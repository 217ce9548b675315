"""Merkle commitments over per-expert output chunks.

The executor edge splits each expert's result on the published task into
``chunks_per_expert`` contiguous batch chunks, digests every chunk into a
leaf, and commits the single Merkle root on-chain.  Auditors later
recompute sampled leaves; a mismatching leaf plus its Merkle path is a
fraud proof checkable by anyone holding only the 32-byte root — the
commitment is what makes O(1)-sized proofs possible.

Leaf ordering is row-major over (expert, chunk): leaf index
``e * chunks_per_expert + c`` covers expert ``e``'s rows
``[chunk_bounds[c], chunk_bounds[c+1])`` of the batch.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ledger import digest_bytes


def leaf_digest(chunk: np.ndarray) -> str:
    """Digest of one output chunk (shape/dtype-sensitive, like
    ledger.digest_array, but domain-separated from interior nodes)."""
    a = np.ascontiguousarray(chunk)
    return digest_bytes(b"leaf:" + a.tobytes() + str(a.shape).encode()
                        + str(a.dtype).encode())


def leaf_digest_batch(chunks, lengths: Optional[Sequence[int]] = None
                      ) -> List[str]:
    """Digest every leaf of a stacked chunk batch in one pass.

    ``chunks`` is ``(S, Cmax, *tail)``; row ``s`` covers the leaf's first
    ``lengths[s]`` rows (``Cmax`` when ``lengths`` is None — the
    equal-chunk fast path).  Rows past a leaf's length are padding and
    never enter the hash.  Digests are byte-identical to
    ``leaf_digest(chunks[s, :lengths[s]])``: one ``ascontiguousarray``
    up front makes every leading-axis slice a contiguous view, so no
    per-leaf canonicalization copies remain — this is the fused-hash
    half of the batched audit pass, and what ``commit_outputs`` uses to
    digest a whole round at once.
    """
    a = np.ascontiguousarray(chunks)
    if a.ndim < 2:
        raise ValueError(f"expected (S, Cmax, ...), got {a.shape}")
    dt = str(a.dtype).encode()
    if lengths is None:
        shp = str(a.shape[1:]).encode()
        return [digest_bytes(b"leaf:" + a[s].tobytes() + shp + dt)
                for s in range(a.shape[0])]
    if len(lengths) != a.shape[0]:
        raise ValueError(f"{len(lengths)} lengths for {a.shape[0]} leaves")
    out = []
    for s, n in enumerate(lengths):
        v = a[s, :n]
        out.append(digest_bytes(b"leaf:" + v.tobytes()
                                + str(v.shape).encode() + dt))
    return out


def _node_digest(left: str, right: str) -> str:
    return hashlib.sha256(b"node:" + left.encode() + right.encode()).hexdigest()


@dataclasses.dataclass(frozen=True)
class MerklePath:
    """Authentication path for one leaf: sibling digests bottom-up plus
    the leaf's index (the index determines left/right at each level)."""
    index: int
    siblings: Tuple[str, ...]


class MerkleTree:
    """Binary Merkle tree over a list of leaf digests.

    Odd levels are padded by duplicating the last node (Bitcoin-style),
    so any leaf count works.  ``prove``/``verify`` round-trip: a path is
    valid iff folding the leaf digest up through the siblings reproduces
    the root.
    """

    def __init__(self, leaves: Sequence[str]):
        if not leaves:
            raise ValueError("Merkle tree needs at least one leaf")
        self.leaves = list(leaves)
        self.levels: List[List[str]] = [list(leaves)]
        while len(self.levels[-1]) > 1:
            cur = self.levels[-1]
            if len(cur) % 2:
                cur = cur + [cur[-1]]
            self.levels.append([_node_digest(cur[i], cur[i + 1])
                                for i in range(0, len(cur), 2)])

    @property
    def root(self) -> str:
        return self.levels[-1][0]

    def prove(self, index: int) -> MerklePath:
        if not 0 <= index < len(self.leaves):
            raise IndexError(index)
        siblings = []
        i = index
        for level in self.levels[:-1]:
            padded = level + [level[-1]] if len(level) % 2 else level
            sib = i + 1 if i % 2 == 0 else i - 1
            siblings.append(padded[sib])
            i //= 2
        return MerklePath(index=index, siblings=tuple(siblings))

    @staticmethod
    def verify(root: str, leaf: str, path: MerklePath) -> bool:
        h = leaf
        i = path.index
        for sib in path.siblings:
            h = _node_digest(h, sib) if i % 2 == 0 else _node_digest(sib, h)
            i //= 2
        return h == root


def chunk_bounds(batch: int, chunks: int) -> List[int]:
    """Contiguous near-equal chunk boundaries: len == chunks+1."""
    chunks = max(1, min(chunks, batch))
    edges = np.linspace(0, batch, chunks + 1).astype(int)
    return list(edges)


@dataclasses.dataclass
class RoundCommitment:
    """What the executor publishes for one round.

    Only ``root`` (plus, for sparse dispatch, the routing digest) goes
    on-chain; the claimed outputs (the leaf data) stay off-chain with the
    executor, retrievable by auditors on demand.

    Dense dispatch commits the full per-expert outputs ``(N, B, C)`` —
    leaf ``(e, c)`` covers batch rows ``bounds[c]:bounds[c+1]``.  Sparse
    dispatch commits the capacity-bucketed buffers ``(N, capacity, C)``
    the executor actually computed: leaf ``(e, c)`` covers bucket slots
    ``bounds[c]:bounds[c+1]`` of expert ``e``, and ``row_index[e, s]``
    names the task row filling slot ``s`` (one past the batch = empty
    slot, recomputed from a zero row).  Publishing ``row_index`` is what
    lets any auditor re-derive the exact buckets and recompute a sampled
    leaf without re-running the gate — verification cost scales with
    ``top_k/num_experts`` exactly like execution cost.
    """
    round_id: int
    executor: int
    root: str
    num_experts: int
    chunks_per_expert: int
    bounds: List[int]                       # batch/bucket chunk boundaries
    leaf_digests: List[str]
    claimed: np.ndarray                     # (N, B|cap, C) executor outputs
    task_digest: str = ""
    row_index: Optional[np.ndarray] = None  # (N, cap) task row per slot
    routing_digest: str = ""                # binds row_index on-chain
    num_shards: int = 1                     # edge shards that hashed locally
    shard_roots: Optional[List[str]] = None  # per-edge subtree roots

    @property
    def num_leaves(self) -> int:
        return len(self.leaf_digests)

    @property
    def rows_per_expert(self) -> int:
        """Committed rows per expert: the capacity bucket under sparse
        dispatch, the full batch under dense — the unit audit/court
        recompute cost scales with."""
        return int(self.claimed.shape[1])

    def leaf_coords(self, leaf: int) -> Tuple[int, int, slice]:
        """leaf index -> (expert, chunk, batch slice)."""
        e, c = divmod(leaf, self.chunks_per_expert)
        return e, c, slice(self.bounds[c], self.bounds[c + 1])

    def leaf_chunk(self, leaf: int) -> np.ndarray:
        e, _, sl = self.leaf_coords(leaf)
        return self.claimed[e, sl]

    def tree(self) -> MerkleTree:
        return MerkleTree(self.leaf_digests)


def routing_digest(row_index: np.ndarray) -> str:
    """Digest of the published routing indices (domain-separated so a
    routing tensor can never collide with an output leaf)."""
    a = np.ascontiguousarray(row_index)
    return digest_bytes(b"routing:" + a.tobytes() + str(a.shape).encode()
                        + str(a.dtype).encode())


def _leaf_digests(claimed: np.ndarray, bounds: List[int]) -> List[str]:
    """Leaf digests for one executor's (or one edge shard's) expert
    slice, in (expert, chunk) row-major leaf order."""
    n_experts = claimed.shape[0]
    chunks = len(bounds) - 1
    widths = [bounds[c + 1] - bounds[c] for c in range(chunks)]
    if len(set(widths)) == 1:
        # equal chunks: digest the whole slice through one reshaped view
        # (leaf order is (e, c) row-major, exactly the reshape order)
        return leaf_digest_batch(
            claimed.reshape((n_experts * chunks, widths[0])
                            + claimed.shape[2:]))
    per_chunk = [leaf_digest_batch(claimed[:, bounds[c]:bounds[c + 1]])
                 for c in range(chunks)]
    return [per_chunk[c][e]
            for e in range(n_experts) for c in range(chunks)]


def commit_outputs(outputs, *, round_id: int, executor: int,
                   chunks_per_expert: int = 4, task_digest: str = "",
                   row_index: Optional[np.ndarray] = None,
                   num_shards: int = 1) -> RoundCommitment:
    """Build the executor's round commitment from its claimed per-expert
    outputs ``(N, B, C)`` — or, with ``row_index``, from its sparse
    capacity-bucketed buffers ``(N, capacity, C)`` (see RoundCommitment:
    the routing indices travel with the commitment so auditors re-derive
    the same buckets).

    ``num_shards`` > 1 models mesh execution: the expert axis splits
    into contiguous edge slices (shard ``s`` owns experts
    ``[s*E_l, (s+1)*E_l)``), each edge digests only its local
    ``(E_l, capacity, C)`` buffers into its own Merkle subtree, and the
    round root is the Merkle reduction over the ``num_shards`` shard
    roots.  Each shard's leaf count must be a power of two — then every
    shard subtree is a complete subtree of the flat tree, so the
    root-of-roots, every leaf's authentication path, and hence every
    fraud proof are BIT-IDENTICAL to the single-device commitment
    (pinned in tests/test_mesh_bmoe.py)."""
    claimed = np.ascontiguousarray(outputs)
    n_experts, batch = claimed.shape[:2]
    if num_shards < 1 or n_experts % num_shards:
        raise ValueError(f"num_shards ({num_shards}) must divide the "
                         f"expert count ({n_experts})")
    bounds = chunk_bounds(batch, chunks_per_expert)
    chunks = len(bounds) - 1
    shard_roots: Optional[List[str]] = None
    if num_shards > 1:
        e_l = n_experts // num_shards
        digests = []
        for s in range(num_shards):   # each edge hashes only its slice
            digests.extend(_leaf_digests(
                claimed[s * e_l:(s + 1) * e_l], bounds))
        lps = len(digests) // num_shards
        if lps & (lps - 1):
            raise ValueError(
                f"shard-local commitment needs a power-of-two leaf count "
                f"per shard, got ({n_experts}/{num_shards}) experts x "
                f"{chunks} chunks = {lps}; pick chunks_per_expert or the "
                f"shard count so (num_experts/num_shards)*chunks_per_expert "
                f"is a power of two")
        shard_roots = [MerkleTree(digests[s * lps:(s + 1) * lps]).root
                       for s in range(num_shards)]
        tree = MerkleTree(shard_roots)
    else:
        digests = _leaf_digests(claimed, bounds)
        tree = MerkleTree(digests)
    if row_index is not None:
        row_index = np.ascontiguousarray(np.asarray(row_index, np.int32))
        if row_index.shape != (n_experts, batch):
            raise ValueError(f"row_index {row_index.shape} does not match "
                             f"claimed {(n_experts, batch)}")
    return RoundCommitment(round_id=round_id, executor=executor,
                           root=tree.root, num_experts=n_experts,
                           chunks_per_expert=chunks, bounds=bounds,
                           leaf_digests=digests, claimed=claimed,
                           task_digest=task_digest, row_index=row_index,
                           routing_digest=(routing_digest(row_index)
                                           if row_index is not None else ""),
                           num_shards=num_shards, shard_roots=shard_roots)
