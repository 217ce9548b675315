"""Batched per-tick session commitments for the serving engine (the
counterpart of ``repro.trust.session``: the same trees over the same leaf
digests, so tick roots and inclusion paths are byte for byte the JAX
package's).

The fixed-slot engine appended one commitment leaf *per active stream
per tick* — O(batch) on-chain appends per tick.  Continuous batching
amortizes that to **one Merkle append per batch tick**: every token the
engine emits in a tick becomes a leaf of a single tick tree (slot
order), only that tree's 32-byte root is appended to the engine's tick
log (the on-chain object), and each session keeps a compact *inclusion
reference* — the tick root plus the leaf's Merkle path — derived from
the same tree.

Per-session leaf digests are unchanged (``leaf_digest`` over the
``(request_id, tick, token)`` record), so the per-session Merkle root a
session seals with — and every ``audit_session`` verdict built on it —
is bit-identical to the per-stream commitment scheme on the same trace.
The tick tree adds a second, independent check: a sampled leaf must
*also* prove membership in the tick root committed when the token was
served, so a post-hoc rewrite of a session's leaf list is caught even
if the per-session root is recomputed consistently.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from repro_torch.trust.commitments import MerklePath, MerkleTree


@dataclasses.dataclass(frozen=True)
class SessionLeafRef:
    """One emitted token's inclusion reference: the batch tick it was
    served in, the tick tree's root (the on-chain append), and the
    Merkle path proving the session's leaf digest sits in that tree."""
    tick: int
    root: str
    path: MerklePath

    def verify(self, leaf: str) -> bool:
        return MerkleTree.verify(self.root, leaf, self.path)


@dataclasses.dataclass(frozen=True)
class TickCommitment:
    """What one batch tick appends on-chain: a single root over every
    token emitted that tick (slot order), plus which sessions it binds.

    ``kv_root`` is a side-band commitment over the KV-block manifest
    roots the engine sealed since the previous append (KV paging on;
    ``""`` otherwise).  It rides the same on-chain object but is NOT
    folded into the token ``root`` — token streams and their audit
    verdicts stay bit-identical with paging on or off."""
    tick: int
    root: str
    request_ids: Tuple[int, ...]
    kv_root: str = ""

    @property
    def num_leaves(self) -> int:
        return len(self.request_ids)


def commit_tick(tick: int, entries: Sequence[Tuple[int, str]],
                kv_roots: Sequence[str] = ()
                ) -> Tuple[TickCommitment, Dict[int, SessionLeafRef]]:
    """Build the batch-tick commitment.

    ``entries``: the tick's emissions in slot order, ``(request_id,
    leaf_digest)`` — one per stream that produced a token this tick (a
    stream emits at most one token per tick, so request ids are unique
    within an entry list).  ``kv_roots``: manifest roots of the KV
    blocks sealed since the last append, committed under one Merkle
    root in ``kv_root`` (prefill ticks can seal without emitting, so
    the engine carries pending roots to the next commit).  Returns the
    tick commitment (one on-chain append for the whole batch) and each
    session's inclusion reference into it."""
    if not entries:
        raise ValueError("commit_tick needs at least one emission")
    rids = [rid for rid, _ in entries]
    if len(set(rids)) != len(rids):
        raise ValueError(f"duplicate request ids in tick {tick}: {rids}")
    tree = MerkleTree([leaf for _, leaf in entries])
    refs = {rid: SessionLeafRef(tick=tick, root=tree.root,
                                path=tree.prove(i))
            for i, (rid, _) in enumerate(entries)}
    kv_root = MerkleTree(list(kv_roots)).root if kv_roots else ""
    return TickCommitment(tick=tick, root=tree.root,
                          request_ids=tuple(rids), kv_root=kv_root), refs


def verify_session_inclusion(leaves: Sequence[str],
                             refs: Sequence[SessionLeafRef],
                             indices: Sequence[int]) -> List[int]:
    """Check sampled session leaves against their committed tick roots.

    Returns the sampled indices whose *current* leaf digest fails its
    inclusion proof — i.e. the session's leaf list no longer matches
    what the engine batch-committed when the token was served."""
    if len(leaves) != len(refs):
        raise ValueError(f"{len(leaves)} leaves but {len(refs)} refs")
    return [i for i in indices if not refs[i].verify(leaves[i])]
