"""Chunked content-addressed serialization (paper §IV-A(4), storage layer).

An expert (any pytree of arrays) is serialized *per leaf*: each leaf's
raw bytes are split into fixed-size chunks and every chunk is
content-addressed by its SHA-256 CID.  A ``ChunkManifest`` names the
chunks in order, carries the leaf layout (shapes/dtypes/treedef) needed
to reassemble the tree, and commits the chunk CID list under one Merkle
root — the single digest that goes on-chain.  That layout is what makes
the storage layer auditable at chunk granularity:

- a *tampered* chunk is self-evident (its bytes no longer hash to the
  CID the manifest names) and is pinpointed without refetching the rest
  of the expert;
- a *withheld* chunk is a data-availability fault attributable to the
  replica node that committed to holding it;
- an *unchanged* chunk between two versions of the same expert keeps its
  CID, so uploading a new version costs only the changed chunks
  (chunk-level dedup — the ``ExpertStore`` economy).

The legacy whole-tree npz blob (``serialize_tree``/``deserialize_tree``)
is kept for checkpoints and one-shot objects; ``deserialize_tree`` now
verifies treedef compatibility against ``like`` instead of silently
unflattening into the wrong structure.

Trees flatten through ``core.ledger.tree_flatten``, which records the
JAX package's treedef string: the same array bytes give byte-identical
chunk CIDs, Merkle roots and manifest CIDs in both packages.
"""
from __future__ import annotations

import dataclasses
import functools
import io
import json
from typing import Any, List, Sequence, Tuple

import numpy as np

from repro_torch.core.ledger import (as_numpy, digest_bytes, tree_flatten,
                                     tree_unflatten)
from repro_torch.trust.commitments import MerklePath, MerkleTree

DEFAULT_CHUNK_BYTES = 1 << 16          # 64 KiB


# ------------------------------------------------------------ npz blob
def serialize_tree(tree) -> bytes:
    leaves, treedef = tree_flatten(tree)
    buf = io.BytesIO()
    np.savez(buf, treedef=treedef,
             **{f"leaf{i}": as_numpy(l) for i, l in enumerate(leaves)})
    return buf.getvalue()


def deserialize_tree(data: bytes, like) -> Any:
    buf = io.BytesIO(data)
    z = np.load(buf, allow_pickle=False)
    leaves = [z[f"leaf{i}"] for i in range(len(z.files) - 1)]
    like_leaves, treedef = tree_flatten(like)
    stored = str(z["treedef"])
    if stored != treedef:
        raise ValueError(
            f"treedef mismatch: stored object has structure {stored}, "
            f"but `like` has {treedef} — wrong template for this CID")
    if len(leaves) != len(like_leaves):
        raise ValueError(f"stored object has {len(leaves)} leaves, "
                         f"`like` has {len(like_leaves)}")
    return tree_unflatten(like, leaves)


# ------------------------------------------------------- chunk manifest
@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Layout of one serialized leaf: enough to rebuild the array from
    its chunk bytes without a template."""
    shape: Tuple[int, ...]
    dtype: str
    num_chunks: int
    nbytes: int


@dataclasses.dataclass(frozen=True)
class ChunkManifest:
    """The content-addressed description of one stored object version.

    ``chunk_cids`` is the flat chunk list, leaf-major in leaf order
    (leaf 0's chunks, then leaf 1's, ...).  ``root`` is the Merkle root
    over the chunk CIDs — the 32-byte commitment that goes on-chain; a
    Merkle path from it proves a single chunk's membership without the
    manifest.  The manifest itself is stored in the network as a JSON
    object whose CID (``manifest_cid``) names this exact version.
    """
    object_id: str
    version: int
    treedef: str
    leaves: Tuple[LeafSpec, ...]
    chunk_cids: Tuple[str, ...]
    chunk_sizes: Tuple[int, ...]
    root: str

    @property
    def total_bytes(self) -> int:
        return sum(self.chunk_sizes)

    @property
    def num_chunks(self) -> int:
        return len(self.chunk_cids)

    def to_json(self) -> bytes:
        d = dataclasses.asdict(self)
        return json.dumps(d, sort_keys=True).encode()

    @staticmethod
    def from_json(data: bytes) -> "ChunkManifest":
        d = json.loads(data.decode())
        d["leaves"] = tuple(LeafSpec(shape=tuple(ls["shape"]),
                                     dtype=ls["dtype"],
                                     num_chunks=ls["num_chunks"],
                                     nbytes=ls["nbytes"])
                            for ls in d["leaves"])
        d["chunk_cids"] = tuple(d["chunk_cids"])
        d["chunk_sizes"] = tuple(d["chunk_sizes"])
        return ChunkManifest(**d)

    @functools.cached_property
    def manifest_cid(self) -> str:
        # cached: the dataclass is frozen, so the canonical JSON (and
        # its digest) can never change after construction
        return digest_bytes(self.to_json())

    def prove_chunk(self, index: int) -> MerklePath:
        return MerkleTree(list(self.chunk_cids)).prove(index)

    def verify_chunk(self, index: int, data: bytes,
                     path: MerklePath | None = None) -> bool:
        """Chunk bytes check: hash to the named CID and (optionally)
        authenticate against the on-chain root through a Merkle path."""
        if digest_bytes(data) != self.chunk_cids[index]:
            return False
        if path is not None:
            return MerkleTree.verify(self.root, self.chunk_cids[index], path)
        return True


def split_chunks(data: bytes, chunk_bytes: int) -> List[bytes]:
    if not data:
        return [b""]
    return [data[i:i + chunk_bytes] for i in range(0, len(data), chunk_bytes)]


def build_manifest(object_id: str, version: int, tree,
                   chunk_bytes: int = DEFAULT_CHUNK_BYTES
                   ) -> Tuple[ChunkManifest, List[bytes]]:
    """Chunk a pytree into (manifest, chunk bytes), leaf-major order."""
    leaves, treedef = tree_flatten(tree)
    specs: List[LeafSpec] = []
    chunks: List[bytes] = []
    for leaf in leaves:
        a = np.ascontiguousarray(as_numpy(leaf))
        parts = split_chunks(a.tobytes(), chunk_bytes)
        specs.append(LeafSpec(shape=tuple(a.shape), dtype=str(a.dtype),
                              num_chunks=len(parts), nbytes=a.nbytes))
        chunks.extend(parts)
    cids = tuple(digest_bytes(c) for c in chunks)
    root = MerkleTree(list(cids)).root
    manifest = ChunkManifest(object_id=object_id, version=version,
                             treedef=treedef, leaves=tuple(specs),
                             chunk_cids=cids,
                             chunk_sizes=tuple(len(c) for c in chunks),
                             root=root)
    return manifest, chunks


def assemble_tree(manifest: ChunkManifest, chunks: Sequence[bytes],
                  like) -> Any:
    """Rebuild the pytree from its chunk bytes (chunk-for-chunk inverse
    of ``build_manifest``).  ``like`` supplies the unflatten structure
    and is verified against the manifest's recorded treedef."""
    like_leaves, treedef = tree_flatten(like)
    if treedef != manifest.treedef:
        raise ValueError(
            f"treedef mismatch for {manifest.object_id!r} v{manifest.version}"
            f": manifest records {manifest.treedef}, `like` has {treedef}")
    if len(like_leaves) != len(manifest.leaves):
        raise ValueError(f"{manifest.object_id!r}: manifest has "
                         f"{len(manifest.leaves)} leaves, `like` has "
                         f"{len(like_leaves)}")
    if len(chunks) != manifest.num_chunks:
        raise ValueError(f"{manifest.object_id!r}: got {len(chunks)} chunks "
                         f"for a {manifest.num_chunks}-chunk manifest")
    out = []
    cursor = 0
    for spec in manifest.leaves:
        data = b"".join(chunks[cursor:cursor + spec.num_chunks])
        cursor += spec.num_chunks
        if len(data) != spec.nbytes:
            raise ValueError(f"{manifest.object_id!r}: leaf byte length "
                             f"{len(data)} != recorded {spec.nbytes}")
        out.append(np.frombuffer(data, dtype=np.dtype(spec.dtype))
                   .reshape(spec.shape))
    return tree_unflatten(like, out)
