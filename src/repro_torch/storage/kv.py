"""KV-cache paging through the chunked trust store (Mooncake / MoE-
Lightning storage-for-compute trade applied to the KV cache); the
counterpart of ``repro.storage.kv``.

Decoded KV is sealed into fixed-size **blocks** of ``block_tokens``
cache rows each.  A block is a tree of host numpy arrays (the per-layer
K/V row slices, plus the int8 scale rows when ``kv_cache_dtype="int8"``,
as ``models.transformer.slice_kv_block`` copies them off the card) and is
stored through the same ``ExpertStore`` machinery as expert weights:
chunked, content-addressed, Merkle-manifested, replicated, DA-
challengeable.

Blocks are addressed by **prefix-hash CIDs**: the CID of block *i* is

    cid_i = H(cid_{i-1} || int64 token ids the block covers)

seeded from ``KV_GENESIS``.  Cache row *p* holds the KV of the token
*fed* at position *p*, which is a pure function of the whole token
prefix — so the chain CID names exactly the content the block holds.
The CIDs hash token ids only, so they equal the JAX package's; manifest
roots hash the KV bytes, which differ between the two packages' float
arithmetic.
Two sessions sharing a prompt prefix derive identical CIDs for the
shared blocks, the second ``seal`` is an ``ExpertStore`` no-op
(chunk-level dedup), and a later admission with a matching prefix
fetches the sealed rows instead of recomputing prefill ("warm hit").

``KVBlockStore`` resolves blocks through an ``ExpertCache`` — the SAME
cache instance as the edge expert runtime when both are configured, so
KV blocks and expert weights compete under ONE byte budget and one LRU
(experts are pinned while activated; cold KV goes first).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.ledger import digest_bytes
from repro_torch.obs.metrics import CounterGroup, MetricsRegistry
from repro_torch.storage.cache import ExpertCache
from repro_torch.storage.chunks import ChunkManifest
from repro_torch.storage.store import ExpertStore

__all__ = ["KV_GENESIS", "KVStorageConfig", "KVBlockStore",
           "prefix_cid", "prefix_chain"]

KV_GENESIS = "kv-genesis"


@dataclasses.dataclass(frozen=True)
class KVStorageConfig:
    """Serving-engine KV paging knobs.

    ``block_tokens``: cache rows per sealed block (the paging granule).
    ``cache_bytes``: edge cache byte budget for the KV store's OWN cache
    — ignored when the engine shares the expert runtime's cache (the
    single-budget mode).  ``da_rate > 0`` runs data-availability
    challenges over the sealed KV chunks each time the engine seals a
    tick's worth of blocks, exactly like expert-chunk DA."""
    block_tokens: int = 16
    cache_bytes: Optional[int] = None       # None: unbounded
    chunk_bytes: int = 1 << 15
    num_nodes: int = 4
    replication: int = 2
    seed: int = 0
    da_rate: float = 0.0
    da_window: int = 2


# ------------------------------------------------------- prefix chain
def prefix_cid(prev_cid: str, tokens) -> str:
    """CID of the block covering ``tokens``, chained onto ``prev_cid``.

    Tokens are encoded as int64 bytes, so the CID binds both the values
    and the count — a tail block over fewer tokens can never collide
    with a full block over the same prefix."""
    t = np.ascontiguousarray(np.asarray(tokens, np.int64))
    return digest_bytes(prev_cid.encode() + t.tobytes())


def prefix_chain(tokens, block_tokens: int) -> List[str]:
    """CIDs of every FULL block of ``tokens`` (partial tail excluded):
    ``len(tokens) // block_tokens`` chained CIDs from ``KV_GENESIS``."""
    t = np.asarray(tokens, np.int64).reshape(-1)
    cids: List[str] = []
    prev = KV_GENESIS
    for b in range(len(t) // block_tokens):
        prev = prefix_cid(prev, t[b * block_tokens:(b + 1) * block_tokens])
        cids.append(prev)
    return cids


# ---------------------------------------------------------- the store
class KVBlockStore:
    """Sealed-KV-block store over an ``ExpertStore`` + ``ExpertCache``.

    Blocks are stored as object ``kv/{cid}`` at version 0 (a prefix CID
    names immutable content — there are no versions to roll).  Sealing
    a CID the store already holds is free: the identical content makes
    ``put_version`` a no-op and every chunk dedups (cross-session
    prefix reuse).  ``store``/``cache`` may be shared with the edge
    expert runtime — that sharing IS the single-byte-budget contract."""

    def __init__(self, store: ExpertStore, cache: ExpertCache,
                 metrics: Optional[MetricsRegistry] = None,
                 namespace: str = "storage.kv"):
        self.store = store
        self.cache = cache
        self._sealed: Dict[str, str] = {}       # cid -> manifest cid
        self.stats = CounterGroup(
            {"sealed_blocks": 0, "sealed_tokens": 0, "sealed_bytes": 0,
             "dedup_blocks": 0, "warm_hits": 0, "warm_misses": 0,
             "restored_tokens": 0, "pageouts": 0, "resumes": 0},
            metrics, namespace)

    @staticmethod
    def object_id(cid: str) -> str:
        return f"kv/{cid}"

    def __contains__(self, cid: str) -> bool:
        return cid in self._sealed

    def sealed_cids(self) -> List[str]:
        return sorted(self._sealed)

    # ----------------------------------------------------------- seal
    def seal(self, cid: str, block: Any, num_tokens: int) -> ChunkManifest:
        """Publish one block under its prefix CID.  Re-sealing a known
        CID (another session reached the same prefix) is pure dedup —
        no new chunks, no new manifest."""
        if cid in self._sealed:
            self.stats["dedup_blocks"] += 1
            return self.store.manifest_by_cid(self._sealed[cid])
        manifest = self.store.put_version(self.object_id(cid), block, 0)
        self._sealed[cid] = manifest.manifest_cid
        self.stats["sealed_blocks"] += 1
        self.stats["sealed_tokens"] += int(num_tokens)
        self.stats["sealed_bytes"] += manifest.total_bytes
        return manifest

    def manifest(self, cid: str) -> ChunkManifest:
        return self.store.manifest_by_cid(self._sealed[cid])

    # ---------------------------------------------------------- fetch
    def fetch(self, cid: str, like: Any) -> Any:
        """Resolve a sealed block through the (possibly shared) cache."""
        return self.cache.get(self.object_id(cid), 0, like)

    def warm_prefix(self, cids: Sequence[str]) -> int:
        """How many leading CIDs of a chain are sealed (restorable).
        Books one warm hit per sealed leading block, one warm miss if
        the chain breaks before its end."""
        n = 0
        for cid in cids:
            if cid not in self._sealed:
                break
            n += 1
        self.stats["warm_hits"] += n
        if n < len(cids):
            self.stats["warm_misses"] += 1
        return n

    # ------------------------------------------------------ manifests
    def manifests(self, cids: Sequence[str]) -> Dict[str, ChunkManifest]:
        """object_id -> manifest map for DA challenges over sealed KV."""
        return {self.object_id(c): self.manifest(c) for c in cids
                if c in self._sealed}
