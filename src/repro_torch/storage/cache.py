"""Edge-side expert cache with gate-statistics-driven prefetch.

The paper's edge layer "employs the activated experts downloaded from
the storage layer": an edge device holds a bounded-byte cache of expert
parameter trees keyed by object id, validated against the *current
version manifest* (a stale entry — the expert changed on-storage — is a
miss and refetches).  Eviction is LRU over unpinned entries; experts
activated by the round in flight are pinned so resolving a bank can
never evict what it is about to compute with.  Every hit/miss/eviction
and every fetched/evicted byte is counted — the cache IS the transfer
ledger benchmarks read.

``GateEMA`` tracks an exponential moving average of routing frequencies
(the gate statistics); ``ExpertCache.prefetch`` warms the top-EMA
experts before the next round/tick, fetching only while the byte budget
has room (prefetch never evicts — it fills idle capacity, it does not
compete with resident experts).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.obs.metrics import CounterGroup, MetricsRegistry
from repro_torch.storage.store import ExpertStore


class GateEMA:
    """EMA of per-expert routing frequencies (the prefetch signal)."""

    def __init__(self, num_experts: int, decay: float = 0.8):
        self.decay = float(decay)
        self.ema = np.zeros(num_experts, np.float64)
        self.updates = 0

    def update(self, counts) -> None:
        c = np.asarray(counts, np.float64)
        total = c.sum()
        freq = c / total if total > 0 else c
        if self.updates == 0:
            self.ema = freq
        else:
            self.ema = self.decay * self.ema + (1.0 - self.decay) * freq
        self.updates += 1

    def ranking(self) -> List[int]:
        """Expert ids, hottest first (deterministic: ties break by id)."""
        return sorted(range(len(self.ema)),
                      key=lambda e: (-self.ema[e], e))


class ExpertCache:
    def __init__(self, store: ExpertStore,
                 budget_bytes: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 namespace: str = "storage.cache"):
        self.store = store
        self.budget_bytes = budget_bytes        # None: unbounded
        self._entries: "OrderedDict[str, Dict]" = OrderedDict()
        self._pinned: set = set()
        self.stats = CounterGroup(
            {"hits": 0, "misses": 0, "evictions": 0,
             "fetched_bytes": 0, "evicted_bytes": 0,
             "prefetches": 0, "bypasses": 0},
            metrics, namespace)

    # -------------------------------------------------------- residency
    @property
    def resident_bytes(self) -> int:
        return sum(e["nbytes"] for e in self._entries.values())

    def __contains__(self, object_id: str) -> bool:
        return object_id in self._entries

    def fresh(self, object_id: str, version: int) -> bool:
        """Cached AND current: the entry matches the version's manifest."""
        entry = self._entries.get(object_id)
        if entry is None:
            return False
        return entry["manifest_cid"] == self.store.manifest_cid(object_id,
                                                                version)

    def pin(self, object_ids: Sequence[str]) -> None:
        self._pinned.update(object_ids)

    def unpin(self, object_ids: Optional[Sequence[str]] = None) -> None:
        if object_ids is None:
            self._pinned.clear()
        else:
            self._pinned.difference_update(object_ids)
        # a resolve that pinned more than the budget holds runs
        # over-budget for its own duration only — the budget is
        # re-enforced the moment the pins drop (this is what makes a
        # tight budget *thrash* instead of silently growing)
        self._evict_to_budget()

    # ------------------------------------------------------------ fetch
    def get(self, object_id: str, version: int, like) -> Any:
        """Resolve an object at a version through the cache: a fresh
        entry is a hit; anything else (absent, or stale because the
        expert has a newer manifest at this version) fetches from the
        storage layer and admits the new bytes."""
        mcid = self.store.manifest_cid(object_id, version)
        entry = self._entries.get(object_id)
        if entry is not None and entry["manifest_cid"] == mcid:
            self.stats["hits"] += 1
            self._entries.move_to_end(object_id)
            return entry["tree"]
        self.stats["misses"] += 1
        manifest = self.store.manifest_by_cid(mcid)
        tree = self.store.fetch_manifest(manifest, like)
        self.stats["fetched_bytes"] += manifest.total_bytes
        self._admit(object_id, mcid, tree, manifest.total_bytes)
        return tree

    def _admit(self, object_id: str, manifest_cid: str, tree: Any,
               nbytes: int) -> None:
        if self.budget_bytes is not None and nbytes > self.budget_bytes:
            # larger than the whole cache: serve without admitting
            self._entries.pop(object_id, None)
            self.stats["bypasses"] += 1
            return
        self._entries.pop(object_id, None)
        self._entries[object_id] = {"manifest_cid": manifest_cid,
                                    "tree": tree, "nbytes": nbytes}
        self._evict_to_budget()

    def _evict_to_budget(self) -> None:
        if self.budget_bytes is None:
            return
        while self.resident_bytes > self.budget_bytes:
            victim = next((oid for oid in self._entries
                           if oid not in self._pinned), None)
            if victim is None:
                return                   # everything pinned: over-budget
            entry = self._entries.pop(victim)
            self.stats["evictions"] += 1
            self.stats["evicted_bytes"] += entry["nbytes"]

    # --------------------------------------------------------- prefetch
    def prefetch(self, ranked_ids: Sequence[str], version: int,
                 like_fn: Callable[[str], Any],
                 max_fetches: Optional[int] = None) -> List[str]:
        """Warm the cache with the hottest experts (``ranked_ids`` comes
        from ``GateEMA.ranking``): fetch each id that is not already
        fresh, in ranking order, while the byte budget has room — a
        prefetch never evicts a resident entry and never exceeds the
        budget.  Returns the ids actually fetched."""
        fetched: List[str] = []
        for object_id in ranked_ids:
            if max_fetches is not None and len(fetched) >= max_fetches:
                break
            if self.fresh(object_id, version):
                continue
            manifest = self.store.manifest(object_id, version)
            if self.budget_bytes is not None and \
                    self.resident_bytes + manifest.total_bytes \
                    > self.budget_bytes:
                continue                 # no room: prefetch never evicts
            tree = self.store.fetch_manifest(manifest, like_fn(object_id))
            self.stats["prefetches"] += 1
            self.stats["fetched_bytes"] += manifest.total_bytes
            self._admit(object_id, manifest.manifest_cid, tree,
                        manifest.total_bytes)
            fetched.append(object_id)
        return fetched
