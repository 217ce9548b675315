"""Decentralized storage network (IPFS-like, paper §IV-A(4)).

Content-addressed: the CID of an object is the SHA-256 of its bytes, so
anything downloaded by CID can be verified against the CID recorded
on-chain (tamper-evidence).  ``StorageNetwork`` replicates each object
across ``replication`` nodes, survives node loss up to the replication
factor, and serves reads from a per-request *randomized* replica order
(seeded — deterministic across runs, but no node absorbs all reads).

Transfer cost is modeled, not just wall-clocked: every put/get accrues
``latency + bytes/bandwidth`` seconds on a deterministic
``NetworkCostModel``, so benchmarks can report byte and time economies
that do not depend on the host machine.

Fault injection (for the storage/serving fault suite and the
data-availability challenges): a replica can be
*corrupted* (bytes flipped — detected by CID verification, served
around) or *withheld* (the node refuses to produce the bytes — the
DA-challengeable fault; ``transient=k`` models a node that recovers
after ``k`` failed probes, the case the read retry loop exists for).

Reads are retried: a ``get`` whose first replica scan comes up empty
re-scans up to ``retry_budget`` times with exponentially-growing
*modeled* backoff seconds (booked to ``storage.network.retries`` /
``.modeled_backoff_s`` in the obs registry), then surfaces a hard
``DataUnavailable`` — a ``KeyError`` subclass, so every existing
handler (``ExpertStore.fetch_manifest`` -> ``ChunkUnavailableError``,
the DA challenges) still fires.
"""
from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Tuple

from repro_torch.core.ledger import digest_bytes
from repro_torch.obs.metrics import CounterGroup, MetricsRegistry


@dataclasses.dataclass(frozen=True)
class NetworkCostModel:
    """Deterministic per-request transfer cost: latency + bytes/bw."""
    bandwidth_bytes_per_s: float = 125e6       # 1 Gbps links
    latency_s: float = 2e-3

    def seconds(self, nbytes: int) -> float:
        return self.latency_s + nbytes / self.bandwidth_bytes_per_s


@dataclasses.dataclass
class ReplicaFault:
    """One observed bad replica: a get() that had to skip a node, or a
    dropped node that took the last replica of an object with it."""
    cid: str
    node_id: int
    kind: str                     # "corrupted" | "withheld" | "lost"


class DataUnavailable(KeyError):
    """Hard unavailability: no replica produced verifiable bytes within
    the read retry budget (or the last replica left the network).  A
    ``KeyError`` subclass so existing recovery paths — the store's
    ``ChunkUnavailableError`` wrap, the DA challenges — fire unchanged.
    """

    def __init__(self, cid: str, kind: str, retries: int = 0):
        super().__init__(cid)
        self.cid = cid
        self.kind = kind
        self.retries = retries

    def __str__(self) -> str:
        tail = f" after {self.retries} retries" if self.retries else ""
        return f"CID {self.cid[:12]}... {self.kind}{tail}"


class StorageNode:
    def __init__(self, node_id: int):
        self.node_id = node_id
        self.objects: Dict[str, bytes] = {}
        self.withheld: set = set()             # cids the node refuses to serve
        self.transient: Dict[str, int] = {}    # cid -> refusals left before
        #                                        the node serves it again
        self.reads = 0                         # served (healthy) reads

    def put(self, cid: str, data: bytes) -> None:
        self.objects[cid] = data

    def get(self, cid: str) -> Optional[bytes]:
        left = self.transient.get(cid)
        if left is not None:
            if left > 0:                       # still refusing — but the
                self.transient[cid] = left - 1  # refusal budget drains, so
                return None                    # a retried read gets through
            del self.transient[cid]
        if cid in self.withheld:
            return None
        return self.objects.get(cid)

    def holds(self, cid: str) -> bool:
        """Committed to holding the object (withholding doesn't erase
        the commitment — that is exactly the DA-challengeable state)."""
        return cid in self.objects or cid in self.withheld


class StorageNetwork:
    """A set of storage nodes with replication. ``put`` returns the CID."""

    def __init__(self, num_nodes: int = 4, replication: int = 2,
                 seed: int = 0, cost: Optional[NetworkCostModel] = None,
                 metrics: Optional[MetricsRegistry] = None,
                 namespace: str = "storage.network",
                 retry_budget: int = 2, backoff_base_s: float = 0.05):
        self.nodes: List[StorageNode] = [StorageNode(i) for i in range(num_nodes)]
        self.replication = min(replication, num_nodes)
        # read retries: extra full replica scans after a failed one, with
        # exponential modeled backoff (deterministic — no wall clock)
        self.retry_budget = int(retry_budget)
        self.backoff_base_s = float(backoff_base_s)
        # placement and read-scan orders draw from SEPARATE seeded
        # streams: the number of reads performed must never perturb
        # where later objects are placed (determinism across call
        # patterns that differ only in read count)
        self._place_rng = random.Random(seed)
        self._scan_rng = random.Random((seed << 1) ^ 0x5DEECE66D)
        self.cost = cost or NetworkCostModel()
        self.faults: List[ReplicaFault] = []
        # CIDs a read observed a bad replica of: a later re-offer of the
        # verified bytes heals those copies (see put)
        self._suspect: set = set()
        # CIDs whose last replica left with a dropped node (the trust
        # event readers surface instead of an uncaught KeyError)
        self.lost: set = set()
        # transfer ledger: plain-dict interface, but with a registry
        # every entry is the live metric {namespace}.{key} (the obs
        # layer's view and this dict are the same numbers)
        self.stats = CounterGroup(
            {"put_requests": 0, "put_bytes": 0, "dedup_puts": 0,
             "healed_puts": 0, "get_requests": 0, "get_bytes": 0,
             "modeled_put_s": 0.0, "modeled_get_s": 0.0,
             "retries": 0, "modeled_backoff_s": 0.0,
             "lost_objects": 0, "repaired_replicas": 0},
            metrics, namespace)

    # ------------------------------------------------------------ write
    def put(self, data: bytes) -> str:
        cid = digest_bytes(data)
        if self.has(cid):
            # content-addressed dedup: the bytes are already replicated,
            # nothing crosses the network.  If a reader has reported a
            # bad replica of this CID, the re-offered (verified) bytes
            # heal the corrupted copies instead of being dropped — an
            # honest re-upload must never be silently discarded just
            # because a poisoned key exists.
            if cid in self._suspect:
                for node in self.nodes:
                    if cid in node.objects \
                            and digest_bytes(node.objects[cid]) != cid:
                        node.put(cid, data)
                        self.stats["healed_puts"] += 1
                self._suspect.discard(cid)
            self.stats["dedup_puts"] += 1
            return cid
        self.lost.discard(cid)                 # re-uploaded: available again
        for node in self._place_rng.sample(self.nodes, self.replication):
            node.put(cid, data)
            self.stats["put_requests"] += 1
            self.stats["put_bytes"] += len(data)
            self.stats["modeled_put_s"] += self.cost.seconds(len(data))
        return cid

    def put_tree(self, tree) -> str:
        from repro_torch.storage.chunks import serialize_tree
        return self.put(serialize_tree(tree))

    # ------------------------------------------------------------- read
    def has(self, cid: str) -> bool:
        return any(cid in n.objects for n in self.nodes)

    def replicas(self, cid: str) -> List[int]:
        """Nodes committed to holding the object (withholding included)."""
        return [n.node_id for n in self.nodes if n.holds(cid)]

    def _scan(self, cid: str, verify: bool,
              seen: set) -> Tuple[Optional[bytes], bool]:
        """One randomized pass over the replicas: (bytes or None, whether
        any replica produced bytes at all).  ``seen`` dedupes the fault
        records across the retry passes of a single request."""
        found = False
        for node in self._scan_rng.sample(self.nodes, len(self.nodes)):
            data = node.get(cid)
            if data is None:
                if node.holds(cid) \
                        and (node.node_id, "withheld") not in seen:
                    seen.add((node.node_id, "withheld"))
                    self.faults.append(ReplicaFault(cid, node.node_id,
                                                    "withheld"))
                continue
            found = True
            if verify and digest_bytes(data) != cid:
                if (node.node_id, "corrupted") not in seen:
                    seen.add((node.node_id, "corrupted"))
                    self.faults.append(ReplicaFault(cid, node.node_id,
                                                    "corrupted"))
                self._suspect.add(cid)         # heal on the next re-offer
                continue                       # try another replica
            node.reads += 1
            self.stats["get_requests"] += 1
            self.stats["get_bytes"] += len(data)
            self.stats["modeled_get_s"] += self.cost.seconds(len(data))
            return data, True
        return None, found

    def get(self, cid: str, verify: bool = True) -> bytes:
        """Fetch by CID: probe replicas in a per-request randomized order
        (seeded), skip corrupted/withheld copies (recording the fault),
        and serve the first copy whose bytes hash back to the CID — the
        verified-refetch path a tampered replica triggers.

        A failed pass is retried up to ``retry_budget`` times as long as
        some node is still *committed* to the object (transient refusals
        recover, healed replicas reappear); each retry books one
        ``retries`` tick plus exponentially-growing modeled backoff
        seconds.  An exhausted budget surfaces ``DataUnavailable`` — the
        hard fault DA challenges attribute and slash."""
        seen: set = set()
        data, found = self._scan(cid, verify, seen)
        retries = 0
        while data is None and retries < self.retry_budget \
                and any(n.holds(cid) for n in self.nodes):
            retries += 1
            self.stats["retries"] += 1
            self.stats["modeled_backoff_s"] += \
                self.backoff_base_s * (2 ** (retries - 1))
            data, f = self._scan(cid, verify, seen)
            found = found or f
        if data is not None:
            return data
        if cid in self.lost:
            raise DataUnavailable(cid, "lost with its last replica",
                                  retries)
        kind = ("corrupted on every replica" if found else
                "unavailable on every replica" if seen else "not found")
        raise DataUnavailable(cid, kind, retries)

    def get_tree(self, cid: str, like):
        from repro_torch.storage.chunks import deserialize_tree
        return deserialize_tree(self.get(cid), like)

    def read_load(self) -> List[int]:
        """Per-node served-read counters (load-balance regression)."""
        return [n.reads for n in self.nodes]

    # ------------------------------------------------------ maintenance
    def discard(self, cid: str) -> None:
        """Drop an object from every node — e.g. a superseded expert
        version whose data-availability window (the challenge window)
        has closed."""
        for node in self.nodes:
            node.objects.pop(cid, None)
            node.withheld.discard(cid)
            node.transient.pop(cid, None)

    def _healthy_bytes(self, cid: str) -> Optional[bytes]:
        """Verified bytes from any replica, without read accounting or
        fault records (the maintenance path re-replication uses)."""
        for node in self.nodes:
            data = node.objects.get(cid)
            if data is not None and digest_bytes(data) == cid:
                return data
        return None

    def drop_node(self, node_id: int, repair: bool = False) -> None:
        """Remove a node.  Every object it held is checked against the
        survivors: with ``repair=True`` the verified bytes are re-
        replicated from a surviving replica back up to the replication
        factor (so a fetch racing the drop still finds a healthy copy);
        an object whose LAST replica left with the node is recorded as a
        ``lost`` ReplicaFault trust event (and later fetches surface
        ``DataUnavailable``) instead of dying in an uncaught KeyError."""
        victim = next((n for n in self.nodes if n.node_id == node_id), None)
        self.nodes = [n for n in self.nodes if n.node_id != node_id]
        if victim is None:
            return
        for cid in sorted(set(victim.objects) | set(victim.withheld)):
            survivors = [n for n in self.nodes if n.holds(cid)]
            if not survivors:
                self.faults.append(ReplicaFault(cid, node_id, "lost"))
                self.lost.add(cid)
                self.stats["lost_objects"] += 1
                continue
            if not repair:
                continue
            data = self._healthy_bytes(cid)
            if data is None:
                continue        # survivors all corrupt/withheld: DA's case
            holders = {n.node_id for n in survivors}
            spares = [n for n in self.nodes if n.node_id not in holders]
            need = min(self.replication, len(self.nodes)) - len(holders)
            if need <= 0 or not spares:
                continue
            for node in self._place_rng.sample(spares,
                                               min(need, len(spares))):
                node.put(cid, data)
                self.stats["repaired_replicas"] += 1

    def repair(self, cid: str, node_id: int) -> bool:
        """Overwrite a node's replica with verified bytes refetched from
        a healthy replica (the recovery step after a corrupted-replica
        fault).  Returns False when no healthy replica remains."""
        try:
            data = self.get(cid)
        except KeyError:
            return False
        for node in self.nodes:
            if node.node_id == node_id:
                node.put(cid, data)
                node.withheld.discard(cid)
                node.transient.pop(cid, None)
                return True
        return False

    # -------------------------------------------------- fault injection
    def node(self, node_id: int) -> StorageNode:
        for n in self.nodes:
            if n.node_id == node_id:
                return n
        raise KeyError(f"no node {node_id}")

    def corrupt_replica(self, cid: str, node_id: int) -> None:
        """Bit-flip one node's copy (CID verification will catch it)."""
        node = self.node(node_id)
        if cid not in node.objects:
            raise KeyError(f"node {node_id} holds no replica of "
                           f"{cid[:12]}...")
        data = bytearray(node.objects[cid])
        if data:
            data[0] ^= 0xFF
        else:
            data = bytearray(b"\x00")
        node.objects[cid] = bytes(data)

    def withhold(self, cid: str, node_id: Optional[int] = None,
                 transient: int = 0) -> None:
        """Make replica(s) refuse to serve the object while still being
        committed to it — the data-availability fault.  ``transient=k``
        makes the refusal recover after ``k`` failed probes (the flaky-
        replica case the read retry budget is sized for); the default is
        a permanent withhold until repaired."""
        for node in self.nodes:
            if node_id is not None and node.node_id != node_id:
                continue
            if cid in node.objects:
                if transient > 0:
                    node.transient[cid] = int(transient)
                else:
                    node.withheld.add(cid)
