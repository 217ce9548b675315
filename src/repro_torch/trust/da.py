"""Data-availability challenges over the chunked storage layer.

The optimistic protocol is only sound while the data behind a round's
commitments stays *retrievable*: auditors must be able to fetch the
committed expert versions (by the manifest root recorded on-chain) for
the whole challenge window.  A storage node that accepted a replica and
then cannot produce a committed chunk is therefore a protocol fault in
its own right — distinct from executor fraud — and is slashed out of its
*storage* stake through the same ``StakeBook`` machinery the executor
bonds use.

Per round the ``DataAvailabilityAuditor`` samples committed chunks (rate
per chunk, seeded by round id — deterministic, unpredictable without the
seed, like the verifier lottery) and challenges every replica node
committed to each sampled chunk to produce its bytes:

- bytes produced, hash matches the CID       -> challenge satisfied;
- bytes produced, hash mismatch (corruption) -> self-evident fault: the
  node is slashed immediately, and a *verified refetch* from a healthy
  replica repairs its copy (availability restored);
- bytes not produced (withheld)              -> an OPEN challenge with a
  deadline one challenge window away; a node that still cannot produce
  the chunk when the window closes is slashed (``resolve``), while one
  that recovers in time satisfies the challenge late (transient
  unavailability is not punished).

Hosts mine the resulting slash events into the ledger (``BMoESystem``
emits one ``kind="da_slash"`` block per conviction).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.ledger import digest_bytes
from repro_torch.obs.metrics import CounterGroup, MetricsRegistry
from repro_torch.storage.chunks import ChunkManifest
from repro_torch.storage.network import StorageNetwork
from repro_torch.trust.slashing import StakeBook


@dataclasses.dataclass(frozen=True)
class DAFault:
    """A confirmed data-availability fault, shaped for StakeBook.slash
    (``executor`` is the guilty *storage node*; ``verifier`` the
    challenger credited with the bounty)."""
    round_id: int
    executor: int                       # storage node id
    verifier: int
    object_id: str
    chunk_index: int
    cid: str
    kind: str                           # "withheld" | "corrupted"


@dataclasses.dataclass
class DAChallenge:
    """One (chunk, node) availability challenge."""
    challenge_id: int
    round_id: int
    object_id: str
    chunk_index: int
    cid: str
    node_id: int
    deadline: int
    status: str = "open"                # open | satisfied | slashed
    kind: str = "withheld"


class DataAvailabilityAuditor:
    """Samples committed chunks per round and holds replica nodes to
    their storage commitments (see module docstring)."""

    def __init__(self, network: StorageNetwork, num_nodes: int,
                 window: int = 2, sample_rate: float = 0.05, seed: int = 0,
                 stake: float = 1.0, slash_fraction: float = 0.5,
                 challenger: int = -1,
                 metrics: Optional[MetricsRegistry] = None,
                 namespace: str = "trust.da"):
        self.network = network
        self.window = int(window)
        self.sample_rate = float(sample_rate)
        self._seed = seed
        self.challenger = challenger
        self.stakes = StakeBook(num_nodes, stake=stake,
                                slash_fraction=slash_fraction,
                                bounty_fraction=0.0)
        self.challenges: List[DAChallenge] = []
        self.faults: List[DAFault] = []
        self._open: Dict[int, DAChallenge] = {}
        # (cid, node) pairs with an open challenge or a booked slash:
        # one availability fault is punished once, even when chunk dedup
        # makes many manifests reference the same CID (a zero-init bias
        # chunk shared by every expert, say) or many rounds re-sample it
        self._outstanding: set = set()
        self._next_id = 0
        self.stats = CounterGroup(
            {"probed": 0, "satisfied": 0, "opened": 0,
             "slashed": 0, "repaired": 0, "deduped": 0},
            metrics, namespace)

    def _rng(self, round_id: int) -> np.random.Generator:
        return np.random.default_rng((self._seed * 7_368_787 + round_id) * 13)

    # ------------------------------------------------------------ probe
    def _probe(self, round_id: int, object_id: str, index: int, cid: str,
               node_id: int) -> Optional[DAChallenge]:
        if (cid, node_id) in self._outstanding:
            self.stats["deduped"] += 1
            return None
        ch = DAChallenge(challenge_id=self._next_id, round_id=round_id,
                         object_id=object_id, chunk_index=index, cid=cid,
                         node_id=node_id, deadline=round_id + self.window)
        self._next_id += 1
        self.challenges.append(ch)
        self.stats["probed"] += 1
        data = self.network.node(node_id).get(cid)
        if data is None:
            # committed but not produced: the DA-challengeable state —
            # the node has until the window closes to recover
            self._open[ch.challenge_id] = ch
            self._outstanding.add((cid, node_id))
            self.stats["opened"] += 1
            return ch
        if digest_bytes(data) == cid:
            ch.status = "satisfied"
            self.stats["satisfied"] += 1
            return ch
        # corrupted replica: self-evident fault (the produced bytes do
        # not hash to the committed CID) — slash now, then repair the
        # copy by verified refetch from a healthy replica
        self._slash(ch, "corrupted")
        if self.network.repair(cid, node_id):
            self.stats["repaired"] += 1
        return ch

    def challenge_round(self, round_id: int,
                        manifests: Dict[str, ChunkManifest]
                        ) -> List[DAChallenge]:
        """Sample each committed chunk at ``sample_rate`` (seeded by
        round id) and challenge every replica node committed to it."""
        out: List[DAChallenge] = []
        rng = self._rng(round_id)
        for object_id in sorted(manifests):
            man = manifests[object_id]
            coins = rng.random(man.num_chunks)
            for i, cid in enumerate(man.chunk_cids):
                if coins[i] >= self.sample_rate:
                    continue
                for node_id in self.network.replicas(cid):
                    ch = self._probe(round_id, object_id, i, cid, node_id)
                    if ch is not None:
                        out.append(ch)
        return out

    # ---------------------------------------------------------- resolve
    def resolve(self, now: Optional[int] = None) -> List[DAChallenge]:
        """Close every open challenge whose deadline passed (``now=None``
        closes all): a node that can produce the committed bytes by the
        deadline satisfies late; one that still cannot is slashed."""
        resolved: List[DAChallenge] = []
        for ch in sorted(self._open.values(),
                         key=lambda c: (c.deadline, c.challenge_id)):
            if now is not None and ch.deadline > now:
                continue
            del self._open[ch.challenge_id]
            try:
                data = self.network.node(ch.node_id).get(ch.cid)
            except KeyError:
                data = None              # node left the network: withheld
            if data is not None and digest_bytes(data) == ch.cid:
                ch.status = "satisfied"
                self.stats["satisfied"] += 1
                # recovered: the pair may be challenged afresh later
                self._outstanding.discard((ch.cid, ch.node_id))
            else:
                self._slash(ch, "withheld")
            resolved.append(ch)
        return resolved

    def pending(self) -> List[DAChallenge]:
        return sorted(self._open.values(),
                      key=lambda c: (c.deadline, c.challenge_id))

    def _slash(self, ch: DAChallenge, kind: str) -> None:
        ch.status = "slashed"
        ch.kind = kind
        self._outstanding.add((ch.cid, ch.node_id))   # punished once
        fault = DAFault(round_id=ch.round_id, executor=ch.node_id,
                        verifier=self.challenger, object_id=ch.object_id,
                        chunk_index=ch.chunk_index, cid=ch.cid, kind=kind)
        self.faults.append(fault)
        self.stakes.slash(fault)
        self.stats["slashed"] += 1
