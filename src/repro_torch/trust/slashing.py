"""Stake accounting, slashing, and the dispute court.

Optimistic acceptance is only safe if cheating is unprofitable: every
executor posts a deposit, and a confirmed fraud proof burns a fraction of
it (part is paid to the reporting verifier as a bounty).  Confirmed
proofs also feed the existing ``ReputationLedger`` (paper §VI-B/D) so
repeat offenders cross the exclusion threshold and are barred from the
executor rotation and the electorate — the same damage-bounding the
paper applies to redundancy consensus, reused for the optimistic path.

The ``DisputeCourt`` is the fallback when a round is challenged: it
re-runs the paper's full M-way redundancy vote (every edge recomputes,
majority wins) for that single round, so a disputed round costs O(M)
but an undisputed one stays O(1) + audit.

A copy of ``repro.trust.slashing``, except that the court votes on a
device: on the card its vote is one launch of the fused vote kernel
(``kernels.ops.redundancy_vote_masked``), where the JAX package calls
the plain oracle on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.ledger import as_numpy
from repro_torch.core.reputation import ReputationLedger
from repro_torch.kernels import ops as kops
from repro_torch.trust.audit import FraudProof


@dataclasses.dataclass
class SlashEvent:
    round_id: int
    edge: int
    amount: float
    bounty: float
    verifier: int


class StakeBook:
    """Per-edge security deposits with slashing and bounties."""

    def __init__(self, num_edges: int, stake: float = 1.0,
                 slash_fraction: float = 0.5, bounty_fraction: float = 0.5,
                 min_stake: float = 0.25):
        self.stake = np.full(num_edges, float(stake))
        self.initial = float(stake)
        self.slash_fraction = float(slash_fraction)
        self.bounty_fraction = float(bounty_fraction)
        self.min_stake = float(min_stake)
        # keyed by verifier id — a distinct id space from edges
        self.bounties: Dict[int, float] = {}
        self.events: List[SlashEvent] = []

    def bonded(self, edge: int) -> bool:
        """Only edges with enough remaining stake may execute."""
        return self.stake[edge] >= self.min_stake

    def bonded_edges(self) -> List[int]:
        return [i for i in range(len(self.stake)) if self.bonded(i)]

    def slash(self, proof: FraudProof) -> SlashEvent:
        """Burn a fraction of the executor's stake; pay the bounty to the
        verifier that raised the proof (griefing-resistant because the
        proof was already court-confirmed)."""
        edge = proof.executor
        amount = self.stake[edge] * self.slash_fraction
        self.stake[edge] -= amount
        bounty = amount * self.bounty_fraction
        if proof.verifier >= 0:
            self.bounties[proof.verifier] = \
                self.bounties.get(proof.verifier, 0.0) + bounty
        ev = SlashEvent(round_id=proof.round_id, edge=edge, amount=amount,
                        bounty=bounty, verifier=proof.verifier)
        self.events.append(ev)
        return ev


def reputation_fraud_update(reputation: Optional[ReputationLedger],
                            guilty_edge: int, num_edges: int) -> None:
    """Feed a confirmed fraud proof into the reputation ledger as a
    consensus outcome: the guilty edge's result was rejected (its column
    is all-zero), everyone else's stood (paper §VI-D slashing signal)."""
    if reputation is None:
        return
    flags = np.ones((1, num_edges), dtype=np.int32)
    flags[0, guilty_edge] = 0
    reputation.update_from_flags(flags)


@dataclasses.dataclass
class Verdict:
    """Outcome of a dispute escalation (the full-redundancy court)."""
    round_id: int
    trusted: np.ndarray                 # (N, B, C) majority outputs
    support: np.ndarray                 # (N,) coalition sizes
    flags: np.ndarray                   # (N, M) per-edge agreement
    executor_guilty: bool               # executor's copy lost the vote


class DisputeCourt:
    """Escalation path: one disputed round pays the paper's full M-way
    redundancy vote to settle what the trusted outputs are.  The vote
    runs on ``device`` (``None``: the CUDA device)."""

    def __init__(self, num_edges: int, device=None):
        self.num_edges = num_edges
        self.device = kops.resolve_device(device)
        self.cases: List[Verdict] = []

    def escalate(self, round_id: int, published: np.ndarray,
                 executor: int, active: Optional[np.ndarray] = None) -> Verdict:
        """``published``: (N, M, B, C) — every edge's copy of every
        expert's result, exactly the redundancy-mechanism input (paper
        Step 3).  The majority vote is the verdict; the executor is
        guilty iff its copy disagrees with the accepted majority for any
        expert."""
        act = (np.ones(self.num_edges, np.float32) if active is None
               else np.asarray(active, np.float32))
        pub = np.ascontiguousarray(published, np.float32)
        E, M = pub.shape[:2]
        trusted, support, flags = (as_numpy(r) for r in
                                   kops.redundancy_vote_masked(
                                       torch.from_numpy(pub.reshape(E, M, -1))
                                       .to(self.device),
                                       torch.from_numpy(act).to(self.device)))
        trusted = trusted.reshape((E,) + pub.shape[2:])
        guilty = bool((flags[:, executor] == 0).any())
        verdict = Verdict(round_id=round_id, trusted=trusted,
                          support=support, flags=flags,
                          executor_guilty=guilty)
        self.cases.append(verdict)
        return verdict
