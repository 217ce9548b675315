"""The optimistic round state machine, pipelined (a copy of
``repro.trust.protocol``; a court it builds votes on a device, and
``resolve_by_recompute``, the federated court, recomputes on the host).

One round of optimistically-verified execution moves through:

    COMMITTED  -- executor publishes outputs + Merkle root (on-chain)
        |
    ACCEPTED   -- the system uses the result immediately (optimistic)
        |                         ... async challenge window (in rounds) ...
        +--> FINALIZED            no confirmed fraud inside the window
        +--> CHALLENGED           a fraud proof was raised
        |        +--> ROLLED_BACK  court confirms: slash + undo the round
        |        +--> ACCEPTED     court clears: griefing attempt rejected
        |                          (finalizes at its deadline, in order)
        +--> INVALIDATED          an *ancestor* round was rolled back: this
                                  round's commitment was built on revoked
                                  state, so it is void (no slash — the
                                  executor computed honestly on the state
                                  it was handed)

The window is truly asynchronous: the host keeps committing rounds
r+1..r+w while round r's audit sits in a deadline-ordered queue
(``schedule_audit`` / ``pop_audit_jobs``), so verification is off the
critical path.  Finality is *sequential*: ``advance`` closes windows in
deadline order and stops at the first unresolved (CHALLENGED) round —
a round can never finalize while an ancestor it built on is still in
dispute.  When a fraud proof is confirmed for round r after descendants
have committed, ``resolve`` rolls back the whole chain: round r is
ROLLED_BACK (exactly one slash), every ACCEPTED descendant is
INVALIDATED (CHALLENGED descendants keep their own court date — fraud
is punished per round), and the host restores its pre-r snapshot and
re-executes (see ``BMoESystem``).

The protocol object owns the verifier pool, the stake book, and the
dispute court; the host system (``BMoESystem``; ``ChallengeWindow`` is
for a streaming host such as a serving engine) supplies the recompute
function and applies rollbacks, keeping the trust layer independent of
what is being verified.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.reputation import ReputationLedger
from repro_torch.obs.metrics import CounterGroup, MetricsRegistry
from repro_torch.trust.audit import (AuditReport, BatchRecomputeFn,
                                     FraudProof, RecomputeFn, VerifierPool,
                                     verify_fraud_proof)
from repro_torch.trust.commitments import (RoundCommitment, commit_outputs,
                                          leaf_digest)
from repro_torch.trust.slashing import (DisputeCourt, StakeBook, Verdict,
                                        reputation_fraud_update)


@dataclasses.dataclass(frozen=True)
class TrustConfig:
    """Knobs of the commit-challenge-audit protocol."""
    audit_rate: float = 0.1            # total fraction of leaves audited
    #                                    (split across the verifier pool)
    num_verifiers: int = 3             # independent auditors per round
    chunks_per_expert: int = 4         # Merkle leaves per expert output
    challenge_window: int = 2          # rounds before finalization
    stake: float = 1.0                 # executor deposit
    slash_fraction: float = 0.5        # stake burned per confirmed fraud
    bounty_fraction: float = 0.5       # slashed amount paid to reporter
    min_stake: float = 0.25            # bond needed to execute
    lazy_verifier_prob: float = 0.0    # P[a verifier rubber-stamps]
    # stake-weighted verifier lottery (None: uniform split, the legacy
    # streams): verifier v samples each leaf with probability
    # audit_rate * stake_v / sum(stakes) — pool-wide rate conserved
    verifier_stakes: Optional[Tuple[float, ...]] = None
    # second-layer audit of the auditors: spot-check each verifier's
    # salted recompute attestations at this per-leaf rate; mismatches
    # (rubber-stampers) burn verifier_slash_fraction of their stake
    reaudit_rate: float = 0.0
    verifier_slash_fraction: float = 0.5
    audit_backend: str = "batched"     # batched (one grouped recompute
    #                                    call/round) | eager (reference
    #                                    oracle: one dispatch per leaf)
    scheduling: str = "pipelined"      # pipelined (audits drain off the
    #                                    critical path at window deadlines,
    #                                    chained rollback on late fraud)
    #                                  | synchronous (audit in the commit
    #                                    round — the pre-pipeline oracle)
    seed: int = 0


class RoundPhase(enum.Enum):
    COMMITTED = "committed"
    ACCEPTED = "accepted"
    CHALLENGED = "challenged"
    FINALIZED = "finalized"
    ROLLED_BACK = "rolled_back"
    INVALIDATED = "invalidated"


# phases only move forward through this partial order.  The two open
# phases share a rank — a court acquittal legitimately returns a
# CHALLENGED round to ACCEPTED (griefing rejected) and a fresh challenge
# can re-open it; the three terminal phases share a rank and a terminal
# round never transitions again.
PHASE_RANK = {RoundPhase.COMMITTED: 0, RoundPhase.ACCEPTED: 1,
              RoundPhase.CHALLENGED: 1, RoundPhase.FINALIZED: 2,
              RoundPhase.ROLLED_BACK: 2, RoundPhase.INVALIDATED: 2}

TERMINAL_PHASES = frozenset({RoundPhase.FINALIZED, RoundPhase.ROLLED_BACK,
                             RoundPhase.INVALIDATED})


@dataclasses.dataclass
class RoundState:
    round_id: int
    executor: int
    commitment: RoundCommitment
    phase: RoundPhase
    deadline: int                          # round id after which finalized
    reports: List[AuditReport] = dataclasses.field(default_factory=list)
    proofs: List[FraudProof] = dataclasses.field(default_factory=list)
    verdict: Optional[Verdict] = None
    # set when an ancestor was rolled back while this round was in
    # dispute: even a court acquittal cannot finalize it — the state it
    # was built on is gone (it invalidates instead)
    tainted: bool = False


@dataclasses.dataclass
class RollbackRecord:
    """One confirmed-fraud rollback: the convicted round plus the chain of
    optimistic descendants its conviction voided."""
    round_id: int
    executor: int
    invalidated: List[int]                 # ACCEPTED descendants voided
    at_clock: int


@dataclasses.dataclass
class AuditJob:
    """A queued (deferred) audit for one committed round."""
    round_id: int
    deadline: int
    recompute_fn: RecomputeFn
    batch_recompute_fn: Optional[BatchRecomputeFn] = None


class OptimisticProtocol:
    """Commit -> optimistic accept -> async challenge window ->
    finalize/rollback, over any per-round (N, B, C) output tensor.

    All bookkeeping that scales with history is heap-based: ``advance``
    and ``pending`` touch only open rounds (plus lazily-discarded stale
    heap entries), never the full ``rounds`` dict — O(open) per call
    instead of O(all rounds ever committed).
    """

    def __init__(self, cfg: TrustConfig, num_edges: int,
                 reputation: Optional[ReputationLedger] = None,
                 stakes: Optional[StakeBook] = None,
                 court: Optional[DisputeCourt] = None,
                 chained: bool = True,
                 metrics: Optional[MetricsRegistry] = None,
                 namespace: str = "trust", device=None):
        self.cfg = cfg
        self.num_edges = num_edges
        self.reputation = reputation
        # chained=True: round r+1 builds on round r's optimistic state
        # (training), so a conviction voids descendants and an open
        # dispute blocks later finality.  chained=False: rounds are
        # independent (batch inference against frozen weights) — a
        # conviction revokes only its own round.
        self.chained = chained
        # cfg.audit_rate is the pool-wide sampled fraction; each verifier
        # draws its share (stake-weighted when verifier_stakes is set) so
        # total recompute stays at audit_rate
        self.verifiers = VerifierPool(
            cfg.num_verifiers, cfg.audit_rate / max(cfg.num_verifiers, 1),
            cfg.lazy_verifier_prob, cfg.seed,
            stakes=cfg.verifier_stakes, reaudit_rate=cfg.reaudit_rate,
            verifier_slash_fraction=cfg.verifier_slash_fraction,
            metrics=metrics, namespace=f"{namespace}.verifiers")
        # stakes/court may be shared with a sibling protocol instance (the
        # host's inference pipeline shares the training pipeline's bonds,
        # so one edge's deposit backs both workloads)
        self.stakes = stakes if stakes is not None else StakeBook(
            num_edges, cfg.stake, cfg.slash_fraction,
            cfg.bounty_fraction, cfg.min_stake)
        # a court of its own votes on ``device`` (None: the CUDA device)
        self.court = (court if court is not None
                      else DisputeCourt(num_edges, device=device))
        self.rounds: Dict[int, RoundState] = {}
        self.clock = 0                     # latest round id seen
        # min-heaps keyed by deadline; entries for rounds that left the
        # ACCEPTED/queued state are discarded lazily on pop
        self._open_heap: List[Tuple[int, int]] = []      # (deadline, rid)
        self._audit_heap: List[Tuple[int, int]] = []     # (deadline, rid)
        self._audit_jobs: Dict[int, AuditJob] = {}
        self.rollbacks: List[RollbackRecord] = []
        # phase-transition counters: with a registry these are the live
        # metrics {namespace}.{committed,finalized,rolled_back,...} the
        # obs layer reads (the host passes "trust.train"/"trust.infer"
        # so sibling protocols never collide on metric names)
        self._metrics = metrics
        self._namespace = namespace
        self.stats = CounterGroup(
            {"committed": 0, "finalized": 0, "rolled_back": 0,
             "invalidated": 0, "audited_leaves": 0,
             "fraud_proofs": 0, "escalations": 0,
             "audit_drains": 0},
            metrics, namespace)

    # -------------------------------------------------------- executors
    def pick_executor(self, round_id: int) -> int:
        """Rotate over bonded, non-excluded edges."""
        eligible = [e for e in self.stakes.bonded_edges()
                    if self.reputation is None
                    or not self.reputation.excluded[e]]
        if not eligible:                   # everyone slashed out: reset to 0
            eligible = list(range(self.num_edges))
        return eligible[round_id % len(eligible)]

    # ------------------------------------------------------------ commit
    def commit(self, round_id: int, executor: int, outputs,
               task_digest: str = "", row_index=None,
               num_shards: int = 1) -> RoundState:
        commitment = commit_outputs(
            outputs, round_id=round_id, executor=executor,
            chunks_per_expert=self.cfg.chunks_per_expert,
            task_digest=task_digest, row_index=row_index,
            num_shards=num_shards)
        state = RoundState(round_id=round_id, executor=executor,
                           commitment=commitment, phase=RoundPhase.ACCEPTED,
                           deadline=round_id + self.cfg.challenge_window)
        self.rounds[round_id] = state
        heapq.heappush(self._open_heap, (state.deadline, round_id))
        self.clock = max(self.clock, round_id)
        self.stats["committed"] += 1
        return state

    # ------------------------------------------------------- audit queue
    def schedule_audit(self, round_id: int, recompute_fn: RecomputeFn,
                       batch_recompute_fn: Optional[BatchRecomputeFn] = None
                       ) -> None:
        """Queue round ``round_id``'s audit to run off the critical path
        (any time before its finalization deadline).  The recompute
        closures must capture the round's *snapshot* (the state the
        executor was handed), not the host's live state."""
        state = self.rounds[round_id]
        self._audit_jobs[round_id] = AuditJob(
            round_id=round_id, deadline=state.deadline,
            recompute_fn=recompute_fn,
            batch_recompute_fn=batch_recompute_fn)
        heapq.heappush(self._audit_heap, (state.deadline, round_id))

    def audit_backlog(self) -> List[int]:
        """Queued-but-unaudited rounds, deadline-ordered."""
        return [rid for _, rid in sorted(self._audit_heap)
                if rid in self._audit_jobs]

    def pop_audit_jobs(self, now: Optional[int] = None) -> List[AuditJob]:
        """Claim the audit backlog for a drain.

        Returns ``[]`` unless some queued job is due (deadline <= now) —
        audits stay parked off the critical path until a window is about
        to close.  Once ANY job is due the ENTIRE backlog is handed out,
        deadline-ordered: a drain batches every queued round into one
        grouped recompute (the cross-round analogue of the in-round
        batching).  ``now=None`` forces a full flush.
        """
        if not self._audit_jobs:
            return []
        if now is not None:
            due = [dl for dl, rid in self._audit_heap
                   if rid in self._audit_jobs and dl <= now]
            if not due:
                return []
        jobs: List[AuditJob] = []
        while self._audit_heap:
            _, rid = heapq.heappop(self._audit_heap)
            job = self._audit_jobs.pop(rid, None)
            if job is not None:
                jobs.append(job)
        if jobs:
            self.stats["audit_drains"] += 1
            if self._metrics is not None:
                # audit-burst size: how many windowed rounds one drain
                # hands to the verifier pool at once
                self._metrics.histogram(
                    f"{self._namespace}.audit_burst_rounds",
                    buckets=(1, 2, 4, 8, 16, 32, 64, 128)
                ).observe(len(jobs))
        return jobs

    def drain_audits(self, now: Optional[int] = None
                     ) -> Dict[int, List[FraudProof]]:
        """Run every queued audit that ``pop_audit_jobs`` releases, one
        round at a time (hosts with a cross-round batched recompute — see
        ``BMoESystem`` — pop the jobs themselves and merge the work).
        Returns the confirmed proofs per drained round."""
        out: Dict[int, List[FraudProof]] = {}
        for job in self.pop_audit_jobs(now):
            out[job.round_id] = self.run_audits(
                job.round_id, job.recompute_fn, job.batch_recompute_fn)
        return out

    # ------------------------------------------------------------- audit
    def run_audits(self, round_id: int, recompute_fn: RecomputeFn,
                   batch_recompute_fn: Optional[BatchRecomputeFn] = None
                   ) -> List[FraudProof]:
        """All verifiers audit the round; raised proofs are court-checked
        against the committed root before they count (so a lying verifier
        cannot grief with a fabricated proof).  With
        ``batch_recompute_fn`` the pool audits through one grouped
        recompute (``VerifierPool.audit_batched``), else one eager
        recompute per sampled leaf; the court confirms raised proofs with
        ``recompute_fn`` either way.  ``BMoESystem`` instead pops the jobs
        itself and merges every drained round into one grouped
        recompute."""
        state = self.rounds[round_id]
        if state.phase is not RoundPhase.ACCEPTED:
            return []                  # window already closed or resolved
        if batch_recompute_fn is not None:
            reports = self.verifiers.audit_batched(state.commitment,
                                                   batch_recompute_fn)
        else:
            reports = self.verifiers.audit(state.commitment, recompute_fn)
        return self.apply_reports(round_id, reports, recompute_fn)

    def apply_reports(self, round_id: int, reports: List[AuditReport],
                      recompute_fn: RecomputeFn) -> List[FraudProof]:
        """Record a set of verifier reports for a round and court-check
        any raised proofs (the shared tail of ``run_audits``; hosts that
        batch audits across rounds call this per round afterwards)."""
        state = self.rounds[round_id]
        if state.phase is not RoundPhase.ACCEPTED:
            return []
        state.reports.extend(reports)
        confirmed: List[FraudProof] = []
        for rep in reports:
            self.stats["audited_leaves"] += rep.recomputed_leaves
            for proof in rep.fraud_proofs:
                e, _, sl = state.commitment.leaf_coords(proof.leaf_index)
                if verify_fraud_proof(state.commitment.root, proof,
                                      recompute_fn, sl):
                    confirmed.append(proof)
        # second-layer lottery: spot-check the verifiers' own recompute
        # attestations and slash rubber-stampers out of future lotteries
        self.verifiers.reaudit(state.commitment, reports, recompute_fn)
        if confirmed:
            state.phase = RoundPhase.CHALLENGED
            state.proofs.extend(confirmed)
            self.stats["fraud_proofs"] += len(confirmed)
        return confirmed

    # --------------------------------------------------------- challenge
    def resolve(self, round_id: int, verdict: Verdict) -> RoundState:
        """Court outcome for a challenged round.

        Guilty: slash + reputation + ROLLED_BACK, and every ACCEPTED
        descendant — a round committed on top of the revoked state — is
        INVALIDATED in the same stroke (no slash: those executors
        computed honestly on the state they were handed).  CHALLENGED
        descendants are left for their own court date, so per-round fraud
        is always punished exactly once.  The chain is recorded in
        ``rollbacks`` for the host to restore snapshots / re-execute.

        Innocent (griefing attempt rejected): the round returns to
        ACCEPTED and finalizes at its deadline through ``advance``, in
        deadline order — never out of turn.  If an ancestor was rolled
        back while this round was in dispute (``tainted``), acquittal
        still INVALIDATES it: its commitment stands on revoked state.
        """
        state = self.rounds[round_id]
        state.verdict = verdict
        self.stats["escalations"] += 1
        if verdict.executor_guilty:
            # one slash per convicted round (proofs for further leaves of
            # the same commitment are the same offense)
            self.stakes.slash(state.proofs[0])
            reputation_fraud_update(self.reputation, state.executor,
                                    self.num_edges)
            state.phase = RoundPhase.ROLLED_BACK
            self.stats["rolled_back"] += 1
            invalidated = (self._invalidate_descendants(round_id)
                           if self.chained else [])
            self.rollbacks.append(RollbackRecord(
                round_id=round_id, executor=state.executor,
                invalidated=invalidated, at_clock=self.clock))
            if self._metrics is not None:
                # chain length of the rollback: the convicted round plus
                # every optimistic descendant it voided
                self._metrics.histogram(
                    f"{self._namespace}.rollback_chain_rounds",
                    buckets=(1, 2, 4, 8, 16, 32, 64, 128)
                ).observe(1 + len(invalidated))
        elif state.tainted:
            state.phase = RoundPhase.INVALIDATED
            self.stats["invalidated"] += 1
        else:
            state.phase = RoundPhase.ACCEPTED
        return state

    def resolve_by_recompute(self, round_id: int,
                             recompute_fn: RecomputeFn) -> RoundState:
        """Court for hosts whose committed computation has no M-way
        redundancy matrix to vote over (federated aggregation: each delta
        is published once, not recomputed by M edges).  The court settles
        the dispute by recomputing EVERY leaf of the challenged
        commitment from the committed inputs — the executor is guilty iff
        any recomputed leaf digest differs from the committed one, and
        the verdict's trusted tensor is the full honest recompute.  Costs
        O(one honest execution) instead of O(M); same ``resolve`` tail
        (slash, chained rollback, sequential finality)."""
        state = self.rounds[round_id]
        com = state.commitment
        trusted = np.array(com.claimed, copy=True)
        guilty = False
        for leaf in range(com.num_leaves):
            e, _, sl = com.leaf_coords(leaf)
            chunk = np.asarray(recompute_fn(e, sl))
            trusted[e, sl] = chunk
            if leaf_digest(chunk) != com.leaf_digests[leaf]:
                guilty = True
        flags = np.ones((com.num_experts, self.num_edges), np.int32)
        if guilty:
            flags[:, state.executor] = 0
        verdict = Verdict(round_id=round_id, trusted=trusted,
                          support=np.full(com.num_experts,
                                          float(self.num_edges)),
                          flags=flags, executor_guilty=guilty)
        self.court.cases.append(verdict)
        return self.resolve(round_id, verdict)

    def _invalidate_descendants(self, round_id: int) -> List[int]:
        """Void every ACCEPTED round built (transitively) on ``round_id``:
        with sequential finality nothing after a rolled-back round can
        have finalized, so the open heap holds the whole chain.
        CHALLENGED descendants are only *tainted* — their own court still
        rules (guilty: slashed; innocent: invalidated anyway)."""
        invalidated = []
        for _, rid in sorted(self._open_heap):
            if rid <= round_id:
                continue
            state = self.rounds[rid]
            if state.phase is RoundPhase.ACCEPTED:
                state.phase = RoundPhase.INVALIDATED
                self.stats["invalidated"] += 1
                # its audit (if still queued) is moot: the commitment is
                # void with its ancestor, not fraud by this executor
                self._audit_jobs.pop(rid, None)
                invalidated.append(rid)
            elif state.phase is RoundPhase.CHALLENGED:
                state.tainted = True
        return invalidated

    # ---------------------------------------------------------- finalize
    def advance(self, now: int) -> List[int]:
        """Close challenge windows in deadline order: every ACCEPTED round
        whose deadline passed becomes FINALIZED — but never past an
        unresolved CHALLENGED round.  Finality is sequential: a round
        built on a disputed ancestor waits for the dispute (and is
        invalidated with it if the ancestor is convicted)."""
        self.clock = max(self.clock, now)
        done = []
        requeue = []
        while self._open_heap:
            deadline, rid = self._open_heap[0]
            if deadline > now:
                break
            state = self.rounds[rid]
            if state.phase is RoundPhase.CHALLENGED:
                if self.chained:
                    break                  # dispute blocks all successors
                heapq.heappop(self._open_heap)
                requeue.append((deadline, rid))   # awaits its own court
                continue
            heapq.heappop(self._open_heap)
            if state.phase is RoundPhase.ACCEPTED:
                state.phase = RoundPhase.FINALIZED
                self.stats["finalized"] += 1
                done.append(rid)
            # terminal phases (resolved/invalidated): stale entry, drop
        for entry in requeue:
            heapq.heappush(self._open_heap, entry)
        return done

    def pending(self) -> List[int]:
        """Open rounds (ACCEPTED or awaiting court), deadline-ordered.
        Touches only the open heap — O(open), not O(history)."""
        return [rid for _, rid in sorted(self._open_heap)
                if self.rounds[rid].phase in (RoundPhase.ACCEPTED,
                                              RoundPhase.CHALLENGED)]


class ChallengeWindow:
    """Minimal tick-based finalization tracker for streaming hosts (the
    serving engine): items become final ``window`` ticks after entry
    unless revoked.  ``enter`` on an already-pending item refreshes its
    deadline; ``revoke`` after expiry is a no-op (final is final)."""

    def __init__(self, window: int):
        self.window = int(window)
        self._pending: Dict[int, int] = {}      # item id -> deadline tick
        self.revoked: List[int] = []

    def enter(self, item_id: int, now: int) -> None:
        self._pending[item_id] = now + self.window

    def revoke(self, item_id: int) -> None:
        if item_id in self._pending:
            del self._pending[item_id]
            self.revoked.append(item_id)

    def expire(self, now: int) -> List[int]:
        done = [i for i, dl in self._pending.items() if now >= dl]
        for i in done:
            del self._pending[i]
        return done

    def hold(self, item_id: int, deadline: int) -> None:
        """Re-park an expired-but-blocked item with an explicit deadline
        (the host's sequential-finality deferral)."""
        self._pending[item_id] = int(deadline)

    def deadline(self, item_id: int) -> Optional[int]:
        return self._pending.get(item_id)

    def __len__(self) -> int:
        return len(self._pending)
