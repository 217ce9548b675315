"""The verifier pool: sampled recompute and fraud proofs (a copy of
``repro.trust.audit``: numpy only).

Each verifier independently samples committed leaves with probability
``audit_rate``, fetches the expert that produced the leaf from the
storage layer by CID (content-addressed, so a tampered replica is
self-evident), recomputes the chunk on the published task, and compares
digests.  A mismatch yields a ``FraudProof``: the claimed leaf chunk plus
its Merkle path — enough for anyone holding the on-chain root to confirm
(a) the executor really committed that leaf and (b) the honest recompute
disagrees.  An executor corrupting ``k`` leaves is caught by one honest
verifier with probability ``1 - (1-audit_rate)**k``; with ``v``
independent honest verifiers the exponent becomes ``k*v``.

Lazy verifiers (rubber-stampers that skip their recompute) are modeled
with ``lazy_prob`` — they sample leaves but never raise proofs, which is
how audit-evasion scenarios are expressed.

The lottery is *stake-weighted* when the pool is given per-verifier
``stakes``: verifier ``v`` samples each leaf with probability
``pool_rate * stake_v / sum(stakes)`` (``pool_rate`` = the per-verifier
base rate x the pool size), so the pool-wide expected sampled fraction
is conserved while high-stake verifiers carry proportionally more of the
audit load — the simulation analogue of a stake-weighted VRF lottery.
Lazy verifiers are *caught by re-audit*: every recomputing verifier must
attest ``H(salt_{round,verifier} || recomputed_chunk)`` per sampled leaf
(``attestation_digest``); the salt makes the attestation underivable
from the executor's published leaf digests, so a rubber-stamper's echo
fails any spot-check — even on honest rounds — and its stake is slashed
(``reaudit``), shrinking its share of every future lottery.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.ledger import digest_bytes
from repro_torch.obs.metrics import CounterGroup, MetricsRegistry
from repro_torch.trust.commitments import (MerklePath, MerkleTree,
                                           RoundCommitment, leaf_digest,
                                           leaf_digest_batch)

# recompute_fn(expert_index, batch_slice) -> honest output chunk
RecomputeFn = Callable[[int, slice], np.ndarray]

# batch_recompute_fn(expert_indices, batch_slices) -> stacked honest
# chunks (S, Cmax, ...): row s covers slices[s] of experts[s]'s output,
# padded past the slice length (padding rows are never hashed).  One
# call recomputes every sampled leaf of a round — the host backs it
# with a single jitted grouped kernel instead of S eager dispatches.
BatchRecomputeFn = Callable[[Sequence[int], Sequence[slice]], np.ndarray]

# multi_batch_recompute_fn(round_slots, expert_indices, batch_slices) ->
# stacked honest chunks (S, Cmax, ...): like BatchRecomputeFn but rows
# may belong to DIFFERENT rounds — ``round_slots[s]`` indexes the round
# (in the order the commitments were handed to ``audit_rounds``) whose
# snapshot state and task row ``s`` must be recomputed against.  One
# call covers a whole drained audit backlog: the host stacks the
# per-round expert-bank snapshots and concatenates the per-round tasks
# so several rounds' audits fuse into one grouped kernel dispatch.
MultiBatchRecomputeFn = Callable[
    [Sequence[int], Sequence[int], Sequence[slice]], np.ndarray]


def pack_audit_batch(expert_ids: Sequence[int], slices: Sequence[slice],
                     bucket: int = 4,
                     row_map: Optional[np.ndarray] = None):
    """Pack a deduped (expert, slice) work list for a grouped recompute.

    Returns ``(idx, gid, n)``: ``idx`` is ``(Sp, Cmax)`` int32 batch-row
    indices per sample (rows past a slice's width point at row 0 — pure
    padding, trimmed before hashing), ``gid`` the ``(Sp,)`` int32 expert
    per sample, ``n`` the real sample count.  ``Sp`` buckets ``n`` up to
    a multiple of ``bucket`` so a jitted consumer retraces O(1) times.

    Dense commitments slice the task directly (``idx`` rows are the
    slice's own indices).  Sparse commitments pass ``row_map`` — the
    commitment's ``(N, capacity)`` routing indices — and slot ``s`` of
    expert ``e``'s bucket reads task row ``row_map[e, s]`` (empty slots
    point one past the batch, at the zero sentinel row the host appends).
    The commitment build (``BMoESystem._eager_outputs``) packs its
    leaves here, and the drains' ``pack_audit_batch_multi`` packs the
    same way, so the executor and the auditors agree row for row.
    """
    n = len(expert_ids)
    sp = -(-n // bucket) * bucket
    cmax = max(sl.stop - sl.start for sl in slices)
    idx = np.zeros((sp, cmax), np.int32)
    gid = np.zeros(sp, np.int32)
    for s, (e, sl) in enumerate(zip(expert_ids, slices)):
        rows = (np.arange(sl.start, sl.stop) if row_map is None
                else row_map[int(e), sl.start:sl.stop])
        idx[s, :sl.stop - sl.start] = rows
        gid[s] = int(e)
    return idx, gid, n


def pack_audit_batch_multi(slots: Sequence[int], expert_ids: Sequence[int],
                           slices: Sequence[slice],
                           row_offsets: Sequence[int], num_experts: int,
                           bucket: int = 4,
                           row_maps: Optional[Sequence[
                               Optional[np.ndarray]]] = None):
    """Cross-round variant of ``pack_audit_batch``: the work list spans
    several rounds whose expert banks are stacked to ``(R*N, ...)`` and
    whose tasks are concatenated row-wise.  Sample ``s`` of round slot
    ``k = slots[s]`` reads task rows ``row_offsets[k] + slice`` and
    expert ``k * num_experts + expert_ids[s]`` — so one grouped kernel
    call recomputes a whole drained audit backlog.  ``row_maps[k]``, when
    set, is round ``k``'s sparse routing (see ``pack_audit_batch``): the
    slice then indexes bucket slots and the task rows come from the
    committed routing.  Returns the same ``(idx, gid, n)`` contract as
    ``pack_audit_batch``.
    """
    n = len(expert_ids)
    sp = -(-n // bucket) * bucket
    cmax = max(sl.stop - sl.start for sl in slices) if n else 1
    idx = np.zeros((sp, cmax), np.int32)
    gid = np.zeros(sp, np.int32)
    for s, (k, e, sl) in enumerate(zip(slots, expert_ids, slices)):
        off = int(row_offsets[k])
        rmap = row_maps[k] if row_maps is not None else None
        rows = (np.arange(sl.start, sl.stop) if rmap is None
                else rmap[int(e), sl.start:sl.stop])
        idx[s, :sl.stop - sl.start] = off + rows
        gid[s] = int(k) * num_experts + int(e)
    return idx, gid, n


def attestation_digest(round_id: int, verifier: int,
                       chunk: np.ndarray) -> str:
    """Salted proof-of-recompute a verifier attests per sampled leaf.

    Domain-separated per (round, verifier): it can only be produced from
    the recomputed chunk *bytes*, never derived from the executor's
    published ``leaf_digest`` — which is exactly what lets a re-audit
    distinguish a real recompute from a rubber-stamp."""
    a = np.ascontiguousarray(chunk)
    salt = f"attest:{round_id}:{verifier}:".encode()
    return digest_bytes(salt + a.tobytes() + str(a.shape).encode()
                        + str(a.dtype).encode())


@dataclasses.dataclass
class LazySlashEvent:
    """A verifier caught rubber-stamping by re-audit."""
    round_id: int
    verifier: int
    leaf_index: int
    amount: float


@dataclasses.dataclass(frozen=True)
class FraudProof:
    round_id: int
    executor: int
    leaf_index: int
    expert: int
    claimed_chunk: np.ndarray               # the committed (bad) leaf data
    path: MerklePath
    claimed_digest: str
    recomputed_digest: str
    verifier: int = -1

    def compact_size_bytes(self) -> int:
        """On-wire size: one chunk + log2(leaves) siblings (32B each)."""
        return self.claimed_chunk.nbytes + 32 * len(self.path.siblings)


@dataclasses.dataclass(frozen=True)
class AuditPlan:
    """Every verifier's lottery for one round, drawn up front.

    ``unique_leaves`` dedupes across verifiers: a leaf sampled by three
    non-lazy verifiers is recomputed once, not three times (each verifier
    still gets the digest for its own report/fraud proof).  ``owner``
    credits the recompute to the first non-lazy verifier that sampled the
    leaf, so summed ``recomputed_leaves`` equals real recompute work.
    """
    round_id: int
    sampled: Dict[int, List[int]]          # verifier -> sampled leaves
    lazy: Dict[int, bool]
    unique_leaves: List[int]               # deduped, ascending
    owner: Dict[int, int]                  # leaf -> crediting verifier

    @property
    def num_recomputes(self) -> int:
        return len(self.unique_leaves)


@dataclasses.dataclass
class AuditReport:
    """One verifier pass over one round commitment.

    ``attestations`` (leaf -> salted recompute digest) are only filled
    when the pool re-audits (``reaudit_rate > 0``): honest verifiers
    attest from the recomputed bytes, lazy ones echo the executor's
    published digests — the only data available without recomputing."""
    round_id: int
    verifier: int
    sampled_leaves: List[int]
    fraud_proofs: List[FraudProof]
    recomputed_leaves: int = 0
    lazy: bool = False
    attestations: Dict[int, str] = dataclasses.field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.fraud_proofs


def verify_fraud_proof(root: str, proof: FraudProof,
                       recompute_fn: Optional[RecomputeFn] = None,
                       batch_slice: Optional[slice] = None) -> bool:
    """Anyone-can-check verdict on a fraud proof.

    Confirms (1) the claimed chunk is really committed under ``root``
    (Merkle path), and (2) its digest differs from the honest recompute.
    When ``recompute_fn`` is given the recompute is redone here (the
    court's own computation); otherwise the proof's recorded
    ``recomputed_digest`` is trusted (a verifier-signed attestation).
    """
    claimed = leaf_digest(proof.claimed_chunk)
    if claimed != proof.claimed_digest:
        return False
    if not MerkleTree.verify(root, claimed, proof.path):
        return False                      # not actually committed: griefing
    if recompute_fn is not None and batch_slice is not None:
        honest = leaf_digest(np.asarray(recompute_fn(proof.expert,
                                                     batch_slice)))
        return honest != claimed
    return proof.recomputed_digest != claimed


class VerifierPool:
    """``num_verifiers`` independent auditors with a shared audit rate.

    Deterministic given ``seed`` and the round id, so audit schedules are
    reproducible (and an executor cannot predict them without the seed —
    the simulation analogue of a VRF-drawn audit lottery).
    """

    def __init__(self, num_verifiers: int = 3, audit_rate: float = 0.1,
                 lazy_prob: float = 0.0, seed: int = 0,
                 stakes: Optional[Sequence[float]] = None,
                 reaudit_rate: float = 0.0,
                 verifier_slash_fraction: float = 0.5,
                 metrics: Optional[MetricsRegistry] = None,
                 namespace: str = "trust.verifiers"):
        self.num_verifiers = num_verifiers
        self.audit_rate = float(audit_rate)
        self.lazy_prob = float(lazy_prob)
        self._seed = seed
        # stake-weighted lottery: None keeps the uniform split (and the
        # exact sampling streams of the pre-stake pool); re-audits need
        # a stake to burn, so they default an unstaked pool to 1.0 each
        if stakes is None and reaudit_rate > 0:
            stakes = np.ones(num_verifiers)
        if stakes is not None:
            stakes = np.asarray(stakes, np.float64).copy()
            if stakes.shape != (num_verifiers,):
                raise ValueError(f"{stakes.shape} stakes for "
                                 f"{num_verifiers} verifiers")
            if (stakes < 0).any():
                raise ValueError("verifier stakes must be >= 0")
        self.stakes = stakes
        self.reaudit_rate = float(reaudit_rate)
        self.verifier_slash_fraction = float(verifier_slash_fraction)
        self.lazy_slashes: List[LazySlashEvent] = []
        # one ledger for every audit path (eager, batched, cross-round
        # burst): the pool's workload as the obs layer sees it
        self.stats = CounterGroup(
            {"audit_passes": 0, "lazy_passes": 0, "sampled_leaves": 0,
             "recomputed_leaves": 0, "fraud_proofs": 0,
             "reaudit_slashes": 0},
            metrics, namespace)

    def _count_report(self, report: "AuditReport") -> None:
        self.stats["audit_passes"] += 1
        self.stats["sampled_leaves"] += len(report.sampled_leaves)
        self.stats["recomputed_leaves"] += report.recomputed_leaves
        self.stats["fraud_proofs"] += len(report.fraud_proofs)
        if report.lazy:
            self.stats["lazy_passes"] += 1

    def _rng(self, round_id: int, verifier: int,
             salt: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            ((self._seed * 1_000_003 + round_id) * 97 + verifier) * 31 + salt)

    def rate_of(self, verifier: int) -> float:
        """Verifier ``verifier``'s per-leaf sampling probability: its
        stake share of the pool-wide budget ``audit_rate * V`` (uniform
        pools: exactly ``audit_rate``).  The sum over verifiers is
        conserved at the pool-wide rate — unless a share is clipped at
        1.0, sampling probabilities being probabilities."""
        if self.stakes is None:
            return self.audit_rate
        total = float(self.stakes.sum())
        if total <= 0.0:
            return 0.0                    # fully-slashed pool audits nothing
        # (stake * V) / total first: exactly 1.0 for a uniform pool, so
        # equal stakes reproduce the unweighted sampling streams bit-
        # for-bit (pinned in tests/test_verifier_lottery.py)
        share = float(self.stakes[verifier]) * self.num_verifiers / total
        return min(1.0, self.audit_rate * share)

    def sample_leaves(self, round_id: int, verifier: int,
                      num_leaves: int) -> List[int]:
        rng = self._rng(round_id, verifier)
        keep = rng.random(num_leaves) < self.rate_of(verifier)
        return [int(i) for i in np.nonzero(keep)[0]]

    def audit_one(self, commitment: RoundCommitment,
                  recompute_fn: RecomputeFn, verifier: int) -> AuditReport:
        """One verifier's pass: sample, recompute, emit fraud proofs."""
        # distinct stream from sample_leaves: the lazy coin must not be
        # correlated with which leaves get sampled (a shared first draw
        # would silently lower leaf 0's effective audit rate)
        lazy = bool(self._rng(commitment.round_id, verifier,
                              salt=1).random() < self.lazy_prob)
        sampled = self.sample_leaves(commitment.round_id, verifier,
                                     commitment.num_leaves)
        report = AuditReport(round_id=commitment.round_id, verifier=verifier,
                             sampled_leaves=sampled, fraud_proofs=[],
                             lazy=lazy)
        if lazy:
            # rubber-stamp: no recompute.  When attestations are due the
            # lazy verifier echoes the executor's published digests —
            # the only bytes it holds — which can never match the salted
            # attestation a re-audit recomputes.
            if self.reaudit_rate > 0:
                report.attestations = {
                    leaf: commitment.leaf_digests[leaf] for leaf in sampled}
            self._count_report(report)
            return report
        tree = commitment.tree()
        for leaf in sampled:
            e, _, sl = commitment.leaf_coords(leaf)
            chunk = np.asarray(recompute_fn(e, sl))
            honest = leaf_digest(chunk)
            if self.reaudit_rate > 0:
                report.attestations[leaf] = attestation_digest(
                    commitment.round_id, verifier, chunk)
            report.recomputed_leaves += 1
            claimed = commitment.leaf_digests[leaf]
            if honest != claimed:
                report.fraud_proofs.append(FraudProof(
                    round_id=commitment.round_id,
                    executor=commitment.executor, leaf_index=leaf, expert=e,
                    claimed_chunk=commitment.leaf_chunk(leaf),
                    path=tree.prove(leaf), claimed_digest=claimed,
                    recomputed_digest=honest, verifier=verifier))
        self._count_report(report)
        return report

    def audit(self, commitment: RoundCommitment,
              recompute_fn: RecomputeFn,
              verifiers: Optional[Sequence[int]] = None) -> List[AuditReport]:
        ids = range(self.num_verifiers) if verifiers is None else verifiers
        return [self.audit_one(commitment, recompute_fn, v) for v in ids]

    # ------------------------------------------------------ batched path
    def plan_audits(self, round_id: int, num_leaves: int,
                    verifiers: Optional[Sequence[int]] = None) -> AuditPlan:
        """Draw every verifier's lottery up front (same RNG streams as
        ``audit_one``, so the plan is sample-for-sample identical to the
        eager path) and dedupe the recompute work across verifiers."""
        ids = list(range(self.num_verifiers) if verifiers is None
                   else verifiers)
        sampled = {v: self.sample_leaves(round_id, v, num_leaves)
                   for v in ids}
        lazy = {v: bool(self._rng(round_id, v, salt=1).random()
                        < self.lazy_prob) for v in ids}
        owner: Dict[int, int] = {}
        for v in ids:                       # verifier order fixes ownership
            if lazy[v]:
                continue
            for leaf in sampled[v]:
                owner.setdefault(leaf, v)
        return AuditPlan(round_id=round_id, sampled=sampled, lazy=lazy,
                         unique_leaves=sorted(owner), owner=owner)

    def audit_batched(self, commitment: RoundCommitment,
                      batch_recompute_fn: BatchRecomputeFn,
                      verifiers: Optional[Sequence[int]] = None
                      ) -> List[AuditReport]:
        """The whole pool's audit pass as ONE recompute call.

        Plans all lotteries, gathers the deduped (expert, slice) work
        list, recomputes it in a single ``batch_recompute_fn`` call, and
        hashes every recomputed chunk in one ``leaf_digest_batch`` pass.
        Per-verifier reports (sampled leaves, lazy flags, fraud proofs)
        are identical to ``audit``'s; only ``recomputed_leaves`` differs —
        it now counts real (deduped) recompute work, credited to the
        first non-lazy sampler of each leaf.
        """
        plan = self.plan_audits(commitment.round_id, commitment.num_leaves,
                                verifiers)
        digest_of: Dict[int, str] = {}
        chunk_of: Optional[Dict[int, np.ndarray]] = None
        if plan.unique_leaves:
            coords = [commitment.leaf_coords(leaf)
                      for leaf in plan.unique_leaves]
            experts = [e for e, _, _ in coords]
            slices = [sl for _, _, sl in coords]
            stacked = np.asarray(batch_recompute_fn(experts, slices))
            lengths = [sl.stop - sl.start for sl in slices]
            digests = leaf_digest_batch(stacked, lengths)
            digest_of = dict(zip(plan.unique_leaves, digests))
            if self.reaudit_rate > 0:
                chunk_of = {leaf: stacked[i, :lengths[i]]
                            for i, leaf in enumerate(plan.unique_leaves)}
        return self._reports_from_digests(commitment, plan, digest_of,
                                          chunk_of)

    def _reports_from_digests(self, commitment: RoundCommitment,
                              plan: AuditPlan, digest_of: Dict[int, str],
                              chunk_of: Optional[Dict[int, np.ndarray]] = None
                              ) -> List[AuditReport]:
        """Per-verifier reports/fraud proofs from a plan plus the honest
        digests (and, when re-audits are on, the recomputed bytes) of its
        unique leaves (shared by ``audit_batched`` and the cross-round
        ``audit_rounds``)."""
        tree = None
        reports = []
        for v, leaves in plan.sampled.items():
            report = AuditReport(round_id=commitment.round_id, verifier=v,
                                 sampled_leaves=leaves, fraud_proofs=[],
                                 lazy=plan.lazy[v])
            reports.append(report)
            if plan.lazy[v]:
                if self.reaudit_rate > 0:
                    report.attestations = {
                        leaf: commitment.leaf_digests[leaf]
                        for leaf in leaves}
                continue
            report.recomputed_leaves = sum(
                1 for leaf in leaves if plan.owner.get(leaf) == v)
            for leaf in leaves:
                honest = digest_of[leaf]
                if chunk_of is not None:
                    report.attestations[leaf] = attestation_digest(
                        commitment.round_id, v, chunk_of[leaf])
                claimed = commitment.leaf_digests[leaf]
                if honest != claimed:
                    if tree is None:
                        tree = commitment.tree()
                    e, _, _ = commitment.leaf_coords(leaf)
                    report.fraud_proofs.append(FraudProof(
                        round_id=commitment.round_id,
                        executor=commitment.executor, leaf_index=leaf,
                        expert=e, claimed_chunk=commitment.leaf_chunk(leaf),
                        path=tree.prove(leaf), claimed_digest=claimed,
                        recomputed_digest=honest, verifier=v))
        for report in reports:
            self._count_report(report)
        return reports

    def audit_rounds(self, commitments: Sequence[RoundCommitment],
                     multi_recompute_fn: MultiBatchRecomputeFn,
                     verifiers: Optional[Sequence[int]] = None
                     ) -> Dict[int, List[AuditReport]]:
        """A whole drained audit *backlog* as ONE recompute call.

        The pipelined protocol parks each round's audit until its window
        is about to close, then drains the backlog in a burst; this is
        the burst's engine.  Every round's lottery is planned exactly as
        ``audit_batched`` would (same RNG streams, keyed by round id, so
        reports are round-for-round identical to draining one at a
        time), the deduped work lists are concatenated with a round-slot
        tag per row, recomputed in a single ``multi_recompute_fn`` call,
        and hashed in one ``leaf_digest_batch`` pass.  Returns reports
        keyed by round id.
        """
        plans = [self.plan_audits(c.round_id, c.num_leaves, verifiers)
                 for c in commitments]
        slots: List[int] = []
        experts: List[int] = []
        slices: List[slice] = []
        for k, (com, plan) in enumerate(zip(commitments, plans)):
            for leaf in plan.unique_leaves:
                e, _, sl = com.leaf_coords(leaf)
                slots.append(k)
                experts.append(e)
                slices.append(sl)
        digests: List[str] = []
        stacked = None
        lengths = [sl.stop - sl.start for sl in slices]
        if slots:
            stacked = np.asarray(multi_recompute_fn(slots, experts, slices))
            digests = leaf_digest_batch(stacked, lengths)
        out: Dict[int, List[AuditReport]] = {}
        cursor = 0
        for com, plan in zip(commitments, plans):
            span = range(cursor, cursor + len(plan.unique_leaves))
            digest_of = dict(zip(plan.unique_leaves,
                                 [digests[i] for i in span]))
            chunk_of = ({leaf: stacked[i, :lengths[i]]
                         for leaf, i in zip(plan.unique_leaves, span)}
                        if self.reaudit_rate > 0 and stacked is not None
                        else None)
            cursor += len(plan.unique_leaves)
            out[com.round_id] = self._reports_from_digests(com, plan,
                                                           digest_of,
                                                           chunk_of)
        return out

    # -------------------------------------------------------- re-audit
    def reaudit(self, commitment: RoundCommitment,
                reports: Sequence[AuditReport],
                recompute_fn: RecomputeFn) -> List[int]:
        """Second-layer audit of the auditors: spot-check each verifier's
        attestations at ``reaudit_rate`` per sampled leaf.

        The expected attestation is recomputed from the honest chunk
        bytes with the (round, verifier) salt; a verifier whose submitted
        attestation differs — a rubber-stamper echoing published digests,
        or one that attested garbage — is slashed
        (``verifier_slash_fraction`` of its stake burned, which also
        shrinks its share of every future stake-weighted lottery).  One
        slash per (round, verifier).  Returns the caught verifier ids.
        """
        if self.reaudit_rate <= 0 or self.stakes is None:
            return []
        caught: List[int] = []
        cache: Dict[int, np.ndarray] = {}
        for report in reports:
            rng = self._rng(commitment.round_id, report.verifier, salt=2)
            coins = rng.random(len(report.sampled_leaves))
            for leaf, coin in zip(report.sampled_leaves, coins):
                if coin >= self.reaudit_rate:
                    continue
                if leaf not in cache:
                    e, _, sl = commitment.leaf_coords(leaf)
                    cache[leaf] = np.asarray(recompute_fn(e, sl))
                expected = attestation_digest(commitment.round_id,
                                              report.verifier, cache[leaf])
                if report.attestations.get(leaf) != expected:
                    amount = float(self.stakes[report.verifier]
                                   * self.verifier_slash_fraction)
                    self.stakes[report.verifier] -= amount
                    self.lazy_slashes.append(LazySlashEvent(
                        round_id=commitment.round_id,
                        verifier=report.verifier, leaf_index=leaf,
                        amount=amount))
                    self.stats["reaudit_slashes"] += 1
                    caught.append(report.verifier)
                    break                  # one slash per (round, verifier)
        return caught

    def detection_probability(self, corrupted_leaves: int,
                              honest_verifiers: Optional[int] = None) -> float:
        """Analytic bound: P[>=1 corrupted leaf sampled by an honest
        verifier].

        Uniform pool: ``1 - (1-audit_rate)^(k*v)``.  Stake-weighted
        pool: each verifier's per-leaf rate is its ``rate_of``, so the
        bound is ``1 - prod_v (1-rate_v)^k`` over the honest verifiers —
        and with only a *count* of honest verifiers given, the v
        LOWEST-rate verifiers are assumed honest (the conservative
        bound: any other honest set detects at least as well)."""
        v = (self.num_verifiers if honest_verifiers is None
             else honest_verifiers)
        if self.stakes is None:
            return 1.0 - (1.0 - self.audit_rate) ** (corrupted_leaves * v)
        rates = sorted(self.rate_of(i) for i in range(self.num_verifiers))
        miss = 1.0
        for r in rates[:v]:
            miss *= (1.0 - r) ** corrupted_leaves
        return 1.0 - miss
