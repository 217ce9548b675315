"""Federated B-MoE training rounds with ledger-verified aggregation (the
counterpart of ``repro.fed.coordinator``).

One ``FedCoordinator`` round:

1. **Plan** — every non-evicted edge draws (dropout?, speed) from a
   seeded per-(round, edge) stream.  Dropped edges go silent for the
   round; slow edges model stragglers (``straggler_factor`` x compute
   time, plus always-slow ``slow_edges``).
2. **Local training** — each participating edge trains its Dirichlet
   shard with the expert-masked local step and publishes its weight
   delta through the chunk-dedup store (``fed/delta/{edge}`` @ round).
3. **Deadline** — deltas whose modeled arrival (compute + upload
   seconds) beats ``deadline_s`` are received; the rest straggle.  A
   straggler's delta is carried into the next round (``late_policy=
   "carry"``) or dropped; ``evict_after`` consecutive late rounds evicts
   the edge so the round clock NEVER waits on a sick device.
4. **Quorum** — fewer than ``min_quorum`` received deltas makes the
   round a committed no-op (global parameters unchanged, received deltas
   carry forward); the clock still advances.
5. **Verified aggregation** — the executor (rotating bonded edge) runs
   the aggregation rule and commits a Merkle root over the resulting
   ``(N + 1, P)`` parameter rows; the round block also carries
   ``aggregation_root`` — one root binding (participant set, per-edge
   delta manifest CIDs, result root).  Delta manifests are retained for
   the challenge window.  ``VerifierPool`` auditors later recompute the
   aggregation from the committed manifests off the critical path; a
   dishonest aggregator (result substitution, or skipping the poison
   screen for a colluding edge) becomes a confirmed fraud proof, and the
   court (``resolve_by_recompute``) slashes it and rolls back: the
   coordinator restores the round's snapshot and re-executes every
   voided round honestly — the paper's claim that aggregation needs no
   trusted server, only a bonded one.

The adversary model is split across layers on purpose: poisoned
*updates* are the aggregation rule's problem (clip + cosine screen —
``fed.aggregate``), a poisoned *aggregator* is the trust layer's
problem (commit/audit/slash/rollback).  A colluding aggregator that
"forgets" to screen an accomplice's poison is caught by the second
layer: auditors recompute with the honest rule, the roots differ, the
fraud proof lands.

Where the state lives: the global parameters are a float32 numpy tree
on the host, as in the JAX package — they are what the round's task
digest hashes, what ``aggregate`` starts from and what rollback
restores.  Local training and ``evaluate`` run on the coordinator's
device (``None``: the CUDA device) from one copy of the global state
there, made once per new global state and shared by every edge (the
local step is functional, so no edge can disturb another's start or a
round's snapshot).  Each edge's delta comes back to the host once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import experts as ex
from repro_torch.core.consensus import ProofOfWork
from repro_torch.core.ledger import (Ledger, as_numpy, digest_tree,
                                     tree_flatten, tree_unflatten)
from repro_torch.core.reputation import ReputationConfig, ReputationLedger
from repro_torch.data.synthetic import dirichlet_shards
from repro_torch.fed.aggregate import (aggregate, aggregation_root,
                                       aggregation_task_digest, commit_rows,
                                       flat_to_tree, make_recompute,
                                       tree_to_flat)
from repro_torch.fed.edge import DeltaRecord, FedEdge, _to_device
from repro_torch.kernels.ops import resolve_device
from repro_torch.obs import CounterGroup, Observability
from repro_torch.storage import ExpertStore, NetworkCostModel, StorageNetwork
from repro_torch.train.step import make_fed_local_step
from repro_torch.trust.protocol import (TERMINAL_PHASES, OptimisticProtocol,
                                        RoundPhase, TrustConfig)


@dataclasses.dataclass(frozen=True)
class FedAttack:
    """What the adversary controls this run."""
    malicious_edges: Tuple[int, ...] = ()
    update_attack: str = "none"        # none | grad_scale | sign_flip
    scale: float = 20.0                # poison magnitude multiplier
    dishonest_aggregator: bool = False
    # substitute: commit honest-looking garbage instead of the real
    #   aggregate.  unscreened: run plain FedAvg (no clip, no screen) so
    #   a colluding edge's poison lands — both diverge from the
    #   committed rule and are provable by recompute.
    aggregator_mode: str = "substitute"
    substitute_std: float = 0.1


@dataclasses.dataclass(frozen=True)
class FedConfig:
    # population / model
    num_edges: int = 8
    num_experts: int = 8
    experts_per_edge: int = 2
    top_k: int = 2
    in_dim: int = 784
    hidden: int = 32
    num_classes: int = 10
    lr: float = 0.2
    local_steps: int = 4
    local_batch: int = 64
    alpha: float = 0.5                 # Dirichlet non-IID concentration
    seed: int = 0
    # aggregation
    rule: str = "defended"             # defended | fedavg
    clip_mult: float = 3.0
    cos_min: float = 0.0
    min_quorum: int = 2
    # robustness injection (modeled round clock, deterministic)
    deadline_s: float = 1.0
    base_step_s: float = 0.02          # modeled seconds per local step
    straggler_prob: float = 0.0
    straggler_factor: float = 25.0
    slow_edges: Tuple[int, ...] = ()   # always-straggling edges
    dropout_prob: float = 0.0
    evict_after: int = 3               # consecutive late rounds -> evict
    late_policy: str = "carry"         # carry | drop
    # verification / chain
    verify: str = "optimistic"         # optimistic | off
    trust: TrustConfig = dataclasses.field(
        default_factory=lambda: TrustConfig(chunks_per_expert=4))
    attack: FedAttack = dataclasses.field(default_factory=FedAttack)
    pow_difficulty: int = 6
    # storage
    storage_nodes: int = 4
    replication: int = 2
    chunk_bytes: int = 1 << 14


class FedCoordinator:
    """Runs federated rounds; owns the global model, the chain, the
    store and the trust protocol (namespace ``trust.fed``).

    ``params``: the initial ``{"gate", "experts"}`` tree (tensors or
    arrays, e.g. ``convert.params_from_numpy``'s); ``None`` draws the
    port's seeded init from ``cfg.seed``, which does not depend on the
    device."""

    def __init__(self, cfg: FedConfig, x, y,
                 obs: Optional[Observability] = None, device=None,
                 params: Optional[Dict[str, Dict]] = None):
        if cfg.experts_per_edge < 1:
            raise ValueError("experts_per_edge must be >= 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.obs = obs if obs is not None else Observability()
        if params is None:
            experts, self.apply_all = ex.make_expert_bank(
                "mlp", cfg.num_experts, cfg.seed, in_dim=cfg.in_dim,
                hidden=cfg.hidden, out=cfg.num_classes, device="cpu")
            params = {"gate": ex.init_gate(cfg.in_dim, cfg.num_experts,
                                           cfg.seed, device="cpu"),
                      "experts": experts}
        else:
            self.apply_all = ex.apply_all_fn("mlp")
        self.global_params = {
            part: {k: np.array(as_numpy(v), np.float32)
                   for k, v in params[part].items()}
            for part in ("gate", "experts")}
        self._mirror: Optional[Tuple[dict, dict]] = None
        # storage + chain
        self.storage = StorageNetwork(
            num_nodes=cfg.storage_nodes, replication=cfg.replication,
            seed=cfg.seed, cost=NetworkCostModel(),
            metrics=self.obs.metrics)
        self.store = ExpertStore(self.storage, chunk_bytes=cfg.chunk_bytes,
                                 metrics=self.obs.metrics)
        self.ledger = Ledger()
        self.pow = ProofOfWork(cfg.num_edges,
                               difficulty_bits=cfg.pow_difficulty,
                               seed=cfg.seed)
        # trust
        if cfg.verify == "optimistic":
            self.reputation = ReputationLedger(cfg.num_edges,
                                               ReputationConfig())
            self.protocol: Optional[OptimisticProtocol] = OptimisticProtocol(
                cfg.trust, cfg.num_edges, reputation=self.reputation,
                chained=True, metrics=self.obs.metrics,
                namespace="trust.fed", device=self.device)
        else:
            self.reputation = None
            self.protocol = None
        # edges: Dirichlet shards + rotating expert ownership
        y = np.asarray(y)
        xflat = np.asarray(x, np.float32).reshape(len(y), -1)
        shards = dirichlet_shards(y, cfg.num_edges, alpha=cfg.alpha,
                                  seed=cfg.seed)
        local_step = make_fed_local_step(cfg.num_experts, cfg.top_k,
                                         cfg.lr, self.apply_all)
        self.edges: List[FedEdge] = []
        for m in range(cfg.num_edges):
            owned = np.zeros(cfg.num_experts, np.float32)
            for j in range(cfg.experts_per_edge):
                owned[(m + j * cfg.num_edges // cfg.experts_per_edge)
                      % cfg.num_experts] = 1.0
            self.edges.append(FedEdge(
                m, xflat[shards[m]], y[shards[m]], owned, self.store,
                local_step, local_steps=cfg.local_steps,
                local_batch=cfg.local_batch, seed=cfg.seed,
                device=self.device))
        self._delta_like = tree_unflatten(self.global_params, [
            np.zeros(a.shape, np.float32)
            for a in tree_flatten(self.global_params)[0]])
        # round state
        self.round = 0
        self._carry: List[DeltaRecord] = []
        self._evicted: set = set()
        self._late_streak: Dict[int, int] = {m: 0
                                             for m in range(cfg.num_edges)}
        self._round_ctx: Dict[int, dict] = {}       # snapshots + closures
        self._retained: Dict[int, List[str]] = {}   # rid -> manifest cids
        self.stats = CounterGroup(
            {"rounds": 0, "deltas_received": 0, "stragglers": 0,
             "dropouts": 0, "evictions": 0, "carried_deltas": 0,
             "quorum_failures": 0, "rejected_updates": 0, "retries": 0,
             "convictions": 0, "replayed_rounds": 0},
            self.obs.metrics, "fed")

    def device_params(self) -> dict:
        """The global parameters as tensors on the coordinator's device:
        one copy per new global state, shared by every edge's local
        update and by ``evaluate``."""
        if self._mirror is None or self._mirror[0] is not self.global_params:
            self._mirror = (self.global_params,
                            _to_device(self.global_params, self.device))
        return self._mirror[1]

    # ------------------------------------------------------------- plan
    def _round_plan(self, rid: int) -> List[Tuple[int, bool, float]]:
        """(edge, dropped, speed) per non-evicted edge — a pure function
        of (cfg, rid, evicted-set), so a rollback replay that restored
        the eviction state reproduces the round exactly."""
        cfg = self.cfg
        plan = []
        for m in range(cfg.num_edges):
            if m in self._evicted:
                continue
            rng = np.random.default_rng([cfg.seed, 7, rid, m])
            dropped = bool(rng.random() < cfg.dropout_prob)
            slow = (m in cfg.slow_edges
                    or bool(rng.random() < cfg.straggler_prob))
            speed = (cfg.straggler_factor if slow
                     else float(rng.uniform(0.6, 1.4)))
            plan.append((m, dropped, speed))
        return plan

    def _attack_for(self, m: int) -> Optional[str]:
        atk = self.cfg.attack
        if m in atk.malicious_edges and atk.update_attack != "none":
            return atk.update_attack
        return None

    # ------------------------------------------------------------ round
    def run_round(self) -> dict:
        rid = self.round
        with self.obs.span("fed-round", metric="fed.round_s", round=rid):
            summary = self._execute_round(rid, honest=False)
            if self.protocol is not None:
                summary["trust"] = self._drain_trust(rid)
                self.protocol.advance(rid)
            self._prune_closed_rounds()
        self.round += 1
        self.stats["rounds"] += 1
        return summary

    def _execute_round(self, rid: int, honest: bool) -> dict:
        """Run one round.  ``honest=True`` is the rollback-replay path:
        no attack, no commitment, no chain blocks, no counters — just the
        honest state transition the convicted executor should have
        produced."""
        cfg = self.cfg
        book = not honest
        ctx = {"base": self.global_params,
               "carry_in": list(self._carry),
               "evicted": set(self._evicted),
               "late": dict(self._late_streak)}
        plan = self._round_plan(rid)
        # ---- local training + publication
        produced: List[DeltaRecord] = []
        dropouts, stragglers = [], []
        with self.obs.span("fed-local-train", metric="fed.train_s",
                           round=rid, edges=len(plan)):
            for m, dropped, speed in plan:
                if dropped:
                    dropouts.append(m)
                    if book:
                        self.stats["dropouts"] += 1
                    continue
                edge = self.edges[m]
                attack = None if honest else self._attack_for(m)
                delta, loss = edge.local_update(
                    self.device_params(), rid, attack=attack,
                    attack_scale=cfg.attack.scale)
                manifest = edge.publish(delta, rid)
                arrival = (cfg.local_steps * cfg.base_step_s * speed
                           + self.storage.cost.seconds(
                               manifest.total_bytes))
                produced.append(DeltaRecord(
                    edge=m, round_id=rid, base_round=rid,
                    manifest_cid=manifest.manifest_cid,
                    num_samples=edge.num_samples, arrival_s=arrival,
                    loss=loss))
        # ---- deadline: received now vs straggled
        fresh: List[DeltaRecord] = []
        late: List[DeltaRecord] = []
        for rec in produced:
            (fresh if rec.arrival_s <= cfg.deadline_s
             else late).append(rec)
        # a fresh arrival supersedes the same edge's stale carried delta
        # (never aggregate one edge twice — double-weighting would also
        # let a poisoner's carried+fresh copies gang up on the median)
        fresh_edges = {rec.edge for rec in fresh}
        received = []
        for rec in self._carry:
            if rec.edge in fresh_edges:
                self.store.release(rec.manifest_cid)
            else:
                received.append(rec)
        self._carry = []
        received.extend(fresh)
        on_time = {rec.edge for rec in fresh}
        for rec in late:
            stragglers.append(rec.edge)
            if book:
                self.stats["stragglers"] += 1
            self._late_streak[rec.edge] += 1
            if self._late_streak[rec.edge] >= cfg.evict_after:
                self._evicted.add(rec.edge)
                if book:
                    self.stats["evictions"] += 1
            elif cfg.late_policy == "carry":
                # lands in the NEXT round's received set; retained so the
                # edge's next-round publish cannot GC it out from under
                # the carry queue (every record in ``_carry`` holds
                # exactly one retention ref)
                self.store.retain(rec.manifest_cid)
                self._carry.append(rec)
                if book:
                    self.stats["carried_deltas"] += 1
        for m in on_time:
            self._late_streak[m] = 0
        summary = {"round": rid, "participants": [m for m, _, _ in plan],
                   "received": [rec.edge for rec in received],
                   "stragglers": stragglers, "dropouts": dropouts,
                   "evicted": sorted(self._evicted), "quorum": True,
                   "rejected": [], "executor": None}
        if book:
            self.stats["deltas_received"] += len(received)
        # ---- quorum gate
        if len(received) < cfg.min_quorum:
            summary["quorum"] = False
            # received deltas are not lost: they carry forward.  Fresh
            # arrivals (produced this round) enter the carry queue for
            # the first time and take their retention ref; carried-in
            # records keep the ref they already hold.
            for rec in received:
                if rec.round_id == rid:
                    self.store.retain(rec.manifest_cid)
            self._carry.extend(received)
            if book:
                self.stats["quorum_failures"] += 1
                self._mine({"kind": "fed_round", "round": rid,
                            "quorum": False,
                            "received": summary["received"],
                            "stragglers": stragglers,
                            "dropouts": dropouts})
            ctx["received"] = []
            self._round_ctx[rid] = ctx
            return summary
        # ---- aggregation (the committed computation)
        received.sort(key=lambda rec: (rec.edge, rec.base_round))
        with self.obs.span("fed-aggregate", metric="fed.aggregate_s",
                           round=rid, deltas=len(received)):
            before = self.storage.stats["retries"]
            deltas = [self.store.fetch_manifest(
                self.store.manifest_by_cid(rec.manifest_cid),
                self._delta_like) for rec in received]
            if book:
                self.stats["retries"] += (self.storage.stats["retries"]
                                          - before)
            weights = [rec.num_samples for rec in received]
            honest_new, info = aggregate(
                ctx["base"], deltas, weights, rule=cfg.rule,
                clip_mult=cfg.clip_mult, cos_min=cfg.cos_min)
        summary["rejected"] = [received[i].edge for i in info.rejected]
        if book:
            self.stats["rejected_updates"] += len(info.rejected)
        executor = (self.protocol.pick_executor(rid)
                    if self.protocol is not None
                    else rid % cfg.num_edges)
        summary["executor"] = executor
        claimed_new = honest_new
        atk = cfg.attack
        if (book and atk.dishonest_aggregator
                and executor in atk.malicious_edges):
            if atk.aggregator_mode == "substitute":
                rng = np.random.default_rng([cfg.seed, 13, rid])
                flat = tree_to_flat(honest_new)
                flat = flat + rng.normal(
                    0.0, atk.substitute_std, size=flat.shape
                ).astype(np.float32)
                claimed_new = flat_to_tree(flat, honest_new)
            elif atk.aggregator_mode == "unscreened":
                claimed_new, _ = aggregate(
                    ctx["base"], deltas, weights, rule="fedavg")
            else:
                raise ValueError(
                    f"unknown aggregator_mode {atk.aggregator_mode!r}")
        # ---- commit + schedule audit (never on the replay path: the
        # convicted round keeps its original commitment and verdict)
        cids = [rec.manifest_cid for rec in received]
        if book and self.protocol is not None:
            rows = commit_rows(claimed_new, cfg.num_experts)
            task = aggregation_task_digest(
                rid, [rec.edge for rec in received], cids, cfg.rule,
                cfg.clip_mult, cfg.cos_min, digest_tree(ctx["base"]))
            state = self.protocol.commit(rid, executor, rows,
                                         task_digest=task)
            recompute = make_recompute(
                self.store, ctx["base"], received, self._delta_like,
                cfg.num_experts, rule=cfg.rule, clip_mult=cfg.clip_mult,
                cos_min=cfg.cos_min)
            self.protocol.schedule_audit(rid, recompute)
            ctx["recompute"] = recompute
            for cid in cids:
                self.store.retain(cid)
            self._retained[rid] = cids
            agg_root = aggregation_root([rec.edge for rec in received],
                                        cids, state.commitment.root)
            summary["agg_root"] = agg_root
            if book:
                self._mine({"kind": "fed_round", "round": rid,
                            "quorum": True, "executor": executor,
                            "agg_root": agg_root[:16],
                            "result_root": state.commitment.root[:16],
                            "received": summary["received"],
                            "delta_cids": [c[:16] for c in cids],
                            "rejected": summary["rejected"],
                            "stragglers": stragglers,
                            "dropouts": dropouts})
        elif book:
            self._mine({"kind": "fed_round", "round": rid,
                        "quorum": True, "executor": executor,
                        "received": summary["received"],
                        "rejected": summary["rejected"],
                        "stragglers": stragglers, "dropouts": dropouts})
        # a consumed carried record gives up its carry-queue ref — the
        # round's own commit retention (above) now keeps it auditable
        for rec in received:
            if rec.round_id < rid:
                self.store.release(rec.manifest_cid)
        # ---- adopt the (claimed) new global state, optimistically
        self.global_params = tree_unflatten(claimed_new, [
            np.asarray(a, np.float32)
            for a in tree_flatten(claimed_new)[0]])
        ctx["received"] = received
        self._round_ctx[rid] = ctx
        return summary

    # ------------------------------------------------------------ trust
    def _drain_trust(self, now: Optional[int]) -> dict:
        """Audit drain -> court -> chained rollback replay -> rollback
        blocks.  Audits run off-path (concurrent with the next round's
        training in deployment), so their seconds are excluded from the
        enclosing round span's metric."""
        p = self.protocol
        out = {"audited": [], "convicted": [], "invalidated": []}
        jobs = p.pop_audit_jobs(now)
        if jobs:
            with self.obs.span("fed-audit-drain", metric="fed.audit_s",
                               off_path=True, drained=len(jobs)):
                for job in jobs:
                    reports = p.verifiers.audit(
                        p.rounds[job.round_id].commitment,
                        job.recompute_fn)
                    p.apply_reports(job.round_id, reports,
                                    job.recompute_fn)
                    out["audited"].append(job.round_id)
        challenged = sorted(
            rid for rid in out["audited"]
            if p.rounds[rid].phase is RoundPhase.CHALLENGED)
        n_rollbacks = len(p.rollbacks)
        for rid in challenged:
            if p.rounds[rid].phase is not RoundPhase.CHALLENGED:
                continue               # voided by an earlier conviction
            state = p.resolve_by_recompute(
                rid, self._round_ctx[rid]["recompute"])
            if state.phase is RoundPhase.ROLLED_BACK:
                out["convicted"].append(rid)
        for rec in p.rollbacks[n_rollbacks:]:
            out["invalidated"].extend(rec.invalidated)
        if out["convicted"]:
            self.stats["convictions"] += len(out["convicted"])
            with self.obs.span("fed-rollback-replay",
                               metric="fed.chain_s",
                               convicted=len(out["convicted"])):
                self._replay_chain(min(out["convicted"]))
            for rec in p.rollbacks[n_rollbacks:]:
                self._mine({"kind": "rollback", "domain": "fed",
                            "rollback_of": rec.round_id,
                            "executor": rec.executor,
                            "chain": [rec.round_id] + rec.invalidated,
                            "invalidated": rec.invalidated,
                            "slashed": [rec.executor],
                            "at_round": self.round})
        return out

    def _replay_chain(self, first: int) -> None:
        """Restore the snapshot entering the first convicted round and
        re-execute it and every later non-terminal-finalized round
        honestly (deltas are reproducible from seeds; ``put_version``
        replaces the voided delta versions in place)."""
        ctx = self._round_ctx[first]
        self.global_params = ctx["base"]
        # rebalance carry-queue retention: the abandoned lineage's queue
        # gives up its refs, the restored queue takes fresh ones (its
        # manifests are still alive under round ``first``'s commit
        # retention, which outlives the replay)
        for rec in self._carry:
            self.store.release(rec.manifest_cid)
        for rec in ctx["carry_in"]:
            self.store.retain(rec.manifest_cid)
        self._carry = list(ctx["carry_in"])
        self._evicted = set(ctx["evicted"])
        self._late_streak = dict(ctx["late"])
        for rid in sorted(r for r in self._round_ctx if r >= first):
            self._execute_round(rid, honest=True)
            self.stats["replayed_rounds"] += 1

    # ----------------------------------------------------------- finish
    def flush_trust(self) -> dict:
        """Close every open challenge window (end of run)."""
        if self.protocol is None:
            return {}
        out = self._drain_trust(None)
        horizon = self.protocol.clock + self.cfg.trust.challenge_window
        out["finalized"] = self.protocol.advance(horizon)
        self._prune_closed_rounds()
        return out

    def _prune_closed_rounds(self) -> None:
        """Release delta-manifest retention (and drop replay snapshots)
        for rounds that reached a terminal phase — their challenge
        window is settled, auditors no longer need the inputs."""
        if self.protocol is None:
            horizon = self.round
            closed = [rid for rid in self._round_ctx if rid < horizon]
        else:
            closed = [rid for rid in self._round_ctx
                      if (st := self.protocol.rounds.get(rid)) is not None
                      and st.phase in TERMINAL_PHASES]
            closed += [rid for rid in self._round_ctx
                       if rid not in self.protocol.rounds
                       and rid < self.round]       # quorum no-ops
        for rid in closed:
            for cid in self._retained.pop(rid, []):
                self.store.release(cid)
            self._round_ctx.pop(rid, None)

    # ------------------------------------------------------------- eval
    def evaluate(self, x, y, batch: int = 512) -> float:
        """Top-1 accuracy of the current global model, on the device; one
        host read at the end."""
        params = self.device_params()
        y = torch.as_tensor(np.asarray(y, np.int64), device=self.device)
        xflat = torch.as_tensor(np.asarray(x, np.float32).reshape(len(y), -1),
                                device=self.device)
        correct = torch.zeros((), dtype=torch.int64, device=self.device)
        with torch.no_grad():
            for i in range(0, len(y), batch):
                xb = xflat[i:i + batch]
                logits = ex.gate_apply(params["gate"], xb)
                w, _ = ex.sparse_gate_weights(logits, self.cfg.top_k)
                outs = self.apply_all(params["experts"], xb)
                pred = torch.einsum("bn,nbc->bc", w, outs).argmax(dim=1)
                correct += (pred == y[i:i + batch]).sum()
        return int(correct) / max(len(y), 1)

    # ------------------------------------------------------------ chain
    def _mine(self, payload: dict):
        if self.obs.enabled:
            payload = dict(payload, trace_id=self.obs.trace.trace_id,
                           span_id=self.obs.trace.current_span_id())
        block = self.pow.mine(len(self.ledger.blocks),
                              self.ledger.head.hash, payload)
        self.ledger.append(block)
        return block

    # ---------------------------------------------------------- reports
    def obs_report(self) -> dict:
        report = {"rounds": self.round,
                  "fed": dict(self.stats),
                  "metrics": self.obs.metrics.snapshot(),
                  "storage": {"network": dict(self.storage.stats),
                              "store": dict(self.store.stats)},
                  "chain": {"blocks": len(self.ledger.blocks),
                            "valid": self.ledger.verify_chain()}}
        if self.protocol is not None:
            report["trust"] = dict(self.protocol.stats)
        return report
