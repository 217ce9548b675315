"""Continuous-batching serving engine with prefill/decode disaggregation
(the counterpart of ``repro.serve.engine``).

The engine serves requests (prompt + max_new_tokens) from a fixed set of
batch slots, and the batch composition changes **every decode step**:
finished requests are evicted and queued requests admitted each tick
(``scheduler.SlotScheduler``), so a short request never waits for a long
co-batched one to drain.  Prefill is disaggregated from decode inside
one fused step (``train.step.make_serve_chunk_step``): each call runs C
engine ticks as masked greedy decode micro-steps in which prefilling
slots consume up to C prompt tokens while decoding slots keep generating
autoregressively — so a long prompt costs ceil(len/C) host round trips
instead of len.  The greedy token is carried from micro-step to
micro-step on the device, and the host reads the chunk's (C, B) tokens
once, after the call.  The chunk width is a power of two up to
``prefill_chunk`` (the width buckets of the JAX package's jit cache).
``scheduling="fixed"`` keeps the batch-synchronous baseline (admit only
into a drained batch, prompts fed token-by-token) as the benchmark
baseline and trust-equivalence oracle.

The engine runs on the device that holds ``params`` (on the card, each
MoE layer of a micro-step launches ``moe_gemm`` three times); its caches
are materialized there from ``models.transformer.cache_decl``.  A
micro-step leaves its input caches untouched and returns new ones
(``forward_decode``'s contract); only the admission reset zeroes an
admitted slot's rows in place.

Verified sessions (``trust=TrustConfig(...)``): the optimistic
commit-challenge-audit protocol applied to streaming inference.  Every
emitted token is digested into a session leaf, and the engine appends
**one Merkle root per batch tick** (``trust.session.commit_tick``), with
per-session inclusion paths derived from it.  Finished requests enter an
asynchronous challenge window (engine ticks); ``completed`` exposes only
*finalized* requests, and a mismatching audit revokes a request (and
its tick-overlapping open neighbours) instead of finalizing it.  Tick
roots, session roots and verdicts equal the JAX package's on the same
token streams.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.builder import materialize
from repro_torch.models.config import ModelConfig
from repro_torch.obs import Observability
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.scheduler import SlotScheduler, SlotState
from repro_torch.storage import (ExpertCache, ExpertStore, GateEMA,
                                 StorageNetwork)
from repro_torch.storage.kv import (KV_GENESIS, KVBlockStore,
                                    KVStorageConfig, prefix_chain,
                                    prefix_cid)
from repro_torch.train.step import make_serve_chunk_step
from repro_torch.trust.audit import VerifierPool
from repro_torch.trust.commitments import (MerkleTree, RoundCommitment,
                                           leaf_digest)
from repro_torch.trust.da import DataAvailabilityAuditor
from repro_torch.trust.protocol import ChallengeWindow, TrustConfig
from repro_torch.trust.session import (SessionLeafRef, TickCommitment,
                                       commit_tick, verify_session_inclusion)

__all__ = ["EdgeStorageConfig", "KVStorageConfig", "ServingEngine",
           "SessionRecord", "SlotState"]


@dataclasses.dataclass(frozen=True)
class EdgeStorageConfig:
    """Serving-edge expert storage (paper: the edge layer "employs the
    activated experts downloaded from the storage layer").

    With this config the engine registers every MoE layer's per-expert
    weights as chunked content-addressed objects in a ``StorageNetwork``
    and resolves, each macro-step, exactly the experts it routed to
    through a bounded ``ExpertCache`` — cold steps fetch, warm steps hit
    (serving params are frozen, so the manifests never go stale).  A
    ``GateEMA`` over the routing counts drives prefetch of the hottest
    experts into spare cache capacity."""
    cache_bytes: Optional[int] = None      # None: unbounded
    chunk_bytes: int = 1 << 15
    prefetch_topk: int = 0
    ema_decay: float = 0.8
    num_nodes: int = 4
    replication: int = 2
    seed: int = 0


class _EdgeExpertRuntime:
    """The engine's storage-layer sidecar: per-(MoE layer, expert) units
    registered once at startup (copied off the device as numpy), resolved
    per macro-step from its routing counts (layer order identical to
    ``forward_decode(expert_stats=True)``: the blocks block-major, then
    the remainder)."""

    def __init__(self, cfg: ModelConfig, params, scfg: EdgeStorageConfig,
                 metrics: Optional[MetricsRegistry] = None):
        self.cfg = cfg
        self.scfg = scfg
        self.network = StorageNetwork(num_nodes=scfg.num_nodes,
                                      replication=scfg.replication,
                                      seed=scfg.seed, metrics=metrics,
                                      namespace="edge.network")
        self.store = ExpertStore(self.network, chunk_bytes=scfg.chunk_bytes,
                                 metrics=metrics, namespace="edge.store")
        self.cache = ExpertCache(self.store, scfg.cache_bytes,
                                 metrics=metrics, namespace="edge.cache")
        self._like: List[Dict] = []           # per layer: one unit template
        self._n_real = cfg.num_experts
        self._register(params)
        self.ema = GateEMA(len(self._like) * self._n_real,
                           decay=scfg.ema_decay)
        self.ticks = 0

    @property
    def num_layers(self) -> int:
        return len(self._like)

    def _unit_id(self, layer: int, expert: int) -> str:
        return f"moe/{layer}/{expert}"

    def _register(self, params) -> None:
        """Chunk every (layer, expert) unit into the storage network
        (version 0 — serving weights are frozen).  Router and shared-
        expert weights stay gate-side resident: they run every tick."""
        def units_of(moe_params, b=None):
            # routed-expert weights only: (E, ...) leading expert axis
            routed = {k: (moe_params[k] if b is None else moe_params[k][b])
                      .detach().cpu().numpy()
                      for k in ("w_gate", "w_up", "w_down")}
            layer = len(self._like)
            # a copy, so the template does not hold the whole layer
            self._like.append({k: a[0].copy() for k, a in routed.items()})
            for e in range(self._n_real):
                self.store.put_version(self._unit_id(layer, e),
                                       {k: a[e] for k, a in routed.items()},
                                       0)

        blocks = params.get("blocks", {})
        for b in range(self.cfg.resolved_num_blocks):
            for i, spec in enumerate(self.cfg.block_pattern):
                if spec.mlp == "moe":
                    units_of(blocks[str(i)]["moe"], b)
        for i, spec in enumerate(self.cfg.remainder):
            if spec.mlp == "moe":
                units_of(params["remainder"][i]["moe"])

    def on_tick(self, stats: np.ndarray) -> None:
        """Resolve the experts this macro-step activated (pinned during
        the resolve), feed the EMA, and prefetch the hottest units into
        spare capacity."""
        stats = np.asarray(stats)[:, :self._n_real]
        flat = stats.reshape(-1).astype(np.float64)
        active = [(int(l), int(e)) for l, e in zip(*np.nonzero(stats))]
        ids = [self._unit_id(l, e) for l, e in active]
        self.cache.pin(ids)
        try:
            for (layer, e), oid in zip(active, ids):
                self.cache.get(oid, 0, self._like[layer])
            self.ema.update(flat)
            if self.scfg.prefetch_topk:
                ranked = [self._unit_id(u // self._n_real, u % self._n_real)
                          for u in self.ema.ranking()[:self.scfg.prefetch_topk]]
                self.cache.prefetch(
                    ranked, 0,
                    lambda oid: self._like[int(oid.split("/")[1])])
        finally:
            self.cache.unpin(ids)
        self.ticks += 1

    def report(self) -> Dict:
        # with a registry the stats dicts are live views over the
        # edge.{cache,store,network}.* metrics
        return {"cache": dict(self.cache.stats),
                "store": dict(self.store.stats),
                "network": dict(self.network.stats),
                "units": len(self._like) * self._n_real,
                "ticks": self.ticks}


class _KVRuntime:
    """The engine's KV-paging sidecar: a ``KVBlockStore`` over either
    its own storage network or — when the edge expert runtime is also
    configured — the SAME store and cache as the expert weights, so KV
    blocks and experts compete under one byte budget and one LRU
    (experts are pinned while activated; cold KV evicts first).

    ``da_rate > 0`` adds data-availability challenges over the sealed
    KV chunks: the same corrupt-slash-repair / withhold-window-slash
    machinery that audits expert chunks (``trust.da``)."""

    def __init__(self, kcfg: KVStorageConfig, shared=None,
                 metrics: Optional[MetricsRegistry] = None):
        self.cfg = kcfg
        self.T = int(kcfg.block_tokens)
        if self.T < 1:
            raise ValueError(f"block_tokens {self.T} < 1")
        if shared is not None:
            self.store, self.cache = shared
            self.network = self.store.network
        else:
            self.network = StorageNetwork(num_nodes=kcfg.num_nodes,
                                          replication=kcfg.replication,
                                          seed=kcfg.seed, metrics=metrics,
                                          namespace="kv.network")
            self.store = ExpertStore(self.network,
                                     chunk_bytes=kcfg.chunk_bytes,
                                     metrics=metrics, namespace="kv.store")
            self.cache = ExpertCache(self.store, kcfg.cache_bytes,
                                     metrics=metrics, namespace="kv.cache")
        self.kv = KVBlockStore(self.store, self.cache, metrics=metrics)
        self.da = (DataAvailabilityAuditor(
            self.network, len(self.network.nodes), window=kcfg.da_window,
            sample_rate=kcfg.da_rate, seed=kcfg.seed, metrics=metrics,
            namespace="kv.da") if kcfg.da_rate > 0 else None)
        self.like = None                # block-structure template (lazy)

    def report(self) -> Dict:
        out = {**dict(self.kv.stats),
               "cache": dict(self.cache.stats),
               "store": dict(self.store.stats)}
        if self.da is not None:
            out["da"] = dict(self.da.stats)
        return out


def _tick_leaf(request_id: int, tick: int, token: int) -> str:
    """Leaf digest of one committed engine tick.  The (1, 3) row layout
    matches ``RoundCommitment.leaf_chunk`` for a one-tick-per-leaf
    commitment, so session audits run through the same batched
    ``VerifierPool`` path as training audits."""
    return leaf_digest(np.array([[request_id, tick, token]], np.int64))


@dataclasses.dataclass
class SessionRecord:
    """Per-request commitment stream: one leaf per generated token, plus
    one inclusion reference per leaf into the batch tick tree it was
    committed under."""
    request_id: int
    leaves: List[str] = dataclasses.field(default_factory=list)
    ticks: List[int] = dataclasses.field(default_factory=list)
    tokens: List[int] = dataclasses.field(default_factory=list)
    refs: List[SessionLeafRef] = dataclasses.field(default_factory=list)
    root: str = ""
    finalized: bool = False
    revoked: bool = False
    audited: bool = False              # at least one spot-check pass ran

    def append(self, tick: int, token: int) -> None:
        self.leaves.append(_tick_leaf(self.request_id, tick, token))
        self.ticks.append(tick)
        self.tokens.append(token)

    def seal(self) -> str:
        self.root = MerkleTree(self.leaves).root
        return self.root

    def commitment(self) -> RoundCommitment:
        """The sealed session as a RoundCommitment: one (pseudo-)expert,
        one tick per leaf — what lets ``VerifierPool.audit_batched``
        audit a serving session and a training round through one code
        path.  ``claimed`` holds the *current* stream records; the
        sealed ``leaf_digests`` are what they are checked against."""
        t = len(self.leaves)
        claimed = np.array(
            [[[self.request_id, self.ticks[i], self.tokens[i]]
              for i in range(t)]], np.int64)
        return RoundCommitment(
            round_id=self.request_id, executor=-1, root=self.root,
            num_experts=1, chunks_per_expert=t, bounds=list(range(t + 1)),
            leaf_digests=list(self.leaves), claimed=claimed)


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, *, batch_slots: int = 4,
                 cache_len: int = 256, scheduling: str = "continuous",
                 prefill_chunk: int = 16,
                 trust: Optional[TrustConfig] = None,
                 expert_storage: Optional[EdgeStorageConfig] = None,
                 kv_storage: Optional[KVStorageConfig] = None,
                 obs: Optional[Observability] = None):
        if cfg.is_encoder_decoder:
            raise NotImplementedError("engine drives decoder-only archs")
        self.cfg = cfg
        self.params = params
        self.device = params["embed"].device
        self.obs = obs if obs is not None else Observability()
        self.batch = batch_slots
        self.cache_len = cache_len
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.caches = materialize(
            tfm.cache_decl(cfg, batch_slots, cache_len), 0, self.device)
        self.sched = SlotScheduler(batch_slots, policy=scheduling)
        # ---- edge expert storage (MoE models): per-step resolution of
        # the activated experts through a bounded ExpertCache, fed by
        # the serve step's routing counts
        self.edge = None
        if expert_storage is not None:
            has_moe = any(s.mlp == "moe"
                          for s in list(cfg.block_pattern)
                          + list(cfg.remainder))
            if not has_moe:
                raise ValueError("expert_storage needs a MoE model")
            self.edge = _EdgeExpertRuntime(cfg, params, expert_storage,
                                           metrics=self.obs.metrics)
        # ---- KV paging through the chunked store: sealed prefix-CID
        # blocks, warm-prefix restore on admission, page-out/resume.
        # With BOTH runtimes on, KV shares the edge cache+store — the
        # single-byte-budget competition between KV and expert weights.
        self.kvrt = None
        if kv_storage is not None:
            tfm.check_kv_pageable(cfg)
            if cache_len - 1 < kv_storage.block_tokens:
                raise ValueError(
                    f"block_tokens {kv_storage.block_tokens} cannot fit "
                    f"cache_len {cache_len} (need <= cache_len - 1)")
            shared = ((self.edge.store, self.edge.cache)
                      if self.edge is not None else None)
            self.kvrt = _KVRuntime(kv_storage, shared=shared,
                                   metrics=self.obs.metrics)
        # per-slot prefix-chain cursor: {"prev": cid, "sealed": nblocks}
        self._kv_chain: List[Optional[Dict]] = [None] * batch_slots
        # paged-out requests awaiting readmission: rid -> resume state
        self._kv_resume: Dict[int, Dict] = {}
        self._pending_kv_roots: List[str] = []   # sealed, not yet committed
        self._kv_macro_cids: List[str] = []      # sealed this macro-step
        # one fused step: C engine ticks per call (C=1 pure decode up to
        # C=prefill_chunk while prompts are chunking), C a power of two
        self._step_fn = make_serve_chunk_step(
            cfg, expert_stats=self.edge is not None)
        self.tick = 0
        self.steps = 0                  # fused macro-step invocations
        self.micro_steps = 0            # decode micro-steps they ran
        self._done: Dict[int, List[int]] = {}
        # ---- verified-session state (optimistic trust layer)
        self.trust = trust
        self.records: Dict[int, SessionRecord] = {}
        self.session_log: List[Dict] = []       # commit/finalize/revoke events
        # the on-chain session commitment stream: ONE append per batch
        # tick (a Merkle root over every token emitted that tick)
        self.tick_commitments: List[TickCommitment] = []
        self._window = (ChallengeWindow(trust.challenge_window)
                        if trust is not None else None)
        # audit_rate is the pool-wide sampled fraction (same contract as
        # OptimisticProtocol): each verifier draws its stake-weighted
        # share, and session re-audits catch rubber-stampers too
        self._auditors = (VerifierPool(
            trust.num_verifiers,
            trust.audit_rate / max(trust.num_verifiers, 1),
            trust.lazy_verifier_prob, trust.seed,
            stakes=trust.verifier_stakes, reaudit_rate=trust.reaudit_rate,
            verifier_slash_fraction=trust.verifier_slash_fraction,
            metrics=self.obs.metrics, namespace="serve.verifiers")
            if trust is not None else None)
        self._finalized: set = set()
        # deadline-ordered auto-audit queue: a sealed session's audit is
        # parked off the critical path and drained (whole backlog at
        # once, mirroring OptimisticProtocol.pop_audit_jobs) when the
        # oldest challenge window is about to close — so a tampered
        # stream is caught *before* it can finalize
        self._audit_queue: List[Tuple[int, int]] = []   # (deadline, rid)
        # sessions neither finalized nor revoked: the only ones the
        # finality-deferral and chained-revocation scans must touch
        self._open_sessions: set = set()

    # ------------------------------------------------------------- views
    @property
    def scheduling(self) -> str:
        return self.sched.policy

    @property
    def slots(self) -> List[SlotState]:
        return self.sched.slots

    @property
    def queue(self):
        return self.sched.queue

    @property
    def request_meta(self) -> Dict[int, Dict[str, int]]:
        """Per-request tick milestones: submitted/admitted/first-token/
        finished — what a serving benchmark derives TTFT and queueing
        delay from."""
        return self.sched.meta

    @property
    def verified(self) -> bool:
        return self.trust is not None

    @property
    def completed(self) -> Dict[int, List[int]]:
        """Finished — and, in verified mode, *finalized* — requests, in
        request-submission order (deterministic output)."""
        if not self.verified:
            return {rid: self._done[rid] for rid in self.sched.submit_order
                    if rid in self._done}
        return {rid: self._done[rid] for rid in self.sched.submit_order
                if rid in self._finalized}

    @property
    def pending_finalization(self) -> List[int]:
        """Finished requests still inside their challenge window."""
        if not self.verified:
            return []
        return [rid for rid in self.sched.submit_order
                if rid in self._done and rid not in self._finalized
                and not self.records[rid].revoked]

    def submit(self, requests: Iterable[dict]):
        self.sched.submit(requests, self.tick)

    def _device_batch(self, tokens, start, pos, lengths, adv) -> Dict:
        """The step's inputs as one host-to-device copy."""
        C = tokens.shape[1]
        packed = torch.from_numpy(np.concatenate(
            [tokens, np.stack([start, pos, lengths, adv], 1)], 1,
            dtype=np.int32)).to(self.device)
        return {"tokens": packed[:, :C], "start": packed[:, C],
                "pos": packed[:, C + 1], "lengths": packed[:, C + 2],
                "adv": packed[:, C + 3]}

    def warmup(self) -> int:
        """Run every chunk width bucket once (the powers of two up to
        ``prefill_chunk``; just C=1 under the fixed policy) on zero-
        advance dummy batches — ``adv=0`` masks every cache write and the
        outputs are dropped, so state is untouched — and wait for the
        device, so the kernel build and first launches never land in a
        served request's latency.  Returns the number of buckets run."""
        w, n = 1, 0
        while True:
            z = np.zeros(self.batch, np.int32)
            out = self._step_fn(self.params, self.caches, self._device_batch(
                np.zeros((self.batch, w), np.int32), z, z, z, z))
            out[0].cpu()
            n += 1
            if self.sched.policy != "continuous" \
                    or w * 2 > self.prefill_chunk:
                return n
            w *= 2

    # ------------------------------------------------------- slot intake
    def _admit(self) -> None:
        admitted = self.sched.admit(self.tick)
        if not admitted:
            return
        self._reset_slot_caches([i for i, _ in admitted])
        if self.kvrt is not None:
            for i, slot in admitted:
                self._kv_on_admit(i, slot)
        if self.verified:
            for _, slot in admitted:
                rid = slot.request_id
                # a paged-out-then-readmitted session keeps its record:
                # its commitment stream continues where it left off
                if rid not in self.records:
                    self.records[rid] = SessionRecord(request_id=rid)
                self._open_sessions.add(rid)

    def _reset_slot_caches(self, idxs: List[int]) -> None:
        """Zero the admitted slots' cache rows (KV + recurrent state), in
        place: the engine owns its cache tensors (each micro-step returns
        new ones)."""
        sel = torch.tensor(idxs, device=self.device)

        def zero(tree, axis):
            for v in (tree.values() if isinstance(tree, dict) else tree):
                if isinstance(v, (dict, list)):
                    zero(v, axis)
                else:
                    v.index_fill_(axis, sel, 0)

        # stacked block caches carry a leading layer axis: batch is axis 1
        zero(self.caches["blocks"], 1)
        if "remainder" in self.caches:
            zero(self.caches["remainder"], 0)

    # ------------------------------------------------------- KV paging
    def _kv_template(self):
        """Structure-only template for ``assemble_tree`` (leaf shapes
        come from the manifest, only the treedef must match)."""
        if self.kvrt.like is None:
            self.kvrt.like = tfm.slice_kv_block(self.caches, 0, 0, 1)
        return self.kvrt.like

    @staticmethod
    def _fed_tokens(s: SlotState, a: int, b: int) -> np.ndarray:
        """Token ids FED at cache positions [a, b): the prompt up to its
        length, then the generated continuation (cache row p holds the
        KV of the token fed at position p — a pure function of the
        token prefix, which is what makes prefix-CID addressing
        sound)."""
        L = len(s.prompt)
        out = np.empty(b - a, np.int64)
        for j, p in enumerate(range(a, b)):
            out[j] = int(s.prompt[p]) if p < L else s.generated[p - L]
        return out

    def _kv_on_admit(self, index: int, slot: SlotState) -> None:
        """Admission-side restore: a readmitted paged-out request gets
        its exact sealed state back; a fresh request whose leading
        prompt blocks are already sealed (another session shared the
        prefix) restores them instead of recomputing prefill.  At least
        one prompt token is always left unconsumed — the first
        generated token comes from feeding the LAST prompt token."""
        kv, T = self.kvrt.kv, self.kvrt.T
        rid = slot.request_id
        res = self._kv_resume.pop(rid, None)
        if res is not None:
            for cid, a, b in res["cids"]:
                block = kv.fetch(cid, self._kv_template())
                self.caches = tfm.restore_kv_block(self.caches, index,
                                                   a, block)
            slot.pos, slot.cursor = res["pos"], res["cursor"]
            slot.generated = list(res["generated"])
            self._kv_chain[index] = {"prev": res["prev"],
                                     "sealed": res["sealed"]}
            kv.stats["resumes"] += 1
            kv.stats["restored_tokens"] += slot.pos
            return
        chain = prefix_chain(slot.prompt, T)
        # restorable blocks must end strictly inside the prompt
        restorable = chain[:max(0, (len(slot.prompt) - 1) // T)]
        n = kv.warm_prefix(restorable) if restorable else 0
        for b in range(n):
            block = kv.fetch(chain[b], self._kv_template())
            self.caches = tfm.restore_kv_block(self.caches, index,
                                               b * T, block)
        slot.pos = slot.cursor = n * T
        self._kv_chain[index] = {"prev": chain[n - 1] if n else KV_GENESIS,
                                 "sealed": n}
        if n:
            kv.stats["restored_tokens"] += n * T

    def _kv_seal_upto(self, index: int, s: SlotState) -> None:
        """Seal every full block the slot's fed sequence has crossed.
        The chunk already wrote these rows (cache rows are write-once),
        so slicing the post-chunk cache at any replay tick past the
        block boundary reads exactly what that tick held.  A CID another
        session already sealed dedups without slicing."""
        st, kv, T = self._kv_chain[index], self.kvrt.kv, self.kvrt.T
        while (st["sealed"] + 1) * T <= s.pos:
            b = st["sealed"]
            cid = prefix_cid(st["prev"],
                             self._fed_tokens(s, b * T, (b + 1) * T))
            if cid in kv:
                man = kv.seal(cid, None, 0)
            else:
                block = tfm.slice_kv_block(self.caches, index,
                                           b * T, (b + 1) * T)
                man = kv.seal(cid, block, T)
            st["prev"], st["sealed"] = cid, b + 1
            if self.verified:
                self._pending_kv_roots.append(man.root)
            self._kv_macro_cids.append(cid)

    def _kv_prefetch_queued(self) -> None:
        """Warm the cache with queued requests' sealed prefix blocks
        (prefetch never evicts residents)."""
        kv, T = self.kvrt.kv, self.kvrt.T
        for r in list(self.sched.queue)[:self.batch]:
            if r["id"] in self._kv_resume:
                continue                 # resume fetches exact blocks
            chain = prefix_chain(r["prompt"], T)
            run = []
            for cid in chain[:max(0, (len(r["prompt"]) - 1) // T)]:
                if cid not in kv:
                    break
                run.append(KVBlockStore.object_id(cid))
            if run:
                self.kvrt.cache.prefetch(run, 0,
                                         lambda oid: self._kv_template())

    def page_out(self, index: int) -> int:
        """Page a running slot's KV out of the compute cache: seal its
        full blocks plus the partial tail block to the chunked store,
        stash the resume cursor, and requeue the request at the queue
        FRONT.  Readmission (``_kv_on_admit``) restores the rows and
        the slot resumes decode bit-identically.  Returns the request
        id."""
        if self.kvrt is None:
            raise ValueError("engine was not started with kv_storage")
        s = self.sched.slots[index]
        if not s.active:
            raise ValueError(f"slot {index} is not active")
        kv, T = self.kvrt.kv, self.kvrt.T
        self._kv_seal_upto(index, s)     # normally already sealed
        st = self._kv_chain[index]
        nfull, prev = st["sealed"], st["prev"]
        entries = []
        chain_prev = KV_GENESIS
        for b in range(nfull):
            chain_prev = prefix_cid(chain_prev,
                                    self._fed_tokens(s, b * T, (b + 1) * T))
            entries.append((chain_prev, b * T, (b + 1) * T))
        if s.pos > nfull * T:
            # tail block: chained over its (shorter) token run — the
            # int64 encoding binds the count, so it can never collide
            # with the full block over the same prefix
            tail_cid = prefix_cid(prev,
                                  self._fed_tokens(s, nfull * T, s.pos))
            block = tfm.slice_kv_block(self.caches, index, nfull * T, s.pos)
            man = kv.seal(tail_cid, block, s.pos - nfull * T)
            if self.verified:
                self._pending_kv_roots.append(man.root)
            entries.append((tail_cid, nfull * T, s.pos))
        self._kv_resume[s.request_id] = {
            "pos": s.pos, "cursor": s.cursor,
            "generated": list(s.generated),
            "cids": entries, "prev": prev, "sealed": nfull}
        kv.stats["pageouts"] += 1
        rid = self.sched.preempt(index, self.tick)
        self._kv_chain[index] = None
        return rid

    # --------------------------------------------------------- emissions
    def _emit(self, slot: SlotState, token: int, lat_s: float) -> None:
        slot.generated.append(token)
        if len(slot.generated) == 1:
            slot.first_token_tick = self.tick
            self.sched.meta[slot.request_id]["first_token_tick"] = self.tick
        m = self.obs.metrics
        m.counter("serve.tokens").add(1)
        m.histogram("serve.token_latency_s").observe(lat_s)
        m.histogram("serve.token_latency_s",
                    session=slot.request_id).observe(lat_s)
        if self.verified:
            self.records[slot.request_id].append(self.tick, token)

    def _finish(self, index: int) -> None:
        slot = self.sched.slots[index]
        generated = slot.generated[:slot.to_generate]
        rid = self.sched.release(index, self.tick)
        self._done[rid] = generated
        if not self.verified:
            return
        rec = self.records[rid]
        root = rec.seal() if rec.leaves else ""
        self.session_log.append({"event": "commit", "request": rid,
                                 "root": root[:16], "tick": self.tick,
                                 "leaves": len(rec.leaves)})
        self._window.enter(rid, self.tick)
        if rec.leaves:
            heapq.heappush(self._audit_queue,
                           (self.tick + self.trust.challenge_window, rid))

    # ----------------------------------------------------- the macro-step
    def step(self):
        """One fused macro-step: admit from the queue, then run C engine
        ticks in ONE call — prefilling slots chunk-consume their prompts
        while decoding slots keep generating (C=1 when no prompt is in
        flight, up to ``prefill_chunk`` while one is).  Per engine tick,
        host-side: emit, batch-commit the tick's Merkle leaf set, evict
        finished slots.  In verified mode, ticks keep running after the
        queue drains until every challenge window has closed."""
        with self.obs.span("step", metric="serve.tick_s", tick=self.tick):
            return self._step_inner()

    def _step_inner(self):
        with self.obs.span("admit", metric="serve.admit_s",
                           tick=self.tick):
            self._admit()
        if not self.sched.any_active:
            if self.verified and len(self._window):
                self.tick += 1               # idle tick: windows still age
                self._expire_windows()
                return bool(len(self._window))
            return False
        self.steps += 1
        m = self.obs.metrics
        m.histogram("serve.occupancy").observe(self.sched.occupancy())
        m.gauge("serve.queue_depth").set(self.sched.depth())
        slots = self.sched.slots
        continuous = self.sched.policy == "continuous"

        # ---- chunk width C (continuous): the largest pow2 <= the
        # busiest active slot's remaining work (prompt left + tokens
        # left to generate, cache-bounded), capped by prefill_chunk and
        # every active slot's cache headroom.  The fixed baseline always
        # runs C=1 with a 1-token prompt feed.
        if continuous:
            need = self.sched.prefill_lengths(self.prefill_chunk,
                                              self.cache_len)
            work = max((len(s.prompt) - s.cursor)
                       + max(s.to_generate - len(s.generated), 0)
                       for s in slots if s.active)
            headroom = min(self.cache_len - 1 - s.pos
                           for s in slots if s.active)
            cmax = max(1, min(self.prefill_chunk, headroom, work))
            C = 1 << (cmax.bit_length() - 1)      # round DOWN to pow2
            need = np.minimum(need, C).astype(np.int32)
        else:
            C = 1
            need = np.array([1 if s.prefilling else 0 for s in slots],
                            np.int32)

        tokens = np.zeros((self.batch, C), np.int32)
        start = np.zeros(self.batch, np.int32)
        pos = np.zeros(self.batch, np.int32)
        adv = np.zeros(self.batch, np.int32)
        for i, s in enumerate(slots):
            if not s.active:
                continue
            n = int(need[i])
            pos[i] = s.pos
            if n:
                tokens[i, :n] = s.prompt[s.cursor:s.cursor + n]
            if s.generated:
                start[i] = s.generated[-1]
            # a slot that finishes its prompt inside the chunk (or is
            # already decoding) generates for the rest of the chunk; a
            # chunk/headroom-capped prefill slot stops at its cap
            adv[i] = C if s.cursor + n >= len(s.prompt) else n
        prefill_now = continuous and bool((need > 0).any())
        name, metric = (("prefill", "serve.prefill_s") if prefill_now
                        else ("decode", "serve.decode_s"))
        # the span ends after the outputs reach the host, so it holds the
        # device's time for the chunk, not just the launches
        with self.obs.span(name, metric=metric, tick=self.tick,
                           width=C) as sp:
            out = self._step_fn(self.params, self.caches, self._device_batch(
                tokens, start, pos, need, adv))
            self.caches = out[1]
            outs = out[0].cpu().numpy()      # (C, B) greedy next tokens
        self.micro_steps += C
        if self.edge is not None:
            # resolve the chunk's activated experts through the edge
            # cache (cold: chunk fetches; warm: hits) + EMA prefetch
            self.edge.on_tick(out[2].cpu().numpy())
        if self.kvrt is not None:
            # warm queued requests' sealed prefix blocks into the cache
            self._kv_macro_cids = []
            self._kv_prefetch_queued()
        lat = sp.dur_s / C

        # ---- replay the chunk host-side, one engine tick per micro-step
        for t in range(C):
            self.tick += 1
            emissions: List[Tuple[int, int, int]] = []  # (slot, rid, tok)
            for i, s in enumerate(slots):
                if not s.active:             # idle, or finished mid-chunk
                    continue
                n = int(need[i])
                if t < n:                    # consumed a prompt token
                    s.cursor += 1
                    s.pos += 1
                    if s.cursor == len(s.prompt):
                        tok = int(outs[t, i])   # first generated token
                        self._emit(s, tok, lat)
                        emissions.append((i, s.request_id, tok))
                elif int(adv[i]) == C and s.cursor >= len(s.prompt):
                    tok = int(outs[t, i])    # autoregressive continuation
                    self._emit(s, tok, lat)
                    emissions.append((i, s.request_id, tok))
                    s.pos += 1
            if self.kvrt is not None:
                # seal the blocks this tick completed (prefill AND
                # decode rows page through the same chain), BEFORE the
                # commit so their manifest roots ride this tick's
                # on-chain append
                for i, s in enumerate(slots):
                    if s.active:
                        self._kv_seal_upto(i, s)
            if self.verified and emissions:
                self._commit_tick(emissions)
            for i, s in enumerate(slots):
                if not s.active:
                    continue
                done = (not s.prefilling
                        and len(s.generated) >= s.to_generate)
                if done or s.pos >= self.cache_len - 1:
                    self._finish(i)
            if self.verified:
                self._expire_windows()
        if self.kvrt is not None and self.kvrt.da is not None \
                and self._kv_macro_cids:
            # DA challenges over the KV chunks sealed this macro-step:
            # replica nodes answer for sealed KV exactly like expert
            # chunks (corrupt -> slash + repair; withheld -> window)
            seen = sorted(set(self._kv_macro_cids))
            self.kvrt.da.challenge_round(self.tick,
                                         self.kvrt.kv.manifests(seen))
            self.kvrt.da.resolve(self.tick)
        return True

    def _commit_tick(self, emissions: List[Tuple[int, int, int]]) -> None:
        """One Merkle append for the whole batch tick: a tree over every
        token emitted this tick (slot order); each session stores its
        inclusion path into it.  KV-block manifest roots sealed since
        the last append ride along as the side-band ``kv_root`` (a
        prefill tick can seal without emitting, so pending roots carry
        forward); the token ``root`` is untouched — streams and
        verdicts stay bit-identical to paging-off."""
        with self.obs.span("commit", metric="serve.commit_s",
                           tick=self.tick, leaves=len(emissions)):
            entries = [(rid, self.records[rid].leaves[-1])
                       for _, rid, _ in emissions]
            tc, refs = commit_tick(self.tick, entries,
                                   kv_roots=self._pending_kv_roots)
            self._pending_kv_roots = []
            self.tick_commitments.append(tc)
            for rid, ref in refs.items():
                self.records[rid].refs.append(ref)
            m = self.obs.metrics
            m.counter("serve.commit.appends").add(1)
            m.counter("serve.commit.leaves").add(len(entries))

    def run(self, max_ticks: int = 10_000) -> Dict[int, List[int]]:
        ticks = 0
        while self.step() and ticks < max_ticks:
            ticks += 1
        return self.completed

    # ------------------------------------------------------- observability
    def obs_report(self) -> Dict:
        """Serving-side view over the metrics registry: tick/token
        throughput, wall-clock totals per phase, token-latency
        percentiles (aggregate and per session), slot occupancy, the
        batched-commitment append counters, plus the edge storage and KV
        sections when those runtimes are on."""
        m = self.obs.metrics
        out = {
            "ticks": self.tick,
            "tokens": int(m.value("serve.tokens")),
            "tick_s": float(m.value("serve.tick_s")),
            "admit_s": float(m.value("serve.admit_s")),
            "prefill_s": float(m.value("serve.prefill_s")),
            "decode_s": float(m.value("serve.decode_s")),
            "commit_s": float(m.value("serve.commit_s")),
            "audit_offpath_s": float(m.value("serve.audit_s")),
            "token_latency": m.histogram("serve.token_latency_s").snapshot(),
            "occupancy": m.histogram("serve.occupancy").snapshot(),
            "commit_appends": int(m.value("serve.commit.appends")),
            "commit_leaves": int(m.value("serve.commit.leaves")),
            "sessions": {
                name.split("session=", 1)[1].rstrip("}"): snap
                for name, snap in
                m.snapshot("serve.token_latency_s{").items()},
        }
        if self.edge is not None:
            out["edge"] = self.edge.report()
        if self.kvrt is not None:
            out["kv"] = self.kvrt.report()
        return out

    def report(self) -> Dict:
        return self.obs_report()

    # ------------------------------------------------ audits (verified)
    def _audit_full(self, rid: int) -> None:
        """One spot-check pass per verifier (stopping early once a fraud
        revokes the session)."""
        for v in range(self._auditors.num_verifiers):
            self.audit_session(rid, v)
            if self.records[rid].revoked:
                break

    def _drain_session_audits(self) -> None:
        """Run queued session audits once the oldest deadline is due —
        and then the whole backlog, so audits burst off the critical
        path instead of blocking every tick."""
        if not self._audit_queue or self._audit_queue[0][0] > self.tick:
            return
        # burst drains off the critical path: booked to serve.audit_s and
        # excluded from the enclosing tick span's serve.tick_s
        drained = [rid for _, rid in self._audit_queue]
        with self.obs.span("audit-drain", metric="serve.audit_s",
                           off_path=True, tick=self.tick, drained=drained):
            while self._audit_queue:
                _, rid = heapq.heappop(self._audit_queue)
                rec = self.records[rid]
                if rec.revoked or not rec.root:
                    continue
                self._audit_full(rid)

    @staticmethod
    def _overlaps(a: SessionRecord, b: SessionRecord) -> bool:
        return (bool(a.ticks) and bool(b.ticks)
                and b.ticks[0] <= a.ticks[-1] and a.ticks[0] <= b.ticks[-1])

    def _expire_windows(self) -> None:
        self._drain_session_audits()
        for rid in self._window.expire(self.tick):
            rec = self.records[rid]
            if rec.revoked:
                continue
            # serving-side sequential finality: a stream cannot finalize
            # while a tick-overlapping co-batched stream is still being
            # produced (its later-confirmed fraud would void this one) or
            # is sealed but unchecked — spot-check the neighbour first,
            # which revokes this stream too if the neighbour was altered
            deferred = False
            for rid2 in list(self._open_sessions):
                dep = self.records[rid2]
                if rid2 == rid or dep.revoked \
                        or not self._overlaps(rec, dep):
                    continue
                if not dep.root:
                    if rid2 not in self._done:   # neighbour still streaming
                        self._window.hold(rid, self.tick + 1)
                        deferred = True
                        break
                    continue                     # empty session: no leaves
                if not dep.audited:
                    self._audit_full(rid2)
            if deferred or rec.revoked:
                continue
            rec.finalized = True
            self._finalized.add(rid)
            self._open_sessions.discard(rid)
            self.session_log.append({"event": "finalize", "request": rid,
                                     "tick": self.tick})

    def audit_session(self, request_id: int, verifier: int = 0) -> Dict:
        """Spot-check sampled leaves of a session commitment through the
        same batched auditor as training rounds: the sampled (tick,
        token) records are re-digested in one ``leaf_digest_batch`` pass
        and compared against the sealed leaves, then proven against both
        the sealed per-session root AND the batch tick roots the tokens
        were served under.  A mismatch (the served stream was altered
        after commitment) revokes the request: it will never finalize."""
        if not self.verified:
            raise ValueError("engine was not started with a TrustConfig")
        rec = self.records[request_id]
        if not rec.root:
            raise ValueError(f"request {request_id} not sealed yet")
        com = rec.commitment()

        def batch_recompute(experts, slices):
            # honest recompute of a session leaf = re-encoding the served
            # (tick, token) record; leaf i covers batch row i
            rows = [[request_id, rec.ticks[sl.start], rec.tokens[sl.start]]
                    for sl in slices]
            return np.asarray(rows, np.int64)[:, None, :]

        [report] = self._auditors.audit_batched(com, batch_recompute,
                                                verifiers=[verifier])

        def recompute(e: int, sl: slice):
            return np.array([[request_id, rec.ticks[sl.start],
                              rec.tokens[sl.start]]], np.int64)

        # second-layer lottery (reaudit_rate > 0): spot-check this
        # verifier's salted recompute attestations — a rubber-stamping
        # session auditor is slashed out of future lotteries just like a
        # training-round one
        self._auditors.reaudit(com, [report], recompute)
        sampled = report.sampled_leaves
        mismatches = [p.leaf_index for p in report.fraud_proofs]
        # Merkle-path check against the SEALED root: catches a consistent
        # post-seal rewrite of both the record and its leaf digest, which
        # the digest comparison alone (recompute vs current leaf list)
        # cannot see
        tree = MerkleTree(rec.leaves)
        if tree.root != rec.root:
            mismatches = sorted(set(mismatches) | {
                leaf for leaf in sampled
                if not MerkleTree.verify(rec.root, rec.leaves[leaf],
                                         tree.prove(leaf))})
        # inclusion check against the batch tick trees: every sampled
        # leaf must still be the one committed (one append per tick for
        # the whole batch) when its token was served
        if rec.refs and len(rec.refs) == len(rec.leaves):
            bad = verify_session_inclusion(rec.leaves, rec.refs, sampled)
            mismatches = sorted(set(mismatches) | set(bad))
        rec.audited = True
        if mismatches:
            self._revoke_session(request_id, mismatches)
        return {"request": request_id, "sampled": sampled,
                "mismatches": mismatches, "revoked": rec.revoked}

    def _revoke_session(self, request_id: int, mismatches: List[int]) -> None:
        """Revoke a session, then chain the revocation: every session
        whose ticks overlap the revoked stream's and whose window is
        still open is revoked with it — those tokens came out of the
        same batched decode calls as the fraudulent ones, so their
        provenance is void (no separate fraud is booked for them).
        Already-finalized sessions are immune: their windows closed
        clean before the fraud was confirmed."""
        rec = self.records[request_id]
        rec.revoked = True
        rec.finalized = False            # a revoked record is never final
        self._finalized.discard(request_id)
        self._open_sessions.discard(request_id)
        self._window.revoke(request_id)
        self.session_log.append({"event": "revoke", "request": request_id,
                                 "leaves": mismatches})
        for rid in list(self._open_sessions):
            dep = self.records[rid]
            if dep.revoked or dep.finalized or not self._overlaps(rec, dep):
                continue
            dep.revoked = True
            self._finalized.discard(rid)
            self._open_sessions.discard(rid)
            self._window.revoke(rid)
            self.session_log.append({"event": "revoke_dependent",
                                     "request": rid,
                                     "cause": request_id})

    def audit_all(self) -> List[Dict]:
        return [self.audit_session(rid, v)
                for rid in list(self.records)
                if self.records[rid].root
                for v in range(self._auditors.num_verifiers)]
