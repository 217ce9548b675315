"""The B-MoE system (paper §IV), inference path: task publisher + edge
layer + blockchain-layer vote + storage layer, running the Step 1-3
(+6 storage) workflow of Fig. 3 in PyTorch.

The counterpart of ``repro.core.bmoe`` for ``BMoESystem.infer`` and
``evaluate`` under two frameworks:

- ``framework="traditional"``: the paper's baseline — edge i employs
  expert i; no redundancy, no consensus; a malicious edge corrupts its
  own expert's results.
- ``framework="bmoe"``: every edge computes ALL activated experts
  (redundancy mechanism); the blockchain layer majority-votes the
  per-expert results (the fused vote kernel on the card) and the gate
  combines the trusted ones.

One forward: gate -> top-k softmax -> scatter into capacity buckets ->
grouped expert MLP (two ``moe_gemm`` launches) -> trust step (for
``bmoe``: M corrupted copies and one vote launch) -> gate-weighted
combine.  The bank is resolved through the chunked ``ExpertStore`` and
the edge ``ExpertCache`` first.

Randomness is split from the arithmetic: ``BMoESystem`` draws the
round's attack mask and noise from seeded ``torch.Generator``s
(``core.attacks``), and ``_moe_forward`` takes them as tensors.

Not in this slice (each raises ``NotImplementedError``; see ROADMAP.md
queue A): ``framework="optimistic"`` (slice 2), training
(``train_round``), ``dispatch="dense"``, ``expert_kind="cnn"``,
reputation and workload balance, and ``mesh="on"``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import experts as ex
from repro_torch.core.attacks import (AttackConfig, edge_noise,
                                      round_attack_mask, stream)
from repro_torch.core.ledger import as_numpy
from repro_torch.kernels import ops as kops
from repro_torch.models.moe import capacity_positions
from repro_torch.obs import Observability
from repro_torch.storage import (ExpertCache, ExpertStore, GateEMA,
                                 NetworkCostModel, StorageNetwork)


@dataclasses.dataclass(frozen=True)
class BMoEConfig:
    num_experts: int = 10           # N (paper §V)
    num_edges: int = 10             # M
    top_k: int = 3                  # K
    expert_kind: str = "mlp"        # mlp (fmnist) | cnn (cifar)
    in_dim: int = 784
    in_ch: int = 1
    num_classes: int = 10
    lr: float = 0.01
    framework: str = "bmoe"         # bmoe | traditional | optimistic
    # "sparse": top-k scatter-dispatch into per-expert capacity buckets +
    # grouped GEMM + gather-combine; "dense": every expert on the batch
    dispatch: str = "sparse"
    capacity_factor: float = 1.25   # bucket slots per expert, as a
    #                                 multiple of the balanced share
    #                                 B*top_k/num_experts (overflow drops)
    mesh: str = "off"               # on | off
    mesh_shards: Optional[int] = None
    attack: AttackConfig = dataclasses.field(default_factory=AttackConfig)
    pow_difficulty: int = 8
    num_chain_nodes: int = 8
    bandwidth_bytes_per_s: float = 125e6   # 1 Gbps edge links
    # chunked storage / edge cache: the edge resolves the bank through a
    # bounded LRU ExpertCache over versioned chunk manifests; "off" keeps
    # the bank resident (bit-identical outputs)
    edge_cache: str = "on"          # on | off
    edge_cache_bytes: Optional[int] = None  # cache byte budget (None: unbounded)
    chunk_bytes: int = 1 << 16      # storage chunk size
    prefetch_topk: int = 0          # EMA-prefetch this many hot experts
    num_storage_nodes: int = 4
    storage_replication: int = 2
    da_rate: float = 0.05
    seed: int = 0
    reputation: Optional[object] = None    # §VI-B/D (not in this slice)
    workload_balance: bool = False         # §VI-C (not in this slice)
    balance_eta: float = 0.5
    trust: Optional[object] = None         # optimistic knobs (slice 2)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; CUDA asked for but absent raises
    (the port never carries on on the CPU unless asked)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on a CUDA device and none is "
                           "available; pass device='cpu' for the plain "
                           "PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_slice(cfg: BMoEConfig) -> None:
    """Refuse what this slice of the port does not run yet, naming the
    ROADMAP.md queue item that brings it."""
    if cfg.framework == "optimistic":
        raise NotImplementedError(
            "framework='optimistic' is slice 2 of the port (ROADMAP.md "
            "queue A, item 1: the trust package and the audit_mlp kernel)")
    if cfg.framework not in ("bmoe", "traditional"):
        raise ValueError(f"unknown framework {cfg.framework!r}")
    if cfg.dispatch != "sparse":
        raise NotImplementedError(
            f"dispatch={cfg.dispatch!r} is not ported yet (ROADMAP.md "
            "queue A, item 3); the port runs dispatch='sparse'")
    if cfg.expert_kind != "mlp":
        raise NotImplementedError(
            f"expert_kind={cfg.expert_kind!r} is not ported yet (ROADMAP.md"
            " queue A, item 3); the port runs the MLP bank")
    if cfg.reputation is not None or cfg.workload_balance:
        raise NotImplementedError(
            "reputation and workload balance are not ported yet (ROADMAP.md"
            " queue A, item 3)")
    if cfg.mesh == "on":
        raise NotImplementedError(
            "mesh='on' is not ported yet (ROADMAP.md queue A, item 7)")


class BMoESystem:
    """One instantiation of Fig. 3, inference only.  See module docstring.

    ``device=None`` runs on the CUDA device (raising where there is
    none); ``device="cpu"`` runs every kernel's plain version.
    ``params={"gate": ..., "experts": ...}`` (``convert.params_from_numpy``)
    replaces the seeded init, and is what the genesis bank publishes."""

    def __init__(self, cfg: BMoEConfig, device=None,
                 obs: Optional[Observability] = None,
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
        _check_slice(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        # the one observability bundle of the run: storage network, store
        # and cache record into its registry
        self.obs = obs if obs is not None else Observability()
        if params is None:
            self.gate = ex.init_gate(cfg.in_dim, cfg.num_experts, cfg.seed,
                                     device=self.device)
            self.experts = ex.init_mlp_bank(cfg.num_experts, cfg.seed,
                                            in_dim=cfg.in_dim,
                                            out=cfg.num_classes,
                                            device=self.device)
        else:
            self.gate = {k: v.to(self.device) for k, v in params["gate"].items()}
            self.experts = {k: v.to(self.device)
                            for k, v in params["experts"].items()}
            self._check_params()
        self.storage = StorageNetwork(
            num_nodes=cfg.num_storage_nodes,
            replication=cfg.storage_replication, seed=cfg.seed,
            cost=NetworkCostModel(
                bandwidth_bytes_per_s=cfg.bandwidth_bytes_per_s),
            metrics=self.obs.metrics)
        # versioned per-expert chunk manifests, plus the edge-side cache
        # the executor resolves activated experts through
        self.expert_store = ExpertStore(self.storage,
                                        chunk_bytes=cfg.chunk_bytes,
                                        metrics=self.obs.metrics)
        self.edge_cache = (ExpertCache(self.expert_store,
                                       cfg.edge_cache_bytes,
                                       metrics=self.obs.metrics)
                           if cfg.edge_cache == "on" else None)
        self.gate_ema = GateEMA(cfg.num_experts)
        self._expert_like = {k: as_numpy(v[0]) for k, v in self.experts.items()}
        self._bank_version = -1
        self._resolved_bank = None      # device bank memo, keyed by the
        self._resolved_key = None       # resolved manifest cids
        self.obs.metrics.counter("bmoe.storage_s")
        with self.obs.span("publish", metric="bmoe.storage_s", round=0):
            self._publish_bank(None, 0)     # genesis bank: every expert, v0
        self.round = 0
        self.activation_counts = np.zeros(cfg.num_experts)
        self.activation_total = 0

    def _check_params(self) -> None:
        cfg = self.cfg
        want = {"w": (cfg.in_dim, cfg.num_experts), "b": (cfg.num_experts,)}
        for k, shape in want.items():
            if tuple(self.gate[k].shape) != shape:
                raise ValueError(f"gate[{k!r}] is {tuple(self.gate[k].shape)}"
                                 f", config wants {shape}")
        hidden = self.experts["w1"].shape[-1]
        want = {"w1": (cfg.num_experts, cfg.in_dim, hidden),
                "b1": (cfg.num_experts, hidden),
                "w2": (cfg.num_experts, hidden, cfg.num_classes),
                "b2": (cfg.num_experts, cfg.num_classes)}
        for k, shape in want.items():
            if tuple(self.experts[k].shape) != shape:
                raise ValueError(f"experts[{k!r}] is "
                                 f"{tuple(self.experts[k].shape)}, config "
                                 f"wants {shape}")

    # ------------------------------------------------------------ api
    def infer(self, x, *, attack: Optional[AttackConfig] = None,
              commit: bool = True):
        """Steps 1-3 (+6): forward only, no updates.  Returns host numpy
        (logits (B, C), activation (N,), support (N,)).

        The round's attack mask and noise depend on ``cfg.seed`` and the
        training round only (as in the JAX package), so repeated calls
        replay the same draw.  ``commit`` matters only to the optimistic
        framework (slice 2); these frameworks serve their (possibly
        attacked) consensus view either way."""
        del commit
        cfg = self.cfg
        atk = attack if attack is not None else cfg.attack
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        gate_bias, active = self._controls()
        mask_e, noise = self._draw_attack(atk, xt.shape[0],
                                          self.round + 1_000_000)
        bank = self._resolve_bank(xt, gate_bias)
        logits, activation, support = _infer_step(
            self.gate, bank, xt, mask_e, noise, atk.noise_std, gate_bias,
            active, cfg=cfg)
        return (as_numpy(logits), as_numpy(activation), as_numpy(support))

    def evaluate(self, x, y, *, attack: Optional[AttackConfig] = None,
                 batch: int = 1000) -> float:
        correct = 0
        for i in range(0, len(x), batch):
            logits, _, _ = self.infer(x[i:i + batch], attack=attack,
                                      commit=False)
            correct += int((logits.argmax(-1)
                            == np.asarray(y[i:i + batch])).sum())
        return correct / len(x)

    def _controls(self):
        """(gate_bias (N,), active (M,)): zero bias and the whole
        electorate — no balancer or reputation ledger in this slice."""
        cfg = self.cfg
        return (torch.zeros(cfg.num_experts, device=self.device),
                torch.ones(cfg.num_edges, device=self.device))

    def _draw_attack(self, atk: AttackConfig, batch: int, round_id: int):
        """The round's attack mask (M,) and corruption noise: (M, N, cap,
        C) per-edge copies under ``bmoe``, (N, cap, C) under
        ``traditional``.  Drawn on the host from streams seeded by
        (cfg.seed, round, tag[, fold id]), then moved to the device."""
        cfg = self.cfg
        base = (cfg.seed + 91, round_id)
        mask_e = round_attack_mask(atk, cfg.num_edges, stream(*base, "mask"))
        shape = (cfg.num_experts, sparse_capacity(cfg, batch),
                 cfg.num_classes)
        if cfg.framework == "bmoe":
            noise = edge_noise(atk, cfg.num_edges, shape, *base, "noise")
        else:
            noise = torch.randn(shape, generator=stream(*base, "noise"))
        return mask_e.to(self.device), noise.to(self.device)

    @property
    def activation_ratio(self) -> np.ndarray:
        return self.activation_counts / max(self.activation_total, 1)

    # ----------------------------------------------------- storage layer
    @staticmethod
    def _object_id(e: int) -> str:
        return f"expert/{e}"

    def _activated_experts(self, x, gate_bias) -> List[int]:
        """The experts the gate routes this batch to — what the edge must
        hold current versions of before computing."""
        eid, _, _ = _route_for_commit(self.gate, x, gate_bias, cfg=self.cfg)
        return [int(e) for e in torch.unique(eid).cpu()]

    def _resolve_bank(self, x, gate_bias):
        """Edge-side bank resolution: activated experts are pinned and
        resolved at the current version through the bounded
        ``ExpertCache`` — a miss or a stale entry fetches the expert
        chunk-by-chunk (CID-verified) from the storage network.  The
        device bank is memoized on the resolved manifest CIDs, so repeated
        inference against an unchanged bank costs no transfer and no
        re-stack.  ``edge_cache="off"`` keeps the bank resident
        (bit-identical: the chunk round trip preserves every byte)."""
        if self.edge_cache is None:
            return self.experts
        cfg, cache = self.cfg, self.edge_cache
        version = self._bank_version
        ids = [self._object_id(e)
               for e in self._activated_experts(x, gate_bias)]
        cache.pin(ids)
        try:
            if cfg.prefetch_topk:
                hot = [self._object_id(e)
                       for e in self.gate_ema.ranking()[:cfg.prefetch_topk]]
                cache.prefetch(hot, version, lambda oid: self._expert_like)
            rows = [cache.get(self._object_id(e), version,
                              self._expert_like)
                    for e in range(cfg.num_experts)]
        finally:
            cache.unpin(ids)
        key = tuple(
            self.expert_store.manifest_cid(self._object_id(e), version)
            for e in range(cfg.num_experts))
        if key != self._resolved_key:
            # host-side stack first, ONE host->device copy per leaf
            self._resolved_bank = {
                k: torch.from_numpy(np.stack([r[k] for r in rows]))
                .to(self.device) for k in rows[0]}
            self._resolved_key = key
        return self._resolved_bank

    def _publish_bank(self, activation, version: int) -> None:
        """Step 5, chunked: upload a new manifest version for every
        expert the round routed to (``activation=None``: the whole bank —
        genesis).  Unchanged chunks dedup away inside ``put_version``."""
        cfg = self.cfg
        changed = (list(range(cfg.num_experts)) if activation is None else
                   [int(e) for e in
                    np.nonzero(np.asarray(activation) > 0)[0]])
        if changed:
            # one device->host copy for the whole bank, slice on the host
            host = {k: as_numpy(v) for k, v in self.experts.items()}
            for e in changed:
                self.expert_store.put_version(
                    self._object_id(e), {k: a[e] for k, a in host.items()},
                    version)
        self._bank_version = max(self._bank_version, version)

    def storage_report(self) -> Dict:
        """Byte/transfer economy of the storage layer: network counters
        (with *modeled* transfer seconds), chunk-dedup upload savings,
        edge-cache counters, and the host wall-clock spent on storage
        bookkeeping.  Keys as in the JAX package (``da`` is None: no DA
        challenges without the optimistic framework)."""
        return {"network": dict(self.storage.stats),
                "store": dict(self.expert_store.stats),
                "cache": (dict(self.edge_cache.stats)
                          if self.edge_cache else None),
                "da": None,
                "wall_s": float(self.obs.metrics.value("bmoe.storage_s"))}


# ---------------------------------------------------------------- steps
def _flatten_for_gate(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1)


def sparse_capacity(cfg, batch: int) -> int:
    """Bucket slots per expert under sparse dispatch: the balanced share
    ``batch*top_k/num_experts`` scaled by ``capacity_factor``, rounded up
    to a multiple of 8 and capped at ``batch``."""
    cap = int(np.ceil(cfg.capacity_factor * batch * cfg.top_k
                      / cfg.num_experts))
    cap = min(-(-cap // 8) * 8, batch)
    return max(cap, 1)


def _sparse_dispatch(xin: torch.Tensor, topi: torch.Tensor, cfg,
                     capacity: int):
    """Scatter the top-k assignments into per-expert capacity buckets.

    Returns (buf (N, capacity, *xin.shape[1:]), eid (B*k,), pos (B*k,),
    keep (B*k,)): slot ``pos[j]`` of expert ``eid[j]``'s bucket holds
    token ``j // k``'s input (overflowing assignments are dropped — the
    bucket row stays zero and the combine masks the slot out)."""
    B, k = xin.shape[0], cfg.top_k
    eid = topi.reshape(-1)                              # (B*k,) row-major
    pos, keep, _ = capacity_positions(eid[None], cfg.num_experts, capacity)
    pos, keep = pos[0], keep[0]
    posc = torch.where(keep, pos, capacity - 1)         # clamp drops
    kshape = (B * k,) + (1,) * (xin.dim() - 1)
    gath = xin.repeat_interleave(k, dim=0) * keep.reshape(kshape).to(xin.dtype)
    buf = torch.zeros((cfg.num_experts, capacity) + tuple(xin.shape[1:]),
                      dtype=xin.dtype, device=xin.device)
    buf.index_put_((eid, posc), gath, accumulate=True)
    return buf, eid, posc, keep


def _route_for_commit(gate, x, gate_bias, *, cfg):
    """The gate + top-k + capacity-bucket assignment the forward uses."""
    flat = _flatten_for_gate(x)
    logits = ex.gate_apply(gate, flat) + gate_bias[None, :]
    _, topi = ex.sparse_gate_weights(logits, cfg.top_k)
    capacity = sparse_capacity(cfg, flat.shape[0])
    eid = topi.reshape(-1)
    pos, keep, _ = capacity_positions(eid[None], cfg.num_experts, capacity)
    return eid, pos[0], keep[0]


def _trust_outputs(outs, mask_e, noise, noise_std, cfg, active):
    """Framework-specific corruption + consensus over the per-expert
    output buckets ``outs`` (N, cap, C).

    ``traditional``: edge i employs expert i, so ``mask_e[i]`` corrupts
    expert i with ``noise`` (N, cap, C).  ``bmoe``: every edge publishes
    every expert's result; edge m's copy is corrupted with ``noise[m]``
    (``noise`` is (M, N, cap, C)), so an honest edge's copy is bitwise
    ``outs``, and the vote over the M copies (one kernel launch on the
    card) picks the trusted one.  Returns (trusted, support, flags)."""
    N, M = cfg.num_experts, cfg.num_edges
    if cfg.framework == "traditional":
        m = mask_e[:N].reshape((N,) + (1,) * (outs.dim() - 1))
        trusted = outs + noise_std * noise * m
        support = torch.ones(N, device=outs.device)
        flags = torch.ones((N, M), dtype=torch.int32, device=outs.device)
        return trusted, support, flags
    mshape = (1, M) + (1,) * (outs.dim() - 1)
    pub = outs[:, None] + noise_std * noise.movedim(0, 1) \
        * mask_e.reshape(mshape)                         # (N, M, cap, C)
    # Step 3: distributed consensus = majority vote over the M copies
    trusted, support, flags = kops.redundancy_vote_masked(
        pub.reshape(N, M, -1).contiguous(), active)
    return trusted.reshape(outs.shape), support, flags


def _moe_forward(gate, experts, x, mask_e, noise, noise_std, cfg,
                 gate_bias=None, active=None):
    """Shared forward: returns (trusted_out (B,C), weights (B,N),
    activation (N,), support (N,), flags (N,M), logits (B,N),
    dropped ())."""
    flat = _flatten_for_gate(x)
    logits = ex.gate_apply(gate, flat)
    if gate_bias is not None:
        logits = logits + gate_bias[None, :]
    weights, topi = ex.sparse_gate_weights(logits, cfg.top_k)
    B = flat.shape[0]
    capacity = sparse_capacity(cfg, B)
    # top-k scatter-dispatch: only routed tokens reach an expert
    buf, eid, posc, keep = _sparse_dispatch(flat, topi, cfg, capacity)
    outs = ex.mlp_expert_apply_grouped(experts, buf)    # (N, cap, C)
    dropped = (B * cfg.top_k) - keep.sum().float()
    if active is None:
        active = torch.ones(cfg.num_edges, device=flat.device)
    trusted, support, flags = _trust_outputs(outs, mask_e, noise, noise_std,
                                             cfg, active)
    # aggregate with gate weights (paper: weighted sum over top-K)
    yk = trusted[eid, posc]                             # (B*k, C)
    wk = weights.gather(1, topi).reshape(-1)
    wk = wk * keep.to(wk.dtype)                         # drops contribute 0
    y = (yk * wk[:, None]).reshape(B, cfg.top_k, -1).sum(dim=1)
    activation = (weights > 0).sum(dim=0).float()
    return y, weights, activation, support, flags, logits, dropped


def _infer_step(gate, experts, x, mask_e, noise, noise_std, gate_bias,
                active, *, cfg):
    out, _, activation, support, _, _, _ = _moe_forward(
        gate, experts, x, mask_e, noise, noise_std, cfg, gate_bias, active)
    return out, activation, support
