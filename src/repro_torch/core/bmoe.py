"""The B-MoE system (paper §IV): task publisher + edge layer + blockchain
layer + storage layer, running the Step 1-6 workflow of Fig. 3 for
training and the Step 1-3 (+6 storage) workflow for inference, in
PyTorch.

The counterpart of ``repro.core.bmoe``, on one device or an edge mesh:
``BMoESystem.train_round``, ``infer``, ``evaluate`` and ``flush_trust``
under three frameworks, for the MLP bank (Fashion-MNIST) and the CNN bank
(CIFAR-10), with sparse or dense dispatch:

- ``framework="traditional"``: the paper's baseline — edge i employs
  expert i; no redundancy, no consensus; a malicious edge corrupts its
  own expert's results.
- ``framework="bmoe"``: every edge computes ALL activated experts
  (redundancy mechanism); the blockchain layer majority-votes the
  per-expert results (the fused vote kernel on the card) and the gate
  combines the trusted ones.  In training, the edges then hash-vote the
  updated experts (a poisoned upload is outvoted) and the round is mined
  into a PoW block.
- ``framework="optimistic"``: the commit-challenge-audit protocol of
  ``repro_torch.trust`` — a rotating executor's per-expert outputs are
  Merkle-committed (for the MLP bank built by one ``audit_mlp`` launch),
  the round is accepted at once, a verifier pool recomputes sampled
  leaves off the critical path (merged ``audit_mlp`` drains; per-leaf
  recomputes under ``audit_backend="eager"``), and a confirmed fraud
  proof slashes and excludes the executor, escalates to the dispute
  court (one vote launch) and mines a rollback block.  In training, a
  conviction confirmed after later rounds committed on the poisoned
  state rolls the whole chain back and replays it honestly
  (``_replay_chain``); every training round also runs one
  data-availability beat over the expert versions it committed against.
  ``scheduling="synchronous"`` settles each round's audit inside the
  round (the reference oracle).  Batch inference runs the same pipeline
  on its own round clock.

One forward: gate (+ the workload balancer's bias) -> top-k softmax ->
scatter into capacity buckets -> grouped experts (the MLP bank: two
``moe_gemm`` launches; the CNN bank: one expert's network a call) ->
trust step -> gate-weighted combine.  ``dispatch="dense"`` runs every
expert on the whole batch instead (plain products) and combines with the
dense gate weights.  A training step differentiates through it
(``torch.autograd``): the expert MLP's backward is three more
``moe_gemm`` launches, the vote's sends each expert's gradient to its
elected copy; then plain SGD.  The bank is resolved through the chunked
``ExpertStore`` and the edge ``ExpertCache`` first, and a training round
publishes the experts it changed as new versions.

Randomness is split from the arithmetic: ``BMoESystem`` draws each
round's attack mask and noise (and poisoned uploads) from seeded
``torch.Generator``s (``core.attacks``), and ``_moe_forward`` and
``_train_step`` take them as tensors.  The commitment noise of a
cheating executor and the court's copies are numpy draws, byte for byte
the JAX package's.

``mesh="on"`` runs the same rounds on an edge mesh
(``launch.mesh.make_edge_mesh``): one process per edge shard, every rank
running the same script.  Rank ``s`` holds only its contiguous ``E/m``
slice of the bank (``sharding.shard_bank``); routing runs on the full
batch on every rank, each rank scatters its own token slice into the
capacity buckets, the buckets cross the mesh by ``all_to_all_single``,
the rank's experts run on its ``(E/m, capacity, .)`` buckets, and the
results return to the token owners by the reverse exchange
(``_mesh_sparse_forward``).  Corruption noise is drawn at full shape and
sliced, the vote runs over the local experts, commitments and audit
recomputes are shard-local (each rank recomputes the leaves of its own
experts and the results are gathered), and every input to the host
state (ledger, storage, protocol, stakes, reputation, controllers) is
first made identical on every rank by gathering it, so the host state is
replicated.  Everything is bitwise the ``mesh="off"`` system's, which
runs the same code on a one-shard mesh (``launch.mesh.local_mesh``)
whose exchanges are the identity.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import experts as ex
from repro_torch.core.attacks import (AttackConfig, edge_noise,
                                      poison_tree, round_attack_mask, stream)
from repro_torch.core.consensus import ProofOfWork
from repro_torch.core.ledger import (Ledger, as_numpy, digest_array,
                                     digest_bytes, digest_tree)
from repro_torch.core.reputation import (ReputationConfig, ReputationLedger,
                                         WorkloadBalancer)
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import EdgeMesh, local_mesh, make_edge_mesh
from repro_torch.models.moe import capacity_positions
from repro_torch.obs import Observability
from repro_torch.sharding import shard_bank
from repro_torch.storage import (ExpertCache, ExpertStore, GateEMA,
                                 NetworkCostModel, StorageNetwork)
from repro_torch.trust.audit import pack_audit_batch, pack_audit_batch_multi
from repro_torch.trust.commitments import chunk_bounds
from repro_torch.trust.da import DataAvailabilityAuditor
from repro_torch.trust.protocol import (TERMINAL_PHASES, AuditJob,
                                        OptimisticProtocol, RoundPhase,
                                        TrustConfig)
from repro_torch.trust.slashing import DisputeCourt


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
    # grouped experts + gather-combine; "dense": every expert on the whole
    # batch (the reference oracle; top-k only zeroes combine weights)
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
    # data-availability challenges (trust.da): per-chunk sampling rate of
    # the optimistic framework's storage audits
    da_rate: float = 0.05
    seed: int = 0
    reputation: Optional[ReputationConfig] = None   # §VI-B/D
    workload_balance: bool = False                  # §VI-C
    balance_eta: float = 0.5
    trust: Optional[TrustConfig] = None             # optimistic knobs


def _check_slice(cfg: BMoEConfig) -> None:
    """Refuse a configuration the system cannot run."""
    if cfg.framework not in ("bmoe", "traditional", "optimistic"):
        raise ValueError(f"unknown framework {cfg.framework!r}")
    if cfg.dispatch not in ("sparse", "dense"):
        raise ValueError(f"unknown dispatch {cfg.dispatch!r}")
    if cfg.expert_kind not in ("mlp", "cnn"):
        raise ValueError(f"unknown expert_kind {cfg.expert_kind!r}")
    if cfg.mesh not in ("on", "off"):
        raise ValueError(f"unknown mesh {cfg.mesh!r}")
    if cfg.mesh == "on" and cfg.dispatch != "sparse":
        raise ValueError(
            "mesh='on' runs the all_to_all sparse dispatch; dense "
            "dispatch has no per-expert buckets to exchange — set "
            "dispatch='sparse'")


def _check_shard_leaves(cfg: BMoEConfig, shards: int, tc) -> None:
    """Shard-local commitments reduce shard subtree roots into the flat
    round root; that is bitwise the flat root only when each shard's
    subtree is a complete subtree, i.e. leaves per shard is a power of
    two."""
    lps = (cfg.num_experts // shards) * tc.chunks_per_expert
    if lps & (lps - 1):
        raise ValueError(
            f"shard-local commitments need a power-of-two leaf "
            f"count per edge: (num_experts/mesh_shards) * "
            f"chunks_per_expert = ({cfg.num_experts}/{shards}) * "
            f"{tc.chunks_per_expert} = {lps}; adjust "
            f"mesh_shards or TrustConfig.chunks_per_expert")


def gate_in_dim(cfg: BMoEConfig) -> int:
    """The gate's input width: the flattened task row (a 32x32 image of
    ``in_ch`` channels for the CNN bank)."""
    return cfg.in_dim if cfg.expert_kind == "mlp" else 32 * 32 * cfg.in_ch


class BMoESystem:
    """One instantiation of Fig. 3.  See module docstring.

    ``device=None`` runs on the CUDA device (raising where there is
    none); ``device="cpu"`` runs every kernel's plain version.
    ``params={"gate": ..., "experts": ...}`` (``convert.params_from_numpy``)
    replaces the seeded init, and is what the genesis bank publishes.
    Under ``mesh="on"`` every rank of the process group builds the
    system alike; ``experts`` then holds this rank's bank slice and
    ``full_bank()`` gathers the whole bank."""

    # phase-seconds metrics behind the ``_timers`` keys (the JAX
    # package's): every second the system books flows through a span
    _TIMER_METRICS = {"compute": "bmoe.compute_s",
                      "consensus": "bmoe.consensus_s",
                      "chain": "bmoe.chain_s",
                      "audit": "bmoe.audit_s",
                      "audit_infer": "bmoe.audit_infer_s",
                      "storage": "bmoe.storage_s"}

    def __init__(self, cfg: BMoEConfig, device=None,
                 obs: Optional[Observability] = None,
                 params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None):
        _check_slice(cfg)
        self.cfg = cfg
        # the edge mesh: this rank's shard of the expert axis and its
        # model-axis group (one shard, exchanges the identity, off the mesh)
        self.mesh: EdgeMesh = (
            make_edge_mesh(cfg.num_experts, shards=cfg.mesh_shards,
                           device=device) if cfg.mesh == "on"
            else local_mesh(device))
        self.mesh_shards = self.mesh.shards
        self.device = self.mesh.device
        if self.mesh_shards > 1 and cfg.framework == "optimistic":
            _check_shard_leaves(cfg, self.mesh_shards,
                                cfg.trust or TrustConfig(seed=cfg.seed))
        # the one observability bundle of the run: storage network, store,
        # cache, trust protocols and DA auditor record into its registry
        self.obs = obs if obs is not None else Observability()
        if params is None:
            self.gate = ex.init_gate(gate_in_dim(cfg), cfg.num_experts,
                                     cfg.seed, device=self.device)
            self.experts = ex.init_bank(cfg.expert_kind, cfg.num_experts,
                                        cfg.seed, in_dim=cfg.in_dim,
                                        in_ch=cfg.in_ch,
                                        out=cfg.num_classes,
                                        device=self.device)
        else:
            self.gate = {k: v.to(self.device) for k, v in params["gate"].items()}
            self.experts = {k: v.to(self.device)
                            for k, v in params["experts"].items()}
            self._check_params()
        self.experts = shard_bank(self.experts, self.mesh)
        self._full_memo = None          # (local bank, gathered bank)
        self.ledger = Ledger()
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
        # "audit" / "audit_infer": verifier-pool drain seconds of the
        # training / inference pipeline under pipelined scheduling, off
        # the critical path (an off_path span, so the enclosing consensus
        # span excludes them; synchronous drains stay inside consensus);
        # "storage": version publication and bank resolution (host
        # wall-clock)
        for name in self._TIMER_METRICS.values():
            self.obs.metrics.counter(name)
        self.obs.metrics.counter("bmoe.round_s")
        # training rounds re-executed by chained-rollback replays (each
        # runs the forward and backward again)
        self.obs.metrics.counter("bmoe.replayed_rounds")
        with self.obs.span("publish", metric="bmoe.storage_s", round=0):
            self._publish_bank(None, 0)     # genesis bank: every expert, v0
        self.pow = ProofOfWork(cfg.num_chain_nodes,
                               difficulty_bits=cfg.pow_difficulty,
                               seed=cfg.seed)
        self.round = 0
        if cfg.framework == "optimistic" and cfg.reputation is None:
            # exclusion of slashed executors needs a reputation ledger
            self.reputation = ReputationLedger(cfg.num_edges,
                                               ReputationConfig())
        else:
            self.reputation = (ReputationLedger(cfg.num_edges, cfg.reputation)
                               if cfg.reputation else None)
        self.balancer = (WorkloadBalancer(cfg.num_experts, cfg.balance_eta)
                         if cfg.workload_balance else None)
        self.activation_counts = np.zeros(cfg.num_experts)
        self.activation_total = 0
        # manifest CIDs of the expert versions each open optimistic
        # training round committed against (retained while its window is
        # open), and per-pending-round snapshots: the (gate, bank) the
        # executor was handed, the task and what an honest replay needs
        self._audit_cids: Dict[int, List[str]] = {}
        self._round_ctx: Dict[int, Dict] = {}
        # batch-inference pipeline (created on the first optimistic
        # infer): its own round clock, with the training protocol's
        # stakes, court and reputation
        self._infer_protocol: Optional[OptimisticProtocol] = None
        self._infer_round = 0
        self._infer_ctx: Dict[int, Dict] = {}
        self._infer_audit_cids: Dict[int, List[str]] = {}
        self.infer_log: List[Dict] = []
        # verification-compute ledger, in expert evaluations x rows:
        # verify = audit recompute, escalate = dispute-court full votes
        self.verify_stats = {"base_evals": 0.0, "verify_evals": 0.0,
                             "escalate_evals": 0.0, "rounds": 0}
        self.trust_cfg: Optional[TrustConfig] = None
        self.protocol: Optional[OptimisticProtocol] = None
        self.da: Optional[DataAvailabilityAuditor] = None
        if cfg.framework == "optimistic":
            self.trust_cfg = cfg.trust or TrustConfig(seed=cfg.seed)
            # the training-domain protocol owns the stake book and the
            # court; the court votes on this system's device
            self.protocol = OptimisticProtocol(
                self.trust_cfg, cfg.num_edges, self.reputation,
                court=DisputeCourt(cfg.num_edges, device=self.device),
                metrics=self.obs.metrics, namespace="trust.train")
            if cfg.da_rate > 0:
                # storage nodes post their own bonds: a replica that
                # cannot produce a committed chunk inside the challenge
                # window is slashed (see trust.da)
                self.da = DataAvailabilityAuditor(
                    self.storage, num_nodes=cfg.num_storage_nodes,
                    window=self.trust_cfg.challenge_window,
                    sample_rate=cfg.da_rate, seed=cfg.seed,
                    metrics=self.obs.metrics)

    def _check_params(self) -> None:
        cfg = self.cfg
        want = {"w": (gate_in_dim(cfg), cfg.num_experts),
                "b": (cfg.num_experts,)}
        for k, shape in want.items():
            if tuple(self.gate[k].shape) != shape:
                raise ValueError(f"gate[{k!r}] is {tuple(self.gate[k].shape)}"
                                 f", config wants {shape}")
        if cfg.expert_kind == "mlp":
            hidden = self.experts["w1"].shape[-1]
            want = {"w1": (cfg.in_dim, hidden), "b1": (hidden,),
                    "w2": (hidden, cfg.num_classes),
                    "b2": (cfg.num_classes,)}
        else:
            want = {k: leaf.shape for k, leaf in
                    ex.cnn_expert_decl(cfg.in_ch, cfg.num_classes).items()}
        if set(self.experts) != set(want):
            raise ValueError(f"experts has keys {sorted(self.experts)}, a "
                             f"{cfg.expert_kind} bank has {sorted(want)}")
        for k, shape in want.items():
            shape = (cfg.num_experts,) + shape
            if tuple(self.experts[k].shape) != shape:
                raise ValueError(f"experts[{k!r}] is "
                                 f"{tuple(self.experts[k].shape)}, config "
                                 f"wants {shape}")

    # ------------------------------------------------------------ api
    def train_round(self, x, y, *, attack: Optional[AttackConfig] = None):
        """One full Step 1-6 round on one published task (batch): resolve
        the bank, one SGD step through the (attacked) forward and its
        consensus, then per framework — ``traditional``: publish the
        experts the round changed; ``bmoe``: publish, hash-vote the
        updated experts and mine the round's block; ``optimistic``:
        commit, queue the audit (draining a backlog whose window closes,
        with court, slash and chained rollback), publish unless the round
        was rolled back, and mine the round's block.  Returns the round's
        metrics as host numpy (loss, activation, support, flags, dropped;
        ``rolled_back`` under ``optimistic``: the honest replay's metrics
        when the round was voided).  The attack draw depends on
        ``cfg.seed`` and the round only."""
        cfg = self.cfg
        atk = attack if attack is not None else cfg.attack
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        yt = torch.as_tensor(np.asarray(y), device=self.device).long()
        batch = int(xt.shape[0])
        mask_e, noise = self._draw_attack(atk, batch, self.round)
        executor = (self.protocol.pick_executor(self.round)
                    if cfg.framework == "optimistic" else 0)
        gate_bias, active = self._controls()
        # every phase is a child of the round span, so one traced round
        # decomposes into fetch -> dispatch -> [consensus -> publish ->
        # chain], whose metric sums are the latency_report components
        # (an off-path audit drain nested in consensus is excluded)
        with self.obs.span("round", metric="bmoe.round_s", round=self.round,
                           kind="train", framework=cfg.framework,
                           executor=executor):
            with self.obs.span("fetch", metric="bmoe.storage_s",
                               round=self.round):
                bank = self._resolve_bank(xt, gate_bias)
            prev = (self.gate, bank)
            with self.obs.span("dispatch", metric="bmoe.compute_s",
                               round=self.round):
                self.gate, self.experts, metrics = _train_step(
                    self.gate, bank, xt, yt, mask_e.to(self.device),
                    noise.to(self.device), atk.noise_std, gate_bias, active,
                    cfg=cfg, executor=executor, mesh=self.mesh)
                metrics = {k: as_numpy(v) for k, v in metrics.items()}
            self.gate_ema.update(metrics["activation"])
            payload = {"round": self.round, "kind": "train",
                       "task": digest_array(np.asarray(x)[:8]),
                       "loss": float(metrics["loss"])}
            # cost ledger in expert-evaluation units (one expert on one
            # row of what it computes: its capacity bucket under sparse
            # dispatch, the whole batch under dense)
            self.verify_stats["rounds"] += 1
            if cfg.framework == "traditional":
                self.verify_stats["base_evals"] += cfg.top_k * batch
            else:
                self.verify_stats["base_evals"] += self._exec_evals(batch)
            if cfg.framework != "optimistic":
                # Step 5, chunked: the routed experts as new manifest
                # versions (the optimistic round publishes after its
                # commitment retained the version-r manifests)
                with self.obs.span("publish", metric="bmoe.storage_s",
                                   round=self.round):
                    self._publish_bank(metrics["activation"], self.round + 1)
                payload["bank_root"] = self._bank_root()[:16]
            if cfg.framework == "bmoe":
                # the redundancy mechanism IS the verification: M-1 extra
                # copies of the same execution
                self.verify_stats["verify_evals"] += \
                    (cfg.num_edges - 1) * self._exec_evals(batch)
                # Steps 4-5: edges vote on the updated experts' hashes
                with self.obs.span("consensus", metric="bmoe.consensus_s",
                                   round=self.round):
                    payload["trusted_supports"] = \
                        metrics["support"].tolist()
                    self._expert_hash_vote(atk, payload)
                # Step 6: block generation under PoW
                with self.obs.span("chain", metric="bmoe.chain_s",
                                   round=self.round):
                    self._mine(payload)
            elif cfg.framework == "optimistic":
                # commit -> optimistic accept -> queued audit -> maybe
                # rollback; a pipelined drain inside opens an off_path
                # span, so its seconds land in bmoe.audit_s and not here
                with self.obs.span("consensus", metric="bmoe.consensus_s",
                                   round=self.round):
                    metrics = self._optimistic_round(
                        xt, yt, atk, mask_e, noise, executor, prev,
                        metrics, payload, gate_bias, active)
                payload["loss"] = float(metrics["loss"])
                with self.obs.span("publish", metric="bmoe.storage_s",
                                   round=self.round):
                    if not payload.get("rolled_back"):
                        # a rolled-back round's honest replay already
                        # republished the voided versions (this round's
                        # successor included)
                        self._publish_bank(metrics["activation"],
                                           self.round + 1)
                payload["bank_root"] = self._bank_root()[:16]
                with self.obs.span("chain", metric="bmoe.chain_s",
                                   round=self.round):
                    self._mine(payload)
            self._update_controllers(metrics)
            self.activation_counts += metrics["activation"]
            self.activation_total += batch * cfg.top_k
            self.round += 1
        return metrics

    def infer(self, x, *, attack: Optional[AttackConfig] = None,
              commit: bool = True):
        """Steps 1-3 (+6): forward only, no updates.  Returns host numpy
        (logits (B, C), activation (N,), support (N,)).

        ``bmoe`` and ``traditional`` serve their (possibly attacked)
        consensus view; their attack draw depends on ``cfg.seed`` and the
        training round only (as in the JAX package), so repeated calls
        replay it.  Under ``optimistic`` with ``commit=True`` the batch
        runs the commit-challenge-audit pipeline on the inference round
        clock (``_optimistic_infer``); ``commit=False`` is the
        side-effect-free probe of the finalized honest view, which
        ``evaluate`` uses."""
        cfg = self.cfg
        atk = attack if attack is not None else cfg.attack
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        gate_bias, active = self._controls()
        if cfg.framework == "optimistic" and commit:
            return self._optimistic_infer(xt, atk, gate_bias, active)
        if cfg.framework == "optimistic":
            mask_e = torch.zeros(cfg.num_edges)
            noise = torch.zeros(cfg.num_experts,
                                self._exec_rows(xt.shape[0]),
                                cfg.num_classes)
        else:
            mask_e, noise = self._draw_attack(atk, xt.shape[0],
                                              self.round + 1_000_000)
        bank = self._resolve_bank(xt, gate_bias)
        logits, activation, support = _infer_step(
            self.gate, bank, xt, mask_e.to(self.device),
            noise.to(self.device), atk.noise_std, gate_bias, active,
            cfg=cfg, mesh=self.mesh)
        return (as_numpy(logits), as_numpy(activation), as_numpy(support))

    def evaluate(self, x, y, *, attack: Optional[AttackConfig] = None,
                 batch: int = 1000) -> float:
        correct = 0
        for i in range(0, len(x), batch):
            # commit=False: an accuracy probe must not mint inference
            # rounds, pay commitments, or slash anyone
            logits, _, _ = self.infer(x[i:i + batch], attack=attack,
                                      commit=False)
            correct += int((logits.argmax(-1)
                            == np.asarray(y[i:i + batch])).sum())
        return correct / len(x)

    def _active_host(self) -> np.ndarray:
        """(M,) float32 electorate: reputation-excluded edges are 0."""
        if self.reputation is None:
            return np.ones(self.cfg.num_edges, np.float32)
        return (~self.reputation.excluded).astype(np.float32)

    def _controls(self):
        """(gate_bias (N,), active (M,)) on the device: the workload
        balancer's bias (zero without one) and the reputation
        electorate."""
        bias = (torch.from_numpy(self.balancer.bias) if self.balancer
                else torch.zeros(self.cfg.num_experts))
        return (bias.to(self.device),
                torch.from_numpy(self._active_host()).to(self.device))

    def _update_controllers(self, metrics) -> None:
        """The workload balancer's bias from the round's activation
        (§VI-C), and reputation from the round's agreement flags
        (§VI-B/D) — except under ``optimistic``, whose rounds feed
        reputation through confirmed fraud proofs (slashing)."""
        if self.balancer is not None:
            self.balancer.update(metrics["activation"])
        if (self.reputation is not None
                and self.cfg.framework != "optimistic"):
            self.reputation.update_from_flags(metrics["flags"])

    def _expert_hash_vote(self, atk: AttackConfig, payload) -> None:
        """Paper Step 5: each edge uploads the updated experts' digest; the
        chain accepts the majority, so a poisoned minority is rejected and
        a poisoned majority misleads it (§IV-B).  A poisoning edge
        uploads ``poison_tree`` of the bank, drawn from the round's
        stream with its own fold id (0 for a colluding coalition, whose
        uploads are then identical)."""
        cfg = self.cfg
        bank = self.full_bank()
        honest = digest_tree(bank)
        poisoned: Dict[int, str] = {}
        uploads = []
        for m in range(cfg.num_edges):
            if atk.poison_params and m in atk.malicious_edges:
                fid = 0 if atk.colluding else m
                if fid not in poisoned:
                    poisoned[fid] = digest_tree(poison_tree(
                        bank, atk.noise_std, cfg.seed + 17,
                        self.round, "poison", fid))
                uploads.append(poisoned[fid])
            else:
                uploads.append(honest)
        counts: Dict[str, int] = {}
        for d in uploads:
            counts[d] = counts.get(d, 0) + 1
        winner = max(counts, key=counts.get)
        payload["expert_hash"] = winner[:16]
        payload["expert_hash_support"] = counts[winner]
        payload["expert_hash_accepted"] = counts[winner] * 2 > cfg.num_edges
        if winner != honest and payload["expert_hash_accepted"]:
            payload["chain_misled"] = True

    def _exec_rows(self, batch: int) -> int:
        """Rows one expert computes: its capacity bucket under sparse
        dispatch, the whole batch under dense."""
        return (sparse_capacity(self.cfg, batch)
                if self.cfg.dispatch == "sparse" else batch)

    def _exec_evals(self, batch: int) -> float:
        """Expert-evaluation cost of one canonical execution: every
        expert over the rows it computes (padding included)."""
        return self.cfg.num_experts * self._exec_rows(batch)

    def _draw_attack(self, atk: AttackConfig, batch: int, round_id: int,
                     sub: Optional[int] = None):
        """The round's attack mask (M,) and corruption noise, on the host:
        (M, N, R, C) per-edge copies under ``bmoe``, (N, R, C) otherwise,
        R being ``_exec_rows``.  Drawn from streams seeded by (cfg.seed,
        round[, sub], tag[, fold id]); the optimistic inference pipeline
        passes its round id as ``sub``, so back-to-back batches draw
        independently."""
        cfg = self.cfg
        base = (cfg.seed + 91, round_id) + (() if sub is None else (sub,))
        mask_e = round_attack_mask(atk, cfg.num_edges, stream(*base, "mask"))
        shape = (cfg.num_experts, self._exec_rows(batch), cfg.num_classes)
        if cfg.framework == "bmoe":
            noise = edge_noise(atk, cfg.num_edges, shape, *base, "noise")
        else:
            noise = torch.randn(shape, generator=stream(*base, "noise"))
        return mask_e, noise

    @property
    def activation_ratio(self) -> np.ndarray:
        return self.activation_counts / max(self.activation_total, 1)

    def _mine(self, payload):
        tr = self.obs.trace
        if tr.enabled:
            # block -> trace correlation, only while tracing: a disabled
            # run's payloads (and block hashes) stay as without obs
            payload["trace_id"] = tr.trace_id
            payload["span_id"] = tr.current_span_id()
        block = self.pow.mine(len(self.ledger.blocks), self.ledger.head.hash,
                              payload)
        self.ledger.append(block)

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
            # host-side stack first, ONE host->device copy per leaf; under
            # the mesh every rank made the same fetches (the storage
            # counters stay replicated) and puts only its own rows
            lo, hi = self.mesh.expert_range(cfg.num_experts)
            self._resolved_bank = {
                k: torch.from_numpy(np.stack([r[k] for r in rows[lo:hi]]))
                .to(self.device) for k in rows[0]}
            self._resolved_key = key
        return self._resolved_bank

    def full_bank(self) -> Dict[str, torch.Tensor]:
        """The whole ``(N, ...)`` bank on this device: every shard's slice
        gathered in expert order (a collective: every rank of the group
        calls it; one device gathers its one shard)."""
        if self._full_memo is None or self._full_memo[0] is not self.experts:
            full = {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in
                    ((k, self.mesh.all_gather(v, "bank"))
                     for k, v in self.experts.items())}
            self._full_memo = (self.experts, full)
        return self._full_memo[1]

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
            # (under the mesh, the bank gathered from every shard)
            host = {k: as_numpy(v) for k, v in self.full_bank().items()}
            for e in changed:
                self.expert_store.put_version(
                    self._object_id(e), {k: a[e] for k, a in host.items()},
                    version)
        self._bank_version = max(self._bank_version, version)

    def _bank_root(self) -> str:
        """One digest binding the current bank's per-expert manifest
        roots: the storage commitment a round's block records."""
        roots = "".join(
            self.expert_store.manifest(self._object_id(e),
                                       self._bank_version).root
            for e in range(self.cfg.num_experts))
        return digest_bytes(roots.encode())

    def _fetch_expert_manifest(self, manifest_cid: str):
        """Auditor-side fetch: the exact expert version a round committed
        against, named by its retained manifest CID.  Every chunk is
        CID-verified (a corrupted replica is skipped) and reassembled
        chunk-for-chunk: host numpy, byte-identical to the bank."""
        return self.expert_store.fetch_manifest(
            self.expert_store.manifest_by_cid(manifest_cid),
            self._expert_like)

    def _retain_round_manifests(self, version: int) -> List[str]:
        """Pin the manifests a round committed against for the length of
        its challenge window (the data-availability contract)."""
        cids = []
        for e in range(self.cfg.num_experts):
            cid = self.expert_store.manifest_cid(self._object_id(e),
                                                 version)
            self.expert_store.retain(cid)
            cids.append(cid)
        return cids

    def _run_da(self, now: Optional[int],
                manifest_cids: Optional[List[str]] = None) -> None:
        """One data-availability beat: challenge replica nodes for
        sampled chunks of the given manifests, close past-due challenges
        (``now=None``: all), and mine one ``da_slash`` block per
        confirmed fault."""
        if self.da is None:
            return
        n = len(self.da.faults)
        if manifest_cids:
            manifests = {}
            for cid in manifest_cids:
                man = self.expert_store.manifest_by_cid(cid)
                manifests[man.object_id] = man
            self.da.challenge_round(now, manifests)
        self.da.resolve(now)
        for f in self.da.faults[n:]:
            self._mine({"kind": "da_slash", "node": f.executor,
                        "object": f.object_id, "chunk": f.chunk_index,
                        "cid": f.cid[:16], "fault": f.kind,
                        "challenged_round": f.round_id})

    def storage_report(self) -> Dict:
        """Byte/transfer economy of the storage layer: network counters
        (with *modeled* transfer seconds), chunk-dedup upload savings,
        edge-cache counters, DA challenge stats (None without the
        optimistic framework), and the host wall-clock spent on storage
        bookkeeping.  Keys as in the JAX package."""
        return {"network": dict(self.storage.stats),
                "store": dict(self.expert_store.stats),
                "cache": (dict(self.edge_cache.stats)
                          if self.edge_cache else None),
                "da": dict(self.da.stats) if self.da else None,
                "wall_s": float(self.obs.metrics.value("bmoe.storage_s"))}

    def verification_report(self) -> Dict[str, float]:
        """Per-round verification compute, in expert evaluations x rows
        (counted, not timed: the keys of the JAX package)."""
        r = max(self.verify_stats["rounds"], 1)
        verify = self.verify_stats["verify_evals"]
        escalate = self.verify_stats["escalate_evals"]
        return {
            "base_evals_per_round": self.verify_stats["base_evals"] / r,
            "verify_evals_per_round": verify / r,
            "escalate_evals_per_round": escalate / r,
            "total_verification_per_round": (verify + escalate) / r,
        }

    @property
    def _timers(self) -> Dict[str, float]:
        """The phase seconds by the JAX package's keys, read from the obs
        registry (written only through spans)."""
        m = self.obs.metrics
        return {k: float(m.value(n)) for k, n in self._TIMER_METRICS.items()}

    def obs_report(self, expert_bytes: Optional[int] = None,
                   result_bytes: Optional[int] = None,
                   rounds: Optional[int] = None) -> Dict:
        """Every layer's numbers from the one metrics registry: the flat
        snapshot, the phase timers, ``storage_report()``,
        ``verification_report()`` and, given ``rounds``,
        ``latency_report()``'s section."""
        out: Dict = {"metrics": self.obs.metrics.snapshot(),
                     "timers": dict(self._timers),
                     "storage": self.storage_report(),
                     "verification": self.verification_report()}
        if rounds is not None:
            out["latency"] = self._latency_section(
                expert_bytes or 0, result_bytes or 0, rounds)
        return out

    def latency_report(self, expert_bytes: int, result_bytes: int,
                       rounds: int) -> Dict[str, float]:
        """Per-round latency decomposition (paper Fig. 4b is relative):
        measured compute/consensus/chain wall-clock + modeled comms."""
        return self.obs_report(expert_bytes, result_bytes,
                               rounds)["latency"]

    def _latency_section(self, expert_bytes: int, result_bytes: int,
                         rounds: int) -> Dict[str, float]:
        cfg = self.cfg
        bw = cfg.bandwidth_bytes_per_s
        if cfg.framework == "bmoe":
            # every edge downloads all K activated experts + uploads K
            # results
            t_comm = (cfg.num_edges * cfg.top_k * expert_bytes
                      + cfg.num_edges * cfg.top_k * result_bytes) / bw
        elif cfg.framework == "optimistic":
            tc = self.trust_cfg
            # executor: K downloads + K uploads + a 32-byte root; auditors:
            # audit_rate of the N experts re-fetched plus sampled chunks
            audit_bytes = tc.audit_rate * (
                cfg.num_experts * expert_bytes + result_bytes)
            t_comm = (cfg.top_k * expert_bytes + cfg.top_k * result_bytes
                      + 32 + audit_bytes) / bw
        else:
            t_comm = cfg.top_k * result_bytes / bw
        r = max(rounds, 1)
        timers = self._timers
        return {
            "compute_s": timers["compute"] / r,
            "comm_s": t_comm,
            "consensus_s": timers["consensus"] / r,
            "chain_s": timers["chain"] / r,
            # off the critical path, reported apart from total_s
            "audit_offpath_s": timers["audit"] / r,
            # host wall-clock of the storage simulation; the transfer it
            # stands for is the modeled comm_s term
            "storage_s": timers["storage"] / r,
            "total_s": timers["compute"] / r + t_comm
                       + timers["consensus"] / r + timers["chain"] / r,
        }

    # ------------------------------------------- optimistic verification
    def _optimistic_infer(self, xt, atk, gate_bias, active):
        """One optimistic inference round: the rotating executor serves
        its (possibly corrupted) aggregate at once, commits its per-expert
        outputs, and the round's audit is queued; the backlog drains in
        one merged recompute when a window is about to close (at once
        under synchronous scheduling), courts fire in round order, and
        closed windows finalize.  Rounds are independent
        (``chained=False``): a conviction revokes only its own round."""
        cfg, tc = self.cfg, self.trust_cfg
        proto = self._ensure_infer_protocol()
        rid = self._infer_round
        self._infer_round += 1
        # each inference round draws its own attack lottery (the round id
        # is folded in, as the JAX package does)
        mask_e, noise = self._draw_attack(atk, xt.shape[0],
                                          self.round + 1_000_000, rid)
        executor = proto.pick_executor(rid)
        # trace-only spans (no phase metric): a traced run still sees the
        # fetch/dispatch/commit shape of each inference round
        with self.obs.span("infer-round", round=rid, kind="infer",
                           executor=executor):
            with self.obs.span("fetch", round=rid):
                bank = self._resolve_bank(xt, gate_bias)
            version = self._bank_version
            with self.obs.span("dispatch", round=rid):
                logits, activation, support = (as_numpy(a) for a in
                                               _infer_step(
                    self.gate, bank, xt, mask_e.to(self.device),
                    noise.to(self.device), atk.noise_std, gate_bias, active,
                    cfg=cfg, executor=executor, mesh=self.mesh))
            self.gate_ema.update(activation)
            xin = self._task_rows(xt)          # the published task rows
            row_index, bounds = self._commitment_layout(
                self.gate, xt, xt.shape[0], gate_bias)
            with self.obs.span("commit", round=rid,
                               executor=executor) as csp:
                xd = self._pad_task(xin, row_index)
                honest = self._eager_outputs(bank, xd, bounds, row_index)
                attacked = bool(mask_e[executor] > 0)
                state = self._commit_round(proto, rid, executor, honest,
                                           attacked, atk, 1_000_000 + rid,
                                           digest_array(xin[:8]), row_index)
                csp.set(root=state.commitment.root[:16])
        # data-availability contract: the versions this round committed
        # against stay retained until its window closes
        manifests = self._retain_round_manifests(version)
        self._infer_audit_cids[rid] = manifests
        self._infer_ctx[rid] = {
            "prev": (self.gate, bank), "xd": xd, "honest": honest,
            "executor": executor, "mask_e": mask_e.numpy(), "atk": atk,
            "active": as_numpy(active), "manifests": manifests,
        }
        batch_fn = (self._make_batched_recompute(bank, xd, manifests,
                                                 row_index)
                    if tc.audit_backend == "batched" else None)
        proto.schedule_audit(rid, self._make_recompute(xd, manifests,
                                                       row_index), batch_fn)
        self.infer_log.append({"event": "commit", "round": rid,
                               "executor": executor,
                               "root": state.commitment.root[:16]})

        drain_now = None if tc.scheduling == "synchronous" else rid
        summary = self._drain_trust(proto, self._infer_ctx,
                                    self._infer_audit_cids, drain_now,
                                    "infer")
        self._record_infer_verdicts(summary)
        for frid in proto.advance(rid):
            self.infer_log.append({"event": "finalize", "round": frid})
        self._prune_closed_rounds(proto, self._infer_ctx,
                                  self._infer_audit_cids)
        return logits, activation, support

    def _optimistic_round(self, xt, yt, atk, mask_e, noise, executor, prev,
                          metrics, payload, gate_bias, active):
        """Commit -> optimistic accept -> queued audit -> (challenge ->
        court -> slash + chained rollback) for one training round.

        The executor commits its outputs on the round's snapshot ``prev``
        (the (gate, bank) it was handed), the round retains the expert
        versions it committed against and runs one data-availability
        beat over them, and its audit is queued.  Under
        ``scheduling="pipelined"`` the system proceeds on the accepted
        state and the backlog drains in one burst when the oldest window
        is about to close; fraud confirmed after descendants committed
        rolls the whole chain back (``_replay_chain``).
        ``scheduling="synchronous"`` drains in the round itself.  Returns
        the round's final metrics (the honest replay's, if rolled
        back)."""
        cfg, tc = self.cfg, self.trust_cfg
        xin = self._task_rows(xt)
        row_index, bounds = self._commitment_layout(prev[0], xt,
                                                    xin.shape[0], gate_bias)
        xd = self._pad_task(xin, row_index)
        honest = self._eager_outputs(prev[1], xd, bounds, row_index)
        attacked = bool(mask_e[executor] > 0)
        state = self._commit_round(self.protocol, self.round, executor,
                                   honest, attacked, atk, self.round,
                                   payload["task"], row_index)
        payload["commit_root"] = state.commitment.root[:16]
        if state.commitment.routing_digest:
            payload["routing"] = state.commitment.routing_digest[:16]
        payload["executor"] = executor
        # data-availability contract: retain the expert versions this
        # round committed against until its window closes, and challenge
        # replica nodes for sampled chunks of exactly those manifests
        manifests = self._retain_round_manifests(self.round)
        self._audit_cids[self.round] = manifests
        self._round_ctx[self.round] = {
            "prev": prev, "x": xt, "y": yt, "xd": xd, "honest": honest,
            "executor": executor, "mask_e": mask_e.numpy(), "noise": noise,
            "atk": atk, "gate_bias": gate_bias, "active": as_numpy(active),
            "manifests": manifests,
        }
        self._run_da(self.round, manifests)
        recompute_fn = self._make_recompute(xd, manifests, row_index)
        batch_fn = (self._make_batched_recompute(prev[1], xd, manifests,
                                                 row_index)
                    if tc.audit_backend == "batched" else None)
        self.protocol.schedule_audit(self.round, recompute_fn, batch_fn)

        drain_now = None if tc.scheduling == "synchronous" else self.round
        summary = self._drain_trust(self.protocol, self._round_ctx,
                                    self._audit_cids, drain_now, "train")
        payload["audited_leaves"] = summary["audited_leaves"]
        if summary["drained"]:
            payload["drained_rounds"] = summary["drained"]
        if summary["fraud_proofs"]:
            payload["fraud_proofs"] = summary["fraud_proofs"]
            payload["slashed"] = summary["slashed"]
        if summary["replayed_metrics"] is not None:
            payload["rolled_back"] = True
            metrics = summary["replayed_metrics"]

        # close windows in deadline order (sequential finality: never past
        # an unresolved dispute) and release closed rounds' evidence
        finalized = self.protocol.advance(self.round)
        if finalized:
            payload["finalized_rounds"] = finalized
        self._prune_closed_rounds(self.protocol, self._round_ctx,
                                  self._audit_cids)
        metrics = dict(metrics)
        metrics["rolled_back"] = np.float32(
            1.0 if payload.get("rolled_back") else 0.0)
        return metrics

    def _task_rows(self, xt: torch.Tensor) -> torch.Tensor:
        """The published task as the experts read it: images (B, 32, 32,
        C) for the CNN bank, flattened rows otherwise."""
        return xt if self.cfg.expert_kind == "cnn" else _flatten_for_gate(xt)

    def _sparse_routing(self, gate, x, gate_bias):
        """Re-derive the round's routing and build the ``(N, capacity)``
        bucket->task-row index the executor publishes with a sparse
        commitment.  Empty slots point one past the batch (the zero
        sentinel row appended to the task)."""
        cfg = self.cfg
        eid, pos, keep = (as_numpy(a) for a in
                          _route_for_commit(gate, x, gate_bias, cfg=cfg))
        batch = x.shape[0]
        capacity = sparse_capacity(cfg, batch)
        row_index = np.full((cfg.num_experts, capacity), batch, np.int32)
        tok = np.repeat(np.arange(batch, dtype=np.int32), cfg.top_k)
        row_index[eid[keep], pos[keep]] = tok[keep]
        return row_index, capacity

    @staticmethod
    def _pad_task(xt: torch.Tensor, row_index) -> torch.Tensor:
        """The auditors' task view, on the device: under sparse dispatch
        the batch plus one trailing zero row (what empty bucket slots
        recompute from)."""
        if row_index is None:
            return xt
        return torch.cat([xt, xt.new_zeros((1,) + tuple(xt.shape[1:]))])

    def _commitment_layout(self, gate, x, batch: int, gate_bias):
        """(row_index, bounds) of the round's commitment: bucket-chunk
        leaves under sparse dispatch, batch-chunk leaves under dense."""
        tc = self.trust_cfg
        if self.cfg.dispatch == "sparse":
            row_index, capacity = self._sparse_routing(gate, x, gate_bias)
            return row_index, chunk_bounds(capacity, tc.chunks_per_expert)
        return None, chunk_bounds(batch, tc.chunks_per_expert)

    def _batched_recompute_call(self, bank, xd, idx, gid,
                                lens) -> torch.Tensor:
        """One grouped recompute of ``len(lens)`` packed samples (``idx``
        / ``gid`` from ``pack_audit_batch``; sample s is ``lens[s]`` real
        rows): for the MLP bank ``audit_mlp(bank, xd[idx], gid)``, one
        kernel launch on the card; for the CNN bank a gather and apply,
        one per-expert call per sample on exactly its real rows — the
        call shape the commitment and the eager recompute use, so a
        leaf's bytes match theirs bit for bit.  (S, Cmax, C) on the
        device."""
        dev = xd.device
        if self.cfg.expert_kind == "mlp":
            return kops.audit_mlp(
                bank, xd[torch.from_numpy(idx).long().to(dev)],
                torch.from_numpy(gid).to(dev))[:len(lens)]
        out = xd.new_zeros((len(lens), idx.shape[1], self.cfg.num_classes))
        for s, n in enumerate(lens):
            p = {k: v[int(gid[s])] for k, v in bank.items()}
            rows = torch.from_numpy(idx[s, :n]).long().to(dev)
            out[s, :n] = ex.cnn_expert_apply(p, xd[rows])
        return out

    def _eager_outputs(self, experts, xd, bounds, row_index=None):
        """The executor's commitment-building pass: every expert's output
        through the recompute path the auditors use, so honest leaves
        recompute bit-identically.  For the MLP bank every (expert,
        chunk) leaf goes through ONE grouped ``audit_mlp`` call; the CNN
        bank applies each expert to each chunk's rows (one call shape per
        leaf).  With ``row_index`` the chunks tile each expert's capacity
        bucket and the task rows come from the committed routing.  Each
        rank builds the leaves of its own experts (one grouped call over
        its bank slice, local expert ids, its rows of the routing) and the
        slices are gathered: a leaf's bytes do not depend on the grouping.
        Host numpy (N, R, C)."""
        n_chunks = len(bounds) - 1
        slices = [slice(bounds[c], bounds[c + 1]) for c in range(n_chunks)]
        n_local = next(iter(experts.values())).shape[0]
        if row_index is not None:
            lo, hi = self.mesh.expert_range(self.cfg.num_experts)
            row_index = row_index[lo:hi]
        work = [(e, sl) for e in range(n_local)
                for sl in slices]                # (e, c) row-major = leaf order
        idx, gid, n = pack_audit_batch([e for e, _ in work],
                                       [sl for _, sl in work],
                                       row_map=row_index)
        out = self._batched_recompute_call(
            experts, xd, idx, gid, [sl.stop - sl.start for _, sl in work])
        parts = torch.stack([torch.cat(
            [out[e * n_chunks + c][:bounds[c + 1] - bounds[c]]
             for c in range(n_chunks)], dim=0)
            for e in range(n_local)])
        return as_numpy(self.mesh.all_gather(parts, "commit").reshape(
            (-1,) + tuple(parts.shape[1:])))

    def _count_audit_call(self, kind: str) -> None:
        """Host-side count of recompute calls, by kind ("drain": one
        grouped call per drain with sampled leaves, "eager": one S=1 call
        per eager-backend leaf, fraud-proof check or re-audit recompute)
        — what the MLP bank's ``audit_mlp`` launches are held against."""
        self.obs.metrics.counter("bmoe.audit_calls", kind=kind).add(1)

    def _make_recompute(self, xd, manifests: List[str], row_index=None):
        """Auditor-side eager recompute of one leaf: fetch the sampled
        expert from the storage layer by the manifest the round committed
        against (every chunk CID-verified) and recompute the chunk on the
        task rows the committed routing names.  The MLP bank goes through
        ``ops.audit_mlp`` with S=1 — on the card the same kernel as the
        batched audits, so a leaf's bytes match theirs bit for bit (a
        cuBLAS product could differ in the last bit and slash honest
        verifiers under re-audit); the CNN bank through the per-expert
        apply on the chunk's rows, as the commitment did."""
        cache: Dict[int, Dict[str, torch.Tensor]] = {}
        dev = xd.device
        one = torch.zeros(1, dtype=torch.int32, device=dev)
        mlp = self.cfg.expert_kind == "mlp"

        def recompute(e: int, sl: slice):
            if e not in cache:
                tree = self._fetch_expert_manifest(manifests[e])
                cache[e] = {k: torch.tensor(v).to(dev)
                            for k, v in tree.items()}
            rows = (np.arange(sl.start, sl.stop) if row_index is None
                    else row_index[e, sl])
            self._count_audit_call("eager")
            x = xd[torch.from_numpy(rows).long().to(dev)]
            if not mlp:
                return as_numpy(ex.cnn_expert_apply(cache[e], x))
            bank1 = {k: v[None] for k, v in cache[e].items()}
            return as_numpy(kops.audit_mlp(bank1, x[None], one))[0]

        return recompute

    def _make_batched_recompute(self, experts, xd, manifests: List[str],
                                row_index=None):
        """Batched auditor recompute of one round (``BatchRecomputeFn``):
        the fetch-by-manifest semantics of ``_make_recompute`` — one
        chunk-verified storage fetch per sampled expert, so the round's
        device bank ``experts`` is known to be byte-identical to what the
        round committed against (a withheld chunk raises
        ``ChunkUnavailableError``) — then every sampled chunk in ONE
        grouped call on the device task ``xd`` the commitment was built
        from, each sampled chunk on the shard that owns its expert
        (``_sharded_batch_recompute``).  The host's own drains merge
        rounds instead (``_audit_jobs_merged``);
        ``OptimisticProtocol.run_audits`` takes this closure."""
        fetched: set = set()

        def batch_recompute(expert_ids, slices):
            for e in sorted({int(e) for e in expert_ids}):
                if e not in fetched:
                    self._fetch_expert_manifest(manifests[e])
                    fetched.add(e)
            self._count_audit_call("drain")
            return self._sharded_batch_recompute(experts, xd, expert_ids,
                                                 slices, row_index)

        return batch_recompute

    def _shard_groups(self, expert_ids):
        """Sample indices grouped by the edge shard owning each sampled
        expert: every audit recompute runs on the shard that holds the
        expert's slice (off the mesh, the one shard)."""
        e_l = self.cfg.num_experts // self.mesh_shards
        groups: Dict[int, List[int]] = {}
        for i, e in enumerate(expert_ids):
            groups.setdefault(int(e) // e_l, []).append(i)
        return e_l, groups

    def _book_audit_rows(self, shard: int, slices, sel) -> None:
        """Per-shard real recompute rows (padding excluded): shard-local
        audits cost each edge about 1/shards of a round's audited rows.
        Booked under ``mesh="on"`` for every shard on every rank
        (replicated host state)."""
        rows = int(sum(slices[i].stop - slices[i].start for i in sel))
        self.obs.metrics.counter("bmoe.mesh.audit_rows",
                                 shard=str(shard)).add(rows)

    def _shard_local(self, expert_ids, slices, recompute) -> np.ndarray:
        """Shard-local audit recompute: this rank recomputes the sampled
        leaves of its own experts, ``recompute(sel, e_lo)`` over the
        work-list indices ``sel`` whose experts start at ``e_lo`` (one
        grouped call on the device), and every rank's group is gathered
        into the one ``(S, Cmax, C)`` host tensor every rank hashes (off
        the mesh: the one shard's call, gathered by the identity).
        Per-sample arithmetic does not depend on the grouping, so the
        bytes are those of one call over the whole bank: verdicts, fraud
        proofs and attestations do not depend on the shard count."""
        e_l, groups = self._shard_groups(expert_ids)
        s, c = self.mesh.shard, self.cfg.num_classes
        cmax = max(sl.stop - sl.start for sl in slices)
        mine = torch.zeros((max(len(sel) for sel in groups.values()), cmax,
                            c), device=self.device)
        if s in groups:
            part = recompute(groups[s], s * e_l)
            w = min(part.shape[1], cmax)
            mine[:part.shape[0], :w] = part[:, :w]
        if self.cfg.mesh == "on":
            for shard, sel in sorted(groups.items()):
                self._book_audit_rows(shard, slices, sel)
        every = as_numpy(self.mesh.all_gather(mine, "audit"))
        out = np.zeros((len(expert_ids), cmax, c), np.float32)
        for shard, sel in groups.items():
            out[sel] = every[shard, :len(sel)]
        return out

    def _sharded_batch_recompute(self, experts, xd, expert_ids, slices,
                                 row_index):
        """One round's batched recompute: this rank's sampled leaves in
        one grouped call over its bank slice (local expert ids, its rows
        of the routing); see ``_shard_local``."""
        def recompute(sel, e_lo):
            rmap = (None if row_index is None else
                    row_index[e_lo:e_lo + self.cfg.num_experts
                              // self.mesh_shards])
            idx, gid, n = pack_audit_batch(
                [int(expert_ids[i]) - e_lo for i in sel],
                [slices[i] for i in sel], row_map=rmap)
            return self._batched_recompute_call(
                experts, xd, idx, gid,
                [slices[i].stop - slices[i].start for i in sel])[:n]

        return self._shard_local(expert_ids, slices, recompute)

    def _commit_round(self, protocol, rid, executor, honest, attacked, atk,
                      seed_salt, task_digest, row_index=None):
        """Build the executor's claimed tensor (corrupted iff it attacks,
        with the JAX package's numpy draw) and publish the round
        commitment — over the dense ``(N, B, C)`` outputs, or (sparse
        dispatch) the capacity-bucketed buffers plus the routing indices
        auditors re-derive the buckets from."""
        claimed = honest
        if attacked:
            rng = np.random.default_rng(self.cfg.seed * 7919 + seed_salt)
            claimed = honest + atk.noise_std * rng.standard_normal(
                honest.shape).astype(honest.dtype)
        return protocol.commit(rid, executor, claimed,
                               task_digest=task_digest, row_index=row_index,
                               num_shards=self.mesh_shards)

    def _court_publish(self, ctx, claimed, seed_salt):
        """The dispute court's input: every edge's copy of every expert's
        result — the paper's full redundancy matrix, reconstructed from
        the round snapshot and its attack pattern (numpy draws as in the
        JAX package)."""
        cfg = self.cfg
        honest, atk = ctx["honest"], ctx["atk"]
        pub = np.broadcast_to(
            honest[:, None],
            (cfg.num_experts, cfg.num_edges) + honest.shape[1:]).copy()
        att = np.asarray(ctx["mask_e"]) > 0
        if atk.colluding:
            pub[:, att] = claimed[:, None]     # coalition backs the executor
        else:
            rng = np.random.default_rng(cfg.seed * 104729 + seed_salt)
            for m in np.nonzero(att)[0]:
                pub[:, m] = honest + atk.noise_std * rng.standard_normal(
                    honest.shape).astype(honest.dtype)
        pub[:, ctx["executor"]] = claimed
        return pub

    def _audit_jobs_merged(self, protocol, ctx_store,
                           jobs: List[AuditJob]):
        """Audit a whole drained backlog through ONE grouped recompute:
        the per-round bank snapshots stack to ``(slots*N, ...)`` (one
        ``torch.cat`` per leaf on the device), the per-round padded tasks
        concatenate row-wise, and ``VerifierPool.audit_rounds`` fuses
        every sampled leaf of every drained round into one recompute
        (one ``audit_mlp`` launch for the MLP bank) + one hash pass.
        Fetch-by-manifest is kept per (round, sampled expert).  The
        snapshots are this rank's bank slices, so the stack is its
        ``(slots*E_l, ...)`` share, and each rank recomputes the sampled
        leaves of its own experts (``_sharded_multi``)."""
        ctxs = [ctx_store[j.round_id] for j in jobs]
        coms = [protocol.rounds[j.round_id].commitment for j in jobs]
        banks = [c["prev"][1] for c in ctxs]
        xds = [c["xd"] for c in ctxs]    # a sparse task ends in its zero row
        # a multi-round drain pads to a FIXED (window+1)-slot layout, as
        # the JAX package does (padding slots repeat round 0's bank and
        # hold zero task rows; no sample indexes them)
        row_maps = [c.row_index for c in coms]
        slots = (self.trust_cfg.challenge_window + 1 if len(jobs) > 1
                 else 1)
        slots = max(slots, len(jobs))
        bmax = max(len(x) for x in xds)
        row_off = np.arange(slots + 1) * bmax
        pad_banks = banks + [banks[0]] * (slots - len(banks))
        stacked_bank = {k: torch.cat([b[k] for b in pad_banks], 0)
                        for k in banks[0]}
        xcat = xds[0].new_zeros((slots * bmax,) + tuple(xds[0].shape[1:]))
        for k, x in enumerate(xds):
            xcat[k * bmax:k * bmax + len(x)] = x
        fetched: set = set()

        def multi_fn(slot_ids, experts, slices):
            for k, e in sorted({(int(k), int(e))
                                for k, e in zip(slot_ids, experts)}):
                if (k, e) not in fetched:
                    self._fetch_expert_manifest(ctxs[k]["manifests"][e])
                    fetched.add((k, e))
            self._count_audit_call("drain")
            return self._sharded_multi(stacked_bank, xcat, row_off, row_maps,
                                       slot_ids, experts, slices)

        return protocol.verifiers.audit_rounds(coms, multi_fn)

    def _sharded_multi(self, stacked_bank, xcat, row_off, row_maps,
                       slot_ids, experts, slices) -> np.ndarray:
        """The merged drain: every sampled leaf recomputes on the shard
        owning its expert, against that shard's ``(slots*E_l)`` stack of
        round snapshots with local expert ids and its rows of each
        round's routing (``_shard_local``); the sample count buckets to
        a power of two."""
        e_l = self.cfg.num_experts // self.mesh_shards

        def recompute(sel, e_lo):
            idx, gid, n = pack_audit_batch_multi(
                [slot_ids[i] for i in sel],
                [int(experts[i]) - e_lo for i in sel],
                [slices[i] for i in sel], row_off, e_l,
                bucket=_pow2_bucket(len(sel)),
                row_maps=[None if rm is None else rm[e_lo:e_lo + e_l]
                          for rm in row_maps])
            return self._batched_recompute_call(
                stacked_bank, xcat, idx, gid,
                [slices[i].stop - slices[i].start for i in sel])[:n]

        return self._shard_local(experts, slices, recompute)

    def _drain_trust(self, protocol, ctx_store, cid_store, now,
                     domain: str) -> Dict:
        """Drain the deferred-audit backlog: run every queued audit (one
        merged grouped call under the batched backend, one recompute per
        sampled leaf under the eager one), court-resolve the challenged
        rounds in round order, and — for the training domain — roll back
        the whole optimistic chain built on a convicted round (restore the
        pre-fraud snapshot, re-execute every voided round honestly).
        Mines one rollback block per conviction."""
        cfg, tc = self.cfg, self.trust_cfg
        jobs = protocol.pop_audit_jobs(now)
        summary: Dict = {"drained": [j.round_id for j in jobs],
                         "audited_leaves": 0, "fraud_proofs": 0,
                         "convicted": [], "slashed": [],
                         "replayed_metrics": None}
        if not jobs:
            return summary
        # verifier-pool work, concurrent with later rounds in deployment:
        # off the critical path under pipelined scheduling, so the
        # off_path span's seconds land in its own metric and the
        # enclosing consensus span excludes them.  Synchronous drains stay
        # on the path (no metric: their time belongs to consensus).
        # Courts and the chain replay below settle state: on the path.
        off = tc.scheduling == "pipelined"
        metric = (("bmoe.audit_s" if domain == "train"
                   else "bmoe.audit_infer_s") if off else None)
        with self.obs.span("audit-drain", metric=metric, off_path=off,
                           domain=domain,
                           drained=[j.round_id for j in jobs]):
            if tc.audit_backend == "batched":
                reports_by_rid = self._audit_jobs_merged(protocol,
                                                         ctx_store, jobs)
            else:
                reports_by_rid = {
                    j.round_id: protocol.verifiers.audit(
                        protocol.rounds[j.round_id].commitment,
                        j.recompute_fn)
                    for j in jobs}
            for job in jobs:
                reports = reports_by_rid[job.round_id]
                protocol.apply_reports(job.round_id, reports,
                                       job.recompute_fn)
                audited = sum(r.recomputed_leaves for r in reports)
                com = protocol.rounds[job.round_id].commitment
                summary["audited_leaves"] += audited
                self.verify_stats["verify_evals"] += \
                    audited * com.rows_per_expert \
                    / max(com.chunks_per_expert, 1)

        # courts fire in round order, so an early conviction invalidates
        # ACCEPTED descendants before their (clean) audits can finalize
        # them, while CHALLENGED descendants still get their own verdict
        n_rollbacks = len(protocol.rollbacks)
        # the stake book is shared across the train/infer protocols and
        # their round ids overlap: attribute slashes by the events this
        # drain books
        n_events = len(protocol.stakes.events)
        challenged = sorted(
            j.round_id for j in jobs
            if protocol.rounds[j.round_id].phase is RoundPhase.CHALLENGED)
        for rid in challenged:
            state = protocol.rounds[rid]
            if state.phase is not RoundPhase.CHALLENGED:
                continue
            ctx = ctx_store[rid]
            with self.obs.span("court", domain=domain, round=rid,
                               executor=state.executor) as csp:
                pub = self._court_publish(ctx, state.commitment.claimed,
                                          rid)
                verdict = protocol.court.escalate(
                    rid, pub, state.executor, active=ctx["active"])
                state = protocol.resolve(rid, verdict)
                csp.set(verdict=state.phase.value)
            summary["fraud_proofs"] += len(state.proofs)
            self.verify_stats["escalate_evals"] += \
                cfg.num_edges * cfg.num_experts \
                * state.commitment.rows_per_expert
            for cid in cid_store.pop(rid, []):
                self.expert_store.release(cid)
            if state.phase is RoundPhase.ROLLED_BACK:
                summary["convicted"].append(rid)

        summary["slashed"] = sorted(
            {ev.edge for ev in protocol.stakes.events[n_events:]})
        if summary["convicted"] and domain == "train":
            with self.obs.span("rollback-replay",
                               convicted=summary["convicted"]):
                summary["replayed_metrics"] = self._replay_chain(
                    min(summary["convicted"]))
        for rec in protocol.rollbacks[n_rollbacks:]:
            self._mine({"kind": "rollback", "domain": domain,
                        "rollback_of": rec.round_id,
                        "executor": rec.executor,
                        "chain": [rec.round_id] + rec.invalidated,
                        "invalidated": rec.invalidated,
                        "slashed": [rec.executor],
                        "at_round": self.round})
        return summary

    def _replay_chain(self, first: int):
        """Chained rollback: restore the (gate, experts) snapshot the
        convicted round started from and re-execute every voided round —
        the convicted one plus its INVALIDATED descendants — honestly
        (zero attack mask; the round's own task, executor, gate bias and
        electorate) and in order, republishing the full bank at each
        replayed round's successor version.  Returns the replayed
        metrics of the newest round when it is the host's current round,
        else None."""
        chain = [rid for rid in sorted(self._round_ctx)
                 if rid >= first and self.protocol.rounds[rid].phase in
                 (RoundPhase.ROLLED_BACK, RoundPhase.INVALIDATED)]
        self.gate, self.experts = self._round_ctx[first]["prev"]
        metrics = None
        for rid in chain:
            ctx = self._round_ctx[rid]
            self.gate, self.experts, metrics = _train_step(
                self.gate, self.experts, ctx["x"], ctx["y"],
                torch.zeros(self.cfg.num_edges, device=self.device),
                ctx["noise"].to(self.device), ctx["atk"].noise_std,
                ctx["gate_bias"],
                torch.from_numpy(ctx["active"]).to(self.device),
                cfg=self.cfg, executor=ctx["executor"], mesh=self.mesh)
            metrics = {k: as_numpy(v) for k, v in metrics.items()}
            self.obs.metrics.counter("bmoe.replayed_rounds").add(1)
            self.verify_stats["base_evals"] += \
                self._exec_evals(len(ctx["x"]))
            # the voided versions were built on revoked state: republish
            # the replayed round's honest successor in place (the same
            # (object, version) tag).  The full bank, not the replay's
            # routed experts: the voided lineage may have published
            # DIFFERENT experts at this tag; chunk dedup keeps the upload
            # at the bytes that changed.
            self._publish_bank(None, rid + 1)
        return metrics if chain and chain[-1] == self.round else None

    def _prune_closed_rounds(self, protocol, ctx_store, cid_store):
        """Release snapshots and retained version manifests of rounds
        that hit a terminal phase (a superseded version nobody retains
        is then garbage collected)."""
        for rid in list(ctx_store):
            if protocol.rounds[rid].phase in TERMINAL_PHASES:
                del ctx_store[rid]
                for cid in cid_store.pop(rid, []):
                    self.expert_store.release(cid)

    def flush_trust(self) -> Dict:
        """Close out the optimistic pipeline: run every still-queued audit
        (training and inference domains), court-resolve what they raise
        (a training conviction replays its chain), close every open DA
        challenge, and advance both clocks past the last open window so
        every committed round reaches a terminal phase — the pipelined
        equivalent of the synchronous scheduler's per-round settlement."""
        out: Dict = {}
        if self.protocol is None:
            return out
        summary = self._drain_trust(self.protocol, self._round_ctx,
                                    self._audit_cids, None, "train")
        if summary["convicted"]:
            out["rolled_back"] = summary["convicted"]
        horizon = self.protocol.clock + self.trust_cfg.challenge_window
        out["finalized"] = self.protocol.advance(horizon)
        self._prune_closed_rounds(self.protocol, self._round_ctx,
                                  self._audit_cids)
        self._run_da(None)               # close every open DA challenge
        if self._infer_protocol is not None:
            isummary = self._drain_trust(self._infer_protocol,
                                         self._infer_ctx,
                                         self._infer_audit_cids, None,
                                         "infer")
            self._record_infer_verdicts(isummary)
            ihorizon = (self._infer_protocol.clock
                        + self.trust_cfg.challenge_window)
            out["infer_finalized"] = self._infer_protocol.advance(ihorizon)
            for frid in out["infer_finalized"]:
                self.infer_log.append({"event": "finalize", "round": frid})
            self._prune_closed_rounds(self._infer_protocol, self._infer_ctx,
                                      self._infer_audit_cids)
        return out

    def _ensure_infer_protocol(self) -> OptimisticProtocol:
        if self._infer_protocol is None:
            # its own round clock/window, but the SAME stake book, court
            # and reputation ledger: an inference conviction bars the
            # executor from the training rotation too.  chained=False:
            # batches run against frozen weights, so rounds are
            # independent
            self._infer_protocol = OptimisticProtocol(
                self.trust_cfg, self.cfg.num_edges, self.reputation,
                stakes=self.protocol.stakes, court=self.protocol.court,
                chained=False, metrics=self.obs.metrics,
                namespace="trust.infer")
        return self._infer_protocol

    def _record_infer_verdicts(self, summary: Dict) -> None:
        for rid in summary["convicted"]:
            self.infer_log.append({"event": "revoke", "round": rid,
                                   "executor":
                                       self._infer_protocol.rounds[rid]
                                       .executor})

    def pending_inference(self) -> List[int]:
        """Inference rounds still inside their challenge window."""
        return ([] if self._infer_protocol is None
                else self._infer_protocol.pending())


# ---------------------------------------------------------------- steps
def _pow2_bucket(n: int) -> int:
    """Merged drains bucket the sample count to a power of two (>= 8)."""
    bucket = 8
    while bucket < n:
        bucket *= 2
    return bucket


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
                     capacity: int, rows=None):
    """Scatter the top-k assignments into per-expert capacity buckets.

    Returns (buf (N, capacity, *xin.shape[1:]), eid (B*k,), pos (B*k,),
    keep (B*k,)): slot ``pos[j]`` of expert ``eid[j]``'s bucket holds
    token ``j // k``'s input (overflowing assignments are dropped — the
    bucket row stays zero and the combine masks the slot out).  The slots
    come from the whole batch ``topi`` routes; ``rows=(lo, hi)`` means
    ``xin`` holds only tokens ``[lo, hi)``, scattered at their global
    slots (an edge shard's send buffer)."""
    k = cfg.top_k
    eid = topi.reshape(-1)                              # (B*k,) row-major
    pos, keep, _ = capacity_positions(eid[None], cfg.num_experts, capacity)
    pos, keep = pos[0], keep[0]
    posc = torch.where(keep, pos, capacity - 1)         # clamp drops
    lo, hi = rows if rows is not None else (0, topi.shape[0])
    mine = slice(lo * k, hi * k)
    kshape = ((hi - lo) * k,) + (1,) * (xin.dim() - 1)
    gath = xin.repeat_interleave(k, dim=0) * keep[mine].reshape(kshape).to(
        xin.dtype)
    buf = torch.zeros((cfg.num_experts, capacity) + tuple(xin.shape[1:]),
                      dtype=xin.dtype, device=xin.device)
    buf.index_put_((eid[mine], posc[mine]), gath, accumulate=True)
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


def _trust_outputs(outs, mask_e, noise, noise_std, cfg, active,
                   executor=0, shard=None):
    """Framework-specific corruption + consensus over the per-expert
    outputs ``outs`` (N, R, C): R is the capacity bucket under sparse
    dispatch, the whole batch under dense.

    ``shard=(s, E_l)`` (sparse dispatch, on a mesh of any shard count):
    ``outs`` is edge shard ``s``'s local experts ``(E_l, R, C)``.  The noise still comes drawn
    at the full shape and is sliced to the local experts (so each edge's
    corrupted bytes are the one-device system's), and the vote runs over
    the local experts only: it is independent per expert, so the local
    verdicts concatenate to the global ones.

    ``optimistic``: the round's result is whatever the rotating
    ``executor`` published — corrupted with ``noise`` (N, R, C) iff
    ``mask_e[executor]``; verification happens off this path (commit,
    audit, court).  ``traditional``: edge i employs expert i, so
    ``mask_e[i]`` corrupts expert i with ``noise`` (N, R, C).  ``bmoe``:
    every edge publishes every expert's result; edge m's copy is
    corrupted with ``noise[m]`` (``noise`` is (M, N, R, C)), so an honest
    edge's copy is bitwise ``outs``, and the vote over the M copies (one
    kernel launch on the card) picks the trusted one.  Returns (trusted,
    support, flags)."""
    N, M = outs.shape[0], cfg.num_edges
    lo = 0 if shard is None else shard[0] * shard[1]
    if shard is not None:
        noise = (noise[:, lo:lo + N] if cfg.framework == "bmoe"
                 else noise[lo:lo + N])
    if cfg.framework == "optimistic":
        trusted = outs + noise_std * noise * mask_e[executor]
        support = torch.ones(N, device=outs.device)
        flags = torch.ones((N, M), dtype=torch.int32, device=outs.device)
        return trusted, support, flags
    if cfg.framework == "traditional":
        m = mask_e[lo:lo + N].reshape((N,) + (1,) * (outs.dim() - 1))
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


def _mesh_sparse_forward(experts, xin, topi, weights, capacity, mask_e,
                         noise, noise_std, cfg, active, executor,
                         mesh: EdgeMesh):
    """Sparse dispatch on the edge mesh, run by every rank on the
    replicated gate's routing (off the mesh, a one-shard mesh whose
    exchanges are the identity).

    Rank ``s`` owns tokens ``[s*B_l, (s+1)*B_l)`` (``B_l = ceil(B/m)``)
    and scatters only those into a full ``(N, capacity, d)`` send buffer
    at their global bucket positions; the buffers cross the mesh by
    all-to-all and the ``(m, E_l, capacity, d)`` partials are summed over
    the senders.  That sum is exact: every bucket slot has at most one
    nonzero contributor (its one token) and 0 + x = x, so the
    ``(E_l, capacity, d)`` buckets the rank's experts run on are bitwise
    the one-device buckets' rows.  Wire bytes a rank sends are about
    ``capacity_factor*B*top_k*d``, whatever the expert count.

    The trust step runs on the local experts (``_trust_outputs`` with
    ``shard``), and the return exchange hands every bucket row back to
    the shard owning its token, masked by ``slot_src`` (the token shard
    of each filled slot, from the replicated routing, so it needs no
    exchange): the receiver's sum again has one contributor per slot.
    Each rank combines its own tokens with their gate weights (the
    paper's weighted sum over the top-K), and the rows are gathered to
    ``(B, C)`` on every rank, so every rank computes the one-device
    loss.  Backward: the exchanges reverse, the gather keeps this rank's
    rows of the (replicated) cotangent, and the replicated ``wk`` and
    ``xin`` enter through ``slice_rows``, whose cotangent slices are
    gathered whole, so the gate's backward runs on the full batch on
    every rank, as the one-device step's does; bank gradients stay on
    their shard.  Returns (y (B, C), support (N,), flags (N, M),
    dropped ())."""
    N, k, m = cfg.num_experts, cfg.top_k, mesh.shards
    E_l = N // m
    B = xin.shape[0]
    B_l = -(-B // m)
    dev = xin.device

    # this rank's tokens, scattered at their GLOBAL bucket positions
    b_lo, b_hi = mesh.row_range(B, B_l)
    send, eid, posc, keep = _sparse_dispatch(mesh.slice_rows(xin, B_l),
                                             topi, cfg, capacity,
                                             rows=(b_lo, b_hi))
    dropped = (B * k) - keep.sum().float()
    recv = mesh.all_to_all(send.reshape((m, E_l) + tuple(send.shape[1:])),
                           "dispatch")
    buf_l = recv.sum(dim=0)                       # (E_l, capacity, *tail)

    outs_l = ex.grouped_apply_fn(cfg.expert_kind)(experts, buf_l)
    trusted_l, support_l, flags_l = _trust_outputs(
        outs_l, mask_e, noise, noise_std, cfg, active, executor,
        shard=(mesh.shard, E_l))

    # return exchange, masked by ownership: slot_src is the token shard
    # of each filled slot, -1 for an empty one (a dropped assignment
    # adds 0, a kept one its shard + 1: one contributor a slot)
    towner = torch.arange(B, device=dev).repeat_interleave(k) // B_l
    slot_src = torch.zeros(N * capacity, dtype=torch.long, device=dev)
    slot_src.scatter_add_(0, eid * capacity + posc, (towner + 1) * keep)
    e_lo = mesh.shard * E_l
    own = slot_src.view(N, capacity)[e_lo:e_lo + E_l][None] - 1 == \
        torch.arange(m, device=dev)[:, None, None]     # (m, E_l, cap)
    back = torch.where(own.reshape(own.shape + (1,) * (trusted_l.dim() - 2)),
                       trusted_l[None], trusted_l.new_zeros(()))
    ret = mesh.all_to_all(back, "return").reshape(
        (N, capacity) + tuple(trusted_l.shape[2:]))
    mine = slice(b_lo * k, b_hi * k)
    yk = ret[eid[mine], posc[mine]]                    # (B_l*k, C)
    wk = weights.gather(1, topi).reshape(-1)
    wk = mesh.slice_rows(wk * keep.to(wk.dtype), B_l * k)  # drops give 0
    y_l = (yk * wk[:, None]).reshape(-1, k, yk.shape[-1]).sum(dim=1)
    y = mesh.gather_rows(y_l, B, B_l)
    support = mesh.all_gather(support_l).reshape(N)
    flags = mesh.all_gather(flags_l).reshape(N, cfg.num_edges)
    return y, support, flags, dropped


def _moe_forward(gate, experts, x, mask_e, noise, noise_std, cfg,
                 gate_bias=None, active=None, executor=0, mesh=None):
    """Shared forward: returns (trusted_out (B,C), weights (B,N),
    activation (N,), support (N,), flags (N,M), logits (B,N),
    dropped ()).  The gate reads the flattened task; the experts read
    flattened rows (MLP bank) or NHWC images (CNN bank).  Sparse dispatch
    runs on the edge ``mesh`` (``_mesh_sparse_forward``, ``experts`` this
    rank's slice; ``None``: one shard on the task's device) — bitwise the
    same outputs on any shard count."""
    flat = _flatten_for_gate(x)
    xin = x if cfg.expert_kind == "cnn" else flat
    logits = ex.gate_apply(gate, flat)
    if gate_bias is not None:
        # §VI-C workload-balance bias: steers routing, carries no gradient
        logits = logits + gate_bias.detach()[None, :]
    weights, topi = ex.sparse_gate_weights(logits, cfg.top_k)
    if active is None:
        active = torch.ones(cfg.num_edges, device=flat.device)
    if cfg.dispatch == "sparse":
        # top-k scatter-dispatch: only routed tokens reach an expert
        y, support, flags, dropped = _mesh_sparse_forward(
            experts, xin, topi, weights, sparse_capacity(cfg, flat.shape[0]),
            mask_e, noise, noise_std, cfg, active, executor,
            mesh if mesh is not None else local_mesh(flat.device))
    else:
        # dense dispatch: every expert on the whole batch; the top-k
        # weights zero the unrouted experts' share of the combine
        outs = ex.apply_all_fn(cfg.expert_kind)(experts, xin)  # (N, B, C)
        dropped = torch.zeros((), device=flat.device)
        trusted, support, flags = _trust_outputs(outs, mask_e, noise,
                                                 noise_std, cfg, active,
                                                 executor)
        y = torch.einsum("bn,nbc->bc", weights, trusted)
    activation = (weights > 0).sum(dim=0).float()
    return y, weights, activation, support, flags, logits, dropped


def _loss_and_grads(gate, experts, x, y, mask_e, noise, noise_std,
                    gate_bias, active, *, cfg, executor=0, mesh=None):
    """The training step's loss and gradients: the shared forward,
    log-softmax, the mean NLL of the labels ``y`` (B,), and the gradient
    over the gate and the bank by ``torch.autograd`` (the expert MLP's
    backward through ``ops.moe_gemm`` under sparse dispatch, the vote's
    to the elected copies).
    Returns (gate grads, expert grads, metrics) with loss, activation,
    support, flags and dropped on the device."""
    params = {("gate", k): v.detach().requires_grad_()
              for k, v in gate.items()}
    params.update({("experts", k): v.detach().requires_grad_()
                   for k, v in experts.items()})
    # the CNN's cuDNN flags cover its backward too
    with torch.enable_grad(), ex.cnn_numerics():
        gp = {k: v for (tree, k), v in params.items() if tree == "gate"}
        ep = {k: v for (tree, k), v in params.items() if tree == "experts"}
        out, _, activation, support, flags, _, dropped = _moe_forward(
            gp, ep, x, mask_e, noise, noise_std, cfg, gate_bias, active,
            executor, mesh)
        logp = torch.log_softmax(out, dim=-1)
        loss = -logp.gather(1, y[:, None]).mean()
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
    metrics = {"loss": loss.detach(), "activation": activation,
               "support": support, "flags": flags, "dropped": dropped}
    return ({k: grads[("gate", k)] for k in gate},
            {k: grads[("experts", k)] for k in experts}, metrics)


def _train_step(gate, experts, x, y, mask_e, noise, noise_std, gate_bias,
                active, *, cfg, executor=0, mesh=None):
    """One SGD step (the counterpart of JAX's ``_train_step``):
    ``_loss_and_grads``, then ``p - lr * g``.  The attack mask and noise
    come in as tensors.  Under the mesh the gate's update is replicated
    and the bank's stays on its shard.  Returns (gate, experts,
    metrics)."""
    g_gate, g_exp, metrics = _loss_and_grads(
        gate, experts, x, y, mask_e, noise, noise_std, gate_bias, active,
        cfg=cfg, executor=executor, mesh=mesh)
    return ({k: v.detach() - cfg.lr * g_gate[k] for k, v in gate.items()},
            {k: v.detach() - cfg.lr * g_exp[k] for k, v in experts.items()},
            metrics)


def _infer_step(gate, experts, x, mask_e, noise, noise_std, gate_bias,
                active, *, cfg, executor=0, mesh=None):
    with ex.cnn_numerics():
        out, _, activation, support, _, _, _ = _moe_forward(
            gate, experts, x, mask_e, noise, noise_std, cfg, gate_bias,
            active, executor, mesh)
    return out, activation, support
