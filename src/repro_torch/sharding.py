"""Logical-axis sharding rules and the placement of expert leaves (the
counterpart of ``repro.sharding``).

Model code names its parameters' and activations' dimensions with
*logical* axes ("batch", "vocab", "ff", "experts", ...).
``logical_rules`` maps them to the axes of whatever mesh is in play, as
the JAX package does:

  single-pod        (data=16, model=16)
  multi-pod         (pod=2, data=16, model=16)     # pod folds into batch
  trusted (B-MoE)   (data/r, replica=r, model)     # widths world-derived
  edge (B-MoE sys)  (data, model=edge shards)      # expert bank over model
  one device        mesh=None -> no rules

The "replica" axis is never assigned to a logical axis: replicas hold
identical copies of the batch shard, and only the consensus vote
communicates across it (``core.trusted_moe``).

Under SPMD the layout is explicit, so the rules are a record (what
``Sharder.spec`` reports), and a ``Sharder`` applied to a rank's tensor
is the identity.  What the port places: the batch over pod x data (each
rank keeps its rows of the global batch), and the experts of an
expert-parallel MoE layer over ``model`` (``shard_params``: each rank
keeps its contiguous ``E / model`` rows of ``w_gate``, ``w_up`` and
``w_down``).  Every other leaf is whole on every rank (FSDP's
embed-over-data placement and dense tensor parallelism change memory,
not results, and are not ported).  ``shard_bank`` places the B-MoE
system's expert bank on the edge mesh (``BMoESystem(mesh="on")``).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _mesh_axes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.shape))


def logical_rules(mesh, cfg=None, params: bool = False) -> dict:
    """Activation rules (default) or parameter rules (``params=True``):
    logical axis -> mesh axis name, tuple of names or None, JAX's dict
    for a mesh of these axis names and widths (``mesh.axis_names``,
    ``mesh.shape``).  Parameter rules also put ``embed`` over the batch
    axes (FSDP) where ``d_model`` divides them."""
    if mesh is None:
        return {}
    axes = _mesh_axes(mesh)
    batch = tuple(a for a in ("pod", "data") if a in axes) or None
    if cfg is not None and not getattr(cfg, "batch_shardable", True):
        batch = None
    model = "model" if "model" in axes else None
    msize = axes.get("model", 1)

    def _iff_divides(n):  # shard an axis only when it divides the mesh axis
        return model if (model and n and n % msize == 0) else None

    rules = {
        "batch": batch,
        "seq": None,
        "embed": None,
        "layers": None,
        "vocab": model,
        "q_dim": model,
        "kv_dim": model,
        "heads": _iff_divides(getattr(cfg, "num_heads", 0)),
        "kv_heads": _iff_divides(getattr(cfg, "num_kv_heads", 0)),
        "head_dim": None,
        "ff": model,
        "ssm_inner": model,
        "ssm_heads": _iff_divides(getattr(cfg, "ssm_heads", 0) if cfg else 0),
        "rglru_inner": model,
        "state": None,
        "conv": None,
        "kv_seq": _iff_divides(getattr(cfg, "sliding_window", 0)),
        "cache_seq": None,
    }
    # expert parallelism where the experts divide the model axis, else
    # tensor parallelism inside each expert
    if cfg is not None and getattr(cfg, "num_experts", 0):
        n_exp = getattr(cfg, "resolved_padded_experts", cfg.num_experts)
        if n_exp % msize == 0:
            rules["experts"] = model
            rules["moe_ff"] = None
        else:
            rules["experts"] = None
            rules["moe_ff"] = model
    else:
        rules["experts"] = None
        rules["moe_ff"] = model
    # decode caches: the sequence dim over the axes the config names
    cache_axes = tuple(a for a in getattr(cfg, "cache_seq_axes", ("model",))
                       if a in axes) if cfg is not None else ()
    rules["cache_seq"] = cache_axes or None
    if "model" in cache_axes:
        # one spec may use each mesh axis once
        rules["kv_heads"] = None
    if params:
        fsdp = tuple(a for a in ("pod", "data") if a in axes) or None
        d_model = getattr(cfg, "d_model", 0) if cfg is not None else 0
        n_fsdp = 1
        for a in (fsdp or ()):
            n_fsdp *= axes[a]
        if fsdp and d_model and d_model % n_fsdp == 0:
            rules["embed"] = fsdp
    return rules


def use_fsdp(cfg, kind: str, model_shards: int = 16,
             hbm_budget: float = 9e9) -> bool:
    """FSDP policy per step kind: training always; prefill and decode
    only when the bf16 parameters split over ``model_shards`` would not
    fit ``hbm_budget`` bytes (parameters counted from the declaration,
    ``models.builder.count_params``)."""
    if kind == "train":
        return True
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    from repro_torch.models.builder import count_params
    decl = (encdec.encdec_decl(cfg) if cfg.is_encoder_decoder
            else tfm.model_decl(cfg))
    return count_params(decl) * 2 / model_shards > hbm_budget


class Sharder:
    """The mesh a model runs on, its rules, whether parameters carry FSDP
    and the in-graph adversary of the trusted-MoE tests.  ``spec`` gives
    JAX's partition spec as a tuple; applied to a rank's tensor the
    sharder is the identity (the layout is explicit under SPMD)."""

    def __init__(self, mesh=None, rules: Optional[dict] = None,
                 fsdp: bool = True, attack=None):
        self.mesh = mesh
        self.rules = rules if rules is not None else logical_rules(mesh)
        self.fsdp = fsdp
        self.attack = attack

    def spec(self, *axes) -> tuple:
        return tuple(self.rules.get(a) if a is not None else None
                     for a in axes)

    def __call__(self, x, *axes):
        if self.mesh is not None and len(axes) != x.dim():
            raise ValueError(f"{len(axes)} axes for rank-{x.dim()} value")
        return x


NO_SHARD = Sharder(None)


# --------------------------------------------------- expert placement
def is_expert_parallel(cfg, mesh) -> bool:
    """Does ``cfg``'s MoE run expert-parallel on ``mesh``?"""
    return (mesh is not None and getattr(cfg, "moe_impl", "") == "ep"
            and bool(getattr(cfg, "num_experts", 0)))


def map_expert_leaves(params, fn: Callable, other: Callable = None):
    """``params`` with ``fn(leaf, axis)`` applied to the routed experts'
    ``w_gate``, ``w_up`` and ``w_down`` of every MoE layer (``axis`` the
    expert axis: 1 in the stacked blocks, 0 in the remainder) and
    ``other(leaf)`` (default: the leaf itself) to every other leaf."""
    other = other or (lambda t: t)

    def walk(node, stacked, in_moe):
        if isinstance(node, dict):
            return {k: (fn(v, 1 if stacked else 0)
                        if in_moe and k in _EXPERT_LEAVES
                        and not isinstance(v, (dict, list))
                        else walk(v, stacked or k in ("blocks",),
                                  k == "moe"))
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, stacked, in_moe) for v in node]
        return other(node)

    return walk(params, False, False)


def _cutter(mesh):
    """(leaf, expert axis) -> this rank's contiguous expert rows, a
    tensor of its own (the whole leaf is not kept alive by a view)."""
    m, s = mesh.model.shards, mesh.model.shard

    def cut(t, axis):
        e_l = t.shape[axis] // m
        return t.narrow(axis, s * e_l, e_l).clone()

    return cut


def shard_params(params, cfg, mesh):
    """This rank's tree: under expert parallelism each MoE layer's
    expert leaves cut to the rank's contiguous ``E / model`` rows, every
    other leaf as given."""
    if not is_expert_parallel(cfg, mesh):
        return params
    return map_expert_leaves(params, _cutter(mesh))


def place_leaf(cfg, mesh):
    """``models.builder.materialize``'s ``place`` for this rank: an
    expert-parallel layer's expert leaf (path ``.../moe/w_gate`` and the
    like) cut to the rank's rows as it is drawn, so the rank's tree is
    ``shard_params`` of the whole one without the whole one in memory;
    None when nothing is cut."""
    if not is_expert_parallel(cfg, mesh):
        return None
    cut = _cutter(mesh)

    def place(path, t):
        parts = path.split("/")
        if parts[-1] not in _EXPERT_LEAVES or parts[-2] != "moe":
            return t
        return cut(t, 1 if parts[1] == "blocks" else 0)

    return place


def gather_params(params, cfg, mesh):
    """The whole tree from this rank's (``shard_params``' inverse): the
    expert leaves all-gathered over ``model``.  Collective: every rank of
    the model group calls it.  No gradient."""
    if not is_expert_parallel(cfg, mesh):
        return params

    def whole(t, axis):
        parts = mesh.model.all_gather(t, "gather_params")
        return torch.cat(list(parts), dim=axis)

    return map_expert_leaves(params, whole)


def shard_bank(bank: Dict[str, torch.Tensor], mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's expert rows of the B-MoE ``bank`` (every leaf's
    leading axis the ``N`` experts, on any device) on ``mesh.device``:
    its contiguous ``[s*E_l, (s+1)*E_l)`` rows, ``E_l = N / shards``, as
    tensors of their own (the full bank is not kept alive by a view)."""
    n = next(iter(bank.values())).shape[0]
    lo, hi = mesh.expert_range(n)
    return {k: v[lo:hi].to(mesh.device).clone() for k, v in bank.items()}
