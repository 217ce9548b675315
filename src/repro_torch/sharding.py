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
rank keeps its rows of the global batch), the experts of an
expert-parallel MoE layer over ``model`` (``shard_params``: each rank
keeps its contiguous ``E / model`` rows of ``w_gate``, ``w_up`` and
``w_down``), and the decode caches by the cache declaration's
``batch``, ``cache_seq`` and ``kv_seq`` dimensions under the JAX
package's rules (``shard_caches``, ``place_cache``: each rank keeps its
batch rows and its contiguous part of the positions).  Every other leaf
and dimension is whole on every rank (FSDP's embed-over-data placement
and dense tensor parallelism, a recurrent state's inner dimension over
``model`` among them, change memory, not results, and are not ported).
``shard_bank`` places the B-MoE system's expert bank on the edge mesh
(``BMoESystem(mesh="on")``).
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


# ---------------------------------------------------- cache placement
# the cache declaration's dimensions the port splits; the others (kv
# heads, recurrent inner dims over model: tensor parallelism) stay whole
_CACHE_PLACED = ("batch", "cache_seq", "kv_seq")


def cache_decl_of(cfg):
    """The decode cache declaration's logical axes for ``cfg`` (the
    leaves' shapes at unit sizes; only their axes are read)."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    if cfg.is_encoder_decoder:
        return encdec.encdec_cache_decl(cfg, 1, 1, 1)
    return tfm.cache_decl(cfg, 1, 1)


def cache_specs(decl, cfg, mesh):
    """Each cache leaf's partition spec as the port places it: JAX's
    (``builder.partition_specs`` under ``logical_rules(mesh, cfg)``) on
    the ``batch``, ``cache_seq`` and ``kv_seq`` dimensions, None on every
    other."""
    from repro_torch.models.builder import partition_specs
    rules = logical_rules(mesh, cfg)
    return partition_specs(decl, {a: rules.get(a) for a in _CACHE_PLACED})


def _dim_view(mesh, cfg, axis: str, rules: dict):
    """The mesh view a cache dimension of logical ``axis`` splits over,
    or None (whole on every rank, or a group of one)."""
    if axis == "batch":
        view = mesh.batch if rules.get("batch") else None
    elif axis == "cache_seq":
        view = mesh.cache_group(cfg) if rules.get("cache_seq") else None
    elif axis == "kv_seq":
        view = mesh.model if rules.get("kv_seq") else None
    else:
        view = None
    return view if view is not None and view.shards > 1 else None


def cache_views(cfg, mesh, axes):
    """Per dimension of a cache leaf with logical ``axes``, the mesh view
    it splits over (``shard_caches``' placement), or None where it is
    whole."""
    rules = logical_rules(mesh, cfg)
    return [_dim_view(mesh, cfg, a, rules) for a in axes]


def _zip_map(fn, tree, decl, path=""):
    """``fn(path, leaf tensor, Leaf)`` over a cache tree and its
    declaration (the same structure)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], decl[k], f"{path}/{k}")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_zip_map(fn, t, d, f"{path}/{i}")
                for i, (t, d) in enumerate(zip(tree, decl))]
    return fn(path, tree, decl)


def _cut_shape(shape, axes, views, path: str):
    """(this rank's [lo, hi) per dimension) of a leaf of ``shape``."""
    out = []
    for n, a, v in zip(shape, axes, views):
        out.append((0, n) if v is None else
                   v.span(n, f"cache leaf {path} dimension '{a}'"))
    return out


def shard_caches(caches, cfg, mesh):
    """This rank's part of a whole decode-cache tree (``cache_decl`` or
    ``encdec_cache_decl`` of ``cfg``), as tensors of their own: each
    leaf's ``batch`` dimension cut to the rank's rows (split over pod x
    data when ``cfg`` is ``batch_shardable``), ``cache_seq`` to its
    contiguous positions over ``mesh.cache_group(cfg)`` and ``kv_seq``
    (a sliding-window ring) over ``model`` where the window divides it,
    as ``cache_specs`` says.  Raises, naming the numbers, when a group
    does not divide a dimension.  Identity without a mesh."""
    if mesh is None:
        return caches

    def cut(path, t, leaf):
        vs = cache_views(cfg, mesh, leaf.axes)
        for d, (lo, hi) in enumerate(_cut_shape(t.shape, leaf.axes, vs,
                                                path)):
            if vs[d] is not None:
                t = t.narrow(d, lo, hi - lo)
        return t.clone()

    return _zip_map(cut, caches, cache_decl_of(cfg))


def gather_caches(caches, cfg, mesh):
    """The whole cache tree from this rank's (``shard_caches``' inverse):
    each placed dimension all-gathered over its group, in rank order.
    Collective: every rank of the mesh calls it.  No gradient."""
    if mesh is None:
        return caches

    def whole(path, t, leaf):
        for d, v in enumerate(cache_views(cfg, mesh, leaf.axes)):
            if v is not None:
                t = torch.cat(list(v.all_gather(t, "gather_caches")), dim=d)
        return t

    return _zip_map(whole, caches, cache_decl_of(cfg))


def place_cache(decl, cfg, mesh):
    """This rank's cache declaration: every leaf of ``decl`` (a
    ``cache_decl``, zeros) with its shape cut to the rank's part, so
    ``models.builder.materialize`` draws the rank's slice and the whole
    cache is never in memory (zeros: the slice of the whole one).
    ``decl`` itself without a mesh."""
    import dataclasses as dc
    from repro_torch.models.builder import Leaf
    if mesh is None:
        return decl

    def walk(node, path):
        if isinstance(node, Leaf):
            if node.init != "zeros":
                raise ValueError(f"{path}: place_cache cuts zero-initialised"
                                 f" cache leaves, not {node.init!r} ones")
            span = _cut_shape(node.shape, node.axes,
                              cache_views(cfg, mesh, node.axes), path)
            return dc.replace(node, shape=tuple(hi - lo for lo, hi in span))
        if isinstance(node, dict):
            return {k: walk(v, f"{path}/{k}") for k, v in node.items()}
        return [walk(v, f"{path}/{i}") for i, v in enumerate(node)]

    return walk(decl, "")


def cache_split(shard, cfg, window: int, cap: int):
    """How a decode attention layer's cache of local capacity ``cap`` is
    split on the sharder's mesh: ``(view, lo, global capacity)``, this
    rank holding positions [lo, lo + cap); None when it holds them all
    (no mesh, or a group of one).  ``window`` > 0: the sliding-window
    ring (``kv_seq``), else the linear cache (``cache_seq``)."""
    mesh = getattr(shard, "mesh", None)
    if mesh is None:
        return None
    view = cache_views(cfg, mesh, ("kv_seq" if window else "cache_seq",))[0]
    if view is None:
        return None
    return view, view.shard * cap, cap * view.shards


def owned_row(mesh, cfg, batch: int, row: int):
    """This rank's local index of global batch row ``row`` of a batch of
    ``batch`` rows, or None when another rank holds it."""
    if mesh is None:
        return row
    lo, hi = mesh.batch_rows(batch, cfg)
    return row - lo if lo <= row < hi else None
