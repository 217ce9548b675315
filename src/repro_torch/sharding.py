"""Logical-axis sharding rules and the placement of every parameter
leaf (the counterpart of ``repro.sharding``).

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

Under SPMD the layout is explicit: a ``Sharder`` applied to a rank's
tensor is the identity, and the layers ask it what the rank holds
(``Sharder.tp``, ``Sharder.fsdp_view``).  What the port places:

- the batch over pod x data (each rank keeps its rows of the global
  batch);
- every parameter leaf of every model as the JAX package's
  ``partition_specs`` under ``logical_rules(mesh, cfg, params=use_fsdp(
  cfg, kind, model width))`` say (``placed_specs``, ``shard_params``,
  ``place_leaf``): ``embed`` over pod x data (FSDP: the layers gather a
  block's leaves whole before use and reduce-scatter their gradients),
  and ``vocab``, ``q_dim``, ``kv_dim``, ``ff``, ``experts``, ``moe_ff``,
  ``ssm_inner``, ``ssm_heads`` and ``rglru_inner`` over ``model``
  (tensor and expert parallelism: each rank keeps its contiguous part,
  and the layers run column- and row-parallel);
  ``unplaced_leaves``, the check, lists any dimension JAX splits and the
  port keeps whole: there is none;
- the decode caches as the JAX package's cache rules say, on every
  dimension (``shard_caches``, ``place_cache``: each rank keeps its
  batch rows, its contiguous part of the positions, and its part of a
  recurrent mixer's heads or channels over ``model``; kv heads stay
  whole, as JAX's rules leave them wherever ``cache_seq`` uses
  ``model``).

``shard_bank`` places the B-MoE system's expert bank on the edge mesh
(``BMoESystem(mesh="on")``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


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
    sharder is the identity (the layout is explicit under SPMD).

    On a mesh the model's leaves are this rank's parts (``shard_params``):
    the layers run tensor-parallel over ``model`` where ``tp`` names a
    view, and gather a leaf's ``embed`` dimension over ``fsdp_view``
    wherever the rank holds part of it."""

    def __init__(self, mesh=None, rules: Optional[dict] = None,
                 fsdp: bool = True, attack=None):
        self.mesh = mesh
        self.rules = rules if rules is not None else logical_rules(mesh)
        self.fsdp = fsdp
        self.attack = attack

    def tp(self, axis: str):
        """The ``model`` view a placed dimension of logical ``axis`` is
        split over, or None (whole: no mesh, a model axis of one, a rule
        that leaves it whole)."""
        if (self.mesh is None or self.rules.get(axis) != "model"
                or self.mesh.model.shards == 1):
            return None
        return self.mesh.model

    @property
    def fsdp_view(self):
        """The pod x data view an FSDP leaf's ``embed`` is split over, or
        None."""
        if self.mesh is None or self.mesh.batch.shards == 1:
            return None
        return self.mesh.batch

    def spec(self, *axes) -> tuple:
        return tuple(self.rules.get(a) if a is not None else None
                     for a in axes)

    def __call__(self, x, *axes):
        if self.mesh is not None and len(axes) != x.dim():
            raise ValueError(f"{len(axes)} axes for rank-{x.dim()} value")
        return x


NO_SHARD = Sharder(None)


def step_sharder(cfg, mesh, kind: str, attack=None) -> Optional[Sharder]:
    """The sharder of a ``kind`` step of ``cfg`` on ``mesh`` over a placed
    tree (None without a mesh): JAX's activation rules and its FSDP
    policy."""
    if mesh is None:
        return None
    return Sharder(mesh, logical_rules(mesh, cfg),
                   fsdp=use_fsdp(cfg, kind, mesh.shape[-1]), attack=attack)


# ------------------------------------------------------ leaf placement
def is_expert_parallel(cfg, mesh) -> bool:
    """Does ``cfg``'s MoE run expert-parallel on ``mesh``?"""
    return (mesh is not None and getattr(cfg, "moe_impl", "") == "ep"
            and bool(getattr(cfg, "num_experts", 0)))


def param_decl(cfg):
    """The parameter declaration of ``cfg`` (either family)."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    return (encdec.encdec_decl(cfg) if cfg.is_encoder_decoder
            else tfm.model_decl(cfg))


def param_rules(cfg, mesh, kind: str = "train") -> dict:
    """JAX's parameter rules for a ``kind`` step (``launch/shapes.py``'s
    choice): ``embed`` over pod x data when ``use_fsdp`` says so."""
    return logical_rules(mesh, cfg,
                         params=use_fsdp(cfg, kind, mesh.shape[-1]))


def placed_specs(cfg, mesh, kind: str = "train"):
    """Each leaf's partition spec as the port places it for a ``kind``
    step: JAX's ``partition_specs`` under ``param_rules``.  None without
    a mesh."""
    if mesh is None:
        return None
    return specs_for(param_decl(cfg), cfg, mesh, kind)


def specs_for(decl, cfg, mesh, kind: str = "train"):
    """``placed_specs``' specs for any part ``decl`` of the declaration
    (a layer's, an MoE block's)."""
    from repro_torch.models.builder import partition_specs
    return partition_specs(decl, param_rules(cfg, mesh, kind))


def unplaced_leaves(cfg, mesh, kind: str = "train"):
    """``[(path, logical axis, JAX's mesh axes)]``: every dimension JAX's
    specs split that the port keeps whole, in declaration order (the
    check that ``placed_specs`` follows JAX's specs: empty for every
    config)."""
    from repro_torch.models.builder import Leaf, partition_specs
    decl = param_decl(cfg)
    jax_specs = partition_specs(decl, param_rules(cfg, mesh, kind))
    mine = placed_specs(cfg, mesh, kind)
    out = []

    def walk(d, js, ms, path):
        if isinstance(d, Leaf):
            out.extend((path, a, j) for a, j, m in zip(d.axes, js, ms)
                       if j is not None and m is None)
        elif isinstance(d, dict):
            for k in d:
                walk(d[k], js[k], ms[k], f"{path}/{k}")
        else:
            for i, v in enumerate(d):
                walk(v, js[i], ms[i], f"{path}/{i}")

    walk(decl, jax_specs, mine, "")
    return out


def spec_views(spec, mesh):
    """Per dimension of a placed leaf, the mesh view it is split over (a
    group of one counts as whole), or None."""
    out = []
    for s in spec:
        names = () if s is None else ((s,) if isinstance(s, str)
                                      else tuple(s))
        if not names:
            view = None
        elif names == ("model",):
            view = mesh.model
        elif set(names) <= {"pod", "data"}:
            view = mesh.batch
        else:
            raise ValueError(f"the port places no dimension over {names}")
        out.append(view if view is not None and view.shards > 1 else None)
    return out


def cut_leaf(t: torch.Tensor, spec, mesh, path: str = "a leaf"
             ) -> torch.Tensor:
    """This rank's part of a whole leaf under its placed ``spec``, a
    tensor of its own (the whole leaf is not kept alive by a view); the
    leaf itself when nothing is cut.  Raises, naming the numbers, when a
    group does not divide a dimension."""
    views = spec_views(spec, mesh)
    if all(v is None for v in views):
        return t
    for d, v in enumerate(views):
        if v is not None:
            lo, hi = v.span(t.shape[d], f"{path} dimension {d}")
            t = t.narrow(d, lo, hi - lo)
    return t.clone()


def gather_leaf(t: torch.Tensor, spec, mesh, shape) -> torch.Tensor:
    """The whole leaf of ``shape`` from this rank's part (``cut_leaf``'s
    inverse): each dimension the rank holds part of all-gathered over
    its group, in rank order (``spec`` a training placement's, which
    splits every dimension any placement does).  Collective over those
    groups.  No gradient."""
    for d, v in enumerate(spec_views(spec, mesh)):
        if v is not None and t.shape[d] < shape[d]:
            t = torch.cat(list(v.all_gather(t, "gather_params")), dim=d)
    return t


def _spec_map(fn, tree, specs, path=""):
    """``fn(path, leaf, spec)`` over a parameter tree and its specs."""
    if isinstance(tree, dict):
        return {k: _spec_map(fn, tree[k], specs[k], f"{path}/{k}")
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return [_spec_map(fn, t, s, f"{path}/{i}")
                for i, (t, s) in enumerate(zip(tree, specs))]
    return fn(path, tree, specs)


def shard_params(params, cfg, mesh, kind: str = "train"):
    """This rank's tree of a whole one, placed for a ``kind`` step
    (``placed_specs``; prefill and decode place alike): each leaf cut to
    the rank's part, a tensor of its own; a leaf that is not cut is the
    input's.  Under expert parallelism an MoE layer's expert leaves keep
    the rank's contiguous ``E / model`` rows.  Identity without a
    mesh."""
    if mesh is None:
        return params
    return _spec_map(lambda p, t, s: cut_leaf(t, s, mesh, p), params,
                     placed_specs(cfg, mesh, kind))


def place_leaf(cfg, mesh, kind: str = "train"):
    """``models.builder.materialize``'s ``place`` for this rank: each leaf
    cut to its part as it is drawn (``cut_leaf`` under ``placed_specs``),
    so the rank's tree is ``shard_params`` of the whole one while at most
    one whole leaf is in memory at a time; None without a mesh."""
    from repro_torch.models.builder import abstract
    if mesh is None:
        return None
    flat = {}
    _spec_map(lambda p, t, s: flat.__setitem__(p, s),
              abstract(param_decl(cfg)), placed_specs(cfg, mesh, kind))

    def place(path, t):
        return cut_leaf(t, flat[path], mesh, path)

    return place


def gather_params(params, cfg, mesh):
    """The whole tree from this rank's (``shard_params``' inverse, either
    kind's placement): every dimension the rank holds part of
    all-gathered over its group.  Collective: every rank of the mesh
    calls it.  No gradient."""
    from repro_torch.models.builder import abstract
    if mesh is None:
        return params
    shapes = {}
    _spec_map(lambda p, t, s: shapes.__setitem__(p, t.shape),
              abstract(param_decl(cfg)), abstract(param_decl(cfg)))
    return _spec_map(lambda p, t, s: gather_leaf(t, s, mesh, shapes[p]),
                     params, placed_specs(cfg, mesh, "train"))


def leaf_splits(params, cfg, mesh):
    """Per leaf of a placed tree (either kind's placement), ``(over
    model, over the batch ranks)``: whether the rank holds part of a
    dimension the leaf's spec splits over ``model``, and part of its
    ``embed`` dimension (FSDP), read from its shape against the
    declaration's."""
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.models.builder import Leaf
    decl = param_decl(cfg)
    specs = placed_specs(cfg, mesh, "train")
    out = []

    def walk(t, d, s):
        if isinstance(d, Leaf):
            short = [n < w for n, w in zip(t.shape, d.shape)]
            out.append((any(c and x == "model" for c, x in zip(short, s)),
                        any(c and a == "embed" for c, a in zip(short,
                                                               d.axes))))
        elif isinstance(d, dict):
            for k in t:
                walk(t[k], d[k], s[k])
        else:
            for a, b, c in zip(t, d, s):
                walk(a, b, c)

    walk(params, decl, specs)
    assert len(out) == len(tree_flatten(params)[0])
    return out


def fsdp_gather(tree, decl, shard):
    """``tree`` (a layer's or the model's top leaves, ``decl`` its
    declaration) with every leaf whose ``embed`` dimension this rank
    holds part of gathered whole over ``shard.fsdp_view`` (differentiable:
    the gradient is reduce-scattered back).  Tensor-parallel dimensions
    stay split.  ``tree`` itself without FSDP."""
    from repro_torch.models.builder import Leaf
    view = shard.fsdp_view if shard is not None else None
    if view is None:
        return tree

    def walk(t, d):
        if isinstance(d, Leaf):
            if "embed" not in d.axes:
                return t
            dim = d.axes.index("embed")
            if t.shape[dim] == d.shape[dim]:
                return t
            return view.gather_dim(t, dim, "fsdp_gather", reduce=True)
        if isinstance(d, dict):
            return {k: walk(t[k], d[k]) for k in t}
        return [walk(a, b) for a, b in zip(t, d)]

    return walk(tree, decl)


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
def cache_decl_of(cfg):
    """The decode cache declaration's logical axes for ``cfg`` (the
    leaves' shapes at unit sizes; only their axes are read)."""
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    if cfg.is_encoder_decoder:
        return encdec.encdec_cache_decl(cfg, 1, 1, 1)
    return tfm.cache_decl(cfg, 1, 1)


def cache_specs(decl, cfg, mesh):
    """Each cache leaf's partition spec: JAX's (``builder.partition_specs``
    under ``logical_rules(mesh, cfg)``), which the port places on every
    dimension."""
    from repro_torch.models.builder import partition_specs
    return partition_specs(decl, logical_rules(mesh, cfg))


def _dim_view(mesh, cfg, axis, rules: dict):
    """The mesh view a cache dimension of logical ``axis`` splits over,
    or None (whole on every rank, or a group of one): the batch over pod
    x data, the linear cache's positions over ``mesh.cache_group(cfg)``,
    any other dimension JAX's rules put over ``model`` (the ring's
    positions, a recurrent mixer's heads or channels) over ``model``."""
    rule = rules.get(axis) if axis is not None else None
    if not rule:
        return None
    if axis == "batch":
        view = mesh.batch
    elif axis == "cache_seq":
        view = mesh.cache_group(cfg)
    elif rule == "model" and axis != "kv_heads":
        view = mesh.model
    else:
        raise ValueError(f"the port splits no cache dimension {axis!r} "
                         f"over {rule!r} (its decode attention holds every "
                         f"kv head of its positions)")
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
    contiguous positions over ``mesh.cache_group(cfg)``, and ``kv_seq``
    (a sliding-window ring, where the window divides ``model``),
    ``ssm_heads`` (where the heads divide it) and ``rglru_inner`` to
    the rank's contiguous part over ``model``, as ``cache_specs``
    says.  Raises, naming the numbers, when a group
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
