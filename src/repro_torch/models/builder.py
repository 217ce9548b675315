"""Declaration-based parameter trees (the counterpart of
``repro.models.builder``).

Models declare their parameters once as a nested dict of :class:`Leaf`
(shape + logical axes + init law); ``materialize`` turns a declaration
into tensors, ``abstract`` into meta tensors of each leaf's shape and
dtype (the dry run's stand-ins: nothing is allocated), and
``partition_specs`` into each leaf's mesh axes under a rules dict.  The
logical axes are kept so that a declaration compares equal with the JAX
package's; ``materialize``'s ``place`` keeps a rank's part of each leaf
(``sharding.place_leaf``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from typing import Any, Callable, Mapping

import torch

from repro_torch.kernels.ops import resolve_device

Tree = Any

# the dtype overrides declarations use (quantized KV caches and scales)
_DTYPES = {"float32": torch.float32, "int8": torch.int8}


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A single parameter declaration."""

    shape: tuple
    axes: tuple  # logical axis name (or None) per dim, len == len(shape)
    init: str = "normal"  # normal | zeros | ones | scaled | constant
    scale: float | None = None  # stddev for normal/scaled; value for constant
    dtype: str | None = None    # override the materialization dtype
                                # (e.g. "int8" quantized KV caches)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def _walk(tree: Tree, fn: Callable[[str, Leaf], Any], prefix: str = "") -> Tree:
    if isinstance(tree, Leaf):
        return fn(prefix, tree)
    if isinstance(tree, Mapping):
        return {k: _walk(v, fn, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_walk(v, fn, f"{prefix}/{i}") for i, v in enumerate(tree)]
    raise TypeError(f"unexpected node at {prefix}: {type(tree)}")


def _leaf_dtype(leaf: Leaf, default: torch.dtype) -> torch.dtype:
    return _DTYPES[leaf.dtype] if leaf.dtype else default


def _leaf_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{seed}:{path}".encode()).digest()
    return int.from_bytes(digest[:8], "big") & ((1 << 63) - 1)


def _init_leaf(leaf: Leaf, seed: int, path: str, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=dtype, device=device)
    if leaf.init == "constant":
        return torch.full(leaf.shape, leaf.scale, dtype=dtype, device=device)
    if leaf.init in ("normal", "scaled"):
        if leaf.scale is not None:
            std = leaf.scale
        else:  # fan-in scaling on the second-to-last dim (or last for 1D)
            fan_in = leaf.shape[-2] if len(leaf.shape) >= 2 else leaf.shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
        gen = torch.Generator(device=device)
        gen.manual_seed(_leaf_seed(seed, path))
        out = torch.randn(leaf.shape, generator=gen, dtype=torch.float32,
                          device=device)
        return out.mul_(std).to(dtype)
    raise ValueError(f"unknown init {leaf.init}")


def materialize(decl: Tree, seed: int = 0, device=None,
                dtype: torch.dtype = torch.float32,
                place: Callable[[str, torch.Tensor], torch.Tensor] = None
                ) -> Tree:
    """Tensors for every leaf of ``decl`` on ``device`` (``None``: the
    CUDA device).  Each normal leaf is drawn on the device from its own
    ``torch.Generator``, seeded from ``seed`` and the leaf's path, so a
    leaf's values do not depend on the other leaves, and nothing is drawn
    on the host and copied.  The values differ from the JAX package's
    (threefry keys are not reproduced): parity tests carry JAX weights
    across with ``convert.lm_params_from_numpy``.  ``place(path, leaf)``
    returns what is kept of each leaf as it is drawn (a rank's rows), so
    the whole leaf is freed before the next is drawn."""
    dev = resolve_device(device)

    def init(path, leaf):
        t = _init_leaf(leaf, seed, path, dev, _leaf_dtype(leaf, dtype))
        return t if place is None else place(path, t)

    return _walk(decl, init)


def abstract(decl: Tree, dtype: torch.dtype = torch.bfloat16) -> Tree:
    """Meta tensors with each leaf's shape and dtype (the leaf's own
    dtype where it names one, else ``dtype``; JAX's default is kept)."""
    return _walk(decl, lambda p, l: torch.empty(
        l.shape, dtype=_leaf_dtype(l, dtype), device="meta"))


def partition_specs(decl: Tree, rules: Mapping[str, Any]) -> Tree:
    """Each leaf's logical axes mapped to mesh axes: a tuple with, per
    dimension, ``rules[name]`` (a mesh axis name, a tuple of names or
    None), the form ``sharding.Sharder.spec`` returns."""
    return _walk(decl, lambda _, l: tuple(
        rules.get(a) if a is not None else None for a in l.axes))


def count_params(decl: Tree) -> int:
    total = 0

    def add(_, leaf: Leaf):
        nonlocal total
        total += math.prod(leaf.shape)
        return None

    _walk(decl, add)
    return total


def stack(decl: Tree, n: int, axis_name: str = "layers") -> Tree:
    """Prepend a stacked dimension of size ``n`` to every leaf."""

    def stk(_, leaf: Leaf):
        return Leaf((n,) + tuple(leaf.shape), (axis_name,) + tuple(leaf.axes),
                    leaf.init, leaf.scale, leaf.dtype)

    return _walk(decl, stk)
