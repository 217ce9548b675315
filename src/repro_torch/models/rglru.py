"""RG-LRU recurrent block (RecurrentGemma, arXiv:2402.19427): the
counterpart of ``repro.models.rglru``.

Recurrence: a_t = exp(-c * softplus(Lambda) * sigmoid(W_r x_t)),
h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (sigmoid(W_i x_t) * x_t).
The full-sequence forward runs the recurrence through
``kernels.ops.rglru_scan`` (the hand-written CUDA kernel on the card);
decode carries the hidden state, O(1) memory.

Block structure (simplified Griffin recurrent block): two branches from
the residual stream — (conv1d -> RG-LRU) and a GeLU gate — multiplied and
projected back.  The GeLU is the tanh approximation, ``jax.nn.gelu``'s
default (PyTorch's default is the erf form).

Tensor parallelism over ``model`` (a placed tree's ``rglru_inner``
channels, ``sharding.Sharder.tp``): the input enters through "f",
``w_in``, ``w_gate_branch``, ``conv`` and ``lam`` hold the rank's
channels, ``w_r`` and ``w_i`` its rows: the gates' products are partial
sums over the channels, reduce-scattered to the rank's channels
(``EdgeMesh.psum_scatter``, whose backward all-gathers), so the scan
runs on the rank's channels; ``w_out`` is row-parallel ("g").  Decode's
caches hold the rank's channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.builder import Leaf
from repro_torch.models.ssm import _causal_conv

_C = 8.0


def rglru_decl(cfg) -> dict:
    d = cfg.d_model
    inner = cfg.rglru_expand * d
    w = cfg.ssm_conv_width
    return {
        "w_in": Leaf((d, inner), ("embed", "rglru_inner")),
        "w_gate_branch": Leaf((d, inner), ("embed", "rglru_inner")),
        "conv": Leaf((w, inner), ("conv", "rglru_inner"), scale=0.5),
        "w_r": Leaf((inner, inner), ("rglru_inner", None), scale=0.02),
        "w_i": Leaf((inner, inner), ("rglru_inner", None), scale=0.02),
        "lam": Leaf((inner,), ("rglru_inner",), "constant", scale=0.7),
        "w_out": Leaf((inner, d), ("rglru_inner", "embed")),
    }


def _gelu(x):
    return F.gelu(x, approximate="tanh")


def _gates(params, x, tp=None):
    """x: (..., inner) -> (a, gated_input), both (..., inner), f32.
    ``tp``: ``x`` and the leaves hold this rank's channels (``w_r`` and
    ``w_i`` its rows); the two products' partial sums are
    reduce-scattered together to the rank's channels."""
    xf = x.float()
    if tp is None:
        r = torch.sigmoid(xf @ params["w_r"].float())
        i = torch.sigmoid(xf @ params["w_i"].float())
    else:
        ri = torch.stack([xf @ params["w_r"].float(),
                          xf @ params["w_i"].float()], dim=-2)
        ri = torch.sigmoid(tp.psum_scatter(ri, -1, "rglru_gates"))
        r, i = ri.unbind(-2)
    log_a = -_C * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def rglru_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h = 0.
    a, b: (B, S, C) f32.  Returns h: (B, S, C)."""
    return ops.rglru_scan(a.contiguous(), b.contiguous())


def _tp(shard):
    return shard.tp("rglru_inner") if shard is not None else None


def rglru_train(params, x, cfg, shard=None):
    """x: (B, S, d) -> (B, S, d).  ``shard``: the sharder of a placed
    tree (tensor-parallel over ``model``, see the module's docstring)."""
    tp = _tp(shard)
    if tp is not None:
        x = tp.copy_to(x, "rglru_in")
    gate = _gelu(x @ params["w_gate_branch"])
    u = x @ params["w_in"]
    u = _causal_conv(u, params["conv"])
    a, b = _gates(params, u, tp)
    h = rglru_scan(a, b).to(x.dtype)
    out = (h * gate) @ params["w_out"]
    return out if tp is None else tp.psum(out, "rglru_sum")


def rglru_decode(params, x, cache, cfg, shard=None):
    """One token. cache = {"h": (B, inner) f32, "conv": (B, W-1, inner)}
    (this rank's channels over a placed tree)."""
    tp = _tp(shard)
    xt = x[:, 0]
    gate = _gelu(xt @ params["w_gate_branch"])
    pre = xt @ params["w_in"]
    hist = torch.cat([cache["conv"], pre[:, None]], dim=1)
    u = (hist * params["conv"][None]).sum(dim=1)
    a, b = _gates(params, u, tp)
    h = a * cache["h"] + b
    out = ((h.to(x.dtype) * gate) @ params["w_out"])[:, None]
    if tp is not None:
        out = tp.psum(out, "rglru_sum")
    return out, {"h": h, "conv": hist[:, 1:]}
