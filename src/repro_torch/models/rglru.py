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


def _gates(params, x):
    """x: (..., inner) -> (a, gated_input), both (..., inner), f32."""
    xf = x.float()
    r = torch.sigmoid(xf @ params["w_r"].float())
    i = torch.sigmoid(xf @ params["w_i"].float())
    log_a = -_C * F.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    return a, gated


def rglru_scan(a, b):
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h = 0.
    a, b: (B, S, C) f32.  Returns h: (B, S, C)."""
    return ops.rglru_scan(a.contiguous(), b.contiguous())


def rglru_train(params, x, cfg):
    """x: (B, S, d) -> (B, S, d)."""
    gate = _gelu(x @ params["w_gate_branch"])
    u = x @ params["w_in"]
    u = _causal_conv(u, params["conv"])
    a, b = _gates(params, u)
    h = rglru_scan(a, b).to(x.dtype)
    return (h * gate) @ params["w_out"]


def rglru_decode(params, x, cache, cfg):
    """One token. cache = {"h": (B, inner) f32, "conv": (B, W-1, inner)}."""
    xt = x[:, 0]
    gate = _gelu(xt @ params["w_gate_branch"])
    pre = xt @ params["w_in"]
    hist = torch.cat([cache["conv"], pre[:, None]], dim=1)
    u = (hist * params["conv"][None]).sum(dim=1)
    a, b = _gates(params, u)
    h = a * cache["h"] + b
    out = ((h.to(x.dtype) * gate) @ params["w_out"])[:, None]
    return out, {"h": h, "conv": hist[:, 1:]}
