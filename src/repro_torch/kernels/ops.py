"""Device dispatch over the port's kernels.

The route follows the tensor's device, nothing else: a CUDA tensor
launches the hand-written kernel (or the wrapper raises — there is no
fallback), a CPU tensor runs the kernel's plain PyTorch version from
``kernels.ref``.  No environment variable changes the route.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import audit_mlp as _am
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gemm as _mg
from repro_torch.kernels import redundancy_vote as _rv
from repro_torch.kernels import rglru_scan as _rg
from repro_torch.kernels import ssd_scan as _ss
from repro_torch.kernels import ref
from repro_torch.obs import annotate

__all__ = ["resolve_device", "kernel_route", "moe_gemm",
           "redundancy_vote_masked", "audit_mlp", "flash_attention",
           "rglru_scan", "ssd_scan", "launch_counts",
           "reset_launch_counts"]


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


def kernel_route(t: torch.Tensor) -> str:
    """The path a tensor on this device takes: "cuda" or "plain"."""
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel route for device {t.device}")


def moe_gemm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[e] = buf[e] @ w[e]; buf (E, C, d), w (E, d, f) -> (E, C, f)."""
    route = kernel_route(buf)
    with annotate(f"moe_gemm[{route}]"):
        if route == "cuda":
            return _mg.moe_gemm(buf, w)
        _mg.check_operands(buf, w)
        return ref.moe_gemm_ref(buf, w)


class _Vote(torch.autograd.Function):
    """The vote with the gradient of JAX's ``take_along_axis`` in
    ``redundancy_vote_masked_ref``: the cotangent of trusted[e] lands on
    pub[e, winner[e]], zeros elsewhere; support and flags carry none."""

    @staticmethod
    def forward(ctx, pub, active, atol):
        route = kernel_route(pub)
        with annotate(f"redundancy_vote[{route}]"):
            if route == "cuda":
                trusted, support, flags, winner = _rv.redundancy_vote_masked(
                    pub, active, atol)
            else:
                trusted, support, flags, winner = \
                    ref.redundancy_vote_winner_ref(pub, active, atol)
        ctx.mark_non_differentiable(support, flags)
        ctx.winner, ctx.pub_shape = winner, pub.shape
        return trusted, support, flags

    @staticmethod
    def backward(ctx, g_trusted, _g_support, _g_flags):
        winner = ctx.winner.long()
        grad = g_trusted.new_zeros(ctx.pub_shape)
        grad[torch.arange(len(winner), device=winner.device), winner] = \
            g_trusted
        return grad, None, None


def redundancy_vote_masked(pub: torch.Tensor, active: torch.Tensor,
                           atol: float = 0.0):
    """Majority vote over M published copies restricted to the ``active``
    electorate (paper Step 3, §VI-D).  pub (E, M, T) -> (trusted (E, T),
    support (E,) int32, flags (E, M) int32).  Differentiable in pub:
    trusted's gradient goes to the elected copies."""
    _rv.check_operands(pub, active)
    return _Vote.apply(pub, active, atol)


def audit_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
              gid: torch.Tensor) -> torch.Tensor:
    """Batched audit recompute: out[s] = mlp(params[gid[s]], x[s]).
    params: stacked {w1, b1, w2, b2}; x (S, C, d); gid (S,) -> (S, C, o).
    Both routes give a row bytes that depend on that row alone."""
    route = kernel_route(x)
    with annotate(f"audit_mlp[{route}]"):
        if route == "cuda":
            return _am.audit_mlp(params, x, gid)
        _am.check_operands(params, x, gid)
        return ref.audit_mlp_ref(params, x, gid)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention in the model layout: q (B, Sq, H, D),
    k/v (B, Sk, KH, D) -> (B, Sq, H, D) in q's dtype.  Query row i sits at
    absolute position ``q_offset + i``; ``window`` > 0 keeps the last
    ``window`` keys (inclusive of self)."""
    route = kernel_route(q)
    with annotate(f"flash_attention[{route}]"):
        if route == "cuda":
            return _fa.flash_attention(q, k, v, causal=causal, window=window,
                                       softcap=softcap, q_offset=q_offset)
        _fa.check_operands(q, k, v, window=window, q_offset=q_offset)
        return ref.attention_ref(q, k, v, causal=causal, window=window,
                                 softcap=softcap, q_offset=q_offset)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h = 0; a, b (B, S, C)
    float32 -> h (B, S, C) float32."""
    route = kernel_route(a)
    with annotate(f"rglru_scan[{route}]"):
        if route == "cuda":
            return _rg.rglru_scan(a, b)
        _rg.check_operands(a, b)
        return ref.rglru_scan_ref(a, b)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor,
             chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD scan from a zero state: x (B, S, H, P), dt (B, S, H),
    A (H,), Bmat/Cmat (B, S, N), float32 -> y (B, S, H, P) float32.  S
    must be a multiple of min(chunk, S)."""
    route = kernel_route(x)
    with annotate(f"ssd_scan[{route}]"):
        if route == "cuda":
            return _ss.ssd_scan(x, dt, A, Bmat, Cmat, chunk)
        _ss.check_operands(x, dt, A, Bmat, Cmat, chunk)
        B, _, H, P = x.shape
        state0 = torch.zeros((B, H, P, Bmat.shape[-1]), dtype=torch.float32,
                             device=x.device)
        return ref.ssd_scan_ref(x, dt, A, Bmat, Cmat, state0)[0]


_KERNELS = {"moe_gemm": _mg, "redundancy_vote": _rv, "audit_mlp": _am,
            "flash_attention": _fa, "rglru_scan": _rg, "ssd_scan": _ss}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
