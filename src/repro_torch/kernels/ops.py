"""Device dispatch over the port's kernels.

The route follows the tensor's device, nothing else: a CUDA tensor
launches the hand-written kernel (or the wrapper raises — there is no
fallback), a CPU tensor runs the kernel's plain PyTorch version from
``kernels.ref``.  No environment variable changes the route.

Where autograd records the call (grad mode on, an operand that requires
a gradient), ``moe_gemm``, ``flash_attention``, ``rglru_scan`` and
``ssd_scan`` go through ``torch.autograd.Function``s whose backward takes
the same route: ``moe_gemm`` launches the kernel on transposed copies,
the other three their backward kernels (``kernels.ref``'s plain backward
on the CPU).  A call autograd does not record runs the forward alone, as
it always did.
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


def _recorded(*ts: torch.Tensor) -> bool:
    """Does autograd record a call on these operands?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _moe_gemm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    route = kernel_route(buf)
    with annotate(f"moe_gemm[{route}]"):
        if route == "cuda":
            return _mg.moe_gemm(buf, w)
        _mg.check_operands(buf, w)
        return ref.moe_gemm_ref(buf, w)


class _MoeGemm(torch.autograd.Function):
    """out = buf @ w per expert, with the backward as two more grouped
    products on contiguous transposed copies (as ``core.experts.
    _GroupedMLP`` does): d_buf = g w^T, d_w = buf^T g."""

    @staticmethod
    def forward(ctx, buf, w):
        ctx.save_for_backward(buf, w)
        return _moe_gemm(buf, w)

    @staticmethod
    def backward(ctx, g):
        buf, w = ctx.saved_tensors
        g = g.contiguous()
        d_buf = (_moe_gemm(g, w.transpose(1, 2).contiguous())
                 if ctx.needs_input_grad[0] else None)
        d_w = (_moe_gemm(buf.transpose(1, 2).contiguous(), g)
               if ctx.needs_input_grad[1] else None)
        return d_buf, d_w


def moe_gemm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """out[e] = buf[e] @ w[e]; buf (E, C, d), w (E, d, f) -> (E, C, f).
    Differentiable: one launch forward, one for each operand's gradient
    in the backward."""
    if _recorded(buf, w):
        return _MoeGemm.apply(buf, w)
    return _moe_gemm(buf, w)


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


def _flash(q, k, v, kw, return_lse):
    route = kernel_route(q)
    with annotate(f"flash_attention[{route}]"):
        if route == "cuda":
            return _fa.flash_attention(q, k, v, return_lse=return_lse, **kw)
        _fa.check_operands(q, k, v, window=kw["window"],
                           q_offset=kw["q_offset"])
        return ref.attention_ref(q, k, v, return_lse=return_lse, **kw)


class _FlashAttention(torch.autograd.Function):
    """Attention whose forward also writes the rows' log-sum-exp, and
    whose backward is ``flash_attention_bwd`` (``attention_bwd_ref`` on
    the CPU) from the saved q, k, v, o and lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)
        out, lse = _flash(q, k, v, kw, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        route = kernel_route(q)
        with annotate(f"flash_attention_bwd[{route}]"):
            if route == "cuda":
                dq, dk, dv = _fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                     **ctx.kw)
            else:
                dq, dk, dv = ref.attention_bwd_ref(q, k, v, o, do, lse,
                                                   **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention in the model layout: q (B, Sq, H, D),
    k/v (B, Sk, KH, D) -> (B, Sq, H, D) in q's dtype.  Query row i sits at
    absolute position ``q_offset + i``; ``window`` > 0 keeps the last
    ``window`` keys (inclusive of self).  Differentiable in q, k and v
    (float32): the forward then also writes the log-sum-exp, and the
    backward is one more kernel call."""
    if _recorded(q, k, v):
        return _FlashAttention.apply(q, k, v, causal, window, softcap,
                                     q_offset)
    return _flash(q, k, v, dict(causal=causal, window=window,
                                softcap=softcap, q_offset=q_offset), False)


def _rglru(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    route = kernel_route(a)
    with annotate(f"rglru_scan[{route}]"):
        if route == "cuda":
            return _rg.rglru_scan(a, b)
        _rg.check_operands(a, b)
        return ref.rglru_scan_ref(a, b)


class _RGLRUScan(torch.autograd.Function):
    """The scan with the reverse scan as its backward, from the saved a
    and the output h."""

    @staticmethod
    def forward(ctx, a, b):
        h = _rglru(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        dh = dh.contiguous()
        route = kernel_route(a)
        with annotate(f"rglru_scan_bwd[{route}]"):
            if route == "cuda":
                return _rg.rglru_scan_bwd(a, h, dh)
            return ref.rglru_scan_bwd_ref(a, h, dh)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h = 0; a, b (B, S, C)
    float32 -> h (B, S, C) float32.  Differentiable in a and b."""
    if _recorded(a, b):
        return _RGLRUScan.apply(a, b)
    return _rglru(a, b)


def _ssd(x, dt, A, Bmat, Cmat, chunk):
    route = kernel_route(x)
    with annotate(f"ssd_scan[{route}]"):
        if route == "cuda":
            return _ss.ssd_scan(x, dt, A, Bmat, Cmat, chunk)
        _ss.check_operands(x, dt, A, Bmat, Cmat, chunk)
        B, _, H, P = x.shape
        state0 = torch.zeros((B, H, P, Bmat.shape[-1]), dtype=torch.float32,
                             device=x.device)
        return ref.ssd_scan_ref(x, dt, A, Bmat, Cmat, state0)[0]


class _SSDScan(torch.autograd.Function):
    """The scan whose backward is ``ssd_scan_bwd`` (``ssd_scan_bwd_ref``
    on the CPU) from the five saved operands: the chunk states are
    recomputed there, not kept."""

    @staticmethod
    def forward(ctx, x, dt, A, Bmat, Cmat, chunk):
        ctx.save_for_backward(x, dt, A, Bmat, Cmat)
        ctx.chunk = chunk
        return _ssd(x, dt, A, Bmat, Cmat, chunk)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bmat, Cmat = ctx.saved_tensors
        route = kernel_route(x)
        with annotate(f"ssd_scan_bwd[{route}]"):
            if route == "cuda":
                grads = _ss.ssd_scan_bwd(x, dt, A, Bmat, Cmat, dy, ctx.chunk)
            else:
                grads = ref.ssd_scan_bwd_ref(x, dt, A, Bmat, Cmat, dy,
                                             ctx.chunk)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bmat: torch.Tensor, Cmat: torch.Tensor,
             chunk: int = 128) -> torch.Tensor:
    """Mamba-2 SSD scan from a zero state: x (B, S, H, P), dt (B, S, H),
    A (H,), Bmat/Cmat (B, S, N), float32 -> y (B, S, H, P) float32.  S
    must be a multiple of min(chunk, S).  Differentiable in all five
    operands: the backward is one more kernel call, which recomputes the
    forward's chunk states from the saved operands."""
    if _recorded(x, dt, A, Bmat, Cmat):
        return _SSDScan.apply(x, dt, A, Bmat, Cmat, chunk)
    return _ssd(x, dt, A, Bmat, Cmat, chunk)


# name -> (wrapper module, its counter)
_KERNELS = {"moe_gemm": (_mg, "launches"),
            "redundancy_vote": (_rv, "launches"),
            "audit_mlp": (_am, "launches"),
            "flash_attention": (_fa, "launches"),
            "flash_attention_bwd": (_fa, "bwd_launches"),
            "rglru_scan": (_rg, "launches"),
            "rglru_scan_bwd": (_rg, "bwd_launches"),
            "ssd_scan": (_ss, "launches"),
            "ssd_scan_bwd": (_ss, "bwd_launches")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _KERNELS.values():
        setattr(mod, attr, 0)
