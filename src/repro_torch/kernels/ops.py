"""Device dispatch over the port's kernels.

The route follows the tensor's device, nothing else: a CUDA tensor
launches the hand-written kernel (or the wrapper raises — there is no
fallback), a CPU tensor runs the kernel's plain PyTorch version from
``kernels.ref``, and a meta tensor (only the dry run makes them,
``launch.dryrun``) gets empty meta outputs of the kernel's shapes: it
runs neither the kernel nor the plain version and computes nothing.  Any
other device raises.  No environment variable changes the route.

Every call books its kernel's work with ``launch.opanalysis`` (FLOPs by
formula: 2·E·C·d·f for ``moe_gemm``; 4·B·H·D per (query, key) pair the
mask keeps for attention, 10 for its backward's five products; the
chunked form's products for the SSD scan and its gradient; 2·S·C·(d·h +
h·o) for ``audit_mlp``; none for the vote and the RG-LRU scan) and pauses
the library counting inside itself, so a step counts the same on every
route.  The launch counters are the kernels' own, and the meta route
leaves them alone.

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
from repro_torch.launch import opanalysis
from repro_torch.obs import annotate

__all__ = ["resolve_device", "kernel_route", "moe_gemm",
           "redundancy_vote_masked", "audit_mlp", "flash_attention",
           "rglru_scan", "ssd_scan", "launch_counts",
           "reset_launch_counts", "attention_pairs", "ssd_flops"]


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
    """The path a tensor on this device takes: "cuda", "plain" (CPU) or
    "meta" (shapes only)."""
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    if t.device.type == "meta":
        return "meta"
    raise ValueError(f"no kernel route for device {t.device}")


def _book(name: str, flops, dtype: torch.dtype) -> None:
    """Book one call of kernel ``name`` while a count is open;
    ``flops()`` (its work, from the operands' shapes) is only evaluated
    then."""
    if opanalysis.counting():
        opanalysis.book_kernel(name, flops(), dtype)


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int,
                    q_offset: int = 0) -> int:
    """The (query, key) pairs the masks keep: query i at absolute
    position q_offset + i sees keys (p - window, p] (all when window is
    0), and none after p when causal."""
    q = torch.arange(q_offset, q_offset + Sq, dtype=torch.int64)
    lo = (q - window + 1).clamp(min=0) if window else torch.zeros_like(q)
    hi = q.clamp(max=Sk - 1) if causal else torch.full_like(q, Sk - 1)
    return int((hi - lo + 1).clamp(min=0).sum())


def ssd_flops(x: torch.Tensor, Bmat: torch.Tensor, chunk: int,
              backward: bool) -> int:
    """The SSD scan's (or with ``backward`` its gradient's) FLOPs, from
    the operands' shapes: the chunked form's products.  Forward, per (b, chunk): the
    scores times x per head and C B^T once (causal pairs); per (b, h):
    C state^T where the state is not zero and the state update where a
    later chunk reads it.  Backward: the recomputed C B^T and chunk
    states, the local gradient states, per (chunk, head) C s^T, B G^T,
    (CB o L)^T dy and dy x^T, and the head sums dCB, dC and dB."""
    B, S, H, P = x.shape
    N = Bmat.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    pairs = Q * (Q + 1) // 2
    if backward:
        return 2 * B * (6 * H * (nc - 1) * Q * N * P
                        + 2 * H * nc * pairs * P + 3 * nc * pairs * N)
    return 2 * B * (nc * (H * pairs * P + pairs * N)
                    + H * (nc - 1) * 2 * Q * N * P)


def _recorded(*ts: torch.Tensor) -> bool:
    """Does autograd record a call on these operands?"""
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _moe_gemm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    route = kernel_route(buf)
    _book("moe_gemm", lambda: 2 * buf.shape[:3].numel() * w.shape[-1],
          buf.dtype)
    with annotate(f"moe_gemm[{route}]"), opanalysis.paused():
        if route == "cuda":
            return _mg.moe_gemm(buf, w)
        _mg.check_operands(buf, w)
        if route == "meta":
            return buf.new_empty(buf.shape[:2] + w.shape[-1:])
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
        _book("redundancy_vote", lambda: 0, pub.dtype)
        with annotate(f"redundancy_vote[{route}]"), opanalysis.paused():
            if route == "cuda":
                trusted, support, flags, winner = _rv.redundancy_vote_masked(
                    pub, active, atol)
            elif route == "meta":
                E, M = pub.shape[:2]
                trusted = pub.new_empty((E,) + tuple(pub.shape[2:]))
                support, winner = (pub.new_empty((E,), dtype=torch.int32)
                                   for _ in range(2))
                flags = pub.new_empty((E, M), dtype=torch.int32)
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
    w2 = params["w2"]
    _book("audit_mlp", lambda: 2 * x.shape[:2].numel() * w2.shape[1] * (
        x.shape[2] + w2.shape[2]), x.dtype)
    with annotate(f"audit_mlp[{route}]"), opanalysis.paused():
        if route == "cuda":
            return _am.audit_mlp(params, x, gid)
        _am.check_operands(params, x, gid)
        if route == "meta":
            return x.new_empty(x.shape[:2] + w2.shape[-1:])
        return ref.audit_mlp_ref(params, x, gid)


def _attention_flops(q, k, kw, per_pair: int) -> int:
    B, Sq, H, D = q.shape
    return per_pair * B * H * D * attention_pairs(
        Sq, k.shape[1], kw["causal"], kw["window"], kw["q_offset"])


def _flash(q, k, v, kw, return_lse):
    route = kernel_route(q)
    _book("flash_attention", lambda: _attention_flops(q, k, kw, 4), q.dtype)
    with annotate(f"flash_attention[{route}]"), opanalysis.paused():
        if route == "cuda":
            return _fa.flash_attention(q, k, v, return_lse=return_lse, **kw)
        _fa.check_operands(q, k, v, window=kw["window"],
                           q_offset=kw["q_offset"])
        if route == "meta":
            B, Sq, H, _ = q.shape
            out = torch.empty_like(q)
            lse = q.new_empty((B, H, Sq), dtype=torch.float32)
            return (out, lse) if return_lse else out
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
        _book("flash_attention_bwd",
              lambda: _attention_flops(q, k, ctx.kw, 10), q.dtype)
        with annotate(f"flash_attention_bwd[{route}]"), opanalysis.paused():
            if route == "cuda":
                dq, dk, dv = _fa.flash_attention_bwd(q, k, v, o, do, lse,
                                                     **ctx.kw)
            elif route == "meta":
                dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
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
    _book("rglru_scan", lambda: 0, a.dtype)
    with annotate(f"rglru_scan[{route}]"), opanalysis.paused():
        if route == "cuda":
            return _rg.rglru_scan(a, b)
        _rg.check_operands(a, b)
        if route == "meta":
            return torch.empty_like(a)
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
        _book("rglru_scan_bwd", lambda: 0, a.dtype)
        with annotate(f"rglru_scan_bwd[{route}]"), opanalysis.paused():
            if route == "cuda":
                return _rg.rglru_scan_bwd(a, h, dh)
            if route == "meta":
                return torch.empty_like(a), torch.empty_like(a)
            return ref.rglru_scan_bwd_ref(a, h, dh)


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 from h = 0; a, b (B, S, C)
    float32 -> h (B, S, C) float32.  Differentiable in a and b."""
    if _recorded(a, b):
        return _RGLRUScan.apply(a, b)
    return _rglru(a, b)


def _ssd(x, dt, A, Bmat, Cmat, chunk):
    route = kernel_route(x)
    _book("ssd_scan", lambda: ssd_flops(x, Bmat, chunk, False), x.dtype)
    with annotate(f"ssd_scan[{route}]"), opanalysis.paused():
        if route == "cuda":
            return _ss.ssd_scan(x, dt, A, Bmat, Cmat, chunk)
        _ss.check_operands(x, dt, A, Bmat, Cmat, chunk)
        if route == "meta":
            return x.new_empty(x.shape, dtype=torch.float32)
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
        _book("ssd_scan_bwd", lambda: ssd_flops(x, Bmat, ctx.chunk, True),
              x.dtype)
        with annotate(f"ssd_scan_bwd[{route}]"), opanalysis.paused():
            if route == "cuda":
                grads = _ss.ssd_scan_bwd(x, dt, A, Bmat, Cmat, dy, ctx.chunk)
            elif route == "meta":
                grads = tuple(torch.empty_like(t)
                              for t in (x, dt, A, Bmat, Cmat))
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
