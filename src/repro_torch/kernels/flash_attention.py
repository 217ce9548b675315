"""Online-softmax attention: the wrapper of the CUDA kernel in
``csrc/flash_attention.cu`` (the port of
``repro.kernels.flash_attention.flash_attention``).

``flash_attention(q, k, v, causal=, window=, softcap=, q_offset=)`` takes
the model layout, q (B, Sq, H, D) and k, v (B, Sk, KH, D) with H a
multiple of KH, float32 or bfloat16, and returns (B, Sq, H, D) in the
input dtype.  q, k and v may be strided views as long as the last
dimension is contiguous.  Ragged Sq and Sk are taken (masked in the
kernel).  With ``return_lse`` it also returns each row's log-sum-exp,
(B, H, Sq) float32, written only then; ``o`` has the same bits either
way.

``flash_attention_bwd(q, k, v, o, do, lse, ...)`` is the backward
(``csrc/flash_attention_bwd.cu``): (dq, dk, dv), float32 only, two
CUDA launches a call (the row sums rowsum(dO o), then dK, dV and dQ per
key tile and query head) and, under GQA, a third that sums each group's
heads.  ``launches`` and ``bwd_launches`` count calls.

Both take CUDA tensors only and launch the kernel or raise;
``kernels.ops.flash_attention`` is the device dispatch that gives CPU
tensors the plain versions and makes the call differentiable.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPE = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 48, 64, 128, 256)     # the kernel's compiled head dims

# kernel launches (forward calls) and backward calls since the last reset
# (ops.reset_launch_counts)
launches = 0
bwd_launches = 0


def check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   window: int = 0, q_offset: int = 0) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"flash_attention wants q (B, Sq, H, D) and k, v "
                         f"(B, Sk, KH, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention shape mismatch: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    KH = k.shape[2]
    if KH == 0 or H % KH:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {KH} kv heads")
    if k.shape[1] == 0:
        raise ValueError("flash_attention needs at least one key")
    if q.dtype != k.dtype or q.dtype != v.dtype or q.dtype not in _DTYPE:
        raise TypeError(f"flash_attention takes float32 or bfloat16 "
                        f"operands of one dtype, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention operands on different devices")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window {window} and q_offset "
                         f"{q_offset} must be >= 0")


def _check_device(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} launches on CUDA tensors, got {t.device}")
    if torch.cuda.get_device_capability(t.device) != (9, 0):
        raise RuntimeError(f"{what} is built for sm_90a (Hopper); device "
                           f"{torch.cuda.get_device_name(t.device)} is not")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, q_offset: int = 0,
                    return_lse: bool = False):
    """Launch the CUDA kernel on CUDA tensors: out, or (out, lse)."""
    global launches
    check_operands(q, k, v, window=window, q_offset=q_offset)
    _check_device(q, "flash_attention")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(3) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention needs the head dim contiguous")
    if B * H >= 2 ** 31 or (Sq + 63) // 64 > 65535:    # 64-row q tiles
        raise ValueError(f"flash_attention: B*H={B * H} or Sq={Sq} over "
                         f"the grid's limits")
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    strides = (ctypes.c_longlong * 9)(*[t.stride(i) for t in (q, k, v)
                                        for i in (0, 1, 2)])
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None, strides,
            _DTYPE[q.dtype], B, Sq, Sk, H, KH, D, int(causal), int(window),
            int(q_offset), D ** -0.5, float(softcap or 0.0), stream)
    build.check(code, "flash_attention")
    launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, q_offset: int = 0):
    """Launch the backward kernels on CUDA tensors: (dq, dk, dv), float32,
    contiguous, in q's, k's and v's shapes.  o and lse are the forward's
    (``flash_attention(..., return_lse=True)``); operands that are not
    contiguous are copied first."""
    global bwd_launches
    check_operands(q, k, v, window=window, q_offset=q_offset)
    _check_device(q, "flash_attention_bwd")
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    if q.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd takes float32 operands, got "
                        f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {D} not in "
                         f"{HEAD_DIMS}")
    if o.shape != q.shape or do.shape != q.shape or \
            lse.shape != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)}, do "
                         f"{tuple(do.shape)} and lse {tuple(lse.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if any(t.dtype != torch.float32 or t.device != q.device
           for t in (o, do, lse)):
        raise TypeError("flash_attention_bwd: o, do and lse must be float32 "
                        "on q's device")
    # one-dimensional grids of (tile, b, query head), tiles of 16 rows at
    # the least
    if (max(Sq, Sk) + 15) // 16 * B * H >= 2 ** 31:
        raise ValueError(f"flash_attention_bwd: B={B}, H={H}, Sq={Sq} or "
                         f"Sk={Sk} over the grid's limits")
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    # under GQA each query head's dK and dV, summed in head order after
    parts = [torch.empty((B, Sk, H, D), dtype=torch.float32,
                         device=q.device) for _ in range(2)] \
        if H > KH else [None, None]
    # a semaphore per (b, head, 32-row query tile): dQ's order of sums
    sem = torch.empty(B * H * ((Sq + 31) // 32), dtype=torch.int32,
                      device=q.device)
    lib = build.library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(),
            *[t.data_ptr() if t is not None else None for t in parts],
            sem.data_ptr(),
            B, Sq, Sk, H, KH, D, int(causal),
            int(window), int(q_offset), D ** -0.5, float(softcap or 0.0),
            stream)
    build.check(code, "flash_attention_bwd")
    bwd_launches += 1
    return dq, dk, dv
