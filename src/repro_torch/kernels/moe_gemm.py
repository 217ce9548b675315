"""Grouped expert GEMM: the wrapper of the CUDA kernel in
``csrc/moe_gemm.cu`` (the port of ``repro.kernels.moe_gemm.moe_gemm``).

``moe_gemm(buf, w)`` computes ``out[e] = buf[e] @ w[e]`` for every
expert: buf (E, C, d), w (E, d, f) -> (E, C, f), fp32 accumulation,
output in the input dtype (float32 or bfloat16).  It takes CUDA tensors
only and launches the kernel or raises; ``kernels.ops.moe_gemm`` is the
device dispatch that gives CPU tensors the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_ENTRY = {torch.float32: "moe_gemm_f32", torch.bfloat16: "moe_gemm_bf16"}

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0


def check_operands(buf: torch.Tensor, w: torch.Tensor) -> None:
    if buf.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_gemm wants buf (E, C, d) and w (E, d, f), "
                         f"got {tuple(buf.shape)} and {tuple(w.shape)}")
    if buf.shape[0] != w.shape[0] or buf.shape[2] != w.shape[1]:
        raise ValueError(f"moe_gemm shape mismatch: buf {tuple(buf.shape)}"
                         f" x w {tuple(w.shape)}")
    if buf.dtype != w.dtype or buf.dtype not in _ENTRY:
        raise TypeError(f"moe_gemm takes float32 or bfloat16 operands of "
                        f"one dtype, got {buf.dtype} and {w.dtype}")
    if buf.device != w.device:
        raise ValueError(f"moe_gemm operands on {buf.device} and {w.device}")
    if buf.shape[0] > 65535:
        raise ValueError(f"moe_gemm: {buf.shape[0]} experts exceed the "
                         f"grid's z limit of 65535")


def moe_gemm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors."""
    global launches
    check_operands(buf, w)
    if buf.device.type != "cuda":
        raise ValueError(f"moe_gemm launches on CUDA tensors, got "
                         f"{buf.device}")
    if torch.cuda.get_device_capability(buf.device) != (9, 0):
        raise RuntimeError("moe_gemm is built for sm_90a (Hopper); device "
                           f"{torch.cuda.get_device_name(buf.device)} is not")
    if not (buf.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gemm needs contiguous operands")
    E, C, D = buf.shape
    F = w.shape[2]
    out = torch.empty((E, C, F), dtype=buf.dtype, device=buf.device)
    if out.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        code = getattr(lib, _ENTRY[buf.dtype])(
            buf.data_ptr(), w.data_ptr(), out.data_ptr(), E, C, D, F, stream)
    build.check(code, "moe_gemm")
    launches += 1
    return out

