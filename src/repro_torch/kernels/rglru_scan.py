"""RG-LRU linear recurrence: the wrapper of the CUDA kernel in
``csrc/rglru_scan.cu`` (the port of
``repro.kernels.rglru_scan.rglru_scan_pallas``).

``rglru_scan(a, b)`` computes ``h_t = a_t * h_{t-1} + b_t`` along axis 1
from h = 0: a, b (B, S, C) float32 -> h (B, S, C) float32, each channel
independent.  It takes CUDA tensors only and launches the kernel or
raises; ``kernels.ops.rglru_scan`` is the device dispatch that gives CPU
tensors the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0


def check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan wants a and b of one (B, S, C) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rglru_scan takes float32 a and b, got {a.dtype} "
                        f"and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"rglru_scan operands on {a.device} and {b.device}")


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors."""
    global launches
    check_operands(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan launches on CUDA tensors, got "
                         f"{a.device}")
    if torch.cuda.get_device_capability(a.device) != (9, 0):
        raise RuntimeError("rglru_scan is built for sm_90a (Hopper); device "
                           f"{torch.cuda.get_device_name(a.device)} is not")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan needs contiguous a and b")
    B, S, C = a.shape
    if B > 65535:
        raise ValueError(f"rglru_scan: batch {B} exceeds the grid's y "
                         f"limit of 65535")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    lib = build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.rglru_scan_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  B, S, C, stream)
    build.check(code, "rglru_scan")
    launches += 1
    return out
