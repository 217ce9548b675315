"""RG-LRU linear recurrence: the wrapper of the CUDA kernel in
``csrc/rglru_scan.cu`` (the port of
``repro.kernels.rglru_scan.rglru_scan_pallas``).

``rglru_scan(a, b)`` computes ``h_t = a_t * h_{t-1} + b_t`` along axis 1
from h = 0: a, b (B, S, C) float32 -> h (B, S, C) float32, each channel
independent.  It takes CUDA tensors only and launches the kernel or
raises; ``kernels.ops.rglru_scan`` is the device dispatch that gives CPU
tensors the plain version.

The kernel is a chunked scan over chunks of ``CHUNK`` steps: one call is
two CUDA launches (the chunk summaries, then the scan that folds them in
chunk order and re-runs each chunk), or one where S <= ``CHUNK``, over a
``torch.empty`` scratch of 2 x (B, ceil(S / CHUNK) - 1, C) floats (1.3 MB
at recurrentgemma-2b's prefill).

``rglru_scan_bwd(a, h, dh)`` is the gradient, the same chunked design run
backwards in time: with c_t = dh_t + a_{t+1} c_{t+1} (a_S = 0), it
returns (da, db) with db_t = c_t and da_t = c_t h_{t-1}, from the saved a
and the forward's h; two launches (one where S <= ``CHUNK``) over the
same scratch.  ``launches`` and ``bwd_launches`` count calls.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# the kernel's chunk length (kChunk in csrc/rglru_scan.cu, which refuses
# any other); with S it fixes the association of every product and sum
CHUNK = 64

# calls that launched the forward and the backward kernels since the last
# reset (ops.reset_launch_counts)
launches = 0
bwd_launches = 0


def check_operands(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"rglru_scan wants a and b of one (B, S, C) shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"rglru_scan takes float32 a and b, got {a.dtype} "
                        f"and {b.dtype}")
    if a.device != b.device:
        raise ValueError(f"rglru_scan operands on {a.device} and {b.device}")


def _check_launch(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    """The checks both launches share; returns the number of chunks."""
    check_operands(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"{what} launches on CUDA tensors, got {a.device}")
    if torch.cuda.get_device_capability(a.device) != (9, 0):
        raise RuntimeError(f"{what} is built for sm_90a (Hopper); device "
                           f"{torch.cuda.get_device_name(a.device)} is not")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{what} needs contiguous operands")
    B, S, _ = a.shape
    nc = -(-S // CHUNK)
    if B > 65535 or nc > 65535:
        raise ValueError(f"{what}: batch {B} or {nc} chunks of {CHUNK} "
                         f"exceed the grid's limit of 65535")
    return nc


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors."""
    global launches
    nc = _check_launch(a, b, "rglru_scan")
    B, S, C = a.shape
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    # the chunk summaries: products of a and end states from h = 0
    summ = torch.empty((2, B, nc - 1, C), dtype=torch.float32,
                       device=a.device)
    lib = build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.rglru_scan_f32(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  summ[0].data_ptr(), summ[1].data_ptr(),
                                  B, S, C, CHUNK, stream)
    build.check(code, "rglru_scan")
    launches += 1
    return out


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor,
                   dh: torch.Tensor):
    """Launch the reverse scan on CUDA tensors: (da, db) (B, S, C)."""
    global bwd_launches
    nc = _check_launch(a, h, "rglru_scan_bwd")
    check_operands(a, dh)
    if not dh.is_contiguous():
        raise ValueError("rglru_scan_bwd needs contiguous operands")
    B, S, C = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    # the chunk summaries, now of the reverse recurrence from c = 0
    summ = torch.empty((2, B, nc - 1, C), dtype=torch.float32,
                       device=a.device)
    lib = build.library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        code = lib.rglru_scan_bwd_f32(a.data_ptr(), h.data_ptr(),
                                      dh.data_ptr(), da.data_ptr(),
                                      db.data_ptr(), summ[0].data_ptr(),
                                      summ[1].data_ptr(), B, S, C, CHUNK,
                                      stream)
    build.check(code, "rglru_scan_bwd")
    bwd_launches += 1
    return da, db
