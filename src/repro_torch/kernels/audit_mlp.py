"""Fused grouped gathered two-layer MLP: the wrapper of the CUDA kernel in
``csrc/audit_mlp.cu`` (the port of ``repro.kernels.audit_gemm.audit_mlp``).

``audit_mlp(params, x, gid)`` computes ``out[s] = relu(x[s] @ w1[g] +
b1[g]) @ w2[g] + b2[g]`` with ``g = gid[s]``: x (S, C, d) float32, gid
(S,) integer, and a stacked bank ``w1 (E, d, h)``, ``b1 (E, h)``,
``w2 (E, h, o)``, ``b2 (E, o)`` float32 -> (S, C, o) float32.  A row's
bytes depend on its own inputs only (not on S, its slot, the bank it is
gathered from, or C), which is what lets the optimistic framework's
executor and auditors hash the same leaves.  It takes CUDA tensors only
and launches the kernel or raises; ``kernels.ops.audit_mlp`` is the
device dispatch that gives CPU tensors the plain version.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build

KEYS = ("w1", "b1", "w2", "b2")
# the widest hidden layer the wrapper takes: the kernel streams the hidden
# units in slices of 256 and needs no more shared memory for a wider one,
# and this is the width the card tests hold it at
MAX_HIDDEN = 3072

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0


def check_operands(params: Dict[str, torch.Tensor], x: torch.Tensor,
                   gid: torch.Tensor) -> None:
    w1, b1, w2, b2 = (params[k] for k in KEYS)
    if x.dim() != 3 or gid.dim() != 1 or gid.shape[0] != x.shape[0]:
        raise ValueError(f"audit_mlp wants x (S, C, d) and gid (S,), got "
                         f"{tuple(x.shape)} and {tuple(gid.shape)}")
    E, d, h = w1.shape
    o = w2.shape[-1]
    want = {"w1": (E, x.shape[2], h), "b1": (E, h), "w2": (E, h, o),
            "b2": (E, o)}
    for k, shape in want.items():
        if tuple(params[k].shape) != shape:
            raise ValueError(f"audit_mlp: {k} is {tuple(params[k].shape)}, "
                             f"wanted {shape} for x {tuple(x.shape)}")
    if any(t.dtype != torch.float32 for t in (x, w1, b1, w2, b2)):
        raise TypeError("audit_mlp takes float32 x and bank")
    if gid.dtype.is_floating_point or gid.dtype == torch.bool:
        raise TypeError(f"audit_mlp takes integer gid, got {gid.dtype}")
    if any(t.device != x.device for t in (gid, w1, b1, w2, b2)):
        raise ValueError("audit_mlp operands on different devices")


def audit_mlp(params: Dict[str, torch.Tensor], x: torch.Tensor,
              gid: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors."""
    global launches
    check_operands(params, x, gid)
    if x.device.type != "cuda":
        raise ValueError(f"audit_mlp launches on CUDA tensors, got "
                         f"{x.device}")
    if torch.cuda.get_device_capability(x.device) != (9, 0):
        raise RuntimeError("audit_mlp is built for sm_90a (Hopper); device "
                           f"{torch.cuda.get_device_name(x.device)} is not")
    w1, b1, w2, b2 = (params[k] for k in KEYS)
    if not all(t.is_contiguous() for t in (x, w1, b1, w2, b2)):
        raise ValueError("audit_mlp needs contiguous x and bank")
    S, C, d = x.shape
    E, _, h = w1.shape
    o = w2.shape[-1]
    if h > MAX_HIDDEN:
        raise ValueError(f"audit_mlp: hidden width {h} exceeds {MAX_HIDDEN}")
    if S > 65535:
        raise ValueError(f"audit_mlp: {S} samples exceed the grid's y "
                         f"limit of 65535")
    out = torch.empty((S, C, o), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    g = gid.to(torch.int32).contiguous()
    if not torch.cuda.is_current_stream_capturing():
        # one device->host read; a graph capture cannot read, and there
        # the kernel's own guard writes NaN rows for a bad id instead
        lo, hi = (int(v) for v in torch.aminmax(g))
        if lo < 0 or hi >= E:
            raise IndexError(f"audit_mlp: gid in [{lo}, {hi}] for a bank "
                             f"of {E} experts")
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.audit_mlp_f32(
            x.data_ptr(), g.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), S, C, d, h, o, E,
            stream)
    build.check(code, "audit_mlp")
    launches += 1
    return out
