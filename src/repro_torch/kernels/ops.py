"""Device dispatch over the port's kernels.

The route follows the tensor's device, nothing else: a CUDA tensor
launches the hand-written kernel (or the wrapper raises — there is no
fallback), a CPU tensor runs the kernel's plain PyTorch version from
``kernels.ref``.  No environment variable changes the route.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import moe_gemm as _mg
from repro_torch.kernels import redundancy_vote as _rv
from repro_torch.kernels import ref
from repro_torch.obs import annotate

__all__ = ["kernel_route", "moe_gemm", "redundancy_vote_masked",
           "launch_counts", "reset_launch_counts"]


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


def redundancy_vote_masked(pub: torch.Tensor, active: torch.Tensor,
                           atol: float = 0.0):
    """Majority vote over M published copies restricted to the ``active``
    electorate (paper Step 3, §VI-D).  pub (E, M, T) -> (trusted (E, T),
    support (E,) int32, flags (E, M) int32)."""
    route = kernel_route(pub)
    with annotate(f"redundancy_vote[{route}]"):
        if route == "cuda":
            return _rv.redundancy_vote_masked(pub, active, atol)
        _rv.check_operands(pub, active)
        return ref.redundancy_vote_masked_ref(pub, active, atol)


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {"moe_gemm": _mg.launches, "redundancy_vote": _rv.launches}


def reset_launch_counts() -> None:
    _mg.launches = 0
    _rv.launches = 0
