"""Fused masked redundancy vote: the wrapper of the CUDA kernel in
``csrc/vote.cu`` (the port of ``repro.kernels.redundancy_vote.
pairwise_agreement`` together with the masked epilogue of
``repro.kernels.ref.redundancy_vote_masked_ref``).

``redundancy_vote_masked(pub, active, atol)`` takes pub (E, M, T)
float32 (expert e's result as published by edge m, flattened) and the
(M,) electorate ``active``, and returns trusted (E, T), support (E,)
int32, flags (E, M) int32 and winner (E,) int32 (the elected copy),
equal exactly to ``ref.redundancy_vote_winner_ref``.  Any M >= 1 is taken
on the CPU route, as by the JAX reference; each block of the kernel's
clusters keeps ceil(M/32) disagreement words per copy in shared memory,
which bounds it at ``MAX_EDGES_CUDA``.  It takes CUDA tensors only and launches
the kernel or raises; ``kernels.ops.redundancy_vote_masked`` is the device
dispatch, and carries the gradient of trusted to the winner's copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# M * ceil(M / 32) disagreement words fit a block's 227 KB of shared memory
MAX_EDGES_CUDA = 1351

# kernel launches since the last reset (ops.reset_launch_counts)
launches = 0


def check_operands(pub: torch.Tensor, active: torch.Tensor) -> None:
    if pub.dim() != 3:
        raise ValueError(f"vote wants pub (E, M, T), got {tuple(pub.shape)}")
    if pub.dtype != torch.float32:
        raise TypeError(f"vote takes float32 copies, got {pub.dtype}")
    M = pub.shape[1]
    if M < 1:
        raise ValueError(f"vote needs at least one copy, got {M}")
    if active.shape != (M,):
        raise ValueError(f"active must be ({M},), got {tuple(active.shape)}")
    if active.device != pub.device:
        raise ValueError(f"vote operands on {pub.device} and "
                         f"{active.device}")


def _check_device(pub: torch.Tensor) -> None:
    if pub.device.type != "cuda":
        raise ValueError(f"vote launches on CUDA tensors, got {pub.device}")
    if torch.cuda.get_device_capability(pub.device) != (9, 0):
        raise RuntimeError("the vote is built for sm_90a (Hopper); device "
                           f"{torch.cuda.get_device_name(pub.device)} is not")
    if pub.shape[1] > MAX_EDGES_CUDA:
        raise ValueError(f"the vote kernel handles 1..{MAX_EDGES_CUDA} "
                         f"copies, got {pub.shape[1]}")


def redundancy_vote_masked(pub: torch.Tensor, active: torch.Tensor,
                           atol: float = 0.0):
    """Launch the CUDA kernel on CUDA tensors."""
    global launches
    check_operands(pub, active)
    _check_device(pub)
    if not pub.is_contiguous():
        raise ValueError("vote needs a contiguous pub")
    E, M, T = pub.shape
    act = active.to(torch.int32).contiguous()   # as astype(int32)
    trusted = torch.empty((E, T), dtype=pub.dtype, device=pub.device)
    support = torch.empty((E,), dtype=torch.int32, device=pub.device)
    flags = torch.empty((E, M), dtype=torch.int32, device=pub.device)
    winner = torch.empty((E,), dtype=torch.int32, device=pub.device)
    if E == 0:
        return trusted, support, flags, winner
    lib = build.library()
    with torch.cuda.device(pub.device):
        stream = torch.cuda.current_stream(pub.device).cuda_stream
        code = lib.redundancy_vote_masked_f32(
            pub.data_ptr(), act.data_ptr(), float(atol), E, M, T,
            trusted.data_ptr(), support.data_ptr(), flags.data_ptr(),
            winner.data_ptr(), stream)
    build.check(code, "redundancy_vote_masked")
    launches += 1
    return trusted, support, flags, winner


def launch_floor(pub: torch.Tensor) -> None:
    """Launch an empty kernel with the grid, cluster shape, block size and
    shared memory the vote takes for ``pub``: the time no vote of that
    shape can go below.  Not a vote launch (``launches`` is unchanged)."""
    _check_device(pub)
    E, M, _ = pub.shape
    lib = build.library()
    with torch.cuda.device(pub.device):
        stream = torch.cuda.current_stream(pub.device).cuda_stream
        build.check(lib.vote_launch_floor(E, M, stream), "vote_launch_floor")
