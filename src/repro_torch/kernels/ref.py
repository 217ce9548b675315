"""Plain PyTorch versions of the kernels (the counterparts of
``repro.kernels.ref``).

They are what a kernel wrapper runs on a CPU tensor, what the tests hold
the JAX package against, and the yardstick ``chip_smoke.py`` holds each
CUDA kernel against on the card.  On a CUDA tensor the main path never
calls them: ``kernels.ops`` launches the kernel instead.
"""
from __future__ import annotations

import torch


# ------------------------------------------------- redundancy vote
def pairwise_agreement_ref(pub: torch.Tensor,
                           atol: float = 0.0) -> torch.Tensor:
    """pub: (E, M, T). Returns (E, M, M) int32 — for each expert e, the
    number of elements on which copies i and j agree (within atol)."""
    diff = (pub[:, :, None, :] - pub[:, None, :, :]).abs()
    return (diff <= atol).sum(dim=-1).to(torch.int32)


def _gather_copy(flat: torch.Tensor, winner: torch.Tensor) -> torch.Tensor:
    """flat (E, M, T), winner (E,) -> flat[e, winner[e]] (E, T)."""
    idx = winner[:, None, None].expand(-1, 1, flat.shape[-1])
    return flat.gather(1, idx)[:, 0]


def redundancy_vote_ref(pub: torch.Tensor, atol: float = 0.0):
    """pub: (E, M, *tail) — expert e's result as published by edge m.

    Replica-level majority vote (paper Step 3): the accepted copy of
    expert e is the one agreeing (on every element) with the largest
    coalition; ties go to the lowest edge index.  Returns
    (trusted (E, *tail), support (E,) int32)."""
    E, M = pub.shape[:2]
    flat = pub.reshape(E, M, -1)
    T = flat.shape[-1]
    full_agree = (pairwise_agreement_ref(flat, atol) == T).to(torch.int32)
    support_per = full_agree.sum(dim=-1, dtype=torch.int32)     # (E, M)
    winner = support_per.argmax(dim=-1)                        # first max
    trusted = _gather_copy(flat, winner)
    support = support_per.gather(1, winner[:, None])[:, 0]
    return trusted.reshape((E,) + pub.shape[2:]), support


def redundancy_vote_masked_ref(pub: torch.Tensor, active: torch.Tensor,
                               atol: float = 0.0):
    """Vote restricted to ``active`` copies (reputation exclusion,
    paper §VI-D): excluded edges neither count toward majorities nor can
    be elected.  active: (M,) {0,1}.  Returns (trusted (E, *tail),
    support (E,) int32, flags (E, M) int32)."""
    E, M = pub.shape[:2]
    flat = pub.reshape(E, M, -1)
    T = flat.shape[-1]
    full_agree = (pairwise_agreement_ref(flat, atol) == T).to(torch.int32)
    a = active.to(torch.int32)
    support_per = (full_agree * a[None, None, :]).sum(dim=-1,
                                                      dtype=torch.int32)
    score = support_per * a[None, :] - (1 - a[None, :])        # bar excluded
    winner = score.argmax(dim=-1)                              # first max
    trusted = _gather_copy(flat, winner)
    support = support_per.gather(1, winner[:, None])[:, 0]
    flags = full_agree.gather(
        1, winner[:, None, None].expand(-1, 1, M))[:, 0] * a[None, :]
    return trusted.reshape((E,) + pub.shape[2:]), support, flags


# ------------------------------------------------- grouped expert GEMM
def moe_gemm_ref(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """buf: (E, C, d), w: (E, d, f) -> (E, C, f): f32 accumulate, cast to
    ``buf.dtype``."""
    out = torch.einsum("ecd,edf->ecf", buf.float(), w.float())
    return out.to(buf.dtype)
