"""Capacity-bucket dispatch machinery shared by the MoE layers (the
counterpart of ``repro.models.moe.capacity_positions``; the rest of the
LM-stack MoE layer is not ported yet)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def capacity_positions(expert_id: torch.Tensor, num_experts: int,
                       capacity: int):
    """Capacity-bucket slot assignment.

    ``expert_id``: (G, P) int — expert chosen at each of P dispatch
    positions, independently per group G.  Returns ``(position, keep,
    onehot)``: ``position[g, p]`` counts earlier same-expert assignments
    within the group (the slot in that expert's capacity bucket),
    ``keep = position < capacity`` marks assignments that fit, and
    ``onehot`` is the (G, P, E) assignment tensor.  Overflowing
    assignments are *dropped*, never mis-routed.  Positions are int64
    (torch's index type); their values equal the JAX package's int32
    ones."""
    onehot = F.one_hot(expert_id.long(), num_experts)   # (G, P, E) int64
    pos_all = onehot.cumsum(dim=1) - onehot
    position = (pos_all * onehot).sum(dim=-1)
    return position, position < capacity, onehot
