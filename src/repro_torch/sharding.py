"""Placement of the B-MoE expert bank on the edge mesh (the part of
``repro.sharding`` that ``BMoESystem(mesh="on")`` uses: ``Sharder(mesh,
rules={"experts": "model"})`` over a bank whose leading axis is the
expert axis).

Under SPMD a rank holds only its own shard: ``shard_bank`` takes a bank
dict (every leaf's leading axis the ``N`` experts, on any device) to this
rank's contiguous ``[s*E_l, (s+1)*E_l)`` rows on the mesh's device,
``E_l = N / shards``.  The logical-axis rules of the LM models
(``logical_rules``, FSDP) are not ported yet.
"""
from __future__ import annotations

from typing import Dict

import torch


def shard_bank(bank: Dict[str, torch.Tensor], mesh
               ) -> Dict[str, torch.Tensor]:
    """This rank's expert rows of ``bank`` on ``mesh.device``, as tensors
    of their own (the full bank is not kept alive by a view)."""
    n = next(iter(bank.values())).shape[0]
    lo, hi = mesh.expert_range(n)
    return {k: v[lo:hi].to(mesh.device).clone() for k, v in bank.items()}
