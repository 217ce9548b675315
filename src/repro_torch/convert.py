"""Carry weights across from the JAX package (or any numpy source).

Both packages keep the same parameter names and layouts (``x @ w``;
the expert bank stacked on a leading N axis), so nothing is transposed:
the arrays are copied as float32 onto the target device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.bmoe import resolve_device

GATE_KEYS = ("b", "w")
EXPERT_KEYS = ("b1", "b2", "w1", "w2")


def params_from_numpy(gate: Dict[str, np.ndarray],
                      experts: Dict[str, np.ndarray],
                      device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"gate": {w, b}, "experts": {w1, b1, w2, b2}}`` as float32
    tensors on ``device`` (``None``: the CUDA device) — what
    ``BMoESystem(cfg, device, params=...)`` takes."""
    dev = resolve_device(device)
    for name, tree, keys in (("gate", gate, GATE_KEYS),
                             ("experts", experts, EXPERT_KEYS)):
        if tuple(sorted(tree)) != keys:
            raise ValueError(f"{name} must have keys {keys}, got "
                             f"{tuple(sorted(tree))}")

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return {"gate": {k: put(v) for k, v in gate.items()},
            "experts": {k: put(v) for k, v in experts.items()}}
