"""Carry weights across from the JAX package (or any numpy source).

Both packages keep the same parameter names and layouts (``x @ w``;
conv kernels HWIO; the expert bank and the LM's blocks stacked on a
leading axis), so nothing is transposed: the arrays are copied onto the
target device.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.kernels.ops import resolve_device

GATE_KEYS = ("b", "w")
# the MLP bank's and the CNN bank's leaves, sorted
EXPERT_KEYS = (("b1", "b2", "w1", "w2"),
               ("b1", "b2", "c1", "c2", "c3", "w1", "w2"))


def params_from_numpy(gate: Dict[str, np.ndarray],
                      experts: Dict[str, np.ndarray],
                      device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"gate": {w, b}, "experts": bank}`` as float32 tensors on
    ``device`` (``None``: the CUDA device) — what ``BMoESystem(cfg,
    device, params=...)`` takes.  The bank is the MLP's {w1, b1, w2, b2}
    or the CNN's {c1, c2, c3, w1, b1, w2, b2} (kernels HWIO, unchanged)."""
    dev = resolve_device(device)
    for name, tree, allowed in (("gate", gate, (GATE_KEYS,)),
                                ("experts", experts, EXPERT_KEYS)):
        if tuple(sorted(tree)) not in allowed:
            raise ValueError(f"{name} must have keys "
                             f"{' or '.join(map(str, allowed))}, got "
                             f"{tuple(sorted(tree))}")

    def put(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(dev)

    return {"gate": {k: put(v) for k, v in gate.items()},
            "experts": {k: put(v) for k, v in experts.items()}}


def lm_params_from_numpy(tree: Any, device=None) -> Any:
    """The port's LM parameter (or cache) tree from the JAX package's, as
    numpy arrays: the same nested dicts and lists, each array copied in
    its own dtype onto ``device`` (``None``: the CUDA device)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        arr = np.array(node)
        if arr.dtype.kind not in "fiub":
            raise TypeError(f"lm_params_from_numpy: unsupported dtype "
                            f"{arr.dtype}")
        return torch.from_numpy(arr).to(dev)

    return walk(tree)
