"""Carry weights across from the JAX package (or any numpy source), and
back.

Both packages keep the same parameter names and layouts (``x @ w``;
conv kernels HWIO; the expert bank and the LM's blocks stacked on a
leading axis), so nothing is transposed: the arrays are copied onto the
target device.  An AdamW state carries across as its (step, m, v) parts
(``adamw_state_from_numpy``, ``adamw_state_to_numpy``); ``tree_to_numpy``
copies any tree of tensors back to host numpy arrays.
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
    device, params=...)`` and ``fed.FedCoordinator(cfg, x, y,
    params=...)`` take.  The bank is the MLP's {w1, b1, w2, b2}
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


def tree_to_numpy(tree: Any) -> Any:
    """The same nested dicts and lists with every tensor copied to a host
    numpy array in its own dtype (what the JAX package's functions take)."""
    if isinstance(tree, Mapping):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def adamw_state_from_numpy(state: Any, device=None):
    """The port's ``optim.adamw.AdamWState`` from a JAX ``AdamWState`` (or
    any (step, m, v) triple) of numpy-convertible arrays: step as a 0-dim
    int32 tensor, the moments in their own dtypes, on ``device``
    (``None``: the CUDA device)."""
    from repro_torch.optim.adamw import AdamWState
    step, m, v = state
    dev = resolve_device(device)
    return AdamWState(
        step=torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                          device=dev),
        m=lm_params_from_numpy(m, dev), v=lm_params_from_numpy(v, dev))


def adamw_state_to_numpy(state: Any):
    """(step int32 0-dim array, m, v numpy trees): the parts of a JAX
    ``AdamWState``, which ``AdamWState(*parts)`` rebuilds there."""
    step, m, v = state
    return (np.asarray(step.detach().cpu().numpy(), np.int32),
            tree_to_numpy(m), tree_to_numpy(v))
