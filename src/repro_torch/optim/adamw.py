"""AdamW with warm-up and a decay schedule (the counterpart of
``repro.optim.adamw``).

The state is ``AdamWState(step, m, v)``: ``step`` a 0-dim int32 tensor,
``m`` and ``v`` trees shaped like the parameters, in the parameters'
dtype or another (bf16 or float32 moments round-trip through float32 in
the update, as in the JAX package).  ``update`` runs JAX's arithmetic in
JAX's order, but in place, leaf by leaf: it overwrites the parameters and
the moments it is given and returns them, because functional copies of a
3.5 B-parameter model do not fit on the card beside its moments.  The
scalars (learning rate, bias corrections, clip scale) stay 0-dim float32
tensors on the parameters' device, so a step reads nothing back to the
host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from repro_torch.core.ledger import tree_flatten, tree_unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: object
    v: object


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # cosine | linear | constant


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor or int), float32:
    linear warm-up over ``warmup_steps``, then cosine or linear decay to 0
    at ``total_steps``, or constant."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        decay = 1.0
    else:
        frac = torch.clamp((step - cfg.warmup_steps) /
                           max(cfg.total_steps - cfg.warmup_steps, 1),
                           0.0, 1.0)
        decay = (0.5 * (1 + torch.cos(math.pi * frac))
                 if cfg.schedule == "cosine" else 1.0 - frac)
    return cfg.lr * warm * decay


def init(params) -> AdamWState:
    """Zero moments in the parameters' dtypes, step 0, on their device."""
    leaves, _ = tree_flatten(params)
    zeros = [torch.zeros_like(p) for p in leaves]
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=leaves[0].device),
        m=tree_unflatten(params, zeros),
        v=tree_unflatten(params, [torch.zeros_like(p) for p in leaves]))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf in float32, the leaves
    summed in the JAX package's flatten order."""
    leaves, _ = tree_flatten(tree)
    total = None
    for leaf in leaves:
        sq = torch.sum(torch.square(leaf.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def update(cfg: AdamWConfig, grads, state: AdamWState, params,
           gnorm: torch.Tensor = None):
    """One AdamW step with global-norm clipping.  Returns (params, state,
    metrics) with metrics {grad_norm, lr} as 0-dim float32 tensors.  The
    parameters and the state's moments are updated in place (the returned
    trees are the same tensors); ``grads`` is read only.  ``gnorm``: the
    global norm when ``grads`` is one rank's part of a sharded tree
    (``global_norm(grads)`` otherwise)."""
    flat_p, _ = tree_flatten(params)
    flat_g, _ = tree_flatten(grads)
    flat_m, _ = tree_flatten(state.m)
    flat_v, _ = tree_flatten(state.v)
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError("params, grads and the state's moments must have "
                         "one structure")
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.grad_clip else None)
    step = state.step + 1
    lr = lr_at(cfg, step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    with torch.no_grad():
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            if scale is not None:
                g = g * scale
            g = g.float()
            m32 = m.float().mul_(cfg.b1) if m.dtype != torch.float32 \
                else m.mul_(cfg.b1)
            m32.add_(g * (1 - cfg.b1))
            v32 = v.float().mul_(cfg.b2) if v.dtype != torch.float32 \
                else v.mul_(cfg.b2)
            v32.add_(torch.square(g).mul_(1 - cfg.b2))
            denom = (v32 / bc2).sqrt_().add_(cfg.eps)
            upd = (m32 / bc1).div_(denom).add_(cfg.weight_decay * p)
            del denom
            if p.dtype == torch.float32:
                p.sub_(upd.mul_(lr))
            else:
                p.copy_(p.float().sub_(upd.mul_(lr)))
            if m32 is not m:
                m.copy_(m32)
            if v32 is not v:
                v.copy_(v32)
    return params, AdamWState(step, state.m, state.v), {"grad_norm": gnorm,
                                                        "lr": lr}
