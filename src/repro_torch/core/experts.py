"""The paper's expert/gate models (§V-A(5)), MLP bank only.

- Gating network: linear (flattened input -> N expert logits).
- MLP expert (Fashion-MNIST): two fully-connected layers, hidden 256,
  ReLU.

Parameters are plain dicts of tensors with the JAX package's names and
layouts (``x @ w``); the expert bank is stacked on a leading N axis.
The CNN expert waits for a later slice.
"""
from __future__ import annotations

import hashlib
from typing import Dict

import torch

from repro_torch.kernels import ops as kops

Params = Dict[str, torch.Tensor]


def _leaf_generator(seed: int, path: str) -> torch.Generator:
    """One CPU stream per parameter path (the JAX package's init folds the path
    digest into its key the same way, but its draws differ)."""
    digest = hashlib.sha256(f"{seed}{path}".encode()).digest()
    return torch.Generator(device="cpu").manual_seed(
        int.from_bytes(digest[:8], "little") & (2**63 - 1))


def _normal(shape, std: float, seed: int, path: str) -> torch.Tensor:
    return torch.randn(shape, generator=_leaf_generator(seed, path)) * std


def _fan_in_std(shape) -> float:
    """Fan-in scaling on the second-to-last dim, as the JAX init does."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    return 1.0 / max(fan_in, 1) ** 0.5


def init_gate(in_dim: int, num_experts: int, seed: int,
              device=None) -> Params:
    """Gate ``w`` normal with std 0.01, zero bias, on ``device``
    (``None``: the CUDA device)."""
    device = kops.resolve_device(device)
    return {"w": _normal((in_dim, num_experts), 0.01, seed,
                         "gate/w").to(device),
            "b": torch.zeros(num_experts, device=device)}


def init_mlp_bank(num_experts: int, seed: int, *, in_dim: int = 784,
                  hidden: int = 256, out: int = 10,
                  device=None) -> Params:
    """Stacked MLP bank: ``w1`` (N, in, hidden), ``w2`` (N, hidden, out)
    normal with std 1/sqrt(fan_in), zero biases, on ``device`` (``None``:
    the CUDA device)."""
    device = kops.resolve_device(device)
    s1, s2 = (num_experts, in_dim, hidden), (num_experts, hidden, out)
    return {"w1": _normal(s1, _fan_in_std(s1), seed, "experts/w1").to(device),
            "b1": torch.zeros((num_experts, hidden), device=device),
            "w2": _normal(s2, _fan_in_std(s2), seed, "experts/w2").to(device),
            "b2": torch.zeros((num_experts, out), device=device)}


def gate_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, in_dim) -> logits (B, N)."""
    return x @ params["w"] + params["b"]


def mlp_expert_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """One expert's params, x: (B, in_dim) -> logits (B, out)."""
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


class _GroupedMLP(torch.autograd.Function):
    """The grouped expert MLP with the backward of JAX's ``custom_vjp``
    (``repro.core.experts._mlp_grouped_bwd``): its four products are
    ``ops.moe_gemm`` launches on contiguous transposed copies (the kernel
    takes contiguous operands), the bias gradients plain sums over C."""

    @staticmethod
    def forward(ctx, w1, b1, w2, b2, buf):
        h = torch.relu(kops.moe_gemm(buf, w1) + b1[:, None, :])
        ctx.save_for_backward(w1, w2, buf)
        ctx.h = h
        return kops.moe_gemm(h, w2) + b2[:, None, :]

    @staticmethod
    def backward(ctx, g):
        w1, w2, buf = ctx.saved_tensors
        h, g = ctx.h, g.contiguous()
        dw2 = kops.moe_gemm(h.transpose(1, 2).contiguous(), g)
        dh = kops.moe_gemm(g, w2.transpose(1, 2).contiguous()) * (h > 0)
        dw1 = kops.moe_gemm(buf.transpose(1, 2).contiguous(), dh)
        # buf comes from the data on the B-MoE step: no product for it
        dbuf = (kops.moe_gemm(dh, w1.transpose(1, 2).contiguous())
                if ctx.needs_input_grad[4] else None)
        return dw1, dh.sum(dim=1), dw2, g.sum(dim=1), dbuf


def mlp_expert_apply_grouped(params: Params,
                             buf: torch.Tensor) -> torch.Tensor:
    """buf: (N, C, d) capacity buckets -> (N, C, out): every expert's
    2-layer MLP on its own bucket through the grouped GEMM (two
    ``ops.moe_gemm`` launches on the card; three more in the backward,
    four where buf needs a gradient).  The bias add and ReLU stay outside
    the kernel, as in the JAX package."""
    return _GroupedMLP.apply(params["w1"], params["b1"], params["w2"],
                             params["b2"], buf)


def sparse_gate_weights(logits: torch.Tensor, k: int):
    """Paper's sparse top-K activation: softmax renormalized over the
    selected experts.  Returns dense weights (B, N) (zero off the top-K)
    and the top-K indices (B, k).  Ties break like ``jax.lax.top_k``,
    lower index first: a stable descending sort, first k."""
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :k], topi[:, :k]
    w = torch.softmax(topv, dim=-1)
    return torch.zeros_like(logits).scatter(1, topi, w), topi
