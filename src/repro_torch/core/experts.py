"""The paper's expert/gate models (§V-A(5)).

- Gating network: linear (flattened input -> N expert logits).
- MLP expert (Fashion-MNIST): two fully-connected layers, hidden 256,
  ReLU.
- CNN expert (CIFAR-10): three 3x3 stride-2 convs + two fully-connected
  layers.

Parameters are plain dicts of tensors with the JAX package's names and
layouts (``x @ w``; conv kernels HWIO, images NHWC), because digests,
chunk CIDs and bank roots hash these bytes: a convolution permutes to
PyTorch's NCHW/OIHW inside the apply, never in storage.  The expert
bank is stacked on a leading N axis.
"""
from __future__ import annotations

import contextlib
import hashlib
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.builder import Leaf, stack
from repro_torch.models.moe import top_k

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


def gate_decl(in_dim: int, num_experts: int) -> dict:
    """The linear gate's declaration, the JAX package's."""
    return {"w": Leaf((in_dim, num_experts), (None, None), scale=0.01),
            "b": Leaf((num_experts,), (None,), "zeros")}


def mlp_expert_decl(in_dim: int, hidden: int = 256, out: int = 10) -> dict:
    """One MLP expert's declaration, the JAX package's."""
    return {
        "w1": Leaf((in_dim, hidden), (None, None)),
        "b1": Leaf((hidden,), (None,), "zeros"),
        "w2": Leaf((hidden, out), (None, None)),
        "b2": Leaf((out,), (None,), "zeros"),
    }


def cnn_expert_decl(in_ch: int = 3, out: int = 10) -> dict:
    """One CNN expert's declaration, the JAX package's: three 3x3 stride-2
    convs + two FC layers (widths unspecified in the paper)."""
    return {
        "c1": Leaf((3, 3, in_ch, 16), (None,) * 4),
        "c2": Leaf((3, 3, 16, 32), (None,) * 4),
        "c3": Leaf((3, 3, 32, 32), (None,) * 4),
        "w1": Leaf((4 * 4 * 32, 128), (None, None)),
        "b1": Leaf((128,), (None,), "zeros"),
        "w2": Leaf((128, out), (None, None)),
        "b2": Leaf((out,), (None,), "zeros"),
    }


def _init_decl(decl: dict, seed: int, prefix: str, device) -> Params:
    """Tensors for a flat declaration, drawn on the CPU (so the values do
    not depend on the device) and moved to ``device`` (``None``: the CUDA
    device): a normal leaf takes its declared std, else 1/sqrt(fan_in)
    on the second-to-last dim (a conv's input channels), from the stream
    of its path ``prefix/name``; a zeros leaf is zero."""
    device = kops.resolve_device(device)
    out = {}
    for k, leaf in decl.items():
        std = (leaf.scale if leaf.scale is not None
               else _fan_in_std(leaf.shape))
        out[k] = (torch.zeros(leaf.shape) if leaf.init == "zeros" else
                  _normal(leaf.shape, std, seed, f"{prefix}/{k}"))
    return {k: v.to(device) for k, v in out.items()}


def init_gate(in_dim: int, num_experts: int, seed: int,
              device=None) -> Params:
    """Gate ``w`` normal with std 0.01, zero bias, on ``device``
    (``None``: the CUDA device)."""
    return _init_decl(gate_decl(in_dim, num_experts), seed, "gate", device)


def init_mlp_bank(num_experts: int, seed: int, *, in_dim: int = 784,
                  hidden: int = 256, out: int = 10,
                  device=None) -> Params:
    """Stacked MLP bank: ``w1`` (N, in, hidden), ``w2`` (N, hidden, out)
    normal with std 1/sqrt(fan_in), zero biases, on ``device`` (``None``:
    the CUDA device)."""
    return _init_decl(stack(mlp_expert_decl(in_dim, hidden, out),
                            num_experts, axis_name=None),
                      seed, "experts", device)


def init_cnn_bank(num_experts: int, seed: int, *, in_ch: int = 3,
                  out: int = 10, device=None) -> Params:
    """Stacked CNN bank (``cnn_expert_decl`` behind a leading N axis):
    kernels and weights normal with std 1/sqrt(fan_in) on the
    second-to-last dim (a conv's input channels), zero biases, on
    ``device`` (``None``: the CUDA device)."""
    return _init_decl(stack(cnn_expert_decl(in_ch, out), num_experts,
                            axis_name=None), seed, "experts", device)


def init_bank(kind: str, num_experts: int, seed: int, *, in_dim: int = 784,
              in_ch: int = 3, hidden: int = 256, out: int = 10,
              device=None) -> Params:
    """The seeded stacked bank of ``kind`` ("mlp" | "cnn"); ``hidden`` is
    the MLP's width."""
    if kind == "mlp":
        return init_mlp_bank(num_experts, seed, in_dim=in_dim,
                             hidden=hidden, out=out, device=device)
    if kind == "cnn":
        return init_cnn_bank(num_experts, seed, in_ch=in_ch, out=out,
                             device=device)
    raise ValueError(kind)


def make_expert_bank(kind: str, num_experts: int, seed: int, *,
                     in_dim: int = 784, in_ch: int = 3, hidden: int = 256,
                     out: int = 10, device=None):
    """Returns ``(stacked_params, apply_all)`` where ``apply_all(params,
    x)`` -> (N, B, out): every expert's output on the same batch (the
    JAX package's ``make_expert_bank`` on the port's seeded init)."""
    params = init_bank(kind, num_experts, seed, in_dim=in_dim, in_ch=in_ch,
                       hidden=hidden, out=out, device=device)
    return params, apply_all_fn(kind)


def gate_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, in_dim) -> logits (B, N)."""
    return x @ params["w"] + params["b"]


def mlp_expert_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """One expert's params, x: (B, in_dim) -> logits (B, out)."""
    h = torch.relu(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def cnn_numerics():
    """The CNN's convolutions in fp32 with a fixed algorithm: cuDNN's TF32
    off, no autotuning, deterministic kernels.  So a call of one shape
    gives the same bits every time (the commitment and the auditors'
    recompute hash the same leaves) and weight gradients are repeatable.
    The flags are read when a convolution (or its backward) runs: wrap
    the backward too."""
    if not torch.backends.cudnn.is_available():
        return contextlib.nullcontext()
    return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                      deterministic=True, allow_tf32=False)


def _same_pad(size: int, k: int = 3, stride: int = 2):
    """XLA's ``padding="SAME"``: (before, after) for one spatial dim —
    at stride 2 on an even size, nothing before and one after."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(h: torch.Tensor, w: torch.Tensor, groups: int = 1):
    """A 3x3 stride-2 SAME conv on NCHW ``h`` with an OIHW kernel."""
    (t, b), (lft, r) = _same_pad(h.shape[2]), _same_pad(h.shape[3])
    return F.conv2d(F.pad(h, (lft, r, t, b)), w, stride=2, groups=groups)


def cnn_expert_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """One expert's params, x: (B, 32, 32, C) NHWC -> logits (B, out).
    The activations flatten in NHWC order (h, w, c) before ``w1``, as
    in the JAX package."""
    with cnn_numerics():
        h = x.permute(0, 3, 1, 2)
        for k in ("c1", "c2", "c3"):
            h = torch.relu(_conv_same(h, params[k].permute(3, 2, 0, 1)))
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        h = torch.relu(h @ params["w1"] + params["b1"])
        return h @ params["w2"] + params["b2"]


def cnn_expert_apply_grouped(params: Params,
                             buf: torch.Tensor) -> torch.Tensor:
    """buf: (N, C, 32, 32, ch) -> (N, C, out): every expert's CNN on its
    own rows — the JAX package's ``vmap(cnn_expert_apply)`` — one
    ``cnn_expert_apply`` call an expert.  A call's bytes depend on that
    expert's parameters and rows alone, so an expert's output is the same
    in a bank of any size (a grouped convolution over the whole bank
    rounds apart with the group count, and so would the edge mesh's
    shards)."""
    return torch.stack([cnn_expert_apply({k: v[e] for k, v in
                                          params.items()}, buf[e])
                        for e in range(buf.shape[0])])


def mlp_apply_all(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Dense dispatch: every expert on the whole batch, x (B, d) -> (N, B,
    out) (the JAX package's ``vmap(mlp_expert_apply)``; plain products,
    no kernel)."""
    h = torch.relu(torch.matmul(x, params["w1"]) + params["b1"][:, None])
    return torch.matmul(h, params["w2"]) + params["b2"][:, None]


def cnn_apply_all(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Dense dispatch for the CNN bank: x (B, 32, 32, C) -> (N, B, out)."""
    n = params["c1"].shape[0]
    return cnn_expert_apply_grouped(params, x.expand(n, *x.shape))


def apply_all_fn(kind: str) -> Callable[[Params, torch.Tensor],
                                        torch.Tensor]:
    """apply(stacked_params, x (B, ...)) -> (N, B, out): every expert on
    the same batch (dense dispatch)."""
    if kind == "mlp":
        return mlp_apply_all
    if kind == "cnn":
        return cnn_apply_all
    raise ValueError(kind)


class _GroupedMLP(torch.autograd.Function):
    """The grouped expert MLP with the backward of JAX's ``custom_vjp``
    (``repro.core.experts._mlp_grouped_bwd``): its four products are
    ``ops.moe_gemm`` launches on contiguous transposed copies (the kernel
    takes contiguous operands), the bias gradients plain sums over C.

    Every expert's gradient bytes depend on that expert's rows alone,
    whatever the number of experts (the edge mesh's shards hold the
    one-device bank's experts to it): the products are per-expert
    kernel tiles, and both bias sums are ONE reduction along the
    contiguous last axis of ``(E, f + out, C)`` rows.  There the device
    reduction's thread layout depends on the row length C alone (at
    E*(f + out) >= 16 rows, always), where summing over axis 1 of
    ``(E, C, out)`` lays threads out by E*out."""

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
        db = torch.cat([dh.transpose(1, 2), g.transpose(1, 2)],
                       dim=1).sum(dim=-1)
        f = dh.shape[-1]
        return dw1, db[:, :f], dw2, db[:, f:], dbuf


def mlp_expert_apply_grouped(params: Params,
                             buf: torch.Tensor) -> torch.Tensor:
    """buf: (N, C, d) capacity buckets -> (N, C, out): every expert's
    2-layer MLP on its own bucket through the grouped GEMM (two
    ``ops.moe_gemm`` launches on the card; three more in the backward,
    four where buf needs a gradient).  The bias add and ReLU stay outside
    the kernel, as in the JAX package."""
    return _GroupedMLP.apply(params["w1"], params["b1"], params["w2"],
                             params["b2"], buf)


def grouped_apply_fn(kind: str) -> Callable[[Params, torch.Tensor],
                                            torch.Tensor]:
    """apply(stacked_params, buf (N, C, ...)) -> (N, C, out): each expert
    on its own capacity bucket, the sparse-dispatch counterpart of
    ``apply_all_fn``.  The MLP bank runs the grouped GEMM kernel; the CNN
    bank one network call an expert."""
    if kind == "mlp":
        return mlp_expert_apply_grouped
    if kind == "cnn":
        return cnn_expert_apply_grouped
    raise ValueError(kind)


def sparse_gate_weights(logits: torch.Tensor, k: int):
    """Paper's sparse top-K activation: softmax renormalized over the
    selected experts.  Returns dense weights (B, N) (zero off the top-K)
    and the top-K indices (B, k).  Ties break like ``jax.lax.top_k``,
    lower index first (``models.moe.top_k``)."""
    topv, topi = top_k(logits, k)
    w = torch.softmax(topv, dim=-1)
    return torch.zeros_like(logits).scatter(1, topi, w), topi
