"""Token-choice top-k sparsely-gated MoE layer (GShard-style) with
group-wise capacity dispatch, shared experts and a load-balance auxiliary
loss (the counterpart of ``repro.models.moe``).

Each batch row is a dispatch group: the capacity cumsum runs over the
row's S*k assignments.  Tokens are scattered into a per-row per-expert
capacity buffer (B, E, C, d), run through the experts' SwiGLU as three
``ops.moe_gemm`` launches over the batch folded into each expert's rows,
(E, B*C, d), and combined back with their gate weights.

``capacity_positions`` is shared with the B-MoE system's sparse dispatch.
The JAX package's ``route_masked`` and the ``trust`` hook serve the mesh
(expert parallelism, the LM-scale vote) and wait for ROADMAP A7b.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.builder import Leaf


def moe_decl(cfg) -> dict:
    E, d, f = cfg.resolved_padded_experts, cfg.d_model, cfg.moe_d_ff
    decl = {
        "router": Leaf((d, E), ("embed", "experts"), scale=0.02),
        "w_gate": Leaf((E, d, f), ("experts", "embed", "moe_ff")),
        "w_up": Leaf((E, d, f), ("experts", "embed", "moe_ff")),
        "w_down": Leaf((E, f, d), ("experts", "moe_ff", "embed")),
    }
    if cfg.num_shared_experts:
        sf = cfg.num_shared_experts * f
        decl["shared"] = {
            "w_gate": Leaf((d, sf), ("embed", "ff")),
            "w_up": Leaf((d, sf), ("embed", "ff")),
            "w_down": Leaf((sf, d), ("ff", "embed")),
        }
    return decl


def capacity_for(cfg, tokens_per_group: int) -> int:
    cap = max(int(cfg.capacity_factor * tokens_per_group *
                  cfg.num_experts_per_tok / cfg.num_experts), 1)
    cap = min(-(-cap // 8) * 8, tokens_per_group * cfg.num_experts_per_tok)
    return max(cap, 1)


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


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, largest
    first, and on a tie the lower index first (a stable descending sort;
    ``torch.topk`` promises no order among equal values)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(logits: torch.Tensor, k: int, capacity: int, num_real: int = 0):
    """logits: (B, S, E).  Per-row top-k routing with capacity buckets.

    ``num_real`` < E masks the padded experts out of the softmax and the
    top-k.  Returns weights (B,S,k), expert_id (B,S,k), position
    (B,S,k), keep (B,S,k) and the GShard load-balance aux loss (dropped
    assignments count in it too)."""
    B, S, E = logits.shape
    if num_real and num_real < E:
        pad = torch.arange(E, device=logits.device) >= num_real
        logits = logits.masked_fill(pad, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    weights, expert_id = top_k(probs, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)

    position, keep, onehot = capacity_positions(
        expert_id.reshape(B, S * k), E, capacity)
    position = position.reshape(B, S, k)
    keep = keep.reshape(B, S, k)

    frac_tokens = onehot.sum(dim=(0, 1)).float() / (B * S * k)
    frac_probs = probs.mean(dim=(0, 1))
    aux = E * torch.sum(frac_tokens * frac_probs)
    return weights, expert_id, position, keep, aux


def grouped_mlp(buf, w_gate, w_up, w_down):
    """buf: (B, E, C, d) -> (B, E, C, d) through each expert's SwiGLU.

    The batch is folded into each expert's rows, (E, B*C, d), and the
    three products are ``ops.moe_gemm`` launches: the CUDA kernel on the
    card, whose rows' bits do not depend on the other rows of the call,
    so a request decodes to the same bits whatever else shares its
    batch."""
    B, E, C, d = buf.shape
    rows = buf.transpose(0, 1).reshape(E, B * C, d).contiguous()
    h = F.silu(ops.moe_gemm(rows, w_gate)) * ops.moe_gemm(rows, w_up)
    out = ops.moe_gemm(h, w_down)
    return out.reshape(E, B, C, d).transpose(0, 1)


def moe_mlp(params, x, cfg, return_stats: bool = False):
    """x: (B, S, d) -> (B, S, d), plus the aux loss (weighted).

    ``return_stats``: also return the per-expert routed-token counts
    (E,) int32, every row's assignments counted, dropped ones and the
    inactive rows of a decode batch included: the gate statistic a
    serving edge's expert cache is fed with."""
    B, S, d = x.shape
    k = cfg.num_experts_per_tok
    E = cfg.resolved_padded_experts
    C = capacity_for(cfg, S)

    logits = x @ params["router"]
    weights, expert_id, position, keep, aux = route(logits, k, C,
                                                    cfg.num_experts)

    # ---- dispatch: per-row scatter into (B, E, C, d) capacity buffers.
    # jnp.repeat(x, k, axis=1) repeats each token k times in a row; a
    # dropped assignment lands at slot C - 1 as a zero row, so the
    # scatter adds (as JAX's .at[].add does) rather than overwrites
    row = torch.arange(B, device=x.device)[:, None].expand(B, S * k)
    eid = expert_id.reshape(B, S * k)
    pos = torch.where(keep, position, C - 1).reshape(B, S * k)
    gath = (x.repeat_interleave(k, dim=1)
            * keep.reshape(B, S * k, 1).to(x.dtype))
    buf = x.new_zeros((B, E, C, d)).index_put_((row, eid, pos), gath,
                                               accumulate=True)

    out_buf = grouped_mlp(buf, params["w_gate"], params["w_up"],
                          params["w_down"])

    # ---- combine: gather back and weight
    yk = out_buf[row, eid, pos]                          # (B, S*k, d)
    wk = (weights * keep).reshape(B, S * k, 1).to(x.dtype)
    y = (yk * wk).reshape(B, S, k, d).sum(dim=2)

    if cfg.num_shared_experts:
        sp = params["shared"]
        y = y + (F.silu(x @ sp["w_gate"]) * (x @ sp["w_up"])) @ sp["w_down"]
    if return_stats:
        counts = torch.bincount(eid.reshape(-1), minlength=E).to(torch.int32)
        return y, aux * cfg.router_aux_weight, counts
    return y, aux * cfg.router_aux_weight
