"""Token-choice top-k sparsely-gated MoE layer (GShard-style) with
group-wise capacity dispatch, shared experts and a load-balance auxiliary
loss (the counterpart of ``repro.models.moe``).

Each batch row is a dispatch group: the capacity cumsum runs over the
row's S*k assignments.  Tokens are scattered into a per-row per-expert
capacity buffer (B, E, C, d), run through the experts' SwiGLU as three
``ops.moe_gemm`` launches over the batch folded into each expert's rows,
(E, B*C, d), and combined back with their gate weights.

``capacity_positions`` is shared with the B-MoE system's sparse dispatch.
``route_masked`` routes a token axis that may carry pad rows and returns
the routing statistics a sharded caller sums over its token shards
(``models.moe_ep``, expert parallelism on a mesh).  ``moe_mlp``'s
``trust`` hook (``core.trusted_moe.make_trust``: the B-MoE redundancy
vote over the mesh's ``replica`` axis) takes the (B, E, C, d) expert
output buffer; under a mesh with a batch axis wider than one the aux loss
is formed from the routing statistics summed over the batch ranks, so it
is the global batch's.

Over a placed tree (``sharding.Sharder.tp``) the router is gathered
whole over ``model`` (so routing, capacity and the aux statistics are
the one-device ones) and the experts run split over ``model``: with
``experts`` over it each rank runs its ``E / model`` experts on their
rows of the whole dispatch buffer and the outputs are all-gathered
before the combine (each expert's bytes do not depend on how many share
a launch, so the layer is the one-device layer's bits); with ``moe_ff``
over it each rank runs every expert on its hidden columns and the
partial down products are summed over ``model``.  The shared experts run
as the dense MLP does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.builder import Leaf
from repro_torch.models.layers import swiglu


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


def router_probs(logits: torch.Tensor, num_real: int = 0) -> torch.Tensor:
    """The router's softmax in float32, the padded experts (index >=
    ``num_real``) masked out."""
    E = logits.shape[-1]
    if num_real and num_real < E:
        pad = torch.arange(E, device=logits.device) >= num_real
        logits = logits.masked_fill(pad, -1e30)
    return torch.softmax(logits.float(), dim=-1)


def route_masked(logits: torch.Tensor, k: int, capacity: int,
                 num_real: int = 0, valid=None):
    """``route`` for a token axis that may carry pad rows, returning the
    routing statistics instead of a local aux loss.

    ``valid``: (B, S) bool (None: every row real).  Pad rows route to the
    sentinel expert E: zero gate weight, no capacity slot (their one-hot
    row is all zero, so they move no real assignment's position) and
    ``keep`` False; they are not counted in the statistics.  Returns
    weights (B,S,k), expert_id (B,S,k), position (B,S,k), keep (B,S,k)
    and ``(tok_counts (E,), prob_sums (E,), n_valid ())`` float32, which a
    sharded caller sums over its token shards before ``aux_from_stats``.
    With ``valid=None`` the first four equal ``route``'s bit for bit."""
    return route_probs(router_probs(logits, num_real), k, capacity, valid)


def route_probs(probs: torch.Tensor, k: int, capacity: int, valid=None):
    """``route_masked`` from the router's probabilities (B, S, E)
    (``router_probs``)."""
    B, S, E = probs.shape
    weights, expert_id = top_k(probs, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    if valid is None:
        position, keep, onehot = capacity_positions(
            expert_id.reshape(B, S * k), E, capacity)
        prob_sums = probs.sum(dim=(0, 1))
        n_valid = torch.tensor(float(B * S), device=probs.device)
    else:
        valid = torch.as_tensor(valid, device=probs.device)
        expert_id = torch.where(valid[:, :, None], expert_id, E)
        weights = weights * valid[:, :, None].to(weights.dtype)
        # the sentinel takes a column of its own, dropped after the
        # cumsum: a real expert's positions never count a pad row, and a
        # pad row's (its one-hot row is zero in JAX's) is 0
        position, keep, onehot = capacity_positions(
            expert_id.reshape(B, S * k), E + 1, capacity)
        onehot = onehot[..., :E]
        real = valid.repeat_interleave(k, dim=1)
        position = position * real
        keep = keep & real
        prob_sums = (probs * valid[:, :, None].to(probs.dtype)).sum(
            dim=(0, 1))
        n_valid = valid.sum().float()
    tok_counts = onehot.sum(dim=(0, 1)).float()
    return (weights, expert_id, position.reshape(B, S, k),
            keep.reshape(B, S, k), (tok_counts, prob_sums, n_valid))


def routing_stats(probs: torch.Tensor, k: int):
    """``route_masked``'s statistics of every row of the router's
    probabilities (..., E), without the capacity positions: (tok_counts
    (E,), prob_sums (E,), n_valid ()) float32."""
    E = probs.shape[-1]
    probs = probs.reshape(-1, E)
    _, expert_id = top_k(probs, k)
    counts = probs.new_zeros(E).index_add_(
        0, expert_id.reshape(-1), probs.new_ones(expert_id.numel()))
    return (counts, probs.sum(dim=0),
            torch.tensor(float(probs.shape[0]), device=probs.device))


def sum_stats(view, stats):
    """``route_masked``'s statistics summed over the ranks of one mesh
    axis (``view``, a ``launch.mesh.EdgeMesh`` over that axis's group) in
    one differentiable all-reduce (``EdgeMesh.psum``)."""
    counts, prob_sums, n_valid = stats
    E = counts.shape[0]
    flat = view.psum(torch.cat([counts, prob_sums, n_valid.reshape(1)]),
                     "aux_stats")
    return flat[:E], flat[E:2 * E], flat[2 * E]


def aux_from_stats(stats, num_experts: int, k: int) -> torch.Tensor:
    """The GShard load-balance loss of the tokens the statistics count
    (``route_masked``'s, summed over shards): E * sum(counts / (T * k) *
    prob_sums / T), T = n_valid.  On one shard's statistics it equals
    ``route``'s aux."""
    counts, prob_sums, n_valid = stats
    T = torch.clamp(n_valid, min=1.0)
    return num_experts * torch.sum((counts / (T * k)) * (prob_sums / T))


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


def _batch_mesh(shard):
    """The mesh whose batch ranks must sum routing statistics, or None."""
    mesh = getattr(shard, "mesh", None)
    return mesh if mesh is not None and mesh.batch.shards > 1 else None


def whole_router(params, shard):
    """The router (d, E), gathered over ``model`` where the placement
    splits its experts (the backward keeps this rank's columns: every
    model rank routes the same tokens alike)."""
    tp = shard.tp("experts") if shard is not None else None
    if tp is None:
        return params["router"]
    return tp.gather_dim(params["router"], 1, "router_gather", reduce=False)


def placed_experts(buf, params, shard):
    """``grouped_mlp`` of the (B, E, C, d) dispatch buffer on this rank's
    placed expert leaves; the whole output on every rank."""
    tp_e = shard.tp("experts") if shard is not None else None
    tp_f = shard.tp("moe_ff") if shard is not None else None
    w = (params["w_gate"], params["w_up"], params["w_down"])
    if tp_e is not None:
        mine = tp_e.slice_dim(buf, 1, "moe_dispatch_slice")
        out = grouped_mlp(mine, *w).contiguous()
        return tp_e.gather_dim(out, 1, "moe_experts_gather", reduce=False)
    if tp_f is not None:
        out = grouped_mlp(tp_f.copy_to(buf, "moe_in"), *w)
        return tp_f.psum(out.contiguous(), "moe_sum")
    return grouped_mlp(buf, *w)


def shared_experts(params, x, shard):
    """The shared experts' SwiGLU (``ff`` split over ``model`` over a
    placed tree, as the dense MLP)."""
    sp = params["shared"]
    return swiglu(x, sp["w_gate"], sp["w_up"], sp["w_down"],
                  tp=shard.tp("ff") if shard is not None else None)


def moe_mlp(params, x, cfg, shard=None, trust=None,
            return_stats: bool = False, decode: bool = False):
    """x: (B, S, d) -> (B, S, d), plus the aux loss (weighted).

    ``trust``: an optional hook applied to the (B, E, C, d) expert output
    buffer, the B-MoE redundancy vote (``core.trusted_moe.make_trust``).
    ``shard``: the ``sharding.Sharder`` of a mesh this rank runs on; the
    layer runs on the rank's batch rows, and with a batch axis wider than
    one its aux loss comes from the routing statistics summed over the
    batch ranks (the global batch's, as GSPMD computes it).

    ``return_stats``: also return the per-expert routed-token counts
    (E,) int32, every row's assignments counted, dropped ones and the
    inactive rows of a decode batch included: the gate statistic a
    serving edge's expert cache is fed with.  ``decode``: a decode
    step's layer, whose aux loss decode discards (its statistics are not
    summed over the batch ranks)."""
    B, S, d = x.shape
    k = cfg.num_experts_per_tok
    E = cfg.resolved_padded_experts
    C = capacity_for(cfg, S)

    logits = x @ whole_router(params, shard)
    mesh = None if decode else _batch_mesh(shard)
    if mesh is None:
        weights, expert_id, position, keep, aux = route(logits, k, C,
                                                        cfg.num_experts)
    else:
        weights, expert_id, position, keep, stats = route_masked(
            logits, k, C, cfg.num_experts)
        aux = aux_from_stats(sum_stats(mesh.batch, stats), E, k)

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

    out_buf = placed_experts(buf, params, shard)
    if trust is not None:          # B-MoE consensus on the expert outputs
        out_buf = trust(out_buf)

    # ---- combine: gather back and weight
    yk = out_buf[row, eid, pos]                          # (B, S*k, d)
    wk = (weights * keep).reshape(B, S * k, 1).to(x.dtype)
    y = (yk * wk).reshape(B, S, k, d).sum(dim=2)

    if cfg.num_shared_experts:
        y = y + shared_experts(params, x, shard)
    if return_stats:
        counts = torch.bincount(eid.reshape(-1), minlength=E).to(torch.int32)
        return y, aux * cfg.router_aux_weight, counts
    return y, aux * cfg.router_aux_weight
