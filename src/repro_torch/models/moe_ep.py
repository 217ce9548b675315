"""Expert-parallel MoE over the mesh's ``model`` axis (the counterpart of
``repro.models.moe_ep``).

Each rank holds its batch rows whole (replicated over ``model`` and
``replica``) and its contiguous ``E / model`` experts.  A layer:

  the router's probabilities on the whole token set -> this model rank's
  slice of T_l = ceil(T / model) tokens (``EdgeMesh.slice_rows``; pad
  rows at the end are routed to the sentinel expert, ``route_probs``) ->
  scatter into the send buffer (E, cap, d) -> all-to-all over ``model``
  -> the local experts' SwiGLU on (E_l, model * cap, d), three
  ``ops.moe_gemm`` launches -> the B-MoE vote over ``replica`` when the
  config asks for it -> the return all-to-all -> combine, each token's k
  outputs weighted and summed in ``moe_mlp``'s order -> the rows gathered
  over ``model`` (``EdgeMesh.gather_rows``).

The dispatch group is the model rank's token slice, as in the JAX
package (GShard's "group = device"): the capacity is
``max(int(cf * T_l * k / E), 1)`` rounded up to 8, so which assignments
are dropped depends on the mesh.

Gradients: ``slice_rows``' backward gathers the cotangent slices, so
every model rank holds the whole gradient of the router's probabilities,
and with it of the router and of x, without a further all-reduce;
``gather_rows``' keeps this rank's rows.  The aux loss is formed from the routing statistics of
the whole token set (the same on every model rank), summed over the
batch ranks: the global batch's load-balance loss, JAX's psum'd one up to
the order of its sums, and with one batch rank ``route``'s bit for bit.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.trusted_moe import LMAttack, vote
from repro_torch.kernels import ops
from repro_torch.models.moe import (aux_from_stats, route_probs,
                                    router_probs, routing_stats,
                                    shared_experts, sum_stats, whole_router)


def ep_capacity(cfg, tokens_per_shard: int) -> int:
    """The EP dispatch capacity: ``max(int(cf * T_l * k / E), 1)`` rounded
    up to 8 over the padded expert count (not ``capacity_for``, which
    uses the real count and caps at T * k)."""
    cap = max(int(cfg.capacity_factor * tokens_per_shard
                  * cfg.num_experts_per_tok / cfg.resolved_padded_experts),
              1)
    return -(-cap // 8) * 8


def _swiglu_experts(buf, w_gate, w_up, w_down):
    """(E_l, R, d) -> (E_l, R, d) through each local expert's SwiGLU:
    three ``ops.moe_gemm`` launches."""
    h = F.silu(ops.moe_gemm(buf, w_gate)) * ops.moe_gemm(buf, w_up)
    return ops.moe_gemm(h, w_down)


def _routed(params, x, cfg, mesh, attack, vote_on: bool = True,
            shard=None):
    """The routed experts on this rank: (B, S, d) -> ((B, S, d), stats of
    the whole token set)."""
    B, S, d = x.shape
    E = cfg.resolved_padded_experts
    k = cfg.num_experts_per_tok
    m = mesh.model
    E_l = E // m.shards
    T = B * S
    T_l = -(-T // m.shards)
    lo, hi = m.row_range(T, T_l)
    n = hi - lo                                   # this rank's real rows

    # the router's softmax once, on the whole token set; the aux
    # statistics from it on every model rank, the dispatch from this
    # rank's slice of it (one softmax, so one softmax backward, as on one
    # device)
    probs = router_probs((x @ whole_router(params, shard)).reshape(T, E),
                         cfg.num_experts)
    stats = routing_stats(probs, k)
    pr = m.slice_rows(probs, T_l)
    xt = m.slice_rows(x.reshape(T, d), T_l)
    valid = None
    if n < T_l:                                   # pad rows at the end
        pr = torch.cat([pr, pr.new_zeros((T_l - n, E))])
        valid = (torch.arange(T_l, device=x.device) < n)[None]
    cap = ep_capacity(cfg, T_l)
    weights, eid, pos, keep, _ = route_probs(pr[None], k, cap, valid)
    eid = eid.reshape(T_l * k)
    pos = torch.where(keep, pos, cap - 1).reshape(T_l * k)
    keep = keep.reshape(T_l * k)
    wk = (weights.reshape(T_l * k) * keep).to(x.dtype)

    # send buffer (E, cap, d); pad rows (the sentinel id E) are left out
    real = slice(0, n * k)
    gath = xt.repeat_interleave(k, dim=0) * keep[real, None].to(x.dtype)
    send = x.new_zeros((E, cap, d)).index_put_(
        (eid[real], pos[real]), gath, accumulate=True)
    recv = m.all_to_all(send.reshape(m.shards, E_l, cap, d), "ep_dispatch")
    buf = recv.transpose(0, 1).reshape(E_l, m.shards * cap, d)
    out = _swiglu_experts(buf, params["w_gate"], params["w_up"],
                          params["w_down"])
    if vote_on and cfg.redundancy.mode != "off":
        out = vote(out, cfg.redundancy.mode, mesh, attack)
    back = out.reshape(E_l, m.shards, cap, d).transpose(0, 1)
    ret = m.all_to_all(back, "ep_return").reshape(E, cap, d)

    # combine in moe_mlp's order: each token's k outputs weighted, summed
    yk = ret[eid[real], pos[real]] * wk[real, None]
    y_loc = yk.reshape(n, k, d).sum(dim=1)
    y = m.gather_rows(y_loc, T, T_l)
    return y.reshape(B, S, d), stats


def moe_mlp_ep(params, x, cfg, mesh, attack: Optional[LMAttack] = None,
               decode: bool = False, return_stats: bool = False,
               shard=None):
    """``moe_mlp`` under a mesh: (B, S, d) -> ((B, S, d), aux weighted).

    ``params``: this rank's layer, the router whole and ``w_gate``,
    ``w_up``, ``w_down`` its ``E / model`` expert rows
    (``sharding.shard_params``); ``x``: this rank's batch rows (every
    row when ``cfg`` is not ``batch_shardable``: the statistics are then
    not summed over the batch ranks).  Raises when the model axis does
    not divide the (padded) expert count.  The shared experts run on the
    whole rows and, under redundancy, are voted too, as one pseudo-expert
    row.  ``decode``: a decode step's layer, with no vote (the JAX
    package's decode builds no trust hook) and no aux loss (decode
    discards it: 0 is returned, and the statistics are summed over the
    batch ranks only for the counts).  ``return_stats``: also the
    routed-token counts (E,) int32 of the global batch's tokens, every
    top-k assignment counted, dropped ones included, as ``moe_mlp``'s.
    ``shard``: the sharder of a placed tree (the router's experts split
    over ``model``, gathered whole here; the shared experts' ``ff`` split
    as the dense MLP's)."""
    E = cfg.resolved_padded_experts
    msize = mesh.model.shards
    if E % msize:
        raise ValueError(f"EP needs experts ({E}) % model axis ({msize}) == 0")
    if params["w_gate"].shape[0] != E // msize:
        raise ValueError(f"this rank holds {params['w_gate'].shape[0]} "
                         f"experts, the mesh deals it {E // msize}: pass "
                         f"sharding.shard_params' tree")
    y, stats = _routed(params, x, cfg, mesh, attack, not decode, shard)
    if mesh.batch_split(cfg) and (return_stats or not decode):
        stats = sum_stats(mesh.batch, stats)
    aux = (x.new_zeros(()) if decode
           else aux_from_stats(stats, E, cfg.num_experts_per_tok))
    if cfg.num_shared_experts:
        y_sh = shared_experts(params, x, shard)
        if not decode and cfg.redundancy.mode != "off" \
                and "replica" in mesh.axis_names:
            B, S, d = y_sh.shape
            y_sh = vote(y_sh.reshape(1, B * S, d), cfg.redundancy.mode,
                         mesh, attack).reshape(B, S, d)
        y = y + y_sh
    if return_stats:
        return y, aux * cfg.router_aux_weight, stats[0].to(torch.int32)
    return y, aux * cfg.router_aux_weight
