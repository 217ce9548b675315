"""Mamba-2 SSD (state-space duality, arXiv:2405.21060) layer: the
counterpart of ``repro.models.ssm``.

The full-sequence forward (training and prefill) runs the chunked dual
form through ``kernels.ops.ssd_scan`` (the hand-written CUDA kernel on the
card, from a zero state): within each chunk a quadratic, attention-like
term, and across chunks a recurrence on the (H, P, N) state.  Decode is a
single-token state update with O(1) memory.

``ssd_chunked`` is the chunked form in plain PyTorch, from any initial
state and returning the final one, the counterpart of the JAX package's
jnp form; the kernel computes what it computes from a zero state.

Tensor parallelism over ``model`` (a placed tree's ``ssm_inner``
columns, ``sharding.Sharder.tp``): the input enters through "f"
(``EdgeMesh.copy_to``), ``wz``, ``wx`` and ``conv_x`` are
column-parallel and ``out_proj`` row-parallel ("g", ``psum``); the
gated RMSNorm's sum of squares is summed over the group, and its
cotangent too (every rank applies it to its own columns).  Where
``model`` splits the heads (``ssm_heads``) each rank runs the SSD scan
on its ``H / model`` heads with its parts of ``wdt``, ``dt_bias``,
``A_log`` and ``D``; ``wB``, ``wC``, ``conv_B`` and ``conv_C`` are whole
on every rank but read by its heads only, so they enter through "f" and
their gradients are summed over the group.  Where it splits the
channels but not the heads, a rank's channels straddle heads: its part
of the convolved input is gathered whole, every rank runs every head
(B, C and dt computed alike on every rank from the input, their
gradients whole) and keeps its channels of the output.  Decode keeps
the conv history whole on every rank, as JAX's cache spec leaves it: the
new token's ``x @ wx`` columns are gathered before the history is
updated; the state holds the rank's heads.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.builder import Leaf
from repro_torch.models.layers import rmsnorm


def ssm_decl(cfg) -> dict:
    d, inner, N, H = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    w = cfg.ssm_conv_width
    return {
        "wz": Leaf((d, inner), ("embed", "ssm_inner")),
        "wx": Leaf((d, inner), ("embed", "ssm_inner")),
        "wB": Leaf((d, N), ("embed", "state")),
        "wC": Leaf((d, N), ("embed", "state")),
        "wdt": Leaf((d, H), ("embed", "ssm_heads")),
        "conv_x": Leaf((w, inner), ("conv", "ssm_inner"), scale=0.5),
        "conv_B": Leaf((w, N), ("conv", "state"), scale=0.5),
        "conv_C": Leaf((w, N), ("conv", "state"), scale=0.5),
        "A_log": Leaf((H,), ("ssm_heads",), "zeros"),
        "D": Leaf((H,), ("ssm_heads",), "ones"),
        "dt_bias": Leaf((H,), ("ssm_heads",), "zeros"),
        "norm": Leaf((inner,), ("ssm_inner",), "zeros"),
        "out_proj": Leaf((inner, d), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w):
    """Depthwise causal conv. x: (B, S, C); w: (W, C)."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    return out


def ssd_chunked(x, dt, A, Bmat, Cmat, state0, chunk):
    """Chunked SSD scan in plain PyTorch.

    x: (B, S, H, P); dt: (B, S, H); A: (H,) (negative);
    Bmat, Cmat: (B, S, N) (single group, shared across heads);
    state0: (B, H, P, N).  Returns (y (B,S,H,P), state (B,H,P,N)).
    """
    Bsz, S, H, P = x.shape
    N = Bmat.shape[-1]
    nchunks = S // chunk
    da = dt * A  # (B, S, H), negative

    xc = x.reshape(Bsz, nchunks, chunk, H, P)
    dtc = dt.reshape(Bsz, nchunks, chunk, H)
    dac = da.reshape(Bsz, nchunks, chunk, H)
    Bc = Bmat.reshape(Bsz, nchunks, chunk, N)
    Cc = Cmat.reshape(Bsz, nchunks, chunk, N)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))[None, :, :, None]
    state, ys = state0, []
    for ci in range(nchunks):
        xq, dtq, daq, Bq, Cq = (xc[:, ci], dtc[:, ci], dac[:, ci],
                                Bc[:, ci], Cc[:, ci])
        cum = torch.cumsum(daq, dim=1)  # (B, Q, H)
        # intra-chunk (dual / attention-like) term; mask BEFORE exp:
        # above-diagonal seg is positive and overflows
        seg = cum[:, :, None, :] - cum[:, None, :, :]  # (B, Q, Q, H)
        L = torch.where(causal, torch.exp(torch.where(causal, seg, 0.0)),
                        0.0)
        scores = torch.einsum("bin,bjn->bij", Cq, Bq)[..., None] * L \
            * dtq[:, None, :, :]  # (B, Q, Q, H)
        y_intra = torch.einsum("bijh,bjhp->bihp", scores, xq)
        # inter-chunk term from the carried state
        y_inter = torch.exp(cum)[..., None] * torch.einsum(
            "bin,bhpn->bihp", Cq, state)
        # state update
        total = cum[:, -1:, :]  # (B, 1, H)
        w = torch.exp(total - cum) * dtq  # (B, Q, H)
        ds = torch.einsum("bqh,bqhp,bqn->bhpn", w, xq, Bq)
        state = torch.exp(total[:, 0])[:, :, None, None] * state + ds
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(Bsz, S, H, P)
    return y, state


def _gated_norm(y, z, weight, eps, tp=None):
    """``rmsnorm(y * silu(z), weight)`` over the inner dimension; ``tp``:
    ``y``, ``z`` and ``weight`` are this rank's columns, and the sum of
    squares is summed over the group (``copy_to(psum(.))``: the
    statistic's cotangent is summed too)."""
    v = y * F.silu(z)
    if tp is None:
        return rmsnorm(v, weight, eps)
    dtype = v.dtype
    v = v.float()
    ss = tp.copy_to(tp.psum(torch.sum(v * v, dim=-1, keepdim=True),
                            "ssm_norm"), "ssm_norm_bwd")
    var = ss / (v.shape[-1] * tp.shards)
    return (v * torch.rsqrt(var + eps) * (1.0 + weight.float())).to(dtype)


def _ssm_train_tp(params, x, cfg, tp, heads: bool):
    """``ssm_train`` on this rank's ``ssm_inner`` columns (see the
    module's docstring); ``heads``: ``model`` splits the heads too."""
    B, S = x.shape[:2]
    P = cfg.ssm_head_dim
    xf = tp.copy_to(x, "ssm_in")
    z = xf @ params["wz"]
    xin = F.silu(_causal_conv(xf @ params["wx"], params["conv_x"]))
    state_w = [params[k] for k in ("wB", "wC", "conv_B", "conv_C")]
    if heads:                 # whole B and C read by this rank's heads
        src = xf
        state_w = [tp.copy_to(w, "ssm_state_w") for w in state_w]
    else:                     # every head on every rank
        src = x
        xin = tp.gather_dim(xin, -1, "ssm_gather", reduce=False)
    wB, wC, cB, cC = state_w
    Bmat = F.silu(_causal_conv(src @ wB, cB))
    Cmat = F.silu(_causal_conv(src @ wC, cC))
    dt = F.softplus(src @ params["wdt"] + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    n = A.shape[0]
    xh = xin.reshape(B, S, n, P)
    y = ops.ssd_scan(xh.float(), dt.float(), A, Bmat.float(), Cmat.float(),
                     chunk=min(cfg.ssm_chunk, S))
    y = y + params["D"].float()[None, None, :, None] * xh
    y = y.reshape(B, S, n * P).to(x.dtype)
    if not heads:
        y = tp.slice_dim(y, -1, "ssm_slice")
    y = _gated_norm(y, z, params["norm"], cfg.norm_eps, tp)
    return tp.psum(y @ params["out_proj"], "ssm_sum")


def ssm_train(params, x, cfg, shard=None):
    """x: (B, S, d) -> (B, S, d). Full-sequence (train/prefill) path.
    ``shard``: the sharder of a placed tree (tensor-parallel over
    ``model``, see the module's docstring)."""
    tp = shard.tp("ssm_inner") if shard is not None else None
    if tp is not None:
        return _ssm_train_tp(params, x, cfg, tp,
                             shard.tp("ssm_heads") is not None)
    B, S = x.shape[:2]
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    z = x @ params["wz"]
    xin = _causal_conv(x @ params["wx"], params["conv_x"])
    Bmat = _causal_conv(x @ params["wB"], params["conv_B"])
    Cmat = _causal_conv(x @ params["wC"], params["conv_C"])
    xin = F.silu(xin)
    Bmat, Cmat = F.silu(Bmat), F.silu(Cmat)
    dt = F.softplus(x @ params["wdt"] + params["dt_bias"])  # (B, S, H)
    A = -torch.exp(params["A_log"].float())
    xh = xin.reshape(B, S, H, P)
    y = ops.ssd_scan(xh.float(), dt.float(), A, Bmat.float(), Cmat.float(),
                     chunk=min(cfg.ssm_chunk, S))
    y = y + params["D"].float()[None, None, :, None] * xh
    y = y.reshape(B, S, H * P).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["out_proj"]


def _ssm_decode_tp(params, x, cache, cfg, tp, heads: bool):
    """``ssm_decode`` on this rank's ``ssm_inner`` columns: the conv
    history whole on every rank, the state the rank's heads (every head
    unless ``heads``)."""
    B = x.shape[0]
    P, N, inner = cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_inner
    w = inner // tp.shards
    lo = tp.shard * w
    xt = x[:, 0]
    z = xt @ params["wz"]
    px = torch.cat(list(tp.all_gather(xt @ params["wx"], "ssm_conv_gather")),
                   dim=-1)
    pre = torch.cat([px, xt @ params["wB"], xt @ params["wC"]], dim=-1)
    hist = torch.cat([cache["conv"], pre[:, None]], dim=1)  # (B, W, .)
    xin = F.silu((hist[..., lo:lo + w] * params["conv_x"][None]).sum(dim=1))
    if not heads:
        xin = torch.cat(list(tp.all_gather(xin, "ssm_gather")), dim=-1)
    bc = (hist[..., inner:] * torch.cat([params["conv_B"], params["conv_C"]],
                                        dim=-1)[None]).sum(dim=1)
    Bmat, Cmat = F.silu(bc[:, :N]), F.silu(bc[:, N:])
    dt = F.softplus(xt @ params["wdt"] + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())
    n = A.shape[0]
    da = torch.exp(dt * A)
    xh = xin.reshape(B, n, P).float()
    state = cache["state"] * da[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt.float(), xh, Bmat.float())
    y = torch.einsum("bn,bhpn->bhp", Cmat.float(), state)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(B, n * P).to(x.dtype)
    if not heads:
        y = y[:, lo:lo + w]
    y = _gated_norm(y, z, params["norm"], cfg.norm_eps, tp)
    out = tp.psum(y @ params["out_proj"], "ssm_sum")[:, None]
    return out, {"state": state, "conv": hist[:, 1:]}


def ssm_decode(params, x, cache, cfg, shard=None):
    """One-token decode. x: (B, 1, d).
    cache = {"state": (B,H,P,N) f32, "conv": (B, W-1, inner+2N)}.
    Returns (out (B,1,d), new_cache).  ``shard``: the sharder of a placed
    tree; the state then holds this rank's heads where ``model`` splits
    them (``sharding.shard_caches``)."""
    tp = shard.tp("ssm_inner") if shard is not None else None
    if tp is not None:
        return _ssm_decode_tp(params, x, cache, cfg, tp,
                              shard.tp("ssm_heads") is not None)
    B = x.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xt = x[:, 0]
    z = xt @ params["wz"]
    pre = torch.cat([xt @ params["wx"], xt @ params["wB"],
                     xt @ params["wC"]], dim=-1)  # (B, inner+2N)
    hist = torch.cat([cache["conv"], pre[:, None]], dim=1)  # (B, W, .)
    wfull = torch.cat([params["conv_x"], params["conv_B"],
                       params["conv_C"]], dim=-1)  # (W, inner+2N)
    conv_out = (hist * wfull[None]).sum(dim=1)
    inner = cfg.ssm_inner
    xin = F.silu(conv_out[:, :inner])
    Bmat = F.silu(conv_out[:, inner:inner + N])
    Cmat = F.silu(conv_out[:, inner + N:])
    dt = F.softplus(xt @ params["wdt"] + params["dt_bias"])  # (B, H)
    A = -torch.exp(params["A_log"].float())
    da = torch.exp(dt * A)  # (B, H)
    xh = xin.reshape(B, H, P).float()
    state = cache["state"] * da[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt.float(), xh, Bmat.float())
    y = torch.einsum("bn,bhpn->bhp", Cmat.float(), state)
    y = y + params["D"].float()[None, :, None] * xh
    y = y.reshape(B, H * P).to(x.dtype)
    y = rmsnorm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = (y @ params["out_proj"])[:, None]
    return out, {"state": state, "conv": hist[:, 1:]}
