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


def ssm_train(params, x, cfg):
    """x: (B, S, d) -> (B, S, d). Full-sequence (train/prefill) path."""
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


def ssm_decode(params, x, cache, cfg):
    """One-token decode. x: (B, 1, d).
    cache = {"state": (B,H,P,N) f32, "conv": (B, W-1, inner+2N)}.
    Returns (out (B,1,d), new_cache)."""
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
