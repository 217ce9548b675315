"""Core transformer layers: RMSNorm, RoPE, attention, SwiGLU (the
counterpart of ``repro.models.layers``).

Attention over a whole sequence (training forward, prefill) goes through
``kernels.ops.flash_attention``: the hand-written CUDA kernel on the card,
its plain PyTorch version on the CPU.  Single-token decode attention is
plain PyTorch, as it is plain jnp in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.builder import Leaf

NEG_INF = -1e30


# ----------------------------------------------------------------- norms
def rmsnorm(x, weight, eps=1e-6):
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + weight.float())
    return out.to(dtype)


# ------------------------------------------------------------------ rope
def rope(x, positions, theta=10_000.0):
    """x: (..., S, H, D) rotated at absolute ``positions`` (..., S).  The
    two halves of the head dim are rotated against each other (not
    interleaved pairs); frequencies and angles in float32."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions[..., :, None].float() * freqs  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------- attention
def _softcap(scores, cap):
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def blockwise_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                        q_offset=0, q_chunk=512, kv_chunk=512):
    """Online-softmax attention through ``ops.flash_attention``.

    q: (B, Sq, H, D); k, v: (B, Sk, KH, D) with H = KH * G.
    ``window`` > 0 limits attention to the last ``window`` keys (sliding
    window, inclusive of self).  ``q_offset``: absolute position of q[0]
    relative to k[0] (for chunked prefill; 0 for plain self-attention).
    ``q_chunk`` and ``kv_chunk`` are tiling knobs of the JAX package's jnp
    twin; the kernel sizes its own tiles, so they are accepted and
    ignored.  Returns (B, Sq, H, D)."""
    del q_chunk, kv_chunk
    return ops.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, pos, *, window=0, softcap=0.0):
    """Single-token attention against a cache.

    q: (B, 1, H, D); caches: (B, cap, KH, D); pos: int scalar, 0-dim or
    (B,) integer tensor — number of tokens already in the cache
    *including* the one just written at ``pos % cap`` (ring) or ``pos``
    (linear).  A vector ``pos`` gives every batch row its own decode
    position.  Entries with absolute index > pos or <= pos - window are
    masked.  The ring's absolute index uses floor-mod (``%`` on tensors
    is ``torch.remainder``), as jnp's ``%`` does."""
    B, cap, KH, D = k_cache.shape
    H = q.shape[2]
    G = H // KH
    scale = D ** -0.5
    qh = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qh.float(), k_cache.float()) * scale
    s = _softcap(s, softcap)
    slot = torch.arange(cap, device=q.device)
    p_ = torch.as_tensor(pos, device=q.device).reshape(-1, 1)  # (B|1, 1)
    if window:  # ring buffer: absolute index of slot i
        absidx = p_ - ((p_ - slot[None, :]) % cap)
        valid = (absidx >= 0) & (absidx <= p_) & (absidx > p_ - window)
    else:
        valid = slot[None, :] <= p_
    s = torch.where(valid[:, None, None, :], s,
                    torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, D)


# ----------------------------------------------------------------- MLP
def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


# ------------------------------------------------------- declarations
def attn_decl(cfg) -> dict:
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.resolved_head_dim
    decl = {
        "wq": Leaf((d, qd), ("embed", "q_dim")),
        "wk": Leaf((d, kvd), ("embed", "kv_dim")),
        "wv": Leaf((d, kvd), ("embed", "kv_dim")),
        "wo": Leaf((qd, d), ("q_dim", "embed")),
    }
    if cfg.qkv_bias:
        decl["bq"] = Leaf((qd,), ("q_dim",), "zeros")
        decl["bk"] = Leaf((kvd,), ("kv_dim",), "zeros")
        decl["bv"] = Leaf((kvd,), ("kv_dim",), "zeros")
    if cfg.qk_norm:
        decl["q_norm"] = Leaf((hd,), ("head_dim",), "zeros")
        decl["k_norm"] = Leaf((hd,), ("head_dim",), "zeros")
    return decl


def mlp_decl(cfg) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": Leaf((d, f), ("embed", "ff")),
        "w_up": Leaf((d, f), ("embed", "ff")),
        "w_down": Leaf((f, d), ("ff", "embed")),
    }


# -------------------------------------------------------------- apply
def attn_qkv(params, x, positions, cfg):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, S, cfg.num_kv_heads, hd)
    v = v.reshape(B, S, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, params["k_norm"], cfg.norm_eps)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_train(params, x, cfg, *, window=0, causal=True, q_chunk=512,
               kv_chunk=512):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = attn_qkv(params, x, positions, cfg)
    out = blockwise_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_logit_softcap,
                              q_chunk=q_chunk, kv_chunk=kv_chunk)
    return out.reshape(B, S, cfg.q_dim) @ params["wo"]


def _quantize_kv(t):
    """t: (B, 1, KH, D) -> (int8 values, (B, 1, KH) f32 scales).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    scale = torch.amax(torch.abs(t.float()), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(t.float() / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


def attn_decode(params, x, cache, pos, cfg, *, window=0):
    """One-token decode. cache: {"k": (B,cap,KH,D), "v": ...} (+ int8
    "k_scale"/"v_scale" when cfg.kv_cache_dtype == "int8").

    ``pos`` is an int scalar (every row at the same depth) or a (B,)
    integer tensor (continuous batching: each row writes and reads its own
    cache slot).  The linear cache writes at ``min(pos, cap - 1)``, the
    ring at ``pos % cap``.  The old cache is left as it was: the new one
    is a copy with the row written.  Returns (out, new_cache)."""
    B = x.shape[0]
    pos_t = torch.as_tensor(pos, device=x.device).long()
    positions = pos_t.reshape(-1, 1).expand(B, 1)
    q, k, v = attn_qkv(params, x, positions, cfg)
    cap = cache["k"].shape[1]
    slot = (pos_t % cap) if window else torch.clamp(pos_t, max=cap - 1)
    slot = slot.reshape(-1).expand(B)
    rows = torch.arange(B, device=x.device)

    def put(buf, val):           # row b writes slot[b]
        out = buf.clone()
        out[rows, slot] = val[:, 0]
        return out

    if "k_scale" in cache:      # int8 cache: absmax values + scales
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        new_cache = {
            "k": put(cache["k"], kq),
            "v": put(cache["v"], vq),
            "k_scale": put(cache["k_scale"], ks),
            "v_scale": put(cache["v_scale"], vs),
        }
        k_cache = (new_cache["k"].float()
                   * new_cache["k_scale"][..., None]).to(x.dtype)
        v_cache = (new_cache["v"].float()
                   * new_cache["v_scale"][..., None]).to(x.dtype)
    else:
        k_cache = put(cache["k"], k)
        v_cache = put(cache["v"], v)
        new_cache = {"k": k_cache, "v": v_cache}
    out = decode_attention(q, k_cache, v_cache, pos_t, window=window,
                           softcap=cfg.attn_logit_softcap)
    out = out.reshape(B, 1, cfg.q_dim) @ params["wo"]
    return out, new_cache
