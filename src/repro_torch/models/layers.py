"""Core transformer layers: RMSNorm, RoPE, attention, SwiGLU (the
counterpart of ``repro.models.layers``).

Attention over a whole sequence (training forward, prefill) goes through
``kernels.ops.flash_attention``: the hand-written CUDA kernel on the card,
its plain PyTorch version on the CPU.  Single-token decode attention is
plain PyTorch, as it is plain jnp in the JAX package.

On a mesh a decode cache may hold only this rank's contiguous part of
the positions (``sharding.cache_split``): the new K/V row is written by
the rank that owns its slot, each rank scores its own slots masked by
their global index and keeps its row max, sum of exponentials and
unnormalised output, and the group all-gathers these and merges them in
rank order (a log-sum-exp combine), so every rank of the group returns
the same bits.

Tensor parallelism over ``model`` (a placed tree, ``sharding.Sharder.tp``)
is Megatron's: the input enters through ``EdgeMesh.copy_to`` ("f": its
backward sums the cotangent over ``model``), ``wq``/``wk``/``wv`` (and
their biases), ``w_gate`` and ``w_up`` are column-parallel, ``wo`` and
``w_down`` row-parallel, their partial products summed by
``EdgeMesh.psum`` ("g").  Attention needs whole heads: where ``model``
splits the q heads but not the kv heads (qwen2.5-3b's 2 kv heads on 4
ranks: half a head a rank), k and v are gathered whole (the backward
reduce-scatters) and each rank keeps the kv heads its q heads read;
where it splits neither, q, k and v are gathered whole, every rank
attends over every head and keeps its ``q_dim`` columns of the output
for ``wo``.  Decode gathers the new token's q, k and v whole on every
rank (one all-gather), runs the cache attention on every head and keeps
its columns for ``wo``: the cache holds every kv head of its positions.
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


def decode_attention(q, k_cache, v_cache, pos, *, window=0, softcap=0.0,
                     split=None):
    """Single-token attention against a cache.

    q: (B, 1, H, D); caches: (B, cap, KH, D); pos: int scalar, 0-dim or
    (B,) integer tensor — number of tokens already in the cache
    *including* the one just written at ``pos % cap`` (ring) or ``pos``
    (linear).  A vector ``pos`` gives every batch row its own decode
    position.  Entries with absolute index > pos or <= pos - window are
    masked.  The ring's absolute index uses floor-mod (``%`` on tensors
    is ``torch.remainder``), as jnp's ``%`` does.

    ``split`` = (view, lo, global capacity): the caches hold positions
    [lo, lo + cap) of a cache split over ``view``'s group; the slots are
    masked by their global index and the group's partial softmaxes are
    merged (``_combine``).  None: the caches are whole."""
    B, cap, KH, D = k_cache.shape
    H = q.shape[2]
    G = H // KH
    scale = D ** -0.5
    qh = q.reshape(B, KH, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qh.float(), k_cache.float()) * scale
    s = _softcap(s, softcap)
    lo, total = (0, cap) if split is None else split[1:]
    slot = lo + torch.arange(cap, device=q.device)
    p_ = torch.as_tensor(pos, device=q.device).reshape(-1, 1)  # (B|1, 1)
    if window:  # ring buffer: absolute index of slot i
        absidx = p_ - ((p_ - slot[None, :]) % total)
        valid = (absidx >= 0) & (absidx <= p_) & (absidx > p_ - window)
    else:
        valid = slot[None, :] <= p_
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    if split is None:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype), v_cache)
        return out.reshape(B, 1, H, D)
    # this rank's partial softmax: its row max, sum of exponentials and
    # unnormalised output; a rank whose slots are all masked gives zeros
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(valid, torch.exp(s - m), torch.zeros((), device=q.device))
    o = torch.einsum("bhgk,bkhd->bhgd", e.to(v_cache.dtype), v_cache)
    out = _combine(split[0], m, e.sum(dim=-1, keepdim=True), o.float())
    return out.to(v_cache.dtype).reshape(B, 1, H, D)


def _combine(view, m, l, o):
    """The log-sum-exp merge of the group's partial softmaxes: (B, KH, G,
    1) row max ``m`` and sum ``l``, (B, KH, G, D) unnormalised output
    ``o`` on each rank -> the normalised output.  One all-gather; the
    ranks' parts are summed in rank order, so every rank computes the same
    bits.  A part whose slots were all masked (max ``NEG_INF``, sum and
    output zero) adds exactly zero: its weight exp(NEG_INF - max) is 0."""
    parts = view.all_gather(torch.cat([m, l, o], dim=-1), "cache_combine")
    top = parts[..., :1].amax(dim=0)
    num = den = None
    for w in range(parts.shape[0]):
        a = torch.exp(parts[w, ..., :1] - top)
        den = a * parts[w, ..., 1:2] if den is None else \
            den + a * parts[w, ..., 1:2]
        num = a * parts[w, ..., 2:] if num is None else \
            num + a * parts[w, ..., 2:]
    return num / den


# ----------------------------------------------------------------- MLP
def swiglu(x, w_gate, w_up, w_down, tp=None):
    """SwiGLU; ``tp`` (the ``model`` view of a placed tree): the rank's
    ``ff`` columns of ``w_gate``/``w_up`` and rows of ``w_down``, the
    partial products summed over the group."""
    if tp is not None:
        x = tp.copy_to(x, "mlp_in")
    h = F.silu(x @ w_gate) * (x @ w_up)
    if tp is None:
        return h @ w_down
    return tp.psum(h @ w_down, "mlp_sum")


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
def _project(params, x, cfg):
    """x @ wq, wk, wv plus the biases: (B, S, columns) each (the rank's
    columns of a placed tree)."""
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _heads(params, t, positions, cfg, norm: str):
    """(B, S, n * hd) -> (B, S, n, hd), normed (``qk_norm``) and
    rotated."""
    B, S, _ = t.shape
    t = t.reshape(B, S, -1, cfg.resolved_head_dim)
    if cfg.qk_norm:
        t = rmsnorm(t, params[norm], cfg.norm_eps)
    return rope(t, positions, cfg.rope_theta)


def attn_qkv(params, x, positions, cfg):
    q, k, v = _project(params, x, cfg)
    B, S, _ = x.shape
    return (_heads(params, q, positions, cfg, "q_norm"),
            _heads(params, k, positions, cfg, "k_norm"),
            v.reshape(B, S, cfg.num_kv_heads, cfg.resolved_head_dim))


def _kv_for_heads(k, v, lo: int, n: int, cfg):
    """The kv heads of whole (B, S, KH, D) ``k`` and ``v`` that q heads
    [lo, lo + n) read, laid out for grouped attention over them."""
    G = cfg.num_heads // cfg.num_kv_heads
    first = lo // G
    if G % n == 0 and lo % G + n <= G:       # the rank's heads in one group
        return k[:, :, first:first + 1], v[:, :, first:first + 1]
    if n % G == 0 and lo % G == 0:           # whole groups
        return (k[:, :, first:first + n // G],
                v[:, :, first:first + n // G])
    idx = torch.arange(lo, lo + n, device=k.device) // G
    return k[:, :, idx], v[:, :, idx]        # one kv head a q head


def tp_kv_cover(tp, q, k, v, cfg):
    """Column-parallel (B, S, columns) ``q``, ``k``, ``v`` made to cover
    whole heads: where ``model`` splits the q heads but not the kv heads,
    k and v are gathered whole (the backward reduce-scatters); where it
    splits neither, q, k and v are gathered whole.  Returns (q, k, v,
    whole_heads): whether each rank attends its own q heads."""
    m = tp.shards
    whole_heads = cfg.num_heads % m == 0
    if not whole_heads:                      # every rank attends every head
        q = tp.gather_dim(q, -1, "attn_gather", reduce=False)
    if cfg.num_kv_heads % m:                 # part of a kv head a rank
        k = tp.gather_dim(k, -1, "attn_gather", reduce=whole_heads)
        v = tp.gather_dim(v, -1, "attn_gather", reduce=whole_heads)
    return q, k, v, whole_heads


def tp_attend(tp, q, k, v, cfg, whole_heads, **kw):
    """``blockwise_attention`` of (B, S, n, D) heads from
    ``tp_kv_cover``: the rank's q heads against the kv heads they read,
    or every head, then the rank's ``q_dim`` columns kept.  Returns (B,
    S, q_dim / model)."""
    B, S = q.shape[:2]
    if whole_heads and cfg.num_kv_heads % tp.shards:
        n = q.shape[2]
        k, v = _kv_for_heads(k, v, tp.shard * n, n, cfg)
    out = blockwise_attention(q, k, v, **kw).reshape(B, S, -1)
    if not whole_heads:
        out = tp.slice_dim(out, -1, "attn_slice")
    return out


def attn_train(params, x, cfg, *, window=0, causal=True, q_chunk=512,
               kv_chunk=512, shard=None):
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    tp = shard.tp("q_dim") if shard is not None else None
    if tp is None:
        q, k, v = attn_qkv(params, x, positions, cfg)
        out = blockwise_attention(q, k, v, causal=causal, window=window,
                                  softcap=cfg.attn_logit_softcap,
                                  q_chunk=q_chunk, kv_chunk=kv_chunk)
        return out.reshape(B, S, cfg.q_dim) @ params["wo"]
    q, k, v = _project(params, tp.copy_to(x, "attn_in"), cfg)
    q, k, v, whole_heads = tp_kv_cover(tp, q, k, v, cfg)
    if cfg.qk_norm and whole_heads:
        # the norms act on this rank's heads only: "f" sums their
        # gradients over the group
        params = dict(params, q_norm=tp.copy_to(params["q_norm"], "qk_norm"),
                      k_norm=tp.copy_to(params["k_norm"], "qk_norm"))
    q = _heads(params, q, positions, cfg, "q_norm")
    k = _heads(params, k, positions, cfg, "k_norm")
    v = v.reshape(B, S, -1, cfg.resolved_head_dim)
    out = tp_attend(tp, q, k, v, cfg, whole_heads, causal=causal,
                    window=window, softcap=cfg.attn_logit_softcap,
                    q_chunk=q_chunk, kv_chunk=kv_chunk)
    return tp.psum(out @ params["wo"], "attn_sum")


def _quantize_kv(t):
    """t: (B, 1, KH, D) -> (int8 values, (B, 1, KH) f32 scales).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    scale = torch.amax(torch.abs(t.float()), dim=-1) / 127.0
    scale = torch.clamp(scale, min=1e-8)
    q = torch.clamp(torch.round(t.float() / scale[..., None]),
                    -127, 127).to(torch.int8)
    return q, scale


def _gather_columns(tp, parts):
    """Each of ``parts`` (..., the rank's columns) whole on every rank of
    ``tp``, by one all-gather of their concatenation."""
    widths = [p.shape[-1] for p in parts]
    got = tp.all_gather(torch.cat(parts, dim=-1), "attn_decode_gather")
    out, at = [], 0
    for w in widths:
        out.append(torch.cat([got[r, ..., at:at + w]
                              for r in range(tp.shards)], dim=-1))
        at += w
    return out


def attn_decode(params, x, cache, pos, cfg, *, window=0, split=None,
                shard=None):
    """One-token decode. cache: {"k": (B,cap,KH,D), "v": ...} (+ int8
    "k_scale"/"v_scale" when cfg.kv_cache_dtype == "int8").

    ``pos`` is an int scalar (every row at the same depth) or a (B,)
    integer tensor (continuous batching: each row writes and reads its own
    cache slot).  The linear cache writes at ``min(pos, cap - 1)``, the
    ring at ``pos % cap``.  The old cache is left as it was: the new one
    is a copy with the row written.  ``split`` (``sharding.cache_split``):
    the cache holds this rank's positions of a split one; the slot is
    taken in the global cache and written only by the rank that holds it
    (``decode_attention`` merges the ranks' scores).  ``shard``: the
    sharder of a placed tree; under tensor parallelism the new token's
    q, k and v are gathered whole first, and the output's ``q_dim``
    columns of this rank go through its rows of ``wo``.  Returns (out,
    new_cache)."""
    B = x.shape[0]
    pos_t = torch.as_tensor(pos, device=x.device).long()
    positions = pos_t.reshape(-1, 1).expand(B, 1)
    tp = shard.tp("q_dim") if shard is not None else None
    if tp is None:
        q, k, v = attn_qkv(params, x, positions, cfg)
    else:
        q, k, v = _gather_columns(tp, list(_project(params, x, cfg)))
        q = _heads(params, q, positions, cfg, "q_norm")
        k = _heads(params, k, positions, cfg, "k_norm")
        v = v.reshape(B, 1, cfg.num_kv_heads, cfg.resolved_head_dim)
    cap = cache["k"].shape[1]
    lo, total = (0, cap) if split is None else split[1:]
    slot = (pos_t % total) if window else torch.clamp(pos_t, max=total - 1)
    slot = slot.reshape(-1).expand(B)
    rows = torch.arange(B, device=x.device)
    own = (slot >= lo) & (slot < lo + cap)      # every row on one device
    local = torch.clamp(slot - lo, 0, cap - 1)

    def put(buf, val):           # row b writes slot[b] where this rank holds it
        out = buf.clone()
        keep = own.reshape((B,) + (1,) * (val.dim() - 2))
        out[rows, local] = torch.where(keep, val[:, 0], out[rows, local])
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
                           softcap=cfg.attn_logit_softcap, split=split)
    out = out.reshape(B, 1, cfg.q_dim)
    if tp is None:
        return out @ params["wo"], new_cache
    n = cfg.q_dim // tp.shards
    out = out.narrow(-1, tp.shard * n, n)
    return tp.psum(out @ params["wo"], "attn_sum"), new_cache
