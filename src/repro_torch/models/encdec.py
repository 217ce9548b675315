"""Encoder-decoder backbone, Seamless-M4T style (the counterpart of
``repro.models.encdec``).

The modality frontend (mel-spectrogram and conv feature extractor) is a
stub: the encoder takes precomputed frame embeddings (B, S_enc, d).  The
backbone is a bidirectional encoder and a causal decoder with
cross-attention.  Whole-sequence attention (the encoder's, the decoder's
self- and cross-attention) goes through ``ops.flash_attention``; the
decoder's single-token step attends to its caches in plain PyTorch, as
the JAX package does in jnp.  The cross-attention has no rope.

Over a placed tree (``sharding.step_sharder``) the model runs as the
decoder-only one does (``models.transformer``): each layer gathers its
leaves' FSDP parts whole inside its remat region, self-attention and
the MLP run tensor-parallel over ``model`` (``models.layers``), the
cross-attention is column-parallel over ``q_dim``/``kv_dim`` with ``wo``
row-parallel (the encoder memory enters the decoder through "f" once),
and the embedding, head and loss are vocabulary-parallel.  The cross
K/V cache is whole over heads on every rank (JAX's cache rules leave
``kv_heads`` whole): ``cross_kv`` fills it from ``encode``, and each
rank's decode step reads the kv heads its q heads attend.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.builder import Leaf, stack
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (_kv_for_heads, attn_decl,
                                       attn_decode, attn_train,
                                       blockwise_attention,
                                       decode_attention, mlp_decl, rmsnorm,
                                       swiglu, tp_attend, tp_kv_cover)
from repro_torch.models.transformer import _embed, _head, _index
from repro_torch.sharding import cache_split, fsdp_gather


def _enc_layer_decl(cfg):
    return {
        "norm1": Leaf((cfg.d_model,), ("embed",), "zeros"),
        "attn": attn_decl(cfg),
        "norm2": Leaf((cfg.d_model,), ("embed",), "zeros"),
        "mlp": mlp_decl(cfg),
    }


def _dec_layer_decl(cfg):
    return {
        "norm1": Leaf((cfg.d_model,), ("embed",), "zeros"),
        "attn": attn_decl(cfg),
        "norm_x": Leaf((cfg.d_model,), ("embed",), "zeros"),
        "xattn": attn_decl(cfg),
        "norm2": Leaf((cfg.d_model,), ("embed",), "zeros"),
        "mlp": mlp_decl(cfg),
    }


def encdec_decl(cfg: ModelConfig) -> dict:
    return {
        "embed": Leaf((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                      scale=0.02),
        "enc_blocks": stack(_enc_layer_decl(cfg), cfg.num_encoder_layers),
        "dec_blocks": stack(_dec_layer_decl(cfg), cfg.num_layers),
        "enc_norm": Leaf((cfg.d_model,), ("embed",), "zeros"),
        "final_norm": Leaf((cfg.d_model,), ("embed",), "zeros"),
        "lm_head": Leaf((cfg.d_model, cfg.padded_vocab), ("embed", "vocab"),
                        scale=0.02),
    }


def encdec_cache_decl(cfg: ModelConfig, batch: int, cache_len: int,
                      memory_len: int) -> dict:
    """Decoder self-attention KV cache + precomputed cross K/V."""
    hd = cfg.resolved_head_dim
    L = cfg.num_layers
    self_kv = Leaf((L, batch, cache_len, cfg.num_kv_heads, hd),
                   ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
                   "zeros")
    cross_kv = Leaf((L, batch, memory_len, cfg.num_kv_heads, hd),
                    ("layers", "batch", None, "kv_heads", "head_dim"),
                    "zeros")
    return {"self_k": self_kv, "self_v": self_kv,
            "cross_k": cross_kv, "cross_v": cross_kv}


def _tp(shard, axis: str):
    return shard.tp(axis) if shard is not None else None


def _fsdp(tree, decl, shard):
    """``tree`` with its FSDP parts gathered whole (``tree`` without
    FSDP)."""
    if getattr(shard, "fsdp_view", None) is None:
        return tree
    return fsdp_gather(tree, decl, shard)


def _top(params, cfg, shard, keys):
    """The top-level leaves ``keys``, FSDP-gathered whole."""
    decl = encdec_decl(cfg)
    return _fsdp({k: params[k] for k in keys}, {k: decl[k] for k in keys},
                 shard)


def _mlp(p, h, shard):
    return swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                  p["mlp"]["w_down"], tp=_tp(shard, "ff"))


def _cross_attn_train(p, x, memory, cfg, shard=None):
    """x: (B, Sq, d) queries; memory: (B, Sk, d) (over a placed tree
    already through "f": its cotangent is summed over ``model`` once,
    in ``forward_train``)."""
    B, Sq, _ = x.shape
    Sk = memory.shape[1]
    hd = cfg.resolved_head_dim
    tp = _tp(shard, "q_dim")
    if tp is None:
        q = (x @ p["wq"]).reshape(B, Sq, cfg.num_heads, hd)
        k = (memory @ p["wk"]).reshape(B, Sk, cfg.num_kv_heads, hd)
        v = (memory @ p["wv"]).reshape(B, Sk, cfg.num_kv_heads, hd)
        out = blockwise_attention(q, k, v, causal=False)
        return out.reshape(B, Sq, cfg.q_dim) @ p["wo"]
    q, k, v, whole = tp_kv_cover(tp, tp.copy_to(x, "xattn_in") @ p["wq"],
                                 memory @ p["wk"], memory @ p["wv"], cfg)
    out = tp_attend(tp, q.reshape(B, Sq, -1, hd), k.reshape(B, Sk, -1, hd),
                    v.reshape(B, Sk, -1, hd), cfg, whole, causal=False)
    return tp.psum(out @ p["wo"], "attn_sum")


def _enc_layer(params, i: int, x, cfg, shard=None):
    p = _fsdp(_index(params["enc_blocks"], i), _enc_layer_decl(cfg), shard)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    x = x + attn_train(p["attn"], h, cfg, causal=False, shard=shard)
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + _mlp(p, h, shard)


def _dec_layer(params, i: int, x, memory, cfg, shard=None):
    p = _fsdp(_index(params["dec_blocks"], i), _dec_layer_decl(cfg), shard)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    x = x + attn_train(p["attn"], h, cfg, causal=True, shard=shard)
    h = rmsnorm(x, p["norm_x"], cfg.norm_eps)
    x = x + _cross_attn_train(p["xattn"], h, memory, cfg, shard)
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + _mlp(p, h, shard)


def encode(params, frames, cfg: ModelConfig, *, shard=None, remat=False):
    """frames: (B, S_enc, d) stub embeddings -> encoder memory.
    ``remat``: each layer under ``torch.utils.checkpoint``
    (non-reentrant), as JAX checkpoints its scan body.  ``shard``: the
    sharder of a placed tree (``frames`` this rank's batch rows)."""
    x = frames
    for i in range(cfg.num_encoder_layers):
        if remat:
            x = checkpoint(_enc_layer, params, i, x, cfg, shard,
                           use_reentrant=False)
        else:
            x = _enc_layer(params, i, x, cfg, shard)
    top = _top(params, cfg, shard, ("enc_norm",))
    return rmsnorm(x, top["enc_norm"], cfg.norm_eps)


def _logits(params, x, cfg, shard):
    """Logits (this rank's vocabulary columns over a placed tree)."""
    return _head(_top(params, cfg, shard, ("final_norm", "lm_head")), x, cfg,
                 shard)


def _embed_tokens(params, tokens, cfg, shard):
    return _embed(_top(params, cfg, shard, ("embed",)), tokens, shard)


def forward_train(params, frames, tokens, cfg: ModelConfig, *,
                  shard=None, remat=False):
    """The full encoder-decoder forward.  frames: (B, S_enc, d) stub
    embeddings; tokens: (B, S_dec).  Returns (logits, aux = 0).
    ``remat``: every encoder and decoder layer under
    ``torch.utils.checkpoint``.  ``shard``: the sharder of a placed tree
    (see the module's docstring); ``frames`` and ``tokens`` are then this
    rank's batch rows and the logits its vocabulary columns."""
    memory = encode(params, frames, cfg, shard=shard, remat=remat)
    tp = _tp(shard, "q_dim")
    if tp is not None:
        memory = tp.copy_to(memory, "xattn_memory")
    x = _embed_tokens(params, tokens, cfg, shard)
    for i in range(cfg.num_layers):
        if remat:
            x = checkpoint(_dec_layer, params, i, x, memory, cfg, shard,
                           use_reentrant=False)
        else:
            x = _dec_layer(params, i, x, memory, cfg, shard)
    return (_logits(params, x, cfg, shard),
            torch.zeros((), dtype=torch.float32, device=x.device))


def cross_kv(params, memory, cfg: ModelConfig, *, shard=None):
    """The cross K/V cache leaves from ``encode``'s memory (B, S_enc, d):
    (L, B, S_enc, KH, hd) each, whole over heads on every rank (a placed
    tree's ``kv_dim`` columns gathered over ``model``).  No gradient."""
    B, Sk, _ = memory.shape
    tp = _tp(shard, "kv_dim")
    decl = _dec_layer_decl(cfg)["xattn"]
    ks, vs = [], []
    with torch.no_grad():
        for i in range(cfg.num_layers):
            p = _fsdp(_index(params["dec_blocks"], i)["xattn"], decl, shard)
            k, v = memory @ p["wk"], memory @ p["wv"]
            if tp is not None:
                k, v = (torch.cat(list(tp.all_gather(t, "cross_kv")), dim=-1)
                        for t in (k, v))
            ks.append(k.reshape(B, Sk, cfg.num_kv_heads,
                                cfg.resolved_head_dim))
            vs.append(v.reshape(B, Sk, cfg.num_kv_heads,
                                cfg.resolved_head_dim))
    return torch.stack(ks), torch.stack(vs)


def _cross_attn_decode(p, h, ck, cv, cfg, tp):
    """The decoder token's attention to the whole memory's cross K/V
    (every kv head on every rank): over a placed tree each rank reads the
    kv heads its q heads attend, or (heads not split) every head from the
    gathered q, and keeps its ``q_dim`` columns for ``wo``."""
    B = h.shape[0]
    hd = cfg.resolved_head_dim
    q = h @ p["wq"]
    last = ck.shape[1] - 1
    if tp is None:
        y = decode_attention(q.reshape(B, 1, cfg.num_heads, hd), ck, cv, last)
        return y.reshape(B, 1, cfg.q_dim) @ p["wo"]
    if cfg.num_heads % tp.shards == 0:
        n = cfg.num_heads // tp.shards
        k, v = _kv_for_heads(ck, cv, tp.shard * n, n, cfg)
        y = decode_attention(q.reshape(B, 1, n, hd), k, v, last)
        y = y.reshape(B, 1, -1)
    else:
        q = torch.cat(list(tp.all_gather(q, "xattn_decode_gather")), dim=-1)
        y = decode_attention(q.reshape(B, 1, cfg.num_heads, hd), ck, cv, last)
        n = cfg.q_dim // tp.shards
        y = y.reshape(B, 1, cfg.q_dim).narrow(-1, tp.shard * n, n)
    return tp.psum(y @ p["wo"], "attn_sum")


def forward_decode(params, caches, tokens, pos, cfg: ModelConfig, *,
                   shard=None):
    """One decoder step against the cached self K/V and the precomputed
    cross K/V (the whole memory attended, no mask).  tokens: (B, 1).
    Returns (logits, new_caches); the caches passed in are not
    modified.  ``shard``: a mesh's sharder; ``tokens`` are then this
    rank's batch rows and ``caches`` its part (``sharding.shard_caches``:
    the self K/V split over ``cache_seq``, the cross K/V by rows only),
    and over a placed tree the logits are its vocabulary columns."""
    x = _embed_tokens(params, tokens, cfg, shard)
    split = cache_split(shard, cfg, 0, caches["self_k"].shape[2])
    tp = _tp(shard, "q_dim")
    new_k, new_v = [], []
    for i in range(cfg.num_layers):
        p = _fsdp(_index(params["dec_blocks"], i), _dec_layer_decl(cfg),
                  shard)
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        y, nc = attn_decode(p["attn"], h, {"k": caches["self_k"][i],
                                           "v": caches["self_v"][i]},
                            pos, cfg, split=split, shard=shard)
        x = x + y
        new_k.append(nc["k"])
        new_v.append(nc["v"])
        h = rmsnorm(x, p["norm_x"], cfg.norm_eps)
        x = x + _cross_attn_decode(p["xattn"], h, caches["cross_k"][i],
                                   caches["cross_v"][i], cfg, tp)
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        x = x + _mlp(p, h, shard)
    new_caches = dict(caches)
    new_caches["self_k"], new_caches["self_v"] = (torch.stack(new_k),
                                                  torch.stack(new_v))
    return _logits(params, x, cfg, shard), new_caches
