"""Encoder-decoder backbone, Seamless-M4T style (the counterpart of
``repro.models.encdec``).

The modality frontend (mel-spectrogram and conv feature extractor) is a
stub: the encoder takes precomputed frame embeddings (B, S_enc, d).  The
backbone is a bidirectional encoder and a causal decoder with
cross-attention.  Whole-sequence attention (the encoder's, the decoder's
self- and cross-attention) goes through ``ops.flash_attention``; the
decoder's single-token step attends to its caches in plain PyTorch, as
the JAX package does in jnp.  The cross-attention has no rope.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.builder import Leaf, stack
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (attn_decl, attn_decode, attn_train,
                                       blockwise_attention,
                                       decode_attention, mlp_decl, rmsnorm,
                                       swiglu)
from repro_torch.models.transformer import _embed, _index
from repro_torch.sharding import cache_split


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


def _cross_attn_train(p, x, memory, cfg):
    """x: (B, Sq, d) queries; memory: (B, Sk, d)."""
    B, Sq, _ = x.shape
    Sk = memory.shape[1]
    hd = cfg.resolved_head_dim
    q = (x @ p["wq"]).reshape(B, Sq, cfg.num_heads, hd)
    k = (memory @ p["wk"]).reshape(B, Sk, cfg.num_kv_heads, hd)
    v = (memory @ p["wv"]).reshape(B, Sk, cfg.num_kv_heads, hd)
    out = blockwise_attention(q, k, v, causal=False)
    return out.reshape(B, Sq, cfg.q_dim) @ p["wo"]


def _enc_layer(params, i: int, x, cfg):
    p = _index(params["enc_blocks"], i)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    x = x + attn_train(p["attn"], h, cfg, causal=False)
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                      p["mlp"]["w_down"])


def _dec_layer(params, i: int, x, memory, cfg):
    p = _index(params["dec_blocks"], i)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    x = x + attn_train(p["attn"], h, cfg, causal=True)
    h = rmsnorm(x, p["norm_x"], cfg.norm_eps)
    x = x + _cross_attn_train(p["xattn"], h, memory, cfg)
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                      p["mlp"]["w_down"])


def encode(params, frames, cfg: ModelConfig, *, remat=False):
    """frames: (B, S_enc, d) stub embeddings -> encoder memory.
    ``remat``: each layer under ``torch.utils.checkpoint``
    (non-reentrant), as JAX checkpoints its scan body."""
    x = frames
    for i in range(cfg.num_encoder_layers):
        if remat:
            x = checkpoint(_enc_layer, params, i, x, cfg,
                           use_reentrant=False)
        else:
            x = _enc_layer(params, i, x, cfg)
    return rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def forward_train(params, frames, tokens, cfg: ModelConfig, *,
                  remat=False):
    """The full encoder-decoder forward.  frames: (B, S_enc, d) stub
    embeddings; tokens: (B, S_dec).  Returns (logits, aux = 0).
    ``remat``: every encoder and decoder layer under
    ``torch.utils.checkpoint``."""
    memory = encode(params, frames, cfg, remat=remat)
    x = _embed(params, tokens)
    for i in range(cfg.num_layers):
        if remat:
            x = checkpoint(_dec_layer, params, i, x, memory, cfg,
                           use_reentrant=False)
        else:
            x = _dec_layer(params, i, x, memory, cfg)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"],
            torch.zeros((), dtype=torch.float32, device=x.device))


def forward_decode(params, caches, tokens, pos, cfg: ModelConfig, *,
                   shard=None):
    """One decoder step against the cached self K/V and the precomputed
    cross K/V (the whole memory attended, no mask).  tokens: (B, 1).
    Returns (logits, new_caches); the caches passed in are not
    modified.  ``shard``: a mesh's sharder; ``tokens`` are then this
    rank's batch rows and ``caches`` its part (``sharding.shard_caches``:
    the self K/V split over ``cache_seq``, the cross K/V by rows only)."""
    B = tokens.shape[0]
    x = _embed(params, tokens)
    hd = cfg.resolved_head_dim
    split = cache_split(shard, cfg, 0, caches["self_k"].shape[2])
    new_k, new_v = [], []
    for i in range(cfg.num_layers):
        p = _index(params["dec_blocks"], i)
        h = rmsnorm(x, p["norm1"], cfg.norm_eps)
        y, nc = attn_decode(p["attn"], h, {"k": caches["self_k"][i],
                                           "v": caches["self_v"][i]},
                            pos, cfg, split=split)
        x = x + y
        new_k.append(nc["k"])
        new_v.append(nc["v"])
        # cross-attention against the precomputed memory K/V
        h = rmsnorm(x, p["norm_x"], cfg.norm_eps)
        q = (h @ p["xattn"]["wq"]).reshape(B, 1, cfg.num_heads, hd)
        ck, cv = caches["cross_k"][i], caches["cross_v"][i]
        y = decode_attention(q, ck, cv, ck.shape[1] - 1)
        x = x + y.reshape(B, 1, cfg.q_dim) @ p["xattn"]["wo"]
        h = rmsnorm(x, p["norm2"], cfg.norm_eps)
        x = x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"],
                       p["mlp"]["w_down"])
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    new_caches = dict(caches)
    new_caches["self_k"], new_caches["self_v"] = (torch.stack(new_k),
                                                  torch.stack(new_v))
    return x @ params["lm_head"], new_caches
