"""Decoder-only model (the counterpart of ``repro.models.transformer``):
``attn``, ``local_attn``, ``rglru`` and ``ssm`` layers, each with a dense
SwiGLU MLP, an MoE MLP (``models.moe``) or none.

Parameters and KV-caches are declared with ``repro_torch.models.builder``
exactly as the JAX package declares them (blocks stacked on a leading
axis), so a JAX tree carried across by ``convert.lm_params_from_numpy``
drops in.  Where JAX scans over the stacked blocks, the port loops in
Python over views of the leading axis.  ``forward_train`` takes the
``sharding.Sharder`` of a mesh and a ``trust`` hook: under a mesh a MoE
layer of a ``moe_impl="ep"`` config runs expert-parallel
(``moe_ep.moe_mlp_ep``, on this rank's expert rows), any other MoE layer
``moe.moe_mlp`` with the hook (the B-MoE vote) on this rank's batch rows;
on one device every MoE layer runs ``moe.moe_mlp``, as in the JAX
package.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import moe as moe_lib
from repro_torch.models import moe_ep
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.builder import Leaf, stack
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.layers import (attn_decl, attn_decode, attn_train,
                                       mlp_decl, rmsnorm, swiglu)


# ------------------------------------------------------------- decls
def layer_decl(spec: LayerSpec, cfg: ModelConfig) -> dict:
    decl = {"norm1": Leaf((cfg.d_model,), ("embed",), "zeros")}
    if spec.kind in ("attn", "local_attn"):
        decl["attn"] = attn_decl(cfg)
    elif spec.kind == "rglru":
        decl["rglru"] = rglru_lib.rglru_decl(cfg)
    elif spec.kind == "ssm":
        decl["ssm"] = ssm_lib.ssm_decl(cfg)
    else:
        raise ValueError(spec.kind)
    if spec.mlp != "none":
        decl["norm2"] = Leaf((cfg.d_model,), ("embed",), "zeros")
        decl["moe" if spec.mlp == "moe" else "mlp"] = (
            moe_lib.moe_decl(cfg) if spec.mlp == "moe" else mlp_decl(cfg))
    return decl


def model_decl(cfg: ModelConfig) -> dict:
    nb = cfg.resolved_num_blocks
    decl = {
        "embed": Leaf((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                      scale=0.02),
        "final_norm": Leaf((cfg.d_model,), ("embed",), "zeros"),
        "blocks": {str(i): stack(layer_decl(s, cfg), nb)
                   for i, s in enumerate(cfg.block_pattern)},
    }
    if cfg.remainder:
        decl["remainder"] = [layer_decl(s, cfg) for s in cfg.remainder]
    if not cfg.tie_embeddings:
        decl["lm_head"] = Leaf((cfg.d_model, cfg.padded_vocab),
                               ("embed", "vocab"), scale=0.02)
    return decl


def _attn_cache_decl(cfg: ModelConfig, batch: int, cache_len: int,
                     window: int) -> dict:
    cap = min(window, cache_len) if window else cache_len
    seq_ax = "kv_seq" if window else "cache_seq"
    shape = (batch, cap, cfg.num_kv_heads, cfg.resolved_head_dim)
    axes = ("batch", seq_ax, "kv_heads", "head_dim")
    if cfg.kv_cache_dtype == "int8":
        # absmax-quantized cache + per-slot-head scales
        sshape = (batch, cap, cfg.num_kv_heads)
        saxes = ("batch", seq_ax, "kv_heads")
        return {"k": Leaf(shape, axes, "zeros", dtype="int8"),
                "v": Leaf(shape, axes, "zeros", dtype="int8"),
                "k_scale": Leaf(sshape, saxes, "zeros", dtype="float32"),
                "v_scale": Leaf(sshape, saxes, "zeros", dtype="float32")}
    return {"k": Leaf(shape, axes, "zeros"), "v": Leaf(shape, axes, "zeros")}


def _layer_cache_decl(spec: LayerSpec, cfg: ModelConfig, batch: int,
                      cache_len: int) -> dict:
    if spec.kind == "attn":
        return _attn_cache_decl(cfg, batch, cache_len, 0)
    if spec.kind == "local_attn":
        return _attn_cache_decl(cfg, batch, cache_len, cfg.sliding_window)
    if spec.kind == "ssm":
        H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
        convdim = cfg.ssm_inner + 2 * N
        return {
            "state": Leaf((batch, H, P, N),
                          ("batch", "ssm_heads", None, "state"), "zeros"),
            "conv": Leaf((batch, cfg.ssm_conv_width - 1, convdim),
                         ("batch", "conv", None), "zeros"),
        }
    if spec.kind == "rglru":
        inner = cfg.rglru_expand * cfg.d_model
        return {
            "h": Leaf((batch, inner), ("batch", "rglru_inner"), "zeros"),
            "conv": Leaf((batch, cfg.ssm_conv_width - 1, inner),
                         ("batch", "conv", "rglru_inner"), "zeros"),
        }
    raise ValueError(spec.kind)


def cache_decl(cfg: ModelConfig, batch: int, cache_len: int) -> dict:
    nb = cfg.resolved_num_blocks
    decl = {"blocks": {str(i): stack(_layer_cache_decl(s, cfg, batch,
                                                       cache_len), nb)
                       for i, s in enumerate(cfg.block_pattern)}}
    if cfg.remainder:
        decl["remainder"] = [_layer_cache_decl(s, cfg, batch, cache_len)
                             for s in cfg.remainder]
    return decl


# ------------------------------------------- block-granular KV paging
def check_kv_pageable(cfg: ModelConfig) -> None:
    """KV paging (``storage.kv``) addresses cache ROWS by absolute
    position, which only the full-attention cache layout guarantees:
    local_attn caches are capped ring windows and rglru/ssm carry
    recurrent state that is not row-addressable.  Raises for those."""
    for spec in list(cfg.block_pattern) + list(cfg.remainder):
        if spec.kind != "attn":
            raise ValueError(
                f"kv_storage needs all-'attn' layers (row-addressable "
                f"caches); config has a {spec.kind!r} layer")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def slice_kv_block(caches, slot: int, start: int, end: int) -> dict:
    """Copy one slot's cache rows [start, end) out of every layer's KV
    leaves (the int8 ``k_scale``/``v_scale`` leaves included) as host
    numpy arrays: the tree a sealed KV block stores.  Stacked block
    caches carry a leading layer axis (batch is axis 1); remainder
    caches lead with batch."""
    block = {"blocks": _tree_map(
        lambda a: a[:, slot, start:end].cpu().numpy(), caches["blocks"])}
    if "remainder" in caches:
        block["remainder"] = _tree_map(
            lambda a: a[slot, start:end].cpu().numpy(), caches["remainder"])
    return block


def restore_kv_block(caches, slot: int, start: int, block: dict) -> dict:
    """Functional inverse of ``slice_kv_block``: a copy of ``caches``
    with a fetched block's numpy rows written into one slot at
    ``start``, on the caches' device.  ``caches`` is left as it was."""
    def put(stacked):
        def f(a, b):
            out = a.clone()
            rows = torch.from_numpy(np.array(b)).to(a.device, a.dtype)
            if stacked:              # (layers, batch, seq, ...)
                out[:, slot, start:start + rows.shape[1]] = rows
            else:                    # (batch, seq, ...)
                out[slot, start:start + rows.shape[0]] = rows
            return out
        return f

    new = {"blocks": _map2(put(True), caches["blocks"], block["blocks"])}
    if "remainder" in caches:
        new["remainder"] = [_map2(put(False), a, b) for a, b in
                            zip(caches["remainder"], block["remainder"])]
    return new


# ------------------------------------------------------------- apply
def _index(tree, i: int):
    """Layer ``i`` of a stacked tree: views of the leading axis."""
    return {k: (_index(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _stack(trees):
    first = trees[0]
    return {k: (_stack([t[k] for t in trees]) if isinstance(first[k], dict)
                else torch.stack([t[k] for t in trees]))
            for k in first}


def _map2(fn, new, old):
    return {k: (_map2(fn, new[k], old[k]) if isinstance(new[k], dict)
                else fn(new[k], old[k])) for k in new}


def _embed(params, tokens):
    return params["embed"][torch.as_tensor(tokens).to(
        params["embed"].device, torch.long)]


def _head(params, x, cfg: ModelConfig):
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


def _layers(cfg: ModelConfig):
    """(spec, block key or None, index) of every layer in order: the
    stacked blocks, then the remainder."""
    out = [(spec, str(i), b) for b in range(cfg.resolved_num_blocks)
           for i, spec in enumerate(cfg.block_pattern)]
    return out + [(spec, None, i) for i, spec in enumerate(cfg.remainder)]


def _layer_params(tree, key, i):
    return tree["remainder"][i] if key is None else _index(
        tree["blocks"][key], i)


def _mlp(spec: LayerSpec, p, x, cfg, expert_stats=False, shard=None,
         trust=None):
    """The layer's MLP on the normed residual: (y, aux, counts); aux and
    counts are None where no MoE layer gives them."""
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    if spec.mlp == "moe":
        if expert_stats:
            return moe_lib.moe_mlp(p["moe"], h, cfg, return_stats=True)
        mesh = getattr(shard, "mesh", None)
        if cfg.moe_impl == "ep" and mesh is not None:
            return (*moe_ep.moe_mlp_ep(p["moe"], h, cfg, mesh,
                                       attack=shard.attack), None)
        return (*moe_lib.moe_mlp(p["moe"], h, cfg, shard=shard,
                                 trust=trust), None)
    y = swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])
    return y, None, None


def _layer_train(spec: LayerSpec, p, x, cfg, chunks, shard=None,
                 trust=None):
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.kind in ("attn", "local_attn"):
        window = cfg.sliding_window if spec.kind == "local_attn" else 0
        y = attn_train(p["attn"], h, cfg, window=window,
                       q_chunk=chunks[0], kv_chunk=chunks[1])
    elif spec.kind == "rglru":
        y = rglru_lib.rglru_train(p["rglru"], h, cfg)
    elif spec.kind == "ssm":
        y = ssm_lib.ssm_train(p["ssm"], h, cfg)
    else:
        raise ValueError(spec.kind)
    x = x + y
    aux = None
    if spec.mlp != "none":
        y, aux, _ = _mlp(spec, p, x, cfg, shard=shard, trust=trust)
        x = x + y
    return x, aux


def _block_train(params, b: int, x, aux, cfg: ModelConfig, chunks,
                 shard=None, trust=None):
    """Stacked block ``b``: every layer of the pattern, in order."""
    for i, spec in enumerate(cfg.block_pattern):
        x, a = _layer_train(spec, _index(params["blocks"][str(i)], b), x,
                            cfg, chunks, shard, trust)
        if a is not None:
            aux = aux + a
    return x, aux


def forward_train(params, tokens, cfg: ModelConfig, *, shard=None,
                  trust=None, prefix_embeds=None, remat=False, q_chunk=512,
                  kv_chunk=512):
    """tokens: (B, S_text) integer; prefix_embeds: optional (B, P, d)
    stub modality embeddings prepended to the sequence (VLM early
    fusion).  Returns (logits (B, S, padded_vocab), aux_loss): aux is the
    sum of the MoE layers' weighted load-balance losses, a zero scalar
    without MoE layers.  ``shard``, ``trust``: the mesh's sharder and the
    MoE layers' vote hook (see the module's docstring); under a mesh
    ``tokens`` are this rank's batch rows.

    ``remat``: each stacked block of the pattern runs under
    ``torch.utils.checkpoint`` (non-reentrant), the counterpart of JAX's
    ``jax.checkpoint`` over its scan body: the backward recomputes the
    block's activations from its input, and the remainder layers keep
    theirs.  The values are the same bits either way."""
    x = _embed(params, tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    chunks = (q_chunk, kv_chunk)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for b in range(cfg.resolved_num_blocks):
        if remat:
            x, aux = checkpoint(_block_train, params, b, x, aux, cfg, chunks,
                                shard, trust, use_reentrant=False)
        else:
            x, aux = _block_train(params, b, x, aux, cfg, chunks, shard,
                                  trust)
    for i, spec in enumerate(cfg.remainder):
        x, a = _layer_train(spec, params["remainder"][i], x, cfg, chunks,
                            shard, trust)
        if a is not None:
            aux = aux + a
    return _head(params, x, cfg), aux


def _mask_rows(mask, new, old):
    """Row-select a cache leaf: rows where ``mask`` is False keep their
    old value (the slot is not advancing this step)."""
    m = mask.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def _layer_decode(spec: LayerSpec, p, cache, x, pos, cfg, expert_stats=False,
                  write_mask=None):
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.kind in ("attn", "local_attn"):
        window = cfg.sliding_window if spec.kind == "local_attn" else 0
        y, new_cache = attn_decode(p["attn"], h, cache, pos, cfg,
                                   window=window)
    elif spec.kind == "rglru":
        y, new_cache = rglru_lib.rglru_decode(p["rglru"], h, cache, cfg)
    elif spec.kind == "ssm":
        y, new_cache = ssm_lib.ssm_decode(p["ssm"], h, cache, cfg)
    else:
        raise ValueError(spec.kind)
    if write_mask is not None:
        # inactive slots must not advance KV rows or recurrent state
        new_cache = _map2(lambda n, o: _mask_rows(write_mask, n, o),
                          new_cache, cache)
    x = x + y
    counts = None
    if spec.mlp != "none":
        y, _, counts = _mlp(spec, p, x, cfg, expert_stats)
        x = x + y
    return x, new_cache, counts


def forward_decode(params, caches, tokens, pos, cfg: ModelConfig, *,
                   expert_stats=False, write_mask=None):
    """One decode step.  tokens: (B, 1); pos: int scalar (all rows at the
    same absolute position) or (B,) integer tensor (per-slot positions).
    Returns (logits (B, 1, padded_vocab), new_caches); the caches passed
    in are not modified.  With ``expert_stats`` it also returns the
    per-MoE-layer routed-token counts (num_moe_layers, E) int32 in layer
    order (the blocks first, then the remainder; every row counted, the
    inactive ones too): what a serving edge's expert cache is fed with.

    ``write_mask`` (B,) bool: rows where it is False run the (padded)
    compute but leave their KV rows and recurrent state untouched."""
    x = _embed(params, tokens)
    if write_mask is not None:
        write_mask = torch.as_tensor(write_mask, device=x.device).bool()
    new_blocks = {str(i): [] for i in range(len(cfg.block_pattern))}
    new_rem, counts = [], []
    for spec, key, i in _layers(cfg):
        x, nc, c = _layer_decode(spec, _layer_params(params, key, i),
                                 _layer_params(caches, key, i), x, pos, cfg,
                                 expert_stats, write_mask)
        (new_rem if key is None else new_blocks[key]).append(nc)
        if c is not None:
            counts.append(c)
    new_caches = {"blocks": {k: _stack(v) for k, v in new_blocks.items()}}
    if cfg.remainder:
        new_caches["remainder"] = new_rem
    logits = _head(params, x, cfg)
    if not expert_stats:
        return logits, new_caches
    stats = (torch.stack(counts) if counts else torch.zeros(
        (0, max(cfg.resolved_padded_experts, 1)), dtype=torch.int32,
        device=x.device))
    return logits, new_caches, stats


def forward_serve_chunk(params, caches, tokens, start, pos, lengths, adv,
                        cfg: ModelConfig, *, expert_stats=False):
    """Fused serving macro-step: ``C`` engine ticks in one call, a loop of
    masked greedy ``forward_decode`` micro-steps advancing every batch
    slot one position each.  Prefilling slots consume prompt tokens
    while decoding slots keep generating, and the greedy token is carried
    from step to step on the device, so nothing is read back to the host
    inside the chunk.

    tokens: (B, C) integer, slot b's next prompt tokens, left-aligned and
    zero-padded past ``lengths[b]``; start: (B,), the last token slot b
    generated (fed at the first micro-step past its prompt; 0 if none);
    pos: (B,), slot b's absolute position at micro-step 0; lengths: (B,)
    in [0, C], the prompt columns slot b consumes; adv: (B,) in [0, C],
    the micro-steps slot b advances at all (its cache writes are masked
    from step ``adv[b]`` on; 0: an idle slot, pure padding).  Host arrays
    or tensors; they are moved to the parameters' device.

    Micro-step t feeds ``tokens[:, t]`` where ``t < lengths``, else each
    slot's previous greedy output, and writes where ``t < adv``.
    Returns ``(out_tokens (C, B) int32, new_caches[, stats])`` on the
    device: ``out_tokens[t, b]`` is slot b's greedy next token after
    micro-step t.  ``stats`` (with ``expert_stats``) sums the per-MoE-
    layer routed-token counts (num_moe_layers, E) int32 over the chunk's
    micro-steps.  The caches passed in are not modified."""
    dev = params["embed"].device

    def on_dev(a):
        return torch.as_tensor(a).to(dev, torch.long)

    tokens, pos, lengths, adv = map(on_dev, (tokens, pos, lengths, adv))
    cur = on_dev(start)
    outs, total = [], None
    for t in range(tokens.shape[1]):
        feed = torch.where(t < lengths, tokens[:, t], cur)
        out = forward_decode(params, caches, feed[:, None], pos + t, cfg,
                             expert_stats=expert_stats, write_mask=t < adv)
        logits, caches = out[0], out[1]
        if expert_stats:
            total = out[2] if total is None else total + out[2]
        cur = logits[:, -1].argmax(dim=-1)
        outs.append(cur)
    outs = torch.stack(outs).to(torch.int32)
    if expert_stats:
        return outs, caches, total
    return outs, caches


class _LMLoss(torch.autograd.Function):
    """Mean cross-entropy with its gradient written out: (softmax -
    one-hot) * valid / denom, built in one logits-sized buffer (autograd
    through logsumexp and gather would hold three: at recurrentgemma-2b's
    256k vocabulary and 4,096 positions each is 4.2 GB)."""

    @staticmethod
    def forward(ctx, logits, labels, valid):
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        picked = lf.gather(-1, labels[..., None])[..., 0]
        denom = torch.clamp(valid.sum(), min=1)
        ctx.save_for_backward(logits, labels, valid, lse, denom)
        return -((picked - lse) * valid).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, labels, valid, lse, denom = ctx.saved_tensors
        grad = torch.sub(logits.float(), lse[..., None]).exp_()   # softmax
        idx = labels[..., None]
        grad.scatter_(-1, idx, grad.gather(-1, idx) - 1.0)
        grad.mul_((g * valid / denom)[..., None])
        return grad.to(logits.dtype), None, None


def lm_loss(logits, labels, mask=None):
    """Mean cross-entropy over the valid positions (the counterpart of
    JAX's ``lm_loss``).  logits (B, S, V); labels (B, S) integer, label
    < 0 ignored (a VLM's image prefix); ``mask`` (B, S) bool narrows the
    valid positions further.  In float32.  The label's logit is taken by
    ``gather`` where JAX contracts a one-hot: one term and zeros, the
    same value, without a (B, S, V) one-hot; the backward builds its
    gradient in one (B, S, V) buffer (``_LMLoss``)."""
    labels = torch.as_tensor(labels).to(logits.device, torch.long)
    valid = labels >= 0
    if mask is not None:
        valid = valid & torch.as_tensor(mask).to(logits.device, torch.bool)
    return _LMLoss.apply(logits, labels.clamp(min=0), valid)
