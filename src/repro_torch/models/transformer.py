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
package.  ``forward_decode`` and ``forward_serve_chunk`` take the
sharder too: the caches are then this rank's (``sharding.shard_caches``),
attention merges the ranks' parts of a split cache, and the MoE layers
run as in training but never vote (the JAX package's decode builds no
trust hook), their routed-token counts those of the global batch.

Over a placed tree (``sharding.step_sharder``) each layer gathers its
leaves' ``embed`` dimension whole over the batch ranks first
(``sharding.fsdp_gather``, inside a block's remat region, so the
backward gathers again instead of keeping whole leaves alive), and the
layers run tensor-parallel over ``model`` (``models.layers``,
``models.moe``, ``models.ssm``, ``models.rglru``).  The vocabulary is
split over ``model`` too: the embedding looks up the rank's rows (zeros
for the others) and sums over the group, which adds one value to zeros
and is exact; the head gives this rank's vocabulary columns of the
logits, which ``lm_loss`` (its cross-entropy reduced over the group) and
``vocab_argmax`` take as they are, and ``gather_vocab`` pieces together
whole.
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
from repro_torch.sharding import cache_split, cache_views, fsdp_gather


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


def _block_views(cfg, mesh):
    """(batch view, position view) a KV leaf of an all-'attn' cache is
    split over on ``mesh``, each None when whole."""
    if mesh is None:
        return None, None
    return tuple(cache_views(cfg, mesh, ("batch", "cache_seq")))


def _placed_rows(a, lead: int, slot: int, start: int, end: int, views):
    """Global slot ``slot``'s positions [start, end) of a placed KV leaf
    ``a`` (batch at dim ``lead``, positions after it) on every rank: each
    rank sends what it holds (zeros elsewhere), the position group's
    parts are pieced together in rank order, then the batch group's part
    that holds the slot is taken.  Collective over both groups."""
    bview, sview = views
    n_rows, cap = a.shape[lead], a.shape[lead + 1]
    r = slot - (bview.shard * n_rows if bview is not None else 0)
    shape = a.shape[:lead] + a.shape[lead + 1:]
    row = (a.select(lead, r) if 0 <= r < n_rows
           else a.new_zeros(shape))
    if sview is None:
        out = row.narrow(lead, start, end - start)
    else:
        def clip(w):               # [lo, hi) of the block rank w holds
            return max(start, w * cap), min(end, (w + 1) * cap)

        piece = row.new_zeros(shape[:lead] + (end - start,)
                              + shape[lead + 1:])
        lo, hi = clip(sview.shard)
        if lo < hi:
            piece.narrow(lead, lo - start, hi - lo).copy_(
                row.narrow(lead, lo - sview.shard * cap, hi - lo))
        parts = sview.all_gather(piece, "kv_block")
        out = torch.empty_like(piece)
        for w in range(sview.shards):
            lo, hi = clip(w)
            if lo < hi:
                out.narrow(lead, lo - start, hi - lo).copy_(
                    parts[w].narrow(lead, lo - start, hi - lo))
    if bview is not None:
        out = bview.all_gather(out, "kv_block")[slot // n_rows]
    return out


def slice_kv_block(caches, slot: int, start: int, end: int, cfg=None,
                   mesh=None) -> dict:
    """Copy one slot's cache rows [start, end) out of every layer's KV
    leaves (the int8 ``k_scale``/``v_scale`` leaves included) as host
    numpy arrays: the tree a sealed KV block stores.  Stacked block
    caches carry a leading layer axis (batch is axis 1); remainder
    caches lead with batch.  Under ``mesh`` (with ``cfg``) ``caches`` are
    this rank's part (``sharding.shard_caches``) and ``slot`` a global
    row: the block is gathered from the ranks that hold its row and
    positions, and every rank returns it whole (collective: every rank
    calls it alike)."""
    if mesh is not None:
        views = _block_views(cfg, mesh)

        def take(lead):
            return lambda a: _placed_rows(a, lead, slot, start, end,
                                          views).cpu().numpy()
    else:
        def take(lead):
            return lambda a: (a[:, slot, start:end] if lead else
                              a[slot, start:end]).cpu().numpy()
    block = {"blocks": _tree_map(take(1), caches["blocks"])}
    if "remainder" in caches:
        block["remainder"] = _tree_map(take(0), caches["remainder"])
    return block


def restore_kv_block(caches, slot: int, start: int, block: dict, cfg=None,
                     mesh=None) -> dict:
    """Functional inverse of ``slice_kv_block``: a copy of ``caches``
    with a fetched block's numpy rows written into one slot at
    ``start``, on the caches' device.  ``caches`` is left as it was.
    Under ``mesh`` each rank writes the rows and positions it holds (no
    exchange: every rank has the whole block)."""
    bview, sview = _block_views(cfg, mesh)

    def put(stacked):
        lead = 1 if stacked else 0

        def f(a, b):
            out = a.clone()
            rows = torch.from_numpy(np.array(b)).to(a.device, a.dtype)
            n_rows, cap = a.shape[lead], a.shape[lead + 1]
            r = slot - (bview.shard * n_rows if bview is not None else 0)
            if not 0 <= r < n_rows:
                return out
            lo = sview.shard * cap if sview is not None else 0
            a0 = max(start, lo)
            b0 = min(start + rows.shape[lead], lo + cap)
            if a0 < b0:
                out.select(lead, r).narrow(lead, a0 - lo, b0 - a0).copy_(
                    rows.narrow(lead, a0 - start, b0 - a0))
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


def _top(params, cfg: ModelConfig, shard, keys):
    """The top-level leaves ``keys``, FSDP-gathered whole.  The forward
    gathers the embedding for its lookup (whose backward needs only the
    token ids, so the gathered table is freed after it; a tied table is
    kept for the head, and its two uses add their gradients before one
    reduce-scatter), then the final norm and head after the layers."""
    keys = [k for k in keys if k in params]
    if getattr(shard, "fsdp_view", None) is None:
        return {k: params[k] for k in keys}
    decl = model_decl(cfg)
    return fsdp_gather({k: params[k] for k in keys},
                       {k: decl[k] for k in keys}, shard)


def _embed_and_head(params, cfg: ModelConfig, shard):
    """(the embedding table for the lookup, a function giving the final
    norm and head's leaves after the layers)."""
    emb = _top(params, cfg, shard, ("embed",))
    tied = emb["embed"] if cfg.tie_embeddings else None

    def head():
        out = _top(params, cfg, shard, ("final_norm", "lm_head"))
        if tied is not None:
            out["embed"] = tied
        return out

    return emb, head


def _embed(params, tokens, shard=None):
    """The token embeddings; over a vocabulary split over ``model`` each
    rank looks up its rows (zeros for the others') and the group sums,
    an exact sum of one value and zeros."""
    emb = params["embed"]
    tokens = torch.as_tensor(tokens).to(emb.device, torch.long)
    tp = shard.tp("vocab") if shard is not None else None
    if tp is None:
        return emb[tokens]
    n = emb.shape[0]
    local = tokens - tp.shard * n
    own = (local >= 0) & (local < n)
    x = torch.where(own[..., None], emb[local.clamp(0, n - 1)],
                    torch.zeros((), dtype=emb.dtype, device=emb.device))
    return tp.psum(x, "vocab_embed")


def _head(params, x, cfg: ModelConfig, shard=None):
    """Logits: every column, or this rank's vocabulary columns when
    ``model`` splits the vocabulary."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    tp = shard.tp("vocab") if shard is not None else None
    if tp is not None:
        x = tp.copy_to(x, "head_in")
    return x @ head


def gather_vocab(logits, shard=None):
    """Whole logits from this rank's vocabulary columns (``_head``'s
    output on a split vocabulary), on every rank.  No gradient."""
    tp = shard.tp("vocab") if shard is not None else None
    if tp is None:
        return logits
    return torch.cat(list(tp.all_gather(logits, "gather_vocab")), dim=-1)


def vocab_argmax(logits, shard=None):
    """``logits.argmax(-1)`` over the whole vocabulary from this rank's
    columns: the ranks' (max, index) pairs are gathered and the largest
    taken, a tie going to the lowest global index as ``torch.argmax``
    breaks it (the ranks hold contiguous columns in rank order)."""
    tp = shard.tp("vocab") if shard is not None else None
    if tp is None:
        return logits.argmax(dim=-1)
    idx = logits.argmax(dim=-1)
    val = logits.gather(-1, idx[..., None])[..., 0]
    glob = (idx + tp.shard * logits.shape[-1]).to(val.dtype)
    parts = tp.all_gather(torch.stack([val, glob]), "vocab_argmax")
    best = parts[:, 0].amax(dim=0)
    first = (parts[:, 0] == best).to(torch.int8).argmax(dim=0)
    return parts[:, 1].gather(0, first[None])[0].long()


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
         trust=None, decode=False):
    """The layer's MLP on the normed residual: (y, aux, counts); aux and
    counts are None where no MoE layer gives them.  ``decode``: a decode
    step's layer, which never votes, whose aux loss decode discards and
    whose counts (``expert_stats``) are the global batch's."""
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    if spec.mlp == "moe":
        mesh = getattr(shard, "mesh", None)
        if cfg.moe_impl == "ep" and mesh is not None:
            out = moe_ep.moe_mlp_ep(p["moe"], h, cfg, mesh,
                                    attack=None if decode else shard.attack,
                                    decode=decode, return_stats=expert_stats,
                                    shard=shard)
            return out if expert_stats else (*out, None)
        if decode:
            out = moe_lib.moe_mlp(p["moe"], h, cfg, shard=shard,
                                  return_stats=expert_stats, decode=True)
            if not expert_stats:
                return (*out, None)
            if mesh is not None and mesh.batch_split(cfg):
                out = (*out[:2], mesh.batch.all_reduce(out[2],
                                                       "expert_stats"))
            return out
        return (*moe_lib.moe_mlp(p["moe"], h, cfg, shard=shard,
                                 trust=trust), None)
    y = swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"],
               tp=shard.tp("ff") if shard is not None else None)
    return y, None, None


def _gathered(spec: LayerSpec, p, cfg, shard):
    """A layer's leaves with their FSDP parts gathered whole."""
    if getattr(shard, "fsdp_view", None) is None:
        return p
    return fsdp_gather(p, layer_decl(spec, cfg), shard)


def _layer_train(spec: LayerSpec, p, x, cfg, chunks, shard=None,
                 trust=None):
    p = _gathered(spec, p, cfg, shard)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.kind in ("attn", "local_attn"):
        window = cfg.sliding_window if spec.kind == "local_attn" else 0
        y = attn_train(p["attn"], h, cfg, window=window,
                       q_chunk=chunks[0], kv_chunk=chunks[1], shard=shard)
    elif spec.kind == "rglru":
        y = rglru_lib.rglru_train(p["rglru"], h, cfg, shard)
    elif spec.kind == "ssm":
        y = ssm_lib.ssm_train(p["ssm"], h, cfg, shard)
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
    block's activations (and its FSDP gathers) from its input, and the
    remainder layers keep theirs.  The values are the same bits either
    way.  Over a placed tree the logits are this rank's vocabulary
    columns (see the module's docstring)."""
    emb, head = _embed_and_head(params, cfg, shard)
    x = _embed(emb, tokens, shard)
    del emb
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
    return _head(head(), x, cfg, shard), aux


def _mask_rows(mask, new, old):
    """Row-select a cache leaf: rows where ``mask`` is False keep their
    old value (the slot is not advancing this step)."""
    m = mask.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(m, new, old)


def _layer_decode(spec: LayerSpec, p, cache, x, pos, cfg, expert_stats=False,
                  write_mask=None, shard=None):
    p = _gathered(spec, p, cfg, shard)
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    if spec.kind in ("attn", "local_attn"):
        window = cfg.sliding_window if spec.kind == "local_attn" else 0
        y, new_cache = attn_decode(
            p["attn"], h, cache, pos, cfg, window=window,
            split=cache_split(shard, cfg, window, cache["k"].shape[1]),
            shard=shard)
    elif spec.kind == "rglru":
        y, new_cache = rglru_lib.rglru_decode(p["rglru"], h, cache, cfg,
                                              shard)
    elif spec.kind == "ssm":
        y, new_cache = ssm_lib.ssm_decode(p["ssm"], h, cache, cfg, shard)
    else:
        raise ValueError(spec.kind)
    if write_mask is not None:
        # inactive slots must not advance KV rows or recurrent state
        new_cache = _map2(lambda n, o: _mask_rows(write_mask, n, o),
                          new_cache, cache)
    x = x + y
    counts = None
    if spec.mlp != "none":
        y, _, counts = _mlp(spec, p, x, cfg, expert_stats, shard=shard,
                            decode=True)
        x = x + y
    return x, new_cache, counts


def forward_decode(params, caches, tokens, pos, cfg: ModelConfig, *,
                   shard=None, expert_stats=False, write_mask=None):
    """One decode step.  tokens: (B, 1); pos: int scalar (all rows at the
    same absolute position) or (B,) integer tensor (per-slot positions).
    Returns (logits (B, 1, padded_vocab), new_caches); the caches passed
    in are not modified.  With ``expert_stats`` it also returns the
    per-MoE-layer routed-token counts (num_moe_layers, E) int32 in layer
    order (the blocks first, then the remainder; every row counted, the
    inactive ones too): what a serving edge's expert cache is fed with.

    ``write_mask`` (B,) bool: rows where it is False run the (padded)
    compute but leave their KV rows and recurrent state untouched.

    ``shard``: a mesh's sharder; ``tokens``, ``pos`` (a vector) and
    ``write_mask`` are then this rank's batch rows and ``caches`` its
    part (``sharding.shard_caches``); the counts are the global
    batch's, and over a placed tree the logits are this rank's
    vocabulary columns."""
    emb, head = _embed_and_head(params, cfg, shard)
    x = _embed(emb, tokens, shard)
    del emb
    if write_mask is not None:
        write_mask = torch.as_tensor(write_mask, device=x.device).bool()
    new_blocks = {str(i): [] for i in range(len(cfg.block_pattern))}
    new_rem, counts = [], []
    for spec, key, i in _layers(cfg):
        x, nc, c = _layer_decode(spec, _layer_params(params, key, i),
                                 _layer_params(caches, key, i), x, pos, cfg,
                                 expert_stats, write_mask, shard)
        (new_rem if key is None else new_blocks[key]).append(nc)
        if c is not None:
            counts.append(c)
    new_caches = {"blocks": {k: _stack(v) for k, v in new_blocks.items()}}
    if cfg.remainder:
        new_caches["remainder"] = new_rem
    logits = _head(head(), x, cfg, shard)
    if not expert_stats:
        return logits, new_caches
    stats = (torch.stack(counts) if counts else torch.zeros(
        (0, max(cfg.resolved_padded_experts, 1)), dtype=torch.int32,
        device=x.device))
    return logits, new_caches, stats


def forward_serve_chunk(params, caches, tokens, start, pos, lengths, adv,
                        cfg: ModelConfig, *, shard=None, expert_stats=False):
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
    micro-steps.  The caches passed in are not modified.  ``shard``: a
    mesh's sharder, as ``forward_decode`` takes it (the (B,) inputs and
    the outputs' columns this rank's rows)."""
    dev = params["embed"].device

    def on_dev(a):
        return torch.as_tensor(a).to(dev, torch.long)

    tokens, pos, lengths, adv = map(on_dev, (tokens, pos, lengths, adv))
    cur = on_dev(start)
    outs, total = [], None
    for t in range(tokens.shape[1]):
        feed = torch.where(t < lengths, tokens[:, t], cur)
        out = forward_decode(params, caches, feed[:, None], pos + t, cfg,
                             shard=shard, expert_stats=expert_stats,
                             write_mask=t < adv)
        logits, caches = out[0], out[1]
        if expert_stats:
            total = out[2] if total is None else total + out[2]
        cur = vocab_argmax(logits[:, -1], shard)
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


class _VocabLMLoss(torch.autograd.Function):
    """``_LMLoss`` over logits whose vocabulary is split over ``tp``'s
    group (this rank's contiguous columns): the row max (a gather), the
    sum of exponentials and the label's logit (its owner's, zeros
    elsewhere: exact) are reduced over the group, so every rank holds
    the same loss; the backward writes this rank's columns of (softmax -
    one-hot) * valid / denom."""

    @staticmethod
    def forward(ctx, logits, labels, valid, tp):
        lf = logits.float()
        n = lf.shape[-1]
        top = tp.all_gather(lf.amax(dim=-1), "vocab_max").amax(dim=0)
        local = labels - tp.shard * n
        own = (local >= 0) & (local < n)
        picked = torch.where(
            own, lf.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0],
            torch.zeros((), device=lf.device))
        sums = torch.stack([torch.exp(lf - top[..., None]).sum(dim=-1),
                            picked])
        sums = tp.all_reduce(sums.contiguous(), "vocab_sums")
        lse = top + torch.log(sums[0])
        denom = torch.clamp(valid.sum(), min=1)
        ctx.tp = tp
        ctx.save_for_backward(logits, local, own, valid, lse, denom)
        return -((sums[1] - lse) * valid).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, local, own, valid, lse, denom = ctx.saved_tensors
        grad = torch.sub(logits.float(), lse[..., None]).exp_()
        idx = local.clamp(0, logits.shape[-1] - 1)[..., None]
        grad.scatter_(-1, idx, grad.gather(-1, idx)
                      - own[..., None].to(grad.dtype))
        grad.mul_((g * valid / denom)[..., None])
        return grad.to(logits.dtype), None, None, None


def lm_loss(logits, labels, mask=None, shard=None):
    """Mean cross-entropy over the valid positions (the counterpart of
    JAX's ``lm_loss``).  logits (B, S, V); labels (B, S) integer, label
    < 0 ignored (a VLM's image prefix); ``mask`` (B, S) bool narrows the
    valid positions further.  In float32.  The label's logit is taken by
    ``gather`` where JAX contracts a one-hot: one term and zeros, the
    same value, without a (B, S, V) one-hot; the backward builds its
    gradient in one (B, S, V) buffer (``_LMLoss``).  ``shard``: the
    sharder of a placed tree, whose ``logits`` are this rank's
    vocabulary columns (``_VocabLMLoss``)."""
    labels = torch.as_tensor(labels).to(logits.device, torch.long)
    valid = labels >= 0
    if mask is not None:
        valid = valid & torch.as_tensor(mask).to(logits.device, torch.bool)
    tp = shard.tp("vocab") if shard is not None else None
    if tp is not None:
        return _VocabLMLoss.apply(logits, labels.clamp(min=0), valid, tp)
    return _LMLoss.apply(logits, labels.clamp(min=0), valid)
