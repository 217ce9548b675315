"""The cases of ``tests/test_torch_recurrent_tp.py``, importable by the
ranks ``spawn_edges`` starts (a spawned process cannot import a test
file).

``make_inputs`` draws every case's inputs once with numpy and the port's
seeded initialiser (the same arrays go to the JAX package's functions
and to the port's).  ``tp_rank`` is one rank of the test's world of 4:
for every case of ``CASES`` on each of its meshes it places the whole
tree as ``sharding.placed_specs`` says (``shard_params``: the recurrent
mixers' heads and channels and the encoder-decoder's leaves included)
and runs one training step's loss and gradients (remat on), one AdamW
update, one prefill and ``DECODE_STEPS`` decode steps from random
caches placed as JAX's cache specs say (``shard_caches``), and writes
what the test compares (the rank's rows of the logits, the whole
gradients and updated tree gathered back, the decode logits and the
whole caches gathered back) to ``<out>/rank<r>.pkl``.  The port's
one-device run of every case is made once, the cases dealt over the
ranks, and gathered on every rank.  The bitwise claims and the mixers'
own checks have cases of their own (``_bitwise``)."""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import io as ckpt
from repro_torch.convert import lm_params_from_numpy, tree_to_numpy
from repro_torch.core.ledger import digest_tree, tree_flatten, tree_unflatten
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm
from repro_torch.models.builder import materialize
from repro_torch.optim import adamw
from repro_torch.sharding import (gather_caches, gather_params, shard_caches,
                                  shard_params, step_sharder)
from repro_torch.configs import get_config
from repro_torch.train import step as st
from repro_torch.train.loop import init_model

WORLD = 4
AXES = {2: ("data", "model"), 3: ("data", "replica", "model")}
MESHES = ((2, 2), (1, 4), (4, 1))
# (name, arch, config changes): every case runs on every mesh of MESHES.
# mamba2 at smoke width has 16 heads (4 a rank on model = 4);
# mamba2_odd's 6 heads of 32 channels divide model = 2 but not 4, where a
# rank's 48 channels straddle heads; recurrentgemma's 256 channels and
# its local attention (2 q heads, 1 kv head); seamless-m4t-medium's 2 +
# 2 layers of 4 heads.
CASES = (("mamba2", "mamba2-2.7b", {}),
         ("mamba2_odd", "mamba2-2.7b", {"d_model": 96, "ssm_head_dim": 32}),
         ("rgemma", "recurrentgemma-2b", {}),
         ("seamless", "seamless-m4t-medium", {}))
TOKENS = (4, 16)
FRAMES = 8
CACHE_LEN = 32
MEMORY = 8
DECODE_STEPS = 3
OPT = dict(total_steps=10)


def case_cfg(arch: str, **kw):
    return dataclasses.replace(get_config(arch, smoke=True), **kw)


def decode_cfg(cfg):
    """The decode shapes' settings at batch 4: the cache's positions over
    ``model`` (``launch.shapes.shape_config``)."""
    return dataclasses.replace(cfg, cache_seq_axes=("model",),
                               batch_shardable=True)


def cache_decl(cfg, batch: int):
    if cfg.is_encoder_decoder:
        return encdec.encdec_cache_decl(cfg, batch, CACHE_LEN, MEMORY)
    return tfm.cache_decl(cfg, batch, CACHE_LEN)


def make_inputs() -> dict:
    """Every case's model, training batch, caches and decode batches as
    numpy."""
    rng = np.random.default_rng(0)
    out = {"models": {}, "batch": {}, "caches": {}, "decode": {}}
    B, S = TOKENS
    for name, arch, kw in CASES:
        cfg = case_cfg(arch, **kw)
        out["models"][name] = tree_to_numpy(init_model(cfg, 1, "cpu"))
        toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        batch = {"tokens": toks, "labels": toks}
        if cfg.is_encoder_decoder:
            batch["frames"] = rng.standard_normal(
                (B, FRAMES, cfg.d_model)).astype(np.float32)
        out["batch"][name] = batch
        zeros = materialize(cache_decl(decode_cfg(cfg), B), 0, "cpu")
        flat, _ = tree_flatten(zeros)
        out["caches"][name] = tree_to_numpy(tree_unflatten(zeros, [
            torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
            for t in flat]))
        out["decode"][name] = [
            {"tokens": rng.integers(0, cfg.vocab_size, (B, 1)).astype(
                np.int32),
             "pos": np.array([2, CACHE_LEN // 2 - 1, CACHE_LEN // 2,
                              CACHE_LEN - 1], np.int32) + t}
            for t in range(DECODE_STEPS)]
    return out


def _mesh(shape):
    return make_lm_mesh(shape, AXES[len(shape)], device="cpu")


def _t(tree):
    return lm_params_from_numpy(tree, device="cpu")


def _batch(b):
    return {k: (torch.from_numpy(np.array(v)).long() if v.dtype != np.float32
                else torch.from_numpy(np.array(v))) for k, v in b.items()}


def _np(t):
    return t.detach().cpu().numpy()


def _fresh(tree):
    """A copy of every leaf (the training step updates in place, and
    ``shard_params`` shares the leaves it does not cut)."""
    return tree_unflatten(tree, [t.clone() for t in tree_flatten(tree)[0]])


def _forward_decode(cfg, params, caches, tokens, pos, shard):
    fwd = (encdec.forward_decode if cfg.is_encoder_decoder
           else tfm.forward_decode)
    return fwd(params, caches, tokens, pos, cfg, shard=shard)


def _run(cfg, params, batch, caches, decode, mesh):
    """One case on ``mesh`` (None: one device) from the whole tree
    ``params``: the loss, aux and the whole gradients (remat on), this
    rank's rows of the whole logits, one step's metrics and updated tree
    (gathered whole), the prefill's next tokens, per decode step the next
    tokens and this rank's rows of the whole logits, and the whole caches
    after the last step (gathered)."""
    p = shard_params(params, cfg, mesh)
    loss, aux, grads = st.make_loss_and_grads(cfg, remat=True, mesh=mesh)(
        p, batch)
    shard = step_sharder(cfg, mesh, "train")
    lo, hi = (0, TOKENS[0]) if mesh is None else mesh.batch_rows(TOKENS[0])
    rows = {k: v[lo:hi] for k, v in batch.items()}
    with torch.no_grad():
        logits, _, _ = st.model_forward(p, rows, cfg, shard=shard)
    out = {"loss": float(loss), "aux": float(aux), "rows": (lo, hi),
           "grads": tree_to_numpy(gather_params(grads, cfg, mesh)),
           "logits": _np(tfm.gather_vocab(logits, shard))}
    del logits
    p = shard_params(_fresh(params), cfg, mesh)
    p, _, m = st.apply_update(adamw.AdamWConfig(**OPT), cfg, p,
                              adamw.init(p), grads, mesh)
    del grads
    whole = gather_params(p, cfg, mesh)
    out.update(metrics={k: float(v) for k, v in m.items()},
               updated=tree_to_numpy(whole), updated_digest=digest_tree(whole))
    pp = shard_params(params, cfg, mesh, "prefill")
    out["next"] = _np(st.make_prefill_step(cfg, mesh)(
        pp, {k: v for k, v in batch.items() if k != "labels"}))
    dcfg = decode_cfg(cfg)
    pd = shard_params(params, dcfg, mesh, "decode")
    dshard = step_sharder(dcfg, mesh, "decode")
    c = shard_caches(caches, dcfg, mesh)
    step = st.make_decode_step(dcfg, mesh=mesh)
    out["decode"] = []
    for b in decode:
        b = {"tokens": torch.from_numpy(b["tokens"]).long(),
             "pos": torch.from_numpy(b["pos"]).long()}
        mine = st._local_rows(b, mesh, dcfg)
        logits = _forward_decode(dcfg, pd, c, mine["tokens"], mine["pos"],
                                 dshard)[0]
        nxt, c = step(pd, c, b)
        out["decode"].append({"next": _np(nxt), "logits": _np(
            tfm.gather_vocab(logits, dshard)[:, -1])})
    out["caches"] = tree_to_numpy(gather_caches(c, dcfg, mesh))
    if mesh is not None and not cfg.is_encoder_decoder:
        # the ssm conv history is whole on every model rank: its copies
        # agree bit for bit
        same = []
        for spec, key, i in tfm._layers(dcfg):
            if spec.kind == "ssm":
                conv = tfm._layer_params(c, key, i)["conv"]
                same += [torch.equal(part, conv) for part in
                         mesh.model.all_gather(conv, "conv_check")]
        out["conv_replicated"] = same
    return out


def _one_device(inp):
    """Every case on one device (rank 0 runs it, every rank gets it)."""
    mine = {}
    for i, (name, arch, kw) in enumerate(CASES):
        if i % dist.get_world_size() == dist.get_rank():
            mine[name] = _run(case_cfg(arch, **kw), _t(inp["models"][name]),
                              _batch(inp["batch"][name]),
                              _t(inp["caches"][name]), inp["decode"][name],
                              None)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, mine)
    return {k: v for part in parts for k, v in part.items()}


def _cases(inp, res):
    for name, arch, kw in CASES:
        cfg = case_cfg(arch, **kw)
        full = _t(inp["models"][name])
        for shape in MESHES:
            mesh = _mesh(shape)
            got = _run(cfg, full, _batch(inp["batch"][name]),
                       _t(inp["caches"][name]), inp["decode"][name], mesh)
            got["wire"] = dict(mesh.wire_bytes)
            if mesh.rank != 0:        # the whole trees: rank 0's suffice
                got["grads"] = got["updated"] = got["caches"] = None
            res[f"{name}/{shape}"] = got


def _bitwise(inp, res):
    """The placement's bitwise claims on this rank, and the
    encoder-decoder's cross K/V from a placed tree."""
    out = {}
    # FSDP alone: (data 2, replica 2, model 1) with FSDP (the training
    # placement) against the same mesh over whole leaves (the inference
    # placement), clipping off
    mesh = _mesh((2, 2, 1))
    fsdp = {}
    for name, arch, kw in CASES:
        cfg = case_cfg(arch, **kw)
        full = _t(inp["models"][name])
        batch = _batch(inp["batch"][name])
        runs = []
        for kind in ("train", "prefill"):
            p = shard_params(_fresh(full), cfg, mesh, kind)
            loss, _, g = st.make_loss_and_grads(cfg, remat=True, mesh=mesh)(
                p, batch)
            g = gather_params(g, cfg, mesh)
            p = shard_params(_fresh(full), cfg, mesh, kind)
            p, _, m = st.make_train_step(
                cfg, adamw.AdamWConfig(grad_clip=1e9, **OPT), mesh)(
                p, adamw.init(p), batch)
            runs.append((float(loss), digest_tree(g),
                         digest_tree(gather_params(p, cfg, mesh))))
        fsdp[name] = runs[0] == runs[1]
    out["fsdp_alone"] = fsdp
    # a rank's tree drawn by init_model(mesh=) = the slice of the whole
    # one, both placements, on (2, 2) and (1, 4)
    drawn = {}
    for name, arch, kw in CASES:
        c = case_cfg(arch, **kw)
        w = init_model(c, 5, "cpu")
        for shape in ((2, 2), (1, 4)):
            m = _mesh(shape)
            drawn[f"{name}/{shape}"] = all(
                digest_tree(init_model(c, 5, "cpu", mesh=m, kind=kind))
                == digest_tree(shard_params(w, c, m, kind))
                for kind in ("train", "decode"))
    out["drawn_slice"] = drawn
    # checkpoints of placed trees: the one-device bytes, and a restore
    # cut to the rank's part
    d = res["_dir"]
    mesh = _mesh((2, 2))
    ck = {}
    for name, arch, kw in CASES:
        cfg = case_cfg(arch, **kw)
        w = init_model(cfg, 7, "cpu")
        one = ckpt.save(os.path.join(d, f"one_{name}{mesh.rank}.npz"), w)
        placed = shard_params(w, cfg, mesh)
        path = os.path.join(d, f"mesh_{name}.npz")
        on = ckpt.save(path, placed, cfg=cfg, mesh=mesh)
        dist.barrier()
        back = ckpt.restore(path, placed, cfg=cfg, mesh=mesh)
        ck[name] = (one == on, digest_tree(back) == digest_tree(placed))
    out["checkpoint"] = ck
    # the encoder-decoder's cross K/V from encode's memory over a placed
    # tree on (1, 4) against one device
    name, arch, kw = CASES[3]
    cfg = case_cfg(arch, **kw)
    full = _t(inp["models"][name])
    frames = _batch(inp["batch"][name])["frames"]
    mesh = _mesh((1, 4))
    shard = step_sharder(cfg, mesh, "decode")
    p = shard_params(full, cfg, mesh, "decode")
    with torch.no_grad():
        want = encdec.cross_kv(full, encdec.encode(full, frames, cfg), cfg)
        got = encdec.cross_kv(p, encdec.encode(p, frames, cfg, shard=shard),
                              cfg, shard=shard)
    out["cross_kv"] = [(float((g - w).abs().max()), float(w.abs().max()))
                       for g, w in zip(got, want)]
    res["bitwise"] = out


def tp_rank(rank: int, world: int, in_path: str, out_dir: str) -> None:
    """A rank of the test's world: every case, results to
    ``<out_dir>/rank<r>.pkl``."""
    torch.set_num_threads(1)
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    res = {"_dir": out_dir}
    res["one_device"] = _one_device(inp)
    _cases(inp, res)
    _bitwise(inp, res)
    if rank:
        res.pop("one_device")
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def card_rank(rank: int, world: int, out_dir: str,
              device: str = "cuda") -> None:
    """A rank of ``tests/test_torch_cuda.py``'s 2-rank recurrent
    tensor-parallel case on the card: every case of ``CASES`` at smoke
    width on (1, 2) (mamba2's 8 heads a rank, mamba2_odd's 3,
    recurrentgemma's 128 channels, seamless's 2 heads), against the
    one-device run on the same card: the loss and gradients of a
    training step (remat on) and its launches, the prefill's logits and
    next tokens and its launches."""
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_lm_mesh((1, 2), ("data", "model"), device=device)
    inp = make_inputs()
    out = {}
    for name, arch, kw in CASES:
        cfg = case_cfg(arch, **kw)
        full = lm_params_from_numpy(inp["models"][name], device=mesh.device)
        batch = {k: v.to(mesh.device)
                 for k, v in _batch(inp["batch"][name]).items()}
        one_loss, _, one_g = st.make_loss_and_grads(cfg, remat=True)(
            full, batch)
        p = shard_params(full, cfg, mesh)
        ops.reset_launch_counts()
        loss, _, g = st.make_loss_and_grads(cfg, remat=True, mesh=mesh)(
            p, batch)
        train_launches = ops.launch_counts()
        mine = tree_flatten(shard_params(one_g, cfg, mesh))[0]
        rel = max(float((a - b).abs().max() / b.abs().max().clamp(
            min=1e-30)) for a, b in zip(tree_flatten(g)[0], mine))
        rows = {k: v for k, v in batch.items() if k != "labels"}
        pp = shard_params(full, cfg, mesh, "prefill")
        shard = step_sharder(cfg, mesh, "prefill")
        with torch.no_grad():
            got = tfm.gather_vocab(st.model_forward(pp, rows, cfg,
                                                    shard=shard)[0], shard)
            one = st.model_forward(full, rows, cfg)[0]
        ops.reset_launch_counts()
        nxt = st.make_prefill_step(cfg, mesh)(pp, rows)
        out[name] = {"loss": (float(loss), float(one_loss)),
                     "grads_rel": rel, "train_launches": train_launches,
                     "logits_abs": float((got - one).abs().max()),
                     "logits_max": float(one.abs().max()),
                     "next": _np(nxt),
                     "one_next": _np(one[:, -1:].argmax(-1)),
                     "prefill_launches": ops.launch_counts()}
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
