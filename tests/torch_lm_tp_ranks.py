"""The cases of ``tests/test_torch_lm_tp.py``, importable by the ranks
``spawn_edges`` starts (a spawned process cannot import a test file).

``make_inputs`` draws every case's inputs once with numpy and the port's
seeded initialiser (the same arrays go to the JAX package's functions
and to the port's).  ``tp_rank`` is one rank of the test's world of 4:
for every case of ``CASES`` on each of its meshes it places the whole
tree as ``sharding.placed_specs`` says (``shard_params``) and runs one
training step's loss and gradients (remat on: the FSDP gathers run
inside the checkpointed blocks), one AdamW update, one prefill and
``DECODE_STEPS`` decode steps from random caches, and writes what the
test compares (the rank's rows of the logits, the whole gradients and
updated tree gathered back) to ``<out>/rank<r>.pkl``.  The port's
one-device run of every case is made once, the cases dealt over the
ranks, and gathered on every rank.
The bitwise claims have cases of their own (``_bitwise``)."""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import io as ckpt
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy, tree_to_numpy
from repro_torch.core.ledger import digest_tree, tree_flatten
from repro_torch.core.trusted_moe import LMAttack
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.builder import materialize
from repro_torch.models.config import RedundancyConfig
from repro_torch.optim import adamw
from repro_torch.sharding import (gather_params, shard_caches, shard_params,
                                  step_sharder)
from repro_torch.train import step as st
from repro_torch.train.loop import init_model

WORLD = 4
AXES = {2: ("data", "model"), 3: ("data", "replica", "model")}
MESHES = ((2, 2), (1, 4), (4, 1))
OFF = RedundancyConfig(mode="off")
# (name, arch, config changes): every case runs on every mesh of MESHES.
# qwen2.5-3b has 2 kv heads (half a head a rank on model = 4), gemma3
# local attention, pixtral a patch prefix; bmoe-paper at 6 experts runs
# its gspmd MoE with the experts over model on (2, 2) and moe_ff over
# model on (1, 4) (its vote off: these meshes have no replica axis);
# qwen2-moe-a2.7b is expert-parallel.  Capacity factor 8: nothing
# dropped, so every mesh computes the one-device function.
CASES = (("qwen25", "qwen2.5-3b", {}),
         ("qwen3", "qwen3-32b", {}),
         ("gemma3", "gemma3-27b", {}),
         ("pixtral", "pixtral-12b", {}),
         ("bmoe", "bmoe-paper", {"num_experts": 6, "redundancy": OFF,
                                 "capacity_factor": 8.0}),
         ("qwen_moe_ep", "qwen2-moe-a2.7b", {"capacity_factor": 8.0}))
TOKENS = (4, 16)
PATCHES = 4
CACHE_LEN = 32
DECODE_STEPS = 3
OPT = dict(total_steps=10)


def case_cfg(arch: str, **kw):
    return dataclasses.replace(get_config(arch, smoke=True), **kw)


def decode_cfg(cfg):
    """The decode shapes' settings at batch 4: the cache's positions over
    ``model`` (``launch.shapes.shape_config``)."""
    return dataclasses.replace(cfg, cache_seq_axes=("model",),
                               batch_shardable=True)


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
        if cfg.frontend == "vision":
            batch["patches"] = rng.standard_normal(
                (B, PATCHES, cfg.d_model)).astype(np.float32)
        out["batch"][name] = batch
        zeros = materialize(tfm.cache_decl(decode_cfg(cfg), B, CACHE_LEN),
                            0, "cpu")
        flat, _ = tree_flatten(zeros)
        out["caches"][name] = tree_to_numpy(_unflatten(zeros, [
            torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
            for t in flat]))
        out["decode"][name] = [
            {"tokens": rng.integers(0, cfg.vocab_size, (B, 1)).astype(
                np.int32),
             "pos": np.array([2, CACHE_LEN // 2 - 1, CACHE_LEN // 2,
                              CACHE_LEN - 1], np.int32) + t}
            for t in range(DECODE_STEPS)]
    # the bitwise layer and loss cases
    bm = case_cfg("bmoe-paper", redundancy=OFF, capacity_factor=8.0)
    out["moe_layer"] = {
        "params": tree_to_numpy(init_model(bm, 2, "cpu")),
        "x": rng.standard_normal((2, 8, bm.d_model)).astype(np.float32)}
    out["loss"] = {
        "logits": (rng.standard_normal((2, 5, 512)) * 3).astype(np.float32),
        "labels": np.array([[1, 511, 256, -1, 0], [128, 129, 383, 384, 7]],
                           np.int64)}
    return out


def _unflatten(like, leaves):
    from repro_torch.core.ledger import tree_unflatten
    return tree_unflatten(like, leaves)


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
    return _unflatten(tree, [t.clone() for t in tree_flatten(tree)[0]])


def _prefill_batch(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def _run(cfg, params, batch, caches, decode, mesh):
    """One case on ``mesh`` (None: one device) from the whole tree
    ``params``: the loss, aux and the whole gradients (remat on), this
    rank's rows of the whole logits, one step's metrics and updated tree
    (gathered whole), the prefill's next tokens, and per decode step the
    next tokens and this rank's rows of the whole logits."""
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
    # the training step's update (``make_train_step``'s), on a copy: it
    # updates in place
    p = shard_params(_fresh(params), cfg, mesh)
    p, _, m = st.apply_update(adamw.AdamWConfig(**OPT), cfg, p,
                              adamw.init(p), grads, mesh)
    del grads
    whole = gather_params(p, cfg, mesh)
    out.update(metrics={k: float(v) for k, v in m.items()},
               updated=tree_to_numpy(whole), updated_digest=digest_tree(whole))
    pp = shard_params(params, cfg, mesh, "prefill")
    out["next"] = _np(st.make_prefill_step(cfg, mesh)(
        pp, _prefill_batch(batch)))
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
        logits = tfm.forward_decode(pd, c, mine["tokens"], mine["pos"],
                                    dcfg, shard=dshard)[0]
        nxt, c = step(pd, c, b)
        out["decode"].append({"next": _np(nxt), "logits": _np(
            tfm.gather_vocab(logits, dshard)[:, -1])})
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
                got["grads"] = got["updated"] = None
            res[f"{name}/{shape}"] = got


def _bitwise(inp, res):
    """The placement's bitwise claims on this rank."""
    out = {}
    # FSDP alone: (data 2, replica 2, model 1) with FSDP (the training
    # placement) against the same mesh over whole leaves (the inference
    # placement: no gather, the gradients all-reduced), clipping off
    # (its scale is then exactly 1)
    name, arch, kw = CASES[0]
    cfg = case_cfg(arch, **kw)
    full = _t(inp["models"][name])
    batch = _batch(inp["batch"][name])
    mesh = _mesh((2, 2, 1))
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
                     digest_tree(gather_params(p, cfg, mesh)),
                     float(m["grad_norm"])))
    out["fsdp_alone"] = {"loss": runs[0][0] == runs[1][0],
                         "grads": runs[0][1] == runs[1][1],
                         "update": runs[0][2] == runs[1][2],
                         "grad_norm": (runs[0][3], runs[1][3])}
    # the vocab-parallel embedding on (1, 4) against one device
    mesh = _mesh((1, 4))
    shard = step_sharder(cfg, mesh, "prefill")
    p = shard_params(full, cfg, mesh, "prefill")
    toks = batch["tokens"]
    out["embedding"] = torch.equal(tfm._embed(p, toks, shard),
                                   tfm._embed(full, toks))
    # a gspmd MoE layer with its experts over model (4 of 4) against one
    # device, forward and gradients (router and x)
    bm = case_cfg("bmoe-paper", redundancy=OFF, capacity_factor=8.0)
    whole = _t(inp["moe_layer"]["params"])
    layer = {k: v[0] for k, v in whole["blocks"]["0"]["moe"].items()}
    x = torch.from_numpy(inp["moe_layer"]["x"])
    shard = step_sharder(bm, mesh, "prefill")
    mine = shard_params(whole, bm, mesh, "prefill")
    mine = {k: v[0] for k, v in mine["blocks"]["0"]["moe"].items()}
    ys = []
    for prm, sh in ((layer, None), (mine, shard)):
        prm = {k: v.detach().requires_grad_(True) for k, v in prm.items()}
        xx = x.clone().requires_grad_(True)
        y, aux = moe_lib.moe_mlp(prm, xx, bm, shard=sh)
        (y.square().sum() + aux).backward()
        ys.append((y.detach(), xx.grad, prm["router"].grad))
    out["moe_experts_over_model"] = {
        "y": torch.equal(ys[0][0], ys[1][0]),
        "dx": torch.equal(ys[0][1], ys[1][1]),
        "drouter": torch.equal(ys[0][2].narrow(
            1, mesh.model.shard * ys[1][2].shape[1], ys[1][2].shape[1]),
            ys[1][2])}
    # a rank's slice of a drawn tree = the slice of the whole tree, for
    # every config, both placements, on (2, 2)
    mesh = _mesh((2, 2))
    drawn = {}
    for arch in ARCH_IDS:
        c = get_config(arch, smoke=True)
        w = init_model(c, 5, "cpu")
        drawn[arch] = all(
            digest_tree(init_model(c, 5, "cpu", mesh=mesh, kind=kind))
            == digest_tree(shard_params(w, c, mesh, kind))
            for kind in ("train", "decode"))
    out["drawn_slice"] = drawn
    # checkpoints: the same bytes from a mesh as from one device, and a
    # restore cut to the rank's part
    d = res["_dir"]
    cfg = case_cfg(CASES[1][1])
    w = init_model(cfg, 7, "cpu")
    one = ckpt.save(os.path.join(d, f"one{mesh.rank}.npz"), w)
    placed = shard_params(w, cfg, mesh)
    path = os.path.join(d, "mesh.npz")
    on = ckpt.save(path, placed, cfg=cfg, mesh=mesh)
    dist.barrier()
    back = ckpt.restore(path, placed, cfg=cfg, mesh=mesh)
    out["checkpoint"] = {"same_digest": one == on,
                         "restore": digest_tree(back) == digest_tree(placed)}
    # attacked = clean under FSDP: bmoe-paper's vote (faithful, r = 2)
    # on (data 2, replica 2, model 1), one step each, a minority replica
    # adding noise
    tc = case_cfg("bmoe-paper", capacity_factor=8.0)
    tw = init_model(tc, 3, "cpu")
    mesh = _mesh((2, 2, 1))
    tb = _batch(inp["batch"]["bmoe"])
    digests = []
    for atk in (None, LMAttack(malicious_replicas=(1,), noise_std=5.0)):
        p = shard_params(_fresh(tw), tc, mesh)
        p, _, m = st.make_train_step(tc, adamw.AdamWConfig(**OPT), mesh,
                                     attack=atk)(p, adamw.init(p), tb)
        digests.append((float(m["loss"]), digest_tree(p)))
    out["attacked_is_clean"] = digests[0] == digests[1]
    # the vocab-parallel loss and its gradient against lm_loss on (1, 4)
    mesh = _mesh((1, 4))
    shard = step_sharder(cfg, mesh, "train")
    lg = torch.from_numpy(inp["loss"]["logits"])
    lab = torch.from_numpy(inp["loss"]["labels"])
    n = lg.shape[-1] // 4
    mine = lg[..., mesh.model.shard * n:(mesh.model.shard + 1) * n]
    mine = mine.clone().requires_grad_(True)
    whole = lg.clone().requires_grad_(True)
    a = tfm.lm_loss(mine, lab, shard=shard)
    b = tfm.lm_loss(whole, lab)
    a.backward()
    b.backward()
    out["vocab_loss"] = {
        "loss": (a.item(), b.item()),
        "grad": float((mine.grad - whole.grad[
            ..., mesh.model.shard * n:(mesh.model.shard + 1) * n]).abs().max()),
        "argmax": torch.equal(tfm.vocab_argmax(mine.detach(), shard),
                              lg.argmax(-1))}
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


def card_rank(rank: int, world: int, out_dir: str) -> None:
    """A rank of ``tests/test_torch_cuda.py``'s 2-rank tensor-parallel
    case on the card: bmoe-paper at smoke width with 6 experts (over
    ``model``), capacity factor 8, on (1, 2); the prefill's logits twice
    and against the one-device forward on the same card, its next tokens
    and its launches."""
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    name, arch, kw = CASES[4]
    cfg = case_cfg(arch, **kw)
    mesh = make_lm_mesh((1, 2), ("data", "model"))
    full = init_model(cfg, 1, mesh.device)
    toks = torch.from_numpy(make_inputs()["batch"][name]["tokens"]).long()
    toks = toks.to(mesh.device)
    p = shard_params(full, cfg, mesh, "prefill")
    shard = step_sharder(cfg, mesh, "prefill")
    with torch.no_grad():
        runs = [tfm.gather_vocab(tfm.forward_train(p, toks, cfg,
                                                   shard=shard)[0], shard)
                for _ in range(2)]
        one = tfm.forward_train(full, toks, cfg)[0]
    ops.reset_launch_counts()
    nxt = st.make_prefill_step(cfg, mesh)(p, {"tokens": toks})
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"launches": launches,
                     "twice_bitwise": torch.equal(runs[0], runs[1]),
                     "logits_abs": (runs[0] - one).abs().max().item(),
                     "logits_max": one.abs().max().item(),
                     "next": _np(nxt), "one_next": _np(
                         one[:, -1:].argmax(-1))}, f)
