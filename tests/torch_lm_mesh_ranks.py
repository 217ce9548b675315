"""The cases of ``tests/test_torch_lm_mesh.py``, importable by the ranks
``spawn_edges`` starts (a spawned process cannot import a test file).

``make_inputs`` draws every case's inputs once with numpy and the port's
seeded initialiser (the same arrays go to the JAX package's functions and
to the port's); ``lm_rank`` is one rank of the test's world of 4: it runs
every case on the CPU, each on its own ``LMMesh`` over the world, and
writes what the test compares to ``<out>/rank<r>.pkl``, the counts of
one EP prefill and training step included (the dry run's abstract mesh
is held to them).  The cases that
hold the mesh to the port's own one-device run (bitwise, or 1e-6 with a
data axis of 2) run that run on rank 0, which broadcasts it.

The decode cases (``DECODE``) run ``make_decode_step`` on a mesh from
random caches placed by ``sharding.shard_caches`` (the global batch in,
a vector ``pos`` whose rows sit on both sides of the ranks' position
boundaries, past the linear cache's end and across the ring's wrap, an
``active`` mask with one row off), the serving chunk and the serving
engine run on (2, 2) (``SERVE``), and the cache placement round-trips
every config's declaration."""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, tree_to_numpy
from repro_torch.core.ledger import digest_tree, tree_flatten, tree_unflatten
from repro_torch.core.trusted_moe import LMAttack, make_trust
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import shape_config
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import encdec
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.builder import materialize
from repro_torch.models.config import RedundancyConfig
from repro_torch.models.moe_ep import moe_mlp_ep
from repro_torch.optim import adamw
from repro_torch.sharding import (gather_caches, gather_params, shard_caches,
                                  shard_params, step_sharder)
from repro_torch.train import step as st
from repro_torch.train.loop import init_model

WORLD = 4
AXES = {2: ("data", "model"), 3: ("data", "replica", "model")}
# EP layer cases: (name, mesh, x's (B, S)); "ragged": 14 tokens on a
# 4-wide model axis; "tiny_*": fewer tokens than model ranks, or ragged
EP_LAYER = (("mesh_1x4", (1, 4), (4, 16)), ("mesh_2x2", (2, 2), (4, 16)),
            ("ragged", (1, 4), (2, 7)), ("tiny_1x1", (1, 4), (1, 1)),
            ("tiny_2x1", (1, 4), (2, 1)), ("tiny_1x3", (1, 4), (1, 3)))
# whole steps against the JAX package: (name, mesh)
STEPS = (("qwen_ep", (2, 2)), ("qwen_trusted", (1, 2, 2)),
         ("bmoe", (1, 2, 2)))
TOKENS = (4, 32)
MINORITY = {2: (1,), 4: (1,)}
MAJORITY = {2: (0, 1), 4: (0, 1, 2)}
# decode cases: (name, arch, mesh, batch, cache length, config changes);
# batch 4 caches split over model, batch 1 over data x model (as
# ``launch.shapes.shape_config`` sets them for decode_32k and long_500k)
DECODE_ARCHS = (("qwen_moe", "qwen2-moe-a2.7b", 64, {}),
                ("qwen25", "qwen2.5-3b", 64, {}),
                ("qwen25_int8", "qwen2.5-3b", 64,
                 {"kv_cache_dtype": "int8"}),
                ("gemma3", "gemma3-27b", 96, {}),
                ("mamba2", "mamba2-2.7b", 64, {}),
                ("rgemma", "recurrentgemma-2b", 64, {}),
                ("seamless", "seamless-m4t-medium", 64, {}))
DECODE = tuple((f"{n}_{'2x2' if b > 1 else '1x4'}", a, shape, b, L, kw)
               for n, a, L, kw in DECODE_ARCHS
               for shape, b in (((2, 2), 4), ((1, 4), 1)))
ENCDEC_MEMORY = 8
DECODE_STEPS = 3
# the serve chunk and the engine: qwen2-moe-a2.7b on (2, 2)
SERVE_CHUNK = 4
ENGINE_REQUESTS = ((20, 6), (9, 8), (13, 5), (26, 4), (7, 7))
ENGINE_KW = dict(batch_slots=4, cache_len=64, prefill_chunk=8)
ENGINE_TRUST = dict(audit_rate=1.0, num_verifiers=1, challenge_window=4)
ENGINE_KV = dict(block_tokens=8)
# the counted decode step the dry run's abstract mesh is held to
DECODE_SHAPE = dict(kind="decode", seq=64, batch=4)


def ep_cfg(**kw):
    """qwen2-moe-a2.7b at smoke width: 4 experts (unpadded), top-2, one
    shared expert, ``moe_impl="ep"``."""
    return dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True),
                               **kw)


def step_cfg(name: str, **kw):
    if name == "qwen_ep":
        return ep_cfg(**kw)
    if name == "qwen_trusted":
        return ep_cfg(redundancy=RedundancyConfig(2, "faithful"), **kw)
    return dataclasses.replace(get_config("bmoe-paper", smoke=True), **kw)


def decode_cfg(arch: str, batch: int, **kw):
    """``arch``'s smoke config for a decode case: its cache over
    ``model`` at batch > 1, over ``data`` x ``model`` (and the batch not
    split) at batch 1."""
    return dataclasses.replace(
        get_config(arch, smoke=True), cache_seq_axes=("model",) if batch > 1
        else ("data", "model"), batch_shardable=batch > 1, **kw)


def cache_decl(cfg, batch: int, cache_len: int):
    if cfg.is_encoder_decoder:
        return encdec.encdec_cache_decl(cfg, batch, cache_len,
                                         ENCDEC_MEMORY)
    return tfm.cache_decl(cfg, batch, cache_len)


def random_caches(cfg, batch: int, cache_len: int, rng):
    """A whole cache tree of ``cfg`` as numpy, every slot filled from
    ``rng`` (int8 values and positive scales for an int8 cache), so
    every masked slot would show in the scores if it leaked."""
    cached = materialize(cache_decl(cfg, batch, cache_len), 0, "cpu")
    flat, _ = tree_flatten(cached)
    path = [k for k, _ in _leaf_paths(cached)]
    out = []
    for k, t in zip(path, flat):
        if t.dtype == torch.int8:
            out.append(rng.integers(-127, 128, t.shape).astype(np.int8))
        elif k.endswith("_scale"):
            out.append((np.abs(rng.standard_normal(t.shape)) * 0.01
                        + 1e-3).astype(np.float32))
        else:
            out.append(rng.standard_normal(t.shape).astype(np.float32))
    return tree_to_numpy(tree_unflatten(cached, [torch.from_numpy(a)
                                                 for a in out]))


def _leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in tree for p in _leaf_paths(tree[k],
                                                     f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def decode_batches(cfg, batch: int, cache_len: int, rng):
    """``DECODE_STEPS`` global batches: tokens, ``pos`` and (decoder-only
    at batch > 1) ``active``.  At batch 4 the rows start at 2, at the
    last slot of model rank 0's half, at the first of rank 1's and at
    the last slot (the next steps run past the linear cache's end, and
    the ring's slots cross its ranks' boundary and wrap); row 2 is
    inactive at step 1.  At batch 1 ``pos`` is a scalar: the end of
    rank 0's quarter, the last slot, past the end."""
    out = []
    for t in range(DECODE_STEPS):
        b = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (batch, 1)).astype(np.int32)}
        if batch > 1:
            b["pos"] = np.array([2, cache_len // 2 - 1, cache_len // 2,
                                 cache_len - 1], np.int32) + t
            if not cfg.is_encoder_decoder:
                b["active"] = np.array([True, True, t != 1, True])
        else:
            b["pos"] = int((cache_len // 4 - 1, cache_len - 1,
                            cache_len + 2)[t])
        out.append(b)
    return out


def serve_chunk_batch(cfg, rng):
    """One serve chunk's global batch of 4 slots: prefilling, decoding
    and idle slots, positions on both sides of model rank 1's first
    slot."""
    C = SERVE_CHUNK
    return {"tokens": rng.integers(0, cfg.vocab_size, (4, C)).astype(
                np.int32),
            "start": rng.integers(0, cfg.vocab_size, 4).astype(np.int32),
            "pos": np.array([2, 30, 33, 50], np.int32),
            "lengths": np.array([4, 2, 0, 1], np.int32),
            "adv": np.array([4, 4, 4, 0], np.int32)}


def engine_requests(vocab: int):
    return [{"id": i, "prompt": np.random.default_rng(i).integers(
        0, vocab, n).astype(np.int32), "max_new_tokens": m}
        for i, (n, m) in enumerate(ENGINE_REQUESTS)]


def make_inputs() -> dict:
    """Every case's inputs as numpy: an EP layer's parameters, the x's,
    the vote's buffer, each step's model and the token batch, and the
    decode cases' models, caches and batches."""
    rng = np.random.default_rng(0)
    cfg = ep_cfg()
    d = cfg.d_model
    dec_rng = np.random.default_rng(1)
    decode = {}
    for name, arch, _, B, L, kw in DECODE:
        c = decode_cfg(arch, B, **kw)
        decode[name] = {"caches": random_caches(c, B, L, dec_rng),
                        "batches": decode_batches(c, B, L, dec_rng)}
    return {
        "decode": decode,
        "decode_models": {a: tree_to_numpy(init_model(
            get_config(a, smoke=True), 1, "cpu"))
            for a in sorted({c[1] for c in DECODE})},
        "serve_chunk": {"caches": random_caches(
            ep_cfg(), 4, 64, dec_rng), "batch": serve_chunk_batch(
            ep_cfg(), dec_rng)},
        "moe": tree_to_numpy(materialize(moe_lib.moe_decl(cfg), 0, "cpu")),
        "x": {name: rng.standard_normal((B, S, d), dtype=np.float32)
              for name, _, (B, S) in EP_LAYER},
        "x_trust": rng.standard_normal((4, 16, d), dtype=np.float32),
        "y_vote": rng.standard_normal((2, 8, 4, 16), dtype=np.float32),
        "models": {name: tree_to_numpy(init_model(step_cfg(name), 1, "cpu"))
                   for name, _ in STEPS},
        "tokens": rng.integers(0, cfg.vocab_size, TOKENS).astype(np.int32),
    }


def _mesh(shape):
    return make_lm_mesh(shape, AXES[len(shape)], device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().cpu().numpy()


def _ep_layer(inp, res):
    """``moe_mlp_ep`` at the default capacity on each case's mesh: this
    rank's batch rows of y and the aux loss."""
    cfg = ep_cfg()
    full = lm_params_from_numpy(inp["moe"], device="cpu")
    for name, shape, _ in EP_LAYER:
        mesh = _mesh(shape)
        p = _local_experts(full, mesh)
        x = _t(inp["x"][name])
        lo, hi = mesh.batch_rows(x.shape[0])
        y, aux = moe_mlp_ep(p, x[lo:hi], cfg, mesh)
        res[f"ep/{name}"] = {"rows": (lo, hi), "y": _np(y),
                             "aux": float(aux),
                             "wire": dict(mesh.wire_bytes)}


def _local_experts(moe, mesh):
    """One MoE layer's tree with this rank's contiguous expert rows."""
    e_l = moe["w_gate"].shape[0] // mesh.model.shards
    lo = mesh.model.shard * e_l
    return {k: (v[lo:lo + e_l] if k in ("w_gate", "w_up", "w_down") else v)
            for k, v in moe.items()}


def _trust(inp, res):
    """``make_trust`` on (1, 4, 1) with r=4 and (1, 2, 2) with r=2, both
    modes: clean, a minority and a majority coalition; and the EP layer
    with the vote on (1, 2, 2)."""
    y = _t(inp["y_vote"])
    for shape in ((1, 4, 1), (1, 2, 2)):
        mesh, r = _mesh(shape), shape[1]
        for mode in ("faithful", "digest"):
            out = {}
            for who, mal in (("clean", ()), ("minority", MINORITY[r]),
                             ("majority", MAJORITY[r])):
                hook = make_trust(mesh, RedundancyConfig(r, mode), True,
                                  LMAttack(malicious_replicas=mal,
                                           noise_std=3.0))
                out[who] = _np(hook(y.clone()))
            res[f"trust/{shape}/{mode}"] = out
    mesh = _mesh((1, 2, 2))
    x = _t(inp["x_trust"])
    for mode in ("faithful", "digest"):
        cfg = ep_cfg(redundancy=RedundancyConfig(2, mode))
        p = _local_experts(lm_params_from_numpy(inp["moe"], "cpu"), mesh)
        out = {}
        for who, c, mal in (
                ("clean", cfg, None), ("minority", cfg, (1,)),
                ("majority", cfg, (0, 1)),
                ("no_shared_majority",
                 dataclasses.replace(cfg, num_shared_experts=0), (0, 1)),
                ("no_shared_clean",
                 dataclasses.replace(cfg, num_shared_experts=0), None)):
            atk = None if mal is None else LMAttack(malicious_replicas=mal,
                                                    noise_std=4.0)
            out[who] = _np(moe_mlp_ep(p, x, c, mesh, attack=atk)[0])
        res[f"ep_trust/{mode}"] = out


def _batch(inp):
    t = _t(inp["tokens"]).long()
    return {"tokens": t, "labels": t}


def _steps(inp, res):
    """One ``make_train_step`` and one ``make_prefill_step`` a case from
    the JAX-side init, on the case's mesh."""
    batch = _batch(inp)
    for name, shape in STEPS:
        cfg = step_cfg(name)
        mesh = _mesh(shape)
        full = lm_params_from_numpy(inp["models"][name], device="cpu")
        nxt = st.make_prefill_step(cfg, mesh)(shard_params(full, cfg, mesh),
                                              {"tokens": batch["tokens"]})
        p = shard_params(full, cfg, mesh)
        step = st.make_train_step(cfg, adamw.AdamWConfig(total_steps=10),
                                  mesh, remat=False)
        p, _, m = step(p, adamw.init(p), batch)
        whole = gather_params(p, cfg, mesh)
        res[f"step/{name}"] = {
            "next": _np(nxt), "metrics": {k: float(v) for k, v in m.items()},
            "digest": digest_tree(whole),
            "params": tree_to_numpy(whole) if mesh.rank == 0 else None}


def _grads(cfg, params, batch, mesh=None):
    """(loss, aux, the whole gradient tree, logits of this rank's rows)."""
    loss, aux, g = st.make_loss_and_grads(cfg, remat=False, mesh=mesh)(
        params, batch)
    g = gather_params(g, cfg, mesh)
    lo, hi = (0, batch["tokens"].shape[0]) if mesh is None else \
        mesh.batch_rows(batch["tokens"].shape[0])
    shard = step_sharder(cfg, mesh, "train")
    with torch.no_grad():
        logits, _ = tfm.forward_train(params, batch["tokens"][lo:hi], cfg,
                                      shard=shard)
    return float(loss), float(aux), g, tfm.gather_vocab(logits, shard)


def _diff(a, b, rel: bool):
    """The largest difference of two trees' leaves, relative to each
    leaf's largest magnitude when ``rel``."""
    out = 0.0
    for x, y in zip(tree_flatten(a)[0], tree_flatten(b)[0]):
        d = (x - y).abs().max().item()
        if rel:
            d /= max(y.abs().max().item(), 1e-30)
        out = max(out, d)
    return out


def _against_one_device(inp, res):
    """Capacity factor 8 (nothing dropped): the mesh against the port's
    own one-device run from the same parameters."""
    batch = _batch(inp)
    for name, shape, mcfg in (
            ("ep_1x4", (1, 4), step_cfg("qwen_ep", capacity_factor=8.0)),
            ("trusted_1x2x2", (1, 2, 2),
             step_cfg("qwen_trusted", capacity_factor=8.0)),
            ("bmoe_1x2x2", (1, 2, 2), step_cfg("bmoe")),
            ("ep_2x2", (2, 2), step_cfg("qwen_ep", capacity_factor=8.0))):
        key = "qwen_ep" if name.startswith("ep") else (
            "qwen_trusted" if name.startswith("trusted") else "bmoe")
        full = lm_params_from_numpy(inp["models"][key], device="cpu")
        mesh = _mesh(shape)
        one = [_grads(mcfg, full, batch) if mesh.rank == 0 else None]
        dist.broadcast_object_list(one, src=0)   # one run, not one a rank
        one = one[0]
        on = _grads(mcfg, shard_params(full, mcfg, mesh), batch, mesh)
        lo, hi = mesh.batch_rows(TOKENS[0])
        out = {"loss": (on[0], one[0]), "aux": (on[1], one[1]),
               "grads_rel": _diff(on[2], one[2], rel=True),
               "logits_abs": (on[3] - one[3][lo:hi]).abs().max().item(),
               "logits_max": one[3].abs().max().item()}
        if name == "trusted_1x2x2":
            # a minority-attacked step against the clean one, bitwise
            digests = []
            for atk in (None, LMAttack(malicious_replicas=(1,),
                                       noise_std=5.0)):
                # the step updates in place: each run from a fresh tree
                p = shard_params(lm_params_from_numpy(
                    inp["models"][key], device="cpu"), mcfg, mesh)
                step = st.make_train_step(
                    mcfg, adamw.AdamWConfig(total_steps=10), mesh,
                    attack=atk, remat=False)
                p, _, m = step(p, adamw.init(p), batch)
                digests.append((float(m["loss"]), digest_tree(p)))
            out["attacked_step_bitwise"] = digests[0] == digests[1]
        res[f"one_device/{name}"] = out


def _counted_steps(inp, res):
    """One qwen2-moe EP prefill and one training step on (2, 2), each on
    a fresh mesh and counted (``launch.opanalysis``): this rank's
    ``wire_bytes`` and the count, which the abstract mesh's dry run of
    the same steps must give."""
    cfg = step_cfg("qwen_ep")
    batch = _batch(inp)
    full = lm_params_from_numpy(inp["models"]["qwen_ep"], device="cpu")
    out = {}
    for kind in ("prefill", "train"):       # the step updates in place
        mesh = _mesh((2, 2))
        p = shard_params(full, cfg, mesh, kind)
        opt = adamw.init(p) if kind == "train" else None
        args = (batch if kind == "train" else {"tokens": batch["tokens"]},)
        rec = dryrun.count_step(dryrun.make_step_fn(cfg, kind, mesh,
                                                    remat=False),
                                p, opt, args)
        out[kind] = {"wire": dict(mesh.wire_bytes), "count": rec.as_dict()}
    # one decode step at the dry run's inputs (the cache split over model)
    mesh = _mesh((2, 2))
    dcfg = shape_config(cfg, DECODE_SHAPE)
    p, _, args = dryrun.inputs(dcfg, DECODE_SHAPE, mesh, device="cpu")
    rec = dryrun.count_step(dryrun.make_step_fn(dcfg, "decode", mesh),
                            p, None, args)
    out["decode"] = {"wire": dict(mesh.wire_bytes), "count": rec.as_dict()}
    res["counted_steps"] = out


def _dec_tensors(b):
    return {k: (torch.from_numpy(np.array(v)).long() if k != "active"
                else torch.from_numpy(np.array(v)))
            if not isinstance(v, int) else v for k, v in b.items()}


def _decode_run(cfg, params, caches, batches, mesh, es):
    """The decode steps of one case on ``mesh`` (None: one device):
    per step the next tokens, this rank's logits and row range and the
    counts; then the caches, gathered whole."""
    step = st.make_decode_step(cfg, expert_stats=es, mesh=mesh)
    shard = step_sharder(cfg, mesh, "decode")
    caches = shard_caches(caches, cfg, mesh)
    steps = []
    for b in batches:
        b = _dec_tensors(b)
        n = b["tokens"].shape[0]
        lo, hi = (0, n) if mesh is None else mesh.batch_rows(n, cfg)
        mine = st._local_rows(b, mesh, cfg)
        if cfg.is_encoder_decoder:
            logits, _ = encdec.forward_decode(params, caches, mine["tokens"],
                                              mine["pos"], cfg, shard=shard)
        else:
            logits = tfm.forward_decode(
                params, caches, mine["tokens"], mine["pos"], cfg,
                shard=shard, write_mask=mine.get("active"))[0]
        out = step(params, caches, b)
        caches = out[1]
        logits = tfm.gather_vocab(logits, shard)
        steps.append({"next": _np(out[0]), "logits": _np(logits[:, -1]),
                      "rows": (lo, hi),
                      "stats": _np(out[2]) if es else None})
    return steps, gather_caches(caches, cfg, mesh), caches


def _decode(inp, res):
    """Every ``DECODE`` case on its mesh from the same caches and
    batches (the JAX package's run is held to it in the test), every
    rank's results; and on (4, 1) and (1, 4, 1), where the cache group
    has width one, against the one-device decode."""
    for name, arch, shape, B, L, kw in DECODE:
        cfg = decode_cfg(arch, B, **kw)
        mesh = _mesh(shape)
        full = lm_params_from_numpy(inp["decode_models"][arch],
                                    device="cpu")
        case = inp["decode"][name]
        caches = lm_params_from_numpy(case["caches"], device="cpu")
        es = cfg.num_experts > 0
        steps, whole, _ = _decode_run(
            cfg, shard_params(full, cfg, mesh), caches, case["batches"],
            mesh, es)
        one, one_whole, _ = _decode_run(cfg, full, caches, case["batches"],
                                        None, es)
        res[f"decode/{name}"] = {
            "steps": steps, "digest": digest_tree(whole),
            "caches": tree_to_numpy(whole) if mesh.rank == 0 else None,
            "wire": dict(mesh.wire_bytes),
            "one_device": {
                "next": [o["next"] for o in one],
                "stats": [o["stats"] for o in one],
                "logits_diff": max(float(np.abs(
                    a["logits"] - b["logits"][slice(*a["rows"])]).max())
                    for a, b in zip(steps, one)),
                "caches_diff": _diff(whole, one_whole, rel=False)}}


def _decode_width1(inp, res):
    """Where the cache group has width one the mesh decode is the
    one-device decode bit for bit: on (4, 1) against one device on the
    rank's own row (the CPU's products round by row count, so a 4-row
    one-device batch is not the reference), on (1, 4, 1) against one
    device on the whole batch."""
    out = {}
    for name, arch, shape, B, L, kw in DECODE:
        if B == 1:
            continue
        cfg = decode_cfg(arch, B, **kw)
        full = lm_params_from_numpy(inp["decode_models"][arch],
                                    device="cpu")
        case = inp["decode"][name]
        caches = lm_params_from_numpy(case["caches"], device="cpu")
        es = cfg.num_experts > 0
        for mshape in ((4, 1), (1, 4, 1)):
            mesh = _mesh(mshape)
            on, _, mine = _decode_run(cfg, shard_params(full, cfg, mesh),
                                      caches, case["batches"], mesh, es)
            lo, hi = mesh.batch_rows(B, cfg)
            rows = [st._local_rows(b, mesh, cfg) for b in case["batches"]]
            # the rank's rows of the cache: its part, the group being one
            one, _, theirs = _decode_run(cfg, full,
                                         shard_caches(caches, cfg, mesh),
                                         rows, None, es)
            out[f"{name}/{mshape}"] = all(
                np.array_equal(a["logits"], b["logits"])
                and np.array_equal(a["next"][lo:hi], b["next"])
                and (not es or np.array_equal(a["stats"], b["stats"])
                     or hi - lo < B)
                for a, b in zip(on, one)) and \
                digest_tree(mine) == digest_tree(theirs)
    res["decode_width1"] = out


def _serve_chunk(inp, res):
    """qwen2-moe-a2.7b's serve chunk on (2, 2) with its counts."""
    cfg = ep_cfg()
    mesh = _mesh((2, 2))
    full = lm_params_from_numpy(inp["models"]["qwen_ep"], device="cpu")
    caches = shard_caches(lm_params_from_numpy(
        inp["serve_chunk"]["caches"], device="cpu"), cfg, mesh)
    batch = {k: torch.from_numpy(v) for k, v in
             inp["serve_chunk"]["batch"].items()}
    outs, caches, stats = st.make_serve_chunk_step(
        cfg, expert_stats=True, mesh=mesh)(shard_params(full, cfg, mesh),
                                           caches, batch)
    whole = gather_caches(caches, cfg, mesh)
    res["serve_chunk"] = {
        "tokens": _np(outs), "stats": _np(stats),
        "digest": digest_tree(whole),
        "caches": tree_to_numpy(whole) if mesh.rank == 0 else None}


def serve_engine(cfg, params, mesh):
    """The engine case: 5 requests through 4 slots with verified
    sessions, edge expert storage and KV paging; slot 1 paged out after
    its third token and resumed.  Returns what the test compares."""
    from repro_torch.serve.engine import EdgeStorageConfig, ServingEngine
    from repro_torch.storage.kv import KVStorageConfig
    from repro_torch.trust.protocol import TrustConfig
    eng = ServingEngine(cfg, params, mesh=mesh, **ENGINE_KW,
                        trust=TrustConfig(**ENGINE_TRUST),
                        expert_storage=EdgeStorageConfig(),
                        kv_storage=KVStorageConfig(**ENGINE_KV))
    return engine_outcome(eng, engine_requests(cfg.vocab_size))


def engine_outcome(eng, reqs):
    """Serve ``reqs`` on ``eng`` (either package's engine) with the
    page-out, and read what the test compares."""
    eng.submit(reqs)
    while (not eng.sched.slots[1].decoding
           or len(eng.sched.slots[1].generated) < 3):
        assert eng.step()
    eng.page_out(1)
    done = eng.run()
    rep = eng.report()
    return {"done": {k: list(map(int, v)) for k, v in done.items()},
            "ticks": [(t.tick, t.root, tuple(t.request_ids), bool(t.kv_root))
                      for t in eng.tick_commitments],
            "kv_roots": [t.kv_root for t in eng.tick_commitments],
            "cids": list(eng.kvrt.kv.sealed_cids()),
            "edge": rep["edge"], "kv": rep["kv"]}


def _engine(inp, res):
    """``ServingEngine(mesh=)`` on (2, 2) against the port's one-device
    engine (rank 0 runs it and broadcasts)."""
    cfg = ep_cfg()
    full = lm_params_from_numpy(inp["models"]["qwen_ep"], device="cpu")
    mesh = _mesh((2, 2))
    one = [serve_engine(cfg, full, None) if mesh.rank == 0 else None]
    dist.broadcast_object_list(one, src=0)
    res["engine"] = {"mesh": serve_engine(cfg, shard_params(full, cfg,
                                                             mesh), mesh),
                     "one_device": one[0]}


def _cache_round_trip(inp, res):
    """``shard_caches`` then ``gather_caches`` gives back every config's
    whole cache bit for bit, at batch 4 over ``model`` on (2, 2) and at
    batch 1 over ``data`` x ``model`` on (1, 4); the rank's leaf shapes
    equal ``place_cache``'s declaration."""
    from repro_torch.configs import ARCH_IDS
    from repro_torch.sharding import place_cache
    rng = np.random.default_rng(2)
    out = {}
    for arch in ARCH_IDS:
        for shape, B in (((2, 2), 4), ((1, 4), 1)):
            cfg = decode_cfg(arch, B)
            mesh = _mesh(shape)
            whole = lm_params_from_numpy(random_caches(cfg, B, 64, rng),
                                         device="cpu")
            mine = shard_caches(whole, cfg, mesh)
            local = materialize(place_cache(cache_decl(cfg, B, 64), cfg,
                                            mesh), 0, "cpu")
            shapes_ok = [t.shape for t in tree_flatten(mine)[0]] == \
                [t.shape for t in tree_flatten(local)[0]]
            back = gather_caches(mine, cfg, mesh)
            out[f"{arch}/{shape}"] = shapes_ok and \
                digest_tree(back) == digest_tree(whole)
    res["cache_round_trip"] = out


def lm_rank(rank: int, world: int, in_path: str, out_dir: str) -> None:
    """A rank of the test's world: every case, results to
    ``<out_dir>/rank<r>.pkl``."""
    torch.set_num_threads(1)
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    res = {}
    for case in (_ep_layer, _trust, _steps, _against_one_device,
                 _counted_steps, _decode, _decode_width1, _serve_chunk,
                 _engine, _cache_round_trip):
        case(inp, res)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def card_rank(rank: int, world: int, out_dir: str) -> None:
    """A rank of ``tests/test_torch_cuda.py``'s 2-rank EP case on the
    card: qwen2-moe-a2.7b at smoke width, capacity factor 8, on (1, 2);
    the prefill's logits and the loss and gradients against the
    one-device run on the same card, and the prefill's launches."""
    from repro_torch.kernels import ops
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ep_cfg(capacity_factor=8.0)
    mesh = make_lm_mesh((1, 2), ("data", "model"))
    full = init_model(cfg, 1, mesh.device)
    batch = {k: v.to(mesh.device) for k, v in _batch(make_inputs()).items()}
    p = shard_params(full, cfg, mesh)
    ops.reset_launch_counts()
    st.make_prefill_step(cfg, mesh)(p, {"tokens": batch["tokens"]})
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    one = _grads(cfg, full, batch)
    on = _grads(cfg, p, batch, mesh)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"launches": launches,
                     "loss": (on[0], one[0]), "aux": (on[1], one[1]),
                     "grads_rel": _diff(on[2], one[2], rel=True),
                     "logits_abs": (on[3] - one[3]).abs().max().item(),
                     "logits_max": one[3].abs().max().item()}, f)
