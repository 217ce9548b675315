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
data axis of 2) run that run on rank 0, which broadcasts it."""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, tree_to_numpy
from repro_torch.core.ledger import digest_tree, tree_flatten
from repro_torch.core.trusted_moe import LMAttack, make_trust
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_lm_mesh
from repro_torch.models import moe as moe_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.builder import materialize
from repro_torch.models.config import RedundancyConfig
from repro_torch.models.moe_ep import moe_mlp_ep
from repro_torch.optim import adamw
from repro_torch.sharding import (Sharder, gather_params, logical_rules,
                                  shard_params)
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


def make_inputs() -> dict:
    """Every case's inputs as numpy: an EP layer's parameters, the x's,
    the vote's buffer, each step's model and the token batch."""
    rng = np.random.default_rng(0)
    cfg = ep_cfg()
    d = cfg.d_model
    return {
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
    shard = None if mesh is None else Sharder(mesh,
                                              logical_rules(mesh, cfg))
    with torch.no_grad():
        logits, _ = tfm.forward_train(params, batch["tokens"][lo:hi], cfg,
                                      shard=shard)
    return float(loss), float(aux), g, logits


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
               "grads_bitwise": digest_tree(on[2]) == digest_tree(one[2]),
               "grads_rel": _diff(on[2], one[2], rel=True),
               "logits_bitwise": torch.equal(on[3], one[3][lo:hi]),
               "logits_abs": (on[3] - one[3][lo:hi]).abs().max().item()}
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
        p = shard_params(full, cfg, mesh)
        opt = adamw.init(p) if kind == "train" else None
        args = (batch if kind == "train" else {"tokens": batch["tokens"]},)
        rec = dryrun.count_step(dryrun.make_step_fn(cfg, kind, mesh,
                                                    remat=False),
                                p, opt, args)
        out[kind] = {"wire": dict(mesh.wire_bytes), "count": rec.as_dict()}
    res["counted_steps"] = out


def lm_rank(rank: int, world: int, in_path: str, out_dir: str) -> None:
    """A rank of the test's world: every case, results to
    ``<out_dir>/rank<r>.pkl``."""
    torch.set_num_threads(1)
    with open(in_path, "rb") as f:
        inp = pickle.load(f)
    res = {}
    for case in (_ep_layer, _trust, _steps, _against_one_device,
                 _counted_steps):
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
                     "logits_bitwise": torch.equal(on[3], one[3])}, f)
