"""The LM stack on a mesh in the port, on the CPU: expert parallelism
(``models.moe_ep``), ``route_masked``, the LM-scale B-MoE vote
(``core.trusted_moe``), the mesh layouts and rules (``launch.mesh``,
``sharding``), training and prefill under a mesh, and decode, the
serving chunk and the serving engine on a mesh with the decode caches
placed by the JAX package's rules (``sharding.shard_caches``).

One world of 4 ranks over gloo (``launch.mesh.spawn_edges``, one
intra-op thread a rank, collectives with a time limit) runs every case of
``torch_lm_mesh_ranks`` once.  While it runs, one forced-8-device
subprocess runs the same cases in the JAX package on meshes built here
with ``AxisType.Auto`` axes (the reference's own ``jax.make_mesh`` gives
Explicit axes, which its ``with_sharding_constraint`` refuses on jax
0.9); both sides take the same numpy inputs.  The port is held to JAX at
1e-5 (y, steps) and 1e-6 (aux), and to its own one-device run: bitwise
where the expert buffers' layouts coincide, within 1e-6 elsewhere.
Decode is held to JAX's decode on the same mesh (next tokens and expert
counts exactly, logits and the gathered caches at 1e-5), to the port's
one-device decode at 1e-5, and bit for bit where the cache group has
width one.  The dry run's abstract mesh is held to the world's counts of
one EP prefill, training and decode step, rank by rank."""
import dataclasses
import math
import pickle
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_mesh_ranks as ranks
from conftest import run_with_devices
from repro import sharding as jsharding
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models.moe import route as jroute
from repro.models.moe import route_masked as jroute_masked
from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.ledger import digest_tree
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as lmesh
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import moe as moe_lib
from repro_torch.models.moe_ep import moe_mlp_ep
from repro_torch.train.loop import init_model

JAX_CASES = """
import os
# small compiled programs: a cheaper compile (the device count is set)
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true"
                            " --xla_cpu_multi_thread_eigen=false")
import dataclasses, pickle
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models.config import RedundancyConfig
from repro.models.moe_ep import moe_mlp_ep
from repro.optim import adamw
from repro.sharding import logical_rules
from repro.train.step import make_prefill_step, make_train_step

from repro.models import encdec as jencdec
from repro.models import transformer as jtfm
from repro.serve.engine import EdgeStorageConfig, ServingEngine
from repro.sharding import Sharder, use_fsdp
from repro.storage.kv import KVStorageConfig
from repro.train.step import make_serve_chunk_step
from repro.trust.protocol import TrustConfig

inp = pickle.load(open({inp!r}, "rb"))
names = {{2: ("data", "model"), 3: ("data", "replica", "model")}}
def mesh(shape):
    return jax.make_mesh(shape, names[len(shape)],
                         axis_types=(AxisType.Auto,) * len(shape))
def ep_cfg(**kw):
    return dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True),
                               **kw)
cfgs = {{"qwen_ep": ep_cfg(),
        "qwen_trusted": ep_cfg(redundancy=RedundancyConfig(2, "faithful")),
        "bmoe": get_config("bmoe-paper", smoke=True)}}
tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
host = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {{}}
moe = tree(inp["moe"])
for name, shape, _ in inp["ep_layer"]:
    m, cfg = mesh(shape), ep_cfg()
    rules = logical_rules(m, cfg)
    with m:
        y, aux = jax.jit(lambda p, x: moe_mlp_ep(
            p, x, cfg, m, rules, fsdp=False))(moe, jnp.asarray(inp["x"][name]))
    out["ep/" + name] = (np.asarray(y), float(aux))
m = mesh((1, 2, 2))
for mode in ("faithful", "digest"):
    cfg = ep_cfg(redundancy=RedundancyConfig(2, mode))
    rules = logical_rules(m, cfg)
    with m:
        y, _ = jax.jit(lambda p, x: moe_mlp_ep(
            p, x, cfg, m, rules, fsdp=False))(moe, jnp.asarray(inp["x_trust"]))
    out["ep_trust/" + mode] = np.asarray(y)
toks = jnp.asarray(inp["tokens"])
for name, shape in inp["steps"]:
    cfg, m = cfgs[name], mesh(shape)
    params = tree(inp["models"][name])
    with m:
        nxt = jax.jit(make_prefill_step(cfg, m))(params, {{"tokens": toks}})
        p2, _, met = jax.jit(make_train_step(
            cfg, adamw.AdamWConfig(total_steps=10), m, remat=False))(
            params, adamw.init(params), {{"tokens": toks, "labels": toks}})
    out["step/" + name] = {{"next": np.asarray(nxt), "params": host(p2),
                          "metrics": {{k: float(v) for k, v in met.items()}}}}

# decode: make_decode_step's body (its sharder, forward_decode, the
# argmax) with the logits kept
def decode_fn(cfg, m):
    shard = Sharder(m, logical_rules(m, cfg),
                    fsdp=use_fsdp(cfg, "decode", m.devices.shape[-1]))
    es = cfg.num_experts > 0
    def fwd(p, c, b):
        if cfg.is_encoder_decoder:
            logits, c = jencdec.forward_decode(p, c, b["tokens"], b["pos"],
                                               cfg, shard=shard)
            return logits, c, None
        o = jtfm.forward_decode(p, c, b["tokens"], b["pos"], cfg,
                                shard=shard, expert_stats=es,
                                write_mask=b.get("active"))
        return o if es else (*o, None)
    return jax.jit(fwd)
for name, arch, shape, B, L, kw in inp["decode_cases"]:
    cfg = dataclasses.replace(
        get_config(arch, smoke=True), batch_shardable=B > 1,
        cache_seq_axes=("model",) if B > 1 else ("data", "model"), **kw)
    m, params = mesh(shape), tree(inp["decode_models"][arch])
    caches, steps = tree(inp["decode"][name]["caches"]), []
    with m:
        fn = decode_fn(cfg, m)
        for b in inp["decode"][name]["batches"]:
            logits, caches, stats = fn(params, caches, {{
                k: jnp.asarray(v) for k, v in b.items()}})
            steps.append({{"logits": np.asarray(logits[:, -1]),
                          "next": np.asarray(logits[:, -1].argmax(-1)),
                          "stats": None if stats is None
                          else np.asarray(stats)}})
    out["decode/" + name] = {{"steps": steps, "caches": host(caches)}}

# the serve chunk and the engine: qwen2-moe-a2.7b on (2, 2)
cfg, m = cfgs["qwen_ep"], mesh((2, 2))
params = tree(inp["models"]["qwen_ep"])
with m:
    toks, caches, stats = jax.jit(make_serve_chunk_step(
        cfg, m, expert_stats=True))(params, tree(inp["serve_chunk"][
            "caches"]), tree(inp["serve_chunk"]["batch"]))
out["serve_chunk"] = {{"tokens": np.asarray(toks), "stats": np.asarray(stats),
                      "caches": host(caches)}}
eng = ServingEngine(cfg, params, mesh=m, **inp["engine"]["kw"],
                    trust=TrustConfig(**inp["engine"]["trust"]),
                    expert_storage=EdgeStorageConfig(),
                    kv_storage=KVStorageConfig(**inp["engine"]["kv"]))
with m:
    eng.submit([dict(r) for r in inp["engine"]["requests"]])
    while (not eng.sched.slots[1].decoding
           or len(eng.sched.slots[1].generated) < 3):
        assert eng.step()
    eng.page_out(1)
    done = eng.run()
rep = eng.report()
out["engine"] = {{
    "done": {{k: list(map(int, v)) for k, v in done.items()}},
    "ticks": [(t.tick, t.root, tuple(t.request_ids), bool(t.kv_root))
              for t in eng.tick_commitments],
    "cids": list(eng.kvrt.kv.sealed_cids()),
    "edge": rep["edge"], "kv": rep["kv"]}}
pickle.dump(out, open({out!r}, "wb"))
print("JAX CASES OK")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread in this process for the module (its tensors
    are tiny: a thread pool costs more than it gives)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory, repo_src):
    """(the 4 ranks' results, the JAX package's, the inputs): the world
    and the JAX subprocess run at the same time."""
    d = tmp_path_factory.mktemp("lm_mesh")
    inp = ranks.make_inputs()
    inp.update(ep_layer=ranks.EP_LAYER, steps=ranks.STEPS,
               decode_cases=ranks.DECODE,
               engine={"kw": ranks.ENGINE_KW, "trust": ranks.ENGINE_TRUST,
                       "kv": ranks.ENGINE_KV,
                       "requests": ranks.engine_requests(
                           ranks.ep_cfg().vocab_size)})
    in_path, jax_path = str(d / "in.pkl"), str(d / "jax.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inp, f)
    jax_out = {}

    def run_jax():
        try:
            jax_out["stdout"] = run_with_devices(
                JAX_CASES.format(inp=in_path, out=jax_path), 8, repo_src,
                timeout=900)
        except BaseException as e:      # re-raised in the test thread
            jax_out["error"] = e

    th = threading.Thread(target=run_jax)
    th.start()
    try:
        lmesh.spawn_edges(ranks.lm_rank, ranks.WORLD,
                          args=(in_path, str(d)), device="cpu",
                          rendezvous_dir=str(d), timeout_s=900)
    finally:
        th.join(timeout=960)
    assert not th.is_alive(), "the JAX subprocess did not end"
    if "error" in jax_out:
        raise jax_out["error"]
    assert "JAX CASES OK" in jax_out["stdout"]
    res = []
    for r in range(ranks.WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    with open(jax_path, "rb") as f:
        ref = pickle.load(f)
    return res, ref, inp


# ------------------------------------------------------- route_masked
def _route_inputs():
    """tests/test_moe_ep_edges.py's three host inputs: (logits, k,
    capacity, num_real, valid)."""
    a = jax.random.normal(jax.random.PRNGKey(0), (2, 16, 8))
    b = jax.random.normal(jax.random.PRNGKey(1), (1, 6, 4))
    c = jnp.zeros((1, 4, 2)).at[:, :, 0].set(5.0)
    return {"unmasked": (a, 2, 4, 8, None),
            "pad_rows_inert": (b, 2, 2, 4, [[True] * 4 + [False] * 2]),
            "pad_rows_no_capacity": (c, 1, 2, 2, [[True, False, True,
                                                   True]])}


@pytest.mark.parametrize("case", ["unmasked", "pad_rows_inert",
                                  "pad_rows_no_capacity"])
def test_route_masked_matches_jax(case):
    logits, k, cap, num_real, valid = _route_inputs()[case]
    want = jroute_masked(logits, k, cap, num_real,
                         valid=None if valid is None else jnp.asarray(valid))
    got = moe_lib.route_masked(
        torch.from_numpy(np.array(logits)), k, cap, num_real,
        valid=None if valid is None else torch.tensor(valid))
    for g, w in zip(got[:4], want[:4]):
        if w.dtype == jnp.bool_ or jnp.issubdtype(w.dtype, jnp.integer):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6)
    for g, w in zip(got[4], want[4]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    if valid is None:
        # unmasked: route's routing bit for bit, and its aux
        r = moe_lib.route(torch.from_numpy(np.array(logits)), k, cap,
                          num_real)
        for g, w in zip(got[:4], r[:4]):
            assert torch.equal(g, w)
        aux = moe_lib.aux_from_stats(got[4], 8, k)
        assert torch.equal(aux, r[4])
        np.testing.assert_allclose(float(aux), float(jroute(
            logits, k, cap, num_real)[4]), rtol=0, atol=1e-6)


# ------------------------------------------------------------ EP layer
@pytest.mark.parametrize("case", [c[0] for c in ranks.EP_LAYER])
def test_ep_layer_matches_jax(world, case):
    """``moe_mlp_ep`` at the default capacity (tokens dropped, the same
    ones as JAX's): every rank's rows of y at 1e-5, aux at 1e-6."""
    res, ref, _ = world
    y_ref, aux_ref = ref["ep/" + case]
    for r in res:
        got = r["ep/" + case]
        lo, hi = got["rows"]
        np.testing.assert_allclose(got["y"], y_ref[lo:hi], rtol=0,
                                   atol=1e-5)
        assert abs(got["aux"] - aux_ref) <= 1e-6
        assert got["wire"]["ep_dispatch"] > 0


def test_ep_dispatch_bytes_follow_capacity(world):
    """Each rank sends (model - 1) / model of its (E, cap, d) send buffer
    a way: a ragged 14-token case pads to 4 tokens a rank (capacity 8),
    the 4 x 16 case has 16 a rank (capacity 16)."""
    res, _, inp = world
    d = ranks.ep_cfg().d_model
    for r in res:
        assert r["ep/ragged"]["wire"]["ep_dispatch"] == 3 * 8 * d * 4
        assert r["ep/mesh_1x4"]["wire"]["ep_dispatch"] == 3 * 16 * d * 4
        assert r["ep/ragged"]["wire"]["ep_return"] == \
            r["ep/ragged"]["wire"]["ep_dispatch"]


# ---------------------------------------------------------------- vote
@pytest.mark.parametrize("mesh", ["(1, 4, 1)", "(1, 2, 2)"])
@pytest.mark.parametrize("mode", ["faithful", "digest"])
def test_make_trust_repairs_a_minority(world, mesh, mode):
    """Clean and minority-attacked give back y on every rank, bit for bit
    (the JAX package's own test holds its vote at 1e-6: its digest mode
    averages the agreeing copies); a majority coalition does not."""
    res, _, inp = world
    y = inp["y_vote"]
    for r in res:
        out = r[f"trust/{mesh}/{mode}"]
        np.testing.assert_array_equal(out["clean"], y)
        np.testing.assert_array_equal(out["minority"], y)
        assert not np.allclose(out["majority"], y)


@pytest.mark.parametrize("mode", ["faithful", "digest"])
def test_ep_vote_matches_jax(world, mode):
    """EP with the vote on (1, 2, 2): the minority-attacked layer equals
    the clean one (bitwise under both modes at r = 2), and both equal
    JAX's clean layer at 1e-5."""
    res, ref, _ = world
    for r in res:
        out = r["ep_trust/" + mode]
        np.testing.assert_array_equal(out["minority"], out["clean"])
        np.testing.assert_allclose(out["clean"], ref["ep_trust/" + mode],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", ["faithful", "digest"])
def test_ep_shared_expert_goes_through_the_vote(world, mode):
    """A majority coalition corrupts the shared experts' part of y too
    (isolated by differencing runs with and without the shared expert),
    so the shared rows flow through the vote."""
    res, _, _ = world
    for r in res:
        out = r["ep_trust/" + mode]
        corrupt = out["majority"] - out["no_shared_majority"]
        clean = out["clean"] - out["no_shared_clean"]
        assert not np.allclose(corrupt, clean, atol=1e-4)


# --------------------------------------------------- steps against JAX
@pytest.mark.parametrize("case", [c[0] for c in ranks.STEPS])
def test_train_step_matches_jax(world, case):
    """One ``make_train_step`` on the case's mesh from the same init:
    loss, aux and the gradient norm at 1e-5, every updated parameter at
    1e-5, on every rank; every rank's whole tree the same bits."""
    res, ref, _ = world
    want = ref["step/" + case]
    for r in res:
        got = r["step/" + case]["metrics"]
        for k in ("loss", "aux_loss", "grad_norm"):
            assert abs(got[k] - want["metrics"][k]) <= 1e-5, (k, got, want)
    assert len({r["step/" + case]["digest"] for r in res}) == 1
    got = res[0]["step/" + case]["params"]
    flat_g = jax.tree_util.tree_leaves(got)
    flat_w = jax.tree_util.tree_leaves(want["params"])
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", [c[0] for c in ranks.STEPS])
def test_prefill_step_matches_jax(world, case):
    """``make_prefill_step`` on the case's mesh: the global batch's next
    tokens equal JAX's on every rank."""
    res, ref, _ = world
    for r in res:
        np.testing.assert_array_equal(r["step/" + case]["next"],
                                      ref["step/" + case]["next"])


@pytest.mark.parametrize("kind", ["prefill", "train", "decode"])
def test_abstract_mesh_counts_equal_the_world(world, kind):
    """The dry run of one qwen2-moe EP step on the abstract (2, 2) mesh,
    as each rank of the world: its ``wire_bytes`` by exchange, its
    collective bytes and counts by op and its dot FLOPs equal what that
    rank of the gloo world sent and counted, exactly (decode: a batch of
    4 over a 64-position cache split over ``model``)."""
    res, _, _ = world
    cfg = ranks.step_cfg("qwen_ep")
    B, S = ranks.TOKENS
    shape = dict(kind=kind, seq=S, batch=B)
    if kind == "decode":
        shape = ranks.DECODE_SHAPE
    for r, got in enumerate(res):
        rec = dryrun.run_one(cfg.name, shape, cfg=cfg, mesh_shape=(2, 2),
                             rank=r, remat=False, verbose=False)
        real = got["counted_steps"][kind]
        assert real["wire"] and rec["wire_bytes"] == real["wire"], r
        assert real["count"]["wire_bytes"] == real["wire"]
        for key in ("collective_bytes", "collective_counts",
                    "total_collective_bytes", "dot_flops",
                    "dot_flops_by_route", "kernel_calls"):
            assert rec[key] == real["count"][key], (r, key)


# ------------------------------------------------------ decode on a mesh
@pytest.mark.parametrize("case", [c[0] for c in ranks.DECODE])
def test_decode_matches_jax(world, case):
    """``make_decode_step`` on the case's mesh, its caches placed by
    ``shard_caches``: every rank's next tokens (the global batch's) and
    expert counts equal JAX's decode on the same Auto mesh at every step,
    its rows' logits within 1e-5 of JAX's, the gathered caches within
    1e-5 of each leaf's largest magnitude (at least 1: mamba2's states
    reach 7 from the random caches) of JAX's and the same bits on every
    rank; the port's one-device decode gives the same tokens and counts
    and is within 1e-5."""
    res, ref, _ = world
    want = ref["decode/" + case]
    for r in res:
        got = r["decode/" + case]
        for g, w, one_next, one_stats in zip(
                got["steps"], want["steps"], got["one_device"]["next"],
                got["one_device"]["stats"]):
            np.testing.assert_array_equal(g["next"], w["next"])
            np.testing.assert_array_equal(g["next"], one_next)
            np.testing.assert_allclose(g["logits"],
                                       w["logits"][slice(*g["rows"])],
                                       rtol=0, atol=1e-5)
            if w["stats"] is not None:
                np.testing.assert_array_equal(g["stats"], w["stats"])
                np.testing.assert_array_equal(g["stats"], one_stats)
        assert got["one_device"]["logits_diff"] <= 1e-5
        assert got["one_device"]["caches_diff"] <= 1e-5
    assert len({r["decode/" + case]["digest"] for r in res}) == 1
    flat_g = jax.tree_util.tree_leaves(res[0]["decode/" + case]["caches"])
    flat_w = jax.tree_util.tree_leaves(want["caches"])
    assert len(flat_g) == len(flat_w)
    for g, w in zip(flat_g, flat_w):
        w = w.astype(np.float32)
        np.testing.assert_allclose(g.astype(np.float32), w, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(w).max()))


def test_decode_split_cache_exchanges(world):
    """A split cache's attention layers merge their parts by one
    all-gather each (``cache_combine``); a cache whose group has width
    one (mamba2's states) exchanges nothing for attention; EP decode
    dispatches by all-to-all."""
    res, _, _ = world
    for r in res:
        assert r["decode/qwen25_2x2"]["wire"]["cache_combine"] > 0
        assert r["decode/qwen25_1x4"]["wire"]["cache_combine"] > 0
        assert "cache_combine" not in r["decode/mamba2_2x2"]["wire"]
        assert r["decode/qwen_moe_2x2"]["wire"]["ep_dispatch"] > 0


def test_decode_bitwise_where_the_cache_group_has_width_one(world):
    """On (4, 1) and (1, 4, 1) (a cache group of one) each rank's logits,
    next tokens and caches equal the one-device decode of its rows bit
    for bit, for the six configs of ``DECODE`` at batch 4."""
    res, _, _ = world
    for r in res:
        assert r["decode_width1"] and all(r["decode_width1"].values()), \
            r["decode_width1"]


def test_serve_chunk_matches_jax(world):
    """qwen2-moe-a2.7b's serve chunk on (2, 2) (prefilling, decoding and
    idle slots, one crossing model rank 1's first position): tokens and
    counts equal JAX's, the gathered caches within 1e-5, the same bits
    on every rank."""
    res, ref, _ = world
    want = ref["serve_chunk"]
    for r in res:
        np.testing.assert_array_equal(r["serve_chunk"]["tokens"],
                                      want["tokens"])
        np.testing.assert_array_equal(r["serve_chunk"]["stats"],
                                      want["stats"])
    assert len({r["serve_chunk"]["digest"] for r in res}) == 1
    for g, w in zip(jax.tree_util.tree_leaves(res[0]["serve_chunk"][
            "caches"]), jax.tree_util.tree_leaves(want["caches"])):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_engine_on_a_mesh(world):
    """``ServingEngine(mesh=)`` on (2, 2) with verified sessions, edge
    expert storage and KV paging (slot 1 paged out and resumed): the
    completed streams, tick roots, sealed KV block CIDs and the edge
    and KV reports equal JAX's engine on the same Auto mesh and the
    port's one-device engine, and every rank's run is the same, the KV
    manifests' roots included (those hash the cache's bytes, which the
    split cache's combine rounds otherwise than one device: they are
    not held to it)."""
    res, ref, _ = world
    want = ref["engine"]
    for r in res:
        got, one = r["engine"]["mesh"], r["engine"]["one_device"]
        for k in ("done", "ticks", "cids", "edge", "kv"):
            assert got[k] == one[k], k
            assert got[k] == want[k], k
        assert got == res[0]["engine"]["mesh"]
    assert res[0]["engine"]["mesh"]["kv"]["pageouts"] == 1


def test_cache_round_trip_in_the_world(world):
    """``shard_caches`` then ``gather_caches`` gives every config's
    cache back bit for bit on (2, 2) and (1, 4), and ``place_cache``
    declares the rank's shapes."""
    res, _, _ = world
    for r in res:
        assert len(r["cache_round_trip"]) == 2 * len(JARCH_IDS)
        assert all(r["cache_round_trip"].values()), r["cache_round_trip"]


# the decode shapes' meshes: (name, mesh shape, axis names, batch)
CACHE_MESHES = (("2x2", (2, 2), ("data", "model"), 4),
                ("1x4", (1, 4), ("data", "model"), 1),
                ("16x16", (16, 16), ("data", "model"), 128),
                ("16x16_b1", (16, 16), ("data", "model"), 1),
                ("2x16x16", (2, 16, 16), ("pod", "data", "model"), 128),
                ("2x2x2", (2, 2, 2), ("data", "replica", "model"), 4))


@pytest.mark.parametrize("arch", sorted(JARCH_IDS))
def test_cache_placement_matches_jax_specs(arch):
    """For every config's cache declaration and six meshes (no devices:
    abstract meshes), ``cache_specs`` equals JAX's ``partition_specs``
    under its ``logical_rules`` leaf by leaf on every dimension (the
    batch, the positions, the ssm state's heads and the RG-LRU's
    channels), and ``place_cache``'s shapes are the shard shapes JAX's
    specs give."""
    from repro.models import encdec as jencdec
    from repro.models import transformer as jtfm
    from repro.models.builder import partition_specs as jspecs
    for name, shape, names, B in CACHE_MESHES:
        L = 4096
        knobs = dict(batch_shardable=B > 1, cache_seq_axes=(
            ("model",) if B > 1 else ("data", "model")))
        jcfg = dataclasses.replace(jget_config(arch), **knobs)
        cfg = dataclasses.replace(get_config(arch), **knobs)
        jm = types.SimpleNamespace(axis_names=names,
                                   devices=np.empty(shape))
        jdecl = (jencdec.encdec_cache_decl(jcfg, B, L, ranks.ENCDEC_MEMORY)
                 if jcfg.is_encoder_decoder else jtfm.cache_decl(jcfg, B, L))
        decl = ranks.cache_decl(cfg, B, L)
        want = jax.tree_util.tree_leaves(
            jspecs(jdecl, jsharding.logical_rules(jm, jcfg)),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        axes = [l.axes for l in jax.tree_util.tree_leaves(
            jdecl, is_leaf=lambda x: hasattr(x, "axes"))]
        mesh = lmesh.abstract_lm_mesh(shape, names)
        got = jax.tree_util.tree_leaves(
            sharding.cache_specs(decl, cfg, mesh),
            is_leaf=lambda x: isinstance(x, tuple))
        placed = jax.tree_util.tree_leaves(
            sharding.place_cache(decl, cfg, mesh),
            is_leaf=lambda x: hasattr(x, "axes"))
        whole = jax.tree_util.tree_leaves(
            decl, is_leaf=lambda x: hasattr(x, "axes"))
        widths = dict(zip(names, shape))
        assert len(got) == len(want) == len(axes) == len(placed)
        for g, w, ax, pl, wh in zip(got, want, axes, placed, whole):
            w = tuple(w) + (None,) * (len(ax) - len(w))
            for a, gs, ws, n_pl, n in zip(ax, g, w, pl.shape, wh.shape):
                # a PartitionSpec writes a one-name tuple as the name
                names_ = (ws,) if isinstance(ws, str) else (ws or ())
                assert ((gs,) if isinstance(gs, str) else (gs or ())) \
                    == names_, (name, ax, g, w)
                assert n_pl == n // math.prod(widths[x] for x in names_)


def test_an_indivisible_cache_raises():
    """A capacity the group does not divide raises and names the
    numbers (nothing is padded)."""
    cfg = ranks.decode_cfg("qwen2.5-3b", 1)
    mesh = lmesh.abstract_lm_mesh((1, 4))
    with pytest.raises(ValueError, match="of 30 does not split over 4"):
        sharding.place_cache(ranks.cache_decl(cfg, 1, 30), cfg, mesh)
    cfg = ranks.decode_cfg("qwen2.5-3b", 4)
    with pytest.raises(ValueError, match="of 30 does not split over 4"):
        sharding.shard_caches(materialize_caches(cfg, 4, 30), cfg, mesh)
    with pytest.raises(ValueError, match="of 6 does not split over 4"):
        sharding.shard_caches(materialize_caches(cfg, 6, 32), cfg,
                              lmesh.abstract_lm_mesh((4, 1)))


def materialize_caches(cfg, B, L):
    from repro_torch.models.builder import materialize
    return materialize(ranks.cache_decl(cfg, B, L), 0, "cpu")


def test_make_step_decode_takes_a_mesh():
    """``make_step(cfg, "decode", mesh)`` builds the mesh's decode step
    (it raised before the port's decode took a mesh); on a one-rank mesh
    it is the one-device step bit for bit."""
    from repro_torch.train.step import make_decode_step, make_step
    cfg = ranks.decode_cfg("qwen2.5-3b", 2)
    params = init_model(cfg, 0, "cpu")
    caches = materialize_caches(cfg, 2, 16)
    batch = {"tokens": torch.tensor([[3], [5]]), "pos": 4}
    mesh = lmesh.make_lm_mesh((1, 1), device="cpu")
    a = make_step(cfg, "decode", mesh)(params, caches, batch)
    b = make_decode_step(cfg)(params, caches, batch)
    assert torch.equal(a[0], b[0])
    assert digest_tree(a[1]) == digest_tree(b[1])


# ------------------------------------------- against the one device
def test_mesh_data1_bitwise_loss_and_logits(world):
    """Capacity factor 8, data axis 1 (EP on (1, 4), the trusted EP and
    bmoe-paper's vote hook on (1, 2, 2)): the model axis runs the dense
    layers tensor-parallel (row-parallel sums over ``model`` add partial
    products in another order), so loss, aux and logits are held to the
    one-device run at 1e-5 of their largest magnitude."""
    res, _, _ = world
    for r in res:
        for name in ("ep_1x4", "trusted_1x2x2", "bmoe_1x2x2"):
            out = r["one_device/" + name]
            for key in ("loss", "aux"):
                got, want = out[key]
                assert abs(got - want) <= 1e-5 * max(abs(want), 1e-30), name
            assert out["logits_abs"] <= 1e-5 * out["logits_max"], name


def test_mesh_data1_gradients(world):
    """Capacity factor 8, data axis 1: the gradients within 1e-5 of each
    leaf's largest magnitude, bmoe-paper's on (1, 2, 2) and EP's on
    (1, 4) and (1, 2, 2) (tensor parallelism over model: row-parallel
    sums; EP's expert weights' gradients also sum their capacity rows,
    padded to another count on the mesh, in other blocks)."""
    res, _, _ = world
    for r in res:
        for name in ("bmoe_1x2x2", "ep_1x4", "trusted_1x2x2"):
            assert r["one_device/" + name]["grads_rel"] <= 1e-5, name


def test_mesh_data2_within_1e6(world):
    """Data axis 2 (EP on (2, 2), FSDP over data, tensor parallelism over
    model): the loss within 1e-6 relative (the batch mean is one
    all-reduce), the gradients and this rank's logits within 1e-5 of
    their largest magnitude (row-parallel sums over ``model``)."""
    res, _, _ = world
    for r in res:
        out = r["one_device/ep_2x2"]
        loss, want = out["loss"]
        assert abs(loss - want) <= 1e-6 * abs(want)
        assert out["grads_rel"] <= 1e-5
        assert out["logits_abs"] <= 1e-5 * out["logits_max"]


def test_minority_attacked_step_is_the_clean_step(world):
    """Under ``faithful``, a step with replica 1 adding noise (sigma 5)
    to its expert outputs gives the clean step's loss and parameters bit
    for bit on every rank (the vote repairs the forward, the backward is
    straight through)."""
    res, _, _ = world
    for r in res:
        assert r["one_device/trusted_1x2x2"]["attacked_step_bitwise"]


def test_replicated_leaves_equal_on_every_rank(world):
    """After a step every rank holds the same whole tree (its replicated
    leaves, and the expert rows gathered), bit for bit."""
    res, _, _ = world
    for case, _ in ranks.STEPS:
        assert len({r["step/" + case]["digest"] for r in res}) == 1


# ------------------------------------------------- one process here
def test_ep_bitwise_where_the_layouts_coincide(world):
    """A one-rank mesh is the identity: EP on it at a capacity that
    equals the one-device layer's (cap = S * k, B = 1) gives the layer's
    y and aux bit for bit."""
    cfg = ranks.ep_cfg(capacity_factor=4.0)
    inp = world[2]
    moe = lm_params_from_numpy(inp["moe"], device="cpu")
    x = torch.from_numpy(inp["x"]["mesh_1x4"][:1])
    mesh = lmesh.make_lm_mesh((1, 1), device="cpu")
    y, aux = moe_mlp_ep(moe, x, cfg, mesh)
    y1, aux1 = moe_lib.moe_mlp(moe, x, cfg)
    assert torch.equal(y, y1) and torch.equal(aux, aux1)
    assert mesh.wire_bytes == {}


def test_ep_refuses_an_indivisible_model_axis():
    cfg = ranks.ep_cfg()                      # 4 experts
    mesh = types.SimpleNamespace(model=types.SimpleNamespace(shards=3))
    with pytest.raises(ValueError, match="EP needs experts"):
        moe_mlp_ep({}, torch.zeros(1, 1, cfg.d_model), cfg, mesh)


def test_make_trust_needs_a_replica_axis():
    from repro_torch.core.trusted_moe import make_trust
    from repro_torch.models.config import RedundancyConfig
    mesh = lmesh.make_lm_mesh((1, 1), device="cpu")
    assert make_trust(None, RedundancyConfig(2, "faithful"), True) is None
    with pytest.raises(ValueError, match="replica"):
        make_trust(mesh, RedundancyConfig(2, "faithful"), True)


def test_lm_mesh_of_one_rank():
    """Without a process group the world is one rank: every view is one
    shard with no group; a wider mesh is refused."""
    m = lmesh.make_lm_mesh((1, 1, 1), device="cpu")
    assert m.axes == {"data": 1, "replica": 1, "model": 1}
    assert m.model.group is None and m.batch.shards == 1
    assert m.batch_rows(4) == (0, 4)
    x = torch.arange(6.0)
    assert torch.equal(m.batch.all_reduce(x.clone()), x)
    with pytest.raises(ValueError, match="needs 4 ranks"):
        lmesh.make_lm_mesh((2, 2), device="cpu")
    with pytest.raises(ValueError, match="subsequence"):
        lmesh.make_lm_mesh((1, 1), ("model", "data"), device="cpu")
    with pytest.raises(ValueError, match="256"):
        lmesh.make_production_mesh(device="cpu")


# -------------------------------------------------- rules and layouts
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "1x2x4": ((1, 2, 4), ("data", "replica", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.mark.parametrize("arch", sorted(JARCH_IDS))
def test_logical_rules_and_fsdp_match_jax(arch):
    """``logical_rules`` (activations and parameters) and ``use_fsdp``
    give the JAX package's answers for every config, full and smoke, on
    four mesh geometries (JAX's side takes a stand-in with the axis
    names and a ``devices`` array of the shape, all it reads)."""
    for smoke in (False, True):
        jcfg, cfg = jget_config(arch, smoke=smoke), get_config(arch,
                                                               smoke=smoke)
        for shape, names in MESHES.values():
            jm = types.SimpleNamespace(axis_names=names,
                                       devices=np.empty(shape))
            m = types.SimpleNamespace(axis_names=names, shape=shape)
            for params in (False, True):
                assert sharding.logical_rules(m, cfg, params) == \
                    jsharding.logical_rules(jm, jcfg, params), (shape,
                                                                params)
        for kind in ("train", "prefill", "decode"):
            for shards in (4, 16):
                assert sharding.use_fsdp(cfg, kind, shards) == \
                    jsharding.use_fsdp(jcfg, kind, shards), (kind, shards)
    assert sharding.logical_rules(None, cfg) == {}
    s = sharding.Sharder(m, sharding.logical_rules(m, cfg))
    assert s.spec("batch", None, "vocab") == \
        jsharding.Sharder(None, jsharding.logical_rules(jm, jcfg)).spec(
            "batch", None, "vocab")


def test_mesh_factory_widths_match_jax():
    """The factories' widths for 8 ranks are those
    tests/test_moe_ep_edges.py holds JAX's to for 8 devices."""
    assert lmesh.trusted_mesh_shape(8, 2) == ((1, 2, 4), ("data", "replica",
                                                          "model"))
    assert lmesh.trusted_mesh_shape(8, 4) == ((1, 4, 2), ("data", "replica",
                                                          "model"))
    with pytest.raises(ValueError):
        lmesh.trusted_mesh_shape(8, 3)
    assert lmesh.host_mesh_shape(8) == (1, 8)
    assert lmesh.host_mesh_shape(8, num_experts=6) == (4, 2)
    assert lmesh.trusted_mesh_shape(512, 2, multi_pod=True)[0] == \
        (2, 8, 2, 16)


def test_expert_placement_round_trip():
    """``shard_params`` and the cut of ``place_leaf`` as the leaves are
    drawn give the same rank tree (rank 1 of an abstract (1, 2) mesh):
    an EP layer's experts are the rank's contiguous rows, the vocabulary
    its half, and a leaf the placement splits nowhere stays the input's
    tensor."""
    cfg = ranks.ep_cfg()
    full = init_model(cfg, 3, "cpu")
    mesh = lmesh.abstract_lm_mesh((1, 2), rank=1)
    cut = sharding.shard_params(full, cfg, mesh)
    drawn = init_model(cfg, 3, "cpu", mesh=mesh)
    assert cut["blocks"]["0"]["moe"]["w_gate"].shape[1] == 2
    assert digest_tree(cut) == digest_tree(drawn)
    assert torch.equal(cut["blocks"]["0"]["moe"]["w_up"],
                       full["blocks"]["0"]["moe"]["w_up"][:, 2:4])
    assert torch.equal(cut["embed"], full["embed"][256:])
    assert cut["final_norm"] is full["final_norm"]


# ------------------------------------------------------------ launcher
def test_launcher_mesh_matches_one_device():
    """``python -m repro_torch.launch.train --mesh 1,2 --device cpu
    --arch qwen2-moe-a2.7b --steps 3`` trains on two ranks, and its
    losses equal the one-device launcher's at 1e-5.  At (2, 8) tokens
    neither run drops an assignment (EP's capacity is 8 a shard for 16
    assignments over 4 experts, the layer's 8 a row), so the two compute
    the same function."""
    argv = ["--arch", "qwen2-moe-a2.7b", "--steps", "3", "--batch", "2",
            "--seq", "8", "--device", "cpu"]
    one = launch_train.main(argv)
    on = launch_train.main(argv + ["--mesh", "1,2"])
    assert [h["step"] for h in on] == [0, 1, 2]
    for a, b in zip(on, one):
        assert abs(a["loss"] - b["loss"]) <= 1e-5
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-5 * b["grad_norm"]


def test_serve_launcher_mesh_matches_one_device():
    """``python -m repro_torch.launch.serve --mesh 2,2 --device cpu
    --arch qwen2-moe-a2.7b``: four ranks (EP over model, the slots over
    data, the cache's positions over model) complete the one-device
    launcher's requests with the same tokens."""
    argv = ["--arch", "qwen2-moe-a2.7b", "--requests", "5", "--slots", "4",
            "--cache-len", "64", "--max-prompt", "20", "--max-new", "6",
            "--device", "cpu"]
    one = launch_serve.main(argv)
    on = launch_serve.main(argv + ["--mesh", "2,2"])
    assert on == one and len(one) == 5

