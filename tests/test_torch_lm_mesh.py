"""The LM stack on a mesh in the port, on the CPU: expert parallelism
(``models.moe_ep``), ``route_masked``, the LM-scale B-MoE vote
(``core.trusted_moe``), the mesh layouts and rules (``launch.mesh``,
``sharding``), and training and prefill under a mesh.

One world of 4 ranks over gloo (``launch.mesh.spawn_edges``, one
intra-op thread a rank, collectives with a time limit) runs every case of
``torch_lm_mesh_ranks`` once.  While it runs, one forced-8-device
subprocess runs the same cases in the JAX package on meshes built here
with ``AxisType.Auto`` axes (the reference's own ``jax.make_mesh`` gives
Explicit axes, which its ``with_sharding_constraint`` refuses on jax
0.9); both sides take the same numpy inputs.  The port is held to JAX at
1e-5 (y, steps) and 1e-6 (aux), and to its own one-device run: bitwise
where the expert buffers' layouts coincide, within 1e-6 elsewhere.  The
dry run's abstract mesh is held to the world's counts of one EP prefill
and training step, rank by rank."""
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
    inp.update(ep_layer=ranks.EP_LAYER, steps=ranks.STEPS)
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


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_abstract_mesh_counts_equal_the_world(world, kind):
    """The dry run of one qwen2-moe EP step on the abstract (2, 2) mesh,
    as each rank of the world: its ``wire_bytes`` by exchange, its
    collective bytes and counts by op and its dot FLOPs equal what that
    rank of the gloo world sent and counted, exactly."""
    res, _, _ = world
    cfg = ranks.step_cfg("qwen_ep")
    B, S = ranks.TOKENS
    for r, got in enumerate(res):
        rec = dryrun.run_one(cfg.name, dict(kind=kind, seq=S, batch=B),
                             cfg=cfg, mesh_shape=(2, 2), rank=r,
                             remat=False, verbose=False)
        real = got["counted_steps"][kind]
        assert real["wire"] and rec["wire_bytes"] == real["wire"], r
        assert real["count"]["wire_bytes"] == real["wire"]
        for key in ("collective_bytes", "collective_counts",
                    "total_collective_bytes", "dot_flops",
                    "dot_flops_by_route", "kernel_calls"):
            assert rec[key] == real["count"][key], (r, key)


# ------------------------------------------- against the one device
def test_mesh_data1_bitwise_loss_and_logits(world):
    """Capacity factor 8, data axis 1: loss, aux and logits of the mesh
    equal the one-device run's bit for bit (EP on (1, 4), the trusted EP
    and bmoe-paper's vote hook on (1, 2, 2))."""
    res, _, _ = world
    for r in res:
        for name in ("ep_1x4", "trusted_1x2x2", "bmoe_1x2x2"):
            out = r["one_device/" + name]
            assert out["loss"][0] == out["loss"][1], name
            assert out["aux"][0] == out["aux"][1], name
            assert out["logits_bitwise"], name


def test_mesh_data1_gradients(world):
    """Capacity factor 8, data axis 1: bmoe-paper's gradients equal the
    one-device run's bit for bit; EP's within 1e-6 of each leaf's
    largest magnitude (the expert weights' gradients sum their
    capacity rows, padded to another count on the mesh, in other
    blocks), and bitwise every other leaf (``test_mesh_ep_bitwise_*``)."""
    res, _, _ = world
    for r in res:
        assert r["one_device/bmoe_1x2x2"]["grads_bitwise"]
        for name in ("ep_1x4", "trusted_1x2x2"):
            assert r["one_device/" + name]["grads_rel"] <= 1e-6, name


def test_mesh_data2_within_1e6(world):
    """Data axis 2 (EP on (2, 2)): the loss within 1e-6 relative (the
    batch mean is one all-reduce), the gradients within 1e-6 of each
    leaf's largest magnitude, this rank's logits bitwise."""
    res, _, _ = world
    for r in res:
        out = r["one_device/ep_2x2"]
        loss, want = out["loss"]
        assert abs(loss - want) <= 1e-6 * abs(want)
        assert out["grads_rel"] <= 1e-6
        assert out["logits_bitwise"]


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
    drawn give the same rank tree; the non-expert leaves stay whole."""
    cfg = ranks.ep_cfg()
    full = init_model(cfg, 3, "cpu")
    mesh = types.SimpleNamespace(model=types.SimpleNamespace(shards=2,
                                                             shard=1))
    cut = sharding.shard_params(full, cfg, mesh)
    drawn = init_model(cfg, 3, "cpu", mesh=mesh)
    assert cut["blocks"]["0"]["moe"]["w_gate"].shape[1] == 2
    assert digest_tree(cut) == digest_tree(drawn)
    assert torch.equal(cut["blocks"]["0"]["moe"]["w_up"],
                       full["blocks"]["0"]["moe"]["w_up"][:, 2:4])
    assert cut["embed"] is full["embed"]


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
