"""FSDP placement and dense tensor parallelism in the port, on the CPU:
every decoder-only leaf placed as the JAX package's partition specs say
(``sharding.placed_specs``), the per-block FSDP gathers, the
vocabulary-parallel embedding, head and loss, column- and row-parallel
attention and MLP, and the gspmd MoE with its experts or their hidden
columns over ``model``, in training, prefill and decode.

One world of 4 ranks over gloo (``launch.mesh.spawn_edges``, one
intra-op thread a rank) runs every case of ``torch_lm_tp_ranks`` on
(2, 2), (1, 4) and (4, 1).  While it runs, one forced-8-device
subprocess runs the same cases in the JAX package on the (2, 2) Auto
mesh (the Explicit axes of jax 0.9 refuse ``with_sharding_constraint``),
from the same numpy inputs: JAX's mesh function is the same on every
mesh up to rounding, so each of the port's meshes is held to that one
run.  The bars: logits and loss within 1e-5 of their largest magnitude,
every gradient within 1e-5 of the leaf's largest magnitude and every
updated leaf within 1e-5 of the larger of 1 and that magnitude (AdamW's
first step moves a zero-initialised norm by +-lr, whatever the size of
its gradient), next tokens equal, against both JAX's mesh step and the
port's one device; bitwise where neither a row-parallel sum nor a
reordered reduction applies (``test_bitwise_*``)."""
import dataclasses
import pickle
import threading
import types

import jax
import numpy as np
import pytest
import torch

import torch_lm_tp_ranks as ranks
from conftest import run_with_devices
from repro import sharding as jsharding
from repro.configs import ARCH_IDS as JARCH_IDS
from repro.configs import get_config as jget_config
from repro.models import encdec as jencdec
from repro.models import transformer as jtfm
from repro.models.builder import partition_specs as jspecs
from repro_torch import sharding
from repro_torch.configs import get_config
from repro_torch.launch import mesh as lmesh

JAX_CASES = """
import os
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true"
                            " --xla_cpu_multi_thread_eigen=false")
import dataclasses, pickle
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import transformer as jtfm
from repro.models.config import RedundancyConfig
from repro.optim import adamw
from repro.sharding import Sharder, logical_rules, use_fsdp
from repro.train.step import model_forward

inp = pickle.load(open({inp!r}, "rb"))
tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
host = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {{}}
for name, arch, kw, shape in inp["cases"]:
    kw = dict(kw)
    if "redundancy" in kw:
        kw["redundancy"] = RedundancyConfig(mode=kw["redundancy"])
    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    m = jax.make_mesh(shape, ("data", "model"),
                      axis_types=(AxisType.Auto,) * 2)
    params = tree(inp["models"][name])
    batch = {{k: jnp.asarray(v) for k, v in inp["batch"][name].items()}}
    shard = Sharder(m, logical_rules(m, cfg), fsdp=True)

    def loss_fn(p):
        logits, aux, labels = model_forward(p, batch, cfg, shard, None,
                                            False, False)
        return jtfm.lm_loss(logits, labels) + aux, (aux, logits)

    with m:
        (loss, (aux, logits)), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    opt = adamw.AdamWConfig(**inp["opt"])
    new, _, met = adamw.update(opt, grads, adamw.init(params), params)
    dcfg = dataclasses.replace(cfg, cache_seq_axes=("model",),
                               batch_shardable=True)
    dshard = Sharder(m, logical_rules(m, dcfg),
                     fsdp=use_fsdp(dcfg, "decode", shape[-1]))
    fwd = jax.jit(lambda p, c, t, pos: jtfm.forward_decode(
        p, c, t, pos, dcfg, shard=dshard))
    caches, steps = tree(inp["caches"][name]), []
    with m:
        for b in inp["decode"][name]:
            lg, caches = fwd(params, caches, jnp.asarray(b["tokens"]),
                             jnp.asarray(b["pos"]))
            steps.append({{"logits": np.asarray(lg[:, -1]),
                          "next": np.asarray(lg[:, -1].argmax(-1))}})
    out[f"{{name}}/{{shape}}"] = {{
        "loss": float(loss), "aux": float(aux), "logits": np.asarray(logits),
        "next": np.asarray(logits[:, -1:].argmax(-1)),
        "grads": host(grads), "updated": host(new),
        "grad_norm": float(met["grad_norm"]), "decode": steps}}
pickle.dump(out, open({out!r}, "wb"))
print("JAX CASES OK")
"""


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_kw(kw):
    """A case's config changes with the redundancy as its mode's name
    (the JAX package has its own ``RedundancyConfig``)."""
    return {k: (v.mode if k == "redundancy" else v) for k, v in kw.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory, repo_src):
    """(the 4 ranks' results, the JAX package's, the inputs)."""
    d = tmp_path_factory.mktemp("lm_tp")
    inp = ranks.make_inputs()
    inp["cases"] = [(n, a, _jax_kw(kw), JAX_MESH)
                    for n, a, kw in ranks.CASES]
    inp["opt"] = ranks.OPT
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
        lmesh.spawn_edges(ranks.tp_rank, ranks.WORLD,
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


KEYS = [f"{n}/{s}" for n, _, _ in ranks.CASES for s in ranks.MESHES]
JAX_MESH = (2, 2)


def _close(got, want, what, floor=1e-30):
    """``got`` within 1e-5 of the larger of ``want``'s largest magnitude
    and ``floor``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bar = 1e-5 * max(np.abs(want).max(), floor)
    assert np.abs(got - want).max() <= bar, (what, np.abs(got - want).max(),
                                             bar)


def _trees_close(got, want, what, floor=1e-30):
    g, w = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a, b, (what, i), floor)


@pytest.mark.parametrize("key", KEYS)
def test_train_step_matches_jax_and_one_device(world, key):
    """Loss and aux within 1e-5 relative, this rank's rows of the logits
    within 1e-5 of the largest magnitude, every gradient within 1e-5 of
    the leaf's largest magnitude and every updated leaf within 1e-5 of
    the larger of 1 and it, against JAX's mesh step and the port's one
    device; every rank's updated tree the same bits."""
    res, ref, _ = world
    name = key.split("/")[0]
    one = res[0]["one_device"][name]
    want = ref[f"{name}/{JAX_MESH}"]
    for r in res:
        got = r[key]
        lo, hi = got["rows"]
        for w in (want, one):
            _close(got["loss"], w["loss"], "loss")
            _close(got["aux"], w["aux"], "aux")
            _close(got["logits"], w["logits"][lo:hi], "logits")
        _close(got["metrics"]["grad_norm"], want["grad_norm"], "grad_norm")
    assert len({r[key]["updated_digest"] for r in res}) == 1
    got = res[0][key]
    for w in (want, one):
        _trees_close(got["grads"], w["grads"], "grads")
        _trees_close(got["updated"], w["updated"], "updated", floor=1.0)


@pytest.mark.parametrize("key", KEYS)
def test_prefill_and_decode_match_jax_and_one_device(world, key):
    """The prefill's next tokens equal JAX's and one device's on every
    rank; at each of the decode steps (the cache's positions over
    ``model``) the next tokens equal and this rank's logits are within
    1e-5 of their largest magnitude."""
    res, ref, _ = world
    name = key.split("/")[0]
    one = res[0]["one_device"][name]
    want = ref[f"{name}/{JAX_MESH}"]
    for r in res:
        got = r[key]
        np.testing.assert_array_equal(got["next"], want["next"])
        np.testing.assert_array_equal(got["next"], one["next"])
        lo, hi = got["rows"]
        for g, w, o in zip(got["decode"], want["decode"], one["decode"]):
            np.testing.assert_array_equal(g["next"], w["next"])
            np.testing.assert_array_equal(g["next"], o["next"])
            _close(g["logits"], w["logits"][lo:hi], "decode logits")
            _close(g["logits"], o["logits"][lo:hi], "decode logits")


def test_the_placement_exchanges(world):
    """FSDP gathers and reduce-scatters where the batch axis is wider than
    one, the vocabulary and the row-parallel sums over ``model`` where it
    is; qwen2.5-3b's half kv heads gather k and v on (1, 4); the EP
    layer dispatches by all-to-all; (4, 1) exchanges nothing over
    ``model``."""
    res, _, _ = world
    for r in res:
        w = r["qwen25/(2, 2)"]["wire"]
        for kind in ("fsdp_gather", "fsdp_gather_bwd", "vocab_embed",
                     "attn_sum", "mlp_sum", "vocab_sums"):
            assert w.get(kind, 0) > 0, kind
        assert r["qwen25/(1, 4)"]["wire"]["attn_gather"] > 0
        assert "attn_gather" not in r["qwen3/(2, 2)"]["wire"]
        assert r["bmoe/(2, 2)"]["wire"]["moe_experts_gather"] > 0
        assert r["bmoe/(1, 4)"]["wire"]["moe_sum"] > 0
        assert r["qwen_moe_ep/(2, 2)"]["wire"]["ep_dispatch"] > 0
        w = r["qwen25/(4, 1)"]["wire"]
        assert not any(k.startswith(("attn", "mlp", "vocab")) for k in w)


def test_bitwise_fsdp_alone(world):
    """(data 2, replica 2, model 1): the FSDP step (leaves split over
    data, gathered per block, gradients reduce-scattered) gives the
    replicated step's loss, gradients and AdamW update bit for bit (two
    ranks' sums commute; clipping off, so its scale is exactly 1)."""
    res, _, _ = world
    for r in res:
        out = r["bitwise"]["fsdp_alone"]
        assert out["loss"] and out["grads"] and out["update"], out


def test_bitwise_vocab_embedding_and_experts_over_model(world):
    """The vocabulary-parallel embedding on (1, 4) equals the one-device
    lookup; a gspmd MoE layer with its 4 experts over model = 4 gives
    the one-device layer's output and x's gradient bit for bit, and the
    router's gradient columns of the rank."""
    res, _, _ = world
    for r in res:
        out = r["bitwise"]
        assert out["embedding"]
        assert all(out["moe_experts_over_model"].values()), out


def test_bitwise_drawn_slice_and_checkpoints(world):
    """For all eleven configs and both placements a rank's tree drawn by
    ``init_model(mesh=)`` is the slice of the whole tree bit for bit; a
    checkpoint saved from a placed tree is the one-device checkpoint's
    bytes, and restoring it cuts the rank's part."""
    res, _, _ = world
    for r in res:
        assert len(r["bitwise"]["drawn_slice"]) == len(JARCH_IDS)
        assert all(r["bitwise"]["drawn_slice"].values())
        assert all(r["bitwise"]["checkpoint"].values())


def test_bitwise_attacked_is_clean_under_fsdp(world):
    """bmoe-paper's trusted step on (data 2, replica 2, model 1), FSDP
    over data: a minority replica's noise leaves the loss and the
    updated tree bit for bit the clean step's."""
    res, _, _ = world
    assert all(r["bitwise"]["attacked_is_clean"] for r in res)


def test_vocab_parallel_loss(world):
    """The vocabulary-parallel cross-entropy on (1, 4) against
    ``lm_loss`` on the whole logits (an ignored label included): the
    loss within 1e-6 relative, this rank's gradient columns within 1e-7,
    and ``vocab_argmax`` equal to ``argmax``."""
    res, _, _ = world
    for r in res:
        out = r["bitwise"]["vocab_loss"]
        a, b = out["loss"]
        assert abs(a - b) <= 1e-6 * abs(b)
        assert out["grad"] <= 1e-7
        assert out["argmax"]


# ------------------------------------------------- placement, no world
SPEC_MESHES = (((16, 16), ("data", "model")),
               ((2, 16, 16), ("pod", "data", "model")),
               ((2, 2), ("data", "model")), ((1, 4), ("data", "model")))


@pytest.mark.parametrize("arch", sorted(JARCH_IDS))
def test_placed_specs_match_jax(arch):
    """For every config (full width), four meshes and the three step
    kinds, ``placed_specs`` equals JAX's ``partition_specs`` under its
    ``logical_rules(params=use_fsdp(...))`` leaf by leaf on every
    dimension, and ``unplaced_leaves`` is empty: the recurrent mixers'
    ``ssm_inner``, ``ssm_heads`` and ``rglru_inner`` dimensions and the
    encoder-decoder's leaves are placed like every other."""
    jcfg, cfg = jget_config(arch), get_config(arch)
    jdecl = (jencdec.encdec_decl(jcfg) if jcfg.is_encoder_decoder
             else jtfm.model_decl(jcfg))
    for shape, names in SPEC_MESHES:
        jm = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
        mesh = lmesh.abstract_lm_mesh(shape, names)
        for kind in ("train", "prefill", "decode"):
            rules = jsharding.logical_rules(
                jm, jcfg, params=jsharding.use_fsdp(jcfg, kind, shape[-1]))
            want = jspecs(jdecl, rules)
            assert sharding.unplaced_leaves(cfg, mesh, kind) == [], (shape,
                                                                     kind)
            got = sharding.placed_specs(cfg, mesh, kind)
            leaves = _paths(jdecl)
            got = jax.tree_util.tree_leaves(
                got, is_leaf=lambda x: isinstance(x, tuple))
            want = jax.tree_util.tree_leaves(
                want, is_leaf=lambda x: isinstance(
                    x, jax.sharding.PartitionSpec))
            assert len(got) == len(want) == len(leaves)
            for (path, leaf), g, w in zip(leaves, got, want):
                w = tuple(w) + (None,) * (len(leaf.axes) - len(w))
                for a, gs, ws in zip(leaf.axes, g, w):
                    # a PartitionSpec writes a one-name tuple as the name
                    assert _names(gs) == _names(ws), (shape, kind, path, a,
                                                      gs, ws)


def _names(s):
    return () if s is None else ((s,) if isinstance(s, str) else tuple(s))


def _paths(tree, prefix=""):
    """(path, Leaf) of a JAX declaration in ``tree_leaves``' order."""
    if hasattr(tree, "axes"):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}/{k}")]
    return [p for i, v in enumerate(tree) for p in _paths(v,
                                                          f"{prefix}/{i}")]


def test_an_indivisible_leaf_raises():
    """A dimension its group does not divide raises and names the numbers
    (nothing is padded)."""
    cfg = dataclasses.replace(get_config("qwen2.5-3b", smoke=True),
                              d_ff=510)
    from repro_torch.train.loop import init_model
    with pytest.raises(ValueError, match="of 510 does not split over 4"):
        init_model(cfg, 0, "cpu", mesh=lmesh.abstract_lm_mesh((1, 4)))
