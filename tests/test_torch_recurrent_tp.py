"""The recurrent mixers' tensor parallelism and the encoder-decoder's
placement in the port, on the CPU: mamba2's SSD layer on a rank's
``ssm_inner`` channels and ``ssm_heads`` (and, where the heads do not
divide ``model``, on every head with the rank's channels kept),
recurrentgemma's RG-LRU on a rank's ``rglru_inner`` channels, and
seamless-m4t-medium placed as JAX's specs say (FSDP, tensor- and
vocabulary-parallel), in training, prefill and decode, with the decode
caches placed as JAX's cache specs say.

One world of 4 ranks over gloo (``launch.mesh.spawn_edges``, one
intra-op thread a rank) runs every case of ``torch_recurrent_tp_ranks``
on (2, 2), (1, 4) and (4, 1).  While it runs, one forced-8-device
subprocess runs the same cases in the JAX package on the (2, 2) Auto
mesh (the Explicit axes of jax 0.9 refuse ``with_sharding_constraint``),
from the same numpy inputs: JAX's mesh function is the same on every
mesh up to rounding, so each of the port's meshes is held to that one
run.  The bars: logits and loss within 1e-5 of their largest magnitude,
every gradient within 1e-5 of the leaf's largest magnitude and every
updated leaf within 1e-5 of the larger of 1 and that magnitude (AdamW's
first step moves a zero-initialised norm by +-lr, whatever the size of
its gradient), the decode caches within 1e-5 of the larger of 1 and the
leaf's largest magnitude, next tokens equal, against both JAX's mesh
step and the port's one device; bitwise where neither a row-parallel sum
nor a reordered reduction applies (``test_bitwise_*``)."""
import pickle
import threading

import jax
import numpy as np
import pytest
import torch

import torch_recurrent_tp_ranks as ranks
from conftest import run_with_devices
from repro_torch import sharding
from repro_torch.launch import mesh as lmesh
from repro_torch.models import transformer as tfm

JAX_CASES = """
import os
os.environ["XLA_FLAGS"] += (" --xla_backend_optimization_level=0"
                            " --xla_llvm_disable_expensive_passes=true"
                            " --xla_cpu_multi_thread_eigen=false")
import dataclasses, pickle
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config
from repro.models import encdec as jencdec
from repro.models import transformer as jtfm
from repro.optim import adamw
from repro.sharding import Sharder, logical_rules, use_fsdp
from repro.train.step import model_forward

inp = pickle.load(open({inp!r}, "rb"))
tree = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
host = lambda t: jax.tree_util.tree_map(np.asarray, t)
out = {{}}
for name, arch, kw, shape in inp["cases"]:
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
    lib = jencdec if cfg.is_encoder_decoder else jtfm
    fwd = jax.jit(lambda p, c, t, pos: lib.forward_decode(
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
        "grad_norm": float(met["grad_norm"]), "decode": steps,
        "caches": host(caches)}}
pickle.dump(out, open({out!r}, "wb"))
print("JAX CASES OK")
"""
JAX_MESH = (2, 2)
KEYS = [f"{n}/{s}" for n, _, _ in ranks.CASES for s in ranks.MESHES]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory, repo_src):
    """(the 4 ranks' results, the JAX package's, the inputs)."""
    d = tmp_path_factory.mktemp("recurrent_tp")
    inp = ranks.make_inputs()
    inp["cases"] = [(n, a, kw, JAX_MESH) for n, a, kw in ranks.CASES]
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
    rank; at each of the decode steps (the caches placed as JAX's cache
    specs say: the positions over ``model``, the ssm state's heads and
    the RG-LRU's channels too) the next tokens equal and this rank's
    logits are within 1e-5 of their largest magnitude; the caches
    gathered back after the last step are within 1e-5 of the larger of 1
    and each leaf's largest magnitude."""
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
    for w in (want, one):
        _trees_close(res[0][key]["caches"], w["caches"], "caches", floor=1.0)


@pytest.mark.parametrize("name", ["mamba2", "mamba2_odd"])
def test_ssm_conv_history_is_replicated(world, name):
    """The ssm layer's conv history, whole on every rank as JAX's cache
    spec leaves it, holds the same bits on every rank of a model group
    after the decode steps."""
    res, _, _ = world
    for r in res:
        for shape in ranks.MESHES:
            same = r[f"{name}/{shape}"]["conv_replicated"]
            assert same and all(same), (shape, same)


def test_the_mixers_exchanges(world):
    """Over ``model`` the SSD layer sums its row-parallel output, its
    gated norm's statistic (and that statistic's cotangent) and B and C's
    weights' gradients; where the heads do not divide (mamba2_odd on
    (1, 4)) it gathers the convolved input and slices the output
    instead; decode gathers the new token's conv input.  The RG-LRU
    reduce-scatters its gates (their backward all-gathers) and sums its
    output; the encoder-decoder sums its attention and MLP outputs and
    its vocabulary.  (4, 1) exchanges nothing over ``model``."""
    res, _, _ = world
    for r in res:
        w = r["mamba2/(1, 4)"]["wire"]
        for kind in ("ssm_in", "ssm_sum", "ssm_norm", "ssm_norm_bwd",
                     "ssm_state_w", "ssm_conv_gather", "vocab_sums"):
            assert w.get(kind, 0) > 0, kind
        assert "ssm_gather" not in w and "ssm_slice_bwd" not in w
        w = r["mamba2_odd/(1, 4)"]["wire"]
        for kind in ("ssm_gather", "ssm_slice_bwd", "ssm_sum"):
            assert w.get(kind, 0) > 0, kind
        assert "ssm_state_w" not in w
        assert "ssm_gather" not in r["mamba2_odd/(2, 2)"]["wire"]
        w = r["rgemma/(2, 2)"]["wire"]
        for kind in ("rglru_in", "rglru_gates", "rglru_gates_bwd",
                     "rglru_sum", "fsdp_gather", "fsdp_gather_bwd"):
            assert w.get(kind, 0) > 0, kind
        w = r["seamless/(2, 2)"]["wire"]
        for kind in ("attn_sum", "mlp_sum", "xattn_in", "xattn_memory",
                     "vocab_embed", "vocab_sums", "fsdp_gather",
                     "fsdp_gather_bwd"):
            assert w.get(kind, 0) > 0, kind
        for name in ("mamba2", "rgemma", "seamless"):
            w = r[f"{name}/(4, 1)"]["wire"]
            assert not any(k.startswith(("ssm", "rglru", "attn", "mlp",
                                         "xattn", "vocab")) for k in w)


def test_bitwise_fsdp_alone(world):
    """(data 2, replica 2, model 1): the FSDP step of every case (leaves
    split over data, gathered per block, gradients reduce-scattered)
    gives the replicated step's loss, gradients and AdamW update bit for
    bit (two ranks' sums commute; clipping off)."""
    res, _, _ = world
    for r in res:
        assert r["bitwise"]["fsdp_alone"] == {n: True for n, _, _ in
                                              ranks.CASES}


def test_bitwise_drawn_slice_and_checkpoints(world):
    """Every case's rank tree drawn by ``init_model(mesh=)`` is the slice
    of the whole tree bit for bit on (2, 2) and (1, 4), for both
    placements; a checkpoint saved from a placed tree is the one-device
    checkpoint's bytes, and restoring it cuts the rank's part."""
    res, _, _ = world
    for r in res:
        assert len(r["bitwise"]["drawn_slice"]) == 2 * len(ranks.CASES)
        assert all(r["bitwise"]["drawn_slice"].values())
        assert r["bitwise"]["checkpoint"] == {n: (True, True) for n, _, _
                                              in ranks.CASES}


def test_cross_kv_from_a_placed_tree(world):
    """``encdec.cross_kv`` of ``encode``'s memory over a placed tree on
    (1, 4) gives every rank the whole cross K/V within 1e-5 of the
    one-device cache's largest magnitude."""
    res, _, _ = world
    for r in res:
        for err, top in r["bitwise"]["cross_kv"]:
            assert err <= 1e-5 * top, (err, top)


# ------------------------------------------------- placement, no world
@pytest.mark.parametrize("arch,shape,part", [
    ("mamba2-2.7b", (1, 4), 80 // 4), ("mamba2-2.7b", (16, 16), 80 // 16),
    ("recurrentgemma-2b", (1, 4), 2560 // 4),
    ("recurrentgemma-2b", (16, 16), 2560 // 16)])
def test_place_cache_splits_the_mixers(arch, shape, part):
    """At full width ``place_cache`` declares the rank's part of a
    recurrent mixer's cache as JAX's cache specs say: the ssm state's
    heads (its conv history whole), the RG-LRU's hidden state and conv
    history by channels; each rank keeps 2 batch rows."""
    import dataclasses
    from repro_torch.configs import get_config
    cfg = dataclasses.replace(get_config(arch), cache_seq_axes=("model",))
    mesh = lmesh.abstract_lm_mesh(shape)
    blk = sharding.place_cache(tfm.cache_decl(cfg, 2 * shape[0], 4096), cfg,
                               mesh)["blocks"]["0"]
    nb, W = cfg.resolved_num_blocks, cfg.ssm_conv_width
    if arch.startswith("mamba2"):
        assert blk["state"].shape == (nb, 2, part, cfg.ssm_head_dim,
                                      cfg.ssm_state)
        assert blk["conv"].shape == (nb, 2, W - 1,
                                     cfg.ssm_inner + 2 * cfg.ssm_state)
    else:
        assert blk["h"].shape == (nb, 2, part)
        assert blk["conv"].shape == (nb, 2, W - 1, part)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b",
                                  "seamless-m4t-medium"])
def test_train_launcher_mesh_matches_one_device(arch):
    """``python -m repro_torch.launch.train --mesh 2,2 --device cpu``:
    four ranks (FSDP over data; the mixers, attention, MLP and vocabulary
    over model) train the one-device launcher's 3 steps, loss and
    gradient norm within 1e-5."""
    from repro_torch.launch import train as launch_train
    argv = ["--arch", arch, "--steps", "3", "--batch", "2", "--seq", "16",
            "--device", "cpu"]
    one = launch_train.main(argv)
    on = launch_train.main(argv + ["--mesh", "2,2"])
    assert [h["step"] for h in on] == [0, 1, 2]
    for a, b in zip(on, one):
        assert abs(a["loss"] - b["loss"]) <= 1e-5 * abs(b["loss"])
        assert abs(a["grad_norm"] - b["grad_norm"]) <= 1e-5 * b["grad_norm"]


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-2b"])
def test_serve_launcher_mesh_matches_one_device(arch):
    """``python -m repro_torch.launch.serve --mesh 1,4 --device cpu``:
    four ranks (the ssm state's heads or the RG-LRU's channels, the
    attention ring's positions, the vocabulary over model) complete the
    one-device launcher's requests with the same tokens."""
    from repro_torch.launch import serve as launch_serve
    argv = ["--arch", arch, "--requests", "4", "--slots", "2",
            "--cache-len", "64", "--max-prompt", "20", "--max-new", "6",
            "--device", "cpu"]
    one = launch_serve.main(argv)
    on = launch_serve.main(argv + ["--mesh", "1,4"])
    assert on == one and len(one) == 4
