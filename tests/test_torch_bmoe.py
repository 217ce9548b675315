"""The port's B-MoE inference path against the JAX package, on the CPU:
routing and dispatch exactly, the forward at 1e-5 on shared numpy inputs
and noise, a JAX-trained system carried across, and the paper's trust
claims on the port's own init and RNG."""
import functools
import importlib.util
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bmoe as jbmoe
from repro.core import experts as jex
from repro.core.attacks import AttackConfig as JAttack
from repro.models.moe import capacity_positions as jcapacity_positions
from repro_torch.convert import params_from_numpy
from repro_torch.core import bmoe, experts
from repro_torch.core.attacks import AttackConfig
from repro_torch.data.synthetic import FMNIST, make_image_dataset
from repro_torch.kernels import ops
from repro_torch.models.moe import capacity_positions
from repro_torch.trust.protocol import TrustConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def data():
    xtr, ytr, xte, yte = make_image_dataset(FMNIST, n_train=2000,
                                            n_test=500, seed=0)
    return (xtr.reshape(len(xtr), -1), ytr, xte.reshape(len(xte), -1), yte)


def test_synthetic_data_matches_jax():
    from repro.data.synthetic import FMNIST as JF, make_image_dataset as jmk
    for a, b in zip(make_image_dataset(FMNIST, 50, 20, seed=3),
                    jmk(JF, 50, 20, seed=3)):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ routing
@pytest.mark.parametrize("N,P,cap", [(4, 40, 6), (10, 300, 25), (3, 9, 9)])
def test_capacity_positions_match_jax(N, P, cap):
    eid = np.random.default_rng(P).integers(0, N, size=(2, P))
    pos, keep, onehot = capacity_positions(torch.from_numpy(eid), N, cap)
    jpos, jkeep, jonehot = jcapacity_positions(jnp.asarray(eid, jnp.int32),
                                               N, cap)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(onehot.numpy(), np.asarray(jonehot))
    assert not keep.all() or cap >= P            # overflow is exercised


@pytest.mark.parametrize("batch", [1, 7, 40, 256, 1000])
@pytest.mark.parametrize("N,K,cf", [(10, 3, 1.25), (4, 2, 1.0), (8, 1, 2.0)])
def test_sparse_capacity_matches_jax(batch, N, K, cf):
    kw = dict(num_experts=N, top_k=K, capacity_factor=cf)
    assert bmoe.sparse_capacity(bmoe.BMoEConfig(**kw), batch) == \
        jbmoe.sparse_capacity(jbmoe.BMoEConfig(**kw), batch)
    if (N, K, batch) == (10, 3, 1000):
        assert bmoe.sparse_capacity(bmoe.BMoEConfig(**kw), batch) == 376


@pytest.mark.parametrize("cf", [1.25, 0.5])          # 0.5 forces drops
def test_sparse_dispatch_matches_jax(cf):
    N, K, B, d = 5, 2, 60, 12
    rng = np.random.default_rng(11)
    xin = rng.standard_normal((B, d)).astype(np.float32)
    topi = np.argsort(rng.random((B, N)), axis=1)[:, :K].astype(np.int32)
    cfg = bmoe.BMoEConfig(num_experts=N, top_k=K, capacity_factor=cf)
    jcfg = jbmoe.BMoEConfig(num_experts=N, top_k=K, capacity_factor=cf)
    cap = bmoe.sparse_capacity(cfg, B)
    buf, eid, posc, keep = bmoe._sparse_dispatch(
        torch.from_numpy(xin), torch.from_numpy(topi).long(), cfg, cap)
    jbuf, jeid, jposc, jkeep = jbmoe._sparse_dispatch(
        jnp.asarray(xin), jnp.asarray(topi), jcfg, cap)
    np.testing.assert_array_equal(eid.numpy(), np.asarray(jeid))
    np.testing.assert_array_equal(posc.numpy(), np.asarray(jposc))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    if cf < 1:
        assert not keep.all()


def test_topk_ties_break_like_jax():
    """Integer-valued logits tie often: lower index first, as top_k."""
    logits = np.random.default_rng(0).integers(0, 3, (64, 10)).astype(
        np.float32)
    w, topi = experts.sparse_gate_weights(torch.from_numpy(logits), 3)
    jw, jtopi = jex.sparse_gate_weights(jnp.asarray(logits), 3)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------------------ forward
def _jax_noise(framework, key, colluding, M, shape):
    """The JAX package's draw (bmoe.py _trust_outputs), as numpy."""
    if framework == "traditional":
        return np.array(jax.random.normal(key, shape, jnp.float32))
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, 0 if colluding else m), shape, jnp.float32))
        for m in range(M)])


@pytest.fixture(scope="module")
def jax_forward():
    """Per framework: a small JAX system (N=4, M=5, K=2) and its jitted
    ``_moe_forward``, compiled once for all the cases below."""
    out = {}
    for framework in ("bmoe", "traditional"):
        jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(
            num_experts=4, num_edges=5, top_k=2, framework=framework,
            pow_difficulty=1))
        out[framework] = (jsys, jax.jit(functools.partial(
            jbmoe._moe_forward, cfg=jsys.cfg, apply_all=jsys._apply_all,
            apply_grouped=jsys._apply_grouped)))
    return out


@pytest.mark.parametrize("framework,mask,colluding,active", [
    ("bmoe", (0, 0, 0, 1, 1), True, (1, 1, 1, 1, 1)),     # minority
    ("bmoe", (0, 0, 1, 1, 1), True, (1, 1, 1, 1, 1)),     # majority flips
    ("bmoe", (0, 1, 0, 0, 1), False, (1, 1, 0, 1, 1)),    # masked electorate
    ("traditional", (0, 1, 0, 1, 0), True, (1, 1, 1, 1, 1)),
    ("bmoe", (0, 0, 0, 0, 0), True, (1, 1, 1, 1, 1)),
])
def test_moe_forward_matches_jax(data, jax_forward, framework, mask,
                                colluding, active):
    N, M, K, B = 4, 5, 2, 40
    kw = dict(num_experts=N, num_edges=M, top_k=K, framework=framework)
    jsys, fwd = jax_forward[framework]
    jcfg = jsys.cfg
    x = data[2][:B]
    key = jax.random.PRNGKey(5)
    cap = jbmoe.sparse_capacity(jcfg, B)
    noise = _jax_noise(framework, key, colluding, M, (N, cap, 10))
    mask_e = np.asarray(mask, np.float32)
    act = np.asarray(active, np.float32)
    jout = fwd(jsys.gate, jsys.experts, jnp.asarray(x), jnp.asarray(mask_e),
               key, 5.0, jnp.asarray(colluding), gate_bias=jnp.zeros(N),
               active=jnp.asarray(act))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.gate),
                          jax.tree_util.tree_map(np.asarray, jsys.experts),
                          device="cpu")
    cfg = bmoe.BMoEConfig(**kw)
    out = bmoe._moe_forward(p["gate"], p["experts"], torch.from_numpy(x),
                            torch.from_numpy(mask_e), torch.from_numpy(noise),
                            5.0, cfg, torch.zeros(N), torch.from_numpy(act))
    y, w, activation, support, flags, logits, dropped = (
        o.numpy() for o in out)
    jy, jw, jact, jsup, jflags, jlogits, jdropped = (np.asarray(o)
                                                     for o in jout)
    np.testing.assert_allclose(y, jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(logits, jlogits, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w, jw, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(activation, jact)
    np.testing.assert_array_equal(support, jsup)
    np.testing.assert_array_equal(flags, jflags)
    assert float(dropped) == float(jdropped)


# ------------------------------------------------------------ system
@pytest.fixture(scope="module")
def trained(data):
    """A JAX BMoESystem trained 3 rounds, and the port carrying its
    weights."""
    xtr, ytr, _, _ = data
    jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(pow_difficulty=1, seed=0))
    rng = np.random.default_rng(0)
    for _ in range(3):
        idx = rng.integers(0, len(xtr), 256)
        jsys.train_round(xtr[idx], ytr[idx])
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.gate),
                          jax.tree_util.tree_map(np.asarray, jsys.experts),
                          device="cpu")
    return jsys, bmoe.BMoESystem(bmoe.BMoEConfig(seed=0), device="cpu",
                                 params=p)


def test_carried_weights_infer_and_evaluate_match_jax(data, trained):
    _, _, xte, yte = data
    jsys, tsys = trained
    jl, jact, jsup = jsys.infer(xte, attack=JAttack())
    tl, tact, tsup = tsys.infer(xte, attack=AttackConfig())
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tl.argmax(-1), jl.argmax(-1))
    np.testing.assert_array_equal(tact, jact)
    np.testing.assert_array_equal(tsup, jsup)
    assert tsys.evaluate(xte, yte, attack=AttackConfig()) == \
        jsys.evaluate(xte, yte, attack=JAttack())
    # the genesis bank the edge cache serves is the carried bank
    assert tsys.storage_report().keys() == jsys.storage_report().keys()
    assert tsys.edge_cache.stats["misses"] == 10


@pytest.fixture(scope="module")
def port_systems():
    return (bmoe.BMoESystem(bmoe.BMoEConfig(), device="cpu"),
            bmoe.BMoESystem(bmoe.BMoEConfig(framework="traditional"),
                            device="cpu"))


def _colluders(m):
    return AttackConfig(malicious_edges=tuple(range(10 - m, 10)),
                        attack_prob=1.0, noise_std=5.0)


def test_bmoe_filters_minority_bitwise(data, port_systems):
    sys_b, _ = port_systems
    x = data[2][:200]
    clean, _, s0 = sys_b.infer(x, attack=AttackConfig())
    l3, _, s3 = sys_b.infer(x, attack=_colluders(3))
    assert np.array_equal(clean, l3)
    assert (s0 == 10).all() and (s3 == 7).all()


def test_bmoe_majority_flips_the_vote(data, port_systems):
    sys_b, _ = port_systems
    x = data[2][:200]
    clean, _, _ = sys_b.infer(x, attack=AttackConfig())
    l6, _, s6 = sys_b.infer(x, attack=_colluders(6))
    assert not np.allclose(clean, l6)
    assert (s6 == 6).all()


def test_traditional_is_not_filtered(data, port_systems):
    _, sys_t = port_systems
    x = data[2][:200]
    clean, _, s = sys_t.infer(x, attack=AttackConfig())
    l3, _, _ = sys_t.infer(x, attack=_colluders(3))
    assert not np.allclose(clean, l3)
    assert (s == 1.0).all()


def test_attack_draw_is_seeded_and_colluders_share_noise():
    sys_a = bmoe.BMoESystem(bmoe.BMoEConfig(), device="cpu")
    atk = _colluders(3)
    m1, n1 = sys_a._draw_attack(atk, 100, 7)
    m2, n2 = sys_a._draw_attack(atk, 100, 7)
    assert torch.equal(m1, m2) and torch.equal(n1, n2)
    assert n1.shape == (10, 10, bmoe.sparse_capacity(sys_a.cfg, 100), 10)
    assert torch.equal(n1[7], n1[9])                  # shared fold id 0
    _, n3 = sys_a._draw_attack(atk, 100, 8)
    assert not torch.equal(n1, n3)                    # another round
    solo = AttackConfig(malicious_edges=(8, 9), attack_prob=1.0,
                        colluding=False)
    _, n4 = sys_a._draw_attack(solo, 100, 7)
    assert not torch.equal(n4[8], n4[9])


def test_edge_cache_off_is_bitwise_on(data):
    x = data[2][:100]
    atk = _colluders(2)
    on = bmoe.BMoESystem(bmoe.BMoEConfig(), device="cpu")
    off = bmoe.BMoESystem(bmoe.BMoEConfig(edge_cache="off"), device="cpu")
    assert np.array_equal(on.infer(x, attack=atk)[0],
                          off.infer(x, attack=atk)[0])
    assert off.storage_report()["cache"] is None


def test_plain_path_launches_no_kernel(data, port_systems):
    sys_b, _ = port_systems
    ops.reset_launch_counts()
    sys_b.infer(data[2][:50])
    assert ops.launch_counts() == {"moe_gemm": 0, "redundancy_vote": 0,
                                   "audit_mlp": 0, "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "rglru_scan": 0,
                                   "rglru_scan_bwd": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0}


@pytest.mark.parametrize("kw,match", [
    (dict(mesh="on", dispatch="dense"), "sparse"),
])
def test_unported_options_raise(kw, match):
    """Every option is ported; what stays refused is what cannot run: the
    edge mesh exchanges capacity buckets, so it needs sparse dispatch
    (``mesh="on"`` itself: tests/test_torch_mesh.py)."""
    with pytest.raises(ValueError, match=match):
        bmoe.BMoESystem(bmoe.BMoEConfig(**kw), device="cpu")


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        bmoe.BMoESystem(bmoe.BMoEConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"w": np.zeros((2, 2)), "b": np.zeros(2)},
                          {k: np.zeros(1) for k in ("w1", "b1", "w2", "b2")})
    with pytest.raises(RuntimeError, match="CUDA"):
        experts.init_gate(784, 10, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        experts.init_mlp_bank(10, seed=0)


def test_params_from_numpy_checks_keys():
    with pytest.raises(ValueError, match="gate"):
        params_from_numpy({"w": np.zeros((2, 2))}, {}, device="cpu")
    with pytest.raises(ValueError, match="experts"):
        bmoe.BMoESystem(bmoe.BMoEConfig(), device="cpu", params=params_from_numpy(
            {"w": np.zeros((784, 10)), "b": np.zeros(10)},
            {"w1": np.zeros((10, 784, 8)), "b1": np.zeros((10, 8)),
             "w2": np.zeros((10, 8, 3)), "b2": np.zeros((10, 3))},
            device="cpu"))


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module (the serving engine, the training stack
    and their launchers among them), and chip_smoke.py, imported in a
    fresh interpreter, leaves jax and repro out of sys.modules."""
    code = textwrap.dedent(f"""
        import importlib, importlib.util, pkgutil, sys
        sys.path.insert(0, {os.path.join(ROOT, 'src')!r})
        import repro_torch
        names = [m.name for m in pkgutil.walk_packages(
            repro_torch.__path__, "repro_torch.")]
        for n in names:
            importlib.import_module(n)
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", {os.path.join(ROOT, 'chip_smoke.py')!r})
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "repro" or m.startswith("repro.")]
        lm = {{"repro_torch.configs", "repro_torch.models.builder",
              "repro_torch.models.layers", "repro_torch.models.rglru",
              "repro_torch.models.ssm", "repro_torch.models.transformer",
              "repro_torch.train.step", "repro_torch.train.loop",
              "repro_torch.kernels.flash_attention",
              "repro_torch.kernels.rglru_scan",
              "repro_torch.serve", "repro_torch.serve.engine",
              "repro_torch.serve.scheduler", "repro_torch.trust.session",
              "repro_torch.storage.kv", "repro_torch.launch.serve",
              "repro_torch.optim.adamw", "repro_torch.checkpoint.io",
              "repro_torch.launch.train", "repro_torch.launch.mesh",
              "repro_torch.sharding"}}
        missing = sorted(lm - set(names))
        print(len(names), bad, missing)
        sys.exit(1 if bad or missing or len(names) < 25 else 0)
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={k: v for k, v in os.environ.items()
                              if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert importlib.util.find_spec("repro_torch") is not None


def test_expert_apply_matches_jax_and_the_grouped_path():
    rng = np.random.default_rng(4)
    bank = {"w1": rng.standard_normal((3, 20, 16)).astype(np.float32) / 4,
            "b1": rng.standard_normal((3, 16)).astype(np.float32),
            "w2": rng.standard_normal((3, 16, 5)).astype(np.float32) / 4,
            "b2": rng.standard_normal((3, 5)).astype(np.float32)}
    x = rng.standard_normal((7, 20)).astype(np.float32)
    tbank = {k: torch.from_numpy(v) for k, v in bank.items()}
    grouped = experts.mlp_expert_apply_grouped(
        tbank, torch.from_numpy(x)[None].expand(3, 7, 20).contiguous())
    for e in range(3):
        one = experts.mlp_expert_apply({k: v[e] for k, v in tbank.items()},
                                       torch.from_numpy(x))
        jone = jex.mlp_expert_apply({k: jnp.asarray(v[e])
                                     for k, v in bank.items()},
                                    jnp.asarray(x))
        np.testing.assert_allclose(one.numpy(), np.asarray(jone),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(grouped[e].numpy(), one.numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_port_init_follows_the_jax_init_laws():
    gate = experts.init_gate(784, 10, seed=0, device="cpu")
    bank = experts.init_mlp_bank(10, seed=0, device="cpu")
    assert gate["w"].shape == (784, 10) and not gate["b"].any()
    assert abs(float(gate["w"].std()) - 0.01) < 1e-3
    assert abs(float(bank["w1"].std()) - 784 ** -0.5) < 1e-3
    assert abs(float(bank["w2"].std()) - 256 ** -0.5) < 2e-3
    assert not bank["b1"].any() and not bank["b2"].any()
    again = experts.init_mlp_bank(10, seed=0, device="cpu")
    assert all(torch.equal(bank[k], again[k]) for k in bank)
    assert not torch.equal(bank["w1"], experts.init_mlp_bank(
        10, 1, device="cpu")["w1"])
