"""The port's B-MoE training (``train_round`` under ``bmoe`` and
``traditional``) against the JAX package, on the CPU: one SGD step on
shared numpy inputs and JAX's own noise, the expert MLP's backward, the
vote's gradient, carried weights trained three rounds side by side; then
the paper's training claims on the port's own init and RNG, and the edge
cache's bitwise guarantees in training."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bmoe as jbmoe
from repro.core import experts as jex
from repro.core.attacks import AttackConfig as JAttack
from repro.kernels import ref as jref
from repro_torch.convert import params_from_numpy
from repro_torch.core import bmoe, experts
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.ledger import digest_tree
from repro_torch.data.synthetic import FMNIST, make_image_dataset
from repro_torch.kernels import ops, ref


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """At most 4 intra-op threads while this file runs: its rounds are
    small ops, which more threads only slow on a shared CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    xtr, ytr, xte, yte = make_image_dataset(FMNIST, n_train=2000,
                                            n_test=500, seed=0)
    return (xtr.reshape(len(xtr), -1), ytr, xte.reshape(len(xte), -1), yte)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_noise(framework, key, colluding, M, shape):
    """The JAX package's draw (bmoe.py _trust_outputs), as numpy."""
    if framework == "traditional":
        return np.array(jax.random.normal(key, shape, jnp.float32))
    return np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, 0 if colluding else m), shape, jnp.float32))
        for m in range(M)])


# ------------------------------------------------------------ one step
@pytest.fixture(scope="module")
def jax_train():
    """Per framework: a small JAX system (N=4, M=5, K=2) and its jitted
    ``_train_step``, compiled once for all the cases below."""
    out = {}
    for framework in ("bmoe", "traditional"):
        jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(
            num_experts=4, num_edges=5, top_k=2, framework=framework,
            pow_difficulty=1))
        out[framework] = (jsys, jax.jit(functools.partial(
            jbmoe._train_step, cfg=jsys.cfg, apply_all=jsys._apply_all,
            apply_grouped=jsys._apply_grouped)))
    return out


@pytest.mark.parametrize("framework,mask,colluding,active", [
    ("bmoe", (0, 0, 0, 1, 1), True, (1, 1, 1, 1, 1)),     # minority
    ("bmoe", (0, 0, 1, 1, 1), True, (1, 1, 1, 1, 1)),     # majority flips
    ("bmoe", (0, 1, 0, 0, 1), False, (1, 1, 0, 1, 1)),    # masked electorate
    ("traditional", (0, 1, 0, 1, 0), True, (1, 1, 1, 1, 1)),
    ("bmoe", (0, 0, 0, 0, 0), True, (1, 1, 1, 1, 1)),     # clean
])
def test_train_step_matches_jax(data, jax_train, framework, mask, colluding,
                                active):
    N, M, K, B = 4, 5, 2, 40
    jsys, step = jax_train[framework]
    x, y = data[2][:B], data[3][:B]
    key = jax.random.PRNGKey(7)
    cap = jbmoe.sparse_capacity(jsys.cfg, B)
    noise = _jax_noise(framework, key, colluding, M, (N, cap, 10))
    mask_e = np.asarray(mask, np.float32)
    act = np.asarray(active, np.float32)
    jgate, jexp, jm = step(jsys.gate, jsys.experts, jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(mask_e), key, 5.0,
                           jnp.asarray(colluding), jnp.zeros(N),
                           jnp.asarray(act), jnp.int32(0))
    gate0, exp0 = _numpy_tree(jsys.gate), _numpy_tree(jsys.experts)
    p = params_from_numpy(gate0, exp0, device="cpu")
    cfg = bmoe.BMoEConfig(num_experts=N, num_edges=M, top_k=K,
                          framework=framework)
    gate, exp, m = bmoe._train_step(
        p["gate"], p["experts"], torch.from_numpy(x),
        torch.from_numpy(y).long(), torch.from_numpy(mask_e),
        torch.from_numpy(noise), 5.0, torch.zeros(N), torch.from_numpy(act),
        cfg=cfg)
    lr = cfg.lr
    for before, after, jafter in ((gate0, gate, jgate), (exp0, exp, jexp)):
        for k in before:
            got, want = after[k].numpy(), np.asarray(jafter[k])
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                       err_msg=k)
            np.testing.assert_allclose((before[k] - got) / lr,
                                       (before[k] - want) / lr, rtol=1e-4,
                                       atol=1e-6, err_msg=f"grad {k}")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5, atol=1e-5)
    for k in ("activation", "support", "flags", "dropped"):
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]),
                                      err_msg=k)


# ------------------------------------------------- expert MLP backward
@pytest.mark.parametrize("buf_grad", [False, True])
def test_expert_mlp_backward_matches_jax(monkeypatch, buf_grad):
    """The grouped MLP's vjp against JAX's custom_vjp, dbuf included when
    asked for; its products are ops.moe_gemm calls: 2 forward, 3 backward
    (4 with dbuf)."""
    rng = np.random.default_rng(9)
    bank = {"w1": rng.standard_normal((3, 20, 16)).astype(np.float32) / 4,
            "b1": rng.standard_normal((3, 16)).astype(np.float32),
            "w2": rng.standard_normal((3, 16, 5)).astype(np.float32) / 4,
            "b2": rng.standard_normal((3, 5)).astype(np.float32)}
    buf = rng.standard_normal((3, 7, 20)).astype(np.float32)
    buf[1, 4:] = 0.0                              # empty bucket slots
    g = rng.standard_normal((3, 7, 5)).astype(np.float32)
    jout, vjp = jax.vjp(jex.mlp_expert_apply_grouped,
                        {k: jnp.asarray(v) for k, v in bank.items()},
                        jnp.asarray(buf))
    jgrads, jdbuf = vjp(jnp.asarray(g))
    calls = []
    real = ops.moe_gemm
    monkeypatch.setattr(ops, "moe_gemm",
                        lambda a, b: calls.append(1) or real(a, b))
    tbank = {k: torch.from_numpy(v).requires_grad_() for k, v in bank.items()}
    tbuf = torch.from_numpy(buf).requires_grad_(buf_grad)
    out = experts.mlp_expert_apply_grouped(tbank, tbuf)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-5)
    out.backward(torch.from_numpy(g))
    assert len(calls) == (6 if buf_grad else 5)
    for k in bank:
        np.testing.assert_allclose(tbank[k].grad.numpy(),
                                   np.asarray(jgrads[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    if buf_grad:
        np.testing.assert_allclose(tbuf.grad.numpy(), np.asarray(jdbuf),
                                   rtol=1e-5, atol=1e-5)
    else:
        assert tbuf.grad is None


# ---------------------------------------------------- vote's gradient
@pytest.mark.parametrize("case", ["ties", "masked", "nan_inf", "all_barred"])
def test_vote_gradient_matches_jax(case):
    """The cotangent of trusted[e] lands on pub[e, winner[e]], exactly as
    JAX's vjp of take_along_axis puts it; the plain winner is JAX's
    argmax (first max, so ties go to the lowest copy)."""
    E, M, T = 6, 8, 12
    rng = np.random.default_rng(len(case))
    base = rng.standard_normal((E, 1, T)).astype(np.float32)
    pub = np.repeat(base, M, axis=1)
    active = np.ones(M, np.float32)
    if case == "ties":
        # two coalitions of four: the lower one wins every tie
        pub[:, 4:] += rng.standard_normal((E, 1, T)).astype(np.float32)
        pub[3, 1:] += rng.standard_normal((7, T)).astype(np.float32)
    elif case == "masked":
        pub[:, 5:] += 3.0
        active[[0, 6]] = 0.0
    elif case == "nan_inf":
        pub[0, 0, 2] = np.nan
        pub[1, :, 4] = np.inf
        pub[2, 3:, 0] = -np.inf
    else:
        active[:] = 0.0
    g = rng.standard_normal((E, T)).astype(np.float32)
    jact = jnp.asarray(active)
    _, vjp = jax.vjp(lambda p: jref.redundancy_vote_masked_ref(p, jact)[0],
                     jnp.asarray(pub))
    (jgrad,) = vjp(jnp.asarray(g))
    jgrad = np.asarray(jgrad)
    tpub = torch.from_numpy(pub).requires_grad_()
    trusted, _, _ = ops.redundancy_vote_masked(tpub, torch.from_numpy(active))
    trusted.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tpub.grad.numpy(), jgrad)
    jwinner = np.abs(jgrad).sum(-1).argmax(-1)     # the row g landed on
    _, _, _, winner = ref.redundancy_vote_winner_ref(
        torch.from_numpy(pub), torch.from_numpy(active))
    np.testing.assert_array_equal(winner.numpy(), jwinner)
    if case == "ties":
        assert winner[3] == 0 and (winner == 0).all()


# ------------------------------------------------ carried-weight rounds
def test_carried_weights_train_like_jax(data):
    """A JAX system and the port from the same weights, three clean
    rounds of 256: the same routing and supports every round, and
    parameters within 1e-5 after them."""
    xtr, ytr, _, _ = data
    jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(pow_difficulty=1, seed=0))
    p = params_from_numpy(_numpy_tree(jsys.gate), _numpy_tree(jsys.experts),
                          device="cpu")
    tsys = bmoe.BMoESystem(bmoe.BMoEConfig(pow_difficulty=1, seed=0),
                           device="cpu", params=p)
    rng = np.random.default_rng(0)
    for r in range(3):
        idx = rng.integers(0, len(xtr), 256)
        jm = jsys.train_round(xtr[idx], ytr[idx], attack=JAttack())
        tm = tsys.train_round(xtr[idx], ytr[idx], attack=AttackConfig())
        for k in ("activation", "support", "flags", "dropped"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=(r, k))
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
        jb, tb = jsys.ledger.blocks[-1].payload, tsys.ledger.blocks[-1].payload
        assert {k: tb[k] for k in ("round", "task", "trusted_supports",
                                   "expert_hash_support")} == \
            {k: jb[k] for k in ("round", "task", "trusted_supports",
                                "expert_hash_support")}
    for mine, theirs in ((tsys.gate, jsys.gate),
                         (tsys.experts, jsys.experts)):
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(),
                                       np.asarray(theirs[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    assert len(tsys.ledger.blocks) == len(jsys.ledger.blocks) == 4
    assert tsys.verification_report() == jsys.verification_report()
    assert tsys.round == 3 and tsys._bank_version == jsys._bank_version


# ------------------------------------- the paper's claims, port's init
def _train(framework, attack, data, rounds, seed=0):
    xtr, ytr, _, _ = data
    sys_ = bmoe.BMoESystem(bmoe.BMoEConfig(framework=framework,
                                           attack=attack, pow_difficulty=2,
                                           seed=seed), device="cpu")
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        idx = rng.integers(0, len(xtr), 256)
        sys_.train_round(xtr[idx], ytr[idx])
    return sys_


ATK = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=0.5,
                   noise_std=5.0)


def test_ledger_records_every_training_round(data):
    sys_b = _train("bmoe", ATK, data, rounds=10)
    assert len(sys_b.ledger.blocks) == 11          # genesis + 10 rounds
    assert sys_b.ledger.verify_chain()
    assert [b.payload["round"] for b in sys_b.ledger.blocks[1:]] == \
        list(range(10))
    assert all("expert_hash" in b.payload for b in sys_b.ledger.blocks[1:])


def test_param_poisoning_rejected_by_hash_vote(data):
    atk = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                       noise_std=5.0, poison_params=True)
    sys_b = _train("bmoe", atk, data, rounds=5)
    for b in sys_b.ledger.blocks[1:]:
        assert b.payload["expert_hash_accepted"]
        assert b.payload["expert_hash_support"] == 7     # honest majority
        assert "chain_misled" not in b.payload


def test_majority_poisoning_misleads_chain(data):
    atk = AttackConfig(malicious_edges=(0, 1, 2, 3, 4, 5), attack_prob=1.0,
                       noise_std=5.0, poison_params=True, colluding=True)
    sys_b = _train("bmoe", atk, data, rounds=3)
    assert any(b.payload.get("chain_misled")
               for b in sys_b.ledger.blocks[1:])


def test_gate_deactivates_poisoned_experts_in_training(data):
    """Fig. 2: under training-time attack the traditional gate's
    activation ratio for malicious experts collapses."""
    trad = _train("traditional", ATK, data, rounds=40)
    ratio = trad.activation_ratio
    assert ratio[list(ATK.malicious_edges)].mean() < 0.5 * ratio[:7].mean()


def test_bmoe_robust_traditional_degrades(data):
    """Paper Fig. 4c: both trained clean, then attacked at inference."""
    _, _, xte, yte = data
    trad = _train("traditional", AttackConfig(), data, rounds=30)
    sys_b = _train("bmoe", AttackConfig(), data, rounds=30)
    strong = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                          noise_std=5.0)
    acc_trad = trad.evaluate(xte, yte, attack=strong)
    acc_bmoe = sys_b.evaluate(xte, yte, attack=strong)
    assert acc_bmoe > acc_trad + 0.1, (acc_bmoe, acc_trad)
    acc_clean = sys_b.evaluate(xte, yte, attack=AttackConfig())
    assert abs(acc_bmoe - acc_clean) < 0.02


def test_latency_report_shows_bmoe_overhead(data):
    trad = _train("traditional", ATK, data, rounds=5)
    sys_b = _train("bmoe", ATK, data, rounds=5)
    lt = trad.latency_report(expert_bytes=850_000, result_bytes=40_000,
                             rounds=5)
    lb = sys_b.latency_report(expert_bytes=850_000, result_bytes=40_000,
                              rounds=5)
    assert lb.keys() == lt.keys() == {
        "compute_s", "comm_s", "consensus_s", "chain_s", "audit_offpath_s",
        "storage_s", "total_s"}
    assert lb["total_s"] > lt["total_s"]      # security costs latency
    assert lb["consensus_s"] >= 0 and lb["chain_s"] > 0
    rep = sys_b.obs_report()
    assert rep["timers"].keys() == {"compute", "consensus", "chain", "audit",
                                    "audit_infer", "storage"}
    assert rep["metrics"]["bmoe.round_s"] > 0


# ------------------------------------------------------ edge cache
def _cache_data(seed=0, n=400):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 784)).astype(np.float32),
            rng.integers(0, 10, n))


def _run_cached(edge_cache, framework, rounds=5):
    atk = AttackConfig(malicious_edges=(4,), attack_prob=0.5, noise_std=5.0)
    s = bmoe.BMoESystem(bmoe.BMoEConfig(
        num_experts=6, num_edges=6, top_k=2, framework=framework,
        pow_difficulty=2, attack=atk, edge_cache=edge_cache), device="cpu")
    x, y = _cache_data()
    rng = np.random.default_rng(1)
    for _ in range(rounds):
        idx = rng.integers(0, len(x), 48)
        s.train_round(x[idx], y[idx])
    return s


@pytest.mark.parametrize("framework", ["bmoe", "traditional"])
def test_cache_on_off_bit_identical_training_and_inference(framework):
    """Fetching the bank through the chunk store and the cache changes
    nothing: states and inference outputs equal the resident bank's bit
    for bit."""
    a = _run_cached("on", framework)
    b = _run_cached("off", framework)
    assert digest_tree(a.experts) == digest_tree(b.experts)
    assert digest_tree(a.gate) == digest_tree(b.gate)
    x, _ = _cache_data(3, 64)
    np.testing.assert_array_equal(a.infer(x)[0], b.infer(x)[0])
    assert a.edge_cache is not None and b.edge_cache is None
    assert a.edge_cache.stats["misses"] > 0


def test_unrouted_experts_receive_zero_gradient():
    """An expert the batch never routed to is bit-identical after the
    round, so skipping its re-upload is sound."""
    s = bmoe.BMoESystem(bmoe.BMoEConfig(
        num_experts=8, num_edges=8, top_k=2, framework="traditional",
        pow_difficulty=2, seed=0), device="cpu")
    x, y = _cache_data(4, 8)
    before = {k: v.clone() for k, v in s.experts.items()}
    m = s.train_round(x[:1], y[:1])           # one sample: k experts routed
    routed = set(np.nonzero(m["activation"])[0])
    assert len(routed) == 2
    for e in range(8):
        same = all(torch.equal(before[k][e], s.experts[k][e])
                   for k in before)
        assert same == (e not in routed), (e, routed)


def test_poison_tree_is_seeded_per_leaf():
    tree = {"w": torch.zeros(3, 4), "b": torch.zeros(4)}
    from repro_torch.core.attacks import poison_tree
    a = poison_tree(tree, 5.0, 1, 2, "poison", 0)
    assert all(torch.equal(a[k], poison_tree(tree, 5.0, 1, 2, "poison",
                                             0)[k]) for k in tree)
    other = poison_tree(tree, 5.0, 1, 2, "poison", 3)
    assert not torch.equal(a["w"], other["w"])
    assert a.keys() == tree.keys() and a["w"].shape == (3, 4)
    assert abs(float(a["w"].std()) - 5.0) < 3.0
