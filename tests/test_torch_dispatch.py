"""Dense dispatch, the CNN experts, the workload balancer and the smart
contracts of the port against the JAX package, on the CPU.

- ``dispatch="dense"`` (every expert on the whole batch, the reference's
  oracle): ``infer`` and ``train_round`` against JAX's dense path at
  1e-5, and against the port's own sparse path without drops at the
  tolerances of ``tests/test_sparse_dispatch.py``.
- ``expert_kind="cnn"`` (the paper's CIFAR-10 setting): the SAME-padded
  stride-2 convolution at the three layer sizes, one expert, the grouped
  bank, one ``_train_step`` under ``bmoe`` and ``traditional``, and a
  carried system's ``infer``; the optimistic framework's commitment and
  audits over CNN leaves, honest and attacked.
- ``workload_balance=True``: the bias trajectory over carried rounds,
  exact while the routing agrees.
- ``core/contracts.py`` as ``tests/test_blockchain.py`` uses it."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bmoe as jbmoe
from repro.core import contracts as jcontracts
from repro.core import experts as jex
from repro.core.attacks import AttackConfig as JAttack
from repro_torch.convert import params_from_numpy
from repro_torch.core import bmoe, contracts, experts
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.ledger import digest_tree
from repro_torch.core.reputation import ReputationConfig
from repro_torch.data.synthetic import CIFAR10, FMNIST, make_image_dataset
from repro_torch.trust.protocol import RoundPhase, TrustConfig

REP = dict(init=0.5, gain=0.01, slash=0.4, exclusion_threshold=0.2)
NO_DROPS = 4.0          # capacity_factor = N/k: capacity == batch, 0 drops


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """One intra-op thread while this file runs: its rounds are small
    ops, which more threads only slow on a CPU shared by several test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    xtr, ytr, xte, yte = make_image_dataset(FMNIST, n_train=1200,
                                            n_test=200, seed=0)
    return xtr.reshape(len(xtr), -1), ytr, xte.reshape(len(xte), -1), yte


@pytest.fixture(scope="module")
def cifar():
    xtr, ytr, _, _ = make_image_dataset(CIFAR10, n_train=300, n_test=10,
                                        seed=0)
    return xtr.astype(np.float32), ytr


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _carry(jsys):
    return params_from_numpy(_numpy_tree(jsys.gate),
                             _numpy_tree(jsys.experts), device="cpu")


def _assert_params_close(tsys, jsys, rtol=1e-5, atol=1e-5):
    for mine, theirs in ((tsys.gate, jsys.gate),
                         (tsys.experts, jsys.experts)):
        assert set(mine) == set(theirs)
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(),
                                       np.asarray(theirs[k]), rtol=rtol,
                                       atol=atol, err_msg=k)


# ------------------------------------------------------ dense dispatch
@pytest.mark.parametrize("framework", ["bmoe", "traditional"])
def test_dense_infer_and_train_match_jax(data, framework):
    """Carried weights, dense dispatch, three clean rounds of 64 and an
    infer: integers equal, loss, logits and parameters at 1e-5."""
    xtr, ytr, xte, _ = data
    kw = dict(num_experts=6, num_edges=6, top_k=2, framework=framework,
              pow_difficulty=1, dispatch="dense")
    jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(**kw))
    tsys = bmoe.BMoESystem(bmoe.BMoEConfig(**kw), device="cpu",
                           params=_carry(jsys))
    rng = np.random.default_rng(0)
    for r in range(3):
        idx = rng.integers(0, len(xtr), 64)
        jm = jsys.train_round(xtr[idx], ytr[idx], attack=JAttack())
        tm = tsys.train_round(xtr[idx], ytr[idx], attack=AttackConfig())
        for k in ("activation", "support", "flags", "dropped"):
            np.testing.assert_array_equal(tm[k], jm[k], err_msg=(r, k))
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
    _assert_params_close(tsys, jsys)
    tl, tact, tsup = tsys.infer(xte[:50], attack=AttackConfig())
    jl, jact, jsup = jsys.infer(xte[:50], attack=JAttack())
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tact, jact)
    np.testing.assert_array_equal(tsup, jsup)
    assert tsys.verification_report() == jsys.verification_report()


def _opt_cfg(dispatch, attack=AttackConfig(), capacity_factor=1.25,
             trust=None, **kw):
    kw.setdefault("num_experts", 8)
    kw.setdefault("top_k", 2)
    return bmoe.BMoEConfig(
        framework="optimistic", attack=attack, pow_difficulty=2,
        dispatch=dispatch, capacity_factor=capacity_factor,
        reputation=ReputationConfig(**REP),
        trust=trust or TrustConfig(audit_rate=1.0, num_verifiers=2,
                                   challenge_window=2), **kw)


def test_dense_matches_sparse_without_drops(data):
    """tests/test_sparse_dispatch.py:89 and :98 in the port: with capacity
    = batch nothing drops, so the sparse path's logits agree with the
    dense oracle at 1e-4 and three SGD steps land on its parameters at
    rtol 2e-4."""
    xtr, ytr, xte, _ = data
    sp = bmoe.BMoESystem(_opt_cfg("sparse", capacity_factor=NO_DROPS),
                         device="cpu")
    de = bmoe.BMoESystem(_opt_cfg("dense"), device="cpu")
    ls, _, _ = sp.infer(xte[:64], commit=False)
    ld, _, _ = de.infer(xte[:64], commit=False)
    np.testing.assert_allclose(ls, ld, rtol=1e-4, atol=1e-5)
    rng = np.random.default_rng(0)
    for idx in [rng.integers(0, len(xtr), 48) for _ in range(3)]:
        ms = sp.train_round(xtr[idx], ytr[idx])
        md = de.train_round(xtr[idx], ytr[idx])
        assert float(ms["dropped"]) == 0.0 == float(md["dropped"])
        assert float(ms["loss"]) == pytest.approx(float(md["loss"]),
                                                  abs=1e-5)
    for mine, theirs in ((sp.gate, de.gate), (sp.experts, de.experts)):
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(),
                                       rtol=2e-4, atol=1e-5, err_msg=k)


def _opt_run(dispatch, backend, xtr, ytr, rounds=5):
    atk = AttackConfig(malicious_edges=(2,), attack_prob=1.0, noise_std=5.0)
    s = bmoe.BMoESystem(_opt_cfg(dispatch, atk, trust=TrustConfig(
        audit_rate=1.0, num_verifiers=2, challenge_window=2,
        audit_backend=backend)), device="cpu")
    rng = np.random.default_rng(0)
    for idx in [rng.integers(0, len(xtr), 48) for _ in range(rounds)]:
        s.train_round(xtr[idx], ytr[idx])
    s.flush_trust()
    return s


def test_sparse_and_dense_commitments_reach_the_same_verdicts(data):
    """tests/test_sparse_dispatch.py:168 in the port: the same convictions
    under per-(expert, bucket-chunk) and per-(expert, batch-chunk)
    commitments, at capacity/batch of the verification compute."""
    xtr, ytr, _, _ = data
    sp = _opt_run("sparse", "batched", xtr, ytr)
    de = _opt_run("dense", "batched", xtr, ytr)
    assert [(e.round_id, e.edge) for e in sp.protocol.stakes.events] == \
        [(e.round_id, e.edge) for e in de.protocol.stakes.events]
    assert {r: st.phase for r, st in sp.protocol.rounds.items()} == \
        {r: st.phase for r, st in de.protocol.rounds.items()}
    assert sp.protocol.stats["rolled_back"] == \
        de.protocol.stats["rolled_back"] >= 1
    vs = sp.verification_report()["total_verification_per_round"]
    vd = de.verification_report()["total_verification_per_round"]
    cap = bmoe.sparse_capacity(sp.cfg, 48)
    assert vs == pytest.approx(vd * cap / 48, rel=1e-6)
    com = de.protocol.rounds[0].commitment
    assert com.row_index is None and com.rows_per_expert == 48


def test_capacity_overflow_drop_accounting(data):
    """tests/test_sparse_dispatch.py:123 in the port: the dropped metric
    counts the assignments the committed routing left out."""
    xtr, ytr, _, _ = data
    s = bmoe.BMoESystem(_opt_cfg("sparse", capacity_factor=0.25),
                        device="cpu")
    m = s.train_round(xtr[:64], ytr[:64])
    com = s.protocol.rounds[0].commitment
    cap = bmoe.sparse_capacity(s.cfg, 64)
    assert com.row_index.shape == (s.cfg.num_experts, cap)
    filled = int((com.row_index < 64).sum())
    assert float(m["dropped"]) == 64 * s.cfg.top_k - filled > 0
    assert np.isfinite(float(m["loss"]))


# ---------------------------------------------------------- CNN experts
@pytest.mark.parametrize("size,cin,cout", [(32, 3, 16), (16, 16, 32),
                                           (8, 32, 32)])
def test_same_padded_conv_matches_jax(size, cin, cout):
    """XLA's SAME padding at stride 2 pads (0, 1) at each of the three
    layer sizes; ``conv2d(padding=1)`` would pad (1, 1)."""
    rng = np.random.default_rng(size)
    x = rng.normal(size=(5, size, size, cin)).astype(np.float32)
    w = rng.normal(size=(3, 3, cin, cout)).astype(np.float32) / 3
    want = np.asarray(jex._conv(jnp.asarray(x), jnp.asarray(w)))
    got = experts._conv_same(torch.from_numpy(x).permute(0, 3, 1, 2),
                             torch.from_numpy(w).permute(3, 2, 0, 1))
    assert experts._same_pad(size) == (0, 1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_cnn_expert_apply_matches_jax(cifar):
    """One expert and the grouped bank (one call an expert) against
    JAX's apply and its vmap, at 1e-5; HWIO kernels and NHWC images as
    stored."""
    params, _ = jex.make_expert_bank("cnn", 3, jax.random.PRNGKey(1),
                                     in_ch=3)
    bank = {k: torch.from_numpy(np.array(v)) for k, v in params.items()}
    x = cifar[0][:12]
    buf = x.reshape(3, 4, 32, 32, 3)
    want = np.asarray(jax.vmap(jex.cnn_expert_apply)(params,
                                                     jnp.asarray(buf)))
    got = experts.cnn_expert_apply_grouped(bank, torch.from_numpy(buf))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for e in range(3):
        one = experts.cnn_expert_apply({k: v[e] for k, v in bank.items()},
                                       torch.from_numpy(buf[e]))
        np.testing.assert_allclose(one.numpy(), want[e], rtol=1e-5,
                                   atol=1e-5)
    dense = experts.cnn_apply_all(bank, torch.from_numpy(x[:5]))
    jdense = jax.vmap(jex.cnn_expert_apply, in_axes=(0, None))(
        params, jnp.asarray(x[:5]))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense),
                               rtol=1e-5, atol=1e-5)


def test_cnn_bank_init_and_carry():
    bank = experts.init_cnn_bank(4, seed=0, in_ch=3, device="cpu")
    jdecl = jex.cnn_expert_decl(3, 10)
    decl = experts.cnn_expert_decl(3, 10)
    assert {k: (v.shape, v.axes, v.init, v.scale) for k, v in decl.items()} \
        == {k: (v.shape, v.axes, v.init, v.scale) for k, v in jdecl.items()}
    assert {k: tuple(v.shape) for k, v in bank.items()} == \
        {k: (4,) + tuple(leaf.shape) for k, leaf in jdecl.items()}
    assert abs(float(bank["c2"].std()) - 16 ** -0.5) < 1e-2
    assert not bank["b1"].any() and not bank["b2"].any()
    p = params_from_numpy({"w": np.zeros((3072, 4)), "b": np.zeros(4)},
                          {k: v.numpy() for k, v in bank.items()},
                          device="cpu")
    assert all(torch.equal(p["experts"][k], bank[k]) for k in bank)
    s = bmoe.BMoESystem(bmoe.BMoEConfig(num_experts=4, num_edges=5,
                                        top_k=2, expert_kind="cnn",
                                        in_ch=3), device="cpu", params=p)
    assert digest_tree(s.experts) == digest_tree(bank)


@pytest.mark.parametrize("framework", ["bmoe", "traditional"])
def test_cnn_train_step_matches_jax(cifar, framework):
    """One CNN SGD step (lr 0.1, the paper's CIFAR-10 setting) on shared
    inputs and JAX's own noise: parameters at 1e-5, integers equal."""
    N, M, K, B = 4, 5, 2, 16
    jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(
        num_experts=N, num_edges=M, top_k=K, framework=framework,
        expert_kind="cnn", in_ch=3, lr=0.1, pow_difficulty=1))
    step = jax.jit(functools.partial(
        jbmoe._train_step, cfg=jsys.cfg, apply_all=jsys._apply_all,
        apply_grouped=jsys._apply_grouped))
    x, y = cifar[0][:B], cifar[1][:B]
    key = jax.random.PRNGKey(3)
    mask_e = np.asarray((0, 0, 0, 1, 1) if framework == "bmoe"
                        else (0, 1, 0, 0, 0), np.float32)
    cap = jbmoe.sparse_capacity(jsys.cfg, B)
    shape = (N, cap, 10)
    if framework == "traditional":
        noise = np.array(jax.random.normal(key, shape, jnp.float32))
    else:
        noise = np.stack([np.asarray(jax.random.normal(
            jax.random.fold_in(key, 0), shape, jnp.float32))] * M)
    jgate, jexp, jm = step(jsys.gate, jsys.experts, jnp.asarray(x),
                           jnp.asarray(y), jnp.asarray(mask_e), key, 5.0,
                           jnp.asarray(True), jnp.zeros(N), jnp.ones(M),
                           jnp.int32(0))
    p = _carry(jsys)
    cfg = bmoe.BMoEConfig(num_experts=N, num_edges=M, top_k=K,
                          framework=framework, expert_kind="cnn", in_ch=3,
                          lr=0.1)
    gate, exp, m = bmoe._train_step(
        p["gate"], p["experts"], torch.from_numpy(x),
        torch.from_numpy(y).long(), torch.from_numpy(mask_e),
        torch.from_numpy(noise), 5.0, torch.zeros(N), torch.ones(M),
        cfg=cfg)
    for mine, theirs in ((gate, jgate), (exp, jexp)):
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(),
                                       np.asarray(theirs[k]), rtol=1e-5,
                                       atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for k in ("activation", "support", "flags", "dropped"):
        np.testing.assert_array_equal(m[k].numpy(), np.asarray(jm[k]),
                                      err_msg=k)


def test_cnn_system_rounds_and_infer_match_jax(cifar):
    """A carried CNN system under bmoe, dense and sparse: an infer, then
    two clean rounds, against JAX's."""
    x, y = cifar
    for dispatch in ("sparse", "dense"):
        kw = dict(num_experts=4, num_edges=5, top_k=2, expert_kind="cnn",
                  in_ch=3, lr=0.1, pow_difficulty=1, dispatch=dispatch)
        jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(**kw))
        tsys = bmoe.BMoESystem(bmoe.BMoEConfig(**kw), device="cpu",
                               params=_carry(jsys))
        tl, tact, _ = tsys.infer(x[100:140], attack=AttackConfig())
        jl, jact, _ = jsys.infer(x[100:140], attack=JAttack())
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(tact, jact)
        for r in range(2):
            sl = slice(r * 32, (r + 1) * 32)
            jm = jsys.train_round(x[sl], y[sl], attack=JAttack())
            tm = tsys.train_round(x[sl], y[sl], attack=AttackConfig())
            np.testing.assert_array_equal(tm["activation"],
                                          jm["activation"])
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5)
        _assert_params_close(tsys, jsys)


def _cnn_opt(backend, attack, scheduling="pipelined"):
    return bmoe.BMoESystem(bmoe.BMoEConfig(
        framework="optimistic", num_experts=4, num_edges=5, top_k=2,
        expert_kind="cnn", in_ch=3, lr=0.1, pow_difficulty=1,
        attack=attack, reputation=ReputationConfig(**REP),
        trust=TrustConfig(audit_rate=1.0, num_verifiers=2,
                          challenge_window=1, audit_backend=backend,
                          scheduling=scheduling)), device="cpu")


def test_cnn_optimistic_rounds(cifar):
    """CNN leaves through the optimistic framework: honest rounds are
    never challenged; a cheating executor is convicted and its round
    replayed, identically under the batched and the eager backend."""
    x, y = cifar
    honest = _cnn_opt("batched", AttackConfig())
    for r in range(3):
        honest.train_round(x[r * 32:(r + 1) * 32], y[r * 32:(r + 1) * 32])
    honest.flush_trust()
    assert all(st.phase is RoundPhase.FINALIZED and not st.proofs
               for st in honest.protocol.rounds.values())
    atk = AttackConfig(malicious_edges=(1,), attack_prob=1.0, noise_std=5.0)
    runs = []
    for backend in ("batched", "eager"):
        s = _cnn_opt(backend, atk)
        for r in range(3):
            s.train_round(x[r * 32:(r + 1) * 32], y[r * 32:(r + 1) * 32])
        s.flush_trust()
        runs.append(s)
    a, b = runs
    assert [(e.round_id, e.edge) for e in a.protocol.stakes.events] == \
        [(1, 1)]
    assert [[(p.leaf_index, p.claimed_digest, p.recomputed_digest)
             for p in st.proofs] for st in a.protocol.rounds.values()] == \
        [[(p.leaf_index, p.claimed_digest, p.recomputed_digest)
          for p in st.proofs] for st in b.protocol.rounds.values()]
    assert digest_tree(a.experts) == digest_tree(b.experts)


# ----------------------------------------------------- workload balance
def test_workload_balancer_trajectory_matches_jax(data):
    """Carried weights, ``workload_balance=True``, six clean rounds: the
    bias enters the gate logits (and ``_controls``) as in JAX, and its
    trajectory is exact while the routing agrees."""
    xtr, ytr, _, _ = data
    kw = dict(num_experts=6, num_edges=6, top_k=2, framework="traditional",
              pow_difficulty=1, workload_balance=True, balance_eta=0.5)
    jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(**kw))
    tsys = bmoe.BMoESystem(bmoe.BMoEConfig(**kw), device="cpu",
                           params=_carry(jsys))
    rng = np.random.default_rng(1)
    moved = False
    for r in range(6):
        idx = rng.integers(0, len(xtr), 64)
        np.testing.assert_array_equal(tsys._controls()[0].numpy(),
                                      np.asarray(jsys._controls()[0]))
        jm = jsys.train_round(xtr[idx], ytr[idx], attack=JAttack())
        tm = tsys.train_round(xtr[idx], ytr[idx], attack=AttackConfig())
        np.testing.assert_array_equal(tm["activation"], jm["activation"])
        np.testing.assert_array_equal(tsys.balancer.bias,
                                      jsys.balancer.bias)
        moved |= bool(tsys.balancer.bias.any())
    assert moved
    _assert_params_close(tsys, jsys)


def test_workload_balance_evens_activation(data):
    """tests/test_reputation.py:70 on the port's init: under attacked
    training the balancer pulls activation toward uniform."""
    xtr, ytr, _, _ = data
    atk = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=0.5,
                       noise_std=5.0)

    def spread(balance):
        s = bmoe.BMoESystem(bmoe.BMoEConfig(framework="traditional",
                                            attack=atk, pow_difficulty=2,
                                            workload_balance=balance),
                            device="cpu")
        rng = np.random.default_rng(0)
        for _ in range(40):
            idx = rng.integers(0, len(xtr), 128)
            s.train_round(xtr[idx], ytr[idx])
        return float(np.std(s.activation_ratio))

    assert spread(True) < spread(False)


def test_optimistic_reputation_comes_from_slashing_only(data):
    """Under ``optimistic`` the per-round agreement flags do not move
    reputation: only a confirmed fraud proof does."""
    xtr, ytr, _, _ = data
    s = bmoe.BMoESystem(_opt_cfg("sparse", workload_balance=True),
                        device="cpu")
    rep0 = s.reputation.rep.copy()
    for r in range(3):
        s.train_round(xtr[r * 48:(r + 1) * 48], ytr[r * 48:(r + 1) * 48])
    np.testing.assert_array_equal(s.reputation.rep, rep0)
    assert s.balancer.bias.any()


# ------------------------------------------------------------ contracts
def test_contract_engine_matches_jax():
    """tests/test_blockchain.py:114's use, in both packages."""
    logs = []
    for mod in (contracts, jcontracts):
        eng = mod.ContractEngine()
        hits = []
        eng.register("on_task", lambda e: e.get("type") == "task_published",
                     lambda e: hits.append(e["round"]))
        for ev in ({"type": "task_published", "round": 1},
                   {"type": "other", "round": 2},
                   {"type": "task_published", "round": 3}):
            eng.emit(ev)
        assert hits == [1, 3] and eng.contracts[0].fired == 2
        logs.append(eng.log)
    assert logs[0] == logs[1] and len(logs[0]) == 2


def test_standard_contracts_store_cids_through_the_system():
    s = bmoe.BMoESystem(bmoe.BMoEConfig(num_experts=4, num_edges=5,
                                        top_k=2), device="cpu")
    eng = contracts.ContractEngine()
    contracts.standard_bmoe_contracts(eng, s)
    assert [c.name for c in eng.contracts] == \
        [c.name for c in _jax_standard_contracts()]
    out = eng.emit({"type": "experts_updated", "round": 0,
                    "payload": b"expert bytes"})
    (name, cid), = out
    assert name == "experts_updated->store_cid"
    assert s.storage.get(cid) == b"expert bytes"
    assert eng.emit({"type": "results_uploaded", "round": 1}) == \
        [("results_uploaded->consensus",
          {"type": "results_uploaded", "round": 1})]


def _jax_standard_contracts():
    eng = jcontracts.ContractEngine()
    jcontracts.standard_bmoe_contracts(eng, None)
    return eng.contracts


def test_only_mesh_is_refused():
    """Every option constructs (``mesh="on"`` without a process group is
    one edge shard); the mesh is refused only with dense dispatch."""
    for kw in (dict(dispatch="dense"), dict(expert_kind="cnn", in_ch=3),
               dict(workload_balance=True),
               dict(framework="optimistic",
                    trust=TrustConfig(audit_backend="eager",
                                      scheduling="synchronous")),
               dict(mesh="on")):
        bmoe.BMoESystem(bmoe.BMoEConfig(num_experts=4, num_edges=5,
                                        top_k=2, **kw), device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        bmoe.BMoESystem(bmoe.BMoEConfig(mesh="on", dispatch="dense"),
                        device="cpu")
    with pytest.raises(ValueError, match="dispatch"):
        bmoe.BMoESystem(bmoe.BMoEConfig(dispatch="ragged"), device="cpu")
    with pytest.raises(ValueError, match="expert_kind"):
        bmoe.BMoESystem(bmoe.BMoEConfig(expert_kind="rnn"), device="cpu")
