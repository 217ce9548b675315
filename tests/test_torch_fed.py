"""The port's federated training (``repro_torch.fed``) against the JAX
package's ``repro.fed``, on the CPU.

- The host computations take the same numpy inputs and must give the
  same bytes: Dirichlet shards index for index; ``aggregate`` (and its
  ``AggregationInfo``), ``commit_rows``, ``aggregation_root`` and
  ``aggregation_task_digest`` for both rules, the empty set and zero
  deltas; a delta's manifest CID in either package's store; the
  federated court's verdict.
- The local step from JAX's initial parameters: loss and parameters
  within 1e-5 over 3 steps, the delta exactly zero off the owned
  experts.
- Coordinators carried across from JAX's initial parameters: every
  round's decisions equal (participants, received, stragglers,
  dropouts, rejected, executor, quorum, audits, convictions), the
  phases and counters equal, global parameters within 1e-5.  Each
  case first checks that no cosine the JAX run screened lies within
  1e-4 of ``cos_min``, so float rounding cannot flip a decision.
- The claims of ``tests/test_fed.py`` on the port's own init, and the
  local update's purity (the global state and the round's snapshot are
  never written)."""
import jax
import numpy as np
import pytest
import torch

import repro.fed as jfed
import repro.fed.coordinator as jcoord
from repro.core import experts as jex
from repro.data import synthetic as jsyn
from repro.models.builder import materialize as jmaterialize
from repro.storage import ExpertStore as JStore
from repro.storage import StorageNetwork as JNetwork
from repro.train.step import make_fed_local_step as jlocal_step
from repro.trust import protocol as jproto
from repro_torch import fed
from repro_torch.convert import params_from_numpy
from repro_torch.core import experts as ex
from repro_torch.core.ledger import digest_tree
from repro_torch.data import synthetic as syn
from repro_torch.storage import ExpertStore, StorageNetwork
from repro_torch.train.step import make_fed_local_step
from repro_torch.trust import protocol
from repro_torch.trust.protocol import RoundPhase, TrustConfig

TRUST = dict(chunks_per_expert=4, audit_rate=1.0, challenge_window=2)
SMALL = dict(num_edges=6, num_experts=6, hidden=16, local_steps=3,
             local_batch=32, seed=0)


@pytest.fixture(scope="module")
def data():
    return syn.make_image_dataset(syn.FMNIST, n_train=1500, n_test=400,
                                  seed=0)


def _cfg(**kw):
    return fed.FedConfig(**{**SMALL, "trust": TrustConfig(**TRUST), **kw})


def _cfgs(attack=None, **kw):
    """The same configuration in both packages (each its own
    TrustConfig and FedAttack)."""
    base = {**SMALL, **kw}
    atk = attack or {}
    return (jfed.FedConfig(**base, trust=jproto.TrustConfig(**TRUST),
                           attack=jfed.FedAttack(**atk)),
            fed.FedConfig(**base, trust=TrustConfig(**TRUST),
                          attack=fed.FedAttack(**atk)))


def _run(cfg, data, rounds=4):
    x, y, _, _ = data
    co = fed.FedCoordinator(cfg, x, y, device="cpu")
    for _ in range(rounds):
        co.run_round()
    co.flush_trust()
    return co


def _params_equal(a, b):
    return np.array_equal(fed.tree_to_flat(a), fed.tree_to_flat(b))


def _tree(rng, scale=1.0, n=3, d=8, h=4, c=3):
    """A tiny {gate, experts} tree of the federated model's layout."""
    def g(*s):
        return (scale * rng.normal(size=s)).astype(np.float32)
    return {"gate": {"w": g(d, n), "b": g(n)},
            "experts": {"w1": g(n, d, h), "b1": g(n, h), "w2": g(n, h, c),
                        "b2": g(n, c)}}


def _jax_tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


# ------------------------------------------------------------ shards
@pytest.mark.parametrize("seed,alpha,shards,n", [
    (0, 0.5, 10, 10_000), (3, 0.1, 6, 1500), (7, 5.0, 4, 400),
    (1, 0.3, 40, 60)])
def test_dirichlet_shards_match_jax_index_for_index(seed, alpha, shards, n):
    labels = np.random.default_rng(seed).integers(0, 10, n).astype(np.int32)
    got = syn.dirichlet_shards(labels, shards, alpha=alpha, seed=seed)
    want = jsyn.dirichlet_shards(labels, shards, alpha=alpha, seed=seed)
    assert len(got) == len(want) == shards
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(np.sort(np.concatenate(got)), np.arange(n))


# ------------------------------------------------- aggregation bytes
def _deltas(case, rng):
    if case == "empty":
        return [], []
    if case == "zeros":
        d = _tree(rng, 0.0)
        return [d, d, _tree(rng, 0.5)], [3, 4, 5]
    if case == "poisoned":        # honest ones agree; one scaled, one flipped
        common = _tree(rng, 0.1)
        ds = [jax.tree_util.tree_map(lambda a, b: a + b, common,
                                     _tree(rng, 0.02)) for _ in range(5)]
        ds[1] = jax.tree_util.tree_map(lambda a: 200.0 * a, ds[1])
        ds[3] = jax.tree_util.tree_map(lambda a: -5.0 * a, ds[3])
        return ds, [10, 20, 30, 40, 50]
    ds = [_tree(rng, float(rng.uniform(0.1, 2.0))) for _ in range(4)]
    return ds, [int(rng.integers(1, 500)) for _ in range(4)]


@pytest.mark.parametrize("case", ["random", "empty", "zeros", "poisoned"])
@pytest.mark.parametrize("rule", ["fedavg", "defended"])
def test_aggregation_commitment_and_digests_match_jax_bytewise(case, rule):
    rng = np.random.default_rng(11)
    base = _tree(rng)
    deltas, weights = _deltas(case, rng)
    got, info = fed.aggregate(base, deltas, weights, rule=rule)
    want, jinfo = jfed.aggregate(base, deltas, weights, rule=rule)
    assert fed.tree_to_flat(got).tobytes() == \
        jfed.tree_to_flat(want).tobytes()
    assert info.__dict__ == jinfo.__dict__
    if case == "poisoned" and rule == "defended":
        assert info.rejected == [3]            # the flipped one
        assert info.clip[1] < 0.1              # the scaled one, clipped
    rows = fed.commit_rows(got, 3)
    assert rows.tobytes() == jfed.commit_rows(want, 3).tobytes()
    assert rows.shape == (4, 8 * 4 + 4 + 4 * 3 + 3)
    cids = [f"cid{i}" for i in range(len(deltas))]
    parts = list(range(len(deltas)))
    assert fed.aggregation_root(parts, cids, "root") == \
        jfed.aggregation_root(parts, cids, "root")
    args = (5, parts, cids, rule, 3.0, 0.0, digest_tree(base))
    assert fed.aggregation_task_digest(*args) == \
        jfed.aggregation_task_digest(*args)
    # the round trip through the flat view keeps every byte
    assert fed.tree_to_flat(fed.flat_to_tree(fed.tree_to_flat(base),
                                             base)).tobytes() == \
        fed.tree_to_flat(base).tobytes()


def test_tree_to_flat_takes_tensors_in_jax_leaf_order():
    tree = _tree(np.random.default_rng(2))
    tensors = {p: {k: torch.from_numpy(v) for k, v in sub.items()}
               for p, sub in tree.items()}
    assert fed.tree_to_flat(tensors).tobytes() == \
        jfed.tree_to_flat(tree).tobytes()
    with pytest.raises(ValueError):
        fed.flat_to_tree(np.zeros(3, np.float32), tree)


def test_a_published_delta_has_the_same_manifest_cid_in_both_stores():
    """The round's arrival times come from ``manifest.total_bytes``, and
    the commitment names manifest CIDs: a delta tree must chunk alike."""
    delta = _tree(np.random.default_rng(4), 0.3, n=6, d=784, h=16, c=10)
    delta["experts"]["w1"][2:] = 0.0           # masked off owned experts
    got = ExpertStore(StorageNetwork(seed=0), chunk_bytes=1 << 14) \
        .put_version("fed/delta/3", delta, 2)
    want = JStore(JNetwork(seed=0), chunk_bytes=1 << 14) \
        .put_version("fed/delta/3", _jax_tree(delta), 2)
    assert got.manifest_cid == want.manifest_cid
    assert got.total_bytes == want.total_bytes
    assert got.chunk_cids == want.chunk_cids


# ----------------------------------------------------------- the court
@pytest.mark.parametrize("tamper", [False, True])
def test_resolve_by_recompute_matches_jax(tamper):
    rng = np.random.default_rng(8)
    honest = rng.standard_normal((5, 40)).astype(np.float32)
    claimed = honest.copy()
    if tamper:
        claimed[2, 11] += 1e-3
    cfg = dict(chunks_per_expert=4, challenge_window=2, audit_rate=1.0)

    def recompute(e, sl):
        return honest[e, sl]

    out = []
    for proto, tc in ((protocol.OptimisticProtocol, TrustConfig),
                      (jproto.OptimisticProtocol, jproto.TrustConfig)):
        kw = {"device": "cpu"} if proto is protocol.OptimisticProtocol \
            else {}
        p = proto(tc(**cfg), 4, chained=True, **kw)
        p.commit(0, 1, claimed)
        p.commit(1, 2, honest)
        p.apply_reports(0, p.verifiers.audit(p.rounds[0].commitment,
                                             recompute), recompute)
        assert p.rounds[0].phase.name == ("CHALLENGED" if tamper
                                          else "ACCEPTED")
        state = p.resolve_by_recompute(0, recompute)
        out.append((state.phase.name, state.verdict.executor_guilty,
                    state.verdict.trusted, state.verdict.flags,
                    state.verdict.support, list(p.stakes.stake),
                    [(r.round_id, r.invalidated) for r in p.rollbacks],
                    p.rounds[1].phase.name, dict(p.stats)))
    (got, want) = out
    assert got[0] == want[0] == ("ROLLED_BACK" if tamper else "ACCEPTED")
    assert got[1] == want[1] == tamper
    assert np.array_equal(got[2], want[2])
    assert np.array_equal(got[2], honest)
    assert np.array_equal(got[3], want[3])
    assert np.array_equal(got[4], want[4])
    assert got[5:] == want[5:]


# ------------------------------------------------------- the local step
def test_local_step_matches_jax_and_masks_unowned_experts():
    n, k, d, h, c = 6, 2, 784, 16, 10
    jexperts, japply = jex.make_expert_bank(
        "mlp", n, jax.random.PRNGKey(2), in_dim=d, hidden=h, out=c)
    params = {"gate": jmaterialize(jex.gate_decl(d, n),
                                   jax.random.PRNGKey(1)),
              "experts": jexperts}
    jstep = jlocal_step(n, k, 0.2, japply)
    step = make_fed_local_step(n, k, 0.2, ex.apply_all_fn("mlp"))
    p0 = _jax_tree(params)
    tp = params_from_numpy(p0["gate"], p0["experts"], device="cpu")
    owned = np.zeros(n, np.float32)
    owned[[1, 4]] = 1.0
    x, y, _, _ = syn.make_image_dataset(syn.FMNIST, n_train=96, n_test=1,
                                        seed=3)
    x = x.reshape(len(x), -1)
    jp = params
    for s in range(3):
        xb, yb = x[32 * s:32 * (s + 1)], y[32 * s:32 * (s + 1)]
        jp, jloss = jstep(jp, xb, yb, owned)
        tp, loss = step(tp, torch.from_numpy(xb),
                        torch.from_numpy(yb.astype(np.int64)),
                        torch.from_numpy(owned))
        assert loss.dim() == 0 and not loss.requires_grad
        assert abs(float(loss) - float(jloss)) < 1e-5
    np.testing.assert_allclose(fed.tree_to_flat(tp), fed.tree_to_flat(jp),
                               rtol=1e-5, atol=1e-5)
    for key in ("w1", "b1", "w2", "b2"):
        delta = tp["experts"][key] - torch.from_numpy(p0["experts"][key])
        off = torch.from_numpy(owned == 0)
        assert torch.count_nonzero(delta[off]) == 0
        assert torch.count_nonzero(delta[~off]) > 0
    assert not torch.equal(tp["gate"]["w"],
                           torch.from_numpy(p0["gate"]["w"]))


def test_local_update_writes_neither_the_global_state_nor_the_snapshot(data):
    co = fed.FedCoordinator(_cfg(), data[0], data[1], device="cpu")
    co.run_round()
    base = co._round_ctx[0]["base"]
    before = (fed.tree_to_flat(co.global_params).copy(),
              fed.tree_to_flat(base).copy(),
              fed.tree_to_flat(co.device_params()).copy())
    delta, loss = co.edges[2].local_update(co.device_params(), 1)
    delta2, _ = co.edges[2].local_update(co.global_params, 1)
    assert np.isfinite(loss) and np.abs(fed.tree_to_flat(delta)).max() > 0
    assert _params_equal(delta, delta2)
    for got, want in zip((co.global_params, base, co.device_params()),
                         before):
        assert np.array_equal(fed.tree_to_flat(got), want)
    # and a full round: the snapshot it restores from stays what it was
    snap = fed.tree_to_flat(co.global_params).copy()
    co.run_round()
    assert np.array_equal(fed.tree_to_flat(co._round_ctx[1]["base"]), snap)


def test_coordinator_takes_a_device_and_the_ports_init(data):
    if not torch.cuda.is_available():          # the default is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            fed.FedCoordinator(_cfg(), data[0], data[1])
    a = fed.FedCoordinator(_cfg(), data[0], data[1], device="cpu")
    b = fed.FedCoordinator(_cfg(), data[0], data[1], device="cpu")
    assert _params_equal(a.global_params, b.global_params)
    assert a.global_params["experts"]["w1"].shape == (6, 784, 16)
    assert a.global_params["gate"]["w"].dtype == np.float32
    decl = ex.gate_decl(784, 6)
    jdecl = jex.gate_decl(784, 6)
    assert {k: (v.shape, v.init, v.scale) for k, v in decl.items()} == \
        {k: (v.shape, v.init, v.scale) for k, v in jdecl.items()}
    decl, jdecl = ex.mlp_expert_decl(784, 16, 10), jex.mlp_expert_decl(
        784, 16, 10)
    assert {k: (v.shape, v.init, v.scale) for k, v in decl.items()} == \
        {k: (v.shape, v.init, v.scale) for k, v in jdecl.items()}


# ------------------------------------------ coordinators across packages
def _cosine_margin(calls, cos_min=0.0):
    """Smallest |cos - cos_min| over every delta the recorded defended
    aggregations screened (the JAX rule's own arithmetic)."""
    margin = np.inf
    for deltas in calls:
        flats = np.stack([jfed.tree_to_flat(d) for d in deltas]) \
            .astype(np.float64)
        norms = np.linalg.norm(flats, axis=1)
        med = float(np.median(norms))
        clip = (np.minimum(1.0, 3.0 * med / np.maximum(norms, 1e-12))
                if med > 0 else np.ones(len(flats)))
        clipped = flats * clip[:, None]
        mu = np.median(clipped, axis=0)
        for row in clipped:
            den = np.linalg.norm(row) * np.linalg.norm(mu)
            if den > 0:
                margin = min(margin, abs(row @ mu / den - cos_min))
    return margin


@pytest.mark.parametrize("kw", [
    dict(straggler_prob=0.2, dropout_prob=0.1, seed=5),
    dict(attack=dict(malicious_edges=(2,), update_attack="sign_flip",
                     scale=5.0)),
    dict(attack=dict(malicious_edges=(1,), dishonest_aggregator=True)),
    dict(slow_edges=(0,), evict_after=2, min_quorum=6,
         attack=dict(malicious_edges=(1, 2), update_attack="sign_flip",
                     scale=5.0, dishonest_aggregator=True,
                     aggregator_mode="unscreened"))],
    ids=["faults", "sign_flip", "substitute", "colluding_evict_quorum"])
def test_coordinator_rounds_match_jax(data, monkeypatch, kw):
    """4 rounds and the flush from JAX's initial parameters."""
    x, y, xt, yt = data
    jcfg, cfg = _cfgs(**kw)
    screened = []
    real = jcoord.aggregate

    def recording(base, deltas, weights, **k):
        if k.get("rule", "defended") == "defended" and deltas:
            screened.append(deltas)
        return real(base, deltas, weights, **k)

    monkeypatch.setattr(jcoord, "aggregate", recording)
    jco = jfed.FedCoordinator(jcfg, x, y)
    p0 = _jax_tree(jco.global_params)
    co = fed.FedCoordinator(cfg, x, y, device="cpu",
                            params=params_from_numpy(p0["gate"],
                                                     p0["experts"],
                                                     device="cpu"))
    keys = ("round", "participants", "received", "stragglers", "dropouts",
            "evicted", "quorum", "rejected", "executor", "trust")
    for _ in range(4):
        want, got = jco.run_round(), co.run_round()
        assert {k: got.get(k) for k in keys} == \
            {k: want.get(k) for k in keys}
    assert co.flush_trust() == jco.flush_trust()
    assert _cosine_margin(screened) > 1e-4
    assert co.obs_report()["fed"] == jco.obs_report()["fed"]
    assert co.obs_report()["trust"] == jco.obs_report()["trust"]
    assert [(r, s.phase.name) for r, s in co.protocol.rounds.items()] == \
        [(r, s.phase.name) for r, s in jco.protocol.rounds.items()]
    assert [b.payload.get("kind") for b in co.ledger.blocks] == \
        [b.payload.get("kind") for b in jco.ledger.blocks]
    np.testing.assert_allclose(fed.tree_to_flat(co.global_params),
                               jfed.tree_to_flat(jco.global_params),
                               rtol=1e-5, atol=1e-5)
    assert abs(co.evaluate(xt, yt) - jco.evaluate(xt, yt)) <= 1 / len(yt)


# ---------------------- the claims of tests/test_fed.py, on the port's init
def test_clean_rounds_commit_audit_finalize(data):
    co = _run(_cfg(), data, rounds=4)
    p = co.protocol
    assert all(p.rounds[r].phase is RoundPhase.FINALIZED for r in range(4))
    assert p.stats["fraud_proofs"] == 0
    assert co.evaluate(data[2], data[3]) > 0.6
    aggs = co.ledger.aggregations()
    assert len(aggs) == 4
    assert all(b.payload["agg_root"] for b in aggs)
    assert co.ledger.verify_chain()


def test_fed_counters_visible_in_obs_report(data):
    co = _run(_cfg(straggler_prob=0.2, dropout_prob=0.1, seed=3),
              data, rounds=5)
    rep = co.obs_report()
    for key in ("stragglers", "dropouts", "retries", "evictions",
                "quorum_failures", "rejected_updates"):
        assert key in rep["fed"]
        assert f"fed.{key}" in rep["metrics"]
    assert rep["fed"]["rounds"] == 5
    assert rep["chain"]["valid"]
    assert "fed.round_s" in rep["metrics"] and \
        "fed.train_s" in rep["metrics"]


def test_delta_uploads_dedup_across_edges(data):
    co = _run(_cfg(), data, rounds=2)
    assert co.store.stats["chunks_deduped"] > 0


def test_defended_rule_survives_gradient_scaling(data):
    atk = fed.FedAttack(malicious_edges=(2,), update_attack="grad_scale",
                        scale=200.0)
    clean = _run(_cfg(verify="off"), data)
    undef = _run(_cfg(verify="off", rule="fedavg", attack=atk), data)
    defended = _run(_cfg(verify="off", attack=atk), data)
    x, y = data[2], data[3]
    acc_clean, acc_undef = clean.evaluate(x, y), undef.evaluate(x, y)
    acc_def = defended.evaluate(x, y)
    assert acc_def >= 0.9 * acc_clean
    assert acc_undef < acc_def


def test_sign_flip_is_screened_by_cosine_test(data):
    atk = fed.FedAttack(malicious_edges=(2,), update_attack="sign_flip",
                        scale=5.0)
    defended = _run(_cfg(verify="off", attack=atk), data)
    undef = _run(_cfg(verify="off", rule="fedavg", attack=atk), data)
    assert defended.obs_report()["fed"]["rejected_updates"] > 0
    x, y = data[2], data[3]
    assert defended.evaluate(x, y) > undef.evaluate(x, y)


def test_dishonest_aggregator_convicted_and_rolled_back(data):
    atk = fed.FedAttack(malicious_edges=(1,), dishonest_aggregator=True)
    clean = _run(_cfg(), data, rounds=5)
    bad = _run(_cfg(attack=atk), data, rounds=5)
    rep = bad.obs_report()
    assert rep["fed"]["convictions"] >= 1
    assert rep["trust"]["rolled_back"] >= 1
    rbs = bad.ledger.rollbacks()
    assert len(rbs) >= 1
    assert rbs[0].payload["domain"] == "fed"
    assert 1 in rbs[0].payload["slashed"]
    assert bad.ledger.slashes()
    assert bad.protocol.stakes.stake[1] < bad.protocol.stakes.stake[0]
    assert rep["fed"]["replayed_rounds"] >= 1
    assert _params_equal(clean.global_params, bad.global_params)


def test_colluding_aggregator_skipping_screen_is_convicted(data):
    atk = fed.FedAttack(malicious_edges=(1, 2), update_attack="sign_flip",
                        scale=5.0, dishonest_aggregator=True,
                        aggregator_mode="unscreened")
    bad = _run(_cfg(attack=atk), data, rounds=5)
    rep = bad.obs_report()
    assert rep["fed"]["convictions"] >= 1
    assert len(bad.ledger.rollbacks()) >= 1


def test_straggler_carry_then_evict_never_stalls(data):
    co = _run(_cfg(slow_edges=(0,), evict_after=2, verify="off"), data,
              rounds=4)
    rep = co.obs_report()
    assert rep["fed"]["rounds"] == 4
    assert rep["fed"]["stragglers"] >= 2
    assert rep["fed"]["carried_deltas"] >= 1
    assert rep["fed"]["evictions"] == 1
    assert 0 in co._evicted
    landed = [b for b in co.ledger.aggregations()
              if 0 in b.payload["received"]]
    assert landed


def test_quorum_failure_is_a_committed_noop(data):
    cfg = _cfg(slow_edges=tuple(range(6)), evict_after=100, verify="off")
    co = fed.FedCoordinator(cfg, data[0], data[1], device="cpu")
    before = fed.tree_to_flat(co.global_params).copy()
    s = co.run_round()
    assert not s["quorum"]
    assert np.array_equal(before, fed.tree_to_flat(co.global_params))
    blocks = co.ledger.aggregations()
    assert len(blocks) == 1 and blocks[0].payload["quorum"] is False
    assert co.obs_report()["fed"]["quorum_failures"] == 1
    assert co.round == 1


def test_rounds_complete_under_combined_faults(data):
    co = _run(_cfg(straggler_prob=0.2, dropout_prob=0.1, seed=5), data,
              rounds=6)
    rep = co.obs_report()
    assert rep["fed"]["rounds"] == 6
    assert rep["fed"]["stragglers"] > 0
    assert rep["fed"]["dropouts"] > 0
    assert co.ledger.verify_chain()


def test_two_seeded_runs_bit_identical(data):
    cfg = _cfg(straggler_prob=0.2, dropout_prob=0.1, seed=11)
    a = _run(cfg, data, rounds=3)
    b = _run(cfg, data, rounds=3)
    assert _params_equal(a.global_params, b.global_params)
    ra = [blk.payload.get("agg_root") for blk in a.ledger.aggregations()]
    rb = [blk.payload.get("agg_root") for blk in b.ledger.aggregations()]
    assert ra == rb
    assert a.obs_report()["fed"] == b.obs_report()["fed"]
