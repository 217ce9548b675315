"""Property tests for the port's federated subsystem (hypothesis), the
mirror of ``tests/test_fed_properties.py`` on ``repro_torch.fed`` (on
the CPU), plus the aggregation held to the JAX package's byte for byte
over any received subset.

- The aggregation rule conserves parameter mass: over ANY received
  subset of edges, the mixing coefficients are a convex combination
  (sum to 1 over the accepted set), so the aggregated delta never
  leaves the convex hull of the accepted clipped deltas; and the two
  packages compute the same bytes and decisions.
- The round clock never deadlocks: whatever straggler/dropout/eviction
  draw the adversary gets, N run_round() calls advance the clock N
  times.
- Honest runs are bit-deterministic: identically-seeded coordinators
  produce identical aggregation roots and identical global parameters.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.fed as jfed
from repro_torch.data.synthetic import FMNIST, make_image_dataset
from repro_torch.fed import FedConfig, FedCoordinator, aggregate, tree_to_flat


def _delta(rng, scale=1.0):
    return {"w": (scale * rng.normal(size=(6, 4))).astype(np.float32),
            "b": (scale * rng.normal(size=(4,))).astype(np.float32)}


BASE = {"w": np.zeros((6, 4), np.float32), "b": np.zeros(4, np.float32)}


def _draw(seed, m, scale):
    rng = np.random.default_rng(seed)
    deltas = [_delta(rng, scale=float(rng.uniform(0.1, scale)))
              for _ in range(m)]
    weights = [int(rng.integers(1, 500)) for _ in range(m)]
    return deltas, weights


# ------------------------------------------------ conservation of mass
@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2 ** 31 - 1),
       st.integers(1, 8),
       st.sampled_from(["fedavg", "defended"]),
       st.floats(0.2, 50.0))
def test_aggregation_is_convex_over_any_received_subset(seed, m, rule,
                                                        scale):
    """Whatever subset arrives (any size, any scales), the coefficients
    returned sum to 1 over the accepted set and the aggregated delta is
    inside the convex hull of the accepted clipped deltas."""
    deltas, weights = _draw(seed, m, scale)
    new, info = aggregate(BASE, deltas, weights, rule=rule)
    if info.accepted:
        assert sum(info.coeffs) == pytest.approx(1.0, abs=1e-9)
        assert all(c >= 0 for c in info.coeffs)
        agg = tree_to_flat(new).astype(np.float64)
        clipped_norms = [info.norms[i] * info.clip[i]
                         for i in info.accepted]
        assert np.linalg.norm(agg) <= max(clipped_norms) + 1e-6
    else:
        np.testing.assert_array_equal(tree_to_flat(new),
                                      tree_to_flat(BASE))
    assert set(info.accepted) | set(info.rejected) == set(range(m))
    assert not set(info.accepted) & set(info.rejected)


@settings(max_examples=40, deadline=None)
@given(st.integers(0, 2 ** 31 - 1),
       st.integers(0, 8),
       st.sampled_from(["fedavg", "defended"]),
       st.floats(0.2, 50.0),
       st.sampled_from([0.0, 0.3]))
def test_aggregation_is_the_jax_packages_over_any_received_subset(
        seed, m, rule, scale, cos_min):
    """The committed computation across packages: for any received
    subset (the empty one included) the same result bytes and the same
    decisions, and the mixing weights a convex combination in both."""
    deltas, weights = _draw(seed, m, scale)
    new, info = aggregate(BASE, deltas, weights, rule=rule,
                          cos_min=cos_min)
    jnew, jinfo = jfed.aggregate(BASE, deltas, weights, rule=rule,
                                 cos_min=cos_min)
    assert tree_to_flat(new).tobytes() == jfed.tree_to_flat(jnew).tobytes()
    assert info.__dict__ == jinfo.__dict__
    if info.accepted:
        assert sum(info.coeffs) == pytest.approx(1.0, abs=1e-9)
        assert min(info.coeffs) >= 0


@settings(max_examples=20, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.integers(1, 6))
def test_identical_deltas_aggregate_to_exactly_one_delta(seed, m):
    """m copies of the same delta must average back to that delta —
    the mass-conservation fixed point (no inflation with quorum size)."""
    rng = np.random.default_rng(seed)
    d = _delta(rng)
    new, info = aggregate(BASE, [d] * m, [7] * m, rule="defended")
    assert info.accepted == list(range(m))
    np.testing.assert_allclose(tree_to_flat(new), tree_to_flat(d),
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------- round clock safety
@pytest.fixture(scope="module")
def tiny_data():
    return make_image_dataset(FMNIST, n_train=400, n_test=100, seed=0)


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 50),
       st.floats(0.0, 0.9),
       st.floats(0.0, 0.6),
       st.integers(1, 3),
       st.integers(1, 4))
def test_round_clock_never_deadlocks(tiny_data, seed, straggler_prob,
                                     dropout_prob, evict_after,
                                     min_quorum):
    """N run_round() calls advance the clock N times under any
    straggler/dropout/eviction draw — late or missing edges can make a
    round a no-op, never a stall."""
    x, y, *_ = tiny_data
    cfg = FedConfig(num_edges=4, num_experts=4, hidden=8, local_steps=1,
                    local_batch=16, seed=seed, verify="off",
                    straggler_prob=straggler_prob,
                    dropout_prob=dropout_prob, evict_after=evict_after,
                    min_quorum=min_quorum)
    co = FedCoordinator(cfg, x, y, device="cpu")
    for expect in range(1, 4):
        co.run_round()
        assert co.round == expect
    rep = co.obs_report()
    assert rep["fed"]["rounds"] == 3
    assert len(co.ledger.aggregations()) == 3   # one block per round,
    assert co.ledger.verify_chain()             # quorum no-ops included


# ------------------------------------------------------- bit determinism
@settings(max_examples=3, deadline=None)
@given(st.integers(0, 20))
def test_honest_runs_bit_identical_across_seeds(tiny_data, seed):
    """Two identically-seeded honest runs: identical aggregation roots
    on-chain, identical finalization verdicts, identical parameters."""
    x, y, *_ = tiny_data

    def run():
        cfg = FedConfig(num_edges=4, num_experts=4, hidden=8,
                        local_steps=1, local_batch=16, seed=seed)
        co = FedCoordinator(cfg, x, y, device="cpu")
        for _ in range(3):
            co.run_round()
        co.flush_trust()
        roots = [b.payload["agg_root"] for b in co.ledger.aggregations()]
        phases = [co.protocol.rounds[r].phase.name for r in range(3)]
        flat = tree_to_flat(co.global_params)
        return roots, phases, flat

    ra, pa, fa = run()
    rb, pb, fb = run()
    assert ra == rb
    assert pa == pb == ["FINALIZED"] * 3
    np.testing.assert_array_equal(fa, fb)
