"""The port's optimistic training (``train_round`` under ``optimistic``)
against the JAX package, on the CPU, then its bitwise claims inside the
port.

Each parity case carries a JAX system's weights into the port with
``params_from_numpy`` and trains both on the same numpy tasks.  Wire
formats that hash computed bytes (commitment roots, chunk and DA CIDs,
bank roots) are not compared across packages: after one SGD step the
banks differ by float rounding.  Decisions are: executors, phases, audit
reports, fraud proofs, stake events, rollback blocks, DA challenges and
faults as (round, object, chunk index, node, kind), ``stats``,
``verification_report()`` and ``flush_trust()``; parameters at 1e-5.
A cheating executor's poisoned update uses each package's own noise, so
only rounds that end honest (never attacked, or replayed) are compared
by loss and parameters.

Inside the port: the chained replay equals a clean twin bit for bit,
pipelined equals synchronous and batched equals eager by
``digest_tree``, and the spans keep the JAX package's algebra."""
import jax
import numpy as np
import pytest
import torch

from repro.core import bmoe as jbmoe
from repro.core.attacks import AttackConfig as JAttack
from repro.core.reputation import ReputationConfig as JRepCfg
from repro.trust import audit as jaudit
from repro.trust import protocol as jproto
from repro_torch.convert import params_from_numpy
from repro_torch.core import bmoe
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.ledger import digest_tree
from repro_torch.core.reputation import ReputationConfig
from repro_torch.data.synthetic import FMNIST, make_image_dataset
from repro_torch.kernels import ops
from repro_torch.obs import Observability
from repro_torch.trust import audit, protocol
from repro_torch.trust.commitments import leaf_digest
from repro_torch.trust.protocol import RoundPhase, TrustConfig

REP = dict(init=0.5, gain=0.01, slash=0.4, exclusion_threshold=0.2)


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
    xtr, ytr, xte, yte = make_image_dataset(FMNIST, n_train=1500,
                                            n_test=300, seed=0)
    return xtr.reshape(len(xtr), -1), ytr, xte.reshape(len(xte), -1), yte


# --------------------------------------------------- parity with JAX
CASES = {
    # executor 0 cheats in round 0; synchronous scheduling settles the
    # audit inside the round, so the conviction and the replay land there
    "caught_same_round": (
        dict(malicious_edges=(0,), attack_prob=1.0, noise_std=5.0),
        dict(audit_rate=1.0, num_verifiers=1, challenge_window=2,
             scheduling="synchronous"), {}, 4),
    # tests/test_pipeline.py:38 at N=M=6: round 2's fraud drains at round
    # 3, after round 3 committed on it; the chain [2, 3] is replayed
    "late_fraud_chain": (
        dict(malicious_edges=(2,), attack_prob=1.0, noise_std=5.0),
        dict(audit_rate=1.0, num_verifiers=1, challenge_window=3), {}, 4),
    "batched_pipelined": (
        dict(malicious_edges=(3, 4), attack_prob=1.0, noise_std=5.0),
        dict(audit_rate=0.3, challenge_window=2), {}, 6),
    "eager_pipelined": (
        dict(malicious_edges=(3, 4), attack_prob=1.0, noise_std=5.0),
        dict(audit_rate=0.3, challenge_window=2, audit_backend="eager"),
        {}, 6),
    "batched_synchronous": (
        dict(malicious_edges=(3,), attack_prob=1.0, noise_std=5.0),
        dict(audit_rate=0.5, challenge_window=2, scheduling="synchronous"),
        {}, 6),
    "eager_synchronous": (
        dict(malicious_edges=(3,), attack_prob=1.0, noise_std=5.0),
        dict(audit_rate=0.5, challenge_window=2, scheduling="synchronous",
             audit_backend="eager"), {}, 6),
    # tests/test_storage_faults.py:114: a replica withholds a genesis
    # chunk; the training rounds' DA beats challenge it
    "da_withheld_chunk": (
        dict(), dict(audit_rate=0.1, challenge_window=2), dict(da_rate=1.0),
        4),
    "dense_dispatch": (
        dict(malicious_edges=(2,), attack_prob=1.0, noise_std=5.0),
        dict(audit_rate=1.0, num_verifiers=2, challenge_window=2),
        dict(dispatch="dense"), 5),
    "workload_balance": (
        dict(malicious_edges=(1,), attack_prob=1.0, noise_std=5.0),
        dict(audit_rate=0.5, challenge_window=2),
        dict(workload_balance=True), 5),
}


def _pair(atk_kw, tc_kw, cfg_kw, N=6, M=6, K=2):
    common = dict(num_experts=N, num_edges=M, top_k=K,
                  framework="optimistic", pow_difficulty=2, **cfg_kw)
    jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(
        **common, attack=JAttack(**atk_kw), reputation=JRepCfg(**REP),
        trust=jproto.TrustConfig(**tc_kw)))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.gate),
                          jax.tree_util.tree_map(np.asarray, jsys.experts),
                          device="cpu")
    tsys = bmoe.BMoESystem(bmoe.BMoEConfig(
        **common, attack=AttackConfig(**atk_kw),
        reputation=ReputationConfig(**REP),
        trust=protocol.TrustConfig(**tc_kw)), device="cpu", params=p)
    return jsys, tsys


def _withhold_genesis_chunk(s):
    cid = s.expert_store.manifest("expert/0", 0).chunk_cids[0]
    node = s.storage.replicas(cid)[0]
    s.storage.withhold(cid, node)
    return node


def _decisions(s):
    """Everything the protocol decided, with no hash of computed bytes."""
    P = s.protocol
    rounds = {r: (st.executor, st.phase.value,
                  [(p.leaf_index, p.expert, p.verifier) for p in st.proofs],
                  [(x.verifier, x.sampled_leaves, x.lazy,
                    x.recomputed_leaves) for x in st.reports])
              for r, st in P.rounds.items()}
    da = (None if s.da is None else
          ([(f.round_id, f.object_id, f.chunk_index, f.executor, f.kind)
            for f in s.da.faults],
           [(c.round_id, c.object_id, c.chunk_index, c.node_id, c.status)
            for c in s.da.challenges], dict(s.da.stats)))
    blocks = [{k: v for k, v in b.payload.items()
               if k not in ("commit_root", "routing", "bank_root", "loss",
                            "cid")} for b in s.ledger.blocks[1:]]
    return {"rounds": rounds,
            "stakes": [(e.round_id, e.edge, e.amount, e.verifier)
                       for e in P.stakes.events],
            "rollbacks": [(r.round_id, r.executor, r.invalidated)
                          for r in P.rollbacks],
            "stats": dict(P.stats), "verifiers": dict(P.verifiers.stats),
            "verification": s.verification_report(), "da": da,
            "blocks": blocks, "rep": s.reputation.rep.tolist(),
            "excluded": s.reputation.excluded.tolist()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimistic_training_matches_jax(data, case):
    atk_kw, tc_kw, cfg_kw, rounds = CASES[case]
    xtr, ytr, _, _ = data
    jsys, tsys = _pair(atk_kw, tc_kw, cfg_kw)
    if case == "da_withheld_chunk":
        nodes = {_withhold_genesis_chunk(s) for s in (jsys, tsys)}
        assert len(nodes) == 1
    ops.reset_launch_counts()
    rng = np.random.default_rng(0)
    metrics = []
    for r in range(rounds):
        idx = rng.integers(0, len(xtr), 48)
        jm = jsys.train_round(xtr[idx], ytr[idx])
        tm = tsys.train_round(xtr[idx], ytr[idx])
        np.testing.assert_array_equal(tm["rolled_back"], jm["rolled_back"])
        metrics.append((tm, jm))
        assert tsys.protocol.audit_backlog() == jsys.protocol.audit_backlog()
    assert tsys.flush_trust() == jsys.flush_trust()
    # a round's returned metrics are honest in both packages unless it was
    # built on (or is) a poisoned update that a later replay voided
    for r, (tm, jm) in enumerate(metrics):
        if tm["rolled_back"] or tsys.protocol.rounds[r].phase not in (
                RoundPhase.ROLLED_BACK, RoundPhase.INVALIDATED):
            np.testing.assert_array_equal(tm["activation"], jm["activation"],
                                          err_msg=r)
            np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=1e-5,
                                       err_msg=r)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    dt, dj = _decisions(tsys), _decisions(jsys)
    for k in dj:
        assert dt[k] == dj[k], k
    if case in ("caught_same_round", "late_fraud_chain"):
        # every cheat was rolled back and replayed: the banks agree again
        for mine, theirs in ((tsys.gate, jsys.gate),
                             (tsys.experts, jsys.experts)):
            for k in mine:
                np.testing.assert_allclose(mine[k].numpy(),
                                           np.asarray(theirs[k]), rtol=1e-5,
                                           atol=1e-5, err_msg=k)
    if case == "late_fraud_chain":
        assert dt["rollbacks"] == [(2, 2, [3])]
        assert tsys.ledger.rollbacks()[0].payload["chain"] == [2, 3]
    if case == "caught_same_round":
        assert dt["rollbacks"] == [(0, 0, [])]
    if case == "da_withheld_chunk":
        (node,) = nodes
        faults = [f for f in tsys.da.faults if f.kind == "withheld"]
        assert faults and all(f.executor == node for f in faults)
        blocks = tsys.ledger.find_all(kind="da_slash")
        assert len(blocks) == 1 and blocks[0].payload["node"] == node
    if case == "workload_balance":
        np.testing.assert_array_equal(tsys.balancer.bias,
                                      jsys.balancer.bias)
    assert tsys.ledger.verify_chain()


def test_trust_api_additions_match_jax():
    """``audit_backlog``, ``FraudProof.compact_size_bytes``,
    ``AuditPlan.num_recomputes`` and ``detection_probability`` give the
    JAX package's numbers."""
    claimed = np.random.default_rng(0).normal(size=(4, 32, 10)) \
        .astype(np.float32)
    honest = claimed.copy()
    claimed[1, :8] += 1.0
    out = []
    for pkg, prt, aud in ((protocol, protocol, audit),
                          (jproto, jproto, jaudit)):
        kw = {"device": "cpu"} if pkg is protocol else {}
        p = prt.OptimisticProtocol(prt.TrustConfig(audit_rate=1.0,
                                                   num_verifiers=2,
                                                   challenge_window=3),
                                   num_edges=4, **kw)
        for r in range(3):
            p.commit(r, r % 4, claimed if r == 1 else honest)
            p.schedule_audit(r, lambda e, sl: honest[e, sl])
        backlog = p.audit_backlog()
        p.run_audits(1, lambda e, sl: honest[e, sl],
                     lambda es, sls: np.stack([honest[e, sl]
                                               for e, sl in zip(es, sls)]))
        proofs = p.rounds[1].proofs
        pool = aud.VerifierPool(num_verifiers=3, audit_rate=0.2, seed=1,
                                stakes=[1.0, 2.0, 3.0])
        out.append((backlog, p.rounds[1].phase.value,
                    [q.compact_size_bytes() for q in proofs],
                    pool.plan_audits(0, 40).num_recomputes,
                    pool.detection_probability(5),
                    pool.detection_probability(5, honest_verifiers=1),
                    aud.VerifierPool(3, 0.1).detection_probability(4)))
    assert out[0] == out[1]
    assert out[0][0] == [0, 1, 2] and out[0][2]


# ------------------------------------------ bitwise inside the port
def _system(attack, trust, seed=0, **kw):
    cfg = bmoe.BMoEConfig(framework="optimistic", attack=attack,
                          pow_difficulty=2,
                          reputation=ReputationConfig(**REP), trust=trust,
                          seed=seed, **kw)
    return bmoe.BMoESystem(cfg, device="cpu")


def test_fraud_after_descendants_rolls_back_whole_chain(data):
    """tests/test_pipeline.py:38 in the port, at the paper's widths: the
    replayed chain [2, 3] is bitwise the clean twin's."""
    xtr, ytr, _, _ = data
    atk = AttackConfig(malicious_edges=(2,), attack_prob=1.0, noise_std=5.0)
    trust = TrustConfig(audit_rate=1.0, num_verifiers=1, challenge_window=3)
    s, clean = _system(atk, trust), _system(AttackConfig(), trust)
    rng = np.random.default_rng(0)
    digests, backlogs = [], []
    for idx in [rng.integers(0, len(xtr), 64) for _ in range(4)]:
        s.train_round(xtr[idx], ytr[idx])
        clean.train_round(xtr[idx], ytr[idx])
        digests.append((digest_tree(s.experts), digest_tree(clean.experts)))
        backlogs.append(s.protocol.audit_backlog())
    assert digests[0][0] == digests[0][1] and digests[1][0] == digests[1][1]
    assert digests[2][0] != digests[2][1]
    assert backlogs == [[0], [0, 1], [0, 1, 2], []]
    assert s.protocol.rounds[2].phase is RoundPhase.ROLLED_BACK
    assert s.protocol.rounds[3].phase is RoundPhase.INVALIDATED
    assert [(r.round_id, r.invalidated) for r in s.protocol.rollbacks] == \
        [(2, [3])]
    assert [(ev.round_id, ev.edge) for ev in s.protocol.stakes.events] == \
        [(2, 2)]
    assert s.reputation.excluded[2]
    blocks = s.ledger.rollbacks()
    assert len(blocks) == 1 and blocks[0].payload["chain"] == [2, 3]
    assert blocks[0].payload["slashed"] == [2]
    assert s.ledger.verify_chain()
    assert digests[3][0] == digests[3][1]
    assert digest_tree(s.gate) == digest_tree(clean.gate)
    # the replay republished the voided versions: the bank the store
    # serves is the clean twin's
    assert s._bank_root() == clean._bank_root()


def _run(trust, atk, xtr, ytr, rounds=8, batch=64, **kw):
    s = _system(atk, trust, **kw)
    rng = np.random.default_rng(0)
    for idx in [rng.integers(0, len(xtr), batch) for _ in range(rounds)]:
        s.train_round(xtr[idx], ytr[idx])
    s.flush_trust()
    return s


@pytest.mark.parametrize("dispatch", ["sparse", "dense"])
def test_batched_equals_eager_bitwise(data, dispatch):
    """tests/test_pipeline.py:117 and test_sparse_dispatch.py:207 in the
    port: the same audit plans, proofs and digests under both backends,
    and the same bank after the rollbacks."""
    xtr, ytr, _, _ = data
    atk = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                       noise_std=5.0)
    a, b = (_run(TrustConfig(audit_rate=0.3, challenge_window=2,
                             audit_backend=backend), atk, xtr, ytr,
                 dispatch=dispatch)
            for backend in ("batched", "eager"))
    assert set(a.protocol.rounds) == set(b.protocol.rounds)
    for rid in a.protocol.rounds:
        ra, rb = a.protocol.rounds[rid], b.protocol.rounds[rid]
        assert [(r.verifier, r.sampled_leaves, r.lazy)
                for r in ra.reports] == \
            [(r.verifier, r.sampled_leaves, r.lazy) for r in rb.reports]
        assert [(p.leaf_index, p.expert, p.claimed_digest,
                 p.recomputed_digest) for p in ra.proofs] == \
            [(p.leaf_index, p.expert, p.claimed_digest,
              p.recomputed_digest) for p in rb.proofs]
        assert ra.phase is rb.phase
    assert [(ev.round_id, ev.edge, ev.amount)
            for ev in a.protocol.stakes.events] == \
        [(ev.round_id, ev.edge, ev.amount)
         for ev in b.protocol.stakes.events]
    assert a.protocol.stats["rolled_back"] >= 1
    assert digest_tree(a.experts) == digest_tree(b.experts)
    assert digest_tree(a.gate) == digest_tree(b.gate)
    calls = b.obs.metrics.snapshot("bmoe.audit_calls")
    assert calls.get("bmoe.audit_calls{kind=eager}", 0) > 0


def test_pipelined_equals_synchronous_bitwise(data):
    """tests/test_pipeline.py:148 in the port: one fraud, the same
    verdicts; the pipelined run invalidates descendants the synchronous
    one never built, and both settle on the same bits."""
    xtr, ytr, _, _ = data
    atk = AttackConfig(malicious_edges=(3,), attack_prob=1.0, noise_std=5.0)
    p, q = (_run(TrustConfig(audit_rate=0.5, challenge_window=2,
                             scheduling=sched), atk, xtr, ytr, rounds=6)
            for sched in ("pipelined", "synchronous"))
    for rid in range(6):
        assert [(r.verifier, r.sampled_leaves)
                for r in p.protocol.rounds[rid].reports] == \
            [(r.verifier, r.sampled_leaves)
             for r in q.protocol.rounds[rid].reports]
    for s_ in (p, q):
        assert [(ev.round_id, ev.edge)
                for ev in s_.protocol.stakes.events] == [(3, 3)]
        assert s_.protocol.rounds[3].phase is RoundPhase.ROLLED_BACK
    assert p.protocol.stats["invalidated"] > 0
    assert q.protocol.stats["invalidated"] == 0
    assert digest_tree(p.experts) == digest_tree(q.experts)
    assert digest_tree(p.gate) == digest_tree(q.gate)


def test_pipelined_rounds_commit_past_unaudited_ancestors(data):
    xtr, ytr, _, _ = data
    s = _system(AttackConfig(), TrustConfig(audit_rate=0.3,
                                            challenge_window=4))
    rng = np.random.default_rng(0)
    sizes = []
    for idx in [rng.integers(0, len(xtr), 64) for _ in range(9)]:
        s.train_round(xtr[idx], ytr[idx])
        sizes.append(len(s.protocol.audit_backlog()))
    assert max(sizes) >= 4
    assert 1 <= s.protocol.stats["audit_drains"] <= 3
    s.flush_trust()
    assert s.protocol.pending() == [] and not s._round_ctx
    assert s.protocol.stats["finalized"] == 9
    # an honest executor is never challenged
    assert all(not st.proofs and st.verdict is None
               for st in s.protocol.rounds.values())


def test_adversary_slashed_excluded_and_training_tracks_clean(data):
    """tests/test_trust.py:262 and :310 on the port's own init: three
    always-cheating executors are all slashed and excluded, no honest
    edge is, one rollback per stake event, and the trained model's
    accuracy stays within 0.02 of a clean twin's."""
    xtr, ytr, xte, yte = data
    atk = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                       noise_std=5.0)
    trust = TrustConfig(audit_rate=0.2, challenge_window=2)
    s, clean = _system(atk, trust), _system(AttackConfig(), trust)
    rng = np.random.default_rng(0)
    for r in range(12):
        idx = rng.integers(0, len(xtr), 128)
        s.train_round(xtr[idx], ytr[idx])
        clean.train_round(xtr[idx], ytr[idx])
    acc_a = s.evaluate(xte, yte, attack=AttackConfig())
    acc_c = clean.evaluate(xte, yte, attack=AttackConfig())
    assert abs(acc_a - acc_c) < 0.02, (acc_a, acc_c)
    for _ in range(8):
        idx = rng.integers(0, len(xtr), 128)
        s.train_round(xtr[idx], ytr[idx])
    slashed = {ev.edge for ev in s.protocol.stakes.events}
    assert slashed == {7, 8, 9}
    assert s.reputation.excluded[[7, 8, 9]].all()
    assert not s.reputation.excluded[:7].any()
    assert s.protocol.stats["rolled_back"] == len(s.protocol.stakes.events)
    last = max(ev.round_id for ev in s.protocol.stakes.events)
    execs = [b.payload["executor"] for b in s.ledger.blocks[1:]
             if b.payload.get("kind") == "train"
             and b.payload["round"] > last]
    assert execs and not set(execs) & {7, 8, 9}


def test_audit_spans_off_path_and_replay_under_consensus():
    """tests/test_obs.py:195 and :247 in the port: pipelined drains book
    ``bmoe.audit_s`` off the consensus path, the rollback replay nests
    under consensus, round spans cover their wall, and every mined block
    names a live span."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(512, 784)).astype(np.float32)
    y = rng.integers(0, 10, 512)
    obs = Observability(enabled=True)
    cfg = bmoe.BMoEConfig(
        framework="optimistic", num_experts=4, num_edges=4, top_k=2,
        pow_difficulty=1, attack=AttackConfig(malicious_edges=(2,),
                                              attack_prob=1.0,
                                              noise_std=5.0),
        trust=TrustConfig(audit_rate=0.5, challenge_window=2))
    s = bmoe.BMoESystem(cfg, device="cpu", obs=obs)
    for _ in range(5):
        idx = rng.integers(0, len(x), 128)
        s.train_round(x[idx], y[idx])
    s.flush_trust()
    ev = obs.trace.events
    by_id = {e["span_id"]: e for e in ev}
    cons = {e["span_id"] for e in ev if e["name"] == "consensus"}
    drains = [e for e in ev if e["name"] == "audit-drain"]
    nested = [e for e in drains if e["parent_id"] in cons]
    assert drains and nested
    cons_wall = sum(e["dur_s"] for e in ev if e["name"] == "consensus")
    assert obs.metrics.value("bmoe.consensus_s") == pytest.approx(
        cons_wall - sum(e["dur_s"] for e in nested), rel=1e-6)
    assert obs.metrics.value("bmoe.audit_s") == pytest.approx(
        sum(e["dur_s"] for e in drains), rel=1e-6)
    assert obs.metrics.value("bmoe.audit_infer_s") == 0
    replays = [e for e in ev if e["name"] == "rollback-replay"]
    assert replays and all(by_id[e["parent_id"]]["name"] == "consensus"
                           for e in replays)
    rounds = [e for e in ev if e["name"] == "round"]
    assert len(rounds) == 5
    for r in rounds:
        child = sum(e["dur_s"] for e in ev if e["parent_id"] == r["span_id"])
        assert child >= 0.95 * r["dur_s"]
    lr = s.latency_report(1000, 1000, 5)
    assert lr["audit_offpath_s"] > 0
    assert lr["total_s"] == pytest.approx(
        lr["compute_s"] + lr["comm_s"] + lr["consensus_s"] + lr["chain_s"],
        rel=1e-9)
    mined = [b for b in s.ledger.blocks if b.index > 0]
    assert mined and all(b.payload["span_id"] in by_id for b in mined)


def test_synchronous_drains_carry_no_audit_metric(data):
    xtr, ytr, _, _ = data
    obs = Observability(enabled=True)
    cfg = bmoe.BMoEConfig(framework="optimistic", num_experts=4,
                          num_edges=4, top_k=2, pow_difficulty=1,
                          trust=TrustConfig(audit_rate=0.5,
                                            scheduling="synchronous"))
    s = bmoe.BMoESystem(cfg, device="cpu", obs=obs)
    for r in range(3):
        s.train_round(xtr[r * 64:(r + 1) * 64], ytr[r * 64:(r + 1) * 64])
    drains = [e for e in obs.trace.events if e["name"] == "audit-drain"]
    assert len(drains) == 3 and s.protocol.stats["audit_drains"] == 3
    assert obs.metrics.value("bmoe.audit_s") == 0


def test_auditors_rederive_buckets_and_batched_closure(data):
    """tests/test_sparse_dispatch.py:230 in the port: every honest leaf
    recomputes to its committed digest from the routing, the task and
    the fetched version alone; the round's batched closure gives the
    eager closure's bytes, and ``run_audits`` through it convicts
    nobody."""
    xtr, ytr, _, _ = data
    s = _system(AttackConfig(), TrustConfig(audit_rate=1.0,
                                            challenge_window=2),
                num_experts=8, top_k=2)
    s.train_round(xtr[:48], ytr[:48])
    com = s.protocol.rounds[0].commitment
    job = s.protocol._audit_jobs[0]
    recompute = s._make_recompute(s._round_ctx[0]["xd"], s._audit_cids[0],
                                  com.row_index)
    coords = [com.leaf_coords(leaf) for leaf in range(com.num_leaves)]
    for leaf, (e, _, sl) in enumerate(coords):
        assert leaf_digest(recompute(e, sl)) == com.leaf_digests[leaf]
    stacked = job.batch_recompute_fn([e for e, _, _ in coords],
                                     [sl for _, _, sl in coords])
    for i, (e, _, sl) in enumerate(coords):
        assert np.array_equal(stacked[i, :sl.stop - sl.start],
                              recompute(e, sl))
    assert s.protocol.run_audits(0, job.recompute_fn,
                                 job.batch_recompute_fn) == []


@pytest.mark.parametrize("cache", ["on", "off"])
def test_cache_on_off_bitwise_under_attack_with_rollback(data, cache):
    """tests/test_expert_cache.py:174 in the port: the replayed chain and
    every verdict are blind to the edge cache."""
    xtr, ytr, _, _ = data
    atk = AttackConfig(malicious_edges=(1,), attack_prob=1.0, noise_std=5.0)
    trust = TrustConfig(audit_rate=1.0, num_verifiers=1, challenge_window=2)
    ref = _run(trust, atk, xtr, ytr, rounds=4, edge_cache="on")
    s = _run(trust, atk, xtr, ytr, rounds=4, edge_cache=cache)
    assert s.protocol.stats["rolled_back"] == 1
    assert digest_tree(s.experts) == digest_tree(ref.experts)
    assert [b.payload for b in s.ledger.rollbacks()] == \
        [b.payload for b in ref.ledger.rollbacks()]
