"""The port's optimistic framework against the JAX package, on the CPU.

The pure-numpy trust modules get the same claimed tensors and must give
the same roots, audit plans, fraud proofs, court verdicts, stake books,
reputation and DA challenges.  The ``audit_mlp`` plain version is held
against the JAX oracle and the Pallas kernel (interpret mode) at 1e-5,
and against the eager per-chunk apply bitwise.  A JAX system carried
across runs 3 optimistic ``infer`` rounds plus ``flush_trust`` in both
packages: the protocol's decisions must be identical, and honest
rounds' logits within 1e-5.  Merkle roots are not compared across
packages for computed outputs: honest bytes agree to 1e-5 only."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bmoe as jbmoe
from repro.core.attacks import AttackConfig as JAttack
from repro.core.reputation import ReputationConfig as JRepCfg
from repro.core.reputation import ReputationLedger as JRepLedger
from repro.kernels import ref as jref
from repro.kernels.audit_gemm import audit_mlp as jaudit_mlp_pallas
from repro.obs import MetricsRegistry as JMetrics
from repro.storage import ExpertStore as JStore
from repro.storage import StorageNetwork as JNetwork
from repro.trust import audit as jaudit
from repro.trust import commitments as jcom
from repro.trust import protocol as jproto
from repro.trust import slashing as jslash
from repro.trust.da import DataAvailabilityAuditor as JDA
from repro_torch.convert import params_from_numpy
from repro_torch.core import bmoe
from repro_torch.core.attacks import AttackConfig
from repro_torch.core.consensus import ProofOfWork, majority_vote
from repro_torch.core.reputation import ReputationConfig, ReputationLedger
from repro_torch.data.synthetic import FMNIST, make_image_dataset
from repro_torch.kernels import ops
from repro_torch.obs import MetricsRegistry
from repro_torch.storage import ExpertStore, StorageNetwork
from repro_torch.trust import audit, commitments, protocol, slashing
from repro_torch.trust.da import DataAvailabilityAuditor

N, M, K, B = 4, 5, 2, 40


def _claimed(seed, n=N, rows=32, c=10, bad=((1, 0), (3, 2))):
    """(honest, claimed): claimed corrupts the given (expert, chunk)
    leaves of a 4-chunk commitment."""
    rng = np.random.default_rng(seed)
    honest = rng.standard_normal((n, rows, c)).astype(np.float32)
    claimed = honest.copy()
    step = rows // 4
    for e, ch in bad:
        claimed[e, ch * step:(ch + 1) * step] += 5.0
    return honest, claimed


def _proof_key(p):
    return (p.round_id, p.executor, p.leaf_index, p.expert,
            p.claimed_digest, p.recomputed_digest, p.verifier,
            p.path.index, p.path.siblings, p.claimed_chunk.tobytes())


def _report_key(r):
    return (r.round_id, r.verifier, r.sampled_leaves, r.recomputed_leaves,
            r.lazy, sorted(r.attestations.items()),
            [_proof_key(p) for p in r.fraud_proofs])


# ------------------------------------------------ commitments + audits
@pytest.mark.parametrize("rate,lazy,stakes", [
    (0.5, 0.0, None), (1.0, 0.3, None), (0.4, 0.0, (1.0, 3.0, 0.5))])
def test_plans_proofs_and_reports_match_jax(rate, lazy, stakes):
    honest, claimed = _claimed(1)
    rows = np.random.default_rng(2).integers(0, B + 1, (N, 32)).astype(
        np.int32)
    com = commitments.commit_outputs(claimed, round_id=3, executor=2,
                                     row_index=rows, task_digest="t")
    jc = jcom.commit_outputs(claimed, round_id=3, executor=2,
                             row_index=rows, task_digest="t")
    assert (com.root, com.leaf_digests, com.routing_digest) == \
        (jc.root, jc.leaf_digests, jc.routing_digest)
    kw = dict(lazy_prob=lazy, seed=7, stakes=stakes,
              reaudit_rate=0.5 if stakes else 0.0)
    pool = audit.VerifierPool(3, rate, **kw)
    jpool = jaudit.VerifierPool(3, rate, **kw)
    plan, jplan = pool.plan_audits(3, com.num_leaves), \
        jpool.plan_audits(3, com.num_leaves)
    assert dataclasses.astuple(plan) == dataclasses.astuple(jplan)

    def batch_fn(experts, slices):
        cmax = max(s.stop - s.start for s in slices)
        out = np.zeros((len(experts), cmax, 10), np.float32)
        for i, (e, s) in enumerate(zip(experts, slices)):
            out[i, :s.stop - s.start] = honest[e, s]
        return out

    reps = pool.audit_batched(com, batch_fn)
    jreps = jpool.audit_batched(jc, batch_fn)
    assert [_report_key(r) for r in reps] == [_report_key(r) for r in jreps]
    eager = pool.audit(com, lambda e, s: honest[e, s])
    jeager = jpool.audit(jc, lambda e, s: honest[e, s])
    assert [_report_key(r) for r in eager] == \
        [_report_key(r) for r in jeager]
    proofs = [p for r in reps for p in r.fraud_proofs]
    assert all(audit.verify_fraud_proof(com.root, p, lambda e, s:
                                        honest[e, s], com.leaf_coords(
                                            p.leaf_index)[2])
               for p in proofs)
    assert pool.reaudit(com, reps, lambda e, s: honest[e, s]) == \
        jpool.reaudit(jc, jreps, lambda e, s: honest[e, s])
    assert dict(pool.stats) == dict(jpool.stats)
    if rate == 1.0:
        assert {p.leaf_index for p in proofs} == {4, 14}


def test_pack_audit_batches_match_jax():
    rows = np.random.default_rng(3).integers(0, 41, (N, 32)).astype(np.int32)
    ex_ids, sl = [3, 0, 3, 1, 2], [slice(0, 8), slice(8, 16), slice(24, 32),
                                   slice(16, 23), slice(0, 5)]
    for a, b in zip(audit.pack_audit_batch(ex_ids, sl, row_map=rows),
                    jaudit.pack_audit_batch(ex_ids, sl, row_map=rows)):
        np.testing.assert_array_equal(a, b)
    slots = [0, 2, 1, 2, 0]
    off = np.arange(4) * 41
    maps = [rows, rows[::-1].copy(), rows + 1]
    for a, b in zip(
            audit.pack_audit_batch_multi(slots, ex_ids, sl, off, N,
                                         bucket=8, row_maps=maps),
            jaudit.pack_audit_batch_multi(slots, ex_ids, sl, off, N,
                                          bucket=8, row_maps=maps)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("colluding,mask,active", [
    (True, (1, 0, 0, 0, 0), (1, 1, 1, 1, 1)),
    (True, (1, 1, 1, 0, 0), (1, 1, 1, 1, 1)),      # majority backs fraud
    (False, (1, 0, 1, 0, 0), (1, 1, 0, 1, 1)),     # masked electorate
    (True, (0, 0, 0, 0, 0), (1, 1, 1, 1, 1)),      # griefing: innocent
])
def test_court_verdicts_match_jax(colluding, mask, active):
    honest, claimed = _claimed(4)
    if not any(mask):
        claimed = honest
    pub = np.broadcast_to(honest[:, None], (N, M) + honest.shape[1:]).copy()
    att = np.asarray(mask) > 0
    rng = np.random.default_rng(9)
    for m in np.nonzero(att)[0]:
        pub[:, m] = claimed if colluding else honest + rng.standard_normal(
            honest.shape).astype(np.float32)
    pub[:, 0] = claimed
    act = np.asarray(active, np.float32)
    v = slashing.DisputeCourt(M, device="cpu").escalate(5, pub, 0, act)
    jv = jslash.DisputeCourt(M).escalate(5, pub, 0, act)
    np.testing.assert_array_equal(v.trusted, np.asarray(jv.trusted))
    np.testing.assert_array_equal(v.support, np.asarray(jv.support))
    np.testing.assert_array_equal(v.flags, np.asarray(jv.flags))
    # a colluding majority backing the executor wins the vote
    assert v.executor_guilty == jv.executor_guilty == \
        (bool(mask[0]) and not (colluding and sum(mask) * 2 > M))


def test_stakes_reputation_and_pow_match_jax():
    cfg = dict(init=0.5, gain=0.01, slash=0.4, exclusion_threshold=0.2)
    rep, jrep = ReputationLedger(M, ReputationConfig(**cfg)), \
        JRepLedger(M, JRepCfg(**cfg))
    book, jbook = slashing.StakeBook(M, 1.0, 0.5, 0.5, 0.25), \
        jslash.StakeBook(M, 1.0, 0.5, 0.5, 0.25)
    _, claimed = _claimed(5)
    com = commitments.commit_outputs(claimed, round_id=0, executor=1)
    for r, (edge, verifier) in enumerate([(1, 0), (1, 2), (3, -1), (1, 1)]):
        proof = audit.FraudProof(
            round_id=r, executor=edge, leaf_index=0, expert=0,
            claimed_chunk=claimed[0, :8], path=com.tree().prove(0),
            claimed_digest="c", recomputed_digest="h", verifier=verifier)
        book.slash(proof)
        jbook.slash(proof)
        slashing.reputation_fraud_update(rep, edge, M)
        jslash.reputation_fraud_update(jrep, edge, M)
    np.testing.assert_array_equal(book.stake, jbook.stake)
    assert book.bounties == jbook.bounties and book.bonded_edges() == \
        jbook.bonded_edges()
    assert [dataclasses.astuple(e) for e in book.events] == \
        [dataclasses.astuple(e) for e in jbook.events]
    np.testing.assert_array_equal(rep.rep, jrep.rep)
    np.testing.assert_array_equal(rep.excluded, jrep.excluded)
    np.testing.assert_array_equal(rep.effective_power(),
                                  jrep.effective_power())
    from repro.core.consensus import ProofOfWork as JPoW
    from repro.core.consensus import majority_vote as jvote
    pw, jpw = ProofOfWork(4, 6, seed=3), JPoW(4, 6, seed=3)
    for i in range(3):
        b = pw.mine(i, "0" * 64, {"round": i, "kind": "rollback"})
        jb = jpw.mine(i, "0" * 64, {"round": i, "kind": "rollback"})
        assert (b.hash, b.nonce, b.miner) == (jb.hash, jb.nonce, jb.miner)
        assert pw.verify(b)
    res = [claimed[0], claimed[0], claimed[1]]
    assert dataclasses.astuple(majority_vote(res)) == \
        dataclasses.astuple(jvote(res))


def test_protocol_state_machine_matches_jax():
    """The same commits, audits and courts through both protocols: the
    same phases, finalizations, rollbacks, stakes and counters."""
    tc = dict(audit_rate=0.6, num_verifiers=2, challenge_window=1, seed=4)
    rep = ReputationLedger(M, ReputationConfig())
    jrep = JRepLedger(M, JRepCfg())
    p = protocol.OptimisticProtocol(protocol.TrustConfig(**tc), M, rep,
                                    chained=True, device="cpu")
    jp = jproto.OptimisticProtocol(jproto.TrustConfig(**tc), M, jrep,
                                   chained=True)
    honest = {}
    for rid in range(5):
        h, c = _claimed(10 + rid)
        bad = rid in (1, 3)
        ex_ = p.pick_executor(rid)
        assert ex_ == jp.pick_executor(rid)
        honest[rid] = h
        for proto_ in (p, jp):
            proto_.commit(rid, ex_, c if bad else h)
            proto_.schedule_audit(rid, lambda e, s, h=h: h[e, s])
        for proto_, court in ((p, "port"), (jp, "jax")):
            for job in proto_.pop_audit_jobs(rid):
                proto_.run_audits(job.round_id, job.recompute_fn)
                st = proto_.rounds[job.round_id]
                if st.phase.value == "challenged":
                    hh = honest[job.round_id]
                    pub = np.broadcast_to(hh[:, None],
                                          (N, M) + hh.shape[1:]).copy()
                    pub[:, st.executor] = st.commitment.claimed
                    proto_.resolve(job.round_id,
                                   proto_.court.escalate(job.round_id, pub,
                                                         st.executor))
            proto_.advance(rid)
    assert {r: s.phase.value for r, s in p.rounds.items()} == \
        {r: s.phase.value for r, s in jp.rounds.items()}
    assert [dataclasses.astuple(r) for r in p.rollbacks] == \
        [dataclasses.astuple(r) for r in jp.rollbacks]
    assert dict(p.stats) == dict(jp.stats)
    np.testing.assert_array_equal(p.stakes.stake, jp.stakes.stake)
    np.testing.assert_array_equal(rep.rep, jrep.rep)
    assert p.pending() == jp.pending()
    assert any(s.phase.value == "rolled_back" for s in p.rounds.values())
    w, jw = protocol.ChallengeWindow(2), jproto.ChallengeWindow(2)
    for obj in (w, jw):
        obj.enter(1, 0)
        obj.enter(2, 1)
        obj.revoke(2)
    assert w.expire(2) == jw.expire(2) and w.revoked == jw.revoked


def _da_pair():
    out = []
    for Net, Store, Met, DA in ((StorageNetwork, ExpertStore,
                                 MetricsRegistry, DataAvailabilityAuditor),
                                (JNetwork, JStore, JMetrics, JDA)):
        net = Net(num_nodes=4, replication=2, seed=3, metrics=Met())
        store = Store(net, chunk_bytes=256, metrics=Met())
        mans = {}
        for e in range(3):
            rng = np.random.default_rng(e)
            tree = {"w1": rng.standard_normal((20, 8)).astype(np.float32),
                    "b1": np.zeros(8, np.float32)}
            mans[f"expert/{e}"] = store.put_version(f"expert/{e}", tree, 0)
        out.append((net, mans, DA(net, num_nodes=4, window=2,
                                  sample_rate=0.5, seed=1, metrics=Met())))
    return out


def test_da_challenges_and_faults_match_jax():
    (net, mans, da), (jnet, jmans, jda) = _da_pair()
    assert {k: m.root for k, m in mans.items()} == \
        {k: m.root for k, m in jmans.items()}
    cid = mans["expert/1"].chunk_cids[2]
    held = net.replicas(cid)
    assert held == jnet.replicas(cid)
    for n_ in (net, jnet):
        n_.withhold(cid, held[0])
        n_.corrupt_replica(mans["expert/2"].chunk_cids[0],
                           n_.replicas(mans["expert/2"].chunk_cids[0])[0])
    for r in range(3):
        a = [dataclasses.astuple(c) for c in da.challenge_round(r, mans)]
        b = [dataclasses.astuple(c) for c in jda.challenge_round(r, jmans)]
        assert a == b
        assert [dataclasses.astuple(c) for c in da.resolve(r)] == \
            [dataclasses.astuple(c) for c in jda.resolve(r)]
    da.resolve(None)
    jda.resolve(None)
    assert [dataclasses.astuple(f) for f in da.faults] == \
        [dataclasses.astuple(f) for f in jda.faults]
    assert dict(da.stats) == dict(jda.stats)
    np.testing.assert_array_equal(da.stakes.stake, jda.stakes.stake)
    assert da.faults and {f.kind for f in da.faults} <= {"withheld",
                                                         "corrupted"}


# ------------------------------------------------------ audit_mlp plain
def _bank(seed, E, d, h, o):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((E, d, h)) / np.sqrt(d)).astype(
                np.float32),
            "b1": rng.standard_normal((E, h)).astype(np.float32),
            "w2": (rng.standard_normal((E, h, o)) / np.sqrt(h)).astype(
                np.float32),
            "b2": rng.standard_normal((E, o)).astype(np.float32)}


@pytest.mark.parametrize("E,S,C,d,h,o", [
    (10, 8, 94, 784, 256, 10), (3, 5, 93, 50, 70, 3), (30, 4, 8, 96, 16, 10),
    (1, 1, 1, 7, 5, 2)])
def test_audit_mlp_plain_matches_jax_ref_and_pallas(E, S, C, d, h, o):
    bank = _bank(E + S, E, d, h, o)
    rng = np.random.default_rng(C)
    x = rng.standard_normal((S, C, d)).astype(np.float32)
    gid = rng.integers(0, E, S).astype(np.int32)
    got = ops.audit_mlp({k: torch.from_numpy(v) for k, v in bank.items()},
                        torch.from_numpy(x), torch.from_numpy(gid)).numpy()
    jb = {k: jnp.asarray(v) for k, v in bank.items()}
    want = np.asarray(jref.audit_mlp_ref(jb, jnp.asarray(x),
                                         jnp.asarray(gid)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    pallas = np.asarray(jaudit_mlp_pallas(jb, jnp.asarray(x),
                                          jnp.asarray(gid), interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_audit_mlp_plain_is_bitwise_the_eager_per_chunk_apply():
    """Rows cut from a padded batched call equal, bit for bit, the eager
    recompute of the real slice alone (``audit_mlp`` with S=1, what
    ``_make_recompute`` calls) — also when the slice is shorter than the
    padded C, and over a stacked bank."""
    bank = _bank(0, 12, 784, 256, 10)
    tb = {k: torch.from_numpy(v) for k, v in bank.items()}
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((6, 94, 784)).astype(
        np.float32))
    gid = torch.tensor([0, 11, 11, 4, 7, 0], dtype=torch.int32)
    lengths = [94, 93, 1, 17, 94, 60]
    out = ops.audit_mlp(tb, x, gid)
    for s, n in enumerate(lengths):
        p = {k: v[int(gid[s])] for k, v in tb.items()}
        one = ops.audit_mlp({k: v[None] for k, v in p.items()},
                            x[s:s + 1, :n], torch.zeros(1, dtype=torch.int32))
        assert torch.equal(out[s, :n], one[0])
    with pytest.raises(ValueError, match="w1"):
        ops.audit_mlp(tb, x[:, :, :100], gid)


def test_plain_audit_mlp_launches_nothing():
    ops.reset_launch_counts()
    tb = {k: torch.from_numpy(v) for k, v in _bank(2, 2, 8, 4, 3).items()}
    ops.audit_mlp(tb, torch.zeros(2, 3, 8), torch.tensor([1, 0]))
    assert ops.launch_counts() == {"moe_gemm": 0, "redundancy_vote": 0,
                                   "audit_mlp": 0, "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "rglru_scan": 0,
                                   "rglru_scan_bwd": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0}


# ------------------------------------------------------------- system
@pytest.fixture(scope="module")
def data():
    _, _, xte, _ = make_image_dataset(FMNIST, n_train=50, n_test=200,
                                      seed=0)
    return xte.reshape(len(xte), -1)


CASES = {
    "cheater": (dict(malicious_edges=(0,), attack_prob=1.0, noise_std=5.0),
                dict(audit_rate=1.0, num_verifiers=1, challenge_window=2)),
    "pipelined_default": (dict(malicious_edges=(0, 3), attack_prob=1.0,
                               noise_std=5.0, colluding=False), dict()),
    "honest_reaudit": (dict(), dict(reaudit_rate=1.0, audit_rate=0.5,
                                    challenge_window=1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimistic_infer_matches_jax(data, case):
    atk_kw, tc_kw = CASES[case]
    rep = dict(init=0.5, gain=0.01, slash=0.4, exclusion_threshold=0.2)
    common = dict(num_experts=N, num_edges=M, top_k=K,
                  framework="optimistic", pow_difficulty=2)
    jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(
        **common, attack=JAttack(**atk_kw), reputation=JRepCfg(**rep),
        trust=jproto.TrustConfig(**tc_kw)))
    p = params_from_numpy(jax.tree_util.tree_map(np.asarray, jsys.gate),
                          jax.tree_util.tree_map(np.asarray, jsys.experts),
                          device="cpu")
    tsys = bmoe.BMoESystem(bmoe.BMoEConfig(
        **common, attack=AttackConfig(**atk_kw),
        reputation=ReputationConfig(**rep),
        trust=protocol.TrustConfig(**tc_kw)), device="cpu", params=p)
    ops.reset_launch_counts()
    for r in range(3):
        x = data[r * B:(r + 1) * B]
        jl, jact, _ = jsys.infer(x)
        tl, tact, _ = tsys.infer(x)
        np.testing.assert_array_equal(tact, jact)
        executor = tsys._infer_protocol.rounds[r].executor
        if executor not in atk_kw.get("malicious_edges", ()):
            np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5)
        assert tsys.pending_inference() == jsys.pending_inference()
    assert tsys.flush_trust() == jsys.flush_trust()
    assert ops.launch_counts() == {"moe_gemm": 0, "redundancy_vote": 0,
                                   "audit_mlp": 0, "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "rglru_scan": 0,
                                   "rglru_scan_bwd": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0}
    tp, jp = tsys._infer_protocol, jsys._infer_protocol

    def strip(log):
        return [{k: v for k, v in e.items() if k != "root"} for e in log]

    assert strip(tsys.infer_log) == strip(jsys.infer_log)
    assert {r: (s.executor, s.phase.value, len(s.proofs))
            for r, s in tp.rounds.items()} == \
        {r: (s.executor, s.phase.value, len(s.proofs))
         for r, s in jp.rounds.items()}
    assert [(e.round_id, e.edge, e.amount, e.verifier)
            for e in tp.stakes.events] == \
        [(e.round_id, e.edge, e.amount, e.verifier)
         for e in jp.stakes.events]
    np.testing.assert_array_equal(tsys.reputation.rep, jsys.reputation.rep)
    np.testing.assert_array_equal(tsys.reputation.excluded,
                                  jsys.reputation.excluded)
    assert [b.payload for b in tsys.ledger.rollbacks()] == \
        [b.payload for b in jsys.ledger.rollbacks()]
    assert dict(tp.stats) == dict(jp.stats)
    assert dict(tp.verifiers.stats) == dict(jp.verifiers.stats)
    assert tp.verifiers.lazy_slashes == [] == jp.verifiers.lazy_slashes
    assert tsys.verification_report() == jsys.verification_report()
    assert tsys.storage_report().keys() == jsys.storage_report().keys()
    if case == "cheater":
        assert tp.rounds[0].phase is protocol.RoundPhase.ROLLED_BACK
        assert tsys.reputation.excluded[0]
        assert len(tsys.ledger.rollbacks()) == 1
    if case == "honest_reaudit":
        assert all(s.phase is protocol.RoundPhase.FINALIZED
                   for s in tp.rounds.values())
        assert tsys.obs.metrics.value("bmoe.audit_calls", kind="eager") > 0


def test_reputation_excludes_edges_from_the_bmoe_vote(data):
    """``reputation=`` is accepted for every framework; an excluded edge
    leaves the electorate (``_controls``), as in the JAX package."""
    cfg = dict(num_experts=N, num_edges=M, top_k=K, framework="bmoe",
               reputation=ReputationConfig())
    tsys = bmoe.BMoESystem(bmoe.BMoEConfig(**cfg), device="cpu")
    jsys = jbmoe.BMoESystem(jbmoe.BMoEConfig(**{**cfg, "reputation":
                                                 JRepCfg()}))
    for s in (tsys, jsys):
        s.reputation.rep[[1, 3]] = 0.0
    _, active = tsys._controls()
    np.testing.assert_array_equal(active.numpy(),
                                  np.asarray(jsys._controls()[1]))
    assert active.tolist() == [1.0, 0.0, 1.0, 0.0, 1.0]
    _, _, support = tsys.infer(data[:B], attack=AttackConfig())
    assert (support == 3).all()


def test_optimistic_probe_and_train_round(data):
    tsys = bmoe.BMoESystem(bmoe.BMoEConfig(
        num_experts=N, num_edges=M, top_k=K, framework="optimistic",
        attack=AttackConfig(malicious_edges=(0,), attack_prob=1.0)),
        device="cpu")
    clean = bmoe.BMoESystem(bmoe.BMoEConfig(
        num_experts=N, num_edges=M, top_k=K, framework="bmoe"),
        device="cpu")
    x = data[:B]
    probe, _, support = tsys.infer(x, commit=False)
    honest, _, _ = clean.infer(x, attack=AttackConfig())
    np.testing.assert_array_equal(probe, honest)       # same seeded init
    assert (support == 1.0).all() and tsys._infer_protocol is None
    served, _, _ = tsys.infer(x)                        # executor 0 cheats
    assert not np.allclose(served, honest)
    # a training round: executor 0 commits its poisoned update, accepted
    # optimistically with its audit queued; flush settles it
    m = tsys.train_round(x, np.zeros(B, np.int64))
    assert tsys.round == 1 and m["rolled_back"] == 0
    assert tsys.protocol.rounds[0].executor == 0
    assert tsys.protocol.audit_backlog() == [0]
    tsys.flush_trust()
    assert tsys.protocol.rounds[0].phase in protocol.TERMINAL_PHASES
