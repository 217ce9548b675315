"""The port's serving engine against the JAX package's, on the CPU, on
smollm-360m's smoke config (the JAX package's seed-0 weights carried
across with ``convert.lm_params_from_numpy``).

Held exactly: the scheduler's admissions, meta and prefill lengths; tick
commitments and inclusion paths; ``forward_serve_chunk``'s greedy
tokens (its caches at 1e-5, idle rows bit for bit); the engine's token
streams, tick roots, session logs, verdicts, request meta and
``obs_report`` counters under both schedulings, with verified sessions,
a zero-token request and a tampered session.  Before a stream
comparison each test asserts the JAX run's greedy margin above 1e-4
(``torch_serving_common``)."""
import numpy as np
import pytest
import torch

from repro.data.synthetic import serving_requests
from repro.serve import engine as jengine
from repro.serve.scheduler import SlotScheduler as JScheduler
from repro.serve.scheduler import SlotState as JSlot
from repro.trust.commitments import MerkleTree as JMerkle
from repro.trust.commitments import leaf_digest as jleaf
from repro.trust.session import commit_tick as jcommit_tick
from repro.trust.session import verify_session_inclusion as jverify
from repro_torch.serve import POLICIES, SlotScheduler, SlotState
from repro_torch.serve import engine
from repro_torch.train.step import make_serve_chunk_step
from repro_torch.trust.commitments import leaf_digest
from repro_torch.trust.session import commit_tick, verify_session_inclusion

from torch_serving_common import (check_serve_chunk, clone, copies,
                                  engines, models, req, serve_both,
                                  serve_chunk_case, tick_rows, trees,
                                  verdicts)

TRUST = {"audit_rate": 1.0, "num_verifiers": 2, "challenge_window": 3}


@pytest.fixture(scope="module")
def smollm():
    return models("smollm-360m")


# ----------------------------------------------------------- scheduler
def _drive(sched_cls, slot_cls, case):
    """One scripted scheduler scenario; returns everything observable."""
    log = []
    if case == "full_batch":
        s = sched_cls(2, policy="continuous")
        s.submit([req(i, 4, 2) for i in range(4)], tick=0)
        log.append([(i, x.request_id) for i, x in s.admit(0)])
        log.append((s.depth(), s.admit(1), s.release(0, tick=5)))
        log.append([(i, x.request_id) for i, x in s.admit(6)])
        log.append((s.depth(), s.occupancy(), s.num_active,
                    s.active_requests()))
    elif case == "fixed":
        s = sched_cls(2, policy="fixed")
        s.submit([req(i, 4, 2) for i in range(3)], tick=0)
        log.append([(i, x.request_id) for i, x in s.admit(0)])
        s.release(0, tick=3)
        log.append(s.admit(4))
        s.release(1, tick=6)
        log.append([(i, x.request_id) for i, x in s.admit(7)])
    elif case == "prefill_lengths":
        s = sched_cls(4, policy="continuous")
        s.slots[0] = slot_cls(request_id=0, pos=0,
                              prompt=np.zeros(20, np.int32), cursor=0,
                              to_generate=1)
        s.slots[1] = slot_cls(request_id=1, pos=6,
                              prompt=np.zeros(8, np.int32), cursor=6,
                              to_generate=1)
        s.slots[2] = slot_cls(request_id=2, pos=4,
                              prompt=np.zeros(4, np.int32), cursor=4,
                              to_generate=3)
        for chunk, cache_len in ((16, 10), (4, 64), (1, 3)):
            log.append(s.prefill_lengths(chunk, cache_len).tolist())
    elif case == "preempt":
        s = sched_cls(2, policy="continuous")
        s.submit([req(i, 5, 3) for i in range(3)], tick=2)
        s.admit(2)
        log.append(s.preempt(1, tick=4))
        log.append([(r["id"], r["prompt"].tolist()) for r in s.queue])
        log.append([(i, x.request_id) for i, x in s.admit(5)])
        s.release(0, tick=6)
        with pytest.raises(ValueError, match="not active"):
            s.preempt(0, tick=7)
    return log, s.meta, s.submit_order


@pytest.mark.parametrize("case", ["full_batch", "fixed", "prefill_lengths",
                                  "preempt"])
def test_scheduler_matches_jax(case):
    assert _drive(SlotScheduler, SlotState, case) == \
        _drive(JScheduler, JSlot, case)


def test_scheduler_rejects_what_jax_rejects():
    assert POLICIES == ("continuous", "fixed")
    for cls in (SlotScheduler, JScheduler):
        with pytest.raises(ValueError):
            cls(2, policy="clairvoyant")
        with pytest.raises(ValueError):
            cls(2).submit([{"id": -1, "prompt": [1], "max_new_tokens": 1}])


# ------------------------------------------------------- tick commitments
@pytest.mark.parametrize("n,kv", [(1, 0), (3, 0), (5, 3), (8, 1)])
def test_commit_tick_matches_jax(n, kv):
    """Roots, kv roots and every inclusion path byte for byte."""
    rng = np.random.default_rng(n * 10 + kv)
    rows = rng.integers(0, 1000, (n, 1, 3)).astype(np.int64)
    leaves = [leaf_digest(r) for r in rows]
    assert leaves == [jleaf(r) for r in rows]
    rids = [int(x) for x in rng.permutation(50)[:n]]
    kv_roots = [JMerkle([f"kv{i}"]).root for i in range(kv)]
    tc, refs = commit_tick(7, list(zip(rids, leaves)), kv_roots=kv_roots)
    jtc, jrefs = jcommit_tick(7, list(zip(rids, leaves)), kv_roots=kv_roots)
    assert (tc.tick, tc.root, tc.request_ids, tc.kv_root, tc.num_leaves) \
        == (jtc.tick, jtc.root, jtc.request_ids, jtc.kv_root,
            jtc.num_leaves)
    for rid in rids:
        assert refs[rid].root == jrefs[rid].root
        assert refs[rid].path.index == jrefs[rid].path.index
        assert refs[rid].path.siblings == jrefs[rid].path.siblings
    # a rewritten leaf fails its inclusion proof in both
    tampered = list(leaves)
    tampered[n // 2] = leaves[0] if n > 1 else JMerkle(["x"]).root
    order = [refs[r] for r in rids]
    got = verify_session_inclusion(tampered, order, list(range(n)))
    assert got == jverify(tampered, [jrefs[r] for r in rids],
                          list(range(n))) == [n // 2]


def test_commit_tick_rejects_what_jax_rejects():
    for fn in (commit_tick, jcommit_tick):
        with pytest.raises(ValueError):
            fn(0, [])
        with pytest.raises(ValueError):
            fn(0, [(1, "a"), (1, "b")])
    with pytest.raises(ValueError):
        verify_session_inclusion(["a"], [], [0])


# ---------------------------------------------------- forward_serve_chunk
def test_forward_serve_chunk_matches_jax(smollm):
    check_serve_chunk(*serve_chunk_case(smollm))


def test_serve_chunk_step_refuses_encoder_decoder():
    from repro_torch.configs import get_config
    with pytest.raises(NotImplementedError):
        make_serve_chunk_step(get_config("seamless-m4t-medium", smoke=True))


# ------------------------------------------------------------ the engine
def _requests(n=5, max_prompt=10, max_new=5, seed=11):
    return list(serving_requests(512, n, max_prompt=max_prompt,
                                 max_new=max_new, seed=seed))


@pytest.fixture(scope="module")
def verified_runs(smollm):
    """Six requests through both packages, verified, under each
    scheduling: (JAX engine, JAX completed, port engine, port
    completed)."""
    return {s: serve_both(smollm, _requests(6, 20, 8, seed=3),
                          trust=TRUST, batch_slots=2, cache_len=64,
                          scheduling=s, prefill_chunk=8)
            for s in POLICIES}


def _counters(rep):
    return {k: rep[k] for k in ("ticks", "tokens", "commit_appends",
                                "commit_leaves")} | {
        "sessions": sorted(rep["sessions"]),
        "latency_count": rep["token_latency"]["count"],
        "occupancy_count": rep["occupancy"]["count"]}


@pytest.mark.parametrize("scheduling", POLICIES)
def test_engine_matches_jax(verified_runs, scheduling):
    """Streams, tick roots, session logs, verdicts, meta and counters
    all equal; every request finalizes."""
    j, jd, t, td = verified_runs[scheduling]
    assert td == jd and len(td) == 6
    assert tick_rows(t) == tick_rows(j)
    assert t.session_log == j.session_log
    assert verdicts(t, td) == verdicts(j, jd) == {
        r: "finalized" for r in range(6)}
    assert t.request_meta == j.request_meta
    assert (t.tick, t.steps) == (j.tick, j.steps)
    for rid, rec in t.records.items():
        jr = j.records[rid]
        assert (rec.leaves, rec.ticks, rec.tokens, rec.root) == \
            (jr.leaves, jr.ticks, jr.tokens, jr.root)
        assert [(r.tick, r.root, r.path.siblings) for r in rec.refs] == \
            [(r.tick, r.root, r.path.siblings) for r in jr.refs]
    assert _counters(t.obs_report()) == _counters(j.obs_report())


def test_fixed_equals_continuous_in_the_port(verified_runs):
    """Scheduling changes when tokens land, never which: the same
    streams and verdicts."""
    _, _, c, cd = verified_runs["continuous"]
    _, _, f, fd = verified_runs["fixed"]
    assert cd == fd
    assert verdicts(c, cd) == verdicts(f, fd)
    assert c.micro_steps < f.micro_steps + f.steps
    assert c.steps < f.steps


@pytest.mark.parametrize("scheduling,want", [("continuous", 4), ("fixed", 1)])
def test_warmup_matches_jax_and_changes_nothing(smollm, scheduling, want):
    j, t = engines(smollm, batch_slots=2, cache_len=64,
                   scheduling=scheduling, prefill_chunk=8)
    before = clone(t.caches)
    assert t.warmup() == j.warmup() == want
    assert (t.tick, t.steps, t.micro_steps) == (0, 0, 0)
    trees(lambda a, b, p: torch.equal(a, b) or pytest.fail(p),
           t.caches, before)
    reqs = [req(0, 11, 4), req(1, 3, 4)]
    cold = engines(smollm, batch_slots=2, cache_len=64,
                   scheduling=scheduling, prefill_chunk=8)[1]
    assert t.run() == {}
    t.submit(copies(reqs))
    cold.submit(copies(reqs))
    j.submit(copies(reqs))
    assert t.run() == cold.run() == j.run()


def test_zero_max_new_tokens_matches_jax(smollm):
    j, jd, t, td = serve_both(smollm, [req(0, 6, 0), req(1, 6, 3)],
                              trust={"audit_rate": 1.0, "num_verifiers": 1,
                                     "challenge_window": 2},
                              batch_slots=2, cache_len=64)
    assert td == jd and td[0] == [] and len(td[1]) == 3
    assert t.records[0].finalized and len(t.records[0].leaves) == 1
    assert t.session_log == j.session_log


def _tampered(models_, scheduling, tamper, audit):
    """Serve until every request is done but none can finalize (a wide
    window), tamper one served stream in both packages, audit it (or
    let the drain find it), and run to the end."""
    trust = {"audit_rate": 1.0, "num_verifiers": 1, "challenge_window": 80}
    reqs = [req(0, 4, 20), req(1, 4, 2), req(2, 4, 2)]
    out = []
    for eng in engines(models_, trust=trust, batch_slots=2, cache_len=64,
                       scheduling=scheduling):
        eng.submit(copies(reqs))
        while eng._done.keys() != {0, 1, 2} and eng.step():
            pass
        rec = eng.records[tamper]
        rec.tokens = [x ^ 1 for x in rec.tokens]
        rep = eng.audit_session(tamper) if audit else None
        done = eng.run()
        out.append((rep, done, verdicts(eng, done), eng.session_log))
    return out


@pytest.mark.parametrize("scheduling,tamper,audit", [
    ("continuous", 0, True), ("fixed", 0, True), ("continuous", 2, False)])
def test_tampered_session_revoked_like_jax(smollm, scheduling, tamper,
                                           audit):
    """The tampered session and its tick-overlapping open neighbours are
    revoked, with the same revocation chain in both packages."""
    (jrep, jd, jv, jlog), (rep, td, tv, tlog) = _tampered(
        smollm, scheduling, tamper, audit)
    assert rep == jrep and td == jd and tv == jv and tlog == jlog
    assert tv[tamper] == "revoked"
    assert any(e["event"] == "revoke" and e["request"] == tamper
               for e in tlog)
    if scheduling == "continuous" and tamper == 0:
        assert tv == {0: "revoked", 1: "revoked", 2: "revoked"}
        assert [e["request"] for e in tlog
                if e["event"] == "revoke_dependent"]


def test_consistent_rewrite_caught_by_tick_roots(smollm):
    """Leaves AND the session root rewritten consistently: the tick
    trees still catch it, in both packages."""
    reps = []
    for eng, leaf in zip(engines(smollm, trust={
            "audit_rate": 1.0, "num_verifiers": 1, "challenge_window": 50},
            batch_slots=2, cache_len=64), (jengine._tick_leaf,
                                           engine._tick_leaf)):
        eng.submit([req(0, 5, 4)])
        while 0 not in eng._done and eng.step():
            pass
        rec = eng.records[0]
        rec.tokens = [x ^ 1 for x in rec.tokens]
        rec.leaves = [leaf(0, a, b) for a, b in zip(rec.ticks, rec.tokens)]
        rec.seal()
        reps.append(eng.audit_session(0))
    assert reps[0] == reps[1] and reps[1]["revoked"]


def test_audit_errors_match_jax(smollm):
    for eng in engines(smollm, batch_slots=2, cache_len=64):
        with pytest.raises(ValueError, match="TrustConfig"):
            eng.audit_session(0)
    for eng in engines(smollm, trust=TRUST, batch_slots=2, cache_len=64):
        eng.submit([req(0, 20, 10)])
        eng.step()                   # 16 of 20 prompt tokens: unsealed
        with pytest.raises(ValueError, match="not sealed"):
            eng.audit_session(0)


def test_engine_refuses_encoder_decoder():
    from repro_torch.configs import get_config
    from repro_torch.train.loop import init_model
    cfg = get_config("seamless-m4t-medium", smoke=True)
    with pytest.raises(NotImplementedError):
        engine.ServingEngine(cfg, init_model(cfg, 0, "cpu"))
