"""The port's protocol state machine against the JAX package's, on the
CPU: the walks of ``tests/test_protocol_properties.py`` driven through
both packages in lockstep.

``Twin`` applies every action (commit, audit, griefing audit, drain,
resolve, advance) to a port ``OptimisticProtocol`` and a JAX one built
with the same config and seeds, on the same numpy outputs, and after
every step asserts that the two agree on everything they decide: each
round's phase and deadline, ``pending()``, the stats, the stake book
and its slash events, the rollback chains, the proofs each audit and
drain confirmed, and what each advance finalized.  It also holds the
port to the JAX test's invariants (conservation, forward-only phases,
sequential finality, doomed descendants never finalizing).
``ChallengeWindow``'s edge cases and ``advance`` touching only open
rounds are checked in both packages side by side."""
import random

import numpy as np
import pytest
from hypothesis import settings, strategies as st
from hypothesis.stateful import RuleBasedStateMachine, invariant, rule

from repro.trust import protocol as jproto
from repro.trust.slashing import Verdict as JVerdict
from repro_torch.trust.protocol import (PHASE_RANK, TERMINAL_PHASES,
                                        ChallengeWindow, OptimisticProtocol,
                                        RoundPhase, TrustConfig)
from repro_torch.trust.slashing import Verdict

E, B, C, EDGES = 2, 4, 3, 4


def _proofs(proofs):
    return [(p.round_id, p.executor, p.leaf_index, p.expert, p.verifier,
             p.claimed_digest, p.recomputed_digest, p.path.siblings)
            for p in proofs]


def _state(proto):
    """Everything a protocol decided, in plain Python values."""
    return {
        "rounds": {rid: (s.phase.name, s.deadline, s.executor, s.tainted,
                         s.commitment.root, _proofs(s.proofs))
                   for rid, s in proto.rounds.items()},
        "pending": proto.pending(),
        "backlog": proto.audit_backlog(),
        "stats": dict(proto.stats),
        "stake": proto.stakes.stake.tolist(),
        "events": [(ev.round_id, ev.edge, ev.amount, ev.bounty, ev.verifier)
                   for ev in proto.stakes.events],
        "rollbacks": [(r.round_id, r.executor, r.invalidated, r.at_clock)
                      for r in proto.rollbacks],
    }


class Twin:
    """A port protocol and a JAX protocol driven in lockstep, with the
    ground truth the JAX test keeps (which rounds were fraudulent, which
    were doomed by a convicted ancestor)."""

    def __init__(self, window: int = 2):
        kw = dict(challenge_window=window, audit_rate=1.0, num_verifiers=1,
                  seed=0)
        self.port = OptimisticProtocol(TrustConfig(**kw), num_edges=EDGES,
                                       device="cpu")
        self.jax = jproto.OptimisticProtocol(jproto.TrustConfig(**kw),
                                             num_edges=EDGES)
        self.honest = np.zeros((E, B, C), np.float32)
        self.bad = self.honest + 1.0
        self.fraudulent = {}
        self.next_rid = 0
        self.clock = 0
        self.last_phase = {}
        self.doomed = set()

    def both(self, fn):
        """Apply ``fn(protocol)`` to each; their results must agree."""
        got, want = fn(self.port), fn(self.jax)
        assert got == want
        return got

    # ------------------------------------------------------------ steps
    def do_commit(self, fraud: bool, schedule: bool) -> None:
        rid = self.next_rid
        self.next_rid += 1

        def commit(p):
            executor = p.pick_executor(rid)
            p.commit(rid, executor, self.bad if fraud else self.honest)
            if schedule:
                p.schedule_audit(rid, lambda e, sl: self.honest[e, sl])
            return executor
        self.both(commit)
        self.fraudulent[rid] = fraud
        self.clock = max(self.clock, rid)
        self.check()

    def _audit(self, offset: int, against) -> None:
        open_rounds = self.both(lambda p: p.pending())
        if not open_rounds:
            return
        rid = open_rounds[offset % len(open_rounds)]
        proofs = self.both(lambda p: _proofs(p.run_audits(
            rid, lambda e, sl: against[e, sl])))
        if proofs and against is self.honest:
            assert self.fraudulent[rid]
            assert self.port.rounds[rid].phase is RoundPhase.CHALLENGED
        self.check()

    def do_audit(self, offset: int) -> None:
        self._audit(offset, self.honest)

    def do_grief(self, offset: int) -> None:
        self._audit(offset, self.bad)

    def do_drain(self, now=-1) -> None:
        now = self.clock if now == -1 else now
        self.both(lambda p: {rid: _proofs(ps) for rid, ps in
                             p.drain_audits(now).items()})
        self.check()

    def do_resolve(self) -> None:
        challenged = [rid for rid in self.port.pending()
                      if self.port.rounds[rid].phase
                      is RoundPhase.CHALLENGED]
        if not challenged:
            return
        rid = challenged[0]
        guilty = self.fraudulent[rid]
        before_open = set(self.port.pending())
        args = dict(round_id=rid, trusted=self.honest,
                    support=np.full(E, float(EDGES)),
                    flags=np.ones((E, EDGES), np.int32),
                    executor_guilty=guilty)
        phase = self.both(lambda p: p.resolve(rid, (
            Verdict if p is self.port else JVerdict)(**args)).phase.name)
        if guilty:
            self.doomed |= {r for r in before_open if r > rid}
        else:
            assert phase == ("INVALIDATED" if rid in self.doomed
                             else "ACCEPTED")
        self.check()

    def do_advance(self, dt: int) -> None:
        self.clock += dt
        challenged = {rid for rid in self.port.pending()
                      if self.port.rounds[rid].phase
                      is RoundPhase.CHALLENGED}
        done = self.both(lambda p: p.advance(self.clock))
        assert not set(done) & challenged
        self.check()

    # -------------------------------------------------------- invariants
    def check(self) -> None:
        assert _state(self.port) == _state(self.jax)
        proto = self.port
        phases = {rid: s.phase for rid, s in proto.rounds.items()}
        count = {p: sum(v is p for v in phases.values()) for p in RoundPhase}
        pending = proto.pending()
        assert proto.stats["committed"] == len(phases) == (
            count[RoundPhase.FINALIZED] + count[RoundPhase.ROLLED_BACK]
            + count[RoundPhase.INVALIDATED] + len(pending))
        assert len(proto.stakes.events) == count[RoundPhase.ROLLED_BACK]
        assert (proto.stakes.stake >= 0).all()
        assert pending == sorted(pending)
        finalized = [r for r, p in phases.items()
                     if p is RoundPhase.FINALIZED]
        if finalized and pending:
            assert max(finalized) < min(pending)
        assert not self.doomed & set(finalized)
        for rid, phase in phases.items():
            prev = self.last_phase.get(rid)
            if prev is not None:
                assert PHASE_RANK[phase] >= PHASE_RANK[prev]
                if prev in TERMINAL_PHASES:
                    assert phase is prev
            self.last_phase[rid] = phase

    def settle(self) -> None:
        self.do_drain(None)
        for _ in range(self.next_rid + 1):
            self.do_resolve()
        self.do_advance(self.port.cfg.challenge_window + self.next_rid)
        assert self.port.pending() == [] == self.jax.pending()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_protocol_random_walk_matches_jax(seed):
    """The JAX test's seeded walk (250 steps, then settled), both
    packages in lockstep."""
    rng = random.Random(seed)
    twin = Twin(window=rng.choice([0, 1, 2, 3]))
    steps = [
        lambda: twin.do_commit(rng.random() < 0.3, rng.random() < 0.5),
        lambda: twin.do_audit(rng.randrange(8)),
        lambda: twin.do_grief(rng.randrange(8)),
        lambda: twin.do_drain(),
        lambda: twin.do_resolve(),
        lambda: twin.do_advance(rng.randrange(4)),
    ]
    for _ in range(250):
        rng.choice(steps)()
    twin.settle()
    assert twin.port.stats["committed"] > 0


class TwinMachine(RuleBasedStateMachine):
    def __init__(self):
        super().__init__()
        self.twin = Twin()

    @rule(fraud=st.booleans(), schedule=st.booleans())
    def commit(self, fraud, schedule):
        self.twin.do_commit(fraud, schedule)

    @rule(offset=st.integers(min_value=0, max_value=7))
    def audit(self, offset):
        self.twin.do_audit(offset)

    @rule(offset=st.integers(min_value=0, max_value=7))
    def grief(self, offset):
        self.twin.do_grief(offset)

    @rule()
    def drain(self):
        self.twin.do_drain()

    @rule()
    def resolve(self):
        self.twin.do_resolve()

    @rule(dt=st.integers(min_value=0, max_value=3))
    def advance(self, dt):
        self.twin.do_advance(dt)

    @invariant()
    def invariants(self):
        self.twin.check()


TestTwinMachine = TwinMachine.TestCase
TestTwinMachine.settings = settings(max_examples=15, stateful_step_count=40,
                                    deadline=None)


def test_drain_audits_matches_jax():
    """``drain_audits`` releases nothing before a queued deadline is due,
    then the whole backlog deadline-ordered, and returns the confirmed
    proofs per round, as in the JAX package."""
    twin = Twin(window=3)
    for r in range(5):
        twin.do_commit(fraud=r in (1, 3), schedule=r != 2)
    twin.do_drain(now=2)                    # deadlines 3..7: none due
    assert twin.port.audit_backlog() == [0, 1, 3, 4]
    got = twin.port.drain_audits(3)
    want = twin.jax.drain_audits(3)
    assert {r: _proofs(p) for r, p in got.items()} == \
        {r: _proofs(p) for r, p in want.items()}
    assert sorted(got) == [0, 1, 3, 4] and got[0] == [] and got[1]
    assert twin.port.audit_backlog() == [] and twin.port.stats[
        "audit_drains"] == 1
    twin.check()
    twin.settle()


def test_advance_touches_only_open_rounds_in_both():
    protos = [OptimisticProtocol(TrustConfig(challenge_window=3,
                                             audit_rate=0.0,
                                             num_verifiers=1),
                                 num_edges=4, device="cpu"),
              jproto.OptimisticProtocol(jproto.TrustConfig(
                  challenge_window=3, audit_rate=0.0, num_verifiers=1),
                  num_edges=4)]
    outs = np.zeros((E, B, C), np.float32)
    for r in range(200):
        res = []
        for p in protos:
            p.commit(r, r % 4, outs)
            res.append((p.advance(r), p.pending(), len(p._open_heap)))
        assert res[0] == res[1]
        assert res[0][0] == ([r - 3] if r >= 3 else [])
        assert res[0][1] == list(range(max(0, r - 2), r + 1))
        assert res[0][2] <= 3
    assert protos[0].stats["finalized"] == protos[1].stats["finalized"] \
        == 197


def _window_case(cls, case):
    win = cls(2 if case == "revoke_after_expire" else
              3 if case == "duplicate_enter" else 4)
    log = []
    if case == "revoke_after_expire":
        win.enter(1, now=0)
        log.append(win.expire(2))
        win.revoke(1)
    elif case == "duplicate_enter":
        win.enter(5, now=0)
        win.enter(5, now=2)
        log += [win.deadline(5), win.expire(3), win.expire(5)]
    else:
        win.enter(9, now=10)
        log += [win.expire(13), win.expire(14)]
        win.enter(7, now=20)
        win.revoke(7)
        log.append(win.expire(24))
    return log, list(win.revoked), len(win)


@pytest.mark.parametrize("case,want", [
    ("revoke_after_expire", ([[1]], [], 0)),
    ("duplicate_enter", ([5, [], [5]], [], 0)),
    ("expire_at_deadline", ([[], [9], []], [7], 0))])
def test_challenge_window_edges_match_jax(case, want):
    assert _window_case(ChallengeWindow, case) == \
        _window_case(jproto.ChallengeWindow, case) == want
