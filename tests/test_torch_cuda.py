"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports torch and repro_torch only (no JAX), so it runs on a
machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test skips (decided at run time, in the
fixture, so every test collects the same everywhere)."""
import pickle

import numpy as np
import pytest
import torch

from repro_torch.core.attacks import AttackConfig
from repro_torch.core.bmoe import BMoEConfig, BMoESystem, _loss_and_grads
from repro_torch.core.ledger import digest_tree
from repro_torch.core.reputation import ReputationConfig
from repro_torch.configs import get_config
from repro_torch.kernels import audit_mlp as am
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ops, ref
from repro_torch.kernels import redundancy_vote as rv
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import encdec, moe, transformer
from repro_torch.models.builder import materialize
from repro_torch.train.loop import init_model
from repro_torch.trust.protocol import RoundPhase, TrustConfig

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 references
    return torch.device("cuda")


def _randn(seed, *shape):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.mark.parametrize("E,C,d,f,dtype", [
    (10, 376, 784, 256, torch.float32), (10, 376, 256, 10, torch.float32),
    (2, 100, 50, 70, torch.float32), (1, 1, 1, 1, torch.float32),
    (10, 376, 784, 256, torch.bfloat16), (2, 100, 50, 70, torch.bfloat16),
    # ragged against the 64 x 64 and 32 x 16 tiles and the K steps
    (3, 129, 17, 33, torch.float32), (1, 1, 8, 1, torch.float32),
    (2, 65, 260, 16, torch.float32), (3, 129, 17, 33, torch.bfloat16),
    (10, 376, 256, 10, torch.bfloat16), (1, 1, 8, 1, torch.bfloat16),
    # the training round's backward: dw2 = h^T g, dh = g w2^T, dw1 = buf^T dh
    (10, 256, 376, 10, torch.float32), (10, 376, 10, 256, torch.float32),
    (10, 784, 376, 256, torch.float32)])
def test_moe_gemm_kernel_matches_plain(cuda, E, C, d, f, dtype):
    buf = _randn(E + C, E, C, d).to(cuda, dtype)
    w = _randn(d + f, E, d, f).to(cuda, dtype)
    got = mg.moe_gemm(buf, w)
    want = ref.moe_gemm_ref(buf, w)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (E, C, f)
    tol = TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol * 8)


# the LM MoE layers at a prefill of 4096: bmoe-paper's gate/up and down,
# qwen2-moe-a2.7b's (K = 2048, then K = 1408), and its decode at C = k =
# 4 rows per expert, one slot and the fold of four (gate/up and down);
# bmoe-paper's decode fold of four slots at C = k = 3 (gate/up and down)
@pytest.mark.parametrize("E,C,d,f", [
    (10, 1536, 1024, 2816), (10, 1536, 2816, 1024), (64, 344, 2048, 1408),
    (64, 344, 1408, 2048), (64, 4, 2048, 1408), (64, 16, 2048, 1408),
    (64, 16, 1408, 2048), (10, 12, 1024, 2816), (10, 12, 2816, 1024)])
def test_moe_gemm_lm_shapes_match_plain(cuda, E, C, d, f):
    """Weights at the layers' fan-in scale 1/sqrt(d), as the model draws
    them, held to the fp32 bar of the B-MoE shapes."""
    buf = _randn(E + C, E, C, d).to(cuda)
    w = (_randn(d + f, E, d, f) * d ** -0.5).to(cuda)
    got = mg.moe_gemm(buf, w)
    want = ref.moe_gemm_ref(buf, w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=8e-5)


def test_moe_gemm_is_as_accurate_as_fp32_at_k1024(cuda):
    """On unit weights at K = 1024 (outputs of about 32) two fp32
    reduction orders differ by more than the absolute bar where an output
    cancels to near zero: both are held against the float64 product, the
    kernel's largest error at most twice the plain version's."""
    buf = _randn(50, 10, 1536, 1024).to(cuda)
    w = _randn(51, 10, 1024, 2816).to(cuda)
    exact = torch.bmm(buf.double(), w.double())
    err_k = (mg.moe_gemm(buf, w).double() - exact).abs().max()
    err_p = (ref.moe_gemm_ref(buf, w).double() - exact).abs().max()
    assert float(err_k) <= 2.0 * float(err_p)


def _pub(seed, E, M, T, n_bad, specials=False):
    pub = _randn(seed, E, 1, T).expand(E, M, T).clone()
    if n_bad:
        pub[:, M - n_bad:] += 5.0 * _randn(seed + 1, E, 1, T)
    if specials:
        pub[0, 1, 3] = float("nan")
        pub[1, :, 5] = float("inf")
        pub[2, 0, T - 1] = float("-inf")
    return pub


@pytest.mark.parametrize("E,M,T,n_bad,inactive,specials", [
    (10, 10, 3760, 3, (), False), (10, 10, 3760, 6, (), False),
    (4, 10, 1500, 4, (0, 2), False), (4, 5, 1500, 1, (), True),
    (3, 32, 300, 15, (), False), (2, 1, 7, 0, (), False),
    # past one 32-bit disagreement word per copy: minorities, a majority,
    # barred edges, NaN and +-inf
    (3, 33, 300, 16, (), True), (4, 64, 500, 31, (5, 40), True),
    (3, 100, 257, 51, (), True), (2, 100, 64, 30, (0, 99), False),
    # T = 1, and T below, on and across the edges of the 8 blocks' slices
    # (multiples of 32 elements): 31, 32, 33, 255, 256, 257, 4097
    (2, 10, 1, 3, (), False), (3, 10, 31, 4, (1,), True),
    (2, 10, 32, 3, (), False), (2, 10, 33, 6, (9,), False),
    (3, 10, 255, 3, (), True), (2, 10, 256, 4, (), False),
    (2, 10, 257, 3, (0,), False), (2, 10, 4097, 3, (), False),
    (4, 1, 100, 0, (), False), (2, 1, 5, 0, (0,), False),
    (3, 32, 1000, 16, (3, 31), True),
    # a dense-dispatch bmoe batch of 1000: every expert's whole batch
    (10, 10, 10000, 3, (), False),
    # the widest electorate one block's shared memory holds
    (3, 1351, 40, 600, (0, 700, 1350), True),
    (2, 1351, 3, 700, (), False)])
def test_vote_kernel_matches_plain(cuda, E, M, T, n_bad, inactive, specials):
    """Bitwise against the plain version, the elected copy included."""
    pub = _pub(E + T, E, M, T, n_bad, specials).to(cuda)
    active = torch.ones(M, device=cuda)
    active[list(inactive)] = 0.0
    got = rv.redundancy_vote_masked(pub, active)
    want = ref.redundancy_vote_winner_ref(pub, active)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(got[3], want[3])


def test_vote_launch_floor_launches_no_vote(cuda):
    pub = _pub(0, 10, 10, 3760, 3).to(cuda)
    ops.reset_launch_counts()
    rv.launch_floor(pub)
    rv.launch_floor(_pub(1, 1, 1351, 8, 0).to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["redundancy_vote"] == 0


def test_evaluate_launches_the_kernels(cuda):
    x = _randn(0, 1000, 784).numpy()
    y = np.zeros(1000, np.int64)
    sys_b = BMoESystem(BMoEConfig(), device=cuda)
    ops.reset_launch_counts()
    sys_b.evaluate(x, y, attack=AttackConfig())
    assert ops.launch_counts() == {"moe_gemm": 2, "redundancy_vote": 1,
                                   "audit_mlp": 0, "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "rglru_scan": 0,
                                   "rglru_scan_bwd": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0}


def _train_system(framework, device, attack=None, **kw):
    atk = attack or AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                                 noise_std=5.0)
    return BMoESystem(BMoEConfig(framework=framework, attack=atk, **kw),
                      device=device)


def _task(seed, n=1000):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 784), dtype=np.float32),
            rng.integers(0, 10, n))


def _round_on(device, framework, x, y):
    """autograd's gradients of the round's loss, then the round itself:
    (gradients, the round's metrics, its launches, the parameters after
    it), all on the host."""
    sys_ = _train_system(framework, device)
    atk = sys_.cfg.attack
    mask_e, noise = sys_._draw_attack(atk, len(x), sys_.round)
    gate_bias, active = sys_._controls()
    g_gate, g_exp, _ = _loss_and_grads(
        sys_.gate, sys_.experts, torch.from_numpy(x).to(device),
        torch.from_numpy(y).to(device), mask_e.to(device), noise.to(device),
        atk.noise_std, gate_bias, active, cfg=sys_.cfg)
    grads = {**g_exp, **{"gate_" + k: v for k, v in g_gate.items()}}
    ops.reset_launch_counts()
    m = sys_.train_round(x, y)
    counts = ops.launch_counts()
    params = {**sys_.experts, **{"gate_" + k: v for k, v in sys_.gate.items()}}
    return ({k: v.cpu() for k, v in grads.items()}, m, counts,
            {k: v.cpu() for k, v in params.items()})


@pytest.mark.parametrize("framework", ["bmoe", "traditional"])
def test_training_round_on_the_card_matches_the_cpu(cuda, framework):
    """One full-width training round (N=10, M=10, K=3, 784->256->10, a
    task of 1000, capacity 376, 3 of 10 colluding) on the card against
    the same round on the CPU: autograd's gradients at rtol 1e-4, the
    round's support, flags and activation equal, its parameters within
    1e-5; 5 moe_gemm launches, and 1 vote under bmoe."""
    x, y = _task(0)
    g_c, m_c, counts_c, p_c = _round_on("cpu", framework, x, y)
    g_g, m_g, counts_g, p_g = _round_on(cuda, framework, x, y)
    assert counts_c["moe_gemm"] == 0
    assert counts_g == {"moe_gemm": 5,
                        "redundancy_vote": int(framework == "bmoe"),
                        "audit_mlp": 0, "flash_attention": 0,
                        "flash_attention_bwd": 0,
                        "rglru_scan": 0,
                        "rglru_scan_bwd": 0, "ssd_scan": 0,
                        "ssd_scan_bwd": 0}
    for k in ("activation", "support", "flags", "dropped"):
        np.testing.assert_array_equal(m_g[k], m_c[k], err_msg=k)
    np.testing.assert_allclose(m_g["loss"], m_c["loss"], rtol=1e-5)
    for k in g_c:
        torch.testing.assert_close(g_g[k], g_c[k], rtol=1e-4, atol=1e-6,
                                   msg=k)
        torch.testing.assert_close(p_g[k], p_c[k], rtol=1e-5, atol=1e-5,
                                   msg=k)


def test_training_is_bitwise_repeatable_and_cache_blind(cuda, monkeypatch):
    """Under torch.use_deterministic_algorithms(True): two systems from
    seed 0 after 3 rounds each hold the same bits, and so do edge cache
    on and off."""
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        runs = []
        for cache in ("on", "on", "off"):
            sys_ = _train_system("bmoe", cuda, edge_cache=cache)
            for r in range(3):
                x, y = _task(10 + r)
                sys_.train_round(x, y)
            runs.append({**sys_.experts,
                         **{"gate_" + k: v for k, v in sys_.gate.items()}})
    finally:
        torch.use_deterministic_algorithms(False)
    for other in runs[1:]:
        for k, v in runs[0].items():
            assert torch.equal(v.view(torch.int32),
                               other[k].view(torch.int32)), k


REP = dict(init=0.5, gain=0.01, slash=0.4, exclusion_threshold=0.2)


def _optimistic(device, attack, trust, **kw):
    return BMoESystem(BMoEConfig(framework="optimistic", attack=attack,
                                 reputation=ReputationConfig(**REP),
                                 trust=trust, **kw), device=device)


def _decisions(s):
    p = s.protocol
    return ({r: (st.executor, st.phase.value,
                 [(q.leaf_index, q.expert) for q in st.proofs],
                 [(x.verifier, x.sampled_leaves) for x in st.reports])
             for r, st in p.rounds.items()},
            [(e.round_id, e.edge, e.amount) for e in p.stakes.events],
            [(r.round_id, r.invalidated) for r in p.rollbacks],
            dict(p.stats), s.verification_report())


def test_optimistic_training_on_the_card_matches_the_cpu(cuda):
    """Full-width optimistic training (N=10, M=10, K=3, tasks of 1000):
    round 0's gradients on the card at rtol 1e-4 of the CPU's; then three
    rounds with executor 1 cheating, audited in full: every decision is
    the CPU's, and the launches are the host's records — 5 moe_gemm a
    round and a replayed round, one audit_mlp a commitment and a counted
    recompute call, one vote a court escalation."""
    atk = AttackConfig(malicious_edges=(1,), attack_prob=1.0, noise_std=5.0)
    trust = TrustConfig(audit_rate=1.0, num_verifiers=1, challenge_window=1)
    x, y = _task(0)
    runs = {}
    for dev in ("cpu", cuda):
        s = _optimistic(dev, atk, trust)
        mask_e, noise = s._draw_attack(atk, len(x), 0)
        gate_bias, active = s._controls()
        g_gate, g_exp, _ = _loss_and_grads(
            s.gate, s.experts, torch.from_numpy(x).to(dev),
            torch.from_numpy(y).to(dev), mask_e.to(dev), noise.to(dev),
            atk.noise_std, gate_bias, active, cfg=s.cfg,
            executor=s.protocol.pick_executor(0))
        grads = {k: v.cpu() for k, v in
                 {**g_exp, **{"gate_" + k: v for k, v in g_gate.items()}}
                 .items()}
        ops.reset_launch_counts()
        for r in range(3):
            xr, yr = _task(20 + r)
            s.train_round(xr, yr)
        s.flush_trust()
        torch.cuda.synchronize()
        runs[str(dev)] = (s, grads, ops.launch_counts())
    (sc, gc, cc), (sg, gg, cg) = runs["cpu"], runs["cuda"]
    for k in gc:
        torch.testing.assert_close(gg[k], gc[k], rtol=1e-4, atol=1e-6,
                                   msg=k)
    assert _decisions(sg) == _decisions(sc)
    assert [(e.round_id, e.edge) for e in sg.protocol.stakes.events] == \
        [(1, 1)]
    calls = sg.obs.metrics.snapshot("bmoe.audit_calls")
    replayed = int(sg.obs.metrics.value("bmoe.replayed_rounds"))
    assert replayed >= 1
    assert cc == dict.fromkeys(cc, 0)
    assert cg == {"moe_gemm": 5 * (3 + replayed),
                  "audit_mlp": sg.protocol.stats["committed"]
                  + int(sum(calls.values())),
                  "redundancy_vote": sg.protocol.stats["escalations"],
                  "flash_attention": 0, "flash_attention_bwd": 0,
                  "rglru_scan": 0, "rglru_scan_bwd": 0, "ssd_scan": 0,
                  "ssd_scan_bwd": 0}


def test_chain_rollback_on_the_card_is_bitwise_the_clean_twin(cuda):
    """tests/test_pipeline.py:38 on the card at full width: round 2's
    fraud drains at round 3; the replayed chain [2, 3] holds the clean
    twin's bits."""
    atk = AttackConfig(malicious_edges=(2,), attack_prob=1.0, noise_std=5.0)
    trust = TrustConfig(audit_rate=1.0, num_verifiers=1, challenge_window=3)
    s = _optimistic(cuda, atk, trust)
    clean = _optimistic(cuda, AttackConfig(), trust)
    for r in range(4):
        x, y = _task(30 + r)
        s.train_round(x, y)
        clean.train_round(x, y)
    assert [(q.round_id, q.invalidated) for q in s.protocol.rollbacks] == \
        [(2, [3])]
    assert s.ledger.rollbacks()[0].payload["chain"] == [2, 3]
    assert digest_tree(s.experts) == digest_tree(clean.experts)
    assert digest_tree(s.gate) == digest_tree(clean.gate)


def _cifar_task(seed, n=256):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 32, 32, 3), dtype=np.float32),
            rng.integers(0, 10, n))


@pytest.mark.parametrize("dispatch", ["sparse", "dense"])
def test_cnn_training_is_bitwise_repeatable(cuda, dispatch):
    """The CNN bank (lr 0.1) trained 3 rounds under bmoe twice from seed
    0: the same bits, without the deterministic-algorithms switch (the
    CNN's cuDNN flags fix its algorithms); one vote a round, no
    moe_gemm."""
    runs = []
    for _ in range(2):
        s = _train_system("bmoe", cuda, expert_kind="cnn", in_ch=3, lr=0.1,
                          dispatch=dispatch)
        ops.reset_launch_counts()
        for r in range(3):
            s.train_round(*_cifar_task(40 + r))
        torch.cuda.synchronize()
        assert ops.launch_counts()["redundancy_vote"] == 3
        assert ops.launch_counts()["moe_gemm"] == 0
        runs.append({**s.experts,
                     **{"gate_" + k: v for k, v in s.gate.items()}})
    for k, v in runs[0].items():
        assert torch.equal(v.view(torch.int32),
                           runs[1][k].view(torch.int32)), k


def test_honest_cnn_optimistic_rounds_are_never_challenged(cuda):
    """Every leaf of three honest CNN rounds audited on the card: the
    commitment's bytes and the auditors' recompute agree bit for bit, so
    no round is challenged; batched and eager audits agree."""
    trust = dict(audit_rate=1.0, num_verifiers=2, challenge_window=1)
    runs = []
    for backend in ("batched", "eager"):
        s = _optimistic(cuda, AttackConfig(),
                        TrustConfig(audit_backend=backend, **trust),
                        expert_kind="cnn", in_ch=3, lr=0.1)
        for r in range(3):
            s.train_round(*_cifar_task(50 + r))
        s.flush_trust()
        assert all(st.phase is RoundPhase.FINALIZED and not st.proofs
                   and st.verdict is None
                   for st in s.protocol.rounds.values())
        runs.append(s)
    assert digest_tree(runs[0].experts) == digest_tree(runs[1].experts)


def _bank(seed, E, d, h, o, device):
    return {"w1": _randn(seed, E, d, h).to(device) / d ** 0.5,
            "b1": _randn(seed + 1, E, h).to(device),
            "w2": _randn(seed + 2, E, h, o).to(device) / h ** 0.5,
            "b2": _randn(seed + 3, E, o).to(device)}


@pytest.mark.parametrize("E,S,C,d,h,o", [
    (10, 40, 94, 784, 256, 10), (30, 8, 94, 784, 256, 10),
    (3, 5, 93, 50, 70, 3), (2, 3, 17, 100, 300, 20), (1, 1, 1, 1, 1, 1),
    # the widest hidden layer the wrapper takes (12 hidden slices of 256),
    # and outputs past one 32-wide output group
    (4, 6, 50, 784, 3072, 10), (2, 3, 40, 100, 300, 70)])
def test_audit_mlp_kernel_matches_plain(cuda, E, S, C, d, h, o):
    bank = _bank(E + S, E, d, h, o, cuda)
    x = _randn(C, S, C, d).to(cuda)
    gid = torch.from_numpy(np.random.default_rng(d).integers(
        0, E, S).astype(np.int32)).to(cuda)
    got = am.audit_mlp(bank, x, gid)
    want = ref.audit_mlp_ref(bank, x, gid)
    torch.cuda.synchronize()
    assert got.shape == (S, C, o)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_audit_mlp_rows_are_bitwise_invariant(cuda):
    """A sample's rows do not depend on S, its slot, the bank it is
    gathered from, or the padded C."""
    bank = _bank(0, 10, 784, 256, 10, cuda)
    x = _randn(1, 40, 94, 784).to(cuda)
    gid = torch.arange(40, device=cuda, dtype=torch.int32) % 10
    full = am.audit_mlp(bank, x, gid)
    sub = torch.tensor([37, 2, 19, 8], device=cuda)
    part = am.audit_mlp(bank, x[sub], gid[sub])
    assert torch.equal(part.view(torch.int32), full[sub].view(torch.int32))
    stacked = {k: torch.cat([v, v, v]) for k, v in bank.items()}
    off = am.audit_mlp(stacked, x, gid + 10 * (torch.arange(
        40, device=cuda, dtype=torch.int32) % 3))
    assert torch.equal(off.view(torch.int32), full.view(torch.int32))
    for s, n in ((0, 94), (5, 60), (39, 1)):
        one = am.audit_mlp({k: v[int(gid[s])][None] for k, v in
                            bank.items()}, x[s:s + 1, :n].contiguous(),
                           torch.zeros(1, dtype=torch.int32, device=cuda))
        assert torch.equal(one[0].view(torch.int32),
                           full[s, :n].view(torch.int32))
    with pytest.raises(IndexError):
        am.audit_mlp(bank, x, gid + 1)


def test_audit_mlp_refuses_hidden_past_the_limit(cuda):
    h = am.MAX_HIDDEN + 1
    bank = _bank(2, 1, 8, h, 2, cuda)
    with pytest.raises(ValueError, match="hidden width"):
        am.audit_mlp(bank, _randn(3, 1, 4, 8).to(cuda),
                     torch.zeros(1, dtype=torch.int32, device=cuda))


def test_optimistic_infer_and_flush_launch_audit_mlp(cuda):
    x = _randn(3, 1000, 784).numpy()
    sys_o = BMoESystem(BMoEConfig(framework="optimistic"), device=cuda)
    ops.reset_launch_counts()
    for _ in range(3):
        logits, _, _ = sys_o.infer(x)
        assert logits.shape == (1000, 10) and np.isfinite(logits).all()
    sys_o.flush_trust()
    counts = ops.launch_counts()
    p = sys_o._infer_protocol
    calls = sys_o.obs.metrics.snapshot("bmoe.audit_calls")
    assert counts["audit_mlp"] == p.stats["committed"] + sum(calls.values())
    assert counts["moe_gemm"] == 6 and counts["redundancy_vote"] == 0
    assert all(s.phase.value == "finalized" for s in p.rounds.values())


# the chip_smoke shapes (qwen2.5-3b and recurrentgemma-2b layers, ragged,
# softcap), then every compiled head dim, fully masked rows and a q_offset
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window,softcap,q_offset", [
    (1, 4096, 4096, 16, 2, 128, True, 0, 0.0, 0),
    (1, 4096, 4096, 10, 1, 256, True, 2048, 0.0, 0),
    (2, 1000, 1000, 4, 2, 64, False, 0, 0.0, 0),
    (1, 512, 512, 8, 4, 128, True, 0, 50.0, 0),
    (2, 130, 130, 4, 1, 64, True, 32, 0.0, 0),
    (1, 97, 97, 2, 2, 256, False, 16, 20.0, 0),
    (1, 16, 40, 4, 2, 64, True, 8, 0.0, 100),
    (1, 48, 300, 6, 3, 128, True, 64, 0.0, 252),
    # D 32 and 64 with Sq no multiple of the 64-row query tile
    (2, 100, 100, 4, 2, 32, True, 0, 0.0, 0),
    (1, 77, 77, 6, 3, 64, False, 0, 0.0, 0),
    # window edges inside a key tile (32 keys at D 128, 16 at D 256)
    (1, 300, 300, 4, 1, 128, True, 100, 0.0, 0),
    (1, 200, 200, 2, 1, 256, True, 45, 0.0, 0),
    # q_offset with Sk no multiple of the key tile
    (2, 30, 173, 4, 2, 64, True, 0, 0.0, 143),
    (1, 70, 333, 2, 2, 256, True, 0, 0.0, 263),
    # D 48 (smollm-360m's smoke config): causal, windowed
    (1, 200, 200, 5, 5, 48, True, 0, 0.0, 0),
    (2, 130, 130, 6, 2, 48, True, 40, 0.0, 0),
    # non-causal: seamless-m4t-medium's encoder and cross-attention at
    # 4096, and a ragged cross-attention with Sq != Sk both ways
    (1, 4096, 4096, 16, 16, 64, False, 0, 0.0, 0),
    (2, 1000, 1500, 8, 4, 64, False, 0, 0.0, 0),
    (1, 300, 77, 4, 4, 128, False, 0, 0.0, 0),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, KH, D,
                                              causal, window, softcap,
                                              q_offset, dtype):
    q = _randn(Sq + D, B, Sq, H, D).to(cuda, dtype)
    k = _randn(Sk + H, B, Sk, KH, D).to(cuda, dtype)
    v = _randn(Sk + KH, B, Sk, KH, D).to(cuda, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (B, Sq, H, D)
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("case", ["moe_gemm_layer1", "moe_gemm_layer2",
                                  "flash_causal_gqa", "flash_window_d256",
                                  "ssd_mamba2_chunks", "rglru_rgemma_layer",
                                  "audit_mlp_commit"])
def test_kernels_are_bitwise_repeatable(cuda, case):
    """Two launches on the same inputs give the same bits: one fixed
    reduction order per output, no split-K, no atomics."""
    if case.startswith("rglru"):
        a, b = (t.to(cuda) for t in _scan_inputs(4, 1, 4096, 2560))
        run = lambda: rg.rglru_scan(a, b)
    elif case.startswith("audit"):
        bank = _bank(5, 10, 784, 256, 10, cuda)
        x = _randn(6, 40, 94, 784).to(cuda)
        gid = torch.arange(40, device=cuda, dtype=torch.int32) % 10
        run = lambda: am.audit_mlp(bank, x, gid)
    elif case.startswith("ssd"):
        args = [t.to(cuda) for t in _ssd_inputs(8, 1, 1024, 16, 64, 128)]
        run = lambda: ss.ssd_scan(*args)
    elif case.startswith("moe_gemm"):
        E, C, d, f = (10, 376, 784, 256) if case.endswith("1") else (
            10, 376, 256, 10)
        args = (_randn(1, E, C, d).to(cuda), _randn(2, E, d, f).to(cuda))
        run = lambda: mg.moe_gemm(*args)
    else:
        H, KH, D, window = (16, 2, 128, 0) if case.endswith("gqa") else (
            10, 1, 256, 200)
        q = _randn(3, 1, 600, H, D).to(cuda)
        k, v = (_randn(s, 1, 600, KH, D).to(cuda) for s in (4, 5))
        run = lambda: fa.flash_attention(q, k, v, causal=True, window=window)
    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def test_flash_attention_reads_strided_views(cuda):
    """q, k, v cut out of one fused (B, S, H + 2 KH, D) projection."""
    qkv = _randn(5, 2, 200, 8, 64).to(cuda)
    q, k, v = qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    got = fa.flash_attention(q, k, v, causal=True, window=50)
    want = ref.attention_ref(q, k, v, causal=True, window=50)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :40], k[..., :40], v[..., :40])


def _scan_inputs(seed, B, S, C):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, C)).astype(
        np.float32)), _randn(seed + 1, B, S, C))


@pytest.mark.parametrize("B,S,C", [(1, 4096, 2560), (3, 1000, 300),
                                   (2, 7, 5), (1, 1, 1),
                                   # at and around the 64-step chunk
                                   (2, 63, 130), (2, 64, 130), (2, 65, 130),
                                   (3, 129, 257), (2, 20, 33)])
def test_rglru_scan_kernel_matches_plain(cuda, B, S, C):
    rng = np.random.default_rng(S + C)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, C)).astype(
        np.float32)).to(cuda)
    b = _randn(C, B, S, C).to(cuda)
    got = rg.rglru_scan(a, b)
    want = ref.rglru_scan_ref(a, b)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,S,C", [(1, 4096, 2560), (2, 65, 130),
                                   (2, 20, 33)])
def test_rglru_scan_kernel_is_the_chunked_association(cuda, B, S, C):
    """Bit for bit the chunked scan emulated in plain torch (each product
    and sum its own rounded operation) in tests/test_torch_tf32x3.py."""
    from test_torch_tf32x3 import rglru_chunked
    a, b = (t.to(cuda) for t in _scan_inputs(S, B, S, C))
    got = rg.rglru_scan(a, b)
    want = rglru_chunked(a, b, rg.CHUNK)
    torch.cuda.synchronize()
    assert _bitwise(got, want)


def test_rglru_scan_rows_do_not_depend_on_the_batch(cuda):
    """Each row of a B = 3 call is, bit for bit, the same row run alone:
    the association is fixed by (S, CHUNK), every (b, c) chain its own."""
    a, b = (t.to(cuda) for t in _scan_inputs(7, 3, 1000, 300))
    full = rg.rglru_scan(a, b)
    for i in range(3):
        one = rg.rglru_scan(a[i:i + 1].contiguous(), b[i:i + 1].contiguous())
        assert _bitwise(one[0], full[i])
    part = rg.rglru_scan(a[:, :, 100:200].contiguous(),
                         b[:, :, 100:200].contiguous())
    assert _bitwise(part, full[:, :, 100:200])


def test_recurrentgemma_smoke_prefill_on_the_card(cuda):
    """The smoke-width model on the card launches each kernel once per
    layer of its kind and agrees with the port's CPU run at 1e-4; so does
    the teacher-forced decode against the full forward (2e-3)."""
    cfg = get_config("recurrentgemma-2b", smoke=True)
    p_cpu = init_model(cfg, 0, "cpu")
    p = _to(p_cpu, cuda)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 72)).astype(np.int32))
    ops.reset_launch_counts()
    got, _ = transformer.forward_train(p, toks, cfg)
    torch.cuda.synchronize()
    n_attn = sum(s.kind == "local_attn" for s in cfg.block_pattern)
    n_rglru = sum(s.kind == "rglru" for s in cfg.block_pattern)
    assert ops.launch_counts()["flash_attention"] == n_attn * cfg.num_blocks
    assert ops.launch_counts()["rglru_scan"] == n_rglru * cfg.num_blocks
    want, _ = transformer.forward_train(p_cpu, toks, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    caches = materialize(transformer.cache_decl(cfg, 2, 72), 0, cuda)
    outs = []
    for t in range(72):
        lg, caches = transformer.forward_decode(p, caches,
                                                toks[:, t:t + 1], t, cfg)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), got, rtol=2e-3,
                               atol=2e-3)


def _ssd_inputs(seed, B, S, H, P, N):
    """As tests/test_kernels.py draws them: dt = 0.1 softplus(z),
    A = -|z| - 0.1, B and C at scale 0.5."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P))
    dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))) * 0.1
    A = -np.abs(rng.standard_normal(H)) - 0.1
    Bm = rng.standard_normal((B, S, N)) * 0.5
    Cm = rng.standard_normal((B, S, N)) * 0.5
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, dt, A, Bm, Cm)]


def _ssd_plain(x, dt, A, Bm, Cm):
    state0 = torch.zeros(x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1],
                         device=x.device)
    return ref.ssd_scan_ref(x, dt, A, Bm, Cm, state0)[0]


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 256, 3, 16, 8, 32), (1, 64, 1, 32, 16, 64), (2, 256, 3, 32, 16, 64),
    (1, 48, 16, 32, 32, 128),              # a single chunk of 48
    (1, 512, 4, 64, 128, 128),             # mamba2-2.7b's P and N
    (2, 96, 5, 24, 40, 96), (1, 21, 2, 7, 3, 7),    # off the 16-wide tiles
    (1, 4096, 80, 64, 128, 128),           # mamba2-2.7b's layer: 32 chunks
    (1, 200, 3, 64, 128, 100),             # two ragged chunks of 100
    (3, 300, 4, 64, 128, 100),             # three of 100: the state pass
])
def test_ssd_scan_kernel_matches_plain(cuda, B, S, H, P, N, chunk):
    x, dt, A, Bm, Cm = (t.to(cuda) for t in _ssd_inputs(S + P, B, S, H, P,
                                                         N))
    ops.reset_launch_counts()
    got = ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    assert ops.launch_counts()["ssd_scan"] == 1
    want = _ssd_plain(x, dt, A, Bm, Cm)
    torch.cuda.synchronize()
    assert got.shape == (B, S, H, P) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def _bitwise(a, b):
    return a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def test_ssd_scan_rows_do_not_depend_on_the_batch(cuda):
    """Each row of a B = 3 call is, bit for bit, the same row run alone:
    C B^T, the chunk states and the state pass of row b read row b only."""
    x, dt, A, Bm, Cm = (t.to(cuda) for t in _ssd_inputs(6, 3, 512, 8, 64,
                                                         128))
    full = ss.ssd_scan(x, dt, A, Bm, Cm)
    for b in range(3):
        one = ss.ssd_scan(x[b:b + 1].contiguous(), dt[b:b + 1].contiguous(),
                          A, Bm[b:b + 1].contiguous(),
                          Cm[b:b + 1].contiguous())
        assert _bitwise(one[0], full[b])


@pytest.mark.parametrize("dt_scale,A_scale", [(4.0, 4.0), (50.0, 20.0)])
def test_ssd_scan_strong_decay(cuda, dt_scale, A_scale):
    """dt and A scaled by 4 (cum down to about -300 in a chunk): exp(cum)
    underflows to 0 inside a chunk, and the masked exponent above the
    diagonal (up to +300) overflows and must not reach the output as
    inf * 0; the kernel stays within 2e-4 of the recurrence.  At dt x50
    and A x20 (|cum| to 18,579) the chunked form itself loses fp32 digits
    in cum_i - cum_j: the float32 chunk decomposition of
    tests/test_torch_tf32x3.py misses the float64 recurrence by more than
    2e-4 (1.6e-3), and the kernel, finite, stays within twice that miss."""
    x, dt, A, Bm, Cm = _ssd_inputs(9, 2, 512, 4, 64, 128)
    dt, A = dt * dt_scale, A * A_scale
    got = ss.ssd_scan(*(t.to(cuda) for t in (x, dt, A, Bm, Cm))).cpu()
    assert torch.isfinite(got).all()
    if dt_scale == 4.0:
        torch.testing.assert_close(got, _ssd_plain(x, dt, A, Bm, Cm),
                                   rtol=2e-4, atol=2e-4)
        return
    from test_torch_tf32x3 import ssd_chunks, ssd_recurrence_f64
    truth = ssd_recurrence_f64(x, dt, A, Bm, Cm)
    limit = float((ssd_chunks(x, dt, A, Bm, Cm, 128, torch.matmul).double()
                   - truth).abs().max())
    assert limit > 2e-4
    assert float((got.double() - truth).abs().max()) <= 2 * limit


def test_ssd_scan_under_cuda_graph_capture(cuda):
    """Captured into a CUDA graph (its scratch from the graph's pool, every
    launch on the capturing stream) and replayed on new inputs copied in
    place: the replay gives the eager call's bits."""
    args = [t.to(cuda) for t in _ssd_inputs(10, 1, 1024, 8, 64, 128)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.ssd_scan(*args)                        # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ss.ssd_scan(*args)
    for seed in (11, 12):
        for dst, src in zip(args, _ssd_inputs(seed, 1, 1024, 8, 64, 128)):
            dst.copy_(src)
        graph.replay()
        want = ss.ssd_scan(*args)
        torch.cuda.synchronize()
        assert _bitwise(out, want)
        torch.testing.assert_close(out, _ssd_plain(*args), rtol=2e-4,
                                   atol=2e-4)


def test_ssd_scan_reads_strided_views(cuda):
    """x and dt cut out of wider (B, S, ., .) tensors, B and C out of one
    (B, S, 2N) projection: the kernel reads them through strides."""
    x, dt, A, Bm, Cm = (t.to(cuda) for t in _ssd_inputs(3, 2, 256, 4, 32,
                                                         16))
    xw = torch.cat([x, x], dim=2)[:, :, 1:5]           # head stride 2x
    dtw = torch.cat([dt, dt], dim=2)[:, :, 2:6]
    bc = torch.cat([Bm, Cm], dim=-1)
    assert not (xw.is_contiguous() or dtw.is_contiguous())
    got = ss.ssd_scan(xw, dtw, A, bc[..., :16], bc[..., 16:], chunk=64)
    want = _ssd_plain(xw, dtw, A, bc[..., :16], bc[..., 16:])
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_ssd_scan_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, Bm, Cm = (t.to(cuda) for t in _ssd_inputs(4, 1, 256, 2, 64,
                                                         128))
    with pytest.raises(ValueError, match="not divisible"):
        ss.ssd_scan(x[:, :200], dt[:, :200], A, Bm[:, :200], Cm[:, :200],
                    chunk=128)
    with pytest.raises(ValueError, match="head dim"):
        ss.ssd_scan(torch.cat([x, x], -1), dt, A, Bm, Cm)        # P = 128
    with pytest.raises(ValueError, match="state"):
        ss.ssd_scan(x, dt, A, torch.cat([Bm, Bm], -1),
                    torch.cat([Cm, Cm], -1))                     # N = 256
    with pytest.raises(ValueError, match="chunk"):
        ss.ssd_scan(x, dt, A, Bm, Cm, chunk=256)                 # Q = 256
    with pytest.raises(TypeError):
        ss.ssd_scan(x.double(), dt, A, Bm, Cm)
    with pytest.raises(TypeError):
        ss.ssd_scan(x.bfloat16(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A,
                    Bm, Cm)


def _ssd_bwd_args(seed, B, S, H, P, N, device, decay=1.0):
    """x, dt, A, B, C as ``_ssd_inputs`` draws them (dt and A times
    ``decay``) and dy, on ``device``."""
    x, dt, A, Bm, Cm = _ssd_inputs(seed, B, S, H, P, N)
    dy = _randn(seed + 1, B, S, H, P)
    return [t.to(device) for t in (x, dt * decay, A * decay, Bm, Cm, dy)]


def _ssd_bwd_within_bar(got, args, chunk, strong=False, head_group=None):
    """The kernel's gradients against float64, each within twice the
    sequential loop's float32 error; under ``strong`` decay within twice
    the larger float32 error of the loop and of the chunked form by
    autograd (``tests/test_torch_tf32x3.py::ssd_bwd_errors``).  Each also
    within twice that wider bar of the decomposition emulated there with
    3xTF32 products (its head sums in groups of ``head_group`` heads, the
    kernel's default where None)."""
    from test_torch_tf32x3 import mm_3xtf32, ssd_bwd_chunks, ssd_bwd_errors
    Q = min(chunk, args[0].shape[1])
    errs = ssd_bwd_errors(got, *args, Q)
    assert all(e <= 2.0 * (max(p, c) if strong else p)
               for e, p, c in errs.values()), errs
    emul = ssd_bwd_chunks(*args, Q, mm_3xtf32, head_group=head_group)
    for g, e, (name, (_, p, c)) in zip(got, emul, errs.items()):
        assert float((g - e).abs().max()) <= 4.0 * max(p, c), name


@pytest.mark.parametrize("B,S,H,P,N,chunk", [
    (2, 256, 3, 16, 8, 32), (1, 64, 1, 32, 16, 64),
    (1, 48, 16, 32, 32, 128),              # a single chunk of 48
    (1, 512, 4, 64, 128, 128),             # mamba2-2.7b's P and N
    (2, 96, 5, 24, 40, 96), (1, 21, 2, 7, 3, 7),    # off the 16-wide tiles
    (1, 200, 3, 64, 128, 100),             # two ragged chunks of 100
    (3, 300, 4, 64, 128, 100),             # three of 100: the state passes
    (1, 1024, 8, 64, 128, 128),            # eight chunks
])
def test_ssd_scan_bwd_kernel_matches_plain(cuda, B, S, H, P, N, chunk):
    """One launch count per call; the five gradients in the operands'
    shapes, contiguous float32, finite and within the float64 bar."""
    args = _ssd_bwd_args(S + P, B, S, H, P, N, cuda)
    ops.reset_launch_counts()
    got = ss.ssd_scan_bwd(*args, chunk=chunk)
    assert ops.launch_counts()["ssd_scan_bwd"] == 1
    torch.cuda.synchronize()
    for g, t in zip(got, args[:5]):
        assert g.shape == t.shape and g.dtype == torch.float32
        assert g.is_contiguous() and bool(torch.isfinite(g).all())
    _ssd_bwd_within_bar(got, args, chunk)


def test_ssd_scan_bwd_is_bitwise_repeatable(cuda):
    args = _ssd_bwd_args(20, 2, 1024, 16, 64, 128, cuda)
    first, second = ss.ssd_scan_bwd(*args), ss.ssd_scan_bwd(*args)
    torch.cuda.synchronize()
    assert all(_bitwise(a, b) for a, b in zip(first, second))


def test_ssd_scan_bwd_rows_do_not_depend_on_the_batch(cuda):
    """dx, ddt, dB and dC of each row of a B = 3 call are, bit for bit,
    the row's run alone; dA, the one sum over the batch, is the rows' dA
    within float32 rounding."""
    args = _ssd_bwd_args(21, 3, 512, 8, 64, 128, cuda)
    full = ss.ssd_scan_bwd(*args)
    dA = torch.zeros_like(full[2])
    for b in range(3):
        one = ss.ssd_scan_bwd(*(t[b:b + 1].contiguous() if t.dim() > 1
                                else t for t in args))
        for k in (0, 1, 3, 4):
            assert _bitwise(one[k][0], full[k][b]), k
        dA += one[2]
    torch.testing.assert_close(full[2], dA, rtol=1e-5, atol=1e-5)


def test_ssd_scan_bwd_reads_strided_views(cuda):
    """x and dt cut out of wider tensors, B and C out of one (B, S, 2N)
    projection: the same bits as on contiguous copies, the gradients
    contiguous in the views' shapes."""
    x, dt, A, Bm, Cm, dy = _ssd_bwd_args(22, 2, 256, 4, 32, 16, cuda)
    xw = torch.cat([x, x], dim=2)[:, :, 1:5]
    dtw = torch.cat([dt, dt], dim=2)[:, :, 2:6]
    bc = torch.cat([Bm, Cm], dim=-1)
    assert not (xw.is_contiguous() or dtw.is_contiguous())
    got = ss.ssd_scan_bwd(xw, dtw, A, bc[..., :16], bc[..., 16:], dy,
                          chunk=64)
    want = ss.ssd_scan_bwd(xw.contiguous(), dtw.contiguous(), A,
                           bc[..., :16].contiguous(),
                           bc[..., 16:].contiguous(), dy, chunk=64)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.is_contiguous() and _bitwise(g, w)
    _ssd_bwd_within_bar(got, [xw, dtw, A, bc[..., :16], bc[..., 16:], dy],
                        64)


@pytest.mark.parametrize("dt_scale,A_scale", [(4.0, 4.0), (50.0, 20.0)])
def test_ssd_scan_bwd_strong_decay(cuda, dt_scale, A_scale):
    """dt and A scaled up (|cum| to about 300, then to about 18,600 in a
    chunk): exp(cum) underflows inside a chunk and the masked exponents
    would overflow; the gradients stay finite and within the strong-decay
    bar (which at x50 / x20 follows the chunked form's own loss of
    digits)."""
    x, dt, A, Bm, Cm, dy = _ssd_bwd_args(23, 2, 512, 4, 64, 128, cuda)
    args = [x, dt * dt_scale, A * A_scale, Bm, Cm, dy]
    got = ss.ssd_scan_bwd(*args)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in got)
    _ssd_bwd_within_bar(got, args, 128, strong=True)


def test_ssd_scan_bwd_under_cuda_graph_capture(cuda):
    """Captured into a CUDA graph and replayed on new inputs copied in
    place: the replay gives the eager call's bits."""
    args = _ssd_bwd_args(24, 1, 1024, 8, 64, 128, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ss.ssd_scan_bwd(*args)                    # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ss.ssd_scan_bwd(*args)
    for seed in (25, 26):
        for dst, src in zip(args, _ssd_bwd_args(seed, 1, 1024, 8, 64, 128,
                                                cuda)):
            dst.copy_(src)
        graph.replay()
        want = ss.ssd_scan_bwd(*args)
        torch.cuda.synchronize()
        assert all(_bitwise(a, b) for a, b in zip(out, want))


def _head_groups(monkeypatch, H, S, Q, N, head_group):
    """Set ``ss.HEAD_GROUP_BLOCKS`` so that the backward's default groups
    of the head sums hold ``head_group`` heads at this shape."""
    tiles = 2 * -(-N // 64) * (S // Q)
    monkeypatch.setattr(ss, "HEAD_GROUP_BLOCKS", -(-H // head_group) * tiles)
    assert ss.default_head_group(H, S, Q, N) == head_group


@pytest.mark.parametrize("B,S,H,P,N,chunk,head_group", [
    (1, 256, 3, 64, 128, 128, 2),          # H = 3 in groups of 2 and 1
    (1, 384, 5, 64, 128, 128, 2),          # H = 5 in groups of 2, 2, 1
    (1, 128, 5, 64, 128, 128, 3),          # one chunk: no gradient states
    (2, 256, 5, 64, 128, 128, 3),          # two chunks: no reverse pass
    (1, 192, 5, 32, 64, 48, 2),            # chunks of 48
    (1, 300, 5, 64, 128, 100, 3),          # chunks of 100
    (2, 256, 4, 64, 128, 128, 4),          # one group of every head
])
def test_ssd_scan_bwd_head_groups(cuda, monkeypatch, B, S, H, P, N, chunk,
                                  head_group):
    """Head groups that do not divide H, one and two chunks, Q = 48 and
    100: the five gradients within the float64 bar (the emulation's head
    sums in the same groups); dx, ddt and dA, which no group touches, the
    bits of one group of every head; dB and dC within float32 rounding of
    them."""
    args = _ssd_bwd_args(S + H, B, S, H, P, N, cuda)
    Q = min(chunk, S)
    _head_groups(monkeypatch, H, S, Q, N, head_group)
    got = ss.ssd_scan_bwd(*args, chunk=chunk)
    _head_groups(monkeypatch, H, S, Q, N, H)
    one = ss.ssd_scan_bwd(*args, chunk=chunk)
    torch.cuda.synchronize()
    for k in (0, 1, 2):
        assert _bitwise(got[k], one[k]), k
    for k in (3, 4):
        torch.testing.assert_close(got[k], one[k], rtol=1e-5, atol=1e-4)
    _ssd_bwd_within_bar(got, args, chunk, head_group=head_group)


def test_ssd_scan_bwd_head_groups_keep_rows_apart(cuda, monkeypatch):
    """B = 3 with the heads in groups of 2 of 5: each row's dx, ddt, dB and
    dC are, bit for bit, the row's run alone, so a group's partials do not
    mix rows."""
    args = _ssd_bwd_args(28, 3, 384, 5, 64, 128, cuda)
    _head_groups(monkeypatch, 5, 384, 128, 128, 2)
    full = ss.ssd_scan_bwd(*args)
    for b in range(3):
        one = ss.ssd_scan_bwd(*(t[b:b + 1].contiguous() if t.dim() > 1
                                else t for t in args))
        for k in (0, 1, 3, 4):
            assert _bitwise(one[k][0], full[k][b]), (b, k)


def test_ssd_scan_bwd_refuses_what_the_kernel_does_not_take(cuda):
    x, dt, A, Bm, Cm, dy = _ssd_bwd_args(27, 1, 256, 2, 64, 128, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ss.ssd_scan_bwd(torch.cat([x, x], -1), dt, A, Bm, Cm,
                        torch.cat([dy, dy], -1))                  # P = 128
    with pytest.raises(ValueError, match="state"):
        ss.ssd_scan_bwd(x, dt, A, torch.cat([Bm, Bm], -1),
                        torch.cat([Cm, Cm], -1), dy)              # N = 256
    with pytest.raises(ValueError, match="chunk"):
        ss.ssd_scan_bwd(x, dt, A, Bm, Cm, dy, chunk=256)          # Q = 256
    with pytest.raises(ValueError, match="not divisible"):
        ss.ssd_scan_bwd(x[:, :200], dt[:, :200], A, Bm[:, :200],
                        Cm[:, :200], dy[:, :200])
    with pytest.raises(ValueError, match="dy"):
        ss.ssd_scan_bwd(x, dt, A, Bm, Cm, dy[:, :128])
    with pytest.raises(TypeError):
        ss.ssd_scan_bwd(x.double(), dt, A, Bm, Cm, dy)


def test_smollm_smoke_prefill_on_the_card(cuda):
    """The smoke-width smollm-360m (head dim 48) on the card launches one
    flash attention per layer and agrees with the port's CPU run at
    1e-4."""
    cfg = get_config("smollm-360m", smoke=True)
    assert cfg.head_dim == 48
    p_cpu = init_model(cfg, 0, "cpu")
    p = _to(p_cpu, cuda)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 100)).astype(np.int32))
    ops.reset_launch_counts()
    got, _ = transformer.forward_train(p, toks, cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == cfg.num_layers
    want, _ = transformer.forward_train(p_cpu, toks, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)


def test_mamba2_smoke_prefill_on_the_card(cuda):
    """The smoke-width mamba2 on the card launches one ssd_scan per layer
    and agrees with the port's CPU run at 1e-4; so does the teacher-forced
    decode against the full forward (2e-3)."""
    cfg = get_config("mamba2-2.7b", smoke=True)
    p_cpu = init_model(cfg, 0, "cpu")
    p = _to(p_cpu, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 256)).astype(np.int32))
    ops.reset_launch_counts()
    got, _ = transformer.forward_train(p, toks, cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"moe_gemm": 0, "redundancy_vote": 0,
                                   "audit_mlp": 0, "flash_attention": 0,
                                   "flash_attention_bwd": 0,
                                   "rglru_scan": 0,
                                   "rglru_scan_bwd": 0,
                                   "ssd_scan": cfg.num_layers,
                                   "ssd_scan_bwd": 0}
    want, _ = transformer.forward_train(p_cpu, toks, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    caches = materialize(transformer.cache_decl(cfg, 2, 256), 0, cuda)
    outs = []
    for t in range(256):
        lg, caches = transformer.forward_decode(p, caches,
                                                toks[:, t:t + 1], t, cfg)
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), got, rtol=2e-3,
                               atol=2e-3)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.parametrize("B", [2, 4, 8])
def test_moe_gemm_decode_fold_rows_do_not_depend_on_the_batch(cuda, B):
    """The decode fold (E, B*C, d) at C = 4: each slot's rows equal, bit
    for bit, the same slot's (E, C, d) call alone."""
    buf = _randn(30 + B, B, 64, 4, 2048).to(cuda)
    w = _randn(31, 64, 2048, 1408).to(cuda)
    fold = mg.moe_gemm(buf.transpose(0, 1).reshape(64, 4 * B, 2048)
                       .contiguous(), w).reshape(64, B, 4, 1408)
    for b in range(B):
        assert _bitwise(mg.moe_gemm(buf[b].contiguous(), w), fold[:, b])


NEW_ARCHS = ("bmoe-paper", "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b",
             "qwen3-32b", "gemma3-27b", "pixtral-12b")


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_new_smoke_models_on_the_card_match_the_cpu(cuda, arch):
    """Each smoke model's prefill on the card launches one flash attention
    per attention layer and three moe_gemm per MoE layer, agrees with the
    port's CPU run at 1e-4 (prefill token equal), and 40 decode steps
    (with expert counts for MoE models) agree with the CPU's at 1e-4
    (counts equal).  The CPU run's router margins are asserted above
    1e-4 first, so a near-tie is reported as one."""
    cfg = get_config(arch, smoke=True)
    p_cpu = init_model(cfg, 0, "cpu")
    p = _to(p_cpu, cuda)
    rng = np.random.default_rng(11)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40))
                            .astype(np.int32))
    patches = None
    if cfg.frontend == "vision":
        patches = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    if cfg.num_experts:
        logits = []
        inner = moe.route
        moe.route = lambda lg, *a: (logits.append(lg), inner(lg, *a))[1]
        try:
            transformer.forward_train(p_cpu, toks, cfg)
        finally:
            moe.route = inner
        for lg in logits:
            top = lg[..., :cfg.num_experts].sort(-1, descending=True)[0]
            k = cfg.num_experts_per_tok
            if cfg.num_experts > k:
                assert float((top[..., k - 1] - top[..., k]).min()) > 1e-4
    ops.reset_launch_counts()
    got, aux = transformer.forward_train(
        p, toks, cfg, prefix_embeds=None if patches is None
        else patches.to(cuda))
    torch.cuda.synchronize()
    specs = list(cfg.block_pattern) * cfg.num_blocks + list(cfg.remainder)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == len(specs)
    assert counts["moe_gemm"] == 3 * sum(s.mlp == "moe" for s in specs)
    want, waux = transformer.forward_train(p_cpu, toks, cfg,
                                           prefix_embeds=patches)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux.cpu(), waux, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[:, -1].argmax(-1).cpu(), want[:, -1].argmax(-1))
    stats = bool(cfg.num_experts)
    caches = {d: materialize(transformer.cache_decl(cfg, 2, 40), 0, d)
              for d in (cuda, "cpu")}
    for t in range(40):
        out = {d: transformer.forward_decode(
            pp, caches[d], toks[:, t:t + 1], t, cfg, expert_stats=stats)
            for d, pp in ((cuda, p), ("cpu", p_cpu))}
        caches = {d: o[1] for d, o in out.items()}
        torch.testing.assert_close(out[cuda][0].cpu(), out["cpu"][0],
                                   rtol=1e-4, atol=1e-4)
        if stats:
            assert torch.equal(out[cuda][2].cpu(), out["cpu"][2])


def test_seamless_smoke_on_the_card_matches_the_cpu(cuda):
    """The smoke encoder-decoder on the card: 3 flash launches a layer
    pair (encoder, decoder self, cross), forward at 1e-4 against the CPU
    (prefill token equal), and decode steps against the same cross K/V
    at 1e-4."""
    cfg = get_config("seamless-m4t-medium", smoke=True)
    p_cpu = init_model(cfg, 0, "cpu")
    p = _to(p_cpu, cuda)
    rng = np.random.default_rng(12)
    frames = torch.from_numpy(rng.standard_normal(
        (2, 70, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 30))
                            .astype(np.int32))
    ops.reset_launch_counts()
    got, _ = encdec.forward_train(p, frames.to(cuda), toks, cfg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == (
        cfg.num_encoder_layers + 2 * cfg.num_layers)
    want, _ = encdec.forward_train(p_cpu, frames, toks, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[:, -1].argmax(-1).cpu(), want[:, -1].argmax(-1))
    cpu = materialize(encdec.encdec_cache_decl(cfg, 2, 30, 70), 0, "cpu")
    cpu["cross_k"] = _randn(13, *cpu["cross_k"].shape)
    cpu["cross_v"] = _randn(14, *cpu["cross_v"].shape)
    card = _to(cpu, cuda)
    for t in range(30):
        lg, card = encdec.forward_decode(p, card, toks[:, t:t + 1], t, cfg)
        wl, cpu = encdec.forward_decode(p_cpu, cpu, toks[:, t:t + 1], t, cfg)
        torch.testing.assert_close(lg.cpu(), wl, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ serving
SERVE_ARCHS = ("smollm-360m", "qwen2-moe-a2.7b", "bmoe-paper")


def _emitted_margins(cfg, params, reqs, done):
    """The smallest top-1/top-2 logit margin over every token ``done``
    emitted, by a teacher-forced decode of prompt and stream on the
    CPU: a greedy near-tie between the card and the CPU is reported as
    one."""
    margins = []
    for r in reqs:
        gen = done[r["id"]]
        seq = list(r["prompt"]) + gen[:-1]
        caches = materialize(transformer.cache_decl(cfg, 1, len(seq)), 0,
                             "cpu")
        for t, tok in enumerate(seq):
            lg, caches = transformer.forward_decode(
                params, caches, torch.tensor([[int(tok)]]), t, cfg)
            if t >= len(r["prompt"]) - 1 and gen:
                top = lg[0, -1].topk(2)[0]
                margins.append(float(top[0] - top[1]))
    return min(margins)


def _serve(cfg, params, reqs, **kw):
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, **kw)
    eng.submit([dict(r, prompt=np.array(r["prompt"])) for r in reqs])
    return eng, eng.run()


def _serve_reqs(cfg, n, seed=3):
    from repro_torch.data.synthetic import serving_requests
    return list(serving_requests(cfg.vocab_size, n, max_prompt=20,
                                 max_new=8, seed=seed))


@pytest.mark.parametrize("scheduling", ["continuous", "fixed"])
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_serving_engine_on_the_card_matches_the_cpu(cuda, arch, scheduling,
                                                     monkeypatch):
    """The smoke engine (verified sessions) on the card serves the CPU's
    streams, tick roots and session log; every micro-step of a MoE model
    launches moe_gemm three times a MoE layer and never runs the plain
    version."""
    cfg = get_config(arch, smoke=True)
    p_cpu = init_model(cfg, 0, "cpu")
    reqs = _serve_reqs(cfg, 6)
    kw = dict(batch_slots=4, cache_len=64, scheduling=scheduling,
              trust=TrustConfig(audit_rate=1.0, num_verifiers=2,
                                challenge_window=3))
    cpu, want = _serve(cfg, p_cpu, reqs, **kw)
    assert _emitted_margins(cfg, p_cpu, reqs, want) > 1e-4, \
        "a greedy near-tie on the CPU"

    def plain(*a):
        raise AssertionError("the plain moe_gemm ran on the card's path")
    monkeypatch.setattr(ref, "moe_gemm_ref", plain)
    ops.reset_launch_counts()
    card, got = _serve(cfg, _to(p_cpu, cuda), reqs, **kw)
    counts = ops.launch_counts()
    assert got == want and len(got) == 6
    assert [(t.tick, t.root) for t in card.tick_commitments] == \
        [(t.tick, t.root) for t in cpu.tick_commitments]
    assert card.session_log == cpu.session_log
    n_moe = sum(s.mlp == "moe" for s in list(cfg.block_pattern)
                * cfg.num_blocks + list(cfg.remainder))
    assert card.micro_steps == cpu.micro_steps > 0
    assert counts == {"moe_gemm": 3 * n_moe * card.micro_steps,
                      "redundancy_vote": 0, "audit_mlp": 0,
                      "flash_attention": 0, "flash_attention_bwd": 0,
                      "rglru_scan": 0, "rglru_scan_bwd": 0, "ssd_scan": 0,
                      "ssd_scan_bwd": 0}


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "bmoe-paper"])
def test_serving_batched_equals_alone_on_the_card(cuda, arch):
    """Four requests served together in a 4-slot engine against each one
    alone in a fresh 4-slot engine: the same tokens, and each request's
    cache rows bit for bit (a row is its own dispatch group, and
    moe_gemm's rows do not depend on the other rows of the fold)."""
    cfg = get_config(arch, smoke=True)
    p = init_model(cfg, 0, cuda)
    reqs = _serve_reqs(cfg, 4, seed=5)
    kw = dict(batch_slots=4, cache_len=64, prefill_chunk=8)
    batched, done = _serve(cfg, p, reqs, **kw)
    assert len(done) == 4
    for slot, r in enumerate(reqs):
        alone, one = _serve(cfg, p, [r], **kw)
        assert one[r["id"]] == done[r["id"]]
        fed = len(r["prompt"]) + len(done[r["id"]]) - 1
        for a, b in zip(_leaves(batched.caches), _leaves(alone.caches)):
            assert _bitwise(a[:, slot, :fed], b[:, 0, :fed])


def _leaves(tree):
    from repro_torch.core.ledger import tree_flatten
    return tree_flatten(tree)[0]


def test_serve_launcher_runs_on_the_card(cuda, capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", "qwen2-moe-a2.7b", "--requests", "3",
                       "--slots", "2", "--cache-len", "64"])
    assert len(done) == 3
    assert "device=cuda" in capsys.readouterr().out


# ------------------------------------------------------ LM training
def _attn_grad_fp64(q, k, v, do, causal, window, softcap, q_offset):
    """dq, dk, dv of attention in float64 by autograd (the yardstick both
    backward versions are held to)."""
    q, k, v = (t.double().requires_grad_(True) for t in (q, k, v))
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    G = H // KH
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, KH, G, D),
                     k) * D ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = ref.attention_mask(Sq, Sk, q.device, causal=causal,
                              window=window, q_offset=q_offset)
    s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype,
                                        device=s.device))
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v)
    return torch.autograd.grad(o.reshape(B, Sq, H, D), (q, k, v),
                               do.double())


# the chip_smoke shapes cut in length (qwen2.5-3b, recurrentgemma-2b,
# seamless-m4t-medium, its cross-attention), then GQA with window and
# q_offset, softcap, rows with no valid key, and every head dim at a
# ragged length; then the kernel's tile edges: G = 8 and 10 with Sk ending
# inside a ring stage (32 keys at D 128, 16 at D 256), Sk under one key
# tile, a window narrower than a query tile, D 256 non-causal with a
# softcap, and B = 2 under GQA (the head-sum pass over several batches)
@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window,softcap,q_offset", [
    (1, 512, 512, 16, 2, 128, True, 0, 0.0, 0),
    (1, 600, 600, 10, 1, 256, True, 256, 0.0, 0),
    (1, 512, 512, 16, 16, 64, False, 0, 0.0, 0),
    (2, 100, 150, 8, 4, 64, False, 0, 0.0, 0),
    (1, 48, 300, 6, 3, 128, True, 64, 0.0, 252),
    (1, 512, 512, 8, 4, 128, True, 0, 50.0, 0),
    (1, 97, 97, 2, 2, 256, False, 16, 20.0, 0),
    (1, 40, 30, 4, 2, 64, False, 8, 0.0, 30),
    (2, 100, 100, 4, 2, 32, True, 0, 0.0, 0),
    (1, 130, 130, 6, 2, 48, True, 40, 0.0, 0),
    (2, 77, 77, 4, 4, 64, True, 0, 0.0, 0),
    (1, 70, 333, 2, 2, 256, True, 0, 0.0, 263),
    (1, 200, 200, 4, 1, 128, True, 45, 0.0, 0),
    (1, 300, 300, 16, 2, 128, True, 0, 0.0, 0),
    (1, 333, 333, 10, 1, 256, True, 0, 0.0, 0),
    (1, 40, 20, 4, 2, 64, False, 0, 0.0, 0),
    (1, 10, 12, 4, 1, 128, True, 0, 0.0, 2),
    (1, 200, 200, 8, 2, 128, True, 7, 0.0, 0),
    (1, 150, 150, 4, 2, 256, False, 0, 30.0, 0),
    (2, 130, 130, 8, 2, 64, True, 0, 0.0, 0),
    (2, 100, 160, 8, 4, 128, False, 0, 0.0, 0),
])
def test_flash_attention_bwd_matches_plain(cuda, B, Sq, Sk, H, KH, D,
                                           causal, window, softcap,
                                           q_offset):
    """The backward kernel against ``attention_bwd_ref`` on the same o
    and lse at 2e-4 (the forward's bar), and no further from a float64
    backward than twice the plain version's error (plus 1e-6)."""
    q = _randn(Sq + D, B, Sq, H, D).to(cuda)
    k = _randn(Sk + H, B, Sk, KH, D).to(cuda)
    v = _randn(Sk + KH, B, Sk, KH, D).to(cuda)
    do = _randn(Sq + 1, B, Sq, H, D).to(cuda)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=q_offset)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    ops.reset_launch_counts()
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert ops.launch_counts()["flash_attention_bwd"] == 1
    want = ref.attention_bwd_ref(q, k, v, o, do, lse, **kw)
    exact = _attn_grad_fp64(q, k, v, do, **kw)
    torch.cuda.synchronize()
    for g, w, x, name in zip(got, want, exact, ("dq", "dk", "dv")):
        assert g.shape == w.shape and g.dtype == torch.float32, name
        torch.testing.assert_close(g, w, rtol=2e-4, atol=2e-4, msg=name)
        err_k = float((g.double() - x).abs().max())
        err_p = float((w.double() - x).abs().max())
        assert err_k <= 2 * err_p + 1e-6, (name, err_k, err_p)


@pytest.mark.parametrize("window,q_offset,softcap", [
    (0, 0, 0.0), (100, 0, 0.0), (0, 37, 30.0)])
def test_flash_attention_lse_leaves_out_bitwise(cuda, window, q_offset,
                                                softcap):
    """Writing the log-sum-exp changes no bit of o, and it is the rows'
    log-sum-exp of the plain version."""
    q = _randn(1, 2, 300, 8, 64).to(cuda)
    k, v = (_randn(s, 2, 340, 2, 64).to(cuda) for s in (2, 3))
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=q_offset)
    o1 = fa.flash_attention(q, k, v, **kw)
    o2, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    _, want = ref.attention_ref(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert _bitwise(o1, o2)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


# recurrentgemma-like D 256 under a window; a qwen2.5-3b-like GQA layer
@pytest.mark.parametrize("S,H,KH,D,window", [(600, 10, 1, 256, 200),
                                             (1024, 16, 2, 128, 0)])
def test_flash_attention_bwd_is_bitwise_repeatable(cuda, S, H, KH, D,
                                                   window):
    q = _randn(1, 1, S, H, D).to(cuda)
    k, v = (_randn(s, 1, S, KH, D).to(cuda) for s in (2, 3))
    do = _randn(4, 1, S, H, D).to(cuda)
    o, lse = fa.flash_attention(q, k, v, window=window, return_lse=True)
    first = fa.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    second = fa.flash_attention_bwd(q, k, v, o, do, lse, window=window)
    torch.cuda.synchronize()
    assert all(_bitwise(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("B,S,C", [(2, 20, 33), (2, 64, 130), (2, 65, 130),
                                   (3, 129, 257), (1, 4096, 2560)])
def test_rglru_scan_bwd_matches_plain(cuda, B, S, C):
    """The reverse scan against the reverse loop at 1e-5, bit for bit up
    to two chunks, and bit for bit its emulation in plain torch
    (tests/test_torch_tf32x3.py) at every length."""
    from test_torch_tf32x3 import rglru_bwd_chunked
    a, b = (t.to(cuda) for t in _scan_inputs(S, B, S, C))
    dh = _randn(S + 1, B, S, C).to(cuda)
    h = rg.rglru_scan(a, b)
    ops.reset_launch_counts()
    got = rg.rglru_scan_bwd(a, h, dh)
    assert ops.launch_counts()["rglru_scan_bwd"] == 1
    want = ref.rglru_scan_bwd_ref(a, h, dh)
    emul = rglru_bwd_chunked(a, h, dh, rg.CHUNK)
    torch.cuda.synchronize()
    for g, w, e in zip(got, want, emul):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        assert _bitwise(g, e)
        if S <= 2 * rg.CHUNK:
            assert _bitwise(g, w)


def test_ops_gradients_on_the_card_match_the_plain_versions(cuda):
    """``ops``' autograd Functions on CUDA tensors launch the kernels, one
    forward and one backward call each (moe_gemm: one forward, two
    backward), and give the plain versions' gradients (the SSD scan's by
    autograd through its sequential recurrence)."""
    def grads(fn, *xs):
        xs = [x.clone().requires_grad_(True) for x in xs]
        out = fn(*xs)
        return torch.autograd.grad(out, xs, _randn(9, *out.shape).to(
            out.device))

    q = _randn(1, 2, 200, 4, 64).to(cuda)
    k, v = (_randn(s, 2, 200, 2, 64).to(cuda) for s in (2, 3))
    a, b = (t.to(cuda) for t in _scan_inputs(4, 2, 300, 70))
    buf, w = _randn(5, 3, 100, 64).to(cuda), _randn(6, 3, 64, 48).to(cuda)
    ssd = [t.to(cuda) for t in _ssd_inputs(7, 2, 256, 3, 32, 16)]
    for fn, plain, xs, n in (
            (lambda *t: ops.ssd_scan(*t, chunk=64), _ssd_plain, ssd,
             dict(ssd_scan=1, ssd_scan_bwd=1)),
            (lambda *t: ops.flash_attention(*t, window=50),
             lambda *t: ref.attention_ref(*t, window=50), (q, k, v),
             dict(flash_attention=1, flash_attention_bwd=1)),
            (ops.rglru_scan, ref.rglru_scan_ref, (a, b),
             dict(rglru_scan=1, rglru_scan_bwd=1)),
            (ops.moe_gemm, ref.moe_gemm_ref, (buf, w), dict(moe_gemm=3))):
        ops.reset_launch_counts()
        got = grads(fn, *xs)
        counts = ops.launch_counts()
        assert counts == {k: n.get(k, 0) for k in counts}
        want = grads(plain, *xs)
        for g, wnt in zip(got, want):
            torch.testing.assert_close(g, wnt, rtol=2e-4, atol=2e-4)


TRAIN_ARCHS = ("qwen2.5-3b", "recurrentgemma-2b", "pixtral-12b",
               "seamless-m4t-medium", "gemma3-27b", "bmoe-paper",
               "mamba2-2.7b")


def _train_batch(cfg, device, seed=12):
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64))
                            .astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    if cfg.is_encoder_decoder:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 64, cfg.d_model)).astype(np.float32))
    elif cfg.frontend == "vision":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.frontend_tokens, cfg.d_model)).astype(np.float32))
    return {k: v.to(device) for k, v in batch.items()}


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_smoke_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Every family: the loss and its gradients on the card (attention,
    RG-LRU, SSD and MoE products through their kernels, forward and
    backward) against the CPU's at rtol 1e-4 / atol 1e-5, with one flash
    forward and one backward per attention layer, one scan and one reverse
    scan per RG-LRU layer, one SSD scan and one SSD backward per SSM
    layer, 3 + 6 moe_gemm per MoE layer.  The routing is recorded on both
    devices and held equal first."""
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.train import step
    cfg = get_config(arch, smoke=True)
    p_cpu = init_model(cfg, 0, "cpu")
    p = _to(p_cpu, cuda)
    routes = {}
    inner = moe.route

    def route(logits, k, capacity, num_real=0):
        out = inner(logits, k, capacity, num_real)
        routes.setdefault(logits.device.type, []).append(out[1].cpu())
        return out

    moe.route = route
    try:
        lg = step.make_loss_and_grads(cfg, remat=True)
        want = lg(p_cpu, _train_batch(cfg, "cpu"))
        ops.reset_launch_counts()
        got = lg(p, _train_batch(cfg, cuda))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        moe.route = inner
    for a, b in zip(routes.get("cuda", []), routes.get("cpu", [])):
        assert torch.equal(a, b)
    # per layer kind: (in checkpointed blocks, in the remainder); remat
    # runs a checkpointed block's forward again in the backward
    blocks = list(cfg.block_pattern) * cfg.resolved_num_blocks
    n = {}
    for what, hit in (("attn", lambda s: s.kind in ("attn", "local_attn")),
                      ("rglru", lambda s: s.kind == "rglru"),
                      ("ssm", lambda s: s.kind == "ssm"),
                      ("moe", lambda s: s.mlp == "moe")):
        n[what] = (sum(map(hit, blocks)), sum(map(hit, cfg.remainder)))
    if cfg.is_encoder_decoder:
        n["attn"] = (cfg.num_encoder_layers + 2 * cfg.num_layers, 0)
    assert counts == {
        "moe_gemm": 3 * (2 * n["moe"][0] + n["moe"][1]) + 6 * sum(n["moe"]),
        "redundancy_vote": 0, "audit_mlp": 0,
        "flash_attention": 2 * n["attn"][0] + n["attn"][1],
        "flash_attention_bwd": sum(n["attn"]),
        "rglru_scan": 2 * n["rglru"][0] + n["rglru"][1],
        "rglru_scan_bwd": sum(n["rglru"]),
        "ssd_scan": 2 * n["ssm"][0] + n["ssm"][1],
        "ssd_scan_bwd": sum(n["ssm"])}
    torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-5, atol=1e-5)
    for (a, b) in zip(tree_flatten(got[2])[0], tree_flatten(want[2])[0]):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5)


def test_card_train_steps_are_bitwise_repeatable(cuda):
    """Two train steps from one state give the same parameters and
    moments, bit for bit (no atomics on the path)."""
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.optim import adamw
    from repro_torch.train import step
    cfg = get_config("recurrentgemma-2b", smoke=True)
    runs = []
    for _ in range(2):
        p = init_model(cfg, 0, cuda)
        st = adamw.init(p)
        fn = step.make_train_step(cfg, adamw.AdamWConfig(lr=1e-3))
        for s in range(2):
            p, st, m = fn(p, st, _train_batch(cfg, cuda, seed=s))
        runs.append(tree_flatten((p, st.m, st.v))[0])
    torch.cuda.synchronize()
    assert all(_bitwise(a, b) for a, b in zip(*runs))


def test_train_launcher_runs_on_the_card(cuda, capsys):
    from repro_torch.launch import train
    hist = train.main(["--arch", "bmoe-paper", "--steps", "3", "--batch",
                       "2", "--seq", "32"])
    assert len(hist) == 3 and all(np.isfinite(r["loss"]) for r in hist)
    assert "[train] done" in capsys.readouterr().out


def test_train_launcher_trains_mamba2_on_the_card(cuda, capsys):
    """The launcher's mamba2 run (smoke width, (2, 256): two chunks of
    128) takes two steps on the card, each through the SSD kernels forward
    and backward."""
    from repro_torch.launch import train
    ops.reset_launch_counts()
    hist = train.main(["--arch", "mamba2-2.7b", "--steps", "2", "--batch",
                       "2", "--seq", "256"])
    assert len(hist) == 2 and all(np.isfinite(r["loss"]) for r in hist)
    assert ops.launch_counts()["ssd_scan_bwd"] == 2 * get_config(
        "mamba2-2.7b", smoke=True).num_layers
    assert "[train] done" in capsys.readouterr().out


# ------------------------------------------------ federated training
_FED_TRUST = dict(chunks_per_expert=4, audit_rate=1.0, challenge_window=2)


def _fed_run(device, rounds, **kw):
    """A federated run at the paper's expert width (10 edges, 10 experts,
    top-3, 784->256->10, 4 local steps of 64) on 2,000 samples of the
    Fashion-MNIST-like set, from the port's seed-0 init, with its launch
    counts from just before the first round to just after the flush."""
    from repro_torch import fed
    from repro_torch.data.synthetic import FMNIST, make_image_dataset
    x, y, _, _ = make_image_dataset(FMNIST, n_train=2000, n_test=1, seed=0)
    cfg = fed.FedConfig(num_edges=10, num_experts=10, experts_per_edge=2,
                        top_k=3, hidden=256, local_steps=4, local_batch=64,
                        seed=0, trust=TrustConfig(**_FED_TRUST), **kw)
    co = fed.FedCoordinator(cfg, x, y, device=device)
    ops.reset_launch_counts()
    summaries = []
    for _ in range(rounds):
        s = co.run_round()
        s.pop("agg_root", None)
        summaries.append(s)
    summaries.append(co.flush_trust())
    if co.device.type == "cuda":
        torch.cuda.synchronize()
    return co, summaries, ops.launch_counts()


def test_fed_round_on_the_card_matches_the_cpu(cuda):
    """Two rounds under stragglers, dropouts and a sign-flipping edge on
    the card and on the CPU: every decision equal, the global parameters
    at rtol 1e-5 / atol 1e-5; the dense mixture launches no port kernel,
    as the JAX package's federated step reaches no Pallas kernel."""
    from repro_torch import fed
    kw = dict(straggler_prob=0.2, dropout_prob=0.1,
              attack=fed.FedAttack(malicious_edges=(2,),
                                   update_attack="sign_flip", scale=5.0))
    card, s_card, counts = _fed_run(cuda, 2, **kw)
    cpu, s_cpu, _ = _fed_run("cpu", 2, **kw)
    assert s_card == s_cpu
    assert any(s["rejected"] for s in s_card[:-1])
    assert counts == dict.fromkeys(counts, 0)
    np.testing.assert_allclose(fed.tree_to_flat(card.global_params),
                               fed.tree_to_flat(cpu.global_params),
                               rtol=1e-5, atol=1e-5)


def test_fed_card_runs_are_bitwise_and_replay_to_the_clean_twin(cuda):
    """Plain torch, no deterministic switch: two seeded runs with a
    dishonest aggregator hold the same bits, and the convicted chain,
    replayed on the card, the clean twin's."""
    from repro_torch import fed
    atk = fed.FedAttack(malicious_edges=(1,), dishonest_aggregator=True)
    a, sa, _ = _fed_run(cuda, 3, attack=atk)
    b, sb, _ = _fed_run(cuda, 3, attack=atk)
    clean, _, _ = _fed_run(cuda, 3)
    assert sa == sb
    assert a.obs_report()["fed"]["convictions"] >= 1
    assert a.obs_report()["fed"]["replayed_rounds"] >= 1
    for other in (b, clean):
        assert fed.tree_to_flat(a.global_params).tobytes() == \
            fed.tree_to_flat(other.global_params).tobytes()


def test_edge_mesh_on_the_card_is_bitwise_mesh_off(cuda, tmp_path):
    """B-MoE on a 2-shard edge mesh, two ranks sharing the card over gloo
    (``spawn_edges``), 4 experts: ``bmoe`` under 3 colluders and
    ``optimistic`` with a cheating executor (audited, convicted, replayed)
    hold the one-device system's parameters, roots, chain, counters and
    logits bit for bit.  The kernel library is built here first, so the
    ranks only load it."""
    import torch_mesh_ranks as ranks
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import spawn_edges
    build.library()
    spawn_edges(ranks.card_rank, 2, args=(str(tmp_path),), device="cuda",
                rendezvous_dir=str(tmp_path), timeout_s=300)
    got = []
    for r in range(2):
        with open(tmp_path / f"rank{r}.pkl", "rb") as f:
            got.append(pickle.load(f))
    for fw in ("bmoe", "optimistic"):
        want = ranks.card_case(fw, "off")
        for res in got:
            assert res[fw] == want, fw
    assert got[0]["optimistic"]["host"]["stats"]["rolled_back"] >= 1
