"""The port's kernels against the JAX package's, on the CPU.

On a CPU tensor each port wrapper runs its plain PyTorch version; those
are held here against the JAX Pallas kernels run in interpret mode and
against the JAX oracles, on the same numpy inputs.  The CUDA kernels
themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm
from repro.kernels.redundancy_vote import pairwise_agreement as jax_agree
from repro.kernels.ssd_scan import ssd_scan as jax_ssd_scan
from repro.models.layers import blockwise_attention as jax_blockwise
from repro.models.rglru import rglru_scan as jax_rglru_scan
from repro.models.ssm import ssd_chunked as jax_ssd_chunked
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ops, ref
from repro_torch.kernels import redundancy_vote as rv
from repro_torch.kernels import rglru_scan as rg
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import ssm

# tolerances of tests/test_kernels.py: fp32 1e-5, bf16 2e-2 (atol 8x)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _gemm_inputs(seed, E, C, d, f):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((E, C, d)).astype(np.float32),
            rng.standard_normal((E, d, f)).astype(np.float32))


# ------------------------------------------------------------ moe_gemm
@pytest.mark.parametrize("E,C,d,f,dtype,block", [
    (2, 100, 50, 70, "float32", 32),       # the non-divisible JAX case
    (3, 40, 96, 16, "float32", 128),
    (1, 8, 32, 128, "float32", 128),
    (2, 100, 50, 70, "bfloat16", 32),
    (4, 200, 128, 192, "bfloat16", 128),
])
def test_moe_gemm_plain_matches_pallas(E, C, d, f, dtype, block):
    buf, w = _gemm_inputs(E * 1000 + C, E, C, d, f)
    want = jax_moe_gemm(jnp.asarray(buf, JDT[dtype]), jnp.asarray(w, JDT[dtype]),
                        block_c=block, block_d=block, block_f=block,
                        interpret=True)
    got = ops.moe_gemm(torch.from_numpy(buf).to(TDT[dtype]),
                       torch.from_numpy(w).to(TDT[dtype]))
    assert got.dtype == TDT[dtype] and got.shape == (E, C, f)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol * 8)


def test_moe_gemm_plain_matches_jax_oracle():
    buf, w = _gemm_inputs(7, 10, 376, 784, 10)
    got = ref.moe_gemm_ref(torch.from_numpy(buf), torch.from_numpy(w))
    want = jref.moe_gemm_ref(jnp.asarray(buf), jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-5, atol=8e-5)


def test_moe_gemm_dispatch_follows_device():
    buf, w = (torch.from_numpy(a) for a in _gemm_inputs(1, 2, 8, 4, 3))
    assert ops.kernel_route(buf) == "plain"
    before = ops.launch_counts()["moe_gemm"]
    ops.moe_gemm(buf, w)
    assert ops.launch_counts()["moe_gemm"] == before   # plain: no launch
    with pytest.raises(ValueError, match="CUDA"):
        mg.moe_gemm(buf, w)                            # the kernel wrapper
    with pytest.raises(ValueError, match="mismatch"):
        ops.moe_gemm(buf, w[:, :3])
    with pytest.raises(TypeError):
        ops.moe_gemm(buf.double(), w.double())


# ----------------------------------------------------- redundancy vote
@pytest.mark.parametrize("E,M,T,n_bad", [(1, 3, 7, 0), (4, 5, 64, 1),
                                         (10, 10, 1500, 2), (4, 10, 100, 3)])
def test_pairwise_agreement_plain_matches_pallas(E, M, T, n_bad):
    rng = np.random.default_rng(E + M + T)
    pub = np.broadcast_to(rng.standard_normal((E, 1, T)),
                          (E, M, T)).astype(np.float32).copy()
    pub[:, :n_bad] += rng.standard_normal((E, n_bad, T)).astype(np.float32)
    got = ref.pairwise_agreement_ref(torch.from_numpy(pub))
    tile = 64
    want = np.asarray(jax_agree(jnp.asarray(pub), interpret=True, tile=tile))
    pad = (-T) % min(tile, T)      # the Pallas kernel's zero-pad offset
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want - pad)


def _vote_pub(seed, E, M, T, n_bad, colluding=True, specials=False):
    rng = np.random.default_rng(seed)
    pub = np.broadcast_to(rng.standard_normal((E, 1, T)),
                          (E, M, T)).astype(np.float32).copy()
    if n_bad:
        shape = (E, 1, T) if colluding else (E, n_bad, T)
        pub[:, M - n_bad:] += 5.0 * rng.standard_normal(shape).astype(
            np.float32)
    if specials:
        pub[0, 1, 3] = np.nan            # copy 1 disagrees even with itself
        pub[1, :, 5] = np.inf            # inf - inf: no copy agrees
        pub[2, 0, T - 1] = -np.inf
    return pub


@pytest.mark.parametrize("E,M,T,n_bad,colluding,inactive,specials", [
    (4, 10, 60, 3, True, (), False),
    (4, 10, 60, 6, True, (), False),
    (4, 10, 60, 3, False, (), False),
    (4, 10, 60, 4, True, (0, 2), False),   # excluded edges barred
    (4, 10, 60, 0, True, (1, 5, 9), False),
    (4, 10, 60, 1, True, (), True),        # NaN and +-inf copies
    (4, 10, 60, 2, True, tuple(range(10)), False),   # nobody electable
])
def test_masked_vote_plain_matches_jax(E, M, T, n_bad, colluding, inactive,
                                       specials):
    pub = _vote_pub(E * M + T, E, M, T, n_bad, colluding, specials)
    active = np.ones(M, np.float32)
    active[list(inactive)] = 0.0
    jt, js, jf = jref.redundancy_vote_masked_ref(jnp.asarray(pub),
                                                 jnp.asarray(active))
    tt, ts, tf = ops.redundancy_vote_masked(torch.from_numpy(pub),
                                            torch.from_numpy(active))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert ts.dtype == torch.int32 and tf.dtype == torch.int32


@pytest.mark.parametrize("M,n_bad", [(10, 3), (10, 4), (5, 2), (3, 1)])
def test_vote_rejects_minority(M, n_bad):
    """Twin of test_kernels.py: a colluding minority never flips it."""
    pub = _vote_pub(0, 4, M, 128, n_bad)
    honest = pub[:, 0]
    trusted, support, flags = ops.redundancy_vote_masked(
        torch.from_numpy(pub), torch.ones(M))
    np.testing.assert_array_equal(trusted.numpy(), honest)
    assert int(support.min()) == M - n_bad
    assert (flags[:, M - n_bad:] == 0).all() and (flags[:, :M - n_bad] == 1).all()


def test_vote_majority_collusion_wins():
    """Twin of test_kernels.py: > 50% colluding attackers mislead."""
    pub = _vote_pub(0, 2, 10, 32, 6)
    trusted, support, _ = ops.redundancy_vote_masked(torch.from_numpy(pub),
                                                     torch.ones(10))
    assert not np.allclose(trusted.numpy(), pub[:, 0])
    assert int(support.min()) == 6


def test_redundancy_vote_plain_matches_jax_oracle():
    pub = _vote_pub(3, 4, 7, 5 * 6, 3).reshape(4, 7, 5, 6)
    jt, js = jref.redundancy_vote_ref(jnp.asarray(pub))
    tt, ts = ref.redundancy_vote_ref(torch.from_numpy(pub))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("n_bad,colluding,inactive", [
    (19, True, ()),                 # a colluding minority of 40: filtered
    (21, True, ()),                 # a colluding majority: elected
    (13, False, (0, 33, 39)),       # independent corruption, barred edges
])
def test_masked_vote_past_32_edges_matches_jax(n_bad, colluding, inactive):
    """M = 40 takes two disagreement words per copy in the CUDA kernel;
    the plain route takes any M, as JAX's reference does."""
    E, M, T = 3, 40, 50
    pub = _vote_pub(M + n_bad, E, M, T, n_bad, colluding)
    active = np.ones(M, np.float32)
    active[list(inactive)] = 0.0
    jt, js, jf = jref.redundancy_vote_masked_ref(jnp.asarray(pub),
                                                 jnp.asarray(active))
    tt, ts, tf = ops.redundancy_vote_masked(torch.from_numpy(pub),
                                            torch.from_numpy(active))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    honest = M - n_bad - sum(i < M - n_bad for i in inactive)
    if n_bad * 2 < M:
        np.testing.assert_array_equal(tt.numpy(), pub[:, 0])
        assert (ts.numpy() == honest).all()
    else:
        assert not np.allclose(tt.numpy(), pub[:, 0])
        assert (ts.numpy() == n_bad).all()


def test_vote_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="copy"):
        ops.redundancy_vote_masked(torch.zeros(2, 0, 8), torch.ones(0))
    with pytest.raises(TypeError):
        ops.redundancy_vote_masked(torch.zeros(2, 3, 8, dtype=torch.float64),
                                   torch.ones(3))
    with pytest.raises(ValueError, match="active"):
        ops.redundancy_vote_masked(torch.zeros(2, 3, 8), torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        rv.redundancy_vote_masked(torch.zeros(2, 3, 8), torch.ones(3))


# ----------------------------------------------------- flash attention
def _qkv(seed, B, Sq, Sk, H, KH, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, H, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, D)).astype(np.float32),
            rng.standard_normal((B, Sk, KH, D)).astype(np.float32))


# tests/test_kernels.py's grid (B, S, H, KH, D, causal, window), then
# D=256 (recurrentgemma), MQA and GQA with softcap
FLASH_CASES = [
    (1, 64, 2, 1, 32, True, 0), (2, 128, 4, 2, 64, True, 32),
    (1, 256, 4, 1, 32, False, 0), (2, 64, 2, 2, 64, False, 32),
    (1, 128, 4, 4, 32, True, 0), (2, 256, 2, 1, 64, True, 32),
    (1, 128, 2, 1, 256, True, 64), (1, 128, 8, 1, 64, True, 0),
    (1, 128, 8, 4, 128, True, 0),
]


@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("B,S,H,KH,D,causal,window", FLASH_CASES)
def test_flash_attention_plain_matches_jax(B, S, H, KH, D, causal, window,
                                           softcap):
    """The plain version against JAX's attention_ref at 1e-5 and the
    Pallas kernel (interpret mode, bq = bk = 64) at 2e-4, the JAX bar."""
    q, k, v = _qkv(S + H + D, B, S, S, H, KH, D)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window, softcap=softcap)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    pallas = jax_flash(*(jnp.moveaxis(jnp.asarray(a), 1, 2)
                         for a in (q, k, v)),
                       causal=causal, window=window, softcap=softcap,
                       bq=64, bk=64, interpret=True)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jnp.moveaxis(pallas, 2, 1)),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("B,Sq,Sk,H,KH,D,causal,window", [
    (2, 1000, 1000, 4, 2, 64, False, 0),     # chip_smoke's ragged case
    (1, 77, 77, 2, 1, 32, True, 16),
    (1, 40, 40, 4, 1, 256, True, 32),
    (2, 33, 70, 2, 2, 64, False, 0),
])
def test_flash_attention_plain_ragged_matches_jax_ref(B, Sq, Sk, H, KH, D,
                                                      causal, window):
    """Ragged lengths: the Pallas kernel refuses them, so only JAX's
    attention_ref holds the plain version here."""
    q, k, v = _qkv(Sq + Sk, B, Sq, Sk, H, KH, D)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window)
    want = jref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("q_offset,window", [(24, 0), (24, 16), (100, 8)])
def test_flash_attention_q_offset_matches_jax_blockwise(q_offset, window):
    """Chunked prefill: queries at absolute positions q_offset + i against
    keys from 0, held against JAX's blockwise_attention.  At q_offset 100
    with window 8 every key is masked for every row (all keys lie below
    the window), and both average v over the keys."""
    q, k, v = _qkv(q_offset, 1, 16, 40, 4, 2, 32)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              window=window, q_offset=q_offset)
    want = jax_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, window=window, q_offset=q_offset,
                         q_chunk=8, kv_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


def test_flash_attention_dispatch_follows_device():
    q, k, v = (torch.from_numpy(a) for a in _qkv(0, 1, 8, 8, 2, 1, 32))
    before = ops.launch_counts()["flash_attention"]
    ops.flash_attention(q, k, v)
    assert ops.launch_counts()["flash_attention"] == before   # plain
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, k, v)                     # the kernel wrapper
    with pytest.raises(ValueError, match="multiple"):
        ops.flash_attention(q[:, :, :1].expand(1, 8, 3, 32),
                            torch.cat([k, k], 2), torch.cat([v, v], 2))
    with pytest.raises(ValueError, match="mismatch"):
        ops.flash_attention(q, k, v[:, :4])
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=-1)


# ------------------------------------------------------- RG-LRU scan
def _ab(seed, B, S, C):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.5, 1.0, (B, S, C)).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,S,C", [(1, 64, 128), (2, 40, 256), (3, 1000, 300),
                                   (1, 7, 5)])
def test_rglru_scan_plain_matches_jax(B, S, C):
    """The sequential loop against JAX's associative scan at 2e-4 (not
    against the Pallas kernel, whose own test fails on this tree)."""
    a, b = _ab(S + C, B, S, C)
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(b))
    assert got.dtype == torch.float32 and got.shape == (B, S, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("B,S,C", [(2, 128, 40), (2, 200, 33), (2, 20, 9),
                                   (3, 1, 5), (1, 1000, 300)])
def test_rglru_chunked_matches_jax(B, S, C):
    """The CUDA kernel's chunked association (chunks of rg.CHUNK = 64,
    emulated step for step in tests/test_torch_tf32x3.py) against JAX's
    associative scan at 2e-4 and the sequential loop at 1e-5: whole
    chunks, a ragged last chunk, S below one chunk, S = 1."""
    from test_torch_tf32x3 import rglru_chunked
    a, b = _ab(S + C + 1, B, S, C)
    got = rglru_chunked(torch.from_numpy(a), torch.from_numpy(b), rg.CHUNK)
    want = jax_rglru_scan(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    torch.testing.assert_close(got, ops.rglru_scan(torch.from_numpy(a),
                                                   torch.from_numpy(b)),
                               rtol=1e-5, atol=1e-5)


def test_rglru_scan_dispatch_follows_device():
    a, b = (torch.from_numpy(x) for x in _ab(0, 1, 8, 4))
    before = ops.launch_counts()["rglru_scan"]
    ops.rglru_scan(a, b)
    assert ops.launch_counts()["rglru_scan"] == before
    with pytest.raises(ValueError, match="CUDA"):
        rg.rglru_scan(a, b)
    with pytest.raises(ValueError, match="shape"):
        ops.rglru_scan(a, b[:, :4])
    with pytest.raises(TypeError):
        ops.rglru_scan(a.double(), b.double())


# ------------------------------------------------------------ SSD scan
def _ssd_inputs(seed, B, S, H, P, N, state=False):
    """Drawn as tests/test_kernels.py draws them: dt = 0.1 softplus(z),
    A = -|z| - 0.1, B and C at scale 0.5."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = (np.logaddexp(0.0, rng.standard_normal((B, S, H))) * 0.1).astype(
        np.float32)
    A = (-np.abs(rng.standard_normal(H)) - 0.1).astype(np.float32)
    Bm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, S, N)) * 0.5).astype(np.float32)
    s0 = (rng.standard_normal((B, H, P, N)) if state
          else np.zeros((B, H, P, N))).astype(np.float32)
    return x, dt, A, Bm, Cm, s0


def test_ssd_scan_ref_matches_jax_ref():
    """The sequential recurrence from a non-zero state: y and the state."""
    args = _ssd_inputs(0, 2, 50, 3, 16, 8, state=True)
    y, st = ref.ssd_scan_ref(*map(torch.from_numpy, args))
    jy, jst = jref.ssd_scan_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=1e-5,
                               atol=1e-5)


# tests/test_kernels.py's grid (B, S, H, P, N, chunk): every value of each
# axis appears, and the single-chunk case of chip_smoke.py
SSD_CASES = [
    (1, 64, 1, 16, 8, 32), (2, 256, 3, 16, 8, 32), (1, 256, 3, 32, 16, 64),
    (2, 64, 1, 32, 16, 64), (1, 64, 3, 32, 8, 32), (2, 256, 1, 16, 16, 64),
    (1, 48, 2, 32, 32, 128),
]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_ssd_scan_plain_matches_pallas(B, S, H, P, N, chunk):
    """ops.ssd_scan on the CPU (the sequential recurrence from zero)
    against the Pallas kernel in interpret mode, at the JAX bar 2e-4."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(S + P + N, B, S, H, P, N)
    ops.reset_launch_counts()
    got = ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                       chunk=chunk)
    assert ops.launch_counts()["ssd_scan"] == 0               # CPU: plain
    want = jax_ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=chunk,
                        interpret=True)
    assert got.dtype == torch.float32 and got.shape == (B, S, H, P)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("S,chunk", [(64, 16), (96, 32), (40, 40)])
def test_ssd_chunked_matches_jax(S, chunk):
    """The port's chunked form from a non-zero state against JAX's."""
    args = _ssd_inputs(S, 2, S, 3, 16, 8, state=True)
    y, st = ssm.ssd_chunked(*map(torch.from_numpy, args), chunk)
    jy, jst = jax_ssd_chunked(*map(jnp.asarray, args), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), rtol=2e-4,
                               atol=2e-4)


def test_ssd_scan_refuses_ragged_chunks_and_bad_operands():
    x, dt, A, Bm, Cm = map(torch.from_numpy,
                           _ssd_inputs(1, 1, 96, 2, 16, 8)[:5])
    with pytest.raises(ValueError, match="not divisible"):
        ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)        # 96 % 64
    with pytest.raises(ValueError, match="not divisible"):
        ss.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    ops.ssd_scan(x, dt, A, Bm, Cm, chunk=200)           # one chunk of 96
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan(x, dt, A, Bm, Cm)                   # the kernel wrapper
    with pytest.raises(ValueError, match="mismatch"):
        ops.ssd_scan(x, dt[:, :, :1], A, Bm, Cm)
    with pytest.raises(ValueError, match="mismatch"):
        ops.ssd_scan(x, dt, A, Bm, Cm[..., :4])
    with pytest.raises(TypeError):
        ops.ssd_scan(x.double(), dt, A, Bm, Cm)
