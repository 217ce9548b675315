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
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm
from repro.kernels.redundancy_vote import pairwise_agreement as jax_agree
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ops, ref
from repro_torch.kernels import redundancy_vote as rv

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


def test_vote_refuses_what_the_kernel_cannot_take():
    pub = torch.zeros(2, rv.MAX_EDGES + 1, 8)
    with pytest.raises(ValueError, match="copies"):
        ops.redundancy_vote_masked(pub, torch.ones(rv.MAX_EDGES + 1))
    with pytest.raises(TypeError):
        ops.redundancy_vote_masked(torch.zeros(2, 3, 8, dtype=torch.float64),
                                   torch.ones(3))
    with pytest.raises(ValueError, match="active"):
        ops.redundancy_vote_masked(torch.zeros(2, 3, 8), torch.ones(4))
    with pytest.raises(ValueError, match="CUDA"):
        rv.redundancy_vote_masked(torch.zeros(2, 3, 8), torch.ones(3))
