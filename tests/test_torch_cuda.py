"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Imports torch and repro_torch only (no JAX), so it runs on a
machine with a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a CUDA device every test skips (decided at run time, in the
fixture, so every test collects the same everywhere)."""
import numpy as np
import pytest
import torch

from repro_torch.core.attacks import AttackConfig
from repro_torch.core.bmoe import BMoEConfig, BMoESystem
from repro_torch.kernels import moe_gemm as mg
from repro_torch.kernels import ops, ref
from repro_torch.kernels import redundancy_vote as rv

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
    (10, 376, 784, 256, torch.bfloat16), (2, 100, 50, 70, torch.bfloat16)])
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
    (3, 32, 300, 15, (), False), (2, 1, 7, 0, (), False)])
def test_vote_kernel_matches_plain(cuda, E, M, T, n_bad, inactive, specials):
    pub = _pub(E + T, E, M, T, n_bad, specials).to(cuda)
    active = torch.ones(M, device=cuda)
    active[list(inactive)] = 0.0
    got = rv.redundancy_vote_masked(pub, active)
    want = ref.redundancy_vote_masked_ref(pub, active)
    torch.cuda.synchronize()
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_evaluate_launches_the_kernels(cuda):
    x = _randn(0, 1000, 784).numpy()
    y = np.zeros(1000, np.int64)
    sys_b = BMoESystem(BMoEConfig(), device=cuda)
    ops.reset_launch_counts()
    sys_b.evaluate(x, y, attack=AttackConfig())
    assert ops.launch_counts() == {"moe_gemm": 2, "redundancy_vote": 1}
