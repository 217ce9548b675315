"""The port's LM train step against the JAX package's, on the CPU, at
smoke width, one test per config the JAX package declares.

Both packages start from the weights of JAX's ``init_model`` (carried
across with ``lm_params_from_numpy``) and take the batch of
``tests/test_arch_smoke.py``.  The step's gradients are read where both
packages hand them to ``adamw.update`` (its module attribute wrapped), so
JAX's ``make_train_step(remat=False)`` runs as it is, eagerly.  Held: loss
and aux at 1e-5, gradients leaf by leaf at rtol 1e-4 / atol 1e-5, the
gradient norm at 1e-5 and the learning rate.

Gradients are compared, not the parameters after the step: at step 1
AdamW moves every weight by lr times m / sqrt(v) = +-1, so a gradient
near 0 whose sign differs between the packages moves a weight by 2 lr.
The update itself is held on identical gradients in
``tests/test_torch_lm_train.py``.  On the CPU the port's attention, RG-LRU
and MoE products run their plain versions forward and backward (mamba2
its plain SSD recurrence, through autograd).  For the MoE models both
packages' routing is recorded first and held equal, assignment by
assignment, so a near-tie that routes differently fails as one rather
than as a gradient far off."""
import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro.train import step as jstep
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.train import step
from test_arch_smoke import _batch_for


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@contextlib.contextmanager
def one_thread():
    """Bit-for-bit claims between two CPU runs hold on one intra-op
    thread: with several, a CPU GEMM's blocking can follow the threads it
    gets on a loaded machine, and two identical calls then round apart."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree.detach().numpy()
                                 if isinstance(tree, torch.Tensor) else tree)


def spy_updates(monkeypatch):
    """Wrap both packages' ``adamw.update``: each call's gradients are
    recorded (numpy) before the update runs."""
    rec = {"jax": [], "torch": []}

    def wrap(mod, key, conv):
        inner = mod.update

        def update(cfg, grads, state, params):
            rec[key].append(conv(grads))
            return inner(cfg, grads, state, params)
        monkeypatch.setattr(mod, "update", update)

    wrap(jadamw, "jax", _np)
    wrap(adamw, "torch", lambda g: dict(_paths(g)))
    return rec


def both_steps(jcfg, cfg, jbatch, rec, remat=False):
    """One train step in each package from JAX's init_model weights:
    (JAX metrics, port metrics, JAX grads by path, port grads by path)."""
    jp = jloop.init_model(jcfg, seed=0)
    p = lm_params_from_numpy(_np(jp), device="cpu")
    opt = dict(total_steps=10)
    _, _, jm = jstep.make_train_step(jcfg, jadamw.AdamWConfig(**opt),
                                     remat=False)(jp, jadamw.init(jp),
                                                  jbatch)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    _, _, m = step.make_train_step(cfg, adamw.AdamWConfig(**opt),
                                   remat=remat)(p, adamw.init(p), batch)
    return ({k: float(v) for k, v in jm.items()},
            {k: float(v) for k, v in m.items()},
            dict(_paths(rec["jax"][-1])), rec["torch"][-1])


def assert_step_close(jm, m, jg, g):
    for k in ("loss", "aux_loss", "grad_norm"):
        np.testing.assert_allclose(m[k], jm[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(m["lr"], jm["lr"], rtol=1e-7, atol=0)
    assert sorted(g) == sorted(jg)
    for path in jg:
        assert g[path].shape == jg[path].shape, path
        np.testing.assert_allclose(g[path], jg[path], rtol=1e-4, atol=1e-5,
                                   err_msg=path)


def routing_both(jcfg, cfg, jbatch, monkeypatch):
    """Every MoE call's routing in both packages' forward on the batch
    (the step's routing; JAX eager and unrolled, the port without
    autograd): per call, JAX's smallest top-k margin over the real
    experts (the k-th router logit minus the (k+1)-th) and both packages'
    (expert id, position, keep) as numpy."""
    rec = {"jax": [], "torch": []}

    def wrap(mod, key):
        inner = mod.route

        def route(logits, k, capacity, num_real=0):
            out = inner(logits, k, capacity, num_real)
            rec[key].append(tuple(np.asarray(a) for a in
                                  (logits, out[1], out[2], out[3])))
            return out
        monkeypatch.setattr(mod, "route", route)

    wrap(jmoe, "jax")
    wrap(moe, "torch")
    jp = jloop.init_model(jcfg, seed=0)
    jtfm.forward_train(jp, jbatch["tokens"], jcfg, remat=False, unroll=True,
                       prefix_embeds=jbatch.get("patches"))
    with torch.no_grad():
        tfm.forward_train(lm_params_from_numpy(_np(jp), device="cpu"),
                          torch.from_numpy(np.array(jbatch["tokens"])), cfg)
    monkeypatch.undo()
    margins = []
    for j in rec["jax"]:
        top = -np.sort(-np.asarray(j[0], np.float64)[..., :jcfg.num_experts],
                       axis=-1)
        k = jcfg.num_experts_per_tok
        margins.append(float((top[..., k - 1] - top[..., k]).min()))
    return margins, rec


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_jax(arch, monkeypatch):
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jbatch = _batch_for(jcfg, jax.random.PRNGKey(1))
    if jcfg.num_experts:
        # routing is discrete: both packages must route every assignment
        # alike for the gradients to be comparable.  The margin says how
        # far the batch is from a tie (llama4-maverick's smoke batch has
        # one at 4.4e-5, routed alike all the same)
        margins, routes = routing_both(jcfg, cfg, jbatch, monkeypatch)
        assert len(routes["jax"]) == len(routes["torch"]) > 0
        for n, (j, t) in enumerate(zip(routes["jax"], routes["torch"])):
            for a, b, what in zip(j[1:], t[1:], ("expert_id", "position",
                                                  "keep")):
                np.testing.assert_array_equal(
                    b.astype(a.dtype), a,
                    err_msg=f"MoE call {n} {what} (JAX's smallest top-k "
                            f"margin {margins[n]:.3g})")
    rec = spy_updates(monkeypatch)
    ops.reset_launch_counts()
    assert_step_close(*both_steps(jcfg, cfg, jbatch, rec))
    # the CPU route launches no kernel, forward or backward
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "bmoe-paper"])
def test_microbatched_step_matches_jax_scan(arch, monkeypatch):
    """train_microbatches = 2: the port's loop over microbatches against
    JAX's ``scan``, gradients accumulated / K in the same order."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               train_microbatches=2)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              train_microbatches=2)
    jbatch = _batch_for(jcfg, jax.random.PRNGKey(1))
    rec = spy_updates(monkeypatch)
    assert_step_close(*both_steps(jcfg, cfg, jbatch, rec))


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "bmoe-paper",
                                  "seamless-m4t-medium"])
def test_remat_is_bitwise_the_plain_step(arch, monkeypatch):
    """Checkpointed blocks recompute the same bits: loss and every
    gradient equal with remat on and off."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    jbatch = _batch_for(jcfg, jax.random.PRNGKey(1))
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    p = lm_params_from_numpy(_np(jloop.init_model(jcfg, seed=0)),
                             device="cpu")
    with one_thread():
        out = [step.make_loss_and_grads(cfg, remat=r)(p, batch)
               for r in (False, True)]
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    g0, g1 = dict(_paths(out[0][2])), dict(_paths(out[1][2]))
    assert all(np.array_equal(g0[k], g1[k]) for k in g0)
