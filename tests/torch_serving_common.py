"""Shared helpers of the serving parity tests (``tests/test_torch_serving*.py``):
one request trace, two engines (the JAX package's and the port's) built
from the same numpy weights and the same knobs, and a record of the JAX
run's greedy margins.

Greedy decoding is discrete: where the JAX run's top-1 and top-2 logits
nearly tie, float rounding may pick the other token in the port.  The
tests record the JAX run's smallest top-1/top-2 margin over every row
that advances (``jax_margins``) and assert it above 1e-4 before they
compare streams, so such a near-tie is reported as one."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import transformer as jtfm
from repro.models.builder import materialize as jmaterialize
from repro.serve.engine import EdgeStorageConfig as JEdge
from repro.serve.engine import ServingEngine as JEngine
from repro.storage.kv import KVStorageConfig as JKV
from repro.train.loop import init_model as jinit
from repro.trust.protocol import TrustConfig as JTrust
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.serve.engine import EdgeStorageConfig, ServingEngine
from repro_torch.storage.kv import KVStorageConfig
from repro_torch.train.step import make_serve_chunk_step
from repro_torch.trust.protocol import TrustConfig

MARGIN = 1e-4


def models(arch, **replace):
    """(JAX cfg, JAX params, port cfg, port params on the CPU): the JAX
    package's seed-0 weights carried across as numpy."""
    import dataclasses
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), **replace)
    cfg = dataclasses.replace(get_config(arch, smoke=True), **replace)
    jp = jinit(jcfg, seed=0)
    tp = lm_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                              device="cpu")
    return jcfg, jp, cfg, tp


def req(rid, plen, new, vocab=64, seed=None):
    rng = np.random.default_rng(rid if seed is None else seed)
    return {"id": rid,
            "prompt": rng.integers(0, vocab, size=plen).astype(np.int32),
            "max_new_tokens": new}


def copies(reqs):
    return [dict(r, prompt=np.array(r["prompt"])) for r in reqs]


@contextlib.contextmanager
def jax_margins():
    """Record, for every JAX decode micro-step traced while the block is
    open, each advancing row's top-1/top-2 logit margin (a list that
    fills as the compiled steps run)."""
    rec = []
    inner = jtfm.forward_decode

    def wrapped(params, caches, tokens, pos, cfg, **kw):
        out = inner(params, caches, tokens, pos, cfg, **kw)
        top = jax.lax.top_k(out[0][:, -1], 2)[0]
        mask = kw.get("write_mask")
        if mask is None:
            mask = jnp.ones(top.shape[:1], bool)
        jax.debug.callback(
            lambda m, w: rec.append(np.asarray(m)[np.asarray(w)]),
            top[:, 0] - top[:, 1], mask)
        return out

    jtfm.forward_decode = wrapped
    try:
        yield rec
    finally:
        jtfm.forward_decode = inner


def assert_no_near_tie(rec):
    m = min((float(a.min()) for a in rec if a.size), default=np.inf)
    assert rec and m > MARGIN, (
        f"a greedy near-tie in the JAX run (top-1/top-2 margin {m:.3g}): "
        f"the packages may pick different tokens there")


def engines(models_, *, trust=None, kv=None, edge=None, **kw):
    """The JAX package's engine and the port's, with the same knobs:
    ``trust``, ``kv`` and ``edge`` are the keyword dicts of each
    package's TrustConfig, KVStorageConfig and EdgeStorageConfig."""
    jcfg, jp, cfg, tp = models_
    def make(cls, knobs):
        return None if knobs is None else cls(**knobs)

    j = JEngine(jcfg, jp, trust=make(JTrust, trust),
                kv_storage=make(JKV, kv),
                expert_storage=make(JEdge, edge), **kw)
    t = ServingEngine(cfg, tp, trust=make(TrustConfig, trust),
                      kv_storage=make(KVStorageConfig, kv),
                      expert_storage=make(EdgeStorageConfig, edge), **kw)
    return j, t


def serve_both(models_, reqs, **kw):
    """Serve ``reqs`` in both packages to the end; the JAX run's greedy
    margins are checked.  Returns (JAX engine, its completed, port
    engine, its completed)."""
    j, t = engines(models_, **kw)
    with jax_margins() as rec:
        j.submit(copies(reqs))
        jd = j.run()
    assert_no_near_tie(rec)
    t.submit(copies(reqs))
    return j, jd, t, t.run()


def verdicts(eng, done):
    return {rid: ("revoked" if eng.records[rid].revoked
                  else "finalized" if rid in done else "open")
            for rid in eng.records}


def tick_rows(eng):
    return [(tc.tick, tc.root, tc.request_ids) for tc in eng.tick_commitments]


# ---------------------------------------------------- forward_serve_chunk
def _random_caches(jcfg, B, L, seed):
    caches = jmaterialize(jtfm.cache_decl(jcfg, B, L), jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: rng.standard_normal(np.shape(a)).astype(np.float32),
        caches)


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [clone(v) for v in tree]
    return tree.clone()


def trees(fn, a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            trees(fn, a[k], b[k], f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            trees(fn, x, y, f"{path}/{i}")
    else:
        fn(a, b, path)


def serve_chunk_case(models_, expert_stats=False):
    """Four slots, C = 4: a prefilling slot that finishes its prompt
    inside the chunk, a decoding slot, an idle slot, and a slot whose
    prefill is capped at 2 columns; random caches.  Returns both
    packages' outputs and the port's input caches."""
    jcfg, jp, cfg, tp = models_
    B, C, L = 4, 4, 16
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (B, C)).astype(np.int32)
    tokens[1:3] = 0
    tokens[3, 2:] = 0
    start = np.array([0, 17, 0, 0], np.int32)
    pos = np.array([3, 7, 0, 5], np.int32)
    lengths = np.array([3, 0, 0, 2], np.int32)
    adv = np.array([4, 4, 0, 2], np.int32)
    caches = _random_caches(jcfg, B, L, seed=6)
    with jax_margins() as rec:
        jout = jax.jit(lambda p, c: jtfm.forward_serve_chunk(
            p, c, tokens, start, pos, lengths, adv, jcfg,
            expert_stats=expert_stats))(jp, caches)
        jax.block_until_ready(jout)
    assert_no_near_tie(rec)
    tcaches = lm_params_from_numpy(caches, device="cpu")
    before = clone(tcaches)
    step = make_serve_chunk_step(cfg, expert_stats=expert_stats)
    out = step(tp, tcaches, {"tokens": tokens, "start": start, "pos": pos,
                             "lengths": lengths, "adv": adv})
    trees(lambda a, b, p: torch.equal(a, b) or pytest.fail(
        f"input cache changed at {p}"), tcaches, before)
    return jout, out, tcaches, adv


def check_serve_chunk(jout, out, tcaches, adv):
    """Tokens exact, caches at 1e-5, rows that do not advance bit for bit
    as they were."""
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jout[0]))
    assert out[0].dtype == torch.int32 and out[0].shape == (4, 4)

    def close(a, b, path):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=path)
    trees(close, out[1], jout[1])

    def idle_unchanged(new, old, path):
        # idle slot 2 and slot 3's rows past its 2 micro-steps
        assert torch.equal(new[:, 2], old[:, 2]), path
        keep = torch.ones(new.shape[2], dtype=torch.bool)
        keep[5:7] = False
        assert torch.equal(new[:, 3, keep], old[:, 3, keep]), path
    trees(idle_unchanged, out[1]["blocks"], tcaches["blocks"])
