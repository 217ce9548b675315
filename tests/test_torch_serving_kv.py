"""KV paging in the port's serving engine, on the CPU: smollm-360m's and
qwen2.5-3b's smoke configs.

Across packages: prefix CIDs hash token ids only, so ``prefix_cid`` and
``prefix_chain`` equal the JAX package's (by example and by a hypothesis
property), and so do the KV runtime's counters (sealed blocks and bytes,
dedups, warm hits, restored tokens, page-outs, resumes, store, cache and
DA counters) on the same request traces.  KV manifest roots hash float
KV bytes, which differ between XLA's arithmetic and torch's, so they are
held bitwise only inside the port: ``slice_kv_block``/``restore_kv_block``
round trips (fp32 and int8), warm against cold, page-out and resume, and
paging on against off all give the same bits."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.models import transformer as jtfm
from repro.models.builder import materialize as jmaterialize
from repro.storage import kv as jkv
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.core.ledger import tree_flatten
from repro_torch.models import transformer as tfm
from repro_torch.models.builder import materialize
from repro_torch.serve.engine import ServingEngine
from repro_torch.storage import (KV_GENESIS, ExpertCache, ExpertStore,
                                 KVBlockStore, KVStorageConfig,
                                 StorageNetwork, prefix_chain, prefix_cid)

from torch_serving_common import (copies, engines, models, req, serve_both,
                                  tick_rows, verdicts)

KV = {"block_tokens": 8}
TRUST = {"audit_rate": 1.0, "num_verifiers": 1, "challenge_window": 4}


@pytest.fixture(scope="module")
def smollm():
    return models("smollm-360m")


# ------------------------------------------------------- prefix chains
@pytest.mark.parametrize("tokens,T", [
    (list(range(32)), 8), ([5] * 17, 4), ([0, 1, 2], 8), ([], 3),
    (list(range(100, 163)), 16), ([2 ** 31 - 1, -1, 7], 1)])
def test_prefix_chain_matches_jax(tokens, T):
    assert prefix_chain(tokens, T) == jkv.prefix_chain(tokens, T)
    assert prefix_cid(KV_GENESIS, tokens) == \
        jkv.prefix_cid(jkv.KV_GENESIS, tokens)
    assert KV_GENESIS == jkv.KV_GENESIS


@settings(max_examples=60, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=2 ** 20), max_size=64),
       st.integers(min_value=1, max_value=9),
       st.text(max_size=12))
def test_prefix_cids_equal_jax_property(tokens, T, prev):
    assert prefix_chain(tokens, T) == jkv.prefix_chain(tokens, T)
    assert prefix_cid(prev, tokens) == jkv.prefix_cid(prev, tokens)


def test_prefix_cid_binds_token_count():
    full = prefix_cid(KV_GENESIS, np.arange(8))
    assert prefix_cid(KV_GENESIS, np.arange(7)) != full
    assert prefix_chain(np.arange(8), 8) == [full]


# -------------------------------------------- slice / seal / restore
def _random_caches(cfg, batch, cache_len, seed):
    """Every cache leaf filled with random values of its own dtype (int8
    K/V rows and float32 scale rows under ``kv_cache_dtype="int8"``), as
    numpy."""
    caches = materialize(tfm.cache_decl(cfg, batch, cache_len), 0, "cpu")
    rng = np.random.default_rng(seed)

    def fill(a):
        if a.dtype == torch.int8:
            return rng.integers(-127, 128, a.shape).astype(np.int8)
        return rng.standard_normal(a.shape).astype(np.float32)

    return {"blocks": {k: {n: fill(a) for n, a in v.items()}
                       for k, v in caches["blocks"].items()}}


def _leaves(tree):
    return tree_flatten(tree)[0]


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
def test_slice_seal_fetch_restore_bitwise(kv_dtype):
    """A block sliced off the caches equals the JAX package's slice of
    the same arrays, survives chunking, the replicated network and a
    cache-mediated fetch bit for bit (int8 scale leaves included), and
    restores into exactly the rows it came from, leaving its input
    caches as they were."""
    cfg = get_config("smollm-360m", smoke=True)
    if kv_dtype == "int8":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    host = _random_caches(cfg, 2, 24, seed=3)
    caches = lm_params_from_numpy(host, device="cpu")
    block = tfm.slice_kv_block(caches, 1, 4, 12)
    jblock = jtfm.slice_kv_block(jax.tree_util.tree_map(np.asarray, host),
                                 1, 4, 12)
    assert tree_flatten(block)[1] == str(
        jax.tree_util.tree_structure(jblock))
    for a, b in zip(_leaves(block), jax.tree_util.tree_leaves(jblock)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    if kv_dtype == "int8":
        assert any(a.dtype == np.int8 for a in _leaves(block))
        assert "'k_scale'" in tree_flatten(block)[1]

    net = StorageNetwork(num_nodes=4, replication=2, seed=0)
    store = ExpertStore(net, chunk_bytes=1 << 12)
    kv = KVBlockStore(store, ExpertCache(store, None))
    cid = prefix_cid(KV_GENESIS, np.arange(8))
    man = kv.seal(cid, block, 8)
    assert cid in kv and man.total_bytes == sum(a.nbytes
                                                for a in _leaves(block))
    back = kv.fetch(cid, tfm.slice_kv_block(caches, 0, 0, 1))
    for a, b in zip(_leaves(block), _leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)

    zeros = materialize(tfm.cache_decl(cfg, 2, 24), 0, "cpu")
    restored = tfm.restore_kv_block(zeros, 1, 4, back)
    assert all(not a.any() for a in _leaves(zeros))     # input untouched
    for a, b in zip(_leaves(block),
                    _leaves(tfm.slice_kv_block(restored, 1, 4, 12))):
        np.testing.assert_array_equal(a, b)
    for a in _leaves(restored["blocks"]):
        assert not a[:, 0].any()
        assert not a[:, 1, :4].any() and not a[:, 1, 12:].any()


def test_pageable_configs_match_jax():
    """Paging needs row-addressable caches: configs with local_attn,
    rglru or ssm layers are refused, as in the JAX package."""
    from repro.configs import get_config as jget
    for arch in ("smollm-360m", "qwen2.5-3b", "gemma3-27b",
                 "recurrentgemma-2b", "mamba2-2.7b"):
        cfg, jcfg = get_config(arch, smoke=True), jget(arch, smoke=True)
        try:
            jtfm.check_kv_pageable(jcfg)
            jerr = None
        except ValueError as e:
            jerr = str(e)
        if jerr is None:
            tfm.check_kv_pageable(cfg)
        else:
            with pytest.raises(ValueError) as err:
                tfm.check_kv_pageable(cfg)
            assert str(err.value) == jerr
    with pytest.raises(ValueError, match="local_attn"):
        tfm.check_kv_pageable(get_config("gemma3-27b", smoke=True))


def test_int8_sealed_blocks_carry_half_the_payload():
    """An int8 block (int8 K/V rows plus float32 scale rows) is at most
    half an fp32 block's bytes, but not a free quarter: the scales ride
    along.  The same sizes as the JAX package's."""
    cfg = get_config("qwen2.5-3b", smoke=True)
    sizes = {}
    for name, c in (("fp32", cfg), ("int8", dataclasses.replace(
            cfg, kv_cache_dtype="int8"))):
        caches = materialize(tfm.cache_decl(c, 1, 32), 0, "cpu")
        block = tfm.slice_kv_block(caches, 0, 0, 16)
        store = ExpertStore(StorageNetwork(num_nodes=2, replication=1,
                                           seed=0), chunk_bytes=1 << 12)
        kv = KVBlockStore(store, ExpertCache(store, None))
        man = kv.seal(prefix_cid(KV_GENESIS, np.arange(16)), block, 16)
        assert kv.stats["sealed_bytes"] == man.total_bytes
        jblock = jtfm.slice_kv_block(jmaterialize(
            jtfm.cache_decl(c, 1, 32), jax.random.PRNGKey(0)), 0, 0, 16)
        assert man.total_bytes == sum(np.asarray(a).nbytes for a in
                                      jax.tree_util.tree_leaves(jblock))
        sizes[name] = man.total_bytes
    assert 2 * sizes["int8"] <= sizes["fp32"] < 4 * sizes["int8"]


# ------------------------------------------------------- the engine
def _shared_prefix_reqs(shared_len=40, tail_len=6, new=4, vocab=64):
    rng = np.random.default_rng(7)
    shared = rng.integers(0, vocab, shared_len).astype(np.int32)
    return [{"id": rid, "prompt": np.concatenate(
        [shared, rng.integers(0, vocab, tail_len).astype(np.int32)]),
        "max_new_tokens": new} for rid in range(2)]


def _kv_report(eng):
    return eng.obs_report()["kv"]


def _plain(models_, reqs, **kw):
    eng = engines(models_, **kw)[1]
    eng.submit(copies(reqs))
    return eng, eng.run()


def test_warm_prefix_reuse(smollm):
    """The second session restores the first one's sealed shared blocks
    instead of recomputing their prefill; its stream equals the paging-
    off engine's bit for bit and the counters equal the JAX package's."""
    reqs = _shared_prefix_reqs()
    j, jd, t, td = serve_both(smollm, reqs, batch_slots=1, cache_len=64,
                              kv=KV)
    _, off = _plain(smollm, reqs, batch_slots=1, cache_len=64)
    assert td == jd == off
    rep = _kv_report(t)
    assert rep == _kv_report(j)
    assert rep["warm_hits"] == 5 and rep["restored_tokens"] == 40
    meta = t.request_meta
    ttft = {r: meta[r]["first_token_tick"] - meta[r]["admitted_tick"]
            for r in (0, 1)}
    assert ttft[1] < ttft[0] and meta == j.request_meta


def test_concurrent_identical_prompts_dedup(smollm):
    prompt = np.random.default_rng(9).integers(0, 64, 30).astype(np.int32)
    reqs = [{"id": r, "prompt": prompt.copy(), "max_new_tokens": 3}
            for r in range(2)]
    j, jd, t, td = serve_both(smollm, reqs, batch_slots=2, cache_len=64,
                              kv=KV)
    assert td == jd == _plain(smollm, reqs, batch_slots=2, cache_len=64)[1]
    rep = _kv_report(t)
    assert rep == _kv_report(j)
    assert rep["dedup_blocks"] > 0
    assert rep["store"]["versions"] == rep["sealed_blocks"]


def _paged(models_, pkg):
    """A request paged out mid-decode (full blocks and a tail block),
    then resumed.  ``pkg`` 0: the JAX engine, 1: the port's."""
    rng = np.random.default_rng(1)
    reqs = [{"id": 0, "prompt": rng.integers(0, 64, 20).astype(np.int32),
             "max_new_tokens": 12}]
    eng = engines(models_, batch_slots=2, cache_len=64, prefill_chunk=4,
                  kv=KV)[pkg]
    eng.submit(copies(reqs))
    while (not eng.sched.slots[0].decoding
           or len(eng.sched.slots[0].generated) < 4):
        assert eng.step()
    assert eng.page_out(0) == 0 and not eng.sched.slots[0].active
    assert eng.sched.depth() == 1
    return eng, eng.run(), reqs


def test_page_out_then_resume(smollm):
    """Resumes with the never-paged stream bit for bit; the caches of
    the resumed slot equal the never-paged engine's at the end."""
    t, td, reqs = _paged(smollm, 1)
    j, jd, _ = _paged(smollm, 0)
    base, bd = _plain(smollm, reqs, batch_slots=2, cache_len=64,
                      prefill_chunk=4)
    assert td == bd == jd
    rep = _kv_report(t)
    assert rep == _kv_report(j)
    assert rep["pageouts"] == 1 and rep["resumes"] == 1
    assert rep["restored_tokens"] > 0
    assert t.request_meta[0]["preemptions"] == 1
    for a, b in zip(_leaves(t.caches), _leaves(base.caches)):
        assert torch.equal(a[:, 0], b[:, 0])


@pytest.mark.parametrize("da_rate", [0.0, 0.5])
def test_paging_on_off_same_streams_and_tick_roots(smollm, da_rate):
    """Sealing is side-band: the token tick roots, streams and verdicts
    equal the paging-off engine's; ``kv_root`` carries the sealed
    manifests; DA challenges over the KV chunks resolve with no slash.
    Counters (DA's included) equal the JAX package's."""
    reqs = [req(0, 20, 3), req(1, 17, 3)]
    kv = dict(KV, da_rate=da_rate)
    j, jd, t, td = serve_both(smollm, reqs, trust=TRUST, batch_slots=2,
                              cache_len=64, kv=kv)
    off, offd = _plain(smollm, reqs, trust=TRUST, batch_slots=2,
                       cache_len=64)
    assert td == offd == jd
    assert verdicts(t, td) == verdicts(off, offd) == verdicts(j, jd)
    assert all(v == "finalized" for v in verdicts(t, td).values())
    assert tick_rows(t) == tick_rows(off) == tick_rows(j)
    assert all(tc.kv_root == "" for tc in off.tick_commitments)
    assert any(tc.kv_root for tc in t.tick_commitments)
    rep = _kv_report(t)
    assert rep == _kv_report(j)
    kvbs = t.kvrt.kv
    assert len(kvbs.manifests(kvbs.sealed_cids())) == rep["sealed_blocks"]
    if da_rate:
        assert rep["da"]["probed"] > 0
        assert rep["da"]["probed"] == rep["da"]["satisfied"]
        assert rep["da"]["slashed"] == rep["da"]["opened"] == 0


def test_warm_and_cold_seal_the_same_bytes(smollm):
    """Inside the port a warm session's sealed manifests (restored rows,
    then decoded ones) equal a cold engine's for the same request."""
    reqs = _shared_prefix_reqs()
    warm = engines(smollm, batch_slots=1, cache_len=64, kv=KV)[1]
    warm.submit(copies(reqs))
    warm.run()
    cold = engines(smollm, batch_slots=1, cache_len=64, kv=KV)[1]
    cold.submit(copies(reqs[1:]))
    cold.run()
    roots = {c: cold.kvrt.kv.manifest(c).root
             for c in cold.kvrt.kv.sealed_cids()}
    assert roots and all(warm.kvrt.kv.manifest(c).root == r
                         for c, r in roots.items())


def test_qwen_smoke_paging_and_verified_reuse():
    """qwen2.5-3b's smoke config (GQA, QKV bias): warm reuse under trust
    keeps the paging-off streams and verdicts, and a tampered stream is
    still revoked."""
    m = models("qwen2.5-3b")
    reqs = _shared_prefix_reqs(vocab=512)
    j, jd, t, td = serve_both(m, reqs, trust=TRUST, batch_slots=1,
                              cache_len=64, kv=KV)
    off, offd = _plain(m, reqs, trust=TRUST, batch_slots=1, cache_len=64)
    assert td == jd == offd
    assert _kv_report(t) == _kv_report(j)
    assert _kv_report(t)["warm_hits"] > 0
    assert all(r.finalized for r in t.records.values())
    t.records[1].tokens = [x ^ 1 for x in t.records[1].tokens]
    assert t.audit_session(1)["revoked"]


def test_kv_storage_validation(smollm):
    _, _, cfg, tp = smollm
    with pytest.raises(ValueError, match="block_tokens"):
        ServingEngine(cfg, tp, cache_len=8,
                      kv_storage=KVStorageConfig(block_tokens=8))
    with pytest.raises(ValueError, match="block_tokens"):
        ServingEngine(cfg, tp, kv_storage=KVStorageConfig(block_tokens=0))
    with pytest.raises(ValueError, match="kv_storage"):
        ServingEngine(cfg, tp).page_out(0)
    with pytest.raises(ValueError, match="not active"):
        ServingEngine(cfg, tp, kv_storage=KVStorageConfig()).page_out(0)
    gcfg = get_config("gemma3-27b", smoke=True)
    with pytest.raises(ValueError, match="local_attn"):
        ServingEngine(gcfg, materialize(tfm.model_decl(gcfg), 0, "cpu"),
                      kv_storage=KVStorageConfig())
