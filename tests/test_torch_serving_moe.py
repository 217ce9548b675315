"""The port's serving engine on MoE models against the JAX package's, on
the CPU: qwen2-moe-a2.7b's smoke config (60 experts cut to 4, top-2, a
shared expert) and bmoe-paper's (N = 4, K = 3).

``forward_serve_chunk(expert_stats=True)``: the greedy tokens and the
per-MoE-layer routed-token counts summed over the chunk exactly, the
caches at 1e-5.  The edge expert runtime resolves each macro-step's
activated experts through its cache; the expert units are chunked from
the same numpy weights in both packages, so its report (cache, store
and network counters, units, ticks) equals the JAX package's.  Inside
the port, the streams are the same bits with the edge cache on or off
and with KV blocks and experts sharing one tight byte budget."""
import pytest

from repro.data.synthetic import serving_requests
from repro_torch.serve.engine import EdgeStorageConfig, ServingEngine

from torch_serving_common import (check_serve_chunk, copies, engines,
                                  models, serve_both, serve_chunk_case)


@pytest.fixture(scope="module")
def qwen_moe():
    # unpadded, as the JAX package's own engine tests run it
    return models("qwen2-moe-a2.7b", padded_num_experts=0)


def _reqs(n=4, max_prompt=6, max_new=4, seed=0):
    return list(serving_requests(512, n, max_prompt=max_prompt,
                                 max_new=max_new, seed=seed))


@pytest.mark.parametrize("arch,padded", [("qwen2-moe-a2.7b", 0),
                                         ("qwen2-moe-a2.7b", None),
                                         ("bmoe-paper", None)])
def test_serve_chunk_expert_stats_match_jax(arch, padded):
    """Stats (num_moe_layers, E) int32, every row's assignments counted
    at every micro-step, the idle rows' too; with 64 padded experts the
    padded columns stay 0."""
    m = models(arch) if padded is None else models(
        arch, padded_num_experts=padded)
    jout, out, tcaches, adv = serve_chunk_case(m, expert_stats=True)
    check_serve_chunk(jout, out, tcaches, adv)
    stats = out[2]
    assert str(stats.dtype) == "torch.int32"
    assert stats.numpy().tolist() == jout[2].tolist()
    cfg = m[2]
    k, n = cfg.num_experts_per_tok, cfg.num_experts
    assert (stats.sum(-1) == 4 * 4 * k).all()          # B x C x k
    assert not stats[:, n:].any()


def test_edge_runtime_matches_jax(qwen_moe):
    j, jd, t, td = serve_both(qwen_moe, _reqs(), batch_slots=2,
                              cache_len=32, edge={"prefetch_topk": 2})
    assert td == jd
    rep = t.edge.report()
    assert rep == j.edge.report()
    assert rep["units"] == 2 * 4 and rep["ticks"] == t.steps
    assert 0 < rep["cache"]["misses"] <= rep["units"]
    assert rep["cache"]["hits"] > 0


def test_edge_cache_on_off_bitwise(qwen_moe):
    plain = engines(qwen_moe, batch_slots=2, cache_len=32)[1]
    plain.submit(copies(_reqs()))
    done = plain.run()
    for edge in ({"prefetch_topk": 2}, {"cache_bytes": 1, "prefetch_topk": 1},
                 {"chunk_bytes": 1 << 10, "num_nodes": 3, "replication": 3}):
        eng = engines(qwen_moe, batch_slots=2, cache_len=32, edge=edge)[1]
        eng.submit(copies(_reqs()))
        assert eng.run() == done
        assert eng.micro_steps == plain.micro_steps


@pytest.mark.parametrize("budget", ["unbounded", "half"])
def test_shared_budget_matches_jax_and_plain(qwen_moe, budget):
    """Both runtimes on one store and cache: a budget tight enough to
    evict changes nothing about the streams; the counters equal the JAX
    package's."""
    plain = engines(qwen_moe, batch_slots=2, cache_len=32)[1]
    plain.submit(copies(_reqs()))
    done = plain.run()
    edge = {}
    if budget == "half":
        probe = engines(qwen_moe, batch_slots=2, cache_len=32, edge={},
                        kv={"block_tokens": 4})[1]
        probe.submit(copies(_reqs()))
        probe.run()
        edge = {"cache_bytes": probe.edge.cache.resident_bytes // 2}
    j, jd, t, td = serve_both(qwen_moe, _reqs(), batch_slots=2,
                              cache_len=32, edge=edge,
                              kv={"block_tokens": 4})
    assert t.kvrt.cache is t.edge.cache and t.kvrt.store is t.edge.store
    assert td == jd == done
    rep = t.obs_report()
    jrep = j.obs_report()
    assert rep["kv"] == jrep["kv"] and rep["edge"] == jrep["edge"]
    assert rep["kv"]["sealed_blocks"] > 0
    objects = t.edge.store.objects()
    assert any(o.startswith("kv/") for o in objects)
    assert any(o.startswith("moe/") for o in objects)
    if budget == "half":
        assert t.edge.cache.stats["evictions"] > 0


def test_bmoe_paper_serving_matches_jax():
    """The paper's N = 10, K = 3 setting as an LM (smoke width), verified
    and with edge storage: streams, tick roots and the edge report."""
    m = models("bmoe-paper")
    trust = {"audit_rate": 1.0, "num_verifiers": 2, "challenge_window": 3}
    j, jd, t, td = serve_both(m, _reqs(5, 12, 6, seed=2), batch_slots=3,
                              cache_len=48, trust=trust,
                              edge={"prefetch_topk": 3,
                                    "cache_bytes": 1 << 20})
    assert td == jd and len(td) == 5
    assert [tc.root for tc in t.tick_commitments] == \
        [tc.root for tc in j.tick_commitments]
    assert t.session_log == j.session_log
    assert t.edge.report() == j.edge.report()


def test_expert_storage_needs_moe():
    _, _, cfg, tp = models("smollm-360m")
    with pytest.raises(ValueError, match="MoE"):
        ServingEngine(cfg, tp, expert_storage=EdgeStorageConfig())
