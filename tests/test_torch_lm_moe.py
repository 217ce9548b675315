"""The port's LM MoE layers and the remaining attention configs against
the JAX package, on the CPU, at smoke width.

JAX parameters are materialised from a PRNG key and carried across with
``lm_params_from_numpy``; inputs come from numpy seeds.  On the CPU
``ops.moe_gemm`` and ``ops.flash_attention`` run their plain versions, so
this holds the port's routing, dispatch, combine and model code against
the JAX package: routing integers (expert ids, capacity positions, keep
flags, counts) exactly, tied logits included; ``moe_mlp`` and its aux
loss at 1e-5; the models' forward, aux and decode at 1e-4 with prefill
tokens exact; teacher-forced decode against the forward at 2e-3 (the bar
of ``tests/test_consistency.py``, whose MoE case also raises the
capacity so that the forward drops nothing).

Routing is discrete: where the JAX run's router logits nearly tie at the
k-th expert, float rounding may route the two packages differently.  The
model tests record both packages' routing and assert that the smallest
top-k margin lies above the logits' tolerance, so such a near-tie is
reported as one rather than passing or failing by chance."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import builder as jbuilder
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import builder, moe, transformer
from repro_torch.train import step
from repro_torch.train.loop import init_model


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread while this file runs: its ops are at smoke
    width, and on a CPU shared by several test workers more threads only
    contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MOE_ARCHS = ("bmoe-paper", "qwen2-moe-a2.7b", "llama4-maverick-400b-a17b")
ATTN_ARCHS = ("qwen3-32b", "gemma3-27b", "pixtral-12b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _assert_trees_close(got, want, tol, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_close(got[k], want[k], tol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_close(g, w, tol, f"{path}/{i}")
    else:
        w = np.asarray(want)
        g = got.numpy()
        assert g.shape == w.shape and str(g.dtype) == str(w.dtype), path
        _close(g, w, tol, path)


def _margins(logits, k, num_real):
    """Per token, the router logit of the k-th expert minus the (k+1)-th
    one's, over the real experts: how far a token is from a tie that
    would change its expert set."""
    lg = np.asarray(logits, np.float64)[..., :num_real]
    if num_real <= k:
        return np.full(lg.shape[:-1], np.inf)
    top = -np.sort(-lg, axis=-1)
    return top[..., k - 1] - top[..., k]


@pytest.fixture
def recorded(monkeypatch):
    """Both packages' ``route`` calls recorded in order: (logits, expert
    ids, positions, keep) as numpy.  A traced JAX call (under ``jit`` or
    ``scan``) is not recorded: where a test reads the record the JAX
    package runs eagerly, its layers unrolled."""
    rec = {"jax": [], "torch": []}

    def wrap(mod, key):
        inner = mod.route

        def route(logits, k, capacity, num_real=0):
            out = inner(logits, k, capacity, num_real)
            if isinstance(logits, jax.core.Tracer):
                return out
            rec[key].append(tuple(np.asarray(a) for a in
                                  (logits, out[1], out[2], out[3])))
            return out
        monkeypatch.setattr(mod, "route", route)

    wrap(jmoe, "jax")
    wrap(moe, "torch")
    return rec


def _assert_same_routing(rec, cfg, tol):
    """Per MoE call: the JAX run's smallest top-k margin above ``tol``,
    then expert ids, positions and keep flags equal."""
    assert len(rec["jax"]) == len(rec["torch"]) > 0
    for n, (j, t) in enumerate(zip(rec["jax"], rec["torch"])):
        m = _margins(j[0], cfg.num_experts_per_tok, cfg.num_experts)
        assert m.min() > tol, (
            f"call {n}: a router near-tie (top-k margin {m.min():.3g}) "
            f"within the tolerance {tol}")
        for a, b, what in zip(j[1:], t[1:], ("expert_id", "position",
                                              "keep")):
            np.testing.assert_array_equal(b.astype(a.dtype), a,
                                          err_msg=f"call {n} {what}")


# ---------------------------------------------------------- routing
@pytest.mark.parametrize("S", [1, 7, 40, 4096])
@pytest.mark.parametrize("arch", MOE_ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_capacity_for_matches_jax(arch, smoke, S):
    assert (moe.capacity_for(get_config(arch, smoke), S)
            == jmoe.capacity_for(jget_config(arch, smoke), S))


def test_decode_capacity_is_k():
    for arch in MOE_ARCHS:
        cfg = get_config(arch)
        assert moe.capacity_for(cfg, 1) == cfg.num_experts_per_tok
    assert moe.capacity_for(get_config("bmoe-paper"), 4096) == 1536
    assert moe.capacity_for(get_config("qwen2-moe-a2.7b"), 4096) == 344


def _route_case(case):
    """(logits (B, S, E), k, capacity, num_real)."""
    if case == "random":
        return _rand(20, 2, 24, 6), 2, 16, 0
    if case == "drops":                      # capacity 4 for 24 x 3
        return _rand(21, 2, 24, 5), 3, 4, 0
    if case == "padded":                     # 6 real experts of 8
        return _rand(22, 3, 10, 8), 2, 8, 6
    # duplicated router columns: experts 1 and 3 (and 0 and 4) tie
    # exactly, so the order among equal probabilities decides the routing
    x = _rand(23, 2, 16, 12)
    w = _rand(24, 12, 6)
    w[:, 3] = w[:, 1]
    w[:, 4] = w[:, 0]
    logits = x @ w
    if case == "ties_padded":
        return logits, 3, 8, 5
    return logits, 2, 8, 0


@pytest.mark.parametrize("case", ["random", "drops", "padded", "ties",
                                  "ties_padded"])
def test_route_matches_jax(case):
    logits, k, cap, num_real = _route_case(case)
    got = moe.route(_t(logits), k, cap, num_real)
    want = jmoe.route(jnp.asarray(logits), k, cap, num_real)
    _close(got[0], want[0], 1e-6, "weights")
    for g, w, what in zip(got[1:4], want[1:4],
                          ("expert_id", "position", "keep")):
        np.testing.assert_array_equal(g.numpy().astype(np.asarray(w).dtype),
                                      np.asarray(w), err_msg=what)
    _close(got[4], want[4], 1e-6, "aux")
    if case.startswith("ties"):
        # the ties are real: equal probabilities somewhere in the top k+1
        p = torch.softmax(_t(logits), -1)
        assert bool((p[..., 1] == p[..., 3]).all())
    if case == "drops":
        assert not got[3].all()
    if "padded" in case:
        assert int(got[1].max()) < num_real


def test_top_k_puts_the_lower_index_first_on_a_tie():
    probs = torch.tensor([[0.1, 0.3, 0.2, 0.3, 0.1]])
    vals, idx = moe.top_k(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == [[1, 3, 2]] == np.asarray(ji).tolist()
    _close(vals, jv, 0)


# -------------------------------------------------------- MoE layer
def _moe_case(case):
    """(cfg, x shape) per case: the three smoke MoE configs; qwen2-moe
    with tiny capacity (shaped like tests/test_consistency.py's drop
    case); with padded experts; and a layer whose router duplicates an
    expert's column (tied routing)."""
    if case in MOE_ARCHS:
        return get_config(case, smoke=True), (2, 24)
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    if case == "drops":
        return dataclasses.replace(cfg, capacity_factor=0.05), (2, 32)
    if case == "padded":
        return dataclasses.replace(cfg, padded_num_experts=8), (2, 24)
    return cfg, (3, 16)


@pytest.mark.parametrize("case", list(MOE_ARCHS) + ["drops", "padded",
                                                    "ties"])
def test_moe_mlp_matches_jax(case):
    cfg, (B, S) = _moe_case(case)
    jp = jbuilder.materialize(jmoe.moe_decl(cfg), jax.random.PRNGKey(7))
    if case == "ties":
        r = np.array(jp["router"])
        r[:, 2] = r[:, 0]
        jp["router"] = jnp.asarray(r)
    p = lm_params_from_numpy(_np(jp), device="cpu")
    x = _rand(30, B, S, cfg.d_model)
    ops.reset_launch_counts()
    y, aux, counts = moe.moe_mlp(p, _t(x), cfg, return_stats=True)
    assert ops.launch_counts()["moe_gemm"] == 0          # CPU: plain
    jy, jaux, jcounts = jmoe.moe_mlp(jp, jnp.asarray(x), cfg,
                                     return_stats=True)
    _close(y, jy, 1e-5, "y")
    _close(aux, jaux, 1e-5, "aux")
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert int(counts.sum()) == B * S * cfg.num_experts_per_tok
    if case == "drops":
        C = moe.capacity_for(cfg, S)
        assert int(counts.max()) > C           # an expert overflowed
    if case == "padded":
        assert counts.shape == (8,) and int(counts[cfg.num_experts:].sum()) == 0


def test_dropped_assignments_add_nothing_and_keep_slot_c_minus_1():
    """A dropped assignment clamps to slot C - 1 with a zero row; the
    token kept in that slot must survive (the scatter adds, it does not
    overwrite).  Checked against direct per-token evaluation of the kept
    experts."""
    cfg = dataclasses.replace(get_config("qwen2-moe-a2.7b", smoke=True),
                              capacity_factor=0.05, num_shared_experts=0)
    p = lm_params_from_numpy(_np(jbuilder.materialize(
        jmoe.moe_decl(cfg), jax.random.PRNGKey(8))), device="cpu")
    x = _t(_rand(31, 1, 32, cfg.d_model))
    y, _ = moe.moe_mlp(p, x, cfg)
    C = moe.capacity_for(cfg, 32)
    w, eid, pos, keep, _ = moe.route(x @ p["router"], 2, C, cfg.num_experts)
    assert not keep.all() and bool((pos[keep] == C - 1).any())
    want = torch.zeros_like(x)
    for s in range(32):
        for j in range(2):
            if keep[0, s, j]:
                e = int(eid[0, s, j])
                h = (torch.nn.functional.silu(x[0, s] @ p["w_gate"][e])
                     * (x[0, s] @ p["w_up"][e]))
                want[0, s] += w[0, s, j] * (h @ p["w_down"][e])
    _close(y, want, 1e-5)
    dropped = ~keep[0].any(-1)
    assert bool(dropped.any()) and not y[0, dropped].any()


def test_grouped_mlp_folds_the_batch_into_expert_rows():
    """(B, E, C, d) through the three products equals each row's SwiGLU
    through its expert, and each batch row alone gives the same bits."""
    g = torch.Generator().manual_seed(0)
    B, E, C, d, f = 3, 4, 2, 16, 24
    buf = torch.randn(B, E, C, d, generator=g)
    wg, wu = torch.randn(E, d, f, generator=g), torch.randn(E, d, f,
                                                            generator=g)
    wd = torch.randn(E, f, d, generator=g)
    out = moe.grouped_mlp(buf, wg, wu, wd)
    want = torch.einsum("becf,efd->becd", torch.nn.functional.silu(
        torch.einsum("becd,edf->becf", buf, wg))
        * torch.einsum("becd,edf->becf", buf, wu), wd)
    _close(out, want, 1e-5)
    for b in range(B):
        one = moe.grouped_mlp(buf[b:b + 1], wg, wu, wd)
        assert torch.equal(one[0], out[b])


# ----------------------------------------------------------- models
@pytest.fixture(scope="module")
def models():
    """Per arch: (cfg, JAX params, the port's params on the CPU)."""
    out = {}
    for arch in MOE_ARCHS + ATTN_ARCHS:
        cfg = get_config(arch, smoke=True)
        jp = jbuilder.materialize(jtfm.model_decl(jget_config(arch, True)),
                                  jax.random.PRNGKey(3))
        out[arch] = (cfg, jp, lm_params_from_numpy(_np(jp), device="cpu"))
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS + ATTN_ARCHS)
def test_lm_params_from_numpy_takes_the_tree(models, arch):
    """The JAX tree carried across has the tree, shapes and dtypes of the
    port's own init of the same config."""
    cfg, _, p = models[arch]
    mine = init_model(cfg, 0, "cpu")

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(b, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
    walk(p, mine)
    if cfg.num_experts:
        assert "moe" in p["blocks"][str(len(cfg.block_pattern) - 1)]


def _patches(cfg, B, seed):
    if cfg.frontend != "vision":
        return None
    return _rand(seed, B, cfg.frontend_tokens, cfg.d_model)


@pytest.mark.parametrize("arch", MOE_ARCHS + ATTN_ARCHS)
def test_forward_train_and_prefill_match_jax(models, recorded, arch):
    """S=40 is ragged against the kernels' tiles and longer than
    gemma3's smoke window of 32; the MoE forward at S=40 drops
    assignments (capacity 24 of 3 x 40 over 4 experts for bmoe-paper)
    and routes them as JAX does."""
    cfg, jp, p = models[arch]
    toks = _tokens(cfg, 2, 40, 1)
    patches = _patches(cfg, 2, 9)
    got, aux = transformer.forward_train(
        p, _t(toks), cfg,
        prefix_embeds=None if patches is None else _t(patches))
    want, jaux = jtfm.forward_train(
        jp, toks, cfg, remat=False, q_chunk=16, kv_chunk=16, unroll=True,
        prefix_embeds=None if patches is None else jnp.asarray(patches))
    S = 40 + (0 if patches is None else cfg.frontend_tokens)
    assert got.shape == (2, S, cfg.padded_vocab)
    _close(got, want, 1e-4)
    _close(aux, jaux, 1e-4, "aux")
    if cfg.num_experts:
        assert float(aux) > 0.0
        _assert_same_routing(recorded, cfg, 1e-4)
    batch = {"tokens": toks}
    if patches is not None:
        batch["patches"] = patches
    nxt = step.make_prefill_step(cfg)(
        p, {k: _t(v) for k, v in batch.items()})
    jnxt = jax.jit(jstep.make_prefill_step(cfg))(jp, batch)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def test_vlm_labels_skip_the_patch_prefix(models):
    cfg, jp, p = models["pixtral-12b"]
    toks = _tokens(cfg, 2, 8, 4)
    batch = {"tokens": toks, "labels": toks, "patches": _patches(cfg, 2, 5)}
    _, _, labels = step.model_forward(p, {k: _t(v) for k, v in
                                          batch.items()}, cfg)
    _, _, jlabels = jstep.model_forward(jp, batch, cfg, remat=False)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))
    assert bool((labels[:, :cfg.frontend_tokens] == -1).all())


def _decode_both(cfg, jp, p, B, cache_len, feeds, expert_stats=False):
    """Run the same decode steps through both packages' steps; ``feeds``
    yields (tokens (B,1), pos, active or None).  Asserts per-step logits
    and caches within 1e-4 (and the expert counts exactly) and returns
    the port's logits."""
    jcaches = jbuilder.materialize(jtfm.cache_decl(cfg, B, cache_len),
                                   jax.random.PRNGKey(0))
    caches = builder.materialize(transformer.cache_decl(cfg, B, cache_len),
                                 0, "cpu")
    jrun = jax.jit(lambda c, t, ps, a: jtfm.forward_decode(
        jp, c, t, ps, cfg, write_mask=a, expert_stats=expert_stats))
    jrun_nomask = jax.jit(lambda c, t, ps: jtfm.forward_decode(
        jp, c, t, ps, cfg, expert_stats=expert_stats))
    out = []
    for n, (tok, pos, active) in enumerate(feeds):
        jout = (jrun_nomask(jcaches, tok, pos) if active is None
                else jrun(jcaches, tok, pos, active))
        gout = transformer.forward_decode(
            p, caches, _t(tok), _t(pos), cfg, expert_stats=expert_stats,
            write_mask=None if active is None else _t(active))
        jcaches, caches = jout[1], gout[1]
        _close(gout[0], jout[0], 1e-4, f"step {n}")
        _assert_trees_close(caches, jcaches, 1e-4)
        if expert_stats:
            assert gout[2].dtype == torch.int32
            np.testing.assert_array_equal(gout[2].numpy(),
                                          np.asarray(jout[2]))
        out.append(gout[0][:, 0])
    return torch.stack(out, 1)


@pytest.mark.parametrize("arch", MOE_ARCHS + ATTN_ARCHS)
def test_decode_scalar_pos_matches_jax(models, arch):
    """Scalar positions over 36 steps: past gemma3's smoke window (32),
    so its ring cache wraps; MoE layers with their counts."""
    cfg, jp, p = models[arch]
    toks = _tokens(cfg, 2, 36, 2)
    _decode_both(cfg, jp, p, 2, 36, ((toks[:, t:t + 1], np.int32(t), None)
                                     for t in range(36)),
                 expert_stats=bool(cfg.num_experts))


@pytest.mark.parametrize("arch", MOE_ARCHS + ("gemma3-27b",))
def test_decode_vector_pos_with_write_mask_matches_jax(models, arch):
    """Three slots at their own depths (one admitted later, one that
    sits out every third step): per-row positions, the active mask and,
    for MoE models, the per-layer counts of every row, inactive ones
    included."""
    cfg, jp, p = models[arch]
    toks = _tokens(cfg, 3, 36, 3)
    start = np.array([0, 5, 11], np.int32)
    feeds = []
    for t in range(34):
        active = np.array([True, t >= 5, t % 3 != 1])
        pos = np.maximum(t - start, 0).astype(np.int32)
        feeds.append((toks[:, t:t + 1], pos, active))
    _decode_both(cfg, jp, p, 3, 40, feeds,
                 expert_stats=bool(cfg.num_experts))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_with_expert_stats_matches_jax(models, recorded, arch):
    """``make_decode_step(expert_stats=True)`` in both packages, JAX
    eager so its routing is recorded: next tokens and caches, and counts
    (num_moe_layers, E) that equal a recount from the routing, each
    layer's summing to B * k."""
    cfg, jp, p = models[arch]
    B = 3
    toks = _tokens(cfg, B, 1, 5)
    pos = np.array([0, 2, 1], np.int32)
    active = np.array([True, False, True])
    jc = jbuilder.materialize(jtfm.cache_decl(cfg, B, 8),
                              jax.random.PRNGKey(0))
    c = builder.materialize(transformer.cache_decl(cfg, B, 8), 0, "cpu")
    batch = {"tokens": toks, "pos": pos, "active": active}
    jn, jc, jstats = jstep.make_decode_step(cfg, unroll=True,
                                                 expert_stats=True)(
        jp, jc, batch)
    n, c, stats = step.make_decode_step(cfg, expert_stats=True)(
        p, c, {k: _t(v) for k, v in batch.items()})
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    _assert_trees_close(c, jc, 1e-4)
    n_moe = sum(s.mlp == "moe" for s in cfg.block_pattern) * \
        cfg.resolved_num_blocks + sum(s.mlp == "moe" for s in cfg.remainder)
    E = cfg.resolved_padded_experts
    assert stats.shape == (n_moe, E) and stats.dtype == torch.int32
    np.testing.assert_array_equal(stats.numpy(), np.asarray(jstats))
    assert stats.sum(-1).tolist() == [B * cfg.num_experts_per_tok] * n_moe
    recount = np.stack([np.bincount(r[1].reshape(-1), minlength=E)
                        for r in recorded["torch"]])
    np.testing.assert_array_equal(stats.numpy(), recount)
    _assert_same_routing(recorded, cfg, 1e-4)


def test_dense_decode_step_with_expert_stats_is_empty(models):
    """A model without MoE layers gives (0, 1) counts, as JAX does."""
    cfg, jp, p = models["qwen3-32b"]
    toks = _tokens(cfg, 2, 1, 6)
    c = builder.materialize(transformer.cache_decl(cfg, 2, 4), 0, "cpu")
    jc = jbuilder.materialize(jtfm.cache_decl(cfg, 2, 4),
                              jax.random.PRNGKey(0))
    n, _, stats = step.make_decode_step(cfg, expert_stats=True)(
        p, c, {"tokens": _t(toks), "pos": 0})
    jn, _, jstats = jstep.make_decode_step(cfg, expert_stats=True)(
        jp, jc, {"tokens": toks, "pos": jnp.int32(0)})
    assert tuple(stats.shape) == np.asarray(jstats).shape == (0, 1)
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))


@pytest.mark.parametrize("arch", MOE_ARCHS + ATTN_ARCHS)
def test_teacher_forced_decode_matches_forward(arch):
    """Inside the port: decode-with-cache reproduces the full forward at
    2e-3.  As in tests/test_consistency.py, MoE configs run at capacity
    factor 8 here: the forward's capacity drops (which decode, at
    capacity k, never makes) are a different function, not a cache
    fault."""
    cfg = get_config(arch, smoke=True)
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    p = init_model(cfg, 0, "cpu")
    S = 40
    toks = _t(_tokens(cfg, 1, S, 6))
    full, _ = transformer.forward_train(p, toks, cfg)
    caches = builder.materialize(transformer.cache_decl(cfg, 1, S), 0, "cpu")
    outs = []
    for t in range(S):
        logits, caches = transformer.forward_decode(p, caches,
                                                    toks[:, t:t + 1], t, cfg)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, 1), full, 2e-3)


def test_moe_batched_decode_equals_alone_bitwise():
    """Four slots of one batch against each request alone in the same
    4-slot batch: the same bits (each batch row is its own dispatch
    group, and the folded expert rows do not mix)."""
    cfg = get_config("qwen2-moe-a2.7b", smoke=True)
    p = init_model(cfg, 0, "cpu")
    toks = _t(_tokens(cfg, 4, 12, 8))

    def run(rows):
        caches = builder.materialize(transformer.cache_decl(cfg, 4, 12), 0,
                                     "cpu")
        out = []
        for t in range(12):
            feed = torch.where(rows[:, None], toks[:, t:t + 1], 0)
            lg, caches = transformer.forward_decode(
                p, caches, feed, t, cfg, write_mask=rows)
            out.append(lg[:, 0])
        return torch.stack(out, 1)

    batched = run(torch.ones(4, dtype=torch.bool))
    for r in range(4):
        alone = run(torch.arange(4) == r)
        assert torch.equal(alone[r], batched[r]), r


def test_new_full_width_param_counts():
    """What the chip run allocates (fp32, padded vocab and experts):
    bmoe-paper about 1.1 B parameters, qwen2-moe-a2.7b about 15.1 B,
    pixtral-12b about 12.6 B; qwen3-32b and gemma3-27b above the card's
    80 GB at full depth."""
    n = {a: builder.count_params(transformer.model_decl(get_config(a)))
         for a in MOE_ARCHS + ATTN_ARCHS}
    assert 1.0e9 < n["bmoe-paper"] < 1.2e9
    assert 15.0e9 < n["qwen2-moe-a2.7b"] < 15.3e9
    assert 12.0e9 < n["pixtral-12b"] < 13.0e9
    assert 4 * n["qwen3-32b"] > 80e9 and 4 * n["gemma3-27b"] > 80e9
    assert n["llama4-maverick-400b-a17b"] > 3.5e11
    cfg = get_config("qwen2-moe-a2.7b")
    assert cfg.resolved_padded_experts == 64 and cfg.num_experts == 60


def test_unknown_layer_kind_raises():
    from repro_torch.models.config import LayerSpec
    cfg = get_config("qwen3-32b", smoke=True)
    with pytest.raises(ValueError):
        transformer.layer_decl(LayerSpec("conv", "dense"), cfg)
    with pytest.raises(ValueError):
        jtfm.layer_decl(LayerSpec("conv", "dense"), cfg)
