"""The port's LM prefill and decode path against the JAX package, on the
CPU, at smoke width.

JAX parameters are materialised from a PRNG key and carried across with
``lm_params_from_numpy``; tokens come from numpy seeds.  On the CPU the
port's kernel wrappers run their plain versions (attention_ref, the
sequential RG-LRU and SSM recurrences), so this holds the port's model code and those
plain versions against the JAX package: configs and declarations exactly,
layers at 1e-5, full-sequence logits and per-step decode logits and
caches at 1e-4, teacher-forced decode against the full forward at 2e-3
(the bar of ``tests/test_consistency.py``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import synthetic as jsyn
from repro.models import builder as jbuilder
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro.models import transformer as jtfm
from repro.train import step as jstep
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.models import builder, layers, rglru, ssm, transformer
from repro_torch.train import step
from repro_torch.train.loop import init_model

ARCHS = ARCH_IDS                      # every config the JAX package declares
# the models this file drives (tests/test_torch_lm_moe.py and
# tests/test_torch_encdec.py drive the others)
MODELS = ("qwen2.5-3b", "recurrentgemma-2b", "smollm-360m", "mamba2-2.7b")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


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
        if w.dtype == np.int8:                  # quantized cache rows
            assert np.abs(g.astype(np.int32) - w).max() <= 1, path
        else:
            _close(g, w, tol, path)


@pytest.fixture(scope="module")
def models():
    """Per arch: (cfg, JAX params, the port's params on the CPU)."""
    out = {}
    for arch in MODELS:
        cfg = get_config(arch, smoke=True)
        jp = jbuilder.materialize(jtfm.model_decl(jget_config(arch, True)),
                                  jax.random.PRNGKey(3))
        out[arch] = (cfg, jp, lm_params_from_numpy(_np(jp), device="cpu"))
    return out


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, smoke):
    assert (dataclasses.asdict(get_config(arch, smoke))
            == dataclasses.asdict(jget_config(arch, smoke)))


def test_unknown_arch_raises_keyerror():
    with pytest.raises(KeyError):
        get_config("gpt-17")


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, (tuple(tree.shape), tuple(tree.axes), tree.init,
                       tree.scale, tree.dtype)


@pytest.mark.parametrize("kv", ["default", "int8"])
@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if not get_config(a).is_encoder_decoder])
def test_decls_match_jax_at_full_width(arch, kv):
    """Declarations only: nothing is allocated at full width.  The
    encoder-decoder's are in tests/test_torch_encdec.py."""
    cfg = dataclasses.replace(get_config(arch), kv_cache_dtype=kv)
    jcfg = dataclasses.replace(jget_config(arch), kv_cache_dtype=kv)
    assert (list(_leaves(transformer.model_decl(cfg)))
            == list(_leaves(jtfm.model_decl(jcfg))))
    assert (list(_leaves(transformer.cache_decl(cfg, 4, 4096)))
            == list(_leaves(jtfm.cache_decl(jcfg, 4, 4096))))
    assert (builder.count_params(transformer.model_decl(cfg))
            == jbuilder.count_params(jtfm.model_decl(jcfg)))


def test_full_width_param_counts():
    """What the chip run allocates: about 3.4 B (qwen2.5-3b), 3.55 B
    (recurrentgemma-2b) and 2.83 B (mamba2-2.7b) parameters, padded vocab
    included."""
    n = {a: builder.count_params(transformer.model_decl(get_config(a)))
         for a in MODELS}
    assert 3.3e9 < n["qwen2.5-3b"] < 3.5e9
    assert 3.5e9 < n["recurrentgemma-2b"] < 3.6e9
    assert 2.8e9 < n["mamba2-2.7b"] < 2.9e9
    assert get_config("qwen2.5-3b").padded_vocab == 152064
    assert get_config("recurrentgemma-2b").padded_vocab == 256000
    cfg = get_config("mamba2-2.7b")
    assert cfg.padded_vocab == 50432 and not cfg.tie_embeddings
    assert (cfg.ssm_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
            cfg.ssm_conv_width, cfg.ssm_chunk) == (5120, 80, 64, 128, 4, 128)


def test_materialize_is_seeded_per_leaf():
    cfg = get_config("recurrentgemma-2b", smoke=True)
    a = init_model(cfg, 0, "cpu")
    b = init_model(cfg, 0, "cpu")
    c = init_model(cfg, 1, "cpu")
    wq = a["blocks"]["1"]["attn"]["wq"]
    assert torch.equal(wq, b["blocks"]["1"]["attn"]["wq"])
    assert not torch.equal(wq, c["blocks"]["1"]["attn"]["wq"])
    assert not torch.equal(a["blocks"]["1"]["attn"]["wk"][..., :64], wq[..., :64])
    assert wq.dtype == torch.float32 and wq.device.type == "cpu"
    assert torch.equal(a["blocks"]["0"]["rglru"]["lam"],
                       torch.full((1, 256), 0.7))
    std = float(a["embed"].std())
    assert 0.018 < std < 0.022                   # scale 0.02
    caches = builder.materialize(transformer.cache_decl(
        dataclasses.replace(cfg, kv_cache_dtype="int8"), 2, 16), 0, "cpu")
    assert caches["blocks"]["1"]["k"].dtype == torch.int8
    assert caches["blocks"]["1"]["k_scale"].dtype == torch.float32


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    cfg = get_config("smollm-360m", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        builder.materialize(transformer.cache_decl(cfg, 1, 8))
    with pytest.raises(RuntimeError, match="CUDA"):
        lm_params_from_numpy({"w": np.zeros(2, np.float32)})


def test_lm_params_from_numpy_keeps_tree_and_dtypes():
    tree = {"a": [np.ones((2, 3), np.float32), np.zeros(2, np.int8)],
            "b": {"c": np.arange(3, dtype=np.int32)}}
    got = lm_params_from_numpy(tree, device="cpu")
    assert got["a"][0].dtype == torch.float32 and got["a"][0].shape == (2, 3)
    assert got["a"][1].dtype == torch.int8
    assert torch.equal(got["b"]["c"], torch.arange(3, dtype=torch.int32))


# ---------------------------------------------------------------- data
def test_lm_batches_and_requests_match_jax():
    got = next(syn.lm_batches(512, 3, 40, seed=5))
    want = next(jsyn.lm_batches(512, 3, 40, seed=5))
    assert got["tokens"].dtype == torch.int32
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    for g, w in zip(syn.serving_requests(512, 5, seed=2),
                    jsyn.serving_requests(512, 5, seed=2)):
        assert g["id"] == w["id"]
        assert g["max_new_tokens"] == w["max_new_tokens"]
        np.testing.assert_array_equal(g["prompt"], w["prompt"])


# -------------------------------------------------------------- layers
def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_rmsnorm_rope_swiglu_conv_match_jax():
    x = _rand(0, 2, 9, 3, 16)
    w = _rand(1, 16, scale=0.1)
    _close(layers.rmsnorm(_t(x), _t(w), 1e-6),
           jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6), 1e-5)
    pos = np.array([[0, 1, 2, 3, 4, 5, 6, 7, 8],
                    [40, 41, 42, 43, 44, 45, 46, 47, 48]], np.int32)
    _close(layers.rope(_t(x), _t(pos), 1e6),
           jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 1e6), 1e-5)
    h = _rand(2, 2, 9, 12)
    wg, wu, wd = _rand(3, 12, 20), _rand(4, 12, 20), _rand(5, 20, 12)
    _close(layers.swiglu(_t(h), _t(wg), _t(wu), _t(wd)),
           jlayers.swiglu(*map(jnp.asarray, (h, wg, wu, wd))), 1e-5)
    cw = _rand(6, 4, 12)
    _close(ssm._causal_conv(_t(h), _t(cw)),
           jssm._causal_conv(jnp.asarray(h), jnp.asarray(cw)), 1e-5)


def test_quantize_kv_rounds_half_to_even_like_jax():
    # absmax 127 gives scale 1.0, so x / scale lands exactly on .5
    t = np.array([[[[127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.49, -126.5]]]],
                 np.float32)
    q, s = layers._quantize_kv(_t(t))
    jq, js = jlayers._quantize_kv(jnp.asarray(t))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert q.numpy().tolist()[0][0][0] == [127, 0, 2, 2, 0, -2, 3, -126]
    _close(s, js, 1e-7)


@pytest.mark.parametrize("window,vector", [(0, False), (0, True),
                                           (8, False), (8, True)])
def test_decode_attention_matches_jax(window, vector):
    """Ring (window) and linear caches, scalar and per-row positions;
    positions past the ring's length exercise floor-mod on negatives."""
    B, cap, H, KH, D = 3, 8, 4, 2, 16
    q = _rand(7, B, 1, H, D)
    k, v = _rand(8, B, cap, KH, D), _rand(9, B, cap, KH, D)
    pos = np.array([3, 11, 20], np.int32) if vector else np.int32(13)
    got = layers.decode_attention(_t(q), _t(k), _t(v), _t(pos),
                                  window=window, softcap=30.0)
    want = jlayers.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jnp.asarray(pos),
                                    window=window, softcap=30.0)
    _close(got, want, 1e-5)


@pytest.mark.parametrize("S", [40, 64])
def test_ssm_block_matches_jax(S):
    """``ssm_train`` (one chunk of 40; two chunks of 32 in the JAX form
    against the port's sequential plain scan at 64) at 2e-4, and one
    ``ssm_decode`` step from a non-zero state and conv history at 1e-5."""
    cfg = dataclasses.replace(get_config("mamba2-2.7b", smoke=True),
                              ssm_chunk=32 if S == 64 else 128)
    jp = jbuilder.materialize(jssm.ssm_decl(cfg), jax.random.PRNGKey(5))
    jp["A_log"] = jnp.asarray(_rand(13, cfg.ssm_heads, scale=0.5))
    jp["dt_bias"] = jnp.asarray(_rand(14, cfg.ssm_heads, scale=0.5))
    p = lm_params_from_numpy(_np(jp), device="cpu")
    x = _rand(15, 2, S, cfg.d_model)
    _close(ssm.ssm_train(p, _t(x), cfg),
           jssm.ssm_train(jp, jnp.asarray(x), cfg), 2e-4)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    cache = {"state": _rand(16, 2, H, P, N),
             "conv": _rand(17, 2, cfg.ssm_conv_width - 1,
                           cfg.ssm_inner + 2 * N)}
    got, gc = ssm.ssm_decode(p, _t(x[:, :1]),
                             {k: _t(v) for k, v in cache.items()}, cfg)
    want, wc = jssm.ssm_decode(jp, jnp.asarray(x[:, :1]),
                               {k: jnp.asarray(v) for k, v in cache.items()},
                               cfg)
    _close(got, want, 1e-5)
    _assert_trees_close(gc, wc, 1e-5)


def test_rglru_block_matches_jax():
    cfg = get_config("recurrentgemma-2b", smoke=True)
    jp = jbuilder.materialize(jrglru.rglru_decl(cfg), jax.random.PRNGKey(4))
    p = lm_params_from_numpy(_np(jp), device="cpu")
    x = _rand(10, 2, 40, cfg.d_model)
    _close(rglru.rglru_train(p, _t(x), cfg),
           jrglru.rglru_train(jp, jnp.asarray(x), cfg), 1e-5)
    cache = {"h": _rand(11, 2, cfg.d_model),
             "conv": _rand(12, 2, cfg.ssm_conv_width - 1, cfg.d_model)}
    got, gc = rglru.rglru_decode(p, _t(x[:, :1]),
                                 {k: _t(v) for k, v in cache.items()}, cfg)
    want, wc = jrglru.rglru_decode(jp, jnp.asarray(x[:, :1]),
                                   {k: jnp.asarray(v)
                                    for k, v in cache.items()}, cfg)
    _close(got, want, 1e-5)
    _assert_trees_close(gc, wc, 1e-5)


# ------------------------------------------------------- full forward
def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("arch", MODELS)
def test_forward_train_and_prefill_match_jax(models, arch):
    """S=40 is ragged against the port's kernel tiles and longer than
    recurrentgemma's smoke window of 32."""
    cfg, jp, p = models[arch]
    toks = _tokens(cfg, 2, 40, 1)
    ops.reset_launch_counts()
    got, aux = transformer.forward_train(p, _t(toks), cfg)
    assert ops.launch_counts()["flash_attention"] == 0   # CPU: plain
    want, _ = jax.jit(lambda pp, t: jtfm.forward_train(
        pp, t, cfg, remat=False, q_chunk=16, kv_chunk=16))(jp, toks)
    assert got.shape == (2, 40, cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want, 1e-4)
    nxt = step.make_prefill_step(cfg)(p, {"tokens": _t(toks)})
    jnxt = jax.jit(jstep.make_prefill_step(cfg))(jp, {"tokens": toks})
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def _decode_both(cfg, jp, p, B, cache_len, feeds):
    """Run the same decode steps in both packages; ``feeds`` yields
    (tokens (B,1), pos, active or None).  Asserts per-step logits and
    caches within 1e-4 and returns the port's logits."""
    jcaches = jbuilder.materialize(jtfm.cache_decl(cfg, B, cache_len),
                                   jax.random.PRNGKey(0))
    caches = builder.materialize(transformer.cache_decl(cfg, B, cache_len),
                                 0, "cpu")
    jstep_fn = jax.jit(lambda c, t, ps, a: jtfm.forward_decode(
        jp, c, t, ps, cfg, write_mask=a))
    jstep_nomask = jax.jit(lambda c, t, ps: jtfm.forward_decode(
        jp, c, t, ps, cfg))
    out = []
    for n, (tok, pos, active) in enumerate(feeds):
        if active is None:
            want, jcaches = jstep_nomask(jcaches, tok, pos)
        else:
            want, jcaches = jstep_fn(jcaches, tok, pos, active)
        got, caches = transformer.forward_decode(
            p, caches, _t(tok), _t(pos),
            cfg, write_mask=None if active is None else _t(active))
        _close(got, want, 1e-4, f"step {n}")
        _assert_trees_close(caches, jcaches, 1e-4)
        out.append(got[:, 0])
    return torch.stack(out, 1)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "recurrentgemma-2b",
                                  "mamba2-2.7b"])
def test_decode_scalar_pos_matches_jax(models, arch):
    """Scalar positions over 40 steps: past recurrentgemma's smoke window
    (32), so its ring cache wraps."""
    cfg, jp, p = models[arch]
    toks = _tokens(cfg, 2, 40, 2)
    _decode_both(cfg, jp, p, 2, 40, ((toks[:, t:t + 1], np.int32(t), None)
                                     for t in range(40)))


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b",
                                  "mamba2-2.7b"])
def test_decode_vector_pos_with_write_mask_matches_jax(models, arch):
    """Three slots at their own depths (one admitted later, one that
    sits out every third step): per-row positions and the active mask."""
    cfg, jp, p = models[arch]
    toks = _tokens(cfg, 3, 40, 3)
    start = np.array([0, 5, 11], np.int32)
    feeds = []
    for t in range(36):
        active = np.array([True, t >= 5, t % 3 != 1])
        pos = np.maximum(t - start, 0).astype(np.int32)
        feeds.append((toks[:, t:t + 1], pos, active))
    _decode_both(cfg, jp, p, 3, 40, feeds)


def test_decode_int8_cache_matches_jax(models):
    cfg, jp, p = models["qwen2.5-3b"]
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    toks = _tokens(cfg, 2, 24, 4)
    _decode_both(cfg8, jp, p, 2, 32, ((toks[:, t:t + 1], np.int32(t), None)
                                      for t in range(24)))


def test_decode_step_matches_jax(models):
    """``make_decode_step``: per-row pos and an active mask in the batch."""
    cfg, jp, p = models["smollm-360m"]
    toks = _tokens(cfg, 2, 1, 5)
    pos = np.array([0, 0], np.int32)
    active = np.array([True, False])
    jc = jbuilder.materialize(jtfm.cache_decl(cfg, 2, 8),
                              jax.random.PRNGKey(0))
    c = builder.materialize(transformer.cache_decl(cfg, 2, 8), 0, "cpu")
    jn, jc = jstep.make_decode_step(cfg)(jp, jc, {"tokens": toks, "pos": pos,
                                                  "active": active})
    n, c = step.make_decode_step(cfg)(p, c, {"tokens": _t(toks),
                                             "pos": _t(pos),
                                             "active": _t(active)})
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    _assert_trees_close(c, jc, 1e-4)
    assert not c["blocks"]["0"]["k"][:, 1].any()      # inactive: untouched
    # no MoE layer: expert_stats gives (0, 1) counts, as in JAX
    _, _, stats = step.make_decode_step(cfg, expert_stats=True)(
        p, c, {"tokens": _t(toks), "pos": _t(pos)})
    assert tuple(stats.shape) == (0, 1) and stats.dtype == torch.int32


@pytest.mark.parametrize("arch", MODELS)
def test_teacher_forced_decode_matches_forward(arch):
    """Inside the port: decode-with-cache reproduces the full forward
    (cache semantics, rope positions, ring buffers, recurrent state), the
    analog of tests/test_consistency.py at its 2e-3 bar."""
    cfg = get_config(arch, smoke=True)
    p = init_model(cfg, 0, "cpu")
    S = 48
    toks = _t(_tokens(cfg, 1, S, 6))
    full, _ = transformer.forward_train(p, toks, cfg)
    caches = builder.materialize(transformer.cache_decl(cfg, 1, S), 0, "cpu")
    outs = []
    for t in range(S):
        logits, caches = transformer.forward_decode(p, caches,
                                                    toks[:, t:t + 1], t, cfg)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, 1), full, 2e-3)


def test_ssm_write_mask_keeps_an_inactive_rows_state_and_conv(models):
    """A row whose write_mask is False keeps its SSM state and conv
    history bit for bit, while the active row advances both."""
    cfg, _, p = models["mamba2-2.7b"]
    caches = builder.materialize(transformer.cache_decl(cfg, 2, 8), 0, "cpu")
    toks = _t(_tokens(cfg, 2, 3, 7))
    for t in range(2):
        _, caches = transformer.forward_decode(p, caches, toks[:, t:t + 1],
                                               t, cfg)
    _, new = transformer.forward_decode(p, caches, toks[:, 2:3], 2, cfg,
                                        write_mask=torch.tensor([True,
                                                                 False]))
    for k in ("state", "conv"):
        old, cur = caches["blocks"]["0"][k], new["blocks"]["0"][k]
        assert torch.equal(cur[:, 1], old[:, 1]), k
        assert not torch.equal(cur[:, 0], old[:, 0]), k
