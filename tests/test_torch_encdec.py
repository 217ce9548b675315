"""The port's encoder-decoder (seamless-m4t-medium's backbone) against the
JAX package, on the CPU, at smoke width.

JAX parameters come from a PRNG key and are carried across with
``lm_params_from_numpy``; frames, tokens and cross K/V from numpy seeds.
On the CPU ``ops.flash_attention`` runs its plain version, so this holds
the port's encoder (bidirectional), decoder (causal self-attention and
non-causal cross-attention with Sq != Sk) and decode step against the
JAX package at 1e-4, prefill tokens exactly, and the port's
teacher-forced decode against its own forward at 2e-3 (the bar of
``tests/test_consistency.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import builder as jbuilder
from repro.models import encdec as jencdec
from repro.train import step as jstep
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops
from repro_torch.models import builder, encdec
from repro_torch.train import step
from repro_torch.train.loop import init_model

ARCH = "seamless-m4t-medium"


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


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, (tuple(tree.shape), tuple(tree.axes), tree.init,
                       tree.scale, tree.dtype)


@pytest.fixture(scope="module")
def model():
    cfg = get_config(ARCH, smoke=True)
    jp = jbuilder.materialize(jencdec.encdec_decl(jget_config(ARCH, True)),
                              jax.random.PRNGKey(4))
    return cfg, jp, lm_params_from_numpy(_np(jp), device="cpu")


@pytest.mark.parametrize("smoke", [False, True])
def test_decls_match_jax(smoke):
    cfg, jcfg = get_config(ARCH, smoke), jget_config(ARCH, smoke)
    assert (list(_leaves(encdec.encdec_decl(cfg)))
            == list(_leaves(jencdec.encdec_decl(jcfg))))
    assert (list(_leaves(encdec.encdec_cache_decl(cfg, 2, 4096, 4096)))
            == list(_leaves(jencdec.encdec_cache_decl(jcfg, 2, 4096, 4096))))
    assert (builder.count_params(encdec.encdec_decl(cfg))
            == jbuilder.count_params(jencdec.encdec_decl(jcfg)))


def test_full_width_size():
    """About 1.0 B parameters at full width (the 256,206-token vocabulary
    padded to 256,256, embedding and head untied)."""
    cfg = get_config(ARCH)
    n = builder.count_params(encdec.encdec_decl(cfg))
    assert 0.9e9 < n < 1.1e9 and cfg.padded_vocab == 256256
    assert (cfg.num_encoder_layers, cfg.num_layers) == (12, 12)


def test_init_model_and_carried_tree_agree(model):
    """``init_model`` declares the encoder-decoder tree; the JAX tree
    carried by ``lm_params_from_numpy`` has the same keys, shapes and
    dtypes."""
    cfg, _, p = model
    mine = init_model(cfg, 0, "cpu")

    def walk(a, b, path=""):
        if isinstance(b, dict):
            assert sorted(a) == sorted(b), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path
    walk(p, mine)
    assert set(mine) == {"embed", "enc_blocks", "dec_blocks", "enc_norm",
                         "final_norm", "lm_head"}


def test_encode_matches_jax(model):
    """A bidirectional encoder over 40 frames (ragged against the
    kernel's tiles)."""
    cfg, jp, p = model
    frames = _rand(1, 2, 40, cfg.d_model)
    ops.reset_launch_counts()
    got = encdec.encode(p, _t(frames), cfg)
    assert ops.launch_counts()["flash_attention"] == 0     # CPU: plain
    want = jencdec.encode(jp, jnp.asarray(frames), cfg, remat=False)
    _close(got, want, 1e-4)


@pytest.mark.parametrize("S_enc,S_dec", [(40, 24), (17, 33)])
def test_forward_train_and_prefill_match_jax(model, S_enc, S_dec):
    """Cross-attention with Sq != Sk both ways."""
    cfg, jp, p = model
    frames = _rand(2, 2, S_enc, cfg.d_model)
    toks = _tokens(cfg, 2, S_dec, 3)
    got, aux = encdec.forward_train(p, _t(frames), _t(toks), cfg)
    want, _ = jencdec.forward_train(jp, jnp.asarray(frames), toks, cfg,
                                    remat=False)
    assert got.shape == (2, S_dec, cfg.padded_vocab) and float(aux) == 0.0
    _close(got, want, 1e-4)
    batch = {"frames": frames, "tokens": toks}
    nxt = step.make_prefill_step(cfg)(p, {k: _t(v) for k, v in
                                          batch.items()})
    jnxt = jax.jit(jstep.make_prefill_step(cfg))(jp, batch)
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))


def _caches(cfg, B, cache_len, mem_len, seed):
    """Zero self K/V and nonzero cross K/V, as numpy."""
    L, KH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    z = np.zeros((L, B, cache_len, KH, hd), np.float32)
    return {"self_k": z, "self_v": z.copy(),
            "cross_k": _rand(seed, L, B, mem_len, KH, hd),
            "cross_v": _rand(seed + 1, L, B, mem_len, KH, hd)}


@pytest.mark.parametrize("vector_pos", [False, True])
def test_forward_decode_matches_jax(model, vector_pos):
    """12 steps against the same nonzero cross K/V (memory of 20):
    logits and the self K/V at 1e-4, the cross K/V passed through."""
    cfg, jp, p = model
    B = 2
    cnp = _caches(cfg, B, 12, 20, 5)
    jc = {k: jnp.asarray(v) for k, v in cnp.items()}
    c = {k: _t(v) for k, v in cnp.items()}
    toks = _tokens(cfg, B, 12, 6)
    jrun = jax.jit(lambda cc, t, ps: jencdec.forward_decode(jp, cc, t, ps,
                                                            cfg))
    for t in range(12):
        pos = (np.array([t, max(t - 3, 0)], np.int32) if vector_pos
               else np.int32(t))
        want, jc = jrun(jc, toks[:, t:t + 1], pos)
        got, c = encdec.forward_decode(p, c, _t(toks[:, t:t + 1]), _t(pos),
                                       cfg)
        _close(got, want, 1e-4, f"step {t}")
        for k in ("self_k", "self_v"):
            _close(c[k], jc[k], 1e-4, k)
    assert torch.equal(c["cross_k"], _t(cnp["cross_k"]))


def test_decode_step_matches_jax_and_refuses_an_active_mask(model):
    cfg, jp, p = model
    cnp = _caches(cfg, 2, 4, 9, 7)
    toks = _tokens(cfg, 2, 1, 8)
    jn, jc = jstep.make_decode_step(cfg)(
        jp, {k: jnp.asarray(v) for k, v in cnp.items()},
        {"tokens": toks, "pos": jnp.int32(0)})
    n, c = step.make_decode_step(cfg)(p, {k: _t(v) for k, v in cnp.items()},
                                      {"tokens": _t(toks), "pos": 0})
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    _close(c["self_k"], jc["self_k"], 1e-4)
    active = np.array([True, False])
    with pytest.raises(NotImplementedError, match="decoder-only"):
        jstep.make_decode_step(cfg)(
            jp, {k: jnp.asarray(v) for k, v in cnp.items()},
            {"tokens": toks, "pos": jnp.int32(0), "active": active})
    with pytest.raises(NotImplementedError, match="decoder-only"):
        step.make_decode_step(cfg)(
            p, {k: _t(v) for k, v in cnp.items()},
            {"tokens": _t(toks), "pos": 0, "active": _t(active)})


def cross_kv(params, memory, cfg):
    """Each decoder layer's cross K/V from the encoder's memory (B, S, d):
    (L, B, S, KH, hd) each, no rope, as the forward's cross-attention
    projects them."""
    B, S, _ = memory.shape
    shape = (B, S, cfg.num_kv_heads, cfg.resolved_head_dim)
    x = params["dec_blocks"]["xattn"]
    return (torch.stack([(memory @ w).reshape(shape) for w in x["wk"]]),
            torch.stack([(memory @ w).reshape(shape) for w in x["wv"]]))


def test_teacher_forced_decode_matches_forward():
    """Inside the port: decoding through the self K/V cache against the
    cross K/V built from ``encode`` reproduces the full forward at
    2e-3."""
    cfg = get_config(ARCH, smoke=True)
    p = init_model(cfg, 0, "cpu")
    frames = syn.stub_embeddings(1, 30, cfg.d_model, seed=2, device="cpu")
    toks = _t(_tokens(cfg, 1, 24, 9))
    full, _ = encdec.forward_train(p, frames, toks, cfg)
    ck, cv = cross_kv(p, encdec.encode(p, frames, cfg), cfg)
    caches = builder.materialize(encdec.encdec_cache_decl(cfg, 1, 24, 30),
                                 0, "cpu")
    caches["cross_k"], caches["cross_v"] = ck, cv
    outs = []
    for t in range(24):
        logits, caches = encdec.forward_decode(p, caches, toks[:, t:t + 1],
                                               t, cfg)
        outs.append(logits[:, 0])
    _close(torch.stack(outs, 1), full, 2e-3)


def test_stub_embeddings_are_seeded():
    a = syn.stub_embeddings(2, 5, 16, seed=3, device="cpu")
    b = syn.stub_embeddings(2, 5, 16, seed=3, device="cpu")
    c = syn.stub_embeddings(2, 5, 16, seed=4, device="cpu")
    assert a.shape == (2, 5, 16) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert 0.5 < float(a.std()) < 1.5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            syn.stub_embeddings(1, 2, 3)
