"""The port's LM training pieces against the JAX package, on the CPU:
``lm_loss``, AdamW, the plain backward versions of the attention and
RG-LRU kernels, the differentiable kernel calls of ``kernels.ops``, the
training loop, the launcher and checkpoints.  The train step of every
config, its microbatches and remat are in
``tests/test_torch_lm_train_step.py``.

Inputs are drawn with numpy from seeds and handed to both packages.
Tolerances: the loss and the optimizer at 1e-6 (float32, the same
arithmetic in the same order); the backward versions against ``jax.vjp``
at 1e-5; the ``autograd.Function``s on the CPU against autograd through
the forward's plain version at 1e-5; the loop's first loss at 1e-5.
Checkpoints are held byte for byte: same arrays, same file, digest and
CID in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.configs import get_config as jget_config
from repro.core.ledger import Ledger as JLedger
from repro.core.storage import StorageNetwork as JStorageNetwork
from repro.data import synthetic as jsyn
from repro.models import layers as jlayers
from repro.models import rglru as jrglru
from repro.models import transformer as jtfm
from repro.optim import adamw as jadamw
from repro.train import loop as jloop
from repro_torch.checkpoint import io
from repro_torch.configs import get_config
from repro_torch.convert import (adamw_state_from_numpy,
                                 adamw_state_to_numpy, lm_params_from_numpy,
                                 tree_to_numpy)
from repro_torch.core.ledger import Ledger
from repro_torch.data import synthetic as syn
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tfm
from repro_torch.optim import adamw
from repro_torch.storage.network import StorageNetwork
from repro_torch.train import loop
from repro_torch.train import step
from test_torch_lm_train_step import one_thread


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=what)


# ------------------------------------------------------------- lm_loss
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_jax(masked):
    logits = _rand(0, 2, 7, 33, scale=3.0)
    labels = np.random.default_rng(1).integers(0, 33, (2, 7)).astype(
        np.int32)
    labels[0, :3] = -1                       # an ignored prefix
    mask = (np.random.default_rng(2).random((2, 7)) > 0.3) if masked \
        else None
    want = jtfm.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                        None if mask is None else jnp.asarray(mask))
    got = tfm.lm_loss(_t(logits), _t(labels),
                      None if mask is None else _t(mask))
    _close(got, want, 1e-6)


def test_lm_loss_with_every_label_ignored_is_zero():
    logits = _t(_rand(3, 1, 4, 9))
    assert float(tfm.lm_loss(logits, torch.full((1, 4), -1))) == 0.0


# ------------------------------------------------------------- AdamW
def _tree(seed, scale=1.0):
    """A parameter-shaped tree: nested dicts and a list, to exercise the
    flatten order."""
    return {"w": _rand(seed, 5, 3, scale=scale),
            "blocks": {"0": {"a": _rand(seed + 1, 2, 4, scale=scale),
                             "b": _rand(seed + 2, 4, scale=scale)}},
            "rem": [{"c": _rand(seed + 3, 3, scale=scale)}]}


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _leaves_ref(tree, prefix=""):
    """(path, leaf) of a tree of dicts and lists, keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_ref(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_ref(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _f32(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().float().numpy()
    return np.asarray(jnp.asarray(leaf, jnp.float32))


def _assert_trees(got, want, tol, what):
    g = dict(_leaves_ref(got))
    w = dict(_leaves_ref(want))
    assert sorted(g) == sorted(w)
    for k in w:
        _close(_f32(g[k]), _f32(w[k]), tol, f"{what}{k}")


@pytest.mark.parametrize("clip", [1.0, 0.0])
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_adamw_update_matches_jax(schedule, clip):
    """Three steps on the same params, gradients (large enough that the
    clip bites where it is on) and state: params, moments, step and
    metrics at 1e-6; the port updates in place and returns the same
    tensors."""
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, schedule=schedule,
               grad_clip=clip)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg), adamw.AdamWConfig(**cfg)
    p0 = _tree(10)
    jp, jst = _jtree(p0), jadamw.init(_jtree(p0))
    tp = lm_params_from_numpy(p0, device="cpu")
    tst = adamw.init(tp)
    for s in range(3):
        grads = _tree(20 + 5 * s, scale=3.0)
        jp, jst, jm = jadamw.update(jcfg, _jtree(grads), jst, jp)
        out_p, tst, tm = adamw.update(tcfg, lm_params_from_numpy(
            grads, device="cpu"), tst, tp)
        assert out_p is tp
        _assert_trees(tp, jp, 1e-6, f"step {s} params")
        _assert_trees(tst.m, jst.m, 1e-6, f"step {s} m")
        _assert_trees(tst.v, jst.v, 1e-6, f"step {s} v")
        assert int(tst.step) == int(jst.step) == s + 1
        for k in ("grad_norm", "lr"):
            _close(tm[k], jm[k], 1e-6, k)


def test_adamw_bf16_state_round_trips_like_jax():
    """bf16 moments: read as float32, updated, rounded back to bf16, in
    both packages."""
    cfg = dict(lr=1e-2, warmup_steps=1, total_steps=4)
    p0 = _tree(30)
    jp = _jtree(p0)
    zeros = jax.tree_util.tree_map(lambda a: jnp.zeros(a.shape,
                                                       jnp.bfloat16), jp)
    jst = jadamw.AdamWState(jnp.zeros((), jnp.int32), zeros, zeros)
    tp = lm_params_from_numpy(p0, device="cpu")

    def bf16_zeros(t):
        if isinstance(t, dict):
            return {k: bf16_zeros(v) for k, v in t.items()}
        if isinstance(t, list):
            return [bf16_zeros(v) for v in t]
        return torch.zeros_like(t, dtype=torch.bfloat16)

    tst = adamw.AdamWState(torch.zeros((), dtype=torch.int32),
                           bf16_zeros(tp), bf16_zeros(tp))
    for s in range(3):
        grads = _tree(40 + 5 * s, scale=0.5)
        jp, jst, _ = jadamw.update(jadamw.AdamWConfig(**cfg), _jtree(grads),
                                   jst, jp)
        _, tst, _ = adamw.update(adamw.AdamWConfig(**cfg),
                                 lm_params_from_numpy(grads, device="cpu"),
                                 tst, tp)
    for t in (tst.m, tst.v):
        assert all(leaf.dtype == torch.bfloat16
                   for _, leaf in _leaves_ref(t))
    _assert_trees(tst.m, jst.m, 1e-6, "m")
    _assert_trees(tst.v, jst.v, 1e-6, "v")
    _assert_trees(tp, jp, 1e-6, "params")


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_jax(schedule):
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=20, schedule=schedule)
    for s in range(0, 25, 3):
        _close(adamw.lr_at(adamw.AdamWConfig(**cfg), torch.tensor(s)),
               jadamw.lr_at(jadamw.AdamWConfig(**cfg), jnp.int32(s)), 1e-7,
               f"step {s}")


def test_global_norm_matches_jax():
    tree = _tree(50, scale=2.0)
    _close(adamw.global_norm(lm_params_from_numpy(tree, "cpu")),
           jadamw.global_norm(_jtree(tree)), 1e-6)


def test_adamw_state_carries_across():
    """A JAX AdamW state to the port and back, leaf for leaf."""
    jst = jadamw.AdamWState(jnp.int32(7), _jtree(_tree(60)),
                            _jtree(_tree(61)))
    tst = adamw_state_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                        tuple(jst)), "cpu")
    assert int(tst.step) == 7 and tst.step.dtype == torch.int32
    back = jadamw.AdamWState(*adamw_state_to_numpy(tst))
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jst)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_step_update_is_adamw_on_the_step_gradients():
    """The step's parameter update is ``adamw.update`` on the gradients
    ``make_loss_and_grads`` gives, bit for bit (the update itself is held
    against JAX above, on identical gradients)."""
    cfg = get_config("smollm-360m", smoke=True)
    p1 = loop.init_model(cfg, 0, device="cpu")
    p2 = loop.init_model(cfg, 0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": toks, "labels": toks}
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    with one_thread():
        _, _, m = step.make_train_step(cfg, ocfg)(p1, adamw.init(p1), batch)
        loss, aux, grads = step.make_loss_and_grads(cfg)(p2, batch)
        _, _, m2 = adamw.update(ocfg, grads, adamw.init(p2), p2)
    assert float(m["loss"]) == float(loss + 0 * aux)
    assert float(m["grad_norm"]) == float(m2["grad_norm"])
    for (k, a), (_, b) in zip(_leaves_ref(p1), _leaves_ref(p2)):
        assert torch.equal(a, b), k


def test_train_step_refuses_a_mesh():
    """Training and decode take a mesh (``tests/test_torch_lm_mesh.py``);
    what is refused is the B-MoE vote on a mesh without a replica axis,
    as the JAX package's ``make_trust``, and a decode cache over mesh
    axes the port does not split (only ``model`` or data x model)."""
    import dataclasses

    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.models.builder import materialize
    from repro_torch.models.transformer import cache_decl
    from repro_torch.sharding import shard_caches
    cfg = get_config("smollm-360m", smoke=True)
    mesh = make_lm_mesh((1, 1), device="cpu")
    assert callable(step.make_step(cfg, "decode", mesh=mesh))
    odd = dataclasses.replace(cfg, cache_seq_axes=("data",))
    with pytest.raises(ValueError, match="splits a cache"):
        shard_caches(materialize(cache_decl(odd, 1, 8), 0, "cpu"), odd, mesh)
    trusted = get_config("bmoe-paper", smoke=True)
    with pytest.raises(ValueError, match="replica"):
        step.make_train_step(trusted, adamw.AdamWConfig(), mesh=mesh)
    with pytest.raises(ValueError, match="replica"):
        step.make_step(trusted, "train", mesh=mesh)


# ------------------------------------------------- backward versions
ATTN_CASES = {
    # name: (B, Sq, Sk, H, KH, D, causal, window, softcap, q_offset)
    "causal": (2, 16, 16, 4, 4, 32, True, 0, 0.0, 0),
    "gqa_window_offset": (1, 16, 24, 6, 2, 16, True, 6, 0.0, 8),
    "cross_non_causal": (2, 8, 12, 4, 2, 32, False, 0, 0.0, 0),
    "softcap": (1, 16, 16, 4, 1, 32, True, 0, 5.0, 0),
    # qpos >= Sk + window - 1 has no valid key: uniform weights
    "rows_without_keys": (1, 16, 8, 2, 1, 16, False, 4, 0.0, 8),
}


def _attn_inputs(case, seed=0):
    B, Sq, Sk, H, KH, D = ATTN_CASES[case][:6]
    return (_rand(seed, B, Sq, H, D), _rand(seed + 1, B, Sk, KH, D),
            _rand(seed + 2, B, Sk, KH, D), _rand(seed + 3, B, Sq, H, D))


def _attn_kw(case):
    causal, window, softcap, q_offset = ATTN_CASES[case][6:]
    return dict(causal=causal, window=window, softcap=softcap,
                q_offset=q_offset)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_bwd_ref_matches_jax_vjp(case):
    q, k, v, do = _attn_inputs(case)
    kw = _attn_kw(case)
    _, vjp = jax.vjp(lambda a, b, c: jlayers.blockwise_attention(
        a, b, c, q_chunk=8, kv_chunk=4, **kw), *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    o, lse = ref.attention_ref(_t(q), _t(k), _t(v), return_lse=True, **kw)
    got = ref.attention_bwd_ref(_t(q), _t(k), _t(v), o, _t(do), lse, **kw)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert g.shape == w.shape
        _close(g, w, 1e-5, name)


def test_attention_lse_is_the_rows_logsumexp():
    q, k, v, _ = _attn_inputs("gqa_window_offset", seed=5)
    kw = _attn_kw("gqa_window_offset")
    o, lse = ref.attention_ref(_t(q), _t(k), _t(v), return_lse=True, **kw)
    assert torch.equal(o, ref.attention_ref(_t(q), _t(k), _t(v), **kw))
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    s = np.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, Sq, -1, G, D).astype(
        np.float64), k.astype(np.float64)) * D ** -0.5
    mask = ref.attention_mask(Sq, k.shape[1], "cpu", causal=True, window=6,
                              q_offset=8).numpy()
    s = np.where(mask, s, -np.inf)
    want = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    _close(lse, want.reshape(B, H, Sq), 1e-5)


@pytest.mark.parametrize("S", [1, 5, 64, 65, 130])
def test_rglru_scan_bwd_ref_matches_jax_vjp(S):
    rng = np.random.default_rng(S)
    a = (0.5 + 0.5 * rng.random((2, S, 6))).astype(np.float32)
    b = rng.standard_normal((2, S, 6)).astype(np.float32)
    dh = rng.standard_normal((2, S, 6)).astype(np.float32)
    _, vjp = jax.vjp(jrglru.rglru_scan, jnp.asarray(a), jnp.asarray(b))
    want = vjp(jnp.asarray(dh))
    h = ref.rglru_scan_ref(_t(a), _t(b))
    got = ref.rglru_scan_bwd_ref(_t(a), h, _t(dh))
    for g, w, name in zip(got, want, ("da", "db")):
        _close(g, w, 1e-5, name)


# --------------------------------------- the differentiable kernel calls
def _grads(fn, *xs):
    xs = [x.clone().requires_grad_(True) for x in xs]
    out = fn(*xs)
    cot = torch.from_numpy(_rand(99, *out.shape))
    return torch.autograd.grad(out, xs, cot)


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_ops_flash_attention_gradient_matches_autograd(case):
    """``ops.flash_attention`` under autograd (``_FlashAttention``, its
    plain backward on the CPU) against autograd through
    ``attention_ref``."""
    q, k, v, _ = _attn_inputs(case, seed=7)
    kw = _attn_kw(case)
    got = _grads(lambda a, b, c: ops.flash_attention(a, b, c, **kw),
                 _t(q), _t(k), _t(v))
    want = _grads(lambda a, b, c: ref.attention_ref(a, b, c, **kw),
                  _t(q), _t(k), _t(v))
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        _close(g, w, 1e-5, name)


def test_ops_rglru_scan_gradient_matches_autograd():
    rng = np.random.default_rng(8)
    a = _t((0.5 + 0.5 * rng.random((2, 70, 5))).astype(np.float32))
    b = _t(rng.standard_normal((2, 70, 5)).astype(np.float32))
    got = _grads(ops.rglru_scan, a, b)
    want = _grads(ref.rglru_scan_ref, a, b)
    for g, w, name in zip(got, want, ("da", "db")):
        _close(g, w, 1e-5, name)


def test_ops_moe_gemm_gradient_matches_autograd():
    buf, w = _t(_rand(9, 3, 7, 5)), _t(_rand(10, 3, 5, 4))
    got = _grads(ops.moe_gemm, buf, w)
    want = _grads(ref.moe_gemm_ref, buf, w)
    for g, gw, name in zip(got, want, ("d_buf", "d_w")):
        _close(g, gw, 1e-5, name)


def test_ops_calls_without_autograd_take_the_forward_alone():
    """With nothing to differentiate (no grad mode, or no operand that
    wants a gradient) the calls return plain tensors, as before."""
    q, k, v, _ = _attn_inputs("causal")
    with torch.no_grad():
        out = ops.flash_attention(_t(q).requires_grad_(), _t(k), _t(v))
    assert out.grad_fn is None
    out = ops.moe_gemm(_t(_rand(1, 2, 3, 4)), _t(_rand(2, 2, 4, 5)))
    assert out.grad_fn is None


def test_ops_ssd_scan_stays_differentiable_on_the_cpu():
    """The SSD scan's CPU route is autograd through its plain recurrence
    (its card route refuses a gradient until the backward kernel lands:
    tests/test_torch_cuda.py)."""
    rng = np.random.default_rng(11)
    x = _t(rng.standard_normal((1, 8, 2, 4)).astype(np.float32))
    dt = _t((0.1 + 0.1 * rng.random((1, 8, 2))).astype(np.float32))
    A = _t(-rng.random(2).astype(np.float32))
    Bm = _t(rng.standard_normal((1, 8, 3)).astype(np.float32))
    Cm = _t(rng.standard_normal((1, 8, 3)).astype(np.float32))
    grads = _grads(lambda *t: ops.ssd_scan(*t, chunk=4), x, dt, A, Bm, Cm)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


# ------------------------------------------------------- loop, launcher
def test_train_loop_starts_at_jax_loss_and_falls(monkeypatch):
    """Five steps of smollm-360m's smoke config from JAX's init weights on
    the same synthetic batches of (8, 64) (at (4, 32) the batches' noise
    hides five steps' progress in JAX's run too): the first loss equals
    JAX's at 1e-5 and the loss falls; the history has JAX's keys."""
    jcfg, cfg = jget_config("smollm-360m", True), get_config("smollm-360m",
                                                             True)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=5)
    _, jh = jloop.train(jcfg, jsyn.lm_batches(jcfg.vocab_size, 8, 64), 5,
                        opt_cfg=jadamw.AdamWConfig(**ocfg), log_every=1)
    params = lm_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jloop.init_model(jcfg, 0)), device="cpu")
    # the loop starts from JAX's weights: its init_model gives them
    monkeypatch.setattr(loop, "init_model",
                        lambda cfg, seed=0, device=None: params)
    _, h = loop.train(cfg, syn.lm_batches(cfg.vocab_size, 8, 64), 5,
                      opt_cfg=adamw.AdamWConfig(**ocfg), log_every=1)
    assert [sorted(r) for r in h] == [sorted(r) for r in jh]
    assert [r["step"] for r in h] == list(range(5))
    _close(h[0]["loss"], jh[0]["loss"], 1e-5)
    assert h[-1]["loss"] < h[0]["loss"]


@pytest.mark.parametrize("arch", ["smollm-360m", "seamless-m4t-medium"])
def test_train_launcher_runs_on_the_cpu(arch, capsys):
    hist = launch_train.main(["--arch", arch, "--device", "cpu", "--steps",
                              "3", "--batch", "2", "--seq", "16"])
    out = capsys.readouterr().out
    assert f"[train] arch={arch} smoke=True steps=3" in out
    assert "[train] done: loss" in out
    assert len(hist) == 3 and all(np.isfinite(r["loss"]) for r in hist)


def test_train_launcher_refuses_a_mesh():
    """``--mesh d,m`` trains (``tests/test_torch_lm_mesh.py``) unless the
    config cannot use the mesh: bmoe-paper's vote needs a replica axis,
    and it is refused before any rank starts."""
    with pytest.raises(ValueError, match="replica"):
        launch_train.main(["--device", "cpu", "--mesh", "2,4"])


def test_training_defaults_to_the_card():
    """``train`` (through ``init_model``) and the launcher resolve no
    device to CUDA and raise where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    cfg = get_config("smollm-360m", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.train(cfg, syn.lm_batches(cfg.vocab_size, 2, 8), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch_train.main(["--steps", "1"])


# ---------------------------------------------------------- checkpoints
def _ckpt_tree():
    cfg = get_config("recurrentgemma-2b", smoke=True)
    return loop.init_model(cfg, 0, device="cpu")


def test_checkpoints_cross_packages_byte_for_byte(tmp_path):
    tree = _ckpt_tree()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree_to_numpy(tree))
    d_port = io.save(str(tmp_path / "port.npz"), tree)
    d_jax = jio.save(str(tmp_path / "jax.npz"), jtree)
    assert d_port == d_jax
    assert (tmp_path / "port.npz").read_bytes() == \
        (tmp_path / "jax.npz").read_bytes()
    in_jax = jio.restore(str(tmp_path / "port.npz"), jtree)
    in_port = io.restore(str(tmp_path / "jax.npz"), tree)
    for (k, a), (_, b) in zip(_leaves_ref(in_port), _leaves_ref(tree)):
        assert isinstance(a, torch.Tensor) and a.dtype == b.dtype, k
        assert torch.equal(a, b), k
    for a, b in zip(jax.tree_util.tree_leaves(in_jax),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_storage_cid_and_ledger_match_jax():
    tree = _ckpt_tree()
    jtree = jax.tree_util.tree_map(jnp.asarray, tree_to_numpy(tree))
    net, jnet = StorageNetwork(seed=0), JStorageNetwork(seed=0)
    led, jled = Ledger(), JLedger()
    cid = io.save_to_storage(net, tree, led, meta={"step": 3})
    jcid = jio.save_to_storage(jnet, jtree, jled, meta={"step": 3})
    assert cid == jcid
    assert led.head.payload == jled.head.payload == {
        "step": 3, "kind": "checkpoint", "cid": cid}
    assert led.head.hash == jled.head.hash and led.verify_chain()
    back = io.restore_from_storage(net, cid, tree)
    for (k, a), (_, b) in zip(_leaves_ref(back), _leaves_ref(tree)):
        assert torch.equal(a, b), k
    jback = jio.restore_from_storage(jnet, cid, jtree)
    for a, b in zip(jax.tree_util.tree_leaves(jback),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_optimizer_state_checkpoints_round_trip(tmp_path):
    """The moments and the step, saved and restored as a tree."""
    cfg = get_config("smollm-360m", smoke=True)
    p = loop.init_model(cfg, 0, device="cpu")
    st = adamw.init(p)
    tree = {"params": p, "m": st.m, "v": st.v, "step": st.step}
    io.save(str(tmp_path / "opt.npz"), tree)
    back = io.restore(str(tmp_path / "opt.npz"), tree)
    for (k, a), (_, b) in zip(_leaves_ref(back), _leaves_ref(tree)):
        assert torch.equal(a, b), k
