"""The launch tooling of the port (``builder.abstract`` and
``partition_specs``, ``launch/shapes.py``, ``launch/costmodel.py``,
``launch/opanalysis.py``, ``launch/dryrun.py``, ``launch/roofline.py``)
against the JAX package's, and the dry run against real runs on the CPU.

- Exact parity for all eleven configs x the four assigned shapes:
  ``SHAPES``, ``applicable``, ``shape_config``; ``abstract``'s shapes and
  dtypes and ``partition_specs`` leaf by leaf, for the parameter and the
  cache declarations, JAX's ``partition_specs`` fed the rules JAX's
  ``logical_rules`` gives for a stand-in of the production meshes (all it
  reads is the axis names and a ``devices`` array's shape); the cost
  model's numbers, equal as numbers.
- The dry run against real CPU runs: for the smoke configs of
  qwen2-moe-a2.7b, mamba2-2.7b and gemma3-27b (the three of JAX's
  ``test_small_mesh_train_and_decode_compile``), prefill and train, the
  meta run's dot FLOPs equal the CPU run's exactly, and its argument
  bytes the real tensors'.
- The meta route computes nothing (a full-width mamba2 layer at (1,
  4096) with the plain versions made to raise) and ``kernel_route``
  still raises for any other device.
The abstract mesh's bytes against a real gloo world are held in
``tests/test_torch_lm_mesh.py`` (its world of 4 records them)."""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.launch import costmodel as jcost
from repro.launch import shapes as jshapes
from repro.models import builder as jbuilder
from repro.models import encdec as jencdec
from repro.models import transformer as jtfm
from repro import sharding as jsharding
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels import ops, ref
from repro_torch.launch import costmodel, dryrun, opanalysis, roofline
from repro_torch.launch import shapes
from repro_torch.launch.mesh import (abstract_lm_mesh,
                                     production_mesh_shape,
                                     trusted_mesh_shape)
from repro_torch.models import builder
from repro_torch.models import encdec
from repro_torch.models import transformer as tfm

SHAPE_NAMES = tuple(jshapes.SHAPES)
MESHES = {"single": production_mesh_shape(False),
          "multi_pod": production_mesh_shape(True),
          "trusted": trusted_mesh_shape(256, 4)}


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """One intra-op thread while this file runs (small CPU runs on a CPU
    shared by several test workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves(tree, prefix=""):
    """(path, leaf) in sorted-key order; a partition spec (a tuple of
    axis names, JAX's ``PartitionSpec``) or a tensor is a leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def _jmesh(shape, names):
    return types.SimpleNamespace(axis_names=names, devices=np.empty(shape))


def _spec(p):
    """A spec as a tuple, a one-name tuple as the name (JAX's
    ``PartitionSpec`` writes ("data",) as "data"; the same sharding)."""
    def one(a):
        a = tuple(a) if isinstance(a, (list, tuple)) else a
        return a[0] if isinstance(a, tuple) and len(a) == 1 else a
    return tuple(one(a) for a in p)


def _decls(jcfg, cfg, shape_name):
    """(JAX's, the port's) parameter declarations, and for a decode shape
    their cache declarations too."""
    info = jshapes.SHAPES[shape_name]
    out = [(jshapes.param_decl(jcfg), shapes.param_decl(cfg))]
    if info["kind"] == "decode":
        B, S = info["batch"], info["seq"]
        if cfg.is_encoder_decoder:
            m = jshapes.ENCDEC_DECODE_MEMORY
            out.append((jencdec.encdec_cache_decl(jcfg, B, S, m),
                        encdec.encdec_cache_decl(cfg, B, S, m)))
        else:
            out.append((jtfm.cache_decl(jcfg, B, S),
                        tfm.cache_decl(cfg, B, S)))
    return out


# --------------------------------------------------- shapes and specs
def test_shape_table_matches_jax():
    assert shapes.SHAPES == jshapes.SHAPES
    assert shapes.ENCDEC_DECODE_MEMORY == jshapes.ENCDEC_DECODE_MEMORY


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_abstract_and_specs_match_jax(arch):
    """Per shape: ``applicable`` and ``shape_config`` (every field);
    ``abstract`` (bf16 default; int8 KV caches keep their own dtype) and
    the step inputs' shapes and dtypes; ``partition_specs`` of the
    parameters (FSDP as ``abstract_params`` decides it) and of the
    caches, on the three production meshes, leaf by leaf."""
    for name in SHAPE_NAMES:
        for kv_int8 in (False, True):
            jcfg, cfg = jget_config(arch), get_config(arch)
            assert shapes.applicable(cfg, name) == \
                jshapes.applicable(jcfg, name)
            jcfg, cfg = (jshapes.shape_config(jcfg, name),
                         shapes.shape_config(cfg, name))
            if kv_int8:
                jcfg = dataclasses.replace(jcfg, kv_cache_dtype="int8")
                cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
            assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
            for jdecl, decl in _decls(jcfg, cfg, name):
                got = dict(_leaves(builder.abstract(decl)))
                want = dict(_leaves(jbuilder.abstract(jdecl, jnp.bfloat16)))
                assert sorted(got) == sorted(want)
                for path, s in want.items():
                    assert tuple(got[path].shape) == tuple(s.shape), path
                    assert str(got[path].dtype)[6:] == str(s.dtype), path
                    assert got[path].device.type == "meta"
            kind = shapes.SHAPES[name]["kind"]
            for mshape, names in MESHES.values():
                jrules = jsharding.logical_rules(_jmesh(mshape, names),
                                                 jcfg, params=True)
                if not jsharding.use_fsdp(jcfg, kind, mshape[-1]):
                    jrules["embed"] = None
                mesh = abstract_lm_mesh(mshape, names)
                _, pspec = shapes.abstract_params(cfg, mesh=mesh, kind=kind)
                want = dict(_leaves(jbuilder.partition_specs(
                    jshapes.param_decl(jcfg), jrules)))
                got = {p: _spec(s) for p, s in _leaves(pspec)}
                assert {p: _spec(s) for p, s in want.items()} == got
                args, specs = shapes.input_specs(cfg, name, mesh=mesh)
                if kind == "decode":
                    crules = jsharding.logical_rules(_jmesh(mshape, names),
                                                     jcfg)
                    want = dict(_leaves(jbuilder.partition_specs(
                        _decls(jcfg, cfg, name)[1][0], crules)))
                    assert {p: _spec(s) for p, s in want.items()} == \
                        {p: _spec(s) for p, s in _leaves(specs[0])}
            jargs, jspecs = jshapes.input_specs(jcfg, name)
            args, specs = shapes.input_specs(cfg, name)
            assert specs == jspecs          # no mesh: None in every place
            want = [(p, tuple(s.shape), str(s.dtype))
                    for p, s in _leaves(list(jargs))]
            got = [(p, tuple(t.shape), str(t.dtype)[6:])
                   for p, t in _leaves(list(args))]
            assert got == want


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "seamless-m4t-medium"])
def test_abstract_opt_state_matches_jax(arch):
    """AdamW's moments shaped like the parameters, in float32, the step
    an int32 scalar; on a mesh the moments' specs are the parameters'."""
    jp, _ = jshapes.abstract_params(jget_config(arch))
    jstate, _ = jshapes.abstract_opt_state(jp, None)
    params, pspec = shapes.abstract_params(
        get_config(arch), mesh=abstract_lm_mesh(*MESHES["single"]))
    state, sspec = shapes.abstract_opt_state(params, pspec, mesh=True)
    for got, want in ((state.m, jstate.m), (state.v, jstate.v)):
        assert [(p, tuple(t.shape), t.dtype) for p, t in _leaves(got)] == \
            [(p, tuple(t.shape), torch.float32)
             for p, t in _leaves(jax_tree_to_lists(want))]
    assert state.step.shape == () and state.step.dtype == torch.int32
    assert sspec.m is pspec and sspec.v is pspec and sspec.step == ()


def jax_tree_to_lists(tree):
    """JAX's abstract tree with tuples as lists (the port's layout)."""
    if isinstance(tree, dict):
        return {k: jax_tree_to_lists(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [jax_tree_to_lists(v) for v in tree]
    return tree


def test_partition_specs_of_a_rules_dict():
    """Logical axes to mesh axes as ``Sharder.spec`` gives them; an
    unnamed or unruled axis is None."""
    decl = {"w": builder.Leaf((4, 8), ("embed", "ff")),
            "b": [builder.Leaf((8,), (None,))],
            "q": builder.Leaf((2, 3), ("batch", "heads"), dtype="int8")}
    rules = {"embed": ("pod", "data"), "ff": "model", "batch": None}
    assert builder.partition_specs(decl, rules) == {
        "w": (("pod", "data"), "model"), "b": [(None,)],
        "q": (None, None)}
    ab = builder.abstract(decl, torch.float32)
    assert ab["q"].dtype == torch.int8 and ab["w"].dtype == torch.float32
    assert ab["b"][0].shape == (8,) and ab["w"].device.type == "meta"


# --------------------------------------------------------- cost model
def test_cost_model_matches_jax():
    """``param_counts``, ``model_flops`` and ``hbm_bytes`` equal JAX's
    as numbers for every config and shape (single and multi-pod device
    counts)."""
    for arch in ARCH_IDS:
        assert costmodel.param_counts(get_config(arch)) == \
            jcost.param_counts(jget_config(arch))
        for name, shape in shapes.SHAPES.items():
            jcfg = jshapes.shape_config(jget_config(arch), name)
            cfg = shapes.shape_config(get_config(arch), name)
            assert costmodel._attn_layers(cfg) == jcost._attn_layers(jcfg)
            assert costmodel.model_flops(cfg, shape) == \
                jcost.model_flops(jcfg, shape), (arch, name)
            for n_dev in (256, 512):
                assert costmodel.hbm_bytes(cfg, shape, n_dev) == \
                    jcost.hbm_bytes(jcfg, shape, n_dev), (arch, name)


def test_h100_peaks():
    hw = costmodel.HW
    assert (hw["peak_flops_bf16"], hw["peak_flops_tf32"],
            hw["peak_flops_fp32"]) == (989e12, 495e12, 67e12)
    assert (hw["hbm_bw"], hw["hbm_per_chip"], hw["nvlink_bw"]) == \
        (3.35e12, 80e9, 450e9)
    assert costmodel.ROUTE_PEAK["kernel_3xtf32"] == 495e12 / 3
    assert costmodel.ROUTE_PEAK["library_fp32"] == 67e12


# ----------------------------------------- the dry run against real runs
@pytest.mark.parametrize("kind", ["prefill", "train"])
@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b",
                                  "gemma3-27b"])
def test_meta_run_counts_the_cpu_run(arch, kind):
    """The dry run's dot FLOPs (by route and kernel) equal a real CPU
    run's of the same step, exactly; its argument bytes equal the real
    tensors'; the meta run launches nothing and its peak estimate covers
    its inputs."""
    shape = dict(kind=kind, seq=32, batch=2)
    cfg = get_config(arch, smoke=True)
    ops.reset_launch_counts()
    rec = dryrun.run_one(arch, shape, mesh_shape=None, smoke=True,
                         verbose=False)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)
    params, opt, args = dryrun.inputs(cfg, shape, device="cpu", seed=0)
    real = dryrun.count_step(dryrun.make_step_fn(cfg, kind), params, opt,
                             args)
    assert rec["dot_flops"] == real.dot_flops > 0
    assert rec["dot_flops_by_route"] == real.dot_flops_by_route
    assert rec["kernel_flops"] == real.kernel_flops
    assert rec["kernel_calls"] == real.kernel_calls
    assert rec["argument_size_in_bytes"] == dryrun.nbytes((params, opt,
                                                           args))
    assert rec["peak_bytes_estimate"] > rec["argument_size_in_bytes"]
    assert rec["total_collective_bytes"] == 0
    assert roofline.roofline_row(rec)["dominant"] in roofline.LEVERS


def test_kernel_counts_follow_the_formulas():
    """Each wrapper books its formula on the CPU (plain route) and the
    meta route alike, and pauses the library counting inside itself."""
    g = torch.Generator().manual_seed(0)
    E, C, d, f = 3, 5, 4, 6
    for dev in ("cpu", "meta"):
        buf = torch.randn(E, C, d, generator=g).to(dev)
        w = torch.randn(E, d, f, generator=g).to(dev)
        q = torch.randn(1, 8, 2, 4, generator=g).to(dev)
        k = torch.randn(1, 8, 1, 4, generator=g).to(dev)
        with opanalysis.count() as rec:
            out = ops.moe_gemm(buf, w)
            ops.flash_attention(q, k, k, causal=True, window=3)
        assert out.shape == (E, C, f) and out.device.type == dev
        pairs = ops.attention_pairs(8, 8, True, 3)
        assert pairs == 1 + 2 + 6 * 3          # keys (i - 3, i]
        assert rec.kernel_flops == {"moe_gemm": 2 * E * C * d * f,
                                    "flash_attention": 4 * 2 * 4 * pairs}
        assert rec.dot_flops_by_route == {
            "kernel_3xtf32": 2 * E * C * d * f + 4 * 2 * 4 * pairs}
        with opanalysis.count() as rec:
            buf @ w
        assert rec.dot_flops_by_route == {"library_fp32": 2 * E * C * d * f}


# ------------------------------------------------------ the meta route
def test_meta_route_runs_no_plain_version(monkeypatch):
    """A full-width mamba2-2.7b layer's prefill at (1, 4096) on the meta
    device, with every plain version made to raise: it runs, books the
    SSD scan's count and launches nothing."""
    def boom(*a, **k):
        raise AssertionError("a plain version ran on the meta device")
    for name in ("ssd_scan_ref", "attention_ref", "moe_gemm_ref",
                 "rglru_scan_ref", "audit_mlp_ref",
                 "redundancy_vote_winner_ref", "ssd_scan_bwd_ref",
                 "attention_bwd_ref", "rglru_scan_bwd_ref"):
        monkeypatch.setattr(ref, name, boom)
    cfg = get_config("mamba2-2.7b")
    cfg = dataclasses.replace(cfg, num_layers=1, num_blocks=1).validate()
    ops.reset_launch_counts()
    rec = dryrun.run_one("mamba2-2.7b", dict(kind="prefill", seq=4096,
                                             batch=1), mesh_shape=None,
                         cfg=cfg, verbose=False)
    assert rec["kernel_calls"] == {"ssd_scan": 1}
    Q, nc = cfg.ssm_chunk, 4096 // cfg.ssm_chunk
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    pairs = Q * (Q + 1) // 2
    assert rec["kernel_flops"]["ssd_scan"] == 2 * (
        nc * (H * pairs * P + pairs * N) + H * (nc - 1) * 2 * Q * N * P)
    assert ops.launch_counts() == dict.fromkeys(ops.launch_counts(), 0)


def test_kernel_route_raises_for_other_devices():
    assert ops.kernel_route(torch.empty(1, device="meta")) == "meta"
    assert ops.kernel_route(torch.empty(1)) == "plain"
    for dev in ("mps", "xpu", "hpu"):
        with pytest.raises(ValueError):
            ops.kernel_route(types.SimpleNamespace(device=torch.device(dev)))
    with pytest.raises(ValueError):
        ops.resolve_device("meta")


# ----------------------------------------------------- dry run records
def test_dry_run_records_on_the_production_mesh():
    """qwen2-moe-a2.7b's prefill_32k on rank 0 of (16, 16): expert
    parallelism's exchanges booked under JAX's op names (dispatch and
    return all-to-all, the statistics' all-reduce, the next tokens'
    all-gather), the port's rank bytes above JAX's (dense leaves whole),
    decode_32k run on the mesh (its cache split over ``model``, the
    combine's all-gathers and EP's all-to-alls booked) and long_500k
    skipped where JAX skips it."""
    rec = dryrun.run_one("qwen2-moe-a2.7b", "prefill_32k", verbose=False)
    n_moe = get_config("qwen2-moe-a2.7b").num_layers
    assert rec["num_devices"] == 256 and rec["mesh"] == "16x16"
    assert rec["collective_counts"]["all-to-all"] == 2 * n_moe
    assert rec["wire_bytes"]["ep_dispatch"] == rec["wire_bytes"]["ep_return"]
    assert rec["total_collective_bytes"] == sum(rec["wire_bytes"].values())
    assert rec["argument_size_in_bytes"] > rec["jax_argument_size_in_bytes"]
    assert rec["dtype"] == "float32" and rec["fits"] in (True, False)
    row = roofline.roofline_row(rec)
    assert row["collective_s"] == rec["total_collective_bytes"] / 450e9
    dec = dryrun.run_one("qwen2-moe-a2.7b", "decode_32k", verbose=False)
    assert dec["mesh"] == "16x16" and "pending" not in dec
    assert dec["collective_counts"]["all-to-all"] == 2 * n_moe
    assert dec["wire_bytes"]["cache_combine"] > 0
    assert dec["total_collective_bytes"] == sum(dec["wire_bytes"].values())
    md = roofline.to_markdown([row, roofline.roofline_row(dec)], records=[
        dryrun.run_one("qwen2.5-3b", "long_500k", verbose=False)])
    assert "decode_32k" in md and "skipped" in md


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "mamba2-2.7b",
                                  "recurrentgemma-2b", "seamless-m4t-medium"])
def test_dry_run_decode_bytes_follow_jax_specs(arch):
    """A decode step of batch 8 x 256 on the abstract (2, 2) mesh at smoke
    width: the rank's parameters and placed caches are the bytes JAX's
    specs give them (every leaf and cache dimension placed as they say,
    the caches split once), and the two argument columns differ by the
    batch alone: the port gives every rank the whole (8, 1) int32 tokens
    and ``pos`` as an int, JAX's specs split the tokens over data and
    keep a 4-byte ``pos``."""
    rec = dryrun.run_one(arch, dict(kind="decode", seq=256, batch=8),
                         mesh_shape=(2, 2), smoke=True, verbose=False)
    assert rec["placed_argument_size_in_bytes"] == \
        rec["jax_placed_argument_size_in_bytes"]
    assert rec["argument_size_in_bytes"] - rec["jax_argument_size_in_bytes"] \
        == 8 * 4 - (8 // 2) * 4 - 4
