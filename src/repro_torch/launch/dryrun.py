"""Dry run: what one rank holds, computes and sends for every
(architecture x input shape x mesh), without a card (the counterpart of
``repro.launch.dryrun``).

JAX lowers and compiles each combination for 256 or 512 host devices and
reads XLA's analyses.  The port runs SPMD, one process a device, so the
dry run runs one rank's step itself, on the meta device: the inputs are
``launch.shapes``' meta stand-ins in float32 (the dtype the port runs),
the parameters cut to the rank's part (``sharding.shard_params``: expert
rows over ``model``, dense leaves whole), the mesh an abstract one
(``launch.mesh.abstract_lm_mesh``: exchanges make shapes and count
bytes), the kernels their meta route (``kernels.ops``: shapes and a FLOP
count, no work), and ``launch.opanalysis`` counts the step's dot FLOPs
by route, its collective bytes by op and exchange, and the storages it
keeps alive at once.

Each record holds the JAX package's keys where they apply
(``num_devices``, ``dot_flops``, ``collective_bytes``,
``collective_counts``, ``total_collective_bytes``,
``argument_size_in_bytes``) and adds:

- ``argument_size_in_bytes``: the rank's inputs under the port's
  placement; ``jax_argument_size_in_bytes``: the same inputs split by the
  JAX package's partition specs (FSDP and tensor parallelism included);
- ``peak_bytes_estimate``: the inputs plus the most bytes the step's own
  storages held at once on the meta device, an estimate of the card's
  ``max_memory_allocated`` (no allocator rounding, no kernel scratch),
  and ``fits``: the estimate within the card's 80 GB.

Decode takes no mesh yet (``train.step._refuse_mesh``, ROADMAP A7c):
decode shapes on a mesh give ``{"pending": ...}``.  ``long_500k`` is
skipped for quadratic architectures (``shapes.applicable``).  Steps run
with remat on, as the JAX package's do; ``--no-unroll`` has no
counterpart (the port's layers are a loop).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k [--multi-pod]
  python -m repro_torch.launch.dryrun --all [--multi-pod] --out artifacts/dryrun.json
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Optional

import torch

from repro_torch.core.ledger import tree_flatten
from repro_torch.launch import opanalysis
from repro_torch.launch import shapes as shp
from repro_torch.launch.costmodel import HW

PENDING_DECODE = "A7c: decode on a mesh"


def mesh_for(mesh_shape="production", *, multi_pod: bool = False,
             trusted: str = "off", redundancy_r: int = 4, rank: int = 0):
    """The abstract mesh of a run: "production" is the production mesh,
    or the trusted one of as many ranks when ``trusted`` is on; a tuple
    is that shape (axis names as ``make_lm_mesh`` defaults them); None is
    no mesh."""
    from repro_torch.launch.mesh import (abstract_lm_mesh,
                                         production_mesh_shape,
                                         trusted_mesh_shape)
    if mesh_shape is None:
        return None
    if mesh_shape == "production":
        shape, axes = production_mesh_shape(multi_pod)
        if trusted != "off":
            shape, axes = trusted_mesh_shape(math.prod(shape), redundancy_r,
                                             multi_pod=multi_pod)
        return abstract_lm_mesh(shape, axes, rank=rank)
    return abstract_lm_mesh(tuple(mesh_shape), rank=rank)


def _mesh_name(mesh) -> str:
    return "x".join(map(str, mesh.shape)) if mesh is not None else "none"


def inputs(cfg, shape, mesh=None, device="meta", seed: int = 0):
    """(params, optimizer state or None, step args) of one rank's step of
    ``shape`` (a ``SHAPES`` name or dict): on the meta device the
    abstract stand-ins, on a real device tensors drawn from ``seed``
    (parameters by ``train.loop.init_model``, tokens uniform over the
    vocabulary, embeddings normal).  Float32 throughout; the batch is the
    global one (every rank is given it); decode's ``pos`` is the int
    ``seq - 1``."""
    from repro_torch.core.ledger import tree_unflatten
    from repro_torch.optim import adamw
    from repro_torch.sharding import shard_params
    from repro_torch.train.loop import init_model
    info = shp.shape_info(shape)
    device = torch.device(device)
    if device.type == "meta":
        params = shard_params(shp.abstract_params(cfg, dtype=torch.float32)[0],
                              cfg, mesh)
    else:
        params = init_model(cfg, seed, device, mesh=mesh)
    args, _ = shp.input_specs(cfg, shape, mesh=None, dtype=torch.float32)
    if device.type != "meta":
        gen = torch.Generator().manual_seed(seed)
        leaves, _ = tree_flatten(args)
        args = tree_unflatten(args, [
            (torch.randint(0, cfg.vocab_size, t.shape, generator=gen,
                           dtype=torch.int32) if t.dtype == torch.int32
             else torch.randn(t.shape, generator=gen)).to(device)
            for t in leaves])
    opt = adamw.init(params) if info["kind"] == "train" else None
    if info["kind"] == "decode":
        args[1]["pos"] = info["seq"] - 1
    return params, opt, args


def make_step_fn(cfg, kind: str, mesh=None, remat: bool = True):
    """The port's step of ``kind`` as a user builds it."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (make_decode_step, make_prefill_step,
                                        make_train_step)
    if kind == "train":
        return make_train_step(cfg, AdamWConfig(total_steps=1000), mesh,
                               remat=remat)
    if kind == "prefill":
        return make_prefill_step(cfg, mesh)
    return make_decode_step(cfg)


def nbytes(tree) -> int:
    """Bytes of every tensor in ``tree``."""
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def _spec_bytes(t: torch.Tensor, spec, axes) -> int:
    """Bytes of one device's shard of ``t`` under partition ``spec``."""
    n = t.element_size()
    for dim, s in zip(t.shape, spec or (None,) * t.dim()):
        names = () if s is None else ((s,) if isinstance(s, str) else s)
        n *= -(-dim // math.prod(axes.get(a, 1) for a in names))
    return n


def jax_argument_bytes(cfg, shape, mesh, args, kind: str) -> int:
    """One device's bytes of the step's inputs in float32 under the JAX
    package's partition specs (``shapes.abstract_params`` and
    ``input_specs``; the optimizer's moments as the parameters)."""
    axes = dict(zip(mesh.axis_names, mesh.shape))
    p_abs, p_spec = shp.abstract_params(cfg, mesh=mesh, dtype=torch.float32,
                                        kind=kind)
    _, a_spec = shp.input_specs(cfg, shape, mesh=mesh, dtype=torch.float32)

    def walk(tree, specs):             # the specs' tree follows the tensors'
        if isinstance(tree, torch.Tensor):
            return _spec_bytes(tree, specs, axes)
        if isinstance(tree, dict):
            return sum(walk(tree[k], specs[k]) for k in tree)
        return sum(walk(t, s) for t, s in zip(tree, specs))

    params = walk(p_abs, p_spec)
    moments = 2 * params + 4 if kind == "train" else 0
    return params + moments + walk(args, a_spec)


def count_step(step, params, opt, args, track_memory: bool = False):
    """Runs ``step`` once under ``opanalysis.count`` and returns the
    record (a training step's parameters and moments are updated in
    place, as a real step's are)."""
    with opanalysis.count(track_memory=track_memory) as rec:
        if opt is not None:
            step(params, opt, *args)
        else:
            step(params, *args)
    return rec


def run_one(arch: str, shape="train_4k", *, multi_pod: bool = False,
            trusted: str = "off", redundancy_r: int = 4,
            kv_int8: bool = False, mesh_shape="production", rank: int = 0,
            smoke: bool = False, cfg=None, remat: bool = True,
            verbose: bool = True) -> dict:
    """One (arch, shape, mesh) combination on the meta device; returns
    its record.  ``shape`` is a ``SHAPES`` name or such a dict;
    ``mesh_shape`` as ``mesh_for`` takes it; ``cfg`` overrides the
    config ``arch`` names (``smoke``: its smoke width)."""
    from repro_torch.configs import get_config
    from repro_torch.models.config import RedundancyConfig
    info = shp.shape_info(shape)
    info = {k: info[k] for k in ("kind", "seq", "batch")}
    name = (shape if isinstance(shape, str) else
            f"{info['kind']}_{info['batch']}x{info['seq']}")
    cfg = cfg or get_config(arch, smoke=smoke)
    head = {"arch": arch, "shape": name}
    if isinstance(shape, str):
        ok, reason = shp.applicable(cfg, shape)
        if not ok:
            return {**head, "skipped": reason}
    if trusted != "off":
        cfg = dataclasses.replace(
            cfg, redundancy=RedundancyConfig(r=redundancy_r, mode=trusted))
    mesh = mesh_for(mesh_shape, multi_pod=multi_pod, trusted=trusted,
                    redundancy_r=redundancy_r, rank=rank)
    cfg = shp.shape_config(cfg, info)
    if kv_int8:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    kind = info["kind"]
    head.update(kind=kind, mesh=_mesh_name(mesh), trusted=trusted,
                kv_int8=kv_int8, dtype="float32",
                num_devices=mesh.world if mesh is not None else 1,
                rank=rank, shape_dims=info, smoke=smoke,
                model_shards=mesh.size("model") if mesh is not None else 1)
    if kind == "decode" and mesh is not None:
        return {**head, "pending": PENDING_DECODE}

    params, opt, args = inputs(cfg, info, mesh)
    arg_bytes = nbytes((params, opt, args))
    step = make_step_fn(cfg, kind, mesh, remat=remat)
    t0 = time.perf_counter()
    rec = count_step(step, params, opt, args, track_memory=True)
    run_s = time.perf_counter() - t0
    peak = arg_bytes + rec.peak_live_bytes
    record = {**head, **rec.as_dict(),
              "argument_size_in_bytes": arg_bytes,
              "jax_argument_size_in_bytes": (
                  jax_argument_bytes(cfg, info, mesh, args, kind)
                  if mesh is not None else arg_bytes),
              "peak_bytes_estimate": peak,
              "fits": peak <= HW["hbm_per_chip"],
              "remat": remat, "run_s": round(run_s, 2)}
    if verbose:
        print(f"[dryrun] {arch} x {name} x {record['mesh']} "
              f"(trusted={trusted}): RAN on meta in {run_s:.1f}s")
        print(f"  args={arg_bytes:.3e} B (JAX specs "
              f"{record['jax_argument_size_in_bytes']:.3e}), peak "
              f"estimate {peak:.3e} B, fits={record['fits']}")
        print(f"  dot_flops={record['dot_flops']:.3e} "
              f"{record['dot_flops_by_route']}")
        print(f"  collectives: {record['total_collective_bytes']:.3e} B "
              f"{ {k: v for k, v in record['collective_counts'].items() if v} }")
    return record


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(shp.SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--trusted", default="off",
                    choices=["off", "faithful", "digest"])
    ap.add_argument("--redundancy-r", type=int, default=4)
    ap.add_argument("--out", default=None, help="JSON output path")
    ap.add_argument("--kv-int8", action="store_true",
                    help="int8-quantized decode KV cache")
    args = ap.parse_args(argv)

    from repro_torch.configs import ARCH_IDS
    if args.all:
        combos = [(a, s) for a in ARCH_IDS if a != "bmoe-paper"
                  for s in shp.SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        combos = [(args.arch, args.shape)]

    records = []
    for arch, shape_name in combos:
        try:
            rec = run_one(arch, shape_name, multi_pod=args.multi_pod,
                          trusted=args.trusted,
                          redundancy_r=args.redundancy_r,
                          kv_int8=args.kv_int8)
        except Exception as e:  # a failure here is a bug in the system
            rec = {"arch": arch, "shape": shape_name, "error": repr(e)[:500]}
            print(f"[dryrun] {arch} x {shape_name}: FAILED {e!r}")
        for why in ("skipped", "pending"):
            if why in rec:
                print(f"[dryrun] {arch} x {shape_name}: {why} ({rec[why]})")
        records.append(rec)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=2)
        print(f"[dryrun] wrote {len(records)} records to {args.out}")
    failed = [r for r in records if "error" in r]
    if failed:
        raise SystemExit(f"{len(failed)} combinations FAILED")


if __name__ == "__main__":
    main()
