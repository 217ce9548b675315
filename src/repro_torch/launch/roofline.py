"""Roofline: three terms per (arch x shape x mesh) from the dry run's
records, against one H100's published peaks (the counterpart of
``repro.launch.roofline``; ``costmodel.HW``).

  compute term    = the rank's dot FLOPs by route, each over its route's
                    peak (``costmodel.ROUTE_PEAK``: library float32
                    products at 67 TFLOP/s, the 3xTF32 kernels at 165,
                    bf16 at 989)
  memory term     = the HBM traffic model's bytes (per device, the JAX
                    package's model) / 3.35 TB/s
  collective term = the bytes this rank sends (``EdgeMesh.wire_bytes``:
                    an all-reduce already counted as twice (n-1)/n of its
                    buffer, so JAX's factor 2 is not applied again)
                    / NVLink's 450 GB/s each way

NVLink joins the eight cards of one host; a group wider than a host
crosses the network, slower, so the collective term is a lower bound.
Also reported: MODEL_FLOPS (the analytic useful compute) and the ratio
MODEL_FLOPS / counted FLOPs, which catches remat and redundant work, the
rank's bytes under the port's placement and under JAX's specs, the
estimated peak and whether it fits the card's 80 GB, the dominant term
and a one-line lever.

Usage:
  python -m repro_torch.launch.roofline artifacts/dryrun.json [-o out.md]
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

from repro_torch.launch.costmodel import HW, ROUTE_PEAK, hbm_bytes, model_flops

LEVERS = {
    "compute": ("move float32 library products onto the tensor cores "
                "(3xTF32 or bf16 kernels), lower remat recompute, skip "
                "fully-masked attention tiles"),
    "memory": ("cut HBM traffic: shard or quantize the KV cache, fuse "
               "elementwise chains, keep activations in bf16"),
    "collective": ("cut NVLink bytes: reduce-scatter instead of "
                   "all-reduce + all-gather, NCCL in place of gloo's host "
                   "staging, overlap exchanges with compute, the digest "
                   "vote instead of gathering every replica's copy"),
}


def _shape(rec: dict) -> dict:
    from repro_torch.launch.shapes import SHAPES
    return rec.get("shape_dims") or SHAPES[rec["shape"]]


def roofline_row(rec: dict) -> Optional[dict]:
    """One dry-run record -> its roofline terms (None for a record that
    did not run: skipped or failed)."""
    if any(k in rec for k in ("error", "skipped")):
        return None
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import shape_config
    shape = _shape(rec)
    cfg = shape_config(get_config(rec["arch"], smoke=rec.get("smoke", False)),
                       shape)
    n_dev = rec["num_devices"]
    by_route = rec["dot_flops_by_route"]
    t_compute = sum(f / ROUTE_PEAK[r] for r, f in by_route.items())
    mem = hbm_bytes(cfg, shape, n_dev, rec.get("model_shards", 16))
    t_memory = mem["total"] / HW["hbm_bw"]
    wire = rec["total_collective_bytes"]
    t_coll = wire / HW["nvlink_bw"]
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    flops_dev = rec["dot_flops"]
    return {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "trusted": rec.get("trusted", "off"),
        "compute_s": t_compute, "memory_s": t_memory,
        "collective_s": t_coll, "dominant": dominant,
        "model_flops_total": mf["total"],
        "dot_flops_per_dev": flops_dev,
        "useful_ratio": (mf["total"] / n_dev) / max(flops_dev, 1.0),
        "wire_bytes_per_dev": wire,
        "hbm_bytes_per_dev": mem["total"],
        "rank_bytes_port": rec["argument_size_in_bytes"],
        "rank_bytes_jax": rec["jax_argument_size_in_bytes"],
        "peak_bytes_estimate": rec["peak_bytes_estimate"],
        "fits": rec["fits"],
        "lever": LEVERS[dominant],
    }


def to_markdown(rows, title="Roofline", records=()) -> str:
    """The rows as a table; ``records`` that did not run add a row that
    says why."""
    out = [f"### {title}", "",
           "| arch | shape | mesh | rank GB (port) | rank GB (JAX specs) | "
           "peak GB (est.) | fits | compute (s) | memory (s) | "
           "collective (s) | dominant | MODEL_FLOPS | useful ratio |",
           "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r is None:
            continue
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {r['rank_bytes_port'] / 1e9:.2f} "
            f"| {r['rank_bytes_jax'] / 1e9:.2f} "
            f"| {r['peak_bytes_estimate'] / 1e9:.1f} "
            f"| {'yes' if r['fits'] else 'no'} "
            f"| {r['compute_s']:.2e} | {r['memory_s']:.2e} "
            f"| {r['collective_s']:.2e} | **{r['dominant']}** "
            f"| {r['model_flops_total']:.2e} | {r['useful_ratio']:.2f} |")
    for rec in records:
        for why in ("skipped", "error"):
            if why in rec:
                out.append(f"| {rec['arch']} | {rec['shape']} | "
                           f"{rec.get('mesh', '')} | {why}: "
                           f"{str(rec[why])[:60]} |" + " |" * 9)
    return "\n".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("records", nargs="+")
    ap.add_argument("-o", "--out", default=None)
    args = ap.parse_args(argv)
    rows, idle = [], []
    for path in args.records:
        with open(path) as f:
            for rec in json.load(f):
                row = roofline_row(rec)
                (rows.append(row) if row else idle.append(rec))
    md = to_markdown(rows, records=idle)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
    print(md)


if __name__ == "__main__":
    main()
