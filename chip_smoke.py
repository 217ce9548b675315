#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA
Hopper card: builds the CUDA kernels from this checkout, holds each one
against its plain PyTorch version at the main path's shapes, drives
``BMoESystem.evaluate`` at the paper's full width (N=10 experts, M=10
edges, K=3, MLP experts 784->256->10, sparse dispatch, edge cache on),
and checks the launches and the trust claims.

    python3 chip_smoke.py

Prints, in order: the card's name and power limit (nvidia-smi), the
build time, one JSON line per kernel case, the main-path lines, one
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no last line is printed.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero too.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

FP32_PEAK = 67e12        # H100 SXM, fp32 outside the tensor cores
BF16_PEAK = 989e12       # H100 SXM, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``reps`` times between two CUDA events.  The
    graph takes the host's launch overhead out of the reading, so a
    kernel shorter than a Python call is not timed as the call.
    Operands stay in L2 between calls, as on the path."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):                      # warm up off the capture
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------ kernels
def check_moe_gemm(torch, mg, ref, seed: int, name: str, E: int, C: int,
                   d: int, f: int, dtype):
    g = torch.Generator().manual_seed(seed)
    buf = torch.randn(E, C, d, generator=g).to("cuda", dtype)
    w = torch.randn(E, d, f, generator=g).to("cuda", dtype)
    got = mg.moe_gemm(buf, w)
    want = ref.moe_gemm_ref(buf, w)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = (got.float() - want.float()).abs()
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                             atol=tol * 8))
    size = buf.element_size()
    b_ms, b_by = bound(2.0 * E * C * d * f,
                       (E * C * d + E * d * f + E * C * f) * size,
                       FP32_PEAK if dtype == torch.float32 else BF16_PEAK)
    row = {"case": name, "kernel": "moe_gemm",
           "shape": f"({E},{C},{d})x({E},{d},{f})",
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": float(err.max()), "rtol": tol, "atol": tol * 8,
           "ok": ok,
           "kernel_ms": time_ms(lambda: mg.moe_gemm(buf, w)),
           "plain_ms": time_ms(lambda: ref.moe_gemm_ref(buf, w)),
           "library_ms": time_ms(lambda: torch.bmm(buf, w)),
           "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    require(ok, f"moe_gemm {name} disagrees with its plain version "
                f"(max abs err {row['max_abs_err']})")
    return row


def _bitwise_equal(torch, a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def check_vote(torch, rv, ref, seed: int, name: str, E: int, M: int, T: int,
               n_bad: int = 0, inactive=(), specials: bool = False):
    g = torch.Generator().manual_seed(seed)
    honest = torch.randn(E, 1, T, generator=g)
    pub = honest.expand(E, M, T).clone()
    if n_bad:
        # a colluding coalition: identical corrupted copies
        pub[:, M - n_bad:] += 5.0 * torch.randn(E, 1, T, generator=g)
    if specials:
        pub[0, 1, 3] = float("nan")        # copy 1 of expert 0 disagrees
        pub[1, :, 5] = float("inf")        # inf - inf: nobody agrees
        pub[2, 0, T - 1] = float("-inf")
    active = torch.ones(M)
    active[list(inactive)] = 0.0
    pub, active = pub.cuda(), active.cuda()
    got = rv.redundancy_vote_masked(pub, active)
    want = ref.redundancy_vote_masked_ref(pub, active)
    torch.cuda.synchronize()
    ok = (_bitwise_equal(torch, got[0], want[0])
          and torch.equal(got[1], want[1]) and torch.equal(got[2], want[2]))
    nbytes = (E * M * T + M) * 4 + (E * T + E + E * M) * 4
    b_ms, b_by = bound(3.0 * E * T * M * (M + 1) / 2, nbytes, FP32_PEAK)
    row = {"case": name, "kernel": "redundancy_vote",
           "shape": f"pub ({E},{M},{T})", "dtype": "float32",
           "inactive": list(inactive), "colluding_bad": n_bad,
           "specials": specials, "max_abs_err": 0.0 if ok else None,
           "exact": bool(ok),
           "support": got[1].tolist()[:4],
           "kernel_ms": time_ms(lambda: rv.redundancy_vote_masked(pub,
                                                                  active)),
           "plain_ms": time_ms(lambda: ref.redundancy_vote_masked_ref(
               pub, active)),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    require(ok, f"vote {name} differs from its plain version")
    return row


# ----------------------------------------------------------- main path
def main_path(torch, np, ops):
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    from repro_torch.data.synthetic import FMNIST, make_image_dataset

    _, _, xte, yte = make_image_dataset(FMNIST, n_train=1000, n_test=2000,
                                        seed=0)
    xte = xte.reshape(len(xte), -1)
    x1 = xte[:1000]

    t0 = time.perf_counter()
    sys_b = BMoESystem(BMoEConfig(framework="bmoe"), device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # the main path: two evaluate batches of 1000, counts read around it
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    acc = sys_b.evaluate(xte, yte, batch=1000)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    emit({"phase": "main_path", "framework": "bmoe", "batches": 2,
          "batch": 1000, "launches": counts, "accuracy": acc,
          "init_s": init_s, "evaluate_s": first_s})
    require(counts == {"moe_gemm": 4, "redundancy_vote": 2},
            f"evaluate of 2 batches launched {counts}, wanted 4 moe_gemm "
            f"and 2 vote launches")
    require(0.0 <= acc <= 1.0, f"accuracy {acc}")

    # warm per-batch time, host clock around synchronised batches
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        sys_b.infer(x1, commit=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    prof = profile_batch(torch, sys_b, x1)
    wall_ms = sorted(walls)[len(walls) // 2] * 1e3
    emit({"phase": "batch_time", "framework": "bmoe", "batch": 1000,
          "wall_ms": [w * 1e3 for w in walls],
          "device_busy_ms": prof["device_busy_us"] / 1e3,
          "device_idle_share": 1.0 - prof["device_busy_us"] / 1e3 / wall_ms,
          "profile": prof["top"]})

    # trust claims on the card
    clean, _, sup0 = sys_b.infer(x1, attack=AttackConfig())
    require(clean.shape == (1000, 10) and bool(np.isfinite(clean).all()),
            f"logits shape {clean.shape} / finite")
    a3 = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                      noise_std=5.0)
    a6 = AttackConfig(malicious_edges=(4, 5, 6, 7, 8, 9), attack_prob=1.0,
                      noise_std=5.0)
    l3, _, sup3 = sys_b.infer(x1, attack=a3)
    l6, _, sup6 = sys_b.infer(x1, attack=a6)
    emit({"phase": "attacks", "framework": "bmoe",
          "support_clean": sup0.tolist(), "support_3of10": sup3.tolist(),
          "support_6of10": sup6.tolist(),
          "bitwise_equal_3of10": bool(np.array_equal(clean, l3)),
          "max_abs_diff_6of10": float(np.abs(clean - l6).max())})
    require(np.array_equal(clean, l3), "3 of 10 colluding edges changed "
                                       "the logits")
    require((sup3 == 7).all(), f"3 of 10: support {sup3.tolist()}")
    require(not np.array_equal(clean, l6), "6 of 10 did not flip the vote")
    require((sup6 == 6).all(), f"6 of 10: support {sup6.tolist()}")

    sys_t = BMoESystem(BMoEConfig(framework="traditional"), device="cuda")
    lt_clean, _, _ = sys_t.infer(x1, attack=AttackConfig())
    ops.reset_launch_counts()
    lt3, _, _ = sys_t.infer(x1, attack=a3)
    torch.cuda.synchronize()
    counts_t = ops.launch_counts()
    emit({"phase": "traditional", "launches": counts_t,
          "max_abs_diff_3of10": float(np.abs(lt3 - lt_clean).max())})
    require(counts_t == {"moe_gemm": 2, "redundancy_vote": 0},
            f"traditional batch launched {counts_t}")
    require(not np.array_equal(lt3, lt_clean),
            "traditional under 3 of 10 equals clean")

    # the port's CPU path on the same batch (same seeded init)
    sys_c = BMoESystem(BMoEConfig(framework="bmoe"), device="cpu")
    cpu_logits, _, _ = sys_c.infer(x1, attack=AttackConfig())
    gate_cpu = (torch.from_numpy(x1) @ sys_c.gate["w"] + sys_c.gate["b"])
    top = torch.sort(gate_cpu, dim=-1, descending=True, stable=True)[0]
    margin = (top[:, 2] - top[:, 3]).numpy()       # k-th vs (k+1)-th
    rows_ok = np.isclose(cpu_logits, clean, rtol=1e-4, atol=1e-4).all(-1)
    emit({"phase": "cpu_vs_card", "rows": 1000,
          "rows_within_1e-4": int(rows_ok.sum()),
          "max_abs_diff": float(np.abs(cpu_logits - clean).max()),
          "min_topk_margin_of_other_rows": (float(margin[~rows_ok].min())
                                            if (~rows_ok).any() else None)})
    # a row may only differ where the gate's k-th and (k+1)-th logits
    # nearly tie, so the CPU's and cuBLAS's last ulp route it differently
    require(bool((margin[~rows_ok] < 1e-5).all()),
            "the CPU path and the card disagree beyond a routing near-tie")
    require(int((~rows_ok).sum()) <= 5, "too many rows differ")
    return counts


def profile_batch(torch, sys_b, x1):
    """Device time by kernel (and copy) over one warm evaluate batch,
    from torch.profiler's CUDA activities."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sys_b.infer(x1, commit=False)
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA or ev.key.startswith("Activity"):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        rows.append((float(dev_us), ev.key, ev.count))
    rows.sort(reverse=True)
    return {"device_busy_us": sum(r[0] for r in rows),
            "top": [{"name": k[:70], "device_us": us, "count": c}
                    for us, k, c in rows[:8]]}


# ---------------------------------------------------------- entry point
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "script runs on the card only", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "src"))
    import numpy as np
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import redundancy_vote as rv

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references stay
    torch.backends.cudnn.allow_tf32 = False         # fp32 (no TF32)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)

    t0 = time.perf_counter()
    build.library()
    log = (build.library_path().parent / "nvcc.log").read_text()
    ptxas = [ln.strip() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s ({build.library_path()})",
          flush=True)
    for ln in ptxas:
        print(f"  ptxas: {ln}", flush=True)

    gemm = [check_moe_gemm(torch, mg, ref, 1, "layer1", 10, 376, 784, 256,
                           torch.float32),
            check_moe_gemm(torch, mg, ref, 2, "layer2", 10, 376, 256, 10,
                           torch.float32)]
    check_moe_gemm(torch, mg, ref, 3, "ragged", 2, 100, 50, 70,
                   torch.float32)
    check_moe_gemm(torch, mg, ref, 4, "layer1_bf16", 10, 376, 784, 256,
                   torch.bfloat16)
    check_moe_gemm(torch, mg, ref, 5, "layer2_bf16", 10, 376, 256, 10,
                   torch.bfloat16)
    vote = check_vote(torch, rv, ref, 6, "path", 10, 10, 3760, n_bad=3)
    check_vote(torch, rv, ref, 7, "majority_flips", 10, 10, 3760, n_bad=6)
    check_vote(torch, rv, ref, 8, "masked", 10, 10, 3760, n_bad=4,
               inactive=(0, 2))
    check_vote(torch, rv, ref, 9, "nan_inf_tail", 4, 5, 1500, n_bad=1,
               specials=True)
    check_vote(torch, rv, ref, 10, "max_edges", 3, 32, 300, n_bad=15)

    counts = main_path(torch, np, ops)

    emit({"kernels": [
        {"name": "moe_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm.py:29",
         "launches": counts["moe_gemm"],
         "per": "one evaluate batch of 1000: layer 1 + layer 2 launch",
         "max_abs_err": max(r["max_abs_err"] for r in gemm),
         "ms": sum(r["kernel_ms"] for r in gemm),
         "plain_ms": sum(r["plain_ms"] for r in gemm),
         "bound_ms": sum(r["bound_ms"] for r in gemm),
         "bound_by": gemm[0]["bound_by"],
         "library_ms": sum(r["library_ms"] for r in gemm)},
        {"name": "redundancy_vote", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vote.cu",
         "replaces": "src/repro/kernels/redundancy_vote.py:39",
         "launches": counts["redundancy_vote"],
         "per": "one evaluate batch of 1000: pub (10,10,3760)",
         "max_abs_err": vote["max_abs_err"], "ms": vote["kernel_ms"],
         "plain_ms": vote["plain_ms"], "bound_ms": vote["bound_ms"],
         "bound_by": vote["bound_by"], "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
