#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA
Hopper card: builds the CUDA kernels from this checkout, holds each one
against its plain PyTorch version at the main paths' shapes, and drives
the port's two main paths at the paper's full width (N=10 experts, M=10
edges, K=3, MLP experts 784->256->10, batch 1000, sparse dispatch at
capacity 376, edge cache on):

- ``BMoESystem.evaluate`` under ``bmoe`` (and ``traditional``), with the
  redundancy-vote trust claims;
- optimistic batch inference (``infer(commit=True)`` + ``flush_trust``):
  commit, merged audits, court, slash and rollback, under an attacking
  executor (path A) and under re-audit of honest verifiers (path B);
- the LM stack's prefill and decode at full width, random weights from
  seed 0: qwen2.5-3b (path C: prefill at S=4096, teacher-forced decode
  against the full forward, four requests decoded greedily in one batch
  against each alone, a profile), recurrentgemma-2b (path D, 2 of its 8
  blocks and the 2 remainder layers: prefill at S=4096, teacher-forced
  decode past its 2048-token window) and mamba2-2.7b (path E, 32 of 64
  layers: prefill at S=4096, 32 SSD chunks, teacher-forced decode over
  384 tokens across two chunk boundaries, four requests decoded in one
  batch against each alone);
- the rest of the LM configs (paths H, I and J), prefill at 4,096
  positions and decode against the forward: the MoE models bmoe-paper
  and qwen2-moe-a2.7b at full width and llama4-maverick-400b-a17b at
  its smoke width (path H: 3 moe_gemm launches a MoE layer; decode with
  expert counts held to a recount of the routing, against the forward
  at the config's capacity and at one that drops nothing, every routing
  difference explained by a near-tie or an earlier drop; batched decode
  equal to each request alone bit for bit; qwen2-moe-a2.7b 12 of its
  24 layers); qwen3-32b (12 of 64 layers), gemma3-27b (8 of 62) and
  pixtral-12b (20 of 40) with its 1,024 patch embeddings (path I);
  seamless-m4t-medium over 4,096 frames, decoded against cross K/V
  built from its encoder's memory (path J);
- the serving engine (path K, on the weights of paths C and H while
  they are on the card): K1, qwen2-moe-a2.7b at full width (12 of 24
  layers), six requests through continuous batching with verified
  sessions (4 slots,
  cache 512, chunks up to 16; moe_gemm launched 3 times a MoE layer for
  each micro-step the engine counts; the fixed policy, each request
  alone and a tampered session checked; one decode and one prefill chunk
  profiled; the cache update's cost and a micro-step's host syncs); K2,
  bmoe-paper with its 120 expert units in the chunked store and KV
  blocks under one cache budget of half the experts' bytes, against a
  plain engine bit for bit; K3, qwen2.5-3b with KV paging (warm prefix,
  page-out and resume, tick roots against paging off, DA challenges);
- LM training (path L, through ``train`` and ``make_train_step``, the
  attention, RG-LRU, SSD and MoE products forward and backward through
  their kernels): L1, bmoe-paper at full width and depth from seed 0, 4
  steps of (2, 2048) with the loss falling, two steps from one state
  bitwise equal, one layer against the CPU by gradients and one step
  profiled; L2, recurrentgemma-2b at full width on D's weights, 2 steps
  of (2, 4096) over its 2 microbatches with remat; L3,
  seamless-m4t-medium over 4,096
  frames and 512 tokens, 2 steps; L4, mamba2-2.7b at full width on path
  E's weights, 2 steps of (4, 4096) over its 4
  microbatches with remat, the SSD backward's share of a profiled step,
  one layer against the CPU by gradients; each path's launches held to
  the config's count;
- B-MoE training (path F): ``train_round`` under ``traditional`` and
  ``bmoe``, 30 clean rounds each on tasks of 1000, then the paper's
  claim under 3 of 10 colluding edges (bmoe holds its clean accuracy,
  traditional loses more than 0.1); poisoned uploads outvoted; two runs
  and edge cache on/off bitwise equal; one round against the CPU; a
  profile of a warm round.  A round launches moe_gemm 5 times (2 forward,
  3 backward) and, under bmoe, the vote once;
- optimistic training and the CNN experts (path G): G1, three edges that
  always cheat, slashed and excluded within 20 rounds of 1000, one
  rollback per stake event, accuracy after 12 rounds within 0.02 of a
  clean twin; G2, a fraud convicted after a descendant committed, the
  chain replayed to the clean twin's bits, pipelined equal to
  synchronous and batched equal to eager; G3, a withheld chunk caught by
  the training rounds' DA challenges (one da_slash block); G4, the
  CIFAR-10 CNN bank under bmoe and traditional (card against CPU,
  repeatable, one dense-dispatch round's vote against its plain
  version).  Launches are held against the run's own records: 5
  moe_gemm a round and a replayed round, one audit_mlp a commitment and
  a counted recompute call, one vote a court escalation;
- federated training (path M, ``repro_torch.fed``) at the paper's
  expert width (10 edges owning 2 of 10 experts each, top-3,
  784->256->10, 4 local steps of 64, Dirichlet shards of 10,000): M1, 6
  clean verified rounds, all finalized; M2, edge 2 poisoning (gradient
  scaling x200, sign flip x5) under the defended rule and plain FedAvg;
  M3, a dishonest aggregator convicted by the recompute court, slashed
  and rolled back to a clean twin's bits; M4, two seeded runs bitwise
  equal and a round against the CPU; M5, a profiled warm round and the
  host syncs of a local update.  The federated step's dense mixture is
  plain products (the JAX package's reaches no Pallas kernel), so the
  path's launch counts are held to zero;
- B-MoE on an edge mesh (path N, ``BMoEConfig(mesh="on")``): five ranks
  on the one card (``launch.mesh.spawn_edges``, gloo), each an edge
  shard holding 2 of the 10 experts, at the paper's width: N1, 5
  optimistic rounds with edge 2 cheating, audit rate 1, then
  ``flush_trust`` and ``infer``; N2, ``bmoe`` and ``traditional`` 3
  rounds each under 3 colluders; every rank bitwise equal to the
  one-device system run first in this process (parameters, roots,
  phases, proofs, the chain, logits); N3, ``moe_gemm``, the vote and
  ``audit_mlp`` at the shard shapes against their plain versions and
  bitwise equal to the full-E launch's rows; N4, each rank's launches
  (5 ``moe_gemm`` and, under bmoe, 1 vote a round; ``audit_mlp`` as
  the records count); N5, round walls on and off and each exchange's
  bytes a rank.  The ranks load the library this process built, print
  nothing and are all joined; a failing rank fails the path;
- the LM stack on a mesh (path O, ``launch.mesh.LMMesh``, ranks sharing
  the card over gloo, full width, depth cut): O1, qwen2-moe-a2.7b's
  expert-parallel prefill (1 of 24 layers, 1 x 4096) on (data 1, model
  4), its logits (every 64th position) within 1e-5 of the one-device
  prefill's largest and its next token equal at capacity factor 8 (the
  attention and shared expert tensor-parallel), and at the config's
  1.25 each rank's dispatch equal
  to ``route_masked`` on its logit rows; O2, the trusted EP prefill
  (TRUSTED_FAITHFUL and TRUSTED_DIGEST, r = 4, 1 layer, 1 x 2048) on
  (1, 4, 2): a minority (replica 3) repaired bitwise, a majority
  (replicas 0-2) moving the logits; O3, bmoe-paper's trusted
  training (1 of 12 layers, 2 steps of (4, 2048)) on (2, 2, 1): the
  attacked run bitwise the clean one on every rank, the first step's
  loss within 1e-6 of one device and its gradients within 1e-5 of each
  leaf's largest magnitude; O4, qwen2-moe-a2.7b's
  EP training (1 layer, (1, 2048), capacity factor 8) on (1, 2)
  against one device (gradients within 1e-5).  Each rank's launches are held to the records (3
  ``moe_gemm`` a MoE layer forward, 6 backward, a flash a attention
  layer, 2 votes a MoE layer under faithful EP, 1 under the vote hook);
- the dry run held to the card (path P, ``launch.dryrun``, after O):
  P1, inside paths C, H and L1 on the weights they hold, one extra
  counted run each (qwen2.5-3b's and qwen2-moe-a2.7b's prefill at (1,
  4096), bmoe-paper's training step at (2, 2048)) against the same step
  on the meta device: dot FLOPs by route and kernel equal, kernel calls
  equal the launches, argument bytes equal the tensors held; the
  estimated peak beside ``max_memory_allocated``, and one timed run's
  device time beside the roofline's terms (achieved TFLOP/s, roofline
  share); P2, O1's configuration on the abstract (1, 4) mesh: its bytes
  by exchange equal O1's rank 0's;
- decode and the serving engine on a mesh (path Q, after P; four ranks
  on the card over gloo, each one-device reference run first): Q1,
  qwen2-moe-a2.7b (1 of 24 layers, capacity factor 8) through
  ``ServingEngine(mesh=)`` on (1, 4), 4 slots, cache 4,096, chunks up to
  16, verified sessions, edge expert storage and KV paging, 6 requests
  of 16-96 prompt tokens and 16 new (two admitted mid-run): streams,
  tick commitments and the storage report equal the one-device
  engine's, as many sealed KV blocks, every rank the same (CIDs too);
  Q2, qwen2.5-3b (2 of 36 layers) at batch 1 on (2, 2), a
  cache of 131,072 positions split over data x model, filled from a seed
  to 120,000, 8 decode steps: tokens equal, logits within 1e-5 of the
  largest, each rank's part the one-device cache's; Q3, the launches
  (3 ``moe_gemm`` a MoE layer a micro-step, no flash), ``moe_gemm`` at a
  rank's decode shape, bytes and walls; P3, Q2's step on the abstract
  (2, 2) mesh books Q2 rank 0's bytes;
- FSDP placement and dense tensor parallelism (path R, after Q; four
  ranks on the card over gloo, each one-device reference run first and
  freed): R1, qwen3-32b (2 of 64 layers) trained on (2, 2), FSDP over
  data and tensor parallelism over model, one step of (2, 2048) with
  remat: loss within 1e-5, gradients within 1e-5 of each leaf's largest
  magnitude (or twice one device's own noise of splitting the rows),
  each rank's parameters and moments a quarter of one device's, its
  peak beside one device's; R2, bmoe-paper's gspmd MoE prefill (2 of 12
  layers, (2, 2048)) on (1, 4) (``moe_ff`` over model) and (2, 2) (the
  experts over model, its MoE layer bitwise one device's): logits
  within 1e-5, next tokens and routing equal; R3, qwen3-32b (4 of 64
  layers) decoding 64 steps of a batch of 4 on (1, 4), the 4,096-slot
  cache over model: tokens equal, logits within 1e-5; R4, ``moe_gemm``
  and the flash forward and backward at a rank's shapes, each rank's
  launches; P4, R1's step on the abstract (2, 2) mesh books R1 rank 0's
  bytes by exchange and its parameter-and-moment bytes;
- the recurrent mixers' tensor parallelism and the encoder-decoder's
  placement (path S, after R; four ranks on the card over gloo, each
  one-device reference run first and freed): S1 mamba2-2.7b (2 of 64
  layers), S2 recurrentgemma-2b's first block (rglru, rglru,
  local_attn), S3 seamless-m4t-medium (2 encoder and 2 decoder layers),
  each trained one step on (2, 2) (FSDP over data, the SSD layer's heads
  and channels, the RG-LRU's channels, the attention, MLP and
  vocabulary over model): loss within 1e-5, gradients and the update
  within max(1e-5, twice one device's own difference between two sum
  orders of the step), a rank's parameters and moments the bytes JAX's
  specs give (about a quarter of one device's); then a prefill and 16
  decode steps on (1, 4) (mamba2's 20 heads, recurrentgemma's 640
  channels a rank; S2 past its 2,048-token window, S3 from ``encode``'s
  cross K/V): tokens equal, logits within 1e-5 of the largest, the ssm
  conv history the same bits on every rank; S4 ``ssd_scan``,
  ``rglru_scan`` and the flash kernels forward and backward at a rank's
  shapes; P5 S1's step on the abstract (2, 2) mesh books S1 rank 0's
  bytes.

Each path's launch counts are set to 0 just before it and read just
after it.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels moe_gemm flash_attention ssd_scan_bwd
    python3 chip_smoke.py --serving
    python3 chip_smoke.py --training
    python3 chip_smoke.py --federated
    python3 chip_smoke.py --mesh
    python3 chip_smoke.py --lm-mesh
    python3 chip_smoke.py --dryrun
    python3 chip_smoke.py --decode-mesh
    python3 chip_smoke.py --tensor-parallel
    python3 chip_smoke.py --recurrent-tp

The second form builds, then checks and times only the named kernels'
cases (``moe_gemm``, ``flash_attention``, ``flash_attention_bwd``,
``ssd_scan``, ``ssd_scan_bwd``, ``redundancy_vote``, ``rglru_scan``,
``rglru_scan_bwd``, ``audit_mlp``) and stops (no main path, no last
line): run from two trees in one call, it compares two versions of a
kernel on one card.
The third runs path K alone, the fourth path L alone (their models
initialised from seed 0 as the main run's are), the fifth path M alone,
the sixth path N alone, the seventh path O alone, the eighth path P
alone (O1's world run again for P2), the ninth path Q alone (with P3),
the tenth path R alone (with P4) and the eleventh path S alone (with
P5), and stop the same way.

Prints, in order: the card's name and power limit (nvidia-smi), the
build time, one JSON line per kernel case, the main-path lines, one
``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {...}}``.  Any failed check raises, so the exit
code is non-zero and no last line is printed.  Without a CUDA device, or
without the rest of the repository beside it, it exits non-zero too.
"""
from __future__ import annotations

import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Optional

FP32_PEAK = 67e12        # H100 SXM, fp32 outside the tensor cores
TF32X3_PEAK = 495e12 / 3  # dense TF32 tensor cores, 3 products per fp32 one
BF16_PEAK = 989e12       # H100 SXM, dense bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
STARTED = time.perf_counter()
CARD = ""                # nvidia-smi's name and power limit, set in main


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj) -> None:
    """One JSON line; a phase's or a case's line also carries ``t_s``,
    the seconds since the script started, so a run shows where its time
    went."""
    if isinstance(obj, dict) and ("phase" in obj or "case" in obj):
        obj = {**obj, "t_s": time.perf_counter() - STARTED}
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


def ops_ssd_flops(x, Bmat, chunk: int, backward: bool) -> int:
    from repro_torch.kernels.ops import ssd_flops
    return ssd_flops(x, Bmat, chunk, backward)


def bound(flops: float, nbytes: float, peak: float):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


# ------------------------------------------------------------ kernels
def check_moe_gemm(torch, mg, ref, seed: int, name: str, E: int, C: int,
                   d: int, f: int, dtype, w_scale: float = 1.0):
    """The kernel against its plain version (fp32 cuBLAS, TF32 off) on
    unit normal rows and weights drawn at ``w_scale`` (an LM layer's
    fan-in init is 1/sqrt(d)), drawn on the card (the LM layers' weights
    are about 10^8 numbers a case)."""
    g = torch.Generator("cuda").manual_seed(seed)
    buf = torch.randn(E, C, d, generator=g, device="cuda").to(dtype)
    w = (torch.randn(E, d, f, generator=g, device="cuda")
         * w_scale).to(dtype)
    got = mg.moe_gemm(buf, w)
    want = ref.moe_gemm_ref(buf, w)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = (got.float() - want.float()).abs()
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                             atol=tol * 8))
    size = buf.element_size()
    flops = 2.0 * E * C * d * f
    nbytes = (E * C * d + E * d * f + E * C * f) * size
    fp32 = dtype == torch.float32
    b_ms, b_by = bound(flops, nbytes, TF32X3_PEAK if fp32 else BF16_PEAK)
    row = {"case": name, "kernel": "moe_gemm",
           "shape": f"({E},{C},{d})x({E},{d},{f})",
           "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": float(err.max()), "rtol": tol, "atol": tol * 8,
           "ok": ok,
           "kernel_ms": time_ms(lambda: mg.moe_gemm(buf, w)),
           "plain_ms": time_ms(lambda: ref.moe_gemm_ref(buf, w)),
           "library_ms": time_ms(lambda: torch.bmm(buf, w)),
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_fp32_cores_ms": (bound(flops, nbytes, FP32_PEAK)[0]
                                   if fp32 else None)}
    emit(row)
    require(ok, f"moe_gemm {name} disagrees with its plain version "
                f"(max abs err {row['max_abs_err']})")
    return row


def moe_gemm_cases(torch, mg, ref):
    """The B-MoE path's two expert layers in fp32 (returned first) and
    bf16, a ragged shape, the training round's three backward products
    on contiguous transposed copies (returned second): dw2 = h^T g, dh =
    g w2^T, dw1 = buf^T dh, and the LM MoE layers' products (returned
    third)."""
    gemm = [check_moe_gemm(torch, mg, ref, 1, "layer1", 10, 376, 784, 256,
                           torch.float32),
            check_moe_gemm(torch, mg, ref, 2, "layer2", 10, 376, 256, 10,
                           torch.float32)]
    bwd = [check_moe_gemm(torch, mg, ref, 35, "bwd_dw2", 10, 256, 376, 10,
                          torch.float32),
           check_moe_gemm(torch, mg, ref, 36, "bwd_dh", 10, 376, 10, 256,
                          torch.float32),
           check_moe_gemm(torch, mg, ref, 37, "bwd_dw1", 10, 784, 376, 256,
                          torch.float32)]
    check_moe_gemm(torch, mg, ref, 3, "ragged", 2, 100, 50, 70,
                   torch.float32)
    check_moe_gemm(torch, mg, ref, 4, "layer1_bf16", 10, 376, 784, 256,
                   torch.bfloat16)
    check_moe_gemm(torch, mg, ref, 5, "layer2_bf16", 10, 376, 256, 10,
                   torch.bfloat16)
    # the LM MoE layers of path H at a prefill of 4096 (gate and up share
    # a shape, then down); the decode folds of 4 slots that paths H and K
    # run every micro-step (qwen2-moe at capacity k = 4, 16 rows; bmoe-
    # paper at k = 3, 12 rows); one slot, and the fold's rows against
    # each slot alone; weights at the layers' fan-in scale, as the model
    # draws them
    lm = [check_moe_gemm(torch, mg, ref, seed, name, E, C, d, f,
                         torch.float32, w_scale=d ** -0.5)
          for seed, name, E, C, d, f in (
              (40, "bmoe_lm_gate_up", 10, 1536, 1024, 2816),
              (41, "bmoe_lm_down", 10, 1536, 2816, 1024),
              (42, "qwen2_moe_gate_up", 64, 344, 2048, 1408),
              (43, "qwen2_moe_down", 64, 344, 1408, 2048),
              (44, "qwen2_moe_decode_fold_b4", 64, 16, 2048, 1408),
              (47, "qwen2_moe_decode_fold_b4_down", 64, 16, 1408, 2048),
              (50, "bmoe_lm_decode_fold_b4_gate_up", 10, 12, 1024, 2816),
              (51, "bmoe_lm_decode_fold_b4_down", 10, 12, 2816, 1024))]
    check_moe_gemm(torch, mg, ref, 45, "qwen2_moe_decode_b1", 64, 4, 2048,
                   1408, torch.float32, w_scale=2048 ** -0.5)
    # the LM MoE layer's backward on path L1 (bmoe-paper at (2, 2048), the
    # fold of 1,536 rows): d_buf = g w^T has the forward's shapes above
    # (gate/up's g (E, 1536, 2816) x w^T (E, 2816, 1024) is bmoe_lm_down's,
    # down's is bmoe_lm_gate_up's); d_w = buf^T g contracts the rows
    lm_bwd = [check_moe_gemm(torch, mg, ref, seed, name, E, C, d, f,
                             torch.float32, w_scale=d ** -0.5)
              for seed, name, E, C, d, f in (
                  (52, "bmoe_lm_bwd_dw_gate_up", 10, 1024, 1536, 2816),
                  (53, "bmoe_lm_bwd_dw_down", 10, 2816, 1536, 1024))]
    check_moe_gemm_fp64(torch, mg, ref)
    check_moe_gemm_fold(torch, mg)
    return gemm, bwd, lm, lm_bwd


def check_moe_gemm_fp64(torch, mg, ref):
    """At K = 1024 on unit weights (outputs of about 32) two fp32
    reduction orders differ by more than the 8e-5 absolute bar where an
    output cancels to near zero; so the kernel and its plain version are
    both held against the float64 product: the kernel's largest error
    may not exceed twice the plain version's."""
    g = torch.Generator().manual_seed(49)
    buf = torch.randn(10, 1536, 1024, generator=g).cuda()
    w = torch.randn(10, 1024, 2816, generator=g).cuda()
    exact = torch.bmm(buf.double(), w.double())
    err_k = float((mg.moe_gemm(buf, w).double() - exact).abs().max())
    err_p = float((ref.moe_gemm_ref(buf, w).double() - exact).abs().max())
    res = {"phase": "moe_gemm_vs_fp64", "shape":
           "(10,1536,1024)x(10,1024,2816), unit normal",
           "kernel_max_abs_err": err_k, "plain_max_abs_err": err_p,
           "ok": err_k <= 2.0 * err_p}
    emit(res)
    require(res["ok"], f"moe_gemm less accurate than fp32: {res}")


def check_moe_gemm_fold(torch, mg):
    """The decode fold (E, B*C, d) with B = 4 slots of C = 4 rows, against
    each slot's (E, C, d) call alone, bit for bit: a request's expert
    rows do not depend on the other requests of its batch."""
    g = torch.Generator().manual_seed(46)
    buf = torch.randn(4, 64, 4, 2048, generator=g).cuda()
    w = torch.randn(64, 2048, 1408, generator=g).cuda()
    fold = mg.moe_gemm(buf.transpose(0, 1).reshape(64, 16, 2048)
                       .contiguous(), w).reshape(64, 4, 4, 1408)
    alone = [mg.moe_gemm(buf[b].contiguous(), w) for b in range(4)]
    torch.cuda.synchronize()
    res = {"phase": "moe_gemm_fold_invariance",
           "shape": "(64,4x4,2048)x(64,2048,1408)",
           "slots_alone_bitwise": all(_bitwise_equal(torch, alone[b],
                                                     fold[:, b])
                                      for b in range(4))}
    emit(res)
    require(res["slots_alone_bitwise"],
            f"moe_gemm rows depend on the other slots of the fold: {res}")


def _bitwise_equal(torch, a, b) -> bool:
    return a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def check_vote(torch, rv, ref, seed: int, name: str, E: int, M: int, T: int,
               n_bad: int = 0, inactive=(), specials: bool = False,
               timed: bool = True):
    """The vote kernel against its plain version, bit for bit, the elected
    copy included; where ``timed``, its time, the plain version's and the
    launch floor (an empty kernel of the same grid, cluster shape and
    shared memory), each by graph replay."""
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
    want = ref.redundancy_vote_winner_ref(pub, active)
    torch.cuda.synchronize()
    ok = (_bitwise_equal(torch, got[0], want[0])
          and all(torch.equal(got[i], want[i]) for i in (1, 2, 3)))
    nbytes = (E * M * T + M) * 4 + (E * T + E + E * M + E) * 4
    b_ms, b_by = bound(3.0 * E * T * M * (M + 1) / 2, nbytes, FP32_PEAK)
    row = {"case": name, "kernel": "redundancy_vote",
           "shape": f"pub ({E},{M},{T})", "dtype": "float32",
           "inactive": list(inactive), "colluding_bad": n_bad,
           "specials": specials, "max_abs_err": 0.0 if ok else None,
           "exact": bool(ok), "winner": got[3].tolist()[:4],
           "support": got[1].tolist()[:4],
           "kernel_ms": (time_ms(lambda: rv.redundancy_vote_masked(
               pub, active)) if timed else None),
           "plain_ms": (time_ms(lambda: ref.redundancy_vote_masked_ref(
               pub, active)) if timed else None),
           "launch_floor_ms": (time_ms(lambda: rv.launch_floor(pub))
                               if timed else None),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit(row)
    require(ok, f"vote {name} differs from its plain version")
    return row


def vote_cases(torch, rv, ref):
    """The B-MoE path's vote (returned first) and the court's two-word
    shape (returned second), timed; then a majority, barred edges, NaN
    and +-inf, one word, T = 1, T across the blocks' slice edges, and the
    widest electorate one block's shared memory holds, untimed; then the
    dense-dispatch shape (10, 10, 10000), timed (returned third)."""
    path = check_vote(torch, rv, ref, 6, "path", 10, 10, 3760, n_bad=3)
    court = check_vote(torch, rv, ref, 26, "two_words", 3, 40, 300,
                       n_bad=19, inactive=(0, 39), specials=True)
    check_vote(torch, rv, ref, 7, "majority_flips", 10, 10, 3760, n_bad=6,
               timed=False)
    check_vote(torch, rv, ref, 8, "masked", 10, 10, 3760, n_bad=4,
               inactive=(0, 2), timed=False)
    check_vote(torch, rv, ref, 9, "nan_inf_tail", 4, 5, 1500, n_bad=1,
               specials=True, timed=False)
    check_vote(torch, rv, ref, 10, "one_word", 3, 32, 300, n_bad=15,
               timed=False)
    check_vote(torch, rv, ref, 32, "t_one", 2, 10, 1, n_bad=3, timed=False)
    check_vote(torch, rv, ref, 33, "slice_edges", 3, 10, 257, n_bad=4,
               inactive=(2,), specials=True, timed=False)
    check_vote(torch, rv, ref, 34, "m1351", 3, 1351, 40, n_bad=600,
               inactive=(0, 700, 1350), specials=True, timed=False)
    # a dense-dispatch bmoe batch of 1000: every expert's whole batch
    dense = check_vote(torch, rv, ref, 38, "dense_path", 10, 10, 10000,
                       n_bad=3)
    return path, court, dense


def _audit_bank(torch, g, E, d, h, o):
    return {"w1": (torch.randn(E, d, h, generator=g) / d ** 0.5).cuda(),
            "b1": torch.randn(E, h, generator=g).cuda(),
            "w2": (torch.randn(E, h, o, generator=g) / h ** 0.5).cuda(),
            "b2": torch.randn(E, o, generator=g).cuda()}


def audit_composition(torch, bank, x, gid):
    """The audit MLP as four PyTorch calls (no single call computes it):
    the bank gathered by gid, then baddbmm, ReLU and baddbmm (TF32 off).
    A yardstick only: its bits depend on how cuBLAS tiles the batch."""
    g = gid.long()
    h = torch.relu(torch.baddbmm(bank["b1"][g][:, None], x, bank["w1"][g]))
    return torch.baddbmm(bank["b2"][g][:, None], h, bank["w2"][g])


def check_audit_mlp(torch, am, ref, seed: int, name: str, E: int, S: int,
                    C: int, d: int, h: int, o: int):
    g = torch.Generator().manual_seed(seed)
    bank = _audit_bank(torch, g, E, d, h, o)
    x = torch.randn(S, C, d, generator=g).cuda()
    gid_host = torch.randint(0, E, (S,), generator=g, dtype=torch.int32)
    gid = gid_host.cuda()
    got = am.audit_mlp(bank, x, gid)
    want = ref.audit_mlp_ref(bank, x, gid_host)   # host ids: no sync
    comp = audit_composition(torch, bank, x, gid)
    torch.cuda.synchronize()
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
    # the work this call's data needs: the distinct experts it gathers
    used = len(set(gid_host.tolist()))
    nbytes = 4 * (S * C * d + S + used * (d * h + h + h * o + o) + S * C * o)
    flops = 2.0 * S * C * (d * h + h * o)
    # both layers run as 3xTF32 on the tensor cores
    b_ms, b_by = bound(flops, nbytes, TF32X3_PEAK)
    row = {"case": name, "kernel": "audit_mlp",
           "shape": f"x ({S},{C},{d}), bank E={E} {d}->{h}->{o}",
           "dtype": "float32",
           "max_abs_err": float((got - want).abs().max()), "rtol": 1e-5,
           "atol": 1e-5, "ok": ok,
           "kernel_ms": time_ms(lambda: am.audit_mlp(bank, x, gid)),
           "plain_ms": time_ms(lambda: ref.audit_mlp_ref(bank, x, gid_host)),
           "library_ms": None,
           "composition": "gather by gid + baddbmm + relu + baddbmm",
           "composition_ms": time_ms(lambda: audit_composition(
               torch, bank, x, gid)),
           "composition_max_abs_err": float((comp - want).abs().max()),
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_fp32_cores_ms": bound(flops, nbytes, FP32_PEAK)[0]}
    emit(row)
    require(ok, f"audit_mlp {name} disagrees with its plain version "
                f"(max abs err {row['max_abs_err']})")
    return row


def audit_cases(torch, am, ref):
    """The commitment build (returned first), a merged drain over a stacked
    30-expert bank, a ragged shape, the widest hidden layer the wrapper
    takes and a training drain's merged shape, then the invariance
    phase."""
    audit = [check_audit_mlp(torch, am, ref, 12, "commit", 10, 40, 94,
                             784, 256, 10),
             check_audit_mlp(torch, am, ref, 13, "merged", 30, 8, 94, 784,
                             256, 10),
             check_audit_mlp(torch, am, ref, 14, "ragged", 3, 5, 93, 50, 70,
                             3),
             check_audit_mlp(torch, am, ref, 28, "h3072", 4, 6, 94, 784,
                             3072, 10),
             # a training drain: 3 rounds' banks stacked (window 2), the
             # sampled leaves bucketed to 32
             check_audit_mlp(torch, am, ref, 39, "train_merged", 30, 32, 94,
                             784, 256, 10)]
    check_audit_invariance(torch, am)
    return audit


def check_audit_invariance(torch, am):
    """Rows of the S=40 commit-shaped call, bit for bit, against the same
    samples from an S=4 call over a permuted subset, from S=1 calls (on
    the real rows only), and from a call over a stacked (30-expert) bank
    with gids offset by 10 and 20."""
    g = torch.Generator().manual_seed(11)
    bank = _audit_bank(torch, g, 10, 784, 256, 10)
    x = torch.randn(40, 94, 784, generator=g).cuda()
    gid = torch.randint(0, 10, (40,), generator=g, dtype=torch.int32).cuda()
    full = am.audit_mlp(bank, x, gid)
    sub = torch.tensor([33, 7, 20, 1]).cuda()
    part = am.audit_mlp(bank, x[sub], gid[sub])
    singles = [am.audit_mlp({k: v[int(gid[s])][None]
                             for k, v in bank.items()},
                            x[s:s + 1, :94 - s].contiguous(),
                            torch.zeros(1, dtype=torch.int32).cuda())[0]
               for s in range(40)]
    stacked = {k: torch.cat([v, v, v]) for k, v in bank.items()}
    off = (torch.arange(40, dtype=torch.int32) % 3).cuda() * 10
    moved = am.audit_mlp(stacked, x, gid + off)
    torch.cuda.synchronize()
    res = {"phase": "audit_mlp_invariance",
           "s4_subset_bitwise": _bitwise_equal(torch, part, full[sub]),
           "s1_real_rows_bitwise": all(
               _bitwise_equal(torch, one, full[s, :94 - s])
               for s, one in enumerate(singles)),
           "stacked_bank_bitwise": _bitwise_equal(torch, moved, full)}
    emit(res)
    require(all(v for k, v in res.items() if k != "phase"),
            f"audit_mlp rows depend on the call: {res}")


# ------------------------------------------------ LM stack kernels
def attention_pairs(np, Sq: int, Sk: int, causal: bool, window: int,
                    q_offset: int = 0) -> int:
    """Unmasked (query, key) pairs: the work this call's masks leave (the
    count the kernel wrappers book, ``ops.attention_pairs``)."""
    from repro_torch.kernels.ops import attention_pairs as pairs
    return pairs(Sq, Sk, causal, window, q_offset)


def top_kernel(torch, run) -> str:
    """Name of the kernel with the most device time in one call."""
    top = profile_batch(torch, run)["top"]
    return top[0]["name"] if top else "none"


def check_flash(torch, np, fa, ref, seed: int, name: str, B: int, S: int,
                H: int, KH: int, D: int, causal: bool, window: int = 0,
                softcap: float = 0.0, dtype=None, iters: int = 20,
                Sk: Optional[int] = None):
    """Sq = S queries against Sk keys (default S)."""
    import torch.nn.functional as F
    dtype = dtype or torch.float32
    Sk = Sk or S
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g).to("cuda", dtype)
    k = torch.randn(B, Sk, KH, D, generator=g).to("cuda", dtype)
    v = torch.randn(B, Sk, KH, D, generator=g).to("cuda", dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa.flash_attention(q, k, v, **kw)
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = 2e-4 if dtype == torch.float32 else 2e-2
    err = float((got.float() - want.float()).abs().max())
    ok = bool(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol))
    pairs = attention_pairs(np, S, Sk, causal, window)
    size = q.element_size()
    flops = 4.0 * B * H * D * pairs
    nbytes = size * (2 * B * S * H * D + 2 * B * Sk * KH * D)
    fp32 = dtype == torch.float32
    b_ms, b_by = bound(flops, nbytes, TF32X3_PEAK if fp32 else BF16_PEAK)
    # the yardstick: one scaled_dot_product_attention call on the same
    # inputs, heads first, GQA expanded and the window as a boolean mask
    # (prepared outside the timing); it has no softcap
    library_ms, backend = None, None
    if not softcap:
        G = H // KH
        qt = q.transpose(1, 2).contiguous()
        kt = k.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(G, dim=2).transpose(1, 2).contiguous()
        mask = None
        if window:
            pos = torch.arange(S, device="cuda")      # Sq = Sk here
            mask = pos[None, :] > pos[:, None] - window
            if causal:
                mask &= pos[None, :] <= pos[:, None]
        sdpa = (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and not window))
        library_ms = time_ms(sdpa, iters=iters)
        backend = top_kernel(torch, sdpa)
    row = {"case": name, "kernel": "flash_attention",
           "shape": f"q ({B},{S},{H},{D}), kv ({B},{Sk},{KH},{D})",
           "causal": causal, "window": window, "softcap": softcap,
           "dtype": str(dtype).replace("torch.", ""), "pairs": pairs,
           "max_abs_err": err, "rtol": tol, "atol": tol, "ok": ok,
           "kernel_ms": time_ms(lambda: fa.flash_attention(q, k, v, **kw),
                                iters=iters),
           "plain_ms": time_ms(lambda: ref.attention_ref(q, k, v, **kw),
                               iters=max(iters // 4, 1), reps=2),
           "library_ms": library_ms, "library_backend": backend,
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_fp32_cores_ms": (bound(flops, nbytes, FP32_PEAK)[0]
                                   if fp32 else None)}
    emit(row)
    require(ok, f"flash_attention {name} disagrees with its plain version "
                f"(max abs err {err})")
    return row


def flash_cases(torch, np, fa, ref):
    """A qwen2.5-3b and a recurrentgemma-2b layer in fp32 (returned), the
    qwen layer in bf16, a ragged, a softcapped and a windowed D = 48
    case, then the non-causal cross-attention shapes."""
    flash = [check_flash(torch, np, fa, ref, 15, "qwen_layer", 1, 4096, 16,
                         2, 128, True, iters=5),
             check_flash(torch, np, fa, ref, 16, "rgemma_layer", 1, 4096, 10,
                         1, 256, True, window=2048, iters=5)]
    check_flash(torch, np, fa, ref, 17, "ragged", 2, 1000, 4, 2, 64, False)
    check_flash(torch, np, fa, ref, 18, "softcap", 1, 512, 8, 4, 128, True,
                softcap=50.0)
    check_flash(torch, np, fa, ref, 19, "qwen_layer_bf16", 1, 4096, 16, 2,
                128, True, dtype=torch.bfloat16, iters=5)
    check_flash(torch, np, fa, ref, 27, "d48_window", 2, 512, 6, 2, 48,
                True, window=100)
    # seamless-m4t-medium's cross-attention (and encoder) at 4096: non-
    # causal, returned third; then a ragged non-causal Sq != Sk
    flash.append(check_flash(torch, np, fa, ref, 47, "seamless_cross", 1,
                             4096, 16, 16, 64, False, iters=5))
    check_flash(torch, np, fa, ref, 48, "cross_ragged", 2, 1000, 8, 4, 64,
                False, Sk=1500)
    return flash


def _scan_inputs(torch, seed: int, B: int, S: int, C: int):
    g = torch.Generator().manual_seed(seed)
    a = (0.5 + 0.5 * torch.rand(B, S, C, generator=g)).cuda()
    return a, torch.randn(B, S, C, generator=g).cuda()


def check_rglru(torch, rg, ref, seed: int, name: str, B: int, S: int,
                C: int, profiled: bool = False):
    """The chunked scan against the sequential loop.  One call is one count
    of ``rg.launches``; where ``profiled``, its CUDA launches and each
    one's device time are read from torch.profiler."""
    a, b = _scan_inputs(torch, seed, B, S, C)
    got = rg.rglru_scan(a, b)
    want = ref.rglru_scan_ref(a, b)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=1e-5, atol=1e-5))
    # the function: a and b read once, h written once; the kernel reads a
    # and b twice (the chunk summaries, then the scan): its own floor
    b_ms, b_by = bound(2.0 * B * S * C, 12.0 * B * S * C, FP32_PEAK)
    row = {"case": name, "kernel": "rglru_scan", "shape": f"({B},{S},{C})",
           "dtype": "float32", "max_abs_err": err, "rtol": 1e-5,
           "atol": 1e-5, "ok": ok, "bitwise": bool(torch.equal(got, want)),
           "kernel_ms": time_ms(lambda: rg.rglru_scan(a, b)),
           "plain_ms": time_ms(lambda: ref.rglru_scan_ref(a, b), iters=1,
                               reps=2),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "design_floor_ms": 20.0 * B * S * C / HBM_BYTES_PER_S * 1e3}
    if profiled:
        prof = profile_batch(torch, lambda: rg.rglru_scan(a, b))["rglru"]
        row["cuda_launches_per_call"] = prof["cuda_launches"]
        row["launch_profile"] = prof["by_kernel"]
    emit(row)
    require(ok, f"rglru_scan {name} disagrees with its plain version "
                f"(max abs err {err})")
    return row


def check_rglru_invariance(torch, rg):
    """recurrentgemma-2b's scan width at B = 3: two runs bit for bit, and
    each row run alone against the same row of the batch, bit for bit."""
    a, b = _scan_inputs(torch, 29, 3, 4096, 2560)
    first, second = rg.rglru_scan(a, b), rg.rglru_scan(a, b)
    alone = [rg.rglru_scan(a[i:i + 1].contiguous(), b[i:i + 1].contiguous())
             for i in range(3)]
    torch.cuda.synchronize()
    res = {"phase": "rglru_scan_invariance", "shape": "(3,4096,2560)",
           "repeat_bitwise": _bitwise_equal(torch, first, second),
           "rows_alone_bitwise": all(_bitwise_equal(torch, one[0], first[i])
                                     for i, one in enumerate(alone))}
    emit(res)
    require(res["repeat_bitwise"] and res["rows_alone_bitwise"],
            f"rglru_scan bits depend on the call: {res}")


def rglru_cases(torch, rg, ref):
    """A recurrentgemma-2b layer (returned first, profiled), ragged
    lengths around the 64-step chunk, then the invariance phase."""
    scan = [check_rglru(torch, rg, ref, 20, "rgemma_layer", 1, 4096, 2560,
                        profiled=True),
            check_rglru(torch, rg, ref, 21, "ragged", 3, 1000, 300),
            check_rglru(torch, rg, ref, 30, "chunk_plus_one", 2, 65, 130),
            check_rglru(torch, rg, ref, 31, "below_one_chunk", 2, 20, 33)]
    check_rglru_invariance(torch, rg)
    return scan


def time_events(fn, iters: int = 5, warmup: int = 2) -> float:
    """Device time per call of ``fn`` between two CUDA events over
    ``iters`` calls after ``warmup`` warm-up calls: for calls (an autograd
    backward, a loop of seconds) that a CUDA graph would not capture, and
    long enough that the host's launch overhead does not count."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_grad_fp64(torch, ref, q, k, v, do, causal, window, softcap,
                        q_offset):
    """dq, dk, dv of attention in float64 by autograd: the yardstick the
    backward kernel and its plain version are both held to."""
    q, k, v = (t.double().requires_grad_(True) for t in (q, k, v))
    B, Sq, H, D = q.shape
    Sk, KH = k.shape[1], k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk",
                     q.reshape(B, Sq, KH, H // KH, D), k) * D ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    mask = ref.attention_mask(Sq, Sk, q.device, causal=causal,
                              window=window, q_offset=q_offset)
    s = torch.where(mask, s, torch.full((), -1e30, dtype=s.dtype,
                                        device=s.device))
    o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, -1), v)
    return torch.autograd.grad(o.reshape(B, Sq, H, D), (q, k, v),
                               do.double())


def check_flash_bwd(torch, np, fa, ref, seed: int, name: str, B: int,
                    S: int, H: int, KH: int, D: int, causal: bool,
                    window: int = 0, softcap: float = 0.0,
                    Sk: Optional[int] = None):
    """The backward kernel against ``attention_bwd_ref`` on the same o and lse,
    both held against a float64 backward: the kernel's error on each of dq, dk,
    dv may not exceed twice the plain version's.  Also: the forward's o bitwise
    equal with and without the lse written.  Timed: the kernel, its plain
    version and the library's backward (SDPA in fp32 on the same inputs, heads
    first and GQA expanded, by ``torch.autograd.grad``; its largest kernel
    named).  The bound: five products of the forward's size (S, dP, dV, dK, dQ)
    at the 3xTF32 rate, against q, k, v, o, dO, lse read once and dq, dk, dv
    written once.  ``passes_us``: each CUDA launch's device time in one
    profiled call (Delta, dK/dV, the head sum under GQA, dQ)."""
    import torch.nn.functional as F
    Sk = Sk or S
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g).cuda()
    k = torch.randn(B, Sk, KH, D, generator=g).cuda()
    v = torch.randn(B, Sk, KH, D, generator=g).cuda()
    do = torch.randn(B, S, H, D, generator=g).cuda()
    kw = dict(causal=causal, window=window, softcap=softcap)
    o, lse = fa.flash_attention(q, k, v, return_lse=True, **kw)
    o_bitwise = _bitwise_equal(torch, o, fa.flash_attention(q, k, v, **kw))
    got = fa.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    want = ref.attention_bwd_ref(q, k, v, o, do, lse, **kw)
    exact = attention_grad_fp64(torch, ref, q, k, v, do, q_offset=0, **kw)
    torch.cuda.synchronize()
    err_k = {n: float((a.double() - x).abs().max())
             for n, a, x in zip(("dq", "dk", "dv"), got, exact)}
    err_p = {n: float((a.double() - x).abs().max())
             for n, a, x in zip(("dq", "dk", "dv"), want, exact)}
    vs_plain = max(float((a - b).abs().max()) for a, b in zip(got, want))
    del exact
    ok = all(err_k[n] <= 2.0 * err_p[n] for n in err_k)
    pairs = attention_pairs(np, S, Sk, causal, window)
    flops = 10.0 * B * H * D * pairs
    nbytes = 4.0 * (4 * B * S * H * D + 4 * B * Sk * KH * D + B * H * S)
    b_ms, b_by = bound(flops, nbytes, TF32X3_PEAK)
    library_ms, backend = None, None
    if not softcap:
        G = H // KH
        qt, kt, vt = (t.repeat_interleave(G if t is not q else 1, dim=2)
                      .transpose(1, 2).contiguous().requires_grad_(True)
                      for t in (q, k, v))
        mask = None
        if window:
            pos = torch.arange(S, device="cuda")
            mask = pos[None, :] > pos[:, None] - window
            if causal:
                mask &= pos[None, :] <= pos[:, None]
        dot = do.transpose(1, 2).contiguous()
        out = F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and not window)

        def sdpa_bwd():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)
        library_ms = time_events(sdpa_bwd, iters=3)
        backend = top_kernel(torch, sdpa_bwd)
        del out, qt, kt, vt, dot
    row = {"case": name, "kernel": "flash_attention_bwd",
           "shape": f"q ({B},{S},{H},{D}), kv ({B},{Sk},{KH},{D})",
           "causal": causal, "window": window, "softcap": softcap,
           "dtype": "float32", "pairs": pairs,
           "max_abs_err": vs_plain, "fp64_err_kernel": err_k,
           "fp64_err_plain": err_p, "ok": ok,
           "o_bitwise_with_lse": o_bitwise,
           "kernel_ms": time_ms(lambda: fa.flash_attention_bwd(
               q, k, v, o, do, lse, **kw), iters=3, reps=2),
           "plain_ms": time_ms(lambda: ref.attention_bwd_ref(
               q, k, v, o, do, lse, **kw), iters=1, reps=2),
           "library_ms": library_ms, "library_backend": backend,
           "bound_ms": b_ms, "bound_by": b_by,
           "bound_fp32_cores_ms": bound(flops, nbytes, FP32_PEAK)[0]}
    prof = profile_batch(torch, lambda: fa.flash_attention_bwd(
        q, k, v, o, do, lse, **kw), cpu=False)["flash_bwd"]
    row["cuda_launches_per_call"] = prof["cuda_launches"]
    row["passes_us"] = {n: one["device_us"]
                        for n, one in prof["by_kernel"].items()}
    emit(row)
    require(ok and o_bitwise, f"flash_attention_bwd {name}: kernel error "
                              f"{err_k} against plain {err_p} (float64), "
                              f"o bitwise with lse {o_bitwise}")
    return row


def flash_bwd_cases(torch, np, fa, ref):
    """The attention backward at every shape path L launches it at:
    bmoe-paper's layer at L1's (2, 2048) (GQA 16/8), recurrentgemma-2b's
    windowed D = 256 layer (L2), seamless-m4t-medium's encoder (non-
    causal, 4,096 frames), its decoder's self-attention over 512 tokens
    and its cross-attention from 512 tokens to 4,096 frames (L3); then a
    qwen2.5-3b layer at 4096 (the kernel's headline time, returned
    first) and a ragged cross-attention with Sq != Sk."""
    qwen = check_flash_bwd(torch, np, fa, ref, 60, "qwen_layer", 1, 4096,
                           16, 2, 128, True)
    return [qwen,
            check_flash_bwd(torch, np, fa, ref, 64, "bmoe_lm_layer", 2, 2048,
                            16, 8, 64, True),
            check_flash_bwd(torch, np, fa, ref, 61, "rgemma_layer", 1, 4096,
                            10, 1, 256, True, window=2048),
            check_flash_bwd(torch, np, fa, ref, 62, "seamless_encoder", 1,
                            4096, 16, 16, 64, False),
            check_flash_bwd(torch, np, fa, ref, 65, "seamless_decoder_self",
                            1, 512, 16, 16, 64, True),
            check_flash_bwd(torch, np, fa, ref, 66, "seamless_cross", 1, 512,
                            16, 16, 64, False, Sk=4096),
            check_flash_bwd(torch, np, fa, ref, 63, "cross_ragged", 2, 1000,
                            8, 4, 64, False, Sk=1500)]


def rglru_bwd_fp64(torch, a, h, dh):
    """The reverse loop of ``rglru_scan_bwd_ref`` in float64."""
    a, h, dh = a.double(), h.double(), dh.double()
    S = a.shape[1]
    c = torch.zeros_like(a[:, 0])
    da, db = torch.empty_like(a), torch.empty_like(a)
    for t in range(S - 1, -1, -1):
        c = (a[:, t + 1] * c if t + 1 < S else 0.0) + dh[:, t]
        db[:, t] = c
        da[:, t] = c * h[:, t - 1] if t > 0 else 0.0
    return da, db


def check_rglru_bwd(torch, rg, ref, seed: int, name: str, B: int, S: int,
                    C: int):
    """The reverse chunked scan against the reverse loop at 1e-5, and
    both against the loop in float64: the kernel's error may not exceed
    twice the plain loop's.  The bound: a, h and dh read once, da and db
    written once, 20 bytes an element."""
    a, b = _scan_inputs(torch, seed, B, S, C)
    dh = torch.randn(B, S, C, generator=torch.Generator().manual_seed(
        seed + 1)).cuda()
    h = rg.rglru_scan(a, b)
    got = rg.rglru_scan_bwd(a, h, dh)
    want = ref.rglru_scan_bwd_ref(a, h, dh)
    exact = rglru_bwd_fp64(torch, a, h, dh)
    torch.cuda.synchronize()
    err = max(float((x - y).abs().max()) for x, y in zip(got, want))
    err_k = max(float((x.double() - y).abs().max())
                for x, y in zip(got, exact))
    err_p = max(float((x.double() - y).abs().max())
                for x, y in zip(want, exact))
    ok = all(bool(torch.allclose(x, y, rtol=1e-5, atol=1e-5))
             for x, y in zip(got, want)) and err_k <= 2.0 * err_p
    b_ms, b_by = bound(3.0 * B * S * C, 20.0 * B * S * C, FP32_PEAK)
    row = {"case": name, "kernel": "rglru_scan_bwd",
           "shape": f"({B},{S},{C})", "dtype": "float32",
           "max_abs_err": err, "rtol": 1e-5, "atol": 1e-5,
           "fp64_err_kernel": err_k, "fp64_err_plain": err_p, "ok": ok,
           "bitwise": all(_bitwise_equal(torch, x, y)
                          for x, y in zip(got, want)),
           "kernel_ms": time_ms(lambda: rg.rglru_scan_bwd(a, h, dh)),
           "plain_ms": time_ms(lambda: ref.rglru_scan_bwd_ref(a, h, dh),
                               iters=1, reps=2),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "design_floor_ms": 28.0 * B * S * C / HBM_BYTES_PER_S * 1e3}
    emit(row)
    require(ok, f"rglru_scan_bwd {name}: max abs err {err}, float64 error "
                f"{err_k} against the plain loop's {err_p}")
    return row


def rglru_bwd_cases(torch, rg, ref):
    """recurrentgemma-2b's layer (returned first), then two chunks plus
    one step and a single chunk, where the kernel is the loop bit for
    bit."""
    rows = [check_rglru_bwd(torch, rg, ref, 70, "rgemma_layer", 1, 4096,
                            2560),
            check_rglru_bwd(torch, rg, ref, 71, "chunk_plus_one", 2, 65,
                            130),
            check_rglru_bwd(torch, rg, ref, 72, "below_one_chunk", 2, 20,
                            33)]
    require(rows[1]["bitwise"] and rows[2]["bitwise"],
            "rglru_scan_bwd over at most two chunks is not the loop's bits")
    return rows


def check_ssd(torch, ss, ref, seed: int, name: str, B: int, S: int, H: int,
              P: int, N: int, chunk: int, iters: int = 20,
              profiled: bool = False):
    """The SSD kernels against the sequential recurrence from zero, on
    inputs drawn as the JAX package's tests/test_kernels.py draws them.
    One call is one count of ``ss.launches``; where ``profiled``, the
    CUDA launches of one call and each one's device time are read from
    torch.profiler (``cuda_launches_per_call``, ``launch_profile``)."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g).cuda()
    dt = (F.softplus(torch.randn(B, S, H, generator=g)) * 0.1).cuda()
    A = (-torch.randn(H, generator=g).abs() - 0.1).cuda()
    Bm = (torch.randn(B, S, N, generator=g) * 0.5).cuda()
    Cm = (torch.randn(B, S, N, generator=g) * 0.5).cuda()
    state0 = torch.zeros(B, H, P, N, device="cuda")
    got = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)
    want = ref.ssd_scan_ref(x, dt, A, Bm, Cm, state0)[0]
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ok = bool(torch.allclose(got, want, rtol=2e-4, atol=2e-4))
    Q = min(chunk, S)
    # the chunked form's products (``ops.ssd_flops``: causal pairs)
    flops = float(ops_ssd_flops(x, Bm, chunk, backward=False))
    nbytes = 4.0 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N)
    # the four products run as 3xTF32 on the tensor cores
    b_ms, b_by = bound(flops, nbytes, TF32X3_PEAK)
    row = {"case": name, "kernel": "ssd_scan",
           "shape": f"x ({B},{S},{H},{P}), N {N}, chunk {Q}",
           "dtype": "float32", "max_abs_err": err, "rtol": 2e-4,
           "atol": 2e-4, "ok": ok, "finite": bool(torch.isfinite(got).all()),
           "kernel_ms": time_ms(lambda: ss.ssd_scan(x, dt, A, Bm, Cm,
                                                    chunk=chunk),
                                iters=iters),
           "plain_ms": time_ms(lambda: ref.ssd_scan_ref(x, dt, A, Bm, Cm,
                                                        state0),
                               iters=1, reps=2),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bound_fp32_cores_ms": bound(flops, nbytes, FP32_PEAK)[0]}
    if profiled:
        prof = profile_batch(torch, lambda: ss.ssd_scan(x, dt, A, Bm, Cm,
                                                        chunk=chunk))["ssd"]
        row["cuda_launches_per_call"] = prof["cuda_launches"]
        row["launch_profile"] = prof["by_kernel"]
    emit(row)
    require(ok and row["finite"], f"ssd_scan {name} disagrees with its "
                                  f"plain version (max abs err {err})")
    return row


def ssd_cases(torch, ss, ref):
    """A mamba2-2.7b layer (first), the JAX test shape, one chunk of 48,
    and ragged chunks of 100 through the state pass."""
    return [check_ssd(torch, ss, ref, 22, "mamba2_layer", 1, 4096, 80, 64,
                      128, 128, iters=5, profiled=True),
            check_ssd(torch, ss, ref, 23, "jax_test_shape", 2, 256, 3, 16,
                      8, 32),
            check_ssd(torch, ss, ref, 24, "single_chunk", 1, 48, 16, 32, 32,
                      128),
            check_ssd(torch, ss, ref, 25, "ragged_chunks", 2, 300, 8, 64,
                      128, 100)]


def ssd_chunked_grads(torch, x, dt, A, Bm, Cm, dy, Q):
    """The five gradients of the port's chunked form from zero
    (``models.ssm.ssd_chunked``, the JAX package's form) by autograd, in
    float32: with the sequential loop, the float32 yardstick the SSD
    backward kernel's float64 error is held to."""
    from repro_torch.models.ssm import ssd_chunked
    ts = [t.detach().clone().requires_grad_(True)
          for t in (x, dt, A, Bm, Cm)]
    s0 = x.new_zeros((x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1]))
    return torch.autograd.grad(ssd_chunked(*ts, s0, Q)[0], ts, dy)


def ssd_bwd_inputs(torch, seed: int, B: int, S: int, H: int, P: int,
                   N: int, decay: float = 1.0):
    """(x, dt, A, B, C, dy) on the card, drawn from ``seed`` as
    ``check_ssd`` draws them (dt and A times ``decay``) and a unit-normal
    dy."""
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, H, P, generator=g).cuda()
    dt = (F.softplus(torch.randn(B, S, H, generator=g)) * 0.1
          * decay).cuda()
    A = ((-torch.randn(H, generator=g).abs() - 0.1) * decay).cuda()
    Bm = (torch.randn(B, S, N, generator=g) * 0.5).cuda()
    Cm = (torch.randn(B, S, N, generator=g) * 0.5).cuda()
    dy = torch.randn(B, S, H, P, generator=g).cuda()
    return x, dt, A, Bm, Cm, dy


def check_ssd_bwd(torch, ss, ref, seed: int, name: str, B: int, S: int,
                  H: int, P: int, N: int, chunk: int, decay: float = 1.0,
                  iters: int = 20, profiled: bool = False):
    """The SSD backward kernels against ``ssd_scan_bwd_ref`` (the plain
    reverse loop) on inputs drawn as ``check_ssd`` draws them (dt and A
    times ``decay``) and a unit-normal dy.  Each of the five gradients'
    float64 error (against ``ssd_scan_bwd_ref`` in float64) may not
    exceed twice the plain loop's float32 error; under strong decay
    (``decay`` > 1) twice the larger float32 error of the loop and of the
    chunked form by autograd: there the loop's sums are a few steps long
    and its error small, and the kernel's decomposition emulated with
    3xTF32 products (tests/test_torch_tf32x3.py) misses twice it as well.
    Two calls bitwise equal.  The bound: the products the gradient needs,
    the forward's C B^T and chunk states recomputed (ssd_scan_bwd.cu's
    note), at the 3xTF32 rate, against x, dt, A, B, C, dy read once and
    the five gradients written once; ``design_gflop`` adds the dCB
    products launch f runs once per head group (``head_group`` heads
    each, ``head_groups`` of them) where the gradient needs them once."""
    args = ssd_bwd_inputs(torch, seed, B, S, H, P, N, decay)
    Q = min(chunk, S)
    got = ss.ssd_scan_bwd(*args, chunk=chunk)
    again = ss.ssd_scan_bwd(*args, chunk=chunk)
    want = ref.ssd_scan_bwd_ref(*args, chunk)
    chunked = ssd_chunked_grads(torch, *args, Q)
    exact = ref.ssd_scan_bwd_ref(*args, chunk, dtype=torch.float64)
    torch.cuda.synchronize()
    names = ("dx", "ddt", "dA", "dB", "dC")

    def errs(outs):
        return {n: float((a.double() - e).abs().max())
                for n, a, e in zip(names, outs, exact)}
    err_k, err_p, err_c = errs(got), errs(want), errs(chunked)
    del exact, chunked
    bars = {n: 2.0 * (max(err_p[n], err_c[n]) if decay > 1.0 else err_p[n])
            for n in names}
    ok = all(err_k[n] <= bars[n] for n in names)
    bitwise = all(_bitwise_equal(torch, a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(t).all()) for t in got)
    vs_plain = max(float((a - b).abs().max()) for a, b in zip(got, want))
    nc = S // Q
    pairs = Q * (Q + 1) // 2
    # the products the gradient needs (``ops.ssd_flops``)
    flops = float(ops_ssd_flops(args[0], args[3], chunk, backward=True))
    HG = ss.default_head_group(H, S, Q, N)
    NG = -(-H // HG)
    # dCB B and dCB^T C once per head group
    redone = 2.0 * B * (NG - 1) * 2 * nc * pairs * N
    nbytes = 4.0 * 2 * (2 * B * S * H * P + B * S * H + H + 2 * B * S * N) \
        - 4.0 * B * S * H * P               # dy has no gradient written
    b_ms, b_by = bound(flops, nbytes, TF32X3_PEAK)
    row = {"case": name, "kernel": "ssd_scan_bwd",
           "shape": f"x ({B},{S},{H},{P}), N {N}, chunk {Q}",
           "decay": decay, "dtype": "float32", "max_abs_err": vs_plain,
           "fp64_err_kernel": err_k, "fp64_err_plain": err_p,
           "fp64_err_chunked": err_c, "bar": bars,
           "err_over_loop": {n: err_k[n] / err_p[n] for n in names},
           "ok": ok, "bitwise": bitwise,
           "finite": finite,
           "kernel_ms": time_ms(lambda: ss.ssd_scan_bwd(*args, chunk=chunk),
                                iters=iters),
           # the plain loop ran just above (warm); seconds a call
           "plain_ms": time_events(lambda: ref.ssd_scan_bwd_ref(*args,
                                                                chunk),
                                   iters=1, warmup=0),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bound_fp32_cores_ms": bound(flops, nbytes, FP32_PEAK)[0],
           "gflop": flops / 1e9, "design_gflop": (flops + redone) / 1e9,
           "head_group": HG, "head_groups": NG}
    if profiled:
        prof = profile_batch(torch, lambda: ss.ssd_scan_bwd(
            *args, chunk=chunk), cpu=False)["ssd"]
        row["cuda_launches_per_call"] = prof["cuda_launches"]
        row["launch_profile"] = prof["by_kernel"]
    emit(row)
    require(ok and bitwise and finite,
            f"ssd_scan_bwd {name}: float64 errors {err_k} against the "
            f"bars {bars} (plain loop {err_p}, chunked form {err_c}); "
            f"bitwise {bitwise}, finite {finite}")
    return row


# (name, seed, B, S, H, P, N, chunk, decay): a mamba2-2.7b layer, the JAX
# test shape, one chunk of 48, ragged chunks of 100 through both state
# passes, and dt and A x4 (|cum| to about 300 a chunk)
SSD_BWD_CASES = (("mamba2_layer", 80, 1, 4096, 80, 64, 128, 128, 1.0),
                 ("jax_test_shape", 81, 2, 256, 3, 16, 8, 32, 1.0),
                 ("single_chunk", 82, 1, 48, 16, 32, 32, 128, 1.0),
                 ("ragged_chunks", 83, 2, 300, 8, 64, 128, 100, 1.0),
                 ("strong_decay", 84, 2, 512, 4, 64, 128, 128, 4.0))


def ssd_bwd_cases(torch, ss, ref):
    """``check_ssd_bwd`` at each of ``SSD_BWD_CASES``, the mamba2 layer
    first and profiled."""
    return [check_ssd_bwd(torch, ss, ref, seed, name, B, S, H, P, N, chunk,
                          decay, iters=3 if k == 0 else 20,
                          profiled=k == 0)
            for k, (name, seed, B, S, H, P, N, chunk, decay)
            in enumerate(SSD_BWD_CASES)]


# --------------------------- LM stack: paths C, D, E, H, I and J
def lm_counts(**n):
    """A launch-count dict: the named kernels' counts, every other 0."""
    return {k: n.get(k, 0) for k in ("moe_gemm", "redundancy_vote",
                                     "audit_mlp", "flash_attention",
                                     "flash_attention_bwd", "rglru_scan",
                                     "rglru_scan_bwd", "ssd_scan",
                                     "ssd_scan_bwd")}


def prefill_batch(torch, cfg, S: int):
    """The prefill's inputs at a sequence of S, on the card, from seed 0:
    S tokens; for a VLM the patch prefix (``frontend_tokens``, at most
    S/2, as ``src/repro/launch/shapes.py`` shapes it) and S - P tokens;
    for the encoder-decoder S frames and S tokens."""
    from repro_torch.data.synthetic import lm_batches, stub_embeddings
    batch, text = {}, S
    if cfg.is_encoder_decoder:
        batch["frames"] = stub_embeddings(1, S, cfg.d_model, seed=0)
    elif cfg.frontend == "vision":
        P = min(cfg.frontend_tokens, S // 2)
        batch["patches"] = stub_embeddings(1, P, cfg.d_model, seed=0)
        text = S - P
    batch["tokens"] = next(lm_batches(cfg.vocab_size, 1, text,
                                      seed=0))["tokens"].cuda()
    return batch


def _profiled(prof, group: str, calls: int):
    """One kernel group of a profiled run: its wrapper calls, CUDA
    launches, device time and share of the run's device time."""
    g = prof[group]
    return {"calls": calls, "cuda_launches": g["cuda_launches"],
            "cuda_launches_per_call": (g["cuda_launches"] / calls
                                       if calls else None),
            "device_ms": g["device_us"] / 1e3,
            "device_share": g["device_us"] / prof["device_busy_us"],
            "by_kernel": g["by_kernel"]}


def lm_prefill(torch, ops, cfg, params, batch, want_counts, reduced=None):
    """The prefill step on ``batch`` (1 x 4096 positions): the main path's
    run with the launch counts set to 0 around it, its peak memory, then
    one profiled warm run (device only).  The wall (the run's span on the
    device clock), busy, idle, each kernel group's calls, CUDA launches
    (one ssd_scan call is four, one rglru_scan call two) and device time
    come from the profiled run."""
    from repro_torch.train.step import make_prefill_step
    prefill = make_prefill_step(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    nxt = prefill(params, batch)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ops.reset_launch_counts()
    prof = profile_batch(torch, lambda: prefill(params, batch), cpu=False)
    calls = {k: n // prof["takes"] for k, n in ops.launch_counts().items()}
    wall_ms = prof["span_us"] / 1e3
    S = sum(batch[k].shape[1] for k in ("tokens", "patches") if k in batch)
    row = {"phase": "lm_prefill", "model": cfg.name, "batch": 1, "seq": S,
           "inputs": {k: list(v.shape) for k, v in batch.items()},
           "reduced": reduced, "launches": counts,
           "ssd_profiled": _profiled(prof, "ssd", calls["ssd_scan"]),
           "rglru_profiled": _profiled(prof, "rglru", calls["rglru_scan"]),
           "moe_gemm_profiled": _profiled(prof, "moe_gemm",
                                          calls["moe_gemm"]),
           "flash_profiled": _profiled(prof, "flash",
                                       calls["flash_attention"]),
           "wall_ms": wall_ms,
           "tokens_per_s": S / (wall_ms / 1e3),
           "peak_mem_gb": peak / 1e9, "next_token": nxt.tolist(),
           "device_busy_ms": prof["device_busy_us"] / 1e3,
           "device_idle_share": 1.0 - prof["device_busy_us"] / 1e3 / wall_ms,
           "profile": prof["top"]}
    emit(row)
    require(nxt.shape == (1, 1) and 0 <= int(nxt) < cfg.padded_vocab,
            f"{cfg.name} prefill gave {nxt.tolist()}")
    require(counts == want_counts, f"{cfg.name} prefill launched {counts}, "
                                   f"wanted {want_counts}")
    return counts, row


def _decode_line(torch, name, cfg, S, dec, full, step_ms, prof, extra):
    """Emit a decode-against-forward line; return the error and whether
    it holds the 2e-3 bar."""
    err = float((dec - full).abs().max())
    finite = bool(torch.isfinite(full).all())
    emit({"phase": name, "model": cfg.name, "seq": S, **extra,
          "max_abs_err": err, "rtol": 2e-3, "atol": 2e-3,
          "logits_finite": finite, "logit_abs_max": float(full.abs().max()),
          "decode_step_ms": step_ms,
          "step_device_busy_ms": prof["device_busy_us"] / 1e3,
          "step_device_idle_share": 1.0 - prof["device_busy_us"] / 1e3
          / step_ms, "step_profile": prof["top"]})
    require(finite and full.shape == (1, S, cfg.padded_vocab),
            f"{cfg.name} forward logits shape {tuple(full.shape)} / finite")


def decode_vs_train(torch, cfg, params, tokens, S: int):
    """Teacher-forced decode of ``tokens[:, :S]`` through the caches
    against the full forward's logits, at the 2e-3 bar of the JAX
    package's tests/test_consistency.py.  A VLM decodes its text alone
    (decode embeds tokens, not patches)."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.builder import materialize
    toks = tokens[:, :S].cuda()
    full, _ = tfm.forward_train(params, toks, cfg)
    caches = materialize(tfm.cache_decl(cfg, 1, S), 0, "cuda")
    dec = torch.empty_like(full)
    t0 = time.perf_counter()
    for t in range(S):
        logits, caches = tfm.forward_decode(params, caches,
                                            toks[:, t:t + 1], t, cfg)
        dec[:, t] = logits[:, 0]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / S * 1e3
    prof = profile_batch(torch, lambda: tfm.forward_decode(
        params, caches, toks[:, S - 1:], S - 1, cfg))
    ok = bool(torch.allclose(dec, full, rtol=2e-3, atol=2e-3))
    _decode_line(torch, "decode_vs_train", cfg, S, dec, full, step_ms, prof,
                 {"window": cfg.sliding_window if any(
                     s.kind == "local_attn" for s in cfg.block_pattern)
                  else None, "ok": ok})
    require(ok, f"{cfg.name} decode differs from the forward by "
                f"{float((dec - full).abs().max())}")


class RouteRecorder:
    """``repro_torch.models.moe.route`` wrapped inside a ``with`` block:
    each call's router logits, expert ids and keep flags, in call order,
    left on the card."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.inner, self.calls = moe, moe.route, []

        def route(logits, k, capacity, num_real=0):
            out = self.inner(logits, k, capacity, num_real)
            self.calls.append((logits, out[1], out[3]))
            return out
        moe.route = route
        return self.calls

    def __exit__(self, *exc):
        self.moe.route = self.inner


def routing_check(torch, cfg, fwd, dec, full, dec_logits, S: int):
    """Decode's routing against one forward's, token by token over the L
    MoE layers.  ``fwd``: L recorded calls over the sequence; ``dec``:
    S * L one-token calls, step by step.  A disagreement is a (token,
    layer) whose expert set differs; a drop, an assignment the forward's
    capacity dropped.  Either changes the token's residual from that
    layer on, and every later token reads it through attention, so:
    every disagreement must have a top-k router margin under 1e-4 (a
    near-tie, either run's margin) or follow a drop or disagreement at
    an earlier layer of this or an earlier token; the 2e-3 bar is held
    on every token before the first drop or disagreement, and every
    other token is counted."""
    L, k, n = len(fwd), cfg.num_experts_per_tok, cfg.num_experts
    f_eid = torch.stack([c[1][0] for c in fwd], 1)          # (S, L, k)
    f_keep = torch.stack([c[2][0] for c in fwd], 1)
    d_eid = torch.stack([c[1][0, 0] for c in dec]).reshape(S, L, k)

    def margin(lg):                                        # (S, L)
        top = lg[..., :n].float().sort(-1, descending=True)[0]
        return top[..., k - 1] - top[..., k]

    m = torch.minimum(
        margin(torch.stack([c[0][0] for c in fwd], 1)),
        margin(torch.stack([c[0][0, 0] for c in dec]).reshape(S, L, -1)))
    disagree = (f_eid.sort(-1)[0] != d_eid.sort(-1)[0]).any(-1)
    dropped = ~f_keep.all(-1)
    event = disagree | dropped
    # an event at (s <= t, l' < l) may explain a disagreement at (t, l)
    seen = event.int().cummax(0)[0].cummax(1)[0]
    prior = torch.zeros_like(event)
    prior[:, 1:] = seen[:, :-1].bool()
    unexplained = disagree & ~prior & (m >= 1e-4)
    clean = ~event.any(1).int().cummax(0)[0].bool()       # (S,)
    err = (dec_logits - full).abs().amax(-1)[0]            # (S,)
    where = disagree.nonzero().tolist()
    res = {"moe_layers": L, "dropped_assignments": int((~f_keep).sum()),
           "tokens_with_a_drop": int(dropped.any(1).sum()),
           "disagreements": len(where),
           "disagreement_at": [{"token": t, "layer": l,
                                "topk_margin": float(m[t, l])}
                               for t, l in where[:16]],
           "unexplained_disagreements": int(unexplained.sum()),
           "min_topk_margin": float(m.min()),
           "checked_tokens": int(clean.sum()),
           "unchecked_tokens": int((~clean).sum()),
           "max_abs_err_checked": (float(err[clean].max())
                                   if clean.any() else None),
           "max_abs_err_unchecked": (float(err[~clean].max())
                                     if (~clean).any() else None)}
    res["ok"] = (res["unexplained_disagreements"] == 0
                 and (res["max_abs_err_checked"] or 0.0) <= 2e-3)
    return res


def moe_decode_vs_train(torch, cfg, params, tokens, S: int):
    """Teacher-forced decode with ``expert_stats`` against two forwards:
    at the config's capacity (its drops reported) and at a capacity that
    drops nothing (capacity factor E / k, as the JAX package's own
    tests/test_consistency.py raises it), each under ``routing_check``.
    Every step's counts equal a recount of its routing, each layer's
    summing to k."""
    import dataclasses
    from repro_torch.models import transformer as tfm
    from repro_torch.models.builder import materialize
    from repro_torch.models.moe import capacity_for
    toks = tokens[:, :S].cuda()
    nodrop = dataclasses.replace(
        cfg, capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    E, k = cfg.resolved_padded_experts, cfg.num_experts_per_tok
    with RouteRecorder() as rec:
        full, _ = tfm.forward_train(params, toks, cfg)
        fwd = rec[:]
        full_nd, _ = tfm.forward_train(params, toks, nodrop)
        fwd_nd = rec[len(fwd):]
        del rec[:]
        caches = materialize(tfm.cache_decl(cfg, 1, S), 0, "cuda")
        dec = torch.empty_like(full)
        stats_exact = True
        t0 = time.perf_counter()
        for t in range(S):
            logits, caches, stats = tfm.forward_decode(
                params, caches, toks[:, t:t + 1], t, cfg, expert_stats=True)
            dec[:, t] = logits[:, 0]
            recount = torch.stack([torch.bincount(c[1].reshape(-1),
                                                  minlength=E)
                                   for c in rec[-len(fwd):]])
            stats_exact &= bool(torch.equal(stats.long(), recount)
                                and (stats.sum(-1) == k).all())
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / S * 1e3
        dec_calls = rec[:]
    prof = profile_batch(torch, lambda: tfm.forward_decode(
        params, caches, toks[:, S - 1:], S - 1, cfg, expert_stats=True))
    at_cap = routing_check(torch, cfg, fwd, dec_calls, full, dec, S)
    no_drop = routing_check(torch, cfg, fwd_nd, dec_calls, full_nd, dec, S)
    _decode_line(torch, "moe_decode_vs_train", cfg, S, dec, full_nd,
                 step_ms, prof,
                 {"capacity": capacity_for(cfg, S),
                  "no_drop_capacity": capacity_for(nodrop, S),
                  "stats_exact": stats_exact, "at_capacity": at_cap,
                  "no_drop": no_drop})
    require(stats_exact, f"{cfg.name}: decode expert counts differ from "
                         f"the routing's recount")
    require(at_cap["ok"] and no_drop["ok"],
            f"{cfg.name} decode against the forward: {at_cap}, {no_drop}")


def moe_decode_step_stats(torch, cfg, params):
    """``make_decode_step(expert_stats=True)`` on a 4-row batch (per-row
    positions, one inactive row) after a 4-token prefix: per MoE layer
    the counts of all 4 rows, the inactive one included, sum to 4 k and
    equal a recount of the step's routing."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.builder import materialize
    from repro_torch.train.step import make_decode_step
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (4, 5), generator=g).cuda()
    caches = materialize(tfm.cache_decl(cfg, 4, 8), 0, "cuda")
    for t in range(4):
        _, caches = tfm.forward_decode(params, caches, toks[:, t:t + 1], t,
                                       cfg)
    step = make_decode_step(cfg, expert_stats=True)
    batch = {"tokens": toks[:, 4:], "pos": torch.tensor([4, 4, 3, 4]).cuda(),
             "active": torch.tensor([True, True, False, True]).cuda()}
    with RouteRecorder() as rec:
        nxt, _, stats = step(params, caches, batch)
    E, k = cfg.resolved_padded_experts, cfg.num_experts_per_tok
    recount = torch.stack([torch.bincount(c[1].reshape(-1), minlength=E)
                           for c in rec])
    res = {"phase": "moe_decode_step_stats", "model": cfg.name,
           "rows": 4, "stats_shape": list(stats.shape),
           "layer_sums": stats.sum(-1).tolist(),
           "equal_recount": bool(torch.equal(stats.long(), recount)),
           "next_tokens": nxt.tolist()}
    emit(res)
    require(res["equal_recount"] and res["layer_sums"] == [4 * k] * len(rec)
            and stats.dtype == torch.int32,
            f"{cfg.name} decode step's expert stats: {res}")


def encdec_decode_vs_train(torch, cfg, params, batch, S: int):
    """The encoder-decoder's teacher-forced decode of ``S`` tokens through
    the self K/V cache, against the cross K/V built here from ``encode``
    over all the frames (each decoder layer's ``xattn.wk``/``wv``, no
    rope), held to the full forward's logits at 2e-3."""
    from repro_torch.models import encdec
    from repro_torch.models.builder import materialize
    frames, toks = batch["frames"], batch["tokens"][:, :S]
    full, _ = encdec.forward_train(params, frames, toks, cfg)
    memory = encdec.encode(params, frames, cfg)
    M = memory.shape[1]
    shape = (1, M, cfg.num_kv_heads, cfg.resolved_head_dim)
    x = params["dec_blocks"]["xattn"]
    caches = materialize(encdec.encdec_cache_decl(cfg, 1, S, M), 0, "cuda")
    caches["cross_k"] = torch.stack([(memory @ w).reshape(shape)
                                     for w in x["wk"]])
    caches["cross_v"] = torch.stack([(memory @ w).reshape(shape)
                                     for w in x["wv"]])
    dec = torch.empty_like(full)
    t0 = time.perf_counter()
    for t in range(S):
        logits, caches = encdec.forward_decode(params, caches,
                                               toks[:, t:t + 1], t, cfg)
        dec[:, t] = logits[:, 0]
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / S * 1e3
    prof = profile_batch(torch, lambda: encdec.forward_decode(
        params, caches, toks[:, S - 1:], S - 1, cfg))
    ok = bool(torch.allclose(dec, full, rtol=2e-3, atol=2e-3))
    _decode_line(torch, "encdec_decode_vs_train", cfg, S, dec, full, step_ms,
                 prof, {"memory": M, "ok": ok})
    require(ok, f"{cfg.name} decode differs from the forward by "
                f"{float((dec - full).abs().max())}")


def serve_greedy(torch, cfg, params, requests, start, cache_len: int):
    """Greedy decoding of ``requests`` in one batch, slot r admitted at
    step ``start[r]``: each step feeds a slot its next prompt token, then
    its last generated one, at its own position (``pos`` per row), and an
    inactive slot (not yet admitted, done, or ``None``: a slot that holds
    no request) leaves its caches as they were.  This is the decode step
    ``train.step.make_decode_step`` runs, with the logits kept.  Returns,
    per slot, its logits per step ((n, V) on the card, None for an empty
    slot) and its generated tokens."""
    from repro_torch.models import transformer as tfm
    from repro_torch.models.builder import materialize
    B = len(requests)
    lens = [len(r["prompt"]) + r["max_new_tokens"] - 1 if r else 0
            for r in requests]
    steps = max(s + n for s, n in zip(start, lens))
    caches = materialize(tfm.cache_decl(cfg, B, cache_len), 0, "cuda")
    logits_out = [[] for _ in requests]
    gen = [[] for _ in requests]
    for t in range(steps):
        tok, pos, active = [], [], []
        for r, req in enumerate(requests):
            i = t - start[r]                    # the request's own step
            live = req is not None and 0 <= i < lens[r]
            tok.append(int(req["prompt"][i]) if live and i < len(
                req["prompt"]) else (gen[r][-1] if live else 0))
            pos.append(min(max(i, 0), lens[r]))
            active.append(live)
        logits, caches = tfm.forward_decode(
            params, caches, torch.tensor(tok, device="cuda")[:, None],
            torch.tensor(pos, device="cuda"), cfg,
            write_mask=torch.tensor(active, device="cuda"))
        nxt = logits[:, 0].argmax(dim=-1).tolist()
        for r, req in enumerate(requests):
            i = t - start[r]
            if active[r]:
                logits_out[r].append(logits[r, 0])
                if i >= len(req["prompt"]) - 1:
                    gen[r].append(nxt[r])
    return [torch.stack(x) if x else None for x in logits_out], gen


def batched_vs_alone(torch, cfg, params, width1_tol=None, bitwise=False):
    """Four requests decoded in one 4-slot batch (admitted at steps 0-3)
    against each one alone: in the same 4-slot batch with the other slots
    empty (the serving engine's fixed width: bar 1e-4, or bit for bit
    where ``bitwise``, and the same tokens), and, where ``width1_tol`` is
    given, in a batch of width 1 (the same tokens, the logits within
    ``width1_tol``).  Across widths the library products round
    differently (cuBLAS picks its kernel by the row count), so the
    width-1 error grows with how far the model amplifies rounding, as
    its decode-against-forward error does.  An MoE model is held bit for
    bit at the same width: each slot is its own dispatch group and
    ``moe_gemm``'s rows do not depend on the other rows of the fold."""
    from repro_torch.data.synthetic import serving_requests
    reqs = list(serving_requests(cfg.vocab_size, 4, max_prompt=64,
                                 max_new=16, seed=0))
    cache_len = max(len(r["prompt"]) + r["max_new_tokens"] for r in reqs)
    t0 = time.perf_counter()
    batched, gen_b = serve_greedy(torch, cfg, params, reqs, [0, 1, 2, 3],
                                  cache_len)
    torch.cuda.synchronize()
    batched_s = time.perf_counter() - t0
    errs, same, errs1, same1 = [], [], [], []
    for r, req in enumerate(reqs):
        slots = [None] * 4
        slots[r] = req
        alone, gen_a = serve_greedy(torch, cfg, params, slots, [0] * 4,
                                    cache_len)
        errs.append(float((batched[r] - alone[r]).abs().max()))
        same.append(gen_b[r] == gen_a[r])
        if width1_tol is not None:
            alone1, gen_1 = serve_greedy(torch, cfg, params, [req], [0],
                                         cache_len)
            errs1.append(float((batched[r] - alone1[0]).abs().max()))
            same1.append(gen_b[r] == gen_1[0])
    ok = (max(errs) <= (0.0 if bitwise else 1e-4) and all(same)
          and all(same1) and max(errs1, default=0.0) <= (width1_tol or 0.0))
    emit({"phase": "batched_decode", "model": cfg.name, "slots": 4,
          "prompts": [len(r["prompt"]) for r in reqs],
          "max_new_tokens": [r["max_new_tokens"] for r in reqs],
          "admitted_at_step": [0, 1, 2, 3], "max_abs_err": errs,
          "tol": 0.0 if bitwise else 1e-4, "bitwise": bitwise,
          "tokens_equal": same,
          "width1_max_abs_err": errs1, "width1_tol": width1_tol,
          "width1_tokens_equal": same1, "ok": ok,
          "generated": gen_b, "batched_s": batched_s})
    require(ok, f"batched decode differs from each request alone: {errs} "
                f"(same width), {errs1} (width 1), tokens equal {same}, "
                f"{same1}")


# paths D and E cut in depth to keep the whole script within its time:
# recurrentgemma-2b to 2 of its 8 (rglru, rglru, local_attn) blocks and
# its 2 remainder rglru layers; mamba2-2.7b to 32 of 64 layers (L2 and
# L4 train these)
D_BLOCKS = 2
D_DEPTH = (3 * D_BLOCKS + 2, D_BLOCKS)
E_DEPTH = (32, 32)
# path H's qwen2-moe-a2.7b (K1 and P1 run on its weights): 12 of 24
H_QWEN_DEPTH = (12, 12)


def depth_cut(cfg, depth):
    """``cfg`` at its full width with ``depth`` = (layers, blocks) kept."""
    import dataclasses
    return dataclasses.replace(cfg, num_layers=depth[0],
                               num_blocks=depth[1]).validate()


def lm_path(torch, ops, arch: str, want_counts, decode_seq: int,
            serving: bool = False, width1_tol=None, smoke: bool = False,
            depth=None, then=None):
    """One model: init from seed 0 on the card at full width (``smoke``:
    the config's smoke width; ``depth``: (layers, blocks) kept of a model
    that does not fit the card, widths untouched), prefill at 4096
    positions (the main path's launch counts), decode against the
    forward (the MoE and encoder-decoder forms where they apply), where
    ``serving`` is set the batched-serving check, and ``then(cfg,
    params)`` (a part of path K) while the weights are on the card.  The
    model is freed before returning, so the next path's peak does not
    stack on it.  Returns (prefill counts, prefill line, ``then``'s
    result)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.train.loop import init_model
    cfg = get_config(arch, smoke)
    reduced = "smoke width" if smoke else None
    if depth:
        full = cfg.num_layers
        cfg = depth_cut(cfg, depth)
        reduced = f"depth {cfg.num_layers} of {full} layers"
    t0 = time.perf_counter()
    params = init_model(cfg, 0)
    torch.cuda.synchronize()
    emit({"phase": "lm_init", "model": cfg.name, "reduced": reduced,
          "init_s": time.perf_counter() - t0,
          "params_gb": torch.cuda.memory_allocated() / 1e9})
    batch = prefill_batch(torch, cfg, 4096)
    counts, row = lm_prefill(torch, ops, cfg, params, batch, want_counts,
                             reduced)
    if cfg.is_encoder_decoder:
        encdec_decode_vs_train(torch, cfg, params, batch, decode_seq)
    elif cfg.num_experts:
        moe_decode_vs_train(torch, cfg, params, batch["tokens"], decode_seq)
        moe_decode_step_stats(torch, cfg, params)
    else:
        decode_vs_train(torch, cfg, params, batch["tokens"], decode_seq)
    if serving:
        batched_vs_alone(torch, cfg, params, width1_tol,
                         bitwise=bool(cfg.num_experts))
    after = then(cfg, params) if then is not None else None
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return counts, row, after


# ---------------------------------------- path L: LM training
def _lm_train_batch(torch, cfg, B: int, S: int, seed: int = 0):
    """(B, S) tokens and labels from ``lm_batches``, on the card."""
    from repro_torch.data.synthetic import lm_batches
    return {k: v.cuda() for k, v in next(lm_batches(
        cfg.vocab_size, B, S, seed=seed)).items()}


def _layer_counts(cfg):
    """Per layer kind, (layers in the stacked blocks, in the remainder)."""
    blocks = list(cfg.block_pattern) * cfg.resolved_num_blocks
    out = {}
    for what, hit in (("attn", lambda s: s.kind in ("attn", "local_attn")),
                      ("rglru", lambda s: s.kind == "rglru"),
                      ("ssm", lambda s: s.kind == "ssm"),
                      ("moe", lambda s: s.mlp == "moe")):
        out[what] = (sum(map(hit, blocks)), sum(map(hit, cfg.remainder)))
    return out


def train_step_counts(cfg, remat: bool):
    """The launches one microbatch of a train step makes: each MoE layer 3
    moe_gemm forward and 6 backward, each attention layer one flash
    forward and one backward, each RG-LRU layer one scan and one reverse
    scan, each SSM layer one SSD scan and one SSD backward; with remat a
    checkpointed block's forwards run twice."""
    n = _layer_counts(cfg)
    if cfg.is_encoder_decoder:
        n["attn"] = (cfg.num_encoder_layers + 2 * cfg.num_layers, 0)
    twice = 2 if remat else 1
    return lm_counts(
        moe_gemm=3 * (twice * n["moe"][0] + n["moe"][1]) + 6 * sum(n["moe"]),
        flash_attention=twice * n["attn"][0] + n["attn"][1],
        flash_attention_bwd=sum(n["attn"]),
        rglru_scan=twice * n["rglru"][0] + n["rglru"][1],
        rglru_scan_bwd=sum(n["rglru"]),
        ssd_scan=twice * n["ssm"][0] + n["ssm"][1],
        ssd_scan_bwd=sum(n["ssm"]))


def _clone_tree(torch, tree):
    from repro_torch.core.ledger import tree_flatten, tree_unflatten
    leaves, _ = tree_flatten(tree)
    return tree_unflatten(tree, [t.clone() for t in leaves])


def _train_profile(torch, step_fn, params, state, batch, n_fwd_gemm: int):
    """One profiled train step (fenced, ``profile_batch``), every number
    from that step's own trace: device busy, its wall time on the device
    and idle share, and the device time of the flash forward and backward
    kernels, the moe_gemm launches of the forward (the first
    ``n_fwd_gemm`` in time) and of the backward, the library's GEMMs
    (cuBLAS) and the AdamW update (the kernels inside the step's
    ``adamw.update`` region); the shares are of the busy time."""
    prof = profile_batch(torch, lambda: step_fn(params, state, batch),
                         spans=("adamw.update",))
    ev = prof["events"]
    gemm = [us for _, us, name in ev if re.search(r"\bmoe_gemm_kernel\b",
                                                   name)]
    lib = sum(us for _, us, name in ev
              if re.search(r"gemm|xmma|cutlass|splitK", name, re.I)
              and "moe_gemm_kernel" not in name)
    upd = prof["spans"]["adamw.update"]
    require(len(upd) == 1, f"profiled train step: {len(upd)} adamw.update "
                           f"regions on the device, wanted 1")
    adamw = [us for t, us, _ in ev if upd[0][0] <= t < upd[0][1]]
    require(adamw, "profiled train step: no kernel in adamw.update")
    busy = prof["device_busy_us"]
    out = {"device_busy_ms": busy / 1e3,
           "device_wall_ms": prof["span_us"] / 1e3,
           "device_idle_share": 1.0 - busy / prof["span_us"],
           "device_launches": prof["device_launches"],
           "flash_forward_ms": prof["flash"]["device_us"] / 1e3,
           "flash_backward_ms": prof["flash_bwd"]["device_us"] / 1e3,
           "moe_gemm_forward_ms": sum(gemm[:n_fwd_gemm]) / 1e3,
           "moe_gemm_backward_ms": sum(gemm[n_fwd_gemm:]) / 1e3,
           "moe_gemm_launches": len(gemm),
           "rglru_ms": prof["rglru"]["device_us"] / 1e3,
           "rglru_bwd_ms": prof["rglru_bwd"]["device_us"] / 1e3,
           "library_gemm_ms": lib / 1e3,
           "adamw_update_ms": sum(adamw) / 1e3,
           "adamw_update_launches": len(adamw), "top": prof["top"],
           "takes": prof["takes"]}
    out["shares"] = {k[:-3]: out[k] / out["device_busy_ms"] for k in (
        "flash_forward_ms", "flash_backward_ms", "moe_gemm_forward_ms",
        "moe_gemm_backward_ms", "rglru_ms", "rglru_bwd_ms",
        "library_gemm_ms", "adamw_update_ms")}
    return out


def _flash_bwd_share(torch, run):
    """One fenced, profiled call of ``run`` (a train step), the device
    alone traced: busy and wall on the device, and the flash backward's
    device time, CUDA launches and share of busy."""
    prof = profile_batch(torch, run, cpu=False)
    busy = prof["device_busy_us"] / 1e3
    fb = prof["flash_bwd"]
    return {"device_busy_ms": busy, "device_wall_ms": prof["span_us"] / 1e3,
            "flash_backward_ms": fb["device_us"] / 1e3,
            "flash_backward_cuda_launches": fb["cuda_launches"],
            "flash_backward_share": fb["device_us"] / 1e3 / busy}


def _ssd_bwd_share(torch, run):
    """One fenced, profiled call of ``run`` (a train step), the device
    alone traced: busy and wall on the device, and the SSD scan's device
    time forward and backward.  Both start with the same chunk-state
    launches, so the SSD kernels are cut into calls after each call's
    last launch (the forward's ssd_chunk_out_kernel, the backward's
    ssd_bwd_sums_kernel): a call holding the backward's main launch
    (ssd_bwd_chunk_kernel) is a backward call, whose recomputed states
    count as its own."""
    prof = profile_batch(torch, run, cpu=False)
    chains, ended = [], True
    for _, us, name in prof["events"]:
        if not re.search(r"\bssd_\w+_kernel\b", name):
            continue
        if ended:
            chains.append([])
        chains[-1].append((us, name))
        ended = bool(re.search(r"\bssd_(chunk_out|bwd_sums)_kernel\b",
                               name))
    is_bwd = [any("ssd_bwd_chunk_kernel" in n for _, n in c) for c in chains]
    fwd_ms = bwd_ms = 0.0
    bwd_launches = 0
    for c, b in zip(chains, is_bwd):
        for us, n in c:
            if b:
                bwd_ms += us / 1e3
                bwd_launches += 1
            else:
                fwd_ms += us / 1e3
    busy = prof["device_busy_us"] / 1e3
    n_fwd = sum(len(re.findall(r"\bssd_chunk_out_kernel\b", n))
                for _, _, n in prof["events"])
    return {"device_busy_ms": busy, "device_wall_ms": prof["span_us"] / 1e3,
            "device_idle_share": 1.0 - prof["device_busy_us"]
            / prof["span_us"],
            "ssd_forward_calls": n_fwd, "ssd_forward_ms": fwd_ms,
            "ssd_forward_share": fwd_ms / busy,
            "ssd_backward_calls": sum(is_bwd), "ssd_backward_ms": bwd_ms,
            "ssd_backward_cuda_launches": bwd_launches,
            "ssd_backward_share": bwd_ms / busy, "top": prof["top"]}


def train_l1(torch, ops, cfg):
    """L1: bmoe-paper at full width and depth, ``train`` (remat off) from
    seed 0 (path H's weights, drawn again) for 4 steps on one fixed batch
    of (2, 2048) at lr 1e-3, constant: the loss falls from step 1 to 4
    and every step launches 36 moe_gemm forward + 72 backward and 12
    flash forward + 12 backward (counts set to 0 just before ``train``,
    read just after).  Then, on the trained weights: two steps from one
    state are bitwise equal; one step profiled (busy, idle, shares,
    AdamW's device time, all from that step's trace); one layer at full
    width (1, 512) against the CPU by gradients at rtol 1e-4."""
    import itertools
    from repro_torch.optim import adamw
    from repro_torch.train.loop import train
    from repro_torch.train.step import make_train_step
    start = time.perf_counter()
    batch = _lm_train_batch(torch, cfg, 2, 2048)
    opt = adamw.AdamWConfig(lr=1e-3, schedule="constant", warmup_steps=1)
    per_step = train_step_counts(cfg, remat=False)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    params, hist = train(cfg, itertools.repeat(batch), 4, opt_cfg=opt,
                         log_every=1, remat=False, seed=0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    walls = [hist[0]["wall_s"]] + [b["wall_s"] - a["wall_s"]
                                   for a, b in zip(hist, hist[1:])]
    step_ms = sorted(walls[1:])[1] * 1e3
    # two steps from one state
    step_fn = make_train_step(cfg, opt, remat=False)
    snap = _clone_tree(torch, params)
    ends = []
    for _ in range(2):
        p = _clone_tree(torch, snap)
        st = adamw.init(p)
        step_fn(p, st, batch)
        ends.append((p, st))
    torch.cuda.synchronize()
    from repro_torch.core.ledger import tree_flatten
    bitwise = all(_bitwise_equal(torch, a, b) for a, b in zip(
        tree_flatten((ends[0][0], ends[0][1].m, ends[0][1].v))[0],
        tree_flatten((ends[1][0], ends[1][1].m, ends[1][1].v))[0]))
    del ends, snap
    gc.collect()
    torch.cuda.empty_cache()
    st = adamw.init(params)
    step_fn(params, st, batch)          # warm: the cache emptied above
    prof = _train_profile(torch, step_fn, params, st, batch,
                          n_fwd_gemm=36)
    # P1: the dry run of this step against a counted run of it (last:
    # its timed step updates the weights)
    dryrun_p1(torch, ops, "L1", cfg, params, batch)
    del params, st
    gc.collect()
    torch.cuda.empty_cache()
    layer = train_layer_vs_cpu(torch, cfg)
    losses = [h["loss"] for h in hist]
    row = {"phase": "L1_train", "model": cfg.name, "batch": [2, 2048],
           "steps": 4, "remat": False, "lr": opt.lr, "schedule": "constant",
           "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
           "aux_losses": [h["aux_loss"] for h in hist],
           "launches": counts, "launches_per_step": per_step,
           "step_walls_ms": [w * 1e3 for w in walls],
           "median_step_ms": step_ms,
           "tokens_per_s": 2 * 2048 / (step_ms / 1e3),
           "device_idle_share": prof["device_idle_share"],
           "two_steps_bitwise": bitwise, "profile": prof,
           "one_layer_vs_cpu": layer,
           "path_s": time.perf_counter() - start}
    emit(row)
    require(all(map(math.isfinite, losses)) and losses[3] < losses[0],
            f"L1 loss did not fall: {losses}")
    require(counts == {k: 4 * v for k, v in per_step.items()},
            f"L1 launched {counts} in 4 steps, wanted 4 x {per_step}")
    require(per_step["moe_gemm"] == 36 + 72 and
            per_step["flash_attention"] == 12 and
            per_step["flash_attention_bwd"] == 12,
            f"L1 per-step counts {per_step}")
    require(prof["moe_gemm_launches"] == 108,
            f"L1 profiled step: {prof['moe_gemm_launches']} moe_gemm")
    require(bitwise, "L1: two steps from one state differ")
    require(layer["ok"], f"L1 one layer against the CPU: {layer}")
    return counts, row


def train_layer_vs_cpu(torch, cfg):
    """The model cut to one layer at full width, (1, 512) in one
    microbatch: the loss and every gradient on the card against the CPU's
    from the same weights (drawn on the CPU from seed 0) at rtol 1e-4 /
    atol 1e-5, the loss positive and some gradient not zero; for a MoE
    model the routing recorded on both and held equal."""
    import contextlib
    import dataclasses
    from repro_torch.core.ledger import tree_flatten, tree_unflatten
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import make_loss_and_grads
    # one microbatch: mamba2's 4 would cut a batch of 1 into empty ones
    cfg1 = dataclasses.replace(cfg, num_layers=1, num_blocks=1,
                               train_microbatches=1).validate()
    p_cpu = init_model(cfg1, 0, device="cpu")
    p = tree_unflatten(p_cpu, [t.cuda() for t in tree_flatten(p_cpu)[0]])
    batch = _lm_train_batch(torch, cfg1, 1, 512, seed=1)
    lg = make_loss_and_grads(cfg1, remat=False)
    moe = bool(cfg.num_experts)
    record = RouteRecorder if moe else (lambda: contextlib.nullcontext([]))
    with record() as rc:
        got = lg(p, batch)
    with record() as rp:
        want = lg(p_cpu, {k: v.cpu() for k, v in batch.items()})
    torch.cuda.synchronize()
    g_card, _ = tree_flatten(got[2])
    g_cpu, _ = tree_flatten(want[2])
    errs = [float((a.cpu() - b).abs().max()) for a, b in zip(g_card, g_cpu)]
    close = [bool(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-5))
             for a, b in zip(g_card, g_cpu)]
    res = {"layers": 1, "batch": [1, 512],
           "loss": [float(want[0]), float(got[0])],
           "grad_max_abs_err": max(errs), "leaves": len(errs),
           "leaves_close": sum(close),
           "grad_max_abs": max(float(g.abs().max()) for g in g_cpu)}
    same_route = True
    if moe:
        same_route = all(torch.equal(a[1].cpu(), b[1])
                         for a, b in zip(rc, rp))
        top = rp[0][0].detach()[..., :cfg.num_experts].sort(
            -1, descending=True)[0]
        k = cfg.num_experts_per_tok
        res["routing_equal"] = same_route
        res["router_margin_min"] = float((top[..., k - 1]
                                          - top[..., k]).min())
    res["ok"] = same_route and all(close) and abs(
        float(got[0]) - float(want[0])) <= 1e-5 and float(want[0]) > 0 \
        and res["grad_max_abs"] > 0
    return res


def train_l2(torch, ops, cfg, params):
    """L2: recurrentgemma-2b at full width on path D's weights (its
    ``D_BLOCKS`` blocks and the remainder): ``make_train_step(remat=True)``,
    2 steps on a batch of (2, 4096) cut into its 2 microbatches of (1,
    4096), so the 2048-key window masks keys: finite losses and gradient
    norms, launches per microbatch held to the config (a block's 2
    rglru_scan and the remainder's 2, the block's recomputed, one
    reverse each; a block's flash and its recomputation, one backward),
    the peak memory printed; then a third step profiled for the flash
    backward's share of the device's busy time."""
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    start = time.perf_counter()
    K = cfg.train_microbatches
    batch = _lm_train_batch(torch, cfg, 2, 4096)
    opt = adamw.AdamWConfig(lr=1e-4, schedule="constant", warmup_steps=1)
    step_fn = make_train_step(cfg, opt, remat=True)
    st = adamw.init(params)
    per_mb = train_step_counts(cfg, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    metrics, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        _, st, m = step_fn(params, st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    profiled = _flash_bwd_share(torch, lambda: step_fn(params, st, batch))
    del st
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": "L2_train", "model": cfg.name, "batch": [2, 4096],
           "microbatches": K, "remat": True, "steps": 2,
           "metrics": metrics, "launches": counts,
           "launches_per_microbatch": per_mb,
           "step_walls_ms": [w * 1e3 for w in walls],
           "tokens_per_s": 2 * 4096 / walls[-1],
           "peak_mem_gb": peak / 1e9,
           "params_gb": sum(t.numel() for t in tree_flatten(params)[0])
           * 4 / 1e9, "profiled_step": profiled,
           "path_s": time.perf_counter() - start}
    emit(row)
    require(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                for m in metrics), f"L2 metrics {metrics}")
    require(per_mb["rglru_scan"] == 4 * D_BLOCKS + 2
            and per_mb["rglru_scan_bwd"] == 2 * D_BLOCKS + 2
            and per_mb["flash_attention"] == 2 * D_BLOCKS
            and per_mb["flash_attention_bwd"] == D_BLOCKS,
            f"L2 per-microbatch counts {per_mb}")
    require(counts == {k: 2 * K * v for k, v in per_mb.items()},
            f"L2 launched {counts}, wanted {2 * K} x {per_mb}")
    return counts, row


def train_l3(torch, ops, cfg, params):
    """L3: seamless-m4t-medium at full width on path J's weights, 2 steps
    (remat off) on 4,096 stub frames and 512 tokens: finite losses, 36
    flash forward launches (12 encoder, 12 decoder self, 12 cross) and 36
    backward a step; then a third step profiled for the flash backward's
    share of the device's busy time."""
    from repro_torch.data.synthetic import stub_embeddings
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    start = time.perf_counter()
    batch = _lm_train_batch(torch, cfg, 1, 512)
    batch["frames"] = stub_embeddings(1, 4096, cfg.d_model, seed=0)
    opt = adamw.AdamWConfig(lr=1e-4, schedule="constant", warmup_steps=1)
    step_fn = make_train_step(cfg, opt, remat=False)
    st = adamw.init(params)
    per_step = train_step_counts(cfg, remat=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    metrics, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        _, st, m = step_fn(params, st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        walls.append(time.perf_counter() - t0)
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    profiled = _flash_bwd_share(torch, lambda: step_fn(params, st, batch))
    del st
    gc.collect()
    torch.cuda.empty_cache()
    row = {"phase": "L3_train", "model": cfg.name, "frames": 4096,
           "tokens": 512, "steps": 2, "remat": False, "metrics": metrics,
           "launches": counts, "launches_per_step": per_step,
           "step_walls_ms": [w * 1e3 for w in walls],
           "peak_mem_gb": peak / 1e9, "profiled_step": profiled,
           "path_s": time.perf_counter() - start}
    emit(row)
    require(all(math.isfinite(m["loss"]) for m in metrics),
            f"L3 metrics {metrics}")
    require(per_step["flash_attention"] == 36
            and per_step["flash_attention_bwd"] == 36,
            f"L3 per-step counts {per_step}")
    require(counts == {k: 2 * v for k, v in per_step.items()},
            f"L3 launched {counts}, wanted 2 x {per_step}")
    return counts, row


def train_l4(torch, ops, cfg, params):
    """L4: mamba2-2.7b at full width on path E's weights (``E_DEPTH``'s
    layers): ``make_train_step(remat=True)``, 2 steps on a batch of (4,
    4096) cut into its 4 microbatches of (1, 4096), 32 SSD chunks each:
    finite losses and gradient norms, launches per microbatch held to
    the config (an ssd_scan a layer and its recomputation, an
    ssd_scan_bwd a layer, every other kernel 0),
    the peak memory printed; then a third step profiled for the SSD
    backward's share of the device's busy time; then one layer at full
    width, (1, 512) = 4 chunks, against the CPU by gradients."""
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    start = time.perf_counter()
    K = cfg.train_microbatches
    batch = _lm_train_batch(torch, cfg, K, 4096)
    opt = adamw.AdamWConfig(lr=1e-4, schedule="constant", warmup_steps=1)
    step_fn = make_train_step(cfg, opt, remat=True)
    st = adamw.init(params)
    per_mb = train_step_counts(cfg, remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    metrics, walls = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        _, st, m = step_fn(params, st, batch)
        metrics.append({k: float(v) for k, v in m.items()})
        walls.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    profiled = _ssd_bwd_share(torch, lambda: step_fn(params, st, batch))
    profile_s = time.perf_counter() - t0
    del st
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    layer = train_layer_vs_cpu(torch, cfg)
    layer_s = time.perf_counter() - t0
    row = {"phase": "L4_train", "model": cfg.name, "batch": [K, 4096],
           "microbatches": K, "remat": True, "steps": 2,
           "metrics": metrics, "launches": counts,
           "launches_per_microbatch": per_mb,
           "step_walls_ms": [w * 1e3 for w in walls],
           "tokens_per_s": K * 4096 / walls[-1],
           "peak_mem_gb": peak / 1e9,
           "params_gb": sum(t.numel() for t in tree_flatten(params)[0])
           * 4 / 1e9, "profiled_step": profiled,
           "one_layer_vs_cpu": layer, "profile_s": profile_s,
           "one_layer_s": layer_s, "path_s": time.perf_counter() - start}
    emit(row)
    require(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
                for m in metrics), f"L4 metrics {metrics}")
    n = E_DEPTH[0]
    require(per_mb == lm_counts(ssd_scan=2 * n, ssd_scan_bwd=n),
            f"L4 per-microbatch counts {per_mb}")
    require(counts == {k: 2 * K * v for k, v in per_mb.items()},
            f"L4 launched {counts}, wanted {2 * K} x {per_mb}")
    require(profiled["ssd_backward_calls"] == K * n
            and profiled["ssd_forward_calls"] == 2 * K * n,
            f"L4 profiled step: {profiled['ssd_forward_calls']} SSD "
            f"forward and {profiled['ssd_backward_calls']} backward calls, "
            f"wanted {2 * K * n} and {K * n}")
    require(peak < 80e9, f"L4 peak memory {peak / 1e9} GB")
    require(layer["ok"], f"L4 one layer against the CPU: {layer}")
    return counts, row


# ---------------------------------------- path K: the serving engine
def _k_copies(reqs):
    return [dict(r, prompt=r["prompt"].copy()) for r in reqs]


def _k_serve(torch, cfg, params, reqs, **kw):
    """A fresh ``ServingEngine`` serving ``reqs`` to the end: (engine,
    completed, wall seconds of ``run`` ended by a synchronise)."""
    from repro_torch.serve.engine import ServingEngine
    eng = ServingEngine(cfg, params, **kw)
    eng.submit(_k_copies(reqs))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    return eng, done, time.perf_counter() - t0


def _k_verdicts(eng, done):
    return {rid: ("revoked" if rec.revoked else "finalized" if rid in done
                  else "open") for rid, rec in eng.records.items()}


def _k_trust(window: int):
    from repro_torch.trust.protocol import TrustConfig
    return TrustConfig(audit_rate=1.0, num_verifiers=2,
                       challenge_window=window)


def _k_moe_layers(cfg) -> int:
    specs = list(cfg.block_pattern) * cfg.resolved_num_blocks + list(
        cfg.remainder)
    return sum(s.mlp == "moe" for s in specs)


def _k_chunk_batch(torch, cfg, B: int, C: int, prefill: bool):
    """A serve-step batch of width C in which every slot advances C
    micro-steps from position 64: a prefill chunk feeds C prompt tokens
    a slot, a decode chunk the carried greedy token."""
    g = torch.Generator().manual_seed(C)
    full = torch.full((B,), C, dtype=torch.int32)
    return {k: v.cuda() for k, v in {
        "tokens": torch.randint(0, cfg.vocab_size, (B, C), generator=g,
                                dtype=torch.int32),
        "start": torch.zeros(B, dtype=torch.int32),
        "pos": torch.full((B,), 64, dtype=torch.int32),
        "lengths": full if prefill else torch.zeros(B, dtype=torch.int32),
        "adv": full}.items()}


def _k_syncs(torch, run):
    """The synchronising calls ``run`` makes, by torch's sync debug mode
    (one warning each), with the source lines that made them.  The count
    comes from the second of two calls: the first call of a process under
    the mode records one synchronise of torch's own."""
    import warnings
    for _ in range(2):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode("default")
    hits = [w for w in seen if "synchroniz" in str(w.message)]
    where = {}
    for w in hits:
        key = f"{os.path.relpath(w.filename)}:{w.lineno}"
        where[key] = where.get(key, 0) + 1
    return len(hits), where


def serve_chunk_profile(torch, cfg, params, caches, C: int, prefill: bool,
                        expert_stats: bool = False, reps: int = 3,
                        syncs: bool = True):
    """One chunk of width C through ``make_serve_chunk_step`` on the
    engine's caches (the outputs are dropped, so no state changes): the
    synchronising calls the chunk makes before its tokens are read
    (where ``syncs``); wall (host clock around a call ended by reading
    the tokens, median of ``reps``); device busy, kernel launches and
    ``moe_gemm``'s share of busy (``torch.profiler``, device only).

    ``cache_update``: the functional cache update of forward_decode read
    from the same trace.  Each layer's K/V leaf is cloned for its row
    write (``Memcpy DtoD``), row-selected by ``_mask_rows`` (the
    ``where`` kernel) and re-stacked by ``_stack`` (``CatArrayBatchedCopy``),
    so a micro-step moves 7 x the cache's bytes (read and write, two
    reads and a write, read and write).  The three rows also hold the
    model's few small copies, ``where``s and stacks of (B, ...) tensors."""
    from repro_torch.train.step import make_serve_chunk_step
    step = make_serve_chunk_step(cfg, expert_stats=expert_stats)
    B = next(iter(caches["blocks"].values()))["k"].shape[1]
    batch = _k_chunk_batch(torch, cfg, B, C, prefill)

    def run():
        return step(params, caches, batch)[0].cpu()

    n_syncs, where = (_k_syncs(torch, lambda: step(params, caches, batch))
                      if syncs else (None, None))
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        walls.append(time.perf_counter() - t0)
    prof = profile_batch(torch, run, cpu=False)
    wall_ms = sorted(walls)[len(walls) // 2] * 1e3
    busy_ms = prof["device_busy_us"] / 1e3
    update = {}
    for us, key, n in prof["rows"]:
        for part, pat in (("clone", "Memcpy DtoD"), ("where", "where_kernel"),
                          ("stack", "CatArrayBatchedCopy")):
            if pat in key:
                one = update.setdefault(part, {"device_us": 0.0,
                                               "launches": 0})
                one["device_us"] += us
                one["launches"] += n
    cache_bytes = sum(a.numel() * a.element_size()
                      for layer in caches["blocks"].values()
                      for a in layer.values())
    return {"width": C, "kind": "prefill" if prefill else "decode",
            "slots": B, "expert_stats": expert_stats,
            "wall_ms": [w * 1e3 for w in walls],
            "busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_launches": prof["device_launches"],
            "device_launches_per_micro_step": prof["device_launches"] / C,
            "moe_gemm_cuda_launches": prof["moe_gemm"]["cuda_launches"],
            "moe_gemm_ms": prof["moe_gemm"]["device_us"] / 1e3,
            "moe_gemm_share_of_busy": prof["moe_gemm"]["device_us"] / 1e3
            / busy_ms,
            "host_syncs": n_syncs,
            "host_syncs_per_micro_step": n_syncs / C if syncs else None,
            "host_syncs_at": where, "profile": prof["top"],
            "cache_update": {
                "cache_bytes": cache_bytes,
                "bytes_per_micro_step": 7 * cache_bytes,
                "bound_ms_per_micro_step": 7 * cache_bytes
                / HBM_BYTES_PER_S * 1e3,
                "device_ms_per_micro_step": sum(
                    u["device_us"] for u in update.values()) / 1e3 / C,
                "by_kernel": update}}


def _k_tamper(torch, cfg, params, scheduling: str):
    """Three requests (a long one beside two short ones) under a window
    wide enough that nothing finalizes before all are served; the long
    stream's served tokens are then rewritten and ``audit_session``
    revokes it and its tick-overlapping open neighbours."""
    import numpy as np
    from repro_torch.serve.engine import ServingEngine
    rng = np.random.default_rng(4)
    reqs = [{"id": i, "prompt": rng.integers(0, cfg.vocab_size, 4).astype(
        np.int32), "max_new_tokens": n} for i, n in enumerate((20, 2, 2))]
    eng = ServingEngine(cfg, params, batch_slots=2, cache_len=64,
                        scheduling=scheduling, trust=_k_trust(200))
    eng.submit(_k_copies(reqs))
    while len(eng.pending_finalization) < 3 and eng.step():
        pass
    rec = eng.records[0]
    rec.tokens = [t ^ 1 for t in rec.tokens]
    rep = eng.audit_session(0)
    done = eng.run()
    return {"revoked_by_audit": rep["revoked"],
            "mismatched_leaves": len(rep["mismatches"]),
            "verdicts": _k_verdicts(eng, done),
            "dependents": [e["request"] for e in eng.session_log
                           if e["event"] == "revoke_dependent"]}


# K1's requests (two admitted mid-run into the 4 slots), and those
# served alone too (12 and 4 before path R)
K1_REQUESTS, K1_ALONE = 6, 1


def serving_k1(torch, ops, cfg, params):
    """K1: qwen2-moe-a2.7b at full width on path H's weights.  Six requests
    through a continuous-batching engine with verified sessions (4 slots, cache
    512, chunks up to 16), warmed first; the launch counts are set to 0 just
    before ``run`` and read just after, and moe_gemm must have launched 3 times
    a MoE layer for each micro-step the engine ran.  Then: the fixed policy
    gives the same streams and verdicts; the first request served
    alone in a fresh engine gives its stream; a rewritten session is revoked
    with its neighbours; one decode and one prefill chunk profiled, with the
    cache update's bytes and device time and the synchronising calls a
    micro-step makes."""
    from repro_torch.data.synthetic import serving_requests
    from repro_torch.serve.engine import ServingEngine
    start = time.perf_counter()
    n_moe = _k_moe_layers(cfg)
    reqs = list(serving_requests(cfg.vocab_size, K1_REQUESTS, max_prompt=64,
                                 max_new=16, seed=0))
    kw = dict(batch_slots=4, cache_len=512, prefill_chunk=16)
    eng = ServingEngine(cfg, params, scheduling="continuous",
                        trust=_k_trust(8), **kw)
    t0 = time.perf_counter()
    buckets = eng.warmup()
    warmup_s = time.perf_counter() - t0
    eng.submit(_k_copies(reqs))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rep = eng.obs_report()
    tokens = sum(len(v) for v in done.values())
    verdicts = _k_verdicts(eng, done)
    lat = rep["token_latency"]
    fixed, fdone, fwall = _k_serve(torch, cfg, params, reqs,
                                   scheduling="fixed", trust=_k_trust(8),
                                   **kw)
    t0 = time.perf_counter()
    alone_equal, alone_micro_steps = [], 0
    for r in reqs[:K1_ALONE]:
        one_eng, one, _ = _k_serve(torch, cfg, params, [r], **kw)
        alone_equal.append(one.get(r["id"]) == done.get(r["id"]))
        alone_micro_steps += one_eng.micro_steps
    alone_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tamper = {s: _k_tamper(torch, cfg, params, s)
              for s in ("continuous", "fixed")}
    tamper_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    decode = serve_chunk_profile(torch, cfg, params, eng.caches, 1, False)
    decode_profile_s = time.perf_counter() - t0
    prefill = serve_chunk_profile(torch, cfg, params, eng.caches, 16, True,
                                  reps=1, syncs=False)
    profile_s = time.perf_counter() - t0
    row = {"phase": "K1_serving", "model": cfg.name, "slots": 4,
           "cache_len": 512, "prefill_chunk": 16, "requests": len(reqs),
           "prompts": [len(r["prompt"]) for r in reqs],
           "max_new_tokens": [r["max_new_tokens"] for r in reqs],
           "warmup_buckets": buckets, "warmup_s": warmup_s,
           "launches": counts, "micro_steps": eng.micro_steps,
           "macro_steps": eng.steps, "ticks": eng.tick,
           "moe_layers": n_moe, "tokens": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "token_latency_p50_s": lat["p50"],
           "token_latency_p99_s": lat["p99"],
           "prefill_s": rep["prefill_s"], "decode_s": rep["decode_s"],
           "commit_s": rep["commit_s"], "audit_offpath_s":
           rep["audit_offpath_s"], "commit_appends": rep["commit_appends"],
           "verdicts": sorted(set(verdicts.values())),
           "fixed_equal": fdone == done,
           "fixed_verdicts_equal": _k_verdicts(fixed, fdone) == verdicts,
           "fixed_micro_steps": fixed.micro_steps, "fixed_wall_s": fwall,
           "alone_equal": alone_equal, "alone_s": alone_s,
           "alone_micro_steps": alone_micro_steps,
           "tamper": tamper, "tamper_s": tamper_s, "profile_s": profile_s,
           "decode_profile_s": decode_profile_s,
           "path_s": time.perf_counter() - start, "decode_chunk": decode,
           "prefill_chunk_profile": prefill}
    emit(row)
    require(buckets == 5, f"K1 warmup ran {buckets} buckets, wanted 5")
    require(len(done) == K1_REQUESTS
            and set(verdicts.values()) == {"finalized"}
            and len(verdicts) == K1_REQUESTS,
            f"K1: {len(done)} of {K1_REQUESTS} completed, verdicts "
            f"{verdicts}")
    require(all(len(done[r["id"]]) == r["max_new_tokens"] for r in reqs)
            and all(0 <= t < cfg.padded_vocab for v in done.values()
                    for t in v), "K1 streams' lengths or token range")
    require(counts == lm_counts(moe_gemm=3 * n_moe * eng.micro_steps),
            f"K1 launched {counts} over {eng.micro_steps} micro-steps")
    require(row["fixed_equal"] and row["fixed_verdicts_equal"],
            "K1: the fixed policy's streams or verdicts differ")
    require(all(alone_equal), f"K1: batched differs from alone: "
                              f"{alone_equal}")
    require(all(t["revoked_by_audit"] and t["verdicts"][0] == "revoked"
                for t in tamper.values())
            and tamper["continuous"]["verdicts"] == {
                0: "revoked", 1: "revoked", 2: "revoked"}
            and tamper["fixed"]["verdicts"][1] == "revoked",
            f"K1 tampered sessions: {tamper}")
    require(decode["moe_gemm_cuda_launches"] == 3 * n_moe
            and prefill["moe_gemm_cuda_launches"] == 3 * n_moe * 16,
            "K1 profiled chunks' moe_gemm launches")
    return counts, eng.micro_steps


def _rss_bytes() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return 0


def serving_k2(torch, ops, cfg, params):
    """K2: bmoe-paper at full width on path H's weights, with the edge
    expert runtime and KV paging on one store and one byte budget (half
    the routed expert bytes).  Its streams must equal a plain engine's
    bit for bit; its report must show every unit registered, hits,
    misses and fetched bytes."""
    from repro_torch.data.synthetic import serving_requests
    from repro_torch.serve.engine import EdgeStorageConfig, ServingEngine
    from repro_torch.storage.kv import KVStorageConfig
    start = time.perf_counter()
    n_moe = _k_moe_layers(cfg)
    reqs = list(serving_requests(cfg.vocab_size, 4, max_prompt=32,
                                 max_new=6, seed=1))
    kw = dict(batch_slots=4, cache_len=128, prefill_chunk=16)
    plain, pdone, pwall = _k_serve(torch, cfg, params, reqs, **kw)
    unit_bytes = 3 * cfg.d_model * cfg.moe_d_ff * 4
    routed = n_moe * cfg.num_experts * unit_bytes
    chunk_bytes = 1 << 22
    gc.collect()
    rss0 = _rss_bytes()
    t0 = time.perf_counter()
    eng = ServingEngine(cfg, params, expert_storage=EdgeStorageConfig(
        cache_bytes=routed // 2, chunk_bytes=chunk_bytes, prefetch_topk=4),
        kv_storage=KVStorageConfig(block_tokens=16), **kw)
    register_s = time.perf_counter() - t0
    rss1 = _rss_bytes()
    eng.submit(_k_copies(reqs))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    rep = eng.obs_report()
    edge, kv = rep["edge"], rep["kv"]
    decode = serve_chunk_profile(torch, cfg, params, eng.caches, 1, False,
                                 expert_stats=True)
    import hashlib
    block = bytes(1 << 26)
    t0 = time.perf_counter()
    hashlib.sha256(block).hexdigest()
    sha_gb_s = len(block) / (time.perf_counter() - t0) / 1e9
    row = {"phase": "K2_edge_storage", "model": cfg.name, "slots": 4,
           "requests": len(reqs), "launches": counts,
           "micro_steps": eng.micro_steps, "macro_steps": eng.steps,
           "units": edge["units"], "unit_bytes": unit_bytes,
           "routed_bytes": routed, "cache_bytes": routed // 2,
           "chunk_bytes": chunk_bytes, "register_s": register_s,
           "register_host_bytes": rss1 - rss0,
           "store_bytes": eng.edge.store.total_bytes(),
           "cache": edge["cache"], "store": edge["store"],
           "kv": {k: kv[k] for k in ("sealed_blocks", "sealed_tokens",
                                     "sealed_bytes", "dedup_blocks")},
           "wall_s": wall, "plain_wall_s": pwall,
           "tokens_per_s": sum(len(v) for v in done.values()) / wall,
           "equal_plain": done == pdone, "host_sha256_gb_per_s": sha_gb_s,
           "decode_chunk_with_expert_counts": decode,
           "path_s": time.perf_counter() - start}
    emit(row)
    require(done == pdone and len(done) == len(reqs),
            "K2: the storage engine's streams differ from the plain one's")
    require(edge["units"] == n_moe * cfg.num_experts
            and edge["cache"]["misses"] > 0 and edge["cache"]["hits"] > 0
            and edge["cache"]["fetched_bytes"] > 0
            and edge["cache"]["evictions"] > 0 and kv["sealed_blocks"] > 0,
            f"K2 report: {edge}, {kv}")
    require(counts == lm_counts(moe_gemm=3 * n_moe * eng.micro_steps)
            and decode["moe_gemm_cuda_launches"] == 3 * n_moe,
            f"K2 launched {counts} over {eng.micro_steps} micro-steps")
    return counts, eng.micro_steps


def serving_k3(torch, ops, cfg, params):
    """K3: qwen2.5-3b at full width on path C's weights with KV paging in
    16-token blocks and DA challenges over the sealed chunks.  Two
    disjoint prompts, verified, paging on against off: the same streams,
    token tick roots and verdicts, and no DA slash.  A third request with
    the first one's prompt restores its sealed prefix blocks and decodes
    the stream the paging-off engine computes cold.  A fourth, paged out
    mid-decode and readmitted, resumes its never-paged stream."""
    import numpy as np
    from repro_torch.serve.engine import ServingEngine
    from repro_torch.storage.kv import KVStorageConfig
    start = time.perf_counter()
    rng = np.random.default_rng(7)

    def request(rid, plen, new):
        return {"id": rid, "prompt": rng.integers(
            0, cfg.vocab_size, plen).astype(np.int32), "max_new_tokens": new}

    a, c = request(0, 70, 8), request(1, 50, 8)
    b = dict(a, id=2)                   # the first request's prompt again
    kw = dict(batch_slots=2, cache_len=256, prefill_chunk=16)
    kvc = KVStorageConfig(block_tokens=16, da_rate=0.5)
    engines, ticks = {}, []
    for name, kv in (("on", kvc), ("off", None)):
        eng = ServingEngine(cfg, params, trust=_k_trust(4), kv_storage=kv,
                            **kw)
        eng.submit(_k_copies([a, c]))
        first = eng.run()
        # the token tick roots of the disjoint prompts
        ticks.append([(t.tick, t.root, t.request_ids)
                      for t in eng.tick_commitments])
        eng.submit(_k_copies([b]))
        engines[name] = (eng, first, eng.run())
    on, first_on, all_on = engines["on"]
    off, first_off, all_off = engines["off"]
    kv = on.obs_report()["kv"]
    d = request(3, 20, 24)
    ref_eng, ref, _ = _k_serve(torch, cfg, params, [d], **kw)
    paged = ServingEngine(cfg, params, kv_storage=KVStorageConfig(
        block_tokens=16), **kw)
    paged.submit(_k_copies([d]))
    while not paged.slots[0].decoding or len(paged.slots[0].generated) < 4:
        paged.step()
    paged.page_out(0)
    resumed = paged.run()
    pkv = paged.obs_report()["kv"]
    row = {"phase": "K3_kv_paging", "model": cfg.name,
           "block_tokens": 16, "prompts": [len(a["prompt"]),
                                           len(c["prompt"])],
           "streams_equal": first_on == first_off,
           "tick_roots_equal": ticks[0] == ticks[1],
           "commit_appends": len(ticks[0]),
           "kv_roots": sum(bool(t.kv_root) for t in on.tick_commitments),
           "verdicts_on": _k_verdicts(on, all_on),
           "verdicts_off": _k_verdicts(off, all_off),
           "warm_equal_cold": all_on.get(2) == all_off.get(2),
           "kv": {k: v for k, v in kv.items() if k not in ("cache",
                                                           "store")},
           "block_bytes": kv["sealed_bytes"] / max(kv["sealed_blocks"], 1),
           "page_out": {k: pkv[k] for k in ("pageouts", "resumes",
                                            "restored_tokens")},
           "resumed_equal": resumed == ref,
           "path_s": time.perf_counter() - start}
    emit(row)
    require(row["streams_equal"] and row["tick_roots_equal"]
            and row["kv_roots"] > 0, f"K3 paging on against off: {row}")
    require(set(row["verdicts_on"].values()) == {"finalized"}
            and row["verdicts_on"] == row["verdicts_off"],
            f"K3 verdicts {row['verdicts_on']}, {row['verdicts_off']}")
    require(kv["restored_tokens"] >= 64 and row["warm_equal_cold"],
            f"K3 warm prefix: {kv}")
    require(kv["da"]["probed"] > 0 and kv["da"]["slashed"] == 0
            and kv["da"]["opened"] == 0, f"K3 DA: {kv['da']}")
    require(row["resumed_equal"] and pkv["pageouts"] == 1
            and pkv["resumes"] == 1, f"K3 page-out: {row['page_out']}")
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
    require(counts == lm_counts(moe_gemm=4, redundancy_vote=2),
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
    prof = profile_batch(torch, lambda: sys_b.infer(x1, commit=False))
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
    require(counts_t == lm_counts(moe_gemm=2),
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


# ------------------------------------------------ optimistic main path
def _audit_launches_expected(sys_o):
    """audit_mlp launches the run's own records call for: one commitment
    build per committed round, plus every grouped drain call and every
    eager S=1 recompute the system's closures counted."""
    calls = sys_o.obs.metrics.snapshot("bmoe.audit_calls")
    return (sys_o._infer_protocol.stats["committed"]
            + int(sum(calls.values()))), calls


def _never_challenged(state) -> bool:
    # CHALLENGED books proofs and a court verdict; an honest round that
    # was never challenged has neither
    return not state.proofs and state.verdict is None


def optimistic_path_a(torch, np, ops, xs, clean_logits):
    """An executor that always cheats (edge 0) over 6 batches of 1000,
    then flush: round 0 convicted, slashed and rolled back; rounds 1-5
    finalized."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    from repro_torch.core.reputation import ReputationConfig

    atk = AttackConfig(malicious_edges=(0,), attack_prob=1.0, noise_std=5.0)
    # the reputation settings of the reference's own inference-pipeline
    # test: one conviction crosses the exclusion threshold
    sys_o = BMoESystem(BMoEConfig(
        framework="optimistic", attack=atk,
        reputation=ReputationConfig(init=0.5, gain=0.01, slash=0.4,
                                    exclusion_threshold=0.2)),
        device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    served = [sys_o.infer(x)[0] for x in xs]
    out = sys_o.flush_trust()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    p = sys_o._infer_protocol
    want_audit, calls = _audit_launches_expected(sys_o)
    phases = [p.rounds[r].phase.value for r in sorted(p.rounds)]
    events = [(e.round_id, e.edge) for e in p.stakes.events]
    rollbacks = sys_o.ledger.rollbacks()
    honest_ok = all(_never_challenged(p.rounds[r]) for r in range(1, 6))
    emit({"phase": "optimistic_path_a", "batches": len(xs), "batch": 1000,
          "launches": counts, "audit_calls": calls,
          "protocol": dict(p.stats), "verifiers": dict(p.verifiers.stats),
          "phases": phases, "executors": [p.rounds[r].executor
                                          for r in sorted(p.rounds)],
          "stake_events": events,
          "excluded": sys_o.reputation.excluded.tolist(),
          "rollback_payloads": [b.payload for b in rollbacks],
          "flush": out, "wall_s": wall_s,
          "honest_round1_bitwise_bmoe_clean": bool(
              np.array_equal(served[1], clean_logits)),
          "served_finite": all(bool(np.isfinite(v).all()) for v in served)})
    require(phases == ["rolled_back"] + ["finalized"] * 5,
            f"path A phases {phases}")
    require(p.rounds[0].executor == 0, "round 0's executor is not edge 0")
    require(events == [(0, 0)], f"path A stake events {events}")
    require(bool(sys_o.reputation.excluded[0]), "edge 0 not excluded")
    require(len(rollbacks) == 1
            and rollbacks[0].payload["domain"] == "infer"
            and rollbacks[0].payload["rollback_of"] == 0,
            "path A: not one infer rollback block for round 0")
    require(honest_ok, "an honest round was challenged")
    require(counts["audit_mlp"] == want_audit,
            f"audit_mlp launched {counts['audit_mlp']}, the run's records "
            f"call for {want_audit} ({calls}, {dict(p.stats)})")
    require(counts["redundancy_vote"] == p.stats["escalations"] == 1,
            f"vote launched {counts['redundancy_vote']}, escalations "
            f"{p.stats['escalations']}")
    require(counts["moe_gemm"] == 2 * len(xs),
            f"moe_gemm launched {counts['moe_gemm']}")
    require(all(v.shape == (1000, 10) and np.isfinite(v).all()
                for v in served), "served logits shape / finite")
    # round 1's executor is honest: what it served is the bmoe framework's
    # clean consensus on the same batch and seeded weights, bit for bit
    require(np.array_equal(served[1], clean_logits),
            "honest optimistic round differs from the clean bmoe logits")
    require(not np.allclose(served[0], clean_logits),
            "the cheating executor's round served clean logits")
    return counts


def optimistic_path_b(torch, ops, xs):
    """No attack, every verifier attestation re-audited: the eager S=1
    recompute must hash every honest leaf as the merged drains did, so
    no verifier is slashed and no round challenged."""
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    from repro_torch.trust.protocol import TrustConfig

    sys_o = BMoESystem(BMoEConfig(framework="optimistic",
                                  trust=TrustConfig(reaudit_rate=1.0)),
                       device="cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for x in xs:
        sys_o.infer(x)
    sys_o.flush_trust()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    p = sys_o._infer_protocol
    want_audit, calls = _audit_launches_expected(sys_o)
    emit({"phase": "optimistic_path_b", "batches": len(xs),
          "launches": counts, "audit_calls": calls,
          "protocol": dict(p.stats), "verifiers": dict(p.verifiers.stats),
          "lazy_slashes": len(p.verifiers.lazy_slashes),
          "phases": [p.rounds[r].phase.value for r in sorted(p.rounds)]})
    require(p.verifiers.lazy_slashes == [],
            f"honest verifiers slashed: {p.verifiers.lazy_slashes}")
    require(all(_never_challenged(st) for st in p.rounds.values()),
            "a round was challenged without an attack")
    require(calls.get("bmoe.audit_calls{kind=eager}", 0) >= 1,
            "no eager S=1 recompute ran")
    require(counts["audit_mlp"] == want_audit,
            f"path B audit_mlp launched {counts['audit_mlp']}, records "
            f"call for {want_audit}")
    return counts


def optimistic_batch_time(torch, xs):
    """Warm host-clock wall of ``infer(commit=True)`` on a batch of 1000,
    5 samples (drains land on the batches whose window closes), and the
    device's busy time over one more batch."""
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    sys_o = BMoESystem(BMoEConfig(framework="optimistic"), device="cuda")
    sys_o.infer(xs[0])                      # first batch: cold cache
    walls, drained = [], []
    for i in range(5):
        n0 = sys_o._infer_protocol.stats["audit_drains"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sys_o.infer(xs[1 + i])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        drained.append(sys_o._infer_protocol.stats["audit_drains"] > n0)
    prof = profile_batch(torch, lambda: sys_o.infer(xs[0]))
    wall_ms = sorted(walls)[len(walls) // 2] * 1e3
    emit({"phase": "optimistic_batch_time", "framework": "optimistic",
          "batch": 1000, "wall_ms": [w * 1e3 for w in walls],
          "drained": drained,
          "device_busy_ms": prof["device_busy_us"] / 1e3,
          "device_idle_share": 1.0 - prof["device_busy_us"] / 1e3 / wall_ms,
          "profile": prof["top"]})


# ------------------------------------------ path F: B-MoE training
def _want_round(framework):
    """Launches of one training round: the forward's two moe_gemm, the
    backward's three (dw2, dh, dw1; no dbuf), and under bmoe one vote."""
    return lm_counts(moe_gemm=5, redundancy_vote=int(framework == "bmoe"))


def train_rounds(ops, sys_, xtr, ytr, rng, rounds: int, batch: int = 1000):
    """``rounds`` train_round calls on tasks of ``batch`` rows drawn by
    ``rng``; the launches of each round and the losses."""
    per_round, losses = [], []
    for _ in range(rounds):
        idx = rng.integers(0, len(xtr), batch)
        c0 = ops.launch_counts()
        m = sys_.train_round(xtr[idx], ytr[idx])
        c1 = ops.launch_counts()
        per_round.append({k: c1[k] - c0[k] for k in c1})
        losses.append(float(m["loss"]))
    return per_round, losses


def profile_round(torch, run):
    """Device time of one warm call of ``run`` (a training round), from
    torch.profiler: busy time, and the moe_gemm and vote launches in the
    order they ran (the forward's two, the backward's three)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        prof.step()
        run()
        torch.cuda.synchronize()
        prof.step()
    kernels = sorted(
        (ev.time_range.start, ev.time_range.elapsed_us(), ev.name)
        for ev in prof.events()
        if ev.device_type == DeviceType.CUDA
        and not ev.name.startswith("ProfilerStep"))
    busy = sum(k[1] for k in kernels)
    mine = [(us, "moe_gemm" if "moe_gemm_kernel" in name else "vote")
            for _, us, name in kernels
            if "moe_gemm_kernel" in name or "vote_kernel" in name]
    return busy, mine, kernels


def train_claims(torch, np, ops, xtr, ytr, xte, yte):
    """The paper's training claims at full width on the port's own init:
    traditional and bmoe each trained 30 clean rounds on tasks of 1000,
    then evaluated under 3 of 10 colluding edges (probability 1, sigma
    5).  Each framework's launch counts are set to 0 before its rounds
    and read after them and after every round."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    strong = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                          noise_std=5.0)
    out = {}
    for framework in ("traditional", "bmoe"):
        sys_ = BMoESystem(BMoEConfig(framework=framework), device="cuda")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        per_round, losses = train_rounds(ops, sys_, xtr, ytr,
                                         np.random.default_rng(0), 30)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        acc_attacked = sys_.evaluate(xte, yte, attack=strong)
        acc_clean = sys_.evaluate(xte, yte, attack=AttackConfig())
        want = _want_round(framework)
        row = {"phase": "train_claims", "framework": framework,
               "rounds": 30, "task": 1000, "launches": counts,
               "launches_per_round_all_equal": all(c == want
                                                   for c in per_round),
               "launches_per_round": per_round[0], "loss_first": losses[0],
               "loss_last": losses[-1], "train_s": train_s,
               "accuracy_clean": acc_clean,
               "accuracy_3of10_colluding": acc_attacked,
               "blocks": len(sys_.ledger.blocks),
               "chain_verifies": sys_.ledger.verify_chain()}
        emit(row)
        require(all(np.isfinite(losses)), f"{framework}: loss {losses}")
        require(all(c == want for c in per_round),
                f"{framework} rounds launched {per_round}, wanted {want}")
        require(counts == {k: 30 * v for k, v in want.items()},
                f"{framework} 30 rounds launched {counts}")
        require(len(sys_.ledger.blocks) ==
                (31 if framework == "bmoe" else 1) and
                sys_.ledger.verify_chain(), f"{framework} ledger")
        out[framework] = (sys_, row)
    acc_t = out["traditional"][1]["accuracy_3of10_colluding"]
    acc_b = out["bmoe"][1]["accuracy_3of10_colluding"]
    acc_c = out["bmoe"][1]["accuracy_clean"]
    require(acc_b > acc_t + 0.1, f"bmoe {acc_b} not above traditional "
                                 f"{acc_t} + 0.1 under attack")
    require(abs(acc_b - acc_c) < 0.02, f"bmoe under attack {acc_b}, clean "
                                       f"{acc_c}")
    return out


def train_poisoning(torch, np, xtr, ytr):
    """3 rounds with 3 of 10 edges colluding to upload poisoned experts:
    every block accepts the honest digest with support 7."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    atk = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                       noise_std=5.0, poison_params=True)
    sys_ = BMoESystem(BMoEConfig(framework="bmoe", attack=atk),
                      device="cuda")
    rng = np.random.default_rng(2)
    for _ in range(3):
        idx = rng.integers(0, len(xtr), 1000)
        sys_.train_round(xtr[idx], ytr[idx])
    blocks = [b.payload for b in sys_.ledger.blocks[1:]]
    emit({"phase": "train_poisoning", "rounds": 3,
          "expert_hash_support": [b["expert_hash_support"] for b in blocks],
          "accepted": [b["expert_hash_accepted"] for b in blocks],
          "chain_misled": [bool(b.get("chain_misled")) for b in blocks],
          "trusted_supports": [b["trusted_supports"] for b in blocks]})
    require(len(blocks) == 3 and all(
        b["expert_hash_accepted"] and b["expert_hash_support"] == 7
        and "chain_misled" not in b for b in blocks),
        f"poisoning: {blocks}")


def train_repeatability(torch, np, xtr, ytr):
    """Two systems from seed 0 after 3 rounds under 3 colluding edges hold
    the same bits; so do edge cache on and off.  Plain torch (no
    deterministic-algorithms switch): the path itself must be
    repeatable."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    atk = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                       noise_std=5.0)
    runs = []
    for cache in ("on", "on", "off"):
        sys_ = BMoESystem(BMoEConfig(framework="bmoe", attack=atk,
                                     edge_cache=cache), device="cuda")
        rng = np.random.default_rng(3)
        for _ in range(3):
            idx = rng.integers(0, len(xtr), 1000)
            sys_.train_round(xtr[idx], ytr[idx])
        runs.append({**sys_.experts,
                     **{"gate_" + k: v for k, v in sys_.gate.items()}})
    torch.cuda.synchronize()
    same = [all(_bitwise_equal(torch, runs[0][k], other[k])
                for k in runs[0]) for other in runs[1:]]
    emit({"phase": "train_repeatability", "rounds": 3,
          "seed0_twice_bitwise": same[0], "cache_on_off_bitwise": same[1]})
    require(all(same), f"training bits depend on the run: {same}")


def train_cpu_vs_card(torch, np, ops, xtr, ytr):
    """One full-width bmoe round under 3 colluding edges on the card and
    the same round on the CPU (same seeded init and attack draw):
    autograd's gradients of the round's loss at rtol 1e-4 / atol 1e-6,
    the parameters after the round at 1e-5, support, flags and activation
    equal."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem, _loss_and_grads
    atk = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                       noise_std=5.0)
    idx = np.random.default_rng(4).integers(0, len(xtr), 1000)
    x, y = xtr[idx], ytr[idx]
    res = {}
    for dev in ("cpu", "cuda"):
        sys_ = BMoESystem(BMoEConfig(framework="bmoe", attack=atk),
                          device=dev)
        mask_e, noise = sys_._draw_attack(atk, len(x), sys_.round)
        gate_bias, active = sys_._controls()
        g_gate, g_exp, _ = _loss_and_grads(
            sys_.gate, sys_.experts, torch.from_numpy(x).to(dev),
            torch.from_numpy(y).to(dev), mask_e.to(dev), noise.to(dev),
            atk.noise_std, gate_bias, active, cfg=sys_.cfg)
        m = sys_.train_round(x, y)
        res[dev] = (m, {k: v.cpu() for k, v in {
            **g_exp, **{"gate_" + k: v for k, v in g_gate.items()}}.items()},
            {k: v.cpu() for k, v in {
                **sys_.experts,
                **{"gate_" + k: v for k, v in sys_.gate.items()}}.items()})
    (mc, gc, pc), (mg, gg, pg) = res["cpu"], res["cuda"]
    errs = {k: float((gg[k] - gc[k]).abs().max()) for k in gc}
    close = {k: bool(torch.allclose(gg[k], gc[k], rtol=1e-4, atol=1e-6))
             for k in gc}
    params = {k: bool(torch.allclose(pg[k], pc[k], rtol=1e-5, atol=1e-5))
              for k in pc}
    equal = {k: bool(np.array_equal(mg[k], mc[k]))
             for k in ("activation", "support", "flags", "dropped")}
    emit({"phase": "train_cpu_vs_card", "framework": "bmoe", "task": 1000,
          "grad_max_abs_err": errs, "grad_close": close,
          "params_close": params, "equal": equal,
          "loss": [float(mc["loss"]), float(mg["loss"])],
          "support": mg["support"].tolist()})
    require(all(close.values()) and all(params.values())
            and all(equal.values()),
            f"training round on the card differs from the CPU: {close} "
            f"{params} {equal}")


def train_profile(torch, np, sys_, xtr, ytr, framework, moe_gemm: int = 5,
                  votes: Optional[int] = None):
    """Median host wall of 5 warm rounds, then one more round profiled:
    device busy, idle share, and the device time of the forward's
    moe_gemm launches, the backward's and the vote.  The profiled round
    must hold ``moe_gemm`` moe_gemm launches and ``votes`` votes (by
    default one under bmoe)."""
    rng = np.random.default_rng(5)
    walls = []
    for _ in range(5):
        idx = rng.integers(0, len(xtr), 1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sys_.train_round(xtr[idx], ytr[idx])
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    idx = rng.integers(0, len(xtr), 1000)
    busy, mine, kernels = profile_round(
        torch, lambda: sys_.train_round(xtr[idx], ytr[idx]))
    gemm = [us for us, kind in mine if kind == "moe_gemm"]
    vote = [us for us, kind in mine if kind == "vote"]
    wall_ms = sorted(walls)[2] * 1e3
    top = {}
    for _, us, name in kernels:
        top[name[:70]] = top.get(name[:70], 0.0) + us
    row = {"phase": "train_profile", "framework": framework, "task": 1000,
           "wall_ms": [w * 1e3 for w in walls], "median_wall_ms": wall_ms,
           "device_busy_ms": busy / 1e3,
           "device_idle_share": 1.0 - busy / 1e3 / wall_ms,
           "moe_gemm_forward_us": gemm[:2], "moe_gemm_backward_us": gemm[2:],
           "vote_us": vote, "cuda_kernels": len(kernels),
           "top": sorted(({"name": k, "device_us": v} for k, v in
                          top.items()), key=lambda r: -r["device_us"])[:8]}
    emit(row)
    if votes is None:
        votes = int(framework == "bmoe")
    require(len(gemm) == moe_gemm and len(vote) == votes,
            f"profiled {framework} round: {len(gemm)} moe_gemm, "
            f"{len(vote)} vote launches")
    return row


def training_path(torch, np, ops):
    """Path F: B-MoE training at the paper's full width on the card."""
    from repro_torch.data.synthetic import FMNIST, make_image_dataset
    xtr, ytr, xte, yte = make_image_dataset(FMNIST, n_train=10000,
                                            n_test=2000, seed=0)
    xtr, xte = xtr.reshape(len(xtr), -1), xte.reshape(len(xte), -1)
    trained = train_claims(torch, np, ops, xtr, ytr, xte, yte)
    train_poisoning(torch, np, xtr, ytr)
    train_repeatability(torch, np, xtr, ytr)
    train_cpu_vs_card(torch, np, ops, xtr, ytr)
    profiles = {fw: train_profile(torch, np, trained[fw][0], xtr, ytr, fw)
                for fw in ("traditional", "bmoe")}
    return {fw: trained[fw][1] for fw in trained}, profiles


# ------------------------- path G: optimistic training, DA, CNN experts
REP_G = dict(init=0.5, gain=0.01, slash=0.4, exclusion_threshold=0.2)


def _optimistic_trainer(attack, trust, device="cuda", **kw):
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    from repro_torch.core.reputation import ReputationConfig
    return BMoESystem(BMoEConfig(framework="optimistic", attack=attack,
                                 reputation=ReputationConfig(**REP_G),
                                 trust=trust, **kw), device=device)


def _train_launches_expected(sys_, rounds: int):
    """Launches an optimistic training run's own records call for: 5
    moe_gemm per training round and per replayed round; one audit_mlp per
    committed round plus every recompute call the closures counted; one
    vote per court escalation."""
    p, m = sys_.protocol, sys_.obs.metrics
    calls = m.snapshot("bmoe.audit_calls")
    replayed = int(m.value("bmoe.replayed_rounds"))
    return (lm_counts(moe_gemm=5 * (rounds + replayed),
                      redundancy_vote=p.stats["escalations"],
                      audit_mlp=p.stats["committed"]
                      + int(sum(calls.values()))),
            calls, replayed)


def _counted_rounds(ops, sys_, tasks, xtr, ytr, acc, after=None):
    """``train_round`` on each task, adding each round's launches to
    ``acc``; ``after(r)`` runs between rounds, uncounted."""
    for r, idx in enumerate(tasks):
        c0 = ops.launch_counts()
        sys_.train_round(xtr[idx], ytr[idx])
        c1 = ops.launch_counts()
        for k in c1:
            acc[k] = acc.get(k, 0) + c1[k] - c0[k]
        if after is not None:
            after(r)
    return acc


def optimistic_training_g1(torch, np, ops, xtr, ytr, xte, yte):
    """G1: edges 7, 8, 9 cheat whenever they execute (probability 1,
    sigma 5), audit_rate 0.2, window 2: within 20 rounds of 1000 all
    three are slashed and excluded and no honest edge is, one rollback
    per stake event, and after 12 rounds the accuracy is within 0.02 of
    a clean twin's (tests/test_trust.py:262, :310)."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.trust.protocol import TrustConfig
    atk = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                       noise_std=5.0)
    trust = TrustConfig(audit_rate=0.2, challenge_window=2)
    sys_a = _optimistic_trainer(atk, trust)
    clean = _optimistic_trainer(AttackConfig(), trust)
    rng = np.random.default_rng(0)
    tasks = [rng.integers(0, len(xtr), 1000) for _ in range(20)]
    # the clean twin's first 12 rounds, evaluated (uncounted)
    _counted_rounds(ops, clean, tasks[:12], xtr, ytr, {})
    acc_c = clean.evaluate(xte, yte, attack=AttackConfig())
    evals = {}

    def after(r):
        if r == 11:          # the attacked run at 12 rounds (uncounted)
            evals["acc"] = sys_a.evaluate(xte, yte, attack=AttackConfig())

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    acc = {}
    t0 = time.perf_counter()
    _counted_rounds(ops, sys_a, tasks, xtr, ytr, acc, after)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    acc_a = evals["acc"]
    p = sys_a.protocol
    slashed = sorted({ev.edge for ev in p.stakes.events})
    excluded = sys_a.reputation.excluded.tolist()
    want, calls, replayed = _train_launches_expected(sys_a, 20)
    last = max(ev.round_id for ev in p.stakes.events) if p.stakes.events \
        else None
    row = {"phase": "optimistic_training", "path": "G1", "rounds": 20,
           "task": 1000, "launches": acc, "launches_expected": want,
           "audit_calls": calls, "replayed_rounds": replayed,
           "protocol": dict(p.stats), "verifiers": dict(p.verifiers.stats),
           "executors": [p.rounds[r].executor for r in sorted(p.rounds)],
           "phases": [p.rounds[r].phase.value for r in sorted(p.rounds)],
           "stake_events": [(e.round_id, e.edge) for e in p.stakes.events],
           "slashed": slashed, "excluded": excluded,
           "rollback_chains": [b.payload["chain"]
                               for b in sys_a.ledger.rollbacks()],
           "accuracy_after_12": acc_a, "clean_twin_accuracy_after_12": acc_c,
           "train_s_with_one_evaluate": train_s,
           "verification": sys_a.verification_report(),
           "chain_verifies": sys_a.ledger.verify_chain()}
    emit(row)
    require(slashed == [7, 8, 9], f"G1 slashed {slashed}")
    require(all(excluded[7:]) and not any(excluded[:7]),
            f"G1 excluded {excluded}")
    require(p.stats["rolled_back"] == len(p.stakes.events),
            f"G1 rolled back {p.stats['rolled_back']}, stake events "
            f"{len(p.stakes.events)}")
    require(last is not None and last < 16, f"G1 last slash at {last}")
    require(abs(acc_a - acc_c) < 0.02, f"G1 accuracy {acc_a} against the "
                                       f"clean twin's {acc_c}")
    require(acc == want, f"G1 launched {acc}, the run's records call for "
                         f"{want}")
    require(all(acc[k] > 0 for k in ("moe_gemm", "audit_mlp",
                                     "redundancy_vote")),
            f"G1 left a kernel of its path unlaunched: {acc}")
    require(sys_a.ledger.verify_chain(), "G1 ledger")
    return acc, clean, tasks


def optimistic_training_g2(torch, np, xtr, ytr):
    """G2 (tests/test_pipeline.py:38, :117, :148 at full width): edge 2's
    fraud, window 3, is convicted after round 3 committed on it and the
    chain [2, 3] is replayed to the clean twin's bits; pipelined equals
    synchronous and batched equals eager by digest."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.ledger import digest_tree
    from repro_torch.trust.protocol import RoundPhase, TrustConfig
    rng = np.random.default_rng(1)
    tasks = [rng.integers(0, len(xtr), 1000) for _ in range(8)]

    def run(atk, trust, rounds, flush=True):
        s = _optimistic_trainer(atk, trust)
        for idx in tasks[:rounds]:
            s.train_round(xtr[idx], ytr[idx])
        if flush:
            s.flush_trust()
        return s

    t0 = time.perf_counter()
    late = TrustConfig(audit_rate=1.0, num_verifiers=1, challenge_window=3)
    s = run(AttackConfig(malicious_edges=(2,), attack_prob=1.0,
                         noise_std=5.0), late, 4, flush=False)
    twin = run(AttackConfig(), late, 4, flush=False)
    chain = [b.payload["chain"] for b in s.ledger.rollbacks()]
    chain_ok = (digest_tree(s.experts) == digest_tree(twin.experts)
                and digest_tree(s.gate) == digest_tree(twin.gate))
    one = AttackConfig(malicious_edges=(3,), attack_prob=1.0, noise_std=5.0)
    pq = [run(one, TrustConfig(audit_rate=0.5, challenge_window=2,
                               scheduling=sched), 6)
          for sched in ("pipelined", "synchronous")]
    three = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                         noise_std=5.0)
    ab = [run(three, TrustConfig(audit_rate=0.3, challenge_window=2,
                                 audit_backend=backend), 8)
          for backend in ("batched", "eager")]
    torch.cuda.synchronize()

    def same(a, b):
        return (digest_tree(a.experts) == digest_tree(b.experts)
                and digest_tree(a.gate) == digest_tree(b.gate))

    row = {"phase": "optimistic_training", "path": "G2", "task": 1000,
           "late_fraud_chain": chain,
           "late_fraud_phases": [s.protocol.rounds[r].phase.value
                                 for r in range(4)],
           "late_fraud_stake_events": [(e.round_id, e.edge)
                                       for e in s.protocol.stakes.events],
           "replay_bitwise_clean_twin": chain_ok,
           "pipelined_vs_synchronous_bitwise": same(*pq),
           "invalidated": [x.protocol.stats["invalidated"] for x in pq],
           "batched_vs_eager_bitwise": same(*ab),
           "rolled_back": [x.protocol.stats["rolled_back"] for x in ab],
           "eager_calls": ab[1].obs.metrics.snapshot("bmoe.audit_calls"),
           "honest_rounds_challenged": sum(
               1 for x in (twin,) for st in x.protocol.rounds.values()
               if st.proofs or st.verdict is not None),
           "wall_s": time.perf_counter() - t0}
    emit(row)
    require(chain == [[2, 3]], f"G2 rollback chains {chain}")
    require(s.protocol.rounds[3].phase is RoundPhase.INVALIDATED,
            "G2 round 3 not invalidated")
    require([(e.round_id, e.edge) for e in s.protocol.stakes.events]
            == [(2, 2)], "G2 stake events")
    require(chain_ok, "G2 replayed chain differs from the clean twin")
    require(row["honest_rounds_challenged"] == 0,
            "G2 an honest round was challenged")
    require(row["pipelined_vs_synchronous_bitwise"],
            "G2 pipelined and synchronous differ")
    require(pq[0].protocol.stats["invalidated"] > 0
            and pq[1].protocol.stats["invalidated"] == 0,
            f"G2 invalidated {row['invalidated']}")
    require(row["batched_vs_eager_bitwise"], "G2 batched and eager differ")
    require(min(row["rolled_back"]) >= 1, "G2 no rollback under 3 cheats")


def optimistic_training_g3(torch, np, xtr, ytr):
    """G3 (tests/test_storage_faults.py:114 at full width): a replica node
    withholds a committed genesis chunk; the training rounds' DA beats
    challenge it and exactly one da_slash block names the node."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.trust.protocol import TrustConfig
    s = _optimistic_trainer(AttackConfig(), TrustConfig(
        audit_rate=0.1, challenge_window=2), da_rate=1.0)
    cid = s.expert_store.manifest("expert/0", 0).chunk_cids[0]
    node = s.storage.replicas(cid)[0]
    s.storage.withhold(cid, node)
    rng = np.random.default_rng(2)
    t0 = time.perf_counter()
    for _ in range(4):
        idx = rng.integers(0, len(xtr), 1000)
        s.train_round(xtr[idx], ytr[idx])
    s.flush_trust()
    blocks = s.ledger.find_all(kind="da_slash")
    row = {"phase": "optimistic_training", "path": "G3", "rounds": 4,
           "withheld_node": node, "da": dict(s.da.stats),
           "faults": [(f.round_id, f.object_id, f.chunk_index, f.executor,
                       f.kind) for f in s.da.faults],
           "da_slash_blocks": [b.payload for b in blocks],
           "node_stake": float(s.da.stakes.stake[node]),
           "chain_verifies": s.ledger.verify_chain(),
           "wall_s": time.perf_counter() - t0}
    emit(row)
    require(len(blocks) == 1 and blocks[0].payload["node"] == node
            and blocks[0].payload["fault"] == "withheld",
            f"G3 da_slash blocks {row['da_slash_blocks']}")
    require(s.da.stakes.stake[node] < s.da.stakes.initial,
            "G3 withholding node not slashed")
    require(s.ledger.verify_chain(), "G3 ledger")


def _cnn_round_grads(torch, sys_, x, y, dev):
    from repro_torch.core.bmoe import _loss_and_grads
    atk = sys_.cfg.attack
    mask_e, noise = sys_._draw_attack(atk, len(x), sys_.round)
    gate_bias, active = sys_._controls()
    g_gate, g_exp, m = _loss_and_grads(
        sys_.gate, sys_.experts, torch.from_numpy(x).to(dev),
        torch.from_numpy(y).to(dev), mask_e.to(dev), noise.to(dev),
        atk.noise_std, gate_bias, active, cfg=sys_.cfg)
    return ({k: v.cpu() for k, v in
             {**g_exp, **{"gate_" + k: v for k, v in g_gate.items()}}.items()},
            {k: v.cpu() for k, v in m.items()})


def cnn_path_g4(torch, np, ops, rv, ref):
    """G4: the paper's CIFAR-10 setting (N=10, M=10, K=3, CNN experts,
    lr 0.1, tasks of 1000) under bmoe and traditional, 3 rounds each,
    3 of 10 edges colluding: one vote a bmoe round and no moe_gemm;
    a second run bitwise equal; round 0's gradients on the card at rtol
    1e-4 of the CPU's; and one dense-dispatch bmoe round, whose vote over
    (10, 10, 10000) copies is held bitwise against its plain version on
    the round's own copies."""
    from repro_torch.core import experts as ex
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    from repro_torch.data.synthetic import CIFAR10, make_image_dataset
    xtr, ytr, _, _ = make_image_dataset(CIFAR10, n_train=3000, n_test=10,
                                        seed=0)
    xtr = xtr.astype(np.float32)
    atk = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                       noise_std=5.0)
    rng = np.random.default_rng(6)
    tasks = [rng.integers(0, len(xtr), 1000) for _ in range(3)]

    def system(framework, device="cuda", **kw):
        return BMoESystem(BMoEConfig(framework=framework, attack=atk,
                                     expert_kind="cnn", in_ch=3, lr=0.1,
                                     **kw), device=device)

    out, per_fw = {}, {}
    for framework in ("bmoe", "traditional"):
        x0, y0 = xtr[tasks[0]], ytr[tasks[0]]
        g_cpu, m_cpu = _cnn_round_grads(torch, system(framework, "cpu"), x0,
                                        y0, "cpu")
        runs = []
        for rep in range(2):
            s = system(framework)
            if rep == 0:
                g_card, m_card = _cnn_round_grads(torch, s, x0, y0, "cuda")
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            acc = _counted_rounds(ops, s, tasks, xtr, ytr, {})
            torch.cuda.synchronize()
            runs.append(({**s.experts,
                          **{"gate_" + k: v for k, v in s.gate.items()}},
                         acc, s))
        errs = {k: float((g_card[k] - g_cpu[k]).abs().max()) for k in g_cpu}
        close = {k: bool(torch.allclose(g_card[k], g_cpu[k], rtol=1e-4,
                                        atol=1e-6)) for k in g_cpu}
        equal = {k: bool(torch.equal(m_card[k], m_cpu[k]))
                 for k in ("activation", "support", "flags", "dropped")}
        bitwise = all(_bitwise_equal(torch, runs[0][0][k], runs[1][0][k])
                      for k in runs[0][0])
        acc = runs[0][1]
        want = lm_counts(redundancy_vote=3 * (framework == "bmoe"))
        row = {"phase": "cnn_training", "path": "G4", "framework": framework,
               "rounds": 3, "task": 1000, "launches": acc,
               "grad_max_abs_err": errs, "grad_close": close,
               "metrics_equal": equal, "repeat_bitwise": bitwise,
               "loss_cpu_card": [float(m_cpu["loss"]),
                                 float(m_card["loss"])]}
        emit(row)
        require(all(close.values()) and all(equal.values()),
                f"G4 {framework}: card against CPU {close} {equal}")
        require(bitwise, f"G4 {framework}: two runs differ")
        require(acc == want, f"G4 {framework} launched {acc}, wanted {want}")
        out[framework] = acc
        per_fw[framework] = runs[0][2]

    # one dense-dispatch bmoe round: its vote on the round's own copies
    s = system("bmoe", dispatch="dense")
    x, y = xtr[tasks[1]], ytr[tasks[1]]
    xt = torch.from_numpy(x).cuda()
    mask_e, noise = s._draw_attack(atk, len(x), s.round)
    gate_bias, active = s._controls()
    bank = s._resolve_bank(xt, gate_bias)
    with ex.cnn_numerics():
        outs = ex.cnn_apply_all(bank, xt)                  # (N, B, C)
    pub = (outs[:, None] + atk.noise_std * noise.cuda().movedim(0, 1)
           * mask_e.cuda().reshape(1, -1, 1, 1)).reshape(10, 10, -1)
    pub = pub.contiguous()
    got = rv.redundancy_vote_masked(pub, active)
    want_v = ref.redundancy_vote_winner_ref(pub, active)
    ops.reset_launch_counts()
    m = s.train_round(x, y)
    torch.cuda.synchronize()
    dense_counts = ops.launch_counts()
    exact = (_bitwise_equal(torch, got[0], want_v[0])
             and all(torch.equal(got[i], want_v[i]) for i in (1, 2, 3)))
    row = {"phase": "cnn_training", "path": "G4", "framework": "bmoe",
           "dispatch": "dense", "pub": list(pub.shape), "launches":
           dense_counts, "vote_exact": exact,
           "support": m["support"].tolist(),
           "round_support_equals_vote": bool(np.array_equal(
               m["support"], got[1].cpu().numpy()))}
    emit(row)
    require(exact, "G4 dense round's vote differs from its plain version")
    require(row["round_support_equals_vote"],
            "G4 dense round's support is not its vote's")
    require(dense_counts["redundancy_vote"] == 1
            and dense_counts["moe_gemm"] == 0,
            f"G4 dense round launched {dense_counts}")
    out["dense_round"] = dense_counts
    return out, per_fw, xtr


def optimistic_training_path(torch, np, ops, rv, ref):
    """Path G: optimistic training (G1-G3) and the CNN experts (G4) at
    the paper's §V widths, seed 0, nothing cut."""
    from repro_torch.data.synthetic import FMNIST, make_image_dataset
    xtr, ytr, xte, yte = make_image_dataset(FMNIST, n_train=10000,
                                            n_test=2000, seed=0)
    xtr, xte = xtr.reshape(len(xtr), -1), xte.reshape(len(xte), -1)
    counts_g1, clean, tasks = optimistic_training_g1(torch, np, ops, xtr,
                                                     ytr, xte, yte)
    optimistic_training_g2(torch, np, xtr, ytr)
    optimistic_training_g3(torch, np, xtr, ytr)
    counts_g4, cnn_systems, cifar_x = cnn_path_g4(torch, np, ops, rv, ref)
    # profiled warm rounds: the clean optimistic twin, and the CNN bmoe
    prof_opt = train_profile(torch, np, clean, xtr, ytr, "optimistic",
                             moe_gemm=5, votes=0)
    cifar_y = np.zeros(len(cifar_x), np.int64)
    prof_cnn = train_profile(torch, np, cnn_systems["bmoe"], cifar_x,
                             cifar_y, "bmoe (cnn)", moe_gemm=0, votes=1)
    return counts_g1, counts_g4, prof_opt, prof_cnn


# ------------------------------------------ path M: federated training
FED_TRUST = dict(chunks_per_expert=4, audit_rate=1.0, challenge_window=2)
# the undefended FedAvg baseline and the defended rule under one edge's
# poison: BENCH_federated.json's attacks
FED_ATTACKS = {"grad_scale": dict(update_attack="grad_scale", scale=200.0),
               "sign_flip": dict(update_attack="sign_flip", scale=5.0)}
FED_SPANS = ("fed.round_s", "fed.train_s", "fed.aggregate_s", "fed.audit_s")


def _fed(data, device="cuda", **kw):
    """A ``FedCoordinator`` at the paper's §V expert width (10 edges, 10
    experts, 2 owned an edge, top-3, 784->256->10, 4 local steps of 64,
    seed 0; audit rate 1, window 2) on ``data``'s training set, the
    port's init."""
    from repro_torch import fed
    from repro_torch.trust.protocol import TrustConfig
    cfg = fed.FedConfig(num_edges=10, num_experts=10, experts_per_edge=2,
                        top_k=3, in_dim=784, hidden=256, num_classes=10,
                        local_steps=4, local_batch=64, seed=0,
                        trust=TrustConfig(**FED_TRUST), **kw)
    return fed.FedCoordinator(cfg, data[0], data[1], device=device)


def _fed_summaries(co, rounds: int, flush: bool = True):
    """``rounds`` rounds then the flush; the round summaries without
    their aggregation roots (those hash float bytes)."""
    out = []
    for _ in range(rounds):
        s = co.run_round()
        s.pop("agg_root", None)
        out.append(s)
    if flush:
        out.append(co.flush_trust())
    return out


def _fed_flat(co):
    from repro_torch.fed import tree_to_flat
    return tree_to_flat(co.global_params)


def _device_profile(torch, run):
    """One call of ``run`` under torch.profiler tracing the device only
    (a federated round's host work is mostly numpy and hashing, which a
    CPU trace would slow several-fold): the device's busy microseconds,
    kernels and copies, each record as (start, us, name), read from the
    raw trace, and the call's wall seconds (the profiler's own teardown,
    seconds more, left out).  One take: ``run`` changes state, so it is
    not run again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    raw = prof.profiler.kineto_results
    recs = sorted((e.start_ns() / 1e3, (e.end_ns() - e.start_ns()) / 1e3,
                   n) for e in raw.events()
                  if e.device_type() == DeviceType.CUDA
                  and not (n := e.name()).startswith(("Activity",
                                                      "ProfilerStep",
                                                      "[memory]")))
    return sum(r[1] for r in recs), recs, wall


def fed_m1(torch, np, data):
    """M1: 6 clean verified rounds and the flush.  Every round finalized,
    no fraud proof, one aggregation block a round, the chain valid; the
    accuracy after each round (M2's clean reference) and the state after
    3 rounds (M3's clean twin) are kept.  The last round (a drain of 3
    rounds' audits) is M5's profiled warm round."""
    from repro_torch.trust.protocol import RoundPhase
    co = _fed(data)
    acc, walls, after3, prof = [], [], None, {}
    for r in range(6):
        before = {k: co.obs.metrics.value(k) for k in FED_SPANS}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if r < 5:
            co.run_round()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        else:
            prof["busy_us"], prof["kernels"], wall = _device_profile(
                torch, co.run_round)
            walls.append(wall)
        acc.append(co.evaluate(data[2], data[3]))
        if r == 2:
            after3 = co.global_params
    prof["spans_s"] = {k: co.obs.metrics.value(k) - before[k]
                       for k in FED_SPANS}
    flushed = co.flush_trust()
    p = co.protocol
    phases = [p.rounds[r].phase.value for r in range(6)]
    rep = co.obs_report()
    row = {"phase": "federated", "path": "M1", "rounds": 6,
           "round_wall_s": walls, "accuracy_by_round": acc,
           "phases": phases, "flushed": flushed,
           "fraud_proofs": p.stats["fraud_proofs"],
           "aggregation_blocks": len(co.ledger.aggregations()),
           "chain_valid": co.ledger.verify_chain(), "fed": rep["fed"],
           "store": rep["storage"]["store"],
           "executors": [p.rounds[r].executor for r in range(6)]}
    emit(row)
    require(all(ph == "finalized" for ph in phases),
            f"M1 phases {phases}")
    require(p.stats["fraud_proofs"] == 0 and rep["fed"]["convictions"] == 0,
            f"M1 fraud on a clean run: {p.stats}")
    require(len(co.ledger.aggregations()) == 6 and co.ledger.verify_chain(),
            "M1 chain")
    require(all(0 <= a <= 1 for a in acc) and acc[-1] > 0.6,
            f"M1 accuracy {acc}")
    return co, acc, after3, walls, prof


def fed_m2(torch, np, data, clean_acc, rounds: int = 3):
    """M2: edge 2 poisons its delta (gradient scaling x200, sign flip x5),
    ``rounds`` unverified rounds each under the defended rule and under
    plain FedAvg: the defended run within 0.1 of the clean run's accuracy
    at the same round, FedAvg below it, sign flips rejected."""
    from repro_torch import fed
    res = {}
    for name, atk in FED_ATTACKS.items():
        for rule in ("defended", "fedavg"):
            co = _fed(data, verify="off", rule=rule,
                      attack=fed.FedAttack(malicious_edges=(2,), **atk))
            _fed_summaries(co, rounds, flush=False)
            res[name, rule] = (co.evaluate(data[2], data[3]),
                               co.obs_report()["fed"]["rejected_updates"])
    clean = clean_acc[rounds - 1]
    row = {"phase": "federated", "path": "M2", "rounds": rounds,
           "accuracy_clean": clean,
           **{f"accuracy_{n}_{r}": a for (n, r), (a, _) in res.items()},
           **{f"rejected_{n}_{r}": j for (n, r), (_, j) in res.items()}}
    emit(row)
    for name in FED_ATTACKS:
        acc_d, acc_f = res[name, "defended"][0], res[name, "fedavg"][0]
        require(acc_d >= clean - 0.1, f"M2 {name}: defended {acc_d}, clean "
                                      f"{clean}")
        require(acc_f < acc_d, f"M2 {name}: fedavg {acc_f} not below "
                               f"defended {acc_d}")
    require(res["sign_flip", "defended"][1] > 0, "M2: no sign flip rejected")
    return row


def fed_m3(torch, np, data, twin):
    """M3: edge 1 aggregates dishonestly (substitutes its commitment)
    when it executes; 3 rounds and the flush: the recompute court
    convicts it, slashes it, a rollback block lands, and the replayed
    chain holds the clean twin's bits after 3 rounds (M1's) on the
    card."""
    from repro_torch import fed
    co = _fed(data, attack=fed.FedAttack(malicious_edges=(1,),
                                   dishonest_aggregator=True))
    summaries = _fed_summaries(co, 3)
    rep = co.obs_report()
    rbs = co.ledger.rollbacks()
    stake = co.protocol.stakes.stake
    bitwise = _fed_flat(co).tobytes() == fed.tree_to_flat(twin).tobytes()
    row = {"phase": "federated", "path": "M3", "rounds": 3,
           "summaries": summaries, "fed": rep["fed"], "trust": rep["trust"],
           "rollback_blocks": [b.payload for b in rbs],
           "stake": stake.tolist(), "slash_blocks": len(co.ledger.slashes()),
           "court_cases": len(co.protocol.court.cases),
           "clean_twin_bitwise": bitwise,
           "chain_valid": co.ledger.verify_chain()}
    emit(row)
    require(rep["fed"]["convictions"] >= 1
            and rep["trust"]["rolled_back"] >= 1, f"M3 {rep['fed']}")
    require(len(rbs) >= 1 and rbs[0].payload["domain"] == "fed"
            and 1 in rbs[0].payload["slashed"], f"M3 rollback {rbs}")
    require(stake[1] < stake[0] and co.ledger.slashes(), f"M3 stake {stake}")
    require(rep["fed"]["replayed_rounds"] >= 1, "M3 replayed nothing")
    require(bitwise, "M3: the replayed chain is not the clean twin's bits")
    require(co.ledger.verify_chain(), "M3 chain")
    return row


def fed_m4(torch, np, data):
    """M4: two seeded runs on the card (stragglers 0.2, dropouts 0.1,
    edge 2 flipping its sign, seed 11; 2 rounds and the flush) hold the
    same bits, roots and counters; the first round against the port on
    the CPU from the same init: every decision equal, parameters at rtol
    1e-5 / atol 1e-5 (path F's bar)."""
    from repro_torch import fed
    kw = dict(straggler_prob=0.2, dropout_prob=0.1,
              attack=fed.FedAttack(malicious_edges=(2,),
                                   **FED_ATTACKS["sign_flip"]))
    runs = []
    for _ in range(2):
        co = _fed(data, **kw)
        s0 = _fed_summaries(co, 1, flush=False)
        first = _fed_flat(co)
        rest = _fed_summaries(co, 1)
        runs.append((co, s0 + rest, first))
    cpu = _fed(data, "cpu", **kw)
    s_cpu = _fed_summaries(cpu, 1, flush=False)
    (a, sa, fa), (b, sb, _) = runs
    roots = [[blk.payload.get("agg_root") for blk in c.ledger.aggregations()]
             for c in (a, b)]
    bitwise = _fed_flat(a).tobytes() == _fed_flat(b).tobytes()
    flat_cpu = _fed_flat(cpu)
    err = float(np.abs(fa - flat_cpu).max())
    close = bool(np.allclose(fa, flat_cpu, rtol=1e-5, atol=1e-5))
    row = {"phase": "federated", "path": "M4", "seeded_runs_bitwise": bitwise,
           "roots_equal": roots[0] == roots[1],
           "summaries_equal": sa == sb,
           "card_vs_cpu_decisions_equal": sa[0] == s_cpu[0],
           "card_vs_cpu_max_abs_err": err, "card_vs_cpu_close": close,
           "round0": sa[0], "round0_cpu": s_cpu[0]}
    emit(row)
    require(bitwise and roots[0] == roots[1] and sa == sb
            and a.obs_report()["fed"] == b.obs_report()["fed"],
            "M4: two seeded runs differ")
    require(sa[0] == s_cpu[0], f"M4 card {sa[0]} against the CPU {s_cpu[0]}")
    require(close, f"M4 parameters off the CPU's by {err}")
    return row


def fed_m5(torch, np, co, walls, prof):
    """M5: M1's last round, profiled (a warm round with an audit drain):
    its wall, the spans' seconds (``obs_report`` metrics), device busy
    and idle share; and the host syncs of one edge's local update (by
    torch's sync debug mode), over its local steps."""
    busy_ms = prof["busy_us"] / 1e3
    edge = co.edges[0]
    n_sync, where = _k_syncs(torch, lambda: edge.local_update(
        co.device_params(), co.round))
    top = {}
    for _, us, name in prof["kernels"]:
        top[name[:70]] = top.get(name[:70], 0.0) + us
    mine = sorted({n for _, _, n in prof["kernels"] if re.search(
        r"moe_gemm_kernel|vote_kernel|audit_mlp_kernel|flash_\w+_kernel|"
        r"rglru_\w+_kernel|ssd_\w+_kernel", n)})
    row = {"phase": "federated", "path": "M5",
           "round_wall_ms": walls[-1] * 1e3,
           "warm_round_walls_ms": [w * 1e3 for w in walls[1:]],
           "spans_ms": {k: v * 1e3 for k, v in prof["spans_s"].items()},
           "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / (walls[-1] * 1e3),
           "device_records": len(prof["kernels"]),
           "port_kernels_in_trace": mine,
           "host_syncs_per_local_update": n_sync,
           "host_syncs_per_local_step": n_sync / co.cfg.local_steps,
           "host_sync_sites": where,
           "top": sorted(({"name": k, "device_us": v} for k, v in
                          top.items()), key=lambda r: -r["device_us"])[:6]}
    emit(row)
    require(not mine, f"M5: port kernels in the trace {mine}")
    require(n_sync <= 3, f"M5: {n_sync} host syncs a local update: {where}")
    return row


def federated_path(torch, np, ops):
    """Path M: federated training (``repro_torch.fed``) at the paper's §V
    expert width on the card, seed 0, nothing cut.  JAX's federated step
    reaches no Pallas kernel (its dense mixture is plain products), so
    the path launches no port kernel: its counts are held to zero."""
    from repro_torch.data.synthetic import FMNIST, make_image_dataset
    data = make_image_dataset(FMNIST, n_train=10_000, n_test=2_000, seed=0)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    co, acc, twin, walls, prof = fed_m1(torch, np, data)
    fed_m2(torch, np, data, acc)
    fed_m3(torch, np, data, twin)
    fed_m4(torch, np, data)
    fed_m5(torch, np, co, walls, prof)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    emit({"phase": "federated", "path": "M", "launches": counts,
          "path_s": time.perf_counter() - t0})
    require(counts == dict.fromkeys(counts, 0),
            f"path M launched port kernels: {counts}")
    return counts


MESH_SHARDS = 5


def mesh_data(np):
    """Path N's tasks, the same on every rank: 5 training tasks of 1000
    rows and a test batch of 1000 (seed 2)."""
    from repro_torch.data.synthetic import FMNIST, make_image_dataset
    xtr, ytr, xte, _ = make_image_dataset(FMNIST, n_train=5000,
                                          n_test=1000, seed=2)
    return xtr.reshape(len(xtr), -1), ytr, xte.reshape(len(xte), -1)


def _mesh_rounds(torch, sys_, xtr, ytr, rounds: int):
    """``rounds`` training rounds on consecutive tasks of 1000: each
    round's wall (synchronised) and the bytes this rank sent in it, by
    exchange."""
    walls, wire = [], []
    for r in range(rounds):
        w0 = dict(sys_.mesh.wire_bytes)
        t0 = time.perf_counter()
        sys_.train_round(xtr[r * 1000:(r + 1) * 1000],
                         ytr[r * 1000:(r + 1) * 1000])
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        wire.append({k: v - w0.get(k, 0)
                     for k, v in sys_.mesh.wire_bytes.items()})
    return walls, wire


def mesh_cases(torch, np, ops, mesh: str):
    """Path N's runs at the paper's width with ``mesh`` ("on": this
    rank's share of a 5-shard edge mesh; "off": the one-device system).
    N1, optimistic training: edge 2 always cheats (sigma 5), audit rate
    1, batched audits, window 2, 5 rounds, then ``flush_trust`` and
    ``infer``.  N2, ``bmoe`` and ``traditional`` under 3 colluders, 3
    rounds each, then an attacked ``infer``.  Returns per run: parameter
    digests (the whole bank), rounds (root, phase, proofs), logits,
    block hashes, launches by phase and their records, round walls and
    wire bytes."""
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    from repro_torch.core.ledger import digest_bytes, digest_tree
    from repro_torch.trust.commitments import MerkleTree
    from repro_torch.trust.protocol import TrustConfig

    def params(sys_):
        return {"bank": digest_tree(sys_.full_bank()),
                "gate": digest_tree(sys_.gate),
                "blocks": [b.hash for b in sys_.ledger.blocks],
                "local_rows": {k: tuple(v.shape)
                               for k, v in sys_.experts.items()}}

    xtr, ytr, xte = mesh_data(np)
    out = {}
    sys_ = _optimistic_trainer(
        AttackConfig(malicious_edges=(2,), attack_prob=1.0, noise_std=5.0),
        TrustConfig(audit_rate=1.0, num_verifiers=2, challenge_window=2,
                    audit_backend="batched"),
        mesh=mesh, mesh_shards=MESH_SHARDS)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    walls, wire = _mesh_rounds(torch, sys_, xtr, ytr, 5)
    flush = sys_.flush_trust()
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want, calls, replayed = _train_launches_expected(sys_, 5)
    logits = sys_.infer(xte, commit=False)[0]
    com = sys_.protocol.rounds[0].commitment
    out["N1"] = {
        **params(sys_), "flush": flush, "logits": digest_bytes(
            logits.tobytes()),
        "rounds": {rid: (st.commitment.root, st.phase.value,
                         [(p.leaf_index, p.expert, p.claimed_digest,
                           p.recomputed_digest) for p in st.proofs])
                   for rid, st in sys_.protocol.rounds.items()},
        "rolled_back": sys_.protocol.stats["rolled_back"],
        "stats": dict(sys_.protocol.stats),
        "num_shards": com.num_shards,
        "shard_roots_reduce": (com.shard_roots is None or MerkleTree(
            com.shard_roots).root == com.root),
        "audit_rows": {sh: sys_.obs.metrics.value(
            "bmoe.mesh.audit_rows", shard=str(sh))
            for sh in range(MESH_SHARDS)},
        "capacity": sys_._exec_rows(1000), "launches": counts,
        "want": want, "audit_calls": calls, "replayed": replayed,
        "walls_ms": walls, "wire": wire}
    strong = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                          noise_std=5.0)
    for fw in ("bmoe", "traditional"):
        sys_ = BMoESystem(BMoEConfig(framework=fw, attack=strong, mesh=mesh,
                                     mesh_shards=MESH_SHARDS),
                          device="cuda")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        walls, wire = _mesh_rounds(torch, sys_, xtr, ytr, 3)
        train_counts = ops.launch_counts()
        ops.reset_launch_counts()
        logits, _, support = sys_.infer(xte)
        torch.cuda.synchronize()
        out["N2_" + fw] = {
            **params(sys_), "logits": digest_bytes(logits.tobytes()),
            "support": support.tolist(), "launches": train_counts,
            "infer_launches": ops.launch_counts(), "walls_ms": walls,
            "wire": wire}
    return out


def mesh_rank(rank: int, world: int, out_dir: str) -> None:
    """One rank of path N's world (spawned by ``spawn_edges``, its
    process group and card set): loads the kernel library the parent
    built, runs ``mesh_cases(mesh="on")`` and writes the results to
    ``<out_dir>/rank<r>.pkl``.  It prints nothing: the parent reports."""
    import pickle

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    t0 = time.perf_counter()
    res = mesh_cases(torch, np, ops, "on")
    res["backend"] = dist.get_backend()
    res["device"] = torch.cuda.current_device()
    res["cases_s"] = time.perf_counter() - t0
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def mesh_kernel_cases(torch, mg, rv, am, ref):
    """N3: the three kernels at one shard's shapes (E_l = 2 of 10
    experts): each against its plain version and timed (``check_*``),
    and each E_l launch bitwise equal to the same rows of the full-E
    launch (shard 1, experts 2 and 3)."""
    E, El, lo = 10, 2, 2
    gemm = [check_moe_gemm(torch, mg, ref, seed, name, El, C, d, f,
                           torch.float32)
            for seed, name, C, d, f in (
                (60, "mesh_layer1", 376, 784, 256),
                (61, "mesh_layer2", 376, 256, 10),
                (62, "mesh_bwd_dw2", 256, 376, 10),
                (63, "mesh_bwd_dh", 376, 10, 256),
                (64, "mesh_bwd_dw1", 784, 376, 256))]
    vote = check_vote(torch, rv, ref, 65, "mesh_shard", El, 10, 3760,
                      n_bad=3)
    audit = check_audit_mlp(torch, am, ref, 66, "mesh_shard_commit", El, 8,
                            94, 784, 256, 10)
    g = torch.Generator("cuda").manual_seed(70)
    same = {}
    for row, (C, d, f) in zip(gemm, ((376, 784, 256), (376, 256, 10),
                                     (256, 376, 10), (376, 10, 256),
                                     (784, 376, 256))):
        buf = torch.randn(E, C, d, generator=g, device="cuda")
        w = torch.randn(E, d, f, generator=g, device="cuda") * d ** -0.5
        full = mg.moe_gemm(buf, w)
        part = mg.moe_gemm(buf[lo:lo + El].contiguous(),
                           w[lo:lo + El].contiguous())
        same["moe_gemm " + row["case"]] = _bitwise_equal(
            torch, part, full[lo:lo + El])
    gc = torch.Generator().manual_seed(71)
    honest = torch.randn(E, 1, 3760, generator=gc)
    pub = honest.expand(E, 10, 3760).clone()
    pub[:, 7:] += 5.0 * torch.randn(E, 1, 3760, generator=gc)
    pub, active = pub.cuda(), torch.ones(10, device="cuda")
    full = rv.redundancy_vote_masked(pub, active)
    part = rv.redundancy_vote_masked(pub[lo:lo + El].contiguous(), active)
    same["redundancy_vote"] = all(_bitwise_equal(torch, p, q[lo:lo + El])
                                  for p, q in zip(part, full))
    bank = _audit_bank(torch, gc, E, 784, 256, 10)
    x = torch.randn(4 * E, 94, 784, generator=gc).cuda()
    gid = torch.arange(E, dtype=torch.int32).repeat_interleave(4).cuda()
    full = am.audit_mlp(bank, x, gid)
    part = am.audit_mlp({k: v[lo:lo + El].contiguous()
                         for k, v in bank.items()},
                        x[4 * lo:4 * (lo + El)].contiguous(),
                        gid[4 * lo:4 * (lo + El)] - lo)
    same["audit_mlp"] = _bitwise_equal(torch, part,
                                       full[4 * lo:4 * (lo + El)])
    torch.cuda.synchronize()
    emit({"phase": "mesh", "path": "N3", "shard": "1 of 5 (experts 2, 3)",
          "full_E_rows_bitwise": same})
    require(all(same.values()),
            f"a kernel's E_l launch differs from the full-E rows: {same}")
    return gemm, vote, audit


def mesh_path(torch, np, ops, mg, rv, am, ref):
    """Path N: B-MoE on a 5-shard edge mesh (``mesh="on"``), five ranks
    on the one card (``spawn_edges``; gloo, since NCCL refuses two ranks
    on one card), each holding 2 of the 10 experts, at the paper's width:
    N1 (optimistic) and N2 (bmoe, traditional) held bitwise to the
    one-device system run here first; N3 the kernels at the shard
    shapes; N4 each rank's launches against the records; N5 round walls
    on and off, each exchange's bytes a rank, the backend.  The ranks
    load the library this process built; a failing rank fails the
    path."""
    import pickle
    from repro_torch.launch.mesh import spawn_edges
    t_start = time.perf_counter()
    off = mesh_cases(torch, np, ops, "off")
    t_off = time.perf_counter() - t_start
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", f"mesh-{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    spawn_edges(mesh_rank, MESH_SHARDS, args=(out_dir,), device="cuda",
                rendezvous_dir=out_dir, timeout_s=300)
    t_world = time.perf_counter() - t0
    ranks = []
    for r in range(MESH_SHARDS):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)

    # N1 and N2: every rank bitwise the one-device system
    same = {}
    for run, keys in (("N1", ("bank", "gate", "blocks", "rounds", "flush",
                              "logits", "rolled_back", "stats")),
                      ("N2_bmoe", ("bank", "gate", "blocks", "logits",
                                   "support")),
                      ("N2_traditional", ("bank", "gate", "blocks", "logits",
                                          "support"))):
        same[run] = {k: all(res[run][k] == off[run][k] for res in ranks)
                     for k in keys}
    n1 = ranks[0]["N1"]
    rows = n1["audit_rows"]
    total = sum(rows.values())
    n1_ok = (n1["rolled_back"] >= 1 and n1["num_shards"] == MESH_SHARDS
             and n1["shard_roots_reduce"]
             and all(r > 0 for r in rows.values())
             and max(rows.values()) <= total / MESH_SHARDS + n1["capacity"]
             and all(res["N1"]["local_rows"]["w1"] == (2, 784, 256)
                     for res in ranks))
    emit({"phase": "mesh", "path": "N1", "ranks": MESH_SHARDS,
          "backend": ranks[0]["backend"],
          "devices": [res["device"] for res in ranks],
          "bitwise_vs_mesh_off": same["N1"],
          "rolled_back": n1["rolled_back"], "stats": n1["stats"],
          "num_shards": n1["num_shards"],
          "shard_roots_reduce": n1["shard_roots_reduce"],
          "audit_rows": rows, "audit_rows_total": total,
          "capacity": n1["capacity"],
          "local_rows": n1["local_rows"]})
    require(all(same["N1"].values()) and n1_ok,
            f"N1 on the mesh differs from mesh off: {same['N1']}")
    emit({"phase": "mesh", "path": "N2",
          "bitwise_vs_mesh_off": {k: same["N2_" + k]
                                  for k in ("bmoe", "traditional")},
          "support_bmoe": ranks[0]["N2_bmoe"]["support"]})
    require(all(all(v.values()) for v in same.values()),
            f"N2 on the mesh differs from mesh off: {same}")

    # N3: the kernels at the shard shapes
    gemm, vote, audit = mesh_kernel_cases(torch, mg, rv, am, ref)

    # N4: each rank's launches against the numbers a round calls for
    want_n2 = {fw: (lm_counts(moe_gemm=15, redundancy_vote=3 * (fw ==
                                                                "bmoe")),
                    lm_counts(moe_gemm=2, redundancy_vote=int(fw ==
                                                              "bmoe")))
               for fw in ("bmoe", "traditional")}
    launches = [{"N1": res["N1"]["launches"], "N1_want": res["N1"]["want"],
                 "N2_bmoe": res["N2_bmoe"]["launches"],
                 "N2_bmoe_infer": res["N2_bmoe"]["infer_launches"],
                 "N2_traditional": res["N2_traditional"]["launches"],
                 "N2_traditional_infer": res["N2_traditional"][
                     "infer_launches"]} for res in ranks]
    n4_ok = all(
        lr["N1"] == lr["N1_want"]
        and all(lr["N2_" + fw] == want_n2[fw][0]
                and lr[f"N2_{fw}_infer"] == want_n2[fw][1]
                for fw in want_n2)
        for lr in launches)
    emit({"phase": "mesh", "path": "N4",
          "per_rank_round": {"moe_gemm": "2 forward + 3 backward",
                             "redundancy_vote": "1 a bmoe round or batch",
                             "audit_mlp": "1 a commit + the drains and "
                                          "eager recomputes counted"},
          "rank0": launches[0],
          "audit_calls": n1["audit_calls"], "replayed": n1["replayed"],
          "all_ranks_equal": all(lr == launches[0] for lr in launches)})
    require(n4_ok, f"path N launches differ from the records: {launches}")

    # N5: walls on and off, bytes a rank by exchange, the backend
    emit({"phase": "mesh", "path": "N5", "backend": ranks[0]["backend"],
          "nccl": False,
          "n1_round_walls_ms": {"off": off["N1"]["walls_ms"],
                                "on_rank0": n1["walls_ms"]},
          "n2_bmoe_round_walls_ms": {
              "off": off["N2_bmoe"]["walls_ms"],
              "on_rank0": ranks[0]["N2_bmoe"]["walls_ms"]},
          "n2_traditional_round_walls_ms": {
              "off": off["N2_traditional"]["walls_ms"],
              "on_rank0": ranks[0]["N2_traditional"]["walls_ms"]},
          "wire_bytes_rank0": {"N1_round0": n1["wire"][0],
                               "N2_bmoe_round1": ranks[0]["N2_bmoe"][
                                   "wire"][1]},
          "rank_cases_s": [res["cases_s"] for res in ranks],
          "off_s": t_off, "world_s": t_world,
          "path_s": time.perf_counter() - t_start})
    return {"ranks": launches, "gemm": gemm, "vote": vote, "audit": audit}


# ------------------------------------------------ path O: the LM mesh
LM_MESH_AXES = {2: ("data", "model"), 3: ("data", "replica", "model")}
# path O's depths (O1 4, O2 and O3 2 layers before path Q joined the
# script; O1 and O4 2 before path R did)
LM_MESH_LAYERS = {"O1": 1, "O2": 1, "O3": 1, "O4": 1}
LM_MESH_SHAPES = {"O1": (1, 4), "O2": (1, 4, 2), "O3": (2, 2, 1),
                  "O4": (1, 2)}


def _cut(cfg, layers: int, **kw):
    """``cfg`` at its full width, cut to its first ``layers`` layers."""
    import dataclasses
    return dataclasses.replace(cfg, num_layers=layers, num_blocks=layers,
                               **kw).validate()


def lm_mesh_cfg(sub: str, mode: str = "faithful"):
    """Path O's configs, cut to ``LM_MESH_LAYERS``: O1 qwen2-moe-a2.7b,
    capacity factor 8; O2 its TRUSTED_* variant (r = 4), the config's
    capacity; O3 bmoe-paper (faithful, r = 2; four ranks training 4
    layers at 2 x 2048 rows each outgrow the card); O4 qwen2-moe-a2.7b,
    capacity factor 8, one microbatch."""
    from repro_torch.configs import get_config
    from repro_torch.configs import qwen2_moe_a2_7b as qwen
    n = LM_MESH_LAYERS[sub]
    if sub == "O1":
        return _cut(get_config("qwen2-moe-a2.7b"), n, capacity_factor=8.0)
    if sub == "O2":
        return _cut(qwen.TRUSTED_FAITHFUL if mode == "faithful"
                    else qwen.TRUSTED_DIGEST, n)
    if sub == "O3":
        return _cut(get_config("bmoe-paper"), n)
    return _cut(get_config("qwen2-moe-a2.7b"), n, capacity_factor=8.0,
                train_microbatches=1)


def fingerprint(torch, t) -> int:
    """An exact fingerprint of a float32 tensor's bits, on its device:
    the int64 sum of its 32-bit words, each times a weight by position,
    in chunks (equal bits give equal fingerprints; any one changed bit
    changes it)."""
    flat = t.detach().contiguous().view(-1).view(torch.int32)
    total, step = 0, 1 << 24
    for i in range(0, flat.numel(), step):
        w = torch.arange(i, min(i + step, flat.numel()), device=t.device,
                         dtype=torch.int64) % 65521 + 1
        total += int((flat[i:i + step].to(torch.int64) * w).sum())
    return total


def fingerprint_tree(torch, tree):
    from repro_torch.core.ledger import tree_flatten
    return [fingerprint(torch, t) for t in tree_flatten(tree)[0]]


def _max_diff_chunked(torch, a, b_host, rows: int = 256) -> float:
    """max |a - b| of a (1, S, V) device tensor and a host copy, S in
    chunks (the second copy is never whole on the card)."""
    out = 0.0
    for i in range(0, a.shape[1], rows):
        d = (a[:, i:i + rows] - b_host[:, i:i + rows].to(a.device)).abs()
        out = max(out, float(d.max()))
    return out


def _mesh_logits(torch, cfg, params, tokens, mesh, attack=None,
                 rows=None, whole=True):
    """The prefill's forward logits: at positions ``rows`` (all when
    None), whole (a placed tree's vocabulary columns gathered over
    ``model``) or, with ``whole=False``, this rank's columns."""
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import step_sharder
    shard = step_sharder(cfg, mesh, "prefill", attack)
    with torch.no_grad():
        logits, _ = tfm.forward_train(params, tokens, cfg, shard=shard)
        if rows is not None:
            logits = logits[:, rows]
        return tfm.gather_vocab(logits, shard) if whole else logits


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


class EPRouteRecorder:
    """Records each EP layer's router logits (``moe_ep.router_probs``'
    input) and its dispatch (``moe_ep.route_probs``' outputs) while
    installed."""

    def __init__(self):
        self.logits, self.routes = [], []

    def __enter__(self):
        from repro_torch.models import moe_ep
        self.mod = moe_ep
        self.probs, self.route = moe_ep.router_probs, moe_ep.route_probs

        def probs(logits, num_real=0):
            self.logits.append(logits.detach().clone())
            return self.probs(logits, num_real)

        def route(pr, k, cap, valid=None):
            out = self.route(pr, k, cap, valid)
            self.routes.append((cap, None if valid is None else
                                valid.clone(), [t.clone() for t in out[1:4]]))
            return out

        moe_ep.router_probs, moe_ep.route_probs = probs, route
        return self

    def __exit__(self, *exc):
        self.mod.router_probs, self.mod.route_probs = self.probs, self.route


def _o1(torch, ops, mesh):
    """O1 on a rank: the EP prefill at capacity factor 8 (logits' bits
    against the one-device run's), walls and launches; then at the
    config's 1.25, each layer's dispatch against ``route_masked`` on this
    rank's logit rows, and the share dropped."""
    import dataclasses
    from repro_torch.models.moe import route_masked
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import make_prefill_step
    cfg = lm_mesh_cfg("O1")
    params = init_model(cfg, 0, mesh.device, mesh=mesh, kind="prefill")
    tokens = prefill_batch(torch, cfg, 4096)["tokens"]
    rows = _mesh_logits(torch, cfg, params, tokens, mesh, rows=O1_ROWS)
    one = torch.load(os.path.join(O1_DIR[0], "o1_rows.pt"))
    rows = rows[0].cpu()
    out = {"fingerprint": fingerprint(torch, rows),
           "rows_max_abs_diff": float((rows - one).abs().max()),
           "rows_max_abs": float(one.abs().max()),
           "next": int(rows[-1].argmax())}
    prefill = make_prefill_step(cfg, mesh)
    ops.reset_launch_counts()
    mesh.wire_bytes.clear()
    nxt, wall = _timed(torch, lambda: prefill(params, {"tokens": tokens}))
    out.update(launches=ops.launch_counts(), wire=dict(mesh.wire_bytes),
               walls_ms=[wall] + [_timed(torch, lambda: prefill(
                   params, {"tokens": tokens}))[1] for _ in range(2)],
               next_step=nxt.tolist())
    low = dataclasses.replace(cfg, capacity_factor=1.25)
    with EPRouteRecorder() as rec:
        make_prefill_step(low, mesh)(params, {"tokens": tokens})
    same, dropped = [], []
    T = tokens.numel()
    k = cfg.num_experts_per_tok
    for lg, (cap, valid, got) in zip(rec.logits, rec.routes):
        T_l = -(-T // mesh.model.shards)
        lo, hi = mesh.model.row_range(T, T_l)
        rows = torch.cat([lg[lo:hi], lg.new_zeros((T_l - (hi - lo),
                                                   lg.shape[1]))])
        want = route_masked(rows[None], k, cap, cfg.num_experts, valid)
        same.append(all(torch.equal(a, b) for a, b in zip(got, want[1:4])))
        dropped.append(1.0 - float(got[2].sum()) / ((hi - lo) * k))
    out.update(route_same=same, dropped_share=dropped,
               capacity=rec.routes[0][0])
    return out


# the positions O1 compares (every 64th and the last), and where the
# parent leaves the one-device rows for the ranks
O1_ROWS = list(range(0, 4096, 64)) + [4095]
O1_DIR = [""]


def _o2(torch, ops, mesh):
    """O2 on a rank: the trusted EP prefill under ``faithful`` and
    ``digest`` (r = 4), clean, with replica 3 adding noise and with
    replicas 0-2 colluding; this rank's vocabulary columns of the logits
    against the clean run's."""
    from repro_torch.core.trusted_moe import LMAttack
    from repro_torch.train.loop import init_model
    params = init_model(lm_mesh_cfg("O2"), 0, mesh.device,
                        mesh=mesh, kind="prefill")
    tokens = prefill_batch(torch, lm_mesh_cfg("O2"), 2048)["tokens"]
    out = {}
    for mode in ("faithful", "digest"):
        cfg = lm_mesh_cfg("O2", mode)
        ops.reset_launch_counts()
        mesh.wire_bytes.clear()
        clean, wall = _timed(torch, lambda: _mesh_logits(
            torch, cfg, params, tokens, mesh, whole=False))
        row = {"launches": ops.launch_counts(), "wire": dict(mesh.wire_bytes),
               "wall_ms": wall, "fingerprint": fingerprint(torch, clean),
               "model_shard": mesh.model.shard,
               "max_abs_logit": float(clean.abs().max())}
        clean = clean.cpu()
        for who, mal in (("minority", (3,)), ("majority", (0, 1, 2))):
            got = _mesh_logits(torch, cfg, params, tokens, mesh,
                               LMAttack(malicious_replicas=mal,
                                        noise_std=4.0), whole=False)
            row[who] = {"fingerprint": fingerprint(torch, got),
                        "max_abs_diff": _max_diff_chunked(torch, got, clean)}
            del got
        out[mode] = row
    return out


def _leaf_paths(tree, prefix=""):
    """Each leaf's path, in ``tree_flatten``'s order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _leaf_paths(v, f"{prefix}/{i}")]
    return [prefix]


def _grads_vs_one_device(torch, cfg, mesh, g_mesh, batch):
    """This rank's gradients against the one-device step's, computed here
    in this rank's turn (one rank at a time on the card): bitwise by
    leaf, and the largest difference relative to each leaf's largest
    magnitude.  Returns (the comparison, the one-device wall ms)."""
    import torch.distributed as dist
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.sharding import shard_params
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import make_loss_and_grads
    out = None
    for turn in range(mesh.world):
        dist.barrier()
        if turn != mesh.rank:
            continue
        p1 = init_model(cfg, 0, device=mesh.device)
        (loss1, _, g1), wall = _timed(torch, lambda: make_loss_and_grads(
            cfg, remat=False)(p1, batch))
        del p1
        g1 = shard_params(g1, cfg, mesh)
        a, b = tree_flatten(g_mesh)[0], tree_flatten(g1)[0]
        rel = [float((x - y).abs().max() / y.abs().max().clamp(min=1e-30))
               for x, y in zip(a, b)]
        out = ({"loss_one_device": float(loss1),
                "leaves": len(a),
                "leaves_bitwise": sum(torch.equal(x, y)
                                      for x, y in zip(a, b)),
                "max_rel_diff": max(rel),
                "rel_diff_by_leaf": dict(zip(_leaf_paths(g_mesh), rel))},
               wall)
        del g1, a, b
        gc.collect()                 # the step's tensors sit in cycles
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _o3(torch, ops, mesh):
    """O3 on a rank: bmoe-paper's trusted training (faithful, r = 2) on
    (data 2, replica 2, model 1), 2 steps of (4, 2048), clean and with
    replica 1 adding noise (sigma 5); the first step's loss and gradients
    against the one-device step's."""
    from repro_torch.core.trusted_moe import LMAttack
    from repro_torch.optim import adamw
    from repro_torch.sharding import gather_params
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import make_loss_and_grads, make_train_step
    cfg = lm_mesh_cfg("O3")
    batch = _lm_train_batch(torch, cfg, 4, 2048)
    out = {}
    for who, atk in (("clean", None),
                     ("minority", LMAttack(malicious_replicas=(1,),
                                           noise_std=5.0))):
        params = init_model(cfg, 0, mesh.device, mesh=mesh)
        state = adamw.init(params)
        step = make_train_step(cfg, adamw.AdamWConfig(), mesh, attack=atk,
                               remat=False)
        torch.cuda.reset_peak_memory_stats()
        losses, walls, counts = [], [], None
        for s in range(2):
            ops.reset_launch_counts()
            mesh.wire_bytes.clear()
            (params, state, m), wall = _timed(torch, lambda: step(
                params, state, batch))
            counts = counts or ops.launch_counts()
            losses.append(float(m["loss"]))
            walls.append(wall)
        out[who] = {"losses": losses, "walls_ms": walls, "launches": counts,
                    "wire": dict(mesh.wire_bytes),
                    "step_peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                    "params": fingerprint_tree(torch, gather_params(
                        params, cfg, mesh))}
        del params, state
        gc.collect()
        torch.cuda.empty_cache()
    params = init_model(cfg, 0, mesh.device, mesh=mesh)
    loss, _, g = make_loss_and_grads(cfg, remat=False, mesh=mesh)(params,
                                                                  batch)
    del params
    cmp, wall = _grads_vs_one_device(torch, cfg, mesh, g, batch)
    out["vs_one_device"] = {**cmp, "loss_mesh": float(loss),
                            "one_device_wall_ms": wall}
    return out


def _o4(torch, ops, mesh):
    """O4 on a rank: qwen2-moe-a2.7b's EP training at capacity factor 8 on
    (1, 2), one step at (1, 2048): gradients against the one-device
    step's, then the step's wall and peak memory."""
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import make_loss_and_grads, make_train_step
    cfg = lm_mesh_cfg("O4")
    batch = _lm_train_batch(torch, cfg, 1, 2048)
    params = init_model(cfg, 0, mesh.device, mesh=mesh)
    ops.reset_launch_counts()
    mesh.wire_bytes.clear()
    (loss, _, g), wall = _timed(torch, lambda: make_loss_and_grads(
        cfg, remat=False, mesh=mesh)(params, batch))
    out = {"launches": ops.launch_counts(), "wire": dict(mesh.wire_bytes),
           "loss_and_grads_wall_ms": wall}
    cmp, wall1 = _grads_vs_one_device(torch, cfg, mesh, g, batch)
    out["vs_one_device"] = {**cmp, "loss_mesh": float(loss),
                            "one_device_wall_ms": wall1}
    del g
    gc.collect()
    torch.cuda.empty_cache()
    state = adamw.init(params)
    step = make_train_step(cfg, adamw.AdamWConfig(), mesh, remat=False)
    torch.cuda.reset_peak_memory_stats()
    (_, _, m), out["step_wall_ms"] = _timed(torch, lambda: step(
        params, state, batch))
    out["step_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["step_loss"] = float(m["loss"])
    return out


def lm_mesh_rank(rank: int, world: int, sub: str, out_dir: str) -> None:
    """One rank of a path O world (spawned by ``spawn_edges``, its process
    group and card set): loads the kernel library the parent built, runs
    its sub-path on its ``LMMesh`` and writes the results to
    ``<out_dir>/<sub>-rank<r>.pkl``.  It prints nothing."""
    import pickle

    import torch
    import torch.distributed as dist
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_lm_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    shape = LM_MESH_SHAPES[sub]
    mesh = make_lm_mesh(shape, LM_MESH_AXES[len(shape)])
    O1_DIR[0] = out_dir
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = {"O1": _o1, "O2": _o2, "O3": _o3, "O4": _o4}[sub](torch, ops, mesh)
    res.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               backend=dist.get_backend(), coords=mesh.coords,
               device=torch.cuda.current_device(),
               cases_s=time.perf_counter() - t0)
    with open(os.path.join(out_dir, f"{sub}-rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _lm_mesh_world(sub: str, out_dir: str):
    """Runs sub-path ``sub``'s world and returns its ranks' results."""
    import pickle
    from repro_torch.launch.mesh import spawn_edges
    world = math.prod(LM_MESH_SHAPES[sub])
    t0 = time.perf_counter()
    spawn_edges(lm_mesh_rank, world, args=(sub, out_dir),
                device="cuda", rendezvous_dir=out_dir, timeout_s=300)
    res = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{sub}-rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    return res, time.perf_counter() - t0


def lm_mesh_kernel_cases(torch, mg, rv, ref):
    """``moe_gemm`` and the vote at path O's per-rank shapes: O1's local
    experts at the config's capacity (E_l 16, 4 x 80 rows), and O2's
    routed vote (E_l 32 of 4 copies of 160 rows x 2048)."""
    gemm = [check_moe_gemm(torch, mg, ref, 80, "lm_mesh_gate_up", 16, 320,
                           2048, 1408, torch.float32, w_scale=2048 ** -0.5),
            check_moe_gemm(torch, mg, ref, 81, "lm_mesh_down", 16, 320,
                           1408, 2048, torch.float32, w_scale=1408 ** -0.5)]
    vote = check_vote(torch, rv, ref, 82, "lm_mesh_routed", 32, 4,
                      160 * 2048, n_bad=1)
    return gemm, vote


def lm_mesh_path(torch, np, ops, mg, rv, ref):
    """Path O: the LM stack on a mesh, ranks sharing the one card over
    gloo, at full width (depth cut): O1 qwen2-moe-a2.7b's EP prefill on
    (1, 4) bitwise the one-device prefill run here first; O2 the trusted
    EP prefill on (1, 4, 2), a minority repaired and a majority seen; O3
    bmoe-paper's trusted training on (2, 2, 1), attacked = clean bitwise;
    O4 qwen2-moe's EP training on (1, 2) against one device.  Each rank's
    launches are held to the records."""
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import make_prefill_step
    t_start = time.perf_counter()
    gemm, vote = lm_mesh_kernel_cases(torch, mg, rv, ref)

    # O1's one-device reference, freed before the ranks start
    cfg = lm_mesh_cfg("O1")
    params = init_model(cfg, 0)
    tokens = prefill_batch(torch, cfg, 4096)["tokens"]
    rows = _mesh_logits(torch, cfg, params, tokens, None, rows=O1_ROWS)
    one = {"fingerprint": fingerprint(torch, rows),
           "next": int(rows[0, -1].argmax())}
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", f"lm-mesh-{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    O1_DIR[0] = out_dir
    torch.save(rows[0].cpu(), os.path.join(out_dir, "o1_rows.pt"))
    del rows
    prefill = make_prefill_step(cfg)
    one["walls_ms"] = [_timed(torch, lambda: prefill(
        params, {"tokens": tokens}))[1] for _ in range(3)]
    del params
    gc.collect()
    torch.cuda.empty_cache()

    o1, o1_s = _lm_mesh_world("O1", out_dir)
    # O1: the one-device prefill's logits at 1e-5 of their largest
    # magnitude (every 64th position; the attention and the shared
    # expert run tensor-parallel over model), the ranks alike; dispatch =
    # route_masked
    n1 = LM_MESH_LAYERS["O1"]
    want1 = lm_counts(moe_gemm=3 * n1, flash_attention=n1)
    o1_ok = {"logits": all(r["rows_max_abs_diff"] <= 1e-5 * r["rows_max_abs"]
                           for r in o1),
             "ranks_agree": len({r["fingerprint"] for r in o1}) == 1,
             "next_token": all(r["next"] == one["next"]
                               and r["next_step"] == [[one["next"]]]
                               for r in o1),
             "route_masked_exact": all(all(r["route_same"]) for r in o1),
             "launches": all(r["launches"] == want1 for r in o1)}
    emit({"phase": "lm_mesh", "path": "O1", "model": "qwen2-moe-a2.7b",
          "mesh": {"data": 1, "model": 4},
          "reduced": f"{n1} of 24 layers",
          "prefill": "1 x 4096, capacity factor 8 (nothing dropped)",
          "checks": o1_ok, "next_token": one["next"],
          "sampled_rows_bitwise_one_device": all(
              r["fingerprint"] == one["fingerprint"] for r in o1),
          "max_abs_logit_diff": [r["rows_max_abs_diff"] for r in o1],
          "max_abs_logit": o1[0]["rows_max_abs"],
          "walls_ms": {"one_device": one["walls_ms"],
                       "mesh_rank0": o1[0]["walls_ms"]},
          "launches_rank0": o1[0]["launches"], "want": want1,
          "wire_bytes_rank0": o1[0]["wire"],
          "at_1_25": {"capacity": o1[0]["capacity"],
                      "dropped_share_by_rank_layer": [r["dropped_share"]
                                                      for r in o1]},
          "peak_gb": [r["peak_gb"] for r in o1], "world_s": o1_s})
    require(all(o1_ok.values()), f"O1 failed: {o1_ok}")

    # O2: minority repaired, majority seen, votes as the records say
    o2, o2_s = _lm_mesh_world("O2", out_dir)
    o2_ok = {}
    n2 = LM_MESH_LAYERS["O2"]
    for mode, votes in (("faithful", 2 * n2), ("digest", 0)):
        want = lm_counts(moe_gemm=3 * n2, flash_attention=n2,
                         redundancy_vote=votes)
        o2_ok[mode] = {
            "minority_repaired": all(
                r[mode]["minority"]["fingerprint"] == r[mode]["fingerprint"]
                for r in o2),
            "majority_seen": all(r[mode]["majority"]["max_abs_diff"] > 1e-2
                                 for r in o2),
            # the replicas of each model rank hold the same columns
            "ranks_agree": all(len({r[mode]["fingerprint"] for r in o2
                                    if r[mode]["model_shard"] == m}) == 1
                               for m in range(LM_MESH_SHAPES["O2"][-1])),
            "launches": all(r[mode]["launches"] == want for r in o2)}
    emit({"phase": "lm_mesh", "path": "O2", "model": "qwen2-moe-a2.7b "
          "TRUSTED_FAITHFUL / TRUSTED_DIGEST (r = 4)",
          "mesh": {"data": 1, "replica": 4, "model": 2},
          "reduced": f"{n2} of 24 layers",
          "prefill": "1 x 2048, capacity 1.25",
          "checks": o2_ok,
          "max_abs_logit_rank0": {m: o2[0][m]["max_abs_logit"]
                                  for m in ("faithful", "digest")},
          "max_abs_diff": {m: {w: [r[m][w]["max_abs_diff"] for r in o2]
                               for w in ("minority", "majority")}
                           for m in ("faithful", "digest")},
          "walls_ms_rank0": {m: o2[0][m]["wall_ms"]
                             for m in ("faithful", "digest")},
          "launches_rank0": {m: o2[0][m]["launches"]
                             for m in ("faithful", "digest")},
          "wire_bytes_rank0": {m: o2[0][m]["wire"]
                               for m in ("faithful", "digest")},
          "peak_gb": [r["peak_gb"] for r in o2], "world_s": o2_s})
    require(all(all(v.values()) for v in o2_ok.values()),
            f"O2 failed: {o2_ok}")

    # O3: attacked = clean bitwise, every rank alike; one device's loss at
    # 1e-6, its gradients at 1e-5 of each leaf's largest magnitude (the
    # batch split sums each weight gradient's 8,192 rows as two halves
    # and an all-reduce: 4.1e-6 of it on an H100)
    o3, o3_s = _lm_mesh_world("O3", out_dir)
    n3 = LM_MESH_LAYERS["O3"]
    want3 = lm_counts(moe_gemm=9 * n3, flash_attention=n3,
                      flash_attention_bwd=n3, redundancy_vote=n3)
    cmp3 = [r["vs_one_device"] for r in o3]
    o3_ok = {"attacked_is_clean": all(
                 r["minority"]["losses"] == r["clean"]["losses"]
                 and r["minority"]["params"] == r["clean"]["params"]
                 for r in o3),
             "ranks_agree": all(r["clean"]["params"] == o3[0]["clean"][
                 "params"] for r in o3),
             "loss_vs_one_device": all(
                 abs(c["loss_mesh"] - c["loss_one_device"])
                 <= 1e-6 * abs(c["loss_one_device"]) for c in cmp3),
             "grads_vs_one_device": all(c["max_rel_diff"] <= 1e-5
                                        for c in cmp3),
             "launches": all(r[w]["launches"] == want3 for r in o3
                             for w in ("clean", "minority"))}
    emit({"phase": "lm_mesh", "path": "O3", "model": "bmoe-paper "
          "(faithful, r = 2)", "mesh": {"data": 2, "replica": 2, "model": 1},
          "reduced": f"{LM_MESH_LAYERS['O3']} of 12 layers",
          "steps": "2 of (4, 2048)",
          "checks": o3_ok, "losses_rank0": o3[0]["clean"]["losses"],
          "vs_one_device": cmp3,
          "walls_ms_rank0": {w: o3[0][w]["walls_ms"]
                             for w in ("clean", "minority")},
          "launches_rank0": o3[0]["clean"]["launches"], "want": want3,
          "wire_bytes_rank0": o3[0]["clean"]["wire"],
          "step_peak_gb": [r["clean"]["step_peak_gb"] for r in o3],
          "peak_gb": [r["peak_gb"] for r in o3], "world_s": o3_s})
    require(all(o3_ok.values()), f"O3 failed: {o3_ok}")

    # O4: EP training against one device (the attention, the shared
    # expert and the vocabulary tensor-parallel over model = 2: the
    # gradients at 1e-5 of each leaf's largest magnitude)
    o4, o4_s = _lm_mesh_world("O4", out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    n4 = LM_MESH_LAYERS["O4"]
    want4 = lm_counts(moe_gemm=9 * n4, flash_attention=n4,
                      flash_attention_bwd=n4)
    cmp4 = [r["vs_one_device"] for r in o4]
    o4_ok = {"loss_vs_one_device": all(
                 abs(c["loss_mesh"] - c["loss_one_device"])
                 <= 1e-6 * abs(c["loss_one_device"]) for c in cmp4),
             "grads_vs_one_device": all(c["max_rel_diff"] <= 1e-5
                                        for c in cmp4),
             "launches": all(r["launches"] == want4 for r in o4)}
    emit({"phase": "lm_mesh", "path": "O4", "model": "qwen2-moe-a2.7b",
          "mesh": {"data": 1, "model": 2}, "reduced": f"{n4} of 24 layers",
          "step": "1 x 2048, capacity factor 8", "checks": o4_ok,
          "vs_one_device": cmp4,
          "grads_bitwise": all(c["leaves_bitwise"] == c["leaves"]
                               for c in cmp4),
          "walls_ms_rank0": {"loss_and_grads": o4[0][
                                 "loss_and_grads_wall_ms"],
                             "step": o4[0]["step_wall_ms"],
                             "one_device_loss_and_grads": cmp4[0][
                                 "one_device_wall_ms"]},
          "step_peak_gb": [r["step_peak_gb"] for r in o4],
          "launches_rank0": o4[0]["launches"], "want": want4,
          "wire_bytes_rank0": o4[0]["wire"],
          "peak_gb": [r["peak_gb"] for r in o4], "world_s": o4_s,
          "path_s": time.perf_counter() - t_start})
    require(all(o4_ok.values()), f"O4 failed: {o4_ok}")
    return {"O1": o1[0]["launches"],
            "O2_faithful": o2[0]["faithful"]["launches"],
            "O2_digest": o2[0]["digest"]["launches"],
            "O3": o3[0]["clean"]["launches"], "O4": o4[0]["launches"],
            "O1_wire": o1[0]["wire"], "gemm": gemm, "vote": vote}


# ------------------------------------- path P: the dry run, held to runs
P1_ROWS = []          # P1's checks, made inside paths C, H and L1


def dryrun_p1(torch, ops, sub: str, cfg, params, batch):
    """P1 on weights in memory (``sub``: the path that holds them): the
    dry run of the same step on the meta device (``launch.dryrun``, one
    device, remat off, as the paths run it) against one counted run on
    the card (``launch.opanalysis``, untimed): dot FLOPs equal by route
    and kernel, kernel calls equal the launches, argument bytes equal
    the tensors the run holds.  Then one run timed by CUDA events (a
    training step updates the weights in place: P1 runs last in its
    path), for the achieved TFLOP/s and the roofline share; the
    estimated peak beside ``max_memory_allocated``.  The launch counts
    are set to 0 around the counted run and left at 0 (each path sets
    its own to 0 before it runs)."""
    from repro_torch.launch import dryrun, roofline
    from repro_torch.optim import adamw
    t0 = time.perf_counter()
    kind = "train" if "labels" in batch else "prefill"
    B, S = batch["tokens"].shape
    rec = dryrun.run_one(cfg.name, dict(kind=kind, seq=S, batch=B),
                         mesh_shape=None, cfg=cfg, remat=False,
                         verbose=False)
    step = dryrun.make_step_fn(cfg, kind, remat=False)
    opt = adamw.init(params) if kind == "train" else None
    held = dryrun.nbytes((params, opt, (batch,)))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    real = dryrun.count_step(step, params, opt, (batch,))
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    launches = {k: v for k, v in ops.launch_counts().items() if v}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    step(params, *(() if opt is None else (opt,)), batch)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    ops.reset_launch_counts()
    row = roofline.roofline_row(rec)
    bound_ms = max(row["compute_s"], row["memory_s"]) * 1e3
    out = {"phase": "dryrun", "path": "P1", "in_path": sub,
           "model": cfg.name, "step": kind, "batch": [B, S], "card": CARD,
           "dot_flops": {"meta": rec["dot_flops"], "cuda": real.dot_flops},
           "dot_flops_by_route": {"meta": rec["dot_flops_by_route"],
                                  "cuda": real.dot_flops_by_route},
           "kernel_flops": {"meta": rec["kernel_flops"],
                            "cuda": real.kernel_flops},
           "kernel_calls_meta": rec["kernel_calls"],
           "launches_cuda": launches,
           "argument_bytes": {"meta": rec["argument_size_in_bytes"],
                              "cuda": held},
           "peak_gb": {"estimate_meta": rec["peak_bytes_estimate"] / 1e9,
                       "max_memory_allocated_step":
                           (held + grew) / 1e9},
           "device_ms_cuda_events": ms,
           "achieved_tflops": real.dot_flops / (ms / 1e3) / 1e12,
           "roofline_ms": {"compute": row["compute_s"] * 1e3,
                           "memory": row["memory_s"] * 1e3,
                           "dominant": row["dominant"]},
           "roofline_share": bound_ms / ms,
           "meta_run_s": rec["run_s"], "p1_s": time.perf_counter() - t0}
    P1_ROWS.append(out)
    ok = {"dot_flops": rec["dot_flops"] == real.dot_flops > 0,
          "by_route": rec["dot_flops_by_route"] == real.dot_flops_by_route,
          "by_kernel": rec["kernel_flops"] == real.kernel_flops,
          "calls_are_launches": rec["kernel_calls"] == launches,
          "argument_bytes": rec["argument_size_in_bytes"] == held}
    out["checks"] = ok
    require(all(ok.values()), f"P1 ({sub}) dry run against the card: {ok}")


def dryrun_path(torch, o1_wire, p1_s: float):
    """Path P: P1's checks (made in paths C, H and L1) and P2, O1's
    configuration on the abstract (1, 4) mesh as rank 0: its bytes by
    exchange equal what O1's rank 0 sent."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    for row in P1_ROWS:
        emit(row)
    require(sorted(r["in_path"] for r in P1_ROWS) == ["C", "H", "L1"],
            f"P1 ran in {[r['in_path'] for r in P1_ROWS]}")
    cfg = lm_mesh_cfg("O1")
    rec = dryrun.run_one(cfg.name, dict(kind="prefill", seq=4096, batch=1),
                         cfg=cfg, mesh_shape=LM_MESH_SHAPES["O1"], rank=0,
                         verbose=False)
    ok = rec["wire_bytes"] == o1_wire
    emit({"phase": "dryrun", "path": "P2", "model": cfg.name,
          "mesh": {"data": 1, "model": 4},
          "reduced": f"{LM_MESH_LAYERS['O1']} of 24 layers",
          "prefill": "1 x 4096, capacity factor 8",
          "wire_bytes": {"abstract_rank0": rec["wire_bytes"],
                         "o1_rank0": o1_wire},
          "collective_bytes": rec["collective_bytes"],
          "collective_counts": rec["collective_counts"],
          "dot_flops_rank0": rec["dot_flops"],
          "argument_bytes_rank0": rec["argument_size_in_bytes"],
          "peak_estimate_gb_rank0": rec["peak_bytes_estimate"] / 1e9,
          "checks": {"wire_bytes_equal": ok},
          "path_s": p1_s + time.perf_counter() - t0})
    require(ok, f"P2: the abstract mesh's bytes {rec['wire_bytes']} are "
                f"not O1's {o1_wire}")


def dryrun_alone(torch, ops):
    """``--dryrun``: path P by itself, each model initialised here from
    seed 0 and O1's world run again for its rank 0's bytes."""
    from repro_torch.configs import get_config
    from repro_torch.train.loop import init_model
    t0 = time.perf_counter()
    for sub, arch in (("C", "qwen2.5-3b"), ("H", "qwen2-moe-a2.7b"),
                      ("L1", "bmoe-paper")):
        cfg = get_config(arch)
        params = init_model(cfg, 0)
        batch = (_lm_train_batch(torch, cfg, 2, 2048) if sub == "L1"
                 else prefill_batch(torch, cfg, 4096))
        dryrun_p1(torch, ops, sub, cfg, params, batch)
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
    p1_s = time.perf_counter() - t0
    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", f"dryrun-{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    o1, _ = _lm_mesh_world("O1", out_dir)
    shutil.rmtree(out_dir, ignore_errors=True)
    dryrun_path(torch, o1[0]["wire"], p1_s)


# ------------------------- path Q: decode and the serving engine on a mesh
Q_SHAPES = {"Q1": (1, 4), "Q2": (2, 2)}
Q1_PROMPTS = (16, 96, 40, 64, 24, 80)     # 6 requests through 4 slots
Q1_NEW = 16
Q2_CACHE, Q2_FILL, Q2_STEPS = 131072, 120000, 8
Q2_BLOCK = 4096                             # positions a fill draw covers
Q2_LAYERS = 2                               # 8 before path R joined


def decode_mesh_cfg(sub: str):
    """Q1: qwen2-moe-a2.7b at full width, 1 of 24 layers (each rank's
    edge store holds and hashes every routed expert of every layer: 2.1
    GB a layer), capacity factor 8; Q2: qwen2.5-3b, 2 of 36 layers, as a
    batch-1 decode sets it (the cache over data x model, the batch not
    split)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import shape_config
    if sub == "Q1":
        return _cut(get_config("qwen2-moe-a2.7b"), 1, capacity_factor=8.0)
    return shape_config(_cut(get_config("qwen2.5-3b"), Q2_LAYERS),
                        dict(kind="decode", seq=Q2_CACHE, batch=1))


def q1_requests(cfg):
    import numpy as np
    rng = np.random.default_rng(7)
    return [{"id": i, "prompt": rng.integers(0, cfg.vocab_size, n).astype(
        np.int32), "max_new_tokens": Q1_NEW}
        for i, n in enumerate(Q1_PROMPTS)]


def q1_serve(torch, ops, cfg, params, mesh):
    """Q1's engine (4 slots, cache 4,096, chunks up to 16, verified
    sessions, edge expert storage with an unbounded cache (a budget makes
    every macro-step fetch and hash evicted experts again: 54 s of a
    4-layer engine run on an H100's host) and KV paging in the same
    store) serving ``q1_requests`` to the end; what the path compares,
    its launches and walls."""
    from repro_torch.serve.engine import EdgeStorageConfig, ServingEngine
    from repro_torch.storage.kv import KVStorageConfig
    t0 = time.perf_counter()
    eng = ServingEngine(
        cfg, params, mesh=mesh, batch_slots=4, cache_len=4096,
        prefill_chunk=16, trust=_k_trust(4),
        expert_storage=EdgeStorageConfig(chunk_bytes=1 << 22),
        kv_storage=KVStorageConfig(block_tokens=16))
    register_s = time.perf_counter() - t0
    eng.submit(q1_requests(cfg))
    if mesh is not None:
        mesh.wire_bytes.clear()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rep = eng.report()
    meta = eng.request_meta
    out = {"done": {k: list(map(int, v)) for k, v in done.items()},
           "ticks": [(t.tick, t.root, tuple(t.request_ids), bool(t.kv_root))
                     for t in eng.tick_commitments],
           "kv_roots": [t.kv_root for t in eng.tick_commitments],
           "cids": list(eng.kvrt.kv.sealed_cids()),
           "edge": rep["edge"], "kv": rep["kv"],
           "admitted_tick": [meta[i]["admitted_tick"]
                             for i in range(len(Q1_PROMPTS))],
           "launches": ops.launch_counts(), "micro_steps": eng.micro_steps,
           "macro_steps": eng.steps, "wall_s": wall,
           "register_s": register_s,
           "wire": dict(mesh.wire_bytes) if mesh is not None else {}}
    del eng
    gc.collect()
    return out


def q2_fill(torch, caches, lo: int):
    """Positions [lo, lo + the part's length) below ``Q2_FILL`` of every
    leaf of a Q2 cache part, drawn per ``Q2_BLOCK`` positions from a
    generator seeded by the leaf and the block (a part's values are the
    whole cache's at its positions, whichever rank draws them)."""
    from repro_torch.core.ledger import tree_flatten
    for li, t in enumerate(tree_flatten(caches)[0]):
        n = t.shape[2]
        for p0 in range(lo, min(lo + n, Q2_FILL), Q2_BLOCK):
            g = torch.Generator("cuda").manual_seed(1_000_003 * li
                                                    + p0 // Q2_BLOCK)
            shape = t.shape[:2] + (Q2_BLOCK,) + t.shape[3:]
            k = min(Q2_BLOCK, Q2_FILL - p0)
            t[:, :, p0 - lo:p0 - lo + k] = torch.randn(
                shape, generator=g, device=t.device)[:, :, :k]


def q2_slices(torch, caches, parts: int, lo: int = 0):
    """Per part of ``parts`` equal position ranges of a Q2 cache holding
    positions from ``lo`` on (the whole one, or a rank's with ``parts`` =
    1): the decoded rows (host) and a fingerprint of the rest (the
    filled and empty positions)."""
    from repro_torch.core.ledger import tree_flatten
    out = []
    leaves = tree_flatten(caches)[0]
    n = leaves[0].shape[2] // parts
    for r in range(parts):
        rows, prints = [], []
        for t in leaves:
            part = t[:, :, r * n:(r + 1) * n].clone()
            a = max(Q2_FILL - lo - r * n, 0)
            b = min(Q2_FILL + Q2_STEPS - lo - r * n, n)
            if a < b:
                rows.append(part[:, :, a:b].cpu())
                part[:, :, a:b] = 0
            prints.append(fingerprint(torch, part))
        out.append({"rows": rows, "fingerprint": prints})
    return out


def q2_decode(torch, cfg, params, mesh):
    """Q2: the cache of ``Q2_CACHE`` positions (the rank's part on a
    mesh) filled up to ``Q2_FILL``, then ``Q2_STEPS`` decode steps at
    positions ``Q2_FILL`` on: each step's logits (by ``forward_decode``
    on the step's input caches) and next token (by ``make_decode_step``),
    its wall, the first step's bytes by exchange, and the cache's
    slices."""
    import numpy as np
    from repro_torch.models import transformer as tfm
    from repro_torch.models.builder import materialize
    from repro_torch.sharding import place_cache, step_sharder
    from repro_torch.train.step import make_decode_step
    caches = materialize(place_cache(tfm.cache_decl(cfg, 1, Q2_CACHE), cfg,
                                     mesh), 0, "cuda")
    lo = 0
    if mesh is not None:
        lo = mesh.cache_group(cfg).span(Q2_CACHE)[0]
    q2_fill(torch, caches, lo)
    step = make_decode_step(cfg, mesh=mesh)
    shard = step_sharder(cfg, mesh, "decode")
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, Q2_STEPS)
    out = {"next": [], "logits": [], "walls_ms": [], "wire_step": None}
    for t in range(Q2_STEPS):
        batch = {"tokens": torch.tensor([[int(toks[t])]], device="cuda"),
                 "pos": Q2_FILL + t}
        with torch.no_grad():
            logits = tfm.gather_vocab(tfm.forward_decode(
                params, caches, batch["tokens"], batch["pos"], cfg,
                shard=shard)[0], shard)
        out["logits"].append(logits[0, -1].cpu())
        if mesh is not None:
            mesh.wire_bytes.clear()
        nxt, wall = _timed(torch, lambda: step(params, caches, batch))
        nxt, caches = nxt
        if mesh is not None and t == 0:
            out["wire_step"] = dict(mesh.wire_bytes)
        out["next"].append(int(nxt[0]))
        out["walls_ms"].append(wall)
    out["slices"] = q2_slices(torch, caches, 1 if mesh is not None else
                              math.prod(Q_SHAPES["Q2"]), lo)
    del caches
    gc.collect()
    torch.cuda.empty_cache()
    return out


def decode_mesh_rank(rank: int, world: int, out_dir: str) -> None:
    """One rank of path Q's world of 4 (spawned by ``spawn_edges``, its
    process group and card set): Q1 on (1, 4), then Q2 on (2, 2), each
    with its launch counts from 0; results to ``<out_dir>/Q-rank<r>.pkl``.
    It prints nothing."""
    import pickle

    import torch
    from repro_torch.kernels import build, ops
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.train.loop import init_model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    res = {}
    for sub in ("Q1", "Q2"):
        mesh = make_lm_mesh(Q_SHAPES[sub], ("data", "model"))
        cfg = decode_mesh_cfg(sub)
        params = init_model(cfg, 0, mesh.device, mesh=mesh, kind="decode")
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        if sub == "Q1":
            res[sub] = q1_serve(torch, ops, cfg, params, mesh)
        else:
            res[sub] = q2_decode(torch, cfg, params, mesh)
            res[sub]["launches"] = ops.launch_counts()
            res[sub]["position_range"] = mesh.cache_group(cfg).span(
                Q2_CACHE)
        res[sub]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del params
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(out_dir, f"Q-rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def decode_mesh_kernel_cases(torch, mg, ref):
    """``moe_gemm`` at a Q1 rank's decode shape: its E_l = 16 experts'
    rows from 4 model ranks of ``ep_capacity`` (8) each, at the model's
    fan-in weight scale."""
    from repro_torch.models.moe_ep import ep_capacity
    cfg = decode_mesh_cfg("Q1")
    m = Q_SHAPES["Q1"][1]
    e_l = cfg.resolved_padded_experts // m
    rows = m * ep_capacity(cfg, 1)       # 4 slots: one token a model rank
    d, f = cfg.d_model, cfg.moe_d_ff
    return [check_moe_gemm(torch, mg, ref, 90, "lm_decode_mesh_gate_up",
                           e_l, rows, d, f, torch.float32,
                           w_scale=d ** -0.5),
            check_moe_gemm(torch, mg, ref, 91, "lm_decode_mesh_down", e_l,
                           rows, f, d, torch.float32, w_scale=f ** -0.5)]


def decode_mesh_path(torch, np, ops, mg, ref):
    """Path Q: decode and the serving engine on a mesh, four ranks on the
    card over gloo, each one-device reference run here first.  Q1, the
    engine on (1, 4); Q2, batch-1 long-context decode on (2, 2) with the
    cache over data x model; Q3, each rank's launches held to the
    records (3 ``moe_gemm`` a MoE layer a micro-step, no flash), the
    kernel at a rank's decode shape, bytes and walls; P3, Q2's step on
    the abstract (2, 2) mesh books Q2 rank 0's bytes."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import spawn_edges
    from repro_torch.train.loop import init_model
    t_start = time.perf_counter()
    gemm = decode_mesh_kernel_cases(torch, mg, ref)

    cfg1, cfg2 = decode_mesh_cfg("Q1"), decode_mesh_cfg("Q2")
    params = init_model(cfg1, 0)
    one1 = q1_serve(torch, ops, cfg1, params, None)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = init_model(cfg2, 0)
    ops.reset_launch_counts()
    one2 = q2_decode(torch, cfg2, params, None)
    one2["launches"] = ops.launch_counts()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t_start

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", f"decode-mesh-{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    import pickle
    spawn_edges(decode_mesh_rank, 4, args=(out_dir,), device="cuda",
                rendezvous_dir=out_dir, timeout_s=300)
    res = []
    for r in range(4):
        with open(os.path.join(out_dir, f"Q-rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    world_s = time.perf_counter() - t0

    # Q1: the one-device engine's streams, commitments and report (the
    # sealed KV blocks' CIDs hash the cache's bytes, which tensor
    # parallelism over model rounds otherwise: their count is held, and
    # the CIDs equal on every rank)
    keys = ("done", "ticks", "edge", "kv")
    n_moe = _k_moe_layers(cfg1)
    q1 = [r["Q1"] for r in res]
    want1 = lm_counts(moe_gemm=3 * n_moe * one1["micro_steps"])
    q1_ok = {"equal_one_device": all(q[k] == one1[k] for q in q1
                                     for k in keys),
             "sealed_blocks": all(len(q["cids"]) == len(one1["cids"])
                                  for q in q1),
             "ranks_identical": all(
                 all(q[k] == q1[0][k] for k in keys + ("cids", "kv_roots"))
                 for q in q1),
             "two_admitted_mid_run": sorted(q1[0]["admitted_tick"])[-2] > 0,
             "launches": one1["launches"] == want1 and all(
                 q["launches"] == want1 for q in q1)}
    emit({"phase": "decode_mesh", "path": "Q1", "model": cfg1.name,
          "mesh": {"data": 1, "model": 4}, "card": CARD,
          "reduced": "1 of 24 layers, capacity factor 8",
          "engine": "4 slots, cache 4096, chunks up to 16, verified "
                    "sessions, edge expert storage (unbounded cache) and "
                    "KV paging (blocks of 16) in one store",
          "requests": [list(Q1_PROMPTS), Q1_NEW], "checks": q1_ok,
          "admitted_tick": q1[0]["admitted_tick"],
          "micro_steps": one1["micro_steps"],
          "macro_steps": one1["macro_steps"],
          "sealed_blocks": len(one1["cids"]),
          "cids_equal_one_device": sum(
              a == b for a, b in zip(q1[0]["cids"], one1["cids"])),
          "kv_roots_equal_one_device": sum(
              a == b for a, b in zip(q1[0]["kv_roots"], one1["kv_roots"])),
          "walls_s": {"one_device": one1["wall_s"],
                      "mesh_rank0": q1[0]["wall_s"]},
          "register_s": {"one_device": one1["register_s"],
                         "mesh_rank0": q1[0]["register_s"]},
          "launches_rank0": q1[0]["launches"], "want": want1,
          "wire_bytes_rank0": q1[0]["wire"],
          "peak_gb": [r["Q1"]["peak_gb"] for r in res]})
    require(all(q1_ok.values()), f"Q1 failed: {q1_ok}")

    # Q2: tokens equal, logits within 1e-5 of the largest magnitude, each
    # rank's part of the cache the one-device cache's part
    q2 = [r["Q2"] for r in res]
    scale = max(float(l.abs().max()) for l in one2["logits"])
    diff = max(float((a - b).abs().max()) for q in q2
               for a, b in zip(q["logits"], one2["logits"]))
    parts = one2["slices"]
    rows_diff, prints_equal = 0.0, True
    for q in q2:
        idx = q["position_range"][0] // (Q2_CACHE // len(parts))
        mine, want = q["slices"][0], parts[idx]
        prints_equal &= mine["fingerprint"] == want["fingerprint"]
        for a, b in zip(mine["rows"], want["rows"]):
            rows_diff = max(rows_diff, float((a - b).abs().max()))
    cache_scale = max(float(b.abs().max()) for p in parts
                      for b in p["rows"])
    q2_ok = {"tokens": all(q["next"] == one2["next"] for q in q2),
             "logits": diff <= 1e-5 * scale,
             "cache_parts_untouched_bitwise": prints_equal,
             "decoded_rows": rows_diff <= 1e-5 * cache_scale,
             "launches": one2["launches"] == lm_counts() and all(
                 q["launches"] == lm_counts() for q in q2)}
    emit({"phase": "decode_mesh", "path": "Q2", "model": cfg2.name,
          "mesh": {"data": 2, "model": 2}, "card": CARD,
          "reduced": f"{Q2_LAYERS} of 36 layers",
          "cache": f"{Q2_CACHE} positions ({Q2_CACHE // 4} a rank over "
                   f"data x model), filled to {Q2_FILL}, {Q2_STEPS} steps",
          "checks": q2_ok, "next": one2["next"],
          "max_abs_logit_diff": diff, "max_abs_logit": scale,
          "max_abs_decoded_row_diff": rows_diff,
          "walls_ms": {"one_device": one2["walls_ms"],
                       "mesh_rank0": q2[0]["walls_ms"]},
          "wire_bytes_rank0_step": q2[0]["wire_step"],
          "launches_rank0": q2[0]["launches"],
          "peak_gb": [r["Q2"]["peak_gb"] for r in res]})
    require(all(q2_ok.values()), f"Q2 failed: {q2_ok}")

    # P3: Q2's configuration on the abstract (2, 2) mesh as rank 0
    rec = dryrun.run_one(cfg2.name, dict(kind="decode", seq=Q2_CACHE,
                                         batch=1), cfg=cfg2,
                         mesh_shape=Q_SHAPES["Q2"], rank=0, verbose=False)
    p3 = rec["wire_bytes"] == q2[0]["wire_step"]
    emit({"phase": "dryrun", "path": "P3", "model": cfg2.name,
          "mesh": {"data": 2, "model": 2},
          "reduced": f"{Q2_LAYERS} of 36 layers",
          "decode": f"1 x 1 over a cache of {Q2_CACHE}",
          "wire_bytes": {"abstract_rank0": rec["wire_bytes"],
                         "q2_rank0": q2[0]["wire_step"]},
          "argument_bytes_rank0": rec["argument_size_in_bytes"],
          "jax_argument_bytes_rank0": rec["jax_argument_size_in_bytes"],
          "checks": {"wire_bytes_equal": p3}})
    require(p3, f"P3: the abstract mesh's bytes {rec['wire_bytes']} are "
                f"not Q2 rank 0's {q2[0]['wire_step']}")
    emit({"phase": "decode_mesh", "path": "Q3", "card": CARD,
          "launches_by_rank": {"Q1": [q["launches"] for q in q1],
                               "Q2": [q["launches"] for q in q2]},
          "one_device_s": one_s, "world_s": world_s,
          "path_s": time.perf_counter() - t_start})
    return {"Q1": q1[0]["launches"], "Q1_one_device": one1["launches"],
            "Q1_micro_steps": one1["micro_steps"], "gemm": gemm}


# --------------------- path R: FSDP placement and tensor parallelism
R_SHAPES = {"R1": (2, 2), "R2": ((1, 4), (2, 2)), "R3": (1, 4)}
R1_BATCH = (2, 2048)
R2_BATCH = (2, 2048)
R3_BATCH, R3_CACHE, R3_STEPS = 4, 4096, 64
R3_POS = (1000, 1990, 3050, 4000)       # rows crossing the ranks' parts
R3_LOGITS_EVERY = 4                      # steps whose whole logits are held
R_ROUTE_MARGIN = 1e-5


def tp_cfg(sub: str):
    """Path R's configs at full width: R1 qwen3-32b, 2 of 64 layers, one
    microbatch (the config's 8 are for train_4k's batch of 256); R2
    bmoe-paper, 2 of 12 layers, its vote off (these meshes have no
    replica axis); R3 qwen3-32b, 4 of 64 layers, as a batched decode
    sets it (the cache's positions over ``model``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import shape_config
    from repro_torch.models.config import RedundancyConfig
    if sub == "R1":
        return _cut(get_config("qwen3-32b"), 2, train_microbatches=1)
    if sub == "R2":
        return _cut(get_config("bmoe-paper"), 2,
                    redundancy=RedundancyConfig(mode="off"))
    return shape_config(_cut(get_config("qwen3-32b"), 4),
                        dict(kind="decode", seq=R3_CACHE, batch=R3_BATCH))


class RoutingRecorder:
    """``moe.top_k`` and ``moe.capacity_positions`` wrapped inside a
    ``with`` block: each routing's top-k margin (the k-th probability
    less the next) and its expert ids, positions and keep flags, in call
    order, on the host."""

    def __init__(self, k: int):
        self.k, self.margins, self.routes = k, [], []

    def __enter__(self):
        from repro_torch.models import moe
        self.moe = moe
        self.top, self.cap = moe.top_k, moe.capacity_positions

        def top_k(probs, k):
            vals = probs.sort(dim=-1, descending=True).values
            self.margins.append((vals[..., k - 1] - vals[..., k]).cpu())
            return self.top(probs, k)

        def capacity_positions(eid, n, capacity):
            out = self.cap(eid, n, capacity)
            self.routes.append((eid.cpu(), out[0].cpu(), out[1].cpu()))
            return out

        moe.top_k, moe.capacity_positions = top_k, capacity_positions
        return self

    def __exit__(self, *exc):
        self.moe.top_k, self.moe.capacity_positions = self.top, self.cap


def _routes_equal(got, want, margins, k: int):
    """Per MoE layer: (assignments that differ, those of them on a token
    whose one-device top-k margin is under ``R_ROUTE_MARGIN``)."""
    out = []
    for g, w, m in zip(got, want, margins):
        diff = torch_any_row(g, w)
        tok = diff.reshape(diff.shape[0], -1, k).any(-1)
        near = m.reshape(tok.shape) < R_ROUTE_MARGIN
        out.append((int(tok.sum()), int((tok & near).sum())))
    return out


def torch_any_row(g, w):
    """Where (expert id, position, keep) of two routings differ."""
    return (g[0] != w[0]) | (g[1] != w[1]) | (g[2] != w[2])


def r_fill(torch, caches, lo: int):
    """R3's caches: every position of the rank's part (from ``lo``)
    drawn per 1,024 positions from a generator seeded by the leaf and
    the block, so a part is the whole cache's at its positions."""
    from repro_torch.core.ledger import tree_flatten
    for li, t in enumerate(tree_flatten(caches)[0]):
        n = t.shape[2]
        for p0 in range(lo, lo + n, 1024):
            g = torch.Generator("cuda").manual_seed(7_000_003 * li
                                                    + p0 // 1024)
            t[:, :, p0 - lo:p0 - lo + 1024] = torch.randn(
                t.shape[:2] + (1024,) + t.shape[3:], generator=g,
                device=t.device)


def r3_decode(torch, cfg, params, mesh):
    """R3's ``R3_STEPS`` decode steps of a batch of 4 from ``R3_POS`` on,
    the caches drawn by ``r_fill``: per step the next tokens of
    ``make_decode_step`` and, every ``R3_LOGITS_EVERY`` steps, the whole
    logits of ``forward_decode`` on the step's input (host); walls;
    launches."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.models.builder import materialize
    from repro_torch.sharding import place_cache, step_sharder
    from repro_torch.train.step import make_decode_step
    caches = materialize(place_cache(tfm.cache_decl(cfg, R3_BATCH,
                                                    R3_CACHE), cfg, mesh),
                         0, "cuda")
    lo = 0 if mesh is None else mesh.cache_group(cfg).span(R3_CACHE)[0]
    r_fill(torch, caches, lo)
    step = make_decode_step(cfg, mesh=mesh)
    shard = step_sharder(cfg, mesh, "decode")
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                             (R3_STEPS, R3_BATCH))
    out = {"next": [], "logits": [], "walls_ms": []}
    ops.reset_launch_counts()
    for t in range(R3_STEPS):
        batch = {"tokens": torch.tensor(toks[t], device="cuda")[:, None],
                 "pos": torch.tensor(R3_POS, device="cuda") + t}
        if t % R3_LOGITS_EVERY == 0:
            with torch.no_grad():
                logits = tfm.gather_vocab(tfm.forward_decode(
                    params, caches, batch["tokens"], batch["pos"], cfg,
                    shard=shard)[0], shard)
            out["logits"].append(logits[:, -1].cpu())
        (nxt, caches), wall = _timed(torch, lambda: step(params, caches,
                                                         batch))
        out["next"].append(nxt.tolist())
        out["walls_ms"].append(wall)
    out["launches"] = ops.launch_counts()
    del caches
    return out


def r2_prefill(torch, cfg, params, tokens, mesh):
    """R2's prefill: the whole logits at every 16th position and the last
    (host), the next tokens of ``make_prefill_step``, the routing of the
    rank's rows, launches and walls."""
    from repro_torch.kernels import ops
    from repro_torch.train.step import make_prefill_step
    lo, hi = (0, tokens.shape[0]) if mesh is None else \
        mesh.batch_rows(tokens.shape[0])
    rows = list(range(0, tokens.shape[1], 16)) + [tokens.shape[1] - 1]
    with RoutingRecorder(cfg.num_experts_per_tok) as rec:
        logits = _mesh_logits(torch, cfg, params, tokens[lo:hi], mesh,
                              rows=rows)
    out = {"rows": logits.cpu(), "batch_rows": (lo, hi),
           "routes": rec.routes, "margins": rec.margins}
    del logits
    step = make_prefill_step(cfg, mesh)
    ops.reset_launch_counts()
    (nxt, wall) = _timed(torch, lambda: step(params, {"tokens": tokens}))
    out.update(next=nxt.tolist(), launches=ops.launch_counts(),
               wall_ms=wall)
    return out


def r2_moe_layer(torch, cfg, mesh):
    """R2's bitwise case on (2, 2), the experts over model (5 of 10 a
    rank): MoE layer 0 on this rank's placed leaves against the whole
    layer on the same rows (the dispatch, each expert's rows and the
    combine are the one-device layer's bits)."""
    from repro_torch.models import moe as moe_lib
    from repro_torch.sharding import shard_params, step_sharder
    from repro_torch.train.loop import init_model
    whole = init_model(cfg, 0, mesh.device)
    mine = shard_params(whole, cfg, mesh, "prefill")
    layer = {k: v[0] for k, v in whole["blocks"]["0"]["moe"].items()}
    placed = {k: v[0] for k, v in mine["blocks"]["0"]["moe"].items()}
    g = torch.Generator("cuda").manual_seed(11)
    x = torch.randn(R2_BATCH + (cfg.d_model,), generator=g, device="cuda")
    lo, hi = mesh.batch_rows(R2_BATCH[0])
    with torch.no_grad():
        y1, _ = moe_lib.moe_mlp(layer, x[lo:hi], cfg)
        y2, _ = moe_lib.moe_mlp(placed, x[lo:hi], cfg,
                                shard=step_sharder(cfg, mesh, "prefill"))
    return {"bitwise": bool(torch.equal(y1, y2)),
            "experts_a_rank": placed["w_gate"].shape[0]}


def tp_rank(rank: int, world: int, out_dir: str) -> None:
    """One rank of path R's world of 4 (spawned by ``spawn_edges``): R1's
    training step on (2, 2), R2's prefills on (1, 4) and (2, 2) and its
    MoE layer, R3's decode on (1, 4); results to
    ``<out_dir>/R-rank<r>.pkl``.  It prints nothing."""
    import pickle

    import torch
    from repro_torch.kernels import build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    try:
        res = _tp_rank_cases(torch, ops, out_dir)
    except BaseException:
        # every rank's own error (spawn reports only the first to fail)
        import traceback
        with open(os.path.join(out_dir, f"R-rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(out_dir, f"R-rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _tp_rank_cases(torch, ops, out_dir: str) -> dict:
    """``tp_rank``'s cases on this rank; returns what the parent checks."""
    from repro_torch.launch.dryrun import nbytes
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import apply_update, make_loss_and_grads
    res = {}
    # R1: one FSDP + TP training step, its bytes, memory and launches
    cfg = tp_cfg("R1")
    mesh = make_lm_mesh(R_SHAPES["R1"], ("data", "model"))
    batch = _lm_train_batch(torch, cfg, *R1_BATCH)
    params = init_model(cfg, 0, mesh.device, mesh=mesh)
    state = adamw.init(params)
    placed = nbytes((params, state))
    torch.cuda.empty_cache()          # the whole leaves drawn and cut
    free_gb = torch.cuda.mem_get_info()[0] / 1e9
    loss_and_grads = make_loss_and_grads(cfg, remat=True, mesh=mesh)
    opt_cfg = adamw.AdamWConfig(total_steps=1000)

    def step():                       # make_train_step's two calls
        loss, _, g = loss_and_grads(params, batch)
        return loss, g, apply_update(opt_cfg, cfg, params, state, g,
                                     mesh)[2]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    mesh.wire_bytes.clear()
    (loss, g, m), wall = _timed(torch, step)
    r1 = {"placed_bytes": placed, "wall_ms": wall,
          "card_free_before_step_gb": free_gb,
          "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
          "launches": ops.launch_counts(), "wire": dict(mesh.wire_bytes),
          "loss": float(loss), "grad_norm": float(m["grad_norm"])}
    del params, state
    gc.collect()
    torch.cuda.empty_cache()
    cmp, _ = _grads_vs_one_device(torch, cfg, mesh, g, batch)
    r1["vs_one_device"] = {**cmp, "loss_mesh": float(loss)}
    del g
    gc.collect()
    torch.cuda.empty_cache()
    res["R1"] = r1
    # R2: the gspmd MoE prefill, moe_ff over model on (1, 4), the
    # experts over model on (2, 2)
    cfg = tp_cfg("R2")
    tokens = prefill_batch_rows(torch, cfg, *R2_BATCH)
    for shape in R_SHAPES["R2"]:
        mesh = make_lm_mesh(shape, ("data", "model"))
        params = init_model(cfg, 0, mesh.device, mesh=mesh, kind="prefill")
        res[f"R2/{shape}"] = r2_prefill(torch, cfg, params, tokens, mesh)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    res["R2/layer"] = r2_moe_layer(torch, cfg, mesh)
    gc.collect()
    torch.cuda.empty_cache()
    # R3: tensor-parallel decode
    cfg = tp_cfg("R3")
    mesh = make_lm_mesh(R_SHAPES["R3"], ("data", "model"))
    params = init_model(cfg, 0, mesh.device, mesh=mesh, kind="decode")
    torch.cuda.reset_peak_memory_stats()
    res["R3"] = r3_decode(torch, cfg, params, mesh)
    res["R3"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["R3"]["wire"] = dict(mesh.wire_bytes)
    return res


def prefill_batch_rows(torch, cfg, B: int, S: int):
    """(B, S) prefill tokens from ``lm_batches``, on the card."""
    return _lm_train_batch(torch, cfg, B, S)["tokens"]


def r1_split_noise(torch, cfg, batch) -> float:
    """The float32 noise of splitting R1's (or S1-S3's) batch rows on one
    device: the largest difference, relative to each leaf's largest
    magnitude, between the gradients of one microbatch of 2 rows and of
    two of 1
    (each weight gradient's rows summed as two halves, as the data
    ranks sum them; the loss over 2 is exact)."""
    import dataclasses
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import make_loss_and_grads
    params = init_model(cfg, 0)
    g = [tree_flatten(make_loss_and_grads(dataclasses.replace(
        cfg, train_microbatches=k), remat=False)(params, batch)[2])[0]
        for k in (1, 2)]
    out = max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
              for a, b in zip(*g))
    del params, g
    gc.collect()
    torch.cuda.empty_cache()
    return out


def tp_kernel_cases(torch, np, mg, fa, ref):
    """The kernels at path R's rank shapes: R2's ``moe_gemm`` with moe_ff
    over model = 4 (10 experts, 2 rows x capacity 768, 704 hidden
    columns) and with the experts over model = 2 (5 experts, one row's
    768), and the flash forward and backward at a qwen3-32b rank's heads
    on model = 4: (1, 2048, 16 of 2 kv heads, 128)."""
    from repro_torch.models.moe import capacity_for
    cfg = tp_cfg("R2")
    C = capacity_for(cfg, R2_BATCH[1])
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    rows = R2_BATCH[0] * C
    gemm = [check_moe_gemm(torch, mg, ref, 100, "tp_moe_ff_gate_up", E,
                           rows, d, f // 4, torch.float32,
                           w_scale=d ** -0.5),
            check_moe_gemm(torch, mg, ref, 101, "tp_moe_ff_down", E, rows,
                           f // 4, d, torch.float32, w_scale=f ** -0.5),
            check_moe_gemm(torch, mg, ref, 102, "tp_experts_gate_up",
                           E // 2, C, d, f, torch.float32,
                           w_scale=d ** -0.5),
            check_moe_gemm(torch, mg, ref, 103, "tp_experts_down", E // 2,
                           C, f, d, torch.float32, w_scale=f ** -0.5)]
    flash = [check_flash(torch, np, fa, ref, 105, "tp_qwen3_model4", 1,
                         2048, 16, 2, 128, True, iters=5)]
    flash_bwd = [check_flash_bwd(torch, np, fa, ref, 107, "tp_qwen3_model4",
                                 1, 2048, 16, 2, 128, True)]
    return gemm, flash, flash_bwd


def tp_path(torch, np, ops, mg, fa, ref):
    """Path R: FSDP placement and tensor parallelism, four ranks on the
    card over gloo, each one-device reference run here first and freed.
    R1 qwen3-32b training on (2, 2), FSDP over data and tensor
    parallelism over model: loss and gradients against one device (each
    rank computes it in turn), each rank's parameter-and-moment bytes and
    peak against one device's; R2 bmoe-paper's gspmd MoE prefill on
    (1, 4) (moe_ff over model) and (2, 2) (the experts over model, its
    MoE layer bitwise one device's): logits, next tokens and routing
    against one device; R3 qwen3-32b decode on (1, 4), 64 steps of a
    batch of 4 over a 4,096-position cache split over model: tokens equal
    and logits at the bar; R4 the kernels at a rank's shapes and each
    rank's launches; P4 R1's step on the abstract (2, 2) mesh as rank 0
    books R1 rank 0's bytes and its parameter-and-moment bytes."""
    import pickle
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import spawn_edges
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import make_prefill_step, make_train_step
    t_start = time.perf_counter()
    gemm, flash, flash_bwd = tp_kernel_cases(torch, np, mg, fa, ref)

    # the one-device references
    cfg1, cfg2, cfg3 = tp_cfg("R1"), tp_cfg("R2"), tp_cfg("R3")
    params = init_model(cfg1, 0)
    state = adamw.init(params)
    one1 = {"placed_bytes": dryrun.nbytes((params, state))}
    batch = _lm_train_batch(torch, cfg1, *R1_BATCH)
    step = make_train_step(cfg1, adamw.AdamWConfig(total_steps=1000),
                           remat=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out, one1["wall_ms"] = _timed(torch, lambda: step(params, state,
                                                      batch))
    one1.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches=ops.launch_counts(), loss=float(out[2]["loss"]))
    del params, state, step, out      # the moments too (20 GB)
    gc.collect()
    torch.cuda.empty_cache()
    one1["split_noise"] = r1_split_noise(torch, cfg1, batch)
    params = init_model(cfg2, 0)
    tokens = prefill_batch_rows(torch, cfg2, *R2_BATCH)
    one2 = r2_prefill(torch, cfg2, params, tokens, None)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params = init_model(cfg3, 0)
    torch.cuda.reset_peak_memory_stats()
    one3 = r3_decode(torch, cfg3, params, None)
    one3["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params
    gc.collect()
    torch.cuda.empty_cache()
    one_s = time.perf_counter() - t_start

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", f"tp-{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    emit({"phase": "tensor_parallel", "path": "R0",
          "parent_allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "parent_reserved_gb": torch.cuda.memory_reserved() / 1e9,
          "card_free_gb": torch.cuda.mem_get_info()[0] / 1e9})
    t0 = time.perf_counter()
    # four ranks' caching allocators share the card: segments that grow
    # and shrink keep each rank's reserve near what it holds
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        spawn_edges(tp_rank, 4, args=(out_dir,), device="cuda",
                    rendezvous_dir=out_dir, timeout_s=420)
    except BaseException:
        for r in range(4):
            err = os.path.join(out_dir, f"R-rank{r}.err")
            if os.path.exists(err):
                print(f"path R rank {r}:\n{open(err).read()}",
                      file=sys.stderr, flush=True)
        raise
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    res = []
    for r in range(4):
        with open(os.path.join(out_dir, f"R-rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    world_s = time.perf_counter() - t0

    # R1: loss at 1e-5 relative; gradients at 1e-5 of each leaf's largest
    # magnitude, or twice one device's own noise of splitting the rows
    # where that is larger (at full width float32 sums over 25,600 and
    # 152,064 terms differ by about 1e-5 between two orders); a quarter
    # of the bytes
    r1 = [r["R1"] for r in res]
    want1 = train_step_counts(cfg1, remat=True)
    share = [r["placed_bytes"] / one1["placed_bytes"] for r in r1]
    grad_bar = max(1e-5, 2 * one1["split_noise"])
    r1_ok = {"loss_vs_one_device": all(
                 abs(r["vs_one_device"]["loss_mesh"]
                     - r["vs_one_device"]["loss_one_device"])
                 <= 1e-5 * abs(r["vs_one_device"]["loss_one_device"])
                 for r in r1),
             "grads_vs_one_device": all(
                 r["vs_one_device"]["max_rel_diff"] <= grad_bar
                 for r in r1),
             "step_loss": all(abs(r["loss"] - one1["loss"])
                              <= 1e-5 * abs(one1["loss"]) for r in r1),
             "quarter_of_the_bytes": all(0.25 <= s <= 0.26 for s in share),
             "launches": one1["launches"] == want1 and all(
                 r["launches"] == want1 for r in r1)}
    emit({"phase": "tensor_parallel", "path": "R1", "model": cfg1.name,
          "mesh": {"data": 2, "model": 2}, "card": CARD,
          "reduced": "2 of 64 layers", "step": "(2, 2048), remat on",
          "checks": r1_ok, "placed_share": share,
          "placed_gb": {"one_device": one1["placed_bytes"] / 1e9,
                        "ranks": [r["placed_bytes"] / 1e9 for r in r1]},
          "step_peak_gb": {"one_device": one1["peak_gb"],
                           "ranks": [r["peak_gb"] for r in r1]},
          "walls_ms": {"one_device": one1["wall_ms"],
                       "mesh_rank0": r1[0]["wall_ms"]},
          "max_rel_grad_diff": [r["vs_one_device"]["max_rel_diff"]
                                for r in r1],
          "one_device_split_noise": one1["split_noise"],
          "grad_bar": grad_bar,
          "rel_grad_diff_top_leaves_rank0": sorted(
              r1[0]["vs_one_device"]["rel_diff_by_leaf"].items(),
              key=lambda kv: -kv[1])[:6],
          "loss": {"one_device": one1["loss"], "ranks": [r["loss"]
                                                         for r in r1]},
          "launches_rank0": r1[0]["launches"], "want": want1,
          "wire_bytes_rank0": r1[0]["wire"]})
    require(all(r1_ok.values()), f"R1 failed: {r1_ok}")

    # R2: logits at 1e-5 of their largest magnitude, next tokens equal,
    # routing equal (a token whose top-k margin is under 1e-5 may route
    # otherwise), the MoE layer with the experts over model bitwise
    k = cfg2.num_experts_per_tok
    want2 = lm_counts(moe_gemm=3 * cfg2.num_layers,
                      flash_attention=cfg2.num_layers)
    r2_ok, r2_row = {}, {}
    scale = float(one2["rows"].abs().max())
    for shape in R_SHAPES["R2"]:
        rows = [r[f"R2/{shape}"] for r in res]
        diff = max(float((q["rows"] - one2["rows"][slice(
            *q["batch_rows"])]).abs().max()) for q in rows)
        routes = [_routes_equal(q["routes"], [tuple(
            t[slice(*q["batch_rows"])] for t in w) for w in one2["routes"]],
            [m[slice(*q["batch_rows"])] for m in one2["margins"]], k)
            for q in rows]
        r2_ok[str(shape)] = {
            "logits": diff <= 1e-5 * scale,
            "next_tokens": all(q["next"] == one2["next"] for q in rows),
            "routing": all(n == near for r in routes for n, near in r),
            "launches": all(q["launches"] == want2 for q in rows)}
        r2_row[str(shape)] = {"max_abs_logit_diff": diff,
                              "routing_differs_near_ties": routes[0],
                              "walls_ms_rank0": rows[0]["wall_ms"],
                              "launches_rank0": rows[0]["launches"]}
    r2_ok["moe_layer_experts_over_model_bitwise"] = all(
        r["R2/layer"]["bitwise"] for r in res)
    emit({"phase": "tensor_parallel", "path": "R2", "model": cfg2.name,
          "meshes": {"(1, 4)": "moe_ff over model",
                     "(2, 2)": "the experts over model"}, "card": CARD,
          "reduced": f"{cfg2.num_layers} of 12 layers, vote off",
          "prefill": f"{R2_BATCH}, capacity factor "
                     f"{cfg2.capacity_factor}",
          "checks": r2_ok, "by_mesh": r2_row, "max_abs_logit": scale,
          "want": want2, "one_device_wall_ms": one2["wall_ms"],
          "next_tokens": one2["next"]})
    require(all(all(v.values()) if isinstance(v, dict) else v
                for v in r2_ok.values()), f"R2 failed: {r2_ok}")

    # R3: every step's next tokens equal, logits at 1e-5
    r3 = [r["R3"] for r in res]
    scale = max(float(l.abs().max()) for l in one3["logits"])
    diff = max(float((a - b).abs().max()) for q in r3
               for a, b in zip(q["logits"], one3["logits"]))
    r3_ok = {"tokens": all(q["next"] == one3["next"] for q in r3),
             "logits": diff <= 1e-5 * scale,
             "launches": one3["launches"] == lm_counts() and all(
                 q["launches"] == lm_counts() for q in r3)}
    emit({"phase": "tensor_parallel", "path": "R3", "model": cfg3.name,
          "mesh": {"data": 1, "model": 4}, "card": CARD,
          "reduced": "4 of 64 layers",
          "decode": f"{R3_STEPS} steps of a batch of {R3_BATCH} from "
                    f"{list(R3_POS)}, cache {R3_CACHE} over model",
          "checks": r3_ok, "max_abs_logit_diff": diff,
          "max_abs_logit": scale,
          "walls_ms_median": {
              "one_device": sorted(one3["walls_ms"])[R3_STEPS // 2],
              "mesh_rank0": sorted(r3[0]["walls_ms"])[R3_STEPS // 2]},
          "peak_gb": {"one_device": one3["peak_gb"],
                      "ranks": [q["peak_gb"] for q in r3]},
          "wire_bytes_rank0_64_steps": r3[0]["wire"]})
    require(all(r3_ok.values()), f"R3 failed: {r3_ok}")

    # P4: R1's step on the abstract (2, 2) mesh as rank 0
    rec = dryrun.run_one(cfg1.name, dict(kind="train", seq=R1_BATCH[1],
                                         batch=R1_BATCH[0]), cfg=cfg1,
                         mesh_shape=R_SHAPES["R1"], rank=0, remat=True,
                         verbose=False)
    p4 = {"wire_bytes_equal": rec["wire_bytes"] == r1[0]["wire"],
          "placed_bytes_equal": rec["placed_argument_size_in_bytes"]
          == r1[0]["placed_bytes"]}
    emit({"phase": "dryrun", "path": "P4", "model": cfg1.name,
          "mesh": {"data": 2, "model": 2}, "reduced": "2 of 64 layers",
          "step": "train (2, 2048), remat on",
          "wire_bytes": {"abstract_rank0": rec["wire_bytes"],
                         "r1_rank0": r1[0]["wire"]},
          "placed_bytes": {"abstract_rank0": rec[
              "placed_argument_size_in_bytes"],
              "jax_specs": rec["jax_placed_argument_size_in_bytes"],
              "r1_rank0": r1[0]["placed_bytes"]},
          "peak_estimate_gb_rank0": rec["peak_bytes_estimate"] / 1e9,
          "checks": p4})
    require(all(p4.values()), f"P4 failed: {p4}")
    emit({"phase": "tensor_parallel", "path": "R4", "card": CARD,
          "launches_by_rank": {"R1": [r["launches"] for r in r1],
                               "R2": {str(s): [r[f"R2/{s}"]["launches"]
                                               for r in res]
                                      for s in R_SHAPES["R2"]},
                               "R3": [q["launches"] for q in r3]},
          "one_device_s": one_s, "world_s": world_s,
          "path_s": time.perf_counter() - t_start})
    return {"R1": r1[0]["launches"],
            "R2": {str(s): res[0][f"R2/{s}"]["launches"]
                   for s in R_SHAPES["R2"]},
            "gemm": gemm, "flash": flash, "flash_bwd": flash_bwd}


# ------- path S: the recurrent mixers' tensor parallelism, seamless placed
S_SHAPES = {"train": (2, 2), "infer": (1, 4)}
S_TRAIN = {"S1": (2, 4096), "S2": (2, 2048), "S3": (2, 512)}
S3_FRAMES = 2048
S_PREFILL = {"S1": 4096, "S2": 4096, "S3": 512}
S_DECODE_STEPS = 16
# decode: (batch, cache length, each row's first position); S2's first
# row crosses its 2,048-token window, S3's cross K/V from ``encode``
S_DECODE = {"S1": (1, 4096, (4000,)), "S2": (2, 4096, (2040, 3000)),
            "S3": (2, 512, (100, 300))}
S_PREFILL_EVERY = 64                     # positions whose logits are held


def s_cfg(sub: str, kind: str = "train"):
    """Path S's configs at full width: S1 mamba2-2.7b, 2 of 64 layers; S2
    recurrentgemma-2b's first block (rglru, rglru, local_attn); S3
    seamless-m4t-medium, 2 encoder and 2 decoder layers; one training
    microbatch each.  ``kind="decode"``: as a decode shape sets it
    (``launch.shapes.shape_config``)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import shape_config
    if sub == "S1":
        cfg = _cut(get_config("mamba2-2.7b"), 2, train_microbatches=1)
    elif sub == "S2":
        cfg = dataclasses.replace(
            get_config("recurrentgemma-2b"), num_layers=3, num_blocks=1,
            remainder=(), train_microbatches=1).validate()
    else:
        cfg = dataclasses.replace(
            get_config("seamless-m4t-medium"), num_layers=2, num_blocks=2,
            num_encoder_layers=2).validate()
    if kind == "decode":
        B, L, _ = S_DECODE[sub]
        cfg = shape_config(cfg, dict(kind="decode", seq=L, batch=B))
    return cfg


def s_frames(torch, cfg, B: int, S: int, seed: int):
    """(B, S, d) stub frame embeddings drawn on the card from ``seed``."""
    g = torch.Generator("cuda").manual_seed(seed)
    return torch.randn(B, S, cfg.d_model, generator=g, device="cuda")


def s_train_batch(torch, cfg, sub: str):
    B, S = S_TRAIN[sub]
    batch = _lm_train_batch(torch, cfg, B, S)
    if cfg.is_encoder_decoder:
        batch["frames"] = s_frames(torch, cfg, B, S3_FRAMES, 41)
    return batch


def s_prefill_batch(torch, cfg, sub: str):
    batch = {"tokens": _lm_train_batch(torch, cfg, 1, S_PREFILL[sub],
                                       seed=1)["tokens"]}
    if cfg.is_encoder_decoder:
        batch["frames"] = s_frames(torch, cfg, 1, S3_FRAMES, 42)
    return batch


def s_prefill(torch, cfg, params, batch, mesh):
    """The prefill's whole logits at every ``S_PREFILL_EVERY``-th position
    and the last (host), the next tokens of ``make_prefill_step`` and its
    launches."""
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import step_sharder
    from repro_torch.train.step import make_prefill_step, model_forward
    shard = step_sharder(cfg, mesh, "prefill")
    S = batch["tokens"].shape[1]
    rows = list(range(0, S, S_PREFILL_EVERY)) + [S - 1]
    with torch.no_grad():
        logits = model_forward(params, batch, cfg, shard=shard)[0]
        logits = tfm.gather_vocab(logits[:, rows], shard).cpu()
    step = make_prefill_step(cfg, mesh)
    ops.reset_launch_counts()
    nxt, wall = _timed(torch, lambda: step(params, batch))
    return {"rows": logits, "next": nxt.tolist(),
            "launches": ops.launch_counts(), "wall_ms": wall}


def s_caches(torch, cfg, sub: str, params, mesh):
    """The decode caches of S's decode shape, this rank's part: every leaf
    of the whole cache drawn on the card from a generator seeded by its
    index (so a rank's part is the whole cache's), cut by
    ``shard_caches``; S3's cross K/V from ``encode``'s memory of stub
    frames (``encdec.cross_kv``, whole over heads on every rank)."""
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    from repro_torch.models.builder import materialize
    from repro_torch.sharding import shard_caches, step_sharder
    B, L, _ = S_DECODE[sub]
    if cfg.is_encoder_decoder:
        decl = encdec.encdec_cache_decl(cfg, B, L, S3_FRAMES)
    else:
        decl = tfm.cache_decl(cfg, B, L)
    caches = materialize(decl, 0, "cuda")
    for i, t in enumerate(tree_flatten(caches)[0]):
        g = torch.Generator("cuda").manual_seed(9_000_011 * (i + 1))
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    if cfg.is_encoder_decoder:
        shard = step_sharder(cfg, mesh, "decode")
        with torch.no_grad():
            memory = encdec.encode(params, s_frames(torch, cfg, B, S3_FRAMES,
                                                    43), cfg, shard=shard)
            caches["cross_k"], caches["cross_v"] = encdec.cross_kv(
                params, memory, cfg, shard=shard)
    return shard_caches(caches, cfg, mesh)


def s_decode(torch, cfg, sub: str, params, mesh):
    """S's ``S_DECODE_STEPS`` decode steps from ``s_caches``: per step the
    next tokens of ``make_decode_step`` and the whole logits of the
    forward on the step's input (host); walls; launches; on a mesh,
    whether each ssm layer's conv history holds the same bits on every
    rank of its model group."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.models import encdec
    from repro_torch.models import transformer as tfm
    from repro_torch.sharding import step_sharder
    from repro_torch.train.step import make_decode_step
    B, _, pos = S_DECODE[sub]
    caches = s_caches(torch, cfg, sub, params, mesh)
    step = make_decode_step(cfg, mesh=mesh)
    shard = step_sharder(cfg, mesh, "decode")
    fwd = encdec.forward_decode if cfg.is_encoder_decoder \
        else tfm.forward_decode
    toks = np.random.default_rng(12).integers(0, cfg.vocab_size,
                                              (S_DECODE_STEPS, B))
    out = {"next": [], "logits": [], "walls_ms": []}
    ops.reset_launch_counts()
    for t in range(S_DECODE_STEPS):
        batch = {"tokens": torch.tensor(toks[t], device="cuda")[:, None],
                 "pos": torch.tensor(pos, device="cuda") + t}
        with torch.no_grad():
            logits = tfm.gather_vocab(fwd(params, caches, batch["tokens"],
                                          batch["pos"], cfg,
                                          shard=shard)[0], shard)
        out["logits"].append(logits[:, -1].cpu())
        (nxt, caches), wall = _timed(torch, lambda: step(params, caches,
                                                         batch))
        out["next"].append(nxt.tolist())
        out["walls_ms"].append(wall)
    out["launches"] = ops.launch_counts()
    if mesh is not None and not cfg.is_encoder_decoder:
        same = []
        for spec, key, i in tfm._layers(cfg):
            if spec.kind == "ssm":
                conv = tfm._layer_params(caches, key, i)["conv"]
                same += [bool(torch.equal(p, conv)) for p in
                         mesh.model.all_gather(conv, "conv_check")]
        if same:
            out["conv_replicated"] = same
    del caches
    return out


def _s_step_vs_one_device(torch, cfg, mesh, g_mesh, p_mesh, batch,
                          bar: float):
    """This rank's gradients and updated parameters against the
    one-device step's (computed here in this rank's turn, one rank at a
    time on the card): the largest gradient difference relative to each
    leaf's largest magnitude, and the largest updated-parameter
    difference relative to the larger of 1 and the leaf's largest
    magnitude."""
    import torch.distributed as dist
    from repro_torch.core.ledger import tree_flatten
    from repro_torch.optim import adamw
    from repro_torch.sharding import shard_params
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import apply_update, make_loss_and_grads
    out = None
    for turn in range(mesh.world):
        dist.barrier()
        if turn != mesh.rank:
            continue
        p1 = init_model(cfg, 0, device=mesh.device)
        s1 = adamw.init(p1)
        loss1, _, g1 = make_loss_and_grads(cfg, remat=False)(p1, batch)
        p1, s1, m1 = apply_update(adamw.AdamWConfig(total_steps=1000), cfg,
                                  p1, s1, g1)
        del s1
        g1, p1 = shard_params(g1, cfg, mesh), shard_params(p1, cfg, mesh)
        rel = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
               for a, b in zip(tree_flatten(g_mesh)[0], tree_flatten(g1)[0])]
        upd = [float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
               for a, b in zip(tree_flatten(p_mesh)[0], tree_flatten(p1)[0])]
        out = {"loss_one_device": float(loss1),
               "grad_norm_one_device": float(m1["grad_norm"]),
               "max_rel_diff": max(rel), "max_update_diff": max(upd),
               "rel_diff_by_leaf": dict(zip(_leaf_paths(g_mesh), rel))}
        del g1, p1
        gc.collect()
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def rtp_rank(rank: int, world: int, out_dir: str, bars: dict) -> None:
    """One rank of path S's world of 4 (spawned by ``spawn_edges``): each
    of S1-S3's training step on (2, 2) and its prefill and decode on
    (1, 4); results to ``<out_dir>/S-rank<r>.pkl``.  It prints
    nothing."""
    import pickle

    import torch
    from repro_torch.kernels import build, ops
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    build.library()
    try:
        res = _rtp_rank_cases(torch, ops, bars)
    except BaseException:
        import traceback
        with open(os.path.join(out_dir, f"S-rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(os.path.join(out_dir, f"S-rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _rtp_rank_cases(torch, ops, bars: dict) -> dict:
    """``rtp_rank``'s cases on this rank; returns what the parent
    checks."""
    from repro_torch.launch.dryrun import nbytes
    from repro_torch.launch.mesh import make_lm_mesh
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import apply_update, make_loss_and_grads
    res = {}
    for sub in ("S1", "S2", "S3"):
        cfg = s_cfg(sub)
        mesh = make_lm_mesh(S_SHAPES["train"], ("data", "model"))
        batch = s_train_batch(torch, cfg, sub)
        params = init_model(cfg, 0, mesh.device, mesh=mesh)
        state = adamw.init(params)
        placed = nbytes((params, state))
        loss_and_grads = make_loss_and_grads(cfg, remat=True, mesh=mesh)
        opt_cfg = adamw.AdamWConfig(total_steps=1000)

        def step():                   # make_train_step's two calls
            loss, _, g = loss_and_grads(params, batch)
            return loss, g, apply_update(opt_cfg, cfg, params, state, g,
                                         mesh)[2]

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        mesh.wire_bytes.clear()
        (loss, g, m), wall = _timed(torch, step)
        row = {"placed_bytes": placed, "wall_ms": wall,
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "launches": ops.launch_counts(),
               "wire": dict(mesh.wire_bytes), "loss": float(loss),
               "grad_norm": float(m["grad_norm"])}
        del state
        gc.collect()
        torch.cuda.empty_cache()
        row["vs_one_device"] = _s_step_vs_one_device(
            torch, cfg, mesh, g, params, batch, bars[sub])
        del g, params
        gc.collect()
        torch.cuda.empty_cache()
        res[f"{sub}/train"] = row
        # prefill and decode on (1, 4)
        mesh = make_lm_mesh(S_SHAPES["infer"], ("data", "model"))
        params = init_model(cfg, 0, mesh.device, mesh=mesh, kind="prefill")
        res[f"{sub}/prefill"] = s_prefill(torch, cfg, params,
                                          s_prefill_batch(torch, cfg, sub),
                                          mesh)
        del params
        dcfg = s_cfg(sub, "decode")
        params = init_model(dcfg, 0, mesh.device, mesh=mesh, kind="decode")
        res[f"{sub}/decode"] = s_decode(torch, dcfg, sub, params, mesh)
        res[f"{sub}/decode"]["wire"] = dict(mesh.wire_bytes)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return res


def rtp_kernel_cases(torch, np, fa, ss, rg, ref):
    """The kernels at path S's rank shapes: ``ssd_scan`` and its backward
    at a mamba2-2.7b rank's 20 heads (model = 4) and 40 heads (model =
    2) of (1, 4096), P 64, N 128; ``rglru_scan`` and its reverse scan at
    a recurrentgemma-2b rank's 640 channels (model = 4) and 1,280 (model
    = 2) of (1, 4096); the flash forward and backward at a
    seamless-m4t-medium encoder rank's 4 heads (model = 4) and 8 heads
    (model = 2) of (1, 2048), D 64, non-causal (recurrentgemma's 10 heads
    do not divide model = 4: every rank attends every head, one
    device's shape)."""
    ssd = [check_ssd(torch, ss, ref, 120 + i, f"tp_mamba2_{H}_heads", 1,
                     4096, H, 64, 128, 128, iters=5)
           for i, H in enumerate((20, 40))]
    ssd_bwd = [check_ssd_bwd(torch, ss, ref, 122 + i,
                             f"tp_mamba2_{H}_heads", 1, 4096, H, 64, 128,
                             128, iters=5) for i, H in enumerate((20, 40))]
    scan = [check_rglru(torch, rg, ref, 124 + i, f"tp_rgemma_{C}", 1, 4096,
                        C) for i, C in enumerate((640, 1280))]
    scan_bwd = [check_rglru_bwd(torch, rg, ref, 126 + i, f"tp_rgemma_{C}",
                                1, 4096, C)
                for i, C in enumerate((640, 1280))]
    flash = [check_flash(torch, np, fa, ref, 128 + i,
                         f"tp_seamless_enc_{H}_heads", 1, S3_FRAMES, H, H,
                         64, False, iters=5) for i, H in enumerate((4, 8))]
    flash_bwd = [check_flash_bwd(torch, np, fa, ref, 130 + i,
                                 f"tp_seamless_enc_{H}_heads", 1, S3_FRAMES,
                                 H, H, 64, False)
                 for i, H in enumerate((4, 8))]
    return ssd, ssd_bwd, scan, scan_bwd, flash, flash_bwd


def _s_want(cfg, kind: str):
    """A rank's launches (as one device's) of path S's step of ``kind``."""
    if kind == "train":
        return train_step_counts(cfg, remat=True)
    if kind == "decode":
        return lm_counts()
    n = train_step_counts(cfg, remat=False)
    return {k: (0 if k.endswith("_bwd") else v) for k, v in n.items()}


def recurrent_tp_path(torch, np, ops, fa, ss, rg, ref):
    """Path S: the recurrent mixers' tensor parallelism and the
    encoder-decoder's placement, four ranks on the card over gloo, each
    one-device reference run here first and freed.  S1 mamba2-2.7b (2
    of 64 layers), S2 recurrentgemma-2b's first block, S3
    seamless-m4t-medium (2 + 2 layers), each trained one step on (2, 2)
    (FSDP over data, tensor parallelism over model) against one device:
    loss at 1e-5 relative, gradients at max(1e-5, twice one device's own
    difference between two sum orders of the step) and the updated
    parameters at that bar of the larger of 1 and each leaf's largest
    magnitude, each rank's parameters and moments about a quarter of one
    device's; then a prefill and ``S_DECODE_STEPS`` decode
    steps on (1, 4) (mamba2's 20 heads, recurrentgemma's 640 channels a
    rank): tokens equal, logits within 1e-5 of the largest; S4 the
    kernels at a rank's shapes; P5 S1's step on the abstract (2, 2) mesh
    books S1 rank 0's bytes and its parameter-and-moment bytes."""
    import pickle
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import spawn_edges
    from repro_torch.optim import adamw
    from repro_torch.train.loop import init_model
    from repro_torch.train.step import make_train_step
    t_start = time.perf_counter()
    ssd, ssd_bwd, scan, scan_bwd, flash, flash_bwd = rtp_kernel_cases(
        torch, np, fa, ss, rg, ref)

    # the one-device references
    one, bars = {}, {}
    for sub in ("S1", "S2", "S3"):
        cfg = s_cfg(sub)
        params = init_model(cfg, 0)
        state = adamw.init(params)
        row = {"placed_bytes": dryrun.nbytes((params, state))}
        batch = s_train_batch(torch, cfg, sub)
        step = make_train_step(cfg, adamw.AdamWConfig(total_steps=1000),
                               remat=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out, row["wall_ms"] = _timed(torch, lambda: step(params, state,
                                                         batch))
        row.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=ops.launch_counts(),
                   loss=float(out[2]["loss"]),
                   grad_norm=float(out[2]["grad_norm"]))
        del params, state, step, out
        gc.collect()
        torch.cuda.empty_cache()
        row["split_noise"] = r1_split_noise(torch, cfg, batch)
        bars[sub] = max(1e-5, 2 * row["split_noise"])
        params = init_model(cfg, 0)
        row["prefill"] = s_prefill(torch, cfg, params,
                                   s_prefill_batch(torch, cfg, sub), None)
        del params
        dcfg = s_cfg(sub, "decode")
        params = init_model(dcfg, 0)
        row["decode"] = s_decode(torch, dcfg, sub, params, None)
        del params, batch
        gc.collect()
        torch.cuda.empty_cache()
        one[sub] = row
    one_s = time.perf_counter() - t_start

    here = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(here, "build", f"rtp-{os.getpid()}")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    t0 = time.perf_counter()
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        spawn_edges(rtp_rank, 4, args=(out_dir, bars), device="cuda",
                    rendezvous_dir=out_dir, timeout_s=420)
    except BaseException:
        for r in range(4):
            err = os.path.join(out_dir, f"S-rank{r}.err")
            if os.path.exists(err):
                print(f"path S rank {r}:\n{open(err).read()}",
                      file=sys.stderr, flush=True)
        raise
    finally:
        if alloc is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF", None)
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    res = []
    for r in range(4):
        with open(os.path.join(out_dir, f"S-rank{r}.pkl"), "rb") as f:
            res.append(pickle.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    world_s = time.perf_counter() - t0

    ok_all = {}
    for sub in ("S1", "S2", "S3"):
        cfg, o = s_cfg(sub), one[sub]
        tr = [r[f"{sub}/train"] for r in res]
        want = _s_want(cfg, "train")
        share = [t["placed_bytes"] / o["placed_bytes"] for t in tr]
        jax_bytes = dryrun.jax_argument_bytes(
            cfg, dict(kind="train", seq=S_TRAIN[sub][1],
                      batch=S_TRAIN[sub][0]),
            dryrun.mesh_for(S_SHAPES["train"]), "train", placed_only=True)
        vs = [t["vs_one_device"] for t in tr]
        ok = {"loss_vs_one_device": all(
                  abs(t["loss"] - v["loss_one_device"])
                  <= 1e-5 * abs(v["loss_one_device"])
                  for t, v in zip(tr, vs)),
              "grads_vs_one_device": all(v["max_rel_diff"] <= bars[sub]
                                         for v in vs),
              "grad_norm": all(abs(t["grad_norm"] - v["grad_norm_one_device"])
                               <= bars[sub] * v["grad_norm_one_device"]
                               for t, v in zip(tr, vs)),
              "update_vs_one_device": all(v["max_update_diff"] <= bars[sub]
                                          for v in vs),
              "step_loss": all(abs(t["loss"] - o["loss"])
                               <= 1e-5 * abs(o["loss"]) for t in tr),
              "placed_bytes_jax_specs": all(t["placed_bytes"] == jax_bytes
                                            for t in tr),
              "about_a_quarter": all(0.25 <= s <= 0.26 for s in share),
              "launches": o["launches"] == want and all(
                  t["launches"] == want for t in tr)}
        emit({"phase": "recurrent_tp", "path": sub, "model": cfg.name,
              "mesh": {"data": 2, "model": 2}, "card": CARD,
              "reduced": f"{cfg.num_layers} layers"
                         + (f" + {cfg.num_encoder_layers} encoder"
                            if cfg.is_encoder_decoder else ""),
              "step": f"{S_TRAIN[sub]}, remat on"
                      + (f", {S3_FRAMES} frames" if cfg.is_encoder_decoder
                         else ""),
              "checks": ok, "placed_share": share,
              "placed_gb": {"jax_specs": jax_bytes / 1e9,
                            "one_device": o["placed_bytes"] / 1e9,
                            "ranks": [t["placed_bytes"] / 1e9 for t in tr]},
              "step_peak_gb": {"one_device": o["peak_gb"],
                               "ranks": [t["peak_gb"] for t in tr]},
              "walls_ms": {"one_device": o["wall_ms"],
                           "mesh_rank0": tr[0]["wall_ms"]},
              "max_rel_grad_diff": [v["max_rel_diff"] for v in vs],
              "one_device_split_noise": o["split_noise"],
              "grad_bar": bars[sub],
              "max_update_diff": [v["max_update_diff"] for v in vs],
              "rel_grad_diff_top_leaves_rank0": sorted(
                  vs[0]["rel_diff_by_leaf"].items(),
                  key=lambda kv: -kv[1])[:6],
              "loss": {"one_device": o["loss"],
                       "ranks": [t["loss"] for t in tr]},
              "launches_rank0": tr[0]["launches"], "want": want,
              "wire_bytes_rank0": tr[0]["wire"]})
        require(all(ok.values()), f"{sub} training failed: {ok}")
        ok_all[f"{sub}/train"] = ok
        # prefill and decode on (1, 4): tokens equal, logits at 1e-5
        pf = [r[f"{sub}/prefill"] for r in res]
        dec = [r[f"{sub}/decode"] for r in res]
        pscale = float(o["prefill"]["rows"].abs().max())
        pdiff = max(float((q["rows"] - o["prefill"]["rows"]).abs().max())
                    for q in pf)
        dscale = max(float(l.abs().max()) for l in o["decode"]["logits"])
        ddiff = max(float((a - b).abs().max()) for q in dec
                    for a, b in zip(q["logits"], o["decode"]["logits"]))
        pwant = _s_want(cfg, "prefill")
        ok = {"prefill_next_tokens": all(q["next"] == o["prefill"]["next"]
                                         for q in pf),
              "prefill_logits": pdiff <= 1e-5 * pscale,
              "prefill_launches": o["prefill"]["launches"] == pwant and all(
                  q["launches"] == pwant for q in pf),
              "decode_tokens": all(q["next"] == o["decode"]["next"]
                                   for q in dec),
              "decode_logits": ddiff <= 1e-5 * dscale,
              "decode_launches": all(q["launches"] == lm_counts()
                                     for q in dec)}
        if "conv_replicated" in dec[0]:
            ok["conv_history_replicated"] = all(all(q["conv_replicated"])
                                                for q in dec)
        B, L, pos = S_DECODE[sub]
        emit({"phase": "recurrent_tp", "path": sub, "model": cfg.name,
              "mesh": {"data": 1, "model": 4}, "card": CARD,
              "prefill": f"1 x {S_PREFILL[sub]}",
              "decode": f"{S_DECODE_STEPS} steps of a batch of {B} from "
                        f"{list(pos)}, cache {L}",
              "checks": ok,
              "prefill_max_abs_logit_diff": pdiff,
              "prefill_max_abs_logit": pscale,
              "decode_max_abs_logit_diff": ddiff,
              "decode_max_abs_logit": dscale,
              "prefill_walls_ms": {"one_device": o["prefill"]["wall_ms"],
                                   "mesh_rank0": pf[0]["wall_ms"]},
              "decode_walls_ms_median": {
                  "one_device": sorted(o["decode"]["walls_ms"])[
                      S_DECODE_STEPS // 2],
                  "mesh_rank0": sorted(dec[0]["walls_ms"])[
                      S_DECODE_STEPS // 2]},
              "prefill_launches_rank0": pf[0]["launches"],
              "wire_bytes_rank0_prefill_and_decode": dec[0]["wire"]})
        require(all(ok.values()), f"{sub} prefill/decode failed: {ok}")
        ok_all[f"{sub}/infer"] = ok

    # P5: S1's step on the abstract (2, 2) mesh as rank 0
    cfg1 = s_cfg("S1")
    s1 = res[0]["S1/train"]
    rec = dryrun.run_one(cfg1.name, dict(kind="train", seq=S_TRAIN["S1"][1],
                                         batch=S_TRAIN["S1"][0]), cfg=cfg1,
                         mesh_shape=S_SHAPES["train"], rank=0, remat=True,
                         verbose=False)
    p5 = {"wire_bytes_equal": rec["wire_bytes"] == s1["wire"],
          "placed_bytes_equal": rec["placed_argument_size_in_bytes"]
          == s1["placed_bytes"]
          == rec["jax_placed_argument_size_in_bytes"]}
    emit({"phase": "dryrun", "path": "P5", "model": cfg1.name,
          "mesh": {"data": 2, "model": 2}, "reduced": "2 of 64 layers",
          "step": f"train {S_TRAIN['S1']}, remat on",
          "wire_bytes": {"abstract_rank0": rec["wire_bytes"],
                         "s1_rank0": s1["wire"]},
          "placed_bytes": {"abstract_rank0": rec[
              "placed_argument_size_in_bytes"],
              "jax_specs": rec["jax_placed_argument_size_in_bytes"],
              "s1_rank0": s1["placed_bytes"]},
          "peak_gb_rank0": {"estimate": rec["peak_bytes_estimate"] / 1e9,
                            "max_memory_allocated": s1["peak_gb"]},
          "checks": p5})
    require(all(p5.values()), f"P5 failed: {p5}")
    emit({"phase": "recurrent_tp", "path": "S4", "card": CARD,
          "launches_by_rank": {f"{sub} {k}": [r[f"{sub}/{k}"]["launches"]
                                              for r in res]
                               for sub in ("S1", "S2", "S3")
                               for k in ("train", "prefill")},
          "one_device_s": one_s, "world_s": world_s,
          "path_s": time.perf_counter() - t_start})
    return {"launches": {f"{sub} {k}": res[0][f"{sub}/{k}"]["launches"]
                         for sub in ("S1", "S2", "S3")
                         for k in ("train", "prefill")},
            "ssd": ssd, "ssd_bwd": ssd_bwd, "scan": scan,
            "scan_bwd": scan_bwd, "flash": flash, "flash_bwd": flash_bwd}


def profile_batch(torch, run, cpu: bool = True, spans=()):
    """Device time by kernel (and copy) over one warm call of ``run``,
    from torch.profiler's CUDA activities: the eight largest rows, the
    device launches, and the ``ssd_*``, ``rglru_*``, ``moe_gemm`` and
    flash kernels' launches and time summed (``ssd``, ``rglru``,
    ``moe_gemm``, ``flash``), ``rows``, every (device us, kernel,
    launches), ``takes``, the calls of ``run`` made, and ``span_us``, the
    device clock from the end of the first marker to the start of the
    second (the call's wall time on the device, its idle gaps included).
    ``spans`` names ``record_function`` regions of ``run``: each one's
    device-side annotation is kept out of the kernels and its (start,
    end) listed under ``spans``.

    A trace can lose records at its edges: the first kernels of a call
    (once 3 of a 16-wide serving chunk's 1,152 ``moe_gemm``), a marker
    launched just after the window opened, the last records before it
    closed.  So the call is fenced, by construction: after a one-step
    warm-up, the active step runs 50 ms of settle, 256 one-element fills
    (padding for any loss at the edge), a marker kernel (torch's
    ``spin_kernel``, waited for), ``run``, a second marker, 256 more
    fills and 50 ms of settle.  Only the kernels between the two markers
    count, and a trace without both markers is taken again, three takes
    at most.  ``cpu=False`` traces the device only (a serving chunk's
    tens of thousands of host ops take the profiler tens of seconds to
    sort)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    pad = torch.zeros(1, device="cuda")

    def fence():
        torch.cuda.synchronize()
        time.sleep(0.05)
        for _ in range(256):
            pad.add_(1)

    def marker():
        torch.cuda._sleep(100_000)          # about 50 us
        torch.cuda.synchronize()

    for take in range(1, 4):
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            pad.add_(1)
            torch.cuda.synchronize()
            prof.step()
            fence()
            marker()
            run()
            torch.cuda.synchronize()
            marker()
            fence()
            torch.cuda.synchronize()
            prof.step()
        # the device's records as (name, start us, end us), read from the
        # raw trace: building ``prof.events()`` took 119 s for a mamba2
        # training step's 1.6 M records, the raw list 3 s; the schedule's
        # step annotation spans the whole step on the device
        raw = prof.profiler.kineto_results
        t_ns = raw.trace_start_ns()
        dev = [(n, (e.start_ns() - t_ns) / 1e3, (e.end_ns() - t_ns) / 1e3)
               for e in raw.events()
               if e.device_type() == DeviceType.CUDA
               and not (n := e.name()).startswith(("Activity",
                                                    "ProfilerStep",
                                                    "[memory]"))]
        marked = [e for e in dev if e[0] in spans]
        dev = [e for e in dev if e[0] not in spans]
        marks = sorted((t0, t1) for n, t0, t1 in dev if "spin_kernel" in n)
        if len(marks) == 2:
            break
        emit({"phase": "profile_retake", "take": take,
              "markers": len(marks)})
    require(len(marks) == 2, "no device trace held both marker kernels")
    inside = [(n, t0, t1) for n, t0, t1 in dev
              if marks[0][1] <= t0 and t1 <= marks[1][0]
              and "spin_kernel" not in n]
    by = {}
    for n, t0, t1 in inside:
        one = by.setdefault(n, [0.0, 0])
        one[0] += t1 - t0
        one[1] += 1
    rows = sorted(((us, k, c) for k, (us, c) in by.items()), reverse=True)
    res = {"device_busy_us": sum(r[0] for r in rows),
           "device_launches": sum(r[2] for r in rows), "rows": rows,
           "takes": take, "span_us": marks[1][0] - marks[0][1],
           "spans": {n: sorted((t0, t1) for m, t0, t1 in marked
                               if m == n and marks[0][1] <= t0
                               and t1 <= marks[1][0])
                     for n in spans},
           "events": sorted((t0, t1 - t0, n) for n, t0, t1 in inside),
           "top": [{"name": k[:70], "device_us": us, "count": c}
                   for us, k, c in rows[:8]]}
    for group, pat in (("ssd", r"ssd_\w+_kernel"),
                       ("rglru", r"rglru_chunk_\w+_kernel"),
                       ("rglru_bwd", r"rglru_bwd_\w+_kernel"),
                       ("moe_gemm", r"moe_gemm_kernel"),
                       ("flash", r"flash_fwd_kernel"),
                       ("flash_bwd", r"flash_bwd_\w+_kernel")):
        mine = [r for r in rows if re.search(r"\b" + pat + r"\b", r[1])]
        by = {}
        for us, k, c in mine:       # template instances summed by name
            one = by.setdefault(re.search(pat, k)[0],
                                {"device_us": 0.0, "count": 0})
            one["device_us"] += us
            one["count"] += c
        res[group] = {"cuda_launches": sum(r[2] for r in mine),
                      "device_us": sum(r[0] for r in mine), "by_kernel": by}
    return res


def ptxas_report(log: str):
    """Per kernel function, from ``nvcc -Xptxas -v`` output (build.py's
    nvcc.log): source, function (demangled where c++filt is found),
    registers, static shared memory, stack and spill bytes."""
    fns, source, cur = [], None, None
    for ln in log.splitlines():
        m = re.match(r"== (\S+) \(rc=", ln)
        if m:
            source = m.group(1)
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            cur = {"source": source, "function": m.group(1), "registers": None,
                   "smem_bytes": 0, "stack_bytes": None, "spill_stores": None,
                   "spill_loads": None}
            fns.append(cur)
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            cur["stack_bytes"], cur["spill_stores"], cur["spill_loads"] = (
                int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["smem_bytes"] = int(sm.group(1)) if sm else 0
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt and fns:
        out = subprocess.run([filt], input="\n".join(f["function"] for f in fns),
                             capture_output=True, text=True).stdout.split("\n")
        for f, name in zip(fns, out):
            name = name.strip().replace("(anonymous namespace)::", "")
            name = name[5:] if name.startswith("void ") else name
            if name.endswith(")"):              # drop the parameter list
                name = name[:name.rfind("(")]
            f["function"] = name or f["function"]
    return fns


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
    from repro_torch.kernels import audit_mlp as am
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_gemm as mg
    from repro_torch.kernels import redundancy_vote as rv
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import ssd_scan as ss

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references stay
    torch.backends.cudnn.allow_tf32 = False         # fp32 (no TF32)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    global CARD
    CARD = smi.stdout.strip()

    t0 = time.perf_counter()
    build.library()
    log = (build.library_path().parent / "nvcc.log").read_text()
    print(f"build: {time.perf_counter() - t0:.1f} s ({build.library_path()})",
          flush=True)
    for fn in ptxas_report(log):
        emit({"ptxas": fn})
        # the tensor-core kernels keep every instantiation out of local
        # memory, and so do the scan's
        if fn["source"] in ("moe_gemm.cu", "flash_attention.cu",
                            "flash_attention_bwd.cu", "ssd_scan.cu",
                            "ssd_scan_bwd.cu", "audit_mlp.cu",
                            "rglru_scan.cu"):
            require(fn["spill_stores"] == 0 and fn["spill_loads"] == 0,
                    f"ptxas spills in {fn['function']}")

    if "--serving" in sys.argv:
        # path K alone (K3, K2, K1), each model initialised here at the
        # depth of the path whose weights it serves in the main run
        from repro_torch.configs import get_config
        from repro_torch.train.loop import init_model
        for arch, k, depth in (("qwen2.5-3b", serving_k3, None),
                               ("bmoe-paper", serving_k2, None),
                               ("qwen2-moe-a2.7b", serving_k1, H_QWEN_DEPTH)):
            cfg = get_config(arch)
            if depth:
                cfg = depth_cut(cfg, depth)
            params = init_model(cfg, 0)
            k(torch, ops, cfg, params)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        return 0

    if "--training" in sys.argv:
        # path L alone (L1, L2, L3, L4), each model initialised here at
        # the depth of the path whose weights it trains in the main run
        from repro_torch.configs import get_config
        from repro_torch.train.loop import init_model
        train_l1(torch, ops, get_config("bmoe-paper"))
        for arch, l, depth in (("recurrentgemma-2b", train_l2, D_DEPTH),
                               ("seamless-m4t-medium", train_l3, None),
                               ("mamba2-2.7b", train_l4, E_DEPTH)):
            cfg = get_config(arch)
            if depth:
                cfg = depth_cut(cfg, depth)
            params = init_model(cfg, 0)
            l(torch, ops, cfg, params)
            del params
            gc.collect()
            torch.cuda.empty_cache()
        return 0

    if "--federated" in sys.argv:
        # path M alone
        federated_path(torch, np, ops)
        return 0

    if "--mesh" in sys.argv:
        # path N alone
        mesh_path(torch, np, ops, mg, rv, am, ref)
        return 0

    if "--lm-mesh" in sys.argv:
        # path O alone
        lm_mesh_path(torch, np, ops, mg, rv, ref)
        return 0

    if "--dryrun" in sys.argv:
        # path P alone
        dryrun_alone(torch, ops)
        return 0

    if "--decode-mesh" in sys.argv:
        # path Q alone (P3 with it)
        decode_mesh_path(torch, np, ops, mg, ref)
        return 0

    if "--tensor-parallel" in sys.argv:
        # path R alone (P4 with it)
        tp_path(torch, np, ops, mg, fa, ref)
        return 0

    if "--recurrent-tp" in sys.argv:
        # path S alone (P5 with it)
        recurrent_tp_path(torch, np, ops, fa, ss, rg, ref)
        return 0

    if "--kernels" in sys.argv:
        # only the named kernels' cases, e.g. to time two trees in one call
        cases = {"moe_gemm": lambda: moe_gemm_cases(torch, mg, ref),
                 "flash_attention": lambda: flash_cases(torch, np, fa, ref),
                 "flash_attention_bwd": lambda: flash_bwd_cases(torch, np,
                                                                fa, ref),
                 "rglru_scan_bwd": lambda: rglru_bwd_cases(torch, rg, ref),
                 "ssd_scan": lambda: ssd_cases(torch, ss, ref),
                 "ssd_scan_bwd": lambda: ssd_bwd_cases(torch, ss, ref),
                 "redundancy_vote": lambda: vote_cases(torch, rv, ref),
                 "rglru_scan": lambda: rglru_cases(torch, rg, ref),
                 "audit_mlp": lambda: audit_cases(torch, am, ref)}
        for name in sys.argv[sys.argv.index("--kernels") + 1:]:
            cases[name]()
        return 0

    gemm, gemm_bwd, gemm_lm, gemm_lm_bwd = moe_gemm_cases(torch, mg, ref)
    vote, vote_court, vote_dense = vote_cases(torch, rv, ref)

    audit = audit_cases(torch, am, ref)
    flash = flash_cases(torch, np, fa, ref)
    flash_bwd = flash_bwd_cases(torch, np, fa, ref)
    scan = rglru_cases(torch, rg, ref)
    scan_bwd = rglru_bwd_cases(torch, rg, ref)
    ssd = ssd_cases(torch, ss, ref)
    ssd_bwd = ssd_bwd_cases(torch, ss, ref)

    counts = main_path(torch, np, ops)

    from repro_torch.data.synthetic import FMNIST, make_image_dataset
    _, _, xo, _ = make_image_dataset(FMNIST, n_train=10, n_test=6000,
                                     seed=1)
    xo = xo.reshape(len(xo), -1)
    xs = [xo[i * 1000:(i + 1) * 1000] for i in range(6)]
    # path A's round 1 serves batch 1; the bmoe system's clean consensus
    # on that batch is what an honest executor must serve
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    clean1, _, _ = BMoESystem(BMoEConfig(framework="bmoe"),
                              device="cuda").infer(xs[1],
                                                   attack=AttackConfig())
    counts_a = optimistic_path_a(torch, np, ops, xs, clean1)
    optimistic_path_b(torch, ops, xs[:3])
    optimistic_batch_time(torch, xs)

    # path K3 (serving with KV paging) runs on path C's weights; its
    # decode check runs 128 steps (256 before path K)
    counts_c, _, _ = lm_path(torch, ops, "qwen2.5-3b",
                             lm_counts(flash_attention=36), decode_seq=128,
                             serving=True, width1_tol=1e-4, then=lambda
                             cfg, p: (serving_k3(torch, ops, cfg, p),
                                      dryrun_p1(torch, ops, "C", cfg, p,
                                                prefill_batch(torch, cfg,
                                                              4096)))[0])
    # path L (LM training): L2 and L3 run on the weights of paths D and J
    # while they are on the card, L1 (after K2) on H's seed-0 weights
    # drawn again by ``train``
    trained_lm = {}
    counts_d, row_d, _ = lm_path(torch, ops, "recurrentgemma-2b",
                                 lm_counts(flash_attention=D_BLOCKS,
                                           rglru_scan=2 * D_BLOCKS + 2),
                                 decode_seq=2112, depth=D_DEPTH,
                                 then=lambda cfg, p: trained_lm.setdefault(
                                     "L2", train_l2(torch, ops, cfg, p)))
    # path E: 384 decode steps cross two chunk boundaries of the forward;
    # L4 trains its weights
    counts_e, _, _ = lm_path(torch, ops, "mamba2-2.7b",
                             lm_counts(ssd_scan=E_DEPTH[0]), decode_seq=384,
                             serving=True, width1_tol=5e-4, depth=E_DEPTH,
                             then=lambda cfg, p: trained_lm.setdefault(
                                 "L4", train_l4(torch, ops, cfg, p)))
    # path H: the MoE LMs, 3 moe_gemm launches a MoE layer; paths K2
    # (edge storage) and K1 (the serving engine at full width) run on
    # its bmoe-paper and qwen2-moe-a2.7b weights; qwen2-moe-a2.7b cut to
    # 12 of its 24 layers to keep the whole script within its time
    counts_h, serving = {}, {}
    for arch, n_moe, n_attn, seq, smoke, depth, k in (
            # bmoe-paper decodes 64 steps (128 before path K); L1 trains
            # its seed-0 weights, drawn again, after K2 served them
            ("bmoe-paper", 12, 12, 64, False, None,
             lambda t, o, cfg, p: (serving_k2(t, o, cfg, p),
                                   trained_lm.setdefault(
                                       "L1", train_l1(t, o, cfg)))[0]),
            # P1 after K1, on the same weights
            ("qwen2-moe-a2.7b", 12, 12, 64, False, H_QWEN_DEPTH,
             lambda t, o, cfg, p: (serving_k1(t, o, cfg, p),
                                   dryrun_p1(t, o, "H", cfg, p,
                                             prefill_batch(t, cfg,
                                                           4096)))[0]),
            # one MoE layer of 128 experts is 64 GB in fp32
            ("llama4-maverick-400b-a17b", 1, 2, 128, True, None, None)):
        counts_h[arch], _, after = lm_path(
            torch, ops, arch, lm_counts(moe_gemm=3 * n_moe,
                                        flash_attention=n_attn),
            decode_seq=seq, serving=True, smoke=smoke, depth=depth,
            then=k and (lambda cfg, p, k=k: k(torch, ops, cfg, p)))
        if after is not None:
            serving[arch] = after
    # path I: the attention configs cut in depth (qwen3-32b and
    # gemma3-27b to fit the card, all three to keep the whole script
    # within its time): qwen3-32b 12 of 64 layers, gemma3-27b 1 of 10
    # blocks of 5 local : 1 global and the 2-layer remainder,
    # pixtral-12b 20 of 40
    counts_i = {
        arch: lm_path(torch, ops, arch, lm_counts(flash_attention=n_attn),
                      decode_seq=64, depth=depth)[0]
        for arch, n_attn, depth in (("qwen3-32b", 12, (12, 12)),
                                    ("gemma3-27b", 8, (8, 1)),
                                    ("pixtral-12b", 20, (20, 20)))}
    # path J: the encoder-decoder: 12 encoder, 12 decoder self- and 12
    # cross-attention launches
    counts_j, _, _ = lm_path(torch, ops, "seamless-m4t-medium",
                             lm_counts(flash_attention=36), decode_seq=128,
                             then=lambda cfg, p: trained_lm.setdefault(
                                 "L3", train_l3(torch, ops, cfg, p)))
    ((counts_l1, row_l1), (counts_l2, row_l2), (counts_l3, row_l3),
     (counts_l4, row_l4)) = (trained_lm[k] for k in ("L1", "L2", "L3",
                                                     "L4"))
    # path F: B-MoE training under traditional and bmoe
    trained, train_prof = training_path(torch, np, ops)
    counts_fb = trained["bmoe"]["launches"]
    counts_ft = trained["traditional"]["launches"]
    # path G: optimistic training, DA in training rounds, CNN experts
    counts_g1, counts_g4, prof_g_opt, prof_g_cnn = optimistic_training_path(
        torch, np, ops, rv, ref)
    # path M: federated training; it launches no port kernel
    counts_m = federated_path(torch, np, ops)
    # path N: B-MoE on a 5-shard edge mesh, five ranks on the card
    mesh = mesh_path(torch, np, ops, mg, rv, am, ref)
    mesh_n1 = mesh["ranks"][0]["N1"]
    mesh_n2 = mesh["ranks"][0]["N2_bmoe"]
    # path O: the LM stack on a mesh, its worlds of ranks on the card
    lm_mesh = lm_mesh_path(torch, np, ops, mg, rv, ref)
    # path P: the dry run held to the card (P1 ran inside C, H and L1)
    dryrun_path(torch, lm_mesh["O1_wire"],
                sum(r["p1_s"] for r in P1_ROWS))
    # path Q: decode and the serving engine on a mesh (P3 inside it)
    dec_mesh = decode_mesh_path(torch, np, ops, mg, ref)
    # path R: FSDP placement and tensor parallelism (P4 inside it)
    tp = tp_path(torch, np, ops, mg, fa, ref)
    # path S: the recurrent mixers' tensor parallelism (P5 inside it)
    rtp = recurrent_tp_path(torch, np, ops, fa, ss, rg, ref)
    rtp_shapes = {name: [{k: r[k] for k in (
        "case", "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms")} for r in rtp[name]]
        for name in ("ssd", "ssd_bwd", "scan", "scan_bwd", "flash",
                     "flash_bwd")}
    tp_shapes = {name: [{k: r[k] for k in (
        "case", "shape", "max_abs_err", "kernel_ms", "plain_ms", "bound_ms",
        "bound_by", "library_ms")} for r in tp[name]]
        for name in ("gemm", "flash", "flash_bwd")}

    kernels = [
        {"name": "moe_gemm", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_gemm.cu",
         "replaces": "src/repro/kernels/moe_gemm.py:29",
         "launches": counts["moe_gemm"],
         "per": "one evaluate batch of 1000: layer 1 + layer 2 launch",
         "launches_by_path": {
             "evaluate (bmoe), 2 batches of 1000": counts["moe_gemm"],
             "evaluate, per batch of 1000": counts["moe_gemm"] // 2,
             "training round": trained["bmoe"]["launches_per_round"][
                 "moe_gemm"],
             "bmoe training, 30 rounds": counts_fb["moe_gemm"],
             "traditional training, 30 rounds": counts_ft["moe_gemm"],
             "optimistic training, 20 rounds + replays (G1)": counts_g1[
                 "moe_gemm"],
             "CNN training, 3 rounds (G4, bmoe)": counts_g4["bmoe"][
                 "moe_gemm"],
             "LM training, bmoe-paper, 4 steps (L1, 36 forward + 72 "
             "backward a step)": counts_l1["moe_gemm"],
             "edge mesh, a rank, 5 optimistic rounds + replays (N1)":
                 mesh_n1["moe_gemm"],
             "edge mesh, a rank, 3 bmoe rounds (N2)": mesh_n2["moe_gemm"],
             f"LM mesh, a rank, qwen2-moe EP prefill, "
             f"{LM_MESH_LAYERS['O1']} layers (O1)":
                 lm_mesh["O1"]["moe_gemm"],
             f"LM mesh, a rank, trusted EP prefill, "
             f"{LM_MESH_LAYERS['O2']} layer (O2)":
                 lm_mesh["O2_faithful"]["moe_gemm"],
             f"LM mesh, a rank, bmoe-paper training step, "
             f"{LM_MESH_LAYERS['O3']} layer (O3)":
                 lm_mesh["O3"]["moe_gemm"],
             f"LM mesh, a rank, qwen2-moe EP loss and gradients, "
             f"{LM_MESH_LAYERS['O4']} layer(s) (O4)": lm_mesh["O4"][
                 "moe_gemm"],
             f"decode mesh, a rank, qwen2-moe engine, 1 layer, "
             f"{dec_mesh['Q1_micro_steps']} micro-steps (Q1)":
                 dec_mesh["Q1"]["moe_gemm"],
             "the same engine on one device (Q1)":
                 dec_mesh["Q1_one_device"]["moe_gemm"],
             **{f"tensor parallel, a rank, bmoe-paper prefill on {s}, 2 "
                f"layers (R2)": c["moe_gemm"] for s, c in tp["R2"].items()}},
         "tp_rank_shapes": tp_shapes["gemm"],
         "lm_decode_mesh_shapes": [{k: r[k] for k in (
             "case", "shape", "max_abs_err", "kernel_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")}
             for r in dec_mesh["gemm"]],
         "lm_mesh_shapes": [{k: r[k] for k in (
             "case", "shape", "max_abs_err", "kernel_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")} for r in lm_mesh["gemm"]],
         "mesh_shard_shapes": [{k: r[k] for k in (
             "case", "shape", "max_abs_err", "kernel_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")} for r in mesh["gemm"]],
         "backward": [{k: r[k] for k in ("case", "shape", "max_abs_err",
                                         "kernel_ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")}
                      for r in gemm_bwd],
         "lm_shapes": [{k: r[k] for k in ("case", "shape", "max_abs_err",
                                          "kernel_ms", "plain_ms",
                                          "bound_ms", "bound_by",
                                          "library_ms")}
                       for r in gemm_lm],
         "lm_backward_shapes": [{k: r[k] for k in (
             "case", "shape", "max_abs_err", "kernel_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")} for r in gemm_lm_bwd],
         "lm_training_step_device_ms": {
             "forward": row_l1["profile"]["moe_gemm_forward_ms"],
             "backward": row_l1["profile"]["moe_gemm_backward_ms"]},
         "lm_prefill_launches": {a: c["moe_gemm"]
                                 for a, c in counts_h.items()},
         "serving_launches": {
             f"{a} ({'K1' if a.startswith('qwen') else 'K2'}), {m} "
             f"micro-steps": c["moe_gemm"]
             for a, (c, m) in serving.items()},
         "training_round_device_us": {
             fw: {"forward": prof["moe_gemm_forward_us"],
                  "backward": prof["moe_gemm_backward_us"]}
             for fw, prof in [*train_prof.items(),
                              ("optimistic", prof_g_opt)]},
         "max_abs_err": max(r["max_abs_err"] for r in
                            gemm + gemm_bwd + gemm_lm + gemm_lm_bwd),
         "ms": sum(r["kernel_ms"] for r in gemm),
         "plain_ms": sum(r["plain_ms"] for r in gemm),
         "bound_ms": sum(r["bound_ms"] for r in gemm),
         "bound_by": gemm[0]["bound_by"],
         "bound_fp32_cores_ms": sum(r["bound_fp32_cores_ms"] for r in gemm),
         "library_ms": sum(r["library_ms"] for r in gemm)},
        {"name": "redundancy_vote", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/vote.cu",
         "replaces": "src/repro/kernels/redundancy_vote.py:39",
         "launches": counts["redundancy_vote"],
         "per": "one evaluate batch of 1000: pub (10,10,3760)",
         "launches_by_path": {
             "evaluate (bmoe), 2 batches of 1000": counts["redundancy_vote"],
             "bmoe training round": trained["bmoe"]["launches_per_round"][
                 "redundancy_vote"],
             "bmoe training, 30 rounds": counts_fb["redundancy_vote"],
             "traditional training, 30 rounds": counts_ft[
                 "redundancy_vote"],
             "optimistic path A (court)": counts_a["redundancy_vote"],
             "optimistic training, 20 rounds (G1, courts)": counts_g1[
                 "redundancy_vote"],
             "CNN bmoe training, 3 rounds (G4)": counts_g4["bmoe"][
                 "redundancy_vote"],
             "CNN traditional training, 3 rounds (G4)": counts_g4[
                 "traditional"]["redundancy_vote"],
             "dense-dispatch CNN bmoe round (G4)": counts_g4["dense_round"][
                 "redundancy_vote"],
             "edge mesh, a rank, 3 bmoe rounds (N2)": mesh_n2[
                 "redundancy_vote"],
             "edge mesh, a rank, optimistic courts (N1)": mesh_n1[
                 "redundancy_vote"],
             "LM mesh, a rank, trusted EP prefill, faithful (O2)": lm_mesh[
                 "O2_faithful"]["redundancy_vote"],
             "LM mesh, a rank, trusted EP prefill, digest (O2)": lm_mesh[
                 "O2_digest"]["redundancy_vote"],
             "LM mesh, a rank, bmoe-paper training step (O3)": lm_mesh[
                 "O3"]["redundancy_vote"]},
         "lm_mesh_shape": {k: lm_mesh["vote"][k] for k in (
             "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "launch_floor_ms")},
         "mesh_shard_shape": {k: mesh["vote"][k] for k in (
             "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "launch_floor_ms")},
         "max_abs_err": vote["max_abs_err"], "ms": vote["kernel_ms"],
         "plain_ms": vote["plain_ms"], "bound_ms": vote["bound_ms"],
         "bound_by": vote["bound_by"], "library_ms": None,
         "launch_floor_ms": vote["launch_floor_ms"],
         "training_round_device_us": train_prof["bmoe"]["vote_us"],
         "cnn_training_round_device_us": prof_g_cnn["vote_us"],
         "court_shape": {k: vote_court[k] for k in (
             "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "launch_floor_ms")},
         "dense_shape": {k: vote_dense[k] for k in (
             "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "launch_floor_ms")}},
        {"name": "audit_mlp", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/audit_mlp.cu",
         "replaces": "src/repro/kernels/audit_gemm.py:58",
         "launches": counts_a["audit_mlp"],
         "launches_by_path": {
             "optimistic path A, 6 batches + flush": counts_a["audit_mlp"],
             "optimistic training, 20 rounds (G1)": counts_g1["audit_mlp"],
             "edge mesh, a rank, 5 optimistic rounds + flush (N1)":
                 mesh_n1["audit_mlp"]},
         "mesh_shard_shape": {k: mesh["audit"][k] for k in (
             "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "composition_ms")},
         "per": "optimistic path A (6 batches of 1000 + flush); times at "
                "the commit shape x (40,94,784), bank E=10",
         "train_merged_shape": {k: audit[4][k] for k in (
             "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "composition_ms")},
         "max_abs_err": max(r["max_abs_err"] for r in audit),
         "ms": audit[0]["kernel_ms"], "plain_ms": audit[0]["plain_ms"],
         "bound_ms": audit[0]["bound_ms"], "bound_by": audit[0]["bound_by"],
         "bound_fp32_cores_ms": audit[0]["bound_fp32_cores_ms"],
         "library_ms": None, "composition": audit[0]["composition"],
         "composition_ms": audit[0]["composition_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:64",
         "launches": counts_c["flash_attention"],
         "launches_by_path": {
             "qwen2.5-3b prefill": counts_c["flash_attention"],
             "recurrentgemma-2b prefill": counts_d["flash_attention"],
             **{f"{a} prefill": c["flash_attention"]
                for a, c in {**counts_h, **counts_i}.items()},
             "seamless-m4t-medium prefill (12 encoder, 12 self, 12 "
             "cross)": counts_j["flash_attention"],
             "bmoe-paper training, 4 steps (L1)": counts_l1[
                 "flash_attention"],
             "recurrentgemma-2b training, 2 steps of 2 microbatches, "
             "remat (L2)": counts_l2["flash_attention"],
             "seamless-m4t-medium training, 2 steps (L3)": counts_l3[
                 "flash_attention"],
             **{f"LM mesh, a rank ({p})": lm_mesh[p]["flash_attention"]
                for p in ("O1", "O2_faithful", "O3", "O4")},
             "tensor parallel, a rank, qwen3-32b training step, 2 layers, "
             "remat (R1)": tp["R1"]["flash_attention"],
             **{f"recurrent tp, a rank, {k} (S)": c["flash_attention"]
                for k, c in rtp["launches"].items()
                if c["flash_attention"]}},
         "tp_rank_shapes": tp_shapes["flash"],
         "recurrent_tp_rank_shapes": rtp_shapes["flash"],
         "non_causal_shape": {k: flash[2][k] for k in (
             "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "library_backend")},
         "per": "one qwen2.5-3b prefill at (1, 4096); times per layer, "
                "q (1,4096,16,128), kv heads 2, causal, fp32",
         "max_abs_err": max(r["max_abs_err"] for r in flash),
         "ms": flash[0]["kernel_ms"], "plain_ms": flash[0]["plain_ms"],
         "bound_ms": flash[0]["bound_ms"], "bound_by": flash[0]["bound_by"],
         "bound_fp32_cores_ms": flash[0]["bound_fp32_cores_ms"],
         "library_ms": flash[0]["library_ms"]},
        {"name": "flash_attention_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "replaces": "src/repro/kernels/flash_attention.py:64 (the "
                     "gradient JAX takes of src/repro/models/layers.py:48)",
         "launches": counts_l1["flash_attention_bwd"],
         "launches_by_path": {
             "bmoe-paper training, 4 steps (L1)": counts_l1[
                 "flash_attention_bwd"],
             "recurrentgemma-2b training, 2 steps of 2 microbatches (L2)":
                 counts_l2["flash_attention_bwd"],
             "seamless-m4t-medium training, 2 steps (L3)": counts_l3[
                 "flash_attention_bwd"],
             "tensor parallel, a rank, qwen3-32b training step, 2 layers "
             "(R1)": tp["R1"]["flash_attention_bwd"],
             **{f"recurrent tp, a rank, {k} (S)": c["flash_attention_bwd"]
                for k, c in rtp["launches"].items()
                if c["flash_attention_bwd"]}},
         "tp_rank_shapes": tp_shapes["flash_bwd"],
         "recurrent_tp_rank_shapes": rtp_shapes["flash_bwd"],
         "cuda_launches_per_call": flash_bwd[0]["cuda_launches_per_call"],
         "per": "one qwen2.5-3b layer's backward at (1, 4096): q "
                "(1,4096,16,128), kv heads 2, causal, fp32",
         "shapes": [{k: r[k] for k in (
             "case", "shape", "fp64_err_kernel", "fp64_err_plain",
             "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "library_backend", "passes_us")}
             for r in flash_bwd],
         "training_step_device_ms": row_l1["profile"]["flash_backward_ms"],
         "training_step_share": {
             "L1": row_l1["profile"]["shares"]["flash_backward"],
             "L2": row_l2["profiled_step"]["flash_backward_share"],
             "L3": row_l3["profiled_step"]["flash_backward_share"]},
         "max_abs_err": max(r["max_abs_err"] for r in flash_bwd),
         "ms": flash_bwd[0]["kernel_ms"], "plain_ms": flash_bwd[0][
             "plain_ms"], "bound_ms": flash_bwd[0]["bound_ms"],
         "bound_by": flash_bwd[0]["bound_by"],
         "bound_fp32_cores_ms": flash_bwd[0]["bound_fp32_cores_ms"],
         "library_ms": flash_bwd[0]["library_ms"]},
        {"name": "rglru_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:41",
         "launches": counts_d["rglru_scan"],
         "launches_by_path": {
             "recurrentgemma-2b prefill (D)": counts_d["rglru_scan"],
             **{f"recurrent tp, a rank, {k} (S)": c["rglru_scan"]
                for k, c in rtp["launches"].items() if c["rglru_scan"]}},
         "tp_rank_shapes": rtp_shapes["scan"],
         "per": "one recurrentgemma-2b prefill at (1, 4096); times per "
                "layer, (1,4096,2560)",
         "max_abs_err": max(r["max_abs_err"] for r in scan),
         "cuda_launches_per_call": scan[0]["cuda_launches_per_call"],
         "path_cuda_launches": row_d["rglru_profiled"]["cuda_launches"],
         "path_device_ms": row_d["rglru_profiled"]["device_ms"],
         "ms": scan[0]["kernel_ms"], "plain_ms": scan[0]["plain_ms"],
         "bound_ms": scan[0]["bound_ms"], "bound_by": scan[0]["bound_by"],
         "design_floor_ms": scan[0]["design_floor_ms"], "library_ms": None,
         "training_launches": counts_l2["rglru_scan"]},
        {"name": "rglru_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rglru_scan.cu",
         "replaces": "src/repro/kernels/rglru_scan.py:41 (the gradient "
                     "JAX takes of src/repro/models/rglru.py:55)",
         "launches": counts_l2["rglru_scan_bwd"],
         "launches_by_path": {
             "recurrentgemma-2b training, 2 steps of 2 microbatches (L2)":
                 counts_l2["rglru_scan_bwd"],
             **{f"recurrent tp, a rank, {k} (S)": c["rglru_scan_bwd"]
                for k, c in rtp["launches"].items() if c["rglru_scan_bwd"]}},
         "tp_rank_shapes": rtp_shapes["scan_bwd"],
         "per": "one recurrentgemma-2b layer's backward at (1, 4096), "
                "(1,4096,2560)",
         "max_abs_err": max(r["max_abs_err"] for r in scan_bwd),
         "fp64_err_kernel": scan_bwd[0]["fp64_err_kernel"],
         "fp64_err_plain": scan_bwd[0]["fp64_err_plain"],
         "ms": scan_bwd[0]["kernel_ms"], "plain_ms": scan_bwd[0]["plain_ms"],
         "bound_ms": scan_bwd[0]["bound_ms"],
         "bound_by": scan_bwd[0]["bound_by"],
         "design_floor_ms": scan_bwd[0]["design_floor_ms"],
         "library_ms": None},
        {"name": "ssd_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:53",
         "launches": counts_e["ssd_scan"],
         "launches_by_path": {
             "mamba2-2.7b prefill (E)": counts_e["ssd_scan"],
             **{f"recurrent tp, a rank, {k} (S)": c["ssd_scan"]
                for k, c in rtp["launches"].items() if c["ssd_scan"]}},
         "tp_rank_shapes": rtp_shapes["ssd"],
         "per": "one mamba2-2.7b prefill at (1, 4096); times per layer, "
                "x (1,4096,80,64), N 128, chunk 128",
         "max_abs_err": max(r["max_abs_err"] for r in ssd),
         "cuda_launches_per_call": ssd[0]["cuda_launches_per_call"],
         "ms": ssd[0]["kernel_ms"], "plain_ms": ssd[0]["plain_ms"],
         "bound_ms": ssd[0]["bound_ms"], "bound_by": ssd[0]["bound_by"],
         "bound_fp32_cores_ms": ssd[0]["bound_fp32_cores_ms"],
         "library_ms": None,
         "training_launches": counts_l4["ssd_scan"]},
        {"name": "ssd_scan_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
         "replaces": "src/repro/kernels/ssd_scan.py:53 (the gradient JAX "
                     "takes of src/repro/models/ssm.py:50)",
         "launches": counts_l4["ssd_scan_bwd"],
         "launches_by_path": {
             "mamba2-2.7b training, 2 steps of 4 microbatches (L4)":
                 counts_l4["ssd_scan_bwd"],
             **{f"recurrent tp, a rank, {k} (S)": c["ssd_scan_bwd"]
                for k, c in rtp["launches"].items() if c["ssd_scan_bwd"]}},
         "tp_rank_shapes": rtp_shapes["ssd_bwd"],
         "per": "one mamba2-2.7b layer's backward at (1, 4096), x "
                "(1,4096,80,64), N 128, chunk 128",
         "cuda_launches_per_call": ssd_bwd[0]["cuda_launches_per_call"],
         "shapes": [{k: r[k] for k in (
             "case", "shape", "fp64_err_kernel", "fp64_err_plain",
             "fp64_err_chunked", "kernel_ms", "plain_ms", "bound_ms",
             "bound_by")} for r in ssd_bwd],
         "training_step_device_ms": row_l4["profiled_step"][
             "ssd_backward_ms"],
         "training_step_share": row_l4["profiled_step"][
             "ssd_backward_share"],
         "max_abs_err": max(r["max_abs_err"] for r in ssd_bwd),
         "ms": ssd_bwd[0]["kernel_ms"], "plain_ms": ssd_bwd[0]["plain_ms"],
         "bound_ms": ssd_bwd[0]["bound_ms"],
         "bound_by": ssd_bwd[0]["bound_by"],
         "bound_fp32_cores_ms": ssd_bwd[0]["bound_fp32_cores_ms"],
         "library_ms": None},
    ]
    for k in kernels:
        # federated training (path M) reaches no kernel: held to zero
        k["launches_federated_path_m"] = counts_m[k["name"]]
        # path N, rank 0 of 5: every run's launches (N1, N2 and infers)
        k["launches_mesh_path_n_rank0"] = sum(
            lr[k["name"]] for ph, lr in mesh["ranks"][0].items()
            if ph != "N1_want")
        # path O, rank 0 of each world: the counted run of each sub-path
        k["launches_lm_mesh_path_o_rank0"] = {
            p: lm_mesh[p][k["name"]] for p in ("O1", "O2_faithful",
                                                "O2_digest", "O3", "O4")}
        # path Q, rank 0 of 4: Q1's engine run (Q2 launches no kernel)
        k["launches_decode_mesh_path_q_rank0"] = dec_mesh["Q1"][k["name"]]
        # path R, rank 0 of 4: R1's step and R2's prefills (R3's decode
        # launches no kernel)
        k["launches_tp_path_r_rank0"] = {
            "R1": tp["R1"][k["name"]],
            **{f"R2 {s}": c[k["name"]] for s, c in tp["R2"].items()}}
        # path S, rank 0 of 4: each training step and prefill (its decode
        # launches no kernel)
        k["launches_recurrent_tp_path_s_rank0"] = {
            p: c[k["name"]] for p, c in rtp["launches"].items()}
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
