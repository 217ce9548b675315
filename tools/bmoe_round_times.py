"""Warm B-MoE training-round times on the card, to compare two trees (or
the mesh forward against the one-device one) in one call.

    python3 tools/bmoe_round_times.py [--src DIR] [--label NAME]
                                      [--rounds 8] [--mesh-one-shard]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), builds
that tree's kernel library, and times ``BMoESystem.train_round`` at the
paper's widths (N=10 experts, M=10 edges, K=3, tasks of 1000, 3 of 10
edges colluding with noise 5 under ``traditional`` and ``bmoe``): the MLP
bank on Fashion-MNIST under ``traditional``, ``bmoe`` and ``optimistic``
(clean, audit rate 1), and the CNN bank on CIFAR-10 under ``bmoe``.  Each
configuration runs 2 rounds to warm up, then ``--rounds`` rounds whose
host walls (synchronised) are kept, then one more round under
``torch.profiler``: its device busy time (every device event, copies
included) and its count of device kernels.  Beside each timed round's
wall stand the proof-of-work hashes its blocks took (their nonces + 1):
the host's mining time follows them, and they change with any bit of a
block's payload, the parameters' digests included.  ``--mesh-one-shard``
adds the MLP ``bmoe`` and ``optimistic`` configurations with ``mesh="on"`` in a
process without a process group (one shard: the mesh forward with the
identity for its exchanges).  Prints the card's name and power limit,
then one JSON line a configuration.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def _profile(torch, run):
    """(device busy ms, device kernels) of one call of ``run``."""
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
    events = [ev for ev in prof.events()
              if ev.device_type == DeviceType.CUDA
              and not ev.name.startswith("ProfilerStep")]
    return sum(ev.time_range.elapsed_us() for ev in events) / 1e3, len(events)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--mesh-one-shard", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(os.path.abspath(args.src), "src"))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.attacks import AttackConfig
    from repro_torch.core.bmoe import BMoEConfig, BMoESystem
    from repro_torch.data.synthetic import (CIFAR10, FMNIST,
                                            make_image_dataset)
    from repro_torch.kernels import build
    from repro_torch.trust.protocol import TrustConfig
    build.library()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)

    fx, fy, _, _ = make_image_dataset(FMNIST, n_train=10000, n_test=10,
                                      seed=0)
    fx = fx.reshape(len(fx), -1)
    cx, cy, _, _ = make_image_dataset(CIFAR10, n_train=3000, n_test=10,
                                      seed=0)
    cx = cx.astype(np.float32)
    atk = AttackConfig(malicious_edges=(7, 8, 9), attack_prob=1.0,
                       noise_std=5.0)
    trust = TrustConfig(audit_rate=1.0)
    cases = [("mlp traditional", dict(framework="traditional", attack=atk),
              fx, fy),
             ("mlp bmoe", dict(framework="bmoe", attack=atk), fx, fy),
             ("mlp optimistic", dict(framework="optimistic", trust=trust),
              fx, fy),
             ("cnn bmoe", dict(framework="bmoe", attack=atk,
                               expert_kind="cnn", in_ch=3, lr=0.1), cx, cy)]
    if args.mesh_one_shard:
        cases += [("mlp bmoe, mesh on (1 shard)",
                   dict(framework="bmoe", attack=atk, mesh="on"), fx, fy),
                  ("mlp optimistic, mesh on (1 shard)",
                   dict(framework="optimistic", trust=trust, mesh="on"),
                   fx, fy)]
    for name, kw, x, y in cases:
        sys_ = BMoESystem(BMoEConfig(**kw), device="cuda")
        rng = np.random.default_rng(5)
        walls, hashes = [], []
        for r in range(2 + args.rounds):
            idx = rng.integers(0, len(x), 1000)
            n_blocks = len(sys_.ledger.blocks)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sys_.train_round(x[idx], y[idx])
            torch.cuda.synchronize()
            if r >= 2:
                walls.append((time.perf_counter() - t0) * 1e3)
                hashes.append(sum(b.nonce + 1 for b in
                                  sys_.ledger.blocks[n_blocks:]))
        idx = rng.integers(0, len(x), 1000)
        busy, kernels = _profile(torch,
                                 lambda: sys_.train_round(x[idx], y[idx]))
        print(json.dumps({"label": args.label, "config": name,
                          "wall_ms": walls,
                          "median_wall_ms": float(np.median(walls)),
                          "device_busy_ms": busy,
                          "device_kernels": kernels,
                          "pow_hashes": hashes}), flush=True)
        del sys_
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
