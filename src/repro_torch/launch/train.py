"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(the counterpart of ``repro.launch.train``, with the same flags and
``--device``).

Trains a config (its smoke width unless ``--full``) on synthetic LM
batches through ``train.loop.train`` and prints the loss as it falls.  The
model runs on ``--device`` (default ``cuda``; the CPU only when asked
for).  An encoder-decoder model is fed stub frames as long as its tokens.
``--mesh`` is not ported (ROADMAP A7b) and raises.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import lm_batches, stub_embeddings
from repro_torch.kernels.ops import resolve_device
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import train


def _with_frames(batches, cfg, device):
    for n, batch in enumerate(batches):
        B, S = batch["tokens"].shape
        yield dict(batch, frames=stub_embeddings(B, S, cfg.d_model, seed=n,
                                                 device=device))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bmoe-paper", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the full (not smoke) config")
    ap.add_argument("--mesh", default=None,
                    help="'data,model' sizes (not ported: ROADMAP A7b)")
    ap.add_argument("--device", default="cuda",
                    help="device the model trains on (default: cuda)")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError("--mesh is not ported yet (ROADMAP A7b): "
                                  "the port trains on one device")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    devices = torch.cuda.device_count() if dev.type == "cuda" else 1
    print(f"[train] arch={cfg.name} smoke={not args.full} "
          f"steps={args.steps} devices={devices}")
    batches = lm_batches(cfg.vocab_size, args.batch, args.seq, seed=0)
    if cfg.is_encoder_decoder:
        batches = _with_frames(batches, cfg, dev)
    _, history = train(
        cfg, batches, steps=args.steps, device=dev,
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=10,
                            total_steps=args.steps),
        log_every=max(args.steps // 10, 1),
        callback=lambda m: print(
            f"  step {m['step']:5d} loss={m['loss']:.4f} "
            f"grad_norm={m['grad_norm']:.3f} ({m['wall_s']:.0f}s)"))
    print(f"[train] done: loss {history[0]['loss']:.3f} -> "
          f"{history[-1]['loss']:.3f}")
    return history


if __name__ == "__main__":
    main()
