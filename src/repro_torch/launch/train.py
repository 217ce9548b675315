"""Training launcher: ``python -m repro_torch.launch.train --arch <id>``
(the counterpart of ``repro.launch.train``, with the same flags and
``--device``).

Trains a config (its smoke width unless ``--full``) on synthetic LM
batches through ``train.loop.train`` and prints the loss as it falls.  The
model runs on ``--device`` (default ``cuda``; the CPU only when asked
for).  An encoder-decoder model is fed stub frames as long as its tokens.

``--mesh d,m`` trains on a (data=d, model=m) mesh: the launcher starts a
world of d*m ranks on this host itself (``launch.mesh.spawn_edges``; on
the card it builds the kernels first), every rank runs the same loop on
its part (``train.step``'s SPMD step), and rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import lm_batches, stub_embeddings
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import make_lm_mesh, spawn_edges
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding import is_expert_parallel
from repro_torch.train.loop import train

MESH_TIMEOUT_S = 900.0


def _with_frames(batches, cfg, device):
    for n, batch in enumerate(batches):
        B, S = batch["tokens"].shape
        yield dict(batch, frames=stub_embeddings(B, S, cfg.d_model, seed=n,
                                                 device=device))


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="bmoe-paper", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--full", action="store_true",
                    help="use the full (not smoke) config")
    ap.add_argument("--mesh", default=None,
                    help="'data,model' sizes: train on that many ranks")
    ap.add_argument("--device", default="cuda",
                    help="device the model trains on (default: cuda)")
    return ap


def _run(args, mesh=None, verbose=True):
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    say = print if verbose else (lambda *a, **k: None)
    devices = (mesh.world if mesh is not None else
               torch.cuda.device_count() if dev.type == "cuda" else 1)
    say(f"[train] arch={cfg.name} smoke={not args.full} "
        f"steps={args.steps} devices={devices}"
        + (f" mesh={mesh.axes}" if mesh is not None else ""))
    batches = lm_batches(cfg.vocab_size, args.batch, args.seq, seed=0)
    if cfg.is_encoder_decoder:
        batches = _with_frames(batches, cfg, dev)
    _, history = train(
        cfg, batches, steps=args.steps, device=dev, mesh=mesh,
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=10,
                            total_steps=args.steps),
        log_every=max(args.steps // 10, 1),
        callback=lambda m: say(
            f"  step {m['step']:5d} loss={m['loss']:.4f} "
            f"grad_norm={m['grad_norm']:.3f} ({m['wall_s']:.0f}s)"))
    say(f"[train] done: loss {history[0]['loss']:.3f} -> "
        f"{history[-1]['loss']:.3f}")
    return history


def _mesh_rank(rank: int, world: int, argv, shape, out_dir: str) -> None:
    """One rank of ``--mesh``'s world: the same loop on its part; rank 0
    prints and leaves the history in ``out_dir``."""
    args = _parser().parse_args(argv)
    if resolve_device(args.device).type == "cpu":   # ranks share the cores
        torch.set_num_threads(1)
    mesh = make_lm_mesh(shape, ("data", "model"), device=args.device)
    history = _run(args, mesh, verbose=rank == 0)
    if rank == 0:
        with open(os.path.join(out_dir, "history.pkl"), "wb") as f:
            pickle.dump(history, f)


def _check_mesh(cfg, shape) -> None:
    """Refuse, before any rank starts, a (data, model) mesh the config
    cannot train on: the B-MoE vote needs a replica axis (as
    ``core.trusted_moe.make_trust`` raises), expert parallelism a model
    axis that divides the experts."""
    if cfg.redundancy.mode != "off":
        raise ValueError(f"{cfg.name}'s redundancy vote needs a 'replica' "
                         f"mesh axis; --mesh gives (data, model)")
    if is_expert_parallel(cfg, shape) and \
            cfg.resolved_padded_experts % shape[1]:
        raise ValueError(f"EP needs experts ({cfg.resolved_padded_experts})"
                         f" % model axis ({shape[1]}) == 0")


def main(argv=None):
    args = _parser().parse_args(argv)
    if not args.mesh:
        return _run(args)
    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) != 2:
        raise ValueError(f"--mesh wants 'data,model', got {args.mesh!r}")
    _check_mesh(get_config(args.arch, smoke=not args.full), shape)
    if resolve_device(args.device).type == "cuda":
        from repro_torch.kernels import build
        build.library()          # once, before the ranks load it
    with tempfile.TemporaryDirectory() as out:
        spawn_edges(_mesh_rank, shape[0] * shape[1],
                    args=(argv, shape, out), device=args.device,
                    rendezvous_dir=out, timeout_s=MESH_TIMEOUT_S)
        with open(os.path.join(out, "history.pkl"), "rb") as f:
            return pickle.load(f)


if __name__ == "__main__":
    main()
