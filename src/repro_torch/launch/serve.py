"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``
(the counterpart of ``repro.launch.serve``, with the same flags and the
config's smoke width).

Drives the continuous-batching serving engine (per-tick admit/evict,
fused chunked prefill, greedy decode; ``--scheduling fixed`` for the
batch-synchronous baseline) over synthetic requests and reports
throughput.  The model runs on ``--device`` (default ``cuda``; the CPU
only when asked for).

``--mesh d,m`` serves on a (data=d, model=m) mesh: the launcher starts a
world of d*m ranks on this host itself (``launch.mesh.spawn_edges``; on
the card it builds the kernels first), every rank runs the same engine
on the same requests on its part (``ServingEngine(mesh=)``: its batch
slots' rows, its part of the cache's positions, its experts under
expert parallelism), and rank 0 prints.
"""
from __future__ import annotations

import argparse
import os
import pickle
import tempfile

import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import serving_requests
from repro_torch.kernels.ops import resolve_device
from repro_torch.launch.mesh import make_lm_mesh, spawn_edges
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.scheduler import POLICIES
from repro_torch.train.loop import init_model

MESH_TIMEOUT_S = 900.0


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--max-prompt", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--scheduling", choices=list(POLICIES),
                    default="continuous")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="max prompt tokens fused per step")
    ap.add_argument("--device", default="cuda",
                    help="device the model runs on (default: cuda)")
    ap.add_argument("--mesh", default=None,
                    help="'data,model' sizes: serve on that many ranks")
    return ap


def _serve(args, mesh=None, verbose=True):
    cfg = get_config(args.arch, smoke=True)
    if cfg.is_encoder_decoder:
        raise SystemExit("the serving launcher takes decoder-only archs")
    dev = mesh.device if mesh is not None else args.device
    params = init_model(cfg, seed=0, device=dev, mesh=mesh, kind="decode")
    engine = ServingEngine(cfg, params, batch_slots=args.slots,
                           cache_len=args.cache_len, mesh=mesh,
                           scheduling=args.scheduling,
                           prefill_chunk=args.prefill_chunk)
    reqs = list(serving_requests(cfg.vocab_size, args.requests,
                                 max_prompt=args.max_prompt,
                                 max_new=args.max_new, seed=0))
    engine.submit(reqs)
    done = engine.run()
    dt = engine.report()["tick_s"]     # wall seconds from the registry
    total_tokens = sum(len(v) for v in done.values())
    if verbose:
        where = (f"mesh={mesh.axes}" if mesh is not None
                 else f"device={params['embed'].device}")
        print(f"[serve] arch={cfg.name} {where} completed "
              f"{len(done)}/{len(reqs)} requests, {total_tokens} tokens in "
              f"{dt:.1f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s)")
        for rid in sorted(done)[:5]:
            print(f"  req {rid}: {done[rid]}")
    return done


def _mesh_rank(rank: int, world: int, argv, shape, out_dir: str) -> None:
    """One rank of ``--mesh``'s world: the same engine on its part; rank
    0 prints and leaves the completed requests in ``out_dir``."""
    args = _parser().parse_args(argv)
    if resolve_device(args.device).type == "cpu":   # ranks share the cores
        torch.set_num_threads(1)
    mesh = make_lm_mesh(shape, ("data", "model"), device=args.device)
    done = _serve(args, mesh, verbose=rank == 0)
    if rank == 0:
        with open(os.path.join(out_dir, "done.pkl"), "wb") as f:
            pickle.dump(done, f)


def main(argv=None):
    args = _parser().parse_args(argv)
    if not args.mesh:
        return _serve(args)
    shape = tuple(int(x) for x in args.mesh.split(","))
    if len(shape) != 2:
        raise ValueError(f"--mesh wants 'data,model', got {args.mesh!r}")
    if resolve_device(args.device).type == "cuda":
        from repro_torch.kernels import build
        build.library()          # once, before the ranks load it
    with tempfile.TemporaryDirectory() as out:
        spawn_edges(_mesh_rank, shape[0] * shape[1],
                    args=(argv, shape, out), device=args.device,
                    rendezvous_dir=out, timeout_s=MESH_TIMEOUT_S)
        with open(os.path.join(out, "done.pkl"), "rb") as f:
            return pickle.load(f)


if __name__ == "__main__":
    main()
