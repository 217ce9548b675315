"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``
(the counterpart of ``repro.launch.serve``, with the same flags and the
config's smoke width).

Drives the continuous-batching serving engine (per-tick admit/evict,
fused chunked prefill, greedy decode; ``--scheduling fixed`` for the
batch-synchronous baseline) over synthetic requests and reports
throughput.  The model runs on ``--device`` (default ``cuda``; the CPU
only when asked for).
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.data.synthetic import serving_requests
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.scheduler import POLICIES
from repro_torch.train.loop import init_model


def main(argv=None):
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
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    if cfg.is_encoder_decoder:
        raise SystemExit("the serving launcher takes decoder-only archs")
    params = init_model(cfg, seed=0, device=args.device)
    engine = ServingEngine(cfg, params, batch_slots=args.slots,
                           cache_len=args.cache_len,
                           scheduling=args.scheduling,
                           prefill_chunk=args.prefill_chunk)
    reqs = list(serving_requests(cfg.vocab_size, args.requests,
                                 max_prompt=args.max_prompt,
                                 max_new=args.max_new, seed=0))
    engine.submit(reqs)
    done = engine.run()
    dt = engine.report()["tick_s"]     # wall seconds from the registry
    total_tokens = sum(len(v) for v in done.values())
    print(f"[serve] arch={cfg.name} device={params['embed'].device} "
          f"completed {len(done)}/{len(reqs)} requests, {total_tokens} "
          f"tokens in {dt:.1f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s)")
    for rid in sorted(done)[:5]:
        print(f"  req {rid}: {done[rid]}")
    return done


if __name__ == "__main__":
    main()
