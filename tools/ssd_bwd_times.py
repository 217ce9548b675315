"""Device time of the SSD backward kernel of a source tree, quickly.

Times ``ssd_scan_bwd`` of the tree at ROOT (its ``src/repro_torch``) at
``chip_smoke.py``'s backward cases (``SSD_BWD_CASES``, inputs drawn by
its ``ssd_bwd_inputs``) by that script's ``time_ms`` (a CUDA graph
replayed between two events), and each CUDA launch of the
mamba2-2.7b layer's call by its ``profile_batch``; one JSON line.  No
accuracy check (``chip_smoke.py --kernels ssd_scan_bwd`` holds the
kernel to its bars).  Two trees are compared in turns in one call, e.g.
a parent unpacked with ``git archive`` into a gitignored directory:

    python3 tools/ssd_bwd_times.py build/parent   # on an H100
    python3 tools/ssd_bwd_times.py .
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
    sys.path[:0] = [os.path.join(root, "src"), HERE]
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build, ssd_scan as ss
    if not ss.__file__.startswith(root):
        raise SystemExit(f"imported {ss.__file__}, not the tree at {root}")
    build.library()
    out = {"tree": sys.argv[1] if len(sys.argv) > 1 else ".",
           "device": torch.cuda.get_device_name(0)}
    for name, seed, B, S, H, P, N, chunk, decay in cs.SSD_BWD_CASES:
        args = cs.ssd_bwd_inputs(torch, seed, B, S, H, P, N, decay)

        def run():
            return ss.ssd_scan_bwd(*args, chunk=chunk)
        out[name] = cs.time_ms(run, iters=3 if name == "mamba2_layer"
                               else 20)
        if name == "mamba2_layer":
            prof = cs.profile_batch(torch, run, cpu=False)["ssd"]
            out["launches_us"] = {k: v["device_us"]
                                  for k, v in prof["by_kernel"].items()}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
