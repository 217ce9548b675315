"""The SSD backward's float64 errors over the plain loop's, per shape.

For each shape of the SSD backward's card tests (``tests/test_torch_cuda.py``:
the nine value shapes, the strided views, dt and A x4 and x50 / x20) it
prints one JSON line: the float64 error of the kernel, of the chunked form by
autograd and of the kernel's decomposition emulated with 3xTF32 products
(``tests/test_torch_tf32x3.py``), each divided by the float32 error of the
plain reverse loop (``ssd_scan_bwd_ref``), per gradient.  The card tests hold
the kernel to 2 of these at unit decay.

    PYTHONPATH=src python3 tools/ssd_bwd_ratios.py            # on an H100
    PYTHONPATH=src python3 tools/ssd_bwd_ratios.py --device cpu   # no kernel
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "tests"), os.path.join(ROOT, "src")]

import torch  # noqa: E402

import test_torch_cuda as tc  # noqa: E402
import test_torch_tf32x3 as t  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

# (B, S, H, P, N, chunk) of test_ssd_scan_bwd_kernel_matches_plain
SHAPES = [(2, 256, 3, 16, 8, 32), (1, 64, 1, 32, 16, 64),
          (1, 48, 16, 32, 32, 128), (1, 512, 4, 64, 128, 128),
          (2, 96, 5, 24, 40, 96), (1, 21, 2, 7, 3, 7),
          (1, 200, 3, 64, 128, 100), (3, 300, 4, 64, 128, 100),
          (1, 1024, 8, 64, 128, 128)]


def cases(device):
    """(name, operands, chunk) as the card tests draw them."""
    for B, S, H, P, N, chunk in SHAPES:
        yield (str((B, S, H, P, N, chunk)),
               tc._ssd_bwd_args(S + P, B, S, H, P, N, device), chunk)
    x, dt, A, Bm, Cm, dy = tc._ssd_bwd_args(22, 2, 256, 4, 32, 16, device)
    yield ("strided", [torch.cat([x, x], 2)[:, :, 1:5],
                       torch.cat([dt, dt], 2)[:, :, 2:6], A, Bm, Cm, dy], 64)
    for sd, sa in ((4.0, 4.0), (50.0, 20.0)):
        x, dt, A, Bm, Cm, dy = tc._ssd_bwd_args(23, 2, 512, 4, 64, 128,
                                                device)
        yield f"dt x{sd:g}, A x{sa:g}", [x, dt * sd, A * sa, Bm, Cm, dy], 128


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    device = ap.parse_args().device
    for name, args, chunk in cases(device):
        Q = min(chunk, args[0].shape[1])
        refs = t.ssd_bwd_refs(*args, Q)
        emul = t.ssd_bwd_errors(t.ssd_bwd_chunks(*args, Q, t.mm_3xtf32),
                                *args, Q, refs=refs)
        row = {"case": name,
               "chunked/loop": {n: c / p for n, (_, p, c) in emul.items()},
               "emul/loop": {n: e / p for n, (e, p, _) in emul.items()}}
        if device != "cpu":
            got = ss.ssd_scan_bwd(*args, chunk=chunk)
            row["kernel/loop"] = {
                n: e / p for n, (e, p, _) in t.ssd_bwd_errors(
                    got, *args, Q, refs=refs).items()}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
