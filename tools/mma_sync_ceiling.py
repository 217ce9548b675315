"""This card's ceiling for the products the port's kernels run.

Builds, with ``nvcc``, a kernel that runs only m16n8k8 TF32 ``mma.sync``
from registers (8 independent accumulators a warp, two 256-thread blocks
an SM, as the SSD backward's launches run), once as one product per
output and once as 3xTF32 (three dependent products, ``tf32x3.cuh``'s
``mma_3xtf32``), and prints the rate each reaches: products a second and
TF32 TFLOP/s.  Needs an H100 and the CUDA toolkit:

    python3 tools/mma_sync_ceiling.py
"""
import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(HERE, "src"))
CSRC = os.path.join(HERE, "src", "repro_torch", "kernels", "csrc")

SOURCE = r"""
#include "tf32x3.cuh"
template <int THREE>
__global__ void __launch_bounds__(256, 2) k(float* out, int iters, float v) {
  uint32_t a[4], b[2], al[4], bl[2];
  for (int i = 0; i < 4; ++i) tc::split(v * (threadIdx.x + i), a[i], al[i]);
  for (int i = 0; i < 2; ++i)
    tc::split(v * (threadIdx.x + 7 * i), b[i], bl[i]);
  float d[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (THREE) tc::mma_3xtf32(d[j], a, al, b, bl);
      else tc::mma_tf32(d[j], a, b);
    }
    a[0] ^= it & 1;
    b[1] ^= it & 2;
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int r = 0; r < 4; ++r) s += d[j][r];
  out[blockIdx.x * 256 + threadIdx.x] = s;
}
extern "C" float run(int three, int iters, int blocks) {
  float* out;
  cudaMalloc(&out, blocks * 256 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = 0.f;
  for (int rep = 0; rep < 2; ++rep) {     // the first is a warm-up
    cudaEventRecord(e0);
    if (three) k<1><<<blocks, 256>>>(out, iters, 1.1f);
    else k<0><<<blocks, 256>>>(out, iters, 1.1f);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaFree(out);
  return ms;
}
"""


def main():
    import torch
    from repro_torch.kernels.build import _nvcc
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        src, lib = os.path.join(tmp, "mma.cu"), os.path.join(tmp, "mma.so")
        with open(src, "w") as f:
            f.write(SOURCE)
        subprocess.run([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", CSRC,
                        "-o", lib, src], check=True)
        fn = ctypes.CDLL(lib).run
        fn.restype = ctypes.c_float
        iters = 2000
        for blocks in (2 * sms, 4 * sms):
            for three, per in ((0, 1), (1, 3)):
                ms = fn(three, iters, blocks)
                n = blocks * 8 * iters * 8 * per       # products run
                print({"device": torch.cuda.get_device_name(0),
                       "blocks": blocks, "3xtf32": bool(three), "ms": ms,
                       "mma_per_s": n / (ms * 1e-3),
                       "tf32_tflops": n * 2048 / (ms * 1e-3) / 1e12},
                      flush=True)


if __name__ == "__main__":
    main()
