// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// along the sequence, from h = 0, every channel independent.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan_pallas, the Pallas
// TPU kernel (channels on the lanes, time sequential in a fori_loop, the
// carried state in VMEM scratch across sequence chunks), whose jnp oracle
// is the associative scan in src/repro/models/rglru.py::rglru_scan.  Same
// contract: a, b (B, S, C) float32 -> h (B, S, C) float32.
//
// What bounds it on the H100: it reads a and b once and writes h once,
// 12*B*S*C bytes, with two flops per element: bound by bytes.  At
// recurrentgemma-2b's prefill (B=1, S=4096, C=2560) that is 126 MB, 0.038
// ms at 3.35 TB/s.
//
// Design (right and simple first): one thread per (b, c) channel walks S in
// order.  Neighbouring threads take neighbouring channels, so every load
// and store of a warp is one coalesced 128-byte row segment.  The loads of
// the next kUnroll steps are issued before their products, so a thread has
// that many loads in flight instead of one.  Each step rounds the product
// and then the sum (__fmul_rn / __fadd_rn keep the compiler from fusing
// them into an FMA), so the result equals the plain PyTorch loop
// (kernels/ref.py::rglru_scan_ref) bit for bit.  At (1, 4096, 2560) there
// are only 2,560 chains, 20 blocks of 128 threads on 132 SMs, each a
// sequence of 4,096 dependent steps: the kernel sits far above its byte
// bound.  A chunked two-pass scan (per-chunk products and offsets, then a
// fix-up pass) is a perf PR's work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  float* __restrict__ h, int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= C) return;
  const size_t base = (size_t)bi * S * C + c;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float state = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = ap[(size_t)(t + u) * C];
      bv[u] = bp[(size_t)(t + u) * C];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      state = __fadd_rn(__fmul_rn(av[u], state), bv[u]);
      hp[(size_t)(t + u) * C] = state;
    }
  }
  for (; t < S; ++t) {
    state = __fadd_rn(__fmul_rn(ap[(size_t)t * C], state), bp[(size_t)t * C]);
    hp[(size_t)t * C] = state;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the cudaGetLastError()
// code of the launch; the wrapper raises on non-zero.
extern "C" int rglru_scan_f32(const void* a, const void* b, void* h, int B,
                              int S, int C, void* stream) {
  const dim3 grid((C + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, C);
  return (int)cudaGetLastError();
}
