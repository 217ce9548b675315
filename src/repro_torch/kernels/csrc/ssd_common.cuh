// Pieces shared by the SSD scan's forward (ssd_scan.cu) and backward
// (ssd_scan_bwd.cu): the register tiles' limits, a chunk's dt staged, its
// cumulative decay, and the launch.
#pragma once

#include "tf32x3.cuh"

namespace {

constexpr int kThreads = 256;     // 8 warps in every launch
constexpr int kMaxQ = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

// The chunk's dt (strided) into dts[kMaxQ], zero past Q.
__device__ __forceinline__ void stage_dt(float* dts, const float* dtc,
                                         long long dt_ss, int Q, int tid) {
  for (int j = tid; j < kMaxQ; j += kThreads)
    tc::cp_async4(dts + j, j < Q ? dtc + j * dt_ss : dtc, j < Q ? 4 : 0);
}

// cums = inclusive cumsum of dt * A over the chunk, by one warp (4 steps a
// lane), summed in double and rounded once; entries past Q repeat
// cum_Q-1.  Where cumd is given it gets the double sums, from which an
// exponent cum_i - cum_j is taken before it is rounded: float partial sums
// of a warp scan round neighbours apart, and at |cum| in the hundreds
// (strong decay) that ulp of |cum| in every difference took the kernels'
// gradients to twice the chunked form's float32 error (on the H100).
__device__ __forceinline__ void chunk_cumsum(const float* dts, float* cums,
                                             float Ah, int Q, int lane,
                                             double* cumd = nullptr) {
  double v[4];
  double run = 0.0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int j = lane * 4 + u;
    run += (j < Q) ? (double)dts[j] * (double)Ah : 0.0;
    v[u] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const double off = incl - run;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const double c = off + v[u];
    cums[lane * 4 + u] = (float)c;
    if (cumd != nullptr) cumd[lane * 4 + u] = c;
  }
}

// exp(a - b) of two double cumsums, the difference rounded once
__device__ __forceinline__ float exp_diff(double a, double b) {
  return expf((float)(a - b));
}

// One launch of kThreads-thread blocks with `smem` bytes of dynamic shared
// memory (the limit raised first); the first CUDA error code, or 0.
template <typename K, typename Prm>
int launch(K kern, dim3 grid, size_t smem, cudaStream_t stream,
           const Prm& p) {
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

inline bool aligned16(const void* ptr) { return (uintptr_t)ptr % 16 == 0; }

}  // namespace
