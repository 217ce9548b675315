// Grouped expert GEMM for Hopper (sm_90a): out[e] = buf[e] @ w[e].
//
// Replaces: src/repro/kernels/moe_gemm.py::moe_gemm, the Pallas TPU kernel
// (MXU-aligned 128x128 tiles, f32 VMEM accumulator, inputs zero-padded to
// the tile).  Same contract: buf (E, C, d) x w (E, d, f) -> (E, C, f),
// accumulated in float, written in the input dtype (float or bf16).
//
// What bounds it on the H100: on the B-MoE path (E=10 experts, C=376
// capacity slots, d=784 -> f=256, then 256 -> 10) the first layer is
// 2*E*C*d*f = 1.5 GFLOP over 24 MB of operands, ~64 FLOP per byte, above
// the fp32 CUDA-core ridge (67 TFLOP/s over 3.35 TB/s ~ 20 FLOP/byte):
// bound by operations.  The second layer (19 MFLOP over 4 MB) is bound
// by bytes.  No tensor cores: the JAX reference's bar is 1e-5 in fp32,
// which TF32 would miss, so every product is an fp32 FMA on the CUDA
// cores.
//
// Design (right and simple first; wgmma + TMA come later):
// - one block per (f-tile, C-tile, expert): 64x64 outputs, 256 threads,
//   each thread owns a 4x4 register micro-tile (rows ty+16i, cols tx+16j,
//   so shared-memory reads are broadcasts or consecutive words and the
//   global stores of a warp are coalesced);
// - the d loop stages a 64x16 slice of buf and a 16x64 slice of w in
//   shared memory (converted to float once), then 16 rank-1 updates;
// - ragged edges (C=376, f=10, d=784 are no multiple of 64 or 16) are
//   masked in the kernel: out-of-range loads read 0, out-of-range
//   outputs are not stored.  Nothing is padded in device memory;
// - each output is one sequential fp32 FMA chain over d, so a result
//   does not depend on the grid, the tile or the run.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kBM = 64;       // rows (capacity slots) per block
constexpr int kBN = 64;       // output features per block
constexpr int kBK = 16;       // contraction slice staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_gemm_kernel(const T* __restrict__ buf, const T* __restrict__ w,
                T* __restrict__ out, int C, int D, int F) {
  __shared__ float a_s[kBK][kBM + 1];   // a_s[k][m] = buf[e, m0+m, k0+k]
  __shared__ float b_s[kBK][kBN];       // b_s[k][n] = w[e, k0+k, n0+n]

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const T* a = buf + (size_t)e * C * D;
  const T* b = w + (size_t)e * D * F;
  T* o = out + (size_t)e * C * F;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    // buf slice: 64 rows x 16 cols; consecutive threads walk along d
#pragma unroll
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx % kBK;
      const int gm = m0 + r, gk = k0 + c;
      a_s[c][r] = (gm < C && gk < D) ? load_f(a + (size_t)gm * D + gk) : 0.f;
    }
    // w slice: 16 rows x 64 cols; consecutive threads walk along f
#pragma unroll
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      const int gk = k0 + r, gn = n0 + c;
      b_s[r][c] = (gk < D && gn < F) ? load_f(b + (size_t)gk * F + gn) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = a_s[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= C) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < F) store_f(o + (size_t)gm * F + gn, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* buf, const void* w, void* out, int E, int C, int D,
           int F, void* stream) {
  const dim3 grid((F + kBN - 1) / kBN, (C + kBM - 1) / kBM, E);
  moe_gemm_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(w),
      static_cast<T*>(out), C, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns the
// cudaGetLastError() code of its launch; the wrapper raises on non-zero.
extern "C" int moe_gemm_f32(const void* buf, const void* w, void* out, int E,
                            int C, int D, int F, void* stream) {
  return launch<float>(buf, w, out, E, C, D, F, stream);
}

extern "C" int moe_gemm_bf16(const void* buf, const void* w, void* out, int E,
                             int C, int D, int F, void* stream) {
  return launch<__nv_bfloat16>(buf, w, out, E, C, D, F, stream);
}
