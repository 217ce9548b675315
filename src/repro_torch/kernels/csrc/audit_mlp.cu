// Fused, grouped, gathered two-layer MLP for Hopper (sm_90a):
//   out[s] = relu(x[s] @ w1[g] + b1[g]) @ w2[g] + b2[g],  g = gid[s].
//
// Replaces: src/repro/kernels/audit_gemm.py::audit_mlp, the Pallas TPU
// kernel the optimistic framework's executor and auditors share (the
// commitment build, the batched and merged audit drains).  Same contract:
// x (S, C, d) float, gid (S,) int32 and a stacked bank w1 (E, d, h),
// b1 (E, h), w2 (E, h, o), b2 (E, o) -> out (S, C, o) float.  As in the
// Pallas body, the hidden activations stay on chip: they live in shared
// memory between the two layers and never touch device memory.
//
// What bounds it on the H100: at the commitment build (S=40 leaves of
// C=94 rows, 784 -> 256 -> 10) the work is 2*S*C*(d*h + h*o) = 1.53 GFLOP
// over ~12 MB of operands, ~125 FLOP per byte, far above the fp32
// CUDA-core ridge (67 TFLOP/s over 3.35 TB/s ~ 20 FLOP/byte): bound by
// operations, 0.023 ms at the fp32 peak.  No tensor cores (TF32 would miss
// the 1e-5 bar against the JAX package).
//
// The hard requirement is bitwise invariance, not speed: an honest leaf
// must hash the same whether the executor computed it in the commit call
// (S=40), an auditor in a per-round drain (S a multiple of 4), a merged
// drain (S a power of two, over a bank of (window+1)*N stacked experts),
// or the eager S=1 recompute that confirms fraud proofs and re-audits
// verifiers.  On the card that eager recompute goes through this kernel
// too, never through cuBLAS: cuBLAS picks its algorithm by shape, and a
// last-bit difference would slash honest verifiers under re-audit.  So a
// row's bytes depend on nothing but its own inputs:
// - one block per (sample, 16-row tile); a sample's weights are found
//   through gid only, so its slot in the call and the bank it sits in
//   (a row of a stacked bank holds the same bytes) do not matter;
// - each hidden unit is one sequential fp32 FMA chain over d, in order,
//   starting from 0; then the bias, then ReLU, in shared memory;
// - each output is one sequential FMA chain over h, then the bias;
// - no split-K, no atomics, no TF32, no library call;
// - ragged C, d, h and o are masked in the kernel (out-of-range loads read
//   0, out-of-range outputs are not stored), so nothing is padded in
//   memory and a row's chain is the same whatever C the call has.
// The tiling follows moe_gemm.cu: a 16-deep slice of x and w1 staged in
// shared memory per step, each thread a 4 x 4 register micro-tile.
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 16;        // rows (sample chunk rows) per block
constexpr int kBN = 256;       // hidden units per layer-1 pass
constexpr int kBK = 16;        // contraction slice staged per step
constexpr int kThreads = 256;  // 64 x 4 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
audit_mlp_kernel(const float* __restrict__ x, const int* __restrict__ gid,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 float* __restrict__ out, int C, int D, int H, int O,
                 int E) {
  __shared__ float a_s[kBK][kBM];   // a_s[k][m] = x[s, m0+m, k0+k]
  __shared__ float b_s[kBK][kBN];   // b_s[k][n] = w1[g, k0+k, n0+n]
  extern __shared__ float h_s[];    // h_s[m * (H+1) + n]: hidden units

  const int s = blockIdx.y;
  const int m0 = blockIdx.x * kBM;
  const int rows = min(kBM, C - m0);
  const int tid = threadIdx.x;
  const int hs = H + 1;             // padded stride: no bank conflicts
  float* o = out + ((size_t)s * C + m0) * O;

  const int g = gid[s];
  if (g < 0 || g >= E) {            // the wrapper checks; never read
    for (int i = tid; i < rows * O; i += kThreads)    // outside the bank
      o[i] = __int_as_float(0x7fc00000);
    return;
  }
  const float* xs = x + ((size_t)s * C + m0) * D;
  const float* w1g = w1 + (size_t)g * D * H;
  const float* b1g = b1 + (size_t)g * H;
  const float* w2g = w2 + (size_t)g * H * O;
  const float* b2g = b2 + (size_t)g * O;

  const int tx = tid % 64;          // hidden units tx + 64 j
  const int ty = tid / 64;          // rows ty + 4 i

  // ---- layer 1: h = relu(x @ w1 + b1), kept in shared memory
  for (int n0 = 0; n0 < H; n0 += kBN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += kBK) {
      {  // x slice: 16 rows x 16 cols, one element per thread
        const int r = tid / kBK, c = tid % kBK;
        a_s[c][r] = (r < rows && k0 + c < D)
                        ? xs[(size_t)r * D + k0 + c] : 0.f;
      }
      // w1 slice: 16 rows x 256 cols; consecutive threads walk along h
#pragma unroll
      for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
        const int r = idx / kBN, c = idx % kBN;
        const int gk = k0 + r, gn = n0 + c;
        b_s[r][c] = (gk < D && gn < H) ? w1g[(size_t)gk * H + gn] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kBK; ++k) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) av[i] = a_s[k][ty + 4 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = b_s[k][tx + 64 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 4 * i;
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + tx + 64 * j;
        if (n < H) {
          const float v = acc[i][j] + b1g[n];
          h_s[r * hs + n] = v < 0.f ? 0.f : v;   // ReLU; NaN passes
        }
      }
    }
  }
  __syncthreads();

  // ---- layer 2: out = h @ w2 + b2, one thread per (row, output)
  for (int idx = tid; idx < rows * O; idx += kThreads) {
    const int r = idx / O, c = idx % O;
    const float* hr = h_s + r * hs;
    float a = 0.f;
    for (int k = 0; k < H; ++k) a = fmaf(hr[k], w2g[(size_t)k * O + c], a);
    o[(size_t)r * O + c] = a + b2g[c];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns the cudaGetLastError()
// code of the launch (or of raising the dynamic shared-memory limit); the
// wrapper raises on non-zero.
extern "C" int audit_mlp_f32(const void* x, const void* gid, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             void* out, int S, int C, int D, int H, int O,
                             int E, void* stream) {
  const size_t smem = (size_t)kBM * (H + 1) * sizeof(float);
  const size_t static_smem = sizeof(float) * kBK * (kBM + kBN);
  if (smem + static_smem > 48 * 1024) {     // above the default limit
    const cudaError_t err = cudaFuncSetAttribute(
        audit_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((C + kBM - 1) / kBM, S);
  audit_mlp_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(gid),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), C, D, H, O, E);
  return (int)cudaGetLastError();
}
