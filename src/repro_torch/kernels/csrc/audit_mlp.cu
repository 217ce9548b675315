// Fused, grouped, gathered two-layer MLP for Hopper (sm_90a) on the tensor
// cores:
//   out[s] = relu(x[s] @ w1[g] + b1[g]) @ w2[g] + b2[g],  g = gid[s].
//
// Replaces: src/repro/kernels/audit_gemm.py::audit_mlp, the Pallas TPU
// kernel the optimistic framework's executor and auditors share (the
// commitment build, the batched and merged audit drains).  Same contract:
// x (S, C, d) float, gid (S,) int32 and a stacked bank w1 (E, d, h),
// b1 (E, h), w2 (E, h, o), b2 (E, o) -> out (S, C, o) float.  As in the
// Pallas body, the hidden activations stay on chip: a slice of them lives
// in shared memory between the two layers and never touches device memory.
//
// What bounds it on the H100: at the commitment build (S=40 leaves of
// C=94 rows, 784 -> 256 -> 10) the work is 2*S*C*(d*h + h*o) = 1.53 GFLOP
// over ~12 MB of operands.  Both layers' fp32-accurate products go through
// the tensor cores as 3xTF32 (tf32x3.cuh): an effective 495/3 = 165
// TFLOP/s, so the call is bound by operations, 0.0093 ms (0.023 ms at the
// 67 TFLOP/s of the CUDA cores).  One TF32 product would miss the 1e-5 bar
// against the JAX package; 3xTF32 drops only lo*lo and meets it.
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
// - one tile configuration for every call (32-row tiles, 256-unit hidden
//   slices, 32-deep K slices, 32 outputs a block); a block is one
//   (32-row tile, sample, 32-output group), and a sample's weights are
//   found through gid only, so its slot in the call and the bank it sits
//   in (a row of a stacked bank holds the same bytes) do not matter;
// - an mma tile mixes rows only in which lanes hold them: each output
//   element is its own row of A times its own column of B;
// - one fixed K order per output element: every product is accumulated
//   over a 32-deep K slice (four m16n8k8 steps of three TF32 products:
//   a_lo b_hi, a_hi b_lo, a_hi b_hi) in a zeroed register tile, and the
//   slices are added to the running sum with one fp32 add each, in order
//   from K = 0.  Layer 1 then adds the bias and applies ReLU; layer 2 runs
//   over the hidden slices in order, then adds its bias;
// - no split-K, no atomics, no library call;
// - ragged C, d, h and o are masked in the kernel (out-of-range loads
//   read 0, out-of-range outputs are not stored), so nothing is padded in
//   memory and a row's chain is the same whatever C the call has.
//
// Design:
// - 16 warps.  Layer 1 (per hidden slice of 256 units): each warp holds a
//   16 x 32 register tile (one m16 by four n8 mma tiles); x and w1 K
//   slices are staged through a four-stage cp.async ring, rows copied 16
//   bytes at a time where their byte stride allows.  At the commit shape 3
//   row tiles x 40 samples = 120 blocks: one wave on 132 SMs, each block
//   streaming its expert's w1 once (803 KB, from L2 after the first
//   reader).  Measured on the H100 against 8 warps of 32 x 32 and three
//   stages: 3-9% faster at the commit, merged and h = 3072 shapes;
// - the slice's hidden activations (bias, ReLU) go to shared memory, and
//   the slice's w2 rows (staged with the first K slice) are multiplied in
//   by eight of the warps, one m16 x n8 output tile each (o = 10 uses
//   four);
// - the layer-2 sums stay in registers across hidden slices, so any
//   hidden width runs with the same 223 KB of shared memory; outputs past
//   32 are further blocks (grid z), each recomputing layer 1;
// - fragments are read from fp32 shared memory and split in registers;
//   row padding (+4 floats for A tiles, +8 for B tiles) puts a warp's
//   fragment loads in 32 distinct banks.
#include "tf32x3.cuh"

namespace {

using tc::mma_3xtf32;
using tc::split;

constexpr int kBM = 32;                  // rows per block
constexpr int kBN = 256;                 // hidden units per slice
constexpr int kBK = 32;                  // K slice (staged, accumulated)
constexpr int kBO = 32;                  // outputs per block
constexpr int kStages = 4;
constexpr int kWM = 16, kWN = 32;        // a warp's layer-1 tile
constexpr int kWarps = (kBM / kWM) * (kBN / kWN);
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = kWM / 16, kNT = kWN / 8;
constexpr int kL2Tiles = (kBM / 16) * (kBO / 8);   // layer-2 m16 x n8 tiles
constexpr int kLA = kBK + 4;             // x tile row stride (floats)
constexpr int kLB = kBN + 8;             // w1 tile
constexpr int kLH = kBN + 4;             // hidden tile
constexpr int kLW = kBO + 8;             // w2 tile
constexpr int kSA = kBM * kLA, kSB = kBK * kLB;
constexpr int kSmemBytes =
    (kStages * (kSA + kSB) + kBM * kLH + kBN * kLW) * (int)sizeof(float);
static_assert(kL2Tiles <= kWarps, "one layer-2 tile per warp");
static_assert(kSmemBytes <= 232448, "fits an SM's shared memory");

__global__ void __launch_bounds__(kThreads, 1)
audit_mlp_kernel(const float* __restrict__ x, const int* __restrict__ gid,
                 const float* __restrict__ w1, const float* __restrict__ b1,
                 const float* __restrict__ w2, const float* __restrict__ b2,
                 float* __restrict__ out, int C, int D, int H, int O, int E,
                 int vec_x, int vec_w1, int vec_w2) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                      // [stage][row][k]
  float* Bs = As + kStages * kSA;        // [stage][k][hidden]
  float* Hs = Bs + kStages * kSB;        // [row][hidden]
  float* Ws = Hs + kBM * kLH;            // [hidden][output]

  const int s = blockIdx.y;
  const int m0 = blockIdx.x * kBM;
  const int o0 = blockIdx.z * kBO;
  const int rows = min(kBM, C - m0);
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  float* op = out + ((size_t)s * C + m0) * O;

  const int e = gid[s];
  if (e < 0 || e >= E) {            // the wrapper checks; never read
    const int cols = min(kBO, O - o0);   // outside the bank
    for (int i = tid; i < rows * cols; i += kThreads)
      op[(size_t)(i / cols) * O + o0 + i % cols] = __int_as_float(0x7fc00000);
    return;
  }
  const float* xs = x + ((size_t)s * C + m0) * D;
  const float* w1g = w1 + (size_t)e * D * H;
  const float* b1g = b1 + (size_t)e * H;
  const float* w2g = w2 + (size_t)e * H * O;
  const float* b2g = b2 + (size_t)e * O;
  const int nk = (D + kBK - 1) / kBK;
  const int wm0 = (warp % (kBM / kWM)) * kWM;
  const int wn0 = (warp / (kBM / kWM)) * kWN;
  // this warp's layer-2 tile: rows 16 mt2 .., outputs o0 + 8 nt2 ..
  const int mt2 = warp % (kBM / 16), nt2 = warp / (kBM / 16);
  const bool has_l2 = warp < kL2Tiles && o0 + 8 * nt2 < O;
  float acc2[4] = {0.f, 0.f, 0.f, 0.f};

  for (int n0 = 0; n0 < H; n0 += kBN) {
    auto stage = [&](int kt) {
      const int st = kt % kStages, k0 = kt * kBK;
      tc::stage_tile(As + st * kSA, kLA, xs + k0, D, kBM, kBK, rows, D - k0,
                     vec_x != 0, tid, kThreads);
      tc::stage_tile(Bs + st * kSB, kLB, w1g + (size_t)k0 * H + n0, H, kBK,
                     kBN, D - k0, H - n0, vec_w1 != 0, tid, kThreads);
    };
    // the slice's w2 rows ride with the first K slice's copy group
    tc::stage_tile(Ws, kLW, w2g + (size_t)n0 * O + o0, O, kBN, kBO, H - n0,
                   O - o0, vec_w2 != 0, tid, kThreads);
#pragma unroll
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < nk) stage(st);
      tc::cp_async_commit();
    }

    // ---- layer 1: this slice's hidden units, x @ w1 over K in order
    float acc[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      tc::cp_async_wait<kStages - 2>();
      __syncthreads();  // slice kt landed; slice kt-1's slot is free
      if (kt + kStages - 1 < nk) stage(kt + kStages - 1);
      tc::cp_async_commit();

      const float* A = As + (kt % kStages) * kSA;
      const float* Bt = Bs + (kt % kStages) * kSB;
      float t[kMT][kNT][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) t[i][j][r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kBK; kk += 8) {
        uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int i = 0; i < kMT; ++i) {
          const float* a = A + (wm0 + 16 * i + g) * kLA + kk + q;
          split(a[0], ah[i][0], al[i][0]);
          split(a[8 * kLA], ah[i][1], al[i][1]);
          split(a[4], ah[i][2], al[i][2]);
          split(a[8 * kLA + 4], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const float* b = Bt + (kk + q) * kLB + wn0 + 8 * j + g;
          split(b[0], bh[j][0], bl[j][0]);
          split(b[4 * kLB], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int i = 0; i < kMT; ++i)
#pragma unroll
          for (int j = 0; j < kNT; ++j)
            mma_3xtf32(t[i][j], ah[i], al[i], bh[j], bl[j]);
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[i][j][r] += t[i][j][r];
    }
    tc::cp_async_wait<0>();

    // bias and ReLU into shared memory; units past h are 0
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = wm0 + 16 * i + g + 8 * (r / 2);
          const int col = wn0 + 8 * j + 2 * q + r % 2;
          const int n = n0 + col;
          float v = 0.f;
          if (n < H) {
            v = acc[i][j][r] + b1g[n];
            v = v < 0.f ? 0.f : v;                 // ReLU; NaN passes
          }
          Hs[row * kLH + col] = v;
        }
    __syncthreads();  // the hidden slice and the w2 rows are in place

    // ---- layer 2: this slice's contribution, in K order
    if (has_l2) {
      const float* A = Hs + (16 * mt2 + g) * kLH + q;
      const float* Bw = Ws + q * kLW + 8 * nt2 + g;
      for (int k0 = 0; k0 < kBN && n0 + k0 < H; k0 += kBK) {
        float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = k0; kk < k0 + kBK; kk += 8) {
          uint32_t ah[4], al[4], bh[2], bl[2];
          split(A[kk], ah[0], al[0]);
          split(A[8 * kLH + kk], ah[1], al[1]);
          split(A[kk + 4], ah[2], al[2]);
          split(A[8 * kLH + kk + 4], ah[3], al[3]);
          split(Bw[kk * kLW], bh[0], bl[0]);
          split(Bw[(kk + 4) * kLW], bh[1], bl[1]);
          mma_3xtf32(t, ah, al, bh, bl);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) acc2[r] += t[r];
      }
    }
    __syncthreads();  // Hs, Ws and the ring are free for the next slice
  }

  if (has_l2) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 16 * mt2 + g + 8 * (r / 2);
      const int n = o0 + 8 * nt2 + 2 * q + r % 2;
      if (row < rows && n < O) op[(size_t)row * O + n] = acc2[r] + b2g[n];
    }
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
  const cudaError_t err = cudaFuncSetAttribute(
      audit_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const auto al16 = [](const void* p) { return (uintptr_t)p % 16 == 0; };
  const int vec_x = D % 4 == 0 && al16(x);
  const int vec_w1 = H % 4 == 0 && al16(w1);
  const int vec_w2 = O % 4 == 0 && al16(w2);
  const dim3 grid((C + kBM - 1) / kBM, S, (O + kBO - 1) / kBO);
  audit_mlp_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<const int*>(gid),
      static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2),
      static_cast<float*>(out), C, D, H, O, E, vec_x, vec_w1, vec_w2);
  return (int)cudaGetLastError();
}
