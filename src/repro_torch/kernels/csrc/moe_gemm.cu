// Grouped expert GEMM for Hopper (sm_90a) on the tensor cores:
// out[e] = buf[e] @ w[e].
//
// Replaces: src/repro/kernels/moe_gemm.py::moe_gemm, the Pallas TPU kernel
// (MXU-aligned 128x128 tiles, f32 VMEM accumulator, inputs zero-padded to
// the tile).  Same contract: buf (E, C, d) x w (E, d, f) -> (E, C, f),
// accumulated in float, written in the input dtype (float or bf16).
//
// What bounds it on the H100: on the B-MoE path (E=10 experts, C=376
// capacity slots) layer 1, d=784 -> f=256, is 2*E*C*d*f = 1.51 GFLOP over
// 24 MB of operands.  Its fp32-accurate products go through the tensor
// cores as 3xTF32 (tf32x3.cuh), three TF32 products per fp32 product: an
// effective 495/3 = 165 TFLOP/s, so layer 1 is bound by operations (9.1 us).
// Layer 2, d=256 -> f=10, is 19 MFLOP over 4.1 MB: bound by bytes (1.2 us).
// One TF32 product would miss the JAX bar (1e-5 / 8e-5 in fp32) by three
// orders of magnitude; 3xTF32 drops only lo*lo and meets it.  bf16 inputs
// take one bf16 mma per product, no split.
//
// Design:
// - one block per (f-tile, C-tile, expert), two tile shapes chosen by f:
//   wide (f > 16): 64 x 64 outputs, 4 warps of 32 x 32, K step 64, 3
//   stages (107.5 KB of shared memory, two blocks an SM).  Layer 1 has
//   ceil(376/64) * 256/64 * 10 = 240 blocks, all resident at once on 132
//   SMs (108 SMs hold two, 24 one): one wave, and two independent blocks
//   an SM keep the tensor cores busy across each other's barriers.
//   Measured on the H100 against 128 x 64 tiles (120 blocks, one an SM, 8
//   warps; K step 32 or 64) and 64 x 64 at K step 32: 0.039 ms against
//   0.041-0.046 for layer 1;
//   narrow (f <= 16, layer 2): 32 x 16 outputs, 2 warps of 16 x 16, K step
//   128, 3 stages.  ceil(376/32) * 10 = 120 blocks; the two stages the
//   prologue issues hold all of d = 256, so each block reads its 32 KB of
//   h in one round trip.  No mma work is spent on the 240 columns a
//   256-wide tile would waste;
// - K slices are staged through a cp.async ring, so the copies of later
//   slices overlap the products of this one; rows whose byte stride is a
//   multiple of 16 are copied 16 bytes at a time, other shapes (f = 10,
//   odd d) element by element;
// - fragments are read from fp32 (or bf16) shared memory and split in
//   registers; rows are padded (+4 floats, +8 bf16) so that a warp's
//   fragment loads hit 32 distinct banks;
// - ragged edges (C=376, f=10, d=784 = 12.25 K steps) are masked in the
//   kernel: out-of-range loads are zero-filled by cp.async, out-of-range
//   outputs are not stored.  Nothing is padded in device memory;
// - each K slice is accumulated in a zeroed register tile and then added to
//   the running sum with one fp32 add, so the tensor cores' own
//   accumulation never runs over more than one slice;
// - determinism: each output has one fixed reduction order (the K slices
//   in order, the mma steps in order inside a slice), with no split-K and
//   no atomics, so a launch on the same inputs gives the same bits, and a
//   row's bits do not depend on the other rows of the call.
#include "tf32x3.cuh"

namespace {

using tc::mma_3xtf32;
using tc::mma_bf16;
using tc::split;

template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int WARPS = (BM / WM) * (BN / WN);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int MT = WM / 16, NT = WN / 8;  // mma tiles per warp
};
using Wide = Tile<64, 64, 64, 32, 32, 3>;
using Narrow = Tile<32, 16, 128, 16, 16, 3>;

// Row padding of the staged tiles, in elements: 16 bytes for A (rows stay
// 16-byte aligned for cp.async), 8 elements for B.  With these a warp's
// fragment loads fall in 32 distinct banks at every tile shape above.
template <typename T>
struct Pad {
  static constexpr int A = 16 / sizeof(T);
  static constexpr int B = 8;
};

template <typename T, typename Cfg>
__host__ __device__ constexpr int smem_bytes() {
  return Cfg::STAGES *
         (Cfg::BM * (Cfg::BK + Pad<T>::A) + Cfg::BK * (Cfg::BN + Pad<T>::B)) *
         (int)sizeof(T);
}

__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// One staged K slice into the warp's (MT x NT) register tile.
template <typename Cfg>
__device__ __forceinline__ void slice_mma(float (&t)[Cfg::MT][Cfg::NT][4],
                                          const float* As, const float* Bs,
                                          int wm0, int wn0, int g, int q) {
  constexpr int LA = Cfg::BK + Pad<float>::A, LB = Cfg::BN + Pad<float>::B;
#pragma unroll
  for (int kk = 0; kk < Cfg::BK; kk += 8) {
    uint32_t ah[Cfg::MT][4], al[Cfg::MT][4], bh[Cfg::NT][2], bl[Cfg::NT][2];
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i) {
      const float* a = As + (wm0 + 16 * i + g) * LA + kk + q;
      split(a[0], ah[i][0], al[i][0]);
      split(a[8 * LA], ah[i][1], al[i][1]);
      split(a[4], ah[i][2], al[i][2]);
      split(a[8 * LA + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < Cfg::NT; ++j) {
      const float* b = Bs + (kk + q) * LB + wn0 + 8 * j + g;
      split(b[0], bh[j][0], bl[j][0]);
      split(b[4 * LB], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j)
        mma_3xtf32(t[i][j], ah[i], al[i], bh[j], bl[j]);
  }
}

template <typename Cfg>
__device__ __forceinline__ void slice_mma(float (&t)[Cfg::MT][Cfg::NT][4],
                                          const __nv_bfloat16* As,
                                          const __nv_bfloat16* Bs, int wm0,
                                          int wn0, int g, int q) {
  constexpr int LA = Cfg::BK + Pad<__nv_bfloat16>::A;
  constexpr int LB = Cfg::BN + Pad<__nv_bfloat16>::B;
#pragma unroll 1  // rolled: holds the registers of the packed B loads down
  for (int kk = 0; kk < Cfg::BK; kk += 16) {
    uint32_t a[Cfg::MT][4], b[Cfg::NT][2];
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i) {
      const __nv_bfloat16* p = As + (wm0 + 16 * i + g) * LA + kk + 2 * q;
      a[i][0] = tc::ld_u32(p);
      a[i][1] = tc::ld_u32(p + 8 * LA);
      a[i][2] = tc::ld_u32(p + 8);
      a[i][3] = tc::ld_u32(p + 8 * LA + 8);
    }
#pragma unroll
    for (int j = 0; j < Cfg::NT; ++j) {
      const __nv_bfloat16* p = Bs + (kk + 2 * q) * LB + wn0 + 8 * j + g;
      b[j][0] = tc::pack_bf16(p[0], p[LB]);
      b[j][1] = tc::pack_bf16(p[8 * LB], p[9 * LB]);
    }
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j) mma_bf16(t[i][j], a[i], b[j]);
  }
}

template <typename T, typename Cfg>
__global__ void __launch_bounds__(Cfg::THREADS, 1)
moe_gemm_kernel(const T* __restrict__ buf, const T* __restrict__ w,
                T* __restrict__ out, int C, int D, int F, int vec_a,
                int vec_b) {
  constexpr int BM = Cfg::BM, BN = Cfg::BN, BK = Cfg::BK;
  constexpr int LA = BK + Pad<T>::A, LB = BN + Pad<T>::B;
  constexpr int SA = BM * LA, SB = BK * LB;  // elements per stage
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);
  T* Bs = As + Cfg::STAGES * SA;

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const T* a = buf + (size_t)e * C * D + (size_t)m0 * D;
  const T* b = w + (size_t)e * D * F + n0;
  T* o = out + (size_t)e * C * F;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int wm0 = (warp / (BN / Cfg::WN)) * Cfg::WM;
  const int wn0 = (warp % (BN / Cfg::WN)) * Cfg::WN;
  const int nk = (D + BK - 1) / BK;

  auto stage = [&](int kt) {
    const int s = kt % Cfg::STAGES, k0 = kt * BK;
    tc::stage_tile(As + s * SA, LA, a + k0, D, BM, BK, C - m0, D - k0,
                   vec_a != 0, tid, Cfg::THREADS);
    tc::stage_tile(Bs + s * SB, LB, b + (size_t)k0 * F, F, BK, BN, D - k0,
                   F - n0, vec_b != 0, tid, Cfg::THREADS);
  };

  float acc[Cfg::MT][Cfg::NT][4];
#pragma unroll
  for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
    for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

#pragma unroll
  for (int s = 0; s < Cfg::STAGES - 1; ++s) {
    if (s < nk) stage(s);
    tc::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    tc::cp_async_wait<Cfg::STAGES - 2>();
    __syncthreads();  // slice kt landed; slice kt-1's slot is free
    if (kt + Cfg::STAGES - 1 < nk) stage(kt + Cfg::STAGES - 1);
    tc::cp_async_commit();

    const int s = kt % Cfg::STAGES;
    float t[Cfg::MT][Cfg::NT][4];
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) t[i][j][r] = 0.f;
    slice_mma<Cfg>(t, As + s * SA, Bs + s * SB, wm0, wn0, g, q);
#pragma unroll
    for (int i = 0; i < Cfg::MT; ++i)
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] += t[i][j][r];
  }
  tc::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < Cfg::MT; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm0 + 16 * i + g + 8 * h;
      if (gm >= C) continue;
#pragma unroll
      for (int j = 0; j < Cfg::NT; ++j) {
        const int gn = n0 + wn0 + 8 * j + 2 * q;
        if (gn < F) store_f(o + (size_t)gm * F + gn, acc[i][j][2 * h]);
        if (gn + 1 < F)
          store_f(o + (size_t)gm * F + gn + 1, acc[i][j][2 * h + 1]);
      }
    }
  }
}

template <typename T, typename Cfg>
int launch_cfg(const void* buf, const void* w, void* out, int E, int C, int D,
               int F, void* stream) {
  constexpr int V = 16 / sizeof(T);
  const int vec_a = D % V == 0 && (uintptr_t)buf % 16 == 0;
  const int vec_b = F % V == 0 && (uintptr_t)w % 16 == 0;
  constexpr int smem = smem_bytes<T, Cfg>();
  auto kern = moe_gemm_kernel<T, Cfg>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((F + Cfg::BN - 1) / Cfg::BN, (C + Cfg::BM - 1) / Cfg::BM,
                  E);
  kern<<<grid, Cfg::THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(buf), static_cast<const T*>(w),
      static_cast<T*>(out), C, D, F, vec_a, vec_b);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* buf, const void* w, void* out, int E, int C, int D,
           int F, void* stream) {
  return F <= Narrow::BN
             ? launch_cfg<T, Narrow>(buf, w, out, E, C, D, F, stream)
             : launch_cfg<T, Wide>(buf, w, out, E, C, D, F, stream);
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
