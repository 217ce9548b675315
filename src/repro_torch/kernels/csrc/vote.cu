// Fused masked redundancy vote for Hopper (sm_90a): the B-MoE
// consensus step (paper Step 3) in one launch.
//
// Replaces: src/repro/kernels/redundancy_vote.py::pairwise_agreement, the
// Pallas TPU kernel that tiles T through VMEM and accumulates the (M, M)
// agreement counts, together with the jnp epilogue the JAX round loop
// runs after it (src/repro/kernels/ref.py::redundancy_vote_masked_ref:
// masked support, first-max winner, flags, winner gather).
//
// Contract: pub (E, M, T) float, active (M,) int32, atol -> trusted
// (E, T) float, support (E,) int32, flags (E, M) int32, equal exactly to
// redundancy_vote_masked_ref.  Copies i and j agree on an element when
// fabsf(pub[i] - pub[j]) <= atol, so a NaN (or an inf minus itself) makes
// a copy disagree even with itself, as in the reference.
//
// What bounds it on the H100: bytes.  Each element of pub is read once
// and compared with the M-1 other copies in registers; on the B-MoE path
// (E=10, M=10, T=376*10) that is 1.5 MB in and 0.15 MB out for ~0.4
// MFLOP, far below the ridge.  At this size the launch itself dominates,
// which is why the epilogue is fused instead of being a second launch.
//
// Design (right and simple first):
// - one block per expert, 256 threads striding over T (coalesced: the
//   threads of a warp read consecutive t of one copy);
// - the epilogue only asks whether two copies agree on EVERY element
//   (counts == T), so instead of M*M counters the block keeps one
//   disagreement bit per pair: bit i % 32 of word i / 32 of copy j
//   (i <= j) is set once copies i and j differ anywhere, ceil(M/32) words
//   per copy in shared memory.  The pairs are walked in 32 x 32 tiles
//   (copies 32wi.. against 32wj.., wi <= wj); inside a tile a thread keeps
//   one word per copy j in 32 registers, a warp OR-reduces them and one
//   atomicOr per warp merges into shared memory.  M <= 32 is the single
//   tile, one word per copy.  The result is exact: no count, no order of
//   summation;
// - thread 0 runs the masked epilogue (support, score = support*a-(1-a),
//   first max as jnp.argmax, flags) and the whole block copies the
//   winning copy into trusted[e], bit for bit;
// - the tail of T needs no padding: threads stride and stop at T.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;            // copies per tile: one 32-bit word
constexpr int kThreads = 256;

// OR into dis[j] bit i the disagreements, over this thread's elements, of
// copy i0 + i against copy j0 + j.  kDiag: the tile on the diagonal (i0 ==
// j0), where only i <= j is walked and one set of copies is loaded.
template <bool kDiag>
__device__ __forceinline__ void tile_bits(uint32_t (&dis)[kTile],
                                          const float* __restrict__ p,
                                          float atol, int M, int T, int i0,
                                          int j0) {
  for (int t = threadIdx.x; t < T; t += kThreads) {
    float vi[kTile], vj[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i)
      vi[i] = i0 + i < M ? p[(size_t)(i0 + i) * T + t] : 0.f;
    if constexpr (!kDiag) {
#pragma unroll
      for (int j = 0; j < kTile; ++j)
        vj[j] = j0 + j < M ? p[(size_t)(j0 + j) * T + t] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j0 + j >= M) break;
#pragma unroll
      for (int i = 0; i < (kDiag ? j + 1 : kTile); ++i) {
        const bool agree = fabsf(vi[i] - (kDiag ? vi[j] : vj[j])) <= atol;
        dis[j] |= (agree ? 0u : 1u) << i;
      }
    }
  }
}

// kW: disagreement words per copy, fixed at 1 for M <= 32 (one tile, the
// diagonal one), 0 where it is known at run time only
template <int kW>
__global__ void __launch_bounds__(kThreads)
vote_kernel(const float* __restrict__ pub, const int* __restrict__ active,
            float atol, int M, int T, float* __restrict__ trusted,
            int* __restrict__ support, int* __restrict__ flags) {
  extern __shared__ uint32_t dis_s[];   // [M][W] disagreement words
  __shared__ int winner_s;

  const int e = blockIdx.x;
  const int W = kW ? kW : (M + kTile - 1) / kTile;
  const float* p = pub + (size_t)e * M * T;
  for (int k = threadIdx.x; k < M * W; k += kThreads) dis_s[k] = 0u;
  __syncthreads();

  const int lane = threadIdx.x % 32;
  for (int wj = 0; wj < W; ++wj) {
    for (int wi = 0; wi <= wj; ++wi) {
      const int i0 = kTile * wi, j0 = kTile * wj;
      uint32_t dis[kTile];
#pragma unroll
      for (int j = 0; j < kTile; ++j) dis[j] = 0u;
      if (kW == 1 || wi == wj)
        tile_bits<true>(dis, p, atol, M, T, i0, j0);
      else
        tile_bits<false>(dis, p, atol, M, T, i0, j0);
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (j0 + j >= M) break;
        const uint32_t any = __reduce_or_sync(0xffffffffu, dis[j]);
        if (lane == 0 && any) atomicOr(&dis_s[(j0 + j) * W + wi], any);
      }
    }
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // full agreement of (i, j) <=> no disagreement bit; the bits are
    // stored for i <= j only (|a-b| is symmetric)
    auto agree = [&](int i, int j) -> int {
      if (i > j) {
        const int k = i;
        i = j;
        j = k;
      }
      return !((dis_s[j * W + i / kTile] >> (i % kTile)) & 1u);
    };
    int best = 0, best_score = 0, best_support = 0;
    for (int i = 0; i < M; ++i) {
      int s = 0;
      for (int j = 0; j < M; ++j) s += agree(i, j) * active[j];
      const int a = active[i];
      const int score = s * a - (1 - a);
      if (i == 0 || score > best_score) {   // first max wins ties
        best = i;
        best_score = score;
        best_support = s;
      }
    }
    support[e] = best_support;
    for (int j = 0; j < M; ++j)
      flags[(size_t)e * M + j] = agree(best, j) * active[j];
    winner_s = best;
  }
  __syncthreads();

  const float* src = p + (size_t)winner_s * T;
  for (int t = threadIdx.x; t < T; t += kThreads)
    trusted[(size_t)e * T + t] = src[t];
}

}  // namespace

// Words of the disagreement matrix that fit a block's shared memory (the
// 227 KB a block may opt in to): M * ceil(M / 32) of them, M <= 1351.
constexpr int kMaxWords = 232448 / 4;

// Plain C entry point (bound with ctypes).  Returns the
// cudaGetLastError() code of the launch (or of raising the dynamic
// shared-memory limit, or cudaErrorInvalidValue for an M whose
// disagreement matrix does not fit shared memory); the wrapper raises on
// non-zero.
extern "C" int redundancy_vote_masked_f32(const void* pub, const void* active,
                                          float atol, int E, int M, int T,
                                          void* trusted, void* support,
                                          void* flags, void* stream) {
  const long long words = (long long)M * ((M + kTile - 1) / kTile);
  if (M < 1 || words > kMaxWords - 4) return (int)cudaErrorInvalidValue;
  const size_t smem = words * sizeof(uint32_t);
  auto kern = M <= kTile ? vote_kernel<1> : vote_kernel<0>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<E, kThreads, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(pub), static_cast<const int*>(active), atol,
      M, T, static_cast<float*>(trusted), static_cast<int*>(support),
      static_cast<int*>(flags));
  return (int)cudaGetLastError();
}
