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
//   (counts == T), so instead of M*M counters a thread keeps one
//   disagreement bit per pair: bit i of dis[j] (i <= j) is set once
//   copies i and j differ anywhere.  M <= 32 fits in 32 registers; a warp
//   OR-reduces them and one atomicOr per warp merges into shared memory.
//   The result is exact: no count, no order of summation;
// - thread 0 runs the masked epilogue (support, score = support*a-(1-a),
//   first max as jnp.argmax, flags) and the whole block copies the
//   winning copy into trusted[e], bit for bit;
// - the tail of T needs no padding: threads stride and stop at T.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 32;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vote_kernel(const float* __restrict__ pub, const int* __restrict__ active,
            float atol, int M, int T, float* __restrict__ trusted,
            int* __restrict__ support, int* __restrict__ flags) {
  __shared__ uint32_t dis_s[kMaxM];
  __shared__ int winner_s;

  const int e = blockIdx.x;
  const float* p = pub + (size_t)e * M * T;
  if (threadIdx.x < kMaxM) dis_s[threadIdx.x] = 0u;
  __syncthreads();

  uint32_t dis[kMaxM];
#pragma unroll
  for (int j = 0; j < kMaxM; ++j) dis[j] = 0u;

  for (int t = threadIdx.x; t < T; t += kThreads) {
    float v[kMaxM];
#pragma unroll
    for (int i = 0; i < kMaxM; ++i) v[i] = i < M ? p[(size_t)i * T + t] : 0.f;
#pragma unroll
    for (int j = 0; j < kMaxM; ++j) {
      if (j >= M) break;
#pragma unroll
      for (int i = 0; i <= j; ++i) {
        const bool agree = fabsf(v[i] - v[j]) <= atol;
        dis[j] |= (agree ? 0u : 1u) << i;
      }
    }
  }

  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < kMaxM; ++j) {
    if (j >= M) break;
    const uint32_t any = __reduce_or_sync(0xffffffffu, dis[j]);
    if (lane == 0 && any) atomicOr(&dis_s[j], any);
  }
  __syncthreads();

  if (threadIdx.x == 0) {
    // full agreement of (i, j) <=> no disagreement bit; the bits are
    // stored for i <= j only (|a-b| is symmetric)
    auto agree = [&](int i, int j) -> int {
      return i <= j ? !((dis_s[j] >> i) & 1u) : !((dis_s[i] >> j) & 1u);
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

// Plain C entry point (bound with ctypes).  Returns the
// cudaGetLastError() code of the launch; the wrapper raises on non-zero.
extern "C" int redundancy_vote_masked_f32(const void* pub, const void* active,
                                          float atol, int E, int M, int T,
                                          void* trusted, void* support,
                                          void* flags, void* stream) {
  if (M > kMaxM) return (int)cudaErrorInvalidValue;
  vote_kernel<<<E, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(pub), static_cast<const int*>(active), atol,
      M, T, static_cast<float*>(trusted), static_cast<int*>(support),
      static_cast<int*>(flags));
  return (int)cudaGetLastError();
}
