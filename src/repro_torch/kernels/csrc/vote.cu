// Fused masked redundancy vote for Hopper (sm_90a): the B-MoE
// consensus step (paper Step 3) in one launch of thread-block clusters.
//
// Replaces: src/repro/kernels/redundancy_vote.py::pairwise_agreement, the
// Pallas TPU kernel that tiles T through VMEM and accumulates the (M, M)
// agreement counts, together with the jnp epilogue the JAX round loop
// runs after it (src/repro/kernels/ref.py::redundancy_vote_masked_ref:
// masked support, first-max winner, flags, winner gather).
//
// Contract: pub (E, M, T) float, active (M,) int32, atol -> trusted
// (E, T) float, support (E,) int32, flags (E, M) int32 and winner (E,)
// int32 (the elected copy, which the vote's gradient is routed to), equal
// exactly to redundancy_vote_winner_ref.  Copies i and j agree on an
// element when fabsf(pub[i] - pub[j]) <= atol, so a NaN (or an inf minus
// itself) makes a copy disagree even with itself, as in the reference.
//
// What bounds it on the H100: bytes.  Each element of pub is read once
// and compared with the M-1 other copies in registers; on the B-MoE path
// (E=10, M=10, T=376*10) that is 1.5 MB in and 0.15 MB out for ~0.4
// MFLOP: 0.49 us at 3.35 TB/s, below what any launch costs.  So the
// design spreads the reads over enough SMs to take them at the card's
// rate and keeps everything else inside the one launch.
//
// Design:
// - one cluster of kCluster blocks per expert (grid kCluster * E, cluster
//   dimension set at launch): 80 blocks at (10,10,3760) instead of the 10
//   one block per expert gave;
// - the vote only asks whether two copies agree on EVERY element, so a
//   warp keeps one disagreement bit per pair: bit i % 32 of word i / 32
//   of copy j is set once copies i and j differ, ceil(M/32) words per
//   copy in shared memory (i <= j is what the epilogue reads; a bit for
//   i > j is the same fact and harmless);
// - the cluster's work is dealt to its warps (64 in 8 blocks) as (item,
//   group) pairs: a group is 32 consecutive elements of T, one a lane (a
//   warp's loads of a copy are coalesced); an item is a set of copy
//   pairs.  For M <= 32 there is one item, the triangle of the one 32 x
//   32 tile, so the warps take the groups in turn (at (10,10,3760): 118
//   groups, two a warp) and keep their words in registers across them.
//   For larger M an item is 32 copies i against 8 copies j, a quarter of
//   a tile pair, so at the court's (3,40,300) the 6 items x 10 groups
//   fall one a warp (measured on the H100 against a tile pair a block:
//   0.0103 against 0.0158 ms).  A warp OR-reduces its words over its
//   lanes and merges them with one shared-memory atomicOr a word;
// - the words meet over distributed shared memory (DSMEM).  For M <= 32
//   each block stores its M words into its own slot of every other
//   block, then one cluster.sync(); each block ORs its 8 slots locally,
//   and no block touches another's memory after the barrier (measured on
//   the H100 against pulling the words after the barrier: 0.0067 against
//   0.0076 ms).  For larger M one matrix a block is all that fits, so
//   each block ORs the others' words into its own after the barrier and
//   waits on a second, split barrier only before it exits;
// - the epilogue is parallel, in every block: one warp per candidate i
//   sums agree(i, j) * active[j] over its lanes, and the first-max winner
//   is a 64-bit shared atomicMax on (score, -i), which keeps jnp.argmax's
//   tie rule; block 0's warp 0 then writes the winner's flags, their sum
//   (its support) and the winner;
// - every block then copies its eighth of the winner's copy into
//   trusted, bit for bit (the copy is 1/M of pub and warm in L2);
// - OR, counts and the max do not depend on the order they are taken in,
//   so the result is exact and repeatable, NaN and +-inf included;
// - a cluster's blocks share a GPC; where the shared memory a block needs
//   leaves no room for kCluster of them there, the launch takes the
//   largest power-of-two cluster that fits (M past ~110 only).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTile = 32;            // copies per tile: one 32-bit word
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCluster = 8;          // blocks per expert (portable size)

// The copies a warp's lane holds: rows r0.. of pub at element t (zeros
// past M or T, which agree with each other and so set no bit).
template <int kN>
__device__ __forceinline__ void load_copies(float (&v)[kN],
                                            const float* __restrict__ p,
                                            int M, int T, int t, int r0) {
#pragma unroll
  for (int r = 0; r < kN; ++r)
    v[r] = r0 + r < M && t < T ? p[(size_t)(r0 + r) * T + t] : 0.f;
}

// OR into dis[j] bit i whether copies i and j disagree (|a - b| <= atol
// fails, NaN included): copies vi[i] against vj[j], the whole rectangle.
template <int kJ>
__device__ __forceinline__ void rect_bits(uint32_t (&dis)[kJ],
                                          const float (&vi)[kTile],
                                          const float (&vj)[kJ], float atol) {
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int i = 0; i < kTile; ++i)
      dis[j] |= (fabsf(vi[i] - vj[j]) <= atol ? 0u : 1u) << i;
}

// The cluster barrier in two halves (barrier.cluster), so that work can
// run between a block's arrival and its wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Elements of T a block of a cluster of cl takes: a multiple of 32.
__host__ __device__ __forceinline__ int slice_len(int T, int cl) {
  return ((T + cl - 1) / cl + 31) / 32 * 32;
}

// kW: disagreement words per copy, fixed at 1 for M <= 32 (one tile, the
// diagonal one), 0 where it is known at run time only
template <int kW>
__global__ void __launch_bounds__(kThreads)
vote_kernel(const float* __restrict__ pub, const int* __restrict__ active,
            float atol, int M, int T, float* __restrict__ trusted,
            int* __restrict__ support, int* __restrict__ flags,
            int* __restrict__ winner) {
  // [M][W] disagreement words; M <= 32: [cl][M], one slot a block
  extern __shared__ uint32_t dis_s[];
  __shared__ unsigned long long best_s;

  cg::cluster_group cluster = cg::this_cluster();
  const int cl = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int e = blockIdx.x / cl;
  const int W = kW ? kW : (M + kTile - 1) / kTile;
  const float* p = pub + (size_t)e * M * T;
  // M <= 32: one slot of M words a block of the cluster, its own first
  uint32_t* mine = kW == 1 ? dis_s + rank * M : dis_s;
  for (int k = threadIdx.x; k < M * W; k += kThreads) mine[k] = 0u;
  if (threadIdx.x == 0) best_s = 0ull;
  __syncthreads();

  // (item, group) pairs dealt to the cluster's warps (see the top)
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int groups = (T + 31) / 32;
  const int nw = cl * kWarps;
  if constexpr (kW == 1) {
    uint32_t dis[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) dis[j] = 0u;
    for (int g = rank * kWarps + warp; g < groups; g += nw) {
      float v[kTile];
      load_copies(v, p, M, T, g * 32 + lane, 0);
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        if (j >= M) break;
#pragma unroll
        for (int i = 0; i <= j; ++i)
          dis[j] |= (fabsf(v[i] - v[j]) <= atol ? 0u : 1u) << i;
      }
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j >= M) break;
      const uint32_t any = __reduce_or_sync(0xffffffffu, dis[j]);
      if (lane == 0 && any) atomicOr(&mine[j], any);
    }
  } else {
    // items: for each tile row wj, its (wj + 1) tile pairs times the
    // quarters of 8 copies j that hold a copy (4, and fewer in the last)
    const int qlast = (M - kTile * (W - 1) + 7) / 8;
    const int items = 4 * (W - 1) * W / 2 + W * qlast;
    for (int gw = rank * kWarps + warp; gw < items * groups; gw += nw) {
      int k = gw / groups, wj = 0, qv = W > 1 ? 4 : qlast;
      while (k >= (wj + 1) * qv) {
        k -= (wj + 1) * qv;
        ++wj;
        qv = wj < W - 1 ? 4 : qlast;
      }
      const int wi = k / qv, j0 = kTile * wj + 8 * (k % qv);
      const int t = (gw % groups) * 32 + lane;
      float vi[kTile], vj[8];
      load_copies(vi, p, M, T, t, kTile * wi);
      load_copies(vj, p, M, T, t, j0);
      uint32_t dis[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      rect_bits(dis, vi, vj, atol);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j0 + j >= M) break;
        const uint32_t any = __reduce_or_sync(0xffffffffu, dis[j]);
        if (lane == 0 && any) atomicOr(&mine[(j0 + j) * W + wi], any);
      }
    }
  }

  if constexpr (kW == 1) {
    // push this block's words into its slot of every other block, then
    // one barrier; after it no block touches another's memory
    __syncthreads();
    for (int k = threadIdx.x; k < M * (cl - 1); k += kThreads) {
      const int r = (rank + 1 + k / M) % cl, kk = k % M;
      *cluster.map_shared_rank(mine + kk, r) = mine[kk];
    }
    cluster.sync();
    for (int k = threadIdx.x; k < M; k += kThreads) {
      uint32_t w = 0u;
      for (int r = 0; r < cl; ++r) w |= dis_s[r * M + k];
      dis_s[k] = w;                   // slot 0 becomes the whole matrix
    }
    __syncthreads();
  } else {
    // one matrix a block (eight would not fit at M = 1351): after the
    // barrier each block ORs the others' words into its own, in place (a
    // block may read another's words before or after that one merged
    // them, and the OR of all of them is the same either way), and it
    // arrives once it has read them and waits only before it exits, so
    // that none exits while another still reads it
    cluster.sync();
    for (int k = threadIdx.x; k < M * W; k += kThreads) {
      uint32_t w = dis_s[k];
      for (int r = 1; r < cl; ++r)
        w |= *cluster.map_shared_rank(dis_s + k, (rank + r) % cl);
      dis_s[k] = w;
    }
    cluster_arrive();
    __syncthreads();
  }

  // full agreement of (i, j) <=> no disagreement bit; the bits are stored
  // for i <= j only (|a-b| is symmetric)
  auto agree = [&](int i, int j) -> int {
    if (i > j) {
      const int k = i;
      i = j;
      j = k;
    }
    return !((dis_s[j * W + i / kTile] >> (i % kTile)) & 1u);
  };
  for (int i = warp; i < M; i += kWarps) {
    int s = 0;
    for (int j = lane; j < M; j += 32) s += agree(i, j) * active[j];
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0) {
      const int a = active[i];
      const int score = s * a - (1 - a);             // bar the excluded
      // the largest score, then the lowest index (jnp.argmax)
      atomicMax(&best_s,
                ((unsigned long long)((unsigned)score ^ 0x80000000u) << 32)
                    | (0xffffffffu - (unsigned)i));
    }
  }
  __syncthreads();
  const int best = (int)(0xffffffffu - (unsigned)(best_s & 0xffffffffull));
  if (rank == 0 && warp == 0) {
    int s = 0;
    for (int j = lane; j < M; j += 32) {
      const int f = agree(best, j) * active[j];
      flags[(size_t)e * M + j] = f;
      s += f;
    }
    s = __reduce_add_sync(0xffffffffu, s);
    if (lane == 0) {
      support[e] = s;
      winner[e] = best;
    }
  }

  // block r copies the r-th eighth of the winner's copy
  const float* src = p + (size_t)best * T;
  const int C = slice_len(T, cl), c0 = min(rank * C, T), c1 = min(c0 + C, T);
  for (int t = c0 + threadIdx.x; t < c1; t += kThreads)
    trusted[(size_t)e * T + t] = src[t];
  if constexpr (kW != 1) cluster_wait();
}

// The launch floor: no work, the vote's grid, cluster and shared memory.
__global__ void __launch_bounds__(kThreads) empty_cluster_kernel() {}

// Words of the disagreement matrix that fit a block's shared memory (the
// 227 KB a block may opt in to): M * ceil(M / 32) of them, M <= 1351.
constexpr int kMaxWords = 232448 / 4;

// Fill the launch configuration of ``kern`` for E experts of M copies:
// kCluster blocks an expert, or the largest power-of-two cluster whose
// blocks' shared memory one GPC holds.
cudaError_t configure(const void* kern, int E, int M, void* stream,
                      cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr) {
  const long long words = (long long)M * ((M + kTile - 1) / kTile);
  if (M < 1 || words > kMaxWords - 16) return cudaErrorInvalidValue;
  const size_t smem = (M <= kTile ? kCluster * words : words) * sizeof(uint32_t);
  cfg = cudaLaunchConfig_t{};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int cl = kCluster;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    for (; cl > 1; cl /= 2) {
      int n = 0;
      attr.val.clusterDim.x = cl;
      cfg.gridDim = dim3(cl, 1, 1);
      if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) == cudaSuccess &&
          n > 0)
        break;
    }
    cudaGetLastError();           // a refused query leaves no error behind
  }
  attr.val.clusterDim.x = cl;
  cfg.gridDim = dim3((unsigned)(cl * E), 1, 1);
  return cudaSuccess;
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each returns the
// cudaGetLastError() code of its launch (or of configuring it, or
// cudaErrorInvalidValue for an M whose disagreement matrix does not fit
// shared memory); the wrapper raises on non-zero.
extern "C" int redundancy_vote_masked_f32(const void* pub, const void* active,
                                          float atol, int E, int M, int T,
                                          void* trusted, void* support,
                                          void* flags, void* winner,
                                          void* stream) {
  auto kern = M <= kTile ? vote_kernel<1> : vote_kernel<0>;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure((const void*)kern, E, M, stream, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(pub),
                           static_cast<const int*>(active), atol, M, T,
                           static_cast<float*>(trusted),
                           static_cast<int*>(support),
                           static_cast<int*>(flags),
                           static_cast<int*>(winner));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

extern "C" int vote_launch_floor(int E, int M, void* stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure((const void*)empty_cluster_kernel, E, M,
                              stream, cfg, attr);
  if (err != cudaSuccess) return (int)err;
  err = cudaLaunchKernelEx(&cfg, empty_cluster_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
