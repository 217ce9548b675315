// Attention backward for Hopper (sm_90a): dq, dk and dv of the online-
// softmax forward in flash_attention.cu, on the tensor cores (3xTF32).
//
// Replaces: the gradient the JAX package takes by differentiating
// src/repro/models/layers.py::blockwise_attention (its jnp online softmax
// under jax.checkpoint), the training path's twin of the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention.  Same contract as
// the forward: causal and sliding-window masks on absolute positions
// (query row i at q_offset + i), GQA (query head h reads kv head h / G, so
// dk and dv sum the G heads of a group), the tanh logit softcap (one
// derivative factor 1 - tanh^2), Sq != Sk, ragged tails; float32 only,
// D in {32, 48, 64, 128, 256}.
//
// Given the forward's o and its log-sum-exp lse (B, H, Sq), with s the
// scaled (and soft-capped) scores:
//   P = exp(s - lse) on the mask, 0 off it,
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - Delta),  Delta = rowsum(dO o),
//   dS *= (1 - tanh^2) with a softcap, times the scale,
//   dQ = dS K,  dK = dS^T Q.
// A row with no valid key (a window past the keys' end) took every key at
// weight 1/Sk in the forward: it gives dv that weight and, its scores
// being constants, q and k no gradient (kernels/ref.py::attention_bwd_ref).
//
// What bounds it on the H100: five products of the forward's size (S and dP
// recomputed, dV, dK, dQ), 10*B*H*D flops per unmasked (q, k) pair, against
// q, k, v, o, dO and the three gradients read or written once: bound by
// operations (at qwen2.5-3b's layer, 172 GFLOP against 109 MB).
//
// Design (FlashAttention-2's backward, kept simple): three launches.
// 1. flash_bwd_delta_kernel: Delta = rowsum(dO o), one warp a row.
// 2. flash_bwd_dkdv_kernel: one block of 4 warps per (64-key tile, b, kv
//    head, 64-column slice of dk/dv); each warp owns 16 keys and keeps its
//    dK and dV slices in registers while it walks the group's G query
//    heads and their 32-row query tiles in the mask's range, in order:
//    S^T = K Q^T and dP^T = V dO^T over the whole head dim, P and dS in
//    registers, then dV += P^T dO and dK += dS^T Q on the slice.  K and V
//    stay in shared memory; Q and dO tiles are staged by cp.async.  At
//    D > 64 the column slices recompute S and dP (D / 64 times): the price
//    of keeping the accumulators in registers without spilling.
// 3. flash_bwd_dq_kernel: one block per (b, query head, 64-row query tile,
//    128-column slice of dq), the forward's shape: key tiles in the mask's
//    range, S and dP again, dQ += dS K in registers (at D = 256 the two
//    slices recompute S and dP).
// Each tile's products are accumulated in a zeroed register tile and then
// added to the running sum with one fp32 add, as moe_gemm.cu does: the
// tensor cores' own accumulation truncates, and run over the thousands of
// queries or keys of a long sequence it drifts (at a qwen2.5-3b layer dk
// came out 16 times further from float64 than the plain version's); over
// one tile it does not.  S and dP take the same care per 8-column step.
// Products are m16n8k8 TF32 mma.sync in 3xTF32 (tf32x3.cuh); P passes from
// the accumulator layout to the A operand with no shuffle, as in the
// forward (the A fragment's columns t and t+4 are keys 2t and 2t+1, and the
// B rows are read in that order).  Shared-memory rows are padded by 4
// floats, so every fragment load of a warp hits 32 banks.
// Determinism: every output element is owned by one thread of one block,
// which sums its terms in a fixed order; no atomics, so two launches on the
// same inputs give the same bits.
#include "tf32x3.cuh"

namespace {

using tc::mma_3xtf32;
using tc::split;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 4;              // floats of row padding
constexpr int kKeys = 16 * kWarps;   // dk/dv kernel: keys per block
constexpr int kQT = 32;              // dk/dv kernel: query rows per step
constexpr int kRows = 16 * kWarps;   // dq kernel: query rows per block
constexpr int kSlice = 64;           // dk/dv columns per block
constexpr int kQSlice = 128;         // dq columns per block

struct Params {
  const float* q;     // (B, Sq, H, D), contiguous
  const float* k;     // (B, Sk, KH, D)
  const float* v;
  const float* o;     // (B, Sq, H, D)
  const float* dout;  // (B, Sq, H, D)
  const float* lse;   // (B, H, Sq)
  float* delta;       // (B, H, Sq) scratch
  float* dq;
  float* dk;
  float* dv;
  int B, Sq, Sk, H, KH;
  int causal, window, q_offset;
  int vec;
  float scale, softcap;
};

template <int D>
__host__ __device__ constexpr int key_tile() {   // dq kernel's key tiles
  return D == 256 ? 16 : D == 128 ? 32 : 64;
}
template <int D>
__host__ __device__ constexpr int slice() {      // dk/dv columns a block
  return D < kSlice ? D : kSlice;
}
template <int D>
__host__ __device__ constexpr int qslice() {     // dq columns a block
  return D < kQSlice ? D : kQSlice;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[j][r] = 0.f;
}

// acc += t, one rounded fp32 add an element
template <int N>
__device__ __forceinline__ void add(float (&acc)[N][4],
                                    const float (&t)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], t[j][r]);
}

// does the query at absolute position qpos have a valid key at all?
__device__ __forceinline__ bool has_key(int qpos, const Params& p) {
  const int lo = p.window ? max(qpos - p.window + 1, 0) : 0;
  const int hi = p.causal ? min(qpos, p.Sk - 1) : p.Sk - 1;
  return lo <= hi;
}

__device__ __forceinline__ bool keep(int qpos, int kpos, const Params& p) {
  return (!p.causal || kpos <= qpos) &&
         (!p.window || kpos > qpos - p.window);
}

// acc (16 x N) += X (16 rows) . Y^T (Y: N rows), over D columns, rows
// D + kPad apart: a0 (g, t) a1 (g+8, t) a2 (g, t+4) a3 (g+8, t+4) from X,
// b0 (t, n g) b1 (t+4, n g) from Y's row 8j+g.  Each 8-column step goes
// to a zeroed fragment, added to acc with one rounded fp32 add: S and dP
// feed exp(), and at D = 256 a peaked softmax turned S's truncated
// tensor-core sum into dq errors 10 times the plain version's (the card
// tests' windowed cases)
template <int D, int N>
__device__ __forceinline__ void rows_dot(float (&acc)[N / 8][4],
                                         const float* X, const float* Y,
                                         int g, int t) {
  constexpr int L = D + kPad;
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 8) {
    uint32_t ah[4], al[4];
    split(X[g * L + kk + t], ah[0], al[0]);
    split(X[(g + 8) * L + kk + t], ah[1], al[1]);
    split(X[g * L + kk + t + 4], ah[2], al[2]);
    split(X[(g + 8) * L + kk + t + 4], ah[3], al[3]);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t bh[2], bl[2];
      split(Y[(8 * j + g) * L + kk + t], bh[0], bl[0]);
      split(Y[(8 * j + g) * L + kk + t + 4], bh[1], bl[1]);
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_3xtf32(part, ah, al, bh, bl);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], part[r]);
    }
  }
}

// acc (16 x N) += P (16 x K, accumulator layout in registers) . Y (K rows,
// LY apart, N columns from Y): the A fragment's column t is key 2t and t+4
// key 2t+1 of each 8-key step, so Y's rows are read in that order
template <int N, int K, int LY>
__device__ __forceinline__ void p_dot(float (&acc)[N / 8][4],
                                      const float (&pm)[K / 8][4],
                                      const float* Y, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    uint32_t ah[4], al[4];
    split(pm[kk][0], ah[0], al[0]);    // (row g,   key 2t)
    split(pm[kk][2], ah[1], al[1]);    // (row g+8, key 2t)
    split(pm[kk][1], ah[2], al[2]);    // (row g,   key 2t+1)
    split(pm[kk][3], ah[3], al[3]);    // (row g+8, key 2t+1)
    const float* y = Y + (8 * kk + 2 * t) * LY + g;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      uint32_t bh[2], bl[2];
      split(y[8 * j], bh[0], bl[0]);
      split(y[LY + 8 * j], bh[1], bl[1]);
      mma_3xtf32(acc[j], ah, al, bh, bl);
    }
  }
}

// The score's softmax weight and the gradient of the raw product q . k for
// one (query, key) pair, from S's accumulator s and dP's dp.
__device__ __forceinline__ void weight_and_grad(float s, float dp, int qpos,
                                                int kpos, float lse,
                                                float delta, bool dead,
                                                const Params& p, float& P,
                                                float& dS) {
  if (dead) {                       // no valid key: uniform, constant
    P = 1.f / (float)p.Sk;
    dS = 0.f;
    return;
  }
  if (!keep(qpos, kpos, p)) {
    P = 0.f;
    dS = 0.f;
    return;
  }
  const float raw = s * p.scale;
  float sc = raw, th = 0.f;
  if (p.softcap > 0.f) {
    th = tanhf(raw / p.softcap);
    sc = p.softcap * th;
  }
  P = expf(sc - lse);
  float d = P * (dp - delta);
  if (p.softcap > 0.f) d *= 1.f - th * th;
  dS = d * p.scale;
}

// ------------------------------------------------------------ Delta
__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(Params p, int D) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.Sq * p.H) return;
  const float* o = p.o + row * D;
  const float* d = p.dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += o[c] * d[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {                  // row = (b * Sq + i) * H + h
    const int h = row % p.H;
    const long long bi = row / p.H;
    const int i = bi % p.Sq, b = bi / p.Sq;
    p.delta[((long long)b * p.H + h) * p.Sq + i] = acc;
  }
}

// ------------------------------------------------------------ dK, dV
template <int D>
__host__ __device__ constexpr int dkdv_smem() {
  return ((2 * kKeys + 2 * kQT) * (D + kPad) + 2 * kQT) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(Params p) {
  constexpr int L = D + kPad;
  constexpr int DC = slice<D>();
  constexpr int NQ = kQT / 8;          // S^T n-tiles (8 queries each)
  constexpr int NC = DC / 8;           // dK, dV n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [kKeys][L]
  float* Vs = Ks + kKeys * L;                       // [kKeys][L]
  float* Qs = Vs + kKeys * L;                       // [kQT][L]
  float* Ds = Qs + kQT * L;                         // dO [kQT][L]
  float* lse_s = Ds + kQT * L;                      // [kQT]
  float* del_s = lse_s + kQT;                       // [kQT]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kKeys;
  const int b = blockIdx.y / p.KH, kh = blockIdx.y % p.KH;
  const int c0 = blockIdx.z * DC;
  const int G = p.H / p.KH;
  const bool vec = p.vec != 0;
  const long long kstride = (long long)p.KH * D;
  const long long qstride = (long long)p.H * D;
  const float* kg = p.k + ((long long)b * p.Sk + k0) * kstride + kh * D;
  const float* vg = p.v + ((long long)b * p.Sk + k0) * kstride + kh * D;
  tc::stage_tile(Ks, L, kg, kstride, kKeys, D, p.Sk - k0, D, vec, tid,
                 kThreads);
  tc::stage_tile(Vs, L, vg, kstride, kKeys, D, p.Sk - k0, D, vec, tid,
                 kThreads);
  tc::cp_async_commit();

  // query rows this key tile can touch: the mask's range, and the rows
  // with no valid key at all (a suffix, only under a window)
  const int klast = min(k0 + kKeys, p.Sk) - 1;
  const int i_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int i_hi = p.window ? min(p.Sq, klast + p.window - p.q_offset)
                            : p.Sq;
  const int i_dead = p.window ? max(0, p.Sk + p.window - 1 - p.q_offset)
                              : p.Sq;

  float dk[NC][4], dv[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) dk[j][r] = dv[j][r] = 0.f;

  const int nqt = (p.Sq + kQT - 1) / kQT;
  for (int hg = 0; hg < G; ++hg) {
    const int h = kh * G + hg;
    for (int qt = 0; qt < nqt; ++qt) {
      const int i0 = qt * kQT;
      const bool in_mask = i0 < i_hi && i0 + kQT > i_lo;
      const bool has_dead = i0 + kQT > i_dead;
      if (!in_mask && !has_dead) continue;          // uniform in the block
      __syncthreads();                // the last tile's Q, dO consumed
      const long long qoff = ((long long)b * p.Sq + i0) * qstride + h * D;
      tc::stage_tile(Qs, L, p.q + qoff, qstride, kQT, D, p.Sq - i0, D, vec,
                     tid, kThreads);
      tc::stage_tile(Ds, L, p.dout + qoff, qstride, kQT, D, p.Sq - i0, D,
                     vec, tid, kThreads);
      tc::cp_async_commit();
      if (tid < kQT) {
        const int i = i0 + tid;
        const long long r = ((long long)b * p.H + h) * p.Sq + i;
        lse_s[tid] = i < p.Sq ? p.lse[r] : 0.f;
        del_s[tid] = i < p.Sq ? p.delta[r] : 0.f;
      }
      tc::cp_async_wait<0>();
      __syncthreads();

      float s[NQ][4], dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) s[j][r] = dp[j][r] = 0.f;
      rows_dot<D, kQT>(s, Ks + 16 * warp * L, Qs, g, t);    // S^T
      rows_dot<D, kQT>(dp, Vs + 16 * warp * L, Ds, g, t);   // dP^T

#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int kpos = k0 + 16 * warp + g + 8 * (r >> 1);
          const int qc = 8 * j + 2 * t + (r & 1);
          const int i = i0 + qc, qpos = p.q_offset + i;
          float P = 0.f, dS = 0.f;
          if (kpos < p.Sk && i < p.Sq)
            weight_and_grad(s[j][r], dp[j][r], qpos, kpos, lse_s[qc],
                            del_s[qc], !has_key(qpos, p), p, P, dS);
          s[j][r] = P;
          dp[j][r] = dS;
        }
      float part[NC][4];
      zero(part);
      p_dot<DC, kQT, L>(part, s, Ds + c0, g, t);    // dV += P^T dO
      add(dv, part);
      zero(part);
      p_dot<DC, kQT, L>(part, dp, Qs + c0, g, t);   // dK += dS^T Q
      add(dk, part);
    }
  }
  tc::cp_async_wait<0>();             // K and V staged even with no tile

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int kpos = k0 + 16 * warp + g + 8 * hr;
    if (kpos >= p.Sk) continue;
    const long long off = ((long long)b * p.Sk + kpos) * kstride + kh * D +
                          c0 + 2 * t;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      p.dk[off + 8 * j] = dk[j][2 * hr];
      p.dk[off + 8 * j + 1] = dk[j][2 * hr + 1];
      p.dv[off + 8 * j] = dv[j][2 * hr];
      p.dv[off + 8 * j + 1] = dv[j][2 * hr + 1];
    }
  }
}

// ------------------------------------------------------------ dQ
template <int D>
__host__ __device__ constexpr int dq_smem() {
  return (2 * kRows + 2 * key_tile<D>()) * (D + kPad) * 4;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Params p) {
  constexpr int L = D + kPad;
  constexpr int BK = key_tile<D>();
  constexpr int NS = BK / 8;
  constexpr int DQ = qslice<D>();
  constexpr int NO = DQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // [kRows][L]
  float* Ds = Qs + kRows * L;                       // dO [kRows][L]
  float* Ks = Ds + kRows * L;                       // [BK][L]
  float* Vs = Ks + BK * L;                          // [BK][L]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;   // last tiles first
  const int kh = h / (p.H / p.KH);
  const int c0 = blockIdx.z * DQ;
  const bool vec = p.vec != 0;
  const long long kstride = (long long)p.KH * D;
  const long long qstride = (long long)p.H * D;
  const long long qoff = ((long long)b * p.Sq + q0) * qstride + h * D;
  tc::stage_tile(Qs, L, p.q + qoff, qstride, kRows, D, p.Sq - q0, D, vec,
                 tid, kThreads);
  tc::stage_tile(Ds, L, p.dout + qoff, qstride, kRows, D, p.Sq - q0, D, vec,
                 tid, kThreads);
  tc::cp_async_commit();

  // this thread's two rows: their lse, Delta and whether any key is valid
  float lse[2], del[2];
  bool dead[2];
  const int row0 = q0 + 16 * warp + g;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = row0 + 8 * hr;
    const long long r = ((long long)b * p.H + h) * p.Sq + i;
    lse[hr] = i < p.Sq ? p.lse[r] : 0.f;
    del[hr] = i < p.Sq ? p.delta[r] : 0.f;
    dead[hr] = !has_key(p.q_offset + i, p);
  }

  // key tiles with a valid key for some row of the tile (a row with none
  // has no dq)
  const int nk = (p.Sk + BK - 1) / BK;
  const int qlo = p.q_offset + q0;
  const int qhi = p.q_offset + min(q0 + kRows, p.Sq) - 1;
  const int kt_lo = p.window ? min(nk, max(0, qlo - p.window + 1) / BK) : 0;
  const int kt_hi = p.causal ? min(nk, qhi / BK + 1) : nk;

  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) dq[j][r] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                  // the last key tile consumed
    const long long koff = ((long long)b * p.Sk + k0) * kstride + kh * D;
    tc::stage_tile(Ks, L, p.k + koff, kstride, BK, D, p.Sk - k0, D, vec, tid,
                   kThreads);
    tc::stage_tile(Vs, L, p.v + koff, kstride, BK, D, p.Sk - k0, D, vec, tid,
                   kThreads);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = dp[j][r] = 0.f;
    rows_dot<D, BK>(s, Qs + 16 * warp * L, Ks, g, t);    // S
    rows_dot<D, BK>(dp, Ds + 16 * warp * L, Vs, g, t);   // dP
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int hr = r >> 1;
        const int i = row0 + 8 * hr;
        const int kpos = k0 + 8 * j + 2 * t + (r & 1);
        float P = 0.f, dS = 0.f;
        if (kpos < p.Sk && i < p.Sq)
          weight_and_grad(s[j][r], dp[j][r], p.q_offset + i, kpos, lse[hr],
                          del[hr], dead[hr], p, P, dS);
        dp[j][r] = dS;
      }
    float part[NO][4];
    zero(part);
    p_dot<DQ, BK, L>(part, dp, Ks + c0, g, t);         // dQ += dS K
    add(dq, part);
  }
  tc::cp_async_wait<0>();             // Q and dO staged even with no tile

#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int i = row0 + 8 * hr;
    if (i >= p.Sq) continue;
    float* out = p.dq + ((long long)b * p.Sq + i) * qstride + h * D + c0 +
                 2 * t;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      out[8 * j] = dq[j][2 * hr];
      out[8 * j + 1] = dq[j][2 * hr + 1];
    }
  }
}

template <int D>
int launch(const Params& p, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)p.B * p.Sq * p.H;
  flash_bwd_delta_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps),
                           kThreads, 0, st>>>(p, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int s1 = dkdv_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s1);
  if (err != cudaSuccess) return (int)err;
  const dim3 g1((p.Sk + kKeys - 1) / kKeys, p.B * p.KH, D / slice<D>());
  flash_bwd_dkdv_kernel<D><<<g1, kThreads, s1, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int s2 = dq_smem<D>();
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s2);
  if (err != cudaSuccess) return (int)err;
  const dim3 g2(p.B * p.H, (p.Sq + kRows - 1) / kRows, D / qslice<D>());
  flash_bwd_dq_kernel<D><<<g2, kThreads, s2, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Every operand float32 and
// contiguous in the model layout: q, o, dout, dq (B, Sq, H, D); k, v, dk,
// dv (B, Sk, KH, D); lse and the delta scratch (B, H, Sq).  Three launches
// on the stream; returns the first non-zero cudaError (of a launch or of
// raising the dynamic shared-memory limit), else 0.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   int B, int Sq, int Sk, int H, int KH,
                                   int D, int causal, int window,
                                   int q_offset, float scale, float softcap,
                                   void* stream) {
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<const float*>(o);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KH = KH;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = scale;
  p.softcap = softcap;
  // 16-byte copies need 16-byte-aligned rows: the bases, and D a multiple
  // of 4 (every supported D is)
  p.vec = (uintptr_t)q % 16 == 0 && (uintptr_t)k % 16 == 0 &&
          (uintptr_t)v % 16 == 0 && (uintptr_t)dout % 16 == 0;
  switch (D) {
    case 32: return launch<32>(p, stream);
    case 48: return launch<48>(p, stream);
    case 64: return launch<64>(p, stream);
    case 128: return launch<128>(p, stream);
    case 256: return launch<256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
