// Mamba-2 chunked SSD scan for Hopper (sm_90a), chunk-parallel on the
// tensor cores.
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan, the Pallas TPU kernel
// (grid (B, H, nchunks) with the chunk axis innermost and the carried
// (P, N) state in VMEM scratch), whose jnp form is repro/models/ssm.py::
// ssd_chunked.  Same contract: x (B, S, H, P), dt (B, S, H), A (H,), B and
// C (B, S, N) — one group shared by every head — float32, the state
// starting at zero, S a multiple of the chunk length Q; y (B, S, H, P)
// float32.
//
// Per (b, h) and per chunk c of Q steps, with cum = cumsum(dt * A):
//   L[i, j] = exp(cum_i - cum_j) for j <= i, else 0 (masked before the
//             exponential: above the diagonal the exponent is positive and
//             would overflow, and inf * 0 is NaN);
//   y_c     = ((C B^T) o L o dt_j) x + exp(cum) o (C s_c^T);
//   s_c+1   = exp(cum_Q) s_c + ((exp(cum_Q - cum) dt) o x)^T B,  s_0 = 0.
//
// What bounds it on the H100: the scores times x per head over the
// Q(Q+1)/2 causal pairs of a chunk (times P), C B^T once per (b, chunk)
// over the same pairs (times N), and Q*N*P each for C s^T (every chunk but
// the first, whose state is zero) and x^T B (every chunk but the last,
// whose state nothing reads).  At mamba2-2.7b's prefill (B=1, S=4096,
// H=80, P=64, N=128, Q=128) that is 13.2 GFLOP against 173 MB of
// operands.  All four products go through the tensor cores as 3xTF32
// (tf32x3.cuh), an effective 495/3 = 165 TFLOP/s: bound by operations,
// 0.080 ms (0.197 ms at the 67 TFLOP/s of the CUDA cores).
//
// Design: the chunks are split across blocks, as Mamba-2's own chunked
// algorithm does (arXiv:2405.21060 §6), in four launches in stream order:
//  1. ssd_cb: C B^T once per (b, chunk), not per head, into the CB scratch
//     (B, nc, Q, LQ) with zeros above the diagonal (2 MB at mamba2's
//     shape: it stays in L2 for launch 4);
//  2. ssd_chunk_state, one block per (b, chunk, h) but the last chunk: the
//     chunk's cumsum, w = exp(cum_Q - cum) dt, ds_c = (w o x)^T B (P x N,
//     K = Q) into the state scratch (B, nc-1, H, P, N), and exp(cum_Q);
//  3. ssd_state_pass, one thread per (b, h, p, n): s_c = exp(cum_Q) s_c-1 +
//     ds_c in place over the chunks, the fp32 fma recurrence of the
//     sequential kernel this replaces; bound by bytes;
//  4. ssd_chunk_out, one block per (b, chunk, h) (2,560 at mamba2's shape):
//     y = (exp(cum) o C) s^T + scores x as ONE accumulation over K = N + Q,
//     staged in 64-wide K slices through a 2-stage cp.async ring: the C / s
//     slices first, whose sum is then scaled by exp(cum) as the reference
//     scales C s^T, then the CB / x slices, each CB slice rewritten in
//     shared memory as it lands into the scores CB o L o dt_j (masked
//     first), so one mma loop serves both kinds.
//     Each warp owns two 16-row tiles, one from each end of the causal
//     triangle, so every warp does the same work; a tile skips the key
//     steps above its rows.
// Fragments are read from fp32 shared memory and split in registers (the
// tf32x3.cuh header says why mma.sync and not wgmma); the row strides of
// the staged tiles keep every fragment load of a warp on 32 distinct banks.
// Ragged Q, P and N are staged with zero fill and masked on store; nothing
// is read past S.  Launches 2 and 4 hold two blocks an SM (108 KB and
// 105 KB of shared memory) and walk the heads fastest, so the blocks
// resident together read whole rows of x and contiguous states, and share
// one chunk's C and C B^T in L2.
//
// Determinism: every output has one fixed reduction order (the K steps in
// order, inter-chunk slices before intra-chunk ones), with no split-K and
// no atomics; a row b reads only row b's inputs and scratch, so its bytes
// do not depend on the batch width or on the other rows.
#include "ssd_common.cuh"

namespace {

using tc::mma_tf32;
using tc::split;

constexpr int kSlice = 64;        // K slice of launch 4
constexpr int kStages = 2;
// Row strides (floats) of the staged tiles.  An operand whose fragment is
// read at (row g, column t) has a stride of 4 (mod 32), one read at (row t,
// column g) a stride of 8 (mod 32).
constexpr int kLdCB = kMaxN + 4;  // C and B rows in launch 1
constexpr int kLdX = kMaxP + 8;   // x rows, keys by P
constexpr int kLdB = kMaxN + 8;   // B rows in launch 2, keys by N
constexpr int kLdS = kSlice + 4;  // a K slice of C, CB or s rows
constexpr int kSliceA = kMaxQ * kLdS;     // A part of a ring stage
// B part: an s slice (P rows of kSlice) or an x slice (kSlice rows of P)
constexpr int kSliceB = kMaxP * kLdS > kSlice * kLdX ? kMaxP * kLdS
                                                     : kSlice * kLdX;
constexpr int kAhead = 8;         // state loads in flight in launch 3

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  float* y;
  float* cb;      // (B, nc, Q, LQ) C B^T, zero above the diagonal
  float* st;      // (B, nc-1, H, P, N) ds_c, then the state after chunk c
  float* decay;   // (B, nc, H) exp(cum_Q) of chunk c
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  int S, H, P, N, Q, nc, LQ;
  int vec_x, vec_b, vec_c, vec_s;   // 16-byte copies (aligned rows)
};

// d[i][j] += a[i] b[j] in 3xTF32 over the warp's MI x NJ tiles where
// on_i[i] and on_j[j], one of the three products at a time across all the
// tiles (lo * hi into a zeroed fragment, then hi * lo, then hi * hi), so no
// mma.sync waits on the one just before it; each tile's 8-deep step is then
// added to d in fp32.  The tensor core's fp32 accumulation truncates, so C
// B^T and the chunk states summed in place over K = 128 drifted from
// float64 by several times a float32 sum's error, which the backward
// (ssd_scan_bwd.cu), recomputing them, carried into dx and ddt.
template <int MI, int NJ>
__device__ __forceinline__ void mma_tiles(float (&d)[MI][NJ][4],
                                          const uint32_t (&ah)[MI][4],
                                          const uint32_t (&al)[MI][4],
                                          const uint32_t (&bh)[NJ][2],
                                          const uint32_t (&bl)[NJ][2],
                                          const bool (&on_i)[MI],
                                          const bool (&on_j)[NJ]) {
  float t[MI][NJ][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (on_i[i] && on_j[j]) tc::mma_tf32_z(t[i][j], al[i], bh[j]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (on_i[i] && on_j[j]) mma_tf32(t[i][j], ah[i], bl[j]);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      if (on_i[i] && on_j[j]) {
        mma_tf32(t[i][j], ah[i], bh[j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) d[i][j][r] += t[i][j][r];
      }
}

// ---------------------------------------------- 1. C B^T per (b, chunk)
// Warp w owns rows 16w..16w+15 and the 8-key tiles up to its diagonal.
__global__ void __launch_bounds__(kThreads, 1)
ssd_cb_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                     // [kMaxQ][kLdCB]
  float* Bs = Cs + kMaxQ * kLdCB;       // [kMaxQ][kLdCB]
  const int c = blockIdx.x, b = blockIdx.y;
  const int Q = p.Q, N = p.N, c0 = c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int MT = (Q + 15) / 16;
  tc::stage_tile(Cs, kLdCB, p.Cm + b * p.c_sb + (long long)c0 * p.c_ss,
                 p.c_ss, MT * 16, kMaxN, Q, N, p.vec_c != 0, tid,
                 kThreads);
  tc::stage_tile(Bs, kLdCB, p.Bm + b * p.b_sb + (long long)c0 * p.b_ss,
                 p.b_ss, MT * 16, kMaxN, Q, N, p.vec_b != 0, tid,
                 kThreads);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  if (warp >= MT) return;

  const int m0 = 16 * warp;
  const int jt_hi = min(2 * warp + 1, (Q + 7) / 8 - 1);
  float acc[kMaxQ / 32][1][4][4];   // key tile 4u + j in acc[u][0][j]
#pragma unroll
  for (int u = 0; u < kMaxQ / 32; ++u)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[u][0][j][r] = 0.f;
  const bool on_m[1] = {true};
  for (int kk = 0; kk < N; kk += 8) {
    uint32_t ah[1][4], al[1][4];
    const float* a = Cs + (m0 + g) * kLdCB + kk + q;
    split(a[0], ah[0][0], al[0][0]);
    split(a[8 * kLdCB], ah[0][1], al[0][1]);
    split(a[4], ah[0][2], al[0][2]);
    split(a[8 * kLdCB + 4], ah[0][3], al[0][3]);
#pragma unroll
    for (int u = 0; u < kMaxQ / 32; ++u) {      // four key tiles at a time
      if (4 * u > jt_hi) continue;
      uint32_t bh[4][2], bl[4][2];
      bool on[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        on[j] = 4 * u + j <= jt_hi;
        if (!on[j]) continue;
        const float* bp = Bs + (32 * u + 8 * j + g) * kLdCB + kk + q;
        split(bp[0], bh[j][0], bl[j][0]);
        split(bp[4], bh[j][1], bl[j][1]);
      }
      mma_tiles<1, 4>(acc[u], ah, al, bh, bl, on_m, on);
    }
  }

  float* cb = p.cb + ((long long)b * p.nc + c) * Q * p.LQ;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = m0 + g + 8 * h2;
    if (i >= Q) continue;
    float* row = cb + (long long)i * p.LQ;
#pragma unroll
    for (int jt = 0; jt < kMaxQ / 8; ++jt) {
      const int j = 8 * jt + 2 * q;
      if (j >= p.LQ) continue;
      float v0 = 0.f, v1 = 0.f;
      if (jt <= jt_hi) {
        v0 = j <= i ? acc[jt / 4][0][jt % 4][2 * h2] : 0.f;
        v1 = j + 1 <= i ? acc[jt / 4][0][jt % 4][2 * h2 + 1] : 0.f;
      }
      *reinterpret_cast<float2*>(row + j) = make_float2(v0, v1);
    }
  }
}

// ------------------------------ 2. chunk states per (b, chunk, h)
// ds (P x N) = (w o x)^T B with K = Q: warps 2 (32 rows of p) x 4 (32
// columns of n), two 16-row and four 8-column tiles each.
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_state_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                     // [kMaxQ][kLdX]
  float* Bs = xs + kMaxQ * kLdX;        // [kMaxQ][kLdB]
  float* dts = Bs + kMaxQ * kLdB;       // [kMaxQ]
  float* cums = dts + kMaxQ;            // [kMaxQ]
  float* ws = cums + kMaxQ;             // [kMaxQ] exp(cum_Q - cum) * dt
  double* cumd = reinterpret_cast<double*>(ws + kMaxQ);   // [kMaxQ]
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int Q = p.Q, P = p.P, N = p.N, c0 = c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;

  stage_dt(dts, p.dt + b * p.dt_sb + h * p.dt_sh + (long long)c0 * p.dt_ss,
           p.dt_ss, Q, tid);
  tc::stage_tile(xs, kLdX,
                 p.x + b * p.x_sb + h * p.x_sh + (long long)c0 * p.x_ss,
                 p.x_ss, round_up(Q, 8), kMaxP, Q, P,
                 p.vec_x != 0, tid, kThreads);
  tc::stage_tile(Bs, kLdB, p.Bm + b * p.b_sb + (long long)c0 * p.b_ss,
                 p.b_ss, round_up(Q, 8), kMaxN, Q, N,
                 p.vec_b != 0, tid, kThreads);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, cums, p.A[h], Q, lane, cumd);
  __syncthreads();
  for (int j = tid; j < kMaxQ; j += kThreads)
    ws[j] = j < Q ? exp_diff(cumd[Q - 1], cumd[j]) * dts[j] : 0.f;
  if (tid == 0)
    p.decay[((long long)b * p.nc + c) * p.H + h] = expf(cums[Q - 1]);
  __syncthreads();

  const int wm0 = 32 * (warp / 4), wn0 = 32 * (warp % 4);
  if (wm0 >= P || wn0 >= N) return;
  bool m_on[2], n_on[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) m_on[i] = wm0 + 16 * i < P;
#pragma unroll
  for (int j = 0; j < 4; ++j) n_on[j] = wn0 + 8 * j < N;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int kk = 0; kk < Q; kk += 8) {
    const float w0 = ws[kk + q], w1 = ws[kk + q + 4];
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!n_on[j]) continue;
      const float* bp = Bs + (kk + q) * kLdB + wn0 + 8 * j + g;
      split(bp[0], bh[j][0], bl[j][0]);
      split(bp[4 * kLdB], bh[j][1], bl[j][1]);
    }
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!m_on[i]) continue;
      // A (p, key) = w_key * x[key][p]: a0 (g, t), a1 (g+8, t), a2 (g,
      // t+4), a3 (g+8, t+4)
      const float* a = xs + (kk + q) * kLdX + wm0 + 16 * i + g;
      split(a[0] * w0, ah[i][0], al[i][0]);
      split(a[8] * w0, ah[i][1], al[i][1]);
      split(a[4 * kLdX] * w1, ah[i][2], al[i][2]);
      split(a[4 * kLdX + 8] * w1, ah[i][3], al[i][3]);
    }
    mma_tiles<2, 4>(acc, ah, al, bh, bl, m_on, n_on);
  }

  float* st = p.st + (((long long)b * (p.nc - 1) + c) * p.H + h) *
                         (long long)P * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int pr = wm0 + 16 * i + g + 8 * h2;
      if (pr >= P) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = wn0 + 8 * j + 2 * q;
        if (n < N) st[pr * N + n] = acc[i][j][2 * h2];
        if (n + 1 < N) st[pr * N + n + 1] = acc[i][j][2 * h2 + 1];
      }
    }
}

// ------------------------------ 3. the state pass, in place
// st[c] holds ds_c; afterwards the state after chunk c (chunk c+1's input).
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(const Params p) {
  const long long per = (long long)p.H * p.P * p.N;   // one chunk, one row
  const long long e = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (e >= per) return;
  const int b = blockIdx.y;
  const int h = (int)(e / ((long long)p.P * p.N));
  const int ns = p.nc - 1;                             // stored states
  float* s = p.st + (long long)b * ns * per + e;
  const float* dec = p.decay + (long long)b * p.nc * p.H + h;
  float run = s[0];                                    // s_1 = ds_0
  for (int c = 1; c < ns; c += kAhead) {
    float ds[kAhead], dk[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c + u < ns) {
        ds[u] = s[(c + u) * per];
        dk[u] = dec[(long long)(c + u) * p.H];
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c + u < ns) {
        run = fmaf(dk[u], run, ds[u]);
        s[(c + u) * per] = run;
      }
  }
}

// ------------------------------ 4. outputs per (b, chunk, h)
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_out_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                         // [kStages][kSliceA]
  float* Bs = As + kStages * kSliceA;       // [kStages][kSliceB]
  float* dts = Bs + kStages * kSliceB;      // [kMaxQ]
  float* cums = dts + kMaxQ;                // [kMaxQ]
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int Q = p.Q, P = p.P, N = p.N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int MT = (Q + 15) / 16;
  // K slices: C s^T over N (none for the first chunk, whose state is
  // zero), then the scores times x over the Q keys
  const int KI = c > 0 ? (N + kSlice - 1) / kSlice : 0;
  const int KT = KI + (Q + kSlice - 1) / kSlice;

  auto stage = [&](int kt) {
    float* a = As + (kt % kStages) * kSliceA;
    float* bs = Bs + (kt % kStages) * kSliceB;
    const long long c0 = (long long)c * Q;
    if (kt < KI) {
      const int n0 = kt * kSlice;
      tc::stage_tile(a, kLdS, p.Cm + b * p.c_sb + c0 * p.c_ss + n0, p.c_ss,
                     MT * 16, kSlice, Q, N - n0, p.vec_c != 0, tid,
                     kThreads);
      tc::stage_tile(bs, kLdS,
                     p.st + (((long long)b * (p.nc - 1) + c - 1) * p.H + h) *
                                (long long)P * N + n0,
                     N, round_up(P, 8), kSlice, P, N - n0, p.vec_s != 0,
                     tid, kThreads);
    } else {
      const int j0 = (kt - KI) * kSlice;
      tc::stage_tile(a, kLdS,
                     p.cb + ((long long)b * p.nc + c) * Q * p.LQ + j0, p.LQ,
                     MT * 16, kSlice, Q, p.LQ - j0, true, tid, kThreads);
      tc::stage_tile(bs, kLdX,
                     p.x + b * p.x_sb + h * p.x_sh + (c0 + j0) * p.x_ss,
                     p.x_ss, kSlice, kMaxP, Q - j0, P,
                     p.vec_x != 0, tid, kThreads);
    }
  };

  stage_dt(dts, p.dt + b * p.dt_sb + h * p.dt_sh + (long long)c * Q * p.dt_ss,
           p.dt_ss, Q, tid);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {  // group 0 holds dt too
    if (st < KT) stage(st);
    tc::cp_async_commit();
  }
  tc::cp_async_wait<kStages - 2>();
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, cums, p.A[h], Q, lane);

  // warp w: 16-row tiles k and 7 - k (k = w / 2), columns 32 (w % 2) + 32
  const int pair = warp >> 1;
  const int mt[2] = {pair, kMaxQ / 16 - 1 - pair};
  const int wn0 = 32 * (warp & 1);
  bool n_on[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) n_on[j] = wn0 + 8 * j < P;
  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int kt = 0; kt < KT; ++kt) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();                        // slice kt landed; kt-1 consumed
    if (kt + kStages - 1 < KT) stage(kt + kStages - 1);
    tc::cp_async_commit();
    float* a = As + (kt % kStages) * kSliceA;
    const float* bs = Bs + (kt % kStages) * kSliceB;
    const bool inter = kt < KI;
    // first key of an intra slice; inter slices skip no tile
    const int j0 = inter ? -kMaxQ : (kt - KI) * kSlice;

    if (!inter) {
      // the scores CB o L o dt_j in place, the mask first, four keys a
      // thread; rows above the slice (i < j0: their 16-row tiles skip it)
      // are left as they are
      for (int e = tid; e < MT * 16 * (kSlice / 4); e += kThreads) {
        const int i = e / (kSlice / 4), jj = e % (kSlice / 4) * 4;
        if (i < j0) continue;
        const int j = j0 + jj;
        float4* v = reinterpret_cast<float4*>(a + i * kLdS + jj);
        const float4 cj = *reinterpret_cast<const float4*>(cums + j);
        const float4 dj = *reinterpret_cast<const float4*>(dts + j);
        const float ci = cums[i];
        float4 sc = *v;
        sc.x = j <= i ? sc.x * expf(ci - cj.x) * dj.x : 0.f;
        sc.y = j + 1 <= i ? sc.y * expf(ci - cj.y) * dj.y : 0.f;
        sc.z = j + 2 <= i ? sc.z * expf(ci - cj.z) * dj.z : 0.f;
        sc.w = j + 3 <= i ? sc.w * expf(ci - cj.w) * dj.w : 0.f;
        *v = sc;
      }
      __syncthreads();
    }

    // B fragment (k, column p): s rows [p][n] for C s^T, x rows [key][p]
    // for the scores times x
    const int rs = inter ? kLdS : 1, ks = inter ? 1 : kLdX;
    const int kn = inter ? min(kSlice, N - kt * kSlice) : min(kSlice, Q - j0);
#pragma unroll 1
    for (int kk = 0; kk < kn; kk += 8) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!n_on[j]) continue;
        const float* bp = bs + (wn0 + 8 * j + g) * rs + (kk + q) * ks;
        split(bp[0], bh[j][0], bl[j][0]);
        split(bp[4 * ks], bh[j][1], bl[j][1]);
      }
      // one tile's three products back to back: measured 5% faster here
      // than mma_tiles' order
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // a tile past Q, or whose rows all lie above these keys, adds
        // nothing
        if (mt[i] >= MT || 16 * mt[i] + 15 < j0 + kk) continue;
        const float* ap = a + (16 * mt[i] + g) * kLdS + kk + q;
        uint32_t ah[4], al[4];
        split(ap[0], ah[0], al[0]);
        split(ap[8 * kLdS], ah[1], al[1]);
        split(ap[4], ah[2], al[2]);
        split(ap[8 * kLdS + 4], ah[3], al[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n_on[j]) tc::mma_3xtf32(acc[i][j], ah, al, bh[j], bl[j]);
      }
    }
    if (kt == KI - 1) {
      // the state's part, C s^T, is summed: scale its rows by exp(cum)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int row = 16 * mt[i] + g + 8 * h2;
          const float e = row < Q ? expf(cums[row]) : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j][2 * h2] *= e;
            acc[i][j][2 * h2 + 1] *= e;
          }
        }
    }
  }
  tc::cp_async_wait<0>();

  float* yc = p.y + (((long long)b * p.S + (long long)c * Q) * p.H + h) * P;
  const long long y_ss = (long long)p.H * P;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (mt[i] >= MT) continue;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = 16 * mt[i] + g + 8 * h2;
      if (row >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn0 + 8 * j + 2 * q;
        if (col < P) yc[row * y_ss + col] = acc[i][j][2 * h2];
        if (col + 1 < P) yc[row * y_ss + col + 1] = acc[i][j][2 * h2 + 1];
      }
    }
  }
}

constexpr size_t kSmemCB = sizeof(float) * 2 * kMaxQ * kLdCB;
constexpr size_t kSmemState =
    sizeof(float) * (kMaxQ * kLdX + kMaxQ * kLdB + 3 * kMaxQ) +
    sizeof(double) * kMaxQ;
constexpr size_t kSmemOut =
    sizeof(float) * (kStages * (kSliceA + kSliceB) + 2 * kMaxQ);

// The forward's Params; false for a shape the kernels do not take.
bool make_params(Params& p, const void* x, const void* dt, const void* A,
                 const void* Bm, const void* Cm, void* y, void* cb, void* st,
                 void* decay, const long long* strides, int B, int S, int H,
                 int P, int N, int Q) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      S % Q != 0 || S / Q > 65535 || B < 1 || B > 65535 || H < 1)
    return false;
  p.x = static_cast<const float*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = static_cast<const float*>(Bm);
  p.Cm = static_cast<const float*>(Cm);
  p.y = static_cast<float*>(y);
  p.cb = static_cast<float*>(cb);
  p.st = static_cast<float*>(st);
  p.decay = static_cast<float*>(decay);
  p.x_sb = strides[0]; p.x_ss = strides[1]; p.x_sh = strides[2];
  p.dt_sb = strides[3]; p.dt_ss = strides[4]; p.dt_sh = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7];
  p.c_sb = strides[8]; p.c_ss = strides[9];
  p.S = S; p.H = H; p.P = P; p.N = N; p.Q = Q;
  p.nc = S / Q;
  p.LQ = round_up(Q, 4);
  p.vec_x = aligned16(x) && p.x_sb % 4 == 0 && p.x_ss % 4 == 0 &&
            p.x_sh % 4 == 0 && P % 4 == 0;
  p.vec_b = aligned16(Bm) && p.b_sb % 4 == 0 && p.b_ss % 4 == 0 &&
            N % 4 == 0;
  p.vec_c = aligned16(Cm) && p.c_sb % 4 == 0 && p.c_ss % 4 == 0 &&
            N % 4 == 0;
  p.vec_s = aligned16(st) && N % 4 == 0;
  return true;
}

// Launches 2 and 3 (2 only if nc > 1, 3 only if nc > 2).
int run_states(const Params& p, int B, cudaStream_t s) {
  int err;
  if (p.nc > 1) {
    err = launch(ssd_chunk_state_kernel, dim3(p.H, p.nc - 1, B), kSmemState,
                 s, p);
    if (err) return err;
  }
  if (p.nc > 2) {
    const long long per = (long long)p.H * p.P * p.N;
    err = launch(ssd_state_pass_kernel,
                 dim3((unsigned)((per + kThreads - 1) / kThreads), B), 0, s,
                 p);
    if (err) return err;
  }
  return 0;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Strides are in elements:
// x [batch, seq, head], dt [batch, seq, head], B [batch, seq],
// C [batch, seq].  cb (B, nc, Q, round_up(Q, 4)), st (B, nc-1, H, P, N)
// and decay (B, nc, H) are float32 scratch the caller allocates.  Launches
// 1 to 4 in order on `stream` (2 only if nc > 1, 3 only if nc > 2) and
// returns the first non-zero cudaGetLastError() code (or that of raising a
// dynamic shared-memory limit, or cudaErrorInvalidValue for a shape the
// kernels do not take); the wrapper raises on non-zero.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            void* cb, void* st, void* decay,
                            const long long* strides, int B, int S, int H,
                            int P, int N, int Q, void* stream) {
  Params p;
  if (!make_params(p, x, dt, A, Bm, Cm, y, cb, st, decay, strides, B, S, H,
                   P, N, Q))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = launch(ssd_cb_kernel, dim3(p.nc, B), kSmemCB, s, p);
  if (err || (err = run_states(p, B, s))) return err;
  return launch(ssd_chunk_out_kernel, dim3(H, p.nc, B), kSmemOut, s, p);
}

// Launches 2 and 3 alone, for the backward (ssd_scan_bwd.cu), which
// recomputes the states entering chunks 1..nc-1 and exp(cum_Q) of chunks
// 0..nc-2 instead of keeping them from the forward (and forms its own
// C B^T).  Same operands and scratch as ssd_scan_f32, no y and no cb.
extern "C" int ssd_scan_states_f32(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, void* st, void* decay,
                                   const long long* strides, int B, int S,
                                   int H, int P, int N, int Q,
                                   void* stream) {
  Params p;
  if (!make_params(p, x, dt, A, Bm, Cm, nullptr, nullptr, st, decay,
                   strides, B, S, H, P, N, Q))
    return (int)cudaErrorInvalidValue;
  return run_states(p, B, static_cast<cudaStream_t>(stream));
}
