// Backward of the Mamba-2 chunked SSD scan for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces: the gradient the JAX package takes of its chunked SSD
// (src/repro/models/ssm.py::ssd_chunked, differentiated by jax.grad under
// jax.checkpoint; the Pallas kernel src/repro/kernels/ssd_scan.py::ssd_scan
// has no backward).  The forward's contract (ssd_scan.cu): x (B, S, H, P),
// dt (B, S, H), A (H,), B and C (B, S, N) float32, one group of B and C
// shared by every head, the state starting at zero, S a multiple of Q.
// Given dy (B, S, H, P) it returns dx, ddt, dA, dB and dC in the operands'
// shapes, float32.
//
// Per (b, h) and chunk c of Q steps, with cum_i = sum_{k<=i} dt_k A_h, the
// state s_c entering the chunk (s_0 = 0), L_ij = exp(cum_i - cum_j) for
// j <= i (masked before the exponential, as in the forward), CB = C B^T
// and G_c = dl/ds_c:
//   G_c   = sum_i exp(cum_i) dy_i C_i^T + exp(cum_Q-1) G_c+1,  G_nc = 0;
//   dx_j  = dt_j acc_j, acc_j = exp(cum_Q-1 - cum_j) G_c+1 B_j
//           + sum_{i>=j} CB_ij L_ij dy_i;
//   dC_i  = sum_h [sum_{j<=i} dCB_ij B_j + exp(cum_i) s_c^T dy_i],
//   dB_j  = sum_h [sum_{i>=j} dCB_ij C_i + exp(cum_Q-1 - cum_j) dt_j
//           G_c+1^T x_j], with dCB_ij = (dy_i . x_j) L_ij dt_j;
//   dl/d(dt_k A_h) = dda_k = sum_{i>=k, j<k} D_ij
//           + sum_{i>=k} exp(cum_i) dy_i . (s_c C_i)
//           + sum_{j<k} dt_j x_j . (state part of acc_j)
//           + exp(cum_Q-1) <s_c, G_c+1>,  D_ij = (dy_i . x_j) CB_ij L_ij dt_j;
//   ddt_k = A_h dda_k + x_k . acc_k;   dA_h = sum_{b, k} dt_k dda_k.
// dda sums what crosses step k (pairs j < k <= i, the state written before
// k) rather than taking the reverse cumsum of dl/dcum: that form, or
// dy . y - x . dx in its place, cancels large terms and measured two to
// five times the float32 error of the sequential recurrence on dA
// (tests/test_torch_tf32x3.py's emulation).
//
// What bounds it on the H100: the tensor-core products.  Per (b, chunk,
// head) the forward's C s^T again and its mirror B G^T (Q*N*P each, where
// a state or gradient is carried), the scores' transpose times dy and
// dy x^T over the causal pairs (times P), the local gradient state
// (exp(cum) o dy)^T C (Q*P*N, chunks after the first); per (b, chunk) dC
// and dB ((Q x H*P)(H*P x N) each where a state is carried, and dCB's
// Q x Q times N); plus the forward's C B^T and chunk states, recomputed.
// At mamba2-2.7b's layer (B 1, S 4096, H 80, P 64, N 128, Q 128) that is
// 36.8 GFLOP, 2.8 times the forward's 13.2, all 3xTF32 (an effective 165
// TFLOP/s): bound by operations, 0.223 ms.  This design computes dy x^T
// twice (launches d and e below), 39.5 GFLOP in all.  chip_smoke.py's
// check_ssd_bwd counts both from the shapes.
//
// Design, launches in stream order:
//  a. ssd_scan_states_f32 (ssd_scan.cu, launches 1 to 3): C B^T, the
//     states entering chunks 1..nc-1 and exp(cum_Q-1), recomputed, so
//     autograd keeps only the five operands;
//  b. ssd_bwd_gloc, one block per (b, chunk >= 1, h): (exp(cum) o dy)^T C,
//     P x N over K = Q, into the G scratch (B, nc-1, H, P, N);
//  c. ssd_bwd_state_pass, one thread per (b, h, p, n): G_c = that +
//     exp(cum_Q-1) G_c+1 in place, last chunk to first (the mirror of the
//     forward's state pass); bound by bytes;
//  d. ssd_bwd_chunk, one block per (b, chunk, h): in turn C s_c^T (its row
//     dots with dy), exp(cum_Q-1 - cum) o B G_c+1^T (dx's state part, its
//     row dots with x), (CB o L)^T dy (dx's scores part, its row dots
//     with x), then dy x^T o CB o L o dt_j into shared memory, whose
//     crossing sums (an exclusive prefix along each row, then each column
//     summed below the diagonal) give dda; writes dx, ddt, the chunk's
//     cumsum for launch e and a (B, nc, H) partial of dA;
//  e. ssd_bwd_dcb, one block per (b, chunk, 64 x 64 tile of the causal
//     triangle): dCB summed over the heads in order, each head's dy x^T in
//     a zeroed fragment scaled and added once, into the dCB scratch
//     (B, nc, Q, LQ);
//  f. ssd_bwd_dbc, one block per (b, chunk, dB or dC, 64-row tile, 64-wide
//     N tile): the heads' products (K = P each) then dCB's (K = 64 slices
//     of Q), each slice into a zeroed fragment added once, so a sum over
//     K = H*P = 5,120 is not truncated by the tensor core's accumulation;
//  g. ssd_bwd_da: dA_h = the partials summed over b, then chunks, in
//     order.
// Every product is 3xTF32 mma.sync on fragments split in registers
// (tf32x3.cuh), each 8-deep key step summed in a zeroed fragment and added
// in fp32 (mma_add); every exp(cum_i - cum_j) is taken from the chunk's
// cumsum summed in double (ssd_common.cuh).  K slices are staged through
// a 2-stage cp.async ring with zero fill; ragged Q, P and N are masked on
// store; nothing is read past S.
//
// Determinism: one fixed order for every sum (no split-K, no atomics).
// dx, ddt, dB and dC of row b read only row b's inputs and scratch; dA sums
// over the batch.
#include "ssd_common.cuh"

extern "C" int ssd_scan_states_f32(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, void* cb, void* st,
                                   void* decay, const long long* strides,
                                   int B, int S, int H, int P, int N, int Q,
                                   void* stream);

namespace {

using tc::split;

constexpr int kSlice = 64;          // K slice of every staged product
// Row strides (floats) of staged tiles.  An operand whose fragment is read
// at (row g, column t) has a stride of 4 (mod 32), one read at (row t,
// column g) a stride of 8 (mod 32).
constexpr int kLdA = kSlice + 4;    // rows read by (row, key)
constexpr int kLdK = kSlice + 8;    // rows indexed by key
constexpr int kLdT = kMaxQ + 8;     // a C B^T slice read transposed
constexpr int kLdX = kMaxP + 8;     // dy rows, keys by P (launch b)
constexpr int kLdN = kMaxN + 8;     // C rows, keys by N (launch b)
constexpr int kLdD = kMaxQ + 1;     // D rows, scanned one thread a row
constexpr int kSliceA = kMaxQ * kLdA;                // 128 rows x 64
static_assert(kSlice * kLdT == kSliceA, "a CB slice fills an A stage");
constexpr int kSliceB = kSlice * kLdK;               // 64 rows x 64
constexpr int kAhead = 8;           // gradient loads in flight in launch c

struct BwdParams {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  const float* dy;     // (B, S, H, P) contiguous
  float* dx;           // (B, S, H, P)
  float* ddt;          // (B, S, H)
  float* dA;           // (H,)
  float* dB;           // (B, S, N)
  float* dC;           // (B, S, N)
  const float* cb;     // (B, nc, Q, LQ) C B^T, zero above the diagonal
  const float* st;     // (B, nc-1, H, P, N) the state entering chunk c+1
  const float* decay;  // (B, nc, H) exp(cum_Q-1), chunks 0..nc-2
  float* gst;          // (B, nc-1, H, P, N) G_c+1 (launch b: local part)
  double* cum;         // (B, nc, H, Q) the chunk's cumsum, in double
  float* dcb;          // (B, nc, Q, LQ) dCB summed over the heads
  float* dap;          // (B, nc, H) dA's partials
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  int S, H, P, N, Q, nc, LQ;
  int vec_x, vec_b, vec_c, vec_s, vec_dy;   // 16-byte copies
};

// A fragment (16 x 8) of an operand whose element (row r, key k) is
// a[r * rs + k * ks], rows g and g + 8 scaled by s0 and s1.
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                       const float* a, int rs, int ks,
                                       int g, int q, float s0, float s1) {
  split(a[g * rs + q * ks] * s0, hi[0], lo[0]);
  split(a[(g + 8) * rs + q * ks] * s1, hi[1], lo[1]);
  split(a[g * rs + (q + 4) * ks] * s0, hi[2], lo[2]);
  split(a[(g + 8) * rs + (q + 4) * ks] * s1, hi[3], lo[3]);
}

// B fragment (8 x 8) of an operand whose element (key k, column n) is
// b[k * ks + n * ns].
__device__ __forceinline__ void frag_b(uint32_t (&hi)[2], uint32_t (&lo)[2],
                                       const float* b, int ks, int ns, int g,
                                       int q) {
  split(b[q * ks + g * ns], hi[0], lo[0]);
  split(b[(q + 4) * ks + g * ns], hi[1], lo[1]);
}

// d += a b in 3xTF32 over one 8-deep key step: the three products summed
// in a zeroed fragment (small terms first), then added to d in fp32.  The
// tensor core's fp32 accumulation truncates, so a long K summed in place
// drifts from float64 (three to four times the plain loop's error on dx
// and ddt at mamba2-2.7b's layer, measured on the H100).
__device__ __forceinline__ void mma_add(float (&d)[4], const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const uint32_t (&bh)[2],
                                        const uint32_t (&bl)[2]) {
  float t[4];
  tc::mma_tf32_z(t, al, bh);
  tc::mma_tf32(t, ah, bl);
  tc::mma_tf32(t, ah, bh);
#pragma unroll
  for (int r = 0; r < 4; ++r) d[r] += t[r];
}

template <int MI>
__device__ __forceinline__ void zero(float (&acc)[MI][4][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

// A 2-stage cp.async ring over KT K slices: stage(kt, buf) issues slice
// kt's copies into buffer buf, use(kt, buf) consumes it while slice kt + 1
// lands.  Every thread runs it; it ends with the copies drained.
template <typename Stage, typename Use>
__device__ __forceinline__ void ring(int KT, Stage stage, Use use) {
  if (KT > 0) stage(0, 0);
  tc::cp_async_commit();
  for (int kt = 0; kt < KT; ++kt) {
    tc::cp_async_wait<0>();
    __syncthreads();                  // slice kt landed; kt - 1 consumed
    if (kt + 1 < KT) stage(kt + 1, (kt + 1) & 1);
    tc::cp_async_commit();
    use(kt, kt & 1);
  }
  tc::cp_async_wait<0>();
  __syncthreads();
}

// ------------------------------- launch d's Q x 64 output tile
// Warp w owns the 16-row tiles w/2 and 7 - w/2 (one from each end of a
// causal triangle) and the 32 columns from 32 (w % 2).
struct Tile {
  int mt[2];
  int MT;       // 16-row tiles holding rows < Q
  int wn0;
  bool n_on[4];
};

// acc += A B over kn keys (a multiple of 8, zero-filled past the data):
// A (r, k) at a[r * ars + k * aks], B (k, n) at b[k * bks + n * bns];
// row tile i takes nothing from the 8 keys at kk where skip(mt[i], kk).
template <typename Skip>
__device__ __forceinline__ void mma_rows(float (&acc)[2][4][4],
                                         const float* a, int ars, int aks,
                                         const float* b, int bks, int bns,
                                         int kn, const Tile& t, int g, int q,
                                         Skip skip) {
#pragma unroll 1
  for (int kk = 0; kk < kn; kk += 8) {
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (t.n_on[j])
        frag_b(bh[j], bl[j], b + kk * bks + (t.wn0 + 8 * j) * bns, bks,
               bns, g, q);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (t.mt[i] >= t.MT || skip(t.mt[i], kk)) continue;
      uint32_t ah[4], al[4];
      frag_a(ah, al, a + 16 * t.mt[i] * ars + kk * aks, ars, aks, g, q, 1.f,
             1.f);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t.n_on[j]) mma_add(acc[i][j], ah, al, bh[j], bl[j]);
    }
  }
}

// red[half * kMaxQ + row] = the dot product of acc's row (the warp's 32
// columns) with row `row` of v (row r at v + r * vs, columns contiguous),
// for rows < Q; half = the warp's column half.  The caller syncs and adds
// the two halves.
__device__ __forceinline__ void row_dots(const float (&acc)[2][4][4],
                                         const float* v, long long vs,
                                         const Tile& t, int P, int Q, int g,
                                         int q, int half, float* red) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = 16 * t.mt[i] + g + 8 * h2;
      const bool on = t.mt[i] < t.MT && row < Q;
      float s = 0.f;
      if (on) {
        const float* vr = v + row * vs;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = t.wn0 + 8 * j + 2 * q;
          if (col < P) s = fmaf(acc[i][j][2 * h2], vr[col], s);
          if (col + 1 < P) s = fmaf(acc[i][j][2 * h2 + 1], vr[col + 1], s);
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (on && q == 0) red[half * kMaxQ + row] = s;
    }
}

// ------------------------------ b. G's local part per (b, chunk, h)
// (exp(cum) o dy)^T C, P x N with K = Q, for chunks 1..nc-1: warps 2 (32
// rows of p) x 4 (32 columns of n), two 16-row and four 8-column tiles.
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_gloc_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                    // [kMaxQ][kLdX]
  float* Cs = dys + kMaxQ * kLdX;       // [kMaxQ][kLdN]
  float* dts = Cs + kMaxQ * kLdN;       // [kMaxQ]
  float* cums = dts + kMaxQ;            // [kMaxQ]
  float* es = cums + kMaxQ;             // [kMaxQ] exp(cum), 0 past Q
  const int h = blockIdx.x, c = blockIdx.y + 1, b = blockIdx.z;
  const int Q = p.Q, P = p.P, N = p.N, H = p.H;
  const long long c0 = (long long)c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;

  stage_dt(dts, p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss, p.dt_ss, Q,
           tid);
  tc::stage_tile(dys, kLdX, p.dy + (((long long)b * p.S + c0) * H + h) * P,
                 (long long)H * P, round_up(Q, 8), kMaxP, Q, P,
                 p.vec_dy != 0, tid, kThreads);
  tc::stage_tile(Cs, kLdN, p.Cm + b * p.c_sb + c0 * p.c_ss, p.c_ss,
                 round_up(Q, 8), kMaxN, Q, N, p.vec_c != 0, tid, kThreads);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, cums, p.A[h], Q, lane);
  __syncthreads();
  for (int j = tid; j < kMaxQ; j += kThreads)
    es[j] = j < Q ? expf(cums[j]) : 0.f;
  __syncthreads();

  const int wm0 = 32 * (warp / 4), wn0 = 32 * (warp % 4);
  if (wm0 >= P || wn0 >= N) return;
  bool m_on[2], n_on[4];
#pragma unroll
  for (int i = 0; i < 2; ++i) m_on[i] = wm0 + 16 * i < P;
#pragma unroll
  for (int j = 0; j < 4; ++j) n_on[j] = wn0 + 8 * j < N;
  float acc[2][4][4];
  zero(acc);
  for (int kk = 0; kk < Q; kk += 8) {
    const float w0 = es[kk + q], w1 = es[kk + q + 4];
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (n_on[j])
        frag_b(bh[j], bl[j], Cs + kk * kLdN + wn0 + 8 * j, kLdN, 1, g, q);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!m_on[i]) continue;
      // A (p, key) = exp(cum_key) dy[key][p]: the scale follows the key
      const float* a = dys + (kk + q) * kLdX + wm0 + 16 * i + g;
      uint32_t ah[4], al[4];
      split(a[0] * w0, ah[0], al[0]);
      split(a[8] * w0, ah[1], al[1]);
      split(a[4 * kLdX] * w1, ah[2], al[2]);
      split(a[4 * kLdX + 8] * w1, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n_on[j]) mma_add(acc[i][j], ah, al, bh[j], bl[j]);
    }
  }

  float* gs = p.gst + (((long long)b * (p.nc - 1) + c - 1) * H + h) *
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
        if (n < N) gs[pr * N + n] = acc[i][j][2 * h2];
        if (n + 1 < N) gs[pr * N + n + 1] = acc[i][j][2 * h2 + 1];
      }
    }
}

// ------------------------------ c. the reverse state pass, in place
// gst[c] holds G_c+1's local part; afterwards G_c+1.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_state_pass_kernel(const BwdParams p) {
  const long long per = (long long)p.H * p.P * p.N;
  const long long e = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (e >= per) return;
  const int b = blockIdx.y;
  const int h = (int)(e / ((long long)p.P * p.N));
  const int ns = p.nc - 1;
  float* g = p.gst + (long long)b * ns * per + e;
  const float* dec = p.decay + (long long)b * p.nc * p.H + h;
  float run = g[(long long)(ns - 1) * per];          // G_nc-1
  for (int c = ns - 2; c >= 0; c -= kAhead) {
    float gl[kAhead], dk[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c - u >= 0) {
        gl[u] = g[(long long)(c - u) * per];
        dk[u] = dec[(long long)(c - u + 1) * p.H];
      }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (c - u >= 0) {
        run = fmaf(dk[u], run, gl[u]);
        g[(long long)(c - u) * per] = run;
      }
  }
}

// The head's double cumsum for chunk c (launch d's scratch) into dst
// (kMaxQ doubles, 8-byte aligned), as float pairs; zero past Q.
__device__ __forceinline__ void stage_cum(float* dst, const double* cum,
                                          int b, int c, int h,
                                          const BwdParams& p, int tid) {
  const float* src = reinterpret_cast<const float*>(
      cum + (((long long)b * p.nc + c) * p.H + h) * p.Q);
  for (int j = tid; j < 2 * kMaxQ; j += kThreads)
    tc::cp_async4(dst + j, j < 2 * p.Q ? src + j : src,
                  j < 2 * p.Q ? 4 : 0);
}

// ------------------------------ d. per (b, chunk, h)
__global__ void __launch_bounds__(kThreads, 1)
ssd_bwd_chunk_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                         // [2][kSliceA]
  float* Bs = As + 2 * kSliceA;             // [2][kSliceB]
  float* Dm = Bs + 2 * kSliceB;             // [kMaxQ][kLdD]
  float* dts = Dm + kMaxQ * kLdD;           // [kMaxQ]
  float* cums = dts + kMaxQ;                // [kMaxQ]
  float* inter = cums + kMaxQ;              // exp(cum_i) dy_i . (s_c C_i)
  float* us = inter + kMaxQ;                // x_j . dx's state part / dt_j
  float* ui = us + kMaxQ;                   // x_j . dx's scores part / dt_j
  float* red = ui + kMaxQ;                  // [2][kMaxQ]
  float* part = red + 2 * kMaxQ;            // [kThreads]
  double* cumd = reinterpret_cast<double*>(part + kThreads);   // [kMaxQ]
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int Q = p.Q, P = p.P, N = p.N, H = p.H, nc = p.nc;
  const long long c0 = (long long)c * Q, PN = (long long)P * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4, half = warp & 1;
  Tile t;
  t.mt[0] = warp >> 1;
  t.mt[1] = kMaxQ / 16 - 1 - (warp >> 1);
  t.MT = (Q + 15) / 16;
  t.wn0 = 32 * half;
#pragma unroll
  for (int j = 0; j < 4; ++j) t.n_on[j] = t.wn0 + 8 * j < P;
  const bool has_s = c > 0, has_g = c < nc - 1;
  const float* xb = p.x + b * p.x_sb + h * p.x_sh + c0 * p.x_ss;
  const long long dy_rs = (long long)H * P;
  const float* dyb = p.dy + (((long long)b * p.S + c0) * H + h) * P;
  float* dxb = p.dx + (((long long)b * p.S + c0) * H + h) * P;
  const float* s_c =
      has_s ? p.st + (((long long)b * (nc - 1) + c - 1) * H + h) * PN
            : nullptr;
  const float* g_n =
      has_g ? p.gst + (((long long)b * (nc - 1) + c) * H + h) * PN
            : nullptr;
  const float* cbc = p.cb + ((long long)b * nc + c) * Q * p.LQ;

  stage_dt(dts, p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss, p.dt_ss, Q,
           tid);
  tc::cp_async_commit();
  for (int i = tid; i < kMaxQ; i += kThreads) inter[i] = us[i] = ui[i] = 0.f;
  tc::cp_async_wait<0>();
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, cums, p.A[h], Q, lane, cumd);
  __syncthreads();
  for (int j = tid; j < Q; j += kThreads)
    p.cum[(((long long)b * nc + c) * H + h) * Q + j] = cumd[j];

  float acc[2][4][4];
  auto none = [](int, int) { return false; };
  // C s_c^T or B G_c+1^T: rows (Q x N) times a (P x N) state, K = N
  auto by_state = [&](const float* rows, long long rs, bool vec,
                      const float* state) {
    zero(acc);
    ring((N + kSlice - 1) / kSlice,
         [&](int kt, int buf) {
           const int n0 = kt * kSlice;
           tc::stage_tile(As + buf * kSliceA, kLdA, rows + n0, rs,
                          t.MT * 16, kSlice, Q, N - n0, vec, tid, kThreads);
           tc::stage_tile(Bs + buf * kSliceB, kLdA, state + n0, N,
                          round_up(P, 8), kSlice, P, N - n0, p.vec_s != 0,
                          tid, kThreads);
         },
         [&](int kt, int buf) {
           mma_rows(acc, As + buf * kSliceA, kLdA, 1, Bs + buf * kSliceB, 1,
                    kLdA, round_up(min(kSlice, N - kt * kSlice), 8), t, g, q,
                    none);
         });
  };
  auto add_halves = [&](float* out) {
    __syncthreads();
    for (int i = tid; i < Q; i += kThreads)
      out[i] = red[i] + red[kMaxQ + i];
    __syncthreads();
  };
  // dx (+)= dt o acc, element by element in the warp's fragments
  auto store_dx = [&](bool add) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = 16 * t.mt[i] + g + 8 * h2;
        if (t.mt[i] >= t.MT || row >= Q) continue;
        float* d = dxb + row * dy_rs;
        const float w = dts[row];
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = t.wn0 + 8 * j + 2 * q + e;
            if (col >= P) continue;
            const float v = w * acc[i][j][2 * h2 + e];
            d[col] = add ? d[col] + v : v;
          }
      }
  };

  // 1. the inter-chunk term's row dots: exp(cum_i) dy_i . (s_c C_i)
  if (has_s) {
    by_state(p.Cm + b * p.c_sb + c0 * p.c_ss, p.c_ss, p.vec_c != 0, s_c);
    row_dots(acc, dyb, dy_rs, t, P, Q, g, q, half, red);
    add_halves(inter);
    for (int i = tid; i < Q; i += kThreads) inter[i] *= expf(cums[i]);
  }
  // 2. dx's state part: exp(cum_Q-1 - cum_j) (G_c+1 B_j)
  if (has_g) {
    by_state(p.Bm + b * p.b_sb + c0 * p.b_ss, p.b_ss, p.vec_b != 0, g_n);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = 16 * t.mt[i] + g + 8 * h2;
        const float e = row < Q ? exp_diff(cumd[Q - 1], cumd[row]) : 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j][2 * h2] *= e;
          acc[i][j][2 * h2 + 1] *= e;
        }
      }
    store_dx(false);
    row_dots(acc, xb, p.x_ss, t, P, Q, g, q, half, red);
    add_halves(us);
  }
  // 3. dx's scores part: (CB o L)^T dy over K = Q, a CB slice of 64 rows i
  //    staged as it is and read transposed, each rewritten in place into
  //    CB_ij L_ij (masked first) as it lands
  zero(acc);
  ring((Q + kSlice - 1) / kSlice,
       [&](int kt, int buf) {
         const int i0 = kt * kSlice;
         tc::stage_tile(As + buf * kSliceA, kLdT, cbc + (long long)i0 * p.LQ,
                        p.LQ, kSlice, kMaxQ, Q - i0, p.LQ, true, tid,
                        kThreads);
         tc::stage_tile(Bs + buf * kSliceB, kLdK, dyb + i0 * dy_rs, dy_rs,
                        kSlice, kMaxP, Q - i0, P, p.vec_dy != 0, tid,
                        kThreads);
       },
       [&](int kt, int buf) {
         const int i0 = kt * kSlice;
         float* a = As + buf * kSliceA;
         for (int e = tid; e < kSlice * (kMaxQ / 4); e += kThreads) {
           const int ii = e / (kMaxQ / 4), j = e % (kMaxQ / 4) * 4;
           const int i = i0 + ii;
           float4* v = reinterpret_cast<float4*>(a + ii * kLdT + j);
           const double ci = cumd[i];
           const bool in = i < Q;
           float4 sc = *v;
           sc.x = in && j <= i ? sc.x * exp_diff(ci, cumd[j]) : 0.f;
           sc.y = in && j + 1 <= i ? sc.y * exp_diff(ci, cumd[j + 1]) : 0.f;
           sc.z = in && j + 2 <= i ? sc.z * exp_diff(ci, cumd[j + 2]) : 0.f;
           sc.w = in && j + 3 <= i ? sc.w * exp_diff(ci, cumd[j + 3]) : 0.f;
           *v = sc;
         }
         __syncthreads();
         // rows j of a 16-row tile take nothing from keys i below them
         mma_rows(acc, a, 1, kLdT, Bs + buf * kSliceB, kLdK, 1,
                  round_up(min(kSlice, Q - i0), 8), t, g, q,
                  [&](int m, int kk) { return i0 + kk + 7 < 16 * m; });
       });
  store_dx(has_g);
  row_dots(acc, xb, p.x_ss, t, P, Q, g, q, half, red);
  add_halves(ui);

  // 4. D = (dy x^T) o CB o L o dt_j into shared memory, 64 columns at a
  //    time: dy and x staged whole (Q x P), K = P
  tc::stage_tile(As, kLdA, dyb, dy_rs, t.MT * 16, kMaxP, Q, P,
                 p.vec_dy != 0, tid, kThreads);
  tc::stage_tile(As + kSliceA, kLdA, xb, p.x_ss, t.MT * 16, kMaxP, Q, P,
                 p.vec_x != 0, tid, kThreads);
  tc::cp_async_commit();
  tc::cp_async_wait<0>();
  __syncthreads();
  for (int j0 = 0; j0 < Q; j0 += kSlice) {
    Tile tj = t;
#pragma unroll
    for (int j = 0; j < 4; ++j) tj.n_on[j] = j0 + t.wn0 + 8 * j < Q;
    zero(acc);
    mma_rows(acc, As, kLdA, 1, As + kSliceA + j0 * kLdA, 1, kLdA,
             round_up(P, 8), tj, g, q,
             [&](int m, int) { return 16 * m + 15 < j0; });
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = 16 * t.mt[i] + g + 8 * h2;
        if (t.mt[i] >= t.MT || row >= Q) continue;
        const float* cbr = cbc + (long long)row * p.LQ;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j0 + t.wn0 + 8 * j + 2 * q + e;
            if (col >= Q) continue;
            Dm[row * kLdD + col] =
                col <= row ? acc[i][j][2 * h2 + e] * cbr[col] *
                                 exp_diff(cumd[row], cumd[col]) * dts[col]
                           : 0.f;
          }
      }
  }
  // 5. <s_c, G_c+1>, summed in a fixed order
  float gsd = 0.f;
  if (has_s && has_g) {
    float s = 0.f;
    for (long long e = tid; e < PN; e += kThreads)
      s = fmaf(s_c[e], g_n[e], s);
    part[tid] = s;
    __syncthreads();
    if (tid == 0) {
      float tot = 0.f;
      for (int u = 0; u < kThreads; ++u) tot += part[u];
      part[0] = tot;
    }
    __syncthreads();
    gsd = p.decay[((long long)b * nc + c) * H + h] * part[0];
  }
  __syncthreads();
  // 6. each row's exclusive prefix: Dm[i][k] = sum_{j<k} D_ij
  if (tid < Q) {
    float run = 0.f;
    float* r = Dm + tid * kLdD;
    for (int k = 0; k < Q; ++k) {
      const float v = r[k];
      r[k] = run;
      run += v;
    }
  }
  __syncthreads();
  // 7. dda_k, ddt_k and dt_k dda_k
  if (tid < Q) {
    const int k = tid;
    float cross = 0.f, later = 0.f, written = 0.f;
    for (int i = k; i < Q; ++i) {
      cross += Dm[i * kLdD + k];
      later += inter[i];
    }
    for (int j = 0; j < k; ++j) written = fmaf(dts[j], us[j], written);
    const float dda = ((cross + later) + written) + gsd;
    p.ddt[((long long)b * p.S + c0 + k) * H + h] =
        p.A[h] * dda + (us[k] + ui[k]);
    part[k] = dts[k] * dda;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < Q; ++k) s += part[k];
    p.dap[((long long)b * nc + c) * H + h] = s;
  }
}

// ------------------------------ e. dCB per (b, chunk, 64 x 64 tile)
// dCB_ij = sum_h (dy_i . x_j) exp(cum_i - cum_j) dt_j for j <= i, heads in
// order; warps 4 (16 rows) x 2 (32 columns).
// a stage: dy rows, x rows, the head's cumsum (double), its dt
constexpr int kStageE = 2 * kSlice * kLdA + 3 * kMaxQ;

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dcb_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int Q = p.Q, P = p.P, H = p.H, nc = p.nc;
  const int RT = (Q + kSlice - 1) / kSlice;
  const int rt = blockIdx.x / RT, ct = blockIdx.x % RT;
  const int c = blockIdx.y, b = blockIdx.z;
  const int r0 = kSlice * rt, j0 = kSlice * ct;
  const long long c0 = (long long)c * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int m0 = 16 * (warp >> 1), wn0 = 32 * (warp & 1);
  float* out = p.dcb + (((long long)b * nc + c) * Q) * p.LQ;
  float acc[1][4][4];
  zero(acc);
  if (ct <= rt) {
    bool n_on[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) n_on[j] = j0 + wn0 + 8 * j < Q;
    // a warp's rows all above its columns take nothing
    const bool live = r0 + m0 < Q && j0 + wn0 <= r0 + m0 + 15;
    ring(H,
         [&](int h, int buf) {
           float* s = smem + buf * kStageE;
           tc::stage_tile(s, kLdA,
                          p.dy + (((long long)b * p.S + c0 + r0) * H + h) * P,
                          (long long)H * P, kSlice, kMaxP, Q - r0, P,
                          p.vec_dy != 0, tid, kThreads);
           tc::stage_tile(s + kSlice * kLdA, kLdA,
                          p.x + b * p.x_sb + h * p.x_sh + (c0 + j0) * p.x_ss,
                          p.x_ss, kSlice, kMaxP, Q - j0, P, p.vec_x != 0,
                          tid, kThreads);
           stage_cum(s + 2 * kSlice * kLdA, p.cum, b, c, h, p, tid);
           stage_dt(s + 2 * kSlice * kLdA + 2 * kMaxQ,
                    p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss, p.dt_ss,
                    Q, tid);
         },
         [&](int, int buf) {
           if (!live) return;
           const float* s = smem + buf * kStageE;
           const float* xs = s + kSlice * kLdA;
           const double* cs =
               reinterpret_cast<const double*>(s + 2 * kSlice * kLdA);
           const float* ds = s + 2 * kSlice * kLdA + 2 * kMaxQ;
           float tmp[4][4];
#pragma unroll
           for (int j = 0; j < 4; ++j)
#pragma unroll
             for (int r = 0; r < 4; ++r) tmp[j][r] = 0.f;
           for (int kk = 0; kk < P; kk += 8) {
             uint32_t ah[4], al[4];
             frag_a(ah, al, s + m0 * kLdA + kk, kLdA, 1, g, q, 1.f, 1.f);
#pragma unroll
             for (int j = 0; j < 4; ++j) {
               if (!n_on[j]) continue;
               uint32_t bh[2], bl[2];
               frag_b(bh, bl, xs + (wn0 + 8 * j) * kLdA + kk, 1, kLdA, g, q);
               mma_add(tmp[j], ah, al, bh, bl);
             }
           }
#pragma unroll
           for (int h2 = 0; h2 < 2; ++h2) {
             const int i = r0 + m0 + g + 8 * h2;
#pragma unroll
             for (int j = 0; j < 4; ++j)
#pragma unroll
               for (int e = 0; e < 2; ++e) {
                 const int jj = j0 + wn0 + 8 * j + 2 * q + e;
                 if (i < Q && jj <= i)
                   acc[0][j][2 * h2 + e] +=
                       tmp[j][2 * h2 + e] * exp_diff(cs[i], cs[jj]) * ds[jj];
               }
           }
         });
  }
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = r0 + m0 + g + 8 * h2;
    if (i >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jj = j0 + wn0 + 8 * j + 2 * q + e;
        if (jj < p.LQ) out[(long long)i * p.LQ + jj] = acc[0][j][2 * h2 + e];
      }
  }
}

// ------------------------------ f. dC and dB per (b, chunk, tile)
// dC rows i: sum_h (exp(cum_i) o dy_h) s_c^h, then dCB B; dB rows j:
// sum_h (exp(cum_Q-1 - cum_j) dt_j o x_h) G_c+1^h, then dCB^T C.  Warps
// 4 (16 rows) x 2 (32 columns of a 64-wide N tile).
// a stage: A and B slices, the head's cumsum (double), its dt
constexpr int kStageF = kSlice * kLdK + kSlice * kLdK + 3 * kMaxQ;

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dbc_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int Q = p.Q, P = p.P, N = p.N, H = p.H, nc = p.nc;
  const int RT = (Q + kSlice - 1) / kSlice, NT = (N + kSlice - 1) / kSlice;
  const int which = blockIdx.x / (RT * NT);          // 0: dC, 1: dB
  const int rt = blockIdx.x % (RT * NT) / NT, nt = blockIdx.x % NT;
  const int c = blockIdx.y, b = blockIdx.z;
  const int r0 = kSlice * rt, n0 = kSlice * nt;
  const long long c0 = (long long)c * Q, PN = (long long)P * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int m0 = 16 * (warp >> 1), wn0 = 32 * (warp & 1);
  const bool dB = which == 1;
  // the heads' part: the state entering the chunk (dC) or the gradient of
  // the one leaving it (dB)
  const int KH = (dB ? c < nc - 1 : c > 0) ? H : 0;
  const float* state =
      KH == 0 ? nullptr
      : dB ? p.gst + ((long long)b * (nc - 1) + c) * p.H * PN
           : p.st + ((long long)b * (nc - 1) + c - 1) * p.H * PN;
  const float* dcbc = p.dcb + ((long long)b * nc + c) * Q * p.LQ;
  const float* rows2 = dB ? p.Cm + b * p.c_sb + c0 * p.c_ss
                          : p.Bm + b * p.b_sb + c0 * p.b_ss;
  const long long rs2 = dB ? p.c_ss : p.b_ss;
  const bool vec2 = (dB ? p.vec_c : p.vec_b) != 0;
  bool n_on[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) n_on[j] = n0 + wn0 + 8 * j < N;
  float acc[1][4][4];
  zero(acc);
  ring(KH + RT,
       [&](int kt, int buf) {
         float* a = smem + buf * kStageF;
         float* bs = a + kSlice * kLdK;
         if (kt < KH) {
           const int h = kt;
           if (dB)
             tc::stage_tile(a, kLdA,
                            p.x + b * p.x_sb + h * p.x_sh +
                                (c0 + r0) * p.x_ss,
                            p.x_ss, kSlice, kMaxP, Q - r0, P, p.vec_x != 0,
                            tid, kThreads);
           else
             tc::stage_tile(a, kLdA,
                            p.dy +
                                (((long long)b * p.S + c0 + r0) * H + h) * P,
                            (long long)H * P, kSlice, kMaxP, Q - r0, P,
                            p.vec_dy != 0, tid, kThreads);
           tc::stage_tile(bs, kLdK, state + h * PN + n0, N, round_up(P, 8),
                          kSlice, P, N - n0, p.vec_s != 0, tid, kThreads);
           stage_cum(bs + kSlice * kLdK, p.cum, b, c, h, p, tid);
           stage_dt(bs + kSlice * kLdK + 2 * kMaxQ,
                    p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss, p.dt_ss,
                    Q, tid);
         } else {
           const int i0 = (kt - KH) * kSlice;
           if (dB)   // dCB rows i (keys), columns j of this tile
             tc::stage_tile(a, kLdK, dcbc + (long long)i0 * p.LQ + r0, p.LQ,
                            kSlice, kSlice, Q - i0, p.LQ - r0, true, tid,
                            kThreads);
           else      // dCB rows i of this tile, columns j (keys)
             tc::stage_tile(a, kLdA, dcbc + (long long)r0 * p.LQ + i0, p.LQ,
                            kSlice, kSlice, Q - r0, p.LQ - i0, true, tid,
                            kThreads);
           tc::stage_tile(bs, kLdK, rows2 + i0 * rs2 + n0, rs2, kSlice,
                          kSlice, Q - i0, N - n0, vec2, tid, kThreads);
         }
       },
       [&](int kt, int buf) {
         const float* a = smem + buf * kStageF;
         const float* bs = a + kSlice * kLdK;
         const double* cs =
             reinterpret_cast<const double*>(bs + kSlice * kLdK);
         const float* ds = bs + kSlice * kLdK + 2 * kMaxQ;
         const bool heads = kt < KH;
         // the rows' scales in the heads' part
         float s0 = 1.f, s1 = 1.f;
         if (heads) {
           const int i = r0 + m0 + g;
           auto scale = [&](int r) {
             if (r >= Q) return 0.f;
             return dB ? exp_diff(cs[Q - 1], cs[r]) * ds[r]
                       : expf((float)cs[r]);
           };
           s0 = scale(i);
           s1 = scale(i + 8);
         }
         const int kn = heads ? round_up(P, 8)
                              : round_up(min(kSlice, Q - (kt - KH) * kSlice),
                                         8);
         const int ars = heads || !dB ? kLdA : 1;
         const int aks = heads || !dB ? 1 : kLdK;
         float tmp[4][4];
#pragma unroll
         for (int j = 0; j < 4; ++j)
#pragma unroll
           for (int r = 0; r < 4; ++r) tmp[j][r] = 0.f;
         for (int kk = 0; kk < kn; kk += 8) {
           uint32_t ah[4], al[4];
           frag_a(ah, al, a + m0 * ars + kk * aks, ars, aks, g, q, s0, s1);
#pragma unroll
           for (int j = 0; j < 4; ++j) {
             if (!n_on[j]) continue;
             uint32_t bh[2], bl[2];
             frag_b(bh, bl, bs + kk * kLdK + wn0 + 8 * j, kLdK, 1, g, q);
             mma_add(tmp[j], ah, al, bh, bl);
           }
         }
#pragma unroll
         for (int j = 0; j < 4; ++j)
#pragma unroll
           for (int r = 0; r < 4; ++r) acc[0][j][r] += tmp[j][r];
       });
  float* out = (dB ? p.dB : p.dC) + ((long long)b * p.S + c0) * (long long)N;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = r0 + m0 + g + 8 * h2;
    if (r >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + wn0 + 8 * j + 2 * q + e;
        if (n < N) out[(long long)r * N + n] = acc[0][j][2 * h2 + e];
      }
  }
}

// ------------------------------ g. dA, the partials summed in order
__global__ void __launch_bounds__(kThreads)
ssd_bwd_da_kernel(const BwdParams p, int B) {
  const int h = blockIdx.x * kThreads + threadIdx.x;
  if (h >= p.H) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b)
    for (int c = 0; c < p.nc; ++c)
      s += p.dap[((long long)b * p.nc + c) * p.H + h];
  p.dA[h] = s;
}

constexpr size_t kSmemGloc =
    sizeof(float) * (kMaxQ * kLdX + kMaxQ * kLdN + 3 * kMaxQ);
constexpr size_t kSmemChunk =
    sizeof(float) * (2 * kSliceA + 2 * kSliceB + kMaxQ * kLdD +
                     7 * kMaxQ + kThreads) +
    sizeof(double) * kMaxQ;
constexpr size_t kSmemE = sizeof(float) * 2 * kStageE;
constexpr size_t kSmemF = sizeof(float) * 2 * kStageF;

}  // namespace

// Plain C entry point (bound with ctypes).  Strides are in elements, as
// for ssd_scan_f32: x [batch, seq, head], dt [batch, seq, head], B [batch,
// seq], C [batch, seq]; dy is contiguous (B, S, H, P).  Outputs dx
// (B, S, H, P), ddt (B, S, H), dA (H,), dB and dC (B, S, N), contiguous
// float32.  Scratch the caller allocates (float32): cb (B, nc, Q, LQ), st
// and gst (B, nc-1, H, P, N), decay and dap (B, nc, H), cum (B, nc, H, Q),
// dcb (B, nc, Q, LQ), with LQ = round_up(Q, 4).  Launches a to g in order
// on `stream` (b only if nc > 1, c only if nc > 2) and returns the first
// non-zero CUDA error code, or cudaErrorInvalidValue for a shape the
// kernels do not take; the wrapper raises on non-zero.
extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm,
                                const void* dy, void* dx, void* ddt,
                                void* dA, void* dB, void* dC, void* cb,
                                void* st, void* decay, void* gst, void* cum,
                                void* dcb, void* dap,
                                const long long* strides, int B, int S,
                                int H, int P, int N, int Q, void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      S % Q != 0 || S / Q > 65535 || B < 1 || B > 65535 || H < 1)
    return (int)cudaErrorInvalidValue;
  int err = ssd_scan_states_f32(x, dt, A, Bm, Cm, cb, st, decay, strides, B,
                                S, H, P, N, Q, stream);
  if (err) return err;
  BwdParams p;
  p.x = static_cast<const float*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = static_cast<const float*>(Bm);
  p.Cm = static_cast<const float*>(Cm);
  p.dy = static_cast<const float*>(dy);
  p.dx = static_cast<float*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.dA = static_cast<float*>(dA);
  p.dB = static_cast<float*>(dB);
  p.dC = static_cast<float*>(dC);
  p.cb = static_cast<const float*>(cb);
  p.st = static_cast<const float*>(st);
  p.decay = static_cast<const float*>(decay);
  p.gst = static_cast<float*>(gst);
  p.cum = static_cast<double*>(cum);
  p.dcb = static_cast<float*>(dcb);
  p.dap = static_cast<float*>(dap);
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
  p.vec_s = aligned16(st) && aligned16(gst) && N % 4 == 0;
  p.vec_dy = aligned16(dy) && P % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p.nc > 1) {
    err = launch(ssd_bwd_gloc_kernel, dim3(H, p.nc - 1, B), kSmemGloc, s, p);
    if (err) return err;
  }
  if (p.nc > 2) {
    const long long per = (long long)H * P * N;
    err = launch(ssd_bwd_state_pass_kernel,
                 dim3((unsigned)((per + kThreads - 1) / kThreads), B), 0, s,
                 p);
    if (err) return err;
  }
  err = launch(ssd_bwd_chunk_kernel, dim3(H, p.nc, B), kSmemChunk, s, p);
  if (err) return err;
  const int RT = (Q + kSlice - 1) / kSlice, NT = (N + kSlice - 1) / kSlice;
  err = launch(ssd_bwd_dcb_kernel, dim3(RT * RT, p.nc, B), kSmemE, s, p);
  if (err) return err;
  err = launch(ssd_bwd_dbc_kernel, dim3(2 * RT * NT, p.nc, B), kSmemF, s, p);
  if (err) return err;
  ssd_bwd_da_kernel<<<(H + kThreads - 1) / kThreads, kThreads, 0, s>>>(p,
                                                                       B);
  return (int)cudaGetLastError();
}
