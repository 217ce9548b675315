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
// TFLOP/s): bound by operations, 0.223 ms.  This design forms dy x^T once
// per (chunk, head) (launch d) and runs dCB's products once per head
// group (launch f), 37.1 GFLOP in all at that layer with three groups.
// chip_smoke.py's check_ssd_bwd counts both from the shapes.
//
// Design, launches in stream order:
//  a. ssd_scan_states_f32 (ssd_scan.cu, its launches 2 and 3): the
//     states entering chunks 1..nc-1 and exp(cum_Q-1), recomputed, so
//     autograd keeps only the five operands;
//  a2. ssd_bwd_cb, per (32-row tile, chunk, b): C B^T, each element
//     summed over N in double and rounded once, in place of the
//     forward's 3xTF32 one: the scores' float32 error set most of dA's
//     (3.1x the plain loop's on one card test input, 0.9x with this);
//     bound by double fma and its loads;
//  b. ssd_bwd_gloc, one block per (b, chunk >= 1, h): (exp(cum) o dy)^T C,
//     P x N over K = Q, into the G scratch (B, nc-1, H, P, N);
//  c. ssd_bwd_state_pass, one thread per (b, h, p, n): G_c = that +
//     exp(cum_Q-1) G_c+1 in place, last chunk to first (the mirror of the
//     forward's state pass); bound by bytes;
//  d. ssd_bwd_chunk, one block per (b, chunk, h), two blocks (16 warps) an
//     SM: 110 KB of shared memory, at most 128 registers a thread.  dy is
//     staged once as a Q x P tile and x once after the state products, and
//     a third tile's room W holds in turn a CB slice ring and a Q x 64
//     column half of CB; the state products' ring spans W and x's room.
//     1. C s_c^T over N in 32-key slices, its row dots with dy (from shared
//        memory) give exp(cum_i) dy_i . (s_c C_i);
//     2. B G_c+1^T the same way, each row j scaled by exp(cum_Q-1 - cum_j)
//        and kept in registers as acc; <s_c, G_c+1> is read while its
//        first slice lands;
//     3. x staged with the first CB slice; acc's row dots with x (the
//        state writes); acc += (CB o L)^T dy over 32-row CB slices, each
//        rewritten in place into CB_ij L_ij (masked first) as it lands;
//        dx = dt o acc written once, acc's row dots with x;
//     4. per 64-column half of D: CB's half staged into W, dy x^T over
//        K = P; the head's part of dCB, (dy x^T) o L o dt_j, written to
//        the (B, nc, H, Q, LQ) scratch for launch e, and D = that o CB
//        over CB in place; each row's exclusive prefix by a warp scan (a
//        warp per 16 rows, the row's sum so far carried from the left
//        half); then every column's sum over the rows at and below it,
//        four 32-row groups at a time;
//     5. the suffix sums of the inter-chunk terms and the prefix sums of
//        the state writes by two warps' scans; dda, ddt; dA's partial by a
//        warp's tree;
//     it writes dx, ddt, the chunk's cumsum (double) for launch f, the
//     heads' parts of dCB and a (B, nc, H) partial of dA;
//  e. ssd_bwd_dcb, four columns of a chunk's Q x Q plane a thread, per
//     (head group, chunk, b): dCB = the group's heads' parts from launch d
//     added in head order, zero above the diagonal, into the group's slice
//     of the (NG, B, nc, Q, LQ) scratch; bound by bytes;
//  f. ssd_bwd_dbc, one block per (head group, dB or dC, 64-wide N tile,
//     chunk, b), every row of the chunk, two blocks an SM: the group's
//     heads' products (K = P each, the rows scaled by exp(cum_i) or
//     exp(cum_Q-1 - cum_j) dt_j as their fragments are split) then its
//     dCB's (K = 64 slices of Q), every 8-key step added to acc in order;
//     one group writes dB and dC, more write their partials (NG, 2, B, S,
//     N);
//  g. ssd_bwd_sums: dA_h = the partials summed over b, then chunks, in
//     order; dB and dC = the groups' partials in group order.
// The head groups (HG heads each, NG = ceil(H / HG) of them; the wrapper
// picks HG from the shape but not the batch, so that launch f has at least
// two waves of blocks) fill the card at B = 1: at mamba2-2.7b's layer three
// groups give launch e 1,536 blocks and launch f 384.  Launches d and f
// are bound by their products (mma.sync's instruction rate) and copies;
// a2, b and c as before; e and g by bytes.  The products' loops hold no
// branch between a warp's mma.sync: a key range is cut where a row tile
// starts or stops, each piece runs the tiles active in it, and column
// tiles past the data are computed into accumulators never stored.
// Every other product is 3xTF32 mma.sync on fragments split in registers
// (tf32x3.cuh), each 8-deep key step summed in a zeroed fragment and added
// in fp32 (mma_add); every exp(cum_i - cum_j) is taken from the chunk's
// cumsum summed in double (ssd_common.cuh).  Slices are staged through
// 2-stage cp.async rings with zero fill; ragged Q, P and N are masked on
// store; nothing is read past S.
//
// Determinism: one fixed order for every sum (no split-K, no atomics):
//  - a product's keys in slice order, 8 at a time (mma_add); a2's C B^T
//    over N in order from zero, by double fma;
//  - a row dot: a thread's 8 columns in order, then its quad's xor tree,
//    then the two 32-column halves;
//  - <s_c, G_c+1>: each thread's elements tid, tid + 256, ... in order
//    (fmaf), the warp's xor tree, then the 8 warps in order from zero;
//  - D's row prefix: per half, lane l's pair (v0, v1), the lanes' v0 + v1
//    scanned inclusively (shifts 1, 2, 4, 8, 16), the exclusive value
//    base = carry + (lane l-1's inclusive sum), then base and base + v0;
//    the carry + the last lane's sum carried to the next half;
//  - a column's crossing sum: rows in order inside each group of 32 rows,
//    then the four groups in order;
//  - the suffix (prefix) sums: 4 entries a lane from the right (left),
//    the lanes' totals scanned as above, then entry + exclusive lanes'
//    sum (exclusive lanes' sum + entries before it);
//  - dda = ((cross + later) + written) + decay <s, G>; dA's partial: a
//    lane's 4 products in order, then the warp's xor tree (16 .. 1);
//  - dCB per group: each head's part (its dy x^T from zero, 8 keys at a
//    time, times L_ij then dt_j) added in head order from zero;
//  - dB, dC per group: the heads' 8-key steps in head order from zero,
//    then the group's dCB slices'; the groups' partials added in group
//    order from zero; dA over b, then chunks.
// dx, ddt, dB and dC of row b read only row b's inputs and scratch; dA sums
// over the batch.
#include "ssd_common.cuh"

extern "C" int ssd_scan_states_f32(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* Cm, void* st, void* decay,
                                   const long long* strides, int B, int S,
                                   int H, int P, int N, int Q,
                                   void* stream);

namespace {

using tc::split;

constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlice = 64;          // K slice of launches e and f
// Row strides (floats) of staged tiles.  An operand whose fragment is read
// at (row g, column t) has a stride of 4 (mod 32), one read at (row t,
// column g) a stride of 8 (mod 32).
constexpr int kLdA = kSlice + 4;    // rows read by (row, key)
constexpr int kLdK = kSlice + 8;    // rows indexed by key
constexpr int kLdX = kMaxP + 8;     // dy rows, keys by P (launch b)
constexpr int kLdN = kMaxN + 8;     // C rows, keys by N (launch b)
constexpr int kAhead = 8;           // gradient loads in flight in launch c
// launch d
constexpr int kLdR = kMaxP + 4;     // dy and x (Q x P), a CB column half
constexpr int kTileR = kMaxQ * kLdR;
constexpr int kSliceS = 32;         // K slice of C s^T and B G^T
constexpr int kLdS = kSliceS + 4;
constexpr int kStageS = (kMaxQ + kMaxP) * kLdS;      // rows, then state
constexpr int kRowsT = 32;          // CB rows a step of (CB o L)^T dy
constexpr int kLdT = kMaxQ + 8;     // a CB slice read transposed
constexpr int kStageT = kRowsT * kLdT;
constexpr int kHalf = 64;           // D's columns at a time
static_assert(2 * kStageT == kTileR, "the CB ring fills W");
static_assert(2 * kStageS <= 2 * kTileR, "the state ring fits W and x");
static_assert(kHalf + 4 == kLdR, "a CB column half fills W");
static_assert(kThreads == 4 * kHalf && kMaxQ == 4 * 32 && kWarps * 16 ==
              kMaxQ, "launch d's row and column passes");

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
  float* cb;           // (B, nc, Q, LQ) C B^T, zero above the diagonal
  const float* st;     // (B, nc-1, H, P, N) the state entering chunk c+1
  const float* decay;  // (B, nc, H) exp(cum_Q-1), chunks 0..nc-2
  float* gst;          // (B, nc-1, H, P, N) G_c+1 (launch b: local part)
  double* cum;         // (B, nc, H, Q) the chunk's cumsum, in double
  float* xcb;          // (B, nc, H, Q, LQ) each head's part of dCB
  float* dcbp;         // (NG, B, nc, Q, LQ) dCB summed over a head group
  float* part;         // (NG, 2, B, S, N) dC and dB by group (NG > 1)
  float* dap;          // (B, nc, H) dA's partials
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  int B, S, H, P, N, Q, nc, LQ;
  int HG, NG;          // heads a group, groups
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

// A 2-stage cp.async ring over KT K slices whose slice 0 is started and
// committed: use(kt, kt & 1) consumes slice kt while stage(kt + 1, buf)
// starts the next into the other buffer.  Every thread runs it; it ends
// with the copies drained.
template <typename Stage, typename Use>
__device__ __forceinline__ void ring_run(int KT, Stage stage, Use use) {
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

// The same ring, slice 0 started first.
template <typename Stage, typename Use>
__device__ __forceinline__ void ring(int KT, Stage stage, Use use) {
  if (KT > 0) stage(0, 0);
  tc::cp_async_commit();
  ring_run(KT, stage, use);
}

// Stage a rows x COLS tile of src (row stride ld floats; rows >= nr or
// columns >= nc read 0) into dst (row stride lds), as tc::stage_tile does,
// but with a thread's copies all on one column, rows kThreads / (COLS / 4)
// apart: its addresses take two registers, not one pair a copy.  vec:
// 16-byte copies (rows 16-byte aligned, nc a multiple of 4).  The caller
// commits and waits.
template <int COLS>
__device__ __forceinline__ void stage(float* dst, int lds, const float* src,
                                      long long ld, int rows, int nr, int nc,
                                      bool vec, int tid) {
  static_assert(COLS % 4 == 0 && kThreads % COLS == 0, "whole rows a pass");
  if (vec) {
    constexpr int cpr = COLS / 4;
    const int cc = tid % cpr * 4;
    for (int r = tid / cpr; r < rows; r += kThreads / cpr) {
      const bool in = r < nr && cc < nc;
      tc::cp_async16(dst + r * lds + cc, in ? src + r * ld + cc : src,
                     in ? 16 : 0);
    }
  } else {
    const int cc = tid % COLS;
    for (int r = tid / COLS; r < rows; r += kThreads / COLS) {
      const bool in = r < nr && cc < nc;
      tc::cp_async4(dst + r * lds + cc, in ? src + r * ld + cc : src,
                    in ? 4 : 0);
    }
  }
}

// threadIdx.x read afresh: an index the compiler cannot carry over from
// earlier code in a register
__device__ __forceinline__ int tid_now() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// The warp's inclusive sums in lane order: shifts 1, 2, 4, 8, 16
__device__ __forceinline__ float warp_incl(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The same from the last lane down: lane l gets the sum of lanes >= l
__device__ __forceinline__ float warp_incl_rev(float v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_down_sync(kFull, v, o);
    if (lane + o < 32) v += u;
  }
  return v;
}

// The warp's sum in every lane, by an xor tree (16, 8, 4, 2, 1)
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Set a launch's dynamic shared memory and ask for the largest shared
// carveout, so that blocks of launches d, e and f fit two an SM.
template <typename K>
int prepare(K kern, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  return (int)err;
}

// ------------------------------- launch d's Q x 64 output tile
// Warp w owns the 16-row tiles w/2 and 7 - w/2 (one from each end of a
// causal triangle) and the 32 columns from 32 (w % 2).
struct Tile {
  int mt[2];
  int MT;       // 16-row tiles holding rows < Q
  int wn0;
};

// acc[I..J] += A B over the keys [k0, k1) (multiples of 8) for row tiles
// I to J: A (r, k) at a[r * ars + k * aks], the rows g and g + 8 of row
// tile i scaled by sc[i][0] and sc[i][1]; B (k, n) at b[k * bks + n *
// bns].  Every column tile is computed: those past the data land in
// accumulators the callers never store, and no branch sits between the
// warp's mma.sync.
template <int I, int J>
__device__ __forceinline__ void mma_span(float (&acc)[2][4][4],
                                         const float* a, int ars, int aks,
                                         const float* b, int bks, int bns,
                                         int k0, int k1, const Tile& t,
                                         int g, int q,
                                         const float (&sc)[2][2]) {
#pragma unroll 1
  for (int kk = k0; kk < k1; kk += 8) {
    uint32_t ah[J - I + 1][4], al[J - I + 1][4];
#pragma unroll
    for (int i = I; i <= J; ++i)
      frag_a(ah[i - I], al[i - I], a + 16 * t.mt[i] * ars + kk * aks, ars,
             aks, g, q, sc[i][0], sc[i][1]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t bh[2], bl[2];
      frag_b(bh, bl, b + kk * bks + (t.wn0 + 8 * j) * bns, bks, bns, g, q);
#pragma unroll
      for (int i = I; i <= J; ++i)
        mma_add(acc[i][j], ah[i - I], al[i - I], bh, bl);
    }
  }
}

// acc += A B over kn keys (a multiple of 8, zero-filled past the data):
// row tile i over the keys [lo, hi) that keys(mt[i], lo, hi) narrows from
// [0, kn) (multiples of 8, the ends not falling with the tile's rows; row
// tiles past Q take none).  The range is cut where a tile starts or stops,
// and each piece runs one branch-free loop over the tiles active in it.
template <typename Keys>
__device__ __forceinline__ void mma_rows(float (&acc)[2][4][4],
                                         const float* a, int ars, int aks,
                                         const float* b, int bks, int bns,
                                         int kn, const Tile& t, int g, int q,
                                         Keys keys,
                                         const float (&sc)[2][2]) {
  if (Keys::kWhole) {                      // a tile takes every key or none
    int lo = 0, hi = kn;
    keys(t.mt[0], lo, hi);
    const bool on0 = t.mt[0] < t.MT && lo < hi;
    lo = 0;
    hi = kn;
    keys(t.mt[1], lo, hi);
    const bool on1 = t.mt[1] < t.MT && lo < hi;
    if (on0 && on1)
      mma_span<0, 1>(acc, a, ars, aks, b, bks, bns, 0, kn, t, g, q, sc);
    else if (on0)
      mma_span<0, 0>(acc, a, ars, aks, b, bks, bns, 0, kn, t, g, q, sc);
    else if (on1)
      mma_span<1, 1>(acc, a, ars, aks, b, bks, bns, 0, kn, t, g, q, sc);
    return;
  }
  int lo0 = 0, hi0 = t.mt[0] < t.MT ? kn : 0;
  int lo1 = 0, hi1 = t.mt[1] < t.MT ? kn : 0;
  if (hi0 > 0) keys(t.mt[0], lo0, hi0);
  if (hi1 > 0) keys(t.mt[1], lo1, hi1);
  lo0 = max(lo0, 0);
  hi0 = min(hi0, kn);
  lo1 = max(lo1, 0);
  hi1 = min(hi1, kn);
  if (hi1 <= lo1) {                        // tile 1 takes nothing
    if (lo0 < hi0)
      mma_span<0, 0>(acc, a, ars, aks, b, bks, bns, lo0, hi0, t, g, q, sc);
    return;
  }
  if (hi0 <= lo0) {
    mma_span<1, 1>(acc, a, ars, aks, b, bks, bns, lo1, hi1, t, g, q, sc);
    return;
  }
  // both: tile 1's rows lie below tile 0's, so lo0 <= lo1 and hi0 <= hi1
  const int m0 = min(hi0, lo1), m1 = max(hi0, lo1);
  if (lo0 < m0)
    mma_span<0, 0>(acc, a, ars, aks, b, bks, bns, lo0, m0, t, g, q, sc);
  if (lo1 < hi0)
    mma_span<0, 1>(acc, a, ars, aks, b, bks, bns, lo1, hi0, t, g, q, sc);
  if (m1 < hi1)
    mma_span<1, 1>(acc, a, ars, aks, b, bks, bns, m1, hi1, t, g, q, sc);
}

// The same, unscaled
template <typename Keys>
__device__ __forceinline__ void mma_rows(float (&acc)[2][4][4],
                                         const float* a, int ars, int aks,
                                         const float* b, int bks, int bns,
                                         int kn, const Tile& t, int g, int q,
                                         Keys keys) {
  const float one[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
  mma_rows(acc, a, ars, aks, b, bks, bns, kn, t, g, q, keys, one);
}

// Key ranges: every key; keys from row tile m's first row on (a product
// whose key k pairs with rows <= k); keys up to its last row; none where
// the tile's rows are all above column j0
struct AllKeys {
  static constexpr bool kWhole = true;
  __device__ void operator()(int, int&, int&) const {}
};
struct KeysFrom {
  static constexpr bool kWhole = false;
  int k_first;
  __device__ void operator()(int m, int& lo, int&) const {
    lo = 16 * m - k_first;
  }
};
struct KeysTo {
  static constexpr bool kWhole = false;
  int k_first;
  __device__ void operator()(int m, int&, int& hi) const {
    hi = 16 * m + 16 - k_first;
  }
};
struct Below {
  static constexpr bool kWhole = true;
  int j0;
  __device__ void operator()(int m, int& lo, int& hi) const {
    if (16 * m + 15 < j0) lo = hi = 0;
  }
};
__device__ __forceinline__ KeysFrom keys_from(int k) { return {k}; }
__device__ __forceinline__ KeysTo keys_to(int k) { return {k}; }
__device__ __forceinline__ Below below(int j0) { return {j0}; }

// red[half * kMaxQ + row] = the dot product of acc's row (the warp's 32
// columns) with row `row` of v (a shared tile, row r at v + r * vs), for
// rows < Q; half = the warp's column half.  The caller syncs and adds the
// two halves.
__device__ __forceinline__ void row_dots(const float (&acc)[2][4][4],
                                         const float* v, int vs,
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
      s += __shfl_xor_sync(kFull, s, 1);
      s += __shfl_xor_sync(kFull, s, 2);
      if (on && q == 0) red[half * kMaxQ + row] = s;
    }
}

// ------------------------------ a2. C B^T per chunk, summed in double
// Over (32-row tile, chunk, b): each element j <= i summed over N by
// double fma from zero and rounded once, zero above the diagonal (the
// forward takes it from 3xTF32 products).  The scores' float32 error is
// what most of dA's error came from (the decomposition emulated with one
// product exact at a time: C B^T took dA's error from 3.1x the plain
// loop's to 0.9x).
constexpr int kCbRows = 32;
constexpr int kLdCb = kMaxN + 1;

__global__ void __launch_bounds__(kThreads)
ssd_bwd_cb_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  // the chunk's B and the tile's C rows, converted to double once
  double* Bs = reinterpret_cast<double*>(smem);     // [kMaxQ][kLdCb]
  double* Cs = Bs + kMaxQ * kLdCb;                   // [kCbRows][kLdCb]
  const int i0 = kCbRows * blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int Q = p.Q, N = p.N, LQ = p.LQ, tid = threadIdx.x;
  const long long c0 = (long long)c * Q;
  static_assert(kThreads == 8 * kCbRows && kMaxQ == 4 * 32,
                "4 x 4 sums a thread");
  // loads unrolled so that many are in flight: the staging is latency-bound
#pragma unroll 16
  for (int e = tid; e < kMaxQ * N; e += kThreads) {   // rows past Q: 0
    const int r = e / N, n = e % N;
    Bs[r * kLdCb + n] =
        r < Q ? (double)p.Bm[b * p.b_sb + (c0 + r) * p.b_ss + n] : 0.0;
  }
#pragma unroll 16
  for (int e = tid; e < kCbRows * N; e += kThreads) {
    const int r = e / N, n = e % N;
    Cs[r * kLdCb + n] =
        i0 + r < Q ? (double)p.Cm[b * p.c_sb + (c0 + i0 + r) * p.c_ss + n]
                   : 0.0;
  }
  __syncthreads();
  // thread t: rows i0 + 4 (t / 32) + u and columns t % 32 + 32 v (u, v
  // < 4), sixteen independent sums over n, each B and C value read once
  // for four of them
  const int r0 = 4 * (tid / 32), jc = tid % 32;
  double acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.0;
  for (int n = 0; n < N; ++n) {
    double cv[4], bv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) cv[u] = Cs[(r0 + u) * kLdCb + n];
#pragma unroll
    for (int v = 0; v < 4; ++v) bv[v] = Bs[(jc + 32 * v) * kLdCb + n];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[u][v] = fma(cv[u], bv[v], acc[u][v]);
  }
  float* out = p.cb + (((long long)b * p.nc + c) * Q + i0) * LQ;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + r0 + u;
    if (i >= Q) break;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = jc + 32 * v;
      if (j < LQ) out[(r0 + u) * LQ + j] = j <= i ? (float)acc[u][v] : 0.f;
    }
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
  stage<kMaxP>(dys, kLdX, p.dy + (((long long)b * p.S + c0) * H + h) * P,
               (long long)H * P, round_up(Q, 8), Q, P, p.vec_dy != 0, tid);
  stage<kMaxN>(Cs, kLdN, p.Cm + b * p.c_sb + c0 * p.c_ss, p.c_ss,
               round_up(Q, 8), Q, N, p.vec_c != 0, tid);
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
  // every tile of the warp is computed (those past P or N land in
  // accumulators never stored), no branch between its mma.sync
  float acc[2][4][4];
  zero(acc);
  for (int kk = 0; kk < Q; kk += 8) {
    const float w0 = es[kk + q], w1 = es[kk + q + 4];
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      frag_b(bh[j], bl[j], Cs + kk * kLdN + wn0 + 8 * j, kLdN, 1, g, q);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // A (p, key) = exp(cum_key) dy[key][p]: the scale follows the key
      const float* a = dys + (kk + q) * kLdX + wm0 + 16 * i + g;
      uint32_t ah[4], al[4];
      split(a[0] * w0, ah[0], al[0]);
      split(a[8] * w0, ah[1], al[1]);
      split(a[4 * kLdX] * w1, ah[2], al[2]);
      split(a[4 * kLdX + 8] * w1, ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_add(acc[i][j], ah, al, bh[j], bl[j]);
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

// Stage launch d's C s^T or B G^T K slice kt into dst: rows (Q x 32 keys
// of N, row stride rs) then the state's (P x 32).
__device__ __forceinline__ void stage_state(float* dst, const float* rows,
                                            long long rs, bool vrows,
                                            const float* state, bool vstate,
                                            int kt, int MT, int Q, int P,
                                            int N, int tid) {
  const int n0 = kt * kSliceS;
  stage<kSliceS>(dst, kLdS, rows + n0, rs, MT * 16, Q, N - n0, vrows, tid);
  stage<kSliceS>(dst + kMaxQ * kLdS, kLdS, state + n0, N, round_up(P, 8), P,
                 N - n0, vstate, tid);
}

// ------------------------------ d. per (b, chunk, h)
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_chunk_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  float* dys = smem;                        // [kMaxQ][kLdR] dy
  float* W = dys + kTileR;                  // CB slices, then D
  float* xs = W + kTileR;                   // [kMaxQ][kLdR] x, from step 3
  double* cumd = reinterpret_cast<double*>(xs + kTileR);   // [kMaxQ]
  float* dts = reinterpret_cast<float*>(cumd + kMaxQ);     // [kMaxQ]
  float* cums = dts + kMaxQ;
  float* inter = cums + kMaxQ;      // exp(cum_i) dy_i . (s_c C_i)
  float* us = inter + kMaxQ;        // x_j . dx's state part / dt_j
  float* uu = us + kMaxQ;           // x_j . dx / dt_j
  float* later = uu + kMaxQ;        // sum_{i>=k} inter_i
  float* written = later + kMaxQ;   // sum_{j<k} dt_j us_j
  float* cross = written + kMaxQ;   // sum_{i>=k, j<k} D_ij
  float* rsum = cross + kMaxQ;      // D's row sums over the halves done
  float* red = rsum + kMaxQ;        // [2][kMaxQ]
  float* cpart = red + 2 * kMaxQ;   // [4][kHalf] column sums by row group
  float* gpart = cpart + 4 * kHalf; // [kWarps] <s_c, G_c+1> by warp
  // the block's (chunk, head, row) read back from shared memory where an
  // address needs them, so they hold no register through the products
  __shared__ int coord[3];
  if (threadIdx.x == 0) {
    coord[0] = blockIdx.x;
    coord[1] = blockIdx.y;
    coord[2] = blockIdx.z;
  }
  __syncthreads();
  const volatile int& c = coord[0];
  const volatile int& h = coord[1];
  const volatile int& b = coord[2];
  const int Q = p.Q, P = p.P, N = p.N, H = p.H, nc = p.nc;
  const int c0 = c * Q, PN = P * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4, half = warp & 1;
  Tile t;
  t.mt[0] = warp >> 1;
  t.mt[1] = kMaxQ / 16 - 1 - (warp >> 1);
  t.MT = (Q + 15) / 16;
  t.wn0 = 32 * half;
  const bool has_s = c > 0, has_g = c < nc - 1;
  const int dy_rs = H * P;
  auto row0 = [&]() { return ((long long)b * p.S + c0) * H + h; };  // dy, dx
  auto s_c = [&]() {
    return p.st + (((long long)b * (nc - 1) + c - 1) * H + h) * PN;
  };
  auto g_n = [&]() {
    return p.gst + (((long long)b * (nc - 1) + c) * H + h) * PN;
  };
  auto cbc = [&]() { return p.cb + ((long long)b * nc + c) * Q * p.LQ; };

  stage_dt(dts, p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss, p.dt_ss, Q,
           tid);
  tc::cp_async_commit();
  stage<kMaxP>(dys, kLdR, p.dy + row0() * P, dy_rs, t.MT * 16, Q, P,
               p.vec_dy != 0, tid);
  tc::cp_async_commit();
  for (int i = tid; i < kMaxQ; i += kThreads) inter[i] = us[i] = rsum[i] = 0.f;
  tc::cp_async_wait<1>();           // dt landed; dy may be in flight
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, cums, p.A[h], Q, lane, cumd);
  __syncthreads();
  for (int j = tid; j < Q; j += kThreads)
    p.cum[(((long long)b * nc + c) * H + h) * Q + j] = cumd[j];

  float acc[2][4][4];
  const int KTs = (N + kSliceS - 1) / kSliceS;
  auto use_state = [&](int kt, int buf) {
    const float* s = W + buf * kStageS;
    mma_rows(acc, s, kLdS, 1, s + kMaxQ * kLdS, 1, kLdS,
             round_up(min(kSliceS, N - kt * kSliceS), 8), t, g, q, AllKeys());
  };
  auto add_halves = [&](float* out, bool by_exp) {
    __syncthreads();
    for (int i = tid; i < Q; i += kThreads) {
      const float v = red[i] + red[kMaxQ + i];
      out[i] = by_exp ? v * expf(cums[i]) : v;
    }
    __syncthreads();
  };

  // 1. the inter-chunk term's row dots: exp(cum_i) dy_i . (s_c C_i)
  if (has_s) {
    const float* Cc = p.Cm + b * p.c_sb + c0 * p.c_ss;
    zero(acc);
    ring(KTs,
         [&](int kt, int buf) {
           stage_state(W + buf * kStageS, Cc, p.c_ss, p.vec_c != 0, s_c(),
                       p.vec_s != 0, kt, t.MT, Q, P, N, tid);
         },
         use_state);
    row_dots(acc, dys, kLdR, t, P, Q, g, q, half, red);
    add_halves(inter, true);
  }
  // 2. dx's state part: exp(cum_Q-1 - cum_j) (G_c+1 B_j), kept in acc
  if (has_g) {
    const float* Bc = p.Bm + b * p.b_sb + c0 * p.b_ss;
    auto stage = [&](int kt, int buf) {
      stage_state(W + buf * kStageS, Bc, p.b_ss, p.vec_b != 0, g_n(),
                  p.vec_s != 0, kt, t.MT, Q, P, N, tid);
    };
    zero(acc);
    stage(0, 0);
    tc::cp_async_commit();
    if (has_s) {        // <s_c, G_c+1> while the first slice lands
      float s = 0.f;
      const float* sp = s_c();
      const float* gp = g_n();
#pragma unroll 8
      for (long long e = tid; e < PN; e += kThreads)
        s = fmaf(sp[e], gp[e], s);
      s = warp_sum(s);
      if (lane == 0) gpart[warp] = s;
    }
    ring_run(KTs, stage, use_state);
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
  } else {
    zero(acc);
  }
  // 3. x staged with the first CB slice; the state part's row dots with x;
  //    then acc += (CB o L)^T dy over K = Q, a CB slice of 32 rows i staged
  //    as it is and read transposed, each rewritten in place into CB_ij
  //    L_ij (masked first) as it lands
  auto stage_cb = [&](int kt, int buf) {
    const int i0 = kt * kRowsT;
    stage<kMaxQ>(W + buf * kStageT, kLdT, cbc() + (long long)i0 * p.LQ, p.LQ,
                 kRowsT, Q - i0, p.LQ, true, tid);
  };
  auto use_cb = [&](int kt, int buf) {
    const int i0 = kt * kRowsT;
    float* a = W + buf * kStageT;
    for (int e = tid; e < kRowsT * (kMaxQ / 4); e += kThreads) {
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
    mma_rows(acc, a, 1, kLdT, dys + i0 * kLdR, kLdR, 1,
             round_up(min(kRowsT, Q - i0), 8), t, g, q, keys_from(i0));
  };
  stage_cb(0, 0);
  stage<kMaxP>(xs, kLdR, p.x + b * p.x_sb + h * p.x_sh + c0 * p.x_ss, p.x_ss,
               t.MT * 16, Q, P, p.vec_x != 0, tid);
  tc::cp_async_commit();
  if (has_g) {
    tc::cp_async_wait<0>();
    __syncthreads();
    row_dots(acc, xs, kLdR, t, P, Q, g, q, half, red);
    add_halves(us, false);
  }
  ring_run((Q + kRowsT - 1) / kRowsT, stage_cb, use_cb);
  // dx = dt o acc, written once
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int row = 16 * t.mt[i] + g + 8 * h2;
      if (t.mt[i] >= t.MT || row >= Q) continue;
      float* d = p.dx + (row0() + (long long)row * H) * P;
      const float w = dts[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t.wn0 + 8 * j + 2 * q;
        const float v0 = w * acc[i][j][2 * h2], v1 = w * acc[i][j][2 * h2 + 1];
        if ((P & 1) == 0) {
          if (col < P)
            *reinterpret_cast<float2*>(d + col) = make_float2(v0, v1);
        } else {
          if (col < P) d[col] = v0;
          if (col + 1 < P) d[col + 1] = v1;
        }
      }
    }
  row_dots(acc, xs, kLdR, t, P, Q, g, q, half, red);
  add_halves(uu, false);

  // 4. D = (dy x^T) o CB o L o dt_j, 64 columns at a time, over CB's half
  //    in W; then each row's exclusive prefix and each column's sum below
  //    the diagonal (the crossing sums)
  for (int j0 = 0; j0 < Q; j0 += kHalf) {
    stage<kHalf>(W, kLdR, cbc() + j0, p.LQ, t.MT * 16, Q, p.LQ - j0, true,
                 tid);
    tc::cp_async_commit();
    tc::cp_async_wait<0>();
    __syncthreads();
    zero(acc);
    mma_rows(acc, dys, kLdR, 1, xs + j0 * kLdR, 1, kLdR, round_up(P, 8), t,
             g, q, below(j0));
    // the head's part of dCB, (dy_i . x_j) L_ij dt_j, to launch e; D = that
    // o CB over CB in place
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int row = 16 * t.mt[i] + g + 8 * h2;
        if (t.mt[i] >= t.MT || row >= Q || 16 * t.mt[i] + 15 < j0) continue;
        const double cr = cumd[row];
        float* xr = p.xcb +
                    ((((long long)b * nc + c) * H + h) * Q + row) * p.LQ;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = j0 + t.wn0 + 8 * j + 2 * q;
          if (col >= Q) continue;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = col + e;
            v[e] = cc <= row ? acc[i][j][2 * h2 + e] * exp_diff(cr, cumd[cc]) *
                                   dts[cc]
                             : 0.f;
            float* d = W + row * kLdR + (cc - j0);
            if (cc < Q) *d = v[e] * *d;
          }
          *reinterpret_cast<float2*>(xr + col) = make_float2(v[0], v[1]);
        }
      }
    __syncthreads();
    // a warp per 16 rows: the row's exclusive prefix over the half, the
    // row's sum so far carried in rsum
#pragma unroll 1
    for (int r = 0; r < 16; ++r) {
      const int i = 16 * warp + r;
      if (i < j0 || i >= Q) continue;
      float2* pr = reinterpret_cast<float2*>(W + i * kLdR) + lane;
      const float2 v = *pr;
      const float carry = rsum[i];
      const float incl = warp_incl(v.x + v.y, lane);
      float ex = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) ex = 0.f;
      const float base = carry + ex;
      *pr = make_float2(base, base + v.x);
      const float tot = __shfl_sync(kFull, incl, 31);
      __syncwarp();
      if (lane == 0) rsum[i] = carry + tot;
    }
    __syncthreads();
    // column k's sum over rows i >= k: four groups of 32 rows, then the
    // groups in order
    {
      const int kl = tid % kHalf, grp = tid / kHalf, k = j0 + kl;
      float s = 0.f;
      if (k < Q) {
        const int hi = min(32 * grp + 32, Q);
        for (int i = max(32 * grp, k); i < hi; ++i) s += W[i * kLdR + kl];
      }
      cpart[grp * kHalf + kl] = s;
    }
    __syncthreads();
    if (tid < kHalf && j0 + tid < Q)
      cross[j0 + tid] = ((cpart[tid] + cpart[kHalf + tid]) +
                         cpart[2 * kHalf + tid]) + cpart[3 * kHalf + tid];
  }
  // 5. sum_{i>=k} inter_i (warp 0) and sum_{j<k} dt_j us_j (warp 1), four
  //    entries a lane
  if (warp == 0) {
    const float* v = inter + 4 * lane;
    const float t3 = v[3], t2 = v[2] + t3, t1 = v[1] + t2, t0 = v[0] + t1;
    const float incl = warp_incl_rev(t0, lane);
    float ex = __shfl_down_sync(kFull, incl, 1);
    if (lane == 31) ex = 0.f;
    float* o = later + 4 * lane;
    o[0] = t0 + ex;
    o[1] = t1 + ex;
    o[2] = t2 + ex;
    o[3] = t3 + ex;
  } else if (warp == 1) {
    const int j = 4 * lane;
    const float p0 = dts[j] * us[j];
    const float p1 = p0 + dts[j + 1] * us[j + 1];
    const float p2 = p1 + dts[j + 2] * us[j + 2];
    const float p3 = p2 + dts[j + 3] * us[j + 3];
    const float incl = warp_incl(p3, lane);
    float ex = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) ex = 0.f;
    float* o = written + j;
    o[0] = ex;
    o[1] = ex + p0;
    o[2] = ex + p1;
    o[3] = ex + p2;
  }
  __syncthreads();
  float gsd = 0.f;
  if (has_s && has_g) {
    float tot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) tot += gpart[w];
    gsd = p.decay[((long long)b * nc + c) * H + h] * tot;
  }
  // dda_k, ddt_k and dt_k dda_k
  const int k = tid_now();
  if (k < kMaxQ) {
    float v = 0.f;
    if (k < Q) {
      const float dda = ((cross[k] + later[k]) + written[k]) + gsd;
      p.ddt[((long long)b * p.S + c0 + k) * H + h] = p.A[h] * dda + uu[k];
      v = dts[k] * dda;
    }
    red[k] = v;
  }
  __syncthreads();
  if (warp == 0) {
    const float* v = red + 4 * lane;
    const float s = warp_sum(((v[0] + v[1]) + v[2]) + v[3]);
    if (lane == 0) p.dap[((long long)b * nc + c) * H + h] = s;
  }
}

// ------------------------------ e. dCB per (group, chunk, b)
// dCB_ij = sum over the group's heads, in order from zero, of launch d's
// (dy_i . x_j) exp(cum_i - cum_j) dt_j, for j <= i; zero above the
// diagonal.  Four columns a thread; bound by bytes.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_dcb_kernel(const BwdParams p) {
  const int Q = p.Q, LQ = p.LQ, nc = p.nc, H = p.H;
  const int per = Q * (LQ / 4);             // four-column pieces of a plane
  const int nb = (per + kThreads - 1) / kThreads;
  const int grp = blockIdx.x / nb;
  const int e = blockIdx.x % nb * kThreads + threadIdx.x;
  if (e >= per) return;
  const int c = blockIdx.y, b = blockIdx.z;
  const int i = e / (LQ / 4), j = e % (LQ / 4) * 4;
  const int h0 = grp * p.HG, h1 = min(H, h0 + p.HG);
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (j <= i) {
    const long long hs = (long long)Q * LQ;
    const float* x =
        p.xcb + ((((long long)b * nc + c) * H + h0) * Q + i) * LQ + j;
#pragma unroll 4
    for (int h = h0; h < h1; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(x + (h - h0) * hs);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (j + 1 > i) s.y = 0.f;
    if (j + 2 > i) s.z = 0.f;
    if (j + 3 > i) s.w = 0.f;
  }
  *reinterpret_cast<float4*>(
      p.dcbp + ((((long long)grp * p.B + b) * nc + c) * Q + i) * LQ + j) = s;
}

// ------------------------------ f. dC and dB per (group, N tile, chunk, b)
// dC rows i: sum_{h in the group} (exp(cum_i) o dy_h) s_c^h, then the
// group's dCB times B; dB rows j: sum_h (exp(cum_Q-1 - cum_j) dt_j o x_h)
// G_c+1^h, then the group's dCB^T C.  Every row of the chunk against a
// 64-wide N tile, the warps as launch d's (Tile).
// a stage: the rows (Q x 64 keys; dB's dCB slice 64 keys x Q), the keys'
// B operand (64 x 64), the head's cumsum (double) and its dt
constexpr int kStageF = kMaxQ * kLdA + kSlice * kLdK + 3 * kMaxQ;
static_assert(kSlice * kLdT == kMaxQ * kLdA, "dB's dCB slice fits");

__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_dbc_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float smem[];
  const int Q = p.Q, P = p.P, N = p.N, H = p.H, nc = p.nc;
  const int RT = (Q + kSlice - 1) / kSlice, NT = (N + kSlice - 1) / kSlice;
  // the block's group, dC (0) or dB (1), N tile's first column, chunk and
  // row read back from shared memory where an address needs them, so they
  // hold no register through the products
  __shared__ int coord[5];
  if (threadIdx.x == 0) {
    coord[0] = blockIdx.x / (2 * NT);
    coord[1] = blockIdx.x % (2 * NT) / NT;
    coord[2] = kSlice * (blockIdx.x % NT);
    coord[3] = blockIdx.y;
    coord[4] = blockIdx.z;
  }
  __syncthreads();
  const volatile int& grp = coord[0];
  const volatile int& which = coord[1];
  const volatile int& n0 = coord[2];
  const volatile int& c = coord[3];
  const volatile int& b = coord[4];
  const int h0 = grp * p.HG;
  const int c0 = c * Q, PN = P * N;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  Tile t;
  t.mt[0] = warp >> 1;
  t.mt[1] = kMaxQ / 16 - 1 - (warp >> 1);
  t.MT = (Q + 15) / 16;
  t.wn0 = 32 * (warp & 1);
  const bool dB = which == 1;
  // the heads' part: the state entering the chunk (dC) or the gradient of
  // the one leaving it (dB)
  const int KH = (dB ? c < nc - 1 : c > 0) ? min(H - h0, p.HG) : 0;
  // head h's state (entering the chunk for dC, the gradient of the one
  // leaving it for dB), the group's dCB, and C (dB) or B (dC) rows
  auto state = [&](int h) {
    return dB ? p.gst + (((long long)b * (nc - 1) + c) * H + h) * PN
              : p.st + (((long long)b * (nc - 1) + c - 1) * H + h) * PN;
  };
  auto dcbc = [&]() {
    return p.dcbp + (((long long)grp * p.B + b) * nc + c) * Q * p.LQ;
  };
  auto rows2 = [&]() {
    return dB ? p.Cm + b * p.c_sb + c0 * p.c_ss
              : p.Bm + b * p.b_sb + c0 * p.b_ss;
  };
  float acc[2][4][4];
  zero(acc);
  // the group's heads (K = P each), then its dCB (K = 64 slices of Q),
  // each product's 8-key steps added to acc in order
  ring(KH,
       [&](int kt, int buf) {
         const int h = h0 + kt;
         float* a = smem + buf * kStageF;
         float* bs = a + kMaxQ * kLdA;
         if (dB)
           stage<kMaxP>(a, kLdA, p.x + b * p.x_sb + h * p.x_sh + c0 * p.x_ss,
                        p.x_ss, t.MT * 16, Q, P, p.vec_x != 0, tid);
         else
           stage<kMaxP>(a, kLdA,
                        p.dy + (((long long)b * p.S + c0) * H + h) * P,
                        (long long)H * P, t.MT * 16, Q, P, p.vec_dy != 0, tid);
         stage<kSlice>(bs, kLdK, state(h) + n0, N, round_up(P, 8), P, N - n0,
                       p.vec_s != 0, tid);
         stage_cum(bs + kSlice * kLdK, p.cum, b, c, h, p, tid);
         stage_dt(bs + kSlice * kLdK + 2 * kMaxQ,
                  p.dt + b * p.dt_sb + h * p.dt_sh + c0 * p.dt_ss, p.dt_ss, Q,
                  tid);
       },
       [&](int, int buf) {
         const float* a = smem + buf * kStageF;
         const float* bs = a + kMaxQ * kLdA;
         const double* cs =
             reinterpret_cast<const double*>(bs + kSlice * kLdK);
         const float* ds = bs + kSlice * kLdK + 2 * kMaxQ;
         // the rows' scales: exp(cum_i) (dC), exp(cum_Q-1 - cum_j) dt_j (dB)
         float sc[2][2];
#pragma unroll
         for (int i = 0; i < 2; ++i)
#pragma unroll
           for (int h2 = 0; h2 < 2; ++h2) {
             const int r = 16 * t.mt[i] + g + 8 * h2;
             sc[i][h2] = r >= Q ? 0.f
                         : dB  ? exp_diff(cs[Q - 1], cs[r]) * ds[r]
                               : expf((float)cs[r]);
           }
         mma_rows(acc, a, kLdA, 1, bs, kLdK, 1, round_up(P, 8), t, g, q,
                  AllKeys(), sc);
       });
  ring(RT,
       [&](int kt, int buf) {
         const int i0 = kt * kSlice;
         float* a = smem + buf * kStageF;
         float* bs = a + kMaxQ * kLdA;
         if (dB)   // dCB rows i (keys) i0.., every column j
           stage<kMaxQ>(a, kLdT, dcbc() + (long long)i0 * p.LQ, p.LQ, kSlice,
                        Q - i0, p.LQ, true, tid);
         else      // dCB every row i, columns j (keys) i0..
           stage<kSlice>(a, kLdA, dcbc() + i0, p.LQ, t.MT * 16, Q, p.LQ - i0,
                         true, tid);
         const long long rs2 = dB ? p.c_ss : p.b_ss;
         stage<kSlice>(bs, kLdK, rows2() + i0 * rs2 + n0, rs2, kSlice, Q - i0,
                       N - n0, (dB ? p.vec_c : p.vec_b) != 0, tid);
       },
       [&](int kt, int buf) {
         const int i0 = kt * kSlice;
         const float* a = smem + buf * kStageF;
         const float* bs = a + kMaxQ * kLdA;
         const int kn = round_up(min(kSlice, Q - i0), 8);
         if (dB)   // rows j take nothing from keys i below them
           mma_rows(acc, a, 1, kLdT, bs, kLdK, 1, kn, t, g, q,
                    keys_from(i0));
         else      // rows i take nothing from keys j above them
           mma_rows(acc, a, kLdA, 1, bs, kLdK, 1, kn, t, g, q,
                    keys_to(i0));
       });
  const long long per = (long long)p.B * p.S * N;
  float* out = p.NG == 1
                   ? (dB ? p.dB : p.dC) + ((long long)b * p.S + c0) * N
                   : p.part + ((long long)grp * 2 + which) * per +
                         ((long long)b * p.S + c0) * N;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int r = 16 * t.mt[i] + g + 8 * h2;
      if (t.mt[i] >= t.MT || r >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + t.wn0 + 8 * j + 2 * q + e;
          if (n < N) out[(long long)r * N + n] = acc[i][j][2 * h2 + e];
        }
    }
}

// ------------------------------ g. the fixed-order sums
// Thread e < H: dA_h = the partials over b, then chunks, in order.  The
// rest (NG > 1): dC, then dB, each element the groups' partials in group
// order from zero.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_sums_kernel(const BwdParams p) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e < p.H) {
    float s = 0.f;
    for (int b = 0; b < p.B; ++b)
      for (int c = 0; c < p.nc; ++c)
        s += p.dap[((long long)b * p.nc + c) * p.H + e];
    p.dA[e] = s;
    return;
  }
  const long long per = (long long)p.B * p.S * p.N, f = e - p.H;
  if (p.NG == 1 || f >= 2 * per) return;
  const int which = (int)(f / per);
  const long long r = f - which * per;
  const float* src = p.part + which * per + r;
  float s = 0.f;
  for (int gi = 0; gi < p.NG; ++gi) s += src[(long long)gi * 2 * per];
  (which ? p.dB : p.dC)[r] = s;
}

constexpr size_t kSmemCb = sizeof(double) * (kMaxQ + kCbRows) * kLdCb;
constexpr size_t kSmemGloc =
    sizeof(float) * (kMaxQ * kLdX + kMaxQ * kLdN + 3 * kMaxQ);
constexpr size_t kSmemChunk =
    sizeof(float) * (3 * kTileR + 11 * kMaxQ + 4 * kHalf + kWarps) +
    sizeof(double) * kMaxQ;
constexpr size_t kSmemF = sizeof(float) * 2 * kStageF;
// two blocks an SM: 228 KB of shared memory, 1 KB reserved a block
static_assert(kSmemChunk + 1024 <= 228 * 1024 / 2 &&
                  kSmemF + 1024 <= 228 * 1024 / 2,
              "launches d and f: two blocks an SM");

}  // namespace

// Plain C entry point (bound with ctypes).  Strides are in elements, as
// for ssd_scan_f32: x [batch, seq, head], dt [batch, seq, head], B [batch,
// seq], C [batch, seq]; dy is contiguous (B, S, H, P).  Outputs dx
// (B, S, H, P), ddt (B, S, H), dA (H,), dB and dC (B, S, N), contiguous
// float32.  Scratch the caller allocates (float32): cb (B, nc, Q, LQ), st
// and gst (B, nc-1, H, P, N), decay and dap (B, nc, H), cum (B, nc, H, Q)
// float64, dcbp (NG, B, nc, Q, LQ) and, where NG > 1, part (NG, 2, B, S,
// N), with LQ = round_up(Q, 4) and NG = ceil(H / head_group) (head_group
// above H is taken as H).  Launches a to g in order on `stream` (b only
// if nc > 1, c only if nc > 2) and returns the first non-zero CUDA error
// code, or cudaErrorInvalidValue for a shape the kernels do not take; the
// wrapper raises on non-zero.
extern "C" int ssd_scan_bwd_f32(const void* x, const void* dt, const void* A,
                                const void* Bm, const void* Cm,
                                const void* dy, void* dx, void* ddt,
                                void* dA, void* dB, void* dC, void* cb,
                                void* st, void* decay, void* gst, void* cum,
                                void* xcb, void* dcbp, void* part,
                                void* dap,
                                const long long* strides, int B, int S,
                                int H, int P, int N, int Q, int head_group,
                                void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      S % Q != 0 || S / Q > 65535 || B < 1 || B > 65535 || H < 1 ||
      H > 65535 ||
      head_group < 1)
    return (int)cudaErrorInvalidValue;
  int err = ssd_scan_states_f32(x, dt, A, Bm, Cm, st, decay, strides, B, S,
                                H, P, N, Q, stream);
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
  p.cb = static_cast<float*>(cb);
  p.st = static_cast<const float*>(st);
  p.decay = static_cast<const float*>(decay);
  p.gst = static_cast<float*>(gst);
  p.cum = static_cast<double*>(cum);
  p.xcb = static_cast<float*>(xcb);
  p.dcbp = static_cast<float*>(dcbp);
  p.part = static_cast<float*>(part);
  p.dap = static_cast<float*>(dap);
  p.x_sb = strides[0]; p.x_ss = strides[1]; p.x_sh = strides[2];
  p.dt_sb = strides[3]; p.dt_ss = strides[4]; p.dt_sh = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7];
  p.c_sb = strides[8]; p.c_ss = strides[9];
  p.B = B; p.S = S; p.H = H; p.P = P; p.N = N; p.Q = Q;
  p.nc = S / Q;
  p.LQ = round_up(Q, 4);
  p.HG = head_group < H ? head_group : H;
  p.NG = (H + p.HG - 1) / p.HG;
  p.vec_x = aligned16(x) && p.x_sb % 4 == 0 && p.x_ss % 4 == 0 &&
            p.x_sh % 4 == 0 && P % 4 == 0;
  p.vec_b = aligned16(Bm) && p.b_sb % 4 == 0 && p.b_ss % 4 == 0 &&
            N % 4 == 0;
  p.vec_c = aligned16(Cm) && p.c_sb % 4 == 0 && p.c_ss % 4 == 0 &&
            N % 4 == 0;
  p.vec_s = aligned16(st) && aligned16(gst) && N % 4 == 0;
  p.vec_dy = aligned16(dy) && P % 4 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = launch(ssd_bwd_cb_kernel, dim3((Q + kCbRows - 1) / kCbRows, p.nc, B),
               kSmemCb, s, p);
  if (err) return err;
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
  const int NT = (N + kSlice - 1) / kSlice;
  if ((err = prepare(ssd_bwd_chunk_kernel, kSmemChunk)) ||
      (err = prepare(ssd_bwd_dbc_kernel, kSmemF)))
    return err;
  ssd_bwd_chunk_kernel<<<dim3(p.nc, H, B), kThreads, kSmemChunk, s>>>(p);
  if ((err = (int)cudaGetLastError())) return err;
  const int per = Q * (p.LQ / 4);
  ssd_bwd_dcb_kernel<<<dim3((per + kThreads - 1) / kThreads * p.NG, p.nc, B),
                       kThreads, 0, s>>>(p);
  if ((err = (int)cudaGetLastError())) return err;
  ssd_bwd_dbc_kernel<<<dim3(2 * NT * p.NG, p.nc, B), kThreads, kSmemF, s>>>(
      p);
  if ((err = (int)cudaGetLastError())) return err;
  const long long n_sum =
      H + (p.NG > 1 ? 2LL * B * (long long)S * N : 0LL);
  ssd_bwd_sums_kernel<<<(unsigned)((n_sum + kThreads - 1) / kThreads),
                        kThreads, 0, s>>>(p);
  return (int)cudaGetLastError();
}
