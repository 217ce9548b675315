// Attention backward for Hopper (sm_90a): dq, dk and dv of the online-
// softmax forward in flash_attention.cu, on the tensor cores (3xTF32).
//
// Replaces: the gradient the JAX package takes by differentiating
// src/repro/models/layers.py:48 blockwise_attention (its jnp online softmax
// under jax.checkpoint), the training path's twin of the Pallas TPU kernel
// src/repro/kernels/flash_attention.py:64 flash_attention.  Same contract as
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
// What bounds it on the H100: operations.  The function is five products
// of the forward's size (S, dP, dV, dK, dQ), 10*B*H*D flops per unmasked
// (q, k) pair, against q, k, v, o, dO and the three gradients read or
// written once; at 3xTF32's 165 TFLOP/s (three TF32 products a fp32 one)
// the qwen2.5-3b layer's 172 GFLOP take 1.04 ms, its 109 MB 0.03 ms.  This
// design computes those five products and no more.
//
// Design: two launches (three when G > 1).
// 1. flash_bwd_delta_kernel: Delta = rowsum(dO o), one warp a row; it also
//    zeroes dq and the semaphores of pass 2.
// 2. flash_bwd_dkdv_kernel: one block per (key tile of BK keys, b, query
//    head), so every query head has blocks of its own (1,024 at the qwen
//    layer, 1,280 at recurrentgemma-2b's).  The block walks the 32-row
//    query tiles its keys meet under the mask (and the rows with no valid
//    key).  For each it computes S^T = K Q^T and dP^T = V dO^T once over
//    the whole head dim, warp (wk, wd) taking keys 16 wk .. 16 wk + 15 and
//    a 1/WD share of the queries; P and dS stay in the warp's registers
//    (WD = 1) or pass through shared memory, split into TF32 hi and lo
//    once, in the A-fragment order the next products read; warp (wk, wd)
//    then adds P^T dO and dS^T Q to dV and dK for its 16 keys and a 1/WD
//    share of the head dim (64 columns or fewer, so the accumulators stay
//    in registers at every D, and no column slice of dK and dV recomputes
//    S and dP).  dS also goes to shared memory query-major, and the block
//    computes the tile's dQ = dS K over its keys and adds it to dq: dQ
//    needs no pass of its own, which would compute S and dP a second time
//    (seven products of the forward's size instead of five; timed on the
//    card, the separate pass was slower at every shape but D = 256, where
//    the two were within 3%).  With G > 1 each head writes its
//    dK and dV to a float32 scratch (B, Sk, H, D).
// 3. flash_bwd_headsum_kernel (G > 1): dk and dv are the sum of a group's
//    G partials in head order.
// Blocks are ordered longest first: the grid walks key tiles from the one
// that meets the most query tiles under the mask (the first under a causal
// mask, the last under a window alone), so short blocks fill the last
// wave.  The block walks its query tiles downward (upward under a window
// alone): with that, the block before it in the grid's order reaches each
// query tile at the same step or before, so waiting for its turn at dq
// costs about one tile's add, not a tile's products.
// Copies overlap the products: the streamed tiles (Q, dO, lse, Delta) go
// through a ring of two shared-memory stages by cp.async: once tile n has
// landed (cp.async.wait_group 0 and a barrier, which also says every warp
// is done with tile n - 1's stage), tile n + 1's copy is issued into the
// other stage and runs under tile n's products.  K and V stay resident.
// Shared memory per block and blocks an SM (warps: WK x WD):
//   D 64: 75,264 bytes, 2 of 4 warps; D 128: 173,568, 1 of 8;
//   D 256: 218,624, 1 of 8 (BK = 32 keys).
// Tiles sit in shared memory unpadded and swizzled (row r's 16-byte chunks
// XOR a function of r mod 8), so both ways the products read them, a row's
// 16-byte chunks along d (S, dP) and a 16-byte chunk of columns of rows
// 2t, 2t + 1 (dV, dK, dQ), hit every bank once per phase.  The 3xTF32 split
// (tf32x3.cuh) of P and dS is done once, by the thread that computed them
// (dQ's A fragments of dS are split as they are read); the streamed
// operands are split in registers, and each split value is reused across
// the fragment's n-tiles.
//
// Order of every sum (fixed, so two launches give the same bits; no
// atomic operation anywhere):
// - S and dP: each 8-column step of d goes to a zeroed fragment and is
//   added to the running sum with one rounded fp32 add, in d order (at
//   D = 256 a peaked softmax turned S's truncated tensor-core sum into dq
//   errors 10 times the plain version's);
// - dK and dV per head: each query tile's product goes to a zeroed
//   fragment (the tensor cores' own accumulation truncates, and over the
//   thousands of queries of a long sequence dk drifted 16 times further
//   from float64 than the plain version did) and is added to the running
//   sum with one rounded add, in the block's walk order;
// - dq: each (query tile, key tile)'s dS K goes to a zeroed fragment and is
//   added to dq with one rounded add, key tiles in the grid's order: a
//   semaphore per (b, head, query tile) holds the rank + 1 of the last
//   block that added, and a block waits for the one before it (the key
//   tiles that meet a query tile are consecutive ranks), as
//   FlashAttention-3's deterministic backward does.  Blocks are issued in
//   rank order, so the one waited for is running or done; a wait that
//   never ends traps (a launch error) instead of hanging the card;
// - dk, dv under GQA: the G heads' sums added in head order (h = kh G + 0,
//   1, ...), in pass 3.
// Products are m16n8k8 TF32 mma.sync in 3xTF32; P and dS pass to the A
// operand with the fragment's column t taken as query (or key) 2t and t+4
// as 2t+1, and the B rows are read in that order.
#include "tf32x3.cuh"

namespace {

using tc::mma_tf32;
using tc::split;

constexpr int kSmemPerSM = 233472;      // 228 KB, 1 KB of it per block

// ------------------------------------------------------------ tiles
constexpr int kBQ = 32;                 // query rows a step of the pass

template <int D>
struct Cfg {
  static constexpr int DP = (D + 31) / 32 * 32;  // shared-memory row width
  // WK x WD warps, BK keys a block
  static constexpr int WK = D == 256 ? 2 : 4;
  static constexpr int WD = D == 256 ? 4 : D == 128 ? 2 : 1;
  static constexpr int BK = 16 * WK;
  static constexpr int BQ = kBQ;
  static constexpr int NW = WK * WD;
  static constexpr int kThreads = 32 * NW;
  // dQ of a step: warp w takes query rows 16 (w % 2) .. and the column
  // group w / 2 of NGQ (the warps past them sit out)
  static constexpr int NGQ = NW / 2 < DP / 32 ? NW / 2 : DP / 32;
  static constexpr int LDM = BK + 8;    // dS's row stride, keys
  static_assert(BQ % (8 * WD) == 0 && DP % (32 * WD) == 0, "dK/dV split");
  static_assert(BQ == 32, "dQ's two m-tiles");

  // shared memory (bytes): K and V, the two ring stages, P and dS as split
  // A fragments when the warps split the head dim, dS query-major for dQ
  static constexpr int kSmem = (2 * BK * DP + 2 * (2 * BQ * DP + 2 * BQ) +
                                (WD > 1 ? 4 * BK * BQ : 0) + BQ * LDM) * 4;
  // blocks an SM holds by shared memory, at most two (at three ptxas
  // caps the registers at 168 a thread, and D 64 spills)
  static constexpr int kMinBlocks =
      kSmemPerSM / (kSmem + 1024) < 2 ? kSmemPerSM / (kSmem + 1024) : 2;
};

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
  float* dk_part;     // (B, Sk, H, D) scratch when G > 1, else null
  float* dv_part;
  int* sem;           // (B, H, ceil(Sq / 32)) scratch: dQ's turn
  int B, Sq, Sk, H, KH;
  int causal, window, q_offset;
  int vec;
  float scale, softcap;
};

// The swizzle of a tile with rows DP floats wide: row r's columns XOR
// ((r & 1) << 4) ^ ((r & 6) << 2), which moves 16-byte chunks whole inside
// their 32-column block.  Eight consecutive lanes then read eight
// different 4-bank groups both when they take a 16-byte chunk along d of
// rows g, g+1 (chunks t = 0..3) and when they take chunk g of rows 2t and
// 2t + 1 (t = 0..3).
__device__ __forceinline__ int swz_bits(int r) {
  return ((r & 1) << 4) ^ ((r & 6) << 2);
}
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DP + (c ^ swz_bits(r));
}

// Stage rows x DP floats of global memory (row stride ld; rows >= nr or
// columns >= nc read 0) into a swizzled tile, with threads tid of n.  vec:
// 16-byte copies (aligned rows); otherwise 4-byte ones.  The caller
// commits and waits.
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long ld, int rows, int nr, int nc,
                                      bool vec, int tid, int n) {
  if (vec) {
    constexpr int cpr = DP / 4;
    for (int c = tid; c < rows * cpr; c += n) {
      const int r = c / cpr, cc = (c % cpr) * 4;
      const bool in = r < nr && cc < nc;
      tc::cp_async16(dst + swz<DP>(r, cc), in ? src + r * ld + cc : src,
                     in ? 16 : 0);
    }
  } else {
    for (int c = tid; c < rows * DP; c += n) {
      const int r = c / DP, cc = c % DP;
      const bool in = r < nr && cc < nc;
      tc::cp_async4(dst + swz<DP>(r, cc), in ? src + r * ld + cc : src,
                    in ? 4 : 0);
    }
  }
}

// d = a * b in 3xTF32 from a zeroed accumulator: the two small terms
// first, then hi * hi
__device__ __forceinline__ void mma_3xtf32_z(float (&d)[4],
                                             const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4],
                                             const uint32_t (&bh)[2],
                                             const uint32_t (&bl)[2]) {
  tc::mma_tf32_z(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 columns of d of S (or dP) for the warp's NT n-tiles: the A fragments
// of the two 8-steps (hi and lo) against Y's rows yr + 8j DP at column
// col, d taken in the order of the 16-byte loads (thread t's k columns t
// and t+4 are d = 4t and 4t+1 in the first 8-step, 4t+2 and 4t+3 in the
// second).  Each 8-step goes to a zeroed fragment and is added to acc with
// one rounded add.
template <int DP, int NT>
__device__ __forceinline__ void s_step(float (&acc)[NT][4],
                                       const uint32_t (&ah0)[4],
                                       const uint32_t (&al0)[4],
                                       const uint32_t (&ah1)[4],
                                       const uint32_t (&al1)[4],
                                       const float* yr, int col) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float4 kb = ld4(yr + 8 * j * DP + col);
    uint32_t bh[2], bl[2];
    float part[4];
    split(kb.x, bh[0], bl[0]);
    split(kb.y, bh[1], bl[1]);
    mma_3xtf32_z(part, ah0, al0, bh, bl);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], part[r]);
    split(kb.z, bh[0], bl[0]);
    split(kb.w, bh[1], bl[1]);
    mma_3xtf32_z(part, ah1, al1, bh, bl);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = __fadd_rn(acc[j][r], part[r]);
  }
}

// acc[j] (16 x 8) += X (rows x0 + g, x0 + g + 8) . Y^T (rows y0 + 8j + g),
// over the DP columns of two swizzled tiles (x0, y0 multiples of 8)
template <int DP, int NT>
__device__ __forceinline__ void rows_dot(float (&acc)[NT][4], const float* X,
                                         int x0, const float* Y, int y0,
                                         int g, int t) {
  const int c = (4 * t) ^ swz_bits(g);    // every row read is g mod 8
  const float* xa = X + (x0 + g) * DP;
  const float* xb = xa + 8 * DP;
  const float* yr = Y + (y0 + g) * DP;
#pragma unroll 1
  for (int k32 = 0; k32 < DP; k32 += 32) {
#pragma unroll
    for (int h = 0; h < 32; h += 16) {
      const int col = k32 + (c ^ h);
      const float4 qa = ld4(xa + col), qb = ld4(xb + col);
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      split(qa.x, ah0[0], al0[0]);
      split(qb.x, ah0[1], al0[1]);
      split(qa.y, ah0[2], al0[2]);
      split(qb.y, ah0[3], al0[3]);
      split(qa.z, ah1[0], al1[0]);
      split(qb.z, ah1[1], al1[1]);
      split(qa.w, ah1[2], al1[2]);
      split(qb.w, ah1[3], al1[3]);
      s_step<DP, NT>(acc, ah0, al0, ah1, al1, yr, col);
    }
  }
}

// A fragments of P (or dS) from a warp's accumulators (rows g, g+8;
// columns 2t, 2t+1 of n-tile j), split into hi and lo: k-step j, with the
// fragment's column t taken as column 2t and t+4 as 2t+1 (a0 (g, 2t),
// a1 (g+8, 2t), a2 (g, 2t+1), a3 (g+8, 2t+1))
template <int NT>
__device__ __forceinline__ void split_frags(uint32_t (&ah)[NT][4],
                                            uint32_t (&al)[NT][4],
                                            const float (&x)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split(x[j][0], ah[j][0], al[j][0]);
    split(x[j][2], ah[j][1], al[j][1]);
    split(x[j][1], ah[j][2], al[j][2]);
    split(x[j][3], ah[j][3], al[j][3]);
  }
}

// Those fragments to shared memory, for the warps that split the head dim:
// fragment J0 + j of the m-tile, lane by lane, {hi, lo} as two 16-byte
// words
template <int NT>
__device__ __forceinline__ void store_frags(uint4* F, const float (&x)[NT][4],
                                            int J0, int lane) {
  uint32_t ah[NT][4], al[NT][4];
  split_frags<NT>(ah, al, x);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    F[((J0 + j) * 32 + lane) * 2] = make_uint4(ah[j][0], ah[j][1], ah[j][2],
                                               ah[j][3]);
    F[((J0 + j) * 32 + lane) * 2 + 1] = make_uint4(al[j][0], al[j][1],
                                                   al[j][2], al[j][3]);
  }
}

template <int KS>
__device__ __forceinline__ void load_frags(uint32_t (&ah)[KS][4],
                                           uint32_t (&al)[KS][4],
                                           const uint4* F, int lane) {
#pragma unroll
  for (int J = 0; J < KS; ++J) {
    const uint4 h = F[(J * 32 + lane) * 2], l = F[(J * 32 + lane) * 2 + 1];
    ah[J][0] = h.x; ah[J][1] = h.y; ah[J][2] = h.z; ah[J][3] = h.w;
    al[J][0] = l.x; al[J][1] = l.y; al[J][2] = l.z; al[J][3] = l.w;
  }
}

// acc (16 rows x NC n-tiles) += A (16 x 8 KS) . Y (rows 0 .. 8 KS - 1 of a
// swizzled tile, columns col0 ..); a(J, hi, lo) gives k-step J's split A
// fragment.  The n-tiles are taken four at a time: n-tile 4 cb + u holds
// columns col0 + 32 cb + 4 n + u (n = 0 .. 7), so one 16-byte load of a
// row brings a B value for each of the four.  B rows: k column t is row
// 2t, t+4 row 2t+1 of each 8-row step (the order of the A fragments).  The
// whole product (every k-step) goes to a zeroed fragment, added to acc
// once.
template <int DP, int NC, int KS, class AFrag>
__device__ __forceinline__ void frag_dot(float (&acc)[NC][4], AFrag a,
                                         const float* Y, int col0, int g,
                                         int t) {
  const float* y0 = Y + swz<DP>(2 * t, col0 + 4 * g);
  const float* y1 = Y + swz<DP>(2 * t + 1, col0 + 4 * g);
#pragma unroll
  for (int cb = 0; cb < NC / 4; ++cb) {
    float part[4][4];
#pragma unroll
    for (int J = 0; J < KS; ++J) {
      uint32_t ah[4], al[4];
      a(J, ah, al);
      const float4 b0 = ld4(y0 + 8 * J * DP + 32 * cb);
      const float4 b1 = ld4(y1 + 8 * J * DP + 32 * cb);
      const float v0[4] = {b0.x, b0.y, b0.z, b0.w};
      const float v1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        uint32_t bh[2], bl[2];
        split(v0[u], bh[0], bl[0]);
        split(v1[u], bh[1], bl[1]);
        if (J == 0) {
          mma_3xtf32_z(part[u], ah, al, bh, bl);
        } else {
          mma_tf32(part[u], al, bh);
          mma_tf32(part[u], ah, bl);
          mma_tf32(part[u], ah, bh);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[4 * cb + u][r] = __fadd_rn(acc[4 * cb + u][r], part[u][r]);
  }
}

// Write a warp's accumulators (rows row_g, row_g + 8 of dst, each a
// pointer or null past the end; columns as frag_dot lays them out), the
// columns below D
template <int NC>
__device__ __forceinline__ void store_rows(float* row_g, float* row_g8,
                                           const float (&acc)[NC][4],
                                           int col0, int t, int D) {
#pragma unroll
  for (int cb = 0; cb < NC / 4; ++cb) {
    const int col = col0 + 32 * cb + 8 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (col + 4 * half >= D) continue;
      if (row_g)
        *reinterpret_cast<float4*>(row_g + col + 4 * half) = make_float4(
            acc[4 * cb][half], acc[4 * cb + 1][half], acc[4 * cb + 2][half],
            acc[4 * cb + 3][half]);
      if (row_g8)
        *reinterpret_cast<float4*>(row_g8 + col + 4 * half) = make_float4(
            acc[4 * cb][2 + half], acc[4 * cb + 1][2 + half],
            acc[4 * cb + 2][2 + half], acc[4 * cb + 3][2 + half]);
    }
  }
}

// The same rows and columns added to dst's values: read and written
// through L2, which the block before in the order wrote them to
template <int NC>
__device__ __forceinline__ void add_rows(float* row_g, float* row_g8,
                                         const float (&acc)[NC][4],
                                         int col0, int t, int D) {
#pragma unroll
  for (int cb = 0; cb < NC / 4; ++cb) {
    const int col = col0 + 32 * cb + 8 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (col + 4 * half >= D) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* row = e ? row_g8 : row_g;
        if (!row) continue;
        float4* d = reinterpret_cast<float4*>(row + col + 4 * half);
        float4 x = __ldcg(d);
        x.x = __fadd_rn(x.x, acc[4 * cb][2 * e + half]);
        x.y = __fadd_rn(x.y, acc[4 * cb + 1][2 * e + half]);
        x.z = __fadd_rn(x.z, acc[4 * cb + 2][2 * e + half]);
        x.w = __fadd_rn(x.w, acc[4 * cb + 3][2 * e + half]);
        __stcg(d, x);
      }
    }
  }
}

// dQ's turn for a query tile: wait until the block before in the order
// has added (the semaphore holds its rank + 1); a wait that never ends
// stops the kernel with an error rather than hanging the card
__device__ __forceinline__ void sem_wait(const int* sem, int v) {
  long long spins = 0;
  while (*reinterpret_cast<const volatile int*>(sem) != v) {
    __nanosleep(64);
    if (++spins > (1LL << 26)) __trap();
  }
  __threadfence();
}

__device__ __forceinline__ void sem_post(int* sem, int v) {
  __threadfence();
  *reinterpret_cast<volatile int*>(sem) = v;
}

template <int N>
__device__ __forceinline__ void zero(float (&a)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[j][r] = 0.f;
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

// Is every (query, key) pair of the tile inside the tensors and the mask
// (then no row of it lacks a valid key)?
__device__ __forceinline__ bool tile_inside(int i0, int ni, int k0, int nk,
                                            const Params& p) {
  const int qfirst = p.q_offset + i0, qlast = qfirst + ni - 1;
  return i0 + ni <= p.Sq && k0 + nk <= p.Sk &&
         (!p.causal || k0 + nk - 1 <= qfirst) &&
         (!p.window || k0 > qlast - p.window);
}

// The softmax weight and the gradient of the raw product q . k for a pair
// inside the mask, from S's accumulator s and dP's dp
__device__ __forceinline__ void weight_and_grad_in(float s, float dp,
                                                   float lse, float delta,
                                                   const Params& p, float& P,
                                                   float& dS) {
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

// The same for any pair: off the mask P = dS = 0; a row with no valid key
// weighs every key 1/Sk and has no gradient
__device__ __forceinline__ void weight_and_grad(float s, float dp, int qpos,
                                                int kpos, float lse,
                                                float delta, bool dead,
                                                const Params& p, float& P,
                                                float& dS) {
  if (dead) {
    P = 1.f / (float)p.Sk;
    dS = 0.f;
  } else if (!keep(qpos, kpos, p)) {
    P = 0.f;
    dS = 0.f;
  } else {
    weight_and_grad_in(s, dp, lse, delta, p, P, dS);
  }
}

// ------------------------------------------------------------ Delta
// Delta = rowsum(dO o); dq and the semaphores zeroed for the pass's sums
constexpr int kDeltaWarps = 4;

__global__ void __launch_bounds__(32 * kDeltaWarps)
flash_bwd_delta_kernel(Params p, int D) {
  const long long row = (long long)blockIdx.x * kDeltaWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= (long long)p.B * p.Sq * p.H) return;
  const float* o = p.o + row * D;
  const float* d = p.dout + row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc += o[c] * d[c];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  for (int c = lane; c < D; c += 32) p.dq[row * D + c] = 0.f;
  if (lane == 0) {                  // row = (b * Sq + i) * H + h
    const int h = row % p.H;
    const long long bi = row / p.H;
    const int i = bi % p.Sq, b = bi / p.Sq;
    p.delta[((long long)b * p.H + h) * p.Sq + i] = acc;
    if (i % kBQ == 0)
      p.sem[((long long)b * p.H + h) * ((p.Sq + kBQ - 1) / kBQ) + i / kBQ] =
          0;
  }
}

// ------------------------------------------------------------ dK, dV, dQ
// The query tiles a key tile kt meets: the mask's range [qa, qa + nA),
// and the tiles from qd on, whose rows lack any valid key (only under a
// window); n of them in all.  They are walked downward (upward under a
// window without the causal mask): then the block before in dQ's order
// reaches each query tile at the same step or before.
struct QTiles {
  int qa, nA, qd, n;
  bool up;
  __device__ int tile(int i) const {
    if (!up) i = n - 1 - i;
    return i < nA ? qa + i : qd + i - nA;
  }
  __device__ bool meets(int qt) const {
    return (qt >= qa && qt < qa + nA) || qt >= qd;
  }
};

__device__ __forceinline__ QTiles q_tiles(int kt, int BK, const Params& p) {
  const int k0 = kt * BK;
  const int nqt = (p.Sq + kBQ - 1) / kBQ;
  const int klast = min(k0 + BK, p.Sk) - 1;
  const int i_lo = p.causal ? max(0, k0 - p.q_offset) : 0;
  const int i_hi = p.window ? min(p.Sq, klast + p.window - p.q_offset)
                            : p.Sq;
  const int i_dead = p.window ? max(0, p.Sk + p.window - 1 - p.q_offset)
                              : p.Sq;
  QTiles r;
  r.qa = min(i_lo / kBQ, nqt);
  r.nA = max(0, (i_hi + kBQ - 1) / kBQ - r.qa);
  r.qd = i_dead < p.Sq ? max(i_dead / kBQ, r.qa + r.nA) : nqt;
  r.n = r.nA + (nqt - r.qd);
  r.up = !p.causal && p.window;
  return r;
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinBlocks)
flash_bwd_dkdv_kernel(Params p) {
  using C = Cfg<D>;
  constexpr int DP = C::DP, BK = C::BK, BQ = C::BQ, WD = C::WD;
  constexpr int NQ = BQ / WD;          // queries of S^T a warp computes
  constexpr int NT = NQ / 8;
  constexpr int NC = DP / WD / 8;      // dK, dV n-tiles a warp owns
  constexpr int KS = BQ / 8;
  constexpr int NCQ = DP / C::NGQ / 8;  // dQ n-tiles a warp owns
  constexpr int LDM = C::LDM;
  constexpr int kStage = 2 * BQ * DP + 2 * BQ;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // [BK][DP]
  float* Vs = Ks + BK * DP;                         // [BK][DP]
  float* ring = Vs + BK * DP;                       // 2 x {Q, dO, lse, Delta}
  float* dSm = ring + 2 * kStage;                   // dS [BQ][LDM]
  uint4* Pf = reinterpret_cast<uint4*>(dSm + BQ * LDM);
  uint4* dSf = Pf + BK * BQ / 2;                    // (WD > 1)

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wk = warp / WD, wd = warp % WD;
  const int mq = warp % 2, cg = warp / 2;           // dQ's share
  const int BH = p.B * p.H;
  const int nk = (p.Sk + BK - 1) / BK;
  const int rank = blockIdx.x / BH;
  // longest first: under a causal mask the first key tiles meet the most
  // query tiles, under a window alone the last ones.  dQ's sums follow the
  // same order.
  const bool down = !p.causal && p.window;
  const int kt = down ? nk - 1 - rank : rank;
  const int b = (blockIdx.x % BH) / p.H, h = blockIdx.x % p.H;
  const int G = p.H / p.KH, kh = h / G;
  const int k0 = kt * BK;
  const bool vec = p.vec != 0;
  const long long kstride = (long long)p.KH * D;
  const long long qstride = (long long)p.H * D;
  const long long koff = ((long long)b * p.Sk + k0) * kstride + kh * D;
  stage<DP>(Ks, p.k + koff, kstride, BK, p.Sk - k0, D, vec, tid,
            C::kThreads);
  stage<DP>(Vs, p.v + koff, kstride, BK, p.Sk - k0, D, vec, tid,
            C::kThreads);

  const QTiles mine = q_tiles(kt, BK, p);
  // the key tile before this one in dQ's order; the query tiles that meet
  // a tile are a run of consecutive ranks, so if the one before meets a
  // query tile it is the one to wait for
  const QTiles prev = q_tiles(down ? kt + 1 : kt - 1, BK, p);
  int* sem = p.sem + (long long)(b * p.H + h) * ((p.Sq + BQ - 1) / BQ);

  auto load_tile = [&](int n) {
    const int i0 = mine.tile(n) * BQ;
    float* st = ring + (n & 1) * kStage;
    const long long qoff = ((long long)b * p.Sq + i0) * qstride + h * D;
    stage<DP>(st, p.q + qoff, qstride, BQ, p.Sq - i0, D, vec, tid,
              C::kThreads);
    stage<DP>(st + BQ * DP, p.dout + qoff, qstride, BQ, p.Sq - i0, D, vec,
              tid, C::kThreads);
    if (tid < BQ) {
      const bool in = i0 + tid < p.Sq;
      const long long r = ((long long)b * p.H + h) * p.Sq + i0 + tid;
      tc::cp_async4(st + 2 * BQ * DP + tid, in ? p.lse + r : p.lse,
                    in ? 4 : 0);
      tc::cp_async4(st + 2 * BQ * DP + BQ + tid, in ? p.delta + r : p.delta,
                    in ? 4 : 0);
    }
  };
  if (mine.n > 0) load_tile(0);
  tc::cp_async_commit();

  float dk[NC][4], dv[NC][4];
  zero(dk);
  zero(dv);
  int posted = -1;                      // query tile whose dQ sum is ours
  for (int n = 0; n < mine.n; ++n) {
    tc::cp_async_wait<0>();
    __syncthreads();           // tile n landed; tile n - 1 done by all
    if (tid == 0 && posted >= 0) sem_post(sem + posted, rank + 1);
    if (n + 1 < mine.n) load_tile(n + 1);
    tc::cp_async_commit();
    const int qt = mine.tile(n);
    const int i0 = qt * BQ;
    const float* Qs = ring + (n & 1) * kStage;
    const float* Ds = Qs + BQ * DP;
    const float* lse_s = Ds + BQ * DP;
    const float* del_s = lse_s + BQ;

    float s[NT][4], dp[NT][4];
    zero(s);
    zero(dp);
    rows_dot<DP, NT>(s, Ks, 16 * wk, Qs, wd * NQ, g, t);      // S^T
    rows_dot<DP, NT>(dp, Vs, 16 * wk, Ds, wd * NQ, g, t);     // dP^T
    const bool inside = tile_inside(i0, BQ, k0, BK, p);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int qc = wd * NQ + 8 * j + 2 * t + (r & 1);
        const int kc = 16 * wk + g + 8 * (r >> 1);
        float P, dS;
        if (inside) {
          weight_and_grad_in(s[j][r], dp[j][r], lse_s[qc], del_s[qc], p, P,
                             dS);
        } else {
          const int kpos = k0 + kc;
          const int i = i0 + qc, qpos = p.q_offset + i;
          P = dS = 0.f;
          if (kpos < p.Sk && i < p.Sq)
            weight_and_grad(s[j][r], dp[j][r], qpos, kpos, lse_s[qc],
                            del_s[qc], !has_key(qpos, p), p, P, dS);
        }
        s[j][r] = P;
        dp[j][r] = dS;
        dSm[qc * LDM + kc] = dS;
      }
    if constexpr (WD > 1) {                 // shared by the wd warps
      store_frags<NT>(Pf + wk * KS * 64, s, wd * NT, lane);
      store_frags<NT>(dSf + wk * KS * 64, dp, wd * NT, lane);
    }
    __syncthreads();
    {
      uint32_t ah[KS][4], al[KS][4];
      auto a = [&](int J, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          hi[r] = ah[J][r];
          lo[r] = al[J][r];
        }
      };
      if constexpr (WD == 1) split_frags<KS>(ah, al, s);   // the warp's own
      else load_frags<KS>(ah, al, Pf + wk * KS * 64, lane);
      frag_dot<DP, NC, KS>(dv, a, Ds, wd * (DP / WD), g, t);  // dV += P^T dO
      if constexpr (WD == 1) split_frags<KS>(ah, al, dp);
      else load_frags<KS>(ah, al, dSf + wk * KS * 64, lane);
      frag_dot<DP, NC, KS>(dk, a, Qs, wd * (DP / WD), g, t);  // dK += dS^T Q
    }
    // dQ of this tile, dS K over the block's keys: rows 16 mq .., columns
    // of group cg, in a zeroed fragment added to dq once, in turn
    float dqt[NCQ][4];
    zero(dqt);
    if (cg < C::NGQ) {
      auto a = [&](int J, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        const float* r0 = dSm + (16 * mq + g) * LDM + 8 * J + 2 * t;
        const float2 x0 = *reinterpret_cast<const float2*>(r0);
        const float2 x1 = *reinterpret_cast<const float2*>(r0 + 8 * LDM);
        split(x0.x, hi[0], lo[0]);
        split(x1.x, hi[1], lo[1]);
        split(x0.y, hi[2], lo[2]);
        split(x1.y, hi[3], lo[3]);
      };
      frag_dot<DP, NCQ, BK / 8>(dqt, a, Ks, cg * (DP / C::NGQ), g, t);
    }
    if (tid == 0 && rank > 0 && prev.meets(qt)) sem_wait(sem + qt, rank);
    __syncthreads();
    if (cg < C::NGQ) {
      const int i = i0 + 16 * mq + g;
      float* row = p.dq + ((long long)b * p.Sq + i) * qstride + h * D;
      add_rows<NCQ>(i < p.Sq ? row : nullptr,
                    i + 8 < p.Sq ? row + 8 * qstride : nullptr, dqt,
                    cg * (DP / C::NGQ), t, D);
    }
    posted = qt;
  }
  tc::cp_async_wait<0>();             // K and V staged even with no tile
  __syncthreads();
  if (tid == 0 && posted >= 0) sem_post(sem + posted, rank + 1);

  const int kpos = k0 + 16 * wk + g;
  float *dkr = nullptr, *dkr8 = nullptr, *dvr = nullptr, *dvr8 = nullptr;
  const long long ostride = G > 1 ? qstride : kstride;
  const long long ohead = G > 1 ? (long long)h * D : (long long)kh * D;
  float* dkb = G > 1 ? p.dk_part : p.dk;
  float* dvb = G > 1 ? p.dv_part : p.dv;
  if (kpos < p.Sk) {
    dkr = dkb + ((long long)b * p.Sk + kpos) * ostride + ohead;
    dvr = dvb + ((long long)b * p.Sk + kpos) * ostride + ohead;
  }
  if (kpos + 8 < p.Sk) {
    dkr8 = dkb + ((long long)b * p.Sk + kpos + 8) * ostride + ohead;
    dvr8 = dvb + ((long long)b * p.Sk + kpos + 8) * ostride + ohead;
  }
  store_rows<NC>(dkr, dkr8, dk, wd * (DP / WD), t, D);
  store_rows<NC>(dvr, dvr8, dv, wd * (DP / WD), t, D);
}

// ------------------------------------------------------------ head sum
// dk[b, s, kh] = sum over g of dk_part[b, s, kh G + g], g = 0, 1, ... in
// order (and dv): block (x, y) takes key row x = b Sk + s and 256 of its
// KH D / 4 groups of four columns
constexpr int kSumThreads = 256;

__global__ void __launch_bounds__(kSumThreads)
flash_bwd_headsum_kernel(Params p, int D) {
  const int c4 = D / 4;
  const int j = blockIdx.y * kSumThreads + threadIdx.x;
  if (j >= p.KH * c4) return;
  const int G = p.H / p.KH, kh = j / c4, c = (j % c4) * 4;
  const long long row = blockIdx.x;              // b * Sk + s
  const long long src = (row * p.H + kh * G) * D + c;
  const long long dst = (row * p.KH + kh) * D + c;
  float4 sk = ld4(p.dk_part + src), sv = ld4(p.dv_part + src);
  for (int gg = 1; gg < G; ++gg) {
    const float4 a = ld4(p.dk_part + src + gg * D);
    const float4 w = ld4(p.dv_part + src + gg * D);
    sk.x = __fadd_rn(sk.x, a.x); sk.y = __fadd_rn(sk.y, a.y);
    sk.z = __fadd_rn(sk.z, a.z); sk.w = __fadd_rn(sk.w, a.w);
    sv.x = __fadd_rn(sv.x, w.x); sv.y = __fadd_rn(sv.y, w.y);
    sv.z = __fadd_rn(sv.z, w.z); sv.w = __fadd_rn(sv.w, w.w);
  }
  *reinterpret_cast<float4*>(p.dk + dst) = sk;
  *reinterpret_cast<float4*>(p.dv + dst) = sv;
}

template <int D>
int launch(const Params& p, void* stream) {
  using C = Cfg<D>;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long rows = (long long)p.B * p.Sq * p.H;
  flash_bwd_delta_kernel<<<(unsigned)((rows + kDeltaWarps - 1) / kDeltaWarps),
                           32 * kDeltaWarps, 0, st>>>(p, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const unsigned BH = (unsigned)(p.B * p.H);
  err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkdv_kernel<D><<<(p.Sk + C::BK - 1) / C::BK * BH, C::kThreads,
                             C::kSmem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  if (p.H > p.KH) {
    const dim3 grid((unsigned)(p.B * p.Sk),
                    (unsigned)((p.KH * (D / 4) + kSumThreads - 1) /
                               kSumThreads));
    flash_bwd_headsum_kernel<<<grid, kSumThreads, 0, st>>>(p, D);
    err = cudaGetLastError();
  }
  return (int)err;
}

}  // namespace

// Plain C entry point (bound with ctypes).  Every operand float32 and
// contiguous in the model layout: q, o, dout, dq (B, Sq, H, D); k, v, dk,
// dv (B, Sk, KH, D); lse and the delta scratch (B, H, Sq); with H > KH the
// dk_part and dv_part scratch (B, Sk, H, D) (else null).  Three or four
// launches on the stream; returns the first non-zero cudaError (of a
// launch or of raising the dynamic shared-memory limit), else 0.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, void* dk, void* dv,
                                   void* dk_part, void* dv_part, void* sem,
                                   int B,
                                   int Sq, int Sk, int H, int KH, int D,
                                   int causal, int window, int q_offset,
                                   float scale, float softcap,
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
  p.dk_part = static_cast<float*>(dk_part);
  p.dv_part = static_cast<float*>(dv_part);
  p.sem = static_cast<int*>(sem);
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KH = KH;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = scale;
  p.softcap = softcap;
  if ((H > KH && (dk_part == nullptr || dv_part == nullptr)) || !sem)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need 16-byte-aligned rows: the bases, and D a multiple
  // of 4 (every supported D is); the epilogues store 16 bytes too
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
