// Online-softmax (flash) attention forward for Hopper (sm_90a) on the
// tensor cores.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// Pallas TPU kernel (grid (B*H, nq, nk) with the kv axis innermost, running
// max / denominator / accumulator in VMEM scratch across kv steps), which
// the JAX LM stack's blockwise_attention (models/layers.py) mirrors in jnp.
// Same contract: causal and sliding-window masks, GQA (query head h reads
// kv head h / G), tanh logit softcap, masked scores at -1e30, float32
// statistics and accumulator, output in the input dtype; D in {32, 48,
// 64, 128, 256}, every head dim of the repository's configs.
//
// Layout: q (B, Sq, H, D) and k, v (B, Sk, KH, D), the model's own layout,
// read through element strides (the last dimension must be contiguous), so
// the wrapper makes no transposed copy.  out is (B, Sq, H, D) contiguous.
// Where the caller passes an lse buffer (a gradient is wanted), each row's
// log-sum-exp over its scaled, soft-capped and masked scores, in natural
// units, goes to lse (B, H, Sq) float32: m + log2(l), times ln 2, from the
// running max and sum the kernel already holds, written after out and
// touching nothing out is computed from, so out has the same bits with or
// without it.  flash_attention_bwd.cu recomputes P = exp(s - lse) from it.
//
// Masks use absolute positions: query row i sits at q_offset + i, key j at
// j; causal keeps kpos <= qpos, a window keeps kpos > qpos - window.
// Ragged tails of Sq and Sk are masked here (the Pallas kernel refuses
// them): a key past Sk is absent (weight exactly 0), not a -1e30 score, so
// a row whose every key is masked averages v over the Sk real keys, as
// attention_ref does.
//
// What bounds it on the H100: 4*B*H*D flops per unmasked (q, k) pair.  At
// qwen2.5-3b's prefill (B=1, S=4096, H=16, D=128, causal) that is 68.7
// GFLOP per layer against 50 MB of q/k/v/o: bound by operations.  Both
// products (S = Q K^T and O += P V) go through the tensor cores as 3xTF32
// (tf32x3.cuh), three TF32 products per fp32 product, an effective
// 165 TFLOP/s: 0.42 ms.  One TF32 product would miss the JAX bar (2e-4 in
// fp32) by an order of magnitude; 3xTF32 drops only lo*lo and meets it.
// bf16 inputs take one bf16 mma per product, no split.
//
// Design (FlashAttention-2's, on mma.sync):
// - one block of 4 warps per (b, h, 64-row query tile), 16 rows per warp;
//   S, the running max, the running sum and O stay in registers (at D = 256
//   O is 128 registers a thread);
// - key tiles of 64 rows at D <= 64, 32 at D = 128 and 16 at D = 256 are
//   staged by cp.async; K and V have one buffer each and their copies interleave
//   with the products: V_j lands while S_j = Q K_j^T and the softmax run,
//   K_j+1 while O += P V_j.  Q stays in shared memory and is split again
//   for every key tile; the fp32 Q and K fragments of two mma steps come
//   in one 16-byte load (qk below; 4% faster on the qwen2.5-3b layer than
//   4-byte loads), and the row padding keeps every fragment load free of
//   bank conflicts.  At D = 128 a fp32 block takes 72.2 KB and three run
//   on an SM (12 warps; 64-key tiles at two an SM were 4% slower); at
//   D = 256 two of 103.7 KB (32-key tiles at one an SM were 19% slower on
//   the recurrentgemma-2b layer);
// - P passes from S's accumulator layout to the A operand of P V with no
//   shuffle and no shared-memory hop: in tf32 the A fragment's column t is
//   taken as key 2t and column t+4 as key 2t+1, the keys a thread's
//   accumulator already holds, and V's rows are read in the same order
//   (the sum over 8 keys is the same sum, in another order).  In bf16 the
//   accumulator pairs are the A fragment's pairs;
// - key tiles wholly outside the causal or window range of every row of
//   the query tile are skipped, unless some row of the tile has no valid
//   key at all (then every tile runs, so that row averages v as the
//   reference does); per-element masks run only on tiles that a mask or
//   the end of the keys cuts;
// - the grid walks query tiles from the last to the first, so the longest
//   causal tiles start first and the short ones fill the tail;
// - determinism: each (b, h, query tile) is one block that walks its key
//   tiles in order, with no split of the key range across blocks and no
//   atomics, so a launch on the same inputs gives the same bits.
#include "tf32x3.cuh"

namespace {

using tc::mma_3xtf32;
using tc::mma_bf16;
using tc::split;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;     // query rows per block
constexpr float kMasked = -1e30f;    // NEG_INF of the JAX package
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float neg_infinity() {
  return -__int_as_float(0x7f800000);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* lse;                   // (B, H, Sq) or null
  int B, Sq, Sk, H, KH;
  long long q_sb, q_ss, q_sh;   // element strides of q: batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window, q_offset;
  int vec;                      // 16-byte copies (aligned rows)
  float scale, softcap;
};

// Does the query at absolute position qpos have at least one valid key?
__device__ __forceinline__ bool has_key(int qpos, const Params& p) {
  const int lo = p.window ? max(qpos - p.window + 1, 0) : 0;
  const int hi = p.causal ? min(qpos, p.Sk - 1) : p.Sk - 1;
  return lo <= hi;
}

// Row padding in elements.  Q and K rows: fp32 fragments are read 16 bytes
// at a time (below), so rows sit 16 banks apart (no padding at D = 48,
// whose rows already do); bf16 rows 4 banks apart.  V rows: 16 bytes, 4
// banks apart for fp32.  With these every fragment load of a warp is free
// of bank conflicts.
template <typename T, int D>
__host__ __device__ constexpr int qk_pad() {
  return sizeof(T) == 4 ? (D % 32 == 16 ? 0 : 16) : 8;
}
template <typename T>
__host__ __device__ constexpr int v_pad() { return 16 / sizeof(T); }

template <int D>
__host__ __device__ constexpr int key_tile() {
  return D == 256 ? 16 : D == 128 ? 32 : 64;
}

// blocks an SM must hold (ptxas caps the registers to fit them): three at
// D = 128 (fp32 tiles of 72.2 KB), two at D = 256 (103.7 KB); elsewhere the
// registers are left free
template <int D>
__host__ __device__ constexpr int min_blocks() {
  return D == 128 ? 3 : D == 256 ? 2 : 1;
}

// ---------------------------------------------------------- fp32: 3xTF32
// s[j] += Q_w (16 x D) K_j^T for the warp's rows and key n-tile j.  The
// sum over d takes d in any order as long as Q and K agree: over each 16
// d's, thread t's k columns t and t+4 are d = 4t and 4t+1 in the first
// 8-step and 4t+2, 4t+3 in the second, so one 16-byte load brings a row's
// fragments for both steps.
template <int D, int BK>
__device__ __forceinline__ void qk(float (&s)[BK / 8][4], const float* Qw,
                                   const float* Ks, int g, int q) {
  constexpr int LD = D + qk_pad<float, D>();
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 16) {
    const float4 qa = *reinterpret_cast<const float4*>(Qw + g * LD + kk +
                                                       4 * q);
    const float4 qb = *reinterpret_cast<const float4*>(Qw + (g + 8) * LD +
                                                       kk + 4 * q);
    uint32_t ah0[4], al0[4], ah1[4], al1[4];
    split(qa.x, ah0[0], al0[0]);
    split(qb.x, ah0[1], al0[1]);
    split(qa.y, ah0[2], al0[2]);
    split(qb.y, ah0[3], al0[3]);
    split(qa.z, ah1[0], al1[0]);
    split(qb.z, ah1[1], al1[1]);
    split(qa.w, ah1[2], al1[2]);
    split(qb.w, ah1[3], al1[3]);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float4 kb = *reinterpret_cast<const float4*>(
          Ks + (8 * j + g) * LD + kk + 4 * q);
      uint32_t bh[2], bl[2];
      split(kb.x, bh[0], bl[0]);
      split(kb.y, bh[1], bl[1]);
      mma_3xtf32(s[j], ah0, al0, bh, bl);
      split(kb.z, bh[0], bl[0]);
      split(kb.w, bh[1], bl[1]);
      mma_3xtf32(s[j], ah1, al1, bh, bl);
    }
  }
}

// o[j] += P (16 x BK) V (BK x D): the A fragment's column t is key 2t and
// column t+4 key 2t+1 of each 8-key step, V's rows are read in that order
template <int D, int BK>
__device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                   const float (&pm)[BK / 8][4],
                                   const float* Vs, int g, int q) {
  constexpr int LD = D + v_pad<float>();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    uint32_t ah[4], al[4];
    split(pm[kk][0], ah[0], al[0]);    // (row g,   key 2q)
    split(pm[kk][2], ah[1], al[1]);    // (row g+8, key 2q)
    split(pm[kk][1], ah[2], al[2]);    // (row g,   key 2q+1)
    split(pm[kk][3], ah[3], al[3]);    // (row g+8, key 2q+1)
    const float* v = Vs + (8 * kk + 2 * q) * LD + g;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint32_t bh[2], bl[2];
      split(v[8 * j], bh[0], bl[0]);         // key 2q,   column 8j+g
      split(v[LD + 8 * j], bh[1], bl[1]);    // key 2q+1
      mma_3xtf32(o[j], ah, al, bh, bl);
    }
  }
}

// ---------------------------------------------------------- bf16
template <int D, int BK>
__device__ __forceinline__ void qk(float (&s)[BK / 8][4],
                                   const __nv_bfloat16* Qw,
                                   const __nv_bfloat16* Ks, int g, int q) {
  constexpr int LD = D + qk_pad<__nv_bfloat16, D>();
#pragma unroll 4
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    const __nv_bfloat16* ap = Qw + g * LD + kk + 2 * q;
    a[0] = tc::ld_u32(ap);
    a[1] = tc::ld_u32(ap + 8 * LD);
    a[2] = tc::ld_u32(ap + 8);
    a[3] = tc::ld_u32(ap + 8 * LD + 8);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const __nv_bfloat16* bp = Ks + (8 * j + g) * LD + kk + 2 * q;
      uint32_t b[2] = {tc::ld_u32(bp), tc::ld_u32(bp + 8)};
      mma_bf16(s[j], a, b);
    }
  }
}

template <int D, int BK>
__device__ __forceinline__ void pv(float (&o)[D / 8][4],
                                   const float (&pm)[BK / 8][4],
                                   const __nv_bfloat16* Vs, int g, int q) {
  constexpr int LD = D + v_pad<__nv_bfloat16>();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t a[4];
    a[0] = tc::pack_bf16(pm[2 * kk][0], pm[2 * kk][1]);
    a[1] = tc::pack_bf16(pm[2 * kk][2], pm[2 * kk][3]);
    a[2] = tc::pack_bf16(pm[2 * kk + 1][0], pm[2 * kk + 1][1]);
    a[3] = tc::pack_bf16(pm[2 * kk + 1][2], pm[2 * kk + 1][3]);
    const __nv_bfloat16* v = Vs + (16 * kk + 2 * q) * LD + g;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint32_t b[2] = {tc::pack_bf16(v[8 * j], v[LD + 8 * j]),
                       tc::pack_bf16(v[8 * LD + 8 * j], v[9 * LD + 8 * j])};
      mma_bf16(o[j], a, b);
    }
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T, int D>
__host__ __device__ constexpr int smem_bytes() {
  return ((kBQ + key_tile<D>()) * (D + qk_pad<T, D>()) +
          key_tile<D>() * (D + v_pad<T>())) * (int)sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, min_blocks<D>())
flash_fwd_kernel(Params p) {
  constexpr int BK = key_tile<D>();
  constexpr int LQ = D + qk_pad<T, D>(), LV = D + v_pad<T>();
  constexpr int NS = BK / 8;     // S n-tiles (8 keys each) per warp
  constexpr int NO = D / 8;      // O n-tiles per warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [kBQ][LQ]
  T* Ks = Qs + kBQ * LQ;                    // [BK][LQ]
  T* Vs = Ks + BK * LQ;                     // [BK][LV]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const int h = blockIdx.x % p.H;
  const int b = blockIdx.x / p.H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;   // last tiles first
  const int kh = h / (p.H / p.KH);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh +
                q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;
  const bool vec = p.vec != 0;

  // key tiles this query tile needs
  const int nk = (p.Sk + BK - 1) / BK;
  const int qlo = p.q_offset + q0;
  const int qhi = p.q_offset + min(q0 + kBQ, p.Sq) - 1;
  int kt_lo = 0, kt_hi = nk;
  const bool all_rows_have_keys = has_key(qlo, p) && has_key(qhi, p);
  if (all_rows_have_keys) {
    if (p.causal) kt_hi = min(nk, qhi / BK + 1);
    if (p.window) kt_lo = max(0, (qlo - p.window + 1) / BK);
  }

  tc::stage_tile(Qs, LQ, qg, p.q_ss, kBQ, D, p.Sq - q0, D, vec, tid,
                 kThreads);
  tc::stage_tile(Ks, LQ, kg + kt_lo * BK * p.k_ss, p.k_ss, BK, D,
                 p.Sk - kt_lo * BK, D, vec, tid, kThreads);
  tc::cp_async_commit();

  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[j][r] = 0.f;
  float m[2] = {kMasked, kMasked};   // running max, log2 units
  float l[2] = {0.f, 0.f};           // this thread's part of the sum
  const int row0 = q0 + 16 * warp + g;                 // and row0 + 8
  const float sl2 = p.scale * kLog2e;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    tc::cp_async_wait<0>();
    __syncthreads();          // K_kt (and Q) landed; V_kt-1 consumed
    tc::stage_tile(Vs, LV, vg + k0 * p.v_ss, p.v_ss, BK, D, p.Sk - k0, D,
                   vec, tid, kThreads);
    tc::cp_async_commit();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) s[j][r] = 0.f;
    qk<D, BK>(s, Qs + 16 * warp * LQ, Ks, g, q);

    // scores in log2 units; masks only where a mask or Sk cuts the tile
    const bool cut = !all_rows_have_keys || k0 + BK > p.Sk ||
                     (p.causal && k0 + BK - 1 > qlo) ||
                     (p.window && k0 <= qhi - p.window);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float x;
        if (p.softcap > 0.f)
          x = p.softcap * tanhf(s[j][r] * p.scale / p.softcap) * kLog2e;
        else
          x = s[j][r] * sl2;
        if (cut) {
          const int kpos = k0 + 8 * j + 2 * q + (r & 1);
          const int qpos = p.q_offset + row0 + 8 * (r >> 1);
          bool keep = true;
          if (p.causal) keep = keep && kpos <= qpos;
          if (p.window) keep = keep && kpos > qpos - p.window;
          if (!keep) x = kMasked;
          if (kpos >= p.Sk) x = neg_infinity();   // absent: weight 0
        }
        s[j][r] = x;
      }

    // online softmax over the quad that shares a row
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = neg_infinity();
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * hr], s[j][2 * hr + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hr], mx);        // >= -1e30: finite
      const float alpha = exp2f(m[hr] - m_new);
      m[hr] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        s[j][2 * hr] = exp2f(s[j][2 * hr] - m_new);
        s[j][2 * hr + 1] = exp2f(s[j][2 * hr + 1] - m_new);
        sum += s[j][2 * hr] + s[j][2 * hr + 1];
      }
      l[hr] = l[hr] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * hr] *= alpha;
        o[j][2 * hr + 1] *= alpha;
      }
    }

    tc::cp_async_wait<0>();
    __syncthreads();          // V_kt landed; K_kt consumed
    if (kt + 1 < kt_hi)
      tc::stage_tile(Ks, LQ, kg + (k0 + BK) * p.k_ss, p.k_ss, BK, D,
                     p.Sk - k0 - BK, D, vec, tid, kThreads);
    tc::cp_async_commit();
    pv<D, BK>(o, s, Vs, g, q);
  }

  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    float lt = l[hr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = row0 + 8 * hr;
    if (row >= p.Sq) continue;
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    T* orow = og + (((long long)b * p.Sq + row) * p.H + h) * D + 2 * q;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      store2(orow + 8 * j, o[j][2 * hr] * inv, o[j][2 * hr + 1] * inv);
    if (p.lse != nullptr && q == 0)
      p.lse[((long long)b * p.H + h) * p.Sq + row] =
          (m[hr] + log2f(fmaxf(lt, 1e-30f))) * kLn2;
  }
}

template <typename T, int D>
int launch(const Params& p, void* stream) {
  constexpr int smem = smem_bytes<T, D>();
  auto kern = flash_fwd_kernel<T, D>;
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.B * p.H, (p.Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(Params p, int D, void* stream) {
  // 16-byte copies need every row of q, k and v 16-byte aligned
  constexpr int V = 16 / sizeof(T);
  const long long strides[9] = {p.q_sb, p.q_ss, p.q_sh, p.k_sb, p.k_ss,
                                p.k_sh, p.v_sb, p.v_ss, p.v_sh};
  bool vec = (uintptr_t)p.q % 16 == 0 && (uintptr_t)p.k % 16 == 0 &&
             (uintptr_t)p.v % 16 == 0;
  for (long long s : strides) vec = vec && s % V == 0;
  p.vec = vec;
  switch (D) {
    case 32: return launch<T, 32>(p, stream);
    case 48: return launch<T, 48>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    case 256: return launch<T, 256>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype 0 = float32, 1 = bf16.
// Strides are in elements, [batch, seq, head] for each of q, k, v; lse may
// be null (no log-sum-exp written).
// Returns the cudaGetLastError() code of the launch (or of raising the
// dynamic shared-memory limit); the wrapper raises on non-zero.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   const long long* strides, int dtype,
                                   int B, int Sq, int Sk, int H, int KH,
                                   int D, int causal, int window,
                                   int q_offset, float scale,
                                   float softcap, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out; p.lse = lse;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KH = KH;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.vec = 0;
  p.scale = scale;
  p.softcap = softcap;
  return dtype == 0 ? dispatch<float>(p, D, stream)
                    : dispatch<__nv_bfloat16>(p, D, stream);
}
