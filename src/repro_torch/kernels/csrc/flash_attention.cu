// Online-softmax (flash) attention forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention, the
// Pallas TPU kernel (grid (B*H, nq, nk) with the kv axis innermost, running
// max / denominator / accumulator in VMEM scratch across kv steps), which
// the JAX LM stack's blockwise_attention (models/layers.py) mirrors in jnp.
// Same contract: causal and sliding-window masks, GQA (query head h reads
// kv head h / G), tanh logit softcap, masked scores at -1e30, float32
// statistics and accumulator, output in the input dtype.
//
// Layout: q (B, Sq, H, D) and k, v (B, Sk, KH, D), the model's own layout,
// read through element strides (the last dimension must be contiguous), so
// the wrapper makes no transposed copy.  out is (B, Sq, H, D) contiguous.
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
// GFLOP per layer against 50 MB of q/k/v/o: about 1,400 flops per byte, far
// above the fp32 ridge (67 TFLOP/s over 3.35 TB/s, 20 flops per byte), so
// it is bound by operations: 1.03 ms at the fp32 CUDA-core peak.  No
// tensor cores yet: the JAX bar is 2e-4 in fp32, which TF32 products would
// miss; a bf16 wgmma version is a perf PR's work.
//
// Design (right and simple first):
// - one block of 128 threads per (b, h, BQ-row query tile); it loops over
//   BK-row key tiles, staged in shared memory as float (converted once);
// - tiles are sized by D so that shared memory stays near 64-105 KB:
//   D = 64: 64 x 64; D = 128: 64 x 32; D = 256: 32 x 32.  Above 48 KB the
//   launch opts in to dynamic shared memory;
// - q and k are stored transposed ([d][row], padded by one word) so the
//   S = Q K^T loop reads consecutive words; each thread owns an
//   (BQ/8) x (BK/16) micro-tile of S and an (BQ/8) x (D/16) micro-tile of
//   the output accumulator, in registers;
// - per key tile, BQ rows' max and sum are reduced by 128/BQ threads each
//   (warp shuffles), p = exp(s - m_new) overwrites S in shared memory, and
//   the accumulator is rescaled by alpha = exp(m_prev - m_new);
// - key tiles wholly outside the causal or window range of every row of
//   the query tile are skipped, unless some row of the tile has no valid
//   key at all (then every tile runs, so that row averages v as the
//   reference does).
#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;       // 8 row groups x 16 column lanes
constexpr float kNegInf = -1e30f;   // NEG_INF of the JAX package

__device__ __forceinline__ float neg_infinity() {
  return -__int_as_float(0x7f800000);
}
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  int B, Sq, Sk, H, KH;
  long long q_sb, q_ss, q_sh;   // element strides of q: batch, seq, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  int causal, window, q_offset;
  float scale, softcap;
};

// Does the query at absolute position qpos have at least one valid key?
__device__ __forceinline__ bool has_key(int qpos, const Params& p) {
  const int lo = p.window ? max(qpos - p.window + 1, 0) : 0;
  const int hi = p.causal ? min(qpos, p.Sk - 1) : p.Sk - 1;
  return lo <= hi;
}

template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p) {
  constexpr int RI = BQ / 8;          // rows per thread (stride 8)
  constexpr int CJ = BK / 16;         // S columns per thread (stride 16)
  constexpr int DJ = D / 16;          // output columns per thread
  constexpr int TPR = kThreads / BQ;  // threads per row in the softmax
  constexpr int CPT = BK / TPR;       // columns each of them reduces
  extern __shared__ float smem[];
  float* qs = smem;                   // [D][BQ + 1]  q transposed
  float* ks = qs + D * (BQ + 1);      // [D][BK + 1]  k transposed
  float* vs = ks + D * (BK + 1);      // [BK][D]
  float* ss = vs + BK * D;            // [BQ][BK + 1] scores, then p
  float* m_s = ss + BQ * (BK + 1);    // [BQ] running max
  float* l_s = m_s + BQ;              // [BQ] running denominator
  float* a_s = l_s + BQ;              // [BQ] this tile's rescale

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (p.H / p.KH);
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  // stage the query tile (rows past Sq read 0 and are never stored)
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    qs[d * (BQ + 1) + r] =
        (q0 + r < p.Sq) ? load_f(qg + (q0 + r) * p.q_ss + d) : 0.f;
  }
  for (int r = tid; r < BQ; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // key tiles this query tile needs
  const int nk = (p.Sk + BK - 1) / BK;
  const int qlo = p.q_offset + q0;
  const int qhi = p.q_offset + min(q0 + BQ, p.Sq) - 1;
  int kt_lo = 0, kt_hi = nk;
  if (has_key(qlo, p) && has_key(qhi, p)) {   // every row has a key
    if (p.causal) kt_hi = min(nk, qhi / BK + 1);
    if (p.window) kt_lo = max(0, (qlo - p.window + 1) / BK);
  }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                  // last tile's ks / vs / ss consumed
    for (int idx = tid; idx < BK * D; idx += kThreads) {
      const int c = idx / D, d = idx % D;
      const bool in = k0 + c < p.Sk;
      ks[d * (BK + 1) + c] = in ? load_f(kg + (k0 + c) * p.k_ss + d) : 0.f;
      vs[c * D + d] = in ? load_f(vg + (k0 + c) * p.v_ss + d) : 0.f;
    }
    __syncthreads();

    // S = Q K^T on this thread's micro-tile
    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = qs[d * (BQ + 1) + ty + 8 * i];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = ks[d * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 8 * i;
      const int qpos = p.q_offset + q0 + r;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool keep = true;
        if (p.causal) keep = keep && kpos <= qpos;
        if (p.window) keep = keep && kpos > qpos - p.window;
        if (!keep) x = kNegInf;
        if (kpos >= p.Sk) x = neg_infinity();     // absent: weight exactly 0
        ss[r * (BK + 1) + c] = x;
      }
    }
    __syncthreads();

    // online softmax: TPR threads per row
    {
      const int r = tid / TPR;
      const int part = tid % TPR;
      float* row = ss + r * (BK + 1) + part * CPT;
      float mx = neg_infinity();
      for (int c = 0; c < CPT; ++c) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);   // >= -1e30: finite
      float sum = 0.f;
      for (int c = 0; c < CPT; ++c) {
        const float e = expf(row[c] - m_new);
        row[c] = e;
        sum += e;
      }
#pragma unroll
      for (int off = TPR / 2; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float al = a_s[ty + 8 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= al;
    }
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      float pv[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = ss[(ty + 8 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  T* og = static_cast<T*>(p.out);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 8 * i;
    if (q0 + r >= p.Sq) continue;
    const float inv = 1.f / fmaxf(l_s[r], 1e-30f);
    T* orow = og + (((long long)b * p.Sq + q0 + r) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store_f(orow + tx + 16 * j, acc[i][j] * inv);
  }
}

template <typename T, int D, int BQ, int BK>
int launch(const Params& p, void* stream) {
  const size_t smem = sizeof(float) * ((size_t)D * (BQ + 1) +
                                       (size_t)D * (BK + 1) + (size_t)BK * D +
                                       (size_t)BQ * (BK + 1) + 3 * BQ);
  auto kern = flash_fwd_kernel<T, D, BQ, BK>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Params& p, int D, void* stream) {
  switch (D) {
    case 64: return launch<T, 64, 64, 64>(p, stream);
    case 128: return launch<T, 128, 64, 32>(p, stream);
    case 256: return launch<T, 256, 32, 32>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype 0 = float32, 1 = bf16.
// Strides are in elements, [batch, seq, head] for each of q, k, v.
// Returns the cudaGetLastError() code of the launch (or of raising the
// dynamic shared-memory limit); the wrapper raises on non-zero.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out,
                                   const long long* strides, int dtype,
                                   int B, int Sq, int Sk, int H, int KH,
                                   int D, int causal, int window,
                                   int q_offset, float scale,
                                   float softcap, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.out = out;
  p.B = B; p.Sq = Sq; p.Sk = Sk; p.H = H; p.KH = KH;
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.scale = scale;
  p.softcap = softcap;
  return dtype == 0 ? dispatch<float>(p, D, stream)
                    : dispatch<__nv_bfloat16>(p, D, stream);
}
