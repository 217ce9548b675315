// RG-LRU linear recurrence for Hopper (sm_90a): h_t = a_t * h_{t-1} + b_t
// along the sequence, from h = 0, every channel independent.
//
// Replaces: src/repro/kernels/rglru_scan.py::rglru_scan_pallas, the Pallas
// TPU kernel (channels on the lanes, time sequential in a fori_loop, the
// carried state in VMEM scratch across sequence chunks), whose jnp oracle
// is the associative scan in src/repro/models/rglru.py::rglru_scan.  Same
// contract: a, b (B, S, C) float32 -> h (B, S, C) float32.
//
// What bounds it on the H100: the function reads a and b once and writes h
// once, 12*B*S*C bytes, with two flops per element: bound by bytes.  At
// recurrentgemma-2b's prefill (B=1, S=4096, C=2560) that is 126 MB, 0.038
// ms at 3.35 TB/s.  This design reads a and b twice (20 bytes an element),
// a floor of 0.063 ms at that shape.
//
// Design: a chunked scan.  One thread per (b, c) walking all of S leaves
// only B*C chains (2,560 at the prefill, 20 blocks on 132 SMs) of S
// dependent steps each, with too few loads in flight to fill the card.  So
// S is cut into chunks of kChunk = 64 steps (the last one ragged), and
// every (b, chunk, c) is a thread of its own: 64 x 2,560 = 163,840 threads
// at the prefill, 1,280 blocks.  Two launches:
// 1. rglru_chunk_summary_kernel, chunks 0 .. nc-2: from h = 0, the chunk's
//    product of a (P) and its local end state (H), into a (B, nc-1, C)
//    scratch each;
// 2. rglru_chunk_scan_kernel, every chunk: folds the summaries of the
//    chunks before it, in chunk order, into its carried-in state
//    (carry = H_0, then carry = P_j * carry + H_j for j = 1 .. k-1), then
//    re-runs the chunk from that state and writes h.
// The second launch reads what the first wrote, in stream order: nothing
// races, and no block waits for another.  Neighbouring threads take
// neighbouring channels, so every load and store of a warp is one
// coalesced row segment; the loads of kUnroll steps are issued before
// their products.  (Four channels a thread with 16-byte loads, a quarter of
// the threads, measured 17% slower on the H100.)  The scan launch takes the
// chunks in reverse block order, so its first blocks read what the summary
// launch read last, while it may still be in L2.
//
// Bits: every step rounds the product and then the sum (__fmul_rn /
// __fadd_rn: no fused multiply-add), and the association is fixed by
// (S, kChunk) alone: not by B, C, timing or which block finishes first.
// Two runs give the same bits; a row alone equals the same row inside a
// batch.  Chunk 0 is the plain loop (kernels/ref.py::rglru_scan_ref) bit
// for bit; later chunks differ from it by the rounding of the carried
// state.  With a single chunk (S <= 64) only the scan launch runs, from
// h = 0: the plain loop exactly.
//
// The backward (rglru_scan_bwd_f32) is the same design run backwards in
// time.  The gradient of h_t = a_t h_{t-1} + b_t under dh is the reverse
// recurrence c_t = dh_t + a_{t+1} c_{t+1} (a_S = 0, so c_{S-1} = dh_{S-1}),
// with db_t = c_t and da_t = c_t h_{t-1} (h_{-1} = 0): what JAX takes by
// differentiating the associative scan of src/repro/models/rglru.py.
// 1. rglru_bwd_summary_kernel, chunks 1 .. nc-1: from c = 0 past the
//    chunk's end, the product of the a_{t+1} it multiplies by and its
//    local c at the chunk's first step;
// 2. rglru_bwd_scan_kernel, every chunk: folds the summaries of the chunks
//    after it, last first, into the c carried in from the next chunk,
//    then re-runs the chunk from its last step down and writes da and db.
// It reads a (shifted by one step), h and dh and writes da and db, 20
// bytes an element (a floor of 0.063 ms at recurrentgemma-2b's layer);
// the summaries read a and dh once more.  The association is fixed by
// (S, kChunk) alone, so two runs give the same bits, and the last chunk
// is the plain reverse loop (kernels/ref.py::rglru_scan_bwd_ref) bit for
// bit.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;
constexpr int kThreads = 128;
constexpr int kUnroll = 16;
static_assert(kChunk % kUnroll == 0, "a full chunk is whole unroll steps");

// h <- a_t * h + b_t over steps [t0, t1) of one channel (row stride C);
// writes h_t where kWrite, multiplies the a_t into *prod where kProd.
template <bool kWrite, bool kProd>
__device__ __forceinline__ float run(const float* __restrict__ ap,
                                     const float* __restrict__ bp,
                                     float* __restrict__ hp, size_t C,
                                     int t0, int t1, float h, float* prod) {
  float p = 1.f;
  int t = t0;
  for (; t + kUnroll <= t1; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = ap[(size_t)(t + u) * C];
      bv[u] = bp[(size_t)(t + u) * C];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      if (kProd) p = __fmul_rn(p, av[u]);
      if (kWrite) hp[(size_t)(t + u) * C] = h;
    }
  }
  for (; t < t1; ++t) {
    const float av = ap[(size_t)t * C];
    h = __fadd_rn(__fmul_rn(av, h), bp[(size_t)t * C]);
    if (kProd) p = __fmul_rn(p, av);
    if (kWrite) hp[(size_t)t * C] = h;
  }
  if (kProd) *prod = p;
  return h;
}

// grid (ceil(C / kThreads), nc - 1, B): chunk k = blockIdx.y, a full chunk
__global__ void __launch_bounds__(kThreads)
rglru_chunk_summary_kernel(const float* __restrict__ a,
                           const float* __restrict__ b,
                           float* __restrict__ P, float* __restrict__ H,
                           int S, int C, int nc) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int k = blockIdx.y, bi = blockIdx.z;
  const size_t base = (size_t)bi * S * C + c;
  float p;
  const float h = run<false, true>(a + base, b + base, nullptr, C,
                                   k * kChunk, (k + 1) * kChunk, 0.f, &p);
  const size_t s = ((size_t)bi * (nc - 1) + k) * C + c;
  P[s] = p;
  H[s] = h;
}

// grid (ceil(C / kThreads), nc, B): chunk k = nc - 1 - blockIdx.y
__global__ void __launch_bounds__(kThreads)
rglru_chunk_scan_kernel(const float* __restrict__ a,
                        const float* __restrict__ b,
                        const float* __restrict__ P,
                        const float* __restrict__ H, float* __restrict__ h,
                        int S, int C, int nc) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int k = nc - 1 - blockIdx.y, bi = blockIdx.z;
  float carry = 0.f;
  if (k > 0) {
    // the carried-in state, folded in chunk order from the summaries
    const float* Pp = P + (size_t)bi * (nc - 1) * C + c;
    const float* Hp = H + (size_t)bi * (nc - 1) * C + c;
    carry = Hp[0];
    int j = 1;
    for (; j + kUnroll <= k; j += kUnroll) {
      float pv[kUnroll], hv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        pv[u] = Pp[(size_t)(j + u) * C];
        hv[u] = Hp[(size_t)(j + u) * C];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        carry = __fadd_rn(__fmul_rn(pv[u], carry), hv[u]);
    }
    for (; j < k; ++j)
      carry = __fadd_rn(__fmul_rn(Pp[(size_t)j * C], carry),
                        Hp[(size_t)j * C]);
  }
  const size_t base = (size_t)bi * S * C + c;
  run<true, false>(a + base, b + base, h + base, C, k * kChunk,
                   min(S, (k + 1) * kChunk), carry, nullptr);
}

// ---------------------------------------------------------- backward
// c <- a_{t+1} * c + dh_t for t = t1-1 down to t0 of one channel (a_S = 0);
// writes db_t = c and da_t = c * h_{t-1} where kWrite, multiplies the
// a_{t+1} into *prod where kProd.
template <bool kWrite, bool kProd>
__device__ __forceinline__ float run_back(const float* __restrict__ ap,
                                          const float* __restrict__ hp,
                                          const float* __restrict__ dhp,
                                          float* __restrict__ dap,
                                          float* __restrict__ dbp, size_t C,
                                          int S, int t0, int t1, float c,
                                          float* prod) {
  float p = 1.f;
  int t = t1 - 1;
  for (; t - kUnroll + 1 >= t0; t -= kUnroll) {
    float av[kUnroll], dv[kUnroll], hv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t - u;
      av[u] = tt + 1 < S ? ap[(size_t)(tt + 1) * C] : 0.f;
      dv[u] = dhp[(size_t)tt * C];
      if (kWrite) hv[u] = tt > 0 ? hp[(size_t)(tt - 1) * C] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int tt = t - u;
      c = __fadd_rn(__fmul_rn(av[u], c), dv[u]);
      if (kProd) p = __fmul_rn(p, av[u]);
      if (kWrite) {
        dbp[(size_t)tt * C] = c;
        dap[(size_t)tt * C] = __fmul_rn(c, hv[u]);
      }
    }
  }
  for (; t >= t0; --t) {
    const float av = t + 1 < S ? ap[(size_t)(t + 1) * C] : 0.f;
    c = __fadd_rn(__fmul_rn(av, c), dhp[(size_t)t * C]);
    if (kProd) p = __fmul_rn(p, av);
    if (kWrite) {
      dbp[(size_t)t * C] = c;
      dap[(size_t)t * C] = __fmul_rn(c, t > 0 ? hp[(size_t)(t - 1) * C]
                                              : 0.f);
    }
  }
  if (kProd) *prod = p;
  return c;
}

// grid (ceil(C / kThreads), nc - 1, B): chunk k = blockIdx.y + 1, its
// summary at index k - 1
__global__ void __launch_bounds__(kThreads)
rglru_bwd_summary_kernel(const float* __restrict__ a,
                         const float* __restrict__ dh,
                         float* __restrict__ P, float* __restrict__ H,
                         int S, int C, int nc) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int k = blockIdx.y + 1, bi = blockIdx.z;
  const size_t base = (size_t)bi * S * C + c;
  float p;
  const float h = run_back<false, true>(
      a + base, nullptr, dh + base, nullptr, nullptr, C, S, k * kChunk,
      min(S, (k + 1) * kChunk), 0.f, &p);
  const size_t s = ((size_t)bi * (nc - 1) + k - 1) * C + c;
  P[s] = p;
  H[s] = h;
}

// grid (ceil(C / kThreads), nc, B): chunk k = blockIdx.y (the first chunks,
// which fold the most summaries, start first)
__global__ void __launch_bounds__(kThreads)
rglru_bwd_scan_kernel(const float* __restrict__ a,
                      const float* __restrict__ h,
                      const float* __restrict__ dh,
                      const float* __restrict__ P,
                      const float* __restrict__ H, float* __restrict__ da,
                      float* __restrict__ db, int S, int C, int nc) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const int k = blockIdx.y, bi = blockIdx.z;
  float carry = 0.f;
  if (k < nc - 1) {
    // c at the first step of chunk k + 1, folded from the last chunk down:
    // chunk j's summary sits at index j - 1
    const float* Pp = P + (size_t)bi * (nc - 1) * C + c;
    const float* Hp = H + (size_t)bi * (nc - 1) * C + c;
    carry = Hp[(size_t)(nc - 2) * C];
    int j = nc - 2;                   // the next chunk to fold
    for (; j - kUnroll + 1 >= k + 1; j -= kUnroll) {
      float pv[kUnroll], hv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        pv[u] = Pp[(size_t)(j - 1 - u) * C];
        hv[u] = Hp[(size_t)(j - 1 - u) * C];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        carry = __fadd_rn(__fmul_rn(pv[u], carry), hv[u]);
    }
    for (; j >= k + 1; --j)
      carry = __fadd_rn(__fmul_rn(Pp[(size_t)(j - 1) * C], carry),
                        Hp[(size_t)(j - 1) * C]);
  }
  const size_t base = (size_t)bi * S * C + c;
  run_back<true, false>(a + base, h + base, dh + base, da + base, db + base,
                        C, S, k * kChunk, min(S, (k + 1) * kChunk), carry,
                        nullptr);
}

}  // namespace

// Plain C entry point (bound with ctypes).  P and H are the wrapper's
// (B, nc-1, C) scratch (unused with one chunk); chunk must be kChunk (the
// wrapper's CHUNK).  Returns the cudaGetLastError() code of the launches;
// the wrapper raises on non-zero.
extern "C" int rglru_scan_f32(const void* a, const void* b, void* h, void* P,
                              void* H, int B, int S, int C, int chunk,
                              void* stream) {
  if (chunk != kChunk) return (int)cudaErrorInvalidValue;
  const int nc = (S + kChunk - 1) / kChunk;
  const int cb = (C + kThreads - 1) / kThreads;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  float* Pf = static_cast<float*>(P);
  float* Hf = static_cast<float*>(H);
  if (nc > 1) {
    rglru_chunk_summary_kernel<<<dim3(cb, nc - 1, B), kThreads, 0, st>>>(
        af, bf, Pf, Hf, S, C, nc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rglru_chunk_scan_kernel<<<dim3(cb, nc, B), kThreads, 0, st>>>(
      af, bf, Pf, Hf, static_cast<float*>(h), S, C, nc);
  return (int)cudaGetLastError();
}

// Plain C entry point of the backward (bound with ctypes): a, h (the
// forward's output) and dh (B, S, C) float32 in, da and db out; P and H are
// the wrapper's (B, nc-1, C) scratch (unused with one chunk).  Returns the
// cudaGetLastError() code of the launches.
extern "C" int rglru_scan_bwd_f32(const void* a, const void* h,
                                  const void* dh, void* da, void* db,
                                  void* P, void* H, int B, int S, int C,
                                  int chunk, void* stream) {
  if (chunk != kChunk) return (int)cudaErrorInvalidValue;
  const int nc = (S + kChunk - 1) / kChunk;
  const int cb = (C + kThreads - 1) / kThreads;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* af = static_cast<const float*>(a);
  const float* dhf = static_cast<const float*>(dh);
  float* Pf = static_cast<float*>(P);
  float* Hf = static_cast<float*>(H);
  if (nc > 1) {
    rglru_bwd_summary_kernel<<<dim3(cb, nc - 1, B), kThreads, 0, st>>>(
        af, dhf, Pf, Hf, S, C, nc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  rglru_bwd_scan_kernel<<<dim3(cb, nc, B), kThreads, 0, st>>>(
      af, static_cast<const float*>(h), dhf, Pf, Hf, static_cast<float*>(da),
      static_cast<float*>(db), S, C, nc);
  return (int)cudaGetLastError();
}
