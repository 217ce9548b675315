// Mamba-2 chunked SSD scan for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd_scan.py::ssd_scan, the Pallas TPU kernel
// (grid (B, H, nchunks) with the chunk axis innermost and the carried (P, N)
// state in VMEM scratch), whose jnp form is repro/models/ssm.py::ssd_chunked.
// Same contract: x (B, S, H, P), dt (B, S, H), A (H,), B and C (B, S, N) —
// one group shared by every head — float32, the state starting at zero,
// S a multiple of the chunk length Q; y (B, S, H, P) float32.
//
// Per (b, h) and per chunk of Q steps, with cum = cumsum(dt * A):
//   L[i, j]  = exp(cum_i - cum_j) for j <= i, else 0 (masked before the
//              exponential: above the diagonal the exponent is positive and
//              would overflow, and inf * 0 is NaN);
//   y        = ((C B^T) o L o dt_j) x + exp(cum) o (C state^T);
//   state   <- exp(cum_Q) state + ((exp(cum_Q - cum) dt) o x)^T B.
// All four products run here, on the CUDA cores in fp32 FMA chains.
//
// Layout: x and dt are read in the model's own layout through element
// strides (x's last dimension contiguous), B and C through their batch and
// sequence strides, so the wrapper makes no transposed copy; y is written
// contiguous in (B, S, H, P).
//
// What bounds it on the H100: the work the function needs is the scores
// times x per head over the Q(Q+1)/2 causal pairs of a chunk (times P), C B^T
// once per (b, chunk) over the same pairs (times N), and Q*N*P each for
// C state^T (every chunk but the first, whose state is zero) and x^T B
// (every chunk but the last, whose state nothing reads).  At mamba2-2.7b's
// prefill (B=1, S=4096, H=80, P=64, N=128, Q=128) that is 13.2 GFLOP
// against 173 MB of operands: bound by operations, 0.197 ms at the
// 67 TFLOP/s fp32 peak.
//
// Design (right and simple first):
// - one block of 256 threads per (b, h); it walks the chunks in order and
//   carries the (P, N) state in shared memory, so nothing crosses blocks;
// - a chunk's C, B (Q x N, rows padded to N + 1 words), x (Q x P), dt, the
//   inclusive cumsum (one warp, shuffles) and the state-update weights are
//   staged in shared memory; the Q x Q scores are never whole: they are
//   built 32 key columns at a time (Q x 33 words), so at Q = 128, N = 128,
//   P = 64 the block holds 216 KB, under the 227 KB a block may opt in to;
// - each thread owns a strided 8 x 4 micro-tile of y (rows ty + 16r,
//   columns tx + 16c) in registers across the chunk, an 8 x 2 micro-tile of
//   each score tile, and a 4 x 8 micro-tile of the state update; a score
//   tile's rows that lie wholly above the diagonal are skipped;
// - C B^T is recomputed per head, as the Pallas kernel does; with B = 1
//   only H = 80 blocks run on 132 SMs.  Sharing C B^T across heads and
//   splitting the chunks across blocks (chunk states first, then a short
//   scan over them) is a perf PR's work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;     // 16 row groups (ty) x 16 lanes (tx)
constexpr int kMaxQ = 128;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kJT = 32;           // key columns of one score tile
constexpr int kR = kMaxQ / 16;    // y and score rows per thread
constexpr int kC = kMaxP / 16;    // y columns per thread
constexpr int kSC = kJT / 16;     // score columns per thread
constexpr int kSA = kMaxP / 16;   // state rows (p) per thread
constexpr int kSB = kMaxN / 16;   // state columns (n) per thread

struct Params {
  const float* x;
  const float* dt;
  const float* A;
  const float* Bm;
  const float* Cm;
  float* y;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long b_sb, b_ss;
  long long c_sb, c_ss;
  int S, H, P, N, Q;
};

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const Params p) {
  extern __shared__ float smem[];
  const int Q = p.Q, P = p.P, N = p.N;
  const int NS = N + 1;             // padded row of C, B and the state
  const int TS = kJT + 1;           // padded row of the score tile
  float* Cs = smem;                 // [Q][NS]
  float* Bs = Cs + Q * NS;          // [Q][NS]
  float* xs = Bs + Q * NS;          // [Q][P]
  float* St = xs + Q * P;           // [P][NS] the carried state
  float* Ss = St + P * NS;          // [Q][TS] one score tile
  float* dts = Ss + Q * TS;         // [Q] dt
  float* cums = dts + Q;            // [Q] inclusive cumsum of dt * A
  float* ws = cums + Q;             // [Q] exp(cum_Q - cum) * dt

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const float Ah = p.A[h];
  const float* xb = p.x + b * p.x_sb + h * p.x_sh;
  const float* dtb = p.dt + b * p.dt_sb + h * p.dt_sh;
  const float* Bb = p.Bm + b * p.b_sb;
  const float* Cb = p.Cm + b * p.c_sb;
  const long long y_ss = (long long)p.H * P;
  float* yb = p.y + ((long long)b * p.S * p.H + h) * P;

  // rows and columns this thread owns, clamped into range: a clamped
  // index only ever feeds a result that is not written
  int ri[kR], yc[kC], sa[kSA], sb[kSB];
#pragma unroll
  for (int r = 0; r < kR; ++r) ri[r] = min(ty + 16 * r, Q - 1);
#pragma unroll
  for (int c = 0; c < kC; ++c) yc[c] = min(tx + 16 * c, P - 1);
#pragma unroll
  for (int a = 0; a < kSA; ++a) sa[a] = min(ty + 16 * a, P - 1);
#pragma unroll
  for (int e = 0; e < kSB; ++e) sb[e] = min(tx + 16 * e, N - 1);

  for (int k = tid; k < P * NS; k += kThreads) St[k] = 0.f;

  for (int c0 = 0; c0 < p.S; c0 += Q) {
    // ---- stage the chunk
    for (int k = tid; k < Q * P; k += kThreads) {
      const int j = k / P, pp = k - j * P;
      xs[k] = xb[(long long)(c0 + j) * p.x_ss + pp];
    }
    for (int k = tid; k < Q * N; k += kThreads) {
      const int j = k / N, n = k - j * N;
      Bs[j * NS + n] = Bb[(long long)(c0 + j) * p.b_ss + n];
      Cs[j * NS + n] = Cb[(long long)(c0 + j) * p.c_ss + n];
    }
    for (int j = tid; j < Q; j += kThreads)
      dts[j] = dtb[(long long)(c0 + j) * p.dt_ss];
    __syncthreads();

    // ---- cum = inclusive cumsum of dt * A: one warp, 4 steps a lane
    if (tid < 32) {
      float v[4];
      float run = 0.f;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = tid * 4 + u;
        run += (j < Q) ? dts[j] * Ah : 0.f;
        v[u] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      const float off = incl - run;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = tid * 4 + u;
        if (j < Q) cums[j] = off + v[u];
      }
    }
    __syncthreads();
    const float total = cums[Q - 1];
    for (int j = tid; j < Q; j += kThreads)
      ws[j] = expf(total - cums[j]) * dts[j];   // read after later barriers

    // ---- y = exp(cum) o (C state^T): the carried state's part
    float acc[kR][kC];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[r][c] = 0.f;
    if (c0 > 0) {                   // the first chunk starts from zero
      for (int n = 0; n < N; ++n) {
        float cv[kR], sv[kC];
#pragma unroll
        for (int r = 0; r < kR; ++r) cv[r] = Cs[ri[r] * NS + n];
#pragma unroll
        for (int c = 0; c < kC; ++c) sv[c] = St[yc[c] * NS + n];
#pragma unroll
        for (int r = 0; r < kR; ++r)
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[r][c] = fmaf(cv[r], sv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float e = expf(cums[ri[r]]);
#pragma unroll
        for (int c = 0; c < kC; ++c) acc[r][c] *= e;
      }
    }

    // ---- y += ((C B^T) o L o dt_j) x, one tile of kJT keys at a time
    for (int j0 = 0; j0 < Q; j0 += kJT) {
      const int r0 = j0 / 16;       // rows ty + 16r with r < r0 lie above
      const int jn = min(kJT, Q - j0);
      int jc[kSC];
#pragma unroll
      for (int c = 0; c < kSC; ++c) jc[c] = min(j0 + tx + 16 * c, Q - 1);
      float s[kR][kSC];
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int c = 0; c < kSC; ++c) s[r][c] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[kR], bv[kSC];
#pragma unroll
        for (int r = 0; r < kR; ++r) cv[r] = r < r0 ? 0.f : Cs[ri[r] * NS + n];
#pragma unroll
        for (int c = 0; c < kSC; ++c) bv[c] = Bs[jc[c] * NS + n];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r < r0) continue;
#pragma unroll
          for (int c = 0; c < kSC; ++c) s[r][c] = fmaf(cv[r], bv[c], s[r][c]);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int i = ty + 16 * r;
        if (r < r0 || i >= Q) continue;
#pragma unroll
        for (int c = 0; c < kSC; ++c) {
          const int j = j0 + tx + 16 * c;
          float v = 0.f;
          if (j <= i) v = s[r][c] * expf(cums[i] - cums[j]) * dts[j];
          Ss[i * TS + tx + 16 * c] = v;
        }
      }
      __syncthreads();
      for (int jj = 0; jj < jn; ++jj) {
        float sv[kR], xv[kC];
#pragma unroll
        for (int r = 0; r < kR; ++r) sv[r] = r < r0 ? 0.f : Ss[ri[r] * TS + jj];
#pragma unroll
        for (int c = 0; c < kC; ++c) xv[c] = xs[(j0 + jj) * P + yc[c]];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          if (r < r0) continue;
#pragma unroll
          for (int c = 0; c < kC; ++c) acc[r][c] = fmaf(sv[r], xv[c], acc[r][c]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int i = ty + 16 * r;
      if (i >= Q) continue;
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int pc = tx + 16 * c;
        if (pc < P) yb[(long long)(c0 + i) * y_ss + pc] = acc[r][c];
      }
    }

    // ---- state <- exp(cum_Q) state + ((exp(cum_Q - cum) dt) o x)^T B
    if (c0 + Q < p.S) {             // the last chunk's state is not returned
      float ds[kSA][kSB];
#pragma unroll
      for (int a = 0; a < kSA; ++a)
#pragma unroll
        for (int e = 0; e < kSB; ++e) ds[a][e] = 0.f;
      for (int j = 0; j < Q; ++j) {
        const float wj = ws[j];
        float xv[kSA], bv[kSB];
#pragma unroll
        for (int a = 0; a < kSA; ++a) xv[a] = wj * xs[j * P + sa[a]];
#pragma unroll
        for (int e = 0; e < kSB; ++e) bv[e] = Bs[j * NS + sb[e]];
#pragma unroll
        for (int a = 0; a < kSA; ++a)
#pragma unroll
          for (int e = 0; e < kSB; ++e) ds[a][e] = fmaf(xv[a], bv[e], ds[a][e]);
      }
      const float decay = expf(total);
#pragma unroll
      for (int a = 0; a < kSA; ++a) {
        const int pa = ty + 16 * a;
        if (pa >= P) continue;
#pragma unroll
        for (int e = 0; e < kSB; ++e) {
          const int nb = tx + 16 * e;
          if (nb < N) St[pa * NS + nb] = decay * St[pa * NS + nb] + ds[a][e];
        }
      }
    }
    __syncthreads();                // before the next chunk is staged
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Strides are in elements:
// x [batch, seq, head], dt [batch, seq, head], B [batch, seq],
// C [batch, seq].  Returns the cudaGetLastError() code of the launch (or of
// raising the dynamic shared-memory limit, or cudaErrorInvalidValue for a
// shape the kernel does not take); the wrapper raises on non-zero.
extern "C" int ssd_scan_f32(const void* x, const void* dt, const void* A,
                            const void* Bm, const void* Cm, void* y,
                            const long long* strides, int B, int S, int H,
                            int P, int N, int Q, void* stream) {
  if (Q < 1 || Q > kMaxQ || P < 1 || P > kMaxP || N < 1 || N > kMaxN ||
      S % Q != 0 || B < 1 || B > 65535 || H < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const float*>(x);
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.Bm = static_cast<const float*>(Bm);
  p.Cm = static_cast<const float*>(Cm);
  p.y = static_cast<float*>(y);
  p.x_sb = strides[0]; p.x_ss = strides[1]; p.x_sh = strides[2];
  p.dt_sb = strides[3]; p.dt_ss = strides[4]; p.dt_sh = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7];
  p.c_sb = strides[8]; p.c_ss = strides[9];
  p.S = S; p.H = H; p.P = P; p.N = N; p.Q = Q;
  const size_t smem = sizeof(float) *
      (2 * (size_t)Q * (N + 1) + (size_t)Q * P + (size_t)P * (N + 1) +
       (size_t)Q * (kJT + 1) + 3 * (size_t)Q);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(H, B);
  ssd_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
