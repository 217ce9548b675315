// Tensor-core building blocks shared by moe_gemm.cu, flash_attention.cu,
// flash_attention_bwd.cu, ssd_scan.cu and audit_mlp.cu:
// fp32-accurate products as three TF32 mma.sync (3xTF32), bf16 products as
// one bf16 mma.sync, and the cp.async copies that stage their tiles.
//
// 3xTF32.  TF32 keeps 10 of fp32's 23 mantissa bits, so one TF32 product
// per fp32 product misses the port's fp32 bars (1e-5 / 8e-5 for the expert
// GEMM, 2e-4 for attention) by one to three orders of magnitude.  Split each
// operand as hi = tf32(x), rounded to nearest (ties away from zero, as
// cvt.rna.tf32.f32 rounds), and lo = x - hi, exact in fp32, whose low 13
// bits the tensor core drops (a TF32 operand is read from the top 19 bits
// of its register); then
//     a * b ~= a_lo * b_hi + a_hi * b_lo + a_hi * b_hi
// drops only a_lo * b_lo and lo's cut bits (each about 2^-21 of the
// product) and keeps fp32 accuracy.  The two small terms are accumulated
// before hi * hi, so they are not lost below the last bit of a larger
// partial sum.  hi is rounded by integer arithmetic (add half of TF32's
// last place to the bits, clear the low 13): cvt.rna.tf32.f32 gives the same
// value but runs on the conversion unit, at a fraction of the rate of the
// integer and fp32 pipes, and the kernels split every fragment they load.
//
// Why mma.sync and not wgmma: wgmma reads tf32 operands K-major only (the
// transpose bits exist for f16 / bf16), while w (E, d, f) of the expert GEMM
// and V (Sk, D) of attention are MN-major for their products.  mma.sync
// fragments are loaded from fp32 shared memory and split in registers, so
// nothing is stored twice.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16,
// row.col), with g = lane / 4 and t = lane % 4:
//   tf32  A 16x8:  a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//         B 8x8:   b0 (k t, n g)  b1 (k t+4, n g)
//   bf16  A 16x16: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                  a3 (g+8, 2t+8..)
//         B 16x8:  b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   f32   C 16x8:  c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// (a bf16 pair holds the lower index in its low half).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// ------------------------------------------------------------ 3xTF32
// the TF32 value nearest x, ties away from zero (cvt.rna.tf32.f32's value
// for every finite x)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// hi = tf32(x); lo = x - hi, which the tensor core reads cut to TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b + 0: one TF32 product into a zeroed accumulator
__device__ __forceinline__ void mma_tf32_z(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f), "f"(0.f), "f"(0.f), "f"(0.f));
}

// d += a * b in 3xTF32: the two small terms first, then hi * hi
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi);
  mma_tf32(d, a_hi, b_lo);
  mma_tf32(d, a_hi, b_hi);
}

// ------------------------------------------------------------ bf16
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two bf16 values (lo at the lower index) as one register
__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}
__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ------------------------------------------------------------ cp.async
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared; src_bytes < 16 zero-fills the rest (0: all)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global -> shared; src_bytes 0 writes zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage a rows x cols tile of T from global memory (row stride ld
// elements; rows >= nr or cols >= nc are outside the tensor and read 0)
// into shared memory (row stride lds elements), with threads tid of
// nthreads.  vec: 16-byte copies, which need 16-byte-aligned rows and nc a
// multiple of the vector; otherwise element by element (4-byte cp.async for
// float, plain loads for bf16).  The caller commits and waits.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int lds, const T* src,
                                           long long ld, int rows, int cols,
                                           int nr, int nc, bool vec, int tid,
                                           int nthreads) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);
    const int cpr = cols / V;  // chunks per row
    for (int c = tid; c < rows * cpr; c += nthreads) {
      const int r = c / cpr, cc = (c % cpr) * V;
      const bool in = r < nr && cc < nc;
      cp_async16(dst + r * lds + cc, in ? src + r * ld + cc : src,
                 in ? 16 : 0);
    }
  } else {
    for (int c = tid; c < rows * cols; c += nthreads) {
      const int r = c / cols, cc = c % cols;
      const bool in = r < nr && cc < nc;
      if constexpr (sizeof(T) == 4) {
        cp_async4(dst + r * lds + cc, in ? src + r * ld + cc : src,
                  in ? 4 : 0);
      } else {
        dst[r * lds + cc] = in ? src[r * ld + cc] : __float2bfloat16(0.f);
      }
    }
  }
}

}  // namespace tc
