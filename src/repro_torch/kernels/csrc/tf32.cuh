// What the 3xTF32 kernels share (flash_attention.cu, ssd_scan.cu): the
// TF32 split, the mma.sync m16n8k8 TF32 product and its three-product form,
// ex2.approx, and the cp.async copies that stage their tiles.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace gxtf32 {

// x = big + small.  big is x rounded to TF32 as cvt.rna.tf32.f32 rounds a
// finite value (nearest, ties away from zero: add half a TF32 ulp to the
// bits and clear the low 13), in two integer instructions; cvt.rna itself
// is emulated in about five on sm_90, with its inf and NaN checks.  small =
// x - big is exact in float32, and the tensor cores read its top 19 bits.
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// 2^x (ex2.approx: ~2 ulp; the MUFU without exp2f's range handling).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// c += a·b on TF32 operands, float32 accumulation.  A fragment (16 x 8,
// row-major): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 =
// A[g+8][t+4]; B (8 x 8): b0 = B[t][g], b1 = B[t+4][g]; C (16 x 8): c0, c1
// = C[g][2t], C[g][2t+1], c2, c3 = C[g+8][2t], C[g+8][2t+1]; g = lane / 4,
// t = lane % 4.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b at float32 accuracy: a_s·b_b + a_b·b_s + a_b·b_b.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma(c, as, bb0, bb1);
  mma(c, ab, bs0, bs1);
  mma(c, ab, bb0, bb1);
}

// 16 bytes from device to shared memory; with `in` false nothing is read
// and the 16 bytes are zero-filled (src-size 0).  Both addresses 16-byte
// aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// One float, zero-filled when `in` is false: for rows that are strided or
// not 16-byte aligned.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace gxtf32
