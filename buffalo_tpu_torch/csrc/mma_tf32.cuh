// Tensor-core helpers shared by the Gram kernels (K2
// csrc/als_normal_equations.cu, K17 csrc/cfr_normal_equations.cu): the
// cp.async gather into shared memory, and mma.sync m16n8k8 TF32 with the
// 3xTF32 split that keeps float32 accuracy.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16-byte asynchronous copy global -> shared, L2 only (cp.async.cg); with
// `full` false nothing is read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

// The same through L1 (cp.async.ca): a power-law gather reads its popular
// rows from every SM, and L1 keeps them off the few L2 lines that hold them.
__device__ __forceinline__ void cp_async16_l1(float* dst, const float* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x = big + small for 3xTF32.  The tensor core reads a TF32 operand from
// the top 19 bits of its register.  big is x with the low 13 bits cleared;
// small = x - big is exact in float32, and adding half of the dropped
// bits' range rounds it to the nearest TF32 value as the tensor core reads
// it, so big + small keeps x to 2^-21 relative without a cvt.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a * b with c starting from zero
__device__ __forceinline__ void mma_tf32_first(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// (m16 row, 16-column block) of unit `unit` of an upper block triangle of
// MT x MT 16 x 16 units, row-major
__device__ __forceinline__ void unit_mn(int unit, int MT, int& mi, int& nj) {
  mi = 0;
  while (unit >= MT - mi) unit -= MT - mi++;
  nj = mi + unit;
}

}  // namespace
