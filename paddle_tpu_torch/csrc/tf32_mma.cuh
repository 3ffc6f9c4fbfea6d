// Copy and tensor-core building blocks of the float32 GEMM kernels
// (grouped_gemm.cu's tile kernel, int8_matmul.cu): cp.async with zero
// fill, and mma.sync m16n8k8 TF32 with its A fragment by ldmatrix and
// the bit-mask TF32 split.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies: `bytes` of the 16 (or 4) are
// read, the rest of the destination is zero-filled (bytes 0 reads
// nothing, so `src` need only be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 3xTF32: x = big + small, both TF32. big is x with the 13 low mantissa
// bits cleared (a bit mask: no conversion instruction, which costs more
// than the mask); small = x - big is exact, and is cleared the same way,
// so big·big + big·small + small·big carries ~21 bits of each operand's
// mantissa (one TF32 pass keeps 10). Where the other operand is exact in
// TF32 (an int8 weight), big·w + small·w alone carries them.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) & 0xffffe000u;
}

// The A fragment of mma.m16n8k8 TF32 (a0..a3: rows g, g + 8 at k t, then
// at k t + 4) in one shared-memory instruction: ldmatrix of four 8 x 8
// b16 matrices hands thread i the 32-bit word (row i / 4, word i % 4) of
// each 8-row x 16-byte block, which is that fragment's layout.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const float* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  // not volatile: the products of different fragments may interleave
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
