// int8 -> float32 conversion shared by the int8 kernels
// (paged_attention_int8.cu through ragged_split.cuh, int8_matmul.cu).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

// Byte i of w as a signed int8, exactly, without a conversion
// instruction: the byte biased by 128 goes into the low mantissa bits of
// 2^23 (one byte permute), and 2^23 + 128 comes off again.
__device__ __forceinline__ float i8_at(uint32_t w, int i) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4b000000u,
                                     0x7540 + i)) - 8388736.f;
}

// The four int8 of a 32-bit word, lowest address first.
__device__ __forceinline__ float4 i8x4(uint32_t w) {
  return make_float4(i8_at(w, 0), i8_at(w, 1), i8_at(w, 2), i8_at(w, 3));
}

}  // namespace pt
