// The types, conversions, warp reductions and limits that the Hopper
// kernels share: float32 / bf16 element types (DType, to_f, from_f,
// load4), a warp's sum (warp_sum), the head-width dispatch (with_tiles),
// the dynamic shared-memory opt-in (ensure_smem), and the attention
// bodies' limits (kMaxHd, kMaxRows, kSmemLimit, kNegInf). The attention
// body itself, split-KV over paged or dense K/V, is ragged_split.cuh.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pt {

constexpr int kMaxHd = 256;    // head_dim bound (NT <= 8 lanes/thread)
constexpr int kMaxRows = 128;  // query rows one block holds at most
constexpr size_t kSmemLimit = 232448;  // sm_90 opt-in shared memory/block
constexpr float kNegInf = -1e30f;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// four consecutive elements as float4 (16-byte load for float, 8-byte
// load for bf16; the caller guarantees the alignment)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  return make_float4(__low2float(a), __high2float(a), __low2float(b),
                     __high2float(b));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Calls f(std::integral_constant<int, NT>) with NT = the accumulator
// lanes head width hd needs (2, 4 or 8 for hd <= 64, 128, 256; heads
// narrower than 32 share the hd-64 instance, whose lanes past hd idle,
// to keep the build to three instances per dtype).
template <class F>
inline void with_tiles(int hd, F f) {
  if (hd <= 64) f(std::integral_constant<int, 2>());
  else if (hd <= 128) f(std::integral_constant<int, 4>());
  else f(std::integral_constant<int, 8>());
}

// Raise the dynamic shared-memory cap of `kernel` once per process to
// what the largest launch so far needs (above 48 KB must be opted into).
template <class K>
inline cudaError_t ensure_smem(K kernel, size_t bytes, size_t* configured) {
  if (bytes <= 48 * 1024 || bytes <= *configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *configured = bytes;
  return e;
}

}  // namespace pt
