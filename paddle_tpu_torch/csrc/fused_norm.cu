// Fused RMSNorm (optionally after a residual add) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused_norm.py _rms_fwd (:105; kernels
//   _rms_fwd_kernel :41 and _rms_fwd_kernel_nores :53, pallas_calls :114
//   and :124).
//
// What it computes, per row of h elements: with a residual,
// z = x + residual in fp32, written back rounded to the input type (the
// next residual stream), and y = z * rsqrt(mean(z^2) + eps) * w from the
// fp32 z (not the rounded one); without, y from x alone.
//
// What bounds it on the H100: bytes. At the training shape ([32768, 4096]
// bf16) a call moves 0.537 GB without a residual (x read, y written:
// 0.160 ms at 3.35 TB/s) and 1.07 GB with one (x, residual read, y, z
// written: 0.320 ms); the arithmetic is a few operations per byte.
//
// What the design does about it: one block of 256 threads per row, 16-byte
// loads and stores (8 bf16 or 4 fp32 elements a thread at a time). A
// thread keeps what it read in registers (up to kCache vectors: rows of
// 8192 bf16 or 4096 fp32 elements) while the sum of squares is reduced
// across the block, so each input byte is read from memory once; wider
// rows read the rest again for the second pass. Rows whose width is not
// a multiple of the vector, or whose data is not 16-byte aligned, take a
// scalar path.
#include "attention_common.cuh"

namespace {

constexpr int kNormThreads = 256;
constexpr int kCache = 4;

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);
};

__device__ __forceinline__ void load_vec(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* out) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    out[2 * i] = __low2float(b);
    out[2 * i + 1] = __high2float(b);
  }
}
__device__ __forceinline__ void store_vec(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<uint32_t*>(&b);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = pt::warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kNormThreads / 32; ++w) s += red[w];
  return s;
}

template <typename T, bool RES>
__global__ void __launch_bounds__(kNormThreads)
    rms_kernel(const T* __restrict__ x, const T* __restrict__ r,
               const T* __restrict__ w, T* __restrict__ y,
               T* __restrict__ z, int h, float eps, int vec) {
  __shared__ float red[kNormThreads / 32];
  const long long base = (long long)blockIdx.x * h;
  const T* xr = x + base;
  const T* rr = RES ? r + base : nullptr;
  T* yr = y + base;
  T* zr = RES ? z + base : nullptr;
  float ss = 0.f;
  if (vec) {
    constexpr int N = Vec<T>::N;
    constexpr int STEP = kNormThreads * N;
    float c[kCache][N];
#pragma unroll
    for (int it = 0; it < kCache; ++it) {
      const int col = it * STEP + threadIdx.x * N;
      if (col < h) {
        load_vec(xr + col, c[it]);
        if (RES) {
          float b[N];
          load_vec(rr + col, b);
#pragma unroll
          for (int e = 0; e < N; ++e) c[it][e] += b[e];
          store_vec(zr + col, c[it]);
        }
#pragma unroll
        for (int e = 0; e < N; ++e) ss += c[it][e] * c[it][e];
      }
    }
    for (int col = kCache * STEP + threadIdx.x * N; col < h; col += STEP) {
      float a[N];
      load_vec(xr + col, a);
      if (RES) {
        float b[N];
        load_vec(rr + col, b);
#pragma unroll
        for (int e = 0; e < N; ++e) a[e] += b[e];
        store_vec(zr + col, a);
      }
#pragma unroll
      for (int e = 0; e < N; ++e) ss += a[e] * a[e];
    }
    const float rstd = rsqrtf(block_sum(ss, red) / h + eps);
#pragma unroll
    for (int it = 0; it < kCache; ++it) {
      const int col = it * STEP + threadIdx.x * N;
      if (col < h) {
        float wv[N], o[N];
        load_vec(w + col, wv);
#pragma unroll
        for (int e = 0; e < N; ++e) o[e] = c[it][e] * rstd * wv[e];
        store_vec(yr + col, o);
      }
    }
    for (int col = kCache * STEP + threadIdx.x * N; col < h; col += STEP) {
      float a[N], wv[N], o[N];
      load_vec(xr + col, a);
      if (RES) {
        float b[N];
        load_vec(rr + col, b);
#pragma unroll
        for (int e = 0; e < N; ++e) a[e] += b[e];
      }
      load_vec(w + col, wv);
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = a[e] * rstd * wv[e];
      store_vec(yr + col, o);
    }
    return;
  }
  for (int col = threadIdx.x; col < h; col += kNormThreads) {
    float a = pt::to_f(xr[col]);
    if (RES) {
      a += pt::to_f(rr[col]);
      zr[col] = pt::from_f<T>(a);
    }
    ss += a * a;
  }
  const float rstd = rsqrtf(block_sum(ss, red) / h + eps);
  for (int col = threadIdx.x; col < h; col += kNormThreads) {
    float a = pt::to_f(xr[col]);
    if (RES) a += pt::to_f(rr[col]);
    yr[col] = pt::from_f<T>(a * rstd * pt::to_f(w[col]));
  }
}

template <typename T>
int launch(const void* x, const void* r, const void* w, void* y, void* z,
           long long rows, int h, float eps, int vec, cudaStream_t s) {
  if (rows == 0) return 0;
  if (r)
    rms_kernel<T, true><<<(unsigned)rows, kNormThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const T*>(w), static_cast<T*>(y), static_cast<T*>(z), h,
        eps, vec);
  else
    rms_kernel<T, false><<<(unsigned)rows, kNormThreads, 0, s>>>(
        static_cast<const T*>(x), nullptr, static_cast<const T*>(w),
        static_cast<T*>(y), nullptr, h, eps, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x, residual (or null), w, y, z (null without a residual): contiguous
// [rows, h] (w: [h]); vec = 1 when h is a multiple of 16 bytes' worth of
// elements and every pointer is 16-byte aligned.
extern "C" int pt_rms_norm(int dtype, const void* x, const void* r,
                           const void* w, void* y, void* z, long long rows,
                           int h, float eps, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32) return launch<float>(x, r, w, y, z, rows, h, eps, vec, s);
  if (dtype == pt::kBF16)
    return launch<__nv_bfloat16>(x, r, w, y, z, rows, h, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}
