// Fused normalization and dropout kernels for Hopper (sm_90a): RMSNorm
// and LayerNorm, each optionally after a residual add, and inverted
// dropout with a counter-based mask.
//
// --- RMSNorm -------------------------------------------------------------
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
//
// --- LayerNorm -----------------------------------------------------------
// Replaces: paddle_tpu/ops/pallas/fused_norm.py _ln_fwd_call (:201;
//   kernels _ln_fwd_kernel :62 and _ln_fwd_kernel_nores :77, pallas_calls
//   :209 and :219).
//
// What it computes, per row: z = x (+ residual) in fp32 (written rounded
// to the input type when there is a residual), mu = mean(z), then the
// centred variance var = mean((z - mu)^2) (the Pallas kernel's two-moment
// order, not Welford), y = (z - mu) * rsqrt(var + eps) * w + b.
//
// What bounds it: bytes. BERT's rows are narrow ([4096, 768] fp32 with a
// residual: 4 x 12.6 MB moved, 15.0 us at 3.35 TB/s), so one warp owns a
// row: its lanes keep the fp32 z in registers (kLnCache 16-byte vectors a
// lane: 1024 fp32 or 2048 bf16 elements) across the three passes (sum,
// centred sum of squares, output), reduce with shuffles only, and four
// warps share a block. Wider rows read x (and the residual) again for the
// passes past the cache.
//
// --- Dropout -------------------------------------------------------------
// Replaces: paddle_tpu/ops/pallas/fused_norm.py _fused_dropout (:304;
//   kernel _dropout_kernel :290, pallas_call :325).
//
// What it computes: y = x * keep / (1 - rate) in fp32, rounded to x's
// type, keep = u >= rate with u the low 24 bits of a hash of (seed, flat
// element index) over 2**24. The TPU kernel seeds its on-core generator
// per row block, which no other device reproduces; this mask is a
// function of the seed and the index alone (the murmur3 finaliser that
// flash_attention.cu also uses, over both halves of a 64-bit index), so
// the plain version (ops/hopper/fused_norm.py dropout_reference) draws
// the same mask bit for bit on any device, and the backward regenerates
// it from the seed instead of storing it. The divisor is a float32
// rounded once on the host and applied with a correctly rounded
// division: kernel and plain version agree bitwise.
//
// What bounds it: bytes (x read, y written: [4096, 3072] fp32 is 100.7 MB,
// 30.0 us); the hash is ~15 integer operations an element, under the
// card's integer rate at that bandwidth. Grid-stride loop, 16-byte loads.
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

// -- LayerNorm: one warp a row -------------------------------------------

constexpr int kLnWarps = 4;
constexpr int kLnCache = 8;

// a = x (+ r) in fp32 at col (N elements); with a residual and WRITE_Z,
// the sum is also stored rounded to T as z
template <typename T, bool RES, bool WRITE_Z>
__device__ __forceinline__ void ln_load(const T* xr, const T* rr, T* zr,
                                        int col, float* a) {
  constexpr int N = Vec<T>::N;
  load_vec(xr + col, a);
  if (RES) {
    float b[N];
    load_vec(rr + col, b);
#pragma unroll
    for (int e = 0; e < N; ++e) a[e] += b[e];
    if (WRITE_Z) store_vec(zr + col, a);
  }
}

template <typename T>
__device__ __forceinline__ void ln_store(const T* w, const T* b, T* yr,
                                         int col, const float* a, float mu,
                                         float rstd) {
  constexpr int N = Vec<T>::N;
  float wv[N], bv[N], o[N];
  load_vec(w + col, wv);
  load_vec(b + col, bv);
#pragma unroll
  for (int e = 0; e < N; ++e) o[e] = (a[e] - mu) * rstd * wv[e] + bv[e];
  store_vec(yr + col, o);
}

template <typename T, bool RES>
__global__ void __launch_bounds__(kLnWarps * 32)
    ln_kernel(const T* __restrict__ x, const T* __restrict__ r,
              const T* __restrict__ w, const T* __restrict__ b,
              T* __restrict__ y, T* __restrict__ z, long long rows, int h,
              float eps, int vec) {
  const long long row =
      (long long)blockIdx.x * kLnWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const long long base = row * h;
  const T* xr = x + base;
  const T* rr = RES ? r + base : nullptr;
  T* yr = y + base;
  T* zr = RES ? z + base : nullptr;
  const float fh = (float)h;
  if (vec) {
    constexpr int N = Vec<T>::N;
    constexpr int STEP = 32 * N;
    float c[kLnCache][N];
    float s = 0.f;
#pragma unroll
    for (int it = 0; it < kLnCache; ++it) {
      const int col = it * STEP + lane * N;
      if (col < h) {
        ln_load<T, RES, true>(xr, rr, zr, col, c[it]);
#pragma unroll
        for (int e = 0; e < N; ++e) s += c[it][e];
      }
    }
    for (int col = kLnCache * STEP + lane * N; col < h; col += STEP) {
      float a[N];
      ln_load<T, RES, true>(xr, rr, zr, col, a);
#pragma unroll
      for (int e = 0; e < N; ++e) s += a[e];
    }
    const float mu = pt::warp_sum(s) / fh;
    float q = 0.f;
#pragma unroll
    for (int it = 0; it < kLnCache; ++it) {
      const int col = it * STEP + lane * N;
      if (col < h) {
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float d = c[it][e] - mu;
          q += d * d;
        }
      }
    }
    for (int col = kLnCache * STEP + lane * N; col < h; col += STEP) {
      float a[N];
      ln_load<T, RES, false>(xr, rr, zr, col, a);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float d = a[e] - mu;
        q += d * d;
      }
    }
    const float rstd = rsqrtf(pt::warp_sum(q) / fh + eps);
#pragma unroll
    for (int it = 0; it < kLnCache; ++it) {
      const int col = it * STEP + lane * N;
      if (col < h) ln_store(w, b, yr, col, c[it], mu, rstd);
    }
    for (int col = kLnCache * STEP + lane * N; col < h; col += STEP) {
      float a[N];
      ln_load<T, RES, false>(xr, rr, zr, col, a);
      ln_store(w, b, yr, col, a, mu, rstd);
    }
    return;
  }
  // scalar path: every pass reads x (and the residual) again
  float s = 0.f;
  for (int col = lane; col < h; col += 32) {
    float a = pt::to_f(xr[col]);
    if (RES) {
      a += pt::to_f(rr[col]);
      zr[col] = pt::from_f<T>(a);
    }
    s += a;
  }
  const float mu = pt::warp_sum(s) / fh;
  float q = 0.f;
  for (int col = lane; col < h; col += 32) {
    float a = pt::to_f(xr[col]);
    if (RES) a += pt::to_f(rr[col]);
    q += (a - mu) * (a - mu);
  }
  const float rstd = rsqrtf(pt::warp_sum(q) / fh + eps);
  for (int col = lane; col < h; col += 32) {
    float a = pt::to_f(xr[col]);
    if (RES) a += pt::to_f(rr[col]);
    yr[col] = pt::from_f<T>((a - mu) * rstd * pt::to_f(w[col]) +
                            pt::to_f(b[col]));
  }
}

template <typename T>
int launch_ln(const void* x, const void* r, const void* w, const void* b,
              void* y, void* z, long long rows, int h, float eps, int vec,
              cudaStream_t s) {
  if (rows == 0) return 0;
  const unsigned grid = (unsigned)((rows + kLnWarps - 1) / kLnWarps);
  if (r)
    ln_kernel<T, true><<<grid, kLnWarps * 32, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(r),
        static_cast<const T*>(w), static_cast<const T*>(b),
        static_cast<T*>(y), static_cast<T*>(z), rows, h, eps, vec);
  else
    ln_kernel<T, false><<<grid, kLnWarps * 32, 0, s>>>(
        static_cast<const T*>(x), nullptr, static_cast<const T*>(w),
        static_cast<const T*>(b), static_cast<T*>(y), nullptr, rows, h, eps,
        vec);
  return (int)cudaGetLastError();
}

// -- dropout: a counter-based mask -----------------------------------------

constexpr int kDropThreads = 256;
constexpr long long kDropMaxBlocks = 1 << 16;

// murmur3's 32-bit finaliser (flash_attention.cu hash_mix)
__device__ __forceinline__ uint32_t fmix32(uint32_t v) {
  v ^= v >> 16;
  v *= 0x85ebca6bu;
  v ^= v >> 13;
  v *= 0xc2b2ae35u;
  v ^= v >> 16;
  return v;
}

// x * keep / div for the element at flat index i; s = fmix32(seed +
// 0x9E3779B9), keep = (low 24 bits of the index hash) / 2**24 >= rate
__device__ __forceinline__ float drop_one(float a, unsigned long long i,
                                          uint32_t s, float rate,
                                          float div) {
  const uint32_t hsh = fmix32(((uint32_t)i * 0x9E3779B9u) ^
                              ((uint32_t)(i >> 32) * 0x85EBCA6Bu) ^ s);
  const float u = (float)(hsh & 0xFFFFFFu) * (1.0f / 16777216.0f);
  return __fdiv_rn(__fmul_rn(a, u >= rate ? 1.0f : 0.0f), div);
}

template <typename T>
__global__ void __launch_bounds__(kDropThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ y, long long n,
                   uint32_t seed, float rate, float div, int vec) {
  const uint32_t s = fmix32(seed + 0x9E3779B9u);
  const long long stride = (long long)gridDim.x * kDropThreads;
  const long long t = (long long)blockIdx.x * kDropThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    constexpr int N = Vec<T>::N;
    const long long nv = n / N;
    for (long long v = t; v < nv; v += stride) {
      float a[N];
      load_vec(x + v * N, a);
#pragma unroll
      for (int e = 0; e < N; ++e)
        a[e] = drop_one(a[e], (unsigned long long)(v * N + e), s, rate, div);
      store_vec(y + v * N, a);
    }
    done = nv * N;
  }
  for (long long i = done + t; i < n; i += stride)
    y[i] = pt::from_f<T>(
        drop_one(pt::to_f(x[i]), (unsigned long long)i, s, rate, div));
}

template <typename T>
int launch_dropout(const void* x, void* y, long long n, uint32_t seed,
                   float rate, float div, int vec, cudaStream_t s) {
  if (n == 0) return 0;
  const long long per = vec ? (long long)Vec<T>::N : 1;
  long long blocks = (n / per + kDropThreads - 1) / kDropThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kDropMaxBlocks) blocks = kDropMaxBlocks;
  dropout_kernel<T><<<(unsigned)blocks, kDropThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(y), n, seed, rate, div,
      vec);
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

// x, residual (or null), w, b, y, z (null without a residual): contiguous
// [rows, h] (w, b: [h]); vec as for pt_rms_norm.
extern "C" int pt_layer_norm(int dtype, const void* x, const void* r,
                             const void* w, const void* b, void* y, void* z,
                             long long rows, int h, float eps, int vec,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return launch_ln<float>(x, r, w, b, y, z, rows, h, eps, vec, s);
  if (dtype == pt::kBF16)
    return launch_ln<__nv_bfloat16>(x, r, w, b, y, z, rows, h, eps, vec, s);
  return (int)cudaErrorInvalidValue;
}

// x, y: n contiguous elements; seed: the int32 seed's bits; div: float32
// (1 - rate); vec = 1 when both pointers are 16-byte aligned.
extern "C" int pt_dropout(int dtype, const void* x, void* y, long long n,
                          unsigned int seed, float rate, float div, int vec,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return launch_dropout<float>(x, y, n, seed, rate, div, vec, s);
  if (dtype == pt::kBF16)
    return launch_dropout<__nv_bfloat16>(x, y, n, seed, rate, div, vec, s);
  return (int)cudaErrorInvalidValue;
}
