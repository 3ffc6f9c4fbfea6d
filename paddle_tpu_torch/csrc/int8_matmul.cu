// Weight-only int8 matmul (w8a16) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/int8_matmul.py _w8a16_call (pallas_call
//   at :66, kernel _w8a16_kernel :34), reached through w8a16_matmul :96.
//
// What it computes: out[M, N] = x[M, K] @ float(w[K, N]) in fp32, with x
// float32 or bfloat16 and w int8, UNSCALED: the caller multiplies by the
// per-output-channel scale / qmax (quantization/functional.py).
//
// What bounds it on the H100: at serving sizes (M = 1..8 decode rows) the
// int8 weight bytes read from HBM — 12.6 MB per GPT-medium layer, 3.8 us at
// 3.35 TB/s, against 2 * M * K * N flops that the card does in far less.
// At M = 256 (a prefill chunk) the fp32 arithmetic on the CUDA cores
// takes over (2 * 256 * K * N flops at 67 TFLOP/s).
//
// What the design does about it: the weight is never dequantized into
// device memory. A block owns kBN output columns and kBM output rows;
// every weight element of its column strip crosses HBM once per row tile
// as an int8 (4 adjacent columns per 4-byte load, a warp covering 4 whole
// 32-byte sectors) and is converted to fp32 in registers. The rows' x
// values are staged kKC positions at a time in shared memory, so each
// loaded weight feeds kBM rows. The block's 256 threads split K into
// kKGroups interleaved slices; each slice accumulates in registers in
// increasing K order and the slices are summed in a fixed order through
// shared memory at the end — no atomics, so a result is the same from run
// to run.
//
// Few row tiles and narrow N leave most SMs idle (N = 1024 at 8 rows is 32
// blocks), and one block keeps too few loads in flight to reach the HBM
// rate alone. So a small grid also splits K across blocks (grid.z): each
// split writes its partial tile to a workspace and a second kernel sums
// the splits in split order — still a fixed order, still no atomics.
//
// Not yet done (later PRs): tensor cores (int8 -> bf16 in registers,
// then wgmma) for the 256-row calls, 16-byte weight loads, cp.async/TMA
// staging of the weight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;                           // output columns a block
constexpr int kBM = 8;                            // output rows a block
constexpr int kKC = 256;                          // x positions staged a step
constexpr int kColGroups = kBN / 4;               // 4 columns per thread
constexpr int kKGroups = kThreads / kColGroups;   // interleaved K slices
constexpr int kUnroll = 4;                        // weight loads in flight
constexpr int kKStep = kKGroups * kUnroll;        // K positions per round
constexpr int kMaxSplits = 32;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Split z of `splits` covers K positions [z * per, min(K, (z + 1) * per))
// with per a multiple of kKStep; its tile goes to out + z * M * N.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    w8a16_kernel(const T* __restrict__ x, int64_t x_sr,
                 const int8_t* __restrict__ w, float* __restrict__ out,
                 int M, int K, int N, int per, int vec) {
  __shared__ float xs[kBM][kKC];
  __shared__ float part[kKGroups][kBM][kBN + 1];
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k_lo = blockIdx.z * per;
  const int k_hi = min(K, k_lo + per);
  out += (int64_t)blockIdx.z * M * N;
  const int rows = min(kBM, M - m0);
  const int cg = threadIdx.x % kColGroups;
  const int kg = threadIdx.x / kColGroups;
  const int n = n0 + 4 * cg;   // this thread's first column
  float acc[kBM][4];
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kKC) {
    const int kc = min(kKC, k_hi - k0);
    __syncthreads();  // the previous chunk of x is consumed
    for (int i = threadIdx.x; i < kBM * kKC; i += kThreads) {
      const int r = i / kKC, kk = i - r * kKC;
      xs[r][kk] = (r < rows && kk < kc)
                      ? to_f(x[(int64_t)(m0 + r) * x_sr + k0 + kk])
                      : 0.f;
    }
    __syncthreads();
    // this thread's positions of the chunk: kg, kg + kKGroups, ... in
    // increasing order (the fixed accumulation order)
    for (int kb = kg; kb < kc; kb += kKGroups * kUnroll) {
      float wv[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = kb + u * kKGroups;
        const bool ok = kk < kc;
        const int8_t* wp = w + (int64_t)(k0 + (ok ? kk : 0)) * N + n;
        if (ok && vec && n < N) {
          const char4 c = *reinterpret_cast<const char4*>(wp);
          wv[u][0] = (float)c.x;
          wv[u][1] = (float)c.y;
          wv[u][2] = (float)c.z;
          wv[u][3] = (float)c.w;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[u][j] = (ok && n + j < N) ? (float)wp[j] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int kk = kb + u * kKGroups;
        const bool ok = kk < kc;
#pragma unroll
        for (int r = 0; r < kBM; ++r) {
          const float xv = ok ? xs[r][kk] : 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] += xv * wv[u][j];
        }
      }
    }
  }

  // sum the K slices in a fixed order
#pragma unroll
  for (int r = 0; r < kBM; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[kg][r][4 * cg + j] = acc[r][j];
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kBN; i += kThreads) {
    const int r = i / kBN, c = i - r * kBN;
    if (r >= rows || n0 + c >= N) continue;
    float s = 0.f;
    for (int g = 0; g < kKGroups; ++g) s += part[g][r][c];
    out[(int64_t)(m0 + r) * N + n0 + c] = s;
  }
}

// out[i] = sum over z of part[z][i], z = 0 .. splits - 1 in order
__global__ void __launch_bounds__(kThreads)
    sum_splits(const float* __restrict__ part, float* __restrict__ out,
               int64_t n, int splits) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += part[z * n + i];
  out[i] = s;
}

int per_split(int K, int splits) {
  const int per = (K + splits - 1) / splits;
  return (per + kKStep - 1) / kKStep * kKStep;
}

template <typename T>
int launch(const void* x, long long x_sr, const void* w, void* out,
           float* ws, int M, int K, int N, int splits, int vec,
           cudaStream_t stream) {
  const int per = per_split(K, splits);
  dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  w8a16_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), x_sr, static_cast<const int8_t*>(w),
      splits > 1 ? ws : static_cast<float*>(out), M, K, N, per, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int64_t n = (int64_t)M * N;
  sum_splits<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
               stream>>>(ws, static_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// How many K splits a call of this shape uses on a card of `sms` SMs:
// enough blocks for about 3 per SM, each split at least kKStep positions
// deep; 1 when the row and column tiles alone fill the card.
extern "C" int pt_w8a16_splits(int M, int K, int N, int sms) {
  const int tiles = ((N + kBN - 1) / kBN) * ((M + kBM - 1) / kBM);
  const int want = (3 * sms + tiles - 1) / tiles;
  const int deepest = K / kKStep;
  int splits = min(want, min(deepest, kMaxSplits));
  if (splits < 1) splits = 1;
  // every split must own at least one K position
  while (splits > 1 && per_split(K, splits) * (splits - 1) >= K) --splits;
  return splits;
}

// x [M, K] (row stride x_sr elements, K contiguous) of `dtype`; w int8
// [K, N] contiguous; out float32 [M, N] contiguous; ws float32
// [splits, M, N] when splits > 1 (else unused). `vec`: N % 4 == 0 and w
// 4-byte aligned (4-column loads).
extern "C" int pt_w8a16_matmul(int dtype, const void* x, long long x_sr,
                               const void* w, void* out, void* ws, int M,
                               int K, int N, int splits, int vec,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch<float>(x, x_sr, w, out, wsf, M, K, N, splits, vec, s);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(x, x_sr, w, out, wsf, M, K, N, splits,
                                 vec, s);
  return (int)cudaErrorInvalidValue;
}
