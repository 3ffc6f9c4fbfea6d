// Grouped GEMM (gmm) for the MoE expert FFN on Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/grouped_gemm.py gmm (:65, kernel body
//   _gmm_kernel :47, pallas_call at :129), reached through
//   inference/moe_serving.py _grouped_ffn_impl (:171, :173).
//
// What it computes: out[m, :] = lhs[m, :] @ rhs[block_expert[m / block_m]]
// in float32, lhs [M, K] (K contiguous, any row stride), rhs [E, K, N]
// contiguous, block_expert int32 [M / block_m], out [M, N] contiguous.
//
// Tiles never cross an expert. Rows group into RUNS, maximal sequences
// of consecutive m-blocks with the same expert id (the MoE capacity
// layout has one run per expert). A tile is up to TM rows of one run, so
// it multiplies by one expert's weight. Hopper has no scalar prefetch:
// each block finds its tile by walking block_expert itself (find_tile;
// the same broadcast loads in every thread, so branches stay uniform),
// and loops over tiles with the grid's stride, so any id sequence is
// covered whatever the grid size.
//
// What bounds it on the H100, and the two kernels that follow from it:
// * decode calls (8 rows per expert: M = 64 at block_m 8) read every
//   expert's whole weight for a few rows, 134 MB per GPT-medium ffn1
//   call for 0.54 GFLOP: HBM bytes bound it. gmm_rows_kernel streams the
//   weight straight from HBM to registers (16-byte loads, several in
//   flight per thread), each weight element feeding the tile's 8 rows
//   staged in shared memory; the block's threads split K into
//   interleaved slices summed in a fixed order at the end.
// * mixed and prefill calls (168 rows per expert at 520 rows) are
//   float32-arithmetic bound (11.3 GFLOP per ffn1 call). gmm_tile_kernel
//   is a shared-memory tiled SIMT GEMM: 64 x 128 output tiles, 16-deep K
//   slabs double-buffered through registers, 4 x 8 outputs a thread.
// The wrapper picks the kernel from the shapes alone (rows per expert:
// M over min(E, M / block_m)), so no host sync reads block_expert.
//
// Small grids leave SMs idle (ffn2's N = 1024 gives few column tiles),
// so either kernel also splits K across blocks (grid.z): each split
// writes its partial tile to a workspace and sum_splits adds the splits
// in split order. No float atomics anywhere: a result is the same from
// run to run.
//
// Not yet done (later PRs): tensor cores (TF32 or bf16 wgmma), TMA
// staging, a persistent schedule.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSplits = 32;

// -- rows kernel: tiles of kRM rows, kRN columns a block ----------------
constexpr int kRM = 8;
constexpr int kRN = 64;
constexpr int kRColGroups = kRN / 4;                 // 4 columns a thread
constexpr int kRKGroups = kThreads / kRColGroups;    // interleaved K slices
constexpr int kRUnroll = 4;                          // weight loads in flight
constexpr int kRKStep = kRKGroups * kRUnroll;        // K positions a round
constexpr int kRKC = 256;                            // x positions staged

// -- tile kernel: kTM x kTN output tiles, kBK-deep K slabs ---------------
constexpr int kTM = 64;
constexpr int kTN = 128;
constexpr int kBK = 16;
constexpr int kTAs = kTM + 4;   // padded A row: fewer bank conflicts on the
                                // transposed store, float4-aligned reads

enum Kind { kRows = 0, kTile = 1 };

struct Tile {
  int m0, rows, e;
};

// Tile t of the call (tiles numbered run by run, top to bottom). Returns
// false past the last tile. An expert id outside [0, E) is clamped, so
// no read leaves rhs (the plain version raises on it instead).
__device__ __forceinline__ bool find_tile(const int* __restrict__ be, int M,
                                          int nmb, int block_m, int tm,
                                          int E, int t, Tile& out) {
  if (block_m % tm == 0) {   // tiles never cross an m-block
    const int m0 = t * tm;
    if (m0 >= M) return false;
    out.m0 = m0;
    out.rows = tm;
    out.e = min(max(be[m0 / block_m], 0), E - 1);
    return true;
  }
  int b = 0;
  while (b < nmb) {
    const int e = be[b];
    int end = b + 1;
    while (end < nmb && be[end] == e) ++end;
    const int rows = (end - b) * block_m;
    const int n = (rows + tm - 1) / tm;
    if (t < n) {
      out.m0 = b * block_m + t * tm;
      out.rows = min(tm, rows - t * tm);
      out.e = min(max(e, 0), E - 1);
      return true;
    }
    t -= n;
    b = end;
  }
  return false;
}

// Split z of gridDim.z covers K positions [z * per, min(K, (z + 1) * per));
// its partial result goes to out + z * M * N.
__global__ void __launch_bounds__(kThreads)
    gmm_rows_kernel(const float* __restrict__ x, int64_t x_sr,
                    const float* __restrict__ w, const int* __restrict__ be,
                    float* __restrict__ out, int M, int K, int N, int E,
                    int block_m, int per, int vec) {
  __shared__ float xs[kRM][kRKC];
  __shared__ float part[kRKGroups][kRM][kRN + 1];
  const int nmb = M / block_m;
  const int n0 = blockIdx.x * kRN;
  const int k_lo = blockIdx.z * per;
  const int k_hi = min(K, k_lo + per);
  out += (int64_t)blockIdx.z * M * N;
  const int cg = threadIdx.x % kRColGroups;
  const int kg = threadIdx.x / kRColGroups;
  const int n = n0 + 4 * cg;   // this thread's first column
  Tile tile;
  for (int t = blockIdx.y;
       find_tile(be, M, nmb, block_m, kRM, E, t, tile); t += gridDim.y) {
    const float* we = w + (int64_t)tile.e * K * N;
    float acc[kRM][4];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

    for (int k0 = k_lo; k0 < k_hi; k0 += kRKC) {
      const int kc = min(kRKC, k_hi - k0);
      __syncthreads();  // the previous chunk of x is consumed
      for (int i = threadIdx.x; i < kRM * kRKC; i += kThreads) {
        const int r = i / kRKC, kk = i - r * kRKC;
        xs[r][kk] = (r < tile.rows && kk < kc)
                        ? x[(int64_t)(tile.m0 + r) * x_sr + k0 + kk]
                        : 0.f;
      }
      __syncthreads();
      // this thread's positions of the chunk: kg, kg + kRKGroups, ... in
      // increasing order (the fixed accumulation order)
      for (int kb = kg; kb < kc; kb += kRKStep) {
        float4 wv[kRUnroll];
#pragma unroll
        for (int u = 0; u < kRUnroll; ++u) {
          const int kk = kb + u * kRKGroups;
          const bool ok = kk < kc && n < N;
          const float* wp = we + (int64_t)(k0 + (kk < kc ? kk : 0)) * N + n;
          if (ok && vec) {
            wv[u] = *reinterpret_cast<const float4*>(wp);
          } else {
            wv[u].x = ok ? wp[0] : 0.f;
            wv[u].y = (ok && n + 1 < N) ? wp[1] : 0.f;
            wv[u].z = (ok && n + 2 < N) ? wp[2] : 0.f;
            wv[u].w = (ok && n + 3 < N) ? wp[3] : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRUnroll; ++u) {
          const int kk = kb + u * kRKGroups;
          const bool ok = kk < kc;
#pragma unroll
          for (int r = 0; r < kRM; ++r) {
            const float xv = ok ? xs[r][kk] : 0.f;
            acc[r][0] += xv * wv[u].x;
            acc[r][1] += xv * wv[u].y;
            acc[r][2] += xv * wv[u].z;
            acc[r][3] += xv * wv[u].w;
          }
        }
      }
    }

    // sum the K slices in a fixed order
    __syncthreads();  // the previous tile's sums are read
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[kg][r][4 * cg + j] = acc[r][j];
    __syncthreads();
    for (int i = threadIdx.x; i < kRM * kRN; i += kThreads) {
      const int r = i / kRN, c = i - r * kRN;
      if (r >= tile.rows || n0 + c >= N) continue;
      float s = 0.f;
      for (int g = 0; g < kRKGroups; ++g) s += part[g][r][c];
      out[(int64_t)(tile.m0 + r) * N + n0 + c] = s;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    gmm_tile_kernel(const float* __restrict__ x, int64_t x_sr,
                    const float* __restrict__ w, const int* __restrict__ be,
                    float* __restrict__ out, int M, int K, int N, int E,
                    int block_m, int per, int vec) {
  __shared__ __align__(16) float As[2][kBK][kTAs];
  __shared__ __align__(16) float Bs[2][kBK][kTN];
  const int nmb = M / block_m;
  const int n0 = blockIdx.x * kTN;
  const int k_lo = blockIdx.z * per;
  const int k_hi = min(K, k_lo + per);
  out += (int64_t)blockIdx.z * M * N;
  const int tid = threadIdx.x;
  const int tx = tid % 16;   // columns 4 tx .. 4 tx + 3 and 64 + the same
  const int ty = tid / 16;   // rows 4 ty .. 4 ty + 3
  Tile tile;
  for (int t = blockIdx.y;
       find_tile(be, M, nmb, block_m, kTM, E, t, tile); t += gridDim.y) {
    const float* we = w + (int64_t)tile.e * K * N;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    float a_reg[4];
    float4 b_reg[2];

    // global -> registers: the slab at K position k0 (zeros past the
    // tile's rows, past k_hi and past N)
    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * kThreads;
        const int r = idx / kBK, kk = idx % kBK;
        a_reg[i] = (r < tile.rows && k0 + kk < k_hi)
                       ? x[(int64_t)(tile.m0 + r) * x_sr + k0 + kk]
                       : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        const int kk = idx / (kTN / 4), c = n0 + 4 * (idx % (kTN / 4));
        const bool ok = k0 + kk < k_hi && c < N;
        const float* wp = we + (int64_t)(ok ? k0 + kk : 0) * N + c;
        if (ok && vec) {
          b_reg[i] = *reinterpret_cast<const float4*>(wp);
        } else {
          b_reg[i].x = ok ? wp[0] : 0.f;
          b_reg[i].y = (ok && c + 1 < N) ? wp[1] : 0.f;
          b_reg[i].z = (ok && c + 2 < N) ? wp[2] : 0.f;
          b_reg[i].w = (ok && c + 3 < N) ? wp[3] : 0.f;
        }
      }
    };
    auto store = [&](int buf) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * kThreads;
        As[buf][idx % kBK][idx / kBK] = a_reg[i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * kThreads;
        *reinterpret_cast<float4*>(
            &Bs[buf][idx / (kTN / 4)][4 * (idx % (kTN / 4))]) = b_reg[i];
      }
    };

    __syncthreads();  // the previous tile's slabs are consumed
    int cur = 0;
    if (k_lo < k_hi) {
      load(k_lo);
      store(0);
    }
    __syncthreads();
    for (int k0 = k_lo; k0 < k_hi; k0 += kBK) {
      const bool next = k0 + kBK < k_hi;
      if (next) load(k0 + kBK);   // in flight while this slab is used
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(
            &As[cur][kk][4 * ty]);
        const float4 b0 = *reinterpret_cast<const float4*>(
            &Bs[cur][kk][4 * tx]);
        const float4 b1 = *reinterpret_cast<const float4*>(
            &Bs[cur][kk][64 + 4 * tx]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                             b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] += av[i] * bv[j];
      }
      if (next) store(cur ^ 1);
      __syncthreads();
      cur ^= 1;
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r >= tile.rows) continue;
      float* o = out + (int64_t)(tile.m0 + r) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + (j < 4 ? 4 * tx + j : 64 + 4 * tx + j - 4);
        if (c < N) o[c] = acc[i][j];
      }
    }
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

int kstep(int kind) { return kind == kTile ? kBK : kRKStep; }

int per_split(int K, int splits, int kind) {
  const int step = kstep(kind);
  const int per = (K + splits - 1) / splits;
  return (per + step - 1) / step * step;
}

int tile_rows(int kind) { return kind == kTile ? kTM : kRM; }

int col_tiles(int N, int kind) {
  const int tn = kind == kTile ? kTN : kRN;
  return (N + tn - 1) / tn;
}

// grid.y: exact when each expert's rows form one run (the MoE layout);
// blocks stride over any further tiles
int row_slots(int M, int E, int block_m, int kind) {
  const int tm = tile_rows(kind);
  const int nmb = M / block_m;
  if (block_m % tm == 0) return M / tm;
  return (M + tm - 1) / tm + min(E, nmb);
}

}  // namespace

// The launch plan of a call: the kernel (0 rows, 1 tile; by rows per
// expert) and the number of K splits (enough blocks for about 3 per SM
// with the rows kernel, 2 with the tile kernel, each split at least
// 256 positions deep with the tile kernel). M > 0, M % block_m == 0.
extern "C" void pt_gmm_plan(int M, int K, int N, int E, int block_m,
                            int sms, int* kind, int* splits) {
  const int nmb = M / block_m;
  const int groups = nmb < E ? nmb : E;
  const int k = (M / (groups > 0 ? groups : 1)) >= 32 ? kTile : kRows;
  const int blocks = col_tiles(N, k) * row_slots(M, E, block_m, k);
  const int per_sm = k == kTile ? 2 : 3;
  const int want = (per_sm * sms + blocks - 1) / blocks;
  const int deepest = K / (k == kTile ? 256 : kRKStep);
  int s = min(want, min(deepest, kMaxSplits));
  if (s < 1) s = 1;
  // every split must own at least one K position
  while (s > 1 && per_split(K, s, k) * (s - 1) >= K) --s;
  *kind = k;
  *splits = s;
}

// x float32 [M, K] (row stride x_sr elements, K contiguous); w float32
// [E, K, N] contiguous; be int32 [M / block_m] on the device; out float32
// [M, N] contiguous; ws float32 [splits, M, N] when splits > 1 (else
// unused). `vec`: N % 4 == 0 and w 16-byte aligned (float4 weight loads).
// kind and splits as pt_gmm_plan gives them.
extern "C" int pt_gmm(const void* x, long long x_sr, const void* w,
                      const void* be, void* out, void* ws, int M, int K,
                      int N, int E, int block_m, int kind, int splits,
                      int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || splits > kMaxSplits || (splits > 1 && !ws) ||
      (kind != kRows && kind != kTile) || M <= 0 || N <= 0 || E <= 0 ||
      block_m <= 0 || M % block_m)
    return (int)cudaErrorInvalidValue;
  const int per = per_split(K, splits, kind);
  float* dst = splits > 1 ? static_cast<float*>(ws) : static_cast<float*>(out);
  dim3 grid(col_tiles(N, kind), row_slots(M, E, block_m, kind), splits);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const int* bi = static_cast<const int*>(be);
  if (kind == kTile)
    gmm_tile_kernel<<<grid, kThreads, 0, s>>>(xf, x_sr, wf, bi, dst, M, K,
                                             N, E, block_m, per, vec);
  else
    gmm_rows_kernel<<<grid, kThreads, 0, s>>>(xf, x_sr, wf, bi, dst, M, K,
                                             N, E, block_m, per, vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int64_t n = (int64_t)M * N;
  sum_splits<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}
