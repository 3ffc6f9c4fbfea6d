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
//   arithmetic bound (11.3 GFLOP per ffn1 call; 0.168 ms at the 67
//   TFLOP/s float32 SIMT peak). gmm_tile_kernel runs the products on the
//   tensor cores in 3xTF32: each float32 operand splits into a TF32 big
//   part and a TF32 remainder, and big·big + big·small + small·big
//   accumulate in float32 (three mma.m16n8k8 per product, ~21 mantissa
//   bits of each operand: float32 accuracy, where one TF32 pass keeps
//   ~10). The tensor cores' float32 additions do not round to nearest,
//   so each 32-deep slab is summed on them and the slab sums are added
//   in float32 registers (on an H100, one tensor-core chain of 4096 / 8 x
//   3 additions lost 1.6e-5 x max|ref| at K 4096; per-slab sums 2.9e-6).
//   64 x 128 output tiles, 32-deep K slabs through a 4-stage ring of
//   cp.async copies (16 bytes where the row strides allow it, 4 bytes
//   otherwise, zero-filled past K, N and the tile's rows).
//   Why mma.sync and not wgmma: wgmma reads TF32 operands from shared
//   memory K-major only, and the weight [E, K, N] is N-contiguous (MN-
//   major for B). mma.sync takes B fragments that each thread reads from
//   an N-major shared tile, so the weight is used in place: no packed
//   K-major copy of every expert (134 MB per ffn matrix and layer at
//   GPT-medium widths) and no transpose pass.
// The wrapper picks the kernel from the shapes alone (rows per expert:
// M over min(E, M / block_m)), so no host sync reads block_expert.
//
// Small grids leave SMs idle (ffn2's N = 1024 gives few column tiles),
// so either kernel also splits K across blocks (grid.z): each split
// writes its partial tile to a workspace and sum_splits adds the splits
// in split order. No float atomics anywhere: a result is the same from
// run to run.
//
// Not yet done (later PRs): wgmma over a K-major weight copy, TMA
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

// -- tile kernel: kTM x kTN output tiles, kBK-deep K slabs in a ring ----
constexpr int kTM = 64;
constexpr int kTN = 128;
constexpr int kBK = 32;
constexpr int kStages = 4;
// padded shared rows: the 8 rows x 16 bytes of an A ldmatrix block start
// at banks 4 r, B fragment reads (row tq, column gq) hit banks 8 tq + gq:
// all 32 distinct, and every row stays 16-byte aligned for cp.async
constexpr int kALd = kBK + 4;
constexpr int kBLd = kTN + 8;
constexpr int kWM = 1, kWN = 4;               // warps: rows x columns
constexpr int kTThreads = 32 * kWM * kWN;
constexpr int MT = kTM / kWM / 16;            // m16 fragments a warp
constexpr int NT = kTN / kWN / 8;             // n8 fragments a warp
constexpr int kAStage = kTM * kALd;
constexpr int kBStage = kBK * kBLd;
constexpr size_t kTileSmem = sizeof(float) * kStages * (kAStage + kBStage);

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous global -> shared copies: `bytes` of the 16 (or 4) are
// read, the rest of the destination is zero-filled (bytes 0 reads
// nothing, so `src` need only be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
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
// mantissa (one TF32 pass keeps 10).
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

// Tensor-core tile kernel: kTM x kTN output tiles of one expert, K in
// kBK-deep slabs through a kStages ring of cp.async copies. kWM x kWN
// warps (rows x columns), each a (kTM / kWM) x (kTN / kWN) sub-tile of
// MT x NT mma.m16n8k8 fragments. avec / bvec: lhs rows / weight rows may
// be read as 16-byte vectors (row stride and base 16-byte aligned);
// otherwise 4-byte copies. Zeros past the tile's rows, k_hi and N.
__global__ void __launch_bounds__(kTThreads, 2)
    gmm_tile_kernel(const float* __restrict__ x, int64_t x_sr,
                    const float* __restrict__ w, const int* __restrict__ be,
                    float* __restrict__ out, int M, int K, int N, int E,
                    int block_m, int per, int avec, int bvec) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [kStages][kTM][kALd]
  float* Bs = smem + kStages * kAStage;      // [kStages][kBK][kBLd]
  const int nmb = M / block_m;
  const int n0 = blockIdx.x * kTN;
  const int k_lo = blockIdx.z * per;
  const int k_hi = min(K, k_lo + per);
  const int nslab = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;
  out += (int64_t)blockIdx.z * M * N;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWN, wn = warp % kWN;
  const int gq = lane >> 2, tq = lane & 3;   // mma group / thread in group
  Tile tile;
  for (int t = blockIdx.y;
       find_tile(be, M, nmb, block_m, kTM, E, t, tile); t += gridDim.y) {
    const float* xe = x + (int64_t)tile.m0 * x_sr;
    const float* we = w + (int64_t)tile.e * K * N;

    // slab s (K positions k_lo + s kBK ...) into ring stage s % kStages
    auto load = [&](int s) {
      const int k0 = k_lo + s * kBK;
      const uint32_t a_s = smem_addr(As + (s % kStages) * kAStage);
      const uint32_t b_s = smem_addr(Bs + (s % kStages) * kBStage);
      if (avec) {
#pragma unroll
        for (int i = 0; i < kTM * kBK / 4 / kTThreads; ++i) {
          const int c = tid + i * kTThreads;
          const int r = c / (kBK / 4), kk = 4 * (c % (kBK / 4));
          const int n = r < tile.rows ? min(max(k_hi - k0 - kk, 0), 4) : 0;
          cp_async16(a_s + 4 * (r * kALd + kk),
                     n ? xe + (int64_t)r * x_sr + k0 + kk : x, 4 * n);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < kTM * kBK / kTThreads; ++i) {
          const int c = tid + i * kTThreads;
          const int r = c / kBK, kk = c % kBK;
          const bool ok = r < tile.rows && k0 + kk < k_hi;
          cp_async4(a_s + 4 * (r * kALd + kk),
                    ok ? xe + (int64_t)r * x_sr + k0 + kk : x, ok ? 4 : 0);
        }
      }
      if (bvec) {
#pragma unroll
        for (int i = 0; i < kBK * kTN / 4 / kTThreads; ++i) {
          const int c = tid + i * kTThreads;
          const int kk = c / (kTN / 4), cc = 4 * (c % (kTN / 4));
          const int n =
              k0 + kk < k_hi ? min(max(N - n0 - cc, 0), 4) : 0;
          cp_async16(b_s + 4 * (kk * kBLd + cc),
                     n ? we + (int64_t)(k0 + kk) * N + n0 + cc : w, 4 * n);
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < kBK * kTN / kTThreads; ++i) {
          const int c = tid + i * kTThreads;
          const int kk = c / kTN, cc = c % kTN;
          const bool ok = k0 + kk < k_hi && n0 + cc < N;
          cp_async4(b_s + 4 * (kk * kBLd + cc),
                    ok ? we + (int64_t)(k0 + kk) * N + n0 + cc : w,
                    ok ? 4 : 0);
        }
      }
    };

    // acc: the tile's sums; part: one slab's. The tensor cores add in
    // float32 without round-to-nearest, so a 1000s-long chain of their
    // additions loses ~1e-5 relative; each slab's 12 products per
    // fragment are summed there, and the slab sums added here in float32
    // (round to nearest) keep the result at float32 accuracy.
    float acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < nslab) load(s);
      cp_commit();
    }
    for (int s = 0; s < nslab; ++s) {
      cp_wait<kStages - 2>();   // slab s has landed (this thread's part)
      __syncthreads();          // ... everyone's; slab s - 1 is consumed
      if (s + kStages - 1 < nslab) load(s + kStages - 1);
      cp_commit();
      // ldmatrix rows: lanes 0-7, 8-15, 16-23, 24-31 address rows 0-7 /
      // 8-15 at k 0-3, then at k 4-7, of a 16 x 8 fragment (its four
      // 8 x 4 TF32 blocks are the four 8 x 8 b16 matrices)
      const float* a = As + (s % kStages) * kAStage +
                       (wm * MT * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kALd +
                       (lane >> 4) * 4;
      const float* b = Bs + (s % kStages) * kBStage + wn * NT * 8 + gq;
      float part[MT][NT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) part[i][j][v] = 0.f;
#pragma unroll
      for (int k8 = 0; k8 < kBK; k8 += 8) {
        uint32_t bb[NT][2], bs[NT][2];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* bp = b + (k8 + tq) * kBLd + j * 8;
          split_tf32(bp[0], bb[j][0], bs[j][0]);
          split_tf32(bp[4 * kBLd], bb[j][1], bs[j][1]);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          uint32_t ab[4], as[4];
          uint32_t r4[4];
          ldmatrix_x4(r4, a + i * 16 * kALd + k8);
#pragma unroll
          for (int v = 0; v < 4; ++v)
            split_tf32(__uint_as_float(r4[v]), ab[v], as[v]);
          // the small cross terms first, the big product last; each
          // pass covers the NT fragments of the row, so a fragment's
          // three products are NT independent products apart
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], as, bb[j]);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ab, bs[j]);
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_tf32(part[i][j], ab, bb[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[i][j][v] += part[i][j][v];
    }
    cp_wait<0>();
    __syncthreads();   // the ring is free for the next tile

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * MT * 16 + i * 16 + gq + 8 * h;
        if (r >= tile.rows) continue;
        float* o = out + (int64_t)(tile.m0 + r) * N;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int c = n0 + wn * NT * 8 + j * 8 + 2 * tq;
          if (c < N) o[c] = acc[i][j][2 * h];
          if (c + 1 < N) o[c + 1] = acc[i][j][2 * h + 1];
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
// unused). `vec` bit 0: N % 4 == 0 and w 16-byte aligned (16-byte weight
// loads); bit 1: x_sr % 4 == 0 and x 16-byte aligned (16-byte lhs
// copies, tile kernel). kind and splits as pt_gmm_plan gives them.
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
  if (kind == kTile) {
    static bool configured = false;   // above 48 KB must be opted into
    if (!configured) {
      cudaError_t e = cudaFuncSetAttribute(
          gmm_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)kTileSmem);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    gmm_tile_kernel<<<grid, kTThreads, kTileSmem, s>>>(
        xf, x_sr, wf, bi, dst, M, K, N, E, block_m, per, (vec >> 1) & 1,
        vec & 1);
  } else {
    gmm_rows_kernel<<<grid, kThreads, 0, s>>>(xf, x_sr, wf, bi, dst, M, K,
                                             N, E, block_m, per, vec & 1);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const int64_t n = (int64_t)M * N;
  sum_splits<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), n, splits);
  return (int)cudaGetLastError();
}
