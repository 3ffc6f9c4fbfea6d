// Weight-only int8 matmul (w8a16) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/int8_matmul.py _w8a16_call (pallas_call
//   at :66, kernel _w8a16_kernel :35), reached through w8a16_matmul :96.
//
// What it computes: out[M, N] = x[M, K] @ float(w[K, N]) in fp32, with x
// float32 or bfloat16 and w int8, UNSCALED: the caller multiplies by the
// per-output-channel scale / qmax (quantization/functional.py).
//
// What bounds it on the H100: at serving sizes (M = 1..16 decode and
// verify rows) the int8 weight bytes read from HBM: 12.6 MB per
// GPT-medium layer, 3.8 us at 3.35 TB/s, against 2 M K N flops that the
// card does in far less. A serving model's 24 layers (302 MB) do not fit
// the 50 MB L2, so every projection's weight comes from HBM. At M = 256
// (a prefill chunk) the products take over (2 x 256 K N flops: 24 us at
// the 67 TFLOP/s float32 SIMT rate, a few us on the tensor cores).
//
// What the design does about it: one launch per call, each weight byte
// read from HBM once per row tile (once per call up to 32 rows), never
// dequantized into device memory.
// * A block owns kBN = 64 output columns, a row tile and a contiguous
//   slice of K. Its weight strip streams through a ring of [kBK = 128,
//   64] int8 tiles, the row tile's x beside it in the same stages.
//   Staged bytes become fp32 in registers by a byte permute into the
//   mantissa of 2^23 (no conversion instruction).
// * Up to 8 rows (decode), w8a16_rows_kernel: a tile's weight box and x
//   box come by TMA (one cp.async.bulk.tensor each, completion on the
//   stage's mbarrier, zeros out of bounds; 16-byte cp.async where the
//   rows are not 16-byte aligned). Per-thread cp.async copies took about
//   as long to issue as their data took to arrive (per-block timer
//   stamps). Thread (column group cg, K group kg) reads 4 columns x 4 K
//   positions of a tile as four 32-bit words and feeds each weight to all
//   the block's rows by fp32 FMA; the 16 K groups' sums are added in a
//   fixed order (the warp's two groups by a butterfly, then the 8 warps
//   in order).
// * 9 to 32 rows a tile (verify batches and prefill chunks),
//   w8a16_tc_kernel: mma.sync m16n8k8 TF32 on the tensor cores, tiles by
//   16-byte cp.async into padded rows. An int8 weight is exact in TF32,
//   and float32 x is split by bit masks into a big and a small TF32 part:
//   big w + small w carries ~21 bits of x (2xTF32; bf16 x is exact in
//   TF32: one product). The 8 warps split each K tile (16 positions a
//   warp) and every warp covers all 64 columns; fragment column n of n8
//   fragment j is block column 8 n + j, so a lane's B fragments of all 8
//   fragments are two 8-byte reads (rows padded to 96 bytes: a half
//   warp's reads on distinct banks). Each warp's chain of products is at
//   most 4 a tile per split, and the 8 warps' sums are added in warp
//   order in float32. On the H100 this body was the faster from 16 rows
//   up and the FMA body at 1-8 rows (PERF.md §6).
// * Few column strips leave SMs idle (N = 1024 is 16 strips), so a call
//   splits K over up to 8 blocks (the host's choice, w8a16_tiling in the
//   wrapper: about one block an SM). The splits of a strip form one
//   thread-block cluster: after a cluster barrier, each block sums a
//   share of the strip's outputs over the cluster's blocks in rank order,
//   reading their partial tiles through distributed shared memory, and
//   writes it; a second barrier keeps every partial tile alive until it
//   has been read. No workspace, no atomics and no second launch: a
//   result is the same bits from run to run.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "int8_convert.cuh"
#include "tf32_mma.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 64;            // output columns a block
constexpr int kBK = 128;           // K positions a ring stage
constexpr int kMaxSplits = 8;      // blocks a cluster
// the rows kernel: 16 column groups of 4 x 16 K groups of 2 x 4 a tile
constexpr int kColGroups = kBN / 4;
constexpr int kKGroups = kThreads / kColGroups;
static_assert(kBK == 2 * 4 * kKGroups, "a K group holds 2 x 4 of a tile");
static_assert(kColGroups == 16, "a warp holds two K groups");
// the tensor-core kernel: 16 K positions of a tile a warp
constexpr int kKW = kBK / kWarps;
static_assert(kKW == 16, "a warp takes two k8 steps of a tile");
constexpr int kPLd = kBN + 4;      // padded row of a warp's sums

enum DType { kF32 = 0, kBF16 = 1 };
enum Copy { kCopySync = 0, kCopy4 = 4, kCopy16 = 16 };

// Shared memory of one kernel instance: ROWS rows a block, the rows
// (false) or tensor-core (true) body. A ring of stages (the weight tile
// [kBK][kWLd], then the x tile [ROWS][kXLd]), which holds the warps' sums
// once the K loop is done; then the block's sums [ROWS][kBN].
template <typename T, int ROWS, bool TC>
struct Layout {
  // x rows: plain for the rows kernel; for ldmatrix, float32 rows of kBK
  // + 4 put a block's 8 rows on distinct banks, bf16 rows of kBK + 8 the
  // A fragment's 8 rows
  static constexpr int kXLd = !TC ? kBK : sizeof(T) == 4 ? kBK + 4 : kBK + 8;
  // weight rows (bytes): the rows kernel's as a TMA box lands them; the
  // tensor-core kernel's padded so its B fragment reads miss each other
  static constexpr int kWLd = TC ? kBN + 32 : kBN;
  static constexpr int kStages = TC ? 3 : 4;
  static constexpr int kStage = kBK * kWLd + ROWS * kXLd * (int)sizeof(T);
  static constexpr int kSums =
      kWarps * ROWS * (TC ? kPLd : kBN) * (int)sizeof(float);
  static constexpr int kRing =
      kStages * kStage > kSums ? kStages * kStage : kSums;
  // + the ring's mbarriers, + alignment of the ring to 128 bytes
  static constexpr size_t kSmem =
      kRing + sizeof(float) * ROWS * kBN + 8 * kStages + 128;
};

__device__ __forceinline__ unsigned char* align128(unsigned char* p) {
  return p + ((128u - (smem_addr(p) & 127u)) & 127u);
}

// the box of `map` at (c0, c1) (innermost first) into dst
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// The rows kernel's tensor maps: w [K, N] int8 in [kBK, kBN] boxes, x
// [M, K] in [ROWS, kBK] boxes; used where `use` says (16-byte aligned
// rows), else cp.async. Out of bounds reads as zeros.
struct Maps {
  CUtensorMap w, x;
  int use_w, use_x;
};

// four consecutive staged x values (16- or 8-byte aligned)
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

// One thread's part in staging K tile t of its split: the weight tile
// [kBK][kBN] (rows k0.., columns n0..; zeros past k_hi and N) and the x
// tile [ROWS][kBK] (zeros past the call's rows and k_hi), each by a TMA
// box that thread 0 issues on the stage's mbarrier (where `maps` says),
// else by cp.async of wmode / xmode bytes, or plain loads (kCopySync).
// Splits end at multiples of kBK, so a tile passes k_hi only at K, where
// a TMA box reads zeros.
template <typename T, int ROWS, bool TC>
struct Stager {
  using L = Layout<T, ROWS, TC>;
  const T* x;
  const int8_t* w;
  unsigned char* ring;
  int64_t x_sr;
  int N, n0, m0, rows, k_lo, k_hi, wmode, xmode, tid;
  const Maps* maps;   // null: cp.async only
  uint64_t* bars;     // a stage's TMA completion
  __device__ __forceinline__ bool tma() const {
    return maps && (maps->use_w || maps->use_x);
  }
  __device__ __forceinline__ void issue(int t) const {
    unsigned char* st = ring + (t % L::kStages) * L::kStage;
    int8_t* ws = reinterpret_cast<int8_t*>(st);
    T* xs = reinterpret_cast<T*>(st + kBK * L::kWLd);
    const int k0 = k_lo + t * kBK;
    const bool tw = maps && maps->use_w, tx = maps && maps->use_x;
    if ((tw || tx) && tid == 0) {
      uint64_t* bar = bars + t % L::kStages;
      mbar_expect_tx(bar, (tw ? kBK * kBN : 0) +
                              (tx ? ROWS * kBK * (int)sizeof(T) : 0));
      if (tw) tma_load(ws, &maps->w, bar, n0, k0);
      if (tx) tma_load(xs, &maps->x, bar, k0, m0);
    }
    if (!tw && wmode != kCopySync) {
      const int per_row = kBN / wmode;   // copies a weight row
      for (int c = tid; c < kBK * per_row; c += kThreads) {
        const int r = c / per_row, col = (c - r * per_row) * wmode;
        const bool ok = k0 + r < k_hi && n0 + col < N;
        const int8_t* src = ok ? w + (int64_t)(k0 + r) * N + n0 + col : w;
        const uint32_t dst = smem_addr(ws + r * L::kWLd + col);
        if (wmode == kCopy16)
          cp_async16(dst, src, ok ? 16 : 0);
        else
          cp_async4(dst, src, ok ? 4 : 0);
      }
    } else if (!tw) {
      for (int c = tid; c < kBK * kBN; c += kThreads) {
        const int r = c / kBN, col = c - r * kBN;
        ws[r * L::kWLd + col] = (k0 + r < k_hi && n0 + col < N)
                                    ? w[(int64_t)(k0 + r) * N + n0 + col]
                                    : (int8_t)0;
      }
    }
    if (!tx && xmode != kCopySync) {
      const int epc = xmode / (int)sizeof(T);   // elements a copy
      const int per_row = kBK / epc;
      for (int c = tid; c < ROWS * per_row; c += kThreads) {
        const int r = c / per_row, kk = (c - r * per_row) * epc;
        const int left = r < rows ? k_hi - (k0 + kk) : 0;
        const int bytes = max(0, min(epc, left)) * (int)sizeof(T);
        const T* src = bytes ? x + (int64_t)(m0 + r) * x_sr + k0 + kk : x;
        const uint32_t dst = smem_addr(xs + r * L::kXLd + kk);
        if (xmode == kCopy16)
          cp_async16(dst, src, bytes);
        else
          cp_async4(dst, src, bytes);
      }
    } else if (!tx) {
      for (int c = tid; c < ROWS * kBK; c += kThreads) {
        const int r = c / kBK, kk = c - r * kBK;
        xs[r * L::kXLd + kk] = (r < rows && k0 + kk < k_hi)
                                   ? x[(int64_t)(m0 + r) * x_sr + k0 + kk]
                                   : T(0.f);
      }
    }
  }
};

// The block's part of the call: the call's geometry from the grid (splits,
// column strips, row tiles of ROWS), cluster (splits, 1, 1); split z
// covers K positions [z per, min(K, (z + 1) per)), per a multiple of kBK.
template <int ROWS>
struct Part {
  int z, splits, n0, m0, rows, k_lo, k_hi, nt;
  __device__ Part(int M, int K, int per) {
    z = blockIdx.x;
    splits = gridDim.x;
    n0 = blockIdx.y * kBN;
    m0 = blockIdx.z * ROWS;
    rows = min(ROWS, M - m0);
    k_lo = z * per;
    k_hi = min(K, k_lo + per);
    nt = (k_hi - k_lo + kBK - 1) / kBK;
  }
};

// Writes the strip's output once this thread has put the block's sums of
// elements tid, tid + kThreads, ... into res [ROWS][kBN]: with one split,
// those sums; else, after a cluster barrier, block z sums elements
// z kThreads + tid, ... over the cluster's blocks in rank order.
template <int ROWS>
__device__ __forceinline__ void store_strip(const Part<ROWS>& p, float* res,
                                            float* __restrict__ out, int N) {
  const int tid = threadIdx.x;
  if (p.splits == 1) {
    for (int e = tid; e < ROWS * kBN; e += kThreads) {
      const int r = e / kBN, c = p.n0 + e - r * kBN;
      if (r < p.rows && c < N) out[(int64_t)(p.m0 + r) * N + c] = res[e];
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = p.z * kThreads + tid; e < ROWS * kBN;
       e += p.splits * kThreads) {
    float v[kMaxSplits];   // all the remote reads in flight at once
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < p.splits) v[q] = cluster.map_shared_rank(res, q)[e];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q)
      if (q < p.splits) s += v[q];
    const int r = e / kBN, c = p.n0 + e - r * kBN;
    if (r < p.rows && c < N) out[(int64_t)(p.m0 + r) * N + c] = s;
  }
  cluster.sync();   // no block leaves while another reads its sums
}

// Up to 8 rows: fp32 FMA, every weight fed to all RB rows.
// (launch bounds: with no minimum of blocks, ptxas held a 16-row build
// to 128 registers and spilled)
template <typename T, int RB>
__global__ void __launch_bounds__(kThreads, 1)
    w8a16_rows_kernel(const T* __restrict__ x, int64_t x_sr,
                      const int8_t* __restrict__ w, float* __restrict__ out,
                      int M, int K, int N, int per, int wmode, int xmode,
                      const __grid_constant__ Maps maps) {
  using L = Layout<T, RB, false>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem = align128(smem_raw);   // TMA boxes: 128-byte aligned
  const Part<RB> p(M, K, per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cg_ = tid % kColGroups, kg = tid / kColGroups;
  float* res = reinterpret_cast<float*>(smem + L::kRing);
  uint64_t* bars = reinterpret_cast<uint64_t*>(res + RB * kBN);

  const Stager<T, RB, false> st{x,      w,      smem,   x_sr,   N,
                                p.n0,   p.m0,   p.rows, p.k_lo, p.k_hi,
                                wmode,  xmode,  tid,    &maps,  bars};
  if (st.tma()) {
    if (tid == 0) {
      for (int s = 0; s < L::kStages; ++s) mbar_init(bars + s, 1);
      fence_barrier_init();
    }
    __syncthreads();
  }
  float acc[RB][4];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
#pragma unroll
  for (int t = 0; t < L::kStages - 1; ++t) {
    if (t < p.nt) st.issue(t);
    cp_commit();
  }
  for (int t = 0; t < p.nt; ++t) {
    cp_wait<L::kStages - 2>();
    if (st.tma()) mbar_wait(bars + t % L::kStages, (t / L::kStages) & 1);
    __syncthreads();   // tile t landed; tile t - 1's stage is consumed
    if (t + L::kStages - 1 < p.nt) st.issue(t + L::kStages - 1);
    cp_commit();
    const unsigned char* sb = smem + (t % L::kStages) * L::kStage;
    const T* xs = reinterpret_cast<const T*>(sb + kBK * L::kWLd);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kb = 4 * kg + 4 * kKGroups * h;   // K positions kb .. kb + 3
      float4 wv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        wv[u] = pt::i8x4(*reinterpret_cast<const uint32_t*>(
            sb + (kb + u) * L::kWLd + 4 * cg_));
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float4 xv = load4(xs + r * kBK + kb);
        acc[r][0] += xv.x * wv[0].x;
        acc[r][1] += xv.x * wv[0].y;
        acc[r][2] += xv.x * wv[0].z;
        acc[r][3] += xv.x * wv[0].w;
        acc[r][0] += xv.y * wv[1].x;
        acc[r][1] += xv.y * wv[1].y;
        acc[r][2] += xv.y * wv[1].z;
        acc[r][3] += xv.y * wv[1].w;
        acc[r][0] += xv.z * wv[2].x;
        acc[r][1] += xv.z * wv[2].y;
        acc[r][2] += xv.z * wv[2].z;
        acc[r][3] += xv.z * wv[2].w;
        acc[r][0] += xv.w * wv[3].x;
        acc[r][1] += xv.w * wv[3].y;
        acc[r][2] += xv.w * wv[3].z;
        acc[r][3] += xv.w * wv[3].w;
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free: it holds the warps' sums now

  // the warp's two K groups (lanes l and l ^ 16) added, then the 8
  // warps' sums in warp order
  float* part = reinterpret_cast<float*>(smem);   // [kWarps][RB][kBN]
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float4 v;
    v.x = acc[r][0] + __shfl_xor_sync(0xffffffffu, acc[r][0], 16);
    v.y = acc[r][1] + __shfl_xor_sync(0xffffffffu, acc[r][1], 16);
    v.z = acc[r][2] + __shfl_xor_sync(0xffffffffu, acc[r][2], 16);
    v.w = acc[r][3] + __shfl_xor_sync(0xffffffffu, acc[r][3], 16);
    if (lane < 16)
      *reinterpret_cast<float4*>(part + (warp * RB + r) * kBN + 4 * cg_) = v;
  }
  __syncthreads();
  for (int e = tid; e < RB * kBN; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += part[q * RB * kBN + e];
    res[e] = s;
  }
  store_strip(p, res, out, N);
}

// The A fragments (big and small TF32 parts) of m16 fragment i at K
// offset k8 of the staged x tile. float32: ldmatrix, then the bit-mask
// split; bf16: exact in TF32, no small part.
__device__ __forceinline__ void a_frag(const float* xs, int i, int k8,
                                       int lane, uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  constexpr int XLD = kBK + 4;
  // lanes 0-7, 8-15, 16-23, 24-31 address rows 0-7 / 8-15 at k 0-3, then
  // at k 4-7, of the 16 x 8 fragment
  uint32_t r4[4];
  ldmatrix_x4(r4, xs + (i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * XLD +
                      (lane >> 4) * 4 + k8);
#pragma unroll
  for (int v = 0; v < 4; ++v) split_tf32(__uint_as_float(r4[v]), big[v],
                                         small[v]);
}
__device__ __forceinline__ void a_frag(const __nv_bfloat16* xs, int i,
                                       int k8, int lane, uint32_t (&big)[4],
                                       uint32_t (&)[4]) {
  constexpr int XLD = kBK + 8;
  const uint16_t* xh = reinterpret_cast<const uint16_t*>(xs);
  const int r0 = (i * 16 + (lane >> 2)) * XLD + k8 + (lane & 3);
  big[0] = (uint32_t)xh[r0] << 16;
  big[1] = (uint32_t)xh[r0 + 8 * XLD] << 16;
  big[2] = (uint32_t)xh[r0 + 4] << 16;
  big[3] = (uint32_t)xh[r0 + 8 * XLD + 4] << 16;
}

// Byte i of a staged word of weights as a TF32 operand (exact)
__device__ __forceinline__ uint32_t w_tf32(uint32_t w, int i) {
  return __float_as_uint(pt::i8_at(w, i));
}

// 16 TMF rows a block: the products on the tensor cores.
template <typename T, int TMF>
__global__ void __launch_bounds__(kThreads)
    w8a16_tc_kernel(const T* __restrict__ x, int64_t x_sr,
                    const int8_t* __restrict__ w, float* __restrict__ out,
                    int M, int K, int N, int per, int wmode, int xmode) {
  constexpr int TM = 16 * TMF;
  using L = Layout<T, TM, true>;
  extern __shared__ __align__(16) unsigned char smem[];
  const Part<TM> p(M, K, per);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;   // mma group / thread in group
  float* res = reinterpret_cast<float*>(smem + L::kRing);

  const Stager<T, TM, true> st{x,     w,      smem,   x_sr,   N,
                               p.n0,  p.m0,   p.rows, p.k_lo, p.k_hi,
                               wmode, xmode,  tid,    nullptr, nullptr};
  float acc[TMF][8][4];
#pragma unroll
  for (int i = 0; i < TMF; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;
#pragma unroll
  for (int t = 0; t < L::kStages - 1; ++t) {
    if (t < p.nt) st.issue(t);
    cp_commit();
  }
  for (int t = 0; t < p.nt; ++t) {
    cp_wait<L::kStages - 2>();
    __syncthreads();   // tile t landed; tile t - 1's stage is consumed
    if (t + L::kStages - 1 < p.nt) st.issue(t + L::kStages - 1);
    cp_commit();
    const unsigned char* sb = smem + (t % L::kStages) * L::kStage;
    const T* xs = reinterpret_cast<const T*>(sb + kBK * L::kWLd);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k8 = kKW * warp + 8 * h;
      // this lane's B fragments: block columns 8 gq .. 8 gq + 7 (n8
      // fragment j takes 8 gq + j) at rows k8 + tq and k8 + tq + 4
      const uint2 lo = *reinterpret_cast<const uint2*>(
          sb + (k8 + tq) * L::kWLd + 8 * gq);
      const uint2 hi = *reinterpret_cast<const uint2*>(
          sb + (k8 + tq + 4) * L::kWLd + 8 * gq);
      uint32_t b[8][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j][0] = w_tf32(lo.x, j);
        b[j + 4][0] = w_tf32(lo.y, j);
        b[j][1] = w_tf32(hi.x, j);
        b[j + 4][1] = w_tf32(hi.y, j);
      }
#pragma unroll
      for (int i = 0; i < TMF; ++i) {
        uint32_t big[4], small[4];
        a_frag(xs, i, k8, lane, big, small);
        // the small product first, the big one last
        if constexpr (sizeof(T) == 4) {
#pragma unroll
          for (int j = 0; j < 8; ++j) mma_tf32(acc[i][j], small, b[j]);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(acc[i][j], big, b[j]);
      }
    }
  }
  cp_wait<0>();
  __syncthreads();   // the ring is free: it holds the warps' sums now

  // fragment element (i, j, v): row 16 i + gq + 8 (v / 2), fragment
  // column 2 tq + v % 2, so block column 8 (2 tq + v % 2) + j
  float* part = reinterpret_cast<float*>(smem);   // [kWarps][TM][kPLd]
#pragma unroll
  for (int i = 0; i < TMF; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        part[(warp * TM + 16 * i + gq + 8 * (v >> 1)) * kPLd +
             8 * (2 * tq + (v & 1)) + j] = acc[i][j][v];
  __syncthreads();
  // the warps' sums added in warp order
  for (int e = tid; e < TM * kBN; e += kThreads) {
    const int r = e / kBN, c = e - r * kBN;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) s += part[(q * TM + r) * kPLd + c];
    res[e] = s;
  }
  store_strip(p, res, out, N);
}

// a 2-D map of a [rows, cols] tensor of `type` (row stride `stride`
// bytes) read in [box_rows, box_cols] boxes, zeros out of bounds
bool encode(CUtensorMap* map, CUtensorMapDataType type, const void* base,
            long long rows, long long cols, long long stride, int box_rows,
            int box_cols) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  // an extent-1 axis is never stepped, so any legal stride will do
  const cuuint64_t strides[1] = {(cuuint64_t)(rows > 1 ? stride : 16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// One launch of the kernel for ROWS rows a block (1, 2, 4, 8: the rows
// kernel, its tiles by TMA where the rows are 16-byte aligned; 16, 32:
// the tensor-core kernel).
template <typename T, int ROWS>
int launch(const void* x, long long x_sr, const void* w, void* out, int M,
           int K, int N, int splits, int per, cudaStream_t stream) {
  constexpr bool kTC = ROWS >= 16;
  const uintptr_t wb = reinterpret_cast<uintptr_t>(w);
  const uintptr_t xb = reinterpret_cast<uintptr_t>(x);
  const long long xrow = x_sr * (long long)sizeof(T);
  const int wmode = (N % 16 == 0 && wb % 16 == 0)  ? kCopy16
                    : (N % 4 == 0 && wb % 4 == 0) ? kCopy4
                                                  : kCopySync;
  const int xmode = (xrow % 16 == 0 && xb % 16 == 0)  ? kCopy16
                    : (xrow % 4 == 0 && xb % 4 == 0) ? kCopy4
                                                     : kCopySync;
  constexpr size_t smem = Layout<T, ROWS, kTC>::kSmem;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + kBN - 1) / kBN, (M + ROWS - 1) / ROWS);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static bool configured = false;   // above 48 KB must be opted into
  cudaError_t e = cudaSuccess;
  if constexpr (kTC) {
    constexpr auto kernel = w8a16_tc_kernel<T, ROWS / 16>;
    if (!configured)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           (int64_t)x_sr, static_cast<const int8_t*>(w),
                           static_cast<float*>(out), M, K, N, per * kBK,
                           wmode, xmode);
  } else {
    constexpr auto kernel = w8a16_rows_kernel<T, ROWS>;
    if (!configured)
      e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
    Maps maps = {};
    maps.use_w = wmode == kCopy16 &&
                 encode(&maps.w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K, N, N,
                        kBK, kBN);
    maps.use_x = xb % 16 == 0 && (M == 1 || xrow % 16 == 0) &&
                 encode(&maps.x,
                        sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                        x, M, K, xrow, ROWS, kBK);
    e = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                           (int64_t)x_sr, static_cast<const int8_t*>(w),
                           static_cast<float*>(out), M, K, N, per * kBK,
                           wmode, xmode, maps);
  }
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rows(const void* x, long long x_sr, const void* w, void* out,
                int M, int K, int N, int rows, int splits, int per,
                cudaStream_t s) {
  switch (rows) {
    case 1: return launch<T, 1>(x, x_sr, w, out, M, K, N, splits, per, s);
    case 2: return launch<T, 2>(x, x_sr, w, out, M, K, N, splits, per, s);
    case 4: return launch<T, 4>(x, x_sr, w, out, M, K, N, splits, per, s);
    case 8: return launch<T, 8>(x, x_sr, w, out, M, K, N, splits, per, s);
    case 16: return launch<T, 16>(x, x_sr, w, out, M, K, N, splits, per, s);
    case 32: return launch<T, 32>(x, x_sr, w, out, M, K, N, splits, per, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Shapes the host's tiling (w8a16_tiling in the wrapper) cuts by.
extern "C" int pt_w8a16_block_n() { return kBN; }
extern "C" int pt_w8a16_block_k() { return kBK; }
extern "C" int pt_w8a16_max_splits() { return kMaxSplits; }

// x [M, K] (row stride x_sr elements, K contiguous) of `dtype`; w int8
// [K, N] contiguous; out float32 [M, N] contiguous. rows: rows a block
// (1, 2, 4 or 8: the rows kernel; 16 or 32: the tensor-core kernel);
// splits blocks split K, each `per` K tiles of kBK (the last one fewer):
// every split must own at least one K position and together they must
// cover K.
extern "C" int pt_w8a16_matmul(int dtype, const void* x, long long x_sr,
                               const void* w, void* out, int M, int K,
                               int N, int rows, int splits, int per,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long span = (long long)per * kBK;
  if (M < 1 || K < 1 || N < 1 || splits < 1 || splits > kMaxSplits ||
      per < 1 || (splits - 1) * span >= K || splits * span < K)
    return (int)cudaErrorInvalidValue;
  if (dtype == kF32)
    return launch_rows<float>(x, x_sr, w, out, M, K, N, rows, splits, per,
                              s);
  if (dtype == kBF16)
    return launch_rows<__nv_bfloat16>(x, x_sr, w, out, M, K, N, rows,
                                      splits, per, s);
  return (int)cudaErrorInvalidValue;
}
