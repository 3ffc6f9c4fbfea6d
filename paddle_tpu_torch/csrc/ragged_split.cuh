// Split-KV ragged paged attention body for Hopper (sm_90a): the float32
// and bf16 pool kernel of paged_attention.cu. See that source for what it
// computes and why it is laid out so.
//
// Work items: (query tile, span) x kv head. A span is kSpan key positions
// aligned to ABSOLUTE positions ([s kSpan, (s + 1) kSpan)), cut at the
// tile's causal frontier. One block scores every query row of its tile
// (tile rows x the g query heads of its kv head) against the span's keys
// and writes each row's partial online-softmax state (m, l, acc) to a
// workspace slot; combine_kernel merges a row's spans in span order.
//
// Inside a block the span streams through a ring of NS shared-memory
// stages of kCh positions (K and V in the pool's own element type, each
// position's page row copied by cp.async: 16 bytes a copy where the rows
// allow it, 4 bytes otherwise, plain loads below that; each row padded
// by 16 bytes, so the 32 lanes reading 32 keys' rows hit distinct banks).
// The pool row of every position of the span is computed once from the
// block table.
//
// Every row's arithmetic is fixed by key positions alone: the row's warp
// (row mod kSWarps) gives lane j the key at chunk offset j and sums its
// dot product over head elements in a fixed order, takes max and sum by
// the same butterflies, and adds p v over keys in an order fixed by their
// positions. Chunk and span edges sit at absolute positions. So a row's
// bits do not depend on the other rows of its tile or its step, nor on
// the tile width.
//
// The body is generic over the pool element type P (float, bf16: read
// through to_f / load4); an int8 pool would add its per-position scales
// to the ring and dequantize where those read a staged element.
#pragma once

#include "attention_common.cuh"

namespace pt {
namespace split {

constexpr int kSpan = 128;     // key positions per work item
constexpr int kCh = 32;        // key positions per ring stage: one a lane
constexpr int kSWarps = 4;
constexpr int kSThreads = kSWarps * 32;
constexpr int kRB = 4;         // rows a warp scores together

static_assert(kSpan % kCh == 0, "spans hold whole ring stages");

// Ring stages by accumulator width (NT = ceil(hd / 32)): 2 chunks of
// K/V in flight a block up to hd 128 (32-64 KB at float32), a ring that
// leaves room for 3 blocks an SM at hd 64 (4 stages measured slower).
template <int NT>
struct Stages {
  static constexpr int value = NT <= 4 ? 3 : 2;
};

enum Copy { kCopySync = 0, kCopy4 = 4, kCopy16 = 16 };

// Shared row stride (elements) of one position's K or V: the page row
// plus a pad (16 bytes with 16-byte copies, 4 otherwise) that spreads
// the rows of a chunk over the banks (lane j reads row j).
__host__ __device__ inline int row_ld(int hd, int psize, int copy) {
  return hd + (copy == kCopy16 ? 16 : 4) / psize;
}

__host__ __device__ inline size_t ring_bytes(int stages, int ld, int psize) {
  return (size_t)stages * 2 * kCh * ld * psize;   // a multiple of 64
}

// Shared memory of a block of `rows` query rows: the ring, each warp's
// probabilities [kRB, kCh], the span's pool rows [kSpan] (int64), then
// q, acc [rows, hd], m, l and the row positions [rows].
__host__ __device__ inline size_t smem_bytes(int stages, int rows, int hd,
                                             int ld, int psize) {
  return ring_bytes(stages, ld, psize) + sizeof(int64_t) * kSpan +
         sizeof(float) * ((size_t)2 * rows * hd + 3 * (size_t)rows +
                          (size_t)kSWarps * kRB * kCh);
}

template <int NT>
__host__ inline int max_rows_nt(int hd) {
  int rows = kMaxRows;
  while (rows > 0 && smem_bytes(Stages<NT>::value, rows, hd,
                                row_ld(hd, 4, kCopy16), 4) > kSmemLimit)
    --rows;
  return rows;
}

__host__ inline int max_rows(int hd) {
  if (hd < 1 || hd > kMaxHd) return 0;
  int r = 0;
  with_tiles(hd, [&](auto nt) { r = max_rows_nt<decltype(nt)::value>(hd); });
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Workspace: acc [nkv][n_items][max_rows][hd], then (m, l) [nkv][n_items]
// [max_rows][2]; slot (kvh, item, r) -> index (kvh n_items + item)
// max_rows + r.
struct Partials {
  float* acc;
  float* ml;
  int n_items, max_rows, hd;
  __device__ __forceinline__ int64_t slot(int kvh, int item, int r) const {
    return ((int64_t)kvh * n_items + item) * max_rows + r;
  }
};

// One thread's part in staging a span's chunks: chunk c -> ring stage
// c % stages (K at the stage's start, V after it), each position's page
// row (its pool row from row_s) by cp.async copies of `copy` bytes, or
// plain loads (kCopySync); positions past k_hi are not copied (never
// read). Where a row's copies divide the block, a thread keeps one
// column of copies.
template <typename P>
struct Stager {
  const P* pool;
  const int64_t* row_s;
  P* ring;
  int64_t v_off;
  int ld, stage, hd, copy, k_lo, k_hi, stages, tid;
  int epu, per_row, u_col, p_first, p_step;
  bool col;
  __device__ Stager(const P* pool_, const int64_t* row_s_, P* ring_,
                    int64_t v_off_, int ld_, int stage_, int hd_, int copy_,
                    int k_lo_, int k_hi_, int stages_, int tid_)
      : pool(pool_), row_s(row_s_), ring(ring_), v_off(v_off_), ld(ld_),
        stage(stage_), hd(hd_), copy(copy_), k_lo(k_lo_), k_hi(k_hi_),
        stages(stages_), tid(tid_) {
    epu = copy == kCopySync ? 1 : copy / (int)sizeof(P);
    per_row = hd / epu;
    col = copy != kCopySync && kSThreads % per_row == 0;
    u_col = col ? (tid % per_row) * epu : 0;
    p_first = col ? tid / per_row : 0;
    p_step = col ? kSThreads / per_row : 0;
  }
  __device__ __forceinline__ void row(P* dst, const P* src) const {
    if (copy == kCopy16) {
      cp_async16(dst, src);
      cp_async16(dst + stage, src + v_off);
    } else {
      cp_async4(dst, src);
      cp_async4(dst + stage, src + v_off);
    }
  }
  __device__ __forceinline__ void issue(int c) const {
    const int c0 = k_lo + c * kCh;
    const int nk = min(kCh, k_hi - c0);
    const int64_t* rows_c = row_s + (c0 - k_lo);
    P* ks = ring + (c % stages) * 2 * stage;
    if (col) {
      for (int p = p_first; p < nk; p += p_step)
        row(ks + p * ld + u_col, pool + rows_c[p] * hd + u_col);
    } else if (copy != kCopySync) {
      for (int i = tid; i < nk * per_row; i += kSThreads) {
        const int p = i / per_row, u = (i - p * per_row) * epu;
        row(ks + p * ld + u, pool + rows_c[p] * hd + u);
      }
    } else {
      for (int i = tid; i < nk * hd; i += kSThreads) {
        const int p = i / hd, d = i - p * hd;
        const P* src = pool + rows_c[p] * hd + d;
        ks[p * ld + d] = src[0];
        ks[stage + p * ld + d] = src[v_off];
      }
    }
  }
};

// What one warp keeps of a chunk: the staged K/V rows, the chunk's first
// position and live keys, and its row state in shared memory.
template <typename P>
struct Chunk {
  const P* ks;   // K rows [kCh][ld]
  const P* vs;   // V rows [kCh][ld]
  int c0, nv, ld, hd;
  bool vec;
};

// Keys j .. j + 3 of a staged chunk into a warp's accumulators a: lane
// element d = lane + 32 t, p from the warp's probabilities (zeros past
// nv, where V is not read).
template <int RB, int NT, typename P>
__device__ __forceinline__ void pv4(float (&a)[RB][NT], const Chunk<P>& ch,
                                    const float* __restrict__ p_w, int j,
                                    int lane) {
  float vd[4][NT];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      vd[u][t] = (j + u < ch.nv && d < ch.hd)
                     ? to_f(ch.vs[(j + u) * ch.ld + d]) : 0.f;
    }
#pragma unroll
  for (int b = 0; b < RB; ++b) {
    const float4 p4 = *reinterpret_cast<const float4*>(p_w + b * kCh + j);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      a[b][t] += p4.x * vd[0][t];
      a[b][t] += p4.y * vd[1][t];
      a[b][t] += p4.z * vd[2][t];
      a[b][t] += p4.w * vd[3][t];
    }
  }
}

// One warp scores RB of its rows (r0 + b kSWarps) against a staged
// chunk: lane j
// holds key c0 + j. The dot products run over head elements in order as
// two partial sums (even and odd 4-element groups, added at the end);
// softmax by butterflies; p v added over keys in position order into
// two accumulators (even and odd 4-key groups of the chunk, added at the
// end). Every choice depends on key positions alone, and a row that
// sees none of the chunk's keys is left bit for bit as it was (its p
// are zeros), so a row's bits do not depend on which rows share its
// group, its tile or its step.
template <int RB, int NT, typename P>
__device__ __forceinline__ void score_rows(const Chunk<P>& ch, int r0,
                                           const float* __restrict__ q_s,
                                           float* __restrict__ acc_s,
                                           float* __restrict__ m_s,
                                           float* __restrict__ l_s,
                                           const int* __restrict__ qpos_s,
                                           float* __restrict__ p_w,
                                           float scale, int lane) {
  const int hd = ch.hd;
  int r[RB];
#pragma unroll
  for (int b = 0; b < RB; ++b) r[b] = r0 + b * kSWarps;
  int qp[RB];
  bool any = false;
#pragma unroll
  for (int b = 0; b < RB; ++b) {
    qp[b] = qpos_s[r[b]];
    any |= qp[b] >= ch.c0;   // sees the chunk's first key
  }
  if (!any) return;   // warp-uniform
  float s0[RB], s1[RB];
#pragma unroll
  for (int b = 0; b < RB; ++b) s0[b] = s1[b] = 0.f;
  const P* kr = ch.ks + lane * ch.ld;
  if (ch.vec) {
    for (int d = 0; d < hd; d += 8) {
      const float4 ka = load4(kr + d);
#pragma unroll
      for (int b = 0; b < RB; ++b) {
        const float4 qa = *reinterpret_cast<const float4*>(q_s + r[b] * hd + d);
        s0[b] += qa.x * ka.x;
        s0[b] += qa.y * ka.y;
        s0[b] += qa.z * ka.z;
        s0[b] += qa.w * ka.w;
      }
      if (d + 4 < hd) {
        const float4 kb = load4(kr + d + 4);
#pragma unroll
        for (int b = 0; b < RB; ++b) {
          const float4 qb =
              *reinterpret_cast<const float4*>(q_s + r[b] * hd + d + 4);
          s1[b] += qb.x * kb.x;
          s1[b] += qb.y * kb.y;
          s1[b] += qb.z * kb.z;
          s1[b] += qb.w * kb.w;
        }
      }
    }
  } else {
    for (int d = 0; d < hd; ++d) {
      const float kd = to_f(kr[d]);
#pragma unroll
      for (int b = 0; b < RB; ++b) s0[b] += q_s[r[b] * hd + d] * kd;
    }
  }
  // online softmax, the RB rows' butterflies side by side
  bool ok[RB];
  float s[RB], mx[RB], ps[RB], m_new[RB], corr[RB];
#pragma unroll
  for (int b = 0; b < RB; ++b) {
    ok[b] = lane < ch.nv && ch.c0 + lane <= qp[b];
    s[b] = ok[b] ? (s0[b] + s1[b]) * scale : kNegInf;
    mx[b] = s[b];
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
#pragma unroll
    for (int b = 0; b < RB; ++b)
      mx[b] = fmaxf(mx[b], __shfl_xor_sync(0xffffffffu, mx[b], o));
#pragma unroll
  for (int b = 0; b < RB; ++b) {
    const float m_old = m_s[r[b]];
    m_new[b] = fmaxf(m_old, mx[b]);
    corr[b] = expf(m_old - m_new[b]);
    ps[b] = ok[b] ? expf(s[b] - m_new[b]) : 0.f;
    p_w[b * kCh + lane] = ps[b];
  }
#pragma unroll
  for (int o = 16; o; o >>= 1)
#pragma unroll
    for (int b = 0; b < RB; ++b)
      ps[b] += __shfl_xor_sync(0xffffffffu, ps[b], o);
  __syncwarp();
  if (lane == 0) {
#pragma unroll
    for (int b = 0; b < RB; ++b) {
      m_s[r[b]] = m_new[b];
      l_s[r[b]] = l_s[r[b]] * corr[b] + ps[b];
    }
  }
  // acc = acc corr + sum of p v; lane holds elements lane + 32 t
  float a0[RB][NT], a1[RB][NT];
#pragma unroll
  for (int b = 0; b < RB; ++b)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      a0[b][t] = d < hd ? acc_s[r[b] * hd + d] * corr[b] : 0.f;
      a1[b][t] = 0.f;
    }
  for (int j = 0; j < ch.nv; j += 8) {
    pv4<RB, NT>(a0, ch, p_w, j, lane);
    if (j + 4 < ch.nv) pv4<RB, NT>(a1, ch, p_w, j + 4, lane);
  }
#pragma unroll
  for (int b = 0; b < RB; ++b)
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int d = lane + 32 * t;
      if (d < hd) acc_s[r[b] * hd + d] = a0[b][t] + a1[b][t];
    }
  __syncwarp();   // p_w is read before the next row group writes it
}

// launch[2 b], launch[2 b + 1] = (slot, sequence, query offset, rows),
// (first packed row, span, 0, 0): block b's work item, heaviest first.
// grid (n_items, nkv), kSThreads threads. copy: kCopy16 / kCopy4 /
// kCopySync as the page rows' bytes and alignment allow.
// (launch bounds: without a minimum of blocks an SM, ptxas traded spills
// for occupancy here)
template <typename T, typename P, int NT, int NS>
__global__ void __launch_bounds__(kSThreads, 2)
    span_kernel(const T* __restrict__ q, int64_t q_sr, int64_t q_sh,
                const P* __restrict__ pool, const int* __restrict__ bt,
                int mb, const int* __restrict__ q_lens,
                const int* __restrict__ kv_lens,
                const int4* __restrict__ launch, Partials part, int nh,
                int nkv, int hd, int bs, float scale, int copy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int4 la = launch[2 * blockIdx.x];
  const int4 lb = launch[2 * blockIdx.x + 1];
  const int item = la.x, seq = la.y, n = la.w, row0 = lb.x;
  const int kvh = blockIdx.y;
  const int g = nh / nkv;
  const int rows = n * g;
  const int pos0 = kv_lens[seq] - q_lens[seq] + la.z;
  const int frontier = max(0, min(pos0 + n, mb * bs));
  const int k_lo = lb.y * kSpan;
  const int k_hi = min(k_lo + kSpan, frontier);
  const int nch = k_hi > k_lo ? (k_hi - k_lo + kCh - 1) / kCh : 0;
  const int* bt_row = bt + (int64_t)seq * mb;

  const int ld = row_ld(hd, sizeof(P), copy);
  const bool vec = hd % 4 == 0 && ld % 4 == 0;   // 4-element smem reads
  const int stage = kCh * ld;   // elements of K (or V) a stage
  // 16-byte aligned: the ring (a multiple of 64 bytes), p_s (2 KB),
  // row_s (2 KB), q_s
  P* ring = reinterpret_cast<P*>(smem_raw);
  float* p_s = reinterpret_cast<float*>(smem_raw +
                                        ring_bytes(NS, ld, sizeof(P)));
  int64_t* row_s = reinterpret_cast<int64_t*>(p_s + kSWarps * kRB * kCh);
  float* q_s = reinterpret_cast<float*>(row_s + kSpan);
  float* acc_s = q_s + rows * hd;
  float* m_s = acc_s + rows * hd;
  float* l_s = m_s + rows;
  int* qpos_s = reinterpret_cast<int*>(l_s + rows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < rows * hd; i += kSThreads) {
    const int r = i / hd, d = i - r * hd;
    const int64_t row = row0 + r / g, head = kvh * g + r % g;
    q_s[i] = to_f(q[row * q_sr + head * q_sh + d]);
    acc_s[i] = 0.f;
  }
  // pool row (element offset / hd) of K at each span position; V's is
  // nkv bs rows further
  for (int p = tid; p < k_hi - k_lo; p += kSThreads) {
    const int pos = k_lo + p;
    row_s[p] = ((int64_t)bt_row[pos / bs] * 2 * nkv + kvh) * bs + pos % bs;
  }
  for (int r = tid; r < rows; r += kSThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    qpos_s[r] = pos0 + r / g;
  }
  __syncthreads();
  const Stager<P> st(pool, row_s, ring, (int64_t)nkv * bs * hd, ld, stage,
                    hd, copy, k_lo, k_hi, NS, tid);
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < nch) st.issue(c);
    cp_commit();
  }
  float* p_w = p_s + warp * kRB * kCh;
  // this warp's rows: warp + kSWarps i
  const int mine = rows > warp ? (rows - warp + kSWarps - 1) / kSWarps : 0;
  for (int c = 0; c < nch; ++c) {
    cp_wait<NS - 2>();
    __syncthreads();   // chunk c landed; chunk c - 1's stage is consumed
    if (c + NS - 1 < nch) st.issue(c + NS - 1);
    cp_commit();
    Chunk<P> ch;
    ch.ks = ring + (c % NS) * 2 * stage;
    ch.vs = ch.ks + stage;
    ch.c0 = k_lo + c * kCh;
    ch.nv = min(kCh, k_hi - ch.c0);
    ch.ld = ld;
    ch.hd = hd;
    ch.vec = vec;
    // row groups of up to RBM rows (2 at the widest heads, for registers)
    constexpr int RBM = NT <= 4 ? kRB : 2;
    for (int i = 0; i < mine; i += RBM) {
      const int left = mine - i, r0 = warp + kSWarps * i;
      if constexpr (RBM >= 4) {
        if (left >= 4) {
          score_rows<4, NT>(ch, r0, q_s, acc_s, m_s, l_s, qpos_s, p_w,
                            scale, lane);
          continue;
        }
        if (left == 3) {
          score_rows<3, NT>(ch, r0, q_s, acc_s, m_s, l_s, qpos_s, p_w,
                            scale, lane);
          continue;
        }
      }
      if (left >= 2)
        score_rows<2, NT>(ch, r0, q_s, acc_s, m_s, l_s, qpos_s, p_w, scale,
                          lane);
      else
        score_rows<1, NT>(ch, r0, q_s, acc_s, m_s, l_s, qpos_s, p_w, scale,
                          lane);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // this span's partial state of every row
  for (int i = tid; i < rows * hd; i += kSThreads) {
    const int r = i / hd, d = i - r * hd;
    part.acc[part.slot(kvh, item, r) * hd + d] = acc_s[i];
  }
  for (int r = tid; r < rows; r += kSThreads) {
    const int64_t sl = part.slot(kvh, item, r);
    part.ml[2 * sl] = m_s[r];
    part.ml[2 * sl + 1] = l_s[r];
  }
}

// One warp per (packed row, query head, part of NT x 32 head elements):
// merge the row's spans in span order, m = max m_s, l = sum l_s
// e^(m_s - m), acc likewise; a row that saw no key (l == 0) gives zeros.
// tspan[t] = (first item, items) of tile t; row_tile[i] = the tile of
// packed row i.
template <typename T, int NT>
__global__ void __launch_bounds__(kSThreads)
    combine_kernel(Partials part, const int4* __restrict__ tiles,
                   const int2* __restrict__ tspan,
                   const int* __restrict__ row_tile, T* __restrict__ out,
                   int R, int nh, int nkv, int hd, int parts) {
  const int lane = threadIdx.x & 31;
  const int64_t wid =
      (int64_t)blockIdx.x * kSWarps + (threadIdx.x >> 5);
  if (wid >= (int64_t)R * nh * parts) return;
  const int ih = (int)(wid / parts);
  const int d0 = (int)(wid - (int64_t)ih * parts) * 32 * NT + lane;
  const int i = ih / nh, h = ih % nh;
  const int g = nh / nkv, kvh = h / g;
  const int t = row_tile[i];
  const int r = (i - tiles[t].w) * g + h % g;
  const int2 fs = tspan[t];
  float m = kNegInf;
  for (int k = 0; k < fs.y; ++k)
    m = fmaxf(m, part.ml[2 * part.slot(kvh, fs.x + k, r)]);
  float l = 0.f, acc[NT];
#pragma unroll
  for (int u = 0; u < NT; ++u) acc[u] = 0.f;
  for (int k = 0; k < fs.y; ++k) {
    const int64_t sl = part.slot(kvh, fs.x + k, r);
    const float w = expf(part.ml[2 * sl] - m);
    l += part.ml[2 * sl + 1] * w;
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int d = d0 + 32 * u;
      if (d < hd) acc[u] += part.acc[sl * hd + d] * w;
    }
  }
  const float inv = l == 0.f ? 1.f : l;
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int d = d0 + 32 * u;
    if (d < hd) out[((int64_t)i * nh + h) * hd + d] = from_f<T>(acc[u] / inv);
  }
}

// tables: launch [n_items][8], tiles [n_tiles][4], tspan [n_tiles][2],
// row_tile [R], packed in that order. ws: float32 [nkv, n_items,
// max_rows, hd + 2].
template <typename T, typename P, int NT>
int launch(const void* q, long long q_sr, long long q_sh, const void* pool,
           const int* bt, int mb, const int* q_lens, const int* kv_lens,
           const int* tables, int n_tiles, int n_items, void* ws, void* out,
           int R, int nh, int nkv, int hd, int bs, int max_rows, float scale,
           cudaStream_t stream) {
  constexpr int NS = Stages<NT>::value;
  const int4* lt = reinterpret_cast<const int4*>(tables);
  const int4* tiles = reinterpret_cast<const int4*>(tables + 8 * n_items);
  const int2* tspan =
      reinterpret_cast<const int2*>(tables + 8 * n_items + 4 * n_tiles);
  const int* row_tile = tables + 8 * n_items + 6 * n_tiles;
  Partials part{static_cast<float*>(ws),
                static_cast<float*>(ws) + (size_t)nkv * n_items * max_rows * hd,
                n_items, max_rows, hd};
  if (n_items > 0) {
    const int row_bytes = hd * (int)sizeof(P);
    const uintptr_t base = reinterpret_cast<uintptr_t>(pool);
    const int copy = (row_bytes % 16 == 0 && base % 16 == 0)  ? kCopy16
                     : (row_bytes % 4 == 0 && base % 4 == 0) ? kCopy4
                                                             : kCopySync;
    static size_t configured = 0;
    const size_t smem = smem_bytes(NS, max_rows, hd,
                                   row_ld(hd, sizeof(P), copy), sizeof(P));
    cudaError_t e = ensure_smem(span_kernel<T, P, NT, NS>, smem, &configured);
    if (e != cudaSuccess) return (int)e;
    span_kernel<T, P, NT, NS><<<dim3(n_items, nkv), kSThreads, smem, stream>>>(
        static_cast<const T*>(q), q_sr, q_sh, static_cast<const P*>(pool),
        bt, mb, q_lens, kv_lens, lt, part, nh, nkv, hd, bs, scale, copy);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // a warp merges up to 128 head elements of a (row, head)
  constexpr int NTC = NT < 4 ? NT : 4;
  const int parts = (hd + 32 * NTC - 1) / (32 * NTC);
  const int64_t warps = (int64_t)R * nh * parts;
  combine_kernel<T, NTC>
      <<<(unsigned)((warps + kSWarps - 1) / kSWarps), kSThreads, 0, stream>>>(
          part, tiles, tspan, row_tile, static_cast<T*>(out), R, nh, nkv,
          hd, parts);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int launch_hd(const void* q, long long q_sr, long long q_sh, const void* pool,
              const int* bt, int mb, const int* q_lens, const int* kv_lens,
              const int* tables, int n_tiles, int n_items, void* ws,
              void* out, int R, int nh, int nkv, int hd, int bs,
              int max_rows, float scale, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  with_tiles(hd, [&](auto nt) {
    err = launch<T, P, decltype(nt)::value>(
        q, q_sr, q_sh, pool, bt, mb, q_lens, kv_lens, tables, n_tiles,
        n_items, ws, out, R, nh, nkv, hd, bs, max_rows, scale, stream);
  });
  return err;
}

}  // namespace split
}  // namespace pt
