// Split-KV attention body for Hopper (sm_90a): the kernel of
// paged_attention.cu (float32 and bf16 pools), paged_attention_int8.cu
// (int8 pools with per-position scales) and decode_attention.cu (dense
// float32 / bf16 caches). See those sources for what they compute and
// why it is laid out so.
//
// Work items: (query tile, span) x kv head. A span is kSpan key positions
// aligned to ABSOLUTE positions ([s kSpan, (s + 1) kSpan)), cut at the
// tile's causal frontier. One block scores every query row of its tile
// (tile rows x the g query heads of its kv head) against the span's keys
// (span_body) and writes each row's partial online-softmax state (m, l,
// acc) to a workspace slot; merge_spans merges a row's spans in span
// order. The paged kernels take their items from the host plan and their
// K/V rows through the block table (PagedSrc); the dense decode kernel
// makes (row, span) items from its grid and reads its rows through the
// cache's strides (its DenseSrc).
//
// Inside a block the span streams through a ring of NS shared-memory
// stages of kCh positions (K and V in the pool's own element type, each
// position's page row copied by cp.async: 16 bytes a copy where the rows
// allow it, 4 bytes otherwise, plain loads below that; each row padded
// by 16 bytes, so the 32 lanes reading 32 keys' rows hit distinct banks).
// A paged block computes the pool row of every position of its span once
// from the block table.
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
// through to_f / load4; int8). An int8 pool stages each position's K and
// V scale beside its page rows, in the same ring stage ([2, kCh] float32
// after the rows) and the same cp.async group, and dequantizes where a
// staged element is read: a key's scale is factored out of its dot
// product (s = scale_k[p] sum q k_int8, then the softmax scale), and a
// value's scale is folded into its probability before p v (the row's
// l sums the unscaled p). Both are fixed per key position, so the rows
// stay independent of their step. int8 rows are read 16 bytes a lane
// (a quarter warp's 8 rows of 80 bytes at hd 64 fall on distinct banks)
// and converted by a byte permute into the mantissa of 2^23, no
// conversion instruction.
#pragma once

#include "attention_common.cuh"
#include "int8_convert.cuh"

namespace pt {

// an int8 page element as a float (no scale)
__device__ __forceinline__ float to_f(int8_t x) {
  return i8_at((uint8_t)x, 0);
}

namespace split {

template <typename P>
constexpr bool kQuant = std::is_same<P, int8_t>::value;

constexpr int kSpan = 128;     // key positions per work item
constexpr int kCh = 32;        // key positions per ring stage: one a lane
constexpr int kSWarps = 4;
constexpr int kSThreads = kSWarps * 32;
constexpr int kRB = 4;         // rows a warp scores together

static_assert(kSpan % kCh == 0, "spans hold whole ring stages");
static_assert(kSThreads >= kCh, "a thread stages one position's scales");

// Ring stages by pool type and accumulator width (NT = ceil(hd / 32)).
// float32 / bf16: 2 chunks of K/V in flight a block up to hd 128 (32-64
// KB at float32), a ring that leaves room for 3 blocks an SM at hd 64 (4
// stages measured slower). int8: a stage is 3.4x smaller (80-byte rows
// and 256 bytes of scales at hd 64, 5.4 KB), so 4 stages (a whole
// 128-position span) keep 16 KB in flight a block up to hd 128.
template <int NT, typename P>
struct Stages {
  static constexpr int value = kQuant<P> ? (NT <= 4 ? 4 : 3)
                                         : (NT <= 4 ? 3 : 2);
};

enum Copy { kCopySync = 0, kCopy4 = 4, kCopy16 = 16 };

// Shared row stride (elements) of one position's K or V: the page row
// plus a pad (16 bytes with 16-byte copies, 4 otherwise) that spreads
// the rows of a chunk over the banks (lane j reads row j). int8 rows
// read 4 bytes a lane take an odd number of words.
__host__ __device__ inline int row_ld(int hd, int psize, int copy) {
  if (psize == 1 && copy != kCopy16 && hd % 4 == 0)
    return hd + ((hd / 4) % 2 ? 8 : 4);
  return hd + (copy == kCopy16 ? 16 : 4) / psize;
}

// One ring stage: K and V rows [2][kCh][ld], then for int8 pools the
// positions' K and V scales [2][kCh] float32 (a multiple of 16 bytes).
__host__ __device__ inline size_t stage_bytes(int ld, int psize,
                                              bool quant) {
  return (size_t)2 * kCh * ld * psize + (quant ? 2 * kCh * sizeof(float)
                                               : 0);
}

// Shared memory of a block of `rows` query rows: the ring, each warp's
// probabilities [kRB, kCh], the span's pool rows [kSpan] (int64), then
// q, acc [rows, hd], m, l and the row positions [rows].
__host__ __device__ inline size_t smem_bytes(int stages, int rows, int hd,
                                             int ld, int psize,
                                             bool quant) {
  return stages * stage_bytes(ld, psize, quant) + sizeof(int64_t) * kSpan +
         sizeof(float) * ((size_t)2 * rows * hd + 3 * (size_t)rows +
                          (size_t)kSWarps * kRB * kCh);
}

template <typename P, int NT>
__host__ inline int max_rows_nt(int hd) {
  int rows = kMaxRows;
  while (rows > 0 &&
         smem_bytes(Stages<NT, P>::value, rows, hd,
                    row_ld(hd, sizeof(P), kCopy16), sizeof(P),
                    kQuant<P>) > kSmemLimit)
    --rows;
  return rows;
}

template <typename P>
__host__ inline int max_rows_hd(int hd) {
  if (hd < 1 || hd > kMaxHd) return 0;
  int r = 0;
  with_tiles(hd,
             [&](auto nt) { r = max_rows_nt<P, decltype(nt)::value>(hd); });
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

// Where a span's K/V rows come from: Src::krow(p) points at the head_dim
// vector of K at span position p (absolute position k_lo + p), and
// vrow(k, p, u) at element u of V's, given k = krow(p) + u; kscale(p)
// and vscale(ks) at an int8 pool's scales of it; prepare(tid), called by
// every thread before the block's first barrier, fills what the source
// keeps in shared memory. PagedSrc reads a pool [num_blocks, 2, nkv, bs,
// hd] through the span's pool rows (row_s, which prepare computes from
// the block table), V a fixed offset after K; DenseSrc in
// decode_attention.cu reads a dense cache through its strides.
template <typename P>
struct PagedSrc {
  const P* pool;
  const float* scales;
  int64_t* row_s;         // pool row (element offset / hd) of K at p
  int64_t v_srow;         // V's row is v_srow rows after K's
  int64_t v_off;          // v_srow hd
  int hd;
  const int* bt_row;      // the sequence's block table row
  int k_lo, n, kvh, nkv, bs;
  __device__ __forceinline__ void prepare(int tid) const {
    for (int p = tid; p < n; p += kSThreads) {
      const int pos = k_lo + p;
      row_s[p] = ((int64_t)bt_row[pos / bs] * 2 * nkv + kvh) * bs + pos % bs;
    }
  }
  __device__ __forceinline__ const P* krow(int p) const {
    return pool + row_s[p] * hd;
  }
  __device__ __forceinline__ const P* vrow(const P* k, int, int) const {
    return k + v_off;
  }
  __device__ __forceinline__ const float* kscale(int p) const {
    return scales + row_s[p];
  }
  __device__ __forceinline__ const float* vscale(const float* ks) const {
    return ks + v_srow;
  }
};

// One thread's part in staging a span's chunks: chunk c -> ring stage
// c % stages (K at the stage's start, V after it, then an int8 pool's
// scales), each position's K and V rows (from src) by cp.async copies of
// `copy` bytes, or plain loads (kCopySync); positions past k_hi are not
// copied (never read). Where a row's copies divide the block, a thread
// keeps one column of copies. An int8 pool's K and V scales of a
// position are copied by 4-byte cp.async into the same stage, in the
// same group.
template <typename P, class Src>
struct Stager {
  Src src;
  unsigned char* ring;
  int ld, stage, hd, copy, k_lo, k_hi, stages, tid;
  int epu, per_row, u_col, p_first, p_step;
  bool col;
  __device__ Stager(const Src& src_, unsigned char* ring_, int ld_,
                    int stage_, int hd_, int copy_, int k_lo_, int k_hi_,
                    int stages_, int tid_)
      : src(src_), ring(ring_), ld(ld_), stage(stage_), hd(hd_),
        copy(copy_), k_lo(k_lo_), k_hi(k_hi_), stages(stages_), tid(tid_) {
    epu = copy == kCopySync ? 1 : copy / (int)sizeof(P);
    per_row = hd / epu;
    col = copy != kCopySync && kSThreads % per_row == 0;
    u_col = col ? (tid % per_row) * epu : 0;
    p_first = col ? tid / per_row : 0;
    p_step = col ? kSThreads / per_row : 0;
  }
  __device__ __forceinline__ P* stage_at(int c) const {
    return reinterpret_cast<P*>(
        ring + (c % stages) * stage_bytes(ld, sizeof(P), kQuant<P>));
  }
  // elements u .. of span position p into stage row dst
  __device__ __forceinline__ void row(P* dst, int p, int u) const {
    const P* k = src.krow(p) + u;
    const P* v = src.vrow(k, p, u);
    if (copy == kCopy16) {
      cp_async16(dst, k);
      cp_async16(dst + stage, v);
    } else {
      cp_async4(dst, k);
      cp_async4(dst + stage, v);
    }
  }
  __device__ __forceinline__ void issue(int c) const {
    const int c0 = k_lo + c * kCh;
    const int nk = min(kCh, k_hi - c0);
    const int pc = c0 - k_lo;   // span position of the chunk's first key
    P* ks = stage_at(c);
    if constexpr (kQuant<P>) {
      float* sc = reinterpret_cast<float*>(ks + 2 * stage);
      if (tid < nk) {   // kSThreads >= kCh: one position a thread
        const float* sk = src.kscale(pc + tid);
        if (copy != kCopySync) {
          cp_async4(sc + tid, sk);
          cp_async4(sc + kCh + tid, src.vscale(sk));
        } else {
          sc[tid] = sk[0];
          sc[kCh + tid] = *src.vscale(sk);
        }
      }
    }
    if (col) {
      for (int p = p_first; p < nk; p += p_step)
        row(ks + p * ld + u_col, pc + p, u_col);
    } else if (copy != kCopySync) {
      for (int i = tid; i < nk * per_row; i += kSThreads) {
        const int p = i / per_row, u = (i - p * per_row) * epu;
        row(ks + p * ld + u, pc + p, u);
      }
    } else {
      for (int i = tid; i < nk * hd; i += kSThreads) {
        const int p = i / hd, d = i - p * hd;
        const P* k = src.krow(pc + p) + d;
        ks[p * ld + d] = k[0];
        ks[stage + p * ld + d] = src.vrow(k, pc + p, d)[0];
      }
    }
  }
};

// The ring's first NS - 1 chunks of nch, one cp.async group each (empty
// groups past nch), so that chunk c is waited for by cp_wait<NS - 2>.
template <int NS, class St>
__device__ __forceinline__ void prime(const St& st, int nch) {
#pragma unroll
  for (int c = 0; c < NS - 1; ++c) {
    if (c < nch) st.issue(c);
    cp_commit();
  }
}

// What one warp keeps of a chunk: the staged K/V rows (and an int8
// pool's scales), the chunk's first position and live keys, and how
// wide K may be read (16, 4 or 1 elements: vw).
template <typename P>
struct Chunk {
  const P* ks;      // K rows [kCh][ld]
  const P* vs;      // V rows [kCh][ld]
  const float* sc;  // int8 pools: K scales [kCh], then V scales [kCh]
  int c0, nv, ld, hd, vw;
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

// s0[b] / s1[b] += q[r[b], d .. d + 3] . k[d .. d + 3] for one group of
// four head elements (k as floats); even groups of the head go to s0,
// odd ones to s1.
template <int RB>
__device__ __forceinline__ void dot4(float (&s)[RB], const float* q_s,
                                     const int (&r)[RB], int hd, int d,
                                     const float4& k) {
#pragma unroll
  for (int b = 0; b < RB; ++b) {
    const float4 qa = *reinterpret_cast<const float4*>(q_s + r[b] * hd + d);
    s[b] += qa.x * k.x;
    s[b] += qa.y * k.y;
    s[b] += qa.z * k.z;
    s[b] += qa.w * k.w;
  }
}

// The RB rows' dot products with the key row kr, over head elements in
// order: 4-element groups alternately into s0 and s1 (where K may be
// read 4 or 16 elements wide), else one element at a time into s0.
template <int RB, typename P>
__device__ __forceinline__ void dot_rows(float (&s0)[RB], float (&s1)[RB],
                                         const P* kr, const Chunk<P>& ch,
                                         const float* q_s,
                                         const int (&r)[RB]) {
  const int hd = ch.hd;
  if constexpr (kQuant<P>) {
    if (ch.vw == 16) {
      for (int d = 0; d < hd; d += 16) {
        const uint4 k = *reinterpret_cast<const uint4*>(kr + d);
        dot4<RB>(s0, q_s, r, hd, d, i8x4(k.x));
        dot4<RB>(s1, q_s, r, hd, d + 4, i8x4(k.y));
        dot4<RB>(s0, q_s, r, hd, d + 8, i8x4(k.z));
        dot4<RB>(s1, q_s, r, hd, d + 12, i8x4(k.w));
      }
      return;
    }
    if (ch.vw == 4) {
      for (int d = 0; d < hd; d += 8) {
        dot4<RB>(s0, q_s, r, hd, d,
                 i8x4(*reinterpret_cast<const uint32_t*>(kr + d)));
        if (d + 4 < hd)
          dot4<RB>(s1, q_s, r, hd, d + 4,
                   i8x4(*reinterpret_cast<const uint32_t*>(kr + d + 4)));
      }
      return;
    }
  } else if (ch.vw == 4) {
    for (int d = 0; d < hd; d += 8) {
      dot4<RB>(s0, q_s, r, hd, d, load4(kr + d));
      if (d + 4 < hd) dot4<RB>(s1, q_s, r, hd, d + 4, load4(kr + d + 4));
    }
    return;
  }
  for (int d = 0; d < hd; ++d) {
    const float kd = to_f(kr[d]);
#pragma unroll
    for (int b = 0; b < RB; ++b) s0[b] += q_s[r[b] * hd + d] * kd;
  }
}

// One warp scores RB of its rows (r0 + b kSWarps) against a staged
// chunk: lane j holds key c0 + j. The dot products run over head
// elements in order as two partial sums (even and odd 4-element groups,
// added at the end); softmax by butterflies; p v added over keys in
// position order into two accumulators (even and odd 4-key groups of the
// chunk, added at the end). An int8 chunk multiplies a key's summed
// product by its K scale and writes p times the key's V scale for p v.
// Every choice depends on key positions alone, and a row that sees none
// of the chunk's keys is left bit for bit as it was (its p are zeros),
// so a row's bits do not depend on which rows share its group, its tile
// or its step.
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
  dot_rows<RB>(s0, s1, ch.ks + lane * ch.ld, ch, q_s, r);
  // online softmax, the RB rows' butterflies side by side
  bool ok[RB];
  float s[RB], mx[RB], ps[RB], m_new[RB], corr[RB];
#pragma unroll
  for (int b = 0; b < RB; ++b) {
    ok[b] = lane < ch.nv && ch.c0 + lane <= qp[b];
    float dot = s0[b] + s1[b];
    if constexpr (kQuant<P>) dot *= ch.sc[lane];
    s[b] = ok[b] ? dot * scale : kNegInf;
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
    if constexpr (kQuant<P>)   // a stale scale past nv never reaches p v
      p_w[b * kCh + lane] = ok[b] ? ps[b] * ch.sc[kCh + lane] : 0.f;
    else
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

// A block's shared memory (smem_bytes): the ring, each warp's
// probabilities [kRB, kCh], the span's pool rows [kSpan] (int64; paged
// sources only), then q, acc [rows, hd], m, l and the row positions
// [rows]. All 16-byte aligned up to q: the ring's stages are a multiple
// of 16 bytes, p_s 2 KB, row_s 1 KB.
struct Layout {
  unsigned char* ring;
  float *p_s, *q_s, *acc_s, *m_s, *l_s;
  int64_t* row_s;
  int* qpos_s;
  __device__ Layout(unsigned char* smem, int stages, int rows, int hd,
                    int ld, int psize, bool quant) {
    ring = smem;
    p_s = reinterpret_cast<float*>(smem +
                                   stages * stage_bytes(ld, psize, quant));
    row_s = reinterpret_cast<int64_t*>(p_s + kSWarps * kRB * kCh);
    q_s = reinterpret_cast<float*>(row_s + kSpan);
    acc_s = q_s + rows * hd;
    m_s = acc_s + rows * hd;
    l_s = m_s + rows;
    qpos_s = reinterpret_cast<int*>(l_s + rows);
  }
};

// The work item's body, shared by the paged and the dense kernels: the
// block's `rows` query rows (n = rows / g consecutive query rows from
// q row row0, each with the g heads of kv head kvh; row r at position
// pos0 + r / g) against span positions [k_lo, k_hi) from src, each
// row's partial (m, l, acc) written to workspace slot (kvh, item, r).
// RBC caps the rows a warp scores together (a row's bits do not depend
// on its group). EARLY: the ring's first NS - 1 chunks are issued before
// q is read, so their loads overlap it (the dense kernel, whose source
// needs no preparing); else after q, acc, m and l are written,
// src.prepare has run and the block is synchronised (the paged kernels).
template <typename T, typename P, int NT, int NS, int RBC, bool EARLY,
          class Src>
__device__ __forceinline__ void span_body(
    const Layout& L, const Src& src, const T* __restrict__ q, int64_t q_sr,
    int64_t q_sh, int64_t row0, int rows, int g, int kvh, int pos0,
    int k_lo, int k_hi, const Partials& part, int item, int hd, float scale,
    int ld, int copy) {
  const int nch = k_hi > k_lo ? (k_hi - k_lo + kCh - 1) / kCh : 0;
  // K read 16 elements a lane (int8 rows copied 16 bytes at a time), 4
  // (4-element aligned rows) or 1
  const int vw = kQuant<P> && copy == kCopy16       ? 16
                 : hd % 4 == 0 && ld % 4 == 0 ? 4
                                                    : 1;
  const int stage = kCh * ld;   // elements of K (or V) a stage
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if constexpr (EARLY)
    prime<NS>(Stager<P, Src>(src, L.ring, ld, stage, hd, copy, k_lo, k_hi,
                             NS, tid),
              nch);
  for (int i = tid; i < rows * hd; i += kSThreads) {
    const int r = i / hd, d = i - r * hd;
    const int64_t row = row0 + r / g, head = kvh * g + r % g;
    L.q_s[i] = to_f(q[row * q_sr + head * q_sh + d]);
    L.acc_s[i] = 0.f;
  }
  src.prepare(tid);
  for (int r = tid; r < rows; r += kSThreads) {
    L.m_s[r] = kNegInf;
    L.l_s[r] = 0.f;
    L.qpos_s[r] = pos0 + r / g;
  }
  if constexpr (!EARLY) __syncthreads();
  // the loop's Stager is made here, not before q is read: its fields live
  // across the loads above otherwise, which cost the int8 span kernel
  // ~2.5% on an H100
  const Stager<P, Src> st(src, L.ring, ld, stage, hd, copy, k_lo, k_hi, NS,
                          tid);
  if constexpr (!EARLY) prime<NS>(st, nch);
  float* p_w = L.p_s + warp * kRB * kCh;
  // this warp's rows: warp + kSWarps i
  const int mine = rows > warp ? (rows - warp + kSWarps - 1) / kSWarps : 0;
  for (int c = 0; c < nch; ++c) {
    cp_wait<NS - 2>();
    // chunk c landed; chunk c - 1's stage is consumed (at c = 0 and
    // EARLY: q, acc, m, l and the positions are written)
    __syncthreads();
    if (c + NS - 1 < nch) st.issue(c + NS - 1);
    cp_commit();
    Chunk<P> ch;
    ch.ks = st.stage_at(c);
    ch.vs = ch.ks + stage;
    ch.sc = reinterpret_cast<const float*>(ch.vs + stage);
    ch.c0 = k_lo + c * kCh;
    ch.nv = min(kCh, k_hi - ch.c0);
    ch.ld = ld;
    ch.hd = hd;
    ch.vw = vw;
    // row groups of up to RBM rows (2 at the widest heads, for registers)
    constexpr int RBW = NT <= 4 ? kRB : 2;
    constexpr int RBM = RBW < RBC ? RBW : RBC;
    for (int i = 0; i < mine; i += RBM) {
      const int left = mine - i, r0 = warp + kSWarps * i;
      if constexpr (RBM >= 4) {
        if (left >= 4) {
          score_rows<4, NT>(ch, r0, L.q_s, L.acc_s, L.m_s, L.l_s, L.qpos_s,
                            p_w, scale, lane);
          continue;
        }
        if (left == 3) {
          score_rows<3, NT>(ch, r0, L.q_s, L.acc_s, L.m_s, L.l_s, L.qpos_s,
                            p_w, scale, lane);
          continue;
        }
      }
      if constexpr (RBM >= 2) {
        if (left >= 2) {
          score_rows<2, NT>(ch, r0, L.q_s, L.acc_s, L.m_s, L.l_s, L.qpos_s,
                            p_w, scale, lane);
          continue;
        }
      }
      score_rows<1, NT>(ch, r0, L.q_s, L.acc_s, L.m_s, L.l_s, L.qpos_s, p_w,
                        scale, lane);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // this span's partial state of every row
  for (int i = tid; i < rows * hd; i += kSThreads) {
    const int r = i / hd, d = i - r * hd;
    part.acc[part.slot(kvh, item, r) * hd + d] = L.acc_s[i];
  }
  for (int r = tid; r < rows; r += kSThreads) {
    const int64_t sl = part.slot(kvh, item, r);
    part.ml[2 * sl] = L.m_s[r];
    part.ml[2 * sl + 1] = L.l_s[r];
  }
}

// launch[2 b], launch[2 b + 1] = (slot, sequence, query offset, rows),
// (first packed row, span, 0, 0): block b's work item, heaviest first.
// grid (n_items, nkv), kSThreads threads. copy: kCopy16 / kCopy4 /
// kCopySync as the page rows' bytes and alignment allow. scales: an
// int8 pool's [num_blocks, 2, nkv, bs] float32 (null for float pools).
// (launch bounds: without a minimum of blocks an SM, ptxas traded spills
// for occupancy here)
template <typename T, typename P, int NT, int NS>
__global__ void __launch_bounds__(kSThreads, 2)
    span_kernel(const T* __restrict__ q, int64_t q_sr, int64_t q_sh,
                const P* __restrict__ pool,
                const float* __restrict__ scales,
                const int* __restrict__ bt, int mb,
                const int* __restrict__ q_lens,
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
  const int ld = row_ld(hd, sizeof(P), copy);
  const Layout L(smem_raw, NS, rows, hd, ld, sizeof(P), kQuant<P>);
  // pool rows of K at the span's positions; V's are nkv bs rows further
  const int64_t v_srow = (int64_t)nkv * bs;
  const PagedSrc<P> src{pool, scales, L.row_s, v_srow, v_srow * hd, hd,
                        bt + (int64_t)seq * mb, k_lo, k_hi - k_lo, kvh, nkv,
                        bs};
  span_body<T, P, NT, NS, kRB, false>(L, src, q, q_sr, q_sh, row0, rows, g,
                                      kvh, pos0, k_lo, k_hi, part, item, hd,
                                      scale, ld, copy);
}

// The span-order merge of one (row, query head), by one warp: lane's
// head elements d0 + 32 u (d0 = lane + the warp's part offset) of the
// partials in slots (kvh, first + k, r), k < n, into out_row. m = max
// m_s (exact in any order: the lanes take 32 spans' maxima at a time),
// then l = sum l_s e^(m_s - m) and acc likewise, added in span order; a
// row that saw no key (l == 0, or n == 0) gives zeros. acc is loaded KB
// spans a batch, so a row's spans cost n / KB round trips (the ragged
// kernels' rows hold a few spans; a long dense row up to S / kSpan). A
// row's bits depend on neither NT nor KB. n is warp-uniform.
template <typename T, int NT, int KB>
__device__ __forceinline__ void merge_spans(const Partials& part, int kvh,
                                            int first, int n, int r,
                                            int d0, int hd,
                                            T* __restrict__ out_row) {
  static_assert(KB >= 1 && KB <= 32, "a batch's weights sit in one warp");
  const int lane = threadIdx.x & 31;
  float m = kNegInf;
  for (int k0 = 0; k0 < n; k0 += 32)
    if (k0 + lane < n)
      m = fmaxf(m, part.ml[2 * part.slot(kvh, first + k0 + lane, r)]);
#pragma unroll
  for (int o = 16; o; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f, acc[NT];
#pragma unroll
  for (int u = 0; u < NT; ++u) acc[u] = 0.f;
  for (int k0 = 0; k0 < n; k0 += 32) {
    // lane j: span k0 + j's weight e^(m_s - m) and l_s
    float wj = 0.f, lj = 0.f;
    if (k0 + lane < n) {
      const int64_t sl = part.slot(kvh, first + k0 + lane, r);
      wj = expf(part.ml[2 * sl] - m);
      lj = part.ml[2 * sl + 1];
    }
    const int nk = min(32, n - k0);
    for (int j0 = 0; j0 < nk; j0 += KB) {
      float a[KB][NT];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const int64_t sl = part.slot(kvh, first + k0 + j0 + j, r);
#pragma unroll
        for (int u = 0; u < NT; ++u) {
          const int d = d0 + 32 * u;
          a[j][u] = j0 + j < nk && d < hd ? part.acc[sl * hd + d] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        const float w = __shfl_sync(0xffffffffu, wj, (j0 + j) & 31);
        const float ls = __shfl_sync(0xffffffffu, lj, (j0 + j) & 31);
        if (j0 + j < nk) {
          l += ls * w;
#pragma unroll
          for (int u = 0; u < NT; ++u) {
            const int d = d0 + 32 * u;
            if (d < hd) acc[u] += a[j][u] * w;
          }
        }
      }
    }
  }
  const float inv = l == 0.f ? 1.f : l;
#pragma unroll
  for (int u = 0; u < NT; ++u) {
    const int d = d0 + 32 * u;
    if (d < hd) out_row[d] = from_f<T>(acc[u] / inv);
  }
}

// One warp per (packed row, query head, part of NT x 32 head elements):
// merge_spans over the row's tile's items, 8 / NT spans a batch.
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
  merge_spans<T, NT, 8 / NT>(part, kvh, fs.x, fs.y, r, d0, hd,
                             out + ((int64_t)i * nh + h) * hd);
}

// tables: launch [n_items][8], tiles [n_tiles][4], tspan [n_tiles][2],
// row_tile [R], packed in that order. ws: float32 [nkv, n_items,
// max_rows, hd + 2].
template <typename T, typename P, int NT>
int launch(const void* q, long long q_sr, long long q_sh, const void* pool,
           const float* scales, const int* bt, int mb, const int* q_lens,
           const int* kv_lens, const int* tables, int n_tiles, int n_items,
           void* ws, void* out, int R, int nh, int nkv, int hd, int bs,
           int max_rows, float scale, cudaStream_t stream) {
  constexpr int NS = Stages<NT, P>::value;
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
                                   row_ld(hd, sizeof(P), copy), sizeof(P),
                                   kQuant<P>);
    cudaError_t e = ensure_smem(span_kernel<T, P, NT, NS>, smem, &configured);
    if (e != cudaSuccess) return (int)e;
    span_kernel<T, P, NT, NS><<<dim3(n_items, nkv), kSThreads, smem, stream>>>(
        static_cast<const T*>(q), q_sr, q_sh, static_cast<const P*>(pool),
        scales, bt, mb, q_lens, kv_lens, lt, part, nh, nkv, hd, bs, scale,
        copy);
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

// The libraries' entry point for pool element type P (float32 and bf16
// pools: q and pool of one dtype, scales null; int8 pools: float32 or
// bf16 q, scales required). dtype: kF32 or kBF16 (q and out).
template <typename P>
int entry(int dtype, const void* q, long long q_sr, long long q_sh,
          const void* pool, const float* scales, const int* bt, int mb,
          const int* q_lens, const int* kv_lens, const int* tables,
          int n_tiles, int n_items, void* ws, void* out, int R, int nh,
          int nkv, int hd, int bs, int max_rows, float scale,
          cudaStream_t stream) {
  if (hd < 1 || hd > kMaxHd || nkv < 1 || nh % nkv || max_rows < 1 ||
      max_rows > max_rows_hd<P>(hd) || kQuant<P> != (scales != nullptr))
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  auto run = [&](auto* tag) {   // T: the query / output type
    using T = std::remove_pointer_t<decltype(tag)>;
    with_tiles(hd, [&](auto nt) {
      err = launch<T, P, decltype(nt)::value>(
          q, q_sr, q_sh, pool, scales, bt, mb, q_lens, kv_lens, tables,
          n_tiles, n_items, ws, out, R, nh, nkv, hd, bs, max_rows, scale,
          stream);
    });
  };
  if constexpr (kQuant<P>) {
    if (dtype == kF32) run((float*)nullptr);
    if (dtype == kBF16) run((__nv_bfloat16*)nullptr);
  } else if (dtype == (std::is_same<P, float>::value ? kF32 : kBF16)) {
    run((P*)nullptr);
  }
  return err;
}

}  // namespace split
}  // namespace pt
