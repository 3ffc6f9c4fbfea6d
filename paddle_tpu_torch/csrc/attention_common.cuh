// Shared online-softmax attention body for the Hopper attention kernels
// (paged_attention.cu, decode_attention.cu).
//
// One thread block scores a small set of query rows (one query tile of a
// sequence times the query heads of ONE kv head) against the keys at
// positions [0, n_keys) of that kv head. Keys are staged in shared memory
// kChunk positions at a time; each warp owns some of the rows and some of
// each chunk's keys and keeps their running max / denominator /
// accumulator, so the softmax is exact fp32 online softmax (the Pallas bodies' m/l/acc scratch,
// ops/pallas/paged_attention.py _ragged_body) and no score matrix ever
// reaches device memory.
//
// Memory: the next chunk's K/V are loaded into registers (16-byte vector
// loads, several in flight per thread) while the current chunk is being
// scored, then stored to shared memory — so the HBM latency of a chunk
// hides behind the previous chunk's arithmetic instead of serialising
// with it.
// Arithmetic: a warp scores up to kRowBlock of its rows at once, so each
// staged K/V element read from shared memory feeds kRowBlock rows.
//
// Query row r sits at absolute position qpos[r]; it sees key position p
// iff p <= qpos[r]. A row with qpos < 0 sees nothing and is written as
// zeros (the Pallas kernels' "l == 0 -> zeros" rule).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace pt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;     // key positions staged per shared-memory step
constexpr int kMaxHd = 256;    // head_dim bound (NT <= 8 lanes/thread)
constexpr int kMaxRows = 128;  // query rows one block holds at most
constexpr size_t kSmemLimit = 232448;  // sm_90 opt-in shared memory/block
constexpr int kRowBlock = 4;   // rows a warp scores together
constexpr int kPrefetch = 4;   // K and V float4 loads in flight per thread
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Warps split a block's work by rows and by keys: WR row groups x WK key
// groups (WR * WK == kWarps). A block with many rows gives every warp its
// own rows (WK = 1); a block with few rows — a decode row, a GQA group —
// gives every warp its own slice of each staged chunk's keys, keeps one
// partial softmax state per (row, key group) and merges them at the end.
__host__ __device__ inline int row_groups(int rows) {
  const int blocks = (rows + kRowBlock - 1) / kRowBlock;
  return blocks <= 1 ? 1 : blocks <= 2 ? 2 : blocks <= 4 ? 4 : kWarps;
}

// Shared memory for blocks of up to `rows` query rows of width hd, in
// bytes: q [rows, hd] and qpos [rows]; the partial softmax states, one
// per (row, key group) — at most 8 x rows below kRowBlock rows, else
// max(rows, kWarps * kRowBlock) — as acc [., hd], m, l; K and V chunks
// [kChunk, hd + 1] (the +1 pad keeps the per-lane key reads
// conflict-free).
__host__ __device__ inline size_t smem_bytes(int rows, int hd) {
  const size_t states = rows < kRowBlock
                            ? (size_t)rows * kWarps
                            : (size_t)(rows > kWarps * kRowBlock
                                           ? rows : kWarps * kRowBlock);
  return sizeof(float) * ((size_t)rows * hd + (size_t)rows +
                          states * (hd + 2) + 2 * (size_t)kChunk * (hd + 1));
}

// The most query rows (<= kMaxRows) one block can hold at head width hd
// within the card's shared memory; 0 when hd is outside (0, kMaxHd].
// The wrappers size their query tiles by it (each library exports it).
__host__ inline int max_block_rows(int hd) {
  if (hd < 1 || hd > kMaxHd) return 0;
  int rows = kMaxRows;
  while (rows > 0 && smem_bytes(rows, hd) > kSmemLimit) --rows;
  return rows;
}

// A K/V source the Stager reads (which: 0 = K, 1 = V; p: position < the
// block's n_keys; d: element of the head_dim vector):
//   Raw               what a prefetch holds in registers for 4 elements
//   raw4(which, p, d) issue the loads of elements d .. d + 3
//   cvt(raw)          those 4 elements as floats, once the loads landed
//   load1(which, p, d) one element as a float (unaligned heads)
// RowsKV serves float32/bf16 rows: `at(which, p)` points at position p's
// head_dim vector. Quantized sources (paged_attention.cuh PagedKVQ) keep
// the int8 payload and its scale in Raw and dequantize in cvt.
template <typename T, class Addr>
struct RowsKV {
  Addr at;
  using Raw = float4;
  __device__ __forceinline__ float4 raw4(int which, int p, int d) const {
    return load4(at(which, p) + d);
  }
  __device__ __forceinline__ static float4 cvt(const float4& r) { return r; }
  __device__ __forceinline__ float load1(int which, int p, int d) const {
    return to_f(at(which, p)[d]);
  }
};

// Stages the K/V of positions [c0, c0 + nk) into shared memory. With
// `vec` (head_dim % 4 == 0 and 4-element-aligned rows) the loads are
// 4-element vectors: the first kPrefetch per thread come from `kr`/`vr`,
// issued by prefetch() and converted only here, after the previous
// chunk's arithmetic; the rest (wide heads) are loaded here in batches.
template <class KV>
struct Stager {
  using Raw = typename KV::Raw;
  const KV& kv;
  int hd, ld, n4;
  bool vec;
  Raw kr[kPrefetch], vr[kPrefetch];

  __device__ Stager(const KV& kv_, int hd_, bool vec_)
      : kv(kv_), hd(hd_), ld(hd_ + 1), n4(hd_ >> 2), vec(vec_) {}

  __device__ __forceinline__ void prefetch(int c0, int nk) {
    if (!vec) return;
    const int total = nk * n4;
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int i = threadIdx.x + u * kThreads;
      if (i < total) {
        const int p = i / n4, d = (i - p * n4) << 2;
        kr[u] = kv.raw4(0, c0 + p, d);
        vr[u] = kv.raw4(1, c0 + p, d);
      }
    }
  }

  __device__ __forceinline__ void put(float* k_s, float* v_s, int i,
                                      const float4& a, const float4& b) {
    const int p = i / n4, d = (i - p * n4) << 2;
    float* ks = k_s + p * ld + d;
    float* vs = v_s + p * ld + d;
    ks[0] = a.x; ks[1] = a.y; ks[2] = a.z; ks[3] = a.w;
    vs[0] = b.x; vs[1] = b.y; vs[2] = b.z; vs[3] = b.w;
  }

  __device__ __forceinline__ void store(int c0, int nk, float* k_s,
                                        float* v_s) {
    if (vec) {
      const int total = nk * n4;
#pragma unroll
      for (int u = 0; u < kPrefetch; ++u) {
        const int i = threadIdx.x + u * kThreads;
        if (i < total) put(k_s, v_s, i, KV::cvt(kr[u]), KV::cvt(vr[u]));
      }
      for (int base = threadIdx.x + kPrefetch * kThreads; base < total;
           base += kPrefetch * kThreads) {
        Raw a[kPrefetch], b[kPrefetch];
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          const int i = base + u * kThreads;
          if (i < total) {
            const int p = i / n4, d = (i - p * n4) << 2;
            a[u] = kv.raw4(0, c0 + p, d);
            b[u] = kv.raw4(1, c0 + p, d);
          }
        }
#pragma unroll
        for (int u = 0; u < kPrefetch; ++u) {
          const int i = base + u * kThreads;
          if (i < total) put(k_s, v_s, i, KV::cvt(a[u]), KV::cvt(b[u]));
        }
      }
      return;
    }
    for (int i = threadIdx.x; i < nk * hd; i += kThreads) {
      const int p = i / hd, d = i - p * hd;
      k_s[p * ld + d] = kv.load1(0, c0 + p, d);
      v_s[p * ld + d] = kv.load1(1, c0 + p, d);
    }
  }
};

// kv: a K/V source (RowsKV above) over positions [0, n_keys), each
// head_dim vector contiguous in d. qrow(r, d): query element of row r.
// orow(r, d, x): store. qpos_src(r): absolute position of row r.
// NT = ceil(hd / 32): the accumulator lanes each thread holds per row.
template <int NT, class KV, class QRow, class ORow, class QPos>
__device__ __forceinline__ void attention_block(const KV& kv, int n_keys,
                                                int rows, int hd,
                                                float scale, bool vec,
                                                const QRow& qrow,
                                                const ORow& orow,
                                                const QPos& qpos_src) {
  extern __shared__ float smem[];
  const int WR = row_groups(rows), WK = kWarps / WR;
  const int states = rows * WK;
  const int ld = hd + 1;
  float* q_s = smem;
  int* qpos = reinterpret_cast<int*>(q_s + rows * hd);
  float* acc_s = reinterpret_cast<float*>(qpos + rows);  // [WK][rows][hd]
  float* m_s = acc_s + states * hd;                      // [WK][rows]
  float* l_s = m_s + states;
  float* k_s = l_s + states;
  float* v_s = k_s + kChunk * ld;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wr = warp % WR, wk = warp / WR;
  const int klen = kChunk / WK;        // keys of each chunk this warp owns
  const int kbase = wk * klen;
  float* acc_w = acc_s + wk * rows * hd;
  float* m_w = m_s + wk * rows;
  float* l_w = l_s + wk * rows;
  Stager<KV> st(kv, hd, vec);
  if (n_keys > 0) st.prefetch(0, min(kChunk, n_keys));

  for (int i = tid; i < rows * hd; i += blockDim.x)
    q_s[i] = qrow(i / hd, i % hd);
  for (int i = tid; i < states * hd; i += blockDim.x) acc_s[i] = 0.f;
  for (int i = tid; i < states; i += blockDim.x) {
    m_s[i] = kNegInf;
    l_s[i] = 0.f;
  }
  for (int r = tid; r < rows; r += blockDim.x) qpos[r] = qpos_src(r);

  for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
    const int nk = min(kChunk, n_keys - c0);
    __syncthreads();                 // the previous chunk is consumed
    st.store(c0, nk, k_s, v_s);
    __syncthreads();
    if (c0 + kChunk < n_keys)        // next chunk's loads fly meanwhile
      st.prefetch(c0 + kChunk, min(kChunk, n_keys - c0 - kChunk));
    const int kend = min(klen, nk - kbase);  // this warp's keys: [0, kend)
    if (kend <= 0) continue;
    // this warp's rows: rb + b * WR for b < kRowBlock
    for (int rb = wr; rb < rows; rb += WR * kRowBlock) {
      int qp[kRowBlock];
      bool live[kRowBlock];
      bool any = false;
#pragma unroll
      for (int b = 0; b < kRowBlock; ++b) {
        const int r = rb + b * WR;
        qp[b] = r < rows ? qpos[r] : -1;
        live[b] = qp[b] >= c0 + kbase;   // sees this warp's first key
        any |= live[b];
      }
      if (!any) continue;            // warp-uniform
      // scores: a warp owning klen >= 32 keys gives each lane klen / 32
      // keys; one owning fewer splits each key's dot product over
      // G = 32 / klen lanes (lane -> key lane % klen, d-slice
      // lane / klen) and sums the slices with log2(G) shuffles
      const int G = klen >= 32 ? 1 : 32 / klen;
      const int kl = lane % (32 / G);          // this lane's key (j = 0)
      const int dlen = (hd + G - 1) / G;
      const int d0 = (lane / (32 / G)) * dlen;
      const int d1 = min(hd, d0 + dlen);
      float s[kRowBlock][kChunk / 32];
#pragma unroll
      for (int b = 0; b < kRowBlock; ++b)
#pragma unroll
        for (int j = 0; j < kChunk / 32; ++j) s[b][j] = 0.f;
#pragma unroll 8
      for (int d = d0; d < d1; ++d) {
        float kd[kChunk / 32];
#pragma unroll
        for (int j = 0; j < kChunk / 32; ++j) {
          const int p = kl + 32 * j;
          kd[j] = p < kend ? k_s[(kbase + p) * ld + d] : 0.f;
        }
#pragma unroll
        for (int b = 0; b < kRowBlock; ++b) {
          if (!live[b]) continue;
          const float qd = q_s[(rb + b * WR) * hd + d];
#pragma unroll
          for (int j = 0; j < kChunk / 32; ++j) s[b][j] += qd * kd[j];
        }
      }
      for (int o = 32 / G; o < 32; o <<= 1)
#pragma unroll
        for (int b = 0; b < kRowBlock; ++b)
#pragma unroll
          for (int j = 0; j < kChunk / 32; ++j)
            s[b][j] += __shfl_xor_sync(0xffffffffu, s[b][j], o);
      // every lane of a key now holds its full score; lanes of the
      // first d-slice (lane < 32 / G) carry it into the softmax sums
      const bool lead = lane < 32 / G;
      float corr[kRowBlock];
#pragma unroll
      for (int b = 0; b < kRowBlock; ++b) {
        if (!live[b]) {
          corr[b] = 1.f;
          continue;
        }
        const int r = rb + b * WR;
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < kChunk / 32; ++j) {
          const int p = kl + 32 * j;
          const bool ok = p < kend && c0 + kbase + p <= qp[b];
          s[b][j] = ok ? s[b][j] * scale : kNegInf;
          mx = fmaxf(mx, s[b][j]);
        }
        mx = warp_max(mx);
        const float m_old = m_w[r];
        const float m_new = fmaxf(m_old, mx);
        corr[b] = expf(m_old - m_new);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < kChunk / 32; ++j) {
          const int p = kl + 32 * j;
          // masked keys contribute nothing
          const bool ok = p < kend && c0 + kbase + p <= qp[b];
          s[b][j] = ok ? expf(s[b][j] - m_new) : 0.f;
          if (lead) psum += s[b][j];
        }
        psum = warp_sum(psum);
        __syncwarp();
        if (lane == 0) {
          m_w[r] = m_new;
          l_w[r] = l_w[r] * corr[b] + psum;
        }
      }
      float a[kRowBlock][NT];
#pragma unroll
      for (int b = 0; b < kRowBlock; ++b) {
        const int r = rb + b * WR;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int d = lane + 32 * t;
          a[b][t] = (live[b] && d < hd) ? acc_w[r * hd + d] * corr[b] : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk / 32; ++j) {
        // key 32 j + src's probability sits in lane src (first d-slice)
        const int n_src = min(32, kend - 32 * j);
#pragma unroll 8
        for (int src = 0; src < n_src; ++src) {
          const float* vr = v_s + (kbase + 32 * j + src) * ld;
          float vd[NT];
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            const int d = lane + 32 * t;
            vd[t] = d < hd ? vr[d] : 0.f;
          }
#pragma unroll
          for (int b = 0; b < kRowBlock; ++b) {
            if (!live[b]) continue;  // warp-uniform
            const float pp = __shfl_sync(0xffffffffu, s[b][j], src);
#pragma unroll
            for (int t = 0; t < NT; ++t) a[b][t] += pp * vd[t];
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kRowBlock; ++b) {
        const int r = rb + b * WR;
        if (!live[b]) continue;
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int d = lane + 32 * t;
          if (d < hd) acc_w[r * hd + d] = a[b][t];
        }
      }
    }
  }
  __syncthreads();

  // merge the key groups' partial states: m = max m_k, l = sum l_k e^(m_k
  // - m), acc likewise; a row that saw no key has l == 0 and gives zeros
  for (int i = tid; i < rows * hd; i += blockDim.x) {
    const int r = i / hd;
    float m = kNegInf;
    for (int k = 0; k < WK; ++k) m = fmaxf(m, m_s[k * rows + r]);
    float l = 0.f, acc = 0.f;
    for (int k = 0; k < WK; ++k) {
      const float w = expf(m_s[k * rows + r] - m);
      l += l_s[k * rows + r] * w;
      acc += acc_s[k * rows * hd + i] * w;
    }
    orow(r, i % hd, acc / (l == 0.f ? 1.f : l));
  }
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
