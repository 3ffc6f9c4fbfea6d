// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py decode_attention
//   (pallas_call at :131, kernel _decode_kernel :42).
//
// What it computes: one query step per batch row over a dense KV cache
// with per-row valid lengths: row b's query heads attend to cache
// positions [0, min(seq_lens[b], S)) with an online fp32 softmax; a row
// of length 0 returns zeros. GQA: query head h reads kv head h / (nh /
// nkv).
//
// What bounds it on the H100: the K/V bytes of each row's valid prefix
// read from HBM (4 hd flops per 8 hd fp32 bytes per query head). What
// held the first design back was the critical path, not the bytes: one
// block per (row, kv head) walked the row's keys serially, so a decode
// batch of B rows filled B nkv blocks of the 132 SMs.
//
// What the design does about it: the split-KV body of the ragged paged
// kernels (ragged_split.cuh) over a dense source. A decode row is the
// ragged kernel's decode tile: one query row at position len - 1 with
// the g query heads of a kv head.
// * work items (row, span of 128 absolute positions) x kv head, a grid
//   sized from S (the lengths stay on the card); a block whose span
//   starts at or past its row's length exits at once;
// * each span streams 32-position chunks of K and V through the body's
//   ring, each position's head_dim vectors read through the cache's
//   strides (DenseSrc; the serving model hands over its [2, B, H,
//   max_len, D] layer cache as [B, S, H, D] strided views), 16 bytes a
//   cp.async where rows allow it (TMA copies, a row or a chunk each,
//   measured slower);
// * a second kernel merges a row's spans in span order with the ragged
//   kernels' merge (merge_spans), the span count read from the row's
//   length on the card. No atomics: the bits repeat.
// A row's arithmetic is that of the ragged kernel's decode row over a
// pool holding the same K/V, so the two kernels' outputs are bitwise
// equal (where both copy rows alike: 16-byte aligned rows and strides).
#include "ragged_split.cuh"

namespace {

using namespace pt::split;

// K and V of one (row, kv head) from its span's first position: span
// position p at k + p k_ss and v + p v_ss (elements; head_dim
// contiguous). K and V are two tensors with strides of their own.
template <typename P>
struct DenseSrc {
  const P* k;
  const P* v;
  int64_t k_ss, v_ss;
  __device__ __forceinline__ void prepare(int) const {}
  __device__ __forceinline__ const P* krow(int p) const {
    return k + p * k_ss;
  }
  __device__ __forceinline__ const P* vrow(const P*, int p, int u) const {
    return v + p * v_ss + u;
  }
};

// grid (ceil(S / kSpan), nkv, B), kSThreads threads: block (s, kvh, b)
// scores row b's g query heads of kv head kvh (one decode row at
// position len - 1) against positions [s kSpan, (s + 1) kSpan) below
// min(len, S), as the ragged kernel's decode tile does, into workspace
// slot (kvh, b nsp + s, r). copy: kCopy16 / kCopy4 / kCopySync as the
// rows' bytes, bases and strides allow. A warp scores its rows one at a
// time (the body's one-row path alone, in fewer registers: at g <=
// kSWarps a warp holds at most one row).
template <typename T, int NT, int NS>
__global__ void __launch_bounds__(kSThreads, 2)
    decode_span_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_sh,
                       const T* __restrict__ kc, int64_t k_sb, int64_t k_ss,
                       int64_t k_sh, const T* __restrict__ vc, int64_t v_sb,
                       int64_t v_ss, int64_t v_sh,
                       const int* __restrict__ seq_lens, Partials part,
                       int nh, int nkv, int hd, int S, float scale,
                       int copy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int len = seq_lens[b];
  const int k_lo = sp * kSpan;
  const int k_hi = min(k_lo + kSpan, max(0, min(len, S)));
  if (k_hi <= k_lo) return;   // the span holds none of the row's keys
  const int g = nh / nkv;
  const int ld = row_ld(hd, sizeof(T), copy);
  const Layout L(smem_raw, NS, g, hd, ld, sizeof(T), false);
  const DenseSrc<T> src{kc + b * k_sb + kvh * k_sh + k_lo * k_ss,
                        vc + b * v_sb + kvh * v_sh + k_lo * v_ss, k_ss,
                        v_ss};
  span_body<T, T, NT, NS, 1, true>(L, src, q, q_sb, q_sh, b, g, g, kvh,
                                   len - 1, k_lo, k_hi, part,
                                   b * (int)gridDim.x + sp, hd, scale, ld,
                                   copy);
}

// One warp per (row, query head, 32 head elements): the ragged kernels'
// span-order merge over the row's spans, as many as its length on the
// card covers (none for a length <= 0: zeros), 32 spans a batch (a long
// row's 64 spans in two round trips).
template <typename T>
__global__ void __launch_bounds__(kSThreads)
    decode_combine_kernel(Partials part, const int* __restrict__ seq_lens,
                          T* __restrict__ out, int B, int nh, int nkv,
                          int hd, int S, int nsp, int parts) {
  const int lane = threadIdx.x & 31;
  const int64_t wid =
      (int64_t)blockIdx.x * kSWarps + (threadIdx.x >> 5);
  if (wid >= (int64_t)B * nh * parts) return;
  const int ih = (int)(wid / parts);
  const int d0 = (int)(wid - (int64_t)ih * parts) * 32 + lane;
  const int b = ih / nh, h = ih % nh;
  const int g = nh / nkv;
  const int n_keys = max(0, min(seq_lens[b], S));
  merge_spans<T, 1, 32>(part, h / g, b * nsp, (n_keys + kSpan - 1) / kSpan,
                        h % g, d0, hd, out + ((int64_t)b * nh + h) * hd);
}

// ws: float32 [nkv, B nsp, g, hd + 2] (acc, then m and l).
template <typename T, int NT>
int launch(const T* q, long long q_sb, long long q_sh, const T* kc,
           long long k_sb, long long k_ss, long long k_sh, const T* vc,
           long long v_sb, long long v_ss, long long v_sh,
           const int* seq_lens, float* ws, T* out, int B, int nh, int nkv,
           int hd, int S, float scale, cudaStream_t stream) {
  constexpr int NS = Stages<NT, T>::value;
  const int g = nh / nkv, nsp = (S + kSpan - 1) / kSpan;
  const int n_items = B * nsp;
  Partials part{ws, ws + (size_t)nkv * n_items * g * hd, n_items, g, hd};
  if (nsp > 0) {
    // 16- or 4-byte copies where every row start is so aligned
    const long long strides[] = {k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, hd};
    auto aligned = [&](unsigned a) {
      if (reinterpret_cast<uintptr_t>(kc) % a ||
          reinterpret_cast<uintptr_t>(vc) % a)
        return false;
      for (long long st : strides)
        if ((st * (long long)sizeof(T)) % a) return false;
      return true;
    };
    const int copy = aligned(16) ? kCopy16 : aligned(4) ? kCopy4 : kCopySync;
    const size_t smem = smem_bytes(NS, g, hd, row_ld(hd, sizeof(T), copy),
                                   sizeof(T), false);
    static size_t configured = 0;
    cudaError_t e =
        pt::ensure_smem(decode_span_kernel<T, NT, NS>, smem, &configured);
    if (e != cudaSuccess) return (int)e;
    decode_span_kernel<T, NT, NS><<<dim3(nsp, nkv, B), kSThreads, smem,
                                    stream>>>(
        q, q_sb, q_sh, kc, k_sb, k_ss, k_sh, vc, v_sb, v_ss, v_sh, seq_lens,
        part, nh, nkv, hd, S, scale, copy);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  // a warp merges 32 head elements of a (row, head)
  const int parts = (hd + 31) / 32;
  const int64_t warps = (int64_t)B * nh * parts;
  decode_combine_kernel<T>
      <<<(unsigned)((warps + kSWarps - 1) / kSWarps), kSThreads, 0,
         stream>>>(part, seq_lens, out, B, nh, nkv, hd, S, nsp, parts);
  return (int)cudaGetLastError();
}

template <typename T>
int entry(const void* q, long long q_sb, long long q_sh, const void* kc,
          long long k_sb, long long k_ss, long long k_sh, const void* vc,
          long long v_sb, long long v_ss, long long v_sh,
          const int* seq_lens, void* ws, void* out, int B, int nh, int nkv,
          int hd, int S, float scale, cudaStream_t stream) {
  if (hd < 1 || hd > pt::kMaxHd || nkv < 1 || nkv > 65535 || nh % nkv ||
      nh / nkv > max_rows_hd<T>(hd) || B < 1 || B > 65535 || S < 0)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  pt::with_tiles(hd, [&](auto nt) {
    err = launch<T, decltype(nt)::value>(
        static_cast<const T*>(q), q_sb, q_sh, static_cast<const T*>(kc),
        k_sb, k_ss, k_sh, static_cast<const T*>(vc), v_sb, v_ss, v_sh,
        seq_lens, static_cast<float*>(ws), static_cast<T*>(out), B, nh, nkv,
        hd, S, scale, stream);
  });
  return err;
}

}  // namespace

// dtype: pt::kF32 or pt::kBF16 (q, caches and out alike). q [B, nh, hd]
// and the caches [B, S, nkv, hd] by their strides (elements; head_dim
// contiguous); out [B, nh, hd] contiguous; ws float32 of
// nkv B ceil(S / span) (nh / nkv) (hd + 2) elements.
extern "C" int pt_decode_attention(int dtype, const void* q, long long q_sb,
                                   long long q_sh, const void* kc,
                                   long long k_sb, long long k_ss,
                                   long long k_sh, const void* vc,
                                   long long v_sb, long long v_ss,
                                   long long v_sh, const int* seq_lens,
                                   void* ws, void* out, int B, int nh,
                                   int nkv, int hd, int S, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return entry<float>(q, q_sb, q_sh, kc, k_sb, k_ss, k_sh, vc, v_sb, v_ss,
                        v_sh, seq_lens, ws, out, B, nh, nkv, hd, S, scale,
                        s);
  if (dtype == pt::kBF16)
    return entry<__nv_bfloat16>(q, q_sb, q_sh, kc, k_sb, k_ss, k_sh, vc,
                                v_sb, v_ss, v_sh, seq_lens, ws, out, B, nh,
                                nkv, hd, S, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The most query heads a kv head may have (g) at head width hd: the
// rows one block of the body holds (sized for float32 rows, so it holds
// for bf16 ones too).
extern "C" int pt_decode_attention_max_rows(int hd) {
  return max_rows_hd<float>(hd);
}

// Key positions per span (the wrapper sizes the workspace by it).
extern "C" int pt_decode_attention_span() { return kSpan; }
