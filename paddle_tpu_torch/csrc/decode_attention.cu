// Dense-cache decode attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/decode_attention.py decode_attention
//   (pallas_call at :131, kernel _decode_kernel :42).
//
// What it computes: one query step per batch row over a dense KV cache
// with per-row valid lengths: row b's query heads attend to cache
// positions [0, seq_lens[b]) with an online fp32 softmax; a row of
// length 0 returns zeros. GQA: query head h reads kv head h / (nh / nkv).
//
// What bounds it on the H100: the K/V bytes of each row's valid prefix
// read from HBM (4 * hd flops per 8 * hd fp32 bytes per query head).
//
// What the design does about it: one block per (row, kv head) walks the
// cache up to seq_lens[b] only (never the padded max_len), stages
// kChunk positions of K and V in shared memory and scores all g query
// heads of the kv head against each staged chunk. The cache is read
// through its strides, so the serving model hands over the
// [2, B, H, max_len, D] layer cache as-is (a [B, S, H, D] strided view)
// instead of a transposed copy per layer per step.
//
// Not yet done (later PRs): split-KV across blocks for long rows (a
// decode batch of B rows fills only B * nkv blocks), tensor cores.
#include "attention_common.cuh"

namespace {

template <typename T>
struct DenseKV {
  const T* kp;  // this row and kv head: element (p, d) at p * ss + d
  const T* vp;
  int64_t k_ss, v_ss;
  __device__ __forceinline__ const T* kptr(int p) const {
    return kp + p * k_ss;
  }
  __device__ __forceinline__ const T* vptr(int p) const {
    return vp + p * v_ss;
  }
};

template <typename T, int NT>
__global__ void __launch_bounds__(pt::kThreads)
    decode_kernel(const T* __restrict__ q, int64_t q_sb, int64_t q_sh,
                  const T* __restrict__ kc, int64_t k_sb, int64_t k_ss,
                  int64_t k_sh, const T* __restrict__ vc, int64_t v_sb,
                  int64_t v_ss, int64_t v_sh,
                  const int* __restrict__ seq_lens, T* __restrict__ out,
                  int nh, int nkv, int hd, int S, float scale, int vec) {
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int g = nh / nkv;
  const int len = seq_lens[b];
  const int n_keys = max(0, min(len, S));
  DenseKV<T> kv{kc + b * k_sb + kvh * k_sh, vc + b * v_sb + kvh * v_sh,
                k_ss, v_ss};
  auto qrow = [&](int r, int d) {
    return pt::to_f(q[b * q_sb + (int64_t)(kvh * g + r) * q_sh + d]);
  };
  auto orow = [&](int r, int d, float x) {
    out[((int64_t)b * nh + kvh * g + r) * hd + d] = pt::from_f<T>(x);
  };
  // every valid position is <= len - 1; len <= 0 -> the row sees nothing
  auto qpos = [&](int) { return len - 1; };
  pt::attention_block<NT>(kv, n_keys, g, hd, scale, vec != 0, qrow, orow,
                          qpos);
}

template <typename T, int NT>
int launch(const void* q, long long q_sb, long long q_sh, const void* kc,
           long long k_sb, long long k_ss, long long k_sh, const void* vc,
           long long v_sb, long long v_ss, long long v_sh,
           const int* seq_lens, void* out, int B, int nh, int nkv, int hd,
           int S, float scale, int vec, cudaStream_t stream) {
  static size_t configured = 0;
  const size_t smem = pt::smem_bytes(nh / nkv, hd);
  cudaError_t e = pt::ensure_smem(decode_kernel<T, NT>, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B, nkv);
  decode_kernel<T, NT><<<grid, pt::kThreads, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_sh, static_cast<const T*>(kc), k_sb,
      k_ss, k_sh, static_cast<const T*>(vc), v_sb, v_ss, v_sh, seq_lens,
      static_cast<T*>(out), nh, nkv, hd, S, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, long long q_sb, long long q_sh, const void* kc,
              long long k_sb, long long k_ss, long long k_sh, const void* vc,
              long long v_sb, long long v_ss, long long v_sh,
              const int* seq_lens, void* out, int B, int nh, int nkv, int hd,
              int S, float scale, int vec, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  pt::with_tiles(hd, [&](auto nt) {
    err = launch<T, decltype(nt)::value>(q, q_sb, q_sh, kc, k_sb, k_ss, k_sh,
                                         vc, v_sb, v_ss, v_sh, seq_lens, out,
                                         B, nh, nkv, hd, S, scale, vec,
                                         stream);
  });
  return err;
}

}  // namespace

extern "C" int pt_decode_attention(int dtype, const void* q, long long q_sb,
                                   long long q_sh, const void* kc,
                                   long long k_sb, long long k_ss,
                                   long long k_sh, const void* vc,
                                   long long v_sb, long long v_ss,
                                   long long v_sh, const int* seq_lens,
                                   void* out, int B, int nh, int nkv, int hd,
                                   int S, float scale, int vec,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return launch_hd<float>(q, q_sb, q_sh, kc, k_sb, k_ss, k_sh, vc, v_sb,
                            v_ss, v_sh, seq_lens, out, B, nh, nkv, hd, S,
                            scale, vec, s);
  if (dtype == pt::kBF16)
    return launch_hd<__nv_bfloat16>(q, q_sb, q_sh, kc, k_sb, k_ss, k_sh, vc,
                                    v_sb, v_ss, v_sh, seq_lens, out, B, nh,
                                    nkv, hd, S, scale, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_decode_attention_max_rows(int hd) {
  return pt::max_block_rows(hd);
}
