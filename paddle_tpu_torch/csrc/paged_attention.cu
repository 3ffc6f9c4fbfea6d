// Ragged paged attention for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py
//   paged_attention_ragged (pallas_call at :464, kernel
//   _kernel_ragged_prefetch :217 over _ragged_body :156).
//
// What it computes: causal attention for a PACKED mixed batch of
// prefill chunks, decode rows and verify rows through per-sequence block
// tables. Query i of sequence s sits at position kv_lens[s] - q_lens[s] + i
// and attends to every position <= its own in s's pages; K/V live in the
// pool [num_blocks, 2, nkv, block_size, hd]. GQA: query head h reads kv
// head h / (nh / nkv).
//
// What bounds it on the H100: at decode it is the K/V bytes read from
// HBM (one query row per sequence does 4 * hd flops per 8 * hd bytes of
// fp32 K/V, far below the card's ~20 flop/byte fp32 balance point); a
// long prefill tile of 64 rows moves it towards the fp32 CUDA-core rate.
//
// What the design does about it: one block per (query tile, kv head)
// loads each visited K/V page ONCE into shared memory and scores every
// query row of the tile (all g query heads of the kv head, all tile
// rows) against it, so a page crosses HBM once per tile instead of once
// per row; pages past the tile's causal frontier (its last REAL query
// position) are never read. The next 64 positions' K/V are loaded into
// registers while the current ones are scored (attention_common.cuh), so
// HBM latency overlaps the arithmetic. There is no scalar prefetch on
// Hopper: the
// block reads its own tile descriptor and block-table row from device
// memory. The descriptors are built on the host once per step and shared
// by every layer (ops/hopper/paged_attention.py RaggedPlan).
//
// Not yet done (later PRs): tensor cores (wgmma) and TMA staging,
// split-KV across blocks for long decode contexts.
#include "attention_common.cuh"

namespace {

template <typename T>
struct PagedKV {
  const T* pool;
  const int* bt_row;  // this sequence's block-table row
  int nkv, kvh, bs, hd;
  __device__ __forceinline__ const T* row(int kv, int p) const {
    const int64_t blk = bt_row[p / bs];
    return pool + (((blk * 2 + kv) * nkv + kvh) * bs + (p % bs)) *
                      (int64_t)hd;
  }
  __device__ __forceinline__ const T* kptr(int p) const { return row(0, p); }
  __device__ __forceinline__ const T* vptr(int p) const { return row(1, p); }
};

// tiles[t] = (sequence, query offset within it, real rows, first packed row)
template <typename T, int NT>
__global__ void __launch_bounds__(pt::kThreads)
    ragged_kernel(const T* __restrict__ q, int64_t q_sr, int64_t q_sh,
                  const T* __restrict__ pool, const int* __restrict__ bt,
                  int mb, const int* __restrict__ q_lens,
                  const int* __restrict__ kv_lens,
                  const int4* __restrict__ tiles, T* __restrict__ out,
                  int nh, int nkv, int hd, int bs, float scale, int vec) {
  const int4 td = tiles[blockIdx.x];
  const int seq = td.x, off = td.y, n = td.z, row0 = td.w;
  const int kvh = blockIdx.y;
  const int g = nh / nkv;
  const int pos0 = kv_lens[seq] - q_lens[seq] + off;
  // causal frontier: the tile's LAST REAL query position
  const int n_keys = max(0, min(pos0 + n, mb * bs));
  PagedKV<T> kv{pool, bt + (int64_t)seq * mb, nkv, kvh, bs, hd};
  auto qrow = [&](int r, int d) {
    const int64_t row = row0 + r / g, head = kvh * g + r % g;
    return pt::to_f(q[row * q_sr + head * q_sh + d]);
  };
  auto orow = [&](int r, int d, float x) {
    const int64_t row = row0 + r / g, head = kvh * g + r % g;
    out[(row * nh + head) * hd + d] = pt::from_f<T>(x);
  };
  auto qpos = [&](int r) { return pos0 + r / g; };
  pt::attention_block<NT>(kv, n_keys, n * g, hd, scale, vec != 0, qrow,
                          orow, qpos);
}

template <typename T, int NT>
int launch(const void* q, long long q_sr, long long q_sh, const void* pool,
           const int* bt, int mb, const int* q_lens, const int* kv_lens,
           const int* tiles, int n_tiles, void* out, int nh, int nkv, int hd,
           int bs, int max_rows, float scale, int vec, cudaStream_t stream) {
  static size_t configured = 0;
  const size_t smem = pt::smem_bytes(max_rows, hd);
  cudaError_t e = pt::ensure_smem(ragged_kernel<T, NT>, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_tiles, nkv);
  ragged_kernel<T, NT><<<grid, pt::kThreads, smem, stream>>>(
      static_cast<const T*>(q), q_sr, q_sh, static_cast<const T*>(pool), bt,
      mb, q_lens, kv_lens, reinterpret_cast<const int4*>(tiles),
      static_cast<T*>(out), nh, nkv, hd, bs, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, long long q_sr, long long q_sh,
              const void* pool, const int* bt, int mb, const int* q_lens,
              const int* kv_lens, const int* tiles, int n_tiles, void* out,
              int nh, int nkv, int hd, int bs, int max_rows, float scale,
              int vec, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  pt::with_tiles(hd, [&](auto nt) {
    err = launch<T, decltype(nt)::value>(q, q_sr, q_sh, pool, bt, mb, q_lens,
                                         kv_lens, tiles, n_tiles, out, nh,
                                         nkv, hd, bs, max_rows, scale, vec,
                                         stream);
  });
  return err;
}

}  // namespace

extern "C" int pt_paged_attention_ragged(
    int dtype, const void* q, long long q_sr, long long q_sh,
    const void* pool, const int* bt, int mb, const int* q_lens,
    const int* kv_lens, const int* tiles, int n_tiles, void* out, int nh,
    int nkv, int hd, int bs, int max_rows, float scale, int vec,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return launch_hd<float>(q, q_sr, q_sh, pool, bt, mb, q_lens, kv_lens,
                            tiles, n_tiles, out, nh, nkv, hd, bs, max_rows,
                            scale, vec, s);
  if (dtype == pt::kBF16)
    return launch_hd<__nv_bfloat16>(q, q_sr, q_sh, pool, bt, mb, q_lens,
                                    kv_lens, tiles, n_tiles, out, nh, nkv,
                                    hd, bs, max_rows, scale, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_paged_attention_max_rows(int hd) {
  return pt::max_block_rows(hd);
}
