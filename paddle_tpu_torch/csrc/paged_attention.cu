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
// The kernel template lives in paged_attention.cuh; this source builds
// it over float32 and bf16 pools, paged_attention_int8.cu over int8 pools.
//
// Not yet done (later PRs): tensor cores (wgmma) and TMA staging,
// split-KV across blocks for long decode contexts.
#include "paged_attention.cuh"

extern "C" int pt_paged_attention_ragged(
    int dtype, const void* q, long long q_sr, long long q_sh,
    const void* pool, const int* bt, int mb, const int* q_lens,
    const int* kv_lens, const int* tiles, int n_tiles, void* out, int nh,
    int nkv, int hd, int bs, int max_rows, float scale, int vec,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return pt::launch_ragged_hd<float, float>(
        q, q_sr, q_sh, pool, nullptr, bt, mb, q_lens, kv_lens, tiles,
        n_tiles, out, nh, nkv, hd, bs, max_rows, scale, vec, s);
  if (dtype == pt::kBF16)
    return pt::launch_ragged_hd<__nv_bfloat16, __nv_bfloat16>(
        q, q_sr, q_sh, pool, nullptr, bt, mb, q_lens, kv_lens, tiles,
        n_tiles, out, nh, nkv, hd, bs, max_rows, scale, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_paged_attention_max_rows(int hd) {
  return pt::max_block_rows(hd);
}
