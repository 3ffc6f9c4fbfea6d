// Ragged paged attention over int8 KV pages for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py
//   paged_attention_ragged with kv_scales= (pallas_call at :464, kernel
//   _kernel_ragged_prefetch_quant :231 over _ragged_body :156).
//
// What it computes: the ragged kernel of paged_attention.cu over a pool of
// int8 pages [num_blocks, 2, nkv, block_size, hd] with one float32 scale
// per (block, K|V, kv head, position) in [num_blocks, 2, nkv, block_size]:
// element d of position p is (float)pool[..., p, d] * scales[..., p], the
// same product the plain version forms. Queries and output are float32 or
// bf16.
//
// What bounds it on the H100: the K/V bytes read, now hd + 4 bytes per
// (position, kv head, K|V) instead of 4 * hd — 68 B at hd 64 against 256 B
// for float32 pages (0.27x), so a decode step over the same cache moves
// about a quarter of the bytes.
//
// What the design does about it: the stager of attention_common.cuh reads
// each position's payload as 4-byte vectors (a warp covers two whole 64-B
// rows at hd 64) and the position's scale beside them, keeps both in
// registers while the previous chunk is scored, and multiplies only when
// it stores the chunk to shared memory as float32 — pages are never
// dequantized into device memory. The online softmax and the tiling are
// those of the float kernel (paged_attention.cuh). Trash-table rows read
// block 0, whose scales are zero until something is written there, so
// they stay finite.
//
// Not yet done (later PRs): 16-byte payload loads, int8 -> bf16 tensor
// core products.
#include "paged_attention.cuh"

extern "C" int pt_paged_attention_ragged_int8(
    int dtype, const void* q, long long q_sr, long long q_sh,
    const void* pool, const float* scales, const int* bt, int mb,
    const int* q_lens, const int* kv_lens, const int* tiles, int n_tiles,
    void* out, int nh, int nkv, int hd, int bs, int max_rows, float scale,
    int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32)
    return pt::launch_ragged_hd<float, int8_t>(
        q, q_sr, q_sh, pool, scales, bt, mb, q_lens, kv_lens, tiles,
        n_tiles, out, nh, nkv, hd, bs, max_rows, scale, vec, s);
  if (dtype == pt::kBF16)
    return pt::launch_ragged_hd<__nv_bfloat16, int8_t>(
        q, q_sr, q_sh, pool, scales, bt, mb, q_lens, kv_lens, tiles,
        n_tiles, out, nh, nkv, hd, bs, max_rows, scale, vec, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int pt_paged_attention_int8_max_rows(int hd) {
  return pt::max_block_rows(hd);
}
