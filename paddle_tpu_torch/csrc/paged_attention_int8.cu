// Ragged paged attention over int8 KV pages for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py
//   paged_attention_ragged with kv_scales= (pallas_call at :464, kernel
//   _kernel_ragged_prefetch_quant :231 over _ragged_body :156).
//
// What it computes: the ragged kernel of paged_attention.cu over a pool of
// int8 pages [num_blocks, 2, nkv, block_size, hd] with one float32 scale
// per (block, K|V, kv head, position) in [num_blocks, 2, nkv, block_size]:
// element d of position p is (float)pool[..., p, d] * scales[..., p], as
// the plain version dequantizes it. Queries and output are float32 or
// bf16.
//
// What bounds it on the H100: the K/V bytes read, hd + 4 bytes per
// (position, kv head, K|V) instead of 4 hd: 68 B at hd 64 against 256 B
// for float32 pages (0.27x), so a decode step over the same cache moves
// about a quarter of the bytes, through the same arithmetic.
//
// What the design does about it: the float kernel's split-KV body
// (ragged_split.cuh) with the pool type as a template argument. Work
// items of 128 absolute key positions, one block each, merged in span
// order by the combine kernel; each position's int8 page rows go into
// a 4-stage ring by 16-byte cp.async (4-byte where hd % 16 != 0 or the
// pool is not 16-byte aligned, plain loads where hd % 4 != 0), and its K
// and V scales by 4-byte cp.async into the same stage, under the same
// wait. Pages are never dequantized into device memory: a lane converts
// a staged int8 element where it reads it (a byte permute into the
// mantissa of 2^23), multiplies a key's summed product q . k_int8 by the
// key's K scale, and folds the key's V scale into its probability before
// p v. The row's arithmetic depends on key positions alone, so its bits
// do not depend on the rest of its step or the tile width, as for the
// float kernel. Trash-table rows read block 0, whose scales are zero
// until something is written there, so they stay finite.
//
// Not yet done (later PRs): tensor cores for long prefill tiles.
#include "ragged_split.cuh"

// As pt_paged_attention_split of paged_attention.cu over an int8 pool;
// scales: [num_blocks, 2, nkv, bs] float32, required. dtype: q and out.
extern "C" int pt_paged_attention_split(
    int dtype, const void* q, long long q_sr, long long q_sh,
    const void* pool, const float* scales, const int* bt, int mb,
    const int* q_lens, const int* kv_lens, const int* tables, int n_tiles,
    int n_items, void* ws, void* out, int R, int nh, int nkv, int hd,
    int bs, int max_rows, float scale, void* stream) {
  return pt::split::entry<int8_t>(
      dtype, q, q_sr, q_sh, pool, scales, bt, mb, q_lens, kv_lens, tables,
      n_tiles, n_items, ws, out, R, nh, nkv, hd, bs, max_rows, scale,
      static_cast<cudaStream_t>(stream));
}

// The most query rows (tile rows x g) one block holds at head width hd.
extern "C" int pt_paged_attention_max_rows(int hd) {
  return pt::split::max_rows_hd<int8_t>(hd);
}

// Key positions per span (the host plan cuts its items by it).
extern "C" int pt_paged_attention_span() { return pt::split::kSpan; }
