// Ragged paged attention over float32 / bf16 pages for Hopper (sm_90a).
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
// What bounds it on the H100: the K/V bytes read from HBM (one query row
// does 4 hd flops per 8 hd bytes of fp32 K/V; a serving step's mixed
// batch is ~0.17 GFLOP for ~38 MB). What held the first design back was
// not the bytes but the critical path: one block per (query tile, kv
// head) walked all of its sequence's keys serially, so a ~1000-key
// decode row was one block that streamed 16 chunks alone.
//
// What the design does about it (ragged_split.cuh):
// * split-KV: each (tile, kv head) splits its visible keys into spans of
//   128 absolute positions, one block each; combine_kernel merges a row's
//   partial (m, l, acc) in span order. No atomics: the bits repeat, and a
//   row's bits do not depend on the rest of the step.
// * asynchronous page staging: a span streams through a 3-stage ring of
//   32-position K/V chunks copied by cp.async (16-byte copies of each
//   position's page row), 2 chunks (32 KB at hd 64) in flight a block,
//   3 blocks an SM.
// * arithmetic: a warp scores up to 4 of its rows against each staged
//   chunk (lane j holds key j), with no per-row branch in the products,
//   split dot products and accumulators for more independent work.
// * balance: the host plan (RaggedPlan.split_tables) lists the items
//   heaviest first (rows x keys), so long prefill tiles and long decode
//   rows start together.
// There is no scalar prefetch on Hopper: each block reads its item, tile
// descriptor and block-table row from device memory. The plan is built
// on the host once per step (from the host kv_lens where the caller has
// them, else from the table width, whose surplus spans exit at once) and
// shared by every layer.
//
// paged_attention_int8.cu runs the same body over int8 pools.
//
// Not yet done (later PRs): tensor cores for long prefill tiles.
#include "ragged_split.cuh"

// tables, ws: see pt::split::launch. dtype: pt::kF32 or pt::kBF16 (q,
// pool and out alike). scales: null (the int8 library's argument).
extern "C" int pt_paged_attention_split(
    int dtype, const void* q, long long q_sr, long long q_sh,
    const void* pool, const float* scales, const int* bt, int mb,
    const int* q_lens, const int* kv_lens, const int* tables, int n_tiles,
    int n_items, void* ws, void* out, int R, int nh, int nkv, int hd,
    int bs, int max_rows, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kBF16)
    return pt::split::entry<__nv_bfloat16>(
        dtype, q, q_sr, q_sh, pool, scales, bt, mb, q_lens, kv_lens, tables,
        n_tiles, n_items, ws, out, R, nh, nkv, hd, bs, max_rows, scale, s);
  return pt::split::entry<float>(
      dtype, q, q_sr, q_sh, pool, scales, bt, mb, q_lens, kv_lens, tables,
      n_tiles, n_items, ws, out, R, nh, nkv, hd, bs, max_rows, scale, s);
}

// The most query rows (tile rows x g) one block holds at head width hd
// (sized for float32 pages, so it holds for bf16 ones too).
extern "C" int pt_paged_attention_max_rows(int hd) {
  return pt::split::max_rows_hd<float>(hd);
}

// Key positions per span (the host plan cuts its items by it).
extern "C" int pt_paged_attention_span() { return pt::split::kSpan; }
