// Ragged paged attention kernel template for Hopper (sm_90a), shared by
// paged_attention.cu (float32 / bf16 pools) and paged_attention_int8.cu
// (int8 pools with per-position scales). Each source instantiates only its
// own pool type, so the two compile in parallel.
//
// tiles[t] = (sequence, query offset within it, real rows, first packed
// row); one block per (tile, kv head). See paged_attention.cu for what the
// kernel computes and how it is laid out.
#pragma once

#include "attention_common.cuh"

namespace pt {

// Pool row of (K|V, position p) for one sequence and kv head, in units of
// head_dim vectors; the scale pages [num_blocks, 2, nkv, bs] share it.
template <typename P>
struct PagedAddr {
  const P* pool;
  const int* bt_row;  // this sequence's block-table row
  int nkv, kvh, bs, hd;
  __device__ __forceinline__ int64_t row(int which, int p) const {
    const int64_t blk = bt_row[p / bs];
    return ((blk * 2 + which) * nkv + kvh) * bs + (p % bs);
  }
  __device__ __forceinline__ const P* operator()(int which, int p) const {
    return pool + row(which, p) * (int64_t)hd;
  }
};

// int8 payload in registers with its position's scale; dequantized
// ((float)q * scale, the plain version's product) only when staged
struct QRaw {
  char4 q;
  float s;
};

struct PagedKVQ {
  PagedAddr<int8_t> at;
  const float* scales;
  using Raw = QRaw;
  __device__ __forceinline__ QRaw raw4(int which, int p, int d) const {
    const int64_t r = at.row(which, p);
    QRaw o;
    o.q = *reinterpret_cast<const char4*>(at.pool + r * at.hd + d);
    o.s = scales[r];
    return o;
  }
  __device__ __forceinline__ static float4 cvt(const QRaw& r) {
    return make_float4((float)r.q.x * r.s, (float)r.q.y * r.s,
                       (float)r.q.z * r.s, (float)r.q.w * r.s);
  }
  __device__ __forceinline__ float load1(int which, int p, int d) const {
    const int64_t r = at.row(which, p);
    return (float)at.pool[r * at.hd + d] * scales[r];
  }
};

template <typename P>
__device__ __forceinline__ RowsKV<P, PagedAddr<P>> paged_kv(
    const P* pool, const float*, const int* bt_row, int nkv, int kvh, int bs,
    int hd) {
  return RowsKV<P, PagedAddr<P>>{{pool, bt_row, nkv, kvh, bs, hd}};
}

__device__ __forceinline__ PagedKVQ paged_kv(const int8_t* pool,
                                             const float* scales,
                                             const int* bt_row, int nkv,
                                             int kvh, int bs, int hd) {
  return PagedKVQ{{pool, bt_row, nkv, kvh, bs, hd}, scales};
}

// T: query / output type; P: pool element type (T, or int8 with scales)
template <typename T, typename P, int NT>
__global__ void __launch_bounds__(kThreads)
    ragged_kernel(const T* __restrict__ q, int64_t q_sr, int64_t q_sh,
                  const P* __restrict__ pool,
                  const float* __restrict__ scales,
                  const int* __restrict__ bt, int mb,
                  const int* __restrict__ q_lens,
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
  const auto kv =
      paged_kv(pool, scales, bt + (int64_t)seq * mb, nkv, kvh, bs, hd);
  auto qrow = [&](int r, int d) {
    const int64_t row = row0 + r / g, head = kvh * g + r % g;
    return to_f(q[row * q_sr + head * q_sh + d]);
  };
  auto orow = [&](int r, int d, float x) {
    const int64_t row = row0 + r / g, head = kvh * g + r % g;
    out[(row * nh + head) * hd + d] = from_f<T>(x);
  };
  auto qpos = [&](int r) { return pos0 + r / g; };
  attention_block<NT>(kv, n_keys, n * g, hd, scale, vec != 0, qrow, orow,
                      qpos);
}

template <typename T, typename P, int NT>
int launch_ragged(const void* q, long long q_sr, long long q_sh,
                  const void* pool, const float* scales, const int* bt,
                  int mb, const int* q_lens, const int* kv_lens,
                  const int* tiles, int n_tiles, void* out, int nh, int nkv,
                  int hd, int bs, int max_rows, float scale, int vec,
                  cudaStream_t stream) {
  static size_t configured = 0;
  const size_t smem = smem_bytes(max_rows, hd);
  cudaError_t e =
      ensure_smem(ragged_kernel<T, P, NT>, smem, &configured);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_tiles, nkv);
  ragged_kernel<T, P, NT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), q_sr, q_sh, static_cast<const P*>(pool),
      scales, bt, mb, q_lens, kv_lens, reinterpret_cast<const int4*>(tiles),
      static_cast<T*>(out), nh, nkv, hd, bs, scale, vec);
  return (int)cudaGetLastError();
}

// launch_ragged at the accumulator width head_dim hd needs
template <typename T, typename P>
int launch_ragged_hd(const void* q, long long q_sr, long long q_sh,
                     const void* pool, const float* scales, const int* bt,
                     int mb, const int* q_lens, const int* kv_lens,
                     const int* tiles, int n_tiles, void* out, int nh,
                     int nkv, int hd, int bs, int max_rows, float scale,
                     int vec, cudaStream_t stream) {
  int err = (int)cudaErrorInvalidValue;
  with_tiles(hd, [&](auto nt) {
    err = launch_ragged<T, P, decltype(nt)::value>(
        q, q_sr, q_sh, pool, scales, bt, mb, q_lens, kv_lens, tiles, n_tiles,
        out, nh, nkv, hd, bs, max_rows, scale, vec, stream);
  });
  return err;
}

}  // namespace pt
