// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py
//   _flash_fwd_pallas (:157; kernel _flash_fwd_kernel :69, pallas_call :221)
//   _flash_bwd_pallas (:382; dq kernel _flash_bwd_dq_kernel :245, call :434;
//                      dk/dv kernel _flash_bwd_dkv_kernel :308, call :463).
//
// What it computes: online-softmax attention of q [t_q, D] over k, v
// [t_k, D] for every (batch, head), with the Pallas kernels' semantics:
// scores scaled by sm_scale, masked entries set to -1e30 (never -inf, so
// a fully masked row degrades to uniform attention), causal masking
// bottom-right (row + t_k - t_q >= col), key columns >= t_k adding exactly
// 0, optional probability dropout from the position hash (_keep_scale:
// a murmur3 finalizer over row, col, b*H+h and the seed, bit for bit),
// the normalizer taken over the undropped probabilities. The forward
// writes out and lse = m + log(l); the backward is FlashAttention-2 from
// lse and delta = rowsum(dO * O), split as in JAX: one kernel owns dQ and
// walks the key tiles, the other owns dK and dV and walks the query
// tiles, so every output is written once, with no atomics, and the same
// bits come out run to run. Rounding points follow Pallas: p to the input
// type before P.V, dS to the input type before dS.K and dS^T.Q, P*mask to
// the input type before dV.
//
// What bounds it on the H100: operations. At the training shape (B*H 512,
// T 2048, D 128, causal, bf16) the forward does 5.50e11 FLOP (0.556 ms at
// the 989 TFLOP/s bf16 tensor-core peak) against 1.07 GB (0.32 ms at
// 3.35 TB/s). The backward needs 5 products of the causal half (1.39 ms);
// the split design recomputes S and dP in both kernels, 7 products
// (1.95 ms), the price of writing every output once without atomics.
//
// What the design does about it (bf16, the training path): the products
// run on wgmma, the only way to the tensor cores' full rate, fed by TMA.
// A block has a producer warpgroup (one thread keeps 64 x 64 TMA boxes in
// flight into a 3-stage shared-memory ring guarded by full/empty
// mbarriers; setmaxnreg moves its registers to the consumers) and two
// consumer warpgroups, each owning 64 of the block's 128 rows. Tiles stay
// in the 128-byte swizzle TMA writes; the score products read both
// operands K-major from shared memory, and each probability or dS tile,
// rounded to bf16 on the accumulator, is the register A operand of the
// next product, whose B (V, K, Q or dO) is read MN-major in place: no
// operand is ever copied transposed. The forward and dQ consumers are
// software-pipelined: the scores of tile j + 1 run on the tensor cores
// beside the product of tile j, and the softmax (or dS) of tile j + 1 is
// formed while that product is still in flight. The mask, the tail test
// and the index arithmetic run only on tiles that hold the causal
// diagonal or a tail; dropout's keep bits are hashed while the score
// products run; tiles above a warpgroup's diagonal are skipped (the
// forward only when t_k >= t_q, as Pallas); a head's blocks run together
// (its tiles stay in L2) with the heaviest query tiles (forward, dQ) or
// key tiles (dK/dV) first. Accumulators leave through shared memory in
// 16-byte stores. ptxas must report no spills (chip_smoke.py checks).
//
// float32 inputs run SIMT kernels: tiles staged in shared memory as fp32
// (rows padded to D + 4 floats, so 16-byte reads of neighbouring rows fall
// in distinct banks), 256 threads each computing a 4 x 4 block of scores
// and a 4 x D/16 block of the output with fp32 FMAs, the row statistics
// reduced across the 16 lanes that share a row.
#include <cuda.h>
#include <climits>

#include "attention_common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kFlashThreads = 256;
constexpr int kLDP = kBK + 4;  // row stride of a [64, 64] score tile

struct Strides {
  long long sb, sh, st;  // batch, head, position strides in elements
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* out;  // forward: o; backward: dq
  void* dk;
  void* dv;
  float* lse;    // [B * H, t_q]
  float* delta;  // [B * H, t_q]
  Strides sq, sk, sv, so, sdo, sout, sdk, sdv;
  int H, t_q, t_k;
  float scale;
  int causal;
  float rate, keep;  // dropout rate and 1 / (1 - rate)
  unsigned seed;
};

__device__ __forceinline__ uint32_t hash_mix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// _keep_scale: keep / (1 - rate) for the attention probability at (row,
// col) of head bh; int32 wraparound arithmetic done in uint32. The hash
// XORs a (row, head) term with a column term, so a tile computes each
// term once per row and once per column.
__device__ __forceinline__ uint32_t row_term(int row, int bh) {
  return (uint32_t)row * 0x9E3779B9u ^ (uint32_t)bh * 374761393u;
}
__device__ __forceinline__ uint32_t col_term(int col) {
  return (uint32_t)col * 1013904223u;
}
__device__ __forceinline__ bool keep_bit(uint32_t terms, const FlashArgs& a) {
  const uint32_t h = hash_mix(terms + a.seed);
  return (float)(h & 0xFFFFFFu) * (1.0f / 16777216.0f) >= a.rate;
}
__device__ __forceinline__ float keep_scale(int row, int col, int bh,
                                            const FlashArgs& a) {
  return keep_bit(row_term(row, bh) ^ col_term(col), a) ? a.keep : 0.0f;
}

__device__ __forceinline__ void store4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

// rows [r0, r0 + 64) of a [n, D] matrix (row stride st) into dst [64][D+4];
// rows >= n are zeros
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long st, int r0, int n) {
  constexpr int LD = D + 4, C4 = D / 4;
  for (int i = threadIdx.x; i < 64 * C4; i += kFlashThreads) {
    const int r = i / C4, c = (i - r * C4) * 4;
    const int row = r0 + r;
    const float4 v = row < n ? pt::load4(src + row * st + c)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    store4(dst + r * LD + c, v);
  }
}

__device__ __forceinline__ float hmax16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float hsum16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// c[i][j] = sum_d A[ty + 16 i][d] * B[tx + 16 j][d]   (A, B: [64][D+4])
template <int D>
__device__ __forceinline__ void mm_nt(const float* A, const float* B,
                                      float c[4][4], int ty, int tx) {
  constexpr int LD = D + 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * LD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = c[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        c[i][j] = s;
      }
  }
}

__device__ __forceinline__ void fma4(float4& c, float a, const float4& b) {
  c.x = fmaf(a, b.x, c.x);
  c.y = fmaf(a, b.y, c.y);
  c.z = fmaf(a, b.z, c.z);
  c.w = fmaf(a, b.w, c.w);
}

// c[i][jj] += sum_k A[ty + 16 i][k] * B[k][tx * 4 + 64 jj .. + 3]
// (A: [64][kLDP], B: [64][D+4])
template <int D>
__device__ __forceinline__ void mm_nn(const float* A, const float* B,
                                      float4 c[4][D / 64], int ty, int tx) {
  constexpr int LD = D + 4, NC = D / 64;
#pragma unroll 2
  for (int k = 0; k < kBK; k += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * kLDP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 b[NC];
#pragma unroll
      for (int jj = 0; jj < NC; ++jj)
        b[jj] = *reinterpret_cast<const float4*>(B + (k + kk) * LD + tx * 4 +
                                                 64 * jj);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float av = kk == 0 ? a[i].x : kk == 1 ? a[i].y
                         : kk == 2 ? a[i].z : a[i].w;
#pragma unroll
        for (int jj = 0; jj < NC; ++jj) fma4(c[i][jj], av, b[jj]);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base,
                                             const Strides& s, int b, int h) {
  return static_cast<const T*>(base) + b * s.sb + h * s.sh;
}

// ------------------------------------------- float32: SIMT, forward
template <int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_fwd_kernel(const FlashArgs a) {
  constexpr int LD = D + 4, NC = D / 64;
  extern __shared__ float sm[];
  float* q_s = sm;
  float* k_s = q_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* p_s = v_s + kBK * LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * kBQ, off = a.t_k - a.t_q;
  const float* q = head_ptr<float>(a.q, a.sq, b, h);
  const float* k = head_ptr<float>(a.k, a.sk, b, h);
  const float* v = head_ptr<float>(a.v, a.sv, b, h);
  load_tile<D>(q_s, q, a.sq.st, q0, a.t_q);

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = pt::kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int n_kv = (a.t_k + kBK - 1) / kBK;
  // causal tile skipping only when t_k >= t_q (no row is fully masked)
  if (a.causal && off >= 0) n_kv = min(n_kv, (q0 + kBQ - 1 + off) / kBK + 1);
  const bool drop = a.rate > 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(k_s, k, a.sk.st, k0, a.t_k);
    load_tile<D>(v_s, v, a.sv.st, k0, a.t_k);
    __syncthreads();
    float s[4][4];
    mm_nt<D>(q_s, k_s, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = pt::kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * a.scale;
        if (col >= a.t_k || (a.causal && row + off < col)) x = pt::kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], hmax16(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        // tail columns add exactly 0, even while the max is still -1e30
        const float p = col < a.t_k ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        const float pu = drop ? p * keep_scale(row, col, bh, a) : p;
        p_s[(ty + 16 * i) * kLDP + tx + 16 * j] = pu;
      }
      l[i] = alpha * l[i] + hsum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        acc[i][jj].x *= alpha;
        acc[i][jj].y *= alpha;
        acc[i][jj].z *= alpha;
        acc[i][jj].w *= alpha;
      }
    }
    __syncthreads();
    mm_nn<D>(p_s, v_s, acc, ty, tx);
  }

  float* o = static_cast<float*>(a.out) + b * a.sout.sb + h * a.sout.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.t_q) continue;
    const float lc = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const float4 c = acc[i][jj];
      store4(o + row * a.sout.st + tx * 4 + 64 * jj,
             make_float4(c.x / lc, c.y / lc, c.z / lc, c.w / lc));
    }
    if (tx == 0) a.lse[(long long)bh * a.t_q + row] = m[i] + logf(lc);
  }
}

// ---------------------------------------- backward: delta (both types)
// delta[bh, row] = sum_d dO * O in fp32; one warp per row
template <typename T>
__global__ void __launch_bounds__(kFlashThreads)
    flash_delta_kernel(const FlashArgs a, int D, int n_rows) {
  const int w = (blockIdx.x * kFlashThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n_rows) return;
  const int bh = w / a.t_q, row = w - bh * a.t_q;
  const int b = bh / a.H, h = bh - b * a.H;
  const T* o = head_ptr<T>(a.o, a.so, b, h) + row * a.so.st;
  const T* g = head_ptr<T>(a.dout, a.sdo, b, h) + row * a.sdo.st;
  float s = 0.f;
  for (int d = lane * 4; d < D; d += 128) {
    const float4 x = pt::load4(o + d), y = pt::load4(g + d);
    s += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
  }
  s = pt::warp_sum(s);
  if (lane == 0) a.delta[w] = s;
}

// ------------------------------------------ float32: SIMT, backward dQ
template <int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_dq_kernel(const FlashArgs a) {
  constexpr int LD = D + 4, NC = D / 64;
  extern __shared__ float sm[];
  float* q_s = sm;
  float* do_s = q_s + kBQ * LD;
  float* k_s = do_s + kBQ * LD;
  float* v_s = k_s + kBK * LD;
  float* ds_s = v_s + kBK * LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * kBQ, off = a.t_k - a.t_q;
  const float* k = head_ptr<float>(a.k, a.sk, b, h);
  const float* v = head_ptr<float>(a.v, a.sv, b, h);
  load_tile<D>(q_s, head_ptr<float>(a.q, a.sq, b, h), a.sq.st, q0, a.t_q);
  load_tile<D>(do_s, head_ptr<float>(a.dout, a.sdo, b, h), a.sdo.st, q0,
                  a.t_q);
  float lse[4], dl[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = (long long)bh * a.t_q + row;
    lse[i] = row < a.t_q ? a.lse[at] : 0.f;
    dl[i] = row < a.t_q ? a.delta[at] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) acc[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  int n_kv = (a.t_k + kBK - 1) / kBK;
  if (a.causal) {
    const int last = q0 + kBQ - 1 + off;  // the tile's lowest visible row
    n_kv = last < 0 ? 0 : min(n_kv, last / kBK + 1);
  }
  const bool drop = a.rate > 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<D>(k_s, k, a.sk.st, k0, a.t_k);
    load_tile<D>(v_s, v, a.sv.st, k0, a.t_k);
    __syncthreads();
    float s[4][4], dp[4][4];
    mm_nt<D>(q_s, k_s, s, ty, tx);
    mm_nt<D>(do_s, v_s, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool valid = col < a.t_k && !(a.causal && row + off < col);
        const float p = valid ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        float d = dp[i][j];
        if (drop) d *= keep_scale(row, col, bh, a);
        ds_s[(ty + 16 * i) * kLDP + tx + 16 * j] =
            p * (d - dl[i]) * a.scale;
      }
    }
    __syncthreads();
    mm_nn<D>(ds_s, k_s, acc, ty, tx);
  }

  float* dq = static_cast<float*>(a.out) + b * a.sout.sb + h * a.sout.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.t_q) continue;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj)
      store4(dq + row * a.sout.st + tx * 4 + 64 * jj, acc[i][jj]);
  }
}

// ------------------------------------- float32: SIMT, backward dK, dV
template <int D>
__global__ void __launch_bounds__(kFlashThreads)
    flash_dkv_kernel(const FlashArgs a) {
  constexpr int LD = D + 4, NC = D / 64;
  extern __shared__ float sm[];
  float* k_s = sm;
  float* v_s = k_s + kBK * LD;
  float* q_s = v_s + kBK * LD;
  float* do_s = q_s + kBQ * LD;
  float* t_s = do_s + kBQ * LD;  // P^T, then dS^T: [64 keys][64 queries]
  float* lse_s = t_s + kBK * kLDP;
  float* dl_s = lse_s + kBQ;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int k0 = blockIdx.x * kBK, off = a.t_k - a.t_q;
  const float* q = head_ptr<float>(a.q, a.sq, b, h);
  const float* g = head_ptr<float>(a.dout, a.sdo, b, h);
  load_tile<D>(k_s, head_ptr<float>(a.k, a.sk, b, h), a.sk.st, k0, a.t_k);
  load_tile<D>(v_s, head_ptr<float>(a.v, a.sv, b, h), a.sv.st, k0, a.t_k);
  float4 dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      dk[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
      dv[i][jj] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  const int n_q = (a.t_q + kBQ - 1) / kBQ;
  const bool drop = a.rate > 0.f;

  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * kBQ;
    // a query tile wholly above the diagonal adds nothing
    if (a.causal && q0 + kBQ - 1 + off < k0) continue;
    __syncthreads();
    load_tile<D>(q_s, q, a.sq.st, q0, a.t_q);
    load_tile<D>(do_s, g, a.sdo.st, q0, a.t_q);
    if (threadIdx.x < kBQ) {
      const int row = q0 + threadIdx.x;
      const long long at = (long long)bh * a.t_q + row;
      lse_s[threadIdx.x] = row < a.t_q ? a.lse[at] : 0.f;
      dl_s[threadIdx.x] = row < a.t_q ? a.delta[at] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    mm_nt<D>(k_s, q_s, st, ty, tx);   // S^T [key][query]
    mm_nt<D>(v_s, do_s, dpt, ty, tx);  // dP^T
    float ds[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j, row = q0 + r;
        const bool valid = row < a.t_q && col < a.t_k &&
                           !(a.causal && row + off < col);
        const float p = valid ? expf(st[i][j] * a.scale - lse_s[r]) : 0.f;
        float pv = p, d = dpt[i][j];
        if (drop) {
          const float ks = keep_scale(row, col, bh, a);
          pv = p * ks;
          d *= ks;
        }
        ds[i][j] = p * (d - dl_s[r]) * a.scale;
        t_s[(ty + 16 * i) * kLDP + r] = pv;
      }
    }
    __syncthreads();
    mm_nn<D>(t_s, do_s, dv, ty, tx);  // dV += (P o M)^T dO
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        t_s[(ty + 16 * i) * kLDP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    mm_nn<D>(t_s, q_s, dk, ty, tx);  // dK += dS^T Q
  }

  float* dkp = static_cast<float*>(a.dk) + b * a.sdk.sb + h * a.sdk.sh;
  float* dvp = static_cast<float*>(a.dv) + b * a.sdv.sb + h * a.sdv.sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= a.t_k) continue;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      store4(dkp + row * a.sdk.st + tx * 4 + 64 * jj, dk[i][jj]);
      store4(dvp + row * a.sdv.st + tx * 4 + 64 * jj, dv[i][jj]);
    }
  }
}

// ----------------------------------------- bf16: Hopper tensor cores
// Three kernels, one per TPU kernel's output: flash_fwd_wgmma (out, lse),
// flash_dq_wgmma (dQ) and flash_dkv_wgmma (dK, dV). Each block has three
// warpgroups: warpgroup 0 is the producer (one thread issues the TMA
// loads, setmaxnreg hands its registers to the others), warpgroups 1 and 2
// are consumers that each own 64 rows of the block's 128 (wgmma's M).
// Every tile is one or more 64 x 64 TMA boxes ([B, L, H, D] read through
// its strides, rows past the end filled with zeros), stored as 64-column
// panels of 128-byte rows in the 128-byte swizzle that wgmma reads.
using bf16 = __nv_bfloat16;

constexpr int kWgThreads = 384;                 // producer + 2 consumers
constexpr uint32_t kBoxBytes = 64 * 128;        // one 64 x 64 bf16 box
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kMask2 = -1e30f * kLog2e;       // a masked score, log2 units
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

struct TmaMaps {
  CUtensorMap q, k, v, g;  // g: dO
};
struct WgParams {
  TmaMaps m;
  FlashArgs a;
  int tiles;  // 128-row tiles per (batch, head): the grid is BH x tiles
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t n) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(n)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// the 64 x 64 box at (column col, position row) of head (h, b)
__device__ __forceinline__ void tma_load(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(h), "r"(b)
      : "memory");
}

// positions [row0, row0 + R) of one head, all D columns, into D / 64
// panels of [R][64] (R * 128 bytes each)
template <int D, int R>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
#pragma unroll
  for (int pn = 0; pn < D / 64; ++pn)
#pragma unroll
    for (int rb = 0; rb < R / 64; ++rb)
      tma_load(dst + pn * R * 128 + rb * kBoxBytes, map, bar, pn * 64,
               row0 + rb * 64, h, b);
}

// the wgmma shared-memory descriptor of a tile of 64-column panels
// (`panel` bytes apart) of 128-byte rows in the 128-byte swizzle: start
// address, leading byte offset `panel` (used by MN-major operands), stride
// byte offset 1024 between 8-row groups, all in 16-byte units
__device__ __forceinline__ uint64_t tile_desc(uint32_t tile, uint32_t panel) {
  return (uint64_t)((tile & 0x3FFFFu) >> 4) | ((uint64_t)(panel >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// k-step kk of a K-major operand (the reduction axis contiguous: the rows
// of Q, K, V, dO in the score products): 16 columns = 32 bytes into the
// 128-byte row of panel kk / 4 (8-row groups 1024 bytes apart)
__device__ __forceinline__ uint32_t k_step(uint32_t panel, int kk) {
  return ((kk >> 2) * panel + (kk & 3) * 32) >> 4;
}

// k-step kk of an MN-major operand (the output axis contiguous: V in P.V,
// K in dS.K, dO and Q in the dV and dK products, read in place, never
// transposed): rows 16 kk.. of every panel; the descriptor's leading
// offset steps between 64-column panels, its stride offset between 8-row
// groups
__device__ __forceinline__ uint32_t mn_step(int kk) { return kk * 128; }

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed product groups are still running
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the accumulators are read only after the products that write them are
// done: no read may move above this point
template <int R>
__device__ __forceinline__ void keep(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// the 128 threads of one consumer warpgroup (named barrier 1 or 2)
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// wgmma.m64nNk16, fp32 += bf16 x bf16. _ss: A and B from shared memory,
// each a tile's descriptor plus the k-step's offset (16-byte units, added
// inside the asm so the compiler keeps one descriptor per tile in
// registers, not one per k-step); _rs: A from registers (the m16n8k16 A
// fragment of each warp's 16 rows). TB: B is MN-major. acc 0 overwrites d.
template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint32_t oa, uint64_t db,
                                         uint32_t ob, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %36, 0;\n"
      "cvt.u64.u32 da, %33;\nadd.s64 da, da, %32;\n"
      "cvt.u64.u32 db, %35;\nadd.s64 db, db, %34;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "da, db, p, 1, 1, 0, %37;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "r"(oa), "l"(db), "r"(ob), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t db, uint32_t ob, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "cvt.u64.u32 db, %37;\nadd.s64 db, db, %36;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, db, p, 1, 1, %39;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(ob),
        "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint32_t oa, uint64_t db,
                                         uint32_t ob, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 da, db;\n"
      "setp.ne.b32 p, %68, 0;\n"
      "cvt.u64.u32 da, %65;\nadd.s64 da, da, %64;\n"
      "cvt.u64.u32 db, %67;\nadd.s64 db, db, %66;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "da, db, p, 1, 1, 0, %69;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "r"(oa), "l"(db), "r"(ob), "r"(acc), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t* a,
                                         uint64_t db, uint32_t ob, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\n"
      "setp.ne.b32 p, %70, 0;\n"
      "cvt.u64.u32 db, %69;\nadd.s64 db, db, %68;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, db, p, 1, 1, %71;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(ob),
        "r"(acc), "n"(TB));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// An accumulator of wgmma.m64nNk16: thread (warp w, lane 4 g + t4) holds
// d[4 j + 2 hf + e] at row 16 w + g + 8 hf, column 8 j + 2 t4 + e. Its
// 16-column k-step kk, rounded to bf16, is the register A operand of the
// next product, element for element.
template <int R>
__device__ __forceinline__ void to_a(uint32_t (&a)[R / 2], const float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) a[i] = pack_bf16(d[2 * i], d[2 * i + 1]);
}

__device__ __forceinline__ float qmax4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float qsum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// (r, c) of a tile of 64-column panels of `panel` bytes, 128-byte swizzle
__device__ __forceinline__ uint32_t swz(int r, int c, uint32_t panel) {
  return (c >> 6) * panel + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) +
         (c & 7) * 2;
}

// A consumer warpgroup's 64 x D accumulator to rows [r0, r0 + 64) of a
// [*, D] bf16 output: scaled by inv[hf], staged in the warpgroup's own 64
// rows of a panelled tile (its products are done), then copied out in
// 16-byte stores, rows >= n dropped
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           const float (&inv)[2],
                                           uint8_t* stage, uint32_t panel,
                                           bf16* out, long long st, int r0,
                                           int n, int bar_id, int tw) {
  const int warp = tw >> 5, g = (tw & 31) >> 2, t4 = tw & 3;
  wg_sync(bar_id);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = 16 * warp + g + 8 * hf;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(stage + swz(r, 8 * j + 2 * t4, panel)) =
          pack_bf16(acc[4 * j + 2 * hf] * inv[hf],
                    acc[4 * j + 2 * hf + 1] * inv[hf]);
  }
  wg_sync(bar_id);
#pragma unroll
  for (int i = tw; i < 64 * D / 8; i += 128) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    if (r0 + r < n)
      *reinterpret_cast<uint4*>(out + (r0 + r) * st + c) =
          *reinterpret_cast<const uint4*>(stage + swz(r, c, panel));
  }
}

// ----------------------------------------------------------- forward
template <int D>
struct FwdSmem {
  static constexpr int kStages = 3;
  static constexpr uint32_t kQ = 128 * D * 2;   // Q: 128 rows
  static constexpr uint32_t kKV = 128 * D * 2;  // a K or V tile: 128 keys
  static constexpr uint32_t kBars = kQ + kStages * 2 * kKV;
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// S = Q K^T for one key tile: issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[64], uint64_t q_desc,
                                        uint32_t k_tile) {
  constexpr uint32_t kPanel = 128 * 128;
  const uint64_t k_desc = tile_desc(k_tile, kPanel);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(s, q_desc, k_step(kPanel, kk), k_desc, k_step(kPanel, kk),
                kk > 0);
  wg_commit();
}

// O += P V for one key tile (p as the register A operand, V read
// MN-major): issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[32],
                                         uint32_t v_tile) {
  const uint64_t v_desc = tile_desc(v_tile, 128 * 128);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_rs<1>(o, &pa[4 * kk], v_desc, mn_step(kk), 1);
  wg_commit();
}

// the dropout keep bits of one key tile, bit 2 j + e of kb[hf] for the
// thread's column 8 j + e in row hf: computed while the products run
__device__ __forceinline__ void fwd_keep_bits(uint32_t (&kb)[2], int row_a,
                                              int k0, int bh, int t4,
                                              const FlashArgs& a) {
  kb[0] = kb[1] = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t ct = col_term(k0 + 8 * j + 2 * t4 + e);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (keep_bit(row_term(row_a + 8 * hf, bh) ^ ct, a))
          kb[hf] |= 1u << (2 * j + e);
    }
}

// the online softmax of one S tile on its accumulator: s becomes p
// (dropout applied), m and l move on, alpha is the factor O must take.
// MASK: the tile holds the causal diagonal or the key tail; other tiles
// take no per-element test.
template <bool MASK, bool DROP>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             const uint32_t (&kb)[2],
                                             int row_a, int k0, int t4,
                                             const FlashArgs& a) {
  const float sl2 = a.scale * kLog2e;
  // column 8 j + e of this thread (k0 + 8 j + 2 t4 + e) is a key tail
  // when 8 j + e >= tail, and masked in row hf when 8 j + e >= lim[hf]
  const int tail = a.t_k - k0 - 2 * t4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int lim =
        a.causal ? min(tail, row_a + 8 * hf + a.t_k - a.t_q + 1 - k0 - 2 * t4)
                 : tail;
    float mx = kMask2;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * j + 2 * hf + e] * sl2;
        if (MASK && 8 * j + e >= lim) x = kMask2;
        s[4 * j + 2 * hf + e] = x;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m[hf], qmax4(mx));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = exp2f(s[4 * j + 2 * hf + e] - m_new);
        // tail columns add exactly 0, even while the max is still masked
        if (MASK && 8 * j + e >= tail) p = 0.f;
        sum += p;
        if (DROP) p *= (kb[hf] >> (2 * j + e)) & 1u ? a.keep : 0.f;
        s[4 * j + 2 * hf + e] = p;
      }
    alpha[hf] = exp2f(m[hf] - m_new);
    l[hf] = alpha[hf] * l[hf] + qsum4(sum);
    m[hf] = m_new;
  }
}

template <bool DROP>
__device__ __forceinline__ void softmax_tile(bool mask, float (&s)[64],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const uint32_t (&kb)[2],
                                             int row_a, int k0, int t4,
                                             const FlashArgs& a) {
  if (mask)
    softmax_tile<true, DROP>(s, m, l, alpha, kb, row_a, k0, t4, a);
  else
    softmax_tile<false, DROP>(s, m, l, alpha, kb, row_a, k0, t4, a);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ WgParams p) {
  using L = FwdSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;
  const FlashArgs& a = p.a;
  const int bh = blockIdx.x / p.tiles, b = bh / a.H, h = bh - b * a.H;
  // a head's blocks run together (its K and V stay in L2), and within a
  // head the last query tiles, which see the most keys, start first
  const int q0 = (p.tiles - 1 - blockIdx.x % p.tiles) * 128;
  const int off = a.t_k - a.t_q;
  int n_kv = (a.t_k + 127) / 128;
  // causal tile skipping only when t_k >= t_q (no row is fully masked)
  if (a.causal && off >= 0) n_kv = min(n_kv, (q0 + 127 + off) / 128 + 1);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, L::kQ);
      load_tile<D, 128>(sm, &p.m.q, q_full, q0, h, b);
      int st = 0, ph = 0;
      for (int kt = 0; kt < n_kv; ++kt) {
        mbar_wait(&empty[st], ph ^ 1);
        uint8_t* kv = sm + L::kQ + st * 2 * L::kKV;
        mbar_expect_tx(&full[st], 2 * L::kKV);
        load_tile<D, 128>(kv, &p.m.k, &full[st], kt * 128, h, b);
        load_tile<D, 128>(kv + L::kKV, &p.m.v, &full[st], kt * 128, h, b);
        if (++st == L::kStages) st = 0, ph ^= 1;
      }
    }
  } else {  // consumers
    reg_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, tw = threadIdx.x & 127;
    const int t4 = tw & 3, r0 = q0 + 64 * cw;
    const int row_a = r0 + 16 * (tw >> 5) + ((tw & 31) >> 2);
    float o[D / 2], m[2] = {kMask2, kMask2}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    const uint64_t q_desc = tile_desc(smem_u32(sm) + cw * 64 * 128, 128 * 128);
    // tiles past n_run lie wholly above this warpgroup's diagonal: they
    // add exactly 0 and are only released
    int n_run = n_kv;
    if (a.causal && off >= 0) n_run = min(n_kv, (r0 + 63 + off) / 128 + 1);
    auto kv_tile = [&](int stage) {
      return smem_u32(sm + L::kQ + stage * 2 * L::kKV);
    };
    auto masked = [&](int k0) {
      return k0 + 128 > a.t_k || (a.causal && r0 + off < k0 + 127);
    };
    // software pipeline: S of tile kt runs on the tensor cores beside
    // P V of tile kt - 1, and the softmax of tile kt runs while P V is
    // still in flight
    float s[64], alpha[2];
    uint32_t pa[32], kb[2] = {0u, 0u};
    mbar_wait(q_full, 0);
    int st = 0, ph = 0, prev = 0;
    if (n_run > 0) {
      mbar_wait(&full[0], 0);
      wg_fence();
      issue_s<D>(s, q_desc, kv_tile(0));
      if (DROP) fwd_keep_bits(kb, row_a, 0, bh, t4, a);
      wg_wait<0>();
      keep(s);
      softmax_tile<DROP>(masked(0), s, m, l, alpha, kb, row_a, 0, t4, a);
      to_a(pa, s);
    }
    for (int kt = 1; kt < n_run; ++kt) {
      const int k0 = kt * 128;
      prev = st;
      if (++st == L::kStages) st = 0, ph ^= 1;
      mbar_wait(&full[st], ph);
      wg_fence();
      issue_s<D>(s, q_desc, kv_tile(st));
      issue_pv<D>(o, pa, kv_tile(prev) + L::kKV);
      if (DROP) fwd_keep_bits(kb, row_a, k0, bh, t4, a);
      wg_wait<1>();  // S is done; P V may still run
      keep(s);
      softmax_tile<DROP>(masked(k0), s, m, l, alpha, kb, row_a, k0, t4, a);
      wg_wait<0>();
      keep(o);
      if (tw == 0) mbar_arrive(&empty[prev]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          o[4 * n + 2 * hf] *= alpha[hf];
          o[4 * n + 2 * hf + 1] *= alpha[hf];
        }
      to_a(pa, s);
    }
    if (n_run > 0) {
      wg_fence();
      issue_pv<D>(o, pa, kv_tile(st) + L::kKV);
      wg_wait<0>();
      keep(o);
      if (tw == 0) mbar_arrive(&empty[st]);
      if (++st == L::kStages) st = 0, ph ^= 1;
    }
    for (int kt = n_run; kt < n_kv; ++kt) {
      mbar_wait(&full[st], ph);
      if (tw == 0) mbar_arrive(&empty[st]);
      if (++st == L::kStages) st = 0, ph ^= 1;
    }
    float inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float lc = fmaxf(l[hf], 1e-30f);
      inv[hf] = 1.f / lc;
      const int row = row_a + 8 * hf;
      if (t4 == 0 && row < a.t_q)
        a.lse[(long long)bh * a.t_q + row] =
            m[hf] == kMask2 ? pt::kNegInf + logf(lc)
                            : (m[hf] + log2f(lc)) * kLn2;
    }
    bf16* out = static_cast<bf16*>(a.out) + b * a.sout.sb + h * a.sout.sh;
    store_rows<D>(o, inv, sm + cw * 64 * 128, 128 * 128, out, a.sout.st, r0,
                  a.t_q, 1 + cw, tw);
  }
}

// ----------------------------------------------------------- backward dQ
template <int D>
struct DqSmem {
  static constexpr int kStages = 3;
  static constexpr uint32_t kQ = 128 * D * 2;  // Q, dO: 128 rows
  static constexpr uint32_t kKV = 64 * D * 2;  // a K or V tile: 64 keys
  static constexpr uint32_t kBars = 2 * kQ + kStages * 2 * kKV;
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// S = Q K^T and dP = dO V^T for one key tile: issued and committed as
// one group, not waited for
template <int D>
__device__ __forceinline__ void issue_s_dp(float (&s)[32], float (&dp)[32],
                                           uint64_t q_desc, uint64_t do_desc,
                                           uint32_t k_tile) {
  constexpr uint32_t kQPanel = 128 * 128, kKPanel = 64 * 128;
  const uint64_t k_desc = tile_desc(k_tile, kKPanel);
  const uint64_t v_desc = tile_desc(k_tile + DqSmem<D>::kKV, kKPanel);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(s, q_desc, k_step(kQPanel, kk), k_desc, k_step(kKPanel, kk),
                kk > 0);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(dp, do_desc, k_step(kQPanel, kk), v_desc,
                k_step(kKPanel, kk), kk > 0);
  wg_commit();
}

// dQ += dS K for one key tile (dS as the register A operand, K read
// MN-major): issued and committed, not waited for
template <int D>
__device__ __forceinline__ void issue_dq(float (&dq)[D / 2],
                                         const uint32_t (&da)[16],
                                         uint32_t k_tile) {
  const uint64_t k_desc = tile_desc(k_tile, 64 * 128);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<1>(dq, &da[4 * kk], k_desc, mn_step(kk), 1);
  wg_commit();
}

// the dropout keep bits of one 64-key tile, bit i of kb for accumulator
// element i: computed while the products run
__device__ __forceinline__ uint32_t dq_keep_bits(int row_a, int k0, int bh,
                                                 int t4, const FlashArgs& a) {
  uint32_t kb = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t ct = col_term(k0 + 8 * j + 2 * t4 + e);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (keep_bit(row_term(row_a + 8 * hf, bh) ^ ct, a))
          kb |= 1u << (4 * j + 2 * hf + e);
    }
  return kb;
}

// dS = p (dP - delta) scale of one key tile on the accumulators, into s
template <bool MASK, bool DROP>
__device__ __forceinline__ void ds_tile(float (&s)[32], const float (&dp)[32],
                                        uint32_t kb, int row_a, int k0,
                                        int t4, const float (&lse2)[2],
                                        const float (&dl)[2],
                                        const FlashArgs& a) {
  const float sl2 = a.scale * kLog2e;
  // column 8 j + e of this thread (k0 + 8 j + 2 t4 + e) is masked in row
  // hf (a key tail or above the diagonal) when 8 j + e >= lim[hf]
  const int tail = a.t_k - k0 - 2 * t4;
  int lim[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    lim[hf] = a.causal ? min(tail, row_a + 8 * hf + a.t_k - a.t_q + 1 - k0 -
                                       2 * t4)
                       : tail;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * j + 2 * hf + e;
        float p = exp2f(fmaf(s[i], sl2, -lse2[hf]));
        if (MASK && 8 * j + e >= lim[hf]) p = 0.f;
        float d = dp[i];
        if (DROP) d *= (kb >> i) & 1u ? a.keep : 0.f;
        s[i] = p * (d - dl[hf]) * a.scale;
      }
}

template <bool DROP>
__device__ __forceinline__ void ds_tile(bool mask, float (&s)[32],
                                        const float (&dp)[32], uint32_t kb,
                                        int row_a, int k0, int t4,
                                        const float (&lse2)[2],
                                        const float (&dl)[2],
                                        const FlashArgs& a) {
  if (mask)
    ds_tile<true, DROP>(s, dp, kb, row_a, k0, t4, lse2, dl, a);
  else
    ds_tile<false, DROP>(s, dp, kb, row_a, k0, t4, lse2, dl, a);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_dq_wgmma(const __grid_constant__ WgParams p) {
  using L = DqSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::kStages;
  const FlashArgs& a = p.a;
  const int bh = blockIdx.x / p.tiles, b = bh / a.H, h = bh - b * a.H;
  const int q0 = (p.tiles - 1 - blockIdx.x % p.tiles) * 128;
  const int off = a.t_k - a.t_q;
  int n_kv = (a.t_k + 63) / 64;
  if (a.causal) {
    const int last = q0 + 127 + off;  // the tile's lowest visible key
    n_kv = last < 0 ? 0 : min(n_kv, last / 64 + 1);
  }
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * L::kQ);
      load_tile<D, 128>(sm, &p.m.q, q_full, q0, h, b);
      load_tile<D, 128>(sm + L::kQ, &p.m.g, q_full, q0, h, b);
      int st = 0, ph = 0;
      for (int kt = 0; kt < n_kv; ++kt) {
        mbar_wait(&empty[st], ph ^ 1);
        uint8_t* kv = sm + 2 * L::kQ + st * 2 * L::kKV;
        mbar_expect_tx(&full[st], 2 * L::kKV);
        load_tile<D, 64>(kv, &p.m.k, &full[st], kt * 64, h, b);
        load_tile<D, 64>(kv + L::kKV, &p.m.v, &full[st], kt * 64, h, b);
        if (++st == L::kStages) st = 0, ph ^= 1;
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, tw = threadIdx.x & 127;
    const int t4 = tw & 3, r0 = q0 + 64 * cw;
    const int row_a = r0 + 16 * (tw >> 5) + ((tw & 31) >> 2);
    float lse2[2], dl[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = row_a + 8 * hf;
      const long long at = (long long)bh * a.t_q + row;
      lse2[hf] = row < a.t_q ? a.lse[at] * kLog2e : 0.f;
      dl[hf] = row < a.t_q ? a.delta[at] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    const uint32_t q_tile = smem_u32(sm) + cw * 64 * 128;
    const uint64_t q_desc = tile_desc(q_tile, 128 * 128);
    const uint64_t do_desc = tile_desc(q_tile + L::kQ, 128 * 128);
    // tiles past n_run lie wholly above this warpgroup's diagonal: they
    // add exactly 0 and are only released
    int n_run = n_kv;
    if (a.causal) {
      const int last = r0 + 63 + off;
      n_run = last < 0 ? 0 : min(n_kv, last / 64 + 1);
    }
    auto kv_tile = [&](int stage) {
      return smem_u32(sm + 2 * L::kQ + stage * 2 * L::kKV);
    };
    auto masked = [&](int k0) {
      return k0 + 64 > a.t_k || (a.causal && r0 + off < k0 + 63);
    };
    // software pipeline: S and dP of tile kt run on the tensor cores
    // beside dQ += dS K of tile kt - 1, and dS of tile kt is formed while
    // that product is still in flight
    float s[32], dp[32];
    uint32_t da[16], kb = 0u;
    mbar_wait(q_full, 0);
    int st = 0, ph = 0, prev = 0;
    if (n_run > 0) {
      mbar_wait(&full[0], 0);
      wg_fence();
      issue_s_dp<D>(s, dp, q_desc, do_desc, kv_tile(0));
      if (DROP) kb = dq_keep_bits(row_a, 0, bh, t4, a);
      wg_wait<0>();
      keep(s);
      keep(dp);
      ds_tile<DROP>(masked(0), s, dp, kb, row_a, 0, t4, lse2, dl, a);
      to_a(da, s);
    }
    for (int kt = 1; kt < n_run; ++kt) {
      const int k0 = kt * 64;
      prev = st;
      if (++st == L::kStages) st = 0, ph ^= 1;
      mbar_wait(&full[st], ph);
      wg_fence();
      issue_s_dp<D>(s, dp, q_desc, do_desc, kv_tile(st));
      issue_dq<D>(dq, da, kv_tile(prev));
      if (DROP) kb = dq_keep_bits(row_a, k0, bh, t4, a);
      wg_wait<1>();  // S and dP are done; dQ += dS K may still run
      keep(s);
      keep(dp);
      ds_tile<DROP>(masked(k0), s, dp, kb, row_a, k0, t4, lse2, dl, a);
      wg_wait<0>();
      keep(dq);
      if (tw == 0) mbar_arrive(&empty[prev]);
      to_a(da, s);
    }
    if (n_run > 0) {
      wg_fence();
      issue_dq<D>(dq, da, kv_tile(st));
      wg_wait<0>();
      keep(dq);
      if (tw == 0) mbar_arrive(&empty[st]);
      if (++st == L::kStages) st = 0, ph ^= 1;
    }
    for (int kt = n_run; kt < n_kv; ++kt) {
      mbar_wait(&full[st], ph);
      if (tw == 0) mbar_arrive(&empty[st]);
      if (++st == L::kStages) st = 0, ph ^= 1;
    }
    const float one[2] = {1.f, 1.f};
    bf16* out = static_cast<bf16*>(a.out) + b * a.sout.sb + h * a.sout.sh;
    store_rows<D>(dq, one, sm + cw * 64 * 128, 128 * 128, out, a.sout.st, r0,
                  a.t_q, 1 + cw, tw);
  }
}

// -------------------------------------------------------- backward dK, dV
template <int D>
struct DkvSmem {
  static constexpr int kStages = 3;
  static constexpr uint32_t kKV = 128 * D * 2;  // K, V: 128 keys
  static constexpr uint32_t kQ = 64 * D * 2;    // a Q or dO tile: 64 queries
  // per stage: lse (log2 units) and delta of the tile's 64 queries
  static constexpr uint32_t kRows = 2 * kKV + kStages * 2 * kQ;
  static constexpr uint32_t kBars = kRows + kStages * 128 * 4;
  static constexpr size_t kBytes = kBars + 8 * (1 + 2 * kStages) + 1024;
};

// one query tile: S^T = K Q^T, dP^T = V dO^T; (P o M)^T and dS^T rounded
// to bf16 as the register A operands of dV += (P o M)^T dO and
// dK += dS^T Q (dO and Q read MN-major)
template <int D, bool MASK, bool DROP>
__device__ __forceinline__ void dkv_tile(float (&dk)[D / 2],
                                         float (&dv)[D / 2], uint64_t k_desc,
                                         uint64_t v_desc, uint32_t q_tile,
                                         const float* rows, int key_a, int q0,
                                         int bh, int t4, const FlashArgs& a) {
  constexpr uint32_t kKPanel = 128 * 128, kQPanel = 64 * 128;
  const uint64_t q_desc = tile_desc(q_tile, kQPanel);
  const uint64_t do_desc = tile_desc(q_tile + DkvSmem<D>::kQ, kQPanel);
  float st[32], dpt[32];
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(st, k_desc, k_step(kKPanel, kk), q_desc, k_step(kQPanel, kk),
                kk > 0);
  wg_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(dpt, v_desc, k_step(kKPanel, kk), do_desc,
                k_step(kQPanel, kk), kk > 0);
  wg_commit();
  // while the products run: the dropout keep bits, bit i of kb for
  // accumulator element i
  uint32_t kb = 0u;
  if (DROP) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const uint32_t rt = row_term(q0 + 8 * j + 2 * t4 + e, bh);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (keep_bit(rt ^ col_term(key_a + 8 * hf), a))
            kb |= 1u << (4 * j + 2 * hf + e);
      }
  }
  wg_wait<1>();  // S^T is done; dP^T may still run
  keep(st);
  const float sl2 = a.scale * kLog2e;
  // query 8 j + e of this thread (q0 + 8 j + 2 t4 + e) is past t_q when
  // 8 j + e >= tail, and above key hf's diagonal when 8 j + e < lo[hf]
  const int tail = a.t_q - q0 - 2 * t4;
  int lo[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf)
    lo[hf] = a.causal ? key_a + 8 * hf - (a.t_k - a.t_q) - q0 - 2 * t4
                      : INT_MIN;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float lse2 = rows[8 * j + 2 * t4 + e];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * j + 2 * hf + e;
        float p = exp2f(fmaf(st[i], sl2, -lse2));
        if (MASK && (8 * j + e >= tail || 8 * j + e < lo[hf])) p = 0.f;
        st[i] = p;
      }
    }
  wg_wait<0>();
  keep(dpt);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float dl = rows[64 + 8 * j + 2 * t4 + e];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int i = 4 * j + 2 * hf + e;
        const float p = st[i];
        float pv = p, d = dpt[i];
        if (DROP) {
          const float ks = (kb >> i) & 1u ? a.keep : 0.f;
          pv = p * ks;
          d *= ks;
        }
        st[i] = pv;                       // (P o M)^T
        dpt[i] = p * (d - dl) * a.scale;  // dS^T
      }
    }
  uint32_t pa[16], da[16];
  to_a(pa, st);
  to_a(da, dpt);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<1>(dv, &pa[4 * kk], do_desc, mn_step(kk), 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<1>(dk, &da[4 * kk], q_desc, mn_step(kk), 1);
  wg_commit();
  wg_wait<0>();
  keep(dv);
  keep(dk);
}

// with dropout every tile takes the masked body: one body fewer keeps the
// dropout kernel within its registers (the mask is exact on any tile)
template <int D, bool DROP>
__device__ __forceinline__ void dkv_tile(bool mask, float (&dk)[D / 2],
                                         float (&dv)[D / 2], uint64_t k_desc,
                                         uint64_t v_desc, uint32_t q_tile,
                                         const float* rows, int key_a, int q0,
                                         int bh, int t4, const FlashArgs& a) {
  if (mask || DROP)
    dkv_tile<D, true, DROP>(dk, dv, k_desc, v_desc, q_tile, rows, key_a, q0,
                            bh, t4, a);
  else
    dkv_tile<D, false, DROP>(dk, dv, k_desc, v_desc, q_tile, rows, key_a, q0,
                             bh, t4, a);
}

template <int D, bool DROP>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_dkv_wgmma(const __grid_constant__ WgParams p) {
  using L = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  float* rows_s = reinterpret_cast<float*>(sm + L::kRows);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sm + L::kBars);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + L::kStages;
  const FlashArgs& a = p.a;
  const int bh = blockIdx.x / p.tiles, b = bh / a.H, h = bh - b * a.H;
  // a head's blocks run together; under causal masking its first key
  // tiles meet the most queries, and they start first
  const int k0 = (blockIdx.x % p.tiles) * 128, off = a.t_k - a.t_q;
  const int n_q = (a.t_q + 63) / 64;
  int qt0 = 0;
  if (a.causal) {
    const int first = k0 - off;  // the first query that sees key k0
    qt0 = first <= 0 ? 0 : min(first / 64, n_q);
  }
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA thread + the row warp's lanes
      mbar_init(&empty[s], 2);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * L::kKV);
      load_tile<D, 128>(sm, &p.m.k, kv_full, k0, h, b);
      load_tile<D, 128>(sm + L::kKV, &p.m.v, kv_full, k0, h, b);
      int st = 0, ph = 0;
      for (int qt = qt0; qt < n_q; ++qt) {
        mbar_wait(&empty[st], ph ^ 1);
        uint8_t* qd = sm + 2 * L::kKV + st * 2 * L::kQ;
        mbar_expect_tx(&full[st], 2 * L::kQ);
        load_tile<D, 64>(qd, &p.m.q, &full[st], qt * 64, h, b);
        load_tile<D, 64>(qd + L::kQ, &p.m.g, &full[st], qt * 64, h, b);
        if (++st == L::kStages) st = 0, ph ^= 1;
      }
    } else if (threadIdx.x >= 32 && threadIdx.x < 64) {
      // the row warp: each tile's lse (log2 units) and delta, 0 past t_q
      const int lane = threadIdx.x - 32;
      int st = 0, ph = 0;
      for (int qt = qt0; qt < n_q; ++qt) {
        mbar_wait(&empty[st], ph ^ 1);
        float* rs = rows_s + st * 128;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * lane + e, row = qt * 64 + i;
          const long long at = (long long)bh * a.t_q + row;
          rs[i] = row < a.t_q ? a.lse[at] * kLog2e : 0.f;
          rs[64 + i] = row < a.t_q ? a.delta[at] : 0.f;
        }
        mbar_arrive(&full[st]);
        if (++st == L::kStages) st = 0, ph ^= 1;
      }
    }
  } else {
    reg_alloc<kConsumerRegs>();
    const int cw = threadIdx.x / 128 - 1, tw = threadIdx.x & 127;
    const int t4 = tw & 3, c0 = k0 + 64 * cw;
    const int key_a = c0 + 16 * (tw >> 5) + ((tw & 31) >> 2);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_tile = smem_u32(sm) + cw * 64 * 128;
    const uint64_t k_desc = tile_desc(k_tile, 128 * 128);
    const uint64_t v_desc = tile_desc(k_tile + L::kKV, 128 * 128);
    mbar_wait(kv_full, 0);
    int st = 0, ph = 0;
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * 64;
      mbar_wait(&full[st], ph);
      if (!(a.causal && q0 + 63 + off < c0)) {
        const uint32_t q_tile = smem_u32(sm + 2 * L::kKV + st * 2 * L::kQ);
        const float* rs = rows_s + st * 128;
        const bool mask = q0 + 64 > a.t_q || (a.causal && q0 + off < c0 + 63);
        dkv_tile<D, DROP>(mask, dk, dv, k_desc, v_desc, q_tile, rs, key_a, q0,
                          bh, t4, a);
      }
      if (tw == 0) mbar_arrive(&empty[st]);
      if (++st == L::kStages) st = 0, ph ^= 1;
    }
    const float one[2] = {1.f, 1.f};
    bf16* dkp = static_cast<bf16*>(a.dk) + b * a.sdk.sb + h * a.sdk.sh;
    bf16* dvp = static_cast<bf16*>(a.dv) + b * a.sdv.sb + h * a.sdv.sh;
    store_rows<D>(dk, one, sm + cw * 64 * 128, 128 * 128, dkp, a.sdk.st, c0,
                  a.t_k, 1 + cw, tw);
    store_rows<D>(dv, one, sm + L::kKV + cw * 64 * 128, 128 * 128, dvp,
                  a.sdv.st, c0, a.t_k, 1 + cw, tw);
  }
}

// ------------------------------------------------ building-block probe
// One warpgroup runs the kernels' building blocks alone, for a card test
// against torch.matmul (a, b contiguous bf16 through TMA, c float32):
//   mode 0: c [64, N] = a [64, 128] . b [N, 128]^T  (K-major A and B, as
//           S = Q K^T)
//   mode 1: c [64, 128] = a [64, R] . b [R, 128]     (A from registers,
//           MN-major B, as O += P V; R 64 or 128)
template <int N>
__global__ void __launch_bounds__(128)
    wgmma_probe(const __grid_constant__ WgParams p, int mode, int rows,
                float* c) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = align1024(smem_raw);
  uint8_t* b_s = sm + 2 * kBoxBytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(b_s + 2 * 128 * 128);
  const int tw = threadIdx.x, warp = tw >> 5, g = (tw & 31) >> 2, t4 = tw & 3;
  if (tw == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (tw == 0) {
    if (mode == 0) {
      mbar_expect_tx(bar, 2 * kBoxBytes + N * 256);
      load_tile<128, 64>(sm, &p.m.q, bar, 0, 0, 0);
      load_tile<128, N>(b_s, &p.m.k, bar, 0, 0, 0);
    } else {
      mbar_expect_tx(bar, rows * 256);
      if (rows == 64)
        load_tile<128, 64>(b_s, &p.m.k, bar, 0, 0, 0);
      else
        load_tile<128, 128>(b_s, &p.m.k, bar, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float d[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  if (mode == 0) {
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss<0>(d, tile_desc(smem_u32(sm), 64 * 128),
                  k_step(64 * 128, kk), tile_desc(smem_u32(b_s), N * 128),
                  k_step(N * 128, kk), kk > 0);
  } else if constexpr (N == 128) {
    const bf16* A = static_cast<const bf16*>(p.a.q);
    uint32_t af[32];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const bf16* r = A + (16 * warp + g) * rows + 16 * kk + 2 * t4;
      const bool in = kk * 16 < rows;
      af[4 * kk] = in ? *reinterpret_cast<const uint32_t*>(r) : 0u;
      af[4 * kk + 1] = in ? *reinterpret_cast<const uint32_t*>(r + 8 * rows)
                          : 0u;
      af[4 * kk + 2] = in ? *reinterpret_cast<const uint32_t*>(r + 8) : 0u;
      af[4 * kk + 3] =
          in ? *reinterpret_cast<const uint32_t*>(r + 8 * rows + 8) : 0u;
    }
    wg_fence();
    const uint32_t bt = smem_u32(b_s);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      if (kk * 16 < rows)
        wgmma_rs<1>(d, &af[4 * kk], tile_desc(bt, rows * 128), mn_step(kk),
                    1);
  }
  wg_commit();
  wg_wait<0>();
  keep(d);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      c[(16 * warp + g + 8 * (e >> 1)) * N + 8 * j + 2 * t4 + (e & 1)] =
          d[4 * j + e];
}

// ------------------------------------------------------------ launchers
// float32 runs the SIMT kernels, bf16 the wgmma ones
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * (3 * 64 * (D + 4) + 64 * kLDP);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * 64 * (D + 4) + 64 * kLDP);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (4 * 64 * (D + 4) + 64 * kLDP + 2 * kBQ);
}

template <typename K, typename P>
int launch(K kernel, dim3 grid, int threads, size_t smem, size_t* configured,
           const P& a, cudaStream_t s) {
  cudaError_t e = pt::ensure_smem(kernel, smem, configured);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled lives in libcuda: its address comes from the
// runtime's entry-point query, so the library links no libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// a bf16 [B, L, H, D] tensor (strides in elements) read in 64 x 64 boxes
// with the 128-byte swizzle; positions past L read as zeros
bool encode(CUtensorMap* map, const void* base, int D, int L, int H, int B,
            const Strides& s) {
  const EncodeTiledFn fn = encoder();
  if (fn == nullptr) return false;
  // an extent-1 axis is never stepped, so any legal stride will do
  auto bytes = [](long long st, int n) {
    return (cuuint64_t)(n > 1 ? st * 2 : 16);
  };
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)max(L, 1),
                              (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {bytes(s.st, L), bytes(s.sh, H),
                                 bytes(s.sb, B)};
  const cuuint32_t box[4] = {64, 64, 1, 1}, unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
int launch_fwd(const FlashArgs& a, int B, int BH, cudaStream_t s) {
  static size_t configured = 0;
  if constexpr (std::is_same<T, bf16>::value) {
    WgParams p{};
    p.a = a;
    if (!encode(&p.m.q, a.q, D, a.t_q, a.H, B, a.sq) ||
        !encode(&p.m.k, a.k, D, a.t_k, a.H, B, a.sk) ||
        !encode(&p.m.v, a.v, D, a.t_k, a.H, B, a.sv))
      return (int)cudaErrorInvalidValue;
    p.tiles = (a.t_q + 127) / 128;
    static size_t cfg_drop = 0;
    return a.rate > 0.f
               ? launch(flash_fwd_wgmma<D, true>, dim3(BH * p.tiles),
                        kWgThreads, FwdSmem<D>::kBytes, &cfg_drop, p, s)
               : launch(flash_fwd_wgmma<D, false>, dim3(BH * p.tiles),
                        kWgThreads, FwdSmem<D>::kBytes, &configured, p, s);
  } else {
    return launch(flash_fwd_kernel<D>, dim3((a.t_q + kBQ - 1) / kBQ, BH),
                  kFlashThreads, fwd_smem<D>(), &configured, a, s);
  }
}

template <typename T, int D>
int launch_bwd(const FlashArgs& a, int B, int BH, cudaStream_t s) {
  const int n_rows = BH * a.t_q;
  flash_delta_kernel<T><<<(n_rows + 7) / 8, kFlashThreads, 0, s>>>(a, D,
                                                                    n_rows);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  static size_t cfg_dq = 0, cfg_dkv = 0;
  if constexpr (std::is_same<T, bf16>::value) {
    WgParams p{};
    p.a = a;
    if (!encode(&p.m.q, a.q, D, a.t_q, a.H, B, a.sq) ||
        !encode(&p.m.k, a.k, D, a.t_k, a.H, B, a.sk) ||
        !encode(&p.m.v, a.v, D, a.t_k, a.H, B, a.sv) ||
        !encode(&p.m.g, a.dout, D, a.t_q, a.H, B, a.sdo))
      return (int)cudaErrorInvalidValue;
    static size_t cfg_dq_drop = 0, cfg_dkv_drop = 0;
    const bool drop = a.rate > 0.f;
    p.tiles = (a.t_q + 127) / 128;
    e = drop ? launch(flash_dq_wgmma<D, true>, dim3(BH * p.tiles), kWgThreads,
                      DqSmem<D>::kBytes, &cfg_dq_drop, p, s)
             : launch(flash_dq_wgmma<D, false>, dim3(BH * p.tiles),
                      kWgThreads, DqSmem<D>::kBytes, &cfg_dq, p, s);
    if (e != 0 || a.t_k == 0) return e;
    p.tiles = (a.t_k + 127) / 128;
    return drop ? launch(flash_dkv_wgmma<D, true>, dim3(BH * p.tiles),
                         kWgThreads, DkvSmem<D>::kBytes, &cfg_dkv_drop, p, s)
                : launch(flash_dkv_wgmma<D, false>, dim3(BH * p.tiles),
                         kWgThreads, DkvSmem<D>::kBytes, &cfg_dkv, p, s);
  } else {
    e = launch(flash_dq_kernel<D>, dim3((a.t_q + kBQ - 1) / kBQ, BH),
               kFlashThreads, dq_smem<D>(), &cfg_dq, a, s);
    if (e != 0 || a.t_k == 0) return e;
    return launch(flash_dkv_kernel<D>, dim3((a.t_k + kBK - 1) / kBK, BH),
                  kFlashThreads, dkv_smem<D>(), &cfg_dkv, a, s);
  }
}

template <typename T>
int dispatch(bool bwd, int hd, const FlashArgs& a, int B, int BH,
             cudaStream_t s) {
  if (hd == 64) return bwd ? launch_bwd<T, 64>(a, B, BH, s)
                           : launch_fwd<T, 64>(a, B, BH, s);
  if (hd == 128) return bwd ? launch_bwd<T, 128>(a, B, BH, s)
                            : launch_fwd<T, 128>(a, B, BH, s);
  return (int)cudaErrorInvalidValue;
}

Strides at(const long long* s, int i) { return {s[3 * i], s[3 * i + 1], s[3 * i + 2]}; }

int run(bool bwd, int dtype, int hd, FlashArgs& a, const long long* st,
        int B, void* stream) {
  a.sq = at(st, 0);
  a.sk = at(st, 1);
  a.sv = at(st, 2);
  a.so = at(st, 3);
  a.sdo = at(st, 4);
  a.sout = at(st, 5);
  a.sdk = at(st, 6);
  a.sdv = at(st, 7);
  const int BH = B * a.H;
  if (BH == 0 || a.t_q == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == pt::kF32) return dispatch<float>(bwd, hd, a, B, BH, s);
  if (dtype == pt::kBF16) return dispatch<bf16>(bwd, hd, a, B, BH, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// strides: 8 x (batch, head, position) in elements, in the order
// q, k, v, o, dO, out (forward o / backward dq), dk, dv; the forward
// reads the first three and the sixth.
extern "C" int pt_flash_fwd(int dtype, int hd, const void* q, const void* k,
                            const void* v, void* o, float* lse,
                            const long long* strides, int B, int H, int t_q,
                            int t_k, float scale, int causal, float rate,
                            float keep, unsigned seed, void* stream) {
  FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = o;
  a.lse = lse;
  a.H = H;
  a.t_q = t_q;
  a.t_k = t_k;
  a.scale = scale;
  a.causal = causal;
  a.rate = rate;
  a.keep = keep;
  a.seed = seed;
  return run(false, dtype, hd, a, strides, B, stream);
}

// delta: an fp32 workspace of B * H * t_q floats
extern "C" int pt_flash_bwd(int dtype, int hd, const void* q, const void* k,
                            const void* v, const void* o, const void* dout,
                            const float* lse, float* delta, void* dq,
                            void* dk, void* dv, const long long* strides,
                            int B, int H, int t_q, int t_k, float scale,
                            int causal, float rate, float keep,
                            unsigned seed, void* stream) {
  FlashArgs a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.out = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = const_cast<float*>(lse);
  a.delta = delta;
  a.H = H;
  a.t_q = t_q;
  a.t_k = t_k;
  a.scale = scale;
  a.causal = causal;
  a.rate = rate;
  a.keep = keep;
  a.seed = seed;
  return run(true, dtype, hd, a, strides, B, stream);
}

// wgmma_probe (above): mode 0 with n 64 or 128, mode 1 with rows 64 or
// 128; a, b contiguous bf16 on the card, c [64, n] float32
extern "C" int pt_flash_wgmma_probe(int mode, int n, int rows, const void* a,
                                    const void* b, float* c, void* stream) {
  WgParams p{};
  p.a.q = a;
  const Strides s{0, 0, 128};
  const bool ok = mode == 0
                      ? encode(&p.m.q, a, 128, 64, 1, 1, s) &&
                            encode(&p.m.k, b, 128, n, 1, 1, s)
                      : n == 128 && encode(&p.m.k, b, 128, rows, 1, 1, s);
  if (!ok || (n != 64 && n != 128) || (rows != 64 && rows != 128))
    return (int)cudaErrorInvalidValue;
  const size_t smem = 1024 + 2 * kBoxBytes + 2 * 128 * 128 + 8;
  static size_t cfg64 = 0, cfg128 = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = n == 64 ? pt::ensure_smem(wgmma_probe<64>, smem, &cfg64)
                          : pt::ensure_smem(wgmma_probe<128>, smem, &cfg128);
  if (e != cudaSuccess) return (int)e;
  if (n == 64)
    wgmma_probe<64><<<1, 128, smem, st>>>(p, mode, rows, c);
  else
    wgmma_probe<128><<<1, 128, smem, st>>>(p, mode, rows, c);
  return (int)cudaGetLastError();
}
