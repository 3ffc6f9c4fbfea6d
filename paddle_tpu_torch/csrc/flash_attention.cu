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
// 3.35 TB/s); the backward's 7 products of the causal half 1.95 ms.
//
// What the design does about it: a first, simple version. The TPU grid's
// sequential ("arbitrary") axis becomes a loop inside one block: a block
// owns 64 query rows (forward, dQ) or 64 key rows (dK/dV) of one (batch,
// head) and walks the other side's tiles, skipping tiles that lie wholly
// above the causal diagonal (the forward only when t_k >= t_q, as
// Pallas). Inputs are read through their strides ([B, L, H, D] or
// [BH, T, D], head_dim contiguous), so no transposed copy is made in
// device memory. bf16 inputs (the training path) run on the tensor cores
// with mma.sync (see the bf16 section below); float32 inputs run SIMT
// kernels: tiles staged in shared memory as fp32 (rows padded to D + 4
// floats, so 16-byte reads of neighbouring rows fall in distinct banks),
// 256 threads each computing a 4 x 4 block of scores and a 4 x D/16
// block of the output with fp32 FMAs, the row statistics reduced across
// the 16 lanes that share a row. wgmma, TMA and a pipelined tile ring are
// later work.
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
// col) of head bh; int32 wraparound arithmetic done in uint32
__device__ __forceinline__ float keep_scale(int row, int col, int bh,
                                            const FlashArgs& a) {
  uint32_t h = ((uint32_t)row * 0x9E3779B9u ^ (uint32_t)col * 1013904223u ^
                (uint32_t)bh * 374761393u) +
               a.seed;
  h = hash_mix(h);
  const float u = (float)(h & 0xFFFFFFu) * (1.0f / 16777216.0f);
  return u >= a.rate ? a.keep : 0.0f;
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

// ------------------------------------- bf16: tensor cores (mma.sync)
// The same three kernels for bf16 inputs on the tensor cores:
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulators). Four warps per
// block, each owning 16 rows of the block's 64; scores stay in
// registers, and a score fragment is, element for element, the A operand
// of the next product (p, dS and P*mask rounded to bf16 on the way, the
// Pallas rounding points). Tiles are staged in shared memory as bf16,
// rows padded by 8 elements so that the fragment loads of the 8 row
// groups fall in distinct banks; operands needed along the other axis
// (V for P.V, K for dS.K, Q and dO for the dK/dV products) are staged
// transposed from the same loads.
constexpr int kTcThreads = 128;
constexpr int kTcQ2 = 32;  // query rows per tile of the dK/dV kernel
using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// rows [r0, r0 + R) of a [n, D] bf16 matrix (row stride st) into dst
// [R][D + 8] and/or, transposed, dstT [D][R + 8]; rows >= n are zeros.
// Consecutive threads take consecutive rows, so the transposed stores
// of a warp hit consecutive addresses.
template <int D, int R>
__device__ __forceinline__ void stage_bf16(bf16* dst, bf16* dstT,
                                           const bf16* src, long long st,
                                           int r0, int n) {
  for (int i = threadIdx.x; i < R * (D / 8); i += kTcThreads) {
    const int r = i % R, c = (i / R) * 8;
    const int row = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < n) v = *reinterpret_cast<const uint4*>(src + row * st + c);
    if (dst) *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = v;
    if (dstT) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) dstT[(c + k) * (R + 8) + r] = e[k];
    }
  }
}

// the A fragment (16 x 16) of rows [row0, row0 + 16), columns
// [col0, col0 + 16) of a bf16 tile with row stride ld
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* t, int ld,
                                       int row0, int col0, int g, int t4) {
  const bf16* p = t + (row0 + g) * ld + col0 + t4 * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// the B fragment (16 x 8) whose column n is row n0 + n of a bf16 tile
// with row stride ld, over columns [col0, col0 + 16) of that tile
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* t, int ld, int n0,
                                       int col0, int g, int t4) {
  const bf16* p = t + (n0 + g) * ld + col0 + t4 * 2;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// score fragments s[2 kk], s[2 kk + 1] (16 x 16) as a bf16 A fragment
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float lo[4],
                                       const float hi[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

__device__ __forceinline__ float qmax4(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float qsum4(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_fwd_tc(const FlashArgs a) {
  constexpr int LD = D + 8, LT = kBK + 8, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + kBQ * LD;
  bf16* vt_s = k_s + kBK * LD;  // V transposed: [D][64 keys]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, w0 = warp * 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * kBQ, off = a.t_k - a.t_q;
  const bf16* k = head_ptr<bf16>(a.k, a.sk, b, h);
  const bf16* v = head_ptr<bf16>(a.v, a.sv, b, h);
  stage_bf16<D, kBQ>(q_s, nullptr, head_ptr<bf16>(a.q, a.sq, b, h), a.sq.st,
                     q0, a.t_q);
  float m[2] = {pt::kNegInf, pt::kNegInf}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  int n_kv = (a.t_k + kBK - 1) / kBK;
  if (a.causal && off >= 0) n_kv = min(n_kv, (q0 + kBQ - 1 + off) / kBK + 1);
  const bool drop = a.rate > 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    stage_bf16<D, kBK>(k_s, nullptr, k, a.sk.st, k0, a.t_k);
    stage_bf16<D, kBK>(nullptr, vt_s, v, a.sv.st, k0, a.t_k);
    __syncthreads();
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t af[4];
      frag_a(af, q_s, LD, w0, kk * 16, g, t4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        frag_b(b0, b1, k_s, LD, j * 8, kk * 16, g, t4);
        mma_bf16(s[j], af, b0, b1);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + w0 + g + 8 * hf;
      float mx = pt::kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + j * 8 + t4 * 2 + e;
          float x = s[j][2 * hf + e] * a.scale;
          if (col >= a.t_k || (a.causal && row + off < col)) x = pt::kNegInf;
          s[j][2 * hf + e] = x;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[hf], qmax4(mx));
      const float alpha = expf(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + j * 8 + t4 * 2 + e;
          const float p = col < a.t_k ? expf(s[j][2 * hf + e] - m_new) : 0.f;
          sum += p;
          s[j][2 * hf + e] = drop ? p * keep_scale(row, col, bh, a) : p;
        }
      l[hf] = alpha * l[hf] + qsum4(sum);
      m[hf] = m_new;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][2 * hf] *= alpha;
        o[n][2 * hf + 1] *= alpha;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, vt_s, LT, n * 8, kk * 16, g, t4);
        mma_bf16(o[n], pa, b0, b1);
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.out) + b * a.sout.sb + h * a.sout.sh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + w0 + g + 8 * hf;
    if (row >= a.t_q) continue;
    const float lc = fmaxf(l[hf], 1e-30f);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(out + row * a.sout.st + n * 8 + t4 * 2) =
          pack_bf16(o[n][2 * hf] / lc, o[n][2 * hf + 1] / lc);
    if (t4 == 0) a.lse[(long long)bh * a.t_q + row] = m[hf] + logf(lc);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_dq_tc(const FlashArgs a) {
  constexpr int LD = D + 8, LT = kBK + 8, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* do_s = q_s + kBQ * LD;
  bf16* k_s = do_s + kBQ * LD;
  bf16* v_s = k_s + kBK * LD;
  bf16* kt_s = v_s + kBK * LD;  // K transposed: [D][64 keys]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, w0 = warp * 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.x * kBQ, off = a.t_k - a.t_q;
  const bf16* k = head_ptr<bf16>(a.k, a.sk, b, h);
  const bf16* v = head_ptr<bf16>(a.v, a.sv, b, h);
  stage_bf16<D, kBQ>(q_s, nullptr, head_ptr<bf16>(a.q, a.sq, b, h), a.sq.st,
                     q0, a.t_q);
  stage_bf16<D, kBQ>(do_s, nullptr, head_ptr<bf16>(a.dout, a.sdo, b, h),
                     a.sdo.st, q0, a.t_q);
  float lse[2], dl[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + w0 + g + 8 * hf;
    const long long at = (long long)bh * a.t_q + row;
    lse[hf] = row < a.t_q ? a.lse[at] : 0.f;
    dl[hf] = row < a.t_q ? a.delta[at] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  int n_kv = (a.t_k + kBK - 1) / kBK;
  if (a.causal) {
    const int last = q0 + kBQ - 1 + off;
    n_kv = last < 0 ? 0 : min(n_kv, last / kBK + 1);
  }
  const bool drop = a.rate > 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    stage_bf16<D, kBK>(k_s, kt_s, k, a.sk.st, k0, a.t_k);
    stage_bf16<D, kBK>(v_s, nullptr, v, a.sv.st, k0, a.t_k);
    __syncthreads();
    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ad[4];
      frag_a(aq, q_s, LD, w0, kk * 16, g, t4);
      frag_a(ad, do_s, LD, w0, kk * 16, g, t4);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        uint32_t b0, b1;
        frag_b(b0, b1, k_s, LD, j * 8, kk * 16, g, t4);
        mma_bf16(s[j], aq, b0, b1);
        frag_b(b0, b1, v_s, LD, j * 8, kk * 16, g, t4);
        mma_bf16(dp[j], ad, b0, b1);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = q0 + w0 + g + 8 * hf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + j * 8 + t4 * 2 + e;
          const bool valid = col < a.t_k && !(a.causal && row + off < col);
          const float p =
              valid ? expf(s[j][2 * hf + e] * a.scale - lse[hf]) : 0.f;
          float d = dp[j][2 * hf + e];
          if (drop) d *= keep_scale(row, col, bh, a);
          s[j][2 * hf + e] = p * (d - dl[hf]) * a.scale;  // dS
        }
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t da[4];
      c_to_a(da, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, kt_s, LT, n * 8, kk * 16, g, t4);
        mma_bf16(dq[n], da, b0, b1);
      }
    }
  }

  bf16* out = static_cast<bf16*>(a.out) + b * a.sout.sb + h * a.sout.sh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = q0 + w0 + g + 8 * hf;
    if (row >= a.t_q) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<uint32_t*>(out + row * a.sout.st + n * 8 + t4 * 2) =
          pack_bf16(dq[n][2 * hf], dq[n][2 * hf + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
    flash_dkv_tc(const FlashArgs a) {
  constexpr int LD = D + 8, LT = kTcQ2 + 8, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kBK * LD;
  bf16* q_s = v_s + kBK * LD;     // [32 queries][D]
  bf16* do_s = q_s + kTcQ2 * LD;
  bf16* qt_s = do_s + kTcQ2 * LD;  // Q transposed: [D][32 queries]
  bf16* dot_s = qt_s + D * LT;     // dO transposed
  float* lse_s = reinterpret_cast<float*>(dot_s + D * LT);
  float* dl_s = lse_s + kTcQ2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, w0 = warp * 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int k0 = blockIdx.x * kBK, off = a.t_k - a.t_q;
  const bf16* q = head_ptr<bf16>(a.q, a.sq, b, h);
  const bf16* gq = head_ptr<bf16>(a.dout, a.sdo, b, h);
  stage_bf16<D, kBK>(k_s, nullptr, head_ptr<bf16>(a.k, a.sk, b, h), a.sk.st,
                     k0, a.t_k);
  stage_bf16<D, kBK>(v_s, nullptr, head_ptr<bf16>(a.v, a.sv, b, h), a.sv.st,
                     k0, a.t_k);
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  const int n_q = (a.t_q + kTcQ2 - 1) / kTcQ2;
  const bool drop = a.rate > 0.f;

  for (int qt = 0; qt < n_q; ++qt) {
    const int q0 = qt * kTcQ2;
    if (a.causal && q0 + kTcQ2 - 1 + off < k0) continue;
    __syncthreads();
    stage_bf16<D, kTcQ2>(q_s, qt_s, q, a.sq.st, q0, a.t_q);
    stage_bf16<D, kTcQ2>(do_s, dot_s, gq, a.sdo.st, q0, a.t_q);
    if (threadIdx.x < kTcQ2) {
      const int row = q0 + threadIdx.x;
      const long long at = (long long)bh * a.t_q + row;
      lse_s[threadIdx.x] = row < a.t_q ? a.lse[at] : 0.f;
      dl_s[threadIdx.x] = row < a.t_q ? a.delta[at] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];  // S^T, dP^T: [16 keys][32 queries]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, k_s, LD, w0, kk * 16, g, t4);
      frag_a(av, v_s, LD, w0, kk * 16, g, t4);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t b0, b1;
        frag_b(b0, b1, q_s, LD, j * 8, kk * 16, g, t4);
        mma_bf16(st[j], ak, b0, b1);
        frag_b(b0, b1, do_s, LD, j * 8, kk * 16, g, t4);
        mma_bf16(dpt[j], av, b0, b1);
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int col = k0 + w0 + g + 8 * hf;  // this fragment row's key
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = j * 8 + t4 * 2 + e, row = q0 + r;
          const bool valid = row < a.t_q && col < a.t_k &&
                             !(a.causal && row + off < col);
          const float p =
              valid ? expf(st[j][2 * hf + e] * a.scale - lse_s[r]) : 0.f;
          float pv = p, d = dpt[j][2 * hf + e];
          if (drop) {
            const float ks = keep_scale(row, col, bh, a);
            pv = p * ks;
            d *= ks;
          }
          st[j][2 * hf + e] = pv;                          // (P o M)^T
          dpt[j][2 * hf + e] = p * (d - dl_s[r]) * a.scale;  // dS^T
        }
    }
#pragma unroll
    for (int kk = 0; kk < kTcQ2 / 16; ++kk) {
      uint32_t pa[4], da[4];
      c_to_a(pa, st[2 * kk], st[2 * kk + 1]);
      c_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        frag_b(b0, b1, dot_s, LT, n * 8, kk * 16, g, t4);
        mma_bf16(dv[n], pa, b0, b1);  // dV += (P o M)^T dO
        frag_b(b0, b1, qt_s, LT, n * 8, kk * 16, g, t4);
        mma_bf16(dk[n], da, b0, b1);  // dK += dS^T Q
      }
    }
  }

  bf16* dkp = static_cast<bf16*>(a.dk) + b * a.sdk.sb + h * a.sdk.sh;
  bf16* dvp = static_cast<bf16*>(a.dv) + b * a.sdv.sb + h * a.sdv.sh;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int row = k0 + w0 + g + 8 * hf;
    if (row >= a.t_k) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = n * 8 + t4 * 2;
      *reinterpret_cast<uint32_t*>(dkp + row * a.sdk.st + c) =
          pack_bf16(dk[n][2 * hf], dk[n][2 * hf + 1]);
      *reinterpret_cast<uint32_t*>(dvp + row * a.sdv.st + c) =
          pack_bf16(dv[n][2 * hf], dv[n][2 * hf + 1]);
    }
  }
}

// ------------------------------------------------------------ launchers
// float32 runs the SIMT kernels, bf16 the tensor-core ones
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
template <int D>
constexpr size_t fwd_tc_smem() {
  return sizeof(bf16) * (2 * 64 * (D + 8) + D * (kBK + 8));
}
template <int D>
constexpr size_t dq_tc_smem() {
  return sizeof(bf16) * (4 * 64 * (D + 8) + D * (kBK + 8));
}
template <int D>
constexpr size_t dkv_tc_smem() {
  return sizeof(bf16) * (2 * 64 * (D + 8) + 2 * kTcQ2 * (D + 8) +
                         2 * D * (kTcQ2 + 8)) +
         sizeof(float) * 2 * kTcQ2;
}

template <typename K>
int launch(K kernel, dim3 grid, int threads, size_t smem, size_t* configured,
           const FlashArgs& a, cudaStream_t s) {
  cudaError_t e = pt::ensure_smem(kernel, smem, configured);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, threads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_fwd(const FlashArgs& a, int BH, cudaStream_t s) {
  static size_t configured = 0;
  const dim3 grid((a.t_q + kBQ - 1) / kBQ, BH);
  if constexpr (std::is_same<T, bf16>::value)
    return launch(flash_fwd_tc<D>, grid, kTcThreads, fwd_tc_smem<D>(),
                  &configured, a, s);
  else
    return launch(flash_fwd_kernel<D>, grid, kFlashThreads, fwd_smem<D>(),
                  &configured, a, s);
}

template <typename T, int D>
int launch_bwd(const FlashArgs& a, int BH, cudaStream_t s) {
  const int n_rows = BH * a.t_q;
  flash_delta_kernel<T><<<(n_rows + 7) / 8, kFlashThreads, 0, s>>>(a, D,
                                                                    n_rows);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  static size_t cfg_dq = 0, cfg_dkv = 0;
  const dim3 grid_q((a.t_q + kBQ - 1) / kBQ, BH);
  const dim3 grid_k((a.t_k + kBK - 1) / kBK, BH);
  if constexpr (std::is_same<T, bf16>::value) {
    e = launch(flash_dq_tc<D>, grid_q, kTcThreads, dq_tc_smem<D>(), &cfg_dq,
               a, s);
    if (e != 0 || a.t_k == 0) return e;
    return launch(flash_dkv_tc<D>, grid_k, kTcThreads, dkv_tc_smem<D>(),
                  &cfg_dkv, a, s);
  } else {
    e = launch(flash_dq_kernel<D>, grid_q, kFlashThreads, dq_smem<D>(),
               &cfg_dq, a, s);
    if (e != 0 || a.t_k == 0) return e;
    return launch(flash_dkv_kernel<D>, grid_k, kFlashThreads,
                  dkv_smem<D>(), &cfg_dkv, a, s);
  }
}

template <typename T>
int dispatch(bool bwd, int hd, const FlashArgs& a, int BH, cudaStream_t s) {
  if (hd == 64) return bwd ? launch_bwd<T, 64>(a, BH, s)
                           : launch_fwd<T, 64>(a, BH, s);
  if (hd == 128) return bwd ? launch_bwd<T, 128>(a, BH, s)
                            : launch_fwd<T, 128>(a, BH, s);
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
  if (dtype == pt::kF32) return dispatch<float>(bwd, hd, a, BH, s);
  if (dtype == pt::kBF16) return dispatch<bf16>(bwd, hd, a, BH, s);
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
