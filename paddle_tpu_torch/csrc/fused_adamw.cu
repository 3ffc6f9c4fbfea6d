// Fused AdamW update for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/fused_adamw.py fused_adamw_update (:67;
//   kernel _adamw_kernel :42, pallas_calls :110 and :120).
//
// What it computes, per element, in the Pallas kernel's order:
//   m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
//   upd = (m / bc1) / (sqrt(v / bc2) + eps) + wd master
//   master = master - lr upd;  p = master cast to p's type
// with the scalars (lr, b1, b2, eps, wd, bc1 = 1 - b1^step,
// bc2 = 1 - b2^step) read from a 7-float device tensor, so one launch
// serves every step (and a captured CUDA graph stays valid).
//
// What bounds it on the H100: bytes. p and g bf16, m, v and master fp32:
// 30 bytes an element (each read once, p, m, v and master written once),
// 20.0 GB per training step over the 12 leaves of the 2-layer Llama-2-7B
// proxy, 5.97 ms at 3.35 TB/s.
//
// What the design does about it: an elementwise grid-stride loop over the
// flat buffers, four elements a thread at a time (16-byte loads of m, v
// and master), updating p, m, v and master in place. No padding to the
// TPU's 1024-lane rows is needed; a scalar tail covers sizes that are not
// a multiple of 4 and buffers that are not 16-byte aligned.
#include "attention_common.cuh"

namespace {

constexpr int kAdamThreads = 256;

struct Scal {
  float lr, b1, b2, eps, wd, bc1, bc2;
};

__device__ __forceinline__ float adamw_one(float g, float& m, float& v,
                                           float& master, const Scal& s) {
  m = s.b1 * m + (1.0f - s.b1) * g;
  v = s.b2 * v + (1.0f - s.b2) * g * g;
  const float mhat = m / s.bc1;
  const float vhat = v / s.bc2;
  const float upd = mhat / (sqrtf(vhat) + s.eps) + s.wd * master;
  master = master - s.lr * upd;
  return master;
}

template <typename P>
__device__ __forceinline__ void load4v(const P* p, float* out) {
  const float4 v = pt::load4(p);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void store4v(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4v(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&a);
  u.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = u;
}

template <typename P, typename G>
__global__ void __launch_bounds__(kAdamThreads)
    adamw_kernel(P* __restrict__ p, const G* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v,
                 float* __restrict__ master, const float* __restrict__ scal,
                 long long n, int vec) {
  const Scal s{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5], scal[6]};
  const long long stride = (long long)gridDim.x * kAdamThreads;
  const long long t = (long long)blockIdx.x * kAdamThreads + threadIdx.x;
  const long long n4 = vec ? n / 4 : 0;
  for (long long i = t; i < n4; i += stride) {
    const long long e = i * 4;
    float gv[4], mv[4], vv[4], ma[4], out[4];
    load4v(g + e, gv);
    load4v(m + e, mv);
    load4v(v + e, vv);
    load4v(master + e, ma);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = adamw_one(gv[k], mv[k], vv[k], ma[k], s);
    store4v(m + e, mv);
    store4v(v + e, vv);
    store4v(master + e, ma);
    store4v(p + e, out);
  }
  for (long long e = n4 * 4 + t; e < n; e += stride) {
    float mv = m[e], vv = v[e], ma = master[e];
    const float out = adamw_one(pt::to_f(g[e]), mv, vv, ma, s);
    m[e] = mv;
    v[e] = vv;
    master[e] = ma;
    p[e] = pt::from_f<P>(out);
  }
}

template <typename P, typename G>
int launch(void* p, const void* g, float* m, float* v, float* master,
           const float* scal, long long n, int vec, int sms, cudaStream_t s) {
  if (n == 0) return 0;
  const long long work = vec ? (n + 3) / 4 : n;
  long long blocks = (work + kAdamThreads - 1) / kAdamThreads;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  adamw_kernel<P, G><<<(unsigned)blocks, kAdamThreads, 0, s>>>(
      static_cast<P*>(p), static_cast<const G*>(g), m, v, master, scal, n,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// p (p_dtype), g (g_dtype), m, v, master (fp32): n contiguous elements,
// updated in place; scal: 7 fp32 on the device (lr, b1, b2, eps, wd, bc1,
// bc2); vec = 1 when every buffer is 16-byte aligned.
extern "C" int pt_fused_adamw(int p_dtype, int g_dtype, void* p,
                              const void* g, float* m, float* v,
                              float* master, const float* scal, long long n,
                              int vec, int sms, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_dtype == pt::kF32 && g_dtype == pt::kF32)
    return launch<float, float>(p, g, m, v, master, scal, n, vec, sms, s);
  if (p_dtype == pt::kBF16 && g_dtype == pt::kBF16)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, g, m, v, master, scal, n,
                                                vec, sms, s);
  if (p_dtype == pt::kBF16 && g_dtype == pt::kF32)
    return launch<__nv_bfloat16, float>(p, g, m, v, master, scal, n, vec,
                                        sms, s);
  if (p_dtype == pt::kF32 && g_dtype == pt::kBF16)
    return launch<float, __nv_bfloat16>(p, g, m, v, master, scal, n, vec,
                                        sms, s);
  return (int)cudaErrorInvalidValue;
}
