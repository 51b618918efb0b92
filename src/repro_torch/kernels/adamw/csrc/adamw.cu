// AdamW for Hopper (sm_90a) in two passes: the grad norm's sum of squares
// in f64 with the clip factor, and the update of p, m and v in one read and
// one write of each.
//
// Replaces no Pallas kernel: the JAX package's AdamW
// (src/repro/optim/adamw.py: global_norm, adamw_update) is plain jnp, which
// XLA fuses on the TPU.  Eager PyTorch ran the same formula as ~26 launches
// of f32 elementwise ops on each flat slice of 2^26 elements
// (optim/adamw.py: _update_slice, global_norm), each reading and writing
// whole f32 slices.
//
// What it computes, for each leaf (p, g, m, v) of n elements:
//   norm:   partial[b] = sum over block b's elements of (double)g^2
//   final:  gnorm = (float)sqrt(sum of partials in index order)
//           clip  = min(max(gnorm, 1e-9)^-1 * grad_clip, 1)   (NaN kept)
//   update: gc = g * clip
//           m' = b1 * m + (1 - b1) * gc
//           v' = b2 * v + (1 - b2) * gc^2
//           step = (m' / c1) / (sqrt(v' / c2) + eps) + wd * p
//           p' = p - lr * step
// clip, c1, c2 and lr are read from 0-dim f32 device tensors, so the host
// never waits for them.  Every operation is rounded to f32 on its own, in
// the order of the eager ops (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn,
// __fsqrt_rn: nvcc contracts no multiply-add into an FMA), with the
// constants the eager ops use: each Python float rounded to f32 once,
// (float)(1 - b1) computed in double.  "grad_clip / x" is torch's
// reciprocal(x) * grad_clip (Tensor.__rtruediv__).  p, m and v are rounded
// to their dtypes once, to nearest even; bf16 inputs widen exactly.  So the
// update equals the eager slices bit for bit, and 0 stays 0 (the padded
// heads' slots).  The norm sums in another order than torch.sum's tree:
// within an ulp of f32 after the root, and the same bits every run (a
// fixed grid for a given n and SM count, a fixed reduction tree, no
// atomics).  f64 keeps the norm finite where an f32 sum of squares
// overflows (C-ref13).
//
// Bound on this card: bytes.  The update reads p (bf16, 2 B), g, m, v (f32,
// 4 B each) and writes p, m, v: 24 B a parameter, 101 GB for chatglm3-6b at
// 18 layers (4.20 B parameters), 30 ms at 3.35 TB/s; the norm reads g once,
// 4 B a parameter, 5 ms.  Design: one grid-stride pass a leaf, at most 4
// blocks of 256 threads an SM, each thread taking 8 elements a step with
// 16-byte loads and stores (two of f32, one of bf16) when every base is
// 16-byte aligned, else one element a step; 64-bit indices (a leaf of
// grok-1 has 1.61 B elements).  Nothing is written to device memory but
// p, m, v and the norm's one double a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kThreads = 256;       // threads a block of either pass
constexpr int kVec = 8;             // elements a thread takes a step
constexpr int kFinalThreads = 1024; // the final sum's one block

// the dtype codes of the C entry points
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// kVec elements from a 16-byte aligned address, widened to f32
__device__ __forceinline__ void load_vec(const float* x, float* out) {
  const float4 a = reinterpret_cast<const float4*>(x)[0];
  const float4 b = reinterpret_cast<const float4*>(x)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* x, float* out) {
  const uint4 a = *reinterpret_cast<const uint4*>(x);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// kVec f32 values to a 16-byte aligned address, each rounded to the dtype
__device__ __forceinline__ void store_vec(float* x, const float* in) {
  reinterpret_cast<float4*>(x)[0] = make_float4(in[0], in[1], in[2], in[3]);
  reinterpret_cast<float4*>(x)[1] = make_float4(in[4], in[5], in[6], in[7]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* x, const float* in) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
  *reinterpret_cast<uint4*>(x) = a;
}

// a block's double sum in a fixed order: each warp's by shuffles, then the
// warps' in index order by thread 0 (the only thread whose value counts)
template <int kBlock>
__device__ __forceinline__ double block_sum(double x) {
  __shared__ double warp_sums[kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kBlock / 32; ++w) total += warp_sums[w];
  return total;
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
    adamw_sumsq_kernel(const G* __restrict__ g, long long n, int vec,
                       double* __restrict__ partial) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  double acc = 0.0;
  long long done = 0;
  if (vec) {
    const long long groups = n / kVec;
    for (long long i = first; i < groups; i += stride) {
      float x[kVec];
      load_vec(g + i * kVec, x);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const double d = x[e];
        acc += d * d;           // exact product: fused or not, the same sum
      }
    }
    done = groups * kVec;
  }
  for (long long i = done + first; i < n; i += stride) {
    const double d = widen(g[i]);
    acc += d * d;
  }
  const double total = block_sum<kThreads>(acc);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kFinalThreads)
    adamw_norm_final_kernel(const double* __restrict__ partial,
                            long long count, float grad_clip,
                            float* __restrict__ gnorm,
                            float* __restrict__ clip) {
  double acc = 0.0;
  for (long long i = threadIdx.x; i < count; i += kFinalThreads)
    acc += partial[i];
  const double total = block_sum<kFinalThreads>(acc);
  if (threadIdx.x != 0) return;
  const float gn = __double2float_rn(sqrt(total));
  *gnorm = gn;
  // torch.clamp(gnorm, min=1e-9), then grad_clip / that as reciprocal and
  // multiply, then torch.clamp(max=1): clamp keeps a NaN
  const float lo = static_cast<float>(1e-9);
  const float x = isnan(gn) ? gn : fmaxf(gn, lo);
  const float c = __fmul_rn(__fdiv_rn(1.0f, x), grad_clip);
  *clip = isnan(c) ? c : fminf(c, 1.0f);
}

struct Coef {
  float b1, one_minus_b1, b2, one_minus_b2, eps, wd;
};

// one element, in the eager ops' order and rounding
__device__ __forceinline__ void adamw_one(float& p, float g, float& m,
                                          float& v, float clip, float c1,
                                          float c2, float lr,
                                          const Coef& k) {
  const float gc = __fmul_rn(g, clip);
  const float mn =
      __fadd_rn(__fmul_rn(k.b1, m), __fmul_rn(k.one_minus_b1, gc));
  const float vn = __fadd_rn(__fmul_rn(k.b2, v),
                             __fmul_rn(k.one_minus_b2, __fmul_rn(gc, gc)));
  const float mhat = __fdiv_rn(mn, c1);
  const float vhat = __fdiv_rn(vn, c2);
  float step = __fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), k.eps));
  step = __fadd_rn(step, __fmul_rn(k.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, step));
  m = mn;
  v = vn;
}

template <typename P, typename G, typename M>
__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(P* __restrict__ p, const G* __restrict__ g,
                        M* __restrict__ m, M* __restrict__ v, long long n,
                        int vec, const float* __restrict__ clip_p,
                        const float* __restrict__ c1_p,
                        const float* __restrict__ c2_p,
                        const float* __restrict__ lr_p, Coef k) {
  const float clip = *clip_p, c1 = *c1_p, c2 = *c2_p, lr = *lr_p;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long groups = n / kVec;
    for (long long i = first; i < groups; i += stride) {
      float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
      load_vec(p + i * kVec, pf);
      load_vec(g + i * kVec, gf);
      load_vec(m + i * kVec, mf);
      load_vec(v + i * kVec, vf);
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        adamw_one(pf[e], gf[e], mf[e], vf[e], clip, c1, c2, lr, k);
      store_vec(p + i * kVec, pf);
      store_vec(m + i * kVec, mf);
      store_vec(v + i * kVec, vf);
    }
    done = groups * kVec;
  }
  for (long long i = done + first; i < n; i += stride) {
    float pf = widen(p[i]), mf = widen(m[i]), vf = widen(v[i]);
    adamw_one(pf, widen(g[i]), mf, vf, clip, c1, c2, lr, k);
    p[i] = narrow<P>(pf);
    m[i] = narrow<M>(mf);
    v[i] = narrow<M>(vf);
  }
}

bool bad_launch(long long n, int blocks, int vec, const void* a,
                const void* b = nullptr, const void* c = nullptr,
                const void* d = nullptr) {
  if (n <= 0 || blocks <= 0) return true;
  if (!vec) return false;
  for (const void* x : {a, b, c, d})
    if (x != nullptr && reinterpret_cast<uintptr_t>(x) % 16 != 0) return true;
  return false;
}

template <typename P, typename G, typename M>
int launch_update(void* p, const void* g, void* m, void* v, long long n,
                  int blocks, int vec, const void* clip, const void* c1,
                  const void* c2, const void* lr, const Coef& k,
                  cudaStream_t st) {
  adamw_update_kernel<P, G, M><<<blocks, kThreads, 0, st>>>(
      static_cast<P*>(p), static_cast<const G*>(g), static_cast<M*>(m),
      static_cast<M*>(v), n, vec, static_cast<const float*>(clip),
      static_cast<const float*>(c1), static_cast<const float*>(c2),
      static_cast<const float*>(lr), k);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, typename G>
int launch_update_m(int m_dtype, void* p, const void* g, void* m, void* v,
                    long long n, int blocks, int vec, const void* clip,
                    const void* c1, const void* c2, const void* lr,
                    const Coef& k, cudaStream_t st) {
  if (m_dtype == kF32)
    return launch_update<P, G, float>(p, g, m, v, n, blocks, vec, clip, c1,
                                      c2, lr, k, st);
  return launch_update<P, G, __nv_bfloat16>(p, g, m, v, n, blocks, vec, clip,
                                            c1, c2, lr, k, st);
}

template <typename P>
int launch_update_g(int g_dtype, int m_dtype, void* p, const void* g,
                    void* m, void* v, long long n, int blocks, int vec,
                    const void* clip, const void* c1, const void* c2,
                    const void* lr, const Coef& k, cudaStream_t st) {
  if (g_dtype == kF32)
    return launch_update_m<P, float>(m_dtype, p, g, m, v, n, blocks, vec,
                                     clip, c1, c2, lr, k, st);
  return launch_update_m<P, __nv_bfloat16>(m_dtype, p, g, m, v, n, blocks,
                                           vec, clip, c1, c2, lr, k, st);
}

bool bad_dtype(int x) { return x != kF32 && x != kBF16; }

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream`,
// does not synchronise, and returns cudaGetLastError() so that a refused
// launch is seen; dtypes are 0 for f32 and 1 for bf16; vec (1) needs every
// base 16-byte aligned.

// The sum of squares of g's n elements (contiguous), one double a block
// into partial[0 .. blocks).
extern "C" int adamw_sumsq_launch(const void* g, int g_dtype, long long n,
                                  int blocks, int vec, void* partial,
                                  void* stream) {
  if (bad_dtype(g_dtype) || partial == nullptr ||
      bad_launch(n, blocks, vec, g))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  double* out = static_cast<double*>(partial);
  if (g_dtype == kF32)
    adamw_sumsq_kernel<float>
        <<<blocks, kThreads, 0, st>>>(static_cast<const float*>(g), n, vec,
                                      out);
  else
    adamw_sumsq_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), n, vec, out);
  return static_cast<int>(cudaGetLastError());
}

// The norm (0-dim f32 gnorm) from `count` partials summed in index order,
// and the clip factor (0-dim f32 clip) for grad_clip.
extern "C" int adamw_norm_final_launch(const void* partial, long long count,
                                       float grad_clip, void* gnorm,
                                       void* clip, void* stream) {
  if (count < 0 || (count > 0 && partial == nullptr) || gnorm == nullptr ||
      clip == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  adamw_norm_final_kernel<<<1, kFinalThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(partial), count, grad_clip,
      static_cast<float*>(gnorm), static_cast<float*>(clip));
  return static_cast<int>(cudaGetLastError());
}

// The update of one leaf in place: p (p_dtype), g (g_dtype), m and v
// (m_dtype), n elements each, contiguous; clip, c1, c2, lr 0-dim f32.
extern "C" int adamw_update_launch(void* p, int p_dtype, const void* g,
                                   int g_dtype, void* m, void* v,
                                   int m_dtype, long long n, int blocks,
                                   int vec, const void* clip, const void* c1,
                                   const void* c2, const void* lr, float b1,
                                   float one_minus_b1, float b2,
                                   float one_minus_b2, float eps, float wd,
                                   void* stream) {
  if (bad_dtype(p_dtype) || bad_dtype(g_dtype) || bad_dtype(m_dtype) ||
      clip == nullptr || c1 == nullptr || c2 == nullptr || lr == nullptr ||
      bad_launch(n, blocks, vec, p, g, m, v))
    return static_cast<int>(cudaErrorInvalidValue);
  const Coef k{b1, one_minus_b1, b2, one_minus_b2, eps, wd};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p_dtype == kF32)
    return launch_update_g<float>(g_dtype, m_dtype, p, g, m, v, n, blocks,
                                  vec, clip, c1, c2, lr, k, st);
  return launch_update_g<__nv_bfloat16>(g_dtype, m_dtype, p, g, m, v, n,
                                        blocks, vec, clip, c1, c2, lr, k,
                                        st);
}
