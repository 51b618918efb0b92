// Forward flash attention (online softmax, GQA, causal, window, softcap)
// for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/flash_attention/kernel.py: flash_attention (_kernel).
//
// What it computes, for q (B,Sq,H,D), k/v (B,Sk,K,D), f32 inside:
//   q_pos = i + (causal ? Sk - Sq : 0),  k_pos = j
//   s     = scale * (q_i . k_j)                      [f32 sums]
//   s     = cap * tanh(s / cap)                      [when a cap is given]
//   valid = j < Sk && (!causal || k_pos <= q_pos)
//                  && (!window || k_pos > q_pos - window)
//   per key tile: m_new = max(m, max_j s, 0.1 * NEG_INF)   (masked guard)
//                 p = exp(s - m_new), corr = exp(m - m_new)
//                 l = l * corr + sum_j p,  acc = acc * corr + p . v
//   out   = acc / max(l, 1e-30), cast to q's dtype.
// Query head h reads kv head h / (H / K) directly: K and V are never
// repeated.  q, k and v are read through their (batch, seq, head) strides
// with the head dim contiguous, so no transpose copy is made; out is a
// contiguous (B,Sq,H,D).
//
// Three device kernels; the wrapper's plan (kernel.py: plan) picks one a
// call:
//
// 1. prefill, bf16, head dim 64/128/256 (flash_wgmma.cuh): wgmma on the
//    tensor cores fed by TMA, two warpgroups of 64 query rows, one thread
//    of which issues the loads (no producer warp); bound by operations
//    (4 * B * H * valid pairs * D flops against 989 TFLOP/s bf16).
// 2. decode and short Sq, bf16, head dim 64/128/256, G * Sq <= 16
//    (flash_decode.cuh): the G query heads of a kv head packed into the
//    rows of one mma.sync tile, so each K/V tile is read once, and the
//    keys split over blocks with a fixed-order merge pass when Sk is long;
//    bound by bytes (q, k, v in, out out at 3.35 TB/s).
// 3. float32 at every head dim, and bf16 at head dim 16/32: the CUDA-core
//    kernel below, f32 FMAs (the Pallas kernel's own arithmetic).  f32
//    stays off the tensor cores: there they would run TF32 (10-bit
//    mantissa), which cannot hold the 2e-4 tolerance the port keeps for
//    f32 against its plain version with TF32 off.  No model path calls it.
//
// A training call asks for each row's lse, the backward's input
// (flash_attention_bwd.cu): the prefill kernels (1 and 3) write it in
// their epilogue from the row's running max and sum, in natural log of
// the scaled (capped) scores, +inf for a row with no valid key; the
// decode kernel writes none, so the plan never gives it such a call.
//
// In bf16 the tensor-core kernels feed P to P.V as two bf16 terms,
// bf16(P) and bf16(P - bf16(P)), so P keeps ~16 bits; q * scale is never
// rounded: the scores stay unscaled in f32 and exp runs in base 2 on
// s c - m c in one fused multiply-add, c = scale * log2(e).  The details
// are in flash_wgmma.cuh and flash_decode.cuh.
//
// CUDA-core kernel layout: one block of 128 threads (256 at head dim 256)
// per (b, q head, tile of 32 query rows).  The block stages the scaled Q
// tile once and then walks tiles of 32 keys: K and V are loaded into
// shared memory as f32, each lane computes the score of one key against
// the warp's 8 rows, or 4 at head dim 256 (float4 reads, K rows padded by
// 4 floats so the lanes hit distinct banks), the softmax statistics of a
// row are reduced across the warp with butterfly shuffles, and the warp's
// probabilities go through shared memory to the P.V product, where each
// lane owns the head-dim columns lane, lane + 32, ...  Tiles that are
// fully masked for every row of the block (above the causal diagonal, or
// before the window) are skipped in all three kernels: under the guard
// they change neither m, l nor acc, so skipping them is exact.
//
// Determinism: every sum has a fixed order (per-lane FMAs in index order,
// butterfly shuffles, tensor-core tiles in order, split merges in split
// order), and no data goes through an atomic (the prefill kernel's one
// atomic counts releases of a shared-memory stage), so runs repeat bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_decode.cuh"
#include "flash_wgmma.cuh"

namespace {

constexpr int kBlockQ = 32;                       // query rows per block
constexpr int kBlockK = 32;                       // keys per tile, one a lane

// 4 warps of 8 rows up to head dim 128; 8 warps of 4 rows at 256, so the
// accumulator stays at 32 registers a lane (4 rows x 8 columns)
template <int D>
struct Shape {
  static constexpr int kWarps = D >= 256 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRowsPerWarp = kBlockQ / kWarps;  // warp + kWarps r
};
constexpr float kNegInf = -1e30f;
constexpr float kGuard = 0.1f * kNegInf;          // masked-block guard

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;                     // (B, H, Sq) f32 for the backward, or null
  int64_t sq, sk, h, kh;
  int64_t q_sb, q_ss, q_sh;                       // strides, in elements
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  float scale;
  int causal;
  int has_window;
  int64_t window;
  int has_cap;
  float cap;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kBlockQ * D + kBlockK * (D + 4) + kBlockK * D +
                          kBlockQ * kBlockK);
}

template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads)
flash_attention_kernel(const Params p) {
  static_assert(D % 4 == 0, "float4 reads need D % 4 == 0");
  constexpr int kThreads = Shape<D>::kThreads;
  constexpr int kWarps = Shape<D>::kWarps;
  constexpr int kRowsPerWarp = Shape<D>::kRowsPerWarp;
  constexpr int kStrideK = D + 4;                 // pad: distinct banks
  constexpr int kCols = (D + 31) / 32;            // head-dim columns a lane
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                              // [kBlockQ][D]
  float* k_s = q_s + kBlockQ * D;                 // [kBlockK][kStrideK]
  float* v_s = k_s + kBlockK * kStrideK;          // [kBlockK][D]
  float* p_s = v_s + kBlockK * D;                 // [kBlockQ][kBlockK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * kBlockQ;
  const int64_t hh = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const int64_t kvh = hh / (p.h / p.kh);
  const T* q = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  const int64_t off = p.causal ? p.sk - p.sq : 0;

  // the Q tile, upcast and scaled in f32; rows past Sq are zero
  for (int idx = tid; idx < kBlockQ * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int64_t row = q0 + r;
    q_s[idx] = row < p.sq ? to_f32(q[row * p.q_ss + d]) * p.scale : 0.0f;
  }

  // keys [k_lo, k_hi) hold every key valid for some row of this block
  const int64_t row_last = (q0 + kBlockQ < p.sq ? q0 + kBlockQ : p.sq) - 1;
  int64_t k_lo = 0, k_hi = p.sk;
  if (p.causal && row_last + off + 1 < k_hi) k_hi = row_last + off + 1;
  if (p.has_window && q0 + off - p.window + 1 > k_lo)
    k_lo = q0 + off - p.window + 1;

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  for (int64_t k0 = (k_lo / kBlockK) * kBlockK; k0 < k_hi; k0 += kBlockK) {
    __syncthreads();  // the last tile's K, V reads are done (Q is written)
    for (int idx = tid; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int64_t key = k0 + j;
      const bool in = key < p.sk;
      k_s[j * kStrideK + d] = in ? to_f32(k[key * p.k_ss + d]) : 0.0f;
      v_s[j * D + d] = in ? to_f32(v[key * p.v_ss + d]) : 0.0f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.0f;
    const float4* kr = reinterpret_cast<const float4*>(k_s + lane * kStrideK);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kv = kr[d4];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 qv = reinterpret_cast<const float4*>(
            q_s + (warp + kWarps * r) * D)[d4];
        s[r] = fmaf(qv.x, kv.x, s[r]);
        s[r] = fmaf(qv.y, kv.y, s[r]);
        s[r] = fmaf(qv.z, kv.z, s[r]);
        s[r] = fmaf(qv.w, kv.w, s[r]);
      }
    }

    const int64_t key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int i = warp + kWarps * r;
      const int64_t q_pos = q0 + i + off;
      float x = s[r];
      if (p.has_cap) x = p.cap * tanhf(x / p.cap);
      bool valid = key < p.sk;
      if (p.causal) valid = valid && key <= q_pos;
      if (p.has_window) valid = valid && key > q_pos - p.window;
      x = valid ? x : kNegInf;
      const float m_new = fmaxf(fmaxf(m[r], warp_max(x)), kGuard);
      const float pe = expf(x - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(pe);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
      m[r] = m_new;
      p_s[i * kBlockK + lane] = pe;
    }
    __syncwarp();  // a warp reads back only its own rows of P

    // acc[r][c] += sum_j p[i][j] * v[j][lane + 32 c]
#pragma unroll 2
    for (int j4 = 0; j4 < kBlockK / 4; ++j4) {
      float vv[4][kCols];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < D ? v_s[(4 * j4 + jj) * D + d] : 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float4 pv = reinterpret_cast<const float4*>(
            p_s + (warp + kWarps * r) * kBlockK)[j4];
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          acc[r][c] = fmaf(pv.x, vv[0][c], acc[r][c]);
          acc[r][c] = fmaf(pv.y, vv[1][c], acc[r][c]);
          acc[r][c] = fmaf(pv.z, vv[2][c], acc[r][c]);
          acc[r][c] = fmaf(pv.w, vv[3][c], acc[r][c]);
        }
      }
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int64_t row = q0 + warp + kWarps * r;
    if (row >= p.sq) continue;
    // the backward's lse (every lane holds the row's m and l): +inf for a
    // row that saw no valid key
    if (p.lse != nullptr && lane == 0)
      p.lse[(bb * p.h + hh) * p.sq + row] =
          l[r] > 0.0f ? m[r] + logf(l[r]) : __int_as_float(0x7f800000);
    const float den = fmaxf(l[r], 1e-30f);
    T* orow = o + ((bb * p.sq + row) * p.h + hh) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(orow + d, acc[r][c] / den);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, long long b, cudaStream_t stream) {
  // above 48 KB a block gets dynamic shared memory only after opting in;
  // done once per instance, at its first launch (never inside a capture
  // that is not preceded by a launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D>()));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((p.sq + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(p.h), static_cast<unsigned>(b));
  flash_attention_kernel<T, D>
      <<<grid, Shape<D>::kThreads, smem_bytes<D>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// f32 at every head dim; bf16 only where the tensor-core kernels do not
// reach (head dim 16, 32)
template <typename T>
int launch_dim(const Params& p, int head_dim, long long b,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, b, stream);
    case 32: return launch<T, 32>(p, b, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (head_dim) {
      case 64: return launch<T, 64>(p, b, stream);
      case 128: return launch<T, 128>(p, b, stream);
      case 256: return launch<T, 256>(p, b, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace

// Plain C entry points (bound with ctypes); strides are in elements.  Each
// launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (so a refused launch is seen) or a negative hopper::
// status code when a TMA descriptor cannot be made.
//
// With `lse` not null the prefill kernels also write each row's lse
// ((B, H, Sq) f32, natural log of the scaled scores, +inf for a row with
// no valid key), which the backward reads.
//
// The CUDA-core kernel: dtype 0 is float32, 1 is bfloat16 (head dim 16,
// 32).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int dtype,
    int head_dim, long long b, long long sq, long long sk, long long h,
    long long kh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int causal, int has_window,
    long long window, int has_cap, float cap, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kh <= 0 || h % kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    lse,   sq,     sk,         h,
           kh,   q_sb, q_ss, q_sh, k_sb,  k_ss,   k_sh,       v_sb,
           v_ss, v_sh, scale, causal, has_window, window, has_cap, cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(p, head_dim, b, s);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(p, head_dim, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core prefill kernel: bf16, head dim 64, 128 or 256; base and
// strides 16-byte aligned (the wrapper checks).
extern "C" int flash_attention_wgmma_launch(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int head_dim,
    long long b, long long sq, long long sk, long long h, long long kh,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, float scale, int causal, int has_window, long long window,
    int has_cap, float cap, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kh <= 0 || h % kh != 0 ||
      sq > INT32_MAX || sk > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  fa_wgmma::Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.sq = static_cast<int>(sq);
  p.sk = static_cast<int>(sk);
  p.h = static_cast<int>(h);
  p.kh = static_cast<int>(kh);
  p.to_log2 = has_cap ? kLog2e : scale * kLog2e;
  p.cap = cap;
  p.scale_over_cap = has_cap ? scale / cap : 0.0f;
  p.has_cap = has_cap;
  p.causal = causal;
  p.has_window = has_window;
  // a window past both lengths masks nothing more than none
  p.window = static_cast<int>(window < sq + sk ? window : sq + sk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return fa_wgmma::launch<64>(q, k, v, p, b, q_sb, q_ss, q_sh, k_sb, k_ss,
                                  k_sh, v_sb, v_ss, v_sh, s);
    case 128:
      return fa_wgmma::launch<128>(q, k, v, p, b, q_sb, q_ss, q_sh, k_sb,
                                   k_ss, k_sh, v_sb, v_ss, v_sh, s);
    case 256:
      return fa_wgmma::launch<256>(q, k, v, p, b, q_sb, q_ss, q_sh, k_sb,
                                   k_ss, k_sh, v_sb, v_ss, v_sh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The GQA-packed decode kernel: bf16, head dim 64, 128 or 256, (H / K) *
// Sq <= 16 rows; keys [k_lo, k_hi) in n_splits splits of `chunk` keys
// (the last one shorter).  With n_splits > 1, ws_acc (B, K, n_splits, 16,
// D) and ws_ml (B, K, n_splits, 16, 2) are f32 scratch and a merge kernel
// follows on the same stream.
extern "C" int flash_attention_decode_launch(
    const void* q, const void* k, const void* v, void* o, void* ws_acc,
    void* ws_ml, int head_dim, long long b, long long sq, long long sk,
    long long h, long long kh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int causal, int has_window,
    long long window, int has_cap, float cap, long long k_lo, long long k_hi,
    long long chunk, int n_splits, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kh <= 0 || h % kh != 0 ||
      sk > INT32_MAX || chunk <= 0 || k_lo < 0 || k_hi > sk ||
      k_lo + chunk * (n_splits - 1) >= k_hi ||
      (n_splits > 1 && (ws_acc == nullptr || ws_ml == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  fa_decode::Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.ws_acc = static_cast<float*>(ws_acc);
  p.ws_ml = static_cast<float*>(ws_ml);
  p.sq = static_cast<int>(sq);
  p.sk = static_cast<int>(sk);
  p.h = static_cast<int>(h);
  p.kh = static_cast<int>(kh);
  p.g = static_cast<int>(h / kh);
  p.rows = static_cast<int>(h / kh * sq);
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.to_log2 = has_cap ? kLog2e : scale * kLog2e;
  p.cap = cap;
  p.scale_over_cap = has_cap ? scale / cap : 0.0f;
  p.has_cap = has_cap;
  p.causal = causal;
  p.has_window = has_window;
  p.window = static_cast<int>(window < sq + sk ? window : sq + sk);
  p.k_lo = static_cast<int>(k_lo);
  p.k_hi = static_cast<int>(k_hi);
  p.chunk = static_cast<int>(chunk);
  p.n_splits = n_splits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return fa_decode::launch<64>(p, b, s);
    case 128: return fa_decode::launch<128>(p, b, s);
    case 256: return fa_decode::launch<256>(p, b, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
