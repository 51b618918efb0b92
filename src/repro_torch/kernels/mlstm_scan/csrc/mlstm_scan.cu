// Chunkwise-parallel mLSTM (xLSTM matrix memory) forward for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/mlstm_scan/kernel.py: mlstm_pallas (_kernel), with two
// device kernels; kernel.py's plan picks one per call:
//   - mlstm_wgmma.cuh: bf16 at head dim 512 (xlstm-350m), on the tensor
//     cores, its own notes there;
//   - mlstm_kernel below: f32, and bf16 at the other head dims, on the
//     CUDA cores.  The rest of this note is about it.
//
// What it computes, for q, k, v (B,S,H,D) and F = cumsum(log f), log_i
// (B,S,H) f32 (the wrapper forms F, as the Pallas wrapper does), f32
// inside:
//   for query row t and key s <= t (s < S):
//     logw  = F_t - F_s + i_s                        [the gate part]
//     sc    = (f32(q_t) * D^-1/2) . f32(k_s)         [f32 products and sums]
//   per key tile: m_new = max(m, max_s logw, 0.1 * NEG)   (masked guard)
//                 w = exp(logw - m_new), corr = exp(m - m_new)
//                 a = w * sc
//                 den = den * corr + sum_s a,  acc = acc * corr + a . v
//   out_t = acc / max(|den|, exp(-m)), cast to q's dtype.
// The running max m covers the gate part only, not the dot products (the
// paper's stabiliser), exactly as the Pallas kernel.  q, k and v are read
// through their (batch, seq, head) strides with the head dim contiguous,
// so no transpose copy is made; out is a contiguous (B,S,H,D).
//
// Layout, after csrc/flash_attention.cu: one block per (b, head, tile of
// 32 query rows), walking tiles of 32 keys.  K and V are staged in shared
// memory as f32 (16-byte loads, each thread's batch issued before any of
// its stores, so they are in flight together); each lane computes the
// score of one key against its warp's rows (float4 reads, K rows padded
// by 4 floats so the lanes hit distinct banks); the gate statistics of a
// row are reduced across the warp with butterfly shuffles; the warp's
// weights go through shared memory to the a.V product, where each lane
// owns the head-dim columns lane, lane + 32, ...  Tiles above the causal
// diagonal are skipped: for every row they would give w = 0 and corr = 1
// once m is past the guard, and row t always sees key t, so skipping them
// is exact.  Query tiles run heaviest first (the last rows see the most
// keys).
//
// Head dim 512 (xlstm-350m: inner 2048 over 4 heads) sets the design: the
// f32 tiles take 201.6 KB of shared memory (one block an SM, after the
// opt-in above 48 KB), and the block has 8 warps of 4 rows each, so the
// accumulator is 4 rows x 16 columns = 64 registers a lane.  Smaller
// head dims keep 4 warps of 8 rows.
//
// Bound on this card: operations.  4 flops per valid (query, key, head,
// dim): 17.2 GFLOP at xlstm-350m's (1, 2048, 4, 512), 0.0174 ms at 989
// TFLOP/s bf16, against 33.6 MB of q, k, v, out and gates (0.010 ms at
// 3.35 TB/s).  This kernel is simple and right, not fast: the products
// run on the CUDA cores in f32 (the Pallas kernel's own arithmetic); the
// bf16 calls at head dim 512 take the tensor-core kernel, so bf16 has no
// instance of this kernel at 512.
//
// Determinism: every sum has a fixed order (per-lane FMAs in index order,
// butterfly shuffles), no atomics, so runs repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <initializer_list>
#include <type_traits>

#include "mlstm_wgmma.cuh"

namespace {

constexpr int kBlockQ = 32;                       // query rows per block
constexpr int kBlockK = 32;                       // keys per tile, one a lane
constexpr float kNeg = -1e30f;
constexpr float kGuard = 0.1f * kNeg;             // masked-block guard

template <int D>
struct Shape {
  static constexpr int kWarps = D >= 256 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = kBlockQ / kWarps;  // rows warp + kWarps * r
  static constexpr int kCols = (D + 31) / 32;     // head-dim columns a lane
  static constexpr int kKeyStep = kCols >= 8 ? 2 : 4;  // keys per a.V step
  static constexpr int kStrideK = D + 4;          // pad: distinct banks
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kBlockQ * D + kBlockK * kStrideK + kBlockK * D +
                       kBlockQ * kBlockK + kBlockQ + 2 * kBlockK);
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* f;                                 // cumsum(log f), (B,S,H)
  const float* li;                                // log i, (B,S,H)
  void* o;
  int64_t s, h;
  int64_t q_sb, q_ss, q_sh;                       // strides, in elements
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t f_sb, f_ss;                             // of f and li; head: 1
  float scale;
  bool vec;                                       // 16-byte loads of q, k, v
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

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& u, float* out, float) {
  const float4 v = *reinterpret_cast<const float4*>(&u);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void unpack(const uint4& u, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stage rows [row0, row0 + 32) of a (S, D) operand (row stride `stride`,
// head dim contiguous) into shared memory as f32 times `scale`, rows past
// S as zeros.  With `vec` (every address 16-byte aligned) each thread
// issues its 16-byte loads in batches of kBatch before any store, so the
// loads of a batch are in flight together; otherwise one element a load.
template <typename T, int D, int kThreads>
__device__ __forceinline__ void stage_rows(const T* src, int64_t stride,
                                           int64_t row0, int64_t s,
                                           float* dst, int dst_stride,
                                           float scale, bool vec, int tid) {
  constexpr int kVec = 16 / sizeof(T);            // elements a load
  constexpr int kRowVecs = D / kVec;
  constexpr int kVecs = 32 * kRowVecs;
  constexpr int kBatch = 8;
  if (vec) {
#pragma unroll
    for (int v0 = 0; v0 < kVecs; v0 += kBatch * kThreads) {
      uint4 buf[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = v0 + u * kThreads + tid;
        const int64_t row = row0 + idx / kRowVecs;
        buf[u] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < kVecs && row < s)
          buf[u] = __ldg(reinterpret_cast<const uint4*>(
              src + row * stride + (idx % kRowVecs) * kVec));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int idx = v0 + u * kThreads + tid;
        if (idx >= kVecs) continue;
        float f[kVec];
        unpack(buf[u], f, T());
        float* out = dst + (idx / kRowVecs) * dst_stride +
                     (idx % kRowVecs) * kVec;
#pragma unroll
        for (int e = 0; e < kVec; e += 4)
          *reinterpret_cast<float4*>(out + e) =
              make_float4(f[e] * scale, f[e + 1] * scale, f[e + 2] * scale,
                          f[e + 3] * scale);
      }
    }
  } else {
    for (int idx = tid; idx < 32 * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int64_t row = row0 + j;
      dst[j * dst_stride + d] =
          row < s ? to_f32(src[row * stride + d]) * scale : 0.0f;
    }
  }
}

// one block an SM is enough at every instance: ptxas may then use up to
// 255 registers a thread rather than spill
template <typename T, int D>
__global__ void __launch_bounds__(Shape<D>::kThreads, 1)
mlstm_kernel(const Params p) {
  using S = Shape<D>;
  static_assert(D % 4 == 0, "float4 reads need D % 4 == 0");
  constexpr int kWarps = S::kWarps, kRows = S::kRows, kCols = S::kCols;
  constexpr int kStrideK = S::kStrideK, kKeyStep = S::kKeyStep;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                              // [kBlockQ][D]
  float* k_s = q_s + kBlockQ * D;                 // [kBlockK][kStrideK]
  float* v_s = k_s + kBlockK * kStrideK;          // [kBlockK][D]
  float* p_s = v_s + kBlockK * D;                 // [kBlockQ][kBlockK]
  float* fq_s = p_s + kBlockQ * kBlockK;          // [kBlockQ]
  float* fk_s = fq_s + kBlockQ;                   // [kBlockK]
  float* ik_s = fk_s + kBlockK;                   // [kBlockK]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // heaviest query tiles first
  const int64_t q0 =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const int64_t hh = blockIdx.y;
  const int64_t bb = blockIdx.z;
  const T* q = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  const float* f = p.f + bb * p.f_sb + hh;
  const float* li = p.li + bb * p.f_sb + hh;

  // the Q tile, upcast and scaled in f32, and its F; rows past S are zero
  stage_rows<T, D, S::kThreads>(q, p.q_ss, q0, p.s, q_s, D, p.scale, p.vec,
                                tid);
  for (int r = tid; r < kBlockQ; r += S::kThreads)
    fq_s[r] = q0 + r < p.s ? f[(q0 + r) * p.f_ss] : 0.0f;

  // keys [0, k_hi) hold every key valid for some row of this block
  const int64_t row_last = (q0 + kBlockQ < p.s ? q0 + kBlockQ : p.s) - 1;
  const int64_t k_hi = row_last + 1;

  float m[kRows], den[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNeg;
    den[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < k_hi; k0 += kBlockK) {
    __syncthreads();  // the last tile's reads are done (Q is written)
    stage_rows<T, D, S::kThreads>(k, p.k_ss, k0, p.s, k_s, kStrideK, 1.0f,
                                  p.vec, tid);
    stage_rows<T, D, S::kThreads>(v, p.v_ss, k0, p.s, v_s, D, 1.0f, p.vec,
                                  tid);
    for (int j = tid; j < kBlockK; j += S::kThreads) {
      const bool in = k0 + j < p.s;
      fk_s[j] = in ? f[(k0 + j) * p.f_ss] : 0.0f;
      ik_s[j] = in ? li[(k0 + j) * p.f_ss] : 0.0f;
    }
    __syncthreads();

    // scores of key k0 + lane against the warp's rows
    float sc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r] = 0.0f;
    const float4* kr = reinterpret_cast<const float4*>(k_s + lane * kStrideK);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kv = kr[d4];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = reinterpret_cast<const float4*>(
            q_s + (warp + kWarps * r) * D)[d4];
        sc[r] = fmaf(qv.x, kv.x, sc[r]);
        sc[r] = fmaf(qv.y, kv.y, sc[r]);
        sc[r] = fmaf(qv.z, kv.z, sc[r]);
        sc[r] = fmaf(qv.w, kv.w, sc[r]);
      }
    }

    const int64_t key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = warp + kWarps * r;
      const int64_t q_pos = q0 + i;
      const bool valid = key < p.s && key <= q_pos;
      const float logw =
          valid ? (fq_s[i] - fk_s[lane]) + ik_s[lane] : kNeg;
      const float m_new = fmaxf(fmaxf(m[r], warp_max(logw)), kGuard);
      const float a = expf(logw - m_new) * sc[r];
      const float corr = expf(m[r] - m_new);
      den[r] = den[r] * corr + warp_sum(a);
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
      m[r] = m_new;
      p_s[i * kBlockK + lane] = a;
    }
    __syncwarp();  // a warp reads back only its own rows of a

    // acc[r][c] += sum_j a[i][j] * v[j][lane + 32 c]
#pragma unroll 2
    for (int j0 = 0; j0 < kBlockK; j0 += kKeyStep) {
      float vv[kKeyStep][kCols];
#pragma unroll
      for (int jj = 0; jj < kKeyStep; ++jj) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const int d = lane + 32 * c;
          vv[jj][c] = d < D ? v_s[(j0 + jj) * D + d] : 0.0f;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float* pr = p_s + (warp + kWarps * r) * kBlockK + j0;
#pragma unroll
        for (int jj = 0; jj < kKeyStep; ++jj) {
          const float pj = pr[jj];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[r][c] = fmaf(pj, vv[jj][c], acc[r][c]);
        }
      }
    }
  }

  T* o = static_cast<T*>(p.o);
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t row = q0 + warp + kWarps * r;
    if (row >= p.s) continue;
    const float norm = fmaxf(fabsf(den[r]), expf(-m[r]));
    T* orow = o + ((bb * p.s + row) * p.h + hh) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(orow + d, acc[r][c] / norm);
    }
  }
}

template <typename T, int D>
int launch(const Params& p, long long b, cudaStream_t stream) {
  using S = Shape<D>;
  // above 48 KB a block gets dynamic shared memory only after opting in;
  // done once per instance, at its first launch (never inside a capture
  // that is not preceded by a launch)
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(S::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((p.s + kBlockQ - 1) / kBlockQ),
                  static_cast<unsigned>(p.h), static_cast<unsigned>(b));
  mlstm_kernel<T, D><<<grid, S::kThreads, S::kSmemBytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Params& p, int head_dim, long long b,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, b, stream);
    case 32: return launch<T, 32>(p, b, stream);
    case 64: return launch<T, 64>(p, b, stream);
    case 512:
      // bf16 at 512 is the tensor-core kernel's (kernel.py's plan)
      if constexpr (std::is_same_v<T, float>)
        return launch<T, 512>(p, b, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype 0 is float32, 1 is
// bfloat16 (q, k, v, out; f and li are float32 with a contiguous head
// axis); strides are in elements; scale is D^-1/2.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() so a refused launch
// is seen.
extern "C" int mlstm_launch(
    const void* q, const void* k, const void* v, const void* f,
    const void* li, void* o, int dtype, int head_dim, long long b,
    long long s, long long h, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long f_sb, long long f_ss,
    float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads need every row start aligned: the base pointers and
  // every stride a whole number of 16-byte vectors
  const long long vec_elems = dtype == 1 ? 8 : 4;
  bool vec = true;
  for (const void* ptr : {q, k, v})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long st : {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh})
    vec = vec && st % vec_elems == 0;
  Params p{q,    k,    v,    static_cast<const float*>(f),
           static_cast<const float*>(li),   o,    s,    h,
           q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
           f_sb, f_ss, scale, vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(p, head_dim, b, st);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(p, head_dim, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core kernel: bf16 q, k, v at head dim 512 (base and strides
// 16-byte aligned, which the wrapper checks), keys split into chunks of
// `chunk_tiles` tiles of 32 (kernel.py's plan).  lf and li are log f and
// log i (B, S, H) f32 with the strides f_sb, f_ss and a contiguous head
// axis (the kernel forms F itself); gates is f32 scratch (3, B * H, S
// rounded up to 64); scale is D^-1/2.  `items` (the blocks per (b, h))
// and `split_tiles` are the plan's counts, which size the grid and the
// split counters; with split tiles, ws (split_items * B * H, 64, 512) and
// ws_den (split_items * B * H, 256, 2) are f32 scratch and done
// (split_tiles * B * H) int32 scratch, sized by the plan.  Two launches on
// `stream`: the gate planes, then the product.
extern "C" int mlstm_wgmma_launch(
    const void* q, const void* k, const void* v, const void* lf,
    const void* li, void* o, void* gates, void* ws, void* ws_den,
    void* done, int head_dim, long long b, long long s, long long h,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long f_sb, long long f_ss, float scale,
    int chunk_tiles, long long items, long long split_tiles, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || s > 64LL * 65535 ||
      b * h > INT32_MAX || chunk_tiles <= 0 || head_dim != 512 ||
      gates == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (items <= 0 || split_tiles < 0 || items * b * h > INT32_MAX ||
      (split_tiles > 0 &&
       (ws == nullptr || ws_den == nullptr || done == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  mlstm_wgmma::Params p;
  p.gates = static_cast<const float*>(gates);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.ws = static_cast<float*>(ws);
  p.ws_den = static_cast<float*>(ws_den);
  p.done = static_cast<int*>(done);
  p.s = static_cast<int>(s);
  p.h = static_cast<int>(h);
  p.bh = static_cast<int>(b * h);
  p.sp = static_cast<int>((s + 63) / 64 * 64);
  p.chunk_tiles = chunk_tiles;
  return mlstm_wgmma::launch<512>(
      q, k, v, static_cast<const float*>(lf), static_cast<const float*>(li),
      f_sb, f_ss, std::log2(scale), static_cast<float*>(gates), p, b, q_sb,
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, items,
      static_cast<int>(split_tiles * b * h),
      static_cast<cudaStream_t>(stream));
}
