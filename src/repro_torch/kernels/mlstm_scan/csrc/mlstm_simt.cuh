// CUDA-core helpers of the mLSTM kernels (mlstm_scan.cu's forward and
// mlstm_scan_bwd.cu's backward): conversions, warp reductions and the
// staging of a tile of (S, D) rows into shared memory as f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Stage rows [row0, row0 + kN) of a (S, D) operand (row stride `stride`,
// head dim contiguous) into shared memory as f32 times `scale`, rows past
// S as zeros.  With `vec` (every address 16-byte aligned) each thread
// issues its 16-byte loads in batches of kBatch before any store, so the
// loads of a batch are in flight together; otherwise one element a load.
template <typename T, int D, int kThreads, int kN = 32>
__device__ __forceinline__ void stage_rows(const T* src, int64_t stride,
                                           int64_t row0, int64_t s,
                                           float* dst, int dst_stride,
                                           float scale, bool vec, int tid) {
  constexpr int kVec = 16 / sizeof(T);            // elements a load
  constexpr int kRowVecs = D / kVec;
  constexpr int kVecs = kN * kRowVecs;
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
    for (int idx = tid; idx < kN * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const int64_t row = row0 + j;
      dst[j * dst_stride + d] =
          row < s ? to_f32(src[row * stride + d]) * scale : 0.0f;
    }
  }
}

}  // namespace
