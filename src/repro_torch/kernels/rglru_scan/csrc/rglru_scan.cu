// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/rglru_scan/kernel.py: rglru_scan_pallas (_kernel).
//
// What it computes, for a, b (B,S,W) f32 and h0 (B,W) f32 or null (zeros):
//   h_{-1} = h0[b, w]
//   h_t    = a[b,t,w] * h_{t-1} + b[b,t,w]         for t = 0 .. S-1
//   out[b,t,w] = h_t                                (f32)
// The product and the sum are rounded one at a time (__fmul_rn,
// __fadd_rn): nvcc would otherwise contract them into an FMA, which
// neither the Pallas kernel nor the plain version computes.
//
// Layout: one thread per (b, w) channel walks S in order, carrying h in a
// register, as the Pallas kernel carries it in VMEM across its sequential
// S axis.  Threads of a block take neighbouring channels, so every load
// and store of a time step is coalesced along W.  The time loop runs in
// steps of kUnroll: the step's kUnroll loads of a and b do not depend on
// h and are all issued before the dependent chain, so they are in flight
// together.
//
// Bound on this card: bytes.  a and b are read once and h written once,
// 12 bytes per element: 201 MB at recurrentgemma-9b's (1, 4096, 4096),
// 0.060 ms at 3.35 TB/s; two flops an element are nothing beside that.
// This first design is simple and right, not fast: B x W threads (4096 at
// that shape) fill a quarter of the SMs, each with one dependent chain,
// so the loads in flight are far fewer than the memory rate needs.  A
// chunked two-pass scan over S (local scans, then a carry pass) is the
// known next step.
//
// Determinism: each h is one fixed sequence of rounded operations, so
// runs repeat bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // channels a block: 64 blocks at W = 4096
constexpr int kUnroll = 16;    // time steps whose loads are in flight

__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ out,
                  int64_t s, int64_t w) {
  const int64_t ch = static_cast<int64_t>(blockIdx.x) * kThreads +
                     threadIdx.x;
  if (ch >= w) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * s * w + ch;
  const float* ap = a + base;
  const float* bp = b + base;
  float* op = out + base;
  float h = h0 != nullptr ? h0[static_cast<int64_t>(blockIdx.y) * w + ch]
                          : 0.0f;

  int64_t t = 0;
  for (; t + kUnroll <= s; t += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = __ldg(ap + (t + u) * w);
      bv[u] = __ldg(bp + (t + u) * w);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      op[(t + u) * w] = h;
    }
  }
  for (; t < s; ++t) {
    h = __fadd_rn(__fmul_rn(__ldg(ap + t * w), h), __ldg(bp + t * w));
    op[t * w] = h;
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  a, b, out are contiguous
// (B,S,W) f32, h0 a contiguous (B,W) f32 or null.  Launches on `stream`,
// does not synchronise, and returns cudaGetLastError() so a refused launch
// is seen.
extern "C" int rglru_scan_launch(const void* a, const void* b,
                                 const void* h0, void* out, long long bsz,
                                 long long s, long long w, void* stream) {
  if (bsz <= 0 || s <= 0 || w <= 0 || bsz > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(bsz));
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(out), s, w);
  return static_cast<int>(cudaGetLastError());
}
