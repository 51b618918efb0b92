// Fused event filter + calibration + per-event reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of the JAX package,
// src/repro/kernels/event_filter/kernel.py:
//   event_filter_batch_kernel  <- event_filter_batch_pallas (_batch_kernel),
//                                 the K-query shared scan;
//   the single-query wrapper   <- event_filter_pallas (_kernel), launched as
//                                 the same kernel with K = 1.
//
// What it computes, per event e (one thread block per event):
//   pt_t   = calib_iters rounds of pt *= 1 + 0.01*tanh(pt)*rsqrt(1 + pt*pt)
//            over the valid tracks t < min(n_tracks[e], T);
//   cnt_k  = #(pt_t > B_k)        (int32, exact and order-free)
//   sum    = sum_t pt_t           (fixed-shape tree, deterministic)
//   mask[e,k] = sc[var_idx_k] > A_k && cnt_k >= C_k && (!(D_k > 0) || sum < D_k)
//   var[e]    = scalars[e, 0]
//
// Only column 0 of each track is loaded.  The calibration correction of an
// element depends only on that element and on pt, and the TPU kernel reads
// nothing but trk[..., 0] after calibrating (kernel.py:101-118), so
// calibrating pt alone gives the TPU kernel's pt exactly.  Each step is
// rounded on its own (__fmul_rn/__fadd_rn stop nvcc from contracting into
// FMAs), in the operation order of the plain PyTorch version, and the build
// does not use --use_fast_math, so tanhf and rsqrtf are the same functions
// PyTorch's CUDA kernels call.
//
// Bound on this card: memory.  The work per track is a compare per query and
// one add (plus ~10 flops per calibration round), far below the H100's
// 67 TFLOP/s fp32; the bytes that must move are the valid tracks' pt
// (4 B each), n_tracks, scalars and the outputs, read or written once, at
// 3.35 TB/s.  The pt load is strided by V floats, so each 4-byte pt costs a
// 32-byte sector (the store's layout; a contiguous pt plane beside each
// brick would cut that by 8).
//
// Design for latency: one block per event, of `threads` threads (128, 256
// or 512, a launch argument; 512 unless the caller's launch-shape sweep,
// kernels/event_filter/tune.py, picked another).  Each thread issues all
// its loads of pt for up to kPer = 8 tracks (tid, tid + threads, ...)
// before it uses any of them, so at 512 threads an event of up to 4096
// tracks (the store's width) costs one round trip to device memory, not
// one per block-wide row of tracks, and a longer one a round trip per
// 4096 (at 128 threads, one per 1024 tracks); the loads of the query
// operands of the final compare (thresholds, var_idx, the selected
// scalar) are issued at the start too.
// Each pt is a 128-byte line of its own to the SM's L1, which takes lines
// one at a time: 512 threads (more warps with lines in flight) beat 256
// on an H100 at the query path's chunk, and the loads allocate no line in
// L1.  The block size is a runtime value of the one kernel instance: the
// loop stride and the warp count follow blockDim.x, and the sum's tree
// has one leaf a thread, so its order (and a sum's last bits) depends on
// the block size, never on the run.  Calibration, the sum and the K
// counts then run on registers: each thread counts its own hits of query
// k, the warp adds them (__reduce_add_sync) and lane 0 adds the warp's
// count to shared memory.
// Spreading an event over two or four blocks (a cluster whose block 0 adds
// the others' counts and sums through distributed shared memory) measured
// no faster on an H100 at the query path's 64 events: the combine cost
// what the spread saved.
//
// Determinism: counts are int32 (per-thread counts, integer warp sums and
// shared-memory integer atomics), the sum is a fixed-shape tree (each
// thread in track order, warp shuffles, then shared memory) with no float
// atomics, so results are identical from run to run.  Offsets are 64-bit:
// a full-width slab of 8192 events holds ~2.1e9 track elements, more than
// INT32_MAX.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;  // the largest block size a launch takes
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kPer = 8;  // tracks a thread loads before it uses any

// a read-only load that leaves no line in L1: no pt is read twice, and
// the SM's L1 takes each pt's line on its own
__device__ __forceinline__ float load_no_allocate(const float* p) {
  float x;
  asm volatile("ld.global.nc.L1::no_allocate.f32 %0, [%1];"
               : "=f"(x)
               : "l"(p));
  return x;
}

__device__ __forceinline__ float calibrate_pt(float pt, int iters) {
  for (int i = 0; i < iters; ++i) {
    // corr = 1.0 + 0.01 * tanh(pt) * rsqrt(1.0 + pt * pt), op by op
    const float r = rsqrtf(__fadd_rn(1.0f, __fmul_rn(pt, pt)));
    const float corr =
        __fadd_rn(1.0f, __fmul_rn(__fmul_rn(0.01f, tanhf(pt)), r));
    pt = __fmul_rn(pt, corr);
  }
  return pt;
}

// the final compare of query j: sc[var_idx_j] > A_j, with an index outside
// the event's scalars selecting nothing (the kernel never reads past the
// row; the host builds var_idx in range)
__device__ __forceinline__ bool scalar_pass(const float* sc,
                                            const float* thresholds,
                                            const int32_t* var_idx,
                                            int64_t n_scalars, int j) {
  const int vi = var_idx[j];
  return vi >= 0 && vi < n_scalars && sc[vi] > thresholds[j];
}

__global__ void __launch_bounds__(kMaxThreads)
event_filter_batch_kernel(const float* __restrict__ scalars,
                          const float* __restrict__ tracks,
                          const int32_t* __restrict__ n_tracks,
                          const float* __restrict__ thresholds,  // (4, K)
                          const int32_t* __restrict__ var_idx,   // (K,)
                          float* __restrict__ mask,              // (N, K)
                          float* __restrict__ var,               // (N,)
                          int64_t n_scalars, int64_t max_tracks,
                          int64_t track_vars, int k, int calib_iters) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* pt_thr = reinterpret_cast<float*>(smem_raw);  // (K,) B_k
  int* cnt = reinterpret_cast<int*>(pt_thr + k);       // (K,) cnt_k
  __shared__ float warp_sums[kMaxWarps];

  const int64_t e = blockIdx.x;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;  // 128, 256 or 512 (the entry point's)
  const int n_warps = threads >> 5;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* sc = scalars + e * n_scalars;

  int64_t nt = n_tracks[e];
  nt = nt < 0 ? 0 : (nt > max_tracks ? max_tracks : nt);
  const float* trk = tracks + e * max_tracks * track_vars;
  for (int j = tid; j < k; j += threads) {
    pt_thr[j] = thresholds[k + j];
    cnt[j] = 0;
  }
  // the operands of query tid's final compare, loaded now
  bool pass = false;
  float c_min = 0.0f, d_cap = 0.0f;
  if (tid < k) {
    pass = scalar_pass(sc, thresholds, var_idx, n_scalars, tid);
    c_min = thresholds[2 * k + tid];
    d_cap = thresholds[3 * k + tid];
  }

  // nt is uniform over the block, so every warp runs the same rounds and
  // the full-mask warp sums below are well defined
  float sum = 0.0f;
  for (int64_t base = 0; base < nt; base += kPer * threads) {
    float pt[kPer];
    int n_mine = 0;                   // this thread's valid tracks: u < it
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int64_t t = base + u * threads + tid;
      pt[u] = 0.0f;
      if (t < nt) pt[u] = load_no_allocate(trk + t * track_vars);
      n_mine += t < nt ? 1 : 0;
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      if (u < n_mine) {
        pt[u] = calibrate_pt(pt[u], calib_iters);
        sum += pt[u];
      }
    }
    __syncthreads();  // the thresholds are in shared memory
    for (int j = 0; j < k; ++j) {
      const float b = pt_thr[j];
      int c = 0;
#pragma unroll
      for (int u = 0; u < kPer; ++u) c += (u < n_mine && pt[u] > b) ? 1 : 0;
      c = __reduce_add_sync(0xffffffffu, c);
      if (lane == 0 && c != 0) atomicAdd(&cnt[j], c);
    }
  }

  // fixed-shape tree: within each warp, then over the warps
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (lane == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (warp == 0) {
    float s = lane < n_warps ? warp_sums[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[0] = s;
  }
  __syncthreads();
  const float total = warp_sums[0];

  for (int j = tid; j < k; j += threads) {
    if (j >= threads) {
      pass = scalar_pass(sc, thresholds, var_idx, n_scalars, j);
      c_min = thresholds[2 * k + j];
      d_cap = thresholds[3 * k + j];
    }
    const bool m = pass && static_cast<float>(cnt[j]) >= c_min &&
                   (!(d_cap > 0.0f) || total < d_cap);
    mask[e * k + j] = m ? 1.0f : 0.0f;
  }
  if (tid == 0) var[e] = sc[0];
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` with
// `threads` threads a block (128, 256 or 512; anything else is refused as
// cudaErrorInvalidValue before any launch), does not synchronise, and
// returns cudaGetLastError() so a refused launch is seen.
extern "C" int event_filter_batch_launch(
    const void* scalars, const void* tracks, const void* n_tracks,
    const void* thresholds, const void* var_idx, void* mask, void* var,
    long long n, long long n_scalars, long long max_tracks,
    long long track_vars, int k, int calib_iters, int threads,
    void* stream) {
  if (threads != 128 && threads != 256 && threads != kMaxThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * static_cast<size_t>(k) * sizeof(float);
  event_filter_batch_kernel<<<static_cast<unsigned>(n), threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(scalars), static_cast<const float*>(tracks),
      static_cast<const int32_t*>(n_tracks),
      static_cast<const float*>(thresholds),
      static_cast<const int32_t*>(var_idx), static_cast<float*>(mask),
      static_cast<float*>(var), n_scalars, max_tracks, track_vars, k,
      calib_iters);
  return static_cast<int>(cudaGetLastError());
}
