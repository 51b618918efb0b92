// Chunkwise mLSTM backward for Hopper (sm_90a), on the CUDA cores.
//
// No Pallas counterpart: the JAX package differentiates its plain
// mlstm_parallel (src/repro/models/xlstm.py), and the port's forward on
// the card is a kernel (mlstm_scan.cu, which replaces mlstm_pallas of
// src/repro/kernels/mlstm_scan/kernel.py), so its gradient is one too.
//
// What it computes, for q, k, v (B,S,H,D), log f and log i (B,S,H) f32,
// F = cumsum(log f), the forward's output o and its row
// stats L = m + log n and sg = sign(den) where |den| > exp(-m), else 0
// (written by the forward launch, kernel.py: mlstm_cuda(with_stats)), and
// dO = dL/do.  The output num / n does not depend on the stabiliser m
// (every term scales by exp(-m)), so m is a constant here.  With
// sc = q_t . k_s D^-1/2 and E = exp((F_t - F_s) + i_s - L_t) for s <= t:
//   delta_t = sg_t (dO_t . o_t)            P = E sc    dP = dO_t . v_s
//   dsc = E (dP - delta_t)                 dlogw = P (dP - delta_t)
//   dv_s = sum_t P dO_t     dk_s = sum_t dsc q_t D^-1/2
//   dq_t = sum_s dsc k_s D^-1/2
//   d log i_s = sum_t dlogw (column sums)
//   dF_t = sum_s dlogw - d log i_t,   d log f_j = sum_{t >= j} dF_t.
// In exact arithmetic the row sums of dlogw have a closed form, sum_s P
// (dP - delta) = dO.o (1 - sg^2), but o is the forward's output rounded
// to its dtype, and d log f sums the row and column sums' differences
// over the sequence: on xlstm-350m's training activations (bf16) the
// closed form put d log f up to 3.3 % of its largest value off the f64
// evaluation, where the plain backward in f32 stayed within 6.5e-5 (an
// H100).  So the row sums are summed from the terms, as the column sums
// are.  ref.py: mlstm_bwd_ref is this function in
// plain PyTorch, flash attention's backward with a signed P and no
// softmax.
//
// Five launches, every sum in a fixed order and no atomics, so two runs
// give the same bits:
//  0. F = cumsum(log f), one warp per (b, h) (PyTorch's cumsum over the
//     sequence axis took 0.28 ms here, 4 % of the call, on an H100);
//  1. prep: one warp a row, delta;
//  2. dK/dV: one block per (16 keys, b, h), heaviest (first) key blocks
//     first, walking the query tiles of 32 rows from the block's diagonal
//     on.  Its keys' K and V stay in shared memory as f32 (64 KB at D 512),
//     each query tile's Q (scaled) and dO are staged as f32 rows padded by
//     4 floats (132 KB).  Lane = query row, each warp 2 keys (4 below D
//     256): the lane forms sc and dP of its row against the warp's keys
//     (its rows' float4s conflict-free, the keys' broadcast), then P and
//     dsc, and the warp sums dlogw over its lanes for the column sums.
//     The accumulation walks the tile's rows, P and dsc broadcast by
//     shuffles, each lane owning the head-dim columns lane, lane + 32, ...
//     of its warp's keys: dK and dV are 2 keys x 16 columns x 2 = 64
//     registers a lane at D 512.  D 512 is what sets the layout: a key
//     block's dK and dV (16 x 512 x 2 floats) fill the block's registers,
//     so the block keeps 16 keys and stages the rows it reads in shared
//     memory rather than more keys;
//  3. dQ: one block per (query tile, h, b), after the forward's CUDA-core
//     kernel: 16 query rows at D 512 (32 below), Q and dO staged once,
//     keys in tiles of 32 (K and V padded), lane = key: sc, dP, dsc to
//     shared memory, then dq[r][lane + 32 c] += sum_j dsc k; the warp
//     sums each row's dlogw over its lanes, tile after tile (row sums);
//  4. finish: one warp per (b, h): d log f by a reverse scan of dF, 32
//     rows at a time from the end.
//
// Bf16 at head dim 512 (xlstm-350m) takes the tensor cores instead
// (mlstm_bwd_wgmma.cuh, entry point mlstm_bwd_wgmma_launch): 0., then a
// planes pass (delta and the gates' exp2 terms as padded (B * H, S)
// planes), the wgmma dK/dV and dQ kernels, then 4.; backward.py: plan
// picks it.  The kernels below stay for f32 at every head dim and bf16 at
// 16, 32 and 64: their bf16 instance at 512 is not built.
//
// Bound on this card: operations.  Seven products of D per valid (query,
// key) pair (sc and dP in each of dK/dV and dQ, dv, dk, dq): 14 D flops,
// ~120 GFLOP at xlstm-350m's training microbatch (2, 2048, 4, 512); in
// f32 on the CUDA cores at 67 TFLOP/s ~1.8 ms.  A backward that any
// implementation needs does 10 D flops a pair (five products) at 989
// TFLOP/s bf16 on the tensor cores: the bound chip_smoke reports.  This
// kernel is simple and right, not fast; its reads from shared memory
// (about one float4 or two floats per two FMAs a lane) hold it below the
// CUDA cores' rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "mlstm_bwd_wgmma.cuh"
#include "mlstm_simt.cuh"

namespace {

constexpr int kTile = 32;      // query rows a dK/dV tile; keys a dQ tile
constexpr int kKeyBlock = 16;  // keys a dK/dV block
constexpr int kPrepRows = 8;   // rows a prep block, one a warp

template <int D>
struct BwdShape {
  static constexpr int kWarps = D >= 256 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kKeys = kKeyBlock / kWarps;  // keys a dK/dV warp
  static constexpr int kRowsQ = D >= 256 ? 16 : 32;  // rows a dQ block
  static constexpr int kRowsW = kRowsQ / kWarps;     // rows a dQ warp
  static constexpr int kCols = (D + 31) / 32;        // columns a lane
  static constexpr int kStride = D + 4;              // pad: distinct banks
  static constexpr size_t kSmemKV =
      sizeof(float) * (2 * kKeyBlock * D + 2 * kTile * kStride + 3 * kTile +
                       2 * kKeyBlock);
  static constexpr size_t kSmemQ =
      sizeof(float) * (2 * kRowsQ * D + 2 * kTile * kStride +
                       kRowsQ * kTile + 3 * kRowsQ + 2 * kTile);
  static_assert(kSmemKV <= 232448 && kSmemQ <= 232448,
                "more shared memory than a block has");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;          // the forward's output
  const void* g;          // dO
  const float* lf;        // log f, (B,S,H) contiguous
  float* f;               // F = cumsum(log f), (B,S,H): written first
  const float* li;        // log i, (B,S,H) contiguous
  const float* lse;       // the forward's L, (B,S,H)
  const float* sg;        // the forward's sg, (B,S,H)
  float* delta;           // scratch (B,S,H)
  float* rowsum;          // scratch (B,S,H)
  void* dq;               // (B,S,H,D) contiguous, q's dtype
  void* dk;
  void* dv;
  float* dli;             // (B,S,H): the column sums
  float* dlf;             // (B,S,H)
  int64_t s, h;
  int64_t q_sb, q_ss, q_sh;                       // strides, in elements
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t g_sb, g_ss, g_sh;
  float scale;
  bool vec;                                       // 16-byte loads
};

__device__ __forceinline__ int64_t plane_at(const Params& p, int64_t b,
                                            int64_t t, int64_t h) {
  return (b * p.s + t) * p.h + h;
}

// 0. F = cumsum(log f): one warp per (b, h), 32 rows at a time, each
// lane's next row loaded before the current rows' scan
__global__ void __launch_bounds__(32) mlstm_bwd_cumsum_kernel(const Params p) {
  const int lane = threadIdx.x;
  const int64_t hh = blockIdx.x % p.h, bb = blockIdx.x / p.h;
  auto load = [&](int64_t t) {
    return t < p.s ? p.lf[plane_at(p, bb, t, hh)] : 0.0f;
  };
  float carry = 0.0f;
  float x = load(lane);
  for (int64_t t0 = 0; t0 < p.s; t0 += 32) {
    const int64_t t = t0 + lane;
    const float next = load(t + 32);
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    x += carry;
    if (t < p.s) p.f[plane_at(p, bb, t, hh)] = x;
    carry = __shfl_sync(0xffffffffu, x, 31);
    x = next;
  }
}

// 1. delta_t = sg_t (dO_t . o_t)
template <typename T, int D>
__global__ void __launch_bounds__(32 * kPrepRows)
mlstm_bwd_prep_kernel(const Params p) {
  const int lane = threadIdx.x % 32;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kPrepRows +
                    threadIdx.x / 32;
  if (t >= p.s) return;
  const int64_t hh = blockIdx.y, bb = blockIdx.z;
  const T* o = static_cast<const T*>(p.o) + bb * p.o_sb + t * p.o_ss +
               hh * p.o_sh;
  const T* g = static_cast<const T*>(p.g) + bb * p.g_sb + t * p.g_ss +
               hh * p.g_sh;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(g[d]), to_f32(o[d]), acc);
  const float dot = warp_sum(acc);
  if (lane == 0) {
    const int64_t at = plane_at(p, bb, t, hh);
    p.delta[at] = p.sg[at] * dot;
  }
}

// 2. dK, dV and the column sums (d log i) of one key block
template <typename T, int D>
__global__ void __launch_bounds__(BwdShape<D>::kThreads, 1)
mlstm_bwd_dkdv_kernel(const Params p, int bh_count) {
  using S = BwdShape<D>;
  constexpr int kWarps = S::kWarps, kKeys = S::kKeys, kCols = S::kCols;
  constexpr int kStride = S::kStride;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                              // [kKeyBlock][D]
  float* v_s = k_s + kKeyBlock * D;               // [kKeyBlock][D]
  float* q_s = v_s + kKeyBlock * D;               // [kTile][kStride], scaled
  float* g_s = q_s + kTile * kStride;             // [kTile][kStride]
  float* fq_s = g_s + kTile * kStride;            // [kTile] F_t
  float* lq_s = fq_s + kTile;                     // [kTile] L_t
  float* dl_s = lq_s + kTile;                     // [kTile] delta_t
  float* fk_s = dl_s + kTile;                     // [kKeyBlock] F_s
  float* ik_s = fk_s + kKeyBlock;                 // [kKeyBlock] log i_s

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // the first key blocks see the most query rows: they go first
  const int bh = blockIdx.x % bh_count;
  const int64_t s0 = static_cast<int64_t>(blockIdx.x / bh_count) * kKeyBlock;
  const int64_t hh = bh % p.h, bb = bh / p.h;
  const T* q = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  const T* g = static_cast<const T*>(p.g) + bb * p.g_sb + hh * p.g_sh;

  stage_rows<T, D, S::kThreads, kKeyBlock>(k, p.k_ss, s0, p.s, k_s, D, 1.0f,
                                           p.vec, tid);
  stage_rows<T, D, S::kThreads, kKeyBlock>(v, p.v_ss, s0, p.s, v_s, D, 1.0f,
                                           p.vec, tid);
  for (int j = tid; j < kKeyBlock; j += S::kThreads) {
    const bool in = s0 + j < p.s;
    fk_s[j] = in ? p.f[plane_at(p, bb, s0 + j, hh)] : 0.0f;
    ik_s[j] = in ? p.li[plane_at(p, bb, s0 + j, hh)] : 0.0f;
  }

  float dk[kKeys][kCols], dv[kKeys][kCols], col[kKeys];
#pragma unroll
  for (int kk = 0; kk < kKeys; ++kk) {
    col[kk] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[kk][c] = dv[kk][c] = 0.0f;
  }

  for (int64_t t0 = s0 / kTile * kTile; t0 < p.s; t0 += kTile) {
    __syncthreads();  // the last tile's reads are done (K, V are written)
    stage_rows<T, D, S::kThreads, kTile>(q, p.q_ss, t0, p.s, q_s, kStride,
                                         p.scale, p.vec, tid);
    stage_rows<T, D, S::kThreads, kTile>(g, p.g_ss, t0, p.s, g_s, kStride,
                                         1.0f, p.vec, tid);
    for (int r = tid; r < kTile; r += S::kThreads) {
      const bool in = t0 + r < p.s;
      const int64_t at = plane_at(p, bb, in ? t0 + r : 0, hh);
      fq_s[r] = in ? p.f[at] : 0.0f;
      lq_s[r] = in ? p.lse[at] : 0.0f;
      dl_s[r] = in ? p.delta[at] : 0.0f;
    }
    __syncthreads();

    // sc and dP of row t0 + lane against the warp's keys
    float sc[kKeys], dp[kKeys];
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) sc[kk] = dp[kk] = 0.0f;
    const float4* qr = reinterpret_cast<const float4*>(q_s + lane * kStride);
    const float4* gr = reinterpret_cast<const float4*>(g_s + lane * kStride);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 qv = qr[d4], gv = gr[d4];
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) {
        const int j = warp + kWarps * kk;
        const float4 kv = reinterpret_cast<const float4*>(k_s + j * D)[d4];
        const float4 vv = reinterpret_cast<const float4*>(v_s + j * D)[d4];
        sc[kk] = fmaf(qv.x, kv.x, sc[kk]);
        sc[kk] = fmaf(qv.y, kv.y, sc[kk]);
        sc[kk] = fmaf(qv.z, kv.z, sc[kk]);
        sc[kk] = fmaf(qv.w, kv.w, sc[kk]);
        dp[kk] = fmaf(gv.x, vv.x, dp[kk]);
        dp[kk] = fmaf(gv.y, vv.y, dp[kk]);
        dp[kk] = fmaf(gv.z, vv.z, dp[kk]);
        dp[kk] = fmaf(gv.w, vv.w, dp[kk]);
      }
    }
    const int64_t t = t0 + lane;
    float pp[kKeys], ds[kKeys];
#pragma unroll
    for (int kk = 0; kk < kKeys; ++kk) {
      const int j = warp + kWarps * kk;
      const bool valid = t < p.s && s0 + j <= t;
      const float e =
          valid ? expf(((fq_s[lane] - fk_s[j]) + ik_s[j]) - lq_s[lane])
                : 0.0f;
      const float dpd = dp[kk] - dl_s[lane];
      pp[kk] = e * sc[kk];
      ds[kk] = e * dpd;
      col[kk] += warp_sum(pp[kk] * dpd);
    }

    // dv += P^T dO, dk += dsc^T (q D^-1/2), the tile's rows in order
#pragma unroll 2
    for (int tt = 0; tt < kTile; ++tt) {
      float pt[kKeys], dt[kKeys];
#pragma unroll
      for (int kk = 0; kk < kKeys; ++kk) {
        pt[kk] = __shfl_sync(0xffffffffu, pp[kk], tt);
        dt[kk] = __shfl_sync(0xffffffffu, ds[kk], tt);
      }
      const float* gq = g_s + tt * kStride;
      const float* qq = q_s + tt * kStride;
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        if (d >= D) continue;
        const float gv = gq[d], qv = qq[d];
#pragma unroll
        for (int kk = 0; kk < kKeys; ++kk) {
          dv[kk][c] = fmaf(pt[kk], gv, dv[kk][c]);
          dk[kk][c] = fmaf(dt[kk], qv, dk[kk][c]);
        }
      }
    }
  }

#pragma unroll
  for (int kk = 0; kk < kKeys; ++kk) {
    const int64_t key = s0 + warp + kWarps * kk;
    if (key >= p.s) continue;
    const int64_t at = plane_at(p, bb, key, hh);
    T* dkr = static_cast<T*>(p.dk) + at * D;
    T* dvr = static_cast<T*>(p.dv) + at * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d >= D) continue;
      store(dkr + d, dk[kk][c]);
      store(dvr + d, dv[kk][c]);
    }
    if (lane == 0) p.dli[at] = col[kk];
  }
}

// 3. dQ of one query tile
template <typename T, int D>
__global__ void __launch_bounds__(BwdShape<D>::kThreads, 1)
mlstm_bwd_dq_kernel(const Params p) {
  using S = BwdShape<D>;
  constexpr int kWarps = S::kWarps, kRows = S::kRowsQ, kRowsW = S::kRowsW;
  constexpr int kCols = S::kCols, kStride = S::kStride;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                              // [kRows][D], scaled
  float* g_s = q_s + kRows * D;                   // [kRows][D]
  float* k_s = g_s + kRows * D;                   // [kTile][kStride]
  float* v_s = k_s + kTile * kStride;             // [kTile][kStride]
  float* p_s = v_s + kTile * kStride;             // [kRows][kTile] dsc
  float* fq_s = p_s + kRows * kTile;              // [kRows] F_t
  float* lq_s = fq_s + kRows;                     // [kRows] L_t
  float* dl_s = lq_s + kRows;                     // [kRows] delta_t
  float* fk_s = dl_s + kRows;                     // [kTile] F_s
  float* ik_s = fk_s + kTile;                     // [kTile] log i_s

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // heaviest query tiles first
  const int64_t q0 =
      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * kRows;
  const int64_t hh = blockIdx.y, bb = blockIdx.z;
  const T* q = static_cast<const T*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + bb * p.k_sb + hh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + bb * p.v_sb + hh * p.v_sh;
  const T* g = static_cast<const T*>(p.g) + bb * p.g_sb + hh * p.g_sh;

  stage_rows<T, D, S::kThreads, kRows>(q, p.q_ss, q0, p.s, q_s, D, p.scale,
                                       p.vec, tid);
  stage_rows<T, D, S::kThreads, kRows>(g, p.g_ss, q0, p.s, g_s, D, 1.0f,
                                       p.vec, tid);
  for (int r = tid; r < kRows; r += S::kThreads) {
    const bool in = q0 + r < p.s;
    const int64_t at = plane_at(p, bb, in ? q0 + r : 0, hh);
    fq_s[r] = in ? p.f[at] : 0.0f;
    lq_s[r] = in ? p.lse[at] : 0.0f;
    dl_s[r] = in ? p.delta[at] : 0.0f;
  }
  const int64_t k_hi = q0 + kRows < p.s ? q0 + kRows : p.s;

  float acc[kRowsW][kCols], row_sum[kRowsW];
#pragma unroll
  for (int r = 0; r < kRowsW; ++r) {
    row_sum[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.0f;
  }

  for (int64_t k0 = 0; k0 < k_hi; k0 += kTile) {
    __syncthreads();  // the last tile's reads are done (Q, dO are written)
    stage_rows<T, D, S::kThreads, kTile>(k, p.k_ss, k0, p.s, k_s, kStride,
                                         1.0f, p.vec, tid);
    stage_rows<T, D, S::kThreads, kTile>(v, p.v_ss, k0, p.s, v_s, kStride,
                                         1.0f, p.vec, tid);
    for (int j = tid; j < kTile; j += S::kThreads) {
      const bool in = k0 + j < p.s;
      const int64_t at = plane_at(p, bb, in ? k0 + j : 0, hh);
      fk_s[j] = in ? p.f[at] : 0.0f;
      ik_s[j] = in ? p.li[at] : 0.0f;
    }
    __syncthreads();

    // sc and dP of key k0 + lane against the warp's rows
    float sc[kRowsW], dp[kRowsW];
#pragma unroll
    for (int r = 0; r < kRowsW; ++r) sc[r] = dp[r] = 0.0f;
    const float4* kr = reinterpret_cast<const float4*>(k_s + lane * kStride);
    const float4* vr = reinterpret_cast<const float4*>(v_s + lane * kStride);
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kv = kr[d4], vv = vr[d4];
#pragma unroll
      for (int r = 0; r < kRowsW; ++r) {
        const int i = warp + kWarps * r;
        const float4 qv = reinterpret_cast<const float4*>(q_s + i * D)[d4];
        const float4 gv = reinterpret_cast<const float4*>(g_s + i * D)[d4];
        sc[r] = fmaf(qv.x, kv.x, sc[r]);
        sc[r] = fmaf(qv.y, kv.y, sc[r]);
        sc[r] = fmaf(qv.z, kv.z, sc[r]);
        sc[r] = fmaf(qv.w, kv.w, sc[r]);
        dp[r] = fmaf(gv.x, vv.x, dp[r]);
        dp[r] = fmaf(gv.y, vv.y, dp[r]);
        dp[r] = fmaf(gv.z, vv.z, dp[r]);
        dp[r] = fmaf(gv.w, vv.w, dp[r]);
      }
    }
    const int64_t key = k0 + lane;
#pragma unroll
    for (int r = 0; r < kRowsW; ++r) {
      const int i = warp + kWarps * r;
      const bool valid = q0 + i < p.s && key <= q0 + i;
      const float e =
          valid ? expf(((fq_s[i] - fk_s[lane]) + ik_s[lane]) - lq_s[i])
                : 0.0f;
      const float dpd = dp[r] - dl_s[i];
      p_s[i * kTile + lane] = e * dpd;
      row_sum[r] += warp_sum((e * sc[r]) * dpd);
    }
    __syncwarp();  // a warp reads back only its own rows of dsc

    // acc[r][c] += sum_j dsc[i][j] k[j][lane + 32 c]
#pragma unroll 2
    for (int j = 0; j < kTile; ++j) {
      float kk[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int d = lane + 32 * c;
        kk[c] = d < D ? k_s[j * kStride + d] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < kRowsW; ++r) {
        const float pj = p_s[(warp + kWarps * r) * kTile + j];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, kk[c], acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsW; ++r) {
    const int64_t row = q0 + warp + kWarps * r;
    if (row >= p.s) continue;
    if (lane == 0) p.rowsum[plane_at(p, bb, row, hh)] = row_sum[r];
    T* dqr = static_cast<T*>(p.dq) + plane_at(p, bb, row, hh) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store(dqr + d, acc[r][c] * p.scale);
    }
  }
}

// 1'. the tensor-core path's planes (3, B * H, sp), one warp a row: delta_t
// = sg_t (dO_t . o_t), c_t = (F_t - L_t) log2(e) + log2(D^-1/2) and g_t =
// (i_t - F_t) log2(e); rows in [S, sp) get zeros (the products mask them)
__global__ void __launch_bounds__(32 * kPrepRows)
mlstm_bwd_planes_kernel(const Params p, float* planes, int sp,
                        float log2_scale) {
  constexpr float kLog2e = 1.4426950408889634f;
  constexpr int D = mlstm_bwd_wgmma::D;
  const int lane = threadIdx.x % 32;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kPrepRows +
                    threadIdx.x / 32;
  if (t >= sp) return;
  const int64_t hh = blockIdx.y, bb = blockIdx.z;
  const int64_t plane = static_cast<int64_t>(gridDim.z) * p.h * sp;
  float* row = planes + (bb * p.h + hh) * sp + t;
  if (t >= p.s) {
    if (lane == 0) row[0] = row[plane] = row[2 * plane] = 0.0f;
    return;
  }
  const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(p.o) +
                           bb * p.o_sb + t * p.o_ss + hh * p.o_sh;
  const __nv_bfloat16* g = static_cast<const __nv_bfloat16*>(p.g) +
                           bb * p.g_sb + t * p.g_ss + hh * p.g_sh;
  float acc = 0.0f;
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f32(g[d]), to_f32(o[d]), acc);
  const float dot = warp_sum(acc);
  if (lane == 0) {
    const int64_t at = plane_at(p, bb, t, hh);
    const float f = p.f[at];
    row[0] = p.sg[at] * dot;
    row[plane] = (f - p.lse[at]) * kLog2e + log2_scale;
    row[2 * plane] = (p.li[at] - f) * kLog2e;
  }
}

// 4. d log f_j = sum_{t >= j} (rowsum_t - d log i_t): one warp per (b, h),
// 32 rows at a time from the end, each lane's next row loaded before the
// current rows' scan
__global__ void __launch_bounds__(32) mlstm_bwd_finish_kernel(const Params p) {
  const int lane = threadIdx.x;
  const int64_t hh = blockIdx.x % p.h, bb = blockIdx.x / p.h;
  auto load = [&](int64_t t) {
    return t >= 0 ? p.rowsum[plane_at(p, bb, t, hh)] -
                        p.dli[plane_at(p, bb, t, hh)]
                  : 0.0f;
  };
  float carry = 0.0f;
  float x = load(p.s - 1 - lane);
  for (int64_t top = p.s - 1; top >= 0; top -= 32) {
    const int64_t t = top - lane;
    const float next = load(t - 32);
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    x += carry;
    if (t >= 0) p.dlf[plane_at(p, bb, t, hh)] = x;
    carry = __shfl_sync(0xffffffffu, x, 31);
    x = next;
  }
}

template <typename T, int D>
int launch(const Params& p, long long b, cudaStream_t stream) {
  using S = BwdShape<D>;
  // above 48 KB a block gets dynamic shared memory only after opting in;
  // done once per instance, at its first launch (never inside a capture
  // that is not preceded by a launch)
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(mlstm_bwd_dkdv_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(S::kSmemKV)),
      cudaFuncSetAttribute(mlstm_bwd_dq_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(S::kSmemQ))};
  for (const cudaError_t rc : attr)
    if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long bh = b * p.h;
  mlstm_bwd_cumsum_kernel<<<static_cast<unsigned>(bh), 32, 0, stream>>>(p);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  mlstm_bwd_prep_kernel<T, D>
      <<<dim3(static_cast<unsigned>((p.s + kPrepRows - 1) / kPrepRows),
              static_cast<unsigned>(p.h), static_cast<unsigned>(b)),
         32 * kPrepRows, 0, stream>>>(p);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  mlstm_bwd_dkdv_kernel<T, D>
      <<<static_cast<unsigned>((p.s + kKeyBlock - 1) / kKeyBlock * bh),
         S::kThreads, S::kSmemKV, stream>>>(p, static_cast<int>(bh));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  mlstm_bwd_dq_kernel<T, D>
      <<<dim3(static_cast<unsigned>((p.s + S::kRowsQ - 1) / S::kRowsQ),
              static_cast<unsigned>(p.h), static_cast<unsigned>(b)),
         S::kThreads, S::kSmemQ, stream>>>(p);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  mlstm_bwd_finish_kernel<<<static_cast<unsigned>(bh), 32, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// f32 at every head dim; bf16 only where the tensor-core variant does not
// reach (head dim 16, 32, 64)
template <typename T>
int launch_dim(const Params& p, int head_dim, long long b,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<T, 16>(p, b, stream);
    case 32: return launch<T, 32>(p, b, stream);
    case 64: return launch<T, 64>(p, b, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    if (head_dim == 512) return launch<T, 512>(p, b, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype 0 is float32 (head dim
// 16, 32, 64, 512), 1 is bfloat16 (16, 32, 64) (q, k, v, o, dO, and dq,
// dk, dv); q, k, v, o and dO have a contiguous head dim and the given
// strides (in elements); lf (log f),
// li, lse and sg are contiguous (B,S,H) f32 (lse and sg from the forward
// launch); f, delta and rowsum are (B,S,H) f32 scratch; dq, dk, dv
// contiguous (B,S,H,D), dli and dlf contiguous (B,S,H) f32; scale is
// D^-1/2.  Five launches on `stream`; does not synchronise, and returns
// cudaGetLastError() so a refused launch is seen.
extern "C" int mlstm_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* lf, void* f, const void* li, const void* lse,
    const void* sg, void* delta, void* rowsum, void* dq, void* dk, void* dv,
    void* dli, void* dlf, int dtype, int head_dim, long long b, long long s,
    long long h, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long g_sb, long long g_ss, long long g_sh,
    float scale, void* stream) {
  if (b <= 0 || s <= 0 || h <= 0 || b > 65535 || h > 65535 ||
      (s + kKeyBlock - 1) / kKeyBlock * b * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte loads need every row start aligned: the base pointers and
  // every stride a whole number of 16-byte vectors
  const long long vec_elems = dtype == 1 ? 8 : 4;
  bool vec = true;
  for (const void* ptr : {q, k, v, g})
    vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (long long st : {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                       g_sb, g_ss, g_sh})
    vec = vec && st % vec_elems == 0;
  Params p{q,
           k,
           v,
           o,
           g,
           static_cast<const float*>(lf),
           static_cast<float*>(f),
           static_cast<const float*>(li),
           static_cast<const float*>(lse),
           static_cast<const float*>(sg),
           static_cast<float*>(delta),
           static_cast<float*>(rowsum),
           dq,
           dk,
           dv,
           static_cast<float*>(dli),
           static_cast<float*>(dlf),
           s,
           h,
           q_sb, q_ss, q_sh,
           k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh,
           g_sb, g_ss, g_sh,
           scale,
           vec};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(p, head_dim, b, st);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(p, head_dim, b, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Plain C entry point of the tensor-core path (bf16, head dim 512): the
// operands as mlstm_bwd_launch's (rowsum the row sums' (B,S,H) f32
// scratch), planes a (3, B * H, sp) f32 scratch, sp = S rounded up to 64;
// q, k, v and dO 16-byte aligned (TMA); log2_scale is log2(D^-1/2).  F's
// cumulative sum, the planes, dK/dV, dQ and d log f's reverse sum on
// `stream`; does not synchronise, and returns 0, a cudaError_t, or a
// hopper:: status code (negative) when a tensor map cannot be encoded.
extern "C" int mlstm_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* g, const void* lf, void* f, const void* li, const void* lse,
    const void* sg, void* rowsum, void* planes, void* dq, void* dk,
    void* dv, void* dli, void* dlf, long long b, long long s, long long h,
    long long sp, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long g_sb, long long g_ss, long long g_sh,
    float log2_scale, void* stream) {
  namespace tc = mlstm_bwd_wgmma;
  if (b <= 0 || s <= 0 || h <= 0 || b > 65535 || h > 65535 ||
      sp != (s + tc::kBlock - 1) / tc::kBlock * tc::kBlock ||
      2 * sp / tc::kBlock * b * h > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, g,
           static_cast<const float*>(lf),
           static_cast<float*>(f),
           static_cast<const float*>(li),
           static_cast<const float*>(lse),
           static_cast<const float*>(sg),
           nullptr,
           static_cast<float*>(rowsum),
           dq, dk, dv,
           static_cast<float*>(dli),
           static_cast<float*>(dlf),
           s, h,
           q_sb, q_ss, q_sh,
           k_sb, k_ss, k_sh,
           v_sb, v_ss, v_sh,
           o_sb, o_ss, o_sh,
           g_sb, g_ss, g_sh,
           0.0f,
           false};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned bh = static_cast<unsigned>(b * h);
  mlstm_bwd_cumsum_kernel<<<bh, 32, 0, st>>>(p);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  mlstm_bwd_planes_kernel<<<dim3(static_cast<unsigned>(sp / kPrepRows),
                                 static_cast<unsigned>(h),
                                 static_cast<unsigned>(b)),
                            32 * kPrepRows, 0, st>>>(
      p, static_cast<float*>(planes), static_cast<int>(sp), log2_scale);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const tc::Params tp{static_cast<const float*>(planes),
                      static_cast<__nv_bfloat16*>(dq),
                      static_cast<__nv_bfloat16*>(dk),
                      static_cast<__nv_bfloat16*>(dv),
                      static_cast<float*>(dli),
                      static_cast<float*>(rowsum),
                      static_cast<int>(s),
                      static_cast<int>(h),
                      static_cast<int>(bh),
                      static_cast<int>(sp)};
  const int tc_rc = tc::launch(q, k, v, g, tp, b, q_sb, q_ss, q_sh, k_sb,
                               k_ss, k_sh, v_sb, v_ss, v_sh, g_sb, g_ss,
                               g_sh, st);
  if (tc_rc != 0) return tc_rc;
  mlstm_bwd_finish_kernel<<<bh, 32, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
