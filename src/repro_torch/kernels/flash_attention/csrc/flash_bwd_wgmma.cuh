// Backward of flash attention on the tensor cores: bf16 at head dim 64 or
// 128 (every dense config trains at 128), wgmma fed by TMA.  Included by
// flash_attention_bwd.cu, which holds the formulas, the delta pre-pass
// and the C entry point.
//
// Inputs beside q, k, v and dO: lse2 = lse * log2(e) and delta, two f32
// planes (B, H, sqp) that the pre-pass writes from the forward's lse and
// from dO . O, padded to sqp = Sq rounded up to 128 rows with lse2 = +inf
// and delta = 0, so a padded row's P and dS are exactly 0 and a stage's
// 64 values are one 16-byte-aligned bulk copy.
//
// Two kernels, no atomic on data, every sum in a fixed order:
//
// 1. dK, dV (fa_bwd_dkdv_wgmma_kernel).  One block per (tile of 128 keys,
//    batch row, kv head, head split), the key tiles that most queries see
//    first; two warpgroups own 64 keys each, K and V loaded once.  The
//    block walks the split's query heads in order and, for each, the query
//    tiles of 64 rows that can see its keys; Q, dO and their lse2/delta go
//    through a ring of kStages stages (TMA and a bulk copy on one full
//    barrier; the second warpgroup to release a stage refills it, as the
//    forward's ring).  Per tile a warpgroup computes
//      S^T  = K . Q^T          (m64n64k16, both K-major over D)
//      dP^T = V . dO^T         (the same)
//      P^T  = 2^(S^T c - lse2), 0 where masked;  dS^T = P^T (dP^T - delta)
//             (1 - tanh^2) scale
//      dV  += P^T . dO,  dK += dS^T . Q   (P^T and dS^T from registers as
//             one bf16 term each, dO and Q through the transpose bit)
//    with dK and dV in f32 registers (D/2 each a thread).  The G = H / K
//    query heads of a kv head are cut into `splits` consecutive runs
//    (backward.py's plan: enough blocks to fill the card; at
//    starcoder2-3b's shape 64 key tiles x 4 splits = 256 blocks).  One
//    split stores dK, dV in bf16; several store f32 partials (2, splits,
//    B, Sk, K, D), and fa_bwd_sum_kernel adds them in split order.
// 2. dQ (fa_bwd_dq_wgmma_kernel).  One block per (tile of 128 query rows,
//    q head, batch row), heaviest tiles first; two warpgroups own 64 rows
//    each, Q and dO loaded once; K and V tiles of 64 keys through a ring.
//    Per tile: S = Q . K^T, dP = dO . V^T, P and dS as above, then
//    dQ += dS . K (dS from registers, K through the transpose bit).  It
//    recomputes S and dP: 7 products of Sq x Sk x D a head in all, 1.4x
//    the 5 that any backward needs, the price of a dQ summed in order
//    without atomics (FA2/FA3 add dQ with float atomics, whose order
//    changes from run to run).
//
// Tiles fully masked for a warpgroup are skipped (exact: their P is 0);
// the warpgroup still waits for and releases them, so the ring stays in
// step.  A branch of one thread beside an unfinished wgmma makes ptxas
// serialise every wgmma, so each product group is waited for before any
// branch and before the release.  A block of 256 threads may use 255
// registers a thread: the dK/dV kernel's largest state at D = 128 is dK
// and dV (128) with S^T and dP^T (64); P^T and dS^T are packed to bf16 16
// queries at a time, so the f32 tiles die as the fragments are formed.
#pragma once

#include "hopper.cuh"

namespace fa_bwd_wgmma {

template <int D>
struct Cfg {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int kChunks = D / 64;          // 128-byte boxes a row
  static constexpr int kRows = 64;                // rows of every tile
  static constexpr int kBox = kRows * 128;        // bytes of a 64-row box
  static constexpr int kTile = kChunks * kBox;    // 64 rows x D, bf16
  static constexpr int kGroups = 2;               // warpgroups of 64 rows
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBlockRows = kRows * kGroups;  // keys / rows a block
  // dK/dV: Q, dO (and lse2, delta) stages of 64 query rows
  static constexpr int kStagesKV = D >= 128 ? 3 : 4;
  static constexpr int kSmemKV = 1024 + 2 * kGroups * kTile +
                                 2 * kStagesKV * kTile +
                                 kStagesKV * 2 * kRows * 4 + 128;
  // dQ: K, V stages of 64 keys
  static constexpr int kStagesQ = D >= 128 ? 3 : 4;
  static constexpr int kSmemQ = 1024 + 2 * kGroups * kTile +
                                2 * kStagesQ * kTile + 128;
  static_assert(kSmemKV <= 232448 && kSmemQ <= 232448,
                "more shared memory than a block has");
};

struct Params {
  const float* lse2;              // (B, H, sqp): lse * log2(e), +inf padded
  const float* delta;             // (B, H, sqp): sum_d dO O, 0 padded
  __nv_bfloat16* dq;              // (B, Sq, H, D) contiguous
  __nv_bfloat16* dk;              // (B, Sk, K, D) contiguous
  __nv_bfloat16* dv;
  float* ws;                      // (2, splits, B, Sk, K, D), splits > 1
  int b, sq, sk, h, kh, sqp;
  int splits;                     // runs of a kv head's query heads
  // P = 2^(x c - lse2): x the unscaled score and c = scale * log2(e), or
  // with a cap x = cap * tanh(s * scale / cap) and c = log2(e)
  float c, scale, cap, scale_over_cap;
  int has_cap, causal, has_window, window;
};

// P and dS (times the cap's derivative and the scale) of one score x (the
// accumulator: unscaled q . k) from dP, lse2 and delta of its query
__device__ __forceinline__ void p_and_ds(const Params& p, float x, float dp,
                                         float lse2, float dl, bool valid,
                                         float& pr, float& ds) {
  float t = 0.0f;
  if (p.has_cap) {
    t = tanhf(x * p.scale_over_cap);
    x = p.cap * t;
  }
  pr = valid ? exp2f(fmaf(x, p.c, -lse2)) : 0.0f;
  float d = pr * (dp - dl);
  if (p.has_cap) d *= 1.0f - t * t;
  ds = d * p.scale;
}

// ------------------------------------------------------------------------ //
// 1. dK, dV
// ------------------------------------------------------------------------ //
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
fa_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const Params p) {
  using C = Cfg<D>;
  using namespace hopper;
  constexpr int kStages = C::kStagesKV;
  extern __shared__ __align__(1024) uint8_t dkdv_smem[];
  uint8_t* k_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dkdv_smem) + 1023) & ~uintptr_t(1023));
  uint8_t* v_s = k_s + C::kGroups * C::kTile;     // [group][chunk][64][64]
  uint8_t* q_s = v_s + C::kGroups * C::kTile;     // [stage][chunk][64][64]
  uint8_t* do_s = q_s + kStages * C::kTile;
  float* st_s = reinterpret_cast<float*>(do_s + kStages * C::kTile);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(st_s +
                                                  kStages * 2 * C::kRows);
  uint64_t* full = kv_full + 1;
  int* released = reinterpret_cast<int*>(full + kStages);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // block -> (key tile, batch row, kv head, split), key tile slowest: the
  // first key tiles, which the most queries see, are scheduled first
  const int per_tile = p.b * p.kh * p.splits;
  const int kt = blockIdx.x / per_tile;
  int rest = blockIdx.x % per_tile;
  const int split = rest % p.splits;
  rest /= p.splits;
  const int kvh = rest % p.kh;
  const int bb = rest / p.kh;
  const int k0 = kt * C::kBlockRows;
  const int g = p.h / p.kh;
  const int heads = g / p.splits;
  const int h0 = kvh * g + split * heads;
  const int off = p.causal ? p.sk - p.sq : 0;     // queries at the last Sq

  // query rows [q_lo, q_hi) hold every query that sees some key of the
  // block
  const int k_last = min(k0 + C::kBlockRows, p.sk) - 1;
  const int q_lo = p.causal ? max(0, k0 - off) : 0;
  const int q_hi = p.has_window ? min(p.sq, k_last - off + p.window) : p.sq;
  const int t_first = q_lo / C::kRows;
  const int nq = q_hi > q_lo ? (q_hi + C::kRows - 1) / C::kRows - t_first
                             : 0;
  const int n_items = heads * nq;

  const int64_t n_out = static_cast<int64_t>(p.b) * p.sk * p.kh * D;
  float* ws_k = p.ws + static_cast<int64_t>(split) * n_out;
  float* ws_v = p.ws + static_cast<int64_t>(p.splits + split) * n_out;
  if (n_items <= 0) {
    // no query sees these keys: their dK and dV are 0
    for (int idx = tid; idx < C::kBlockRows * D; idx += C::kThreads) {
      const int key = k0 + idx / D;
      if (key >= p.sk) continue;
      const int64_t at =
          ((static_cast<int64_t>(bb) * p.sk + key) * p.kh + kvh) * D +
          idx % D;
      if (p.splits == 1) {
        p.dk[at] = __float2bfloat16_rn(0.0f);
        p.dv[at] = __float2bfloat16_rn(0.0f);
      } else {
        ws_k[at] = 0.0f;
        ws_v[at] = 0.0f;
      }
    }
    return;
  }

  // item i (head h0 + i / nq, query tile t_first + i % nq) into its stage
  auto load_item = [&](int i) {
    const int s = i % kStages;
    const int hh = h0 + i / nq;
    const int q0 = (t_first + i % nq) * C::kRows;
    mbar_arrive_expect_tx(&full[s], 2 * C::kTile + 2 * C::kRows * 4);
    for (int c = 0; c < C::kChunks; ++c) {
      tma_load_4d(q_s + s * C::kTile + c * C::kBox, &q_map, &full[s], 64 * c,
                  hh, q0, bb);
      tma_load_4d(do_s + s * C::kTile + c * C::kBox, &do_map, &full[s],
                  64 * c, hh, q0, bb);
    }
    const int64_t at = (static_cast<int64_t>(bb) * p.h + hh) * p.sqp + q0;
    bulk_load(st_s + s * 2 * C::kRows, p.lse2 + at, C::kRows * 4, &full[s]);
    bulk_load(st_s + s * 2 * C::kRows + C::kRows, p.delta + at, C::kRows * 4,
              &full[s]);
  };
  // each warpgroup releases item i once it has read it; the second to do
  // so loads item i + kStages into the stage (the forward's ring).  Called
  // with no wgmma in flight.
  auto release = [&](int i) {
    named_barrier_sync(1 + warp / 4, 128);
    if (tid % 128 == 0) {
      const int s = i % kStages;
      __threadfence_block();
      const int before = atomicAdd(&released[s], 1);
      __threadfence_block();
      if (before == C::kGroups * (i / kStages + 1) - 1 &&
          i + kStages < n_items)
        load_item(i + kStages);
    }
    __syncwarp();
  };

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    fence_barrier_init();
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    prefetch_tensor_map(&do_map);
    mbar_arrive_expect_tx(kv_full, 2 * C::kGroups * C::kTile);
    for (int w = 0; w < C::kGroups; ++w)
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(k_s + (w * C::kChunks + c) * C::kBox, &k_map, kv_full,
                    64 * c, kvh, k0 + C::kRows * w, bb);
        tma_load_4d(v_s + (w * C::kChunks + c) * C::kBox, &v_map, kv_full,
                    64 * c, kvh, k0 + C::kRows * w, bb);
      }
    for (int i = 0; i < min(kStages, n_items); ++i) load_item(i);
  }
  __syncthreads();

  // ---- warpgroup wg: keys [kw0, kw0 + 64) ----
  const int wg = warp / 4;
  const int kw0 = k0 + C::kRows * wg;
  const bool active = kw0 < p.sk;
  const int key0 = kw0 + 16 * (warp % 4) + lane / 4;   // and key0 + 8
  const uint8_t* k_mine = k_s + wg * C::kTile;
  const uint8_t* v_mine = v_s + wg * C::kTile;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

  if (active) mbar_wait(kv_full, 0);
  for (int i = 0; i < n_items; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int q0 = (t_first + i % nq) * C::kRows;
    // every pair of the tile masked (skip), or some (mask)
    const bool none =
        (p.causal && kw0 > q0 + C::kRows - 1 + off) ||
        (p.has_window && kw0 + C::kRows - 1 <= q0 + off - p.window);
    const bool compute = active && !none;
    const bool masked =
        (p.causal && kw0 + C::kRows - 1 > q0 + off) ||
        (p.has_window && kw0 <= q0 + C::kRows - 1 + off - p.window);

    mbar_wait(&full[s], parity);
    if (compute) {
      const uint8_t* q_tile = q_s + s * C::kTile;
      const uint8_t* do_tile = do_s + s * C::kTile;
      const float* lse_s = st_s + s * 2 * C::kRows;
      const float* dl_s = lse_s + C::kRows;
      float st[C::kRows / 2], dpt[C::kRows / 2];  // S^T, dP^T: 64 x 64
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, in = 32 * (kk % 4);
        Wgmma<C::kRows>::template ss<0>(
            st, desc_sw128(k_mine + c * C::kBox + in, 16, 1024),
            desc_sw128(q_tile + c * C::kBox + in, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, in = 32 * (kk % 4);
        Wgmma<C::kRows>::template ss<0>(
            dpt, desc_sw128(v_mine + c * C::kBox + in, 16, 1024),
            desc_sw128(do_tile + c * C::kBox + in, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T, 16 queries (one A fragment) at a time: accumulator
      // columns 16f..16f+15 are fragment f
      uint32_t pa[C::kRows / 4], da[C::kRows / 4];
#pragma unroll
      for (int f = 0; f < C::kRows / 16; ++f) {
        float pv[8], dsv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = 8 * f + u;            // = 4 j + e, j = 2 f + u / 4
          const int e = u % 4;
          const int col = 16 * f + 8 * (u / 4) + 2 * (lane % 4) + (e % 2);
          bool valid = true;
          if (masked) {
            const int key = key0 + 8 * (e / 2);
            const int q_pos = q0 + col + off;
            if (p.causal) valid = key <= q_pos;
            if (p.has_window) valid = valid && key > q_pos - p.window;
          }
          p_and_ds(p, st[idx], dpt[idx], lse_s[col], dl_s[col], valid,
                   pv[u], dsv[u]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pa[4 * f + r] = pack_bf16(pv[2 * r], pv[2 * r + 1]);
          da[4 * f + r] = pack_bf16(dsv[2 * r], dsv[2 * r + 1]);
        }
      }

      fence_regs(dk);
      fence_regs(dv);
      wgmma_fence();
#pragma unroll
      for (int f = 0; f < C::kRows / 16; ++f) {
        const uint32_t a[4] = {pa[4 * f], pa[4 * f + 1], pa[4 * f + 2],
                               pa[4 * f + 3]};
        Wgmma<D>::template rs<1>(
            dv, a, desc_sw128(do_tile + f * 16 * 128, C::kBox, 1024), 1);
      }
#pragma unroll
      for (int f = 0; f < C::kRows / 16; ++f) {
        const uint32_t a[4] = {da[4 * f], da[4 * f + 1], da[4 * f + 2],
                               da[4 * f + 3]};
        Wgmma<D>::template rs<1>(
            dk, a, desc_sw128(q_tile + f * 16 * 128, C::kBox, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(pa);
      fence_regs(da);
    }
    release(i);
  }
  if (!active) return;

  // epilogue: rows key0, key0 + 8; columns 8 j + 2 (lane % 4) + {0, 1}
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.sk) continue;
    const int64_t row =
        ((static_cast<int64_t>(bb) * p.sk + key) * p.kh + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float k_lo = dk[4 * j + 2 * r], k_hi = dk[4 * j + 2 * r + 1];
      const float v_lo = dv[4 * j + 2 * r], v_hi = dv[4 * j + 2 * r + 1];
      if (p.splits == 1) {
        *reinterpret_cast<__nv_bfloat162*>(p.dk + row + col) =
            __floats2bfloat162_rn(k_lo, k_hi);
        *reinterpret_cast<__nv_bfloat162*>(p.dv + row + col) =
            __floats2bfloat162_rn(v_lo, v_hi);
      } else {
        *reinterpret_cast<float2*>(ws_k + row + col) = make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(ws_v + row + col) = make_float2(v_lo, v_hi);
      }
    }
  }
}

// dK and dV (n elements each) as the sum of their `splits` f32 partials in
// split order, cast to bf16; four elements a thread (D is a multiple of 4)
__global__ void __launch_bounds__(256)
fa_bwd_sum_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ dk,
                  __nv_bfloat16* __restrict__ dv, long long n, int splits) {
  const long long n4 = n / 4;
  for (long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
       i < 2 * n4; i += static_cast<long long>(gridDim.x) * 256) {
    const int which = i >= n4;
    const long long e = i - which * n4;
    const float4* src =
        reinterpret_cast<const float4*>(ws) + which * splits * n4 + e;
    float4 acc = src[0];
    for (int s = 1; s < splits; ++s) {
      const float4 x = src[s * n4];
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x, acc.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z, acc.w);
    uint2 packed;
    packed.x = *reinterpret_cast<const uint32_t*>(&lo);
    packed.y = *reinterpret_cast<const uint32_t*>(&hi);
    *reinterpret_cast<uint2*>((which ? dv : dk) + 4 * e) = packed;
  }
}

// ------------------------------------------------------------------------ //
// 2. dQ
// ------------------------------------------------------------------------ //
template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
fa_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const Params p) {
  using C = Cfg<D>;
  using namespace hopper;
  constexpr int kStages = C::kStagesQ;
  extern __shared__ __align__(1024) uint8_t dq_smem[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(dq_smem) + 1023) & ~uintptr_t(1023));
  uint8_t* do_s = q_s + C::kGroups * C::kTile;    // [group][chunk][64][64]
  uint8_t* k_s = do_s + C::kGroups * C::kTile;    // [stage][chunk][64][64]
  uint8_t* v_s = k_s + kStages * C::kTile;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(v_s + kStages * C::kTile);
  uint64_t* full = qd_full + 1;
  int* released = reinterpret_cast<int*>(full + kStages);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kBlockRows;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.kh);
  const int off = p.causal ? p.sk - p.sq : 0;

  // keys [k_lo, k_hi) hold every key valid for some row of the block
  const int row_last = min(q0 + C::kBlockRows, p.sq) - 1;
  const int k_hi = p.causal ? min(p.sk, row_last + off + 1) : p.sk;
  const int k_lo = p.has_window ? max(0, q0 + off - p.window + 1) : 0;
  const int t_first = k_lo / C::kRows;
  const int n_tiles = (k_hi + C::kRows - 1) / C::kRows - t_first;
  if (n_tiles <= 0) {
    // a window of no key: every row is masked, its dq 0
    for (int idx = tid; idx < C::kBlockRows * D; idx += C::kThreads) {
      const int row = q0 + idx / D;
      if (row < p.sq)
        p.dq[((static_cast<int64_t>(bb) * p.sq + row) * p.h + hh) * D +
             idx % D] = __float2bfloat16_rn(0.0f);
    }
    return;
  }

  auto load_tile = [&](int i) {
    const int s = i % kStages;
    const int k0 = (t_first + i) * C::kRows;
    mbar_arrive_expect_tx(&full[s], 2 * C::kTile);
    for (int c = 0; c < C::kChunks; ++c) {
      tma_load_4d(k_s + s * C::kTile + c * C::kBox, &k_map, &full[s], 64 * c,
                  kvh, k0, bb);
      tma_load_4d(v_s + s * C::kTile + c * C::kBox, &v_map, &full[s], 64 * c,
                  kvh, k0, bb);
    }
  };
  auto release = [&](int i) {
    named_barrier_sync(1 + warp / 4, 128);
    if (tid % 128 == 0) {
      const int s = i % kStages;
      __threadfence_block();
      const int before = atomicAdd(&released[s], 1);
      __threadfence_block();
      if (before == C::kGroups * (i / kStages + 1) - 1 &&
          i + kStages < n_tiles)
        load_tile(i + kStages);
    }
    __syncwarp();
  };

  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      released[s] = 0;
    }
    fence_barrier_init();
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    prefetch_tensor_map(&do_map);
    mbar_arrive_expect_tx(qd_full, 2 * C::kGroups * C::kTile);
    for (int w = 0; w < C::kGroups; ++w)
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(q_s + (w * C::kChunks + c) * C::kBox, &q_map, qd_full,
                    64 * c, hh, q0 + C::kRows * w, bb);
        tma_load_4d(do_s + (w * C::kChunks + c) * C::kBox, &do_map, qd_full,
                    64 * c, hh, q0 + C::kRows * w, bb);
      }
    for (int i = 0; i < min(kStages, n_tiles); ++i) load_tile(i);
  }
  __syncthreads();

  // ---- warpgroup wg: query rows [r_first, r_first + 64) ----
  const int wg = warp / 4;
  const int r_first = q0 + C::kRows * wg;
  const bool active = r_first < p.sq;
  const int row0 = r_first + 16 * (warp % 4) + lane / 4;   // and row0 + 8
  const int w_last = min(r_first + C::kRows - 1, p.sq - 1);
  // keys valid for some row of the warpgroup, and keys valid for all 64
  const int wk_hi = p.causal ? min(p.sk, w_last + off + 1) : p.sk;
  const int wk_lo = p.has_window ? r_first + off - p.window + 1 : 0;
  const int full_hi = p.causal ? min(p.sk, r_first + off + 1) : p.sk;
  const int full_lo =
      p.has_window ? r_first + C::kRows - 1 + off - p.window + 1 : 0;
  // the rows' lse2 and delta (padded rows: +inf and 0; sqp covers every
  // row of the grid)
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t at =
        (static_cast<int64_t>(bb) * p.h + hh) * p.sqp + row0 + 8 * r;
    lse_r[r] = p.lse2[at];
    dl_r[r] = p.delta[at];
  }
  const uint8_t* q_mine = q_s + wg * C::kTile;
  const uint8_t* do_mine = do_s + wg * C::kTile;

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

  if (active) mbar_wait(qd_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    const uint32_t parity = (i / kStages) & 1;
    const int k0 = (t_first + i) * C::kRows;
    const bool compute = active && k0 < wk_hi && k0 + C::kRows > wk_lo;
    const bool masked = k0 < full_lo || k0 + C::kRows > full_hi;

    mbar_wait(&full[s], parity);
    if (compute) {
      const uint8_t* k_tile = k_s + s * C::kTile;
      const uint8_t* v_tile = v_s + s * C::kTile;
      float sc[C::kRows / 2], dp[C::kRows / 2];   // S, dP: 64 x 64
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, in = 32 * (kk % 4);
        Wgmma<C::kRows>::template ss<0>(
            sc, desc_sw128(q_mine + c * C::kBox + in, 16, 1024),
            desc_sw128(k_tile + c * C::kBox + in, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, in = 32 * (kk % 4);
        Wgmma<C::kRows>::template ss<0>(
            dp, desc_sw128(do_mine + c * C::kBox + in, 16, 1024),
            desc_sw128(v_tile + c * C::kBox + in, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS, 16 keys (one A fragment) at a time
      uint32_t da[C::kRows / 4];
#pragma unroll
      for (int f = 0; f < C::kRows / 16; ++f) {
        float dsv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = 8 * f + u;
          const int e = u % 4;
          bool valid = true;
          if (masked) {
            const int key = k0 + 16 * f + 8 * (u / 4) + 2 * (lane % 4) +
                            (e % 2);
            const int q_pos = row0 + 8 * (e / 2) + off;
            valid = key < p.sk;
            if (p.causal) valid = valid && key <= q_pos;
            if (p.has_window) valid = valid && key > q_pos - p.window;
          }
          float pr;
          p_and_ds(p, sc[idx], dp[idx], lse_r[e / 2], dl_r[e / 2], valid, pr,
                   dsv[u]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[4 * f + r] = pack_bf16(dsv[2 * r], dsv[2 * r + 1]);
      }

      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int f = 0; f < C::kRows / 16; ++f) {
        const uint32_t a[4] = {da[4 * f], da[4 * f + 1], da[4 * f + 2],
                               da[4 * f + 3]};
        Wgmma<D>::template rs<1>(
            dq, a, desc_sw128(k_tile + f * 16 * 128, C::kBox, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      fence_regs(da);
    }
    release(i);
  }
  if (!active) return;

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.sq) continue;
    __nv_bfloat16* out =
        p.dq + ((static_cast<int64_t>(bb) * p.sq + row) * p.h + hh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

// Encodes the four tensor maps (boxes of 64 rows) and launches dK/dV, the
// sum of the partials when there are several splits, and dQ, in that
// order on `stream`.  Returns 0, a cudaError_t, or a hopper:: status code
// when a tensor map cannot be encoded.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const Params& p, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, long long d_sb, long long d_ss,
           long long d_sh, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qm, km, vm, dm;
  int rc = hopper::encode_bshd_bf16(&qm, q, p.b, p.sq, p.h, D, q_sb, q_ss,
                                    q_sh, C::kRows);
  if (rc == 0)
    rc = hopper::encode_bshd_bf16(&km, k, p.b, p.sk, p.kh, D, k_sb, k_ss,
                                  k_sh, C::kRows);
  if (rc == 0)
    rc = hopper::encode_bshd_bf16(&vm, v, p.b, p.sk, p.kh, D, v_sb, v_ss,
                                  v_sh, C::kRows);
  if (rc == 0)
    rc = hopper::encode_bshd_bf16(&dm, dout, p.b, p.sq, p.h, D, d_sb, d_ss,
                                  d_sh, C::kRows);
  if (rc != 0) return rc;
  // above 48 KB a block gets dynamic shared memory only after opting in;
  // done once per instance, at its first launch
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dkdv_wgmma_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmemKV);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dq_wgmma_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmemQ);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long key_tiles = (p.sk + C::kBlockRows - 1) / C::kBlockRows;
  const long long blocks = key_tiles * p.b * p.kh * p.splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fa_bwd_dkdv_wgmma_kernel<D>
      <<<static_cast<unsigned>(blocks), C::kThreads, C::kSmemKV, stream>>>(
          qm, km, vm, dm, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (p.splits > 1) {
    const long long n4 = static_cast<long long>(p.b) * p.sk * p.kh * D / 4;
    const long long grid = (2 * n4 + 255) / 256;
    fa_bwd_sum_kernel<<<static_cast<unsigned>(grid < 65536 ? grid : 65536),
                        256, 0, stream>>>(p.ws, p.dk, p.dv, 4 * n4,
                                          p.splits);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.sq + C::kBlockRows - 1) / C::kBlockRows, p.h, p.b);
  fa_bwd_dq_wgmma_kernel<D><<<grid, C::kThreads, C::kSmemQ, stream>>>(
      qm, km, vm, dm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa_bwd_wgmma
