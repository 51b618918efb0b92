// Backward of flash attention on the tensor cores: bf16 at head dim 64,
// 128 (every dense config trains at 128) and 256 (recurrentgemma-9b),
// wgmma fed by TMA.  Included by flash_attention_bwd.cu, which holds the
// formulas, the delta pre-pass and the C entry point.
//
// Inputs beside q, k, v and dO: lse2 = lse * log2(e) and delta, two f32
// planes (B, H, sqp) that the pre-pass writes from the forward's lse and
// from dO . O, padded to sqp = Sq rounded up to 128 rows with lse2 = +inf
// and delta = 0, so a padded row's P and dS are exactly 0 and a stage's
// 64 values are one 16-byte-aligned bulk copy.
//
// Two kernels at head dim 64 and 128 (1., 2.), two more at 256 (3.), no
// atomic on data, every sum in a fixed order:
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

// ------------------------------------------------------------------------ //
// 3. Head dim 256: two warpgroups with two roles over one 64-row tile
// ------------------------------------------------------------------------ //
// At D = 256 a warpgroup cannot own 64 keys x all of D for both dK and dV
// (256 f32 a thread before S^T and dP^T; the cap is 255), and K, V for
// 128 keys with three stages of Q and dO pass 227 KB.  So a block holds
// one tile of 64 keys (dK/dV) or 64 query rows (dQ), and its two
// warpgroups split the products by role:
//
// dK/dV (fa_bwd_dkdv_roles_kernel): one block per (64 keys, batch row, kv
// head, run of query heads), items (head, query tile) through a ring of
// two stages of Q, dO, lse2 and delta.  Per item
//   P role  (warpgroup 0): S^T = K . Q^T as two chains of 8 k-steps over
//           D's halves, added in f32 (the forward's S, flash_wgmma.cuh:
//           its lse is only as good as a recompute that matches it);
//           P^T = 2^(S^T c - lse2) as bf16 A fragments; W^T = P^T (1 -
//           t^2) scale in f32 into a shared slot; dV += P^T . dO;
//   dS role (warpgroup 1): dP^T = V . dO^T; reads the slot; dS^T = W^T
//           (dP^T - delta) as bf16 A fragments; dK += dS^T . Q;
// two products of 64 x 64 x 256 each a role.  The slot (64 x 64 f32, one
// column of 32 values per thread, read back by the same thread index of
// the other role, so neither side has a bank conflict) is doubled, so the
// P role runs up to one item ahead; named barriers hand it over (3 + s:
// written, 5 + s: read).  dV (P role) and dK (dS role) are 128 f32 a
// thread.
//
// dQ (fa_bwd_dq_roles_kernel): one block per (64 query rows, q head,
// batch row), Q and dO loaded once, K and V tiles of 64 keys through a
// ring of two stages.  Per tile the P role computes S (two chains) and
// writes W = P (1 - t^2) scale into the slot; the dS role computes dP =
// dO . V^T, forms dS = W (dP - delta) and writes it in bf16 to shared
// memory as one 128-byte-swizzled box (the A operand's layout); then
// each role adds its half of the head dim, dQ[:, 128 r, +128) += dS .
// K[:, 128 r, +128) with dS from shared memory: 1.5 products a role.
// Barrier 3 hands the slot over, barrier 4 (both roles) dS; a single
// slot and a single dS box suffice, because each role's next write comes
// after the other role's pass through barrier 4, or after its own wait
// for the product that read them.
//
// Every sum keeps a fixed order as in 1. and 2.: each wgmma chain in
// order, the items of a block in order, the runs of heads summed by
// fa_bwd_sum_kernel.  Each role waits for its own product group before
// any branch, barrier or release.
struct Roles {
  static constexpr int D = 256;
  static constexpr int kChunks = D / 64;          // 128-byte boxes a row
  static constexpr int kRows = 64;                // keys or rows a block
  static constexpr int kBox = kRows * 128;        // bytes of a 64-row box
  static constexpr int kTile = kChunks * kBox;    // 64 rows x D, bf16
  static constexpr int kThreads = 256;            // two warpgroups
  static constexpr int kStages = 2;
  static constexpr int kHalfK = 8;                // k-steps of an S chain
  static constexpr int kSlotFloats = kRows * kRows;   // 64 x 64 f32
  // dK/dV: K, V; Q, dO stages; their lse2 and delta; two slots
  static constexpr int kSmemKV = 1024 + 2 * kTile + 2 * kStages * kTile +
                                 kStages * 2 * kRows * 4 +
                                 2 * kSlotFloats * 4 + 128;
  // dQ: Q, dO; K, V stages; the slot; dS (one box of bf16)
  static constexpr int kSmemQ = 1024 + 2 * kTile + 2 * kStages * kTile +
                                kSlotFloats * 4 + kBox + 128;
  static_assert(kSmemKV <= 232448 && kSmemQ <= 232448,
                "more shared memory than a block has");
};

// P (0 where masked) and W = P (1 - t^2) scale of one score x (the
// accumulator: unscaled q . k); dS is then W (dP - delta)
__device__ __forceinline__ void p_and_w(const Params& p, float x, float lse2,
                                        bool valid, float& pr, float& w) {
  float t = 0.0f;
  if (p.has_cap) {
    t = tanhf(x * p.scale_over_cap);
    x = p.cap * t;
  }
  pr = valid ? exp2f(fmaf(x, p.c, -lse2)) : 0.0f;
  w = p.has_cap ? pr * (1.0f - t * t) * p.scale : pr * p.scale;
}

// S (or S^T) of one 64 x 64 tile over D = 256 as two chains of kHalfK
// k-steps, one a half of the head dim, added in f32 once both are done:
// a and b are 64-row K-major tiles of D/64 boxes
__device__ __forceinline__ void scores_two_chains(float (&s)[32],
                                                  const uint8_t* a,
                                                  const uint8_t* b) {
  using namespace hopper;
  float hi[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Roles::D / 16; ++kk) {
    const int c = kk / 4, in = 32 * (kk % 4);
    const uint64_t da = desc_sw128(a + c * Roles::kBox + in, 16, 1024);
    const uint64_t db = desc_sw128(b + c * Roles::kBox + in, 16, 1024);
    if (kk < Roles::kHalfK)
      Wgmma<64>::ss<0>(s, da, db, kk > 0);
    else
      Wgmma<64>::ss<0>(hi, da, db, kk > Roles::kHalfK);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(hi);
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] += hi[i];
}

// dP (or dP^T) of one 64 x 64 tile over D = 256, one chain of 16 k-steps
// (dP only scales P: no exponent amplifies its rounding)
__device__ __forceinline__ void dots_one_chain(float (&s)[32],
                                               const uint8_t* a,
                                               const uint8_t* b) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < Roles::D / 16; ++kk) {
    const int c = kk / 4, in = 32 * (kk % 4);
    Wgmma<64>::ss<0>(s, desc_sw128(a + c * Roles::kBox + in, 16, 1024),
                     desc_sw128(b + c * Roles::kBox + in, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

__global__ void __launch_bounds__(Roles::kThreads, 1)
fa_bwd_dkdv_roles_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const Params p) {
  using R = Roles;
  using namespace hopper;
  constexpr int D = R::D;
  constexpr int kStages = R::kStages;
  extern __shared__ __align__(1024) uint8_t roles_kv_smem[];
  uint8_t* k_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(roles_kv_smem) + 1023) & ~uintptr_t(1023));
  uint8_t* v_s = k_s + R::kTile;                  // [chunk][64][64]
  uint8_t* q_s = v_s + R::kTile;                  // [stage][chunk][64][64]
  uint8_t* do_s = q_s + kStages * R::kTile;
  float* st_s = reinterpret_cast<float*>(do_s + kStages * R::kTile);
  float* slot_s = st_s + kStages * 2 * R::kRows;  // [slot][32][128]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(slot_s +
                                                  2 * R::kSlotFloats);
  uint64_t* full = kv_full + 1;
  int* released = reinterpret_cast<int*>(full + kStages);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // block -> (key tile, batch row, kv head, split), key tile slowest
  const int per_tile = p.b * p.kh * p.splits;
  const int kt = blockIdx.x / per_tile;
  int rest = blockIdx.x % per_tile;
  const int split = rest % p.splits;
  rest /= p.splits;
  const int kvh = rest % p.kh;
  const int bb = rest / p.kh;
  const int k0 = kt * R::kRows;
  const int g = p.h / p.kh;
  const int heads = g / p.splits;
  const int h0 = kvh * g + split * heads;
  const int off = p.causal ? p.sk - p.sq : 0;     // queries at the last Sq

  // query rows [q_lo, q_hi) hold every query that sees some key of the
  // tile; each of its query tiles then holds a valid pair
  const int k_last = min(k0 + R::kRows, p.sk) - 1;
  const int q_lo = p.causal ? max(0, k0 - off) : 0;
  const int q_hi = p.has_window ? min(p.sq, k_last - off + p.window) : p.sq;
  const int t_first = q_lo / R::kRows;
  const int nq = q_hi > q_lo ? (q_hi + R::kRows - 1) / R::kRows - t_first
                             : 0;
  const int n_items = heads * nq;

  const int64_t n_out = static_cast<int64_t>(p.b) * p.sk * p.kh * D;
  float* ws_k = p.ws + static_cast<int64_t>(split) * n_out;
  float* ws_v = p.ws + static_cast<int64_t>(p.splits + split) * n_out;
  if (n_items <= 0) {
    // no query sees these keys: their dK and dV are 0
    for (int idx = tid; idx < R::kRows * D; idx += R::kThreads) {
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
    const int q0 = (t_first + i % nq) * R::kRows;
    mbar_arrive_expect_tx(&full[s], 2 * R::kTile + 2 * R::kRows * 4);
    for (int c = 0; c < R::kChunks; ++c) {
      tma_load_4d(q_s + s * R::kTile + c * R::kBox, &q_map, &full[s], 64 * c,
                  hh, q0, bb);
      tma_load_4d(do_s + s * R::kTile + c * R::kBox, &do_map, &full[s],
                  64 * c, hh, q0, bb);
    }
    const int64_t at = (static_cast<int64_t>(bb) * p.h + hh) * p.sqp + q0;
    bulk_load(st_s + s * 2 * R::kRows, p.lse2 + at, R::kRows * 4, &full[s]);
    bulk_load(st_s + s * 2 * R::kRows + R::kRows, p.delta + at, R::kRows * 4,
              &full[s]);
  };
  // each role releases item i once its products on it are done; the
  // second to do so loads item i + kStages into the stage
  auto release = [&](int i) {
    named_barrier_sync(1 + warp / 4, 128);
    if (tid % 128 == 0) {
      const int s = i % kStages;
      __threadfence_block();
      const int before = atomicAdd(&released[s], 1);
      __threadfence_block();
      if (before == 2 * (i / kStages + 1) - 1 && i + kStages < n_items)
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
    mbar_arrive_expect_tx(kv_full, 2 * R::kTile);
    for (int c = 0; c < R::kChunks; ++c) {
      tma_load_4d(k_s + c * R::kBox, &k_map, kv_full, 64 * c, kvh, k0, bb);
      tma_load_4d(v_s + c * R::kBox, &v_map, kv_full, 64 * c, kvh, k0, bb);
    }
    for (int i = 0; i < min(kStages, n_items); ++i) load_item(i);
  }
  __syncthreads();

  const int wg = warp / 4;                        // 0: P role, 1: dS role
  const int lt = tid % 128;                       // column of the slot
  const int key0 = k0 + 16 * (warp % 4) + lane / 4;   // and key0 + 8
  float acc[D / 2];                               // dV (P role), dK (dS)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;

  mbar_wait(kv_full, 0);
  if (wg == 0) {
    for (int i = 0; i < n_items; ++i) {
      const int s = i % kStages;
      const int q0 = (t_first + i % nq) * R::kRows;
      const bool masked =
          (p.causal && k0 + R::kRows - 1 > q0 + off) ||
          (p.has_window && k0 <= q0 + R::kRows - 1 + off - p.window);
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* q_tile = q_s + s * R::kTile;
      const uint8_t* do_tile = do_s + s * R::kTile;
      const float* lse_s = st_s + s * 2 * R::kRows;
      float st[32];                               // S^T: 64 keys x 64 rows
      scores_two_chains(st, k_s, q_tile);

      // the dS role has read this slot's item i - 2
      if (i >= 2) named_barrier_sync(5 + i % 2, 256);
      float* slot = slot_s + (i % 2) * R::kSlotFloats;
      // P^T as bf16 A fragments, 16 queries (fragment f) at a time:
      // accumulator columns 16f..16f+15 are fragment f
      uint32_t pa[16];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        float pv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = 8 * f + u;              // = 4 j + e, j = 2 f + u / 4
          const int e = u % 4;
          const int col = 16 * f + 8 * (u / 4) + 2 * (lane % 4) + (e % 2);
          bool valid = true;
          if (masked) {
            const int key = key0 + 8 * (e / 2);
            const int q_pos = q0 + col + off;
            if (p.causal) valid = key <= q_pos;
            if (p.has_window) valid = valid && key > q_pos - p.window;
          }
          float w;
          p_and_w(p, st[idx], lse_s[col], valid, pv[u], w);
          slot[idx * 128 + lt] = w;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[4 * f + r] = pack_bf16(pv[2 * r], pv[2 * r + 1]);
      }
      named_barrier_arrive(3 + i % 2, 256);

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const uint32_t a[4] = {pa[4 * f], pa[4 * f + 1], pa[4 * f + 2],
                               pa[4 * f + 3]};
        Wgmma<D>::rs<1>(
            acc, a, desc_sw128(do_tile + f * 16 * 128, R::kBox, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(i);
    }
  } else {
    for (int i = 0; i < n_items; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* q_tile = q_s + s * R::kTile;
      const uint8_t* do_tile = do_s + s * R::kTile;
      const float* dl_s = st_s + s * 2 * R::kRows + R::kRows;
      float dpt[32];                              // dP^T: 64 keys x 64 rows
      dots_one_chain(dpt, v_s, do_tile);

      named_barrier_sync(3 + i % 2, 256);         // the P role's W^T
      const float* slot = slot_s + (i % 2) * R::kSlotFloats;
      uint32_t da[16];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        float dsv[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int idx = 8 * f + u;
          const int col = 16 * f + 8 * (u / 4) + 2 * (lane % 4) + (u % 2);
          dsv[u] = slot[idx * 128 + lt] * (dpt[idx] - dl_s[col]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          da[4 * f + r] = pack_bf16(dsv[2 * r], dsv[2 * r + 1]);
      }
      // the slot is free for item i + 2
      if (i + 2 < n_items) named_barrier_arrive(5 + i % 2, 256);

      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const uint32_t a[4] = {da[4 * f], da[4 * f + 1], da[4 * f + 2],
                               da[4 * f + 3]};
        Wgmma<D>::rs<1>(
            acc, a, desc_sw128(q_tile + f * 16 * 128, R::kBox, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      release(i);
    }
  }

  // epilogue: dV (P role) or dK (dS role); rows key0, key0 + 8, columns
  // 8 j + 2 (lane % 4) + {0, 1}
  __nv_bfloat16* out = wg == 0 ? p.dv : p.dk;
  float* ws_out = wg == 0 ? ws_v : ws_k;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.sk) continue;
    const int64_t row =
        ((static_cast<int64_t>(bb) * p.sk + key) * p.kh + kvh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      const float lo = acc[4 * j + 2 * r], hi = acc[4 * j + 2 * r + 1];
      if (p.splits == 1)
        *reinterpret_cast<__nv_bfloat162*>(out + row + col) =
            __floats2bfloat162_rn(lo, hi);
      else
        *reinterpret_cast<float2*>(ws_out + row + col) = make_float2(lo, hi);
    }
  }
}

__global__ void __launch_bounds__(Roles::kThreads, 1)
fa_bwd_dq_roles_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       const __grid_constant__ CUtensorMap do_map,
                       const Params p) {
  using R = Roles;
  using namespace hopper;
  constexpr int D = R::D;
  constexpr int kStages = R::kStages;
  extern __shared__ __align__(1024) uint8_t roles_q_smem[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(roles_q_smem) + 1023) & ~uintptr_t(1023));
  uint8_t* do_s = q_s + R::kTile;                 // [chunk][64][64]
  uint8_t* k_s = do_s + R::kTile;                 // [stage][chunk][64][64]
  uint8_t* v_s = k_s + kStages * R::kTile;
  float* slot = reinterpret_cast<float*>(v_s + kStages * R::kTile);
  uint8_t* ds_s = reinterpret_cast<uint8_t*>(slot + R::kSlotFloats);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(ds_s + R::kBox);
  uint64_t* full = qd_full + 1;
  int* released = reinterpret_cast<int*>(full + kStages);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * R::kRows;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.kh);
  const int off = p.causal ? p.sk - p.sq : 0;

  // keys [k_lo, k_hi) hold every key valid for some row of the block;
  // each of its key tiles then holds a valid pair
  const int row_last = min(q0 + R::kRows, p.sq) - 1;
  const int k_hi = p.causal ? min(p.sk, row_last + off + 1) : p.sk;
  const int k_lo = p.has_window ? max(0, q0 + off - p.window + 1) : 0;
  const int t_first = k_lo / R::kRows;
  const int n_tiles = (k_hi + R::kRows - 1) / R::kRows - t_first;
  if (n_tiles <= 0) {
    // a window of no key: every row is masked, its dq 0
    for (int idx = tid; idx < R::kRows * D; idx += R::kThreads) {
      const int row = q0 + idx / D;
      if (row < p.sq)
        p.dq[((static_cast<int64_t>(bb) * p.sq + row) * p.h + hh) * D +
             idx % D] = __float2bfloat16_rn(0.0f);
    }
    return;
  }

  auto load_tile = [&](int i) {
    const int s = i % kStages;
    const int k0 = (t_first + i) * R::kRows;
    mbar_arrive_expect_tx(&full[s], 2 * R::kTile);
    for (int c = 0; c < R::kChunks; ++c) {
      tma_load_4d(k_s + s * R::kTile + c * R::kBox, &k_map, &full[s], 64 * c,
                  kvh, k0, bb);
      tma_load_4d(v_s + s * R::kTile + c * R::kBox, &v_map, &full[s], 64 * c,
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
      if (before == 2 * (i / kStages + 1) - 1 && i + kStages < n_tiles)
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
    mbar_arrive_expect_tx(qd_full, 2 * R::kTile);
    for (int c = 0; c < R::kChunks; ++c) {
      tma_load_4d(q_s + c * R::kBox, &q_map, qd_full, 64 * c, hh, q0, bb);
      tma_load_4d(do_s + c * R::kBox, &do_map, qd_full, 64 * c, hh, q0, bb);
    }
    for (int i = 0; i < min(kStages, n_tiles); ++i) load_tile(i);
  }
  __syncthreads();

  const int wg = warp / 4;                        // 0: P role, 1: dS role
  const int lt = tid % 128;
  const int row0 = q0 + 16 * (warp % 4) + lane / 4;   // and row0 + 8
  // keys valid for all 64 rows: tiles inside need no mask
  const int full_hi = p.causal ? min(p.sk, q0 + off + 1) : p.sk;
  const int full_lo =
      p.has_window ? q0 + R::kRows - 1 + off - p.window + 1 : 0;
  // this role's half of the head dim: boxes 2 wg and 2 wg + 1 of a K tile
  const int half = wg * (D / 2);
  float dq[D / 4];                                // 64 rows x 128
#pragma unroll
  for (int i = 0; i < D / 4; ++i) dq[i] = 0.0f;

  mbar_wait(qd_full, 0);
  if (wg == 0) {
    // the rows' lse2 (padded rows: +inf; sqp covers every row of the grid)
    float lse_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      lse_r[r] = p.lse2[(static_cast<int64_t>(bb) * p.h + hh) * p.sqp +
                        row0 + 8 * r];
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int k0 = (t_first + i) * R::kRows;
      const bool masked = k0 < full_lo || k0 + R::kRows > full_hi;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* k_tile = k_s + s * R::kTile;
      float sc[32];                               // S: 64 rows x 64 keys
      scores_two_chains(sc, q_s, k_tile);
      // the slot's last reader passed barrier 4 before this
#pragma unroll
      for (int idx = 0; idx < 32; ++idx) {
        const int e = idx % 4;
        bool valid = true;
        if (masked) {
          const int key = k0 + 8 * (idx / 4) + 2 * (lane % 4) + (e % 2);
          const int q_pos = row0 + 8 * (e / 2) + off;
          valid = key < p.sk;
          if (p.causal) valid = valid && key <= q_pos;
          if (p.has_window) valid = valid && key > q_pos - p.window;
        }
        float pr, w;
        p_and_w(p, sc[idx], lse_r[e / 2], valid, pr, w);
        slot[idx * 128 + lt] = w;
      }
      named_barrier_arrive(3, 256);               // W written
      named_barrier_sync(4, 256);                 // dS written

      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R::kRows / 16; ++kk)
        Wgmma<D / 2>::ss<1>(
            dq, desc_sw128(ds_s + 32 * kk, 16, 1024),
            desc_sw128(k_tile + 2 * wg * R::kBox + kk * 16 * 128, R::kBox,
                       1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      release(i);
    }
  } else {
    float dl_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      dl_r[r] = p.delta[(static_cast<int64_t>(bb) * p.h + hh) * p.sqp +
                        row0 + 8 * r];
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* k_tile = k_s + s * R::kTile;
      const uint8_t* v_tile = v_s + s * R::kTile;
      float dp[32];                               // dP: 64 rows x 64 keys
      dots_one_chain(dp, do_s, v_tile);

      named_barrier_sync(3, 256);                 // the P role's W
      // dS into the 128-byte-swizzled box: row r, keys 2 (lane % 4) + 8 j
      // + {0, 1} are 4 bytes at r * 128 + (j ^ r % 8) * 16 + 4 (lane % 4)
#pragma unroll
      for (int j = 0; j < R::kRows / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int idx = 4 * j + 2 * r;
          const float lo = slot[idx * 128 + lt] * (dp[idx] - dl_r[r]);
          const float hi =
              slot[(idx + 1) * 128 + lt] * (dp[idx + 1] - dl_r[r]);
          const int row = 16 * (warp % 4) + lane / 4 + 8 * r;
          *reinterpret_cast<uint32_t*>(
              ds_s + row * 128 + ((j ^ (row % 8)) * 16) + 4 * (lane % 4)) =
              pack_bf16(lo, hi);
        }
      }
      fence_proxy_async();                        // dS for the wgmmas
      named_barrier_sync(4, 256);                 // dS written (both roles)

      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < R::kRows / 16; ++kk)
        Wgmma<D / 2>::ss<1>(
            dq, desc_sw128(ds_s + 32 * kk, 16, 1024),
            desc_sw128(k_tile + 2 * wg * R::kBox + kk * 16 * 128, R::kBox,
                       1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      release(i);
    }
  }

  // epilogue: rows row0, row0 + 8; columns half + 8 j + 2 (lane % 4)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.sq) continue;
    __nv_bfloat16* out =
        p.dq + ((static_cast<int64_t>(bb) * p.sq + row) * p.h + hh) * D +
        half;
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

// The four tensor maps (boxes of 64 rows of D), or a hopper:: status code
inline int encode_maps(CUtensorMap (&m)[4], int d, const void* q,
                       const void* k, const void* v, const void* dout,
                       const Params& p, long long q_sb, long long q_ss,
                       long long q_sh, long long k_sb, long long k_ss,
                       long long k_sh, long long v_sb, long long v_ss,
                       long long v_sh, long long d_sb, long long d_ss,
                       long long d_sh) {
  int rc = hopper::encode_bshd_bf16(&m[0], q, p.b, p.sq, p.h, d, q_sb, q_ss,
                                    q_sh, 64);
  if (rc == 0)
    rc = hopper::encode_bshd_bf16(&m[1], k, p.b, p.sk, p.kh, d, k_sb, k_ss,
                                  k_sh, 64);
  if (rc == 0)
    rc = hopper::encode_bshd_bf16(&m[2], v, p.b, p.sk, p.kh, d, v_sb, v_ss,
                                  v_sh, 64);
  if (rc == 0)
    rc = hopper::encode_bshd_bf16(&m[3], dout, p.b, p.sq, p.h, d, d_sb, d_ss,
                                  d_sh, 64);
  return rc;
}

// the runs' partials summed into dK and dV (several runs only)
inline cudaError_t launch_sum(const Params& p, int d, cudaStream_t stream) {
  if (p.splits == 1) return cudaSuccess;
  const long long n4 = static_cast<long long>(p.b) * p.sk * p.kh * d / 4;
  const long long grid = (2 * n4 + 255) / 256;
  fa_bwd_sum_kernel<<<static_cast<unsigned>(grid < 65536 ? grid : 65536),
                      256, 0, stream>>>(p.ws, p.dk, p.dv, 4 * n4, p.splits);
  return cudaGetLastError();
}

// above 48 KB a block gets dynamic shared memory only after opting in
template <typename KV, typename Q>
cudaError_t allow_smem(KV* dkdv, int smem_kv, Q* dq, int smem_q) {
  cudaError_t e = cudaFuncSetAttribute(
      dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_kv);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_q);
  return e;
}

// Encodes the four tensor maps and launches dK/dV, the sum of the
// partials when there are several splits, and dQ, in that order on
// `stream`: head dim 64 or 128 the kernels of 1. and 2., 256 those of 3.
// Returns 0, a cudaError_t, or a hopper:: status code when a tensor map
// cannot be encoded.
template <int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const Params& p, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, long long d_sb, long long d_ss,
           long long d_sh, cudaStream_t stream) {
  static_assert(D == 64 || D == 128 || D == 256, "head dim 64, 128, 256");
  CUtensorMap m[4];
  const int rc = encode_maps(m, D, q, k, v, dout, p, q_sb, q_ss, q_sh, k_sb,
                             k_ss, k_sh, v_sb, v_ss, v_sh, d_sb, d_ss, d_sh);
  if (rc != 0) return rc;
  // keys of a dK/dV block and query rows of a dQ block
  constexpr int kBlockRows = D == 256 ? Roles::kRows : 128;
  const long long key_tiles = (p.sk + kBlockRows - 1) / kBlockRows;
  const long long blocks = key_tiles * p.b * p.kh * p.splits;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 q_grid((p.sq + kBlockRows - 1) / kBlockRows, p.h, p.b);
  const unsigned kv_grid = static_cast<unsigned>(blocks);
  cudaError_t e;
  // done once per instance, at its first launch
  if constexpr (D == 256) {
    using R = Roles;
    static const cudaError_t attr =
        allow_smem(fa_bwd_dkdv_roles_kernel, R::kSmemKV,
                   fa_bwd_dq_roles_kernel, R::kSmemQ);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    fa_bwd_dkdv_roles_kernel<<<kv_grid, R::kThreads, R::kSmemKV, stream>>>(
        m[0], m[1], m[2], m[3], p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    e = launch_sum(p, D, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    fa_bwd_dq_roles_kernel<<<q_grid, R::kThreads, R::kSmemQ, stream>>>(
        m[0], m[1], m[2], m[3], p);
  } else {
    using C = Cfg<D>;
    static_assert(C::kBlockRows == kBlockRows, "a block's rows");
    static const cudaError_t attr =
        allow_smem(fa_bwd_dkdv_wgmma_kernel<D>, C::kSmemKV,
                   fa_bwd_dq_wgmma_kernel<D>, C::kSmemQ);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    fa_bwd_dkdv_wgmma_kernel<D><<<kv_grid, C::kThreads, C::kSmemKV,
                                  stream>>>(m[0], m[1], m[2], m[3], p);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    e = launch_sum(p, D, stream);
    if (e != cudaSuccess) return static_cast<int>(e);
    fa_bwd_dq_wgmma_kernel<D><<<q_grid, C::kThreads, C::kSmemQ, stream>>>(
        m[0], m[1], m[2], m[3], p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa_bwd_wgmma
