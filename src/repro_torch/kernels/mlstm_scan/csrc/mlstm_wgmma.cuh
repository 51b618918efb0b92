// Chunkwise mLSTM on the tensor cores: bf16 q, k, v at head dim 512
// (xlstm-350m: inner 2048 over 4 heads), wgmma fed by TMA.  Included by
// mlstm_scan.cu, which holds the C entry point and the CUDA-core kernel
// that f32 calls and the other head dims keep.
//
// The row max first.  The reference's running max over the gate part
// ends at m_t = max(max_{s<=t} (F_t - F_s) + i_s, 0.1 NEG): it depends on
// the gates alone, and equals F_t + M_t with M_t = max_{s<=t} (i_s - F_s),
// a prefix max.  So a first kernel (mlstm_gates_kernel) forms F =
// cumsum(log f) and M by block scans in a fixed order and writes, as
// contiguous (B * H, S) planes, g_s = (i_s - F_s) log2(e) for each key and
// c_t = log2(D^-1/2) - M_t log2(e), exp(-m_t) and m_t for each row (m for
// the backward's row stats, which the epilogue writes on request).  Every
// weight, with the scale folded in, is then final: D^-1/2 w = 2^(c_t +
// g_s), one add and one exp2 a (row, key) pair, and the accumulators need
// no rescale per key tile; key splits of one query tile merge by adding
// their (num, den) in split order.  m is the reference's up to the
// rounding of F_t + M_t (a few ulps of |F|, as F's own rounding).  Two
// alternatives measured slower on an H100 at xlstm-350m's shape: PyTorch's
// cumsum over the sequence axis of the (B, S, H) gates, 0.17 ms, more than
// the product, and m by evaluating every (F_t - F_s) + i_s, ~10 us.
//
// Block: 64 query rows of one (batch row, head) and one split of their
// keys: two warpgroups, each owning half of the head dim (256).  The
// block loads Q once (8 boxes of 64 rows x 64 dims) and K (with its keys'
// g), V in tiles of 32 keys through a ring of two stages (32 + 32 KB a
// stage), by TMA over 4-D tensor maps on the tensors' own strides (zeros
// past S), each warp issuing one box of each.  Per key tile i, warpgroup j:
//   - S_j = Q[:, half_j] . K[:, half_j]^T (m64n32k16, both operands in
//     shared memory, K-major) in two chains of 128 head dims added in f32:
//     a wgmma chain adds with its terms aligned to the largest and cut
//     towards zero, so chains stay at 128 (PERF.md, PR 14);
//   - S_j goes to shared memory, one named barrier, and S = S_0 + S_1 in
//     f32 (16 KB a tile, double-buffered so one barrier a tile suffices);
//     past the barrier both groups are done with K(i) and V(i - 1), so
//     the warps load K(i + 2) and V(i + 1) into their stages: no release
//     count, no fence, no wait;
//   - a = 2^(c_t + g_s) S, 0 above the diagonal and past S (a select);
//     den += a per thread in key order;
//   - O_j += a . V[:, half_j] (m64n256k16, a from registers as two bf16
//     terms, bf16(a) and bf16(a - bf16(a)), V through the transpose bit),
//     the second 16 keys' a formed while the first 16 keys' products run.
//     One bf16 term would round a to 8 bits; den cancels, and the plain
//     version in bf16, which rounds a so, lands 0.375 off the plain
//     version in f32 at xlstm-350m's shape (PERF.md, PR 13).
// Both warpgroups compute the same a, bit for bit (addition commutes).
// Tiles above the diagonal are never visited (exact: their w is 0).
//
// Balance: 4 heads x 32 query tiles give 128 blocks of 2 to 64 key tiles,
// one wave whose longest block is twice the call's bound.  kernel.py's
// plan cuts each query tile's keys into splits of `chunk_tiles` key tiles
// (the total work over the SMs, at least 4), the heaviest query tiles
// first.  A query tile of one split normalises and stores its rows; one
// of several writes its (num, den) to scratch in the accumulator layout,
// counts itself done with an integer atomic, and the last of the splits
// to finish adds every split's partials in split order, then normalises
// and stores.  Sums have fixed orders and no float atomics, so two
// launches give the same bits.  out = num / max(|den|, exp(-m)) in f32,
// rows < S stored as bf16.
//
// Bound on this card: operations, 4 flops per valid (query, key, head,
// dim) at 989 TFLOP/s bf16: 0.0174 ms at (1, 2048, 4, 512).  The kernel
// does 1.5 times that on the tensor cores (a in two terms), and what
// holds it back is shared memory: every 32-key tile re-reads the block's
// Q for the scores (64 KB) beside the K, V and S traffic, and the two
// warpgroups, tied by the exchange, wait on each other's products.
#pragma once

#include "hopper.cuh"

namespace mlstm_wgmma {

constexpr float kNeg = -1e30f;
constexpr float kGuard = 0.1f * kNeg;             // masked-block guard

template <int D>
struct Cfg {
  static constexpr int kRows = 64;                // query rows a block
  static constexpr int kBlockN = 32;              // keys a tile
  static constexpr int kStages = 2;
  static constexpr int kGroups = 2;               // warpgroups, half D each
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kHalf = D / kGroups;       // head dims a warpgroup
  static constexpr int kSliceK = 128;             // head dims an S chain
  static_assert(kHalf == 2 * kSliceK, "two S chains a warpgroup");
  static constexpr int kChunks = D / 64;          // 128-byte boxes a row
  static constexpr int kBoxQ = kRows * 128;       // bytes of a 64-row box
  static constexpr int kBoxKV = kBlockN * 128;
  static constexpr int kQBytes = kChunks * kBoxQ;
  static constexpr int kTileBytes = kChunks * kBoxKV;     // one K or V tile
  static constexpr int kXFloats = kRows * kBlockN;        // a partial S
  static constexpr int kGateBytes = kBlockN * 4;          // a tile's g
  static constexpr int kAcc = kHalf / 2;          // O floats a thread
  static constexpr int kSmem = 1024 + kQBytes + 2 * kStages * kTileBytes +
                               2 * kGroups * kXFloats * 4 +
                               kStages * kGateBytes + 128;
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

struct Params {
  const float* gates;         // (4, B * H, sp): g, c, exp(-m) and m
  __nv_bfloat16* o;           // (B, S, H, D) contiguous
  float* ws;                  // split partials: num, accumulator layout
  float* ws_den;              // and den, two a thread
  int* done;                  // splits done, per split query tile and (b, h)
  int s, h, bh, sp;            // sp: S rounded up to the 64-row tile
  int chunk_tiles;            // key tiles a split
  float* lse;                 // row stats (B, S, H) f32, or null: none
  float* sg;
};

// key tiles of query tile qt's keys [0, min(64 (qt + 1), S))
__host__ __device__ __forceinline__ int key_tiles(int qt, int s) {
  const int hi = 64 * (qt + 1) < s ? 64 * (qt + 1) : s;
  return (hi + 31) / 32;
}

__host__ __device__ __forceinline__ int n_splits(int qt, int s, int chunk) {
  return (key_tiles(qt, s) + chunk - 1) / chunk;
}

constexpr int kScanThreads = 256;
constexpr int kScanChunk = 8 * kScanThreads;     // keys a scan step

// The gate planes: one block per ((b, h), 64-row query tile).  F and M
// over keys [0, min(q0 + 64, S)) in chunks of kScanChunk: each thread 8
// keys in order, then the lanes, the warps and the chunk's carry (every
// block of a (b, h) runs the same chunks, so the planes have the same bits
// in all of them).  Writes g, c, exp(-m) and m of the tile's 64 rows to
// gates (4, B * H, sp); a row past S sees log f = log i = 0, and is never
// stored.  Block (0, 0) also zeroes the split counters, which the main
// kernel, next on the stream, counts up.
__global__ void __launch_bounds__(kScanThreads)
mlstm_gates_kernel(const float* __restrict__ lf,
                   const float* __restrict__ li, long long g_sb,
                   long long g_ss, int s, int h, int sp, int bh_count,
                   float log2_scale, float* __restrict__ gates,
                   int* __restrict__ done, int n_done) {
  constexpr float kLog2e = 1.4426950408889634f;
  __shared__ float warp_sum[kScanThreads / 32], warp_max[kScanThreads / 32];
  __shared__ float carry_s[2];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.x, q0 = 64 * blockIdx.y;
  const int k_end = q0 + 64;                      // the tile's last row + 1
  const float* lfp = lf + (bh / h) * g_sb + bh % h;
  const float* lip = li + (bh / h) * g_sb + bh % h;
  if (bh == 0 && q0 == 0)
    for (int i = tid; i < n_done; i += kScanThreads) done[i] = 0;

  float carry_f = 0.0f, carry_m = kNeg;
  for (int c0 = 0; c0 < k_end; c0 += kScanChunk) {
    float fv[8], iv[8];
    float run = 0.0f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int key = c0 + 8 * tid + u;
      const bool in = key < s && key < k_end;
      const float x = in ? lfp[key * g_ss] : 0.0f;
      iv[u] = in ? lip[key * g_ss] : 0.0f;
      run = u ? run + x : x;
      fv[u] = run;
    }
    // F: the thread's sums, then the lanes and the warps in order
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0f;
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    float before = 0.0f;
    for (int w = 0; w < warp; ++w) before += warp_sum[w];
    const float base = carry_f + (before + excl);
    // M: the running max of i - F, the same way (a max does not round)
    float dv[8], run_m = kNeg;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      fv[u] = base + fv[u];
      dv[u] = iv[u] - fv[u];
      run_m = fmaxf(run_m, dv[u]);
      iv[u] = run_m;                              // now the thread's max
    }
    float incl_m = run_m;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(0xffffffffu, incl_m, off);
      if (lane >= off) incl_m = fmaxf(incl_m, y);
    }
    float excl_m = __shfl_up_sync(0xffffffffu, incl_m, 1);
    if (lane == 0) excl_m = kNeg;
    if (lane == 31) warp_max[warp] = incl_m;
    __syncthreads();
    float before_m = carry_m;
    for (int w = 0; w < warp; ++w) before_m = fmaxf(before_m, warp_max[w]);
    before_m = fmaxf(before_m, excl_m);
    // the tile's rows lie in the last chunk
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int key = c0 + 8 * tid + u;
      const float mm = fmaxf(before_m, iv[u]);    // M at this key
      if (key >= q0 && key < k_end) {
        const long long row = static_cast<long long>(bh) * sp + key;
        const long long plane = static_cast<long long>(bh_count) * sp;
        gates[row] = dv[u] * kLog2e;
        gates[plane + row] = log2_scale - mm * kLog2e;
        const float m = fmaxf(fv[u] + mm, kGuard);
        gates[2 * plane + row] = expf(-m);
        gates[3 * plane + row] = m;
      }
      if (key == c0 + kScanChunk - 1) {
        carry_s[0] = fv[u];
        carry_s[1] = mm;
      }
    }
    __syncthreads();
    carry_f = carry_s[0];
    carry_m = carry_s[1];
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
mlstm_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const Params p) {
  using C = Cfg<D>;
  using namespace hopper;
  extern __shared__ __align__(1024) uint8_t mlstm_smem[];
  // the tiles' base rounded up to 1024 bytes, as an offset from the shared
  // array so that the compiler keeps every pointer below in the shared
  // window (shared-memory loads and stores, not generic ones)
  uint8_t* q_s = mlstm_smem + ((1024 - (smem_u32(mlstm_smem) & 1023)) & 1023);
  uint8_t* k_s = q_s + C::kQBytes;                // [stage][chunk][32][64]
  uint8_t* v_s = k_s + C::kStages * C::kTileBytes;
  float* xs = reinterpret_cast<float*>(v_s + C::kStages * C::kTileBytes);
  float* g_s = xs + 2 * C::kGroups * C::kXFloats;  // [stage][32] keys' g
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(g_s + C::kStages * C::kBlockN);
  uint64_t* k_full = q_full + 1;                   // K tile and its g
  uint64_t* v_full = k_full + C::kStages;
  int* last_s = reinterpret_cast<int*>(v_full + C::kStages);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  // the work item: blocks run the query tiles from the last (heaviest)
  // down, each tile's splits in order, the (b, h) pairs innermost
  const int bh = blockIdx.x % p.bh;
  const int item = blockIdx.x / p.bh;
  int qt = (p.s + 63) / 64 - 1, split = item, ns = 1;
  for (;; --qt) {
    ns = n_splits(qt, p.s, p.chunk_tiles);
    if (split < ns) break;
    split -= ns;
  }
  const int first_item = item - split;            // split 0 of this tile
  const int bb = bh / p.h, hh = bh % p.h;
  const int q0 = 64 * qt;
  const int t_first = split * p.chunk_tiles;
  const int t_end = min(t_first + p.chunk_tiles, key_tiles(qt, p.s));
  const int n_tiles = t_end - t_first;
  const long long plane = static_cast<long long>(p.bh) * p.sp;
  const float* g = p.gates + static_cast<long long>(bh) * p.sp;  // keys
  const float* c_row = g + plane;                               // rows
  const float* e_row = c_row + plane;                           // exp(-m)
  const float* m_row = e_row + plane;                           // m

  // Lane 0 of each warp refills the ring, warp w taking box w of K tile
  // kt (and warp 0 the arrivals and the keys' g) and of V tile vt, a
  // negative index loading nothing; eight warps issue their copies at
  // once.  K and V are released separately: a K tile is read by the
  // scores only, so K(i + 2) may replace K(i) once both warpgroups are past
  // the exchange of tile i, which is also when both are done with V(i - 1).
  // (A copy may land before its expect_tx: the barrier's count of bytes
  // may run negative.)
  static_assert(C::kChunks == C::kThreads / 32, "a box a warp");
  auto refill = [&](int kt, int vt) {
    if (kt >= 0) {
      uint64_t* bar = &k_full[kt % C::kStages];
      if (warp == 0) {
        mbar_arrive_expect_tx(bar, C::kTileBytes + C::kGateBytes);
        bulk_load(g_s + (kt % C::kStages) * C::kBlockN,
                  g + (t_first + kt) * C::kBlockN, C::kGateBytes, bar);
      }
      tma_load_4d(k_s + ((kt % C::kStages) * C::kChunks + warp) * C::kBoxKV,
                  &k_map, bar, 64 * warp, hh, (t_first + kt) * C::kBlockN,
                  bb);
    }
    if (vt >= 0) {
      uint64_t* bar = &v_full[vt % C::kStages];
      if (warp == 0) mbar_arrive_expect_tx(bar, C::kTileBytes);
      tma_load_4d(v_s + ((vt % C::kStages) * C::kChunks + warp) * C::kBoxKV,
                  &v_map, bar, 64 * warp, hh, (t_first + vt) * C::kBlockN,
                  bb);
    }
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
    }
    fence_barrier_init();
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    mbar_arrive_expect_tx(q_full, C::kQBytes);
  }
  __syncthreads();
  if (lane == 0) {
    tma_load_4d(q_s + warp * C::kBoxQ, &q_map, q_full, 64 * warp, hh, q0, bb);
    refill(0, 0);
    if (n_tiles > 1) refill(1, -1);
  }

  // ---- warpgroup wg: head dims [kHalf wg, kHalf (wg + 1)) ----
  const int wg = warp / 4;
  const int gt = tid % 128;                       // thread in the group
  const int row0 = 16 * (warp % 4) + lane / 4;    // and row0 + 8
  float c_r[2], e_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    c_r[r] = c_row[q0 + row0 + 8 * r];
    e_r[r] = e_row[q0 + row0 + 8 * r];
  }
  float acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.0f;
  float den[2] = {0.0f, 0.0f};                    // this thread's keys

  mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::kStages;
    const uint32_t parity = (i / C::kStages) & 1;
    const int k0 = (t_first + i) * C::kBlockN;
    float sa[16], sb[16];
    mbar_wait(&k_full[s], parity);
    // this thread's keys' g, read before the exchange lets the warps refill
    // the stage: accumulator element 4j + e is row row0 + 8 (e / 2), key
    // k0 + 8 j + 2 (lane % 4) + e % 2
    float2 gk[C::kBlockN / 8];
#pragma unroll
    for (int j = 0; j < C::kBlockN / 8; ++j)
      gk[j] = *reinterpret_cast<const float2*>(
          g_s + s * C::kBlockN + 8 * j + 2 * (lane % 4));
    {
      // descriptors of the group's first 16 head dims, stepped by their
      // address field (16-byte units) for the others; laundered so that
      // the compiler recomputes the steps each tile rather than keeping
      // sixteen 64-bit descriptors in registers
      uint64_t dq = desc_sw128(q_s + (C::kHalf / 64) * wg * C::kBoxQ, 16,
                               1024);
      uint64_t dk = desc_sw128(k_s + s * C::kTileBytes +
                               (C::kHalf / 64) * wg * C::kBoxKV, 16, 1024);
      asm volatile("" : "+l"(dq), "+l"(dk));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kHalf / 16; ++kk) {
        const uint64_t da = dq + ((kk / 4) * C::kBoxQ + 32 * (kk % 4)) / 16;
        const uint64_t db = dk + ((kk / 4) * C::kBoxKV + 32 * (kk % 4)) / 16;
        if (kk < C::kSliceK / 16)
          Wgmma<C::kBlockN>::template ss<0>(sa, da, db, kk > 0);
        else
          Wgmma<C::kBlockN>::template ss<0>(sb, da, db,
                                            kk > C::kSliceK / 16);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(sa);
    fence_regs(sb);
    // S = S_0 + S_1 through shared memory, in the accumulator layout
    float* x_mine = xs + ((i & 1) * C::kGroups + wg) * C::kXFloats;
    const float* x_other =
        xs + ((i & 1) * C::kGroups + (1 - wg)) * C::kXFloats;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      sa[e] += sb[e];
      x_mine[e * 128 + gt] = sa[e];
    }
    named_barrier_sync(1, C::kThreads);
    // both warpgroups are done with K(i) and V(i - 1)
    if (lane == 0)
      refill(i + 2 < n_tiles ? i + 2 : -1, i + 1 < n_tiles ? i + 1 : -1);
    // a = D^-1/2 w S = 2^(c_t + g_s) S, 0 above the diagonal and past S,
    // as bf16 A fragments in two terms (accumulator columns 16k..16k+15
    // are A fragment k of a.V), then O_j += a.V.  The second 16 keys' a is
    // formed while the first 16 keys' products run: branch-free (a branch
    // of a thread beside an unfinished wgmma makes ptxas serialise them).
    uint32_t pa[8], pl[8];
    auto form_a = [&](int k) {                    // keys 16k .. 16k + 15
#pragma unroll
      for (int j = 2 * k; j < 2 * k + 2; ++j) {
        float a[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + 8 * j + 2 * (lane % 4) + e % 2;
          const int q_pos = q0 + row0 + 8 * (e / 2);
          const float w = exp2f(c_r[e / 2] + (e % 2 ? gk[j].y : gk[j].x));
          a[e] = (key <= q_pos && key < p.s ? w : 0.0f) *
                 (sa[4 * j + e] + x_other[(4 * j + e) * 128 + gt]);
          den[e / 2] += a[e];
        }
        split_bf16(a[0], a[1], pa[4 * k + 2 * (j % 2)],
                   pl[4 * k + 2 * (j % 2)]);
        split_bf16(a[2], a[3], pa[4 * k + 2 * (j % 2) + 1],
                   pl[4 * k + 2 * (j % 2) + 1]);
      }
    };
    const uint8_t* v_half = v_s + s * C::kTileBytes +
                            (C::kHalf / 64) * wg * C::kBoxKV;
    auto issue_av = [&](int k) {
      uint64_t db = desc_sw128(v_half + k * 16 * 128, C::kBoxKV, 1024);
      asm volatile("" : "+l"(db));
      const uint32_t hi[4] = {pa[4 * k], pa[4 * k + 1], pa[4 * k + 2],
                              pa[4 * k + 3]};
      const uint32_t lo[4] = {pl[4 * k], pl[4 * k + 1], pl[4 * k + 2],
                              pl[4 * k + 3]};
      wgmma_fence();
      Wgmma<C::kHalf>::template rs<1>(acc, hi, db, 1);
      Wgmma<C::kHalf>::template rs<1>(acc, lo, db, 1);
      wgmma_commit();
    };
    form_a(0);
    mbar_wait(&v_full[s], parity);
    fence_regs(acc);
    issue_av(0);
    form_a(1);
    issue_av(1);
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    fence_regs(pl);
  }

  // den over the four lanes of a row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 1);
    den[r] += __shfl_xor_sync(0xffffffffu, den[r], 2);
  }

  if (ns > 1) {
    // this split's partials, then the last split to finish adds them all
    const long long slot = blockIdx.x;
    float4* wsv = reinterpret_cast<float4*>(p.ws);
#pragma unroll
    for (int q = 0; q < C::kAcc / 4; ++q)
      wsv[(slot * (C::kAcc / 4) + q) * C::kThreads + tid] =
          make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                      acc[4 * q + 3]);
    reinterpret_cast<float2*>(p.ws_den)[slot * C::kThreads + tid] =
        make_float2(den[0], den[1]);
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int tile = (p.s + 63) / 64 - 1 - qt;  // < n_split_tiles
      *last_s = atomicAdd(&p.done[tile * p.bh + bh], 1) == ns - 1;
    }
    __syncthreads();
    if (!*last_s) return;
    __threadfence();
    // (0 + p_0) + p_1 + ...: the same sum in whichever block is last
#pragma unroll
    for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.0f;
    den[0] = den[1] = 0.0f;
    const long long slot0 = static_cast<long long>(first_item) * p.bh + bh;
    const float4* part = wsv + slot0 * (C::kAcc / 4) * C::kThreads + tid;
    const float2* part_den = reinterpret_cast<const float2*>(p.ws_den) +
                             slot0 * C::kThreads + tid;
    for (int j = 0; j < ns; ++j) {
#pragma unroll
      for (int q = 0; q < C::kAcc / 4; ++q) {
        const float4 x = __ldcg(part + q * C::kThreads);
        acc[4 * q] += x.x;
        acc[4 * q + 1] += x.y;
        acc[4 * q + 2] += x.z;
        acc[4 * q + 3] += x.w;
      }
      const float2 d2 = __ldcg(part_den);
      den[0] += d2.x;
      den[1] += d2.y;
      part += static_cast<long long>(p.bh) * (C::kAcc / 4) * C::kThreads;
      part_den += static_cast<long long>(p.bh) * C::kThreads;
    }
  }

  // out = num / max(|den|, exp(-m)), rows < S; on request the row stats
  // L = m + log n and sg = sign(den) where |den| > exp(-m), else 0
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= p.s) continue;
    const float norm = fmaxf(fabsf(den[r]), e_r[r]);
    if (p.lse != nullptr && wg == 0 && lane % 4 == 0) {
      const int64_t at = (static_cast<int64_t>(bb) * p.s + row) * p.h + hh;
      p.lse[at] = m_row[row] + logf(norm);
      p.sg[at] = fabsf(den[r]) > e_r[r] ? copysignf(1.0f, den[r]) : 0.0f;
    }
    __nv_bfloat16* orow =
        p.o + ((static_cast<int64_t>(bb) * p.s + row) * p.h + hh) * D +
        C::kHalf * wg;
#pragma unroll
    for (int j = 0; j < C::kHalf / 8; ++j) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / norm, acc[4 * j + 2 * r + 1] / norm);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane % 4)) = v2;
    }
  }
}

// Encodes the three tensor maps on the host (they travel by value as
// __grid_constant__ parameters, so the launch can be captured into a CUDA
// graph) and launches.  Returns 0, a cudaError_t, or a hopper:: status
// code when a tensor map cannot be encoded.
template <int D>
int launch(const void* q, const void* k, const void* v, const float* lf,
           const float* li, long long g_sb, long long g_ss, float log2_scale,
           float* gates, const Params& p, long long b, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh,
           long long v_sb, long long v_ss, long long v_sh, long long items,
           int n_done, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qm, km, vm;
  int rc = hopper::encode_bshd_bf16(&qm, q, b, p.s, p.h, D, q_sb, q_ss, q_sh,
                                    C::kRows);
  if (rc == 0)
    rc = hopper::encode_bshd_bf16(&km, k, b, p.s, p.h, D, k_sb, k_ss, k_sh,
                                  C::kBlockN);
  if (rc == 0)
    rc = hopper::encode_bshd_bf16(&vm, v, b, p.s, p.h, D, v_sb, v_ss, v_sh,
                                  C::kBlockN);
  if (rc != 0) return rc;
  static const cudaError_t attr = cudaFuncSetAttribute(
      mlstm_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  mlstm_gates_kernel<<<dim3(static_cast<unsigned>(p.bh),
                            static_cast<unsigned>(p.sp / 64)),
                       kScanThreads, 0, stream>>>(lf, li, g_sb, g_ss, p.s,
                                                  p.h, p.sp, p.bh, log2_scale,
                                                  gates, p.done, n_done);
  const cudaError_t gate_rc = cudaGetLastError();
  if (gate_rc != cudaSuccess) return static_cast<int>(gate_rc);
  mlstm_wgmma_kernel<D><<<static_cast<unsigned>(items * p.bh), C::kThreads,
                          C::kSmem, stream>>>(qm, km, vm, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mlstm_wgmma
