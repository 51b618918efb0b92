// Backward of the chunkwise mLSTM on the tensor cores: bf16 q, k, v, o, dO
// at head dim 512 (xlstm-350m), wgmma fed by TMA.  Included by
// mlstm_scan_bwd.cu, which holds the formulas, the three small passes (F =
// cumsum(log f), the row and key planes below, d log f's reverse sum), the
// C entry point, and the CUDA-core kernels that f32 calls and the other
// head dims keep.
//
// Inputs beside q, k, v and dO: three f32 planes (3, B * H, sp), sp = S
// rounded up to 64 rows, that the planes pass writes from the forward's
// row stats (L, sg), F and log i:
//   delta_t = sg_t (dO_t . o_t),
//   c_t = (F_t - L_t) log2(e) + log2(D^-1/2),   g_s = (i_s - F_s) log2(e),
// so that W = 2^(c_t + g_s) = E D^-1/2 (one add and one exp2 a pair; c and
// g round |F| ~ 600 to f32, a few 1e-5 of the exponent).  With S the raw
// q . k:  P = W S (= E sc),  dS = W (dP - delta) (= dsc D^-1/2),
//   dV = sum_t P^T dO,  dK = sum_t dS^T Q,  dQ = sum_s dS K,
//   dlogw = P (dP - delta): d log i its column sums, dQ's pass its row sums.
// W depends on the gates alone, so each role forms it where it needs it;
// only dlogw needs S and dP together, and one hand-over gives it.
//
// Two kernels, two warpgroups each, split by role as fa_bwd_*_roles_kernel
// (flash_bwd_wgmma.cuh) at head dim 256; every sum in a fixed order, no
// float atomics:
//
// 1. dK/dV (mlstm_bwd_dkdv_wgmma_kernel): one block per (64 keys, half j of
//    the output's head dim, b, h), the first key blocks (the most rows)
//    first.  K and V of the 64 keys stay in shared memory (128 KB); Q, dO
//    and their c, delta come in stages of 16 rows through a ring of two
//    (32 KB a stage), from the block's diagonal on.  Per stage
//      P role  (warpgroup 0): S^T = K . Q^T (m64n16k16 over all 512 head
//              dims), P^T = W^T S^T as a bf16 A fragment and in f32 into a
//              shared slot; dV_j += P^T . dO[:, 256 j +256) (m64n256k16);
//      dS role (warpgroup 1): dP^T = V . dO^T, dS^T = W^T (dP^T - delta)
//              as a bf16 A fragment; the column sums of P^T (dP^T - delta)
//              from the slot; dK_j += dS^T . Q[:, 256 j +256).
//    dV_j and dK_j are 128 f32 a thread.  64 keys x 512 of both would be
//    the SM's whole register file, so the two halves of the head dim are
//    two blocks, each computing S^T and dP^T in full: 18 D-flops a valid
//    pair in all against the 10 any backward needs.
// 2. dQ (mlstm_bwd_dq_wgmma_kernel): one block per (64 query rows, b, h),
//    heaviest first.  Q and dO stay (128 KB); K, V and the keys' g come in
//    stages of 16 keys through a ring of two.  Per stage the P role forms
//    S and P = W S into the slot; the dS role forms dP, dS = W (dP - delta)
//    into a 128-byte-swizzled bf16 box (the A operand's layout) and the
//    row sums of P (dP - delta) from the slot; then each role adds its
//    half of the head dim, dQ[:, 256 r +256) += dS . K[:, 256 r +256).
//    Barrier 3 hands the slot over, barrier 4 (both roles) dS, as at head
//    dim 256.
//
// Precision: S and dP (and their transposes) in four wgmma chains of 128
// head dims added in f32 as the forward adds them, ((c0 + c1) + (c2 +
// c3)) (a chain longer than 128 truncates: mlstm_wgmma.cuh); P and dS as
// one bf16 term each (the sums of dlogw come from the f32 values).  The
// masks are selects: a pair is valid where key <= row < S, and the planes'
// padding is never read unmasked.  ref.py: mlstm_bwd_split_ref repeats
// this arithmetic in plain PyTorch.
//
// Bound on this card: operations, 10 flops a valid pair and head dim at
// 989 TFLOP/s bf16 (0.0869 ms at xlstm-350m's (2, 2048, 4, 512)); the
// kernels do 1.8 times that on the tensor cores.  What holds them back,
// in order (scripts/mlstm_bwd_ablation.py takes each part out on the
// card): each stage's chain of waits and barriers (a role waits for its
// S or dP products, forms P or dS, hands over, waits for its one large
// product, releases the stage), the 16-row products of S and dP (a
// 16-row B operand reads the 64-row A operand from shared memory for a
// quarter of a k-step's work), and the stage loads (every block re-reads
// its rows or keys from L2: dK/dV ~1 GB, dQ ~0.5 GB at that shape).
#pragma once

#include "hopper.cuh"

// Diagnosis switches, 0 in the package's build: set to 1 (a #define before
// this header), they take a part of the kernels' work out, so that timing
// the rest shows what that part costs (scripts/mlstm_bwd_ablation.py); the
// gradients are then wrong.
//   MLSTM_BWD_SKIP_STAGE_LOADS: after the ring's first kStages stages, a
//     stage's barrier completes with no copy (the products read the stale
//     stage);
//   MLSTM_BWD_SKIP_SMALL_PRODUCTS: the m64n16k16 products of S, S^T, dP
//     and dP^T are not issued (their accumulators are zeros).
#ifndef MLSTM_BWD_SKIP_STAGE_LOADS
#define MLSTM_BWD_SKIP_STAGE_LOADS 0
#endif
#ifndef MLSTM_BWD_SKIP_SMALL_PRODUCTS
#define MLSTM_BWD_SKIP_SMALL_PRODUCTS 0
#endif

namespace mlstm_bwd_wgmma {

constexpr int D = 512;
constexpr int kChunks = D / 64;                 // 128-byte boxes a row
constexpr int kBlock = 64;                      // keys (dK/dV), rows (dQ)
constexpr int kTile = 16;                       // rows (dK/dV), keys (dQ)
constexpr int kStages = 2;
constexpr bool kSkipStageLoads = MLSTM_BWD_SKIP_STAGE_LOADS != 0;
constexpr bool kSkipSmallProducts = MLSTM_BWD_SKIP_SMALL_PRODUCTS != 0;
constexpr int kThreads = 256;                   // two warpgroups
constexpr int kHalf = D / 2;                    // head dims a role outputs
constexpr int kSliceK = 128;                    // head dims a chain
constexpr int kBoxBlock = kBlock * 128;         // bytes of a 64-row box
constexpr int kBoxTile = kTile * 128;           // bytes of a 16-row box
constexpr int kBlockBytes = kChunks * kBoxBlock;        // 64 rows x 512
constexpr int kTileBytes = kChunks * kBoxTile;          // 16 rows x 512
constexpr int kSlotFloats = kBlock * kTile;     // a 64 x 16 f32 tile
constexpr int kAcc = kBlock * kHalf / 128;      // f32 a thread: 128
// dK/dV: K, V; Q, dO stages; their c and delta; two slots
constexpr int kSmemKV = 1024 + 2 * kBlockBytes + 2 * kStages * kTileBytes +
                        kStages * 2 * kTile * 4 + 2 * kSlotFloats * 4 + 128;
// dQ: Q, dO; K, V stages; dS (one 64-row box); the keys' g; the slot
constexpr int kSmemQ = 1024 + 2 * kBlockBytes + 2 * kStages * kTileBytes +
                       kBoxBlock + kStages * kTile * 4 + kSlotFloats * 4 +
                       128;
static_assert(kSmemKV <= 232448 && kSmemQ <= 232448,
              "more shared memory than a block has");
static_assert(D == 4 * kSliceK, "four S chains");

struct Params {
  const float* planes;          // (3, bh, sp): delta, c, g
  __nv_bfloat16* dq;            // (B, S, H, D) contiguous
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* dli;                   // (B, S, H): the column sums
  float* rowsum;                // (B, S, H): the row sums
  int s, h, bh, sp;
};

// S (M = 64 rows of a, N = 16 rows of b; both K-major, kChunks boxes of
// ABox and BBox bytes) over the 512 head dims as four chains of 128, added
// ((c0 + c1) + (c2 + c3)) in f32 once all are done
template <int ABox, int BBox>
__device__ __forceinline__ void dots512(float (&s)[8], const uint8_t* a,
                                        const uint8_t* b) {
  using namespace hopper;
  float c1[8], c2[8], c3[8];
  wgmma_fence();
  if constexpr (kSkipSmallProducts) {
    for (int i = 0; i < 8; ++i) s[i] = c1[i] = c2[i] = c3[i] = 0.0f;
  } else {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk / 4, in = 32 * (kk % 4);
      const uint64_t da = desc_sw128(a + c * ABox + in, 16, 1024);
      const uint64_t db = desc_sw128(b + c * BBox + in, 16, 1024);
      const int step = kk % (kSliceK / 16);
      switch (kk / (kSliceK / 16)) {
        case 0: Wgmma<16>::ss<0>(s, da, db, step > 0); break;
        case 1: Wgmma<16>::ss<0>(c1, da, db, step > 0); break;
        case 2: Wgmma<16>::ss<0>(c2, da, db, step > 0); break;
        default: Wgmma<16>::ss<0>(c3, da, db, step > 0); break;
      }
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(c1);
  fence_regs(c2);
  fence_regs(c3);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = (s[i] + c1[i]) + (c2[i] + c3[i]);
}

// the first 1024-aligned byte of the dynamic shared array, as an offset
// from it (pointers stay in the shared window)
__device__ __forceinline__ uint8_t* aligned_base(uint8_t* smem) {
  return smem + ((1024 - (hopper::smem_u32(smem) & 1023)) & 1023);
}

// ------------------------------------------------------------------------ //
// 1. dK, dV and the column sums
// ------------------------------------------------------------------------ //
__global__ void __launch_bounds__(kThreads, 1)
mlstm_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const Params p) {
  using namespace hopper;
  extern __shared__ __align__(1024) uint8_t dkdv_smem[];
  uint8_t* k_s = aligned_base(dkdv_smem);         // [chunk][64][64]
  uint8_t* v_s = k_s + kBlockBytes;
  uint8_t* q_s = v_s + kBlockBytes;               // [stage][chunk][16][64]
  uint8_t* do_s = q_s + kStages * kTileBytes;
  float* st_s = reinterpret_cast<float*>(do_s + kStages * kTileBytes);
  float* slot_s = st_s + kStages * 2 * kTile;     // [slot][8][128]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(slot_s + 2 * kSlotFloats);
  uint64_t* full = kv_full + 1;
  int* released = reinterpret_cast<int*>(full + kStages);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // block -> (key block, half, (b, h)), key block slowest: the first key
  // blocks, which the most rows see, are scheduled first
  const int kt = blockIdx.x / (2 * p.bh);
  const int half = blockIdx.x % 2;
  const int bh = blockIdx.x / 2 % p.bh;
  const int bb = bh / p.h, hh = bh % p.h;
  const int k0 = kt * kBlock;
  // the stages of 16 rows from the block's diagonal to S
  const int t_first = k0 / kTile;
  const int n_items = (p.s + kTile - 1) / kTile - t_first;
  const int64_t plane = static_cast<int64_t>(p.bh) * p.sp;
  const float* delta_p = p.planes + static_cast<int64_t>(bh) * p.sp;
  const float* c_p = delta_p + plane;
  const float* g_p = c_p + plane;

  auto load_item = [&](int i) {
    const int s = i % kStages;
    if (kSkipStageLoads && i >= kStages) {
      mbar_arrive_expect_tx(&full[s], 0);
      return;
    }
    const int t0 = (t_first + i) * kTile;
    mbar_arrive_expect_tx(&full[s], 2 * kTileBytes + 2 * kTile * 4);
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(q_s + s * kTileBytes + c * kBoxTile, &q_map, &full[s],
                  64 * c, hh, t0, bb);
      tma_load_4d(do_s + s * kTileBytes + c * kBoxTile, &do_map, &full[s],
                  64 * c, hh, t0, bb);
    }
    bulk_load(st_s + s * 2 * kTile, c_p + t0, kTile * 4, &full[s]);
    bulk_load(st_s + s * 2 * kTile + kTile, delta_p + t0, kTile * 4,
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
    mbar_arrive_expect_tx(kv_full, 2 * kBlockBytes);
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(k_s + c * kBoxBlock, &k_map, kv_full, 64 * c, hh, k0, bb);
      tma_load_4d(v_s + c * kBoxBlock, &v_map, kv_full, 64 * c, hh, k0, bb);
    }
    for (int i = 0; i < min(kStages, n_items); ++i) load_item(i);
  }
  __syncthreads();

  const int wg = warp / 4;                        // 0: P role, 1: dS role
  const int lt = tid % 128;                       // column of the slot
  const int key0 = k0 + 16 * (warp % 4) + lane / 4;   // and key0 + 8
  // the keys' g (keys past S: the planes' padding, masked; sp >= k0 + 64)
  const float g_k[2] = {g_p[key0], g_p[key0 + 8]};
  float acc[kAcc];                                // dV_j (P), dK_j (dS)
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.0f;
  // accumulator element 4 j + e of S^T: key key0 + 8 (e / 2), row t0 + 8 j
  // + 2 (lane % 4) + e % 2 (its column col)
  auto weight = [&](int idx, int t0, const float* c_s) {
    const int e = idx % 4;
    const int col = 8 * (idx / 4) + 2 * (lane % 4) + e % 2;
    const int row = t0 + col;
    const float w = exp2f(c_s[col] + g_k[e / 2]);
    return key0 + 8 * (e / 2) <= row && row < p.s ? w : 0.0f;
  };

  mbar_wait(kv_full, 0);
  if (wg == 0) {
    for (int i = 0; i < n_items; ++i) {
      const int s = i % kStages;
      const int t0 = (t_first + i) * kTile;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* q_tile = q_s + s * kTileBytes;
      const uint8_t* do_tile = do_s + s * kTileBytes;
      const float* c_s = st_s + s * 2 * kTile;
      float st[8];                                // S^T: 64 keys x 16 rows
      dots512<kBoxBlock, kBoxTile>(st, k_s, q_tile);
      // the dS role has read this slot's item i - 2
      if (i >= 2) named_barrier_sync(5 + i % 2, 256);
      float* slot = slot_s + (i % 2) * kSlotFloats;
      float pv[8];
#pragma unroll
      for (int idx = 0; idx < 8; ++idx) {
        pv[idx] = weight(idx, t0, c_s) * st[idx];
        slot[idx * 128 + lt] = pv[idx];
      }
      named_barrier_arrive(3 + i % 2, 256);
      // P^T as the A fragment of the 16 rows: accumulator columns 0..15
      uint32_t pa[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[r] = pack_bf16(pv[2 * r], pv[2 * r + 1]);
      fence_regs(acc);
      wgmma_fence();
      Wgmma<kHalf>::rs<1>(
          acc, pa,
          desc_sw128(do_tile + (kHalf / 64) * half * kBoxTile, kBoxTile,
                     1024),
          1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(i);
    }
  } else {
    float col[2] = {0.0f, 0.0f};                  // this thread's rows
    for (int i = 0; i < n_items; ++i) {
      const int s = i % kStages;
      const int t0 = (t_first + i) * kTile;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* q_tile = q_s + s * kTileBytes;
      const uint8_t* do_tile = do_s + s * kTileBytes;
      const float* c_s = st_s + s * 2 * kTile;
      const float* dl_s = c_s + kTile;
      float dpt[8];                               // dP^T: 64 keys x 16 rows
      dots512<kBoxBlock, kBoxTile>(dpt, v_s, do_tile);
      named_barrier_sync(3 + i % 2, 256);         // the P role's P^T
      const float* slot = slot_s + (i % 2) * kSlotFloats;
      float dsv[8];
#pragma unroll
      for (int idx = 0; idx < 8; ++idx) {
        const int col_i = 8 * (idx / 4) + 2 * (lane % 4) + idx % 2;
        const float dpd = dpt[idx] - dl_s[col_i];
        dsv[idx] = weight(idx, t0, c_s) * dpd;
        col[idx % 4 / 2] += slot[idx * 128 + lt] * dpd;
      }
      // the slot is free for item i + 2
      if (i + 2 < n_items) named_barrier_arrive(5 + i % 2, 256);
      uint32_t da[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[r] = pack_bf16(dsv[2 * r], dsv[2 * r + 1]);
      fence_regs(acc);
      wgmma_fence();
      Wgmma<kHalf>::rs<1>(
          acc, da,
          desc_sw128(q_tile + (kHalf / 64) * half * kBoxTile, kBoxTile,
                     1024),
          1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      release(i);
    }
    // d log i: the column sums over the four lanes of a key, one half's
    // blocks storing them
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      col[r] += __shfl_xor_sync(0xffffffffu, col[r], 1);
      col[r] += __shfl_xor_sync(0xffffffffu, col[r], 2);
      const int key = key0 + 8 * r;
      if (half == 0 && lane % 4 == 0 && key < p.s)
        p.dli[(static_cast<int64_t>(bb) * p.s + key) * p.h + hh] = col[r];
    }
  }

  // epilogue: dV (P role) or dK (dS role) of half j; rows key0, key0 + 8,
  // columns 256 j + 8 jj + 2 (lane % 4) + {0, 1}
  __nv_bfloat16* out = wg == 0 ? p.dv : p.dk;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= p.s) continue;
    __nv_bfloat16* row =
        out + ((static_cast<int64_t>(bb) * p.s + key) * p.h + hh) * D +
        kHalf * half;
#pragma unroll
    for (int jj = 0; jj < kHalf / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * jj + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
  }
}

// ------------------------------------------------------------------------ //
// 2. dQ and the row sums
// ------------------------------------------------------------------------ //
__global__ void __launch_bounds__(kThreads, 1)
mlstm_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                          const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap do_map,
                          const Params p) {
  using namespace hopper;
  extern __shared__ __align__(1024) uint8_t dq_smem[];
  uint8_t* q_s = aligned_base(dq_smem);           // [chunk][64][64]
  uint8_t* do_s = q_s + kBlockBytes;
  uint8_t* k_s = do_s + kBlockBytes;              // [stage][chunk][16][64]
  uint8_t* v_s = k_s + kStages * kTileBytes;
  uint8_t* ds_s = v_s + kStages * kTileBytes;     // [64][128 bytes], swizzled
  float* g_s = reinterpret_cast<float*>(ds_s + kBoxBlock);   // [stage][16]
  float* slot = g_s + kStages * kTile;            // [8][128]
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(slot + kSlotFloats);
  uint64_t* full = qd_full + 1;
  int* released = reinterpret_cast<int*>(full + kStages);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // block -> (query tile, (b, h)), (b, h) fastest and the last (heaviest)
  // query tiles first
  const int bh = blockIdx.x % p.bh;
  const int bb = bh / p.h, hh = bh % p.h;
  const int q0 = ((p.s + kBlock - 1) / kBlock - 1 - blockIdx.x / p.bh) *
                 kBlock;
  // the key stages of 16 that some row of the block sees
  const int n_tiles = (min(q0 + kBlock, p.s) + kTile - 1) / kTile;
  const int64_t plane = static_cast<int64_t>(p.bh) * p.sp;
  const float* delta_p = p.planes + static_cast<int64_t>(bh) * p.sp;
  const float* c_p = delta_p + plane;
  const float* g_p = c_p + plane;

  auto load_tile = [&](int i) {
    const int s = i % kStages;
    if (kSkipStageLoads && i >= kStages) {
      mbar_arrive_expect_tx(&full[s], 0);
      return;
    }
    const int k0 = i * kTile;
    mbar_arrive_expect_tx(&full[s], 2 * kTileBytes + kTile * 4);
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(k_s + s * kTileBytes + c * kBoxTile, &k_map, &full[s],
                  64 * c, hh, k0, bb);
      tma_load_4d(v_s + s * kTileBytes + c * kBoxTile, &v_map, &full[s],
                  64 * c, hh, k0, bb);
    }
    bulk_load(g_s + s * kTile, g_p + k0, kTile * 4, &full[s]);
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
    mbar_arrive_expect_tx(qd_full, 2 * kBlockBytes);
    for (int c = 0; c < kChunks; ++c) {
      tma_load_4d(q_s + c * kBoxBlock, &q_map, qd_full, 64 * c, hh, q0, bb);
      tma_load_4d(do_s + c * kBoxBlock, &do_map, qd_full, 64 * c, hh, q0,
                  bb);
    }
    for (int i = 0; i < min(kStages, n_tiles); ++i) load_tile(i);
  }
  __syncthreads();

  const int wg = warp / 4;                        // 0: P role, 1: dS role
  const int lt = tid % 128;
  const int lrow = 16 * (warp % 4) + lane / 4;    // and lrow + 8
  const int row0 = q0 + lrow;
  // the rows' c and delta (rows past S: the planes' padding, masked)
  const float c_r[2] = {c_p[row0], c_p[row0 + 8]};
  const float dl_r[2] = {delta_p[row0], delta_p[row0 + 8]};
  float dq[kAcc];                                 // 64 rows x 256
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dq[i] = 0.0f;
  // accumulator element 4 j + e of S: row row0 + 8 (e / 2), key k0 + 8 j +
  // 2 (lane % 4) + e % 2
  auto weight = [&](int idx, int k0, const float* gk) {
    const int e = idx % 4;
    const int kc = 8 * (idx / 4) + 2 * (lane % 4) + e % 2;
    const int row = row0 + 8 * (e / 2);
    const float w = exp2f(c_r[e / 2] + gk[kc]);
    return k0 + kc <= row && row < p.s ? w : 0.0f;
  };
  // dQ[:, 256 wg, +256) += dS . K[:, 256 wg, +256): dS (64 rows x 16 keys)
  // from its box, K through the transpose bit
  auto add_dq = [&](const uint8_t* k_tile) {
    fence_regs(dq);
    wgmma_fence();
    Wgmma<kHalf>::ss<1>(
        dq, desc_sw128(ds_s, 16, 1024),
        desc_sw128(k_tile + (kHalf / 64) * wg * kBoxTile, kBoxTile, 1024),
        1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
  };

  mbar_wait(qd_full, 0);
  if (wg == 0) {
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* k_tile = k_s + s * kTileBytes;
      float sc[8];                                // S: 64 rows x 16 keys
      dots512<kBoxBlock, kBoxTile>(sc, q_s, k_tile);
      // the slot's last reader passed barrier 4 before this
#pragma unroll
      for (int idx = 0; idx < 8; ++idx)
        slot[idx * 128 + lt] = weight(idx, i * kTile, g_s + s * kTile) *
                               sc[idx];
      named_barrier_arrive(3, 256);               // P written
      named_barrier_sync(4, 256);                 // dS written
      add_dq(k_tile);
      release(i);
    }
  } else {
    float rsum[2] = {0.0f, 0.0f};
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* k_tile = k_s + s * kTileBytes;
      const uint8_t* v_tile = v_s + s * kTileBytes;
      float dp[8];                                // dP: 64 rows x 16 keys
      dots512<kBoxBlock, kBoxTile>(dp, do_s, v_tile);
      // the P role's P, and both roles done reading the last dS
      named_barrier_sync(3, 256);
      // dS into the 128-byte-swizzled box: row r, keys 8 j + 2 (lane % 4)
      // + {0, 1} are 4 bytes at r * 128 + (j ^ r % 8) * 16 + 4 (lane % 4)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int idx = 4 * j + 2 * r;
          const float lo = dp[idx] - dl_r[r], hi = dp[idx + 1] - dl_r[r];
          rsum[r] += slot[idx * 128 + lt] * lo;
          rsum[r] += slot[(idx + 1) * 128 + lt] * hi;
          const float* gk = g_s + s * kTile;
          const int rr = lrow + 8 * r;
          *reinterpret_cast<uint32_t*>(
              ds_s + rr * 128 + ((j ^ (rr % 8)) * 16) + 4 * (lane % 4)) =
              pack_bf16(weight(idx, i * kTile, gk) * lo,
                        weight(idx + 1, i * kTile, gk) * hi);
        }
      }
      fence_proxy_async();                        // dS for the wgmmas
      named_barrier_sync(4, 256);                 // dS written (both roles)
      add_dq(k_tile);
      release(i);
    }
    // the row sums over the four lanes of a row
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 1);
      rsum[r] += __shfl_xor_sync(0xffffffffu, rsum[r], 2);
      const int row = row0 + 8 * r;
      if (lane % 4 == 0 && row < p.s)
        p.rowsum[(static_cast<int64_t>(bb) * p.s + row) * p.h + hh] = rsum[r];
    }
  }

  // epilogue: rows row0, row0 + 8; columns 256 wg + 8 j + 2 (lane % 4)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.s) continue;
    __nv_bfloat16* out =
        p.dq + ((static_cast<int64_t>(bb) * p.s + row) * p.h + hh) * D +
        kHalf * wg;
#pragma unroll
    for (int j = 0; j < kHalf / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

// Encodes the eight tensor maps (each of q, k, v, dO in boxes of 64 rows
// and of 16) and launches dK/dV, then dQ, on `stream`.  Returns 0, a
// cudaError_t, or a hopper:: status code when a tensor map cannot be
// encoded.
inline int launch(const void* q, const void* k, const void* v,
                  const void* dout, const Params& p, long long b,
                  long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh,
                  long long d_sb, long long d_ss, long long d_sh,
                  cudaStream_t stream) {
  const void* base[4] = {q, k, v, dout};
  const long long st[4][3] = {{q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
                              {v_sb, v_ss, v_sh}, {d_sb, d_ss, d_sh}};
  CUtensorMap block[4], tile[4];                  // 64-row and 16-row boxes
  for (int i = 0; i < 4; ++i) {
    int rc = hopper::encode_bshd_bf16(&block[i], base[i], b, p.s, p.h, D,
                                      st[i][0], st[i][1], st[i][2], kBlock);
    if (rc == 0)
      rc = hopper::encode_bshd_bf16(&tile[i], base[i], b, p.s, p.h, D,
                                    st[i][0], st[i][1], st[i][2], kTile);
    if (rc != 0) return rc;
  }
  // above 48 KB a block gets dynamic shared memory only after opting in;
  // done once, at the first launch
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        mlstm_bwd_dkdv_wgmma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemKV);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(mlstm_bwd_dq_wgmma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemQ);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const long long blocks = (p.s + kBlock - 1) / kBlock * p.bh;
  mlstm_bwd_dkdv_wgmma_kernel<<<static_cast<unsigned>(2 * blocks), kThreads,
                                kSmemKV, stream>>>(tile[0], block[1],
                                                   block[2], tile[3], p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mlstm_bwd_dq_wgmma_kernel<<<static_cast<unsigned>(blocks), kThreads,
                              kSmemQ, stream>>>(block[0], tile[1], tile[2],
                                                block[3], p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace mlstm_bwd_wgmma
