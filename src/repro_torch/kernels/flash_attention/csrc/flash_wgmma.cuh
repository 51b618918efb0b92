// Prefill flash attention on the tensor cores: bf16, head dim 64, 128 or
// 256 (every config of the port), wgmma fed by TMA.  Included by
// flash_attention.cu, which holds the function's definition and its
// dispatch.
//
// Block: one per (tile of 128 query rows, q head, batch row), heaviest
// causal tiles first; two warpgroups own 64 query rows each.  Thread 0
// issues the first loads:
//   - Q: the block's 128 rows once, as D/64 boxes per warpgroup;
//   - K, V: tiles of kBlockN keys (128, or 64 at D = 256) through a ring
//     of kStages stages; each stage has a full barrier for K and one for V
//     (TMA completes them).  The first kStages tiles are issued up front;
//     when a warpgroup is done with tile i it counts its release of the
//     stage, and the second of the two to do so loads tile i + kStages
//     into it.  Neither waits for the other, so one may run up to
//     kStages - 1 tiles ahead, and the two overlap one's softmax with the
//     other's wgmma.
// The 4-D tensor maps (D, heads, seq, batch) use the tensors' own strides,
// so a ragged last Q or K tile is zero-filled per dimension and never read
// from the next batch row or head.
//
// Per tile a warpgroup computes S = Q.K^T with wgmma (both operands in
// shared memory, K-major), at D = 256 in two accumulators of 128 head
// dims each, added in f32: a wgmma adds into its accumulator with its
// terms aligned to the largest and cut towards zero, so one chain of 16
// over the full head dim ends up to ~8.6 u |s| below |s| (u = 2^-24)
// where recurrentgemma-9b's scores reach ~5e3, against ~3.4 u |s| for f32
// FMAs in order; two chains of 8 end within ~5.1 u |s| and halve the
// bias (scripts/flash_conditioning.py, on an H100).  Then in f32
// registers: the softcap, the mask
// (only on tiles that straddle the causal diagonal, the window's edge or
// Sk) and the online softmax with the 0.1.NEG_INF guard, its running max
// taken on the unscaled scores and exp run in base 2 on s c - m c in one
// fused multiply-add, c = scale.log2(e): q is never rounded after
// scaling, and scaling each score before the max would round it by
// ~|s| 2^-24, which recurrentgemma's scores of ~1e3 turn into errors past
// the tolerance.  P goes straight from the accumulator layout into
// wgmma's A-register layout
// (they coincide) as two bf16 terms, bf16(P) and bf16(P - bf16(P)), and
// O += P.V runs once for each, with A from registers and V from shared
// memory through the transpose bit (V's head dim is contiguous).  One
// bf16 term would round P to 8 bits: against the plain version in f32
// that is off by up to 2^-9 |v|, outside the 2e-2 tolerance once |v|
// passes ~10, as in the reduced recurrentgemma (|v| to 52, measured on
// an H100); two terms hold P to ~16 bits for half again the tensor-core work.
// Tiles fully masked for a warpgroup's rows are skipped (exact under the
// guard); the warpgroup still waits for and releases them, so the ring
// stays in step.  The epilogue divides by max(l, 1e-30) and stores rows
// < Sq.  The one atomic counts a stage's releases and touches no data:
// every sum keeps a fixed order, so two launches give the same bits.
//
// Registers: the largest state, D = 256, is a 64 x 256 f32 accumulator
// (128 a thread), S (32) and P (2 x 16) live at once; ptxas needs over
// 200 a thread for it without spilling or serialising the wgmma chain.
// A block of 256 threads may use 255.  A separate producer warp(group)
// would make the block 384 threads, whose launch cap is 168, and ptxas
// (CUDA 12.8) kept the consumers at that cap even after a
// setmaxnreg.inc: D = 128 and 256 spilled and every wgmma waited for the
// one before (measured on an H100).  So a consumer thread issues the
// loads.
#pragma once

#include "hopper.cuh"

namespace fa_wgmma {

constexpr float kNegInf = -1e30f;
constexpr float kGuard = 0.1f * kNegInf;          // masked-block guard

template <int D>
struct Cfg {
  static constexpr int kChunks = D / 64;          // 128-byte boxes a row
  static constexpr int kSliceK = 128;             // head dims an S accumulator
  static_assert(D <= 2 * kSliceK, "S takes at most two accumulators");
  static constexpr int kBlockN = D >= 256 ? 64 : 128;   // keys a tile
  static constexpr int kStages = D >= 256 ? 2 : D >= 128 ? 3 : 4;
  static constexpr int kGroups = 2;               // warpgroups of 64 rows
  static constexpr int kRows = 64 * kGroups;      // query rows a block
  static constexpr int kThreads = 128 * kGroups;
  static constexpr int kBoxQ = 64 * 128;          // bytes of a 64-row box
  static constexpr int kBoxKV = kBlockN * 128;
  static constexpr int kQBytes = kChunks * kBoxQ;          // a group's Q
  static constexpr int kTileBytes = kChunks * kBoxKV;      // one K or V tile
  static constexpr int kSmem = 1024 + kGroups * kQBytes +
                               2 * kStages * kTileBytes + 1024;
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

struct Params {
  __nv_bfloat16* o;                               // (B, Sq, H, D) contiguous
  int sq, sk, h, kh;
  // to base 2 from the units the softmax runs in: scale * log2(e), or
  // log2(e) with a cap (x = cap * tanh(s * scale / cap) is then scaled)
  float to_log2;
  float cap, scale_over_cap;
  int has_cap, causal, has_window, window;
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map,
                   const Params p) {
  using C = Cfg<D>;
  using namespace hopper;
  extern __shared__ __align__(1024) uint8_t wgmma_smem[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(wgmma_smem) + 1023) & ~uintptr_t(1023));
  uint8_t* k_s = q_s + C::kGroups * C::kQBytes;  // [stage][chunk][N][64]
  uint8_t* v_s = k_s + C::kStages * C::kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(v_s +
                                                 C::kStages * C::kTileBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + C::kStages;
  // releases of each stage so far, both warpgroups together
  int* released = reinterpret_cast<int*>(v_full + C::kStages);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::kRows;
  const int hh = blockIdx.y;
  const int bb = blockIdx.z;
  const int kvh = hh / (p.h / p.kh);
  const int off = p.causal ? p.sk - p.sq : 0;     // queries at the last Sq

  // keys [k_lo, k_hi) hold every key valid for some row of the block
  const int row_last = min(q0 + C::kRows, p.sq) - 1;
  const int k_hi = p.causal ? min(p.sk, row_last + off + 1) : p.sk;
  const int k_lo = p.has_window ? max(0, q0 + off - p.window + 1) : 0;
  const int t_first = k_lo / C::kBlockN;
  const int n_tiles = (k_hi + C::kBlockN - 1) / C::kBlockN - t_first;
  if (n_tiles <= 0) {
    // a window of no key (window < 1): every row is masked, the output 0
    for (int idx = tid; idx < C::kRows * D; idx += C::kThreads) {
      const int row = q0 + idx / D;
      if (row < p.sq)
        p.o[((static_cast<int64_t>(bb) * p.sq + row) * p.h + hh) * D +
            idx % D] = __float2bfloat16_rn(0.0f);
    }
    return;
  }

  // tile i into its stage (one thread)
  auto load_tile = [&](int i) {
    const int s = i % C::kStages;
    const int k0 = (t_first + i) * C::kBlockN;
    mbar_arrive_expect_tx(&k_full[s], C::kTileBytes);
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_4d(k_s + (s * C::kChunks + c) * C::kBoxKV, &k_map,
                  &k_full[s], 64 * c, kvh, k0, bb);
    mbar_arrive_expect_tx(&v_full[s], C::kTileBytes);
    for (int c = 0; c < C::kChunks; ++c)
      tma_load_4d(v_s + (s * C::kChunks + c) * C::kBoxKV, &v_map,
                  &v_full[s], 64 * c, kvh, k0, bb);
  };
  // each warpgroup releases tile i once it has read it; the second to do
  // so (the counter tells which, without waiting) loads tile i + kStages
  // into the stage.  Called with no wgmma in flight: a branch of one
  // thread beside an unfinished wgmma makes ptxas serialise every wgmma.
  auto release = [&](int i) {
    named_barrier_sync(1 + warp / 4, 128);       // the group is done with i
    if (tid % 128 == 0) {
      const int s = i % C::kStages;
      __threadfence_block();          // the group's reads before the count
      const int before = atomicAdd(&released[s], 1);
      __threadfence_block();          // the other group's, before the load
      if (before == C::kGroups * (i / C::kStages + 1) - 1 &&
          i + C::kStages < n_tiles)
        load_tile(i + C::kStages);
    }
    __syncwarp();
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      released[s] = 0;
    }
    fence_barrier_init();
    prefetch_tensor_map(&q_map);
    prefetch_tensor_map(&k_map);
    prefetch_tensor_map(&v_map);
    mbar_arrive_expect_tx(q_full, C::kGroups * C::kQBytes);
    for (int w = 0; w < C::kGroups; ++w)
      for (int c = 0; c < C::kChunks; ++c)
        tma_load_4d(q_s + (w * C::kChunks + c) * C::kBoxQ, &q_map, q_full,
                    64 * c, hh, q0 + 64 * w, bb);
    for (int i = 0; i < min(C::kStages, n_tiles); ++i) load_tile(i);
  }
  __syncthreads();

  // ---- warpgroup wg: query rows [r_first, r_first + 64) ----
  const int wg = warp / 4;
  const int r_first = q0 + 64 * wg;
  const bool active = r_first < p.sq;
  const int row0 = r_first + 16 * (warp % 4) + lane / 4;   // and row0 + 8
  const int w_last = min(r_first + 63, p.sq - 1);
  // keys valid for some row of the warpgroup, and keys valid for all 64
  const int wk_hi = p.causal ? min(p.sk, w_last + off + 1) : p.sk;
  const int wk_lo = p.has_window ? r_first + off - p.window + 1 : 0;
  const int full_hi = p.causal ? min(p.sk, r_first + off + 1) : p.sk;
  const int full_lo = p.has_window ? r_first + 63 + off - p.window + 1 : 0;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};                      // this thread's columns
  const uint8_t* q_mine = q_s + wg * C::kQBytes;

  if (active) mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % C::kStages;
    const uint32_t parity = (i / C::kStages) & 1;
    const int k0 = (t_first + i) * C::kBlockN;
    const bool compute = active && k0 < wk_hi && k0 + C::kBlockN > wk_lo;
    // P as bf16 A fragments, in two terms: pa = bf16(P), pl = bf16(P - pa)
    uint32_t pa[C::kBlockN / 4], pl[C::kBlockN / 4];

    mbar_wait(&k_full[s], parity);
    if (compute) {
      // S over head-dim slices of 128: one accumulator each (two at D =
      // 256), summed in f32 once both are done
      float sc[C::kBlockN / 2], sc_hi[C::kBlockN / 2];
      const uint8_t* k_tile = k_s + s * C::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk / 4, in = 32 * (kk % 4);
        const uint64_t da = desc_sw128(q_mine + c * C::kBoxQ + in, 16, 1024);
        const uint64_t db = desc_sw128(k_tile + c * C::kBoxKV + in, 16, 1024);
        if (kk < C::kSliceK / 16)
          Wgmma<C::kBlockN>::template ss<0>(sc, da, db, kk > 0);
        else
          Wgmma<C::kBlockN>::template ss<0>(sc_hi, da, db,
                                            kk > C::kSliceK / 16);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if constexpr (D > C::kSliceK) {
        fence_regs(sc_hi);
#pragma unroll
        for (int i = 0; i < C::kBlockN / 2; ++i) sc[i] += sc_hi[i];
      }

      // cap and mask in f32; the running max per row, in the units of the
      // scores before the scale (with a cap, after it)
      const bool masked = k0 < full_lo || k0 + C::kBlockN > full_hi;
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < C::kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e];
          if (p.has_cap) x = p.cap * tanhf(x * p.scale_over_cap);
          if (masked) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + (e % 2);
            const int q_pos = row0 + 8 * (e / 2) + off;
            bool valid = key < p.sk;
            if (p.causal) valid = valid && key <= q_pos;
            if (p.has_window) valid = valid && key > q_pos - p.window;
            x = valid ? x : kNegInf;
          }
          sc[4 * j + e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      }
      // P = 2^(x c - m c), one fused multiply-add a score
      float corr[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] = fmaxf(mx[r], kGuard);
        corr[r] = exp2f((m[r] - mx[r]) * p.to_log2);
        m[r] = mx[r];
        mc[r] = mx[r] * p.to_log2;
      }
      float sum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < C::kBlockN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe =
              exp2f(fmaf(sc[4 * j + e], p.to_log2, -mc[e / 2]));
          sum[e / 2] += pe;
          sc[4 * j + e] = pe;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j + 0] *= corr[0];
        acc[4 * j + 1] *= corr[0];
        acc[4 * j + 2] *= corr[1];
        acc[4 * j + 3] *= corr[1];
      }
      // accumulator columns 16k..16k+15 are A fragment k of P.V
#pragma unroll
      for (int k = 0; k < C::kBlockN / 16; ++k) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split_bf16(sc[8 * k + 2 * r], sc[8 * k + 2 * r + 1], pa[4 * k + r],
                     pl[4 * k + r]);
      }
    }
    mbar_wait(&v_full[s], parity);
    if (compute) {
      const uint8_t* v_tile = v_s + s * C::kTileBytes;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < C::kBlockN / 16; ++k) {
        const uint64_t db = desc_sw128(v_tile + k * 16 * 128, C::kBoxKV, 1024);
        const uint32_t a[4] = {pa[4 * k], pa[4 * k + 1], pa[4 * k + 2],
                               pa[4 * k + 3]};
        const uint32_t a_lo[4] = {pl[4 * k], pl[4 * k + 1], pl[4 * k + 2],
                                  pl[4 * k + 3]};
        Wgmma<D>::template rs<1>(acc, a, db, 1);
        Wgmma<D>::template rs<1>(acc, a_lo, db, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      fence_regs(pl);
    }
    release(i);
  }
  if (!active) return;

  // epilogue: the row sums over the 4 lanes of a row, then out = acc / l
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= p.sq) continue;
    __nv_bfloat16* orow =
        p.o + ((static_cast<int64_t>(bb) * p.sq + row) * p.h + hh) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const __nv_bfloat162 v2 = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] / l[r], acc[4 * j + 2 * r + 1] / l[r]);
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * (lane % 4)) = v2;
    }
  }
}

// Encodes the three tensor maps on the host (the descriptors travel by
// value as __grid_constant__ parameters, so the launch can be captured
// into a CUDA graph) and launches.  Returns 0, a cudaError_t, or a
// hopper:: status code when a tensor map cannot be encoded.
template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p,
           long long b, long long q_sb, long long q_ss, long long q_sh,
           long long k_sb, long long k_ss, long long k_sh, long long v_sb,
           long long v_ss, long long v_sh, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qm, km, vm;
  int rc = hopper::encode_bshd_bf16(&qm, q, b, p.sq, p.h, D, q_sb, q_ss,
                                    q_sh, 64);
  if (rc == 0)
    rc = hopper::encode_bshd_bf16(&km, k, b, p.sk, p.kh, D, k_sb, k_ss, k_sh,
                                  C::kBlockN);
  if (rc == 0)
    rc = hopper::encode_bshd_bf16(&vm, v, b, p.sk, p.kh, D, v_sb, v_ss, v_sh,
                                  C::kBlockN);
  if (rc != 0) return rc;
  // above 48 KB a block gets dynamic shared memory only after opting in;
  // done once per instance, at its first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      C::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((p.sq + C::kRows - 1) / C::kRows),
                  static_cast<unsigned>(p.h), static_cast<unsigned>(b));
  flash_wgmma_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(qm, km, vm,
                                                                  p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa_wgmma
