// Decode (and short-Sq) flash attention: bf16, head dim 64, 128 or 256,
// GQA-packed and split over the keys.  Included by flash_attention.cu.
//
// The work is bound by bytes (each K/V element is used by G = H / K query
// heads times Sq rows), so the layout makes every K/V tile be read once:
// one block per (key split, kv head, batch row), whose M rows are the G
// query heads of that kv head times the Sq queries (row r: query r / G,
// head kvh * G + r % G), at most 16: 6 for qwen3-14b (48 / 8), 16 for
// recurrentgemma-9b (16 / 1).  The block's 4 warps stream tiles of 64
// keys through a double-buffered cp.async ring; warp w takes keys
// 16w..16w+15 of each tile and keeps its own online softmax (m, l, acc)
// over them, both products on the tensor cores with mma.sync m16n8k16
// (S = Q.K^T from ldmatrix fragments; P from the accumulator layout,
// which is the A layout, in two bf16 terms as in the prefill kernel; V
// through ldmatrix.trans).  Softcap, mask, the 0.1.NEG_INF guard and the
// exponent act on the f32 scores as in the prefill kernel; the partial
// (m, l) of a split are in the same units.  The four
// warps' states are merged in shared memory in warp order; with one split
// that is the output, otherwise the block writes its split's (m, l, acc)
// in f32 and a second kernel merges the splits in split order
// (log-sum-exp).  The wrapper's plan picks the splits (up to one block an
// SM when Sk is long) and launches the merge only for more than one
// split.  No atomics: two launches give the same bits.
#pragma once

#include "hopper.cuh"

namespace fa_decode {

constexpr float kNegInf = -1e30f;
constexpr float kGuard = 0.1f * kNegInf;          // masked-block guard
constexpr int kRows = 16;                         // packed (head, query) rows
constexpr int kTileK = 64;                        // keys a tile
constexpr int kWarps = 4;                         // 16 keys of a tile each
constexpr int kThreads = 32 * kWarps;

template <int D>
struct Cfg {
  // rows padded by 16 bytes: the 8 row addresses of an ldmatrix hit
  // distinct banks
  static constexpr int kStride = D + 8;
  static constexpr int kTile = kTileK * kStride;  // elements of a K/V tile
  static constexpr int kSmem = 2 * (kRows * kStride + 2 * 2 * kTile);
  // the warps' states, merged after the loop in the K/V ring's place;
  // accumulator rows padded by 8 floats, so the 8 rows a warp's store
  // touches fall in distinct banks
  static constexpr int kAccStride = D + 8;
  static_assert(4 * kWarps * kRows * (kAccStride + 2) + 8 * kRows <=
                    2 * 2 * 2 * kTile,
                "merge scratch larger than the ring");
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;                               // (B, Sq, H, D) contiguous
  float* ws_acc;                                  // (B, K, splits, 16, D)
  float* ws_ml;                                   // (B, K, splits, 16, 2)
  int sq, sk, h, kh, g, rows;                     // rows = G * Sq <= 16
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float to_log2, cap, scale_over_cap;             // as in fa_wgmma::Params
  int has_cap, causal, has_window, window;
  int k_lo, k_hi, chunk, n_splits;                // split s: k_lo + s * chunk
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_decode_kernel(const Params p) {
  using C = Cfg<D>;
  using namespace hopper;
  constexpr int kVecs = D / 8;                    // 16-byte pieces a row
  static_assert(kThreads % kVecs == 0 && kRows % (kThreads / kVecs) == 0,
                "a pass of the block covers whole rows");
  extern __shared__ __align__(16) __nv_bfloat16 decode_smem[];
  __nv_bfloat16* q_s = decode_smem;               // [16][kStride]
  __nv_bfloat16* kv_s = q_s + kRows * C::kStride; // [stage][K|V][64][kStride]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int bb = blockIdx.z;
  const int off = p.causal ? p.sk - p.sq : 0;
  const int lo = p.k_lo + split * p.chunk;
  const int hi = min(lo + p.chunk, p.k_hi);
  const int n_tiles = (hi - lo + kTileK - 1) / kTileK;

  // a thread always copies the same 16 bytes (column c) of rows j0,
  // j0 + kPass, ... of a tile: the rows of tile t that hold keys come by
  // cp.async; V's other rows are zeroed (P is 0 there, and 0 times a stale
  // NaN would not be), K's are left as they are (their scores are masked)
  constexpr int kPass = kThreads / kVecs;         // rows a pass covers
  const int c = 8 * (tid % kVecs);
  const int j0 = tid / kVecs;
  const __nv_bfloat16* k_col = p.k + bb * p.k_sb + kvh * p.k_sh + c;
  const __nv_bfloat16* v_col = p.v + bb * p.v_sb + kvh * p.v_sh + c;
  auto load_tile = [&](int t, int stage) {
    __nv_bfloat16* k_dst = kv_s + (2 * stage) * C::kTile + c;
    __nv_bfloat16* v_dst = k_dst + C::kTile;
    const int first = lo + t * kTileK;
    const int rows = min(kTileK, hi - first);
#pragma unroll
    for (int it = 0; it < kTileK / kPass; ++it) {
      const int j = j0 + it * kPass;
      if (j < rows) {
        const int64_t key = first + j;
        cp_async_16(k_dst + j * C::kStride, k_col + key * p.k_ss, true);
        cp_async_16(v_dst + j * C::kStride, v_col + key * p.v_ss, true);
      } else {
        *reinterpret_cast<uint4*>(v_dst + j * C::kStride) =
            make_uint4(0, 0, 0, 0);
      }
    }
  };

  // Q rows, zero past G * Sq; in the first group with tile 0
#pragma unroll
  for (int it = 0; it < kRows / kPass; ++it) {
    const int r = j0 + it * kPass;
    if (r < p.rows) {
      const int qi = r / p.g, head = kvh * p.g + r % p.g;
      cp_async_16(q_s + r * C::kStride + c,
                  p.q + bb * p.q_sb + qi * p.q_ss + head * p.q_sh + c, true);
    } else {
      *reinterpret_cast<uint4*>(q_s + r * C::kStride + c) =
          make_uint4(0, 0, 0, 0);
    }
  }
  if (n_tiles > 0) load_tile(0, 0);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.0f, 0.0f};                      // this thread's columns
  const int r0 = lane / 4;                        // rows r0 and r0 + 8
  int q_pos[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) q_pos[r] = (r0 + 8 * r) / p.g + off;
  const __nv_bfloat16* q_row = q_s + (lane % 16) * C::kStride + 8 * (lane / 16);

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_tile(t + 1, (t + 1) % 2);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* k_t = kv_s + (2 * (t % 2)) * C::kTile;
    const __nv_bfloat16* v_t = k_t + C::kTile;

    // S (16 rows x this warp's 16 keys) = Q . K^T, the even and odd
    // 16-column steps of the head dim in two chains (half the latency)
    float s[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    float s_odd[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
    const __nv_bfloat16* k_row =
        k_t + (16 * warp + lane % 8 + 8 * (lane / 16)) * C::kStride +
        8 * ((lane / 8) % 2);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      ldmatrix_x4(a, q_row + 16 * kk);
      ldmatrix_x4(b, k_row + 16 * kk);
      float (&chain)[2][4] = kk % 2 ? s_odd : s;
      mma_16816(chain[0], a, b[0], b[1]);
      mma_16816(chain[1], a, b[2], b[3]);
    }

    // cap, mask and the online softmax per row, as in the prefill kernel
    const int k0 = lo + t * kTileK + 16 * warp;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] + s_odd[n][e];
        if (p.has_cap) x = p.cap * tanhf(x * p.scale_over_cap);
        const int key = k0 + 8 * n + 2 * (lane % 4) + (e % 2);
        const int qp = q_pos[e / 2];
        bool valid = key < hi;
        if (p.causal) valid = valid && key <= qp;
        if (p.has_window) valid = valid && key > qp - p.window;
        x = valid ? x : kNegInf;
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
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
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(fmaf(s[n][e], p.to_log2, -mc[e / 2]));
        sum[e / 2] += pe;
        s[n][e] = pe;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
    // P in two bf16 terms, as in the prefill kernel
    uint32_t pa[4], pl[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(s[r / 2][2 * (r % 2)], s[r / 2][2 * (r % 2) + 1], pa[r],
                 pl[r]);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= corr[0];
      acc[j][1] *= corr[0];
      acc[j][2] *= corr[1];
      acc[j][3] *= corr[1];
    }

    // acc (16 x D) += P . V over this warp's 16 keys
    const __nv_bfloat16* v_row =
        v_t + (16 * warp + lane % 8 + 8 * ((lane / 8) % 2)) * C::kStride +
        8 * (lane / 16);
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, v_row + 16 * nd);
      mma_16816(acc[2 * nd], pa, b[0], b[1]);
      mma_16816(acc[2 * nd], pl, b[0], b[1]);
      mma_16816(acc[2 * nd + 1], pa, b[2], b[3]);
      mma_16816(acc[2 * nd + 1], pl, b[2], b[3]);
    }
    __syncthreads();                              // the stage is free again
  }
  cp_async_wait<0>();

  // merge the four warps' states in warp order, through shared memory in
  // the ring's place: the rows' maxima first, then each warp scales its
  // own l and acc by 2^((m_w - M) c), and each thread sums the warps for
  // its columns, row by row
  float* w_m = reinterpret_cast<float*>(kv_s);    // [warp][16]
  float* w_l = w_m + kWarps * kRows;              // [warp][16]
  float* w_acc = w_l + kWarps * kRows;            // [warp][16][kAccStride]
  int64_t* w_out = reinterpret_cast<int64_t*>(w_acc + kWarps * kRows *
                                               C::kAccStride);   // [16]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (lane % 4 == 0) w_m[warp * kRows + r0 + 8 * r] = m[r];
  }
  const int64_t bk = static_cast<int64_t>(bb) * p.kh + kvh;
  if (tid < kRows) {
    // where row tid goes: the output row, or the split's scratch row
    const int qi = tid / p.g, head = kvh * p.g + tid % p.g;
    w_out[tid] = p.n_splits == 1
                     ? ((static_cast<int64_t>(bb) * p.sq + qi) * p.h + head) *
                           D
                     : ((bk * p.n_splits + split) * kRows + tid) * D;
  }
  __syncthreads();
  float top[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    top[r] = w_m[r0 + 8 * r];
#pragma unroll
    for (int w = 1; w < kWarps; ++w)
      top[r] = fmaxf(top[r], w_m[w * kRows + r0 + 8 * r]);
    const float f = exp2f((m[r] - top[r]) * p.to_log2);
    if (lane % 4 == 0) w_l[warp * kRows + r0 + 8 * r] = l[r] * f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(
          w_acc + (warp * kRows + r0 + 8 * r) * C::kAccStride + 8 * j +
          2 * (lane % 4)) = make_float2(acc[j][2 * r] * f,
                                        acc[j][2 * r + 1] * f);
  }
  if (p.n_splits > 1 && warp == 0 && lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      if (row < p.rows)
        p.ws_ml[((bk * p.n_splits + split) * kRows + row) * 2] = top[r];
    }
  }
  __syncthreads();

  // each thread sums the warps for 4 adjacent columns of D / 32 rows
  // (float4 reads), then writes them
  constexpr int kGroupsOfCols = D / 4;
  constexpr int kRowStep = kThreads / kGroupsOfCols;
  const int col = 4 * (tid % kGroupsOfCols);
#pragma unroll
  for (int r = tid / kGroupsOfCols; r < kRows; r += kRowStep) {
    if (r >= p.rows) break;
    float ll = 0.0f;
    float4 aa = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      ll += w_l[w * kRows + r];
      const float4 x = *reinterpret_cast<const float4*>(
          w_acc + (w * kRows + r) * C::kAccStride + col);
      aa.x += x.x;
      aa.y += x.y;
      aa.z += x.z;
      aa.w += x.w;
    }
    if (p.n_splits == 1) {
      const float inv = 1.0f / fmaxf(ll, 1e-30f);
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(p.o + w_out[r] + col);
      dst[0] = __floats2bfloat162_rn(aa.x * inv, aa.y * inv);
      dst[1] = __floats2bfloat162_rn(aa.z * inv, aa.w * inv);
    } else {
      *reinterpret_cast<float4*>(p.ws_acc + w_out[r] + col) = aa;
      if (col == 0) p.ws_ml[w_out[r] / D * 2 + 1] = ll;
    }
  }
}

// merges the splits' (m, l, acc) in split order: one block per (packed
// row, batch row x kv head), one thread per head-dim column
template <int D>
__global__ void __launch_bounds__(D) flash_decode_merge_kernel(
    const Params p) {
  const int r = blockIdx.x;
  const int64_t bk = blockIdx.y;
  const int d = threadIdx.x;
  const int64_t first = bk * p.n_splits * kRows + r;  // split 0's row
  float mm = p.ws_ml[first * 2];
  for (int s = 1; s < p.n_splits; ++s)
    mm = fmaxf(mm, p.ws_ml[(first + s * kRows) * 2]);
  float ll = 0.0f, aa = 0.0f;
  for (int s = 0; s < p.n_splits; ++s) {
    const int64_t row = first + s * kRows;
    const float f = exp2f((p.ws_ml[row * 2] - mm) * p.to_log2);
    ll += f * p.ws_ml[row * 2 + 1];
    aa += f * p.ws_acc[row * D + d];
  }
  const int64_t bb = bk / p.kh;
  const int kvh = static_cast<int>(bk % p.kh);
  const int qi = r / p.g, head = kvh * p.g + r % p.g;
  p.o[((bb * p.sq + qi) * p.h + head) * D + d] =
      __float2bfloat16_rn(aa / fmaxf(ll, 1e-30f));
}

template <int D>
int launch(const Params& p, long long b, cudaStream_t stream) {
  if (p.rows > kRows || p.rows <= 0 || p.n_splits <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a block gets dynamic shared memory only after opting in;
  // done once per instance, at its first launch
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_decode_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Cfg<D>::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(p.n_splits),
                  static_cast<unsigned>(p.kh), static_cast<unsigned>(b));
  flash_decode_kernel<D><<<grid, kThreads, Cfg<D>::kSmem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_splits == 1) return static_cast<int>(err);
  const dim3 merge_grid(static_cast<unsigned>(p.rows),
                        static_cast<unsigned>(b * p.kh));
  flash_decode_merge_kernel<D><<<merge_grid, D, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace fa_decode
