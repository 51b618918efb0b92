// Backward of flash attention (GQA, causal, window, softcap) for Hopper
// (sm_90a): the gradient of exactly the forward in flash_attention.cu.
//
// The JAX package has no backward kernel: it trains by differentiating
// its plain attention (src/repro/models/attention.py) with autodiff.  The
// port's forward on the card is the hand-written kernel that replaces the
// Pallas kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention, so its gradient is these kernels; they compute what
// autodiff of the same function computes.
//
// What it computes, for q (B,Sq,H,D), k/v (B,Sk,K,D), the forward's out O,
// its lse and the incoming gradient dO (both (B,Sq,H,D)), f32 inside:
//   r_ij  = scale * (q_i . k_j)          (q * scale is not rounded: the
//                                         forward kernels never round it)
//   s_ij  = cap * tanh(r_ij / cap)       [r_ij without a cap]
//   valid = as the forward (causal with the queries at the last Sq of Sk,
//           the window), and j < Sk
//   lse_i = the forward's: m_i + log(l_i) with m_i = max(max_valid s_ij,
//           0.1 * NEG_INF) and l_i = sum_valid exp(s - m), or +inf for a
//           row with no valid key (written by the forward launch whose
//           out is differentiated, kernel.py: flash_attention_cuda with
//           with_lse)
//   P_ij  = valid ? exp(s_ij - lse_i) : 0
//   delta_i = sum_d dO_id * O_id
//   dV_j  = sum_i P_ij dO_i                 dP_ij = dO_i . v_j
//   dS_ij = P_ij (dP_ij - delta_i) (1 - tanh^2(r_ij / cap)) * scale
//   dQ_i  = sum_j dS_ij k_j                 dK_j  = sum_i dS_ij q_i
// with the sums over the G = H / K query heads of a kv head for dK and dV
// (the transpose of the forward's repeat of K and V).  A row with no
// valid key has out = 0 for every input, so its P, dS and dQ are 0: the
// +inf lse makes exp(s - lse) exactly 0, never NaN.
//
// Two variants; backward.py's plan picks one a call:
//
// - "wgmma", bf16 at head dim 64, 128 and 256 (every dense config trains
//   at 128, recurrentgemma-9b at 256; flash_bwd_wgmma.cuh): the delta
//   pre-pass, then dK/dV on the tensor cores, one block per (128 keys, or
//   64 at 256, batch row, kv head, run of query heads), the runs' f32
//   partials added in order by a sum kernel, then dQ on the tensor cores,
//   one block per 128 query rows of a head (64 at 256).  At 256 the two
//   warpgroups of a block share its 64 keys or rows and split the
//   products by role (one computes P, the other dS).  Bound by
//   operations: 10 * B * H * pairs * D flops (S, dP, dV, dK, dQ) at 989
//   TFLOP/s; the design does 14 (dQ's kernel recomputes S and dP) so that
//   no float atomic sums dQ.
// - "simt", f32 at every head dim and bf16 at 16 and 32 (no model path
//   trains there): the delta pre-pass, then two CUDA-core kernels of
//   256 threads, f32 FMAs, tiles of T = 64 rows (32 at head dim 256, so
//   that four f32 tiles of T x D stay within shared memory):
//     dK, dV: one block per (b, kv head, key tile).  Walks the G query
//       heads of the group in order and, for each, the query tiles that
//       can see the key tile (fully masked tiles skipped as the forward
//       skips them): recomputes P, accumulates dV += P^T dO, forms dS and
//       accumulates dK += dS^T Q, in registers.
//     dQ: one block per (b, q head, query tile).  Walks the key tiles the
//       tile can see and accumulates dQ += dS K.
//   Every product is a T x T or T x D tile of a block-wide sum over
//   shared memory: thread (ty, tx) = (t / 16, t % 16) owns rows ty + 16 a
//   and columns tx + 16 b, so a warp reads two rows (different banks,
//   rows are padded to an odd stride) and sixteen consecutive columns.
//   Bound by operations at 67 TFLOP/s f32 (7 products of Sq x Sk x D a
//   head: S and dP twice, dV, dK, dQ).
//
// The delta pre-pass (fa_bwd_delta_kernel, one warp a row) reads dO and O
// once (~67 MB at starcoder2-3b's training shape) and writes delta; for
// the tensor-core variant it also writes lse * log2(e), both padded to a
// multiple of 128 rows (+inf and 0 past Sq).  lse itself comes from the
// forward: no pass recomputes it.
//
// Determinism: every sum has a fixed order (FMAs in index order, fixed
// butterflies across lanes, wgmma chains in order, heads, tiles and head
// runs in order); no data goes through an atomic (the tensor-core
// kernels' one atomic counts a shared-memory stage's releases), so runs
// repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_bwd_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Tile {
  static constexpr int T = D >= 256 ? 32 : 64;    // rows of a tile
  static constexpr int R = T / 16;                // tile rows a thread
  static constexpr int C = D / 16 > 0 ? D / 16 : 1;  // head-dim columns
  static constexpr int LD = D + 1;                // padded row stride
  static constexpr int LT = T + 1;
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  const float* lse;                               // (B, H, Sq), the forward's
  float* delta;                                   // (B, H, Sq)
  int64_t sq, sk, h, kh;
  int64_t q_sb, q_ss, q_sh;                       // strides, in elements
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int64_t d_sb, d_ss, d_sh;
  float scale;
  int causal;
  int has_window;
  int64_t window;
  int has_cap;
  float cap;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float inf_f32() {
  return __int_as_float(0x7f800000);
}

// rows [r0, r0 + T) of one (batch, head) slice as f32, rows past n zero
template <typename TT, int D>
__device__ __forceinline__ void load_rows(float* dst, const TT* src,
                                          int64_t r0, int64_t n,
                                          int64_t stride) {
  constexpr int T = Tile<D>::T, LD = Tile<D>::LD;
  for (int idx = threadIdx.x; idx < T * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int64_t row = r0 + r;
    dst[r * LD + d] = row < n ? to_f32(src[row * stride + d]) : 0.0f;
  }
}

// acc[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d]   (a T x T tile)
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[Tile<D>::R][Tile<D>::R],
                                         const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int R = Tile<D>::R, LD = Tile<D>::LD;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < R; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[R], bv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) av[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < R; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[a][c] += sum_i w[i][ty + 16 a] * x[i][tx + 16 c]   (w^T x, T x D)
template <int D>
__device__ __forceinline__ void acc_tn(float (&acc)[Tile<D>::R][Tile<D>::C],
                                       const float* w, const float* x,
                                       int ty, int tx) {
  constexpr int T = Tile<D>::T, R = Tile<D>::R, C = Tile<D>::C;
  constexpr int LD = Tile<D>::LD, LT = Tile<D>::LT;
#pragma unroll 2
  for (int i = 0; i < T; ++i) {
    float wv[R], xv[C];
#pragma unroll
    for (int a = 0; a < R; ++a) wv[a] = w[i * LT + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < C; ++c)
      xv[c] = tx + 16 * c < D ? x[i * LD + tx + 16 * c] : 0.0f;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[a][c] = fmaf(wv[a], xv[c], acc[a][c]);
  }
}

// acc[a][c] += sum_j w[ty + 16 a][j] * x[j][tx + 16 c]   (w x, T x D)
template <int D>
__device__ __forceinline__ void acc_nn(float (&acc)[Tile<D>::R][Tile<D>::C],
                                       const float* w, const float* x,
                                       int ty, int tx) {
  constexpr int T = Tile<D>::T, R = Tile<D>::R, C = Tile<D>::C;
  constexpr int LD = Tile<D>::LD, LT = Tile<D>::LT;
#pragma unroll 2
  for (int j = 0; j < T; ++j) {
    float wv[R], xv[C];
#pragma unroll
    for (int a = 0; a < R; ++a) wv[a] = w[(ty + 16 * a) * LT + j];
#pragma unroll
    for (int c = 0; c < C; ++c)
      xv[c] = tx + 16 * c < D ? x[j * LD + tx + 16 * c] : 0.0f;
#pragma unroll
    for (int a = 0; a < R; ++a)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[a][c] = fmaf(wv[a], xv[c], acc[a][c]);
  }
}

__device__ __forceinline__ bool is_valid(const Params& p, int64_t row,
                                         int64_t key, int64_t off) {
  if (row >= p.sq || key >= p.sk) return false;
  const int64_t pos = row + off;
  if (p.causal && key > pos) return false;
  if (p.has_window && key <= pos - p.window) return false;
  return true;
}

// keys [lo, hi) hold every key valid for some row of the query tile at q0
// (the forward's range)
__device__ __forceinline__ void key_range(const Params& p, int64_t q0,
                                          int T, int64_t off, int64_t* lo,
                                          int64_t* hi) {
  const int64_t row_last = (q0 + T < p.sq ? q0 + T : p.sq) - 1;
  *lo = 0;
  *hi = p.sk;
  if (p.causal && row_last + off + 1 < *hi) *hi = row_last + off + 1;
  if (p.has_window && q0 + off - p.window + 1 > *lo)
    *lo = q0 + off - p.window + 1;
}

// P and dS of one T x T tile from the scores' dots (s, unscaled) and dP:
// dS already carries the cap's derivative and the scale
template <int D>
__device__ __forceinline__ void probs_and_ds(
    const Params& p, float (&s)[Tile<D>::R][Tile<D>::R],
    float (&dp)[Tile<D>::R][Tile<D>::R], const float* lse_s,
    const float* dl_s, int64_t q0, int64_t k0, int64_t off, int ty, int tx) {
  constexpr int R = Tile<D>::R;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const float raw = p.scale * s[i][j];
      float t = 0.0f, sc = raw;
      if (p.has_cap) {
        t = tanhf(raw / p.cap);
        sc = p.cap * t;
      }
      const bool ok = is_valid(p, q0 + r, k0 + tx + 16 * j, off);
      const float pr = ok ? expf(sc - lse_s[r]) : 0.0f;
      float ds = pr * (dp[i][j] - dl_s[r]);
      if (p.has_cap) ds *= 1.0f - t * t;
      s[i][j] = pr;
      dp[i][j] = ds * p.scale;
    }
  }
}

// --------------------------------------------------------------------- //
// the delta pre-pass (both variants)
// --------------------------------------------------------------------- //
constexpr int kDeltaRows = 8;                     // rows a block, a warp each

// delta[r] = sum_d dO . O of row r of the (B, H, ld) plane, and with lse2
// also lse2[r] = lse * log2(e); rows i >= Sq (the tensor-core variant's
// padding) get delta 0 and lse2 +inf.  Each lane sums its columns in
// order, then a fixed butterfly.
template <typename TT, int D>
__global__ void __launch_bounds__(32 * kDeltaRows)
fa_bwd_delta_kernel(const void* o_, const void* dout_, const float* lse,
                    float* delta, float* lse2, int64_t sq, int64_t h,
                    int64_t ld, int64_t n_rows, int64_t o_sb, int64_t o_ss,
                    int64_t o_sh, int64_t d_sb, int64_t d_ss, int64_t d_sh) {
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kDeltaRows +
                    threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_rows) return;                        // the whole warp
  const int64_t i = r % ld, bh = r / ld, hh = bh % h, bb = bh / h;
  float dot = 0.0f;
  if (i < sq) {
    const TT* o = static_cast<const TT*>(o_) + bb * o_sb + i * o_ss +
                  hh * o_sh;
    const TT* dout = static_cast<const TT*>(dout_) + bb * d_sb + i * d_ss +
                     hh * d_sh;
#pragma unroll
    for (int d = lane; d < D; d += 32)
      dot = fmaf(to_f32(dout[d]), to_f32(o[d]), dot);
  }
  for (int off = 16; off > 0; off >>= 1)
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if (lane == 0) {
    delta[r] = dot;
    if (lse2 != nullptr) lse2[r] = i < sq ? lse[bh * sq + i] * kLog2e
                                          : inf_f32();
  }
}

template <typename TT, int D>
int launch_delta(const Params& p, long long b, float* delta, float* lse2,
                 long long ld, cudaStream_t stream) {
  const long long n_rows = b * p.h * ld;
  const long long blocks = (n_rows + kDeltaRows - 1) / kDeltaRows;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fa_bwd_delta_kernel<TT, D>
      <<<static_cast<unsigned>(blocks), 32 * kDeltaRows, 0, stream>>>(
          p.o, p.dout, p.lse, delta, lse2, p.sq, p.h, ld, n_rows, p.o_sb,
          p.o_ss, p.o_sh, p.d_sb, p.d_ss, p.d_sh);
  return static_cast<int>(cudaGetLastError());
}

// lse and delta of rows [q0, q0 + T) into shared memory; rows past Sq get
// +inf and 0, so their P and dS are 0
template <int D>
__device__ __forceinline__ void load_stats(const Params& p, float* lse_s,
                                           float* dl_s, int64_t bb,
                                           int64_t hh, int64_t q0) {
  constexpr int T = Tile<D>::T;
  for (int r = threadIdx.x; r < T; r += kThreads) {
    const int64_t row = q0 + r;
    const int64_t at = (bb * p.h + hh) * p.sq + row;
    lse_s[r] = row < p.sq ? p.lse[at] : inf_f32();
    dl_s[r] = row < p.sq ? p.delta[at] : 0.0f;
  }
}

// --------------------------------------------------------------------- //
// CUDA-core dK and dV: one block a key tile of one kv head, over its G
// heads
// --------------------------------------------------------------------- //
template <typename TT, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dkdv_kernel(const Params p) {
  constexpr int T = Tile<D>::T, R = Tile<D>::R, C = Tile<D>::C;
  constexpr int LD = Tile<D>::LD, LT = Tile<D>::LT;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                              // [T][LD]
  float* v_s = k_s + T * LD;                      // [T][LD]
  float* q_s = v_s + T * LD;                      // [T][LD]
  float* do_s = q_s + T * LD;                     // [T][LD]
  float* p_s = do_s + T * LD;                     // [T][LT]
  float* ds_s = p_s + T * LT;                     // [T][LT]
  float* lse_s = ds_s + T * LT;                   // [T]
  float* dl_s = lse_s + T;                        // [T]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t k0 = static_cast<int64_t>(blockIdx.x) * T;
  const int64_t kvh = blockIdx.y, bb = blockIdx.z;
  const int64_t g = p.h / p.kh;
  const int64_t off = p.causal ? p.sk - p.sq : 0;
  const TT* k = static_cast<const TT*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const TT* v = static_cast<const TT*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  load_rows<TT, D>(k_s, k, k0, p.sk, p.k_ss);
  load_rows<TT, D>(v_s, v, k0, p.sk, p.v_ss);

  // the queries some key of the tile is valid for
  const int64_t k_last = (k0 + T < p.sk ? k0 + T : p.sk) - 1;
  int64_t q_lo = 0, q_hi = p.sq;
  if (p.causal && k0 - off > q_lo) q_lo = k0 - off;
  if (p.has_window && k_last - off + p.window < q_hi)
    q_hi = k_last - off + p.window;

  float dk[R][C], dv[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) dk[a][c] = dv[a][c] = 0.0f;

  for (int64_t gi = 0; gi < g; ++gi) {
    const int64_t hh = kvh * g + gi;
    const TT* q = static_cast<const TT*>(p.q) + bb * p.q_sb + hh * p.q_sh;
    const TT* dout =
        static_cast<const TT*>(p.dout) + bb * p.d_sb + hh * p.d_sh;
    for (int64_t q0 = (q_lo / T) * T; q0 < q_hi; q0 += T) {
      __syncthreads();  // the last tile's reads are done (K, V written)
      load_rows<TT, D>(q_s, q, q0, p.sq, p.q_ss);
      load_rows<TT, D>(do_s, dout, q0, p.sq, p.d_ss);
      load_stats<D>(p, lse_s, dl_s, bb, hh, q0);
      __syncthreads();
      float s[R][R], dp[R][R];
      dot_tile<D>(s, q_s, k_s, ty, tx);
      dot_tile<D>(dp, do_s, v_s, ty, tx);
      probs_and_ds<D>(p, s, dp, lse_s, dl_s, q0, k0, off, ty, tx);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          p_s[(ty + 16 * i) * LT + tx + 16 * j] = s[i][j];
          ds_s[(ty + 16 * i) * LT + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();
      acc_tn<D>(dv, p_s, do_s, ty, tx);
      acc_tn<D>(dk, ds_s, q_s, ty, tx);
    }
  }

  TT* dk_out = static_cast<TT*>(p.dk);
  TT* dv_out = static_cast<TT*>(p.dv);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int64_t key = k0 + ty + 16 * a;
    if (key >= p.sk) continue;
    const int64_t at = ((bb * p.sk + key) * p.kh + kvh) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = tx + 16 * c;
      if (d < D) {
        store(dk_out + at + d, dk[a][c]);
        store(dv_out + at + d, dv[a][c]);
      }
    }
  }
}

// --------------------------------------------------------------------- //
// CUDA-core dQ: one block a query tile of one q head
// --------------------------------------------------------------------- //
template <typename TT, int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bwd_dq_kernel(const Params p) {
  constexpr int T = Tile<D>::T, R = Tile<D>::R, C = Tile<D>::C;
  constexpr int LD = Tile<D>::LD, LT = Tile<D>::LT;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                              // [T][LD]
  float* do_s = q_s + T * LD;                     // [T][LD]
  float* k_s = do_s + T * LD;                     // [T][LD]
  float* v_s = k_s + T * LD;                      // [T][LD]
  float* ds_s = v_s + T * LD;                     // [T][LT]
  float* lse_s = ds_s + T * LT;                   // [T]
  float* dl_s = lse_s + T;                        // [T]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * T;
  const int64_t hh = blockIdx.y, bb = blockIdx.z;
  const int64_t kvh = hh / (p.h / p.kh);
  const int64_t off = p.causal ? p.sk - p.sq : 0;
  const TT* q = static_cast<const TT*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const TT* dout =
      static_cast<const TT*>(p.dout) + bb * p.d_sb + hh * p.d_sh;
  const TT* k = static_cast<const TT*>(p.k) + bb * p.k_sb + kvh * p.k_sh;
  const TT* v = static_cast<const TT*>(p.v) + bb * p.v_sb + kvh * p.v_sh;
  load_rows<TT, D>(q_s, q, q0, p.sq, p.q_ss);
  load_rows<TT, D>(do_s, dout, q0, p.sq, p.d_ss);
  load_stats<D>(p, lse_s, dl_s, bb, hh, q0);
  int64_t k_lo, k_hi;
  key_range(p, q0, T, off, &k_lo, &k_hi);

  float dq[R][C];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < C; ++c) dq[a][c] = 0.0f;

  for (int64_t k0 = (k_lo / T) * T; k0 < k_hi; k0 += T) {
    __syncthreads();  // the last tile's reads are done (Q, dO written)
    load_rows<TT, D>(k_s, k, k0, p.sk, p.k_ss);
    load_rows<TT, D>(v_s, v, k0, p.sk, p.v_ss);
    __syncthreads();
    float s[R][R], dp[R][R];
    dot_tile<D>(s, q_s, k_s, ty, tx);
    dot_tile<D>(dp, do_s, v_s, ty, tx);
    probs_and_ds<D>(p, s, dp, lse_s, dl_s, q0, k0, off, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j)
        ds_s[(ty + 16 * i) * LT + tx + 16 * j] = dp[i][j];
    __syncthreads();
    acc_nn<D>(dq, ds_s, k_s, ty, tx);
  }

  TT* dq_out = static_cast<TT*>(p.dq);
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int64_t row = q0 + ty + 16 * a;
    if (row >= p.sq) continue;
    const int64_t at = ((bb * p.sq + row) * p.h + hh) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(dq_out + at + d, dq[a][c]);
    }
  }
}

template <int D>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (4 * Tile<D>::T * Tile<D>::LD +
                          2 * Tile<D>::T * Tile<D>::LT + 2 * Tile<D>::T);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (4 * Tile<D>::T * Tile<D>::LD +
                          Tile<D>::T * Tile<D>::LT + 2 * Tile<D>::T);
}

template <typename TT, int D>
int launch(const Params& p, long long b, cudaStream_t stream) {
  // above 48 KB a block gets dynamic shared memory only after opting in;
  // done once per instance, at its first launch
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        fa_bwd_dkdv_kernel<TT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(dkdv_smem<D>()));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dq_kernel<TT, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem<D>()));
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  int rc = launch_delta<TT, D>(p, b, p.delta, nullptr, p.sq, stream);
  if (rc != 0) return rc;
  constexpr int T = Tile<D>::T;
  const dim3 q_grid(static_cast<unsigned>((p.sq + T - 1) / T),
                    static_cast<unsigned>(p.h), static_cast<unsigned>(b));
  const dim3 k_grid(static_cast<unsigned>((p.sk + T - 1) / T),
                    static_cast<unsigned>(p.kh), static_cast<unsigned>(b));
  fa_bwd_dkdv_kernel<TT, D><<<k_grid, kThreads, dkdv_smem<D>(), stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_bwd_dq_kernel<TT, D><<<q_grid, kThreads, dq_smem<D>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// f32 at every head dim; bf16 only where the tensor-core variant does not
// reach (head dim 16, 32)
template <typename TT>
int launch_dim(const Params& p, int head_dim, long long b,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<TT, 16>(p, b, stream);
    case 32: return launch<TT, 32>(p, b, stream);
  }
  if constexpr (std::is_same<TT, float>::value) {
    switch (head_dim) {
      case 64: return launch<TT, 64>(p, b, stream);
      case 128: return launch<TT, 128>(p, b, stream);
      case 256: return launch<TT, 256>(p, b, stream);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry points (bound with ctypes); strides are in elements, the
// head dim of every operand contiguous; q, k, v, out and dout share one
// dtype, and dq (B,Sq,H,D), dk and dv (B,Sk,K,D) are contiguous outputs
// of it; lse is the forward's (B, H, Sq) f32.  Each launches its kernels
// on `stream`, does not synchronise, and returns cudaGetLastError() (so a
// refused launch is seen) or a negative hopper:: status code when a TMA
// descriptor cannot be made.
//
// The CUDA-core variant: dtype 0 is float32 (every head dim), 1 bfloat16
// (head dim 16, 32); delta is (B, H, Sq) f32 scratch.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const float* lse,
    float* delta, int dtype, int head_dim, long long b, long long sq,
    long long sk, long long h, long long kh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long d_sb, long long d_ss,
    long long d_sh, float scale, int causal, int has_window, long long window,
    int has_cap, float cap, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kh <= 0 || h % kh != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    dout, dq,   dk,    dv,         lse,
           delta, sq,  sk,   h,    kh,   q_sb, q_ss,  q_sh,       k_sb,
           k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,  o_sh,       d_sb,
           d_ss, d_sh, scale, causal, has_window, window, has_cap, cap};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dim<float>(p, head_dim, b, s);
  if (dtype == 1) return launch_dim<__nv_bfloat16>(p, head_dim, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The tensor-core variant: bf16, head dim 64, 128 or 256, base and strides
// of q, k, v and dout 16-byte aligned (the wrapper checks).  lse2 and delta
// are (B, H, sqp) f32 scratch, sqp = Sq rounded up to 128; with splits > 1
// runs of query heads, ws is (2, splits, B, Sk, K, D) f32 scratch.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, const float* lse,
    float* lse2, float* delta, float* ws, int head_dim, long long b,
    long long sq, long long sk, long long h, long long kh, long long sqp,
    int splits, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long d_sb, long long d_ss, long long d_sh,
    float scale, int causal, int has_window, long long window, int has_cap,
    float cap, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0 || kh <= 0 || h % kh != 0 ||
      sq > INT32_MAX || sk > INT32_MAX || h > 65535 || b > 65535 ||
      sqp < sq || sqp % 128 != 0 || splits <= 0 || (h / kh) % splits != 0 ||
      (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q,    k,    v,    o,    dout, dq,   dk,    dv,         lse,
           delta, sq,  sk,   h,    kh,   q_sb, q_ss,  q_sh,       k_sb,
           k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,  o_sh,       d_sb,
           d_ss, d_sh, scale, causal, has_window, window, has_cap, cap};
  fa_bwd_wgmma::Params w;
  w.lse2 = lse2;
  w.delta = delta;
  w.dq = static_cast<__nv_bfloat16*>(dq);
  w.dk = static_cast<__nv_bfloat16*>(dk);
  w.dv = static_cast<__nv_bfloat16*>(dv);
  w.ws = ws;
  w.b = static_cast<int>(b);
  w.sq = static_cast<int>(sq);
  w.sk = static_cast<int>(sk);
  w.h = static_cast<int>(h);
  w.kh = static_cast<int>(kh);
  w.sqp = static_cast<int>(sqp);
  w.splits = splits;
  w.c = has_cap ? kLog2e : scale * kLog2e;
  w.scale = scale;
  w.cap = cap;
  w.scale_over_cap = has_cap ? scale / cap : 0.0f;
  w.has_cap = has_cap;
  w.causal = causal;
  w.has_window = has_window;
  // a window past both lengths masks nothing more than none
  w.window = static_cast<int>(window < sq + sk ? window : sq + sk);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (head_dim) {
    case 64:
      rc = launch_delta<__nv_bfloat16, 64>(p, b, delta, lse2, sqp, s);
      if (rc != 0) return rc;
      return fa_bwd_wgmma::launch<64>(q, k, v, dout, w, q_sb, q_ss, q_sh,
                                      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                      d_sb, d_ss, d_sh, s);
    case 128:
      rc = launch_delta<__nv_bfloat16, 128>(p, b, delta, lse2, sqp, s);
      if (rc != 0) return rc;
      return fa_bwd_wgmma::launch<128>(q, k, v, dout, w, q_sb, q_ss, q_sh,
                                       k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                       d_sb, d_ss, d_sh, s);
    case 256:
      rc = launch_delta<__nv_bfloat16, 256>(p, b, delta, lse2, sqp, s);
      if (rc != 0) return rc;
      return fa_bwd_wgmma::launch<256>(q, k, v, dout, w, q_sb, q_ss, q_sh,
                                       k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                                       d_sb, d_ss, d_sh, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
