// Backward of flash attention (GQA, causal, window, softcap) for Hopper
// (sm_90a): the gradient of exactly the forward in flash_attention.cu.
//
// The JAX package has no backward kernel: it trains by differentiating
// its plain attention (src/repro/models/attention.py) with autodiff.  The
// port's forward on the card is the hand-written kernel that replaces the
// Pallas kernel src/repro/kernels/flash_attention/kernel.py:
// flash_attention, so its gradient is this kernel; it computes what
// autodiff of the same function computes.
//
// What it computes, for q (B,Sq,H,D), k/v (B,Sk,K,D), the forward's out O
// and the incoming gradient dO (both (B,Sq,H,D)), f32 inside:
//   r_ij  = scale * (q_i . k_j)          (q * scale is not rounded: the
//                                         forward kernels never round it)
//   s_ij  = cap * tanh(r_ij / cap)       [r_ij without a cap]
//   valid = as the forward (causal with the queries at the last Sq of Sk,
//           the window), and j < Sk
//   m_i   = max(max_valid s_ij, 0.1 * NEG_INF),  l_i = sum_valid exp(s - m)
//   lse_i = m_i + log(l_i), or +inf for a row with no valid key
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
// Three device kernels on one stream, 256 threads a block, f32 FMAs on
// the CUDA cores, tiles of T = 64 rows (32 at head dim 256, so that four
// f32 tiles of T x D stay within shared memory):
//   1. stats: one block per (b, q head, query tile).  Recomputes each
//      row's m and l over the valid keys, as the forward does, and writes
//      lse and delta, (B, H, Sq) f32 scratch.
//   2. dK, dV: one block per (b, kv head, key tile).  Walks the G query
//      heads of the group in order and, for each, the query tiles that
//      can see the key tile (fully masked tiles skipped as the forward
//      skips them): recomputes P, accumulates dV += P^T dO, forms dS and
//      accumulates dK += dS^T Q, in registers.
//   3. dQ: one block per (b, q head, query tile).  Walks the key tiles the
//      tile can see and accumulates dQ += dS K.
// Every product is a T x T or T x D tile of a block-wide sum over shared
// memory: thread (ty, tx) = (t / 16, t % 16) owns rows ty + 16 a and
// columns tx + 16 b, so a warp reads two rows (different banks, rows are
// padded to an odd stride) and sixteen consecutive columns.
//
// Bound: operations.  The three kernels do 7 products of Sq x Sk x D per
// head (S three times, dP twice, dV, dK, dQ), 14 * B * H * pairs * D
// flops on the CUDA cores (67 TFLOP/s f32); the minimum any backward needs
// is 5 products (S, dP, dV, dK, dQ), 10 * B * H * pairs * D flops at the
// tensor cores' 989 TFLOP/s, which is what the port reports as the bound.
// This design is the simple one: no tensor cores, no TMA, the stats pass
// and the dQ pass recompute S.  The next steps are lse from the forward
// and a single-pass wgmma design (ROADMAP.md, section B).
//
// Determinism: every sum has a fixed order (FMAs in index order, a
// fixed butterfly across the 16 lanes of a row, heads and tiles in
// order); no data goes through an atomic, so runs repeat bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kGuard = 0.1f * kNegInf;          // masked-row guard

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
  float* lse;                                     // (B, H, Sq)
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

// reductions over the 16 lanes that share a tile row (xor < 16 stays in
// the half warp)
__device__ __forceinline__ float row_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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
// 1. row statistics: lse and delta
// --------------------------------------------------------------------- //
template <typename TT, int D>
__global__ void __launch_bounds__(kThreads)
fa_bwd_stats_kernel(const Params p) {
  constexpr int T = Tile<D>::T, R = Tile<D>::R, C = Tile<D>::C;
  constexpr int LD = Tile<D>::LD;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                              // [T][LD]
  float* k_s = q_s + T * LD;                      // [T][LD]

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * T;
  const int64_t hh = blockIdx.y, bb = blockIdx.z;
  const int64_t kvh = hh / (p.h / p.kh);
  const int64_t off = p.causal ? p.sk - p.sq : 0;
  const TT* q = static_cast<const TT*>(p.q) + bb * p.q_sb + hh * p.q_sh;
  const TT* k = static_cast<const TT*>(p.k) + bb * p.k_sb + kvh * p.k_sh;

  load_rows<TT, D>(q_s, q, q0, p.sq, p.q_ss);
  int64_t k_lo, k_hi;
  key_range(p, q0, T, off, &k_lo, &k_hi);

  float m[R], l[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  for (int64_t k0 = (k_lo / T) * T; k0 < k_hi; k0 += T) {
    __syncthreads();  // the last tile's reads are done (Q is written)
    load_rows<TT, D>(k_s, k, k0, p.sk, p.k_ss);
    __syncthreads();
    float s[R][R];
    dot_tile<D>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float x = p.scale * s[i][j];
        if (p.has_cap) x = p.cap * tanhf(x / p.cap);
        x = is_valid(p, q0 + ty + 16 * i, k0 + tx + 16 * j, off) ? x
                                                                 : kNegInf;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(fmaxf(m[i], row_max(mx)), kGuard);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < R; ++j) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }

  const TT* o = static_cast<const TT*>(p.o) + bb * p.o_sb + hh * p.o_sh;
  const TT* dout =
      static_cast<const TT*>(p.dout) + bb * p.d_sb + hh * p.d_sh;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int64_t row = q0 + ty + 16 * i;
    float dot = 0.0f;
    if (row < p.sq) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int d = tx + 16 * c;
        if (d < D)
          dot = fmaf(to_f32(dout[row * p.d_ss + d]),
                     to_f32(o[row * p.o_ss + d]), dot);
      }
    }
    dot = row_sum(dot);
    if (row < p.sq && tx == 0) {
      const int64_t at = (bb * p.h + hh) * p.sq + row;
      p.lse[at] = l[i] > 0.0f ? m[i] + logf(l[i]) : inf_f32();
      p.delta[at] = dot;
    }
  }
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
// 2. dK and dV: one block a key tile of one kv head, over its G heads
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
// 3. dQ: one block a query tile of one q head
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
constexpr size_t stats_smem() {
  return sizeof(float) * 2 * Tile<D>::T * Tile<D>::LD;
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
        fa_bwd_stats_kernel<TT, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(stats_smem<D>()));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<TT, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dkdv_smem<D>()));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fa_bwd_dq_kernel<TT, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dq_smem<D>()));
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int T = Tile<D>::T;
  const dim3 q_grid(static_cast<unsigned>((p.sq + T - 1) / T),
                    static_cast<unsigned>(p.h), static_cast<unsigned>(b));
  const dim3 k_grid(static_cast<unsigned>((p.sk + T - 1) / T),
                    static_cast<unsigned>(p.kh), static_cast<unsigned>(b));
  fa_bwd_stats_kernel<TT, D><<<q_grid, kThreads, stats_smem<D>(), stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_bwd_dkdv_kernel<TT, D><<<k_grid, kThreads, dkdv_smem<D>(), stream>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_bwd_dq_kernel<TT, D><<<q_grid, kThreads, dq_smem<D>(), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename TT>
int launch_dim(const Params& p, int head_dim, long long b,
               cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<TT, 16>(p, b, stream);
    case 32: return launch<TT, 32>(p, b, stream);
    case 64: return launch<TT, 64>(p, b, stream);
    case 128: return launch<TT, 128>(p, b, stream);
    case 256: return launch<TT, 256>(p, b, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes); strides are in elements, the
// head dim of every operand contiguous.  dtype 0 is float32, 1 bfloat16;
// q, k, v, out and dout share it, and dq (B,Sq,H,D), dk and dv (B,Sk,K,D)
// are contiguous outputs of it.  lse and delta are (B, H, Sq) f32
// scratch.  Launches the three kernels on `stream`, does not
// synchronise, and returns cudaGetLastError() (so a refused launch is
// seen).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
    int dtype, int head_dim, long long b, long long sq, long long sk,
    long long h, long long kh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss,
    long long o_sh, long long d_sb, long long d_ss, long long d_sh,
    float scale, int causal, int has_window, long long window, int has_cap,
    float cap, void* stream) {
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
