// RG-LRU linear recurrence h_t = a_t * h_{t-1} + b_t for Hopper (sm_90a):
// a single-pass chunked scan whose carry is composed in a fixed order, and
// its gradient, the same scan run from the end (kRev = 1, below).
//
// Replaces the Pallas TPU kernel of the JAX package,
// src/repro/kernels/rglru_scan/kernel.py: rglru_scan_pallas (_kernel).
//
// What it computes, for a, b (B,S,W) f32 and h0 (B,W) f32 or null (zeros):
//   h_{-1} = h0[b, w]
//   h_t    = a[b,t,w] * h_{t-1} + b[b,t,w]         for t = 0 .. S-1
//   out[b,t,w] = h_t                                (f32)
// Every product and every sum is rounded on its own (__fmul_rn,
// __fadd_rn): nvcc would otherwise contract them into an FMA.
//
// Bound on this card: bytes.  a and b are read once and h written once,
// 12 bytes an element: 201 MB at recurrentgemma-9b's (1, 4096, 4096),
// 0.060 ms at 3.35 TB/s.  At ~1 us of DRAM latency that rate needs ~3 MB
// of loads in flight (Little's law).  A thread per channel walking all of
// S keeps a few hundred KB in flight; this kernel cuts S into chunks so
// that every block stages a whole chunk at once.
//
// Items.  S is cut into chunks of L steps (kernel.py: plan; the last may
// be shorter) and W into tiles of kTile channels; an item is one (b,
// chunk, tile), chunks form groups of kFold, and one block of kTile
// threads, a thread a channel, takes each item:
//  1. Ticket.  The block's item comes from an atomicAdd on a per-launch
//     counter, chunk-major, not from blockIdx: every block it waits on
//     below (same b and tile, an earlier chunk) took a smaller ticket, so
//     it is running or done, and the grid cannot deadlock.
//  2. Stage.  The chunk's rows of a and b go into shared memory at once:
//     one cp.async.bulk a row (W % 4 == 0 and 16-byte aligned bases: the
//     "bulk" load path), kStageRows rows on each mbarrier so that the walk
//     below starts on the first rows; else one 4-byte cp.async an element
//     (the "cp_async" path).  64 KB a block, three blocks an SM: ~25 MB in
//     flight across the card.
//  3. Aggregate.  Every chunk but the last runs its steps from h = 0,
//     giving B_c (the chunk's result with no carry-in), and multiplies
//     A_c = 1 * a_0 * a_1 * ... in step order.  A chunk other than the
//     last of its group publishes (A_c, B_c); the last of a group (but the
//     last group) instead folds its group's aggregates in chunk order, GA
//     = 1 * A_0 * A_1 ..., GB = A_j * GB + B_j from GB = 0, and publishes
//     (GA, GB).  A block publishes before it waits on any other.
//  4. Carry-in, in a fixed order.  carry = h0 (or 0); then carry = GA *
//     carry + GB for each earlier group, in order, then carry = A * carry
//     + B for each earlier chunk of its own group, in order.  The order
//     never depends on timing, so two launches give the same bits (a
//     decoupled look-back, which takes whichever prefix is ready, would
//     not).  Two levels keep the reads of an item to about chunks / kFold
//     + kFold aggregates, where one level made them the chunk's index.
//  5. Recurrence.  The chunk's steps again, from shared memory, starting
//     at the carry; h is stored a row at a time, coalesced along W.
// ref.py: rglru_scan_chunked_ref computes the same operations in the same
// order in plain PyTorch, and the kernel equals it bit for bit.
//
// Publishing.  An aggregate is one 64-bit word (A's bits low, B's high)
// written with one relaxed store; the wrapper fills the workspace with
// all-ones words first, and a reader polls the word itself until its low
// half is no longer 0xffffffff.  No fmul returns that pattern (a NaN
// result is the canonical 0x7fffffff), and a 64-bit access is single-copy
// atomic, so no flag and no fence is needed: a reader's one round trip to
// L2 both waits and reads.  Every launch starts from a fresh fill, so
// CUDA-graph replays do too.
//
// The backward (kRev = 1; no Pallas counterpart: the JAX package
// differentiates its plain associative scan) is the same kernel on the
// reversed sequence.  For dy = dL/dh, dh_last = dL/dh_last (or null):
//   g_{S-1} = dy_{S-1} + 1 * dh_last,  g_t = a_{t+1} * g_{t+1} + dy_t
//   db = g,  da_t = g_t * h_{t-1} (h_{-1} = h0, or 0),  dh0 = a_0 * g_0.
// Reversed step r is time t = S - 1 - r; its decay is a read one step
// ahead (a_{t+1}, and 1 at t = S - 1, which the block writes into shared
// memory itself: there is no row to copy), its input dy_t, and dh_last is
// the initial carry.  Chunks count from the end, so a ragged chunk holds
// the first steps of time; items, aggregates and the carry's order are
// the forward's, row addresses step by -W.  The second pass also forms
// da_t = g_t * h_{t-1} from the forward's h (read as g is stored) and, at
// t = 0, dh0.  Bound: bytes, a, dy and h read and g and da written once,
// 20 bytes an element.  ref.py: rglru_scan_bwd_chunked_ref is its order
// of operations, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kTile = 128;      // channels an item, one a thread
constexpr int kMaxChunk = 64;   // steps a chunk at most
constexpr int kFold = 8;        // chunks a group
constexpr int kBatch = 16;      // group aggregates read at once
constexpr int kStageRows = 16;  // rows a staging mbarrier covers
constexpr int kStages = kMaxChunk / kStageRows;
constexpr uint32_t kUnset = 0xffffffffu;  // low half of an unwritten word

// dynamic shared memory of a block: L rows of a, L rows of b, then the
// staging mbarriers
__host__ __device__ constexpr size_t smem_bytes(int chunk) {
  return 2 * static_cast<size_t>(chunk) * kTile * sizeof(float) +
         kStages * sizeof(uint64_t);
}

struct Params {
  const float* a;
  const float* b;      // the backward: dy
  const float* h0;     // null: zeros; the backward: dh_last
  float* out;          // the backward: g = db
  uint64_t* ws;        // [0] the ticket, then (B, slots, W) aggregates
  // the backward only: the forward's h and h0 (null: zeros), and da, dh0
  // (null when the forward had no h0)
  const float* h;
  const float* h_init;
  float* da;
  float* dh0;
  int64_t s, w;
  int bsz, chunk, chunks, tiles, bulk;
};

struct Item {
  int bi, c, rows, cols;
  int64_t w0, first;   // first: element (bi, its first step, w0)
  int64_t step;        // elements from one step to the next: W, or -W
  int64_t t_first;     // the time of its first step
};

template <int kRev>
__device__ __forceinline__ Item decode(const Params& p, int t) {
  Item it;
  const int tile = t % p.tiles;
  it.bi = (t / p.tiles) % p.bsz;
  it.c = t / (p.tiles * p.bsz);
  const int64_t t0 = static_cast<int64_t>(it.c) * p.chunk;
  it.rows = p.s - t0 < p.chunk ? static_cast<int>(p.s - t0) : p.chunk;
  it.w0 = static_cast<int64_t>(tile) * kTile;
  it.cols = p.w - it.w0 < kTile ? static_cast<int>(p.w - it.w0) : kTile;
  it.t_first = kRev ? p.s - 1 - t0 : t0;
  it.step = kRev ? -p.w : p.w;
  it.first = (it.bi * p.s + it.t_first) * p.w + it.w0;
  return it;
}

__device__ __forceinline__ uint64_t pack(float A, float B) {
  return static_cast<uint64_t>(__float_as_uint(A)) |
         static_cast<uint64_t>(__float_as_uint(B)) << 32;
}

// N aggregates src[k * stride], k < n: start() sends the reads, settle()
// reads again any still unwritten until none is, then unpacks them
template <int N>
struct Pending {
  uint64_t word[N];

  __device__ __forceinline__ void start(const uint64_t* src, int n,
                                        int64_t stride) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < n) word[k] = ld_relaxed_gpu(src + k * stride);
  }

  __device__ __forceinline__ void settle(const uint64_t* src, int n,
                                         int64_t stride, float2 (&v)[N]) {
    for (uint32_t polls = 0;; ++polls) {
      bool ready = true;
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (k < n && static_cast<uint32_t>(word[k]) == kUnset) {
          ready = false;
          word[k] = ld_relaxed_gpu(src + k * stride);
        }
      if (ready) break;
      if (polls == kMaxPolls) __trap();  // an aggregate never written
      __nanosleep(32);
    }
#pragma unroll
    for (int k = 0; k < N; ++k)
      v[k] = make_float2(__uint_as_float(static_cast<uint32_t>(word[k])),
                         __uint_as_float(static_cast<uint32_t>(word[k] >>
                                                               32)));
  }
};

// the workspace of one item: this thread's channel of slot 0 (chunk k's
// slot is k, group k's is last + k)
struct Slots {
  uint64_t* agg;
  int last, g, j;
};

__device__ __forceinline__ Slots slots_of(const Params& p, const Item& it) {
  Slots sl;
  sl.last = p.chunks - 1;
  const int slots = sl.last + sl.last / kFold;
  sl.g = it.c / kFold;
  sl.j = it.c % kFold;
  sl.agg = p.ws + 1 + static_cast<int64_t>(it.bi) * slots * p.w + it.w0 +
           threadIdx.x;
  return sl;
}

// the item's rows in shared memory, kStageRows at a time
struct Staged {
  const float* a_s;
  const float* b_s;
  uint64_t* bars;  // null on the cp_async path: every row is there
  int rows;

  // waits for stage i's rows, which start at i * kStageRows, and returns
  // where they end
  __device__ __forceinline__ int wait(int i) const {
    if (bars != nullptr) mbar_wait(&bars[i], 0);
    return min(rows, (i + 1) * kStageRows);
  }
  __device__ __forceinline__ int stages() const {
    return (rows + kStageRows - 1) / kStageRows;
  }
};

// 3. the item's aggregate, published before any wait on another item
// (the last chunk of a group waits on its group's other chunks)
__device__ __forceinline__ void publish_item(const Params& p, const Item& it,
                                             const Staged& st) {
  const int tid = threadIdx.x;
  const Slots sl = slots_of(p, it);
  if (it.c >= sl.last || tid >= it.cols) return;
  float A = 1.0f, B = 0.0f;
  for (int i = 0; i < st.stages(); ++i) {
    const int hi = st.wait(i);
#pragma unroll 8
    for (int r = i * kStageRows; r < hi; ++r) {
      const float av = st.a_s[r * kTile + tid];
      A = __fmul_rn(A, av);
      B = __fadd_rn(__fmul_rn(av, B), st.b_s[r * kTile + tid]);
    }
  }
  if (sl.j < kFold - 1) {
    st_relaxed_gpu(sl.agg + static_cast<int64_t>(it.c) * p.w, pack(A, B));
    return;
  }
  const uint64_t* mine = sl.agg + static_cast<int64_t>(sl.g) * kFold * p.w;
  Pending<kFold - 1> chunks;
  float2 v[kFold - 1];
  chunks.start(mine, kFold - 1, p.w);
  chunks.settle(mine, kFold - 1, p.w, v);
  float ga = 1.0f, gb = 0.0f;
#pragma unroll
  for (int k = 0; k < kFold - 1; ++k) {
    ga = __fmul_rn(ga, v[k].x);
    gb = __fadd_rn(__fmul_rn(v[k].x, gb), v[k].y);
  }
  ga = __fmul_rn(ga, A);
  gb = __fadd_rn(__fmul_rn(A, gb), B);
  st_relaxed_gpu(sl.agg + static_cast<int64_t>(sl.last + sl.g) * p.w,
                 pack(ga, gb));
}

// 4 and 5: the item's carry, then its steps (the backward: and da, dh0)
template <int kRev>
__device__ __forceinline__ void finish_item(const Params& p, const Item& it,
                                            const Staged& st) {
  const int tid = threadIdx.x;
  if (tid >= it.cols) return;
  const Slots sl = slots_of(p, it);
  float carry = p.h0 != nullptr ? p.h0[it.bi * p.w + it.w0 + tid] : 0.0f;
  // the reads of both levels go out together: one round trip to L2
  const uint64_t* groups = sl.agg + static_cast<int64_t>(sl.last) * p.w;
  const uint64_t* mine = sl.agg + static_cast<int64_t>(sl.g) * kFold * p.w;
  Pending<kBatch> gp;
  Pending<kFold - 1> cp;
  gp.start(groups, min(sl.g, kBatch), p.w);
  cp.start(mine, sl.j, p.w);
  for (int k0 = 0; k0 < sl.g; k0 += kBatch) {
    const int n = min(sl.g - k0, kBatch);
    if (k0 > 0) gp.start(groups + k0 * p.w, n, p.w);
    float2 v[kBatch];
    gp.settle(groups + k0 * p.w, n, p.w, v);
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (k < n) carry = __fadd_rn(__fmul_rn(v[k].x, carry), v[k].y);
  }
  float2 v[kFold - 1];
  cp.settle(mine, sl.j, p.w, v);
#pragma unroll
  for (int k = 0; k < kFold - 1; ++k)
    if (k < sl.j) carry = __fadd_rn(__fmul_rn(v[k].x, carry), v[k].y);

  float h = carry;
  const int64_t e0 = it.first + tid;
  for (int i = 0; i < st.stages(); ++i) {
    const int hi = st.wait(i);
    if constexpr (!kRev) {
#pragma unroll 8
      for (int r = i * kStageRows; r < hi; ++r) {
        h = __fadd_rn(__fmul_rn(st.a_s[r * kTile + tid], h),
                      st.b_s[r * kTile + tid]);
        p.out[e0 + r * it.step] = h;
      }
    } else {
      // h is g_t here: da_t = g_t h_{t-1}, and dh0 = a_0 g_0 at t = 0.
      // The stage's h_{t-1} are loaded before its steps, so that the
      // loads are in flight together rather than one a step
      const int64_t w_at = it.bi * p.w + it.w0 + tid;
      float prev[kStageRows];
#pragma unroll
      for (int k = 0; k < kStageRows; ++k) {
        const int r = i * kStageRows + k;
        const int64_t e = e0 + r * it.step;
        prev[k] = r >= hi               ? 0.0f
                  : it.t_first != r     ? __ldg(p.h + e - p.w)
                  : p.h_init != nullptr ? p.h_init[w_at]
                                        : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < kStageRows; ++k) {
        const int r = i * kStageRows + k;
        if (r >= hi) break;
        const int64_t e = e0 + r * it.step;
        h = __fadd_rn(__fmul_rn(st.a_s[r * kTile + tid], h),
                      st.b_s[r * kTile + tid]);
        p.out[e] = h;
        p.da[e] = __fmul_rn(h, prev[k]);
        if (it.t_first == r && p.dh0 != nullptr)
          p.dh0[w_at] = __fmul_rn(p.a[e], h);
      }
    }
  }
}

template <int kRev>
__global__ void __launch_bounds__(kTile)
rglru_chunked_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* const a_s = reinterpret_cast<float*>(smem);  // [chunk][kTile]
  float* const b_s = a_s + p.chunk * kTile;           // [chunk][kTile]
  uint64_t* bars = reinterpret_cast<uint64_t*>(b_s + p.chunk * kTile);
  __shared__ int ticket;

  const int tid = threadIdx.x;
  if (tid == 0) {
    // 1. the counter starts at all ones: the first ticket is 0
    ticket = static_cast<int>(
        atomicAdd(reinterpret_cast<unsigned long long*>(p.ws), 1ull) + 1ull);
    if (p.bulk) {
      for (int i = 0; i < kStages; ++i) mbar_init(&bars[i], 1);
      fence_barrier_init();
    }
  }
  __syncthreads();
  const Item it = decode<kRev>(p, ticket);
  const Staged st{a_s, b_s, p.bulk ? bars : nullptr, it.rows};
  // the backward's decays are a one step ahead: row r of a_s is a at time
  // t_r + 1, one row on from b's.  Time S has no row: the first chunk
  // from the end gets its first decay, 1, from each thread (for its own
  // channel, which only it reads), and copies one row of a less.
  const int64_t a_off = kRev ? p.w : 0;
  const int a_skip = kRev && it.c == 0 ? 1 : 0;
  if (a_skip && tid < it.cols) a_s[tid] = 1.0f;

  // 2. stage the chunk's rows of a and b
  if (p.bulk) {
    if (tid < 32) {
      const uint32_t row_bytes = it.cols * sizeof(float);
      for (int i = 0; i < st.stages(); ++i) {
        const int lo = i * kStageRows;
        const int n = min(it.rows - lo, kStageRows);
        const int skip = i == 0 ? a_skip : 0;
        if (tid == 0)
          mbar_arrive_expect_tx(&bars[i], (2 * n - skip) * row_bytes);
        __syncwarp();
        for (int k = tid + skip; k < 2 * n; k += 32) {
          const bool is_b = k >= n;
          const int row = lo + (is_b ? k - n : k);
          bulk_load((is_b ? b_s : a_s) + row * kTile,
                    is_b ? p.b + it.first + row * it.step
                         : p.a + it.first + a_off + row * it.step,
                    row_bytes, &bars[i]);
        }
      }
    }
  } else if (tid < it.cols) {
    for (int r = 0; r < it.rows; ++r) {
      const int64_t e = it.first + r * it.step + tid;
      if (r >= a_skip) cp_async_4(a_s + r * kTile + tid, p.a + e + a_off,
                                  true);
      cp_async_4(b_s + r * kTile + tid, p.b + e, true);
    }
    cp_async_commit();
    cp_async_wait<0>();
  }

  publish_item(p, it, st);
  finish_item<kRev>(p, it, st);
}

// the checks and the launch shared by both entry points
int launch_scan(Params& p, long long bsz, long long s, long long w,
                int chunk, int bulk, bool rev, void* stream) {
  if (bsz <= 0 || s <= 0 || w <= 0 || bsz > 65535 || chunk <= 0 ||
      chunk > kMaxChunk || p.ws == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = (s + chunk - 1) / chunk;
  const long long tiles = (w + kTile - 1) / kTile;
  const long long items = bsz * chunks * tiles;
  if (items > 0x7fffffffLL ||
      (bulk && (w % 4 != 0 || reinterpret_cast<uintptr_t>(p.a) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(p.b) % 16 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  // above 48 KB a block gets dynamic shared memory only after opting in;
  // done once per instance, at its first launch (never inside a capture
  // that is not preceded by a launch)
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(rglru_chunked_kernel<0>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes(kMaxChunk))),
      cudaFuncSetAttribute(rglru_chunked_kernel<1>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem_bytes(kMaxChunk)))};
  if (attr[rev] != cudaSuccess) return static_cast<int>(attr[rev]);
  p.s = s;
  p.w = w;
  p.bsz = static_cast<int>(bsz);
  p.chunk = chunk;
  p.chunks = static_cast<int>(chunks);
  p.tiles = static_cast<int>(tiles);
  p.bulk = bulk;
  const dim3 grid(static_cast<unsigned>(items));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rev)
    rglru_chunked_kernel<1><<<grid, kTile, smem_bytes(chunk), st>>>(p);
  else
    rglru_chunked_kernel<0><<<grid, kTile, smem_bytes(chunk), st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  a, b, out are contiguous
// (B,S,W) f32, h0 a contiguous (B,W) f32 or null; with last = chunks - 1
// and slots = last + last / 8, ws holds 1 + B x slots x W 64-bit words,
// all ones.  bulk (1) needs W % 4 == 0 and 16-byte aligned a and b.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() so a refused launch is seen.
extern "C" int rglru_scan_launch(const void* a, const void* b,
                                 const void* h0, void* out, void* ws,
                                 long long bsz, long long s, long long w,
                                 int chunk, int bulk, void* stream) {
  Params p{};
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.h0 = static_cast<const float*>(h0);
  p.out = static_cast<float*>(out);
  p.ws = static_cast<uint64_t*>(ws);
  return launch_scan(p, bsz, s, w, chunk, bulk, false, stream);
}

// The backward, with the same conventions: a, dy, h (the forward's
// output), db and da are contiguous (B,S,W) f32; dh_last, h0 (the
// forward's) and dh0 contiguous (B,W) f32, dh_last and h0 null for zeros,
// dh0 null when h0 is; ws as the forward's, all ones.  bulk (1) needs W %
// 4 == 0 and 16-byte aligned a and dy.
extern "C" int rglru_scan_bwd_launch(const void* a, const void* dy,
                                     const void* dh_last, const void* h,
                                     const void* h0, void* db, void* da,
                                     void* dh0, void* ws, long long bsz,
                                     long long s, long long w, int chunk,
                                     int bulk, void* stream) {
  if (h == nullptr || da == nullptr || (dh0 != nullptr && h0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(dy);
  p.h0 = static_cast<const float*>(dh_last);
  p.out = static_cast<float*>(db);
  p.ws = static_cast<uint64_t*>(ws);
  p.h = static_cast<const float*>(h);
  p.h_init = static_cast<const float*>(h0);
  p.da = static_cast<float*>(da);
  p.dh0 = static_cast<float*>(dh0);
  return launch_scan(p, bsz, s, w, chunk, bulk, true, stream);
}
