// Window-aggregate kernels for Hopper (sm_90a). Plain C interface, loaded
// with ctypes by quickstep_tpu_torch/ops/cuda.py; every function launches on
// the stream it is given, allocates nothing, and returns the cudaError_t of
// its launches. All of them work on rows already sorted by (partition keys,
// order keys), with bool flags marking the first row of each segment
// (partition) and of each peer group (rows with equal order keys).
//
// W1 qs_window_prefix replaces quickstep_tpu/ops/window.py:75
//    _segmented_scan, :239 _prefix_to_peers and :220 _seg_total: the
//    inclusive SUM, MIN or MAX and the COUNT of each segment up to the last
//    row of the row's peer group (a whole-partition aggregate is the same
//    call with the peer groups equal to the segments).
// W2 qs_frame_minmax replaces :50 _range_query_minmax (the MIN/MAX branch of
//    :315 _eval_frame): MIN or MAX over per-row index ranges [lo, hi].
// W3 qs_frame_bounds replaces :30 _lex_searchsorted, the RANGE path through
//    ops/join.py:189 merge_starts (:166-196) and seg_first/seg_last
//    (:147-150): each row's frame [lo, hi] inside its segment, for ROWS and
//    RANGE frames.
// W4 qs_sliding_sum replaces :273 _sliding_float_sums: float frame sums in
//    the reference's sliding order, bit for bit.
//
// What bounds them on an H100. W1-W3 are bound by bytes: each row's flags,
// value and outputs are touched a fixed number of times, with a few ALU
// operations each. The TPU formulation (whole-array cumsum minus the prefix
// at the segment start, a sparse table of ceil(log2 n) + 1 shifted copies of
// the column, log2 n rounds of full gathers or a merge sort for the RANGE
// bounds) existed because the TPU has no cheap per-row control flow. Here:
// - W1 is a tiled segmented scan that carries across tiles (reduce, then a
//   one-block scan of the tile summaries, then the rows again), so one long
//   segment is as fast as many short ones; the row at the end of each peer
//   group holds the result, which a last pass copies to the group's rows.
// - W3 finds each row's segment bounds with the same tile scheme (the last
//   segment start at or before the row, the first after it) and, for RANGE
//   frames, binary-searches the row's own segment: no (segment, value)
//   packing and no sort.
// - W2 walks short frames directly; a frame that spans more than two tiles
//   of kSpan rows reads its two partial tiles and a sparse table over the
//   tile minima or maxima only (n / kSpan entries per level, not n).
// W4 is bound by its sequential order, not by the card: one thread per
// segment slides a running sum over its rows, subtracting the rows that
// leave the frame and adding those that enter, in the reference's order and
// in the values' own type, so its sums equal the reference's bit for bit. A
// frame with no PARTITION BY is one thread walking the whole input.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_device.cuh"

namespace {

enum FrameMode { kRows = 0, kRange = 1 };

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int64_t kTile = (int64_t)kThreads * kItems;   // rows per tile
constexpr int kScanThreads = 1024;
constexpr int kSpan = 1024;                              // W2's tile
constexpr int kNone = INT32_MAX;

struct MaxOp {
  __device__ __forceinline__ int operator()(int a, int b) const {
    return a > b ? a : b;
  }
};

// The minimum of x over the threads after this one (kNone if none); total
// receives the minimum over all threads.
template <int NT>
__device__ __forceinline__ int block_suffix_min(int x, int& total) {
  constexpr int NW = NT / 32;
  __shared__ int warp_tot[NW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_down_sync(kFull, inc, d);
    if (lane + d < 32) inc = min(inc, y);
  }
  if (lane == 0) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < NW ? warp_tot[lane] : kNone;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_down_sync(kFull, w, d);
      if (lane + d < 32) w = min(w, y);
    }
    if (lane < NW) warp_tot[lane] = w;          // inclusive suffix over warps
  }
  __syncthreads();
  int after = __shfl_down_sync(kFull, inc, 1);
  if (lane == 31) after = kNone;
  const int result = min(after, warp + 1 < NW ? warp_tot[warp + 1] : kNone);
  total = warp_tot[0];
  __syncthreads();
  return result;
}

// ---------------------------------------------------------------------
// W1: segmented prefix, read at the end of each peer group
// ---------------------------------------------------------------------
template <int FN, typename T, typename A>
__device__ __forceinline__ Seg<A> seg_item(const T* __restrict__ vals,
                                           const uint8_t* __restrict__ live,
                                           const uint8_t* __restrict__ seg_start,
                                           int64_t r) {
  Seg<A> x;
  x.f = seg_start[r] != 0;
  if constexpr (FN == kCount) x.v = A(0);
  else x.v = (A)vals[r];
  x.c = live[r] != 0;
  return x;
}

// This thread's summary of its kItems rows and its first peer start.
template <int FN, typename T, typename A>
__device__ __forceinline__ Seg<A> thread_summary(
    const T* vals, const uint8_t* live, const uint8_t* seg_start,
    const uint8_t* __restrict__ peer_start, int64_t n, int64_t base,
    int& first_peer) {
  const SegOp<FN, A> op;
  Seg<A> s = {0, identity<FN, A>(), 0};
  first_peer = kNone;
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = base + j;
    if (r >= n) break;
    s = op(s, seg_item<FN, T, A>(vals, live, seg_start, r));
    if (peer_start[r] && first_peer == kNone) first_peer = (int)r;
  }
  return s;
}

// Pass 1: one summary per tile of kTile rows.
template <int FN, typename T, typename A>
__global__ void __launch_bounds__(kThreads)
prefix_tiles(const T* __restrict__ vals, const uint8_t* __restrict__ live,
             const uint8_t* __restrict__ seg_start,
             const uint8_t* __restrict__ peer_start, int64_t n,
             int* __restrict__ tile_f, A* __restrict__ tile_v,
             long long* __restrict__ tile_c, int* __restrict__ tile_peer) {
  const int64_t base = (int64_t)blockIdx.x * kTile +
                       (int64_t)threadIdx.x * kItems;
  int first_peer;
  const Seg<A> s = thread_summary<FN, T, A>(vals, live, seg_start, peer_start,
                                            n, base, first_peer);
  const Seg<A> id = {0, identity<FN, A>(), 0};
  Seg<A> total;
  block_exclusive_scan<kThreads>(s, id, SegOp<FN, A>(), total);
  int peer_total;
  block_suffix_min<kThreads>(first_peer, peer_total);
  if (threadIdx.x == 0) {
    tile_f[blockIdx.x] = total.f;
    tile_v[blockIdx.x] = total.v;
    tile_c[blockIdx.x] = total.c;
    tile_peer[blockIdx.x] = peer_total;
  }
}

// Pass 2, one block: each tile's carry (the value and count since the last
// segment start before it) and the first peer start after it.
template <int FN, typename A>
__global__ void __launch_bounds__(kScanThreads)
prefix_scan(const int* __restrict__ tile_f, const A* __restrict__ tile_v,
            const long long* __restrict__ tile_c,
            const int* __restrict__ tile_peer, int64_t ntiles,
            A* __restrict__ carry_v, long long* __restrict__ carry_c,
            int* __restrict__ next_peer) {
  const SegOp<FN, A> op;
  const Seg<A> id = {0, identity<FN, A>(), 0};
  Seg<A> carry = id;
  for (int64_t base = 0; base < ntiles; base += kScanThreads) {
    const int64_t t = base + threadIdx.x;
    Seg<A> x = id;
    if (t < ntiles) x = {tile_f[t], tile_v[t], tile_c[t]};
    Seg<A> total;
    const Seg<A> ex = block_exclusive_scan<kScanThreads>(x, id, op, total);
    if (t < ntiles) {
      const Seg<A> in = op(carry, ex);
      carry_v[t] = in.v;
      carry_c[t] = in.c;
    }
    carry = op(carry, total);
  }
  int after = kNone;
  const int64_t chunks = (ntiles + kScanThreads - 1) / kScanThreads;
  for (int64_t k = chunks - 1; k >= 0; --k) {
    const int64_t t = k * kScanThreads + threadIdx.x;
    int total;
    const int ex = block_suffix_min<kScanThreads>(
        t < ntiles ? tile_peer[t] : kNone, total);
    if (t < ntiles) next_peer[t] = min(ex, after);
    after = min(after, total);
  }
}

// Pass 3: each row's inclusive prefix (written to out) and the last row of
// its peer group (peer_last).
template <int FN, typename T, typename A, typename O>
__global__ void __launch_bounds__(kThreads)
prefix_rows(const T* __restrict__ vals, const uint8_t* __restrict__ live,
            const uint8_t* __restrict__ seg_start,
            const uint8_t* __restrict__ peer_start, int64_t n,
            const A* __restrict__ carry_v, const long long* __restrict__ carry_c,
            const int* __restrict__ next_peer, O* __restrict__ out_val,
            long long* __restrict__ out_cnt, int* __restrict__ peer_last) {
  const SegOp<FN, A> op;
  const int64_t base = (int64_t)blockIdx.x * kTile +
                       (int64_t)threadIdx.x * kItems;
  int first_peer;
  const Seg<A> s = thread_summary<FN, T, A>(vals, live, seg_start, peer_start,
                                            n, base, first_peer);
  const Seg<A> id = {0, identity<FN, A>(), 0};
  Seg<A> total;
  const Seg<A> ex = block_exclusive_scan<kThreads>(s, id, op, total);
  const Seg<A> tile_carry = {0, carry_v[blockIdx.x], carry_c[blockIdx.x]};
  Seg<A> cur = op(tile_carry, ex);
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = base + j;
    if (r >= n) break;
    cur = op(cur, seg_item<FN, T, A>(vals, live, seg_start, r));
    if constexpr (FN != kCount) out_val[r] = (O)cur.v;
    out_cnt[r] = cur.c;
  }
  int peer_total;
  int next = min(block_suffix_min<kThreads>(first_peer, peer_total),
                 next_peer[blockIdx.x]);
  if (next == kNone) next = (int)n;
  for (int j = kItems - 1; j >= 0; --j) {
    const int64_t r = base + j;
    if (r >= n) continue;
    peer_last[r] = next - 1;
    if (peer_start[r]) next = (int)r;
  }
}

// Pass 4: every row takes the result of its peer group's last row. Those
// rows are never written (their peer_last is themselves), so the copy is in
// place.
template <int FN, typename O>
__global__ void __launch_bounds__(kThreads)
take_peer_last(const int* __restrict__ peer_last, int64_t n,
               O* __restrict__ out_val, long long* __restrict__ out_cnt) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int p = peer_last[i];
    if (p == i) continue;
    if constexpr (FN != kCount) out_val[i] = out_val[p];
    out_cnt[i] = out_cnt[p];
  }
}

int grid_stride_blocks(int64_t n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 8;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

template <int FN, typename T, typename A, typename O>
cudaError_t launch_window_prefix(const void* vals, const void* live,
                                 const void* seg_start, const void* peer_start,
                                 int64_t n, void* tile_f, void* tile_v,
                                 void* tile_c, void* tile_peer, void* carry_v,
                                 void* carry_c, void* next_peer,
                                 void* peer_last, void* out_val,
                                 void* out_cnt, cudaStream_t s) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  prefix_tiles<FN, T, A><<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const T*)vals, (const uint8_t*)live, (const uint8_t*)seg_start,
      (const uint8_t*)peer_start, n, (int*)tile_f, (A*)tile_v,
      (long long*)tile_c, (int*)tile_peer);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  prefix_scan<FN, A><<<1, kScanThreads, 0, s>>>(
      (const int*)tile_f, (const A*)tile_v, (const long long*)tile_c,
      (const int*)tile_peer, ntiles, (A*)carry_v, (long long*)carry_c,
      (int*)next_peer);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  prefix_rows<FN, T, A, O><<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const T*)vals, (const uint8_t*)live, (const uint8_t*)seg_start,
      (const uint8_t*)peer_start, n, (const A*)carry_v,
      (const long long*)carry_c, (const int*)next_peer, (O*)out_val,
      (long long*)out_cnt, (int*)peer_last);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  take_peer_last<FN, O><<<grid_stride_blocks(n), kThreads, 0, s>>>(
      (const int*)peer_last, n, (O*)out_val, (long long*)out_cnt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// W3: segment bounds and frame bounds
// ---------------------------------------------------------------------

// This thread's last and first segment start (-1 and kNone when none).
__device__ __forceinline__ void thread_starts(const uint8_t* __restrict__ start,
                                              int64_t n, int64_t base,
                                              int& last, int& first) {
  last = -1;
  first = kNone;
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = base + j;
    if (r >= n) break;
    if (start[r]) {
      last = (int)r;
      if (first == kNone) first = (int)r;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bounds_tiles(const uint8_t* __restrict__ start, int64_t n,
             int* __restrict__ tile_last, int* __restrict__ tile_first) {
  const int64_t base = (int64_t)blockIdx.x * kTile +
                       (int64_t)threadIdx.x * kItems;
  int last, first;
  thread_starts(start, n, base, last, first);
  int last_total, first_total;
  block_exclusive_scan<kThreads>(last, -1, MaxOp(), last_total);
  block_suffix_min<kThreads>(first, first_total);
  if (threadIdx.x == 0) {
    tile_last[blockIdx.x] = last_total;
    tile_first[blockIdx.x] = first_total;
  }
}

// One block: the last segment start before each tile and the first after.
__global__ void __launch_bounds__(kScanThreads)
bounds_scan(const int* __restrict__ tile_last,
            const int* __restrict__ tile_first, int64_t ntiles,
            int* __restrict__ prev_start, int* __restrict__ next_start) {
  int carry = -1;
  for (int64_t base = 0; base < ntiles; base += kScanThreads) {
    const int64_t t = base + threadIdx.x;
    int total;
    const int ex = block_exclusive_scan<kScanThreads>(
        t < ntiles ? tile_last[t] : -1, -1, MaxOp(), total);
    if (t < ntiles) prev_start[t] = max(ex, carry);
    carry = max(carry, total);
  }
  int after = kNone;
  const int64_t chunks = (ntiles + kScanThreads - 1) / kScanThreads;
  for (int64_t k = chunks - 1; k >= 0; --k) {
    const int64_t t = k * kScanThreads + threadIdx.x;
    int total;
    const int ex = block_suffix_min<kScanThreads>(
        t < ntiles ? tile_first[t] : kNone, total);
    if (t < ntiles) next_start[t] = min(ex, after);
    after = min(after, total);
  }
}

// The first row j in [first, last + 1) whose key is not below q (lower) or
// above q (upper): the reference's lexicographic search confined to the
// row's own segment.
template <bool UPPER, typename K>
__device__ __forceinline__ int search(const K* __restrict__ keys, int first,
                                      int last, K q) {
  int lo = first, hi = last + 1;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    const K m = keys[mid];
    const bool right = UPPER ? (m <= q) : (m < q);
    if (right) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// Integer keys search in int64 (v - a cannot wrap); float keys in their own
// type, as the reference computes v - a and v + b.
template <typename K> struct KeyMath { using Q = long long; };
template <> struct KeyMath<float> { using Q = float; };
template <> struct KeyMath<double> { using Q = double; };

template <int MODE, typename K>
__global__ void __launch_bounds__(kThreads)
bounds_rows(const uint8_t* __restrict__ start, const K* __restrict__ keys,
            int64_t n, long long a, long long b, int start_unbounded,
            int end_unbounded, const int* __restrict__ prev_start,
            const int* __restrict__ next_start, int* __restrict__ lo_out,
            int* __restrict__ hi_out) {
  const int64_t base = (int64_t)blockIdx.x * kTile +
                       (int64_t)threadIdx.x * kItems;
  int last, first;
  thread_starts(start, n, base, last, first);
  int total;
  const int before = block_exclusive_scan<kThreads>(last, -1, MaxOp(), total);
  int next = min(block_suffix_min<kThreads>(first, total),
                 next_start[blockIdx.x]);
  if (next == kNone) next = (int)n;
  int seg_first[kItems];
  int cur = max(before, prev_start[blockIdx.x]);
  for (int j = 0; j < kItems; ++j) {
    const int64_t r = base + j;
    if (r < n && start[r]) cur = (int)r;
    seg_first[j] = cur;
  }
  for (int j = kItems - 1; j >= 0; --j) {
    const int64_t r = base + j;
    if (r >= n) continue;
    const int sf = seg_first[j];
    const int sl = next - 1;
    if (start[r]) next = (int)r;
    long long lo, hi;
    if constexpr (MODE == kRows) {
      lo = start_unbounded ? sf : max((long long)sf, r - a);
      hi = end_unbounded ? sl : min((long long)sl, r + b);
    } else {
      using Q = typename KeyMath<K>::Q;
      const Q v = (Q)keys[r];
      if constexpr (std::is_floating_point<K>::value) {
        lo = start_unbounded ? sf : search<false, K>(keys, sf, sl, v - (K)a);
        hi = end_unbounded ? sl : search<true, K>(keys, sf, sl, v + (K)b) - 1;
      } else {
        // compare in int64: a bound below or above the key type's range
        // still orders correctly against every key
        int l = sf, h = sl + 1;
        const long long qlo = v - a;
        while (l < h) {
          const int mid = l + ((h - l) >> 1);
          if ((long long)keys[mid] < qlo) l = mid + 1;
          else h = mid;
        }
        lo = start_unbounded ? sf : l;
        l = sf;
        h = sl + 1;
        const long long qhi = v + b;
        while (l < h) {
          const int mid = l + ((h - l) >> 1);
          if ((long long)keys[mid] <= qhi) l = mid + 1;
          else h = mid;
        }
        hi = end_unbounded ? sl : l - 1;
      }
    }
    hi = max(hi, lo - 1);                         // an empty frame
    lo_out[r] = (int)lo;
    hi_out[r] = (int)hi;
  }
}

template <int MODE, typename K>
cudaError_t launch_frame_bounds(const void* start, const void* keys,
                                int64_t n, long long a, long long b, int su,
                                int eu, void* tile_last, void* tile_first,
                                void* prev_start, void* next_start, void* lo,
                                void* hi, cudaStream_t s) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  bounds_tiles<<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const uint8_t*)start, n, (int*)tile_last, (int*)tile_first);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bounds_scan<<<1, kScanThreads, 0, s>>>(
      (const int*)tile_last, (const int*)tile_first, ntiles,
      (int*)prev_start, (int*)next_start);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bounds_rows<MODE, K><<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const uint8_t*)start, (const K*)keys, n, a, b, su, eu,
      (const int*)prev_start, (const int*)next_start, (int*)lo, (int*)hi);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// W2: MIN/MAX over per-row [lo, hi]
// ---------------------------------------------------------------------

// Level 0 of the tile table: the MIN or MAX of each kSpan rows.
template <int FN, typename T>
__global__ void __launch_bounds__(kThreads)
minmax_tiles(const T* __restrict__ c, int64_t n, T* __restrict__ level0) {
  __shared__ T part[kThreads / 32];
  const int64_t start = (int64_t)blockIdx.x * kSpan;
  T acc = identity<FN, T>();
  for (int j = threadIdx.x; j < kSpan; j += kThreads) {
    const int64_t r = start + j;
    if (r < n) acc = combine<FN, T>(acc, c[r]);
  }
  for (int off = 16; off > 0; off >>= 1)
    acc = combine<FN, T>(acc, __shfl_down_sync(kFull, acc, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) acc = combine<FN, T>(acc, part[w]);
    level0[blockIdx.x] = acc;
  }
}

// Level k from level k - 1: the MIN or MAX of 2^k tiles from each tile.
template <int FN, typename T>
__global__ void __launch_bounds__(kThreads)
minmax_level(const T* __restrict__ prev, T* __restrict__ cur, int64_t ntiles,
             int64_t half) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= ntiles) return;
  cur[t] = t + half < ntiles ? combine<FN, T>(prev[t], prev[t + half])
                             : prev[t];
}

template <int FN, typename T>
__device__ __forceinline__ T walk(const T* __restrict__ c, int64_t from,
                                  int64_t to, T acc) {
  for (int64_t j = from; j <= to; ++j) acc = combine<FN, T>(acc, c[j]);
  return acc;
}

template <int FN, typename T>
__global__ void __launch_bounds__(kThreads)
minmax_rows(const T* __restrict__ c, const int* __restrict__ lo,
            const int* __restrict__ hi, int64_t n, const T* __restrict__ table,
            int64_t ntiles, T* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t l = lo[i], h = hi[i];
    T acc = identity<FN, T>();
    if (h >= l) {
      const int64_t tl = l / kSpan, th = h / kSpan;
      if (th - tl <= 1) {
        acc = walk<FN, T>(c, l, h, acc);
      } else {
        acc = walk<FN, T>(c, l, (tl + 1) * kSpan - 1, acc);
        const int64_t len = th - tl - 1;          // whole tiles between
        const int k = 63 - __clzll(len);
        const T* level = table + (int64_t)k * ntiles;
        acc = combine<FN, T>(acc, level[tl + 1]);
        acc = combine<FN, T>(acc, level[th - 1 - (1LL << k) + 1]);
        acc = walk<FN, T>(c, th * kSpan, h, acc);
      }
    }
    out[i] = acc;
  }
}

template <int FN, typename T>
cudaError_t launch_frame_minmax(const void* c, const void* lo, const void* hi,
                                int64_t n, void* table, int64_t ntiles,
                                int levels, void* out, cudaStream_t s) {
  T* tab = (T*)table;
  minmax_tiles<FN, T><<<(unsigned)ntiles, kThreads, 0, s>>>((const T*)c, n,
                                                            tab);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((ntiles + kThreads - 1) / kThreads);
  for (int k = 1; k < levels; ++k) {
    minmax_level<FN, T><<<blocks, kThreads, 0, s>>>(
        tab + (int64_t)(k - 1) * ntiles, tab + (int64_t)k * ntiles, ntiles,
        1LL << (k - 1));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  minmax_rows<FN, T><<<grid_stride_blocks(n), kThreads, 0, s>>>(
      (const T*)c, (const int*)lo, (const int*)hi, n, tab, ntiles, (T*)out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// W4: sliding float frame sums in the reference's order
// ---------------------------------------------------------------------
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// The thread of each segment's first row walks the segment: at its first
// row the sum restarts at 0 with the previous frame [lo, lo); on each row
// it subtracts the rows from the previous lo to this lo - 1 and then adds
// those from max(previous end, lo) to this end - 1, in index order, exactly
// as the reference's scan step (window.py:288-307) does.
template <typename T>
__global__ void __launch_bounds__(kThreads)
sliding_sum(const T* __restrict__ c, const int* __restrict__ lo,
            const int* __restrict__ hi, const uint8_t* __restrict__ is_start,
            int64_t n, T* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (!is_start[i]) continue;
    T s = T(0);
    int64_t plo = lo[i], pend = lo[i];
    for (int64_t r = i; r < n && (r == i || !is_start[r]); ++r) {
      const int64_t l = lo[r], e = (int64_t)hi[r] + 1;
      for (int64_t j = plo; j < l; ++j) s = sub_rn(s, c[j]);
      for (int64_t j = pend > l ? pend : l; j < e; ++j) s = add_rn(s, c[j]);
      out[r] = s;
      plo = l;
      pend = e;
    }
  }
}

#define WIN_TYPES(LAUNCH, FN, ...)                                            \
  switch (dtype) {                                                            \
    case kI32: return LAUNCH<FN, int, int, int>(__VA_ARGS__);                 \
    case kI64: return LAUNCH<FN, long long, long long, long long>(__VA_ARGS__); \
    case kF32: return LAUNCH<FN, float, float, float>(__VA_ARGS__);           \
    case kF64: return LAUNCH<FN, double, double, double>(__VA_ARGS__);        \
  }                                                                           \
  break;

}  // namespace

extern "C" {

// W1. fn: 0 sum, 1 count, 2 min, 3 max; dtype of vals: 0 int32, 1 int64,
// 2 float32, 3 float64 (vals may be null for count). vals holds each row's
// contribution (0 or the MIN/MAX sentinel where a row is dead or NULL) and
// live its count (0 or 1). Sums accumulate in int64 (integers) or float64
// (floats) and are written in the input's type; out_cnt is int64. Scratch:
// with ntiles = ceil(n / 4096), tile_f, tile_peer, next_peer int32[ntiles],
// tile_v, tile_c, carry_v, carry_c 8-byte[ntiles], peer_last int32[n].
int qs_window_prefix(int fn, int dtype, const void* vals, const void* live,
                     const void* seg_start, const void* peer_start, int64_t n,
                     void* tile_f, void* tile_v, void* tile_c, void* tile_peer,
                     void* carry_v, void* carry_c, void* next_peer,
                     void* peer_last, void* out_val, void* out_cnt,
                     void* stream) {
  if (n == 0) return cudaSuccess;
  if (n >= INT32_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define W1_ARGS vals, live, seg_start, peer_start, n, tile_f, tile_v, tile_c, \
    tile_peer, carry_v, carry_c, next_peer, peer_last, out_val, out_cnt, s
  switch (fn) {
    case kSum:
      switch (dtype) {
        case kI32: return launch_window_prefix<kSum, int, long long, int>(W1_ARGS);
        case kI64: return launch_window_prefix<kSum, long long, long long, long long>(W1_ARGS);
        case kF32: return launch_window_prefix<kSum, float, double, float>(W1_ARGS);
        case kF64: return launch_window_prefix<kSum, double, double, double>(W1_ARGS);
      }
      break;
    case kMin: WIN_TYPES(launch_window_prefix, kMin, W1_ARGS)
    case kMax: WIN_TYPES(launch_window_prefix, kMax, W1_ARGS)
    case kCount:
      return launch_window_prefix<kCount, uint8_t, long long, long long>(W1_ARGS);
  }
#undef W1_ARGS
  return cudaErrorInvalidValue;
}

// W3. mode: 0 ROWS, 1 RANGE; kdtype: the sorted first order key's type
// (RANGE only; keys may be null for ROWS). a and b: the PRECEDING and
// FOLLOWING offsets, ignored where start_unbounded / end_unbounded. Scratch:
// tile_last, tile_first, prev_start, next_start int32[ceil(n / 4096)].
// Writes int32 lo[n] and hi[n], hi = lo - 1 for an empty frame.
int qs_frame_bounds(int mode, int kdtype, const void* start, const void* keys,
                    int64_t n, int64_t a, int64_t b, int start_unbounded,
                    int end_unbounded, void* tile_last, void* tile_first,
                    void* prev_start, void* next_start, void* lo, void* hi,
                    void* stream) {
  if (n == 0) return cudaSuccess;
  if (n >= INT32_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define W3_ARGS start, keys, n, (long long)a, (long long)b, start_unbounded, \
    end_unbounded, tile_last, tile_first, prev_start, next_start, lo, hi, s
  if (mode == kRows) return launch_frame_bounds<kRows, int>(W3_ARGS);
  if (mode != kRange) return cudaErrorInvalidValue;
  switch (kdtype) {
    case kI32: return launch_frame_bounds<kRange, int>(W3_ARGS);
    case kI64: return launch_frame_bounds<kRange, long long>(W3_ARGS);
    case kF32: return launch_frame_bounds<kRange, float>(W3_ARGS);
    case kF64: return launch_frame_bounds<kRange, double>(W3_ARGS);
  }
#undef W3_ARGS
  return cudaErrorInvalidValue;
}

// W2. fn: 2 min, 3 max; c holds the sentinel at dead and NULL rows. table:
// levels x ntiles values of c's type, ntiles = ceil(n / 1024), levels =
// floor(log2(ntiles)) + 1. Writes out[n] of c's type, the sentinel where
// hi < lo.
int qs_frame_minmax(int fn, int dtype, const void* c, const void* lo,
                    const void* hi, int64_t n, void* table, int64_t ntiles,
                    int levels, void* out, void* stream) {
  if (n == 0) return cudaSuccess;
  if ((fn != kMin && fn != kMax) || n >= INT32_MAX ||
      ntiles != (n + kSpan - 1) / kSpan || levels < 1 ||
      (1LL << (levels - 1)) > ntiles)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define W2_LAUNCH(FN, T) \
  return launch_frame_minmax<FN, T>(c, lo, hi, n, table, ntiles, levels, out, s)
  switch (dtype) {
    case kI32: if (fn == kMin) W2_LAUNCH(kMin, int); W2_LAUNCH(kMax, int);
    case kI64: if (fn == kMin) W2_LAUNCH(kMin, long long); W2_LAUNCH(kMax, long long);
    case kF32: if (fn == kMin) W2_LAUNCH(kMin, float); W2_LAUNCH(kMax, float);
    case kF64: if (fn == kMin) W2_LAUNCH(kMin, double); W2_LAUNCH(kMax, double);
  }
#undef W2_LAUNCH
  return cudaErrorInvalidValue;
}

// W4. dtype: 2 float32 or 3 float64. is_start marks each segment's first
// row; lo/hi are each row's frame (hi = lo - 1 when empty). Writes out[n].
int qs_sliding_sum(int dtype, const void* c, const void* lo, const void* hi,
                   const void* is_start, int64_t n, void* out, void* stream) {
  if (n == 0) return cudaSuccess;
  if (n >= INT32_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = grid_stride_blocks(n);
  if (dtype == kF32) {
    sliding_sum<float><<<blocks, kThreads, 0, s>>>(
        (const float*)c, (const int*)lo, (const int*)hi,
        (const uint8_t*)is_start, n, (float*)out);
  } else if (dtype == kF64) {
    sliding_sum<double><<<blocks, kThreads, 0, s>>>(
        (const double*)c, (const int*)lo, (const int*)hi,
        (const uint8_t*)is_start, n, (double*)out);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // extern "C"
