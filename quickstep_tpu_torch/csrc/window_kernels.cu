// Window-aggregate kernels for Hopper (sm_90a). Plain C interface, loaded
// with ctypes by quickstep_tpu_torch/ops/cuda.py; every function launches on
// the stream it is given, allocates nothing, and returns the cudaError_t of
// its launches. All of them work on rows already sorted by (partition keys,
// order keys), with bool flags marking the first row of each segment
// (partition) and of each peer group (rows with equal order keys).
//
// W1 qs_window_prefix replaces quickstep_tpu/ops/window.py:75
//    _segmented_scan, :239 _prefix_to_peers and :220 _seg_total: in its
//    running mode the inclusive SUM, MIN or MAX and the COUNT of each
//    segment up to the last row of the row's peer group; in its
//    whole-partition mode each segment's SUM, MIN or MAX and COUNT.
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
// - W1 is a tiled segmented scan that carries across tiles: reduce each
//   tile, scan the tile summaries in one block in tile order, then the rows
//   again, so one long segment is as fast as many short ones and float sums
//   repeat bit for bit. Tiles move between device and shared memory
//   coalesced; a peer group (a segment, in the whole-partition mode) that
//   ends inside its tile is resolved there, and the one-block scan gives
//   each tile the result of the group that spans its end, so that every
//   row's result is written once: inputs read twice, outputs written once.
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
// W1 works on tiles of kW1Tile rows, one block a tile, each thread owning
// kW1Items consecutive rows. A tile's columns are copied coalesced into
// shared memory (16-byte loads, neighbouring threads on neighbouring
// addresses) and each thread then reads its own rows from there; results
// go back the same way. A thread's row of items is padded by 16 bytes in
// shared memory, so that its 16-byte accesses meet no other thread's bank.
// "Boundary" below is where a result is read: the peer starts in the
// running mode, the segment starts in the whole-partition mode (every
// segment start is a peer start). The first row always starts both.
constexpr int kW1Items = 8;
constexpr int kW1Tile = kThreads * kW1Items;

// bytes of one thread's row of kW1Items elements of b bytes
__host__ __device__ constexpr int row_stride(int b) {
  return b * kW1Items >= 16 ? b * kW1Items + 16 : b * kW1Items;
}
constexpr int kW1RowBytes = kThreads * row_stride(8);

// the tile's count elements of B bytes from src (16-byte aligned) into the
// threads' rows in smem
template <int B>
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ src,
                                          int count, uint8_t* smem) {
  constexpr int RB = B * kW1Items;
  constexpr int RS = row_stride(B);
  const int bytes = count * B;
  const int full = bytes & ~15;
  for (int o = threadIdx.x * 16; o < full; o += kThreads * 16)
    *reinterpret_cast<uint4*>(smem + (o / RB) * RS + o % RB) =
        __ldg(reinterpret_cast<const uint4*>(src + o));
  for (int o = full + threadIdx.x; o < bytes; o += kThreads)
    smem[(o / RB) * RS + o % RB] = src[o];
}

// the inverse of load_tile: the threads' rows in smem to dst
template <int B>
__device__ __forceinline__ void store_tile(uint8_t* __restrict__ dst,
                                           int count,
                                           const uint8_t* smem) {
  constexpr int RB = B * kW1Items;
  constexpr int RS = row_stride(B);
  const int bytes = count * B;
  const int full = bytes & ~15;
  for (int o = threadIdx.x * 16; o < full; o += kThreads * 16)
    *reinterpret_cast<uint4*>(dst + o) =
        *reinterpret_cast<const uint4*>(smem + (o / RB) * RS + o % RB);
  for (int o = full + threadIdx.x; o < bytes; o += kThreads)
    dst[o] = smem[(o / RB) * RS + o % RB];
}

// element e of the tile in the row layout of its type
template <typename E>
__device__ __forceinline__ E& at(uint8_t* smem, int e) {
  return reinterpret_cast<E*>(smem + (e / kW1Items) * row_stride(sizeof(E)))
      [e % kW1Items];
}

// A tile's rows in shared memory, and this thread's items read from there.
template <int FN, typename T, typename A, bool WHOLE>
struct W1Rows {
  __align__(16) uint8_t val[kW1RowBytes];
  __align__(16) uint8_t live[kW1Tile];
  __align__(16) uint8_t seg[kW1Tile];
  __align__(16) uint8_t peer[WHOLE ? 16 : kW1Tile];

  __device__ __forceinline__ int load(const T* vals, const uint8_t* lv,
                                      const uint8_t* sg, const uint8_t* pr,
                                      int64_t n, int64_t base) {
    const int count = (int)(n - base < kW1Tile ? n - base : kW1Tile);
    if constexpr (FN != kCount)
      load_tile<sizeof(T)>(reinterpret_cast<const uint8_t*>(vals + base),
                           count, val);
    load_tile<1>(lv + base, count, live);
    load_tile<1>(sg + base, count, seg);
    if constexpr (!WHOLE) load_tile<1>(pr + base, count, peer);
    __syncthreads();
    return count;
  }

  // this thread's item j as a segmented element (the identity past count);
  // b: the row is a boundary
  __device__ __forceinline__ Seg<A> item(int j, int count, bool first_tile,
                                         bool& b) {
    const int i = threadIdx.x * kW1Items + j;
    Seg<A> x = {0, identity<FN, A>(), 0};
    b = false;
    if (i >= count) return x;
    x.f = seg[i] != 0 || (first_tile && i == 0);
    if constexpr (FN != kCount) x.v = (A)at<T>(val, i);
    x.c = live[i] != 0;
    b = x.f || (!WHOLE && peer[i] != 0);
    return x;
  }
};

// Pass 1: each tile's summary (tile_f, tile_v, tile_c), whether it holds a
// boundary (tile_b), and its head: the combination of its rows before its
// first boundary (head_v, head_c), the whole tile where it has none.
template <int FN, typename T, typename A, bool WHOLE>
__global__ void __launch_bounds__(kThreads)
w1_tiles(const T* __restrict__ vals, const uint8_t* __restrict__ live,
         const uint8_t* __restrict__ seg_start,
         const uint8_t* __restrict__ peer_start, int64_t n,
         int* __restrict__ tile_f, int* __restrict__ tile_b,
         A* __restrict__ tile_v, long long* __restrict__ tile_c,
         A* __restrict__ head_v, long long* __restrict__ head_c) {
  __shared__ W1Rows<FN, T, A, WHOLE> rows;
  const SegOp<FN, A> op;
  const Seg<A> id = {0, identity<FN, A>(), 0};
  const int64_t base = (int64_t)blockIdx.x * kW1Tile;
  const int count = rows.load(vals, live, seg_start, peer_start, n, base);
  Seg<A> s = id, head = id;
  int first_b = kNone;
  for (int j = 0; j < kW1Items; ++j) {
    bool b;
    const Seg<A> x = rows.item(j, count, base == 0, b);
    s = op(s, x);
    if (first_b == kNone) {
      if (b) first_b = threadIdx.x * kW1Items + j;
      else head = op(head, x);
    }
  }
  Seg<A> total;
  const Seg<A> ex = block_exclusive_scan<kThreads>(s, id, op, total);
  int tile_first;
  block_suffix_min<kThreads>(first_b, tile_first);
  // no segment starts before the first boundary, so the head is a plain
  // combination: the threads before the first one with a boundary, then
  // that thread's items before it
  if (tile_first != kNone && first_b == tile_first) {
    const Seg<A> h = op(ex, head);
    head_v[blockIdx.x] = h.v;
    head_c[blockIdx.x] = h.c;
  }
  if (threadIdx.x == 0) {
    tile_f[blockIdx.x] = total.f;
    tile_v[blockIdx.x] = total.v;
    tile_c[blockIdx.x] = total.c;
    tile_b[blockIdx.x] = tile_first != kNone;
    if (tile_first == kNone) {
      head_v[blockIdx.x] = total.v;
      head_c[blockIdx.x] = total.c;
    }
  }
}

// Pass 2, one block, tiles in order: each tile's carry (the value and count
// since the last segment start before it: carry_v, carry_c); for a tile
// with a boundary, the result of the peer group its head closes (written
// over head_v, head_c); then, over tile_v and tile_c, each tile's open
// result: that of the peer group holding its last row, closed by the next
// tile with a boundary or by the end of the rows.
template <int FN, typename A>
__global__ void __launch_bounds__(kScanThreads)
w1_scan(const int* __restrict__ tile_f, const int* __restrict__ tile_b,
        A* __restrict__ tile_v, long long* __restrict__ tile_c,
        A* __restrict__ head_v, long long* __restrict__ head_c,
        int64_t ntiles, A* __restrict__ carry_v,
        long long* __restrict__ carry_c) {
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
      if (tile_b[t]) {
        const Seg<A> close = op(in, Seg<A>{0, head_v[t], head_c[t]});
        head_v[t] = close.v;
        head_c[t] = close.c;
      }
    }
    carry = op(carry, total);
  }
  __syncthreads();
  int after = kNone;
  const int64_t chunks = (ntiles + kScanThreads - 1) / kScanThreads;
  for (int64_t k = chunks - 1; k >= 0; --k) {
    const int64_t t = k * kScanThreads + threadIdx.x;
    int total;
    const int ex = block_suffix_min<kScanThreads>(
        t < ntiles && tile_b[t] ? (int)t : kNone, total);
    const int next = min(ex, after);
    if (t < ntiles) {
      tile_v[t] = next == kNone ? carry.v : head_v[next];
      tile_c[t] = next == kNone ? carry.c : head_c[next];
    }
    after = min(after, total);
  }
}

// Pass 3: each row's result, written once. A row whose peer group ends in
// its tile reads the inclusive prefix at the group's last row, kept in
// shared memory; the rows before the tile's first boundary take the open
// result of the tile before, those after its last boundary the tile's own.
template <int FN, typename T, typename A, typename O, bool WHOLE>
__global__ void __launch_bounds__(kThreads)
w1_rows(const T* __restrict__ vals, const uint8_t* __restrict__ live,
        const uint8_t* __restrict__ seg_start,
        const uint8_t* __restrict__ peer_start, int64_t n,
        const A* __restrict__ carry_v, const long long* __restrict__ carry_c,
        const A* __restrict__ open_v, const long long* __restrict__ open_c,
        O* __restrict__ out_val, long long* __restrict__ out_cnt) {
  __shared__ W1Rows<FN, T, A, WHOLE> rows;
  __shared__ __align__(16) uint8_t cnt[kW1RowBytes];
  const SegOp<FN, A> op;
  const Seg<A> id = {0, identity<FN, A>(), 0};
  const int64_t base = (int64_t)blockIdx.x * kW1Tile;
  const int count = rows.load(vals, live, seg_start, peer_start, n, base);
  Seg<A> x[kW1Items];
  bool b[kW1Items];
  Seg<A> s = id;
  int first_b = kNone;
  for (int j = 0; j < kW1Items; ++j) {
    x[j] = rows.item(j, count, base == 0, b[j]);
    s = op(s, x[j]);
    if (b[j] && first_b == kNone) first_b = threadIdx.x * kW1Items + j;
  }
  Seg<A> total;
  const Seg<A> ex = block_exclusive_scan<kThreads>(s, id, op, total);
  // every thread has read its items (the scan synchronised): the value
  // rows now take the inclusive prefixes
  Seg<A> cur = op(Seg<A>{0, carry_v[blockIdx.x], carry_c[blockIdx.x]}, ex);
  for (int j = 0; j < kW1Items; ++j) {
    cur = op(cur, x[j]);
    const int i = threadIdx.x * kW1Items + j;
    at<A>(rows.val, i) = cur.v;
    at<long long>(cnt, i) = cur.c;
  }
  int tile_first;
  int next = block_suffix_min<kThreads>(first_b, tile_first);
  const A prev_v = blockIdx.x > 0 ? open_v[blockIdx.x - 1] : id.v;
  const long long prev_c = blockIdx.x > 0 ? open_c[blockIdx.x - 1] : 0;
  A rv[kW1Items];
  long long rc[kW1Items];
  for (int j = kW1Items - 1; j >= 0; --j) {
    const int i = threadIdx.x * kW1Items + j;
    const int end = next;                 // the next boundary after row i
    if (b[j]) next = i;
    if (tile_first == kNone || i < tile_first) {
      rv[j] = prev_v;
      rc[j] = prev_c;
    } else if (end == kNone) {
      rv[j] = open_v[blockIdx.x];
      rc[j] = open_c[blockIdx.x];
    } else {
      rv[j] = at<A>(rows.val, end - 1);
      rc[j] = at<long long>(cnt, end - 1);
    }
  }
  __syncthreads();
  for (int j = 0; j < kW1Items; ++j) {
    const int i = threadIdx.x * kW1Items + j;
    if constexpr (FN != kCount) at<O>(rows.val, i) = (O)rv[j];
    at<long long>(cnt, i) = rc[j];
  }
  __syncthreads();
  if constexpr (FN != kCount)
    store_tile<sizeof(O)>(reinterpret_cast<uint8_t*>(out_val + base), count,
                          rows.val);
  store_tile<8>(reinterpret_cast<uint8_t*>(out_cnt + base), count, cnt);
}

int grid_stride_blocks(int64_t n) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)sms * 8;
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

// scratch: 7 x ntiles int64 words (tile_v, tile_c, head_v, head_c, carry_v,
// carry_c, then tile_f and tile_b as int32)
template <int FN, typename T, typename A, typename O, bool WHOLE>
cudaError_t launch_w1(const void* vals, const void* live,
                      const void* seg_start, const void* peer_start,
                      int64_t n, void* scratch, void* out_val, void* out_cnt,
                      cudaStream_t s) {
  const int64_t ntiles = (n + kW1Tile - 1) / kW1Tile;
  long long* w = (long long*)scratch;
  A* tile_v = (A*)w;
  long long* tile_c = w + ntiles;
  A* head_v = (A*)(w + 2 * ntiles);
  long long* head_c = w + 3 * ntiles;
  A* carry_v = (A*)(w + 4 * ntiles);
  long long* carry_c = w + 5 * ntiles;
  int* tile_f = (int*)(w + 6 * ntiles);
  int* tile_b = tile_f + ntiles;
  w1_tiles<FN, T, A, WHOLE><<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const T*)vals, (const uint8_t*)live, (const uint8_t*)seg_start,
      (const uint8_t*)peer_start, n, tile_f, tile_b, tile_v, tile_c, head_v,
      head_c);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  w1_scan<FN, A><<<1, kScanThreads, 0, s>>>(tile_f, tile_b, tile_v, tile_c,
                                            head_v, head_c, ntiles, carry_v,
                                            carry_c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  w1_rows<FN, T, A, O, WHOLE><<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const T*)vals, (const uint8_t*)live, (const uint8_t*)seg_start,
      (const uint8_t*)peer_start, n, carry_v, carry_c, tile_v, tile_c,
      (O*)out_val, (long long*)out_cnt);
  return cudaGetLastError();
}

template <int FN, typename T, typename A, typename O>
cudaError_t launch_window_prefix(bool whole, const void* vals,
                                 const void* live, const void* seg_start,
                                 const void* peer_start, int64_t n,
                                 void* scratch, void* out_val, void* out_cnt,
                                 cudaStream_t s) {
  if (whole)
    return launch_w1<FN, T, A, O, true>(vals, live, seg_start, peer_start, n,
                                        scratch, out_val, out_cnt, s);
  return launch_w1<FN, T, A, O, false>(vals, live, seg_start, peer_start, n,
                                       scratch, out_val, out_cnt, s);
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
// live its count (0 or 1). whole: the whole-partition mode (each row takes
// its segment's result; peer_start is not read), else the running mode
// (each row takes the prefix at the last row of its peer group). Sums
// accumulate in int64 (integers) or float64 (floats) and are written in the
// input's type; out_cnt is int64. vals, live, the flags and the outputs
// start on 16 bytes. Scratch: 7 x ceil(n / 2048) int64 words.
int qs_window_prefix(int fn, int dtype, int whole, const void* vals,
                     const void* live, const void* seg_start,
                     const void* peer_start, int64_t n, void* scratch,
                     void* out_val, void* out_cnt, void* stream) {
  if (n == 0) return cudaSuccess;
  if (n >= INT32_MAX) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define W1_ARGS whole != 0, vals, live, seg_start, peer_start, n, scratch, \
    out_val, out_cnt, s
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
