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
// - W3 is two launches over tiles taken in ticket order: the last segment
//   start before each tile by a decoupled look-back over the tiles before
//   it, then, tiles in reverse order, the first start after each tile by
//   the same look-back toward the tiles after it, and each row's frame. Its
//   flags are read by 16-byte loads and its outputs written back through
//   shared memory; a RANGE bound is binary-searched once a thread (16 rows)
//   inside the row's segment, over the tile's keys staged with a halo, and
//   then stepped forward row by row: no (segment, value) packing and no
//   sort.
// - W2 stages each 1,024-row tile's frames in shared memory and answers a
//   frame of any length in a bounded number of on-chip reads (32-row
//   blocks' prefix and suffix, a sparse table over the blocks); frames
//   that leave the staged window read a table of 32-row, tile and
//   superblock aggregates, built only when one does.
// W4 is bound by its sequential order within a segment: its sums are a
// chain of dependent rounded adds, in the reference's order and in the
// values' own type, so that they equal the reference's bit for bit. Short
// segments are walked a thread each out of shared memory; a long one (one
// 15 M-row frame with no PARTITION BY) gets a block that streams its rows
// ahead of one walking thread, whose chain of adds is then the bound
// (qs_add_chain measures one add's latency).

#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_device.cuh"

namespace {

enum FrameMode { kRows = 0, kRange = 1 };

constexpr int kThreads = 256;
constexpr int kItems = 16;
constexpr int64_t kTile = (int64_t)kThreads * kItems;   // rows per tile
constexpr int kScanThreads = 1024;
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
// Two launches over tiles of kTile rows, each thread 16 consecutive rows
// whose start flags it reads by one 16-byte load. Launch 1 takes its tiles
// in ticket order and finds the last segment start before each tile by a
// decoupled look-back over the tiles before it; launch 2 takes them in
// reverse ticket order, finds the first start after its tile by the same
// look-back toward the tiles after it, and writes each row's frame. A tile
// that holds a start publishes its inclusive value at once, so a look-back
// reads past only the tiles inside one segment.

constexpr int kW3Halo = 256;                        // keys staged each side
constexpr int kPrevTiles = 16;                      // launch 1: tiles a block
constexpr int kW3Keys = kTile + 2 * kW3Halo;        // keys staged a tile
template <typename K>
constexpr int kW3KeyVecs = kW3Keys / (16 / sizeof(K)) / kThreads + 1;

__host__ __device__ constexpr int kpad(int e) { return e + (e >> 4); }
constexpr int kW3RowStride = kItems * 4 + 16;       // a thread's 16 int32
constexpr int kW3RowBytes = kThreads * kW3RowStride;
// A tile's status word: its flag in the top two bits, a row index + 1 in the
// low 32.
constexpr unsigned long long kStAgg = 1ull << 62;   // the tile's own value
constexpr unsigned long long kStInc = 2ull << 62;   // the value up to it
constexpr unsigned long long kStFlags = 3ull << 62;

struct AddOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

__device__ __forceinline__ unsigned long long st_word(unsigned long long flag,
                                                      int v) {
  return flag | (unsigned long long)((unsigned)v + 1u);
}

__device__ __forceinline__ int st_value(unsigned long long w) {
  return (int)((unsigned)(w & 0xffffffffull) - 1u);
}

// The largest (MAX) or smallest value of the tiles tile + dir, tile + 2 dir,
// ... up to the nearest one whose word holds its inclusive value, by one
// warp: each lane reads one status word, lane 0 the nearest; a word not yet
// published ends the window there, after a pause that doubles while lane
// 0's word is unpublished. Tiles past either end are inclusive identities.
template <bool MAX>
__device__ __forceinline__ int look_back_bound(
    const unsigned long long* status, int tile, int dir, int ntiles,
    int lane) {
  const int id = MAX ? -1 : kNone;
  int acc = id;
  unsigned pause = 32;
  for (int t = tile + dir;;) {
    const int at = t + dir * lane;
    const unsigned long long w =
        at >= 0 && at < ntiles
            ? *(volatile const unsigned long long*)(status + at)
            : st_word(kStInc, id);
    const unsigned inc = __ballot_sync(kFull, (w & kStFlags) == kStInc);
    const unsigned unpub = __ballot_sync(kFull, (w & kStFlags) == 0);
    const int first_inc = inc ? __ffs(inc) - 1 : 32;
    const int first_unpub = unpub ? __ffs(unpub) - 1 : 32;
    const bool done = first_inc < first_unpub;
    const int take = done ? first_inc + 1 : first_unpub;
    int v = lane < take ? st_value(w) : id;
    v = MAX ? __reduce_max_sync(kFull, v) : __reduce_min_sync(kFull, v);
    acc = MAX ? max(acc, v) : min(acc, v);
    if (done) return acc;
    if (take == 0) {
      __nanosleep(pause);
      pause = pause < 256 ? 2 * pause : pause;
    }
    t += dir * take;
  }
}

// The 16 start flags of a thread's load as bits; row 0 always starts one.
__device__ __forceinline__ unsigned start_bits(const uint4& m, int64_t r) {
  const unsigned w[4] = {m.x, m.y, m.z, m.w};
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kItems; ++j)
    bits |= (unsigned)(((w[j >> 2] >> (8 * (j & 3))) & 0xffu) != 0) << j;
  return r == 0 ? bits | 1u : bits;
}

// The thread's 16 flags from row r (0 at and past n): one 16-byte load
// where all 16 lie below n (the wrapper hands over 16-byte aligned flags).
__device__ __forceinline__ uint4 load_flags(const uint8_t* __restrict__ start,
                                            int64_t r, int64_t n) {
  if (r + kItems <= n) return __ldg(reinterpret_cast<const uint4*>(start + r));
  unsigned w[4] = {0, 0, 0, 0};
  for (int j = 0; j < kItems && r + j < n; ++j)
    w[j >> 2] |= (unsigned)start[r + j] << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Launch 1: prev_start[t], the last segment start before tile t (-1 for
// tile 0). A block takes kPrevTiles tiles in ticket order (a 16-byte load a
// thread a tile, all issued before any is used) and looks back once.
__global__ void __launch_bounds__(kThreads)
w3_prev(const uint8_t* __restrict__ start, int64_t n, int ntiles,
        int nsuper, int* ticket, unsigned long long* status,
        int* __restrict__ prev_start) {
  __shared__ int s_sup;
  __shared__ int s_warp[kThreads / 32][kPrevTiles];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_sup = atomicAdd(ticket, 1);
  __syncthreads();
  const int sup = s_sup;
  const int64_t first = (int64_t)sup * kPrevTiles;
  uint4 m[kPrevTiles];
#pragma unroll
  for (int k = 0; k < kPrevTiles; ++k)
    m[k] = load_flags(start, (first + k) * kTile +
                      (int64_t)threadIdx.x * kItems, n);
#pragma unroll
  for (int k = 0; k < kPrevTiles; ++k) {
    const int64_t r = (first + k) * kTile + (int64_t)threadIdx.x * kItems;
    const unsigned bits = r < n ? start_bits(m[k], r) : 0u;
    const int last = __reduce_max_sync(
        kFull, bits ? (int)(r + 31 - __clz(bits)) : -1);
    if (lane == 0) s_warp[warp][k] = last;
  }
  __syncthreads();
  if (warp != 0) return;
  int x = -1;                            // lane k: tile first + k's last start
  if (lane < kPrevTiles) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) x = max(x, s_warp[w][lane]);
  }
#pragma unroll
  for (int off = 1; off < kPrevTiles; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x = max(x, y);
  }
  const int total = __shfl_sync(kFull, x, kPrevTiles - 1);
  int ex = __shfl_up_sync(kFull, x, 1);
  if (lane == 0) ex = -1;
  volatile unsigned long long* own = status + sup;
  if (lane == 0) *own = st_word(total >= 0 ? kStInc : kStAgg, total);
  const int before =
      sup > 0 ? look_back_bound<true>(status, sup, -1, nsuper, lane) : -1;
  if (lane == 0 && total < 0) *own = st_word(kStInc, before);
  if (lane < kPrevTiles && first + lane < ntiles)
    prev_start[first + lane] = max(before, ex);
}

// Up to V 16-byte vectors a thread of src[from, to), all loaded before any
// is stored (from a multiple of 16 / sizeof(T), src on 16 bytes): vector q
// of a thread starts at element from + (threadIdx.x + q kThreads) EV.
// store() hands each element to put(index, value), the ragged tail read
// there directly.
template <typename T, int V, int NT = kThreads>
struct Staged {
  static constexpr int EV = 16 / sizeof(T);
  uint4 v[V];
  int64_t from, whole, to;

  __device__ __forceinline__ void load(const T* __restrict__ src,
                                       int64_t f, int64_t t) {
    from = f;
    to = t;
    whole = t > f ? f + (t - f) / EV * EV : f;
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int64_t i =
          from + ((int64_t)threadIdx.x + (int64_t)q * NT) * EV;
      if (i < whole) v[q] = __ldg(reinterpret_cast<const uint4*>(src + i));
    }
  }

  template <typename Put>
  __device__ __forceinline__ void store(const T* __restrict__ src,
                                        const Put& put) const {
#pragma unroll
    for (int q = 0; q < V; ++q) {
      const int64_t i =
          from + ((int64_t)threadIdx.x + (int64_t)q * NT) * EV;
      if (i < whole) {
        const T* x = reinterpret_cast<const T*>(&v[q]);
#pragma unroll
        for (int k = 0; k < EV; ++k) put(i + k, x[k]);
      }
    }
    for (int64_t i = whole + threadIdx.x; i < to; i += NT) put(i, src[i]);
  }
};

// Integer keys compare in int64, float keys in their own type, as the
// reference computes v - a and v + b; an int64 key's v + d wraps as the
// reference's int64 arithmetic does.
template <typename K> struct KeyMath { using Q = long long; };
template <> struct KeyMath<float> { using Q = float; };
template <> struct KeyMath<double> { using Q = double; };

template <typename Q>
__device__ __forceinline__ Q shift(Q v, long long d) {
  if constexpr (std::is_floating_point<Q>::value) return v + (Q)d;
  else return (Q)((unsigned long long)v + (unsigned long long)d);
}

// A read of global memory that the compiler cannot if-convert into a
// shared-memory read's path: a predicated-off global load writing the same
// register would hold every shared read behind a global load's latency.
template <typename T>
__device__ __noinline__ T read_global(const T* __restrict__ p, int j) {
  return __ldg(p + j);
}

// A RANGE bound inside one segment: the first row j whose key is not
// below q (UPPER: not at or below q), so that the lexicographic search of
// the reference over sorted rows gives the same row. key(j) reads the
// staged keys or, outside them, global memory.
template <bool UPPER, typename Q, typename KeyAt>
__device__ __forceinline__ bool below(const KeyAt& key, int j, Q q) {
  const Q m = (Q)key(j);
  return UPPER ? m <= q : m < q;
}

// binary search of [lo, hi)
template <bool UPPER, typename Q, typename KeyAt>
__device__ __forceinline__ int search(const KeyAt& key, int lo, int hi,
                                      Q q) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (below<UPPER>(key, mid, q)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// The answer in [p, end), p not after it. A frame moves a row or two from
// one row to the next, so the next four rows are read at once (their loads
// in flight together, no branch between them) and the answer is p plus the
// number of them below q; only where all four are does a search follow,
// steps of 1, 2, 4, ... and a binary search of the last one, so that a long
// way stays logarithmic.
template <bool UPPER, typename Q, typename KeyAt>
__device__ __forceinline__ int forward(const KeyAt& key, int p, int end,
                                       Q q) {
  int run = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    run += (p + k < end) & below<UPPER>(key, min(p + k, end - 1), q);
  if (run < 4) return p + run;
  int lo = p + 4;
  for (int step = 1;; step <<= 1) {
    const int probe = lo - 1 + step;
    if (probe >= end) return search<UPPER>(key, lo, end, q);
    if (!below<UPPER>(key, probe, q)) return search<UPPER>(key, lo, probe, q);
    lo = probe + 1;
  }
}

// The answer in [first, hi], row hi known not below q: steps of 1, 2, 4,
// ... back from hi, then a binary search of the last one.
template <bool UPPER, typename Q, typename KeyAt>
__device__ __forceinline__ int backward(const KeyAt& key, int first, int hi,
                                        Q q) {
  for (int step = 1;; step <<= 1) {
    const int probe = hi - step;
    if (probe < first) return search<UPPER>(key, first, hi, q);
    if (below<UPPER>(key, probe, q)) return search<UPPER>(key, probe + 1, hi, q);
    hi = probe;
  }
}

// Launch 2: each row's [lo, hi]. ROWS clamps r - a and r + b to the
// segment. RANGE: the tile's keys and kW3Halo rows each side are staged in
// shared memory (padded a bank every 16 keys, so that a thread's 16 rows
// start one bank past its neighbour's), and a search reads them unless its
// answer lies outside them. A thread searches both bounds of its first row
// inside the row's segment, from the row itself: where q = fl(v - a) <= v,
// lo <= r, and where q = fl(v + b) >= v, hi + 1 > r, so lo gallops back
// from r and hi forward from r + 1 (else, as for a NaN q or a wrapped int64
// sum, a binary search of the segment). For its next rows it steps both
// bounds forward, because within a segment of sorted keys fl(v - a) and
// fl(v + b) are nondecreasing in the row and so are both bounds. A segment
// start, or a q that is not at least the previous row's (keys that are not
// sorted, as dead rows' are), starts a new search, and no search leaves the
// row's segment. A NaN q is below no key: lo is the segment's first row and
// hi = lo - 1.
template <int MODE, typename K>
__global__ void __launch_bounds__(kThreads)
w3_rows(const uint8_t* __restrict__ start, const K* __restrict__ keys,
        int64_t n, int ntiles, long long a, long long b, int su, int eu,
        int* ticket, unsigned long long* status,
        const int* __restrict__ prev_start, int* __restrict__ lo_out,
        int* __restrict__ hi_out) {
  extern __shared__ __align__(16) uint8_t w3_smem[];
  uint8_t* lo_s = w3_smem;
  uint8_t* hi_s = w3_smem + kW3RowBytes;
  // the staged keys, row kb + e at ks[kpad(e)]
  K* ks = reinterpret_cast<K*>(w3_smem + 2 * kW3RowBytes);
  __shared__ int s_tile, s_next;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = ntiles - 1 - atomicAdd(ticket, 1);
  __syncthreads();
  const int tile = s_tile;
  const int prev = prev_start[tile];
  const int64_t base = (int64_t)tile * kTile;
  const int64_t r0 = base + (int64_t)threadIdx.x * kItems;
  const unsigned bits = r0 < n ? start_bits(load_flags(start, r0, n), r0)
                                : 0u;
  const int last = bits ? (int)(r0 + 31 - __clz(bits)) : -1;
  const int first = bits ? (int)(r0 + __ffs(bits) - 1) : kNone;
  int64_t kb = 0, ke = 0;
  Staged<K, kW3KeyVecs<K>> staged;
  if constexpr (MODE == kRange) {
    kb = base > kW3Halo ? base - kW3Halo : 0;
    ke = min(n, base + kTile + kW3Halo);
    staged.load(keys, kb, ke);
  }
  int total;
  const int before = block_exclusive_scan<kThreads>(last, -1, MaxOp(), total);
  int tile_first;
  const int after = block_suffix_min<kThreads>(first, tile_first);
  if constexpr (MODE == kRange)
    staged.store(keys, [&](int64_t i, K x) { ks[kpad((int)(i - kb))] = x; });
  if (warp == 0) {
    volatile unsigned long long* own = status + tile;
    if (lane == 0)
      *own = st_word(tile_first != kNone ? kStInc : kStAgg, tile_first);
    const int next = tile + 1 < ntiles
        ? look_back_bound<false>(status, tile, 1, ntiles, lane) : kNone;
    if (lane == 0) {
      if (tile_first == kNone) *own = st_word(kStInc, next);
      s_next = next;
    }
  }
  __syncthreads();
  // the segment of row r0 + j: [its last start at or before it, the first
  // start after it)
  const int sf0 = max(before, prev);
  int nx0 = min(after, s_next);
  if (nx0 == kNone) nx0 = (int)n;
  const auto seg_first = [&](int j) {
    const unsigned upto = bits & ((2u << j) - 1u);
    return upto ? (int)(r0 + 31 - __clz(upto)) : sf0;
  };
  const auto seg_end = [&](int j) {
    const unsigned later = bits >> (j + 1);
    return later ? (int)(r0 + j + __ffs(later)) : nx0;
  };
  if constexpr (MODE == kRows) {
    int lo[kItems], hi[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const long long r = r0 + j;
      const long long f = seg_first(j), e = seg_end(j);
      const long long l = su ? f : max(f, r - a);
      const long long h = eu ? e - 1 : min(e - 1, r + b);
      lo[j] = (int)l;
      hi[j] = (int)max(h, l - 1);
    }
    // a thread's row of 16 is padded by 16 bytes, so that its four 16-byte
    // stores meet no other thread's banks
#pragma unroll
    for (int q = 0; q < kItems / 4; ++q) {
      *reinterpret_cast<int4*>(lo_s + threadIdx.x * kW3RowStride + 16 * q) =
          make_int4(lo[4 * q], lo[4 * q + 1], lo[4 * q + 2], lo[4 * q + 3]);
      *reinterpret_cast<int4*>(hi_s + threadIdx.x * kW3RowStride + 16 * q) =
          make_int4(hi[4 * q], hi[4 * q + 1], hi[4 * q + 2], hi[4 * q + 3]);
    }
  } else {
    using Q = typename KeyMath<K>::Q;
    const int ikb = (int)kb, ike = (int)ke;
    // the staged keys [ikb, ike), and global memory for the rest: a search
    // reads the staged keys unless its answer lies outside them
    const auto skey = [&](int j) -> K { return ks[kpad(j - ikb)]; };
    const auto gkey = [&](int j) -> K { return read_global(keys, j); };
    // the answer in [p, e), p not after it
    const auto step = [&](auto upper, int p, int e, Q q) {
      constexpr bool U = decltype(upper)::value;
      if (p >= e) return p;
      const int lim = min(e, ike);
      if (p < ikb || p >= lim) return forward<U>(gkey, p, e, q);
      if (lim < e && below<U>(skey, lim - 1, q))
        return search<U>(gkey, lim, e, q);
      return forward<U>(skey, p, lim, q);
    };
    // lo in [f, r], row r (staged) not below q
    const auto back = [&](int f, int r, Q q) {
      if (f >= ikb) return backward<false>(skey, f, r, q);
      if (!below<false>(skey, ikb, q)) return search<false>(gkey, f, ikb, q);
      return backward<false>(skey, ikb + 1, r, q);
    };
    bool fresh = true;
    Q ql = 0, qh = 0;
    int pl = 0, ph = 0;
    for (int j = 0; j < kItems; ++j) {
      const int r = (int)r0 + j;
      if (r >= n) continue;
      if (bits >> j & 1u) fresh = true;
      const int f = seg_first(j), e = seg_end(j);
      const Q v = (Q)skey(r);
      int l = f, h = e - 1;
      if (!su) {
        const Q q = shift(v, -a);
        if (!(q <= v)) pl = search<false>(gkey, f, e, q);
        else if (fresh || !(q >= ql)) pl = back(f, r, q);
        else pl = step(std::false_type(), pl, e, q);
        ql = q;
        l = pl;
      }
      if (!eu) {
        const Q q = shift(v, b);
        if (!(q >= v)) ph = search<true>(gkey, f, e, q);
        else ph = step(std::true_type(), fresh || !(q >= qh) ? r + 1 : ph, e,
                       q);
        qh = q;
        h = ph - 1;
      }
      fresh = false;
      reinterpret_cast<int*>(lo_s + threadIdx.x * kW3RowStride)[j] = l;
      reinterpret_cast<int*>(hi_s + threadIdx.x * kW3RowStride)[j] =
          max(h, l - 1);
    }
  }
  __syncthreads();
  const int count = (int)(n - base < kTile ? n - base : kTile);
  const int bytes = count * 4;
  const int full = bytes & ~15;
  uint8_t* lo_d = reinterpret_cast<uint8_t*>(lo_out + base);
  uint8_t* hi_d = reinterpret_cast<uint8_t*>(hi_out + base);
  for (int o = threadIdx.x * 16; o < full; o += kThreads * 16) {
    const int at = (o / (kItems * 4)) * kW3RowStride + o % (kItems * 4);
    *reinterpret_cast<uint4*>(lo_d + o) =
        *reinterpret_cast<const uint4*>(lo_s + at);
    *reinterpret_cast<uint4*>(hi_d + o) =
        *reinterpret_cast<const uint4*>(hi_s + at);
  }
  for (int o = full + threadIdx.x; o < bytes; o += kThreads) {
    const int at = (o / (kItems * 4)) * kW3RowStride + o % (kItems * 4);
    lo_d[o] = lo_s[at];
    hi_d[o] = hi_s[at];
  }
}

// Shared memory beyond 48 KB must be asked for; the carveout is set to the
// most shared memory, so that as many blocks fit an SM as it allows.
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess || bytes <= 48 * 1024) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// scratch: int64 words: the two tickets, the status words of launch 1's
// blocks and of launch 2's tiles (ntiles each), then prev_start as
// int32[ntiles]
template <int MODE, typename K>
cudaError_t launch_frame_bounds(const void* start, const void* keys,
                                int64_t n, long long a, long long b, int su,
                                int eu, void* scratch, void* lo, void* hi,
                                cudaStream_t s) {
  const int64_t ntiles = (n + kTile - 1) / kTile;
  long long* w = (long long*)scratch;
  int* tickets = (int*)w;
  unsigned long long* st1 = (unsigned long long*)(w + 1);
  unsigned long long* st2 = st1 + ntiles;
  int* prev = (int*)(st2 + ntiles);
  cudaError_t err = cudaMemsetAsync(w, 0, (1 + 2 * ntiles) * 8, s);
  if (err != cudaSuccess) return err;
  const int64_t nsuper = (ntiles + kPrevTiles - 1) / kPrevTiles;
  w3_prev<<<(unsigned)nsuper, kThreads, 0, s>>>(
      (const uint8_t*)start, n, (int)ntiles, (int)nsuper, tickets, st1, prev);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int smem = 2 * kW3RowBytes +
      (MODE == kRange ? kpad(kW3Keys) * (int)sizeof(K) : 0);
  if ((err = allow_smem(w3_rows<MODE, K>, smem)) != cudaSuccess) return err;
  w3_rows<MODE, K><<<(unsigned)ntiles, kThreads, smem, s>>>(
      (const uint8_t*)start, (const K*)keys, n, (int)ntiles, a, b, su, eu,
      tickets + 1, st2, prev, (int*)lo, (int*)hi);
  return cudaGetLastError();
}

// dst[0, to - from) = src[from, to) by cp.async where whole 16 bytes (from a
// multiple of 16 / sizeof(T)); nothing where to <= from
template <typename T>
__device__ __forceinline__ void fetch(T* dst, const T* __restrict__ src,
                                      int64_t from, int64_t to) {
  constexpr int EV = 16 / sizeof(T);
  if (to <= from) return;
  const int64_t whole = from + (to - from) / EV * EV;
  for (int64_t i = from + (int64_t)threadIdx.x * EV; i < whole;
       i += (int64_t)kThreads * EV) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst + (i - from));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src + i));
  }
  for (int64_t i = whole + threadIdx.x; i < to; i += kThreads)
    dst[i - from] = src[i];
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------
// W2: MIN/MAX over per-row [lo, hi]
// ---------------------------------------------------------------------
// Three launches; the last two return at once unless some frame needs
// them, which only the device knows (no host sync).
//
// w2_rows, a block of kThreads a tile of kW2Tile rows: stages a window of
// c in shared memory (the tile and kW2Halo rows on each side) by cp.async
// while it reads the tile's lo and hi, so that a tile waits for device
// memory once. Where the tile's non-empty frames lie inside the window, it
// walks each frame there where none is longer than 8 rows, and else takes
// each covered 8-row block's prefix and suffix MIN/MAX by shuffles inside
// 8 lanes and, where a frame spans whole blocks, a sparse table
// over the block aggregates (only the levels the tile's frames need, at
// most kW2Levels: a tile with a frame over more than 2^kW2Levels whole
// blocks is deferred). A frame inside one block walks at most 7 staged
// values (none where it starts or ends on the block's edge); any other is
// suffix[lo] (+) the whole blocks between (two sparse-table reads) (+)
// prefix[hi] (van Herk / Gil-Werman). lo and hi are read from device
// memory once, c once more only for the halos, and out written once; 31
// KB of shared memory (8-byte values) leaves room for 7 blocks an SM.
// Staging the next tile while answering this one (a persistent grid, two
// windows) was slower, as were blocks of 128 or 512 threads. A tile
// whose frames leave the window goes on a device list and is left to the
// third launch.
// w2_table (only when the list is not empty): a block a superblock of
// kW2Super tiles builds the global aggregates in one pass over c: each
// 32-row block's MIN/MAX and its prefix and suffix within its tile, each
// tile's and its prefix and suffix within its superblock; the last block
// to finish builds the sparse table over the superblocks.
// w2_deferred (only when the list is not empty): each listed tile's rows,
// a warp 32 consecutive rows: a frame's two partial 32-row blocks (where
// the warp's frame ends fall in at most two blocks, a shuffle scan over
// them; else a walk of at most 32 values) and the whole blocks between
// from the table: at most 32 block or tile aggregates, or a suffix and a
// prefix at each level and two reads of the sparse table. No row reads
// more than about 100 values, whatever its frame's length. MIN/MAX is
// associative and commutative and a NaN wins from either side
// (seg_device.cuh combine), so the result is the value the reference's
// sparse table gives.
constexpr int kW2Tile = 1024;
constexpr int kW2Items = kW2Tile / kThreads;             // rows a thread
constexpr int kW2Halo = 64;                              // staged each side
constexpr int kW2Super = 32;                             // tiles a superblock

// the staged window: the tile and kW2Halo rows on each side
constexpr int kW2Window = kW2Tile + 2 * kW2Halo;
// the staged window's blocks: kW2Span rows each
constexpr int kW2Span = 8;
constexpr int kW2Blocks = kW2Window / kW2Span;
// levels of the staged sparse table: frames that span fewer than 2^3
// whole blocks are answered in the window (a tile with longer ones goes to
// w2_deferred), so that 7 blocks of 8-byte values fit an SM
constexpr int kW2Levels = 3;
template <typename T>
__host__ __device__ constexpr int w2_smem() {
  return (3 * kW2Window + kW2Levels * kW2Blocks) * (int)sizeof(T);
}
static_assert(kW2Halo % 32 == 0, "the window starts on a 32-row block");

// inclusive prefix and suffix MIN/MAX of v over the warp's lanes
template <int FN, typename T>
__device__ __forceinline__ void warp_pre_suf(T v, T& pre, T& suf) {
  const int lane = threadIdx.x & 31;
  pre = v;
  suf = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T a = __shfl_up_sync(kFull, pre, d);
    const T b = __shfl_down_sync(kFull, suf, d);
    if (lane >= d) pre = combine<FN, T>(pre, a);
    if (lane + d < 32) suf = combine<FN, T>(suf, b);
  }
}

// MIN/MAX of staged rows [j, k] (local indices): a walk of at most
// kW2Span - 1 values inside one block, else at most four reads
template <int FN, typename T, int NB>
__device__ __forceinline__ T w2_staged(const T* sc, const T* spre,
                                       const T* ssuf, const T* sp, int j,
                                       int k) {
  const int bl = j / kW2Span, bh = k / kW2Span;
  if (bl == bh) {
    if (j % kW2Span == 0) return spre[k];
    if (k % kW2Span == kW2Span - 1) return ssuf[j];
    T acc = sc[j];
    for (int x = j + 1; x <= k; ++x) acc = combine<FN, T>(acc, sc[x]);
    return acc;
  }
  T acc = combine<FN, T>(ssuf[j], spre[k]);
  const int mid = bh - bl - 1;                // whole blocks between
  if (mid > 0) {
    const int lev = 31 - __clz(mid);
    acc = combine<FN, T>(acc, sp[lev * NB + bl + 1]);
    acc = combine<FN, T>(acc, sp[lev * NB + bh - (1 << lev)]);
  }
  return acc;
}

// deferred: [0] the listed tiles, [1] w2_table's finished blocks, then the
// list. Thread t takes rows t, t + kThreads, ... of the tile.
template <int FN, typename T>
__global__ void __launch_bounds__(kThreads)
w2_rows(const T* __restrict__ c, const int* __restrict__ lo,
        const int* __restrict__ hi, int64_t n, int* __restrict__ deferred,
        T* __restrict__ out) {
  constexpr int WR = kW2Window;
  constexpr int NB = kW2Blocks;
  extern __shared__ __align__(16) unsigned char w2_smem_raw[];
  T* sc = reinterpret_cast<T*>(w2_smem_raw);
  T* spre = sc + WR;
  T* ssuf = spre + WR;
  T* sp = ssuf + WR;                          // kW2Levels levels of NB
  __shared__ int red[4][kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t t0 = (int64_t)blockIdx.x * kW2Tile;
  const int cnt = n - t0 < kW2Tile ? (int)(n - t0) : kW2Tile;
  const int64_t ws = t0 - kW2Halo;            // the window's first row
  const T none = identity<FN, T>();
  // the window's rows of c, by cp.async, while lo and hi are read
  {
    const int64_t from = ws < 0 ? 0 : ws;
    const int64_t to = ws + WR < n ? ws + WR : n;
    fetch<T>(sc + (from - ws), c, from, to);
    cp_async_commit();
    for (int j = threadIdx.x; j < WR; j += kThreads)
      if (ws + j < from || ws + j >= to) sc[j] = none;
  }
  int l[kW2Items], h[kW2Items];
#pragma unroll
  for (int k = 0; k < kW2Items; ++k) {
    const int r = k * kThreads + threadIdx.x;
    l[k] = r < cnt ? lo[t0 + r] : 0;
    h[k] = r < cnt ? hi[t0 + r] : -1;
  }
  // the frames' first and last rows, the most blocks one reaches past its
  // first, and the longest
  int mn = INT32_MAX, mx = -1, spans = 0, longest = 0;
#pragma unroll
  for (int k = 0; k < kW2Items; ++k)
    if (h[k] >= l[k]) {
      mn = min(mn, l[k]);
      mx = max(mx, h[k]);
      spans = max(spans, (int)((h[k] - ws) / kW2Span -
                               (l[k] - ws) / kW2Span));
      longest = max(longest, h[k] - l[k] + 1);
    }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    mn = min(mn, __shfl_xor_sync(kFull, mn, d));
    mx = max(mx, __shfl_xor_sync(kFull, mx, d));
    spans = max(spans, __shfl_xor_sync(kFull, spans, d));
    longest = max(longest, __shfl_xor_sync(kFull, longest, d));
  }
  if (lane == 0) {
    red[0][warp] = mn;
    red[1][warp] = mx;
    red[2][warp] = spans;
    red[3][warp] = longest;
  }
  cp_async_wait_all();
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    mn = min(mn, red[0][w]);
    mx = max(mx, red[1][w]);
    spans = max(spans, red[2][w]);
    longest = max(longest, red[3][w]);
  }
  if (mx < 0) {                               // every frame is empty
    for (int r = threadIdx.x; r < cnt; r += kThreads) out[t0 + r] = none;
    return;
  }
  if (mn < ws || mx >= ws + WR ||             // for w2_deferred
      spans > 1 << kW2Levels) {
    if (threadIdx.x == 0) deferred[2 + atomicAdd(deferred, 1)] = blockIdx.x;
    return;
  }
  if (longest <= kW2Span) {                   // short frames: walk them
#pragma unroll
    for (int k = 0; k < kW2Items; ++k) {
      const int r = k * kThreads + threadIdx.x;
      if (r < cnt) {
        T acc = none;
        for (int x = l[k]; x <= h[k]; ++x)
          acc = combine<FN, T>(acc, sc[x - ws]);
        out[t0 + r] = acc;
      }
    }
    return;
  }
  // the blocks the frames cover: each block's prefix and suffix by
  // shuffles inside kW2Span lanes, a warp 32 rows at a time, and its
  // aggregate
  const int b0 = (int)(mn - ws) / kW2Span, b1 = (int)(mx - ws) / kW2Span;
  for (int r = b0 * kW2Span + warp * 32; r < (b1 + 1) * kW2Span;
       r += kThreads) {
    const int j = r + lane;
    T p = j < WR ? sc[j] : none, s = p;
    const int part = lane % kW2Span;
#pragma unroll
    for (int d = 1; d < kW2Span; d <<= 1) {
      const T x = __shfl_up_sync(kFull, p, d, kW2Span);
      const T y = __shfl_down_sync(kFull, s, d, kW2Span);
      if (part >= d) p = combine<FN, T>(p, x);
      if (part + d < kW2Span) s = combine<FN, T>(s, y);
    }
    if (j < WR) {
      spre[j] = p;
      ssuf[j] = s;
      if (part == 0) sp[j / kW2Span] = s;
    }
  }
  __syncthreads();
  // the levels the frames read: spans - 1 whole blocks at most
  for (int k = 1; (1 << k) < spans; ++k) {
    const int half = 1 << (k - 1);
    for (int q = b0 + threadIdx.x; q + (1 << k) <= b1 + 1; q += kThreads)
      sp[k * NB + q] = combine<FN, T>(sp[(k - 1) * NB + q],
                                      sp[(k - 1) * NB + q + half]);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kW2Items; ++k) {
    const int r = k * kThreads + threadIdx.x;
    if (r < cnt)
      out[t0 + r] = h[k] < l[k]
                        ? none
                        : w2_staged<FN, T, NB>(sc, spre, ssuf, sp,
                                               (int)(l[k] - ws),
                                               (int)(h[k] - ws));
  }
}

// The global aggregates of w2_deferred, one table of T
template <typename T>
struct W2Table {
  T* agg;       // each 32-row block's MIN/MAX, 32 a tile
  T* pre;       // its prefix within its tile (from the tile's first block)
  T* suf;       // its suffix within its tile
  T* tagg;      // each tile's, kW2Super a superblock
  T* tpre;      // its prefix within its superblock
  T* tsuf;      // its suffix within its superblock
  T* sp;        // levels x nsuper: the sparse table over superblocks
  int64_t nsuper;
  int levels;
};

// a block a superblock at a time; the last block to finish builds the
// sparse table's upper levels
template <int FN, typename T>
__global__ void __launch_bounds__(kThreads)
w2_table(const T* __restrict__ c, int64_t n, int* deferred, W2Table<T> t) {
  constexpr int Q = 32 / (kThreads / 32);    // blocks of a tile a warp
  if (*(volatile int*)deferred == 0) return;
  __shared__ T blk[32];
  __shared__ T tl[kW2Super];
  __shared__ int last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T none = identity<FN, T>();
  for (int64_t sb = blockIdx.x; sb < t.nsuper; sb += gridDim.x) {
    for (int k = 0; k < kW2Super; ++k) {
      const int64_t tile = sb * kW2Super + k;
      const int64_t base = tile * kW2Tile;
      if (base >= n) {
        if (threadIdx.x == 0) tl[k] = none;
        continue;
      }
      // warp w takes blocks Q * w .. Q * w + Q - 1, a row a lane
      T v[Q];
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const int64_t r = base + (warp * Q + q) * 32 + lane;
        v[q] = r < n ? c[r] : none;
      }
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        T a = v[q];
#pragma unroll
        for (int d = 16; d > 0; d >>= 1)
          a = combine<FN, T>(a, __shfl_xor_sync(kFull, a, d));
        if (lane == 0) {
          blk[warp * Q + q] = a;
          t.agg[tile * 32 + warp * Q + q] = a;
        }
      }
      __syncthreads();
      if (warp == 0) {
        T p, s;
        warp_pre_suf<FN, T>(blk[lane], p, s);
        t.pre[tile * 32 + lane] = p;
        t.suf[tile * 32 + lane] = s;
        if (lane == 31) tl[k] = p;
      }
      __syncthreads();
    }
    __syncthreads();
    if (warp == 0) {
      T p, s;
      warp_pre_suf<FN, T>(tl[lane], p, s);
      const int64_t ti = sb * kW2Super + lane;
      t.tagg[ti] = tl[lane];
      t.tpre[ti] = p;
      t.tsuf[ti] = s;
      if (lane == 31) t.sp[sb] = p;
    }
    __syncthreads();
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(deferred + 1, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = 1; k < t.levels; ++k) {
    const int64_t half = 1LL << (k - 1);
    const T* prev = t.sp + (k - 1) * t.nsuper;
    T* cur = t.sp + k * t.nsuper;
    for (int64_t i = threadIdx.x; i + (1LL << k) <= t.nsuper; i += kThreads)
      cur[i] = combine<FN, T>(__ldcg(prev + i), __ldcg(prev + i + half));
    __syncthreads();
  }
}

// MIN/MAX of p[from .. to], at most 32 values
template <int FN, typename T>
__device__ __forceinline__ T w2_walk(const T* __restrict__ p, int64_t from,
                                     int64_t to) {
  T acc = identity<FN, T>();
  for (int64_t x = from; x <= to; ++x) acc = combine<FN, T>(acc, p[x]);
  return acc;
}

// MIN/MAX of the whole 32-row blocks b1 .. b2 from the global table: at
// most 32 block or tile aggregates, or a suffix and a prefix at each level
// and two reads of the sparse table
template <int FN, typename T>
__device__ __forceinline__ T w2_between(const W2Table<T>& t, int64_t b1,
                                        int64_t b2) {
  if (b1 > b2) return identity<FN, T>();
  if ((b1 >> 5) == (b2 >> 5)) return w2_walk<FN, T>(t.agg, b1, b2);
  T acc = combine<FN, T>(t.suf[b1], t.pre[b2]);
  const int64_t t1 = (b1 >> 5) + 1, t2 = (b2 >> 5) - 1;   // whole tiles
  if (t1 > t2) return acc;
  if ((t1 >> 5) == (t2 >> 5))
    return combine<FN, T>(acc, w2_walk<FN, T>(t.tagg, t1, t2));
  acc = combine<FN, T>(acc, combine<FN, T>(t.tsuf[t1], t.tpre[t2]));
  const int64_t s1 = (t1 >> 5) + 1, s2 = (t2 >> 5) - 1;   // superblocks
  if (s1 > s2) return acc;
  const int k = 63 - __clzll(s2 - s1 + 1);
  const T* level = t.sp + k * t.nsuper;
  return combine<FN, T>(acc, combine<FN, T>(level[s1],
                                            level[s2 - (1LL << k) + 1]));
}

__device__ __forceinline__ long long warp_min_ll(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = min(x, __shfl_xor_sync(kFull, x, d));
  return x;
}

__device__ __forceinline__ long long warp_max_ll(long long x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = max(x, __shfl_xor_sync(kFull, x, d));
  return x;
}

// For each lane that uses it, MIN/MAX of c from x to the end of x's 32-row
// block (SUFFIX) or from that block's start to x. Where the using lanes'
// x fall in at most two blocks, as a warp's consecutive rows' frame ends
// do, the warp loads those blocks a value a lane and scans them by
// shuffles; else each lane walks its own (at most 32 values).
template <int FN, typename T, bool SUFFIX>
__device__ __forceinline__ T w2_end(const T* __restrict__ c, int64_t n,
                                    int64_t x, bool use) {
  const int lane = threadIdx.x & 31;
  const int64_t b = x >> 5;
  const long long lo_b = warp_min_ll(use ? b : INT64_MAX);
  const long long hi_b = warp_max_ll(use ? b : -1);
  if (hi_b < 0) return identity<FN, T>();
  if (hi_b - lo_b > 1)
    return !use ? identity<FN, T>()
           : SUFFIX ? w2_walk<FN, T>(c, x, (b << 5) + 31)
                    : w2_walk<FN, T>(c, b << 5, x);
  const int64_t r0 = ((int64_t)lo_b << 5) + lane, r1 = r0 + 32;
  T v0 = r0 < n ? c[r0] : identity<FN, T>();
  T v1 = r1 < n ? c[r1] : identity<FN, T>();
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T a0 = SUFFIX ? __shfl_down_sync(kFull, v0, d)
                        : __shfl_up_sync(kFull, v0, d);
    const T a1 = SUFFIX ? __shfl_down_sync(kFull, v1, d)
                        : __shfl_up_sync(kFull, v1, d);
    if (SUFFIX ? lane + d < 32 : lane >= d) {
      v0 = combine<FN, T>(v0, a0);
      v1 = combine<FN, T>(v1, a1);
    }
  }
  const T e0 = __shfl_sync(kFull, v0, (int)(x & 31));
  const T e1 = __shfl_sync(kFull, v1, (int)(x & 31));
  return b == lo_b ? e0 : e1;
}

// a warp 32 consecutive rows of each listed tile
template <int FN, typename T>
__global__ void __launch_bounds__(kThreads)
w2_deferred(const T* __restrict__ c, const int* __restrict__ lo,
            const int* __restrict__ hi, int64_t n,
            const int* __restrict__ deferred, const W2Table<T> t,
            T* __restrict__ out) {
  const int count = deferred[0];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T none = identity<FN, T>();
  for (int i = blockIdx.x; i < count; i += gridDim.x) {
    const int64_t t0 = (int64_t)deferred[2 + i] * kW2Tile;
    const int cnt = n - t0 < kW2Tile ? (int)(n - t0) : kW2Tile;
    for (int r0 = warp * 32; r0 < cnt; r0 += kThreads) {
      const int r = r0 + lane;
      const bool in = r < cnt;
      const int l = in ? lo[t0 + r] : 0, h = in ? hi[t0 + r] : -1;
      const bool cross = h >= l && (l >> 5) != (h >> 5);
      const T left = w2_end<FN, T, true>(c, n, l, cross);
      const T right = w2_end<FN, T, false>(c, n, h, cross);
      T acc = none;
      if (cross)
        acc = combine<FN, T>(combine<FN, T>(left, right),
                             w2_between<FN, T>(t, (l >> 5) + 1,
                                               (h >> 5) - 1));
      else if (h >= l)
        acc = w2_walk<FN, T>(c, l, h);
      if (in) out[t0 + r] = acc;
    }
  }
}

// scratch: 2 + ceil(n / kW2Tile) int32; table: w2 table elements of T
// (ops/cuda.py frame_minmax)
template <int FN, typename T>
cudaError_t launch_frame_minmax(const void* c, const void* lo, const void* hi,
                                int64_t n, void* scratch, void* table,
                                int64_t nsuper, int levels, void* out,
                                cudaStream_t s) {
  const int64_t ntiles = (n + kW2Tile - 1) / kW2Tile;
  int* deferred = (int*)scratch;
  cudaError_t err = cudaMemsetAsync(deferred, 0, 2 * sizeof(int), s);
  if (err != cudaSuccess) return err;
  const int smem = w2_smem<T>();
  static bool smem_set = false;     // the attribute, once a kernel
  if (!smem_set) {
    if ((err = allow_smem(w2_rows<FN, T>, smem)) != cudaSuccess) return err;
    smem_set = true;
  }
  w2_rows<FN, T><<<(unsigned)ntiles, kThreads, smem, s>>>(
      (const T*)c, (const int*)lo, (const int*)hi, n, deferred, (T*)out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  W2Table<T> t;
  const int64_t blocks = nsuper * kW2Super * 32, tiles = nsuper * kW2Super;
  t.agg = (T*)table;
  t.pre = t.agg + blocks;
  t.suf = t.pre + blocks;
  t.tagg = t.suf + blocks;
  t.tpre = t.tagg + tiles;
  t.tsuf = t.tpre + tiles;
  t.sp = t.tsuf + tiles;
  t.nsuper = nsuper;
  t.levels = levels;
  w2_table<FN, T><<<grid_stride_blocks(nsuper * kThreads), kThreads, 0,
                    s>>>((const T*)c, n, deferred, t);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  w2_deferred<FN, T><<<grid_stride_blocks(ntiles * kThreads), kThreads, 0,
                       s>>>((const T*)c, (const int*)lo, (const int*)hi, n,
                            deferred, t, (T*)out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// W4: sliding float frame sums in the reference's order
// ---------------------------------------------------------------------
// The reference's step (window.py:288-307), the specification of both
// routes: at a segment's first row the sum restarts at 0 with the previous
// frame [lo, lo); on each row it subtracts the rows from the previous lo to
// this lo - 1, then adds those from max(previous end, lo) to this end - 1,
// one rounding a step in index order, in the values' own type. The rounding
// chain cannot be reassociated, so a segment is never split: parallelism
// comes from segments, and each walk runs at the latency of its dependent
// adds rather than of device memory.
//
// Short route (w4_short, a block of kW4Threads a tile of kW4Tile rows): the
// block loads its tile's flags, values, lo and hi at once, finds the
// segments that start in the tile (a scan of the flags), and walks those
// that end within kW4Span rows of the tile's start out of shared memory,
// a thread a segment, a warp's lanes a row at a time in step; a row a
// frame reaches outside the staged rows is read from global memory. The
// sums go back through shared memory. The one segment of a tile that can
// run further is appended to a list (an atomic counter).
//
// Long route (w4_long, a fixed grid over that list, a block a segment): the
// block streams kChunk rows at a time into a shared-memory ring (cp.async,
// the next chunk's flags, lo and hi and the chunk after next's values in
// flight during the walk). For each chunk it counts every row's subtract
// and add steps, scans them, and writes the chunk's steps in order as one
// stream of values (a subtracted value negated: fl(s - x) == fl(s + -x) in
// IEEE arithmetic), padded to a multiple of 8 with -0.0 (s + -0.0 == s for
// every s); one thread then walks the stream 8 values at a time, the next
// 8's 16-byte loads issued before this 8's adds, writing the sum after
// each step in place, and every thread reads back each row's sum at its
// last step. The walk costs one dependent rounded add a step.
constexpr int kW4Threads = 128;                // short route: threads a block
constexpr int kW4Tile = 1024;                  // rows whose segments a block owns
constexpr int kW4Span = 2 * kW4Tile;           // rows it may stage
constexpr int kW4Items = kW4Tile / kW4Threads; // start flags a thread scans
constexpr int kChunk = 1024;                   // long route: rows a chunk
constexpr int kChunkItems = kChunk / kThreads;
constexpr int kCap = 3072;                     // long route: steps a walk

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

template <typename T>
struct W4Short {
  __align__(16) T c[kW4Span];
  // lo and hi of each row; the thread that walks a row overwrites the pair
  // with the row's sum (no other thread reads it)
  __align__(16) int2 lohi[kW4Span];
  __align__(16) uint8_t flag[kW4Span];
  uint16_t start[kW4Tile];                     // the tile's segment starts
};

template <typename T>
__global__ void __launch_bounds__(kW4Threads)
w4_short(const T* __restrict__ c, const int* __restrict__ lo,
         const int* __restrict__ hi, const uint8_t* __restrict__ is_start,
         int64_t n, T* __restrict__ out, int* __restrict__ long_starts,
         int* __restrict__ long_count) {
  extern __shared__ __align__(16) uint8_t w4_smem[];
  W4Short<T>& sh = *reinterpret_cast<W4Short<T>*>(w4_smem);
  const int64_t base = (int64_t)blockIdx.x * kW4Tile;
  const int64_t span_end = min(n, base + (int64_t)kW4Span);
  const int64_t tile_end = min(n, base + (int64_t)kW4Tile);
  // every load of the tile's own rows is issued at once, before the scan
  // that finds which of them the block needs
  Staged<uint8_t, kW4Span / 16 / kW4Threads, kW4Threads> fl;
  Staged<T, kW4Tile / (16 / sizeof(T)) / kW4Threads, kW4Threads> cv;
  Staged<int, kW4Tile / 4 / kW4Threads, kW4Threads> lv, hv;
  fl.load(is_start, base, span_end);
  cv.load(c, base, tile_end);
  lv.load(lo, base, tile_end);
  hv.load(hi, base, tile_end);
  fl.store(is_start, [&](int64_t i, uint8_t x) { sh.flag[i - base] = x; });
  __syncthreads();
  // the tile's segment starts, in order (row 0 always starts one)
  const int i0 = threadIdx.x * kW4Items;
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < kW4Items; ++j) {
    const int64_t r = base + i0 + j;
    if (r < n && (sh.flag[i0 + j] || r == 0)) bits |= 1u << j;
  }
  int m;
  int at = block_exclusive_scan<kW4Threads>(__popc(bits), 0, AddOp(), m);
#pragma unroll
  for (int j = 0; j < kW4Items; ++j)
    if (bits >> j & 1u) sh.start[at++] = (uint16_t)(i0 + j);
  // the first start after the tile ends the tile's last segment
  int first = kNone;
  for (int j = 0; j < kW4Items; ++j) {
    const int i = kW4Tile + i0 + j;
    if (base + i < span_end && sh.flag[i]) {
      first = i;
      break;
    }
  }
  int halo_first;
  block_suffix_min<kW4Threads>(first, halo_first);
  if (m == 0) return;
  int64_t b;                                   // the staged segments' end
  if (halo_first != kNone) {
    b = base + halo_first;
  } else if (base + kW4Span >= n) {
    b = n;
  } else {                                     // the last one is long
    --m;
    b = base + sh.start[m];
    if (threadIdx.x == 0) long_starts[atomicAdd(long_count, 1)] = (int)b;
  }
  if (m == 0) return;
  const int64_t a = base + sh.start[0];
  cv.store(c, [&](int64_t i, T x) { sh.c[i - base] = x; });
  lv.store(lo, [&](int64_t i, int x) { sh.lohi[i - base].x = x; });
  hv.store(hi, [&](int64_t i, int x) { sh.lohi[i - base].y = x; });
  if (b > tile_end) {                          // the halo's rows
    cv.load(c, tile_end, b);
    lv.load(lo, tile_end, b);
    hv.load(hi, tile_end, b);
    cv.store(c, [&](int64_t i, T x) { sh.c[i - base] = x; });
    lv.store(lo, [&](int64_t i, int x) { sh.lohi[i - base].x = x; });
    hv.store(hi, [&](int64_t i, int x) { sh.lohi[i - base].y = x; });
  }
  __syncthreads();
  // rows as int offsets from base (n < 2^31); rows [base, staged) are in
  // shared memory
  const int ib = (int)base, iend = (int)(b - base);
  const int staged = (int)((b > tile_end ? b : tile_end) - base);
  const auto in_smem = [&](int j) { return j >= ib && j - ib < staged; };
  const auto value = [&](int j) -> T {
    return in_smem(j) ? sh.c[j - ib] : read_global(c, j);
  };
  // a warp's lanes walk their segments' rows in step: as many steps as the
  // warp's longest segment, each ending in a reconvergence
  for (int k0 = 0; k0 < m; k0 += kW4Threads) {
    const int k = k0 + threadIdx.x;
    const int s0 = k < m ? sh.start[k] : 0;
    const int e0 = k + 1 < m ? sh.start[k + 1] : (k < m ? iend : 0);
    const int steps = __reduce_max_sync(kFull, e0 - s0);
    T s = T(0);
    int2 f = sh.lohi[s0];
    int plo = f.x, pend = f.x;
    for (int t = 0; t < steps; ++t, __syncwarp()) {
      const int i = s0 + t;
      if (i >= e0) continue;
      const int2 g = sh.lohi[i + 1 < e0 ? i + 1 : i];
      const int l = f.x, e = f.y + 1;
      const int from = pend > l ? pend : l;
      const int subs = l - plo, adds = e - from;
      if (subs <= 1 && adds <= 1) {
        // at most one value leaves and one enters: both loads first (row
        // i itself stands in for a step that is not taken)
        const int xi = subs > 0 ? plo : ib + i;
        const int yi = adds > 0 ? from : ib + i;
        T x, y;
        if (in_smem(xi) && in_smem(yi)) {
          x = sh.c[xi - ib];
          y = sh.c[yi - ib];
        } else {
          x = value(xi);
          y = value(yi);
        }
        if (subs > 0) s = sub_rn(s, x);
        if (adds > 0) s = add_rn(s, y);
      } else {
        for (int j = plo; j < l; ++j) s = sub_rn(s, value(j));
        for (int j = from; j < e; ++j) s = add_rn(s, value(j));
      }
      *reinterpret_cast<T*>(&sh.lohi[i]) = s;
      plo = l;
      pend = e;
      f = g;
    }
  }
  __syncthreads();
  for (int64_t r = a + threadIdx.x; r < b; r += kW4Threads)
    out[r] = *reinterpret_cast<const T*>(&sh.lohi[r - base]);
}

template <typename T>
struct W4Long {
  __align__(16) T c[3][kChunk];                // values: chunk k in slot k % 3
  __align__(16) int lo[2][kChunk];             // chunk k in slot k % 2
  __align__(16) int hi[2][kChunk];
  __align__(16) long long end[kChunk];         // each row's last step + 1
  __align__(16) uint8_t flag[2][kChunk];
  __align__(16) T v[kCap];                     // the steps' values, then sums
};

// s after each of the groups x 8 values of v, written over them, in order:
// one dependent rounded add a value; the next group's loads are issued
// before this group's adds.
__device__ __forceinline__ void walk_steps(double* v, int groups,
                                           double& s) {
  double2* w = reinterpret_cast<double2*>(v);
  double2 a0 = w[0], a1 = w[1], a2 = w[2], a3 = w[3];
  for (int g = 0; g < groups; ++g) {
    double2 b0 = a0, b1 = a1, b2 = a2, b3 = a3;
    if (g + 1 < groups) {
      b0 = w[4 * g + 4];
      b1 = w[4 * g + 5];
      b2 = w[4 * g + 6];
      b3 = w[4 * g + 7];
    }
    double2 y0, y1, y2, y3;
    s = __dadd_rn(s, a0.x); y0.x = s;
    s = __dadd_rn(s, a0.y); y0.y = s;
    s = __dadd_rn(s, a1.x); y1.x = s;
    s = __dadd_rn(s, a1.y); y1.y = s;
    s = __dadd_rn(s, a2.x); y2.x = s;
    s = __dadd_rn(s, a2.y); y2.y = s;
    s = __dadd_rn(s, a3.x); y3.x = s;
    s = __dadd_rn(s, a3.y); y3.y = s;
    w[4 * g] = y0;
    w[4 * g + 1] = y1;
    w[4 * g + 2] = y2;
    w[4 * g + 3] = y3;
    a0 = b0; a1 = b1; a2 = b2; a3 = b3;
  }
}

__device__ __forceinline__ void walk_steps(float* v, int groups, float& s) {
  float4* w = reinterpret_cast<float4*>(v);
  float4 a0 = w[0], a1 = w[1];
  for (int g = 0; g < groups; ++g) {
    float4 b0 = a0, b1 = a1;
    if (g + 1 < groups) {
      b0 = w[2 * g + 2];
      b1 = w[2 * g + 3];
    }
    float4 y0, y1;
    s = __fadd_rn(s, a0.x); y0.x = s;
    s = __fadd_rn(s, a0.y); y0.y = s;
    s = __fadd_rn(s, a0.z); y0.z = s;
    s = __fadd_rn(s, a0.w); y0.w = s;
    s = __fadd_rn(s, a1.x); y1.x = s;
    s = __fadd_rn(s, a1.y); y1.y = s;
    s = __fadd_rn(s, a1.z); y1.z = s;
    s = __fadd_rn(s, a1.w); y1.w = s;
    w[2 * g] = y0;
    w[2 * g + 1] = y1;
    a0 = b0; a1 = b1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
w4_long(const T* __restrict__ c, const int* __restrict__ lo,
        const int* __restrict__ hi, const uint8_t* __restrict__ is_start,
        int64_t n, T* __restrict__ out, const int* __restrict__ long_starts,
        const int* __restrict__ long_count) {
  extern __shared__ __align__(16) uint8_t w4_smem[];
  W4Long<T>& sh = *reinterpret_cast<W4Long<T>*>(w4_smem);
  __shared__ T s_sum;                          // the walk's running sum
  __shared__ long long s_plo, s_pend;          // a chunk's last row's frame
  const int count = *long_count;
  const int i0 = threadIdx.x * kChunkItems;
  for (int li = blockIdx.x; li < count; li += gridDim.x) {
    const int64_t s0 = long_starts[li];
    const int64_t c0 = s0 & ~(int64_t)(kChunk - 1);   // chunk 0's first row
    const auto fetch_rows = [&](int slot, int64_t from) {
      const int64_t to = min(n, from + kChunk);
      fetch<int>(sh.lo[slot], lo, from, to);
      fetch<int>(sh.hi[slot], hi, from, to);
      fetch<uint8_t>(sh.flag[slot], is_start, from, to);
    };
    fetch_rows(0, c0);
    fetch<T>(sh.c[0], c, c0, min(n, c0 + kChunk));
    fetch<T>(sh.c[1], c, c0 + kChunk, min(n, c0 + 2 * kChunk));
    cp_async_commit();
    if (threadIdx.x == 0) s_sum = T(0);
    int64_t seg_end = n;
    for (int k = 0;; ++k) {
      const int64_t cb = c0 + (int64_t)k * kChunk;
      cp_async_wait_all();
      __syncthreads();
      const int slot = k & 1;
      const int* lo_s = sh.lo[slot];
      const int* hi_s = sh.hi[slot];
      // the frame before the chunk's first row (at the segment's first
      // row: [lo, lo))
      const long long p_lo = k == 0 ? lo_s[s0 - c0] : s_plo;
      const long long p_end = k == 0 ? lo_s[s0 - c0] : s_pend;
      const T carry = s_sum;
      fetch_rows(slot ^ 1, cb + kChunk);
      cp_async_commit();
      // the segment ends at its first start after s0
      int first = kNone;
#pragma unroll
      for (int q = 0; q < kChunkItems; ++q) {
        const int64_t r = cb + i0 + q;
        if (first == kNone && r > s0 && r < n && sh.flag[slot][i0 + q])
          first = i0 + q;
      }
      int chunk_first;
      block_suffix_min<kThreads>(first, chunk_first);
      if (chunk_first != kNone) seg_end = min(seg_end, cb + chunk_first);
      const int ilo = (int)(max(s0, cb) - cb);
      const int ihi = (int)(min(seg_end, cb + kChunk) - cb);
      // each row's steps: subtracts, then adds
      const auto frame = [&](int i, long long& l, long long& e,
                             long long& subs, long long& from_add) {
        const long long pl = i == ilo ? p_lo : lo_s[i - 1];
        const long long pe = i == ilo ? p_end : hi_s[i - 1] + 1LL;
        l = lo_s[i];
        e = hi_s[i] + 1LL;
        subs = l > pl ? l - pl : 0;
        from_add = pe > l ? pe : l;
      };
      long long cnt[kChunkItems];
      long long mine = 0;
#pragma unroll
      for (int q = 0; q < kChunkItems; ++q) {
        const int i = i0 + q;
        cnt[q] = 0;
        if (i >= ilo && i < ihi) {
          long long l, e, subs, from_add;
          frame(i, l, e, subs, from_add);
          cnt[q] = subs + (e > from_add ? e - from_add : 0);
        }
        mine += cnt[q];
      }
      long long steps;
      long long run = block_exclusive_scan<kThreads>(mine, 0LL, AddOp(), steps);
#pragma unroll
      for (int q = 0; q < kChunkItems; ++q) {
        run += cnt[q];
        sh.end[i0 + q] = run;
      }
      if (threadIdx.x == kThreads - 1) {
        s_plo = lo_s[kChunk - 1];
        s_pend = hi_s[kChunk - 1] + 1LL;
      }
      __syncthreads();
      const auto value = [&](long long j) -> T {
        const long long d = j - c0;
        if (d >= 0) {
          const long long kj = d / kChunk;
          if (kj + 1 >= k && kj <= k + 1) return sh.c[kj % 3][d % kChunk];
        }
        return read_global(c, (int)j);
      };
      for (long long p0 = 0; p0 == 0 || p0 < steps; p0 += kCap) {
        const int np = (int)min((long long)kCap, steps - p0);
        // the values of steps [p0, p0 + np): a run of them a thread, the
        // row of its first found by a binary search of end
        const int per = (np + kThreads - 1) / kThreads;
        const int k0 = threadIdx.x * per;
        const int k1 = min(np, k0 + per);
        if (k0 < k1) {
          int lo_i = ilo, hi_i = ihi - 1;
          while (lo_i < hi_i) {
            const int mid = (lo_i + hi_i) >> 1;
            if (sh.end[mid] > p0 + k0) hi_i = mid;
            else lo_i = mid + 1;
          }
          int i = lo_i;
          long long row_first = i == ilo ? 0 : sh.end[i - 1];
          long long l, e, subs, from_add;
          frame(i, l, e, subs, from_add);
          for (int kk = k0; kk < k1; ++kk) {
            while (p0 + kk >= sh.end[i]) {
              row_first = sh.end[i];
              frame(++i, l, e, subs, from_add);
            }
            const long long o = p0 + kk - row_first;
            sh.v[kk] = o < subs ? -value(l - subs + o)
                                : value(from_add + (o - subs));
          }
        }
        if (threadIdx.x == 0)
          for (int kk = np; kk < ((np + 7) & ~7); ++kk) sh.v[kk] = -T(0);
        __syncthreads();
        // the values two chunks ahead, in flight during the walk
        if (p0 + kCap >= steps)
          fetch<T>(sh.c[(k + 2) % 3], c, cb + 2 * kChunk,
                   min(n, cb + 3 * kChunk));
        cp_async_commit();
        if (threadIdx.x == 0) {
          T s = s_sum;
          walk_steps(sh.v, (np + 7) >> 3, s);
          s_sum = s;
        }
        __syncthreads();
        for (int i = ilo + threadIdx.x; i < ihi; i += kThreads) {
          const long long last = sh.end[i];
          if (last > p0 && last <= p0 + np) out[cb + i] = sh.v[last - 1 - p0];
          else if (last == 0) out[cb + i] = carry;
        }
        __syncthreads();
      }
      if (cb + kChunk >= seg_end) break;
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

// One thread, steps dependent rounded adds of x[1] to x[0] (steps a multiple
// of 16): the latency of one add in the chain, the bound of a walk.
template <typename T>
__global__ void add_chain(const T* __restrict__ x, int64_t steps,
                          T* __restrict__ out) {
  T s = x[0];
  const T d = x[1];
  for (int64_t i = 0; i < steps; i += 16) {
#pragma unroll
    for (int u = 0; u < 16; ++u) s = add_rn(s, d);
  }
  *out = s;
}

int long_route_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks = 2 * sms;
  }
  return blocks;
}

// scratch: int32 words: the long segments' count, then their starts (at
// most one a tile)
template <typename T>
cudaError_t launch_sliding_sum(const void* c, const void* lo, const void* hi,
                               const void* is_start, int64_t n,
                               void* scratch, void* out, cudaStream_t s) {
  const int64_t ntiles = (n + kW4Tile - 1) / kW4Tile;
  int* count = (int*)scratch;
  int* starts = count + 1;
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  if ((err = allow_smem(w4_short<T>, (int)sizeof(W4Short<T>))) != cudaSuccess)
    return err;
  w4_short<T><<<(unsigned)ntiles, kW4Threads, sizeof(W4Short<T>), s>>>(
      (const T*)c, (const int*)lo, (const int*)hi, (const uint8_t*)is_start,
      n, (T*)out, starts, count);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(w4_long<T>, (int)sizeof(W4Long<T>))) != cudaSuccess)
    return err;
  w4_long<T><<<long_route_blocks(), kThreads, sizeof(W4Long<T>), s>>>(
      (const T*)c, (const int*)lo, (const int*)hi, (const uint8_t*)is_start,
      n, (T*)out, starts, count);
  return cudaGetLastError();
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
// FOLLOWING offsets, ignored where start_unbounded / end_unbounded. start
// and keys start on 16 bytes. Scratch: 1 + 2 x ntiles + ceil(ntiles / 2)
// int64 words, ntiles = ceil(n / 4096). Writes int32 lo[n] and hi[n], hi =
// lo - 1 for an empty frame. Two launches.
int qs_frame_bounds(int mode, int kdtype, const void* start, const void* keys,
                    int64_t n, int64_t a, int64_t b, int start_unbounded,
                    int end_unbounded, void* scratch, void* lo, void* hi,
                    void* stream) {
  if (n == 0) return cudaSuccess;
  if (n >= INT32_MAX - kTile) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define W3_ARGS start, keys, n, (long long)a, (long long)b, start_unbounded, \
    end_unbounded, scratch, lo, hi, s
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

// W2. fn: 2 min, 3 max; c holds the sentinel at dead and NULL rows; c,
// lo and hi start on 16 bytes. scratch: 2 + ceil(n / 1024) int32. table:
// 3 * 1024 * nsuper + 3 * 32 * nsuper + levels * nsuper values of c's type,
// nsuper = ceil(n / 32768), levels = floor(log2(nsuper)) + 1 (written only
// where a frame leaves its tile's staged window). Writes out[n] of c's
// type, the sentinel where hi < lo. Three launches (and an 8-byte memset).
int qs_frame_minmax(int fn, int dtype, const void* c, const void* lo,
                    const void* hi, int64_t n, void* scratch, void* table,
                    int64_t nsuper, int levels, void* out, void* stream) {
  if (n == 0) return cudaSuccess;
  const int64_t per = (int64_t)kW2Tile * kW2Super;
  if ((fn != kMin && fn != kMax) || n >= INT32_MAX ||
      nsuper != (n + per - 1) / per || levels < 1 ||
      (1LL << (levels - 1)) > nsuper || (2LL << (levels - 1)) <= nsuper)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define W2_LAUNCH(FN, T) \
  return launch_frame_minmax<FN, T>(c, lo, hi, n, scratch, table, nsuper, \
                                    levels, out, s)
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
// row; lo/hi are each row's frame (hi = lo - 1 when empty). c, lo, hi and
// is_start start on 16 bytes. Scratch: 1 + ceil(n / 1024) int32 words.
// Writes out[n]. Two launches (and a 4-byte memset).
int qs_sliding_sum(int dtype, const void* c, const void* lo, const void* hi,
                   const void* is_start, int64_t n, void* scratch, void* out,
                   void* stream) {
  if (n == 0) return cudaSuccess;
  if (n >= INT32_MAX - kW4Span) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    return launch_sliding_sum<float>(c, lo, hi, is_start, n, scratch, out, s);
  if (dtype == kF64)
    return launch_sliding_sum<double>(c, lo, hi, is_start, n, scratch, out,
                                      s);
  return cudaErrorInvalidValue;
}

// The dependent-add probe: out[0] = x[0] + x[1] + ... (steps times, each
// rounded), by one thread; dtype 2 float32 or 3 float64, steps a multiple
// of 16.
int qs_add_chain(int dtype, const void* x, int64_t steps, void* out,
                 void* stream) {
  if (steps < 0 || steps % 16 != 0) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kF32)
    add_chain<float><<<1, 1, 0, s>>>((const float*)x, steps, (float*)out);
  else if (dtype == kF64)
    add_chain<double><<<1, 1, 0, s>>>((const double*)x, steps, (double*)out);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // extern "C"
