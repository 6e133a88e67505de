// Aggregation kernels for Hopper (sm_90a): the masked scalar reduce, the
// dense (collision-free) group-by and the segmented reduce of the sort
// group-by. Plain C interface, loaded with ctypes by
// quickstep_tpu_torch/ops/cuda.py; every function launches on the stream it is
// given, allocates nothing, and returns the cudaError_t of its launches.
//
// qs_masked_reduce replaces quickstep_tpu/ops/groupby.py:435 scalar_agg (and
// the retired Pallas scan kernel, ops/pallas_scan.py:57 _pallas_scan_agg).
// qs_dense_aggregate replaces quickstep_tpu/ops/groupby.py:39
// pack_dense_index and :56 dense_groupby (_dense_groupby_broadcast :72 /
// _dense_groupby_scatter :110, and the retired Pallas kernel
// ops/pallas_groupby.py:95 _run): the packing and every aggregate of one
// dense GROUP BY in one pass.
// qs_segment_reduce replaces the segmented reductions of
// quickstep_tpu/ops/groupby.py:204 sort_groupby (:146 _seg_fill, :187
// _seg_minmax32 and the prefix-sum differences); the sort itself is
// torch.sort. The TPU formulation (packed cummax scans, differences of
// prefix sums) existed because TPU gathers and scatters are slow; here each
// group is reduced directly from its rows, which also makes float64 sums
// more exact than the reference's.
//
// What bounds them on an H100: bytes read from device memory. Each row is
// touched once; per row the scalar reduce reads 1 byte of live mask, 1 byte
// of validity when the column is nullable and the value itself (4 or 8
// bytes), and does a handful of ALU operations, far below the card's
// ~300 operations per byte. The design therefore streams each column once
// with coalesced grid-stride loads, keeps every partial result in registers
// or shared memory, and writes only one partial per block (scalar) or one
// set of [domain] tables per block (group-by) to device memory before a
// second tiny launch folds the partials in a fixed order.
//
// Results: integer sums, counts, minima and maxima are exact. All three are
// deterministic (fixed tiles, fixed shuffle trees, partials and carries
// combined in a fixed order, no atomics on values), so float sums repeat
// bit for bit from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

#include "seg_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDomain = 128;

// Block-wide reduction of (value, count): warp shuffles, one slot per warp in
// shared memory, then the first warp. The result is valid in thread 0.
template <int FN, typename A>
__device__ __forceinline__ void block_reduce(A& v, long long& c) {
  __shared__ A s_v[kWarps];
  __shared__ long long s_c[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    v = combine<FN, A>(v, __shfl_down_sync(0xffffffffu, v, off));
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_v[warp] = v;
    s_c[warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_v[lane] : identity<FN, A>();
    c = lane < kWarps ? s_c[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      v = combine<FN, A>(v, __shfl_down_sync(0xffffffffu, v, off));
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
  }
}

// ---------------------------------------------------------------------
// K1: masked scalar reduce. Pass 1: one (value, count) partial per block.
// ---------------------------------------------------------------------
template <int FN, typename T, typename A>
__global__ void __launch_bounds__(kThreads)
masked_reduce_partial(const T* __restrict__ vals,
                      const uint8_t* __restrict__ valid,
                      const uint8_t* __restrict__ alive, int64_t n,
                      A* __restrict__ part_val,
                      long long* __restrict__ part_cnt) {
  A acc = identity<FN, A>();
  long long cnt = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const bool live = alive[i] && (valid == nullptr || valid[i]);
    if (live) {
      cnt += 1;
      if constexpr (FN != kCount) acc = combine<FN, A>(acc, (A)vals[i]);
    }
  }
  block_reduce<FN, A>(acc, cnt);
  if (threadIdx.x == 0) {
    part_val[blockIdx.x] = acc;
    part_cnt[blockIdx.x] = cnt;
  }
}

// Pass 2: one block folds the per-block partials in a fixed order.
template <int FN, typename A, typename O>
__global__ void __launch_bounds__(kThreads)
masked_reduce_final(const A* __restrict__ part_val,
                    const long long* __restrict__ part_cnt, int blocks,
                    O* __restrict__ out_val, long long* __restrict__ out_cnt) {
  A acc = identity<FN, A>();
  long long cnt = 0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    acc = combine<FN, A>(acc, part_val[b]);
    cnt += part_cnt[b];
  }
  block_reduce<FN, A>(acc, cnt);
  if (threadIdx.x == 0) {
    if constexpr (FN != kCount) *out_val = (O)acc;
    *out_cnt = cnt;
  }
}

template <int FN, typename T, typename A, typename O>
cudaError_t launch_masked_reduce(const void* vals, const void* valid,
                                 const void* alive, int64_t n, void* part_val,
                                 void* part_cnt, int blocks, void* out_val,
                                 void* out_cnt, cudaStream_t stream) {
  masked_reduce_partial<FN, T, A><<<blocks, kThreads, 0, stream>>>(
      (const T*)vals, (const uint8_t*)valid, (const uint8_t*)alive, n,
      (A*)part_val, (long long*)part_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  masked_reduce_final<FN, A, O><<<1, kThreads, 0, stream>>>(
      (const A*)part_val, (const long long*)part_cnt, blocks, (O*)out_val,
      (long long*)out_cnt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// K2: one dense GROUP BY in one pass (qs_dense_aggregate). Each row's group
// is packed from its key columns in registers, with pack_dense_index's
// int64 arithmetic (wrapping): sum of (key - offset) * stride; a row is kept
// where it is alive and 0 <= index < domain. One launch reads the key
// columns, the live mask and each aggregate's values once and keeps, per
// group, every accumulator (SUM, MIN or MAX of one value column over the
// rows that are kept and not NULL) and every non-null count (one for each
// distinct validity, the first for the kept rows themselves).
//
// The rows go a tile at a time, and a tile a column at a time (see the row
// pass below), so that a column's dtype and an aggregate's kind are
// dispatched once a tile and not once a row. Where the tables of every
// thread fit in shared memory (a small domain and few aggregates: every
// dense GROUP BY of TPC-H), each thread owns its own [accumulators x
// domain] and [counts x domain] slots and adds its rows into them in row
// order: no exchange between threads, no atomic, however hot a group.
// Otherwise (a large domain, whose groups are rarely hot) each warp owns
// its slots: counts and integer aggregates go in by shared-memory atomics,
// whose results do not depend on order; a float aggregate's lanes of one
// group find each other by __match_any_sync and are combined by a shuffle
// tree in rank order, whose lowest lane adds the result into the warp's
// slot. After the rows, the
// block folds each slot's owners (threads or warps) in order into its
// partial; a second launch, one block a group, folds the blocks' partials
// in a fixed order. Every float sum is therefore taken in the same order in
// every run: the same bits. Integer sums wrap as int64 does in torch.
//
// What bounds it: the bytes of the key columns, the mask and the distinct
// value columns (a second accumulator over the same column, or a second
// read of one validity, hits L1 within the tile). Dispatch and exchange
// are what cost beyond those bytes: at Q1's shape on an H100, dispatching
// every column at every row with a warp's shuffle tree at every row took
// 5.9 ms, the same dispatch with a table a thread 2.0, a tile a column at
// a time 1.2 (bound 0.88); over domain 128 a tree for every kind took
// twice the time of shared atomics, so the warp path keeps the tree for
// float aggregates alone.
// ---------------------------------------------------------------------
constexpr int kMaxKeys = 8;
constexpr int kMaxAccs = 8;
constexpr int kMaxCounts = kMaxAccs + 1;
constexpr int kDenseRows = 8;                   // rows a thread a tile
constexpr int kDenseTile = kThreads * kDenseRows;

enum KeyType { kKeyU8 = 0, kKeyI8 = 1, kKeyI16 = 2, kKeyI32 = 3, kKeyI64 = 4 };
// An accumulator: SUM of integers in int64, SUM of floats in float64, MIN
// and MAX in int64 or float64 (exact for every input type); its bits are
// held in a long long.
enum AccKind { kSumI = 0, kSumF = 1, kMinI = 2, kMaxI = 3, kMinF = 4,
               kMaxF = 5 };

struct DenseKey {
  const void* col;
  long long offset;
  long long stride;
  int type;
};

struct DenseAcc {
  const void* vals;
  const uint8_t* valid;       // null: no NULLs
  void* out;                  // [domain] of out_type
  long long init;             // the identity's bits: an empty group's result
  int kind;
  int type;                   // the values' DType
  int out_type;               // the result's DType
};

struct DenseArgs {
  DenseKey keys[kMaxKeys];
  DenseAcc accs[kMaxAccs];
  const uint8_t* valids[kMaxCounts];   // null: the kept rows themselves
  int* counts[kMaxCounts];             // [domain] int32 each
  bool* occupied;                      // [domain], from count 0; may be null
  const uint8_t* alive;
  long long* part_acc;                 // [blocks][n_accs][domain]
  int* part_cnt;                       // [blocks][n_counts][domain]
  int64_t n;
  int domain;
  int n_keys;
  int n_accs;
  int n_counts;
};

// ---- the row pass: a tile of kDenseTile rows at a time, kDenseRows a
// thread (rows base + k * kThreads + threadIdx.x, so each warp reads 32
// consecutive rows at once). The tile is taken a column at a time: the
// column's dtype and the aggregate's kind are dispatched once a tile, and
// a thread's loads of one column are all in flight together.

// The thread's rows of the tile: their positions (row 0 past n) and groups.
struct TileRows {
  int64_t at[kDenseRows];
  int g[kDenseRows];          // -1: not kept
};

template <typename T>
__device__ __forceinline__ void add_key(const DenseKey& key, TileRows& t,
                                        unsigned long long (&idx)[kDenseRows]) {
  const T* p = reinterpret_cast<const T*>(key.col);
  T v[kDenseRows];
#pragma unroll
  for (int k = 0; k < kDenseRows; ++k) v[k] = __ldg(p + t.at[k]);
#pragma unroll
  for (int k = 0; k < kDenseRows; ++k)
    idx[k] += ((unsigned long long)(long long)v[k] -
               (unsigned long long)key.offset) *
              (unsigned long long)key.stride;
}

__device__ __forceinline__ void tile_groups(const DenseArgs& a, int64_t base,
                                            TileRows& t) {
  unsigned long long idx[kDenseRows];
  bool live[kDenseRows];
#pragma unroll
  for (int k = 0; k < kDenseRows; ++k) {
    const int64_t i = base + (int64_t)k * kThreads + threadIdx.x;
    live[k] = i < a.n;
    t.at[k] = live[k] ? i : 0;
    idx[k] = 0;
  }
#pragma unroll
  for (int k = 0; k < kDenseRows; ++k)
    live[k] = live[k] && __ldg(a.alive + t.at[k]);
  for (int c = 0; c < a.n_keys; ++c) {
    const DenseKey& key = a.keys[c];
    switch (key.type) {
      case kKeyU8: add_key<unsigned char>(key, t, idx); break;
      case kKeyI8: add_key<signed char>(key, t, idx); break;
      case kKeyI16: add_key<short>(key, t, idx); break;
      case kKeyI32: add_key<int>(key, t, idx); break;
      default: add_key<long long>(key, t, idx); break;
    }
  }
#pragma unroll
  for (int k = 0; k < kDenseRows; ++k) {
    const long long s = (long long)idx[k];
    t.g[k] = live[k] && s >= 0 && s < a.domain ? (int)s : -1;
  }
}

// The warp path's groups of each row step: peers, rank and the next peer
// up, and the largest group of the step.
struct TilePeers {
  unsigned peers[kDenseRows];
  int partner[kDenseRows];
  unsigned most[kDenseRows];
};

__device__ __forceinline__ void tile_peers(const TileRows& t, int lane,
                                           TilePeers& p) {
#pragma unroll
  for (int k = 0; k < kDenseRows; ++k) {
    p.peers[k] = __match_any_sync(kFull, t.g[k]);
    const unsigned above = p.peers[k] & ~((2u << lane) - 1u);  // 0: lane 31
    p.partner[k] = above ? __ffs(above) - 1 : -1;
    p.most[k] = __reduce_max_sync(kFull, (unsigned)__popc(p.peers[k]));
  }
}

// The thread's rows' flags of one validity (null: every row valid).
__device__ __forceinline__ void load_valid(const uint8_t* v, const TileRows& t,
                                           bool (&ok)[kDenseRows]) {
#pragma unroll
  for (int k = 0; k < kDenseRows; ++k)
    ok[k] = t.g[k] >= 0 && (v == nullptr || __ldg(v + t.at[k]));
}

// Counts: the lane path adds into the thread's own slot; the warp path by
// a shared-memory atomic (a count does not depend on order).
template <bool kLane>
__device__ __forceinline__ void tile_counts(const DenseArgs& a,
                                            const TileRows& t, int* ctab) {
  const int D = a.domain;
  constexpr int kOwners = kLane ? kThreads : kWarps;
  for (int c = 0; c < a.n_counts; ++c) {
    bool ok[kDenseRows];
    load_valid(a.valids[c], t, ok);
    int* slot = ctab + c * D * kOwners;
#pragma unroll
    for (int k = 0; k < kDenseRows; ++k) {
      if (ok[k]) {
        if constexpr (kLane) slot[t.g[k] * kOwners] += 1;
        else atomicAdd(slot + t.g[k] * kOwners, 1);
      }
    }
  }
}

// Each accumulator kind's combination and conversion, known at compile time
// (a first: the earlier rows); MIN/MAX let a NaN win, as combine<> does.
template <int KIND> struct AccOp;
template <> struct AccOp<kSumI> {
  using A = long long;
  __device__ static A op(A a, A b) {
    return (long long)((unsigned long long)a + (unsigned long long)b);
  }
};
template <> struct AccOp<kSumF> {
  using A = double;
  __device__ static A op(A a, A b) { return a + b; }
};
template <> struct AccOp<kMinI> {
  using A = long long;
  __device__ static A op(A a, A b) { return b < a ? b : a; }
};
template <> struct AccOp<kMaxI> {
  using A = long long;
  __device__ static A op(A a, A b) { return b > a ? b : a; }
};
template <> struct AccOp<kMinF> {
  using A = double;
  __device__ static A op(A a, A b) { return (b < a || b != b) ? b : a; }
};
template <> struct AccOp<kMaxF> {
  using A = double;
  __device__ static A op(A a, A b) { return (b > a || b != b) ? b : a; }
};

__host__ __device__ constexpr bool float_kind(int kind) {
  return kind == kSumF || kind == kMinF || kind == kMaxF;
}

// The warp path's integer accumulators (sums, MIN and MAX, whose results
// do not depend on order) go in by shared-memory atomics.
template <int KIND>
__device__ __forceinline__ void atomic_acc(long long* s, long long x) {
  if constexpr (KIND == kSumI)
    atomicAdd(reinterpret_cast<unsigned long long*>(s), (unsigned long long)x);
  else if constexpr (KIND == kMinI)
    atomicMin(s, x);
  else
    atomicMax(s, x);
}

// One accumulator over the thread's rows of the tile: the lane path adds
// each row into the thread's own slot, in row order. The warp path folds a
// float aggregate over each row step's groups by the rank-order shuffle
// tree (at level s a lane whose rank is a multiple of 2s takes the partial
// of the peer s ranks above, found by pointer jumping from the next peer
// up), and the group's lowest lane adds the result into the warp's slot:
// the same order in every run (a float MIN or MAX by compare-and-swap ran
// 2.5 times slower over domain 128). Its integer kinds go in by
// atomic_acc.
template <bool kLane, int KIND, typename T>
__device__ __forceinline__ void tile_acc(const DenseAcc& acc,
                                         const TileRows& t,
                                         const TilePeers& p, int lane,
                                         long long* tbl_j) {
  using Op = AccOp<KIND>;
  using A = typename Op::A;
  constexpr int kOwners = kLane ? kThreads : kWarps;
  A* slot = reinterpret_cast<A*>(tbl_j);
  const T* vals = reinterpret_cast<const T*>(acc.vals);
  T v[kDenseRows];
#pragma unroll
  for (int k = 0; k < kDenseRows; ++k) v[k] = __ldg(vals + t.at[k]);
  bool ok[kDenseRows];
  load_valid(acc.valid, t, ok);
  A init;
  if constexpr (std::is_same<A, double>::value)
    init = __longlong_as_double(acc.init);
  else
    init = acc.init;
#pragma unroll
  for (int k = 0; k < kDenseRows; ++k) {
    if constexpr (kLane) {
      if (ok[k]) {
        A* s = slot + t.g[k] * kOwners;
        *s = Op::op(*s, (A)v[k]);
      }
    } else if constexpr (!float_kind(KIND)) {
      if (ok[k]) atomic_acc<KIND>(slot + t.g[k] * kOwners, (A)v[k]);
    } else {
      A x = ok[k] ? (A)v[k] : init;
      const int rank = __popc(p.peers[k] & ((1u << lane) - 1u));
      int partner = p.partner[k];
      for (unsigned s = 1; s < p.most[k]; s <<= 1) {
        const int src = partner >= 0 ? partner : lane;
        const A y = __shfl_sync(kFull, x, src);
        if (partner >= 0 && (rank & (2 * s - 1)) == 0) x = Op::op(x, y);
        const int next = __shfl_sync(kFull, partner, src);
        partner = partner >= 0 ? next : -1;
      }
      if (rank == 0 && t.g[k] >= 0) {
        A* s = slot + t.g[k] * kOwners;
        *s = Op::op(*s, x);
      }
      __syncwarp();           // the slot's next reader may be another lane
    }
  }
}

template <bool kLane>
__device__ __forceinline__ void tile_accs(const DenseArgs& a,
                                          const TileRows& t,
                                          const TilePeers& p, int lane,
                                          long long* tbl) {
  constexpr int kOwners = kLane ? kThreads : kWarps;
  for (int j = 0; j < a.n_accs; ++j) {
    const DenseAcc& acc = a.accs[j];
    long long* tj = tbl + j * a.domain * kOwners;
    switch (acc.kind * 4 + acc.type) {
      case kSumI * 4 + kI32: tile_acc<kLane, kSumI, int>(acc, t, p, lane, tj); break;
      case kSumI * 4 + kI64: tile_acc<kLane, kSumI, long long>(acc, t, p, lane, tj); break;
      case kSumF * 4 + kF32: tile_acc<kLane, kSumF, float>(acc, t, p, lane, tj); break;
      case kSumF * 4 + kF64: tile_acc<kLane, kSumF, double>(acc, t, p, lane, tj); break;
      case kMinI * 4 + kI32: tile_acc<kLane, kMinI, int>(acc, t, p, lane, tj); break;
      case kMinI * 4 + kI64: tile_acc<kLane, kMinI, long long>(acc, t, p, lane, tj); break;
      case kMaxI * 4 + kI32: tile_acc<kLane, kMaxI, int>(acc, t, p, lane, tj); break;
      case kMaxI * 4 + kI64: tile_acc<kLane, kMaxI, long long>(acc, t, p, lane, tj); break;
      case kMinF * 4 + kF32: tile_acc<kLane, kMinF, float>(acc, t, p, lane, tj); break;
      case kMinF * 4 + kF64: tile_acc<kLane, kMinF, double>(acc, t, p, lane, tj); break;
      case kMaxF * 4 + kF32: tile_acc<kLane, kMaxF, float>(acc, t, p, lane, tj); break;
      default: tile_acc<kLane, kMaxF, double>(acc, t, p, lane, tj); break;
    }
  }
}

// a combined with b, a first, for a kind known only at run time (the folds
// of the partials)
__device__ __forceinline__ long long acc_combine(int kind, long long a,
                                                 long long b) {
  switch (kind) {
    case kSumI: return AccOp<kSumI>::op(a, b);
    case kMinI: return AccOp<kMinI>::op(a, b);
    case kMaxI: return AccOp<kMaxI>::op(a, b);
    case kSumF:
      return __double_as_longlong(AccOp<kSumF>::op(__longlong_as_double(a),
                                                   __longlong_as_double(b)));
    case kMinF:
      return __double_as_longlong(AccOp<kMinF>::op(__longlong_as_double(a),
                                                   __longlong_as_double(b)));
    default:
      return __double_as_longlong(AccOp<kMaxF>::op(__longlong_as_double(a),
                                                   __longlong_as_double(b)));
  }
}

// The row pass. Tables hold one slot an (accumulator or count, group) for
// each owner, the owners of a slot side by side: the threads (kLane: each
// thread adds its own rows into its own slots, rows in order, with no
// exchange at all; taken where those tables fit, which dense GROUP BYs of
// small domains do) or the warps (the shuffle tree). The block's partial
// then folds each slot's owners in order.
template <bool kLane>
__global__ void __launch_bounds__(kThreads, kLane ? 3 : 4)
dense_agg_kernel(const __grid_constant__ DenseArgs a) {
  extern __shared__ __align__(16) unsigned char dense_smem[];
  constexpr int kOwners = kLane ? kThreads : kWarps;
  const int A = a.n_accs, C = a.n_counts, D = a.domain;
  long long* tbl_all = reinterpret_cast<long long*>(dense_smem);
  int* ctab_all = reinterpret_cast<int*>(tbl_all + kOwners * A * D);
  for (int j = threadIdx.x; j < kOwners * A * D; j += kThreads)
    tbl_all[j] = a.accs[j / (kOwners * D)].init;
  for (int j = threadIdx.x; j < kOwners * C * D; j += kThreads)
    ctab_all[j] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int owner = kLane ? threadIdx.x : threadIdx.x >> 5;
  bool tree = false;                 // the warp path has a float aggregate
  for (int j = 0; j < A && !kLane; ++j)
    tree = tree || float_kind(a.accs[j].kind);
  for (int64_t base = (int64_t)blockIdx.x * kDenseTile; base < a.n;
       base += (int64_t)gridDim.x * kDenseTile) {
    TileRows t;
    tile_groups(a, base, t);
    TilePeers p;
    if (tree) tile_peers(t, lane, p);
    tile_counts<kLane>(a, t, ctab_all + owner);
    tile_accs<kLane>(a, t, p, lane, tbl_all + owner);
  }
  __syncthreads();
  // the block's partial: each slot's owners folded in order
  for (int j = threadIdx.x; j < A * D; j += kThreads) {
    const int kind = a.accs[j / D].kind;
    const long long* t = tbl_all + j * kOwners;
    long long v = t[0];
    for (int o = 1; o < kOwners; ++o) v = acc_combine(kind, v, t[o]);
    a.part_acc[(int64_t)blockIdx.x * A * D + j] = v;
  }
  for (int j = threadIdx.x; j < C * D; j += kThreads) {
    const int* t = ctab_all + j * kOwners;
    int v = 0;
    for (int o = 0; o < kOwners; ++o) v += t[o];
    a.part_cnt[(int64_t)blockIdx.x * C * D + j] = v;
  }
}

// v folded over the block's threads in thread order (a shuffle tree in
// each warp, then the warps in order); the result is valid in thread 0.
__device__ __forceinline__ long long block_fold(int kind, long long v) {
  __shared__ long long s_w[kWarps];
  for (int off = 1; off < 32; off <<= 1) {
    const long long x = __shfl_down_sync(kFull, v, off);
    if (((threadIdx.x & 31) & (2 * off - 1)) == 0)
      v = acc_combine(kind, v, x);
  }
  if ((threadIdx.x & 31) == 0) s_w[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) v = acc_combine(kind, v, s_w[w]);
  }
  __syncthreads();                               // s_w is reused
  return v;
}

__device__ __forceinline__ void store_out(void* out, int type, int g,
                                          long long v, int kind) {
  const bool flt = kind == kSumF || kind == kMinF || kind == kMaxF;
  switch (type) {
    case kI32: ((int*)out)[g] = (int)v; break;
    case kI64: ((long long*)out)[g] = v; break;
    case kF32:
      ((float*)out)[g] = (float)(flt ? __longlong_as_double(v) : (double)v);
      break;
    default: ((double*)out)[g] = flt ? __longlong_as_double(v) : (double)v;
  }
}

// Second launch, one block a group: the blocks' partials folded, each
// thread over the blocks t, t + kThreads, ... in order, then block_fold.
__global__ void __launch_bounds__(kThreads)
dense_final_kernel(const __grid_constant__ DenseArgs a, int blocks) {
  const int g = blockIdx.x;
  const int A = a.n_accs, C = a.n_counts, D = a.domain;
  for (int j = 0; j < A; ++j) {
    const int kind = a.accs[j].kind;
    long long v = a.accs[j].init;
    for (int b = threadIdx.x; b < blocks; b += kThreads)
      v = acc_combine(kind, v, a.part_acc[((int64_t)b * A + j) * D + g]);
    v = block_fold(kind, v);
    if (threadIdx.x == 0) store_out(a.accs[j].out, a.accs[j].out_type, g, v,
                                    kind);
  }
  for (int c = 0; c < C; ++c) {
    long long v = 0;
    for (int b = threadIdx.x; b < blocks; b += kThreads)
      v += a.part_cnt[((int64_t)b * C + c) * D + g];
    v = block_fold(kSumI, v);
    if (threadIdx.x == 0) {
      a.counts[c][g] = (int)v;
      if (c == 0 && a.occupied != nullptr) a.occupied[g] = v > 0;
    }
  }
}

// ---------------------------------------------------------------------
// K5: segmented reduce over key-sorted rows (sort GROUP BY). Row i of the
// sorted order holds input row perm[i]; live rows form a prefix (s_alive)
// and change[i] marks the first row of each group. Each group's result and
// live non-null count go to its LAST row; every other row gets 0. A dead
// row ends the group before it, as the end of the live prefix does.
//
// What bounds it: the streams (change, s_alive, perm in; the result and
// the count out) and one random read of the value (and of its validity) a
// live row, through perm. One thread walking a whole group would turn a
// large group into serial latency (Q9's 175 groups over 3 M live rows), so
// the rows are cut by position, not by group: a block takes a tile of
// kSegTile sorted rows, kSegItems consecutive rows a thread, loads their
// flags and perm by vector loads, issues all of its rows' gathers before it
// uses any, and reduces the tile with head flags in a fixed order:
// serially within a thread, then the block's shuffle scan
// (seg_device.cuh). Every group that starts and ends inside the tile gets
// its result there. A tile past the live prefix writes its zeros and
// leaves at once. Eight rows a thread (107 registers at sixteen, two
// blocks an SM) measured best over the three shapes of PERF.md §6. Each tile also writes a carry: the value and count of
// the group open at its end, whether a group starts inside it, and, where
// the group open at its start ends inside it, that row and the tile's part
// of the group. A second launch, one block, scans the tiles' carries in
// tile order and completes the result at those rows. No decoupled
// look-back: the order of combination never depends on timing, so float
// sums repeat bit for bit.
// ---------------------------------------------------------------------
constexpr int kSegItems = 8;                                  // rows a thread
constexpr int64_t kSegTile = (int64_t)kThreads * kSegItems;   // rows a block
constexpr int kCarryThreads = 1024;

// The carries of the tiles, carved out of the wrapper's scratch of five
// int64 words a tile (ops/cuda.py segment_scratch_words).
template <typename A>
struct TileCarry {
  A* v;              // the value since the tile's last group start
  long long* c;      // the live non-null rows since then
  A* fix_v;          // the tile's part of the group open at its start
  long long* fix_c;
  int* f;            // a group (or a dead row) starts inside the tile
  int* fix_at;       // that group's last row, from the tile's start; -1
};

template <typename A>
__host__ TileCarry<A> carve_carry(void* scratch, int64_t ntiles) {
  long long* w = (long long*)scratch;
  TileCarry<A> t;
  t.v = (A*)w;
  t.c = w + ntiles;
  t.fix_v = (A*)(w + 2 * ntiles);
  t.fix_c = w + 3 * ntiles;
  t.f = (int*)(w + 4 * ntiles);
  t.fix_at = t.f + ntiles;
  return t;
}

// The kSegItems bytes of a 0/1 flag array at row r: one 8-byte load where
// the tile is whole, else the rows below n and `pad` past them.
__device__ __forceinline__ void load_flags(const uint8_t* __restrict__ a,
                                           int64_t r, int64_t n, bool whole,
                                           uint8_t pad,
                                           uint8_t (&out)[kSegItems]) {
  static_assert(kSegItems == 8, "one uint2 of flags a thread");
  if (whole) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(a + r));
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      out[j] = ((j < 4 ? v.x : v.y) >> (8 * (j & 3))) & 0xff;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) out[j] = r + j < n ? a[r + j] : pad;
  }
}

template <typename O>
__device__ __forceinline__ long long bits64(O x) {
  if constexpr (std::is_same<O, double>::value) return __double_as_longlong(x);
  else return (long long)x;
}

template <typename O>
__device__ __forceinline__ int bits32(O x) {
  if constexpr (std::is_same<O, float>::value) return __float_as_int(x);
  else return (int)x;
}

// kSegItems values of 4 or 8 bytes from row r: 16-byte streaming stores
// where the tile is whole, else the rows below n.
template <typename O>
__device__ __forceinline__ void store_items(O* __restrict__ p, int64_t r,
                                            int64_t n, bool whole,
                                            const O (&x)[kSegItems]) {
  if (!whole) {
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      if (r + j < n) p[r + j] = x[j];
    }
  } else if constexpr (sizeof(O) == 8) {
#pragma unroll
    for (int q = 0; q < kSegItems / 2; ++q) {
      longlong2 w;
      w.x = bits64(x[2 * q]);
      w.y = bits64(x[2 * q + 1]);
      __stcs(reinterpret_cast<longlong2*>(p + r) + q, w);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSegItems / 4; ++q) {
      __stcs(reinterpret_cast<int4*>(p + r) + q,
             make_int4(bits32(x[4 * q]), bits32(x[4 * q + 1]),
                       bits32(x[4 * q + 2]), bits32(x[4 * q + 3])));
    }
  }
}

// First launch: one block a tile of kSegTile rows.
template <int FN, typename T, typename A, typename O>
__global__ void __launch_bounds__(kThreads)
segment_tile_kernel(const uint8_t* __restrict__ change,
                    const uint8_t* __restrict__ s_alive,
                    const long long* __restrict__ perm, int64_t n,
                    const T* __restrict__ vals,
                    const uint8_t* __restrict__ valid,
                    O* __restrict__ out_val, int* __restrict__ out_nn,
                    TileCarry<A> carry) {
  __shared__ int s_fix;
  const SegOp<FN, A> op;
  const Seg<A> id = {0, identity<FN, A>(), 0};
  const int64_t tile0 = (int64_t)blockIdx.x * kSegTile;
  const int64_t r0 = tile0 + (int64_t)threadIdx.x * kSegItems;
  const bool whole = r0 + kSegItems <= n;
  if (threadIdx.x == 0) s_fix = -1;

  uint8_t live[kSegItems], head[kSegItems];
  load_flags(s_alive, r0, n, whole, 0, live);
  load_flags(change, r0, n, whole, 1, head);
  bool any = false;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    head[j] = head[j] || !live[j];
    any = any || live[j];
  }
  // a tile with no live row (past the live prefix): zeros, and a carry
  // that starts a group
  if (!__syncthreads_or(any)) {
    O res[kSegItems];
    int cnt[kSegItems];
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      res[j] = O(0);
      cnt[j] = 0;
    }
    if constexpr (FN != kCount) store_items(out_val, r0, n, whole, res);
    store_items(out_nn, r0, n, whole, cnt);
    if (threadIdx.x == 0) {
      carry.f[blockIdx.x] = 1;
      carry.v[blockIdx.x] = identity<FN, A>();
      carry.c[blockIdx.x] = 0;
      carry.fix_at[blockIdx.x] = -1;
    }
    return;
  }
  // every gather of the thread's rows is issued before any is used; a NULL
  // row takes the identity
  A x[kSegItems];
  bool ok[kSegItems];
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    x[j] = identity<FN, A>();
    ok[j] = false;
  }
  if (any) {
    long long p[kSegItems];
    if (whole) {
#pragma unroll
      for (int q = 0; q < kSegItems / 2; ++q) {
        const longlong2 v =
            __ldcs(reinterpret_cast<const longlong2*>(perm + r0) + q);
        p[2 * q] = v.x;
        p[2 * q + 1] = v.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kSegItems; ++j) p[j] = live[j] ? perm[r0 + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      ok[j] = live[j] && (valid == nullptr || __ldg(valid + p[j]));
      if constexpr (FN != kCount) {
        x[j] = live[j] ? (A)__ldg(vals + p[j]) : identity<FN, A>();
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    if (!ok[j]) x[j] = identity<FN, A>();
  }
  Seg<A> s = id;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    s = op(s, Seg<A>{head[j], x[j], ok[j] ? 1 : 0});
  }
  Seg<A> total;
  Seg<A> cur = block_exclusive_scan<kThreads>(s, id, op, total);

  // whether the row after the thread's last starts a group (or is past n)
  int after = __shfl_down_sync(kFull, (int)head[0], 1);
  if ((threadIdx.x & 31) == 31) {
    const int64_t r = r0 + kSegItems;
    after = r >= n || change[r] || !s_alive[r];
  }
  O res[kSegItems];
  int cnt[kSegItems];
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    cur = op(cur, Seg<A>{head[j], x[j], ok[j] ? 1 : 0});
    const bool last = live[j] && (j + 1 < kSegItems ? head[j + 1] : after);
    res[j] = last ? (O)cur.v : O(0);
    cnt[j] = last ? (int)cur.c : 0;
    if (last && !cur.f) {
      // the group open at the tile's start ends here: the carry completes it
      s_fix = (int)(r0 + j - tile0);
      carry.fix_v[blockIdx.x] = cur.v;
      carry.fix_c[blockIdx.x] = cur.c;
    }
  }
  if constexpr (FN != kCount) store_items(out_val, r0, n, whole, res);
  store_items(out_nn, r0, n, whole, cnt);
  __syncthreads();
  if (threadIdx.x == 0) {
    carry.f[blockIdx.x] = total.f;
    carry.v[blockIdx.x] = total.v;
    carry.c[blockIdx.x] = total.c;
    carry.fix_at[blockIdx.x] = s_fix;
  }
}

// Second launch, one block: the carry into each tile (the value and count
// of the group open at its start, from the tiles before it), scanned in
// tile order, completes the result at the tile's fix row.
template <int FN, typename A, typename O>
__global__ void __launch_bounds__(kCarryThreads)
segment_carry_kernel(TileCarry<A> carry, int64_t ntiles,
                     O* __restrict__ out_val, int* __restrict__ out_nn) {
  const SegOp<FN, A> op;
  const Seg<A> id = {0, identity<FN, A>(), 0};
  const int64_t per = (ntiles + kCarryThreads - 1) / kCarryThreads;
  const int64_t t0 = (int64_t)threadIdx.x * per;
  const int64_t t1 = t0 + per < ntiles ? t0 + per : ntiles;
  Seg<A> s = id;
  for (int64_t t = t0; t < t1; ++t) {
    s = op(s, Seg<A>{carry.f[t], carry.v[t], carry.c[t]});
  }
  Seg<A> total;
  Seg<A> cur = block_exclusive_scan<kCarryThreads>(s, id, op, total);
  for (int64_t t = t0; t < t1; ++t) {
    const int at = carry.fix_at[t];
    if (at >= 0) {
      const int64_t e = t * kSegTile + at;
      if constexpr (FN != kCount) {
        out_val[e] = (O)combine<FN, A>(cur.v, carry.fix_v[t]);
      }
      out_nn[e] = (int)(cur.c + carry.fix_c[t]);
    }
    cur = op(cur, Seg<A>{carry.f[t], carry.v[t], carry.c[t]});
  }
}

template <int FN, typename T, typename A, typename O>
cudaError_t launch_segment_reduce(const void* change, const void* s_alive,
                                  const void* perm, int64_t n,
                                  const void* vals, const void* valid,
                                  void* out_val, void* out_nn, void* scratch,
                                  cudaStream_t stream) {
  const int64_t ntiles = (n + kSegTile - 1) / kSegTile;
  const TileCarry<A> carry = carve_carry<A>(scratch, ntiles);
  segment_tile_kernel<FN, T, A, O><<<(unsigned)ntiles, kThreads, 0, stream>>>(
      (const uint8_t*)change, (const uint8_t*)s_alive, (const long long*)perm,
      n, (const T*)vals, (const uint8_t*)valid, (O*)out_val, (int*)out_nn,
      carry);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  segment_carry_kernel<FN, A, O><<<1, kCarryThreads, 0, stream>>>(
      carry, ntiles, (O*)out_val, (int*)out_nn);
  return cudaGetLastError();
}

// Accumulator and output types per (fn, dtype), the same for both kernels:
//   SUM   i32, i64 -> acc int64, out int64; f32 -> acc f64, out f32;
//         f64 -> acc f64, out f64
//   MIN/MAX      -> acc and out of the input's type
//   COUNT        -> only the counts (the value pointer may be null)
#define QS_DISPATCH(LAUNCH, ...)                                              \
  switch (fn) {                                                               \
    case kSum:                                                                \
      switch (dtype) {                                                        \
        case kI32: return LAUNCH<kSum, int, long long, long long>(__VA_ARGS__); \
        case kI64: return LAUNCH<kSum, long long, long long, long long>(__VA_ARGS__); \
        case kF32: return LAUNCH<kSum, float, double, float>(__VA_ARGS__);    \
        case kF64: return LAUNCH<kSum, double, double, double>(__VA_ARGS__);  \
      }                                                                       \
      break;                                                                  \
    case kMin:                                                                \
      switch (dtype) {                                                        \
        case kI32: return LAUNCH<kMin, int, int, int>(__VA_ARGS__);           \
        case kI64: return LAUNCH<kMin, long long, long long, long long>(__VA_ARGS__); \
        case kF32: return LAUNCH<kMin, float, float, float>(__VA_ARGS__);     \
        case kF64: return LAUNCH<kMin, double, double, double>(__VA_ARGS__);  \
      }                                                                       \
      break;                                                                  \
    case kMax:                                                                \
      switch (dtype) {                                                        \
        case kI32: return LAUNCH<kMax, int, int, int>(__VA_ARGS__);           \
        case kI64: return LAUNCH<kMax, long long, long long, long long>(__VA_ARGS__); \
        case kF32: return LAUNCH<kMax, float, float, float>(__VA_ARGS__);     \
        case kF64: return LAUNCH<kMax, double, double, double>(__VA_ARGS__);  \
      }                                                                       \
      break;                                                                  \
    case kCount:                                                              \
      return LAUNCH<kCount, uint8_t, long long, long long>(__VA_ARGS__);      \
  }                                                                           \
  return cudaErrorInvalidValue;

}  // namespace

extern "C" {

int qs_masked_reduce(int fn, int dtype, const void* vals, const void* valid,
                     const void* alive, int64_t n, void* part_val,
                     void* part_cnt, int blocks, void* out_val, void* out_cnt,
                     void* stream) {
  QS_DISPATCH(launch_masked_reduce, vals, valid, alive, n, part_val, part_cnt,
              blocks, out_val, out_cnt, (cudaStream_t)stream)
}

// The dense GROUP BY of DenseArgs; lane: the lane path; shared memory of
// owners * domain * (8 * n_accs + 4 * n_counts) bytes a block, the owners
// kThreads on the lane path, else kWarps (ops/cuda.py dense_smem_bytes);
// part_acc and part_cnt of `blocks` partials each.
int qs_dense_aggregate(const void* args, int blocks, int smem, int lane,
                       void* stream) {
  const DenseArgs& a = *(const DenseArgs*)args;
  if (a.domain < 1 || a.domain > kMaxDomain || a.n_keys < 1 ||
      a.n_keys > kMaxKeys || a.n_accs < 0 || a.n_accs > kMaxAccs ||
      a.n_counts < 1 || a.n_counts > kMaxCounts)
    return cudaErrorInvalidValue;
  if (a.n == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (lane) {
    err = cudaFuncSetAttribute(dense_agg_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    dense_agg_kernel<true><<<blocks, kThreads, smem, st>>>(a);
  } else {
    err = cudaFuncSetAttribute(dense_agg_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    dense_agg_kernel<false><<<blocks, kThreads, smem, st>>>(a);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dense_final_kernel<<<a.domain, kThreads, 0, st>>>(a, blocks);
  return cudaGetLastError();
}

// The row pass's blocks that fit on one SM at once with smem bytes of
// shared memory (its grid is sized to them: a second wave would run alone);
// 0 where none fits, or an error.
int qs_dense_blocks_per_sm(int lane, int smem) {
  const void* fn = lane ? (const void*)dense_agg_kernel<true>
                        : (const void*)dense_agg_kernel<false>;
  if (cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                    smem) != cudaSuccess)
    return 0;
  return blocks;
}

// sizeof(DenseArgs): the wrapper checks its own packing against it.
int64_t qs_dense_args_bytes() { return (int64_t)sizeof(DenseArgs); }

// change, s_alive and perm 16-byte aligned; scratch of 5 int64 words a tile
// of kSegTile rows (ops/cuda.py segment_scratch_words).
int qs_segment_reduce(int fn, int dtype, const void* change,
                      const void* s_alive, const void* perm, int64_t n,
                      const void* vals, const void* valid, void* out_val,
                      void* out_nn, void* scratch, void* stream) {
  if (n == 0) return cudaSuccess;
  QS_DISPATCH(launch_segment_reduce, change, s_alive, perm, n, vals, valid,
              out_val, out_nn, scratch, (cudaStream_t)stream)
}

const char* qs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
