// Aggregation kernels for Hopper (sm_90a): the masked scalar reduce, the
// dense (collision-free) group-by and the segmented reduce of the sort
// group-by. Plain C interface, loaded with ctypes by
// quickstep_tpu_torch/ops/cuda.py; every function launches on the stream it is
// given, allocates nothing, and returns the cudaError_t of its launches.
//
// qs_masked_reduce replaces quickstep_tpu/ops/groupby.py:435 scalar_agg (and
// the retired Pallas scan kernel, ops/pallas_scan.py:57 _pallas_scan_agg).
// qs_dense_group_reduce replaces quickstep_tpu/ops/groupby.py:56
// dense_groupby (_dense_groupby_broadcast :72 / _dense_groupby_scatter :110,
// and the retired Pallas kernel ops/pallas_groupby.py:95 _run).
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
// [domain] table per block (group-by) to device memory before a second tiny
// launch folds the partials in a fixed order.
//
// Results: integer sums, counts, minima and maxima are exact. The scalar
// reduce and the segmented reduce are deterministic (fixed tiles, fixed
// shuffle trees, carries combined in a fixed order). The group-by's
// floating-point sums go through shared-memory atomics, whose order varies
// from run to run, so they may differ in the last bits between runs.

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
// K2: dense group-by. Each warp owns a [domain] accumulator table in shared
// memory, so shared-memory atomics collide only within a warp; the block
// folds its warps' tables into one [domain] partial, and pass 2 folds the
// per-block partials per group.
// ---------------------------------------------------------------------
__device__ __forceinline__ void atomic_add(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void atomic_add(double* p, double v) { atomicAdd(p, v); }

__device__ __forceinline__ void atomic_min(int* p, int v) { atomicMin(p, v); }
__device__ __forceinline__ void atomic_max(int* p, int v) { atomicMax(p, v); }
__device__ __forceinline__ void atomic_min(long long* p, long long v) { atomicMin(p, v); }
__device__ __forceinline__ void atomic_max(long long* p, long long v) { atomicMax(p, v); }

// Whether v takes the place of the stored cur: a NaN wins and stays.
template <bool MIN, typename A>
__device__ __forceinline__ bool replaces(A v, A cur) {
  if (is_nan(v)) return !is_nan(cur);
  return MIN ? v < cur : v > cur;
}

template <bool MIN>
__device__ __forceinline__ void atomic_minmax_f(float* p, float v) {
  unsigned int* a = reinterpret_cast<unsigned int*>(p);
  unsigned int old = *a;
  while (replaces<MIN>(v, __uint_as_float(old))) {
    const unsigned int assumed = old;
    old = atomicCAS(a, assumed, __float_as_uint(v));
    if (old == assumed) break;
  }
}
template <bool MIN>
__device__ __forceinline__ void atomic_minmax_f(double* p, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *a;
  while (replaces<MIN>(v, __longlong_as_double(old))) {
    const unsigned long long assumed = old;
    old = atomicCAS(a, assumed, (unsigned long long)__double_as_longlong(v));
    if (old == assumed) break;
  }
}
__device__ __forceinline__ void atomic_min(float* p, float v) { atomic_minmax_f<true>(p, v); }
__device__ __forceinline__ void atomic_max(float* p, float v) { atomic_minmax_f<false>(p, v); }
__device__ __forceinline__ void atomic_min(double* p, double v) { atomic_minmax_f<true>(p, v); }
__device__ __forceinline__ void atomic_max(double* p, double v) { atomic_minmax_f<false>(p, v); }

template <int FN, typename T, typename A>
__global__ void __launch_bounds__(kThreads)
dense_group_partial(const int64_t* __restrict__ idx,
                    const T* __restrict__ vals,
                    const uint8_t* __restrict__ valid,
                    const uint8_t* __restrict__ alive, int64_t n, int domain,
                    A* __restrict__ part_val, int* __restrict__ part_nn,
                    int* __restrict__ part_occ) {
  __shared__ A s_acc[kWarps][kMaxDomain];
  __shared__ int s_nn[kWarps][kMaxDomain];
  __shared__ int s_occ[kWarps][kMaxDomain];
  const bool has_valid = valid != nullptr;
  for (int j = threadIdx.x; j < kWarps * kMaxDomain; j += kThreads) {
    s_acc[j / kMaxDomain][j % kMaxDomain] = identity<FN, A>();
    s_nn[j / kMaxDomain][j % kMaxDomain] = 0;
    s_occ[j / kMaxDomain][j % kMaxDomain] = 0;
  }
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const long long g = idx[i];
    if (!alive[i] || g < 0 || g >= domain) continue;
    if (has_valid) {
      atomicAdd(&s_occ[w][g], 1);
      if (!valid[i]) continue;
    }
    atomicAdd(&s_nn[w][g], 1);
    if constexpr (FN == kSum) atomic_add(&s_acc[w][g], (A)vals[i]);
    else if constexpr (FN == kMin) atomic_min(&s_acc[w][g], (A)vals[i]);
    else if constexpr (FN == kMax) atomic_max(&s_acc[w][g], (A)vals[i]);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < domain; g += kThreads) {
    A acc = identity<FN, A>();
    int nn = 0, occ = 0;
    for (int k = 0; k < kWarps; ++k) {
      acc = combine<FN, A>(acc, s_acc[k][g]);
      nn += s_nn[k][g];
      occ += s_occ[k][g];
    }
    const int64_t o = (int64_t)blockIdx.x * domain + g;
    part_val[o] = acc;
    part_nn[o] = nn;
    part_occ[o] = has_valid ? occ : nn;
  }
}

// Pass 2: one block per group; its threads stride over the per-block
// partials, then fold them in a fixed order.
template <int FN, typename A, typename O>
__global__ void __launch_bounds__(kThreads)
dense_group_final(const A* __restrict__ part_val,
                  const int* __restrict__ part_nn,
                  const int* __restrict__ part_occ, int blocks, int domain,
                  O* __restrict__ out_val, int* __restrict__ out_nn,
                  bool* __restrict__ out_occ) {
  const int g = blockIdx.x;
  A acc = identity<FN, A>();
  A unused = identity<FN, A>();
  long long nn = 0, occ = 0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    const int64_t o = (int64_t)b * domain + g;
    acc = combine<FN, A>(acc, part_val[o]);
    nn += part_nn[o];
    occ += part_occ[o];
  }
  block_reduce<FN, A>(acc, nn);
  __syncthreads();  // the second reduction reuses block_reduce's slots
  block_reduce<FN, A>(unused, occ);
  if (threadIdx.x == 0) {
    if constexpr (FN != kCount) out_val[g] = (O)acc;
    out_nn[g] = (int)nn;
    out_occ[g] = occ > 0;
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

template <int FN, typename T, typename A, typename O>
cudaError_t launch_dense_group(const void* idx, const void* vals,
                               const void* valid, const void* alive, int64_t n,
                               int domain, void* part_val, void* part_nn,
                               void* part_occ, int blocks, void* out_val,
                               void* out_nn, void* out_occ,
                               cudaStream_t stream) {
  dense_group_partial<FN, T, A><<<blocks, kThreads, 0, stream>>>(
      (const int64_t*)idx, (const T*)vals, (const uint8_t*)valid,
      (const uint8_t*)alive, n, domain, (A*)part_val, (int*)part_nn,
      (int*)part_occ);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dense_group_final<FN, A, O><<<domain, kThreads, 0, stream>>>(
      (const A*)part_val, (const int*)part_nn, (const int*)part_occ, blocks,
      domain, (O*)out_val, (int*)out_nn, (bool*)out_occ);
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

int qs_dense_group_reduce(int fn, int dtype, const void* idx, const void* vals,
                          const void* valid, const void* alive, int64_t n,
                          int domain, void* part_val, void* part_nn,
                          void* part_occ, int blocks, void* out_val,
                          void* out_nn, void* out_occ, void* stream) {
  if (domain < 1 || domain > kMaxDomain) return cudaErrorInvalidValue;
  QS_DISPATCH(launch_dense_group, idx, vals, valid, alive, n, domain, part_val,
              part_nn, part_occ, blocks, out_val, out_nn, out_occ,
              (cudaStream_t)stream)
}

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
