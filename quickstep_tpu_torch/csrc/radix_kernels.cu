// The sort of scalar DISTINCT (K12) for Hopper (sm_90a): a stable LSD radix
// sort of one column's values, written by hand. Plain C interface, loaded
// with ctypes by quickstep_tpu_torch/ops/cuda.py; qs_radix_sort_live
// launches on the stream it is given, allocates nothing, and returns the
// cudaError_t of its launches.
//
// It replaces the sort in quickstep_tpu/ops/groupby.py:455 distinct_count
// and quickstep_tpu/exec/runner.py:837 _dedup_values: the values with the
// dead and NULL rows replaced by the dtype's maximum (INT_MAX, +inf, True),
// sorted stably, and the number of live rows. The output is bit for bit the
// reference's stable sort (jnp.sort, and torch.sort on the CPU): each value
// maps to an unsigned key in that order (integers and bools: the sign bit
// flipped, a bijection; floats: -0.0 and +0.0 to one key, every NaN to one
// key above +inf, a negative float's bits inverted, a positive float's sign
// bit set), the sort is stable on that key, and it moves the values
// themselves, so -0.0, +0.0 and each NaN's payload keep their input order
// among equal keys. (torch.sort on the card puts negative NaNs before
// -inf, so the plain version sorts by a copy with zeros and NaNs made
// canonical.) The key is recomputed from the value in every pass; no key
// array is stored.
//
// Design. qs_radix_sort_live launches:
// 1. hist: one read of the values and masks builds the 8-bit digit
//    histograms of every pass at once (shared memory, then added to global
//    memory) and counts the live rows (n_live stays on the device). A warp
//    whose lanes share a digit adds 32 with one atomic, so a constant digit
//    costs no contended shared atomics.
// 2. plan (one block): each pass's digit offsets (an exclusive scan of its
//    histogram), and which passes run: a pass whose digit is the same in
//    every row leaves the order as it is and is skipped. The plan also
//    fixes each running pass's source and destination, alternating between
//    the output and one scratch buffer so that the last running pass
//    writes the output; the first running pass reads the input and applies
//    the masks itself. If no digit varies, the lowest pass runs anyway, to
//    move the input into the output. The host never reads the plan: every
//    pass kernel is launched, and a skipped pass returns at once.
// 3. one pass per digit, onesweep style: each block takes tiles of kTile
//    rows in order from an atomic counter. A warp loads kItems rows per lane
//    (each round 32 consecutive rows). The tile counts its digits with
//    shared atomics and publishes the counts at once; then it ranks its rows
//    stably within each warp, by peers found with one ballot per digit bit
//    and a per-warp count of each digit, and scans the warps' counts per
//    digit. A decoupled look-back over the earlier tiles' published counts
//    (one 64-bit word per tile and digit: the pass's tag above the count,
//    so a word from an earlier pass reads as not yet published and the
//    status array is zeroed once per sort; kLookBack words read at once,
//    with a growing pause while a word is not yet there) gives each digit's
//    rows before the tile. The tile's rows are staged in shared memory in
//    sorted order and written out in that order, so each digit's run goes
//    out coalesced.
//
// The plan, the warp ranks and the look-back live in radix_device.cuh,
// which also holds the key-value sort that K8 and K13 share; qs_kv_sort
// runs that sort alone on given keys (for the card tests and benchmarks).
//
// What bounds it: the bytes, at best. The histogram pass reads the values
// and masks once; each running pass reads and writes the values once (the
// first reads the masks again). For the 60 M int32 values in [1, 2 M] of
// chip_smoke.py the top byte never varies, so three of the four passes run.
// The look-back's status words add 2 KiB per 4,096-row tile and pass. On an
// H100 a pass takes about three times its bytes' time: each tile's steps
// (its loads, the ranks, the look-back, barriers between them) wait on one
// another, and three blocks an SM do not hide all of it (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_device.cuh"

namespace {

using namespace radix;

constexpr int kItems = 16;                  // rows per lane and tile
constexpr int kWarpRows = 32 * kItems;
constexpr int kTile = kThreads * kItems;    // rows per tile

enum { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3, kU8 = 4 };

template <typename T> struct Radix;

template <> struct Radix<int> {
  typedef unsigned int Key;
  static constexpr int kPasses = 4;
  static __device__ __forceinline__ Key key(int x) {
    return (unsigned int)x ^ 0x80000000u;
  }
  static __device__ __forceinline__ int top() { return INT32_MAX; }
};

template <> struct Radix<long long> {
  typedef unsigned long long Key;
  static constexpr int kPasses = 8;
  static __device__ __forceinline__ Key key(long long x) {
    return (unsigned long long)x ^ 0x8000000000000000ull;
  }
  static __device__ __forceinline__ long long top() { return INT64_MAX; }
};

template <> struct Radix<float> {
  typedef unsigned int Key;
  static constexpr int kPasses = 4;
  static __device__ __forceinline__ Key key(float x) {
    if (x != x) return 0xffffffffu;
    if (x == 0.0f) return 0x80000000u;
    const unsigned int b = __float_as_uint(x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
  static __device__ __forceinline__ float top() {
    return __int_as_float(0x7f800000);
  }
};

template <> struct Radix<double> {
  typedef unsigned long long Key;
  static constexpr int kPasses = 8;
  static __device__ __forceinline__ Key key(double x) {
    if (x != x) return 0xffffffffffffffffull;
    if (x == 0.0) return 0x8000000000000000ull;
    const unsigned long long b = (unsigned long long)__double_as_longlong(x);
    return (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
  }
  static __device__ __forceinline__ double top() {
    return __longlong_as_double(0x7ff0000000000000ll);
  }
};

template <> struct Radix<unsigned char> {   // bool, as 0 / 1 bytes
  typedef unsigned int Key;
  static constexpr int kPasses = 1;
  static __device__ __forceinline__ Key key(unsigned char x) { return x; }
  static __device__ __forceinline__ unsigned char top() { return 1; }
};

template <typename T>
__device__ __forceinline__ unsigned digit_of(T v, int shift) {
  return (unsigned)(Radix<T>::key(v) >> shift) & 0xffu;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const T* __restrict__ vals, const bool* __restrict__ alive,
            const bool* __restrict__ valid, int64_t n,
            unsigned long long* hist, unsigned long long* n_live) {
  constexpr int P = Radix<T>::kPasses;
  __shared__ unsigned int sh[P * kBins];
  for (int i = threadIdx.x; i < P * kBins; i += kThreads) sh[i] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  unsigned int live_rows = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads * kHistRows;
  // the trip count is the block's, so every lane of a warp takes part in
  // the warp votes; each thread loads kHistRows rows before it counts them
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kHistRows; base < n;
       base += stride) {
    typename Radix<T>::Key k[kHistRows];
    bool in[kHistRows];
#pragma unroll
    for (int u = 0; u < kHistRows; ++u) {
      const int64_t i = base + u * kThreads + threadIdx.x;
      in[u] = i < n;
      T v = Radix<T>::top();
      if (in[u]) {
        const bool live = alive[i] && (valid == nullptr || valid[i]);
        const T x = vals[i];
        live_rows += live;
        if (live) v = x;
      }
      k[u] = Radix<T>::key(v);
    }
#pragma unroll
    for (int u = 0; u < kHistRows; ++u) {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const unsigned d = in[u] ? (unsigned)(k[u] >> (8 * p)) & 0xffu : kBins;
        if (__all_sync(0xffffffffu, d == __shfl_sync(0xffffffffu, d, 0))) {
          if (lane == 0 && d < kBins) atomicAdd(&sh[p * kBins + d], 32u);
        } else if (in[u]) {
          atomicAdd(&sh[p * kBins + d], 1u);
        }
      }
    }
  }
  live_rows = __reduce_add_sync(0xffffffffu, live_rows);
  if (lane == 0 && live_rows) atomicAdd(n_live, (unsigned long long)live_rows);
  __syncthreads();
  for (int i = threadIdx.x; i < P * kBins; i += kThreads)
    if (sh[i]) atomicAdd(&hist[i], (unsigned long long)sh[i]);
}

// at most 85 registers a thread, so that three blocks fit on an SM: the
// pass is bound by the latency of its steps, and a third block hides more
// of it than the registers it gives up
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
pass_kernel(const T* __restrict__ vals, const bool* __restrict__ alive,
            const bool* __restrict__ valid, int64_t n, int pass,
            const Plan* __restrict__ plan, T* out, T* tmp,
            unsigned long long* status, int* tile_counter, int n_tiles) {
  if (!plan->active[pass]) return;
  const int src_kind = plan->src[pass];
  const T* src = src_kind == kInput ? vals : (src_kind == kOut ? out : tmp);
  T* dst = plan->dst[pass] == kOut ? out : tmp;
  const int shift = 8 * pass;
  const unsigned long long agg_tag = 2ull * pass + 1;
  const unsigned long long pre_tag = 2ull * pass + 2;

  __shared__ unsigned int warp_count[kWarps][kBins];
  __shared__ unsigned int tile_count[kBins];
  __shared__ unsigned int digit_start[kBins];
  __shared__ long long out_base[kBins];
  __shared__ long long digit_base[kBins];    // the pass's digit offsets
  __shared__ unsigned int warp_sum[kWarps];
  __shared__ int tile_sh;
  __shared__ T stage[kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = threadIdx.x;                  // the digit this thread scans
  digit_base[b] = plan->base[pass][b];

  for (;;) {
    if (threadIdx.x == 0) tile_sh = atomicAdd(&tile_counter[pass], 1);
    for (int i = lane; i < kBins; i += 32) warp_count[warp][i] = 0;
    tile_count[b] = 0;
    __syncthreads();
    const int tile = tile_sh;
    if (tile >= n_tiles) break;
    const int64_t first = (int64_t)tile * kTile;
    const int64_t base = first + (int64_t)warp * kWarpRows;

    // every load of the tile is issued before any is used: rows past n
    // read row n - 1 and are marked by the digit kBins
    const bool full = first + kTile <= n;
    T v[kItems];
    if (src_kind == kInput) {
      bool live[kItems];
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int64_t r = base + j * 32 + lane;
        const int64_t at = full || r < n ? r : n - 1;
        v[j] = src[at];
        live[j] = alive[at];
        if (valid != nullptr) live[j] = live[j] & valid[at];
      }
#pragma unroll
      for (int j = 0; j < kItems; ++j)
        if (!live[j]) v[j] = Radix<T>::top();
    } else {
#pragma unroll
      for (int j = 0; j < kItems; ++j) {
        const int64_t r = base + j * 32 + lane;
        v[j] = src[full || r < n ? r : n - 1];
      }
    }
    unsigned dg[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      dg[j] = full || base + j * 32 + lane < n ? digit_of(v[j], shift)
                                                : (unsigned)kBins;
    // the tile's count of each digit, published before the ranks are
    // computed so that later tiles' look-backs find it early; tile 0's is
    // already its inclusive prefix
#pragma unroll
    for (int j = 0; j < kItems; ++j)
      if (dg[j] < kBins) atomicAdd(&tile_count[dg[j]], 1u);
    __syncthreads();
    const unsigned total = tile_count[b];
    volatile unsigned long long* st = status + (int64_t)tile * kBins + b;
    *st = ((tile == 0 ? pre_tag : agg_tag) << 32) | total;
    // stable ranks within the warp (radix_device.cuh warp_ranks)
    unsigned rank[kItems];
    warp_ranks<kItems>(dg, warp_count[warp], lane, rank);
    __syncthreads();

    // per digit: the earlier warps' rows
    unsigned before_warp = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = warp_count[w][b];
      warp_count[w][b] = before_warp;
      before_warp += c;
    }
    // the tile's exclusive scan over the digits
    unsigned x = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sum[warp] = x;
    __syncthreads();
    unsigned woff = 0;
    for (int w = 0; w < warp; ++w) woff += warp_sum[w];
    const unsigned start = woff + x - total;
    digit_start[b] = start;
    __syncthreads();
    // stage the rows in sorted order, which frees their registers for the
    // look-back
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const unsigned d = dg[j];
      if (d < kBins)
        stage[digit_start[d] + warp_count[warp][d] + rank[j]] = v[j];
    }
    // the digit's rows in the earlier tiles (radix_device.cuh look_back)
    long long before_tile = 0;
    if (tile > 0) {
      before_tile = look_back(status, tile, b, agg_tag, pre_tag);
      *st = (pre_tag << 32) | (unsigned long long)(before_tile + total);
    }
    out_base[b] = digit_base[b] + before_tile - (long long)start;
    __syncthreads();
    const int rows = (int)(n - first < kTile ? n - first : kTile);
    for (int p = threadIdx.x; p < rows; p += kThreads) {
      const T y = stage[p];
      dst[out_base[digit_of(y, shift)] + p] = y;
    }
    __syncthreads();
  }
}

template <typename T>
int launch_sort(const void* vals, const void* alive, const void* valid,
                int64_t n, void* out, void* tmp, void* scratch, void* n_live,
                int hist_blocks, int pass_blocks, cudaStream_t st) {
  constexpr int P = Radix<T>::kPasses;
  const int n_tiles = (int)((n + kTile - 1) / kTile);
  // scratch: hist [kMaxPasses * kBins], tile counters [kMaxPasses ints],
  // the plan, then the status words [n_tiles * kBins]; zeroed by the caller
  unsigned long long* hist = (unsigned long long*)scratch;
  int* counters = (int*)(hist + kMaxPasses * kBins);
  Plan* plan = (Plan*)(hist + kMaxPasses * kBins + kMaxPasses / 2);
  unsigned long long* status =
      hist + kMaxPasses * kBins + kMaxPasses / 2 + sizeof(Plan) / 8;
  hist_kernel<T><<<hist_blocks, kThreads, 0, st>>>(
      (const T*)vals, (const bool*)alive, (const bool*)valid, n, hist,
      (unsigned long long*)n_live);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  plan_kernel<<<1, kBins, 0, st>>>(hist, P, n, plan, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int grid = pass_blocks < n_tiles ? pass_blocks : n_tiles;
  for (int p = 0; p < P; ++p) {
    pass_kernel<T><<<grid, kThreads, 0, st>>>(
        (const T*)vals, (const bool*)alive, (const bool*)valid, n, p, plan,
        (T*)out, (T*)tmp, status, counters, n_tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The key-value sort of given unsigned keys (radix_device.cuh), which K8
// and K13 run on their range-compressed codes: the source reads the keys.
template <typename K>
struct GivenKeys {
  const K* keys;
  __device__ __forceinline__ unsigned long long code(
      int64_t i, unsigned long long, unsigned long long) const {
    return keys[i];
  }
};

}  // namespace

extern "C" {

// The 64-bit words of scratch a sort of n rows needs (zeroed by the caller).
int64_t qs_radix_scratch_words(int64_t n) {
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  return kMaxPasses * kBins + kMaxPasses / 2 + (int64_t)sizeof(Plan) / 8 +
         n_tiles * kBins;
}

// The 64-bit words of scratch of a key-value sort of n rows (radix_device.cuh
// kv_scratch_words; the sort zeroes it itself).
int64_t qs_kv_scratch_words(int64_t n) { return radix::kv_scratch_words(n); }

// The n (key, payload) records sorted stably by the unsigned key, 4 or 8
// bytes (key_bytes); vals may be null (the payload is then the row id).
// keys_out / vals_out receive the result, keys_tmp / vals_tmp are scratch of
// n records, scratch holds qs_kv_scratch_words(n) words. n < 2^31.
int qs_kv_sort(int key_bytes, const void* keys, const void* vals, int64_t n,
               void* keys_out, void* vals_out, void* keys_tmp, void* vals_tmp,
               void* scratch, int hist_blocks, int pass_blocks, void* stream) {
  if (n < 0 || n >= (1ll << 31) || hist_blocks < 1 || pass_blocks < 1 ||
      (key_bytes != 4 && key_bytes != 8))
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  const radix::KvBufs b = {const_cast<void*>(keys), (const int*)vals,
                           keys_out, (int*)vals_out, keys_tmp,
                           (int*)vals_tmp};
  cudaStream_t st = (cudaStream_t)stream;
  if (key_bytes == 4)
    return radix::kv_sort<4>(GivenKeys<unsigned>{(const unsigned*)keys},
                             nullptr, n, false, b, scratch, nullptr,
                             hist_blocks, pass_blocks, st);
  return radix::kv_sort<8>(
      GivenKeys<unsigned long long>{(const unsigned long long*)keys}, nullptr,
      n, false, b, scratch, nullptr, hist_blocks, pass_blocks, st);
}

// out = the n values (dtype; bools as 0 / 1 bytes) with the rows that are
// not alive & valid (valid may be null) as the dtype's maximum, sorted
// stably; tmp: n more values of scratch; n_live: one int64 on the device,
// 0, which receives the number of live rows. n < 2^31.
int qs_radix_sort_live(int dtype, const void* vals, const void* alive,
                       const void* valid, int64_t n, void* out, void* tmp,
                       void* scratch, void* n_live, int hist_blocks,
                       int pass_blocks, void* stream) {
  if (n < 0 || n >= (1ll << 31) || hist_blocks < 1 || pass_blocks < 1)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kI32: return launch_sort<int>(vals, alive, valid, n, out, tmp, scratch, n_live, hist_blocks, pass_blocks, st);
    case kI64: return launch_sort<long long>(vals, alive, valid, n, out, tmp, scratch, n_live, hist_blocks, pass_blocks, st);
    case kF32: return launch_sort<float>(vals, alive, valid, n, out, tmp, scratch, n_live, hist_blocks, pass_blocks, st);
    case kF64: return launch_sort<double>(vals, alive, valid, n, out, tmp, scratch, n_live, hist_blocks, pass_blocks, st);
    case kU8: return launch_sort<unsigned char>(vals, alive, valid, n, out, tmp, scratch, n_live, hist_blocks, pass_blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
