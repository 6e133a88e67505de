// The LSD radix sort of the port, shared by K12 (radix_kernels.cu), K13
// (sort_kernels.cu) and K8 (join_kernels.cu): the digit plan, the pieces
// of a onesweep pass (stable ranks within a warp, the decoupled look-back),
// and the key-value sort that K8 and K13 run on range-compressed codes.
//
// The key-value sort orders (unsigned key, int32 payload) records stably by
// the key. Its keys are codes that a source struct computes row by row:
//
// - Range compression. A reduce launch finds the min and max of the
//   order-preserving codes of the rows that count (not NULL; for K8 also
//   not dead), and a one-thread launch turns them into the range [lo, hi]:
//   lo = min - 1 and hi = max + 1, each where the code space has room. The
//   encode maps a valid row's code u to u - lo and a NULL or dead row's
//   sentinel code to clamp(sentinel, lo, hi) - lo, all in unsigned
//   arithmetic: a NULL keeps every tie it has in the reference (a valid
//   value at the dtype's extreme ties with NULLs there, and a float NULL at
//   +inf still sorts below a NaN), and the codes span hi - lo + 1 values, so
//   the digits above that span are 0 in every row and the plan skips them.
//   Where the codes of a 64-bit key span all 64 bits, lo = 0 and hi = 2^64
//   - 1, nothing is skipped and the order is still right.
// - Key width. A key whose range fits 32 bits (hi - lo < 2^32) is stored as
//   uint32, else as uint64. The host cannot know which without a sync, so
//   for a 64-bit source every launch is made in both widths and the one
//   whose width the range does not pick returns at once.
// - One launch encodes the rows, writes the codes and builds the 8-bit
//   digit histograms of every pass (K12's histogram, fed by the source);
//   the plan skips every digit that is the same in every row; each running
//   pass moves the key and its payload (row ids, where the caller gives no
//   payload) through shared memory, as K12's passes move its values.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace radix {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;
constexpr int kMaxPasses = 8;
constexpr int kLookBack = 16;              // status words read at once
constexpr int kHistRows = 4;               // rows per thread and round
// rows a lane moves in a key-value pass: 12 with 32-bit keys, 8 with 64-bit
// ones, so that three blocks of 256 threads fit on an SM in 85 registers
constexpr int kKvItems32 = 12;
constexpr int kKvItems64 = 8;
constexpr int kKvMinTile = kThreads * kKvItems64;

enum { kInput = 0, kOut = 1, kTmp = 2 };

struct Plan {
  long long base[kMaxPasses][kBins];  // rows of the smaller digits
  int active[kMaxPasses];
  int src[kMaxPasses];
  int dst[kMaxPasses];
};

// The reduced range of one key's codes (min > max: no row counts), then lo,
// hi and whether hi - lo fits 32 bits.
struct Span {
  unsigned long long min, max, lo, hi;
  int narrow;
  int pad;
};

// Each pass's digit offsets and which passes run (a digit that is the same
// in every row leaves the order as it is); the running passes alternate
// between the output and the scratch buffer so that the last one writes
// the output. With narrow set (a 64-bit source whose range fits 32 bits)
// only the first four passes can run.
// (static, like span_kernel: every source that includes this header keeps
// its own copy; the templates below are merged by the linker.)
static __global__ void __launch_bounds__(kBins)
plan_kernel(const unsigned long long* __restrict__ hist, int passes,
            int64_t n, Plan* plan, const int* __restrict__ narrow) {
  __shared__ unsigned long long scan[kBins];
  __shared__ int run[kMaxPasses];
  const int d = threadIdx.x;
  if (narrow != nullptr && *narrow && passes > 4) passes = 4;
  if (d < kMaxPasses) run[d] = 1;
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const unsigned long long c = hist[p * kBins + d];
    if (c == (unsigned long long)n) run[p] = 0;   // one digit in every row
    scan[d] = c;
    __syncthreads();
    for (int off = 1; off < kBins; off <<= 1) {
      const unsigned long long t = d >= off ? scan[d - off] : 0;
      __syncthreads();
      scan[d] += t;
      __syncthreads();
    }
    plan->base[p][d] = (long long)(scan[d] - c);
    __syncthreads();
  }
  if (d == 0) {
    int count = 0;
    for (int p = 0; p < passes; ++p) count += run[p];
    if (count == 0) {
      run[0] = 1;
      count = 1;
    }
    int prev = kInput, left = count;
    for (int p = 0; p < kMaxPasses; ++p) {
      const bool on = p < passes && run[p];
      plan->active[p] = on;
      if (!on) continue;
      // the last running pass (left == 1) writes the output
      const int dst = (left & 1) ? kOut : kTmp;
      plan->src[p] = prev;
      plan->dst[p] = dst;
      prev = dst;
      --left;
    }
  }
}

// Stable ranks within a warp: round j holds rows j * 32 + lane, dg[j] their
// digits (kBins past n). A lane's peers (the lanes with its digit) come
// from one ballot per digit bit and one for the rows past n; the lowest
// peer adds the peers to the warp's count of the digit and hands the old
// count on. The rounds' peers first, then their atomics back to back, then
// the ranks: no round waits on the one before. kBits and limit serve
// digits of fewer bits (K14's bins): every dg[j] fits kBits bits, and only
// digits below limit are counted.
template <int N, int kBits = 9>
__device__ __forceinline__ void warp_ranks(const unsigned (&dg)[N],
                                           unsigned* warp_count, int lane,
                                           unsigned (&rank)[N],
                                           unsigned limit = kBins) {
  const unsigned lower = (1u << lane) - 1u;
  unsigned peers[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    peers[j] = 0xffffffffu;
#pragma unroll
    for (int bit = 0; bit < kBits; ++bit) {
      const bool set = (dg[j] >> bit) & 1u;
      const unsigned vote = __ballot_sync(0xffffffffu, set);
      peers[j] &= set ? vote : ~vote;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
    rank[j] = 0;
    if (lane == __ffs(peers[j]) - 1 && dg[j] < limit)
      rank[j] = atomicAdd(&warp_count[dg[j]], (unsigned)__popc(peers[j]));
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    rank[j] = __shfl_sync(0xffffffffu, rank[j], __ffs(peers[j]) - 1) +
              __popc(peers[j] & lower);
}

// The rows of digit b in the tiles before `tile`: kLookBack status words
// are read at once, nearest first, and summed up to the first inclusive
// prefix; a word not yet published starts the next window there, after a
// pause that doubles while it waits, so that waiting tiles do not crowd the
// L2 with reads. A word's tag (above its count) names the pass that wrote
// it, so a word of an earlier pass reads as not yet published. A tile's
// words lie `stride` apart (kBins: a word for every digit).
__device__ __forceinline__ long long look_back(
    const unsigned long long* status, int tile, int b,
    unsigned long long agg_tag, unsigned long long pre_tag,
    int64_t stride = kBins) {
  long long before_tile = 0;
  unsigned pause = 32;
  for (int t = tile - 1;;) {
    unsigned long long w[kLookBack];
#pragma unroll
    for (int i = 0; i < kLookBack; ++i)
      w[i] = t - i >= 0 ? *(volatile const unsigned long long*)(
                              status + (int64_t)(t - i) * stride + b)
                        : 0ull;
    int i = 0;
    bool done = false;
#pragma unroll
    for (int k = 0; k < kLookBack; ++k) {
      if (done || i < k) continue;
      const unsigned long long tag = w[k] >> 32;
      if (tag < agg_tag) continue;        // not published yet
      before_tile += (unsigned int)w[k];
      done = tag == pre_tag;
      i = k + 1;
    }
    if (done) return before_tile;
    if (i == 0) {
      __nanosleep(pause);
      pause = pause < 1024 ? 2 * pause : pause;
    }
    t -= i;
  }
}

// ---------------------------------------------------------------------
// the key-value sort
// ---------------------------------------------------------------------

template <typename K>
__device__ __forceinline__ bool wrong_width(const int* narrow) {
  return narrow != nullptr && *narrow != (sizeof(K) == 4 ? 1 : 0);
}

// Reduce launch: the min and max code of the rows the source counts.
template <typename Src>
__global__ void __launch_bounds__(kThreads)
range_reduce_kernel(Src src, int64_t n, Span* span) {
  unsigned long long mn = ~0ull, mx = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    unsigned long long u;
    if (src.raw(i, u)) {
      mn = u < mn ? u : mn;
      mx = u > mx ? u : mx;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long a = __shfl_down_sync(0xffffffffu, mn, off);
    const unsigned long long b = __shfl_down_sync(0xffffffffu, mx, off);
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
  }
  if ((threadIdx.x & 31) == 0) {
    if (mn != ~0ull) atomicMin(&span->min, mn);
    if (mx != 0) atomicMax(&span->max, mx);
  }
}

// One thread: lo, hi and the key width from the reduced min and max; top is
// the largest code of the source's code space.
static __global__ void span_kernel(Span* span,
                                   unsigned long long top) {
  const unsigned long long mn = span->min, mx = span->max;
  unsigned long long lo = 0, hi = 0;
  if (mn <= mx) {
    lo = mn > 0 ? mn - 1 : 0;
    hi = mx < top ? mx + 1 : mx;
  }
  span->lo = lo;
  span->hi = hi;
  span->narrow = hi - lo <= 0xffffffffull;
}

// Encode launch: codes[i] = the source's code of row i (unless codes is
// null: the source reads given keys), and the 8-bit digit histograms of the
// first P passes (K12's histogram: a warp whose lanes share a digit adds 32
// with one atomic).
template <typename K, int P, typename Src>
__global__ void __launch_bounds__(kThreads)
code_hist_kernel(Src src, const Span* __restrict__ span, int64_t n,
                 K* __restrict__ codes, unsigned long long* hist,
                 const int* __restrict__ narrow) {
  if (wrong_width<K>(narrow)) return;
  __shared__ unsigned int sh[P * kBins];
  for (int i = threadIdx.x; i < P * kBins; i += kThreads) sh[i] = 0;
  __syncthreads();
  const unsigned long long lo = span != nullptr ? span->lo : 0;
  const unsigned long long hi = span != nullptr ? span->hi : 0;
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kThreads * kHistRows;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kHistRows; base < n;
       base += stride) {
    K k[kHistRows];
    bool in[kHistRows];
#pragma unroll
    for (int u = 0; u < kHistRows; ++u) {
      const int64_t i = base + u * kThreads + threadIdx.x;
      in[u] = i < n;
      k[u] = in[u] ? (K)src.code(i, lo, hi) : (K)0;
      if (in[u] && codes != nullptr) codes[i] = k[u];
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
  __syncthreads();
  for (int i = threadIdx.x; i < P * kBins; i += kThreads)
    if (sh[i]) atomicAdd(&hist[i], (unsigned long long)sh[i]);
}

// One key-value pass (K12's pass_kernel with a payload beside the key): each
// block takes tiles of kThreads * N records in order from an atomic
// counter, ranks them stably by the pass's digit, looks back for each
// digit's records in the earlier tiles, stages the tile in shared memory in
// sorted order and writes it out. The first running pass reads the codes
// and the caller's payload (row ids where vals_in is null).
template <typename K, int N>
__global__ void __launch_bounds__(kThreads, 3)
kv_pass_kernel(const K* __restrict__ keys_in, const int* __restrict__ vals_in,
               int64_t n, int pass, const Plan* __restrict__ plan,
               K* keys_out, int* vals_out, K* keys_tmp, int* vals_tmp,
               unsigned long long* status, int* tile_counter,
               const int* __restrict__ narrow) {
  if (wrong_width<K>(narrow) || !plan->active[pass]) return;
  constexpr int kTile = kThreads * N;
  constexpr int kWarpRows = 32 * N;
  const int n_tiles = (int)((n + kTile - 1) / kTile);
  const int src_kind = plan->src[pass];
  const K* ksrc = src_kind == kInput ? keys_in
                                     : (src_kind == kOut ? keys_out : keys_tmp);
  const int* vsrc = src_kind == kInput ? vals_in
                                       : (src_kind == kOut ? vals_out : vals_tmp);
  K* kdst = plan->dst[pass] == kOut ? keys_out : keys_tmp;
  int* vdst = plan->dst[pass] == kOut ? vals_out : vals_tmp;
  const int shift = 8 * pass;
  const unsigned long long agg_tag = 2ull * pass + 1;
  const unsigned long long pre_tag = 2ull * pass + 2;

  __shared__ unsigned int warp_count[kWarps][kBins];
  __shared__ unsigned int tile_count[kBins];
  __shared__ unsigned int digit_start[kBins];
  __shared__ long long out_base[kBins];
  __shared__ long long digit_base[kBins];
  __shared__ unsigned int warp_sum[kWarps];
  __shared__ int tile_sh;
  __shared__ K stage_k[kTile];
  __shared__ int stage_v[kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = threadIdx.x;
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
    const bool full = first + kTile <= n;
    K k[N];
    int v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int64_t r = base + j * 32 + lane;
      const int64_t at = full || r < n ? r : n - 1;
      k[j] = ksrc[at];
      v[j] = vsrc != nullptr ? vsrc[at] : (int)at;
    }
    unsigned dg[N];
#pragma unroll
    for (int j = 0; j < N; ++j)
      dg[j] = full || base + j * 32 + lane < n
                  ? (unsigned)(k[j] >> shift) & 0xffu : (unsigned)kBins;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (dg[j] < kBins) atomicAdd(&tile_count[dg[j]], 1u);
    __syncthreads();
    const unsigned total = tile_count[b];
    volatile unsigned long long* st = status + (int64_t)tile * kBins + b;
    *st = ((tile == 0 ? pre_tag : agg_tag) << 32) | total;
    unsigned rank[N];
    warp_ranks<N>(dg, warp_count[warp], lane, rank);
    __syncthreads();
    unsigned before_warp = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned c = warp_count[w][b];
      warp_count[w][b] = before_warp;
      before_warp += c;
    }
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
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const unsigned d = dg[j];
      if (d < kBins) {
        const unsigned at = digit_start[d] + warp_count[warp][d] + rank[j];
        stage_k[at] = k[j];
        stage_v[at] = v[j];
      }
    }
    long long before_tile = 0;
    if (tile > 0) {
      before_tile = look_back(status, tile, b, agg_tag, pre_tag);
      *st = (pre_tag << 32) | (unsigned long long)(before_tile + total);
    }
    out_base[b] = digit_base[b] + before_tile - (long long)start;
    __syncthreads();
    const int rows = (int)(n - first < kTile ? n - first : kTile);
    for (int p = threadIdx.x; p < rows; p += kThreads) {
      const K y = stage_k[p];
      const long long to = out_base[(unsigned)(y >> shift) & 0xffu] + p;
      kdst[to] = y;
      vdst[to] = stage_v[p];
    }
    __syncthreads();
  }
}

// The buffers of one key-value sort: the codes (written by the encode, or
// given), the payload (null: row ids), and the output and scratch of each.
struct KvBufs {
  void* keys_in;
  const int* vals_in;
  void* keys_out;
  int* vals_out;
  void* keys_tmp;
  int* vals_tmp;
};

// The 64-bit words of scratch of a key-value sort of n rows: the
// histograms, the tile counters, the plan, then one status word per tile
// (of the smallest tile) and digit.
inline int64_t kv_scratch_words(int64_t n) {
  const int64_t n_tiles = (n + kKvMinTile - 1) / kKvMinTile;
  return kMaxPasses * kBins + kMaxPasses / 2 + (int64_t)sizeof(Plan) / 8 +
         n_tiles * kBins;
}

// A key-value sort of the source's codes, stable, on the stream. narrow null:
// keys of the source's own width (32 or 64 bits); else the range's flag
// picks the width, and every launch is made in both. P: the digits of the
// source's code space. The sorted records land in keys_out and vals_out.
template <int P, typename Src>
cudaError_t kv_sort(const Src& src, const Span* span, int64_t n,
                    bool write_codes, const KvBufs& b, void* scratch,
                    const int* narrow, int hist_blocks, int pass_blocks,
                    cudaStream_t st) {
  unsigned long long* hist = (unsigned long long*)scratch;
  int* counters = (int*)(hist + kMaxPasses * kBins);
  Plan* plan = (Plan*)(hist + kMaxPasses * kBins + kMaxPasses / 2);
  unsigned long long* status =
      hist + kMaxPasses * kBins + kMaxPasses / 2 + sizeof(Plan) / 8;
  cudaError_t err = cudaMemsetAsync(scratch, 0, kv_scratch_words(n) * 8, st);
  if (err != cudaSuccess) return err;
  const bool wide = P > 4;
  const bool both = wide && narrow != nullptr;
  if (!wide || both) {
    code_hist_kernel<unsigned, (P < 4 ? P : 4), Src>
        <<<hist_blocks, kThreads, 0, st>>>(
            src, span, n, write_codes ? (unsigned*)b.keys_in : nullptr, hist,
            narrow);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (wide) {
    code_hist_kernel<unsigned long long, P, Src>
        <<<hist_blocks, kThreads, 0, st>>>(
            src, span, n,
            write_codes ? (unsigned long long*)b.keys_in : nullptr, hist,
            narrow);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  plan_kernel<<<1, kBins, 0, st>>>(hist, P, n, plan, narrow);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t t32 = (n + kThreads * kKvItems32 - 1) / (kThreads * kKvItems32);
  const int64_t t64 = (n + kThreads * kKvItems64 - 1) / (kThreads * kKvItems64);
  const int g32 = (int)(pass_blocks < t32 ? pass_blocks : t32);
  const int g64 = (int)(pass_blocks < t64 ? pass_blocks : t64);
  for (int p = 0; p < P; ++p) {
    if ((!wide || both) && p < 4) {
      kv_pass_kernel<unsigned, kKvItems32><<<g32, kThreads, 0, st>>>(
          (const unsigned*)b.keys_in, b.vals_in, n, p, plan,
          (unsigned*)b.keys_out, b.vals_out, (unsigned*)b.keys_tmp,
          b.vals_tmp, status, counters, narrow);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (wide) {
      kv_pass_kernel<unsigned long long, kKvItems64><<<g64, kThreads, 0, st>>>(
          (const unsigned long long*)b.keys_in, b.vals_in, n, p, plan,
          (unsigned long long*)b.keys_out, b.vals_out,
          (unsigned long long*)b.keys_tmp, b.vals_tmp, status, counters,
          narrow);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// The range of the source's codes into span (reduce, then lo, hi, width).
template <typename Src>
cudaError_t reduce_range(const Src& src, int64_t n, Span* span,
                         unsigned long long top, int blocks,
                         cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(&span->min, 0xff, 8, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(&span->max, 0, 8, st);
  if (err != cudaSuccess) return err;
  range_reduce_kernel<Src><<<blocks, kThreads, 0, st>>>(src, n, span);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  span_kernel<<<1, 1, 0, st>>>(span, top);
  return cudaGetLastError();
}

}  // namespace radix
