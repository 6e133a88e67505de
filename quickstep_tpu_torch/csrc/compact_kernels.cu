// Compaction kernel for Hopper (sm_90a): the stable live-first partition of
// row positions (K9). Plain C interface, loaded with ctypes by
// quickstep_tpu_torch/ops/cuda.py; the function launches on the stream it is
// given, allocates nothing, and returns the cudaError_t of its launches.
//
// qs_stable_partition replaces the compaction inside
// quickstep_tpu/ops/groupby.py:405 sort_groupby_compact, that is
// ops/kernels.py:132 compact_order (the TPU's payload-carrying stable sort of
// the dead mask) and :35 compact_indices (the cumsum destinations). Its
// result is the head of `limit` entries of the permutation
// torch.argsort(~mask, stable=True): the positions of the live rows in
// order, then those of the dead rows in order. The join compaction keeps
// only its target's worth of rows, and the dead rows' positions are then
// never written.
//
// What bounds it on an H100: bytes. The function must read the 1-byte mask
// once and write `limit` 8-byte positions. Two launches, one where the mask
// fits one tile of kTile rows:
//  - count: each block takes the next kCountTiles tiles from an atomic
//    ticket, reads their mask by 16-byte loads (one a thread a tile, all in
//    flight at once), sums the bytes by popcount and warp reductions,
//    publishes the tiles' live count and finds the live rows before them
//    by a decoupled look-back (one warp reads 32 blocks' status words at
//    once, nearest first); with one tile a block the look-back's latency
//    is the block's life (0.064 ms at 60 M rows on an H100, against 0.033
//    with 16). The last block also writes the live total, which places
//    the dead rows.
//  - scatter: eight blocks an SM walk the tiles, each loading its next
//    tile's mask and base before it ranks the current one (with a block a
//    tile, those loads' latency cost 0.088 ms at 60 M rows whatever was
//    written). A tile's rows are read again (16 bytes a thread), ranked by
//    popcount within the thread, a warp scan of the threads' counts and
//    one pass over the 8 warp totals (one barrier), staged in shared
//    memory, live then dead offsets, and written out in order,
//    consecutive threads to consecutive positions, so that each warp's
//    stores fill whole sectors. Only the rows that land below `limit` are
//    staged and written; with out_mask each written position also gets
//    its row's mask value, which the join compaction would otherwise
//    gather.
// No sort, and no barrier per row round.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                          // rows a thread: 16 bytes
constexpr int64_t kTile = (int64_t)kThreads * kItems;
constexpr int kCountTiles = 16;                     // tiles a count block
constexpr unsigned kFull = 0xffffffffu;

// A tile's status word: its flag in the top two bits, a row count below.
constexpr unsigned long long kAgg = 1ull << 62;     // the tile's own live rows
constexpr unsigned long long kPre = 2ull << 62;     // the live rows up to its end
constexpr unsigned long long kFlags = 3ull << 62;
constexpr unsigned long long kCount = ~kFlags;

// The thread's 16 mask bytes from row r, each made 0 or 1; rows at or past n
// read as 0. One 16-byte load where all 16 lie below n (the wrapper hands
// over a 16-byte aligned mask).
template <bool kLast>
__device__ __forceinline__ uint4 load_mask(const uint8_t* __restrict__ mask,
                                           int64_t r, int64_t n) {
  uint4 m;
  if (r + kItems <= n) {
    m = kLast ? __ldcs(reinterpret_cast<const uint4*>(mask + r))
              : __ldg(reinterpret_cast<const uint4*>(mask + r));
  } else {
    unsigned w[4] = {0, 0, 0, 0};
    for (int k = 0; k < kItems && r + k < n; ++k)
      w[k >> 2] |= (unsigned)mask[r + k] << (8 * (k & 3));
    m = make_uint4(w[0], w[1], w[2], w[3]);
  }
  unsigned* w = reinterpret_cast<unsigned*>(&m);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    unsigned b = w[q];
    b |= b >> 4;
    b |= b >> 2;
    b |= b >> 1;
    w[q] = b & 0x01010101u;
  }
  return m;
}

__device__ __forceinline__ unsigned live_count(const uint4& m) {
  return __popc(m.x) + __popc(m.y) + __popc(m.z) + __popc(m.w);
}

// The live rows of the tiles before `tile`, by warp 0 of its block: each
// lane reads one status word, lane 0 the nearest; the words up to the
// nearest inclusive prefix are summed, unless a word not yet published
// comes first: then the words before it are summed and the window moves
// there, after a pause that doubles while lane 0's word is unpublished.
__device__ __forceinline__ long long look_back(
    const unsigned long long* status, int tile, int lane) {
  long long before = 0;
  unsigned pause = 32;
  for (int t = tile - 1;;) {
    const int at = t - lane;
    const unsigned long long w =
        at >= 0 ? *(volatile const unsigned long long*)(status + at) : kPre;
    const unsigned pre = __ballot_sync(kFull, (w & kFlags) == kPre);
    const unsigned unpub = __ballot_sync(kFull, (w & kFlags) == 0);
    const int first_pre = pre ? __ffs(pre) - 1 : 32;
    const int first_unpub = unpub ? __ffs(unpub) - 1 : 32;
    const bool done = first_pre < first_unpub;
    const int take = done ? first_pre + 1 : first_unpub;
    long long v = lane < take ? (long long)(w & kCount) : 0;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(kFull, v, off);
    before += __shfl_sync(kFull, v, 0);
    if (done) return before;
    if (take == 0) {
      __nanosleep(pause);
      pause = pause < 1024 ? 2 * pause : pause;
    }
    t -= take;
  }
}

// Launch 1: each block takes kCountTiles tiles in ticket order (one 16-byte
// load a thread a tile, all issued before any is used), counts each tile's
// live rows, publishes their sum and looks back once for the live rows
// before its first tile; then tile_before[t] holds the live rows before
// tile t, and the last block writes the live total to tile_before[ntiles].
__global__ void __launch_bounds__(kThreads)
count_kernel(const uint8_t* __restrict__ mask, int64_t n, int ntiles,
             int nsuper, int* ticket, unsigned long long* status,
             long long* __restrict__ tile_before) {
  __shared__ int s_super;
  __shared__ unsigned s_warp[kWarps][kCountTiles];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_super = atomicAdd(ticket, 1);
  __syncthreads();
  const int sup = s_super;
  const int64_t first = (int64_t)sup * kCountTiles;
  uint4 m[kCountTiles];
#pragma unroll
  for (int k = 0; k < kCountTiles; ++k)
    m[k] = load_mask<false>(
        mask, (first + k) * kTile + (int64_t)threadIdx.x * kItems, n);
#pragma unroll
  for (int k = 0; k < kCountTiles; ++k) {
    const unsigned c = __reduce_add_sync(kFull, live_count(m[k]));
    if (lane == 0) s_warp[warp][k] = c;
  }
  __syncthreads();
  if (warp != 0) return;
  unsigned mine = 0;                     // lane k: tile first + k's count
  if (lane < kCountTiles) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mine += s_warp[w][lane];
  }
  unsigned x = mine;
#pragma unroll
  for (int off = 1; off < kCountTiles; off <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  const unsigned total = __shfl_sync(kFull, x, kCountTiles - 1);
  volatile unsigned long long* own = status + sup;
  if (lane == 0) *own = (sup == 0 ? kPre : kAgg) | total;
  const long long before = sup > 0 ? look_back(status, sup, lane) : 0;
  if (lane == 0 && sup > 0)
    *own = kPre | (unsigned long long)(before + total);
  if (lane < kCountTiles && first + lane < ntiles)
    tile_before[first + lane] = before + (x - mine);
  if (lane == 0 && sup == nsuper - 1) tile_before[ntiles] = before + total;
}

// Launch 2 (or the only launch, kOne, where the mask is one tile): each
// block walks the tiles blockIdx.x, + gridDim.x, ..., the next tile's mask
// and base loaded before the current one is ranked, so that a tile's work
// does not wait on its loads. A tile's live rows go from the live rows
// before it, its dead rows from the live total plus the dead rows before
// it; only positions below `limit` are written, and with out_mask the
// mask's value there (mask[order]: live first).
template <bool kOne>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const uint8_t* __restrict__ mask, int64_t n,
               const long long* __restrict__ tile_before, int ntiles,
               int64_t limit, long long* __restrict__ out,
               bool* __restrict__ out_mask) {
  __shared__ unsigned s_warp[kWarps];
  __shared__ uint16_t s_pos[kTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long total = kOne ? 0 : tile_before[ntiles];
  int tile = blockIdx.x;
  uint4 m = load_mask<true>(
      mask, (int64_t)tile * kTile + (int64_t)threadIdx.x * kItems, n);
  long long live_base = kOne ? 0 : tile_before[tile];
  for (;;) {
    const int next = tile + gridDim.x;
    uint4 m_next = make_uint4(0, 0, 0, 0);
    long long base_next = 0;
    if (next < ntiles) {
      m_next = load_mask<true>(
          mask, (int64_t)next * kTile + (int64_t)threadIdx.x * kItems, n);
      base_next = tile_before[next];
    }
    const int64_t start = (int64_t)tile * kTile;
    long long dead_base = total + (start - live_base);
    if (kOne || live_base < limit || dead_base < limit) {   // uniform
      const unsigned c = live_count(m);
      unsigned x = c;                                 // inclusive warp scan
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (lane == 31) s_warp[warp] = x;
      __syncthreads();
      unsigned tile_live = 0, live_rank = x - c;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const unsigned v = s_warp[w];
        live_rank += w < warp ? v : 0;
        tile_live += v;
      }
      if (kOne) dead_base = tile_live;
      const bool dead = dead_base < limit;            // uniform
      // every row before the thread's first lies below n
      unsigned dead_rank = tile_live + threadIdx.x * kItems - live_rank;
      const int rows = (int)(n - start < kTile ? n - start : kTile);
      const unsigned* w = reinterpret_cast<const unsigned*>(&m);
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
        const int local = threadIdx.x * kItems + k;
        if (local < rows) {
          if ((w[k >> 2] >> (8 * (k & 3))) & 1u) s_pos[live_rank++] = local;
          else if (dead) s_pos[dead_rank++] = local;
        }
      }
      __syncthreads();
      const long long room = limit - live_base;
      const int live_end =
          (long long)tile_live < room ? (int)tile_live : (int)(room > 0 ? room : 0);
      for (int j = threadIdx.x; j < live_end; j += kThreads) {
        __stcs(out + live_base + j, start + s_pos[j]);
        if (out_mask != nullptr) out_mask[live_base + j] = true;
      }
      if (dead) {
        const long long dead_room = limit - dead_base + tile_live;
        const int dead_end = (long long)rows < dead_room ? rows : (int)dead_room;
        for (int j = tile_live + threadIdx.x; j < dead_end; j += kThreads) {
          __stcs(out + dead_base + (j - (int)tile_live), start + s_pos[j]);
          if (out_mask != nullptr)
            out_mask[dead_base + (j - (int)tile_live)] = false;
        }
      }
    }
    if (next >= ntiles) break;
    tile = next;
    m = m_next;
    live_base = base_next;
    __syncthreads();                            // s_warp and s_pos are reused
  }
}

}  // namespace

extern "C" {

// scratch: int64 words of ceil(n / kTile) + ceil(n / (kTile *
// kCountTiles)) + 2 (ops/cuda.py partition_scratch_words), unused where
// n <= kTile: the ticket, a status word a count block, then the live rows
// before each tile and the live total. mask 16-byte aligned; out:
// int64[limit], 0 < limit <= n; out_mask: bool[limit] or null; grid: the
// scatter's blocks (at most the tiles).
int qs_stable_partition(const void* mask, int64_t n, int64_t limit,
                        void* scratch, void* out, void* out_mask, int grid,
                        void* stream) {
  if (n == 0 || limit <= 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (ntiles > INT32_MAX / 2 || grid < 1) return cudaErrorInvalidValue;
  if (ntiles == 1) {
    scatter_kernel<true><<<1, kThreads, 0, s>>>(
        (const uint8_t*)mask, n, nullptr, 1, limit, (long long*)out,
        (bool*)out_mask);
    return cudaGetLastError();
  }
  const int64_t nsuper = (ntiles + kCountTiles - 1) / kCountTiles;
  long long* words = (long long*)scratch;
  long long* tile_before = words + 1 + nsuper;
  cudaError_t err = cudaMemsetAsync(words, 0, (nsuper + 1) * 8, s);
  if (err != cudaSuccess) return err;
  count_kernel<<<(unsigned)nsuper, kThreads, 0, s>>>(
      (const uint8_t*)mask, n, (int)ntiles, (int)nsuper, (int*)words,
      (unsigned long long*)(words + 1), tile_before);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  scatter_kernel<false><<<grid < ntiles ? grid : (int)ntiles, kThreads, 0,
                          s>>>(
      (const uint8_t*)mask, n, tile_before, (int)ntiles, limit,
      (long long*)out, (bool*)out_mask);
  return cudaGetLastError();
}

}  // extern "C"
