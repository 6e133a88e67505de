// Compaction kernel for Hopper (sm_90a): the stable live-first partition of
// row positions (K9). Plain C interface, loaded with ctypes by
// quickstep_tpu_torch/ops/cuda.py; the function launches on the stream it is
// given, allocates nothing, and returns the cudaError_t of its launches.
//
// qs_stable_partition replaces the compaction inside
// quickstep_tpu/ops/groupby.py:405 sort_groupby_compact, that is
// ops/kernels.py:132 compact_order (the TPU's payload-carrying stable sort of
// the dead mask) and :35 compact_indices (the cumsum destinations). Its
// result is the permutation torch.argsort(~mask, stable=True): the positions
// of the live rows in order, then those of the dead rows in order.
//
// What bounds it on an H100: bytes. It reads the 1-byte mask twice and
// writes one 8-byte position per row, with no sort. Three launches: each
// block counts the live rows of its tile of kTile positions; one block scans
// the tile counts into tile offsets (the live total last); each block walks
// its tile again in kItems rounds of kThreads consecutive positions, ranks
// the live rows of a round by warp ballots and a scan of the 8 warp counts in
// shared memory, and writes every position to its place: live rows from the
// tile's live offset, dead rows from the live total plus the tile's dead
// offset. Reads and the ballots are coalesced; the writes of one round go to
// two runs of consecutive addresses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;
constexpr int64_t kTile = (int64_t)kThreads * kItems;
constexpr int kScanThreads = 1024;

__global__ void __launch_bounds__(kThreads)
count_tiles_kernel(const uint8_t* __restrict__ mask, int64_t n,
                   int* __restrict__ tile_counts) {
  __shared__ int warp_sums[kWarps];
  const int64_t start = (int64_t)blockIdx.x * kTile;
  int mine = 0;
  for (int j = 0; j < kItems; ++j) {
    const int64_t p = start + (int64_t)j * kThreads + threadIdx.x;
    mine += (p < n && mask[p]) ? 1 : 0;
  }
  for (int off = 16; off > 0; off >>= 1)
    mine += __shfl_down_sync(0xffffffffu, mine, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = mine;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
    tile_counts[blockIdx.x] = total;
  }
}

// One block: tile_offsets[t] = sum of tile_counts[0, t), and
// tile_offsets[ntiles] = the live total.
__global__ void __launch_bounds__(kScanThreads)
scan_tiles_kernel(const int* __restrict__ tile_counts, int64_t ntiles,
                  long long* __restrict__ tile_offsets) {
  __shared__ long long buf[kScanThreads];
  __shared__ long long carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < ntiles; base += kScanThreads) {
    const int64_t t = base + threadIdx.x;
    const long long v = t < ntiles ? tile_counts[t] : 0;
    buf[threadIdx.x] = v;
    __syncthreads();
    // Hillis-Steele inclusive scan over the chunk
    for (int off = 1; off < kScanThreads; off <<= 1) {
      const long long add = threadIdx.x >= off ? buf[threadIdx.x - off] : 0;
      __syncthreads();
      buf[threadIdx.x] += add;
      __syncthreads();
    }
    if (t < ntiles) tile_offsets[t] = carry + buf[threadIdx.x] - v;
    __syncthreads();
    if (threadIdx.x == kScanThreads - 1) carry += buf[threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.x == 0) tile_offsets[ntiles] = carry;
}

__global__ void __launch_bounds__(kThreads)
scatter_tiles_kernel(const uint8_t* __restrict__ mask, int64_t n,
                     const long long* __restrict__ tile_offsets,
                     int64_t ntiles, long long* __restrict__ out) {
  __shared__ int warp_live[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t start = (int64_t)blockIdx.x * kTile;
  const long long total_live = tile_offsets[ntiles];
  long long live_next = tile_offsets[blockIdx.x];
  long long dead_next = total_live + (start - tile_offsets[blockIdx.x]);
  const unsigned lanes_below = (1u << lane) - 1u;
  for (int j = 0; j < kItems; ++j) {
    const int64_t round = start + (int64_t)j * kThreads;
    if (round >= n) break;                      // uniform across the block
    const int64_t p = round + threadIdx.x;
    const bool valid = p < n;
    const bool live = valid && mask[p];
    const unsigned ballot = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = __popc(ballot);
    __syncthreads();
    int live_before = __popc(ballot & lanes_below);
    int round_live = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_live[w];
      live_before += w < warp ? c : 0;
      round_live += c;
    }
    if (live) {
      out[live_next + live_before] = p;
    } else if (valid) {
      // every position before p in this round is valid
      out[dead_next + (threadIdx.x - live_before)] = p;
    }
    const int64_t round_valid = n - round < kThreads ? n - round : kThreads;
    live_next += round_live;
    dead_next += round_valid - round_live;
    __syncthreads();                            // warp_live is reused
  }
}

}  // namespace

extern "C" {

// tile_counts: int32 scratch of ceil(n / 4096) entries; tile_offsets: int64
// scratch of one more; out: int64[n].
int qs_stable_partition(const void* mask, int64_t n, void* tile_counts,
                        void* tile_offsets, void* out, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (ntiles > INT32_MAX) return cudaErrorInvalidValue;
  count_tiles_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const uint8_t*)mask, n, (int*)tile_counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_tiles_kernel<<<1, kScanThreads, 0, s>>>(
      (const int*)tile_counts, ntiles, (long long*)tile_offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_tiles_kernel<<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const uint8_t*)mask, n, (const long long*)tile_offsets, ntiles,
      (long long*)out);
  return cudaGetLastError();
}

}  // extern "C"
