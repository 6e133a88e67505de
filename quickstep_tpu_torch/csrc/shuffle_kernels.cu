// The mesh path's kernels for Hopper (sm_90a): the radix partition (K14),
// the bucket scatter (K15) and the one-hash bloom filter (K16). Plain C
// interface, loaded with ctypes by quickstep_tpu_torch/ops/cuda.py; every
// function launches on the stream it is given, allocates nothing, and
// returns the cudaError_t of its launches.
//
// K14, qs_partition_count + qs_partition_dest, replaces
// quickstep_tpu/parallel/shuffle.py:36 _partition_of and the ranking of :43
// radix_exchange (:60-91). The reference ranks rows by a stable argsort of
// their partition ids, a searchsorted for the run starts and gathers; a
// stable counting pass needs no sort. Rows are cut into tiles of kTile. The
// count kernel hashes each row's key (K10's hash64, the modulo taken in
// uint64 registers), adds its salt and builds the tile's histogram of the
// n_parts + 1 bins (the last takes the dead rows) in shared memory. A
// cumulative sum over the tiles of each bin (one torch.cumsum over the small
// count matrix) gives each tile's first rank in every bin. The dest kernel
// hashes the tile again and ranks its rows in row order: round by round, each
// warp groups its lanes by bin with __match_any_sync and ranks a lane by the
// __popc of its peers in the lower lanes; per-warp counts in shared memory
// give each warp its offset, and a running count per bin carries the ranks
// from round to round. A row's rank is thus its stable rank in its
// partition, the reference's argsort order, so the buffers match JAX's bit
// for bit. dest = p * cap + rank, or n_parts * cap for a dead row and for a
// live row past the bucket's capacity, which also sets the overflow flag
// (atomicOr). A salted build side addresses row r = s * L + i of the tiled
// input without copying the key or the payload: key and mask are read at
// i = r mod L. What bounds K14 on an H100: the bytes of the key and the mask,
// read twice (once per kernel), and of dest, written once; the hash is a few
// integer multiplies per row, far below the card's integer rate.
//
// K15, qs_scatter_compact, replaces quickstep_tpu/ops/kernels.py:44
// scatter_compact (and the scatter radix_exchange inlines at shuffle.py:96):
// out[dest[i]] = col[i] for dest[i] in [0, capacity), other rows dropped,
// every other slot the fill, which a first kernel writes. Destinations are
// unique, so one thread stores one row with no atomic. Bound by bytes: col
// and dest read once, out written twice (the fill, then the rows). The
// stores land at scattered addresses, one 32-byte sector each where dest is
// not monotone; K14's destinations rise within each bucket, so the stores of
// a warp fall into few sectors.
//
// K16, qs_bloom_build / qs_bloom_probe, replaces quickstep_tpu/ops/bloom.py:41
// bloom_build and :52 bloom_probe, which the shuffle join's LIP filter
// computes (quickstep_tpu/exec/runner.py:1236-1259): slot = hash_combine of
// hash64 of the key columns (K10's hash_row) & (nbits - 1). The reference
// keeps a byte a slot; here the table is one bit a slot in int32 words
// (K3's exact-filter layout), 512 KiB at the shuffle join's largest 2^22
// slots (runner.py:1166), so that the shards' tables OR word by word and
// the probe's table reads hit on chip. The build sets each live row's bit
// by atomicOr after a memset. The probe takes a row a thread and reads its
// word through L1 (__ldg): a table of up to 2^20 slots (128 KiB) mostly
// stays there, and a miss costs a 32-byte L2 sector, so at 2^22 slots the
// L2's random-sector rate (bench/gather_rates.py), not the bytes of the
// keys, mask and result, bounds the probe. Copying the table into shared
// memory (whole, or split over a thread-block cluster) was measured no
// faster in the engine on the H100 (PERF.md).

#include <cstring>

#include "hash_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // rows per block of K14
constexpr int kMaxParts = 1024;

struct PartArgs {
  const void* key;
  int key_is64;
  const bool* alive;
  int64_t L;      // rows of the input
  int salt;
  int tiled;      // build side, salt > 1: row r = s * L + i
  int n_parts;
};

// the partition of (virtual) row r, or n_parts for a dead row
__device__ __forceinline__ int part_of(const PartArgs& a, int64_t r) {
  const int64_t i = a.tiled ? r % a.L : r;
  if (!a.alive[i]) return a.n_parts;
  const unsigned long long k =
      a.key_is64 ? (unsigned long long)static_cast<const long long*>(a.key)[i]
                 : (unsigned long long)(long long)static_cast<const int*>(
                       a.key)[i];
  const int p0 = (int)(qs_mix64(k) % (unsigned long long)a.n_parts);
  int s = 0;
  if (a.salt > 1) s = a.tiled ? (int)(r / a.L) : (int)(r % a.salt);
  return (p0 + s) % a.n_parts;
}

__global__ void __launch_bounds__(kThreads)
part_count_kernel(const PartArgs a, int64_t lx, int n_tiles, int* counts) {
  extern __shared__ int hist[];
  const int nb = a.n_parts + 1;
  for (int b = threadIdx.x; b < nb; b += kThreads) hist[b] = 0;
  __syncthreads();
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int j = threadIdx.x; j < kTile; j += kThreads) {
    const int64_t r = base + j;
    if (r < lx) atomicAdd(&hist[part_of(a, r)], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += kThreads)
    counts[(int64_t)b * n_tiles + blockIdx.x] = hist[b];
}

__global__ void __launch_bounds__(kThreads)
part_dest_kernel(const PartArgs a, int64_t lx, int n_tiles,
                 const int* __restrict__ tile_first, int cap, int* dest,
                 int* overflow) {
  extern __shared__ int sm[];
  const int nb = a.n_parts + 1;
  int* running = sm;        // [nb]: the next rank of each bin
  int* wcnt = sm + nb;      // [kWarps][nb]: this round's count per warp
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int dropped = a.n_parts * cap;
  for (int b = threadIdx.x; b < nb; b += kThreads)
    running[b] = tile_first[(int64_t)b * n_tiles + blockIdx.x];
  const int64_t base = (int64_t)blockIdx.x * kTile;
  for (int round = 0; round < kRounds; ++round) {
    for (int b = threadIdx.x; b < kWarps * nb; b += kThreads) wcnt[b] = 0;
    __syncthreads();
    const int64_t r = base + (int64_t)round * kThreads + threadIdx.x;
    const bool in = r < lx;
    const int p = in ? part_of(a, r) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    const int wrank = __popc(peers & lower);
    if (in && wrank == 0) wcnt[warp * nb + p] = __popc(peers);
    __syncthreads();
    if (in) {
      int rank = running[p] + wrank;
      for (int w = 0; w < warp; ++w) rank += wcnt[w * nb + p];
      if (p == a.n_parts) {
        dest[r] = dropped;
      } else if (rank < cap) {
        dest[r] = p * cap + rank;
      } else {
        dest[r] = dropped;
        atomicOr(overflow, 1);
      }
    }
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += kThreads) {
      int s = 0;
      for (int w = 0; w < kWarps; ++w) s += wcnt[w * nb + b];
      running[b] += s;
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fill_kernel(T* out, int64_t n, T v) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    out[i] = v;
}

template <typename T, typename D>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const T* __restrict__ col, const D* __restrict__ dest,
               int64_t n, int64_t capacity, T* out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t d = (int64_t)dest[i];
    if (d >= 0 && d < capacity) out[d] = col[i];
  }
}

template <typename T>
int scatter_typed(const void* col, const void* dest, int dest_is64,
                  int64_t n, int64_t capacity, unsigned long long fill_bits,
                  void* out, int blocks, cudaStream_t stream) {
  T fill;
  memcpy(&fill, &fill_bits, sizeof(T));
  const int64_t need = (capacity + kThreads - 1) / kThreads;
  const int fill_blocks = need < blocks ? (int)need : blocks;
  if (capacity > 0)
    fill_kernel<T><<<fill_blocks, kThreads, 0, stream>>>((T*)out, capacity,
                                                         fill);
  int err = cudaGetLastError();
  if (err != cudaSuccess || n == 0) return err;
  if (dest_is64)
    scatter_kernel<T, long long><<<blocks, kThreads, 0, stream>>>(
        (const T*)col, (const long long*)dest, n, capacity, (T*)out);
  else
    scatter_kernel<T, int><<<blocks, kThreads, 0, stream>>>(
        (const T*)col, (const int*)dest, n, capacity, (T*)out);
  return cudaGetLastError();
}

// K16's table: one bit a slot, slot s at bit s % 32 of word s / 32 (the
// layout of ops/bloom.py presence_words), at least one word
__global__ void __launch_bounds__(kThreads)
bloom_build_kernel(const Keys keys, const bool* __restrict__ alive, int64_t n,
                   unsigned long long mask, unsigned* words) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    if (alive[i]) {
      const unsigned long long s = hash_row(keys, i) & mask;
      atomicOr(words + (s >> 5), 1u << (s & 31));
    }
}

// out[i] = alive[i] && the bit of row i's slot. A dead row's key is not
// read: the mesh's shard slices hold many dead rows.
__global__ void __launch_bounds__(kThreads)
bloom_probe_kernel(const Keys keys, const bool* __restrict__ alive, int64_t n,
                   const unsigned* __restrict__ words,
                   unsigned long long mask, bool* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    bool hit = false;
    if (alive[i]) {
      const unsigned long long s = hash_row(keys, i) & mask;
      hit = (__ldg(words + (s >> 5)) >> (s & 31)) & 1u;
    }
    out[i] = hit;
  }
}

int part_args(const void* key, int key_is64, const void* alive, int64_t L,
              int salt, int tiled, int n_parts, PartArgs* a) {
  if (n_parts < 1 || n_parts > kMaxParts || salt < 1 || L < 0)
    return cudaErrorInvalidValue;
  a->key = key;
  a->key_is64 = key_is64;
  a->alive = (const bool*)alive;
  a->L = L;
  a->salt = salt;
  a->tiled = tiled && salt > 1;
  a->n_parts = n_parts;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// counts: (n_parts + 1) x n_tiles int32, bin-major; lx = L * salt for a
// tiled build side, else L; n_tiles = ceil(lx / kTile)
int qs_partition_count(const void* key, int key_is64, const void* alive,
                       int64_t L, int salt, int tiled, int n_parts, int64_t lx,
                       int n_tiles, void* counts, void* stream) {
  PartArgs a;
  int err = part_args(key, key_is64, alive, L, salt, tiled, n_parts, &a);
  if (err != cudaSuccess) return err;
  if (lx == 0) return cudaSuccess;
  part_count_kernel<<<n_tiles, kThreads, (n_parts + 1) * sizeof(int),
                      (cudaStream_t)stream>>>(a, lx, n_tiles, (int*)counts);
  return cudaGetLastError();
}

// tile_first: per bin and tile, the ranks of the bin in the earlier tiles
// (the layout of counts); dest: lx int32; overflow: one int32, 0
int qs_partition_dest(const void* key, int key_is64, const void* alive,
                      int64_t L, int salt, int tiled, int n_parts, int64_t lx,
                      int n_tiles, const void* tile_first, int cap, void* dest,
                      void* overflow, void* stream) {
  PartArgs a;
  int err = part_args(key, key_is64, alive, L, salt, tiled, n_parts, &a);
  if (err != cudaSuccess) return err;
  if (cap < 1 || (int64_t)n_parts * cap >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (lx == 0) return cudaSuccess;
  part_dest_kernel<<<n_tiles, kThreads,
                     (1 + kWarps) * (n_parts + 1) * sizeof(int),
                     (cudaStream_t)stream>>>(a, lx, n_tiles,
                                             (const int*)tile_first, cap,
                                             (int*)dest, (int*)overflow);
  return cudaGetLastError();
}

int qs_scatter_compact(int width, const void* col, const void* dest,
                       int dest_is64, int64_t n, int64_t capacity,
                       unsigned long long fill_bits, void* out, int blocks,
                       void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (width) {
    case 1:
      return scatter_typed<uint8_t>(col, dest, dest_is64, n, capacity,
                                    fill_bits, out, blocks, s);
    case 2:
      return scatter_typed<uint16_t>(col, dest, dest_is64, n, capacity,
                                     fill_bits, out, blocks, s);
    case 4:
      return scatter_typed<uint32_t>(col, dest, dest_is64, n, capacity,
                                     fill_bits, out, blocks, s);
    case 8:
      return scatter_typed<unsigned long long>(col, dest, dest_is64, n,
                                               capacity, fill_bits, out,
                                               blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// words: max(1, nbits / 32) int32 words (nbits a power of two), cleared
// here before the build
int qs_bloom_build(int ncols, const void* const* cols, const int* dtypes,
                   const void* alive, int64_t n, void* words, int64_t nbits,
                   int blocks, void* stream) {
  Keys keys;
  int err = make_keys(ncols, cols, dtypes, &keys);
  if (err != cudaSuccess) return err;
  if (nbits < 1 || (nbits & (nbits - 1)) != 0) return cudaErrorInvalidValue;
  const int64_t nwords = nbits < 32 ? 1 : nbits / 32;
  err = cudaMemsetAsync(words, 0, (size_t)nwords * sizeof(unsigned),
                        (cudaStream_t)stream);
  if (err != cudaSuccess || n == 0) return err;
  bloom_build_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, (const bool*)alive, n, (unsigned long long)(nbits - 1),
      (unsigned*)words);
  return cudaGetLastError();
}

// words as qs_bloom_build writes them
int qs_bloom_probe(int ncols, const void* const* cols, const int* dtypes,
                   const void* alive, int64_t n, const void* words,
                   int64_t nbits, void* out, int blocks, void* stream) {
  Keys keys;
  int err = make_keys(ncols, cols, dtypes, &keys);
  if (err != cudaSuccess) return err;
  if (nbits < 1 || (nbits & (nbits - 1)) != 0) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  bloom_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, (const bool*)alive, n, (const unsigned*)words,
      (unsigned long long)(nbits - 1), (bool*)out);
  return cudaGetLastError();
}

}  // extern "C"
