// The mesh path's kernels for Hopper (sm_90a): the radix partition (K14),
// the bucket scatter (K15) and the one-hash bloom filter (K16). Plain C
// interface, loaded with ctypes by quickstep_tpu_torch/ops/cuda.py; every
// function launches on the stream it is given, allocates nothing, and
// returns the cudaError_t of its launches.
//
// K14 replaces quickstep_tpu/parallel/shuffle.py:36 _partition_of and the
// ranking of :43 radix_exchange (:60-91): each row's slot p * cap + its
// stable rank among the live rows of its partition p (the reference's
// stable argsort), n_parts * cap for a dead row and for a live row past its
// bucket's capacity; and, for K15, each bucket's occupied count min(live
// rows of p, cap) and the 0-d bool overflow (some bucket had more live rows
// than cap). What bounds it on an H100: the bytes of the key and the mask,
// read once, and of dest, written once (0.029 ms at 7.5 M int64 keys).
// - No division per row. p = (hash64(key) + salt) mod n_parts is a mask for
//   a power of two, else a multiply-high by a reciprocal the host computes
//   (Divisor, part_of). A salted row's salt, and a salted build side's
//   source row i of row r = s * L + i, come from one multiply-high at a
//   thread's first row and increments after it (RowWalk).
// - qs_partition_sweep, up to kSweepParts = 255 partitions (256 bins with
//   the dead rows'): one onesweep launch. Tiles of kTile rows are taken in
//   ticket order; each thread loads its 16 rows (a warp's 512 consecutive
//   rows, 32 a round: coalesced, any start offset), in two parts whose
//   loads are all issued before any is used, hashes each once, and ranks
//   them stably within its warp by kBits ballots a round (radix_device.cuh
//   warp_ranks). Thread b publishes bin b's count in the tile and finds the
//   bin's rows in the earlier tiles by a decoupled look-back
//   (radix_device.cuh look_back, a tile's words n_parts apart): bucket p's
//   base is fixed at p * cap, so no histogram pass comes first. dest is
//   written once, a warp round's 32 rows together. The tile that takes the
//   last ticket knows every bin's total after its look-back and writes the
//   counts and the overflow flag: no atomic per row, no memset, no pass
//   after it. The look-back state (a 64-bit ticket and a status word a tile
//   and bin) is never cleared: each call's words carry the call's tag above
//   their count (older tags read as not yet published), and the ticket
//   keeps counting (a tile is its ticket less the count before the
//   launch); the wrapper keeps one state a stream and passes both. What
//   holds it above its bound on the H100 is latency, not bytes: a tile's
//   ticket, loads, ranks and look-back follow one another in each block,
//   three blocks an SM (at most 85 registers a thread), and a tile's
//   look-back waits for the counts of the tiles just before it.
// - More partitions (up to kMaxParts): two launches, qs_partition_count (a
//   tile's histogram in shared memory) and qs_partition_dest (rounds of 256
//   rows ranked by __match_any_sync), with one torch.cumsum of the tiles'
//   counts between them; the last tile writes the counts and the overflow.
//
// K15 replaces quickstep_tpu/ops/kernels.py:44 scatter_compact and the
// scatter radix_exchange inlines at shuffle.py:96. Two routes:
// - qs_bucket_rows, the shuffle's route for K14's destinations (and
//   counts): in one launch it writes the gather index of every slot (the
//   row's id mod L in an occupied slot, 0 in an empty one) and the occupied
//   mask, each slot once. Bucket p's occupied slots are [p * cap, p * cap +
//   count_p): every block writes its share of the mask from the counts
//   alone and the index's 0 into the empty tails only; each block also
//   takes a tile of dest, whose rows of one bucket land on consecutive
//   slots (stable ranks), stages them in shared memory in slot order
//   (each bucket's first slot and rows in the tile by one ballot group a
//   warp round) and stores each bucket's run whole. Bound by bytes: dest
//   read once, 5 bytes a slot written once (0.031 ms at 7.5 M rows into
//   15 M slots).
// - qs_scatter_compact, for any unique dest: out[dest[i]] = col[i] for
//   dest[i] in [0, capacity), other rows dropped, every other slot the
//   fill, which a first kernel writes. Bound by bytes: col and dest read
//   once, out written twice (the fill, then the rows).
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

#include <climits>
#include <cstring>

#include "hash_device.cuh"
#include "radix_device.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRounds = 16;
constexpr int kTile = kThreads * kRounds;  // rows a tile of K14 and K15
constexpr int kWarpRows = 32 * kRounds;    // a warp's rows of a tile
constexpr int kMaxParts = 1024;
constexpr int kSweepParts = 255;           // K14's one-launch route

// Division by a runtime divisor d with no divide instruction (Lemire, Kaser
// and Kurz, "Faster remainder by direct computation", 2019): with m =
// ceil(2^64 / d) = (2^64 + e) / d, 0 <= e < d, for every x with x e < 2^64,
// x / d = floor(m x / 2^64) and x mod d = floor((m x mod 2^64) d / 2^64).
// The host computes m (ops/cuda.py reciprocal); d = 1 is taken apart (m
// would be 2^64).
struct Divisor {
  unsigned long long m;
  unsigned d;
};

// x / d for x < 2^32 (x e < 2^64)
__device__ __forceinline__ unsigned div_by(unsigned x, const Divisor& v) {
  return v.d == 1 ? x : (unsigned)__umul64hi(v.m, (unsigned long long)x);
}

struct PartArgs {
  const void* key;
  const bool* alive;
  int key_is64;
  int tiled;                  // build side, salt > 1: row r = s * L + i
  int n_parts;
  int pow2;                   // n_parts a power of two: the hash is masked
  unsigned long long part_m;  // else ceil(2^64 / n_parts)
  unsigned part_c;            // and 2^32 mod n_parts
  Divisor walk;               // L (tiled), else the salt (1: unsalted)
};

// (hash + s) mod n_parts. With h = hi 2^32 + lo, h = hi (2^32 mod n) + lo
// (mod n), and x = hi (2^32 mod n) + lo + s < 2^43 for n <= 1024 and s <
// 2^31, so x e < 2^53: one multiply-high takes x mod n.
__device__ __forceinline__ unsigned part_of(const PartArgs& a,
                                            unsigned long long h,
                                            unsigned s) {
  if (a.pow2) return (unsigned)((h + s) & (unsigned long long)(a.n_parts - 1));
  const unsigned long long x =
      (h >> 32) * a.part_c + (h & 0xffffffffull) + s;
  return (unsigned)__umul64hi(a.part_m * x, (unsigned long long)a.n_parts);
}

// A thread's rows r, r + step, ...: q = r / d and m = r mod d of the walk's
// divisor, from one multiply-high at the first row and increments after
// it. A tiled build side reads source row i = m with salt s = q; a probe
// side reads i = r with salt s = m (0 unsalted).
struct RowWalk {
  unsigned r, q, m, dq, dm;
  __device__ __forceinline__ RowWalk(const Divisor& v, unsigned r0,
                                     unsigned step) {
    r = r0;
    q = div_by(r0, v);
    m = r0 - q * v.d;
    dq = div_by(step, v);
    dm = step - dq * v.d;
  }
  __device__ __forceinline__ void next(const Divisor& v, unsigned step) {
    r += step;
    q += dq;
    m += dm;
    if (m >= v.d) {
      m -= v.d;
      ++q;
    }
  }
  __device__ __forceinline__ unsigned row(const PartArgs& a) const {
    return a.tiled ? m : r;
  }
  __device__ __forceinline__ unsigned salt(const PartArgs& a) const {
    return a.tiled ? q : m;
  }
};

__device__ __forceinline__ unsigned long long key_at(const PartArgs& a,
                                                     unsigned i) {
  return a.key_is64
             ? (unsigned long long)__ldg(static_cast<const long long*>(a.key) + i)
             : (unsigned long long)(long long)__ldg(
                   static_cast<const int*>(a.key) + i);
}

// the partition of the walk's current row, or n_parts for a dead row
__device__ __forceinline__ unsigned bin_of(const PartArgs& a,
                                           const RowWalk& w) {
  const unsigned i = w.row(a);
  return a.alive[i] ? part_of(a, qs_mix64(key_at(a, i)), w.salt(a))
                    : (unsigned)a.n_parts;
}

// The bits of a bin id in K14's and K15's ballots: 2^bits - 1 > every
// partition, so that all ones marks a row without a bin.
inline int bin_bits(int n_parts) {
  return n_parts <= 3 ? 2 : n_parts <= 15 ? 4 : n_parts <= 255 ? 8 : 11;
}

// The lanes of the warp whose v equals this lane's, by one ballot a bit.
template <int kBits>
__device__ __forceinline__ unsigned peers_of(unsigned v) {
  unsigned peers = 0xffffffffu;
#pragma unroll
  for (int bit = 0; bit < kBits; ++bit) {
    const bool set = (v >> bit) & 1u;
    const unsigned vote = __ballot_sync(0xffffffffu, set);
    peers &= set ? vote : ~vote;
  }
  return peers;
}

// K14's one-launch state: the ticket (every launch adds its tiles, from
// `base`) and the status words, a tile's n_parts words in a row; a word is
// (tag << 32) | count, agg_tag over the tile's own rows of the bin,
// pre_tag over the rows up to the tile's end.
struct Sweep {
  unsigned long long* ticket;
  unsigned long long* status;
  unsigned long long base;
  unsigned long long agg_tag, pre_tag;
};

template <int kBits>
__global__ void __launch_bounds__(kThreads, 3)
part_sweep_kernel(const PartArgs a, int lx, int n_tiles, const Sweep sw,
                  int cap, int* __restrict__ dest, int* __restrict__ counts,
                  bool* __restrict__ overflow) {
  constexpr unsigned kNone = (1u << kBits) - 1u;
  __shared__ unsigned warp_count[kWarps][1 << kBits];
  __shared__ unsigned tile_before[1 << kBits];
  __shared__ int tile_sh;
  __shared__ int over_sh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int np = a.n_parts;
  if (threadIdx.x == 0) {
    tile_sh = (int)(atomicAdd(sw.ticket, 1ull) - sw.base);
    over_sh = 0;
  }
  for (int b = lane; b < np; b += 32) warp_count[warp][b] = 0;
  __syncthreads();
  const int tile = tile_sh;
  const unsigned r0 = (unsigned)tile * kTile + warp * kWarpRows + lane;

  // the loads of the rows, then their hashes, in two parts of kPart rounds
  // (every load of a part issued before any is used; a part's keys alone
  // are held, so that three blocks fit an SM), then the ranks
  constexpr int kPart = kRounds / 2;
  unsigned dg[kRounds];
  RowWalk w(a.walk, r0, 32);
#pragma unroll
  for (int h = 0; h < kRounds; h += kPart) {
    unsigned long long key[kPart];
    bool live[kPart];
    unsigned salt[kPart];
#pragma unroll
    for (int j = 0; j < kPart; ++j) {
      const unsigned i = w.row(a);
      live[j] = w.r < (unsigned)lx && a.alive[i];
      key[j] = w.r < (unsigned)lx ? key_at(a, i) : 0ull;
      salt[j] = w.salt(a);
      w.next(a.walk, 32);
    }
#pragma unroll
    for (int j = 0; j < kPart; ++j)
      dg[h + j] = live[j] ? part_of(a, qs_mix64(key[j]), salt[j]) : kNone;
  }
  unsigned rank[kRounds];
#pragma unroll
  for (int h = 0; h < kRounds; h += kPart) {
    unsigned part_dg[kPart], part_rank[kPart];
#pragma unroll
    for (int j = 0; j < kPart; ++j) part_dg[j] = dg[h + j];
    radix::warp_ranks<kPart, kBits>(part_dg, warp_count[warp], lane,
                                    part_rank, (unsigned)np);
#pragma unroll
    for (int j = 0; j < kPart; ++j) rank[h + j] = part_rank[j];
  }
  __syncthreads();

  // thread b: bin b's count in the tile, published, then its rows in the
  // earlier tiles; warp_count[v][b] becomes the rows of bin b in the tile's
  // warps before v
  const int b = threadIdx.x;
  if (b < np) {
    unsigned total = 0;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) {
      const unsigned c = warp_count[v][b];
      warp_count[v][b] = total;
      total += c;
    }
    volatile unsigned long long* own = sw.status + (int64_t)tile * np + b;
    *own = ((tile == 0 ? sw.pre_tag : sw.agg_tag) << 32) | total;
    long long before = 0;
    if (tile > 0) {
      before = radix::look_back(sw.status, tile, b, sw.agg_tag, sw.pre_tag,
                                np);
      *own = (sw.pre_tag << 32) | (unsigned long long)(before + total);
    }
    tile_before[b] = (unsigned)before;
    if (tile == n_tiles - 1) {        // the bins' totals: counts and flag
      const long long all = before + total;
      counts[b] = all < cap ? (int)all : cap;
      if (all > cap) over_sh = 1;
    }
  }
  __syncthreads();
  if (tile == n_tiles - 1 && threadIdx.x == 0) *overflow = over_sh != 0;
  const int dropped = np * cap;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const unsigned r = r0 + j * 32;
    if (r < (unsigned)lx) {
      int d = dropped;
      if (dg[j] != kNone) {
        const unsigned rk =
            tile_before[dg[j]] + warp_count[warp][dg[j]] + rank[j];
        if (rk < (unsigned)cap) d = (int)(dg[j] * cap + rk);
      }
      dest[r] = d;
    }
  }
}

// More than kSweepParts partitions, launch 1: each tile's histogram of the
// n_parts + 1 bins (the last the dead rows') in shared memory.
__global__ void __launch_bounds__(kThreads)
part_count_kernel(const PartArgs a, int lx, int n_tiles, int* counts) {
  extern __shared__ int hist[];
  const int nb = a.n_parts + 1;
  for (int b = threadIdx.x; b < nb; b += kThreads) hist[b] = 0;
  __syncthreads();
  RowWalk w(a.walk, (unsigned)blockIdx.x * kTile + threadIdx.x, kThreads);
  for (int j = 0; j < kRounds; ++j, w.next(a.walk, kThreads))
    if (w.r < (unsigned)lx) atomicAdd(&hist[bin_of(a, w)], 1);
  __syncthreads();
  for (int b = threadIdx.x; b < nb; b += kThreads)
    counts[(int64_t)b * n_tiles + blockIdx.x] = hist[b];
}

// Launch 2: the tile's rows ranked in row order, 256 a round (each warp
// groups its lanes by bin with __match_any_sync, per-warp counts give
// each warp its offset, a running count per bin carries the ranks from
// round to round) from tile_first, each bin's rows in the earlier tiles.
// The last tile's running counts are the bins' totals: it writes the
// counts and the overflow flag.
__global__ void __launch_bounds__(kThreads)
part_dest_kernel(const PartArgs a, int lx, int n_tiles,
                 const int* __restrict__ tile_first, int cap, int* dest,
                 int* counts, bool* overflow) {
  extern __shared__ int sm[];
  const int np = a.n_parts;
  const int nb = np + 1;
  int* running = sm;        // [nb]: the next rank of each bin
  int* wcnt = sm + nb;      // [kWarps][nb]: this round's count per warp
  int* over = wcnt + kWarps * nb;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int dropped = np * cap;
  for (int b = threadIdx.x; b < nb; b += kThreads)
    running[b] = tile_first[(int64_t)b * n_tiles + blockIdx.x];
  if (threadIdx.x == 0) *over = 0;
  RowWalk w(a.walk, (unsigned)blockIdx.x * kTile + threadIdx.x, kThreads);
  for (int round = 0; round < kRounds; ++round, w.next(a.walk, kThreads)) {
    for (int b = threadIdx.x; b < kWarps * nb; b += kThreads) wcnt[b] = 0;
    __syncthreads();
    const bool in = w.r < (unsigned)lx;
    const int p = in ? (int)bin_of(a, w) : -1;
    const unsigned peers = __match_any_sync(0xffffffffu, p);
    const int wrank = __popc(peers & lower);
    if (in && wrank == 0) wcnt[warp * nb + p] = __popc(peers);
    __syncthreads();
    if (in) {
      int rank = running[p] + wrank;
      for (int v = 0; v < warp; ++v) rank += wcnt[v * nb + p];
      dest[w.r] = p < np && rank < cap ? p * cap + rank : dropped;
    }
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += kThreads) {
      int s = 0;
      for (int v = 0; v < kWarps; ++v) s += wcnt[v * nb + b];
      running[b] += s;
    }
    __syncthreads();
  }
  if (blockIdx.x != n_tiles - 1) return;
  for (int b = threadIdx.x; b < np; b += kThreads) {
    counts[b] = running[b] < cap ? running[b] : cap;
    if (running[b] > cap) *over = 1;
  }
  __syncthreads();
  if (threadIdx.x == 0) *overflow = *over != 0;
}

// K15's route for K14's destinations, in one launch. Every block writes its
// share of the slots, four a thread: the occupied mask (slot k of bucket p
// = k / cap is occupied below p * cap + counts[p]) and a 0 in the index of
// each empty slot. Block t < n_tiles also takes tile t of dest: its rows'
// slots (issued before the share), each bucket's first slot and number of
// rows in the tile (a warp round's rows of a bucket grouped by ballots,
// the group's first lane adding them), and so each row's place in the
// tile's rows in slot order; the rows' ids mod L are staged there and
// stored in slot order, each bucket's run whole.
template <int kBits>
__global__ void __launch_bounds__(kThreads, 4)
bucket_rows_kernel(const int* __restrict__ dest, int lx, int tiled,
                   const Divisor rows, int n_parts, int cap,
                   const Divisor cap_d, const int* __restrict__ counts,
                   int n_tiles, int* __restrict__ idx, bool* __restrict__ occ) {
  constexpr unsigned kNone = (1u << kBits) - 1u;
  constexpr int kBins = kBits > 10 ? kMaxParts : (1 << kBits);
  __shared__ int shift[kBins];          // first the bucket's first slot
  __shared__ unsigned cnt[kBins];
  __shared__ int stage_slot[kTile];
  __shared__ int stage_row[kTile];
  __shared__ unsigned warp_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int64_t slots = (int64_t)n_parts * cap;
  const unsigned r0 = (unsigned)tile * kTile + warp * kWarpRows + lane;
  int d[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const unsigned r = r0 + j * 32;
    d[j] = tile < n_tiles && r < (unsigned)lx ? __ldg(dest + r) : -1;
  }
  for (int p = threadIdx.x; p < n_parts; p += kThreads) {
    shift[p] = INT_MAX;
    cnt[p] = 0;
  }

  // the share of the slots: the mask everywhere, the index's 0 in the tails
  const int64_t stride = (int64_t)gridDim.x * kThreads * 4;
  for (int64_t k0 = ((int64_t)blockIdx.x * kThreads + threadIdx.x) * 4;
       k0 < slots; k0 += stride) {
    unsigned bytes = 0, empty = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const unsigned k = (unsigned)k0 + e;
      const unsigned p = div_by(k, cap_d);
      if (k0 + e < slots && (int)(k - p * cap) < __ldg(counts + p))
        bytes |= 1u << (8 * e);
      else
        empty |= 1u << e;
    }
    if (k0 + 4 <= slots) {
      *reinterpret_cast<unsigned*>(occ + k0) = bytes;
      if (empty == 0xfu)
        *reinterpret_cast<int4*>(idx + k0) = make_int4(0, 0, 0, 0);
      else
        for (int e = 0; e < 4; ++e)
          if ((empty >> e) & 1u) idx[k0 + e] = 0;
    } else {
      for (int e = 0; k0 + e < slots; ++e) {
        occ[k0 + e] = (bytes >> (8 * e)) & 1u;
        if ((empty >> e) & 1u) idx[k0 + e] = 0;
      }
    }
  }
  __syncthreads();
  if (tile >= n_tiles) return;

  unsigned pb[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j)
    pb[j] = d[j] >= 0 && d[j] < slots ? div_by((unsigned)d[j], cap_d) : kNone;
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    // a bucket's rows in a round have consecutive slots rising with the
    // lane: the group's first lane holds its first slot
    const unsigned peers = peers_of<kBits>(pb[j]);
    if (pb[j] != kNone && lane == __ffs(peers) - 1) {
      atomicMin(&shift[pb[j]], d[j]);
      atomicAdd(&cnt[pb[j]], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  // each bucket's first place in the tile (an exclusive scan of cnt over
  // the buckets, a few a thread); shift = that place less its first slot
  const int per = (n_parts + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  unsigned mine = 0;
  for (int e = 0; e < per && lo + e < n_parts; ++e) mine += cnt[lo + e];
  unsigned x = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  unsigned run = x - mine, kept = 0;
#pragma unroll
  for (int v = 0; v < kWarps; ++v) {
    run += v < warp ? warp_sum[v] : 0u;
    kept += warp_sum[v];
  }
  for (int e = 0; e < per && lo + e < n_parts; ++e) {
    const int p = lo + e;
    shift[p] = (int)run - shift[p];
    run += cnt[p];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    if (pb[j] == kNone) continue;
    const int64_t at = (int64_t)d[j] + shift[pb[j]];
    if (at < 0 || at >= (int64_t)kept) continue;   // not K14's dest
    const unsigned r = r0 + j * 32;
    stage_slot[at] = d[j];
    stage_row[at] = tiled ? (int)(r - div_by(r, rows) * rows.d) : (int)r;
  }
  __syncthreads();
  for (int q = threadIdx.x; q < (int)kept; q += kThreads)
    idx[stage_slot[q]] = stage_row[q];
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

int part_args(const void* key, int key_is64, const void* alive, int tiled,
              int n_parts, unsigned long long part_m, unsigned part_c,
              unsigned walk_d, unsigned long long walk_m, PartArgs* a) {
  const int pow2 = n_parts > 0 && (n_parts & (n_parts - 1)) == 0;
  if (n_parts < 1 || n_parts > kMaxParts || walk_d < 1 ||
      (!pow2 && (part_m == 0 || part_c >= (unsigned)n_parts)) ||
      (walk_d > 1 && walk_m == 0))
    return cudaErrorInvalidValue;
  a->key = key;
  a->alive = (const bool*)alive;
  a->key_is64 = key_is64;
  a->tiled = tiled;
  a->n_parts = n_parts;
  a->pow2 = pow2;
  a->part_m = part_m;
  a->part_c = part_c;
  a->walk.m = walk_m;
  a->walk.d = walk_d;
  return cudaSuccess;
}

template <int kBits>
int sweep_launch(const PartArgs& a, int lx, int n_tiles, const Sweep& sw,
                 int cap, void* dest, void* counts, void* overflow,
                 cudaStream_t s) {
  part_sweep_kernel<kBits><<<n_tiles, kThreads, 0, s>>>(
      a, lx, n_tiles, sw, cap, (int*)dest, (int*)counts, (bool*)overflow);
  return cudaGetLastError();
}

template <int kBits>
int bucket_launch(const void* dest, int lx, int tiled, Divisor rows,
                  int n_parts, int cap, Divisor cap_d, const void* counts,
                  int n_tiles, void* idx, void* occ, int grid,
                  cudaStream_t s) {
  bucket_rows_kernel<kBits><<<grid, kThreads, 0, s>>>(
      (const int*)dest, lx, tiled, rows, n_parts, cap, cap_d,
      (const int*)counts, n_tiles, (int*)idx, (bool*)occ);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K14 in one launch, n_parts <= kSweepParts. part_m, part_c: ops/cuda.py
// mod_constants(n_parts); walk_d, walk_m: L (tiled) or the salt and its
// reciprocal; lx = L * salt tiled, else L, 0 < lx < 2^31; dest: lx int32;
// counts: n_parts int32; overflow: one bool. state: the ticket, then at
// least ceil(lx / kTile) * n_parts status words, whose tags are below tag
// (zeros at first); base: the ticket's count before this launch (it adds
// ceil(lx / kTile)); 0 < tag < 2^31 - 1.
int qs_partition_sweep(const void* key, int key_is64, const void* alive,
                       int tiled, int n_parts, unsigned long long part_m,
                       unsigned part_c, unsigned walk_d,
                       unsigned long long walk_m, int64_t lx, int cap,
                       void* dest, void* counts, void* overflow, void* state,
                       unsigned long long base, unsigned tag, void* stream) {
  PartArgs a;
  int err = part_args(key, key_is64, alive, tiled, n_parts, part_m, part_c,
                      walk_d, walk_m, &a);
  if (err != cudaSuccess) return err;
  if (n_parts > kSweepParts || cap < 1 ||
      (int64_t)n_parts * cap >= (1LL << 31) || lx < 1 || lx >= (1LL << 31) ||
      tag < 1 || tag >= 0x7fffffffu)
    return cudaErrorInvalidValue;
  const int n_tiles = (int)((lx + kTile - 1) / kTile);
  Sweep sw;
  sw.ticket = (unsigned long long*)state;
  sw.status = sw.ticket + 1;
  sw.base = base;
  sw.agg_tag = 2ull * tag + 1;
  sw.pre_tag = 2ull * tag + 2;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bin_bits(n_parts)) {
    case 2:
      return sweep_launch<2>(a, (int)lx, n_tiles, sw, cap, dest, counts,
                             overflow, s);
    case 4:
      return sweep_launch<4>(a, (int)lx, n_tiles, sw, cap, dest, counts,
                             overflow, s);
    default:
      return sweep_launch<8>(a, (int)lx, n_tiles, sw, cap, dest, counts,
                             overflow, s);
  }
}

// K14's two launches (any n_parts up to kMaxParts). counts: (n_parts + 1)
// x n_tiles int32, bin-major; n_tiles = ceil(lx / kTile)
int qs_partition_count(const void* key, int key_is64, const void* alive,
                       int tiled, int n_parts, unsigned long long part_m,
                       unsigned part_c, unsigned walk_d,
                       unsigned long long walk_m, int64_t lx, int n_tiles,
                       void* counts, void* stream) {
  PartArgs a;
  int err = part_args(key, key_is64, alive, tiled, n_parts, part_m, part_c,
                      walk_d, walk_m, &a);
  if (err != cudaSuccess) return err;
  if (lx < 0 || lx >= (1LL << 31)) return cudaErrorInvalidValue;
  if (lx == 0) return cudaSuccess;
  part_count_kernel<<<n_tiles, kThreads, (n_parts + 1) * sizeof(int),
                      (cudaStream_t)stream>>>(a, (int)lx, n_tiles,
                                              (int*)counts);
  return cudaGetLastError();
}

// tile_first: per bin and tile, the ranks of the bin in the earlier tiles
// (the layout of counts); dest: lx int32; out_counts: n_parts int32;
// overflow: one bool
int qs_partition_dest(const void* key, int key_is64, const void* alive,
                      int tiled, int n_parts, unsigned long long part_m,
                      unsigned part_c, unsigned walk_d,
                      unsigned long long walk_m, int64_t lx, int n_tiles,
                      const void* tile_first, int cap, void* dest,
                      void* out_counts, void* overflow, void* stream) {
  PartArgs a;
  int err = part_args(key, key_is64, alive, tiled, n_parts, part_m, part_c,
                      walk_d, walk_m, &a);
  if (err != cudaSuccess) return err;
  if (cap < 1 || (int64_t)n_parts * cap >= (1LL << 31) || lx < 0 ||
      lx >= (1LL << 31))
    return cudaErrorInvalidValue;
  if (lx == 0) return cudaSuccess;
  part_dest_kernel<<<n_tiles, kThreads,
                     ((1 + kWarps) * (n_parts + 1) + 1) * sizeof(int),
                     (cudaStream_t)stream>>>(
      a, (int)lx, n_tiles, (const int*)tile_first, cap, (int*)dest,
      (int*)out_counts, (bool*)overflow);
  return cudaGetLastError();
}

// K15's route for K14's dest (lx int32, each live row's slot rising with its
// row within its bucket) and counts (n_parts int32): idx (n_parts * cap
// int32) and occ (as many bools). tiled: a salted build side, lx = L *
// salt, whose row r is row r mod L (rows_d = L, rows_m its reciprocal);
// cap_m: cap's reciprocal; grid >= ceil(lx / kTile).
int qs_bucket_rows(const void* dest, int64_t lx, int tiled, unsigned rows_d,
                   unsigned long long rows_m, int n_parts, int cap,
                   unsigned long long cap_m, const void* counts, void* idx,
                   void* occ, int grid, void* stream) {
  const int64_t n_tiles = (lx + kTile - 1) / kTile;
  if (n_parts < 1 || n_parts > kMaxParts || cap < 1 ||
      (int64_t)n_parts * cap >= (1LL << 31) || lx < 0 || lx >= (1LL << 31) ||
      rows_d < 1 || (rows_d > 1 && rows_m == 0) || (cap > 1 && cap_m == 0) ||
      grid < n_tiles || grid < 1)
    return cudaErrorInvalidValue;
  const Divisor rows = {rows_m, rows_d};
  const Divisor cap_d = {cap_m, (unsigned)cap};
  cudaStream_t s = (cudaStream_t)stream;
  switch (bin_bits(n_parts)) {
    case 2:
      return bucket_launch<2>(dest, (int)lx, tiled, rows, n_parts, cap,
                              cap_d, counts, (int)n_tiles, idx, occ, grid, s);
    case 4:
      return bucket_launch<4>(dest, (int)lx, tiled, rows, n_parts, cap,
                              cap_d, counts, (int)n_tiles, idx, occ, grid, s);
    case 8:
      return bucket_launch<8>(dest, (int)lx, tiled, rows, n_parts, cap,
                              cap_d, counts, (int)n_tiles, idx, occ, grid, s);
    default:
      return bucket_launch<11>(dest, (int)lx, tiled, rows, n_parts, cap,
                               cap_d, counts, (int)n_tiles, idx, occ, grid,
                               s);
  }
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
