// Join kernels for Hopper (sm_90a): the direct-address table (K3), the
// sorted-build probe (K4), the expansion probe (K7) and the run-statistics
// probe (K8). Plain C interface, loaded with ctypes by
// quickstep_tpu_torch/ops/cuda.py; every function launches on the stream it
// is given, allocates nothing, and returns the cudaError_t of its launches.
//
// qs_direct_build / qs_direct_probe replace quickstep_tpu/ops/join.py:43
// direct_build and :63 direct_probe, and, in presence mode, ops/bloom.py:24
// exact_filter_build and :33 exact_filter_probe. qs_sorted_probe replaces the
// probe half of ops/join.py:382 merge_unique_probe (:189 merge_starts); the
// build half, a stable sort of the packed build keys, is torch.sort.
//
// K3 is bound by random accesses to device memory: the build claims one slot
// of a table of `domain` int32 row ids per build row, the probe reads one
// slot per live in-range probe row. The SF10 orderkey table has 60 M slots
// (240 MB), far beyond the 50 MB L2, so each read is a DRAM sector, and most
// probes of a selective join pay it to learn that the key is absent. So a
// table too large for the L2 carries a presence bitmap of ceil(domain / 32)
// words behind it (kTableBits: 7.5 MB at 60 M slots, 16.8 MB at the 2^27-slot
// limit, both L2-resident): the build sets a key's bit in the launch that
// claims its slot, and the probe tests the bit in the L2 and reads the table
// only where it is set. A table that fits the L2 is read directly (kTable);
// ops/cuda.py direct_route picks the layout from the domain. The exact
// filter is the bitmap alone (kBits), a bit where the reference keeps a byte.
// The probe takes four rows a thread by vector accesses (int4 or two
// longlong2 of keys, uchar4 of the mask and of the matched flags, int4 of row
// ids) that stream past the L2 (__ldcs, __stcs), so that the bitmap and the
// table stay there, and it issues the four rows' bitmap reads, then their
// table reads, together. The TPU formulation (a collision-free scatter plus a
// read-back gather to find duplicates) becomes an atomicCAS: a row that finds
// its slot taken by another row is the duplicate.
//
// qs_sorted_probe (K4) searches the fence that K7 builds (below): a first
// launch packs the sorted keys, the rows as int32 and the fence levels, and
// sets the dup flag from adjacent sorted keys; the second takes four probe
// rows a thread by streaming vector accesses (K3's), searches the top level
// in shared memory for the four together, then reads one sector of 4 keys a
// level down to the leaf, and one int32 row on a hit: at 100 K build keys
// two sectors and a row where a binary search over the keys makes 17
// dependent reads and an int64 one. The reference's concatenated merge sort
// existed only because TPU gathers are slow.
//
// qs_expand_probe replaces quickstep_tpu/ops/join.py:228 expand_probe (and
// the (start, count) of :189 merge_starts). A binary search over the sorted
// build keys costs ceil(log2 n) dependent reads a probe row (23 at 8 M rows)
// in arrays beyond the L2, and the walk then reads the int64 permutation.
// What bounds it is the number of random loads a thread issues: each costs
// the SM's L1 one pass whatever its width (measured: the walk's five scalar
// key loads alone took 1.7 of 7.4 ms). So a first launch copies the sorted
// keys (padded to whole sectors) and the rows as int32, and builds a fence
// over the keys: level 0 holds every 4th key, each further level every 4th
// key of the level below, up to a level of at most kTopKeys keys (64 KB),
// which every block of the second launch stages in shared memory. A probe
// row binary-searches that top level in shared memory, then reads one
// sector of 4 keys a level (two loads) and counts the keys below its own,
// down to its leaf (four levels at 8 M rows, 21 MB that stay in the L2).
// For K <= 4 it reads the leaf and the next as one window of eight keys and
// the rows as two int4, and counts the run and picks its rows in
// registers: six loads where the leaf and a walk key by key and row by row
// take eleven. It writes the
// first K build rows of the run, in stable sort order, into its K slots of
// the row-major output (-1 pads; int4 stores where K is a multiple of 4).
// The same launch raises the overflow flag when a live run is longer than
// K, which the executor answers with a retry at 4 K; where the window or
// the walk cannot see the run's end, its length comes from a second search,
// for the key plus one.
//
// qs_run_stats_probe replaces ops/join.py:317 merge_cmp_probe and :247
// merge_stats_probe. The reference concatenates build and probe, sorts them
// together, takes segmented min/max by packed cummax scans and sorts back,
// all to avoid TPU gathers. Here one call runs:
// - a range reduce over the live build keys (a key of INT64_MAX, which no
//   probe row can match, counts as dead) and the key-value radix sort of
//   radix_device.cuh over their range-compressed codes, with the int32
//   build values as the payload: K8 needs only each run's min and max,
//   never the build row, so no value is gathered through a permutation.
//   Dead rows sort last, at max + 1. Q21's orderkeys span about 26 bits, so
//   four 8-bit passes of 8-byte records run where a sort of the int64 keys
//   with INT64_MAX sentinels runs eight of 16-byte ones;
// - each run's min and max by a segmented reduce over the sorted records in
//   tiles of kStatTile (K5's tile-and-carry design with seg_device.cuh's
//   block scan, run from the tile's end so that the result lands at the
//   run's first position): no run is walked by one thread, and MIN and MAX
//   are exact in any grouping. A run that starts in a tile and ends past it
//   is completed by a one-block launch over the tiles' carries. Min and max
//   are stored packed in one int64, so a hit costs one load;
// - K4's fence over the sorted codes (the pack launch), then the probe:
//   four probe rows a thread in lockstep map their keys into the code
//   range (a key outside [min, max] matches nothing: dead build rows never
//   match), descend the fence to the lower bound and the code there, and
//   a hit reads the packed stats. Probe keys, masks, values and outputs
//   stream (__ldcs, __stcs) so that the fence stays in the L2.
// In compare mode it returns pmask & (a live build row has the key) & (pval
// OP the run's stat); in stats mode (matched, min, max), with (INT32_MAX,
// INT32_MIN) for a probe row that matches nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_device.cuh"
#include "seg_device.cuh"

namespace {

constexpr int kThreads = 256;

// K3's layouts of its one int32 buffer: the row table of `domain` slots; the
// row table with the presence bitmap behind it; the bitmap alone.
enum DirectMode { kTable = 0, kTableBits = 1, kBits = 2 };

// K3 build. The row table: table[key - lo] = row by atomicCAS from -1; a row
// that loses to ANOTHER row raises *dup. Which duplicate wins may differ from
// XLA's scatter, but only when the dup flag is set, and then the executor
// discards the result and retries on the expansion path. The bitmap: where
// neighbouring lanes of a warp share a word, the lanes of each word OR their
// bits together and one of them sets them by atomicOr (a build of ascending
// keys, or a semi-join build that repeats keys by design, would otherwise
// queue its atomics on one word); each atomicOr is skipped where its bits
// are set already. The bitmap alone raises no dup flag. The loop runs whole blocks of rows, so that every lane of a warp
// reaches the warp-wide match.
template <typename K, int MODE>
__global__ void __launch_bounds__(kThreads)
direct_build_kernel(const K* __restrict__ key, const uint8_t* __restrict__ alive,
                    int64_t n, int64_t lo, int64_t domain,
                    int* __restrict__ table, unsigned* __restrict__ bits,
                    int* __restrict__ dup) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n;
       base += stride) {
    const int64_t i = base + threadIdx.x;
    int64_t idx = 0;
    bool ok = false;
    if (i < n && alive[i]) {
      idx = (int64_t)key[i] - lo;
      ok = idx >= 0 && idx < domain;
    }
    if constexpr (MODE != kTable) {
      const unsigned long long word = ok ? (unsigned long long)(idx >> 5)
                                         : ~0ull;
      const unsigned bit = ok ? 1u << (idx & 31) : 0u;
      unsigned mine = bit;
      bool leader = ok;
      // random keys seldom share a word with the next lane's, and then
      // every lane sets its own bit (every lane takes part in the shuffle)
      const unsigned long long prev = __shfl_up_sync(0xffffffffu, word, 1);
      const bool near = ok && (threadIdx.x & 31) != 0 && prev == word;
      if (__any_sync(0xffffffffu, near)) {
        const unsigned peers = __match_any_sync(0xffffffffu, word);
        mine = __reduce_or_sync(peers, bit);
        leader = ok && (int)(threadIdx.x & 31) == __ffs(peers) - 1;
      }
      if (leader) {
        unsigned* w = bits + (idx >> 5);
        if ((*w & mine) != mine) atomicOr(w, mine);
      }
    }
    if constexpr (MODE != kBits) {
      if (ok) {
        const int old = atomicCAS(table + idx, -1, (int)i);
        if (old != -1 && old != (int)i) atomicExch(dup, 1);
      }
    }
  }
}

// The keys and mask of R probe rows from row i: R = 4 by vector loads (the
// caller checked the alignment), R = 1 by scalar ones; all streamed.
template <typename K, int R>
__device__ __forceinline__ void load_rows(const K* __restrict__ key,
                                          const uint8_t* __restrict__ alive,
                                          int64_t i, long long (&k)[R],
                                          bool (&live)[R]) {
  if constexpr (R == 1) {
    k[0] = __ldcs(key + i);
    live[0] = __ldcs(alive + i);
  } else {
    if constexpr (sizeof(K) == 4) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(key + i));
      k[0] = v.x; k[1] = v.y; k[2] = v.z; k[3] = v.w;
    } else {
      const longlong2 a = __ldcs(reinterpret_cast<const longlong2*>(key + i));
      const longlong2 b =
          __ldcs(reinterpret_cast<const longlong2*>(key + i + 2));
      k[0] = a.x; k[1] = a.y; k[2] = b.x; k[3] = b.y;
    }
    const uchar4 m = __ldcs(reinterpret_cast<const uchar4*>(alive + i));
    live[0] = m.x; live[1] = m.y; live[2] = m.z; live[3] = m.w;
  }
}

// K3's lookup of R rows: every row's bitmap word first, then every table
// slot whose bit is set, so that each round of reads is in flight together.
template <int MODE, int R>
__device__ __forceinline__ void lookup(const long long (&k)[R],
                                       const bool (&live)[R], int64_t lo,
                                       int64_t domain,
                                       const int* __restrict__ table,
                                       const unsigned* __restrict__ bits,
                                       int (&b)[R], bool (&hit)[R]) {
  int64_t idx[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    idx[r] = k[r] - lo;
    hit[r] = live[r] && idx[r] >= 0 && idx[r] < domain;
  }
  if constexpr (MODE != kTable) {
    unsigned w[R];
#pragma unroll
    for (int r = 0; r < R; ++r) w[r] = hit[r] ? __ldg(bits + (idx[r] >> 5)) : 0u;
#pragma unroll
    for (int r = 0; r < R; ++r) hit[r] = (w[r] >> (idx[r] & 31)) & 1u;
  }
  if constexpr (MODE != kBits) {
#pragma unroll
    for (int r = 0; r < R; ++r) b[r] = hit[r] ? __ldg(table + idx[r]) : -1;
#pragma unroll
    for (int r = 0; r < R; ++r) hit[r] = b[r] >= 0;
  }
}

template <int MODE, int R>
__device__ __forceinline__ void store_rows(int* __restrict__ bidx,
                                           uint8_t* __restrict__ matched,
                                           int64_t i, const int (&b)[R],
                                           const bool (&hit)[R]) {
  if constexpr (R == 1) {
    __stcs(matched + i, (uint8_t)hit[0]);
    if constexpr (MODE != kBits) __stcs(bidx + i, b[0]);
  } else {
    __stcs(reinterpret_cast<uchar4*>(matched + i),
           make_uchar4(hit[0], hit[1], hit[2], hit[3]));
    if constexpr (MODE != kBits) {
      __stcs(reinterpret_cast<int4*>(bidx + i),
             make_int4(b[0], b[1], b[2], b[3]));
    }
  }
}

// K3 probe: groups of four rows (VEC), then the rows past the last whole
// group (or every row, where the buffers are not aligned for vectors) one
// at a time.
template <typename K, int MODE, bool VEC>
__global__ void __launch_bounds__(kThreads)
direct_probe_kernel(const K* __restrict__ key, const uint8_t* __restrict__ alive,
                    int64_t n, int64_t lo, int64_t domain,
                    const int* __restrict__ table,
                    const unsigned* __restrict__ bits, int* __restrict__ bidx,
                    uint8_t* __restrict__ matched) {
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t first = 0;
  if constexpr (VEC) {
    const int64_t groups = n / 4;
    for (int64_t g = tid; g < groups; g += stride) {
      long long k[4];
      bool live[4], hit[4];
      int b[4];
      load_rows<K, 4>(key, alive, 4 * g, k, live);
      lookup<MODE, 4>(k, live, lo, domain, table, bits, b, hit);
      store_rows<MODE, 4>(bidx, matched, 4 * g, b, hit);
    }
    first = 4 * groups;
  }
  for (int64_t i = first + tid; i < n; i += stride) {
    long long k[1];
    bool live[1], hit[1];
    int b[1];
    load_rows<K, 1>(key, alive, i, k, live);
    lookup<MODE, 1>(k, live, lo, domain, table, bits, b, hit);
    store_rows<MODE, 1>(bidx, matched, i, b, hit);
  }
}

// K7's scratch: the sorted keys, padded with dead keys to a whole leaf of
// kLeafKeys and two leaves more (so that a walk of five keys from any lower
// bound stays inside); the build rows as int32, padded alike with -1; then
// the fence: level 0 holds every kLeafKeys-th key, level l + 1 every
// kFanout-th key of level l, up to a top level of at most kTopKeys keys.
// Each level is padded with dead keys to a whole node of kFanout keys, so
// that every node and leaf is one aligned 32-byte sector.
constexpr int kLeafKeys = 4;       // 4 int64 keys: one 32-byte sector
constexpr int kFanout = 4;         // the same for a fence node
constexpr int kTopKeys = 8192;     // 64 KB of shared memory
constexpr int kProbeThreads = 512; // three blocks an SM share its 227 KB
constexpr int kMaxLevels = 16;
constexpr long long kDeadKey = INT64_MAX;

struct Fence {
  long long* level[kMaxLevels];
  int64_t size[kMaxLevels];   // keys of each level, without its padding
  int levels;
};

__host__ __device__ constexpr int64_t round_up(int64_t x, int64_t m) {
  return (x + m - 1) / m * m;
}

__host__ __device__ constexpr int64_t padded_keys(int64_t n_build) {
  return round_up(n_build, kLeafKeys) + 2 * kLeafKeys;
}

// The fence's int64 of a sorted key: K4's and K7's keys as they are; K8's
// range-compressed codes, 32-bit ones as they are and 64-bit ones with the
// top bit flipped, so that the signed order is theirs.
__device__ __forceinline__ long long fence_key(long long x) { return x; }
__device__ __forceinline__ long long fence_key(unsigned x) {
  return (long long)x;
}
__device__ __forceinline__ long long fence_key(unsigned long long x) {
  return (long long)(x ^ 0x8000000000000000ull);
}

// K7's, K4's and K8's first launch: the padded keys, the int32 rows (where
// order is given) and the fence; with dup (K4), *dup = 1 where two live
// sorted keys are equal. K8 launches it in both key widths (narrow picks).
template <typename K>
__global__ void __launch_bounds__(kThreads)
fence_pack_kernel(const K* __restrict__ sorted_key,
                  const long long* __restrict__ order, int64_t n_build,
                  long long* __restrict__ keys, int* __restrict__ rows,
                  Fence f, int* __restrict__ dup,
                  const int* __restrict__ narrow) {
  if (radix::wrong_width<K>(narrow)) return;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t padded = padded_keys(n_build);
  for (int64_t i = tid; i < padded; i += stride) {
    const long long key = i < n_build ? fence_key(sorted_key[i]) : kDeadKey;
    if (dup != nullptr && i + 1 < n_build && key != kDeadKey &&
        key == fence_key(sorted_key[i + 1])) {
      *dup = 1;
    }
    keys[i] = key;
    if (order != nullptr) rows[i] = i < n_build ? (int)order[i] : -1;
    if (i >= n_build || i % kLeafKeys) continue;
    int64_t j = i / kLeafKeys;
    f.level[0][j] = key;
    for (int l = 1; l < f.levels && j % kFanout == 0; ++l) {
      j /= kFanout;
      f.level[l][j] = key;
    }
  }
  for (int64_t t = tid; t < (int64_t)f.levels * kFanout; t += stride) {
    const int l = (int)(t / kFanout);
    const int64_t j = f.size[l] + t % kFanout;
    if (j < round_up(f.size[l], kFanout)) f.level[l][j] = kDeadKey;
  }
}

// The keys below k among the four of one aligned sector at p.
__device__ __forceinline__ int count_below(const long long* __restrict__ p,
                                           long long k) {
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(p));
  const longlong2 b = __ldg(reinterpret_cast<const longlong2*>(p) + 1);
  return (a.x < k) + (a.y < k) + (b.x < k) + (b.y < k);
}

// The leaf (the first of kLeafKeys sorted keys) that holds the first key >=
// k, or whose end it is. c counts the keys of a level below k: every key
// before node c - 1 of the level beneath is below k (it is at most key c -
// 1 of this level, which is), every key from node c on is not, so the count
// there is the node's start plus its keys below k. One sector a level.
__device__ __forceinline__ int64_t fence_leaf(const long long* top,
                                              int64_t n_top, const Fence& f,
                                              long long k) {
  int64_t lo = 0, hi = n_top;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (top[mid] < k) lo = mid + 1;
    else hi = mid;
  }
  int64_t c = lo;
  for (int l = f.levels - 2; l >= 0; --l) {
    const int64_t base = (c > 0 ? c - 1 : 0) * kFanout;
    c = base + count_below(f.level[l] + base, k);
  }
  return (c > 0 ? c - 1 : 0) * kLeafKeys;
}

// The first key >= k (where c above is 0, every key is >= k: the count in
// leaf 0 is 0).
__device__ __forceinline__ int64_t fence_lower_bound(
    const long long* top, int64_t n_top, const Fence& f,
    const long long* __restrict__ keys, long long k) {
  const int64_t base = fence_leaf(top, n_top, f, k);
  return base + count_below(keys + base, k);
}

// a[i] for a small register array and an index known only at run time,
// without a trip through local memory.
template <int N, typename T>
__device__ __forceinline__ T pick(const T (&a)[N], int i) {
  T x = a[0];
#pragma unroll
  for (int t = 1; t < N; ++t) x = i == t ? a[t] : x;
  return x;
}

// K4's descent, which also carries the key at the lower bound down, so that
// no load is spent on it, and searches the four rows of a thread in
// lockstep (K7 keeps its own, above: sharing this one cost its probe about
// 1 % in kernel_ab). One level down: c counts the keys of the level above
// below k, and next is the first of them >= k. Every key before node c - 1 of this level is below
// k (it is at most key c - 1 above, which is), every key from node c on is
// not, so the count here is the node's start plus its keys below k; one
// sector. Where the node holds no key >= k, the first such key is key c of
// the level above (each level holds every kFanout-th key of the one below),
// which is next already.
__device__ __forceinline__ void fence_step(const long long* __restrict__ level,
                                           int64_t& c, long long& next,
                                           long long k) {
  const int64_t base = (c > 0 ? c - 1 : 0) * kFanout;
  const longlong2 a = __ldg(reinterpret_cast<const longlong2*>(level + base));
  const longlong2 b =
      __ldg(reinterpret_cast<const longlong2*>(level + base) + 1);
  const long long w[kFanout] = {a.x, a.y, b.x, b.y};
  const int below = (w[0] < k) + (w[1] < k) + (w[2] < k) + (w[3] < k);
  c = base + below;
  if (below < kFanout) next = pick(w, below);
}

// The count c of level-0 keys below each of R keys, and next, the first
// level-0 key >= it (kDeadKey past the end): a branchless lower bound over
// the top level in shared memory, the same steps for every key, then one
// fence_step a level, the R rows' loads of a level issued together. Rows
// that are not live load nothing.
template <int R>
__device__ __forceinline__ void fence_descend(const long long* top,
                                              int64_t n_top, const Fence& f,
                                              const long long (&k)[R],
                                              const bool (&live)[R],
                                              int64_t (&c)[R],
                                              long long (&next)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) c[r] = 0;
  for (int64_t len = n_top; len > 1;) {
    const int64_t half = len >> 1;
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = top[c[r] + half] < k[r] ? c[r] + half : c[r];
    len -= half;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    c[r] += top[c[r]] < k[r];
    next[r] = c[r] < n_top ? top[c[r]] : kDeadKey;
  }
  for (int l = f.levels - 2; l >= 0; --l) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (live[r]) fence_step(f.level[l], c[r], next[r], k[r]);
    }
  }
}

// K7, second launch: the run [lb, lb + count) of every live probe row's key;
// rows receives the run's first min(count, k) build rows in the row's k
// slots and -1 in the others; counts receives count (0 for dead rows and
// the dead key). SMALL (k <= 4): the leaf and the next leaf are read as one
// window of eight keys (a ninth where the lower bound is the leaf's end),
// which holds the lower bound and the five keys the run needs, and the
// eight rows from the lower bound's aligned group of four as two int4. A
// run of up to four is counted exactly from the window; where all five keys
// are the probe's, the run's end comes from a second search, for the key
// plus one. K = 4 stores its slots as one int4. Otherwise the walk reads
// key by key and stores four slots at a time (one int4 where K is a
// multiple of 4).
template <bool SMALL>
__global__ void __launch_bounds__(kProbeThreads)
expand_probe_kernel(const long long* __restrict__ keys,
                    const int* __restrict__ build_rows, int64_t n_build,
                    Fence f, const long long* __restrict__ probe,
                    const uint8_t* __restrict__ alive, int64_t n_probe, int k,
                    int* __restrict__ rows, int* __restrict__ counts,
                    int* __restrict__ overflow) {
  extern __shared__ long long top[];
  const int64_t n_top = f.size[f.levels - 1];
  for (int t = threadIdx.x; t < n_top; t += kProbeThreads) {
    top[t] = f.level[f.levels - 1][t];
  }
  __syncthreads();
  const int64_t stride = (int64_t)gridDim.x * kProbeThreads;
  for (int64_t i = (int64_t)blockIdx.x * kProbeThreads + threadIdx.x;
       i < n_probe; i += stride) {
    const long long key = __ldcs(probe + i);
    const bool live = __ldcs(alive + i) && key != kDeadKey;
    int* out = rows + i * k;
    int64_t count = 0;
    if constexpr (SMALL) {
      int slot[4] = {-1, -1, -1, -1};
      if (live) {
        const int64_t base = fence_leaf(top, n_top, f, key);
        const longlong2* w2 = reinterpret_cast<const longlong2*>(keys + base);
        long long w[9];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const longlong2 x = __ldg(w2 + j);
          w[2 * j] = x.x;
          w[2 * j + 1] = x.y;
        }
        const int off = (w[0] < key) + (w[1] < key) + (w[2] < key) +
                        (w[3] < key);
        const int64_t lb = base + off;
        w[8] = off == kLeafKeys ? __ldg(keys + base + 2 * kLeafKeys)
                                : kDeadKey;
        const int64_t a = lb & ~(int64_t)3;
        const int4 r0 = __ldg(reinterpret_cast<const int4*>(build_rows + a));
        const int4 r1 =
            __ldg(reinterpret_cast<const int4*>(build_rows + a) + 1);
        const int r[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
        const int ro = (int)(lb - a);
        bool on = true;
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          on = on && pick(w, off + j) == key;
          count += on;
          if (j < 4) slot[j] = on ? pick(r, ro + j) : -1;
        }
        if (count == 5) {
          count = fence_lower_bound(top, n_top, f, keys, key + 1) - lb;
        }
      }
      if (k == 4) {
        __stcs(reinterpret_cast<int4*>(out),
               make_int4(slot[0], slot[1], slot[2], slot[3]));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (j < k) out[j] = slot[j];
        }
      }
    } else {
      const int64_t lb = live ? fence_lower_bound(top, n_top, f, keys, key)
                              : 0;
      int64_t end = lb;   // the first position not known to be in the run
      bool on = live;
      for (int g = 0; g < k; g += 4) {
        int v[4] = {-1, -1, -1, -1};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (g + j < k) {
            on = on && end < n_build && __ldg(keys + end) == key;
            v[j] = on ? __ldg(build_rows + end) : -1;
            end += on;
          }
        }
        if ((k & 3) == 0) {
          __stcs(reinterpret_cast<int4*>(out + g),
                 make_int4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (g + j < k) out[g + j] = v[j];
          }
        }
      }
      count = end - lb;
      if (on && end < n_build && __ldg(keys + end) == key) {
        count = fence_lower_bound(top, n_top, f, keys, key + 1) - lb;
      }
    }
    __stcs(counts + i, (int)count);
    if (count > k) *overflow = 1;
  }
}

// K4, second launch: for each live probe row, the first build row (in
// stable sorted order) whose key equals the probe key; dead probe rows and
// the dead key match nothing. The fence gives the lower bound and the key
// there (fence_descend, then fence_step over the leaf), and a hit reads one
// int32 row. Four rows a thread in lockstep (VEC: by K3's vector loads and
// stores), then the rows past the last group of four one at a time.
template <int R>
__device__ __forceinline__ void unique_lookup(const long long* top,
                                              int64_t n_top, const Fence& f,
                                              const long long* __restrict__ keys,
                                              const int* __restrict__ rows,
                                              const long long (&k)[R],
                                              const bool (&live)[R],
                                              int (&b)[R], bool (&hit)[R]) {
  int64_t c[R];
  long long at[R];
  fence_descend<R>(top, n_top, f, k, live, c, at);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (live[r]) fence_step(keys, c[r], at[r], k[r]);
  }
#pragma unroll
  for (int r = 0; r < R; ++r) hit[r] = live[r] && at[r] == k[r];
#pragma unroll
  for (int r = 0; r < R; ++r) b[r] = hit[r] ? __ldg(rows + c[r]) : -1;
}

template <bool VEC>
__global__ void __launch_bounds__(kProbeThreads, 2)
unique_probe_kernel(const long long* __restrict__ keys,
                    const int* __restrict__ build_rows, Fence f,
                    const long long* __restrict__ probe,
                    const uint8_t* __restrict__ pmask, int64_t n_probe,
                    int* __restrict__ bidx, uint8_t* __restrict__ matched) {
  extern __shared__ long long top[];
  const int64_t n_top = f.size[f.levels - 1];
  for (int t = threadIdx.x; t < n_top; t += kProbeThreads) {
    top[t] = f.level[f.levels - 1][t];
  }
  __syncthreads();
  const int64_t tid = (int64_t)blockIdx.x * kProbeThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kProbeThreads;
  int64_t first = 0;
  if constexpr (VEC) {
    const int64_t groups = n_probe / 4;
    for (int64_t g = tid; g < groups; g += stride) {
      long long k[4];
      bool live[4], hit[4];
      int b[4];
      load_rows<long long, 4>(probe, pmask, 4 * g, k, live);
#pragma unroll
      for (int r = 0; r < 4; ++r) live[r] = live[r] && k[r] != kDeadKey;
      unique_lookup<4>(top, n_top, f, keys, build_rows, k, live, b, hit);
      store_rows<kTable, 4>(bidx, matched, 4 * g, b, hit);
    }
    first = 4 * groups;
  }
  for (int64_t i = first + tid; i < n_probe; i += stride) {
    long long k[1];
    bool live[1], hit[1];
    int b[1];
    load_rows<long long, 1>(probe, pmask, i, k, live);
    live[0] = live[0] && k[0] != kDeadKey;
    unique_lookup<1>(top, n_top, f, keys, build_rows, k, live, b, hit);
    store_rows<kTable, 1>(bidx, matched, i, b, hit);
  }
}

enum CmpOp { kStats = -1, kNe = 0, kLt = 1, kLe = 2, kGt = 3, kGe = 4 };

constexpr unsigned long long kSignBit = 0x8000000000000000ull;

// K8's build keys as a source of the key-value sort: the order-preserving
// code of a live key, and max + 1 (the top of the range) for a dead row.
struct BuildSrc {
  const long long* key;
  const uint8_t* alive;
  __device__ __forceinline__ bool raw(int64_t i,
                                      unsigned long long& u) const {
    const long long k = key[i];
    u = (unsigned long long)k ^ kSignBit;
    return alive[i] && k != kDeadKey;
  }
  __device__ __forceinline__ unsigned long long code(
      int64_t i, unsigned long long lo, unsigned long long hi) const {
    unsigned long long u;
    return raw(i, u) ? u - lo : hi - lo;
  }
};

// K8's run statistics: tiles of kStatTile sorted records, kStatItems a
// thread; the carries' one block.
constexpr int kStatItems = 8;
constexpr int kStatTile = kThreads * kStatItems;
constexpr int kCarryThreads = 1024;

// A segmented min/max element; a segment starts at a run's last row, as
// the scan runs from the end of the rows to their start.
struct RunStat {
  int f;
  int mn;
  int mx;
};

__device__ __forceinline__ RunStat shfl_up(const RunStat& x, int d) {
  return {__shfl_up_sync(kFull, x.f, d), __shfl_up_sync(kFull, x.mn, d),
          __shfl_up_sync(kFull, x.mx, d)};
}

struct RunStatOp {   // (earlier, later) in scan order
  __device__ __forceinline__ RunStat operator()(const RunStat& a,
                                                const RunStat& b) const {
    return {a.f | b.f, b.f ? b.mn : min(a.mn, b.mn),
            b.f ? b.mx : max(a.mx, b.mx)};
  }
};

__device__ __forceinline__ long long pack_stat(int mn, int mx) {
  return (long long)(((unsigned long long)(unsigned)mx << 32) |
                     (unsigned)mn);
}

// Per tile: the tile's scan total (whether a run ends in it, and the min
// and max of its rows up to the first run end), and the fix row (the start
// of the run that is open at the tile's end, or -1) with its partial stats.
struct StatCarry {
  int* f;
  int* mn;
  int* mx;
  int* fix_at;
  int* fix_mn;
  int* fix_mx;
};

// K8's stats launch, one block a tile: thread t holds the kStatItems rows
// of the tile's chunk kThreads - 1 - t, so the block scan in thread order
// runs from the tile's end to its start and each run's first row receives
// the min and max of the run's rows in the tile; where the run goes on past
// the tile, that row is the tile's fix row, which the carry launch
// completes. Launched in both key widths (narrow picks).
template <typename K>
__global__ void __launch_bounds__(kThreads)
run_stats_tile_kernel(const K* __restrict__ keys, const int* __restrict__ vals,
                      int64_t n, long long* __restrict__ stats,
                      StatCarry carry, const int* __restrict__ narrow) {
  if (radix::wrong_width<K>(narrow)) return;
  __shared__ int s_fix;
  const RunStatOp op;
  const RunStat id = {0, INT32_MAX, INT32_MIN};
  const int64_t tile0 = (int64_t)blockIdx.x * kStatTile;
  const int64_t r0 =
      tile0 + (int64_t)(kThreads - 1 - threadIdx.x) * kStatItems;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s_fix = -1;
  K k[kStatItems];
  int v[kStatItems];
#pragma unroll
  for (int j = 0; j < kStatItems; ++j) {
    const int64_t r = r0 + j;
    k[j] = r < n ? keys[r] : K(0);
    v[j] = r < n ? vals[r] : 0;
  }
  // the key after the thread's rows (the thread before's first) and the
  // key before them (the thread after's last)
  K after = __shfl_up_sync(kFull, k[0], 1);
  K before = __shfl_down_sync(kFull, k[kStatItems - 1], 1);
  if (lane == 0) after = r0 + kStatItems < n ? keys[r0 + kStatItems] : K(0);
  if (lane == 31) before = r0 > 0 && r0 - 1 < n ? keys[r0 - 1] : K(0);
  bool tail[kStatItems], head[kStatItems];
#pragma unroll
  for (int j = 0; j < kStatItems; ++j) {
    const int64_t r = r0 + j;
    const K next = j + 1 < kStatItems ? k[j + 1] : after;
    const K prev = j > 0 ? k[j - 1] : before;
    tail[j] = r < n && (r + 1 == n || k[j] != next);
    head[j] = r < n && (r == 0 || k[j] != prev);
  }
  RunStat s = id;
#pragma unroll
  for (int j = kStatItems - 1; j >= 0; --j) {
    if (r0 + j < n) s = op(s, RunStat{tail[j], v[j], v[j]});
  }
  RunStat total;
  RunStat cur = block_exclusive_scan<kThreads>(s, id, op, total);
#pragma unroll
  for (int j = kStatItems - 1; j >= 0; --j) {
    const int64_t r = r0 + j;
    if (r >= n) continue;
    cur = op(cur, RunStat{tail[j], v[j], v[j]});
    if (!head[j]) continue;
    if (cur.f) {
      stats[r] = pack_stat(cur.mn, cur.mx);
    } else {   // the run goes on past the tile: at most one a tile
      s_fix = (int)(r - tile0);
      carry.fix_mn[blockIdx.x] = cur.mn;
      carry.fix_mx[blockIdx.x] = cur.mx;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    carry.f[blockIdx.x] = total.f;
    carry.mn[blockIdx.x] = total.mn;
    carry.mx[blockIdx.x] = total.mx;
    carry.fix_at[blockIdx.x] = s_fix;
  }
}

// K8's carry launch, one block: the tiles' totals scanned from the last
// tile to the first give each tile the min and max of the rows after it up
// to the first run end, which complete its fix row.
__global__ void __launch_bounds__(kCarryThreads)
run_stats_carry_kernel(StatCarry carry, int64_t ntiles,
                       long long* __restrict__ stats) {
  const RunStatOp op;
  const RunStat id = {0, INT32_MAX, INT32_MIN};
  const int64_t per = (ntiles + kCarryThreads - 1) / kCarryThreads;
  const int64_t p0 = (int64_t)threadIdx.x * per;
  const int64_t p1 = p0 + per < ntiles ? p0 + per : ntiles;
  RunStat s = id;
  for (int64_t p = p0; p < p1; ++p) {   // scan position p: tile ntiles-1-p
    const int64_t t = ntiles - 1 - p;
    s = op(s, RunStat{carry.f[t], carry.mn[t], carry.mx[t]});
  }
  RunStat total;
  RunStat cur = block_exclusive_scan<kCarryThreads>(s, id, op, total);
  for (int64_t p = p0; p < p1; ++p) {
    const int64_t t = ntiles - 1 - p;
    const int at = carry.fix_at[t];
    if (at >= 0) {
      stats[t * kStatTile + at] = pack_stat(min(cur.mn, carry.fix_mn[t]),
                                            max(cur.mx, carry.fix_mx[t]));
    }
    cur = op(cur, RunStat{carry.f[t], carry.mn[t], carry.mx[t]});
  }
}

// K8's probe of R rows from row i (R = 4 by vector accesses): each key is
// mapped into the build's code range (outside it, and for rows that need
// no answer, the row searches nothing), the fence gives the lower bound and
// the code there, and a hit reads the run's packed min and max. Compare
// mode: matched = pmask & hit & (pval OP stat); stats mode: matched = pmask
// & hit, and min and max for every row with a hit.
template <int R>
__device__ __forceinline__ void stats_probe_rows(
    const long long* top, int64_t n_top, const Fence& f,
    const long long* __restrict__ keys, const long long* __restrict__ stats,
    const radix::Span& sp, const long long* __restrict__ probe,
    const uint8_t* __restrict__ pmask, const int* __restrict__ pval,
    int64_t i, int op, uint8_t* __restrict__ matched,
    int* __restrict__ out_min, int* __restrict__ out_max) {
  long long k[R];
  bool m[R];
  load_rows<long long, R>(probe, pmask, i, k, m);
  int v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = 0;
  if (op != kStats) {
    if constexpr (R == 1) {
      v[0] = __ldcs(pval + i);
    } else {
      const int4 x = __ldcs(reinterpret_cast<const int4*>(pval + i));
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    }
  }
  long long code[R];
  bool live[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const unsigned long long u = (unsigned long long)k[r] ^ kSignBit;
    live[r] = (op == kStats || m[r]) && u >= sp.min && u <= sp.max;
    const unsigned long long c = u - sp.lo;
    code[r] = sp.narrow ? (long long)c : (long long)(c ^ kSignBit);
  }
  int64_t c[R];
  long long at[R];
  fence_descend<R>(top, n_top, f, code, live, c, at);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (live[r]) fence_step(keys, c[r], at[r], code[r]);
  }
  bool has[R];
  long long st[R];
#pragma unroll
  for (int r = 0; r < R; ++r) has[r] = live[r] && at[r] == code[r];
#pragma unroll
  for (int r = 0; r < R; ++r) st[r] = has[r] ? __ldg(stats + c[r]) : 0;
  int mn[R], mx[R];
  uint8_t hit[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    mn[r] = has[r] ? (int)(unsigned)st[r] : INT32_MAX;
    mx[r] = has[r] ? (int)(st[r] >> 32) : INT32_MIN;
    bool h = m[r] && has[r];
    switch (op) {
      case kStats: break;
      case kNe: h = h && (mn[r] != v[r] || mx[r] != v[r]); break;
      case kLt: h = h && v[r] < mx[r]; break;
      case kLe: h = h && v[r] <= mx[r]; break;
      case kGt: h = h && v[r] > mn[r]; break;
      default: h = h && v[r] >= mn[r]; break;
    }
    hit[r] = h;
  }
  if constexpr (R == 1) {
    __stcs(matched + i, hit[0]);
    if (op == kStats) {
      __stcs(out_min + i, mn[0]);
      __stcs(out_max + i, mx[0]);
    }
  } else {
    __stcs(reinterpret_cast<uchar4*>(matched + i),
           make_uchar4(hit[0], hit[1], hit[2], hit[3]));
    if (op == kStats) {
      __stcs(reinterpret_cast<int4*>(out_min + i),
             make_int4(mn[0], mn[1], mn[2], mn[3]));
      __stcs(reinterpret_cast<int4*>(out_max + i),
             make_int4(mx[0], mx[1], mx[2], mx[3]));
    }
  }
}

// K8's probe launch: the fence's top level staged in shared memory, then
// groups of four probe rows (VEC), then the rows past the last group.
template <bool VEC>
__global__ void __launch_bounds__(kProbeThreads, 2)
stats_probe_kernel(const long long* __restrict__ keys,
                   const long long* __restrict__ stats, Fence f,
                   const radix::Span* __restrict__ span,
                   const long long* __restrict__ probe,
                   const uint8_t* __restrict__ pmask,
                   const int* __restrict__ pval, int64_t n_probe, int op,
                   uint8_t* __restrict__ matched, int* __restrict__ out_min,
                   int* __restrict__ out_max) {
  extern __shared__ long long top[];
  const int64_t n_top = f.size[f.levels - 1];
  for (int t = threadIdx.x; t < n_top; t += kProbeThreads) {
    top[t] = f.level[f.levels - 1][t];
  }
  __syncthreads();
  const radix::Span sp = *span;
  const int64_t tid = (int64_t)blockIdx.x * kProbeThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kProbeThreads;
  int64_t first = 0;
  if constexpr (VEC) {
    const int64_t groups = n_probe / 4;
    for (int64_t g = tid; g < groups; g += stride) {
      stats_probe_rows<4>(top, n_top, f, keys, stats, sp, probe, pmask, pval,
                          4 * g, op, matched, out_min, out_max);
    }
    first = 4 * groups;
  }
  for (int64_t i = first + tid; i < n_probe; i += stride) {
    stats_probe_rows<1>(top, n_top, f, keys, stats, sp, probe, pmask, pval,
                        i, op, matched, out_min, out_max);
  }
}

enum KeyType { kKeyI32 = 0, kKeyI64 = 1 };

bool aligned(const void* p, uintptr_t bytes) {
  return ((uintptr_t)p & (bytes - 1)) == 0;
}

// K4's and K7's scratch, cut into the padded keys, the int32 rows and the
// fence levels; false where the layout is not one fence_layout makes.
bool carve_fence(void* scratch, int64_t n_build, const int64_t* level_sizes,
                 int levels, long long*& keys, int*& rows, Fence& f) {
  if (levels < 1 || levels > kMaxLevels ||
      level_sizes[levels - 1] > kTopKeys) {
    return false;
  }
  const int64_t padded = padded_keys(n_build);
  keys = (long long*)scratch;
  rows = (int*)(keys + padded);
  long long* at = keys + padded + round_up(padded, 2 * kLeafKeys) / 2;
  f.levels = levels;
  for (int l = 0; l < kMaxLevels; ++l) {
    f.level[l] = l < levels ? at : nullptr;
    f.size[l] = l < levels ? level_sizes[l] : 0;
    if (l < levels) at += round_up(level_sizes[l], kFanout);
  }
  return true;
}

template <int MODE>
cudaError_t launch_build(int key_type, const void* key, const void* alive,
                         int64_t n, int64_t lo, int64_t domain, void* table,
                         void* bits, void* dup, int blocks,
                         cudaStream_t stream) {
  if (key_type == kKeyI32) {
    direct_build_kernel<int, MODE><<<blocks, kThreads, 0, stream>>>(
        (const int*)key, (const uint8_t*)alive, n, lo, domain, (int*)table,
        (unsigned*)bits, (int*)dup);
  } else {
    direct_build_kernel<long long, MODE><<<blocks, kThreads, 0, stream>>>(
        (const long long*)key, (const uint8_t*)alive, n, lo, domain,
        (int*)table, (unsigned*)bits, (int*)dup);
  }
  return cudaGetLastError();
}

template <typename K, int MODE>
cudaError_t launch_probe(const void* key, const void* alive, int64_t n,
                         int64_t lo, int64_t domain, const void* table,
                         const void* bits, void* bidx, void* matched,
                         int blocks, cudaStream_t stream) {
  const bool vec = aligned(key, 16) && aligned(alive, 4) &&
                   aligned(matched, 4) && (MODE == kBits || aligned(bidx, 16));
  auto kernel = vec ? direct_probe_kernel<K, MODE, true>
                    : direct_probe_kernel<K, MODE, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(
      (const K*)key, (const uint8_t*)alive, n, lo, domain, (const int*)table,
      (const unsigned*)bits, (int*)bidx, (uint8_t*)matched);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t probe_mode(int key_type, const void* key, const void* alive,
                       int64_t n, int64_t lo, int64_t domain,
                       const void* table, const void* bits, void* bidx,
                       void* matched, int blocks, cudaStream_t stream) {
  return key_type == kKeyI32
             ? launch_probe<int, MODE>(key, alive, n, lo, domain, table, bits,
                                       bidx, matched, blocks, stream)
             : launch_probe<long long, MODE>(key, alive, n, lo, domain, table,
                                             bits, bidx, matched, blocks,
                                             stream);
}

}  // namespace

extern "C" {

// mode: 0 the row table alone, 1 the row table and the bitmap, 2 the bitmap
// alone (the exact filter: table and dup unused). The row table holds
// `domain` slots at -1 and the bitmap ceil(domain / 32) zero words.
int qs_direct_build(int key_type, int mode, const void* key,
                    const void* alive, int64_t n, int64_t lo, int64_t domain,
                    void* table, void* bits, void* dup, int blocks,
                    void* stream) {
  if (key_type != kKeyI32 && key_type != kKeyI64) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kTable:
      return launch_build<kTable>(key_type, key, alive, n, lo, domain, table,
                                  bits, dup, blocks, s);
    case kTableBits:
      return launch_build<kTableBits>(key_type, key, alive, n, lo, domain,
                                      table, bits, dup, blocks, s);
    case kBits:
      return launch_build<kBits>(key_type, key, alive, n, lo, domain, table,
                                 bits, dup, blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// mode as for qs_direct_build; in mode 2 bidx is unused and domain may be
// the bitmap's 32 x words (no bit past the build's domain is set).
int qs_direct_probe(int key_type, int mode, const void* key,
                    const void* alive, int64_t n, int64_t lo, int64_t domain,
                    const void* table, const void* bits, void* bidx,
                    void* matched, int blocks, void* stream) {
  if (key_type != kKeyI32 && key_type != kKeyI64) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case kTable:
      return probe_mode<kTable>(key_type, key, alive, n, lo, domain, table,
                                bits, bidx, matched, blocks, s);
    case kTableBits:
      return probe_mode<kTableBits>(key_type, key, alive, n, lo, domain,
                                    table, bits, bidx, matched, blocks, s);
    case kBits:
      return probe_mode<kBits>(key_type, key, alive, n, lo, domain, table,
                               bits, bidx, matched, blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// scratch (int64 words): the keys, round4(n_build) + 8 of them; the int32
// rows, as many, rounded up to whole sectors; then each fence level's
// level_sizes[l] keys rounded up to a multiple of 4 (ops/cuda.py
// fence_layout, fence_scratch_words). The top level holds at most 8,192.
// With n_probe 0 the first launch alone runs (the dup flag).
int qs_sorted_probe(const void* sorted_key, const void* order, int64_t n_build,
                    const void* probe, const void* pmask, int64_t n_probe,
                    void* scratch, const int64_t* level_sizes, int levels,
                    void* bidx, void* matched, void* dup, int pack_blocks,
                    int blocks, void* stream) {
  if (n_build == 0) return cudaSuccess;
  Fence f;
  long long* keys;
  int* build_rows;
  if (!carve_fence(scratch, n_build, level_sizes, levels, keys, build_rows,
                   f)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  fence_pack_kernel<long long><<<pack_blocks, kThreads, 0, s>>>(
      (const long long*)sorted_key, (const long long*)order, n_build, keys,
      build_rows, f, (int*)dup, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_probe == 0) return err;
  const bool vec = aligned(probe, 16) && aligned(pmask, 4) &&
                   aligned(bidx, 16) && aligned(matched, 4);
  auto kernel = vec ? unique_probe_kernel<true> : unique_probe_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTopKeys * (int)sizeof(long long));
  if (err != cudaSuccess) return err;
  const int shared = (int)(level_sizes[levels - 1] * sizeof(long long));
  kernel<<<blocks, kProbeThreads, shared, s>>>(
      keys, build_rows, f, (const long long*)probe, (const uint8_t*)pmask,
      n_probe, (int*)bidx, (uint8_t*)matched);
  return cudaGetLastError();
}

// scratch and level_sizes as for qs_sorted_probe.
int qs_expand_probe(const void* sorted_key, const void* order,
                    int64_t n_build, const void* probe, const void* alive,
                    int64_t n_probe, int k, void* scratch,
                    const int64_t* level_sizes, int levels, void* rows,
                    void* counts, void* overflow, int pack_blocks,
                    int blocks, void* stream) {
  if (n_probe == 0 || n_build == 0) return cudaSuccess;
  Fence f;
  long long* keys;
  int* build_rows;
  if (k < 1 || !carve_fence(scratch, n_build, level_sizes, levels, keys,
                            build_rows, f)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  fence_pack_kernel<long long><<<pack_blocks, kThreads, 0, s>>>(
      (const long long*)sorted_key, (const long long*)order, n_build, keys,
      build_rows, f, nullptr, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int shared = (int)(level_sizes[levels - 1] * sizeof(long long));
  auto kernel = k <= 4 ? expand_probe_kernel<true> : expand_probe_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTopKeys * (int)sizeof(long long));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kProbeThreads, shared, s>>>(
      keys, build_rows, n_build, f, (const long long*)probe,
      (const uint8_t*)alive, n_probe, k, (int*)rows, (int*)counts,
      (int*)overflow);
  return cudaGetLastError();
}

// The int32 words of K8's carry scratch for n_build rows: six a tile.
int64_t qs_run_stats_carry_words(int64_t n_build) {
  return 6 * ((n_build + kStatTile - 1) / kStatTile);
}

// op: -1 stats mode (out_min and out_max written), 0..4 compare mode with
// <>, <, <=, >, >= (pval read, out_min and out_max untouched). Scratch:
// codes 3 n_build int64 words, vals 2 n_build int32, span one radix::Span,
// sort_scratch qs_kv_scratch_words(n_build) words, carry
// qs_run_stats_carry_words(n_build) int32, fence_scratch and level_sizes as
// for qs_sorted_probe. With no build or no probe rows it launches nothing
// (the caller fills the outputs). n_build < 2^31.
int qs_run_stats_probe(const void* bkey, const void* bmask, const void* bval,
                       int64_t n_build, const void* probe, const void* pmask,
                       const void* pval, int64_t n_probe, int op,
                       void* matched, void* out_min, void* out_max,
                       void* codes, void* vals, void* span,
                       void* sort_scratch, void* carry_scratch,
                       void* fence_scratch, const int64_t* level_sizes,
                       int levels, int blocks, int pass_blocks,
                       int probe_blocks, void* stream) {
  if (op < kStats || op > kGe || n_build < 0 || n_build >= (1ll << 31) ||
      blocks < 1 || pass_blocks < 1 || probe_blocks < 1)
    return cudaErrorInvalidValue;
  if (n_build == 0 || n_probe == 0) return cudaSuccess;
  Fence f;
  long long* keys;
  int* unused_rows;
  if (!carve_fence(fence_scratch, n_build, level_sizes, levels, keys,
                   unused_rows, f)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  radix::Span* sp = (radix::Span*)span;
  const BuildSrc src = {(const long long*)bkey, (const uint8_t*)bmask};
  cudaError_t err = radix::reduce_range(src, n_build, sp, ~0ull, blocks, s);
  if (err != cudaSuccess) return err;
  unsigned long long* c = (unsigned long long*)codes;
  int* v = (int*)vals;
  const radix::KvBufs b = {c, (const int*)bval, c + n_build, v,
                           c + 2 * n_build, v + n_build};
  err = radix::kv_sort<8>(src, sp, n_build, true, b, sort_scratch,
                          &sp->narrow, blocks, pass_blocks, s);
  if (err != cudaSuccess) return err;
  // the sorted codes are in c + n_build (32- or 64-bit, as the range
  // picks), the values in v; the sort's scratch keys hold the stats now
  long long* stats = (long long*)(c + 2 * n_build);
  const int64_t ntiles = (n_build + kStatTile - 1) / kStatTile;
  int* cw = (int*)carry_scratch;
  const StatCarry carry = {cw, cw + ntiles, cw + 2 * ntiles, cw + 3 * ntiles,
                           cw + 4 * ntiles, cw + 5 * ntiles};
  run_stats_tile_kernel<unsigned><<<(unsigned)ntiles, kThreads, 0, s>>>(
      (const unsigned*)(c + n_build), v, n_build, stats, carry, &sp->narrow);
  run_stats_tile_kernel<unsigned long long>
      <<<(unsigned)ntiles, kThreads, 0, s>>>(c + n_build, v, n_build, stats,
                                             carry, &sp->narrow);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  run_stats_carry_kernel<<<1, kCarryThreads, 0, s>>>(carry, ntiles, stats);
  fence_pack_kernel<unsigned><<<blocks, kThreads, 0, s>>>(
      (const unsigned*)(c + n_build), nullptr, n_build, keys, nullptr, f,
      nullptr, &sp->narrow);
  fence_pack_kernel<unsigned long long><<<blocks, kThreads, 0, s>>>(
      c + n_build, nullptr, n_build, keys, nullptr, f, nullptr, &sp->narrow);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const bool vec = aligned(probe, 16) && aligned(pmask, 4) &&
                   aligned(matched, 4) &&
                   (op != kStats || (aligned(out_min, 16) &&
                                     aligned(out_max, 16))) &&
                   (op == kStats || aligned(pval, 16));
  auto kernel = vec ? stats_probe_kernel<true> : stats_probe_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTopKeys * (int)sizeof(long long));
  if (err != cudaSuccess) return err;
  const int shared = (int)(level_sizes[levels - 1] * sizeof(long long));
  kernel<<<probe_blocks, kProbeThreads, shared, s>>>(
      keys, stats, f, sp, (const long long*)probe, (const uint8_t*)pmask,
      (const int*)pval, n_probe, op, (uint8_t*)matched, (int*)out_min,
      (int*)out_max);
  return cudaGetLastError();
}

}  // extern "C"
