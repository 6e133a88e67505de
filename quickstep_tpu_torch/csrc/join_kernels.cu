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
// What bounds them on an H100: random accesses to device memory. The build
// scatters one 4-byte row id (or one byte) per build row into a table of
// `domain` entries; the probe reads one entry per probe row. At SF10 the
// orderkey table is 60 M int32 (240 MB), far beyond the 50 MB L2, so each
// access is a DRAM sector. Both are one thread per row with a grid-stride
// loop: the key and mask reads are coalesced, the table access is the one
// random access the algorithm needs. The TPU formulation (a colliding-free
// scatter plus a read-back gather to find duplicates) becomes an atomicCAS:
// a row that finds its slot taken by another row is the duplicate.
//
// The sorted probe is one thread per probe row binary-searching the lower
// bound of its key in the sorted build keys (log2(n) dependent reads, most of
// them in L2 for a build side of 100 K keys). The reference's concatenated
// merge sort existed only because TPU gathers are slow.
//
// qs_expand_probe replaces quickstep_tpu/ops/join.py:228 expand_probe (and
// the (start, count) of :189 merge_starts): one thread per probe row searches
// the lower bound of its key, walks at most K + 1 keys from there (a binary
// search finds the run's end only past them) and writes the first K build
// rows of the run, in stable sort order, into its K slots of the row-major
// output (-1 pads). The same launch raises the overflow flag when a live run
// is longer than K, which the executor answers with a retry at 4 K. The
// lower-bound search's dependent random reads bound it: a second search for
// the upper bound, as in the first version, doubled them.
//
// qs_run_stats_probe replaces ops/join.py:317 merge_cmp_probe and :247
// merge_stats_probe. The reference concatenates build and probe, sorts them
// together, takes segmented min/max by packed cummax scans and sorts back,
// all to avoid TPU gathers. Here the build keys are sorted once (torch.sort,
// dead rows at INT64_MAX); a first launch has the thread at each run's first
// sorted position walk its run and store the run's min and max of the int32
// build values there; a second launch has one thread per probe row find the
// lower bound of its key and read that run's stats. In compare mode it
// returns pmask & (a live build row has the key) & (pval OP the run's stat);
// in stats mode (matched, min, max), with (INT32_MAX, INT32_MIN) for a probe
// row that matches nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// K3 build. Table mode: table[key - lo] = row by atomicCAS from -1; a row
// that loses to ANOTHER row raises *dup. Which duplicate wins may differ from
// XLA's scatter, but only when the dup flag is set, and then the executor
// discards the result and retries on the expansion path.
// Presence mode (exact filter): the byte table[key - lo] = 1, no dup flag
// (semi-join builds repeat keys by design).
template <typename K, bool PRESENCE>
__global__ void __launch_bounds__(kThreads)
direct_build_kernel(const K* __restrict__ key, const uint8_t* __restrict__ alive,
                    int64_t n, int64_t lo, int64_t domain, void* table,
                    int* __restrict__ dup) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (!alive[i]) continue;
    const int64_t idx = (int64_t)key[i] - lo;
    if (idx < 0 || idx >= domain) continue;
    if constexpr (PRESENCE) {
      static_cast<uint8_t*>(table)[idx] = 1;
    } else {
      int* slot = static_cast<int*>(table) + idx;
      const int old = atomicCAS(slot, -1, (int)i);
      if (old != -1 && old != (int)i) atomicExch(dup, 1);
    }
  }
}

// K3 probe: one table read per live in-range probe row.
template <typename K, bool PRESENCE>
__global__ void __launch_bounds__(kThreads)
direct_probe_kernel(const K* __restrict__ key, const uint8_t* __restrict__ alive,
                    int64_t n, int64_t lo, int64_t domain,
                    const void* __restrict__ table, int* __restrict__ bidx,
                    uint8_t* __restrict__ matched) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t idx = (int64_t)key[i] - lo;
    bool hit = false;
    int b = -1;
    if (alive[i] && idx >= 0 && idx < domain) {
      if constexpr (PRESENCE) {
        hit = static_cast<const uint8_t*>(table)[idx] != 0;
      } else {
        b = static_cast<const int*>(table)[idx];
        hit = b >= 0;
      }
    }
    matched[i] = hit;
    if constexpr (!PRESENCE) bidx[i] = hit ? b : -1;
  }
}

// K4: for each live probe row, the first build row (in stable sorted order)
// whose key equals the probe key; dead build rows carry INT64_MAX and never
// match. Threads below n_build - 1 also test their adjacent sorted pair and
// raise *dup when two live build keys are equal.
__global__ void __launch_bounds__(kThreads)
sorted_probe_kernel(const long long* __restrict__ sorted_key,
                    const long long* __restrict__ order, int64_t n_build,
                    const long long* __restrict__ probe,
                    const uint8_t* __restrict__ pmask, int64_t n_probe,
                    int* __restrict__ bidx, uint8_t* __restrict__ matched,
                    int* __restrict__ dup) {
  const long long kDead = INT64_MAX;
  const int64_t total = n_probe > n_build ? n_probe : n_build;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += stride) {
    if (i + 1 < n_build && sorted_key[i] != kDead &&
        sorted_key[i] == sorted_key[i + 1]) {
      atomicExch(dup, 1);
    }
    if (i >= n_probe) continue;
    const long long k = probe[i];
    bool hit = false;
    int b = -1;
    if (pmask[i] && k != kDead) {
      int64_t lo = 0, hi = n_build;        // lower bound in [lo, hi)
      while (lo < hi) {
        const int64_t mid = lo + ((hi - lo) >> 1);
        if (sorted_key[mid] < k) lo = mid + 1;
        else hi = mid;
      }
      if (lo < n_build && sorted_key[lo] == k) {
        hit = true;
        b = (int)order[lo];
      }
    }
    matched[i] = hit;
    bidx[i] = b;
  }
}

// First position in [lo, hi) of sorted_key whose key is >= k (upper: > k).
template <bool UPPER>
__device__ __forceinline__ int64_t bound(const long long* __restrict__ a,
                                         int64_t lo, int64_t hi, long long k) {
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (UPPER ? a[mid] <= k : a[mid] < k) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// K7: the run [lb, ub) of equal build keys for every live probe row; rows
// receives order[lb + j] for j < min(count, k) in the row's k slots, -1 in
// the others; counts receives ub - lb (0 for dead rows and the dead key).
__global__ void __launch_bounds__(kThreads)
expand_probe_kernel(const long long* __restrict__ sorted_key,
                    const long long* __restrict__ order, int64_t n_build,
                    const long long* __restrict__ probe,
                    const uint8_t* __restrict__ alive, int64_t n_probe, int k,
                    int* __restrict__ rows, int* __restrict__ counts,
                    int* __restrict__ overflow) {
  const long long kDead = INT64_MAX;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_probe;
       i += stride) {
    const long long key = probe[i];
    int64_t lb = 0, count = 0;
    if (alive[i] && key != kDead) {
      lb = bound<false>(sorted_key, 0, n_build, key);
      const int64_t stop = lb + k + 1 < n_build ? lb + k + 1 : n_build;
      int64_t end = lb;
      while (end < stop && sorted_key[end] == key) ++end;
      if (end == lb + k + 1) end = bound<true>(sorted_key, end, n_build, key);
      count = end - lb;
    }
    counts[i] = (int)count;
    if (count > k) *overflow = 1;
    int* out = rows + i * k;
    for (int j = 0; j < k; ++j) out[j] = j < count ? (int)order[lb + j] : -1;
  }
}

// K8, first launch: at the first sorted position of every run of equal live
// keys, the min and max of the run's build values (read through the sort
// permutation). Other positions are not written.
__global__ void __launch_bounds__(kThreads)
run_stats_kernel(const long long* __restrict__ sorted_key,
                 const long long* __restrict__ order, int64_t n_build,
                 const int* __restrict__ bval, int* __restrict__ run_min,
                 int* __restrict__ run_max) {
  const long long kDead = INT64_MAX;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_build;
       i += stride) {
    const long long key = sorted_key[i];
    if (key == kDead || (i > 0 && sorted_key[i - 1] == key)) continue;
    int mn = INT32_MAX, mx = INT32_MIN;
    for (int64_t j = i; j < n_build && sorted_key[j] == key; ++j) {
      const int v = bval[order[j]];
      mn = v < mn ? v : mn;
      mx = v > mx ? v : mx;
    }
    run_min[i] = mn;
    run_max[i] = mx;
  }
}

enum CmpOp { kStats = -1, kNe = 0, kLt = 1, kLe = 2, kGt = 3, kGe = 4 };

// K8, second launch: one thread per probe row reads the stats of its key's
// run. Compare mode (op >= 0): matched = pmask & has_build & (pval OP stat).
// Stats mode: matched = pmask & has_build, and the run's min and max.
__global__ void __launch_bounds__(kThreads)
stats_probe_kernel(const long long* __restrict__ sorted_key, int64_t n_build,
                   const int* __restrict__ run_min,
                   const int* __restrict__ run_max,
                   const long long* __restrict__ probe,
                   const uint8_t* __restrict__ pmask,
                   const int* __restrict__ pval, int64_t n_probe, int op,
                   uint8_t* __restrict__ matched, int* __restrict__ out_min,
                   int* __restrict__ out_max) {
  const long long kDead = INT64_MAX;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n_probe;
       i += stride) {
    const long long key = probe[i];
    bool has = false;
    int mn = INT32_MAX, mx = INT32_MIN;
    if (key != kDead) {
      const int64_t lb = bound<false>(sorted_key, 0, n_build, key);
      if (lb < n_build && sorted_key[lb] == key) {
        has = true;
        mn = run_min[lb];
        mx = run_max[lb];
      }
    }
    if (op == kStats) {
      matched[i] = pmask[i] && has;
      out_min[i] = mn;
      out_max[i] = mx;
      continue;
    }
    bool hit = false;
    if (pmask[i] && has) {
      const int v = pval[i];
      switch (op) {
        case kNe: hit = mn != v || mx != v; break;
        case kLt: hit = v < mx; break;
        case kLe: hit = v <= mx; break;
        case kGt: hit = v > mn; break;
        default: hit = v >= mn; break;
      }
    }
    matched[i] = hit;
  }
}

enum KeyType { kKeyI32 = 0, kKeyI64 = 1 };

template <typename K, bool PRESENCE>
cudaError_t launch_build(const void* key, const void* alive, int64_t n,
                         int64_t lo, int64_t domain, void* table, void* dup,
                         int blocks, cudaStream_t stream) {
  direct_build_kernel<K, PRESENCE><<<blocks, kThreads, 0, stream>>>(
      (const K*)key, (const uint8_t*)alive, n, lo, domain, table, (int*)dup);
  return cudaGetLastError();
}

template <typename K, bool PRESENCE>
cudaError_t launch_probe(const void* key, const void* alive, int64_t n,
                         int64_t lo, int64_t domain, const void* table,
                         void* bidx, void* matched, int blocks,
                         cudaStream_t stream) {
  direct_probe_kernel<K, PRESENCE><<<blocks, kThreads, 0, stream>>>(
      (const K*)key, (const uint8_t*)alive, n, lo, domain, table, (int*)bidx,
      (uint8_t*)matched);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int qs_direct_build(int key_type, int presence, const void* key,
                    const void* alive, int64_t n, int64_t lo, int64_t domain,
                    void* table, void* dup, int blocks, void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (key_type == kKeyI32) {
    return presence ? launch_build<int, true>(key, alive, n, lo, domain, table, dup, blocks, s)
                    : launch_build<int, false>(key, alive, n, lo, domain, table, dup, blocks, s);
  }
  if (key_type == kKeyI64) {
    return presence ? launch_build<long long, true>(key, alive, n, lo, domain, table, dup, blocks, s)
                    : launch_build<long long, false>(key, alive, n, lo, domain, table, dup, blocks, s);
  }
  return cudaErrorInvalidValue;
}

int qs_direct_probe(int key_type, int presence, const void* key,
                    const void* alive, int64_t n, int64_t lo, int64_t domain,
                    const void* table, void* bidx, void* matched, int blocks,
                    void* stream) {
  if (n == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (key_type == kKeyI32) {
    return presence ? launch_probe<int, true>(key, alive, n, lo, domain, table, bidx, matched, blocks, s)
                    : launch_probe<int, false>(key, alive, n, lo, domain, table, bidx, matched, blocks, s);
  }
  if (key_type == kKeyI64) {
    return presence ? launch_probe<long long, true>(key, alive, n, lo, domain, table, bidx, matched, blocks, s)
                    : launch_probe<long long, false>(key, alive, n, lo, domain, table, bidx, matched, blocks, s);
  }
  return cudaErrorInvalidValue;
}

int qs_sorted_probe(const void* sorted_key, const void* order, int64_t n_build,
                    const void* probe, const void* pmask, int64_t n_probe,
                    void* bidx, void* matched, void* dup, int blocks,
                    void* stream) {
  if (n_build == 0 && n_probe == 0) return cudaSuccess;
  sorted_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)sorted_key, (const long long*)order, n_build,
      (const long long*)probe, (const uint8_t*)pmask, n_probe, (int*)bidx,
      (uint8_t*)matched, (int*)dup);
  return cudaGetLastError();
}

int qs_expand_probe(const void* sorted_key, const void* order,
                    int64_t n_build, const void* probe, const void* alive,
                    int64_t n_probe, int k, void* rows, void* counts,
                    void* overflow, int blocks, void* stream) {
  if (n_probe == 0) return cudaSuccess;
  if (k < 1) return cudaErrorInvalidValue;
  expand_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const long long*)sorted_key, (const long long*)order, n_build,
      (const long long*)probe, (const uint8_t*)alive, n_probe, k, (int*)rows,
      (int*)counts, (int*)overflow);
  return cudaGetLastError();
}

// op: -1 stats mode (out_min and out_max written), 0..4 compare mode with
// <>, <, <=, >, >= (pval read, out_min and out_max untouched). run_min and
// run_max are scratch of n_build entries.
int qs_run_stats_probe(const void* sorted_key, const void* order,
                       int64_t n_build, const void* bval, void* run_min,
                       void* run_max, const void* probe, const void* pmask,
                       const void* pval, int64_t n_probe, int op,
                       void* matched, void* out_min, void* out_max,
                       int build_blocks, int probe_blocks, void* stream) {
  if (op < kStats || op > kGe) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_build > 0) {
    run_stats_kernel<<<build_blocks, kThreads, 0, s>>>(
        (const long long*)sorted_key, (const long long*)order, n_build,
        (const int*)bval, (int*)run_min, (int*)run_max);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (n_probe == 0) return cudaSuccess;
  stats_probe_kernel<<<probe_blocks, kThreads, 0, s>>>(
      (const long long*)sorted_key, n_build, (const int*)run_min,
      (const int*)run_max, (const long long*)probe, (const uint8_t*)pmask,
      (const int*)pval, n_probe, op, (uint8_t*)matched, (int*)out_min,
      (int*)out_max);
  return cudaGetLastError();
}

}  // extern "C"
