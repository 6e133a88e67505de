// Join kernels for Hopper (sm_90a): the direct-address table (K3) and the
// sorted-build probe (K4). Plain C interface, loaded with ctypes by
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

}  // extern "C"
