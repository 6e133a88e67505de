// Key hashing (K10) and open addressing (K11) for Hopper (sm_90a). Plain C
// interface, loaded with ctypes by quickstep_tpu_torch/ops/cuda.py; every
// function launches on the stream it is given, allocates nothing, and
// returns the cudaError_t of its launch.
//
// qs_hash_keys replaces quickstep_tpu/ops/kernels.py:143 hash64 and :154
// hash_combine as the reference's callers use them (each int32 or int64 key
// column cast to int64, hashed, the hashes combined left to right): one
// thread per row reads the row's key columns once and writes one 64-bit hash,
// equal bit for bit to the reference's uint64. The hashed join keys and the
// TABLESAMPLE mask take their hashes from it, and open addressing (below)
// calls its device functions. The TPU computes the finalizer column by column with a full-width
// intermediate per column; here the row's hash stays in a register. What
// bounds it on an H100: the bytes of the key columns read once and of the
// hash written once, coalesced.
//
// qs_oa_build / qs_oa_probe replace quickstep_tpu/ops/join.py:83 oa_build and
// :135 oa_probe. The reference settles contenders in rounds of a scatter and
// a read-back inside a while_loop, because a TPU has no atomics. Here each
// live build row hashes its own key columns with K10's device functions
// (hash_row: each column cast to int64 as the reference casts it, floats
// truncating) and claims its slot with one atomicCAS of its row id into an
// empty (-1) slot; when the CAS loses, the row compares the occupant's key
// columns with its own: an equal key sets the dup flag and stops (the row is
// not inserted), any other key sends it to the next slot. A settled row is
// never evicted, the invariant the reference keeps at ops/join.py:111-114.
// With duplicate keys the first CAS wins, where the reference keeps the last
// scattered row; the matched rows and the dup flag are the same, and the row
// index is the same wherever the build keys are unique. The probe hashes its
// row the same way and walks from that slot to an equal key (its row) or an
// empty slot (no match).
//
// What bounds them on an H100: random 32-byte sectors. The table is
// next_pow2(2 x build rows) int32 (512 MiB for 60 M build rows), far beyond
// the 50 MB L2, so each slot touched is a DRAM sector, and comparing an
// occupant's keys reads one more sector per key column. At a load factor at
// most 1/2 the expected walk is short; the key and mask reads are coalesced.

#include "hash_device.cuh"

namespace {

constexpr int kThreads = 256;

// SQL equality of row a of keys x and row b of keys y (same dtypes)
__device__ __forceinline__ bool keys_equal(const Keys& x, int64_t a,
                                           const Keys& y, int64_t b) {
  for (int c = 0; c < x.n; ++c) {
    bool eq;
    switch (x.dtype[c]) {
      case kI32:
        eq = static_cast<const int*>(x.col[c])[a] ==
             static_cast<const int*>(y.col[c])[b];
        break;
      case kI64:
        eq = static_cast<const long long*>(x.col[c])[a] ==
             static_cast<const long long*>(y.col[c])[b];
        break;
      case kF32:
        eq = static_cast<const float*>(x.col[c])[a] ==
             static_cast<const float*>(y.col[c])[b];
        break;
      case kF64:
        eq = static_cast<const double*>(x.col[c])[a] ==
             static_cast<const double*>(y.col[c])[b];
        break;
      default:
        eq = static_cast<const unsigned char*>(x.col[c])[a] ==
             static_cast<const unsigned char*>(y.col[c])[b];
        break;
    }
    if (!eq) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads)
hash_keys_kernel(const Keys keys, int64_t n, unsigned long long* out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride)
    out[i] = hash_row(keys, i);
}

__global__ void __launch_bounds__(kThreads)
oa_build_kernel(const Keys keys, const bool* __restrict__ alive, int64_t n,
                int* table, unsigned long long mask, int* dup) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (!alive[i]) continue;
    unsigned long long slot = hash_row(keys, i) & mask;
    while (true) {
      const int prev = atomicCAS(&table[slot], -1, (int)i);
      if (prev == -1) break;
      if (keys_equal(keys, prev, keys, i)) {
        *dup = 1;
        break;
      }
      slot = (slot + 1) & mask;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
oa_probe_kernel(const int* __restrict__ table, unsigned long long size,
                const Keys build, const Keys probe,
                const bool* __restrict__ alive, int64_t n, int* out,
                bool* matched) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const unsigned long long mask = size - 1;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    int res = -1;
    if (alive[i]) {
      unsigned long long slot = hash_row(probe, i) & mask;
      for (unsigned long long step = 0; step < size; ++step) {
        const int occ = table[slot];
        if (occ < 0) break;
        if (keys_equal(build, occ, probe, i)) {
          res = occ;
          break;
        }
        slot = (slot + 1) & mask;
      }
    }
    out[i] = res;
    matched[i] = res >= 0;
  }
}

}  // namespace

extern "C" {

// cols and dtypes are host arrays of ncols entries (1 <= ncols <= kMaxKeys)
int qs_hash_keys(int ncols, const void* const* cols, const int* dtypes,
                 int64_t n, void* out, int blocks, void* stream) {
  Keys keys;
  int err = make_keys(ncols, cols, dtypes, &keys);
  if (err != cudaSuccess) return err;
  if (n == 0) return cudaSuccess;
  hash_keys_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, n, (unsigned long long*)out);
  return cudaGetLastError();
}

// table: table_size int32 entries, all -1, table_size a power of two above
// the number of live rows; dup: one int32, 0
int qs_oa_build(int ncols, const void* const* cols, const int* dtypes,
                const void* alive, int64_t n, void* table, int64_t table_size,
                void* dup, int blocks, void* stream) {
  Keys keys;
  int err = make_keys(ncols, cols, dtypes, &keys);
  if (err != cudaSuccess) return err;
  if (table_size < 1 || (table_size & (table_size - 1)) != 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  oa_build_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, (const bool*)alive, n, (int*)table,
      (unsigned long long)(table_size - 1), (int*)dup);
  return cudaGetLastError();
}

// build and probe key columns pair up with equal dtypes
int qs_oa_probe(const void* table, int64_t table_size, int ncols,
                const void* const* bcols, const void* const* pcols,
                const int* dtypes, const void* alive, int64_t n, void* out,
                void* matched, int blocks, void* stream) {
  Keys build, probe;
  int err = make_keys(ncols, bcols, dtypes, &build);
  if (err != cudaSuccess) return err;
  err = make_keys(ncols, pcols, dtypes, &probe);
  if (err != cudaSuccess) return err;
  if (table_size < 1 || (table_size & (table_size - 1)) != 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  oa_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)table, (unsigned long long)table_size,
      build, probe, (const bool*)alive, n, (int*)out, (bool*)matched);
  return cudaGetLastError();
}

}  // extern "C"
