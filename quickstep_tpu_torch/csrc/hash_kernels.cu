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
// K11, open addressing, replaces quickstep_tpu/ops/join.py:83 oa_build and
// :135 oa_probe. The reference settles contenders in rounds of a scatter and
// a read-back inside a while_loop, because a TPU has no atomics. Here each
// live build row claims a slot of a linear-probing table with one atomic
// compare-and-swap, and a settled row is never evicted (the invariant the
// reference keeps at ops/join.py:111-114). With duplicate keys the first
// CAS wins where the reference keeps the last scattered row: the matched
// rows and the dup flag are the same, and the row is the same wherever the
// build keys are unique. Two routes, chosen by ops/cuda.py from the key
// dtypes on the host:
//
// - Key in the slot (qs_oa_word_build / qs_oa_word_probe), for keys made of
//   integer columns (int32, int64, uint8) whose widths add up to at most 64
//   bits. A row's columns are bit-concatenated into one 64-bit word, which
//   is injective, and a slot is 16 bytes: the word, then the row id. The
//   build reads its slot with a plain load first and only then tries the
//   CAS of its word into an empty slot, so a hot key (millions of rows on
//   one key) costs reads of one cached line, not millions of serialised
//   atomics; meeting its own word there makes the row a duplicate without
//   reading any key column. The winner writes its row id beside the word.
//   The probe compares slot words with its own word: one random 32-byte
//   sector a step, the row id coming in the same sector. The all-ones
//   word marks an empty slot; the one key that packs to it is kept apart,
//   in a device int32 holding its row.
// - Row ids only (qs_oa_build / qs_oa_probe), for float keys (hashed by
//   their int64 truncation and compared by value: -0.0 equals 0.0 and NaN
//   equals nothing, so their bits cannot be the key), wider keys and
//   nullable keys whose validity columns take the width past 64 bits. Each
//   live build row hashes its key columns with K10's device functions
//   (hash_row), reads its slot, and on an occupied slot compares the
//   occupant's key columns with its own; only an empty slot is tried with
//   atomicCAS. The probe walks from the same hash, comparing key columns.
//
// What bounds them on an H100: random 32-byte sectors. The table has
// next_pow2(2 x build rows) slots, far beyond the 50 MB L2 at SF10 sizes,
// so each slot touched is a DRAM sector; the row-id route pays one more
// sector for each key column compared. Key and mask reads are coalesced,
// and the dup flag is reduced in the block, one store a block.

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
  bool seen_dup = false;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (!alive[i]) continue;
    unsigned long long slot = hash_row(keys, i) & mask;
    while (true) {
      int occ = __ldcg(&table[slot]);
      if (occ == -1) {
        occ = atomicCAS(&table[slot], -1, (int)i);
        if (occ == -1) break;
      }
      if (keys_equal(keys, occ, keys, i)) {
        seen_dup = true;
        break;
      }
      slot = (slot + 1) & mask;
    }
  }
  if (__syncthreads_or(seen_dup) && threadIdx.x == 0) *dup = 1;
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

// ---------------------------------------------------------------------
// the key-in-slot route
// ---------------------------------------------------------------------
constexpr unsigned long long kEmptyWord = ~0ULL;

// The row's key columns bit-concatenated, the first column highest; the
// host allows at most 64 bits in all, so an int64 column is the only one.
__device__ __forceinline__ unsigned long long pack_word(const Keys& k,
                                                        int64_t i) {
  unsigned long long w = 0;
  for (int c = 0; c < k.n; ++c) {
    switch (k.dtype[c]) {
      case kI32:
        w = (w << 32) |
            (unsigned int)static_cast<const int*>(k.col[c])[i];
        break;
      case kI64:
        w = (unsigned long long)static_cast<const long long*>(k.col[c])[i];
        break;
      default:
        w = (w << 8) | static_cast<const unsigned char*>(k.col[c])[i];
        break;
    }
  }
  return w;
}

// slots: two 8-byte words a slot, the key word then the row id in the low
// 32 bits of the second (little endian), all ones when empty
__global__ void __launch_bounds__(kThreads)
oa_word_build_kernel(const Keys keys, const bool* __restrict__ alive,
                     int64_t n, unsigned long long* slots,
                     unsigned long long mask, int* special, int* dup) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  bool seen_dup = false;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (!alive[i]) continue;
    const unsigned long long w = pack_word(keys, i);
    if (w == kEmptyWord) {
      seen_dup |= __ldcg(special) != -1 || atomicCAS(special, -1, (int)i) != -1;
      continue;
    }
    unsigned long long slot = qs_mix64(w) & mask;
    while (true) {
      unsigned long long* key = slots + 2 * slot;
      unsigned long long cur = __ldcg(key);
      if (cur == kEmptyWord) {
        cur = atomicCAS(key, kEmptyWord, w);
        if (cur == kEmptyWord) {
          reinterpret_cast<int*>(key + 1)[0] = (int)i;
          break;
        }
      }
      if (cur == w) {
        seen_dup = true;
        break;
      }
      slot = (slot + 1) & mask;
    }
  }
  if (__syncthreads_or(seen_dup) && threadIdx.x == 0) *dup = 1;
}

__global__ void __launch_bounds__(kThreads)
oa_word_probe_kernel(const ulonglong2* __restrict__ slots,
                     unsigned long long size, const int* __restrict__ special,
                     const Keys probe, const bool* __restrict__ alive,
                     int64_t n, int* out, bool* matched) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const unsigned long long mask = size - 1;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    int res = -1;
    if (alive[i]) {
      const unsigned long long w = pack_word(probe, i);
      if (w == kEmptyWord) {
        res = *special;
      } else {
        unsigned long long slot = qs_mix64(w) & mask;
        for (unsigned long long step = 0; step < size; ++step) {
          const ulonglong2 s = __ldg(&slots[slot]);
          if (s.x == w) {
            res = (int)(unsigned int)s.y;
            break;
          }
          if (s.x == kEmptyWord) break;
          slot = (slot + 1) & mask;
        }
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

// slots: 2 x table_size int64 words, all ones (-1); special: one int32,
// -1; dup: one int32, 0. The caller has checked that the key columns take
// the key-in-slot route (ops/cuda.py oa_word_route).
int qs_oa_word_build(int ncols, const void* const* cols, const int* dtypes,
                     const void* alive, int64_t n, void* slots,
                     int64_t table_size, void* special, void* dup, int blocks,
                     void* stream) {
  Keys keys;
  int err = make_keys(ncols, cols, dtypes, &keys);
  if (err != cudaSuccess) return err;
  if (table_size < 1 || (table_size & (table_size - 1)) != 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  oa_word_build_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      keys, (const bool*)alive, n, (unsigned long long*)slots,
      (unsigned long long)(table_size - 1), (int*)special, (int*)dup);
  return cudaGetLastError();
}

// the probe's key columns in the build's dtypes
int qs_oa_word_probe(const void* slots, int64_t table_size,
                     const void* special, int ncols, const void* const* pcols,
                     const int* dtypes, const void* alive, int64_t n,
                     void* out, void* matched, int blocks, void* stream) {
  Keys probe;
  int err = make_keys(ncols, pcols, dtypes, &probe);
  if (err != cudaSuccess) return err;
  if (table_size < 1 || (table_size & (table_size - 1)) != 0)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  oa_word_probe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const ulonglong2*)slots, (unsigned long long)table_size,
      (const int*)special, probe, (const bool*)alive, n, (int*)out,
      (bool*)matched);
  return cudaGetLastError();
}

}  // extern "C"
