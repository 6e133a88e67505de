// K10's device functions: the SplitMix64 finalizer of
// quickstep_tpu/ops/kernels.py:143 hash64, :154 hash_combine, and the row
// hash over up to kMaxKeys key columns that the reference's callers take
// (each column cast to int64, floats truncating, hashed, combined left to
// right). Included by hash_kernels.cu (K10, K11) and shuffle_kernels.cu
// (K14, K16), so that every hashed path computes the same bits.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxKeys = 16;

// key dtypes, as ops/cuda.py passes them
enum { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3, kU8 = 4 };

struct Keys {
  const void* col[kMaxKeys];
  int dtype[kMaxKeys];
  int n;
};

__device__ __forceinline__ unsigned long long qs_mix64(unsigned long long h) {
  h = (h ^ (h >> 30)) * 0xBF58476D1CE4E5B9ULL;
  h = (h ^ (h >> 27)) * 0x94D049BB133111EBULL;
  return h ^ (h >> 31);
}

__device__ __forceinline__ unsigned long long qs_combine(
    unsigned long long out, unsigned long long h) {
  return out ^ (h + 0x9E3779B97F4A7C15ULL + (out << 6) + (out >> 2));
}

// a key's int64 value, as the reference's astype(int64) gives it
__device__ __forceinline__ unsigned long long key_bits(const Keys& k, int c,
                                                       int64_t i) {
  switch (k.dtype[c]) {
    case kI32:
      return (unsigned long long)(long long)static_cast<const int*>(
          k.col[c])[i];
    case kI64:
      return (unsigned long long)static_cast<const long long*>(k.col[c])[i];
    case kF32:
      return (unsigned long long)(long long)static_cast<const float*>(
          k.col[c])[i];
    case kF64:
      return (unsigned long long)(long long)static_cast<const double*>(
          k.col[c])[i];
    default:
      return static_cast<const unsigned char*>(k.col[c])[i];
  }
}

// hash_combine of hash64 of each key column of row i
__device__ __forceinline__ unsigned long long hash_row(const Keys& k,
                                                       int64_t i) {
  unsigned long long h = qs_mix64(key_bits(k, 0, i));
  for (int c = 1; c < k.n; ++c) h = qs_combine(h, qs_mix64(key_bits(k, c, i)));
  return h;
}

int make_keys(int ncols, const void* const* cols, const int* dtypes,
              Keys* keys) {
  if (ncols < 1 || ncols > kMaxKeys) return cudaErrorInvalidValue;
  keys->n = ncols;
  for (int c = 0; c < kMaxKeys; ++c) {
    keys->col[c] = c < ncols ? cols[c] : nullptr;
    keys->dtype[c] = c < ncols ? dtypes[c] : 0;
    if (c < ncols && (dtypes[c] < kI32 || dtypes[c] > kU8))
      return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace
