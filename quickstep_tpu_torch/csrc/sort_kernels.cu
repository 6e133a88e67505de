// Scalar DISTINCT (K12) and ORDER BY key encoding (K13) for Hopper (sm_90a).
// Plain C interface, loaded with ctypes by quickstep_tpu_torch/ops/cuda.py;
// every function launches on the stream it is given, allocates nothing, and
// returns the cudaError_t of its launch.
//
// qs_run_starts replaces the boundary count of quickstep_tpu/ops/groupby.py
// :455 distinct_count and the boundary mask of exec/runner.py:837
// _dedup_values. Both sort the values with dead and NULL rows as the dtype's
// maximum (torch.sort, as in the sort group-by) and mark i < n_live &
// (i == 0 | s[i] != s[i - 1]). The TPU builds the shifted copy (jnp.roll) and
// the iota as full-width arrays; here one thread per sorted position reads
// s[i - 1] and s[i] (the neighbour is the previous thread's element, so the
// pair costs one coalesced read) and either writes the flag or counts it,
// with a warp reduction and one 64-bit atomic add per warp. n_live stays on
// the device, so no host synchronisation is needed. What bounds it on an
// H100: the sorted values read once (and, in flag mode, one byte written per
// row).
//
// qs_sort_key_encode replaces the key transforms of quickstep_tpu/ops/sort.py
// :21 order_permutation: DESC by negation (floats) or bitwise not (integers,
// booleans), NULL rows to the dtype's min or max as NULLS FIRST / LAST asks,
// then one order-preserving int64 per row, so that every key sorts as one
// int64 torch.sort. Floats map through their bits: -0.0 and 0.0 to 0, NaN to
// INT64_MAX, a negative float's magnitude bits flipped, which is the order
// jnp.lexsort gives them. The launch reads the key at the current
// permutation (out[i] = enc(key[perm[i]])), fusing the gather that the
// chained stable sort needs before each key. What bounds it on an H100: the
// permutation and the encoded key move coalesced; the key and its validity
// are read at random through the permutation, one sector per row except
// for the first key, whose permutation is the identity.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

enum { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3, kU8 = 4 };

template <typename T>
__global__ void __launch_bounds__(kThreads)
run_starts_kernel(const T* __restrict__ s, int64_t n,
                  const long long* __restrict__ n_live, bool* flags,
                  unsigned long long* count) {
  const long long live = *n_live;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  unsigned long long mine = 0;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const bool start = i < live && (i == 0 || s[i] != s[i - 1]);
    if (flags != nullptr) flags[i] = start;
    mine += start;
  }
  if (count != nullptr) {
    for (int off = 16; off > 0; off >>= 1)
      mine += __shfl_down_sync(0xffffffffu, mine, off);
    if ((threadIdx.x & 31) == 0 && mine) atomicAdd(count, mine);
  }
}

template <typename T>
int launch_run_starts(const void* s, int64_t n, const void* n_live,
                      void* flags, void* count, int blocks, cudaStream_t st) {
  run_starts_kernel<T><<<blocks, kThreads, 0, st>>>(
      (const T*)s, n, (const long long*)n_live, (bool*)flags,
      (unsigned long long*)count);
  return cudaGetLastError();
}

template <typename T> struct Enc;

template <> struct Enc<int> {
  static __device__ __forceinline__ long long run(int x, bool desc,
                                                  int null_mode) {
    if (desc) x = ~x;
    if (null_mode) x = null_mode < 0 ? INT32_MIN : INT32_MAX;
    return x;
  }
};

template <> struct Enc<long long> {
  static __device__ __forceinline__ long long run(long long x, bool desc,
                                                  int null_mode) {
    if (desc) x = ~x;
    if (null_mode) x = null_mode < 0 ? INT64_MIN : INT64_MAX;
    return x;
  }
};

template <> struct Enc<unsigned char> {
  static __device__ __forceinline__ long long run(unsigned char x, bool desc,
                                                  int null_mode) {
    long long v = x != 0;
    if (desc) v = 1 - v;
    if (null_mode) v = null_mode < 0 ? 0 : 1;
    return v;
  }
};

template <> struct Enc<float> {
  static __device__ __forceinline__ long long run(float x, bool desc,
                                                  int null_mode) {
    if (desc) x = -x;
    if (null_mode)
      x = __int_as_float(null_mode < 0 ? (int)0xff800000u : 0x7f800000);
    if (x != x) return INT64_MAX;
    if (x == 0.0f) return 0;
    const int b = __float_as_int(x);
    return b < 0 ? (long long)(b ^ 0x7fffffff) : (long long)b;
  }
};

template <> struct Enc<double> {
  static __device__ __forceinline__ long long run(double x, bool desc,
                                                  int null_mode) {
    if (desc) x = -x;
    if (null_mode)
      x = __longlong_as_double(null_mode < 0 ? (long long)0xfff0000000000000ULL
                                             : 0x7ff0000000000000LL);
    if (x != x) return INT64_MAX;
    if (x == 0.0) return 0;
    const long long b = __double_as_longlong(x);
    return b < 0 ? (b ^ INT64_MAX) : b;
  }
};

// null_mode per row: 0 valid, -1 NULL sorting first, +1 NULL sorting last
template <typename T>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const T* __restrict__ key, const bool* __restrict__ valid,
              const long long* __restrict__ perm, int64_t n, bool desc,
              int null_side, long long* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const int64_t j = perm != nullptr ? perm[i] : i;
    const int null_mode = (valid != nullptr && !valid[j]) ? null_side : 0;
    out[i] = Enc<T>::run(key[j], desc, null_mode);
  }
}

template <typename T>
int launch_encode(const void* key, const void* valid, const void* perm,
                  int64_t n, int desc, int null_side, void* out, int blocks,
                  cudaStream_t st) {
  encode_kernel<T><<<blocks, kThreads, 0, st>>>(
      (const T*)key, (const bool*)valid, (const long long*)perm, n, desc != 0,
      null_side, (long long*)out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// s: n sorted values of dtype; n_live: one int64 on the device; exactly one
// of flags (n bools) and count (one int64, 0) is given
int qs_run_starts(int dtype, const void* s, int64_t n, const void* n_live,
                  void* flags, void* count, int blocks, void* stream) {
  if ((flags == nullptr) == (count == nullptr)) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kI32: return launch_run_starts<int>(s, n, n_live, flags, count, blocks, st);
    case kI64: return launch_run_starts<long long>(s, n, n_live, flags, count, blocks, st);
    case kF32: return launch_run_starts<float>(s, n, n_live, flags, count, blocks, st);
    case kF64: return launch_run_starts<double>(s, n, n_live, flags, count, blocks, st);
    case kU8: return launch_run_starts<unsigned char>(s, n, n_live, flags, count, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

// out[i] = the order-preserving int64 of key[perm[i]] (perm may be null:
// the identity); valid may be null; null_side -1 puts NULLs first, +1 last
int qs_sort_key_encode(int dtype, const void* key, const void* valid,
                       const void* perm, int64_t n, int desc, int null_side,
                       void* out, int blocks, void* stream) {
  if (null_side != -1 && null_side != 1) return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case kI32: return launch_encode<int>(key, valid, perm, n, desc, null_side, out, blocks, st);
    case kI64: return launch_encode<long long>(key, valid, perm, n, desc, null_side, out, blocks, st);
    case kF32: return launch_encode<float>(key, valid, perm, n, desc, null_side, out, blocks, st);
    case kF64: return launch_encode<double>(key, valid, perm, n, desc, null_side, out, blocks, st);
    case kU8: return launch_encode<unsigned char>(key, valid, perm, n, desc, null_side, out, blocks, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
