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
// qs_order_permutation replaces quickstep_tpu/ops/sort.py:21
// order_permutation, the reference's jnp.lexsort of the transformed keys with
// ~alive as the most significant key. It runs one LSD chain of key-value
// radix sorts (radix_device.cuh), last key first, whose payload is the int32
// row id: each key is encoded as the reference transforms it (DESC by
// negation for floats, bitwise not for integers and booleans; NULL rows at
// the dtype's minimum or maximum as NULLS FIRST / LAST asks), mapped to an
// order-preserving unsigned code (floats through their bits, -0.0 equal to
// 0.0, every NaN above +inf), range-compressed over its non-NULL rows (dead
// rows included: they are sorted by their keys too), and sorted through the
// digits that vary only. The first key sorted (the least significant) is
// encoded in input order; each later key is read at the current
// permutation, one gather. A last one-digit sort by the dead flag at the
// permutation puts the dead rows after the live ones, each in key order,
// and one launch widens the int32 permutation to int64. No library sort
// runs. What bounds it on an H100: the bytes of the passes that run (8 or
// 12 a record, read and written once a pass) and one random gather of a
// key and its validity a row for every key but the first.

#include <cuda_runtime.h>
#include <stdint.h>

#include "radix_device.cuh"

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

// The order-preserving unsigned code of a key value after the reference's
// DESC transform, in the dtype's own code space (kTop its largest code;
// kPasses its 8-bit digits): integers with the sign bit flipped; floats with
// -0.0 and 0.0 at one code, every NaN at kTop, a negative float's bits
// inverted and a positive float's sign bit set; booleans as 0 / 1.
template <typename D> struct KeyCode;

template <> struct KeyCode<int> {
  static constexpr int kPasses = 4;
  static constexpr unsigned long long kTop = 0xffffffffull;
  static __device__ __forceinline__ unsigned long long of(int x, bool desc) {
    if (desc) x = ~x;
    return (unsigned)x ^ 0x80000000u;
  }
};

template <> struct KeyCode<long long> {
  static constexpr int kPasses = 8;
  static constexpr unsigned long long kTop = ~0ull;
  static __device__ __forceinline__ unsigned long long of(long long x,
                                                          bool desc) {
    if (desc) x = ~x;
    return (unsigned long long)x ^ 0x8000000000000000ull;
  }
};

template <> struct KeyCode<float> {
  static constexpr int kPasses = 4;
  static constexpr unsigned long long kTop = 0xffffffffull;
  static __device__ __forceinline__ unsigned long long of(float x,
                                                          bool desc) {
    if (desc) x = -x;
    if (x != x) return kTop;
    if (x == 0.0f) return 0x80000000u;
    const unsigned b = __float_as_uint(x);
    return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  }
};

template <> struct KeyCode<double> {
  static constexpr int kPasses = 8;
  static constexpr unsigned long long kTop = ~0ull;
  static __device__ __forceinline__ unsigned long long of(double x,
                                                          bool desc) {
    if (desc) x = -x;
    if (x != x) return kTop;
    if (x == 0.0) return 0x8000000000000000ull;
    const unsigned long long b = (unsigned long long)__double_as_longlong(x);
    return (b & 0x8000000000000000ull) ? ~b : (b | 0x8000000000000000ull);
  }
};

template <> struct KeyCode<unsigned char> {   // bool, as 0 / 1 bytes
  static constexpr int kPasses = 1;
  static constexpr unsigned long long kTop = 1;
  static __device__ __forceinline__ unsigned long long of(unsigned char x,
                                                          bool desc) {
    return (x != 0) != desc;
  }
};

// The code of a NULL row: the dtype's minimum (first) or maximum, which the
// reference puts in after the DESC transform (ops/kernels.py sentinels).
unsigned long long null_code(int dtype, bool first) {
  switch (dtype) {
    case kI32: return first ? 0 : 0xffffffffull;
    case kI64: return first ? 0 : ~0ull;
    case kF32: return first ? 0x007fffffull : 0xff800000ull;  // -inf, +inf
    case kF64: return first ? 0x000fffffffffffffull : 0xfff0000000000000ull;
    default: return first ? 0 : 1;
  }
}

// One key of the chain as a source of the key-value sort: raw() is the
// code of row i in input order for the range (NULL rows do not count),
// code() the range-compressed code of the row at sorted position i (perm
// null: the identity), a NULL row's clamped into the range.
template <typename D>
struct KeySrc {
  const D* key;
  const uint8_t* valid;
  const int* perm;
  bool desc;
  unsigned long long null;
  __device__ __forceinline__ bool raw(int64_t i,
                                      unsigned long long& u) const {
    u = KeyCode<D>::of(key[i], desc);
    return valid == nullptr || valid[i];
  }
  __device__ __forceinline__ unsigned long long code(
      int64_t i, unsigned long long lo, unsigned long long hi) const {
    const int64_t j = perm != nullptr ? perm[i] : i;
    unsigned long long u = (valid != nullptr && !valid[j])
                               ? null : KeyCode<D>::of(key[j], desc);
    u = u < lo ? lo : (u > hi ? hi : u);
    return u - lo;
  }
};

// The dead flag at the permutation: the chain's most significant digit.
struct DeadSrc {
  const uint8_t* alive;
  const int* perm;
  __device__ __forceinline__ unsigned long long code(
      int64_t i, unsigned long long, unsigned long long) const {
    return alive[perm != nullptr ? perm[i] : i] ? 0 : 1;
  }
};

__global__ void __launch_bounds__(kThreads)
widen_kernel(const int* __restrict__ perm, int64_t n,
             long long* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    out[i] = perm[i];
  }
}

// One key of the chain: its range, then the key-value sort of its codes
// carrying the permutation (b.vals_in; null for the first key sorted).
template <typename D>
cudaError_t sort_key(const void* key, const void* valid, bool desc,
                     bool first, int dtype, int64_t n, radix::Span* span,
                     const radix::KvBufs& b, void* scratch, int blocks,
                     int pass_blocks, cudaStream_t st) {
  const KeySrc<D> src = {(const D*)key, (const uint8_t*)valid, b.vals_in,
                         desc, null_code(dtype, first)};
  cudaError_t err = radix::reduce_range(src, n, span, KeyCode<D>::kTop,
                                        blocks, st);
  if (err != cudaSuccess) return err;
  constexpr int P = KeyCode<D>::kPasses;
  return radix::kv_sort<P>(src, span, n, true, b, scratch,
                           P > 4 ? &span->narrow : nullptr, blocks,
                           pass_blocks, st);
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

// The 64-bit words of the spans scratch of qs_order_permutation, per key.
int64_t qs_span_words() { return sizeof(radix::Span) / 8; }

// out (int64, n) = the stable permutation of the n rows by the n_keys keys
// (keys[0] most significant; dtypes, desc and nulls_first per key; valids
// entries may be null), the dead rows after the live ones. Scratch: codes
// 3 n int64 words, vals 3 n int32, spans n_keys * qs_span_words() words,
// scratch qs_kv_scratch_words(n) words. n < 2^31.
int qs_order_permutation(int n_keys, const int* dtypes,
                         const void* const* keys, const void* const* valids,
                         const int* desc, const int* nulls_first,
                         const void* alive, int64_t n, void* out, void* codes,
                         void* vals, void* spans, void* scratch, int blocks,
                         int pass_blocks, void* stream) {
  if (n < 0 || n >= (1ll << 31) || n_keys < 0 || blocks < 1 ||
      pass_blocks < 1)
    return cudaErrorInvalidValue;
  if (n == 0) return cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* c = (unsigned long long*)codes;
  int* v = (int*)vals;
  const int* perm = nullptr;   // the current permutation (null: identity)
  int cur = 2;                 // the buffer that holds it
  cudaError_t err = cudaSuccess;
  // keys n_keys - 1 down to 0, then the dead flag
  for (int k = n_keys - 1; k >= -1 && err == cudaSuccess; --k) {
    const int o = (cur + 1) % 3, t = (cur + 2) % 3;
    const radix::KvBufs b = {c, perm, c + n, v + o * n, c + 2 * n, v + t * n};
    if (k < 0) {
      err = radix::kv_sort<1>(DeadSrc{(const uint8_t*)alive, perm}, nullptr,
                              n, true, b, scratch, nullptr, blocks,
                              pass_blocks, st);
    } else {
      radix::Span* span = (radix::Span*)spans + k;
      const bool d = desc[k] != 0, f = nulls_first[k] != 0;
      switch (dtypes[k]) {
        case kI32: err = sort_key<int>(keys[k], valids[k], d, f, kI32, n, span, b, scratch, blocks, pass_blocks, st); break;
        case kI64: err = sort_key<long long>(keys[k], valids[k], d, f, kI64, n, span, b, scratch, blocks, pass_blocks, st); break;
        case kF32: err = sort_key<float>(keys[k], valids[k], d, f, kF32, n, span, b, scratch, blocks, pass_blocks, st); break;
        case kF64: err = sort_key<double>(keys[k], valids[k], d, f, kF64, n, span, b, scratch, blocks, pass_blocks, st); break;
        case kU8: err = sort_key<unsigned char>(keys[k], valids[k], d, f, kU8, n, span, b, scratch, blocks, pass_blocks, st); break;
        default: return cudaErrorInvalidValue;
      }
    }
    perm = v + o * n;
    cur = o;
  }
  if (err != cudaSuccess) return err;
  widen_kernel<<<blocks, kThreads, 0, st>>>(perm, n, (long long*)out);
  return cudaGetLastError();
}

}  // extern "C"
