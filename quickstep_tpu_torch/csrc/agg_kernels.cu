// Aggregation kernels for Hopper (sm_90a): the masked scalar reduce, the
// dense (collision-free) group-by and the segmented reduce of the sort
// group-by. Plain C interface, loaded with ctypes by
// quickstep_tpu_torch/ops/cuda.py; every function launches on the stream it is
// given, allocates nothing, and returns the cudaError_t of its launches.
//
// qs_masked_reduce replaces quickstep_tpu/ops/groupby.py:435 scalar_agg (and
// the retired Pallas scan kernel, ops/pallas_scan.py:57 _pallas_scan_agg).
// qs_dense_group_reduce replaces quickstep_tpu/ops/groupby.py:56
// dense_groupby (_dense_groupby_broadcast :72 / _dense_groupby_scatter :110,
// and the retired Pallas kernel ops/pallas_groupby.py:95 _run).
// qs_segment_reduce replaces the segmented reductions of
// quickstep_tpu/ops/groupby.py:204 sort_groupby (:146 _seg_fill, :187
// _seg_minmax32 and the prefix-sum differences); the sort itself is
// torch.sort. The TPU formulation (packed cummax scans, differences of
// prefix sums) existed because TPU gathers and scatters are slow; here the
// thread at a group's first row sums the group directly, which also makes
// float64 sums more exact than the reference's.
//
// What bounds them on an H100: bytes read from device memory. Each row is
// touched once; per row the scalar reduce reads 1 byte of live mask, 1 byte
// of validity when the column is nullable and the value itself (4 or 8
// bytes), and does a handful of ALU operations, far below the card's
// ~300 operations per byte. The design therefore streams each column once
// with coalesced grid-stride loads, keeps every partial result in registers
// or shared memory, and writes only one partial per block (scalar) or one
// [domain] table per block (group-by) to device memory before a second tiny
// launch folds the partials in a fixed order.
//
// Results: integer sums, counts, minima and maxima are exact. The scalar
// reduce is deterministic (fixed grid, fixed shuffle tree). The group-by's
// floating-point sums go through shared-memory atomics, whose order varies
// from run to run, so they may differ in the last bits between runs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Fn { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };
enum DType { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxDomain = 128;

template <typename A> __device__ __forceinline__ A lowest();
template <typename A> __device__ __forceinline__ A highest();
template <> __device__ __forceinline__ int lowest<int>() { return INT32_MIN; }
template <> __device__ __forceinline__ int highest<int>() { return INT32_MAX; }
template <> __device__ __forceinline__ long long lowest<long long>() { return INT64_MIN; }
template <> __device__ __forceinline__ long long highest<long long>() { return INT64_MAX; }
template <> __device__ __forceinline__ float lowest<float>() { return __uint_as_float(0xff800000u); }
template <> __device__ __forceinline__ float highest<float>() { return __uint_as_float(0x7f800000u); }
template <> __device__ __forceinline__ double lowest<double>() { return __longlong_as_double((long long)0xfff0000000000000ULL); }
template <> __device__ __forceinline__ double highest<double>() { return __longlong_as_double(0x7ff0000000000000LL); }

// The identity of each reduction: 0 for sums and counts, the reference's
// max/min sentinels (ops/kernels.py:175-196) for MIN/MAX.
template <int FN, typename A>
__device__ __forceinline__ A identity() {
  if constexpr (FN == kMin) return highest<A>();
  else if constexpr (FN == kMax) return lowest<A>();
  else return A(0);
}

template <typename A>
__device__ __forceinline__ bool is_nan(A x) {
  if constexpr (std::is_floating_point<A>::value) return x != x;
  else return false;
}

// MIN/MAX let a NaN win, as jnp.min/jnp.max and torch's min/max do.
template <int FN, typename A>
__device__ __forceinline__ A combine(A a, A b) {
  if constexpr (FN == kMin) return (b < a || is_nan(b)) ? b : a;
  else if constexpr (FN == kMax) return (b > a || is_nan(b)) ? b : a;
  else if constexpr (FN == kSum) return a + b;
  else return a;
}

// Block-wide reduction of (value, count): warp shuffles, one slot per warp in
// shared memory, then the first warp. The result is valid in thread 0.
template <int FN, typename A>
__device__ __forceinline__ void block_reduce(A& v, long long& c) {
  __shared__ A s_v[kWarps];
  __shared__ long long s_c[kWarps];
  for (int off = 16; off > 0; off >>= 1) {
    v = combine<FN, A>(v, __shfl_down_sync(0xffffffffu, v, off));
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_v[warp] = v;
    s_c[warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_v[lane] : identity<FN, A>();
    c = lane < kWarps ? s_c[lane] : 0;
    for (int off = 16; off > 0; off >>= 1) {
      v = combine<FN, A>(v, __shfl_down_sync(0xffffffffu, v, off));
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
  }
}

// ---------------------------------------------------------------------
// K1: masked scalar reduce. Pass 1: one (value, count) partial per block.
// ---------------------------------------------------------------------
template <int FN, typename T, typename A>
__global__ void __launch_bounds__(kThreads)
masked_reduce_partial(const T* __restrict__ vals,
                      const uint8_t* __restrict__ valid,
                      const uint8_t* __restrict__ alive, int64_t n,
                      A* __restrict__ part_val,
                      long long* __restrict__ part_cnt) {
  A acc = identity<FN, A>();
  long long cnt = 0;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const bool live = alive[i] && (valid == nullptr || valid[i]);
    if (live) {
      cnt += 1;
      if constexpr (FN != kCount) acc = combine<FN, A>(acc, (A)vals[i]);
    }
  }
  block_reduce<FN, A>(acc, cnt);
  if (threadIdx.x == 0) {
    part_val[blockIdx.x] = acc;
    part_cnt[blockIdx.x] = cnt;
  }
}

// Pass 2: one block folds the per-block partials in a fixed order.
template <int FN, typename A, typename O>
__global__ void __launch_bounds__(kThreads)
masked_reduce_final(const A* __restrict__ part_val,
                    const long long* __restrict__ part_cnt, int blocks,
                    O* __restrict__ out_val, long long* __restrict__ out_cnt) {
  A acc = identity<FN, A>();
  long long cnt = 0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    acc = combine<FN, A>(acc, part_val[b]);
    cnt += part_cnt[b];
  }
  block_reduce<FN, A>(acc, cnt);
  if (threadIdx.x == 0) {
    if constexpr (FN != kCount) *out_val = (O)acc;
    *out_cnt = cnt;
  }
}

template <int FN, typename T, typename A, typename O>
cudaError_t launch_masked_reduce(const void* vals, const void* valid,
                                 const void* alive, int64_t n, void* part_val,
                                 void* part_cnt, int blocks, void* out_val,
                                 void* out_cnt, cudaStream_t stream) {
  masked_reduce_partial<FN, T, A><<<blocks, kThreads, 0, stream>>>(
      (const T*)vals, (const uint8_t*)valid, (const uint8_t*)alive, n,
      (A*)part_val, (long long*)part_cnt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  masked_reduce_final<FN, A, O><<<1, kThreads, 0, stream>>>(
      (const A*)part_val, (const long long*)part_cnt, blocks, (O*)out_val,
      (long long*)out_cnt);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// K2: dense group-by. Each warp owns a [domain] accumulator table in shared
// memory, so shared-memory atomics collide only within a warp; the block
// folds its warps' tables into one [domain] partial, and pass 2 folds the
// per-block partials per group.
// ---------------------------------------------------------------------
__device__ __forceinline__ void atomic_add(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void atomic_add(double* p, double v) { atomicAdd(p, v); }

__device__ __forceinline__ void atomic_min(int* p, int v) { atomicMin(p, v); }
__device__ __forceinline__ void atomic_max(int* p, int v) { atomicMax(p, v); }
__device__ __forceinline__ void atomic_min(long long* p, long long v) { atomicMin(p, v); }
__device__ __forceinline__ void atomic_max(long long* p, long long v) { atomicMax(p, v); }

// Whether v takes the place of the stored cur: a NaN wins and stays.
template <bool MIN, typename A>
__device__ __forceinline__ bool replaces(A v, A cur) {
  if (is_nan(v)) return !is_nan(cur);
  return MIN ? v < cur : v > cur;
}

template <bool MIN>
__device__ __forceinline__ void atomic_minmax_f(float* p, float v) {
  unsigned int* a = reinterpret_cast<unsigned int*>(p);
  unsigned int old = *a;
  while (replaces<MIN>(v, __uint_as_float(old))) {
    const unsigned int assumed = old;
    old = atomicCAS(a, assumed, __float_as_uint(v));
    if (old == assumed) break;
  }
}
template <bool MIN>
__device__ __forceinline__ void atomic_minmax_f(double* p, double v) {
  unsigned long long* a = reinterpret_cast<unsigned long long*>(p);
  unsigned long long old = *a;
  while (replaces<MIN>(v, __longlong_as_double(old))) {
    const unsigned long long assumed = old;
    old = atomicCAS(a, assumed, (unsigned long long)__double_as_longlong(v));
    if (old == assumed) break;
  }
}
__device__ __forceinline__ void atomic_min(float* p, float v) { atomic_minmax_f<true>(p, v); }
__device__ __forceinline__ void atomic_max(float* p, float v) { atomic_minmax_f<false>(p, v); }
__device__ __forceinline__ void atomic_min(double* p, double v) { atomic_minmax_f<true>(p, v); }
__device__ __forceinline__ void atomic_max(double* p, double v) { atomic_minmax_f<false>(p, v); }

template <int FN, typename T, typename A>
__global__ void __launch_bounds__(kThreads)
dense_group_partial(const int64_t* __restrict__ idx,
                    const T* __restrict__ vals,
                    const uint8_t* __restrict__ valid,
                    const uint8_t* __restrict__ alive, int64_t n, int domain,
                    A* __restrict__ part_val, int* __restrict__ part_nn,
                    int* __restrict__ part_occ) {
  __shared__ A s_acc[kWarps][kMaxDomain];
  __shared__ int s_nn[kWarps][kMaxDomain];
  __shared__ int s_occ[kWarps][kMaxDomain];
  const bool has_valid = valid != nullptr;
  for (int j = threadIdx.x; j < kWarps * kMaxDomain; j += kThreads) {
    s_acc[j / kMaxDomain][j % kMaxDomain] = identity<FN, A>();
    s_nn[j / kMaxDomain][j % kMaxDomain] = 0;
    s_occ[j / kMaxDomain][j % kMaxDomain] = 0;
  }
  __syncthreads();
  const int w = threadIdx.x >> 5;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const long long g = idx[i];
    if (!alive[i] || g < 0 || g >= domain) continue;
    if (has_valid) {
      atomicAdd(&s_occ[w][g], 1);
      if (!valid[i]) continue;
    }
    atomicAdd(&s_nn[w][g], 1);
    if constexpr (FN == kSum) atomic_add(&s_acc[w][g], (A)vals[i]);
    else if constexpr (FN == kMin) atomic_min(&s_acc[w][g], (A)vals[i]);
    else if constexpr (FN == kMax) atomic_max(&s_acc[w][g], (A)vals[i]);
  }
  __syncthreads();
  for (int g = threadIdx.x; g < domain; g += kThreads) {
    A acc = identity<FN, A>();
    int nn = 0, occ = 0;
    for (int k = 0; k < kWarps; ++k) {
      acc = combine<FN, A>(acc, s_acc[k][g]);
      nn += s_nn[k][g];
      occ += s_occ[k][g];
    }
    const int64_t o = (int64_t)blockIdx.x * domain + g;
    part_val[o] = acc;
    part_nn[o] = nn;
    part_occ[o] = has_valid ? occ : nn;
  }
}

// Pass 2: one block per group; its threads stride over the per-block
// partials, then fold them in a fixed order.
template <int FN, typename A, typename O>
__global__ void __launch_bounds__(kThreads)
dense_group_final(const A* __restrict__ part_val,
                  const int* __restrict__ part_nn,
                  const int* __restrict__ part_occ, int blocks, int domain,
                  O* __restrict__ out_val, int* __restrict__ out_nn,
                  bool* __restrict__ out_occ) {
  const int g = blockIdx.x;
  A acc = identity<FN, A>();
  A unused = identity<FN, A>();
  long long nn = 0, occ = 0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    const int64_t o = (int64_t)b * domain + g;
    acc = combine<FN, A>(acc, part_val[o]);
    nn += part_nn[o];
    occ += part_occ[o];
  }
  block_reduce<FN, A>(acc, nn);
  __syncthreads();  // the second reduction reuses block_reduce's slots
  block_reduce<FN, A>(unused, occ);
  if (threadIdx.x == 0) {
    if constexpr (FN != kCount) out_val[g] = (O)acc;
    out_nn[g] = (int)nn;
    out_occ[g] = occ > 0;
  }
}

// ---------------------------------------------------------------------
// K5: segmented reduce over key-sorted rows (sort GROUP BY). Row i of the
// sorted order holds input row perm[i]; live rows form a prefix (s_alive)
// and change[i] marks the first row of each group. The thread that owns a
// group's first row walks the group, reading the values through perm (no
// sorted copy of the payload is materialised), and writes the group's
// result and live non-null count at its LAST row; every other row gets 0.
// Deterministic: a group is summed by one thread in sorted (stable) order.
// Slow when one group is huge (one thread walks it); TPC-H's groups are
// short.
// ---------------------------------------------------------------------
template <int FN, typename T, typename A, typename O>
__global__ void __launch_bounds__(kThreads)
segment_reduce_kernel(const uint8_t* __restrict__ change,
                      const uint8_t* __restrict__ s_alive,
                      const long long* __restrict__ perm, int64_t n,
                      const T* __restrict__ vals,
                      const uint8_t* __restrict__ valid,
                      O* __restrict__ out_val, int* __restrict__ out_nn) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    if (!s_alive[i]) {
      if constexpr (FN != kCount) out_val[i] = O(0);
      out_nn[i] = 0;
      continue;
    }
    if (!change[i]) continue;  // written by the walker of its group
    A acc = identity<FN, A>();
    int nn = 0;
    int64_t j = i;
    while (true) {
      const long long r = perm[j];
      if (valid == nullptr || valid[r]) {
        nn += 1;
        if constexpr (FN != kCount) acc = combine<FN, A>(acc, (A)vals[r]);
      }
      if (j + 1 >= n || !s_alive[j + 1] || change[j + 1]) break;
      if constexpr (FN != kCount) out_val[j] = O(0);
      out_nn[j] = 0;
      ++j;
    }
    if constexpr (FN != kCount) out_val[j] = (O)acc;
    out_nn[j] = nn;
  }
}

template <int FN, typename T, typename A, typename O>
cudaError_t launch_segment_reduce(const void* change, const void* s_alive,
                                  const void* perm, int64_t n,
                                  const void* vals, const void* valid,
                                  void* out_val, void* out_nn, int blocks,
                                  cudaStream_t stream) {
  segment_reduce_kernel<FN, T, A, O><<<blocks, kThreads, 0, stream>>>(
      (const uint8_t*)change, (const uint8_t*)s_alive, (const long long*)perm,
      n, (const T*)vals, (const uint8_t*)valid, (O*)out_val, (int*)out_nn);
  return cudaGetLastError();
}

template <int FN, typename T, typename A, typename O>
cudaError_t launch_dense_group(const void* idx, const void* vals,
                               const void* valid, const void* alive, int64_t n,
                               int domain, void* part_val, void* part_nn,
                               void* part_occ, int blocks, void* out_val,
                               void* out_nn, void* out_occ,
                               cudaStream_t stream) {
  dense_group_partial<FN, T, A><<<blocks, kThreads, 0, stream>>>(
      (const int64_t*)idx, (const T*)vals, (const uint8_t*)valid,
      (const uint8_t*)alive, n, domain, (A*)part_val, (int*)part_nn,
      (int*)part_occ);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dense_group_final<FN, A, O><<<domain, kThreads, 0, stream>>>(
      (const A*)part_val, (const int*)part_nn, (const int*)part_occ, blocks,
      domain, (O*)out_val, (int*)out_nn, (bool*)out_occ);
  return cudaGetLastError();
}

// Accumulator and output types per (fn, dtype), the same for both kernels:
//   SUM   i32, i64 -> acc int64, out int64; f32 -> acc f64, out f32;
//         f64 -> acc f64, out f64
//   MIN/MAX      -> acc and out of the input's type
//   COUNT        -> only the counts (the value pointer may be null)
#define QS_DISPATCH(LAUNCH, ...)                                              \
  switch (fn) {                                                               \
    case kSum:                                                                \
      switch (dtype) {                                                        \
        case kI32: return LAUNCH<kSum, int, long long, long long>(__VA_ARGS__); \
        case kI64: return LAUNCH<kSum, long long, long long, long long>(__VA_ARGS__); \
        case kF32: return LAUNCH<kSum, float, double, float>(__VA_ARGS__);    \
        case kF64: return LAUNCH<kSum, double, double, double>(__VA_ARGS__);  \
      }                                                                       \
      break;                                                                  \
    case kMin:                                                                \
      switch (dtype) {                                                        \
        case kI32: return LAUNCH<kMin, int, int, int>(__VA_ARGS__);           \
        case kI64: return LAUNCH<kMin, long long, long long, long long>(__VA_ARGS__); \
        case kF32: return LAUNCH<kMin, float, float, float>(__VA_ARGS__);     \
        case kF64: return LAUNCH<kMin, double, double, double>(__VA_ARGS__);  \
      }                                                                       \
      break;                                                                  \
    case kMax:                                                                \
      switch (dtype) {                                                        \
        case kI32: return LAUNCH<kMax, int, int, int>(__VA_ARGS__);           \
        case kI64: return LAUNCH<kMax, long long, long long, long long>(__VA_ARGS__); \
        case kF32: return LAUNCH<kMax, float, float, float>(__VA_ARGS__);     \
        case kF64: return LAUNCH<kMax, double, double, double>(__VA_ARGS__);  \
      }                                                                       \
      break;                                                                  \
    case kCount:                                                              \
      return LAUNCH<kCount, uint8_t, long long, long long>(__VA_ARGS__);      \
  }                                                                           \
  return cudaErrorInvalidValue;

}  // namespace

extern "C" {

int qs_masked_reduce(int fn, int dtype, const void* vals, const void* valid,
                     const void* alive, int64_t n, void* part_val,
                     void* part_cnt, int blocks, void* out_val, void* out_cnt,
                     void* stream) {
  QS_DISPATCH(launch_masked_reduce, vals, valid, alive, n, part_val, part_cnt,
              blocks, out_val, out_cnt, (cudaStream_t)stream)
}

int qs_dense_group_reduce(int fn, int dtype, const void* idx, const void* vals,
                          const void* valid, const void* alive, int64_t n,
                          int domain, void* part_val, void* part_nn,
                          void* part_occ, int blocks, void* out_val,
                          void* out_nn, void* out_occ, void* stream) {
  if (domain < 1 || domain > kMaxDomain) return cudaErrorInvalidValue;
  QS_DISPATCH(launch_dense_group, idx, vals, valid, alive, n, domain, part_val,
              part_nn, part_occ, blocks, out_val, out_nn, out_occ,
              (cudaStream_t)stream)
}

int qs_segment_reduce(int fn, int dtype, const void* change,
                      const void* s_alive, const void* perm, int64_t n,
                      const void* vals, const void* valid, void* out_val,
                      void* out_nn, int blocks, void* stream) {
  if (n == 0) return cudaSuccess;
  QS_DISPATCH(launch_segment_reduce, change, s_alive, perm, n, vals, valid,
              out_val, out_nn, blocks, (cudaStream_t)stream)
}

const char* qs_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
