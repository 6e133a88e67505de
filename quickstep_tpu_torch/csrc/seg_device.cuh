// Device functions of the reductions and segmented scans, included by
// agg_kernels.cu (K1, K2, K5) and window_kernels.cu (W1-W4): the aggregate
// and dtype codes ops/cuda.py passes, each reduction's identity and
// combination (MIN/MAX let a NaN win), and a block-wide exclusive scan in
// thread order with the segmented (flag, value, count) element it scans.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Fn { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };
enum DType { kI32 = 0, kI64 = 1, kF32 = 2, kF64 = 3 };

constexpr unsigned kFull = 0xffffffffu;

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
// max/min sentinels (ops/kernels.py:175-196) for MIN/MAX, which dead and
// NULL rows hold.
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

__device__ __forceinline__ int shfl_up(int x, int d) {
  return __shfl_up_sync(kFull, x, d);
}

__device__ __forceinline__ long long shfl_up(long long x, int d) {
  return __shfl_up_sync(kFull, x, d);
}

// A segmented-scan element: f says a segment starts inside it; v and c are
// the value and the count since its last segment start (or since its first
// row when f is 0). SegOp(earlier, later) is associative.
template <typename A>
struct Seg {
  int f;
  A v;
  long long c;
};

template <typename A>
__device__ __forceinline__ Seg<A> shfl_up(const Seg<A>& x, int d) {
  Seg<A> r;
  r.f = __shfl_up_sync(kFull, x.f, d);
  r.v = __shfl_up_sync(kFull, x.v, d);
  r.c = __shfl_up_sync(kFull, x.c, d);
  return r;
}

template <int FN, typename A>
struct SegOp {
  __device__ __forceinline__ Seg<A> operator()(const Seg<A>& a,
                                               const Seg<A>& b) const {
    Seg<A> r;
    r.f = a.f | b.f;
    r.v = b.f ? b.v : combine<FN, A>(a.v, b.v);
    r.c = b.f ? b.c : a.c + b.c;
    return r;
  }
};

// Exclusive scan of x in thread order with identity id, every thread of the
// block taking part: Hillis-Steele within each warp, then the same over the
// warp totals. total receives the combination of every thread's x. The
// order of combination is fixed, so float results repeat bit for bit.
template <int NT, typename S, typename Op>
__device__ __forceinline__ S block_exclusive_scan(S x, S id, Op op, S& total) {
  constexpr int NW = NT / 32;
  __shared__ S warp_tot[NW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  S inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const S y = shfl_up(inc, d);
    if (lane >= d) inc = op(y, inc);
  }
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    S w = lane < NW ? warp_tot[lane] : id;
    for (int d = 1; d < 32; d <<= 1) {
      const S y = shfl_up(w, d);
      if (lane >= d) w = op(y, w);
    }
    if (lane < NW) warp_tot[lane] = w;          // inclusive over warps
  }
  __syncthreads();
  S before = shfl_up(inc, 1);
  if (lane == 0) before = id;
  const S result = op(warp == 0 ? id : warp_tot[warp - 1], before);
  total = warp_tot[NW - 1];
  __syncthreads();                              // warp_tot is reused
  return result;
}

}  // namespace
