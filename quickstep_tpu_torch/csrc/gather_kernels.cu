// The many-column gather (K6) for Hopper (sm_90a). Plain C interface, loaded
// with ctypes by quickstep_tpu_torch/ops/cuda.py; launches on the stream it
// is given, allocates nothing, and returns the cudaError_t of its launch.
//
// qs_multi_gather replaces quickstep_tpu/ops/kernels.py:88 multi_gather: out
// column c, row i = column c at row idx[i], for up to kMaxCols columns of
// 1-, 2-, 4- or 8-byte elements in one launch. The reference packs columns
// of one lane dtype into a [n, k] array so that the TPU pays one random-
// access pass per lane group; on Hopper each column is read at its own width
// and the pass is shared by reading idx[i] once per row for all columns.
//
// What bounds it on an H100: random reads from device memory, one 32-byte
// sector per (row, column) unless neighbouring indices share a sector, plus
// the coalesced index read and output writes. One thread per output row
// walks the columns, so a warp's writes to each output column are
// contiguous. Issuing all of a row's column reads before its stores did not
// change the time (6 columns by a 60 M random index, 12.7 ms either way on
// an H100): the random sector rate bounds it, as it bounds index_select. The
// column pointers and widths travel as a by-value kernel parameter, so a
// launch needs no device-side table and no host-to-device copy. An index
// outside [0, n_src) is clamped: callers clip as the reference does, and the
// kernel never reads out of bounds either way.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;

struct Cols {
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  int width[kMaxCols];
  int n;
};

template <typename I>
__global__ void __launch_bounds__(kThreads)
multi_gather_kernel(const Cols cols, const I* __restrict__ idx, int64_t n_src,
                    int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < m;
       i += stride) {
    int64_t j = (int64_t)idx[i];
    j = j < 0 ? 0 : (j >= n_src ? n_src - 1 : j);
    for (int c = 0; c < cols.n; ++c) {
      switch (cols.width[c]) {
        case 1:
          static_cast<uint8_t*>(cols.dst[c])[i] =
              static_cast<const uint8_t*>(cols.src[c])[j];
          break;
        case 2:
          static_cast<uint16_t*>(cols.dst[c])[i] =
              static_cast<const uint16_t*>(cols.src[c])[j];
          break;
        case 4:
          static_cast<uint32_t*>(cols.dst[c])[i] =
              static_cast<const uint32_t*>(cols.src[c])[j];
          break;
        default:
          static_cast<unsigned long long*>(cols.dst[c])[i] =
              static_cast<const unsigned long long*>(cols.src[c])[j];
          break;
      }
    }
  }
}

}  // namespace

extern "C" {

// srcs, dsts and widths are host arrays of ncols entries (1 <= ncols <=
// kMaxCols); idx is int32 (idx_is_64 == 0) or int64 on the device.
int qs_multi_gather(int ncols, const void* const* srcs, void* const* dsts,
                    const int* widths, int64_t n_src, const void* idx,
                    int idx_is_64, int64_t m, int blocks, void* stream) {
  if (ncols < 1 || ncols > kMaxCols || (m > 0 && n_src < 1))
    return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
  Cols cols;
  cols.n = ncols;
  for (int c = 0; c < ncols; ++c) {
    const int w = widths[c];
    if (w != 1 && w != 2 && w != 4 && w != 8) return cudaErrorInvalidValue;
    cols.src[c] = srcs[c];
    cols.dst[c] = dsts[c];
    cols.width[c] = w;
  }
  for (int c = ncols; c < kMaxCols; ++c) {
    cols.src[c] = nullptr;
    cols.dst[c] = nullptr;
    cols.width[c] = 0;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (idx_is_64) {
    multi_gather_kernel<long long><<<blocks, kThreads, 0, s>>>(
        cols, (const long long*)idx, n_src, m);
  } else {
    multi_gather_kernel<int><<<blocks, kThreads, 0, s>>>(
        cols, (const int*)idx, n_src, m);
  }
  return cudaGetLastError();
}

}  // extern "C"
