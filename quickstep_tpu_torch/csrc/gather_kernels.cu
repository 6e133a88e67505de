// The many-column gather (K6) for Hopper (sm_90a). Plain C interface, loaded
// with ctypes by quickstep_tpu_torch/ops/cuda.py; every function launches on
// the stream it is given, allocates nothing, and returns the cudaError_t of
// its launches.
//
// Both routes replace quickstep_tpu/ops/kernels.py:88 multi_gather: out
// column c, row i = column c at row idx[i], for up to kMaxCols columns of
// 1-, 2-, 4- or 8-byte elements. The reference packs columns of one lane
// dtype into a [n, k] array so that the TPU pays one random-access pass per
// lane group. An index outside [0, n_src) is clamped: callers clip as the
// reference does, and neither route reads out of bounds either way.
//
// What bounds a gather on an H100 is the index. A nearly ascending index
// (compaction, the probe side's row ids, the shuffle's bucket gathers)
// reads each column almost coalesced; a random one (a sort permutation)
// costs one 32-byte DRAM sector per row and column read, and the card
// serves random sectors at a fraction of its streaming rate. The host
// picks the route (ops/cuda.py gather_route) from the caller's word that
// the index is random and a cost model of the two rates; it never reads a
// device value to do so.
//
// qs_multi_gather, the direct route: one thread per output row walks the
// columns, so a warp's writes to each output column are contiguous. By a
// random index it costs a sector per (row, column): 6 columns by a 60 M
// random index took 12.5 ms on an H100, near index_select's time, and
// issuing all of a row's column reads before its stores did not change
// that. The column pointers and widths travel as a by-value kernel
// parameter, so a launch needs no device-side table.
//
// qs_packed_gather, the row-packed route, cuts the sectors to one per row
// (two for rows of 33 to 64 bytes):
// 1. pack: tiles of the source columns are read coalesced into shared
//    memory as rows of W bytes (the columns widest first, so every field
//    sits at a multiple of its width, W = 16, 32 or 64), then written out
//    as whole rows: one n_src x W scratch buffer, which the caller
//    allocates.
// 2. gather: each thread copies its output row's W bytes with cp.async.cg
//    16-byte copies into a shared-memory ring of 32 KiB per block
//    (8, 4 or 2 stages, one row per thread and stage), so each thread keeps
//    several random rows in flight without holding them in registers.
// 3. unpack: each thread reads its own row's fields out of the ring and
//    stores them, so every output column is written coalesced. A thread
//    reads only the rows it copied, so the ring needs no block barrier:
//    cp.async.wait_group orders a thread's own copies, and a slot is
//    refilled only after the stores that used its loads were issued.
// The 16-byte chunks of a row are placed in the ring and the pack tile
// with an XOR swizzle on the row number, so the 32 lanes of a warp reading
// one field of 32 rows touch 8 bank groups, not 2 or 4.
// Bound: the pack moves n_src x (row bytes + W) coalesced, the gather m
// random rows of W bytes, the unpack m x row bytes coalesced, and the index
// is read once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;
constexpr int kMaxRowBytes = 64;
constexpr int kPackTileBytes = 16384;     // pack tile in shared memory
constexpr int kRingBytes = 32768;         // gather ring per block

struct Cols {
  const void* src[kMaxCols];
  void* dst[kMaxCols];
  int width[kMaxCols];
  int n;
};

struct PackedCols {       // the row-packed route's columns
  Cols c;
  int offset[kMaxCols];   // each column's byte offset in a packed row
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

// the 16-byte chunk slot of chunk q of row r (CW chunks per row)
template <int CW>
__device__ __forceinline__ int swz(int r, int q) {
  constexpr int kShift = CW == 1 ? 3 : (CW == 2 ? 2 : 1);
  return q ^ ((r >> kShift) & (CW - 1));
}

// the byte address of the field at byte offset off of row r of a tile
template <int CW>
__device__ __forceinline__ unsigned char* field(unsigned char* tile, int r,
                                                int off) {
  return tile + ((r * CW + swz<CW>(r, off >> 4)) << 4) + (off & 15);
}

template <int CW>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const PackedCols p, int64_t n_src, uint4* __restrict__ packed) {
  const Cols& cols = p.c;
  constexpr int kRows = kPackTileBytes / (16 * CW);
  __shared__ uint4 tile[kPackTileBytes / 16];
  unsigned char* bytes = reinterpret_cast<unsigned char*>(tile);
  for (int64_t first = (int64_t)blockIdx.x * kRows; first < n_src;
       first += (int64_t)gridDim.x * kRows) {
    const int rows = (int)(n_src - first < kRows ? n_src - first : kRows);
    for (int i = threadIdx.x; i < kPackTileBytes / 16; i += kThreads)
      tile[i] = make_uint4(0, 0, 0, 0);
    __syncthreads();
    for (int c = 0; c < cols.n; ++c) {
      const int off = p.offset[c];
      for (int r = threadIdx.x; r < rows; r += kThreads) {
        unsigned char* f = field<CW>(bytes, r, off);
        const int64_t j = first + r;
        switch (cols.width[c]) {
          case 1:
            *f = static_cast<const uint8_t*>(cols.src[c])[j];
            break;
          case 2:
            *reinterpret_cast<uint16_t*>(f) =
                static_cast<const uint16_t*>(cols.src[c])[j];
            break;
          case 4:
            *reinterpret_cast<uint32_t*>(f) =
                static_cast<const uint32_t*>(cols.src[c])[j];
            break;
          default:
            *reinterpret_cast<unsigned long long*>(f) =
                static_cast<const unsigned long long*>(cols.src[c])[j];
            break;
        }
      }
    }
    __syncthreads();
    uint4* dst = packed + first * CW;
    for (int g = threadIdx.x; g < rows * CW; g += kThreads) {
      const int r = g / CW, q = g % CW;
      dst[g] = tile[r * CW + swz<CW>(r, q)];
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int CW, typename I>
__global__ void __launch_bounds__(kThreads)
packed_gather_kernel(const PackedCols p, const uint4* __restrict__ packed,
                     const I* __restrict__ idx, int64_t n_src, int64_t m) {
  const Cols& cols = p.c;
  constexpr int kStages = kRingBytes / (kThreads * 16 * CW);
  extern __shared__ uint4 ring[];
  const int t = threadIdx.x;
  const int64_t n_tiles = (m + kThreads - 1) / kThreads;
  const int64_t step = gridDim.x;
  auto slot = [&](int s) { return ring + s * kThreads * CW; };
  auto issue = [&](int64_t tile, int s) {
    const int64_t i = tile * kThreads + t;
    if (tile < n_tiles && i < m) {
      int64_t j = (int64_t)idx[i];
      j = j < 0 ? 0 : (j >= n_src ? n_src - 1 : j);
      const uint4* src = packed + j * CW;
      uint4* dst = slot(s) + t * CW;
#pragma unroll
      for (int q = 0; q < CW; ++q) cp_async16(dst + swz<CW>(t, q), src + q);
    }
    cp_async_commit();
  };
  const int64_t first = blockIdx.x;
#pragma unroll
  for (int s = 0; s < kStages; ++s) issue(first + s * step, s);
  int s = 0;
  for (int64_t tile = first; tile < n_tiles; tile += step) {
    cp_async_wait<kStages - 1>();
    const int64_t i = tile * kThreads + t;
    if (i < m) {
      unsigned char* tile_bytes = reinterpret_cast<unsigned char*>(slot(s));
      for (int c = 0; c < cols.n; ++c) {
        const unsigned char* f = field<CW>(tile_bytes, t, p.offset[c]);
        switch (cols.width[c]) {
          case 1:
            static_cast<uint8_t*>(cols.dst[c])[i] = *f;
            break;
          case 2:
            static_cast<uint16_t*>(cols.dst[c])[i] =
                *reinterpret_cast<const uint16_t*>(f);
            break;
          case 4:
            static_cast<uint32_t*>(cols.dst[c])[i] =
                *reinterpret_cast<const uint32_t*>(f);
            break;
          default:
            static_cast<unsigned long long*>(cols.dst[c])[i] =
                *reinterpret_cast<const unsigned long long*>(f);
            break;
        }
      }
    }
    // the slot's loads above fed the stores, so it can be refilled
    issue(tile + kStages * step, s);
    s = s + 1 == kStages ? 0 : s + 1;
  }
  cp_async_wait<0>();
}

int fill_cols(Cols* cols, int ncols, const void* const* srcs,
              void* const* dsts, const int* widths) {
  if (ncols < 1 || ncols > kMaxCols) return cudaErrorInvalidValue;
  cols->n = ncols;
  for (int c = 0; c < kMaxCols; ++c) {
    const bool on = c < ncols;
    const int w = on ? widths[c] : 0;
    if (on && w != 1 && w != 2 && w != 4 && w != 8)
      return cudaErrorInvalidValue;
    cols->src[c] = on ? srcs[c] : nullptr;
    cols->dst[c] = on ? dsts[c] : nullptr;
    cols->width[c] = w;
  }
  return cudaSuccess;
}

template <int CW, typename I>
int launch_packed_gather(const PackedCols& cols, const uint4* packed,
                         const I* idx, int64_t n_src, int64_t m,
                         cudaStream_t st) {
  auto kernel = packed_gather_kernel<CW, I>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                kRingBytes);
  const int64_t n_tiles = (m + kThreads - 1) / kThreads;
  int64_t grid = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > n_tiles) grid = n_tiles;
  kernel<<<(int)grid, kThreads, kRingBytes, st>>>(cols, packed, idx, n_src,
                                                  m);
  return cudaGetLastError();
}

template <int CW>
int packed_route(const PackedCols& cols, int64_t n_src, void* packed,
                 const void* idx, int idx_is_64, int64_t m, int blocks,
                 cudaStream_t st) {
  constexpr int kRows = kPackTileBytes / (16 * CW);
  const int64_t need = (n_src + kRows - 1) / kRows;
  const int pack_blocks = need < blocks ? (int)need : blocks;
  pack_kernel<CW><<<pack_blocks, kThreads, 0, st>>>(cols, n_src,
                                                    (uint4*)packed);
  int err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (idx_is_64)
    return launch_packed_gather<CW, long long>(
        cols, (const uint4*)packed, (const long long*)idx, n_src, m, st);
  return launch_packed_gather<CW, int>(cols, (const uint4*)packed,
                                       (const int*)idx, n_src, m, st);
}

}  // namespace

extern "C" {

// srcs, dsts and widths are host arrays of ncols entries (1 <= ncols <=
// kMaxCols); idx is int32 (idx_is_64 == 0) or int64 on the device.
int qs_multi_gather(int ncols, const void* const* srcs, void* const* dsts,
                    const int* widths, int64_t n_src, const void* idx,
                    int idx_is_64, int64_t m, int blocks, void* stream) {
  Cols cols;
  int err = fill_cols(&cols, ncols, srcs, dsts, widths);
  if (err != cudaSuccess || (m > 0 && n_src < 1)) return cudaErrorInvalidValue;
  if (m == 0) return cudaSuccess;
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

// The row-packed route: offsets[c] is column c's byte offset in a packed
// row of row_bytes (16, 32 or 64) bytes, a multiple of its width, the
// fields inside the row; packed is n_src * row_bytes bytes of scratch,
// 16-byte aligned.
int qs_packed_gather(int ncols, const void* const* srcs, void* const* dsts,
                     const int* widths, const int* offsets, int row_bytes,
                     int64_t n_src, void* packed, const void* idx,
                     int idx_is_64, int64_t m, int blocks, void* stream) {
  PackedCols cols;
  int err = fill_cols(&cols.c, ncols, srcs, dsts, widths);
  if (err != cudaSuccess || (m > 0 && n_src < 1) || blocks < 1 ||
      ((uintptr_t)packed & 15) != 0)
    return cudaErrorInvalidValue;
  if (row_bytes != 16 && row_bytes != 32 && row_bytes != kMaxRowBytes)
    return cudaErrorInvalidValue;
  for (int c = 0; c < kMaxCols; ++c) {
    const int o = c < ncols ? offsets[c] : 0, w = c < ncols ? widths[c] : 1;
    if (o < 0 || o % w != 0 || o + w > row_bytes) return cudaErrorInvalidValue;
    cols.offset[c] = o;
  }
  if (m == 0) return cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (row_bytes) {
    case 16: return packed_route<1>(cols, n_src, packed, idx, idx_is_64, m, blocks, s);
    case 32: return packed_route<2>(cols, n_src, packed, idx, idx_is_64, m, blocks, s);
    default: return packed_route<4>(cols, n_src, packed, idx, idx_is_64, m, blocks, s);
  }
}

}  // extern "C"
