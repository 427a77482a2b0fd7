// Single-plane untile for Hopper (sm_90a): (T, th, tw) 32-bit tiles ->
// (nty*th, ntx*tw) row-major image, a pure permutation copy.
//
// Replaces: tinyrenderder_tpu/ops/raster_sparse.py::_untile_one_kernel,
// as launched by _untile_one_jit.  Plain version:
// tinyrenderder_tpu_torch/ops/raster_sparse.py::untile_one_plain.
//
// What bounds it on this card: device-memory bandwidth; it reads and
// writes each word once and computes nothing but addresses.
//
// Design: one block per tile, its threads striding over the tile's
// 16-byte vectors (four words).  Consecutive threads read consecutive
// vectors of a tile row and write them to consecutive addresses of the
// image row, so both sides move whole 512-byte rows of a 128-wide tile
// in coalesced 16-byte accesses.  Index math is 32-bit within a tile.
// The words are moved as int4 bits, so int32 and float32 planes are
// copied bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
untile32_kernel(const int4* __restrict__ src, int4* __restrict__ dst,
                int n_tiles_x, int tile_h, int tile_w4) {
  const int tile = blockIdx.x;
  const int n = tile_h * tile_w4;  // vectors per tile
  const size_t row = static_cast<size_t>(n_tiles_x) * tile_w4;
  const int4* s = src + static_cast<size_t>(tile) * n;
  int4* d = dst + static_cast<size_t>(tile / n_tiles_x) * tile_h * row +
            static_cast<size_t>(tile % n_tiles_x) * tile_w4;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int y = i / tile_w4;
    d[y * row + (i - y * tile_w4)] = s[i];
  }
}

}  // namespace

extern "C" int trt_untile32(const void* src, void* dst, int n_tiles_x,
                            int n_tiles_y, int tile_h, int tile_w,
                            void* stream) {
  if (tile_w % 4 != 0 || n_tiles_x <= 0 || n_tiles_y <= 0 || tile_h <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  untile32_kernel<<<n_tiles_x * n_tiles_y, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst), n_tiles_x,
      tile_h, tile_w / 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
