// Untile for Hopper (sm_90a): (T, th, tw) 32-bit tiles -> (nty*th, ntx*tw)
// row-major image, a pure permutation copy.  Two entry points:
//
//   trt_untile32 replaces tinyrenderder_tpu/ops/raster_sparse.py::
//     _untile_one_kernel (launched by _untile_one_jit): one plane.
//   trt_untile3 replaces raster_sparse.py::_untile_kernel (launched by
//     _untile_call_jit): the frame's packed colour (i32), depth (f32) and
//     winner (i32) planes in one launch.
//
// Plain versions: tinyrenderder_tpu_torch/ops/raster_sparse.py::
// untile_one_plain and untile3_plain.
//
// What bounds it on this card: device-memory bandwidth; it reads and
// writes each word once and computes nothing but addresses.
//
// Design: one block per (tile, plane), its threads striding over the
// tile's 16-byte vectors (four words).  Consecutive threads read
// consecutive vectors of a tile row and write them to consecutive
// addresses of the image row, so both sides move whole 512-byte rows of
// a 128-wide tile in coalesced 16-byte accesses.  The three-plane entry
// puts the plane on blockIdx.y, so one launch fills the card with three
// times the blocks of a single plane.  Index math is 32-bit within a
// tile.  The words are moved as int4 bits, so int32 and float32 planes
// are copied bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void untile_tile(const int4* __restrict__ src,
                                            int4* __restrict__ dst, int tile,
                                            int n_tiles_x, int tile_h,
                                            int tile_w4) {
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

__global__ void __launch_bounds__(kThreads)
untile32_kernel(const int4* __restrict__ src, int4* __restrict__ dst,
                int n_tiles_x, int tile_h, int tile_w4) {
  untile_tile(src, dst, blockIdx.x, n_tiles_x, tile_h, tile_w4);
}

struct Planes3 {
  const int4* src[3];
  int4* dst[3];
};

__global__ void __launch_bounds__(kThreads)
untile3_kernel(Planes3 p, int n_tiles_x, int tile_h, int tile_w4) {
  const int k = blockIdx.y;
  untile_tile(p.src[k], p.dst[k], blockIdx.x, n_tiles_x, tile_h, tile_w4);
}

bool bad_shape(int n_tiles_x, int n_tiles_y, int tile_h, int tile_w) {
  return tile_w % 4 != 0 || n_tiles_x <= 0 || n_tiles_y <= 0 || tile_h <= 0;
}

}  // namespace

extern "C" int trt_untile32(const void* src, void* dst, int n_tiles_x,
                            int n_tiles_y, int tile_h, int tile_w,
                            void* stream) {
  if (bad_shape(n_tiles_x, n_tiles_y, tile_h, tile_w))
    return static_cast<int>(cudaErrorInvalidValue);
  untile32_kernel<<<n_tiles_x * n_tiles_y, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(src), static_cast<int4*>(dst), n_tiles_x,
      tile_h, tile_w / 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trt_untile3(const void* color, const void* depth,
                           const void* winner, void* color_out,
                           void* depth_out, void* winner_out, int n_tiles_x,
                           int n_tiles_y, int tile_h, int tile_w,
                           void* stream) {
  if (bad_shape(n_tiles_x, n_tiles_y, tile_h, tile_w))
    return static_cast<int>(cudaErrorInvalidValue);
  Planes3 p;
  p.src[0] = static_cast<const int4*>(color);
  p.src[1] = static_cast<const int4*>(depth);
  p.src[2] = static_cast<const int4*>(winner);
  p.dst[0] = static_cast<int4*>(color_out);
  p.dst[1] = static_cast<int4*>(depth_out);
  p.dst[2] = static_cast<int4*>(winner_out);
  const dim3 grid(n_tiles_x * n_tiles_y, 3);
  untile3_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, n_tiles_x, tile_h, tile_w / 4);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
