// Strip raster over compacted active tiles, for Hopper (sm_90a).
//
// Replaces: tinyrenderder_tpu/ops/raster_fine.py::_fine_kernel, as
// launched over active tiles by _fine_call_jit, with and without its
// collect_stats event planes.  Plain version, pre-stage and contract:
// tinyrenderder_tpu_torch/ops/raster_fine.py.  The outputs are the coarse
// raster's (raster_coarse.cu), so the post stage is shared.
//
// What bounds it on this card: per-pixel arithmetic, as in the coarse
// raster.  For every (pixel, slot) inside the triangle's bbox a lane
// evaluates the barycentric coverage with three IEEE divisions and the
// affine depth (-fmad=false: no contraction, for bitwise parity with the
// reference).  Its bytes are small: the slot table tri8, the per-triangle
// rows of tri_rec, the running depth and the (2 + V) output planes (two
// more with stats), each touched once.
//
// What the design does about it: it cuts the (pixel, triangle) tests.
// A tile's triangles are binned per 16-px strip, so a pixel walks only
// the triangles whose bbox touches its own strip:
//  * one block of 8 warps per active tile of TH x 128 pixels, warp k on
//    strip k.  The warp's walk (trt::strip_column in raster_common.cuh,
//    shared with the grouped strip raster raster_fine2.cu) covers only its
//    own slot column tri8[row_start + r][k] in row order (= submission order,
//    build_bins sorts stably) and stops at the first -1: a strip's bin is a
//    prefix of its column, so it walks its strip's count, not the tile's
//    largest.  A warp whose strip is empty (a ragged right edge) exits the
//    loop at once and still writes the init depth, -1 and zero varyings;
//  * 32 slots at a time: each lane reads one slot id, the warp stages the
//    32 triangles' 16 geometry floats in its own shared memory, and every
//    lane runs the sequential strict-less update over them in order.  A
//    lane outside a triangle's bbox column skips it before any
//    arithmetic;
//  * the stats variant (STATS = true, a separate instantiation) counts
//    every z < depth step as a z-pass event, from the running init depth,
//    as the coarse kernel does; the TPU's exclusive cummin over 8-row
//    sub-blocks recovers the same sequence;
//  * loop 2 reads each pixel's winner row of tri_rec from global memory.
//
// Not done yet: a strip's 16 columns make 64-byte store segments, half
// the coalescing of the coarse kernel's 128-float rows; the warps of a
// block finish at their own strip's count, so a tile with one long strip
// keeps its block resident.  Making it fast is later work.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using trt::kStrips;
using trt::kStripW;
using trt::kTileW;
using trt::kWarp;

template <int TH, bool STATS>
__global__ void __launch_bounds__(trt::kStripThreads)
fine_raster_kernel(const float* __restrict__ tri_rec, int rec_stride,
                   const int* __restrict__ tri8, const int* __restrict__ tile_ids,
                   const int* __restrict__ row_start, const int* __restrict__ rows,
                   int origin_x, int origin_y, int n_tiles_x, int n_vary,
                   const float* __restrict__ init_depth, float* __restrict__ depth_out,
                   int* __restrict__ winner_out, float* __restrict__ vary_out,
                   int* __restrict__ ev_count, float* __restrict__ ev_maxz) {
  __shared__ float s_geom[kStrips][kWarp][trt::kGeom];
  __shared__ int s_tri[kStrips][kWarp];

  const int a = blockIdx.x;
  const int tile = tile_ids[a];
  const int k = threadIdx.x / kWarp;      // strip
  const int lane = threadIdx.x % kWarp;
  const int x = origin_x + (tile % n_tiles_x) * kTileW + k * kStripW + lane % kStripW;
  const int y = origin_y + (tile / n_tiles_x) * TH + lane / kStripW;
  trt::strip_column<TH, STATS>(tri_rec, rec_stride, tri8, row_start[a], rows[a], a, x, y,
                               n_vary, init_depth, depth_out, winner_out, vary_out,
                               ev_count, ev_maxz, s_geom[k], s_tri[k]);
}

template <int TH, bool STATS>
void launch(int n_active, cudaStream_t s, const float* tri_rec, int rec_stride,
            const int* tri8, const int* tile_ids, const int* row_start, const int* rows,
            int origin_x, int origin_y, int n_tiles_x, int n_vary,
            const float* init_depth, float* depth, int* winner, float* vary,
            int* ev_count, float* ev_maxz) {
  fine_raster_kernel<TH, STATS><<<n_active, trt::kStripThreads, 0, s>>>(
      tri_rec, rec_stride, tri8, tile_ids, row_start, rows, origin_x, origin_y,
      n_tiles_x, n_vary, init_depth, depth, winner, vary, ev_count, ev_maxz);
}

}  // namespace

// ev_count and ev_maxz: both null (no stats) or both (A, TH, 128)
extern "C" int trt_fine_raster(const float* tri_rec, int rec_stride, const int* tri8,
                               const int* tile_ids, const int* row_start,
                               const int* rows, int n_active, int origin_x,
                               int origin_y, int n_tiles_x, int tile_h, int tile_w,
                               int n_vary, const float* init_depth, float* depth,
                               int* winner, float* vary, int* ev_count,
                               float* ev_maxz, void* stream) {
  if (tile_w != kTileW || (tile_h != 16 && tile_h != 32) || n_active <= 0 ||
      (ev_count == nullptr) != (ev_maxz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = ev_count != nullptr;
  using Launch = decltype(&launch<16, false>);
  const Launch fn = tile_h == 32 ? (stats ? &launch<32, true> : &launch<32, false>)
                                 : (stats ? &launch<16, true> : &launch<16, false>);
  fn(n_active, s, tri_rec, rec_stride, tri8, tile_ids, row_start, rows, origin_x,
     origin_y, n_tiles_x, n_vary, init_depth, depth, winner, vary, ev_count, ev_maxz);
  return static_cast<int>(cudaGetLastError());
}
