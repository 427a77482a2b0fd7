// Grouped strip raster, for Hopper (sm_90a).
//
// Replaces: tinyrenderder_tpu/ops/raster_fine2.py::_fine2_kernel, as
// launched over the scheduled strip groups by _fine2_call_jit, pass-local
// and (collect_stats) init-seeded with its event planes.  Plain version,
// pre-stage, post stage and contract: tinyrenderder_tpu_torch/ops/raster_fine2.py.
//
// What bounds it on this card: per-pixel arithmetic, as in the other
// rasters.  For every (pixel, slot) inside the triangle's bbox a lane
// evaluates the barycentric coverage with three IEEE divisions and the
// affine depth (-fmad=false: no contraction, for bitwise parity with the
// reference).  Its bytes are small: the slot table tri8, the per-triangle
// rows of tri_rec, the slot origins, the running depth (stats launch only)
// and the (2 + V) output planes (two more with stats), each touched once.
//
// What the design does about it: the strip raster (raster_fine.cu) already
// cuts the tests to a pixel's own 16-px strip, but one block walks a
// tile's 8 strips, and a block stays resident until its longest strip is
// done: on the 246k-triangle bench scenes the blocks' longest walks sum to
// ~2.5x the strips' own counts over 8.  Here a block walks a GROUP of 8
// strips taken from anywhere on the screen: the pre-stage sorts every
// strip by its count (one stable descending argsort) and gives rank r to
// group r / 8, slot r % 8, so the 8 walks of a block are near-equal and
// the sum of the blocks' longest walks is the least any grouping gives.
//  * one block of 8 warps per scheduled group (a group with rows > 0; they
//    are a prefix, rows descend); warp k owns slot k, whose strip's pixel
//    origin comes from the slot-origin table x0y0 (G, 8, 2), plus the pass
//    origin;
//  * the warp walks its own column of the slot table over the group's rows
//    with trt::strip_column (raster_common.cuh, shared with raster_fine.cu):
//    32 triangles' geometry staged in shared memory, the sequential
//    strict-less depth_step in every lane, a stop at the first -1 (a
//    strip's bin is a prefix of its column).  An empty slot (fewer than 8
//    strips with pairs in the last group) writes +inf (or its init), -1 and
//    zero varyings;
//  * depth starts at +inf (pass-local: the post stage merges it into the
//    frame with a strict-less select), or at the running depth of each
//    slot's strip in the stats instantiation (STATS), whose events are
//    then every z < depth step, as in the other rasters.
//
// Not done yet: 64-byte store segments per strip, as in raster_fine.cu;
// the outputs go through device memory in group space and the post stage
// regroups them.  Making it fast is later work.

#include <cuda_runtime.h>

#include "raster_common.cuh"

namespace {

using trt::kStrips;
using trt::kStripW;
using trt::kWarp;

template <int TH, bool STATS>
__global__ void __launch_bounds__(trt::kStripThreads)
fine2_raster_kernel(const float* __restrict__ tri_rec, int rec_stride,
                    const int* __restrict__ tri8, const int* __restrict__ group_start,
                    const int* __restrict__ group_rows, const int* __restrict__ x0y0,
                    int origin_x, int origin_y, int n_vary,
                    const float* __restrict__ init_depth, float* __restrict__ depth_out,
                    int* __restrict__ winner_out, float* __restrict__ vary_out,
                    int* __restrict__ ev_count, float* __restrict__ ev_maxz) {
  __shared__ float s_geom[kStrips][kWarp][trt::kGeom];
  __shared__ int s_tri[kStrips][kWarp];

  const int g = blockIdx.x;
  const int k = threadIdx.x / kWarp;      // slot
  const int lane = threadIdx.x % kWarp;
  const int* o = x0y0 + (static_cast<size_t>(g) * kStrips + k) * 2;
  const int x = origin_x + o[0] + lane % kStripW;
  const int y = origin_y + o[1] + lane / kStripW;
  trt::strip_column<TH, STATS>(tri_rec, rec_stride, tri8, group_start[g], group_rows[g], g,
                               x, y, n_vary, init_depth, depth_out, winner_out, vary_out,
                               ev_count, ev_maxz, s_geom[k], s_tri[k]);
}

template <int TH, bool STATS>
void launch(int n_groups, cudaStream_t s, const float* tri_rec, int rec_stride,
            const int* tri8, const int* group_start, const int* group_rows,
            const int* x0y0, int origin_x, int origin_y, int n_vary,
            const float* init_depth, float* depth, int* winner, float* vary,
            int* ev_count, float* ev_maxz) {
  fine2_raster_kernel<TH, STATS><<<n_groups, trt::kStripThreads, 0, s>>>(
      tri_rec, rec_stride, tri8, group_start, group_rows, x0y0, origin_x, origin_y,
      n_vary, init_depth, depth, winner, vary, ev_count, ev_maxz);
}

}  // namespace

// init_depth: null (+inf, pass-local) or (G, TH, 128); ev_count and
// ev_maxz: both null (no stats) or both (G, TH, 128)
extern "C" int trt_fine2_raster(const float* tri_rec, int rec_stride, const int* tri8,
                                const int* group_start, const int* group_rows,
                                const int* x0y0, int n_groups, int origin_x, int origin_y,
                                int tile_h, int tile_w, int n_vary,
                                const float* init_depth, float* depth, int* winner,
                                float* vary, int* ev_count, float* ev_maxz,
                                void* stream) {
  if (tile_w != trt::kTileW || (tile_h != 16 && tile_h != 32) || n_groups <= 0 ||
      (ev_count == nullptr) != (ev_maxz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = ev_count != nullptr;
  using Launch = decltype(&launch<16, false>);
  const Launch fn = tile_h == 32 ? (stats ? &launch<32, true> : &launch<32, false>)
                                 : (stats ? &launch<16, true> : &launch<16, false>);
  fn(n_groups, s, tri_rec, rec_stride, tri8, group_start, group_rows, x0y0, origin_x,
     origin_y, n_vary, init_depth, depth, winner, vary, ev_count, ev_maxz);
  return static_cast<int>(cudaGetLastError());
}
