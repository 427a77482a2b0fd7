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
// Each step of a walk waits on the one before it, so a walk runs at the
// latency of one step; one block walking a group's rows made the kernel as
// long as its largest group (1,273 rows on the 246k stress pass, whose
// median group has 92).
//
// What the design does about it.  The strip raster (raster_fine.cu) already
// cuts the tests to a pixel's own 16-px strip, but a block walks a tile's 8
// strips, and a block stays resident until its longest strip is done.
// Here a block walks a GROUP of 8 strips taken from anywhere on the screen:
// the pre-stage sorts every strip by its count (one stable descending
// argsort) and gives rank r to group r / 8, slot r % 8, so the 8 walks of a
// block are near-equal.  And a group's rows are cut into ranges (the split
// walk of raster_strip.cuh, shared with raster_fine.cu, whose blocks are
// a tile's 8 strips; this file keeps the slot-origin policy, the range
// length and the launch bounds):
//  * a group's rows are cut into ranges of at most kRangeRows slot rows, in
//    row order; each range is one block of 8 warps (item_scan_kernel,
//    find_item).  The grid is group_start.shape[0] + ceil(tri8.shape[0] /
//    kRangeRows) blocks, known to the host without a readback; surplus
//    blocks exit.  Warp k owns slot k, whose strip's pixel origin comes
//    from the slot-origin table x0y0 (G, 8, 2), plus the pass origin;
//  * the warp walks its own column of the slot table over the range's rows
//    with trt::strip_walk: 32 triangles' geometry staged in shared memory,
//    the sequential strict-less depth_step in every lane, a stop at the
//    first -1 (a strip's bin is a prefix of its column).  An empty slot (fewer than 8
//    strips with pairs in the last group) writes +inf (or its init), -1 and
//    zero varyings;
//  * a group of one range walks it from its running depth and writes its
//    outputs directly; the ranges of a longer group write their first
//    minima from +inf to partial planes, and strip_merge_kernel folds them
//    in range order with strict-less (trt::merge_ranges), then writes the
//    varyings of each winner;
//  * depth starts at +inf (pass-local: the post stage merges it into the
//    frame with a strict-less select), or at the running depth of each
//    slot's strip in the stats instantiation (STATS), whose events are
//    then every z < depth step, as in the other rasters.  With stats the
//    merge leaves each range's entering depth in its partial plane and
//    strip_events_kernel walks the range again from it, adding its events
//    into the planes (trt::add_events).
//
// Not done yet: 64-byte store segments per strip, as in raster_fine.cu;
// the outputs go through device memory in group space and the post stage
// regroups them.

#include <cuda_runtime.h>

#include "raster_strip.cuh"

namespace {

using trt::kStrips;
using trt::kTileW;

constexpr int kRangeRows = 32;  // slot rows of a group's range: one work item
// resident walk blocks an SM holds at the least (a launch bound): 4 caps a
// thread at 64 registers; the 32-row walks with event counts (16 pixels a
// thread) keep 128, as they spill at fewer
constexpr int kMinBlocks = 4;
constexpr int kMinBlocksStats32 = 2;
template <int TH, bool STATS>
constexpr int min_blocks() {
  return TH == 32 && STATS ? kMinBlocksStats32 : kMinBlocks;
}

// slot k of group g: its strip's place on the screen, the table x0y0 (G, 8, 2)
struct SlotOrigins {
  const int* x0y0;
  __device__ int2 operator()(int g, int k) const {
    const int* o = x0y0 + (static_cast<size_t>(g) * kStrips + k) * 2;
    return make_int2(o[0], o[1]);
  }
};

template <int TH, bool STATS>
int launch(const trt::StripLaunch& p, const SlotOrigins& origin, int n_items, cudaStream_t s) {
  return trt::strip_launch<TH, STATS, kRangeRows, min_blocks<TH, STATS>(),
                           min_blocks<TH, true>()>(p, origin, n_items, s);
}

}  // namespace

// The slot rows of one work item, for the host's grid and scratch sizes.
extern "C" int trt_fine2_range_rows() { return kRangeRows; }

// init_depth: null (+inf, pass-local) or (G, TH, 128); ev_count and
// ev_maxz: both null (no stats) or both (G, TH, 128); n_items: G +
// ceil(n_rows / trt_fine2_range_rows()), the walk's grid; scratch: n_items *
// TH * 128 floats, as many ints, then G + 1 ints
extern "C" int trt_fine2_raster(const float* tri_rec, int rec_stride, const int* tri8,
                                const int* group_start, const int* group_rows,
                                const int* x0y0, int n_groups, int origin_x, int origin_y,
                                int tile_h, int tile_w, int n_vary,
                                const float* init_depth, float* depth, int* winner,
                                float* vary, int* ev_count, float* ev_maxz, int n_items,
                                void* scratch, void* stream) {
  if (tile_w != kTileW || (tile_h != 16 && tile_h != 32) || n_groups <= 0 ||
      n_items < n_groups || scratch == nullptr ||
      (ev_count == nullptr) != (ev_maxz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t part = static_cast<size_t>(n_items) * tile_h * kTileW;
  float* part_d = static_cast<float*>(scratch);
  int* part_w = reinterpret_cast<int*>(part_d + part);
  const trt::StripLaunch p{tri_rec, rec_stride, tri8, group_start, group_rows, n_groups,
                           origin_x, origin_y, n_vary, init_depth, depth, winner, vary,
                           ev_count, ev_maxz, part_w + part, part_d, part_w};
  const SlotOrigins origin{x0y0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = ev_count != nullptr;
  if (tile_h == 32)
    return stats ? launch<32, true>(p, origin, n_items, s)
                 : launch<32, false>(p, origin, n_items, s);
  return stats ? launch<16, true>(p, origin, n_items, s)
               : launch<16, false>(p, origin, n_items, s);
}
