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
// more with stats), each touched once.  Each step of a walk waits on the
// one before it, so a walk runs at the latency of one step; one block
// walking a tile's rows made the kernel as long as its longest tile (255
// rows on the 2048² headline pass, whose median tile has 16).
//
// What the design does about it.  A tile's triangles are binned per 16-px
// strip, so a pixel walks only the triangles whose bbox touches its own
// strip; and a tile's rows are cut into ranges, the split walk of
// raster_strip.cuh shared with the grouped strip raster (raster_fine2.cu).
// A tile is a block of that walk whose 8 slots are its 8 adjacent strips;
// this file keeps the tile-origin policy, the range length and the launch
// bounds:
//  * a tile's rows[a] slot rows are cut into ranges of at most R =
//    kTileRangeArea / TH rows (32 at 16-row tiles, 16 at 32: the same
//    pixel work an item), in row order (= submission order, build_bins
//    sorts stably); each range is one block of 8 warps, warp k on strip k
//    (item_scan_kernel, find_item).  The grid is tile_ids.shape[0] +
//    ceil(tri8.shape[0] / R) blocks, known to the host without a readback;
//    surplus blocks exit;
//  * warp k walks only its own slot column and stops at the first -1 (a
//    strip's bin is a prefix of its column, and of any run of its rows), so
//    a strip that ends inside a range ends its walk there while a sibling
//    goes on; a strip empty in the range (a ragged right edge) still
//    writes the init depth, -1 and zero varyings;
//  * a tile of one range walks it from its running depth init_depth[a]
//    and writes its outputs directly; the ranges of a longer tile write
//    their first minima from +inf to partial planes, and the merge folds
//    them in range order with strict-less from init_depth[a], so the first
//    drawn still wins a tie across a range edge, then runs loop 2;
//  * the stats variant (STATS = true) counts every z < depth step as a
//    z-pass event, from the running depth; the merge leaves each range's
//    entering depth in its partial plane and the events walk counts the
//    range's events again from there (exact integer atomics);
//  * a pass whose tiles all fit one range (the caller's max_rows; the room
//    pass's tiles hold at most 2 rows) takes one launch: the walk alone,
//    one block a tile walking all of its rows, no scan, merge or events.
//
// Not done yet: a strip's 16 columns make 64-byte store segments, half
// the coalescing of the coarse kernel's 128-float rows; a block keeps its
// idle warps until its longest strip ends the range.

#include <cuda_runtime.h>

#include "raster_strip.cuh"

namespace {

using trt::kStripW;
using trt::kTileW;

// a range's slot rows x the tile's pixel rows: a work item is R =
// kTileRangeArea / TH slot rows (R = 16, 32 and 64 timed at both heights:
// 16 was best at 32-row tiles, 32 at 16-row tiles)
constexpr int kTileRangeArea = 512;
template <int TH>
constexpr int range_rows() {
  return kTileRangeArea / TH;
}
// resident walk blocks an SM holds at the least (a launch bound): 4 caps a
// thread at 64 registers; the 32-row walks with event counts (16 pixels a
// thread) keep 128, as they spill at fewer
constexpr int kTileMinBlocks = 4;
constexpr int kTileMinBlocksStats32 = 2;
template <int TH, bool STATS>
constexpr int min_blocks() {
  return TH == 32 && STATS ? kTileMinBlocksStats32 : kTileMinBlocks;
}

// slot k of active tile a: strip k of tile tile_ids[a]
struct TileOrigins {
  const int* tile_ids;
  int n_tiles_x, tile_h;
  __device__ int2 operator()(int a, int k) const {
    const int tile = tile_ids[a];
    return make_int2((tile % n_tiles_x) * kTileW + k * kStripW, (tile / n_tiles_x) * tile_h);
  }
};

template <int TH, bool STATS>
int launch(const trt::StripLaunch& p, const TileOrigins& origin, int n_items, cudaStream_t s) {
  return trt::strip_launch<TH, STATS, range_rows<TH>(), min_blocks<TH, STATS>(),
                           min_blocks<TH, true>()>(p, origin, n_items, s);
}

}  // namespace

// A work item's slot rows times the tile's pixel rows, for the host's grid
// and scratch sizes.
extern "C" int trt_fine_range_area() { return kTileRangeArea; }

// init_depth: (A, TH, 128); ev_count and ev_maxz: both null (no stats) or
// both (A, TH, 128); n_items: A + ceil(n_rows / (trt_fine_range_area() /
// TH)), the walk's grid; scratch: n_items * TH * 128 floats, as many ints,
// then A + 1 ints, or null for the one launch (every tile walks all of its
// rows in one block: for a pass whose tiles all fit one range)
extern "C" int trt_fine_raster(const float* tri_rec, int rec_stride, const int* tri8,
                               const int* tile_ids, const int* row_start,
                               const int* rows, int n_active, int origin_x,
                               int origin_y, int n_tiles_x, int tile_h, int tile_w,
                               int n_vary, const float* init_depth, float* depth,
                               int* winner, float* vary, int* ev_count,
                               float* ev_maxz, int n_items, void* scratch, void* stream) {
  if (tile_w != kTileW || (tile_h != 16 && tile_h != 32) || n_active <= 0 ||
      n_items < n_active || init_depth == nullptr ||
      (ev_count == nullptr) != (ev_maxz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t part = static_cast<size_t>(n_items) * tile_h * kTileW;
  float* part_d = static_cast<float*>(scratch);
  int* part_w = scratch ? reinterpret_cast<int*>(part_d + part) : nullptr;
  const trt::StripLaunch p{tri_rec, rec_stride, tri8, row_start, rows, n_active,
                           origin_x, origin_y, n_vary, init_depth, depth, winner, vary,
                           ev_count, ev_maxz, scratch ? part_w + part : nullptr, part_d,
                           part_w};
  const TileOrigins origin{tile_ids, n_tiles_x, tile_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = ev_count != nullptr;
  if (tile_h == 32)
    return stats ? launch<32, true>(p, origin, n_items, s)
                 : launch<32, false>(p, origin, n_items, s);
  return stats ? launch<16, true>(p, origin, n_items, s)
               : launch<16, false>(p, origin, n_items, s);
}
