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
// cuts the tests to a pixel's own 16-px strip, but one block walks a tile's
// 8 strips, and a block stays resident until its longest strip is done.
// Here a block walks a GROUP of 8 strips taken from anywhere on the screen:
// the pre-stage sorts every strip by its count (one stable descending
// argsort) and gives rank r to group r / 8, slot r % 8, so the 8 walks of a
// block are near-equal.  And a group's rows are cut into ranges (the split
// walk of raster_common.cuh, shared with raster_coarse.cu):
//  * a group's rows are cut into ranges of at most kRangeRows slot rows, in
//    row order; each range is one block of 8 warps (item_scan_kernel,
//    find_item).  The grid is group_start.shape[0] + ceil(tri8.shape[0] /
//    kRangeRows) blocks, known to the host without a readback; surplus
//    blocks exit.  Warp k owns slot k, whose strip's pixel origin comes
//    from the slot-origin table x0y0 (G, 8, 2), plus the pass origin;
//  * the warp walks its own column of the slot table over the range's rows
//    with trt::strip_walk (raster_common.cuh, shared with raster_fine.cu):
//    32 triangles' geometry staged in shared memory, the sequential
//    strict-less depth_step in every lane, a stop at the first -1 (a
//    strip's bin is a prefix of its column).  An empty slot (fewer than 8
//    strips with pairs in the last group) writes +inf (or its init), -1 and
//    zero varyings;
//  * a group of one range walks it from its running depth and writes its
//    outputs directly; the ranges of a longer group write their first
//    minima from +inf to partial planes, and
//    fine2_merge_kernel folds them in range order with strict-less
//    (trt::merge_ranges), then writes the varyings of each winner;
//  * depth starts at +inf (pass-local: the post stage merges it into the
//    frame with a strict-less select), or at the running depth of each
//    slot's strip in the stats instantiation (STATS), whose events are
//    then every z < depth step, as in the other rasters.  With stats the
//    merge leaves each range's entering depth in its partial plane and
//    fine2_events_kernel walks the range again from it, adding its events
//    into the planes (trt::add_events).
//
// Not done yet: 64-byte store segments per strip, as in raster_fine.cu;
// the outputs go through device memory in group space and the post stage
// regroups them.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "raster_common.cuh"

namespace {

using trt::kGeom;
using trt::kStrips;
using trt::kStripW;
using trt::kTileW;
using trt::kWarp;

constexpr int kRangeRows = 32;  // slot rows of a group's range: one work item
constexpr int kRowStep = kWarp / kStripW;  // a lane's pixels are 2 rows apart
// resident walk blocks an SM holds at the least (a launch bound): 4 caps a
// thread at 64 registers; the 32-row walks with event counts (16 pixels a
// thread) keep 128, as they spill at fewer
constexpr int kMinBlocks = 4;
constexpr int kMinBlocksStats32 = 2;
template <int TH, bool STATS>
constexpr int min_blocks() {
  return TH == 32 && STATS ? kMinBlocksStats32 : kMinBlocks;
}

// the launch: every pointer and size the kernels share
struct Fine2 {
  const float* tri_rec;
  int rec_stride;
  const int* tri8;
  const int* group_start;
  const int* group_rows;
  const int* x0y0;
  int n_groups, origin_x, origin_y, n_vary;
  const float* init_depth;  // null: +inf, pass-local
  float* depth;
  int* winner;
  float* vary;
  int* ev_count;   // null without stats
  float* ev_maxz;
  int* starts;     // (n_groups + 1,) each group's first item, then the total
  float* part_d;   // (items, TH, 128) a range's first minimum, or its entering depth
  int* part_w;     // (items, TH, 128) its winner
};

// This lane's pixel column and first row in group g, and its offset in
// the TH x 128 plane (the strip map of trt::strip_column).
__device__ __forceinline__ int lane_pixel(const Fine2& p, int g, int& x, int& y) {
  const int k = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int* o = p.x0y0 + (static_cast<size_t>(g) * kStrips + k) * 2;
  x = p.origin_x + o[0] + lane % kStripW;
  y = p.origin_y + o[1] + lane / kStripW;
  return (lane / kStripW) * kTileW + k * kStripW + lane % kStripW;
}

// One block per work item: a group of one range walks it from its running
// depth and writes its outputs; a range of a longer group walks from +inf
// and writes its first minimum to the partial planes at the item's index.
template <int TH, bool STATS>
__global__ void __launch_bounds__(trt::kStripThreads, min_blocks<TH, STATS>())
fine2_walk_kernel(const Fine2 p) {
  constexpr int kPix = TH / kRowStep;
  __shared__ float s_geom[kStrips][kWarp][kGeom];
  __shared__ int s_tri[kStrips][kWarp];

  const int item = blockIdx.x;
  if (item >= p.starts[p.n_groups]) return;  // a surplus block
  const int2 gr = trt::find_item(p.starts, p.n_groups, item);
  const int g = gr.x;
  const int rows = p.group_rows[g];
  const bool whole = trt::range_items<kRangeRows>(rows) == 1;
  const int r0 = gr.y * kRangeRows;
  const int k = threadIdx.x / kWarp;
  int x, y;
  const int o = lane_pixel(p, g, x, y);
  const size_t plane = static_cast<size_t>(TH) * kTileW;
  const float* init = whole && p.init_depth ? p.init_depth + g * plane : nullptr;

  float depth[kPix];
  int win[kPix];
  int events[STATS ? kPix : 1];   // z-pass events (our_gl.cpp:194)
  float maxz[STATS ? kPix : 1];   // largest event z (our_gl.cpp:199)
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    depth[i] = init ? init[o + i * kRowStep * kTileW] : CUDART_INF_F;
    win[i] = -1;
    if constexpr (STATS) {
      events[i] = 0;
      maxz[i] = -CUDART_INF_F;
    }
  }
  // a range of a longer group counts events from +inf too; they are dropped
  trt::strip_walk<kPix, STATS>(p.tri_rec, p.rec_stride, p.tri8, p.group_start[g] + r0,
                               min(kRangeRows, rows - r0), static_cast<float>(x), y, depth,
                               win, events, maxz, s_geom[k], s_tri[k]);
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const size_t at = o + i * kRowStep * kTileW;
    if (whole) {
      trt::store_pixel<STATS>(p.tri_rec, p.rec_stride, g, plane, at, depth[i], win[i],
                              events[STATS ? i : 0], maxz[STATS ? i : 0],
                              static_cast<float>(x) + 0.5f,
                              static_cast<float>(y + i * kRowStep) + 0.5f, p.n_vary, p.depth,
                              p.winner, p.vary, p.ev_count, p.ev_maxz);
    } else {
      p.part_d[item * plane + at] = depth[i];
      p.part_w[item * plane + at] = win[i];
    }
  }
}

// One block per band of kMergeRows rows of a group (blockIdx.y): the
// ordered merge of a group of more than one range, thread t on column
// t % 128 (slot t % 128 / 16) of the group.
template <int TH, bool STATS>
__global__ void __launch_bounds__(trt::kBlockThreads) fine2_merge_kernel(const Fine2 p) {
  const int g = blockIdx.x;
  const int m = trt::range_items<kRangeRows>(p.group_rows[g]);
  if (m == 1) return;  // written by its walk
  const int col = threadIdx.x % kTileW;
  const int* o = p.x0y0 + (static_cast<size_t>(g) * kStrips + col / kStripW) * 2;
  const float fx = static_cast<float>(p.origin_x + o[0] + col % kStripW);
  const int gy0 = p.origin_y + o[1] + threadIdx.x / kTileW;
  trt::merge_ranges<TH, STATS>(p.tri_rec, p.rec_stride, g, blockIdx.y, p.starts[g], m, fx,
                               gy0, p.n_vary, p.init_depth, p.part_d, p.part_w, p.depth,
                               p.winner, p.vary, p.ev_count, p.ev_maxz);
}

// The stats launch's second walk: each range of a group of more than one
// range, again, from its entering depth; its events go into the planes.
template <int TH>
__global__ void __launch_bounds__(trt::kStripThreads, min_blocks<TH, true>())
fine2_events_kernel(const Fine2 p) {
  constexpr int kPix = TH / kRowStep;
  __shared__ float s_geom[kStrips][kWarp][kGeom];
  __shared__ int s_tri[kStrips][kWarp];

  const int item = blockIdx.x;
  if (item >= p.starts[p.n_groups]) return;
  const int2 gr = trt::find_item(p.starts, p.n_groups, item);
  const int g = gr.x;
  const int rows = p.group_rows[g];
  if (trt::range_items<kRangeRows>(rows) == 1) return;  // no range to seed
  const int k = threadIdx.x / kWarp;
  int x, y;
  const int o = lane_pixel(p, g, x, y);
  const size_t plane = static_cast<size_t>(TH) * kTileW;
  float depth[kPix], maxz[kPix];
  int win[kPix], events[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    depth[i] = p.part_d[item * plane + o + i * kRowStep * kTileW];
    win[i] = -1;
    events[i] = 0;
    maxz[i] = -CUDART_INF_F;
  }
  const int r0 = gr.y * kRangeRows;
  trt::strip_walk<kPix, true>(p.tri_rec, p.rec_stride, p.tri8, p.group_start[g] + r0,
                              min(kRangeRows, rows - r0), static_cast<float>(x), y, depth,
                              win, events, maxz, s_geom[k], s_tri[k]);
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const size_t at = g * plane + o + i * kRowStep * kTileW;
    trt::add_events(p.ev_count + at, p.ev_maxz + at, events[i], maxz[i]);
  }
}

template <int TH, bool STATS>
int launch(const Fine2& p, int n_items, cudaStream_t s) {
  trt::item_scan_kernel<kRangeRows><<<1, trt::kScanThreads, 0, s>>>(p.group_rows, p.n_groups,
                                                                    p.starts);
  fine2_walk_kernel<TH, STATS><<<n_items, trt::kStripThreads, 0, s>>>(p);
  fine2_merge_kernel<TH, STATS>
      <<<dim3(p.n_groups, TH / trt::kMergeRows), trt::kBlockThreads, 0, s>>>(p);
  if constexpr (STATS) fine2_events_kernel<TH><<<n_items, trt::kStripThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
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
      n_items < n_groups || (ev_count == nullptr) != (ev_maxz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t part = static_cast<size_t>(n_items) * tile_h * kTileW;
  float* part_d = static_cast<float*>(scratch);
  int* part_w = reinterpret_cast<int*>(part_d + part);
  const Fine2 p{tri_rec, rec_stride, tri8, group_start, group_rows, x0y0, n_groups,
                origin_x, origin_y, n_vary, init_depth, depth, winner, vary, ev_count,
                ev_maxz, part_w + part, part_d, part_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = ev_count != nullptr;
  if (tile_h == 32)
    return stats ? launch<32, true>(p, n_items, s) : launch<32, false>(p, n_items, s);
  return stats ? launch<16, true>(p, n_items, s) : launch<16, false>(p, n_items, s);
}
