// Coarse raster over compacted active tiles or over every tile, for Hopper
// (sm_90a).
//
// Replaces: tinyrenderder_tpu/ops/raster_pallas.py::_tile_kernel, as
// launched over active tiles by _pallas_call_sparse_jit, with and
// without its collect_stats event planes, and as launched over the dense
// grid of every tile by _pallas_call_jit (rasterize_pallas,
// depth_resolve_pallas).  Plain version and contract:
// tinyrenderder_tpu_torch/ops/raster_coarse.py.
//
// What bounds it on this card: per-pixel arithmetic.  For every (pixel,
// pair) inside the pair's bbox a thread evaluates the barycentric
// coverage with three IEEE divisions and the affine depth; memory traffic
// is small (16 floats per pair, read once per block into shared memory,
// and the tile's outputs written once).  IEEE division without FMA
// contraction is the price of bitwise parity with the reference.  Each
// step of a walk depends on the one before it (the running depth), so a
// walk runs at the latency of one step; one block walking a tile's whole
// bin made the kernel as long as the longest bin (691 pairs on the 2048²
// headline pass, whose median bin is 55).
//
// Design: the split walk of raster_common.cuh.
//  * a tile's bin is cut into ranges of at most kRangePairs pairs, in bin
//    order; each range is one block of 256 threads (item_scan_kernel gives
//    each tile its first item, find_item an item its tile and range).
//    The grid is count.shape[0] + ceil(sorted_tri.shape[0] / kRangePairs)
//    blocks, what the host knows without a readback (the ranges of bins
//    that are disjoint parts of sorted_tri are no more); surplus blocks
//    exit.  Thread t owns the pixels t, t + 256, ... of the tile (column
//    t % 128), so every store is a coalesced 128-float row segment;
//  * a walk streams its pairs IN BIN ORDER through shared memory in chunks
//    and keeps, per pixel in registers, the depth and winner of a
//    sequential strict-less update: the reference's first-drawn-wins
//    z-test.  A pixel outside a pair's integer bbox skips the pair before
//    any arithmetic: the bbox test is one factor of the coverage AND, so
//    skipping changes nothing;
//  * a tile of one range (the dense launch's empty tiles too) walks it from
//    its init depth and writes depth, winner, varyings and, with stats, the
//    event planes directly.  A longer bin's ranges each write their first
//    minimum from +inf to partial planes, and coarse_merge_kernel folds them
//    in range order with strict-less from the init depth (merge_ranges),
//    then runs loop 2: each pixel reads its winner's row from global memory
//    and interpolates the varyings;
//  * the stats launch (STATS = true) counts z-pass events: every covered
//    step with z < depth of the sequential strict-less update IS an event
//    (our_gl.cpp:194), from the running init depth.  A range's events
//    depend on the depth it enters with, so the merge leaves each range's
//    entering depth (the exclusive prefix) in its partial plane, and
//    coarse_events_kernel walks the range again from there and adds its
//    count and largest event z into the planes (add_events: exact integer
//    atomics).  Depth, winner and varyings come from the walk and the
//    merge alone, as without stats;
//  * arithmetic follows tinyrenderder_tpu/ops/semantics.py operation for
//    operation, built with -fmad=false and IEEE division; thresholds are
//    float literals (the reference compares in float32).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "raster_common.cuh"

namespace {

using trt::kGeom;
using trt::kTileW;

constexpr int kThreads = trt::kBlockThreads;
constexpr int kRangePairs = 32;  // pairs of a bin's range: one work item
constexpr int kChunk = kRangePairs;  // pairs staged at a time: a whole range
constexpr int kWarpCols = 16;        // columns a walk warp covers (16 or 32)
static_assert(kWarpCols == 16 || kWarpCols == 32, "a thread's rows are 2 apart");
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
struct Coarse {
  const float* tri_rec;
  int rec_stride;
  const int* sorted_tri;
  const int* tile_ids;  // null: block a is tile a (the dense launch)
  const int* start;
  const int* count;
  int n_active, origin_x, origin_y, n_tiles_x, n_vary;
  const float* init_depth;
  float* depth;
  int* winner;
  float* vary;
  int* ev_count;   // null without stats
  float* ev_maxz;
  int* starts;     // (n_active + 1,) each tile's first item, then the total
  float* part_d;   // (items, TH, 128) a range's first minimum, or its entering depth
  int* part_w;     // (items, TH, 128) its winner
};

// The global pixel of output block a's top-left corner.
template <int TH>
__device__ __forceinline__ void tile_origin(const Coarse& p, int a, int& x0, int& y0) {
  const int tile = p.tile_ids ? p.tile_ids[a] : a;
  x0 = p.origin_x + (tile % p.n_tiles_x) * kTileW;
  y0 = p.origin_y + (tile / p.n_tiles_x) * TH;
}

// A walk's thread map: warp w owns kWarpCols columns of a tile row pair,
// lane l column (w % (128 / kWarpCols)) * kWarpCols + l % kWarpCols in rows
// r0, r0 + 2, ... (r0 = l / kWarpCols, or w / 4 for 32 columns).  A
// triangle a few pixels wide then wakes fewer, fuller warps than with
// 32-column rows.  -> the thread's offset of its first pixel in the plane.
__device__ __forceinline__ int walk_offset() {
  constexpr int kPerRow = kTileW / kWarpCols;  // warps across a row
  const int w = threadIdx.x / trt::kWarp, lane = threadIdx.x % trt::kWarp;
  const int col = (w % kPerRow) * kWarpCols + lane % kWarpCols;
  const int row0 = lane / kWarpCols + (w / kPerRow) * (trt::kWarp / kWarpCols);
  return row0 * kTileW + col;
}

// Loop 1 over pairs p0 .. p1 - 1 of the bin at seg, in bin order.
template <int kPix, bool STATS>
__device__ __forceinline__ void bin_walk(const Coarse& p, int seg, int p0, int p1, float fx,
                                         int gy0, float* depth, int* win, int* events,
                                         float* maxz, float (*s_geom)[kGeom], int* s_tri) {
  constexpr int kRowStep = kThreads / kTileW;
  const int tid = threadIdx.x;
  for (int c0 = p0; c0 < p1; c0 += kChunk) {
    const int m = min(kChunk, p1 - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < m * kGeom; i += kThreads) {
      const int q = i / kGeom, c = i % kGeom;
      const int tri = p.sorted_tri[seg + c0 + q];
      s_geom[q][c] = p.tri_rec[static_cast<size_t>(tri) * p.rec_stride + c];
      if (c == 0) s_tri[q] = tri;
    }
    __syncthreads();
    for (int q = 0; q < m; ++q) {
      const float* g = s_geom[q];
      if (fx < g[12] || fx > g[13]) continue;  // column outside the bbox
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        trt::depth_step<STATS>(g, s_tri[q], fx, static_cast<float>(gy0 + k * kRowStep),
                               depth[k], win[k], events[STATS ? k : 0], maxz[STATS ? k : 0]);
    }
  }
}

// One block per work item: a tile of one range walks its bin from the init
// depth and writes its outputs; a range of a longer bin walks from +inf
// and writes its first minimum to the partial planes at the item's index.
template <int TH, bool STATS>
__global__ void __launch_bounds__(kThreads, min_blocks<TH, STATS>())
coarse_walk_kernel(const Coarse p) {
  constexpr int kPix = TH * kTileW / kThreads;  // pixels per thread
  constexpr int kRowStep = kThreads / kTileW;   // rows between them
  __shared__ float s_geom[kChunk][kGeom];
  __shared__ int s_tri[kChunk];

  const int item = blockIdx.x;
  if (item >= p.starts[p.n_active]) return;  // a surplus block
  const int2 ar = trt::find_item(p.starts, p.n_active, item);
  const int a = ar.x;
  const int n = p.count[a];
  const bool whole = trt::range_items<kRangePairs>(n) == 1;
  const int p0 = ar.y * kRangePairs;
  const int base = walk_offset();
  int x0, y0;
  tile_origin<TH>(p, a, x0, y0);
  const float fx = static_cast<float>(x0 + base % kTileW);
  const int gy0 = y0 + base / kTileW;
  const size_t plane = static_cast<size_t>(TH) * kTileW;

  float depth[kPix];
  int win[kPix];
  int events[STATS ? kPix : 1];   // z-pass events (our_gl.cpp:194)
  float maxz[STATS ? kPix : 1];   // largest event z (our_gl.cpp:199)
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    depth[k] = whole ? p.init_depth[a * plane + base + k * kThreads] : CUDART_INF_F;
    win[k] = -1;
    if constexpr (STATS) {
      events[k] = 0;
      maxz[k] = -CUDART_INF_F;
    }
  }
  // a range of a longer bin counts events from +inf too; they are dropped
  bin_walk<kPix, STATS>(p, p.start[a], p0, min(n, p0 + kRangePairs), fx, gy0, depth, win,
                        events, maxz, s_geom, s_tri);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const size_t o = base + k * kThreads;
    if (whole) {
      trt::store_pixel<STATS>(p.tri_rec, p.rec_stride, a, plane, o, depth[k], win[k],
                              events[STATS ? k : 0], maxz[STATS ? k : 0], fx + 0.5f,
                              static_cast<float>(gy0 + k * kRowStep) + 0.5f, p.n_vary, p.depth,
                              p.winner, p.vary, p.ev_count, p.ev_maxz);
    } else {
      p.part_d[item * plane + o] = depth[k];
      p.part_w[item * plane + o] = win[k];
    }
  }
}

// One block per band of kMergeRows rows of a tile (blockIdx.y): the
// ordered merge of a bin of more than one range.
template <int TH, bool STATS>
__global__ void __launch_bounds__(kThreads) coarse_merge_kernel(const Coarse p) {
  const int a = blockIdx.x;
  const int m = trt::range_items<kRangePairs>(p.count[a]);
  if (m == 1) return;  // written by its walk
  int x0, y0;
  tile_origin<TH>(p, a, x0, y0);
  const float fx = static_cast<float>(x0 + threadIdx.x % kTileW);
  const int gy0 = y0 + threadIdx.x / kTileW;
  trt::merge_ranges<TH, STATS>(p.tri_rec, p.rec_stride, a, blockIdx.y, p.starts[a], m, fx,
                               gy0, p.n_vary, p.init_depth, p.part_d, p.part_w, p.depth,
                               p.winner, p.vary, p.ev_count, p.ev_maxz);
}

// The stats launch's second walk: each range of a bin of more than one
// range, again, from its entering depth; its events go into the planes.
template <int TH>
__global__ void __launch_bounds__(kThreads, min_blocks<TH, true>())
coarse_events_kernel(const Coarse p) {
  constexpr int kPix = TH * kTileW / kThreads;
  __shared__ float s_geom[kChunk][kGeom];
  __shared__ int s_tri[kChunk];

  const int item = blockIdx.x;
  if (item >= p.starts[p.n_active]) return;
  const int2 ar = trt::find_item(p.starts, p.n_active, item);
  const int a = ar.x;
  const int n = p.count[a];
  if (trt::range_items<kRangePairs>(n) == 1) return;  // no range to seed
  const int base = walk_offset();
  int x0, y0;
  tile_origin<TH>(p, a, x0, y0);
  const float fx = static_cast<float>(x0 + base % kTileW);
  const int gy0 = y0 + base / kTileW;
  const size_t plane = static_cast<size_t>(TH) * kTileW;
  float depth[kPix], maxz[kPix];
  int win[kPix], events[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    depth[k] = p.part_d[item * plane + base + k * kThreads];
    win[k] = -1;
    events[k] = 0;
    maxz[k] = -CUDART_INF_F;
  }
  const int p0 = ar.y * kRangePairs;
  bin_walk<kPix, true>(p, p.start[a], p0, min(n, p0 + kRangePairs), fx, gy0, depth, win,
                       events, maxz, s_geom, s_tri);
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const size_t at = a * plane + base + k * kThreads;
    trt::add_events(p.ev_count + at, p.ev_maxz + at, events[k], maxz[k]);
  }
}

template <int TH, bool STATS>
int launch(const Coarse& p, int n_items, cudaStream_t s) {
  trt::item_scan_kernel<kRangePairs><<<1, trt::kScanThreads, 0, s>>>(p.count, p.n_active,
                                                                     p.starts);
  coarse_walk_kernel<TH, STATS><<<n_items, kThreads, 0, s>>>(p);
  coarse_merge_kernel<TH, STATS><<<dim3(p.n_active, TH / trt::kMergeRows), kThreads, 0, s>>>(p);
  if constexpr (STATS) coarse_events_kernel<TH><<<n_items, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The bin range of one work item, for the host's grid and scratch sizes.
extern "C" int trt_coarse_range_pairs() { return kRangePairs; }

// tile_ids: (A,) tile of each block, or null for the dense launch over
// tiles 0 .. A - 1; ev_count and ev_maxz: both null (no stats) or both
// (A, TH, 128); n_items: A + ceil(n_pairs / trt_coarse_range_pairs()), the
// walk's grid; scratch: n_items * TH * 128 floats, as many ints, then A + 1
// ints
extern "C" int trt_coarse_raster(const float* tri_rec, int rec_stride,
                                 const int* sorted_tri, const int* tile_ids,
                                 const int* start, const int* count, int n_active,
                                 int origin_x, int origin_y, int n_tiles_x,
                                 int tile_h, int tile_w, int n_vary,
                                 const float* init_depth, float* depth,
                                 int* winner, float* vary, int* ev_count,
                                 float* ev_maxz, int n_items, void* scratch,
                                 void* stream) {
  if (tile_w != kTileW || (tile_h != 16 && tile_h != 32) || n_active <= 0 ||
      n_items < n_active || (ev_count == nullptr) != (ev_maxz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t part = static_cast<size_t>(n_items) * tile_h * kTileW;
  float* part_d = static_cast<float*>(scratch);
  int* part_w = reinterpret_cast<int*>(part_d + part);
  const Coarse p{tri_rec, rec_stride, sorted_tri, tile_ids, start, count, n_active,
                 origin_x, origin_y, n_tiles_x, n_vary, init_depth, depth, winner, vary,
                 ev_count, ev_maxz, part_w + part, part_d, part_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool stats = ev_count != nullptr;
  if (tile_h == 32)
    return stats ? launch<32, true>(p, n_items, s) : launch<32, false>(p, n_items, s);
  return stats ? launch<16, true>(p, n_items, s) : launch<16, false>(p, n_items, s);
}
