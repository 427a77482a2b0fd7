// The split walk of the two strip rasters (raster_fine.cu: a block of 8
// adjacent strips per active tile; raster_fine2.cu: a group of 8 strips
// from anywhere on the screen), on the machinery of raster_common.cuh.
//
// An output block is kStrips slots of kStripW columns by TH rows; slot k's
// strip walks column k of the slot table tri8 over the block's slot rows
// block_start[b] .. + block_rows[b] - 1 (a strip's bin is a prefix of its
// column).  The two rasters differ only in where slot k's pixels lie: the
// Origin policy, a functor origin(b, k) -> the pixel offset of slot k of
// block b's top-left corner (the pass origin is added here).  The kernels:
//  * strip_walk_kernel: one block of 8 warps per work item, warp k on slot
//    k.  With the item scan (starts non-null), a block's rows are cut into
//    ranges of R rows: a block of one range walks it from its running depth
//    and writes its outputs; each range of a longer block writes its first
//    minimum from +inf to the partial planes at its item's index.  Without
//    (starts null) block b walks all of its rows as one item: the one
//    launch of a pass whose blocks all fit one range;
//  * strip_merge_kernel: the ordered strict-less merge of a block of more
//    than one range (trt::merge_ranges), then loop 2;
//  * strip_events_kernel (stats): each range of such a block walked again
//    from its entering depth, its events added into the planes.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include "raster_common.cuh"

namespace trt {

// Loop 1 of one warp of a strip raster block: the warp walks slot rows
// seg .. seg + n - 1 of its own column k of tri8 in row order (=
// submission order) and stops at the first -1 (a strip's bin is a prefix
// of its column, so also of any run of rows that starts inside it), 32
// slots at a time: each lane reads one slot id, the warp stages the 32
// triangles' geometry in shared memory (geom, stri: this warp's part), and
// every lane runs the sequential strict-less depth_step over them at its
// kPix pixels (column x, rows y, y + 2, ...).
template <int kPix, bool STATS>
__device__ __forceinline__ void strip_walk(const float* __restrict__ tri_rec, int rec_stride,
                                           const int* __restrict__ tri8, int seg, int n,
                                           float fx, int y, float* depth, int* win,
                                           int* events, float* maxz, float (*geom)[kGeom],
                                           int* stri) {
  constexpr int kRowStep = kWarp / kStripW;  // 2 rows per lane step
  const int k = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  for (int r0 = 0; r0 < n; r0 += kWarp) {
    const int m = min(kWarp, n - r0);
    const int t = lane < m ? tri8[static_cast<size_t>(seg + r0 + lane) * kStrips + k] : -1;
    // the column is a prefix: its live slots are the lanes below the first -1
    const unsigned dead = __ballot_sync(kAll, t < 0);
    const int live = dead ? __ffs(dead) - 1 : kWarp;
    __syncwarp();  // the previous chunk is consumed
    stri[lane] = t;
    __syncwarp();
    for (int i = lane; i < live * kGeom; i += kWarp) {
      const int p = i / kGeom, c = i % kGeom;
      geom[p][c] = tri_rec[static_cast<size_t>(stri[p]) * rec_stride + c];
    }
    __syncwarp();
    for (int p = 0; p < live; ++p) {
      const float* g = geom[p];
      if (fx < g[12] || fx > g[13]) continue;  // column outside the bbox
      const int tri = stri[p];
#pragma unroll
      for (int i = 0; i < kPix; ++i)
        depth_step<STATS>(g, tri, fx, static_cast<float>(y + i * kRowStep), depth[i],
                          win[i], events[STATS ? i : 0], maxz[STATS ? i : 0]);
    }
    if (live < kWarp) break;  // the strip's bin ended in this chunk
  }
}

// the launch: every pointer and size the kernels share
struct StripLaunch {
  const float* tri_rec;
  int rec_stride;
  const int* tri8;
  const int* block_start;   // (n_blocks,) each block's first slot row
  const int* block_rows;    // (n_blocks,) its slot rows
  int n_blocks, origin_x, origin_y, n_vary;
  const float* init_depth;  // (n_blocks, TH, 128), or null: +inf (pass-local)
  float* depth;
  int* winner;
  float* vary;
  int* ev_count;   // null without stats
  float* ev_maxz;
  int* starts;     // (n_blocks + 1,) each block's first item, then the total;
                   // null: one item a block (the walk alone)
  float* part_d;   // (items, TH, 128) a range's first minimum, or its entering depth
  int* part_w;     // (items, TH, 128) its winner
};

constexpr int kStripRowStep = kWarp / kStripW;  // a lane's pixels are 2 rows apart

// This lane's pixel column and first row in block b, and its offset in the
// TH x 128 plane: warp k owns slot k's columns 16k .. 16k + 15, lane l the
// pixels of column 16k + l % 16 in rows l / 16, l / 16 + 2, ...
template <class Origin>
__device__ __forceinline__ int lane_pixel(const StripLaunch& p, const Origin& origin, int b,
                                          int& x, int& y) {
  const int k = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int2 o = origin(b, k);
  x = p.origin_x + o.x + lane % kStripW;
  y = p.origin_y + o.y + lane / kStripW;
  return (lane / kStripW) * kTileW + k * kStripW + lane % kStripW;
}

// One block per work item (see the top of this file).  MINB: the launch
// bound, resident blocks an SM holds at the least.
template <int TH, bool STATS, int R, int MINB, class Origin>
__global__ void __launch_bounds__(kStripThreads, MINB)
strip_walk_kernel(const StripLaunch p, const Origin origin) {
  constexpr int kPix = TH / kStripRowStep;
  __shared__ float s_geom[kStrips][kWarp][kGeom];
  __shared__ int s_tri[kStrips][kWarp];

  const int item = blockIdx.x;
  int b = item, r0 = 0, n;
  bool whole = true;
  if (p.starts) {
    if (item >= p.starts[p.n_blocks]) return;  // a surplus block
    const int2 br = find_item(p.starts, p.n_blocks, item);
    b = br.x;
    const int rows = p.block_rows[b];
    whole = range_items<R>(rows) == 1;
    r0 = br.y * R;
    n = min(R, rows - r0);
  } else {
    n = p.block_rows[b];
  }
  const int k = threadIdx.x / kWarp;
  int x, y;
  const int o = lane_pixel(p, origin, b, x, y);
  const size_t plane = static_cast<size_t>(TH) * kTileW;
  const float* init = whole && p.init_depth ? p.init_depth + b * plane : nullptr;

  float depth[kPix];
  int win[kPix];
  int events[STATS ? kPix : 1];   // z-pass events (our_gl.cpp:194)
  float maxz[STATS ? kPix : 1];   // largest event z (our_gl.cpp:199)
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    depth[i] = init ? init[o + i * kStripRowStep * kTileW] : CUDART_INF_F;
    win[i] = -1;
    if constexpr (STATS) {
      events[i] = 0;
      maxz[i] = -CUDART_INF_F;
    }
  }
  // a range of a longer block counts events from +inf too; they are dropped
  strip_walk<kPix, STATS>(p.tri_rec, p.rec_stride, p.tri8, p.block_start[b] + r0, n,
                          static_cast<float>(x), y, depth, win, events, maxz, s_geom[k],
                          s_tri[k]);
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const size_t at = o + i * kStripRowStep * kTileW;
    if (whole) {
      store_pixel<STATS>(p.tri_rec, p.rec_stride, b, plane, at, depth[i], win[i],
                         events[STATS ? i : 0], maxz[STATS ? i : 0],
                         static_cast<float>(x) + 0.5f,
                         static_cast<float>(y + i * kStripRowStep) + 0.5f, p.n_vary, p.depth,
                         p.winner, p.vary, p.ev_count, p.ev_maxz);
    } else {
      p.part_d[item * plane + at] = depth[i];
      p.part_w[item * plane + at] = win[i];
    }
  }
}

// One block per band of kMergeRows rows of a block (blockIdx.y): the
// ordered merge of a block of more than one range, thread t on column
// t % 128 (slot t % 128 / 16).
template <int TH, bool STATS, int R, class Origin>
__global__ void __launch_bounds__(kBlockThreads)
strip_merge_kernel(const StripLaunch p, const Origin origin) {
  const int b = blockIdx.x;
  const int m = range_items<R>(p.block_rows[b]);
  if (m == 1) return;  // written by its walk
  const int col = threadIdx.x % kTileW;
  const int2 o = origin(b, col / kStripW);
  const float fx = static_cast<float>(p.origin_x + o.x + col % kStripW);
  const int gy0 = p.origin_y + o.y + threadIdx.x / kTileW;
  merge_ranges<TH, STATS>(p.tri_rec, p.rec_stride, b, blockIdx.y, p.starts[b], m, fx, gy0,
                          p.n_vary, p.init_depth, p.part_d, p.part_w, p.depth, p.winner,
                          p.vary, p.ev_count, p.ev_maxz);
}

// The stats launch's second walk: each range of a block of more than one
// range, again, from its entering depth; its events go into the planes.
template <int TH, int R, int MINB, class Origin>
__global__ void __launch_bounds__(kStripThreads, MINB)
strip_events_kernel(const StripLaunch p, const Origin origin) {
  constexpr int kPix = TH / kStripRowStep;
  __shared__ float s_geom[kStrips][kWarp][kGeom];
  __shared__ int s_tri[kStrips][kWarp];

  const int item = blockIdx.x;
  if (item >= p.starts[p.n_blocks]) return;
  const int2 br = find_item(p.starts, p.n_blocks, item);
  const int b = br.x;
  const int rows = p.block_rows[b];
  if (range_items<R>(rows) == 1) return;  // no range to seed
  const int k = threadIdx.x / kWarp;
  int x, y;
  const int o = lane_pixel(p, origin, b, x, y);
  const size_t plane = static_cast<size_t>(TH) * kTileW;
  float depth[kPix], maxz[kPix];
  int win[kPix], events[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    depth[i] = p.part_d[item * plane + o + i * kStripRowStep * kTileW];
    win[i] = -1;
    events[i] = 0;
    maxz[i] = -CUDART_INF_F;
  }
  const int r0 = br.y * R;
  strip_walk<kPix, true>(p.tri_rec, p.rec_stride, p.tri8, p.block_start[b] + r0,
                         min(R, rows - r0), static_cast<float>(x), y, depth, win, events,
                         maxz, s_geom[k], s_tri[k]);
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const size_t at = b * plane + o + i * kStripRowStep * kTileW;
    add_events(p.ev_count + at, p.ev_maxz + at, events[i], maxz[i]);
  }
}

// The launches of one call: with p.starts, the item scan, the walk over
// n_items blocks (surplus blocks exit), the merge and (STATS) the events
// walk; without, the walk alone, one block a block.  MINB: the walk's
// launch bound; MINB_EVENTS: the events walk's.
template <int TH, bool STATS, int R, int MINB, int MINB_EVENTS, class Origin>
int strip_launch(const StripLaunch& p, const Origin& origin, int n_items, cudaStream_t s) {
  if (!p.starts) {
    strip_walk_kernel<TH, STATS, R, MINB, Origin><<<p.n_blocks, kStripThreads, 0, s>>>(p, origin);
    return static_cast<int>(cudaGetLastError());
  }
  item_scan_kernel<R><<<1, kScanThreads, 0, s>>>(p.block_rows, p.n_blocks, p.starts);
  strip_walk_kernel<TH, STATS, R, MINB, Origin><<<n_items, kStripThreads, 0, s>>>(p, origin);
  strip_merge_kernel<TH, STATS, R, Origin>
      <<<dim3(p.n_blocks, TH / kMergeRows), kBlockThreads, 0, s>>>(p, origin);
  if constexpr (STATS)
    strip_events_kernel<TH, R, MINB_EVENTS, Origin><<<n_items, kStripThreads, 0, s>>>(p, origin);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace trt
