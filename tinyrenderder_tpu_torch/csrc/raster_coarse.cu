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
// contraction is the price of bitwise parity with the reference.
//
// Design:
//  * one block of 256 threads per active tile of TH x 128 pixels (block a
//    rasters tile tile_ids[a]; with no tile_ids, the dense launch, block a
//    is tile a, and a tile whose bin is empty returns its init depth,
//    winner -1 and zero varyings); thread
//    t owns the pixels t, t + 256, ... (column t % 128), so every store is
//    a coalesced 128-float row segment;
//  * loop 1 streams the tile's bin IN BIN ORDER through shared memory in
//    chunks of 64 pairs and keeps, per pixel in registers, the depth and
//    winner of a sequential strict-less update.  That is the reference's
//    first-drawn-wins z-test; the TPU kernel's first-minimum argmin over
//    16-pair sub-blocks followed by a strict-less merge picks the same
//    pair.  A pixel outside a pair's integer bbox skips the pair before
//    any arithmetic: the bbox test is one factor of the coverage AND, so
//    skipping changes nothing;
//  * the stats variant (STATS = true, a separate instantiation, so the
//    plain variant's code is untouched) counts z-pass events: every
//    covered step with z < depth of the sequential strict-less update IS
//    an event (our_gl.cpp:194), starting from the running init depth.
//    So a per-pixel int count and fmaxf of the event z in registers are
//    exact by construction; the TPU needed a prefix-min per 16-pair
//    sub-block to recover the same sequence.  Depth, winner and
//    varyings come out of the same update, bit for bit;
//  * loop 2 needs no second pass over the bin (the TPU re-streamed it to
//    avoid gathers): each pixel reads its winner's row from global memory
//    and interpolates the varyings;
//  * arithmetic follows tinyrenderder_tpu/ops/semantics.py operation for
//    operation, built with -fmad=false and IEEE division; thresholds are
//    float literals (the reference compares in float32).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "raster_common.cuh"

namespace {

using trt::kGeom;
using trt::kTileW;

constexpr int kThreads = 256;
constexpr int kChunk = 64;   // pairs staged in shared memory at a time

template <int TH, bool STATS>
__global__ void __launch_bounds__(kThreads)
coarse_raster_kernel(const float* __restrict__ tri_rec, int rec_stride,
                     const int* __restrict__ sorted_tri,
                     const int* __restrict__ tile_ids,
                     const int* __restrict__ start,
                     const int* __restrict__ count, int origin_x, int origin_y,
                     int n_tiles_x, int n_vary,
                     const float* __restrict__ init_depth,
                     float* __restrict__ depth_out, int* __restrict__ winner_out,
                     float* __restrict__ vary_out,
                     int* __restrict__ ev_count, float* __restrict__ ev_maxz) {
  constexpr int kPix = TH * kTileW / kThreads;  // pixels per thread
  constexpr int kRowStep = kThreads / kTileW;   // rows between them
  __shared__ float s_geom[kChunk][kGeom];
  __shared__ int s_tri[kChunk];

  const int a = blockIdx.x;
  const int tile = tile_ids ? tile_ids[a] : a;
  const int seg = start[a];
  const int n = count[a];
  const int tid = threadIdx.x;
  const int col = tid % kTileW;
  const int row0 = tid / kTileW;
  const int xi = origin_x + (tile % n_tiles_x) * kTileW + col;
  const int gy0 = origin_y + (tile / n_tiles_x) * TH + row0;
  const float fx = static_cast<float>(xi);
  const float px = fx + 0.5f;
  const size_t plane = static_cast<size_t>(TH) * kTileW;
  const size_t base = static_cast<size_t>(a) * plane + tid;

  float depth[kPix];
  int win[kPix];
  int events[STATS ? kPix : 1];   // z-pass events (our_gl.cpp:194)
  float maxz[STATS ? kPix : 1];   // largest event z (our_gl.cpp:199)
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    depth[k] = init_depth[base + k * kThreads];
    win[k] = -1;
    if constexpr (STATS) {
      events[k] = 0;
      maxz[k] = -CUDART_INF_F;
    }
  }

  // ---- loop 1: depth resolve in bin order ----
  for (int c0 = 0; c0 < n; c0 += kChunk) {
    const int m = min(kChunk, n - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = tid; i < m * kGeom; i += kThreads) {
      const int p = i / kGeom, c = i % kGeom;
      const int tri = sorted_tri[seg + c0 + p];
      s_geom[p][c] = tri_rec[static_cast<size_t>(tri) * rec_stride + c];
      if (c == 0) s_tri[p] = tri;
    }
    __syncthreads();
    for (int p = 0; p < m; ++p) {
      const float* g = s_geom[p];
      if (fx < g[12] || fx > g[13]) continue;  // column outside the bbox
#pragma unroll
      for (int k = 0; k < kPix; ++k)
        trt::depth_step<STATS>(g, s_tri[p], fx, static_cast<float>(gy0 + k * kRowStep),
                               depth[k], win[k], events[STATS ? k : 0],
                               maxz[STATS ? k : 0]);
    }
  }

  // ---- loop 2: perspective-correct varyings of each pixel's winner ----
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    const size_t o = base + k * kThreads;
    depth_out[o] = depth[k];
    winner_out[o] = win[k];
    if constexpr (STATS) {
      ev_count[o] = events[k];
      ev_maxz[o] = maxz[k];
    }
    if (n_vary == 0) continue;
    float* vo = vary_out + static_cast<size_t>(a) * n_vary * plane + tid + k * kThreads;
    if (win[k] < 0) {
      for (int c = 0; c < n_vary; ++c) vo[c * plane] = 0.0f;
      continue;
    }
    trt::write_varyings(tri_rec + static_cast<size_t>(win[k]) * rec_stride, px,
                        static_cast<float>(gy0 + k * kRowStep) + 0.5f, n_vary, plane, vo);
  }
}

template <int TH, bool STATS>
void launch(int n_active, cudaStream_t s, const float* tri_rec,
            int rec_stride, const int* sorted_tri, const int* tile_ids,
            const int* start, const int* count, int origin_x, int origin_y,
            int n_tiles_x, int n_vary, const float* init_depth, float* depth,
            int* winner, float* vary, int* ev_count, float* ev_maxz) {
  coarse_raster_kernel<TH, STATS><<<n_active, kThreads, 0, s>>>(
      tri_rec, rec_stride, sorted_tri, tile_ids, start, count, origin_x,
      origin_y, n_tiles_x, n_vary, init_depth, depth, winner, vary, ev_count,
      ev_maxz);
}

}  // namespace

// tile_ids: (A,) tile of each block, or null for the dense launch over
// tiles 0 .. A - 1; ev_count and ev_maxz: both null (no stats) or both
// (A, TH, 128)
extern "C" int trt_coarse_raster(const float* tri_rec, int rec_stride,
                                 const int* sorted_tri, const int* tile_ids,
                                 const int* start, const int* count, int n_active,
                                 int origin_x, int origin_y, int n_tiles_x,
                                 int tile_h, int tile_w, int n_vary,
                                 const float* init_depth, float* depth,
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
  fn(n_active, s, tri_rec, rec_stride, sorted_tri, tile_ids, start, count,
     origin_x, origin_y, n_tiles_x, n_vary, init_depth, depth, winner, vary,
     ev_count, ev_maxz);
  return static_cast<int>(cudaGetLastError());
}
