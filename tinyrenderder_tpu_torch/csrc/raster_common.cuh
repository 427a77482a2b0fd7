// Per-pixel triangle math shared by the raster kernels, following
// tinyrenderder_tpu/ops/semantics.py operation for operation (built with
// -fmad=false and IEEE division; thresholds are float literals, as the
// reference compares in float32).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace trt {

constexpr int kTileW = 128;
constexpr int kGeom = 16;  // screen xy x3, ndc z x3, clip w x3, bbox x4
constexpr int kStrips = 8;                 // strips of a 128-px block row
constexpr int kStripW = kTileW / kStrips;  // 16
constexpr int kWarp = 32;
constexpr int kStripThreads = kStrips * kWarp;  // one warp per strip
constexpr unsigned kAll = 0xffffffffu;

// semantics.barycentric (our_gl.cpp:77-86)
__device__ __forceinline__ void barycentric(const float* g, float px, float py,
                                            float& b0, float& b1, float& b2) {
  const float ax = g[0], ay = g[1], bx = g[2], by = g[3], cx = g[4], cy = g[5];
  const float s0x = cx - ax;
  const float s0y = bx - ax;
  const float s0z = ax - px;
  const float s1x = cy - ay;
  const float s1y = by - ay;
  const float s1z = ay - py;
  const float ux = s0y * s1z - s0z * s1y;
  const float uy = s0z * s1x - s0x * s1z;
  const float uz = s0x * s1y - s0y * s1x;
  if (fabsf(uz) < 1e-12f) {  // DEGEN_EPS, compared in float32
    b0 = -1.0f;
    b1 = 1.0f;
    b2 = 1.0f;
    return;
  }
  b0 = 1.0f - (ux + uy) / uz;
  b1 = uy / uz;
  b2 = ux / uz;
}

// semantics.perspective_correct_bary (our_gl.cpp:168-185)
__device__ __forceinline__ float inv_w(float w) {
  return fabsf(w) <= 1e-12f ? 0.0f : 1.0f / w;  // W_EPS
}

// Loop 2 of both rasters: the perspective-correct varyings of the
// winning triangle's row r at pixel centre (px, py), written to vo[c *
// plane]; + 0.0f makes -0.0 +0.0 like the TPU kernels' select-by-sum.
__device__ __forceinline__ void write_varyings(const float* r, float px, float py,
                                               int n_vary, size_t plane, float* vo) {
  float b0, b1, b2;
  barycentric(r, px, py, b0, b1, b2);
  const float iw0 = inv_w(r[9]), iw1 = inv_w(r[10]), iw2 = inv_w(r[11]);
  const float denom = b0 * iw0 + b1 * iw1 + b2 * iw2;
  float p0 = b0, p1 = b1, p2 = b2;
  if (!(fabsf(denom) < 1e-15f)) {  // DENOM_EPS: else the affine fallback
    p0 = (b0 * iw0) / denom;
    p1 = (b1 * iw1) / denom;
    p2 = (b2 * iw2) / denom;
  }
  for (int c = 0; c < n_vary; ++c) {
    const float* v = r + kGeom + 3 * c;
    vo[c * plane] = (v[0] * p0 + v[1] * p1 + v[2] * p2) + 0.0f;  // interp3
  }
}

// One loop-1 step at one pixel: the triangle's geometry g against the
// pixel (x, y), a sequential strict-less depth update (the first drawn
// wins a tie, our_gl.cpp:165) and, in the stats variant, the z-pass event
// it is (our_gl.cpp:194).  The caller has done the bbox column test.
template <bool STATS>
__device__ __forceinline__ void depth_step(const float* g, int tri, float fx, float fy,
                                           float& depth, int& win, int& events,
                                           float& maxz) {
  if (fy < g[14] || fy > g[15]) return;  // row outside the bbox
  float b0, b1, b2;
  barycentric(g, fx + 0.5f, fy + 0.5f, b0, b1, b2);
  if (b0 < 0.0f || b1 < 0.0f || b2 < 0.0f) return;  // coverage_mask
  const float z = b0 * g[6] + b1 * g[7] + b2 * g[8];  // affine_z
  if (!isfinite(z)) return;
  if (z < depth) {
    depth = z;
    win = tri;
    if constexpr (STATS) {
      events += 1;
      maxz = fmaxf(maxz, z);
    }
  }
}

// ---------------------------------------------------------------------------
// Split walks (raster_coarse.cu; raster_strip.cuh for raster_fine.cu and
// raster_fine2.cu).  An output block's walk (a tile's bin of pairs, a
// tile's or a group's slot rows) is cut into consecutive
// ranges of at most L steps; each range is one work item, a block of 256
// threads.  A block's item count is range_items<L>(steps); item_scan_kernel
// gives each block its first item (an exclusive scan), and find_item turns
// an item back into (output block, range).  A block of one range walks it
// from the running depth and writes its outputs directly.  A block of more
// ranges writes each range's first minimum from +inf, (depth, winner) per
// pixel, to the partial planes at the item's index, and merge_ranges folds
// them in range order with strict-less from the running depth: the result
// is the serial walk's depth and winner, its first-drawn-wins tie included
// (a strict-less fold over a sequence equals the strict-less fold, over its
// consecutive parts in order, of each part's own fold from +inf).  The
// stats launch then walks each such range again from its entering depth
// (the merge's exclusive prefix, seeded with the running depth), which
// gives exactly the serial walk's events of that range, and add_events
// sums them into the event planes.
// ---------------------------------------------------------------------------

constexpr int kBlockThreads = 256;   // one block of a walk item or a merge
constexpr int kScanThreads = 1024;
static_assert(kBlockThreads == kStripThreads, "a merge block covers a strip block");

// a walk of n steps cut into ranges of at most L: max(1, ceil(n / L)) items
template <int L>
__device__ __forceinline__ int range_items(int n) {
  return n > L ? (n + L - 1) / L : 1;
}

// One block: starts[b] = the exclusive prefix sum of range_items<L>(count[b])
// over b < n, and starts[n] = the total, the item count of the launch.
template <int L>
__global__ void __launch_bounds__(kScanThreads)
item_scan_kernel(const int* __restrict__ count, int n, int* __restrict__ starts) {
  __shared__ int s_warp[kScanThreads / kWarp];
  __shared__ int s_carry;
  const int t = threadIdx.x, lane = t % kWarp, w = t / kWarp;
  if (t == 0) s_carry = 0;
  for (int b0 = 0; b0 < n; b0 += kScanThreads) {
    const int b = b0 + t;
    const int v = b < n ? range_items<L>(count[b]) : 0;
    int x = v;  // inclusive scan over the warp
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kAll, x, d);
      if (lane >= d) x += y;
    }
    if (lane == kWarp - 1) s_warp[w] = x;
    __syncthreads();
    if (w == 0) {  // the warps' totals, scanned
      int s = s_warp[lane];
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const int y = __shfl_up_sync(kAll, s, d);
        if (lane >= d) s += y;
      }
      s_warp[lane] = s;
    }
    __syncthreads();
    const int carry = s_carry;
    if (b < n) starts[b] = carry + (w ? s_warp[w - 1] : 0) + x - v;
    __syncthreads();  // every read of s_warp and s_carry is done
    if (t == kScanThreads - 1) s_carry = carry + s_warp[kWarp - 1];
  }
  __syncthreads();
  if (t == 0) starts[n] = s_carry;
}

// The output block of work item `item` (< starts[n]) and the item's range
// index in it: the last b < n with starts[b] <= item (starts ascend
// strictly from starts[0] = 0, since every block has an item).  Called by
// every lane of a warp: a 32-way search, each lane probing one point.
__device__ __forceinline__ int2 find_item(const int* __restrict__ starts, int n, int item) {
  const int lane = threadIdx.x % kWarp;
  int lo = 0, hi = n;  // the block is in [lo, hi), and starts[lo] <= item
  while (hi - lo > 1) {
    const int step = (hi - lo + kWarp - 1) / kWarp;
    const int p = lo + lane * step;
    const unsigned le = __ballot_sync(kAll, p < hi && starts[p] <= item);
    lo += (31 - __clz(le)) * step;  // lane 0 always holds
    hi = min(hi, lo + step);
  }
  return make_int2(lo, item - starts[lo]);
}

// Loop 2 at one pixel of output block `block`, at offset o in its TH x 128
// plane: depth, winner, (STATS) the event planes, and the varyings of the
// winner at pixel centre (px, py), zeros where there is none.
template <bool STATS>
__device__ __forceinline__ void store_pixel(const float* __restrict__ tri_rec, int rec_stride,
                                            int block, size_t plane, size_t o, float depth,
                                            int win, int events, float maxz, float px,
                                            float py, int n_vary, float* __restrict__ depth_out,
                                            int* __restrict__ winner_out,
                                            float* __restrict__ vary_out,
                                            int* __restrict__ ev_count,
                                            float* __restrict__ ev_maxz) {
  const size_t at = static_cast<size_t>(block) * plane + o;
  depth_out[at] = depth;
  winner_out[at] = win;
  if constexpr (STATS) {
    ev_count[at] = events;
    ev_maxz[at] = maxz;
  }
  if (n_vary == 0) return;
  float* vo = vary_out + static_cast<size_t>(block) * n_vary * plane + o;
  if (win < 0) {
    for (int c = 0; c < n_vary; ++c) vo[c * plane] = 0.0f;
    return;
  }
  write_varyings(tri_rec + static_cast<size_t>(win) * rec_stride, px, py, n_vary, plane, vo);
}

// The ordered merge of output block `block`'s m > 1 ranges, whose partial
// (depth, winner) planes are items first .. first + m - 1 of part_d and
// part_w, for the kMergeRows rows of band `part` of the block.  A block of
// 256 threads; thread t owns the band's pixels of column t % 128 in rows
// t / 128, t / 128 + 2, ..., at global column fx (gy0: the global row of
// the block's row t / 128).  Per pixel, from the running depth
// (init_depth, or +inf where it is null), each range's pair replaces the
// running one only where its depth is strictly less, so the first range
// wins a tie.  A thread loads kMergeAhead ranges at a time for all its
// pixels, so those loads are in flight together, then folds them in
// order.  STATS: each range's partial depth is overwritten by its
// entering depth (the running depth before it) for the events walk, and
// the event planes start at 0 and -inf for add_events.  Then loop 2.
constexpr int kMergeRows = 4;
constexpr int kMergeAhead = 4;

template <int TH, bool STATS>
__device__ __forceinline__ void merge_ranges(
    const float* __restrict__ tri_rec, int rec_stride, int block, int part, int first, int m,
    float fx, int gy0, int n_vary, const float* __restrict__ init_depth,
    float* __restrict__ part_d, const int* __restrict__ part_w, float* __restrict__ depth_out,
    int* __restrict__ winner_out, float* __restrict__ vary_out, int* __restrict__ ev_count,
    float* __restrict__ ev_maxz) {
  static_assert(TH % kMergeRows == 0, "a tile is whole merge bands");
  constexpr int kPix = kMergeRows * kTileW / kBlockThreads;
  constexpr int kRowStep = kBlockThreads / kTileW;
  const size_t plane = static_cast<size_t>(TH) * kTileW;
  const size_t o0 = threadIdx.x + static_cast<size_t>(part) * kPix * kBlockThreads;
  float d[kPix];
  int w[kPix];
#pragma unroll
  for (int k = 0; k < kPix; ++k) {
    d[k] = init_depth ? init_depth[block * plane + o0 + k * kBlockThreads] : CUDART_INF_F;
    w[k] = -1;
  }
  for (int r0 = 0; r0 < m; r0 += kMergeAhead) {
    float rd[kMergeAhead][kPix];
    int rw[kMergeAhead][kPix];
#pragma unroll
    for (int j = 0; j < kMergeAhead; ++j) {
      if (r0 + j == m) break;
      const size_t at = static_cast<size_t>(first + r0 + j) * plane + o0;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        rd[j][k] = part_d[at + k * kBlockThreads];
        rw[j][k] = part_w[at + k * kBlockThreads];
      }
    }
#pragma unroll
    for (int j = 0; j < kMergeAhead; ++j) {
      if (r0 + j == m) break;
      const size_t at = static_cast<size_t>(first + r0 + j) * plane + o0;
#pragma unroll
      for (int k = 0; k < kPix; ++k) {
        if constexpr (STATS) part_d[at + k * kBlockThreads] = d[k];
        if (rd[j][k] < d[k]) {
          d[k] = rd[j][k];
          w[k] = rw[j][k];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPix; ++k)
    store_pixel<STATS>(tri_rec, rec_stride, block, plane, o0 + k * kBlockThreads, d[k], w[k],
                       0, -CUDART_INF_F, fx + 0.5f,
                       static_cast<float>(gy0 + (part * kPix + k) * kRowStep) + 0.5f, n_vary,
                       depth_out, winner_out, vary_out, ev_count, ev_maxz);
}

// Adds one range's events at a pixel to the event planes merge_ranges
// started: the count by an integer add, the largest event z by an integer
// max on the float's bits (sign bit clear: a signed max; set: an unsigned
// min, which orders negative floats and -0.0).  Both are exact in any
// order.  (A walk's events are a strictly falling sequence of z, so the
// largest is its first.)
__device__ __forceinline__ void add_events(int* count, float* maxz, int events, float z) {
  if (events == 0) return;
  atomicAdd(count, events);
  const int bits = __float_as_int(z);
  if (bits >= 0)
    atomicMax(reinterpret_cast<int*>(maxz), bits);
  else
    atomicMin(reinterpret_cast<unsigned*>(maxz), __float_as_uint(z));
}

}  // namespace trt
