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

// One warp of a strip raster block (raster_fine.cu, raster_fine2.cu): a
// block of kStrips warps owns a TH x 128 output block; warp k owns its
// columns 16k .. 16k + 15, lane l the pixels of column 16k + l % 16 in
// rows l / 16, l / 16 + 2, ... (TH / 2 pixels a lane).  The warp walks its
// slot column tri8[seg + r][k], r < n, in row order (= submission order)
// and stops at the first -1 (its bin is a prefix of the column), 32 slots
// at a time: each lane reads one slot id, the warp stages the 32
// triangles' geometry in shared memory (geom, stri: this warp's part), and
// every lane runs the sequential strict-less depth_step over them.  Then
// loop 2 writes each pixel's depth, winner, varyings and (STATS) events.
//   block: the output block index; x, y: this lane's global pixel column
//   and first row; init_depth: (blocks, TH, 128) running depth, or null
//   for +inf (pass-local).
template <int TH, bool STATS>
__device__ __forceinline__ void strip_column(
    const float* __restrict__ tri_rec, int rec_stride, const int* __restrict__ tri8,
    int seg, int n, int block, int x, int y, int n_vary,
    const float* __restrict__ init_depth, float* __restrict__ depth_out,
    int* __restrict__ winner_out, float* __restrict__ vary_out, int* __restrict__ ev_count,
    float* __restrict__ ev_maxz, float (*geom)[kGeom], int* stri) {
  constexpr int kRowStep = kWarp / kStripW;  // 2 rows per lane step
  constexpr int kPix = TH / kRowStep;        // pixels per lane
  const int k = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const float fx = static_cast<float>(x);
  const size_t plane = static_cast<size_t>(TH) * kTileW;
  const size_t base = static_cast<size_t>(block) * plane +
                      (lane / kStripW) * kTileW + k * kStripW + lane % kStripW;

  float depth[kPix];
  int win[kPix];
  int events[STATS ? kPix : 1];   // z-pass events (our_gl.cpp:194)
  float maxz[STATS ? kPix : 1];   // largest event z (our_gl.cpp:199)
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    depth[i] = init_depth ? init_depth[base + i * kRowStep * kTileW] : CUDART_INF_F;
    win[i] = -1;
    if constexpr (STATS) {
      events[i] = 0;
      maxz[i] = -CUDART_INF_F;
    }
  }

  // ---- loop 1: this strip's column of slots, in row order ----
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

  // ---- loop 2: perspective-correct varyings of each pixel's winner ----
  const float px = fx + 0.5f;
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    const size_t o = base + i * kRowStep * kTileW;
    depth_out[o] = depth[i];
    winner_out[o] = win[i];
    if constexpr (STATS) {
      ev_count[o] = events[i];
      ev_maxz[o] = maxz[i];
    }
    if (n_vary == 0) continue;
    float* vo = vary_out + static_cast<size_t>(block) * n_vary * plane + (o - block * plane);
    if (win[i] < 0) {
      for (int c = 0; c < n_vary; ++c) vo[c * plane] = 0.0f;
      continue;
    }
    write_varyings(tri_rec + static_cast<size_t>(win[i]) * rec_stride, px,
                   static_cast<float>(y + i * kRowStep) + 0.5f, n_vary, plane, vo);
  }
}

}  // namespace trt
