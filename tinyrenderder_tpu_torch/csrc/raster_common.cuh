// Per-pixel triangle math shared by the raster kernels, following
// tinyrenderder_tpu/ops/semantics.py operation for operation (built with
// -fmad=false and IEEE division; thresholds are float literals, as the
// reference compares in float32).
#pragma once

#include <cuda_runtime.h>

namespace trt {

constexpr int kTileW = 128;
constexpr int kGeom = 16;  // screen xy x3, ndc z x3, clip w x3, bbox x4

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

}  // namespace trt
