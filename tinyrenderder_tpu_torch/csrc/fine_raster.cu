// Prototype strip raster (depth and winner) over 8 x 128 tiles, for Hopper
// (sm_90a).
//
// Replaces: scripts/experimental_fine_raster.py::_strip_kernel, as
// launched by strip_rasterize (pallas_call :196).  Plain version, record
// builder and contract: tinyrenderder_tpu_torch/experimental/fine_raster.py.
//
// The prototype's contract, not the production raster's: records are
// (G, max_rows, 128) f32, a row holding one slot of each of the group's 8
// strips of 8 x 16 pixels (16 floats a slot: ax ay bx by cx cy z0 z1 z2 id,
// then zeros; id -1 in an empty slot).  A pixel of strip k walks slot k of
// rows 0 .. rows[g] - 1 in order: barycentric coverage, the affine z,
// covered &= isfinite(z) and id >= 0, then a strict-less depth update whose
// winner is the slot's id.  There is NO bbox test (the production raster
// clips to the triangle's integer bbox), so this kernel does not use
// raster_common.cuh's depth_step, only its barycentric, whose op order is
// the prototype's (semantics.barycentric).
//
// What bounds it on this card: per-pixel arithmetic.  Every pixel of a
// strip evaluates every slot of its strip's bin (three IEEE divisions, no
// contraction: -fmad=false), with no bbox test to skip any.  The records
// are read once.
//
// Design: one block of 128 threads per group (tile), thread x on column x
// with its 8 pixels' depth and winner in registers.  The block walks
// rows[g] rows, never the padded maximum, staging 32 record rows at a time
// in shared memory (one coalesced 512-byte row read a row); each thread
// then reads its strip's 10 fields from shared memory (a warp spans two
// strips: two addresses a load, on different banks).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "raster_common.cuh"

namespace {

constexpr int kTH = 8;                  // tile rows
constexpr int kTW = trt::kTileW;        // 128 tile columns = record lanes
constexpr int kStripW = trt::kStripW;   // 16 lanes a slot
constexpr int kStage = 32;              // record rows staged at a time

__global__ void __launch_bounds__(kTW)
strip_proto_kernel(const float* __restrict__ recs, const int* __restrict__ rows,
                   int max_rows, const float* __restrict__ init,
                   float* __restrict__ depth_out, int* __restrict__ winner_out,
                   int n_tiles_x) {
  __shared__ float s_rec[kStage][kTW];

  const int g = blockIdx.x;
  const int x = threadIdx.x;
  const int k = x / kStripW;
  // the prototype's pixel centres: (tile origin + iota) + 0.5, all exact
  const float gx0 = static_cast<float>((g % n_tiles_x) * kTW);
  const float gy0 = static_cast<float>((g / n_tiles_x) * kTH);
  const float px = (gx0 + static_cast<float>(x)) + 0.5f;
  const size_t tile = static_cast<size_t>(g) * kTH * kTW;

  float depth[kTH];
  int win[kTH];
#pragma unroll
  for (int i = 0; i < kTH; ++i) {
    depth[i] = init[tile + i * kTW + x];
    win[i] = -1;
  }

  const int n = rows[g];
  const float* rec = recs + static_cast<size_t>(g) * max_rows * kTW;
  for (int r0 = 0; r0 < n; r0 += kStage) {
    const int m = min(kStage, n - r0);
    __syncthreads();  // the previous stage is consumed
    for (int r = 0; r < m; ++r) s_rec[r][x] = rec[static_cast<size_t>(r0 + r) * kTW + x];
    __syncthreads();
    for (int r = 0; r < m; ++r) {
      const float* f = &s_rec[r][k * kStripW];
      const float id = f[9];
      if (!(id >= 0.0f)) continue;  // covered &= id >= 0 (-1 = empty slot)
      const int tri = static_cast<int>(id);
#pragma unroll
      for (int i = 0; i < kTH; ++i) {
        const float py = (gy0 + static_cast<float>(i)) + 0.5f;
        float b0, b1, b2;
        trt::barycentric(f, px, py, b0, b1, b2);
        if (b0 < 0.0f || b1 < 0.0f || b2 < 0.0f) continue;  // coverage_mask
        const float z = b0 * f[6] + b1 * f[7] + b2 * f[8];  // affine_z
        if (!isfinite(z)) continue;
        if (z < depth[i]) {
          depth[i] = z;
          win[i] = tri;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTH; ++i) {
    depth_out[tile + i * kTW + x] = depth[i];
    winner_out[tile + i * kTW + x] = win[i];
  }
}

}  // namespace

// recs (G, max_rows, 128) f32, rows (G,) i32, init (G, 8, 128) f32 ->
// depth (G, 8, 128) f32, winner (G, 8, 128) i32
extern "C" int trt_strip_proto(const float* recs, const int* rows, int n_groups,
                               int max_rows, const float* init, float* depth, int* winner,
                               int n_tiles_x, void* stream) {
  if (n_groups <= 0 || max_rows <= 0 || n_tiles_x <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  strip_proto_kernel<<<n_groups, kTW, 0, static_cast<cudaStream_t>(stream)>>>(
      recs, rows, max_rows, init, depth, winner, n_tiles_x);
  return static_cast<int>(cudaGetLastError());
}
