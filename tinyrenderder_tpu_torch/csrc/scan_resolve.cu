// The scan backend's depth resolve over the whole frame, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: it is the counterpart of
// tinyrenderder_tpu/ops/raster.py::depth_resolve_xla and, with stats, of
// pass_events_xla, which the JAX package runs as one lax.scan over chunks
// of 8 triangles, each step testing every triangle of the chunk against
// every pixel of the frame.  XLA compiles that loop into one device
// program; eager PyTorch would launch some forty elementwise kernels over
// chunk x H x W floats per chunk, so the resolve is this kernel and the
// chunked scan (ops/raster.py::depth_resolve_xla_plain) its plain version.
//
// Why one serial walk equals the chunked scan for any chunk size: within a
// chunk the scan keeps, per pixel, the first-occurrence argmin of the
// covered depths and merges it into the running depth on strict less-than;
// across chunks it merges in chunk order.  Both keep the smallest depth
// and, on a tie, the earliest triangle, which is exactly what a walk in
// submission order with a strict-less update keeps.  The scan's event rule,
// "zc[k] < min(running depth, zc[0..k-1])", is exactly that walk's update
// at step k, so the walk's updates are the events: their count, and their
// largest z (max_z).  min_z, the least depth over the pixels the pass won,
// is taken from the outputs by the wrapper.
//
// What bounds it on this card: the bbox tests.  A naive walk tests every
// triangle at every pixel (1.15e11 tests at 27,360 faces and 2048²).  Here
// a block of 256 threads owns a 32 x 32 pixel block (thread t: column
// t % 32, rows t / 32 + 8 k for k < 4) and first keeps, in submission
// order, only the triangles whose valid integer bbox meets the block: the
// pass's triangles stream through in chunks of 256, one a thread, and a
// ballot and a prefix sum over the warps place each hit in a shared-memory
// list, with its 16 geometry floats.  The pixels then walk that list.  A
// pixel outside a triangle's bbox, or a triangle outside the block, skips
// it before any arithmetic: the bbox test is one factor of the coverage
// AND, so skipping changes nothing.  Each block reads every triangle's
// bbox once (from L2 after the first block), and per covered test the
// arithmetic of raster_common.cuh (three IEEE divisions).
//
// Arithmetic follows tinyrenderder_tpu/ops/semantics.py operation for
// operation (raster_common.cuh's barycentric and depth_step), built with
// -fmad=false and IEEE division.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "raster_common.cuh"

namespace {

using namespace trt;

constexpr int kThreads = 256;
constexpr int kBlockW = 32;                        // pixel columns of a block
constexpr int kPixY = 4;                           // pixel rows a thread owns
constexpr int kRowStep = kThreads / kBlockW;       // 8
constexpr int kBlockH = kRowStep * kPixY;          // 32
constexpr int kRowPad = kGeom + 1;                 // shared row stride (bank spread)

struct Scan {
  const float* tri_rec;        // (F, rec_stride) f32: raster_coarse's 16 geometry columns first
  int rec_stride;
  const unsigned char* valid;  // (F,) bool
  int n_tri;
  int height, width;           // the buffer
  int x0, y0;                  // the buffer's top-left global pixel
  const float* init_depth;     // (H, W) or null: +inf
  const int* init_winner;      // (H, W) or null: -1
  float* depth;                // (H, W)
  int* winner;                 // (H, W)
  int* ev_count;               // (1,) or null (no stats)
  float* ev_maxz;              // (1,) or null
};

template <bool STATS>
__global__ void __launch_bounds__(kThreads) scan_resolve_kernel(const Scan p) {
  __shared__ float s_geom[kThreads][kRowPad];
  __shared__ int s_id[kThreads];
  __shared__ int s_warp[kThreads / kWarp];
  const int t = threadIdx.x, lane = t % kWarp, w = t / kWarp;
  const int bx = blockIdx.x * kBlockW, by = blockIdx.y * kBlockH;
  const int x = bx + t % kBlockW, y0 = by + t / kBlockW;
  // the block's rectangle in global pixels, cut at the buffer's edge
  const float gx0 = static_cast<float>(p.x0 + bx);
  const float gx1 = static_cast<float>(p.x0 + min(bx + kBlockW, p.width) - 1);
  const float gy0 = static_cast<float>(p.y0 + by);
  const float gy1 = static_cast<float>(p.y0 + min(by + kBlockH, p.height) - 1);
  const float fx = static_cast<float>(p.x0 + x);
  const bool col_in = x < p.width;
  // rows y0 + k * kRowStep for k < n_in lie in the buffer (the rows below a
  // band's buffer are another band's: they walk nothing)
  const int n_in = min(kPixY, max(0, (p.height - y0 + kRowStep - 1) / kRowStep));

  float depth[kPixY], maxz[kPixY];
  int win[kPixY], events[kPixY];
#pragma unroll
  for (int k = 0; k < kPixY; ++k) {
    const int y = y0 + k * kRowStep;
    const size_t at = static_cast<size_t>(y) * p.width + x;
    const bool in = col_in && k < n_in;
    depth[k] = in && p.init_depth ? p.init_depth[at] : CUDART_INF_F;
    win[k] = in && p.init_winner ? p.init_winner[at] : -1;
    events[k] = 0;
    maxz[k] = -CUDART_INF_F;
  }

  for (int c0 = 0; c0 < p.n_tri; c0 += kThreads) {
    // keep, in submission order, the chunk's valid triangles that meet the block
    const int tri = c0 + t;
    const float* r = p.tri_rec + static_cast<size_t>(tri) * p.rec_stride;
    bool hit = false;
    if (tri < p.n_tri && p.valid[tri])
      hit = r[12] <= gx1 && r[13] >= gx0 && r[14] <= gy1 && r[15] >= gy0;
    const unsigned ballot = __ballot_sync(kAll, hit);
    if (lane == 0) s_warp[w] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int k = 0; k < kThreads / kWarp; ++k) {
      const int c = s_warp[k];
      before += k < w ? c : 0;
      total += c;
    }
    if (hit) {
      const int at = before + __popc(ballot & ((1u << lane) - 1u));
      s_id[at] = tri;
#pragma unroll
      for (int j = 0; j < kGeom; ++j) s_geom[at][j] = r[j];
    }
    __syncthreads();
    // each pixel walks the list in order: a strict-less depth update
    if (col_in) {
      for (int i = 0; i < total; ++i) {
        const float* g = s_geom[i];
        if (fx < g[12] || fx > g[13]) continue;  // column outside the bbox
        const int id = s_id[i];
#pragma unroll
        for (int k = 0; k < kPixY; ++k)
          if (k < n_in)
            depth_step<STATS>(g, id, fx, static_cast<float>(p.y0 + y0 + k * kRowStep),
                              depth[k], win[k], events[k], maxz[k]);
      }
    }
    __syncthreads();  // the list is read before the next chunk overwrites it
  }

#pragma unroll
  for (int k = 0; k < kPixY; ++k) {
    const int y = y0 + k * kRowStep;
    if (col_in && k < n_in) {
      const size_t at = static_cast<size_t>(y) * p.width + x;
      p.depth[at] = depth[k];
      p.winner[at] = win[k];
    }
  }
  if constexpr (STATS) {
    int n = 0;
    float z = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < kPixY; ++k) {
      n += events[k];
      z = fmaxf(z, maxz[k]);
    }
#pragma unroll
    for (int d = kWarp / 2; d > 0; d >>= 1) {
      n += __shfl_down_sync(kAll, n, d);
      z = fmaxf(z, __shfl_down_sync(kAll, z, d));
    }
    if (lane == 0) add_events(p.ev_count, p.ev_maxz, n, z);
  }
}

}  // namespace

// tri_rec: (n_tri, rec_stride >= 16) f32 rows (raster_coarse.build_tri_records'
// geometry columns); valid: (n_tri,) bool; the buffer is height x width at
// global pixel (x0, y0); init_depth / init_winner: (height, width) or null
// (+inf / -1); depth, winner: (height, width) outputs; ev_count (int, 0) and
// ev_maxz (float, -inf): both null (no stats) or both one element, which the
// kernel adds this pass's z-pass events to.
extern "C" int trt_scan_resolve(const float* tri_rec, int rec_stride, const unsigned char* valid,
                                int n_tri, int height, int width, int x0, int y0,
                                const float* init_depth, const int* init_winner, float* depth,
                                int* winner, int* ev_count, float* ev_maxz, void* stream) {
  if (rec_stride < kGeom || n_tri < 0 || height <= 0 || width <= 0 ||
      (ev_count == nullptr) != (ev_maxz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Scan p{tri_rec, rec_stride, valid, n_tri, height, width, x0, y0,
               init_depth, init_winner, depth, winner, ev_count, ev_maxz};
  const dim3 grid((width + kBlockW - 1) / kBlockW, (height + kBlockH - 1) / kBlockH);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ev_count != nullptr)
    scan_resolve_kernel<true><<<grid, kThreads, 0, s>>>(p);
  else
    scan_resolve_kernel<false><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
