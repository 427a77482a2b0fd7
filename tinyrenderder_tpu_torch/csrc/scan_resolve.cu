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
// The walk: a block of 256 threads owns a block of kBlockW x kBlockH = 8 x
// 32 pixels, one a thread (thread t: column t % 8, row t / 8), and keeps,
// in submission order, the valid triangles whose integer bbox meets the
// block: it streams a list of candidates in chunks of 256, one a thread,
// and a ballot and a prefix sum over the warps place each hit in a
// shared-memory list, with its 16 geometry floats.  The pixels then walk
// that list with raster_common.cuh's depth_step.  A pixel outside a
// triangle's bbox, or a triangle outside the block, skips it before any
// arithmetic: the bbox test is one factor of the coverage AND, so
// skipping changes nothing.
//
// Which candidates a block streams: every triangle of the pass, for every
// block (27,360 bboxes, one 32-byte L2 sector each, for each of 4,096
// 32 x 32 blocks at 2048²: 3.6 GB), costs far more than the walk.  So the
// stream is culled once per super-block of kSuperPx x kSuperPx = 128 x 128
// pixels (16 x 4 blocks), before the walk:
//   1. count (one warp a unit of 32 consecutive triangles and a slice of
//      the super-blocks: all of them but for a pass of few units): each
//      lane reads its triangle's bbox (one 16-byte load from its record
//      row), cuts it to the buffer and turns it into a range of blocks;
//      for each super-block of the slice the warp's ballot counts the
//      unit's triangles that meet it, written to counts[super-block][unit];
//   2. prefix (one block a super-block): the exclusive prefix of its row
//      of unit counts, in place, and the list's length after the row;
//   3. fill (as count): each hit is written at its unit's prefix plus the
//      hits of the lanes below it, with its block range cut to the
//      super-block (four 8-bit local block indices), as one int2;
//   4. walk (one block a pixel block): streams its super-block's list, an
//      8-byte coalesced load a candidate, and tests the block against the
//      packed range.
// No launch reads anything back to the host and no capacity is checked: a
// list holds at most every triangle, so the wrapper sizes each at n_tri.
// What bounds it then is the walk's arithmetic: three IEEE divisions a
// pixel inside a triangle's bbox, so that small blocks (8 x 32, one pixel
// a thread) spread a pile of large triangles over more multiprocessors
// than 32 x 32 blocks of four pixels a thread would.
//
// Why the walk's output is bitwise the one over the whole stream: a
// super-block's list is, by 1-3, the valid triangles whose bbox (cut to
// the buffer) meets the super-block, in submission order (units in order
// by the prefix, lanes in order by the ballot).  A block's hits are the
// ordered subsequence of that list whose range holds the block.  For a
// valid triangle (its bbox not inverted, semantics.triangle_setup_planes)
// the range holds the block iff the bbox meets the block's rectangle cut
// to the buffer: the bbox test of a walk over the whole stream; and a
// bbox that meets the block meets its super-block, so no such triangle is
// missing from the list.  Both levels keep submission order, so a block
// walks, element for element, the list that a walk over the whole stream
// builds, and the depth, winner and events are that walk's.  (A triangle
// with an inverted bbox meets no pixel's bbox test either, so leaving it
// out changes nothing.)
//
// Arithmetic follows tinyrenderder_tpu/ops/semantics.py operation for
// operation (raster_common.cuh's barycentric and depth_step), built with
// -fmad=false and IEEE division.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "raster_common.cuh"

namespace {

using namespace trt;

constexpr int kThreads = 256;
constexpr int kBlockW = 8;                         // pixel columns of a block
constexpr int kPixY = 1;                           // pixel rows a thread owns
constexpr int kRowStep = kThreads / kBlockW;       // 32
constexpr int kBlockH = kRowStep * kPixY;          // 32
constexpr int kRowPad = kGeom + 1;                 // shared row stride (bank spread)
constexpr int kSuperPx = 128;                      // a super-block's side in pixels
constexpr int kSuperW = kSuperPx / kBlockW;        // blocks a super-block across
constexpr int kSuperH = kSuperPx / kBlockH;        // and down
constexpr int kCullThreads = 256;                  // 8 warps, a unit of 32 triangles each
constexpr int kCullWarps = 1024;                   // warps the list launches aim at
constexpr int kMinSlice = 8;                       // least super-blocks a warp visits
constexpr int kScanPer = 8;                        // counts a prefix thread sums in order
static_assert(kThreads % kBlockW == 0, "a block's threads cover whole rows");
static_assert(kSuperPx % kBlockW == 0 && kSuperPx % kBlockH == 0, "whole blocks a super-block");
static_assert(kSuperW <= 128 && kSuperH <= 128, "a packed local block index is 8 bits");
static_assert(kScanThreads == kWarp * kWarp, "the prefix scans its warps' sums in one warp");

// The bbox's packed local range: x0 | x1 << 8 | y0 << 16 | y1 << 24.
__device__ __forceinline__ bool range_holds(unsigned box, int bx, int by) {
  return static_cast<int>(box & 0xffu) <= bx && static_cast<int>((box >> 8) & 0xffu) >= bx &&
         static_cast<int>((box >> 16) & 0xffu) <= by && static_cast<int>(box >> 24) >= by;
}

struct Cull {
  const float* tri_rec;        // (F, rec_stride) f32: raster_coarse's 16 geometry columns first
  int rec_stride;
  const unsigned char* valid;  // (F,) bool
  int n_tri;
  int height, width;           // the buffer
  int x0, y0;                  // the buffer's top-left global pixel
  int nsx, nsy;                // super-blocks across and down
  int n_units;                 // ceil(n_tri / 32)
  int slice;                   // super-blocks a warp visits (a slice; blockIdx.y's)
  int* counts;                 // (nsx * nsy, n_units + 1)
  int2* lists;                 // (nsx * nsy, n_tri): (triangle, packed local range)
};

// The buffer's blocks that valid triangle tri's integer bbox meets, cut to
// the buffer, as an inclusive range (x0, x1, y0, y1) of block indices; or
// false where it meets none.  The bbox columns hold integers (the int32
// bbox, raster_coarse.build_tri_records), so the float compares are the
// walk's, and the cut values convert exactly.
__device__ __forceinline__ bool block_range(const Cull& p, int tri, int4& r) {
  if (tri >= p.n_tri || !p.valid[tri]) return false;
  const float4 b = __ldg(reinterpret_cast<const float4*>(
      p.tri_rec + static_cast<size_t>(tri) * p.rec_stride + 12));
  const float lx = fmaxf(b.x, static_cast<float>(p.x0));
  const float hx = fminf(b.y, static_cast<float>(p.x0 + p.width - 1));
  const float ly = fmaxf(b.z, static_cast<float>(p.y0));
  const float hy = fminf(b.w, static_cast<float>(p.y0 + p.height - 1));
  if (!(lx <= hx && ly <= hy)) return false;
  r = make_int4((static_cast<int>(lx) - p.x0) / kBlockW, (static_cast<int>(hx) - p.x0) / kBlockW,
                (static_cast<int>(ly) - p.y0) / kBlockH, (static_cast<int>(hy) - p.y0) / kBlockH);
  return true;
}

// Launches 1 (FILL false: the counts) and 3 (FILL true: the lists, from
// the counts' prefixes).
template <bool FILL>
__global__ void __launch_bounds__(kCullThreads) scan_cull_kernel(const Cull p) {
  const int lane = threadIdx.x % kWarp;
  const int unit = blockIdx.x * (kCullThreads / kWarp) + threadIdx.x / kWarp;
  if (unit >= p.n_units) return;  // the whole warp
  const int tri = unit * kWarp + lane;
  int4 r = make_int4(0, 0, 0, 0);
  const bool any = block_range(p, tri, r);
  const int sx0 = r.x / kSuperW, sx1 = r.y / kSuperW;
  const int sy0 = r.z / kSuperH, sy1 = r.w / kSuperH;
  const size_t row = static_cast<size_t>(p.n_units) + 1;
  const unsigned below = (1u << lane) - 1u;
  // this block's slice of the super-blocks, row-major (one division: the
  // loop steps its super-block's column and row)
  const int first = blockIdx.y * p.slice;
  const int s_end = min(first + p.slice, p.nsx * p.nsy);
  int sy = first / p.nsx, sx = first - sy * p.nsx;
  for (int s = first; s < s_end; ++s) {
    const bool hit = any && sy0 <= sy && sy <= sy1 && sx0 <= sx && sx <= sx1;
    const unsigned ballot = __ballot_sync(kAll, hit);
    int* count = p.counts + s * row + unit;
    if constexpr (!FILL) {
      if (lane == 0) *count = __popc(ballot);
    } else if (hit) {
      const int bx = sx * kSuperW, by = sy * kSuperH;
      const unsigned box = static_cast<unsigned>(max(r.x - bx, 0)) |
                           static_cast<unsigned>(min(r.y - bx, kSuperW - 1)) << 8 |
                           static_cast<unsigned>(max(r.z - by, 0)) << 16 |
                           static_cast<unsigned>(min(r.w - by, kSuperH - 1)) << 24;
      p.lists[s * static_cast<size_t>(p.n_tri) + *count + __popc(ballot & below)] =
          make_int2(tri, static_cast<int>(box));
    }
    if (++sx == p.nsx) {
      sx = 0;
      ++sy;
    }
  }
}

// Launch 2: block s turns counts[s][0 .. n_units) into their exclusive
// prefix, in place, and writes the total to counts[s][n_units].  A thread
// takes kScanPer consecutive counts a tile; the tiles go in order.
__global__ void __launch_bounds__(kScanThreads) scan_prefix_kernel(int* counts, int n_units) {
  __shared__ int s_warp[kScanThreads / kWarp];
  int* c = counts + static_cast<size_t>(blockIdx.x) * (n_units + 1);
  const int t = threadIdx.x, lane = t % kWarp, w = t / kWarp;
  int carry = 0;
  for (int base = 0; base < n_units; base += kScanThreads * kScanPer) {
    const int i0 = base + t * kScanPer;
    int v[kScanPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      v[k] = i0 + k < n_units ? c[i0 + k] : 0;
      sum += v[k];
    }
    int x = sum;  // the warp's inclusive scan of the threads' sums
#pragma unroll
    for (int d = 1; d < kWarp; d <<= 1) {
      const int y = __shfl_up_sync(kAll, x, d);
      if (lane >= d) x += y;
    }
    if (lane == kWarp - 1) s_warp[w] = x;
    __syncthreads();
    if (w == 0) {  // the inclusive scan of the warps' sums
      int y = s_warp[lane];
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
        const int z = __shfl_up_sync(kAll, y, d);
        if (lane >= d) y += z;
      }
      s_warp[lane] = y;
    }
    __syncthreads();
    int at = carry + (w > 0 ? s_warp[w - 1] : 0) + x - sum;
#pragma unroll
    for (int k = 0; k < kScanPer; ++k) {
      if (i0 + k < n_units) c[i0 + k] = at;
      at += v[k];
    }
    carry += s_warp[kWarp - 1];
    __syncthreads();  // s_warp is read before the next tile writes it
  }
  if (t == 0) c[n_units] = carry;
}

struct Walk {
  const float* tri_rec;        // as Cull
  int rec_stride;
  int height, width, x0, y0;   // as Cull
  int nsx, n_units, n_tri;     // as Cull
  const int* counts;           // the prefixes, each list's length last
  const int2* lists;
  const float* init_depth;     // (H, W) or null: +inf
  const int* init_winner;      // (H, W) or null: -1
  float* depth;                // (H, W)
  int* winner;                 // (H, W)
  int* ev_count;               // (1,) or null (no stats)
  float* ev_maxz;              // (1,) or null
};

// Launch 4.
template <bool STATS>
__global__ void __launch_bounds__(kThreads) scan_walk_kernel(const Walk p) {
  __shared__ float s_geom[kThreads][kRowPad];
  __shared__ int s_id[kThreads];
  __shared__ int s_warp[kThreads / kWarp];
  const int t = threadIdx.x, lane = t % kWarp, w = t / kWarp;
  const int bx = blockIdx.x * kBlockW, by = blockIdx.y * kBlockH;
  const int x = bx + t % kBlockW, y0 = by + t / kBlockW;
  const float fx = static_cast<float>(p.x0 + x);
  const bool col_in = x < p.width;
  // rows y0 + k * kRowStep for k < n_in lie in the buffer (the rows below a
  // band's buffer are another band's: they walk nothing)
  const int n_in = min(kPixY, max(0, (p.height - y0 + kRowStep - 1) / kRowStep));
  // the block's super-block list and its place in that super-block
  const int sx = blockIdx.x / kSuperW, sy = blockIdx.y / kSuperH;
  const int lbx = blockIdx.x - sx * kSuperW, lby = blockIdx.y - sy * kSuperH;
  const int s = sy * p.nsx + sx;
  const int n = p.counts[static_cast<size_t>(s) * (p.n_units + 1) + p.n_units];
  const int2* list = p.lists + static_cast<size_t>(s) * p.n_tri;

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

  for (int c0 = 0; c0 < n; c0 += kThreads) {
    // keep, in list order, the chunk's candidates whose range holds the block
    bool hit = false;
    int tri = 0;
    if (c0 + t < n) {
      const int2 e = list[c0 + t];
      tri = e.x;
      hit = range_holds(static_cast<unsigned>(e.y), lbx, lby);
    }
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
      const float4* r =
          reinterpret_cast<const float4*>(p.tri_rec + static_cast<size_t>(tri) * p.rec_stride);
      s_id[at] = tri;
#pragma unroll
      for (int j = 0; j < kGeom / 4; ++j) {
        const float4 v = __ldg(r + j);
        s_geom[at][4 * j] = v.x;
        s_geom[at][4 * j + 1] = v.y;
        s_geom[at][4 * j + 2] = v.z;
        s_geom[at][4 * j + 3] = v.w;
      }
    }
    __syncthreads();
    // each pixel walks the list in order: a strict-less depth update.  The
    // next chunk writes the shared list only after its first barrier, which
    // every thread reaches after this walk, and s_warp after this chunk's
    // last read of it (before the barrier above).
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
    int cnt = 0;
    float z = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < kPixY; ++k) {
      cnt += events[k];
      z = fmaxf(z, maxz[k]);
    }
#pragma unroll
    for (int d = kWarp / 2; d > 0; d >>= 1) {
      cnt += __shfl_down_sync(kAll, cnt, d);
      z = fmaxf(z, __shfl_down_sync(kAll, z, d));
    }
    if (lane == 0) add_events(p.ev_count, p.ev_maxz, cnt, z);
  }
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

// tri_rec: (n_tri, rec_stride) f32 rows, 16-byte aligned, rec_stride >= 16
// and a multiple of 4 (raster_coarse.build_tri_records' geometry columns);
// valid: (n_tri,) bool; n_tri >= 1; the buffer is height x width at global
// pixel (x0, y0); init_depth / init_winner: (height, width) or null (+inf /
// -1); depth, winner: (height, width) outputs; ev_count (int, 0) and
// ev_maxz (float, -inf): both null (no stats) or both one element, which
// the kernel adds this pass's z-pass events to.  Workspace: counts (S,
// ceil(n_tri / 32) + 1) int32 and lists (S, n_tri, 2) int32, S =
// ceil(ceil(width / kBlockW) / kSuperW) * ceil(ceil(height / kBlockH) / kSuperH)
// (trt_scan_block_w/h, trt_scan_super_px); on return counts[s][last] is super-block s's list
// length and lists[s][0 .. length) its list.  Four launches on stream.
extern "C" int trt_scan_resolve(const float* tri_rec, int rec_stride, const unsigned char* valid,
                                int n_tri, int height, int width, int x0, int y0,
                                const float* init_depth, const int* init_winner, float* depth,
                                int* winner, int* ev_count, float* ev_maxz, int* counts,
                                int* lists, void* stream) {
  if (rec_stride < kGeom || rec_stride % 4 != 0 ||
      reinterpret_cast<std::uintptr_t>(tri_rec) % 16 != 0 || n_tri < 1 || height <= 0 ||
      width <= 0 || (ev_count == nullptr) != (ev_maxz == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nbx = cdiv(width, kBlockW), nby = cdiv(height, kBlockH);
  const int nsx = cdiv(nbx, kSuperW), nsy = cdiv(nby, kSuperH);
  const int n_units = cdiv(n_tri, kWarp);
  // few units: the super-blocks are cut into slices, so that some
  // kCullWarps warps share the loop over them
  const int slices = min(cdiv(nsx * nsy, kMinSlice), max(1, cdiv(kCullWarps, n_units)));
  const int slice = cdiv(nsx * nsy, slices);
  int2* list2 = reinterpret_cast<int2*>(lists);
  const Cull c{tri_rec, rec_stride, valid, n_tri, height, width, x0, y0, nsx, nsy, n_units,
               slice, counts, list2};
  const Walk k{tri_rec, rec_stride, height, width, x0, y0, nsx, n_units, n_tri, counts, list2,
               init_depth, init_winner, depth, winner, ev_count, ev_maxz};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 cull_blocks(cdiv(n_units, kCullThreads / kWarp), cdiv(nsx * nsy, slice));
  scan_cull_kernel<false><<<cull_blocks, kCullThreads, 0, s>>>(c);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  scan_prefix_kernel<<<nsx * nsy, kScanThreads, 0, s>>>(counts, n_units);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  scan_cull_kernel<true><<<cull_blocks, kCullThreads, 0, s>>>(c);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(nbx, nby);
  if (ev_count != nullptr)
    scan_walk_kernel<true><<<grid, kThreads, 0, s>>>(k);
  else
    scan_walk_kernel<false><<<grid, kThreads, 0, s>>>(k);
  return static_cast<int>(cudaGetLastError());
}

// the walk's block and the super-block, in pixels (ops/raster.py::ScanGeometry)
extern "C" int trt_scan_block_w() { return kBlockW; }
extern "C" int trt_scan_block_h() { return kBlockH; }
extern "C" int trt_scan_super_px() { return kSuperPx; }
