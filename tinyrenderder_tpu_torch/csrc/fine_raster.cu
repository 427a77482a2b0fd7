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
// the prototype's (semantics.barycentric).  Nothing is skipped but an
// empty slot, which the id test rejects at every pixel anyway.
//
// What bounds it on this card: the walk's length, then the instruction
// throughput of its per-pixel arithmetic.  Every pixel of a strip
// evaluates every slot of its strip's bin (three IEEE divisions, each its
// own reciprocal and slow-path check, no contraction: -fmad=false).  The
// bytes are the records' live rows, read once, and the dense planes (init
// depth read, depth and winner written) of every group.  Each step of a
// walk waits on the one before it, and one block walking all of a group's
// rows made the kernel as long as its longest group (182 rows on the 2048²
// headline head, whose 4,096 groups walk about 6 rows on average).
//
// What the design does about it: the split walk of raster_common.cuh,
// as the production rasters have it.
//  * a group's rows are cut into ranges of at most kProtoRangeRows rows,
//    in row order; each range is one work item, a block of 8 warps
//    (item_scan_kernel, find_item).  The grid is G + ceil(row total /
//    kProtoRangeRows) blocks; surplus blocks exit.  A group of no row has
//    one item, which writes its init depth and -1;
//  * the block stages its range's rows in shared memory (coalesced
//    512-byte row reads) and warp k walks slot k of them, each lane on
//    one column of the strip and 4 of its 8 rows: the slot's fields are a
//    broadcast read and the id test is uniform over the warp.  An empty
//    slot is skipped and the walk goes on (the contract does not promise
//    that a strip's bin is a prefix of its column);
//  * a group of one range walks from its init depth and writes its
//    outputs; each range of a longer group writes its first minimum from
//    +inf to partial planes, and proto_merge_kernel folds them in range
//    order with strict-less from the init depth (trt::merge_ranges, no
//    varyings): the serial walk's depth and winner, its first-drawn-wins
//    tie included;
//  * a call whose records have at most kProtoRangeRows rows (the
//    script's 128 x 64 passes) launches the walk alone, one block a
//    group, with no scan and no merge.  (The walk alone takes any row
//    count, staging R rows at a time: one block a group over all its
//    rows, the schedule before the split.)
// The host sizes the grid and the scratch from the row total (the one
// readback of build_strip_records, or rows.sum()), never from G x
// max_rows, which would be ~224 MB at the headline.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "raster_common.cuh"

namespace {

using trt::kWarp;

constexpr int kTH = 8;                            // tile rows
constexpr int kTW = trt::kTileW;                  // 128 tile columns = record lanes
constexpr int kStripW = trt::kStripW;             // 16 lanes a slot
constexpr int kRowStep = kWarp / kStripW;         // a lane's pixels are 2 rows apart
constexpr int kPix = kTH / kRowStep;              // 4 pixels a lane
// record rows of a range, one work item: 64 keeps the script's 128 x 64
// passes (<= 54 rows) on the walk alone; 16 walks the headline head ~20%
// faster but splits them (scripts/torch_split_ab.py variants)
constexpr int kProtoRangeRows = 64;
static_assert(kProtoRangeRows * kTW * 4 <= 48 * 1024, "a range's rows fit static smem");

// the launch: every pointer and size the kernels share
struct ProtoLaunch {
  const float* recs;    // (G, max_rows, 128)
  const int* rows;      // (G,) each group's rows
  int n_groups, max_rows, n_tiles_x;
  const float* init;    // (G, 8, 128)
  float* depth;
  int* winner;
  int* starts;          // (G + 1,) each group's first item, then the total;
                        // null: one item a group (the walk alone)
  float* part_d;        // (items, 8, 128) a range's first minimum
  int* part_w;          // (items, 8, 128) its winner
};

// One block per work item: warp k walks slot k of the item's rows.
// Without the scan (starts null) block g walks all of group g's rows, a
// stage of R rows at a time.
template <int R>
__global__ void __launch_bounds__(trt::kStripThreads)
proto_walk_kernel(const ProtoLaunch p) {
  __shared__ __align__(16) float s_rec[R * kTW];

  const int item = blockIdx.x;
  int g = item, r0 = 0, n;
  bool whole = true;
  if (p.starts) {
    if (item >= p.starts[p.n_groups]) return;  // a surplus block
    const int2 gr = trt::find_item(p.starts, p.n_groups, item);
    g = gr.x;
    whole = trt::range_items<R>(p.rows[g]) == 1;
    r0 = gr.y * R;
    n = min(R, min(p.rows[g], p.max_rows) - r0);
  } else {
    n = min(p.rows[g], p.max_rows);
  }
  const int k = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int col = k * kStripW + lane % kStripW;
  const int o = (lane / kStripW) * kTW + col;  // the lane's first pixel in the plane
  const size_t plane = static_cast<size_t>(kTH) * kTW;
  // the prototype's pixel centres: (tile origin + iota) + 0.5, all exact
  const float px =
      (static_cast<float>((g % p.n_tiles_x) * kTW) + static_cast<float>(col)) + 0.5f;
  const float gy0 = static_cast<float>((g / p.n_tiles_x) * kTH);

  float depth[kPix], py[kPix];
  int win[kPix];
#pragma unroll
  for (int i = 0; i < kPix; ++i) {
    depth[i] = whole ? p.init[g * plane + o + i * kRowStep * kTW] : CUDART_INF_F;
    win[i] = -1;
    py[i] = (gy0 + static_cast<float>(lane / kStripW + i * kRowStep)) + 0.5f;
  }

  const float* rec = p.recs + (static_cast<size_t>(g) * p.max_rows + r0) * kTW;
  for (int s0 = 0; s0 < n; s0 += R) {
    const int m = min(R, n - s0);
    __syncthreads();  // the previous stage is consumed
    for (int i = threadIdx.x; i < m * kTW; i += trt::kStripThreads)
      s_rec[i] = rec[static_cast<size_t>(s0) * kTW + i];
    __syncthreads();
    for (int r = 0; r < m; ++r) {
      const float4* q = reinterpret_cast<const float4*>(s_rec + r * kTW + k * kStripW);
      const float4 f0 = q[0], f1 = q[1], f2 = q[2];
      const float f[10] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w, f2.x, f2.y};
      if (!(f[9] >= 0.0f)) continue;  // covered &= id >= 0: an empty slot, warp-uniform
      const int tri = static_cast<int>(f[9]);
#pragma unroll
      for (int i = 0; i < kPix; ++i) {
        float b0, b1, b2;
        trt::barycentric(f, px, py[i], b0, b1, b2);
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
  for (int i = 0; i < kPix; ++i) {
    const size_t at = o + i * kRowStep * kTW;
    if (whole) {
      p.depth[g * plane + at] = depth[i];
      p.winner[g * plane + at] = win[i];
    } else {
      p.part_d[item * plane + at] = depth[i];
      p.part_w[item * plane + at] = win[i];
    }
  }
}

// One block per band of kMergeRows rows of a group (blockIdx.y): the
// ordered merge of a group of more than one range.
template <int R>
__global__ void __launch_bounds__(trt::kBlockThreads)
proto_merge_kernel(const ProtoLaunch p) {
  const int g = blockIdx.x;
  const int m = trt::range_items<R>(p.rows[g]);
  if (m == 1) return;  // written by its walk
  trt::merge_ranges<kTH, false>(nullptr, 0, g, blockIdx.y, p.starts[g], m, 0.0f, 0, 0, p.init,
                                p.part_d, p.part_w, p.depth, p.winner, nullptr, nullptr,
                                nullptr);
}

}  // namespace

// The record rows of one work item, for the host's grid and scratch sizes.
extern "C" int trt_proto_range_rows() { return kProtoRangeRows; }

// recs (G, max_rows, 128) f32, rows (G,) i32, init (G, 8, 128) f32 ->
// depth (G, 8, 128) f32, winner (G, 8, 128) i32.  scratch null: the walk
// alone (one block a group); else n_items = G + ceil(sum(rows) /
// trt_proto_range_rows()), the walk's grid, and scratch = n_items * 8 *
// 128 floats, as many ints, then G + 1 ints: the scan, the walk and the
// merge.
extern "C" int trt_strip_proto(const float* recs, const int* rows, int n_groups, int max_rows,
                               const float* init, float* depth, int* winner, int n_tiles_x,
                               int n_items, void* scratch, void* stream) {
  if (n_groups <= 0 || max_rows <= 0 || n_tiles_x <= 0 ||
      (scratch != nullptr && n_items < n_groups))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int R = kProtoRangeRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ProtoLaunch p{recs, rows, n_groups, max_rows, n_tiles_x, init, depth, winner,
                nullptr, nullptr, nullptr};
  if (scratch == nullptr) {
    proto_walk_kernel<R><<<n_groups, trt::kStripThreads, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t part = static_cast<size_t>(n_items) * kTH * kTW;
  p.part_d = static_cast<float*>(scratch);
  p.part_w = reinterpret_cast<int*>(p.part_d + part);
  p.starts = p.part_w + part;
  trt::item_scan_kernel<R><<<1, trt::kScanThreads, 0, s>>>(rows, n_groups, p.starts);
  proto_walk_kernel<R><<<n_items, trt::kStripThreads, 0, s>>>(p);
  proto_merge_kernel<R><<<dim3(n_groups, kTH / trt::kMergeRows), trt::kBlockThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
