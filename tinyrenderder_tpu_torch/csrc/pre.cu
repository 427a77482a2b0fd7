// The coarse pre-stage for Hopper (sm_90a): vertex stage, triangle setup,
// tile spans, per-triangle records and stable tile bins of one pass, in
// three launches and one readback.
//
//   pre_front_kernel (one block of kRange threads a range of kRange
//     triangles, one thread a triangle): the vertex stage of the pass's
//     shader, triangle_setup_planes, tile_spans and the tri_rec row; the
//     setup's valid, screen, ndc_z, clip_w and bbox; the triangle's
//     (tx0, ty0, span_x, spans); and the range's pairs per tile, counted
//     in shared memory and written as one row of the (ranges, tiles) count
//     table (on a grid of more than kSharedTiles tiles, counted in that
//     row in global memory).
//   pre_offsets_kernel (one block a run of kScanTiles tiles): the
//     exclusive prefix of each tile's counts over the ranges, in place,
//     and the tile's total; the last block to finish scans the totals into
//     every tile's CSR start, the active (non-empty) tile ids ascending
//     with their CSR start and count, and the word (pair total, active
//     tiles) the host reads back.
//   pre_place_kernel (one warp a range): seeds a counter per tile in
//     shared memory (past kSharedTiles tiles: in the range's own row of
//     the count table) with the tile's CSR start plus its prefix row, then
//     walks the range's (triangle, tile) pairs in submission order, a warp
//     step of 32 pairs at a time: rank = counter + earlier lanes of the
//     step with that tile (__match_any_sync, as rank_kernel.cu's walk
//     does); the triangle id goes to sorted_tri[rank].
//
// It replaces no Pallas kernel: the JAX package computes the pre-stage as
// XLA ops (tinyrenderder_tpu/ops/raster_sparse.py::_pre_sparse_jit).  On
// the card the eager composition it replaces
// (tinyrenderder_tpu_torch/ops/raster_sparse.py::pre_sparse_plain, its
// plain version) makes some 270 launches a pass, and the frame waits on
// the host between them.
//
// Exactness: every float op is the plain version's, in its order and in
// float32 (-fmad=false; __fmul_rn / __fadd_rn / __fdiv_rn spell it out):
// apply_mat4's left-to-right sums with the pad's * 1.0 and * 0.0 kept,
// IEEE division, floor, the clamp of torch.clamp (a NaN passes) and the
// conversion of .to(torch.int32) (cvt.rzi: truncation, saturation, NaN to
// 0); the corners' minimum and maximum propagate a NaN as amin and amax
// do.  The viewport's eight used entries come from the host as float32
// scalars, math3d.viewport(0, 0, w, h) rounded as torch.as_tensor rounds
// it.  Bins are the stable sort's: within a tile, triangles in submission
// order (the reference's first-drawn-wins z-tie rule, our_gl.cpp:165).
// No rank comes from an atomic's return value: the shared atomics of the
// front kernel only sum, and each range's counters belong to one warp that
// walks its pairs in order, so the result does not depend on scheduling.
// The offsets kernel's ticket (zeroed by the front kernel) only picks the
// block that scans.
//
// What bounds it: the bytes.  A triangle reads its 96 B of corners (36
// with a depth-only shader) and writes 64 + 12V B of record, 65 B of setup
// and 16 B of spans; a pair is written once as 4 B; the count table, 4 B
// a (range, tile), is written, read twice and read once more (it stays in
// the 50 MB L2).  So that the writes go out in whole lines, each warp of
// the front kernel stages its 32 records in shared memory and writes them
// row by row, with the setup's screen, ndc_z and clip_w (copies of record
// columns): a thread storing its own 40-float row would send 32 partial
// sectors a store instruction.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kRange = 512;            // triangles a range (front block, place warp)
constexpr int kWarp = 32;
constexpr int kScanTiles = 32;         // tiles an offsets block (one warp wide)
constexpr int kScanSegs = 16;          // range segments an offsets block (its warps)
constexpr int kScanThreads = kScanTiles * kScanSegs;
constexpr int kAhead = 8;              // loads a thread keeps in flight in the count-table loops
constexpr int kGeom = 16;              // record columns before the varyings
// tiles a grid whose per-tile counters live in shared memory: the place
// kernel's counters and its range's offsets fit the default 48 KB of
// dynamic shared memory.  A larger grid counts in global memory, in each
// range's row of the count table, which that range's block (front) or
// warp (place) alone touches.
constexpr int kSharedTiles = 11264;
constexpr unsigned kAll = 0xffffffffu;
constexpr float kWEps = static_cast<float>(1e-12);   // semantics.W_EPS as float32
constexpr float kBig = 1073741824.0f;                // 2 ** 30

// the vertex stage: shaders._base_vertex (Phong, Eye), the same with the
// position_model passthrough (ShadowMappedShader), clip only (DepthShader,
// whose records carry no varyings), clip with ndc_z (GrayDepthShader)
enum Kind { kBase = 0, kShadow = 1, kDepth = 2, kGrayDepth = 3 };

__host__ __device__ constexpr int vary_of(int kind) {
  return kind == kBase ? 8 : kind == kShadow ? 11 : kind == kGrayDepth ? 1 : 0;
}

struct Attr {
  const float* p;
  int sf, sc, sk;   // element strides: face, corner, channel
  __device__ __forceinline__ float at(int f, int c, int k) const {
    return p[static_cast<long long>(f) * sf + c * sc + k * sk];
  }
};

struct FrontArgs {
  Attr pos, nrm, uv;
  const float* modelview;    // (4, 4) row-major
  const float* perspective;  // (4, 4) row-major
  float vp[8];               // viewport rows 0 and 1
  int n_tri, width, height, tile_w, tile_h, n_tiles_x, n_tiles;
  float* tri_rec;
  int rec_stride;
  unsigned char* valid;
  float* screen;             // (F, 3, 2)
  float* ndc_z;              // (F, 3)
  float* clip_w;             // (F, 3)
  int4* bbox;                // (F, 4): min_x, max_x, min_y, max_y
  int4* span;                // (F, 4): tx0, ty0, span_x, spans
  int* hist;                 // (ranges, tiles)
  int* word;                 // [0] pairs, [1] active tiles, [2] offsets ticket
};

// a staged record's shared-memory row: odd, so that the 32 lanes of a warp
// writing one column hit 32 banks
__host__ __device__ constexpr int pitch_of(int rec_stride) { return rec_stride | 1; }

// ((m[i,0]*x + m[i,1]*y) + m[i,2]*z) + m[i,3]*w, each op rounded
__device__ __forceinline__ float mat_row(const float* m, int i, float x, float y, float z,
                                         float w) {
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[4 * i], x), __fmul_rn(m[4 * i + 1], y)),
                             __fmul_rn(m[4 * i + 2], z)),
                   __fmul_rn(m[4 * i + 3], w));
}

// torch's NaN-propagating min / max of two
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || a < b) ? a : b;
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || a > b) ? a : b;
}

// torch.clamp(v, -2 ** 30, 2 ** 30).to(torch.int32)
__device__ __forceinline__ int to_int(float v) {
  const float c = isnan(v) ? v : fminf(fmaxf(v, -kBig), kBig);
  return __float2int_rz(c);
}

// torch.div(a, b, rounding_mode="floor") for b > 0
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// kShared: the range's counts in shared memory (n_tiles <= kSharedTiles),
// else in its row of the count table
template <int K, bool kShared>
__global__ void __launch_bounds__(kRange)
pre_front_kernel(FrontArgs a) {
  // dynamic shared memory: the range's per-tile counts (where they fit),
  // then each warp's 32 records, a row of pitch floats each
  extern __shared__ int s_hist[];
  __shared__ float s_m[32];   // modelview, then perspective
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int pitch = pitch_of(a.rec_stride);
  int* cnt = kShared ? s_hist : a.hist + static_cast<long long>(blockIdx.x) * a.n_tiles;
  float* stage = reinterpret_cast<float*>(s_hist + (kShared ? a.n_tiles : 0)) +
                 warp * kWarp * pitch;
  if (threadIdx.x < 16) s_m[threadIdx.x] = a.modelview[threadIdx.x];
  else if (threadIdx.x < 32) s_m[threadIdx.x] = a.perspective[threadIdx.x - 16];
  for (int t = threadIdx.x; t < a.n_tiles; t += kRange) cnt[t] = 0;
  if (blockIdx.x == 0 && threadIdx.x == 0) a.word[2] = 0;
  __syncthreads();

  const int i = blockIdx.x * kRange + threadIdx.x;
  if (i < a.n_tri) {
    const float* mv = s_m;
    const float* pm = s_m + 16;
    float* rec = stage + lane * pitch;   // this triangle's record, staged
    float clip[3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = a.pos.at(i, c, 0), y = a.pos.at(i, c, 1), z = a.pos.at(i, c, 2);
      float pe[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pe[r] = mat_row(mv, r, x, y, z, 1.0f);
#pragma unroll
      for (int r = 0; r < 4; ++r) clip[c][r] = mat_row(pm, r, pe[0], pe[1], pe[2], pe[3]);
      if (K == kBase || K == kShadow) {
        // varyings, channel-major: uv (2), position_eye (3), normal_eye (3)
        // [, position_model (3)]
        const float nx = a.nrm.at(i, c, 0), ny = a.nrm.at(i, c, 1), nz = a.nrm.at(i, c, 2);
        float* v = rec + kGeom + c;
        v[0] = a.uv.at(i, c, 0);
        v[3] = a.uv.at(i, c, 1);
#pragma unroll
        for (int r = 0; r < 3; ++r) v[3 * (2 + r)] = pe[r];
#pragma unroll
        for (int r = 0; r < 3; ++r) v[3 * (5 + r)] = mat_row(mv, r, nx, ny, nz, 0.0f);
        if (K == kShadow) {
          v[3 * 8] = x;
          v[3 * 9] = y;
          v[3 * 10] = z;
        }
      }
    }

    // triangle_setup_planes
    bool w_ok = true, z_all_out = true, finite_ok = true;
    float z[3], sx[3], sy[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float w = clip[c][3];
      w_ok = w_ok && (w > kWEps);
      const float safe_w = w == 0.0f ? 1.0f : w;
      float n[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) n[r] = __fdiv_rn(clip[c][r], safe_w);
      z[c] = n[2];
      z_all_out = z_all_out && ((n[2] < -1.0f) || (n[2] > 1.0f));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool fin = isfinite(n[r]);
        finite_ok = finite_ok && fin;
        n[r] = fin ? n[r] : 0.0f;
      }
      sx[c] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.vp[0], n[0]), __fmul_rn(a.vp[1], n[1])),
                                  __fmul_rn(a.vp[2], n[2])),
                        __fmul_rn(a.vp[3], n[3]));
      sy[c] = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a.vp[4], n[0]), __fmul_rn(a.vp[5], n[1])),
                                  __fmul_rn(a.vp[6], n[2])),
                        __fmul_rn(a.vp[7], n[3]));
    }
    const float e1x = __fsub_rn(sx[1], sx[0]);
    const float e1y = __fsub_rn(sy[1], sy[0]);
    const float e2x = __fsub_rn(sx[2], sx[0]);
    const float e2y = __fsub_rn(sy[2], sy[0]);
    const float cross = __fsub_rn(__fmul_rn(e1x, e2y), __fmul_rn(e1y, e2x));
    const int min_x = max(to_int(floorf(nan_min(nan_min(sx[0], sx[1]), sx[2]))), 0);
    const int max_x = min(to_int(ceilf(nan_max(nan_max(sx[0], sx[1]), sx[2]))), a.width - 1);
    const int min_y = max(to_int(floorf(nan_min(nan_min(sy[0], sy[1]), sy[2]))), 0);
    const int max_y = min(to_int(ceilf(nan_max(nan_max(sy[0], sy[1]), sy[2]))), a.height - 1);
    const bool valid = w_ok && !z_all_out && finite_ok && (cross > 0.0f) && (min_x <= max_x) &&
                       (min_y <= max_y);

    a.valid[i] = valid;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      rec[2 * c] = sx[c];
      rec[2 * c + 1] = sy[c];
      rec[6 + c] = z[c];
      rec[9 + c] = clip[c][3];
      if (K == kGrayDepth) rec[kGeom + c] = z[c];   // the varying ndc_z: clip z / safe w
    }
    a.bbox[i] = make_int4(min_x, max_x, min_y, max_y);
    rec[12] = static_cast<float>(min_x);
    rec[13] = static_cast<float>(max_x);
    rec[14] = static_cast<float>(min_y);
    rec[15] = static_cast<float>(max_y);

    // tile_spans over every tile
    const int tx0 = floor_div(min_x, a.tile_w);
    const int tx1 = floor_div(max_x, a.tile_w);
    const int ty0 = floor_div(min_y, a.tile_h);
    const int ty1 = floor_div(max_y, a.tile_h);
    const int span_x = valid ? tx1 - tx0 + 1 : 0;
    const int span_y = valid ? ty1 - ty0 + 1 : 0;
    const int spans = (span_y > 0 ? span_x : 0) * span_y;
    a.span[i] = make_int4(tx0, ty0, span_x, spans);
    if (spans > 0) {
      // a valid triangle's bbox lies on the frame, so its tiles on the grid
      for (int yy = ty0; yy < ty0 + span_y; ++yy)
        for (int xx = tx0; xx < tx0 + span_x; ++xx) atomicAdd(&cnt[yy * a.n_tiles_x + xx], 1);
    }
  }

  // the warp writes its staged records row by row, and the setup's screen,
  // ndc_z and clip_w (record columns 0-5, 6-8, 9-11), in whole lines
  __syncwarp();
  const int w0 = blockIdx.x * kRange + warp * kWarp;
  const int rows = min(kWarp, a.n_tri - w0);
  for (int r = 0; r < rows; ++r) {
    float* dst = a.tri_rec + static_cast<long long>(w0 + r) * a.rec_stride;
    for (int c = lane; c < a.rec_stride; c += kWarp) dst[c] = stage[r * pitch + c];
  }
  for (int e = lane; e < 6 * rows; e += kWarp)
    a.screen[6LL * w0 + e] = stage[(e / 6) * pitch + e % 6];
  for (int e = lane; e < 3 * rows; e += kWarp) {
    a.ndc_z[3LL * w0 + e] = stage[(e / 3) * pitch + 6 + e % 3];
    a.clip_w[3LL * w0 + e] = stage[(e / 3) * pitch + 9 + e % 3];
  }
  if (!kShared) return;
  __syncthreads();
  int* row = a.hist + static_cast<long long>(blockIdx.x) * a.n_tiles;
  for (int t = threadIdx.x; t < a.n_tiles; t += kRange) row[t] = s_hist[t];
}

// block-wide exclusive scan of (x, y) over kScanThreads threads; also the
// block's totals
__device__ __forceinline__ int2 block_scan2(int x, int y, int2* total) {
  __shared__ int2 s_warp[kScanThreads / kWarp];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  int ix = x, iy = y;
#pragma unroll
  for (int d = 1; d < kWarp; d *= 2) {
    const int ux = __shfl_up_sync(kAll, ix, d);
    const int uy = __shfl_up_sync(kAll, iy, d);
    if (lane >= d) {
      ix += ux;
      iy += uy;
    }
  }
  if (lane == kWarp - 1) s_warp[warp] = make_int2(ix, iy);
  __syncthreads();
  int bx = 0, by = 0, tx = 0, ty = 0;
  for (int w = 0; w < kScanThreads / kWarp; ++w) {
    const int2 s = s_warp[w];
    if (w < warp) {
      bx += s.x;
      by += s.y;
    }
    tx += s.x;
    ty += s.y;
  }
  __syncthreads();   // s_warp may be rewritten by the next call
  *total = make_int2(tx, ty);
  return make_int2(bx + ix - x, by + iy - y);
}

__global__ void __launch_bounds__(kScanThreads)
pre_offsets_kernel(int* __restrict__ hist, int n_ranges, int n_tiles, int* __restrict__ tile_total,
                   int* __restrict__ tile_start, int* __restrict__ ids, int* __restrict__ cstart,
                   int* __restrict__ ccount, int* __restrict__ word) {
  __shared__ int s_tot[kScanSegs][kScanTiles];
  __shared__ bool s_last;
  const int lane = threadIdx.x % kWarp;
  const int seg = threadIdx.x / kWarp;
  const int t = blockIdx.x * kScanTiles + lane;
  const int per = (n_ranges + kScanSegs - 1) / kScanSegs;
  const int g0 = min(seg * per, n_ranges);
  const int g1 = min(g0 + per, n_ranges);
  int sum = 0;
  if (t < n_tiles) {
#pragma unroll kAhead   // the rows' loads in flight together
    for (int g = g0; g < g1; ++g) sum += hist[static_cast<long long>(g) * n_tiles + t];
  }
  s_tot[seg][lane] = sum;
  __syncthreads();
  int run = 0;
  for (int s = 0; s < seg; ++s) run += s_tot[s][lane];
  if (t < n_tiles) {
    // kAhead rows' loads before their stores (a store could alias a later load)
    for (int g = g0; g < g1; g += kAhead) {
      int v[kAhead];
#pragma unroll
      for (int k = 0; k < kAhead; ++k)
        v[k] = g + k < g1 ? hist[static_cast<long long>(g + k) * n_tiles + t] : 0;
#pragma unroll
      for (int k = 0; k < kAhead; ++k) {
        if (g + k < g1) hist[static_cast<long long>(g + k) * n_tiles + t] = run;
        run += v[k];
      }
    }
    if (seg == kScanSegs - 1) tile_total[t] = run;
  }

  // the last block to finish scans the tiles
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(word + 2, 1) == static_cast<int>(gridDim.x) - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  int pairs = 0, active = 0;
  for (int c0 = 0; c0 < n_tiles; c0 += kScanThreads) {
    const int u = c0 + threadIdx.x;
    const int c = u < n_tiles ? __ldcg(tile_total + u) : 0;
    int2 tot;
    const int2 ex = block_scan2(c, c > 0, &tot);
    if (u < n_tiles) tile_start[u] = pairs + ex.x;
    if (c > 0) {
      ids[active + ex.y] = u;
      cstart[active + ex.y] = pairs + ex.x;
      ccount[active + ex.y] = c;
    }
    pairs += tot.x;
    active += tot.y;
  }
  if (threadIdx.x == 0) {
    word[0] = pairs;
    word[1] = active;
  }
}

template <bool kShared>
__global__ void __launch_bounds__(kWarp)
pre_place_kernel(const int4* __restrict__ span, int n_tri, int* __restrict__ hist,
                 const int* __restrict__ tile_start, int n_tiles, int n_tiles_x,
                 int* __restrict__ sorted_tri) {
  extern __shared__ int s_mem[];
  int* row = hist + static_cast<long long>(blockIdx.x) * n_tiles;
  int* cnt = kShared ? s_mem : row;               // n_tiles counters
  int* s_off = s_mem + (kShared ? n_tiles : 0);   // kRange pair offsets of the range's triangles
  constexpr int kPer = kRange / kWarp;
  const int lane = threadIdx.x;
#pragma unroll kAhead   // a lane's loads in flight together: one warp seeds every counter
  for (int t = lane; t < n_tiles; t += kWarp)
    cnt[t] = __ldg(tile_start + t) + (kShared ? __ldg(row + t) : row[t]);
  const int r0 = blockIdx.x * kRange;
  const int n = min(kRange, n_tri - r0);
  for (int j = lane; j < kRange; j += kWarp) s_off[j] = j < n ? __ldg(&span[r0 + j].w) : 0;
  __syncwarp();
  // exclusive prefix of the spans: lane l sums entries l * kPer .. + kPer
  int loc[kPer];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    loc[j] = sum;
    sum += s_off[lane * kPer + j];
  }
  int incl = sum;
#pragma unroll
  for (int d = 1; d < kWarp; d *= 2) {
    const int u = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += u;
  }
  const int total = __shfl_sync(kAll, incl, kWarp - 1);
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kPer; ++j) s_off[lane * kPer + j] = incl - sum + loc[j];
  __syncwarp();

  const unsigned below = (1u << lane) - 1u;
  for (int base = 0; base < total; base += kWarp) {
    const int p = base + lane;
    const bool live = p < total;
    // the pair's triangle: the last j with s_off[j] <= p (entries past n,
    // and triangles of no pair, repeat the next offset)
    int j = 0;
#pragma unroll
    for (int step = kRange / 2; step >= 1; step /= 2) j = s_off[j + step] <= p ? j + step : j;
    int tile = -1;
    if (live) {
      const int4 s = __ldg(span + r0 + j);
      const int k = p - s_off[j];
      const int q = k / s.z;
      tile = (s.y + q) * n_tiles_x + s.x + (k - q * s.z);
    }
    const unsigned same = __match_any_sync(kAll, tile);
    const int rank = live ? cnt[tile] + __popc(same & below) : 0;
    __syncwarp();   // every lane has read its counter
    // the group's leader is its lowest lane: its rank is the counter
    if (live && (same & below) == 0) cnt[tile] = rank + __popc(same);
    __syncwarp();   // the step's counts are in
    if (live) sorted_tri[rank] = r0 + j;
  }
}

// the front launch, its dynamic shared memory raised past the default 48 KB
// where it needs more (once per kind, counter place and size: the
// attribute persists)
template <int K, bool kShared>
cudaError_t launch_front(const FrontArgs& a, int n_ranges, cudaStream_t s) {
  const size_t smem =
      (static_cast<size_t>(kShared ? a.n_tiles : 0) + kRange * pitch_of(a.rec_stride)) * 4;
  static size_t allowed = 48 * 1024;
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(pre_front_kernel<K, kShared>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  pre_front_kernel<K, kShared><<<n_ranges, kRange, smem, s>>>(a);
  return cudaSuccess;
}

template <int K>
cudaError_t launch_front(const FrontArgs& a, int n_ranges, cudaStream_t s) {
  return a.n_tiles <= kSharedTiles ? launch_front<K, true>(a, n_ranges, s)
                                   : launch_front<K, false>(a, n_ranges, s);
}

}  // namespace

extern "C" int trt_pre_range() { return kRange; }

// The front and offsets launches of one pass.  kind: the vertex stage (the
// Kind enum); pos, nrm, uv (F, 3, C) float32 with their element strides
// (nrm and uv only for kBase and kShadow); modelview, perspective (4, 4)
// float32 on the device; vp: the viewport's rows 0 and 1.  Outputs: tri_rec
// (F, rec_stride = 16 + 3V) float32; valid (F,) bytes; screen (F, 3, 2),
// ndc_z (F, 3), clip_w (F, 3) float32; bbox, span (F, 4) int32, 16-byte
// aligned; hist (n_ranges, n_tiles) int32 with n_ranges = ceil(F / kRange),
// then (n_tiles,) tile_total, tile_start, ids, cstart, ccount; word (4
// ints): pairs, active tiles.
extern "C" int trt_pre_front(int kind, int n_tri, const float* pos, int pos_sf, int pos_sc,
                             int pos_sk, const float* nrm, int nrm_sf, int nrm_sc, int nrm_sk,
                             const float* uv, int uv_sf, int uv_sc, int uv_sk,
                             const float* modelview, const float* perspective, float vp00,
                             float vp01, float vp02, float vp03, float vp10, float vp11,
                             float vp12, float vp13, int width, int height, int tile_w,
                             int tile_h, float* tri_rec, int rec_stride, unsigned char* valid,
                             float* screen, float* ndc_z, float* clip_w, int* bbox, int* span,
                             int* hist, int* tile_total, int* tile_start, int* ids, int* cstart,
                             int* ccount, int* word, void* stream) {
  if (kind < kBase || kind > kGrayDepth || n_tri <= 0 || width <= 0 || height <= 0 ||
      tile_w <= 0 || tile_h <= 0 || rec_stride != kGeom + 3 * vary_of(kind))
    return static_cast<int>(cudaErrorInvalidValue);
  const int ntx = (width + tile_w - 1) / tile_w;
  const int nty = (height + tile_h - 1) / tile_h;
  if (static_cast<long long>(ntx) * nty > INT_MAX / 4)
    return static_cast<int>(cudaErrorInvalidValue);
  FrontArgs a;
  a.pos = {pos, pos_sf, pos_sc, pos_sk};
  a.nrm = {nrm, nrm_sf, nrm_sc, nrm_sk};
  a.uv = {uv, uv_sf, uv_sc, uv_sk};
  a.modelview = modelview;
  a.perspective = perspective;
  const float vp[8] = {vp00, vp01, vp02, vp03, vp10, vp11, vp12, vp13};
  for (int k = 0; k < 8; ++k) a.vp[k] = vp[k];
  a.n_tri = n_tri;
  a.width = width;
  a.height = height;
  a.tile_w = tile_w;
  a.tile_h = tile_h;
  a.n_tiles_x = ntx;
  a.n_tiles = ntx * nty;
  a.tri_rec = tri_rec;
  a.rec_stride = rec_stride;
  a.valid = valid;
  a.screen = screen;
  a.ndc_z = ndc_z;
  a.clip_w = clip_w;
  a.bbox = reinterpret_cast<int4*>(bbox);
  a.span = reinterpret_cast<int4*>(span);
  a.hist = hist;
  a.word = word;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_ranges = (n_tri + kRange - 1) / kRange;
  cudaError_t err = cudaSuccess;
  switch (kind) {
    case kBase: err = launch_front<kBase>(a, n_ranges, s); break;
    case kShadow: err = launch_front<kShadow>(a, n_ranges, s); break;
    case kDepth: err = launch_front<kDepth>(a, n_ranges, s); break;
    default: err = launch_front<kGrayDepth>(a, n_ranges, s); break;
  }
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pre_offsets_kernel<<<(a.n_tiles + kScanTiles - 1) / kScanTiles, kScanThreads, 0, s>>>(
      hist, n_ranges, a.n_tiles, tile_total, tile_start, ids, cstart, ccount, word);
  return static_cast<int>(cudaGetLastError());
}

// The place launch: span, hist and tile_start as trt_pre_front left them
// (past kSharedTiles tiles, hist's rows become the counters); sorted_tri
// (pairs,) int32, pairs > 0.
extern "C" int trt_pre_place(const int* span, int n_tri, int* hist, const int* tile_start,
                             int n_tiles, int n_tiles_x, int* sorted_tri, void* stream) {
  if (n_tri <= 0 || n_tiles <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_ranges = (n_tri + kRange - 1) / kRange;
  const bool shared = n_tiles <= kSharedTiles;
  const size_t smem = static_cast<size_t>((shared ? n_tiles : 0) + kRange) * sizeof(int);
  const auto kernel = shared ? pre_place_kernel<true> : pre_place_kernel<false>;
  kernel<<<n_ranges, kWarp, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const int4*>(span), n_tri, hist, tile_start, n_tiles, n_tiles_x,
      sorted_tri);
  return static_cast<int>(cudaGetLastError());
}
