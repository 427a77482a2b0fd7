// The post pass for Hopper (sm_90a): the z-image, the 64-tap SSAO, the AO
// byte and the composite of one frame in two launches.
//
//   post_range_kernel: the finite minimum and maximum of the depth plane and
//     an any-finite flag, then (in the last block to finish) the
//     degenerate-range guard and the positive-clamped denominator of
//     zbuffer_to_image into a few device words;
//   post_ssao_kernel: one block per 32x16-px output tile; each pixel's
//     64 taps, its AO byte, its composite and its z-image byte.
//
// It replaces no Pallas kernel: the JAX package computes the post as XLA
// ops (tinyrenderder_tpu/ops/post.py::postprocess_device, a jit of
// zbuffer_to_image, ssao_map, ssao_image and composite).  It was added
// because the eager composition it replaces on CUDA tensors
// (tinyrenderder_tpu_torch/ops/post.py::postprocess_plain, its plain
// version) launches some 820 kernels a frame, 64 taps of a dozen
// elementwise ops each, and the frame waits on the host between them.
//
// What bounds it on this card: device-memory bandwidth.  At 1200x800 it
// must read 3.84 MB of depth and 2.88 MB of colour and write 0.96 MB of
// z-image, 0.96 MB of AO and 2.88 MB of composite: 11.5 MB, 3.4 us at
// 3.35 TB/s (the 64 taps at ~4 float ops a pixel are 3.7 us at 67 TFLOP/s).
// What the design does about it:
//   * Each output tile's depth plus a 16-px halo (the largest |offset| of
//     a tap, kHalo) is loaded once into shared memory, NaN off the frame
//     (the plain version's NaN padding); the 64 taps of every pixel are
//     then read from shared memory, so device memory sees each depth word
//     once per tile that covers it (48x64 words for 32x16 px, 6x; the
//     second read of the plane, after the range kernel's, hits the 50 MB
//     L2).  A warp is 32 consecutive pixels of one row: a tap reads 32
//     consecutive words of one shared-memory row, no bank conflict.
//   * The tap table is a __constant__ array equal to ssao_offsets().  It is
//     const, so with the tap loop unrolled the compiler folds each tap's
//     offset into its shared-memory load (an A/B build on the card without
//     const computed every address: 80 registers and 34.6 us for the
//     stencil at 1200x800, against 64 and 26.8 us).  Tiles of 32x8, 32x32
//     and 64x16 px ran within 20% of 32x16.
//   * The range is exact in any order: finite depths are reduced as
//     order-preserving unsigned keys (warp reductions, then one atomic per
//     block); the last block folds in the sentinels 1e9 / -1e9 where some
//     depth is not finite, as torch.where(finite, z, +-1e9).amin() /
//     .amax() do.
//   * Counts are integers; each float op is the plain version's, in its
//     order and in float32 (-fmad=false, IEEE division), so the three
//     outputs equal the plain composition bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 64;
constexpr int kHalo = 16;             // the largest |dx| or |dy| of a tap
constexpr int kTileW = 32;            // output tile, px; one warp a row
constexpr int kTileH = 16;
constexpr int kThreadsY = 8;          // a block is kTileW x kThreadsY threads
constexpr int kRowsPerThread = kTileH / kThreadsY;
constexpr int kSmemW = kTileW + 2 * kHalo;
constexpr int kSmemH = kTileH + 2 * kHalo;
constexpr int kSsaoThreads = kTileW * kThreadsY;
constexpr int kRangeThreads = 256;
constexpr int kRangeItems = 8;        // depth words a range thread reads, at least
constexpr int kRangeMaxBlocks = 1024;
constexpr int kMaxGridY = 65535;

// the plain version's Python floats, rounded to float32 as torch rounds a
// scalar operand of a float32 tensor op
constexpr float kBig = static_cast<float>(1e9);
constexpr float kRangeEps = static_cast<float>(1e-7);
constexpr float kThreshold = static_cast<float>(1e-3);   // AO_OCCLUSION_THRESHOLD
constexpr float kIntensity = static_cast<float>(0.35);   // AO_INTENSITY

// workspace words: [0] max of ~key over the finite depths, [1] max of key,
// [2] any finite, [3] any not finite, [4] blocks done (zeroed before the
// range kernel); [5] zmin bits, [6] denominator bits, [7] any finite
// (written by the last block)
constexpr int kWsZeroed = 5;

// (dx, dy) of the 64 taps: ops/post.py::ssao_offsets(), 8 directions of 8
// steps out to 16 px
__constant__ const int2 kTapOffsets[kTaps] = {
    {2, 0}, {4, 0}, {6, 0}, {8, 0}, {10, 0}, {12, 0}, {14, 0}, {16, 0},
    {1, 1}, {3, 3}, {4, 4}, {6, 6}, {7, 7}, {8, 8}, {10, 10}, {11, 11},
    {0, 2}, {0, 4}, {0, 6}, {0, 8}, {0, 10}, {0, 12}, {0, 14}, {0, 16},
    {-1, 1}, {-3, 3}, {-4, 4}, {-6, 6}, {-7, 7}, {-8, 8}, {-10, 10}, {-11, 11},
    {-2, 0}, {-4, 0}, {-6, 0}, {-8, 0}, {-10, 0}, {-12, 0}, {-14, 0}, {-16, 0},
    {-1, -1}, {-3, -3}, {-4, -4}, {-6, -6}, {-7, -7}, {-8, -8}, {-10, -10}, {-11, -11},
    {0, -2}, {0, -4}, {0, -6}, {0, -8}, {0, -10}, {0, -12}, {0, -14}, {0, -16},
    {1, -1}, {3, -3}, {4, -4}, {6, -6}, {7, -7}, {8, -8}, {10, -10}, {11, -11},
};

// a float's bits as an unsigned key whose order is the floats' order
__device__ __forceinline__ unsigned int order_key(float v) {
  const unsigned int b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void __launch_bounds__(kRangeThreads)
post_range_kernel(const float* __restrict__ depth, long long n, unsigned int* ws) {
  __shared__ unsigned int part[4][kRangeThreads / 32];
  // the zeroed words' identities: no key is above ~0u or below 0u
  unsigned int lo = ~0u, hi = 0u, any = 0u, other = 0u;
  const long long step = static_cast<long long>(gridDim.x) * kRangeThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kRangeThreads + threadIdx.x; i < n;
       i += step) {
    const float z = depth[i];
    if (isfinite(z)) {
      const unsigned int k = order_key(z);
      lo = min(lo, k);
      hi = max(hi, k);
      any = 1u;
    } else {
      other = 1u;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  any = __reduce_or_sync(0xffffffffu, any);
  other = __reduce_or_sync(0xffffffffu, other);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    part[0][warp] = lo;
    part[1][warp] = hi;
    part[2][warp] = any;
    part[3][warp] = other;
  }
  __syncthreads();
  if (warp != 0) return;
  const bool has = lane < kRangeThreads / 32;
  lo = __reduce_min_sync(0xffffffffu, has ? part[0][lane] : ~0u);
  hi = __reduce_max_sync(0xffffffffu, has ? part[1][lane] : 0u);
  any = __reduce_or_sync(0xffffffffu, has ? part[2][lane] : 0u);
  other = __reduce_or_sync(0xffffffffu, has ? part[3][lane] : 0u);
  if (lane != 0) return;
  atomicMax(&ws[0], ~lo);
  atomicMax(&ws[1], hi);
  if (any) atomicOr(&ws[2], 1u);
  if (other) atomicOr(&ws[3], 1u);
  __threadfence();
  if (atomicAdd(&ws[4], 1u) != gridDim.x - 1) return;
  // the last block: every block's atomics are done
  lo = ~atomicAdd(&ws[0], 0u);
  hi = atomicAdd(&ws[1], 0u);
  if (atomicAdd(&ws[3], 0u) != 0u) {   // the sentinels stand in for the other depths
    lo = min(lo, order_key(kBig));
    hi = max(hi, order_key(-kBig));
  }
  const float zmin = key_value(lo);
  float zmax = key_value(hi);
  // zbuffer_to_image's guard, in its order
  zmax = (zmax - zmin < kRangeEps) ? zmin + kRangeEps : zmax;
  float denom = zmax - zmin;
  denom = denom > 0.0f ? denom : 1.0f;
  ws[5] = __float_as_uint(zmin);
  ws[6] = __float_as_uint(denom);
  ws[7] = atomicAdd(&ws[2], 0u) != 0u ? 1u : 0u;
}

__global__ void __launch_bounds__(kSsaoThreads)
post_ssao_kernel(const float* __restrict__ depth, const uint8_t* __restrict__ color,
                 uint8_t* __restrict__ zimg, uint8_t* __restrict__ ao_out,
                 uint8_t* __restrict__ final_rgb, const unsigned int* __restrict__ ws,
                 int height, int width) {
  __shared__ float tile[kSmemH][kSmemW];
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int tid = threadIdx.y * kTileW + threadIdx.x;
  for (int i = tid; i < kSmemH * kSmemW; i += kSsaoThreads) {
    const int r = i / kSmemW, c = i % kSmemW;
    const int gy = y0 - kHalo + r, gx = x0 - kHalo + c;
    float v = __int_as_float(0x7fc00000);    // NaN: off the frame
    if (gy >= 0 && gy < height && gx >= 0 && gx < width)
      v = depth[static_cast<size_t>(gy) * width + gx];
    // -inf as +inf: both count toward a tap's total and never occlude (no
    // threshold is above +inf), and a centre of either is not finite
    tile[r][c] = v == -INFINITY ? INFINITY : v;
  }
  __syncthreads();
  const float zmin = __uint_as_float(ws[5]);
  const float denom = __uint_as_float(ws[6]);
  const bool any_finite = ws[7] != 0u;
  const int x = x0 + threadIdx.x;
  if (x >= width) return;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int ly = threadIdx.y + k * kThreadsY, y = y0 + ly;
    if (y >= height) break;
    const float z = tile[ly + kHalo][threadIdx.x + kHalo];
    const float threshold = z - kThreshold;
    int total = 0, occluded = 0;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) {
      const int2 o = kTapOffsets[t];
      const float s = tile[ly + kHalo + o.y][threadIdx.x + kHalo + o.x];
      total += !isnan(s);
      // isfinite(s) & (s < threshold): s < threshold fails for NaN and +inf,
      // and the tile holds no -inf
      occluded += s < threshold;
    }
    float ao = 1.0f;
    if (total != 0 && isfinite(z)) {
      const float ratio = static_cast<float>(occluded) / static_cast<float>(total);
      ao = 1.0f - ratio * kIntensity;
    }
    const int a = static_cast<int>(truncf(255.0f * ao));
    const size_t p = static_cast<size_t>(y) * width + x;
    ao_out[p] = static_cast<uint8_t>(a);
    for (int ch = 0; ch < 3; ++ch)
      final_rgb[3 * p + ch] = static_cast<uint8_t>(static_cast<int>(color[3 * p + ch]) * a / 255);
    float v = 255.0f;
    if (any_finite && isfinite(z)) v = truncf(255.0f * (1.0f - (z - zmin) / denom));
    v = v < 0.0f ? 0.0f : (v > 255.0f ? 255.0f : v);
    zimg[p] = static_cast<uint8_t>(static_cast<int>(v));
  }
}

}  // namespace

// depth (height, width) float32, color (height, width, 3) uint8 -> zimg and
// ao (height, width) uint8, final_rgb (height, width, 3) uint8; ws: 8 words
// of scratch.  Three stream operations: a 20-byte memset, then the two
// kernels.
extern "C" int trt_post(const float* depth, const unsigned char* color, unsigned char* zimg,
                        unsigned char* ao, unsigned char* final_rgb, unsigned int* ws,
                        int height, int width, void* stream) {
  if (height <= 0 || width <= 0 || (height + kTileH - 1) / kTileH > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(ws, 0, kWsZeroed * sizeof(unsigned int), s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long n = static_cast<long long>(height) * width;
  const long long per_block = static_cast<long long>(kRangeThreads) * kRangeItems;
  const long long want = (n + per_block - 1) / per_block;
  const int blocks = static_cast<int>(want < kRangeMaxBlocks ? want : kRangeMaxBlocks);
  post_range_kernel<<<blocks, kRangeThreads, 0, s>>>(depth, n, ws);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((width + kTileW - 1) / kTileW, (height + kTileH - 1) / kTileH);
  post_ssao_kernel<<<grid, dim3(kTileW, kThreadsY), 0, s>>>(
      depth, color, zimg, ao, final_rgb, ws, height, width);
  return static_cast<int>(cudaGetLastError());
}
