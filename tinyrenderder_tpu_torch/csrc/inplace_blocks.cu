// In-place update of a list of image blocks, for Hopper (sm_90a): one
// launch, the deduplication inside.
//
// Replaces: scripts/probe_inplace_blocks.py::kernel, as launched by run
// (pallas_call :53): a grid over a compacted list of block ids whose
// output block is aliased to the input image, so that each listed block
// becomes block + 1.0f * add + (float)id and every other block keeps its
// input.  Plain version and contract:
// tinyrenderder_tpu_torch/experimental/inplace_blocks.py.
//
// The TPU applies a duplicate id's visits one after the other, each from
// the block's content before the call (interpret mode: block 3 of ids
// [1, 3, 3, 6] gains 13, once).  On CUDA two blocks on one id would race,
// so CUDA block i first reads ids[0 .. i) (a few KB, in L2) and decides
// with __syncthreads_or whether its id occurred earlier; if it did, or if
// the id lies outside [0, n_blocks), the block returns.  Exactly one CUDA
// block writes each listed image block, whatever the scheduling, and the
// kernel needs no buffer and no launch before it.
//
// What bounds it on this card: device-memory bandwidth; each visited
// block is read and written once, with two IEEE additions a float
// (__fadd_rn, in the script's order: (x + 1.0f * add) + id).
//
// Design: one block of 256 threads a listed id.  Where the block width,
// the image width and the image's address allow it, each thread moves
// 16 bytes at a time (float4), kUnroll of them loaded before any is
// stored, so a 32 x 128 block is one round of 16 KB in flight; otherwise
// one float at a time.  `add` comes by value, or through a pointer to one
// float on the device.  The image is updated in place: nothing outside
// the listed blocks is touched.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float update(float x, float val, float ft) {
  return __fadd_rn(__fadd_rn(x, val), ft);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
inplace_blocks_kernel(float* __restrict__ img, const int* __restrict__ ids, int id_stride,
                      const float* __restrict__ add_ptr, float add_val, int n_blocks,
                      int n_blocks_x, int width, int block_h, int block_w) {
  const int t = ids[static_cast<size_t>(blockIdx.x) * id_stride];
  if (t < 0 || t >= n_blocks) return;  // outside the image: the whole block
  int seen = 0;
  for (int j = threadIdx.x; j < static_cast<int>(blockIdx.x); j += kThreads)
    seen |= ids[static_cast<size_t>(j) * id_stride] == t;
  if (__syncthreads_or(seen)) return;  // a repeat: the first occurrence writes

  const float val = __fmul_rn(1.0f, add_ptr != nullptr ? *add_ptr : add_val);
  const float ft = static_cast<float>(t);
  float* base = img + static_cast<size_t>(t / n_blocks_x) * block_h * width +
                static_cast<size_t>(t % n_blocks_x) * block_w;
  if constexpr (kVec) {
    const int row4 = block_w / 4;
    const int n4 = block_h * row4;
    for (int i0 = threadIdx.x; i0 < n4; i0 += kThreads * kUnroll) {
      float4* p[kUnroll];
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        if (i < n4) {
          const int y = i / row4;
          float* row = base + static_cast<size_t>(y) * width;
          p[u] = reinterpret_cast<float4*>(row) + (i - y * row4);
          v[u] = *p[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (i0 + u * kThreads < n4) {
          v[u].x = update(v[u].x, val, ft);
          v[u].y = update(v[u].y, val, ft);
          v[u].z = update(v[u].z, val, ft);
          v[u].w = update(v[u].w, val, ft);
          *p[u] = v[u];
        }
      }
    }
  } else {
    const int n = block_h * block_w;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int y = i / block_w;
      float* p = base + static_cast<size_t>(y) * width + (i - y * block_w);
      *p = update(*p, val, ft);
    }
  }
}

}  // namespace

// img (H, W) f32 updated in place; ids: n_ids i32 at a stride of
// id_stride ints (repeats and ids outside the image allowed); add_ptr a
// (1,) f32 on the device, or null to take add_val; blocks of
// block_h x block_w tile the image exactly.
extern "C" int trt_inplace_blocks(float* img, const int* ids, int id_stride,
                                  const float* add_ptr, float add_val, int n_ids, int height,
                                  int width, int block_h, int block_w, void* stream) {
  if (n_ids <= 0 || id_stride < 0 || block_h <= 0 || block_w <= 0 || height % block_h ||
      width % block_w)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks_x = width / block_w;
  const int n_blocks = n_blocks_x * (height / block_h);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = block_w % 4 == 0 && width % 4 == 0 &&
                   reinterpret_cast<std::uintptr_t>(img) % 16 == 0;
  if (vec)
    inplace_blocks_kernel<true><<<n_ids, kThreads, 0, s>>>(
        img, ids, id_stride, add_ptr, add_val, n_blocks, n_blocks_x, width, block_h, block_w);
  else
    inplace_blocks_kernel<false><<<n_ids, kThreads, 0, s>>>(
        img, ids, id_stride, add_ptr, add_val, n_blocks, n_blocks_x, width, block_h, block_w);
  return static_cast<int>(cudaGetLastError());
}
