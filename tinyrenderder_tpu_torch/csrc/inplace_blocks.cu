// In-place update of a list of image blocks, for Hopper (sm_90a).
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
// so the wrapper deduplicates the ids on the device before the launch,
// keeping first occurrences, and passes -1 for the others: a block given
// -1 (or an id outside the image) does nothing.  Every surviving id is
// written by exactly one block, so the result does not depend on the
// order in which blocks run.
//
// What bounds it on this card: device-memory bandwidth; each visited
// block is read and written once, with two IEEE additions a float
// (__fadd_rn, in the script's order: (x + 1.0f * add) + id).
//
// Design: one block of 256 threads per listed id; consecutive threads
// walk consecutive floats of a block row, so each row of a 128-wide
// block is one coalesced 512-byte read and write.  The image is updated
// in place: nothing outside the listed blocks is touched.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
inplace_blocks_kernel(float* __restrict__ img, const int* __restrict__ ids,
                      const float* __restrict__ add, int n_blocks, int n_blocks_x,
                      int width, int block_h, int block_w) {
  const int t = ids[blockIdx.x];
  if (t < 0 || t >= n_blocks) return;  // a duplicate, or outside the image
  const float val = __fmul_rn(1.0f, add[0]);
  const float ft = static_cast<float>(t);
  float* base = img + static_cast<size_t>(t / n_blocks_x) * block_h * width +
                static_cast<size_t>(t % n_blocks_x) * block_w;
  const int n = block_h * block_w;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int y = i / block_w;
    float* p = base + static_cast<size_t>(y) * width + (i - y * block_w);
    *p = __fadd_rn(__fadd_rn(*p, val), ft);
  }
}

}  // namespace

// img (H, W) f32 updated in place; ids (n_ids,) i32, deduplicated (-1 =
// skip); add (1,) f32 on the device; blocks of block_h x block_w tile
// the image exactly.
extern "C" int trt_inplace_blocks(float* img, const int* ids, const float* add, int n_ids,
                                  int height, int width, int block_h, int block_w,
                                  void* stream) {
  if (n_ids <= 0 || block_h <= 0 || block_w <= 0 || height % block_h || width % block_w)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks_x = width / block_w;
  const int n_blocks = n_blocks_x * (height / block_h);
  inplace_blocks_kernel<<<n_ids, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, ids, add, n_blocks, n_blocks_x, width, block_h, block_w);
  return static_cast<int>(cudaGetLastError());
}
