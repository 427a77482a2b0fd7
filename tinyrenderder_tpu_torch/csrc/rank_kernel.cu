// Pair ranks within strips, for Hopper (sm_90a).
//
// Replaces: scripts/experimental_rank_kernel.py::_rank_kernel, as launched
// by rank_pairs_kernel (pallas_call :139), together with the slot
// expansion that rank_pairs_kernel does in XLA before the launch.  Plain
// version and contract: tinyrenderder_tpu_torch/experimental/rank_kernel.py.
//
// Each triangle i has kSlots = 4 slots j (triangle-major, slot-minor =
// submission order): sx = max(span_x, 1), q = j / sx, r = j - q * sx, strip
// row sy = ty0 + q, strip column sc = tx0 + r, live iff j < spans.  A live
// slot's strip is sy * nsx + sc and its rank is the number of earlier live
// slots in the same strip (the stable sort's rank); a padded slot gets
// strip -1 and rank 0, as the TPU kernel writes them.  The wrapper refuses
// live slots outside the TPU's 64 x 128 counter table, so every live slot
// has a table entry here.
//
// Determinism: a rank never comes from an atomic's return value.  One
// block walks the 128-triangle chunks in order (the TPU's sequential
// grid), the 64 x 128 counters as int32 in shared memory (32 KB).  Per
// chunk, each of its 512 threads takes one slot:
//   rank = counters[strip] before the chunk
//        + earlier live slots of the chunk in the same strip
// (in the warp: a __match_any_sync mask; before it: a scan of the earlier
// warps' keys in shared memory, eight 16-byte loads in flight).  Then,
// after a barrier, every live slot adds 1 to its counter with a
// shared-memory atomic: the increments commute, so the counters after the
// chunk do not depend on their order.  Each thread loads its next chunk's
// inputs before walking this one.
//
// What bounds it on this card: neither bytes (16 B in and 32 B out a
// triangle) nor arithmetic, but the serial walk: one block on one SM, two
// barriers and a scan of up to 480 keys per chunk.  A parallel version
// (per-chunk histograms, an exclusive scan over chunks, the in-chunk
// prefix) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 4;
constexpr int kChunk = 128;                // triangles a step, as the TPU's CHUNK
constexpr int kThreads = kChunk * kSlots;  // one thread a slot
constexpr int kRows = 64;                  // the TPU's ROWS_PAD
constexpr int kCols = 128;                 // the TPU's COLS_PAD
constexpr unsigned kAll = 0xffffffffu;

// the four inputs of slot g's triangle, or zeros past the last slot
__device__ __forceinline__ int4 fetch(const int* __restrict__ tx0, const int* __restrict__ ty0,
                                      const int* __restrict__ span_x,
                                      const int* __restrict__ spans, long long g,
                                      long long n_slots) {
  if (g >= n_slots) return make_int4(0, 0, 0, 0);
  const long long i = g / kSlots;
  return make_int4(tx0[i], ty0[i], span_x[i], spans[i]);
}

__global__ void __launch_bounds__(kThreads)
rank_kernel(const int* __restrict__ tx0, const int* __restrict__ ty0,
            const int* __restrict__ span_x, const int* __restrict__ spans, int n_tri,
            int nsx, int* __restrict__ strips, int* __restrict__ ranks) {
  __shared__ int s_count[kRows * kCols];
  __shared__ __align__(16) int s_key[kThreads];

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp_base = tid - lane;
  for (int i = tid; i < kRows * kCols; i += kThreads) s_count[i] = 0;

  const long long n_slots = static_cast<long long>(n_tri) * kSlots;
  int4 next = fetch(tx0, ty0, span_x, spans, tid, n_slots);
  for (long long c0 = 0; c0 < n_slots; c0 += kThreads) {
    const long long g = c0 + tid;
    const int4 t = next;  // (tx0, ty0, span_x, spans) of this slot's triangle
    // the next chunk's inputs are in flight during this chunk's walk
    next = fetch(tx0, ty0, span_x, spans, g + kThreads, n_slots);
    int key = -1, strip = -1;
    if (g < n_slots) {
      const int j = static_cast<int>(g % kSlots);
      const int sx = max(t.z, 1);
      const int q = j / sx;
      const int sy = t.y + q;
      const int sc = t.x + (j - q * sx);
      if (j < t.w) {
        strip = sy * nsx + sc;
        // in the table by the wrapper's checks; the guard keeps memory safe
        if (sy >= 0 && sy < kRows && sc >= 0 && sc < kCols) key = sy * kCols + sc;
      }
    }
    s_key[tid] = key;
    __syncthreads();  // the keys are in; the previous chunk's counts are in

    const unsigned same = __match_any_sync(kAll, key);  // every lane of the warp
    int rank = 0;
    if (key >= 0) {
      rank = s_count[key] + __popc(same & ((1u << lane) - 1u));
      const int4* k4 = reinterpret_cast<const int4*>(s_key);
#pragma unroll 8
      for (int m = 0; m < warp_base / 4; ++m) {  // a multiple of 8 iterations
        const int4 v = k4[m];
        rank += (v.x == key) + (v.y == key) + (v.z == key) + (v.w == key);
      }
    }
    if (g < n_slots) {
      strips[g] = strip;
      ranks[g] = rank;
    }
    __syncthreads();  // every read of the counters and keys is done
    if (key >= 0) atomicAdd(&s_count[key], 1);
  }
}

}  // namespace

// tx0, ty0, span_x, spans (n_tri,) i32 -> strips, ranks (n_tri, 4) i32
extern "C" int trt_rank_pairs(const int* tx0, const int* ty0, const int* span_x,
                              const int* spans, int n_tri, int nsx, int* strips, int* ranks,
                              void* stream) {
  if (n_tri <= 0) return static_cast<int>(cudaErrorInvalidValue);
  rank_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tx0, ty0, span_x, spans, n_tri, nsx, strips, ranks);
  return static_cast<int>(cudaGetLastError());
}
