// Pair ranks within strips, for Hopper (sm_90a): a parallel stable
// counting rank.
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
// slots with the same counter-table key sy * 128 + sc (the stable sort's
// rank); a padded slot gets strip -1 and rank 0, as the TPU kernel writes
// them.  A live slot outside the TPU's 64 x 128 counter table is counted
// nowhere and ranked 0; the wrapper refuses such input after reading the
// domain word (below), so only memory safety depends on that guard.
//
// The TPU walks 128-triangle chunks in order, its counters carried from
// one grid step to the next.  Here the slots are cut into G contiguous
// ranges of R slots (R a multiple of 32, G <= kMaxRanges, G and R chosen
// by the wrapper from the slot count and the SM count), and three
// launches replace the serial walk:
//   1. hist (G blocks of kHistThreads): each block counts its range's live
//      slots per key in shared memory and writes its row of 8,192 counts.
//      Each warp step aggregates with __match_any_sync, so one leader a
//      match group adds __popc(same): a pile of triangles on one strip
//      costs one shared atomic a warp step, not one a slot.  The block also
//      reduces its part of the domain word: the largest spans, and the
//      least and largest strip row and column, a padded slot counting as
//      row and column 0 (check_domain's five reductions).
//   2. scan (kKeys / kScanKeys blocks of kScanKeys x kScanSegs): the
//      exclusive prefix of the counts over the ranges, per key, in place:
//      row g becomes the count of live slots with that key in ranges
//      0 .. g-1.  A block takes 32 consecutive keys (each warp reads 128
//      coalesced bytes of a row) and splits the G rows into kScanSegs
//      segments, held in registers, then adds the earlier segments'
//      totals from shared memory.  Block 0 also folds the G parts of the
//      domain word into one word of five ints.
//   3. walk (G blocks of one warp): each block seeds a 32 KB table of
//      counters in shared memory with its prefix row, then walks its
//      range in order, 32 slots a step:
//        rank = counters[key] + earlier lanes of the step with that key
//      (the last from __match_any_sync and __popc(same & lanes below));
//      after a __syncwarp the step's match-group leader adds
//      __popc(same).  The steps go in batches of kAhead: each batch first
//      decodes its slots and matches their keys (independent work, issued
//      together), then runs the counters' chain, a shared load and store
//      a step, while the next batch's inputs are in flight.
//
// Determinism: no rank comes from an atomic's return value.  Phase 1's
// shared atomics only sum (they commute), and phase 3's counters are
// owned by one warp that walks its range in order, so the result does not
// depend on the order in which blocks or warps run.
//
// What bounds each phase on this card: phase 1 writes G x 32 KB of counts
// and reads the 16 B of each triangle; phase 2 reads and writes those
// G x 32 KB once (they stay in the 50 MB L2 at G <= 3 x 132); phase 3
// reads them once more to seed, then is a dependent chain of R / 32 warp
// steps beside its reads and the 32 B written a triangle.  A walking warp
// is alone on its scheduler, so its steps cost the latency of their
// dependent instructions: decode and fetch are branch-free, with no
// division, so that a batch's steps interleave.  G balances phase 3's
// chain against the G x 32 KB of the three phases.  The contract's own
// bound is its bytes: 16 B in and 32 B out a triangle.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kSlots = 4;
constexpr int kRows = 64;                   // the TPU's ROWS_PAD
constexpr int kCols = 128;                  // the TPU's COLS_PAD
constexpr int kKeys = kRows * kCols;        // counter-table keys
constexpr int kWarp = 32;
constexpr int kHistThreads = 256;
constexpr int kScanKeys = 32;               // keys a scan block (one warp wide)
constexpr int kScanSegs = 16;               // row segments a scan block (its warps)
constexpr int kSegRows = 32;                // rows a segment holds in registers
constexpr int kMaxRanges = kScanSegs * kSegRows;
constexpr int kPart = 8;                    // ints a range's domain part (5 used)
constexpr int kAhead = 8;                   // warp steps a batch, their inputs in flight
constexpr unsigned kAll = 0xffffffffu;

struct Slot {
  int key;    // counter-table key, or -1 (padded, outside the table, past the end)
  int strip;  // sy * nsx + sc, or -1 (padded or past the end)
  int spans;  // the triangle's spans (INT_MIN past the end)
  int row;    // sy if live, else 0
  int col;    // sc if live, else 0
};

// The four inputs of slot g's triangle; past the range's end, those of its
// last slot (decode marks such a slot dead).  Like decode, branch-free:
// one warp steps through its range alone, so a step's latency is the sum
// of its dependent instructions unless the steps of a batch interleave,
// and a branch a step would keep them apart.
__device__ __forceinline__ int4 fetch(const int* __restrict__ tx0, const int* __restrict__ ty0,
                                      const int* __restrict__ span_x,
                                      const int* __restrict__ spans, int g, int end) {
  const int i = min(g, end - 1) / kSlots;
  return make_int4(__ldg(tx0 + i), __ldg(ty0 + i), __ldg(span_x + i), __ldg(spans + i));
}

// Slot g of the triangle t = (tx0, ty0, span_x, spans).  q = j / sx without
// a division: j < 4, so j / sx = j / min(sx, 4) = the multiples of
// min(sx, 4) in 1 .. j, and j - q * sx = j - q * min(sx, 4).
__device__ __forceinline__ Slot decode(int4 t, int g, int end, int nsx) {
  const int j = g % kSlots;
  const int s4 = min(max(t.z, 1), kSlots);
  const int q = (j >= s4) + (j >= 2 * s4) + (j >= 3 * s4);
  const int sy = t.y + q;
  const int sc = t.x + (j - q * s4);
  const bool in = g < end;
  const bool live = in && j < t.w;
  const bool table = live && sy >= 0 && sy < kRows && sc >= 0 && sc < kCols;
  Slot s;
  s.key = table ? sy * kCols + sc : -1;
  s.strip = live ? sy * nsx + sc : -1;
  s.spans = in ? t.w : INT_MIN;
  s.row = live ? sy : 0;
  s.col = live ? sc : 0;
  return s;
}

// phase 1: per-range key counts and domain parts
__global__ void __launch_bounds__(kHistThreads)
rank_hist_kernel(const int* __restrict__ tx0, const int* __restrict__ ty0,
                 const int* __restrict__ span_x, const int* __restrict__ spans,
                 int n_slots, int range, int nsx, int* __restrict__ hist,
                 int* __restrict__ part) {
  __shared__ __align__(16) int s_count[kKeys];
  __shared__ int s_red[kHistThreads / kWarp][5];
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  int4* c4 = reinterpret_cast<int4*>(s_count);
  for (int i = threadIdx.x; i < kKeys / 4; i += kHistThreads) c4[i] = make_int4(0, 0, 0, 0);
  __syncthreads();

  const int r0 = blockIdx.x * range;
  const int r1 = min(r0 + range, n_slots);
  int most = INT_MIN, row_lo = INT_MAX, row_hi = INT_MIN, col_lo = INT_MAX, col_hi = INT_MIN;
  // r0 is a multiple of 32: every warp step is warp-uniform; a warp loads
  // kAhead steps' inputs before it counts them
  for (int base = r0 + warp * kWarp; base < r1; base += kAhead * kHistThreads) {
    int4 t[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
      t[a] = fetch(tx0, ty0, span_x, spans, base + a * kHistThreads + lane, r1);
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int g = base + a * kHistThreads + lane;
      const Slot s = decode(t[a], g, r1, nsx);
      if (g < r1) {
        most = max(most, s.spans);
        row_lo = min(row_lo, s.row);
        row_hi = max(row_hi, s.row);
        col_lo = min(col_lo, s.col);
        col_hi = max(col_hi, s.col);
      }
      const unsigned same = __match_any_sync(kAll, s.key);
      if (s.key >= 0 && lane == __ffs(same) - 1) atomicAdd(&s_count[s.key], __popc(same));
    }
  }
  most = __reduce_max_sync(kAll, most);
  row_lo = __reduce_min_sync(kAll, row_lo);
  row_hi = __reduce_max_sync(kAll, row_hi);
  col_lo = __reduce_min_sync(kAll, col_lo);
  col_hi = __reduce_max_sync(kAll, col_hi);
  if (lane == 0) {
    s_red[warp][0] = most;
    s_red[warp][1] = row_lo;
    s_red[warp][2] = row_hi;
    s_red[warp][3] = col_lo;
    s_red[warp][4] = col_hi;
  }
  __syncthreads();  // the counts and the warps' parts are in
  if (threadIdx.x == 0) {
    int p[5] = {s_red[0][0], s_red[0][1], s_red[0][2], s_red[0][3], s_red[0][4]};
    for (int w = 1; w < kHistThreads / kWarp; ++w) {
      p[0] = max(p[0], s_red[w][0]);
      p[1] = min(p[1], s_red[w][1]);
      p[2] = max(p[2], s_red[w][2]);
      p[3] = min(p[3], s_red[w][3]);
      p[4] = max(p[4], s_red[w][4]);
    }
    for (int k = 0; k < 5; ++k) part[blockIdx.x * kPart + k] = p[k];
  }
  int4* h4 = reinterpret_cast<int4*>(hist + static_cast<size_t>(blockIdx.x) * kKeys);
  for (int i = threadIdx.x; i < kKeys / 4; i += kHistThreads) h4[i] = c4[i];
}

// phase 2: exclusive prefix over the ranges, per key, in place; block 0
// folds the domain parts
__global__ void __launch_bounds__(kScanKeys * kScanSegs)
rank_scan_kernel(int* __restrict__ hist, int n_ranges, const int* __restrict__ part,
                 int* __restrict__ domain) {
  __shared__ int s_tot[kScanSegs][kScanKeys];
  const int lane = threadIdx.x % kWarp;
  const int seg = threadIdx.x / kWarp;
  if (blockIdx.x == 0 && seg == 0) {
    int most = INT_MIN, row_lo = INT_MAX, row_hi = INT_MIN, col_lo = INT_MAX, col_hi = INT_MIN;
    for (int g = lane; g < n_ranges; g += kWarp) {
      const int* p = part + g * kPart;
      most = max(most, p[0]);
      row_lo = min(row_lo, p[1]);
      row_hi = max(row_hi, p[2]);
      col_lo = min(col_lo, p[3]);
      col_hi = max(col_hi, p[4]);
    }
    most = __reduce_max_sync(kAll, most);
    row_lo = __reduce_min_sync(kAll, row_lo);
    row_hi = __reduce_max_sync(kAll, row_hi);
    col_lo = __reduce_min_sync(kAll, col_lo);
    col_hi = __reduce_max_sync(kAll, col_hi);
    if (lane == 0) {
      domain[0] = most;
      domain[1] = row_lo;
      domain[2] = row_hi;
      domain[3] = col_lo;
      domain[4] = col_hi;
    }
  }
  const int key = blockIdx.x * kScanKeys + lane;
  const int per = (n_ranges + kScanSegs - 1) / kScanSegs;  // <= kSegRows
  const int g0 = seg * per;
  int v[kSegRows];
  int sum = 0;
#pragma unroll
  for (int i = 0; i < kSegRows; ++i) {
    const int g = g0 + i;
    v[i] = (i < per && g < n_ranges) ? hist[static_cast<size_t>(g) * kKeys + key] : 0;
    sum += v[i];
  }
  s_tot[seg][lane] = sum;
  __syncthreads();
  int run = 0;
  for (int s = 0; s < seg; ++s) run += s_tot[s][lane];
#pragma unroll
  for (int i = 0; i < kSegRows; ++i) {
    const int g = g0 + i;
    if (i < per && g < n_ranges) {
      hist[static_cast<size_t>(g) * kKeys + key] = run;
      run += v[i];
    }
  }
}

// phase 3: each warp walks its range in order, seeded by its prefix row
__global__ void __launch_bounds__(kWarp)
rank_walk_kernel(const int* __restrict__ tx0, const int* __restrict__ ty0,
                 const int* __restrict__ span_x, const int* __restrict__ spans,
                 int n_slots, int range, int nsx, const int* __restrict__ prefix,
                 int* __restrict__ strips, int* __restrict__ ranks) {
  __shared__ __align__(16) int s_count[kKeys];
  const int lane = threadIdx.x;
  const int4* p4 = reinterpret_cast<const int4*>(prefix + static_cast<size_t>(blockIdx.x) * kKeys);
  int4* c4 = reinterpret_cast<int4*>(s_count);
#pragma unroll 16
  for (int i = lane; i < kKeys / 4; i += kWarp) c4[i] = __ldg(p4 + i);
  __syncwarp();

  const int r0 = blockIdx.x * range;
  const int r1 = min(r0 + range, n_slots);
  const unsigned below = (1u << lane) - 1u;
  // the inputs of the next kAhead steps are in flight
  int4 t[kAhead];
#pragma unroll
  for (int a = 0; a < kAhead; ++a) t[a] = fetch(tx0, ty0, span_x, spans, r0 + a * kWarp + lane, r1);
  for (int base = r0; base < r1; base += kAhead * kWarp) {
    // a batch of kAhead steps (a step past r1 has no live lane): first what
    // does not depend on the counters, for all steps at once
    Slot s[kAhead];
    unsigned same[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int g = base + a * kWarp + lane;
      s[a] = decode(t[a], g, r1, nsx);
      t[a] = fetch(tx0, ty0, span_x, spans, g + kAhead * kWarp, r1);
      same[a] = __match_any_sync(kAll, s[a].key);
    }
    // then the counters' chain, step by step
    int rank[kAhead];
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      rank[a] = s[a].key >= 0 ? s_count[s[a].key] + __popc(same[a] & below) : 0;
      __syncwarp();  // every lane has read its counter
      // the group's leader is its lowest lane: its rank is the counter
      if (s[a].key >= 0 && (same[a] & below) == 0) s_count[s[a].key] = rank[a] + __popc(same[a]);
      __syncwarp();  // the step's counts are in
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int g = base + a * kWarp + lane;
      if (g < r1) {
        strips[g] = s[a].strip;
        ranks[g] = rank[a];
      }
    }
  }
}

}  // namespace

// tx0, ty0, span_x, spans (n_tri,) i32 -> strips, ranks (n_tri, 4) i32.
// work: n_ranges * (8192 + 8) + 8 ints of scratch; its last 8 hold the
// domain word (max spans, row min, row max, column min, column max).
// range: slots a range, a multiple of 32; n_ranges * range covers the
// 4 * n_tri slots and (n_ranges - 1) * range does not.
extern "C" int trt_rank_pairs(const int* tx0, const int* ty0, const int* span_x,
                              const int* spans, int n_tri, int nsx, int n_ranges, int range,
                              int* work, int* strips, int* ranks, void* stream) {
  // slot indices are 32-bit: the wrapper refuses 4 n_tri >= 2^24
  if (n_tri <= 0 || n_tri >= (1 << 22) || n_ranges <= 0 || n_ranges > kMaxRanges ||
      range <= 0 || range % kWarp)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_slots = n_tri * kSlots;
  if (static_cast<long long>(n_ranges) * range < n_slots ||
      static_cast<long long>(n_ranges - 1) * range >= n_slots)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* hist = work;
  int* part = hist + static_cast<size_t>(n_ranges) * kKeys;
  int* domain = part + static_cast<size_t>(n_ranges) * kPart;
  rank_hist_kernel<<<n_ranges, kHistThreads, 0, s>>>(tx0, ty0, span_x, spans, n_slots, range,
                                                      nsx, hist, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_scan_kernel<<<kKeys / kScanKeys, kScanKeys * kScanSegs, 0, s>>>(hist, n_ranges, part,
                                                                       domain);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rank_walk_kernel<<<n_ranges, kWarp, 0, s>>>(tx0, ty0, span_x, spans, n_slots, range, nsx,
                                              hist, strips, ranks);
  return static_cast<int>(cudaGetLastError());
}
