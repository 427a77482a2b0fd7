// Untile for Hopper (sm_90a): (T, th, tw) 32-bit tiles -> row-major image,
// a permutation copy, with the crop, the colour unpack and the placement of
// compact tiles done in its stores.  Two kernels:
//
//   untile32_kernel (one plane) replaces tinyrenderder_tpu/ops/
//     raster_sparse.py::_untile_one_kernel (launched by _untile_one_jit);
//   untile3_kernel (the frame's packed colour i32, depth f32 and winner i32
//     planes in one launch, the plane on blockIdx.z) replaces
//     raster_sparse.py::_untile_kernel (launched by _untile_call_jit).
//
// Entry points, each one launch:
//   trt_untile32 / trt_untile3: the plain layout (nty*th, ntx*tw);
//   trt_untile_image: one plane cropped to (height, width), its tiles
//     gathered by id from a compact (A, th, tw) stack (fill where a tile is
//     absent) or taken in order, stored as 32-bit words or, for packed
//     0x00BBGGRR colour, as (height, width, 3) uint8;
//   trt_untile3_image: the three planes cropped, the colour unpacked.
// Plain versions: tinyrenderder_tpu_torch/ops/raster_sparse.py::
// untile_one_plain, untile3_plain, untile_image_plain, untile3_image_plain.
//
// What bounds it on this card: device-memory bandwidth.  Each word is read
// once and each output byte written once; nothing is computed but
// addresses and, for colour, a byte permutation.  What the design does:
//   * tile_w = 128 with tile_h 8, 16 or 32 is compiled per tile_h: one warp
//     moves a group of R = min(th, 8) rows of one tile, lane = 16-byte
//     column, so every load and store of a full row is one coalesced
//     512-byte access.  All R loads are issued before the first store, so
//     R loads are in flight per thread; every index is a shift or a
//     constant, and the per-vector offsets are immediates on a pointer
//     computed once per row.  The loads and stores carry no streaming
//     (.cs) hint: in A/B builds on the card it slowed the warm case,
//     where a plane just written by the previous stage sits in the 50 MB
//     L2, and did not change the cold one.
//   * A block is 8 warps on one tile-row band (blockIdx.y), 32 KB at th >= 8
//     in the plain layout: at 2048² with 32-row tiles 512 blocks of 256
//     threads, not thousands of 8-16 KB ones.  A/B builds on the card
//     found 1 to 8 rows a warp, and a load-ahead depth of 2 to 8 rows,
//     within a few per cent of each other with a cold L2 (16 rows slower):
//     the kernel runs at the speed of a copy of the same bytes
//     (chip_smoke.py [3 untile]).
//   * The compact stack's tile -> slot lookup is a binary search of the
//     ascending ids, once per warp and row group (L1-resident broadcast
//     loads), so the placement needs no full-frame fill, scatter or map.
//   * The crop skips rows and columns outside the image; a 32-bit row is
//     stored as 16-byte vectors where the address is 16-byte aligned and
//     word by word elsewhere (width % 4 != 0, the ragged edge).  A colour
//     row's 128 pixels are turned into 384 bytes of RGB in shared memory
//     (three __byte_perm a lane) and stored as 24 16-byte vectors where the
//     row segment is 16-byte aligned (every row when width % 16 == 0), as
//     words where it is 4-byte aligned, in bytes elsewhere.
//   * Any other tile shape (tw % 4 == 0) takes the generic kernel: one tile
//     row a warp, its 16-byte columns strided over the lanes; one integer
//     division a warp row, none per vector.
// The words are moved as bits, so int32 and float32 planes are copied bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 8;               // rows a warp holds (tile_w 128 path)
constexpr int kRgbWords = 96;          // one 128-pixel row as RGB bytes, in words
constexpr int kMaxGridY = 65535;

// rows a warp moves at tile height TH on the tile_w 128 path (TH 0: the
// generic kernel, one row), and its warp units a tile
template <int TH>
__host__ __device__ constexpr int rows_of() { return TH == 0 ? 1 : TH < kRows ? TH : kRows; }

template <int TH>
__host__ __device__ __forceinline__ int units_per_tile(int th) {
  return TH == 0 ? th : TH / rows_of<TH>();
}

struct Plane {
  const int4* src;   // (n_slots, th, tw) 32-bit tiles
  void* out;         // (height, width) 32-bit, or (height, width, 3) uint8
  int rgb;           // 1: packed 0x00BBGGRR -> R, G, B bytes
  int fill;          // the bits of an absent tile's words
};

struct Frame {
  Plane plane[3];    // blockIdx.z picks one
  const int* ids;    // slot k holds tile ids[k] (ascending); null: slot t = tile t
  int n_ids;
  int ntx, nty, th, tw4;
  int height, width;
};

// The slot of ``tile`` in the compact stack, -1 when absent.  ``ids`` is
// ascending and unique, so ids[k] >= k and the slot is at most ``tile``.
__device__ __forceinline__ int slot_of(const int* __restrict__ ids, int n, int tile) {
  if (ids == nullptr) return tile;
  int lo = 0, hi = min(n, tile + 1);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(ids + mid) < tile) lo = mid + 1; else hi = mid;
  }
  return (lo < n && __ldg(ids + lo) == tile) ? lo : -1;
}

// The lane's four words, pixels x .. x+3 of a 32-bit image row, those < xe.
__device__ __forceinline__ void store_words(int* row, int x, int xe, int4 v) {
  int* p = row + x;
  const int n = xe - x;
  if (n >= 4 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    *reinterpret_cast<int4*>(p) = v;
  } else {
    if (n > 0) p[0] = v.x;
    if (n > 1) p[1] = v.y;
    if (n > 2) p[2] = v.z;
    if (n > 3) p[3] = v.w;
  }
}

// The lane's four packed colours as 12 RGB bytes at word 3 * lane of ``st``.
__device__ __forceinline__ void stage_rgb(uint32_t* st, int lane, int4 v) {
  const unsigned a = v.x, b = v.y, c = v.z, d = v.w;
  st[3 * lane] = __byte_perm(a, b, 0x4210);       // R0 G0 B0 R1
  st[3 * lane + 1] = __byte_perm(b, c, 0x5421);   // G1 B1 R2 G2
  st[3 * lane + 2] = __byte_perm(c, d, 0x6542);   // B2 R3 G3 B3
}

// A staged 128-pixel row segment (384 bytes at ``st``) to the RGB image row
// ``row`` at pixel xs, the pixels < xe: 16-byte vectors where the segment is
// 16-byte aligned, else words where it is 4-byte aligned, bytes for the rest.
__device__ __forceinline__ void store_rgb(uint8_t* row, const int4* st, int lane, int xs,
                                          int xe) {
  const int n = 3 * min(max(xe - xs, 0), 128);
  uint8_t* seg = row + 3 * static_cast<size_t>(xs);
  const uintptr_t align = reinterpret_cast<uintptr_t>(seg);
  int b = lane;
  if ((align & 15) == 0) {
    if (lane < (n >> 4)) reinterpret_cast<int4*>(seg)[lane] = st[lane];
    b += n & ~15;
  } else if ((align & 3) == 0) {
    const uint32_t* sw = reinterpret_cast<const uint32_t*>(st);
    for (int w = lane; w < (n >> 2); w += 32) reinterpret_cast<uint32_t*>(seg)[w] = sw[w];
    b += n & ~3;
  }
  const uint8_t* sb = reinterpret_cast<const uint8_t*>(st);
  for (; b < n; b += 32) seg[b] = sb[b];
}

__device__ __forceinline__ int* row32(const Plane& p, int width, int y) {
  return static_cast<int*>(p.out) + static_cast<size_t>(y) * width;
}

__device__ __forceinline__ uint8_t* row_rgb(const Plane& p, int width, int y) {
  return static_cast<uint8_t*>(p.out) + static_cast<size_t>(y) * width * 3;
}

// tile_w 128: warp unit u of band ty is row group g = u % G of tile column
// tx = u / G (G = th / R, a power of two), rows ty*TH + g*R .. + R.
template <int TH>
__device__ __forceinline__ void move_group(const Frame& f, const Plane& p, int ty, int u,
                                           int lane, uint32_t* stage) {
  constexpr int R = rows_of<TH>();
  constexpr unsigned G = TH / R;
  const int tx = static_cast<unsigned>(u) / G, g = static_cast<unsigned>(u) % G;
  const int y0 = ty * TH + g * R;
  const int rows = min(R, f.height - y0);
  if (rows <= 0) return;
  const int slot = slot_of(f.ids, f.n_ids, ty * f.ntx + tx);
  const int4* s =
      slot >= 0 ? p.src + (static_cast<size_t>(slot) * TH + g * R) * 32 + lane : nullptr;
  const int4 fill = make_int4(p.fill, p.fill, p.fill, p.fill);
  int4 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < rows) v[r] = s ? __ldg(s + r * 32) : fill;
  }
  const int xs = tx * 128, xe = min(xs + 128, f.width);
  if (p.rgb) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) stage_rgb(stage + r * kRgbWords, lane, v[r]);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows)
        store_rgb(row_rgb(p, f.width, y0 + r),
                  reinterpret_cast<const int4*>(stage + r * kRgbWords), lane, xs, xe);
    }
    __syncwarp();     // the warp's next unit restages
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < rows) store_words(row32(p, f.width, y0 + r), xs + 4 * lane, xe, v[r]);
    }
  }
}

// Any tile shape: warp unit u of band ty is row r = u % th of tile column
// tx = u / th; the row's 16-byte columns go 32 at a time over the lanes.
__device__ __forceinline__ void move_row(const Frame& f, const Plane& p, int ty, int u,
                                         int lane, uint32_t* stage) {
  const int tx = u / f.th, r = u - tx * f.th;
  const int y = ty * f.th + r;
  if (y >= f.height) return;
  const int slot = slot_of(f.ids, f.n_ids, ty * f.ntx + tx);
  const int tw = 4 * f.tw4;
  const int xe = min(tx * tw + tw, f.width);
  const int4* s =
      slot >= 0 ? p.src + (static_cast<size_t>(slot) * f.th + r) * f.tw4 : nullptr;
  for (int c0 = 0; c0 < f.tw4; c0 += 32) {
    const int xs = tx * tw + 4 * c0;
    if (xs >= xe) break;
    const int c = c0 + lane;
    int4 v = make_int4(p.fill, p.fill, p.fill, p.fill);
    if (s != nullptr && c < f.tw4) v = __ldg(s + c);
    if (p.rgb) {
      stage_rgb(stage, lane, v);
      __syncwarp();
      store_rgb(row_rgb(p, f.width, y), reinterpret_cast<const int4*>(stage), lane, xs, xe);
      __syncwarp();
    } else {
      store_words(row32(p, f.width, y), xs + 4 * lane, xe, v);
    }
  }
}

// TH 8, 16, 32: the tile_w 128 path; TH 0: any shape.
template <int TH>
__device__ __forceinline__ void untile_block(const Frame& f) {
  __shared__ __align__(16) uint32_t stage[kWarps][kRows * kRgbWords];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // selected, not indexed: a runtime index into the parameters copies them
  // to the stack
  const Plane p = blockIdx.z == 0 ? f.plane[0] : blockIdx.z == 1 ? f.plane[1] : f.plane[2];
  const int u = blockIdx.x * kWarps + warp;
  if (u >= f.ntx * units_per_tile<TH>(f.th)) return;
  for (int ty = blockIdx.y; ty < f.nty; ty += gridDim.y) {
    if constexpr (TH != 0) move_group<TH>(f, p, ty, u, lane, stage[warp]);
    else move_row(f, p, ty, u, lane, stage[warp]);
  }
}

template <int TH>
__global__ void __launch_bounds__(kThreads) untile32_kernel(Frame f) {
  untile_block<TH>(f);
}

template <int TH>
__global__ void __launch_bounds__(kThreads) untile3_kernel(Frame f) {
  untile_block<TH>(f);
}

template <int TH>
void launch_th(const Frame& f, int n_planes, cudaStream_t stream) {
  const int units = f.ntx * units_per_tile<TH>(f.th);     // warp units a band
  const dim3 grid((units + kWarps - 1) / kWarps, f.nty < kMaxGridY ? f.nty : kMaxGridY,
                  n_planes);
  if (n_planes == 1)
    untile32_kernel<TH><<<grid, kThreads, 0, stream>>>(f);
  else
    untile3_kernel<TH><<<grid, kThreads, 0, stream>>>(f);
}

int launch(const Frame& f, int n_planes, void* stream) {
  if (f.tw4 <= 0 || f.ntx <= 0 || f.nty <= 0 || f.th <= 0 || f.n_ids < 0 ||
      f.height <= 0 || f.height > f.nty * f.th || f.width <= 0 ||
      f.width > f.ntx * 4 * f.tw4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (f.tw4 == 32 && f.th == 8) launch_th<8>(f, n_planes, s);
  else if (f.tw4 == 32 && f.th == 16) launch_th<16>(f, n_planes, s);
  else if (f.tw4 == 32 && f.th == 32) launch_th<32>(f, n_planes, s);
  else launch_th<0>(f, n_planes, s);
  return static_cast<int>(cudaGetLastError());
}

Frame frame(int n_tiles_x, int n_tiles_y, int tile_h, int tile_w, int height, int width,
            const int* ids, int n_ids) {
  Frame f = {};
  f.ids = ids;
  f.n_ids = n_ids;
  f.ntx = n_tiles_x;
  f.nty = n_tiles_y;
  f.th = tile_h;
  f.tw4 = tile_w % 4 == 0 ? tile_w / 4 : 0;
  f.height = height;
  f.width = width;
  return f;
}

Plane plane(const void* src, void* out, int rgb, int fill) {
  return Plane{static_cast<const int4*>(src), out, rgb, fill};
}

}  // namespace

extern "C" int trt_untile32(const void* src, void* dst, int n_tiles_x, int n_tiles_y,
                            int tile_h, int tile_w, void* stream) {
  Frame f = frame(n_tiles_x, n_tiles_y, tile_h, tile_w, n_tiles_y * tile_h,
                  n_tiles_x * tile_w, nullptr, 0);
  f.plane[0] = plane(src, dst, 0, 0);
  return launch(f, 1, stream);
}

extern "C" int trt_untile3(const void* color, const void* depth, const void* winner,
                           void* color_out, void* depth_out, void* winner_out,
                           int n_tiles_x, int n_tiles_y, int tile_h, int tile_w,
                           void* stream) {
  Frame f = frame(n_tiles_x, n_tiles_y, tile_h, tile_w, n_tiles_y * tile_h,
                  n_tiles_x * tile_w, nullptr, 0);
  f.plane[0] = plane(color, color_out, 0, 0);
  f.plane[1] = plane(depth, depth_out, 0, 0);
  f.plane[2] = plane(winner, winner_out, 0, 0);
  return launch(f, 3, stream);
}

extern "C" int trt_untile_image(const void* src, const void* ids, int n_ids, void* dst,
                                int n_tiles_x, int n_tiles_y, int tile_h, int tile_w,
                                int height, int width, int fill, int rgb, void* stream) {
  Frame f = frame(n_tiles_x, n_tiles_y, tile_h, tile_w, height, width,
                  static_cast<const int*>(ids), n_ids);
  f.plane[0] = plane(src, dst, rgb != 0, fill);
  return launch(f, 1, stream);
}

extern "C" int trt_untile3_image(const void* color, const void* depth, const void* winner,
                                 void* rgb_out, void* depth_out, void* winner_out,
                                 int n_tiles_x, int n_tiles_y, int tile_h, int tile_w,
                                 int height, int width, void* stream) {
  Frame f = frame(n_tiles_x, n_tiles_y, tile_h, tile_w, height, width, nullptr, 0);
  f.plane[0] = plane(color, rgb_out, 1, 0);
  f.plane[1] = plane(depth, depth_out, 0, 0);
  f.plane[2] = plane(winner, winner_out, 0, 0);
  return launch(f, 3, stream);
}

extern "C" const char* trt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
