// Merge + shade for Hopper (sm_90a): one pass's compact raster outputs
// merged into the frame's tiles, and the fragment of every pixel the pass
// won, in one launch; and the same fragment on a fresh frame.
//
//   merge_shade_kernel<K> (one thread a pixel of an active tile; tile a of
//     the pass is frame tile ids[a]): writes the pass's depth at every
//     active pixel; where the pass won the pixel (winner >= 0), the winner
//     plus the pass's offset and, for a shader that writes colour, the
//     fragment of the pixel's varyings, finalized and packed 0x00BBGGRR.
//     Elsewhere the frame keeps its winner and colour.  K is the fragment:
//     Phong (the packed 7-channel texel, the eye-pixel test, the normal-map
//     blend, key / fill / rim diffuse and key specular), Eye (normalized
//     interpolated normal, key and rim diffuse, the x^8 specular),
//     ShadowMappedShader (Phong, then the light-space transform of
//     position_model, the clamped gather from the shadow map and the
//     0.3 / 1.0 gate on all but the ambient term), GrayDepthShader, and
//     depth only (a shader that writes no colour).
//   shade_fresh_kernel<K> (one thread a pixel of the compact tiles; the
//     image route's single pass on a fresh frame, where a pixel's winner
//     >= 0 is already the merge's outcome): the packed fragment of K, one
//     of the colour kinds, where the winner is >= 0, and 0 elsewhere,
//     written into compact (A, th, tw) tiles.  It calls the same uniform
//     load and fragment as merge_shade_kernel.
//
// It replaces no Pallas kernel: the JAX package merges and shades as XLA
// ops (tinyrenderder_tpu/ops/raster_sparse.py::_post_sparse_jit).  On the
// card the eager composition it replaces
// (tinyrenderder_tpu_torch/ops/raster_sparse.py::post_sparse_plain, its
// plain version) makes some 170 launches a colour pass, shades every
// active pixel and throws away the ones the pass lost, and the frame
// waits on the host between the launches; the fresh entry replaces
// shade_compact_fresh_plain, the same chain and a torch.where.
//
// Exactness: every float op is the plain version's (shaders.py), in its
// order and in float32 (-fmad=false; __fmul_rn / __fadd_rn / __fdiv_rn /
// __fsqrt_rn spell it out): dot3's ((x + y) + z), apply_mat4's
// left-to-right sums with transform_dir's m[i][3] * 0 and the shadow
// transform's m[i][3] * 1 kept, normalized3's pass-through of a
// zero-length vector, IEEE division and the correctly rounded root (as
// sqrt_rn's float64 root rounded to float32 is).  Shader constants come
// from the host as float32 scalars, each rounded as PyTorch rounds a
// Python float operand.  torch.clamp(x, min=) and clamp(max=) pass a NaN
// (fmaxf / fminf would not); _to_int32 maps NaN and |x| >= 2**31 to 0
// before the clamp; finalize_color's float -> int32 -> uint8 is cvt.rzi
// (truncation, saturation, NaN to 0) and then the low byte.
//
// What bounds it: the bytes.  A thread reads its tile id, depth and winner
// (12 B) and writes the depth (4 B); a won pixel reads its V varyings (4V
// B, neighbouring threads at neighbouring addresses) and writes winner and
// colour (8 B).  On a fresh frame a thread reads its winner and writes its
// colour (8 B), a won pixel reads its varyings besides.  Only won pixels gather a texel or a shadow-map texel; the
// texture (7 B a texel) and the map stay in the 50 MB L2 across a pass.
// The uniforms (matrices, lights) are read once a block into shared
// memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 256;            // threads a block, one pixel each
constexpr float kInt32Range = 2147483648.0f;   // shaders._INT32_RANGE

enum Kind { kPhong = 0, kEye = 1, kShadow = 2, kGrayDepth = 3, kDepthOnly = 4 };

__host__ __device__ constexpr int vary_of(int kind) {
  return kind == kPhong || kind == kEye ? 8 : kind == kShadow ? 11 : kind == kGrayDepth ? 1 : 0;
}

// the shader's constants, each a float32 scalar
struct Consts {
  float ambient, key_diffuse, key_specular, fill_diffuse, rim_diffuse, specular_scale;
  float one_minus_s, s;                  // normal_map_strength: float32(1.0 - s), float32(s)
  float shadow_eps, shadow_factor;       // SHADOW_EPS, SHADOW_AMBIENT_FACTOR
  float eye_brightness, eye_specular;    // the eye-pixel thresholds
};

struct ShadeArgs {
  const int* ids;                 // (A,) frame tile of each compact tile (merge only)
  const float* depth_c;           // (A, th, tw)
  const int* winner_c;            // (A, th, tw)
  const float* vary_c;            // (A, V, th, tw)
  long long n_px;                 // A * th * tw
  int area, n_vary, winner_offset;
  int* color;                     // (T, th, tw) frame planes; fresh: (A, th, tw) output
  float* depth;                   // merge only
  int* winner;
  const float* modelview;         // (4, 4) row-major
  const float* key;               // (3,) light directions in eye space
  const float* fill;
  const float* rim;
  const unsigned char* tex;       // (tex_h, tex_w, 7) packed texture
  int tex_h, tex_w;
  const float* shadow_matrix;     // (4, 4) row-major
  const float* shadow_map;        // (map_h, map_w)
  int map_h, map_w;
  Consts c;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// (ax*bx + ay*by) + az*bz
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}

// zero-length pass-through (geometry.h:136-140)
__device__ __forceinline__ V3 normalized3(V3 v) {
  const float len = __fsqrt_rn(dot3(v, v));
  if (len == 0.0f) return v;
  return {dvd(v.x, len), dvd(v.y, len), dvd(v.z, len)};
}

// torch.clamp(x, min=lo): a NaN passes
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// ((m[i,0]*x + m[i,1]*y) + m[i,2]*z) + m[i,3]*w
__device__ __forceinline__ float mat_row(const float* m, int i, float x, float y, float z,
                                         float w) {
  return add(add(add(mul(m[4 * i], x), mul(m[4 * i + 1], y)), mul(m[4 * i + 2], z)),
             mul(m[4 * i + 3], w));
}

// _to_int32 of a truncated value: NaN and |t| >= 2**31 become 0
__device__ __forceinline__ int to_int32(float t) {
  return fabsf(t) < kInt32Range ? __float2int_rz(t) : 0;
}

// _nearest_index: trunc(coord * size), to int32, clamped to the edge
__device__ __forceinline__ int nearest(float coord, int size) {
  const int i = to_int32(truncf(mul(coord, static_cast<float>(size))));
  return min(max(i, 0), size - 1);
}

// finalize_color of one channel: min(255, v) (a NaN passes), trunc, the
// card's float -> int32 conversion, then the low byte
__device__ __forceinline__ int finalize(float v) {
  const float c = isnan(v) ? v : fminf(v, 255.0f);
  return __float2int_rz(truncf(c)) & 0xFF;
}

__device__ __forceinline__ int pack(const float rgb[3]) {
  return finalize(rgb[0]) | (finalize(rgb[1]) << 8) | (finalize(rgb[2]) << 16);
}

// the packed texel at (u, v): diffuse RGB and, for Phong, the normal-map
// vector (normalized) and the specular scalar (sample_packed)
template <bool kFull>
__device__ __forceinline__ void sample_packed(const ShadeArgs& a, float u, float v, float base[3],
                                              V3* nm, float* spec) {
  const int xi = nearest(u, a.tex_w);
  const int yi = nearest(v, a.tex_h);
  const unsigned char* t = a.tex + (static_cast<long long>(yi) * a.tex_w + xi) * 7;
  for (int c = 0; c < 3; ++c) base[c] = static_cast<float>(t[c]);
  if constexpr (kFull) {
    float n[3];
    for (int c = 0; c < 3; ++c)
      n[c] = sub(mul(dvd(static_cast<float>(t[3 + c]), 255.0f), 2.0f), 1.0f);
    *nm = normalized3({n[0], n[1], n[2]});
    *spec = dvd(static_cast<float>(t[6]), 255.0f);
  }
}

// _phong_rgb_base: -> rgb, and the diffuse sample in base
__device__ __forceinline__ void phong(const ShadeArgs& a, const float* s_mv, const float* s_l,
                                      const float* v, float rgb[3], float base[3]) {
  const Consts& c = a.c;
  const V3 pe = {v[2], v[3], v[4]};
  const V3 g = {v[5], v[6], v[7]};
  V3 nm;
  float spec;
  sample_packed<true>(a, v[0], v[1], base, &nm, &spec);
  const float specular_power = clamp_min(spec, 1.0f);
  const float brightness = dvd(add(add(base[0], base[1]), base[2]), 765.0f);
  const bool is_eye = (brightness >= c.eye_brightness) && (specular_power <= c.eye_specular);
  // transform_dir(modelview, nm): the pad's * 0 kept
  const V3 ne = {mat_row(s_mv, 0, nm.x, nm.y, nm.z, 0.0f),
                 mat_row(s_mv, 1, nm.x, nm.y, nm.z, 0.0f),
                 mat_row(s_mv, 2, nm.x, nm.y, nm.z, 0.0f)};
  const V3 blended = {add(mul(g.x, c.one_minus_s), mul(ne.x, c.s)),
                      add(mul(g.y, c.one_minus_s), mul(ne.y, c.s)),
                      add(mul(g.z, c.one_minus_s), mul(ne.z, c.s))};
  const V3 fn = is_eye ? g : normalized3(blended);
  const V3 view = normalized3({-pe.x, -pe.y, -pe.z});
  const V3 key = {s_l[0], s_l[1], s_l[2]};
  const V3 fill = {s_l[3], s_l[4], s_l[5]};
  const V3 rim = {s_l[6], s_l[7], s_l[8]};
  const float dk = dot3(fn, key);
  const float key_diffuse = mul(clamp_min(dk, 0.0f), c.key_diffuse);
  const float dk2 = mul(dk, 2.0f);
  const V3 rd = normalized3({sub(mul(fn.x, dk2), key.x), sub(mul(fn.y, dk2), key.y),
                             sub(mul(fn.z, dk2), key.z)});
  const float reflect_view = clamp_min(dot3(rd, view), 0.0f);
  const float key_specular = mul(reflect_view > 0.0f ? reflect_view : 0.0f, c.key_specular);
  const float fill_diffuse = mul(clamp_min(dot3(fn, fill), 0.0f), c.fill_diffuse);
  const float rim_diffuse = mul(clamp_min(dot3(fn, rim), 0.0f), c.rim_diffuse);
  const float total = add(add(key_diffuse, fill_diffuse), rim_diffuse);
  const float lit = add(total, c.ambient);
  const float spec_term = mul(mul(key_specular, c.specular_scale), 255.0f);
  for (int k = 0; k < 3; ++k) rgb[k] = add(mul(base[k], lit), spec_term);
}

// _eye_fragment
__device__ __forceinline__ void eye(const ShadeArgs& a, const float* s_l, const float* v,
                                    float rgb[3]) {
  const Consts& c = a.c;
  const V3 pe = {v[2], v[3], v[4]};
  const V3 n = normalized3({v[5], v[6], v[7]});
  float base[3];
  sample_packed<false>(a, v[0], v[1], base, nullptr, nullptr);
  const V3 view = normalized3({-pe.x, -pe.y, -pe.z});
  const V3 key = {s_l[0], s_l[1], s_l[2]};
  const V3 rim = {s_l[6], s_l[7], s_l[8]};
  const float dk = dot3(n, key);
  const float key_diffuse = mul(clamp_min(dk, 0.0f), c.key_diffuse);
  const float rim_diffuse = mul(clamp_min(dot3(n, rim), 0.0f), c.rim_diffuse);
  const float total = add(key_diffuse, rim_diffuse);
  const float dk2 = mul(dk, 2.0f);
  const V3 rd = normalized3({sub(mul(n.x, dk2), key.x), sub(mul(n.y, dk2), key.y),
                             sub(mul(n.z, dk2), key.z)});
  const float reflect_view = clamp_min(dot3(rd, view), 0.0f);
  const float x2 = mul(reflect_view, reflect_view);
  const float x4 = mul(x2, x2);
  const float specular = mul(x4, x4);
  const float lit = add(total, c.ambient);
  const float spec_term = mul(mul(specular, c.specular_scale), 255.0f);
  for (int k = 0; k < 3; ++k) rgb[k] = add(mul(base[k], lit), spec_term);
}

// _shadow_factor: 1 where lit, shadow_factor where the map's depth at the
// pixel's light-screen texel is below its own by more than shadow_eps
__device__ __forceinline__ float shadow_factor(const ShadeArgs& a, const float* s_sm,
                                               const float* v) {
  const float x = v[8], y = v[9], z = v[10];
  float p[4];
  for (int r = 0; r < 4; ++r) p[r] = mat_row(s_sm, r, x, y, z, 1.0f);
  const float w = p[3];
  const float safe_w = w == 0.0f ? 1.0f : w;
  const float sx = dvd(p[0], safe_w), sy = dvd(p[1], safe_w), sz = dvd(p[2], safe_w);
  const int xi = min(max(to_int32(truncf(sx)), 0), a.map_w - 1);
  const int yi = min(max(to_int32(truncf(sy)), 0), a.map_h - 1);
  const bool inside = (sx >= 0.0f) && (sx < static_cast<float>(a.map_w)) && (sy >= 0.0f) &&
                      (sy < static_cast<float>(a.map_h)) && (w > 0.0f);
  const float closest = a.shadow_map[static_cast<long long>(yi) * a.map_w + xi];
  const bool lit = !inside || (closest > sub(sz, a.c.shadow_eps));
  return lit ? 1.0f : a.c.shadow_factor;
}

// the uniforms, once a block, into shared memory: modelview, shadow
// matrix, key / fill / rim (an Eye pass reads no modelview and no fill
// light); every thread of the block reaches the barrier
template <int K>
__device__ __forceinline__ void load_uniforms(const ShadeArgs& a, float* s_mv, float* s_sm,
                                              float* s_l) {
  if (K <= kShadow) {
    const int i = threadIdx.x;
    if (i < 16) {
      if (K != kEye) s_mv[i] = a.modelview[i];
    } else if (i < 32) {
      if (K == kShadow) s_sm[i - 16] = a.shadow_matrix[i - 16];
    } else if (i < 41) {
      const float* light = i < 35 ? a.key : i < 38 ? a.fill : a.rim;
      if (light) s_l[i - 32] = light[(i - 32) % 3];
    }
    __syncthreads();
  }
}

// the packed fragment of a colour kind K at the pixel whose varyings
// start at src (channel stride a.area)
template <int K>
__device__ __forceinline__ int shade_pixel(const ShadeArgs& a, const float* s_mv,
                                           const float* s_sm, const float* s_l,
                                           const float* src) {
  constexpr int V = vary_of(K);
  float v[V];
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = __ldg(src + static_cast<long long>(k) * a.area);

  float rgb[3];
  if constexpr (K == kPhong) {
    float base[3];
    phong(a, s_mv, s_l, v, rgb, base);
  } else if constexpr (K == kShadow) {
    float base[3], lit[3];
    phong(a, s_mv, s_l, v, lit, base);
    const float f = shadow_factor(a, s_sm, v);
    for (int k = 0; k < 3; ++k) {
      const float amb = mul(base[k], a.c.ambient);
      rgb[k] = add(amb, mul(sub(lit[k], amb), f));
    }
  } else if constexpr (K == kEye) {
    eye(a, s_l, v, rgb);
  } else {   // kGrayDepth: (ndc_z * 0.5 + 0.5) * 255
    const float g = mul(add(mul(v[0], 0.5f), 0.5f), 255.0f);
    rgb[0] = rgb[1] = rgb[2] = g;
  }
  return pack(rgb);
}

template <int K>
__global__ void __launch_bounds__(kBlock)
merge_shade_kernel(ShadeArgs a) {
  __shared__ float s_mv[16], s_sm[16], s_l[9];
  load_uniforms<K>(a, s_mv, s_sm, s_l);

  const long long p = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (p >= a.n_px) return;
  const long long t = p / a.area;
  const int q = static_cast<int>(p - t * a.area);
  const long long dst = static_cast<long long>(__ldg(a.ids + t)) * a.area + q;
  a.depth[dst] = __ldg(a.depth_c + p);
  const int w = __ldg(a.winner_c + p);
  if (w < 0) return;
  a.winner[dst] = static_cast<int>(static_cast<unsigned>(w) +
                                   static_cast<unsigned>(a.winner_offset));
  if constexpr (K != kDepthOnly)
    a.color[dst] = shade_pixel<K>(a, s_mv, s_sm, s_l, a.vary_c + t * vary_of(K) * a.area + q);
}

template <int K>
__global__ void __launch_bounds__(kBlock)
shade_fresh_kernel(ShadeArgs a) {
  __shared__ float s_mv[16], s_sm[16], s_l[9];
  load_uniforms<K>(a, s_mv, s_sm, s_l);

  const long long p = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  if (p >= a.n_px) return;
  if (__ldg(a.winner_c + p) < 0) {
    a.color[p] = 0;
    return;
  }
  const long long t = p / a.area;
  const int q = static_cast<int>(p - t * a.area);
  a.color[p] = shade_pixel<K>(a, s_mv, s_sm, s_l, a.vary_c + t * vary_of(K) * a.area + q);
}

template <int K>
void launch(const ShadeArgs& a, cudaStream_t s) {
  const long long blocks = (a.n_px + kBlock - 1) / kBlock;
  merge_shade_kernel<K><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(a);
}

template <int K>
void launch_fresh(const ShadeArgs& a, cudaStream_t s) {
  const long long blocks = (a.n_px + kBlock - 1) / kBlock;
  shade_fresh_kernel<K><<<static_cast<unsigned>(blocks), kBlock, 0, s>>>(a);
}

// The uniform block both entries take, checked and stored into a: false
// where a uniform the kind reads is missing or empty
bool set_uniforms(ShadeArgs& a, int kind, const float* modelview, const float* key,
                  const float* fill, const float* rim, const unsigned char* tex, int tex_h,
                  int tex_w, const float* shadow_matrix, const float* shadow_map, int map_h,
                  int map_w, const Consts& c) {
  const bool textured = kind == kPhong || kind == kEye || kind == kShadow;
  if ((textured && (!key || !rim || !tex || tex_h <= 0 || tex_w <= 0)) ||
      ((kind == kPhong || kind == kShadow) && (!modelview || !fill)) ||
      (kind == kShadow && (!shadow_matrix || !shadow_map || map_h <= 0 || map_w <= 0)))
    return false;
  a.modelview = modelview;
  a.key = key;
  a.fill = fill;
  a.rim = rim;
  a.tex = tex;
  a.tex_h = tex_h;
  a.tex_w = tex_w;
  a.shadow_matrix = shadow_matrix;
  a.shadow_map = shadow_map;
  a.map_h = map_h;
  a.map_w = map_w;
  a.c = c;
  return true;
}

}  // namespace

// One pass's merge + shade.  kind: the fragment (the Kind enum); ids (A,)
// int32, the frame tile of each compact tile; depth_c (A, th, tw) float32,
// winner_c (A, th, tw) int32, vary_c (A, n_vary, th, tw) float32 (null
// when n_vary is 0), the raster's outputs; color, depth, winner: the
// frame's (T, th, tw) planes, written in place.  The uniforms, float32 and
// row-major, those the kind reads (null otherwise): modelview (4, 4), key,
// fill, rim (3,), tex (tex_h, tex_w, 7) uint8, shadow_matrix (4, 4),
// shadow_map (map_h, map_w).  Then the shader's constants (Consts' order).
extern "C" int trt_merge_shade(int kind, const int* ids, int n_active, int tile_h, int tile_w,
                               const float* depth_c, const int* winner_c, const float* vary_c,
                               int n_vary, int winner_offset, int* color, float* depth,
                               int* winner, const float* modelview, const float* key,
                               const float* fill, const float* rim, const unsigned char* tex,
                               int tex_h, int tex_w, const float* shadow_matrix,
                               const float* shadow_map, int map_h, int map_w, float ambient,
                               float key_diffuse, float key_specular, float fill_diffuse,
                               float rim_diffuse, float specular_scale, float one_minus_s,
                               float s, float shadow_eps, float shadow_factor,
                               float eye_brightness, float eye_specular, void* stream) {
  ShadeArgs a;
  if (kind < kPhong || kind > kDepthOnly || n_active <= 0 || tile_h <= 0 || tile_w <= 0 ||
      n_vary != vary_of(kind) || !ids || !depth_c || !winner_c || !depth || !winner ||
      (n_vary > 0 && !vary_c) || (kind != kDepthOnly && !color) ||
      !set_uniforms(a, kind, modelview, key, fill, rim, tex, tex_h, tex_w, shadow_matrix,
                    shadow_map, map_h, map_w,
                    {ambient, key_diffuse, key_specular, fill_diffuse, rim_diffuse,
                     specular_scale, one_minus_s, s, shadow_eps, shadow_factor, eye_brightness,
                     eye_specular}))
    return static_cast<int>(cudaErrorInvalidValue);
  a.ids = ids;
  a.depth_c = depth_c;
  a.winner_c = winner_c;
  a.vary_c = vary_c;
  a.area = tile_h * tile_w;
  a.n_px = static_cast<long long>(n_active) * a.area;
  a.n_vary = n_vary;
  a.winner_offset = winner_offset;
  a.color = color;
  a.depth = depth;
  a.winner = winner;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kPhong: launch<kPhong>(a, st); break;
    case kEye: launch<kEye>(a, st); break;
    case kShadow: launch<kShadow>(a, st); break;
    case kGrayDepth: launch<kGrayDepth>(a, st); break;
    default: launch<kDepthOnly>(a, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// One pass's fragment on a fresh frame.  kind: a colour kind (kPhong,
// kEye, kShadow, kGrayDepth); winner_c (A, th, tw) int32 and vary_c (A,
// n_vary, th, tw) float32, the raster's outputs; out (A, th, tw) int32,
// the packed colour where winner_c >= 0, 0 elsewhere.  Then the uniform
// block and the shader's constants, as trt_merge_shade takes them.
extern "C" int trt_shade_fresh(int kind, int n_active, int tile_h, int tile_w,
                               const int* winner_c, const float* vary_c, int n_vary, int* out,
                               const float* modelview, const float* key, const float* fill,
                               const float* rim, const unsigned char* tex, int tex_h, int tex_w,
                               const float* shadow_matrix, const float* shadow_map, int map_h,
                               int map_w, float ambient, float key_diffuse, float key_specular,
                               float fill_diffuse, float rim_diffuse, float specular_scale,
                               float one_minus_s, float s, float shadow_eps,
                               float shadow_factor, float eye_brightness, float eye_specular,
                               void* stream) {
  ShadeArgs a = {};
  if (kind < kPhong || kind > kGrayDepth || n_active <= 0 || tile_h <= 0 || tile_w <= 0 ||
      n_vary != vary_of(kind) || !winner_c || !vary_c || !out ||
      !set_uniforms(a, kind, modelview, key, fill, rim, tex, tex_h, tex_w, shadow_matrix,
                    shadow_map, map_h, map_w,
                    {ambient, key_diffuse, key_specular, fill_diffuse, rim_diffuse,
                     specular_scale, one_minus_s, s, shadow_eps, shadow_factor, eye_brightness,
                     eye_specular}))
    return static_cast<int>(cudaErrorInvalidValue);
  a.winner_c = winner_c;
  a.vary_c = vary_c;
  a.area = tile_h * tile_w;
  a.n_px = static_cast<long long>(n_active) * a.area;
  a.n_vary = n_vary;
  a.color = out;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kPhong: launch_fresh<kPhong>(a, st); break;
    case kEye: launch_fresh<kEye>(a, st); break;
    case kShadow: launch_fresh<kShadow>(a, st); break;
    default: launch_fresh<kGrayDepth>(a, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}
