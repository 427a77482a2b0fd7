"""Shaders: the host-side classes and the device half in PyTorch.

Counterpart of ``tinyrenderder_tpu/shaders.py``: the reference's
``IShader`` and its implementations (our_gl.h:36-52, main.cpp:39-262:
Phong, Eye) and the course's shaders (flat, Gouraud, textured, the
depth-only pass, its grayscale variant and the shadow-mapped Phong).
Two halves:

  * host: the shader classes, ``build_uniforms`` (float64 host math cast
    to the working dtype, as the reference's doubles; the material's
    packed texture cached on the material; ``scene`` uploads the result
    and keeps it while ``uniforms_token`` and the matrices hold still) and
    each class's NumPy ``vertex_np`` / ``fragment_np``, which the NumPy
    oracle (``oracle.py``) runs;
  * device: ``vertex`` and ``fragment`` in PyTorch, dispatched on the
    shader's exact class (a subclass may change the fragment, so it is
    not taken for its base).

Both halves follow the reference's NumPy path formula for formula and in
the same operation order; the device half divides by tensors on the
operand's device (see ``ops.semantics``).
"""

from __future__ import annotations

import numpy as np
import torch

from tinyrenderder_tpu_torch import math3d
from tinyrenderder_tpu_torch.models.mesh import Material
from tinyrenderder_tpu_torch.ops.semantics import apply_mat4

__all__ = ["Shader", "PhongShader", "EyeShader", "FlatShader", "GouraudShader",
           "TexturedShader", "DepthShader", "GrayDepthShader", "ShadowMappedShader",
           "EYE_DIFFUSE_BRIGHTNESS_THRESHOLD", "EYE_SPECULAR_POWER_THRESHOLD",
           "finalize_color_np", "vertex", "fragment", "supports", "sample_diffuse",
           "sample_normal_map", "sample_specular", "sample_emission", "sample_packed",
           "tokens_match", "TOKEN_VALUE_ELEMENTS", "dot3",
           "sqrt_rn", "normalized3", "transform_dir", "finalize_color"]

# Eye-pixel heuristic thresholds (main.cpp:33-34)
EYE_DIFFUSE_BRIGHTNESS_THRESHOLD = 0.85
EYE_SPECULAR_POWER_THRESHOLD = 5.0


def dot3(a, b):
    """(ax*bx + ay*by) + az*bz (geometry.h:122-127), for arrays and tensors."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


# ===========================================================================
# Host half: NumPy, for build_uniforms and the oracle
# ===========================================================================

def _apply_mat4_np(m, v):
    """4x4 matrix times column 4-vector, summed left to right."""
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    return np.stack([((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3] * w
                     for i in range(4)], axis=-1)


def _pad_np(v, w):
    return np.concatenate([v, np.full(v.shape[:-1] + (1,), w, dtype=v.dtype)], axis=-1)


def _transform_dir_np(m, v):
    return _apply_mat4_np(m, _pad_np(v, 0.0))[..., :3]


def _normalized3_np(v):
    length = np.sqrt(dot3(v, v))
    safe = np.where(length == 0, np.ones_like(length), length)
    return np.where((length == 0)[..., None], v, v / safe[..., None])


def _gather_texel_np(tex, u, v):
    """Nearest, clamp-to-edge, truncating index (model.cpp:415-472)."""
    th, tw = tex.shape[0], tex.shape[1]
    xi = np.clip(np.trunc(u * float(tw)).astype(np.int32), 0, tw - 1)
    yi = np.clip(np.trunc(v * float(th)).astype(np.int32), 0, th - 1)
    return tex.reshape(th * tw, -1)[yi * tw + xi]


def _texel_rgb_np(texel, dtype):
    """Zero-filled TGAColor semantics: a grayscale texel lands in blue."""
    if texel.shape[-1] >= 3:
        return texel[..., :3].astype(dtype)
    gray = texel[..., 0].astype(dtype)
    zero = np.zeros_like(gray)
    return np.stack([zero, zero, gray], axis=-1)


def _sample_diffuse_np(tex, u, v):
    if tex is None:
        return np.full(np.shape(u) + (3,), 255.0, dtype=u.dtype)
    return _texel_rgb_np(_gather_texel_np(tex, u, v), u.dtype)


def _sample_normal_map_np(tex, u, v):
    if tex is None:
        shape = np.shape(u)
        return np.concatenate([np.zeros(shape + (2,), dtype=u.dtype),
                               np.ones(shape + (1,), dtype=u.dtype)], axis=-1)
    texel = _texel_rgb_np(_gather_texel_np(tex, u, v), u.dtype)
    return _normalized3_np(texel / 255.0 * 2.0 - 1.0)


def _sample_specular_np(tex, u, v):
    if tex is None:
        return np.ones(np.shape(u), dtype=u.dtype)
    channel = 0 if tex.shape[-1] == 1 else 2
    texel = _gather_texel_np(tex, u, v)[..., channel]
    return (texel.astype(np.float32) / np.float32(255.0)).astype(u.dtype)


def _sample_packed_np(packed, u, v):
    texel = _gather_texel_np(packed, u, v)
    base = texel[..., 0:3].astype(u.dtype)
    nm = _normalized3_np(texel[..., 3:6].astype(u.dtype) / 255.0 * 2.0 - 1.0)
    spec = (texel[..., 6].astype(np.float32) / np.float32(255.0)).astype(u.dtype)
    return base, nm, spec


def finalize_color_np(rgb):
    """Per-channel min(255, v) + truncating uint8 cast (main.cpp:161-167)."""
    return np.trunc(np.minimum(rgb, 255.0)).astype(np.uint8)


def pack_material_textures(material: Material | None) -> np.ndarray | None:
    """Diffuse RGB + normal RGB + the specular byte as one (h, w, 7) uint8
    texture when all three maps share a shape: one gather instead of
    three, decoded to the same values as the individual samplers."""
    m = material
    if m is None or m.diffuse is None or m.normal is None or m.specular is None:
        return None
    d, n, s = m.diffuse, m.normal, m.specular
    if not (d.shape[:2] == n.shape[:2] == s.shape[:2]):
        return None
    if d.shape[-1] < 3 or n.shape[-1] < 3:
        return None     # grayscale maps take the zero-fill samplers
    spec_channel = 0 if s.shape[-1] == 1 else 2   # the specular sampler's choice
    return np.concatenate([d[..., :3], n[..., :3],
                           s[..., spec_channel:spec_channel + 1]], axis=-1).astype(np.uint8)


def _light_dirs_eye(modelview64: np.ndarray, world_dirs: list) -> list:
    """initLightDirections (main.cpp:55-69): world light directions turned
    by the upper 3x3 of the ModelView (model matrix included: the lights
    turn with the model), normalized, in float64."""
    nm = modelview64[:3, :3]
    return [math3d.normalized(nm @ np.asarray(d, dtype=np.float64)) for d in world_dirs]


def _material_textures(material: Material | None) -> dict:
    """A material's texture uniforms, the packed texture cached on the
    material and keyed on the identity of its four source arrays (the key
    keeps them alive, so a recycled id cannot alias): ``build_uniforms``
    runs every frame, and rebinding ``m.diffuse`` and the others rebuilds
    the pack.  Writing INTO a bound texture array is out of contract:
    rebind it to change it."""
    m = material or Material()
    src = (m.diffuse, m.normal, m.specular, m.emission)
    cached = m.__dict__.get("_packed")
    if cached is None or any(a is not b for a, b in zip(cached[0], src)):
        cached = (src, pack_material_textures(m))
        m.__dict__["_packed"] = cached
    return {"tex_diffuse": m.diffuse, "tex_normal": m.normal,
            "tex_specular": m.specular, "tex_emission": m.emission,
            "tex_packed": cached[1]}


#: ndarray attributes below this many elements are a uniforms token's
#: values; the rest (and every other object) its references
TOKEN_VALUE_ELEMENTS = 4096


def tokens_match(a, b) -> bool:
    """Compare two ``Shader.uniforms_token`` snapshots: reference entries
    with ``is`` (a swapped-in equal object misses, never goes stale),
    value entries with ``==``."""
    if a is b:
        return True
    if len(a) != len(b):
        return False
    for ea, eb in zip(a, b):
        if ea[0] != eb[0] or ea[1] != eb[1]:
            return False
        if ea[1] == "ref":
            if ea[2] is not eb[2]:
                return False
        elif ea[2:] != eb[2:]:
            return False
    return True


class Shader:
    """Base shader: the vertex stage shared by Phong and Eye
    (main.cpp:71-90 == main.cpp:199-218)."""

    name = "base"
    #: varying channel counts (the raster's record layout)
    varying_spec: dict[str, int] = {"uv": 2, "position_eye": 3, "normal_eye": 3}
    #: False for depth-only passes: the frame skips varying interpolation
    #: and shading (the z-test precedes shading, our_gl.cpp:165)
    writes_color: bool = True

    def uniforms_token(self) -> tuple:
        """A snapshot of the instance state ``build_uniforms`` reads, for
        the scene's per-pass uniform cache.  An ndarray of fewer than
        ``TOKEN_VALUE_ELEMENTS`` elements is taken by value (shape, dtype,
        bytes), so even a write into it is seen; anything else (a large
        array, a ``torch.Tensor`` such as ``ShadowMappedShader.shadow_map``,
        a float) by reference, compared with ``is`` and kept alive by the
        cache, never copied or moved to the host: rebind such an attribute
        to change it.  Compare tokens with ``tokens_match``."""
        out = []
        for k in sorted(self.__dict__):
            if k.startswith("_"):
                continue                # private caches feed no uniform
            v = self.__dict__[k]
            if isinstance(v, np.ndarray) and v.size < TOKEN_VALUE_ELEMENTS:
                out.append((k, "nd", v.shape, v.dtype.str, v.tobytes()))
            else:
                out.append((k, "ref", v))
        return tuple(out)

    def build_uniforms(self, modelview: np.ndarray, perspective: np.ndarray,
                       material: Material | None, dtype) -> dict:
        u = {
            "modelview": np.asarray(modelview, dtype=np.float64).astype(dtype),
            "perspective": np.asarray(perspective, dtype=np.float64).astype(dtype),
        }
        u.update(_material_textures(material))
        return u

    def vertex_np(self, u, attrs):
        """-> (clip (F, 3, 4), varyings {name: (F, 3, C)}), NumPy."""
        mv = u["modelview"]
        pos_eye4 = _apply_mat4_np(mv, _pad_np(attrs["position"], 1.0))
        normal_eye = _transform_dir_np(mv, attrs["normal"])
        clip = _apply_mat4_np(u["perspective"], pos_eye4)
        return clip, {"uv": attrs["uv"], "position_eye": pos_eye4[..., :3],
                      "normal_eye": normal_eye}

    def fragment_np(self, u, vary):
        """-> (..., 3) RGB floats in 0..255, NumPy; apply ``finalize_color_np``."""
        raise NotImplementedError


class PhongShader(Shader):
    """Per-pixel 3-light Phong with object-space normal mapping
    (main.cpp:39-171), with the eye-pixel heuristic that drops the normal
    map on bright low-specular texels (main.cpp:109-112)."""

    name = "phong"

    KEY_DIFFUSE_INTENSITY = 1.0
    KEY_SPECULAR_INTENSITY = 1.0
    FILL_DIFFUSE_INTENSITY = 0.35
    RIM_DIFFUSE_INTENSITY = 0.6
    AMBIENT = 0.10
    SPECULAR_SCALE = 0.35

    def __init__(self, key_light_world, fill_light_world, rim_light_world,
                 normal_map_strength: float = 1.0):
        self.key_light_world = np.asarray(key_light_world, dtype=np.float64)
        self.fill_light_world = np.asarray(fill_light_world, dtype=np.float64)
        self.rim_light_world = np.asarray(rim_light_world, dtype=np.float64)
        self.normal_map_strength = float(normal_map_strength)

    def build_uniforms(self, modelview, perspective, material, dtype):
        u = super().build_uniforms(modelview, perspective, material, dtype)
        key, fill, rim = _light_dirs_eye(
            np.asarray(modelview, dtype=np.float64),
            [self.key_light_world, self.fill_light_world, self.rim_light_world])
        u["key_light_eye"] = key.astype(dtype)
        u["fill_light_eye"] = fill.astype(dtype)
        u["rim_light_eye"] = rim.astype(dtype)
        return u

    def fragment_np(self, u, vary):
        return self._phong_fragment_np(u, vary)[0]

    def _phong_fragment_np(self, u, vary):
        """-> (rgb, the diffuse sample), so the shadow-mapped subclass
        reuses the texture fetch."""
        pos_eye = vary["position_eye"]
        geom_normal = vary["normal_eye"]
        uu, vv = vary["uv"][..., 0], vary["uv"][..., 1]
        if u["tex_packed"] is not None:
            base, nm, spec_val = _sample_packed_np(u["tex_packed"], uu, vv)
        else:
            base = _sample_diffuse_np(u["tex_diffuse"], uu, vv)
            spec_val = _sample_specular_np(u["tex_specular"], uu, vv)
            nm = _sample_normal_map_np(u["tex_normal"], uu, vv)
        specular_power = np.maximum(np.asarray(1.0, dtype=spec_val.dtype), spec_val)

        brightness = ((base[..., 0] + base[..., 1]) + base[..., 2]) / (3.0 * 255.0)
        is_eye = ((brightness >= EYE_DIFFUSE_BRIGHTNESS_THRESHOLD)
                  & (specular_power <= EYE_SPECULAR_POWER_THRESHOLD))
        nm_eye = _transform_dir_np(u["modelview"], nm)
        s = self.normal_map_strength
        blended = geom_normal * (1.0 - s) + nm_eye * s
        final_normal = np.where(is_eye[..., None], geom_normal, _normalized3_np(blended))
        view_dir = _normalized3_np(-pos_eye)

        key = u["key_light_eye"]
        key_diffuse = np.maximum(0.0, dot3(final_normal, key)) * self.KEY_DIFFUSE_INTENSITY
        reflect_dir = _normalized3_np(
            final_normal * (2.0 * dot3(final_normal, key))[..., None] - key)
        reflect_view = np.maximum(0.0, dot3(reflect_dir, view_dir))
        # the specular exponent max(1, specular(uv)) is always 1
        # (main.cpp:107), and pow(x, 1) == x exactly
        key_specular = np.where(reflect_view > 0.0, reflect_view,
                                np.zeros_like(reflect_view)) * self.KEY_SPECULAR_INTENSITY
        fill_diffuse = (np.maximum(0.0, dot3(final_normal, u["fill_light_eye"]))
                        * self.FILL_DIFFUSE_INTENSITY)
        rim_diffuse = (np.maximum(0.0, dot3(final_normal, u["rim_light_eye"]))
                       * self.RIM_DIFFUSE_INTENSITY)
        total_diffuse = key_diffuse + fill_diffuse + rim_diffuse
        rgb = (base * (self.AMBIENT + total_diffuse)[..., None]
               + 255.0 * (self.SPECULAR_SCALE * key_specular)[..., None])
        return rgb, base


class EyeShader(Shader):
    """Glossy eye material (main.cpp:176-262): normalized interpolated
    normal, key + rim diffuse, specular exponent 8, spec scale 1.5, no
    normal map."""

    name = "eye"

    KEY_DIFFUSE_INTENSITY = 1.0
    RIM_DIFFUSE_INTENSITY = 0.6
    AMBIENT = 0.1
    SPECULAR_SCALE = 1.5

    def __init__(self, key_light_world, rim_light_world):
        self.key_light_world = np.asarray(key_light_world, dtype=np.float64)
        self.rim_light_world = np.asarray(rim_light_world, dtype=np.float64)

    def build_uniforms(self, modelview, perspective, material, dtype):
        u = super().build_uniforms(modelview, perspective, material, dtype)
        key, rim = _light_dirs_eye(np.asarray(modelview, dtype=np.float64),
                                   [self.key_light_world, self.rim_light_world])
        u["key_light_eye"] = key.astype(dtype)
        u["rim_light_eye"] = rim.astype(dtype)
        return u

    def fragment_np(self, u, vary):
        pos_eye = vary["position_eye"]
        normal = _normalized3_np(vary["normal_eye"])      # main.cpp:225-227
        uu, vv = vary["uv"][..., 0], vary["uv"][..., 1]
        if u["tex_packed"] is not None:
            base = _sample_packed_np(u["tex_packed"], uu, vv)[0]
        else:
            base = _sample_diffuse_np(u["tex_diffuse"], uu, vv)
        view_dir = _normalized3_np(-pos_eye)
        key = u["key_light_eye"]
        key_diffuse = np.maximum(0.0, dot3(normal, key)) * self.KEY_DIFFUSE_INTENSITY
        rim_diffuse = (np.maximum(0.0, dot3(normal, u["rim_light_eye"]))
                       * self.RIM_DIFFUSE_INTENSITY)
        total_diffuse = key_diffuse + rim_diffuse
        # the exponent max(1, specular(uv)) * 8 is always 8 (main.cpp:235):
        # three exact squarings
        reflect_dir = _normalized3_np(normal * (2.0 * dot3(normal, key))[..., None] - key)
        reflect_view = np.maximum(0.0, dot3(reflect_dir, view_dir))
        x2 = reflect_view * reflect_view
        x4 = x2 * x2
        specular = x4 * x4
        return (base * (self.AMBIENT + total_diffuse)[..., None]
                + 255.0 * (self.SPECULAR_SCALE * specular)[..., None])


def _face_normal_np(pos):
    """Unnormalized e1 x e2 of each (..., 3, 3) corner triple."""
    e1 = pos[..., 1, :] - pos[..., 0, :]
    e2 = pos[..., 2, :] - pos[..., 0, :]
    return np.stack([e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1],
                     e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2],
                     e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]], axis=-1)


class FlatShader(Shader):
    """Faceted Lambert shading: one eye-space face normal per triangle,
    one directional light."""

    name = "flat"
    varying_spec = {"face_normal_eye": 3}

    def __init__(self, light_world=(0.0, 0.0, 1.0), base_color=(255.0, 255.0, 255.0)):
        self.light_world = np.asarray(light_world, dtype=np.float64)
        self.base_color = np.asarray(base_color, dtype=np.float64)

    def build_uniforms(self, modelview, perspective, material, dtype):
        u = super().build_uniforms(modelview, perspective, material, dtype)
        (u["light_eye"],) = [d.astype(dtype) for d in _light_dirs_eye(
            np.asarray(modelview, dtype=np.float64), [self.light_world])]
        u["base_color"] = self.base_color.astype(dtype)
        return u

    def vertex_np(self, u, attrs):
        clip, _ = super().vertex_np(u, attrs)
        pos = attrs["position"]
        n_eye = _normalized3_np(_transform_dir_np(u["modelview"], _face_normal_np(pos)))
        return clip, {"face_normal_eye": np.broadcast_to(n_eye[..., None, :], pos.shape)}

    def fragment_np(self, u, vary):
        intensity = np.maximum(0.0, dot3(_normalized3_np(vary["face_normal_eye"]),
                                         u["light_eye"]))
        return u["base_color"] * intensity[..., None]


class GouraudShader(Shader):
    """Per-vertex Lambert intensity interpolated across the triangle."""

    name = "gouraud"
    varying_spec = {"intensity": 1}

    def __init__(self, light_world=(0.0, 0.0, 1.0), base_color=(255.0, 255.0, 255.0)):
        self.light_world = np.asarray(light_world, dtype=np.float64)
        self.base_color = np.asarray(base_color, dtype=np.float64)

    def build_uniforms(self, modelview, perspective, material, dtype):
        u = super().build_uniforms(modelview, perspective, material, dtype)
        (u["light_eye"],) = [d.astype(dtype) for d in _light_dirs_eye(
            np.asarray(modelview, dtype=np.float64), [self.light_world])]
        u["base_color"] = self.base_color.astype(dtype)
        return u

    def vertex_np(self, u, attrs):
        clip, vary = super().vertex_np(u, attrs)
        n = _normalized3_np(vary["normal_eye"])
        intensity = np.maximum(0.0, dot3(n, u["light_eye"]))
        return clip, {"intensity": intensity[..., None]}

    def fragment_np(self, u, vary):
        return u["base_color"] * vary["intensity"]


class TexturedShader(GouraudShader):
    """Diffuse texture modulated by the Gouraud intensity."""

    name = "textured"
    varying_spec = {"intensity": 1, "uv": 2}

    def vertex_np(self, u, attrs):
        clip, vary = super().vertex_np(u, attrs)
        vary["uv"] = attrs["uv"]
        return clip, vary

    def fragment_np(self, u, vary):
        uv = vary["uv"]
        base = _sample_diffuse_np(u["tex_diffuse"], uv[..., 0], uv[..., 1])
        return base * vary["intensity"]


class DepthShader(Shader):
    """Depth-only pass (the shadow map's light pass): the frame skips
    varying interpolation and shading (``writes_color`` False); the
    fragment, NDC depth as gray, is what ``GrayDepthShader`` shades."""

    name = "depth"
    varying_spec = {"ndc_z": 1}
    writes_color = False

    def vertex_np(self, u, attrs):
        clip, _ = super().vertex_np(u, attrs)
        w = clip[..., 3]
        safe_w = np.where(w == 0, np.ones_like(w), w)
        return clip, {"ndc_z": (clip[..., 2] / safe_w)[..., None]}

    def fragment_np(self, u, vary):
        v = (vary["ndc_z"][..., 0] * 0.5 + 0.5) * 255.0
        return np.stack([v, v, v], axis=-1)


class GrayDepthShader(DepthShader):
    """DepthShader that shades: NDC depth as grayscale."""

    name = "gray_depth"
    writes_color = True


class ShadowMappedShader(PhongShader):
    """Phong whose lit terms are gated by a shadow-map depth test (the hard
    0.3/1.0 factor of the course's two-pass shadows).  ``shadow_matrix``
    maps this pass's model-space positions to the light pass's screen
    (viewport_l @ persp_l @ view_l); ``shadow_map`` is the light pass's
    (S, S) depth, a NumPy array for the oracle or a tensor on the frame's
    device, which ``build_uniforms`` passes through untouched."""

    name = "shadow_phong"
    varying_spec = {"uv": 2, "position_eye": 3, "normal_eye": 3, "position_model": 3}

    SHADOW_AMBIENT_FACTOR = 0.3
    SHADOW_EPS = 2e-3

    def __init__(self, key_light_world, fill_light_world, rim_light_world,
                 shadow_matrix: np.ndarray, shadow_map, normal_map_strength: float = 1.0):
        super().__init__(key_light_world, fill_light_world, rim_light_world,
                         normal_map_strength)
        self.shadow_matrix = np.asarray(shadow_matrix, dtype=np.float64)
        self.shadow_map = shadow_map

    def build_uniforms(self, modelview, perspective, material, dtype):
        u = super().build_uniforms(modelview, perspective, material, dtype)
        u["shadow_matrix"] = self.shadow_matrix.astype(dtype)
        sm = self.shadow_map
        if isinstance(sm, np.ndarray):      # a device tensor stays where it is
            sm = np.asarray(sm, dtype=dtype)
        u["shadow_map"] = sm
        return u

    def vertex_np(self, u, attrs):
        clip, vary = super().vertex_np(u, attrs)
        vary["position_model"] = attrs["position"]
        return clip, vary

    def shadow_factor_np(self, u, vary):
        sm = u["shadow_map"]
        p4 = _apply_mat4_np(u["shadow_matrix"], _pad_np(vary["position_model"], 1.0))
        w = p4[..., 3]
        safe_w = np.where(w == 0, np.ones_like(w), w)
        sx, sy, sz = p4[..., 0] / safe_w, p4[..., 1] / safe_w, p4[..., 2] / safe_w
        h, wdt = sm.shape
        xi = np.clip(np.trunc(sx).astype(np.int32), 0, wdt - 1)
        yi = np.clip(np.trunc(sy).astype(np.int32), 0, h - 1)
        inside = (sx >= 0) & (sx < wdt) & (sy >= 0) & (sy < h) & (w > 0)
        closest = sm.reshape(h * wdt)[yi * wdt + xi]
        lit = (~inside) | (closest > sz - self.SHADOW_EPS)
        return np.where(lit, np.asarray(1.0, dtype=sx.dtype),
                        np.asarray(self.SHADOW_AMBIENT_FACTOR, dtype=sx.dtype))

    def fragment_np(self, u, vary):
        rgb, base = self._phong_fragment_np(u, vary)
        amb = base * self.AMBIENT
        return amb + (rgb - amb) * self.shadow_factor_np(u, vary)[..., None]


# ===========================================================================
# Device half: PyTorch
# ===========================================================================

_INT32_RANGE = 2.0 ** 31


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d divisor on ``like``'s device and dtype."""
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """Truncated float -> int32 with the oracle's x86 semantics: NaN and
    out-of-range values become INT32_MIN there (cvttss2si), which every
    caller then clamps to 0.  Mapping them to 0 first gives the same
    clamped index on the CPU and on the GPU (whose conversion
    saturates)."""
    ok = torch.abs(x) < _INT32_RANGE              # False for NaN
    return torch.where(ok, x, torch.zeros_like(x)).to(torch.int32)


# ---------------------------------------------------------------------------
# Texture sampling (model.cpp:415-472): nearest, clamp-to-edge, truncation
# ---------------------------------------------------------------------------

def _nearest_index(coord, size: int):
    idx = _to_int32(torch.trunc(coord * float(size)))
    return torch.clamp(idx, 0, size - 1)


def _gather_texel(tex, u, v):
    """tex: (th, tw, c) uint8, rows top-first.  Returns (..., c) uint8."""
    th, tw = tex.shape[0], tex.shape[1]
    xi = _nearest_index(u, tw)
    yi = _nearest_index(v, th)
    return tex.reshape(th * tw, -1)[(yi * tw + xi).long()]


def _texel_rgb(texel, dtype):
    """Zero-filled TGAColor semantics: a grayscale texel lands in blue."""
    if texel.shape[-1] >= 3:
        return texel[..., :3].to(dtype)
    gray = texel[..., 0].to(dtype)
    zero = torch.zeros_like(gray)
    return torch.stack([zero, zero, gray], dim=-1)


def sample_diffuse(tex, u, v):
    if tex is None:
        return torch.full(u.shape + (3,), 255.0, dtype=u.dtype, device=u.device)
    return _texel_rgb(_gather_texel(tex, u, v), u.dtype)


def sample_normal_map(tex, u, v):
    if tex is None:
        n = torch.zeros(u.shape + (3,), dtype=u.dtype, device=u.device)
        n[..., 2] = 1.0
        return n
    texel = _texel_rgb(_gather_texel(tex, u, v), u.dtype)
    return normalized3(texel / _const(255.0, u) * 2.0 - 1.0)


def sample_specular(tex, u, v):
    if tex is None:
        return torch.ones_like(u)
    channel = 0 if tex.shape[-1] == 1 else 2
    texel = _gather_texel(tex, u, v)[..., channel].to(torch.float32)
    return (texel / _const(255.0, texel)).to(u.dtype)


def sample_emission(tex, u, v):
    """RGB in 0..255; black without a map (model.cpp:461-472); a
    grayscale map lands in blue, as every sampler reads it."""
    if tex is None:
        return torch.zeros(u.shape + (3,), dtype=u.dtype, device=u.device)
    return _texel_rgb(_gather_texel(tex, u, v), u.dtype)


def sample_packed(packed, u, v):
    """One 7-channel gather -> (diffuse RGB, raw normal-map vector,
    specular scalar), decoded as the individual samplers do."""
    texel = _gather_texel(packed, u, v)
    base = texel[..., 0:3].to(u.dtype)
    nm = normalized3(texel[..., 3:6].to(u.dtype) / _const(255.0, u) * 2.0 - 1.0)
    spec_f = texel[..., 6].to(torch.float32)
    spec = (spec_f / _const(255.0, spec_f)).to(u.dtype)
    return base, nm, spec


# ---------------------------------------------------------------------------
# Vector helpers with fixed operation order
# ---------------------------------------------------------------------------

def sqrt_rn(x):
    """Correctly rounded float32 square root.  PyTorch's vectorised CPU
    sqrt is not correctly rounded (it differs from NumPy in the last bit);
    a float64 root rounded to float32 is, on every device."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def normalized3(v):
    """Normalize with zero-length passthrough (geometry.h:136-140)."""
    length = sqrt_rn(dot3(v, v))
    zero_len = length == 0
    safe = torch.where(zero_len, torch.ones_like(length), length)
    return torch.where(zero_len[..., None], v, v / safe[..., None])


def _pad(v, w: float):
    return torch.cat([v, torch.full(v.shape[:-1] + (1,), w, dtype=v.dtype,
                                    device=v.device)], dim=-1)


def transform_dir(m, v):
    """ModelView * (v, 0) (main.cpp:83-87); returns xyz."""
    return apply_mat4(m, _pad(v, 0.0))[..., :3]


def finalize_color(rgb):
    """min(255, v) and a truncating unsigned-char cast (main.cpp:161-167),
    through int32 so the CPU and the GPU wrap alike."""
    return torch.trunc(torch.clamp(rgb, max=255.0)).to(torch.int32).to(torch.uint8)


# ---------------------------------------------------------------------------
# vertex / fragment per shader class
# ---------------------------------------------------------------------------

def _base_vertex(shader, u, attrs):
    """Shader.vertex (main.cpp:71-90)."""
    mv = u["modelview"]
    pos_eye4 = apply_mat4(mv, _pad(attrs["position"], 1.0))
    normal_eye = transform_dir(mv, attrs["normal"])
    clip = apply_mat4(u["perspective"], pos_eye4)
    return clip, {"uv": attrs["uv"], "position_eye": pos_eye4[..., :3],
                  "normal_eye": normal_eye}


def _phong_fragment(shader, u, vary):
    return _phong_rgb_base(shader, u, vary)[0]


def _phong_rgb_base(shader, u, vary):
    """PhongShader._phong_fragment (main.cpp:39-171) without the
    transcendental (specular power is always 1, see the reference) ->
    (rgb, the diffuse sample)."""
    pos_eye = vary["position_eye"]
    geom_normal = vary["normal_eye"]
    uu, vv = vary["uv"][..., 0], vary["uv"][..., 1]

    if u["tex_packed"] is not None:
        base, nm, spec_val = sample_packed(u["tex_packed"], uu, vv)
    else:
        base = sample_diffuse(u["tex_diffuse"], uu, vv)
        spec_val = sample_specular(u["tex_specular"], uu, vv)
        nm = sample_normal_map(u["tex_normal"], uu, vv)
    specular_power = torch.clamp(spec_val, min=1.0)

    brightness = ((base[..., 0] + base[..., 1]) + base[..., 2]) / _const(3.0 * 255.0, base)
    is_eye = ((brightness >= EYE_DIFFUSE_BRIGHTNESS_THRESHOLD)
              & (specular_power <= EYE_SPECULAR_POWER_THRESHOLD))

    nm_eye = transform_dir(u["modelview"], nm)
    s = shader.normal_map_strength
    blended = geom_normal * (1.0 - s) + nm_eye * s
    final_normal = torch.where(is_eye[..., None], geom_normal, normalized3(blended))

    view_dir = normalized3(-pos_eye)

    key = u["key_light_eye"]
    key_diffuse = torch.clamp(dot3(final_normal, key), min=0.0) * shader.KEY_DIFFUSE_INTENSITY
    reflect_dir = normalized3(
        final_normal * (2.0 * dot3(final_normal, key))[..., None] - key)
    reflect_view = torch.clamp(dot3(reflect_dir, view_dir), min=0.0)
    key_specular = torch.where(reflect_view > 0.0, reflect_view,
                               torch.zeros_like(reflect_view)) * shader.KEY_SPECULAR_INTENSITY

    fill_diffuse = (torch.clamp(dot3(final_normal, u["fill_light_eye"]), min=0.0)
                    * shader.FILL_DIFFUSE_INTENSITY)
    rim_diffuse = (torch.clamp(dot3(final_normal, u["rim_light_eye"]), min=0.0)
                   * shader.RIM_DIFFUSE_INTENSITY)

    total_diffuse = key_diffuse + fill_diffuse + rim_diffuse
    rgb = (base * (shader.AMBIENT + total_diffuse)[..., None]
           + 255.0 * (shader.SPECULAR_SCALE * key_specular)[..., None])
    return rgb, base


def _eye_fragment(shader, u, vary):
    """EyeShader.fragment (main.cpp:176-262): normalized interpolated
    normal, key and rim diffuse, the ^8 specular as three squarings (the
    exponent is always 8, see the reference), no normal map."""
    pos_eye = vary["position_eye"]
    normal = normalized3(vary["normal_eye"])
    uu, vv = vary["uv"][..., 0], vary["uv"][..., 1]
    if u["tex_packed"] is not None:
        base = sample_packed(u["tex_packed"], uu, vv)[0]
    else:
        base = sample_diffuse(u["tex_diffuse"], uu, vv)
    view_dir = normalized3(-pos_eye)
    key = u["key_light_eye"]

    key_diffuse = torch.clamp(dot3(normal, key), min=0.0) * shader.KEY_DIFFUSE_INTENSITY
    rim_diffuse = (torch.clamp(dot3(normal, u["rim_light_eye"]), min=0.0)
                   * shader.RIM_DIFFUSE_INTENSITY)
    total_diffuse = key_diffuse + rim_diffuse
    reflect_dir = normalized3(normal * (2.0 * dot3(normal, key))[..., None] - key)
    reflect_view = torch.clamp(dot3(reflect_dir, view_dir), min=0.0)
    x2 = reflect_view * reflect_view
    x4 = x2 * x2
    specular = x4 * x4
    return (base * (shader.AMBIENT + total_diffuse)[..., None]
            + 255.0 * (shader.SPECULAR_SCALE * specular)[..., None])


def _gouraud_vertex(shader, u, attrs):
    """GouraudShader.vertex: per-vertex Lambert intensity."""
    clip, vary = _base_vertex(shader, u, attrs)
    n = normalized3(vary["normal_eye"])
    intensity = torch.clamp(dot3(n, u["light_eye"]), min=0.0)
    return clip, {"intensity": intensity[..., None]}


def _gouraud_fragment(shader, u, vary):
    return u["base_color"] * vary["intensity"]


def _textured_vertex(shader, u, attrs):
    clip, vary = _gouraud_vertex(shader, u, attrs)
    vary["uv"] = attrs["uv"]
    return clip, vary


def _textured_fragment(shader, u, vary):
    uv = vary["uv"]
    base = sample_diffuse(u["tex_diffuse"], uv[..., 0], uv[..., 1])
    return base * vary["intensity"]


def _flat_vertex(shader, u, attrs):
    """FlatShader.vertex: the eye-space face normal e1 x e2, normalized,
    at every corner."""
    clip, _ = _base_vertex(shader, u, attrs)
    pos = attrs["position"]
    e1 = pos[..., 1, :] - pos[..., 0, :]
    e2 = pos[..., 2, :] - pos[..., 0, :]
    n = torch.stack([e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1],
                     e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2],
                     e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]], dim=-1)
    n_eye = normalized3(transform_dir(u["modelview"], n))
    return clip, {"face_normal_eye": n_eye[..., None, :].expand(pos.shape)}


def _flat_fragment(shader, u, vary):
    intensity = torch.clamp(dot3(normalized3(vary["face_normal_eye"]), u["light_eye"]),
                            min=0.0)
    return u["base_color"] * intensity[..., None]


def _depth_vertex(shader, u, attrs):
    """DepthShader.vertex: NDC z = clip z / w (w == 0 divides by 1)."""
    clip, _ = _base_vertex(shader, u, attrs)
    w = clip[..., 3]
    safe_w = torch.where(w == 0, torch.ones_like(w), w)
    return clip, {"ndc_z": (clip[..., 2] / safe_w)[..., None]}


def _depth_fragment(shader, u, vary):
    v = (vary["ndc_z"][..., 0] * 0.5 + 0.5) * 255.0
    return torch.stack([v, v, v], dim=-1)


def _shadow_vertex(shader, u, attrs):
    clip, vary = _base_vertex(shader, u, attrs)
    vary["position_model"] = attrs["position"]
    return clip, vary


def _shadow_factor(shader, u, vary):
    """1 where the pixel is lit, SHADOW_AMBIENT_FACTOR where the light
    pass's depth at its light-screen texel is below its own by more than
    SHADOW_EPS (ShadowMappedShader.shadow_factor).  Off the map or behind
    the light (w <= 0) is lit; the texel index is clamped before the
    gather, so it stays on the map whatever the float to int conversion
    of an off-map or NaN coordinate gives."""
    sm = u["shadow_map"]
    p4 = apply_mat4(u["shadow_matrix"], _pad(vary["position_model"], 1.0))
    w = p4[..., 3]
    safe_w = torch.where(w == 0, torch.ones_like(w), w)
    sx, sy, sz = p4[..., 0] / safe_w, p4[..., 1] / safe_w, p4[..., 2] / safe_w
    h, wdt = sm.shape
    xi = torch.clamp(_to_int32(torch.trunc(sx)), 0, wdt - 1)
    yi = torch.clamp(_to_int32(torch.trunc(sy)), 0, h - 1)
    inside = (sx >= 0) & (sx < wdt) & (sy >= 0) & (sy < h) & (w > 0)
    closest = sm.reshape(h * wdt)[(yi * wdt + xi).long()]
    lit = (~inside) | (closest > sz - _const(shader.SHADOW_EPS, sz))
    return torch.where(lit, _const(1.0, sx), _const(shader.SHADOW_AMBIENT_FACTOR, sx))


def _shadow_fragment(shader, u, vary):
    """Phong with everything but the ambient term gated by the shadow
    factor, reusing the Phong stage's diffuse sample."""
    rgb, base = _phong_rgb_base(shader, u, vary)
    amb = base * shader.AMBIENT
    return amb + (rgb - amb) * _shadow_factor(shader, u, vary)[..., None]


#: exact shader class -> (vertex, fragment)
_STAGES = {
    PhongShader: (_base_vertex, _phong_fragment),
    EyeShader: (_base_vertex, _eye_fragment),
    FlatShader: (_flat_vertex, _flat_fragment),
    GouraudShader: (_gouraud_vertex, _gouraud_fragment),
    TexturedShader: (_textured_vertex, _textured_fragment),
    DepthShader: (_depth_vertex, _depth_fragment),
    GrayDepthShader: (_depth_vertex, _depth_fragment),
    ShadowMappedShader: (_shadow_vertex, _shadow_fragment),
}


def supports(shader) -> bool:
    return type(shader) in _STAGES


def _stages(shader):
    stages = _STAGES.get(type(shader))
    if stages is None:
        raise NotImplementedError(
            f"{type(shader).__name__} has no device half in the port (it has "
            f"{', '.join(c.__name__ for c in _STAGES)})")
    return stages


def vertex(shader, u: dict, attrs: dict):
    """-> (clip (F, 3, 4), varyings {name: (F, 3, C)})."""
    return _stages(shader)[0](shader, u, attrs)


def fragment(shader, u: dict, vary: dict):
    """-> (..., 3) RGB floats in 0..255; apply ``finalize_color``."""
    return _stages(shader)[1](shader, u, vary)
