"""Device halves of the shaders in PyTorch.

The shader objects stay the JAX package's (``tinyrenderder_tpu.shaders``):
their ``build_uniforms`` runs host-side in NumPy and ``convert`` carries
the result across.  This module supplies what ran on the device —
``vertex`` and ``fragment`` — for the ported shaders (Phong, Eye,
Gouraud, Textured), dispatched on the shader's exact class (a subclass such as
``ShadowMappedShader`` changes the fragment, so it is not taken for its
base).  Formulas and operation order follow the reference's
``xp=numpy`` path; divisors are tensors on the operand's device (see
``ops.semantics``).
"""

from __future__ import annotations

import torch

from tinyrenderder_tpu import shaders as ref
from tinyrenderder_tpu_torch.ops.semantics import apply_mat4

__all__ = ["vertex", "fragment", "supports", "sample_diffuse",
           "sample_normal_map", "sample_specular", "sample_packed", "dot3",
           "sqrt_rn", "normalized3", "transform_dir", "finalize_color"]

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

def dot3(a, b):
    """(ax*bx + ay*by) + az*bz (geometry.h:122-127)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


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
    """PhongShader._phong_fragment (main.cpp:39-171) without the
    transcendental: specular power is always 1 (see the reference)."""
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
    is_eye = ((brightness >= ref.EYE_DIFFUSE_BRIGHTNESS_THRESHOLD)
              & (specular_power <= ref.EYE_SPECULAR_POWER_THRESHOLD))

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
    return (base * (shader.AMBIENT + total_diffuse)[..., None]
            + 255.0 * (shader.SPECULAR_SCALE * key_specular)[..., None])


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


#: exact shader class -> (vertex, fragment)
_STAGES = {
    ref.PhongShader: (_base_vertex, _phong_fragment),
    ref.EyeShader: (_base_vertex, _eye_fragment),
    ref.GouraudShader: (_gouraud_vertex, _gouraud_fragment),
    ref.TexturedShader: (_textured_vertex, _textured_fragment),
}


def supports(shader) -> bool:
    return type(shader) in _STAGES


def _stages(shader):
    stages = _STAGES.get(type(shader))
    if stages is None:
        raise NotImplementedError(
            f"{type(shader).__name__} has no torch port yet (the slice ports "
            f"{', '.join(c.__name__ for c in _STAGES)}; see ROADMAP.md Queue 1)")
    return stages


def vertex(shader, u: dict, attrs: dict):
    """-> (clip (F, 3, 4), varyings {name: (F, 3, C)})."""
    return _stages(shader)[0](shader, u, attrs)


def fragment(shader, u: dict, vary: dict):
    """-> (..., 3) RGB floats in 0..255; apply ``finalize_color``."""
    return _stages(shader)[1](shader, u, vary)
