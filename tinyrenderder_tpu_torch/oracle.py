"""NumPy oracle: the serial reference rasterizer, the bitwise anchor of
the port.

Counterpart of ``tinyrenderder_tpu/oracle.py``: the reference's
``rasterize()`` control flow (our_gl.cpp:89-201) one triangle at a time
in submission order — whole-triangle rejects, per-pixel affine
barycentric coverage (the NaN-tolerant ``not (b < 0)``), affine z, the
z-test before shading with strict less-than, perspective-correct
interpolation, shade, depth and colour write — with exact counters
(overdraw included, our_gl.cpp:194).  A shader's ``vertex_np`` and
``fragment_np`` shade; a depth-only pass (``writes_color`` False) writes
depth and counts, and shades nothing.

This module imports no torch: the decision formulas below are its own
NumPy copies of ``ops/semantics.py`` (same operation order), so a check
against it on the card is independent of the port's PyTorch code.  Run
with dtype=float32 for the bitwise reference of the port's frames.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tinyrenderder_tpu_torch import math3d
from tinyrenderder_tpu_torch.utils.stats import RenderStats

__all__ = ["OraclePass", "OracleFrame", "render_pass", "render_passes"]

W_EPS = 1e-12       # w <= W_EPS -> reject triangle (our_gl.cpp:94)
DEGEN_EPS = 1e-12   # |cross.z| < DEGEN_EPS -> degenerate barycentric (:82)
DENOM_EPS = 1e-15   # |persp denom| < DENOM_EPS -> affine barycentrics (:177)


# ---------------------------------------------------------------------------
# the decision formulas (NumPy copies of ops/semantics.py)
# ---------------------------------------------------------------------------

def _apply_mat4(m, v):
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    return np.stack([((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3] * w
                     for i in range(4)], axis=-1)


def barycentric(ax, ay, bx, by, cx, cy, px, py):
    """our_gl.cpp:77-86; degenerate (|u.z| < 1e-12) gives (-1, 1, 1)."""
    s0x = cx - ax
    s0y = bx - ax
    s0z = ax - px
    s1x = cy - ay
    s1y = by - ay
    s1z = ay - py
    ux = s0y * s1z - s0z * s1y
    uy = s0z * s1x - s0x * s1z
    uz = s0x * s1y - s0y * s1x
    degen = np.abs(uz) < DEGEN_EPS
    safe_uz = np.where(degen, np.ones_like(uz), uz)
    b0 = 1.0 - (ux + uy) / safe_uz
    b1 = uy / safe_uz
    b2 = ux / safe_uz
    neg1 = np.asarray(-1.0, dtype=b0.dtype)
    pos1 = np.asarray(1.0, dtype=b0.dtype)
    return (np.where(degen, neg1, b0), np.where(degen, pos1, b1),
            np.where(degen, pos1, b2), degen)


def coverage_mask(b0, b1, b2):
    """``not (b < 0)`` per coordinate (our_gl.cpp:150-153)."""
    return ~((b0 < 0) | (b1 < 0) | (b2 < 0))


def interp3(v0, v1, v2, b0, b1, b2):
    """v0*b0 + v1*b1 + v2*b2, left to right (main.cpp:94-104)."""
    return v0 * b0 + v1 * b1 + v2 * b2


def affine_z(z0, z1, z2, b0, b1, b2):
    """NDC depth with affine barycentrics (our_gl.cpp:156-158)."""
    return b0 * z0 + b1 * z1 + b2 * z2


def perspective_correct_bary(b0, b1, b2, w0, w1, w2):
    """our_gl.cpp:168-185: inv_w = |w| > 1e-12 ? 1/w : 0; |denom| < 1e-15
    falls back to the affine barycentrics."""
    one = np.asarray(1.0, dtype=b0.dtype)
    zero = np.zeros_like(b0)

    def inv(w):
        w = w + zero
        bad = np.abs(w) <= W_EPS
        return np.where(bad, np.zeros_like(w), one / np.where(bad, one, w))

    iw0, iw1, iw2 = inv(w0), inv(w1), inv(w2)
    denom = b0 * iw0 + b1 * iw1 + b2 * iw2
    fallback = np.abs(denom) < DENOM_EPS
    safe = np.where(fallback, one, denom)
    return (np.where(fallback, b0, (b0 * iw0) / safe),
            np.where(fallback, b1, (b1 * iw1) / safe),
            np.where(fallback, b2, (b2 * iw2) / safe))


def triangle_setup_planes(clip, viewport_mat, width, height):
    """Whole-triangle rejects, NDC, screen xy and clamped bbox
    (our_gl.cpp:89-135) -> dict valid, screen, ndc_z, clip_w, bbox
    (min_x, max_x, min_y, max_y) int32."""
    w = clip[..., 3]
    w_ok = np.all(w > W_EPS, axis=-1)
    safe_w = np.where(w == 0, np.ones_like(w), w)
    ndc = clip / safe_w[..., None]
    z = ndc[..., 2]
    z_ok = ~np.all((z < -1.0) | (z > 1.0), axis=-1)
    finite_ok = np.all(np.isfinite(ndc), axis=(-2, -1))
    ndc = np.where(np.isfinite(ndc), ndc, np.zeros_like(ndc))

    screen4 = _apply_mat4(viewport_mat, ndc)
    sx = screen4[..., 0]
    sy = screen4[..., 1]
    e1x = sx[..., 1] - sx[..., 0]
    e1y = sy[..., 1] - sy[..., 0]
    e2x = sx[..., 2] - sx[..., 0]
    e2y = sy[..., 2] - sy[..., 0]
    facing_ok = (e1x * e2y - e1y * e2x) > 0

    big = 2**30
    min_x = np.maximum(0, np.clip(np.floor(np.min(sx, axis=-1)), -big, big).astype(np.int32))
    max_x = np.minimum(width - 1,
                       np.clip(np.ceil(np.max(sx, axis=-1)), -big, big).astype(np.int32))
    min_y = np.maximum(0, np.clip(np.floor(np.min(sy, axis=-1)), -big, big).astype(np.int32))
    max_y = np.minimum(height - 1,
                       np.clip(np.ceil(np.max(sy, axis=-1)), -big, big).astype(np.int32))
    bbox_ok = (min_x <= max_x) & (min_y <= max_y)
    return {
        "valid": w_ok & z_ok & finite_ok & facing_ok & bbox_ok,
        "screen": np.stack([sx, sy], axis=-1),
        "ndc_z": z,
        "clip_w": w,
        "bbox": np.stack([min_x, max_x, min_y, max_y], axis=-1),
    }


def _finalize_color(rgb):
    """min(255, v) + truncating uint8 cast (main.cpp:161-167)."""
    return np.trunc(np.minimum(rgb, 255.0)).astype(np.uint8)


# ---------------------------------------------------------------------------
# the serial frame
# ---------------------------------------------------------------------------

@dataclass
class OraclePass:
    """One mesh + shader submission (a main.cpp:647-668 render block)."""

    attrs: dict                      # {name: (F, 3, C)} face-corner attributes
    shader: object                   # a shaders.Shader
    uniforms: dict                   # from shader.build_uniforms(..., dtype)


@dataclass
class OracleFrame:
    color: np.ndarray                # (H, W, 3) uint8 RGB
    zbuffer: np.ndarray              # (H, W) dtype, +inf where empty
    stats: RenderStats = field(default_factory=RenderStats)


def render_pass(frame: OracleFrame, p: OraclePass, width: int, height: int,
                dtype=np.float64) -> None:
    """Rasterize every face of one pass into the frame, in order."""
    attrs = {k: np.asarray(v, dtype=dtype) for k, v in p.attrs.items()}
    uniforms = dict(p.uniforms)
    clip, varyings = p.shader.vertex_np(uniforms, attrs)
    clip = np.asarray(clip, dtype=dtype)
    vp = math3d.viewport(0, 0, width, height).astype(dtype)
    setup = triangle_setup_planes(clip, vp, width, height)

    nfaces = clip.shape[0]
    st = frame.stats
    st.triangles_rasterized += nfaces
    zbuf = frame.zbuffer
    color = frame.color

    for f in range(nfaces):
        if not bool(setup["valid"][f]):
            continue
        min_x, max_x, min_y, max_y = (int(v) for v in setup["bbox"][f])
        st.merge_bbox(min_x, min_y, max_x, max_y)

        screen = setup["screen"][f]          # (3, 2)
        ndc_z = setup["ndc_z"][f]            # (3,)
        w = setup["clip_w"][f]               # (3,)
        xs = np.arange(min_x, max_x + 1)
        ys = np.arange(min_y, max_y + 1)
        px = (xs.astype(dtype) + dtype(0.5))[None, :]   # (1, W')
        py = (ys.astype(dtype) + dtype(0.5))[:, None]   # (H', 1)

        b0, b1, b2, _ = barycentric(screen[0, 0], screen[0, 1], screen[1, 0],
                                    screen[1, 1], screen[2, 0], screen[2, 1], px, py)
        covered = coverage_mask(b0, b1, b2)
        z = affine_z(ndc_z[0], ndc_z[1], ndc_z[2], b0, b1, b2)
        covered &= np.isfinite(z)

        tile = zbuf[min_y:max_y + 1, min_x:max_x + 1]
        mask = covered & (z < tile)          # strict less: first drawn wins
        if not mask.any():
            continue
        midx = np.nonzero(mask)
        zwin = z[midx]
        if not p.shader.writes_color:        # a depth-only pass shades nothing
            tile[midx] = zwin
            st.fragments_drawn += int(mask.sum())
            st.merge_z(float(zwin.min()), float(zwin.max()))
            continue
        pb0, pb1, pb2 = perspective_correct_bary(b0, b1, b2, w[0], w[1], w[2])
        vary_pix = {}
        for name, vv in varyings.items():
            v0, v1, v2 = (np.asarray(vv[f, k], dtype=dtype) for k in range(3))
            vary_pix[name] = interp3(v0[None, :], v1[None, :], v2[None, :],
                                     pb0[midx][:, None], pb1[midx][:, None],
                                     pb2[midx][:, None])
        out = _finalize_color(p.shader.fragment_np(uniforms, vary_pix))
        tile[midx] = zwin
        color[min_y:max_y + 1, min_x:max_x + 1][midx] = out
        st.fragments_drawn += int(mask.sum())
        st.merge_z(float(zwin.min()), float(zwin.max()))


def render_passes(passes: list[OraclePass], width: int, height: int,
                  dtype=np.float64, frame: OracleFrame | None = None) -> OracleFrame:
    """Render a list of passes into one frame (fresh unless given)."""
    if frame is None:
        frame = OracleFrame(color=np.zeros((height, width, 3), dtype=np.uint8),
                            zbuffer=np.full((height, width), np.inf, dtype=dtype))
    for p in passes:
        render_pass(frame, p, width, height, dtype=dtype)
    return frame
