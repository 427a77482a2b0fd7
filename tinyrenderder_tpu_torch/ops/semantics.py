"""Exact rasterization semantics in PyTorch.

Counterpart of ``tinyrenderder_tpu/ops/semantics.py`` with the same
formulas in the same operation order (the C++ left-to-right association
of our_gl.cpp), so every discontinuous decision — coverage sign,
z-compare, back-face sign, bbox rounding — comes out bitwise as in the
NumPy oracle.  Two rules keep it so on the GPU:

  * every product and sum is its own eager op: no ``torch.compile`` and
    no ``torch.matmul`` (which reorders sums and may use TF32);
  * every division is tensor by tensor on one device.  PyTorch's CUDA
    division by a Python float (a CPU scalar) multiplies by the
    reciprocal instead, which rounds differently.

All functions broadcast over leading dimensions.
"""

from __future__ import annotations

import torch

__all__ = [
    "apply_mat4", "barycentric", "coverage_mask", "interp3", "affine_z",
    "perspective_correct_bary", "triangle_setup_planes",
    "W_EPS", "DEGEN_EPS", "DENOM_EPS",
]

# Thresholds exactly as in the reference (our_gl.cpp:94, :82, :177)
W_EPS = 1e-12       # w <= W_EPS -> reject triangle
DEGEN_EPS = 1e-12   # |cross.z| < DEGEN_EPS -> degenerate barycentric
DENOM_EPS = 1e-15   # |persp denom| < DENOM_EPS -> fall back to affine bary


def apply_mat4(m, v):
    """4x4 matrix times column 4-vector, summed left to right:
    r_i = ((m[i,0]*x + m[i,1]*y) + m[i,2]*z) + m[i,3]*w.
    v: (..., 4); m: (4, 4) on v's device.  Returns (..., 4)."""
    x, y, z, w = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    rows = [((m[i, 0] * x + m[i, 1] * y) + m[i, 2] * z) + m[i, 3] * w
            for i in range(4)]
    return torch.stack(rows, dim=-1)


def barycentric(ax, ay, bx, by, cx, cy, px, py):
    """Affine barycentrics of P in (A, B, C) with the operation order of
    our_gl.cpp:77-86; degenerate (|u.z| < 1e-12) gives (-1, 1, 1).
    Returns (b0, b1, b2, degenerate_mask)."""
    s0x = cx - ax
    s0y = bx - ax
    s0z = ax - px
    s1x = cy - ay
    s1y = by - ay
    s1z = ay - py
    ux = s0y * s1z - s0z * s1y
    uy = s0z * s1x - s0x * s1z
    uz = s0x * s1y - s0y * s1x
    degen = torch.abs(uz) < DEGEN_EPS
    safe_uz = torch.where(degen, torch.ones_like(uz), uz)
    b0 = 1.0 - (ux + uy) / safe_uz
    b1 = uy / safe_uz
    b2 = ux / safe_uz
    b0 = torch.where(degen, -1.0, b0)
    b1 = torch.where(degen, 1.0, b1)
    b2 = torch.where(degen, 1.0, b2)
    return b0, b1, b2, degen


def coverage_mask(b0, b1, b2):
    """NaN-tolerant inside test ``not (b < 0)`` (our_gl.cpp:150-153)."""
    return ~((b0 < 0) | (b1 < 0) | (b2 < 0))


def interp3(v0, v1, v2, b0, b1, b2):
    """v0*b0 + v1*b1 + v2*b2, summed left to right (main.cpp:94-104)."""
    return v0 * b0 + v1 * b1 + v2 * b2


def affine_z(z0, z1, z2, b0, b1, b2):
    """NDC depth with affine barycentrics (our_gl.cpp:156-158)."""
    return b0 * z0 + b1 * z1 + b2 * z2


def perspective_correct_bary(b0, b1, b2, w0, w1, w2):
    """Perspective-correct barycentrics (our_gl.cpp:168-185):
    inv_w = |w| > 1e-12 ? 1/w : 0; |denom| < 1e-15 falls back to the
    affine barycentrics.  Returns (p0, p1, p2)."""
    one = torch.ones_like(b0)
    zero = torch.zeros_like(b0)

    def inv(w):
        w = w + zero                     # per-triangle scalar -> pixel shape
        bad = torch.abs(w) <= W_EPS
        return torch.where(bad, zero, one / torch.where(bad, one, w))

    iw0, iw1, iw2 = inv(w0), inv(w1), inv(w2)
    denom = b0 * iw0 + b1 * iw1 + b2 * iw2
    fallback = torch.abs(denom) < DENOM_EPS
    safe = torch.where(fallback, one, denom)
    p0 = torch.where(fallback, b0, (b0 * iw0) / safe)
    p1 = torch.where(fallback, b1, (b1 * iw1) / safe)
    p2 = torch.where(fallback, b2, (b2 * iw2) / safe)
    return p0, p1, p2


def triangle_setup_planes(clip, viewport_mat, width: int, height: int) -> dict:
    """Whole-triangle rejects, NDC, screen xy and clamped bbox
    (our_gl.cpp:89-135).  ``clip``: (..., 3, 4); ``viewport_mat``: (4, 4)
    of clip's dtype and device.  Returns valid (bool), screen (..., 3, 2),
    ndc_z (..., 3), clip_w (..., 3), bbox (..., 4) int32 as
    (min_x, max_x, min_y, max_y)."""
    w = clip[..., 3]
    w_ok = (w > W_EPS).all(dim=-1)

    safe_w = torch.where(w == 0, torch.ones_like(w), w)
    ndc = clip / safe_w[..., None]

    z = ndc[..., 2]
    z_out = (z < -1.0) | (z > 1.0)
    z_ok = ~z_out.all(dim=-1)

    finite = torch.isfinite(ndc)
    finite_ok = finite.flatten(-2).all(dim=-1)
    # rejected anyway; zeroed so no NaN/Inf reaches the float->int casts
    ndc = torch.where(finite, ndc, torch.zeros_like(ndc))

    screen4 = apply_mat4(viewport_mat, ndc)
    sx = screen4[..., 0]
    sy = screen4[..., 1]

    e1x = sx[..., 1] - sx[..., 0]
    e1y = sy[..., 1] - sy[..., 0]
    e2x = sx[..., 2] - sx[..., 0]
    e2y = sy[..., 2] - sy[..., 0]
    cross = e1x * e2y - e1y * e2x
    facing_ok = cross > 0

    big = 2 ** 30

    def to_int(v):
        return torch.clamp(v, -big, big).to(torch.int32)

    min_x = torch.clamp(to_int(torch.floor(sx.amin(dim=-1))), min=0)
    max_x = torch.clamp(to_int(torch.ceil(sx.amax(dim=-1))), max=width - 1)
    min_y = torch.clamp(to_int(torch.floor(sy.amin(dim=-1))), min=0)
    max_y = torch.clamp(to_int(torch.ceil(sy.amax(dim=-1))), max=height - 1)
    bbox_ok = (min_x <= max_x) & (min_y <= max_y)

    valid = w_ok & z_ok & finite_ok & facing_ok & bbox_ok
    return {
        "valid": valid,
        "screen": torch.stack([sx, sy], dim=-1),
        "ndc_z": z,
        "clip_w": w,
        "bbox": torch.stack([min_x, max_x, min_y, max_y], dim=-1),
    }
