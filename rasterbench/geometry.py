"""Host-side geometry of the yardstick, in float64 NumPy.

Frozen copies, taken at commit 6e89d3a91fb6a69bf8fbc13207f16929040733f9:

  * ``normalized``, ``cross``, ``lookat``, ``perspective``, ``viewport``,
    ``transform_point``, ``AABB`` and ``Frustum`` from
    ``tinyrenderder_tpu_torch/math3d.py``;
  * ``generate_normals`` from ``Mesh.generate_normals_if_needed`` and
    ``local_aabb`` from ``Mesh.compute_aabb`` in
    ``tinyrenderder_tpu_torch/models/mesh.py``;
  * ``light_dirs_eye`` from ``_light_dirs_eye`` in
    ``tinyrenderder_tpu_torch/shaders.py``.

The operation order is the originals', so the host numbers the reference
derives (matrices, normals, light directions, the cull decision) are
those the program derives from the same inputs.  Later changes to the
program's copies do not move these.
"""

from __future__ import annotations

import math

import numpy as np


def norm(v: np.ndarray) -> float:
    return float(math.sqrt(float(np.dot(v, v))))


def normalized(v: np.ndarray) -> np.ndarray:
    """Zero vectors pass through unchanged."""
    length = norm(v)
    if length == 0.0:
        return np.array(v, dtype=np.float64)
    return np.asarray(v, dtype=np.float64) / length


def cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.array([a[1] * b[2] - a[2] * b[1],
                     a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]], dtype=np.float64)


def lookat(eye, target, up) -> np.ndarray:
    """Right-handed look-at view matrix (camera.h:192-205)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)
    z_axis = normalized(eye - target)
    x_axis = normalized(cross(up, z_axis))
    y_axis = cross(z_axis, x_axis)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = x_axis
    m[1, :3] = y_axis
    m[2, :3] = z_axis
    m[0, 3] = -float(np.dot(x_axis, eye))
    m[1, 3] = -float(np.dot(y_axis, eye))
    m[2, 3] = -float(np.dot(z_axis, eye))
    return m


def perspective(fov_deg: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """OpenGL-style projection, NDC z in [-1, 1] (camera.h:207-218)."""
    fov_rad = fov_deg * math.pi / 180.0
    tan_half = math.tan(fov_rad / 2.0)
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = (2.0 * zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    m[3, 3] = 0.0
    return m


def viewport(x: int, y: int, w: int, h: int) -> np.ndarray:
    """x, y to screen (our_gl.cpp:59-69); z passes through."""
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = w / 2.0
    m[1, 1] = h / 2.0
    m[0, 3] = x + w / 2.0
    m[1, 3] = y + h / 2.0
    return m


def transform_point(m: np.ndarray, p) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    v = m @ np.array([p[0], p[1], p[2], 1.0])
    return v[:3] / v[3]


class AABB:
    """Axis-aligned box (geometry.h:270-327)."""

    def __init__(self, lo, hi):
        self.min = np.asarray(lo, dtype=np.float64).copy()
        self.max = np.asarray(hi, dtype=np.float64).copy()

    def transform(self, matrix: np.ndarray) -> "AABB":
        """The 8 corners transformed with the w-divide, re-boxed."""
        new_min = np.full(3, 1e9)
        new_max = np.full(3, -1e9)
        for z in (self.min[2], self.max[2]):
            for y in (self.min[1], self.max[1]):
                for x in (self.min[0], self.max[0]):
                    p = transform_point(matrix, (x, y, z))
                    new_min = np.minimum(new_min, p)
                    new_max = np.maximum(new_max, p)
        return AABB(new_min, new_max)


def local_aabb(positions: np.ndarray) -> AABB:
    """The mesh's box with a 1% symmetric margin (model.cpp:15-40)."""
    points = np.asarray(positions, dtype=np.float64)
    if points.size == 0:
        return AABB(np.zeros(3), np.zeros(3))
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    margin = (hi - lo) * 0.01
    return AABB(lo - margin, hi + margin)


class Frustum:
    """Six planes from a view-projection matrix (Gribb-Hartmann rows)."""

    def __init__(self, matrix: np.ndarray):
        m = np.asarray(matrix, dtype=np.float64)
        row3 = m[3, :]
        self.planes = []
        for axis, sign in ((0, +1), (0, -1), (1, +1), (1, -1), (2, +1), (2, -1)):
            v = row3 + sign * m[axis, :]
            n, d = v[:3].copy(), float(v[3])
            length = norm(n)
            if length > 0.0:
                n /= length
                d /= length
            self.planes.append((n, d))

    def intersects(self, box: AABB) -> bool:
        """Positive-vertex test (our_gl.cpp:264-280)."""
        for n, d in self.planes:
            positive = np.where(n >= 0, box.max, box.min)
            if float(np.dot(n, np.asarray(positive, dtype=np.float64))) + d < 0:
                return False
        return True


def _row_norms(v: np.ndarray) -> np.ndarray:
    return np.sqrt((v * v).sum(axis=-1))


def generate_normals(positions: np.ndarray, faces: np.ndarray,
                     normals: np.ndarray | None) -> np.ndarray:
    """Area-weighted vertex normals (model.cpp:269-316) for the vertices
    whose normal is shorter than 0.001 (all of them when ``normals`` is
    None); authored normals are kept."""
    p = np.asarray(positions, dtype=np.float64)
    given = np.zeros_like(p) if normals is None else np.asarray(normals, dtype=np.float64)
    missing = _row_norms(given) < 0.001
    if p.shape[0] == 0 or not missing.any():
        return given
    out = np.zeros_like(p)
    f = np.asarray(faces, dtype=np.int32)
    e1 = p[f[:, 1]] - p[f[:, 0]]
    e2 = p[f[:, 2]] - p[f[:, 0]]
    face_n = np.cross(e1, e2)
    for k in range(3):
        np.add.at(out, f[:, k], face_n)
    lens = _row_norms(out)
    ok = lens > 0.001
    out[ok] /= lens[ok, None]
    out[~ok] = (0.0, 0.0, 1.0)
    return np.where(missing[:, None], out, given)


def light_dirs_eye(modelview64: np.ndarray, world_dirs: list) -> list:
    """World light directions turned by the ModelView's upper 3x3 and
    normalized (main.cpp:55-69)."""
    nm = modelview64[:3, :3]
    return [normalized(nm @ np.asarray(d, dtype=np.float64)) for d in world_dirs]


def rotation_y(angle_rad: float) -> np.ndarray:
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], dtype=np.float64)


def model_matrix(scale: float = 1.0, translate=(0.0, 0.0, 0.0)) -> np.ndarray:
    """T(translate) @ S(scale), float64."""
    m = np.eye(4, dtype=np.float64)
    m[0, 0] = m[1, 1] = m[2, 2] = float(scale)
    m[:3, 3] = np.asarray(translate, dtype=np.float64)
    return m
