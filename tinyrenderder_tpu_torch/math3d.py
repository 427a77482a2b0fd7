"""Host-side 3D math: vectors, matrices, transforms, culling primitives.

Counterpart of ``tinyrenderder_tpu/math3d.py``, the parts the port uses:
the reference's ``geometry.h`` vectors, Plane and AABB, the transform
builders of ``our_gl.cpp:25-69`` / ``camera.h:192-218``, the model-matrix
constructors of ``main.cpp:365-420`` and the frustum extraction of
``our_gl.cpp:212-280``.  Float64 NumPy, like the reference's doubles;
matrices are (4, 4) arrays acting on column vectors (``M @ v``) and are
cast to float32 where the passes are built.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = [
    "vec2", "vec3", "vec4", "normalized", "cross", "norm", "identity4", "lookat",
    "perspective", "viewport", "scale_matrix", "translation_matrix", "rotation_x",
    "rotation_y", "rotation_z", "transform_point", "transform_dir", "print_vec3",
    "print_mat4", "Plane", "AABB", "Frustum",
]


def vec2(x: float, y: float) -> np.ndarray:
    return np.array([x, y], dtype=np.float64)


def vec3(x: float, y: float, z: float) -> np.ndarray:
    return np.array([x, y, z], dtype=np.float64)


def vec4(x: float, y: float, z: float, w: float) -> np.ndarray:
    return np.array([x, y, z, w], dtype=np.float64)


def norm(v: np.ndarray) -> float:
    """Euclidean norm (geometry.h:130-133)."""
    return float(math.sqrt(float(np.dot(v, v))))


def normalized(v: np.ndarray) -> np.ndarray:
    """Normalize; zero vectors pass through unchanged (geometry.h:136-140)."""
    length = norm(v)
    if length == 0.0:
        return np.array(v, dtype=np.float64)
    return np.asarray(v, dtype=np.float64) / length


def cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """3D cross product (geometry.h:143-149)."""
    return np.array([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ], dtype=np.float64)


def identity4() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def lookat(eye, target, up) -> np.ndarray:
    """Right-handed look-at view matrix (camera.h:192-205): z =
    norm(eye-target), x = norm(up x z), y = z x x, translation =
    -dot(axis, eye)."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    up = np.asarray(up, dtype=np.float64)

    z_axis = normalized(eye - target)
    x_axis = normalized(cross(up, z_axis))
    y_axis = cross(z_axis, x_axis)

    m = identity4()
    m[0, :3] = x_axis
    m[1, :3] = y_axis
    m[2, :3] = z_axis
    m[0, 3] = -float(np.dot(x_axis, eye))
    m[1, 3] = -float(np.dot(y_axis, eye))
    m[2, 3] = -float(np.dot(z_axis, eye))
    return m


def perspective(fov_deg: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """OpenGL-style perspective projection, NDC z in [-1, 1]
    (camera.h:207-218)."""
    fov_rad = fov_deg * math.pi / 180.0
    tan_half = math.tan(fov_rad / 2.0)
    m = identity4()
    m[0, 0] = 1.0 / (aspect * tan_half)
    m[1, 1] = 1.0 / tan_half
    m[2, 2] = (zfar + znear) / (znear - zfar)
    m[2, 3] = (2.0 * zfar * znear) / (znear - zfar)
    m[3, 2] = -1.0
    m[3, 3] = 0.0
    return m


def viewport(x: int, y: int, w: int, h: int) -> np.ndarray:
    """Screen-space viewport transform for x, y only (our_gl.cpp:59-69);
    z passes through unchanged, so depth stays in NDC."""
    m = identity4()
    m[0, 0] = w / 2.0
    m[1, 1] = h / 2.0
    m[0, 3] = x + w / 2.0
    m[1, 3] = y + h / 2.0
    return m


def scale_matrix(sx: float, sy: float, sz: float) -> np.ndarray:
    """main.cpp:365-371."""
    m = identity4()
    m[0, 0], m[1, 1], m[2, 2] = sx, sy, sz
    return m


def translation_matrix(tx: float, ty: float, tz: float) -> np.ndarray:
    """main.cpp:374-380."""
    m = identity4()
    m[0, 3], m[1, 3], m[2, 3] = tx, ty, tz
    return m


def rotation_x(angle_rad: float) -> np.ndarray:
    """main.cpp:382-392."""
    m = identity4()
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rotation_y(angle_rad: float) -> np.ndarray:
    """main.cpp:408-420."""
    m = identity4()
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    m[0, 0], m[0, 2] = c, s
    m[2, 0], m[2, 2] = -s, c
    return m


def rotation_z(angle_rad: float) -> np.ndarray:
    """main.cpp:394-406."""
    m = identity4()
    c, s = math.cos(angle_rad), math.sin(angle_rad)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def print_vec3(name: str, v) -> None:
    """Debug vector dump (main.cpp:422-427)."""
    v = np.asarray(v, dtype=np.float64)
    print(f"{name}: ({v[0]:.4f}, {v[1]:.4f}, {v[2]:.4f})")


def print_mat4(name: str, m: np.ndarray) -> None:
    """Debug matrix dump (main.cpp:429-438)."""
    print(f"{name}:")
    for i in range(4):
        print("  [" + ", ".join(f"{m[i, j]:8.4f}" for j in range(4)) + "]")


def transform_point(m: np.ndarray, p) -> np.ndarray:
    """Apply a 4x4 to a 3D point (w=1) with the perspective divide, as
    the AABB corner transform does (geometry.h:297-327)."""
    p = np.asarray(p, dtype=np.float64)
    v = m @ np.array([p[0], p[1], p[2], 1.0])
    return v[:3] / v[3]


def transform_dir(m: np.ndarray, d) -> np.ndarray:
    """Apply a 4x4 to a direction (w=0), as the shaders turn normals
    (main.cpp:83-87)."""
    d = np.asarray(d, dtype=np.float64)
    return (m @ np.array([d[0], d[1], d[2], 0.0]))[:3]


@dataclass
class Plane:
    """Plane in the form dot(normal, p) + d = 0 (geometry.h:253-267)."""

    normal: np.ndarray
    d: float

    def distance(self, point) -> float:
        return float(np.dot(self.normal, np.asarray(point, dtype=np.float64))) + self.d


@dataclass
class AABB:
    """Axis-aligned bounding box (geometry.h:270-327)."""

    min: np.ndarray
    max: np.ndarray

    def __init__(self, min_val=None, max_val=None):
        self.min = (np.zeros(3) if min_val is None
                    else np.asarray(min_val, dtype=np.float64).copy())
        self.max = (np.zeros(3) if max_val is None
                    else np.asarray(max_val, dtype=np.float64).copy())

    def center(self) -> np.ndarray:
        return (self.min + self.max) * 0.5

    def transform(self, matrix: np.ndarray) -> "AABB":
        """Transform all 8 corners (with w-divide) and re-box
        (geometry.h:297-327)."""
        xs = [self.min[0], self.max[0]]
        ys = [self.min[1], self.max[1]]
        zs = [self.min[2], self.max[2]]
        new_min = np.full(3, 1e9)
        new_max = np.full(3, -1e9)
        for z in zs:
            for y in ys:
                for x in xs:
                    p = transform_point(matrix, (x, y, z))
                    new_min = np.minimum(new_min, p)
                    new_max = np.maximum(new_max, p)
        return AABB(new_min, new_max)

    @classmethod
    def of_points(cls, points: np.ndarray, margin_frac: float = 0.0) -> "AABB":
        """Bounding box of an (N, 3) point cloud with an optional symmetric
        margin fraction (model.cpp:15-40 uses 1%)."""
        points = np.asarray(points, dtype=np.float64)
        if points.size == 0:
            return cls(np.zeros(3), np.zeros(3))
        lo = points.min(axis=0)
        hi = points.max(axis=0)
        margin = (hi - lo) * margin_frac
        return cls(lo - margin, hi + margin)


class Frustum:
    """View frustum as 6 planes for per-model AABB culling, extracted with
    the Gribb-Hartmann rows for column-vector matrices: plane k = row 3
    +/- row k of the view-projection matrix; points inside satisfy all
    six ``dot(n, p) + d >= 0``."""

    def __init__(self, planes):
        self.planes = list(planes)

    @classmethod
    def from_matrix(cls, matrix: np.ndarray) -> "Frustum":
        m = np.asarray(matrix, dtype=np.float64)
        row3 = m[3, :]
        planes = []
        for axis, sign in ((0, +1), (0, -1), (1, +1), (1, -1), (2, +1), (2, -1)):
            v = row3 + sign * m[axis, :]       # (nx, ny, nz, d)
            n, d = v[:3].copy(), float(v[3])
            length = norm(n)
            if length > 0.0:
                n /= length
                d /= length
            planes.append(Plane(normal=n, d=d))
        return cls(planes)

    def intersects(self, aabb: AABB) -> bool:
        """Positive-vertex test (our_gl.cpp:264-280): for each plane pick the
        AABB corner farthest along the normal; if it is behind the plane the
        box is fully outside."""
        for plane in self.planes:
            positive = np.where(plane.normal >= 0, aabb.max, aabb.min)
            if plane.distance(positive) < 0:
                return False
        return True
