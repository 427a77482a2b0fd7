"""Camera: view and projection matrices with recomputing setters.

Counterpart of ``tinyrenderder_tpu/camera.py`` (the reference's
``camera.h``), the parts the port's scenes use: the right-handed look-at
view (camera.h:192-205), the OpenGL-style projection with NDC z in
[-1, 1] (camera.h:207-218) and the setter-recomputes-matrices behaviour
(camera.h:165-174).  Host-side float64, like the reference's doubles.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np

from tinyrenderder_tpu_torch import math3d

log = logging.getLogger("tinyrenderder_tpu_torch.camera")

__all__ = ["Camera", "CameraParams"]


@dataclass
class CameraParams:
    """camera.h:20-29."""

    eye: np.ndarray = field(default_factory=lambda: math3d.vec3(0, 0, 10))
    target: np.ndarray = field(default_factory=lambda: math3d.vec3(0, 0, 0))
    up: np.ndarray = field(default_factory=lambda: math3d.vec3(0, 1, 0))
    fov: float = 60.0            # degrees
    aspect: float = 16.0 / 9.0
    near_plane: float = 0.1
    far_plane: float = 1000.0


class Camera:
    def __init__(self):
        self.params = CameraParams()
        self.update_matrices()

    def update_matrices(self) -> None:
        self._update_view()
        self._update_projection()

    def _update_view(self) -> None:
        p = self.params
        self._view = math3d.lookat(p.eye, p.target, p.up)

    def _update_projection(self) -> None:
        p = self.params
        self._proj = math3d.perspective(p.fov, p.aspect, p.near_plane, p.far_plane)

    @property
    def view_matrix(self) -> np.ndarray:
        return self._view.copy()

    @property
    def projection_matrix(self) -> np.ndarray:
        return self._proj.copy()

    # -- setters (camera.h:165-174) ---------------------------------------------
    def set_eye(self, eye) -> None:
        self.params.eye = np.asarray(eye, dtype=np.float64)
        self._update_view()

    def set_target(self, target) -> None:
        self.params.target = np.asarray(target, dtype=np.float64)
        self._update_view()

    def set_up(self, up) -> None:
        self.params.up = np.asarray(up, dtype=np.float64)
        self._update_view()

    def set_fov(self, fov: float) -> None:
        self.params.fov = fov
        self._update_projection()

    def set_aspect(self, aspect: float) -> None:
        self.params.aspect = aspect
        self._update_projection()

    def set_clipping(self, near: float, far: float) -> None:
        self.params.near_plane = near
        self.params.far_plane = far
        self._update_projection()

    # -- diagnostics (camera.h:177-185) ------------------------------------------
    def describe(self) -> str:
        p = self.params
        dist = math3d.norm(p.eye - p.target)
        return (f"Camera Info:\n"
                f"  Eye: ({p.eye[0]}, {p.eye[1]}, {p.eye[2]})\n"
                f"  Target: ({p.target[0]}, {p.target[1]}, {p.target[2]})\n"
                f"  FOV: {p.fov} degrees\n"
                f"  Aspect: {p.aspect}\n"
                f"  Clipping: {p.near_plane} - {p.far_plane}\n"
                f"  Distance to target: {dist}")

    def print_info(self) -> None:
        log.info("%s", self.describe())
