"""Camera: view and projection matrices, presets and auto-framing.

Counterpart of ``tinyrenderder_tpu/camera.py`` (the reference's
``camera.h``): the right-handed look-at view (camera.h:192-205), the
OpenGL-style projection with NDC z in [-1, 1] (camera.h:207-218), the
four named presets (camera.h:39-82), the AABB auto-framing
(camera.h:85-141) and the setter-recomputes-matrices behaviour
(camera.h:165-174).  Host-side float64, like the reference's doubles.
"""

from __future__ import annotations

import enum
import logging
import math
from dataclasses import dataclass, field

import numpy as np

from tinyrenderder_tpu_torch import math3d
from tinyrenderder_tpu_torch.math3d import AABB

log = logging.getLogger("tinyrenderder_tpu_torch.camera")

__all__ = ["Camera", "CameraParams", "Preset", "setup_camera_for_rendering"]


class Preset(enum.Enum):
    """camera.h:12-17."""

    SPONZA_SCENE = "sponza_scene"
    CHARACTER_CLOSEUP = "character_closeup"
    OVERVIEW = "overview"
    DEFAULT = "default"


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
    def __init__(self, preset: Preset | None = None, aspect: float = 16.0 / 9.0):
        self.params = CameraParams()
        if preset is not None:
            self.set_preset(preset, aspect)
        else:
            self.update_matrices()

    # -- presets (camera.h:39-82) -------------------------------------------
    def set_preset(self, preset: Preset, aspect: float = 16.0 / 9.0) -> None:
        """Only OVERVIEW assigns ``up`` (camera.h:39-82): leaving OVERVIEW
        for another preset keeps up = (0, 0, -1), as the reference does,
        which can put up parallel to the view; set ``up`` after it where
        that matters."""
        p = self.params
        p.aspect = aspect
        if preset == Preset.SPONZA_SCENE:
            p.eye = math3d.vec3(0, 15, 40)
            p.target = math3d.vec3(0, 10, 0)
            p.fov, p.near_plane, p.far_plane = 55.0, 0.5, 500.0
        elif preset == Preset.CHARACTER_CLOSEUP:
            p.eye = math3d.vec3(0, 5, 12)
            p.target = math3d.vec3(0, 4, 0)
            p.fov, p.near_plane, p.far_plane = 45.0, 0.1, 100.0
        elif preset == Preset.OVERVIEW:
            p.eye = math3d.vec3(0, 50, 0)
            p.target = math3d.vec3(0, 0, 0)
            p.up = math3d.vec3(0, 0, -1)
            p.fov, p.near_plane, p.far_plane = 60.0, 1.0, 200.0
        else:
            p.eye = math3d.vec3(0, 0, 10)
            p.target = math3d.vec3(0, 0, 0)
            p.fov, p.near_plane, p.far_plane = 60.0, 0.1, 200.0
        self.update_matrices()

    # -- auto-framing (camera.h:85-141) -----------------------------------------
    def auto_setup_for_scene(self, scene_bounds: AABB, aspect: float = 16.0 / 9.0) -> None:
        """Frame one AABB (camera.h:85-116): the eye above and in front of
        its centre at the distance that fits 1.5x its largest side."""
        p = self.params
        p.aspect = aspect
        center = (scene_bounds.min + scene_bounds.max) * 0.5
        size = scene_bounds.max - scene_bounds.min
        max_dim = float(np.max(size))

        fov_rad = p.fov * math.pi / 180.0
        required = (max_dim * 1.5) / (2.0 * math.tan(fov_rad / 2.0))
        if p.aspect > 1.0:
            required *= p.aspect
        required = max(5.0, min(required, 200.0))

        p.eye = center + math3d.vec3(0, required * 0.5, required)
        p.target = center
        scene_radius = max_dim * 0.5
        p.far_plane = max(100.0, required + scene_radius * 3.0)
        self.update_matrices()

    def setup_for_multiple_models(self, model_bounds: list[AABB],
                                  aspect: float = 16.0 / 9.0) -> None:
        """Frame the union of the AABBs (camera.h:119-141); DEFAULT for none."""
        if not model_bounds:
            self.set_preset(Preset.DEFAULT, aspect)
            return
        overall_min = model_bounds[0].min.copy()
        overall_max = model_bounds[0].max.copy()
        for b in model_bounds[1:]:
            overall_min = np.minimum(overall_min, b.min)
            overall_max = np.maximum(overall_max, b.max)
        self.auto_setup_for_scene(AABB(overall_min, overall_max), aspect)

    # -- matrix maintenance (camera.h:144-174, 192-218) ------------------------
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

    @property
    def view_projection_matrix(self) -> np.ndarray:
        """camera.h:152 (projection @ view)."""
        return self._proj @ self._view

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


def setup_camera_for_rendering(camera: Camera, model_bounds: list[AABB],
                               width: int, height: int, auto_adjust: bool = True) -> None:
    """Frame the models for a width x height frame, or take the
    SPONZA_SCENE preset (camera.h:232-242)."""
    if auto_adjust and model_bounds:
        camera.setup_for_multiple_models(model_bounds, width / height)
    else:
        camera.set_preset(Preset.SPONZA_SCENE, width / height)
    camera.print_info()
