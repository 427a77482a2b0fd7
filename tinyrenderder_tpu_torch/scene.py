"""Scene entry points: the tiled frame and the image route.

Counterpart of ``tinyrenderder_tpu.scene.render_scene`` (the tiled
backend's device loop, ``_render_device_tiles`` and
``_finish_device_tiles``) and ``render_scene_image``.  The scene
description stays the JAX package's host-side ``Scene``: its frustum
cull and per-pass inputs (``_cull_passes``, ``_pass_inputs(device=False)``)
run in NumPy, ``convert`` carries them across, and ``ops.raster_sparse``
renders.

A shader the port has no device half for raises ``NotImplementedError``
naming the ROADMAP item that ports it; nothing falls back to another
route.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tinyrenderder_tpu import math3d
from tinyrenderder_tpu.camera import Camera
from tinyrenderder_tpu.models import procedural
from tinyrenderder_tpu.scene import RenderResult, Scene, _cull_passes, _pass_inputs
from tinyrenderder_tpu.shaders import (EyeShader, GouraudShader, PhongShader,
                                       TexturedShader)
from tinyrenderder_tpu.utils.stats import RenderStats
from tinyrenderder_tpu_torch import convert, shaders
from tinyrenderder_tpu_torch.ops import raster, raster_sparse

__all__ = ["render_scene", "render_passes", "render_scene_image", "pass_tensors",
           "oracle_render", "headline_scene", "multimesh_scene", "Scene",
           "RenderResult"]


def _tensors(scene: Scene, p, device):
    if not shaders.supports(p.shader):
        raise NotImplementedError(
            f"{type(p.shader).__name__} is not ported yet: ROADMAP.md Queue 1 "
            "(depth-only and shadow-mapped passes: item 10)")
    attrs, uniforms = _pass_inputs(scene, p, np.float32, device=False)
    attrs_t, uniforms_t = convert.pass_to_torch(attrs, uniforms, device)
    return attrs_t, p.shader, uniforms_t, p.exclude_from_output_depth


def pass_tensors(scene: Scene, device, frustum_cull: bool = True) -> list:
    """The scene's visible passes as ``(attrs, shader, uniforms,
    exclude_from_output_depth)`` with tensors on ``device``: the host-side
    cull and inputs, carried across."""
    visible = _cull_passes(scene, frustum_cull, RenderStats())
    return [_tensors(scene, p, device) for p in visible]


def render_scene(scene: Scene, device, frustum_cull: bool = True,
                 collect_stats: bool = True) -> RenderResult:
    """Render every pass of ``scene`` into one tiled frame on ``device``
    (the JAX package's ``render_scene(backend="tiled")``).  ``color``
    (H, W, 3) uint8, ``depth`` (the output depth: the snapshot when the
    frame ends inside a run of excluded passes) and ``full_depth`` are
    tensors on ``device``.  With ``collect_stats`` the ``RenderStats``
    are exact (``fragments_exact``): each pass reads back its counters
    once, and ``pass_timings["frame"]`` holds the frame's host seconds.
    On a CUDA device every kernel of the route runs on the card; on the
    CPU the kernels' plain versions run."""
    stats = RenderStats()
    visible = _cull_passes(scene, frustum_cull, stats)
    passes = [_tensors(scene, p, device) for p in visible]
    t0 = time.perf_counter()
    fb, depth, events = render_passes(passes, scene.width, scene.height, device,
                                      collect_stats)
    timings = {}
    if collect_stats:
        for ev in events:
            agg = raster.pass_stats(ev.setup)
            stats.triangles_rasterized += agg["triangles"]
            if agg["valid_triangles"]:
                stats.merge_bbox(agg["min_x"], agg["min_y"], agg["max_x"], agg["max_y"])
            frags, min_z, max_z = torch.stack(
                [ev.fragments.double(), ev.min_z.double(), ev.max_z.double()]).tolist()
            stats.fragments_drawn += int(frags)
            if np.isfinite(min_z):
                stats.merge_z(min_z, max_z)
        stats.fragments_exact = True
        timings["frame"] = time.perf_counter() - t0
    return RenderResult(color=fb.color, depth=depth, full_depth=fb.depth,
                        stats=stats, pass_timings=timings)


def render_passes(passes, width: int, height: int, device,
                  collect_stats: bool = False):
    """The frame of ``render_scene`` from its pass tensors
    (``pass_tensors``) -> (FrameBuffers in image layout, output depth
    (H, W), per-pass events or None).  The frame is tiled with
    ``pick_tile_h`` rows; the output depth of a frame that ends inside
    a run of excluded passes is the snapshot, untiled on its own."""
    th = raster_sparse.pick_tile_h(width, height)
    ft, out_depth_t, events = raster_sparse.render_frame_fused(
        passes, width, height, device, tile_h=th, collect_stats=collect_stats)
    fb = raster_sparse.tiles_to_buffers(ft, width, height, tile_h=th)
    if not (passes and passes[-1][3]):
        return fb, fb.depth, events
    tw = raster_sparse.TILE_W
    depth = raster_sparse.untile_one(out_depth_t, raster_sparse.cdiv(width, tw),
                                     raster_sparse.cdiv(height, th), th, tw)
    return fb, depth[:height, :width], events


def render_scene_image(scene: Scene, device, frustum_cull: bool = True):
    """Render ``scene`` to an (H, W, 3) uint8 image tensor on ``device``.
    A frame of one non-empty colour pass goes straight to the image
    (``render_frame_fused_image``); any other goes through
    ``render_scene`` and returns its colour, as the JAX package routes
    it.  On a CUDA device every kernel runs on the card; on the CPU the
    kernels' plain versions run."""
    visible = _cull_passes(scene, frustum_cull, RenderStats())
    if (len(visible) == 1 and visible[0].mesh.nfaces > 0
            and visible[0].shader.writes_color
            and not visible[0].exclude_from_output_depth):
        return raster_sparse.render_frame_fused_image(
            [_tensors(scene, visible[0], device)], scene.width, scene.height,
            tile_h=raster_sparse.pick_tile_h(scene.width, scene.height))
    return render_scene(scene, device, frustum_cull, collect_stats=False).color


def oracle_render(scene: Scene, frustum_cull: bool = True) -> RenderResult:
    """The JAX package's float32 NumPy oracle on the same scene: the
    bitwise reference for ``render_scene`` and ``render_scene_image``."""
    return scene.render(backend="oracle", dtype=np.float32, frustum_cull=frustum_cull)


def _lights():
    key = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
    fill = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
    rim = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))
    return key, fill, rim


def _camera(width: int, height: int, eye) -> Camera:
    cam = Camera()
    cam.set_eye(math3d.vec3(*eye))
    cam.set_target(math3d.vec3(0, 0, 0))
    cam.set_fov(60.0)
    cam.set_aspect(width / height)
    cam.set_clipping(0.1, 50.0)
    return cam


def headline_scene(width: int = 2048, height: int = 2048, shader: str = "phong",
                   n_lat: int = 96, n_lon: int = 144) -> Scene:
    """The benchmark headline scene of ``bench.py::bench_single_pass``
    without importing the benchmark: the procedural bumpy head with a
    256² packed material, the bench camera and lights, one pass."""
    key, fill, rim = _lights()
    shader_obj = {
        "phong": lambda: PhongShader(key, fill, rim, normal_map_strength=0.5),
        "gouraud": lambda: GouraudShader(light_world=key),
        "textured": lambda: TexturedShader(light_world=key),
    }[shader]()
    head = procedural.bumpy_head(n_lat, n_lon)
    head.materials = [procedural.default_head_material(256)]
    scene = Scene(camera=_camera(width, height, (0, 0.4, 2.6)), width=width,
                  height=height)
    scene.add(head, math3d.identity4(), shader_obj, name="head")
    return scene


def multimesh_scene(width: int, height: int, head_lat: int = 64, head_lon: int = 96,
                    eye_lat: int = 12, eye_lon: int = 16) -> Scene:
    """The benchmark's 3-mesh scene, ``bench.py::_scene(meshes=3)``,
    without importing the benchmark: the bumpy head (normal-mapped
    Phong), the eyes (EyeShader, excluded from the output depth, the
    middle pass) and an inward-facing room (Phong, no normal map).  The
    mesh resolutions are the bench's by default; tests pass smaller
    ones."""
    key, fill, rim = _lights()
    scene = Scene(camera=_camera(width, height, (0, 0.6, 3.0)), width=width,
                  height=height)
    head = procedural.bumpy_head(head_lat, head_lon)
    head.materials = [procedural.default_head_material(256)]
    scene.add(head, math3d.identity4(),
              PhongShader(key, fill, rim, normal_map_strength=0.5), name="head")
    eyes = procedural.uv_sphere(eye_lat, eye_lon, radius=0.12, name="eyes")
    eyes.positions += np.array([0.35, 0.25, 0.8])
    eyes.finalize()
    eyes.materials = [procedural.default_head_material(64)]
    scene.add(eyes, math3d.identity4(), EyeShader(key, rim), name="eyes",
              exclude_from_output_depth=True)
    room = procedural.cube(size=12.0, name="room")
    room.faces = room.faces[:, ::-1].copy()
    room.finalize()
    room.materials = [procedural.default_head_material(128)]
    scene.add(room, math3d.identity4(),
              PhongShader(key, fill, rim, normal_map_strength=0.0), name="room")
    return scene
