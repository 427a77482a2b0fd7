"""Scenes and their entry points: the tiled frame and the image route.

Counterpart of ``tinyrenderder_tpu/scene.py``: the scene description
(``ScenePass``, ``Scene``, ``RenderResult``), the per-model frustum cull
(main.cpp:623-736) and the per-pass inputs (``build_uniforms`` and the
face attributes, in NumPy), then ``render_scene`` (the tiled backend's
frame loop, ``_render_device_tiles`` + ``_finish_device_tiles``) and
``render_scene_image``: ``convert`` carries each pass's inputs to the
device and ``ops.raster_sparse`` renders.  ``oracle_render`` is the
scene on the NumPy oracle (``_render_oracle``), the bitwise reference.

Every shader class of the JAX package has its device half here; a
shader class the port does not know raises ``NotImplementedError``, and
nothing falls back to another route.  A depth-only pass (the shadow
map's light pass, ``shadows.py``) renders depth and shades nothing.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tinyrenderder_tpu_torch import convert, math3d, oracle, shaders
from tinyrenderder_tpu_torch.camera import Camera
from tinyrenderder_tpu_torch.math3d import Frustum
from tinyrenderder_tpu_torch.models import procedural
from tinyrenderder_tpu_torch.models.mesh import Mesh
from tinyrenderder_tpu_torch.ops import raster, raster_sparse
from tinyrenderder_tpu_torch.shaders import (EyeShader, GouraudShader, PhongShader,
                                             Shader, TexturedShader)
from tinyrenderder_tpu_torch.utils.stats import RenderStats

log = logging.getLogger("tinyrenderder_tpu_torch.scene")

__all__ = ["ScenePass", "Scene", "RenderResult", "render_scene", "render_passes",
           "render_scene_image", "pass_tensors", "oracle_render", "headline_scene",
           "multimesh_scene", "stress_scene", "mixed_scene"]


@dataclass
class ScenePass:
    """One model submission: mesh + model matrix + shader (a
    main.cpp:647-668 render block)."""

    mesh: Mesh
    model_matrix: np.ndarray
    shader: Shader
    name: str = ""
    material_index: int = 0
    #: rendered into colour, but its depth writes leave the frame's OUTPUT
    #: depth: the reference's eye pass (z-buffer snapshot before, restore
    #: after, main.cpp:700,730), so SSAO sees the depth without the eyes
    exclude_from_output_depth: bool = False


@dataclass
class RenderResult:
    color: object                # (H, W, 3) uint8 RGB
    depth: object                # (H, W) float, the output depth (after restore)
    full_depth: object           # (H, W) float, excluded passes included
    stats: RenderStats
    pass_timings: dict = field(default_factory=dict)


@dataclass
class Scene:
    """A renderable scene description (camera + passes)."""

    camera: Camera
    width: int
    height: int
    passes: list[ScenePass] = field(default_factory=list)

    def add(self, mesh: Mesh, model_matrix, shader: Shader, **kw) -> ScenePass:
        p = ScenePass(mesh=mesh, model_matrix=np.asarray(model_matrix, dtype=np.float64),
                      shader=shader, **kw)
        self.passes.append(p)
        return p

    def world_aabbs(self) -> list:
        return [p.mesh.get_world_aabb(p.model_matrix) for p in self.passes]

    def describe(self) -> str:
        """Scene-analysis text in the spirit of main.cpp:545-579."""
        lines = ["=== Scene Analysis ==="]
        for p in self.passes:
            c = p.mesh.get_center()
            wc = p.mesh.get_world_aabb(p.model_matrix).center()
            lines.append(f"  {p.name or p.mesh.name}: local center "
                         f"({c[0]:.4f}, {c[1]:.4f}, {c[2]:.4f}) world center "
                         f"({wc[0]:.4f}, {wc[1]:.4f}, {wc[2]:.4f}) "
                         f"faces {p.mesh.nfaces}")
        return "\n".join(lines)


# one-entry frustum cache: a render loop keeps the camera fixed or moves
# it every frame, and either way one entry suffices
_FRUSTUM_CACHE: tuple | None = None


def _frustum_cached(view_proj: np.ndarray) -> Frustum:
    global _FRUSTUM_CACHE
    key = view_proj.tobytes()
    hit = _FRUSTUM_CACHE
    if hit is not None and hit[0] == key:
        return hit[1]
    f = Frustum.from_matrix(view_proj)
    _FRUSTUM_CACHE = (key, f)
    return f


def _cull_passes(scene: Scene, frustum_cull: bool, stats: RenderStats) -> list:
    """Per-model frustum culling (main.cpp:623-736): the visible passes,
    with the model and triangle counts added to ``stats``."""
    frustum = _frustum_cached(scene.camera.projection_matrix @ scene.camera.view_matrix)
    visible = []
    for p in scene.passes:
        if frustum_cull and not frustum.intersects(p.mesh.get_world_aabb(p.model_matrix)):
            stats.models_culled += 1
            stats.culled_triangles += p.mesh.nfaces
            log.info("%s CULLED by frustum", p.name or p.mesh.name)
            continue
        stats.models_rendered += 1
        stats.total_triangles += p.mesh.nfaces
        visible.append(p)
    return visible


def _pass_inputs(scene: Scene, p: ScenePass, dtype) -> tuple[dict, dict]:
    """A pass's face attributes and uniforms as NumPy arrays of ``dtype``
    (ModelView = view @ model, main.cpp:653)."""
    modelview = scene.camera.view_matrix @ p.model_matrix
    material = p.mesh.materials[p.material_index] if p.mesh.materials else None
    uniforms = p.shader.build_uniforms(modelview, scene.camera.projection_matrix,
                                       material, dtype)
    return p.mesh.face_attributes(dtype), uniforms


def _tensors(scene: Scene, p, device):
    if not shaders.supports(p.shader):
        raise NotImplementedError(
            f"{type(p.shader).__name__} has no device half in the port")
    attrs, uniforms = _pass_inputs(scene, p, np.float32)
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
    depth = raster_sparse.untile_image(out_depth_t, None, raster_sparse.cdiv(width, tw),
                                       raster_sparse.cdiv(height, th), th, tw, height, width)
    return fb, depth, events


def render_scene_image(scene: Scene, device, frustum_cull: bool = True):
    """Render ``scene`` to an (H, W, 3) uint8 image tensor on ``device``.
    A frame of one non-empty colour pass goes straight to the image
    (``render_frame_fused_image``); any other, a depth-only pass
    included, goes through ``render_scene`` and returns its colour, as
    the JAX package routes it.  On a CUDA device every kernel runs on the card; on the CPU the
    kernels' plain versions run."""
    visible = _cull_passes(scene, frustum_cull, RenderStats())
    if (len(visible) == 1 and visible[0].mesh.nfaces > 0
            and visible[0].shader.writes_color
            and not visible[0].exclude_from_output_depth):
        return raster_sparse.render_frame_fused_image(
            [_tensors(scene, visible[0], device)], scene.width, scene.height,
            tile_h=raster_sparse.pick_tile_h(scene.width, scene.height))
    return render_scene(scene, device, frustum_cull, collect_stats=False).color


def oracle_render(scene: Scene, frustum_cull: bool = True,
                  dtype=np.float32) -> RenderResult:
    """The scene on the NumPy oracle (the JAX package's
    ``render(backend="oracle")``), with the same snapshot/restore around
    excluded passes: the bitwise reference for ``render_scene`` and
    ``render_scene_image`` at float32.  NumPy arrays, exact stats."""
    stats = RenderStats()
    visible = _cull_passes(scene, frustum_cull, stats)
    frame = oracle.OracleFrame(
        color=np.zeros((scene.height, scene.width, 3), dtype=np.uint8),
        zbuffer=np.full((scene.height, scene.width), np.inf, dtype=dtype), stats=stats)
    snapshot = None
    in_excluded = False
    timings = {}
    for p in visible:
        attrs, uniforms = _pass_inputs(scene, p, dtype)
        if p.exclude_from_output_depth:
            if not in_excluded:
                snapshot = frame.zbuffer.copy()     # main.cpp:700
                in_excluded = True
        elif in_excluded:
            frame.zbuffer = snapshot.copy()         # main.cpp:730
            in_excluded = False
        t0 = time.perf_counter()
        oracle.render_pass(frame, oracle.OraclePass(attrs, p.shader, uniforms),
                           scene.width, scene.height, dtype=dtype)
        timings[p.name or p.mesh.name] = time.perf_counter() - t0
    return RenderResult(color=frame.color,
                        depth=snapshot if in_excluded else frame.zbuffer,
                        full_depth=frame.zbuffer, stats=stats, pass_timings=timings)


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


def _wall_scene(mesh: Mesh, width: int, height: int) -> Scene:
    """One normal-mapped Phong pass of ``mesh`` (its own 128² material)
    under the camera of ``bench.py::bench_stress`` / ``bench_mixed``."""
    key, fill, rim = _lights()
    scene = Scene(camera=_camera(width, height, (0, 0.3, 6.5)), width=width,
                  height=height)
    scene.add(mesh, math3d.identity4(), PhongShader(key, fill, rim, normal_map_strength=0.5),
              name=mesh.name)
    return scene


def stress_scene(width: int, height: int, grid: int = 3, n_lat: int = 96,
                 n_lon: int = 144) -> Scene:
    """The bench's Sponza-scale stress scene (``bench.py::bench_stress``):
    ``procedural.head_wall(grid)``, 246,240 faces at grid 3.  Tests pass a
    smaller grid and tessellation."""
    return _wall_scene(procedural.head_wall(grid, n_lat, n_lon), width, height)


def mixed_scene(width: int, height: int, grid: int = 3, n_lat: int = 96,
                n_lon: int = 144) -> Scene:
    """The bench's mixed-regime scene (``bench.py::bench_mixed``):
    ``procedural.mixed_interior(grid)``, the head wall and twelve giant
    room triangles in one mesh, 246,252 faces at grid 3."""
    return _wall_scene(procedural.mixed_interior(grid, n_lat, n_lon), width, height)
