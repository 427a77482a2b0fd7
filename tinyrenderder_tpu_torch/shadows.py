"""Two-pass hard shadow mapping on the device.

Counterpart of ``tinyrenderder_tpu/shadows.py``: pass 1 renders the
scene's depth from the key light (a depth-only frame: the coarse, strip
or grouped strip raster and the depth merge, no shading), pass 2 renders
the scene with every Phong pass swapped for a ``ShadowMappedShader`` that
samples that depth map.

The JAX package renders it two ways, a fused XLA program for the tiled
backend without stats and a loop of two renders.  Eager PyTorch has one
path, ``render_with_shadows``: the light pass through
``raster_sparse.render_frame_fused`` at S x S with 16-row tiles and no
stats, ``untile_one`` of its depth, then the lit scene through
``scene.render_scene``; on the scan backend ("xla") and the sharded
ones, both passes through ``scene.render_scene``.  The map never leaves the device: it reaches the
lit passes as a uniform tensor.  ``oracle_render_with_shadows`` is the
same two passes on the NumPy oracle, the bitwise reference.
``Scene.render(shadows=(light_dir, settings))`` returns the lit result of
either.

Traced (``trace``), a shadowed frame is one frame record: ``frame``
around both passes, ``shadow.light`` around the light camera, the depth
scene, the light pass and its untile (the light pass's ``frame.cull``,
``frame.inputs``, ``pass`` and ``readback`` spans lie under it), and
``shadow.lit`` around ``shadowed_scene``; the lit pass's spans lie under
``frame``.  Each of the four caches counts ``cache.shadow_cam``,
``cache.shadow_merged``, ``cache.shadow_depth`` and
``cache.shadow_lit`` ``.hit`` / ``.miss``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from tinyrenderder_tpu_torch import math3d, trace
from tinyrenderder_tpu_torch.camera import Camera
from tinyrenderder_tpu_torch.models.mesh import Mesh
from tinyrenderder_tpu_torch.ops import raster_sparse
from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_H, TILE_W, cdiv
from tinyrenderder_tpu_torch.scene import (RenderResult, Scene, oracle_render,
                                           pass_tensors, render_scene)
from tinyrenderder_tpu_torch.shaders import DepthShader, PhongShader, ShadowMappedShader

__all__ = ["ShadowSettings", "light_camera_for_scene", "invalidate_caches", "depth_scene",
           "render_depth_from_light", "shadowed_scene", "render_with_shadows",
           "oracle_render_with_shadows"]


@dataclass
class ShadowSettings:
    size: int = 1024          # shadow map resolution (square)
    fov_margin: float = 1.3   # widen the light frustum beyond the scene
    distance_factor: float = 2.5


def light_camera_for_scene(scene: Scene, light_dir,
                           settings: ShadowSettings | None = None) -> Camera:
    """A camera looking down ``light_dir`` (the direction light comes
    from, the shaders' to-light vector) that frames the whole scene.
    Cached on the scene, keyed by its meshes, model matrices, the light
    and the settings."""
    settings = settings or ShadowSettings()
    ckey = (tuple((id(p.mesh), p.model_matrix.tobytes()) for p in scene.passes),
            np.asarray(light_dir, np.float64).tobytes(),
            settings.size, settings.fov_margin, settings.distance_factor)
    cached = scene.__dict__.get("_shadow_light_cam")
    if cached is not None and cached[0] == ckey:
        trace.count("cache.shadow_cam.hit")
        return cached[1]
    trace.count("cache.shadow_cam.miss")
    boxes = scene.world_aabbs()
    lo = np.min([b.min for b in boxes], axis=0)
    hi = np.max([b.max for b in boxes], axis=0)
    center = (lo + hi) * 0.5
    radius = max(float(np.linalg.norm(hi - lo)) * 0.5, 1e-3)
    d = math3d.normalized(np.asarray(light_dir, dtype=np.float64))
    dist = radius * settings.distance_factor

    cam = Camera()
    cam.set_eye(center + d * dist)
    cam.set_target(center)
    up = (0.0, 1.0, 0.0) if abs(d[1]) < 0.99 else (1.0, 0.0, 0.0)
    cam.set_up(np.asarray(up))
    fov = 2.0 * np.degrees(np.arctan2(radius, dist)) * settings.fov_margin
    cam.set_fov(float(np.clip(fov, 10.0, 120.0)))
    cam.set_aspect(1.0)
    # distance_factor <= 1.5 would put the near plane at or behind the eye
    cam.set_clipping(max(dist - radius * 1.5, radius * 1e-3), dist + radius * 1.5)
    scene.__dict__["_shadow_light_cam"] = (ckey, cam)
    return cam


def invalidate_caches(scene: Scene) -> None:
    """Drop the per-scene shadow caches (light camera, merged mesh, depth
    scene).  Call after editing a mesh's ``positions`` in place, with the
    mesh's ``invalidate_device_cache``: the caches key on ``id(mesh)`` and
    the model matrices, which cannot see that."""
    for k in ("_shadow_light_cam", "_shadow_merged", "_shadow_depth_scene"):
        scene.__dict__.pop(k, None)


def _merged_world_mesh(scene: Scene) -> Mesh:
    """Every mesh of the scene in one, model matrices baked into the
    positions (the light pass has no per-mesh state, so one pass replaces
    len(passes)).  Positions and faces only, as the JAX package builds it.
    Cached on the scene like the light camera."""
    key = tuple((id(p.mesh), p.model_matrix.tobytes()) for p in scene.passes)
    cached = scene.__dict__.get("_shadow_merged")
    if cached is not None and cached[0] == key:
        trace.count("cache.shadow_merged.hit")
        return cached[1]
    trace.count("cache.shadow_merged.miss")
    pos, fac = [], []
    offset = 0
    for p in scene.passes:
        m = p.model_matrix
        ph = p.mesh.positions @ m[:3, :3].T + m[:3, 3]
        w = (p.mesh.positions @ m[3:4, :3].T + m[3, 3]).reshape(-1, 1)
        pos.append(ph / w)                      # the AABB's w divide
        fac.append(p.mesh.faces + offset)
        offset += p.mesh.nverts
    merged = Mesh(positions=np.concatenate(pos), faces=np.concatenate(fac),
                  name="shadow_merged")
    scene.__dict__["_shadow_merged"] = (key, merged)
    return merged


def depth_scene(scene: Scene, light_cam: Camera, settings: ShadowSettings) -> Scene:
    """The light pass as a scene: the merged mesh under ``DepthShader`` at
    S x S from ``light_cam``, cached on ``scene``."""
    merged = _merged_world_mesh(scene)
    ckey = (id(merged), id(light_cam), settings.size)
    cached = scene.__dict__.get("_shadow_depth_scene")
    if cached is not None and cached[0] == ckey:
        trace.count("cache.shadow_depth.hit")
        return cached[1]
    trace.count("cache.shadow_depth.miss")
    light = Scene(camera=light_cam, width=settings.size, height=settings.size)
    light.add(merged, np.eye(4), DepthShader(), name="lightdepth")
    scene.__dict__["_shadow_depth_scene"] = (ckey, light)
    return light


def render_depth_from_light(scene: Scene, light_cam: Camera, settings: ShadowSettings,
                            device, backend: str = "tiled", mesh=None):
    """Pass 1: the depth of every mesh from the light, an (S, S) float32
    tensor on ``device`` (+inf where nothing is drawn).  One depth-only
    pass through ``render_frame_fused`` with 16-row tiles, no stats (the
    map is all the pass returns), then ``untile_one`` of its depth; on the
    scan backend ("xla": a depth-only scan pass) or a sharded backend
    (over ``mesh``'s ranks), the full depth of ``render_scene`` of the
    light's scene."""
    s = settings.size
    light = depth_scene(scene, light_cam, settings)
    if backend != "tiled":
        return render_scene(light, device, False, False, backend, mesh).full_depth
    passes = pass_tensors(light, device, frustum_cull=False)
    ft, _, _ = raster_sparse.render_frame_fused(passes, s, s, device, tile_h=TILE_H,
                                                names=[p.name for p in light.passes])
    depth = raster_sparse.untile_one(ft.depth, cdiv(s, TILE_W), cdiv(s, TILE_H), TILE_H,
                                     TILE_W)
    return depth[:s, :s].contiguous()


def _phong_lights(shader) -> tuple | None:
    """The state a Phong pass's ``ShadowMappedShader`` copies: its three
    world lights (by value) and its normal-map strength."""
    if not isinstance(shader, PhongShader) or isinstance(shader, ShadowMappedShader):
        return None
    return tuple(np.asarray(v, np.float64).tobytes() for v in
                 (shader.key_light_world, shader.fill_light_world,
                  shader.rim_light_world)) + (shader.normal_map_strength,)


def shadowed_scene(scene: Scene, light_dir, shadow_map, light_cam: Camera,
                   settings: ShadowSettings) -> Scene:
    """Pass 2's scene: every Phong pass swapped for a
    ``ShadowMappedShader`` carrying its model-space -> light-screen
    matrix and ``shadow_map`` (a tensor, or a NumPy array for the
    oracle).  Cached on the source scene: a later call with the same
    passes, Phong lights, light and camera only swaps the map on the
    cached shaders (the Phong lights are keyed by value: the swapped
    shaders keep the lights bound when they were made)."""
    vp_l = math3d.viewport(0, 0, settings.size, settings.size)
    light_vp = vp_l @ light_cam.projection_matrix @ light_cam.view_matrix
    ckey = (tuple((id(p.mesh), p.model_matrix.tobytes(), id(p.shader),
                   _phong_lights(p.shader)) for p in scene.passes),
            light_vp.tobytes(), id(scene.camera), scene.width, scene.height)
    cached = scene.__dict__.get("_shadow_lit_scene")
    if cached is not None and cached[0] == ckey:
        trace.count("cache.shadow_lit.hit")
        lit = cached[1]
        for p in lit.passes:
            if isinstance(p.shader, ShadowMappedShader):
                p.shader.shadow_map = shadow_map
        return lit
    trace.count("cache.shadow_lit.miss")

    out = Scene(camera=scene.camera, width=scene.width, height=scene.height)
    for p in scene.passes:
        sh = p.shader
        if isinstance(sh, PhongShader) and not isinstance(sh, ShadowMappedShader):
            sh = ShadowMappedShader(
                sh.key_light_world, sh.fill_light_world, sh.rim_light_world,
                shadow_matrix=light_vp @ p.model_matrix, shadow_map=shadow_map,
                normal_map_strength=sh.normal_map_strength)
        out.add(p.mesh, p.model_matrix, sh, name=p.name, material_index=p.material_index,
                exclude_from_output_depth=p.exclude_from_output_depth)
    scene.__dict__["_shadow_lit_scene"] = (ckey, out)
    return out


def render_with_shadows(scene: Scene, light_dir, settings: ShadowSettings | None = None,
                        device="cuda", frustum_cull: bool = True,
                        collect_stats: bool = True, backend: str = "tiled", mesh=None):
    """The two-pass shadowed frame on ``device`` -> (``RenderResult`` of
    ``render_scene`` on the lit scene, the (S, S) shadow map tensor).  On
    a CUDA device every kernel runs on the card; on the CPU the kernels'
    plain versions run.  ``backend``: "tiled", "xla" (the scan backend) or
    a sharded backend for both passes (over ``mesh``, see
    ``scene.render_scene``)."""
    settings = settings or ShadowSettings()
    with trace.frame():
        with trace.span("shadow.light"):
            light_cam = light_camera_for_scene(scene, light_dir, settings)
            shadow_map = render_depth_from_light(scene, light_cam, settings, device, backend,
                                                 mesh)
        with trace.span("shadow.lit"):
            lit = shadowed_scene(scene, light_dir, shadow_map, light_cam, settings)
        return (render_scene(lit, device, frustum_cull, collect_stats, backend, mesh),
                shadow_map)


def oracle_render_with_shadows(scene: Scene, light_dir,
                               settings: ShadowSettings | None = None,
                               frustum_cull: bool = True,
                               dtype=np.float32) -> tuple[RenderResult, np.ndarray]:
    """The same two passes on the NumPy oracle (the JAX package's
    ``render_with_shadows(backend="oracle")``): -> (``RenderResult`` of
    NumPy arrays with exact stats, the (S, S) map as NumPy)."""
    settings = settings or ShadowSettings()
    light_cam = light_camera_for_scene(scene, light_dir, settings)
    shadow_map = oracle_render(depth_scene(scene, light_cam, settings), frustum_cull=False,
                               dtype=dtype).full_depth
    lit = shadowed_scene(scene, light_dir, shadow_map, light_cam, settings)
    return oracle_render(lit, frustum_cull, dtype), shadow_map
