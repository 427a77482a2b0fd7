"""Scene entry point of the single-pass image route.

Counterpart of ``tinyrenderder_tpu.scene.render_scene_image`` (tiled
branch).  The scene description stays the JAX package's host-side
``Scene``: its frustum cull and per-pass inputs (``_cull_passes``,
``_pass_inputs(device=False)``) run in NumPy, ``convert`` carries them
across, and ``ops.raster_sparse`` renders.

Scene shapes this slice does not cover raise ``NotImplementedError``
naming the ROADMAP item that ports them; nothing falls back to another
route.
"""

from __future__ import annotations

import numpy as np

from tinyrenderder_tpu import math3d, oracle
from tinyrenderder_tpu.camera import Camera
from tinyrenderder_tpu.models import procedural
from tinyrenderder_tpu.scene import Scene, _cull_passes, _pass_inputs
from tinyrenderder_tpu.shaders import GouraudShader, PhongShader, TexturedShader
from tinyrenderder_tpu.utils.stats import RenderStats
from tinyrenderder_tpu_torch import convert, shaders
from tinyrenderder_tpu_torch.ops import raster_sparse

__all__ = ["render_scene_image", "pass_tensors", "oracle_frame", "headline_scene",
           "Scene"]


def _single_pass(scene: Scene, frustum_cull: bool):
    visible = _cull_passes(scene, frustum_cull, RenderStats())
    if not visible:
        raise NotImplementedError("an empty frame (every pass culled) is not "
                                  "ported yet: ROADMAP.md Queue 1 item 7")
    if len(visible) > 1:
        raise NotImplementedError(f"{len(visible)}-pass frames are not ported "
                                  "yet: ROADMAP.md Queue 1 item 7")
    p = visible[0]
    if p.mesh.nfaces == 0:
        raise NotImplementedError("an empty pass is not ported yet: "
                                  "ROADMAP.md Queue 1 item 7")
    if not p.shader.writes_color or p.exclude_from_output_depth:
        raise NotImplementedError("depth-only and excluded-depth passes are not "
                                  "ported yet: ROADMAP.md Queue 1 items 7 and 10")
    if not shaders.supports(p.shader):
        raise NotImplementedError(f"{type(p.shader).__name__} is not ported yet: "
                                  "ROADMAP.md Queue 1")
    return p


def render_scene_image(scene: Scene, device, frustum_cull: bool = True):
    """Render a one-color-pass scene straight to an (H, W, 3) uint8 image
    tensor on ``device``.  On a CUDA device every kernel of the route
    runs on the card; on the CPU the kernels' plain versions run."""
    return raster_sparse.render_frame_fused_image(
        [pass_tensors(scene, device, frustum_cull)], scene.width, scene.height,
        tile_h=raster_sparse.pick_tile_h(scene.width, scene.height))


def pass_tensors(scene: Scene, device, frustum_cull: bool = True):
    """The scene's single pass as ``(attrs, shader, uniforms, False)`` with
    tensors on ``device``: the host-side cull and inputs, carried across."""
    p = _single_pass(scene, frustum_cull)
    attrs, uniforms = _pass_inputs(scene, p, np.float32, device=False)
    attrs_t, uniforms_t = convert.pass_to_torch(attrs, uniforms, device)
    return attrs_t, p.shader, uniforms_t, False


def oracle_frame(scene: Scene, frustum_cull: bool = True) -> oracle.OracleFrame:
    """The JAX package's float32 NumPy oracle on the same single pass:
    the bitwise reference for ``render_scene_image``."""
    p = _single_pass(scene, frustum_cull)
    attrs, uniforms = _pass_inputs(scene, p, np.float32, device=False)
    return oracle.render_passes([oracle.OraclePass(attrs, p.shader, uniforms)],
                                scene.width, scene.height, dtype=np.float32)


def headline_scene(width: int = 2048, height: int = 2048, shader: str = "phong",
                   n_lat: int = 96, n_lon: int = 144) -> Scene:
    """The benchmark headline scene of ``bench.py::bench_single_pass``
    without importing the benchmark: the procedural bumpy head with a
    256² packed material, the bench camera and lights, one pass."""
    key = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
    fill = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
    rim = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))
    shader_obj = {
        "phong": lambda: PhongShader(key, fill, rim, normal_map_strength=0.5),
        "gouraud": lambda: GouraudShader(light_world=key),
        "textured": lambda: TexturedShader(light_world=key),
    }[shader]()
    head = procedural.bumpy_head(n_lat, n_lon)
    head.materials = [procedural.default_head_material(256)]
    cam = Camera()
    cam.set_eye(math3d.vec3(0, 0.4, 2.6))
    cam.set_target(math3d.vec3(0, 0, 0))
    cam.set_fov(60.0)
    cam.set_aspect(width / height)
    cam.set_clipping(0.1, 50.0)
    scene = Scene(camera=cam, width=width, height=height)
    scene.add(head, math3d.identity4(), shader_obj, name="head")
    return scene
