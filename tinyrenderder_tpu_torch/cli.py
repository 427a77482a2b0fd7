"""Command-line front end of the PyTorch port (main.cpp:469-807).

    python -m tinyrenderder_tpu_torch.cli [model] --device cuda|cpu \\
        [--backend tiled|oracle] [--width W] [--height H] [--outdir DIR] \\
        [--no-cull] [--no-ssao] [--image-only] [--shadows [--shadow-size S]] \\
        [--animate N] [--profile]

Counterpart of ``tinyrenderder_tpu.cli`` on the port: the same default
scene (``build_default_scene``: Sponza, head, eyes excluded from the
output depth; deterministic procedural stand-ins where the OBJ assets
are missing; the head from ``model``, any of the formats
``models.manager.load_mesh`` reads), rendered with exact stats by
``Scene.render`` on ``--device``, then z-visualization, SSAO and the
composite on the same device, and the same four TGA files and log lines.
``--backend oracle`` renders on the serial NumPy oracle instead and runs
the NumPy post in float64, as the JAX CLI does (slow; keep frames small).  ``--shadows`` renders
the two-pass shadowed frame from the key light (``shadows.py``) in its
place.  ``--animate N`` renders an N-frame orbit of the scene instead
(``animation.py``, resumable from ``<outdir>/checkpoint.json``);
``--profile`` records a ``torch.profiler`` trace of the render (CPU, and
CUDA on a CUDA device) into ``<outdir>/trace/trace.json``.
"""

from __future__ import annotations

import argparse
import logging
import math
import os
import sys
import time

import numpy as np
import torch

from tinyrenderder_tpu_torch import math3d
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch import shadows
from tinyrenderder_tpu_torch.animation import AnimationConfig, render_animation
from tinyrenderder_tpu_torch.camera import Camera
from tinyrenderder_tpu_torch.models import procedural
from tinyrenderder_tpu_torch.models.manager import ModelManager
from tinyrenderder_tpu_torch.models.mesh import Mesh
from tinyrenderder_tpu_torch.ops import post
from tinyrenderder_tpu_torch.shaders import EyeShader, PhongShader
from tinyrenderder_tpu_torch.utils import tga
from tinyrenderder_tpu_torch.utils.stats import RenderStats

log = logging.getLogger("tinyrenderder_tpu_torch.cli")

# Render constants (main.cpp:26-30)
WIDTH = 1200
HEIGHT = 800
DEFAULT_MODEL_PATH = "obj/african_head/african_head.obj"
EYES_MODEL_PATH = "obj/african_head/african_head_eye_inner.obj"
SPONZA_MODEL_PATH = "obj/sponza/sponza.obj"
#: the default scene's key light (main.cpp:615)
KEY_LIGHT_DIR = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))

def _load_or_procedural(manager: ModelManager, path: str, kind: str,
                        explicit: bool = False) -> Mesh:
    """The model at ``path``, or its procedural stand-in when the file is
    missing (or, unless the user named it, fails to parse)."""
    if os.path.exists(path):
        mesh = manager.load_model(path)
        if mesh is not None:
            return mesh
        if explicit:
            raise SystemExit(f"error: failed to load model: {path}")
        log.warning("%s exists but failed to load — using procedural stand-in", path)
    else:
        log.warning("%s not found — using procedural stand-in", path)
    if kind == "head":
        mesh = procedural.bumpy_head(n_lat=32, n_lon=48)
        mesh.materials = [procedural.default_head_material()]
        return mesh
    if kind == "eyes":
        eyes = procedural.uv_sphere(n_lat=8, n_lon=12, radius=0.12, name="eyes")
        eyes.positions += np.array([0.35, 0.25, 0.8])
        eyes.finalize()
        eyes.materials = [procedural.default_head_material()]
        return eyes
    # the Sponza stand-in: an inward-facing box room that the reference's
    # 0.014 scale (main.cpp:506-507) leaves at ~56 units around the camera;
    # rebuilt without cube()'s outward normals so finalize() derives them
    # from the flipped winding
    out = procedural.cube(size=4000.0)
    room = Mesh(positions=out.positions, faces=out.faces[:, ::-1].copy(),
                uvs=out.uvs, name="sponza_standin").finalize()
    room.materials = [procedural.default_head_material(128)]
    return room


def build_default_scene(head_path: str | None = None, width: int = WIDTH,
                        height: int = HEIGHT,
                        manager: ModelManager | None = None) -> tscene.Scene:
    """The main.cpp default scene: model matrices (main.cpp:506-513),
    camera (main.cpp:585-597), lights (main.cpp:615-617), shader
    assignments (main.cpp:655-657, :688-689, :711-712)."""
    manager = manager or ModelManager.instance()
    head = _load_or_procedural(manager, head_path or DEFAULT_MODEL_PATH, "head",
                               explicit=head_path is not None)
    eyes = _load_or_procedural(manager, EYES_MODEL_PATH, "eyes")
    sponza = _load_or_procedural(manager, SPONZA_MODEL_PATH, "sponza")

    sponza_matrix = math3d.scale_matrix(0.014, 0.014, 0.014)
    head_matrix = (math3d.translation_matrix(0.0, 1.6815, 0.0)
                   @ math3d.rotation_y(-112.82 * math.pi / 180.0))
    eye_matrix = head_matrix

    camera = Camera()
    camera.set_eye(math3d.vec3(-3.4019, 2.2001, 1.8026))
    camera.set_target(math3d.vec3(1.3555, 1.5116, -0.9686))
    camera.set_up(math3d.vec3(0, 1, 0))
    camera.set_fov(70.0)
    camera.set_aspect(width / height)
    camera.set_clipping(0.05, 500.0)

    key_light = KEY_LIGHT_DIR
    fill_light = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
    rim_light = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))

    scene = tscene.Scene(camera=camera, width=width, height=height)
    scene.add(sponza, sponza_matrix,
              PhongShader(key_light, fill_light, rim_light, normal_map_strength=0.5),
              name="sponza")
    scene.add(head, head_matrix, PhongShader(key_light, fill_light, rim_light),
              name="head")
    scene.add(eyes, eye_matrix, EyeShader(key_light, rim_light), name="eyes",
              exclude_from_output_depth=True)
    return scene


def _host(x) -> np.ndarray:
    return np.ascontiguousarray(x.cpu().numpy() if isinstance(x, torch.Tensor) else x)


def write_rgb(path: str, rgb) -> None:
    """(H, W, 3) uint8 tensor or array -> TGA file."""
    tga.TGAImage.from_rgb(_host(rgb)).write_tga_file(path)


def write_gray(path: str, gray) -> None:
    """(H, W) uint8 tensor or array -> grey TGA file."""
    gray = _host(gray)
    write_rgb(path, np.repeat(gray[..., None], 3, axis=-1))


def run(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="tinyrenderder_tpu_torch — the renderer on PyTorch/CUDA")
    parser.add_argument("model", nargs="?", default=None,
                        help="head model path override (reference argv[1]): .obj, "
                             ".ply, .stl, .gltf, .glb, .dae, .fbx or .off")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda: the hand-written kernels on the GPU; "
                             "cpu: their plain PyTorch versions")
    parser.add_argument("--backend", choices=["tiled", "oracle"], default="tiled",
                        help="tiled: the tiled frame on --device; oracle: the serial "
                             "NumPy oracle on the host (slow; keep frames small)")
    parser.add_argument("--width", type=int, default=WIDTH)
    parser.add_argument("--height", type=int, default=HEIGHT)
    parser.add_argument("--outdir", default=".")
    parser.add_argument("--no-cull", action="store_true",
                        help="disable per-model frustum culling")
    parser.add_argument("--no-ssao", action="store_true")
    parser.add_argument("--image-only", action="store_true",
                        help="write ONLY phong.tga")
    parser.add_argument("--shadows", action="store_true",
                        help="two-pass hard shadow mapping from the key light")
    parser.add_argument("--shadow-size", type=int, default=1024)
    parser.add_argument("--animate", type=int, default=0, metavar="N",
                        help="render an N-frame orbit animation "
                             "(resumable via <outdir>/checkpoint.json)")
    parser.add_argument("--profile", action="store_true",
                        help="write a torch.profiler trace to <outdir>/trace")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    if args.backend == "tiled" and args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    if args.backend == "oracle" and args.animate:
        parser.error("--animate renders on the tiled backend")

    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(message)s")
    log.info("=== tinyrenderder_tpu_torch: renderer with ModelManager and "
             "frustum culling ===")
    scene = build_default_scene(args.model, args.width, args.height)
    log.info("%s", scene.describe())
    scene.camera.print_info()

    if args.animate:
        for flag, on in (("--shadows", args.shadows), ("--profile", args.profile)):
            if on:
                log.warning("%s is not supported with --animate and is ignored", flag)
        cfg = AnimationConfig(frames=args.animate, device=args.device, outdir=args.outdir,
                              frustum_cull=not args.no_cull)
        summary = render_animation(scene, cfg)
        log.info("animation: %d frames in %.1f s (%.2f fps), resumed at %d",
                 summary["frames_rendered"], summary["seconds"], summary["fps"],
                 summary["resumed_at"])
        return 0

    profiler = None
    if args.profile:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if args.device == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
    try:
        return _render_and_write(args, scene)
    finally:
        # finalize the trace even when the render raises: the trace of a
        # failing run is exactly the artifact worth keeping
        if profiler is not None:
            profiler.__exit__(None, None, None)
            trace_dir = os.path.join(args.outdir, "trace")
            os.makedirs(trace_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
            log.info("Saved profiler trace to %s", trace_dir)


def _render_and_write(args, scene) -> int:
    t0 = time.perf_counter()
    cull = not args.no_cull
    os.makedirs(args.outdir, exist_ok=True)
    if args.image_only:
        if args.shadows:
            log.warning("--shadows is not supported with --image-only and is ignored")
        # a fully culled scene must not clobber an earlier phong.tga
        if not tscene._cull_passes(scene, cull, RenderStats()):
            log.warning("every model culled — phong.tga not written")
            return 0
        image = scene.render_image(args.device, cull, backend=args.backend)
        write_rgb(os.path.join(args.outdir, "phong.tga"), image)
        log.info("Render time: %.3f s (%s, image-only)",
                 time.perf_counter() - t0, _where(args))
        log.info("Saved: phong.tga")
        return 0

    settings = shadows.ShadowSettings(size=args.shadow_size)
    if args.shadows and args.backend == "oracle":
        result, _ = shadows.oracle_render_with_shadows(scene, KEY_LIGHT_DIR, settings,
                                                       frustum_cull=cull)
    elif args.shadows:
        # the scene's key light: the shadows track it
        result, _ = shadows.render_with_shadows(scene, KEY_LIGHT_DIR, settings, args.device,
                                                frustum_cull=cull)
    else:
        result = scene.render(args.device, cull, backend=args.backend)
    log.info("Render time: %.3f s (%s)", time.perf_counter() - t0, _where(args))
    for name, dt in result.pass_timings.items():
        log.info("  pass %-10s %.3f s", name, dt)
    if result.stats.models_rendered > 0:
        write_rgb(os.path.join(args.outdir, "phong.tga"), result.color)
        log.info("Saved: phong.tga")

    if args.backend == "oracle":
        # the JAX CLI's NumPy post, in float64
        depth = np.asarray(result.depth, dtype=np.float64)
        zimg = post.zbuffer_to_image_np(depth)
        if not args.no_ssao:
            ao_u8 = post.ssao_image_np(post.ssao_map_np(depth))
            final = post.composite_np(result.color, ao_u8)
    elif args.no_ssao:
        # the JAX CLI normalizes depth in float64 on this path
        zimg = post.zbuffer_to_image(result.depth.to(torch.float64))
    else:
        zimg, ao_u8, final = post.postprocess(result.color, result.depth)
    write_gray(os.path.join(args.outdir, "zbuffer.tga"), zimg)
    log.info("Saved: zbuffer.tga")
    if not args.no_ssao:
        write_gray(os.path.join(args.outdir, "ao.tga"), ao_u8)
        log.info("Saved: ao.tga")
        if result.stats.models_rendered > 0:
            write_rgb(os.path.join(args.outdir, "final.tga"), final)
            log.info("Saved: final.tga")

    log.info("%s", result.stats.describe())
    log.info("%s", result.stats.culling_report())
    return 0


def _where(args) -> str:
    return "oracle" if args.backend == "oracle" else args.device


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
