"""Command-line front end of the PyTorch port (main.cpp:469-807).

    python -m tinyrenderder_tpu_torch.cli [model] --device cuda|cpu \\
        [--width W] [--height H] [--outdir DIR] [--no-cull] [--no-ssao] \\
        [--image-only]

Counterpart of ``tinyrenderder_tpu.cli`` on the port: the same default
scene (``build_default_scene``: Sponza, head, eyes excluded from the
output depth), rendered with exact stats by ``scene.render_scene`` on
``--device``, then z-visualization, SSAO and the composite on the same
device, and the same four TGA files and log lines.  The JAX CLI's
shadow, animation and profiler modes are not ported yet and are refused.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np
import torch

from tinyrenderder_tpu.cli import HEIGHT, WIDTH, build_default_scene
from tinyrenderder_tpu.scene import _cull_passes
from tinyrenderder_tpu.utils import tga
from tinyrenderder_tpu.utils.stats import RenderStats
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.ops import post

log = logging.getLogger("tinyrenderder_tpu_torch.cli")

#: JAX CLI modes the port refuses, and the ROADMAP.md Queue 1 item that ports each
UNPORTED = {"shadows": "item 10", "animate": "item 11", "profile": "item 11"}


def write_rgb(path: str, rgb) -> None:
    """(H, W, 3) uint8 tensor -> TGA file."""
    tga.TGAImage.from_rgb(np.ascontiguousarray(rgb.cpu().numpy())).write_tga_file(path)


def write_gray(path: str, gray) -> None:
    """(H, W) uint8 tensor -> grey TGA file."""
    write_rgb(path, gray[..., None].expand(*gray.shape, 3))


def run(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="tinyrenderder_tpu_torch — the renderer on PyTorch/CUDA")
    parser.add_argument("model", nargs="?", default=None,
                        help="head model path override (reference argv[1])")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                        help="cuda: the hand-written kernels on the GPU; "
                             "cpu: their plain PyTorch versions")
    parser.add_argument("--width", type=int, default=WIDTH)
    parser.add_argument("--height", type=int, default=HEIGHT)
    parser.add_argument("--outdir", default=".")
    parser.add_argument("--no-cull", action="store_true",
                        help="disable per-model frustum culling")
    parser.add_argument("--no-ssao", action="store_true")
    parser.add_argument("--image-only", action="store_true",
                        help="write ONLY phong.tga")
    parser.add_argument("--shadows", action="store_true", help="not ported yet")
    parser.add_argument("--animate", type=int, default=0, metavar="N",
                        help="not ported yet")
    parser.add_argument("--profile", action="store_true", help="not ported yet")
    parser.add_argument("-v", "--verbose", action="store_true")
    args = parser.parse_args(argv)
    for flag, item in UNPORTED.items():
        if getattr(args, flag):
            parser.error(f"--{flag} is not ported to tinyrenderder_tpu_torch yet "
                         f"(ROADMAP.md Queue 1 {item})")
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")

    logging.basicConfig(level=logging.DEBUG if args.verbose else logging.INFO,
                        format="%(message)s")
    log.info("=== tinyrenderder_tpu_torch: renderer with ModelManager and "
             "frustum culling ===")
    scene = build_default_scene(args.model, args.width, args.height)
    log.info("%s", scene.describe())
    scene.camera.print_info()
    return _render_and_write(args, scene)


def _render_and_write(args, scene) -> int:
    t0 = time.perf_counter()
    cull = not args.no_cull
    os.makedirs(args.outdir, exist_ok=True)
    if args.image_only:
        # a fully culled scene must not clobber an earlier phong.tga
        if not _cull_passes(scene, cull, RenderStats()):
            log.warning("every model culled — phong.tga not written")
            return 0
        image = tscene.render_scene_image(scene, args.device, cull)
        write_rgb(os.path.join(args.outdir, "phong.tga"), image)
        log.info("Render time: %.3f s (%s, image-only)",
                 time.perf_counter() - t0, args.device)
        log.info("Saved: phong.tga")
        return 0

    result = tscene.render_scene(scene, args.device, cull)
    log.info("Render time: %.3f s (%s)", time.perf_counter() - t0, args.device)
    for name, dt in result.pass_timings.items():
        log.info("  pass %-10s %.3f s", name, dt)
    if result.stats.models_rendered > 0:
        write_rgb(os.path.join(args.outdir, "phong.tga"), result.color)
        log.info("Saved: phong.tga")

    if args.no_ssao:
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


def main() -> None:
    sys.exit(run())


if __name__ == "__main__":
    main()
