#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's single-pass image route on one GPU.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. the card: ``nvidia-smi`` name and power limit (alone on the first
     line), torch's device name;
  2. the kernel build from ``tinyrenderder_tpu_torch/csrc`` with nvcc;
  3. each kernel against its plain PyTorch version on the card, at the
     headline shapes (2048², 32-row tiles, Phong with 8 varyings):
     depth, winner, varyings and the untiled image must be bitwise equal;
  4. the route end to end through ``scene.render_scene_image`` on the
     headline scene (the 27,360-face bumpy head, normal-mapped Phong,
     2048²): every kernel of the route must have launched, and the
     image must equal the float32 NumPy oracle bitwise;
  5. CUDA-event timing on pre-uploaded inputs (3 warm-up frames, median
     of 20): the kernel route and the plain-PyTorch route, per stage.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

WIDTH = HEIGHT = 2048
WARMUP, FRAMES = 3, 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, warmup: int = WARMUP, reps: int = FRAMES) -> float:
    """Median CUDA-event time of ``fn`` in ms."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def bits_equal(a, b) -> tuple[int, float]:
    """(elements whose bits differ, max |a - b| over finite pairs)."""
    import torch
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype {tuple(a.shape)} {a.dtype} != {tuple(b.shape)} {b.dtype}")
    if a.dtype == torch.float32:
        diff = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        both = torch.isfinite(a) & torch.isfinite(b)
        err = float((a[both] - b[both]).abs().max()) if bool(both.any()) else 0.0
        return diff, err
    diff = int((a != b).sum())
    err = float((a.long() - b.long()).abs().max()) if a.numel() else 0.0
    return diff, err


def staged_frame(attrs, shader, uniforms, th, raster, untile, marks=None):
    """One frame of the route from its stage functions (the body of
    ``raster_sparse.render_frame_fused_image``), recording a CUDA event
    after each stage when ``marks`` is given."""
    import torch

    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    def mark():
        if marks is not None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append(e)

    ntx, nty = cdiv(WIDTH, TILE_W), cdiv(HEIGHT, th)
    n_vary = sum(shader.varying_spec.values())
    mark()
    pre = rs.pre_sparse(attrs, uniforms, shader, WIDTH, HEIGHT, th, TILE_W)
    mark()
    init = torch.full((pre.n_active, th, TILE_W), torch.inf, device="cuda")
    _, winner_c, vary_c = raster(pre.tri_rec, pre.sorted_tri, pre.ids, pre.start,
                                 pre.counts, init, ntx, th, TILE_W, n_vary)
    mark()
    c_img = rs.shade_compact_fresh(winner_c, vary_c, uniforms, shader)
    mark()
    img = rs.compact_to_image(c_img, pre.ids, ntx, nty, th, TILE_W, untile=untile)
    image = rs.unpack_rgb(img[:HEIGHT, :WIDTH])
    mark()
    return image


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one GPU")

    from tinyrenderder_tpu_torch import _build  # fails outside a checkout
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    # ---- 1. the card ----
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say(smi)
    say(f"[1 card] nvidia-smi: {smi} | torch: {kind} x{torch.cuda.device_count()} "
        f"| torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    say(f"[2 build] {time.perf_counter() - t0:.2f} s (nvcc {_build.BUILD_SECONDS:.2f} s) "
        f"-> {lib.name}")
    for ln in ptxas:
        say(f"    ptxas: {ln}")

    # ---- 3. kernels against their plain versions at the headline shapes ----
    scene = tscene.headline_scene(WIDTH, HEIGHT, "phong")
    attrs, shader, uniforms, _ = tscene.pass_tensors(scene, "cuda")
    th = rs.pick_tile_h(WIDTH, HEIGHT)
    ntx, nty = cdiv(WIDTH, TILE_W), cdiv(HEIGHT, th)
    n_vary = sum(shader.varying_spec.values())
    pre = rs.pre_sparse(attrs, uniforms, shader, WIDTH, HEIGHT, th, TILE_W)
    init = torch.full((pre.n_active, th, TILE_W), torch.inf, device="cuda")
    args = (pre.tri_rec, pre.sorted_tri, pre.ids, pre.start, pre.counts, init,
            ntx, th, TILE_W, n_vary)
    say(f"[3 shapes] faces {attrs['position'].shape[0]}, th {th}, tiles {ntx * nty}, "
        f"active {pre.n_active}, pairs {pre.total}, V {n_vary}, "
        f"max bin {int(pre.counts.max())}")
    kd, kw, kv = rc.coarse_raster(*args)
    pd, pw, pv = rc.coarse_raster_plain(*args)
    torch.cuda.synchronize()
    raster_err = 0.0
    for name, a, b in (("depth", kd, pd), ("winner", kw, pw), ("varyings", kv, pv)):
        diff, err = bits_equal(a, b)
        raster_err = max(raster_err, err)
        if diff:
            fail(f"coarse raster {name}: {diff} elements differ from the plain "
                 f"version (max abs err {err})")
    raster_ms = event_ms(lambda: rc.coarse_raster(*args))
    raster_plain_ms = event_ms(lambda: rc.coarse_raster_plain(*args))
    say(f"[3 raster] kernel == plain bitwise (depth, winner, {n_vary} varyings); "
        f"kernel {raster_ms:.4f} ms, plain {raster_plain_ms:.4f} ms")

    c_img = rs.shade_compact_fresh(kw, kv, uniforms, shader)
    tiles = torch.zeros((ntx * nty, th, TILE_W), dtype=torch.int32, device="cuda")
    tiles.index_copy_(0, pre.ids.long(), c_img)
    uk = rs.untile_one(tiles, ntx, nty, th, TILE_W)
    up = rs.untile_one_plain(tiles, ntx, nty, th, TILE_W).contiguous()
    torch.cuda.synchronize()
    diff, untile_err = bits_equal(uk, up)
    if diff:
        fail(f"untile: {diff} words differ from the plain version")
    untile_ms = event_ms(lambda: rs.untile_one(tiles, ntx, nty, th, TILE_W))
    untile_plain_ms = event_ms(
        lambda: rs.untile_one_plain(tiles, ntx, nty, th, TILE_W).contiguous())
    say(f"[3 untile] kernel == plain bitwise ({uk.shape[0]}x{uk.shape[1]} int32); "
        f"kernel {untile_ms:.4f} ms, plain (permute + contiguous) {untile_plain_ms:.4f} ms")

    # ---- 4. the route end to end, counted ----
    rc.LAUNCHES = 0
    rs.LAUNCHES = 0
    image = tscene.render_scene_image(scene, "cuda")
    torch.cuda.synchronize()
    launches = {"raster_coarse": rc.LAUNCHES, "untile": rs.LAUNCHES}
    say(f"[4 route] render_scene_image -> {tuple(image.shape)} {image.dtype} on "
        f"{image.device}; launches {launches}")
    if any(n == 0 for n in launches.values()):
        fail(f"a kernel of the route never launched: {launches}")
    if tuple(image.shape) != (HEIGHT, WIDTH, 3) or image.dtype != torch.uint8:
        fail(f"image is {tuple(image.shape)} {image.dtype}")
    t0 = time.perf_counter()
    ref = tscene.oracle_frame(scene)
    oracle_s = time.perf_counter() - t0
    got = image.cpu().numpy()
    bad = (got != ref.color).any(axis=-1)
    n_bad = int(bad.sum())
    covered = int(np.isfinite(ref.zbuffer).sum())
    if n_bad:
        lsb = int(abs(got.astype(int) - ref.color.astype(int)).max())
        first = [tuple(int(v) for v in c) for c in np.argwhere(bad)[:5]]
        fail(f"{n_bad} pixels differ from the f32 oracle (max {lsb} LSB; "
             f"first (y, x): {first})")
    say(f"[4 oracle] image == float32 oracle bitwise: 0 of {WIDTH * HEIGHT} pixels "
        f"differ, {covered} covered (oracle {oracle_s:.1f} s on the host)")

    # ---- 5. timing on pre-uploaded inputs ----
    def kernel_frame():
        return rs.render_frame_fused_image([(attrs, shader, uniforms, False)],
                                           WIDTH, HEIGHT, tile_h=th)

    routes = {"kernel": (rc.coarse_raster, rs.untile_one),
              "plain": (rc.coarse_raster_plain,
                        lambda *a: rs.untile_one_plain(*a).contiguous())}
    for route, fns in routes.items():      # the staged copy has not drifted
        if not torch.equal(staged_frame(attrs, shader, uniforms, th, *fns), image):
            fail(f"the staged {route} frame differs from render_scene_image")
    frame_ms = {"kernel": event_ms(kernel_frame),
                "plain": event_ms(lambda: staged_frame(attrs, shader, uniforms, th,
                                                       *routes["plain"]))}
    stage_names = ("pre", "raster", "shade", "placement")
    stages = {}
    for route, (raster, untile) in routes.items():
        per = {s: [] for s in stage_names}
        for i in range(WARMUP + FRAMES):
            marks = []
            staged_frame(attrs, shader, uniforms, th, raster, untile, marks)
            marks[-1].synchronize()
            if i >= WARMUP:
                for s, e0, e1 in zip(stage_names, marks, marks[1:]):
                    per[s].append(e0.elapsed_time(e1))
        stages[route] = {s: statistics.median(v) for s, v in per.items()}
    for route in routes:
        ms = frame_ms[route]
        st = " ".join(f"{s} {v:.3f}" for s, v in stages[route].items())
        say(f"[5 timing] {route} route: {ms:.3f} ms/frame, "
            f"{WIDTH * HEIGHT / ms / 1e3:.1f} Mpix/s (screen pixels); "
            f"stages ms: {st} | {smi}")

    if "jax" in sys.modules:
        fail("jax was imported")
    record = {"kernels": [
        {"name": "coarse_raster", "route": "cuda",
         "source": "tinyrenderder_tpu_torch/csrc/raster_coarse.cu",
         "replaces": "tinyrenderder_tpu/ops/raster_pallas.py:109",
         "launches": launches["raster_coarse"], "max_abs_err": raster_err,
         "ms": raster_ms, "plain_ms": raster_plain_ms},
        {"name": "untile_one", "route": "cuda",
         "source": "tinyrenderder_tpu_torch/csrc/untile.cu",
         "replaces": "tinyrenderder_tpu/ops/raster_sparse.py:194",
         "launches": launches["untile"], "max_abs_err": untile_err,
         "ms": untile_ms, "plain_ms": untile_plain_ms},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
