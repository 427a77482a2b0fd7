#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: the single-pass image route,
the multi-pass tiled frame with exact stats, the post pass and the CLI.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. the card: ``nvidia-smi`` name and power limit (alone on the first
     line), torch's device name;
  2. the kernel build from ``tinyrenderder_tpu_torch/csrc`` with nvcc;
  3. each kernel against its plain PyTorch version on the card, bitwise:
     the coarse raster and the single-plane untile at the headline
     shapes (2048², 32-row tiles, Phong with 8 varyings); the
     three-plane untile on the tiled 3-pass frame at 2048² and at ragged
     1200x800; the raster's event planes on the room pass of the 3-pass
     scene at 2048², rendered after the head (so its running depth is
     not all +inf), which must also leave depth, winner and varyings as
     the launch without stats does;
  4. the image route end to end through ``scene.render_scene_image`` on
     the headline scene (the 27,360-face bumpy head, normal-mapped
     Phong, 2048²): every kernel of the route must have launched, and the
     image must equal the float32 NumPy oracle bitwise;
  5. CUDA-event timing of that route on pre-uploaded inputs (3 warm-up
     frames, median of 20): the kernel route and the plain-PyTorch
     route, per stage;
  6. the tiled frame through ``scene.render_scene`` with exact stats, on
     the bench's 3-pass scene (eyes excluded in the middle) and the CLI's
     default scene (eyes excluded last), both 1200x800: colour, output
     depth and full depth bitwise equal to the float32 oracle, equal
     ``RenderStats``, the same frame without stats, and every kernel of
     the route launched;
  7. the port's CLI at 1200x800 on the card: its four TGA files must
     equal, byte for byte, those written from the oracle's colour and the
     JAX package's NumPy post on the oracle's depth;
  8. CUDA-event timing (3 warm-up frames, median of 20) of the reference
     pipeline (the 3-pass scene at 1200x800 plus the post pass) and of
     the 3-pass frame at 2048², kernel route and plain route, per stage.

The line before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

DEVICE = "cuda"
WIDTH = HEIGHT = 2048                 # the headline and the large 3-pass frame
REF_W, REF_H = 1200, 800              # the reference's default frame (main.cpp:26-27)
FRAME_SIZES = ((WIDTH, HEIGHT), (REF_W, REF_H))   # the 3-pass frame's two sizes
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
    init = torch.full((pre.n_active, th, TILE_W), torch.inf, device=DEVICE)
    _, winner_c, vary_c = raster(pre.tri_rec, pre.sorted_tri, pre.ids, pre.start,
                                 pre.counts, init, ntx, th, TILE_W, n_vary)
    mark()
    c_img = rs.shade_compact_fresh(winner_c, vary_c, uniforms, shader)
    mark()
    img = rs.compact_to_image(c_img, pre.ids, ntx, nty, th, TILE_W, untile=untile)
    image = rs.unpack_rgb(img[:HEIGHT, :WIDTH])
    mark()
    return image


def staged_multipass(passes, width, height, raster, untile3, untile_one,
                     with_post, marks=None):
    """One tiled frame from its stage functions (the bodies of
    ``raster_sparse.render_frame_fused`` and ``scene.render_passes``),
    plus the post pass when ``with_post``; with ``marks`` it appends
    (stage, CUDA event) after each stage, the stage naming the interval
    that ends at the event."""
    import torch

    from tinyrenderder_tpu_torch.ops import post
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    def mark(stage):
        if marks is not None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((stage, e))

    th = rs.pick_tile_h(width, height)
    ntx, nty = cdiv(width, TILE_W), cdiv(height, th)
    mark(None)
    ft = rs.new_frame_tiles(width, height, DEVICE, th)
    snapshot, in_excluded, offset = None, False, 0
    for attrs, shader, uniforms, exclude in passes:
        if exclude:
            if not in_excluded:
                snapshot, in_excluded = ft.depth.clone(), True
        elif in_excluded:
            ft, in_excluded = ft._replace(depth=snapshot), False
        pre = rs.pre_sparse(attrs, uniforms, shader, width, height, th, TILE_W)
        mark("pre")
        d_c, w_c, v_c = raster(pre.tri_rec, pre.sorted_tri, pre.ids, pre.start,
                               pre.counts, ft.depth[pre.ids.long()], ntx, th, TILE_W,
                               sum(shader.varying_spec.values()))
        mark("raster")
        rs.post_sparse(ft, pre.ids, d_c, w_c, v_c, uniforms, shader, offset)
        mark("merge+shade")
        offset += attrs["position"].shape[0]
    color, depth, _ = untile3(*ft, ntx, nty, th, TILE_W)
    if in_excluded:
        depth = untile_one(snapshot, ntx, nty, th, TILE_W)
    image, depth = rs.unpack_rgb(color[:height, :width]), depth[:height, :width]
    mark("untile")
    if not with_post:
        return image, depth
    final = post.postprocess(image, depth)[2]
    mark("post")
    return image, depth, final


def stage_medians(run, stage_names):
    """Median ms per stage over FRAMES frames after WARMUP, from ``run(marks)``."""
    per = {s: [] for s in stage_names}
    for i in range(WARMUP + FRAMES):
        marks = []
        run(marks)
        marks[-1][1].synchronize()
        if i < WARMUP:
            continue
        frame = dict.fromkeys(stage_names, 0.0)
        for (_, e0), (stage, e1) in zip(marks, marks[1:]):
            frame[stage] += e0.elapsed_time(e1)
        for k, v in frame.items():
            per[k].append(v)
    return {k: statistics.median(v) for k, v in per.items()}


def launch_counts():
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    return {"coarse_raster": rc.LAUNCHES, "coarse_raster_stats": rc.STATS_LAUNCHES,
            "untile_one": rs.LAUNCHES, "untile3": rs.UNTILE3_LAUNCHES}


def reset_counts():
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    rc.LAUNCHES = rc.STATS_LAUNCHES = rs.LAUNCHES = rs.UNTILE3_LAUNCHES = 0


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one GPU")

    from tinyrenderder_tpu_torch import _build  # fails outside a checkout
    from tinyrenderder_tpu_torch import cli
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.ops import post
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    # ---- 1. the card ----
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    say(smi)
    say(f"[1 card] nvidia-smi: {smi} | torch: {kind} x{torch.cuda.device_count()} "
        f"| torch {torch.__version__} cuda {torch.version.cuda} | numpy {np.__version__}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    say(f"[2 build] {time.perf_counter() - t0:.2f} s (nvcc {_build.BUILD_SECONDS:.2f} s, "
        f"one process per source) -> {lib.name}")
    for ln in ptxas:
        say(f"    ptxas: {ln}")

    # ---- 3. kernels against their plain versions at the headline shapes ----
    scene = tscene.headline_scene(WIDTH, HEIGHT, "phong")
    attrs, shader, uniforms, _ = tscene.pass_tensors(scene, DEVICE)[0]
    th = rs.pick_tile_h(WIDTH, HEIGHT)
    ntx, nty = cdiv(WIDTH, TILE_W), cdiv(HEIGHT, th)
    n_vary = sum(shader.varying_spec.values())
    pre = rs.pre_sparse(attrs, uniforms, shader, WIDTH, HEIGHT, th, TILE_W)
    init = torch.full((pre.n_active, th, TILE_W), torch.inf, device=DEVICE)
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
    tiles = torch.zeros((ntx * nty, th, TILE_W), dtype=torch.int32, device=DEVICE)
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

    # the three-plane untile on the tiled 3-pass frame, both sizes
    mm_passes = {size: tscene.pass_tensors(tscene.multimesh_scene(*size), DEVICE)
                 for size in FRAME_SIZES}
    untile3_err, untile3_ms = 0.0, {}
    for (w, h), passes in mm_passes.items():
        th3 = rs.pick_tile_h(w, h)
        n3 = (cdiv(w, TILE_W), cdiv(h, th3), th3, TILE_W)
        ft, _, _ = rs.render_frame_fused(passes, w, h, DEVICE, tile_h=th3)
        got = rs.untile3(*ft, *n3)
        want = rs.untile3_plain(*ft, *n3)
        torch.cuda.synchronize()
        for name, a, b in zip(("colour", "depth", "winner"), got, want):
            diff, err = bits_equal(a, b)
            untile3_err = max(untile3_err, err)
            if diff:
                fail(f"untile3 {name} at {w}x{h}: {diff} words differ from the plain version")
        untile3_ms[(w, h)] = (event_ms(lambda: rs.untile3(*ft, *n3)),
                              event_ms(lambda: rs.untile3_plain(*ft, *n3)))
        say(f"[3 untile3] {w}x{h}: kernel == plain bitwise (3 planes of {n3[0] * n3[1]} "
            f"{th3}x{TILE_W} tiles, {3 * ft.color.numel() * 4 / 1e6:.1f} MB); kernel "
            f"{untile3_ms[(w, h)][0]:.4f} ms, plain (3x permute + contiguous) "
            f"{untile3_ms[(w, h)][1]:.4f} ms")

    # the event planes on the room pass, rendered after the head
    w, h = FRAME_SIZES[0]
    th3 = rs.pick_tile_h(w, h)
    head_pass, _, (r_attrs, r_shader, r_uniforms, _) = mm_passes[(w, h)]
    ft, _, _ = rs.render_frame_fused([head_pass], w, h, DEVICE, tile_h=th3)
    pre_r = rs.pre_sparse(r_attrs, r_uniforms, r_shader, w, h, th3, TILE_W)
    init_r = ft.depth[pre_r.ids.long()]
    args_r = (pre_r.tri_rec, pre_r.sorted_tri, pre_r.ids, pre_r.start, pre_r.counts,
              init_r, cdiv(w, TILE_W), th3, TILE_W, sum(r_shader.varying_spec.values()))
    ks = rc.coarse_raster(*args_r, collect_stats=True)
    ps = rc.coarse_raster_plain(*args_r, collect_stats=True)
    k0 = rc.coarse_raster(*args_r)
    torch.cuda.synchronize()
    stats_err = 0.0
    names = ("depth", "winner", "varyings", "event count", "event max z")
    for name, a, b in zip(names, (*ks[:3], *ks[3]), (*ps[:3], *ps[3])):
        diff, err = bits_equal(a, b)
        stats_err = max(stats_err, err)
        if diff:
            fail(f"coarse raster with stats, {name}: {diff} elements differ from the "
                 f"plain version (max abs err {err})")
    for name, a, b in zip(names, ks[:3], k0):
        if bits_equal(a, b)[0]:
            fail(f"coarse raster {name} differs with and without the event planes")
    finite_init = int(torch.isfinite(init_r).sum())
    n_events = int(ks[3][0].sum())
    if not finite_init or not n_events:
        fail(f"room pass: {finite_init} finite init depths, {n_events} events")
    stats_ms = event_ms(lambda: rc.coarse_raster(*args_r, collect_stats=True))
    stats_plain_ms = event_ms(lambda: rc.coarse_raster_plain(*args_r, collect_stats=True))
    nostats_ms = event_ms(lambda: rc.coarse_raster(*args_r))
    say(f"[3 raster stats] room pass after the head at {w}x{h} (active {pre_r.n_active}, "
        f"pairs {pre_r.total}, {finite_init} finite init depths, {n_events} events): "
        f"kernel == plain bitwise (depth, winner, varyings, both event planes), and "
        f"== the launch without stats; kernel {stats_ms:.4f} ms, plain {stats_plain_ms:.4f} "
        f"ms; the same pass without stats {nostats_ms:.4f} ms")

    # ---- 4. the image route end to end, counted ----
    reset_counts()
    image = tscene.render_scene_image(scene, DEVICE)
    torch.cuda.synchronize()
    launches = launch_counts()
    say(f"[4 route] render_scene_image -> {tuple(image.shape)} {image.dtype} on "
        f"{image.device}; launches {launches}")
    if not (launches["coarse_raster"] and launches["untile_one"]):
        fail(f"a kernel of the route never launched: {launches}")
    if tuple(image.shape) != (HEIGHT, WIDTH, 3) or image.dtype != torch.uint8:
        fail(f"image is {tuple(image.shape)} {image.dtype}")
    t0 = time.perf_counter()
    ref = tscene.oracle_render(scene)
    oracle_s = time.perf_counter() - t0
    got = image.cpu().numpy()
    bad = (got != ref.color).any(axis=-1)
    n_bad = int(bad.sum())
    covered = int(np.isfinite(ref.full_depth).sum())
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

    # ---- 6. the tiled frame with exact stats, against the oracle ----
    frames = {"multimesh": tscene.multimesh_scene(REF_W, REF_H),
              "cli_default": cli.build_default_scene(width=REF_W, height=REF_H)}
    reset_counts()
    results = {name: (tscene.render_scene(sc, DEVICE, collect_stats=True),
                      tscene.render_scene(sc, DEVICE, collect_stats=False))
               for name, sc in frames.items()}
    torch.cuda.synchronize()
    frame_launches = launch_counts()
    say(f"[6 frame] render_scene at {REF_W}x{REF_H} on {list(frames)}; launches {frame_launches}")
    if not all(frame_launches.values()):
        fail(f"a kernel of the tiled frame never launched: {frame_launches}")
    oracles = {}
    for name, sc in frames.items():
        r, r0 = results[name]
        t0 = time.perf_counter()
        ref = oracles[name] = tscene.oracle_render(sc)
        oracle_s = time.perf_counter() - t0
        for plane in ("color", "depth", "full_depth"):
            got, want = getattr(r, plane), getattr(ref, plane)
            diff, err = bits_equal(got.cpu(), torch.from_numpy(np.ascontiguousarray(want)))
            if diff:
                fail(f"{name} {plane}: {diff} elements differ from the f32 oracle "
                     f"(max abs err {err})")
            if not torch.equal(getattr(r0, plane), got):
                fail(f"{name} {plane} differs between the frames with and without stats")
        if r.stats != ref.stats:
            fail(f"{name} stats differ from the oracle's:\n  port   {r.stats}\n"
                 f"  oracle {ref.stats}")
        excluded = int((r.depth != r.full_depth).sum())
        say(f"[6 oracle] {name}: colour, depth and full depth == float32 oracle bitwise "
            f"({int(torch.isfinite(r.full_depth).sum())} covered, {excluded} pixels where "
            f"the output depth drops the excluded pass), stats equal "
            f"({r.stats.describe()}), the frame without stats equal "
            f"(oracle {oracle_s:.1f} s on the host)")

    # ---- 7. the CLI, against the oracle + NumPy post ----
    with tempfile.TemporaryDirectory() as tmp:
        out, want_dir = Path(tmp) / "port", Path(tmp) / "oracle"
        want_dir.mkdir()
        reset_counts()
        code = cli.run(["--device", DEVICE, "--width", str(REF_W), "--height", str(REF_H),
                        "--outdir", str(out)])
        torch.cuda.synchronize()
        cli_launches = launch_counts()
        if code != 0:
            fail(f"the CLI exited {code}")
        ref = oracles["cli_default"]
        zimg, ao_u8, final = post.oracle_post(ref.color, ref.depth)
        cli.write_rgb(str(want_dir / "phong.tga"), torch.from_numpy(ref.color))
        cli.write_gray(str(want_dir / "zbuffer.tga"), torch.from_numpy(zimg))
        cli.write_gray(str(want_dir / "ao.tga"), torch.from_numpy(ao_u8))
        cli.write_rgb(str(want_dir / "final.tga"), torch.from_numpy(final))
        sizes = {}
        for f in ("phong.tga", "zbuffer.tga", "ao.tga", "final.tga"):
            got_b, want_b = (out / f).read_bytes(), (want_dir / f).read_bytes()
            if got_b != want_b:
                fail(f"CLI {f} differs from the oracle + NumPy post file")
            sizes[f] = len(got_b)
    if not (cli_launches["coarse_raster_stats"] and cli_launches["untile3"]
            and cli_launches["untile_one"]):
        fail(f"a kernel of the CLI's frame never launched: {cli_launches}")
    say(f"[7 cli] tinyrenderder_tpu_torch.cli {REF_W}x{REF_H} on {DEVICE}: 4 TGAs "
        f"byte-identical to the f32 oracle + NumPy post ({sizes}); launches {cli_launches}")

    # ---- 8. timing of the 3-pass frame on pre-uploaded inputs ----
    plain_fns = (rc.coarse_raster_plain, rs.untile3_plain,
                 lambda *a: rs.untile_one_plain(*a).contiguous())
    kernel_fns = (rc.coarse_raster, rs.untile3, rs.untile_one)
    frame_stages = ("pre", "raster", "merge+shade", "untile")
    cells = {f"reference_pipeline_{REF_W}x{REF_H}": ((REF_W, REF_H), True),
             f"multimesh_frame_{WIDTH}x{HEIGHT}": ((WIDTH, HEIGHT), False)}
    for cell, ((w, h), with_post) in cells.items():
        passes = mm_passes[(w, h)]

        def kernel_run():
            fb, depth, _ = tscene.render_passes(passes, w, h, DEVICE)
            return post.postprocess(fb.color, depth)[2] if with_post else fb.color

        want_img = kernel_run()
        for route, fns in (("kernel", kernel_fns), ("plain", plain_fns)):
            got_img = staged_multipass(passes, w, h, *fns, with_post)[-1 if with_post else 0]
            if not torch.equal(got_img, want_img):
                fail(f"{cell}: the staged {route} frame differs from render_passes")
        names = frame_stages + (("post",) if with_post else ())
        for route, fns in (("kernel", kernel_fns), ("plain", plain_fns)):
            ms = event_ms(kernel_run if route == "kernel" else
                          lambda: staged_multipass(passes, w, h, *fns, with_post))
            st = stage_medians(lambda m: staged_multipass(passes, w, h, *fns, with_post, m),
                               names)
            say(f"[8 timing] {cell} {route} route: {ms:.3f} ms/frame, "
                f"{w * h / ms / 1e3:.1f} Mpix/s; stages ms: "
                + " ".join(f"{k} {v:.3f}" for k, v in st.items())
                + f" | {len(passes)} passes, one readback each | {smi}")

    if "jax" in sys.modules:
        fail("jax was imported")
    total = {k: launches[k] + frame_launches[k] + cli_launches[k] for k in launches}
    big = FRAME_SIZES[0]
    record = {"kernels": [
        {"name": "coarse_raster", "route": "cuda",
         "source": "tinyrenderder_tpu_torch/csrc/raster_coarse.cu",
         "replaces": "tinyrenderder_tpu/ops/raster_pallas.py:109",
         "launches": total["coarse_raster"], "max_abs_err": raster_err,
         "ms": raster_ms, "plain_ms": raster_plain_ms},
        {"name": "coarse_raster_stats", "route": "cuda",
         "source": "tinyrenderder_tpu_torch/csrc/raster_coarse.cu",
         "replaces": "tinyrenderder_tpu/ops/raster_pallas.py:109",
         "launches": total["coarse_raster_stats"], "max_abs_err": stats_err,
         "ms": stats_ms, "plain_ms": stats_plain_ms},
        {"name": "untile_one", "route": "cuda",
         "source": "tinyrenderder_tpu_torch/csrc/untile.cu",
         "replaces": "tinyrenderder_tpu/ops/raster_sparse.py:194",
         "launches": total["untile_one"], "max_abs_err": untile_err,
         "ms": untile_ms, "plain_ms": untile_plain_ms},
        {"name": "untile3", "route": "cuda",
         "source": "tinyrenderder_tpu_torch/csrc/untile.cu",
         "replaces": "tinyrenderder_tpu/ops/raster_sparse.py:150",
         "launches": total["untile3"], "max_abs_err": untile3_err,
         "ms": untile3_ms[big][0], "plain_ms": untile3_ms[big][1]},
    ]}
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
