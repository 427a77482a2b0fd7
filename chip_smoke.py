#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: the single-pass image route and
the multi-pass tiled frame with exact stats, each on the coarse and on the
strip raster, the post pass and the CLI.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. the card: ``nvidia-smi`` name and power limit (alone on the first
     line), torch's device name;
  2. the kernel build from ``tinyrenderder_tpu_torch/csrc`` with nvcc;
  3. each kernel against its plain PyTorch version on the card, bitwise:
     the coarse and the strip raster and the single-plane untile at the
     headline shapes (2048², 32-row tiles, Phong with 8 varyings); the
     three-plane untile on the tiled 3-pass frame at 2048² and at ragged
     1200x800; the coarse raster's event planes on the room pass of the
     3-pass scene at 2048², rendered after the head, and the strip
     raster's on the head pass, rendered after the room (so each running
     depth is not all +inf); each stats launch must also leave depth,
     winner and varyings as the launch without stats does.  Each kernel's
     time, its plain version's, the library call's where one PyTorch call
     computes the same function, and its bound (bytes over 3.35 TB/s or
     float operations over 67 TFLOP/s, from this run's data);
  4. the image route end to end through ``scene.render_scene_image`` on
     the headline scene (the 27,360-face bumpy head, normal-mapped Phong,
     2048²) under ``FINE_MODE = "fine"`` and ``"coarse"``: every kernel of
     each route must have launched, and both images must equal the
     float32 NumPy oracle bitwise;
  5. CUDA-event timing (3 warm-up frames, median of 20) on pre-uploaded
     inputs, coarse against fine: the headline (kernel and plain routes,
     per stage), the Gouraud head at 800², and the headline head at three
     tessellations (its strip rows against its coarse pairs);
  6. the tiled frame through ``scene.render_scene`` with exact stats, on
     the bench's 3-pass scene (eyes excluded in the middle) and the CLI's
     default scene (eyes excluded last), both 1200x800, under "coarse"
     and "fine": colour, output depth and full depth bitwise equal to the
     float32 oracle, equal ``RenderStats``, the same frame without stats,
     and every kernel of the route launched;
  7. the port's CLI at 1200x800 on the card: its four TGA files must
     equal, byte for byte, those written from the oracle's colour and the
     port's NumPy post on the oracle's depth;
  8. CUDA-event timing, coarse against fine, of the reference pipeline
     (the 3-pass scene at 1200x800 plus the post pass) and of the 3-pass
     frame at 2048², kernel route and plain route, per stage.

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
MODES = ("coarse", "fine")
#: the bound's peaks: NVIDIA's H100 SXM data sheet, float32 outside the
#: tensor cores and HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
#: float operations of one raster test of a pixel inside a triangle's bbox
#: (barycentric: 15 products and differences, 1 sum, 3 divisions, 1
#: difference; affine z: 5) and of one winner's varyings (barycentric 20,
#: three 1/w, the perspective denominator 5 and weights 6, then 6 per
#: channel: 3 products, 2 sums and the + 0.0)
OPS_TEST, OPS_WIN, OPS_WIN_PER_VARY = 25, 34, 6


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


def check_outputs(what: str, got, want) -> float:
    """Fail unless every plane of ``got`` equals ``want`` bitwise (event
    planes nested as a pair); returns the max abs error (0.0)."""
    names = ("depth", "winner", "varyings", "event count", "event max z")
    flat = lambda out: (*out[:3], *(out[3] if len(out) > 3 else ()))  # noqa: E731
    worst = 0.0
    for name, a, b in zip(names, flat(got), flat(want)):
        diff, err = bits_equal(a, b)
        worst = max(worst, err)
        if diff:
            fail(f"{what} {name}: {diff} elements differ (max abs err {err})")
    return worst


# ---------------------------------------------------------------------------
# bounds: the least time the card could take, from this run's data
# ---------------------------------------------------------------------------

def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations")."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bbox_tests(tri_rec, tri, tile, x_off, span_w: int, n_tiles_x: int, tile_h: int) -> int:
    """Pixels inside each (triangle, tile-or-strip) pair's integer bbox,
    summed: the raster tests that reach the arithmetic."""
    import torch
    bb = tri_rec[tri.long(), 12:16]
    x0 = ((tile % n_tiles_x) * 128 + x_off).to(torch.float32)
    y0 = (torch.div(tile, n_tiles_x, rounding_mode="floor") * tile_h).to(torch.float32)
    nx = (torch.minimum(x0 + (span_w - 1), bb[:, 1]) - torch.maximum(x0, bb[:, 0]) + 1)
    ny = (torch.minimum(y0 + (tile_h - 1), bb[:, 3]) - torch.maximum(y0, bb[:, 2]) + 1)
    return int((nx.clamp(min=0).double() * ny.clamp(min=0).double()).sum())


def raster_bound(kind: str, pre, out, tile_h: int, n_tiles_x: int, n_vary: int,
                 stats: bool) -> tuple[float, str]:
    """The raster's bound: bytes = its inputs (bins or slot table, the
    per-triangle rows, the active tiles' ids/segments, the running depth)
    read once and its (2 + V) output planes (+2 with stats) written once;
    operations = OPS_TEST per pixel inside a visited bbox and the varyings
    of every won pixel."""
    import torch
    a, plane = pre.ids.shape[0], tile_h * 128 * 4
    if kind == "coarse":
        tile = torch.repeat_interleave(pre.ids, pre.counts)
        tests = bbox_tests(pre.tri_rec, pre.sorted_tri, tile, 0, 128, n_tiles_x, tile_h)
        bins_bytes = pre.sorted_tri.numel() * 4
    else:
        slots = pre.tri8.reshape(-1)
        tile = torch.repeat_interleave(pre.ids, pre.rows * 8)
        strip = torch.arange(slots.numel(), device=slots.device) % 8
        live = slots >= 0
        tests = bbox_tests(pre.tri_rec, slots[live], tile[live], strip[live] * 16, 16,
                           n_tiles_x, tile_h)
        bins_bytes = slots.numel() * 4
    won = int((out[1] >= 0).sum())
    n_bytes = (bins_bytes + pre.tri_rec.numel() * 4 + 3 * a * 4 + a * plane
               + a * plane * (2 + n_vary + (2 if stats else 0)))
    ops = tests * OPS_TEST + won * (OPS_WIN + OPS_WIN_PER_VARY * n_vary)
    return bound(n_bytes, ops)


# ---------------------------------------------------------------------------
# the routes from their stage functions
# ---------------------------------------------------------------------------

def raster_stage(mode: str, plain: bool, attrs, shader, uniforms, w: int, h: int,
                 th: int, init_depth, mark):
    """``raster_sparse.raster_pass`` on one route, marking the end of the
    pre-stage and of the raster; -> (ids, (depth, winner, vary))."""
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_fine as rf
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    ntx, n_vary = cdiv(w, TILE_W), sum(shader.varying_spec.values())
    if mode == "fine":
        pre = rf.pre_fine(attrs, uniforms, shader, w, h, th, TILE_W)
        mark("pre")
        fn = rf.fine_raster_plain if plain else rf.fine_raster
        out = fn(pre.tri_rec, pre.tri8, pre.ids, pre.row_start, pre.rows,
                 init_depth(pre.ids), ntx, th, TILE_W, n_vary)
    else:
        pre = rs.pre_sparse(attrs, uniforms, shader, w, h, th, TILE_W)
        mark("pre")
        fn = rc.coarse_raster_plain if plain else rc.coarse_raster
        out = fn(pre.tri_rec, pre.sorted_tri, pre.ids, pre.start, pre.counts,
                 init_depth(pre.ids), ntx, th, TILE_W, n_vary)
    mark("raster")
    return pre.ids, out


def marker(marks):
    """mark(stage): record a CUDA event ending ``stage`` when ``marks`` is a list."""
    import torch

    def mark(stage):
        if marks is not None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((stage, e))
    return mark


def staged_frame(attrs, shader, uniforms, w, h, th, mode, plain, marks=None):
    """One frame of the image route from its stage functions (the body of
    ``raster_sparse.render_frame_fused_image``)."""
    import torch

    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    mark = marker(marks)
    ntx, nty = cdiv(w, TILE_W), cdiv(h, th)
    mark(None)
    ids, (_, winner_c, vary_c) = raster_stage(
        mode, plain, attrs, shader, uniforms, w, h, th,
        lambda ids: torch.full((ids.shape[0], th, TILE_W), torch.inf, device=DEVICE), mark)
    c_img = rs.shade_compact_fresh(winner_c, vary_c, uniforms, shader)
    mark("shade")
    untile = (lambda *a: rs.untile_one_plain(*a).contiguous()) if plain else rs.untile_one
    img = rs.compact_to_image(c_img, ids, ntx, nty, th, TILE_W, untile=untile)
    image = rs.unpack_rgb(img[:h, :w])
    mark("placement")
    return image


def staged_multipass(passes, width, height, mode, plain, with_post, marks=None):
    """One tiled frame from its stage functions (the bodies of
    ``raster_sparse.render_frame_fused`` and ``scene.render_passes``),
    plus the post pass when ``with_post``; with ``marks`` it appends
    (stage, CUDA event) after each stage, the stage naming the interval
    that ends at the event."""
    from tinyrenderder_tpu_torch.ops import post
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    mark = marker(marks)
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
        ids, (d_c, w_c, v_c) = raster_stage(mode, plain, attrs, shader, uniforms, width,
                                            height, th, lambda i: ft.depth[i.long()], mark)
        rs.post_sparse(ft, ids, d_c, w_c, v_c, uniforms, shader, offset)
        mark("merge+shade")
        offset += attrs["position"].shape[0]
    if plain:
        color, depth, _ = rs.untile3_plain(*ft, ntx, nty, th, TILE_W)
    else:
        color, depth, _ = rs.untile3(*ft, ntx, nty, th, TILE_W)
    if in_excluded:
        depth = (rs.untile_one_plain(snapshot, ntx, nty, th, TILE_W).contiguous() if plain
                 else rs.untile_one(snapshot, ntx, nty, th, TILE_W))
    image, depth = rs.unpack_rgb(color[:height, :width]), depth[:height, :width]
    mark("untile")
    if not with_post:
        return image, depth
    final = post.postprocess(image, depth)[2]
    mark("post")
    return image, depth, final


def ab_ms(run) -> dict:
    """ms/frame of ``run(mode)`` per mode, measured in turns (coarse, fine,
    fine, coarse), each turn a median of FRAMES: the mean of a mode's two
    turns."""
    turns = {m: [] for m in MODES}
    for mode in MODES + MODES[::-1]:
        with fine_mode(mode):
            turns[mode].append(event_ms(lambda: run(mode)))
    return {m: statistics.fmean(v) for m, v in turns.items()}


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


class fine_mode:
    """``raster_sparse.FINE_MODE`` set to ``mode`` inside the block."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        from tinyrenderder_tpu_torch.ops import raster_sparse as rs
        self.old, rs.FINE_MODE = rs.FINE_MODE, self.mode

    def __exit__(self, *exc):
        from tinyrenderder_tpu_torch.ops import raster_sparse as rs
        rs.FINE_MODE = self.old


def launch_counts():
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_fine as rf
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    return {"coarse_raster": rc.LAUNCHES, "coarse_raster_stats": rc.STATS_LAUNCHES,
            "fine_raster": rf.LAUNCHES, "fine_raster_stats": rf.STATS_LAUNCHES,
            "untile_one": rs.LAUNCHES, "untile3": rs.UNTILE3_LAUNCHES}


def reset_counts():
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_fine as rf
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    rc.LAUNCHES = rc.STATS_LAUNCHES = rf.LAUNCHES = rf.STATS_LAUNCHES = 0
    rs.LAUNCHES = rs.UNTILE3_LAUNCHES = 0


def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before; -> (result,
    the counts just after)."""
    import torch
    reset_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, launch_counts()


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
    from tinyrenderder_tpu_torch.ops import raster_fine as rf
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    t_start = time.perf_counter()
    record: dict[str, dict] = {}        # kernel name -> its JSON entry
    totals = dict.fromkeys(launch_counts(), 0)

    def add_launches(counts):
        for k, v in counts.items():
            totals[k] += v

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
             if "registers" in ln or "Compiling entry" in ln or "spill" in ln]
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
    pre_f = rf.pre_fine(attrs, uniforms, shader, WIDTH, HEIGHT, th, TILE_W)
    init = torch.full((pre.n_active, th, TILE_W), torch.inf, device=DEVICE)
    init_f = torch.full((pre_f.n_active, th, TILE_W), torch.inf, device=DEVICE)
    args = (pre.tri_rec, pre.sorted_tri, pre.ids, pre.start, pre.counts, init,
            ntx, th, TILE_W, n_vary)
    args_f = (pre_f.tri_rec, pre_f.tri8, pre_f.ids, pre_f.row_start, pre_f.rows, init_f,
              ntx, th, TILE_W, n_vary)
    say(f"[3 shapes] faces {attrs['position'].shape[0]}, th {th}, tiles {ntx * nty}, "
        f"V {n_vary}; coarse: active {pre.n_active}, pairs {pre.total}, max bin "
        f"{int(pre.counts.max())}; strips: active {pre_f.n_active}, pairs {pre_f.pairs}, "
        f"rows {pre_f.row_total}, max rows {int(pre_f.rows.max())}")
    kc = rc.coarse_raster(*args)
    raster_err = check_outputs("coarse raster vs plain", kc, rc.coarse_raster_plain(*args))
    kf = rf.fine_raster(*args_f)
    fine_err = check_outputs("strip raster vs plain", kf, rf.fine_raster_plain(*args_f))
    torch.cuda.synchronize()
    raster_ms, raster_plain_ms = (event_ms(lambda: rc.coarse_raster(*args)),
                                  event_ms(lambda: rc.coarse_raster_plain(*args)))
    fine_ms, fine_plain_ms = (event_ms(lambda: rf.fine_raster(*args_f)),
                              event_ms(lambda: rf.fine_raster_plain(*args_f)))
    coarse_bound = raster_bound("coarse", pre, kc, th, ntx, n_vary, False)
    fine_bound = raster_bound("fine", pre_f, kf, th, ntx, n_vary, False)
    say(f"[3 raster] headline pass: coarse kernel == plain bitwise (depth, winner, "
        f"{n_vary} varyings), kernel {raster_ms:.4f} ms, plain {raster_plain_ms:.4f} ms, "
        f"bound {coarse_bound[0]:.4f} ms ({coarse_bound[1]}) | strip kernel == plain "
        f"bitwise, kernel {fine_ms:.4f} ms, plain {fine_plain_ms:.4f} ms, bound "
        f"{fine_bound[0]:.4f} ms ({fine_bound[1]}); strip/coarse kernel "
        f"{fine_ms / raster_ms:.3f} | {smi}")
    record["coarse_raster"] = {
        "name": "coarse_raster", "route": "cuda",
        "source": "tinyrenderder_tpu_torch/csrc/raster_coarse.cu",
        "replaces": "tinyrenderder_tpu/ops/raster_pallas.py:109",
        "max_abs_err": raster_err, "ms": raster_ms, "plain_ms": raster_plain_ms,
        "bound_ms": coarse_bound[0], "bound_by": coarse_bound[1], "library_ms": None}
    record["fine_raster"] = {
        "name": "fine_raster", "route": "cuda",
        "source": "tinyrenderder_tpu_torch/csrc/raster_fine.cu",
        "replaces": "tinyrenderder_tpu/ops/raster_fine.py:231",
        "max_abs_err": fine_err, "ms": fine_ms, "plain_ms": fine_plain_ms,
        "bound_ms": fine_bound[0], "bound_by": fine_bound[1], "library_ms": None}

    c_img = rs.shade_compact_fresh(kc[1], kc[2], uniforms, shader)
    tiles = torch.zeros((ntx * nty, th, TILE_W), dtype=torch.int32, device=DEVICE)
    tiles.index_copy_(0, pre.ids.long(), c_img)
    uk = rs.untile_one(tiles, ntx, nty, th, TILE_W)
    up = rs.untile_one_plain(tiles, ntx, nty, th, TILE_W).contiguous()
    torch.cuda.synchronize()
    diff, untile_err = bits_equal(uk, up)
    if diff:
        fail(f"untile: {diff} words differ from the plain version")
    untile_ms = event_ms(lambda: rs.untile_one(tiles, ntx, nty, th, TILE_W))
    untile_plain_ms = event_ms(lambda: rs.untile_one_plain(tiles, ntx, nty, th, TILE_W))
    untile_lib_ms = event_ms(lambda: tiles.view(nty, ntx, th, TILE_W)
                             .permute(0, 2, 1, 3).contiguous())
    untile_bound = bound(2 * tiles.numel() * 4, 0)
    say(f"[3 untile] kernel == plain bitwise ({uk.shape[0]}x{uk.shape[1]} int32); "
        f"kernel {untile_ms:.4f} ms, plain {untile_plain_ms:.4f} ms, library "
        f"(permute + contiguous) {untile_lib_ms:.4f} ms, bound {untile_bound[0]:.4f} ms")
    record["untile_one"] = {
        "name": "untile_one", "route": "cuda",
        "source": "tinyrenderder_tpu_torch/csrc/untile.cu",
        "replaces": "tinyrenderder_tpu/ops/raster_sparse.py:194",
        "max_abs_err": untile_err, "ms": untile_ms, "plain_ms": untile_plain_ms,
        "bound_ms": untile_bound[0], "bound_by": untile_bound[1],
        "library_ms": untile_lib_ms}

    # the three-plane untile on the tiled 3-pass frame, both sizes
    mm_passes = {size: tscene.pass_tensors(tscene.multimesh_scene(*size), DEVICE)
                 for size in FRAME_SIZES}
    untile3_err = 0.0
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
        k_ms = event_ms(lambda: rs.untile3(*ft, *n3))
        p_ms = event_ms(lambda: rs.untile3_plain(*ft, *n3))
        lib_ms = event_ms(lambda: [x.view(n3[1], n3[0], th3, TILE_W).permute(0, 2, 1, 3)
                                   .contiguous() for x in ft])
        b3 = bound(2 * 3 * ft.color.numel() * 4, 0)
        say(f"[3 untile3] {w}x{h}: kernel == plain bitwise (3 planes of {n3[0] * n3[1]} "
            f"{th3}x{TILE_W} tiles, {3 * ft.color.numel() * 4 / 1e6:.1f} MB); kernel "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library (3x permute + contiguous) "
            f"{lib_ms:.4f} ms, bound {b3[0]:.4f} ms")
        if (w, h) == FRAME_SIZES[0]:
            record["untile3"] = {
                "name": "untile3", "route": "cuda",
                "source": "tinyrenderder_tpu_torch/csrc/untile.cu",
                "replaces": "tinyrenderder_tpu/ops/raster_sparse.py:150",
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b3[0], "bound_by": b3[1],
                "library_ms": lib_ms}
    record["untile3"]["max_abs_err"] = untile3_err

    # the event planes: the coarse raster on the room pass after the head,
    # the strip raster on the head pass after the room (finite init depths)
    w, h = FRAME_SIZES[0]
    th3 = rs.pick_tile_h(w, h)
    head_pass, _, room_pass = mm_passes[(w, h)]
    with fine_mode("coarse"):
        after_head, _, _ = rs.render_frame_fused([head_pass], w, h, DEVICE, tile_h=th3)
        after_room, _, _ = rs.render_frame_fused([room_pass], w, h, DEVICE, tile_h=th3)
    stats_checks = (
        ("coarse_raster_stats", "coarse", room_pass, after_head,
         "tinyrenderder_tpu_torch/csrc/raster_coarse.cu",
         "tinyrenderder_tpu/ops/raster_pallas.py:109", "room pass after the head"),
        ("fine_raster_stats", "fine", head_pass, after_room,
         "tinyrenderder_tpu_torch/csrc/raster_fine.cu",
         "tinyrenderder_tpu/ops/raster_fine.py:231", "head pass after the room"))
    for name, mode, (p_attrs, p_shader, p_uniforms, _), ft_prior, src, repl, what in stats_checks:
        nv = sum(p_shader.varying_spec.values())
        if mode == "coarse":
            pp = rs.pre_sparse(p_attrs, p_uniforms, p_shader, w, h, th3, TILE_W)
            sargs = (pp.tri_rec, pp.sorted_tri, pp.ids, pp.start, pp.counts,
                     ft_prior.depth[pp.ids.long()], cdiv(w, TILE_W), th3, TILE_W, nv)
            kernel, plain = rc.coarse_raster, rc.coarse_raster_plain
        else:
            pp = rf.pre_fine(p_attrs, p_uniforms, p_shader, w, h, th3, TILE_W)
            sargs = (pp.tri_rec, pp.tri8, pp.ids, pp.row_start, pp.rows,
                     ft_prior.depth[pp.ids.long()], cdiv(w, TILE_W), th3, TILE_W, nv)
            kernel, plain = rf.fine_raster, rf.fine_raster_plain
        ks = kernel(*sargs, collect_stats=True)
        err = check_outputs(f"{name} vs plain", ks, plain(*sargs, collect_stats=True))
        check_outputs(f"{name} vs the launch without stats", ks[:3], kernel(*sargs))
        finite_init = int(torch.isfinite(sargs[5]).sum())
        n_events = int(ks[3][0].sum())
        if not finite_init or not n_events:
            fail(f"{name}: {finite_init} finite init depths, {n_events} events")
        s_ms = event_ms(lambda: kernel(*sargs, collect_stats=True))
        sp_ms = event_ms(lambda: plain(*sargs, collect_stats=True))
        n_ms = event_ms(lambda: kernel(*sargs))
        sb = raster_bound(mode, pp, ks, th3, cdiv(w, TILE_W), nv, True)
        say(f"[3 raster stats] {name}, {what} at {w}x{h} (active {pp.n_active}, "
            f"{finite_init} finite init depths, {n_events} events): kernel == plain "
            f"bitwise (depth, winner, varyings, both event planes), and == the launch "
            f"without stats; kernel {s_ms:.4f} ms, plain {sp_ms:.4f} ms, bound "
            f"{sb[0]:.4f} ms ({sb[1]}); the same pass without stats {n_ms:.4f} ms")
        record[name] = {"name": name, "route": "cuda", "source": src, "replaces": repl,
                        "max_abs_err": err, "ms": s_ms, "plain_ms": sp_ms,
                        "bound_ms": sb[0], "bound_by": sb[1], "library_ms": None}

    # ---- 4. the image route end to end, counted, on both rasters ----
    images = {}
    for mode in MODES:
        with fine_mode(mode):
            images[mode], launches = counted(lambda: tscene.render_scene_image(scene, DEVICE))
        add_launches(launches)
        image = images[mode]
        say(f"[4 route] FINE_MODE={mode!r}: render_scene_image -> {tuple(image.shape)} "
            f"{image.dtype} on {image.device}; launches {launches}")
        if not (launches[f"{mode}_raster"] and launches["untile_one"]):
            fail(f"a kernel of the {mode} route never launched: {launches}")
        if tuple(image.shape) != (HEIGHT, WIDTH, 3) or image.dtype != torch.uint8:
            fail(f"image is {tuple(image.shape)} {image.dtype}")
    t0 = time.perf_counter()
    ref = tscene.oracle_render(scene)
    oracle_s = time.perf_counter() - t0
    covered = int(np.isfinite(ref.full_depth).sum())
    for mode, image in images.items():
        got = image.cpu().numpy()
        bad = (got != ref.color).any(axis=-1)
        if bad.any():
            lsb = int(abs(got.astype(int) - ref.color.astype(int)).max())
            first = [tuple(int(v) for v in c) for c in np.argwhere(bad)[:5]]
            fail(f"{mode}: {int(bad.sum())} pixels differ from the f32 oracle (max {lsb} "
                 f"LSB; first (y, x): {first})")
    say(f"[4 oracle] both images == float32 oracle bitwise: 0 of {WIDTH * HEIGHT} pixels "
        f"differ, {covered} covered (oracle {oracle_s:.1f} s on the host)")

    # ---- 5. timing on pre-uploaded inputs, coarse against fine ----
    stage_names = ("pre", "raster", "shade", "placement")
    for mode in MODES:
        for plain in (False, True):      # the staged copy has not drifted
            if not torch.equal(staged_frame(attrs, shader, uniforms, WIDTH, HEIGHT, th,
                                            mode, plain), images[mode]):
                fail(f"the staged {mode} frame (plain={plain}) differs from the image route")
    frame_ms = ab_ms(lambda mode: rs.render_frame_fused_image(
        [(attrs, shader, uniforms, False)], WIDTH, HEIGHT, tile_h=th))
    for mode in MODES:
        for plain in (False, True):
            route = "plain" if plain else "kernel"
            ms = (event_ms(lambda: staged_frame(attrs, shader, uniforms, WIDTH, HEIGHT, th,
                                                mode, True)) if plain else frame_ms[mode])
            st = stage_medians(lambda m: staged_frame(attrs, shader, uniforms, WIDTH,
                                                      HEIGHT, th, mode, plain, m),
                               stage_names)
            say(f"[5 timing] head_phong_{WIDTH} {mode} {route} route: {ms:.3f} ms/frame, "
                f"{WIDTH * HEIGHT / ms / 1e3:.1f} Mpix/s (screen pixels); stages ms: "
                + " ".join(f"{s} {v:.3f}" for s, v in st.items()) + f" | {smi}")
    say(f"[5 a/b] head_phong_{WIDTH}: kernel route ms/frame in turns, coarse "
        f"{frame_ms['coarse']:.3f} fine {frame_ms['fine']:.3f} (fine/coarse "
        f"{frame_ms['fine'] / frame_ms['coarse']:.3f}) | {smi}")

    # the coarse/fine A/B on more single-pass frames: the Gouraud head at
    # 800², and the headline head at three tessellations
    ab_scenes = {"head_gouraud_800": (tscene.headline_scene(800, 800, "gouraud"), 800, 800)}
    for lat, lon in ((24, 36), (48, 72), (96, 144)):
        ab_scenes[f"head_phong_{WIDTH}_{lat}x{lon}"] = (
            tscene.headline_scene(WIDTH, HEIGHT, "phong", n_lat=lat, n_lon=lon), WIDTH, HEIGHT)
    for name, (sc, w, h) in ab_scenes.items():
        a_attrs, a_shader, a_uniforms, _ = tscene.pass_tensors(sc, DEVICE)[0]
        th_a = rs.pick_tile_h(w, h)
        rows, pairs = rf.probe_rows_pairs(a_attrs, a_uniforms, a_shader, w, h, th_a, TILE_W)
        outs, st = {}, {}
        for mode in MODES:
            with fine_mode(mode):
                outs[mode] = rs.render_frame_fused_image(
                    [(a_attrs, a_shader, a_uniforms, False)], w, h, tile_h=th_a)
            st[mode] = stage_medians(lambda m: staged_frame(
                a_attrs, a_shader, a_uniforms, w, h, th_a, mode, False, m), stage_names)
        ms = ab_ms(lambda mode: rs.render_frame_fused_image(
            [(a_attrs, a_shader, a_uniforms, False)], w, h, tile_h=th_a))
        if not torch.equal(outs["coarse"], outs["fine"]):
            fail(f"{name}: the fine image differs from the coarse image")
        rs._FINE_DECISION.clear()
        auto = rs.decide_mode(a_attrs, a_uniforms, a_shader, w, h, th_a, TILE_W)
        say(f"[5 a/b] {name}: faces {a_attrs['position'].shape[0]}, th {th_a}, strip rows "
            f"{rows}, coarse pairs {pairs}, rows/pairs {rows / max(pairs, 1):.3f}; "
            f"ms/frame coarse {ms['coarse']:.3f} fine {ms['fine']:.3f} (fine/coarse "
            f"{ms['fine'] / ms['coarse']:.3f}, in turns); raster ms coarse {st['coarse']['raster']:.3f} "
            f"fine {st['fine']['raster']:.3f}, pre ms coarse {st['coarse']['pre']:.3f} fine "
            f"{st['fine']['pre']:.3f}; images equal; auto picks {auto} | {smi}")

    # ---- 6. the tiled frame with exact stats, against the oracle ----
    frames = {"multimesh": tscene.multimesh_scene(REF_W, REF_H),
              "cli_default": cli.build_default_scene(width=REF_W, height=REF_H)}
    oracles = {}
    for name, sc in frames.items():
        t0 = time.perf_counter()
        oracles[name] = tscene.oracle_render(sc)
        say(f"[6 oracle] {name} {REF_W}x{REF_H} on the host: {time.perf_counter() - t0:.1f} s")
    for mode in MODES:
        with fine_mode(mode):
            results, frame_launches = counted(lambda: {
                name: (tscene.render_scene(sc, DEVICE, collect_stats=True),
                       tscene.render_scene(sc, DEVICE, collect_stats=False))
                for name, sc in frames.items()})
        add_launches(frame_launches)
        say(f"[6 frame] FINE_MODE={mode!r}: render_scene at {REF_W}x{REF_H} on "
            f"{list(frames)}; launches {frame_launches}")
        for k in (f"{mode}_raster", f"{mode}_raster_stats", "untile3", "untile_one"):
            if not frame_launches[k]:
                fail(f"{k} never launched in the {mode} frames: {frame_launches}")
        for name in frames:
            r, r0 = results[name]
            ref = oracles[name]
            for plane in ("color", "depth", "full_depth"):
                got, want = getattr(r, plane), getattr(ref, plane)
                diff, err = bits_equal(got.cpu(),
                                       torch.from_numpy(np.ascontiguousarray(want)))
                if diff:
                    fail(f"{mode} {name} {plane}: {diff} elements differ from the f32 "
                         f"oracle (max abs err {err})")
                if not torch.equal(getattr(r0, plane), got):
                    fail(f"{mode} {name} {plane} differs between the frames with and "
                         f"without stats")
            if r.stats != ref.stats:
                fail(f"{mode} {name} stats differ from the oracle's:\n  port   {r.stats}\n"
                     f"  oracle {ref.stats}")
            excluded = int((r.depth != r.full_depth).sum())
            say(f"[6 oracle] {mode} {name}: colour, depth and full depth == float32 oracle "
                f"bitwise ({int(torch.isfinite(r.full_depth).sum())} covered, {excluded} "
                f"pixels where the output depth drops the excluded pass), stats equal "
                f"({r.stats.describe()}), the frame without stats equal")

    # ---- 7. the CLI, against the oracle + NumPy post ----
    with tempfile.TemporaryDirectory() as tmp:
        out, want_dir = Path(tmp) / "port", Path(tmp) / "oracle"
        want_dir.mkdir()
        code, cli_launches = counted(lambda: cli.run(
            ["--device", DEVICE, "--width", str(REF_W), "--height", str(REF_H),
             "--outdir", str(out)]))
        add_launches(cli_launches)
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
    if not (cli_launches["untile3"] and cli_launches["untile_one"]
            and cli_launches["coarse_raster_stats"] + cli_launches["fine_raster_stats"]):
        fail(f"a kernel of the CLI's frame never launched: {cli_launches}")
    say(f"[7 cli] tinyrenderder_tpu_torch.cli {REF_W}x{REF_H} on {DEVICE} "
        f"(FINE_MODE={rs.FINE_MODE!r}): 4 TGAs byte-identical to the f32 oracle + NumPy "
        f"post ({sizes}); launches {cli_launches}")

    # ---- 8. timing of the 3-pass frame on pre-uploaded inputs ----
    frame_stages = ("pre", "raster", "merge+shade", "untile")
    cells = {f"reference_pipeline_{REF_W}x{REF_H}": ((REF_W, REF_H), True),
             f"multimesh_frame_{WIDTH}x{HEIGHT}": ((WIDTH, HEIGHT), False)}
    for cell, ((w, h), with_post) in cells.items():
        passes = mm_passes[(w, h)]

        def kernel_run():
            fb, depth, _ = tscene.render_passes(passes, w, h, DEVICE)
            return post.postprocess(fb.color, depth)[2] if with_post else fb.color

        names = frame_stages + (("post",) if with_post else ())
        for mode in MODES:
            with fine_mode(mode):
                want_img = kernel_run()
                for plain in (False, True):
                    got_img = staged_multipass(passes, w, h, mode, plain,
                                               with_post)[-1 if with_post else 0]
                    if not torch.equal(got_img, want_img):
                        fail(f"{cell} {mode}: the staged frame (plain={plain}) differs "
                             f"from render_passes")
        frame_ms = ab_ms(lambda mode: kernel_run())
        for mode in MODES:
            for plain in (False, True):
                ms = (event_ms(lambda: staged_multipass(passes, w, h, mode, True, with_post))
                      if plain else frame_ms[mode])
                st = stage_medians(lambda m: staged_multipass(passes, w, h, mode, plain,
                                                              with_post, m), names)
                say(f"[8 timing] {cell} {mode} {'plain' if plain else 'kernel'} route: "
                    f"{ms:.3f} ms/frame, {w * h / ms / 1e3:.1f} Mpix/s; stages ms: "
                    + " ".join(f"{k} {v:.3f}" for k, v in st.items())
                    + f" | {len(passes)} passes, one readback each | {smi}")
        say(f"[8 a/b] {cell}: kernel route ms/frame in turns, coarse {frame_ms['coarse']:.3f} "
            f"fine {frame_ms['fine']:.3f} (fine/coarse "
            f"{frame_ms['fine'] / frame_ms['coarse']:.3f}) | {smi}")

    if "jax" in sys.modules or any(m.split(".")[0] == "tinyrenderder_tpu" for m in sys.modules):
        fail("jax or the JAX package was imported")
    order = ("coarse_raster", "coarse_raster_stats", "fine_raster", "fine_raster_stats",
             "untile_one", "untile3")
    kernels = []
    for name in order:
        entry = dict(record[name])
        entry["launches"] = totals[name]
        kernels.append({k: entry[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")})
    say(f"[9 done] {time.perf_counter() - t_start:.1f} s; main-path launches {totals}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
