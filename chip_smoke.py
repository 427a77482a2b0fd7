#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: the single-pass image route and
the multi-pass tiled frame with exact stats, each on the coarse raster, the
strip raster and the grouped strip raster, the post pass, the CLI, the
bench's two 246k-triangle scenes, the two-pass shadowed frame, the
dense-grid raster entry, the ports of the scripts' three experimental
kernels, the orbit animation (on every backend), the scene entry methods
with their device caches on loaded models, and the sharded backends.

    python3 chip_smoke.py

Phases, one line each (any failure exits non-zero before the last line):
  1. the card: ``nvidia-smi`` name and power limit (alone on the first
     line), torch's device name;
  2. the kernel build from ``tinyrenderder_tpu_torch/csrc`` with nvcc, and
     each split-walk kernel's registers, shared memory and spills (the
     strip kernels of raster_strip.cuh once for the strip raster's tiles,
     once for the grouped raster's groups);
  3. each kernel against its plain PyTorch version on the card, bitwise:
     the coarse and the strip raster at the headline shapes (2048², 32-row
     tiles, Phong with 8 varyings); the single-plane untile on the
     headline's tile frame and its image store (``untile_image``) on the
     headline's compact tiles and ids, the three-plane untile and its
     image store (``untile3_image``) on the tiled 3-pass frame at 2048²,
     1200x800 and 1000x600 (a width that is not a multiple of 16), and
     ``untile_image`` on that frame's active tiles (RGB, depth with +inf
     fill) and on every tile (the snapshot's crop), each untile timed in
     turns with the library call or the eager composition it replaces,
     warm, with a cold L2 and as profiler device time; the
     grouped strip raster at the stress scene's (1280x800, 16-row tiles,
     Phong with 8 varyings), pass-local and seeded with the depth of the
     1200x800 3-pass scene's room at 1280x800, and the strip raster on the
     same pass, pass-local and seeded with stats; the coarse raster's
     event planes on the room pass of the 3-pass scene at 2048², rendered
     after the head, with the strip raster's beside them (its tiles all fit
     one range: through the route's one launch and through the split
     walk, in turns), and the strip and grouped strip rasters' on the head
     pass, rendered after the room (so each running depth is not all
     +inf); each stats launch must also leave depth, winner and varyings
     as the seeded launch without stats does; the dense launch of the
     coarse raster over every tile (``raster_coarse.rasterize`` /
     ``depth_resolve``) on the headline pass (2048², 32-row tiles, 8
     varyings) and on the light pass of ``shadow_phong_800`` (1024²,
     16-row tiles, depth only), each entry driven once through its user
     function, and ``depth_resolve`` of the light pass equal to the
     shadow map of the sparse route; [3 experimental] the ports of the
     scripts' kernels (``tinyrenderder_tpu_torch/experimental``): the
     prototype strip raster on the script's head, soup and cube Gouraud
     passes at 128x64 (with the script's own check against
     ``coarse_raster_plain`` over 8-row tiles; one launch each), on two
     piles of ties cut into several ranges, and on the headline head at
     2048² (8-row tiles, through ``strip_rasterize``; its split's items,
     the kernels a call launches, and in turns the walk alone over every
     group against the split walk), the pair-rank kernel
     on the script's 60,000 synthetic triangles, on 246,240 of the same
     distribution and on a one-strip pile of 246,240 (also against
     ``reference_ranks``), the in-place block update on the probe's image
     and ids and at the headline's tile shape (its 492 active tiles with a
     repeated id, and each of them four times, shuffled), these two also
     timed as their launches alone and as device time from a
     ``torch.profiler`` trace; [3 gouraud/textured 800]
     the Gouraud and Textured head at 800² through ``render_scene_image``
     and ``render_scene``, equal to the float32 oracle bitwise.  Each
     kernel's time, its plain version's, the library call's where one
     PyTorch call computes the same function, and its bound (bytes over
     3.35 TB/s or float operations over 67 TFLOP/s, from this run's data);
     for the split walks of the three rasters (sparse, stats, dense) also
     the work items, the longest item, the kernels one call launches (a
     profiler trace) and the time over the strip kernel's on the same pass
     ("/#4 split"; the strip kernel's over the coarse kernel's);
  4. the image route end to end through ``scene.render_scene_image`` on
     the headline scene (the 27,360-face bumpy head, normal-mapped Phong,
     2048²) under ``FINE_MODE`` "coarse", "fine" and "fine2": every kernel
     of each route must have launched, and every image must equal the
     float32 NumPy oracle bitwise;
  5. CUDA-event timing (3 warm-up frames, median of 20; the plain versions
     and routes 1 and 5) on pre-uploaded
     inputs, the three rasters in turns: the headline (kernel and plain
     routes, per stage), the Gouraud head at 800², and the headline head
     at three tessellations (its strip rows and grouped rows against its
     coarse pairs); [5 untile a/b] the headline's placement stage and
     frame with the eager composition and with ``untile_image``, in turns;
  6. the tiled frame through ``scene.render_scene`` with exact stats, on
     the bench's 3-pass scene (eyes excluded in the middle) and the CLI's
     default scene (eyes excluded last), both 1200x800, on each raster:
     colour, output depth and full depth bitwise equal to the float32
     oracle, equal ``RenderStats``, the same frame without stats, and
     every kernel of the route launched;
  7. the port's CLI at 1200x800 on the card, without and with
     ``--shadows``: its four TGA files must equal, byte for byte, those
     written from the oracle's colour and the port's NumPy post on the
     oracle's depth;
  8. CUDA-event timing, the three rasters in turns, of the reference
     pipeline (the 3-pass scene at 1200x800 plus the post pass) and of the
     3-pass frame at 2048², kernel route and plain route, per stage; [8
     untile a/b] each frame's untile stage composed and through
     ``untile3_image``, in turns;
  9. the bench's stress scene (``head_wall(3)``, 246,240 faces) and mixed
     scene (``mixed_interior(3)``, 246,252) at 1280x800 through
     ``scene.render_scene`` with exact stats and ``render_scene_image``
     under "fine2": colour and depth bitwise equal to the float32 oracle,
     equal ``RenderStats``, every kernel of the route launched, and the
     same frames and images under "coarse" and "fine";
 10. CUDA-event timing, the three rasters in turns (coarse, fine, fine2,
     fine2, fine, coarse), of both scenes' tiled frames as the bench runs
     them (``render_frame_fused`` + ``tiles_to_buffers(...).color``), per
     stage, and [10 untile a/b] as in [8];
 12. ``shadow_phong_800`` (``bench.py::bench_shadows``): the 3-mesh scene
     at 800², its key light, a 1024² map, no frustum cull, through
     ``shadows.render_with_shadows`` under "coarse", "fine" and "fine2":
     the map equal to the float32 oracle's light pass, colour, depth and
     full depth equal to the oracle's lit frame fed that map, bitwise,
     equal ``RenderStats``, and every kernel of the route launched;
 13. CUDA-event timing of that frame on pre-uploaded inputs, the three
     rasters in turns, per stage (light pass, untile, lit frame);
 15. the orbit of ``bench.py::bench_animation`` (the 3-pass scene at
     2048², no frustum cull) through ``animation.render_animation``, 6
     frames with the checkpoint on: a run stopped after 3 frames and
     resumed writes the uninterrupted run's bytes, frames 0 and 5 equal
     the float32 oracle at their eyes written by the Python encoder, and
     the native encoder wrote every frame; the render-only orbit's
     ms/frame, ms/frame with TGA writes, native against Python RLE encode;
     the CLI's ``--animate 3`` and ``--profile`` at 1200x800;
 17. the sharded backends (``parallel/dist.py``): the headline through
     ``Scene.render_image`` / ``Scene.render`` with ``backend="sharded"``
     in a world of one rank == the f32 oracle, the one-rank sharded frame
     of ``bench.py::bench_sharded_mesh1`` timed in five rounds of turns
     with ``render_frame_fused`` (and their profiler device times); 4
     ranks emulated on the card (the headline on interleaved bands and a
     2x2 grid, the stress scene on ``even_unequal_bands`` and measured
     bands) on the three rasters, every stitched frame and image == the
     f32 oracle; #1, #1s, #4 and #4s with ``y_stride`` on an interleaved
     band == their plain versions;
 18. the triangle-sharded backend (``sharded-geometry``: each pass's faces
     split over the ranks, the coarse raster on every rank over the whole
     frame, the min/min/sum merge): the headline through
     ``Scene.render_image`` / ``Scene.render`` in a world of one rank ==
     the f32 oracle; 4 ranks emulated on the card (the headline, the
     stress scene, the 3-pass scene at 1200x800 and ``shadow_phong_800``
     through ``render_with_shadows``), each frame with stats and without
     == the f32 oracle, stats equal, and the headline on 7 ranks (a short
     last block) == the oracle; the coarse raster launched once per rank
     and pass whose block reaches a tile; the one-rank geometry frame timed
     in five rounds of turns with ``render_frame_fused`` (and their
     profiler device times), each emulated rank's body on the stress pass
     (device time) and the bytes a colour pass's all-reduces would move;
 19. the orbit of [15] through ``animation.render_animation`` on every
     backend: each sharded backend on one rank and on 4 emulated ranks
     (``sharded-2d`` as a 2x2 grid) writes the tiled orbit's TGAs byte for
     byte, with #1 and #3i launched and one blocking cost measurement for
     ``sharded-measured``; the oracle's orbit at 128x64 == ``oracle_render``
     at its eyes; render-only orbit steps in rounds of turns, the one-rank
     sharded orbit against the tiled one and 4 emulated ranks
     ``sharded-measured`` against ``sharded``;
 20. the scan backend (``backend="xla"``, ``csrc/scan_resolve.cu``): the
     resolve kernel (super-block lists, then the walk), without and with
     its event sums, == the chunked scan and the split plain version
     bitwise, and its super-block lists == the plain lists, on the
     headline pass, the 2048² room pass seeded by the head, the 246k stress
     pass at 1280x800 and a band of the headline pass; ``Scene.render`` /
     ``render_image`` of the headline at 2048² == the f32 oracle and the
     tiled frame (stats equal), the 3-pass scene at 2048² == the tiled
     frame and at 1200x800 == the oracle, ``render_with_shadows`` of
     ``shadow_phong_800`` == the tiled shadowed frame and the oracle; each
     pass's kernel time (CUDA events), bound and launches a call, without
     and with stats, and the scan frame against the tiled frame in turns.
 21. the post (``csrc/post.cu``, ``post.postprocess`` on CUDA tensors) ==
     ``post.postprocess_plain`` bitwise at 1200x800 on the CLI's frame and
     on edge planes, == the NumPy ``oracle_post`` on the CLI's frame; the
     kernel and the plain composition timed in turns (CUDA events, median
     of 20), the kernel with a cold L2, their profiler device times and the
     bound.
 22. the pre-stage (``csrc/pre.cu``, ``raster_sparse.pre_sparse`` on CUDA
     tensors) == ``pre_sparse_plain`` bitwise on every output, on the
     walk's three passes, the sun walk's 2048² light pass and its two lit
     Phong passes (``rasterbench``'s scenes at their first view), each
     entry's launches a pass, and each pass's kernel and plain pre-stage
     timed in turns, their profiler device times and the bound.
 23. the merge + shade (``csrc/shade.cu``, ``raster_sparse.post_sparse``
     on CUDA tensors) == ``post_sparse_plain`` bitwise on the frame's
     colour, depth and winner, on every pass of the walk's frame and of the
     sun walk's (the 2048² light pass, then the lit passes over its map),
     one launch a pass, and each pass's kernel and plain merge + shade
     timed in turns (warm and cold L2), their profiler device times and
     the bound.  Alone: ``python3 -c "import chip_smoke as c;
     c.shade_phase(c.nvidia_smi(), {})"``.

Before those, ``[profiler]`` names each phase whose profiler trace was
read without its first call (``per_call``'s marker split).  The line
before the last is the kernels' JSON record; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from functools import partial
from pathlib import Path
from types import SimpleNamespace

DEVICE = "cuda"
WIDTH = HEIGHT = 2048                 # the headline and the large 3-pass frame
REF_W, REF_H = 1200, 800              # the reference's default frame (main.cpp:26-27)
FRAME_SIZES = ((WIDTH, HEIGHT), (REF_W, REF_H))   # the 3-pass frame's two sizes
WARMUP, FRAMES = 3, 20
#: the plain versions and plain routes: no yardstick of speed, timed shorter
PLAIN_WARMUP, PLAIN_FRAMES = 1, 5
MODES = ("coarse", "fine", "fine2")
#: the bench's 246k-triangle scenes (bench.py::bench_stress, bench_mixed)
WALL_W, WALL_H = 1280, 800
#: shadow_phong_800 (bench.py::bench_shadows): the frame and the map side
SHADOW_W = SHADOW_H = 800
SHADOW_SIZE = 1024
#: the orbit's frames (bench.py::bench_animation_tga runs 120 at 2048²)
ANIM_FRAMES = 6
#: gouraud_800 and textured_800 (bench.py:568-579)
SHADED_SIZE = 800
#: the bound's peaks: NVIDIA's H100 SXM data sheet, float32 outside the
#: tensor cores and HBM3
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
#: the replaced designs' times through the user function (PERF.md §6,
#: NVIDIA H100 80GB HBM3 at 700 W): the rank kernel's one block walking its
#: 128-triangle chunks in order, the block update's on-device
#: deduplication launches before its kernel, and the prototype strip
#: raster's one block a group walking all of its rows (the headline head);
#: printed as "before"
SERIAL_MS = {"rank_pairs 60000 synthetic": 2.3708, "rank_pairs 246240 synthetic": 8.3540,
             "inplace_blocks": 0.3364, "strip_raster_proto": 0.3219}
#: bytes written before a cold-L2 timing: twice the H100's 50 MB L2
FLUSH_BYTES = 128 << 20
#: a 3-pass frame whose width is not a multiple of 16 (nor its height of
#: the 16-row tile): the untile's narrow stores
RAGGED_SIZE = (1000, 600)
#: float operations of one raster test of a pixel inside a triangle's bbox
#: (barycentric: 15 products and differences, 1 sum, 3 divisions, 1
#: difference; affine z: 5) and of one winner's varyings (barycentric 20,
#: three 1/w, the perspective denominator 5 and weights 6, then 6 per
#: channel: 3 products, 2 sums and the + 0.0)
OPS_TEST, OPS_WIN, OPS_WIN_PER_VARY = 25, 34, 6
#: rounds of turns of [17 timing] (a frame moves ±30% between turns of one call)
MESH1_ROUNDS = 5
#: rounds of turns of [19 timing], and the oracle orbit's frame there
ORBIT_ROUNDS = 3
ORACLE_ORBIT = (128, 64)


def fail(msg: str) -> None:
    """Print the failed check on standard output and on standard error (a
    caller that keeps only the end of standard error still reads which
    check failed), and exit 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"chip_smoke.py FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


#: the tag of the phase ``say`` last printed (its "[...]"), and each trace
#: ``_traced_calls`` read without its first call, by that tag
PHASE = [""]
RELAXED: list[str] = []


def say(msg: str) -> None:
    if msg.startswith("[") and "]" in msg:
        PHASE[0] = msg[:msg.index("]") + 1]
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, warmup: int = WARMUP, reps: int = FRAMES, before=None) -> float:
    """Median CUDA-event time of ``fn`` in ms; ``before()`` runs ahead of
    each call, outside the timed interval."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if before is not None:
            before()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(fn, names, calls: dict | None = None) -> dict[str, float]:
    """Mean device time of one call of ``fn``, in ms, for each of ``names``
    that a CUDA kernel's name holds, from a ``torch.profiler`` trace of
    FRAMES calls after WARMUP; a name no kernel of the trace holds is
    left out.  ``calls``, if given, receives the mean number of those
    device events (kernels, copies, fills) a call, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(FRAMES):
            fn()
        torch.cuda.synchronize()
    ms: dict[str, float] = {}
    for e in prof.events():
        hit = [n for n in names if n in e.name]
        if e.device_type == DeviceType.CUDA and hit:
            ms[hit[0]] = ms.get(hit[0], 0.0) + e.time_range.elapsed_us() / FRAMES / 1e3
            if calls is not None:
                calls[hit[0]] = calls.get(hit[0], 0.0) + 1 / FRAMES
    return ms


def in_turns(fn_a, fn_b, before=None) -> tuple[float, float]:
    """``event_ms`` of ``fn_a`` and ``fn_b`` in turns (a, b, b, a): the mean
    of each one's two medians."""
    a0, b0, b1, a1 = (event_ms(fn, before=before) for fn in (fn_a, fn_b, fn_b, fn_a))
    return (a0 + a1) / 2, (b0 + b1) / 2


def cold_l2():
    """-> flush(): reads and writes FLUSH_BYTES of random words on the card,
    more than its 50 MB L2 holds, so that the next call reads its inputs
    from device memory.  The host prepares the timed call while the flush
    runs, so an event time taken after it holds little of the host's
    launch cost."""
    import torch
    buf = torch.randint(-2**31, 2**31 - 1, (FLUSH_BYTES // 4,), dtype=torch.int32,
                        device=DEVICE)
    return lambda: buf.add_(1)


def device_total(fn) -> float:
    """Device time of one call of ``fn`` in ms: every CUDA kernel, copy and
    fill of a ``torch.profiler`` trace (``device_ms``), summed."""
    return sum(device_ms(fn, ("",)).values())


def untile_ab(kernel, other, flush) -> dict:
    """The untile wrapper ``kernel`` against ``other`` (the library call or
    the composition it replaces): CUDA-event times in turns (a, b, b, a),
    warm and with a cold L2 (``flush`` before each call), and profiler
    device times; keys ms, cold, device and other_ms, other_cold,
    other_device."""
    out = dict(zip(("ms", "other_ms"), in_turns(kernel, other)))
    out.update(zip(("cold", "other_cold"), in_turns(kernel, other, before=flush)))
    out.update(device=device_total(kernel), other_device=device_total(other))
    return out


def untile_text(t: dict, other: str) -> str:
    return (f"kernel {t['ms']:.4f} ms (cold L2 {t['cold']:.4f}, device {t['device']:.4f}), "
            f"{other} {t['other_ms']:.4f} ms (cold L2 {t['other_cold']:.4f}, device "
            f"{t['other_device']:.4f}); kernel/{other.split(' ')[0]} "
            f"{t['ms'] / t['other_ms']:.3f}, cold {t['cold'] / t['other_cold']:.3f}")


def ms_text(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def device_text(ms: dict[str, float]) -> str:
    """'t ms (a x ms + b y ms)' from ``device_ms``, or 'not measured'."""
    if not ms:
        return "not measured"
    parts = " + ".join(f"{k} {v:.4f}" for k, v in ms.items())
    return f"{sum(ms.values()):.4f} ms" + (f" ({parts})" if len(ms) > 1 else "")


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


def same_planes(what: str, names, got, want) -> float:
    """Fail unless each named plane of ``got`` equals ``want`` bitwise;
    -> the max abs error (0.0)."""
    worst = 0.0
    for name, a, b in zip(names, got, want, strict=True):
        diff, err = bits_equal(a, b)
        worst = max(worst, err)
        if diff:
            fail(f"{what} {name}: {diff} elements differ (max abs err {err})")
    return worst


def check_outputs(what: str, got, want) -> float:
    """Fail unless every plane of ``got`` equals ``want`` bitwise (event
    planes nested as a pair); returns the max abs error (0.0)."""
    names = ("depth", "winner", "varyings", "event count", "event max z")
    flat = lambda out: (*out[:3], *(out[3] if len(out) > 3 else ()))  # noqa: E731
    got, want = flat(got), flat(want)
    return same_planes(what, names[:len(got)], got, want)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take, from this run's data
# ---------------------------------------------------------------------------

def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(bound ms, "bytes" or "operations")."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, ops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bbox_tests(tri_rec, tri, x0, y0, span_w: int, tile_h: int) -> int:
    """Pixels inside each (triangle, block) pair's integer bbox, summed,
    for blocks of ``span_w`` x ``tile_h`` pixels at (x0, y0): the raster
    tests that reach the arithmetic."""
    import torch
    bb = tri_rec[tri.long(), 12:16]
    x0, y0 = x0.to(torch.float32), y0.to(torch.float32)
    nx = (torch.minimum(x0 + (span_w - 1), bb[:, 1]) - torch.maximum(x0, bb[:, 0]) + 1)
    ny = (torch.minimum(y0 + (tile_h - 1), bb[:, 3]) - torch.maximum(y0, bb[:, 2]) + 1)
    return int((nx.clamp(min=0).double() * ny.clamp(min=0).double()).sum())


def raster_bound(kind: str, pre, out, tile_h: int, n_tiles_x: int, n_vary: int,
                 stats: bool, seeded: bool = True) -> tuple[float, str]:
    """The raster's bound: bytes = its inputs (the live entries of the bins
    or slot table, the 16 geometry floats of each triangle they name, the
    3V varying corners of each triangle that wins a pixel, the blocks'
    ids/segments or origins, the running depth where ``seeded``) read once
    and its (2 + V) output planes (+2 with stats) written once; operations
    = OPS_TEST per pixel inside the bbox of a visited (triangle, tile or
    strip) pair and the varyings of every won pixel."""
    import torch
    plane = tile_h * 128 * 4
    if kind == "coarse":
        a = pre.ids.shape[0]
        tile = torch.repeat_interleave(pre.ids, pre.counts)
        tri, span_w, meta = pre.sorted_tri, 128, 3 * a * 4
        x0, y0 = (tile % n_tiles_x) * 128, torch.div(tile, n_tiles_x, rounding_mode="floor") * tile_h
    elif kind == "fine":
        a = pre.ids.shape[0]
        tri = pre.tri8.reshape(-1)
        tile = torch.repeat_interleave(pre.ids, pre.rows * 8)
        strip = torch.arange(tri.numel(), device=tri.device) % 8
        x0 = (tile % n_tiles_x) * 128 + strip * 16
        y0 = torch.div(tile, n_tiles_x, rounding_mode="floor") * tile_h
        span_w, meta = 16, 3 * a * 4
    else:
        a = pre.n_groups
        tri = pre.tri8.reshape(-1)
        group = torch.repeat_interleave(torch.arange(a, device=tri.device), pre.group_rows * 8)
        slot = torch.arange(tri.numel(), device=tri.device) % 8
        x0, y0 = pre.x0y0[group, slot, 0], pre.x0y0[group, slot, 1]
        span_w, meta = 16, a * 4 * (2 + 16)
    live = tri >= 0
    tests = bbox_tests(pre.tri_rec, tri[live], x0[live], y0[live], span_w, tile_h)
    winner = out[1][out[1] >= 0]
    won = winner.numel()
    rec_floats = (torch.unique(tri[live]).numel() * 16
                  + torch.unique(winner).numel() * 3 * n_vary)
    n_bytes = (int(live.sum()) * 4 + rec_floats * 4 + meta + (a * plane if seeded else 0)
               + a * plane * (2 + n_vary + (2 if stats else 0)))
    ops = tests * OPS_TEST + won * (OPS_WIN + OPS_WIN_PER_VARY * n_vary)
    return bound(n_bytes, ops)


# ---------------------------------------------------------------------------
# the routes from their stage functions
# ---------------------------------------------------------------------------

def raster_stage(mode: str, plain: bool, attrs, shader, uniforms, w: int, h: int,
                 th: int, init_depth, mark):
    """``raster_sparse.raster_pass`` or ``grouped_pass`` (pass-local) on
    one route, marking the end of the pre-stage and of the raster; ->
    (pre, (depth, winner, vary)), in group space on the "fine2" route."""
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_fine as rf
    from tinyrenderder_tpu_torch.ops import raster_fine2 as rf2
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    ntx, n_vary = cdiv(w, TILE_W), sum(shader.varying_spec.values())
    if mode == "fine2":
        pre = rf2.pre_fine2(attrs, uniforms, shader, w, h, th, TILE_W)
        mark("pre")
        fn = rf2.fine2_raster_plain if plain else rf2.fine2_raster
        out = fn(pre.tri_rec, pre.tri8, pre.group_start, pre.group_rows, pre.x0y0, th, n_vary)
    elif mode == "fine":
        pre = rf.pre_fine(attrs, uniforms, shader, w, h, th, TILE_W)
        mark("pre")
        fn = rf.fine_raster_plain if plain else partial(rf.fine_raster, max_rows=pre.max_rows)
        out = fn(pre.tri_rec, pre.tri8, pre.ids, pre.row_start, pre.rows,
                 init_depth(pre.ids), ntx, th, TILE_W, n_vary)
    else:
        pre = rs.pre_sparse(attrs, uniforms, shader, w, h, th, TILE_W)
        mark("pre")
        fn = rc.coarse_raster_plain if plain else rc.coarse_raster
        out = fn(pre.tri_rec, pre.sorted_tri, pre.ids, pre.start, pre.counts,
                 init_depth(pre.ids), ntx, th, TILE_W, n_vary)
    mark("raster")
    return pre, out


def marker(marks):
    """mark(stage): record a CUDA event ending ``stage`` when ``marks`` is a list."""
    import torch

    def mark(stage):
        if marks is not None:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((stage, e))
    return mark


def staged_frame(attrs, shader, uniforms, w, h, th, mode, plain, marks=None,
                 composed=False):
    """One frame of the image route from its stage functions (the body of
    ``raster_sparse.render_frame_fused_image``); ``composed``: the
    placement as it was composed before ``untile_image`` (a full-frame
    fill and scatter, ``untile_one``, the crop and ``unpack_rgb``)."""
    import torch

    from tinyrenderder_tpu_torch.ops import raster_fine2 as rf2
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    mark = marker(marks)
    ntx, nty = cdiv(w, TILE_W), cdiv(h, th)
    mark(None)
    pre, out = raster_stage(
        mode, plain, attrs, shader, uniforms, w, h, th,
        lambda ids: torch.full((ids.shape[0], th, TILE_W), torch.inf, device=DEVICE), mark)
    if mode == "fine2":
        c_img, _ = rf2.post_fine2_image(pre, out,
                                        lambda v: rs._shade_packed(v, uniforms, shader))
    else:
        shade = rs.shade_compact_fresh_plain if plain else rs.shade_compact_fresh
        c_img = shade(out[1], out[2], uniforms, shader)
    mark("shade")
    if plain:
        image = rs.untile_image_plain(c_img, pre.ids, ntx, nty, th, TILE_W, h, w, rgb=True)
    elif composed:
        image = rs.unpack_rgb(rs.compact_to_image(c_img, pre.ids, ntx, nty, th, TILE_W)[:h, :w])
    else:
        image = rs.untile_image(c_img, pre.ids, ntx, nty, th, TILE_W, h, w, rgb=True)
    mark("placement")
    return image


def staged_multipass(passes, width, height, mode, plain, with_post, marks=None,
                     composed=False):
    """One tiled frame from its stage functions (the bodies of
    ``raster_sparse.render_frame_fused`` and ``scene.render_passes``),
    plus the post pass when ``with_post``; with ``marks`` it appends
    (stage, CUDA event) after each stage, the stage naming the interval
    that ends at the event.  ``composed``: the untile stage as it was
    composed before ``untile3_image`` (``untile3``, the crops and
    ``unpack_rgb``; ``untile_one`` and a crop for the snapshot)."""
    from tinyrenderder_tpu_torch.ops import post
    from tinyrenderder_tpu_torch.ops import raster_fine2 as rf2
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
        pre, out = raster_stage(mode, plain, attrs, shader, uniforms, width, height, th,
                                lambda i: ft.depth[i.long()], mark)
        if mode == "fine2":
            rf2.post_fine2(ft, pre, out, offset,
                           lambda v, u=uniforms, sh=shader: rs._shade_packed(v, u, sh))
        else:
            rs.post_sparse(ft, pre.ids, *out, uniforms, shader, offset)
        mark("merge+shade")
        offset += attrs["position"].shape[0]
    n = (ntx, nty, th, TILE_W)
    if composed:
        color, depth, _ = rs.untile3(*ft, *n)
        if in_excluded:
            depth = rs.untile_one(snapshot, *n)
        image, depth = rs.unpack_rgb(color[:height, :width]), depth[:height, :width]
    else:
        image, depth, _ = (rs.untile3_image_plain if plain else rs.untile3_image)(
            *ft, *n, height, width)
        if in_excluded:
            depth = (rs.untile_image_plain if plain else rs.untile_image)(
                snapshot, None, *n, height, width)
    mark("untile")
    if not with_post:
        return image, depth
    final = post.postprocess(image, depth.contiguous())[2]
    mark("post")
    return image, depth, final


def staged_shadow_frame(light_passes, lit_passes, width, height, size, marks=None):
    """One shadowed frame from its stage functions on pre-uploaded pass
    tensors (the body of ``shadows.render_with_shadows`` without the host
    layer): the light pass, the untile of its depth, then the lit frame
    with that map as each shadow-mapped pass's uniform."""
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_H, TILE_W, cdiv

    mark = marker(marks)
    mark(None)
    ft, _, _ = rs.render_frame_fused(light_passes, size, size, DEVICE, tile_h=TILE_H)
    mark("light pass")
    smap = rs.untile_one(ft.depth, cdiv(size, TILE_W), cdiv(size, TILE_H), TILE_H,
                         TILE_W)[:size, :size].contiguous()
    mark("untile")
    passes = [(a, sh, dict(u, shadow_map=smap) if "shadow_map" in u else u, ex)
              for a, sh, u, ex in lit_passes]
    fb, _, _ = tscene.render_passes(passes, width, height, DEVICE)
    mark("lit frame")
    return fb.color


def placement_ab(run, stage_names, stage: str) -> str:
    """``run(marks, composed)`` with the untile stage composed as before the
    image stores (``composed`` True) and through them, in turns (store,
    composed, composed, store): ``stage``'s median and the frame's ms, each
    the mean of its arm's two turns."""
    st, ms = {True: [], False: []}, {True: [], False: []}
    for composed in (False, True, True, False):
        st[composed].append(stage_medians(lambda m: run(m, composed), stage_names)[stage])
        ms[composed].append(event_ms(lambda: run(None, composed)))
    def arm(v):
        return f"{statistics.fmean(v):.3f} ({v[0]:.3f}, {v[1]:.3f})"
    return (f"{stage} ms (mean (turns)) composed {arm(st[True])} -> image store "
            f"{arm(st[False])}; ms/frame composed {arm(ms[True])} -> image store "
            f"{arm(ms[False])}")


def write_oracle_files(out: Path, ref) -> None:
    """The CLI's four files from an oracle result: its colour, and the
    port's NumPy post on its depth."""
    import torch

    from tinyrenderder_tpu_torch import cli
    from tinyrenderder_tpu_torch.ops import post

    out.mkdir()
    zimg, ao_u8, final = post.oracle_post(ref.color, ref.depth)
    cli.write_rgb(str(out / "phong.tga"), torch.from_numpy(ref.color))
    cli.write_gray(str(out / "zbuffer.tga"), torch.from_numpy(zimg))
    cli.write_gray(str(out / "ao.tga"), torch.from_numpy(ao_u8))
    cli.write_rgb(str(out / "final.tga"), torch.from_numpy(final))


def write_ply(path, mesh) -> None:
    """``mesh`` as binary little-endian PLY: float32 x y z nx ny nz u v,
    triangles as uchar-counted int lists."""
    import numpy as np
    header = "\n".join(
        ["ply", "format binary_little_endian 1.0", f"element vertex {mesh.nverts}"]
        + [f"property float {k}" for k in ("x", "y", "z", "nx", "ny", "nz", "u", "v")]
        + [f"element face {mesh.nfaces}", "property list uchar int vertex_indices",
           "end_header"]) + "\n"
    verts = np.concatenate([mesh.positions, mesh.normals, mesh.uvs], axis=1).astype("<f4")
    faces = np.zeros(mesh.nfaces, dtype=[("n", "u1"), ("i", "<i4", 3)])
    faces["n"], faces["i"] = 3, mesh.faces
    Path(path).write_bytes(header.encode() + verts.tobytes() + faces.tobytes())


def write_stl(path, mesh) -> None:
    """``mesh`` as binary STL: a zero normal, the three float32 corners and
    a zero attribute per triangle."""
    import struct

    import numpy as np
    rec = np.zeros(mesh.nfaces, dtype=[("n", "<f4", 3), ("v", "<f4", (3, 3)),
                                      ("a", "<u2")])
    rec["v"] = mesh.positions[mesh.faces]
    Path(path).write_bytes(b"\0" * 80 + struct.pack("<I", mesh.nfaces) + rec.tobytes())


def write_off(path, mesh) -> None:
    """``mesh`` as OFF text, positions at full float64 precision."""
    lines = ["OFF", f"{mesh.nverts} {mesh.nfaces} 0"]
    lines += [" ".join(repr(float(c)) for c in p) for p in mesh.positions]
    lines += ["3 " + " ".join(str(int(i)) for i in f) for f in mesh.faces]
    Path(path).write_text("\n".join(lines) + "\n")


def write_glb(path, mesh) -> None:
    """``mesh`` as a binary glTF: one node, one primitive with float32
    POSITION, NORMAL and TEXCOORD_0 and uint32 indices."""
    import struct

    import numpy as np
    arrays = [mesh.positions.astype("<f4"), mesh.normals.astype("<f4"),
              mesh.uvs.astype("<f4"), mesh.faces.reshape(-1).astype("<u4")]
    views, accessors, blob = [], [], b""
    for a, (kind, comp) in zip(arrays, (("VEC3", 5126), ("VEC3", 5126), ("VEC2", 5126),
                                        ("SCALAR", 5125))):
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": a.nbytes})
        accessors.append({"bufferView": len(views) - 1, "componentType": comp,
                          "count": a.shape[0], "type": kind})
        blob += a.tobytes()
    doc = {"asset": {"version": "2.0"}, "buffers": [{"byteLength": len(blob)}],
           "bufferViews": views, "accessors": accessors,
           "meshes": [{"name": mesh.name or "mesh", "primitives": [
               {"attributes": {"POSITION": 0, "NORMAL": 1, "TEXCOORD_0": 2},
                "indices": 3}]}],
           "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}], "scene": 0}
    jb = json.dumps(doc).encode()
    jb += b" " * (-len(jb) % 4)
    blob += b"\0" * (-len(blob) % 4)
    body = (struct.pack("<II", len(jb), 0x4E4F534A) + jb
            + struct.pack("<II", len(blob), 0x004E4942) + blob)
    Path(path).write_bytes(struct.pack("<III", 0x46546C67, 2, 12 + len(body)) + body)


#: the model files [16 host] writes and loads back through ``ModelManager``
MODEL_WRITERS = {".ply": write_ply, ".stl": write_stl, ".off": write_off, ".glb": write_glb}


def same_files(got: Path, want: Path, what: str) -> dict:
    """Fail unless the CLI's four TGA files are byte-identical; -> sizes."""
    sizes = {}
    for f in ("phong.tga", "zbuffer.tga", "ao.tga", "final.tga"):
        got_b, want_b = (got / f).read_bytes(), (want / f).read_bytes()
        if got_b != want_b:
            fail(f"{what} {f} differs from the oracle + NumPy post file")
        sizes[f] = len(got_b)
    return sizes


def ab_ms(run) -> dict:
    """ms/frame of ``run(mode)`` per mode, measured in turns (coarse, fine,
    fine2, fine2, fine, coarse), each turn a median of FRAMES: the mean of a
    mode's two turns."""
    turns = {m: [] for m in MODES}
    for mode in MODES + MODES[::-1]:
        with fine_mode(mode):
            turns[mode].append(event_ms(lambda: run(mode)))
    return {m: statistics.fmean(v) for m, v in turns.items()}


def ab_text(ms: dict) -> str:
    """'coarse a fine b fine2 c (fine/coarse x, fine2/coarse y)' from ms per mode."""
    ratios = ", ".join(f"{m}/coarse {ms[m] / ms['coarse']:.3f}" for m in MODES[1:])
    return " ".join(f"{m} {ms[m]:.3f}" for m in MODES) + f" ({ratios})"


def time_plain(fn) -> float:
    """``event_ms`` of a plain version or route: median of PLAIN_FRAMES
    after PLAIN_WARMUP."""
    return event_ms(fn, PLAIN_WARMUP, PLAIN_FRAMES)


def stage_medians(run, stage_names, plain: bool = False):
    """Median ms per stage over FRAMES frames after WARMUP (PLAIN_FRAMES
    after PLAIN_WARMUP for a plain route), from ``run(marks)``."""
    per = {s: [] for s in stage_names}
    warmup, frames = (PLAIN_WARMUP, PLAIN_FRAMES) if plain else (WARMUP, FRAMES)
    for i in range(warmup + frames):
        marks = []
        run(marks)
        marks[-1][1].synchronize()
        if i < warmup:
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
    """Every kernel's launches by entry point (the ``launch.*`` counters of
    ``trace``, without the prefix): ``untile_one`` and ``untile3`` count the
    plain-layout entries, ``untile_image`` and ``untile3_image`` the image
    stores of the same two kernels."""
    from tinyrenderder_tpu_torch import trace
    c = trace.counts()
    return {name[len("launch."):]: c[name] for name in trace.LAUNCH_KERNELS}


def reset_counts():
    from tinyrenderder_tpu_torch import trace
    trace.reset_counts()


def counted(fn):
    """Run ``fn`` with every launch count set to 0 just before; -> (result,
    the counts just after)."""
    import torch
    reset_counts()
    result = fn()
    torch.cuda.synchronize()
    return result, launch_counts()


def untile_sass(lib: Path) -> dict:
    """{untile kernel: counts} from ``cuobjdump -sass`` of the built library:
    its 16-byte loads (all, and those before the first store: the loads a
    thread has in flight) and stores, and its MUFU.RCP (the reciprocal of
    an integer division); {} where the toolkit has no cuobjdump."""
    import re

    from tinyrenderder_tpu_torch import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    counts, cur = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            m = re.search(r"(untile3?2?_kernel)ILi(\d+)E", ln)
            cur = None
            if m:
                th = m.group(2)
                cur = counts[f"{m.group(1)}<{'any' if th == '0' else th}>"] = dict.fromkeys(
                    ("ldg", "ahead", "stg", "rcp"), 0)
        elif cur is not None:
            if "LDG" in ln and ".128" in ln:
                cur["ldg"] += 1
                cur["ahead"] += cur["stg"] == 0
            elif "STG" in ln and ".128" in ln:
                cur["stg"] += 1
            elif "MUFU.RCP" in ln:
                cur["rcp"] += 1
    return counts


#: the split-walk kernels of the rasters: raster_coarse.cu's, raster_strip.cuh's,
#: shared by the strip and grouped strip rasters, and fine_raster.cu's (#7)
SPLIT_KERNELS = ("item_scan_kernel", "coarse_walk_kernel", "coarse_merge_kernel",
                 "coarse_events_kernel", "strip_walk_kernel", "strip_merge_kernel",
                 "strip_events_kernel", "proto_walk_kernel", "proto_merge_kernel")
#: the scan resolve's kernels (csrc/scan_resolve.cu), and the names of the
#: template flag of those that have one where it is not STATS
SCAN_KERNELS = ("scan_cull_kernel", "scan_prefix_kernel", "scan_walk_kernel")
PRE_KERNELS = ("pre_front_kernel", "pre_offsets_kernel", "pre_place_kernel")
FLAG_NAMES = {"scan_cull_kernel": ("count", "fill"), "pre_front_kernel": ("global", "shared"),
              "pre_place_kernel": ("global", "shared")}


def ptxas_kernels(log: str, names) -> dict[str, str]:
    """{kernel<TH,STATS[,tiles|groups]>: "R registers, S B smem, spills
    x/y"} from the ptxas report of the build for each kernel whose name is
    in ``names``; a strip kernel names its origin policy (the strip
    raster's tiles, the grouped raster's groups)."""
    import re
    out, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search("(" + "|".join(names) + r")(?:I(?:Li(\d+)E)?(?:Lb([01])E)?)?", ln)
            cur = None
            if m:
                flags = FLAG_NAMES.get(m.group(1), ("plain", "stats"))
                args = ([m.group(2)] if m.group(2) else []) + (
                    [flags[int(m.group(3))]] if m.group(3) else [])
                origin = re.search(r"(Tile|Slot)Origins", ln)
                if origin:
                    args.append({"Tile": "tiles", "Slot": "groups"}[origin.group(1)])
                cur = m.group(1) + (f"<{','.join(args)}>" if args else "")
                out[cur] = ""
        elif cur is not None and "spill stores" in ln:
            st = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
            out[cur] = f"spills {st.group(1)}/{st.group(2)} B"
        elif cur is not None and "Used" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            smem = re.search(r"(\d+) bytes smem", ln)
            out[cur] = f"{regs} registers, {smem.group(1) if smem else 0} B smem, {out[cur]}"
    return out


def split_shape(counts, range_len: int) -> tuple[int, int]:
    """(work items, the longest item's steps) of a split walk over blocks
    of ``counts`` steps cut into ranges of ``range_len``."""
    c = [int(x) for x in counts.tolist()]
    return (sum(max(1, -(-n // range_len)) for n in c),
            min(max(c, default=0), range_len))


#: the marker kernel ``_traced_calls`` launches before each call
# (``torch.cuda._sleep``), so that a trace splits into calls
MARK_KERNEL = "spin_kernel"


def per_call(events, calls: int) -> tuple[list, bool] | None:
    """(the device events of ``calls`` calls, whether all ``calls`` + 1
    were read) from a trace of ``calls`` + 1 calls, each after a marker
    kernel.  The whole-trace check first: the events but the markers are
    one sequence repeated ``calls`` + 1 times; the events of the last
    ``calls`` calls are returned.  Else the marker split: the segments
    between markers, the last ``calls`` of which hold one sequence (the
    card's profiler drops the first events of a trace, in some processes
    the first kernel of every trace).  None where neither holds."""
    names = [e.name for e in events if MARK_KERNEL not in e.name]
    one = len(names) // (calls + 1)
    if one and names[:one] * (calls + 1) == names:
        return [e for e in events if MARK_KERNEL not in e.name][one:], True
    segments: list[list] = []
    for e in events:
        if MARK_KERNEL in e.name:
            segments.append([])
        elif segments:
            segments[-1].append(e)
    if len(segments) < calls:
        return None
    seqs = [[e.name for e in seg] for seg in segments[-calls:]]
    if not seqs[0] or any(n != seqs[0] for n in seqs):
        return None
    return [e for seg in segments[-calls:] for e in seg], False


def _traced_calls(fn, calls: int, tries: int, what: str):
    """-> (the device events of ``calls`` calls in launch order, one
    call's count) from ``torch.profiler`` traces of ``calls`` + 1 calls of
    ``fn`` after a warm-up call (``per_call``): the first sequence that
    two such traces of ``tries`` show, else None.  The card's traces drop
    events now and then, and in runs of several traces (a trace has been
    seen to hold no kernel, one call's kernels, or the last kernel of the
    first call and everything after); a trace no sequence explains is
    taken again, after a pause.  A trace read by the marker split alone
    is noted in ``RELAXED`` under the phase's tag."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen: list[list[str]] = []
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls + 1):
                torch.cuda._sleep(1)
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        found = per_call(events, calls)
        if found is not None:
            read, whole = found
            one = [e.name for e in read[:len(read) // calls]]
            if one in seen:
                if not whole:
                    RELAXED.append(f"{PHASE[0]} ({what})")
                return read, len(one)
            seen.append(one)
            continue
        print(f"chip_smoke.py: profiler trace {attempt + 1} of {tries} is inconsistent "
              f"({len(events)} {what} over {calls + 1} calls and their markers): taken "
              f"again", file=sys.stderr, flush=True)
        time.sleep(0.2)
    return None


def call_kernels(fn, calls: int = 3, tries: int = 12) -> list[str] | None:
    """The CUDA kernels one call of ``fn`` launches, in launch order
    (``_traced_calls``), a split kernel by its template's name, or None."""
    traced = _traced_calls(fn, calls, tries, "kernels")
    if traced is None:
        return None
    events, n = traced
    return [next((k for k in SPLIT_KERNELS + SCAN_KERNELS if k in e.name), e.name.split("(")[0])
            for e in events[:n]]


def consistent_device_ms(fn, names=(), calls: int = 3,
                         tries: int = 12) -> tuple[dict[str, float], int] | None:
    """({name: device ms of one call of ``fn``}, device events a call) from
    the trace ``_traced_calls`` takes: the kernels, copies and fills of
    ``calls`` calls, each keyed by the first of ``names`` its name holds,
    else "other", their mean over the calls.  None if ``tries`` traces
    show no such sequence."""
    traced = _traced_calls(fn, calls, tries, "device events")
    if traced is None:
        return None
    events, per = traced
    ms: dict[str, float] = {}
    for e in events:
        key = next((n for n in names if n in e.name), "other")
        ms[key] = ms.get(key, 0.0) + e.time_range.elapsed_us() / calls / 1e3
    return ms, per


def split_text(counts, range_len: int, fn, ms: float, yard_ms: float, yard: str) -> str:
    """The [3 raster] clause of a split-walk raster: its items, longest
    item, the kernels a call launches and its time over ``yard``'s on the
    same pass (``yard_ms``)."""
    items, longest = split_shape(counts, range_len)
    kernels = call_kernels(fn)
    launched = ("the profiler recorded no consistent trace" if kernels is None else
                f"{len(kernels)} launches a call ({', '.join(kernels)})")
    return (f"split: {items} items of <= {range_len} (longest {longest}, the longest walk "
            f"{int(counts.max())}), {launched}; "
            f"/{yard} {ms / yard_ms:.3f}")


def untile_kernels(smi: str, c_img, ids, th: int, mm_passes) -> dict:
    """[3 untile], [3 untile3], [3 untile image]: both untile kernels and
    their image stores against their plain versions on the card, bitwise,
    and timed in turns with the library call or the composition each
    replaces (warm, cold L2, profiler device time).  #2 on the headline's
    tile frame (its compact colour tiles scattered, 2048², 32-row tiles);
    #2i on those compact tiles and ids; #3 and #3i on the 3-pass frame's
    tiles at 2048², 1200x800 and RAGGED_SIZE, #2i also on that frame's
    active tiles.  -> {name: kernels-line entry}."""
    import torch

    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, cdiv

    flush = cold_l2()
    entries = {}

    def entry(name, replaces, err, t, plain_ms, b, library):
        entries[name] = {
            "name": name, "route": "cuda", "source": "tinyrenderder_tpu_torch/csrc/untile.cu",
            "replaces": replaces, "max_abs_err": err, "ms": t["ms"], "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": t["other_ms"] if library else None}

    # #2: one plane in the plain layout, against permute().contiguous()
    ntx, nty = cdiv(WIDTH, TILE_W), cdiv(HEIGHT, th)
    n = (ntx, nty, th, TILE_W)
    tiles = torch.zeros((ntx * nty, th, TILE_W), dtype=torch.int32, device=DEVICE)
    tiles.index_copy_(0, ids.long(), c_img)
    diff, err = bits_equal(rs.untile_one(tiles, *n),
                           rs.untile_one_plain(tiles, *n).contiguous())
    if diff:
        fail(f"untile: {diff} words differ from the plain version")
    t = untile_ab(lambda: rs.untile_one(tiles, *n),
                  lambda: tiles.view(nty, ntx, th, TILE_W).permute(0, 2, 1, 3).contiguous(),
                  flush)
    plain_ms = time_plain(lambda: rs.untile_one_plain(tiles, *n))
    copy_cold = event_ms(lambda: tiles.clone(), before=flush)
    b = bound(2 * tiles.numel() * 4, 0)
    say(f"[3 untile] #2 {nty * th}x{ntx * TILE_W} int32 ({th}-row tiles): kernel == plain "
        f"bitwise; in turns {untile_text(t, 'library (permute + contiguous)')}; plain "
        f"{plain_ms:.4f} ms, bound {b[0]:.4f} ms; yardstick: a copy of the same bytes "
        f"(clone) with a cold L2 {copy_cold:.4f} ms | {smi}")
    entry("untile_one", "tinyrenderder_tpu/ops/raster_sparse.py:194", err, t, plain_ms, b,
          True)

    # #2i: the headline's compact tiles by id -> the (H, W, 3) image, against
    # the composition it replaces (fill + scatter, #2, crop, unpack_rgb)
    img = rs.untile_image(c_img, ids, *n, HEIGHT, WIDTH, rgb=True)
    diff, err2i = bits_equal(img, rs.untile_image_plain(c_img, ids, *n, HEIGHT, WIDTH,
                                                        rgb=True))
    if diff:
        fail(f"untile_image: {diff} bytes differ from the plain version")
    t = untile_ab(lambda: rs.untile_image(c_img, ids, *n, HEIGHT, WIDTH, rgb=True),
                  lambda: rs.unpack_rgb(rs.compact_to_image(c_img, ids, *n)[:HEIGHT, :WIDTH]),
                  flush)
    plain_ms = time_plain(lambda: rs.untile_image_plain(c_img, ids, *n, HEIGHT, WIDTH,
                                                        rgb=True))
    b2i = bound(c_img.numel() * 4 + ids.numel() * 4 + img.numel(), 0)
    say(f"[3 untile image] #2i headline {ids.numel()} compact {th}x{TILE_W} tiles -> "
        f"{HEIGHT}x{WIDTH}x3 uint8: kernel == plain bitwise; in turns "
        f"{untile_text(t, 'composition (fill + index_copy_ + #2 + crop + unpack_rgb)')}; plain "
        f"{plain_ms:.4f} ms, library none, bound {b2i[0]:.4f} ms | {smi}")
    entry("untile_image", "tinyrenderder_tpu/ops/raster_sparse.py:194", err2i, t, plain_ms,
          b2i, False)

    # #3 and #3i on the 3-pass frame's tiles; #2i on its active tiles
    frames = dict(mm_passes)
    frames[RAGGED_SIZE] = tscene.pass_tensors(tscene.multimesh_scene(*RAGGED_SIZE), DEVICE)
    err3 = err3i = 0.0
    for (w, h), passes in frames.items():
        th3 = rs.pick_tile_h(w, h)
        n3 = (cdiv(w, TILE_W), cdiv(h, th3), th3, TILE_W)
        ft, _, _ = rs.render_frame_fused(passes, w, h, DEVICE, tile_h=th3)
        what = f"{w}x{h} ({th3}-row tiles, {n3[0] * n3[1]} a plane)"
        err3 = max(err3, same_planes(f"untile3 {what}", ("colour", "depth", "winner"),
                                     rs.untile3(*ft, *n3), rs.untile3_plain(*ft, *n3)))
        err3i = max(err3i, same_planes(f"untile3_image {what}", ("rgb", "depth", "winner"),
                                       rs.untile3_image(*ft, *n3, h, w),
                                       rs.untile3_image_plain(*ft, *n3, h, w)))
        act = torch.nonzero((ft.winner >= 0).flatten(1).any(1))[:, 0].to(torch.int32)
        cc, cd = ft.color[act.long()], ft.depth[act.long()]
        for name, args, kw in (("rgb", (cc, act), {"rgb": True}),
                               ("depth, +inf where absent", (cd, act), {"fill": torch.inf}),
                               ("every tile's depth", (ft.depth, None), {})):
            diff, e = bits_equal(rs.untile_image(*args, *n3, h, w, **kw),
                                 rs.untile_image_plain(*args, *n3, h, w, **kw))
            err2i = max(err2i, e)
            if diff:
                fail(f"untile_image {name} at {what}: {diff} elements differ from plain")
        t3 = untile_ab(lambda: rs.untile3(*ft, *n3),
                       lambda: [x.view(n3[1], n3[0], th3, TILE_W).permute(0, 2, 1, 3)
                                .contiguous() for x in ft], flush)
        t3i = untile_ab(lambda: rs.untile3_image(*ft, *n3, h, w),
                        lambda: (lambda c, d, wn: (rs.unpack_rgb(c[:h, :w]), d[:h, :w],
                                                   wn[:h, :w]))(*rs.untile3(*ft, *n3)),
                        flush)
        copy3_cold = event_ms(lambda: [x.clone() for x in ft], before=flush)
        p3 = time_plain(lambda: rs.untile3_plain(*ft, *n3))
        p3i = time_plain(lambda: rs.untile3_image_plain(*ft, *n3, h, w))
        b3 = bound(2 * 3 * ft.color.numel() * 4, 0)
        b3i = bound(3 * ft.color.numel() * 4 + h * w * (3 + 4 + 4), 0)
        say(f"[3 untile3] #3 {what}: kernel == plain bitwise; in turns "
            f"{untile_text(t3, 'library (3x permute + contiguous)')}; plain {p3:.4f} ms, "
            f"bound {b3[0]:.4f} ms; yardstick: a copy of the three planes (3 clones) with "
            f"a cold L2 {copy3_cold:.4f} ms | {smi}")
        say(f"[3 untile image] #3i {what} -> rgb, depth, winner cropped: kernel == plain "
            f"bitwise; in turns {untile_text(t3i, 'composition (#3 + crops + unpack_rgb)')}; "
            f"plain {p3i:.4f} ms, library none, bound {b3i[0]:.4f} ms; #2i == plain on its "
            f"{act.numel()} active tiles (rgb, depth) and the crop of every tile | {smi}")
        if (w, h) == FRAME_SIZES[0]:
            entry("untile3", "tinyrenderder_tpu/ops/raster_sparse.py:150", 0.0, t3, p3, b3,
                  True)
            entry("untile3_image", "tinyrenderder_tpu/ops/raster_sparse.py:150", 0.0, t3i,
                  p3i, b3i, False)
    entries["untile3"]["max_abs_err"] = err3
    entries["untile3_image"]["max_abs_err"] = err3i
    entries["untile_image"]["max_abs_err"] = err2i
    return entries


def experimental_kernels(head_pass, active_ids, th: int, smi: str):
    """[3 experimental]: the ports of the scripts' three kernels, each held
    against its plain version on the card, bitwise, at the scripts' shapes
    and at the headline's, driven once through its user function with
    the counts zeroed.  -> ({name: kernels-line entry}, main-path
    launches)."""
    import numpy as np
    import torch

    from tinyrenderder_tpu_torch import _build
    from tinyrenderder_tpu_torch.experimental import fine_raster as xfr
    from tinyrenderder_tpu_torch.experimental import inplace_blocks as xib
    from tinyrenderder_tpu_torch.experimental import rank_kernel as xrk
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops.raster_tiled import (TILE_W, bin_triangles_csr,
                                                          build_bins, to_tiles, vertex_stage)

    entries, totals = {}, dict.fromkeys(launch_counts(), 0)

    def main_path(name, fn):
        result, counts = counted(fn)
        if not counts[name]:
            fail(f"{name} never launched on its main path: {counts}")
        for k, v in counts.items():
            totals[k] += v
        return result, counts[name]

    # #7 the prototype strip raster: the script's three Gouraud passes at
    # 128x64 (and the script's own check against the production raster),
    # the tie piles, then the headline head at 2048², 8-row tiles
    r7 = xfr.range_rows()

    def proto_kernels(fn, recs):
        """The kernels a call launches, failing unless they are the split
        walk's three where the records outgrow one range, else the walk alone."""
        want = (["item_scan_kernel", "proto_walk_kernel", "proto_merge_kernel"]
                if recs.shape[1] > r7 else ["proto_walk_kernel"])
        got = call_kernels(fn)
        if got is None:
            fail(f"strip_raster_proto on records {tuple(recs.shape)}: no consistent "
                 f"profiler trace of its kernels")
        if got != want:
            fail(f"strip_raster_proto on records {tuple(recs.shape)} launched {got}, not {want}")
        return got

    w, h = 128, 64
    for name, setup in xfr.script_setups(DEVICE, w, h).items():
        recs, rows, ntx, _, total = xfr.build_strip_records(setup, w, h)
        init = torch.full((recs.shape[0], xfr.TILE_H, TILE_W), torch.inf, device=DEVICE)
        call = partial(xfr.strip_raster, recs, rows, init, ntx, row_total=total)
        same_planes(f"strip_raster_proto, script's {name}", ("depth", "winner"), call(),
                    xfr.strip_raster_plain(recs, rows, init, ntx))
        kern = proto_kernels(call, recs)
        cov_ok, win_ok, ulps, shape = xfr.check_against_coarse(setup, w, h)
        if not cov_ok or ulps > 4:
            fail(f"the script's check on {name}: coverage_ok={cov_ok} depth_ulps={ulps}")
        say(f"[3 experimental] strip_raster_proto, script's {name} {w}x{h}: kernel == plain "
            f"bitwise, {len(kern)} launch a call ({', '.join(kern)}); the script's check "
            f"against coarse_raster_plain over 8-row tiles: coverage_ok={cov_ok} "
            f"winners_ok={win_ok} depth_ulps={ulps} recs={shape}")
    for n_tie in (100, 300):
        recs, rows, init, ntx = (t.to(DEVICE) if torch.is_tensor(t) else t
                                 for t in xfr.tie_pile(n_tie))
        got = xfr.strip_raster(recs, rows, init, ntx)
        same_planes(f"strip_raster_proto, tie pile of {n_tie}", ("depth", "winner"), got,
                    xfr.strip_raster_plain(recs, rows, init, ntx))
        wins = sorted(torch.unique(got[1]).tolist())
        if wins != [0, 1, n_tie + 2]:
            fail(f"strip_raster_proto, tie pile of {n_tie}: winners {wins}")
        kern = proto_kernels(partial(xfr.strip_raster, recs, rows, init, ntx,
                                     row_total=int(rows[0])), recs)
        say(f"[3 experimental] strip_raster_proto, tie pile of {n_tie} ties + 3 rows "
            f"({-(-int(rows[0]) // r7)} ranges of {r7}): kernel == plain bitwise; winners "
            f"{wins} (the first drawn keeps every tie across the ranges, the nearer "
            f"triangle where it covers); {len(kern)} launches a call ({', '.join(kern)})")
    h_attrs, h_shader, h_uniforms = head_pass
    setup = vertex_stage(h_attrs, h_uniforms, h_shader, WIDTH, HEIGHT)[0]
    init_img = torch.full((HEIGHT, WIDTH), torch.inf, device=DEVICE)
    (d_img, w_img, shape), n7 = main_path(
        "strip_raster_proto", lambda: xfr.strip_rasterize(setup, init_img, WIDTH, HEIGHT))
    recs, rows, ntx, nty, row_sum = xfr.build_strip_records(setup, WIDTH, HEIGHT)
    init_t = to_tiles(init_img, nty, ntx, xfr.TILE_H, TILE_W, torch.inf)
    call7 = partial(xfr.strip_raster, recs, rows, init_t, ntx, row_total=row_sum)
    k7 = call7()
    err7 = same_planes("strip_raster_proto, headline", ("depth", "winner"), k7,
                       xfr.strip_raster_plain(recs, rows, init_t, ntx))
    from tinyrenderder_tpu_torch.ops.raster_sparse import untile_one_plain
    same_planes("strip_rasterize, headline", ("depth", "winner"), (d_img, w_img),
                [untile_one_plain(x, ntx, nty, xfr.TILE_H, TILE_W)[:HEIGHT, :WIDTH]
                 for x in k7])
    g = recs.shape[0]

    def walk_alone():
        """The walk alone over every group: one block a group walking all
        of its rows, the schedule of the kernel before the split."""
        d, wn = torch.empty_like(init_t), torch.empty_like(init_t, dtype=torch.int32)
        _build.call("trt_strip_proto", recs.device, recs.data_ptr(), rows.data_ptr(), g,
                    recs.shape[1], init_t.data_ptr(), d.data_ptr(), wn.data_ptr(), ntx, g, None)
        return d, wn
    same_planes("strip_raster_proto, headline, the walk alone", ("depth", "winner"),
                walk_alone(), k7)
    kern7 = proto_kernels(call7, recs)
    ms7 = event_ms(call7)
    alone_ms, split_ms = in_turns(walk_alone, call7)
    dev7 = device_ms(call7, ("item_scan", "proto_walk", "proto_merge"))
    plain7 = time_plain(lambda: xfr.strip_raster_plain(recs, rows, init_t, ntx))
    items7, longest7 = split_shape(rows, r7)
    pairs = int((recs.view(g, recs.shape[1], 8, 16)[..., 9] >= 0).sum())
    b7 = bound(row_sum * TILE_W * 4 + g * 4 + 3 * g * xfr.TILE_H * TILE_W * 4,
               pairs * xfr.TILE_H * 16 * OPS_TEST)
    bins = bin_triangles_csr(setup, WIDTH, HEIGHT, TILE_W, th)
    rec_d = rc.build_tri_records(setup)
    init_d = to_tiles(init_img, bins.n_tiles_y, bins.n_tiles_x, th, TILE_W, torch.inf)
    dense_ms = event_ms(lambda: rc.dense_raster(rec_d, bins.sorted_tri, bins.start[:-1],
                                                bins.counts, init_d, bins.n_tiles_x, th,
                                                TILE_W, 0))
    say(f"[3 experimental] strip_raster_proto, headline head {WIDTH}x{HEIGHT} ({g} groups of "
        f"8x128, recs {shape}, {pairs} strip pairs, {row_sum} rows walked, "
        f"{int((w_img >= 0).sum())} pixels won): kernel == plain bitwise, == the walk alone, "
        f"strip_rasterize == the kernel's tiles untiled; split: {items7} items of <= {r7} rows "
        f"(longest {longest7}, the longest group {int(rows.max())}), "
        f"{int((rows > r7).sum())} groups of more than one range, {int((rows == 0).sum())} "
        f"of no row, {len(kern7)} launches a call ({', '.join(kern7)}); kernel {ms7:.4f} ms, "
        f"device {device_text(dev7)}; in turns the walk alone (one block a group) "
        f"{alone_ms:.4f} -> split {split_ms:.4f} ms; the serial kernel before (recorded): "
        f"{ms_text(SERIAL_MS['strip_raster_proto'])}; plain {plain7:.4f} ms, library none, "
        f"bound {b7[0]:.4f} ms ({b7[1]}); yardstick: the depth-only dense coarse launch on "
        f"the same pass ({th}-row tiles) {dense_ms:.4f} ms; launches {n7} | {smi}")
    entries["strip_raster_proto"] = {
        "name": "strip_raster_proto", "route": "cuda",
        "source": "tinyrenderder_tpu_torch/csrc/fine_raster.cu",
        "replaces": "scripts/experimental_fine_raster.py:73",
        "max_abs_err": err7, "ms": ms7, "plain_ms": plain7, "bound_ms": b7[0],
        "bound_by": b7[1], "library_ms": None}

    # #8 the pair-rank kernel: the script's 60,000 synthetic triangles (seed
    # 7, 80 x 50 strips), 246,240 of the same distribution (its main path)
    # and a one-strip pile of 246,240
    nsx, nty = 80, 50
    rank_sets = {"60000 synthetic": xrk.synthetic_set(60000, nsx=nsx, nty=nty),
                 "246240 synthetic": xrk.synthetic_set(246240, nsx=nsx, nty=nty),
                 "246240 one-strip pile": xrk.pile_set(246240)}
    err8 = 0.0
    for label, data in rank_sets.items():
        f = len(data[0])
        args = [torch.from_numpy(a).to(DEVICE) for a in data]
        if label == "246240 synthetic":
            got, n8 = main_path("rank_pairs", lambda: xrk.rank_pairs_kernel(*args, nsx))
        else:
            got = xrk.rank_pairs_kernel(*args, nsx)
        err8 = max(err8, same_planes(f"rank_pairs, {label}", ("strips", "ranks"), got,
                                     xrk.rank_pairs_plain(*args, nsx)))
        s_ref, r_ref = xrk.reference_ranks(*data, nsx, f)
        s_k, r_k = (x.cpu().numpy() for x in got)
        live = s_ref >= 0
        if not ((s_k == s_ref).all() and (r_k[live] == r_ref[live]).all()
                and not r_k[~live].any()):
            fail(f"rank_pairs, {label}: differs from reference_ranks")
        total = int(data[3].sum())
        ms8 = event_ms(lambda: xrk.rank_pairs_kernel(*args, nsx))
        launch8 = event_ms(lambda: xrk.launch(*args, nsx))
        dev8 = device_ms(lambda: xrk.launch(*args, nsx), ("rank_hist", "rank_scan", "rank_walk"))
        plain8 = time_plain(lambda: xrk.rank_pairs_plain(*args, nsx))
        lib8 = event_ms(lambda: build_bins(*args, total, nsx, nty))
        b8 = bound(f * 4 * 4 + 2 * f * xrk.S_CAP * 4, 0)
        g8, r8 = xrk.ranges(f * xrk.S_CAP,
                            torch.cuda.get_device_properties(0).multi_processor_count)
        before = SERIAL_MS.get(f"rank_pairs {label}")
        say(f"[3 experimental] rank_pairs, {label} triangles ({total} pairs; {g8} ranges of "
            f"{r8} slots): kernel == plain bitwise, == reference_ranks (padded ranks 0); "
            f"rank_pairs_kernel {ms8:.4f} ms, its launches alone {launch8:.4f} ms, device "
            f"{device_text(dev8)}, plain {plain8:.4f} ms, library (build_bins: stable torch.sort + "
            f"searchsorted) {lib8:.4f} ms, bound {b8[0]:.4f} ms ({b8[1]}); the serial kernel "
            f"before: {ms_text(before)} | {smi}")
        if label == "246240 synthetic":
            entries["rank_pairs"] = {
                "name": "rank_pairs", "route": "cuda",
                "source": "tinyrenderder_tpu_torch/csrc/rank_kernel.cu",
                "replaces": "scripts/experimental_rank_kernel.py:64",
                "ms": ms8, "plain_ms": plain8, "bound_ms": b8[0], "bound_by": b8[1],
                "library_ms": lib8}
    entries["rank_pairs"]["max_abs_err"] = err8

    # #9 the in-place block update: the probe's image and ids, then the
    # headline's tile shape (2048², 32x128 blocks): its active tiles + a
    # repeat (the main path), and every active tile four times, shuffled
    img0 = np.arange(xib.H * xib.W, dtype=np.float32).reshape(xib.H, xib.W) * np.float32(0.001)
    ids = torch.tensor([1, 3, 3, 6], dtype=torch.int32, device=DEVICE)
    probe = torch.from_numpy(img0).to(DEVICE)
    got = xib.run(probe.clone(), ids, 10.0, 4)
    same_planes("inplace_blocks, the probe", ("image",), (got,),
                (xib.run_plain(probe.clone(), ids, 10.0, 4),))
    same_planes("inplace_blocks, the probe", ("expected image",), (got.cpu(),),
                (torch.from_numpy(xib.expected_image(img0, [1, 3, 3, 6], 10.0)),))
    blk3 = (got.cpu().numpy() - img0)[16:32, 128:256]
    say(f"[3 experimental] inplace_blocks: the probe's ids [1, 3, 3, 6] == plain == the f32 "
        f"expected image bitwise, block 3 + ({float(blk3.min())}, {float(blk3.max())}) = "
        f"(x + 1.0 * 10) + 3, once")
    rng = np.random.default_rng(9)
    big = torch.from_numpy(rng.standard_normal((HEIGHT, WIDTH)).astype(np.float32)).to(DEVICE)
    n_act = active_ids.shape[0]
    perm = torch.from_numpy(np.random.default_rng(4).permutation(4 * n_act)).to(DEVICE)
    id_lists = {f"{n_act} active tiles + 1 repeat":
                torch.cat([active_ids, active_ids[n_act // 2:][:1]]),
                f"{n_act} active tiles x 4, shuffled": active_ids.repeat(4)[perm].contiguous()}
    block = (th, TILE_W)
    n_blk = HEIGHT // th * (WIDTH // TILE_W)

    def tiles_of(x):
        return x.view(HEIGHT // th, th, WIDTH // TILE_W, TILE_W).transpose(1, 2)
    unvisited = torch.ones(n_blk, dtype=torch.bool, device=DEVICE)
    unvisited[active_ids.long()] = False
    tiles = torch.zeros((n_blk, th, TILE_W), device=DEVICE)
    upd = torch.ones((n_act, th, TILE_W), device=DEVICE)
    err9 = 0.0
    for k, (label, ids9) in enumerate(id_lists.items()):
        n_ids = ids9.shape[0]
        if k == 0:
            work, n9 = main_path("inplace_blocks",
                                 lambda: xib.run(big.clone(), ids9, 10.0, n_ids, block))
        else:
            work = xib.run(big.clone(), ids9, 10.0, n_ids, block)
        err9 = max(err9, same_planes(f"inplace_blocks, headline tiles, {label}", ("image",),
                                     (work,),
                                     (xib.run_plain(big.clone(), ids9, 10.0, n_ids, block),)))
        if not torch.equal(tiles_of(work).reshape(-1, th, TILE_W)[unvisited].view(torch.int32),
                           tiles_of(big).reshape(-1, th, TILE_W)[unvisited].view(torch.int32)):
            fail(f"inplace_blocks, {label}: an unvisited block changed")
        # run and index_copy_ (on the kernel's int32 ids: it takes int64
        # only) in turns, run first and last: both are a few host µs apart
        # and the host drifts between measurements
        ms9, lib9 = in_turns(lambda: xib.run(work, ids9, 10.0, n_ids, block),
                             lambda: tiles.index_copy_(0, active_ids.long(), upd))
        launch9 = event_ms(lambda: xib.launch(work, ids9, 10.0, n_ids, th, TILE_W))
        dev9 = device_ms(lambda: xib.launch(work, ids9, 10.0, n_ids, th, TILE_W),
                         ("inplace_blocks_kernel",))
        plain9 = time_plain(lambda: xib.run_plain(work, ids9, 10.0, n_ids, block))
        b9 = bound(2 * n_act * th * TILE_W * 4 + n_ids * 4, 0)
        say(f"[3 experimental] inplace_blocks, headline tile shape ({WIDTH}x{HEIGHT}, "
            f"{th}x{TILE_W} blocks, {n_ids} ids = {label}): kernel == plain bitwise, unvisited "
            f"blocks bit-unchanged; run {ms9:.4f} ms (in turns with the library), its launch "
            f"alone {launch9:.4f} ms, device {device_text(dev9)}, plain {plain9:.4f} ms, library (index_copy_ of the {n_act} "
            f"updated blocks into a tiled plane) {lib9:.4f} ms, bound {b9[0]:.4f} ms "
            f"({b9[1]}); the kernel before (dedup launches + one kernel): "
            f"{ms_text(SERIAL_MS['inplace_blocks'] if k == 0 else None)} | {smi}")
        if k == 0:
            entries["inplace_blocks"] = {
                "name": "inplace_blocks", "route": "cuda",
                "source": "tinyrenderder_tpu_torch/csrc/inplace_blocks.cu",
                "replaces": "scripts/probe_inplace_blocks.py:31",
                "ms": ms9, "plain_ms": plain9, "bound_ms": b9[0], "bound_by": b9[1],
                "library_ms": lib9}
    entries["inplace_blocks"]["max_abs_err"] = err9
    say(f"[3 experimental] main-path launches: rank_pairs {n8}, inplace_blocks {n9}")
    return entries, totals


def shaded_800(smi: str) -> dict:
    """[3 gouraud/textured 800]: the Gouraud and Textured head at 800²
    (``bench.py``'s gouraud_800 and textured_800) through
    ``render_scene_image`` and ``render_scene``, each equal to the f32
    oracle bitwise.  -> main-path launches."""
    import numpy as np
    import torch

    from tinyrenderder_tpu_torch import scene as tscene

    totals = dict.fromkeys(launch_counts(), 0)
    for kind in ("gouraud", "textured"):
        sc = tscene.headline_scene(SHADED_SIZE, SHADED_SIZE, kind)
        t0 = time.perf_counter()
        ref = tscene.oracle_render(sc)
        oracle_s = time.perf_counter() - t0
        (image, frame), counts = counted(lambda: (tscene.render_scene_image(sc, DEVICE),
                                                  tscene.render_scene(sc, DEVICE)))
        for k, v in counts.items():
            totals[k] += v
        if not (counts["untile_image"] and counts["untile3_image"]
                and sum(counts[f"{m}_raster"] + counts[f"{m}_raster_stats"] for m in MODES)):
            fail(f"a kernel of the {kind}_800 routes never launched: {counts}")
        if not np.array_equal(image.cpu().numpy(), ref.color):
            fail(f"{kind}_800: render_scene_image differs from the f32 oracle")
        for plane in ("color", "depth", "full_depth"):
            diff, err = bits_equal(getattr(frame, plane).cpu(),
                                   torch.from_numpy(np.ascontiguousarray(getattr(ref, plane))))
            if diff:
                fail(f"{kind}_800 {plane}: {diff} elements differ from the f32 oracle "
                     f"(max abs err {err})")
        if frame.stats != ref.stats:
            fail(f"{kind}_800 stats differ from the oracle's:\n  port   {frame.stats}\n"
                 f"  oracle {ref.stats}")
        say(f"[3 gouraud/textured 800] {kind}_{SHADED_SIZE} ({sc.passes[0].mesh.nfaces} faces, "
            f"{type(sc.passes[0].shader).__name__}): render_scene_image and render_scene "
            f"(colour, depth, full depth, stats) == float32 oracle bitwise "
            f"({int(np.isfinite(ref.full_depth).sum())} covered; oracle {oracle_s:.1f} s on "
            f"the host); launches {counts} | {smi}")
    return totals


def same_frame(what: str, got, want) -> None:
    """Fail unless a port frame (tensors) equals an oracle frame (NumPy):
    colour, output depth and full depth bitwise, equal stats."""
    import numpy as np
    import torch
    for plane in ("color", "depth", "full_depth"):
        diff, err = bits_equal(getattr(got, plane).cpu(),
                               torch.from_numpy(np.ascontiguousarray(getattr(want, plane))))
        if diff:
            fail(f"{what} {plane}: {diff} elements differ from the f32 oracle (max abs err "
                 f"{err})")
    if got.stats != want.stats:
        fail(f"{what} stats differ from the oracle's:\n  port   {got.stats}\n  oracle "
             f"{want.stats}")


def same_image(what: str, image, want) -> None:
    import numpy as np
    got = image.cpu().numpy()
    if got.shape != want.shape or (got != want).any():
        bad = int((got != want).any(axis=-1).sum()) if got.shape == want.shape else -1
        fail(f"{what}: {bad} pixels differ from the f32 oracle")


def nonzero(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def host_phase(smi: str) -> dict:
    """[16 host]: the scene entry methods with their device caches.  The
    headline head written as PLY, STL, OFF and GLB, loaded back through
    ``ModelManager``, framed by ``setup_camera_for_rendering`` and rendered
    through ``Scene.render_image`` and ``Scene.render`` == the f32 oracle;
    a second frame through the caches == the first, its attribute tensors
    where they were; a vertex moved in place + ``invalidate_device_cache``
    and a rebound diffuse map == their oracles; then cold (caches dropped
    before each frame), warm and pre-uploaded ms/frame of five scenes, in
    turns.  -> main-path launches."""
    import math

    import numpy as np
    import torch

    from tinyrenderder_tpu_torch import animation, math3d, shadows
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.camera import Camera, setup_camera_for_rendering
    from tinyrenderder_tpu_torch.models import procedural
    from tinyrenderder_tpu_torch.models.manager import ModelManager
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.shaders import PhongShader

    totals = dict.fromkeys(launch_counts(), 0)

    def count(fn, what, need):
        result, counts = counted(fn)
        for k, v in counts.items():
            totals[k] += v
        if not all(counts[k] for k in need):
            fail(f"a kernel of {what} never launched: {counts}")
        return result, counts

    image_need, frame_need = ("coarse_raster", "untile_image"), ("coarse_raster_stats",
                                                                 "untile3_image")
    key, fill, rim = tscene._lights()

    # ---- loaded models, rendered on the card through both entries ----
    head = procedural.bumpy_head(96, 144)
    manager = ModelManager()
    with tempfile.TemporaryDirectory() as tmp:
        for ext, writer in MODEL_WRITERS.items():
            path = Path(tmp) / f"head{ext}"
            writer(path, head)
            mesh = manager.load_model(str(path))
            if mesh is None or mesh.nfaces != head.nfaces:
                fail(f"{ext}: ModelManager loaded {mesh and mesh.nfaces} faces of "
                     f"{head.nfaces}")
            mesh.materials = [procedural.default_head_material(256)]
            sc = tscene.Scene(camera=Camera(), width=REF_W, height=REF_H)
            sc.add(mesh, math3d.identity4(), PhongShader(key, fill, rim, 0.5), name=ext)
            setup_camera_for_rendering(sc.camera, sc.world_aabbs(), REF_W, REF_H)
            image, li = count(lambda: sc.render_image(), f"{ext} render_image", image_need)
            res, lr = count(lambda: sc.render(), f"{ext} render", frame_need)
            ref = tscene.oracle_render(sc)
            same_image(f"{ext} render_image", image, ref.color)
            same_frame(f"{ext} render", res, ref)
            say(f"[16 host] {ext}: {mesh.nfaces} faces, {mesh.nverts} vertices loaded through "
                f"ModelManager, framed by setup_camera_for_rendering at {REF_W}x{REF_H}: "
                f"render_image and render == f32 oracle bitwise, stats equal "
                f"({int(np.isfinite(ref.full_depth).sum())} covered), errors 0; launches "
                f"render_image {nonzero(li)}, render {nonzero(lr)}")
    if sorted(manager.stats()) != sorted(f"head{e}" for e in MODEL_WRITERS):
        fail(f"ModelManager holds {manager.stats()}")

    # ---- the caches keep the frames right ----
    scenes = {"head_phong_2048": tscene.headline_scene(WIDTH, HEIGHT),
              f"multimesh_{REF_W}x{REF_H}": tscene.multimesh_scene(REF_W, REF_H)}
    for name, sc in scenes.items():
        tscene.clear_caches(sc)
        first_img = sc.render_image()
        ptrs = [t.data_ptr() for p in sc.passes
                for t in p.mesh.device_face_attributes(np.float32, DEVICE).values()]
        first = sc.render()
        (second_img, li), (second, lr) = (
            count(lambda: sc.render_image(), f"{name} second render_image", ("untile_image",)
                  if len(sc.passes) == 1 else ("untile3_image",)),
            count(lambda: sc.render(), f"{name} second render", frame_need))
        if ptrs != [t.data_ptr() for p in sc.passes
                    for t in p.mesh.device_face_attributes(np.float32, DEVICE).values()]:
            fail(f"{name}: the cached attribute tensors moved between frames")
        if not torch.equal(first_img, second_img):
            fail(f"{name}: the second render_image differs from the first")
        for plane in ("color", "depth", "full_depth"):
            if not torch.equal(getattr(first, plane), getattr(second, plane)):
                fail(f"{name}: the second render's {plane} differs from the first")
        if first.stats != second.stats:
            fail(f"{name}: the second render's stats differ from the first's")
        say(f"[16 host] {name}: the second frame through render_image and render == the "
            f"first bitwise ({len(ptrs)} cached attribute tensors kept their data_ptr); "
            f"launches render_image {nonzero(li)}, render {nonzero(lr)}")
    sc = scenes[f"multimesh_{REF_W}x{REF_H}"]
    base = sc.render()
    mesh = sc.passes[0].mesh                          # the head
    moved = int(np.argmax(mesh.positions[:, 2]))
    kept = mesh.positions[moved].copy()
    mesh.positions[moved] += (0.3, 0.3, 0.3)
    mesh.invalidate_device_cache()
    got, lm = count(lambda: sc.render(), "the invalidated frame", frame_need)
    same_frame("moved vertex + invalidate_device_cache", got, tscene.oracle_render(sc))
    changed = int((got.color != base.color).any(dim=-1).sum())
    mesh.positions[moved] = kept
    mesh.invalidate_device_cache()
    material = mesh.materials[0]
    diffuse = material.diffuse
    material.diffuse = procedural.noise_texture(diffuse.shape[0])
    got_t, lt = count(lambda: sc.render(), "the rebound texture's frame", frame_need)
    same_frame("rebound material.diffuse", got_t, tscene.oracle_render(sc))
    changed_t = int((got_t.color != base.color).any(dim=-1).sum())
    material.diffuse = diffuse
    if not (changed and changed_t):
        fail(f"the moved vertex changed {changed} pixels, the new texture {changed_t}")
    say(f"[16 host] multimesh_{REF_W}x{REF_H}: head vertex {moved} moved in place + "
        f"invalidate_device_cache -> == f32 oracle of the moved mesh bitwise ({changed} "
        f"pixels changed); material.diffuse rebound -> == f32 oracle of the new texture "
        f"({changed_t} pixels changed); launches {nonzero(lm)}, {nonzero(lt)}")

    # ---- host-layer ms/frame: cold, warm, pre-uploaded, in turns ----
    def host_ms(frame, pre, drop) -> dict:
        turns = {"cold": [], "warm": [], "pre": []}
        for arm in ("cold", "warm", "pre", "pre", "warm", "cold"):
            turns[arm].append(event_ms({"cold": frame, "warm": frame, "pre": pre}[arm],
                                       before=drop if arm == "cold" else None))
        return {k: statistics.fmean(v) for k, v in turns.items()}

    def drop(*scs):
        return lambda: [tscene.clear_caches(s) for s in scs]

    rows = {}
    head_sc = scenes["head_phong_2048"]
    th = rs.pick_tile_h(WIDTH, HEIGHT)
    head_passes = tscene.pass_tensors(head_sc, DEVICE)
    rows["head_phong_2048 (render_image)"] = host_ms(
        lambda: head_sc.render_image(),
        lambda: rs.render_frame_fused_image(head_passes, WIDTH, HEIGHT, tile_h=th),
        drop(head_sc))
    ref_sc = tscene.multimesh_scene(REF_W, REF_H)
    ref_passes = tscene.pass_tensors(ref_sc, DEVICE)
    rows[f"reference_default_{REF_W}x{REF_H}, no post (render)"] = host_ms(
        lambda: ref_sc.render(collect_stats=False).color,
        lambda: tscene.render_passes(ref_passes, REF_W, REF_H, DEVICE)[0].color,
        drop(ref_sc))
    wall = tscene.stress_scene(WALL_W, WALL_H)
    wall_passes = tscene.pass_tensors(wall, DEVICE)
    th_w = rs.pick_tile_h(WALL_W, WALL_H)
    rows[f"sponza_scale_246k_{WALL_W}x{WALL_H} (render_image)"] = host_ms(
        lambda: wall.render_image(),
        lambda: rs.render_frame_fused_image(wall_passes, WALL_W, WALL_H, tile_h=th_w),
        drop(wall))
    sh_scene = tscene.multimesh_scene(SHADOW_W, SHADOW_H)
    sh_key = sh_scene.passes[0].shader.key_light_world
    settings = shadows.ShadowSettings(size=SHADOW_SIZE)
    light_cam = shadows.light_camera_for_scene(sh_scene, sh_key, settings)
    light_sc = shadows.depth_scene(sh_scene, light_cam, settings)
    smap = shadows.render_depth_from_light(sh_scene, light_cam, settings, DEVICE)
    lit_sc = shadows.shadowed_scene(sh_scene, sh_key, smap, light_cam, settings)
    light_passes = tscene.pass_tensors(light_sc, DEVICE, frustum_cull=False)
    lit_passes = tscene.pass_tensors(lit_sc, DEVICE, frustum_cull=False)
    rows[f"shadow_phong_{SHADOW_W} (render_with_shadows)"] = host_ms(
        lambda: shadows.render_with_shadows(sh_scene, sh_key, settings, DEVICE,
                                            frustum_cull=False, collect_stats=False)[0].color,
        lambda: staged_shadow_frame(light_passes, lit_passes, SHADOW_W, SHADOW_H, SHADOW_SIZE),
        drop(sh_scene, light_sc, lit_sc))
    orbit = tscene.multimesh_scene(WIDTH, WIDTH)
    eye0, target0 = orbit.camera.params.eye.copy(), orbit.camera.params.target.copy()
    orbit_passes = tscene.pass_tensors(orbit, DEVICE, frustum_cull=False)
    step = iter(range(10 ** 6))

    def orbit_frame():
        i = next(step)
        orbit.camera.set_eye(animation.orbit_eye(eye0, target0, 2 * math.pi * i / 120))
        return tscene.render_scene(orbit, DEVICE, frustum_cull=False,
                                   collect_stats=False).color

    rows[f"animation_multimesh_{WIDTH} orbit (render_scene, eye moving)"] = host_ms(
        orbit_frame,
        lambda: tscene.render_passes(orbit_passes, WIDTH, WIDTH, DEVICE)[0].color,
        drop(orbit))
    for name, ms in rows.items():
        say(f"[16 host] timing {name}: cold {ms['cold']:.3f} ms/frame (caches dropped before "
            f"each frame), warm {ms['warm']:.3f}, pre-uploaded {ms['pre']:.3f}; warm - pre "
            f"{ms['warm'] - ms['pre']:.3f}, cold - warm {ms['cold'] - ms['warm']:.3f} (CUDA "
            f"events around the host call, {WARMUP} warm-up + median of {FRAMES}, in turns "
            f"cold, warm, pre, pre, warm, cold) | {smi}")
    return totals


def sharded_phase(smi: str, head_scene, head_ref, stress_scene, stress_ref, record) -> dict:
    """[17 sharded]: the sharded backends (``parallel/dist.py``).  A world
    of one rank: the headline through ``Scene.render_image`` and
    ``Scene.render`` with ``backend="sharded"`` == the f32 oracle, and the
    JAX bench's one-device sharded frame (``render_frame_fused_sharded`` +
    ``tiles_to_buffers_sharded(...).color`` at ``pick_tile_h``) timed in
    turns with ``render_frame_fused`` + ``tiles_to_buffers``.  Then 4 ranks
    emulated on the card (``dist.emulated_mesh``; NCCL refuses two ranks
    on one GPU): the headline on 4 interleaved bands (32-row tiles, 64
    tile rows) and on a 2x2 grid, the stress scene (16-row tiles, 50 tile
    rows) on ``even_unequal_bands(50, 4)`` and on measured bands, each on
    the three rasters: the frame with stats, without, and (row bands) the
    image, each == the f32 oracle bitwise, stats equal.  Last, #1, #1s, #4
    and #4s at an interleaved band's origin and ``y_stride``, 32- and
    16-row tiles, == their plain versions bitwise.  -> main-path
    launches."""
    import numpy as np
    import torch

    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_fine as rf
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, Band, cdiv
    from tinyrenderder_tpu_torch.parallel import dist
    from tinyrenderder_tpu_torch.utils.stats import RenderStats

    t_phase = time.perf_counter()
    totals = dict.fromkeys(launch_counts(), 0)

    def count(fn, what, need):
        result, counts = counted(fn)
        for k, v in counts.items():
            totals[k] += v
        if not all(counts[k] for k in need):
            fail(f"a kernel of {what} never launched: {counts}")
        return result, counts

    def same(what, got, want):
        diff, err = bits_equal(got.cpu(), torch.from_numpy(np.ascontiguousarray(want)))
        if diff:
            fail(f"{what}: {diff} elements differ from the f32 oracle (max abs err {err})")

    # ---- a world of one rank ----
    image, li = count(lambda: head_scene.render_image(DEVICE, backend="sharded"),
                      "the one-rank sharded image", ("coarse_raster", "untile_image"))
    res, lr = count(lambda: head_scene.render(DEVICE, backend="sharded"),
                    "the one-rank sharded frame", ("coarse_raster_stats", "untile3_image"))
    same("one-rank render_image(backend='sharded')", image, head_ref.color)
    same_frame("one-rank render(backend='sharded')", res, head_ref)
    mesh1 = dist.make_mesh(device=DEVICE)
    say(f"[17 sharded] world of one rank ({mesh1.size} rank on {mesh1.device}): headline "
        f"{WIDTH}x{HEIGHT} "
        f"render_image and render with backend='sharded' == f32 oracle bitwise, stats equal; "
        f"launches render_image {nonzero(li)}, render {nonzero(lr)}")
    passes = tscene.pass_tensors(head_scene, DEVICE)
    th = rs.pick_tile_h(WIDTH, HEIGHT)

    def sharded_frame():
        ft, _, _ = dist.render_frame_fused_sharded(mesh1, passes, WIDTH, HEIGHT, tile_h=th)
        return dist.tiles_to_buffers_sharded(mesh1, ft, WIDTH, HEIGHT, tile_h=th).color

    def fused_frame():
        ft, _, _ = rs.render_frame_fused(passes, WIDTH, HEIGHT, DEVICE, tile_h=th)
        return rs.tiles_to_buffers(ft, WIDTH, HEIGHT, th).color

    if not torch.equal(sharded_frame(), fused_frame()):
        fail("the one-rank sharded frame differs from render_frame_fused's")
    rounds = [[event_ms(fn) for fn in (sharded_frame, fused_frame, fused_frame, sharded_frame)]
              for _ in range(MESH1_ROUNDS)]
    arms = {"sharded": [t for r in rounds for t in (r[0], r[3])],
            "fused": [t for r in rounds for t in (r[1], r[2])]}
    ratios = [(r[0] + r[3]) / (r[1] + r[2]) for r in rounds]
    device = {"sharded": device_total(sharded_frame), "fused": device_total(fused_frame)}
    say(f"[17 timing] phong_2048_sharded_mesh1 (bench.py::bench_sharded_mesh1's frame, th "
        f"{th}): render_frame_fused_sharded + tiles_to_buffers_sharded "
        + "; render_frame_fused + tiles_to_buffers ".join(
            f"{statistics.median(v):.3f} ms/frame (turns {min(v):.3f}-{max(v):.3f}, device "
            f"{device[k]:.3f})" for k, v in arms.items())
        + f"; sharded/fused a round {', '.join(f'{x:.3f}' for x in ratios)}, median "
        f"{statistics.median(ratios):.3f} (CUDA events, {WARMUP} warm-up + median of {FRAMES} a "
        f"turn, {MESH1_ROUNDS} rounds of turns sharded, fused, fused, sharded; device: "
        f"torch.profiler, every kernel, copy and fill of a frame) | {smi}")

    # ---- 4 ranks emulated on the card ----
    stress_passes = tscene.pass_tensors(stress_scene, DEVICE)
    th_w = rs.pick_tile_h(WALL_W, WALL_H)
    nty_w = cdiv(WALL_H, th_w)
    measured = dist.balance_bands(dist.measure_tile_row_costs(stress_passes, WALL_W, WALL_H),
                                  4)
    layouts = {  # name: (scene, ref, passes, w, h, th, mesh, interleave, bands)
        "headline interleaved 4": (head_scene, head_ref, passes, WIDTH, HEIGHT, th,
                                   dist.emulated_mesh(4, device=DEVICE), True, None),
        "headline grid 2x2": (head_scene, head_ref, passes, WIDTH, HEIGHT, th,
                              dist.emulated_mesh(2, 2, DEVICE), False, None),
        f"stress even_unequal_bands({nty_w}, 4)": (
            stress_scene, stress_ref, stress_passes, WALL_W, WALL_H, th_w,
            dist.emulated_mesh(4, device=DEVICE), False, dist.even_unequal_bands(nty_w, 4)),
        f"stress measured {measured}": (
            stress_scene, stress_ref, stress_passes, WALL_W, WALL_H, th_w,
            dist.emulated_mesh(4, device=DEVICE), False, measured),
    }
    for name, (sc, ref, ps, w, h, t, mesh, inter, bands) in layouts.items():
        lay = {"tile_h": t, "interleave": inter, "bands": bands}
        for mode in MODES:
            def frame(stats):
                ft, _, events = dist.render_frame_fused_sharded(mesh, ps, w, h,
                                                                collect_stats=stats, **lay)
                return dist.tiles_to_buffers_sharded(mesh, ft, w, h, **lay), events

            with fine_mode(mode):
                (fb, events), lf = count(lambda: frame(True), f"{name} {mode} frame",
                                         (f"{mode}_raster_stats", "untile3_image"))
                (fb0, _), l0 = count(lambda: frame(False), f"{name} {mode} frame, no stats",
                                     (f"{mode}_raster", "untile3_image"))
                img, lm = (count(lambda: dist.render_frame_fused_image_sharded(
                    mesh, ps[:1], w, h, **lay), f"{name} {mode} image",
                    (f"{mode}_raster", "untile_image")) if not mesh.two_d else (None, {}))
            same(f"{name} {mode} colour", fb.color, ref.color)
            same(f"{name} {mode} depth", fb.depth, ref.full_depth)
            for plane in ("color", "depth", "winner"):
                if not torch.equal(getattr(fb0, plane), getattr(fb, plane)):
                    fail(f"{name} {mode}: the frame without stats differs ({plane})")
            st = RenderStats()
            tscene._cull_passes(sc, True, st)
            tscene._add_events(st, events)
            if st != ref.stats:
                fail(f"{name} {mode} stats differ from the oracle's:\n  port   {st}\n  "
                     f"oracle {ref.stats}")
            if img is not None:
                same(f"{name} {mode} image", img, ref.color)
            say(f"[17 sharded] {name} ({mesh.n_rows}x{mesh.n_cols} emulated ranks, th {t}) "
                f"{mode}: frame with stats, without and"
                + ("" if img is None else " the image")
                + f" == f32 oracle bitwise, stats equal; launches frame {nonzero(lf)}, no "
                f"stats {nonzero(l0)}" + ("" if img is None else f", image {nonzero(lm)}"))

    # ---- the y_stride instantiations against their plain versions ----
    cases = {32: (passes[0], WIDTH, HEIGHT, Band(1, cdiv(HEIGHT, 32) // 4, 4)),
             16: (stress_passes[0], WALL_W, WALL_H, Band(1, nty_w // 4, 4))}
    worst = {}
    for t, ((a, sh, u, _), w, h, band) in cases.items():
        place = {"origin": band.origin(t, TILE_W), "y_stride": band.y_stride(t)}
        nv = sum(sh.varying_spec.values())
        pc = rs.pre_sparse(a, u, sh, w, h, t, TILE_W, band)
        pf = rf.pre_fine(a, u, sh, w, h, t, TILE_W, band)
        init = torch.full((max(pc.n_active, pf.n_active), t, TILE_W), torch.inf, device=DEVICE)
        args_c = (pc.tri_rec, pc.sorted_tri, pc.ids, pc.start, pc.counts, init[:pc.n_active],
                  cdiv(w, TILE_W), t, TILE_W, nv)
        args_f = (pf.tri_rec, pf.tri8, pf.ids, pf.row_start, pf.rows, init[:pf.n_active],
                  cdiv(w, TILE_W), t, TILE_W, nv)
        for stats in (False, True):
            key = f"coarse_raster{'_stats' if stats else ''}"
            worst[key] = max(worst.get(key, 0.0), check_outputs(
                f"{key} y_stride th {t}", rc.coarse_raster(*args_c, collect_stats=stats, **place),
                rc.coarse_raster_plain(*args_c, collect_stats=stats, **place)))
            key = f"fine_raster{'_stats' if stats else ''}"
            want = rf.fine_raster_plain(*args_f, collect_stats=stats, **place)
            for max_rows in (None, pf.max_rows):
                worst[key] = max(worst.get(key, 0.0), check_outputs(
                    f"{key} y_stride th {t} max_rows {max_rows}",
                    rf.fine_raster(*args_f, collect_stats=stats, max_rows=max_rows, **place),
                    want))
        say(f"[17 y_stride] th {t}, interleaved band {band[:3]} (ty_lo, tile rows, stride), "
            f"origin {place['origin']}, y_stride {place['y_stride']}: #1 and #1s ({pc.n_active} "
            f"active tiles, largest bin {int(pc.counts.max())}), #4 and #4s (split walk and "
            f"the route's launch, largest tile {pf.max_rows} rows) == plain bitwise")
    for key, err in worst.items():
        record[key]["max_abs_err"] = max(record[key]["max_abs_err"], err)
    say(f"[17 done] {time.perf_counter() - t_phase:.1f} s; launches {nonzero(totals)}")
    return totals


def geometry_launches(n_ranks: int, passes, width: int, height: int) -> int:
    """The coarse raster launches of one triangle-sharded frame: one per
    rank and pass whose block of faces reaches a tile of the frame."""
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.parallel import dist
    total = 0
    for attrs, shader, uniforms, _ in passes:
        for r in range(n_ranks):
            lo, hi = dist.face_block(attrs["position"].shape[0], n_ranks, r)
            if hi > lo:
                block = {k: v[lo:hi] for k, v in attrs.items()}
                total += rs.pre_sparse(block, uniforms, shader, width, height).n_active > 0
    return total


def geometry_phase(smi: str, head_scene, head_ref, stress_scene, stress_ref, mm_scene, mm_ref,
                   shadow) -> dict:
    """[18 geometry]: the triangle-sharded backend (``sharded-geometry``).
    A world of one rank: the headline through ``Scene.render_image`` and
    ``Scene.render`` == the f32 oracle.  4 ranks emulated on the card
    (``dist.emulated_mesh``; NCCL refuses two ranks on one GPU): the
    headline (6,840 faces a rank), the stress scene (61,560), the 3-pass
    scene at 1200x800 and ``shadow_phong_800`` through
    ``render_with_shadows``, each frame with stats and without == the f32
    oracle bitwise, stats equal; the headline on 7 ranks (27,360 faces in
    blocks of 3,909, the last 3,906).  The coarse raster launches once per
    rank and pass whose block reaches a tile (``geometry_launches``), the
    three-plane untile once per frame, and a frame with stats also runs
    the stats raster (its one-rank replay).  Then the one-rank geometry
    frame against ``render_frame_fused`` in five rounds of turns, each
    emulated rank's body on the stress pass and the all-reduce bytes.
    ``shadow``: (scene, key light, settings, the oracle's frame and map,
    the light pass and the lit passes).  -> main-path launches."""
    import numpy as np
    import torch

    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch import shadows
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_H, TILE_W, cdiv
    from tinyrenderder_tpu_torch.parallel import dist

    t_phase = time.perf_counter()
    totals = dict.fromkeys(launch_counts(), 0)
    backend = "sharded-geometry"
    sh_scene, sh_key, sh_settings, sh_ref, sh_map, light_passes, lit_passes = shadow

    def count(fn, what, need):
        """``counted(fn)``, the counts added to the phase's; fails unless
        each kernel of ``need`` launched as many times as it says."""
        result, counts = counted(fn)
        for k, v in counts.items():
            totals[k] += v
        for k, n in need.items():
            if (counts[k] != n) if n else not counts[k]:
                fail(f"{what}: {k} launched {counts[k]} times, not {n or 'at least once'}: "
                     f"{counts}")
        return result, counts

    def frames(what, sc, ref, mesh, passes, w, h, render=None):
        """The frame with stats and without through ``render`` (default
        ``sc.render``) on ``mesh``, == ``ref``; -> the launches of each."""
        render = render or (lambda stats: sc.render(DEVICE, collect_stats=stats,
                                                    backend=backend, mesh=mesh))
        need = {"coarse_raster": geometry_launches(mesh.size, passes, w, h),
                "untile3_image": 1}
        res, ls = count(lambda: render(True), f"{what} with stats",
                        {**need, "coarse_raster_stats": 0})
        res0, l0 = count(lambda: render(False), f"{what} without stats", need)
        same_frame(f"{what} with stats", res, ref)
        for plane in ("color", "depth", "full_depth"):
            if not torch.equal(getattr(res0, plane), getattr(res, plane)):
                fail(f"{what}: the frame without stats differs ({plane})")
        return ls, l0

    # ---- a world of one rank ----
    mesh1 = dist.make_mesh(device=DEVICE)
    passes = tscene.pass_tensors(head_scene, DEVICE)
    one = geometry_launches(1, passes, WIDTH, HEIGHT)
    image, li = count(lambda: head_scene.render_image(DEVICE, backend=backend),
                      "the one-rank geometry image", {"coarse_raster": one, "untile3_image": 1})
    same_image("one-rank render_image(backend='sharded-geometry')", image, head_ref.color)
    ls, l0 = frames("one-rank render(backend='sharded-geometry')", head_scene, head_ref, mesh1,
                    passes, WIDTH, HEIGHT, lambda stats: head_scene.render(
                        DEVICE, collect_stats=stats, backend=backend))
    say(f"[18 geometry] world of one rank ({mesh1.size} rank on {mesh1.device}): headline "
        f"{WIDTH}x{HEIGHT} render_image and render (with stats and without) with "
        f"backend='sharded-geometry' == f32 oracle bitwise, stats equal; launches render_image "
        f"{nonzero(li)}, render {nonzero(ls)}, no stats {nonzero(l0)}")

    # ---- ranks emulated on the card ----
    stress_passes = tscene.pass_tensors(stress_scene, DEVICE)
    mm_passes = tscene.pass_tensors(mm_scene, DEVICE)
    cases = {  # name: (scene, ref, passes, w, h, ranks)
        "headline": (head_scene, head_ref, passes, WIDTH, HEIGHT, 4),
        "stress": (stress_scene, stress_ref, stress_passes, WALL_W, WALL_H, 4),
        f"multimesh_{REF_W}x{REF_H}": (mm_scene, mm_ref, mm_passes, REF_W, REF_H, 4),
        "headline, uneven": (head_scene, head_ref, passes, WIDTH, HEIGHT, 7),
    }
    for name, (sc, ref, ps, w, h, n) in cases.items():
        mesh = dist.emulated_mesh(n, device=DEVICE)
        ls, l0 = frames(f"{name} on {n} ranks", sc, ref, mesh, ps, w, h)
        blocks = [[hi - lo for lo, hi in (dist.face_block(a["position"].shape[0], n, r)
                                          for r in range(n))] for a, *_ in ps]
        say(f"[18 geometry] {name} {w}x{h} on {n} emulated ranks (faces a rank "
            f"{blocks if len(blocks) > 1 else blocks[0]}): frame with stats and without == f32 "
            f"oracle bitwise, stats equal; launches {nonzero(ls)}, no stats {nonzero(l0)}")
    mesh4 = dist.emulated_mesh(4, device=DEVICE)

    def shadowed(stats):
        res, smap = shadows.render_with_shadows(sh_scene, sh_key, sh_settings, DEVICE,
                                                frustum_cull=False, collect_stats=stats,
                                                backend=backend, mesh=mesh4)
        diff, err = bits_equal(smap.cpu(), torch.from_numpy(sh_map))
        if diff:
            fail(f"shadow_phong_{SHADOW_W} on 4 ranks: {diff} texels of the map differ from the "
                 f"f32 oracle's light pass (max abs err {err})")
        return res

    need = {"coarse_raster": geometry_launches(4, light_passes, SHADOW_SIZE, SHADOW_SIZE)
            + geometry_launches(4, lit_passes, SHADOW_W, SHADOW_H), "untile3_image": 2}
    res, ls = count(lambda: shadowed(True), "the shadowed frame with stats",
                    {**need, "coarse_raster_stats": 0})
    res0, l0 = count(lambda: shadowed(False), "the shadowed frame without stats", need)
    same_frame(f"shadow_phong_{SHADOW_W} on 4 ranks", res, sh_ref)
    for plane in ("color", "depth", "full_depth"):
        if not torch.equal(getattr(res0, plane), getattr(res, plane)):
            fail(f"shadow_phong_{SHADOW_W} on 4 ranks: the frame without stats differs")
    say(f"[18 geometry] shadow_phong_{SHADOW_W} through render_with_shadows on 4 emulated ranks "
        f"(the {SHADOW_SIZE}² light pass and the lit frame split): map == f32 oracle light "
        f"pass, frame with stats and without == f32 oracle bitwise, stats equal; launches "
        f"{nonzero(ls)}, no stats {nonzero(l0)}")

    # ---- timing: the one-rank geometry frame against the fused frame ----
    th = rs.pick_tile_h(WIDTH, HEIGHT)

    def geometry_frame():
        ft, _ = dist.render_frame_geometry_tiles(mesh1, passes, WIDTH, HEIGHT, th)
        return rs.tiles_to_buffers(ft, WIDTH, HEIGHT, th).color

    def fused_frame():
        ft, _, _ = rs.render_frame_fused(passes, WIDTH, HEIGHT, DEVICE, tile_h=th)
        return rs.tiles_to_buffers(ft, WIDTH, HEIGHT, th).color

    if not torch.equal(geometry_frame(), fused_frame()):
        fail("the one-rank geometry frame differs from render_frame_fused's")
    rounds = [[event_ms(fn) for fn in (geometry_frame, fused_frame, fused_frame,
                                       geometry_frame)] for _ in range(MESH1_ROUNDS)]
    arms = {"geometry": [t for r in rounds for t in (r[0], r[3])],
            "fused": [t for r in rounds for t in (r[1], r[2])]}
    ratios = [(r[0] + r[3]) / (r[1] + r[2]) for r in rounds]
    device = {"geometry": device_total(geometry_frame), "fused": device_total(fused_frame)}
    say(f"[18 timing] head_phong_{WIDTH} on one rank (th {th}): render_frame_geometry_tiles + "
        f"tiles_to_buffers "
        + "; render_frame_fused + tiles_to_buffers ".join(
            f"{statistics.median(v):.3f} ms/frame (turns {min(v):.3f}-{max(v):.3f}, device "
            f"{device[k]:.3f})" for k, v in arms.items())
        + f"; geometry/fused a round {', '.join(f'{x:.3f}' for x in ratios)}, median "
        f"{statistics.median(ratios):.3f}; device geometry - fused "
        f"{device['geometry'] - device['fused']:.3f} ms (CUDA events, {WARMUP} warm-up + median "
        f"of {FRAMES} a turn, {MESH1_ROUNDS} rounds of turns geometry, fused, fused, geometry; "
        f"device: torch.profiler, every kernel, copy and fill of a frame) | {smi}")

    # ---- each emulated rank's body on the stress pass, and the merge's bytes ----
    s_attrs, s_shader, s_uniforms, _ = stress_passes[0]
    block = cdiv(s_attrs["position"].shape[0], 4)

    def body_device(mesh, r):
        """(device ms, device events) of one call of rank r's body."""
        calls = {}
        ms = device_ms(lambda: dist.geometry_rank(mesh, r, s_attrs, s_shader, s_uniforms,
                                                  WALL_W, WALL_H), ("",), calls)
        return sum(ms.values()), sum(calls.values())

    body = [body_device(mesh4, r) for r in range(4)]
    whole = body_device(mesh1, 0)
    say(f"[18 timing] stress {WALL_W}x{WALL_H} (th {TILE_H}), each emulated rank's body "
        f"(geometry_rank: pre_sparse, the coarse raster, shading and the scatters of its "
        f"{block} faces), device ms (device events a call): "
        + ", ".join(f"rank {r} {t:.3f} ({k:.0f})" for r, (t, k) in enumerate(body))
        + f"; sum {sum(t for t, _ in body):.3f}, the one-rank body {whole[0]:.3f} "
        f"({whole[1]:.0f}) (emulated in turn, not a scaling result; torch.profiler) | {smi}")
    for w, h, t in ((WIDTH, HEIGHT, th), (WALL_W, WALL_H, TILE_H)):
        plane = cdiv(w, TILE_W) * cdiv(h, t) * t * TILE_W * 4
        say(f"[18 merge] {w}x{h} (th {t}): a colour pass all-reduces 3 planes (min depth, min "
            f"winner id, sum colour) of {plane} B each = {3 * plane} B a rank "
            f"({3 * plane / 2**20:.1f} MiB); a depth-only pass 2 planes, {2 * plane} B")
    say(f"[18 done] {time.perf_counter() - t_phase:.1f} s; launches {nonzero(totals)}")
    return totals


def animation_phase(smi: str) -> dict:
    """[15 animation]: the orbit of ``bench.py::bench_animation`` /
    ``bench_animation_tga`` (the 3-mesh scene at 2048², no frustum cull)
    through ``animation.render_animation``, the native TGA codec, and the
    CLI's ``--animate`` and ``--profile``.  -> main-path launches."""
    import math

    import numpy as np

    from tinyrenderder_tpu_torch import animation, cli
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.utils import native, tga

    totals = dict.fromkeys(launch_counts(), 0)

    def count(fn, what, need):
        result, counts = counted(fn)
        for k, v in counts.items():
            totals[k] += v
        if not all(counts[k] for k in need):
            fail(f"a kernel of {what} never launched: {counts}")
        return result, counts

    if not native.available():
        fail(f"the native codec did not build: {native.BUILD_ERROR}")
    real_encode, encodes = native.rle_encode, []

    def counting_encode(flat, bpp):
        encodes.append(flat.shape[0])
        return real_encode(flat, bpp)

    def files(d: Path) -> dict:
        return {p.name: p.read_bytes() for p in sorted(d.iterdir())}

    n, size = ANIM_FRAMES, WIDTH
    native.rle_encode = counting_encode
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)

            def cfg(d: str, frames: int = n):
                return animation.AnimationConfig(frames=frames, device=DEVICE,
                                                 outdir=str(tmp / d), frustum_cull=False)

            sc = tscene.multimesh_scene(size, size)
            eye0, target0 = sc.camera.params.eye.copy(), sc.camera.params.target.copy()
            summary, counts = count(lambda: animation.render_animation(sc, cfg("full")),
                                    "the orbit", ("coarse_raster", "untile3_image"))
            if summary["frames_rendered"] != n or len(encodes) != n:
                fail(f"the orbit wrote {summary['frames_rendered']} frames, {len(encodes)} "
                     f"through the native encoder, of {n}")
            first = animation.render_animation(tscene.multimesh_scene(size, size),
                                               cfg("resumed"), stop_after=3)
            second = animation.render_animation(tscene.multimesh_scene(size, size),
                                                cfg("resumed"))
            if ((first["frames_rendered"], first["resumed_at"], second["frames_rendered"],
                 second["resumed_at"]) != (3, 0, n - 3, 3)):
                fail(f"stop_after=3 then resume: {first}, {second}")
            if files(tmp / "full") != files(tmp / "resumed"):
                fail("the killed-and-resumed orbit's files differ from the uninterrupted run's")
            native_available = native.available
            oracle_s = time.perf_counter()
            for i in (0, n - 1):
                sc.camera.set_eye(animation.orbit_eye(eye0, target0, 2 * math.pi * i / n))
                ref = tscene.oracle_render(sc, frustum_cull=False)
                native.available = lambda: False            # the port's Python encoder
                try:
                    tga.TGAImage.from_rgb(ref.color).write_tga_file(str(tmp / f"oracle{i}.tga"))
                finally:
                    native.available = native_available
                if (tmp / f"oracle{i}.tga").read_bytes() != \
                        (tmp / "full" / f"frame_{i:04d}.tga").read_bytes():
                    fail(f"orbit frame {i} differs from the f32 oracle's at its eye")
            oracle_s = time.perf_counter() - oracle_s
            sc.camera.set_eye(eye0)
            say(f"[15 animation] multimesh {size}x{size} orbit, {n} frames, checkpoint on, "
                f"no cull: {n} TGAs through the native encoder; stop_after=3 + resume == the "
                f"uninterrupted run byte for byte ({len(files(tmp / 'full'))} files with "
                f"checkpoint.json); frames 0 and {n - 1} == the f32 oracle at their eyes "
                f"written by the Python encoder (oracle {oracle_s:.1f} s on the host); "
                f"launches {counts} | {smi}")

            # bench_animation's work: render-only orbit steps, CUDA events
            step = iter(range(10 ** 6))

            def render_at():
                i = next(step)
                sc.camera.set_eye(animation.orbit_eye(eye0, target0, 2 * math.pi * i / 120))
                return tscene.render_scene(sc, DEVICE, frustum_cull=False,
                                           collect_stats=False).color

            orbit_ms = event_ms(render_at)
            sc.camera.set_eye(eye0)
            # bench_animation_tga's: seconds / frames_rendered of a written orbit
            timed = animation.render_animation(sc, cfg("timed", 2 * n))
            tga_ms = timed["seconds"] / timed["frames_rendered"] * 1e3
            flat = tga.TGAImage.from_rgb(ref.color).data.reshape(-1, 3)
            t0 = time.perf_counter()
            enc_native = real_encode(flat, 3)
            native_ms = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            enc_py = tga._encode_rle_py(flat, 3)
            py_ms = (time.perf_counter() - t0) * 1e3
            if enc_native != enc_py:
                fail("the native RLE encoder's bytes differ from the Python encoder's")
            say(f"[15 animation] timing: render-only orbit {orbit_ms:.3f} ms/frame "
                f"(render_scene, CUDA events, {WARMUP} warm-up + median of {FRAMES}); with "
                f"TGA writes {tga_ms:.3f} ms/frame ({timed['frames_rendered']} frames, "
                f"{timed['seconds']:.3f} s); RLE encode of one {size}² frame: native "
                f"{native_ms:.3f} ms, Python {py_ms:.3f} ms ({len(enc_native)} bytes) | {smi}")

            # the CLI: --animate 3 at 1200x800, then --profile once
            code, counts = count(lambda: cli.run(
                ["--device", DEVICE, "--width", str(REF_W), "--height", str(REF_H),
                 "--outdir", str(tmp / "cli"), "--animate", "3"]),
                "the CLI's --animate", ("untile3_image",))
            got = sorted(p.name for p in (tmp / "cli").iterdir())
            if code != 0 or got != ["checkpoint.json", "frame_0000.tga", "frame_0001.tga",
                                    "frame_0002.tga"]:
                fail(f"the CLI with --animate 3 exited {code}, wrote {got}")
            code, pcounts = count(lambda: cli.run(
                ["--device", DEVICE, "--width", str(REF_W), "--height", str(REF_H),
                 "--outdir", str(tmp / "prof"), "--profile"]),
                "the CLI's --profile", ("untile3_image",))
            trace = tmp / "prof" / "trace"
            traces = sorted(trace.iterdir()) if trace.is_dir() else []
            if code != 0 or not traces or not traces[0].stat().st_size:
                fail(f"the CLI with --profile exited {code}, trace {traces}")
            say(f"[15 animation] cli --animate 3 at {REF_W}x{REF_H}: {got}; launches {counts}; "
                f"cli --profile: {traces[0].name} {traces[0].stat().st_size} bytes; launches "
                f"{pcounts}")
    finally:
        native.rle_encode = real_encode
    return totals


def animation_ranks_phase(smi: str) -> dict:
    """[19 animation ranks]: the orbit of [15 animation] (the 3-mesh scene at
    2048², ANIM_FRAMES frames, no frustum cull) through
    ``animation.render_animation`` on every backend the JAX module renders
    it on.  Each sharded backend on one rank (``dist.make_mesh``) and on 4
    ranks emulated on the card ("sharded-2d" there as a 2x2 grid): its TGAs
    == the tiled orbit's byte for byte, #1 and #3i launched, and one
    blocking cost measurement for "sharded-measured" on 4 ranks.  The
    oracle's orbit at ORACLE_ORBIT == ``oracle_render`` at its eyes.  Then
    render-only orbit steps through ``Scene.render`` (the eye moves every
    frame), in ORBIT_ROUNDS rounds of turns: the one-rank "sharded" orbit
    against the "tiled" one, and 4 emulated ranks "sharded-measured"
    against "sharded".  -> main-path launches."""
    import math

    from tinyrenderder_tpu_torch import animation
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.parallel import dist
    from tinyrenderder_tpu_torch.utils import tga

    t_phase = time.perf_counter()
    totals = dict.fromkeys(launch_counts(), 0)
    n, size = ANIM_FRAMES, WIDTH
    real_measure, blocking = dist.measure_tile_row_costs, []

    def measure(*args, **kw):
        blocking.append(1)
        return real_measure(*args, **kw)

    def files(d: Path) -> dict:
        return {p.name: p.read_bytes() for p in sorted(d.iterdir())}

    def orbit(d: Path, backend: str, mesh=None, w: int = size, h: int = size):
        cfg = animation.AnimationConfig(frames=n, backend=backend, device=DEVICE, mesh=mesh,
                                        outdir=str(d), frustum_cull=False)
        return animation.render_animation(tscene.multimesh_scene(w, h), cfg)

    def count(fn, what):
        blocking.clear()
        summary, counts = counted(fn)
        for k, v in counts.items():
            totals[k] += v
        if not (counts["coarse_raster"] and counts["untile3_image"]):
            fail(f"a kernel of {what} never launched: {counts}")
        if summary["frames_rendered"] != n:
            fail(f"{what} rendered {summary['frames_rendered']} of {n} frames")
        return summary, nonzero(counts), len(blocking)

    meshes = {1: dist.make_mesh(device=DEVICE), 4: dist.emulated_mesh(4, device=DEVICE)}
    dist.measure_tile_row_costs = measure
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            summary, counts, _ = count(lambda: orbit(tmp / "tiled", "tiled"), "the tiled orbit")
            want = files(tmp / "tiled")
            say(f"[19 animation ranks] tiled: multimesh {size}x{size}, {n} frames, no cull, "
                f"{summary['seconds'] / n * 1e3:.3f} ms/frame written; launches {counts}")
            for backend in tscene.SHARDED_BACKENDS:
                for ranks, mesh in meshes.items():
                    what = f"the {backend} orbit on {ranks} rank(s)"
                    d = tmp / f"{backend}_{ranks}"
                    summary, counts, measures = count(lambda: orbit(d, backend, mesh), what)
                    if files(d) != want:
                        fail(f"{what} wrote other files than the tiled orbit")
                    if backend == "sharded-measured" and measures != int(ranks > 1):
                        fail(f"{what} measured the row costs {measures} time(s), blocking")
                    grid = tscene._sharded_mesh(DEVICE, mesh, backend, size, size)
                    say(f"[19 animation ranks] {backend} on {ranks} "
                        f"{'emulated ranks' if mesh.rank is None else 'rank'} "
                        f"({grid.n_rows}x{grid.n_cols}): {n} TGAs == the tiled orbit's byte "
                        f"for byte, {summary['seconds'] / n * 1e3:.3f} ms/frame written; "
                        f"blocking measurements {measures}; launches {counts}")
            ow, oh = ORACLE_ORBIT
            summary = orbit(tmp / "oracle", "oracle", w=ow, h=oh)
            sc = tscene.multimesh_scene(ow, oh)
            eye0, target0 = sc.camera.params.eye.copy(), sc.camera.params.target.copy()
            for i in range(n):
                sc.camera.set_eye(animation.orbit_eye(eye0, target0, 2 * math.pi * i / n))
                tga.TGAImage.from_rgb(tscene.oracle_render(sc, frustum_cull=False).color
                                      ).write_tga_file(str(tmp / f"want{i}.tga"))
                if (tmp / f"want{i}.tga").read_bytes() != \
                        (tmp / "oracle" / f"frame_{i:04d}.tga").read_bytes():
                    fail(f"oracle orbit frame {i} differs from oracle_render at its eye")
            say(f"[19 animation ranks] oracle: multimesh {ow}x{oh}, {n} frames == oracle_render "
                f"at their eyes byte for byte ({summary['seconds']:.1f} s on the host)")

        # render-only orbit steps, as [15 animation] times the tiled one
        sc = tscene.multimesh_scene(size, size)
        eye0, target0 = sc.camera.params.eye.copy(), sc.camera.params.target.copy()
        step = iter(range(10 ** 6))

        def stepper(backend, mesh):
            def frame():
                i = next(step)
                sc.camera.set_eye(animation.orbit_eye(eye0, target0, 2 * math.pi * i / 120))
                return sc.render(DEVICE, False, collect_stats=False, backend=backend,
                                 mesh=mesh).color
            return frame

        pairs = {"one-rank sharded / tiled": (stepper("sharded", meshes[1]),
                                              stepper("tiled", None)),
                 "4-rank sharded-measured / 4-rank sharded": (
                     stepper("sharded-measured", meshes[4]), stepper("sharded", meshes[4]))}
        for name, (fn_a, fn_b) in pairs.items():
            blocking.clear()
            rounds = [[event_ms(fn) for fn in (fn_a, fn_b, fn_b, fn_a)]
                      for _ in range(ORBIT_ROUNDS)]
            a = [t for r in rounds for t in (r[0], r[3])]
            b = [t for r in rounds for t in (r[1], r[2])]
            ratios = [(r[0] + r[3]) / (r[1] + r[2]) for r in rounds]
            say(f"[19 timing] orbit steps {name}: {statistics.median(a):.3f} / "
                f"{statistics.median(b):.3f} ms/frame (turns {min(a):.3f}-{max(a):.3f} / "
                f"{min(b):.3f}-{max(b):.3f}); a round {', '.join(f'{x:.3f}' for x in ratios)}, "
                f"median {statistics.median(ratios):.3f}; blocking measurements {len(blocking)} "
                f"in {ORBIT_ROUNDS * 2 * (WARMUP + FRAMES)} measured frames (multimesh "
                f"{size}x{size}, eye moving every frame, Scene.render without stats; CUDA "
                f"events, {WARMUP} warm-up + median of {FRAMES} a turn, {ORBIT_ROUNDS} rounds "
                f"of turns a, b, b, a) | {smi}")
    finally:
        dist.measure_tile_row_costs = real_measure
    say(f"[19 done] {time.perf_counter() - t_phase:.1f} s; launches {nonzero(totals)}")
    return totals

def scan_tests(setup, height: int, y0: int = 0) -> float:
    """Pixels of the buffer (rows y0 .. y0 + height - 1, the frame's width)
    inside a valid triangle's bbox, summed over the triangles: the scan
    resolve's tests that reach the arithmetic."""
    bb = setup["bbox"][setup["valid"]].double()
    rows = (bb[:, 3].clamp(max=y0 + height - 1) - bb[:, 2].clamp(min=y0) + 1).clamp(min=0)
    return float(((bb[:, 1] - bb[:, 0] + 1) * rows).sum())


def scan_bound(setup, height: int, width: int, seeded: bool, y0: int = 0) -> tuple[float, str]:
    """The scan resolve's bound: bytes = each triangle's 13 geometry floats
    it uses (screen xy, NDC z, bbox) and its valid byte read once, the
    running depth where ``seeded``, and depth and winner written once;
    operations = OPS_TEST per test (``scan_tests``)."""
    px = height * width
    return bound(setup["valid"].shape[0] * (13 * 4 + 1) + px * (8 + 4 * seeded),
                 OPS_TEST * scan_tests(setup, height, y0))


def timed(fn):
    """(fn(), the CUDA-event time of that one call in ms)."""
    import torch
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1)


def list_text(lengths, n_tri: int, height: int, width: int, geom) -> str:
    """The [20] clause of a pass's super-block lists: their count, entries,
    the longest, and the entries the walk's blocks stream (each block its
    super-block's list, 8 bytes an entry) beside what every block streaming
    every triangle's bbox (one 32-byte sector each) would read."""
    bw, bh, px = geom
    nbx, nby = -(-width // bw), -(-height // bh)
    sw, sh = px // bw, px // bh
    nsx = -(-nbx // sw)
    n = [int(v) for v in lengths.tolist()]
    streamed = sum(n[by // sh * nsx + bx // sw] for by in range(nby) for bx in range(nbx))
    return (f"{len(n)} super-blocks of {px}x{px} px, {sum(n)} entries (longest {max(n)}), "
            f"{streamed} streamed by the {nbx * nby} blocks of {bw}x{bh} px "
            f"({streamed * 8 / 1e6:.2f} MB; every bbox to every 32x32 block: "
            f"{n_tri * -(-width // 32) * -(-height // 32) * 32 / 1e9:.2f} GB)")


#: [20]'s band of the headline pass: its first row and its rows (not a
#: multiple of the 32-row block)
SCAN_BAND = (1000, 500)
#: the chunked scan's chunk on the stress pass (any chunk gives one result;
#: 64 keeps its 3,005 steps to seconds where 8 would take 18,920)
STRESS_CHUNK = 64


def scan_kernel_phase(smi: str, head_scene, stress_scene, record) -> None:
    """[20 scan]'s kernel part: the resolve kernel (``csrc/scan_resolve.cu``),
    without and with its event sums, == the chunked scan and the split
    plain version bitwise (depth, winner; event count, max z, min z), and
    its super-block lists == the plain lists, on the headline pass, the
    2048² room pass seeded by the head, the 246k stress pass at 1280x800
    and a band of the headline pass seeded by the room; then each pass's
    kernel time (CUDA events), bound and the kernels a call launches."""
    import torch

    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.ops import raster
    from tinyrenderder_tpu_torch.ops.raster_tiled import vertex_stage

    geom = raster.kernel_geometry()

    def setup_of(scene, index=0):
        attrs, shader, uniforms, _ = tscene.pass_tensors(scene, DEVICE)[index]
        return vertex_stage(attrs, uniforms, shader, scene.width, scene.height)[0]

    def check_resolve(what, setup, h, w, init, y0, chunk):
        """The kernel == the chunked scan in chunks of ``chunk`` and the
        split plain version, without and with the event sums; its lists ==
        the plain lists.  -> (max abs err, events, the chunked scan's ms
        without and with stats, the lists' clause)."""
        got = raster.depth_resolve_xla(setup, h, w, init_depth=init, y0=y0)
        want, p_ms = timed(lambda: raster.depth_resolve_xla_plain(setup, h, w, chunk, init,
                                                                  y0=y0))
        split = raster.scan_resolve_split_plain(setup, h, w, init, y0=y0, geom=geom)
        err = same_planes(f"scan resolve vs the chunked scan, {what}", ("depth", "winner"),
                          got, want)
        same_planes(f"scan resolve vs the split plain version, {what}", ("depth", "winner"),
                    got, split)
        seed = init if init is not None else torch.full((h, w), torch.inf, device=DEVICE)
        ev = raster.pass_events_xla(setup, seed, h, w, y0=y0)
        ev_want, ps_ms = timed(lambda: raster.pass_events_xla_plain(setup, seed, h, w, chunk,
                                                                    y0=y0))
        ev_split = raster.scan_resolve_split_plain(setup, h, w, seed, y0=y0,
                                                   collect_stats=True, geom=geom)
        err = max(err, same_planes(f"scan resolve stats vs the chunked scan, {what}",
                                   ("depth", "winner", "events", "min z", "max z"), ev,
                                   ev_want))
        same_planes(f"scan resolve stats vs the split plain version, {what}",
                    ("depth", "winner", "events", "max z"), (*ev[:3], ev[4]), ev_split)
        same_planes(f"scan resolve stats vs without, {what}", ("depth", "winner"), ev[:2],
                    got)
        if int(ev[2]) <= 0:
            fail(f"scan resolve stats, {what}: {int(ev[2])} events")
        lengths, lists = raster.scan_lists(setup, h, w, y0=y0)
        p_len, p_lists = raster.scan_super_lists_plain(setup, h, w, y0=y0, geom=geom)
        same_planes(f"super-block list lengths, {what}", ("lengths",), (lengths,), (p_len,))
        held = (torch.arange(lists.shape[1], device=DEVICE)[None, :] < p_len[:, None].long())
        same_planes(f"super-block lists, {what}", ("entries",), (lists[held],),
                    (p_lists[held],))
        return err, int(ev[2]), p_ms, ps_ms, list_text(p_len, setup["valid"].shape[0], h, w,
                                                       geom)

    head = setup_of(head_scene)
    mm_big = tscene.multimesh_scene(WIDTH, HEIGHT)
    room = setup_of(mm_big, 2)
    head_depth = raster.scan_resolve_split_plain(setup_of(mm_big), HEIGHT, WIDTH, geom=geom)[0]
    stress = setup_of(stress_scene)
    y0, rows = SCAN_BAND
    passes = {"headline": (head, HEIGHT, WIDTH, None, 0, 8),
              "room after the head": (room, HEIGHT, WIDTH, head_depth, 0, 8),
              "stress": (stress, WALL_H, WALL_W, None, 0, STRESS_CHUNK)}
    results = {}
    for what, (setup, h, w, init, b0, chunk) in passes.items():
        results[what] = check_resolve(what, setup, h, w, init, b0, chunk)
    room_depth = raster.depth_resolve_xla(room, HEIGHT, WIDTH, init_depth=head_depth)[0]
    passes["band"] = (head, rows, WIDTH, room_depth[y0:y0 + rows].contiguous(), y0, 8)
    results["band"] = check_resolve("band", *passes["band"])
    say(f"[20 scan] resolve kernel == the chunked scan and the split plain version bitwise "
        f"(depth, winner; with stats the event count and max z, and min z), its super-block "
        f"lists == the plain lists: " + "; ".join(
            f"{k} ({passes[k][0]['valid'].shape[0]} faces, {passes[k][2]}x{passes[k][1]} at "
            f"y0 {passes[k][4]}, {r[1]} events, chunk {passes[k][5]}: {r[4]})"
            for k, r in results.items()))

    # ---- timing: each pass, without and with stats ----
    # the kernels a call launches do not depend on the pass: traced on the
    # headline only (the card's profiler drops events in runs of traces, and
    # each retry costs seconds)
    k_ms, launched = {}, {}
    for what, (setup, h, w, init, b0, _) in passes.items():
        seed = init if init is not None else torch.full((h, w), torch.inf, device=DEVICE)
        for stats in (False, True):
            fn = ((lambda s=setup, h=h, w=w, i=seed, b=b0: raster.pass_events_xla(
                      s, i, h, w, y0=b)) if stats else
                  (lambda s=setup, h=h, w=w, i=init, b=b0: raster.depth_resolve_xla(
                      s, h, w, init_depth=i, y0=b)))
            ms = k_ms[(what, stats)] = event_ms(fn)
            kb = scan_bound(setup, h, w, stats or init is not None, b0)
            if what == "headline":
                kernels = call_kernels(fn)
                own = [k for k in kernels or () if k in SCAN_KERNELS]
                launched[stats] = (
                    "the profiler recorded no consistent trace" if kernels is None else
                    f"{len(own)} launches a call ({', '.join(own)}; {len(kernels)} kernels "
                    f"with the wrapper's torch ops)")
            say(f"[20 timing] scan resolve{' stats' if stats else ''}, {what}: kernel "
                f"{ms:.4f} ms, bound {kb[0]:.4f} ms ({kb[1]}, kernel/bound "
                f"{ms / kb[0]:.1f}; {scan_tests(setup, h, b0):.0f} bbox tests), "
                f"{launched[stats]}{'' if what == 'headline' else ' (headline trace)'}" + (
                    f"; the chunked scan (chunk {passes[what][5]}, one call) "
                    f"{results[what][3 if stats else 2]:.2f} ms" if what == "headline" else "")
                + f" | {smi}")
    # no Pallas kernel: the JAX scan functions (lax.scan) it stands for
    err = max(r[0] for r in results.values())
    for name, replaces, stats in (("scan_resolve", "tinyrenderder_tpu/ops/raster.py:85", False),
                                  ("scan_resolve_stats", "tinyrenderder_tpu/ops/raster.py:168",
                                   True)):
        b = scan_bound(head, HEIGHT, WIDTH, stats)
        record[name] = {"name": name, "route": "cuda",
                        "source": "tinyrenderder_tpu_torch/csrc/scan_resolve.cu",
                        "replaces": replaces, "max_abs_err": err,
                        "ms": k_ms[("headline", stats)],
                        "plain_ms": results["headline"][3 if stats else 2],
                        "bound_ms": b[0], "bound_by": b[1], "library_ms": None}


def scan_phase(smi: str, head_scene, head_ref, mm_scene, mm_ref, stress_scene, shadow,
               record) -> dict:
    """[20 scan]: the scan backend (``backend="xla"``: ``ops/raster.py``,
    ``csrc/scan_resolve.cu``).  ``scan_kernel_phase``; then the headline
    through ``Scene.render`` (with and without stats) and ``render_image``
    == the f32 oracle and the tiled frame, stats equal; the 3-pass scene at
    2048² == the tiled frame (stats equal) and at 1200x800 (``mm_scene``)
    == the f32 oracle; ``render_with_shadows`` of ``shadow_phong_800``
    (``shadow``: scene, key light, settings, the oracle's frame and map) ==
    the tiled shadowed frame and the oracle.  Then the scan frame against
    the tiled frame, ms/frame in turns, at 2048².  -> main-path launches."""
    import torch

    from tinyrenderder_tpu_torch import shadows
    from tinyrenderder_tpu_torch import scene as tscene

    t_phase = time.perf_counter()
    totals = dict.fromkeys(launch_counts(), 0)

    def count(fn, what, need):
        result, counts = counted(fn)
        for k, v in counts.items():
            totals[k] += v
        if not all(counts[k] for k in need):
            fail(f"a kernel of {what} never launched: {counts}")
        return result, counts

    scan_kernel_phase(smi, head_scene, stress_scene, record)

    # ---- the scan frames at full width ----
    res, lr = count(lambda: head_scene.render(DEVICE, backend="xla"), "the headline scan frame",
                    ("scan_resolve_stats",))
    res0, l0 = count(lambda: head_scene.render(DEVICE, backend="xla", collect_stats=False),
                     "the headline scan frame without stats", ("scan_resolve",))
    image, li = count(lambda: head_scene.render_image(DEVICE, backend="xla"),
                      "the headline scan image", ("scan_resolve",))
    same_frame("headline render(backend='xla')", res, head_ref)
    tiled = head_scene.render(DEVICE)
    same_frame("headline render(backend='xla') vs tiled", res,
               SimpleNamespace(**{k: getattr(tiled, k).cpu().numpy()
                                  for k in ("color", "depth", "full_depth")},
                               stats=tiled.stats))
    for k in ("color", "depth", "full_depth"):
        if not torch.equal(getattr(res0, k), getattr(res, k)):
            fail(f"headline scan frame {k} differs without stats")
    same_image("headline render_image(backend='xla')", image, head_ref.color)
    if list(res.pass_timings) != ["head"] or list(tiled.pass_timings) != ["head"]:
        fail(f"pass_timings keys {list(res.pass_timings)}, tiled {list(tiled.pass_timings)}")
    say(f"[20 scan] headline {WIDTH}x{HEIGHT}: render (stats and without) and render_image "
        f"with backend='xla' == f32 oracle and the tiled frame bitwise, stats equal "
        f"({res.stats.describe()}); launches render {nonzero(lr)}, without stats "
        f"{nonzero(l0)}, render_image {nonzero(li)}")
    mm_big = tscene.multimesh_scene(WIDTH, HEIGHT)
    (m_xla, m_tiled), lm = count(lambda: (mm_big.render(DEVICE, backend="xla"),
                                          mm_big.render(DEVICE)),
                                 "the 3-pass scan frame", ("scan_resolve_stats",))
    for k in ("color", "depth", "full_depth"):
        if not torch.equal(getattr(m_xla, k), getattr(m_tiled, k)):
            fail(f"3-pass {WIDTH}x{HEIGHT} scan frame {k} differs from the tiled frame")
    if m_xla.stats != m_tiled.stats:
        fail(f"3-pass scan stats {m_xla.stats} != tiled {m_tiled.stats}")
    if not list(m_xla.pass_timings) == list(m_tiled.pass_timings) == ["head", "eyes", "room"]:
        fail(f"3-pass pass_timings keys {list(m_xla.pass_timings)}, tiled "
             f"{list(m_tiled.pass_timings)}")
    m_ref, lmr = count(lambda: mm_scene.render(DEVICE, backend="xla"),
                       "the 3-pass scan frame at the reference size", ("scan_resolve_stats",))
    same_frame(f"3-pass {REF_W}x{REF_H} render(backend='xla')", m_ref, mm_ref)
    say(f"[20 scan] 3-pass {WIDTH}x{HEIGHT}: render(backend='xla') == the tiled frame bitwise "
        f"(colour, depth, full depth), stats equal, pass_timings keys "
        f"{list(m_xla.pass_timings)} on both; {REF_W}x{REF_H} == f32 oracle, stats equal; "
        f"launches {nonzero(lm)} (both backends), {nonzero(lmr)}")
    sh_scene, sh_key, sh_settings, sh_ref, sh_map = shadow
    (sres, smap), ls = count(lambda: shadows.render_with_shadows(
        sh_scene, sh_key, sh_settings, DEVICE, frustum_cull=False, backend="xla"),
        "the scan shadowed frame", ("scan_resolve", "scan_resolve_stats"))
    tres, tmap = shadows.render_with_shadows(sh_scene, sh_key, sh_settings, DEVICE,
                                             frustum_cull=False)
    if not torch.equal(smap, tmap):
        fail("the scan shadow map differs from the tiled one")
    diff, err = bits_equal(smap.cpu(), torch.from_numpy(sh_map))
    if diff:
        fail(f"the scan shadow map: {diff} depths differ from the f32 oracle (max {err})")
    same_frame(f"shadow_phong_{SHADOW_W} render_with_shadows(backend='xla')", sres, sh_ref)
    for k in ("color", "depth", "full_depth"):
        if not torch.equal(getattr(sres, k), getattr(tres, k)):
            fail(f"scan shadowed frame {k} differs from the tiled one")
    say(f"[20 scan] shadow_phong_{SHADOW_W}: render_with_shadows(backend='xla') -> map == the "
        f"tiled map and the f32 oracle's, frame == the tiled frame and the f32 oracle "
        f"bitwise, stats equal; launches {nonzero(ls)}")

    # ---- timing: the frames in turns ----
    for name, sc in (("head_phong", head_scene), ("multimesh", mm_big)):
        xla_ms, tiled_ms = in_turns(
            lambda: tscene.render_scene(sc, DEVICE, collect_stats=False, backend="xla").color,
            lambda: tscene.render_scene(sc, DEVICE, collect_stats=False).color)
        say(f"[20 timing] {name}_{WIDTH}: render_scene ms/frame in turns (xla, tiled, tiled, "
            f"xla): xla {xla_ms:.3f}, tiled {tiled_ms:.3f} (xla/tiled {xla_ms / tiled_ms:.3f}) "
            f"| {smi}")
    say(f"[20 done] {time.perf_counter() - t_phase:.1f} s; launches {nonzero(totals)}")
    return totals


def post_phase(smi: str, record: dict) -> dict:
    """[21 post]: ``csrc/post.cu`` (``post.postprocess`` on CUDA tensors)
    against ``post.postprocess_plain`` on the card, bitwise on all three
    outputs, on the CLI's frame at REF_W x REF_H (and against the NumPy
    ``oracle_post`` there) and on edge planes at the same size (every depth
    infinite, one finite pixel, a degenerate range, finite pixels on the
    borders only, noise with infinite holes); then on the CLI's frame
    CUDA-event medians of FRAMES calls of the kernel and the plain
    composition in turns, the kernel with a cold L2, each one's
    ``torch.profiler`` device time from a trace that holds every event of
    its calls (``consistent_device_ms``; "not measured" if none does) and
    the bound.  -> main-path launches."""
    import numpy as np
    import torch

    from tinyrenderder_tpu_torch import cli
    from tinyrenderder_tpu_torch.ops import post

    t_phase = time.perf_counter()
    sc = cli.build_default_scene(width=REF_W, height=REF_H)
    res = sc.render(DEVICE)
    color, depth = res.color, res.depth
    rng = np.random.default_rng(21)
    shape = (REF_H, REF_W)
    inf = np.full(shape, np.inf, np.float32)
    one = inf.copy()
    one[REF_H // 3, REF_W // 5] = 0.25
    near = np.where(rng.random(shape) < 0.5, np.float32(0.5),
                    np.nextafter(np.float32(0.5), np.float32(1))).astype(np.float32)
    border = inf.copy()
    border[[0, -1], :] = rng.uniform(0.2, 0.9, size=(2, REF_W))
    border[:, [0, -1]] = rng.uniform(0.2, 0.9, size=(REF_H, 2))
    noisy = rng.uniform(0.9, 1.0, size=shape).astype(np.float32)
    noisy[rng.random(shape) < 0.3] = np.inf
    planes = {"cli frame": depth, "all infinite": inf, "one finite pixel": one,
              "degenerate range": near, "finite borders": border, "noisy": noisy}
    totals = dict.fromkeys(launch_counts(), 0)
    err = 0.0
    for what, d in planes.items():
        d = torch.as_tensor(d, device=DEVICE)
        want = post.postprocess_plain(color, d)
        got, counts = counted(partial(post.postprocess, color, d))
        for k, v in counts.items():
            totals[k] += v
        if counts["post"] != 1:
            fail(f"post {what}: the kernel entry counted {counts['post']} launches, not 1")
        err = max(err, same_planes(f"post kernel vs plain, {what}", ("zimg", "ao", "final"),
                                   got, want))
    host = (color.cpu().numpy(), depth.cpu().numpy())
    got = post.postprocess(color, depth)
    err = max(err, same_planes("post kernel vs NumPy oracle_post", ("zimg", "ao", "final"),
                               [g.cpu() for g in got],
                               [torch.from_numpy(w) for w in post.oracle_post(*host)]))
    say(f"[21 post] {REF_W}x{REF_H}: kernel == postprocess_plain bitwise on the z-image, AO "
        f"and composite of {', '.join(planes)}; == oracle_post on the CLI frame "
        f"({int(torch.isfinite(depth).sum())} finite depths)")

    def kernel():
        return post.postprocess(color, depth)

    def plain():
        return post.postprocess_plain(color, depth)

    k_ms, p_ms = in_turns(kernel, plain)
    cold = event_ms(kernel, before=cold_l2())
    k_dev = consistent_device_ms(kernel, ("post_range_kernel", "post_ssao_kernel", "Memset"))
    p_dev = consistent_device_ms(plain)
    dev_text = lambda d: (  # noqa: E731
        "not measured: the profiler recorded no consistent trace" if d is None else
        f"{device_text(d[0])}, {d[1]} device events a call")
    n = REF_W * REF_H
    moved = n * (4 + 3) + n * (1 + 1 + 3)      # depth, colour read; z-image, AO, final
    taps = n * 64 * 4                          # 64 taps of ~4 float compares and sums
    b = bound(moved, taps)
    say(f"[21 post] {REF_W}x{REF_H} CLI frame, in turns: kernel {k_ms:.4f} ms (cold L2 "
        f"{cold:.4f}, device {dev_text(k_dev)}), plain composition {p_ms:.4f} ms (device "
        f"{dev_text(p_dev)}); kernel/plain {k_ms / p_ms:.4f}; "
        f"bound {b[0]:.4f} ms ({b[1]}; bytes {moved / PEAK_BYTES * 1e3:.4f} ms for "
        f"{moved / 1e6:.2f} MB, operations {taps / PEAK_FLOPS * 1e3:.4f} ms) | {smi}")
    record["post"] = {"name": "post", "route": "cuda",
                      "source": "tinyrenderder_tpu_torch/csrc/post.cu",
                      "replaces": "none: tinyrenderder_tpu/ops/post.py::postprocess_device "
                                  "is XLA", "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                      "bound_ms": b[0], "bound_by": b[1], "library_ms": None}
    say(f"[21 done] {time.perf_counter() - t_phase:.1f} s; launches {nonzero(totals)}")
    return totals

#: the benchmark's seed the [22 pre] passes are drawn with (their first view)
PRE_SEED = 2**31 + 5


def pre_passes() -> list:
    """[(name, attrs, shader, uniforms, width, height, tile_h)]: the walk's
    three passes (``reference_main_1200x800``, full size) and the sun
    walk's light pass (2048², 16-row tiles, as ``render_depth_from_light``
    runs it) and its two lit Phong passes, at the first view of
    ``PRE_SEED``, as ``rasterbench`` builds them."""
    import importlib

    import torch

    from rasterbench import catalog, scenes
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch import shadows
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_H

    bench = catalog.Benchmark(Path(__file__).resolve().parent)
    out = []
    for config, traffic in (("reference_main_1200x800", "walk"),
                            ("reference_main_shadows_1200x800", "sun_walk")):
        plan = scenes.make_plan(bench.config(config), bench.traffic(traffic), PRE_SEED)
        sc = scenes.port_scene(plan)
        sc.camera.set_eye(plan.orbit.eye_at(plan.orbit.first))
        th = rs.pick_tile_h(plan.width, plan.height)
        if traffic == "walk":
            out += [(p.name, a, sh, u, plan.width, plan.height, th)
                    for p, (a, sh, u, _) in zip(sc.passes, tscene.pass_tensors(sc, DEVICE, False))]
            continue
        ref = importlib.import_module(f"rasterbench.references.{plan.options['reference']}")
        sun = ref.sun(plan, sc.camera.params.eye)
        o = plan.options["shadows"]
        settings = shadows.ShadowSettings(size=int(o["size"]), fov_margin=float(o["fov_margin"]),
                                          distance_factor=float(o["distance_factor"]))
        cam = shadows.light_camera_for_scene(sc, sun, settings)
        light = shadows.depth_scene(sc, cam, settings)
        ((a, sh, u, _),) = tscene.pass_tensors(light, DEVICE, False)
        out.append(("light", a, sh, u, settings.size, settings.size, TILE_H))
        smap = torch.zeros((settings.size, settings.size), dtype=torch.float32, device=DEVICE)
        lit = shadows.shadowed_scene(sc, sun, smap, cam, settings)
        out += [(f"lit {p.name}", a, sh, u, plan.width, plan.height, th)
                for p, (a, sh, u, _) in zip(lit.passes, tscene.pass_tensors(lit, DEVICE, False))
                if p.name != "eyes"]
    return out


def pre_phase(smi: str, record: dict) -> dict:
    """[22 pre]: ``csrc/pre.cu`` (``raster_sparse.pre_sparse`` on the card)
    against ``pre_sparse_plain`` on ``pre_passes()``: every ``PreSparse``
    field and the setup's bitwise, each entry's launches a pass, then per
    pass the kernel pre-stage and the plain one timed in turns (CUDA
    events around the call, its readback included: median of 20), each
    one's profiler device time and device events a call (a consistent
    trace; "not measured" if none is), and the kernel's bound: 96 B of
    corners read (36 depth-only) and 64 + 12V B written a triangle, 4 B a
    pair.  -> main-path launches."""
    import torch

    from tinyrenderder_tpu_torch.ops import raster_sparse as rs

    t_phase = time.perf_counter()
    passes = pre_passes()
    totals = dict.fromkeys(launch_counts(), 0)
    fields = ("tri_rec", "sorted_tri", "ids", "start", "counts")
    setup = ("valid", "screen", "ndc_z", "clip_w", "bbox")
    k_sum = p_sum = b_sum = 0.0
    for name, a, sh, u, w, h, th in passes:
        args = (a, u, sh, w, h, th)
        want = rs.pre_sparse_plain(*args)
        got, counts = counted(partial(rs.pre_sparse, *args))
        for k, v in counts.items():
            totals[k] += v
        expect = {"pre_front": 1, "pre_offsets": 1, "pre_place": int(want.total > 0)}
        if {k: counts[k] for k in expect} != expect:
            fail(f"pre {name}: launches {nonzero(counts)}, not {expect}")
        if (got.total, got.n_active) != (want.total, want.n_active):
            fail(f"pre {name}: totals {(got.total, got.n_active)} != "
                 f"{(want.total, want.n_active)}")
        same_planes(f"pre kernel vs plain, {name}", fields + setup,
                    [getattr(got, k) for k in fields] + [got.setup[k] for k in setup],
                    [getattr(want, k) for k in fields] + [want.setup[k] for k in setup])
        k_ms, p_ms = in_turns(partial(rs.pre_sparse, *args), partial(rs.pre_sparse_plain, *args))
        k_dev = consistent_device_ms(partial(rs.pre_sparse, *args),
                                     ("pre_front_kernel", "pre_offsets_kernel",
                                      "pre_place_kernel", "Memcpy"))
        p_dev = consistent_device_ms(partial(rs.pre_sparse_plain, *args))
        dev_text = lambda d: (  # noqa: E731
            "not measured: the profiler recorded no consistent trace" if d is None else
            f"{device_text(d[0])}, {d[1]} device events a call")
        f = a["position"].shape[0]
        n_vary = (got.tri_rec.shape[1] - 16) // 3
        corners = 96 if rs.pre_kind(*args[:3]) in (0, 1) else 36     # position, normal, uv
        moved = f * (corners + 64 + 12 * n_vary) + 4 * want.total
        b = bound(moved, 0)
        k_sum, p_sum, b_sum = k_sum + k_ms, p_sum + p_ms, b_sum + b[0]
        say(f"[22 pre] {name} ({type(sh).__name__}, {f} faces, {w}x{h}, {th}-row tiles, "
            f"{want.total} pairs, {want.n_active} active tiles): kernel == pre_sparse_plain "
            f"bitwise on {', '.join(fields + setup)}; launches {nonzero(counts)}; in turns "
            f"kernel {k_ms:.4f} ms (device {dev_text(k_dev)}), plain {p_ms:.4f} ms (device "
            f"{dev_text(p_dev)}); kernel/plain {k_ms / p_ms:.4f}; bound {b[0]:.4f} ms "
            f"({moved / 1e6:.2f} MB) | {smi}")
    record["pre_front"] = {"name": "pre", "route": "cuda",
                           "source": "tinyrenderder_tpu_torch/csrc/pre.cu",
                           "replaces": "none: tinyrenderder_tpu/ops/raster_sparse.py::"
                                       "_pre_sparse_jit is XLA", "max_abs_err": 0.0,
                           "ms": k_sum, "plain_ms": p_sum, "bound_ms": b_sum,
                           "bound_by": "bytes", "library_ms": None}
    say(f"[22 pre] {len(passes)} passes: kernel {k_sum:.4f} ms, plain {p_sum:.4f} ms, bound "
        f"{b_sum:.4f} ms in all")
    say(f"[22 done] {time.perf_counter() - t_phase:.1f} s; launches {nonzero(totals)}")
    return totals


def shade_cases() -> list:
    """[(name, frame, ids, (depth_c, winner_c, vary_c), uniforms, shader,
    winner_offset)]: the merge + shade inputs of every pass of the walk's
    frame (``reference_main_1200x800``, full size, culled as the cell
    culls) and of the sun walk's light pass (2048², 16-row tiles) and lit
    passes, whose shadow map is that light pass's depth, at the first view
    of ``PRE_SEED``: the coarse route's raster outputs and a copy of the
    running frame before the pass's merge."""
    import importlib

    from rasterbench import catalog, scenes
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch import shadows
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_H, TILE_W, cdiv

    out = []

    def frame_cases(prefix, sc, w, h, th, cull):
        ft = rs.new_frame_tiles(w, h, DEVICE, th)
        offset = 0
        for p, (a, sh, u, _) in zip(sc.passes, tscene.pass_tensors(sc, DEVICE, cull)):
            f = a["position"].shape[0]
            if f:
                ids, _, o = rs.raster_pass("coarse", a, u, sh, w, h, th, TILE_W,
                                           lambda ids: ft.depth[ids.long()])
                out.append((f"{prefix}{p.name}", rs.FrameTiles(*(x.clone() for x in ft)), ids,
                            o[:3], u, sh, offset))
                rs.post_sparse(ft, ids, *o[:3], u, sh, offset)
            offset += f
        return ft

    bench = catalog.Benchmark(Path(__file__).resolve().parent)
    for config, traffic in (("reference_main_1200x800", "walk"),
                            ("reference_main_shadows_1200x800", "sun_walk")):
        plan = scenes.make_plan(bench.config(config), bench.traffic(traffic), PRE_SEED)
        sc = scenes.port_scene(plan)
        sc.camera.set_eye(plan.orbit.eye_at(plan.orbit.first))
        th = rs.pick_tile_h(plan.width, plan.height)
        if traffic == "walk":
            frame_cases("", sc, plan.width, plan.height, th, plan.frustum_cull)
            continue
        ref = importlib.import_module(f"rasterbench.references.{plan.options['reference']}")
        sun = ref.sun(plan, sc.camera.params.eye)
        o = plan.options["shadows"]
        settings = shadows.ShadowSettings(size=int(o["size"]), fov_margin=float(o["fov_margin"]),
                                          distance_factor=float(o["distance_factor"]))
        s = settings.size
        cam = shadows.light_camera_for_scene(sc, sun, settings)
        light = frame_cases("", shadows.depth_scene(sc, cam, settings), s, s, TILE_H, False)
        smap = rs.untile_one(light.depth, cdiv(s, TILE_W), cdiv(s, TILE_H), TILE_H,
                             TILE_W)[:s, :s].contiguous()
        frame_cases("lit ", shadows.shadowed_scene(sc, sun, smap, cam, settings), plan.width,
                    plan.height, th, plan.frustum_cull)
    return out


def shade_phase(smi: str, record: dict) -> dict:
    """[23 shade]: ``csrc/shade.cu`` (``raster_sparse.post_sparse`` on the
    card) against ``post_sparse_plain`` on ``shade_cases()``: colour, depth
    and winner bitwise on copies of the running frame, one launch a pass,
    then per pass the kernel and the plain merge + shade timed in turns
    (CUDA events around the call, median of 20: warm, and after a 128 MB
    write, cold L2), each one's profiler device time and device events a
    call (a consistent trace; "not measured" if none is), and the
    kernel's bound: 12 B an active pixel (its depth and winner read, its
    depth written) and 4V + 8 B a won pixel (its varyings read, winner and
    colour written; 4 B, the winner, in a depth-only pass).  -> main-path
    launches."""
    import torch

    from tinyrenderder_tpu_torch.ops import raster_sparse as rs

    t_phase = time.perf_counter()
    cases = shade_cases()
    totals = dict.fromkeys(launch_counts(), 0)
    flush = cold_l2()
    k_sum = p_sum = b_sum = 0.0
    dev_text = lambda d: (  # noqa: E731
        "not measured: the profiler recorded no consistent trace" if d is None else
        f"{device_text(d[0])}, {d[1]} device events a call")
    for name, ft, ids, planes, u, sh, offset in cases:
        kind = rs.shade_kind(u, sh, (*ft, *planes))
        if kind is None:
            fail(f"shade {name}: {type(sh).__name__} takes the plain merge + shade")
        got, want = (rs.FrameTiles(*(x.clone() for x in ft)) for _ in range(2))
        _, counts = counted(partial(rs.post_sparse, got, ids, *planes, u, sh, offset))
        for k, v in counts.items():
            totals[k] += v
        if nonzero(counts) != {"merge_shade": 1}:
            fail(f"shade {name}: launches {nonzero(counts)}, not one merge_shade")
        rs.post_sparse_plain(want, ids, *planes, u, sh, offset)
        same_planes(f"merge + shade kernel vs plain, {name}", rs.FrameTiles._fields, got, want)
        kernel = partial(rs.post_sparse, got, ids, *planes, u, sh, offset)
        plain = partial(rs.post_sparse_plain, want, ids, *planes, u, sh, offset)
        k_ms, p_ms = in_turns(kernel, plain)
        k_cold, p_cold = in_turns(kernel, plain, before=flush)
        k_dev = consistent_device_ms(kernel, ("merge_shade_kernel",))
        p_dev = consistent_device_ms(plain)
        depth_c, winner_c, vary_c = planes
        won = int((winner_c >= 0).sum())
        n_vary = vary_c.shape[1]
        moved = depth_c.numel() * 12 + won * (4 * n_vary + (8 if sh.writes_color else 4))
        b = bound(moved, 0)
        k_sum, p_sum, b_sum = k_sum + k_ms, p_sum + p_ms, b_sum + b[0]
        say(f"[23 shade] {name} ({type(sh).__name__}, kind {kind}, {ids.numel()} active tiles, "
            f"{depth_c.numel()} px, {won} won, V {n_vary}): kernel == post_sparse_plain bitwise "
            f"on colour, depth, winner; launches {nonzero(counts)}; in turns kernel "
            f"{k_ms:.4f} ms (cold L2 {k_cold:.4f}; device {dev_text(k_dev)}), plain "
            f"{p_ms:.4f} ms (cold L2 {p_cold:.4f}; device {dev_text(p_dev)}); kernel/plain "
            f"{k_ms / p_ms:.4f}; bound {b[0]:.4f} ms ({moved / 1e6:.2f} MB) | {smi}")
    record["merge_shade"] = {"name": "merge_shade", "route": "cuda",
                             "source": "tinyrenderder_tpu_torch/csrc/shade.cu",
                             "replaces": "none: tinyrenderder_tpu/ops/raster_sparse.py::"
                                         "_post_sparse_jit is XLA", "max_abs_err": 0.0,
                             "ms": k_sum, "plain_ms": p_sum, "bound_ms": b_sum,
                             "bound_by": "bytes", "library_ms": None}
    say(f"[23 shade] {len(cases)} passes: kernel {k_sum:.4f} ms, plain {p_sum:.4f} ms, bound "
        f"{b_sum:.4f} ms in all")
    say(f"[23 done] {time.perf_counter() - t_phase:.1f} s; launches {nonzero(totals)}")
    return totals


def fresh_cases() -> list:
    """[(name, scene, eye, (winner_c, vary_c), uniforms, shader)]: the image
    route's single pass of ``object_orbit_800`` at full size, as
    ``rasterbench`` builds it, at three views of ``PRE_SEED``'s orbit
    (the first and 50 and 100 views on): its Phong pass as configured,
    and the same pass with an Eye shader on the same texture; the coarse
    route's raster outputs on a fresh frame."""
    import torch

    from rasterbench import catalog, scenes
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch import shaders
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W

    bench = catalog.Benchmark(Path(__file__).resolve().parent)
    plan = scenes.make_plan(bench.config("object_orbit_800"), bench.traffic("host"), PRE_SEED)
    out = []
    for eye_shader in (False, True):
        sc = scenes.port_scene(plan)
        if eye_shader:
            key, _, rim = tscene._lights()
            sc.passes[0].shader = shaders.EyeShader(key, rim)
        th = rs.pick_tile_h(plan.width, plan.height)
        for step in (0, 50, 100):
            eye = plan.orbit.eye_at(plan.orbit.first + step)
            sc.camera.set_eye(eye)
            (a, sh, u, _), = tscene.pass_tensors(sc, DEVICE, plan.frustum_cull)
            _, _, o = rs.raster_pass(
                "coarse", a, u, sh, plan.width, plan.height, th, TILE_W,
                lambda ids: torch.full((ids.shape[0], th, TILE_W), torch.inf, device=DEVICE))
            out.append((f"{type(sh).__name__} view +{step}", sc, eye, o[1:3], u, sh))
    return out


def fresh_phase(smi: str, record: dict) -> dict:
    """[24 fresh]: ``csrc/shade.cu``'s fresh-frame entry
    (``raster_sparse.shade_compact_fresh`` on the card) against
    ``shade_compact_fresh_plain`` on ``fresh_cases()``: the packed tiles
    bitwise, one launch a pass, then per pass both timed in turns (CUDA
    events around the call, median of 20: warm and cold L2), each one's
    profiler device time, and the kernel's bound as
    ``rasterbench/metrics/image_shade_roofline_pct`` counts it (4V + 8 B
    and its Phong operations a won pixel).  Then each case's frame through
    ``Scene.render_image`` == the frame of the plain shading, with the
    image route's launches counted (one ``shade_fresh``).  -> main-path
    launches."""
    import torch

    from rasterbench.metrics import image_shade_roofline_pct as roof
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs

    t_phase = time.perf_counter()
    cases = fresh_cases()
    totals = dict.fromkeys(launch_counts(), 0)
    flush = cold_l2()
    k_sum = p_sum = b_sum = 0.0
    dev_text = lambda d: (  # noqa: E731
        "not measured: the profiler recorded no consistent trace" if d is None else
        f"{device_text(d[0])}, {d[1]} device events a call")
    for name, sc, eye, (winner_c, vary_c), u, sh in cases:
        kind = rs.shade_kind(u, sh, (winner_c, vary_c))
        if kind is None:
            fail(f"fresh {name}: {type(sh).__name__} takes the plain fresh shading")
        got, counts = counted(partial(rs.shade_compact_fresh, winner_c, vary_c, u, sh))
        for k, v in counts.items():
            totals[k] += v
        if nonzero(counts) != {"shade_fresh": 1}:
            fail(f"fresh {name}: launches {nonzero(counts)}, not one shade_fresh")
        want = rs.shade_compact_fresh_plain(winner_c, vary_c, u, sh)
        same_planes(f"fresh shading kernel vs plain, {name}", ("colour",), (got,), (want,))
        kernel = partial(rs.shade_compact_fresh, winner_c, vary_c, u, sh)
        plain = partial(rs.shade_compact_fresh_plain, winner_c, vary_c, u, sh)
        k_ms, p_ms = in_turns(kernel, plain)
        k_cold, p_cold = in_turns(kernel, plain, before=flush)
        k_dev = consistent_device_ms(kernel, ("shade_fresh_kernel",))
        p_dev = consistent_device_ms(plain)
        won = int((winner_c >= 0).sum())
        b_ms = roof.pass_bound_s({"won": won, "varyings": vary_c.shape[1]}) * 1e3
        k_sum, p_sum, b_sum = k_sum + k_ms, p_sum + p_ms, b_sum + b_ms
        dev_ms = k_dev[0].get("shade_fresh_kernel") if k_dev else None
        share = ("not measured" if not dev_ms else f"{100 * b_ms / dev_ms:.2f}% of its device "
                 "time")
        sc.camera.set_eye(eye)
        image, frame_counts = counted(lambda: sc.render_image(DEVICE, frustum_cull=True,
                                                              backend="tiled"))
        for k, v in frame_counts.items():
            totals[k] += v
        old, rs._SHADE_DEVICE = rs._SHADE_DEVICE, "none"
        try:
            plain_image = sc.render_image(DEVICE, frustum_cull=True, backend="tiled")
        finally:
            rs._SHADE_DEVICE = old
        same_planes(f"render_image with the fresh kernel vs plain, {name}", ("image",),
                    (image,), (plain_image,))
        if frame_counts["shade_fresh"] != 1:
            fail(f"fresh {name}: render_image launched {nonzero(frame_counts)}")
        say(f"[24 fresh] {name} ({type(sh).__name__}, kind {kind}, {winner_c.shape[0]} tiles, "
            f"{winner_c.numel()} px, {won} won, V {vary_c.shape[1]}): kernel == "
            f"shade_compact_fresh_plain bitwise; launches {nonzero(counts)}; in turns kernel "
            f"{k_ms:.4f} ms (cold L2 {k_cold:.4f}; device {dev_text(k_dev)}), plain "
            f"{p_ms:.4f} ms (cold L2 {p_cold:.4f}; device {dev_text(p_dev)}); kernel/plain "
            f"{k_ms / p_ms:.4f}; bound {b_ms:.4f} ms, {share}; render_image == the plain "
            f"shading's frame, launches {nonzero(frame_counts)} | {smi}")
    record["shade_fresh"] = {"name": "shade_fresh", "route": "cuda",
                             "source": "tinyrenderder_tpu_torch/csrc/shade.cu",
                             "replaces": "none: tinyrenderder_tpu/ops/raster_sparse.py::"
                                         "_shade_compact_fresh is XLA", "max_abs_err": 0.0,
                             "ms": k_sum, "plain_ms": p_sum, "bound_ms": b_sum,
                             "bound_by": "bytes", "library_ms": None}
    say(f"[24 fresh] {len(cases)} passes: kernel {k_sum:.4f} ms, plain {p_sum:.4f} ms, bound "
        f"{b_sum:.4f} ms in all")
    say(f"[24 done] {time.perf_counter() - t_phase:.1f} s; launches {nonzero(totals)}")
    return totals


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one GPU")

    from tinyrenderder_tpu_torch import _build  # fails outside a checkout
    from tinyrenderder_tpu_torch import cli, shadows
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.ops import post
    from tinyrenderder_tpu_torch.ops import raster
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_fine as rf
    from tinyrenderder_tpu_torch.ops import raster_fine2 as rf2
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import (TILE_H, TILE_W, bin_triangles_csr,
                                                          cdiv, n_vary_of, shader_varyings,
                                                          to_tiles, vertex_stage)

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
    for name, c in untile_sass(lib).items():
        say(f"    sass: {name}: {c['ldg']} 16-byte loads, {c['ahead']} of them before the "
            f"first store; {c['stg']} 16-byte stores; {c['rcp']} MUFU.RCP (integer division)")
    range_pairs = _build.constant("trt_coarse_range_pairs")
    range_rows = _build.constant("trt_fine2_range_rows")
    say(f"[2 build] split walks: ranges of {range_pairs} pairs (coarse), {rf.range_rows(16)} "
        f"and {rf.range_rows(32)} slot rows (strips, 16- and 32-row tiles), {range_rows} slot "
        f"rows (grouped strips), {_build.constant('trt_proto_range_rows')} record rows "
        f"(prototype strips, #7); scan resolve walk blocks and super-blocks (px) "
        f"{tuple(raster.kernel_geometry())}; " + "; ".join(
            f"{k} {v}" for k, v in ptxas_kernels(lib.with_suffix(".log").read_text(),
                                                 SPLIT_KERNELS + SCAN_KERNELS
                                                 + PRE_KERNELS).items()))

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
                                  time_plain(lambda: rc.coarse_raster_plain(*args)))
    fine_ms, fine_plain_ms = (event_ms(lambda: rf.fine_raster(*args_f)),
                              time_plain(lambda: rf.fine_raster_plain(*args_f)))
    coarse_bound = raster_bound("coarse", pre, kc, th, ntx, n_vary, False)
    fine_bound = raster_bound("fine", pre_f, kf, th, ntx, n_vary, False)
    say(f"[3 raster] headline pass: coarse kernel == plain bitwise (depth, winner, "
        f"{n_vary} varyings), kernel {raster_ms:.4f} ms, plain {raster_plain_ms:.4f} ms, "
        f"bound {coarse_bound[0]:.4f} ms ({coarse_bound[1]}); "
        + split_text(pre.counts, range_pairs, lambda: rc.coarse_raster(*args), raster_ms,
                     fine_ms, "#4 split") + " | strip kernel == plain "
        f"bitwise, kernel {fine_ms:.4f} ms, plain {fine_plain_ms:.4f} ms, bound "
        f"{fine_bound[0]:.4f} ms ({fine_bound[1]}); "
        + split_text(pre_f.rows, rf.range_rows(th), lambda: rf.fine_raster(*args_f), fine_ms,
                     raster_ms, "coarse") + f" | {smi}")
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

    # the grouped strip raster at the stress scene's shapes, pass-local and
    # seeded with the depth of the 3-pass scene's room at the same size;
    # the coarse and strip kernels on the same pass beside it
    t0 = time.perf_counter()
    walls = {"stress": tscene.stress_scene(WALL_W, WALL_H),
             "mixed": tscene.mixed_scene(WALL_W, WALL_H)}
    wall_passes = {name: tscene.pass_tensors(sc, DEVICE) for name, sc in walls.items()}
    wall_host_s = time.perf_counter() - t0
    s_attrs, s_shader, s_uniforms, _ = wall_passes["stress"][0]
    th_w = rs.pick_tile_h(WALL_W, WALL_H)
    ntx_w = cdiv(WALL_W, TILE_W)
    nv_w = sum(s_shader.varying_spec.values())
    pre_2 = rf2.pre_fine2(s_attrs, s_uniforms, s_shader, WALL_W, WALL_H, th_w, TILE_W)
    args_2 = (pre_2.tri_rec, pre_2.tri8, pre_2.group_start, pre_2.group_rows, pre_2.x0y0,
              th_w, nv_w)
    k2 = rf2.fine2_raster(*args_2)
    fine2_err = check_outputs("grouped strip raster vs plain", k2,
                              rf2.fine2_raster_plain(*args_2))
    room_w = tscene.pass_tensors(tscene.multimesh_scene(WALL_W, WALL_H), DEVICE)[2]
    with fine_mode("coarse"):
        after_room_w, _, _ = rs.render_frame_fused([room_w], WALL_W, WALL_H, DEVICE,
                                                   tile_h=th_w)
    init_2 = rf2.init_strips(after_room_w.depth, pre_2)
    k2s = rf2.fine2_raster(*args_2, init_2, collect_stats=True)
    fine2s_err = check_outputs("grouped strip stats raster vs plain", k2s,
                               rf2.fine2_raster_plain(*args_2, init_2, collect_stats=True))
    check_outputs("grouped strip stats raster vs the seeded launch without stats",
                  k2s[:3], rf2.fine2_raster(*args_2, init_2))
    finite_2, events_2 = int(torch.isfinite(init_2).sum()), int(k2s[3][0].sum())
    if not finite_2 or not events_2:
        fail(f"fine2_raster_stats: {finite_2} finite init depths, {events_2} events")
    f2_ms, f2_plain_ms = (event_ms(lambda: rf2.fine2_raster(*args_2)),
                          time_plain(lambda: rf2.fine2_raster_plain(*args_2)))
    f2s_ms = event_ms(lambda: rf2.fine2_raster(*args_2, init_2, collect_stats=True))
    f2s_plain_ms = time_plain(lambda: rf2.fine2_raster_plain(*args_2, init_2,
                                                            collect_stats=True))
    f2_seeded_ms = event_ms(lambda: rf2.fine2_raster(*args_2, init_2))
    f2_bound = raster_bound("fine2", pre_2, k2, th_w, ntx_w, nv_w, False, seeded=False)
    f2s_bound = raster_bound("fine2", pre_2, k2s, th_w, ntx_w, nv_w, True)
    pre_wc = rs.pre_sparse(s_attrs, s_uniforms, s_shader, WALL_W, WALL_H, th_w, TILE_W)
    pre_wf = rf.pre_fine(s_attrs, s_uniforms, s_shader, WALL_W, WALL_H, th_w, TILE_W)
    args_wc = (pre_wc.tri_rec, pre_wc.sorted_tri, pre_wc.ids, pre_wc.start, pre_wc.counts,
               torch.full((pre_wc.n_active, th_w, TILE_W), torch.inf, device=DEVICE), ntx_w,
               th_w, TILE_W, nv_w)
    args_wf = (pre_wf.tri_rec, pre_wf.tri8, pre_wf.ids, pre_wf.row_start, pre_wf.rows,
               torch.full((pre_wf.n_active, th_w, TILE_W), torch.inf, device=DEVICE), ntx_w,
               th_w, TILE_W, nv_w)
    # the strip kernel on the same pass, pass-local, and its event planes
    # seeded as #5s is
    args_wfs = args_wf[:5] + (after_room_w.depth[pre_wf.ids.long()],) + args_wf[6:]
    check_outputs("strip raster vs plain, stress pass", rf.fine_raster(*args_wf),
                  rf.fine_raster_plain(*args_wf))
    check_outputs("strip stats raster vs plain, stress pass, seeded",
                  rf.fine_raster(*args_wfs, collect_stats=True),
                  rf.fine_raster_plain(*args_wfs, collect_stats=True))
    wc_ms = event_ms(lambda: rc.coarse_raster(*args_wc))
    wf_ms = event_ms(lambda: rf.fine_raster(*args_wf))
    wfs_ms = event_ms(lambda: rf.fine_raster(*args_wfs, collect_stats=True))
    args_wcs = args_wc[:5] + (after_room_w.depth[pre_wc.ids.long()],) + args_wc[6:]
    wcs_ms = event_ms(lambda: rc.coarse_raster(*args_wcs, collect_stats=True))
    say(f"[3 shapes] stress pass {WALL_W}x{WALL_H} (host build of both 246k scenes "
        f"{wall_host_s:.1f} s): faces {s_attrs['position'].shape[0]}, th {th_w}, V {nv_w}; "
        f"coarse pairs {pre_wc.total}, active {pre_wc.n_active}; strips: pairs {pre_2.pairs}, "
        f"per-tile rows {pre_wf.row_total}, grouped rows {pre_2.row_total} "
        f"({pre_2.row_total / pre_wf.row_total:.3f}), groups {pre_2.n_groups}, active "
        f"{pre_2.n_active}, largest group {int(pre_2.group_rows[0])} rows")
    say(f"[3 raster] stress pass: grouped strip kernel == plain bitwise, pass-local "
        f"(depth, winner, {nv_w} varyings) and seeded by the room's depth with stats "
        f"({finite_2} finite init depths, {events_2} events; == the seeded launch without "
        f"stats); kernel {f2_ms:.4f} ms, plain {f2_plain_ms:.4f} ms, bound "
        f"{f2_bound[0]:.4f} ms ({f2_bound[1]}); "
        + split_text(pre_2.group_rows, range_rows, lambda: rf2.fine2_raster(*args_2), f2_ms,
                     wf_ms, "#4 split")
        + f" | stats kernel {f2s_ms:.4f} ms, plain {f2s_plain_ms:.4f} ms, bound "
        f"{f2s_bound[0]:.4f} ms ({f2s_bound[1]}), seeded without stats {f2_seeded_ms:.4f} ms; "
        + split_text(pre_2.group_rows, range_rows,
                     lambda: rf2.fine2_raster(*args_2, init_2, collect_stats=True), f2s_ms,
                     wfs_ms, "#4s split") + f" (#4s {wfs_ms:.4f} ms)"
        + f" | on the same pass coarse kernel {wc_ms:.4f} ms ("
        + split_text(pre_wc.counts, range_pairs, lambda: rc.coarse_raster(*args_wc), wc_ms,
                     wf_ms, "#4 split")
        + f"), strip kernel == plain bitwise, pass-local and seeded with stats, "
        f"{wf_ms:.4f} ms (grouped/strip {f2_ms / wf_ms:.3f}, grouped/coarse "
        f"{f2_ms / wc_ms:.3f}; "
        + split_text(pre_wf.rows, rf.range_rows(th_w), lambda: rf.fine_raster(*args_wf), wf_ms,
                     wc_ms, "coarse")
        + f"), seeded with stats {wfs_ms:.4f} ms ("
        + split_text(pre_wf.rows, rf.range_rows(th_w),
                     lambda: rf.fine_raster(*args_wfs, collect_stats=True), wfs_ms, wcs_ms,
                     "coarse stats") + f", coarse stats {wcs_ms:.4f} ms) | {smi}")
    for name, err, ms, plain_ms, b in (
            ("fine2_raster", fine2_err, f2_ms, f2_plain_ms, f2_bound),
            ("fine2_raster_stats", fine2s_err, f2s_ms, f2s_plain_ms, f2s_bound)):
        record[name] = {
            "name": name, "route": "cuda",
            "source": "tinyrenderder_tpu_torch/csrc/raster_fine2.cu",
            "replaces": "tinyrenderder_tpu/ops/raster_fine2.py:236",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b[0],
            "bound_by": b[1], "library_ms": None}

    # the untile kernels: the headline's compact colour tiles, and the tiled
    # 3-pass frame at 2048², 1200x800 and a width that is not a multiple of 16
    c_img = rs.shade_compact_fresh(kc[1], kc[2], uniforms, shader)
    mm_passes = {size: tscene.pass_tensors(tscene.multimesh_scene(*size), DEVICE)
                 for size in FRAME_SIZES}
    record.update(untile_kernels(smi, c_img, pre.ids, th, mm_passes))

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
            kernel = partial(rf.fine_raster, max_rows=pp.max_rows)     # as the route calls it
            plain = rf.fine_raster_plain
        ks = kernel(*sargs, collect_stats=True)
        err = check_outputs(f"{name} vs plain", ks, plain(*sargs, collect_stats=True))
        check_outputs(f"{name} vs the launch without stats", ks[:3], kernel(*sargs))
        finite_init = int(torch.isfinite(sargs[5]).sum())
        n_events = int(ks[3][0].sum())
        if not finite_init or not n_events:
            fail(f"{name}: {finite_init} finite init depths, {n_events} events")
        s_ms = event_ms(lambda: kernel(*sargs, collect_stats=True))
        sp_ms = time_plain(lambda: plain(*sargs, collect_stats=True))
        n_ms = event_ms(lambda: kernel(*sargs))
        sb = raster_bound(mode, pp, ks, th3, cdiv(w, TILE_W), nv, True)
        if mode == "coarse":
            # and the strip kernel's event planes on the same pass, whose
            # tiles all fit one range: bitwise its plain version as the
            # route calls it (one launch) and through the split walk
            pf = rf.pre_fine(p_attrs, p_uniforms, p_shader, w, h, th3, TILE_W)
            fargs = (pf.tri_rec, pf.tri8, pf.ids, pf.row_start, pf.rows,
                     ft_prior.depth[pf.ids.long()], cdiv(w, TILE_W), th3, TILE_W, nv)
            f_want = rf.fine_raster_plain(*fargs, collect_stats=True)
            f_one = partial(rf.fine_raster, *fargs, collect_stats=True, max_rows=pf.max_rows)
            f_split = partial(rf.fine_raster, *fargs, collect_stats=True)
            check_outputs("fine_raster_stats vs plain, room pass, one launch", f_one(), f_want)
            check_outputs("fine_raster_stats vs plain, room pass, split walk", f_split(), f_want)
            one_ms, split_ms = in_turns(f_one, f_split)
            split = ("; " + split_text(pp.counts, range_pairs,
                                       lambda: kernel(*sargs, collect_stats=True), s_ms,
                                       one_ms, "#4s split") + f" | #4s on the same pass == plain "
                     f"bitwise, {one_ms:.4f} ms ("
                     + split_text(pf.rows, rf.range_rows(th3), f_one, one_ms, s_ms,
                                  "coarse stats")
                     + f"); through the split walk {split_ms:.4f} ms (in turns; "
                     f"{len(call_kernels(f_split) or '?')} launches a call)")
        else:   # and the coarse stats kernel on the same pass, its yardstick
            pc = rs.pre_sparse(p_attrs, p_uniforms, p_shader, w, h, th3, TILE_W)
            cargs = (pc.tri_rec, pc.sorted_tri, pc.ids, pc.start, pc.counts,
                     ft_prior.depth[pc.ids.long()], cdiv(w, TILE_W), th3, TILE_W, nv)
            yard_ms = event_ms(lambda: rc.coarse_raster(*cargs, collect_stats=True))
            split = "; " + split_text(pp.rows, rf.range_rows(th3),
                                      lambda: kernel(*sargs, collect_stats=True), s_ms,
                                      yard_ms, "coarse stats") + \
                f" (coarse stats {yard_ms:.4f} ms)"
        say(f"[3 raster stats] {name}, {what} at {w}x{h} (active {pp.n_active}, "
            f"{finite_init} finite init depths, {n_events} events): kernel == plain "
            f"bitwise (depth, winner, varyings, both event planes), and == the launch "
            f"without stats; kernel {s_ms:.4f} ms, plain {sp_ms:.4f} ms, bound "
            f"{sb[0]:.4f} ms ({sb[1]}); the same pass without stats {n_ms:.4f} ms{split}")
        record[name] = {"name": name, "route": "cuda", "source": src, "replaces": repl,
                        "max_abs_err": err, "ms": s_ms, "plain_ms": sp_ms,
                        "bound_ms": sb[0], "bound_by": sb[1], "library_ms": None}
    # the grouped strip raster's 32-row instantiations: the head pass after
    # the room, seeded, with and without stats
    h_attrs, h_shader, h_uniforms, _ = head_pass
    pp = rf2.pre_fine2(h_attrs, h_uniforms, h_shader, w, h, th3, TILE_W)
    hargs = (pp.tri_rec, pp.tri8, pp.group_start, pp.group_rows, pp.x0y0, th3,
             sum(h_shader.varying_spec.values()))
    h_init = rf2.init_strips(after_room.depth, pp)
    ks = rf2.fine2_raster(*hargs, h_init, collect_stats=True)
    check_outputs("fine2_raster_stats at 32 rows vs plain", ks,
                  rf2.fine2_raster_plain(*hargs, h_init, collect_stats=True))
    check_outputs("fine2_raster_stats at 32 rows vs the seeded launch without stats", ks[:3],
                  rf2.fine2_raster(*hargs, h_init))
    check_outputs("fine2_raster at 32 rows vs plain", rf2.fine2_raster(*hargs),
                  rf2.fine2_raster_plain(*hargs))
    say(f"[3 raster stats] fine2_raster_stats, head pass after the room at {w}x{h} "
        f"({pp.n_groups} groups, {pp.row_total} rows, {int(ks[3][0].sum())} events): kernel "
        f"== plain bitwise with and without stats, seeded and pass-local; kernel "
        f"{event_ms(lambda: rf2.fine2_raster(*hargs, h_init, collect_stats=True)):.4f} ms")

    # the dense launch over every tile (rasterize_pallas / depth_resolve_pallas):
    # the headline pass (2048², 32-row tiles, 8 varyings) and the light pass of
    # shadow_phong_800 (1024², 16-row tiles, depth only), each driven once
    # through its user entry with the counts zeroed
    sh_scene = tscene.multimesh_scene(SHADOW_W, SHADOW_H)
    sh_key = sh_scene.passes[0].shader.key_light_world    # bench.py::_lights()'s key
    sh_settings = shadows.ShadowSettings(size=SHADOW_SIZE)
    light_cam = shadows.light_camera_for_scene(sh_scene, sh_key, sh_settings)
    light_pass = tscene.pass_tensors(shadows.depth_scene(sh_scene, light_cam, sh_settings),
                                     DEVICE, frustum_cull=False)[0]
    for name, (d_attrs, d_shader, d_uniforms, _), size, th_d in (
            ("headline pass", (attrs, shader, uniforms, False), WIDTH, th),
            ("light pass", light_pass, SHADOW_SIZE, TILE_H)):
        setup_d, vary_d = vertex_stage(d_attrs, d_uniforms, d_shader, size, size)
        corners, nv = shader_varyings(vary_d, d_shader), n_vary_of(d_shader)
        bins = bin_triangles_csr(setup_d, size, size, TILE_W, th_d)
        n_t = bins.counts.shape[0]
        rec_d = rc.build_tri_records(setup_d, corners)
        init_img = torch.full((size, size), torch.inf, device=DEVICE)
        init_t = to_tiles(init_img, bins.n_tiles_y, bins.n_tiles_x, th_d, TILE_W, torch.inf)
        every = torch.arange(n_t, dtype=torch.int32, device=DEVICE)
        dargs = (rec_d, bins.sorted_tri, bins.start[:-1], bins.counts, init_t, bins.n_tiles_x,
                 th_d, TILE_W, nv)
        pargs = dargs[:2] + (every,) + dargs[2:]
        kd = rc.dense_raster(*dargs)
        d_err = check_outputs(f"dense raster vs plain, {name}", kd, rc.coarse_raster_plain(*pargs))
        d_ms, dp_ms = event_ms(lambda: rc.dense_raster(*dargs)), time_plain(
            lambda: rc.coarse_raster_plain(*pargs))
        d_bound = raster_bound("coarse", SimpleNamespace(ids=every, counts=bins.counts,
                                                         sorted_tri=bins.sorted_tri,
                                                         tri_rec=rec_d),
                               kd, th_d, bins.n_tiles_x, nv, False)
        # the sparse launch over the same pass's active tiles, for the empty blocks' cost
        act = torch.nonzero(bins.counts > 0)[:, 0]
        sargs = (rec_d, bins.sorted_tri, act.to(torch.int32), bins.start[act], bins.counts[act],
                 init_t[act], bins.n_tiles_x, th_d, TILE_W, nv)
        s_ms = event_ms(lambda: rc.coarse_raster(*sargs))
        # the strip kernel on the same pass
        pf = rf.pre_fine(d_attrs, d_uniforms, d_shader, size, size, th_d, TILE_W)
        fargs = (pf.tri_rec, pf.tri8, pf.ids, pf.row_start, pf.rows,
                 torch.full((pf.n_active, th_d, TILE_W), torch.inf, device=DEVICE),
                 bins.n_tiles_x, th_d, TILE_W, nv)
        split = split_text(bins.counts, range_pairs, lambda: rc.dense_raster(*dargs), d_ms,
                           event_ms(lambda: rf.fine_raster(*fargs)), "#4 split")
        if corners is None:
            (got, _), dl = counted(lambda: rc.depth_resolve(setup_d, bins, init_img, size, size,
                                                            th_d, TILE_W))
            want = shadows.render_depth_from_light(sh_scene, light_cam, sh_settings, DEVICE)
            entry = "depth_resolve == render_depth_from_light's map (the sparse route)"
        else:
            (got, _, _), dl = counted(lambda: rc.rasterize(setup_d, bins, init_img, size, size,
                                                           corners, th_d, TILE_W))
            want = rs.untile_one_plain(kd[0], bins.n_tiles_x, bins.n_tiles_y, th_d, TILE_W)
            entry = "rasterize == the untiled kernel depth"
        add_launches(dl)
        diff, _ = bits_equal(got.contiguous(), want[:size, :size].contiguous())
        if diff or dl["dense_raster"] != 1:
            fail(f"dense entry, {name}: {diff} depths differ ({entry}); launches {dl}")
        say(f"[3 dense] {name} {size}x{size} (th {th_d}, V {nv}): {n_t} tiles, "
            f"{int((bins.counts == 0).sum())} empty, {bins.total} pairs, largest bin "
            f"{int(bins.counts.max())}; kernel == plain bitwise (depth, winner, {nv} varyings); "
            f"kernel {d_ms:.4f} ms, plain {dp_ms:.4f} ms, library none, bound {d_bound[0]:.4f} ms "
            f"({d_bound[1]}); {split}; the sparse launch over the {act.numel()} active tiles "
            f"{s_ms:.4f} ms; {entry} bitwise; launches {dl['dense_raster']} | {smi}")
        if name == "headline pass":
            record["dense_raster"] = {
                "name": "dense_raster", "route": "cuda",
                "source": "tinyrenderder_tpu_torch/csrc/raster_coarse.cu",
                "replaces": "tinyrenderder_tpu/ops/raster_pallas.py:321",
                "max_abs_err": d_err, "ms": d_ms, "plain_ms": dp_ms,
                "bound_ms": d_bound[0], "bound_by": d_bound[1], "library_ms": None}
        else:
            record["dense_raster"]["max_abs_err"] = max(record["dense_raster"]["max_abs_err"],
                                                        d_err)

    # the ports of the scripts' kernels, and the 800² Gouraud and Textured frames
    entries, exp_launches = experimental_kernels((attrs, shader, uniforms), pre.ids, th, smi)
    record.update(entries)
    add_launches(exp_launches)
    add_launches(shaded_800(smi))

    # ---- 4. the image route end to end, counted, on each raster ----
    images = {}
    for mode in MODES:
        with fine_mode(mode):
            images[mode], launches = counted(lambda: tscene.render_scene_image(scene, DEVICE))
        add_launches(launches)
        image = images[mode]
        say(f"[4 route] FINE_MODE={mode!r}: render_scene_image -> {tuple(image.shape)} "
            f"{image.dtype} on {image.device}; launches {launches}")
        if not (launches[f"{mode}_raster"] and launches["untile_image"]):
            fail(f"a kernel of the {mode} route never launched: {launches}")
        if tuple(image.shape) != (HEIGHT, WIDTH, 3) or image.dtype != torch.uint8:
            fail(f"image is {tuple(image.shape)} {image.dtype}")
    t0 = time.perf_counter()
    ref = head_ref = tscene.oracle_render(scene)
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
    say(f"[4 oracle] all {len(images)} images == float32 oracle bitwise: 0 of {WIDTH * HEIGHT} pixels "
        f"differ, {covered} covered (oracle {oracle_s:.1f} s on the host)")

    # ---- 5. timing on pre-uploaded inputs, the three rasters in turns ----
    stage_names = ("pre", "raster", "shade", "placement")
    for mode in MODES:
        for plain, composed in ((False, False), (True, False), (False, True)):
            # the staged copy has not drifted, and the composed placement agrees
            if not torch.equal(staged_frame(attrs, shader, uniforms, WIDTH, HEIGHT, th,
                                            mode, plain, composed=composed), images[mode]):
                fail(f"the staged {mode} frame (plain={plain}, composed={composed}) differs "
                     f"from the image route")
    frame_ms = ab_ms(lambda mode: rs.render_frame_fused_image(
        [(attrs, shader, uniforms, False)], WIDTH, HEIGHT, tile_h=th))
    for mode in MODES:
        for plain in (False, True):
            route = "plain" if plain else "kernel"
            ms = (time_plain(lambda: staged_frame(attrs, shader, uniforms, WIDTH, HEIGHT, th,
                                                  mode, True)) if plain else frame_ms[mode])
            st = stage_medians(lambda m: staged_frame(attrs, shader, uniforms, WIDTH,
                                                      HEIGHT, th, mode, plain, m),
                               stage_names, plain)
            say(f"[5 timing] head_phong_{WIDTH} {mode} {route} route: {ms:.3f} ms/frame, "
                f"{WIDTH * HEIGHT / ms / 1e3:.1f} Mpix/s (screen pixels); stages ms: "
                + " ".join(f"{s} {v:.3f}" for s, v in st.items()) + f" | {smi}")
    say(f"[5 a/b] head_phong_{WIDTH}: kernel route ms/frame in turns, {ab_text(frame_ms)} "
        f"| {smi}")
    say(f"[5 untile a/b] head_phong_{WIDTH} coarse, staged, in turns: " + placement_ab(
        lambda m, c: staged_frame(attrs, shader, uniforms, WIDTH, HEIGHT, th, "coarse", False,
                                  m, composed=c), stage_names, "placement") + f" | {smi}")

    # the A/B on more single-pass frames: the Gouraud head at 800², and the
    # headline head at three tessellations
    ab_scenes = {"head_gouraud_800": (tscene.headline_scene(800, 800, "gouraud"), 800, 800)}
    for lat, lon in ((24, 36), (48, 72), (96, 144)):
        ab_scenes[f"head_phong_{WIDTH}_{lat}x{lon}"] = (
            tscene.headline_scene(WIDTH, HEIGHT, "phong", n_lat=lat, n_lon=lon), WIDTH, HEIGHT)
    for name, (sc, w, h) in ab_scenes.items():
        a_attrs, a_shader, a_uniforms, _ = tscene.pass_tensors(sc, DEVICE)[0]
        th_a = rs.pick_tile_h(w, h)
        rows = rf.pre_fine(a_attrs, a_uniforms, a_shader, w, h, th_a, TILE_W).row_total
        grouped = rf2.pre_fine2(a_attrs, a_uniforms, a_shader, w, h, th_a, TILE_W).row_total
        pairs = rs.pre_sparse(a_attrs, a_uniforms, a_shader, w, h, th_a, TILE_W).total
        outs, st = {}, {}
        for mode in MODES:
            with fine_mode(mode):
                outs[mode] = rs.render_frame_fused_image(
                    [(a_attrs, a_shader, a_uniforms, False)], w, h, tile_h=th_a)
            st[mode] = stage_medians(lambda m: staged_frame(
                a_attrs, a_shader, a_uniforms, w, h, th_a, mode, False, m), stage_names)
        ms = ab_ms(lambda mode: rs.render_frame_fused_image(
            [(a_attrs, a_shader, a_uniforms, False)], w, h, tile_h=th_a))
        for mode in MODES[1:]:
            if not torch.equal(outs["coarse"], outs[mode]):
                fail(f"{name}: the {mode} image differs from the coarse image")
        say(f"[5 a/b] {name}: faces {a_attrs['position'].shape[0]}, th {th_a}, strip rows "
            f"{rows}, grouped rows {grouped}, coarse pairs {pairs}, rows/pairs "
            f"{rows / max(pairs, 1):.3f}, grouped/rows {grouped / max(rows, 1):.3f}; "
            f"ms/frame in turns {ab_text(ms)}; raster ms "
            + " ".join(f"{m} {st[m]['raster']:.3f}" for m in MODES) + "; pre ms "
            + " ".join(f"{m} {st[m]['pre']:.3f}" for m in MODES)
            + f"; images equal | {smi}")

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
        # the CLI scene ends in an excluded pass: its output depth is the
        # snapshot's image store
        for k in (f"{mode}_raster", f"{mode}_raster_stats", "untile3_image", "untile_image"):
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
        code, cli_launches = counted(lambda: cli.run(
            ["--device", DEVICE, "--width", str(REF_W), "--height", str(REF_H),
             "--outdir", str(out)]))
        add_launches(cli_launches)
        if code != 0:
            fail(f"the CLI exited {code}")
        write_oracle_files(want_dir, oracles["cli_default"])
        sizes = same_files(out, want_dir, "CLI")
        if not (cli_launches["untile3_image"] and cli_launches["untile_image"]
                and sum(cli_launches[f"{m}_raster_stats"] for m in MODES)):
            fail(f"a kernel of the CLI's frame never launched: {cli_launches}")
        say(f"[7 cli] tinyrenderder_tpu_torch.cli {REF_W}x{REF_H} on {DEVICE} "
            f"(FINE_MODE={rs.FINE_MODE!r}): 4 TGAs byte-identical to the f32 oracle + NumPy "
            f"post ({sizes}); launches {cli_launches}")
        # --shadows: the shadowed frame from the key light, 1024² map
        out_s = Path(tmp) / "port_shadows"
        code, cli_s_launches = counted(lambda: cli.run(
            ["--device", DEVICE, "--width", str(REF_W), "--height", str(REF_H),
             "--outdir", str(out_s), "--shadows", "--shadow-size", str(SHADOW_SIZE)]))
        add_launches(cli_s_launches)
        if code != 0:
            fail(f"the CLI with --shadows exited {code}")
        t0 = time.perf_counter()
        ref_s, _ = shadows.oracle_render_with_shadows(
            cli.build_default_scene(width=REF_W, height=REF_H), cli.KEY_LIGHT_DIR,
            shadows.ShadowSettings(size=SHADOW_SIZE))
        cli_oracle_s = time.perf_counter() - t0
        write_oracle_files(Path(tmp) / "oracle_shadows", ref_s)
        sizes = same_files(out_s, Path(tmp) / "oracle_shadows", "CLI --shadows")
        if (out_s / "phong.tga").read_bytes() == (out / "phong.tga").read_bytes():
            fail("the CLI's --shadows phong.tga equals the one without shadows")
        if not (cli_s_launches["untile3_image"] and cli_s_launches["untile_image"]
                and cli_s_launches["untile_one"]
                and sum(cli_s_launches[f"{m}_raster"] for m in MODES)
                and sum(cli_s_launches[f"{m}_raster_stats"] for m in MODES)):
            fail(f"a kernel of the CLI's shadowed frame never launched: {cli_s_launches}")
        say(f"[7 cli] --shadows --shadow-size {SHADOW_SIZE}: 4 TGAs byte-identical to the f32 "
            f"oracle's two passes + NumPy post ({sizes}; oracle {cli_oracle_s:.1f} s on the "
            f"host); launches {cli_s_launches}")

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
                ms = (time_plain(lambda: staged_multipass(passes, w, h, mode, True, with_post))
                      if plain else frame_ms[mode])
                st = stage_medians(lambda m: staged_multipass(passes, w, h, mode, plain,
                                                              with_post, m), names, plain)
                say(f"[8 timing] {cell} {mode} {'plain' if plain else 'kernel'} route: "
                    f"{ms:.3f} ms/frame, {w * h / ms / 1e3:.1f} Mpix/s; stages ms: "
                    + " ".join(f"{k} {v:.3f}" for k, v in st.items())
                    + f" | {len(passes)} passes, one readback each | {smi}")
        say(f"[8 a/b] {cell}: kernel route ms/frame in turns, {ab_text(frame_ms)} | {smi}")
        if not torch.equal(staged_multipass(passes, w, h, "coarse", False, with_post,
                                            composed=True)[-1 if with_post else 0],
                           kernel_run()):
            fail(f"{cell}: the staged frame with the composed untile differs")
        say(f"[8 untile a/b] {cell} coarse, staged, in turns: " + placement_ab(
            lambda m, c: staged_multipass(passes, w, h, "coarse", False, with_post, m,
                                          composed=c), names, "untile") + f" | {smi}")

    # ---- 9. the bench's 246k-triangle scenes, against the oracle ----
    for name, sc in walls.items():
        t0 = time.perf_counter()
        ref = oracles[name] = tscene.oracle_render(sc)
        say(f"[9 oracle] {name} {WALL_W}x{WALL_H}, {sc.passes[0].mesh.nfaces} faces, on the "
            f"host: {time.perf_counter() - t0:.1f} s")
        frames_w = {}
        for mode in MODES[::-1]:
            with fine_mode(mode):
                frames_w[mode], wl = counted(lambda: (
                    tscene.render_scene(sc, DEVICE, collect_stats=True),
                    tscene.render_scene_image(sc, DEVICE)))
            add_launches(wl)
            for k in (f"{mode}_raster", f"{mode}_raster_stats", "untile3_image",
                      "untile_image"):
                if not wl[k]:
                    fail(f"{k} never launched on the {name} scene under {mode}: {wl}")
            r, image = frames_w[mode]
            if mode == "fine2":
                for plane in ("color", "depth", "full_depth"):
                    diff, err = bits_equal(getattr(r, plane).cpu(), torch.from_numpy(
                        np.ascontiguousarray(getattr(ref, plane))))
                    if diff:
                        fail(f"fine2 {name} {plane}: {diff} elements differ from the f32 "
                             f"oracle (max abs err {err})")
                if r.stats != ref.stats:
                    fail(f"fine2 {name} stats differ from the oracle's:\n  port   {r.stats}\n"
                         f"  oracle {ref.stats}")
                if not np.array_equal(image.cpu().numpy(), ref.color):
                    fail(f"fine2 {name}: render_scene_image differs from the f32 oracle")
            else:
                want, want_image = frames_w["fine2"]
                for plane in ("color", "depth", "full_depth"):
                    if not torch.equal(getattr(r, plane), getattr(want, plane)):
                        fail(f"{name}: the {mode} {plane} differs from the fine2 frame's")
                if r.stats != want.stats or not torch.equal(image, want_image):
                    fail(f"{name}: the {mode} stats or image differ from the fine2 route's")
            say(f"[9 route] {name} FINE_MODE={mode!r}: render_scene (stats) and "
                f"render_scene_image; launches {wl}")
        say(f"[9 oracle] {name}: under fine2 colour, depth and full depth == float32 oracle "
            f"bitwise ({int(torch.isfinite(r.full_depth).sum())} covered), stats equal "
            f"({ref.stats.describe()}), render_scene_image == oracle; the coarse and fine "
            f"frames, stats and images equal the fine2 ones")

    # ---- 10. timing of the 246k-triangle frames, the three rasters in turns ----
    for name, passes in wall_passes.items():
        def bench_frame():
            ft, _, _ = rs.render_frame_fused(passes, WALL_W, WALL_H, DEVICE)
            return rs.tiles_to_buffers(ft, WALL_W, WALL_H).color

        for mode in MODES:
            with fine_mode(mode):
                want_img = bench_frame()
            if not torch.equal(staged_multipass(passes, WALL_W, WALL_H, mode, False,
                                                False)[0], want_img):
                fail(f"{name} {mode}: the staged frame differs from render_frame_fused")
        frame_ms = ab_ms(lambda mode: bench_frame())
        st = {mode: stage_medians(lambda m: staged_multipass(passes, WALL_W, WALL_H, mode,
                                                             False, False, m), frame_stages)
              for mode in MODES}
        p_attrs, p_shader, p_uniforms, _ = passes[0]
        pf = rf.pre_fine(p_attrs, p_uniforms, p_shader, WALL_W, WALL_H, th_w, TILE_W)
        pf2 = rf2.pre_fine2(p_attrs, p_uniforms, p_shader, WALL_W, WALL_H, th_w, TILE_W)
        pairs = rs.pre_sparse(p_attrs, p_uniforms, p_shader, WALL_W, WALL_H, th_w, TILE_W).total
        for mode in MODES:
            say(f"[10 timing] {name}_{WALL_W}x{WALL_H} {mode} kernel route: "
                f"{frame_ms[mode]:.3f} ms/frame, {WALL_W * WALL_H / frame_ms[mode] / 1e3:.1f} "
                f"Mpix/s, {p_attrs['position'].shape[0] / frame_ms[mode] / 1e3:.2f} Mtri/s; "
                f"stages ms: " + " ".join(f"{k} {v:.3f}" for k, v in st[mode].items())
                + f" | {smi}")
        say(f"[10 untile a/b] {name}_{WALL_W}x{WALL_H} coarse, staged, in turns: "
            + placement_ab(lambda m, c: staged_multipass(passes, WALL_W, WALL_H, "coarse",
                                                         False, False, m, composed=c),
                           frame_stages, "untile") + f" | {smi}")
        say(f"[10 a/b] {name}_{WALL_W}x{WALL_H}: per-tile rows {pf.row_total}, grouped rows "
            f"{pf2.row_total} ({pf2.row_total / pf.row_total:.3f}), groups "
            f"{pf2.n_groups}, active {pf2.n_active}, coarse pairs {pairs}; kernel route "
            f"ms/frame in turns, {ab_text(frame_ms)} | {smi}")

    # ---- 12. shadow_phong_800: the shadowed frame against the oracle ----
    t0 = time.perf_counter()
    ref, ref_map = sh_oracle = shadows.oracle_render_with_shadows(sh_scene, sh_key,
                                                                  sh_settings,
                                                                  frustum_cull=False)
    sh_oracle_s = time.perf_counter() - t0
    l_attrs, l_shader, l_uniforms, _ = light_pass
    l_pre = rs.pre_sparse(l_attrs, l_uniforms, l_shader, SHADOW_SIZE, SHADOW_SIZE, TILE_H,
                          TILE_W)
    lit_shapes = ", ".join(f"{p.name} {p.mesh.nfaces} faces {type(p.shader).__name__} "
                           f"V {n_vary_of(p.shader)}"
                           for p in shadows.shadowed_scene(sh_scene, sh_key, ref_map, light_cam,
                                                           sh_settings).passes)
    say(f"[12 shapes] shadow_phong_{SHADOW_W}: light pass {SHADOW_SIZE}x{SHADOW_SIZE} (th "
        f"{TILE_H}, depth only): faces {l_attrs['position'].shape[0]}, coarse pairs "
        f"{l_pre.total}, active tiles {l_pre.n_active} of "
        f"{cdiv(SHADOW_SIZE, TILE_W) * cdiv(SHADOW_SIZE, TILE_H)}; "
        f"lit passes at {SHADOW_W}x{SHADOW_H} (th {rs.pick_tile_h(SHADOW_W, SHADOW_H)}): "
        f"{lit_shapes}; f32 oracle of both passes {sh_oracle_s:.1f} s on the host")
    for mode in MODES:
        with fine_mode(mode):
            (res, smap), sl = counted(lambda: shadows.render_with_shadows(
                sh_scene, sh_key, sh_settings, DEVICE, frustum_cull=False))
            res0, smap0 = shadows.render_with_shadows(sh_scene, sh_key, sh_settings, DEVICE,
                                                      frustum_cull=False, collect_stats=False)
        add_launches(sl)
        # the light pass's map is the plain-layout untile, the lit frame's
        # buffers the three-plane image store
        for k in (f"{mode}_raster", f"{mode}_raster_stats", "untile_one", "untile3_image"):
            if not sl[k]:
                fail(f"{k} never launched in the {mode} shadowed frame: {sl}")
        diff, err = bits_equal(smap.cpu(), torch.from_numpy(ref_map))
        if diff or not torch.equal(smap0, smap):
            fail(f"{mode} shadow map: {diff} depths differ from the f32 oracle's light pass "
                 f"(max abs err {err}), or the map differs without stats")
        for plane in ("color", "depth", "full_depth"):
            diff, err = bits_equal(getattr(res, plane).cpu(),
                                   torch.from_numpy(np.ascontiguousarray(getattr(ref, plane))))
            if diff:
                fail(f"{mode} shadow_phong_{SHADOW_W} {plane}: {diff} elements differ from the "
                     f"f32 oracle (max abs err {err})")
            if not torch.equal(getattr(res0, plane), getattr(res, plane)):
                fail(f"{mode} shadow_phong_{SHADOW_W} {plane} differs without stats")
        if res.stats != ref.stats:
            fail(f"{mode} shadow_phong_{SHADOW_W} stats differ from the oracle's:\n  port   "
                 f"{res.stats}\n  oracle {ref.stats}")
        say(f"[12 shadows] FINE_MODE={mode!r}: render_with_shadows -> map == f32 oracle light "
            f"pass bitwise ({int(torch.isfinite(smap).sum())} texels drawn), colour, depth and "
            f"full depth == f32 oracle of the lit scene fed that map bitwise "
            f"({int(torch.isfinite(res.full_depth).sum())} covered), stats equal "
            f"({res.stats.describe()}), the frame without stats equal; launches {sl}")

    # ---- 13. shadow_phong_800 timing on pre-uploaded inputs, in turns ----
    lit_passes = tscene.pass_tensors(shadows.shadowed_scene(sh_scene, sh_key, smap, light_cam,
                                                            sh_settings),
                                     DEVICE, frustum_cull=False)

    def shadow_run(marks=None):
        return staged_shadow_frame([light_pass], lit_passes, SHADOW_W, SHADOW_H, SHADOW_SIZE,
                                   marks)

    def shadow_e2e():
        return shadows.render_with_shadows(sh_scene, sh_key, sh_settings, DEVICE,
                                           frustum_cull=False, collect_stats=False)[0].color

    for mode in MODES:
        with fine_mode(mode):
            if not torch.equal(shadow_run(), shadow_e2e()):
                fail(f"the staged shadowed frame ({mode}) differs from render_with_shadows")
    frame_ms = ab_ms(lambda mode: shadow_run())
    e2e_ms = ab_ms(lambda mode: shadow_e2e())
    for mode in MODES:
        with fine_mode(mode):
            st = stage_medians(shadow_run, ("light pass", "untile", "lit frame"))
        say(f"[13 timing] shadow_phong_{SHADOW_W} {mode} kernel route: {frame_ms[mode]:.3f} "
            f"ms/frame on pre-uploaded inputs, {SHADOW_W * SHADOW_H / frame_ms[mode] / 1e3:.1f} "
            f"Mpix/s; render_with_shadows with its host layer {e2e_ms[mode]:.3f} ms/frame; "
            f"stages ms: " + " ".join(f"{k} {v:.3f}" for k, v in st.items()) + f" | {smi}")
    say(f"[13 a/b] shadow_phong_{SHADOW_W}: ms/frame in turns, pre-uploaded "
        f"{ab_text(frame_ms)}; with the host layer {ab_text(e2e_ms)} | {smi}")

    # ---- 15. the orbit animation, the native codec, --animate and --profile ----
    add_launches(animation_phase(smi))

    # ---- 16. the scene entry methods, their caches and loaded models ----
    add_launches(host_phase(smi))

    # ---- 17. the sharded backends: one rank, and 4 ranks emulated ----
    add_launches(sharded_phase(smi, scene, head_ref, walls["stress"], oracles["stress"],
                               record))

    # ---- 18. the triangle-sharded backend: one rank, 4 and 7 ranks emulated ----
    add_launches(geometry_phase(smi, scene, head_ref, walls["stress"], oracles["stress"],
                                frames["multimesh"], oracles["multimesh"],
                                (sh_scene, sh_key, sh_settings, *sh_oracle, [light_pass],
                                 lit_passes)))

    # ---- 19. the orbit on every backend ----
    add_launches(animation_ranks_phase(smi))

    # ---- 20. the scan backend ----
    add_launches(scan_phase(smi, scene, head_ref, frames["multimesh"], oracles["multimesh"],
                            walls["stress"], (sh_scene, sh_key, sh_settings, *sh_oracle),
                            record))

    # ---- 21. the post kernel ----
    add_launches(post_phase(smi, record))

    # ---- 22. the pre-stage kernel ----
    add_launches(pre_phase(smi, record))

    # ---- 23. the merge + shade kernel ----
    add_launches(shade_phase(smi, record))

    # ---- 24. the fresh-frame shading kernel ----
    add_launches(fresh_phase(smi, record))

    if "jax" in sys.modules or any(m.split(".")[0] == "tinyrenderder_tpu" for m in sys.modules):
        fail("jax or the JAX package was imported")
    order = ("coarse_raster", "coarse_raster_stats", "dense_raster", "fine_raster",
             "fine_raster_stats", "fine2_raster", "fine2_raster_stats", "untile_one",
             "untile_image", "untile3", "untile3_image", "strip_raster_proto", "rank_pairs",
             "inplace_blocks", "scan_resolve", "scan_resolve_stats", "post", "pre_front",
             "merge_shade", "shade_fresh")
    # untile_one and untile3 are kernels: their launches include their image stores'
    stores = {"untile_one": "untile_image", "untile3": "untile3_image"}
    kernels = []
    for name in order:
        entry = dict(record[name])
        entry["launches"] = totals[name] + (totals[stores[name]] if name in stores else 0)
        kernels.append({k: entry[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")})
    say(f"[14 done] {time.perf_counter() - t_start:.1f} s; main-path launches {totals}")
    say(f"[profiler] traces read without their first call (the whole-trace check failed; "
        f"the marker split held): {len(RELAXED)}: {', '.join(RELAXED) or 'none'}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
