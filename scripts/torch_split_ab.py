#!/usr/bin/env python3
"""A/B runs of the split raster walks of the PyTorch/CUDA port on one GPU.

    python3 scripts/torch_split_ab.py variants --set kRangePairs=32,64 [--set NAME=V,...]
    python3 scripts/torch_split_ab.py kernels --root DIR --tag NAME
    python3 scripts/torch_split_ab.py stages --root DIR --tag NAME

``--only TEXT`` (variants, kernels) keeps the workloads whose name holds
TEXT, and "#4 headline", the yardstick.

``variants``: builds the kernel library once for each combination of the
``--set`` values of integer constants of ``csrc/*.cu*`` (``constexpr int
NAME = V;``, e.g. ``kRangePairs`` and ``kWarpCols`` of
``raster_coarse.cu``, ``kRangeRows`` of ``raster_fine2.cu``, both files'
``kMinBlocks`` and ``kMinBlocksStats32``, ``kTileRangeArea``,
``kTileMinBlocks`` and ``kTileMinBlocksStats32`` of ``raster_fine.cu``,
``kMergeRows`` and ``kMergeAhead`` of ``raster_common.cuh``,
``kProtoRangeRows`` of ``fine_raster.cu``, ``kThreads``, ``kBlockW``,
``kPixY`` and ``kSuperPx`` of ``scan_resolve.cu``, edited in a copy of ``csrc``
under ``build/split_ab/``), checks every raster of each
build bitwise against its plain version, and times them in turns (the
builds in order, then in reverse; the mean of each build's two CUDA-event
medians): the coarse raster on the 2048² headline pass and on the 246k
stress pass, its event planes on the 2048² room pass after the head, the
strip raster on the headline pass, on the stress pass, and with stats on
the 2048² head pass after the room and on the room pass after the head
(whose tiles all fit one range: as the route calls it), the grouped strip
raster on the stress pass pass-local and seeded with the 1280x800 room's
depth with stats, the dense launch on the headline pass and on the
1024² light pass of shadow_phong_800, the prototype strip raster (#7)
on the headline head's 8x128 groups, and the scan resolve (S, the "xla"
backend's, checked against its split plain version) on the headline
pass, with stats, on the 2048² room pass after the head and on the
stress pass, without and with stats.  Each line also gives the
profiler's device time per kernel and the ratio to the strip raster on
the headline pass.

``kernels``: the same workloads' CUDA-event medians through the package
of the checkout at DIR (its own ``chip_smoke.py`` helpers and kernels);
run it for two checkouts in turns (A, B, B, A) to compare them in one
call.

``stages``: the "raster" stage median (and the frame's) of the staged
frames of ``chip_smoke.py`` on the coarse route (the 2048² headline, the
3-pass scene at 2048², the stress scene at 1280x800), on the strip route
(the 2048² headline) and on the grouped strip route (the stress scene),
from the checkout at DIR, in turns as ``kernels``.  Each line is one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def variant_csrc(csrc: Path, values: dict[str, int]) -> Path:
    """A copy of ``csrc`` with each constant ``NAME`` of ``values`` set in
    every source that defines it."""
    out = ROOT / "build" / "split_ab" / variant_name(values)
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    for name, v in values.items():
        hits = 0
        for src in out.glob("*.cu*"):
            text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {v};",
                              src.read_text())
            src.write_text(text)
            hits += n
        if not hits:
            raise SystemExit(f"no source defines {name}")
    return out


def variant_name(values: dict[str, int]) -> str:
    return "_".join(f"{k}{v}" for k, v in values.items())


def workloads(cs):
    """name -> (kernel call, plain call), at the smoke's shapes."""
    import torch

    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch import shadows
    from tinyrenderder_tpu_torch.ops import raster_coarse as rc
    from tinyrenderder_tpu_torch.ops import raster_fine as rf
    from tinyrenderder_tpu_torch.ops import raster_fine2 as rf2
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    from tinyrenderder_tpu_torch.ops.raster_tiled import (TILE_H, TILE_W, bin_triangles_csr,
                                                          cdiv, n_vary_of, shader_varyings,
                                                          to_tiles, vertex_stage)
    dev, out = cs.DEVICE, {}
    w = h = cs.WIDTH

    def inf(n, th):
        return torch.full((n, th, TILE_W), torch.inf, device=dev)

    def coarse(pre, init, ntx, th, nv, name, stats=False):
        a = (pre.tri_rec, pre.sorted_tri, pre.ids, pre.start, pre.counts, init, ntx, th,
             TILE_W, nv)
        out[name] = (lambda: rc.coarse_raster(*a, collect_stats=stats),
                     lambda: rc.coarse_raster_plain(*a, collect_stats=stats))

    head = tscene.pass_tensors(tscene.headline_scene(w, h, "phong"), dev)[0]
    th = rs.pick_tile_h(w, h)
    nv = n_vary_of(head[1])
    pre = rs.pre_sparse(head[0], head[2], head[1], w, h, th, TILE_W)
    coarse(pre, inf(pre.n_active, th), cdiv(w, TILE_W), th, nv, "#1 headline")
    def strip(p, size, th, init, name, stats=False):
        """#4 on pass p = (attrs, shader, uniforms, ...) at size = (w, h),
        with the route's max_rows where the checkout's pre-stage has it;
        init(pre) -> the running depth of the pre-stage's active tiles."""
        pf = rf.pre_fine(p[0], p[2], p[1], *size, th, TILE_W)
        a = (pf.tri_rec, pf.tri8, pf.ids, pf.row_start, pf.rows, init(pf), cdiv(size[0], TILE_W),
             th, TILE_W, n_vary_of(p[1]))
        kw = {"max_rows": pf.max_rows} if hasattr(pf, "max_rows") else {}
        out[name] = (lambda: rf.fine_raster(*a, collect_stats=stats, **kw),
                     lambda: rf.fine_raster_plain(*a, collect_stats=stats))

    strip(head, (w, h), th, lambda pf: inf(pf.n_active, th), "#4 headline")

    head3, _, room3 = tscene.pass_tensors(tscene.multimesh_scene(w, h), dev)
    with cs.fine_mode("coarse"):
        after_head, _, _ = rs.render_frame_fused([head3], w, h, dev, tile_h=th)
        after_room3, _, _ = rs.render_frame_fused([room3], w, h, dev, tile_h=th)
    pr = rs.pre_sparse(room3[0], room3[2], room3[1], w, h, th, TILE_W)
    coarse(pr, after_head.depth[pr.ids.long()], cdiv(w, TILE_W), th, n_vary_of(room3[1]),
           "#1s room after the head", stats=True)
    strip(head3, (w, h), th, lambda pf: after_room3.depth[pf.ids.long()],
          "#4s head after the room", stats=True)
    strip(room3, (w, h), th, lambda pf: after_head.depth[pf.ids.long()],
          "#4s room after the head", stats=True)

    ww, wh = cs.WALL_W, cs.WALL_H
    sa, ssh, su, _ = tscene.pass_tensors(tscene.stress_scene(ww, wh), dev)[0]
    thw, nvw = rs.pick_tile_h(ww, wh), n_vary_of(ssh)
    pw = rs.pre_sparse(sa, su, ssh, ww, wh, thw, TILE_W)
    coarse(pw, inf(pw.n_active, thw), cdiv(ww, TILE_W), thw, nvw, "#1 stress")
    strip((sa, ssh, su), (ww, wh), thw, lambda pf: inf(pf.n_active, thw), "#4 stress")
    p2 = rf2.pre_fine2(sa, su, ssh, ww, wh, thw, TILE_W)
    a2 = (p2.tri_rec, p2.tri8, p2.group_start, p2.group_rows, p2.x0y0, thw, nvw)
    room_w = tscene.pass_tensors(tscene.multimesh_scene(ww, wh), dev)[2]
    with cs.fine_mode("coarse"):
        after_room, _, _ = rs.render_frame_fused([room_w], ww, wh, dev, tile_h=thw)
    i2 = rf2.init_strips(after_room.depth, p2)
    out["#5 stress"] = (lambda: rf2.fine2_raster(*a2), lambda: rf2.fine2_raster_plain(*a2))
    out["#5s stress seeded"] = (lambda: rf2.fine2_raster(*a2, i2, collect_stats=True),
                                lambda: rf2.fine2_raster_plain(*a2, i2, collect_stats=True))

    sh_scene = tscene.multimesh_scene(cs.SHADOW_W, cs.SHADOW_H)
    settings = shadows.ShadowSettings(size=cs.SHADOW_SIZE)
    cam = shadows.light_camera_for_scene(sh_scene, sh_scene.passes[0].shader.key_light_world,
                                         settings)
    light = tscene.pass_tensors(shadows.depth_scene(sh_scene, cam, settings), dev,
                                frustum_cull=False)[0]
    for name, (d_attrs, d_shader, d_uniforms, _), size, th_d in (
            ("#6 headline", head, w, th), ("#6 light pass", light, cs.SHADOW_SIZE, TILE_H)):
        setup, vary = vertex_stage(d_attrs, d_uniforms, d_shader, size, size)
        bins = bin_triangles_csr(setup, size, size, TILE_W, th_d)
        rec = rc.build_tri_records(setup, shader_varyings(vary, d_shader))
        init = to_tiles(torch.full((size, size), torch.inf, device=dev), bins.n_tiles_y,
                        bins.n_tiles_x, th_d, TILE_W, torch.inf)
        every = torch.arange(bins.counts.shape[0], dtype=torch.int32, device=dev)
        d = (rec, bins.sorted_tri, bins.start[:-1], bins.counts, init, bins.n_tiles_x, th_d,
             TILE_W, n_vary_of(d_shader))
        out[name] = (lambda d=d: rc.dense_raster(*d),
                     lambda d=d, e=every: rc.coarse_raster_plain(*d[:2], e, *d[2:]))

    # #7 through the wrapper as strip_rasterize calls it (with the row
    # total where the checkout's build_strip_records returns one)
    from tinyrenderder_tpu_torch.experimental import fine_raster as xfr
    setup7 = vertex_stage(head[0], head[2], head[1], w, h)[0]
    recs7, rows7, ntx7, nty7, *total7 = xfr.build_strip_records(setup7, w, h)
    kw7 = {"row_total": total7[0]} if total7 else {}
    init7 = to_tiles(torch.full((h, w), torch.inf, device=dev), nty7, ntx7, xfr.TILE_H, TILE_W,
                     torch.inf)
    out["#7 headline head"] = (lambda: xfr.strip_raster(recs7, rows7, init7, ntx7, **kw7),
                               lambda: xfr.strip_raster_plain(recs7, rows7, init7, ntx7))

    # S, the scan resolve, as render_pass_xla calls it (the plain side: the
    # split plain version, which the checkout at --root may lack)
    from tinyrenderder_tpu_torch.ops import raster

    def scan(name, p, size, init=None, stats=False):
        setup = vertex_stage(p[0], p[2], p[1], *size)[0]
        w_, h_ = size
        if stats:
            seed = init if init is not None else torch.full((h_, w_), torch.inf, device=dev)

            def plain():
                d, wn, n, mz = raster.scan_resolve_split_plain(setup, h_, w_, seed,
                                                               collect_stats=True)
                return d, wn, n, torch.where(wn >= 0, d, torch.inf).amin(), mz
            out[name] = (lambda: raster.pass_events_xla(setup, seed, h_, w_), plain)
        else:
            out[name] = (lambda: raster.depth_resolve_xla(setup, h_, w_, init_depth=init),
                         lambda: raster.scan_resolve_split_plain(setup, h_, w_, init))

    scan("scan headline", head, (w, h))
    scan("scan headline stats", head, (w, h), stats=True)
    head3_setup = vertex_stage(head3[0], head3[2], head3[1], w, h)[0]
    scan("scan room after the head", room3, (w, h),
         raster.depth_resolve_xla(head3_setup, h, w)[0])
    scan("scan stress", (sa, ssh, su), (ww, wh))
    scan("scan stress stats", (sa, ssh, su), (ww, wh), stats=True)
    return out


def flat(out) -> list:
    """A wrapper's outputs as one list of tensors (event planes nested as a
    pair are taken apart)."""
    return [t for o in out for t in (o if isinstance(o, (tuple, list)) else (o,))]


def selected(cs, only: str | None):
    """``workloads`` whose name holds ``only`` (all where it is None), and
    the yardstick "#4 headline"."""
    return {k: v for k, v in workloads(cs).items()
            if only is None or only in k or k == "#4 headline"}


def variants(settings: dict[str, list[int]], only: str | None = None) -> None:
    import itertools

    import chip_smoke as cs
    import torch

    from tinyrenderder_tpu_torch import _build
    smi = cs.nvidia_smi()
    print(smi, flush=True)
    t0 = time.perf_counter()
    combos = [dict(zip(settings, vs)) for vs in itertools.product(*settings.values())]
    libs = {variant_name(c): _build.load(_build.build(variant_csrc(_build.CSRC, c)))
            for c in combos}
    builds = list(libs)
    print(f"[build] {len(builds)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)

    def use(n):
        _build._LIB = libs[n]
        _build._CONSTANT_VALUES.clear()

    use(builds[0])
    work = selected(cs, only)
    for name, (kernel, plain) in work.items():
        want = flat(plain())
        for n in builds:
            use(n)
            cs.same_planes(f"{name}, {n}", [str(i) for i in range(len(want))], flat(kernel()),
                           want)
    print(f"[check] every raster of every build == plain bitwise ({', '.join(work)})",
          flush=True)
    ms = {(name, n): [] for name in work for n in builds}
    for order in (builds, builds[::-1]):
        for n in order:
            use(n)
            for name, (kernel, _) in work.items():
                ms[(name, n)].append(cs.event_ms(kernel))
    names = ("item_scan", "walk", "merge", "events", "cull", "prefix")
    for name, (kernel, _) in work.items():
        for n in builds:
            use(n)
            t = sum(ms[(name, n)]) / 2
            yard = sum(ms[("#4 headline", n)]) / 2
            print(json.dumps({"workload": name, "build": n, "ms": t, "turns": ms[(name, n)],
                              "ratio_to_#4_headline": t / yard,
                              "device_ms": {k: round(v, 5) for k, v in
                                            cs.device_ms(kernel, names).items()},
                              "card": smi}), flush=True)
    torch.cuda.synchronize()


def checkout(root: Path):
    """chip_smoke of the checkout at ``root``, its package first on the path."""
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    return cs


def kernels(root: Path, tag: str, only: str | None = None) -> None:
    cs = checkout(root)
    smi = cs.nvidia_smi()
    for name, (kernel, _) in selected(cs, only).items():
        print(json.dumps({"tag": tag, "workload": name, "ms": cs.event_ms(kernel),
                          "card": smi}), flush=True)


def stages(root: Path, tag: str) -> None:
    cs = checkout(root)

    from tinyrenderder_tpu_torch import _build
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    smi = cs.nvidia_smi()
    _build.library()
    dev, w = cs.DEVICE, cs.WIDTH
    head = tscene.pass_tensors(tscene.headline_scene(w, w, "phong"), dev)[0]
    th = rs.pick_tile_h(w, w)
    three = tscene.pass_tensors(tscene.multimesh_scene(w, w), dev)
    stress = tscene.pass_tensors(tscene.stress_scene(cs.WALL_W, cs.WALL_H), dev)
    image_stages = ("pre", "raster", "shade", "placement")
    frame_stages = ("pre", "raster", "merge+shade", "untile")
    runs = {
        "head_phong_2048 coarse": (lambda m: cs.staged_frame(
            head[0], head[1], head[2], w, w, th, "coarse", False, m), image_stages),
        "head_phong_2048 fine": (lambda m: cs.staged_frame(
            head[0], head[1], head[2], w, w, th, "fine", False, m), image_stages),
        "3-pass 2048 coarse": (lambda m: cs.staged_multipass(
            three, w, w, "coarse", False, False, m), frame_stages),
        "stress 1280x800 coarse": (lambda m: cs.staged_multipass(
            stress, cs.WALL_W, cs.WALL_H, "coarse", False, False, m), frame_stages),
        "stress 1280x800 fine2": (lambda m: cs.staged_multipass(
            stress, cs.WALL_W, cs.WALL_H, "fine2", False, False, m), frame_stages)}
    for frame, (run, names) in runs.items():
        st = cs.stage_medians(run, names)
        print(json.dumps({"tag": tag, "frame": frame, "raster_ms": st["raster"],
                          "frame_ms": sum(st.values()), "stages": st, "card": smi}),
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    v = sub.add_parser("variants")
    v.add_argument("--set", action="append", required=True, metavar="NAME=V1,V2")
    v.add_argument("--only")
    for mode in ("kernels", "stages"):
        s = sub.add_parser(mode)
        s.add_argument("--root", type=Path, default=ROOT)
        s.add_argument("--tag", required=True)
        if mode == "kernels":
            s.add_argument("--only")
    args = ap.parse_args()
    if args.mode == "variants":
        sys.path.insert(0, str(ROOT))
        variants({k: [int(x) for x in vs.split(",")]
                  for k, vs in (item.split("=", 1) for item in args.set)}, args.only)
    elif args.mode == "kernels":
        kernels(args.root.resolve(), args.tag, args.only)
    else:
        stages(args.root.resolve(), args.tag)


if __name__ == "__main__":
    main()
