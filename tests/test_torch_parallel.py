"""The port's multi-rank rendering against the JAX package: the band
windows of the three pre-stages (``raster_tiled.Band``), the ``y_stride``
of the coarse and strip rasters, the split vertex stage, the partition
helpers and the per-rank body of ``parallel/dist.py`` stitched over N
ranks, and a process group of two gloo ranks.

JAX side, run as the JAX package's own tests run it on the CPU (Pallas in
interpret mode), in one subprocess for the module on 4 virtual CPU
devices (tests/torch_parity.py says why): ``_tile_spans``,
``_pre_sparse_jit``, ``_pre_fine_jit`` and ``_pre_fine2_jit`` under each
band window at the port's exact totals, the three rasters on those
pre-stages at the band's origin and row stride, and
``render_frame_fused_sharded`` / ``render_frame_fused_image_sharded``
with their untile helpers on 2 or 4 devices.  The port emulates the
ranks in this process (``dist.emulated_mesh``) on the CPU.  The pure
partition helpers are held against the JAX module in this process.
Every comparison is bitwise, with one exception the reference makes: at
256x128 the JAX package's colour leaves its own float32 NumPy oracle by
1 LSB at one pixel of the room pass, on one device and sharded alike
(its 1-LSB colour contract).  There the port's colour must be the
oracle's and within 1 LSB of the JAX package's (``_assert_colour``);
everywhere else it is the JAX package's, bitwise.

Tests marked ``cuda`` compare the CUDA kernels with ``y_stride`` with
their plain versions and skip where no GPU is present."""

import datetime
import os
import tempfile

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_parity import (assert_bits, fine_mode, multimesh_scene, run_jax, scene_pass,
                          sharded_scene, spawn_ranks)
from tinyrenderder_tpu_torch import convert
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.ops import raster_coarse, raster_fine, raster_fine2, raster_sparse
from tinyrenderder_tpu_torch.ops.raster_tiled import Band, band_spans, cdiv, vertex_stage
from tinyrenderder_tpu_torch.parallel import dist

#: band windows of the pre-stage cases, on the 256x128 head (torch_parity.SCENES):
#: name -> (tile_h, Band arguments); the head covers tile rows 1-6 at 16 rows
BANDS = {
    "contiguous": (16, dict(ty_lo=2, nty_band=4)),
    "interleaved_2": (16, dict(ty_lo=1, nty_band=4, ty_stride=2)),
    "interleaved_4": (16, dict(ty_lo=1, nty_band=2, ty_stride=4)),
    "block": (16, dict(ty_lo=4, nty_band=4, tx_lo=1, ntx_band=1)),
    "measured": (16, dict(ty_lo=1, nty_band=4, ty_rows=3)),
    "interleaved_2_th32": (32, dict(ty_lo=1, nty_band=2, ty_stride=2)),
}
#: the bands whose rasters also run on the JAX side (seconds a case there)
KERNEL_BANDS = ("interleaved_2", "interleaved_4", "block", "interleaved_2_th32")
PRE_SCENE = "head_phong"
#: stitched frames: name -> (w, h, ranks, grid columns, interleave, bands);
#: the 3-pass scene with the eyes last (so the output depth is the snapshot
#: before them), its head pass alone for the image route; "measured" holds
#: the balance_bands partition of the scene's measured row costs
FRAME_W, FRAME_H = 256, 128
FRAME_SCENE = "eyes_last"
LAYOUTS = {
    "interleaved_4": (FRAME_W, FRAME_H, 4, 1, True, None),
    "contiguous_2": (FRAME_W, FRAME_H, 2, 1, False, None),
    "even_unequal_4": (FRAME_W, 96, 4, 1, False, dist.even_unequal_bands(6, 4)),
    "measured_4": (FRAME_W, FRAME_H, 4, 1, False, "measured"),
    "grid_2x2": (FRAME_W, FRAME_H, 4, 2, False, None),
}
IMAGE_LAYOUTS = ("interleaved_4", "contiguous_2", "even_unequal_4", "measured_4")
MODES = ("coarse", "fine", "fine2")


def _head():
    p, w, h = scene_pass(PRE_SCENE)
    attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, "cpu")
    return attrs, p.shader, uniforms, w, h


def _depth_tiles(n, th, seed):
    """A running depth over a band's tiles, half of it +inf."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.2, 1.0, size=(n, th, 128)).astype(np.float32)
    d[rng.random(d.shape) < 0.5] = np.inf
    return d


def _frame_passes(w, h):
    return tscene.pass_tensors(sharded_scene(FRAME_SCENE, "port", w, h), "cpu")


def _measured_bands():
    passes = _frame_passes(FRAME_W, FRAME_H)
    return dist.balance_bands(dist.measure_tile_row_costs(passes, FRAME_W, FRAME_H), 4)


def _layout(name):
    w, h, n, n_cols, inter, bands = LAYOUTS[name]
    if bands == "measured":
        bands = _measured_bands()
    return w, h, n, n_cols, inter, bands


@pytest.fixture(scope="module")
def prepared():
    """band name -> (Band, th, PreSparse, PreFine, PreFine2, depth tiles of
    the band, n_vary)."""
    attrs, shader, uniforms, w, h = _head()
    out = {}
    for seed, (name, (th, kw)) in enumerate(BANDS.items()):
        band = Band(**kw)
        ntx, nty = band.grid(w, 128)
        out[name] = (band, th,
                     raster_sparse.pre_sparse(attrs, uniforms, shader, w, h, th, band=band),
                     raster_fine.pre_fine(attrs, uniforms, shader, w, h, th, band=band),
                     raster_fine2.pre_fine2(attrs, uniforms, shader, w, h, th, band=band),
                     _depth_tiles(ntx * nty, th, seed), sum(shader.varying_spec.values()))
    return out


@pytest.fixture(scope="module")
def jax_side(prepared, tmp_path_factory):
    req = {}
    for name, (band, th, ps, pf, pf2, depth_tiles, n_vary) in prepared.items():
        kw = {k: v for k, v in BANDS[name][1].items()}
        base = {"scene": PRE_SCENE, "th": th, **kw}
        kernel = ({"depth_tiles": depth_tiles, "n_vary": n_vary}
                  if name in KERNEL_BANDS else {})
        req[f"{name}_sparse"] = {"op": "pre_sparse", **base, "total": ps.total,
                                 "active": ps.n_active, **kernel}
        req[f"{name}_fine"] = {"op": "pre_fine", **base, "pairs": pf.pairs,
                               "rows": pf.row_total, "active": pf.n_active, **kernel}
        req[f"{name}_fine2"] = {"op": "pre_fine2", **base, "pairs": pf2.pairs,
                                "rows": pf2.row_total, "groups": pf2.n_groups,
                                "active": pf2.n_active, **kernel}
    for w, h in ((FRAME_W, FRAME_H), (160, 96)):
        req[f"costs_{w}x{h}"] = {"op": "row_costs", "scene": "multimesh", "w": w, "h": h,
                                 "th": 16}
    for name in LAYOUTS:
        w, h, n, n_cols, inter, bands = _layout(name)
        layout = {"scene": FRAME_SCENE, "w": w, "h": h, "n": n, "n_cols": n_cols,
                  "interleave": inter}
        if bands is not None:
            layout["bands"] = np.array(bands)
        for mode in MODES:
            req[f"frame_{name}_{mode}"] = {"op": "sharded_frame", "mode": mode, **layout}
            if name in IMAGE_LAYOUTS:
                req[f"image_{name}_{mode}"] = {"op": "sharded_image", "mode": mode, **layout}
    # two subprocesses, the band pre-stages and the sharded frames, so that
    # each stays well inside run_jax's time limit on a loaded machine
    frames = {k: v for k, v in req.items() if k.startswith(("frame_", "image_"))}
    rest = {k: v for k, v in req.items() if k not in frames}
    return {**run_jax(rest, tmp_path_factory.mktemp("jax_parallel"), devices=4),
            **run_jax(frames, tmp_path_factory.mktemp("jax_parallel_frames"), devices=4)}


# ---------------------------------------------------------------------------
# the partition helpers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jdist():
    from tinyrenderder_tpu.parallel import dist as jax_dist
    return jax_dist


@settings(max_examples=60, deadline=None, derandomize=True)
@given(nty=st.integers(1, 40), n=st.integers(1, 8))
def test_even_unequal_bands_match_jax(jdist, nty, n):
    assert dist.even_unequal_bands(nty, n) == jdist.even_unequal_bands(nty, n)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(costs=st.lists(st.integers(0, 500), min_size=1, max_size=40), n=st.integers(1, 8),
       extra=st.one_of(st.none(), st.integers(0, 6)))
def test_balance_bands_match_jax(jdist, costs, n, extra):
    """The DP partition, at the default cap and at a cap ``extra`` rows
    above the even split."""
    cap = None if extra is None else -(-len(costs) // n) + extra
    bands = dist.balance_bands(costs, n, cap)
    assert bands == jdist.balance_bands(costs, n, cap)
    assert sum(r for _, r in bands) == len(costs)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(costs=st.lists(st.integers(0, 500), min_size=1, max_size=40), n=st.integers(1, 8),
       tile_h=st.sampled_from([16, 32]))
def test_band_cap_and_row_map_match_jax(jdist, costs, n, tile_h):
    """``_stable_band_cap``, ``_band_row_map`` and ``_check_bands`` on
    measured and near-even partitions of the same rows."""
    nty = len(costs)
    for bands in (dist.balance_bands(costs, n), dist.even_unequal_bands(nty, n)):
        cap = dist._stable_band_cap(bands, nty, n)
        assert cap == jdist._stable_band_cap(bands, nty, n)
        assert_bits(dist._band_row_map(bands, cap, tile_h, nty * tile_h),
                    jdist._band_row_map(bands, cap, tile_h, nty * tile_h), "row map")
        dist._check_bands(bands, n, nty * tile_h, tile_h)
    bad = ((0, nty + 1),) + ((nty + 1, 0),) * (n - 1)
    for mod in (dist, jdist):
        with pytest.raises(ValueError, match="cover"):
            mod._check_bands(bad, n, nty * tile_h, tile_h)


@pytest.mark.parametrize("size", [(FRAME_W, FRAME_H), (160, 96)])
def test_measure_tile_row_costs_match_jax(jax_side, size):
    """Per-tile-row pair counts of the 3-pass scene, tile-aligned and
    ragged (cdiv rows)."""
    w, h = size
    passes = tscene.pass_tensors(multimesh_scene("port", w, h), "cpu")
    got = dist.measure_tile_row_costs(passes, w, h)
    assert_bits(got, jax_side[f"costs_{w}x{h}"]["costs"].astype(np.int64), "row costs")
    assert got.shape == (cdiv(h, 16),) and got.sum() > 0


# ---------------------------------------------------------------------------
# the pre-stages under band windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(BANDS))
def test_tile_spans_window_matches_jax(prepared, jax_side, name):
    band, th, ps = prepared[name][:3]
    _, _, _, w, h = _head()
    (tx0, ty0, span_x, _, spans), _ = band_spans(ps.setup, 128, th, w, h, band)
    want = jax_side[f"{name}_sparse"]
    for what, got in (("tx0", tx0), ("ty0", ty0), ("span_x", span_x), ("spans", spans)):
        assert_bits(got.numpy(), want[what], what)
    assert int(spans.sum()) == ps.total > 0


@pytest.mark.parametrize("name", list(BANDS))
def test_pre_sparse_band_matches_jax(prepared, jax_side, name):
    """Band-local active tiles, their CSR segments, the bins' triangles and
    the totals."""
    ps = prepared[name][2]
    want = jax_side[f"{name}_sparse"]
    assert ps.n_active > 0
    assert_bits(np.array([ps.total, ps.n_active]), want["totals"], "totals")
    for what in ("ids", "start", "counts", "sorted_tri"):
        assert_bits(getattr(ps, what).numpy(), want[what], what)


@pytest.mark.parametrize("name", list(BANDS))
def test_pre_fine_band_matches_jax(prepared, jax_side, name):
    pf = prepared[name][3]
    want = jax_side[f"{name}_fine"]
    assert_bits(np.array([pf.pairs, pf.row_total, pf.n_active]), want["totals"], "totals")
    assert_bits(pf.ids.numpy(), want["ids"], "ids")
    assert_bits(pf.row_start.numpy(), want["row_start"], "row_start")
    assert_bits(pf.rows.numpy(), want["rows"], "rows")
    assert_bits(pf.tri8.numpy(), want["slots"], "slots")


@pytest.mark.parametrize("name", list(BANDS))
def test_pre_fine2_band_matches_jax(prepared, jax_side, name):
    """The groups, their interleave-aware slot origins and the active-tile
    map (the JAX x0y0 repeats each slot's origin over its 16 lanes)."""
    pf2 = prepared[name][4]
    want = jax_side[f"{name}_fine2"]
    g = pf2.n_groups
    assert_bits(np.array([pf2.pairs, pf2.row_total, g, pf2.n_active]), want["totals"],
                "totals")
    assert_bits(pf2.group_start.numpy(), want["group_start"], "group_start")
    assert_bits(pf2.group_rows.numpy(), want["group_rows"], "group_rows")
    assert_bits(pf2.x0y0.numpy(), want["x0y0"][:, :, ::16].transpose(0, 2, 1), "x0y0")
    assert_bits(pf2.sid_of.numpy(), want["sid_of"], "sid_of")
    assert_bits(pf2.tri8.numpy(), want["slots"], "slots")
    assert_bits(pf2.ids.numpy(), want["ids"], "ids")
    assert_bits(pf2.src.numpy(), want["src"], "src")
    assert_bits(pf2.live.numpy(), want["live"], "live")


# ---------------------------------------------------------------------------
# the rasters at a band's origin and row stride
# ---------------------------------------------------------------------------

def _place(band, th):
    return {"origin": band.origin(th, 128), "y_stride": band.y_stride(th)}


def _check_raster(out, want, stats, what):
    depth, winner, vary = out[:3]
    k = int(stats)
    assert_bits(depth.numpy(), want[f"depth_{k}"], f"{what} depth")
    # the TPU kernels carry ids as exact f32 (< 2^24), -1 = background
    assert_bits(winner.numpy(), want[f"winner_{k}"].astype(np.int32), f"{what} winner")
    assert_bits(vary.numpy(), want[f"vary_{k}"], f"{what} varyings")
    won = winner.numpy() >= 0
    assert won.any() and (~won).any()
    if stats:
        count, max_z = out[3]
        assert_bits(count.numpy(), want["ev"][:, 0].astype(np.int32), f"{what} event count")
        assert_bits(max_z.numpy(), want["ev"][:, 1], f"{what} event max z")


def _coarse_args(c):
    band, th, ps, _, _, depth_tiles, n_vary = c
    init = torch.from_numpy(depth_tiles)[ps.ids.long()].contiguous()
    return (ps.tri_rec, ps.sorted_tri, ps.ids, ps.start, ps.counts, init,
            band.grid(256, 128)[0], th, 128, n_vary)


def _fine_args(c):
    band, th, _, pf, _, depth_tiles, n_vary = c
    init = torch.from_numpy(depth_tiles)[pf.ids.long()].contiguous()
    return (pf.tri_rec, pf.tri8, pf.ids, pf.row_start, pf.rows, init,
            band.grid(256, 128)[0], th, 128, n_vary)


@pytest.mark.parametrize("name", KERNEL_BANDS)
@pytest.mark.parametrize("stats", [False, True])
def test_coarse_raster_y_stride_matches_pallas(prepared, jax_side, name, stats):
    """The plain #1 (#1s with stats) at the band's origin and ``y_stride``
    against ``_pallas_call_sparse_jit(origin, y_stride)`` in interpret
    mode, seeded with a running depth."""
    c = prepared[name]
    out = raster_coarse.coarse_raster(*_coarse_args(c), collect_stats=stats,
                                      **_place(c[0], c[1]))
    _check_raster(out, jax_side[f"{name}_sparse"], stats, "coarse")


@pytest.mark.parametrize("name", KERNEL_BANDS)
@pytest.mark.parametrize("stats", [False, True])
def test_fine_raster_y_stride_matches_pallas(prepared, jax_side, name, stats):
    """The plain #4 (#4s) against ``_fine_call_jit(origin, y_stride)``."""
    c = prepared[name]
    out = raster_fine.fine_raster(*_fine_args(c), collect_stats=stats,
                                  **_place(c[0], c[1]))
    _check_raster(out, jax_side[f"{name}_fine"], stats, "strip")


@pytest.mark.parametrize("name", KERNEL_BANDS)
def test_fine2_raster_band_matches_pallas(prepared, jax_side, name):
    """The plain #5 (pass-local) and #5s (seeded, stats) at the band's
    origin: the row stride is in the slot origins."""
    band, th, _, _, pf2, depth_tiles, n_vary = prepared[name]
    want = jax_side[f"{name}_fine2"]
    args = (pf2.tri_rec, pf2.tri8, pf2.group_start, pf2.group_rows, pf2.x0y0, th)
    origin = band.origin(th, 128)
    d, wn, v = raster_fine2.fine2_raster(*args, n_vary, origin=origin)
    g = pf2.n_groups
    assert_bits(d.numpy(), want["depth_0"][:g], "depth")
    assert_bits(wn.numpy(), want["winner_0"][:g].astype(np.int32), "winner")
    assert_bits(v.numpy(), want["vary_0"][:g, :n_vary], "varyings")
    init = raster_fine2.init_strips(torch.from_numpy(depth_tiles), pf2)
    assert_bits(init.numpy(), want["init"][:g], "init strips")
    de, we, _, (count, max_z) = raster_fine2.fine2_raster(*args, 0, init, origin,
                                                          collect_stats=True)
    assert_bits(de.numpy(), want["depth_1"][:g], "seeded depth")
    assert_bits(we.numpy(), want["winner_1"][:g].astype(np.int32), "seeded winner")
    assert_bits(count.numpy(), want["ev"][:g, 0].astype(np.int32), "event count")
    assert_bits(max_z.numpy(), want["ev"][:g, 1], "event max z")


@pytest.mark.parametrize("name", ["interleaved_2", "interleaved_4"])
def test_y_stride_moves_each_tile_row(prepared, name):
    """An interleaved band's tile row j is drawn at global row ty_lo + j *
    stride: with y_stride left out (tile_h) the rows of every tile row
    past the first would be other pixels, and the outputs differ."""
    c = prepared[name]
    ps = c[2]
    assert int((ps.ids // 2).max()) > 0           # a tile past the band's first row
    strided = raster_coarse.coarse_raster(*_coarse_args(c), **_place(c[0], c[1]))
    flat = raster_coarse.coarse_raster(*_coarse_args(c), origin=c[0].origin(c[1], 128))
    assert not torch.equal(strided[0], flat[0])


# ---------------------------------------------------------------------------
# the split vertex stage
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world", [2, 3, 4, 7])
@pytest.mark.parametrize("scene", ["head_phong", "head_textured", "soup_phong_ragged"])
def test_split_vertex_stage_is_bitwise_the_whole(scene, world):
    """Each rank's slice of the triangles through the vertex stage,
    gathered in rank order (zero padding cut off), equals the unsplit
    stage bitwise, from every rank's point of view."""
    p, w, h = scene_pass(scene)
    attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, "cpu")
    setup, vary = vertex_stage(attrs, uniforms, p.shader, w, h)
    mesh = dist.emulated_mesh(world, device="cpu")
    for rank in (0, world - 1):
        s2, v2 = vertex_stage(attrs, uniforms, p.shader, w, h, dist._geom_split(mesh, rank))
        assert sorted(s2) == sorted(setup) and sorted(v2) == sorted(vary)
        for k in setup:
            assert_bits(s2[k].numpy(), setup[k].numpy(), f"setup {k}")
        for k in vary:
            assert_bits(v2[k].numpy(), vary[k].numpy(), f"varying {k}")


# ---------------------------------------------------------------------------
# the per-rank body stitched over N ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracle_colour():
    """(w, h) -> the float32 NumPy oracle's colour of the 3-pass scene."""
    return {(w, h): tscene.oracle_render(sharded_scene(FRAME_SCENE, "port", w, h)).color
            for w, h in {LAYOUTS[name][:2] for name in LAYOUTS}}


def _unpacked(tiles):
    return np.stack([tiles & 0xFF, (tiles >> 8) & 0xFF, (tiles >> 16) & 0xFF], axis=-1)


def _assert_colour(got, want, oracle, got_tiles, want_tiles):
    """The port's colour is the f32 oracle's, bitwise; the JAX package's
    where that leaves the oracle by no more than 1 LSB, and bitwise
    elsewhere; the packed colour tiles differ from the JAX package's at as
    many pixels, by at most 1 LSB a channel."""
    assert_bits(got, oracle, "colour vs the f32 oracle")
    off = (want != oracle).any(-1)
    assert off.sum() <= 2, f"the JAX colour leaves the oracle at {int(off.sum())} pixels"
    assert_bits(got[~off], want[~off], "colour")
    assert np.abs(got[off].astype(int) - want[off].astype(int)).max(initial=0) <= 1
    bad = got_tiles != want_tiles
    assert bad.sum() == off.sum(), "colour tiles"
    diff = np.abs(_unpacked(got_tiles[bad]) - _unpacked(want_tiles[bad]))
    assert diff.max(initial=0) <= 1


@pytest.fixture(scope="module")
def port_frames():
    out = {}
    for name in LAYOUTS:
        w, h, n, n_cols, inter, bands = _layout(name)
        mesh = dist.emulated_mesh(n // n_cols, n_cols, "cpu")
        passes = _frame_passes(w, h)
        for mode in MODES:
            with fine_mode(mode):
                ft, od, _ = dist.render_frame_fused_sharded(mesh, passes, w, h,
                                                            interleave=inter, bands=bands)
                ranks = [dist.render_rank(mesh, r, passes, w, h, interleave=inter,
                                          bands=bands)[0] for r in range(mesh.size)]
                image = (dist.render_frame_fused_image_sharded(mesh, passes[:1], w, h,
                                                                interleave=inter, bands=bands)
                         if name in IMAGE_LAYOUTS else None)
            fb = dist.tiles_to_buffers_sharded(mesh, ft, w, h, interleave=inter, bands=bands)
            out_depth = dist.untile_one_sharded(mesh, od, w, h, interleave=inter, bands=bands)
            out[name, mode] = (ft, od, ranks, fb, out_depth, image)
    return out


@pytest.mark.parametrize("name", list(LAYOUTS))
@pytest.mark.parametrize("mode", MODES)
def test_sharded_frame_matches_jax(port_frames, jax_side, oracle_colour, name, mode):
    """The rank-ordered tile planes and output depth tiles (each rank's
    ``render_rank`` its slice of them), then the untiled buffers and output
    depth, against the JAX package's sharded frame on as many devices."""
    ft, od, ranks, fb, out_depth, _ = port_frames[name, mode]
    want = jax_side[f"frame_{name}_{mode}"]
    for plane in ("depth", "winner"):
        assert_bits(getattr(ft, plane).numpy(), want[f"{plane}_t"], f"{plane} tiles")
        assert_bits(getattr(fb, plane).numpy(), want[plane], plane)
    _assert_colour(fb.color.numpy(), want["color"], oracle_colour[LAYOUTS[name][:2]],
                   ft.color.numpy(), want["color_t"])
    assert_bits(od.numpy(), want["out_depth_t"], "output depth tiles")
    assert_bits(out_depth.numpy(), want["out_depth"], "output depth")
    per = ft.color.shape[0] // len(ranks)
    for r, band_ft in enumerate(ranks):
        for plane in ("color", "depth", "winner"):
            assert_bits(getattr(band_ft, plane).numpy(),
                        getattr(ft, plane)[r * per:(r + 1) * per].numpy(),
                        f"rank {r} {plane} tiles")
    assert (fb.winner.numpy() >= 0).sum() > 1000
    assert (out_depth.numpy() != fb.depth.numpy()).sum() > 0     # the eyes left it


@pytest.mark.parametrize("name", IMAGE_LAYOUTS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_image_matches_jax(port_frames, jax_side, name, mode):
    image = port_frames[name, mode][5]
    want = jax_side[f"image_{name}_{mode}"]["image"]
    assert_bits(image.numpy(), want, "image")
    assert (want.sum(-1) > 0).sum() > 1000


def test_sharded_frame_equals_the_one_rank_frame(port_frames):
    """Every layout and raster gives the tiled route's frame."""
    for (name, mode), (_, _, _, fb, _, _) in port_frames.items():
        w, h = LAYOUTS[name][:2]
        with fine_mode(mode):
            ft, od, _ = raster_sparse.render_frame_fused(_frame_passes(w, h), w, h, "cpu")
        want = raster_sparse.tiles_to_buffers(ft, w, h)
        for plane in ("color", "depth", "winner"):
            assert_bits(getattr(fb, plane).numpy(), getattr(want, plane).numpy(),
                        f"{name} {mode} {plane}")
        if name == "grid_2x2":        # the blocks' tiles in the one rank's order
            got = port_frames[name, mode][0]
            for plane in ("color", "depth", "winner"):
                assert_bits(dist.blocks_to_flat_tiles(getattr(got, plane), w, h, 2, 2, 16,
                                                      128).numpy(),
                            getattr(ft, plane).numpy(), f"{name} {mode} {plane} tiles")
        assert_bits(port_frames[name, mode][4].numpy(),
                    raster_sparse.untile_image(od, None, 2, cdiv(h, 16), 16, 128, h,
                                               w).numpy(), f"{name} {mode} output depth")


def test_layouts_refuse_what_they_cannot_render():
    """Interleave on a grid, bands beside interleave (also in the untile
    helpers), a partition that is not one and rows that do not divide."""
    grid = dist.emulated_mesh(2, 2, "cpu")
    rows = dist.emulated_mesh(4, 1, "cpu")
    passes = _frame_passes(FRAME_W, FRAME_H)
    with pytest.raises(ValueError, match="1-D"):
        dist.render_frame_fused_sharded(grid, passes, FRAME_W, FRAME_H, interleave=True)
    bands = dist.even_unequal_bands(8, 4)
    ft, _, _ = dist.render_frame_fused_sharded(rows, passes, FRAME_W, FRAME_H, bands=bands)
    for fn in (dist.tiles_to_buffers_sharded, dist.untile_one_sharded):
        with pytest.raises(ValueError, match="interleave"):
            fn(rows, ft if fn is dist.tiles_to_buffers_sharded else ft.depth, FRAME_W,
               FRAME_H, interleave=True, bands=bands)
    with pytest.raises(ValueError, match="contiguously"):
        dist.render_frame_fused_sharded(rows, passes, FRAME_W, FRAME_H,
                                        bands=((0, 2), (3, 2), (5, 2), (7, 1)))
    with pytest.raises(ValueError, match="divide"):
        dist.render_frame_fused_sharded(dist.emulated_mesh(3, 1, "cpu"), passes, FRAME_W,
                                        FRAME_H)
    with pytest.raises(ValueError, match="1-D"):
        dist.render_frame_fused_image_sharded(grid, passes[:1], FRAME_W, FRAME_H)


def test_mesh_without_a_process_group():
    """One rank, as the JAX package's one-device mesh; more is refused,
    and a rank renders on its card unless the CPU is asked for."""
    mesh = dist.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device.type, mesh.two_d) == (1, 0, "cpu", False)
    assert dist.make_mesh_grid(1, 1, device="cpu").two_d
    with pytest.raises(ValueError, match="requested 2 ranks"):
        dist.make_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            dist.make_mesh()


# ---------------------------------------------------------------------------
# a process group of two gloo ranks
# ---------------------------------------------------------------------------

def _gloo_rank(rank, world, init, out_dir):
    """One rank of ``test_two_gloo_ranks_render_the_one_rank_frame``."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, world_size=world,
                                         rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        scene = sharded_scene("multimesh", "port", FRAME_W, FRAME_H)
        res = scene.render("cpu", backend="sharded")
        head = sharded_scene("head", "port", FRAME_W, FRAME_H)
        image = head.render_image("cpu", backend="sharded")
        planes = {k: getattr(res, k).numpy() for k in ("color", "depth", "full_depth")}
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), image=image.numpy(),
                 stats=np.array([res.stats.fragments_drawn, res.stats.min_z,
                                 res.stats.max_z, res.stats.triangles_rasterized]),
                 mesh=np.array([dist.make_mesh(device="cpu").size]), **planes)
    finally:
        torch.distributed.destroy_process_group()


def test_two_gloo_ranks_render_the_one_rank_frame(tmp_path):
    """``torch.multiprocessing.spawn`` of two gloo ranks (a ``file://``
    rendezvous): each renders its interleaved band of the 3-pass frame and
    of the one-pass image, the split vertex stage and the tiles travel by
    ``all_gather``, and both ranks hold the one-rank frame, stats and
    image."""
    init = "file://" + os.path.join(tempfile.mkdtemp(dir=tmp_path), "rendezvous")
    spawn_ranks(_gloo_rank, (2, init, str(tmp_path)), 2)
    want = sharded_scene("multimesh", "port", FRAME_W, FRAME_H).render("cpu")
    want_image = sharded_scene("head", "port", FRAME_W, FRAME_H).render_image("cpu")
    for rank in range(2):
        with np.load(tmp_path / f"rank{rank}.npz") as got:
            assert int(got["mesh"][0]) == 2
            for plane in ("color", "depth", "full_depth"):
                assert_bits(got[plane], getattr(want, plane).numpy(), f"rank {rank} {plane}")
            assert_bits(got["image"], want_image.numpy(), f"rank {rank} image")
            s = want.stats
            assert_bits(got["stats"], np.array([s.fragments_drawn, s.min_z, s.max_z,
                                                s.triangles_rasterized]), "stats")


# ---------------------------------------------------------------------------
# the CUDA kernels with y_stride
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_BANDS)
@pytest.mark.parametrize("stats", [False, True])
def test_cuda_rasters_with_y_stride_match_plain(prepared, cuda_device, name, stats):
    """#1/#1s and #4/#4s at an interleaved band's origin and row stride:
    bitwise their plain versions."""
    c = prepared[name]
    for fn, args in ((raster_coarse.coarse_raster, _coarse_args(c)),
                     (raster_fine.fine_raster, _fine_args(c))):
        want = fn(*args, collect_stats=stats, **_place(c[0], c[1]))
        got = fn(*(a.to(cuda_device) if torch.is_tensor(a) else a for a in args),
                 collect_stats=stats, **_place(c[0], c[1]))
        torch.cuda.synchronize()
        flat = lambda out: (*out[:3], *(out[3] if stats else ()))  # noqa: E731
        for i, (g, w) in enumerate(zip(flat(got), flat(want))):
            assert_bits(g.cpu().numpy(), w.numpy(), f"{fn.__name__} plane {i}")
