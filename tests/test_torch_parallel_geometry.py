"""The port's triangle-sharded backend ("sharded-geometry") against the JAX
package's: each pass's faces split over the ranks, each rank's coarse
raster over the whole frame, the min/min/sum tile merge, and the entry
points that route to it.

JAX side: ``dist.render_frame_geometry_tiles`` (Pallas in interpret mode),
``Scene.render`` / ``render_image(backend="sharded-geometry")`` (its XLA
scan where the frame is not tile-aligned) and ``render_with_shadows`` on
up to 4 virtual CPU devices, and ``render_frame_fused`` of a moving
camera's near view, in one subprocess for the module
(tests/torch_parity.py says why).  The port emulates the ranks in this
process on the CPU (``dist.emulated_mesh``); two tests spawn two gloo
ranks.  Every comparison is bitwise, with ``torch_parity.assert_colour``'s
one exception (the JAX package's colour may leave its own f32 oracle by 1
LSB; the port's is the oracle's).  The test marked ``cuda`` holds the
card's frame to the CPU's and skips where no GPU is present."""

import datetime
import os
import socket
import tempfile

import numpy as np
import pytest
import torch

from torch_parity import (SHADOW_KEY, assert_bits, assert_colour, blocker_scene, cli_rank,
                          cut_passes, launches, reset_launches, run_jax, sharded_scene,
                          spawn_ranks, stats_vector, view_pass)
from tinyrenderder_tpu_torch import cli, convert, math3d, oracle, shadows
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.ops import raster_coarse, raster_sparse
from tinyrenderder_tpu_torch.ops.raster_tiled import cdiv
from tinyrenderder_tpu_torch.parallel import dist
from tinyrenderder_tpu_torch.utils.stats import RenderStats

BACKEND = "sharded-geometry"
W, H = 256, 128
#: frame cases: name -> (sharded_scene kind, per-pass face cuts or None,
#: rank counts).  multimesh: the eyes excluded in the middle; eyes_last:
#: the frame ends inside the excluded run; depth_head: a depth-only pass
#: (the head) before a colour pass; uneven: 349, 79 and 11 faces, which
#: no rank count divides; three_faces: a 3-face room on 4 ranks (the last
#: rank's block is empty); empty_eyes: a pass with no faces
FRAMES = {
    "multimesh": ("multimesh", None, (2, 3, 4)),
    "head": ("head", None, (2, 3, 4)),
    "eyes_last": ("eyes_last", None, (2, 3, 4)),
    "depth_head": ("depth_head", None, (2, 3, 4)),
    "uneven": ("multimesh", (349, 79, 11), (2, 3, 4)),
    "three_faces": ("multimesh", (-1, -1, 3), (4,)),
    "empty_eyes": ("multimesh", (-1, 0, -1), (4,)),
}
FRAME_CASES = [(name, n) for name, (_, _, ns) in FRAMES.items() for n in ns]
RANKS = 4
#: scene cases of the entry points: name -> (sharded_scene kind, w, h);
#: "ragged" is not tile-aligned (the JAX package takes its XLA scan)
SCENES = {"multimesh": ("multimesh", W, H), "head": ("head", W, H),
          "ragged": ("multimesh", 160, 96), "culled": ("culled", 128, 128)}
SHADOW_W, SHADOW_H, SHADOW_SIZE = 128, 64, 128
#: the moving camera of tests/test_parallel.py: far, then near
MOTION_W = MOTION_H = 128
FAR_Z, NEAR_Z = 14.0, 1.6


def _mesh(n=RANKS):
    return dist.emulated_mesh(n, device="cpu")


def _passes(name, device="cpu"):
    kind, cut, _ = FRAMES[name]
    passes = tscene.pass_tensors(sharded_scene(kind, "port", W, H), device)
    return passes if cut is None else cut_passes(passes, cut)


def _view_passes(eye_z):
    p = view_pass(eye_z, MOTION_W, MOTION_H, "port")
    attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, "cpu")
    return [(attrs, p.shader, uniforms, False)]


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    req = {}
    for name, n in FRAME_CASES:
        kind, cut, _ = FRAMES[name]
        req[f"frame_{name}_{n}"] = {"op": "geometry_frame", "scene": kind, "w": W, "h": H,
                                    "n": n, **({} if cut is None else {"cut": np.array(cut)})}
    for name, (kind, w, h) in SCENES.items():
        req[f"scene_{name}"] = {"op": "sharded_scene", "scene": kind, "w": w, "h": h,
                                "backend": BACKEND}
    req["shadows"] = {"op": "shadows", "w": SHADOW_W, "h": SHADOW_H, "size": SHADOW_SIZE,
                      "mode": "coarse", "backend": BACKEND}
    req["near"] = {"op": "view_frame", "w": MOTION_W, "h": MOTION_H, "eye_z": NEAR_Z}
    return run_jax(req, tmp_path_factory.mktemp("jax_parallel_geometry"), devices=RANKS)


def _oracle_colour(name):
    """The f32 NumPy oracle's colour of a frame case: its scene's passes
    (all visible at W x H), each cut as the case cuts it, through
    ``oracle.render_pass`` with the snapshot and restore around the
    excluded pass (main.cpp:700,730)."""
    kind, cut, _ = FRAMES[name]
    scene = sharded_scene(kind, "port", W, H)
    frame = oracle.OracleFrame(color=np.zeros((H, W, 3), np.uint8),
                               zbuffer=np.full((H, W), np.inf, np.float32), stats=RenderStats())
    snapshot = None
    for p, n in zip(scene.passes, cut or (-1,) * len(scene.passes)):
        attrs, uniforms = tscene._pass_inputs(scene, p, np.float32)
        if p.exclude_from_output_depth and snapshot is None:
            snapshot = frame.zbuffer.copy()
        elif not p.exclude_from_output_depth and snapshot is not None:
            frame.zbuffer, snapshot = snapshot, None
        attrs = {k: v if n < 0 else v[:n] for k, v in attrs.items()}
        oracle.render_pass(frame, oracle.OraclePass(attrs, p.shader, uniforms), W, H,
                           dtype=np.float32)
    return frame.color


@pytest.fixture(scope="module")
def oracle_colour():
    return {name: _oracle_colour(name) for name in FRAMES}


@pytest.fixture(scope="module")
def port_frames():
    """(name, n) -> (FrameTiles, output depth tiles, FrameBuffers, output
    depth (H, W)) of the port's geometry frame on n emulated ranks."""
    out = {}
    for name, n in FRAME_CASES:
        ft, od = dist.render_frame_geometry_tiles(_mesh(n), _passes(name), W, H)
        fb = raster_sparse.tiles_to_buffers(ft, W, H)
        out[name, n] = (ft, od, fb, raster_sparse.untile_image(od, None, cdiv(W, 128),
                                                               cdiv(H, 16), 16, 128, H, W))
    return out


# ---------------------------------------------------------------------------
# the frame's tiles and buffers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,n", FRAME_CASES)
def test_geometry_frame_matches_jax(port_frames, jax_side, oracle_colour, name, n):
    """Tile planes, output depth tiles, the untiled buffers and the output
    depth against the JAX package's ``render_frame_geometry_tiles`` on as
    many devices."""
    ft, od, fb, out_depth = port_frames[name, n]
    want = jax_side[f"frame_{name}_{n}"]
    for plane in ("depth", "winner"):
        assert_bits(getattr(ft, plane).numpy(), want[f"{plane}_t"], f"{plane} tiles")
        assert_bits(getattr(fb, plane).numpy(), want[plane], plane)
    assert_colour(fb.color.numpy(), want["color"], oracle_colour[name], "colour")
    jax_off = (want["color"] != oracle_colour[name]).any(-1)
    colour_off = (ft.color.numpy() != want["color_t"]).sum()
    assert colour_off == jax_off.sum(), "the colour tiles differ where the buffers agree"
    assert_bits(od.numpy(), want["out_depth_t"], "output depth tiles")
    assert_bits(out_depth.numpy(), want["out_depth"], "output depth")
    assert (fb.winner.numpy() >= 0).sum() > 1000


@pytest.mark.parametrize("name,n", FRAME_CASES)
def test_geometry_frame_equals_the_one_rank_frame(port_frames, name, n):
    """Every split gives ``render_frame_fused``'s tiles and output depth
    tiles, bitwise: the merge is exact."""
    ft, od, _, _ = port_frames[name, n]
    want, want_od, _ = raster_sparse.render_frame_fused(_passes(name), W, H, "cpu")
    for plane in ("color", "depth", "winner"):
        assert_bits(getattr(ft, plane).numpy(), getattr(want, plane).numpy(), plane)
    assert_bits(od.numpy(), want_od.numpy(), "output depth tiles")


def test_face_blocks_cover_the_faces_in_order():
    """Contiguous blocks of ceil(max(F, 1) / N) faces in rank order, the
    last short or empty: the JAX package's padded blocks, cut."""
    for f in (0, 1, 3, 11, 349, 352):
        for n in (1, 2, 3, 4, 7):
            blocks = [dist.face_block(f, n, r) for r in range(n)]
            size = -(-max(f, 1) // n)
            assert blocks[0][0] == 0 and blocks[-1][1] == f
            for r, (lo, hi) in enumerate(blocks):
                assert lo == min(r * size, f) and hi == min(lo + size, f)


def test_empty_blocks_launch_nothing(monkeypatch):
    """A rank whose block is empty (3 faces on 4 ranks) contributes the
    background planes and never reaches the raster; a pass with no faces
    reaches nothing."""
    calls = []
    real = raster_coarse.coarse_raster

    def spy(*args, **kw):
        calls.append(args[0].shape[0])
        return real(*args, **kw)

    monkeypatch.setattr(dist, "coarse_raster", spy)
    attrs, shader, uniforms, _ = _passes("three_faces")[2]
    mesh = _mesh(4)
    ft, lo = dist.geometry_rank(mesh, 3, attrs, shader, uniforms, W, H)
    assert lo == 3 and not calls
    want = raster_sparse.new_frame_tiles(W, H, "cpu")
    for plane in ("color", "depth", "winner"):
        assert_bits(getattr(ft, plane).numpy(), getattr(want, plane).numpy(), plane)
    dist.render_pass_geometry_tiles(mesh, want, attrs, shader, uniforms, W, H)
    assert calls == [1, 1, 1]
    empty = {k: v[:0] for k, v in attrs.items()}
    assert dist.render_pass_geometry_tiles(mesh, want, empty, shader, uniforms, W, H) is want
    assert len(calls) == 3


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def oracles():
    out = {name: tscene.oracle_render(sharded_scene(kind, "port", w, h))
           for name, (kind, w, h) in SCENES.items()}
    out["shadows"] = shadows.oracle_render_with_shadows(
        blocker_scene("port", SHADOW_W, SHADOW_H), math3d.normalized(math3d.vec3(*SHADOW_KEY)),
        shadows.ShadowSettings(size=SHADOW_SIZE))
    return out


def _check_frame(got, want, oracle, what):
    assert_colour(got.color.numpy(), want["color"], oracle.color, f"{what} colour")
    for plane in ("depth", "full_depth"):
        assert_bits(getattr(got, plane).numpy(), want[plane], f"{what} {plane}")
    assert_bits(stats_vector(got.stats), want["stats"], f"{what} stats")
    assert got.stats == oracle.stats


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_render_matches_jax(jax_side, oracles, name):
    """``Scene.render(backend="sharded-geometry")`` with exact stats (the
    one-rank stats replay) and without: colour, output depth, full depth
    and ``RenderStats``."""
    kind, w, h = SCENES[name]
    scene = sharded_scene(kind, "port", w, h)
    got = scene.render("cpu", backend=BACKEND, mesh=_mesh())
    _check_frame(got, jax_side[f"scene_{name}"], oracles[name], name)
    plain = scene.render("cpu", collect_stats=False, backend=BACKEND, mesh=_mesh())
    for plane in ("color", "depth", "full_depth"):
        assert torch.equal(getattr(plain, plane), getattr(got, plane)), plane
    if name == "culled":
        assert got.color.sum() == 0 and not torch.isfinite(got.full_depth).any()
    else:
        assert torch.isfinite(got.full_depth).sum() > 1000


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_render_image_matches_jax(jax_side, oracles, name):
    kind, w, h = SCENES[name]
    got = sharded_scene(kind, "port", w, h).render_image("cpu", backend=BACKEND, mesh=_mesh())
    assert_colour(got.numpy(), jax_side[f"scene_{name}"]["image"], oracles[name].color,
                  f"{name} image")


def test_render_with_shadows_matches_jax(jax_side, oracles):
    """The light pass (depth only) and the lit frame, each with its faces
    split over the ranks."""
    want = jax_side["shadows"]
    ref, ref_map = oracles["shadows"]
    res, smap = shadows.render_with_shadows(
        blocker_scene("port", SHADOW_W, SHADOW_H), math3d.normalized(math3d.vec3(*SHADOW_KEY)),
        shadows.ShadowSettings(size=SHADOW_SIZE), "cpu", backend=BACKEND, mesh=_mesh())
    assert_bits(smap.numpy(), want["map"], "shadow map")
    assert_bits(smap.numpy(), ref_map, "shadow map vs the f32 oracle")
    _check_frame(res, want, ref, "shadowed")


def test_near_view_after_a_far_view_is_exact_at_once(jax_side):
    """The port sizes every buffer from each pass's readback, so the first
    near frame after a far one is already the JAX package's single-device
    frame (where its geometry path grows its capacities a frame late)."""
    mesh = _mesh()
    for eye_z in (FAR_Z, NEAR_Z):
        ft, _ = dist.render_frame_geometry_tiles(mesh, _view_passes(eye_z), MOTION_W, MOTION_H)
    fb = raster_sparse.tiles_to_buffers(ft, MOTION_W, MOTION_H)
    want = jax_side["near"]
    for plane in ("color", "depth", "winner"):
        assert_bits(getattr(fb, plane).numpy(), want[plane], plane)
    assert (fb.winner.numpy() >= 0).sum() > MOTION_W * MOTION_H // 2


def test_geometry_renders_on_the_card_unless_asked():
    scene = sharded_scene("head", "port", 128, 64)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="GPU"):
            scene.render(backend=BACKEND)
    got = scene.render_image("cpu", backend=BACKEND)
    assert got.device.type == "cpu"
    assert torch.equal(got, scene.render_image("cpu"))


# ---------------------------------------------------------------------------
# a process group of two gloo ranks
# ---------------------------------------------------------------------------

def _gloo_rank(rank, world, init, out_dir):
    """One rank of ``test_two_gloo_ranks_render_the_emulated_frame``."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, world_size=world,
                                         rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        mesh = dist.make_mesh(device="cpu")
        ft, od = dist.render_frame_geometry_tiles(mesh, _passes("uneven"), W, H)
        res = sharded_scene("multimesh", "port", W, H).render("cpu", backend=BACKEND)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), mesh=np.array([mesh.size]),
                 od=od.numpy(), stats=stats_vector(res.stats),
                 **{f"{k}_t": v.numpy() for k, v in ft._asdict().items()},
                 **{k: getattr(res, k).numpy() for k in ("color", "depth", "full_depth")})
    finally:
        torch.distributed.destroy_process_group()


def test_two_gloo_ranks_render_the_emulated_frame(tmp_path):
    """``torch.multiprocessing.spawn`` of two gloo ranks: each rasterizes
    its block of every pass, the merge travels by ``all_reduce``, and both
    ranks hold the frame two emulated ranks render (tiles, output depth),
    and ``Scene.render``'s frame and stats."""
    init = "file://" + os.path.join(tempfile.mkdtemp(dir=tmp_path), "rendezvous")
    spawn_ranks(_gloo_rank, (2, init, str(tmp_path)), 2)
    want_ft, want_od = dist.render_frame_geometry_tiles(_mesh(2), _passes("uneven"), W, H)
    want = sharded_scene("multimesh", "port", W, H).render("cpu", backend=BACKEND,
                                                          mesh=_mesh(2))
    for rank in range(2):
        with np.load(tmp_path / f"rank{rank}.npz") as got:
            assert int(got["mesh"][0]) == 2
            for k, v in want_ft._asdict().items():
                assert_bits(got[f"{k}_t"], v.numpy(), f"rank {rank} {k} tiles")
            assert_bits(got["od"], want_od.numpy(), f"rank {rank} output depth tiles")
            for k in ("color", "depth", "full_depth"):
                assert_bits(got[k], getattr(want, k).numpy(), f"rank {rank} {k}")
            assert_bits(got["stats"], stats_vector(want.stats), f"rank {rank} stats")


def test_cli_geometry_under_two_gloo_ranks(tmp_path):
    """The CLI with ``--backend sharded-geometry`` under two gloo ranks:
    rank 0 writes the tiled backend's four files, byte for byte."""
    args = ["--device", "cpu", "--width", "128", "--height", "96"]
    assert cli.run(args + ["--outdir", str(tmp_path / "tiled")]) == 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    spawn_ranks(cli_rank, (2, port, args + ["--backend", BACKEND, "--outdir",
                                            str(tmp_path / "geometry")]), 2)
    for name in ("phong", "zbuffer", "ao", "final"):
        assert (tmp_path / "geometry" / f"{name}.tga").read_bytes() == \
            (tmp_path / "tiled" / f"{name}.tga").read_bytes(), name


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_geometry_frame_matches_fused_and_cpu():
    """4 emulated ranks on the card (the coarse kernel on each block):
    the card's one-rank fused frame and the CPU frame, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cpu_ft, cpu_od = dist.render_frame_geometry_tiles(_mesh(), _passes("uneven"), W, H)
    passes = _passes("uneven", dev)
    reset_launches()
    ft, od = dist.render_frame_geometry_tiles(dist.emulated_mesh(RANKS, device=dev), passes,
                                              W, H)
    torch.cuda.synchronize()
    assert launches("coarse_raster") > 0
    fused, fused_od, _ = raster_sparse.render_frame_fused(passes, W, H, dev)
    for plane in ("color", "depth", "winner"):
        got = getattr(ft, plane).cpu().numpy()
        assert_bits(got, getattr(fused, plane).cpu().numpy(), f"{plane} vs fused")
        assert_bits(got, getattr(cpu_ft, plane).numpy(), f"{plane} vs the CPU")
    assert_bits(od.cpu().numpy(), fused_od.cpu().numpy(), "output depth vs fused")
    assert_bits(od.cpu().numpy(), cpu_od.numpy(), "output depth vs the CPU")
