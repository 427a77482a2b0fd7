"""The port's multi-pass tiled frame (``scene.render_scene``) end to end.

Two pass orders at a ragged 160x96 (tests/torch_parity.py ``FRAMES``):
the CLI's default scene (eyes excluded from the output depth, LAST: the
output depth is the snapshot) and the bench's 3-mesh scene (eyes
excluded in the MIDDLE: depth is restored before the room pass).

(a) against the float32 NumPy oracle (``scene.render(backend="oracle")``):
    colour, output depth, full depth and every ``RenderStats`` field,
    bitwise;
(b) against the JAX package's ``scene.render(backend="tiled")`` with and
    without stats, and the winner plane of its ``render_frame_fused`` +
    ``tiles_to_buffers`` (coarse mode, Pallas in interpret mode, one
    subprocess for the module): bitwise;
plus the image route on multi-pass scenes, the tile height, empty,
depth-only and unknown-shader frames, and (``cuda``) the GPU frame
against the CPU frame.
The port side runs on the port's own scenes and shaders (``frame_scene``
builds them), the JAX side on the JAX package's."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from torch_parity import (FRAMES, assert_bits, frame_scene, launches, reset_launches,
                          run_jax, scene_pass, stats_vector)
from tinyrenderder_tpu_torch import convert, shaders
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.ops import raster, raster_sparse

PLANES = ("color", "depth", "full_depth")


class UnknownShader(shaders.Shader):
    """A colour shader class the port has no device half for."""
    name = "unknown"


def _np(result):
    return {k: getattr(result, k).cpu().numpy() for k in PLANES}


@pytest.fixture(scope="module")
def port_frames():
    """name -> (stats frame planes, RenderStats, frame planes without stats)."""
    out = {}
    for name in FRAMES:
        r = tscene.render_scene(frame_scene(name), "cpu")
        r0 = tscene.render_scene(frame_scene(name), "cpu", collect_stats=False)
        out[name] = (_np(r), r.stats, _np(r0))
    return out


@pytest.fixture(scope="module")
def oracle_frames():
    return {name: tscene.oracle_render(frame_scene(name)) for name in FRAMES}


@pytest.fixture(scope="module")
def jax_frames(tmp_path_factory):
    req = {name: {"op": "scene", "scene": name} for name in FRAMES}
    return run_jax(req, tmp_path_factory.mktemp("jax_frame"))


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_f32_oracle(port_frames, oracle_frames, name):
    got, stats, _ = port_frames[name]
    want = oracle_frames[name]
    for k in PLANES:
        assert_bits(got[k], getattr(want, k), k)
    assert stats == want.stats
    assert stats.fragments_exact and stats.fragments_drawn > 0
    assert np.isfinite(got["full_depth"]).sum() > 1000


def test_excluded_pass_order_shapes_the_output_depth(port_frames):
    """Eyes last: the output depth drops them; eyes in the middle: the
    room renders on the restored depth, so both depths agree."""
    last, _, _ = port_frames["cli_default"]
    assert (last["depth"] != last["full_depth"]).sum() > 0
    middle, _, _ = port_frames["multimesh"]
    assert_bits(middle["depth"], middle["full_depth"], "depth")


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_without_stats_is_the_same_frame(port_frames, name):
    got, _, got0 = port_frames[name]
    for k in PLANES:
        assert_bits(got0[k], got[k], k)


@pytest.mark.parametrize("name", list(FRAMES))
@pytest.mark.parametrize("stats", [True, False])
def test_frame_matches_jax_tiled_route(port_frames, jax_frames, name, stats):
    got = port_frames[name][0 if stats else 2]
    want = jax_frames[name]
    for k in PLANES:
        assert_bits(got[k], want[f"{k}_{int(stats)}"], k)
    if stats:
        assert_bits(stats_vector(port_frames[name][1]), want["stats_1"], "stats")


@pytest.mark.parametrize("name", list(FRAMES))
def test_winner_plane_matches_jax(jax_frames, name):
    """winner_offset: each pass's winners are frame-global triangle ids."""
    w, h = FRAMES[name]
    ft, _, _ = raster_sparse.render_frame_fused(
        tscene.pass_tensors(frame_scene(name), "cpu"), w, h, "cpu")
    winner = raster_sparse.tiles_to_buffers(ft, w, h).winner.numpy()
    assert_bits(winner, jax_frames[name]["winner"], "winner")
    assert winner.max() >= frame_scene(name).passes[0].mesh.nfaces   # a later pass won


@pytest.mark.parametrize("name", list(FRAMES))
def test_image_route_of_a_multipass_scene_is_the_frame_colour(port_frames, name):
    image = tscene.render_scene_image(frame_scene(name), "cpu")
    assert_bits(image.numpy(), port_frames[name][0]["color"], "image")


@pytest.mark.parametrize("name", list(FRAMES))
def test_tile_height_does_not_change_the_frame(port_frames, monkeypatch, name):
    monkeypatch.setattr(raster_sparse, "TILE_H_LARGE_PIXELS", 1)
    r = tscene.render_scene(frame_scene(name), "cpu")
    got, stats, _ = port_frames[name]
    for k in PLANES:
        assert_bits(_np(r)[k], got[k], k)
    assert r.stats == stats


def test_pass_stats_match_the_oracle_counters():
    p, w, h = scene_pass("soup_phong_ragged")
    attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, "cpu")
    pre = raster_sparse.pre_sparse(attrs, uniforms, p.shader, w, h)
    agg = raster.pass_stats(pre.setup)
    valid = pre.setup["valid"].numpy()
    bbox = pre.setup["bbox"].numpy()[valid]
    assert 0 < valid.sum() < valid.size
    assert agg == dict(min_x=bbox[:, 0].min(), max_x=bbox[:, 1].max(),
                       min_y=bbox[:, 2].min(), max_y=bbox[:, 3].max(),
                       triangles=valid.size, valid_triangles=valid.sum())
    none = {k: v[:0] for k, v in pre.setup.items()}
    assert raster.pass_stats(none) == dict(min_x=2**31 - 1, max_x=-2**31,
                                           min_y=2**31 - 1, max_y=-2**31,
                                           triangles=0, valid_triangles=0)


def test_empty_and_culled_frames_are_background():
    sc = frame_scene("multimesh")
    for p in sc.passes:
        behind = np.eye(4)
        behind[2, 3] = 100.0                       # behind the camera: culled
        p.model_matrix = behind
    r = tscene.render_scene(sc, "cpu")
    want = tscene.oracle_render(sc)
    for k in PLANES:
        assert_bits(getattr(r, k).numpy(), getattr(want, k), k)
    assert r.stats == want.stats and r.stats.models_culled == 3
    assert not r.color.any()
    assert_bits(tscene.render_scene_image(sc, "cpu").numpy(), want.color, "image")


def test_empty_and_rejected_passes_render_nothing():
    """A 0-face pass is skipped and a pass whose triangles are all
    rejected (zero area) has no active tile; the frame equals the oracle's."""
    sc = frame_scene("multimesh")
    head, eyes, _room = sc.passes
    head.mesh = dataclasses.replace(head.mesh)
    head.mesh.positions = np.zeros_like(head.mesh.positions)   # zero area
    eyes.mesh = dataclasses.replace(eyes.mesh, faces=eyes.mesh.faces[:0])
    r = tscene.render_scene(sc, "cpu")
    want = tscene.oracle_render(sc)
    for k in PLANES:
        assert_bits(getattr(r, k).numpy(), getattr(want, k), k)
    assert r.stats == want.stats


def test_unported_shaders_raise(monkeypatch):
    """A shader class the port does not know raises.  Depth-only passes
    (``DepthShader``) render: a frame of them only is black with the
    passes' depth, and a depth-only room keeps the colour of the passes
    before it; both equal the oracle on each raster."""
    sc = frame_scene("multimesh")
    sc.passes[2].shader = UnknownShader()
    with pytest.raises(NotImplementedError, match="UnknownShader"):
        tscene.render_scene(sc, "cpu")
    for mode, depth_only in itertools.product(("coarse", "fine", "fine2"), ([2], [0, 1, 2])):
        monkeypatch.setattr(raster_sparse, "FINE_MODE", mode)
        sc = frame_scene("multimesh")
        for i in depth_only:
            sc.passes[i].shader = shaders.DepthShader()
        r = tscene.render_scene(sc, "cpu")
        want = tscene.oracle_render(sc)
        for k in PLANES:
            assert_bits(getattr(r, k).numpy(), getattr(want, k), k)
        assert r.stats == want.stats
        assert_bits(tscene.render_scene_image(sc, "cpu").numpy(), want.color, "image")
        assert r.color.any() == (len(depth_only) == 1)
        assert torch.isfinite(r.full_depth).any()


def test_cpu_frame_launches_no_kernel(monkeypatch):
    reset_launches()
    tscene.render_scene(frame_scene("cli_default"), "cpu")
    monkeypatch.setattr(raster_sparse, "FINE_MODE", "fine")
    tscene.render_scene(frame_scene("cli_default"), "cpu")
    assert (launches("coarse_raster"), launches("coarse_raster_stats"),
            launches("fine_raster"), launches("fine_raster_stats"),
            launches("untile_one", "untile_image"),
            launches("untile3", "untile3_image")) == (0, 0, 0, 0, 0, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FRAMES))
def test_cuda_frame_matches_cpu_frame(port_frames, cuda_device, name):
    reset_launches()
    r = tscene.render_scene(frame_scene(name), cuda_device)
    torch.cuda.synchronize()
    assert launches("coarse_raster_stats", "fine_raster_stats") == 3
    assert launches("untile3", "untile3_image") == 1
    got, stats, _ = port_frames[name]
    for k in PLANES:
        assert_bits(_np(r)[k], got[k], k)
    assert r.stats == stats

