"""The port's pixel-split sharded backends ("sharded", "sharded-2d",
"sharded-measured") through its entry points against the JAX package's
("sharded-geometry" has tests/test_torch_parallel_geometry.py):
``Scene.render`` with exact stats, ``Scene.render_image``,
``shadows.render_with_shadows`` and the CLI.

JAX side: ``Scene.render(backend)`` / ``render_image(backend)`` and
``render_with_shadows(backend)`` on 4 virtual CPU devices, in one
subprocess for the module (tests/torch_parity.py says why), with the JAX
package's routing: interleaved row bands, a 2x2 grid of blocks, measured
bands, and its XLA scan for a frame that is not tile-aligned.  The port
renders over 4 ranks emulated in this process on the CPU
(``dist.emulated_mesh``); the CLI runs as two gloo ranks.

Colour, output depth, full depth and ``RenderStats`` are compared
bitwise, with the one exception the reference makes
(``torch_parity.assert_colour``): where the JAX package's colour leaves
its own float32 NumPy oracle by 1 LSB (its colour contract), the port's
is the oracle's."""

import socket

import pytest
import torch

from torch_parity import (SHADOW_KEY, assert_bits, assert_colour, blocker_scene, cli_rank,
                          run_jax, sharded_scene, spawn_ranks, stats_vector)
from tinyrenderder_tpu_torch import cli, math3d, shadows
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.parallel import dist

BACKENDS = ("sharded", "sharded-2d", "sharded-measured")
RANKS = 4
#: scene cases: name -> (sharded_scene kind, w, h): the 3-pass frame (eyes
#: excluded in the middle), one colour pass (the image route), a frame
#: that is not tile-aligned (160 x 96: a ragged tile column, 6 tile rows on
#: 4 ranks) and a scene whose one pass is culled
SCENES = {"multimesh": ("multimesh", 256, 128), "head": ("head", 256, 128),
          "ragged": ("multimesh", 160, 96), "culled": ("culled", 128, 128)}
#: the cases rendered on every backend; "ragged" takes "sharded" alone (the
#: JAX package's scan backs all three there)
CASES = [(name, b) for name in ("multimesh", "head", "culled") for b in BACKENDS] + [
    ("ragged", "sharded")]
SHADOW_W, SHADOW_H, SHADOW_SIZE = 128, 64, 128
PLANES = ("color", "depth", "full_depth")


def _mesh():
    return dist.emulated_mesh(RANKS, device="cpu")


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    req = {f"{name}_{b}": {"op": "sharded_scene", "scene": SCENES[name][0],
                           "w": SCENES[name][1], "h": SCENES[name][2], "backend": b}
           for name, b in CASES}
    for b in BACKENDS:
        req[f"shadows_{b}"] = {"op": "shadows", "w": SHADOW_W, "h": SHADOW_H,
                               "size": SHADOW_SIZE, "mode": "coarse", "backend": b}
    return run_jax(req, tmp_path_factory.mktemp("jax_parallel_scene"), devices=RANKS)


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
    for plane in PLANES[1:]:
        assert_bits(getattr(got, plane).numpy(), want[plane], f"{what} {plane}")
    assert_bits(stats_vector(got.stats), want["stats"], f"{what} stats")
    assert got.stats == oracle.stats


@pytest.mark.parametrize("name,backend", CASES)
def test_scene_render_matches_jax(jax_side, oracles, name, backend):
    """``Scene.render(backend)`` with exact stats: colour, output depth,
    full depth and ``RenderStats``."""
    kind, w, h = SCENES[name]
    got = sharded_scene(kind, "port", w, h).render("cpu", backend=backend, mesh=_mesh())
    _check_frame(got, jax_side[f"{name}_{backend}"], oracles[name], f"{name} {backend}")
    if name == "culled":
        assert got.color.sum() == 0 and not torch.isfinite(got.full_depth).any()
    else:
        assert torch.isfinite(got.full_depth).sum() > 1000


@pytest.mark.parametrize("name,backend", CASES)
def test_scene_render_image_matches_jax(jax_side, oracles, name, backend):
    """``Scene.render_image(backend)``: the image route of one colour pass
    on "sharded", the frame's colour otherwise."""
    kind, w, h = SCENES[name]
    got = sharded_scene(kind, "port", w, h).render_image("cpu", backend=backend, mesh=_mesh())
    assert_colour(got.numpy(), jax_side[f"{name}_{backend}"]["image"], oracles[name].color,
                  f"{name} {backend} image")


@pytest.mark.parametrize("backend", BACKENDS)
def test_render_with_shadows_matches_jax(jax_side, oracles, backend):
    """Both passes of the shadowed frame on a sharded backend: the map and
    the lit frame with stats."""
    want = jax_side[f"shadows_{backend}"]
    ref, ref_map = oracles["shadows"]
    res, smap = shadows.render_with_shadows(
        blocker_scene("port", SHADOW_W, SHADOW_H), math3d.normalized(math3d.vec3(*SHADOW_KEY)),
        shadows.ShadowSettings(size=SHADOW_SIZE), "cpu", backend=backend, mesh=_mesh())
    assert_bits(smap.numpy(), want["map"], "shadow map")
    assert_bits(smap.numpy(), ref_map, "shadow map vs the f32 oracle")
    _check_frame(res, want, ref, f"shadowed {backend}")


def test_sharded_backends_render_on_the_card_unless_asked():
    """With no mesh given, the ranks of the process group (here one)
    render on the card: without one that raises; ``device="cpu"`` renders
    on the CPU, and a mesh on another kind of device is refused."""
    scene = sharded_scene("head", "port", 128, 64)
    if not torch.cuda.is_available():
        for backend in BACKENDS:
            with pytest.raises(RuntimeError, match="GPU"):
                scene.render(backend=backend)
    got = scene.render_image("cpu", backend="sharded")
    assert got.device.type == "cpu"
    assert torch.equal(got, scene.render_image("cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="the mesh renders on cpu"):
            scene.render("cuda", backend="sharded", mesh=_mesh())


def test_cli_under_two_gloo_ranks(tmp_path):
    """The CLI with ``--backend sharded`` started as torchrun starts it (the
    process group from the environment, here two gloo ranks on the CPU):
    each rank renders its band, rank 0 writes the four files, and they are
    the tiled backend's, byte for byte."""
    args = ["--device", "cpu", "--width", "128", "--height", "96"]
    assert cli.run(args + ["--outdir", str(tmp_path / "tiled")]) == 0
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    spawn_ranks(cli_rank, (2, port, args + ["--backend", "sharded", "--outdir",
                                             str(tmp_path / "sharded")]), 2)
    for name in ("phong", "zbuffer", "ao", "final"):
        assert (tmp_path / "sharded" / f"{name}.tga").read_bytes() == \
            (tmp_path / "tiled" / f"{name}.tga").read_bytes(), name
