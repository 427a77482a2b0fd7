"""The port's single-pass image route end to end.

(a) against the float32 NumPy oracle (``oracle.render_passes``): image
    and depth, bitwise;
(b) against the JAX package's ``raster_sparse.render_frame_fused_image``
    with ``FINE_MODE = "coarse"`` (Pallas in interpret mode, one
    subprocess for the module, see tests/torch_parity.py): image, bitwise;
(c) the port imports and renders with jax unimportable;
plus the scene shapes the entry point sends to the tiled frame (a
depth-only pass among them) and its refusals, and (``cuda``) the GPU
route against the CPU route.  The port side runs on the port's own meshes, shaders and
scenes, the oracle and JAX sides on the JAX package's."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import ROOT, SCENES, assert_bits, launches, reset_launches, run_jax, scene_pass
from tinyrenderder_tpu import oracle
from tinyrenderder_tpu_torch import convert, math3d, shaders
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.models import procedural
from tinyrenderder_tpu_torch.ops import raster_sparse


def _port_frame(name, device="cpu", tile_h=16):
    p, w, h = scene_pass(name)
    attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, device)
    image, depth = raster_sparse.render_frame_fused_image(
        [(attrs, p.shader, uniforms, False)], w, h, tile_h=tile_h, return_depth=True)
    return image.cpu().numpy(), depth.cpu().numpy()


@pytest.fixture(scope="module")
def port_frames():
    return {name: _port_frame(name) for name in SCENES}


@pytest.fixture(scope="module")
def jax_images(tmp_path_factory):
    req = {name: {"op": "image", "scene": name, "th": 16} for name in SCENES}
    return run_jax(req, tmp_path_factory.mktemp("jax_image"))


@pytest.mark.parametrize("name", list(SCENES))
def test_image_and_depth_match_f32_oracle(port_frames, name):
    p, w, h = scene_pass(name, "jax")
    want = oracle.render_passes([p], w, h, dtype=np.float32)
    image, depth = port_frames[name]
    assert image.shape == (h, w, 3) and image.dtype == np.uint8
    assert_bits(depth, want.zbuffer, "depth")
    assert_bits(image, want.color, "image")
    assert np.isfinite(depth).sum() > 100


@pytest.mark.parametrize("name", list(SCENES))
def test_image_matches_jax_coarse_route(port_frames, jax_images, name):
    assert_bits(port_frames[name][0], jax_images[name]["image"], "image")


@pytest.mark.parametrize("name", ["head_phong", "soup_phong_ragged"])
def test_tile_height_does_not_change_the_frame(port_frames, name):
    image, depth = _port_frame(name, tile_h=32)
    assert_bits(image, port_frames[name][0], "image")
    assert_bits(depth, port_frames[name][1], "depth")


def test_scene_route_matches_oracle():
    scene = tscene.headline_scene(128, 64, "phong", n_lat=12, n_lon=16)
    image = tscene.render_scene_image(scene, "cpu")
    assert_bits(image.numpy(), tscene.oracle_render(scene).color, "image")


def test_port_runs_without_jax():
    """The port never imports jax: render with jax made unimportable."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from tinyrenderder_tpu_torch import scene\n"
        "s = scene.headline_scene(128, 64, 'gouraud', n_lat=12, n_lon=16)\n"
        "img = scene.render_scene_image(s, 'cpu')\n"
        "assert tuple(img.shape) == (64, 128, 3), img.shape\n"
        "assert (img.numpy() == scene.oracle_render(s).color).all()\n"
        "r = scene.render_scene(scene.multimesh_scene(160, 96, 8, 8, 4, 6), 'cpu')\n"
        "assert r.stats.fragments_drawn > 0\n"
        "from tinyrenderder_tpu_torch import cli\n"
        "assert not any(m == 'jax' or m.startswith('jax.') for m in sys.modules "
        "if sys.modules[m] is not None)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _head_scene():
    return tscene.headline_scene(64, 32, "phong", n_lat=8, n_lon=8)


def test_unported_scene_shapes_raise():
    """The scene shapes the single-pass route does not take (a depth-only
    pass, several passes, an excluded pass, an empty frame) go through
    the tiled frame and equal the oracle; the depth-only frame is black
    with the pass's depth.  A shader class the port does not know
    raises."""
    depth_only = _head_scene()
    depth_only.passes[0].shader = shaders.DepthShader()
    image = tscene.render_scene_image(depth_only, "cpu")
    want = tscene.oracle_render(depth_only)
    assert_bits(image.numpy(), want.color, "image")
    assert not image.any() and np.isfinite(want.depth).any()
    assert_bits(tscene.render_scene(depth_only, "cpu").depth.numpy(), want.depth, "depth")
    unknown = _head_scene()
    unknown.passes[0].shader = type("UnknownShader", (shaders.Shader,), {})()
    with pytest.raises(NotImplementedError, match="UnknownShader"):
        tscene.render_scene_image(unknown, "cpu")
    key = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
    two = _head_scene()
    two.add(procedural.uv_sphere(6, 8), math3d.identity4(),
            shaders.PhongShader(key, key, key), name="second")
    excluded = _head_scene()
    excluded.passes[0].exclude_from_output_depth = True
    culled = _head_scene()
    behind = np.eye(4)
    behind[2, 3] = 100.0                        # behind the camera: culled
    culled.passes[0].model_matrix = behind
    for sc in (two, excluded, culled):
        assert_bits(tscene.render_scene_image(sc, "cpu").numpy(),
                    tscene.oracle_render(sc).color, "image")


def test_frame_function_validates_passes():
    p, w, h = scene_pass("head_phong")
    attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, "cpu")
    one = (attrs, p.shader, uniforms, False)
    with pytest.raises(ValueError, match="exactly one"):
        raster_sparse.render_frame_fused_image([one, one], w, h)
    with pytest.raises(ValueError, match="color shader"):
        raster_sparse.render_frame_fused_image(
            [(attrs, shaders.DepthShader(), uniforms, False)], w, h)
    empty = {k: v[:0] for k, v in attrs.items()}
    with pytest.raises(ValueError, match="non-empty"):
        raster_sparse.render_frame_fused_image([(empty, p.shader, uniforms, False)], w, h)


def test_frame_with_no_covered_tile_is_background():
    """Every triangle zero-area (rejected): zero pairs, zero active tiles."""
    p, w, h = scene_pass("head_phong")
    flat = dict(p.attrs)
    flat["position"] = np.broadcast_to(flat["position"][:1, :1], flat["position"].shape).copy()
    attrs, uniforms = convert.pass_to_torch(flat, p.uniforms, "cpu")
    image, depth = raster_sparse.render_frame_fused_image(
        [(attrs, p.shader, uniforms, False)], w, h, return_depth=True)
    assert not image.any() and torch.isinf(depth).all()
    pj = scene_pass("head_phong", "jax")[0]
    want = oracle.render_passes([oracle.OraclePass(flat, pj.shader, pj.uniforms)],
                                w, h, dtype=np.float32)
    assert_bits(image.numpy(), want.color, "image")


def test_cpu_route_launches_no_kernel(monkeypatch):
    reset_launches()
    _port_frame("head_textured")
    monkeypatch.setattr(raster_sparse, "FINE_MODE", "fine")
    _port_frame("head_textured")
    assert launches("coarse_raster") == launches("untile_one", "untile_image") == \
        launches("fine_raster") == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SCENES))
def test_cuda_route_matches_cpu_route(port_frames, cuda_device, name):
    reset_launches()
    image, depth = _port_frame(name, device=cuda_device)
    assert launches("coarse_raster") == 1 and launches("untile_one", "untile_image") == 2
    assert_bits(image, port_frames[name][0], "image")
    assert_bits(depth, port_frames[name][1], "depth")
