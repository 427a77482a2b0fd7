"""The port against the checked-in golden images of ``tests/golden/``.

The port's parity tests compare it live with the JAX package and with its
own oracle copy; if the two drifted together none would fail.  These pin
the port to the fixed files, as ``tests/test_golden.py`` and
``tests/test_real_asset.py`` pin the JAX package:

  * the six scenes of ``scripts/gen_goldens.golden_configs`` at 96x72,
    built from the port's own ``models.procedural``, ``math3d`` and
    ``shaders``, rendered on the CPU through ``scene.render_passes`` on the
    tiled and the scan ("xla") backends: bitwise;
  * the three post images of ``gen_goldens.postprocess_golden`` (z-viz,
    SSAO and the composite over the multi-pass scene, depth in float64),
    through the NumPy post and the torch post: bitwise;
  * the CLI on the 27,360-face disk head that
    ``scripts/gen_real_asset.generate`` writes, at 160x100 on the CPU, on
    both backends: ``phong.tga`` bitwise the golden; ``final.tga`` bitwise
    the JAX package's ``--backend oracle`` CLI output (one JAX subprocess,
    which also writes the asset), which differs from the golden at 2
    pixels by 1 LSB (ROADMAP.md, Queue 3).
"""

import os

import numpy as np
import pytest
import torch

from torch_parity import assert_bits, run_jax
from tinyrenderder_tpu_torch import cli, convert, math3d
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.models import procedural
from tinyrenderder_tpu_torch.ops import post
from tinyrenderder_tpu_torch.shaders import (EyeShader, FlatShader, GouraudShader,
                                             PhongShader, TexturedShader)
from tinyrenderder_tpu_torch.utils import tga

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
#: scripts/gen_goldens.py's frame and lights
W, H = 96, 72
KEY = np.array([1.0, 1.4, 1.0])
FILL = np.array([-0.3, 0.5, 0.2])
RIM = np.array([-1.0, 0.8, -1.5])
SCENES = ("flat_head", "gouraud_head", "textured_head", "phong_nm_head", "eye_sphere",
          "multi_pass")
BACKENDS = ("tiled", "xla")
#: scripts/gen_real_asset.py's CLI frame
CLI_W, CLI_H = 160, 100


def golden_passes(name: str) -> list:
    """``gen_goldens.golden_configs()[name]`` from the port's host objects,
    as ``render_passes`` takes them: tensors on the CPU, identity model
    matrices, ``tests/helpers.py::default_view`` (aspect 1)."""
    head = procedural.bumpy_head(12, 16)
    head.materials = [procedural.default_head_material(32)]
    sphere = procedural.uv_sphere(10, 14)
    sphere.materials = [procedural.default_head_material(16)]
    meshes = {"head": head, "sphere": sphere, "soup": procedural.triangle_soup(40),
              "plane": procedural.plane(3.0, -1.0)}
    view = math3d.lookat((0, 0.5, 3), (0, 0, 0), (0, 1, 0))
    proj = math3d.perspective(60.0, 1.0, 0.1, 50.0)
    config = {
        "flat_head": [("head", FlatShader(light_world=(0.3, 0.4, 1.0)))],
        "gouraud_head": [("head", GouraudShader(light_world=(0.3, 0.4, 1.0)))],
        "textured_head": [("head", TexturedShader())],
        "phong_nm_head": [("head", PhongShader(KEY, FILL, RIM, normal_map_strength=0.5))],
        "eye_sphere": [("sphere", EyeShader(KEY, RIM))],
        "multi_pass": [("head", PhongShader(KEY, FILL, RIM)), ("plane", TexturedShader()),
                       ("soup", GouraudShader())],
    }[name]
    passes = []
    for mesh_name, shader in config:
        mesh = meshes[mesh_name]
        material = mesh.materials[0] if mesh.materials else None
        uniforms = shader.build_uniforms(view @ np.eye(4), proj, material, np.float32)
        attrs, uniforms = convert.pass_to_torch(mesh.face_attributes(np.float32), uniforms,
                                                "cpu")
        passes.append((attrs, shader, uniforms, False))
    return passes


def golden(name: str) -> np.ndarray:
    """A golden TGA as (H, W, 3) RGB, top row first (the files are written
    bottom row first, tgaimage.cpp:161-191)."""
    return tga.read(os.path.join(GOLDEN_DIR, f"{name}.tga")).to_rgb()[::-1][..., :3]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("name", SCENES)
def test_golden_scene(name, backend):
    fb, _, _ = tscene.render_passes(golden_passes(name), W, H, "cpu", backend=backend)
    assert_bits(fb.color.numpy(), golden(name), f"{name} on {backend}")


@pytest.mark.parametrize("backend", BACKENDS)
def test_golden_post(backend):
    """The post over the multi-pass scene, in float64 as the goldens were
    made: NumPy and torch, bitwise the three post images."""
    fb, _, _ = tscene.render_passes(golden_passes("multi_pass"), W, H, "cpu",
                                    backend=backend)
    color = fb.color.numpy()
    depth = fb.depth.numpy().astype(np.float64)
    ao_np = post.ssao_image_np(post.ssao_map_np(depth))
    depth_t = torch.from_numpy(depth)
    ao_t = post.ssao_image(post.ssao_map(depth_t)).numpy()
    for what, zimg, ao, final in (
            ("numpy", post.zbuffer_to_image_np(depth), ao_np, post.composite_np(color, ao_np)),
            ("torch", post.zbuffer_to_image(depth_t).numpy(), ao_t,
             post.composite(fb.color, torch.from_numpy(ao_t)).numpy())):
        for name, img in (("post_zbuffer", np.repeat(zimg[..., None], 3, -1)),
                          ("post_ao", np.repeat(ao[..., None], 3, -1)),
                          ("post_final", final)):
            assert_bits(img, golden(name), f"{name} ({what} post, {backend})")


@pytest.fixture(scope="module")
def real_asset(tmp_path_factory):
    """(the asset's directory, the JAX oracle CLI's files' bytes)."""
    d = tmp_path_factory.mktemp("real_asset")
    out = run_jax({"cli": {"op": "real_asset", "dir": str(d)}}, d)["cli"]
    return d, {k: v.tobytes() for k, v in out.items()}


@pytest.mark.parametrize("backend", BACKENDS)
def test_golden_real_asset_cli(real_asset, backend, tmp_path):
    """``cli --device cpu`` on the disk head (the argv[1] model override,
    main.cpp:478): ``phong.tga`` bitwise the golden, and ``final.tga``
    (and the z-viz and AO images) byte for byte the JAX oracle CLI's."""
    d, jax_files = real_asset
    assert cli.run([str(d / "head.obj"), "--device", "cpu", "--width", str(CLI_W),
                    "--height", str(CLI_H), "--backend", backend,
                    "--outdir", str(tmp_path)]) == 0
    phong = tga.read(str(tmp_path / "phong.tga")).to_rgb()[::-1]
    assert phong.shape == (CLI_H, CLI_W, 3)
    assert_bits(phong, golden("real_head_cli_phong"), f"phong on {backend}")
    for name in ("zbuffer", "ao", "final"):
        assert (tmp_path / f"{name}.tga").read_bytes() == jax_files[name], (
            f"{name}.tga on {backend} differs from the JAX oracle CLI's")
