"""The port's post pass (``ops/post.py``) and CLI (``cli.py``).

(a) z-visualization, SSAO and composite against the JAX package's NumPy
    path (``xp=numpy``), bitwise, on real and degenerate depth buffers;
(b) ``postprocess`` against the JAX package's ``postprocess_device``
    (one subprocess for the module, see tests/torch_parity.py), bitwise;
(c) the port's CLI on the CPU: its TGA files equal, byte for byte, those
    written from the float32 oracle's colour and depth through the JAX
    package's NumPy post and TGA writer, as the JAX CLI writes them,
    with and without ``--shadows`` (the shadowed oracle frame); refused
    modes exit non-zero.  The scenes are the port's own."""

import numpy as np
import pytest
import torch

from torch_parity import assert_bits, frame_scene, run_jax
from tinyrenderder_tpu.ops import post as ref
from tinyrenderder_tpu.utils import tga
from tinyrenderder_tpu_torch import cli
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch import shadows
from tinyrenderder_tpu_torch.ops import post


CASES = ("cli_default", "noisy", "all_inf", "constant_far", "edge_pixels")


@pytest.fixture(scope="module")
def cases():
    """name -> ((H, W, 3) uint8 colour, (H, W) f32 depth)."""
    r = tscene.oracle_render(frame_scene("cli_default"))
    rng = np.random.default_rng(3)
    h, w = 40, 72
    color = rng.integers(0, 256, size=(h, w, 3), dtype=np.int64).astype(np.uint8)
    noisy = rng.uniform(0.9, 1.0, size=(h, w)).astype(np.float32)
    noisy[rng.random((h, w)) < 0.3] = np.inf
    far = np.full((h, w), 37.5, np.float32)   # |z| > 16: zmin + 1e-7 rounds to zmin
    far[:, :9] = np.inf
    out = {"cli_default": (r.color, r.depth),
           "noisy": (color, noisy),
           "all_inf": (color, np.full((h, w), np.inf, np.float32)),
           "constant_far": (color, far),
           "edge_pixels": (color[:3, :5], noisy[:3, :5])}
    assert tuple(out) == CASES
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def jax_post(cases, tmp_path_factory):
    req = {name: {"op": "post", "color": c, "depth": d} for name, (c, d) in cases.items()}
    return run_jax(req, tmp_path_factory.mktemp("jax_post"))


@pytest.mark.parametrize("name", CASES)
def test_post_stages_match_numpy(cases, name):
    color, depth = cases[name]
    assert_bits(post.zbuffer_to_image(_t(depth)).numpy(),
                ref.zbuffer_to_image(depth, np), "zbuffer image")
    ao = post.ssao_map(_t(depth))
    assert_bits(ao.numpy(), ref.ssao_map(depth, np), "ssao map")
    ao_u8 = post.ssao_image(ao)
    assert_bits(ao_u8.numpy(), ref.ssao_image(ref.ssao_map(depth, np), np), "ao image")
    assert_bits(post.composite(_t(color), ao_u8).numpy(),
                ref.composite(color, ao_u8.numpy(), np), "composite")


@pytest.mark.parametrize("name", CASES)
def test_zbuffer_image_in_float64_matches_numpy(cases, name):
    """The CLI's --no-ssao path normalizes depth in float64, as the JAX CLI does."""
    depth = cases[name][1].astype(np.float64)
    assert_bits(post.zbuffer_to_image(_t(depth)).numpy(),
                ref.zbuffer_to_image(depth, np), "zbuffer image")


@pytest.mark.parametrize("name", CASES)
def test_postprocess_matches_jax_postprocess_device(cases, jax_post, name):
    color, depth = cases[name]
    got = post.postprocess(_t(color), _t(depth))
    for k, g in zip(("zimg", "ao", "final"), got):
        assert_bits(g.numpy(), jax_post[name][k], k)
    for k, g, w in zip(("zimg", "ao", "final"), got, post.oracle_post(color, depth)):
        assert_bits(g.numpy(), w, k)


def test_composite_is_integer_floor():
    c = np.arange(256, dtype=np.uint8)[:, None, None].repeat(3, axis=-1)
    a = np.arange(256, dtype=np.uint8)[None, :]
    c = np.broadcast_to(c, (256, 256, 3)).copy()
    a = np.broadcast_to(a, (256, 256)).copy()
    assert_bits(post.composite(_t(c), _t(a)).numpy(), ref.composite(c, a, np), "composite")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

W, H = 64, 48
#: the shadow map side of the --shadows case
SHADOW_SIZE = 128


def _write_oracle_files(out, r):
    """The four files the JAX CLI writes from a render result, through
    the JAX package's NumPy post and TGA writer, and the float64 z image
    of its --no-ssao path."""
    zimg = ref.zbuffer_to_image(r.depth, np)
    ao_u8 = ref.ssao_image(ref.ssao_map(r.depth, np), np)
    final = ref.composite(r.color, ao_u8, np)
    gray = lambda a: np.repeat(a[..., None], 3, axis=-1)  # noqa: E731
    for name, rgb in (("phong", r.color), ("zbuffer", gray(zimg)), ("ao", gray(ao_u8)),
                      ("final", final)):
        tga.TGAImage.from_rgb(rgb).write_tga_file(str(out / f"{name}.tga"))
    z64 = ref.zbuffer_to_image(np.asarray(r.depth, np.float64), np)
    tga.TGAImage.from_rgb(gray(z64)).write_tga_file(str(out / "zbuffer64.tga"))


@pytest.fixture(scope="module")
def oracle_files(tmp_path_factory):
    """The four files written the JAX CLI's way from the f32 oracle."""
    out = tmp_path_factory.mktemp("oracle_cli")
    r = tscene.oracle_render(cli.build_default_scene(width=W, height=H))
    _write_oracle_files(out, r)
    return out, r.stats


def test_cli_writes_the_oracle_files(oracle_files, tmp_path, caplog):
    want, stats = oracle_files
    caplog.set_level("INFO")
    assert cli.run(["--device", "cpu", "--width", str(W), "--height", str(H),
                    "--outdir", str(tmp_path)]) == 0
    for name in ("phong", "zbuffer", "ao", "final"):
        assert (tmp_path / f"{name}.tga").read_bytes() == \
            (want / f"{name}.tga").read_bytes(), name
    assert stats.describe() in caplog.text
    assert stats.culling_report() in caplog.text


def test_cli_no_ssao_and_image_only(oracle_files, tmp_path):
    want, _ = oracle_files
    assert cli.run(["--device", "cpu", "--width", str(W), "--height", str(H),
                    "--outdir", str(tmp_path / "a"), "--no-ssao"]) == 0
    assert sorted(p.name for p in (tmp_path / "a").iterdir()) == ["phong.tga",
                                                                   "zbuffer.tga"]
    assert (tmp_path / "a" / "zbuffer.tga").read_bytes() == \
        (want / "zbuffer64.tga").read_bytes()
    assert cli.run(["--device", "cpu", "--width", str(W), "--height", str(H),
                    "--outdir", str(tmp_path / "b"), "--image-only"]) == 0
    assert [p.name for p in (tmp_path / "b").iterdir()] == ["phong.tga"]
    assert (tmp_path / "b" / "phong.tga").read_bytes() == (want / "phong.tga").read_bytes()


def test_cli_shadows_writes_the_oracle_files(oracle_files, tmp_path, caplog):
    """--shadows: the shadowed frame with exact stats, then the same post;
    the files equal those of the oracle's two passes.  With --image-only
    the flag is ignored, with a warning."""
    want = tmp_path / "oracle"
    want.mkdir()
    r, _ = shadows.oracle_render_with_shadows(cli.build_default_scene(width=W, height=H),
                                              cli.KEY_LIGHT_DIR,
                                              shadows.ShadowSettings(size=SHADOW_SIZE))
    _write_oracle_files(want, r)
    caplog.set_level("INFO")
    assert cli.run(["--device", "cpu", "--width", str(W), "--height", str(H), "--outdir",
                    str(tmp_path / "a"), "--shadows", "--shadow-size", str(SHADOW_SIZE)]) == 0
    for name in ("phong", "zbuffer", "ao", "final"):
        assert (tmp_path / "a" / f"{name}.tga").read_bytes() == \
            (want / f"{name}.tga").read_bytes(), name
    assert r.stats.describe() in caplog.text
    assert (want / "phong.tga").read_bytes() != (oracle_files[0] / "phong.tga").read_bytes()
    assert cli.run(["--device", "cpu", "--width", str(W), "--height", str(H), "--outdir",
                    str(tmp_path / "b"), "--image-only", "--shadows"]) == 0
    assert "--shadows is not supported with --image-only" in caplog.text
    assert (tmp_path / "b" / "phong.tga").read_bytes() == \
        (oracle_files[0] / "phong.tga").read_bytes()


@pytest.mark.parametrize("flags,item", [(["--animate", "4"], "item 11"),
                                        (["--profile"], "item 11")])
def test_cli_refuses_unported_modes(flags, item, tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.run(["--device", "cpu", "--outdir", str(tmp_path), *flags])
    assert exc.value.code != 0
    assert item in capsys.readouterr().err
    assert not any(tmp_path.iterdir())
