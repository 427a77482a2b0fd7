"""The port's orbit animation (``animation.py``) and native host codecs
(``utils/native.py``).

(a) ``orbit_eye`` and the checkpoint file against the JAX package's
    ``animation.py`` in-process (both are NumPy and JSON): bitwise and
    byte for byte, and the same resume rule;
(b) the orbit on the CPU (the kernels' plain versions) at 64 x 48 on the
    bench's 3-mesh scene: every frame equals the float32 oracle's colour
    at its orbit eye, written by the port's Python encoder; a run killed
    after a few frames and resumed from its checkpoint writes the same
    bytes as one uninterrupted run; the camera is restored after a
    failure;
(c) the C++ RLE codec and OBJ tokenizer against the Python paths, byte
    for byte (skipped where the library does not build, as the JAX tests
    do)."""

import json
import math
import os

import numpy as np
import pytest
import torch

from torch_parity import assert_bits, fine_mode, multimesh_scene
from tinyrenderder_tpu_torch import animation
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.ops import raster_sparse
from tinyrenderder_tpu_torch.models import obj
from tinyrenderder_tpu_torch.utils import native, tga

W, H = 64, 48
FRAMES = 4
#: (eye, target, angle) of the orbit_eye cases
EYES = {"bench": ((0.0, 0.6, 3.0), (0.0, 0.0, 0.0), 2 * math.pi * 1 / 120),
        "cli": ((-3.4019, 2.2001, 1.8026), (1.3555, 1.5116, -0.9686), math.radians(90.0)),
        "zero": ((1.0, 2.0, 3.0), (0.5, 0.0, -0.5), 0.0),
        "full": ((1.0, 2.0, 3.0), (0.5, 0.0, -0.5), 2 * math.pi)}


def _scene():
    return multimesh_scene("port", W, H)


def _files(d):
    return {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}


@pytest.mark.parametrize("name", list(EYES))
def test_orbit_eye_matches_jax(name):
    from tinyrenderder_tpu import animation as j_animation   # jax: not on a GPU host
    eye, target, angle = EYES[name]
    assert_bits(animation.orbit_eye(eye, target, angle),
                j_animation.orbit_eye(eye, target, angle), name)


@pytest.mark.parametrize("case", ["match", "frames", "degrees", "corrupt", "disabled"])
def test_checkpoint_matches_jax(tmp_path, case):
    """The file each module writes, byte for byte, and the frame each
    resumes at from it (a config mismatch or a corrupt file restarts)."""
    from tinyrenderder_tpu import animation as j_animation
    got = []
    for side, mod, extra in (("port", animation, {"device": "cpu"}),
                             ("jax", j_animation, {"backend": "xla"})):
        d = tmp_path / side
        d.mkdir()
        cfg = mod.AnimationConfig(frames=6, orbit_degrees=90.0, outdir=str(d), **extra)
        mod._save_checkpoint(cfg, 4)
        written = (d / "checkpoint.json").read_bytes()
        if case == "corrupt":
            (d / "checkpoint.json").write_text('{"next_frame": ')
        cfg.frames = 7 if case == "frames" else cfg.frames
        cfg.orbit_degrees = 45.0 if case == "degrees" else cfg.orbit_degrees
        cfg.checkpoint = case != "disabled"
        got.append((written, mod._load_checkpoint(cfg)))
    assert got[0] == got[1]
    assert json.loads(got[0][0]) == {"next_frame": 4, "frames": 6, "orbit_degrees": 90.0}
    assert got[0][1] == (4 if case == "match" else 0)


@pytest.fixture(scope="module")
def orbit(tmp_path_factory):
    """One uninterrupted orbit of FRAMES frames on the CPU -> (dir, summary)."""
    d = tmp_path_factory.mktemp("orbit")
    summary = animation.render_animation(
        _scene(), animation.AnimationConfig(frames=FRAMES, device="cpu", outdir=str(d)))
    return d, summary


def test_orbit_frames_equal_the_oracle(orbit, tmp_path, monkeypatch):
    d, summary = orbit
    assert summary["frames_rendered"] == FRAMES and summary["resumed_at"] == 0
    assert set(summary) == {"frames_rendered", "resumed_at", "seconds", "fps",
                            "overflows_repaired"} and summary["overflows_repaired"] == 0
    monkeypatch.setattr(native, "available", lambda: False)     # the Python encoder
    sc = _scene()
    eye, target = sc.camera.params.eye.copy(), sc.camera.params.target.copy()
    frames = set()
    for i in range(FRAMES):
        sc.camera.set_eye(animation.orbit_eye(eye, target, 2 * math.pi * i / FRAMES))
        want = tmp_path / f"want_{i}.tga"
        tga.TGAImage.from_rgb(tscene.oracle_render(sc).color).write_tga_file(str(want))
        got = (d / f"frame_{i:04d}.tga").read_bytes()
        assert got == want.read_bytes(), f"frame {i}"
        frames.add(got)
    assert len(frames) == FRAMES                                 # the camera moves


def test_killed_and_resumed_orbit_writes_the_same_files(orbit, tmp_path):
    d, _ = orbit
    cfg = animation.AnimationConfig(frames=FRAMES, device="cpu", outdir=str(tmp_path))
    sc = _scene()
    eye = sc.camera.params.eye.copy()
    first = animation.render_animation(sc, cfg, stop_after=2)
    assert (first["frames_rendered"], first["resumed_at"]) == (2, 0)
    assert json.loads((tmp_path / "checkpoint.json").read_text())["next_frame"] == 2
    assert_bits(sc.camera.params.eye, eye, "camera restored")
    second = animation.render_animation(_scene(), cfg)
    assert (second["frames_rendered"], second["resumed_at"]) == (FRAMES - 2, 2)
    assert _files(tmp_path) == _files(d)
    done = animation.render_animation(_scene(), cfg)
    assert done["frames_rendered"] == 0 and _files(tmp_path) == _files(d)


def test_failed_frame_restores_the_camera_and_resumes(orbit, tmp_path, monkeypatch):
    """A render that raises mid-orbit: the frame in flight is not written,
    the checkpoint names the next unwritten frame, the camera is back at
    its base eye, and the resumed run completes the same files."""
    d, _ = orbit
    cfg = animation.AnimationConfig(frames=FRAMES, device="cpu", outdir=str(tmp_path))
    real, calls = tscene.render_scene, []

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("device lost")
        return real(*args, **kw)

    sc = _scene()
    eye = sc.camera.params.eye.copy()
    monkeypatch.setattr(tscene, "render_scene", failing)     # Scene.render's tiled frame
    with fine_mode("fine"):
        with pytest.raises(RuntimeError, match="device lost"):
            animation.render_animation(sc, cfg)
        assert_bits(sc.camera.params.eye, eye, "camera restored")
        assert sorted(os.listdir(tmp_path)) == ["checkpoint.json", "frame_0000.tga"]
        monkeypatch.setattr(tscene, "render_scene", real)
        assert animation.render_animation(sc, cfg)["resumed_at"] == 1
    assert raster_sparse.FINE_MODE == "coarse"
    assert _files(tmp_path) == _files(d)          # the strip raster: the same frames


# ---------------------------------------------------------------------------
# the native codecs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip(f"native library did not build: {native.BUILD_ERROR}")
    return native


@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_native_rle_matches_python(lib, bpp):
    rng = np.random.default_rng(bpp)
    img = rng.integers(0, 3, size=(37, 61, bpp), dtype=np.int64).astype(np.uint8) * 90
    img[5:9] = 200                                   # long runs, longer than 128
    img[20, :40] = rng.integers(0, 256, size=(40, bpp))   # a long raw stretch
    flat = img.reshape(-1, bpp)
    enc = lib.rle_encode(flat, bpp)
    assert enc == tga._encode_rle_py(flat, bpp)
    assert_bits(lib.rle_decode(enc, 61, 37, bpp), flat, "native decode")
    assert_bits(tga._decode_rle_py(enc, 61, 37, bpp), flat, "Python decode")
    with pytest.raises(ValueError):
        lib.rle_decode(enc[:len(enc) // 2], 61, 37, bpp)


def test_native_tga_file_matches_python(lib, tmp_path, monkeypatch):
    rgb = (np.arange(48 * 64 * 3) % 7 * 30).astype(np.uint8).reshape(48, 64, 3)
    tga.TGAImage.from_rgb(rgb).write_tga_file(str(tmp_path / "native.tga"))
    monkeypatch.setattr(native, "available", lambda: False)
    tga.TGAImage.from_rgb(rgb).write_tga_file(str(tmp_path / "python.tga"))
    assert (tmp_path / "native.tga").read_bytes() == (tmp_path / "python.tga").read_bytes()
    assert_bits(tga.read(str(tmp_path / "native.tga")).to_rgb(), rgb[::-1], "read back")


def test_native_obj_matches_python(lib, tmp_path):
    (tmp_path / "m.mtl").write_text("newmtl skin\nnewmtl bare\n")
    (tmp_path / "model.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\nvn 0 1 0\n"
        "g front\nusemtl skin\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "o back\nusemtl bare\nf -1/-1/-2 -2/-2/-2 -3/-3/-2\nf 1 2 5\nf 1 2 999\n")
    path = str(tmp_path / "model.obj")
    a = obj.load_obj(path, load_textures=False, use_native=False)
    b = obj.load_obj(path, load_textures=False, use_native=True)
    for k in ("positions", "faces", "uvs", "normals"):
        assert_bits(getattr(b, k), getattr(a, k), k)
    assert [vars(s) for s in b.submeshes] == [vars(s) for s in a.submeshes]
    assert [m.name for m in b.materials] == [m.name for m in a.materials]
    (tmp_path / "bad.obj").write_text("v 0 0 0x\n")
    for use_native in (False, True):
        with pytest.raises(ValueError):
            obj.load_obj(str(tmp_path / "bad.obj"), load_textures=False, use_native=use_native)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_orbit_matches_cpu_orbit(orbit, cuda_device, tmp_path):
    """The pinned, one-frame-behind write pipeline writes the CPU orbit's bytes."""
    d, _ = orbit
    summary = animation.render_animation(
        _scene(), animation.AnimationConfig(frames=FRAMES, device="cuda", outdir=str(tmp_path)))
    assert summary["frames_rendered"] == FRAMES
    assert _files(tmp_path) == _files(d)
