"""The port's orbit animation on every backend the JAX module renders it on:
``animation.render_animation(backend=...)`` and ``cli --animate N
--backend ...``.

(a) Against the JAX package: its ``render_animation(backend)`` on 4
    virtual CPU devices (one JAX subprocess for the module,
    tests/torch_parity.py) and the port's over 4 ranks emulated in this
    process (``dist.emulated_mesh``), for the oracle and the four sharded
    backends, a 3-frame orbit of the 3-mesh scene at 128x64: the decoded
    frames under ``torch_parity.assert_colour``'s rule, and the port's
    files equal to its tiled orbit's byte for byte.
(b) ``sharded-measured`` under the moving camera: one blocking
    measurement an orbit; each later frame's re-measure is adopted at the
    start of the next frame, so frame 2 renders on the bands of frame 1's
    costs.
(c) Two gloo ranks (``torch_parity.spawn_ranks``): ``cli --animate 3`` on
    ``sharded-measured`` and ``sharded-geometry``, and a
    ``render_animation`` stopped after one frame and resumed, write the
    one-process tiled orbit's files byte for byte, and only rank 0 reads
    the checkpoint or writes.
(d) The CLI's orbit on every backend in one process, and the scan
    backend's (``"xla"``) orbit: the tiled orbit's files, through
    ``render_animation`` and the CLI."""

import math
import os
import socket

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from torch_parity import assert_colour, cli_rank, multimesh_scene, run_jax, spawn_ranks
from tinyrenderder_tpu_torch import animation, cli
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.parallel import dist
from tinyrenderder_tpu_torch.utils import tga

W, H, FRAMES = 128, 64, 3
RANKS = 4
BACKENDS = ("oracle", *tscene.SHARDED_BACKENDS)
#: the CLI's default scene, as tests/test_torch_parallel_scene.py runs it
CLI_W, CLI_H = 128, 96


def _scene():
    return multimesh_scene("port", W, H)


def _files(d) -> dict:
    return {p: (d / p).read_bytes() for p in sorted(os.listdir(d))}


def _orbit(d, backend, scene=None, **kw) -> dict:
    cfg = animation.AnimationConfig(frames=FRAMES, backend=backend, device="cpu",
                                    mesh=dist.emulated_mesh(RANKS, device="cpu"), outdir=str(d))
    summary = animation.render_animation(scene or _scene(), cfg, **kw)
    assert summary["frames_rendered"] == FRAMES and summary["resumed_at"] == 0
    return _files(d)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    req = {b: {"op": "animation", "backend": b, "w": W, "h": H, "frames": FRAMES}
           for b in BACKENDS}
    return run_jax(req, tmp_path_factory.mktemp("jax_animation"), devices=RANKS)


@pytest.fixture(scope="module")
def tiled(tmp_path_factory) -> dict:
    """The tiled orbit's files, one process on the CPU."""
    return _orbit(tmp_path_factory.mktemp("tiled"), "tiled")


@pytest.fixture(scope="module")
def oracles() -> list:
    """The float32 oracle's colour at each orbit eye."""
    sc = _scene()
    eye, target = sc.camera.params.eye.copy(), sc.camera.params.target.copy()
    out = []
    for i in range(FRAMES):
        sc.camera.set_eye(animation.orbit_eye(eye, target, 2 * math.pi * i / FRAMES))
        out.append(tscene.oracle_render(sc).color)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_orbit_matches_jax(jax_side, tiled, oracles, backend, tmp_path):
    got = _orbit(tmp_path, backend)
    assert got == tiled
    want = jax_side[backend]["frames"]
    for i in range(FRAMES):
        # the files are written bottom row first; both sides decode them alike
        frame = tga.read(str(tmp_path / f"frame_{i:04d}.tga")).to_rgb()[::-1]
        assert_colour(frame, want[i][::-1], oracles[i], f"{backend} frame {i}")
    assert len({tiled[f"frame_{i:04d}.tga"] for i in range(FRAMES)}) == FRAMES


def test_measured_orbit_measures_once_and_lags_one_frame(tiled, tmp_path, monkeypatch):
    """One blocking measurement (frame 0); frames 1 and 2 re-measure without
    blocking; frame 1's costs are balanced at the start of frame 2 and its
    bands render frame 2, though frame 2's own costs differ."""
    blocking, measured, balanced, bands = [], [], [], []
    real_blocking, real_device = dist.measure_tile_row_costs, dist.measure_tile_row_costs_device
    real_balance, real_frame = dist.balance_bands, dist.render_frame_fused_sharded

    def blocking_measure(*args, **kw):
        blocking.append(len(bands))
        return real_blocking(*args, **kw)

    def device_measure(*args, **kw):
        costs = real_device(*args, **kw)
        measured.append(costs.numpy().astype(np.int64))
        return costs

    def balance(costs, n, *args):
        balanced.append((len(bands), np.asarray(costs)))
        return real_balance(costs, n, *args)

    def frame(*args, **kw):
        bands.append(kw["bands"])
        return real_frame(*args, **kw)

    monkeypatch.setattr(dist, "measure_tile_row_costs", blocking_measure)
    monkeypatch.setattr(dist, "measure_tile_row_costs_device", device_measure)
    monkeypatch.setattr(dist, "balance_bands", balance)
    monkeypatch.setattr(dist, "render_frame_fused_sharded", frame)
    assert _orbit(tmp_path, "sharded-measured") == tiled
    assert blocking == [0] and len(measured) == FRAMES
    assert [f for f, _ in balanced] == [0, 2]
    np.testing.assert_array_equal(balanced[0][1], measured[0])
    np.testing.assert_array_equal(balanced[1][1], measured[1])
    assert not np.array_equal(measured[1], measured[2])
    assert bands == [real_balance(measured[0], RANKS)] * 2 + [real_balance(measured[1], RANKS)]


def test_measured_orbit_resizes_with_the_frame(tmp_path):
    """A change of frame size measures again, synchronously: the previous
    size's bands would be illegal."""
    sc = _scene()
    mesh = dist.emulated_mesh(RANKS, device="cpu")
    sc.render("cpu", backend="sharded-measured", mesh=mesh)
    sc.width, sc.height = W, 2 * H
    got = sc.render("cpu", backend="sharded-measured", mesh=mesh)
    assert sum(r for _, r in sc.__dict__["_band_cache"]["bands"]) == 2 * H // 16
    assert torch.equal(got.color, sc.render("cpu").color)


# ---------------------------------------------------------------------------
# the CLI, and two gloo ranks
# ---------------------------------------------------------------------------

def _cli_args(outdir, backend: str = "tiled") -> list:
    return ["--device", "cpu", "--width", str(CLI_W), "--height", str(CLI_H), "--outdir",
            str(outdir), "--animate", str(FRAMES), "--backend", backend]


@pytest.fixture(scope="module")
def cli_tiled(tmp_path_factory) -> dict:
    d = tmp_path_factory.mktemp("cli_tiled")
    assert cli.run(_cli_args(d)) == 0
    return _files(d)


@pytest.mark.parametrize("backend", BACKENDS)
def test_cli_animate_on_every_backend(cli_tiled, backend, tmp_path):
    """Started plainly (a world of one rank), --animate on any backend
    writes the tiled orbit's files."""
    assert cli.run(_cli_args(tmp_path, backend)) == 0
    assert _files(tmp_path) == cli_tiled


def test_xla_orbit_writes_the_tiled_orbits_files(tiled, cli_tiled, tmp_path):
    """The scan backend's orbit, through ``render_animation`` (its mesh is
    not used) and ``cli --animate --backend xla``: the tiled orbit's files
    byte for byte."""
    assert _orbit(tmp_path / "orbit", "xla") == tiled
    assert cli.run(_cli_args(tmp_path / "cli", "xla")) == 0
    assert _files(tmp_path / "cli") == cli_tiled


def _log_writes(rank: int, log_dir: str) -> None:
    """Append every checkpoint read, checkpoint write and TGA write of this
    rank to ``<log_dir>/rank<rank>``."""
    path = os.path.join(log_dir, f"rank{rank}")

    def logged(fn, what):
        def wrapper(*args, **kw):
            with open(path, "a") as f:
                f.write(what + "\n")
            return fn(*args, **kw)
        return wrapper

    tga.TGAImage.write_tga_file = logged(tga.TGAImage.write_tga_file, "tga")
    animation._save_checkpoint = logged(animation._save_checkpoint, "save")
    animation._load_checkpoint = logged(animation._load_checkpoint, "load")


def _cli_orbit_rank(rank, world, port, argv, log_dir):
    _log_writes(rank, log_dir)
    cli_rank(rank, world, port, argv)


def _resumed_orbit_rank(rank, world, port, outdir, log_dir):
    """A sharded-measured orbit of the CLI's scene stopped after one frame,
    then resumed in a fresh scene, on a gloo process group."""
    _log_writes(rank, log_dir)
    torch.set_num_threads(1)
    tdist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                             world_size=world, rank=rank)
    try:
        cfg = animation.AnimationConfig(frames=FRAMES, backend="sharded-measured",
                                        device="cpu", outdir=outdir)
        first = animation.render_animation(
            cli.build_default_scene(width=CLI_W, height=CLI_H), cfg, stop_after=1)
        assert (first["frames_rendered"], first["resumed_at"]) == (1, 0)
        second = animation.render_animation(
            cli.build_default_scene(width=CLI_W, height=CLI_H), cfg)
        assert (second["frames_rendered"], second["resumed_at"]) == (FRAMES - 1, 1)
    finally:
        tdist.destroy_process_group()


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_logs(log_dir) -> dict:
    return {p: sorted((log_dir / p).read_text().split()) for p in sorted(os.listdir(log_dir))}


@pytest.mark.parametrize("backend", ["sharded-measured", "sharded-geometry"])
def test_cli_animate_under_two_gloo_ranks(cli_tiled, backend, tmp_path):
    """Every rank renders every frame; rank 0 alone reads the checkpoint
    and writes the frames and checkpoints, the one-process tiled orbit's
    bytes."""
    out, logs = tmp_path / "out", tmp_path / "logs"
    logs.mkdir()
    spawn_ranks(_cli_orbit_rank, (2, _port(), _cli_args(out, backend), str(logs)), 2)
    assert _files(out) == cli_tiled
    assert _rank_logs(logs) == {"rank0": ["load"] + ["save"] * FRAMES + ["tga"] * FRAMES}


def test_resumed_orbit_under_two_gloo_ranks(cli_tiled, tmp_path):
    """Stopped after one frame and resumed: rank 0's checkpoint decides the
    start frame on both ranks, and the files are the uninterrupted
    orbit's."""
    out, logs = tmp_path / "out", tmp_path / "logs"
    logs.mkdir()
    spawn_ranks(_resumed_orbit_rank, (2, _port(), str(out), str(logs)), 2)
    assert _files(out) == cli_tiled
    assert _rank_logs(logs) == {"rank0": ["load"] * 2 + ["save"] * FRAMES + ["tga"] * FRAMES}


@pytest.mark.cuda
def test_cuda_measured_orbit_matches_cpu_orbit(tiled, tmp_path):
    """On the card the re-measure goes through a pinned copy and an event:
    one blocking measurement, the CPU orbit's bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    calls = []
    real = dist.measure_tile_row_costs

    def blocking(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    dist.measure_tile_row_costs = blocking
    try:
        cfg = animation.AnimationConfig(frames=FRAMES, backend="sharded-measured",
                                        device="cuda", mesh=dist.emulated_mesh(RANKS),
                                        outdir=str(tmp_path))
        assert animation.render_animation(_scene(), cfg)["frames_rendered"] == FRAMES
    finally:
        dist.measure_tile_row_costs = real
    assert calls == [1] and _files(tmp_path) == tiled
