"""The plain reference against the program at the tiny size, a
perturbed output, the control (the reference in bfloat16) and the
roofline's counts on three hand-made triangles."""

import math

import numpy as np
import pytest
import torch
from tiny_checkout import benchmark, tiny_config

from rasterbench import check, control, loop, reference, scenes

BENCH = benchmark()
CELLS = [w["name"] for w in BENCH.spec["workloads"]]


def _plan(cell, seed):
    """-> (the cell's tiny plan, its traffic, its configuration's reference module)."""
    w = BENCH.cell(cell)
    traffic = BENCH.traffic(w["traffic"])
    config = tiny_config(BENCH.config(w["config"]))
    return (scenes.make_plan(config, traffic, seed), traffic,
            BENCH.reference(config.get("reference")))


def _program_frame(fl, eye):
    fl.scene.camera.set_eye(eye)
    return fl.route.frame(fl, None)


@pytest.mark.parametrize("seed", [3, 2**31 + 7])
@pytest.mark.parametrize("cell", CELLS)
def test_reference_equals_the_program(cell, seed):
    plan, traffic, refs = _plan(cell, seed)
    fl = loop.FrameLoop(plan, traffic, BENCH.route(traffic["route"]), "cpu")
    ref = refs.Reference(plan)
    checks = traffic["checks"]
    for frame in range(0, plan.orbit.views, plan.orbit.views // 7):
        eye = plan.orbit.eye_at(frame)
        images, depth, stats = _program_frame(fl, eye)
        want = ref.render(eye, stats="stats_off" in checks)
        got = check.numbers(images, depth, stats, want,
                            check.reference_images(refs, want, checks), checks)
        assert got == {n: 0 for n in traffic["checks"]}, (frame, got)


@pytest.mark.parametrize("cell", CELLS)
def test_a_perturbed_output_fails(cell):
    plan, traffic, refs = _plan(cell, 5)
    ref = refs.Reference(plan)
    eye = plan.orbit.eye_at(11)
    want = ref.render(eye, stats=True)
    checks = traffic["checks"]
    images = {k: v.clone() for k, v in check.reference_images(refs, want, checks).items()}
    images["color"][3, 5, 0] ^= 1
    got = check.numbers(images, want.depth, want.stats, want,
                        check.reference_images(refs, want, checks), checks)
    assert got["color_px_off"] == 1
    assert sum(got.values()) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_fails_every_limit_it_should(cell):
    """The control at a size a test run holds: it fails the colour and,
    in the walk, the depth and the counters; the float32 reference
    against itself reads 0."""
    plan, traffic, refs = _plan(cell, 9)
    eyes = [plan.orbit.eye_at(f) for f in (0, 40, 90)]
    limits = traffic["checks"]
    low, failed, _ = check.compare(refs, plan, limits, eyes,
                                   control.bfloat16_frames(refs, plan, limits, "cpu"), "cpu")
    assert failed > 0
    assert low["color_px_off"] > limits["color_px_off"]
    for name in ("depth_px_off", "stats_off"):
        if name in limits:
            assert low[name] > limits[name]


def test_roofline_counts_three_triangles():
    """An 8x8 frame, w = 1 so NDC = clip: A (screen (0,0),(4,0),(0,4),
    z 0) tests its 5x5 bbox and wins the 10 centres with x + y <= 3; B is
    A wound backwards (rejected); C ((0,0),(8,0),(0,8), z 0.5, behind A)
    tests its bbox clamped to 8x8 and wins the 36 - 10 centres with
    x + y <= 7 that A does not."""
    def corner(sx, sy, z):
        return [sx / 4.0 - 1.0, sy / 4.0 - 1.0, z, 1.0]
    clip = torch.tensor([[corner(0, 0, 0), corner(4, 0, 0), corner(0, 4, 0)],
                         [corner(0, 0, 0), corner(0, 4, 0), corner(4, 0, 0)],
                         [corner(0, 0, .5), corner(8, 0, .5), corner(0, 8, .5)]])
    from rasterbench import geometry
    vp = torch.from_numpy(geometry.viewport(0, 0, 8, 8).astype(np.float32))
    setup = reference.triangle_setup(clip, vp, 8, 8)
    won, win_tri, work = reference.resolve(setup, torch.full((64,), math.inf), 8, 8)
    assert work == {"valid": 2, "tests": 25 + 64, "won": 36, "winning_triangles": 2,
                    "pixels": 64}
    assert int((win_tri == 0).sum()) == 10 and int((win_tri == 2).sum()) == 26
    roofline = BENCH.reader("raster_roofline_pct")
    work["varyings"] = 8
    ops = 89 * 25 + 36 * (34 + 6 * 8)
    n_bytes = 2 * 64 + 2 * 12 * 8 + 64 * 8
    assert roofline.pass_bound_s(work) == max(n_bytes / 3.35e12, ops / 67e12)


def test_serial_writes_counted_in_submission_order():
    """Three triangles over one pixel at depths 0.5, 0.7, 0.2: the serial
    z-test writes the first and the third."""
    def corner(sx, sy, z):
        return [sx / 2.0 - 1.0, sy / 2.0 - 1.0, z, 1.0]
    tri = lambda z: [corner(0, 0, z), corner(4, 0, z), corner(0, 4, z)]
    clip = torch.tensor([tri(0.5), tri(0.7), tri(0.2)])
    from rasterbench import geometry
    vp = torch.from_numpy(geometry.viewport(0, 0, 4, 4).astype(np.float32))
    setup = reference.triangle_setup(clip, vp, 4, 4)
    st = {"triangles_rasterized": 0, "fragments_drawn": 0, "min_x": 9, "min_y": 9,
          "max_x": -9, "max_y": -9, "min_z": math.inf, "max_z": -math.inf}
    won, win_tri, work = reference.resolve(setup, torch.full((16,), math.inf), 4, 4, st)
    covered = work["won"]
    assert set(win_tri.tolist()) == {2}
    assert st["fragments_drawn"] == 2 * covered
    assert st["triangles_rasterized"] == 3
    assert (st["min_z"], st["max_z"]) == (pytest.approx(0.2), 0.5)
