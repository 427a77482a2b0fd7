"""Each cell end to end at the tiny size on the CPU (the program's plain
versions), the faults that the comparison has to catch, the check of
the loaded modules and the refusal to run without a card."""

import json

import pytest
import torch
from tiny_checkout import benchmark, tiny_root  # noqa: F401  (a fixture)

from rasterbench import run, scenes

BENCH = benchmark()
CELLS = [w["name"] for w in BENCH.spec["workloads"]]
#: the cells with a pass excluded from the output depth (main.cpp:700,730)
EXCLUDING = [w["name"] for w in BENCH.spec["workloads"]
             if any(p.get("exclude_from_output_depth")
                    for p in BENCH.config(w["config"])["passes"])]
RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(root, cell, capsys, trace=False, seed=2**31 + 11):
    rc = run.execute(root, cell, seed, 0.6, trace, "cpu")
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_prints_the_result_line(tiny_root, cell, trace, capsys):
    rc, result, err = _run(tiny_root, cell, capsys, trace)
    assert rc == 0
    assert RESULT_KEYS <= set(result) and list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    assert err.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert {"render_ms", "frame_mean_ms"} <= set(result["metrics"])
        assert "frame_p95_ms" not in result["metrics"]
    else:
        assert {"frame_p95_ms", "setup_s"} == set(result["metrics"])
        m = result["metrics"]
        assert m["frame_p95_ms"]["value"] > 0 and m["setup_s"]["unit"] == "s"


def _stale(monkeypatch):
    from tinyrenderder_tpu_torch import scene
    first = {}
    for name in ("render", "render_image"):
        real = getattr(scene.Scene, name)

        def once(self, *a, _real=real, _name=name, **k):
            if _name not in first:
                first[_name] = _real(self, *a, **k)
            return first[_name]
        monkeypatch.setattr(scene.Scene, name, once)


def _half_faces(monkeypatch):
    from tinyrenderder_tpu_torch.models import mesh
    real = mesh.Mesh.device_face_attributes

    def half(self, *a, **k):
        attrs = real(self, *a, **k)
        return {n: t[: t.shape[0] // 2] for n, t in attrs.items()}
    monkeypatch.setattr(mesh.Mesh, "device_face_attributes", half)


def _altered_pixel(monkeypatch):
    from tinyrenderder_tpu_torch import scene

    def bump(color):
        color = color.clone()
        h, w = color.shape[:2]
        color[h // 2, w // 2, 1] += 1
        return color
    real_render, real_image = scene.Scene.render, scene.Scene.render_image

    def render(self, *a, **k):
        res = real_render(self, *a, **k)
        res.color = bump(res.color)
        return res
    monkeypatch.setattr(scene.Scene, "render", render)
    monkeypatch.setattr(scene.Scene, "render_image",
                        lambda self, *a, **k: bump(real_image(self, *a, **k)))


@pytest.mark.parametrize("fault", [_stale, _half_faces, _altered_pixel],
                         ids=["state_unchanged", "half_the_faces", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(tiny_root, cell, fault, monkeypatch, capsys):
    fault(monkeypatch)
    rc, result, _ = _run(tiny_root, cell, capsys)
    assert rc == 0
    assert result["correct"] is False and result["failed"] > 0
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def _restore_skipped(monkeypatch):
    """The program draws the excluded passes into the output depth: no
    snapshot before them and no restore after."""
    real = scenes.port_scene

    def port_scene(plan):
        scene = real(plan)
        for p in scene.passes:
            p.exclude_from_output_depth = False
        return scene
    monkeypatch.setattr(scenes, "port_scene", port_scene)


@pytest.mark.parametrize("cell", EXCLUDING)
def test_a_skipped_depth_restore_is_not_correct(tiny_root, cell, monkeypatch, capsys):
    _restore_skipped(monkeypatch)
    rc, result, _ = _run(tiny_root, cell, capsys)
    assert rc == 0
    assert result["correct"] is False and result["failed"] > 0
    assert result["checks"]["depth_px_off"]["value"] > 0


@pytest.mark.parametrize("loaded,found", [
    (["tinyrenderder_tpu_torch", "tinyrenderder_tpu_torch.ops.post", "torch"], []),
    (["jax", "torch"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["tinyrenderder_tpu.ops.raster", "tinyrenderder_tpu_torch"], ["tinyrenderder_tpu"]),
    (["jax_extra", "tinyrenderder_tpu_extra"], []),
])
def test_forbidden_modules_by_whole_top_level_name(loaded, found):
    assert run.forbidden_modules(loaded) == found


def test_no_card_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the refusal is for hosts without one")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"])
    out, err = capsys.readouterr()
    assert rc != 0 and out == "" and "CUDA" in err
