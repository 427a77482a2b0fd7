"""A checkout-like directory with the benchmark's files, its
configurations cut to a size the CPU renders in milliseconds.  The test
modules import it first: it also puts the repository on ``sys.path``."""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: config -> its tiny size: the frame's (width, height) and, by pass
#: index, the mesh keys and material size.  A configuration not named
#: here brings the same in a ``"tiny"`` block of its own file (pass
#: indices as strings), which ``scenes.make_plan`` leaves to
#: ``Plan.options``.
TINY = {
    "reference_main_1200x800": {"size": (96, 64), "passes": {
        0: ({"grid": 2, "n_lat": 10, "n_lon": 14}, 16), 1: ({"n_lat": 12, "n_lon": 16}, 32)}},
    "object_orbit_800": {"size": (64, 64), "passes": {
        0: ({"n_lat": 12, "n_lon": 16}, 32)}},
}


#: a cell whose files the benchmark keeps but leaves out of
#: BENCHMARK.json, as its runs spread too widely for a bound (PERF.md,
#: Open questions): the tests run it as a cell all the same
LATER = {
    "config": {"name": "object_orbit_800", "source": "https://arxiv.org/abs/2003.08934",
               "file": "rasterbench/configs/object_orbit_800.json", "reduced": [],
               "why": "a view dataset: one 27k-face object on the single-pass image route"},
    "workload": {"name": "object_orbit_800.host", "config": "object_orbit_800",
                 "traffic": "host", "chips": 1,
                 "why": "800x800, one 27k-face pass, 200 views a turn, colour to pinned host"},
    "per_layer": ("frame_mean_ms", "render_ms", "readback_wait_ms", "raster_roofline_pct",
                  "device_idle_pct", "kernels_per_frame"),
}


def full_spec(spec: dict) -> dict:
    """``BENCHMARK.json``'s content with the ``LATER`` cell added."""
    spec = copy.deepcopy(spec)
    spec["configs"].append(dict(LATER["config"]))
    spec["workloads"].append(dict(LATER["workload"]))
    for m in spec["per_layer"]:
        if m["name"] in LATER["per_layer"]:
            m["workloads"].append(LATER["workload"]["name"])
    return spec


def benchmark():
    """The repository's ``catalog.Benchmark`` with the ``LATER`` cell."""
    from rasterbench import catalog
    bench = catalog.Benchmark(REPO)
    bench.spec = full_spec(bench.spec)
    return bench


def tiny_config(config: dict) -> dict:
    """``config`` cut to its tiny size: ``TINY``'s entry, else the
    configuration's own ``"tiny"`` block."""
    tiny = TINY.get(config["name"], config.get("tiny"))
    if tiny is None:
        raise ValueError(f"configuration {config['name']!r} has no \"tiny\" block and no "
                         "TINY entry: add a \"tiny\" block (size, and per pass index its "
                         "mesh keys and material size) to its file")
    config["width"], config["height"] = tiny["size"]
    for i, (mesh, size) in tiny["passes"].items():
        config["passes"][int(i)]["mesh"].update(mesh)
        config["passes"][int(i)]["material"]["size"] = size
    return config


def cut(root: Path) -> None:
    """Cut, in place, each configuration file under ``root`` to its tiny
    size and each traffic mix's warm-up and profiled frames to a few."""
    for path in (root / "rasterbench" / "configs").glob("*.json"):
        path.write_text(json.dumps(tiny_config(json.loads(path.read_text()))))
    for path in (root / "rasterbench" / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t["warmup_frames"], t["trace_frames"] = 2, 3
        path.write_text(json.dumps(t))


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of BENCHMARK.json (with the ``LATER`` cell) and
    rasterbench/'s data, route, reference and metric files, ``cut``."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "rasterbench", root / "rasterbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = full_spec(json.loads((REPO / "BENCHMARK.json").read_text()))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cut(root)
    return root
