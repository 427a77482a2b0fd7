"""A configuration brings its own reference module, options and CPU
size as files: each is found by its name, the comparison takes the
reference the configuration names, and the existing configurations
keep their plans and the stock reference."""

import copy
import dataclasses
import hashlib
import json

import numpy as np
import pytest
from tiny_checkout import REPO, benchmark, cut, tiny_config, tiny_root  # noqa: F401

from rasterbench import catalog, check, control, reference, run, scenes

BENCH = benchmark()

#: ``fingerprint`` of the tiny plan of each existing configuration at
#: three seeds, as ``make_plan`` built them before ``Plan.options``
PLANS = {
    ("reference_main_1200x800", 7): (
        "c8f554a6b955cf14", 8422, 2213.5013674952797, 6056.837079418698, 83455.7196021899),
    ("reference_main_1200x800", 2**31 + 13): (
        "e6058de679c14f9e", 8422, 2192.5579521074683, 6086.385953190688, 82435.38832715119),
    ("reference_main_1200x800", 123456789): (
        "cbc5a02e157cd8cc", 8422, 2195.0959313809976, 6063.863824445685, 82558.67936517726),
    ("object_orbit_800", 7): (
        "62df11d83f6afce2", 1149, 355.0970486355245, 653.8690360943149, 12400.627446812645),
    ("object_orbit_800", 2**31 + 13): (
        "0532e2ffabaac8c1", 1149, 353.15660989005187, 657.234738516961, 12278.65450893183),
    ("object_orbit_800", 123456789): (
        "3ef3bfdcf045655b", 1149, 354.1549616478624, 653.102229463847, 12352.370452783483),
}


def fingerprint(plan) -> tuple:
    """Every field of ``plan`` but ``options``: the names, sizes, seeds,
    shaders and integer and byte arrays as a SHA-256 prefix; the float
    values by their count, sum, sum of magnitudes and a sum weighted by
    position."""
    exact, floats = hashlib.sha256(), []

    def walk(v):
        if dataclasses.is_dataclass(v):
            for f in dataclasses.fields(v):
                if f.name != "options":
                    exact.update(f.name.encode())
                    walk(getattr(v, f.name))
        elif isinstance(v, dict):
            for k in sorted(v):
                exact.update(str(k).encode())
                walk(v[k])
        elif isinstance(v, (list, tuple)):
            exact.update(b"[%d" % len(v))
            for x in v:
                walk(x)
        elif isinstance(v, np.ndarray):
            exact.update(f"{v.dtype}{v.shape}".encode())
            if v.dtype.kind == "f":
                floats.append(v.ravel().astype(np.float64))
            else:
                exact.update(np.ascontiguousarray(v).tobytes())
        elif isinstance(v, float):
            floats.append(np.array([v], dtype=np.float64))
        else:
            exact.update(repr(v.item() if isinstance(v, np.generic) else v).encode())
    walk(plan)
    x = np.concatenate(floats)
    weights = np.arange(x.size) % 97 + 1
    return (exact.hexdigest()[:16], int(x.size), float(x.sum()), float(np.abs(x).sum()),
            float(x @ weights))


@pytest.mark.parametrize("name,seed", list(PLANS), ids=lambda v: str(v))
def test_existing_configurations_keep_their_plan_and_the_stock_reference(name, seed):
    cell = next(w for w in BENCH.spec["workloads"] if w["config"] == name)
    config = tiny_config(BENCH.config(name))
    plan = scenes.make_plan(config, BENCH.traffic(cell["traffic"]), seed)
    digest, n, *sums = fingerprint(plan)
    want_digest, want_n, *want_sums = PLANS[name, seed]
    assert (digest, n) == (want_digest, want_n)
    scale = 97 * want_sums[1]
    assert sums == pytest.approx(want_sums, rel=1e-12, abs=1e-12 * scale)
    assert plan.options == {k: v for k, v in config.items() if k not in scenes.READ}
    config["assumed"].append("edited after the plan was made")
    assert plan.options["assumed"] != config["assumed"]
    found = BENCH.reference(config.get("reference"))
    assert found is reference and found.__file__.endswith("rasterbench/reference.py")


#: the test configuration's route: the image route's colour, flipped on
#: the axis its configuration's ``flip`` block names
ROUTE = """
def outputs(plan):
    return {"color": (plan.height, plan.width, 3)}


def frame(loop, spans):
    color = loop.scene.render_image(loop.device, frustum_cull=loop.plan.frustum_cull,
                                    backend=loop.traffic["backend"])
    loop.render_done(spans)
    return {"color": color.flip(loop.plan.options["flip"]["axis"])}, None, None
"""

#: the test configuration's reference module: the stock frame, its
#: colour flipped as the route flips it
FLIPPED = """
from rasterbench import reference
from rasterbench.reference import post  # noqa: F401


class Reference(reference.Reference):
    def render(self, eye, stats=False):
        frame = super().render(eye, stats)
        frame.color = frame.color.flip(self.plan.options["flip"]["axis"])
        return frame
"""
FLIP_LINE = '        frame.color = frame.color.flip(self.plan.options["flip"]["axis"])\n'
CELL = "object_orbit_flip.flip"


@pytest.fixture
def flip_root(tiny_root):
    """``tiny_root`` with a configuration added as files and entries
    only: its full-size file with a ``"reference"``, a ``flip`` block and
    a ``"tiny"`` block, its reference module, a traffic mix and a route,
    then ``cut`` as the checkout cuts every configuration."""
    files = tiny_root / "rasterbench"
    config = json.loads((REPO / "rasterbench/configs/object_orbit_800.json").read_text())
    config.update(name="object_orbit_flip", reference="flipped", flip={"axis": 0},
                  tiny={"size": [48, 40], "passes": {"0": [{"n_lat": 10, "n_lon": 14}, 16]}})
    (files / "configs/object_orbit_flip.json").write_text(json.dumps(config))
    (files / "references").mkdir(exist_ok=True)
    (files / "references/flipped.py").write_text(FLIPPED)
    traffic = json.loads((REPO / "rasterbench/traffic/host.json").read_text())
    traffic["route"] = "render_flipped"
    (files / "traffic/flip.json").write_text(json.dumps(traffic))
    (files / "routes/render_flipped.py").write_text(ROUTE)
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "object_orbit_flip", "source": "https://example.org",
                             "file": "rasterbench/configs/object_orbit_flip.json",
                             "reduced": [], "why": "the orbit, flipped by its own reference"})
    bench["workloads"].append({"name": CELL, "config": "object_orbit_flip", "traffic": "flip",
                               "chips": 1, "why": "a flipped colour"})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cut(tiny_root)
    return tiny_root


def _run(root, capsys, trace=False):
    assert run.execute(root, CELL, 2**31 + 17, 0.4, trace, "cpu") == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_own_reference_options_and_tiny_block_run_end_to_end(flip_root, trace, capsys):
    found = catalog.Benchmark(flip_root)
    config = found.config("object_orbit_flip")
    assert (config["width"], config["height"]) == (48, 40)
    assert config["passes"][0]["mesh"]["n_lat"] == 10
    assert config["passes"][0]["material"]["size"] == 16
    plan = scenes.make_plan(config, found.traffic("flip"), 3)
    assert plan.options["flip"] == {"axis": 0} and plan.options["reference"] == "flipped"
    assert found.reference("flipped").__file__.endswith("references/flipped.py")
    result = _run(flip_root, capsys, trace)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert result["checks"]["color_px_off"]["value"] == 0


def _stock_reference(root):
    path = root / "rasterbench/configs/object_orbit_flip.json"
    config = json.loads(path.read_text())
    del config["reference"]
    path.write_text(json.dumps(config))


def _flip_removed(root):
    path = root / "rasterbench/references/flipped.py"
    path.write_text(path.read_text().replace(FLIP_LINE, ""))


@pytest.mark.parametrize("fault", [_stock_reference, _flip_removed],
                         ids=["stock_reference", "flip_removed"])
def test_the_configurations_reference_decides_correct(flip_root, fault, capsys):
    fault(flip_root)
    result = _run(flip_root, capsys)
    assert result["correct"] is False and result["failed"] > 0
    assert result["checks"]["color_px_off"]["value"] > 0


def test_the_control_takes_the_configurations_reference(flip_root):
    seed = 2**31 + 19
    got = control.readings(flip_root, CELL, seed, 0.3, "cpu")
    assert got["program_failed"] == 0 and got["program"] == {"color_px_off": 0}
    found = catalog.Benchmark(flip_root)
    traffic = found.traffic("flip")
    plan = scenes.make_plan(found.config("object_orbit_flip"), traffic, seed)
    eyes = [plan.orbit.eye_at(f) for f in got["sampled"]]
    flipped, checks = found.reference("flipped"), traffic["checks"]

    def control_of(low):
        return check.compare(flipped, plan, checks, eyes,
                             control.bfloat16_frames(low, plan, checks, "cpu"), "cpu")[0]
    assert got["control"] == control_of(flipped) != control_of(reference)
    assert got["control"]["color_px_off"] > 0


def test_a_configuration_without_a_tiny_size_names_the_block():
    config = copy.deepcopy(BENCH.config("object_orbit_800"))
    config["name"] = "object_orbit_untold"
    with pytest.raises(ValueError, match='"tiny" block'):
        tiny_config(config)
