"""Every part BENCHMARK.json names is found by its name, and a part
added as files is found without an edit to the harness."""

import json

import pytest
from tiny_checkout import benchmark, tiny_root  # noqa: F401  (a fixture)

from rasterbench import catalog, run, scenes

BENCH = benchmark()
METRICS = [(m, False) for m in BENCH.spec["end_to_end"]] + \
          [(m, True) for m in BENCH.spec["per_layer"]]


@pytest.mark.parametrize("cell", BENCH.spec["workloads"], ids=lambda c: c["name"])
def test_cell_parts_found_and_parsed(cell):
    config = BENCH.config(cell["config"])
    traffic = BENCH.traffic(cell["traffic"])
    assert config["name"] == cell["config"]
    entry = next(c for c in BENCH.spec["configs"] if c["name"] == cell["config"])
    assert config["reduced"] == entry["reduced"]
    assert set(config["faces"]) == {p["name"] for p in config["passes"]}
    plan = scenes.make_plan(config, traffic, seed=5)
    assert {p.name: p.mesh.nfaces for p in plan.passes} == config["faces"]
    assert set(traffic["checks"]) and all(v == 0 for v in traffic["checks"].values())
    names = {m["name"] for m in BENCH.metrics(cell, per_layer=False)}
    assert "setup_s" in names and len(names) >= 2
    assert BENCH.metrics(cell, per_layer=True)


@pytest.mark.parametrize("entry,per_layer", METRICS, ids=lambda m: getattr(m, "get", str)("name"))
def test_metric_module_matches_its_entry(entry, per_layer):
    reader = BENCH.reader(entry["name"])
    assert reader.UNIT == entry["unit"]
    assert callable(reader.read)
    if per_layer:
        assert reader.LAYER == entry["layer"]
        assert reader.MOVES == entry["moves"]
    else:
        assert reader.LAYER is None and reader.MOVES == entry["name"]


#: a route added as a file: the full render, the colour alone delivered,
#: every frame it renders counted in a span of its own
ROUTE = """
def outputs(plan):
    return {"color": (plan.height, plan.width, 3)}


def frame(loop, spans):
    res = loop.scene.render(loop.device, frustum_cull=loop.plan.frustum_cull,
                            backend=loop.traffic["backend"])
    loop.render_done(spans)
    if spans is not None:
        spans["route_frames"].append(1)
    return {"color": res.color}, None, None
"""


def test_parts_added_as_files_are_found(tiny_root, capsys):
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    config = json.loads((tiny_root / "rasterbench/configs/object_orbit_800.json").read_text())
    config["name"] = "object_orbit_640"
    config["width"] = config["height"] = 40
    (tiny_root / "rasterbench/configs/object_orbit_640.json").write_text(json.dumps(config))
    traffic = json.loads((tiny_root / "rasterbench/traffic/host.json").read_text())
    traffic["views_per_revolution"] = 120
    traffic["route"] = "render_color"
    (tiny_root / "rasterbench/traffic/slow_orbit.json").write_text(json.dumps(traffic))
    (tiny_root / "rasterbench/routes/render_color.py").write_text(ROUTE)
    (tiny_root / "rasterbench/metrics/frames_seen.py").write_text(
        'UNIT = "frames"\nLAYER = "frame loop"\nMOVES = "frame_p95_ms"\n\n\n'
        'def read(data):\n    return len(data.window.spans.get("route_frames", []))\n')
    bench["configs"].append({"name": "object_orbit_640", "source": "https://example.org",
                             "file": "rasterbench/configs/object_orbit_640.json",
                             "reduced": [], "why": "a smaller frame"})
    bench["workloads"].append({"name": "object_orbit_640.slow_orbit",
                               "config": "object_orbit_640", "traffic": "slow_orbit",
                               "chips": 1, "why": "slower orbit"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "frame loop",
                               "moves": "frame_p95_ms",
                               "workloads": ["object_orbit_640.slow_orbit"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))

    found = catalog.Benchmark(tiny_root)
    cell = found.cell("object_orbit_640.slow_orbit")
    assert found.config(cell["config"])["width"] == 40
    assert found.traffic(cell["traffic"])["views_per_revolution"] == 120
    assert [m["name"] for m in found.metrics(cell, per_layer=True)][-1] == "frames_seen"
    assert found.reader("frames_seen").UNIT == "frames"
    assert found.route("render_color").outputs(scenes.make_plan(
        found.config(cell["config"]), found.traffic(cell["traffic"]), 3))["color"] == (40, 40, 3)

    assert run.execute(tiny_root, cell["name"], 2**31 + 3, 0.4, True, "cpu") == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["frames_seen"]["value"] == result["attempted"] > 0
