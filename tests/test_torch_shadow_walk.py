"""The shadow-mapped frame on ``Scene.render`` against the benchmark's
plain reference of it (``rasterbench/references/shadow_mapping.py``),
on the CPU at the configuration ``reference_main_shadows_1200x800``'s
own tiny size with a 128² map, three seeds, two views each:

(a) ``Scene.render(shadows=...)`` equals the reference bitwise in
    colour, output depth and stats, its map equals the reference's light
    pass, and both equal ``oracle_render_with_shadows``;
    ``Scene.render(shadows=...)`` equals ``render_with_shadows``;
(b) what the comparison has to see: the reference without its shadow
    test differs from the port, and the sun turns the map;
(c) the tracing: one shadowed frame is one frame record with the light
    pass under ``shadow.light``, the four shadow caches' counters, and the
    benchmark's three readers of them on synthetic records."""

from __future__ import annotations

import json
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_parity  # noqa: F401  (one torch thread per test worker)
from rasterbench import catalog, check, reference, scenes
from tinyrenderder_tpu_torch import shadows, trace
from tinyrenderder_tpu_torch.ops import post
from tinyrenderder_tpu_torch.shaders import EyeShader, PhongShader

ROOT = Path(__file__).resolve().parent.parent
BENCH = catalog.Benchmark(ROOT)
CONFIG = "reference_main_shadows_1200x800"
CELL = "reference_main_shadows_1200x800.sun_walk"
CPU = "cpu"
S = 128
SEEDS = (3, 2**31 + 29, 123456789)
VIEWS = (0, 131)
CHECKS = {"color_px_off": 0, "depth_px_off": 0, "stats_off": 0}
REFERENCE = BENCH.reference(BENCH.config(CONFIG)["reference"])


def tiny_plan(seed: int, size: int = S):
    """The configuration at its ``"tiny"`` size, with an S x S map."""
    config = BENCH.config(CONFIG)
    tiny = config["tiny"]
    config["width"], config["height"] = tiny["size"]
    for i, (mesh, side) in tiny["passes"].items():
        config["passes"][int(i)]["mesh"].update(mesh)
        config["passes"][int(i)]["material"]["size"] = side
    config["shadows"]["size"] = size
    return scenes.make_plan(config, BENCH.traffic("sun_walk"), seed)


def settings_of(plan) -> shadows.ShadowSettings:
    o = plan.options["shadows"]
    return shadows.ShadowSettings(size=o["size"], fov_margin=o["fov_margin"],
                                  distance_factor=o["distance_factor"])


def turn(scene, plan, view: int) -> np.ndarray:
    """Set the scene's eye to ``view`` of the orbit and its key light to
    the sun there, as the benchmark's route does; -> the sun."""
    scene.camera.set_eye(plan.orbit.eye_at(view))
    sun = REFERENCE.sun(plan, scene.camera.params.eye)
    for p in scene.passes:
        if isinstance(p.shader, (PhongShader, EyeShader)):
            p.shader.key_light_world = sun
    return sun


def stats_of(res) -> dict:
    return {f: getattr(res.stats, f) for f in check.STATS_FIELDS}


def same(a, b) -> bool:
    a, b = torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b))
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


@pytest.fixture(scope="module", params=SEEDS, ids=lambda s: f"seed{s}")
def frames(request):
    """Per view of one seed: the port's frame by ``Scene.render``, its
    frame and map by ``render_with_shadows``, the oracle's, and the
    reference's frame and map."""
    plan = tiny_plan(request.param)
    scene = scenes.port_scene(plan)
    ref = REFERENCE.Reference(plan, CPU)
    out = {}
    for view in VIEWS:
        sun = turn(scene, plan, view)
        st = settings_of(plan)
        res = scene.render(CPU, shadows=(sun, st))
        pair = shadows.render_with_shadows(scene, sun, st, CPU)
        oracle = shadows.oracle_render_with_shadows(scene, sun, st)
        frame = ref.render(plan.orbit.eye_at(view), stats=True)
        out[view] = SimpleNamespace(res=res, pair=pair, oracle=oracle, ref=frame,
                                    ref_map=ref.shadow[1], plan=plan)
    return out


@pytest.mark.parametrize("view", VIEWS)
def test_frame_equals_the_reference(frames, view):
    f = frames[view]
    got = check.numbers({"color": f.res.color}, f.res.depth, f.res.stats, f.ref,
                        {"color": f.ref.color}, CHECKS)
    assert got == {n: 0 for n in CHECKS}
    assert [w["pass"] for w in f.ref.work][0] == "light"
    assert [w["varyings"] for w in f.ref.work] == [0, 11, 11, 8][:len(f.ref.work)]


@pytest.mark.parametrize("view", VIEWS)
def test_map_equals_the_references_light_pass(frames, view):
    f = frames[view]
    smap = f.pair[1]
    assert smap.shape == (S, S) and same(smap, f.ref_map)
    assert 0 < int(torch.isfinite(smap).sum()) < S * S


@pytest.mark.parametrize("view", VIEWS)
def test_map_and_frame_equal_the_oracle(frames, view):
    f = frames[view]
    ores, omap = f.oracle
    assert same(f.pair[1], omap)
    for plane in ("color", "depth", "full_depth"):
        assert same(getattr(f.res, plane), getattr(ores, plane)), plane
    assert stats_of(f.res) == stats_of(ores)


@pytest.mark.parametrize("view", VIEWS)
def test_scene_render_equals_render_with_shadows(frames, view):
    f = frames[view]
    res, _ = f.pair
    for plane in ("color", "depth", "full_depth"):
        assert same(getattr(f.res, plane), getattr(res, plane)), plane
    assert stats_of(f.res) == stats_of(res)


def test_the_oracle_backend_takes_the_shadows():
    plan = tiny_plan(SEEDS[0])
    scene = scenes.port_scene(plan)
    sun = turn(scene, plan, VIEWS[1])
    res = scene.render(CPU, backend="oracle", shadows=(sun, settings_of(plan)))
    ores, _ = shadows.oracle_render_with_shadows(scene, sun, settings_of(plan))
    assert same(res.color, ores.color) and same(res.depth, ores.depth)
    with pytest.raises(ValueError, match="float32"):
        scene.render(CPU, dtype=np.float64, shadows=(sun, None))


def test_no_shadows_is_the_unshadowed_frame():
    plan = tiny_plan(SEEDS[0])
    scene = scenes.port_scene(plan)
    scene.camera.set_eye(plan.orbit.eye_at(VIEWS[1]))
    frame = reference.Reference(plan, CPU).render(plan.orbit.eye_at(VIEWS[1]), stats=True)
    res = scene.render(CPU, shadows=None)
    got = check.numbers({"color": res.color}, res.depth, res.stats, frame,
                        {"color": frame.color}, CHECKS)
    assert got == {n: 0 for n in CHECKS}


# ---------------------------------------------------------------------------
# (b) what the comparison sees
# ---------------------------------------------------------------------------

def test_a_reference_without_the_shadow_test_differs(frames, monkeypatch):
    monkeypatch.setattr(REFERENCE, "shadow_factor",
                        lambda u_, vary: torch.ones_like(vary["uv"][..., 0]))
    for view, f in frames.items():
        lit = REFERENCE.Reference(f.plan, CPU).render(f.plan.orbit.eye_at(view))
        assert int((lit.color != f.res.color).any(-1).sum()) > 0


def test_the_sun_turns_the_map(frames):
    a, b = (frames[v].pair[1] for v in VIEWS)
    assert not same(a, b)


def test_the_configured_eye_gives_the_key_light():
    plan = tiny_plan(SEEDS[0])
    key = plan.lights[plan.options["shadows"]["light"]]
    assert np.array_equal(REFERENCE.sun(plan, np.asarray(plan.camera["eye"])), key)
    turned = REFERENCE.sun(plan, plan.orbit.eye_at(0))
    assert turned[1] == pytest.approx(key[1], abs=1e-15)
    assert math.hypot(turned[0], turned[2]) == pytest.approx(math.hypot(key[0], key[2]))


# ---------------------------------------------------------------------------
# (c) tracing
# ---------------------------------------------------------------------------

@pytest.fixture
def walk():
    """A tiny scene of the configuration, warmed, and its frame function
    (the route's: the sun turned, ``Scene.render(shadows=...)``, the
    post)."""
    plan = tiny_plan(SEEDS[1])
    scene = scenes.port_scene(plan)
    views = iter(range(0, 360, 7))

    def frame(view=None):
        sun = turn(scene, plan, next(views) if view is None else view)
        res = scene.render(CPU, shadows=(sun, settings_of(plan)))
        post.postprocess(res.color, res.depth)
        return res
    frame()
    trace.clear()
    yield frame
    trace.clear()


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _ancestors(span):
    out = []
    while span.parent is not None:
        span = span.parent
        out.append(span.name)
    return out


def test_a_shadowed_frame_is_one_frame_record(walk):
    _traced(lambda: [walk() for _ in range(2)])
    recs = trace.frames()
    assert len(recs) == 2
    for rec in recs:
        assert [s.name for s in rec.spans if s.parent is None] == ["frame", "post"]
        assert all(s.frame == rec.id for s in rec.spans)
        (light,) = [s for s in rec.spans if s.name == "shadow.light"]
        (lit,) = [s for s in rec.spans if s.name == "shadow.lit"]
        assert light.parent.name == lit.parent.name == "frame" and light.end <= lit.start
        passes = [s for s in rec.spans if s.name == "pass"]
        assert [s.arg for s in passes] == ["lightdepth", "sponza", "head", "eyes"]
        assert "shadow.light" in _ancestors(passes[0])
        assert all(s.parent.name == "frame" for s in passes[1:])
        for name in ("frame.cull", "frame.inputs", "readback"):
            under = [s for s in rec.spans if s.name == name and "shadow.light" in _ancestors(s)]
            assert under, name
        assert sum(s.name == "readback" for s in rec.spans) == rec.counts["readback"] == 10
    # nothing of the second frame lies in the first frame's record
    assert [s.arg for s in recs[0].spans if s.name == "pass"].count("lightdepth") == 1


CACHES = ("shadow_cam", "shadow_merged", "shadow_depth", "shadow_lit")


def _cache_counts():
    c = trace.counts()
    return ({n: c[f"cache.{n}.hit"] for n in CACHES}, {n: c[f"cache.{n}.miss"] for n in CACHES})


def test_a_fixed_light_hits_every_shadow_cache_and_a_turned_one_misses_three(walk):
    walk(view=40)
    trace.reset_counts()
    walk(view=40)
    hits, misses = _cache_counts()
    assert hits == {n: 1 for n in CACHES} and misses == {n: 0 for n in CACHES}
    trace.reset_counts()
    walk(view=41)
    hits, misses = _cache_counts()
    assert misses == {"shadow_cam": 1, "shadow_merged": 0, "shadow_depth": 1, "shadow_lit": 1}
    assert hits == {"shadow_cam": 0, "shadow_merged": 1, "shadow_depth": 0, "shadow_lit": 0}


def test_the_lit_scene_sees_a_rebound_phong_light(walk):
    """The lit scene's shadowed shaders copy the Phong lights: a rebound
    key light with the shadow light unchanged is a miss, not a stale
    frame."""
    plan = tiny_plan(SEEDS[1])
    scene = scenes.port_scene(plan)
    sun = turn(scene, plan, 50)
    st = settings_of(plan)
    scene.render(CPU, shadows=(sun, st))
    for p in scene.passes:
        if isinstance(p.shader, PhongShader):
            p.shader.key_light_world = np.array([0.0, 1.0, 0.0])
    trace.reset_counts()
    res = scene.render(CPU, shadows=(sun, st))
    assert trace.counts()["cache.shadow_lit.miss"] == 1
    fresh = scenes.port_scene(plan)
    fresh.camera.set_eye(scene.camera.params.eye)
    for p, q in zip(fresh.passes, scene.passes):
        p.shader.key_light_world = q.shader.key_light_world
    assert same(res.color, fresh.render(CPU, shadows=(sun, st)).color)


def test_the_readers_on_a_profiled_cpu_frame(walk):
    _traced(lambda: [walk() for _ in range(2)])
    data = _data(frames=2)
    assert _reader("shadow_light_ms").read(data) > 0
    assert _reader("shadow_cache_misses_per_frame").read(data) == 3


# the readers on synthetic records

def _reader(name):
    return BENCH.reader(name)


def _data(frames=2, device=None, work=None):
    t = SimpleNamespace(frames=frames, device=device or [])
    return SimpleNamespace(window=SimpleNamespace(trace=t), work=work)


def _span(rec, name, start_us, end_us, parent=None, arg=None):
    s = trace.Span(name, arg)
    s.start, s.end = int(start_us * 1000), int(end_us * 1000)
    s.parent, s.frame = parent, rec.id
    rec.spans.append(s)
    return s


def synthetic_shadow_frame(frame_id=0, shift_us=0.0):
    """frame [1000, 3000] us: shadow.light [1000, 1600] (its pass [1100,
    1500]: pre [1100, 1200] with a readback [1150, 1200], raster [1200,
    1300], a launch stamp at 1210), shadow.lit [1600, 1650], the lit pass
    [1700, 2900] (pre [1700, 1900] with a readback [1800, 1850], raster
    [1900, 2000], a stamp at 1910); cache misses 3, hits 1."""
    rec = trace.FrameRecord(frame_id)
    t = lambda us: us + shift_us  # noqa: E731
    f = _span(rec, "frame", t(1000), t(3000))
    light = _span(rec, "shadow.light", t(1000), t(1600), f)
    lp = _span(rec, "pass", t(1100), t(1500), light, "lightdepth")
    lpre = _span(rec, "pass.pre", t(1100), t(1200), lp)
    _span(rec, "readback", t(1150), t(1200), lpre)
    lr = _span(rec, "pass.raster", t(1200), t(1300), lp)
    _span(rec, "shadow.lit", t(1600), t(1650), f)
    p = _span(rec, "pass", t(1700), t(2900), f, "sponza")
    pre = _span(rec, "pass.pre", t(1700), t(1900), p)
    _span(rec, "readback", t(1800), t(1850), pre)
    r = _span(rec, "pass.raster", t(1900), t(2000), p)
    rec.stamps = [("launch.coarse_raster", int(t(1210) * 1000), lr),
                  ("launch.coarse_raster_stats", int(t(1910) * 1000), r)]
    rec.counts.update({"cache.shadow_cam.miss": 1, "cache.shadow_depth.miss": 1,
                       "cache.shadow_lit.miss": 1, "cache.shadow_merged.hit": 1})
    return rec


#: device = host + OFFSET; each walk starts 5 us after its stamp.  The
#: light pass's merge starts after its span has closed (1650), before the
#: lit pass's readback ends (1850): it counts; the lit pass's kernels and
#: an elementwise kernel do not
OFFSET = -700.0


def synthetic_device(shift_us=0.0):
    d = lambda us: us + shift_us + OFFSET  # noqa: E731
    return [("void trt::item_scan_kernel<32>(int*)", d(1212), d(1215)),
            ("void trt::coarse_walk_kernel<16, false>(Coarse)", d(1215), d(1255)),
            ("void trt::coarse_merge_kernel<16>(Coarse)", d(1650), d(1670)),
            ("void at::elementwise_kernel<float>(...)", d(1300), d(1400)),
            ("void trt::item_scan_kernel<32>(int*)", d(1912), d(1915)),
            ("void trt::coarse_walk_kernel<16, true>(Coarse)", d(1915), d(1990)),
            ("void trt::coarse_events_kernel<16>(Coarse)", d(1990), d(2010))]


LIGHT_WORK = {"pass": "light", "valid": 1000, "tests": 50000, "won": 20000,
              "winning_triangles": 900, "pixels": 16384, "varyings": 0}
LIT_WORK = dict(LIGHT_WORK, **{"pass": "sponza", "varyings": 11})


@pytest.fixture
def shadow_frames(monkeypatch):
    recs = [synthetic_shadow_frame(i, shift_us=5000.0 * i) for i in range(3)]
    monkeypatch.setattr(trace, "_RING", type(trace._RING)(recs, maxlen=trace.FRAMES))
    return recs


def test_shadow_readers_on_synthetic_frames(shadow_frames):
    assert _reader("shadow_light_ms").read(_data()) == pytest.approx(0.6)
    assert _reader("shadow_cache_misses_per_frame").read(_data()) == 3
    device = synthetic_device(5000.0) + synthetic_device(10000.0)
    work = [[LIGHT_WORK, LIT_WORK]] * 2
    bound = BENCH.reader("raster_roofline_pct").pass_bound_s(LIGHT_WORK)
    want = 100.0 * 2 * bound / (2 * (3 + 40 + 20) / 1e6)
    got = _reader("shadow_light_roofline_pct").read(_data(device=device, work=work))
    assert got == pytest.approx(want)


SHADOW_READERS = ("shadow_light_ms", "shadow_light_roofline_pct",
                  "shadow_cache_misses_per_frame")


@pytest.mark.parametrize("name", SHADOW_READERS)
def test_shadow_reader_without_shadow_spans_is_none(name, monkeypatch):
    recs = [synthetic_shadow_frame(i, shift_us=5000.0 * i) for i in range(3)]
    for rec in recs:                # a program without the shadow spans
        rec.spans = [s for s in rec.spans if not s.name.startswith("shadow.")]
    monkeypatch.setattr(trace, "_RING", type(trace._RING)(recs, maxlen=trace.FRAMES))
    device = synthetic_device(5000.0) + synthetic_device(10000.0)
    assert _reader(name).read(_data(device=device, work=[[LIGHT_WORK, LIT_WORK]] * 2)) is None
    monkeypatch.setattr(trace, "_RING", type(trace._RING)([], maxlen=trace.FRAMES))
    assert _reader(name).read(_data(work=[[LIGHT_WORK]] * 2)) is None
    assert _reader(name).read(SimpleNamespace(window=SimpleNamespace(trace=None),
                                              work=None)) is None


@pytest.mark.parametrize("name", SHADOW_READERS)
def test_shadow_reader_entry_in_the_benchmark(name):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == name)
    reader = _reader(name)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"],
                                                         entry["moves"])
    assert entry["workloads"] == [CELL]
