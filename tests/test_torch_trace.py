"""The port's trace module (``tinyrenderder_tpu_torch.trace``) on the CPU:
spans only while a ``torch.profiler`` session is active, their nesting
and frame ids over a 3-pass frame with stats and its post, the counters
(launches, readbacks, caches), ``pass_timings`` without a synchronize,
the alignment of spans with a device trace, and the benchmark's readers
of the spans (``rasterbench/metrics``) on synthetic runs."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torch_parity import frame_scene
from tinyrenderder_tpu_torch import animation, cli, convert, trace
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.ops import post, raster_sparse

ROOT = Path(__file__).resolve().parent.parent
CPU = "cpu"

#: each span of the walk's frame, and its parent (None: top level)
PARENTS = {"frame": None, "frame.cull": "frame", "frame.inputs": "frame", "pass": "frame",
           "pass.pre": "pass", "pass.raster": "pass", "pass.merge_shade": "pass",
           "pass.stats": "pass", "frame.untile": "frame", "frame.stats": "frame",
           "post": None}


@pytest.fixture(autouse=True)
def _fresh():
    trace.clear()
    yield
    trace.clear()


@pytest.fixture(scope="module")
def scene3():
    """The CLI's 3-pass scene (room, head, excluded eyes), warmed once."""
    sc = frame_scene("cli_default")
    sc.render(CPU)
    return sc


def _traced(fn, activities=(ProfilerActivity.CPU,)):
    with profile(activities=list(activities)) as prof:
        out = fn()
    return out, prof


def _walk_frame(sc, backend="tiled"):
    res = sc.render(CPU, backend=backend)
    post.postprocess(res.color, res.depth)
    return res


# ---------------------------------------------------------------------------
# off
# ---------------------------------------------------------------------------

def test_off_records_nothing_and_shares_one_null_context(scene3):
    assert not torch.autograd.profiler._is_profiler_enabled
    first = trace.span("pass.pre")
    assert all(trace.span(n) is first for n in ("frame", "pass", "readback"))
    assert trace.frame() is first and trace.frame("animation.frame") is first
    with first as got:
        assert got is None
    _walk_frame(scene3)
    assert trace.frames() == []


def test_off_still_counts(scene3):
    before = trace.counts()
    _walk_frame(scene3)
    after = trace.counts()
    assert after["readback"] - before["readback"] == 9
    assert trace.frames() == []


# ---------------------------------------------------------------------------
# on: the walk's frame
# ---------------------------------------------------------------------------

def test_walk_frame_spans_nest_as_the_table(scene3):
    _, prof = _traced(lambda: _walk_frame(scene3))
    (rec,) = trace.frames()
    got = {}
    for s in rec.spans:
        assert s.frame == rec.id
        assert s.end >= s.start > 0
        if s.name == "readback":
            assert s.parent.name in ("pass.pre", "frame.stats")
            continue
        got.setdefault(s.name, set()).add(None if s.parent is None else s.parent.name)
    assert got == {k: {v} for k, v in PARENTS.items()}
    assert [s.arg for s in rec.spans if s.name == "pass"] == ["sponza", "head", "eyes"]
    assert sum(s.name == "readback" for s in rec.spans) == 9
    for s in rec.spans:                          # a child lies inside its parent
        if s.parent is not None:
            assert s.parent.start <= s.start <= s.end <= s.parent.end
    names = {e.name for e in prof.events()}
    assert {"frame", "frame.cull", "pass sponza", "pass head", "pass eyes", "pass.pre",
            "pass.raster", "pass.merge_shade", "pass.stats", "frame.untile", "frame.stats",
            "readback", "post"} <= names


def test_frames_get_new_ids_and_the_post_follows_its_frame(scene3):
    _traced(lambda: [_walk_frame(scene3) for _ in range(3)])
    recs = trace.frames()
    assert [r.id for r in recs] == [recs[0].id + i for i in range(3)]
    for r in recs:
        assert [s.name for s in r.spans if s.parent is None] == ["frame", "post"]
    assert trace.frames(2) == recs[1:]


def test_nested_entries_open_one_frame(scene3):
    """``render_passes`` inside ``render_scene`` and ``render_scene``
    inside ``render_scene_image`` add no second frame."""
    def frame():
        scene3.render_image(CPU)
        passes = tscene.pass_tensors(scene3, CPU)
        tscene.render_passes(passes, scene3.width, scene3.height, CPU)
    _traced(frame)
    recs = trace.frames()
    assert len(recs) == 2
    for r in recs:
        assert sum(s.name == "frame" for s in r.spans) == 1


def test_ring_keeps_the_last_frames():
    def many():
        for _ in range(trace.FRAMES + 5):
            with trace.frame():
                with trace.span("pass.pre"):
                    pass
    _traced(many)
    recs = trace.frames()
    assert len(recs) == trace.FRAMES
    assert recs[-1].id - recs[0].id == trace.FRAMES - 1


def test_frame_inside_another_frame_kind_is_its_child():
    def run():
        with trace.frame("animation.frame"):
            with trace.frame():
                with trace.frame():
                    with trace.span("pass"):
                        pass
        with trace.span("animation.write", 0):
            pass
    _traced(run)
    (rec,) = trace.frames()
    assert [(s.name, s.parent and s.parent.name) for s in rec.spans] == [
        ("animation.frame", None), ("frame", "animation.frame"), ("pass", "frame"),
        ("animation.write", None)]


def test_span_closes_when_its_block_raises():
    def run():
        with trace.frame():
            with pytest.raises(RuntimeError):
                with trace.span("pass.pre"):
                    raise RuntimeError("boom")
            with trace.span("pass.raster"):
                pass
    _traced(run)
    (rec,) = trace.frames()
    assert [(s.name, s.parent and s.parent.name) for s in rec.spans] == [
        ("frame", None), ("pass.pre", "frame"), ("pass.raster", "frame")]
    assert all(s.end >= s.start for s in rec.spans)


def test_xla_frame_spans(scene3):
    _traced(lambda: scene3.render(CPU, backend="xla"))
    (rec,) = trace.frames()
    under = {}
    for s in rec.spans:
        if s.parent is not None and s.name != "readback":
            under.setdefault(s.parent.name, set()).add(s.name)
    assert under["pass"] == {"pass.pre", "pass.raster", "pass.merge_shade"}
    assert [s.arg for s in rec.spans if s.name == "pass"] == ["sponza", "head", "eyes"]


def test_image_route_spans():
    sc = tscene.headline_scene(96, 64, n_lat=12, n_lon=16)
    _traced(lambda: sc.render_image(CPU))
    (rec,) = trace.frames()
    parents = {s.name: s.parent and s.parent.name for s in rec.spans if s.name != "readback"}
    assert parents == {"frame": None, "frame.cull": "frame", "frame.inputs": "frame",
                       "pass.pre": "frame", "pass.raster": "frame",
                       "pass.merge_shade": "frame", "frame.untile": "frame"}


def test_image_frame_counts_the_plain_fresh_shading_in_its_span():
    """A traced image frame on the CPU: its one pass shades in
    ``pass.merge_shade`` on the plain fresh chain, counted ``shade.plain``
    once in the frame's record, with no ``shade.kernel`` and no launch."""
    sc = tscene.headline_scene(96, 64, n_lat=12, n_lon=16)
    sc.render_image(CPU)
    _traced(lambda: sc.render_image(CPU))
    (rec,) = trace.frames()
    assert [s.name for s in rec.spans].count("pass.merge_shade") == 1
    assert (rec.counts["shade.plain"], rec.counts["shade.kernel"],
            rec.counts["launch.shade_fresh"]) == (1, 0, 0)


def test_animation_spans(tmp_path):
    sc = tscene.headline_scene(64, 64, n_lat=8, n_lon=12)
    cfg = animation.AnimationConfig(frames=3, device=CPU, outdir=str(tmp_path))
    _traced(lambda: animation.render_animation(sc, cfg))
    recs = trace.frames()
    assert len(recs) == 3
    for i, r in enumerate(recs):
        top = [(s.name, s.arg) for s in r.spans if s.parent is None]
        writes = [("animation.write", i - 1)] if i else []
        assert top == [("animation.frame", None)] + writes + (
            [("animation.write", 2)] if i == 2 else [])
        assert {s.parent.name for s in r.spans if s.name == "frame"} == {"animation.frame"}


def test_cli_profile_trace_names_the_layers(tmp_path):
    assert cli.run(["--device", CPU, "--width", "96", "--height", "64",
                    "--outdir", str(tmp_path), "--profile"]) == 0
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events if e.get("cat") == "user_annotation"}
    assert {"frame", "pass.pre", "pass.raster", "pass.merge_shade", "frame.untile",
            "readback", "post"} <= names


# ---------------------------------------------------------------------------
# counters and pass_timings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend,reads", [("tiled", 9), ("xla", 6)])
def test_readbacks_of_a_3_pass_frame_with_stats(scene3, backend, reads):
    before = trace.counts()["readback"]
    scene3.render(CPU, backend=backend)
    assert trace.counts()["readback"] - before == reads
    _traced(lambda: scene3.render(CPU, backend=backend))
    (rec,) = trace.frames()
    assert rec.counts["readback"] == reads
    assert sum(s.name == "readback" for s in rec.spans) == reads


@pytest.mark.parametrize("backend", ["tiled", "xla"])
def test_pass_timings_keep_their_keys_without_a_synchronize(scene3, backend, monkeypatch):
    calls = []
    monkeypatch.setattr(raster_sparse, "synchronize", lambda *a: calls.append(a),
                        raising=False)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(a))
    res = scene3.render(CPU, backend=backend)
    assert calls == []
    assert list(res.pass_timings) == ["sponza", "head", "eyes"]
    assert all(isinstance(v, float) and v >= 0 for v in res.pass_timings.values())
    res, _ = _traced(lambda: scene3.render(CPU, backend=backend))
    assert list(res.pass_timings) == ["sponza", "head", "eyes"]
    (rec,) = trace.frames()
    spans = [s for s in rec.spans if s.name == "pass"]
    assert [s.arg for s in spans] == ["sponza", "head", "eyes"]


def test_cache_counters_hit_on_a_still_camera_and_miss_on_a_moved_one(scene3):
    scene3.render(CPU)
    trace.reset_counts()
    scene3.render(CPU)
    c = trace.counts()
    assert (c["cache.cull.hit"], c["cache.pass_inputs.hit"]) == (1, 3)
    assert c["cache.cull.miss"] == c["cache.pass_inputs.miss"] == 0
    eye = scene3.camera.params.eye
    try:
        scene3.camera.set_eye(eye + 0.01)
        trace.reset_counts()
        scene3.render(CPU)
        c = trace.counts()
        assert (c["cache.cull.miss"], c["cache.pass_inputs.miss"]) == (1, 3)
        assert c["cache.uniforms.hit"] > 0 and c["upload"] == 0      # nothing leaves the host
    finally:
        scene3.camera.set_eye(eye)


def test_cpu_frame_counts_the_plain_merge_shade_per_pass(scene3):
    """On the CPU every pass with faces takes the plain merge + shade: one
    ``shade.plain`` each, no ``shade.kernel`` and no launch."""
    trace.reset_counts()
    scene3.render(CPU)
    c = trace.counts()
    assert (c["shade.plain"], c["shade.kernel"], c["launch.merge_shade"]) == (3, 0, 0)


@pytest.mark.cuda
def test_cuda_frame_counts_one_merge_shade_launch_per_pass():
    """A tiled frame on the card: every pass with faces takes the kernel,
    one ``shade.kernel`` and one ``launch.merge_shade`` each, and none the
    plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sc = frame_scene("cli_default")
    sc.render("cuda")
    trace.reset_counts()
    sc.render("cuda")
    c = trace.counts()
    assert (c["shade.kernel"], c["launch.merge_shade"], c["shade.plain"]) == (3, 3, 0)


def test_counts_is_a_copy_and_resets():
    trace.count("x.test", 2)
    c = trace.counts()
    c["x.test"] += 5
    assert trace.counts()["x.test"] == 2 and trace.counts()["never"] == 0
    trace.reset_counts()
    assert trace.counts()["x.test"] == 0


def test_cpu_tensors_are_no_upload():
    import numpy as np
    before = trace.counts()
    convert.to_torch(np.zeros((4, 3), dtype=np.float32), CPU)
    assert trace.counts()["upload"] == before["upload"]
    assert trace.counts()["upload_bytes"] == before["upload_bytes"]


def test_launch_stamps_only_while_tracing():
    trace.count("launch.coarse_raster")
    def run():
        with trace.frame():
            with trace.span("pass.raster"):
                trace.count("launch.coarse_raster")
    _traced(run)
    (rec,) = trace.frames()
    (stamp,) = rec.stamps
    assert stamp[0] == "launch.coarse_raster" and stamp[2].name == "pass.raster"
    assert stamp[2].start <= stamp[1] <= stamp[2].end
    assert rec.counts["launch.coarse_raster"] == 1


# ---------------------------------------------------------------------------
# self time and the alignment with a device trace
# ---------------------------------------------------------------------------

def _span(rec, name, start_us, end_us, parent=None, arg=None):
    s = trace.Span(name, arg)
    s.start, s.end = int(start_us * 1000), int(end_us * 1000)
    s.parent, s.frame = parent, rec.id
    rec.spans.append(s)
    return s


def synthetic_frame(frame_id=0, shift_us=0.0):
    """frame [1000, 2000] us: pass [1100, 1800] (pre [1100, 1300] with a
    readback [1200, 1250], raster [1300, 1400], merge_shade [1400, 1700]),
    untile [1800, 1900], stats [1900, 1980] with a readback [1950, 1980],
    then post [2000, 2500]; launch stamps at 1310 (coarse) and 1810
    (untile3), all moved by ``shift_us``."""
    rec = trace.FrameRecord(frame_id)
    t = lambda us: us + shift_us  # noqa: E731
    f = _span(rec, "frame", t(1000), t(2000))
    p = _span(rec, "pass", t(1100), t(1800), f, "room")
    pre = _span(rec, "pass.pre", t(1100), t(1300), p)
    _span(rec, "readback", t(1200), t(1250), pre)
    r = _span(rec, "pass.raster", t(1300), t(1400), p)
    _span(rec, "pass.merge_shade", t(1400), t(1700), p)
    u = _span(rec, "frame.untile", t(1800), t(1900), f)
    st = _span(rec, "frame.stats", t(1900), t(1980), f)
    _span(rec, "readback", t(1950), t(1980), st)
    _span(rec, "post", t(2000), t(2500))
    rec.stamps = [("launch.coarse_raster", int(t(1310) * 1000), r),
                  ("launch.untile3_image", int(t(1810) * 1000), u)]
    rec.counts.update({"readback": 2, "upload": 7})
    return rec


#: device = host + OFFSET, on the device's own clock; the coarse walk
#: starts 9 us after its stamp (the item scan before it), the untile 4 us
OFFSET = -900.0


def synthetic_device(shift_us=0.0):
    d = lambda us: us + shift_us + OFFSET  # noqa: E731
    return [("void trt::elementwise_kernel<float>(...)", d(1150), d(1230)),
            ("void trt::item_scan_kernel<32>(int*)", d(1312), d(1319)),
            ("void trt::coarse_walk_kernel<16, true>(Coarse)", d(1319), d(1360)),
            ("Memcpy DtoH (Device -> Pageable)", d(1960), d(1965)),
            ("void trt::untile3_kernel<16>(Frame)", d(1814), d(1830)),
            ("void at::reduce_kernel<512>(...)", d(2100), d(2300))]


def test_self_ns_leaves_children_out_unless_named():
    rec = synthetic_frame()
    assert trace.self_ns([rec], "pass.pre") == 150_000
    assert trace.self_ns([rec], "pass.pre", include=("readback",)) == 200_000
    assert trace.self_ns([rec], "frame") == 1000_000 - 700_000 - 100_000 - 80_000
    assert trace.self_ns([rec, synthetic_frame(1)], "frame.stats") == 2 * 50_000
    assert trace.self_ns([rec], "no.such.span") is None


def test_alignment_finds_the_offset_and_attributes_each_span():
    recs = [synthetic_frame(0), synthetic_frame(1, shift_us=5000.0)]
    device = synthetic_device() + synthetic_device(5000.0)
    att = trace.attribute(device, recs)
    assert att["offset_us"] == pytest.approx(OFFSET + 4)
    assert sorted(att["residual_us"]) == pytest.approx([0, 0, 5, 5])
    rows = [r for r in att["spans"] if r["frame"] == 0]
    by = {(r["name"], r["arg"]): r for r in rows}
    # on the aligned clock a device interval [a, b] lies at host [a - 4 - OFFSET, ...]
    pre = by[("pass.pre", None)]
    assert pre["self_ms"] == pytest.approx(0.150)
    assert pre["busy_ms"] == pytest.approx((1200 - 1146) / 1e3)
    assert pre["kernels"] == ["void trt::elementwise_kernel<float>(...)"]
    rb = [r for r in rows if r["name"] == "readback"]
    assert rb[0]["busy_ms"] == pytest.approx((1226 - 1200) / 1e3)
    assert rb[1]["kernels"] == []                          # a copy is not a kernel
    raster = by[("pass.raster", None)]
    assert raster["busy_ms"] == pytest.approx((1356 - 1308) / 1e3)   # the scan, then the walk
    assert raster["kernels"] == ["void trt::item_scan_kernel<32>(int*)",
                                 "void trt::coarse_walk_kernel<16, true>(Coarse)"]
    assert by[("frame.untile", None)]["busy_ms"] == pytest.approx(0.016)
    post_row = by[("post", None)]
    assert post_row["busy_ms"] == pytest.approx(0.2)
    for r in rows:
        assert r["idle_ms"] + r["busy_ms"] == pytest.approx(r["self_ms"])
    # the rows partition the frame and the post: 1.5 ms, of which the
    # device ran 54 + 26 + 48 + 16 + 5 (the copy) + 200 us
    assert sum(r["self_ms"] for r in rows) == pytest.approx(1.5)
    assert sum(r["busy_ms"] for r in rows) == pytest.approx(0.349)


def test_alignment_skips_kernels_whose_counts_disagree():
    recs = [synthetic_frame()]
    device = [d for d in synthetic_device() if "untile3" not in d[0]]
    att = trace.attribute(device, recs)
    assert att["offset_us"] == pytest.approx(OFFSET + 9)    # from the walk alone
    assert att["residual_us"] == [0]
    assert trace.attribute([d for d in device if "walk" not in d[0]], recs) is None


def test_alignment_takes_any_profilers_clock():
    recs = [synthetic_frame()]
    moved = [(n, s + 1e9, e + 1e9) for n, s, e in synthetic_device()]
    a, b = trace.attribute(synthetic_device(), recs), trace.attribute(moved, recs)
    assert b["offset_us"] - a["offset_us"] == pytest.approx(1e9)
    assert [r["idle_ms"] for r in a["spans"]] == pytest.approx([r["idle_ms"]
                                                               for r in b["spans"]])


# ---------------------------------------------------------------------------
# the benchmark's readers of the spans
# ---------------------------------------------------------------------------

READERS = ("pre_host_ms", "merge_shade_host_ms", "untile_host_ms", "stats_host_ms",
           "readbacks_per_frame", "uploads_per_frame", "idle_in_program_ms")


def _reader(name):
    from rasterbench import catalog
    return catalog.Benchmark(ROOT).reader(name)


def _data(frames=2, device=None):
    t = SimpleNamespace(frames=frames, device=device or [])
    return SimpleNamespace(window=SimpleNamespace(trace=t), work=None)


@pytest.fixture
def two_frames(monkeypatch):
    """Three recorded frames; the last two are the profiled ones."""
    recs = [synthetic_frame(i, shift_us=5000.0 * i) for i in range(3)]
    monkeypatch.setattr(trace, "_RING", type(trace._RING)(recs, maxlen=trace.FRAMES))
    return recs


@pytest.mark.parametrize("name,want", [
    ("pre_host_ms", 0.150), ("merge_shade_host_ms", 0.300), ("untile_host_ms", 0.100),
    ("stats_host_ms", 0.080), ("readbacks_per_frame", 2.0), ("uploads_per_frame", 7.0)])
def test_reader_on_synthetic_frames(two_frames, name, want):
    assert _reader(name).read(_data()) == pytest.approx(want)


def test_idle_in_program_reader(two_frames):
    device = synthetic_device(5000.0) + synthetic_device(10000.0)
    assert _reader("idle_in_program_ms").read(_data(device=device)) == \
        pytest.approx(1.5 - 0.349)
    assert _reader("idle_in_program_ms").read(_data()) is None      # no device trace


@pytest.mark.parametrize("name", READERS)
def test_reader_without_spans_is_none(name):
    assert _reader(name).read(_data()) is None                     # nothing recorded
    assert _reader(name).read(SimpleNamespace(window=SimpleNamespace(trace=None))) is None


@pytest.mark.parametrize("name", READERS)
def test_reader_entry_in_the_benchmark(name):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == name)
    reader = _reader(name)
    assert (reader.UNIT, reader.LAYER, reader.MOVES) == (entry["unit"], entry["layer"],
                                                         entry["moves"])
    image = [] if name == "stats_host_ms" else ["object_orbit_800.host"]   # no stats there
    assert entry["workloads"] == ["reference_main_1200x800.walk",
                                  "reference_main_shadows_1200x800.sun_walk", *image]


def test_readers_on_a_profiled_cpu_frame(scene3):
    _traced(lambda: [_walk_frame(scene3) for _ in range(2)])
    data = _data(frames=2)
    for name in ("pre_host_ms", "merge_shade_host_ms", "untile_host_ms", "stats_host_ms"):
        assert _reader(name).read(data) > 0
    assert _reader("readbacks_per_frame").read(data) == 9
    assert _reader("uploads_per_frame").read(data) == 0
