"""The port's strip route (``ops/raster_fine.py`` and the ``FINE_MODE``
dispatch of ``ops/raster_sparse.py``) against the JAX package.

JAX side, run as the JAX package's own tests run it on the CPU (Pallas in
interpret mode), in one subprocess for the module (tests/torch_parity.py
says why): ``raster_fine._pre_fine_jit`` at the port's exact totals,
``raster_fine._fine_call_jit(interpret=True)`` with and without
``collect_stats`` on that pre-stage, and ``render_frame_fused_image`` /
``scene.render(backend="tiled")`` / ``render_frame_fused`` with
``raster_sparse.FINE_MODE = "fine"``.  Every comparison is bitwise; the
strip route must also equal the port's coarse route.

Tests marked ``cuda`` compare the CUDA kernel with its plain version and
skip where no GPU is present."""

import numpy as np
import pytest
import torch

from torch_parity import (FRAMES, assert_bits, frame_scene, run_jax, scene_pass,
                          stats_vector)
from tinyrenderder_tpu_torch import convert
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.ops import raster_coarse, raster_fine, raster_fine2, raster_sparse

#: pre-stage and raster cases: (scene of torch_parity.SCENES, tile_h)
CASES = {f"{scene}_{th}": (scene, th)
         for scene in ("head_phong", "soup_phong_ragged", "cube_gouraud")
         for th in (16, 32)}
#: the cases whose strip raster also runs on the JAX side (its interpret
#: mode takes seconds a case)
KERNEL_CASES = ("head_phong_16", "soup_phong_ragged_32", "cube_gouraud_16")
#: image-route cases: (scene, tile_h)
IMAGES = {"head_textured_32": ("head_textured", 32),
          "soup_phong_ragged_16": ("soup_phong_ragged", 16)}
PLANES = ("color", "depth", "full_depth")
#: split-walk cases, port only: (scene, tile_h, the scale of each copy of
#: the pass's triangles, drawn one copy after another).  A z-tie soup (every
#: triangle drawn twice, the copies after all the originals, so each tie's
#: two rows fall on both sides of a range edge) and a stack of six heads
#: (pairs of exact copies at three scales: tiles of several ranges whose
#: strips end at different rows, and whose later ranges win pixels)
STACKS = {"soup_ties_16": ("soup_phong_ragged", 16, (1.0, 1.0)),
          "head_stack_32": ("head_phong", 32, (1.0, 1.0, 1.02, 1.02, 0.98, 0.98))}
RANGE_LENS = (1, 7, 64)


def _pass(scene, scales=(1.0,)):
    """A scene's pass, its triangles drawn once for each scale (positions
    scaled), one copy after another."""
    p, w, h = scene_pass(scene)
    attrs = {k: np.concatenate([v * np.float32(s) if k == "position" else v for s in scales])
             for k, v in p.attrs.items()}
    attrs, uniforms = convert.pass_to_torch(attrs, p.uniforms, "cpu")
    return attrs, p.shader, uniforms, w, h


def _depth_tiles(w, h, th, seed):
    """A running depth over every tile, half of it +inf."""
    rng = np.random.default_rng(seed)
    n = raster_sparse.cdiv(w, 128) * raster_sparse.cdiv(h, th)
    d = rng.uniform(-0.2, 1.0, size=(n, th, 128)).astype(np.float32)
    d[rng.random(d.shape) < 0.5] = np.inf
    return d


@pytest.fixture(scope="module")
def prepared():
    """name -> (PreFine, the full running depth, n_vary, w, h, th)."""
    out = {}
    for seed, (name, (scene, th)) in enumerate(CASES.items()):
        attrs, shader, uniforms, w, h = _pass(scene)
        pre = raster_fine.pre_fine(attrs, uniforms, shader, w, h, th)
        out[name] = (pre, _depth_tiles(w, h, th, seed), sum(shader.varying_spec.values()),
                     w, h, th)
    return out


@pytest.fixture(scope="module")
def split_prepared(prepared):
    """``prepared`` and the STACKS cases."""
    out = dict(prepared)
    for seed, (name, (scene, th, scales)) in enumerate(STACKS.items(), start=30):
        attrs, shader, uniforms, w, h = _pass(scene, scales)
        pre = raster_fine.pre_fine(attrs, uniforms, shader, w, h, th)
        out[name] = (pre, _depth_tiles(w, h, th, seed), sum(shader.varying_spec.values()),
                     w, h, th)
    return out


class _mode:
    """``raster_sparse.FINE_MODE`` set inside the block."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        self.old, raster_sparse.FINE_MODE = raster_sparse.FINE_MODE, self.mode

    def __exit__(self, *exc):
        raster_sparse.FINE_MODE = self.old


def _port_image(scene, th, mode):
    attrs, shader, uniforms, w, h = _pass(scene)
    with _mode(mode):
        return raster_sparse.render_frame_fused_image(
            [(attrs, shader, uniforms, False)], w, h, tile_h=th).numpy()


def _port_frame(name, mode):
    """(planes, RenderStats, winner plane) of a FRAMES scene on one route."""
    w, h = FRAMES[name]
    with _mode(mode):
        r = tscene.render_scene(frame_scene(name), "cpu")
        ft, _, _ = raster_sparse.render_frame_fused(
            tscene.pass_tensors(frame_scene(name), "cpu"), w, h, "cpu")
    winner = raster_sparse.tiles_to_buffers(ft, w, h).winner.numpy()
    return {k: getattr(r, k).numpy() for k in PLANES}, r.stats, winner


@pytest.fixture(scope="module")
def port_frames():
    return {(name, mode): _port_frame(name, mode) for name in FRAMES
            for mode in ("coarse", "fine")}


@pytest.fixture(scope="module")
def jax_side(prepared, tmp_path_factory):
    req = {}
    for name, (pre, depth_tiles, n_vary, _, _, th) in prepared.items():
        req[f"{name}_pre"] = {"op": "pre_fine", "scene": CASES[name][0], "th": th,
                              "pairs": pre.pairs, "rows": pre.row_total,
                              "active": pre.n_active}
        if name in KERNEL_CASES:
            req[f"{name}_pre"].update(depth_tiles=depth_tiles, n_vary=n_vary)
    for name, (scene, th) in IMAGES.items():
        req[f"{name}_image"] = {"op": "image", "scene": scene, "th": th, "mode": "fine"}
    for name in FRAMES:
        req[f"{name}_scene"] = {"op": "scene", "scene": name, "mode": "fine"}
    return run_jax(req, tmp_path_factory.mktemp("jax_fine"))


def _raster_args(c):
    pre, depth_tiles, n_vary, w, _, th = c
    init = torch.from_numpy(depth_tiles)[pre.ids.long()].contiguous()
    return (pre.tri_rec, pre.tri8, pre.ids, pre.row_start, pre.rows, init,
            raster_sparse.cdiv(w, 128), th, 128, n_vary)


@pytest.mark.parametrize("case", list(CASES))
def test_pre_stage_matches_jax(prepared, jax_side, case):
    """Active tiles, their row segments, the totals and every slot's
    triangle id (record column 16 on the JAX side, -1 = empty)."""
    pre = prepared[case][0]
    want = jax_side[f"{case}_pre"]
    assert pre.pairs > 0 and pre.n_active > 0
    assert_bits(np.array([pre.pairs, pre.row_total, pre.n_active]), want["totals"], "totals")
    assert_bits(pre.ids.numpy(), want["ids"], "ids")
    assert_bits(pre.row_start.numpy(), want["row_start"], "row_start")
    assert_bits(pre.rows.numpy(), want["rows"], "rows")
    assert_bits(pre.tri8.numpy(), want["slots"], "slots")


@pytest.mark.parametrize("case", KERNEL_CASES)
@pytest.mark.parametrize("stats", [False, True])
def test_fine_raster_plain_matches_pallas(prepared, jax_side, case, stats):
    """Depth, winner, varyings and (with stats) both event planes against
    the TPU kernel in interpret mode, merged against a running depth."""
    want = jax_side[f"{case}_pre"]
    out = raster_fine.fine_raster(*_raster_args(prepared[case]), collect_stats=stats)
    depth, winner, vary = out[:3]
    assert_bits(depth.numpy(), want[f"depth_{int(stats)}"], "depth")
    # the TPU kernel carries ids as exact f32 (< 2^24), -1 = background
    assert_bits(winner.numpy(), want[f"winner_{int(stats)}"].astype(np.int32), "winner")
    assert_bits(vary.numpy(), want[f"vary_{int(stats)}"], "varyings")
    won = winner.numpy() >= 0
    assert won.any() and (~won).any()
    if stats:
        count, max_z = out[3]
        assert_bits(count.numpy(), want["ev"][:, 0].astype(np.int32), "event count")
        assert_bits(max_z.numpy(), want["ev"][:, 1], "event max z")
        assert (count.numpy()[won] >= 1).all() and (count.numpy()[~won] == 0).all()


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("stats", [False, True])
def test_fine_raster_equals_coarse_raster(prepared, case, stats):
    """The strip raster's outputs are the coarse raster's, on the same
    active tiles (a triangle touching a tile touches one of its strips)."""
    pre, depth_tiles, n_vary, w, h, th = prepared[case]
    scene = CASES[case][0]
    attrs, shader, uniforms, _, _ = _pass(scene)
    ps = raster_sparse.pre_sparse(attrs, uniforms, shader, w, h, th)
    assert_bits(ps.ids.numpy(), pre.ids.numpy(), "active tiles")
    init = torch.from_numpy(depth_tiles)[ps.ids.long()].contiguous()
    want = raster_coarse.coarse_raster(ps.tri_rec, ps.sorted_tri, ps.ids, ps.start,
                                       ps.counts, init, raster_sparse.cdiv(w, 128), th,
                                       128, n_vary, collect_stats=stats)
    got = raster_fine.fine_raster(*_raster_args(prepared[case]), collect_stats=stats)
    for name, g, x in zip(("depth", "winner", "vary"), got, want):
        assert_bits(g.numpy(), x.numpy(), name)
    if stats:
        for name, g, x in zip(("event count", "event max z"), got[3], want[3]):
            assert_bits(g.numpy(), x.numpy(), name)


@pytest.mark.parametrize("case", list(IMAGES))
def test_image_route_matches_jax_fine_route(jax_side, case):
    scene, th = IMAGES[case]
    got = _port_image(scene, th, "fine")
    assert_bits(got, jax_side[f"{case}_image"]["image"], "image")
    assert_bits(got, _port_image(scene, th, "coarse"), "image (coarse route)")


@pytest.mark.parametrize("name", list(FRAMES))
def test_frame_matches_jax_fine_route(port_frames, jax_side, name):
    """Colour, output and full depth, stats and the winner plane of the
    3-pass frames under FINE_MODE="fine" (every pass, the excluded eyes
    included, takes the strip raster)."""
    planes, stats, winner = port_frames[(name, "fine")]
    want = jax_side[f"{name}_scene"]
    for k in PLANES:
        assert_bits(planes[k], want[f"{k}_1"], k)
    assert_bits(stats_vector(stats), want["stats_1"], "stats")
    assert_bits(winner, want["winner"], "winner")
    assert stats.fragments_exact and stats.fragments_drawn > 0


@pytest.mark.parametrize("name", list(FRAMES))
def test_fine_frame_equals_coarse_frame(port_frames, name):
    fine, coarse = port_frames[(name, "fine")], port_frames[(name, "coarse")]
    for k in PLANES:
        assert_bits(fine[0][k], coarse[0][k], k)
    assert fine[1] == coarse[1]
    assert_bits(fine[2], coarse[2], "winner")


def test_z_ties_go_to_the_first_drawn():
    """Every triangle drawn twice: the first copy must win each tie."""
    p, w, h = scene_pass("head_phong")
    attrs = {k: np.concatenate([v, v]) for k, v in p.attrs.items()}
    f = p.attrs["position"].shape[0]
    attrs_t, uniforms_t = convert.pass_to_torch(attrs, p.uniforms, "cpu")
    pre = raster_fine.pre_fine(attrs_t, uniforms_t, p.shader, w, h, 32)
    init = torch.full((pre.n_active, 32, 128), torch.inf)
    _, winner, _ = raster_fine.fine_raster(pre.tri_rec, pre.tri8, pre.ids, pre.row_start,
                                           pre.rows, init, raster_sparse.cdiv(w, 128), 32,
                                           128, 8)
    assert (winner >= 0).any() and int(winner.max()) < f


@pytest.mark.parametrize("case", [*KERNEL_CASES, *STACKS])
@pytest.mark.parametrize("range_len", RANGE_LENS)
@pytest.mark.parametrize("stats", [False, True])
def test_split_walk_equals_the_serial_walk(split_prepared, case, range_len, stats):
    """The CUDA kernels' decomposition in plain PyTorch: every tile's rows
    cut into ranges of ``range_len``, each range's first minimum from +inf,
    the ranges merged in order with strict-less from the running depth
    (finite on half the pixels), and with stats each range walked again
    from its entering depth.  Bitwise the serial walk."""
    c = split_prepared[case]
    args = _raster_args(c)
    assert torch.isfinite(args[5]).any() and torch.isinf(args[5]).any()
    want = raster_fine.fine_raster_plain(*args, collect_stats=stats)
    got = raster_fine.fine_raster_split_plain(*args, collect_stats=stats, range_len=range_len)
    flat = lambda out: (*out[:3], *(out[3] if stats else ()))  # noqa: E731
    for name, g, w in zip(("depth", "winner", "vary", "event count", "event max z"),
                          flat(got), flat(want)):
        assert_bits(g.numpy(), w.numpy(), name)
    pre = c[0]
    if case == "head_stack_32":                    # tiles of several ranges
        assert pre.max_rows > 3 * range_len
    if case == "soup_ties_16":                     # every tie goes to the first copy
        f = pre.tri_rec.shape[0] // 2
        assert (want[1] >= 0).any() and int(want[1].max()) < f


@pytest.mark.parametrize("case", [*CASES, *STACKS])
def test_pre_stage_max_rows(split_prepared, case):
    """The readback's fourth integer is the largest tile's rows."""
    pre = split_prepared[case][0]
    assert pre.max_rows == int(pre.rows.max()) > 0


def test_mode_dispatch(monkeypatch):
    """Forced modes apply to every pass ("fine2" included); "auto" probes
    rows against pairs once per key when a ratio is set, and routes
    coarse otherwise."""
    attrs, shader, uniforms, w, h = _pass("head_phong")
    decide = lambda: raster_sparse.decide_mode(attrs, uniforms, shader, w, h, 16, 128)  # noqa: E731
    for mode in ("coarse", "fine", "fine2"):
        monkeypatch.setattr(raster_sparse, "FINE_MODE", mode)
        assert decide() == mode
    monkeypatch.setattr(raster_sparse, "FINE_MODE", "strips")
    with pytest.raises(ValueError):
        decide()
    monkeypatch.setattr(raster_sparse, "FINE_MODE", "auto")
    monkeypatch.setattr(raster_sparse, "_FINE_DECISION", {})
    assert raster_sparse.FINE_RATIO is None and decide() == "coarse"
    probe = raster_fine2.probe_rows(attrs, uniforms, shader, w, h, 16, 128)
    rows, pairs = probe.rows, probe.pairs
    pre = raster_fine.pre_fine(attrs, uniforms, shader, w, h, 16)
    assert (rows, pairs) == (pre.row_total, raster_sparse.pre_sparse(
        attrs, uniforms, shader, w, h, 16).total)
    monkeypatch.setattr(raster_sparse, "FINE_MIN_FACES", 0)
    for ratio, mode in ((rows / pairs + 1e-9, "fine"), (0.99 * rows / pairs, "coarse")):
        monkeypatch.setattr(raster_sparse, "FINE_RATIO", ratio)
        monkeypatch.setattr(raster_sparse, "_FINE_DECISION", {})
        assert decide() == mode
        monkeypatch.setattr(raster_sparse, "FINE_RATIO", 1.0)
        assert decide() == mode                       # cached per key
    monkeypatch.setattr(raster_sparse, "FINE_MIN_FACES", 10**6)
    monkeypatch.setattr(raster_sparse, "_FINE_DECISION", {})
    assert decide() == "coarse"


def test_wrapper_validates_inputs(prepared):
    args = list(_raster_args(prepared["head_phong_16"]))
    raster_fine.fine_raster(*args)
    for i, bad in ((1, args[1].reshape(-1)), (1, args[1].long()), (2, args[2].long()),
                   (5, args[5][:, :8]), (0, args[0].double())):
        broken = list(args)
        broken[i] = bad
        with pytest.raises(ValueError):
            raster_fine.fine_raster(*broken)
    with pytest.raises(ValueError, match="room"):
        raster_fine.fine_raster(*args[:-1], 40)
    with pytest.raises(ValueError):
        raster_fine.pre_fine(*_pass("head_phong")[:3], 256, 128, 16, 64)


def test_cpu_raster_launches_no_kernel(prepared):
    raster_fine.LAUNCHES = raster_fine.STATS_LAUNCHES = 0
    args = _raster_args(prepared["soup_phong_ragged_32"])
    raster_fine.fine_raster(*args)
    raster_fine.fine_raster(*args, collect_stats=True)
    assert raster_fine.LAUNCHES == raster_fine.STATS_LAUNCHES == 0


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (skipped without a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SPLIT_KERNELS = ("item_scan_kernel", "strip_walk_kernel", "strip_merge_kernel",
                 "strip_events_kernel")


def _device_kernels(fn, calls=3):
    """The distinct CUDA kernels ``calls`` calls of ``fn`` launch (a split
    kernel by its template's name), from torch.profiler after a warm call;
    a trace that holds no kernel at all is taken again (up to three
    traces: the profiler has been seen to return an empty one)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        names = {next((k for k in SPLIT_KERNELS if k in e.name), e.name) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "emcpy" not in e.name}
        if names:
            break
    return names


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CASES, *STACKS])
@pytest.mark.parametrize("stats", [False, True])
def test_cuda_fine_raster_matches_plain(split_prepared, cuda_device, case, stats):
    """Bitwise the plain version through the split walk, with and without
    stats, on tiles of one range and (the head stack) on tiles of several
    ranges whose strips end at different rows, with z-ties on both sides
    of a range edge (STACKS)."""
    c = split_prepared[case]
    args = _raster_args(c)
    if case == "head_stack_32":
        pre = c[0]
        t = int(pre.rows.argmax())                                  # the longest tile
        assert pre.max_rows > 3 * raster_fine.range_rows(32)
        seg = pre.tri8[int(pre.row_start[t]):int(pre.row_start[t]) + pre.max_rows]
        ends = (seg >= 0).sum(dim=0)                                # its strips' lengths
        assert int(ends.min()) < int(ends.max())
    want = raster_fine.fine_raster_plain(*args, collect_stats=stats)
    gpu = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in args]
    before = (raster_fine.LAUNCHES, raster_fine.STATS_LAUNCHES)
    got = raster_fine.fine_raster(*gpu, collect_stats=stats)
    torch.cuda.synchronize()
    assert (raster_fine.LAUNCHES - before[0], raster_fine.STATS_LAUNCHES - before[1]) == \
        ((0, 1) if stats else (1, 0))
    flat = lambda out: (*out[:3], *(out[3] if stats else ()))  # noqa: E731
    for g, w in zip(flat(got), flat(want)):
        assert_bits(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("stats", [False, True])
def test_cuda_fine_raster_one_launch(split_prepared, cuda_device, stats):
    """A pass whose tiles all fit one range, given its ``max_rows``: one
    kernel launch a call (the walk alone), one count, bitwise the plain
    version; the head stack's longer tiles take the split walk's scan,
    walk and merge (and events)."""
    c = split_prepared["cube_gouraud_16"]
    pre = c[0]
    assert pre.max_rows <= raster_fine.range_rows(16)
    args = _raster_args(c)
    want = raster_fine.fine_raster_plain(*args, collect_stats=stats)
    gpu = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in args]
    raster_fine.LAUNCHES = raster_fine.STATS_LAUNCHES = 0
    got = raster_fine.fine_raster(*gpu, collect_stats=stats, max_rows=pre.max_rows)
    torch.cuda.synchronize()
    assert raster_fine.LAUNCHES + raster_fine.STATS_LAUNCHES == 1
    flat = lambda out: (*out[:3], *(out[3] if stats else ()))  # noqa: E731
    for g, w in zip(flat(got), flat(want)):
        assert_bits(g.cpu().numpy(), w.numpy())
    names = _device_kernels(lambda: raster_fine.fine_raster(*gpu, collect_stats=stats,
                                                            max_rows=pre.max_rows))
    assert names == {"strip_walk_kernel"}, names
    stack = split_prepared["head_stack_32"]
    gs = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in _raster_args(stack)]
    names = _device_kernels(lambda: raster_fine.fine_raster(*gs, collect_stats=stats,
                                                            max_rows=stack[0].max_rows))
    assert names == {"item_scan_kernel", "strip_walk_kernel", "strip_merge_kernel",
                     *(["strip_events_kernel"] if stats else [])}, names


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FRAMES))
def test_cuda_fine_frame_matches_cpu_frame(port_frames, cuda_device, name):
    with _mode("fine"):
        raster_fine.STATS_LAUNCHES = 0
        r = tscene.render_scene(frame_scene(name), cuda_device)
        torch.cuda.synchronize()
    assert raster_fine.STATS_LAUNCHES == 3
    planes, stats, _ = port_frames[(name, "fine")]
    for k in PLANES:
        assert_bits(getattr(r, k).cpu().numpy(), planes[k], k)
    assert r.stats == stats
