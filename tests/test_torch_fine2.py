"""The port's grouped strip route (``ops/raster_fine2.py`` and its
``FINE_MODE`` branch in ``ops/raster_sparse.py``) against the JAX package.

JAX side, run as the JAX package's own tests run it on the CPU (Pallas in
interpret mode), in one subprocess for the module (tests/torch_parity.py
says why): ``raster_fine2._pre_fine2_jit`` at the port's exact totals,
``_init_strips_jit``, ``_fine2_call_jit(interpret=True)`` pass-local and
init-seeded with ``collect_stats`` on that pre-stage, and
``render_frame_fused_image`` / ``scene.render(backend="tiled")`` with
``raster_sparse.FINE_MODE = "fine2"``.  Every comparison is bitwise; the
grouped strip route must also equal the port's coarse route, and the
bench's two 246k-triangle scenes (here at a small grid) the port's f32
oracle.

Tests marked ``cuda`` compare the CUDA kernel with its plain version and
skip where no GPU is present."""

import numpy as np
import pytest
import torch

from torch_parity import (FRAMES, assert_bits, fine_mode, frame_scene, launches,
                          reset_launches, run_jax, scene_pass, stats_vector)
from tinyrenderder_tpu_torch import convert
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.ops import raster_fine, raster_fine2, raster_sparse

#: pre-stage cases: (scene of torch_parity.SCENES, tile_h)
CASES = {f"{scene}_{th}": (scene, th)
         for scene in ("head_phong", "soup_phong_ragged", "cube_gouraud")
         for th in (16, 32)}
#: the cases whose raster also runs on the JAX side (interpret mode)
KERNEL_CASES = ("head_phong_16", "soup_phong_ragged_32")
#: image-route cases: (scene, tile_h)
IMAGES = {"head_textured_32": ("head_textured", 32),
          "soup_phong_ragged_16": ("soup_phong_ragged", 16)}
PLANES = ("color", "depth", "full_depth")
#: the bench's 246k-triangle scenes, cut to a 2x2 grid of 12x16 heads
WALLS = {"stress": tscene.stress_scene, "mixed": tscene.mixed_scene}
WALL_SIZE = dict(width=160, height=96, grid=2, n_lat=12, n_lon=16)


#: split-walk cases, port only: (scene, tile_h, the scale of each copy of
#: the pass's triangles, drawn one copy after another).  A z-tie soup (every
#: triangle drawn twice, the copies after all the originals, so each tie's
#: two rows fall on both sides of a range edge) and a stack of six heads
#: (pairs of exact copies at three scales: groups of several ranges whose
#: slots end at different rows, and whose later ranges win pixels)
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
    """name -> (PreFine2, the full running depth, n_vary, w, h, th)."""
    out = {}
    for seed, (name, (scene, th)) in enumerate(CASES.items()):
        attrs, shader, uniforms, w, h = _pass(scene)
        pre = raster_fine2.pre_fine2(attrs, uniforms, shader, w, h, th)
        out[name] = (pre, _depth_tiles(w, h, th, seed), sum(shader.varying_spec.values()),
                     w, h, th)
    return out


@pytest.fixture(scope="module")
def split_prepared(prepared):
    """``prepared`` and the STACKS cases."""
    out = dict(prepared)
    for seed, (name, (scene, th, scales)) in enumerate(STACKS.items(), start=30):
        attrs, shader, uniforms, w, h = _pass(scene, scales)
        pre = raster_fine2.pre_fine2(attrs, uniforms, shader, w, h, th)
        out[name] = (pre, _depth_tiles(w, h, th, seed), sum(shader.varying_spec.values()),
                     w, h, th)
    return out


def _port_image(scene, th, mode):
    attrs, shader, uniforms, w, h = _pass(scene)
    with fine_mode(mode):
        image, depth = raster_sparse.render_frame_fused_image(
            [(attrs, shader, uniforms, False)], w, h, tile_h=th, return_depth=True)
    return image.numpy(), depth.numpy()


def _port_frame(sc, mode):
    """(planes with stats, planes without, RenderStats, winner plane) of a
    scene on one route."""
    w, h = sc.width, sc.height
    with fine_mode(mode):
        r = tscene.render_scene(sc, "cpu")
        r0 = tscene.render_scene(sc, "cpu", collect_stats=False)
        ft, _, _ = raster_sparse.render_frame_fused(tscene.pass_tensors(sc, "cpu"), w, h,
                                                    "cpu")
    winner = raster_sparse.tiles_to_buffers(ft, w, h).winner.numpy()
    return ({k: getattr(r, k).numpy() for k in PLANES},
            {k: getattr(r0, k).numpy() for k in PLANES}, r.stats, winner)


@pytest.fixture(scope="module")
def port_frames():
    return {(name, mode): _port_frame(frame_scene(name), mode) for name in FRAMES
            for mode in ("coarse", "fine2")}


@pytest.fixture(scope="module")
def jax_side(prepared, tmp_path_factory):
    req = {}
    for name, (pre, depth_tiles, n_vary, _, _, th) in prepared.items():
        req[f"{name}_pre"] = {"op": "pre_fine2", "scene": CASES[name][0], "th": th,
                              "pairs": pre.pairs, "rows": pre.row_total,
                              "groups": pre.n_groups, "active": pre.n_active}
        if name in KERNEL_CASES:
            req[f"{name}_pre"].update(depth_tiles=depth_tiles, n_vary=n_vary)
    for name, (scene, th) in IMAGES.items():
        req[f"{name}_image"] = {"op": "image", "scene": scene, "th": th, "mode": "fine2"}
    req["multimesh_scene"] = {"op": "scene", "scene": "multimesh", "mode": "fine2"}
    return run_jax(req, tmp_path_factory.mktemp("jax_fine2"))


def _raster_args(c):
    pre, _, n_vary, _, _, th = c
    return (pre.tri_rec, pre.tri8, pre.group_start, pre.group_rows, pre.x0y0, th, n_vary)


def _init(c):
    pre, depth_tiles = c[:2]
    return raster_fine2.init_strips(torch.from_numpy(depth_tiles), pre)


@pytest.mark.parametrize("case", list(CASES))
def test_pre_stage_matches_jax(prepared, jax_side, case):
    """The totals, active tiles, groups and their rows, every slot's
    triangle id (record column 16 on the JAX side, -1 = empty), each slot's
    strip and pixel origin, and the active tiles' strip sources."""
    pre = prepared[case][0]
    want = jax_side[f"{case}_pre"]
    assert pre.pairs > 0 and pre.n_groups > 0
    assert_bits(np.array([pre.pairs, pre.row_total, pre.n_groups, pre.n_active]),
                want["totals"], "totals")
    assert_bits(pre.ids.numpy(), want["ids"], "ids")
    assert_bits(pre.group_start.numpy(), want["group_start"], "group starts")
    assert_bits(pre.group_rows.numpy(), want["group_rows"], "group rows")
    assert_bits(pre.tri8.numpy(), want["slots"], "slots")
    assert_bits(pre.sid_of.numpy(), want["sid_of"], "slot strips")
    # the TPU repeats slot k's origin over lanes 16k .. 16k + 15
    assert_bits(pre.x0y0.numpy(), want["x0y0"][:, :, ::16].transpose(0, 2, 1), "origins")
    assert_bits(pre.src.numpy(), want["src"], "src")
    assert_bits(pre.live.numpy(), want["live"], "live")


@pytest.mark.parametrize("case", KERNEL_CASES)
@pytest.mark.parametrize("stats", [False, True])
def test_fine2_raster_plain_matches_pallas(prepared, jax_side, case, stats):
    """Both launches of ``render_pass_fine2``: pass-local with the
    varyings, and init-seeded (a running depth half +inf) with the event
    planes; the port's seeded launch with the varyings gives the same
    depth and winner."""
    want = jax_side[f"{case}_pre"]
    args = _raster_args(prepared[case])
    if stats:
        init = _init(prepared[case])
        assert_bits(init.numpy(), want["init"], "init strips")
        assert torch.isfinite(init).any() and torch.isinf(init).any()
        out = raster_fine2.fine2_raster(*args[:-1], 0, init, collect_stats=True)
        count, max_z = out[3]
        assert_bits(count.numpy(), want["ev"][:, 0].astype(np.int32), "event count")
        assert_bits(max_z.numpy(), want["ev"][:, 1], "event max z")
        full = raster_fine2.fine2_raster(*args, init, collect_stats=True)
        for name, g, x in zip(("depth", "winner", "event count", "event max z"),
                              (*full[:2], *full[3]), (*out[:2], *out[3])):
            assert_bits(g.numpy(), x.numpy(), f"{name} with varyings")
    else:
        out = raster_fine2.fine2_raster(*args)
        assert_bits(out[2].numpy(), want["vary_0"], "varyings")
    depth, winner = out[:2]
    assert_bits(depth.numpy(), want[f"depth_{int(stats)}"], "depth")
    # the TPU kernel carries ids as exact f32 (< 2^24), -1 = background
    assert_bits(winner.numpy(), want[f"winner_{int(stats)}"].astype(np.int32), "winner")
    won = winner.numpy() >= 0
    assert won.any() and (~won).any()


@pytest.mark.parametrize("case", list(CASES))
def test_grouping_is_the_sorted_stride_sum(prepared, case):
    """Grouped rows = sum(sorted_desc[0::8]) <= the strip raster's
    per-tile rows and <= every random grouping of the strips; every strip
    with pairs sits in a launched group (src < G * 8 where live).  The
    three pre-stages agree on the active tiles, the two strip ones on the
    strip pairs, and a coarse pair holds 1 to 8 strip pairs."""
    pre, _, _, w, h, th = prepared[case]
    attrs, shader, uniforms, _, _ = _pass(CASES[case][0])
    per_tile = raster_fine.pre_fine(attrs, uniforms, shader, w, h, th)
    coarse = raster_sparse.pre_sparse(attrs, uniforms, shader, w, h, th)
    assert pre.n_active == per_tile.n_active == coarse.n_active
    assert pre.pairs == per_tile.pairs and coarse.total <= pre.pairs <= 8 * coarse.total
    assert pre.n_groups == -(-int(pre.live.sum()) // 8) > 0      # strips with pairs, 8 a group
    assert (pre.tri8.numpy() >= 0).sum() == pre.pairs
    src, live = pre.src.numpy(), pre.live.numpy()
    assert (src[live] < pre.n_groups * 8).all()
    # each strip's count from its slot column in its group
    g, k = src[live] // 8, src[live] % 8
    col = pre.tri8.numpy()
    c = np.array([(col[s:s + n, kk] >= 0).sum() for s, n, kk in
                  zip(pre.group_start.numpy()[g], pre.group_rows.numpy()[g], k)])
    assert c.sum() == pre.pairs and (c > 0).all()
    desc = np.sort(c)[::-1]
    assert pre.row_total == desc[0::8].sum() <= per_tile.row_total
    assert_bits(pre.group_rows.numpy(), desc[0::8].astype(np.int32), "group rows")
    rng = np.random.default_rng(0)
    padded = np.concatenate([c, np.zeros(-len(c) % 8, c.dtype)])
    for _ in range(20):
        assert pre.row_total <= rng.permutation(padded).reshape(-1, 8).max(axis=1).sum()


@pytest.mark.parametrize("case", list(CASES))
def test_fine2_image_equals_coarse_image(case):
    """The single-pass image and its depth on the grouped route are the
    coarse route's (every pass of the image route)."""
    scene, th = CASES[case]
    got, want = _port_image(scene, th, "fine2"), _port_image(scene, th, "coarse")
    assert_bits(got[0], want[0], "image")
    assert_bits(got[1], want[1], "depth")


@pytest.mark.parametrize("case", list(IMAGES))
def test_image_route_matches_jax_fine2_route(jax_side, case):
    scene, th = IMAGES[case]
    got = _port_image(scene, th, "fine2")[0]
    assert_bits(got, jax_side[f"{case}_image"]["image"], "image")
    assert_bits(got, _port_image(scene, th, "coarse")[0], "image (coarse route)")


def test_frame_matches_jax_fine2_route(port_frames, jax_side):
    """Colour, output and full depth, stats and the winner plane of the
    bench's 3-pass frame under FINE_MODE="fine2" (every pass, the excluded
    eyes included, takes the grouped strip raster)."""
    planes, _, stats, winner = port_frames[("multimesh", "fine2")]
    want = jax_side["multimesh_scene"]
    for k in PLANES:
        assert_bits(planes[k], want[f"{k}_1"], k)
    assert_bits(stats_vector(stats), want["stats_1"], "stats")
    assert_bits(winner, want["winner"], "winner")
    assert stats.fragments_exact and stats.fragments_drawn > 0


@pytest.mark.parametrize("name", list(FRAMES))
def test_fine2_frame_equals_coarse_frame(port_frames, name):
    """With stats (one init-seeded launch a pass) and without (pass-local)."""
    fine2, coarse = port_frames[(name, "fine2")], port_frames[(name, "coarse")]
    for i in (0, 1):
        for k in PLANES:
            assert_bits(fine2[i][k], coarse[i][k], k)
    assert fine2[2] == coarse[2]
    assert_bits(fine2[3], coarse[3], "winner")


@pytest.mark.parametrize("name", list(WALLS))
def test_wall_scenes_match_the_oracle(name):
    """The bench's stress and mixed scenes, cut to a small grid: both entry
    points under "fine2" against the port's f32 oracle."""
    sc = WALLS[name](**WALL_SIZE)
    ref = tscene.oracle_render(sc)
    with fine_mode("fine2"):
        r = tscene.render_scene(sc, "cpu")
        image = tscene.render_scene_image(sc, "cpu")
    for k in PLANES:
        assert_bits(getattr(r, k).numpy(), getattr(ref, k), k)
    assert_bits(image.numpy(), ref.color, "image")
    assert r.stats == ref.stats and r.stats.fragments_drawn > 0


def test_z_ties_go_to_the_first_drawn():
    """Every triangle drawn twice: the first copy must win each tie."""
    p, w, h = scene_pass("head_phong")
    attrs = {k: np.concatenate([v, v]) for k, v in p.attrs.items()}
    f = p.attrs["position"].shape[0]
    attrs_t, uniforms_t = convert.pass_to_torch(attrs, p.uniforms, "cpu")
    pre = raster_fine2.pre_fine2(attrs_t, uniforms_t, p.shader, w, h, 32)
    _, winner, _ = raster_fine2.fine2_raster(pre.tri_rec, pre.tri8, pre.group_start,
                                             pre.group_rows, pre.x0y0, 32, 8)
    assert (winner >= 0).any() and int(winner.max()) < f


@pytest.mark.parametrize("case", [*KERNEL_CASES, *STACKS])
@pytest.mark.parametrize("range_len", RANGE_LENS)
@pytest.mark.parametrize("stats", [False, True])
def test_split_walk_equals_the_serial_walk(split_prepared, case, range_len, stats):
    """The CUDA kernels' decomposition in plain PyTorch: every group's rows
    cut into ranges of ``range_len``, each range's first minimum from +inf,
    the ranges merged in order with strict-less from the running depth
    (+inf pass-local, half finite with stats), and with stats each range
    walked again from its entering depth.  Bitwise the serial walk."""
    c = split_prepared[case]
    args = _raster_args(c)
    init = _init(c) if stats else None
    want = raster_fine2.fine2_raster_plain(*args, init, collect_stats=stats)
    got = raster_fine2.fine2_raster_split_plain(*args, init, collect_stats=stats,
                                                range_len=range_len)
    flat = lambda out: (*out[:3], *(out[3] if stats else ()))  # noqa: E731
    for name, g, w in zip(("depth", "winner", "vary", "event count", "event max z"),
                          flat(got), flat(want)):
        assert_bits(g.numpy(), w.numpy(), name)
    pre = c[0]
    if case == "head_stack_32":                    # groups of several ranges
        assert int(pre.group_rows[0]) > 3 * range_len
    if case == "soup_ties_16":                     # every tie goes to the first copy
        f = pre.tri_rec.shape[0] // 2
        assert (want[1] >= 0).any() and int(want[1].max()) < f


def test_wrapper_validates_inputs(prepared):
    c = prepared["head_phong_16"]
    args = list(_raster_args(c))
    init = _init(c)
    raster_fine2.fine2_raster(*args, init)
    for i, bad in ((1, args[1].reshape(-1)), (1, args[1].long()), (2, args[2].long()),
                   (3, args[3][:-1]), (4, args[4][..., :1]), (0, args[0].double())):
        broken = list(args)
        broken[i] = bad
        with pytest.raises(ValueError):
            raster_fine2.fine2_raster(*broken)
    with pytest.raises(ValueError, match="init_depth"):
        raster_fine2.fine2_raster(*args, init[:, :8])
    with pytest.raises(ValueError, match="room"):
        raster_fine2.fine2_raster(*args[:-1], 40)
    with pytest.raises(ValueError):
        raster_fine2.pre_fine2(*_pass("head_phong")[:3], 256, 128, 16, 64)


def test_cpu_raster_launches_no_kernel(prepared):
    reset_launches()
    c = prepared["soup_phong_ragged_32"]
    raster_fine2.fine2_raster(*_raster_args(c))
    raster_fine2.fine2_raster(*_raster_args(c), _init(c), collect_stats=True)
    assert launches("fine2_raster") == launches("fine2_raster_stats") == 0


# ---------------------------------------------------------------------------
# the CUDA kernel against its plain version (skipped without a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CASES, *STACKS])
@pytest.mark.parametrize("stats", [False, True])
def test_cuda_fine2_raster_matches_plain(split_prepared, cuda_device, case, stats):
    """Bitwise the plain version, pass-local and seeded with stats, on
    groups of one range and (the head stack) on groups of several ranges
    whose slots end at different rows, with z-ties on both sides of a range
    edge (STACKS)."""
    c = split_prepared[case]
    args = _raster_args(c)
    init = _init(c) if stats else None
    if case == "head_stack_32":
        from tinyrenderder_tpu_torch import _build
        pre = c[0]
        assert int(pre.group_rows[0]) > 3 * _build.constant("trt_fine2_range_rows")
        ends = (pre.tri8[:int(pre.group_rows[0])] >= 0).sum(dim=0)   # group 0's slot lengths
        assert int(ends.min()) < int(ends.max())
    want = raster_fine2.fine2_raster_plain(*args, init, collect_stats=stats)
    gpu = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in args]
    before = (launches("fine2_raster"), launches("fine2_raster_stats"))
    got = raster_fine2.fine2_raster(*gpu, None if init is None else init.to(cuda_device),
                                    collect_stats=stats)
    torch.cuda.synchronize()
    assert (launches("fine2_raster") - before[0], launches("fine2_raster_stats") - before[1]) == \
        ((0, 1) if stats else (1, 0))
    flat = lambda out: (*out[:3], *(out[3] if stats else ()))  # noqa: E731
    for g, w in zip(flat(got), flat(want)):
        assert_bits(g.cpu().numpy(), w.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FRAMES))
def test_cuda_fine2_frame_matches_cpu_frame(port_frames, cuda_device, name):
    with fine_mode("fine2"):
        reset_launches()
        r = tscene.render_scene(frame_scene(name), cuda_device)
        torch.cuda.synchronize()
    assert launches("fine2_raster_stats") == 3
    planes, _, stats, _ = port_frames[(name, "fine2")]
    for k in PLANES:
        assert_bits(getattr(r, k).cpu().numpy(), planes[k], k)
    assert r.stats == stats
