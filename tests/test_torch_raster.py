"""The port's binning, coarse raster and untiles against the JAX package.

JAX side, run as the JAX package's own tests run it on the CPU (Pallas in
interpret mode), in one subprocess for the module (tests/torch_parity.py
says why): ``raster_tiled._build_bins``,
``raster_pallas._pallas_call_sparse_jit(interpret=True)`` with and
without ``collect_stats``, ``raster_sparse._untile_one_jit`` and
``raster_sparse._untile_call_jit`` (both ``interpret=True``), and the
dense entry: ``rasterize_pallas`` / ``depth_resolve_pallas`` on the JAX
package's own ``bin_triangles_csr`` bins, and ``_pallas_call_jit`` with a
nonzero ``origin``.  Both sides get the same inputs, made on the port
side from one shared setup (and a seeded random running depth, half of
it finite).  Tolerance: bitwise.

Tests marked ``cuda`` compare the CUDA kernels with their plain versions
and skip where no GPU is present."""

import numpy as np
import pytest
import torch

from torch_parity import assert_bits, launches, reset_launches, run_jax, scene_pass
from tinyrenderder_tpu_torch import convert
from tinyrenderder_tpu_torch.ops import raster_coarse, raster_sparse, raster_tiled

#: raster cases: (scene of torch_parity.SCENES, tile_h)
CASES = {"head16": ("head_phong", 16), "soup32": ("soup_phong_ragged", 32)}
UNTILE = {"i32": (torch.int32, 2, 3, 16), "f32": (torch.float32, 3, 2, 32)}
#: dense-entry cases: (scene of torch_parity.SCENES, width, height, tile_h,
#: origin or None); ragged frames, the last three with empty tiles
DENSE = {"head_97x61": ("head_phong", 97, 61, 16, None),
         "cube_97x61": ("cube_gouraud", 97, 61, 16, None),
         "head_300x61": ("head_phong", 300, 61, 16, None),
         "head_300x61_th32_origin": ("head_phong", 300, 61, 32, (5, 3))}


#: split-walk cases, port only: (scene, tile_h, the scale of each copy of
#: the pass's triangles, drawn one copy after another).  A z-tie soup (every
#: triangle drawn twice, the copies after all the originals, so each tie's
#: two pairs fall on both sides of a range edge) and a stack of four heads
#: (two exact copies, then one scaled up and one down: bins of several
#: ranges, whose later ranges win pixels)
STACKS = {"soup_ties16": ("soup_phong_ragged", 16, (1.0, 1.0)),
          "head_stack32": ("head_phong", 32, (1.0, 1.0, 1.02, 0.98))}
#: the dense entry on a stack of heads: a ragged frame, empty tiles, long bins
DENSE_STACKS = {"head_stack_300x61": ("head_phong", 300, 61, 16, None,
                                      (1.0, 1.0, 1.02, 0.98))}
RANGE_LENS = (1, 7, 64)


def _copies(attrs, scales):
    """The pass's triangles drawn once for each scale, positions scaled."""
    return {k: np.concatenate([v * np.float32(s) if k == "position" else v for s in scales])
            for k, v in attrs.items()}


def _prepare(scene, th, seed, scales=(1.0,)):
    """Port-side pre-stage pieces at one shared setup, as NumPy."""
    p, w, h = scene_pass(scene)
    attrs, uniforms = convert.pass_to_torch(_copies(p.attrs, scales), p.uniforms, "cpu")
    setup, varyings = raster_tiled.vertex_stage(attrs, uniforms, p.shader, w, h)
    ntx, nty = raster_tiled.cdiv(w, 128), raster_tiled.cdiv(h, th)
    tx0, ty0, span_x, span_y, spans = raster_tiled.tile_spans(setup, 128, th)
    per_tile = raster_tiled.tile_pair_counts(tx0, ty0, span_x, span_y, ntx, nty)
    total = int(per_tile.sum())
    sorted_tri, start, counts = raster_tiled.build_bins(tx0, ty0, span_x, spans,
                                                        total, ntx, nty)
    spec = tuple(p.shader.varying_spec.items())
    vary_corners = raster_tiled.flatten_varyings(varyings, spec)
    ids = torch.nonzero(counts > 0)[:, 0].to(torch.int32)
    rng = np.random.default_rng(seed)
    depth_tiles = rng.uniform(-0.2, 1.0, size=(ntx * nty, th, 128)).astype(np.float32)
    depth_tiles[rng.random(depth_tiles.shape) < 0.5] = np.inf
    n = lambda t: t.numpy()  # noqa: E731
    return {
        "setup": {k: n(v) for k, v in setup.items()},
        "spans": {"tx0": n(tx0), "ty0": n(ty0), "span_x": n(span_x), "spans": n(spans)},
        "per_tile": n(per_tile), "total": total, "ntx": ntx, "nty": nty, "th": th,
        "bins": (n(sorted_tri), n(start), n(counts)),
        "vary_corners": n(vary_corners), "n_vary": vary_corners.shape[-1],
        "ids": n(ids), "depth_tiles": depth_tiles,
    }


@pytest.fixture(scope="module")
def prepared():
    return {name: _prepare(scene, th, seed)
            for seed, (name, (scene, th)) in enumerate(CASES.items())}


@pytest.fixture(scope="module")
def split_prepared(prepared):
    """``prepared`` and the STACKS cases."""
    return {**prepared, **{name: _prepare(scene, th, 30 + i, scales)
                           for i, (name, (scene, th, scales)) in enumerate(STACKS.items())}}


def _prepare_dense(scene, w, h, th, origin, seed, scales=(1.0,)):
    """A pass's setup, varying corners and a running depth (H, W), half
    finite, as NumPy; the port's bins of the setup."""
    p, _, _ = scene_pass(scene)
    attrs, uniforms = convert.pass_to_torch(_copies(p.attrs, scales), p.uniforms, "cpu")
    setup, varyings = raster_tiled.vertex_stage(attrs, uniforms, p.shader, w, h)
    vary_corners = raster_tiled.shader_varyings(varyings, p.shader)
    rng = np.random.default_rng(seed)
    init = rng.uniform(-0.2, 1.0, size=(h, w)).astype(np.float32)
    init[rng.random(init.shape) < 0.5] = np.inf
    return {"setup": {k: v.numpy() for k, v in setup.items()},
            "vary_corners": vary_corners.numpy(), "init": init, "w": w, "h": h, "th": th,
            "origin": origin, "bins": raster_tiled.bin_triangles_csr(setup, w, h, 128, th)}


@pytest.fixture(scope="module")
def dense_inputs():
    return {name: _prepare_dense(*case, seed=20 + i)
            for i, (name, case) in enumerate(DENSE.items())}


@pytest.fixture(scope="module")
def dense_stack_inputs(dense_inputs):
    """``dense_inputs`` and the DENSE_STACKS cases."""
    return {**dense_inputs, **{name: _prepare_dense(*case[:5], seed=40 + i, scales=case[5])
                               for i, (name, case) in enumerate(DENSE_STACKS.items())}}


def _dense_port(c, device="cpu"):
    """The port's rasterize and depth_resolve of a dense case on ``device``."""
    setup = {k: torch.from_numpy(v).to(device) for k, v in c["setup"].items()}
    bins = raster_tiled.Bins(*(x.to(device) for x in c["bins"][:3]), *c["bins"][3:])
    init = torch.from_numpy(c["init"]).to(device)
    kw = {"tile_h": c["th"], "tile_w": 128, "origin": c["origin"] or (0, 0)}
    full = raster_coarse.rasterize(setup, bins, init, c["h"], c["w"],
                                   torch.from_numpy(c["vary_corners"]).to(device), **kw)
    return full, raster_coarse.depth_resolve(setup, bins, init, c["h"], c["w"], **kw)


@pytest.fixture(scope="module")
def untile_inputs():
    rng = np.random.default_rng(11)
    out = {}
    for name, (dtype, ntx, nty, th) in UNTILE.items():
        x = rng.integers(-2**31, 2**31 - 1, size=(ntx * nty, th, 128), dtype=np.int64)
        x = x.astype(np.int32)
        if dtype == torch.float32:
            x = rng.normal(size=x.shape).astype(np.float32)
            x[0, 0, :4] = [np.inf, -np.inf, -0.0, np.nan]
        out[name] = (x, ntx, nty, th)
    return out


@pytest.fixture(scope="module")
def untile3_inputs():
    """Random packed-colour, depth (with inf, -0.0 and NaN) and winner
    planes, ragged (3x2 tiles) and 32-row (2x3 tiles)."""
    rng = np.random.default_rng(12)
    out = {}
    for name, (ntx, nty, th) in {"ragged16": (3, 2, 16), "th32": (2, 3, 32)}.items():
        shape = (ntx * nty, th, 128)
        color = rng.integers(0, 1 << 24, size=shape, dtype=np.int64).astype(np.int32)
        depth = rng.normal(size=shape).astype(np.float32)
        depth[0, 0, :4] = [np.inf, -np.inf, -0.0, np.nan]
        winner = rng.integers(-1, 5000, size=shape, dtype=np.int64).astype(np.int32)
        out[name] = ((color, depth, winner), ntx, nty, th)
    return out


@pytest.fixture(scope="module")
def jax_side(prepared, untile_inputs, untile3_inputs, dense_inputs, tmp_path_factory):
    req = {}
    for name, c in dense_inputs.items():
        req[f"{name}_dense"] = {"op": "dense", **c["setup"], "vary_corners": c["vary_corners"],
                                "init": c["init"], "w": c["w"], "h": c["h"], "th": c["th"]}
        if c["origin"] is not None:
            req[f"{name}_dense"]["origin"] = np.asarray(c["origin"], np.int32)
    for name, c in prepared.items():
        req[f"{name}_bins"] = {"op": "bins", **c["spans"], "total": c["total"],
                               "ntx": c["ntx"], "nty": c["nty"]}
        sorted_tri, start, counts = c["bins"]
        ids = c["ids"]
        raster_req = {
            "op": "raster", **c["setup"], "sorted_tri": sorted_tri,
            "vary_corners": c["vary_corners"], "ids": ids, "start": start[:-1][ids],
            "counts": counts[ids], "depth_tiles": c["depth_tiles"], "ntx": c["ntx"],
            "nty": c["nty"], "th": c["th"], "tw": 128, "n_vary": c["n_vary"]}
        req[f"{name}_raster"] = raster_req
        req[f"{name}_raster_stats"] = {**raster_req, "stats": 1}
    for name, (x, ntx, nty, th) in untile_inputs.items():
        req[f"{name}_untile"] = {"op": "untile", "x": x, "ntx": ntx, "nty": nty,
                                 "th": th, "tw": 128}
    for name, ((color, depth, winner), ntx, nty, th) in untile3_inputs.items():
        req[f"{name}_untile3"] = {"op": "untile3", "color": color, "depth": depth,
                                  "winner": winner, "ntx": ntx, "nty": nty, "th": th,
                                  "tw": 128}
    return run_jax(req, tmp_path_factory.mktemp("jax_raster"))


def _raster_args(c):
    """coarse_raster's positional arguments for a prepared case."""
    sorted_tri, start, counts = (torch.from_numpy(a) for a in c["bins"])
    ids = torch.from_numpy(c["ids"])
    setup = {k: torch.from_numpy(v) for k, v in c["setup"].items()}
    rec = raster_coarse.build_tri_records(setup, torch.from_numpy(c["vary_corners"]))
    init = torch.from_numpy(c["depth_tiles"])[ids.long()].contiguous()
    return (rec, sorted_tri, ids, start[:-1][ids.long()], counts[ids.long()], init,
            c["ntx"], c["th"], 128, c["n_vary"])


def _raster_plain(c, collect_stats=False):
    return raster_coarse.coarse_raster(*_raster_args(c), collect_stats=collect_stats)


@pytest.mark.parametrize("case", list(CASES))
def test_bins_match_jax(prepared, jax_side, case):
    c = prepared[case]
    want = jax_side[f"{case}_bins"]
    assert c["total"] > 0
    for name, got in zip(("sorted_tri", "start", "counts"), c["bins"]):
        assert_bits(got, want[name], name)


@pytest.mark.parametrize("case", list(CASES))
def test_tile_pair_counts_equal_bin_counts(prepared, case):
    c = prepared[case]
    assert_bits(c["per_tile"], c["bins"][2], "per-tile pair counts")


@pytest.mark.parametrize("case", list(CASES))
def test_coarse_raster_plain_matches_pallas(prepared, jax_side, case):
    """Depth, winner and every varying plane bitwise against the TPU
    kernel in interpret mode, merged against a random running depth."""
    c = prepared[case]
    want = jax_side[f"{case}_raster"]
    depth, winner, vary = _raster_plain(c)
    assert_bits(depth.numpy(), want["depth"], "depth")
    # the TPU kernel carries ids as exact f32 (< 2^24), -1 = background
    assert_bits(winner.numpy(), want["winner"].astype(np.int32), "winner")
    assert_bits(vary.numpy(), want["vary"], "varyings")
    won = winner.numpy() >= 0
    assert won.any() and (~won).any()
    assert (depth.numpy()[~won] == c["depth_tiles"][c["ids"]][~won]).all()


@pytest.mark.parametrize("case", list(CASES))
def test_coarse_raster_event_planes_match_pallas(prepared, jax_side, case):
    """The stats variant against the TPU kernel's collect_stats launch:
    depth, winner and varyings as without stats, the event count (the
    TPU's f32 plane cast to int32) and the largest event z bitwise."""
    c = prepared[case]
    want = jax_side[f"{case}_raster_stats"]
    depth, winner, vary, (count, max_z) = _raster_plain(c, collect_stats=True)
    assert_bits(depth.numpy(), want["depth"], "depth")
    assert_bits(winner.numpy(), want["winner"].astype(np.int32), "winner")
    assert_bits(vary.numpy(), want["vary"], "varyings")
    assert_bits(count.numpy(), want["ev"][:, 0].astype(np.int32), "event count")
    assert_bits(max_z.numpy(), want["ev"][:, 1], "event max z")
    won = winner.numpy() >= 0
    assert won.any() and (count.numpy()[won] >= 1).all()  # a win is an event
    assert (count.numpy()[~won] == 0).all()               # no event, no winner


@pytest.mark.parametrize("case", list(CASES))
def test_event_planes_leave_the_raster_unchanged(prepared, case):
    plain = _raster_plain(prepared[case])
    stats = _raster_plain(prepared[case], collect_stats=True)
    for name, a, b in zip(("depth", "winner", "vary"), stats, plain):
        assert_bits(a.numpy(), b.numpy(), name)


@pytest.mark.parametrize("name", ["ragged16", "th32"])
def test_untile3_plain_matches_pallas(untile3_inputs, jax_side, name):
    planes, ntx, nty, th = untile3_inputs[name]
    got = raster_sparse.untile3(*(torch.from_numpy(x) for x in planes), ntx, nty, th, 128)
    want = jax_side[f"{name}_untile3"]
    for k, g in zip(("color", "depth", "winner"), got):
        assert_bits(g.numpy(), want[k], k)


@pytest.mark.parametrize("name", list(UNTILE))
def test_untile_plain_matches_pallas(untile_inputs, jax_side, name):
    x, ntx, nty, th = untile_inputs[name]
    got = raster_sparse.untile_one(torch.from_numpy(x), ntx, nty, th, 128)
    assert_bits(got.numpy(), jax_side[f"{name}_untile"]["out"], "untile")


@pytest.mark.parametrize("case", list(DENSE))
def test_dense_raster_plain_matches_pallas(dense_inputs, jax_side, case):
    """``rasterize`` (depth, winner, every varying plane) and
    ``depth_resolve`` bitwise against ``rasterize_pallas`` /
    ``depth_resolve_pallas`` on the JAX package's own bins (with an
    origin, against ``_pallas_call_jit(origin=...)``); an empty tile keeps
    its init depth, winner -1 and zero varyings."""
    c = dense_inputs[case]
    want = jax_side[f"{case}_dense"]
    assert_bits(c["bins"].counts.numpy(), want["counts"], "bin counts")
    (depth, winner, vary), (depth0, winner0) = _dense_port(c)
    assert_bits(depth.numpy(), want["depth"], "depth")
    assert_bits(winner.numpy(), want["winner"], "winner")
    assert_bits(vary.numpy(), want["vary"], "varyings")
    if c["origin"] is None:
        assert_bits(depth0.numpy(), want["depth_only"], "depth_resolve depth")
        assert_bits(winner0.numpy(), want["winner_only"], "depth_resolve winner")
    won = winner.numpy() >= 0
    assert won.any() and (~won).any()
    assert_bits(depth.numpy()[~won], c["init"][~won], "depth where no triangle won")
    assert not vary.numpy()[:, ~won].any()
    if case != "head_97x61":
        assert (c["bins"].counts == 0).any()


def _planes(out, stats):
    """(depth, winner, vary[, event count, event max z]) of a raster."""
    return (*out[:3], *(out[3] if stats else ()))


@pytest.mark.parametrize("case", [*CASES, *STACKS])
@pytest.mark.parametrize("range_len", RANGE_LENS)
@pytest.mark.parametrize("stats", [False, True])
def test_split_walk_equals_the_serial_walk(split_prepared, case, range_len, stats):
    """The CUDA kernels' decomposition in plain PyTorch: every bin cut into
    ranges of ``range_len`` pairs, each range's first minimum from +inf,
    the ranges merged in order with strict-less from the running depth
    (half of it finite), and with stats each range walked again from its
    entering depth.  Bitwise the serial walk, ties and events included."""
    c = split_prepared[case]
    args = _raster_args(c)
    want = raster_coarse.coarse_raster_plain(*args, collect_stats=stats)
    got = raster_coarse.coarse_raster_split_plain(*args, collect_stats=stats,
                                                  range_len=range_len)
    names = ("depth", "winner", "vary", "event count", "event max z")
    for name, g, w in zip(names, _planes(got, stats), _planes(want, stats)):
        assert_bits(g.numpy(), w.numpy(), name)
    if case == "head_stack32":                     # bins of several ranges
        assert int(c["bins"][2].max()) > 3 * range_len
    if case == "soup_ties16":                      # every tie goes to the first copy
        f = c["setup"]["valid"].shape[0] // 2
        assert (want[1] >= 0).any() and int(want[1].max()) < f


def test_dense_raster_counts_no_cpu_launch(dense_inputs):
    reset_launches()
    _dense_port(dense_inputs["cube_97x61"])
    assert launches("dense_raster") == 0


def test_z_ties_go_to_the_first_drawn():
    """Every triangle drawn twice: each covered pixel's depth ties, and the
    first copy must win (the reference's strict-less z-test)."""
    p, w, h = scene_pass("head_phong")
    attrs = {k: np.concatenate([v, v]) for k, v in p.attrs.items()}
    f = p.attrs["position"].shape[0]
    attrs_t, uniforms_t = convert.pass_to_torch(attrs, p.uniforms, "cpu")
    pre = raster_sparse.pre_sparse(attrs_t, uniforms_t, p.shader, w, h)
    init = torch.full((pre.n_active, 16, 128), torch.inf)
    _, winner, _ = raster_coarse.coarse_raster(
        pre.tri_rec, pre.sorted_tri, pre.ids, pre.start, pre.counts, init,
        raster_tiled.cdiv(w, 128), 16, 128, 8)
    assert (winner >= 0).any()
    assert int(winner.max()) < f


def test_wrappers_validate_inputs(prepared):
    c = prepared["head16"]
    sorted_tri, start, counts = (torch.from_numpy(a) for a in c["bins"])
    ids = torch.from_numpy(c["ids"])
    rec = torch.zeros((c["setup"]["valid"].shape[0], 40))
    init = torch.zeros((ids.shape[0], 16, 128))
    good = (rec, sorted_tri, ids, start[:-1][ids.long()], counts[ids.long()], init,
            c["ntx"], 16, 128, 8)
    raster_coarse.coarse_raster(*good)
    for i, bad in ((0, rec.double()), (2, ids.long()), (5, init[:, :8]),
                   (0, rec.t())):
        args = list(good)
        args[i] = bad
        with pytest.raises(ValueError):
            raster_coarse.coarse_raster(*args)
    with pytest.raises(ValueError, match="room"):
        raster_coarse.coarse_raster(*good[:-1], 9)
    tiles = torch.zeros((6, 16, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        raster_sparse.untile_one(tiles, 2, 2, 16, 128)
    with pytest.raises(ValueError):
        raster_sparse.untile_one(tiles.to(torch.int16), 2, 3, 16, 128)
    depth = torch.zeros((6, 16, 128))
    raster_sparse.untile3(tiles, depth, tiles, 2, 3, 16, 128)
    for bad in ((tiles, tiles, tiles), (tiles, depth, depth), (tiles[:4], depth, tiles),
                (tiles, depth.transpose(1, 2).contiguous(), tiles)):
        with pytest.raises(ValueError):
            raster_sparse.untile3(*bad, 2, 3, 16, 128)


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (skipped without a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _long_bins(counts):
    """Check that some bin spans several of the CUDA kernel's ranges."""
    from tinyrenderder_tpu_torch import _build
    assert int(counts.max()) > 3 * _build.constant("trt_coarse_range_pairs")


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CASES, *STACKS])
def test_cuda_coarse_raster_matches_plain(split_prepared, cuda_device, case):
    """Bitwise the plain version, on bins of one range and (the head stack)
    of several, with z-ties on both sides of a range edge (STACKS)."""
    c = split_prepared[case]
    if case == "head_stack32":
        _long_bins(c["bins"][2])
    sorted_tri, start, counts = (torch.from_numpy(a) for a in c["bins"])
    idl = torch.from_numpy(c["ids"]).long()
    setup = {k: torch.from_numpy(v) for k, v in c["setup"].items()}
    rec = raster_coarse.build_tri_records(setup, torch.from_numpy(c["vary_corners"]))
    args = [rec, sorted_tri, idl.int(), start[:-1][idl], counts[idl],
            torch.from_numpy(c["depth_tiles"])[idl].contiguous()]
    want = raster_coarse.coarse_raster_plain(*args, c["ntx"], c["th"], 128, c["n_vary"])
    before = launches("coarse_raster")
    got = raster_coarse.coarse_raster(*(a.to(cuda_device) for a in args), c["ntx"],
                                      c["th"], 128, c["n_vary"])
    torch.cuda.synchronize()
    assert launches("coarse_raster") == before + 1
    for name, g, w in zip(("depth", "winner", "vary"), got, want):
        assert_bits(g.cpu().numpy(), w.numpy(), name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*CASES, *STACKS])
def test_cuda_coarse_raster_event_planes_match_plain(split_prepared, cuda_device, case):
    """The seeded events walk: bitwise the plain version's event planes, on
    bins of one range and (the head stack) of several, from a running
    depth half finite."""
    args = _raster_args(split_prepared[case])
    if case == "head_stack32":
        _long_bins(args[4])
    want = raster_coarse.coarse_raster_plain(*args, collect_stats=True)
    gpu = [a.to(cuda_device) if isinstance(a, torch.Tensor) else a for a in args]
    before = launches("coarse_raster_stats")
    got = raster_coarse.coarse_raster(*gpu, collect_stats=True)
    without = raster_coarse.coarse_raster(*gpu)
    torch.cuda.synchronize()
    assert launches("coarse_raster_stats") == before + 1
    names = ("depth", "winner", "vary", "event count", "event max z")
    for name, g, w in zip(names, (*got[:3], *got[3]), (*want[:3], *want[3])):
        assert_bits(g.cpu().numpy(), w.numpy(), name)
    for name, g, w in zip(names, got[:3], without):
        assert_bits(g.cpu().numpy(), w.cpu().numpy(), name)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*DENSE, *DENSE_STACKS])
def test_cuda_dense_raster_matches_plain(dense_stack_inputs, cuda_device, case):
    """The dense launch (no tile list, every tile) against the plain
    version, through ``rasterize`` and ``depth_resolve``: empty tiles
    (all but the first case) beside (DENSE_STACKS) bins of several
    ranges."""
    c = dense_stack_inputs[case]
    if case in DENSE_STACKS:
        _long_bins(c["bins"].counts)
        assert (c["bins"].counts == 0).any()
    want = _dense_port(c)
    before = launches("dense_raster")
    got = _dense_port(c, cuda_device)
    torch.cuda.synchronize()
    assert launches("dense_raster") == before + 2
    for name, g, w in zip(("depth", "winner", "vary", "depth only", "winner only"),
                          (*got[0], *got[1]), (*want[0], *want[1])):
        assert_bits(g.cpu().numpy(), w.numpy(), name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ragged16", "th32"])
def test_cuda_untile3_matches_plain(untile3_inputs, cuda_device, name):
    planes, ntx, nty, th = untile3_inputs[name]
    cpu = [torch.from_numpy(x) for x in planes]
    before = launches("untile3", "untile3_image")
    got = raster_sparse.untile3(*(x.to(cuda_device) for x in cpu), ntx, nty, th, 128)
    torch.cuda.synchronize()
    assert launches("untile3", "untile3_image") == before + 1
    for k, g, w in zip(("color", "depth", "winner"), got,
                       raster_sparse.untile3_plain(*cpu, ntx, nty, th, 128)):
        assert_bits(g.cpu().numpy(), w.numpy(), k)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(UNTILE))
def test_cuda_untile_matches_plain(untile_inputs, cuda_device, name):
    x, ntx, nty, th = untile_inputs[name]
    xt = torch.from_numpy(x)
    before = launches("untile_one", "untile_image")
    got = raster_sparse.untile_one(xt.to(cuda_device), ntx, nty, th, 128)
    torch.cuda.synchronize()
    assert launches("untile_one", "untile_image") == before + 1
    assert_bits(got.cpu().numpy(),
                raster_sparse.untile_one_plain(xt, ntx, nty, th, 128).numpy(), "untile")
