"""The hand-written pre-stage (``csrc/pre.cu`` through
``raster_sparse.pre_sparse``) against its plain version,
``raster_sparse.pre_sparse_plain``.

On the CPU: the viewport scalars it takes instead of an uploaded matrix
equal ``math3d.viewport(0, 0, w, h)`` in float32; the routing predicate
(``pre_kind``) sends each shader class, dtype, device type and band where
it should, and raises on a pass on the card whose inputs the kernel
cannot read (meta tensors stand in for the card's); ``pre_sparse`` on
CPU tensors still equals the JAX package's ``_pre_sparse_jit`` and counts
``pre.plain``.

Under the ``cuda`` marker, on the card: every ``PreSparse`` field and the
setup's, bitwise, for Phong, Eye, ``ShadowMappedShader``,
``DepthShader`` and ``GrayDepthShader`` passes at 1200x800 with 16-row
tiles, at 2048x2048 with 32-row tiles and on a grid too large for the
kernels' per-tile counters in shared memory: the walk's and the sun
walk's first views (``rasterbench.scenes`` at the tiny plan) and a stress
set (triangles behind the eye and at w = 0, NaN and inf corners,
degenerate and back-facing triangles, triangles off the frame and clamped
at every edge, one over every tile, coincident triangles whose z-ties
keep submission order, an all-invalid pass, a 1-triangle pass, counts of
triangles that are not a multiple of the kernel's range); a pass of no
triangles and one with strided matrices; and a pass makes at most five
device operations."""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from torch_parity import assert_bits, run_jax, scene_pass
from tinyrenderder_tpu_torch import _build, convert, math3d, shaders, trace
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.ops import raster_sparse
from tinyrenderder_tpu_torch.ops.raster_tiled import Band

PRE_CU = raster_sparse.__file__.rsplit("/ops/", 1)[0] + "/csrc/pre.cu"
LIGHTS = (np.array([0.5, 0.7, 0.5]), np.array([-0.3, 0.5, 0.2]), np.array([-1.0, 0.8, -1.5]))

#: shader factory -> the vertex stage the kernel computes (None: plain)
SHADERS = {
    "phong": (lambda: shaders.PhongShader(*LIGHTS, normal_map_strength=0.5), 0),
    "eye": (lambda: shaders.EyeShader(LIGHTS[0], LIGHTS[2]), 0),
    "shadow_phong": (lambda: shaders.ShadowMappedShader(*LIGHTS, shadow_matrix=np.eye(4),
                                                        shadow_map=None), 1),
    "depth": (lambda: shaders.DepthShader(), 2),
    "gray_depth": (lambda: shaders.GrayDepthShader(), 3),
    "flat": (lambda: shaders.FlatShader(), None),
    "gouraud": (lambda: shaders.GouraudShader(), None),
    "textured": (lambda: shaders.TexturedShader(), None),
}
KERNEL_SHADERS = [k for k, (_, kind) in SHADERS.items() if kind is not None]
#: the kernels' constants, read from the source
PRE_SRC = open(PRE_CU).read()
K_RANGE = int(re.search(r"constexpr int kRange = (\d+);", PRE_SRC).group(1))
K_SHARED_TILES = int(re.search(r"constexpr int kSharedTiles = (\d+);", PRE_SRC).group(1))
#: (width, height, tile_h) the card's cases run at; the last grid, of
#: 64 x 256 tiles, counts in global memory
SIZES = ((1200, 800, 16), (2048, 2048, 32), (8192, 4096, 16))


# ---------------------------------------------------------------------------
# the stress set
# ---------------------------------------------------------------------------

CCW = np.array([[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [0.0, 1.0, 0.0]])


def eye_pass(eye_tris, seed: int, identity: bool = False):
    """(attrs {position, normal, uv: (F, 3, C) float32}, modelview,
    perspective) of triangles given in eye space: their world corners
    under a look-at modelview, or under the identity (then a corner at
    z = 0 has clip w = 0 exactly)."""
    rng = np.random.default_rng(seed)
    eye = np.asarray(eye_tris, dtype=np.float64).reshape(-1, 3, 3)
    mv = np.eye(4) if identity else math3d.lookat(np.array([0.4, 0.3, 3.0]), np.zeros(3),
                                                  np.array([0.0, 1.0, 0.0]))
    persp = math3d.perspective(60.0, 1.5, 0.1, 100.0)
    with np.errstate(all="ignore"):
        h = np.concatenate([eye, np.ones(eye.shape[:-1] + (1,))], -1)
        world = eye if identity else (h @ np.linalg.inv(mv).T)[..., :3]
    f = world.shape[0]
    nrm = rng.normal(size=(f, 3, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    attrs = {"position": world.astype(np.float32), "normal": nrm.astype(np.float32),
             "uv": rng.uniform(0, 1, (f, 3, 2)).astype(np.float32)}
    return attrs, mv.astype(np.float32), persp.astype(np.float32)


def special_triangles() -> list:
    """Eye-space triangles for every case of the setup and the bins."""
    tris = []
    for z in (0.0, 1e-7, -1e-7, 1.0, 5.0):                 # w = 0, w ~ 0, behind the eye
        tris.append(CCW * 0.5 + [0.0, 0.0, z])
    tris.append([[0.0, 0.0, -2.0], [0.0, 0.0, 0.0], [1.0, 0.0, -2.0]])   # one corner at w = 0
    for bad in (np.nan, np.inf, -np.inf):                   # non-finite corners
        t = CCW * 0.3 + [0.0, 0.0, -3.0]
        t[1, 0] = bad
        tris.append(t)
    tris.append(np.full((3, 3), np.nan))
    tris.append([[0.0, 0.0, -3.0], [0.5, 0.5, -3.0], [1.0, 1.0, -3.0]])  # collinear
    tris.append([[0.2, 0.1, -3.0]] * 3)                                  # one point
    tris.append((CCW * 0.4 + [0.0, 0.0, -3.0])[::-1])                    # back-facing
    for dx, dy in ((-60, 0), (60, 0), (0, -60), (0, 60), (-60, -60)):    # off the frame
        tris.append(CCW + [dx, dy, -3.0])
    for dx, dy in ((-2.2, 0), (2.2, 0), (0, -1.7), (0, 1.7), (-2.2, -1.7), (2.2, 1.7)):
        tris.append(CCW * 0.8 + [dx, dy, -2.0])                          # clamped at an edge
    tris.append(CCW * 400.0 + [0.0, 100.0, -3.0])                        # over every tile
    tris.append(CCW * 0.5 + [0.0, 0.0, -200.0])                          # past the far plane
    tris.append(CCW * 0.01 + [0.0, 0.0, -0.05])                          # at the near plane
    for _ in range(3):                                                   # z-ties, interleaved
        tris.append(CCW * 0.7 + [0.1, 0.1, -4.0])
        tris.append(CCW * 0.3 + [-0.4, 0.2, -4.5])
    return tris


def random_triangles(n: int, seed: int) -> np.ndarray:
    """``n`` seeded eye-space triangles in front of the eye, of either
    winding, with piles of coincident ones."""
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(-12, -1, n)], -1)
    r = rng.uniform(0.01, 0.6, (n, 3, 3)) * rng.choice([-1, 1], (n, 3, 3))
    tris = c[:, None, :] + r
    for i in range(0, n - 4, 97):
        tris[i + 1:i + 4] = tris[i]
    return tris


def stress_passes() -> dict:
    """name -> (attrs, modelview, perspective): the stress set under both
    modelviews, an all-invalid pass (behind the eye, back-facing, NaN), a
    1-triangle pass, and a large pile; none a multiple of the kernel's
    range."""
    special = special_triangles()
    invalid = ([CCW * 0.5 + [0.0, 0.0, z] for z in (1.0, 2.0, 0.0)]
               + [(CCW * 0.4 + [0.0, 0.0, -3.0])[::-1], np.full((3, 3), np.nan),
                  CCW + [60.0, 0.0, -3.0]])
    return {
        "stress_lookat": eye_pass([*random_triangles(1500, 7), *special], 7),
        "stress_identity": eye_pass([*special, *random_triangles(1037, 8)], 8, identity=True),
        "all_invalid": eye_pass(invalid, 9),
        "one": eye_pass([CCW * 0.5 + [0.0, 0.0, -3.0]], 10),
        "big_pile": eye_pass([*random_triangles(5000, 11), *special], 11),
    }


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(1200, 800), (2048, 2048), (160, 96), (1, 1), (1023, 777)])
def test_viewport_scalars_are_the_viewport_in_float32(size):
    """The kernel's eight viewport scalars equal rows 0 and 1 of the matrix
    the plain version uploads (``math3d.viewport`` through
    ``torch.as_tensor(..., dtype=float32)``), bit for bit."""
    w, h = size
    want = torch.as_tensor(math3d.viewport(0, 0, w, h), dtype=torch.float32)[:2].reshape(-1)
    got = torch.tensor(raster_sparse.viewport_scalars(w, h), dtype=torch.float32)
    assert_bits(got.numpy(), want.numpy(), "viewport")


def _meta_pass(shader_name="phong", f=64, dtype=torch.float32, normal_dtype=None,
               matrix_dtype=torch.float32, device="meta"):
    pos = torch.empty((f, 3, 3), dtype=dtype, device=device)
    attrs = {"position": pos,
             "normal": torch.empty((f, 3, 3), dtype=normal_dtype or dtype, device=device),
             "uv": torch.empty((f, 3, 2), dtype=dtype, device=device)}
    uniforms = {"modelview": torch.empty((4, 4), dtype=matrix_dtype, device=device),
                "perspective": torch.empty((4, 4), dtype=matrix_dtype, device=device)}
    return attrs, uniforms, SHADERS[shader_name][0]()


@pytest.fixture
def meta_is_a_card(monkeypatch):
    """The predicate's device check reads meta tensors as the card's."""
    monkeypatch.setattr(raster_sparse, "_PRE_DEVICE", "meta")


@pytest.mark.parametrize("name", list(SHADERS))
def test_route_by_shader_class(meta_is_a_card, name):
    attrs, uniforms, shader = _meta_pass(name)
    assert raster_sparse.pre_kind(attrs, uniforms, shader) == SHADERS[name][1]


@pytest.mark.parametrize("case", ["position_f64", "position_f16", "normal_f64", "matrix_f64"])
def test_route_other_dtypes_take_the_plain_version(meta_is_a_card, case):
    kw = {"position_f64": {"dtype": torch.float64}, "position_f16": {"dtype": torch.float16},
          "normal_f64": {"normal_dtype": torch.float64},
          "matrix_f64": {"matrix_dtype": torch.float64}}[case]
    attrs, uniforms, shader = _meta_pass("phong", **kw)
    assert raster_sparse.pre_kind(attrs, uniforms, shader) is None


@pytest.mark.parametrize("case", ["strided_matrix", "no_faces"])
def test_route_takes_what_the_kernel_adapts_to(meta_is_a_card, case):
    """Strided matrices are made contiguous, and a pass of no faces returns
    without a launch: both take the kernel's route."""
    attrs, uniforms, shader = _meta_pass("phong", f=0 if case == "no_faces" else 64)
    if case == "strided_matrix":
        uniforms["modelview"] = torch.empty((4, 8), device="meta")[:, ::2]
    assert raster_sparse.pre_kind(attrs, uniforms, shader) == 0


@pytest.mark.parametrize("case", ["short_corner", "normal_elsewhere", "matrix_elsewhere",
                                  "matrix_3x4", "spec_changed", "writes_color_changed"])
def test_route_raises_on_inputs_the_kernel_cannot_read(meta_is_a_card, case):
    """A pass on the card that the kernel takes by its class, band and
    dtypes, but whose inputs it cannot read, raises: it does not give way
    to the plain version."""
    attrs, uniforms, shader = _meta_pass("phong")
    if case == "short_corner":
        attrs["uv"] = torch.empty((64, 3, 1), device="meta")
    elif case == "normal_elsewhere":
        attrs["normal"] = torch.empty((64, 3, 3))
    elif case == "matrix_elsewhere":
        uniforms["perspective"] = torch.empty((4, 4))
    elif case == "matrix_3x4":
        uniforms["modelview"] = torch.empty((3, 4), device="meta")
    elif case == "spec_changed":
        shader.varying_spec = {"uv": 2, "normal_eye": 3, "position_eye": 3}
    elif case == "writes_color_changed":
        shader.writes_color = False
    with pytest.raises(ValueError, match="pre_sparse"):
        raster_sparse.pre_kind(attrs, uniforms, shader)


def test_route_depth_passes_need_no_normals(meta_is_a_card):
    """A depth-only pass reads positions alone: its normals and uvs may be
    of any dtype."""
    attrs, uniforms, _ = _meta_pass("depth", normal_dtype=torch.float64)
    for name in ("depth", "gray_depth"):
        assert raster_sparse.pre_kind(attrs, uniforms, SHADERS[name][0]()) == SHADERS[name][1]


@pytest.mark.parametrize("band", [None, Band(0, 2), Band(1, 3, ty_stride=2),
                                  Band(0, 2, tx_lo=1, ntx_band=3)])
def test_route_by_band(meta_is_a_card, band):
    """A band (a rank's window of the sharded frame) takes the plain
    version; the whole grid the kernel."""
    attrs, uniforms, shader = _meta_pass()
    want = 0 if band is None else None
    assert raster_sparse.pre_kind(attrs, uniforms, shader, band=band) == want


@pytest.mark.parametrize("name", KERNEL_SHADERS)
def test_route_cpu_tensors_take_the_plain_version(name):
    attrs, uniforms, shader = _meta_pass(name, device="cpu")
    assert raster_sparse.pre_kind(attrs, uniforms, shader) is None


def test_shared_tiles_fit_the_default_shared_memory():
    """Up to kSharedTiles tiles, the place kernel's counters and a range's
    offsets fit 48 KB of shared memory; the card's largest grid is past
    that, so the global-memory counters are tested."""
    assert (K_SHARED_TILES + K_RANGE) * 4 <= 48 * 1024
    w, h, th = SIZES[-1]
    assert raster_sparse.cdiv(w, raster_sparse.TILE_W) * raster_sparse.cdiv(h, th) > K_SHARED_TILES


@pytest.mark.parametrize("name", KERNEL_SHADERS)
def test_kernel_route_of_no_triangles_is_the_plain_version(name):
    """A pass of no triangles: the kernel's route makes no launch (so it
    runs here, on CPU tensors) and returns the plain version's empty
    outputs, dtypes and shapes included."""
    attrs, mv, persp = stress_passes()["one"]
    a, u = convert.pass_to_torch(attrs, {"modelview": mv, "perspective": persp}, "cpu")
    a = {k: v[:0] for k, v in a.items()}
    shader, kind = SHADERS[name][0](), SHADERS[name][1]
    before = trace.counts()
    got = raster_sparse.pre_sparse_kernel(a, u, kind, 1200, 800, 16)
    assert trace.counts() == before
    want = raster_sparse.pre_sparse_plain(a, u, shader, 1200, 800, 16)
    assert (got.total, got.n_active) == (want.total, want.n_active) == (0, 0)
    for k in ("tri_rec", "sorted_tri", "ids", "start", "counts"):
        _same(getattr(got, k), getattr(want, k), k)
    assert set(got.setup) == set(want.setup)
    for k in want.setup:
        _same(got.setup[k], want.setup[k], f"setup[{k}]")


#: JAX-side cases: (scene, tile_h)
JAX_CASES = [("head_phong", 16), ("head_phong", 32), ("soup_phong_ragged", 16)]


@pytest.fixture(scope="module")
def cpu_jax(tmp_path_factory):
    got, req = {}, {}
    for name, th in JAX_CASES:
        p, w, h = scene_pass(name)
        attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, "cpu")
        before = trace.counts()
        ps = raster_sparse.pre_sparse(attrs, uniforms, p.shader, w, h, th)
        after = trace.counts()
        got[(name, th)] = (ps, after["pre.plain"] - before["pre.plain"],
                           after["pre.kernel"] - before["pre.kernel"])
        req[f"{name}_{th}"] = {"op": "pre_sparse", "scene": name, "th": th,
                               "total": ps.total, "active": ps.n_active}
    return got, run_jax(req, tmp_path_factory.mktemp("pre_jax"))


@pytest.mark.parametrize("case", JAX_CASES)
def test_cpu_pre_sparse_matches_jax_and_counts_plain(cpu_jax, case):
    got, want = cpu_jax
    ps, plain, kernel = got[case]
    w = want[f"{case[0]}_{case[1]}"]
    assert (plain, kernel) == (1, 0)
    assert ps.total > 0 and ps.n_active > 0
    assert_bits(np.array([ps.total, ps.n_active]), w["totals"], "totals")
    for what in ("ids", "start", "counts", "sorted_tri"):
        assert_bits(getattr(ps, what).numpy(), w[what], what)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bench_passes(device):
    """name -> (attrs, shader, uniforms) of the walk's and the sun walk's
    first views at the tiny plan: the walk's three passes, the light pass
    and the lit passes."""
    from pathlib import Path

    from rasterbench import catalog, scenes
    from rasterbench.tests.tiny_checkout import TINY
    from tinyrenderder_tpu_torch import shadows
    bench = catalog.Benchmark(Path(__file__).resolve().parent.parent)
    out = {}
    for config_name, traffic in (("reference_main_1200x800", "walk"),
                                 ("reference_main_shadows_1200x800", "sun_walk")):
        config = bench.config(config_name)
        tiny = config.get("tiny") or TINY[config_name]
        config["width"], config["height"] = tiny["size"]
        for i, (mesh, side) in tiny["passes"].items():
            config["passes"][int(i)]["mesh"].update(mesh)
            config["passes"][int(i)]["material"]["size"] = side
        plan = scenes.make_plan(config, bench.traffic(traffic), 2**31 + 17)
        sc = scenes.port_scene(plan)
        sc.camera.set_eye(plan.orbit.eye_at(plan.orbit.first))
        if traffic == "walk":
            for p, (a, sh, u, _) in zip(sc.passes, tscene.pass_tensors(sc, device, False)):
                out[f"walk_{p.name}"] = (a, sh, u)
            continue
        sun = np.array([0.5, 0.7, 0.5])
        settings = shadows.ShadowSettings(size=256)
        cam = shadows.light_camera_for_scene(sc, sun, settings)
        light = shadows.depth_scene(sc, cam, settings)
        ((a, sh, u, _),) = tscene.pass_tensors(light, device, False)
        out["sun_light"] = (a, sh, u)
        smap = torch.zeros((256, 256), dtype=torch.float32, device=device)
        lit = shadows.shadowed_scene(sc, sun, smap, cam, settings)
        for p, (a, sh, u, _) in zip(lit.passes, tscene.pass_tensors(lit, device, False)):
            out[f"sun_{p.name}"] = (a, sh, u)
    return out


@pytest.fixture(scope="module")
def card_cases(cuda_device):
    cases = _bench_passes(cuda_device)
    for name, (attrs, mv, persp) in stress_passes().items():
        a, u = convert.pass_to_torch(attrs, {"modelview": mv, "perspective": persp},
                                     cuda_device)
        for s in KERNEL_SHADERS:
            cases[f"{name}_{s}"] = (a, SHADERS[s][0](), u)
    return cases


def _same(got, want, what):
    assert got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape), what
    assert_bits(got.cpu().numpy(), want.cpu().numpy(), what)


def check_pre(attrs, shader, uniforms, w, h, th):
    """Kernel == plain on the card, every field; -> the kernel's PreSparse."""
    before = trace.counts()
    got = raster_sparse.pre_sparse(attrs, uniforms, shader, w, h, th)
    c = trace.counts()
    assert c["pre.kernel"] - before["pre.kernel"] == 1
    assert c["pre.plain"] == before["pre.plain"]
    for k in ("launch.pre_front", "launch.pre_offsets"):
        assert c[k] - before[k] == 1
    assert c["launch.pre_place"] - before["launch.pre_place"] == (1 if got.total else 0)
    assert c["readback"] - before["readback"] == 1
    want = raster_sparse.pre_sparse_plain(attrs, uniforms, shader, w, h, th)
    assert (got.total, got.n_active) == (want.total, want.n_active)
    for k in ("tri_rec", "sorted_tri", "ids", "start", "counts"):
        _same(getattr(got, k), getattr(want, k), k)
    assert set(got.setup) == set(want.setup)
    for k in want.setup:
        _same(got.setup[k], want.setup[k], f"setup[{k}]")
    return got


CARD_NAMES = (["walk_sponza", "walk_head", "walk_eyes", "sun_light", "sun_sponza", "sun_head",
               "sun_eyes"]
              + [f"{n}_{s}" for n in ("stress_lookat", "stress_identity", "all_invalid", "one",
                                      "big_pile") for s in KERNEL_SHADERS])


@pytest.mark.cuda
@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}_th{th}" for w, h, th in SIZES])
@pytest.mark.parametrize("name", CARD_NAMES)
def test_cuda_pre_matches_plain(card_cases, name, size):
    attrs, shader, uniforms = card_cases[name]
    got = check_pre(attrs, shader, uniforms, *size)
    if name.startswith("all_invalid"):
        assert got.total == got.n_active == 0
    else:
        assert got.total > 0


@pytest.mark.cuda
def test_cuda_pre_keeps_submission_order_on_z_ties(card_cases):
    """Coincident triangles: each tile lists them in ascending id."""
    attrs, shader, uniforms = card_cases["stress_lookat_phong"]
    got = check_pre(attrs, shader, uniforms, 1200, 800, 16)
    tri = got.sorted_tri.cpu().numpy()
    for s, n in zip(got.start.cpu().numpy(), got.counts.cpu().numpy()):
        assert (np.diff(tri[s:s + n]) > 0).all()


#: one pass's device operations on the card, in order (name substrings)
PASS_OPS = ("pre_front_kernel", "pre_offsets_kernel", "Memcpy DtoH", "pre_place_kernel")


@pytest.mark.cuda
def test_cuda_pre_device_operations(card_cases):
    """A pass makes four device operations (kernels, copies, fills; at
    most five are allowed): the front, offsets and place launches and the
    readback's copy, and nothing else.  Four passes are traced together
    and the last two read: the card's profiler has been seen to drop the
    first events of a trace."""
    from torch.profiler import ProfilerActivity, profile
    attrs, shader, uniforms = card_cases["stress_lookat_phong"]
    raster_sparse.pre_sparse(attrs, uniforms, shader, 1200, 800, 16)
    torch.cuda.synchronize()
    n = len(PASS_OPS)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                raster_sparse.pre_sparse(attrs, uniforms, shader, 1200, 800, 16)
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events()
                         if e.device_type == torch.autograd.DeviceType.CUDA),
                        key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        if len(names) >= 2 * n and names[-2 * n:-n] == names[-n:]:
            break
    assert names[-2 * n:-n] == names[-n:], names
    assert all(k in got for k, got in zip(PASS_OPS, names[-n:])), names[-n:]


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_SHADERS)
def test_cuda_pre_of_no_triangles(card_cases, name):
    """A pass of no triangles takes the kernel's route, makes no launch and
    no readback, and returns the plain version's empty outputs."""
    _, shader, uniforms = card_cases[f"one_{name}"]
    attrs = {k: v[:0] for k, v in card_cases[f"one_{name}"][0].items()}
    before = trace.counts()
    got = raster_sparse.pre_sparse(attrs, uniforms, shader, 1200, 800, 16)
    c = trace.counts()
    assert c["pre.kernel"] - before["pre.kernel"] == 1
    for k in ("pre.plain", "launch.pre_front", "launch.pre_offsets", "launch.pre_place",
              "readback"):
        assert c[k] == before[k], k
    want = raster_sparse.pre_sparse_plain(attrs, uniforms, shader, 1200, 800, 16)
    assert (got.total, got.n_active) == (want.total, want.n_active) == (0, 0)
    for k in ("tri_rec", "sorted_tri", "ids", "start", "counts"):
        _same(getattr(got, k), getattr(want, k), k)
    for k in want.setup:
        _same(got.setup[k], want.setup[k], f"setup[{k}]")


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["modelview", "perspective"])
def test_cuda_pre_strided_matrices(card_cases, which):
    """A matrix that is a transposed view reads as the same matrix."""
    attrs, shader, uniforms = card_cases["stress_lookat_phong"]
    strided = dict(uniforms)
    strided[which] = uniforms[which].t().contiguous().t()
    assert not strided[which].is_contiguous()
    got = check_pre(attrs, shader, strided, 1200, 800, 16)
    want = check_pre(attrs, shader, uniforms, 1200, 800, 16)
    _same(got.tri_rec, want.tri_rec, "tri_rec")


@pytest.mark.cuda
def test_cuda_kernel_library_constants(cuda_device):
    assert _build.constant("trt_pre_range") == K_RANGE
