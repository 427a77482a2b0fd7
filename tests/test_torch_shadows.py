"""Two-pass shadow mapping on the port (``tinyrenderder_tpu_torch.shadows``
and the shaders it needs) against the JAX package.

(a) the four shaders the port adds (Flat, Depth, GrayDepth,
    ShadowMapped): vertex and fragment, host and device halves, bitwise
    against the JAX classes' NumPy path (``xp=numpy``), in this process;
    the shadow factor on points off the map, behind the light (w <= 0)
    and on the map's last row and column;
(b) the host layer: ``light_camera_for_scene``, ``_merged_world_mesh``
    and ``shadowed_scene`` bitwise against the JAX originals, in this
    process;
(c) the port's oracle of tests/test_shadows.py's blocker scene (96x72,
    a 128² map) against the JAX package's
    ``render_with_shadows(backend="oracle")``: map, colour, depth, full
    depth and stats, bitwise, in this process;
(d) ``render_with_shadows`` on the CPU (the kernels' plain versions)
    against the port's oracle under ``FINE_MODE`` "coarse", "fine" and
    "fine2", and against the JAX package's
    ``render_with_shadows(backend="tiled")`` (coarse, Pallas in interpret
    mode, one subprocess for the module): bitwise, stats equal;
plus the default route of the light pass and (``cuda``) the shadowed frame
on the GPU against the oracle."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from helpers import default_view, make_pass, standard_meshes
from torch_parity import (SHADOW_KEY, assert_bits, blocker_scene, launches, run_jax,
                          stats_vector)
from tinyrenderder_tpu import shadows as j_shadows
from tinyrenderder_tpu_torch import convert, shaders, shadows
from tinyrenderder_tpu_torch.ops import raster_fine, raster_fine2, raster_sparse

W, H, S = 96, 72, 128
MODES = ("coarse", "fine", "fine2")
PLANES = ("color", "depth", "full_depth")
#: the fragment test's shadow map side and its model -> light-screen matrix:
#: sx = 4x / w, sy = 4y / w, sz = z / w with w = z / 2 + 1, so a point is
#: placed anywhere on or off the map, and behind the light, by its z
MAP = 32
EDGE_MATRIX = np.array([[4.0, 0, 0, 0], [0, 4.0, 0, 0], [0, 0, 1.0, 0], [0, 0, 0.5, 1.0]])


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lights(side):
    m = tp.side_modules(side)["math3d"]
    return [m.normalized(m.vec3(*v)) for v in
            (SHADOW_KEY, (-0.3, 0.5, 0.2), (-1.0, 0.8, -1.5))]


def _shadow_map(seed=7):
    rng = np.random.default_rng(seed)
    sm = rng.uniform(-1.0, 1.0, size=(MAP, MAP)).astype(np.float32)
    sm[rng.random(sm.shape) < 0.3] = np.inf
    return sm


def _shader(kind, side):
    sh = tp.side_modules(side)["shaders"]
    key, fill, rim = _lights(side)
    return {"flat": lambda: sh.FlatShader(light_world=key, base_color=(200.0, 180.0, 255.0)),
            "depth": lambda: sh.DepthShader(),
            "gray_depth": lambda: sh.GrayDepthShader(),
            "shadow": lambda: sh.ShadowMappedShader(
                key, fill, rim, shadow_matrix=EDGE_MATRIX, shadow_map=_shadow_map(),
                normal_map_strength=0.5)}[kind]()


@pytest.fixture(scope="module")
def meshes():
    return standard_meshes(), tp.standard_meshes("port")


# ---------------------------------------------------------------------------
# (a) the shaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh,kind", [("head", "flat"), ("cube", "flat"), ("soup", "depth"),
                                       ("sphere", "gray_depth"), ("head", "shadow")])
def test_vertex_matches_numpy(meshes, mesh, kind):
    view, proj = default_view()
    p = make_pass(meshes[0][mesh], _shader(kind, "jax"), view, proj)
    clip_ref, vary_ref = p.shader.vertex(p.uniforms, p.attrs, np)
    q = tp.make_pass(meshes[1][mesh], _shader(kind, "port"), view, proj)
    clip_np, vary_np = q.shader.vertex_np(q.uniforms, q.attrs)
    attrs, uniforms = convert.pass_to_torch(q.attrs, q.uniforms, "cpu")
    clip, vary = shaders.vertex(q.shader, uniforms, attrs)
    assert_bits(clip_np, clip_ref, "host clip")
    assert_bits(clip.numpy(), clip_ref, "clip")
    assert set(vary) == set(vary_np) == set(vary_ref) == set(q.shader.varying_spec)
    for k in vary_ref:
        assert_bits(np.asarray(vary_np[k]), np.asarray(vary_ref[k]), f"host {k}")
        assert_bits(vary[k].numpy(), np.asarray(vary_ref[k]), k)


def _edge_positions(rng, n):
    """Model-space points whose light-screen (sx, sy) under EDGE_MATRIX
    spread over and around the map, with the edges dense: the last row
    and column, exact 0 and MAP, -0.0, and w < 0, w == 0."""
    w = rng.uniform(0.4, 2.0, size=n)
    w[:64] = -rng.uniform(0.1, 1.0, size=64)             # behind the light
    w[64:96] = 0.0
    sx = rng.uniform(-4.0, MAP + 4.0, size=n)
    sy = rng.uniform(-4.0, MAP + 4.0, size=n)
    edges = np.array([MAP - 1.0, MAP - 0.5, MAP - 1e-3, MAP, MAP + 1e-3, 0.0, -0.0, -1e-3])
    sx[96:96 + 256] = rng.choice(edges, 256)
    sy[200:200 + 256] = rng.choice(edges, 256)
    sx[500:510] = [np.nan, np.inf, -np.inf, 3e9, -3e9, 1e20, 2.0, 5.0, 9.0, 17.0]
    x, y, z = sx * w / 4.0, sy * w / 4.0, 2.0 * (w - 1.0)
    x[64:96] = rng.uniform(-5, 5, size=32)
    return np.stack([x, y, z], axis=-1).astype(np.float32)


def _random_varyings(spec, n, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, c in spec.items():
        if name == "uv":
            v = rng.uniform(-0.2, 1.2, size=(n, c))
        elif name == "ndc_z":
            v = rng.uniform(-1.5, 1.5, size=(n, c))
        elif name == "position_model":
            v = _edge_positions(rng, n)
        else:
            v = rng.normal(size=(n, c))
        out[name] = v.astype(np.float32)
    for name in ("normal_eye", "face_normal_eye"):
        if name in out:
            out[name][4] = 0.0                           # zero-length normal
    return out


@pytest.mark.parametrize("mesh,kind", [("head", "flat"), ("sphere", "gray_depth"),
                                       ("soup", "depth"), ("head", "shadow"),
                                       ("sphere", "shadow")])
def test_fragment_matches_numpy(meshes, mesh, kind):
    view, proj = default_view()
    p = make_pass(meshes[0][mesh], _shader(kind, "jax"), view, proj)
    q = tp.make_pass(meshes[1][mesh], _shader(kind, "port"), view, proj)
    vary = _random_varyings(p.shader.varying_spec, 4096, seed=len(mesh) + len(kind))
    want = p.shader.fragment(p.uniforms, vary, np)
    _, ut = convert.pass_to_torch({}, q.uniforms, "cpu")
    rgb = shaders.fragment(q.shader, ut, {k: _t(v) for k, v in vary.items()})
    assert_bits(q.shader.fragment_np(q.uniforms, vary), want, "host rgb")
    assert_bits(rgb.numpy(), want, "rgb")
    assert_bits(shaders.finalize_color(rgb).numpy(),
                tp.side_modules("jax")["shaders"].finalize_color(want, np), "color")


def test_shadow_factor_matches_numpy(meshes):
    """The factor itself, and that the test reaches every branch: off the
    map, behind the light, lit and shadowed on the map, the last row and
    column."""
    view, proj = default_view()
    p = make_pass(meshes[0]["head"], _shader("shadow", "jax"), view, proj)
    q = tp.make_pass(meshes[1]["head"], _shader("shadow", "port"), view, proj)
    vary = _random_varyings(p.shader.varying_spec, 4096, seed=3)
    want = p.shader.shadow_factor(p.uniforms, vary, np)
    host = q.shader.shadow_factor_np(q.uniforms, vary)
    _, ut = convert.pass_to_torch({}, q.uniforms, "cpu")
    got = shaders._shadow_factor(q.shader, ut, {k: _t(v) for k, v in vary.items()})
    assert_bits(host, want, "host factor")
    assert_bits(got.numpy(), want, "factor")
    pm = vary["position_model"].astype(np.float64)
    w = pm[:, 2] / 2 + 1
    sx, sy = 4 * pm[:, 0] / np.where(w == 0, 1, w), 4 * pm[:, 1] / np.where(w == 0, 1, w)
    inside = (sx >= 0) & (sx < MAP) & (sy >= 0) & (sy < MAP) & (w > 0)
    shadowed = want < 1
    assert shadowed.any() and (inside & ~shadowed).any() and (~inside).any()
    assert not shadowed[~inside].any()
    assert (inside & (np.trunc(sx) == MAP - 1)).any() and (inside & (np.trunc(sy) == MAP - 1)).any()
    assert ((w <= 0) & (sx >= 0) & (sx < MAP) & (sy >= 0) & (sy < MAP)).any()


def test_build_uniforms_keeps_a_device_map():
    sm = torch.zeros((4, 4))
    key, fill, rim = _lights("port")
    sh = shaders.ShadowMappedShader(key, fill, rim, np.eye(4), sm)
    u = sh.build_uniforms(np.eye(4), np.eye(4), None, np.float32)
    assert u["shadow_map"] is sm
    assert u["shadow_matrix"].dtype == np.float32


# ---------------------------------------------------------------------------
# (b) the host layer
# ---------------------------------------------------------------------------

SCENES = {"blocker": lambda side: blocker_scene(side, W, H),
          "multimesh": lambda side: tp.multimesh_scene(side, 160, 96)}


@pytest.mark.parametrize("name", list(SCENES))
def test_host_layer_matches_jax(name):
    port, jax_scene = SCENES[name]("port"), SCENES[name]("jax")
    key_p, key_j = _lights("port")[0], _lights("jax")[0]
    settings_p, settings_j = shadows.ShadowSettings(size=S), j_shadows.ShadowSettings(size=S)
    cam_p = shadows.light_camera_for_scene(port, key_p, settings_p)
    cam_j = j_shadows.light_camera_for_scene(jax_scene, key_j, settings_j)
    assert shadows.light_camera_for_scene(port, key_p, settings_p) is cam_p   # cached
    for m in ("view_matrix", "projection_matrix"):
        assert_bits(getattr(cam_p, m), getattr(cam_j, m), m)
    mp, mj = shadows._merged_world_mesh(port), j_shadows._merged_world_mesh(jax_scene)
    for k in ("positions", "faces", "normals", "uvs"):
        assert_bits(getattr(mp, k), getattr(mj, k), k)
    sm = np.full((S, S), 0.5, np.float32)
    lit_p = shadows.shadowed_scene(port, key_p, sm, cam_p, settings_p)
    lit_j = j_shadows.shadowed_scene(jax_scene, key_j, sm, cam_j, settings_j)
    assert [type(p.shader).__name__ for p in lit_p.passes] == \
        [type(p.shader).__name__ for p in lit_j.passes]
    for pp, pj in zip(lit_p.passes, lit_j.passes):
        assert pp.exclude_from_output_depth == pj.exclude_from_output_depth
        mv = lit_j.camera.view_matrix @ pj.model_matrix
        mat = pj.mesh.materials[pj.material_index] if pj.mesh.materials else None
        want = pj.shader.build_uniforms(mv, lit_j.camera.projection_matrix, mat, np.float32)
        got = pp.shader.build_uniforms(mv, lit_p.camera.projection_matrix,
                                       pp.mesh.materials[pp.material_index], np.float32)
        assert set(got) == set(want)
        for k, v in want.items():
            if v is None:
                assert got[k] is None, k
            else:
                assert_bits(np.asarray(got[k]), np.asarray(v), k)
    sm2 = np.zeros((S, S), np.float32)
    again = shadows.shadowed_scene(port, key_p, sm2, cam_p, settings_p)
    assert again is lit_p                                   # the cache swaps the map
    assert all(p.shader.shadow_map is sm2 for p in again.passes
               if isinstance(p.shader, shaders.ShadowMappedShader))


# ---------------------------------------------------------------------------
# (c) the oracle, (d) the frame on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_oracle():
    return shadows.oracle_render_with_shadows(blocker_scene("port", W, H), _lights("port")[0],
                                              shadows.ShadowSettings(size=S))


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    return run_jax({"tiled": {"op": "shadows", "w": W, "h": H, "size": S, "mode": "coarse"}},
                   tmp_path_factory.mktemp("jax_shadows"))


def test_oracle_matches_jax_oracle(port_oracle):
    ref, smap = port_oracle
    res_j, smap_j = j_shadows.render_with_shadows(
        blocker_scene("jax", W, H), _lights("jax")[0], j_shadows.ShadowSettings(size=S),
        backend="oracle")
    assert_bits(smap, smap_j, "shadow map")
    for k in PLANES:
        assert_bits(getattr(ref, k), np.asarray(getattr(res_j, k)), k)
    assert_bits(stats_vector(ref.stats), stats_vector(res_j.stats), "stats")
    assert np.isfinite(smap).sum() > 1000
    plain = tp.side_modules("port")["scene"].oracle_render(blocker_scene("port", W, H))
    darker = (ref.color.astype(int) < plain.color.astype(int) - 20).all(axis=-1)
    assert darker.sum() > 30                                # the sphere casts a shadow
    assert not (ref.color.astype(int) > plain.color.astype(int) + 1).any()


@pytest.fixture(scope="module")
def port_frames():
    out = {}
    for mode in MODES:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(raster_sparse, "FINE_MODE", mode)
            out[mode] = shadows.render_with_shadows(blocker_scene("port", W, H),
                                                    _lights("port")[0],
                                                    shadows.ShadowSettings(size=S), "cpu")
    return out


@pytest.mark.parametrize("mode", MODES)
def test_frame_matches_oracle(port_frames, port_oracle, mode):
    result, smap = port_frames[mode]
    ref, ref_map = port_oracle
    assert smap.shape == (S, S) and smap.dtype == torch.float32
    assert_bits(smap.numpy(), ref_map, "shadow map")
    for k in PLANES:
        assert_bits(getattr(result, k).numpy(), getattr(ref, k), k)
    assert result.stats == ref.stats and result.stats.fragments_exact


def test_frame_matches_jax_tiled(port_frames, jax_side):
    result, smap = port_frames["coarse"]
    want = jax_side["tiled"]
    assert_bits(smap.numpy(), want["map"], "shadow map")
    for k in PLANES:
        assert_bits(getattr(result, k).numpy(), want[k], k)
    assert_bits(stats_vector(result.stats), want["stats"], "stats")


def test_frame_without_stats_and_culled(port_frames):
    """collect_stats=False gives the same frame; frustum_cull=False too
    (nothing of the blocker scene is culled)."""
    result, _ = port_frames["coarse"]
    r0, _ = shadows.render_with_shadows(blocker_scene("port", W, H), _lights("port")[0],
                                        shadows.ShadowSettings(size=S), "cpu",
                                        frustum_cull=False, collect_stats=False)
    for k in PLANES:
        assert torch.equal(getattr(r0, k), getattr(result, k)), k


def test_default_mode_renders_every_pass_coarse(monkeypatch):
    """Under the default ``FINE_MODE`` the shadow map's depth-only light
    pass, the lit passes and each pass of the three-pass frame take the
    coarse route: the strip pre-stages are never called."""
    assert raster_sparse.FINE_MODE == "coarse"

    def strip_route(*args, **kw):
        raise AssertionError("a pass took a strip route")

    monkeypatch.setattr(raster_fine, "pre_fine", strip_route)
    monkeypatch.setattr(raster_fine2, "pre_fine2", strip_route)
    real, shaded = raster_sparse.pre_sparse, []

    def coarse(attrs, uniforms, shader, *args, **kw):
        shaded.append(type(shader).__name__)
        return real(attrs, uniforms, shader, *args, **kw)

    monkeypatch.setattr(raster_sparse, "pre_sparse", coarse)
    shadows.render_with_shadows(blocker_scene("port", W, H), _lights("port")[0],
                                shadows.ShadowSettings(size=S), "cpu", collect_stats=False)
    assert shaded == ["DepthShader", "ShadowMappedShader", "ShadowMappedShader"]
    shaded.clear()
    sc = tp.frame_scene("multimesh")
    tp.side_modules("port")["scene"].render_scene(sc, "cpu", collect_stats=False)
    assert len(shaded) == len(sc.passes) == 3


# ---------------------------------------------------------------------------
# the GPU frame (skipped without a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_cuda_frame_matches_oracle(port_oracle, cuda_device, mode, monkeypatch):
    monkeypatch.setattr(raster_sparse, "FINE_MODE", mode)
    entry = {"coarse": "coarse_raster", "fine": "fine_raster", "fine2": "fine2_raster"}[mode]
    before = launches(entry), launches(f"{entry}_stats")
    result, smap = shadows.render_with_shadows(blocker_scene("port", W, H),
                                               _lights("port")[0],
                                               shadows.ShadowSettings(size=S), cuda_device)
    torch.cuda.synchronize()
    assert launches(entry) > before[0] and launches(f"{entry}_stats") > before[1]
    ref, ref_map = port_oracle
    assert smap.device.type == "cuda"
    assert_bits(smap.cpu().numpy(), ref_map, "shadow map")
    for k in PLANES:
        assert_bits(getattr(result, k).cpu().numpy(), getattr(ref, k), k)
    assert result.stats == ref.stats
