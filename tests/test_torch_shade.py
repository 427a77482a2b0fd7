"""The hand-written merge + shade (``csrc/shade.cu`` through
``raster_sparse.post_sparse``) against its plain version,
``raster_sparse.post_sparse_plain``.

On the CPU: the routing predicate (``shade_kind``) sends each shader
class, device type, dtype and a missing ``tex_packed`` where it should,
and raises on a pass on the card whose planes or uniforms the kernel
cannot read (meta tensors stand in for the card's); the shader constants
travel as float32 scalars rounded as PyTorch rounds a Python float
operand; the source's kinds, varyings and C signature agree with the
wrapper's; ``post_sparse`` on CPU tensors is the eager chain it always
was and counts ``shade.plain``; the kernel's route of no active tile
makes no launch.

Under the ``cuda`` marker, on the card, ``post_sparse`` through the
kernel against the eager chain on the same inputs, bitwise on all three
planes: every pass of the walk's and the sun walk's first views
(``rasterbench.scenes`` at the tiny plan; the excluded eye pass and the
depth-only light pass included); a running frame that already holds
colour and winners, with a large winner offset; a stress set (NaN and
+-inf varyings, uv outside [0, 1], zero-length normals and view
vectors, eye-pixel texels on both sides of both thresholds, light-space
w <= 0 and off-map shadow coordinates); one active tile with no won
pixel; and a pass makes exactly one device operation, a pass with no
active tile none.

The fresh-frame entry (``shade_compact_fresh``, the image route's
shading) likewise: on the CPU its routing (the same predicate on the
winner and varyings alone), the plain chain and its ``shade.plain``
count, no launch without tiles, the source's signature and anchor, and
the benchmark's ``image_shade_roofline_pct`` on a synthetic run; on the
card the kernel against ``shade_compact_fresh_plain`` bitwise on the
stress set and on every pass of the ``object_orbit_800`` orbit at its
tiny size (Phong, and the same frames with an Eye shader), and the
image route's frames equal to the plain route's with one launch a
frame."""

from __future__ import annotations

import ctypes
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import assert_bits
from tinyrenderder_tpu_torch import _build, convert, math3d, shaders, trace
from tinyrenderder_tpu_torch.ops import raster_sparse
from tinyrenderder_tpu_torch.ops.raster_sparse import FrameTiles

ROOT = Path(__file__).resolve().parent.parent
SHADE_CU = ROOT / "tinyrenderder_tpu_torch" / "csrc" / "shade.cu"
LIGHTS = (np.array([0.5, 0.7, 0.5]), np.array([-0.3, 0.5, 0.2]), np.array([-1.0, 0.8, -1.5]))

#: shader factory -> the fragment the kernel computes (None: plain)
SHADERS = {
    "phong": (lambda: shaders.PhongShader(*LIGHTS, normal_map_strength=0.5), 0),
    "eye": (lambda: shaders.EyeShader(LIGHTS[0], LIGHTS[2]), 1),
    "shadow_phong": (lambda: shaders.ShadowMappedShader(*LIGHTS, shadow_matrix=np.eye(4),
                                                        shadow_map=None,
                                                        normal_map_strength=0.7), 2),
    "gray_depth": (lambda: shaders.GrayDepthShader(), 3),
    "depth": (lambda: shaders.DepthShader(), 4),
    "flat": (lambda: shaders.FlatShader(), None),
    "gouraud": (lambda: shaders.GouraudShader(), None),
    "textured": (lambda: shaders.TexturedShader(), None),
}
KERNEL_SHADERS = [k for k, (_, kind) in SHADERS.items() if kind is not None]
TEXTURED = ("phong", "eye", "shadow_phong")
#: the stress set's tiles: (th, tw), active tiles, frame tiles, texture, shadow map
TILE = (16, 128)
N_ACTIVE, N_TILES = 5, 12
TEX_HW, MAP_HW = (37, 53), (64, 48)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def uniforms_of(name: str, shader, device, seed: int = 0) -> dict:
    """Every uniform a pass of ``shader`` reads, float32 tensors on
    ``device`` (the texture uint8): ``build_uniforms`` of a turned view
    and a seeded packed texture whose texels straddle the eye-pixel
    brightness threshold, a shadow matrix whose w is -z (so w <= 0 for
    half the positions) and a seeded shadow map."""
    rng = np.random.default_rng(seed)
    mv = math3d.lookat(np.array([0.7, 0.4, 2.5]), np.array([0.1, 0.0, 0.0]),
                       np.array([0.0, 1.0, 0.0]))
    persp = math3d.perspective(60.0, 1.5, 0.1, 100.0)
    h, w = TEX_HW
    tex = rng.integers(0, 256, (h, w, 7), dtype=np.uint8)
    # brightness sums 650 and 651 lie on either side of 0.85 * 765
    for i, total in enumerate((650, 651, 765, 0)):
        rows = slice(i * 4, i * 4 + 4)
        tex[rows, :, 0] = total // 3
        tex[rows, :, 1] = total // 3
        tex[rows, :, 2] = total - 2 * (total // 3)
    u = shader.build_uniforms(mv, persp, None, np.float32)
    u["tex_packed"] = tex if name in TEXTURED else None
    if name == "shadow_phong":
        mh, mw = MAP_HW
        u["shadow_matrix"] = np.array([[mw / 4, 0.0, 0.3, mw / 2], [0.0, mh / 4, -0.2, mh / 2],
                                       [0.1, 0.2, 0.5, 0.0], [0.0, 0.0, -1.0, 0.0]],
                                      dtype=np.float32)
        u["shadow_map"] = rng.uniform(-1.0, 1.0, (mh, mw)).astype(np.float32)
    return {k: (convert.to_torch(v, device) if isinstance(v, np.ndarray) else v)
            for k, v in u.items()}


def special_values(rng, shape) -> np.ndarray:
    """Seeded floats with NaN, +-inf, zeros, huge and tiny values sprinkled in."""
    x = rng.normal(0.0, 2.0, shape).astype(np.float32)
    pick = rng.random(shape)
    specials = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, 1e30, -1e30, 1e-40],
                        dtype=np.float32)
    idx = rng.integers(0, len(specials), shape)
    return np.where(pick < 0.05, specials[idx], x).astype(np.float32)


def stress_planes(name: str, device, seed: int = 1):
    """(frame, ids, depth_c, winner_c, vary_c) of a stress pass of shader
    ``name``: ``N_ACTIVE`` compact tiles of ``N_TILES``, a frame that
    already holds colour and winners, ~70% of the pixels won, and
    varyings channel by channel: uv in [-0.5, 1.5] with the texture's
    edges and specials, eye-space positions and normals with whole
    zero-length vectors and specials, model positions spread over the
    shadow map and past it, in front of the light and behind it."""
    rng = np.random.default_rng(seed)
    th, tw = TILE
    a = N_ACTIVE
    ids = np.sort(rng.choice(N_TILES, a, replace=False)).astype(np.int32)
    depth_c = special_values(rng, (a, th, tw))
    winner_c = np.where(rng.random((a, th, tw)) < 0.7,
                        rng.integers(0, 5000, (a, th, tw)), -1).astype(np.int32)
    spec = SHADERS[name][0]().varying_spec if SHADERS[name][0]().writes_color else {}
    chans = []
    for k, c in spec.items():
        if k == "uv":
            v = rng.uniform(-0.5, 1.5, (a, c, th, tw)).astype(np.float32)
            v[:, :, 0, :8] = np.array([0.0, 1.0, -0.0, 0.99999994, 1e-8, -1e-8, 2.0, 0.5],
                                      dtype=np.float32)[None, None, :]
            v = np.where(rng.random(v.shape) < 0.03, special_values(rng, v.shape), v)
        elif k == "position_model":
            v = np.stack([rng.uniform(-3.0, 3.0, (a, th, tw)), rng.uniform(-3.0, 3.0, (a, th, tw)),
                          rng.uniform(-2.0, 2.0, (a, th, tw))], 1).astype(np.float32)
            v[:, 2, 1, :4] = 0.0                     # w == 0 exactly
            v = np.where(rng.random(v.shape) < 0.02, special_values(rng, v.shape), v)
        else:
            v = special_values(rng, (a, c, th, tw))
            if c == 3:
                v[:, :, 2, :16] = 0.0                # zero-length vectors
                v[:, :, 3, :4] = -0.0
        chans.append(v)
    vary_c = (np.concatenate(chans, 1) if chans
              else np.zeros((a, 0, th, tw), dtype=np.float32))
    frame = FrameTiles(color=rng.integers(0, 1 << 24, (N_TILES, th, tw)).astype(np.int32),
                       depth=special_values(rng, (N_TILES, th, tw)),
                       winner=rng.integers(-1, 1 << 20, (N_TILES, th, tw)).astype(np.int32))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return (FrameTiles(*(t(p) for p in frame)), t(ids), t(depth_c), t(winner_c), t(vary_c))


def clone_frame(ft: FrameTiles) -> FrameTiles:
    return FrameTiles(*(p.clone() for p in ft))


def eager_post(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, winner_offset):
    """The merge + shade as the eager chain was written before the kernel:
    the reference ``post_sparse_plain`` is held to on the CPU."""
    idl = ids.long()
    won = winner_c >= 0
    ft.depth.index_copy_(0, idl, depth_c)
    ft.winner.index_copy_(0, idl, torch.where(won, winner_c + winner_offset, ft.winner[idl]))
    if not shader.writes_color:
        return
    vary, i = {}, 0
    for k, c in shader.varying_spec.items():
        vary[k] = vary_c[:, i:i + c].movedim(1, -1)
        i += c
    out = raster_sparse.pack_rgb(shaders.finalize_color(shaders.fragment(shader, uniforms,
                                                                          vary)))
    ft.color.index_copy_(0, idl, torch.where(won, out, ft.color[idl]))


def same_frame(got: FrameTiles, want: FrameTiles, what: str) -> None:
    for k in FrameTiles._fields:
        g, w = getattr(got, k), getattr(want, k)
        assert g.dtype == w.dtype and g.shape == w.shape, f"{what} {k}"
        assert_bits(g.cpu().numpy(), w.cpu().numpy(), f"{what} {k}")


# ---------------------------------------------------------------------------
# CPU: routing
# ---------------------------------------------------------------------------

def _meta_pass(name="phong", device="meta", vary_dtype=torch.float32, **uniform_dtypes):
    """(uniforms, shader, planes) of a pass of shader ``name`` as meta tensors."""
    shader = SHADERS[name][0]()
    th, tw = TILE
    n_vary = sum(shader.varying_spec.values()) if shader.writes_color else 0
    planes = (torch.empty((N_TILES, th, tw), dtype=torch.int32, device=device),
              torch.empty((N_TILES, th, tw), dtype=torch.float32, device=device),
              torch.empty((N_TILES, th, tw), dtype=torch.int32, device=device),
              torch.empty((N_ACTIVE, th, tw), dtype=torch.float32, device=device),
              torch.empty((N_ACTIVE, th, tw), dtype=torch.int32, device=device),
              torch.empty((N_ACTIVE, n_vary, th, tw), dtype=vary_dtype, device=device))
    uniforms = {"modelview": (4, 4), "perspective": (4, 4), "key_light_eye": (3,),
                "fill_light_eye": (3,), "rim_light_eye": (3,), "shadow_matrix": (4, 4),
                "shadow_map": MAP_HW}
    uniforms = {k: torch.empty(s, dtype=uniform_dtypes.get(k, torch.float32), device=device)
                for k, s in uniforms.items()}
    uniforms["tex_packed"] = torch.empty((*TEX_HW, 7), device=device,
                                         dtype=uniform_dtypes.get("tex_packed", torch.uint8))
    return uniforms, shader, planes


@pytest.fixture
def meta_is_a_card(monkeypatch):
    """The predicate's device check reads meta tensors as the card's."""
    monkeypatch.setattr(raster_sparse, "_SHADE_DEVICE", "meta")


@pytest.mark.parametrize("name", list(SHADERS))
def test_route_by_shader_class(meta_is_a_card, name):
    assert raster_sparse.shade_kind(*_meta_pass(name)) == SHADERS[name][1]


@pytest.mark.parametrize("name", KERNEL_SHADERS)
def test_route_cpu_planes_take_the_plain_version(name):
    assert raster_sparse.shade_kind(*_meta_pass(name, device="cpu")) is None


@pytest.mark.parametrize("name", TEXTURED)
def test_route_without_a_packed_texture_takes_the_plain_version(meta_is_a_card, name):
    uniforms, shader, planes = _meta_pass(name)
    uniforms["tex_packed"] = None
    assert raster_sparse.shade_kind(uniforms, shader, planes) is None


@pytest.mark.parametrize("name", ["gray_depth", "depth"])
def test_route_depth_kinds_read_no_uniform(meta_is_a_card, name):
    """GrayDepth and depth-only passes read no texture and no uniform."""
    _, shader, planes = _meta_pass(name)
    assert raster_sparse.shade_kind({"tex_packed": None}, shader, planes) == SHADERS[name][1]


@pytest.mark.parametrize("case", ["vary_f64", "modelview_f64", "key_f16", "map_f64",
                                  "texture_i16", "frame_colour_i64"])
def test_route_other_dtypes_take_the_plain_version(meta_is_a_card, case):
    name = "shadow_phong"
    if case == "vary_f64":
        uniforms, shader, planes = _meta_pass(name, vary_dtype=torch.float64)
    elif case == "frame_colour_i64":
        uniforms, shader, planes = _meta_pass(name)
        planes = (planes[0].long(), *planes[1:])
    else:
        key, dtype = {"modelview_f64": ("modelview", torch.float64),
                      "key_f16": ("key_light_eye", torch.float16),
                      "map_f64": ("shadow_map", torch.float64),
                      "texture_i16": ("tex_packed", torch.int16)}[case]
        uniforms, shader, planes = _meta_pass(name, **{key: dtype})
    assert raster_sparse.shade_kind(uniforms, shader, planes) is None


@pytest.mark.parametrize("case", ["texture_elsewhere", "map_elsewhere", "matrix_3x4",
                                  "shadow_matrix_4x3", "light_4", "texture_rgb",
                                  "map_numpy", "light_missing", "spec_changed",
                                  "writes_color_changed", "vary_channels", "plane_elsewhere",
                                  "plane_strided", "tile_shape"])
def test_route_raises_on_inputs_the_kernel_cannot_read(meta_is_a_card, case):
    """A pass on the card that the kernel takes by its class and dtypes, but
    whose planes or uniforms it cannot read, raises: it does not give way
    to the plain version."""
    uniforms, shader, planes = _meta_pass("shadow_phong")
    planes = list(planes)
    if case == "texture_elsewhere":
        uniforms["tex_packed"] = torch.empty((*TEX_HW, 7), dtype=torch.uint8)
    elif case == "map_elsewhere":
        uniforms["shadow_map"] = torch.empty(MAP_HW)
    elif case == "matrix_3x4":
        uniforms["modelview"] = torch.empty((3, 4), device="meta")
    elif case == "shadow_matrix_4x3":
        uniforms["shadow_matrix"] = torch.empty((4, 3), device="meta")
    elif case == "light_4":
        uniforms["rim_light_eye"] = torch.empty((4,), device="meta")
    elif case == "texture_rgb":
        uniforms["tex_packed"] = torch.empty((*TEX_HW, 3), dtype=torch.uint8, device="meta")
    elif case == "map_numpy":
        uniforms["shadow_map"] = np.zeros(MAP_HW, dtype=np.float32)
    elif case == "light_missing":
        del uniforms["fill_light_eye"]
    elif case == "spec_changed":
        shader.varying_spec = {"uv": 2, "normal_eye": 3, "position_eye": 3,
                               "position_model": 3}
    elif case == "writes_color_changed":
        shader.writes_color = False
    elif case == "vary_channels":
        planes[5] = torch.empty((N_ACTIVE, 8, *TILE), device="meta")
    elif case == "plane_elsewhere":
        planes[3] = torch.empty((N_ACTIVE, *TILE))
    elif case == "plane_strided":
        planes[4] = torch.empty((N_ACTIVE, TILE[1], TILE[0]), dtype=torch.int32,
                                device="meta").transpose(1, 2)
    elif case == "tile_shape":
        planes[3] = torch.empty((N_ACTIVE, 32, 128), device="meta")
    with pytest.raises(ValueError, match="post_sparse"):
        raster_sparse.shade_kind(uniforms, shader, tuple(planes))


@pytest.mark.parametrize("name", KERNEL_SHADERS)
def test_shade_scalars_round_as_torch_rounds_a_python_operand(name):
    """Each constant the kernel takes, rounded to float32 by ctypes, is
    the float32 a tensor op with that Python float as operand uses."""
    shader = SHADERS[name][0]()
    for x in raster_sparse._shade_scalars(shader):
        as_torch = (torch.ones(1, dtype=torch.float32) * x).item()
        assert np.float32(ctypes.c_float(x).value) == np.float32(as_torch)
    c = raster_sparse._shade_scalars(shader)
    if name in TEXTURED:
        assert c[0] == shader.AMBIENT and c[5] == shader.SPECULAR_SCALE
    if name in ("phong", "shadow_phong"):
        s = shader.normal_map_strength
        assert c[6:8] == (1.0 - s, s)
    assert c[10:] == (shaders.EYE_DIFFUSE_BRIGHTNESS_THRESHOLD,
                      shaders.EYE_SPECULAR_POWER_THRESHOLD)


def test_source_agrees_with_the_wrapper():
    """The source's Kind enum, its varyings a kind and the C entry's
    parameter count are the wrapper's."""
    src = SHADE_CU.read_text()
    enum = dict((k, int(v)) for k, v in re.findall(r"k(\w+) = (\d)", src.split("enum Kind")[1]
                                                   .split("};")[0]))
    assert enum == {"Phong": 0, "Eye": 1, "Shadow": 2, "GrayDepth": 3, "DepthOnly": 4}
    assert sorted(raster_sparse._SHADE_KINDS.values()) == sorted(enum.values())
    for kind, spec in raster_sparse._SHADE_SPECS.items():
        n = sum(c for _, c in spec or ())
        assert n == {0: 8, 1: 8, 2: 11, 3: 1, 4: 0}[kind]
    params = src.split('extern "C" int trt_merge_shade(')[1].split(")")[0].split(",")
    assert len(params) == len(_build.SIGNATURES["trt_merge_shade"])
    assert "shade.cu" in _build.SOURCES
    assert trace.LAUNCH_KERNELS["launch.merge_shade"] == "merge_shade_kernel"


def test_kernel_name_is_not_a_raster_kernel():
    """The raster's device time and roofline match kernel names by
    substring: the merge + shade kernel is none of them."""
    from rasterbench.metrics import raster_roofline_pct
    assert not any(k in "merge_shade_kernel" for k in raster_roofline_pct.KERNELS)


@pytest.mark.parametrize("name", KERNEL_SHADERS)
def test_kernel_route_of_no_active_tile_makes_no_launch(name):
    """A pass with no active tile: the kernel's route returns before its
    launch (so it runs here, on CPU tensors) and leaves the frame as it
    was."""
    ft, ids, depth_c, winner_c, vary_c = stress_planes(name, "cpu")
    shader = SHADERS[name][0]()
    uniforms = uniforms_of(name, shader, "cpu")
    want = clone_frame(ft)
    before = trace.counts()
    raster_sparse.post_sparse_kernel(ft, ids[:0], depth_c[:0], winner_c[:0], vary_c[:0],
                                     uniforms, shader, 7, SHADERS[name][1])
    assert trace.counts() == before
    same_frame(ft, want, "no active tile")


@pytest.mark.parametrize("name", list(SHADERS))
def test_cpu_post_sparse_is_the_eager_chain_and_counts_plain(name):
    """On CPU tensors ``post_sparse`` is the eager chain as it always was,
    on the stress set, and counts one ``shade.plain``."""
    ft, ids, depth_c, winner_c, vary_c = stress_planes(name, "cpu", seed=3)
    shader = SHADERS[name][0]()
    uniforms = uniforms_of(name, shader, "cpu", seed=3)
    want = clone_frame(ft)
    before = trace.counts()
    raster_sparse.post_sparse(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, 1 << 30)
    c = trace.counts()
    assert (c["shade.plain"] - before["shade.plain"], c["shade.kernel"]
            - before["shade.kernel"]) == (1, 0)
    eager_post(want, ids, depth_c, winner_c, vary_c, uniforms, shader, 1 << 30)
    same_frame(ft, want, name)


def _bench_frames(device, size: int):
    """(walk scene, (sun walk scene, sun, settings)) at the first view of
    the tiny plan: the walk's three passes, and the sun walk's light pass
    (``size``² map) and lit passes."""
    from rasterbench import catalog, scenes
    from rasterbench.tests.tiny_checkout import TINY
    from tinyrenderder_tpu_torch import shadows
    bench = catalog.Benchmark(ROOT)
    out = []
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
            out.append(sc)
            continue
        sun = np.array([0.5, 0.7, 0.5])
        for p in sc.passes:
            if isinstance(p.shader, (shaders.PhongShader, shaders.EyeShader)):
                p.shader.key_light_world = sun
        out.append((sc, sun, shadows.ShadowSettings(size=size)))
    return out


def test_cpu_frames_are_the_eager_chain_pass_by_pass(monkeypatch):
    """Every ``post_sparse`` of the walk's and the sun walk's tiny frames
    on the CPU (Phong, Eye, ``ShadowMappedShader`` and the depth-only
    light pass) equals the eager chain on the same frame and inputs."""
    seen = []
    real = raster_sparse.post_sparse

    def checked(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, winner_offset):
        want = clone_frame(ft)
        eager_post(want, ids, depth_c, winner_c, vary_c, uniforms, shader, winner_offset)
        real(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, winner_offset)
        same_frame(ft, want, type(shader).__name__)
        seen.append(type(shader).__name__)

    monkeypatch.setattr(raster_sparse, "post_sparse", checked)
    walk, (sun_sc, sun, settings) = _bench_frames("cpu", 64)
    walk.render("cpu", frustum_cull=True, backend="tiled")
    sun_sc.render("cpu", frustum_cull=True, backend="tiled", shadows=(sun, settings))
    assert seen == ["PhongShader", "PhongShader", "EyeShader", "DepthShader",
                    "ShadowMappedShader", "ShadowMappedShader", "EyeShader"]


# ---------------------------------------------------------------------------
# CPU: the fresh-frame entry
# ---------------------------------------------------------------------------

COLOUR_KERNEL_SHADERS = [k for k in KERNEL_SHADERS if k != "depth"]
COLOUR_SHADERS = [k for k in SHADERS if k != "depth"]


def _meta_fresh(name="phong", device="meta", **kw):
    """(uniforms, shader, (winner_c, vary_c)) of a fresh pass as meta tensors."""
    uniforms, shader, planes = _meta_pass(name, device, **kw)
    return uniforms, shader, planes[4:]


def eager_fresh(winner_c, vary_c, uniforms, shader):
    """The fresh shading as the eager chain was written before the kernel."""
    vary, i = {}, 0
    for k, c in shader.varying_spec.items():
        vary[k] = vary_c[:, i:i + c].movedim(1, -1)
        i += c
    out = raster_sparse.pack_rgb(shaders.finalize_color(shaders.fragment(shader, uniforms,
                                                                          vary)))
    return torch.where(winner_c >= 0, out, torch.zeros_like(out))


@pytest.mark.parametrize("name", list(SHADERS))
def test_fresh_route_by_shader_class(meta_is_a_card, name):
    """The winner and varyings alone route as the six planes do."""
    assert raster_sparse.shade_kind(*_meta_fresh(name)) == SHADERS[name][1]


@pytest.mark.parametrize("name", COLOUR_KERNEL_SHADERS)
def test_fresh_route_cpu_planes_take_the_plain_version(name):
    assert raster_sparse.shade_kind(*_meta_fresh(name, device="cpu")) is None


@pytest.mark.parametrize("name", TEXTURED)
def test_fresh_route_without_a_packed_texture_takes_the_plain_version(meta_is_a_card, name):
    uniforms, shader, planes = _meta_fresh(name)
    uniforms["tex_packed"] = None
    assert raster_sparse.shade_kind(uniforms, shader, planes) is None


@pytest.mark.parametrize("case", ["vary_f64", "modelview_f64", "key_f16", "map_f64",
                                  "texture_i16", "winner_i64"])
def test_fresh_route_other_dtypes_take_the_plain_version(meta_is_a_card, case):
    name = "shadow_phong"
    if case == "vary_f64":
        uniforms, shader, planes = _meta_fresh(name, vary_dtype=torch.float64)
    elif case == "winner_i64":
        uniforms, shader, planes = _meta_fresh(name)
        planes = (planes[0].long(), planes[1])
    else:
        key, dtype = {"modelview_f64": ("modelview", torch.float64),
                      "key_f16": ("key_light_eye", torch.float16),
                      "map_f64": ("shadow_map", torch.float64),
                      "texture_i16": ("tex_packed", torch.int16)}[case]
        uniforms, shader, planes = _meta_fresh(name, **{key: dtype})
    assert raster_sparse.shade_kind(uniforms, shader, planes) is None


@pytest.mark.parametrize("case", ["texture_elsewhere", "matrix_3x4", "map_numpy",
                                  "light_missing", "spec_changed", "vary_channels",
                                  "vary_elsewhere", "winner_strided", "tile_shape",
                                  "winner_2d"])
def test_fresh_route_raises_on_inputs_the_kernel_cannot_read(meta_is_a_card, case):
    """A fresh pass on the card that the kernel takes by its class and
    dtypes, but whose planes or uniforms it cannot read, raises under
    the fresh entry's name."""
    uniforms, shader, (winner_c, vary_c) = _meta_fresh("shadow_phong")
    if case == "texture_elsewhere":
        uniforms["tex_packed"] = torch.empty((*TEX_HW, 7), dtype=torch.uint8)
    elif case == "matrix_3x4":
        uniforms["modelview"] = torch.empty((3, 4), device="meta")
    elif case == "map_numpy":
        uniforms["shadow_map"] = np.zeros(MAP_HW, dtype=np.float32)
    elif case == "light_missing":
        del uniforms["fill_light_eye"]
    elif case == "spec_changed":
        shader.varying_spec = {"uv": 2, "normal_eye": 3, "position_eye": 3,
                               "position_model": 3}
    elif case == "vary_channels":
        vary_c = torch.empty((N_ACTIVE, 8, *TILE), device="meta")
    elif case == "vary_elsewhere":
        vary_c = torch.empty((N_ACTIVE, 11, *TILE))
    elif case == "winner_strided":
        winner_c = torch.empty((N_ACTIVE, TILE[1], TILE[0]), dtype=torch.int32,
                               device="meta").transpose(1, 2)
    elif case == "tile_shape":
        vary_c = torch.empty((N_ACTIVE, 11, 32, 128), device="meta")
    elif case == "winner_2d":
        winner_c = torch.empty((N_ACTIVE, TILE[0] * TILE[1]), dtype=torch.int32,
                               device="meta")
    with pytest.raises(ValueError, match="shade_compact_fresh"):
        raster_sparse.shade_kind(uniforms, shader, (winner_c, vary_c))


@pytest.mark.parametrize("name", COLOUR_SHADERS)
def test_cpu_shade_compact_fresh_is_the_eager_chain_and_counts_plain(name):
    """On CPU tensors ``shade_compact_fresh`` is the eager chain as it
    always was, on the stress set, and counts one ``shade.plain`` and no
    launch."""
    _, _, _, winner_c, vary_c = stress_planes(name, "cpu", seed=4)
    shader = SHADERS[name][0]()
    uniforms = uniforms_of(name, shader, "cpu", seed=4)
    before = trace.counts()
    got = raster_sparse.shade_compact_fresh(winner_c, vary_c, uniforms, shader)
    c = trace.counts()
    assert (c["shade.plain"] - before["shade.plain"], c["shade.kernel"] - before["shade.kernel"],
            c["launch.shade_fresh"] - before["launch.shade_fresh"]) == (1, 0, 0)
    want = eager_fresh(winner_c, vary_c, uniforms, shader)
    assert_bits(got.numpy(), want.numpy(), name)
    assert_bits(raster_sparse.shade_compact_fresh_plain(winner_c, vary_c, uniforms,
                                                        shader).numpy(), want.numpy(), name)


@pytest.mark.parametrize("name", COLOUR_KERNEL_SHADERS)
def test_fresh_kernel_route_of_no_tile_makes_no_launch(name):
    """No tiles: the fresh entry returns its empty output before its
    launch (so it runs here, on CPU tensors)."""
    _, _, _, winner_c, vary_c = stress_planes(name, "cpu")
    shader = SHADERS[name][0]()
    uniforms = uniforms_of(name, shader, "cpu")
    before = trace.counts()
    out = raster_sparse.shade_compact_fresh_kernel(winner_c[:0], vary_c[:0], uniforms, shader,
                                                   SHADERS[name][1])
    assert trace.counts() == before
    assert out.dtype == torch.int32 and tuple(out.shape) == (0, *TILE)


def test_fresh_source_agrees_with_the_wrapper():
    """The fresh entry's parameter count is its signature's, its uniform
    block is the merge entry's parameter for parameter, it takes the
    colour kinds alone, and its launch counter is anchored on its own
    kernel."""
    src = SHADE_CU.read_text()

    def params(entry):
        body = src.split(f'extern "C" int {entry}(')[1].split(") {")[0]
        return [" ".join(p.split()) for p in body.split(",")]
    fresh, merge = params("trt_shade_fresh"), params("trt_merge_shade")
    assert len(fresh) == len(_build.SIGNATURES["trt_shade_fresh"])
    n_block = 12 + 11 + 1                   # uniforms and sizes, constants, stream
    assert fresh[-n_block:] == merge[-n_block:]
    assert _build.SIGNATURES["trt_shade_fresh"][-n_block:] == \
        _build.SIGNATURES["trt_merge_shade"][-n_block:]
    assert "kind > kGrayDepth" in src.split('extern "C" int trt_shade_fresh(')[1]
    assert trace.LAUNCH_KERNELS["launch.shade_fresh"] == "shade_fresh_kernel"
    assert src.count("shade_fresh_kernel<K><<<") == 1


def test_fresh_kernel_name_is_not_a_raster_kernel():
    """The raster's and the merge's device time match kernel names by
    substring: the fresh kernel is none of them, nor they it."""
    from rasterbench.metrics import image_shade_roofline_pct, raster_roofline_pct
    assert not any(k in "shade_fresh_kernel" for k in raster_roofline_pct.KERNELS)
    assert image_shade_roofline_pct.KERNEL not in "merge_shade_kernel"


def test_image_shade_roofline_reader():
    """``image_shade_roofline_pct``: the reference's won pixels' bound
    over the fresh kernel's device time; None without that kernel."""
    from types import SimpleNamespace

    from rasterbench.metrics import image_shade_roofline_pct as m
    from rasterbench.metrics import raster_roofline_pct as raster
    work = [[{"pass": "object", "won": 200_000, "varyings": 8, "valid": 1, "tests": 1,
              "winning_triangles": 1, "pixels": 640_000}]] * 2
    device = [("void (anonymous namespace)::shade_fresh_kernel<0>(ShadeArgs)", 0.0, 12.0),
              ("void (anonymous namespace)::merge_shade_kernel<0>(ShadeArgs)", 20.0, 50.0),
              ("void (anonymous namespace)::shade_fresh_kernel<0>(ShadeArgs)", 100.0, 108.0)]
    data = SimpleNamespace(window=SimpleNamespace(trace=SimpleNamespace(device=device)),
                           work=work)
    bound = max(200_000 * 40 / raster.PEAK_BYTES_S, 200_000 * m.OPS_PHONG / raster.PEAK_FLOPS)
    assert m.read(data) == pytest.approx(100.0 * 2 * bound / 20e-6)
    assert 0 < m.read(data) < 100
    data.window.trace.device = device[1:2]
    assert m.read(data) is None
    assert m.read(SimpleNamespace(window=SimpleNamespace(trace=None), work=work)) is None


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def check_shade(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, winner_offset,
                what: str, post=None) -> None:
    """Kernel == eager chain on the card, on clones of ``ft``: all three
    planes bitwise, one ``shade.kernel``, one launch (none without active
    tiles), no ``shade.plain``.  ``post``: the routed entry
    (``raster_sparse.post_sparse``)."""
    want = clone_frame(ft)
    got = clone_frame(ft)
    before = trace.counts()
    (post or raster_sparse.post_sparse)(got, ids, depth_c, winner_c, vary_c, uniforms, shader,
                                        winner_offset)
    c = trace.counts()
    assert c["shade.kernel"] - before["shade.kernel"] == 1, what
    assert c["shade.plain"] == before["shade.plain"], what
    assert c["launch.merge_shade"] - before["launch.merge_shade"] == int(ids.numel() > 0)
    raster_sparse.post_sparse_plain(want, ids, depth_c, winner_c, vary_c, uniforms, shader,
                                    winner_offset)
    same_frame(got, want, what)


@pytest.mark.cuda
def test_cuda_bench_frames_every_pass(cuda_device, monkeypatch):
    """Every pass of the walk's and the sun walk's first views through the
    kernel == the eager chain on the same running frame; the frames'
    passes are the kernel's kinds."""
    seen = []
    real = raster_sparse.post_sparse

    def checked(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, winner_offset):
        check_shade(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, winner_offset,
                    type(shader).__name__, post=real)
        real(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, winner_offset)
        seen.append(type(shader).__name__)

    monkeypatch.setattr(raster_sparse, "post_sparse", checked)
    walk, (sun_sc, sun, settings) = _bench_frames(cuda_device, 256)
    walk.render(cuda_device, frustum_cull=True, backend="tiled")
    sun_sc.render(cuda_device, frustum_cull=True, backend="tiled", shadows=(sun, settings))
    assert seen == ["PhongShader", "PhongShader", "EyeShader", "DepthShader",
                    "ShadowMappedShader", "ShadowMappedShader", "EyeShader"]


@pytest.mark.cuda
@pytest.mark.parametrize("thresholds", ["as_set", "spec_below", "bright_zero"])
@pytest.mark.parametrize("name", KERNEL_SHADERS)
@pytest.mark.parametrize("seed", [1, 2])
def test_cuda_stress(cuda_device, monkeypatch, name, thresholds, seed):
    """The stress set, with the eye-pixel thresholds as set and moved so
    that no texel (specular power 1 above 0.5) or every texel (brightness
    0 and above) is an eye pixel; a large winner offset."""
    if thresholds == "spec_below":
        monkeypatch.setattr(shaders, "EYE_SPECULAR_POWER_THRESHOLD", 0.5)
    elif thresholds == "bright_zero":
        monkeypatch.setattr(shaders, "EYE_DIFFUSE_BRIGHTNESS_THRESHOLD", 0.0)
    shader = SHADERS[name][0]()
    uniforms = uniforms_of(name, shader, cuda_device, seed)
    planes = stress_planes(name, cuda_device, seed)
    check_shade(*planes, uniforms, shader, (1 << 30) + seed, f"{name} {thresholds} {seed}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_SHADERS)
def test_cuda_one_tile_no_won_pixel(cuda_device, name):
    """One active tile that the pass did not win anywhere: its depth alone
    changes."""
    shader = SHADERS[name][0]()
    uniforms = uniforms_of(name, shader, cuda_device)
    ft, ids, depth_c, winner_c, vary_c = stress_planes(name, cuda_device)
    ids, depth_c, vary_c = ids[2:3], depth_c[2:3], vary_c[2:3].contiguous()
    winner_c = torch.full_like(winner_c[2:3], -1)
    check_shade(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, 3, name)
    got = clone_frame(ft)
    raster_sparse.post_sparse(got, ids, depth_c, winner_c, vary_c, uniforms, shader, 3)
    want = clone_frame(ft)
    want.depth[int(ids[0])] = depth_c[0]
    same_frame(got, want, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", KERNEL_SHADERS)
def test_cuda_pass_with_no_active_tile(cuda_device, name):
    shader = SHADERS[name][0]()
    uniforms = uniforms_of(name, shader, cuda_device)
    ft, ids, depth_c, winner_c, vary_c = stress_planes(name, cuda_device)
    check_shade(ft, ids[:0], depth_c[:0], winner_c[:0], vary_c[:0], uniforms, shader, 0, name)


@pytest.mark.cuda
@pytest.mark.parametrize("active", [N_ACTIVE, 0])
def test_cuda_device_operations(cuda_device, active):
    """A pass makes exactly one device operation, ``merge_shade_kernel``,
    and a pass with no active tile none.  Four passes are traced together
    and the last two read: the card's profiler has been seen to drop the
    first events of a trace."""
    from torch.profiler import ProfilerActivity, profile
    name = "shadow_phong"
    shader = SHADERS[name][0]()
    uniforms = uniforms_of(name, shader, cuda_device)
    ft, ids, depth_c, winner_c, vary_c = stress_planes(name, cuda_device)
    args = (ft, ids[:active], depth_c[:active], winner_c[:active], vary_c[:active], uniforms,
            shader, 5)
    raster_sparse.post_sparse(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                raster_sparse.post_sparse(*args)
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        if not active or len(names) >= 2:
            break
    if active:
        assert len(names) in (2, 3, 4) and all("merge_shade_kernel" in n for n in names), names
    else:
        assert names == [], names


def check_fresh(winner_c, vary_c, uniforms, shader, what: str, fresh=None) -> None:
    """Fresh kernel == ``shade_compact_fresh_plain`` on the card, bitwise,
    one ``shade.kernel``, one launch (none without tiles), no
    ``shade.plain``.  ``fresh``: the routed entry
    (``raster_sparse.shade_compact_fresh``)."""
    before = trace.counts()
    got = (fresh or raster_sparse.shade_compact_fresh)(winner_c, vary_c, uniforms, shader)
    c = trace.counts()
    assert c["shade.kernel"] - before["shade.kernel"] == 1, what
    assert c["shade.plain"] == before["shade.plain"], what
    assert c["launch.shade_fresh"] - before["launch.shade_fresh"] == int(winner_c.shape[0] > 0)
    want = raster_sparse.shade_compact_fresh_plain(winner_c, vary_c, uniforms, shader)
    assert_bits(got.cpu().numpy(), want.cpu().numpy(), what)


@pytest.mark.cuda
@pytest.mark.parametrize("thresholds", ["as_set", "spec_below", "bright_zero"])
@pytest.mark.parametrize("name", COLOUR_KERNEL_SHADERS)
@pytest.mark.parametrize("seed", [1, 2])
def test_cuda_fresh_stress(cuda_device, monkeypatch, name, thresholds, seed):
    """The stress set through the fresh entry, thresholds as in
    ``test_cuda_stress``; every tile, then one tile and no tile."""
    if thresholds == "spec_below":
        monkeypatch.setattr(shaders, "EYE_SPECULAR_POWER_THRESHOLD", 0.5)
    elif thresholds == "bright_zero":
        monkeypatch.setattr(shaders, "EYE_DIFFUSE_BRIGHTNESS_THRESHOLD", 0.0)
    shader = SHADERS[name][0]()
    uniforms = uniforms_of(name, shader, cuda_device, seed)
    _, _, _, winner_c, vary_c = stress_planes(name, cuda_device, seed)
    what = f"{name} {thresholds} {seed}"
    check_fresh(winner_c, vary_c, uniforms, shader, what)
    check_fresh(winner_c[2:3], vary_c[2:3].contiguous(), uniforms, shader, what + " one tile")
    check_fresh(winner_c[:0], vary_c[:0], uniforms, shader, what + " no tile")


def _orbit_scene(device, eye_shader: bool):
    """(scene, plan) of ``object_orbit_800`` at its tiny size, its pass
    Phong as configured or an Eye shader with the same texture."""
    from rasterbench import catalog, scenes
    from rasterbench.tests.tiny_checkout import tiny_config
    from tinyrenderder_tpu_torch import scene as tscene
    config = tiny_config(json.loads((ROOT / "rasterbench/configs/object_orbit_800.json")
                                    .read_text()))
    plan = scenes.make_plan(config, catalog.Benchmark(ROOT).traffic("host"), 2**31 + 29)
    sc = scenes.port_scene(plan)
    if eye_shader:
        key, _, rim = tscene._lights()
        sc.passes[0].shader = shaders.EyeShader(key, rim)
    return sc, plan


@pytest.mark.cuda
@pytest.mark.parametrize("eye_shader", [False, True], ids=["phong", "eye"])
def test_cuda_fresh_object_orbit_frames(cuda_device, monkeypatch, eye_shader):
    """Every fresh pass of eight views of the ``object_orbit_800`` orbit
    at its tiny size through the kernel == the plain chain on the same
    inputs; each frame of ``render_frame_fused_image`` (``Scene.render_image``)
    equals the frame the plain route renders, with one
    ``launch.shade_fresh`` and one ``shade.kernel`` and no ``shade.plain``."""
    sc, plan = _orbit_scene(cuda_device, eye_shader)
    real = raster_sparse.shade_compact_fresh
    seen = []

    def checked(winner_c, vary_c, uniforms, shader):
        check_fresh(winner_c, vary_c, uniforms, shader, type(shader).__name__, fresh=real)
        seen.append(type(shader).__name__)
        return real(winner_c, vary_c, uniforms, shader)

    for f in range(0, plan.orbit.views, plan.orbit.views // 8):
        sc.camera.set_eye(plan.orbit.eye_at(f))
        with monkeypatch.context() as m:
            m.setattr(raster_sparse, "shade_compact_fresh", checked)
            sc.render_image(cuda_device, frustum_cull=True, backend="tiled")
        trace.reset_counts()
        got = sc.render_image(cuda_device, frustum_cull=True, backend="tiled")
        c = trace.counts()
        assert (c["launch.shade_fresh"], c["shade.kernel"], c["shade.plain"]) == (1, 1, 0), c
        with monkeypatch.context() as m:
            m.setattr(raster_sparse, "_SHADE_DEVICE", "none")
            want = sc.render_image(cuda_device, frustum_cull=True, backend="tiled")
        assert_bits(got.cpu().numpy(), want.cpu().numpy(), f"frame {f}")
    assert seen == ["EyeShader" if eye_shader else "PhongShader"] * 8


@pytest.mark.cuda
def test_cuda_fresh_device_operations(cuda_device):
    """A fresh pass makes exactly one device operation,
    ``shade_fresh_kernel`` (its output is allocated, not filled)."""
    from torch.profiler import ProfilerActivity, profile
    name = "phong"
    shader = SHADERS[name][0]()
    uniforms = uniforms_of(name, shader, cuda_device)
    _, _, _, winner_c, vary_c = stress_planes(name, cuda_device)
    args = (winner_c, vary_c, uniforms, shader)
    raster_sparse.shade_compact_fresh(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                raster_sparse.shade_compact_fresh(*args)
            torch.cuda.synchronize()
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        if len(names) >= 2:
            break
    assert len(names) in (2, 3, 4) and all("shade_fresh_kernel" in n for n in names), names
