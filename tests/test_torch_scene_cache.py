"""The scene entry methods, their device caches and the camera's
auto-framing, against the JAX package.

``Scene.render`` / ``Scene.render_image`` run on the card unless the caller
asks for the CPU (here, where they run the kernels' plain versions).  A
pass's inputs are uploaded once and reused: the face attributes on the
mesh, the finished uniform tensors on the pass, the large uniforms in a
byte-bounded LRU.  The JAX package's contract for those caches
(``tests/test_scene.py``: the LRU and its byte bound, and caches that
never go stale) holds on the port with ``device="cpu"``; nothing
downstream writes into a cached tensor.  Loaded PLY and GLB models framed
by ``auto_setup_for_scene`` render to the JAX package's NumPy oracle
frame, and every camera preset and framing gives its matrices."""

import numpy as np
import pytest
import torch

import chip_smoke
from torch_parity import (FRAMES, SHADOW_KEY, assert_bits, blocker_scene, frame_scene,
                          side_modules)
from tinyrenderder_tpu import camera as j_camera
from tinyrenderder_tpu import math3d as j_math3d
from tinyrenderder_tpu import shaders as j_shaders
from tinyrenderder_tpu.models import manager as j_manager
from tinyrenderder_tpu_torch import camera, convert, math3d, shaders, shadows
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.models import manager, procedural
from tinyrenderder_tpu_torch.ops import raster_sparse
from tinyrenderder_tpu_torch.utils.stats import RenderStats

CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same_frame(got, want, what=""):
    """Colour, output depth, full depth and stats of two RenderResults."""
    for k in ("color", "depth", "full_depth"):
        assert_bits(_np(getattr(got, k)), _np(getattr(want, k)), f"{what} {k}")
    assert got.stats.describe() == want.stats.describe(), what


@pytest.fixture(autouse=True)
def _fresh_lru(monkeypatch):
    """Each test starts with its own empty large-uniform cache."""
    monkeypatch.setattr(tscene, "_DEVICE_UNIFORM_CACHE", type(tscene._DEVICE_UNIFORM_CACHE)())


# ---------------------------------------------------------------------------
# the caches (JAX tests/test_scene.py:115 and :168)
# ---------------------------------------------------------------------------

def test_device_uniform_cache_lru_and_byte_bound(monkeypatch):
    """A large uniform is uploaded once and found by identity (a hit
    returns the same tensor and refreshes recency); one-shot arrays age
    out by the byte bound instead of evicting the long-lived texture;
    small arrays and non-arrays pass through."""
    monkeypatch.setattr(tscene, "_DEVICE_UNIFORM_CACHE_BYTES", 3 * 8192)
    tex = np.zeros(8192, np.uint8)
    dev_tex = tscene._to_device_cached(tex, CPU)
    assert isinstance(dev_tex, torch.Tensor)
    assert tscene._to_device_cached(tex, CPU) is dev_tex
    for _ in range(8):
        tscene._to_device_cached(np.ones(8192, np.uint8), CPU)
        assert tscene._to_device_cached(tex, CPU) is dev_tex
    assert sum(e[0].nbytes for e in tscene._DEVICE_UNIFORM_CACHE.values()) <= 3 * 8192
    small = np.zeros(16, np.float32)
    assert tscene._to_device_cached(small, CPU) is small
    t = torch.zeros(8192)
    assert tscene._to_device_cached(t, CPU) is t
    # the key holds the device: one array on two devices is two entries
    assert all(k[1] == torch.device(CPU) for k in tscene._DEVICE_UNIFORM_CACHE)


KEY = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
FILL = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
RIM = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))


def small_scene(eye=(0, 0.8, 3.2), key=KEY, dx=0.0, width=72, height=72):
    """``tests/test_scene.py::small_scene`` on the port: a floor (Flat), the
    head (Phong) and its eyes (excluded from the output depth)."""
    cam = camera.Camera()
    cam.set_eye(eye)
    cam.set_target((0, 0, 0))
    cam.set_fov(60.0)
    cam.set_aspect(width / height)
    cam.set_clipping(0.1, 50.0)
    sc = tscene.Scene(camera=cam, width=width, height=height)
    head = procedural.bumpy_head(10, 14)
    head.materials = [procedural.default_head_material(32)]
    eyes = procedural.uv_sphere(6, 8, radius=0.15)
    eyes.positions += np.array([0.3, 0.2, 0.85])
    eyes.finalize()
    sc.add(procedural.plane(6.0, -1.2), np.eye(4),
           shaders.FlatShader(light_world=(0.2, 1, 0.3)), name="floor")
    sc.add(head, math3d.translation_matrix(dx, 0, 0), shaders.PhongShader(key, FILL, RIM),
           name="head")
    sc.add(eyes, np.eye(4), shaders.EyeShader(KEY, RIM), name="eyes",
           exclude_from_output_depth=True)
    return sc


def _head(sc):
    return next(p for p in sc.passes if p.name == "head")


def _entry(p):
    return p.__dict__["_device_inputs_cache"]


def test_pass_input_caches_never_go_stale():
    """Each mutation the caches key on misses, and the frame equals a
    freshly built scene's: camera motion, an in-place model-matrix edit, a
    shader light rebound and written in place, a rebound texture, an
    edited and invalidated mesh, a grown and shrunk pass list."""
    sc = small_scene()
    base = sc.render(CPU)
    same_frame(base, small_scene().render(CPU), "base")
    entry, attrs = _entry(_head(sc)), _head(sc).mesh.device_face_attributes(np.float32, CPU)
    same_frame(sc.render(CPU), base, "second frame")
    assert _entry(_head(sc)) is entry                              # a hit
    assert _head(sc).mesh.device_face_attributes(np.float32, CPU) is attrs

    sc.camera.set_eye((0.4, 0.8, 3.0))
    moved = sc.render(CPU)
    assert _entry(_head(sc)) is not entry
    same_frame(moved, small_scene(eye=(0.4, 0.8, 3.0)).render(CPU), "camera")
    assert not torch.equal(moved.color, base.color)
    sc.camera.set_eye((0, 0.8, 3.2))

    _head(sc).model_matrix[:] = math3d.translation_matrix(0.5, 0, 0)
    shifted = sc.render(CPU)
    same_frame(shifted, small_scene(dx=0.5).render(CPU), "model matrix")
    assert not torch.equal(shifted.color, base.color)
    _head(sc).model_matrix[:] = np.eye(4)

    new_key = math3d.normalized(math3d.vec3(-1.0, 0.2, 0.5))
    _head(sc).shader.key_light_world = new_key
    relit = sc.render(CPU)
    same_frame(relit, small_scene(key=new_key).render(CPU), "light rebound")
    assert not torch.equal(relit.color, base.color)
    # a small shader array is taken by value: a write into it is seen
    _head(sc).shader.key_light_world = np.array(KEY)
    same_frame(sc.render(CPU), base, "light restored")
    entry = _entry(_head(sc))
    _head(sc).shader.key_light_world[:] = new_key
    same_frame(sc.render(CPU), relit, "light written in place")
    assert _entry(_head(sc)) is not entry
    _head(sc).shader.key_light_world = np.array(KEY)

    def red(s):
        t = np.zeros((8, 8, 3), np.uint8)
        t[..., 0] = 255
        _head(s).mesh.materials[0].diffuse = t
        return s

    material = _head(sc).mesh.materials[0]
    orig = material.diffuse
    retex = red(sc).render(CPU)
    same_frame(retex, red(small_scene()).render(CPU), "texture rebound")
    assert not torch.equal(retex.color, base.color)
    material.diffuse = orig
    same_frame(sc.render(CPU), base, "texture restored")

    mesh = _head(sc).mesh
    front = int(np.argmax(mesh.positions[:, 2]))
    kept = mesh.positions[front].copy()
    mesh.positions[front] += (0.3, 0.3, 0.3)
    stale = sc.render(CPU)                       # not invalidated: the old upload
    same_frame(stale, base, "edited, not invalidated")
    mesh.invalidate_device_cache()
    edited = sc.render(CPU)
    assert mesh.device_face_attributes(np.float32, CPU) is not attrs
    want = small_scene()
    _head(want).mesh.positions[front] += (0.3, 0.3, 0.3)
    same_frame(edited, want.render(CPU), "invalidated mesh")
    same_frame(edited, tscene.oracle_render(want), "invalidated mesh vs oracle")
    assert not torch.equal(edited.color, base.color)
    mesh.positions[front] = kept
    mesh.invalidate_device_cache()

    n = len(sc.passes)
    box = procedural.cube(size=0.4)
    box.finalize()
    sc.add(box, math3d.translation_matrix(1.0, 0.0, 0.0),
           shaders.FlatShader(light_world=(0.2, 1, 0.3)), name="box")
    grown = sc.render(CPU)
    assert grown.stats.models_rendered == n + 1
    assert not torch.equal(grown.color, base.color)
    sc.passes.pop()
    same_frame(sc.render(CPU), base, "pass list restored")


def test_second_frame_reuses_every_upload():
    """Steady frames upload nothing: the same attribute and uniform dicts,
    the same tensors (data pointers), the same image."""
    sc = frame_scene("multimesh")
    first = sc.render_image(CPU)
    ptrs = {p.name: {k: t.data_ptr() for k, t in
                     p.mesh.device_face_attributes(np.float32, CPU).items()}
            for p in sc.passes}
    entries = {p.name: _entry(p)[4] for p in sc.passes}
    assert torch.equal(sc.render_image(CPU), first)
    for p in sc.passes:
        assert _entry(p)[4] is entries[p.name]
        assert {k: t.data_ptr() for k, t in
                p.mesh.device_face_attributes(np.float32, CPU).items()} == ptrs[p.name]
    # the textures went through the LRU once each (the packed maps and the
    # maps the packs were made from)
    assert len(tscene._DEVICE_UNIFORM_CACHE) > 0
    hits = dict(tscene._DEVICE_UNIFORM_CACHE)
    sc.render_image(CPU)
    assert {k: v[1] for k, v in tscene._DEVICE_UNIFORM_CACHE.items()} == \
        {k: v[1] for k, v in hits.items()}


def _cached_tensors(scenes):
    """Every cached tensor of the scenes' passes: (name, tensor)."""
    out = []
    for sc in scenes:
        for p in sc.passes:
            for key, attrs in p.mesh.__dict__.get("_device_attr_cache", {}).items():
                out += [(f"{p.name} attrs {k}", t) for k, t in attrs.items()]
            hit = p.__dict__.get("_device_inputs_cache")
            if hit is not None:
                out += [(f"{p.name} uniform {k}", t) for k, t in hit[4].items()
                        if isinstance(t, torch.Tensor)]
    out += [(f"lru {k}", v[1]) for k, v in tscene._DEVICE_UNIFORM_CACHE.items()]
    return out


@pytest.mark.parametrize("mode", ["coarse", "fine", "fine2"])
def test_cached_inputs_are_never_written(monkeypatch, mode):
    """The cached dicts and tensors are shared across frames: no raster,
    merge, shading or shadow stage writes into them (each tensor's version
    counter and bytes stay as uploaded)."""
    monkeypatch.setattr(raster_sparse, "FINE_MODE", mode)
    sc, sh = frame_scene("multimesh"), blocker_scene("port")
    head = tscene.headline_scene(96, 64)
    settings = shadows.ShadowSettings(size=64)
    sc.render(CPU)
    head.render_image(CPU)
    shadows.render_with_shadows(sh, SHADOW_KEY, settings, CPU)
    light = shadows.depth_scene(sh, shadows.light_camera_for_scene(sh, SHADOW_KEY, settings),
                                settings)
    lit = sh.__dict__["_shadow_lit_scene"][1]
    scenes = (sc, head, sh, lit, light)
    before = [(name, t, t._version, t.clone()) for name, t in _cached_tensors(scenes)]
    dicts = [(p, dict(_entry(p)[4])) for s in scenes for p in s.passes
             if "_device_inputs_cache" in p.__dict__]
    assert len(before) > 40
    for collect_stats in (True, False):
        sc.render(CPU, collect_stats=collect_stats)
        head.render(CPU, collect_stats=collect_stats)
    sc.render_image(CPU)
    head.render_image(CPU)
    shadows.render_with_shadows(sh, SHADOW_KEY, settings, CPU)
    for name, t, version, copy in before:
        assert t._version == version, f"{name} was written in place"
        assert torch.equal(t, copy), name
    for p, d in dicts:
        # each frame's new shadow map rebuilds the lit passes' entries; the
        # old entries' tensors were checked above
        if p.shader.name != "shadow_phong":
            assert set(_entry(p)[4]) == set(d)
            assert all(_entry(p)[4][k] is v for k, v in d.items()), p.name


def test_device_key_names_the_device(monkeypatch):
    """"cuda" is the current card with its index, so a mesh rendered on the
    CPU and on the card keeps one entry each; with no card, a CUDA device
    raises."""
    assert convert.device_key(CPU) == torch.device(CPU)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.device_key("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert convert.device_key("cuda") == torch.device("cuda", 0) == \
        convert.device_key("cuda:0")
    assert convert.device_key(torch.device("cuda", 1)) == torch.device("cuda", 1)


def test_default_device_without_a_card_raises(monkeypatch):
    """No silent CPU path: the entry methods default to the card and raise
    when there is none, before anything renders."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sc = tscene.headline_scene(64, 64)
    for call in (sc.render, sc.render_image, lambda: tscene.render_scene(sc, "cuda"),
                 lambda: tscene.pass_tensors(sc, "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert "_device_inputs_cache" not in sc.passes[0].__dict__


@pytest.mark.parametrize("name", list(FRAMES))
def test_backends(name):
    """"oracle" is ``oracle_render``; the tiled frame, the scan backend
    ("xla") and the sharded backends (here a world of one rank) render the
    oracle's frame; an unknown backend raises."""
    sc = frame_scene(name)
    want = tscene.oracle_render(sc)
    same_frame(sc.render(backend="oracle"), want, "render oracle")
    assert_bits(sc.render_image(backend="oracle"), want.color, "render_image oracle")
    same_frame(sc.render(CPU), want, "tiled on the CPU")
    assert_bits(sc.render_image(CPU).numpy(), want.color, "image on the CPU")
    for backend in tscene.SHARDED_BACKENDS:
        same_frame(sc.render(CPU, backend=backend), want, f"{backend} on the CPU")
        assert_bits(sc.render_image(CPU, backend=backend).numpy(), want.color,
                    f"{backend} image on the CPU")
    same_frame(sc.render(CPU, backend="xla"), want, "xla on the CPU")
    assert_bits(sc.render_image(CPU, backend="xla").numpy(), want.color, "xla image on the CPU")
    with pytest.raises(ValueError, match="unknown backend"):
        sc.render_image(CPU, backend="tiles")


@pytest.mark.parametrize("name", list(FRAMES))
def test_oracle_dtype_matches_jax(name):
    """``Scene.render(backend="oracle", dtype=np.float64)`` is the float64
    oracle's frame, the JAX package's ``render(backend="oracle",
    dtype=np.float64)`` bitwise; the device backends render in float32
    and refuse another dtype."""
    got = frame_scene(name).render(backend="oracle", dtype=np.float64)
    want = frame_scene(name, "jax").render(backend="oracle", dtype=np.float64)
    assert got.depth.dtype == np.float64
    same_frame(got, want, f"{name} float64 oracle")
    for backend in ("tiled", "xla", *tscene.SHARDED_BACKENDS):
        with pytest.raises(ValueError, match="float32"):
            frame_scene(name).render(CPU, backend=backend, dtype=np.float64)


def test_cull_cache_matches_a_fresh_cull():
    sc = frame_scene("multimesh")
    first, again = RenderStats(), RenderStats()
    vis = tscene._cull_passes(sc, True, first)
    assert tscene._cull_passes(sc, True, again) == vis and again == first
    sc.passes[1].model_matrix[2, 3] = 100.0           # the eyes behind the camera
    moved = RenderStats()
    assert [p.name for p in tscene._cull_passes(sc, True, moved)] == ["head", "room"]
    assert moved.models_culled == 1
    assert len(tscene._cull_passes(sc, False, RenderStats())) == 3


# ---------------------------------------------------------------------------
# loaded models, framed, against the JAX package's NumPy oracle
# ---------------------------------------------------------------------------

def _loaded_scene(side, path, w, h):
    m = side_modules(side)
    mm = {"port": manager, "jax": j_manager}[side].ModelManager()
    mesh = mm.load_model(path)
    mesh.materials = [m["procedural"].default_head_material(32)]
    cam = m["camera"].Camera()
    sc = m["scene"].Scene(camera=cam, width=w, height=h)
    math3d_ = m["math3d"]
    key, fill, rim = (math3d_.normalized(math3d_.vec3(*v)) for v in
                      ((1.0, 1.4, 1.0), (-0.3, 0.5, 0.2), (-1.0, 0.8, -1.5)))
    sc.add(mesh, math3d_.identity4(), m["shaders"].PhongShader(key, fill, rim, 0.5),
           name="model")
    # frame the model closely: the whole of it, the frame's aspect
    cam.set_fov(20.0)
    cam.auto_setup_for_scene(mesh.get_world_aabb(math3d_.identity4()), w / h)
    return sc


@pytest.mark.parametrize("ext", [".ply", ".glb"])
def test_loaded_model_frame_matches_jax(tmp_path, ext):
    """A head written as ``ext``, loaded by each package's manager and
    framed by ``auto_setup_for_scene``: ``Scene.render_image`` and
    ``Scene.render`` on the CPU equal the JAX package's oracle frame."""
    path = tmp_path / f"head{ext}"
    chip_smoke.MODEL_WRITERS[ext](path, procedural.bumpy_head(10, 14))
    w, h = 96, 64
    sc, jsc = _loaded_scene("port", str(path), w, h), _loaded_scene("jax", str(path), w, h)
    assert_bits(sc.camera.view_matrix, jsc.camera.view_matrix, "view")
    want = jsc.render(backend="oracle", dtype=np.float32)
    image = sc.render_image(CPU)
    assert_bits(image.numpy(), want.color, "render_image")
    got = sc.render(CPU)
    for k in ("color", "depth", "full_depth"):
        assert_bits(_np(getattr(got, k)), np.asarray(getattr(want, k)), k)
    assert got.stats.describe() == want.stats.describe()
    assert got.stats.fragments_drawn > 200


# ---------------------------------------------------------------------------
# the camera, the math helpers, the emission sampler, the uniforms token
# ---------------------------------------------------------------------------

def _same_cam(cam, jcam, what):
    assert_bits(cam.view_matrix, jcam.view_matrix, f"{what} view")
    assert_bits(cam.projection_matrix, jcam.projection_matrix, f"{what} projection")
    assert_bits(cam.view_projection_matrix, jcam.view_projection_matrix, f"{what} vp")
    assert cam.describe() == jcam.describe(), what


@pytest.mark.parametrize("preset", [p.name for p in camera.Preset])
def test_camera_presets_match_jax(preset):
    for aspect in (16 / 9, 1.5, 1.0, 0.5):
        _same_cam(camera.Camera(camera.Preset[preset], aspect),
                  j_camera.Camera(j_camera.Preset[preset], aspect), f"{preset} {aspect}")
    # the reference's quirk: up stays (0, 0, -1) after OVERVIEW
    cam, jcam = camera.Camera(camera.Preset.OVERVIEW), j_camera.Camera(j_camera.Preset.OVERVIEW)
    cam.set_preset(camera.Preset[preset], 1.25)
    jcam.set_preset(j_camera.Preset[preset], 1.25)
    _same_cam(cam, jcam, f"OVERVIEW then {preset}")
    assert [p.value for p in camera.Preset] == [p.value for p in j_camera.Preset]


def test_default_camera_unchanged():
    """``Camera()`` keeps the matrices every scene builder starts from."""
    _same_cam(camera.Camera(), j_camera.Camera(), "Camera()")


def test_auto_framing_matches_jax():
    rng = np.random.default_rng(12)
    for trial in range(24):
        lo = rng.uniform(-50, 50, 3)
        hi = lo + rng.uniform(0.01, [1, 30, 300][trial % 3], 3)
        aspect = [16 / 9, 0.75, 1.0][trial % 3]
        cam, jcam = camera.Camera(), j_camera.Camera()
        cam.auto_setup_for_scene(math3d.AABB(lo, hi), aspect)
        jcam.auto_setup_for_scene(j_math3d.AABB(lo, hi), aspect)
        _same_cam(cam, jcam, f"auto {trial}")
    boxes = [(rng.uniform(-5, 0, 3), rng.uniform(0, 5, 3)) for _ in range(4)]
    for n in range(len(boxes) + 1):
        for auto in (True, False):
            cam, jcam = camera.Camera(), j_camera.Camera()
            camera.setup_camera_for_rendering(
                cam, [math3d.AABB(a, b) for a, b in boxes[:n]], 1200, 800, auto)
            j_camera.setup_camera_for_rendering(
                jcam, [j_math3d.AABB(a, b) for a, b in boxes[:n]], 1200, 800, auto)
            _same_cam(cam, jcam, f"{n} models auto={auto}")


def test_math3d_helpers_match_jax(capsys):
    for name, args in (("vec2", (1.5, -2)), ("vec4", (1, 2, 3, 4)), ("rotation_x", (0.7,)),
                       ("rotation_z", (-1.3,)), ("rotation_x", (np.pi,))):
        assert_bits(getattr(math3d, name)(*args), getattr(j_math3d, name)(*args), name)
    m = j_math3d.rotation_x(0.3) @ j_math3d.translation_matrix(1, 2, 3)
    assert_bits(math3d.transform_dir(m, (0.2, -1, 3)), j_math3d.transform_dir(m, (0.2, -1, 3)))
    out = []
    for mod in (math3d, j_math3d):
        mod.print_vec3("v", (1.23456, -2, 3e-5))
        mod.print_mat4("m", m)
        out.append(capsys.readouterr().out)
    assert out[0] == out[1] and out[0].count("\n") == 6


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "none"])
def test_sample_emission_matches_jax(kind):
    rng = np.random.default_rng(3)
    c = {"rgb": 3, "rgba": 4, "gray": 1, "none": 0}[kind]
    tex = (rng.integers(0, 256, size=(5, 7, c), dtype=np.int64).astype(np.uint8)
           if c else None)
    u = rng.uniform(-0.2, 1.2, 50).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, 50).astype(np.float32)
    got = shaders.sample_emission(None if tex is None else torch.from_numpy(tex),
                                  torch.from_numpy(u), torch.from_numpy(v))
    assert_bits(got.numpy(), j_shaders.sample_emission(tex, u, v, np), kind)


def test_uniforms_token_takes_a_tensor_by_reference():
    """``shadow_map`` on the card is a reference in the token: never copied,
    never moved to the host; a rebound map misses, the same one matches.
    The small arrays' entries are the JAX package's."""
    smap = torch.zeros(96, 96)
    args = (KEY, FILL, RIM, np.eye(4))
    sh = shaders.ShadowMappedShader(*args, shadow_map=smap)
    tok = sh.uniforms_token()
    entry = dict((e[0], e) for e in tok)["shadow_map"]
    assert entry[1] == "ref" and entry[2] is smap
    assert shaders.tokens_match(tok, sh.uniforms_token())
    sh.shadow_map = smap.clone()
    assert not shaders.tokens_match(tok, sh.uniforms_token())
    jtok = j_shaders.ShadowMappedShader(*args, shadow_map=np.zeros((96, 96))).uniforms_token()
    assert [e[:2] for e in tok] == [e[:2] for e in jtok]
    assert [e for e in tok if e[1] == "nd"] == [e for e in jtok if e[1] == "nd"]
