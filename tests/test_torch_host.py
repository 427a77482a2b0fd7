"""The port's own host layer against the JAX package's originals.

The port keeps NumPy copies of the host modules it needs (``math3d``,
``camera``, ``models``, ``utils``, the shader classes' host half, the
scene description with its cull and pass inputs, the NumPy post, the
NumPy oracle and the CLI's default scene), so that it imports nothing of
the JAX package.  Each copy must give what its original gives on the same
inputs, bitwise (the JAX package's host modules run NumPy only, so they
run in this process).  A subprocess imports the whole port and checks
that neither jax nor the JAX package was loaded; an ``ast`` scan of the
package and ``chip_smoke.py`` finds no import of either."""

import ast
import base64
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_parity as tp
from torch_parity import FRAMES, ROOT, assert_bits, frame_scene, stats_vector
from tinyrenderder_tpu import camera as j_camera
from tinyrenderder_tpu import cli as j_cli
from tinyrenderder_tpu import math3d as j_math3d
from tinyrenderder_tpu import scene as j_scene
from tinyrenderder_tpu import shaders as j_shaders
from tinyrenderder_tpu.models import obj as j_obj
from tinyrenderder_tpu.models import procedural as j_procedural
from tinyrenderder_tpu.ops import post as j_post
from tinyrenderder_tpu.utils import stats as j_stats
from tinyrenderder_tpu.utils import tga as j_tga
from tinyrenderder_tpu_torch import camera, cli, math3d, shaders
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.models import manager, obj, procedural
from tinyrenderder_tpu_torch.ops import post, semantics
from tinyrenderder_tpu_torch.utils import stats, tga

PACKAGE = os.path.join(ROOT, "tinyrenderder_tpu_torch")


def _same(got, want, what=""):
    """Bitwise equality of arrays, dicts and sequences of them (None = None)."""
    if isinstance(want, dict):
        assert set(got) == set(want), f"{what}: keys {sorted(got)} != {sorted(want)}"
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif want is None:
        assert got is None, what
    else:
        assert_bits(np.asarray(got), np.asarray(want), what)


# ---------------------------------------------------------------------------
# math3d and camera
# ---------------------------------------------------------------------------

MATRICES = {
    "lookat": lambda m: m.lookat(m.vec3(-3.4, 2.2, 1.8), m.vec3(1.35, 1.5, -0.97),
                                 m.vec3(0, 1, 0)),
    "perspective": lambda m: m.perspective(70.0, 1.5, 0.05, 500.0),
    "viewport": lambda m: m.viewport(0, 0, 1200, 800),
    "scale": lambda m: m.scale_matrix(0.014, 0.014, 0.014),
    "translation": lambda m: m.translation_matrix(0.0, 1.6815, 0.0),
    "rotation_y": lambda m: m.rotation_y(-1.9676),
    "transform_point": lambda m: m.transform_point(m.rotation_y(0.3), m.vec3(0.2, -1, 3)),
    "normalized_cross": lambda m: m.normalized(m.cross(m.vec3(1, 2, 3), m.vec3(-1, 0.5, 2))),
}


@pytest.mark.parametrize("name", list(MATRICES))
def test_math3d_matches_jax(name):
    _same(MATRICES[name](math3d), MATRICES[name](j_math3d), name)


def test_aabb_and_frustum_match_jax():
    rng = np.random.default_rng(4)
    vp = (j_math3d.perspective(60.0, 1.6, 0.1, 50.0)
          @ j_math3d.lookat(j_math3d.vec3(0, 0.6, 3), j_math3d.vec3(0, 0, 0),
                            j_math3d.vec3(0, 1, 0)))
    f, jf = math3d.Frustum.from_matrix(vp), j_math3d.Frustum.from_matrix(vp)
    for p, jp in zip(f.planes, jf.planes):
        _same(p.normal, jp.normal, "plane normal")
        assert p.d == jp.d
    m = j_math3d.translation_matrix(0.3, -0.2, 0.1) @ j_math3d.rotation_y(0.7)
    hits = 0
    for _ in range(64):
        pts = rng.normal(size=(10, 3)) + rng.uniform(-40.0, 40.0, size=3)
        box, jbox = math3d.AABB.of_points(pts, 0.01), j_math3d.AABB.of_points(pts, 0.01)
        box, jbox = box.transform(m), jbox.transform(m)
        _same(box.min, jbox.min, "min")
        _same(box.max, jbox.max, "max")
        _same(box.center(), jbox.center(), "center")
        hit = f.intersects(box)
        assert hit == jf.intersects(jbox)
        hits += hit
    assert 0 < hits < 64


@pytest.mark.parametrize("setup", ["cli", "bench", "square"])
def test_camera_matches_jax(setup):
    eye, target, fov, aspect, near, far = {
        "cli": ((-3.4019, 2.2001, 1.8026), (1.3555, 1.5116, -0.9686), 70.0, 1.5, 0.05, 500.0),
        "bench": ((0, 0.6, 3.0), (0, 0, 0), 60.0, 1.5, 0.1, 50.0),
        "square": ((0, 0.4, 2.6), (0, 0, 0), 60.0, 1.0, 0.1, 50.0)}[setup]
    cams = []
    for mod, m3 in ((camera, math3d), (j_camera, j_math3d)):
        cam = mod.Camera()
        cam.set_eye(m3.vec3(*eye))
        cam.set_target(m3.vec3(*target))
        cam.set_up(m3.vec3(0, 1, 0))
        cam.set_fov(fov)
        cam.set_aspect(aspect)
        cam.set_clipping(near, far)
        cams.append(cam)
    _same(cams[0].view_matrix, cams[1].view_matrix, "view")
    _same(cams[0].projection_matrix, cams[1].projection_matrix, "projection")
    assert cams[0].describe() == cams[1].describe()


@pytest.mark.parametrize("name", ["stress", "mixed"])
def test_wall_scenes_match_the_bench(name):
    """``scene.stress_scene`` / ``mixed_scene`` against the pass
    ``bench.py::bench_stress`` / ``bench_mixed`` build from the JAX
    package: the bench's view and projection, bitwise, and the same face
    attributes and uniforms (a small grid here; the bench's is 3).  The
    bench passes the view as the modelview, a scene ``view @ model``
    (main.cpp:653), which turns its -0.0 translation into +0.0: equal as
    numbers, and bitwise equal to the JAX scene's own inputs."""
    w, h = 1280, 800
    grid, n_lat, n_lon = 2, 6, 8
    sc = {"stress": tscene.stress_scene, "mixed": tscene.mixed_scene}[name](
        w, h, grid, n_lat, n_lon)
    mesh = {"stress": j_procedural.head_wall, "mixed": j_procedural.mixed_interior}[name](
        grid=grid, n_lat=n_lat, n_lon=n_lon)
    view = j_math3d.lookat((0, 0.3, 6.5), (0, 0, 0), (0, 1, 0))
    proj = j_math3d.perspective(60.0, w / h, 0.1, 50.0)
    _same(sc.camera.view_matrix, view, "view")
    _same(sc.camera.projection_matrix, proj, "projection")
    key, fill, rim = (j_math3d.normalized(j_math3d.vec3(*v)) for v in
                      ((1.0, 1.4, 1.0), (-0.3, 0.5, 0.2), (-1.0, 0.8, -1.5)))
    shader = j_shaders.PhongShader(key, fill, rim, normal_map_strength=0.5)
    (p,) = sc.passes
    attrs, uniforms = tscene._pass_inputs(sc, p, np.float32)
    want = shader.build_uniforms(view @ np.eye(4), proj, mesh.materials[0], np.float32)
    _same(attrs, mesh.face_attributes(np.float32), "attrs")
    _same(uniforms, {k: want[k] for k in uniforms}, "uniforms")
    assert set(uniforms) == set(want)
    bench = shader.build_uniforms(view, proj, mesh.materials[0], np.float32)
    assert all(np.array_equal(uniforms[k], bench[k]) for k in bench)


# ---------------------------------------------------------------------------
# meshes, materials, model files, TGA
# ---------------------------------------------------------------------------

MESHES = {
    "bumpy_head": lambda p: p.bumpy_head(12, 16),
    "uv_sphere": lambda p: p.uv_sphere(10, 14, radius=0.12, name="eyes"),
    "cube": lambda p: p.cube(size=12.0, name="room"),
    "plane": lambda p: p.plane(6.0, y=-1.0),
    "triangle_soup": lambda p: p.triangle_soup(40),
    "head_wall": lambda p: p.head_wall(2, 6, 8),
    "mixed_interior": lambda p: p.mixed_interior(3, 4, 6, room=10.0),
}
MESH_FIELDS = ("positions", "faces", "normals", "uvs", "tangents", "bitangents")


def _mesh_arrays(mesh):
    out = {k: getattr(mesh, k) for k in MESH_FIELDS}
    out["attrs"] = mesh.face_attributes(np.float32)
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_procedural_meshes_match_jax(name):
    mesh, jmesh = MESHES[name](procedural), MESHES[name](j_procedural)
    assert (mesh.name, mesh.nfaces) == (jmesh.name, jmesh.nfaces)
    _same(_mesh_arrays(mesh), _mesh_arrays(jmesh), name)
    _same(mesh.get_center(), jmesh.get_center(), "center")
    for m, jm in zip(mesh.materials, jmesh.materials, strict=True):
        for k in ("diffuse", "normal", "specular", "emission"):
            _same(getattr(m, k), getattr(jm, k), k)


@pytest.mark.parametrize("size", [32, 256])
def test_default_material_matches_jax(size):
    mat, jmat = procedural.default_head_material(size), j_procedural.default_head_material(size)
    for k in ("diffuse", "normal", "specular", "emission"):
        _same(getattr(mat, k), getattr(jmat, k), k)


@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory):
    """A small OBJ with a material library, a diffuse TGA, negative and
    slash-less indices and a quad."""
    d = tmp_path_factory.mktemp("obj")
    tex = (np.arange(4 * 6 * 3) % 251).astype(np.uint8).reshape(4, 6, 3)
    j_tga.TGAImage.from_rgb(tex).write_tga_file(str(d / "skin.tga"))
    (d / "m.mtl").write_text("newmtl skin\nmap_Kd skin.tga\nnewmtl bare\n")
    (d / "model.obj").write_text(
        "mtllib m.mtl\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
        "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
        "vn 0 0 1\nvn 0 1 0\n"
        "usemtl skin\nf 1/1/1 2/2/1 3/3/1 4/4/1\n"
        "usemtl bare\nf -1/-1/-2 -2/-2/-2 -3/-3/-2\nf 1 2 5\n")
    return d


def test_obj_loader_matches_jax(obj_dir):
    path = str(obj_dir / "model.obj")
    mesh, jmesh = obj.load_obj(path), j_obj.load_obj(path)
    assert mesh.nfaces == jmesh.nfaces == 4
    _same(_mesh_arrays(mesh), _mesh_arrays(jmesh), "obj")
    assert len(mesh.materials) == len(jmesh.materials) == 2
    for m, jm in zip(mesh.materials, jmesh.materials):
        _same(m.diffuse, jm.diffuse, "diffuse")
    assert len(mesh.submeshes) == len(jmesh.submeshes) == 2
    for sm, jsm in zip(mesh.submeshes, jmesh.submeshes):
        assert vars(sm) == {k: vars(jsm)[k] for k in vars(sm)}


def _gltf_text() -> bytes:
    from test_gltf import _quad_bin, _quad_json
    data = _quad_bin()
    uri = "data:application/octet-stream;base64," + base64.b64encode(data).decode()
    return json.dumps(_quad_json({"uri": uri, "byteLength": len(data)})).encode()


@pytest.mark.parametrize("ext", [".ply", ".stl", ".gltf", ".glb", ".dae", ".fbx", ".off"])
def test_every_format_loads_as_in_jax(tmp_path, ext):
    """Each of the JAX package's model formats loads through the port's
    ``ModelManager`` (none raises ``NotImplementedError`` any more) to the
    JAX manager's mesh, bitwise."""
    from test_loader_fuzz import LOADERS
    from tinyrenderder_tpu.models import manager as j_manager
    path = tmp_path / f"model{ext}"
    path.write_bytes(_gltf_text() if ext == ".gltf" else LOADERS[ext.lstrip(".")][0]())
    mesh = manager.ModelManager().load_model(str(path))
    jmesh = j_manager.ModelManager().load_model(str(path))
    assert mesh is not None and mesh.nfaces == jmesh.nfaces == 2
    _same(_mesh_arrays(mesh), _mesh_arrays(jmesh), ext)
    assert [vars(s) for s in mesh.submeshes] == [vars(s) for s in jmesh.submeshes]


def test_model_manager_caches_obj(obj_dir):
    mm = manager.ModelManager()
    a = mm.load_model(str(obj_dir / "model.obj"))
    assert a is mm.load_model(str(obj_dir / "model.obj")) and a.nfaces == 4
    assert mm.load_model(str(obj_dir / "missing.obj")) is None


@pytest.mark.parametrize("kind", ["rgb", "gray"])
@pytest.mark.parametrize("rle", [True, False])
def test_tga_bytes_match_jax(tmp_path, kind, rle):
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 4, size=(23, 37, 3), dtype=np.int64).astype(np.uint8) * 60
    rgb[5:9] = 200                                   # runs for the RLE
    img = rgb if kind == "rgb" else np.repeat(rgb[..., :1], 3, axis=-1)
    a, b = tmp_path / "port.tga", tmp_path / "jax.tga"
    tga.TGAImage.from_rgb(img).write_tga_file(str(a), rle=rle)
    j_tga.TGAImage.from_rgb(img).write_tga_file(str(b), rle=rle)
    assert a.read_bytes() == b.read_bytes()
    _same(tga.read(str(b)).to_rgb(), j_tga.read(str(a)).to_rgb(), "read back")
    _same(tga.read(str(a)).to_rgb(), img[::-1], "vertical flip")


def test_stats_text_matches_jax():
    pairs = []
    for mod in (stats, j_stats):
        st = mod.RenderStats()
        st.triangles_rasterized, st.fragments_drawn = 1234, 98765
        st.merge_bbox(3, 4, 500, 600)
        st.merge_z(0.25, 0.75)
        st.models_rendered, st.models_culled = 2, 1
        st.total_triangles, st.culled_triangles = 3000, 12
        pairs.append((st.describe(), st.culling_report()))
    assert pairs[0] == pairs[1]


# ---------------------------------------------------------------------------
# shaders, scenes, post, oracle
# ---------------------------------------------------------------------------

KINDS = ("phong", "eye", "gouraud", "textured", "flat", "depth", "gray_depth")


@pytest.mark.parametrize("kind", KINDS)
def test_shader_host_half_matches_jax(kind):
    """build_uniforms, the NumPy vertex and fragment, and the constants."""
    from helpers import default_view
    view, proj = default_view()
    mesh = {"phong": "head", "eye": "sphere", "gouraud": "sphere", "textured": "head",
            "flat": "head", "depth": "soup", "gray_depth": "sphere"}[kind]
    p = tp.make_pass(tp.standard_meshes()[mesh], tp.make_shader(kind), view, proj)
    jp = tp.make_pass(tp.standard_meshes("jax")[mesh], tp.make_shader(kind, "jax"), view,
                      proj, "jax")
    assert (p.shader.name, p.shader.varying_spec, p.shader.writes_color) == \
        (jp.shader.name, jp.shader.varying_spec, jp.shader.writes_color)
    _same({k: v for k, v in p.uniforms.items()}, {k: jp.uniforms[k] for k in p.uniforms},
          "uniforms")
    clip, vary = p.shader.vertex_np(p.uniforms, p.attrs)
    jclip, jvary = jp.shader.vertex(jp.uniforms, jp.attrs, np)
    _same(clip, jclip, "clip")
    _same(vary, {k: np.asarray(v) for k, v in jvary.items()}, "varyings")
    frag = {k: v[:, 0] for k, v in vary.items()}            # the first corners
    _same(shaders.finalize_color_np(p.shader.fragment_np(p.uniforms, frag)),
          j_shaders.finalize_color(jp.shader.fragment(jp.uniforms, frag, np), np), "colour")
    assert (shaders.EYE_DIFFUSE_BRIGHTNESS_THRESHOLD, shaders.EYE_SPECULAR_POWER_THRESHOLD) \
        == (j_shaders.EYE_DIFFUSE_BRIGHTNESS_THRESHOLD, j_shaders.EYE_SPECULAR_POWER_THRESHOLD)


def test_semantics_constants_match_jax():
    from tinyrenderder_tpu import oracle as j_oracle
    from tinyrenderder_tpu.ops import semantics as j_semantics
    from tinyrenderder_tpu_torch import oracle
    for mod in (semantics, oracle):
        assert (mod.W_EPS, mod.DEGEN_EPS, mod.DENOM_EPS) == \
            (j_semantics.W_EPS, j_semantics.DEGEN_EPS, j_semantics.DENOM_EPS)
    assert j_oracle is not oracle


def _culled(side):
    """The 3-pass scene with its eyes moved behind the camera."""
    sc = frame_scene("multimesh", side)
    behind = np.eye(4)
    behind[2, 3] = 100.0
    sc.passes[1].model_matrix = behind
    return sc


SCENES = {"cli_default": lambda side: frame_scene("cli_default", side),
          "multimesh": lambda side: frame_scene("multimesh", side),
          "culled": _culled}


@pytest.mark.parametrize("name", list(SCENES))
def test_cull_and_pass_inputs_match_jax(name):
    sc, jsc = SCENES[name]("port"), SCENES[name]("jax")
    st, jst = stats.RenderStats(), j_stats.RenderStats()
    vis = tscene._cull_passes(sc, True, st)
    jvis = j_scene._cull_passes(jsc, True, jst)
    assert [p.name for p in vis] == [p.name for p in jvis]
    assert [p.exclude_from_output_depth for p in vis] == \
        [p.exclude_from_output_depth for p in jvis]
    _same(stats_vector(st), stats_vector(jst), "cull stats")
    for p, jp in zip(vis, jvis):
        attrs, uniforms = tscene._pass_inputs(sc, p, np.float32)
        jattrs, juniforms = j_scene._pass_inputs(jsc, jp, np.float32, device=False)
        _same(attrs, jattrs, f"{p.name} attrs")
        _same(uniforms, {k: juniforms[k] for k in uniforms}, f"{p.name} uniforms")


def test_cli_scene_and_constants_match_jax():
    assert (cli.WIDTH, cli.HEIGHT) == (j_cli.WIDTH, j_cli.HEIGHT)
    _same(cli.KEY_LIGHT_DIR, j_cli.KEY_LIGHT_DIR, "key light")
    sc, jsc = cli.build_default_scene(width=64, height=48), j_cli.build_default_scene(
        width=64, height=48)
    assert [p.name for p in sc.passes] == [p.name for p in jsc.passes]
    for p, jp in zip(sc.passes, jsc.passes):
        _same(p.model_matrix, jp.model_matrix, "model matrix")
        _same(_mesh_arrays(p.mesh), _mesh_arrays(jp.mesh), p.name)
    _same(sc.camera.view_matrix, jsc.camera.view_matrix, "view")


POST_CASES = ("frame", "noisy", "all_inf", "constant_far")


@pytest.mark.parametrize("name", POST_CASES)
def test_numpy_post_matches_jax(name):
    rng = np.random.default_rng(6)
    h, w = 40, 72
    color = rng.integers(0, 256, size=(h, w, 3), dtype=np.int64).astype(np.uint8)
    depth = {"frame": lambda: tscene.oracle_render(frame_scene("multimesh")).depth,
             "noisy": lambda: np.where(rng.random((h, w)) < 0.3, np.inf,
                                       rng.uniform(0.9, 1.0, (h, w))).astype(np.float32),
             "all_inf": lambda: np.full((h, w), np.inf, np.float32),
             "constant_far": lambda: np.full((h, w), 37.5, np.float32)}[name]()
    color = np.resize(color, depth.shape + (3,))
    _same(post.zbuffer_to_image_np(depth), j_post.zbuffer_to_image(depth, np), "zbuffer")
    ao = post.ssao_map_np(depth)
    _same(ao, j_post.ssao_map(depth, np), "ssao map")
    ao_u8 = post.ssao_image_np(ao)
    _same(ao_u8, j_post.ssao_image(j_post.ssao_map(depth, np), np), "ao image")
    _same(post.composite_np(color, ao_u8), j_post.composite(color, ao_u8, np), "composite")
    assert post.ssao_offsets() == j_post.ssao_offsets()
    assert (post.AO_NUM_DIRECTIONS, post.AO_STEPS_PER_DIRECTION, post.AO_SAMPLE_RADIUS,
            post.AO_OCCLUSION_THRESHOLD, post.AO_INTENSITY) == (
        j_post.AO_NUM_DIRECTIONS, j_post.AO_STEPS_PER_DIRECTION, j_post.AO_SAMPLE_RADIUS,
        j_post.AO_OCCLUSION_THRESHOLD, j_post.AO_INTENSITY)


@pytest.mark.parametrize("name", list(FRAMES))
def test_oracle_matches_jax_oracle(name):
    """The port's NumPy oracle against ``scene.render(backend="oracle")``
    at float32: colour, output and full depth, every stats field."""
    got = tscene.oracle_render(frame_scene(name))
    want = frame_scene(name, "jax").render(backend="oracle", dtype=np.float32)
    for k in ("color", "depth", "full_depth"):
        _same(getattr(got, k), getattr(want, k), k)
    _same(stats_vector(got.stats), stats_vector(want.stats), "stats")
    assert got.stats.fragments_drawn > 0


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _port_modules() -> list[str]:
    mods = []
    for dirpath, _, files in os.walk(PACKAGE):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_loads_neither_jax_nor_the_jax_package():
    mods = _port_modules()
    assert "tinyrenderder_tpu_torch.ops.raster_fine" in mods and len(mods) > 20
    assert {"tinyrenderder_tpu_torch.parallel", "tinyrenderder_tpu_torch.parallel.dist"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.split('.')[0] == 'tinyrenderder_tpu')\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


#: traces of four marked calls of a call of kernels a, b, c ("m" the marker)
#: -> (events read, whether the whole trace was read), or None
TRACE_CASES = {
    "whole": ("mabc" * 4, (9, True)),
    "markers_dropped": ("abc" * 4, (9, True)),
    "first_kernel_dropped": ("mbc" + "mabc" * 3, (9, False)),
    "inconsistent": ("mb" + "ma" + "mabc" * 2, None),
    "empty": ("", None),
}


@pytest.mark.parametrize("case", list(TRACE_CASES))
def test_chip_smoke_reads_a_trace_whole_first(case):
    """``chip_smoke.per_call`` reads a trace by the whole-trace check where
    it holds and by the marker split only where it does not."""
    import types

    import chip_smoke
    names, want = TRACE_CASES[case]
    events = [types.SimpleNamespace(name=chip_smoke.MARK_KERNEL if c == "m" else f"k_{c}")
              for c in names]
    got = chip_smoke.per_call(events, 3)
    if want is None:
        assert got is None
        return
    read, whole = got
    assert (len(read), whole) == want
    assert [e.name for e in read] == ["k_a", "k_b", "k_c"] * 3


def _imports(path: str) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_source_imports_the_jax_package():
    files = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(PACKAGE) for f in fs if f.endswith(".py")]
    assert os.path.join(PACKAGE, "parallel", "dist.py") in files
    bad = [(os.path.relpath(f, ROOT), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "tinyrenderder_tpu")]
    assert not bad, bad
    assert "torch.distributed" in _imports(os.path.join(PACKAGE, "parallel", "dist.py"))
    assert "tinyrenderder_tpu_torch.ops" in _imports(os.path.join(PACKAGE, "scene.py"))
