"""The port's exact math (tinyrenderder_tpu_torch.ops.semantics and the
device halves of .shaders) against the JAX package's NumPy path
(``xp=numpy``), bitwise, on CPU tensors.  The JAX side runs on the JAX
package's meshes and shaders, the port side on the port's own.

NumPy is the bitwise anchor: torch's CPU kernels run the same IEEE ops
as NumPy, while XLA:CPU may contract multiply-adds and divides by
constants through a reciprocal (see tests/torch_parity.py)."""

import numpy as np
import pytest
import torch

import torch_parity as tp
from helpers import default_view, make_pass, standard_meshes
from torch_parity import assert_bits, make_shader
from tinyrenderder_tpu import math3d
from tinyrenderder_tpu import shaders as ref_shaders
from tinyrenderder_tpu.models.mesh import Mesh
from tinyrenderder_tpu.ops import semantics as ref
from tinyrenderder_tpu_torch import convert, shaders
from tinyrenderder_tpu_torch.models.mesh import Mesh as PortMesh
from tinyrenderder_tpu_torch.ops import semantics


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_triangles(seed, n=512):
    """Screen-space triangles and pixel centers, with some degenerate,
    sliver and far-away cases mixed in."""
    rng = np.random.default_rng(seed)
    tri = rng.uniform(-20, 60, size=(n, 6)).astype(np.float32)
    tri[:32, 2:4] = tri[:32, 0:2]                      # two equal corners
    tri[32:64, 4:6] = tri[32:64, 0:2] + 1e-7           # near-degenerate
    tri[64:96] *= np.float32(1e6)                      # huge coordinates
    px = (rng.integers(0, 40, size=(n, 16)) + 0.5).astype(np.float32)
    py = (rng.integers(0, 40, size=(n, 16)) + 0.5).astype(np.float32)
    return tri, px, py


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_barycentric_coverage_depth_match_numpy(seed):
    tri, px, py = _random_triangles(seed)
    cols = [tri[:, k:k + 1] for k in range(6)]
    b_ref = ref.barycentric(*cols, px, py, np)
    b_got = semantics.barycentric(*(_t(c) for c in cols), _t(px), _t(py))
    for name, g, w in zip(("b0", "b1", "b2", "degen"), b_got, b_ref):
        assert_bits(g.numpy(), w, name)
    assert_bits(semantics.coverage_mask(*b_got[:3]).numpy(),
                ref.coverage_mask(*b_ref[:3]), "coverage")
    rng = np.random.default_rng(seed + 10)
    z = rng.uniform(-1.5, 1.5, size=(tri.shape[0], 3)).astype(np.float32)
    w = rng.uniform(-0.5, 5, size=(tri.shape[0], 3)).astype(np.float32)
    w[:16] = 0.0
    w[16:32, 0] = np.float32(1e-13)                    # below W_EPS
    zc = [z[:, k:k + 1] for k in range(3)]
    wc = [w[:, k:k + 1] for k in range(3)]
    assert_bits(semantics.affine_z(*(_t(c) for c in zc), *b_got[:3]).numpy(),
                ref.affine_z(*zc, *b_ref[:3]), "affine_z")
    p_ref = ref.perspective_correct_bary(*b_ref[:3], *wc, np)
    p_got = semantics.perspective_correct_bary(*b_got[:3], *(_t(c) for c in wc))
    for k in range(3):
        assert_bits(p_got[k].numpy(), p_ref[k], f"p{k}")
    v = [rng.normal(size=(tri.shape[0], 1)).astype(np.float32) for _ in range(3)]
    assert_bits(semantics.interp3(*(_t(c) for c in v), *p_got).numpy(),
                ref.interp3(*v, *p_ref), "interp3")


def test_apply_mat4_matches_numpy():
    rng = np.random.default_rng(5)
    m = rng.normal(size=(4, 4)).astype(np.float32)
    v = rng.normal(size=(300, 3, 4)).astype(np.float32)
    assert_bits(semantics.apply_mat4(_t(m), _t(v)).numpy(), ref.apply_mat4(m, v, np))


def _clip_cases():
    """Clip-space triangles that hit every whole-triangle reject: w <= eps,
    all z outside, NaN and Inf, back faces, off-screen and huge boxes."""
    rng = np.random.default_rng(7)
    clip = rng.uniform(-2, 2, size=(400, 3, 4)).astype(np.float32)
    clip[..., 3] = rng.uniform(0.2, 3, size=(400, 3)).astype(np.float32)
    clip[0:20, 1, 3] = 0.0
    clip[20:40, 2, 3] = np.float32(1e-13)
    clip[40:60, :, 2] = 5.0 * clip[40:60, :, 3]       # all z > 1
    clip[60:70, 0, 0] = np.nan
    clip[70:80, 1, 1] = np.inf
    clip[80:90] *= np.float32(1e30)
    clip[90:100, :, :2] = 0.0                          # zero area
    return clip


@pytest.mark.parametrize("size", [(64, 48), (160, 42)])
def test_triangle_setup_planes_matches_numpy(size):
    w, h = size
    clip = _clip_cases()
    vp = math3d.viewport(0, 0, w, h).astype(np.float32)
    want = ref.triangle_setup_planes(clip, vp, w, h, np)
    got = semantics.triangle_setup_planes(_t(clip), _t(vp), w, h)
    assert set(got) == set(want)
    for k in want:
        assert_bits(got[k].numpy(), want[k], k)
    assert want["valid"].any() and not want["valid"].all()


def test_setup_of_the_edge_case_meshes_matches_numpy():
    """The degenerate triangles of tests/test_edge_cases.py through the
    Gouraud vertex stage and setup."""
    tris = np.array([
        [[0, 0, 0], [0, 0, 0], [0, 0, 0]],
        [[-1, 0, 0], [0, 0, 0], [1, 0, 0]],
        [[np.nan, 0, 0], [1, 0, 0], [0, 1, 0]],
        [[0, 0, 10], [1, 0, 10], [0, 1, 10]],
        [[-0.5, -0.5, 0], [0.5, -0.5, 0], [0.0, 0.5, 0]],
        [[-50, -50, -1], [50, -50, -1], [0, 80, -1]],
    ], dtype=np.float64)
    n = tris.shape[0]
    parts = dict(positions=tris.reshape(-1, 3),
                 faces=np.arange(n * 3, dtype=np.int32).reshape(n, 3),
                 normals=np.tile([0.0, 0.0, 1.0], (n * 3, 1)), uvs=np.zeros((n * 3, 2)))
    view, proj = default_view()
    p = make_pass(Mesh(**parts), ref_shaders.GouraudShader(), view, proj)
    clip_ref, vary_ref = p.shader.vertex(p.uniforms, p.attrs, np)
    q = tp.make_pass(PortMesh(**parts), shaders.GouraudShader(), view, proj)
    attrs, uniforms = convert.pass_to_torch(q.attrs, q.uniforms, "cpu")
    clip, vary = shaders.vertex(q.shader, uniforms, attrs)
    assert_bits(clip.numpy(), clip_ref, "clip")
    assert_bits(vary["intensity"].numpy(), vary_ref["intensity"], "intensity")
    vp = math3d.viewport(0, 0, 64, 48).astype(np.float32)
    want = ref.triangle_setup_planes(clip_ref, vp, 64, 48, np)
    got = semantics.triangle_setup_planes(clip, _t(vp), 64, 48)
    for k in want:
        assert_bits(got[k].numpy(), want[k], k)
    assert want["valid"].tolist()[:5] == [False, False, False, False, True]


@pytest.fixture(scope="module")
def meshes():
    return standard_meshes()


@pytest.fixture(scope="module")
def port_meshes():
    return tp.standard_meshes("port")


@pytest.mark.parametrize("mesh,kind", [("head", "phong"), ("sphere", "gouraud"),
                                       ("head", "textured"), ("soup", "phong"),
                                       ("sphere", "eye")])
def test_vertex_matches_numpy(meshes, port_meshes, mesh, kind):
    view, proj = default_view()
    p = make_pass(meshes[mesh], make_shader(kind, "jax"), view, proj)
    clip_ref, vary_ref = p.shader.vertex(p.uniforms, p.attrs, np)
    q = tp.make_pass(port_meshes[mesh], make_shader(kind), view, proj)
    attrs, uniforms = convert.pass_to_torch(q.attrs, q.uniforms, "cpu")
    clip, vary = shaders.vertex(q.shader, uniforms, attrs)
    assert_bits(clip.numpy(), clip_ref, "clip")
    assert set(vary) == set(vary_ref) == set(q.shader.varying_spec)
    for k in vary_ref:
        assert_bits(vary[k].numpy(), np.asarray(vary_ref[k]), k)


def _random_varyings(spec, n, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, c in spec.items():
        if name == "uv":
            v = rng.uniform(-0.2, 1.2, size=(n, c))        # clamp-to-edge too
        elif name == "intensity":
            v = rng.uniform(0.0, 1.0, size=(n, c))
        else:
            v = rng.normal(size=(n, c))
        out[name] = v.astype(np.float32)
    out_uv = out.get("uv")
    if out_uv is not None:
        out_uv[:4] = [[np.nan, 0.5], [1e10, -1e10], [0.0, 1.0], [1.0, 0.0]]
    if "normal_eye" in out:
        out["normal_eye"][4] = 0.0                       # zero-length normal
    return out


@pytest.mark.parametrize("mesh,kind,packed", [
    ("head", "phong", True), ("head", "phong", False), ("soup", "phong", False),
    ("sphere", "gouraud", False), ("head", "textured", False),
    ("head", "eye", True), ("sphere", "eye", True), ("soup", "eye", False)])
def test_fragment_matches_numpy(meshes, port_meshes, mesh, kind, packed):
    view, proj = default_view()
    p = make_pass(meshes[mesh], make_shader(kind, "jax"), view, proj)
    q = tp.make_pass(port_meshes[mesh], make_shader(kind), view, proj)
    u, uq = dict(p.uniforms), dict(q.uniforms)
    if "tex_packed" in u and not packed:
        u["tex_packed"] = uq["tex_packed"] = None          # the individual samplers
    assert (u.get("tex_packed") is not None) == packed
    vary = _random_varyings(p.shader.varying_spec, 4096, seed=len(mesh) + len(kind))
    want = ref_shaders.finalize_color(p.shader.fragment(u, vary, np), np)
    _, ut = convert.pass_to_torch({}, uq, "cpu")
    rgb = shaders.fragment(q.shader, ut, {k: _t(v) for k, v in vary.items()})
    assert_bits(rgb.numpy(), p.shader.fragment(u, vary, np), "rgb")
    assert_bits(shaders.finalize_color(rgb).numpy(), want, "color")


def test_finalize_color_matches_numpy():
    x = np.array([-0.9, -0.0, 0.0, 0.5, 254.99, 255.0, 255.5, 1e9, np.inf],
                 np.float32)
    assert_bits(shaders.finalize_color(_t(x)).numpy(), ref_shaders.finalize_color(x, np))


def test_unported_shader_raises():
    """Every shader class of the JAX package has its counterpart in the
    port, and the port supports each; a class it does not know raises,
    a subclass included (a Phong subclass is not Phong)."""
    class UnknownShader(shaders.Shader):
        name = "unknown"

    class MyPhong(shaders.PhongShader):
        name = "my_phong"

    with pytest.raises(NotImplementedError, match="UnknownShader"):
        shaders.vertex(UnknownShader(), {}, {})
    names = {c.__name__ for c in vars(ref_shaders).values()
             if isinstance(c, type) and issubclass(c, ref_shaders.Shader)}
    assert names == {c.__name__ for c in vars(shaders).values()
                     if isinstance(c, type) and issubclass(c, shaders.Shader)}
    key, fill, rim = (0, 0, 1), (0, 1, 0), (1, 0, 0)
    ported = [shaders.Shader(), shaders.PhongShader(key, fill, rim),
              shaders.EyeShader(key, rim), shaders.FlatShader(), shaders.GouraudShader(),
              shaders.TexturedShader(), shaders.DepthShader(), shaders.GrayDepthShader(),
              shaders.ShadowMappedShader(key, fill, rim, np.eye(4), None)]
    assert {type(s).__name__ for s in ported} == names
    assert [shaders.supports(s) for s in ported] == [False] + [True] * (len(ported) - 1)
    assert not shaders.supports(MyPhong(key, fill, rim))
    assert not shaders.supports(ref_shaders.EyeShader(key, rim))
