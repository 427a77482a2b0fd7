"""The port's model loaders, model manager and host I/O helpers against the
JAX package's originals.

The port keeps its own copies of ``models/{ply,stl,off,gltf,collada,fbx}.py``
and of the manager that dispatches on the extension.  Every input here
is written under ``tmp_path`` (with the writers of the JAX package's own
loader tests and ``chip_smoke.py``'s model writers) and loaded by both
packages: every ``Mesh`` field, submesh and texture must be bitwise the
same.  A ``hypothesis`` fuzz truncates and corrupts each format's bytes:
both loaders raise the same exception type or return equal meshes.  The
``TGAImage`` methods, ``procedural.noise_texture`` and
``native.obj_available`` are held against theirs as well."""

import base64
import io
import json
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
import test_collada as jt_dae
import test_fbx as jt_fbx
import test_gltf as jt_gltf
import test_loader_fuzz as jt_fuzz
import test_off as jt_off
import test_ply as jt_ply
import test_stl as jt_stl
from torch_parity import assert_bits
from tinyrenderder_tpu.models import manager as j_manager
from tinyrenderder_tpu.models import procedural as j_procedural
from tinyrenderder_tpu.utils import native as j_native
from tinyrenderder_tpu.utils import tga as j_tga
from tinyrenderder_tpu_torch.models import manager, procedural
from tinyrenderder_tpu_torch.utils import native, tga

MESH_FIELDS = ("positions", "faces", "normals", "uvs", "tangents", "bitangents")
MAPS = ("diffuse", "normal", "specular", "emission")


def same_mesh(mesh, jmesh, what=""):
    """Every field of two meshes bitwise (NaNs match), with the submeshes,
    materials and local AABB."""
    assert type(mesh).__name__ == type(jmesh).__name__ == "Mesh"
    assert mesh.name == jmesh.name, what
    for k in MESH_FIELDS:
        assert_bits(getattr(mesh, k), getattr(jmesh, k), f"{what} {k}")
    assert [vars(s) for s in mesh.submeshes] == [vars(s) for s in jmesh.submeshes], what
    assert len(mesh.materials) == len(jmesh.materials), what
    for m, jm in zip(mesh.materials, jmesh.materials):
        assert m.name == jm.name, what
        for k in MAPS:
            a, b = getattr(m, k), getattr(jm, k)
            assert (a is None) == (b is None), f"{what} {k}"
            if a is not None:
                assert_bits(a, b, f"{what} {k}")
    for k in ("min", "max"):
        assert_bits(getattr(mesh.get_local_aabb(), k), getattr(jmesh.get_local_aabb(), k),
                    f"{what} aabb {k}")


# ---------------------------------------------------------------------------
# the inputs: one writer per case, each -> the path to load
# ---------------------------------------------------------------------------

def _head():
    head = procedural.bumpy_head(8, 12)
    head.name = "head"
    return head


def _ply_texture(d):
    jt_ply._write_ascii(d / "mesh.ply")
    tga.TGAImage.from_rgb(procedural.checker_texture(8)).write_tga_file(
        str(d / "mesh_diffuse.tga"))
    return d / "mesh.ply"


def _ply_mixed(d):
    header = ("ply\nformat binary_little_endian 1.0\nelement vertex 4\n"
              "property float x\nproperty float y\nproperty float z\nelement face 2\n"
              "property list uchar int vertex_indices\nend_header\n")
    blob = b"".join(struct.pack("<3f", *p) for p in ((0, 0, 0), (1, 0, 0), (1, 1, 0),
                                                     (0, 1, 0)))
    blob += struct.pack("<B3i", 3, 0, 1, 2) + struct.pack("<B4i", 4, 0, 1, 2, 3)
    (d / "mixed.ply").write_bytes(header.encode() + blob)
    return d / "mixed.ply"


def _stl_solid_prefixed(d):
    jt_stl._write_binary(d / "m.stl", jt_stl.TRIS)
    data = bytearray((d / "m.stl").read_bytes())
    data[:6] = b"solid "
    (d / "m.stl").write_bytes(bytes(data))
    return d / "m.stl"


def _gltf(d, name, buffer_entry, with_uv=True, nodes=None):
    j = jt_gltf._quad_json(buffer_entry, with_uv)
    if nodes is not None:
        j["nodes"] = nodes
    (d / name).write_text(json.dumps(j))
    return d / name


def _glb(d, with_uv=True, nodes=None):
    data = jt_gltf._quad_bin(with_uv)
    j = jt_gltf._quad_json({"byteLength": len(data)}, with_uv)
    if nodes is not None:
        j["nodes"] = nodes
    jt_gltf._write_glb(d / "q.glb", j, data)
    return d / "q.glb"


def _gltf_external(d, nodes=None):
    data = jt_gltf._quad_bin()
    (d / "q.bin").write_bytes(data)
    return _gltf(d, "q.gltf", {"uri": "q.bin", "byteLength": len(data)}, nodes=nodes)


def _gltf_data_uri(d):
    data = jt_gltf._quad_bin()
    uri = "data:application/octet-stream;base64," + base64.b64encode(data).decode()
    return _gltf(d, "d.gltf", {"uri": uri, "byteLength": len(data)})


def _glb_embedded_png(d):
    """Two primitives, an embedded PNG base colour on the first."""
    from PIL import Image
    img = np.zeros((4, 4, 3), np.uint8)
    img[..., 0], img[1, 2] = 200, (10, 20, 30)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    parts = [jt_gltf.POS.tobytes(), jt_gltf.UV.tobytes(),
             np.array([0, 1, 2], np.uint16).tobytes(),
             np.array([0, 2, 3], np.uint16).tobytes(), buf.getvalue()]
    views, o = [], 0
    for part in parts:
        views.append({"buffer": 0, "byteOffset": o, "byteLength": len(part)})
        o += len(part)
    data = b"".join(parts)
    acc = [("VEC3", 5126, 4), ("VEC2", 5126, 4), ("SCALAR", 5123, 3), ("SCALAR", 5123, 3)]
    j = {"asset": {"version": "2.0"}, "buffers": [{"byteLength": len(data)}],
         "bufferViews": views,
         "accessors": [{"bufferView": i, "componentType": c, "count": n, "type": t}
                       for i, (t, c, n) in enumerate(acc)],
         "images": [{"bufferView": 4, "mimeType": "image/png"}],
         "textures": [{"source": 0}],
         "materials": [{"name": "tex", "pbrMetallicRoughness":
                        {"baseColorTexture": {"index": 0}}}, {"name": "plain"}],
         "meshes": [{"primitives": [
             {"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 2, "material": 0},
             {"attributes": {"POSITION": 0, "TEXCOORD_0": 1}, "indices": 3,
              "material": 1}]}],
         "nodes": [{"mesh": 0}], "scenes": [{"nodes": [0]}]}
    jt_gltf._write_glb(d / "t.glb", j, data)
    return d / "t.glb"


TRI = """<triangles count="2"><input semantic="VERTEX" source="#vtx" offset="0"/>
  <p>0 1 2 0 2 3</p></triangles>"""


def _dae(d, body, up="Y_UP"):
    (d / "m.dae").write_text(jt_dae._doc(body, up=up))
    return d / "m.dae"


def _dae_transforms(d):
    body = jt_dae._geometry(TRI).replace(
        '<node><instance_geometry url="#quad"/></node>',
        """<node><translate>10 0 0</translate><rotate>1 0 0 90</rotate><scale>2 2 2</scale>
             <node><instance_geometry url="#quad"/></node></node>""")
    return _dae(d, body)


def _fbx(d, version=7400, compress=False, model_props=()):
    nodes, version = jt_fbx._quad_doc(version, compress, model_props)
    jt_fbx._write_fbx(d / "q.fbx", nodes, version)
    return d / "q.fbx"


def _written(ext):
    """The smoke's writer of ``ext`` on a small bumpy head."""
    def make(d):
        chip_smoke.MODEL_WRITERS[ext](d / f"head{ext}", _head())
        return d / f"head{ext}"
    return make


def _text(name, text):
    def make(d):
        (d / name).write_text(text)
        return d / name
    return make


TRS = [{"mesh": 0, "translation": [1.0, -2.0, 0.5], "scale": [2.0, 1.0, 3.0],
        "rotation": [0.0, 0.38268343, 0.0, 0.92387953]}]
MATRIX = [{"mesh": 0, "matrix": [0, 0, -1, 0, 0, 2, 0, 0, 1, 0, 0, 0, 3, 4, 5, 1]}]
FBX_TRS = (("Lcl Translation", "Lcl Translation", "", "A", 1.0, 2.0, 3.0),
           ("Lcl Rotation", "Lcl Rotation", "", "A", 30.0, 45.0, 60.0),
           ("Lcl Scaling", "Lcl Scaling", "", "A", 2.0, 0.5, 1.5))

CASES = {
    "ply_ascii": lambda d: (jt_ply._write_ascii(d / "a.ply"), d / "a.ply")[1],
    "ply_binary_le": lambda d: (jt_ply._write_binary(d / "l.ply", "binary_little_endian"),
                                d / "l.ply")[1],
    "ply_binary_be": lambda d: (jt_ply._write_binary(d / "b.ply", "binary_big_endian"),
                                d / "b.ply")[1],
    "ply_mixed_arity": _ply_mixed,
    "ply_texture_fallback": _ply_texture,
    "ply_head": _written(".ply"),
    "stl_binary": lambda d: (jt_stl._write_binary(d / "b.stl", jt_stl.TRIS), d / "b.stl")[1],
    "stl_ascii": lambda d: (jt_stl._write_ascii(d / "a.stl", jt_stl.TRIS), d / "a.stl")[1],
    "stl_solid_prefixed_binary": _stl_solid_prefixed,
    "stl_head": _written(".stl"),
    "off_quad": _text("q.off", jt_off.QUAD),
    "off_colors": _text("c.off", "COFF 4 2 0\n0 0 0 255 0 0\n1 0 0 0 255 0\n"
                                  "1 1 0 0 0 255\n0 1 0 255 255 0\n"
                                  "3 0 1 2 0.5 0.5 0.5\n3 0 2 3 0.1 0.2 0.3\n"),
    "off_head": _written(".off"),
    "glb_quad": _glb,
    "glb_no_uv": lambda d: _glb(d, with_uv=False),
    "glb_trs_node": lambda d: _glb(d, nodes=TRS),
    "gltf_matrix_node": lambda d: _gltf_external(d, nodes=MATRIX),
    "gltf_external_bin": _gltf_external,
    "gltf_data_uri": _gltf_data_uri,
    "glb_embedded_png": _glb_embedded_png,
    "glb_head": _written(".glb"),
    "dae_triangles": lambda d: _dae(d, jt_dae._geometry(TRI)),
    "dae_polylist": lambda d: _dae(d, jt_dae._geometry(
        """<polylist count="1"><input semantic="VERTEX" source="#vtx" offset="0"/>
           <vcount>4</vcount><p>0 1 2 3</p></polylist>""")),
    "dae_polygons_uv": lambda d: _dae(d, jt_dae._geometry(
        """<polygons count="1"><input semantic="VERTEX" source="#vtx" offset="0"/>
           <input semantic="TEXCOORD" source="#uvs" offset="1"/>
           <p>0 3 1 2 2 1 3 0</p></polygons>""", jt_dae.UV_SOURCE)),
    "dae_z_up": lambda d: _dae(d, jt_dae._geometry(TRI), up="Z_UP"),
    "dae_x_up": lambda d: _dae(d, jt_dae._geometry(TRI), up="X_UP"),
    "dae_node_transforms": _dae_transforms,
    "fbx_binary_7400": _fbx,
    "fbx_binary_7500_deflate": lambda d: _fbx(d, 7500, True),
    "fbx_ascii": _text("a.fbx", jt_fbx.ASCII_QUAD),
    "fbx_transforms": lambda d: _fbx(d, model_props=FBX_TRS),
}


@pytest.mark.parametrize("case", list(CASES))
def test_loader_matches_jax(tmp_path, case):
    """Through each package's ``load_mesh``, which picks the loader by
    extension: the port's mesh is the JAX loader's, bitwise."""
    path = str(CASES[case](tmp_path))
    mesh, jmesh = manager.load_mesh(path), j_manager.load_mesh(path)
    assert mesh.nfaces > 0
    same_mesh(mesh, jmesh, case)


# ---------------------------------------------------------------------------
# fuzz: truncated and corrupted bytes
# ---------------------------------------------------------------------------

def _fuzz_base(fmt: str) -> bytes:
    if fmt in ("ply", "stl", "off", "glb"):
        import tempfile
        from pathlib import Path
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / f"m.{fmt}"
            chip_smoke.MODEL_WRITERS[f".{fmt}"](path, procedural.bumpy_head(3, 4))
            return path.read_bytes()
    if fmt == "gltf":
        data = jt_gltf._quad_bin()
        uri = "data:application/octet-stream;base64," + base64.b64encode(data).decode()
        return json.dumps(jt_gltf._quad_json({"uri": uri, "byteLength": len(data)})).encode()
    return {"dae": jt_fuzz._quad_dae, "fbx": jt_fuzz._quad_fbx}[fmt]()


FUZZ_FORMATS = ("ply", "stl", "off", "gltf", "glb", "dae", "fbx")


def _outcome(load, path):
    try:
        return load(path, load_textures=False)
    except Exception as e:          # noqa: BLE001 - the type is what is compared
        return type(e)


@pytest.mark.parametrize("fmt", FUZZ_FORMATS)
@settings(max_examples=25, deadline=None, derandomize=True, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_loader_fuzz_matches_jax(tmp_path, fmt, data):
    """Up to three byte substitutions, insertions or deletions, then a
    truncation: both loaders raise the same exception type, or both give
    the same mesh."""
    buf = bytearray(_fuzz_base(fmt))
    edits = data.draw(st.lists(st.tuples(st.integers(0, 2), st.integers(0, len(buf) - 1),
                                         st.integers(0, 255)), max_size=3))
    for op, pos, byte in edits:
        pos = min(pos, max(len(buf) - 1, 0))
        if op == 0 and buf:
            buf[pos] = byte
        elif op == 1:
            buf[pos:pos] = bytes([byte])
        elif buf:
            del buf[pos]
    cut = data.draw(st.integers(0, len(buf)))
    path = tmp_path / f"f.{fmt}"
    path.write_bytes(bytes(buf[:cut]) if data.draw(st.booleans()) else bytes(buf))
    got = _outcome(manager.load_mesh, str(path))
    want = _outcome(j_manager.load_mesh, str(path))
    if isinstance(want, type):
        assert got is want, (got, want)
    else:
        assert not isinstance(got, type), got
        same_mesh(got, want, fmt)


# ---------------------------------------------------------------------------
# the manager
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("weak", [False, True])
def test_model_manager_matches_jax(tmp_path, weak):
    paths = [str(CASES[c](tmp_path)) for c in ("ply_head", "stl_head", "off_head",
                                               "glb_head")]
    mm, jmm = manager.ModelManager(weak=weak), j_manager.ModelManager(weak=weak)
    held = [mm.load_model(p) for p in paths]
    jheld = [jmm.load_model(p) for p in paths]
    for m, jm, p in zip(held, jheld, paths):
        same_mesh(m, jm, p)
        assert mm.get_model(p) is m
    assert mm.stats() == jmm.stats() and len(mm.stats()) == 4
    assert mm.unload_model(paths[0]) and not mm.unload_model(paths[0])
    assert jmm.unload_model(paths[0])
    assert mm.stats() == jmm.stats()
    mm.print_stats()
    mm.unload_all()
    jmm.unload_all()
    assert mm.stats() == jmm.stats() == {}
    assert mm.load_model(str(tmp_path / "missing.ply")) is None
    assert manager.ModelManager.instance() is manager.ModelManager.instance()


def test_weak_manager_drops_unreferenced_meshes(tmp_path):
    path = str(CASES["off_quad"](tmp_path))
    mm = manager.ModelManager(weak=True)
    mesh = mm.load_model(path)
    assert mm.stats() == {"q.off": 2}
    del mesh
    import gc
    gc.collect()
    assert mm.stats() == {}


# ---------------------------------------------------------------------------
# TGAImage, noise texture, native library
# ---------------------------------------------------------------------------

def _pair(make):
    return make(tga.TGAImage), make(j_tga.TGAImage)


@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_tga_image_methods_match_jax(tmp_path, bpp):
    rng = np.random.default_rng(bpp)
    data = rng.integers(0, 256, size=(13, 19, bpp), dtype=np.int64).astype(np.uint8)
    img, jimg = _pair(lambda cls: cls(data=data.copy()))
    assert (img.width, img.height, img.bpp) == (jimg.width, jimg.height, jimg.bpp) == (19, 13,
                                                                                       bpp)
    for x, y in ((0, 0), (18, 12), (5, 7), (-1, 3), (19, 0), (0, 13)):
        assert_bits(img.get(x, y), jimg.get(x, y), f"get {x} {y}")
    for im in (img, jimg):
        im.set(3, 4, (1, 2, 3, 4))
        im.set(-1, 0, (9, 9, 9, 9))
        im.set(19, 13, (9, 9, 9, 9))
        im.flip_horizontally()
        im.flip_vertically()
    assert_bits(img.data, jimg.data, "set + flips")
    for w2, h2 in ((7, 5), (40, 31), (0, 3)):
        a, b = _pair(lambda cls: cls(data=data.copy()))
        assert a.scale(w2, h2) == b.scale(w2, h2)
        assert_bits(a.data, b.data, f"scale {w2}x{h2}")
    for radius in (0, 1, 3):
        a, b = _pair(lambda cls: cls(data=data.copy()))
        a.gaussian_blur(radius)
        b.gaussian_blur(radius)
        assert_bits(a.data, b.data, f"blur {radius}")
    blank, jblank = _pair(lambda cls: cls(7, 5, bpp))
    assert_bits(blank.data, jblank.data, "blank")
    path = str(tmp_path / "x.tga")
    assert jimg.write_tga_file(path)
    back, jback = _pair(lambda cls: cls())
    assert back.read_tga_file(path) and jback.read_tga_file(path)
    assert_bits(back.data, jback.data, "read_tga_file")
    assert not back.read_tga_file(str(tmp_path / "missing.tga"))
    assert (tga.GRAYSCALE, tga.RGB, tga.RGBA) == (j_tga.GRAYSCALE, j_tga.RGB, j_tga.RGBA)


@pytest.mark.parametrize("size,seed", [(64, 11), (17, 3)])
def test_noise_texture_matches_jax(size, seed):
    assert_bits(procedural.noise_texture(size, seed), j_procedural.noise_texture(size, seed))


def test_obj_available():
    """The port's library carries the OBJ tokenizer whenever it loads (its
    binding needs it); the JAX package's answers for its own library."""
    assert native.obj_available() is native.available()
    assert isinstance(j_native.obj_available(), bool)
