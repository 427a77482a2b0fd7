"""glTF 2.0 loader (.gltf JSON + external/data-URI buffers, .glb binary).

Counterpart of ``tinyrenderder_tpu/models/gltf.py``, line for line.

Fourth mesh format beside OBJ/PLY/STL, and the one that exercises the
remaining Assimp-pipeline behaviors the reference gets for free from
``ReadFile`` (model.cpp:91-99): a node *hierarchy* whose transforms must
be baked into the vertices (aiProcess_PreTransformVertices analogue —
positions by the world matrix, normals by its inverse-transpose),
multiple primitives per mesh mapping to SubMesh ranges with per-range
materials, indexed triangle strips/fans (aiProcess_Triangulate), and
*embedded* textures (GLB buffer-view images decoded via PIL instead of
the filename-fallback probe).

Feeds the same ``Mesh`` SoA dataclass + ``finalize()`` postprocess as
the other loaders: V flip (aiProcess_FlipUVs, model.cpp:93), area-
weighted normal generation when absent (aiProcess_GenNormals,
model.cpp:269-316), tangent generation (model.cpp:318-388).

Scope: core glTF 2.0 geometry + materials.  Accessor component types
5120-5126 incl. normalized ints and sparse substitution; byteStride
(interleaved) buffer views; primitive modes 4/5/6; node matrix or TRS
transforms; pbrMetallicRoughness.baseColorTexture -> diffuse,
normalTexture -> normal, emissiveTexture -> emission (glTF has no
direct analogue of the reference's specular map; the filename probe
still supplies ``<stem>_spec.tga`` when present).  Skins/animations/
extensions are ignored (static-geometry parity, like the reference's
import).
"""

from __future__ import annotations

import base64
import io
import json
import logging
import os
import struct
import urllib.parse

import numpy as np

from tinyrenderder_tpu_torch.models.mesh import Material, Mesh, SubMesh
from tinyrenderder_tpu_torch.models.obj import load_material_textures

log = logging.getLogger("tinyrenderder_tpu_torch.gltf")

__all__ = ["load_gltf"]

_COMPONENT_DTYPES = {
    5120: np.dtype("<i1"), 5121: np.dtype("<u1"),
    5122: np.dtype("<i2"), 5123: np.dtype("<u2"),
    5125: np.dtype("<u4"), 5126: np.dtype("<f4"),
}
_TYPE_NCOMP = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
               "MAT2": 4, "MAT3": 9, "MAT4": 16}

_GLB_MAGIC = 0x46546C67          # 'glTF'
_CHUNK_JSON = 0x4E4F534A         # 'JSON'
_CHUNK_BIN = 0x004E4942          # 'BIN\0'


def _read_glb(data: bytes) -> tuple[dict, bytes | None]:
    if len(data) < 12:
        raise ValueError("truncated GLB header")
    magic, version, length = struct.unpack_from("<III", data, 0)
    if magic != _GLB_MAGIC:
        raise ValueError("not a GLB file (bad magic)")
    if version != 2:
        raise ValueError(f"unsupported GLB version: {version}")
    gltf_json = None
    bin_chunk = None
    off = 12
    while off + 8 <= min(length, len(data)):
        clen, ctype = struct.unpack_from("<II", data, off)
        off += 8
        if off + clen > len(data):
            raise ValueError("truncated GLB chunk")
        chunk = data[off:off + clen]
        off += clen + (-clen % 4 if ctype == _CHUNK_JSON else 0)
        # spec: chunks are 4-byte aligned; trailing pad bytes are included
        # in chunkLength for JSON (spaces) / BIN (zeros), so no extra skip
        if ctype == _CHUNK_JSON and gltf_json is None:
            gltf_json = json.loads(chunk.decode("utf-8"))
        elif ctype == _CHUNK_BIN and bin_chunk is None:
            bin_chunk = chunk
    if gltf_json is None:
        raise ValueError("GLB file has no JSON chunk")
    return gltf_json, bin_chunk


def _decode_uri(uri: str, directory: str) -> bytes:
    if uri.startswith("data:"):
        header, _, payload = uri.partition(",")
        if ";base64" in header:
            return base64.b64decode(payload)
        return urllib.parse.unquote_to_bytes(payload)
    rel = urllib.parse.unquote(uri).replace("\\", "/")
    with open(os.path.join(directory, rel), "rb") as f:
        return f.read()


class _Doc:
    """Resolved glTF document: JSON tree + loaded buffer bytes."""

    def __init__(self, j: dict, directory: str, bin_chunk: bytes | None):
        self.j = j
        self.directory = directory
        self.buffers: list[bytes] = []
        for i, buf in enumerate(j.get("buffers", [])):
            uri = buf.get("uri")
            if uri is None:
                if bin_chunk is None:
                    raise ValueError(f"buffer {i} has no uri and no GLB "
                                     "BIN chunk")
                data = bin_chunk
            else:
                data = _decode_uri(uri, directory)
            need = int(buf.get("byteLength", len(data)))
            if len(data) < need:
                raise ValueError(f"buffer {i} truncated: byteLength {need}, "
                                 f"got {len(data)}")
            self.buffers.append(data)

    def view_bytes(self, view_index: int) -> tuple[bytes, int]:
        """(raw bytes, byteStride) of a bufferView."""
        v = self.j["bufferViews"][view_index]
        buf = self.buffers[v["buffer"]]
        off = int(v.get("byteOffset", 0))
        ln = int(v["byteLength"])
        if off + ln > len(buf):
            raise ValueError(f"bufferView {view_index} out of range")
        return buf[off:off + ln], int(v.get("byteStride", 0))

    def accessor(self, index: int) -> np.ndarray:
        """Decode accessor -> (count, ncomp) float64 (or int64 for
        integral component types), sparse substitution applied,
        normalization applied per spec."""
        a = self.j["accessors"][index]
        dt = _COMPONENT_DTYPES.get(a["componentType"])
        if dt is None:
            raise ValueError(f"unknown componentType {a['componentType']}")
        ncomp = _TYPE_NCOMP[a["type"]]
        count = int(a["count"])
        if "bufferView" in a:
            raw, stride = self.view_bytes(a["bufferView"])
            off = int(a.get("byteOffset", 0))
            tight = ncomp * dt.itemsize
            if stride in (0, tight):
                arr = np.frombuffer(raw, dt, count=count * ncomp,
                                    offset=off).reshape(count, ncomp)
            else:
                need = off + (count - 1) * stride + tight
                if need > len(raw):
                    raise ValueError(f"accessor {index} overruns bufferView")
                base = np.frombuffer(raw, np.uint8)
                arr = np.lib.stride_tricks.as_strided(
                    base[off:].view(np.uint8), shape=(count, tight),
                    strides=(stride, 1)).tobytes()
                arr = np.frombuffer(arr, dt).reshape(count, ncomp)
        else:
            arr = np.zeros((count, ncomp), dt)          # sparse-only base

        sparse = a.get("sparse")
        if sparse:
            n = int(sparse["count"])
            iv = sparse["indices"]
            idt = _COMPONENT_DTYPES[iv["componentType"]]
            iraw, _ = self.view_bytes(iv["bufferView"])
            idx = np.frombuffer(iraw, idt, count=n,
                                offset=int(iv.get("byteOffset", 0)))
            vv = sparse["values"]
            vraw, _ = self.view_bytes(vv["bufferView"])
            vals = np.frombuffer(vraw, dt, count=n * ncomp,
                                 offset=int(vv.get("byteOffset", 0)))
            arr = arr.copy()
            arr[idx.astype(np.int64)] = vals.reshape(n, ncomp)

        if dt.kind == "f":
            return arr.astype(np.float64)
        if a.get("normalized"):
            info = np.iinfo(dt)
            out = arr.astype(np.float64) / info.max
            if dt.kind == "i":
                out = np.maximum(out, -1.0)             # spec: clamp i8/i16
            return out
        return arr.astype(np.int64)


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "scale" in node:
        m[:3, :3] = np.diag(node["scale"])
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = r @ m[:3, :3]
    if "translation" in node:
        m[:3, 3] = node["translation"]
    return m


def _triangulate(idx: np.ndarray, mode: int) -> np.ndarray:
    """Index list -> (F, 3) per primitive mode (aiProcess_Triangulate)."""
    if mode == 4:                                       # TRIANGLES
        if idx.size % 3:
            raise ValueError("TRIANGLES index count not a multiple of 3")
        return idx.reshape(-1, 3)
    if mode == 5:                                       # TRIANGLE_STRIP
        n = idx.size - 2
        if n <= 0:
            return np.zeros((0, 3), idx.dtype)
        tris = np.stack([idx[:-2], idx[1:-1], idx[2:]], axis=-1)
        odd = np.arange(n) % 2 == 1                     # flip odd winding
        tris[odd] = tris[odd][:, [1, 0, 2]]
        return tris
    if mode == 6:                                       # TRIANGLE_FAN
        n = idx.size - 2
        if n <= 0:
            return np.zeros((0, 3), idx.dtype)
        return np.stack([np.broadcast_to(idx[0], (n,)), idx[1:-1],
                         idx[2:]], axis=-1)
    raise ValueError(f"unsupported primitive mode {mode} (points/lines)")


def _decode_image(doc: _Doc, image_index: int) -> np.ndarray | None:
    img = doc.j["images"][image_index]
    try:
        if "uri" in img:
            raw = _decode_uri(img["uri"], doc.directory)
        else:
            raw, _ = doc.view_bytes(img["bufferView"])
        from PIL import Image
        with Image.open(io.BytesIO(raw)) as im:
            if im.mode not in ("RGB", "RGBA", "L"):
                im = im.convert("RGBA" if "A" in im.mode else "RGB")
            arr = np.asarray(im)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        return np.ascontiguousarray(arr, np.uint8)      # row 0 = top
    except Exception as e:                              # noqa: BLE001
        log.warning("Failed to decode glTF image %d: %s", image_index, e)
        return None


def _load_materials(doc: _Doc, stem: str,
                    load_textures: bool) -> tuple[list[Material], Material]:
    """(materials list, default material for material-less primitives).

    The default material gets the reference's filename-probe textures
    (model.cpp:207-267 probes ``<stem>_diffuse.tga`` etc. for every
    material without an explicit path — including Assimp's default)."""
    j = doc.j
    if not load_textures:
        default = Material(name="__gltf_default__")
        return ([Material(name=m.get("name", ""))
                 for m in j.get("materials", [])], default)

    image_cache: dict[int, np.ndarray | None] = {}

    def tex(tex_info) -> np.ndarray | None:
        if not tex_info:
            return None
        t = j.get("textures", [])
        ti = tex_info.get("index")
        if ti is None or ti >= len(t) or "source" not in t[ti]:
            return None
        src = t[ti]["source"]
        if src not in image_cache:
            image_cache[src] = _decode_image(doc, src)
        return image_cache[src]

    # filename-probe fallbacks (model.cpp:207-267) for maps glTF lacks
    probe = load_material_textures("", {}, doc.directory, stem)
    mats = []
    for m in j.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        diffuse = tex(pbr.get("baseColorTexture"))
        normal = tex(m.get("normalTexture"))
        emission = tex(m.get("emissiveTexture"))
        mats.append(Material(
            name=m.get("name", ""),
            diffuse=diffuse if diffuse is not None else probe.diffuse,
            normal=normal if normal is not None else probe.normal,
            specular=probe.specular,
            emission=emission if emission is not None else probe.emission))
    default = Material(name="__gltf_default__", diffuse=probe.diffuse,
                       normal=probe.normal, specular=probe.specular,
                       emission=probe.emission)
    return mats, default


def load_gltf(path: str, load_textures: bool = True) -> Mesh:
    """Load a .gltf/.glb file into a finalized Mesh (same postprocess
    contract as load_obj/load_ply/load_stl; node transforms baked like
    aiProcess_PreTransformVertices)."""
    directory = os.path.dirname(os.path.abspath(path))
    stem = os.path.splitext(os.path.basename(path))[0]

    with open(path, "rb") as f:
        data = f.read()
    if data[:4] == b"glTF":
        j, bin_chunk = _read_glb(data)
    else:
        j = json.loads(data.decode("utf-8"))
        bin_chunk = None
    doc = _Doc(j, directory, bin_chunk)

    # collect (mesh index, world matrix) instances by walking the scene
    # graph; fall back to every mesh untransformed if there are no scenes
    instances: list[tuple[int, np.ndarray]] = []
    nodes = j.get("nodes", [])

    def walk(ni: int, parent: np.ndarray, depth: int = 0):
        if depth > 256:
            raise ValueError("glTF node graph too deep (cycle?)")
        node = nodes[ni]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            instances.append((node["mesh"], world))
        for ci in node.get("children", []):
            walk(ci, world, depth + 1)

    scenes = j.get("scenes", [])
    if scenes:
        scene = scenes[int(j.get("scene", 0))]
        for ni in scene.get("nodes", []):
            walk(ni, np.eye(4))
    elif nodes:
        # no scene: every root node (one without a parent)
        children = {c for n in nodes for c in n.get("children", [])}
        for ni in range(len(nodes)):
            if ni not in children:
                walk(ni, np.eye(4))
    else:
        instances = [(mi, np.eye(4)) for mi in
                     range(len(j.get("meshes", [])))]

    materials, default_material = _load_materials(doc, stem, load_textures)

    all_pos: list[np.ndarray] = []
    all_nrm: list[np.ndarray] = []
    all_uv: list[np.ndarray] = []
    all_faces: list[np.ndarray] = []
    submeshes: list[SubMesh] = []
    v_off = 0
    f_off = 0
    any_nrm = False
    meshes = j.get("meshes", [])
    for mi, world in instances:
        mesh_j = meshes[mi]
        nmat3 = np.linalg.inv(world[:3, :3]).T if abs(
            np.linalg.det(world[:3, :3])) > 1e-12 else np.eye(3)
        for prim in mesh_j.get("primitives", []):
            attrs = prim.get("attributes", {})
            if "POSITION" not in attrs:
                continue
            pos = doc.accessor(attrs["POSITION"]).astype(np.float64)
            nv = pos.shape[0]
            pos = pos @ world[:3, :3].T + world[:3, 3]
            has_n = "NORMAL" in attrs
            nrm = (doc.accessor(attrs["NORMAL"]) @ nmat3.T if has_n
                   else np.zeros((nv, 3)))
            any_nrm |= has_n
            has_uv = "TEXCOORD_0" in attrs
            uv = (doc.accessor(attrs["TEXCOORD_0"])[:, :2].copy()
                  if has_uv else np.zeros((nv, 2)))
            if has_uv:
                uv[:, 1] = 1.0 - uv[:, 1]       # aiProcess_FlipUVs
            if "indices" in prim:
                idx = doc.accessor(prim["indices"]).reshape(-1)
            else:
                idx = np.arange(nv, dtype=np.int64)
            faces = _triangulate(idx.astype(np.int64),
                                 int(prim.get("mode", 4)))
            if faces.size and (faces.min() < 0 or faces.max() >= nv):
                raise ValueError("glTF indices out of range")
            all_pos.append(pos)
            all_nrm.append(nrm)
            all_uv.append(uv)
            all_faces.append(faces.astype(np.int32) + v_off)
            if "material" in prim:
                mat_i = int(prim["material"])
            else:
                # spec: no material property -> the default material,
                # NOT materials[0]; appended lazily as the last slot
                if not materials or materials[-1] is not default_material:
                    materials.append(default_material)
                mat_i = len(materials) - 1
            submeshes.append(SubMesh(
                name=mesh_j.get("name", f"mesh{mi}"),
                start_index=f_off * 3, index_count=faces.size,
                material_index=mat_i,
                has_normals=has_n, has_texcoords=has_uv))
            v_off += nv
            f_off += faces.shape[0]

    if not all_pos:
        raise ValueError("glTF file contains no triangle geometry")
    positions = np.concatenate(all_pos, axis=0)
    normals = np.concatenate(all_nrm, axis=0)
    uvs = np.concatenate(all_uv, axis=0)
    faces = np.concatenate(all_faces, axis=0)
    if not materials:
        materials = [default_material]        # all prims had bad indices
    for sm in submeshes:
        if not 0 <= sm.material_index < len(materials):
            sm.material_index = 0             # incl. negative (fuzzed) ids

    mesh = Mesh(positions=positions, faces=faces,
                normals=normals if any_nrm else None, uvs=uvs,
                submeshes=submeshes, materials=materials, name=stem)
    mesh.finalize()
    kind = "glb" if data[:4] == b"glTF" else "gltf"
    log.info("Model loaded (%s): %s (vertices: %d, faces: %d, "
             "primitives: %d)", kind, path, mesh.nverts, mesh.nfaces,
             len(submeshes))
    return mesh
