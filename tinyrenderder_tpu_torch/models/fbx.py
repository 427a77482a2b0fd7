"""FBX loader (binary 7.x + ascii) — sixth mesh format.

Counterpart of ``tinyrenderder_tpu/models/fbx.py``, line for line.

The reference loads any Assimp-supported format through one fixed
postprocess pipeline (model.cpp:91-99); FBX is Assimp's most common
game-asset interchange format.  This loader parses Kaydara binary FBX
(versions 7000-7700, both the 32-bit record layout and the 64-bit one
introduced in 7500, zlib-deflated arrays) plus the ascii dialect, into
the same node tree, then converts the scene to the shared `Mesh`
contract the other five loaders use:

- polygons fan-triangulate (aiProcess_Triangulate) — vectorized over
  the negative-terminated `PolygonVertexIndex` stream;
- per-corner layer indices (normal/UV with every Mapping x Reference
  combination: ByPolygonVertex / ByVertice / ByPolygon / AllSame,
  Direct / IndexToDirect) dedup to single-index vertices exactly like
  the COLLADA loader (JoinIdenticalVertices analogue);
- UVs flip (aiProcess_FlipUVs, model.cpp:95);
- node transforms bake into the geometry (PreTransformVertices):
  world = parent ... * T * Rpre * R * Rpost^-1 * S per model, with the
  leaf-only geometric transform Gt * Gr * Gs; rotations are Euler
  degrees in the node's RotationOrder (orders 0-5).  Pivot/offset
  properties are assumed zero (the common exporter case) — files using
  them load with those terms ignored;
- `LayerElementMaterial` splits triangles into per-material submeshes
  (stable submission order within each);
- textures resolve through Connections (Texture --OP--> Material by
  property name, embedded Video content or RelativeFilename on disk)
  with the reference's filename-probe fallback for absent maps
  (model.cpp:207-267);
- `Mesh.finalize()` regenerates missing normals/tangents
  (aiProcess_GenNormals / CalcTangentSpace, model.cpp:269-388).

UnitScaleFactor / axis GlobalSettings are not applied (Assimp's FBX
importer also leaves unit conversion to an opt-in flag).
"""

from __future__ import annotations

import io
import logging
import os
import re
import struct
import zlib

import numpy as np

from tinyrenderder_tpu_torch.models.collada import _triangulate_rows
from tinyrenderder_tpu_torch.models.mesh import (Material, Mesh, SubMesh,
                                                 dedup_rows_stable)
from tinyrenderder_tpu_torch.models.obj import (_try_read_texture,
                                                load_material_textures)

log = logging.getLogger("tinyrenderder_tpu_torch.fbx")

__all__ = ["load_fbx"]

_MAGIC = b"Kaydara FBX Binary  \x00"


class _Node:
    """One FBX record: name, property list, nested records."""

    __slots__ = ("name", "props", "children")

    def __init__(self, name: str, props: list):
        self.name = name
        self.props = props
        self.children: list[_Node] = []

    def child(self, name: str) -> "_Node | None":
        for c in self.children:
            if c.name == name:
                return c
        return None

    def all(self, name: str) -> "list[_Node]":
        return [c for c in self.children if c.name == name]


# ---------------------------------------------------------------- binary

_SCALAR = {
    ord("Y"): ("<h", 2), ord("C"): ("<b", 1), ord("I"): ("<i", 4),
    ord("F"): ("<f", 4), ord("D"): ("<d", 8), ord("L"): ("<q", 8),
}
_ARRAY = {
    ord("f"): np.dtype("<f4"), ord("d"): np.dtype("<f8"),
    ord("l"): np.dtype("<i8"), ord("i"): np.dtype("<i4"),
    ord("b"): np.dtype("<i1"),
}


def _read_props(data: bytes, pos: int, count: int) -> tuple[list, int]:
    props: list = []
    for _ in range(count):
        if pos >= len(data):
            raise ValueError("FBX property list truncated")
        t = data[pos]
        pos += 1
        if t in _SCALAR:
            fmt, size = _SCALAR[t]
            if pos + size > len(data):
                raise ValueError("FBX scalar property truncated")
            (v,) = struct.unpack_from(fmt, data, pos)
            props.append(bool(v) if t == ord("C") else v)
            pos += size
        elif t in _ARRAY:
            if pos + 12 > len(data):
                raise ValueError("FBX array property truncated")
            n, enc, clen = struct.unpack_from("<III", data, pos)
            pos += 12
            dt = _ARRAY[t]
            if enc == 0:
                clen = n * dt.itemsize
            if pos + clen > len(data):
                raise ValueError("FBX array payload truncated")
            raw = data[pos:pos + clen]
            pos += clen
            if enc == 1:
                try:
                    raw = zlib.decompress(raw)
                except zlib.error as e:
                    raise ValueError(f"bad FBX deflate stream: {e}") from e
            elif enc != 0:
                raise ValueError(f"unknown FBX array encoding {enc}")
            if len(raw) < n * dt.itemsize:
                raise ValueError("FBX array shorter than declared")
            props.append(np.frombuffer(raw, dt, count=n).copy())
        elif t in (ord("S"), ord("R")):
            if pos + 4 > len(data):
                raise ValueError("FBX string property truncated")
            (n,) = struct.unpack_from("<I", data, pos)
            pos += 4
            if pos + n > len(data):
                raise ValueError("FBX string payload truncated")
            raw = data[pos:pos + n]
            pos += n
            # binary strings store "Name\x00\x01Class"; normalize to the
            # ascii dialect's "Class::Name" form
            if t == ord("S"):
                s = raw.decode("latin1")
                if "\x00\x01" in s:
                    nm, cls = s.split("\x00\x01", 1)
                    s = f"{cls}::{nm}"
                props.append(s)
            else:
                props.append(raw)
        else:
            raise ValueError(f"unknown FBX property type {t:#x}")
    return props, pos


_MAX_DEPTH = 256


def _read_node(data: bytes, pos: int, big: bool,
               depth: int = 0) -> tuple["_Node | None", int]:
    if depth > _MAX_DEPTH:
        raise ValueError("FBX node nesting exceeds maximum depth")
    if big:
        if pos + 24 > len(data):
            raise ValueError("FBX node header truncated")
        end, nprops, _plen = struct.unpack_from("<QQQ", data, pos)
        pos += 24
    else:
        if pos + 12 > len(data):
            raise ValueError("FBX node header truncated")
        end, nprops, _plen = struct.unpack_from("<III", data, pos)
        pos += 12
    if pos >= len(data):
        raise ValueError("FBX node name truncated")
    nl = data[pos]
    pos += 1
    name = data[pos:pos + nl].decode("latin1")
    pos += nl
    if end == 0:                              # null record = list terminator
        return None, pos
    if end < pos or end > len(data):
        raise ValueError("FBX node end offset out of range")
    if nprops > len(data):
        raise ValueError("FBX node property count out of range")
    props, pos = _read_props(data, pos, int(nprops))
    node = _Node(name, props)
    while pos < end:
        child, pos = _read_node(data, pos, big, depth + 1)
        if child is None:
            break
        node.children.append(child)
    return node, end


def _parse_binary(data: bytes) -> tuple[_Node, int]:
    if len(data) < 27:
        raise ValueError("FBX binary truncated before header")
    (version,) = struct.unpack_from("<I", data, 23)
    big = version >= 7500
    root = _Node("", [])
    pos = 27
    # top-level record list runs to the footer; a zeroed header = end
    while pos + (25 if big else 13) <= len(data):
        node, pos = _read_node(data, pos, big)
        if node is None:
            break
        root.children.append(node)
    return root, version


# ----------------------------------------------------------------- ascii

_NUM_RE = re.compile(r"^[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?)$")


def _tokenize_ascii(text: str) -> list:
    """Tokens: ('name', str) | ('val', value) | '{' | '}'."""
    toks: list = []
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in " \t\r\n,":
            i += 1
        elif c == ";":
            j = text.find("\n", i)
            i = n if j < 0 else j + 1
        elif c == '"':
            j = text.find('"', i + 1)
            if j < 0:
                raise ValueError("unterminated FBX ascii string")
            toks.append(("val", text[i + 1:j]))
            i = j + 1
        elif c in "{}":
            toks.append(c)
            i += 1
        else:
            j = i
            while j < n and text[j] not in ' \t\r\n,{};"':
                j += 1
            atom = text[i:j]
            i = j
            if atom.endswith(":"):
                toks.append(("name", atom[:-1]))
            elif atom.startswith("*") and atom[1:].isdigit():
                pass                          # array length hint — redundant
            elif _NUM_RE.match(atom):
                v = float(atom)
                toks.append(("val", int(atom) if re.match(
                    r"^[+-]?\d+$", atom) else v))
            else:
                toks.append(("val", atom))    # bare enum word (T, W, A, ...)
    return toks


def _parse_ascii_nodes(toks: list, i: int,
                       depth: int = 0) -> tuple[list[_Node], int]:
    if depth > _MAX_DEPTH:
        raise ValueError("FBX ascii nesting exceeds maximum depth")
    nodes: list[_Node] = []
    n = len(toks)
    while i < n:
        tok = toks[i]
        if tok == "}":
            return nodes, i + 1
        if not (isinstance(tok, tuple) and tok[0] == "name"):
            raise ValueError(f"unexpected FBX ascii token {tok!r}")
        node = _Node(tok[1], [])
        i += 1
        while i < n and isinstance(toks[i], tuple) and toks[i][0] == "val":
            node.props.append(toks[i][1])
            i += 1
        if i < n and toks[i] == "{":
            node.children, i = _parse_ascii_nodes(toks, i + 1, depth + 1)
        # fold the `a:` numeric child back into an array property
        a = node.child("a")
        if a is not None and len(node.children) == 1:
            vals = a.props
            if all(isinstance(v, int) for v in vals):
                node.props = [np.asarray(vals, np.int64)]
            else:
                node.props = [np.asarray(vals, np.float64)]
            node.children = []
        nodes.append(node)
    return nodes, i


def _parse_ascii(text: str) -> tuple[_Node, int]:
    root = _Node("", [])
    root.children, _ = _parse_ascii_nodes(_tokenize_ascii(text), 0)
    hdr = root.child("FBXHeaderExtension")
    ver = hdr.child("FBXVersion") if hdr else None
    version = int(ver.props[0]) if ver and ver.props else 7400
    return root, version


# ------------------------------------------------------------ scene graph

def _props70(node: _Node) -> dict[str, list]:
    out: dict[str, list] = {}
    p70 = node.child("Properties70") or node.child("Properties60")
    for p in (p70.children if p70 is not None else []):
        if p.name == "P" and p.props:
            out[str(p.props[0])] = p.props[4:]
    return out


def _vec3(props: dict, key: str, default=(0.0, 0.0, 0.0)) -> np.ndarray:
    v = props.get(key)
    if not v or len(v) < 3:
        return np.asarray(default, np.float64)
    return np.asarray([float(v[0]), float(v[1]), float(v[2])], np.float64)


def _euler_matrix(deg: np.ndarray, order: int) -> np.ndarray:
    cx, cy, cz = np.cos(np.radians(deg))
    sx, sy, sz = np.sin(np.radians(deg))
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    axes = {"X": rx, "Y": ry, "Z": rz}
    names = ["XYZ", "XZY", "YZX", "YXZ", "ZXY", "ZYX"][
        order if 0 <= order <= 5 else 0]
    # order "ABC" applies A first: M = Rc @ Rb @ Ra (column vectors)
    return axes[names[2]] @ axes[names[1]] @ axes[names[0]]


def _mat4(lin: np.ndarray, trans: np.ndarray) -> np.ndarray:
    m = np.eye(4)
    m[:3, :3] = lin
    m[:3, 3] = trans
    return m


def _local_matrix(props: dict) -> np.ndarray:
    t = _vec3(props, "Lcl Translation")
    r = _vec3(props, "Lcl Rotation")
    s = _vec3(props, "Lcl Scaling", (1.0, 1.0, 1.0))
    pre = _vec3(props, "PreRotation")
    post = _vec3(props, "PostRotation")
    order_p = props.get("RotationOrder")
    order = (int(order_p[0]) if order_p and isinstance(
        order_p[0], (int, float, np.integer)) else 0)
    lin = (_euler_matrix(pre, 0) @ _euler_matrix(r, order)
           @ _euler_matrix(post, 0).T @ np.diag(s))
    return _mat4(lin, t)


def _geometric_matrix(props: dict) -> np.ndarray:
    t = _vec3(props, "GeometricTranslation")
    r = _vec3(props, "GeometricRotation")
    s = _vec3(props, "GeometricScaling", (1.0, 1.0, 1.0))
    return _mat4(_euler_matrix(r, 0) @ np.diag(s), t)


def _obj_name(node: _Node) -> str:
    for p in node.props:
        if isinstance(p, str):
            return p.split("::", 1)[-1]
    return ""


def _obj_id(node: _Node) -> int:
    return int(node.props[0]) if node.props and isinstance(
        node.props[0], (int, float)) else 0


# --------------------------------------------------------------- geometry

_REF_DIRECT = "Direct"


def _layer_corner_index(gnode: _Node, elname: str, dataname: str,
                        idxname: str, corner_vid: np.ndarray,
                        poly_of_corner: np.ndarray,
                        width: int) -> tuple[np.ndarray, np.ndarray] | None:
    """(data (D, width) f64, per-corner index into data) or None."""
    el = gnode.child(elname)
    if el is None:
        return None
    dat = el.child(dataname)
    if dat is None or not dat.props:
        return None
    flat = np.asarray(dat.props[0], np.float64)
    if flat.size % width:
        flat = flat[: flat.size - flat.size % width]
    data = flat.reshape(-1, width)
    if data.shape[0] == 0:
        return None
    m_el = el.child("MappingInformationType")
    mapping = str(m_el.props[0]) if m_el and m_el.props else "ByPolygonVertex"
    r_el = el.child("ReferenceInformationType")
    ref = str(r_el.props[0]) if r_el and r_el.props else _REF_DIRECT
    n_corners = corner_vid.shape[0]
    if mapping == "ByPolygonVertex":
        idx = np.arange(n_corners, dtype=np.int64)
    elif mapping in ("ByVertice", "ByVertex"):
        idx = corner_vid.astype(np.int64)
    elif mapping == "ByPolygon":
        idx = poly_of_corner.astype(np.int64)
    elif mapping == "AllSame":
        idx = np.zeros(n_corners, np.int64)
    else:
        raise ValueError(f"unsupported FBX {elname} mapping {mapping!r}")
    if ref != _REF_DIRECT:
        ix_el = el.child(idxname)
        if ix_el is not None and ix_el.props:
            table = np.asarray(ix_el.props[0], np.int64)
            if idx.size and (idx.max() >= table.shape[0]):
                raise ValueError(f"FBX {idxname} shorter than mapping")
            idx = table[idx]
    # exporters write -1 for "no value" corners; clamp to slot 0
    idx = np.where(idx < 0, 0, idx)
    if idx.size and idx.max() >= data.shape[0]:
        raise ValueError(f"FBX {elname} index out of range")
    return data, idx


def _geometry_arrays(gnode: _Node):
    """Decode one Geometry node.

    Returns (positions (V,3), corner_vid (C,), tri_corners (T,3),
    normals per-corner index or None, uv per-corner index or None,
    per-triangle material slot (T,)) — all vectorized.
    """
    v_el = gnode.child("Vertices")
    i_el = gnode.child("PolygonVertexIndex")
    if v_el is None or not v_el.props or i_el is None or not i_el.props:
        return None
    flat = np.asarray(v_el.props[0], np.float64)
    positions = flat[: flat.size - flat.size % 3].reshape(-1, 3)
    pvi = np.asarray(i_el.props[0], np.int64)
    if pvi.size == 0 or positions.shape[0] == 0:
        return None
    corner_vid = np.where(pvi < 0, -pvi - 1, pvi)
    if corner_vid.min() < 0 or corner_vid.max() >= positions.shape[0]:
        raise ValueError("FBX PolygonVertexIndex out of range")
    ends = np.nonzero(pvi < 0)[0]
    if ends.size == 0 or ends[-1] != pvi.size - 1:
        # tolerate a missing final terminator (seen in the wild)
        ends = np.append(ends, pvi.size - 1)
    starts = np.concatenate([[0], ends[:-1] + 1])
    vcounts = ends - starts + 1
    # per-ORIGINAL-polygon corner ownership: ByPolygon layer arrays and
    # LayerElementMaterial index the file's polygon list, so degenerate
    # (<3 corner) polygons must keep their slots even though they emit
    # no triangles
    poly_of_corner = np.zeros(pvi.size, np.int64)
    poly_of_corner[starts[1:]] = 1
    poly_of_corner = np.cumsum(poly_of_corner)
    n_polys = starts.shape[0]

    keep = vcounts >= 3
    kept = np.nonzero(keep)[0]                  # original polygon ids
    starts_k, vcounts_k = starts[keep], vcounts[keep]
    if starts_k.size == 0:
        return None
    # fan triangulation over the corner stream (aiProcess_Triangulate):
    # reuse the COLLADA loader's vectorized row expansion
    rel = _triangulate_rows(vcounts_k)          # offsets into kept stream
    poly_of_tri_k = np.repeat(np.arange(starts_k.shape[0]), vcounts_k - 2)
    poly_of_tri = kept[poly_of_tri_k]           # original polygon ids
    tri_corners = rel + (starts_k[poly_of_tri_k] - np.repeat(
        np.concatenate([[0], np.cumsum(vcounts_k)[:-1]]),
        vcounts_k - 2))[:, None]

    nrm = _layer_corner_index(gnode, "LayerElementNormal", "Normals",
                              "NormalsIndex", corner_vid, poly_of_corner, 3)
    uv = _layer_corner_index(gnode, "LayerElementUV", "UV", "UVIndex",
                             corner_vid, poly_of_corner, 2)

    tri_mat = np.zeros(tri_corners.shape[0], np.int64)
    mat_el = gnode.child("LayerElementMaterial")
    if mat_el is not None:
        ids_el = mat_el.child("Materials")
        m_el = mat_el.child("MappingInformationType")
        mapping = str(m_el.props[0]) if m_el and m_el.props else "AllSame"
        if ids_el is not None and ids_el.props and mapping == "ByPolygon":
            ids = np.asarray(ids_el.props[0], np.int64)
            if ids.shape[0] >= n_polys:
                tri_mat = ids[:n_polys][poly_of_tri]
    return positions, corner_vid, tri_corners, nrm, uv, tri_mat


# --------------------------------------------------------------- textures

_TEX_SLOT = {
    "DiffuseColor": "diffuse", "TransparentColor": None, "Bump": "normal",
    "NormalMap": "normal", "SpecularColor": "specular",
    "ShininessExponent": None, "EmissiveColor": "emission",
}


def _decode_embedded(raw: bytes) -> np.ndarray | None:
    try:
        from PIL import Image
        with Image.open(io.BytesIO(raw)) as im:
            if im.mode not in ("RGB", "RGBA", "L"):
                im = im.convert("RGBA" if "A" in im.mode else "RGB")
            arr = np.asarray(im)
        if arr.ndim == 2:
            arr = np.repeat(arr[..., None], 3, axis=-1)
        return np.ascontiguousarray(arr, np.uint8)
    except Exception as e:                                # noqa: BLE001
        log.warning("Failed to decode embedded FBX texture: %s", e)
        return None


def _texture_image(tex_node: _Node, videos: dict[int, _Node],
                   oo_parents: dict[int, list[int]],
                   directory: str) -> np.ndarray | None:
    # embedded payload takes priority (Video --OO--> Texture)
    tid = _obj_id(tex_node)
    for vid_id, parents in oo_parents.items():
        if tid in parents and vid_id in videos:
            content = videos[vid_id].child("Content")
            if content is not None and content.props and \
                    isinstance(content.props[0], (bytes, bytearray)):
                img = _decode_embedded(bytes(content.props[0]))
                if img is not None:
                    return img
    for key in ("RelativeFilename", "FileName", "Filename"):
        fn_el = tex_node.child(key)
        if fn_el is not None and fn_el.props and isinstance(
                fn_el.props[0], str) and fn_el.props[0]:
            rel = fn_el.props[0].replace("\\", "/")
            img = _try_read_texture(os.path.join(directory,
                                                 os.path.basename(rel)))
            if img is None:
                img = _try_read_texture(os.path.join(directory, rel))
            if img is not None:
                return img
    return None


# ------------------------------------------------------------------ load

def load_fbx(path: str, load_textures: bool = True) -> Mesh:
    """Load a binary or ascii FBX file into a finalized Mesh (same
    postprocess contract as the other five loaders)."""
    directory = os.path.dirname(os.path.abspath(path))
    stem = os.path.splitext(os.path.basename(path))[0]
    with open(path, "rb") as f:
        data = f.read()

    if data[:len(_MAGIC)] == _MAGIC:
        root, version = _parse_binary(data)
        kind = "fbx/binary"
    else:
        text = data.decode("utf-8", errors="replace")
        if "FBX" not in text[:4096] and ":" not in text[:4096]:
            raise ValueError("not an FBX file (no binary magic, no ascii "
                             "header)")
        root, version = _parse_ascii(text)
        kind = "fbx/ascii"

    objects = root.child("Objects")
    if objects is None:
        raise ValueError("FBX file has no Objects section")

    geoms: dict[int, _Node] = {}
    models: dict[int, _Node] = {}
    mats: dict[int, _Node] = {}
    texs: dict[int, _Node] = {}
    videos: dict[int, _Node] = {}
    for node in objects.children:
        oid = _obj_id(node)
        if node.name == "Geometry":
            geoms[oid] = node
        elif node.name == "Model":
            models[oid] = node
        elif node.name == "Material":
            mats[oid] = node
        elif node.name == "Texture":
            texs[oid] = node
        elif node.name == "Video":
            videos[oid] = node

    # connections: child -> parents (OO) and (child, parent, prop) (OP)
    oo_parents: dict[int, list[int]] = {}
    op_links: list[tuple[int, int, str]] = []
    conns = root.child("Connections")
    for c in (conns.children if conns is not None else []):
        if c.name != "C" or len(c.props) < 3:
            continue
        mode = str(c.props[0])
        try:
            src, dst = int(c.props[1]), int(c.props[2])
        except (TypeError, ValueError):
            continue
        if mode == "OO":
            oo_parents.setdefault(src, []).append(dst)
        elif mode == "OP" and len(c.props) >= 4:
            op_links.append((src, dst, str(c.props[3])))

    model_parent: dict[int, int] = {}
    model_geoms: dict[int, list[int]] = {}
    model_mats: dict[int, list[int]] = {}
    for src, parents in oo_parents.items():
        for dst in parents:
            if src in models and (dst in models or dst == 0):
                model_parent.setdefault(src, dst)
            elif src in geoms and dst in models:
                model_geoms.setdefault(dst, []).append(src)
            elif src in mats and dst in models:
                model_mats.setdefault(dst, []).append(src)

    def world_of(mid: int) -> np.ndarray:
        m = np.eye(4)
        seen = set()
        cur = mid
        while cur in models and cur not in seen:
            seen.add(cur)
            m = _local_matrix(_props70(models[cur])) @ m
            cur = model_parent.get(cur, 0)
        return m

    # instances = every (model, geometry) attachment; geometries not
    # attached to any model render untransformed
    instances: list[tuple[int, int | None]] = []
    for mid in models:
        for gid in model_geoms.get(mid, []):
            instances.append((gid, mid))
    attached = {gid for gid, _ in instances}
    instances.extend((gid, None) for gid in geoms if gid not in attached)

    mat_order: list[int] = []             # FBX material object ids, first use
    mat_slot: dict[int, int] = {}
    all_pos, all_nrm, all_uv, all_faces = [], [], [], []
    submeshes: list[SubMesh] = []
    v_off = f_off = 0
    any_nrm = False
    for gid, mid in instances:
        decoded = _geometry_arrays(geoms[gid])
        if decoded is None:
            continue
        positions, corner_vid, tri_corners, nrm, uv, tri_mat = decoded
        if mid is not None:
            mprops = _props70(models[mid])
            world = world_of(mid) @ _geometric_matrix(mprops)
        else:
            world = np.eye(4)
        lin = world[:3, :3]
        nmat = (np.linalg.inv(lin).T
                if abs(np.linalg.det(lin)) > 1e-12 else np.eye(3))

        # per-corner (vid, nidx, uvidx) rows -> deduped single-index verts
        cols = [corner_vid]
        if nrm is not None:
            cols.append(nrm[1])
        if uv is not None:
            cols.append(uv[1])
        uniq, corner_id = dedup_rows_stable(np.stack(cols, axis=1))
        nv = uniq.shape[0]
        pos = positions[uniq[:, 0]] @ lin.T + world[:3, 3]
        col = 1
        if nrm is not None:
            nrm_v = nrm[0][uniq[:, col]][:, :3] @ nmat.T
            col += 1
            any_nrm = True
        else:
            nrm_v = np.zeros((nv, 3))
        if uv is not None:
            uv_v = uv[0][uniq[:, col]][:, :2].copy()
            uv_v[:, 1] = 1.0 - uv_v[:, 1]        # aiProcess_FlipUVs
        else:
            uv_v = np.zeros((nv, 2))

        faces = corner_id[tri_corners].astype(np.int32)
        model_mat_ids = model_mats.get(mid, []) if mid is not None else []
        name = _obj_name(models[mid]) if mid is not None else \
            _obj_name(geoms[gid]) or stem

        # split into per-material submeshes (stable within each slot)
        slots = np.unique(tri_mat)
        for slot in slots:
            sel = tri_mat == slot
            sub_faces = faces[sel]
            if sub_faces.size == 0:
                continue
            # negative slots (exporters write -1 for unassigned faces)
            # and out-of-range slots fall back: first material if the
            # model has one, else the probe/default (-1 sentinel)
            mat_obj = (model_mat_ids[int(slot)]
                       if 0 <= int(slot) < len(model_mat_ids) else
                       (model_mat_ids[0] if model_mat_ids else -1))
            if mat_obj not in mat_slot:
                mat_slot[mat_obj] = len(mat_order)
                mat_order.append(mat_obj)
            all_faces.append(sub_faces + v_off)
            submeshes.append(SubMesh(
                name=name or f"model{gid}",
                start_index=f_off * 3, index_count=sub_faces.size,
                material_index=mat_slot[mat_obj],
                has_normals=nrm is not None, has_texcoords=uv is not None))
            f_off += sub_faces.shape[0]
        all_pos.append(pos)
        all_nrm.append(nrm_v)
        all_uv.append(uv_v)
        v_off += nv

    if not all_faces:
        raise ValueError("FBX file contains no triangle geometry")

    # materials: Connections-resolved textures with filename-probe
    # fallback (model.cpp:207-267), like the other loaders
    materials: list[Material] = []
    if load_textures:
        probe = load_material_textures("", {}, directory, stem)
    else:
        probe = Material(name="")
    tex_cache: dict[int, np.ndarray | None] = {}
    for mat_obj in mat_order:
        mnode = mats.get(mat_obj)
        name = _obj_name(mnode) if mnode is not None else ""
        maps: dict[str, np.ndarray] = {}
        if load_textures and mnode is not None:
            for src, dst, prop in op_links:
                slot = _TEX_SLOT.get(prop)
                if dst == mat_obj and src in texs and slot and \
                        slot not in maps:
                    if src not in tex_cache:      # shared textures: decode once
                        tex_cache[src] = _texture_image(
                            texs[src], videos, oo_parents, directory)
                    if tex_cache[src] is not None:
                        maps[slot] = tex_cache[src]
        materials.append(Material(
            name=name,
            diffuse=maps.get("diffuse", probe.diffuse),
            normal=maps.get("normal", probe.normal),
            specular=maps.get("specular", probe.specular),
            emission=maps.get("emission", probe.emission)))
    if not materials:
        materials = [probe]

    mesh = Mesh(positions=np.concatenate(all_pos),
                faces=np.concatenate(all_faces),
                normals=np.concatenate(all_nrm) if any_nrm else None,
                uvs=np.concatenate(all_uv),
                submeshes=submeshes, materials=materials, name=stem)
    mesh.finalize()
    log.info("Model loaded (%s v%d): %s (vertices: %d, faces: %d, "
             "submeshes: %d)", kind, version, path, mesh.nverts,
             mesh.nfaces, len(submeshes))
    return mesh
