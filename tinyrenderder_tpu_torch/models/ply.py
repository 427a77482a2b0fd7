"""Stanford PLY loader (ascii / binary little- & big-endian).

Counterpart of ``tinyrenderder_tpu/models/ply.py``, line for line.

Second mesh format beside OBJ, demonstrating that the loader abstraction
is not OBJ-shaped: the reference loads any Assimp-supported format with a
fixed postprocess pipeline (model.cpp:91-99); this loader feeds the same
``Mesh`` SoA dataclass and postprocessing (fan triangulation =
aiProcess_Triangulate, V flip = aiProcess_FlipUVs, normal/tangent
generation in ``Mesh.finalize()`` = aiProcess_GenNormals /
CalcTangentSpace).  PLY carries no material libraries, so textures come
from the reference's filename-fallback probe (``<stem>_diffuse.tga`` …,
model.cpp:207-267) exactly like an OBJ without an MTL.

Vertex property names recognized: x/y/z (required), nx/ny/nz (normals),
u/v, s/t or texture_u/texture_v (texcoords).  Faces come from the
``vertex_indices``/``vertex_index`` list property of the ``face``
element.  Binary vertex blocks parse through one structured-numpy view
(no per-vertex Python loop); fixed-arity binary face blocks (the common
all-triangle / all-quad case) take the same vectorized path.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from tinyrenderder_tpu_torch.models.mesh import Material, Mesh, SubMesh
from tinyrenderder_tpu_torch.models.obj import load_material_textures

log = logging.getLogger("tinyrenderder_tpu_torch.ply")

__all__ = ["load_ply"]

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}

_UV_NAMES = {"u": 0, "v": 1, "s": 0, "t": 1, "texture_u": 0, "texture_v": 1}


class _Element:
    def __init__(self, name: str, count: int):
        self.name = name
        self.count = count
        # scalar properties: list of (name, dtype code)
        self.props: list[tuple[str, str]] = []
        # list properties: (name, count dtype, item dtype)
        self.list_props: list[tuple[str, str, str]] = []
        self.order: list[tuple[str, bool]] = []   # (name, is_list)


def _parse_header(f) -> tuple[str, list[_Element]]:
    magic = f.readline()
    if magic.strip() != b"ply":
        raise ValueError("not a PLY file (missing 'ply' magic)")
    fmt = None
    elements: list[_Element] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("truncated PLY header (no end_header)")
        tokens = line.decode("ascii", errors="replace").split()
        if not tokens or tokens[0] == "comment" or tokens[0] == "obj_info":
            continue
        tag = tokens[0]
        if tag == "format":
            fmt = tokens[1]
            if fmt not in ("ascii", "binary_little_endian",
                           "binary_big_endian"):
                raise ValueError(f"unsupported PLY format: {fmt}")
        elif tag == "element":
            elements.append(_Element(tokens[1], int(tokens[2])))
        elif tag == "property":
            if not elements:
                raise ValueError("PLY property before any element")
            el = elements[-1]
            if tokens[1] == "list":
                cnt_t = _PLY_DTYPES.get(tokens[2])
                item_t = _PLY_DTYPES.get(tokens[3])
                if cnt_t is None or item_t is None:
                    raise ValueError(f"unknown PLY list types: {tokens[2]}/"
                                     f"{tokens[3]}")
                el.list_props.append((tokens[4], cnt_t, item_t))
                el.order.append((tokens[4], True))
            else:
                code = _PLY_DTYPES.get(tokens[1])
                if code is None:
                    raise ValueError(f"unknown PLY type: {tokens[1]}")
                el.props.append((tokens[2], code))
                el.order.append((tokens[2], False))
        elif tag == "end_header":
            break
    if fmt is None:
        raise ValueError("PLY header missing 'format' line")
    return fmt, elements


def _read_ascii_element(f, el: _Element):
    """Returns ({prop: (N,) float64}, {list prop: list of int lists})."""
    scalars = {name: np.empty(el.count, np.float64) for name, _ in el.props}
    lists: dict[str, list] = {name: [] for name, _, _ in el.list_props}
    for i in range(el.count):
        tokens = f.readline().split()
        if not tokens:
            raise ValueError(f"truncated PLY data in element {el.name}")
        k = 0
        for name, is_list in el.order:
            if is_list:
                n = int(tokens[k])
                if len(tokens) < k + 1 + n:
                    raise ValueError(
                        f"truncated PLY list row in element {el.name}: "
                        f"{n} entries declared, {len(tokens) - k - 1} "
                        "present")
                lists[name].append([int(float(t))
                                    for t in tokens[k + 1:k + 1 + n]])
                k += 1 + n
            else:
                scalars[name][i] = float(tokens[k])
                k += 1
    return scalars, lists


def _read_binary_element(f, el: _Element, endian: str):
    if not el.list_props:
        dt = np.dtype([(n, endian + c) for n, c in el.props])
        raw = f.read(dt.itemsize * el.count)
        if len(raw) < dt.itemsize * el.count:
            raise ValueError(f"truncated PLY data in element {el.name}")
        arr = np.frombuffer(raw, dtype=dt, count=el.count)
        return ({n: arr[n].astype(np.float64) for n, _ in el.props}, {})
    if len(el.list_props) == 1 and not el.props:
        # common case (face element): sniff the first count byte(s); if all
        # rows share one arity the whole block parses as one structured view
        name, cnt_t, item_t = el.list_props[0]
        if el.count == 0:
            # valid zero-count elements (point clouds declare
            # 'element face 0'): nothing to read — the sniff below
            # would consume the NEXT element's first byte and f.read a
            # negative length
            return ({}, {name: []})
        cdt = np.dtype(endian + cnt_t)
        idt = np.dtype(endian + item_t)
        pos = f.tell()
        head = f.read(cdt.itemsize)
        if len(head) < cdt.itemsize:
            raise ValueError(f"truncated PLY data in element {el.name}")
        arity = int(np.frombuffer(head, cdt, count=1)[0])
        row = cdt.itemsize + arity * idt.itemsize
        raw = head + f.read(row * el.count - cdt.itemsize)
        if len(raw) >= row * el.count:
            dt = np.dtype([("n", endian + cnt_t), ("idx", endian + item_t,
                                                   (arity,))])
            arr = np.frombuffer(raw, dtype=dt, count=el.count)
            # uniform counts AND plausible index values: a mixed-arity
            # block misaligned under the sniffed stride would interpret
            # index bytes as counts — requiring every index word to be
            # non-negative too makes a coincidental misparse vanishingly
            # unlikely (the per-row fallback below is always correct)
            if (arr["n"] == arity).all() and (arr["idx"] >= 0).all():
                return ({}, {name: arr["idx"].astype(np.int64).tolist()})
        f.seek(pos)                      # mixed arity: slow per-row path
        rows = []
        for _ in range(el.count):
            cb = f.read(cdt.itemsize)
            if len(cb) < cdt.itemsize:
                raise ValueError(f"truncated PLY data in element {el.name}")
            n = int(np.frombuffer(cb, cdt, count=1)[0])
            ib = f.read(n * idt.itemsize)
            if len(ib) < n * idt.itemsize:
                raise ValueError(f"truncated PLY data in element {el.name}")
            rows.append(np.frombuffer(ib, idt, count=n).astype(np.int64)
                        .tolist())
        return ({}, {name: rows})
    # general slow path: mixed scalars + lists per row
    scalars = {n: np.empty(el.count, np.float64) for n, _ in el.props}
    lists: dict[str, list] = {n: [] for n, _, _ in el.list_props}
    sdt = {n: np.dtype(endian + c) for n, c in el.props}
    ldt = {n: (np.dtype(endian + c), np.dtype(endian + i))
           for n, c, i in el.list_props}
    for i in range(el.count):
        for name, is_list in el.order:
            if is_list:
                cdt, idt = ldt[name]
                n = int(np.frombuffer(f.read(cdt.itemsize), cdt, count=1)[0])
                buf = f.read(n * idt.itemsize)
                if len(buf) < n * idt.itemsize:
                    raise ValueError(
                        f"truncated PLY data in element {el.name}")
                lists[name].append(
                    np.frombuffer(buf, idt, count=n).astype(np.int64)
                    .tolist())
            else:
                dt = sdt[name]
                buf = f.read(dt.itemsize)
                if len(buf) < dt.itemsize:
                    raise ValueError(
                        f"truncated PLY data in element {el.name}")
                scalars[name][i] = float(np.frombuffer(buf, dt, count=1)[0])
    return scalars, lists


def load_ply(path: str, load_textures: bool = True) -> Mesh:
    """Load a PLY file into a finalized Mesh (same postprocess contract
    as load_obj; texture fallbacks per model.cpp:207-267)."""
    directory = os.path.dirname(os.path.abspath(path))
    stem = os.path.splitext(os.path.basename(path))[0]

    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        data: dict[str, tuple[dict, dict]] = {}
        if fmt == "ascii":
            for el in elements:
                data[el.name] = _read_ascii_element(f, el)
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            for el in elements:
                data[el.name] = _read_binary_element(f, el, endian)

    if "vertex" not in data:
        raise ValueError("PLY file has no vertex element")
    vscalars, _ = data["vertex"]
    for axis in ("x", "y", "z"):
        if axis not in vscalars:
            raise ValueError(f"PLY vertex element missing '{axis}'")
    nv = vscalars["x"].shape[0]
    positions = np.stack([vscalars["x"], vscalars["y"], vscalars["z"]],
                         axis=-1)
    normals = np.zeros((nv, 3), np.float64)
    if all(k in vscalars for k in ("nx", "ny", "nz")):
        normals = np.stack([vscalars["nx"], vscalars["ny"], vscalars["nz"]],
                           axis=-1)
    uvs = np.zeros((nv, 2), np.float64)
    has_uv = False
    for name, col in _UV_NAMES.items():
        if name in vscalars:
            uvs[:, col] = vscalars[name]
            has_uv = True
    if has_uv:
        uvs[:, 1] = 1.0 - uvs[:, 1]      # aiProcess_FlipUVs (model.cpp:93)

    face_rows: list = []
    if "face" in data:
        _, flists = data["face"]
        for key in ("vertex_indices", "vertex_index"):
            if key in flists:
                face_rows = flists[key]
                break

    tris: list[tuple[int, int, int]] = []
    for row in face_rows:
        # fan triangulation (aiProcess_Triangulate), invalid indices
        # dropped per corner like the OBJ loader
        ids = [int(i) for i in row if 0 <= int(i) < nv]
        for k in range(1, len(ids) - 1):
            tris.append((ids[0], ids[k], ids[k + 1]))
    faces = np.array(tris, np.int32).reshape(-1, 3)

    if load_textures:
        materials = [load_material_textures("", {}, directory, stem)]
    else:
        materials = [Material(name="")]
    submeshes = [SubMesh(name=stem, start_index=0,
                         index_count=faces.size, material_index=0,
                         has_texcoords=has_uv,
                         has_normals=bool(np.any(normals)))]
    mesh = Mesh(positions=positions, faces=faces, uvs=uvs, normals=normals,
                submeshes=submeshes, materials=materials, name=stem)
    mesh.finalize()
    log.info("Model loaded (ply/%s): %s (vertices: %d, faces: %d)",
             fmt, path, mesh.nverts, mesh.nfaces)
    return mesh
