"""Wavefront OBJ/MTL loader, the Assimp replacement.

Counterpart of the pure-Python path of ``tinyrenderder_tpu/models/obj.py``.
The reference loads models through Assimp with the flags of
model.cpp:91-99; this loader implements the subset its OBJ scenes need:

  * polygon faces are fan-triangulated (aiProcess_Triangulate)
  * V texture coordinates are flipped: v' = 1 - v (aiProcess_FlipUVs)
  * one vertex per unique (position, uv, normal) index triple
    (aiProcess_JoinIdenticalVertices)
  * missing normals / tangents are generated by Mesh.finalize()
  * per-material textures with the reference's fallback names
    ``<stem>_diffuse.tga`` / ``_nm.tga`` / ``_spec.tga`` / ``_emission.tga``
    (model.cpp:207-267); only TGA payloads parse, as in the reference.

The tokenizing loop goes through the C++ tokenizer of ``native/``
(``utils/native.py``) when it builds, as the JAX package's does
(``models/obj.py:146-151``); the Python loop is the plain version, with
the same meshes.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from tinyrenderder_tpu_torch.models.mesh import Material, Mesh, SubMesh
from tinyrenderder_tpu_torch.utils import native, tga

log = logging.getLogger("tinyrenderder_tpu_torch.obj")

__all__ = ["load_obj", "load_mtl", "load_material_textures"]


def _try_read_texture(path: str) -> np.ndarray | None:
    """Read a texture through the TGA codec -> RGB[A] uint8, or None.  A
    path without an extension probes .tga/.png/.jpg/.bmp, all through
    the TGA reader (model.cpp:236-249)."""
    candidates = [path]
    if "." not in os.path.basename(path):
        candidates = [path + ext for ext in (".tga", ".png", ".jpg", ".bmp")]
    for cand in candidates:
        try:
            img = tga.read(cand)
        except (OSError, ValueError):
            continue
        return img.to_rgb()
    return None


def _mtllib_paths(rest: str, directory: str) -> list[str]:
    """A ``mtllib`` line's payload: one file name with spaces if it names
    an existing file, else whitespace-separated names."""
    rest = rest.strip()
    if not rest:
        return []
    if os.path.exists(os.path.join(directory, rest.replace("\\", "/"))):
        return [rest]
    return rest.split()


def load_mtl(path: str) -> dict[str, dict[str, str]]:
    """Parse a .mtl file into {material_name: {map kind: relative path}}:
    map_Kd -> diffuse, map_Bump/bump/norm/map_Kn -> normal, map_Ks ->
    specular, map_Ke -> emission."""
    mats: dict[str, dict[str, str]] = {}
    cur: dict[str, str] | None = None
    try:
        with open(path, "r", errors="replace") as f:
            lines = f.readlines()
    except OSError:
        return mats
    for line in lines:
        tokens = line.split()
        if not tokens or tokens[0].startswith("#"):
            continue
        key = tokens[0].lower()
        if key == "newmtl" and len(tokens) > 1:
            cur = mats.setdefault(tokens[1], {})
        elif cur is not None and len(tokens) > 1:
            tex = tokens[-1]             # the path is last (skips -options)
            if key == "map_kd":
                cur.setdefault("diffuse", tex)
            elif key in ("map_bump", "bump", "norm", "map_kn"):
                cur.setdefault("normal", tex)
            elif key == "map_ks":
                cur.setdefault("specular", tex)
            elif key == "map_ke":
                cur.setdefault("emission", tex)
    return mats


def load_material_textures(name: str, maps: dict[str, str],
                           directory: str, model_stem: str) -> Material:
    """The four maps of one material with the reference's fallback names
    (model.cpp:207-267)."""
    fallbacks = {
        "diffuse": "_diffuse.tga",
        "normal": "_nm.tga",
        "specular": "_spec.tga",
        "emission": "_emission.tga",
    }
    loaded: dict[str, np.ndarray | None] = {}
    for kind, suffix in fallbacks.items():
        img = None
        rel = maps.get(kind)
        if rel is not None:
            img = _try_read_texture(os.path.join(directory, rel.replace("\\", "/")))
            if img is None:
                log.warning("Failed to load texture: %s", rel)
        if img is None:
            img = _try_read_texture(os.path.join(directory, model_stem + suffix))
        loaded[kind] = img
        if img is not None:
            log.info("  Loaded %s texture for material %s (%dx%d)",
                     kind, name or "<default>", img.shape[1], img.shape[0])
    return Material(name=name, diffuse=loaded["diffuse"], normal=loaded["normal"],
                    specular=loaded["specular"], emission=loaded["emission"])


def _materials(material_names: list[str], mtl_maps: dict, load_textures: bool,
               directory: str, stem: str) -> list[Material]:
    if not material_names:
        material_names = [""]
    if load_textures:
        return [load_material_textures(name, mtl_maps.get(name, {}), directory, stem)
                for name in material_names]
    return [Material(name=n) for n in material_names]


def _load_obj_native(path: str, load_textures: bool, directory: str, stem: str) -> Mesh:
    parsed = native.parse_obj(os.path.abspath(path), stem)
    if parsed is None:
        raise OSError(f"cannot open OBJ: {path}")
    (pos, uv, nrm, faces, sub_table, material_names, group_names, mtllibs, any_uv,
     any_norm) = parsed
    submeshes = [SubMesh(name=group_names[i] if i < len(group_names) else stem,
                         start_index=int(sub_table[i, 0]), index_count=int(sub_table[i, 1]),
                         material_index=int(sub_table[i, 2]), has_texcoords=any_uv,
                         has_normals=any_norm)
                 for i in range(sub_table.shape[0])]
    mtl_maps: dict[str, dict[str, str]] = {}
    for raw in mtllibs:
        for rel in _mtllib_paths(raw, directory):
            mtl_maps.update(load_mtl(os.path.join(directory, rel)))
    mesh = Mesh(positions=pos, faces=faces, uvs=uv, normals=nrm, submeshes=submeshes,
                materials=_materials(material_names, mtl_maps, load_textures, directory,
                                     stem),
                name=stem)
    mesh.finalize()
    log.info("Model loaded (native): %s (vertices: %d, faces: %d, submeshes: %d, "
             "materials: %d)", path, mesh.nverts, mesh.nfaces, len(mesh.submeshes),
             len(mesh.materials))
    return mesh


def load_obj(path: str, load_textures: bool = True, use_native: bool | None = None) -> Mesh:
    """Load an OBJ file into a finalized Mesh.  ``use_native=None`` takes
    the C++ tokenizer when it builds (the same mesh as the Python path)."""
    directory = os.path.dirname(os.path.abspath(path))
    stem = os.path.splitext(os.path.basename(path))[0]
    if use_native is None:
        use_native = native.available()
    if use_native:
        return _load_obj_native(path, load_textures, directory, stem)

    positions: list[tuple[float, float, float]] = []
    texcoords: list[tuple[float, float]] = []
    normals: list[tuple[float, float, float]] = []

    # output SoA buffers, one vertex per unique (vi, ti, ni)
    vertex_key_to_id: dict[tuple[int, int, int], int] = {}
    out_pos: list = []
    out_uv: list = []
    out_norm: list = []
    face_indices: list[int] = []

    mtl_maps: dict[str, dict[str, str]] = {}
    material_names: list[str] = []
    material_ids: dict[str, int] = {}
    submeshes: list[SubMesh] = []
    cur_material = 0
    cur_group = stem
    any_uv = False
    any_norm = False

    def get_material_id(name: str) -> int:
        if name not in material_ids:
            material_ids[name] = len(material_names)
            material_names.append(name)
        return material_ids[name]

    def close_submesh():
        if submeshes and submeshes[-1].index_count == 0:
            submeshes.pop()

    def open_submesh():
        close_submesh()
        submeshes.append(SubMesh(name=cur_group, start_index=len(face_indices),
                                 index_count=0, material_index=cur_material))

    def resolve(idx: int, count: int) -> int:
        # OBJ indices are 1-based; negatives are relative to current end
        return idx - 1 if idx > 0 else count + idx

    def vertex_id(vi: int, ti: int, ni: int) -> int:
        key = (vi, ti, ni)
        vid = vertex_key_to_id.get(key)
        if vid is None:
            vid = len(out_pos)
            vertex_key_to_id[key] = vid
            out_pos.append(positions[vi])
            out_uv.append(texcoords[ti] if ti >= 0 else (0.0, 0.0))
            out_norm.append(normals[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        return vid

    open_submesh()
    with open(path, "r", errors="replace") as f:
        for line in f:
            tokens = line.split()
            if not tokens or tokens[0].startswith("#"):
                continue
            tag = tokens[0]
            if tag == "v":
                positions.append((float(tokens[1]), float(tokens[2]), float(tokens[3])))
            elif tag == "vt":
                u = float(tokens[1])
                v = float(tokens[2]) if len(tokens) > 2 else 0.0
                texcoords.append((u, 1.0 - v))  # aiProcess_FlipUVs (model.cpp:93)
            elif tag == "vn":
                normals.append((float(tokens[1]), float(tokens[2]), float(tokens[3])))
            elif tag == "f":
                corner_ids = []
                for corner in tokens[1:]:
                    parts = corner.split("/")
                    vi = resolve(int(parts[0]), len(positions))
                    ti = -1
                    ni = -1
                    if len(parts) > 1 and parts[1]:
                        ti = resolve(int(parts[1]), len(texcoords))
                        any_uv = True
                    if len(parts) > 2 and parts[2]:
                        ni = resolve(int(parts[2]), len(normals))
                        any_norm = True
                    # an invalid position index drops the corner; invalid
                    # uv/normal indices count as missing
                    if vi < 0 or vi >= len(positions):
                        continue
                    if ti < 0 or ti >= len(texcoords):
                        ti = -1
                    if ni < 0 or ni >= len(normals):
                        ni = -1
                    corner_ids.append(vertex_id(vi, ti, ni))
                # fan triangulation (aiProcess_Triangulate)
                for k in range(1, len(corner_ids) - 1):
                    face_indices.extend((corner_ids[0], corner_ids[k], corner_ids[k + 1]))
                    submeshes[-1].index_count += 3
            elif tag == "usemtl" and len(tokens) > 1:
                cur_material = get_material_id(tokens[1])
                open_submesh()
            elif tag == "mtllib" and len(tokens) > 1:
                for rel in _mtllib_paths(" ".join(tokens[1:]), directory):
                    mtl_maps.update(load_mtl(os.path.join(directory, rel)))
            elif tag in ("g", "o") and len(tokens) > 1:
                cur_group = tokens[1]
                open_submesh()
    close_submesh()
    if not submeshes:
        submeshes = [SubMesh(name=stem, start_index=0,
                             index_count=len(face_indices), material_index=0)]
    for sm in submeshes:
        sm.has_texcoords = any_uv
        sm.has_normals = any_norm

    materials = _materials(material_names, mtl_maps, load_textures, directory, stem)
    mesh = Mesh(
        positions=np.array(out_pos, dtype=np.float64).reshape(-1, 3),
        faces=np.array(face_indices, dtype=np.int32).reshape(-1, 3),
        uvs=np.array(out_uv, dtype=np.float64).reshape(-1, 2),
        normals=np.array(out_norm, dtype=np.float64).reshape(-1, 3),
        submeshes=submeshes,
        materials=materials,
        name=stem,
    )
    mesh.finalize()
    log.info("Model loaded: %s (vertices: %d, faces: %d, submeshes: %d, materials: %d)",
             path, mesh.nverts, mesh.nfaces, len(mesh.submeshes), len(mesh.materials))
    return mesh
