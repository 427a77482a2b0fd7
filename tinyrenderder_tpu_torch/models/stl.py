"""STL loader (binary + ascii) — third mesh format beside OBJ and PLY.

Counterpart of ``tinyrenderder_tpu/models/stl.py``, line for line.

The reference loads any Assimp-supported format through one fixed
postprocess pipeline (model.cpp:91-99).  STL exercises the parts of
that pipeline the other two don't: every facet ships three DUPLICATED
vertices, so ``aiProcess_JoinIdenticalVertices`` matters (exact-position
dedup here, matching the OBJ loader's index-reuse behavior), and the
format carries no UVs and only per-facet normals — the loader discards
facet normals like Assimp's smooth-normal generation would and lets
``Mesh.finalize()`` regenerate area-weighted vertex normals
(aiProcess_GenNormals, model.cpp:269-316).  Textures come from the
filename-fallback probe (``<stem>_diffuse.tga`` …, model.cpp:207-267)
exactly like an OBJ without an MTL.

Binary layout: 80-byte header, uint32 facet count, then 50-byte
records (normal 3f32, 3 x vertex 3f32, uint16 attribute).  Ascii:
``solid`` / ``facet normal`` / ``outer loop`` / ``vertex x y z``.
Both parse through vectorized numpy views — no per-facet Python loop
on the binary path.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from tinyrenderder_tpu_torch.models.mesh import (Material, Mesh, SubMesh,
                                                 dedup_rows_stable)
from tinyrenderder_tpu_torch.models.obj import load_material_textures

log = logging.getLogger("tinyrenderder_tpu_torch.stl")

__all__ = ["load_stl"]

_REC = np.dtype([("normal", "<f4", (3,)),
                 ("verts", "<f4", (3, 3)),
                 ("attr", "<u2")])


def _read_binary(data: bytes) -> np.ndarray:
    """(F, 3, 3) float64 corner positions from a binary STL body."""
    if len(data) < 84:
        raise ValueError("binary STL truncated before facet count")
    count = int(np.frombuffer(data[80:84], "<u4")[0])
    need = 84 + count * _REC.itemsize
    if len(data) < need:
        raise ValueError(f"binary STL truncated: {count} facets declared, "
                         f"{(len(data) - 84) // _REC.itemsize} present")
    recs = np.frombuffer(data[84:need], dtype=_REC)
    return recs["verts"].astype(np.float64)


def _read_ascii(text: str) -> np.ndarray:
    verts: list[list[float]] = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0].lower() == "vertex":
            try:
                verts.append([float(parts[1]), float(parts[2]),
                              float(parts[3])])
            except ValueError as e:
                raise ValueError(f"bad STL vertex line: {line!r}") from e
    if len(verts) % 3:
        raise ValueError(f"ascii STL vertex count {len(verts)} is not a "
                         "multiple of 3")
    return np.asarray(verts, np.float64).reshape(-1, 3, 3)


def load_stl(path: str, load_textures: bool = True) -> Mesh:
    """Load an STL file into a finalized Mesh (same postprocess contract
    as load_obj/load_ply)."""
    directory = os.path.dirname(os.path.abspath(path))
    stem = os.path.splitext(os.path.basename(path))[0]

    with open(path, "rb") as f:
        data = f.read()
    # "solid" prefix alone does not mean ascii (many binary exporters
    # write it); require a facet keyword in the early body
    head = data[:512].lower()
    is_ascii = head.lstrip().startswith(b"solid") and b"facet" in head
    corners = (_read_ascii(data.decode("ascii", errors="replace"))
               if is_ascii else _read_binary(data))
    fmt = "ascii" if is_ascii else "binary"

    # JoinIdenticalVertices: exact-position dedup, first occurrence wins
    flat = corners.reshape(-1, 3)
    positions, corner_vid = dedup_rows_stable(flat)
    faces = corner_vid.astype(np.int32).reshape(-1, 3)

    if load_textures:
        materials = [load_material_textures("", {}, directory, stem)]
    else:
        materials = [Material(name="")]
    submeshes = [SubMesh(name=stem, start_index=0,
                         index_count=faces.size, material_index=0,
                         has_texcoords=False, has_normals=False)]
    mesh = Mesh(positions=positions, faces=faces,
                submeshes=submeshes, materials=materials, name=stem)
    mesh.finalize()                      # area-weighted normals + AABB
    log.info("Model loaded (stl/%s): %s (vertices: %d, faces: %d)",
             fmt, path, mesh.nverts, mesh.nfaces)
    return mesh
