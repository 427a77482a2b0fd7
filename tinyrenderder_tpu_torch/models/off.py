"""OFF loader (Object File Format) — seventh mesh format.

Counterpart of ``tinyrenderder_tpu/models/off.py``, line for line.

The reference loads any Assimp-supported format (model.cpp:91-99); OFF
is Assimp's simplest polygon format and rounds out the loader family's
coverage of plain-text academic formats (Princeton shape benchmark,
geometry-processing course data).  The format is LINE-based: an ``OFF``
magic line (the counts may share it), a ``V F E`` counts line, V vertex
lines ``x y z [r g b [a]]`` (COFF colors ignored), then F polygon lines
``n i0 ... i{n-1} [r g b [a]]`` (per-face colors ignored), with ``#``
comments and blank lines allowed anywhere.  Polygons fan-triangulate
(aiProcess_Triangulate).  OFF carries no UVs or normals:
``Mesh.finalize()`` regenerates area-weighted normals
(aiProcess_GenNormals) and textures come from the filename-probe
fallback (model.cpp:207-267), exactly like an OBJ without an MTL.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from tinyrenderder_tpu_torch.models.mesh import Material, Mesh, SubMesh
from tinyrenderder_tpu_torch.models.obj import load_material_textures

log = logging.getLogger("tinyrenderder_tpu_torch.off")

__all__ = ["load_off"]


def load_off(path: str, load_textures: bool = True) -> Mesh:
    """Load an OFF file into a finalized Mesh (same postprocess contract
    as the other loaders)."""
    directory = os.path.dirname(os.path.abspath(path))
    stem = os.path.splitext(os.path.basename(path))[0]
    with open(path, "rb") as f:
        text = f.read().decode("utf-8", errors="replace")

    rows = []
    for line in text.splitlines():
        hash_i = line.find("#")
        if hash_i >= 0:
            line = line[:hash_i]
        toks = line.split()
        if toks:
            rows.append(toks)
    if not rows:
        raise ValueError("empty OFF file")

    # counts: either trailing the magic line or on their own line
    if rows[0][0].upper().endswith("OFF"):
        counts = rows[0][1:] if len(rows[0]) > 1 else (
            rows[1] if len(rows) > 1 else [])
        r = 1 if len(rows[0]) > 1 else 2
    else:
        counts = rows[0]
        r = 1
    try:
        nv, nf = int(counts[0]), int(counts[1])
    except (ValueError, IndexError) as e:
        raise ValueError("OFF counts line malformed") from e
    if nv < 0 or nf < 0:
        raise ValueError("negative OFF element count")
    if len(rows) < r + nv + nf:
        raise ValueError(f"truncated OFF: {nv} vertices + {nf} faces "
                         f"declared, {len(rows) - r} data lines present")

    positions = np.zeros((nv, 3), np.float64)
    try:
        for v in range(nv):
            row = rows[r + v]
            positions[v] = (float(row[0]), float(row[1]), float(row[2]))
    except (ValueError, IndexError) as e:
        raise ValueError("malformed OFF vertex line") from e

    faces: list[tuple[int, int, int]] = []
    try:
        for fi in range(nf):
            row = rows[r + nv + fi]
            n = int(row[0])
            if n < 0 or len(row) < 1 + n:
                raise ValueError(f"OFF face declares {n} corners, "
                                 f"{len(row) - 1} present")
            corners = [int(t) for t in row[1:1 + n]]   # trailing RGB ignored
            for a in range(1, n - 1):
                faces.append((corners[0], corners[a], corners[a + 1]))
    except (ValueError, IndexError) as e:
        raise ValueError("malformed OFF face line") from e

    face_arr = np.asarray(faces, np.int32).reshape(-1, 3)
    if face_arr.size and (face_arr.min() < 0 or face_arr.max() >= nv):
        raise ValueError("OFF face index out of range")

    if load_textures:
        materials = [load_material_textures("", {}, directory, stem)]
    else:
        materials = [Material(name="")]
    submeshes = [SubMesh(name=stem, start_index=0,
                         index_count=face_arr.size, material_index=0)]
    mesh = Mesh(positions=positions, faces=face_arr,
                submeshes=submeshes, materials=materials, name=stem)
    mesh.finalize()
    log.info("Model loaded (off): %s (vertices: %d, faces: %d)",
             path, mesh.nverts, mesh.nfaces)
    return mesh
