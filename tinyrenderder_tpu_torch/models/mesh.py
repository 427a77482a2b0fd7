"""Structure-of-arrays mesh and material containers, and the load-time
geometry post-processing.

Counterpart of ``tinyrenderder_tpu/models/mesh.py`` (the reference's
``model.{h,cpp}`` minus Assimp): flattened vertex/index buffers with
submesh ranges (model.h:114-117), four texture maps per material
(model.h:34-44), area-weighted normal generation (model.cpp:269-316),
tangents with Gram-Schmidt (model.cpp:318-388) and the local AABB with a
1% margin (model.cpp:15-40).  Float64 NumPy; ``face_attributes`` casts to
the working dtype at the boundary to the passes, and
``device_face_attributes`` keeps their tensors on a device, uploaded once.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from tinyrenderder_tpu_torch import convert
from tinyrenderder_tpu_torch.math3d import AABB

__all__ = ["Mesh", "SubMesh", "Material", "dedup_rows_stable"]


@dataclass
class SubMesh:
    """A contiguous index range bound to one material (model.h:23-31)."""

    name: str = ""
    start_index: int = 0
    index_count: int = 0
    material_index: int = 0
    has_normals: bool = False
    has_texcoords: bool = False
    has_tangents: bool = False


@dataclass
class Material:
    """The four texture maps of a material (model.h:34-44): each None or a
    (th, tw, c) uint8 array in RGB[A] order with row 0 = top."""

    name: str = ""
    diffuse: np.ndarray | None = None
    normal: np.ndarray | None = None
    specular: np.ndarray | None = None
    emission: np.ndarray | None = None

    @property
    def has_diffuse(self) -> bool:
        return self.diffuse is not None

    @property
    def has_normal(self) -> bool:
        return self.normal is not None

    @property
    def has_specular(self) -> bool:
        return self.specular is not None

    @property
    def has_emission(self) -> bool:
        return self.emission is not None


def _row_norms(v: np.ndarray) -> np.ndarray:
    return np.sqrt((v * v).sum(axis=-1))


def dedup_rows_stable(rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """First-occurrence-stable unique rows -> (uniq, per-row id into uniq):
    the JoinIdenticalVertices analogue of the STL, COLLADA and FBX
    loaders, ids in order of first appearance (as the OBJ loader reuses
    indices)."""
    uniq, inverse = np.unique(rows, axis=0, return_inverse=True)
    first = np.full(uniq.shape[0], rows.shape[0], np.int64)
    np.minimum.at(first, inverse, np.arange(rows.shape[0]))
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.shape[0])
    return uniq[order], rank[inverse]


@dataclass
class Mesh:
    """Flattened triangle mesh: positions/normals/uvs/tangents/bitangents
    are (V, ·) float64 arrays, faces (F, 3) int32 vertex indices."""

    positions: np.ndarray                      # (V, 3)
    faces: np.ndarray                          # (F, 3) int32
    normals: np.ndarray | None = None          # (V, 3)
    uvs: np.ndarray | None = None              # (V, 2)
    tangents: np.ndarray | None = None         # (V, 3)
    bitangents: np.ndarray | None = None       # (V, 3)
    submeshes: list[SubMesh] = field(default_factory=list)
    materials: list[Material] = field(default_factory=list)
    name: str = ""
    local_aabb: AABB | None = None

    def __post_init__(self):
        self.positions = np.asarray(self.positions, dtype=np.float64).reshape(-1, 3)
        self.faces = np.asarray(self.faces, dtype=np.int32).reshape(-1, 3)
        v = self.positions.shape[0]
        if self.normals is None:
            self.normals = np.zeros((v, 3))
        if self.uvs is None:
            self.uvs = np.zeros((v, 2))
        if self.tangents is None:
            self.tangents = np.zeros((v, 3))
        if self.bitangents is None:
            self.bitangents = np.zeros((v, 3))
        for attr in ("normals", "tangents", "bitangents"):
            setattr(self, attr, np.asarray(getattr(self, attr), dtype=np.float64).reshape(v, 3))
        self.uvs = np.asarray(self.uvs, dtype=np.float64).reshape(v, 2)
        if not self.submeshes:
            self.submeshes = [SubMesh(name=self.name or "mesh", start_index=0,
                                      index_count=self.faces.size, material_index=0)]
        if not self.materials:
            self.materials = [Material()]

    @property
    def nverts(self) -> int:
        return self.positions.shape[0]

    @property
    def nfaces(self) -> int:
        return self.faces.shape[0]

    def finalize(self) -> "Mesh":
        """The reference's load-time pipeline: generate normals and
        tangents where missing, compute the AABB (model.cpp:58-64)."""
        self.generate_normals_if_needed()
        self.compute_tangents_if_needed()
        self.compute_aabb()
        return self

    def generate_normals_if_needed(self) -> None:
        """Area-weighted vertex normals (model.cpp:269-316) for the vertices
        whose normal has length < 0.001: unnormalized face cross products
        accumulated per vertex, then normalized, (0, 0, 1) for isolated
        vertices.  Authored normals are kept."""
        missing = _row_norms(self.normals) < 0.001
        if self.nverts == 0 or not missing.any():
            return
        normals = np.zeros_like(self.positions)
        p = self.positions
        f = self.faces
        e1 = p[f[:, 1]] - p[f[:, 0]]
        e2 = p[f[:, 2]] - p[f[:, 0]]
        face_n = np.cross(e1, e2)
        for k in range(3):
            np.add.at(normals, f[:, k], face_n)
        lens = _row_norms(normals)
        ok = lens > 0.001
        normals[ok] /= lens[ok, None]
        normals[~ok] = (0.0, 0.0, 1.0)
        self.normals = np.where(missing[:, None], normals, self.normals)

    def compute_tangents_if_needed(self) -> None:
        """UV-gradient tangents + Gram-Schmidt (model.cpp:318-388), when any
        tangent has length < 0.001: per-face tangent/bitangent from UV
        deltas (skipping |det| < 1e-8), accumulated per vertex, then
        t = normalize(t - n*dot(n,t)) and bitangent = cross(raw normal, t);
        degenerate vertices get t=(1,0,0), b=(0,1,0)."""
        if self.nverts == 0 or not np.any(_row_norms(self.tangents) < 0.001):
            return
        p, uv, f = self.positions, self.uvs, self.faces
        tan = np.zeros_like(p)
        bitan = np.zeros_like(p)

        d_pos1 = p[f[:, 1]] - p[f[:, 0]]
        d_pos2 = p[f[:, 2]] - p[f[:, 0]]
        d_uv1 = uv[f[:, 1]] - uv[f[:, 0]]
        d_uv2 = uv[f[:, 2]] - uv[f[:, 0]]
        r = d_uv1[:, 0] * d_uv2[:, 1] - d_uv2[:, 0] * d_uv1[:, 1]
        keep = np.abs(r) >= 1e-8
        invr = np.zeros_like(r)
        invr[keep] = 1.0 / r[keep]
        face_t = (d_pos1 * d_uv2[:, 1:2] - d_pos2 * d_uv1[:, 1:2]) * invr[:, None]
        face_b = (d_pos2 * d_uv1[:, 0:1] - d_pos1 * d_uv2[:, 0:1]) * invr[:, None]
        face_t[~keep] = 0.0
        face_b[~keep] = 0.0
        for k in range(3):
            np.add.at(tan, f[:, k], face_t)
            np.add.at(bitan, f[:, k], face_b)

        t_len = _row_norms(tan)
        n_len = _row_norms(self.normals)
        ok = (t_len > 0.001) & (n_len > 0.001)

        n_hat = np.zeros_like(self.normals)
        n_hat[ok] = self.normals[ok] / n_len[ok, None]
        t_hat = np.zeros_like(tan)
        t_hat[ok] = tan[ok] / t_len[ok, None]
        proj = (n_hat * t_hat).sum(axis=-1, keepdims=True)
        t_orth = t_hat - n_hat * proj
        t_orth_len = _row_norms(t_orth)
        safe = t_orth_len > 0
        t_final = np.zeros_like(t_orth)
        t_final[safe] = t_orth[safe] / t_orth_len[safe, None]

        self.tangents = np.where(ok[:, None], t_final, (1.0, 0.0, 0.0))
        self.bitangents = np.where(ok[:, None],
                                   np.cross(self.normals, self.tangents),
                                   (0.0, 1.0, 0.0))

    def compute_aabb(self) -> None:
        """Local AABB with 1% symmetric margin (model.cpp:15-40)."""
        self.local_aabb = AABB.of_points(self.positions, margin_frac=0.01)

    def get_local_aabb(self) -> AABB:
        if self.local_aabb is None:
            self.compute_aabb()
        return self.local_aabb

    def get_world_aabb(self, model_matrix: np.ndarray) -> AABB:
        """World AABB: the 8 local corners transformed (geometry.h:297-327).
        One-entry cache keyed on the local AABB's identity (``compute_aabb``
        replaces it) and the matrix bytes, as the JAX package keeps it: the
        cull runs every frame with matrices that rarely move.  The cached
        AABB is shared; callers do not mutate it."""
        local = self.get_local_aabb()
        mkey = np.asarray(model_matrix, dtype=np.float64).tobytes()
        hit = self.__dict__.get("_world_aabb_cache")
        if hit is not None and hit[0] is local and hit[1] == mkey:
            return hit[2]
        aabb = local.transform(model_matrix)
        self.__dict__["_world_aabb_cache"] = (local, mkey, aabb)
        return aabb

    def get_center(self) -> np.ndarray:
        return self.get_local_aabb().center()

    def get_size(self) -> np.ndarray:
        b = self.get_local_aabb()
        return b.max - b.min

    # -- the reference's per-face accessors (model.cpp:391-412) ---------------
    def vert(self, iface: int, nth: int | None = None) -> np.ndarray:
        if nth is None:
            i = iface
            if i < 0 or i >= self.nverts:
                return np.zeros(3)
            return self.positions[i].copy()
        idx = iface * 3 + nth
        if idx < 0 or idx >= self.faces.size:
            return np.zeros(3)
        return self.positions[self.faces.flat[idx]].copy()

    def normal(self, iface: int, nth: int) -> np.ndarray:
        idx = iface * 3 + nth
        if idx < 0 or idx >= self.faces.size:
            return np.array([0.0, 0.0, 1.0])
        return self.normals[self.faces.flat[idx]].copy()

    def uv(self, iface: int, nth: int) -> np.ndarray:
        idx = iface * 3 + nth
        if idx < 0 or idx >= self.faces.size:
            return np.zeros(2)
        return self.uvs[self.faces.flat[idx]].copy()

    @property
    def has_normal_map(self) -> bool:
        return bool(self.materials) and self.materials[0].has_normal

    # -- the boundary to the passes --------------------------------------------
    def face_attributes(self, dtype=np.float32) -> dict:
        """Per-face-corner attributes for the vertex stage: (F, 3, C)
        arrays in ``dtype``."""
        f = self.faces
        return {
            "position": self.positions[f].astype(dtype),
            "normal": self.normals[f].astype(dtype),
            "uv": self.uvs[f].astype(dtype),
            "tangent": self.tangents[f].astype(dtype),
            "bitangent": self.bitangents[f].astype(dtype),
        }

    def device_face_attributes(self, dtype=np.float32, device="cuda") -> dict:
        """``face_attributes`` as tensors on ``device`` (``convert.to_torch``),
        built and uploaded once per (dtype, device) and reused by every
        later frame: geometry holds still across a render loop.  Call
        ``invalidate_device_cache`` after editing the mesh's arrays.  The
        tensors are shared; nothing downstream writes into them."""
        key = (np.dtype(dtype).str, convert.device_key(device))
        cache = self.__dict__.setdefault("_device_attr_cache", {})
        if key not in cache:
            cache[key] = {k: convert.to_torch(v, key[1])
                          for k, v in self.face_attributes(dtype).items()}
        return cache[key]

    def invalidate_device_cache(self) -> None:
        self.__dict__.pop("_device_attr_cache", None)
