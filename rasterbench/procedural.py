"""The benchmark's meshes and textures, made from a seed.

Frozen copies of ``uv_sphere``, ``bumpy_head``, ``cube``, ``head_wall``,
``mixed_interior``, ``checker_texture``, ``noise_texture``,
``gradient_specular_texture``, ``sphere_normal_texture`` and
``default_head_material`` of ``tinyrenderder_tpu_torch/models/procedural.py``
at commit 6e89d3a91fb6a69bf8fbc13207f16929040733f9, with the same
arithmetic.  Two departures: each returns plain arrays (``MeshArrays``,
a dict of textures) in place of the program's ``Mesh`` and ``Material``,
and ``head_wall`` and ``mixed_interior`` take the bump ``seed`` that the
original fixes at 7.  Where the original finalizes a part mesh inside
the generator (the heads of the wall, the flipped room box) the copy
derives those normals with ``geometry.generate_normals``; a mesh whose
normals the original leaves to ``Mesh.finalize`` (``bumpy_head``) comes
back with ``normals=None``, for the program and the reference to derive
each on its own.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from rasterbench.geometry import generate_normals


@dataclass
class MeshArrays:
    positions: np.ndarray            # (V, 3) float64
    faces: np.ndarray                # (F, 3) int32
    normals: np.ndarray | None       # (V, 3) float64, or None: derived downstream
    uvs: np.ndarray                  # (V, 2) float64

    @property
    def nfaces(self) -> int:
        return int(self.faces.shape[0])


def uv_sphere(n_lat: int = 16, n_lon: int = 24, radius: float = 1.0) -> MeshArrays:
    verts, norms, uvs = [], [], []
    for i in range(n_lat + 1):
        theta = math.pi * i / n_lat
        for j in range(n_lon + 1):
            phi = 2.0 * math.pi * j / n_lon
            x = math.sin(theta) * math.cos(phi)
            y = math.cos(theta)
            z = math.sin(theta) * math.sin(phi)
            verts.append((radius * x, radius * y, radius * z))
            norms.append((x, y, z))
            uvs.append((j / n_lon, i / n_lat))
    faces = []
    stride = n_lon + 1
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * stride + j
            b = a + 1
            c = a + stride
            d = c + 1
            if i > 0:
                faces.append((a, c, b))
            if i < n_lat - 1:
                faces.append((b, c, d))
    pos = np.array(verts, dtype=np.float64)
    f = np.array(faces, dtype=np.int32)
    return MeshArrays(pos, f, generate_normals(pos, f, np.array(norms, dtype=np.float64)),
                      np.array(uvs, dtype=np.float64))


def bumpy_head(n_lat: int = 24, n_lon: int = 32, radius: float = 1.0,
               bump: float = 0.12, seed: int = 7) -> MeshArrays:
    """A displaced sphere; normals left to be derived (``None``)."""
    base = uv_sphere(n_lat, n_lon, radius)
    p = base.positions
    rng = np.random.RandomState(seed)
    disp = np.zeros(len(p))
    for _ in range(5):
        d = rng.randn(3)
        d /= np.linalg.norm(d)
        freq = rng.uniform(1.0, 3.0)
        phase = rng.uniform(0, 2 * math.pi)
        disp += np.sin(freq * (p @ d) * math.pi + phase)
    disp = 1.0 + bump * disp / 5.0
    return MeshArrays(p * disp[:, None], base.faces.copy(), None, base.uvs.copy())


def cube(size: float = 1.0) -> MeshArrays:
    s = size / 2.0
    quads = [
        ([(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)], (0, 0, 1)),
        ([(s, -s, -s), (-s, -s, -s), (-s, s, -s), (s, s, -s)], (0, 0, -1)),
        ([(s, -s, s), (s, -s, -s), (s, s, -s), (s, s, s)], (1, 0, 0)),
        ([(-s, -s, -s), (-s, -s, s), (-s, s, s), (-s, s, -s)], (-1, 0, 0)),
        ([(-s, s, s), (s, s, s), (s, s, -s), (-s, s, -s)], (0, 1, 0)),
        ([(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)], (0, -1, 0)),
    ]
    verts, norms, uvs, faces = [], [], [], []
    uvq = [(0, 0), (1, 0), (1, 1), (0, 1)]
    for corners, n in quads:
        base = len(verts)
        for k, c in enumerate(corners):
            verts.append(c)
            norms.append(n)
            uvs.append(uvq[k])
        faces.append((base, base + 1, base + 2))
        faces.append((base, base + 2, base + 3))
    pos = np.array(verts, dtype=np.float64)
    f = np.array(faces, dtype=np.int32)
    return MeshArrays(pos, f, generate_normals(pos, f, np.array(norms, dtype=np.float64)),
                      np.array(uvs, dtype=np.float64))


def head_wall(grid: int = 3, n_lat: int = 96, n_lon: int = 144, spacing: float = 2.4,
              seed: int = 7) -> MeshArrays:
    """grid x grid bumpy heads (their normals derived) in one mesh."""
    head = bumpy_head(n_lat, n_lon, seed=seed)
    head_normals = generate_normals(head.positions, head.faces, None)
    pos, fac, uvs, nrm = [], [], [], []
    offset = 0
    half = (grid - 1) / 2.0
    for gy in range(grid):
        for gx in range(grid):
            shift = np.array([(gx - half) * spacing, (gy - half) * spacing, 0.0])
            pos.append(head.positions + shift)
            fac.append(head.faces + offset)
            uvs.append(head.uvs)
            nrm.append(head_normals)
            offset += head.positions.shape[0]
    p, f = np.concatenate(pos), np.concatenate(fac)
    return MeshArrays(p, f, generate_normals(p, f, np.concatenate(nrm)), np.concatenate(uvs))


def mixed_interior(grid: int = 3, n_lat: int = 96, n_lon: int = 144, room: float = 14.0,
                   seed: int = 7) -> MeshArrays:
    """Twelve giant inward-facing room triangles and the ``head_wall``
    grid of tiny ones, in one mesh."""
    wall = head_wall(grid=grid, n_lat=n_lat, n_lon=n_lon, seed=seed)
    out = cube(size=room)
    box_faces = out.faces[:, ::-1].copy()
    box_normals = generate_normals(out.positions, box_faces, None)
    n0 = wall.positions.shape[0]
    p = np.concatenate([wall.positions, out.positions])
    f = np.concatenate([wall.faces, box_faces + n0])
    return MeshArrays(p, f, generate_normals(p, f, np.concatenate([wall.normals, box_normals])),
                      np.concatenate([wall.uvs, out.uvs * 6.0]))


# ---------------------------------------------------------------------------
# textures: RGB uint8, rows top-first
# ---------------------------------------------------------------------------

def checker_texture(size: int = 64, cells: int = 8,
                    c0=(200, 60, 40), c1=(240, 220, 200)) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size]
    cell = size // cells
    mask = ((x // cell) + (y // cell)) % 2 == 0
    tex = np.where(mask[..., None], np.array(c0, dtype=np.uint8),
                   np.array(c1, dtype=np.uint8))
    return tex.astype(np.uint8)


def noise_texture(size: int = 64, seed: int = 11) -> np.ndarray:
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(size, size, 3), dtype=np.int64).astype(np.uint8)


def gradient_specular_texture(size: int = 64) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size]
    r = (x * 255 // max(size - 1, 1)).astype(np.uint8)
    g = (y * 255 // max(size - 1, 1)).astype(np.uint8)
    b = ((x + y) * 255 // max(2 * size - 2, 1)).astype(np.uint8)
    return np.stack([r, g, b], axis=-1)


def sphere_normal_texture(size: int = 64) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    u = x / max(size - 1, 1)
    v = y / max(size - 1, 1)
    nx = 0.3 * np.sin(u * 6 * math.pi)
    ny = 0.3 * np.cos(v * 4 * math.pi)
    nz = np.sqrt(np.clip(1.0 - nx * nx - ny * ny, 0.0, None))
    n = np.stack([nx, ny, nz], axis=-1)
    return np.clip((n * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)


def default_head_material(size: int = 64) -> dict:
    """{diffuse, normal, specular} maps of the default head material."""
    return {"diffuse": checker_texture(size), "normal": sphere_normal_texture(size),
            "specular": gradient_specular_texture(size)}
