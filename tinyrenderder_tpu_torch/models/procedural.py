"""Procedural meshes and textures: the deterministic stand-ins for the
reference's assets (its obj/ directory is not shipped).

Counterpart of ``tinyrenderder_tpu/models/procedural.py``, the meshes and
textures the port's scenes and tests use: a UV sphere, the bumpy head
(a displaced sphere), a ground plane, a cube, a random triangle soup, the bench's two
246k-triangle meshes (a wall of heads, and the same inside a room), and
the checker / normal / specular maps of the default head material and a
noise texture.
"""

from __future__ import annotations

import math

import numpy as np

from tinyrenderder_tpu_torch.models.mesh import Material, Mesh

__all__ = ["uv_sphere", "bumpy_head", "plane", "cube", "triangle_soup", "head_wall",
           "mixed_interior", "checker_texture", "noise_texture", "gradient_specular_texture",
           "sphere_normal_texture", "default_head_material"]


def uv_sphere(n_lat: int = 16, n_lon: int = 24, radius: float = 1.0,
              name: str = "sphere") -> Mesh:
    """UV sphere with outward CCW winding, positions/normals/uvs."""
    verts, norms, uvs = [], [], []
    for i in range(n_lat + 1):
        theta = math.pi * i / n_lat          # 0..pi from +y pole
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
    mesh = Mesh(positions=np.array(verts), faces=np.array(faces, dtype=np.int32),
                normals=np.array(norms), uvs=np.array(uvs), name=name)
    return mesh.finalize()


def bumpy_head(n_lat: int = 24, n_lon: int = 32, radius: float = 1.0,
               bump: float = 0.12, seed: int = 7, name: str = "head") -> Mesh:
    """Deterministically displaced sphere, the african_head stand-in; the
    smooth low-frequency displacement keeps valid regenerated normals."""
    base = uv_sphere(n_lat, n_lon, radius, name=name)
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
    mesh = Mesh(positions=p * disp[:, None], faces=base.faces.copy(),
                uvs=base.uvs.copy(), name=name)
    # normals left zero -> regenerated area-weighted (model.cpp:269-316 path)
    return mesh.finalize()


def plane(size: float = 2.0, y: float = 0.0, name: str = "plane") -> Mesh:
    """Ground plane facing +y (two triangles, CCW from above)."""
    s = size / 2.0
    pos = np.array([[-s, y, -s], [s, y, -s], [s, y, s], [-s, y, s]])
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float64)
    faces = np.array([[0, 2, 1], [0, 3, 2]], dtype=np.int32)
    return Mesh(positions=pos, faces=faces, uvs=uv, name=name).finalize()


def cube(size: float = 1.0, name: str = "cube") -> Mesh:
    """Axis-aligned cube with outward faces and per-face UVs."""
    s = size / 2.0
    quads = [  # (4 corners CCW from outside, normal)
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
    return Mesh(positions=np.array(verts, dtype=np.float64),
                faces=np.array(faces, dtype=np.int32),
                normals=np.array(norms, dtype=np.float64),
                uvs=np.array(uvs, dtype=np.float64), name=name).finalize()


def triangle_soup(n: int = 64, seed: int = 3, spread: float = 1.0,
                  tri_size: float = 0.3, name: str = "soup") -> Mesh:
    """Random triangles in a cube, degenerate and sliver ones included."""
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-spread, spread, size=(n, 3))
    offsets = rng.uniform(-tri_size, tri_size, size=(n, 3, 3))
    pos = (centers[:, None, :] + offsets).reshape(-1, 3)
    faces = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    uvs = rng.uniform(0, 1, size=(n * 3, 2))
    return Mesh(positions=pos, faces=faces, uvs=uvs, name=name).finalize()


def head_wall(grid: int = 3, n_lat: int = 96, n_lon: int = 144,
              spacing: float = 2.4, name: str = "head_wall") -> Mesh:
    """grid x grid dense bumpy heads merged into one mesh: the
    Sponza-scale (~quarter-million triangle) stress stand-in."""
    head = bumpy_head(n_lat, n_lon)
    pos, fac, uvs, nrm = [], [], [], []
    offset = 0
    half = (grid - 1) / 2.0
    for gy in range(grid):
        for gx in range(grid):
            shift = np.array([(gx - half) * spacing, (gy - half) * spacing, 0.0])
            pos.append(head.positions + shift)
            fac.append(head.faces + offset)
            uvs.append(head.uvs)
            nrm.append(head.normals)
            offset += head.nverts
    mesh = Mesh(positions=np.concatenate(pos), faces=np.concatenate(fac),
                uvs=np.concatenate(uvs), normals=np.concatenate(nrm), name=name)
    mesh.materials = [default_head_material(128)]
    return mesh.finalize()


def mixed_interior(grid: int = 3, n_lat: int = 96, n_lon: int = 144,
                   room: float = 14.0, name: str = "mixed_interior") -> Mesh:
    """Sponza-regime stand-in: twelve giant inward-facing room triangles
    (walls, floor and ceiling spanning most of the screen) and the
    ``head_wall`` grid of tiny head triangles, merged into ONE mesh, as
    the reference's default scene mixes Sponza's walls with head props
    (main.cpp:483-513)."""
    wall = head_wall(grid=grid, n_lat=n_lat, n_lon=n_lon)
    out = cube(size=room, name="roombox")
    # inward-facing: flip the winding so backface culling keeps the
    # interior; the normals are regenerated from the new winding
    box = Mesh(positions=out.positions, faces=out.faces[:, ::-1].copy(),
               uvs=out.uvs, name="roombox").finalize()
    n0 = wall.nverts
    mesh = Mesh(positions=np.concatenate([wall.positions, box.positions]),
                faces=np.concatenate([wall.faces, box.faces + n0]),
                uvs=np.concatenate([wall.uvs, box.uvs * 6.0]),
                normals=np.concatenate([wall.normals, box.normals]), name=name)
    mesh.materials = [default_head_material(128)]
    return mesh.finalize()


# ---------------------------------------------------------------------------
# Procedural textures (RGB uint8, rows top-first)
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
    """Uniform random RGB bytes from ``seed``."""
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, size=(size, size, 3), dtype=np.int64).astype(np.uint8)


def gradient_specular_texture(size: int = 64) -> np.ndarray:
    """RGB gradients used as the specular map (the sampler reads channel 2)."""
    y, x = np.mgrid[0:size, 0:size]
    r = (x * 255 // max(size - 1, 1)).astype(np.uint8)
    g = (y * 255 // max(size - 1, 1)).astype(np.uint8)
    b = ((x + y) * 255 // max(2 * size - 2, 1)).astype(np.uint8)
    return np.stack([r, g, b], axis=-1)


def sphere_normal_texture(size: int = 64) -> np.ndarray:
    """Object-space normal map: gentle wavy normals around +z."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float64)
    u = x / max(size - 1, 1)
    v = y / max(size - 1, 1)
    nx = 0.3 * np.sin(u * 6 * math.pi)
    ny = 0.3 * np.cos(v * 4 * math.pi)
    nz = np.sqrt(np.clip(1.0 - nx * nx - ny * ny, 0.0, None))
    n = np.stack([nx, ny, nz], axis=-1)
    return np.clip((n * 0.5 + 0.5) * 255.0, 0, 255).astype(np.uint8)


def default_head_material(size: int = 64) -> Material:
    return Material(
        name="head",
        diffuse=checker_texture(size),
        normal=sphere_normal_texture(size),
        specular=gradient_specular_texture(size),
        emission=None,
    )
