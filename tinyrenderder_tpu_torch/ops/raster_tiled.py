"""Vertex stage and tile binning in PyTorch.

Counterpart of ``tinyrenderder_tpu/ops/raster_tiled.py``: the
per-triangle vertex transform and setup, the per-triangle tile spans
from the clamped bbox, and the (tile, triangle) pair bins in CSR form
(``Bins`` / ``bin_triangles_csr`` over every tile, for the dense raster
entry ``raster_coarse.rasterize``).

Everything is sized exactly from the true pair total, which the caller
reads back once (``raster_sparse.pre_sparse``): there is no static
capacity, no padding and no overflow.  The TPU's exact-f32 divmod
(a VPU workaround capped at 2^21 pairs) becomes integer ``//``/``%``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tinyrenderder_tpu_torch import math3d, shaders
from tinyrenderder_tpu_torch.ops import semantics

__all__ = ["TILE_H", "TILE_W", "cdiv", "vertex_stage", "tile_spans",
           "tile_pair_counts", "build_bins", "Bins", "bin_triangles_csr", "to_tiles",
           "flatten_varyings", "n_vary_of", "shader_varyings"]

TILE_H = 16
TILE_W = 128


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def vertex_stage(attrs: dict, uniforms: dict, shader, width: int, height: int):
    """Vertex transform + triangle setup over all F triangles
    (main.cpp:660-665 + our_gl.cpp:89-135).  Returns (setup, varyings)."""
    clip, varyings = shaders.vertex(shader, uniforms, attrs)
    pos = attrs["position"]
    vp = torch.as_tensor(math3d.viewport(0, 0, width, height),
                         dtype=pos.dtype, device=pos.device)
    return semantics.triangle_setup_planes(clip, vp, width, height), varyings


def tile_spans(setup: dict, tile_w: int, tile_h: int):
    """Per-triangle tile range from the clamped bbox.  Returns (tx0, ty0,
    span_x, span_y, spans) int32 (F,); spans = span_x * span_y pairs,
    zero for rejected triangles."""
    bbox = setup["bbox"]
    valid = setup["valid"]
    tx0 = torch.div(bbox[:, 0], tile_w, rounding_mode="floor")
    tx1 = torch.div(bbox[:, 1], tile_w, rounding_mode="floor")
    ty0 = torch.div(bbox[:, 2], tile_h, rounding_mode="floor")
    ty1 = torch.div(bbox[:, 3], tile_h, rounding_mode="floor")
    zero = torch.zeros_like(tx0)
    span_y = torch.where(valid, ty1 - ty0 + 1, zero)
    span_x = torch.where(valid, tx1 - tx0 + 1, zero)
    spans = torch.where(span_y > 0, span_x, zero) * span_y
    return tx0, ty0, span_x, span_y, spans


def tile_pair_counts(tx0, ty0, span_x, span_y, n_tiles_x: int, n_tiles_y: int):
    """(T,) pairs per tile straight from the spans, before any pair
    exists: each triangle adds 1 over a rectangle of tiles, written as
    four corner updates of a 2-D difference array and summed back with
    two prefix sums.  Equals ``build_bins``' counts."""
    live = (span_x > 0) & (span_y > 0)
    zero = torch.zeros_like(tx0)
    x0 = torch.where(live, tx0, zero)            # dead triangles add 0 at (0, 0)
    y0 = torch.where(live, ty0, zero)
    x1 = x0 + torch.where(live, span_x, zero)
    y1 = y0 + torch.where(live, span_y, zero)
    one = live.to(torch.int32)
    row = n_tiles_x + 1
    corners = torch.cat([y0 * row + x0, y0 * row + x1, y1 * row + x0, y1 * row + x1])
    # integer atomics: exact in any order
    diff = torch.zeros((n_tiles_y + 1) * row, dtype=torch.int32, device=tx0.device)
    diff.index_add_(0, corners.long(), torch.cat([one, -one, -one, one]))
    counts = diff.view(n_tiles_y + 1, row).cumsum(0, dtype=torch.int32).cumsum(
        1, dtype=torch.int32)
    return counts[:n_tiles_y, :n_tiles_x].reshape(-1)


def build_bins(tx0, ty0, span_x, spans, total: int, n_tiles_x: int, n_tiles_y: int):
    """Expand spans into ``total`` (tile, triangle) pairs and sort them by
    tile, stably: within a bin the triangles stay in submission order,
    which is the reference's first-drawn-wins z-tie rule (our_gl.cpp:165).
    Returns (sorted_tri (total,) int32, start (T+1,) int32, counts (T,)
    int32): sorted_tri[start[t]:start[t+1]] are tile t's triangles."""
    dev = spans.device
    f = spans.shape[0]
    n_tiles = n_tiles_x * n_tiles_y
    tri = torch.repeat_interleave(torch.arange(f, dtype=torch.int32, device=dev),
                                  spans, output_size=total)
    offs = torch.cumsum(spans, 0, dtype=torch.int32) - spans
    tril = tri.long()
    k = torch.arange(total, dtype=torch.int32, device=dev) - offs[tril]
    sx = torch.clamp(span_x[tril], min=1)
    tile_id = (ty0[tril] + k // sx) * n_tiles_x + tx0[tril] + k % sx
    sorted_tile, order = torch.sort(tile_id, stable=True)
    sorted_tri = tri[order]
    # CSR offsets by binary search over the sorted keys (bincount would
    # read its maximum back to the host on CUDA)
    start = torch.searchsorted(
        sorted_tile, torch.arange(n_tiles + 1, dtype=torch.int32, device=dev),
        out_int32=True)
    return sorted_tri, start, start[1:] - start[:-1]


class Bins(NamedTuple):
    """CSR bins over every tile of the grid: ``sorted_tri[start[t]:start[t
    + 1]]`` are the triangles overlapping tile t in submission order
    (``raster_tiled.Bins``, exact size: no padding, no capacity)."""

    sorted_tri: torch.Tensor   # (total,) i32
    start: torch.Tensor        # (T + 1,) i32
    counts: torch.Tensor       # (T,) i32
    n_tiles_x: int
    n_tiles_y: int
    total: int


def bin_triangles_csr(setup: dict, width: int, height: int, tile_w: int = TILE_W,
                      tile_h: int = TILE_H) -> Bins:
    """Bin a pass's triangles to every screen tile (``bin_triangles_csr``),
    sized from one readback of the pair total."""
    n_tiles_x, n_tiles_y = cdiv(width, tile_w), cdiv(height, tile_h)
    tx0, ty0, span_x, _, spans = tile_spans(setup, tile_w, tile_h)
    total = int(spans.sum())
    return Bins(*build_bins(tx0, ty0, span_x, spans, total, n_tiles_x, n_tiles_y),
                n_tiles_x, n_tiles_y, total)


def to_tiles(img, n_tiles_y: int, n_tiles_x: int, tile_h: int, tile_w: int, fill):
    """(H, W) -> contiguous (T, tile_h, tile_w), the ragged edge padded
    with ``fill`` (``_to_tiles``)."""
    h, w = img.shape
    ph, pw = n_tiles_y * tile_h, n_tiles_x * tile_w
    if (ph, pw) != (h, w):
        img = torch.nn.functional.pad(img, (0, pw - w, 0, ph - h), value=fill)
    return (img.reshape(n_tiles_y, tile_h, n_tiles_x, tile_w).permute(0, 2, 1, 3)
               .reshape(n_tiles_y * n_tiles_x, tile_h, tile_w).contiguous())


def flatten_varyings(varyings: dict, spec) -> torch.Tensor:
    """{name: (F, 3, C)} -> (F, 3, V) in ``spec`` order."""
    return torch.cat([varyings[name] for name, _ in spec], dim=-1)


def n_vary_of(shader) -> int:
    """Varying channels a pass's raster interpolates: none for a
    depth-only pass."""
    return sum(shader.varying_spec.values()) if shader.writes_color else 0


def shader_varyings(varyings: dict, shader):
    """The vertex stage's varyings as (F, 3, V) in the shader's
    ``varying_spec`` order, checked against the spec; None for a
    depth-only pass, whose records carry no varying corners."""
    if not shader.writes_color:
        return None
    spec = tuple(shader.varying_spec.items())
    if {name for name, _ in spec} != set(varyings):
        raise ValueError(f"{shader.name}.varying_spec {sorted(dict(spec))} != "
                         f"vertex output {sorted(varyings)}")
    return flatten_varyings(varyings, spec)


def active_ids(active, n_active: int):
    """(n_active,) int32 ids of the True entries of ``active``, ascending;
    ``n_active`` is their count, already on the host."""
    slot = torch.where(active, torch.cumsum(active, 0) - 1, n_active)
    ids = torch.empty(n_active + 1, dtype=torch.int32, device=active.device)
    ids.scatter_(0, slot, torch.arange(active.shape[0], dtype=torch.int32,
                                       device=active.device))
    return ids[:n_active]     # the last slot is the trash of the inactive
