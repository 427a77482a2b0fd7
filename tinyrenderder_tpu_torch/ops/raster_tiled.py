"""Vertex stage and tile binning in PyTorch.

Counterpart of ``tinyrenderder_tpu/ops/raster_tiled.py``: the
per-triangle vertex transform and setup, the per-triangle tile spans
from the clamped bbox, and the (tile, triangle) pair bins in CSR form
(``Bins`` / ``bin_triangles_csr`` over every tile, for the dense raster
entry ``raster_coarse.rasterize``).

A rank of the sharded frame (``parallel/dist.py``) bins only its
``Band`` of the tile grid: ``tile_spans`` clips each triangle's tile
range to the band's window and returns band-local tile coordinates, and
``vertex_stage`` can split the triangles over the ranks
(``GeomSplit``).

Everything is sized exactly from the true pair total, which the caller
reads back once (``raster_sparse.pre_sparse``): there is no static
capacity, no padding and no overflow.  The TPU's exact-f32 divmod
(a VPU workaround capped at 2^21 pairs) becomes integer ``//``/``%``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from tinyrenderder_tpu_torch import math3d, shaders
from tinyrenderder_tpu_torch.ops import semantics

__all__ = ["TILE_H", "TILE_W", "cdiv", "Band", "GeomSplit", "vertex_stage", "tile_spans",
           "band_spans", "tile_pair_counts", "build_bins", "Bins", "bin_triangles_csr",
           "to_tiles", "flatten_varyings", "n_vary_of", "shader_varyings"]

TILE_H = 16
TILE_W = 128


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


class GeomSplit(NamedTuple):
    """The vertex stage split over ``world`` ranks (``_vertex_stage``'s
    ``geom_axis``): this rank transforms the ``rank``-th of ``world``
    contiguous slices of the triangles, and ``gather(mine, stage)`` returns
    every rank's tensors concatenated in rank order, ``mine`` being this
    rank's list of per-triangle tensors and ``stage(r)`` computing rank r's
    (a process group gathers them; one process that emulates the ranks
    computes them)."""

    rank: int
    world: int
    gather: Callable


class Band(NamedTuple):
    """A rank's window of the frame's tile grid: a static shape of
    ``nty_band`` x ``ntx_band`` tiles (``ntx_band`` None: every tile
    column), tile ids band-local and row-major in it.  Band row j is global
    tile row ``ty_lo + j * ty_stride`` (``ty_stride`` > 1: interleaved row
    bands), band column i global column ``tx_lo + i`` (2-D blocks); with
    ``ty_rows`` only the first ``ty_rows`` rows are the rank's (measured
    bands of unequal height under one shape), the rest bin nothing.
    ``geom`` splits the vertex stage over the ranks (None: every rank
    transforms every triangle)."""

    ty_lo: int
    nty_band: int
    ty_stride: int = 1
    tx_lo: int | None = None
    ntx_band: int | None = None
    ty_rows: int | None = None
    geom: GeomSplit | None = None

    def origin(self, tile_h: int, tile_w: int) -> tuple[int, int]:
        """The global pixel of band tile 0's top-left corner."""
        return (self.tx_lo or 0) * tile_w, self.ty_lo * tile_h

    def y_stride(self, tile_h: int) -> int:
        """Global pixel rows from one band tile row to the next."""
        return tile_h * self.ty_stride

    def grid(self, width: int, tile_w: int) -> tuple[int, int]:
        """(tile columns, tile rows) of the band's shape."""
        ntx = self.ntx_band if self.ntx_band is not None else cdiv(width, tile_w)
        return ntx, self.nty_band


def vertex_stage(attrs: dict, uniforms: dict, shader, width: int, height: int,
                 geom: GeomSplit | None = None):
    """Vertex transform + triangle setup over all F triangles
    (main.cpp:660-665 + our_gl.cpp:89-135).  Returns (setup, varyings).

    With ``geom`` each rank transforms a contiguous slice of cdiv(F, N)
    triangles (zero-padded to N slices) and the slices are gathered in
    rank order and cut back to F (``_vertex_stage`` with ``geom_axis``).
    Every operation is per triangle, so the result equals the unsplit
    stage bitwise; with fewer triangles than ranks the stage is not
    split."""
    if geom is None or attrs["position"].shape[0] < geom.world:
        return _vertex_setup(attrs, uniforms, shader, width, height)
    f = attrs["position"].shape[0]
    chunk = cdiv(f, geom.world)
    pad = chunk * geom.world - f
    padded = {k: (torch.cat([v, v.new_zeros((pad,) + tuple(v.shape[1:]))]) if pad else v)
              for k, v in attrs.items()}
    names = {}

    def stage(r):
        setup, varyings = _vertex_setup({k: v[r * chunk:(r + 1) * chunk]
                                         for k, v in padded.items()},
                                        uniforms, shader, width, height)
        names["setup"], names["vary"] = sorted(setup), sorted(varyings)
        return ([setup[k] for k in names["setup"]]
                + [varyings[k] for k in names["vary"]])

    full = [t[:f] for t in geom.gather(stage(geom.rank), stage)]
    n_setup = len(names["setup"])
    return (dict(zip(names["setup"], full[:n_setup])),
            dict(zip(names["vary"], full[n_setup:])))


def _vertex_setup(attrs: dict, uniforms: dict, shader, width: int, height: int):
    clip, varyings = shaders.vertex(shader, uniforms, attrs)
    pos = attrs["position"]
    vp = torch.as_tensor(math3d.viewport(0, 0, width, height),
                         dtype=pos.dtype, device=pos.device)
    return semantics.triangle_setup_planes(clip, vp, width, height), varyings


def tile_spans(setup: dict, tile_w: int, tile_h: int, ty_lo=None, ty_hi=None,
               tx_lo=None, tx_hi=None, ty_stride: int = 1):
    """Per-triangle tile range from the clamped bbox (``_tile_spans``).
    Returns (tx0, ty0, span_x, span_y, spans) int32 (F,); spans = span_x *
    span_y pairs, zero for rejected triangles.

    ``ty_lo``/``ty_hi`` and ``tx_lo``/``tx_hi`` (inclusive) clip the range
    to a block of the grid, and tx0/ty0 are then block-local.  With
    ``ty_stride`` > 1 the block owns the interleaved rows ty_lo, ty_lo +
    stride, ..., ``ty_hi`` is the last one's index in stride units, and
    owned rows are consecutive in block-local space, so ``build_bins`` and
    ``tile_pair_counts`` do not change."""
    bbox = setup["bbox"]
    valid = setup["valid"]
    tx0 = torch.div(bbox[:, 0], tile_w, rounding_mode="floor")
    tx1 = torch.div(bbox[:, 1], tile_w, rounding_mode="floor")
    ty0 = torch.div(bbox[:, 2], tile_h, rounding_mode="floor")
    ty1 = torch.div(bbox[:, 3], tile_h, rounding_mode="floor")
    zero = torch.zeros_like(tx0)
    if ty_lo is not None and ty_stride > 1:
        m0 = torch.div(torch.clamp(ty0 - ty_lo, min=0) + (ty_stride - 1), ty_stride,
                       rounding_mode="floor")
        m1 = torch.clamp(torch.div(ty1 - ty_lo, ty_stride, rounding_mode="floor"), max=ty_hi)
        span_y = torch.where(valid & (m1 >= m0), m1 - m0 + 1, zero)
        ty0 = m0
    elif ty_lo is not None:
        ty0c = torch.clamp(ty0, min=ty_lo)
        ty1c = torch.clamp(ty1, max=ty_hi)
        span_y = torch.where(valid & (ty1c >= ty0c), ty1c - ty0c + 1, zero)
        ty0 = ty0c - ty_lo
    else:
        span_y = torch.where(valid, ty1 - ty0 + 1, zero)
    if tx_lo is not None:
        tx0c = torch.clamp(tx0, min=tx_lo)
        tx1c = torch.clamp(tx1, max=tx_hi)
        span_x = torch.where(valid & (tx1c >= tx0c), tx1c - tx0c + 1, zero)
        tx0 = tx0c - tx_lo
    else:
        span_x = torch.where(valid, tx1 - tx0 + 1, zero)
    spans = torch.where(span_y > 0, span_x, zero) * span_y
    return tx0, ty0, span_x, span_y, spans


def band_spans(setup: dict, tile_w: int, tile_h: int, width: int, height: int,
               band: Band | None = None, span_w: int | None = None):
    """``tile_spans`` at ``span_w``-px columns (the tile's width, or a
    strip of it) over a band's window, or over every tile without a band,
    as the JAX pre-stages clip it -> (spans, (columns, rows) of the grid in
    ``span_w`` units)."""
    span_w = span_w or tile_w
    per_tile = tile_w // span_w
    if band is None:
        return (tile_spans(setup, span_w, tile_h),
                (cdiv(width, tile_w) * per_tile, cdiv(height, tile_h)))
    ntx, nty = band.grid(width, tile_w)
    ty_hi = (nty - 1 if band.ty_stride > 1
             else band.ty_lo + ((band.ty_rows if band.ty_rows is not None else nty) - 1))
    tx_lo = tx_hi = None
    if band.tx_lo is not None:
        tx_lo = band.tx_lo * per_tile
        tx_hi = tx_lo + ntx * per_tile - 1
    return (tile_spans(setup, span_w, tile_h, band.ty_lo, ty_hi, tx_lo, tx_hi, band.ty_stride),
            (ntx * per_tile, nty))


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
