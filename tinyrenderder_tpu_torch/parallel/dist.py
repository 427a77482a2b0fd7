"""Multi-rank rendering over ``torch.distributed``: the frame's tile rows
(or screen blocks), or each pass's faces, split over the ranks of a
process group.

Counterpart of the row-band, block and triangle-sharded backends of
``tinyrenderder_tpu/parallel/dist.py`` (``render_frame_fused_sharded``,
``render_frame_fused_image_sharded`` and their untile helpers, the
partition helpers of measured bands, ``render_frame_geometry_tiles``).
There ``shard_map`` runs the fused frame once per device of a mesh; here
each rank of a process group runs the same band body,
``raster_sparse.render_frame_fused`` (or the image route) with a
``raster_tiled.Band``:

  * every rank bins the triangles against its own band of the tile grid
    only and rasterizes its tiles at their global pixels (the band's
    origin and, for interleaved bands, its row stride);
  * a pixel has one owner, so the render itself needs no collective; the
    vertex stage is split over the ranks and gathered in submission order
    (``geom_shard``, bitwise equal to the unsplit stage);
  * the ranks' band tiles are gathered with ``all_gather`` (NCCL on CUDA
    ranks, gloo on CPU ranks), in rank order, and every rank assembles the
    frame: each band untiled on its own (``untile3_image``, ``untile_one``
    or the image route's placement), then the rows put in global order.

Layouts (``Mesh``, the JAX package's meshes): contiguous row bands, the
interleaved rows of ``interleave`` (rank b owns tile rows b, b + N, ...),
measured bands of unequal height (``bands``, from ``balance_bands`` or
``even_unequal_bands``) under one static band shape, and 2-D screen
blocks on a grid (``make_mesh_grid``).  All give the single-rank frame
bitwise.  A frame whose height is not a multiple of N tile rows (or not
tile-aligned at all) renders as the tiled route tiles it, ``cdiv`` tiles
cropped; the JAX package sends such a frame to its XLA scan instead.

A mesh of N ranks can also be emulated in one process
(``emulated_mesh``): each rank's body (``render_rank``) runs in turn on
the one device and the gathers are concatenations.  The tests and
``chip_smoke.py`` use it, as the JAX tests use virtual CPU devices; NCCL
refuses two ranks on one GPU.

The triangle-sharded frame (``render_frame_geometry_tiles``, the JAX
package's function of that name) splits the other way: per-triangle work,
for high-poly scenes at small frames.  Rank r takes the contiguous,
submission-ordered block of each pass's faces ``face_block`` gives it,
bins it over every tile of the frame and rasterizes it on +inf tiles with
the coarse raster (``geometry_rank``), whatever ``FINE_MODE`` says.  The
ranks' pass-local full-frame planes merge exactly
(``render_pass_geometry_tiles``): depth is the all-reduce min, the winner
the least global face id among the ranks that reach that depth (the
first-drawn rule, our_gl.cpp:165) and the colour an all-reduce sum with
exactly one contributor a pixel.  The frame is replicated on every rank.

Each rank reads back its totals once per pass, as the single-rank route
does, so the JAX package's capacity cache, its async capacity bookkeeping
and its overflow flags have no counterpart here: the first frame after a
camera move is exact.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace

import numpy as np
import torch
import torch.distributed as tdist

from tinyrenderder_tpu_torch import convert
from tinyrenderder_tpu_torch.ops import raster_sparse
from tinyrenderder_tpu_torch.ops.raster import FrameBuffers
from tinyrenderder_tpu_torch.ops.raster_coarse import coarse_raster
from tinyrenderder_tpu_torch.ops.raster_sparse import FrameTiles, PassEvents
from tinyrenderder_tpu_torch.ops.raster_tiled import (TILE_H, TILE_W, Band, GeomSplit, cdiv,
                                                      n_vary_of, vertex_stage)

__all__ = ["Mesh", "make_mesh", "make_mesh_grid", "emulated_mesh", "broadcast_from_rank0",
           "barrier", "band_of", "render_rank",
           "render_frame_fused_sharded", "render_frame_fused_image_sharded",
           "tiles_to_buffers_sharded", "untile_one_sharded", "blocks_to_flat_tiles",
           "even_unequal_bands", "balance_bands", "measure_tile_row_costs",
           "measure_tile_row_costs_device", "face_block", "geometry_rank",
           "render_pass_geometry_tiles", "render_frame_geometry_tiles"]


@dataclass(frozen=True)
class Mesh:
    """The ranks a frame is split over: ``n_rows`` x ``n_cols`` of them,
    row-major (rank = row * n_cols + col).  ``two_d``: the frame is split
    into screen blocks (the JAX package's ('ty', 'tx') mesh); else into
    row bands.  ``rank`` is this process's rank in the default process
    group, or None when one process emulates every rank in turn.
    ``device``: where this process renders."""

    n_rows: int
    n_cols: int
    device: torch.device
    rank: int | None = 0
    two_d: bool = False

    @property
    def size(self) -> int:
        return self.n_rows * self.n_cols

    def as_rows(self) -> Mesh:
        """The same ranks as row bands."""
        return replace(self, n_rows=self.size, n_cols=1, two_d=False)

    def as_grid(self, n_rows: int, n_cols: int) -> Mesh:
        """The same ranks as an ``n_rows`` x ``n_cols`` grid of blocks."""
        if n_rows * n_cols != self.size:
            raise ValueError(f"a {n_rows}x{n_cols} grid is not {self.size} ranks")
        return replace(self, n_rows=n_rows, n_cols=n_cols, two_d=True)


def _rank_device(device, rank: int) -> torch.device:
    """Where a rank renders: ``cuda:<local rank>`` by default (the
    ``LOCAL_RANK`` that torchrun sets, else the rank modulo the cards), or
    the device asked for.  Raises without a card unless the CPU is asked
    for."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("a rank renders on its GPU and none is available; "
                           "pass device='cpu' to render on the CPU")
    if device is not None and torch.device(device).index is not None:
        return torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def make_mesh(n: int | None = None, device=None) -> Mesh:
    """The row-band mesh of the initialised process group's ranks (all of
    them: ``n``, if given, must be the world size), or of one rank when no
    process group is initialised (the JAX package's one-device mesh).
    ``device``: see ``_rank_device``."""
    if tdist.is_available() and tdist.is_initialized():
        world, rank = tdist.get_world_size(), tdist.get_rank()
        if n is not None and n != world:
            raise ValueError(f"requested {n} ranks, the process group has {world}")
        return Mesh(world, 1, _rank_device(device, rank), rank)
    if n is not None and n != 1:
        raise ValueError(f"requested {n} ranks, have 1 (no process group is initialised)")
    return Mesh(1, 1, _rank_device(device, 0), 0)


def make_mesh_grid(n_rows: int, n_cols: int, device=None) -> Mesh:
    """The process group's ranks as an ``n_rows`` x ``n_cols`` grid of
    screen blocks."""
    return make_mesh(n_rows * n_cols, device).as_grid(n_rows, n_cols)


def emulated_mesh(n_rows: int, n_cols: int = 1, device="cuda") -> Mesh:
    """``n_rows`` x ``n_cols`` ranks emulated in this process on
    ``device`` (a grid of blocks when ``n_cols`` > 1, else row bands):
    each rank's body runs in turn, and a gather is the concatenation of
    the ranks' tensors."""
    return Mesh(n_rows, n_cols, convert.device_key(device), None, n_cols > 1)


# ---------------------------------------------------------------------------
# the ranks' collectives
# ---------------------------------------------------------------------------

def _all_gather(mesh: Mesh, tensors) -> list[list[torch.Tensor]]:
    """Every rank's ``tensors`` (the same shapes on every rank), in rank
    order: -> [rank][i].  Bool tensors travel as uint8."""
    if mesh.size == 1:
        return [list(tensors)]
    out = []
    for t in tensors:
        x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(x) for _ in range(mesh.size)]
        tdist.all_gather(parts, x)
        out.append([p.to(torch.bool) for p in parts] if t.dtype == torch.bool else parts)
    return [list(col) for col in zip(*out)]


def _all_reduce(mesh: Mesh, xs, op: str) -> torch.Tensor:
    """The element-wise ``op`` ("min" or "sum") over the ranks: on a process
    group ``xs`` holds this rank's one tensor, reduced by ``all_reduce``
    (NCCL on CUDA ranks, gloo on CPU ranks); on an emulated mesh it holds
    every rank's, in rank order."""
    if mesh.rank is not None and mesh.size > 1:
        (x,) = xs
        out = x.clone()
        tdist.all_reduce(out, tdist.ReduceOp.MIN if op == "min" else tdist.ReduceOp.SUM)
        return out
    out = xs[0]
    for x in xs[1:]:
        out = torch.minimum(out, x) if op == "min" else out + x
    return out


def broadcast_from_rank0(mesh: Mesh, obj):
    """Rank 0's ``obj`` on every rank of a process group
    (``broadcast_object_list``: NCCL on CUDA ranks, gloo on CPU ranks); on
    an emulated mesh or a world of one rank, ``obj``."""
    if mesh.rank is None or mesh.size == 1:
        return obj
    box = [obj]
    tdist.broadcast_object_list(box, src=0, device=mesh.device)
    return box[0]


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of a process group gets here; nothing on an
    emulated mesh or a world of one rank."""
    if mesh.rank is not None and mesh.size > 1:
        tdist.barrier(device_ids=[mesh.device.index] if mesh.device.type == "cuda" else None)


def _cat(xs, dim: int = 0):
    """``torch.cat``, without the copy of a lone tensor (a world of one)."""
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim)


def _per_rank(mesh: Mesh, body) -> list:
    """``body(rank)`` -> a list of tensors, for every rank: run in turn on
    an emulated mesh, else this rank's, gathered.  -> [rank][i]."""
    if mesh.rank is None:
        return [body(r) for r in range(mesh.size)]
    return _all_gather(mesh, body(mesh.rank))


def _geom_split(mesh: Mesh, rank: int) -> GeomSplit:
    """The vertex stage split over the mesh's ranks for ``rank``."""
    if mesh.rank is None:
        def gather(mine, stage):
            parts = [mine if r == rank else stage(r) for r in range(mesh.size)]
            return [torch.cat(col) for col in zip(*parts)]
    else:
        def gather(mine, stage):
            return [torch.cat(col) for col in zip(*_all_gather(mesh, mine))]
    return GeomSplit(rank, mesh.size, gather)


# ---------------------------------------------------------------------------
# layouts
# ---------------------------------------------------------------------------

def _check_bands(bands, n, height, tile_h):
    if len(bands) != n:
        raise ValueError(f"bands has {len(bands)} entries for {n} devices")
    if height % tile_h:
        raise ValueError(f"height {height} not tile-aligned")
    nty = height // tile_h
    at = 0
    for lo, rows in bands:
        if lo != at or rows < 0:
            raise ValueError(f"bands must tile [0, {nty}) contiguously, "
                             f"got {bands}")
        at += rows
    if at != nty:
        raise ValueError(f"bands cover {at} of {nty} tile rows")


def _stable_band_cap(bands, nty: int, n: int) -> int:
    """The static band shape of an unequal partition: ceil(nty / n) when
    no band is longer (``even_unequal_bands`` always), else even + ~12.5%
    (``balance_bands``' default cap), else the longest band.  The port
    compiles nothing per shape, so a partition that moves across the even
    boundary only resizes a frame's buffers."""
    even = -(-nty // n)
    mx = max(r for _, r in bands)
    if mx <= even:
        return even
    cap = even + max(1, even // 8)
    return cap if mx <= cap else mx


def even_unequal_bands(nty: int, n: int) -> tuple:
    """Measurement-free near-even contiguous partition: the first
    nty % n bands get one extra row."""
    base, extra = divmod(nty, n)
    bands = []
    at = 0
    for b in range(n):
        rows = base + (1 if b < extra else 0)
        bands.append((at, rows))
        at += rows
    return tuple(bands)


def balance_bands(row_costs, n: int, band_cap: int | None = None) -> tuple:
    """Optimal contiguous min-max partition of the tile rows into ``n``
    bands (linear-partition DP over the measured per-row costs), each at
    most ``band_cap`` rows (default ceil(nty / n) + max(1, ceil / 8)).
    Returns ((lo, rows), ...) per rank."""
    costs = np.asarray(row_costs, np.float64)
    nty = len(costs)
    even = -(-nty // n)
    cap = (band_cap if band_cap is not None
           else even + max(1, even // 8))
    cap = max(cap, even)               # feasibility: n bands must cover
    prefix = np.concatenate([[0.0], np.cumsum(costs)])
    inf = float("inf")
    dp = np.full(nty + 1, inf)
    dp[0] = 0.0
    cut = np.zeros((n + 1, nty + 1), np.int32)
    for b in range(1, n + 1):
        ndp = np.full(nty + 1, inf)
        for i in range(nty + 1):
            j0 = max(0, i - cap)
            cand = np.maximum(dp[j0:i + 1], prefix[i] - prefix[j0:i + 1])
            k = int(np.argmin(cand))
            ndp[i] = cand[k]
            cut[b][i] = j0 + k
        dp = ndp
    bands = []
    i = nty
    for b in range(n, 0, -1):
        j = int(cut[b][i])
        bands.append((j, i - j))
        i = j
    bands.reverse()
    return tuple(bands)


def _band_row_map(bands, band_cap: int, tile_h: int, height: int) -> np.ndarray:
    """(H,) gather indices: global pixel row -> its row in the
    rank-concatenated (n * band_cap * tile_h, W) padded output."""
    src = np.empty(height, np.int64)
    for b, (lo, rows) in enumerate(bands):
        for t in range(rows):
            g0 = (lo + t) * tile_h
            s0 = (b * band_cap + t) * tile_h
            src[g0:g0 + tile_h] = np.arange(s0, s0 + tile_h)
    return src


def _row_costs(attrs, uniforms, shader, width, height, tile_h, tile_w):
    """(nty,) int32 pair count per tile row of one pass: the clamped bbox
    the binning uses, accumulated as a difference array over rows."""
    setup, _ = vertex_stage(attrs, uniforms, shader, width, height)
    nty = cdiv(height, tile_h)
    tx0, tx1, ty0, ty1 = (torch.div(setup["bbox"][:, i], s, rounding_mode="floor")
                          for i, s in enumerate((tile_w, tile_w, tile_h, tile_h)))
    ok = setup["valid"] & (ty1 >= ty0) & (tx1 >= tx0)
    add = torch.where(ok, tx1 - tx0 + 1, torch.zeros_like(tx0)).to(torch.int32)
    diff = torch.zeros(nty + 1, dtype=torch.int32, device=add.device)
    diff.index_add_(0, torch.clamp(ty0, 0, nty).long(), add)        # integer: exact
    diff.index_add_(0, torch.clamp(ty1 + 1, 0, nty).long(), -add)
    return torch.cumsum(diff, 0, dtype=torch.int32)[:nty]


def measure_tile_row_costs_device(passes, width: int, height: int,
                                  tile_h: int | None = None, tile_w: int | None = None):
    """(nty,) int32 per-tile-row pair counts summed over the passes, on the
    passes' device."""
    total = None
    for attrs, shader, uniforms, *_ in passes:
        costs = _row_costs(attrs, uniforms, shader, width, height, tile_h or TILE_H,
                           tile_w or TILE_W)
        total = costs if total is None else total + costs
    return total


def measure_tile_row_costs(passes, width: int, height: int, tile_h: int | None = None,
                           tile_w: int | None = None) -> np.ndarray:
    """``measure_tile_row_costs_device`` read back: the ``balance_bands``
    input, as int64."""
    return measure_tile_row_costs_device(passes, width, height, tile_h,
                                         tile_w).cpu().numpy().astype(np.int64)


def _check_layout(mesh: Mesh, width: int, height: int, tile_h: int, tile_w: int,
                  interleave: bool, bands) -> None:
    ntx, nty = cdiv(width, tile_w), cdiv(height, tile_h)
    if mesh.two_d and interleave:
        raise ValueError("interleave is only supported on 1-D row meshes")
    if bands is not None:
        if mesh.two_d or interleave:
            raise ValueError("bands needs a 1-D row mesh without interleave")
        _check_bands(bands, mesh.size, nty * tile_h, tile_h)
    elif nty % mesh.n_rows:
        raise ValueError(f"{nty} tile rows of {tile_h} (height {height}) do not divide "
                         f"into {mesh.n_rows} bands")
    if ntx % mesh.n_cols:
        raise ValueError(f"{ntx} tile columns of {tile_w} (width {width}) do not divide "
                         f"into {mesh.n_cols} blocks")


def _band_shape(mesh: Mesh, width: int, height: int, tile_h: int, tile_w: int,
                bands) -> tuple[int, int]:
    """(tile columns, tile rows) of every rank's band."""
    ntx, nty = cdiv(width, tile_w), cdiv(height, tile_h)
    if bands is not None:
        return ntx, _stable_band_cap(bands, nty, mesh.size)
    return ntx // mesh.n_cols, nty // mesh.n_rows


def band_of(mesh: Mesh, rank: int, width: int, height: int, tile_h: int = TILE_H,
            tile_w: int = TILE_W, interleave: bool = False, bands=None,
            geom_shard: bool = False) -> Band:
    """``rank``'s band of the frame's tile grid (the band arguments the
    JAX package's shard bodies pass ``_fused_frame_body``)."""
    bntx, bnty = _band_shape(mesh, width, height, tile_h, tile_w, bands)
    geom = _geom_split(mesh, rank) if geom_shard and mesh.size > 1 else None
    if mesh.two_d:
        iy, ix = divmod(rank, mesh.n_cols)
        return Band(iy * bnty, bnty, 1, ix * bntx, bntx, geom=geom)
    if bands is not None:
        lo, rows = bands[rank]
        return Band(lo, bnty, ty_rows=rows, geom=geom)
    if interleave:
        return Band(rank, bnty, mesh.size, geom=geom)
    return Band(rank * bnty, bnty, geom=geom)


# ---------------------------------------------------------------------------
# the frame
# ---------------------------------------------------------------------------

def render_rank(mesh: Mesh, rank: int, passes, width: int, height: int,
                tile_h: int = TILE_H, tile_w: int = TILE_W, interleave: bool = False,
                geom_shard: bool = True, bands=None, collect_stats: bool = False):
    """The body one rank runs: ``raster_sparse.render_frame_fused`` over
    ``rank``'s band (``band_of``) -> (the band's FrameTiles, its output
    depth tiles, its per-pass events or None).  Callable for any rank of
    an emulated mesh; on a process group's mesh, for its own rank (the
    split vertex stage gathers from every rank)."""
    band = band_of(mesh, rank, width, height, tile_h, tile_w, interleave, bands, geom_shard)
    return raster_sparse.render_frame_fused(passes, width, height, mesh.device, tile_h,
                                            tile_w, collect_stats, band)


def _pack_events(events) -> torch.Tensor:
    """(P, 3) float64: each pass's fragments, min z and max z (exact)."""
    if not events:
        return torch.zeros((0, 3), dtype=torch.float64)
    return torch.stack([torch.stack([e.fragments.double(), e.min_z.double(), e.max_z.double()])
                        for e in events])


def render_frame_fused_sharded(mesh: Mesh, passes, width: int, height: int,
                               tile_h: int | None = None, tile_w: int | None = None,
                               interleave: bool = False, geom_shard: bool = True,
                               bands: tuple | None = None, collect_stats: bool = False):
    """Render a multi-pass frame with its tile rows (or screen blocks)
    split over ``mesh``'s ranks.  ``passes`` as
    ``raster_sparse.render_frame_fused`` takes them, on the mesh's device.

    Returns (FrameTiles, output depth tiles, events): every rank's band
    tiles in rank order (pass the same layout arguments to
    ``tiles_to_buffers_sharded`` / ``untile_one_sharded``; on a grid,
    ``blocks_to_flat_tiles`` gives the single-rank tile order), on every
    rank.  ``events`` (``collect_stats``): one ``PassEvents`` per pass with
    faces, its counters reduced over the ranks (fragments summed, the z
    range's min and max) and the whole pass's setup; else None.

    ``interleave``: rank b owns tile rows b, b + N, ... (1-D meshes).
    ``bands``: each rank's (first tile row, row count), contiguous bands of
    unequal height under one static band shape (``_stable_band_cap``).
    ``geom_shard``: the vertex stage split over the ranks."""
    tile_h, tile_w = tile_h or TILE_H, tile_w or TILE_W
    _check_layout(mesh, width, height, tile_h, tile_w, interleave, bands)

    setups = []        # each pass's setup: the whole pass's, the same on every rank

    def body(rank):
        ft, od, events = render_rank(mesh, rank, passes, width, height, tile_h, tile_w,
                                     interleave, geom_shard, bands, collect_stats)
        setups[:] = [e.setup for e in events or ()]
        return [*ft, od] + ([_pack_events(events).to(mesh.device)] if collect_stats else [])

    parts = _per_rank(mesh, body)
    ft = FrameTiles(*(_cat([p[i] for p in parts]) for i in range(3)))
    out_depth = _cat([p[3] for p in parts])
    if not collect_stats:
        return ft, out_depth, None
    ev = torch.stack([p[4] for p in parts])                      # (ranks, P, 3)
    frags, min_z, max_z = ev[..., 0].sum(0), ev[..., 1].amin(0), ev[..., 2].amax(0)
    events = [PassEvents(setup, frags[i].to(torch.int64), min_z[i].to(torch.float32),
                         max_z[i].to(torch.float32)) for i, setup in enumerate(setups)]
    return ft, out_depth, events


def render_frame_fused_image_sharded(mesh: Mesh, passes, width: int, height: int,
                                     tile_h: int | None = None, tile_w: int | None = None,
                                     interleave: bool = False, geom_shard: bool = True,
                                     bands: tuple | None = None):
    """One colour pass straight to the (H, W, 3) uint8 image with its tile
    rows split over a 1-D ``mesh``: each rank renders its band's rows
    through the image route (``render_frame_fused_image`` with its band),
    the rows are gathered in rank order, put in global order and
    cropped."""
    tile_h, tile_w = tile_h or TILE_H, tile_w or TILE_W
    if mesh.two_d:
        raise ValueError("render_frame_fused_image_sharded needs a 1-D row mesh (make_mesh)")
    if len(passes) != 1:
        raise ValueError("render_frame_fused_image_sharded takes exactly one pass")
    _check_layout(mesh, width, height, tile_h, tile_w, interleave, bands)
    rows = _per_rank(mesh, lambda rank: [raster_sparse.render_frame_fused_image(
        passes, width, height, tile_h, tile_w,
        band=band_of(mesh, rank, width, height, tile_h, tile_w, interleave, bands,
                     geom_shard))])
    return _assemble(mesh, [r[0] for r in rows], width, height, tile_h, tile_w,
                     interleave, bands)


def _deinterleave_rows(x, n: int, band_nty: int, tile_h: int):
    """Rank-major row blocks -> globally interleaved tile rows: rank b's
    block holds global tile rows b, b + n, ..."""
    t = x.reshape((n, band_nty, tile_h) + tuple(x.shape[1:]))
    return t.movedim(0, 1).reshape(x.shape)


def _assemble(mesh: Mesh, blocks, width: int, height: int, tile_h: int, tile_w: int,
              interleave: bool, bands):
    """The ranks' image-layout band blocks (rank order) -> the (H, W, ...)
    frame: blocks side by side on a grid, else stacked, interleaved rows
    put in global order, measured bands' dead rows dropped, cropped."""
    if mesh.two_d:
        x = _cat([_cat(blocks[r * mesh.n_cols:(r + 1) * mesh.n_cols], dim=1)
                  for r in range(mesh.n_rows)])
    else:
        x = _cat(blocks)
    nty = cdiv(height, tile_h)
    if interleave:
        x = _deinterleave_rows(x, mesh.size, nty // mesh.size, tile_h)
    elif bands is not None:
        cap = _stable_band_cap(bands, nty, mesh.size)
        x = x[torch.from_numpy(_band_row_map(bands, cap, tile_h, nty * tile_h)).to(x.device)]
    return x[:height, :width].contiguous()


def _bands_of_tiles(mesh: Mesh, x, width: int, height: int, tile_h: int, tile_w: int,
                    bands):
    """Split the rank-ordered tile axis of ``x`` into each rank's band."""
    bntx, bnty = _band_shape(mesh, width, height, tile_h, tile_w, bands)
    return bntx, bnty, x.split(bntx * bnty)


def tiles_to_buffers_sharded(mesh: Mesh, ft: FrameTiles, width: int, height: int,
                             tile_h: int | None = None, tile_w: int | None = None,
                             interleave: bool = False, bands: tuple | None = None
                             ) -> FrameBuffers:
    """The rank-ordered FrameTiles of ``render_frame_fused_sharded`` ->
    (H, W) buffers: each rank's band through ``untile3_image`` (one
    launch of the three-plane kernel a band), then assembled."""
    tile_h, tile_w = tile_h or TILE_H, tile_w or TILE_W
    _check_layout(mesh, width, height, tile_h, tile_w, interleave, bands)
    bntx, bnty, color = _bands_of_tiles(mesh, ft.color, width, height, tile_h, tile_w, bands)
    depth, winner = ft.depth.split(bntx * bnty), ft.winner.split(bntx * bnty)
    planes = [raster_sparse.untile3_image(c, d, w, bntx, bnty, tile_h, tile_w, bnty * tile_h,
                                          bntx * tile_w)
              for c, d, w in zip(color, depth, winner)]
    return FrameBuffers(*(_assemble(mesh, [p[i] for p in planes], width, height, tile_h,
                                    tile_w, interleave, bands) for i in range(3)))


def untile_one_sharded(mesh: Mesh, tiles, width: int, height: int,
                       tile_h: int | None = None, tile_w: int | None = None,
                       interleave: bool = False, bands: tuple | None = None):
    """One rank-ordered tile plane (e.g. the output depth of a frame that
    ends inside an excluded run) -> (H, W): each band through
    ``untile_one``, then assembled."""
    tile_h, tile_w = tile_h or TILE_H, tile_w or TILE_W
    _check_layout(mesh, width, height, tile_h, tile_w, interleave, bands)
    bntx, bnty, parts = _bands_of_tiles(mesh, tiles, width, height, tile_h, tile_w, bands)
    return _assemble(mesh, [raster_sparse.untile_one(p, bntx, bnty, tile_h, tile_w)
                            for p in parts], width, height, tile_h, tile_w, interleave, bands)


def blocks_to_flat_tiles(x, width: int, height: int, n_rows: int, n_cols: int,
                         tile_h: int, tile_w: int):
    """Reorder a grid's rank-ordered block tiles into the single-rank
    row-major tile order (for comparisons)."""
    ntx = width // tile_w
    nty = height // tile_h
    band_ty = nty // n_rows
    band_tx = ntx // n_cols
    t = torch.arange(nty * ntx, device=x.device)
    ty, tx = t // ntx, t % ntx
    dev = (ty // band_ty) * n_cols + (tx // band_tx)
    local = (ty % band_ty) * band_tx + (tx % band_tx)
    return x[dev * (band_ty * band_tx) + local]


# ---------------------------------------------------------------------------
# the triangle-sharded frame
# ---------------------------------------------------------------------------

#: the merge's "no candidate" face id: above every face id of a frame
_GEOM_BIG = 1 << 30


def face_block(n_faces: int, n_ranks: int, rank: int) -> tuple[int, int]:
    """[lo, hi) of ``rank``'s contiguous block of ``n_faces`` faces: blocks
    of ceil(max(F, 1) / N) faces in rank order, the last ones short or
    empty.  The JAX package pads the faces to N blocks with degenerate
    ones instead; the face ids come out the same."""
    size = cdiv(max(n_faces, 1), n_ranks)
    return min(rank * size, n_faces), min((rank + 1) * size, n_faces)


def geometry_rank(mesh: Mesh, rank: int, attrs: dict, shader, uniforms: dict, width: int,
                  height: int, tile_h: int = TILE_H, tile_w: int = TILE_W):
    """The body ``rank`` runs for one pass of the triangle-sharded frame:
    its block of the faces (``face_block``) through ``pre_sparse`` over
    every tile of the frame and the coarse raster on +inf tiles, scattered
    into pass-local full-frame planes -> (FrameTiles, the block's first
    face id).  Depth is +inf, the winner (the block's own face id) -1 and
    the packed colour 0 where the block draws nothing; a depth-only pass
    shades nothing.  An empty block launches nothing."""
    lo, hi = face_block(attrs["position"].shape[0], mesh.size, rank)
    ft = raster_sparse.new_frame_tiles(width, height, mesh.device, tile_h, tile_w)
    if hi == lo:
        return ft, lo
    block = {k: v[lo:hi] for k, v in attrs.items()}
    pre = raster_sparse.pre_sparse(block, uniforms, shader, width, height, tile_h, tile_w)
    init = torch.full((pre.n_active, tile_h, tile_w), torch.inf, dtype=torch.float32,
                      device=mesh.device)
    depth_c, winner_c, vary_c = coarse_raster(pre.tri_rec, pre.sorted_tri, pre.ids, pre.start,
                                              pre.counts, init, cdiv(width, tile_w), tile_h,
                                              tile_w, n_vary_of(shader))
    idl = pre.ids.long()
    ft.depth.index_copy_(0, idl, depth_c)
    ft.winner.index_copy_(0, idl, winner_c)
    if shader.writes_color:
        ft.color.index_copy_(0, idl, raster_sparse.shade_compact_fresh(winner_c, vary_c,
                                                                       uniforms, shader))
    return ft, lo


def render_pass_geometry_tiles(mesh: Mesh, ft: FrameTiles, attrs: dict, shader,
                               uniforms: dict, width: int, height: int, winner_offset: int = 0,
                               tile_h: int = TILE_H, tile_w: int = TILE_W) -> FrameTiles:
    """One pass with its faces split over ``mesh``'s ranks, merged into
    the replicated frame ``ft`` (not written in place) -> the new frame.
    Each rank runs ``geometry_rank`` (every rank in turn on an emulated
    mesh); the merge is the JAX package's, exact:

      depth   the all-reduce min ``zmin``, where it beats the frame's;
      winner  the all-reduce min of the global ids (block id + the block's
              first face) of the ranks whose depth is ``zmin`` there: the
              first-drawn of the pass's faces at that depth;
      colour  the all-reduce sum of each rank's packed colour where it
              holds that winner (one rank does), 0 elsewhere.

    A depth-only pass keeps the frame's colour and makes only the two min
    reductions.  A pass with no faces renders nothing."""
    if attrs["position"].shape[0] == 0:
        return ft
    ranks = range(mesh.size) if mesh.rank is None else (mesh.rank,)
    parts = [geometry_rank(mesh, r, attrs, shader, uniforms, width, height, tile_h, tile_w)
             for r in ranks]
    zmin = _all_reduce(mesh, [p.depth for p, _ in parts], "min")
    better = zmin < ft.depth
    cand = [torch.where((p.winner >= 0) & (p.depth == zmin) & better, p.winner + lo, _GEOM_BIG)
            for p, lo in parts]
    gwin = _all_reduce(mesh, cand, "min")
    drawn = better & (gwin < _GEOM_BIG)
    depth = torch.where(better, zmin, ft.depth)
    winner = torch.where(drawn, gwin + winner_offset, ft.winner)
    if not shader.writes_color:
        return FrameTiles(ft.color, depth, winner)
    color = _all_reduce(mesh, [torch.where(drawn & (c == gwin), p.color, 0)
                               for (p, _), c in zip(parts, cand)], "sum")
    return FrameTiles(torch.where(drawn, color, ft.color), depth, winner)


def render_frame_geometry_tiles(mesh: Mesh, passes, width: int, height: int,
                                tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Render a multi-pass frame with each pass's faces split over
    ``mesh``'s ranks (``render_pass_geometry_tiles``) -> (FrameTiles,
    output depth tiles), replicated on every rank.  ``passes`` as
    ``raster_sparse.render_frame_fused`` takes them, on the mesh's device,
    walked by ``raster_sparse.walk_passes`` (winner ids run on over the
    passes; the excluded passes' snapshot and restore, no copy: a pass
    makes a new frame); the output depth is the snapshot when the frame
    ends inside an excluded run.  A frame that is not tile-aligned renders
    on ``cdiv`` tiles; crop after the untile."""
    ft = raster_sparse.new_frame_tiles(width, height, mesh.device, tile_h, tile_w)
    return raster_sparse.walk_passes(
        ft, passes, lambda ft, attrs, shader, uniforms, offset: render_pass_geometry_tiles(
            mesh, ft, attrs, shader, uniforms, width, height, offset, tile_h, tile_w), False)
