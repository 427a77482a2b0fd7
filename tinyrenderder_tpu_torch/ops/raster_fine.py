"""Strip raster over compacted active tiles: the pre-stage, the CUDA
kernels ``csrc/raster_fine.cu`` (the split walk of ``raster_strip.cuh``)
and their plain PyTorch version.

Counterpart of ``tinyrenderder_tpu/ops/raster_fine.py``
(``_pre_fine_jit`` and ``_fine_kernel`` as launched by
``_fine_call_jit``, with and without ``collect_stats``).  Every 128-px
tile is cut into ``STRIPS`` strips of ``STRIP_W`` columns, and the
triangles are binned per strip, so a pixel only walks the triangles whose
bbox touches its own strip: on small triangles that is a fraction of the
tile's bin.

Pre-stage (``pre_fine``): strip bins (strip id ``8 * tile + k``, as in
``raster_fine.py:148-149``), ``rows_t`` = the largest of a tile's 8 strip
bins, and the interleaved slot table ``tri8`` (R, 8) int32 where slot
``(row_start[tile] + rank) * 8 + k`` holds strip k's rank-th triangle in
submission order and -1 marks an empty slot.  A strip's bin is a prefix
of its column.  Each pass reads back four integers, once (strip pair
total, row total, active-tile count, the largest tile's rows) and sizes
every buffer exactly from them; the TPU path's capacity cache and
overflow re-render have no counterpart.

Raster contract (shared by both versions, bitwise, and equal to the
coarse raster's outputs, so the post stage is shared):
  tri_rec     (F, 16 + 3V) f32 per-triangle rows (``raster_coarse``)
  tri8        (R, 8) i32 slot table
  tile_ids, row_start, rows  (A,) i32 active tiles and their row segments
  init_depth  (A, th, tw) f32 running depth per active tile
  -> depth (A, th, tw) f32, winner (A, th, tw) i32 (-1 = background),
     vary (A, V, th, tw) f32 (0 where no winner)
  with collect_stats, also the event planes (count i32, max z f32).

The CUDA kernels cut each tile's rows into ranges of ``range_rows(th)``
and merge them in order (``csrc/raster_strip.cuh``);
``fine_raster_split_plain`` is that decomposition in plain PyTorch, for
the tests.  A call given ``max_rows`` no larger than the range launches
the walk alone, one block a tile.

The TPU records (64 columns x 8 slots, slot-minor, ids as f32) are not
ported: a GPU reads the per-triangle row through ``tri8``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tinyrenderder_tpu_torch import _build
from tinyrenderder_tpu_torch.ops import semantics
from tinyrenderder_tpu_torch.ops.raster_coarse import (GEOM, build_tri_records,
                                                       check_inputs, interpolate_winners,
                                                       split_walks, tile_pixels, walk_items,
                                                       walk_scratch)
from tinyrenderder_tpu_torch.ops.raster_tiled import (TILE_H, TILE_W, active_ids,
                                                      build_bins, cdiv, shader_varyings,
                                                      tile_pair_counts, tile_spans,
                                                      vertex_stage)

__all__ = ["STRIP_W", "STRIPS", "MAX_VARY", "LAUNCHES", "STATS_LAUNCHES", "PreFine",
           "pre_fine", "range_rows", "fine_raster", "fine_raster_plain",
           "fine_raster_split_plain", "strip_raster_plain", "strip_raster_split_plain"]

STRIP_W = 16
STRIPS = TILE_W // STRIP_W       # 8 strips per 128-px tile
#: the JAX package's strip-record limit, (64 - 17) // 3: ``"auto"`` routes
#: a pass with more varying channels to the coarse raster, as there
MAX_VARY = 15
SUB_ROWS = 8                     # slot rows per step of the plain version
TILE_CHUNK = 64                  # tiles per step of the plain version (bounds memory)

#: wrapper calls that launched the kernels since the last reset (the CPU
#: path does not count), without and with the event planes
LAUNCHES = 0
STATS_LAUNCHES = 0


class PreFine(NamedTuple):
    """Strip pre-stage outputs.  ``ids`` are the active tile ids
    (a strip bin is non-empty), ascending; ``row_start``/``rows`` their
    row segments of ``tri8``."""
    tri_rec: torch.Tensor      # (F, 16 + 3V) f32
    tri8: torch.Tensor         # (R, 8) i32, -1 = empty slot
    ids: torch.Tensor          # (n_active,) i32
    row_start: torch.Tensor    # (n_active,) i32
    rows: torch.Tensor         # (n_active,) i32
    pairs: int                 # (strip, triangle) pairs
    row_total: int             # R
    n_active: int
    max_rows: int              # the largest of ``rows`` (0 without an active tile)
    setup: dict                # the triangle setup (valid, screen, ..., bbox)


def pre_fine(attrs: dict, uniforms: dict, shader, width: int, height: int,
             tile_h: int = TILE_H, tile_w: int = TILE_W) -> PreFine:
    """Vertex stage, strip binning, the slot table, per-triangle records
    and active-tile compaction (``_pre_fine_jit``).  Holds the pass's one
    host readback."""
    if tile_w != STRIPS * STRIP_W:
        raise ValueError(f"the strip raster takes {STRIPS * STRIP_W}-px tiles, not {tile_w}")
    setup, varyings = vertex_stage(attrs, uniforms, shader, width, height)
    n_tiles_x, n_tiles_y = cdiv(width, tile_w), cdiv(height, tile_h)
    n_tiles = n_tiles_x * n_tiles_y
    n_strips_x = n_tiles_x * STRIPS
    dev = setup["bbox"].device
    tx0, ty0, span_x, span_y, spans = tile_spans(setup, STRIP_W, tile_h)
    per_strip = tile_pair_counts(tx0, ty0, span_x, span_y, n_strips_x, n_tiles_y)
    rows_t = per_strip.view(n_tiles, STRIPS).amax(dim=1)
    pairs, row_total, n_active, max_rows = torch.stack(
        [per_strip.sum(), rows_t.sum(), (rows_t > 0).sum(), rows_t.max()]).tolist()
    sorted_tri, start, counts = build_bins(tx0, ty0, span_x, spans, pairs,
                                           n_strips_x, n_tiles_y)
    row_start_t = torch.cumsum(rows_t, 0, dtype=torch.int32) - rows_t

    # sorted pair q of strip s = 8 * tile + k goes to slot
    # (row_start[tile] + rank) * 8 + k, rank = q - start[s]
    n_strips = n_tiles * STRIPS
    strip = torch.repeat_interleave(torch.arange(n_strips, dtype=torch.int32, device=dev),
                                    counts, output_size=pairs).long()
    rank = torch.arange(pairs, dtype=torch.int32, device=dev) - start[strip]
    dst = (row_start_t[strip // STRIPS] + rank).long() * STRIPS + strip % STRIPS
    tri8 = torch.full((row_total * STRIPS,), -1, dtype=torch.int32, device=dev)
    tri8.scatter_(0, dst, sorted_tri)

    tri_rec = build_tri_records(setup, shader_varyings(varyings, shader))
    ids = active_ids(rows_t > 0, n_active)
    idl = ids.long()
    return PreFine(tri_rec, tri8.view(row_total, STRIPS), ids, row_start_t[idl].contiguous(),
                   rows_t[idl].contiguous(), pairs, row_total, n_active, max_rows, setup)


def range_rows(tile_h: int) -> int:
    """Slot rows of one range of the CUDA split walk at ``tile_h``-row
    tiles (the library's range area over the tile height)."""
    return _build.constant("trt_fine_range_area") // tile_h


def fine_raster(tri_rec, tri8, tile_ids, row_start, rows, init_depth, n_tiles_x: int,
                tile_h: int, tile_w: int, n_vary: int, origin=(0, 0),
                collect_stats: bool = False, max_rows: int | None = None):
    """Raster the active tiles strip by strip (contract in the module
    docstring).  Returns (depth, winner, vary), and ev as a fourth item
    with ``collect_stats``.  CPU tensors take the plain version; CUDA
    tensors launch the kernels: the split walk, or, where ``max_rows``
    (``rows.max()``, e.g. ``PreFine.max_rows``) is given and no larger
    than a range, the walk alone."""
    global LAUNCHES, STATS_LAUNCHES
    if tri8.dim() != 2 or tri8.shape[1] != STRIPS:
        raise ValueError(f"tri8 must be (R, {STRIPS}), got {tuple(tri8.shape)}")
    check_inputs(tri_rec, tri8, tile_ids, row_start, rows, init_depth, tile_h, tile_w,
                 n_vary, names=("tri8", "row_start", "rows"))
    if tile_w != STRIPS * STRIP_W:
        raise ValueError(f"the strip raster takes {STRIPS * STRIP_W}-px tiles, not {tile_w}")
    if tri_rec.device.type == "cpu":
        return fine_raster_plain(tri_rec, tri8, tile_ids, row_start, rows, init_depth,
                                 n_tiles_x, tile_h, tile_w, n_vary, origin, collect_stats)
    if tri_rec.device.type != "cuda":
        raise ValueError(f"no strip raster for device {tri_rec.device}")
    if tile_h not in (16, 32):
        raise ValueError(f"the CUDA kernel takes 16x128 or 32x128 tiles, "
                         f"not {tile_h}x{tile_w}")
    a = tile_ids.shape[0]
    dev = tri_rec.device
    depth = torch.empty((a, tile_h, tile_w), dtype=torch.float32, device=dev)
    winner = torch.empty((a, tile_h, tile_w), dtype=torch.int32, device=dev)
    vary = torch.empty((a, n_vary, tile_h, tile_w), dtype=torch.float32, device=dev)
    ev = (torch.empty_like(winner), torch.empty_like(depth)) if collect_stats else None
    out = (depth, winner, vary) + ((ev,) if collect_stats else ())
    if a == 0:
        return out
    r = range_rows(tile_h)
    if max_rows is not None and max_rows <= r:
        n_items, scratch = a, None
    else:
        n_items = walk_items(a, tri8.shape[0], r)
        scratch = walk_scratch(n_items, a, tile_h, dev)
    _build.call("trt_fine_raster", dev,
                tri_rec.data_ptr(), tri_rec.shape[1], tri8.data_ptr(), tile_ids.data_ptr(),
                row_start.data_ptr(), rows.data_ptr(), a, int(origin[0]), int(origin[1]), n_tiles_x,
                tile_h, tile_w, n_vary, init_depth.data_ptr(), depth.data_ptr(), winner.data_ptr(),
                vary.data_ptr() if n_vary else None, ev[0].data_ptr() if ev else None,
                ev[1].data_ptr() if ev else None, n_items,
                None if scratch is None else scratch.data_ptr())
    if collect_stats:
        STATS_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out


def fine_raster_plain(tri_rec, tri8, tile_ids, row_start, rows, init_depth,
                      n_tiles_x: int, tile_h: int, tile_w: int, n_vary: int,
                      origin=(0, 0), collect_stats: bool = False):
    """Plain PyTorch version: ``strip_raster_plain`` over the active
    tiles, each pixel at its tile's place on the screen."""
    return strip_raster_plain(
        tri_rec, tri8, row_start, rows, init_depth, n_vary, collect_stats,
        _tile_pixels(tile_ids, n_tiles_x, tile_h, tile_w, origin))


def fine_raster_split_plain(tri_rec, tri8, tile_ids, row_start, rows, init_depth,
                            n_tiles_x: int, tile_h: int, tile_w: int, n_vary: int,
                            origin=(0, 0), collect_stats: bool = False, range_len: int = 64):
    """``fine_raster_plain`` computed as the CUDA kernels split it, for the
    tests: ``strip_raster_split_plain`` over the active tiles, their rows
    cut into ranges of ``range_len``.  Equal to ``fine_raster_plain``
    bitwise."""
    return strip_raster_split_plain(
        tri_rec, tri8, row_start, rows, init_depth, n_vary, collect_stats,
        _tile_pixels(tile_ids, n_tiles_x, tile_h, tile_w, origin), range_len)


def _tile_pixels(tile_ids, n_tiles_x: int, tile_h: int, tile_w: int, origin):
    """pixels(c0, c1) of ``strip_raster_plain``: active tiles c0..c1's
    global pixel coordinates."""
    return lambda c0, c1: tile_pixels(tile_ids[c0:c1].long(), n_tiles_x, tile_h, tile_w,
                                      origin, torch.float32)


def strip_raster_plain(tri_rec, tri8, row_start, rows, init_depth, n_vary: int,
                       collect_stats: bool, pixels):
    """The strip rasters' plain version over output blocks of (th, tw)
    pixels, block b walking slot rows ``row_start[b] .. + rows[b]`` of
    ``tri8``; ``pixels(c0, c1)`` gives blocks c0..c1's global integer pixel
    coordinates as exact floats, x and y broadcastable to (C, 1, th, tw).
    Vectorised over blocks and SUB_ROWS-row steps and chunked over blocks;
    each pixel takes its own strip's slot of a row.  Loop 1 is the TPU
    kernel's form: per step, the first-minimum argmin over the step's rows,
    then a strict-less merge.  The event planes keep the TPU form too: a
    row is an event iff its z is below the exclusive cummin of the step's
    earlier rows and the running depth (raster_fine.py:356-374).  Loop 2
    is the coarse raster's."""
    dev = tri_rec.device
    a, tile_h, tile_w = init_depth.shape
    f32 = torch.float32
    depth = torch.empty((a, tile_h, tile_w), dtype=f32, device=dev)
    winner = torch.empty((a, tile_h, tile_w), dtype=torch.int32, device=dev)
    vary = torch.empty((a, n_vary, tile_h, tile_w), dtype=f32, device=dev)
    ev = ((torch.zeros_like(winner), torch.full_like(depth, -torch.inf))
          if collect_stats else None)
    out = (depth, winner, vary) + ((ev,) if collect_stats else ())
    if a == 0:
        return out
    n_rows = tri8.shape[0]
    strip_of_col = torch.arange(tile_w, device=dev) // STRIP_W            # (tw,)
    for c0 in range(0, a, TILE_CHUNK):
        c1 = min(a, c0 + TILE_CHUNK)
        st, cnt = row_start[c0:c1].long(), rows[c0:c1].long()
        x, y = pixels(c0, c1)
        px, py = x + 0.5, y + 0.5
        zbuf = init_depth[c0:c1].clone()
        wbuf = torch.full_like(zbuf, -1, dtype=torch.int32)
        for s in range(0, int(cnt.max()), SUB_ROWS):
            j = s + torch.arange(SUB_ROWS, device=dev)
            live = j[None, :] < cnt[:, None]                              # (C, SUB)
            idx = torch.clamp(st[:, None] + j[None, :], max=max(n_rows - 1, 0))
            slots = tri8[idx][..., strip_of_col]                          # (C, SUB, tw)
            slots = torch.where(live[..., None], slots, -1)
            tri = slots[:, :, None, :]                                    # (C, SUB, 1, tw)
            g = tri_rec[torch.clamp(tri, min=0).long(), :GEOM]            # (C, SUB, 1, tw, 16)
            b0, b1, b2, _ = semantics.barycentric(
                g[..., 0], g[..., 1], g[..., 2], g[..., 3], g[..., 4], g[..., 5], px, py)
            covered = semantics.coverage_mask(b0, b1, b2)
            z = semantics.affine_z(g[..., 6], g[..., 7], g[..., 8], b0, b1, b2)
            covered &= torch.isfinite(z)
            covered &= ((x >= g[..., 12]) & (x <= g[..., 13])
                        & (y >= g[..., 14]) & (y <= g[..., 15]))
            covered &= tri >= 0                                           # -1 = empty slot
            zc = torch.where(covered, z, torch.inf)
            if collect_stats:
                excl = torch.cat([torch.full_like(zc[:, :1], torch.inf),
                                  torch.cummin(zc, dim=1).values[:, :-1]], dim=1)
                events = zc < torch.minimum(excl, zbuf[:, None])
                ev[0][c0:c1] += events.sum(dim=1, dtype=torch.int32)
                ev[1][c0:c1] = torch.maximum(
                    ev[1][c0:c1], torch.where(events, zc, -torch.inf).amax(dim=1))
            zmin = torch.amin(zc, dim=1)
            best = torch.argmin(zc, dim=1, keepdim=True)   # first minimum on ties
            win = torch.gather(tri.expand_as(zc), 1, best)[:, 0]
            better = zmin < zbuf
            zbuf = torch.where(better, zmin, zbuf)
            wbuf = torch.where(better, win, wbuf)
        depth[c0:c1] = zbuf
        winner[c0:c1] = wbuf
        if n_vary:
            vary[c0:c1] = interpolate_winners(tri_rec, wbuf, px[:, 0], py[:, 0], n_vary)
    return out


def strip_raster_split_plain(tri_rec, tri8, row_start, rows, init_depth, n_vary: int,
                             collect_stats: bool, pixels, range_len: int = 64):
    """``strip_raster_plain`` computed as the strip kernels split it, for
    the tests: ``strip_raster_plain`` over each range of
    ``range_len`` slot rows of every block, merged by
    ``raster_coarse.split_walks``, then loop 2.  Equal to
    ``strip_raster_plain`` bitwise."""
    def walk(r, init, stats):
        sub = torch.clamp(rows - r * range_len, 0, range_len)
        return strip_raster_plain(tri_rec, tri8, row_start + r * range_len, sub, init, 0,
                                  stats, pixels)

    depth, winner, ev = split_walks(walk, init_depth, rows, range_len, collect_stats)
    if n_vary:
        x, y = pixels(0, depth.shape[0])
        vary = interpolate_winners(tri_rec, winner, x[:, 0] + 0.5, y[:, 0] + 0.5, n_vary)
    else:
        vary = depth.new_empty((depth.shape[0], 0, *depth.shape[1:]))
    return (depth, winner, vary) + ((ev,) if collect_stats else ())
