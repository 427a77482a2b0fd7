"""Grouped strip raster: the pre-stage, the CUDA kernel
``csrc/raster_fine2.cu`` with its plain PyTorch version, and the post stage
that merges its outputs into the frame.

Counterpart of ``tinyrenderder_tpu/ops/raster_fine2.py``: ``_pre_fine2_jit``,
``_fine2_kernel`` as launched by ``_fine2_call_jit`` (pass-local, and
init-seeded with ``collect_stats``), ``_init_strips_jit``,
``_post_fine2_jit`` and ``_post_fine2_image_jit``.
``_reduce_events2_jit`` is ``raster_sparse.reduce_events`` on the group
planes.

The strip raster (``raster_fine``) runs a tile's 8 strips together, so a
tile costs as many rows as its largest strip bin.  Here every strip of the
screen is ranked by its bin size with one stable descending argsort, and
the rank-r strip goes to group r // 8, slot r % 8: a group's rows are its
largest member's count, and their sum, ``sum(sorted[0::8])``, is the least
any grouping of the strips into 8 slots gives (raster_fine2.py:17-25).

Pre-stage (``pre_fine2``): the strip bins of ``raster_fine`` (strip id
``8 * tile + k``), the grouping, the slot table ``tri8`` (R, 8) int32 in
which group g's rows start at ``group_start[g]`` and slot k's column holds
its strip's triangles in submission order, then -1, the per-slot pixel
origins ``x0y0`` (G, 8, 2) int32, and the active-tile map: ``ids`` (A,) the
tiles with a non-empty strip, ``src`` (A, 8) the flat group slot ``g * 8 +
k`` of each of their strips, ``live`` (A, 8) whether that strip has pairs.
One readback of four totals (strip pairs, grouped rows, groups with rows,
active tiles) sizes everything exactly: there is no capacity cache and no
overflow re-render.  Only the G groups with rows > 0 are launched; they are
a prefix, since rows descend, and hold every strip with pairs, so ``src <
G * 8`` wherever ``live``.

The CUDA kernels cut each group's rows into ranges walked by separate
blocks and merge them in range order with strict-less (``csrc/raster_fine2.cu``
on the split walk of ``csrc/raster_strip.cuh``, shared with the strip
raster; ``fine2_raster_split_plain`` is the same decomposition in plain
PyTorch, for the tests).

Raster contract (shared by both versions, bitwise), in group space: lanes
16k .. 16k + 15 of group g are slot k's strip.
  tri_rec     (F, 16 + 3V) f32 per-triangle rows (``raster_coarse``)
  tri8        (R, 8) i32 slot table
  group_start, group_rows  (G,) i32 the groups' row segments
  x0y0        (G, 8, 2) i32 each slot's pixel origin (x, y)
  init_depth  None: +inf, pass-local; or (G, th, 128) f32, the running
              depth of each slot's strip (``init_strips``)
  -> depth (G, th, 128) f32, winner (G, th, 128) i32 (-1 = background),
     vary (G, V, th, 128) f32 (0 where no winner)
  with collect_stats, also the event planes (count i32, max z f32).

Post stage (``post_fine2``, ``post_fine2_image``): each active tile's 8
strips gather their slabs from group space through ``src`` and merge into
the frame with the strict-less select ``live & (d_new < d_old)``, which
equals the in-kernel merge against a preloaded depth (raster_fine2.py:31-38);
shading runs in group space and only the packed colour is regrouped.  With
``collect_stats`` the frame takes one init-seeded launch where the TPU takes
two (the pass-local frame, then an init-seeded stats launch without
varyings): where the pass does not beat the frame, the init-seeded depth
equals the frame's and the select keeps it; where it does, both launches
give the same least depth and the first-drawn triangle at it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tinyrenderder_tpu_torch import _build, trace
from tinyrenderder_tpu_torch.ops.raster_coarse import (build_tri_records, check_tensors,
                                                       walk_items, walk_scratch)
from tinyrenderder_tpu_torch.ops.raster_fine import (STRIP_W, STRIPS, strip_raster_plain,
                                                     strip_raster_split_plain)
from tinyrenderder_tpu_torch.ops.raster_tiled import (TILE_H, TILE_W, Band, active_ids,
                                                      band_spans, build_bins,
                                                      shader_varyings, tile_pair_counts,
                                                      vertex_stage)

__all__ = ["PreFine2", "pre_fine2", "fine2_raster", "fine2_raster_plain",
           "fine2_raster_split_plain", "init_strips", "post_fine2", "post_fine2_image"]

# user calls that launch the kernels are counted (``trace.count``, the CPU
# path does not count) as launch.fine2_raster and launch.fine2_raster_stats,
# without and with the event planes; a call launches three kernels, four
# with the event planes (``csrc/raster_fine2.cu``)


class PreFine2(NamedTuple):
    """Grouped-strip pre-stage outputs (see the module docstring)."""
    tri_rec: torch.Tensor      # (F, 16 + 3V) f32
    tri8: torch.Tensor         # (R, 8) i32, -1 = empty slot
    group_start: torch.Tensor  # (G,) i32
    group_rows: torch.Tensor   # (G,) i32, descending
    x0y0: torch.Tensor         # (G, 8, 2) i32 slot pixel origins
    sid_of: torch.Tensor       # (G, 8) i32 strip of each slot
    ids: torch.Tensor          # (A,) i32 active tiles, ascending
    src: torch.Tensor          # (A, 8) i32 flat group slot of each strip
    live: torch.Tensor         # (A, 8) bool: the strip has pairs
    pairs: int                 # (strip, triangle) pairs
    row_total: int             # R
    n_groups: int              # G
    n_active: int              # A
    setup: dict                # the triangle setup (valid, screen, ..., bbox)


def _strip_counts(setup: dict, width: int, height: int, tile_h: int,
                  band: Band | None = None):
    """The strip spans over every tile or ``band``'s window, the (T * 8,)
    pair count of each strip and the (tile columns, tile rows) of the
    grid."""
    (tx0, ty0, span_x, span_y, spans), (n_strips_x, n_tiles_y) = band_spans(
        setup, TILE_W, tile_h, width, height, band, STRIP_W)
    counts = tile_pair_counts(tx0, ty0, span_x, span_y, n_strips_x, n_tiles_y)
    return (tx0, ty0, span_x, spans), counts, (n_strips_x // STRIPS, n_tiles_y)


def pre_fine2(attrs: dict, uniforms: dict, shader, width: int, height: int,
              tile_h: int = TILE_H, tile_w: int = TILE_W, band: Band | None = None) -> PreFine2:
    """Vertex stage, strip binning, grouping, slot table, slot origins,
    per-triangle records and the active-tile map (``_pre_fine2_jit``),
    over every tile or over ``band``'s window: tile ids are then
    band-local and a slot's row origin steps ``tile_h * ty_stride`` a band
    tile row, so the kernel needs only the band's origin.  Holds the
    pass's one host readback."""
    if tile_w != STRIPS * STRIP_W:
        raise ValueError(f"the strip raster takes {STRIPS * STRIP_W}-px tiles, not {tile_w}")
    setup, varyings = vertex_stage(attrs, uniforms, shader, width, height,
                                   band.geom if band else None)
    spans, counts, (n_tiles_x, n_tiles_y) = _strip_counts(setup, width, height, tile_h, band)
    n_tiles = n_tiles_x * n_tiles_y
    n_strips = n_tiles * STRIPS
    dev = setup["bbox"].device
    # rank r -> strip order[r]; JAX's argsort is stable, torch's only on request
    order = torch.argsort(-counts, stable=True)
    group_rows = counts[order][0::STRIPS]                                 # descending
    counts8 = counts.view(n_tiles, STRIPS)
    active = counts8.amax(dim=1) > 0
    pairs, row_total, n_groups, n_active = trace.readback(torch.stack(
        [counts.sum(), group_rows.sum(), (group_rows > 0).sum(), active.sum()]))
    sorted_tri, start, _ = build_bins(*spans, pairs, n_tiles_x * STRIPS, n_tiles_y)
    group_start = torch.cumsum(group_rows, 0, dtype=torch.int32) - group_rows
    rank_of = torch.empty_like(order)
    rank_of[order] = torch.arange(n_strips, device=dev)

    # sorted pair q of strip s goes to slot (group_start[r // 8] + q - start[s]) * 8
    # + r % 8, r = rank_of[s]
    strip = torch.repeat_interleave(torch.arange(n_strips, device=dev), counts,
                                    output_size=pairs)
    r = rank_of[strip]
    dst = ((group_start[r // STRIPS] + torch.arange(pairs, device=dev) - start[strip])
           * STRIPS + r % STRIPS)
    tri8 = torch.full((row_total * STRIPS,), -1, dtype=torch.int32, device=dev)
    tri8.scatter_(0, dst, sorted_tri)

    sid_of = order[:n_groups * STRIPS].view(n_groups, STRIPS)
    tile = sid_of // STRIPS
    y_step = tile_h * (band.ty_stride if band else 1)        # interleave-aware
    x0y0 = torch.stack([(tile % n_tiles_x) * tile_w + (sid_of % STRIPS) * STRIP_W,
                        (tile // n_tiles_x) * y_step], dim=-1).to(torch.int32)
    tri_rec = build_tri_records(setup, shader_varyings(varyings, shader))
    ids = active_ids(active, n_active)
    idl = ids.long()
    return PreFine2(tri_rec, tri8.view(row_total, STRIPS),
                    group_start[:n_groups].contiguous(), group_rows[:n_groups].contiguous(),
                    x0y0.contiguous(), sid_of.to(torch.int32), ids,
                    rank_of.view(n_tiles, STRIPS)[idl].to(torch.int32), counts8[idl] > 0,
                    pairs, row_total, n_groups, n_active, setup)


def _check(tri_rec, tri8, group_start, group_rows, x0y0, init_depth, tile_h: int,
           n_vary: int) -> None:
    g = group_start.shape[0]
    specs = [("tri8", tri8, torch.int32, (tri8.shape[0], STRIPS)),
             ("group_start", group_start, torch.int32, (g,)),
             ("group_rows", group_rows, torch.int32, (g,)),
             ("x0y0", x0y0, torch.int32, (g, STRIPS, 2))]
    if init_depth is not None:
        specs.append(("init_depth", init_depth, torch.float32, (g, tile_h, TILE_W)))
    check_tensors(tri_rec, n_vary, specs)


def fine2_raster(tri_rec, tri8, group_start, group_rows, x0y0, tile_h: int, n_vary: int,
                 init_depth=None, origin=(0, 0), collect_stats: bool = False):
    """Raster the scheduled groups strip by strip (contract in the module
    docstring).  Returns (depth, winner, vary), and ev as a fourth item
    with ``collect_stats``.  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check(tri_rec, tri8, group_start, group_rows, x0y0, init_depth, tile_h, n_vary)
    if tri_rec.device.type == "cpu":
        return fine2_raster_plain(tri_rec, tri8, group_start, group_rows, x0y0, tile_h,
                                  n_vary, init_depth, origin, collect_stats)
    if tri_rec.device.type != "cuda":
        raise ValueError(f"no grouped strip raster for device {tri_rec.device}")
    if tile_h not in (16, 32):
        raise ValueError(f"the CUDA kernel takes 16- or 32-row groups, not {tile_h}")
    g = group_start.shape[0]
    dev = tri_rec.device
    depth = torch.empty((g, tile_h, TILE_W), dtype=torch.float32, device=dev)
    winner = torch.empty((g, tile_h, TILE_W), dtype=torch.int32, device=dev)
    vary = torch.empty((g, n_vary, tile_h, TILE_W), dtype=torch.float32, device=dev)
    ev = (torch.empty_like(winner), torch.empty_like(depth)) if collect_stats else None
    out = (depth, winner, vary) + ((ev,) if collect_stats else ())
    if g == 0:
        return out
    n_items = walk_items(g, tri8.shape[0], _build.constant("trt_fine2_range_rows"))
    scratch = walk_scratch(n_items, g, tile_h, dev)
    trace.count("launch.fine2_raster_stats" if collect_stats else "launch.fine2_raster")
    _build.call("trt_fine2_raster", dev,
                tri_rec.data_ptr(), tri_rec.shape[1], tri8.data_ptr(), group_start.data_ptr(),
                group_rows.data_ptr(), x0y0.data_ptr(), g, int(origin[0]), int(origin[1]), tile_h,
                TILE_W, n_vary, None if init_depth is None else init_depth.data_ptr(),
                depth.data_ptr(), winner.data_ptr(), vary.data_ptr() if n_vary else None,
                ev[0].data_ptr() if ev else None, ev[1].data_ptr() if ev else None, n_items,
                scratch.data_ptr())
    return out


def fine2_raster_plain(tri_rec, tri8, group_start, group_rows, x0y0, tile_h: int,
                       n_vary: int, init_depth=None, origin=(0, 0),
                       collect_stats: bool = False):
    """Plain PyTorch version: ``raster_fine.strip_raster_plain`` over the
    groups, each slot's pixels at its strip's place on the screen."""
    return strip_raster_plain(tri_rec, tri8, group_start, group_rows,
                              _init_or_inf(init_depth, group_start, tile_h, tri_rec.device),
                              n_vary, collect_stats, _group_pixels(x0y0, tile_h, origin))


def fine2_raster_split_plain(tri_rec, tri8, group_start, group_rows, x0y0, tile_h: int,
                             n_vary: int, init_depth=None, origin=(0, 0),
                             collect_stats: bool = False, range_len: int = 64):
    """``fine2_raster_plain`` computed as the CUDA kernels split it, for the
    tests: ``raster_fine.strip_raster_split_plain`` over the groups, their
    rows cut into ranges of ``range_len``.  Equal to ``fine2_raster_plain``
    bitwise."""
    return strip_raster_split_plain(
        tri_rec, tri8, group_start, group_rows,
        _init_or_inf(init_depth, group_start, tile_h, tri_rec.device), n_vary, collect_stats,
        _group_pixels(x0y0, tile_h, origin), range_len)


def _init_or_inf(init_depth, group_start, tile_h: int, dev):
    if init_depth is not None:
        return init_depth
    return torch.full((group_start.shape[0], tile_h, TILE_W), torch.inf, dtype=torch.float32,
                      device=dev)


def _group_pixels(x0y0, tile_h: int, origin):
    """pixels(c0, c1) of ``strip_raster_plain``: groups c0..c1's global
    pixel coordinates, each slot's at its strip's place on the screen."""
    dev = x0y0.device
    lane = torch.arange(TILE_W, device=dev) % STRIP_W
    row = torch.arange(tile_h, device=dev)

    def pixels(c0, c1):
        o = x0y0[c0:c1].repeat_interleave(STRIP_W, dim=1)                 # (C, tw, 2)
        x = origin[0] + o[..., 0] + lane                                  # (C, tw)
        y = origin[1] + o[:, None, :, 1] + row[:, None]                   # (C, th, tw)
        return x.to(torch.float32)[:, None, None, :], y.to(torch.float32)[:, None]

    return pixels


# ---------------------------------------------------------------------------
# between group space and tiles
# ---------------------------------------------------------------------------

def _slabs(blocks, strip):
    """(N, th, 128) blocks and strip ids ``8 * block + k`` of any shape ->
    the strips' (..., th, 16) column slabs."""
    n, th, tw = blocks.shape
    s = strip.long()
    return blocks.view(n, th, STRIPS, STRIP_W).transpose(1, 2)[s // STRIPS, s % STRIPS]


def _blocks(slabs):
    """(N, 8, th, 16) slabs -> (N, th, 128) blocks, slab k at columns 16k.."""
    n, _, th, _ = slabs.shape
    return slabs.transpose(1, 2).reshape(n, th, STRIPS * STRIP_W)


def init_strips(depth_tiles, pre: PreFine2):
    """(G, th, 128) running depth for an init-seeded launch: slot k of a
    group carries its strip's current frame depth (``_init_strips_jit``)."""
    return _blocks(_slabs(depth_tiles, pre.sid_of))


def post_fine2(ft, pre: PreFine2, out, winner_offset: int, shade) -> None:
    """Merge one pass's group outputs into the frame ``ft``
    (``raster_sparse.FrameTiles``), in place (``_post_fine2_jit``): a
    strip's pixel is won where it is live and its depth is strictly below
    the frame's; there depth and colour are the pass's and the winner is
    ``winner + winner_offset``.  ``shade(vary)`` packs (G, V, th, 128)
    varyings into (G, th, 128) int32 colours; it runs in group space and
    only the colour is regrouped.  ``shade`` None (a depth-only pass)
    keeps the frame's colour."""
    d_g, w_g, v_g = out[:3]
    idl = pre.ids.long()
    a, th = idl.shape[0], d_g.shape[1]
    src = torch.where(pre.live, pre.src, 0)
    d_new = _slabs(d_g, src)                                              # (A, 8, th, 16)
    d_old = ft.depth[idl].view(a, th, STRIPS, STRIP_W).transpose(1, 2)
    won = pre.live[:, :, None, None] & (d_new < d_old)                    # strict-less merge
    won_t = _blocks(won)
    ft.depth.index_copy_(0, idl, _blocks(torch.where(won, d_new, d_old)))
    ft.winner.index_copy_(0, idl, torch.where(won_t, _blocks(_slabs(w_g, src)) + winner_offset,
                                              ft.winner[idl]))
    if shade is None:
        return
    ft.color.index_copy_(0, idl, torch.where(won_t, _blocks(_slabs(shade(v_g), src)),
                                             ft.color[idl]))


def post_fine2_image(pre: PreFine2, out, shade):
    """A single pass on a fresh frame (``_post_fine2_image_jit``): ->
    compact (A, th, 128) packed colour, 0 where the pass won no pixel, and
    (A, th, 128) depth, +inf there."""
    d_g, _, v_g = out[:3]
    live = pre.live[:, :, None, None]
    src = torch.where(pre.live, pre.src, 0)
    d_new = torch.where(live, _slabs(d_g, src), torch.inf)
    c_new = _slabs(shade(v_g), src)
    return _blocks(torch.where(d_new < torch.inf, c_new, torch.zeros_like(c_new))), _blocks(d_new)
