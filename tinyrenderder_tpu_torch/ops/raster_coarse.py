"""Coarse raster over compacted active tiles or over every tile: the CUDA
kernel ``csrc/raster_coarse.cu`` and its plain PyTorch version.

Counterpart of ``tinyrenderder_tpu/ops/raster_pallas.py``
(``build_pair_records`` and ``_tile_kernel`` as launched by
``_pallas_call_sparse_jit``, with and without ``collect_stats``, and by
``_pallas_call_jit`` over the dense grid of every tile, the launch of
``rasterize_pallas`` and ``depth_resolve_pallas``: ``dense_raster``,
``rasterize``, ``depth_resolve``).  One program per tile of tile_h x 128
pixels:

  loop 1 — walk the tile's bin in bin order (= submission order) and keep,
           per pixel, the first pair with the smallest covered depth: the
           reference's strict-less first-drawn-wins z-test (our_gl.cpp:165);
  loop 2 — for each pixel's winner, perspective-correct barycentrics
           (our_gl.cpp:168-185) and the interpolated varyings.

The CUDA kernels split loop 1: each bin is cut into ranges walked by
separate blocks, merged in range order with strict-less and, for the
event planes, walked again from each range's entering depth
(``csrc/raster_coarse.cu``; ``coarse_raster_split_plain`` is the same
decomposition in plain PyTorch, for the tests).

Contract (shared by both versions, bitwise):
  tri_rec     (F, 16 + 3V) f32 per-triangle rows: screen ax ay bx by cx cy,
              ndc z0..z2, clip w0..w2, bbox min_x max_x min_y max_y (as
              f32), then the varying corners channel-major
  sorted_tri  (P,) i32 bin-ordered triangle ids
  tile_ids, start, count  (A,) i32 active tiles and their CSR segments
              (the dense launch: every tile, tile_ids = 0 .. T - 1)
  origin      global pixel offset (x, y) of tile 0
  init_depth  (A, th, tw) f32 running depth per active tile
  -> depth (A, th, tw) f32, winner (A, th, tw) i32 (-1 = background),
     vary (A, V, th, tw) f32 (0 where no winner)
  with collect_stats, also the event planes ev = (count, max_z), each
     (A, th, tw): per pixel the number of z-pass events (every strict-less
     depth update of loop 1, overdraw included, our_gl.cpp:194) as int32,
     and the largest event z as f32 (-inf where there was none).  These
     are the TPU's (A, 2, th, tw) f32 planes; its f32 count is an
     artefact of its vector unit.

The TPU's 128-float pair records (one row per pair, lane-aligned for the
DMA engine) and its triangle ids carried as f32 are not ported: a GPU
reads the per-triangle row through ``sorted_tri`` and keeps ids int32.
"""

from __future__ import annotations

import torch

from tinyrenderder_tpu_torch import _build
from tinyrenderder_tpu_torch.ops import semantics
from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_H, TILE_W, Bins, to_tiles

__all__ = ["GEOM", "MAX_VARY", "SUB", "LAUNCHES", "STATS_LAUNCHES", "DENSE_LAUNCHES",
           "build_tri_records", "check_inputs", "check_tensors", "coarse_raster",
           "coarse_raster_plain", "coarse_raster_split_plain", "split_walks", "walk_items",
           "walk_scratch", "dense_raster", "rasterize", "depth_resolve", "tile_pixels",
           "interpolate_winners"]

GEOM = 16            # geometry columns before the varying corners
MAX_VARY = 36        # the reference's record limit, (128 - 20) // 3
SUB = 16             # pairs per vector step of the plain version
TILE_CHUNK = 64      # tiles per step of the plain version (bounds memory)

#: user calls that launched the kernels since the last reset (the CPU path
#: does not count), over active tiles without and with the event planes,
#: and over every tile (``dense_raster``); a call launches three kernels,
#: four with the event planes (``csrc/raster_coarse.cu``)
LAUNCHES = 0
STATS_LAUNCHES = 0
DENSE_LAUNCHES = 0


def build_tri_records(setup: dict, vary_corners=None) -> torch.Tensor:
    """(F, 16 + 3V) f32 per-triangle rows (see the module docstring)."""
    f = setup["valid"].shape[0]
    cols = [setup["screen"].reshape(f, 6).to(torch.float32),
            setup["ndc_z"].to(torch.float32),
            setup["clip_w"].to(torch.float32),
            setup["bbox"].to(torch.float32)]
    if vary_corners is not None:
        v = vary_corners.shape[-1]
        if v > MAX_VARY:
            raise ValueError(f"{v} varying channels > {MAX_VARY} max")
        cols.append(vary_corners.to(torch.float32).transpose(1, 2).reshape(f, 3 * v))
    return torch.cat(cols, dim=1).contiguous()


def check_inputs(tri_rec, bins, tile_ids, start, count, init_depth, tile_h,
                 tile_w, n_vary, names=("sorted_tri", "start", "count")):
    """Raise ValueError unless the raster's inputs have the contract's
    devices, dtypes, shapes and layout.  ``bins`` and its per-tile
    ``start``/``count`` go by ``names`` (the strip raster's slot table
    has other names)."""
    a = tile_ids.shape[0]
    check_tensors(tri_rec, n_vary, (
        (names[0], bins, torch.int32, None),
        ("tile_ids", tile_ids, torch.int32, (a,)),
        (names[1], start, torch.int32, (a,)),
        (names[2], count, torch.int32, (a,)),
        ("init_depth", init_depth, torch.float32, (a, tile_h, tile_w))))


def check_tensors(tri_rec, n_vary: int, specs) -> None:
    """Raise ValueError unless ``tri_rec`` is a contiguous float32 (F, 16 +
    3V) table with room for ``n_vary`` channels and each (name, tensor,
    dtype, shape or None) of ``specs`` lies on its device with that dtype
    and shape, contiguous."""
    dev = tri_rec.device
    for name, t, dtype, shape in (("tri_rec", tri_rec, torch.float32, None), *specs):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, tri_rec on {dev}")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tri_rec.dim() != 2 or tri_rec.shape[1] < GEOM + 3 * n_vary:
        raise ValueError(f"tri_rec {tuple(tri_rec.shape)} has no room for "
                         f"{n_vary} varying channels")


def coarse_raster(tri_rec, sorted_tri, tile_ids, start, count, init_depth,
                  n_tiles_x: int, tile_h: int, tile_w: int, n_vary: int,
                  origin=(0, 0), collect_stats: bool = False):
    """Raster the active tiles (contract in the module docstring).
    Returns (depth, winner, vary), and ev as a fourth item with
    ``collect_stats``.  CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    global LAUNCHES, STATS_LAUNCHES
    if sorted_tri.dim() != 1:
        raise ValueError("sorted_tri must be 1-D")
    check_inputs(tri_rec, sorted_tri, tile_ids, start, count, init_depth, tile_h,
                 tile_w, n_vary)
    if tri_rec.device.type == "cpu":
        return coarse_raster_plain(tri_rec, sorted_tri, tile_ids, start, count,
                                   init_depth, n_tiles_x, tile_h, tile_w,
                                   n_vary, origin, collect_stats)
    out = _launch(tri_rec, sorted_tri, tile_ids, start, count, init_depth, n_tiles_x,
                  tile_h, tile_w, n_vary, origin, collect_stats)
    if count.shape[0]:
        if collect_stats:
            STATS_LAUNCHES += 1
        else:
            LAUNCHES += 1
    return out


def walk_items(n_blocks: int, n_steps: int, range_len: int) -> int:
    """The grid of a split walk (``csrc/raster_common.cuh``): ``n_blocks``
    output blocks whose walks, ``n_steps`` in all, are cut into ranges of
    at most ``range_len`` steps have at most this many ranges (a block of
    no step has one).  Known without a readback."""
    return n_blocks + -(-n_steps // range_len)


def walk_scratch(n_items: int, n_blocks: int, tile_h: int, device) -> torch.Tensor:
    """The split walk's scratch: each range's partial depth and winner
    planes, then each block's first range and the range total."""
    return torch.empty(2 * n_items * tile_h * TILE_W + n_blocks + 1, dtype=torch.int32,
                       device=device)


def _launch(tri_rec, sorted_tri, tile_ids, start, count, init_depth, n_tiles_x: int,
            tile_h: int, tile_w: int, n_vary: int, origin, collect_stats: bool):
    """Launch the kernels on CUDA tensors (the item scan, the split walk,
    the ordered merge and, with ``collect_stats``, the events walk): block
    a's bin is on tile ``tile_ids[a]`` or, with ``tile_ids`` None, on tile
    a.  No entries, no launch."""
    if tri_rec.device.type != "cuda":
        raise ValueError(f"no coarse raster for device {tri_rec.device}")
    if tile_w != 128 or tile_h not in (16, 32):
        raise ValueError(f"the CUDA kernel takes 16x128 or 32x128 tiles, "
                         f"not {tile_h}x{tile_w}")
    a = count.shape[0]
    depth = torch.empty((a, tile_h, tile_w), dtype=torch.float32, device=tri_rec.device)
    winner = torch.empty((a, tile_h, tile_w), dtype=torch.int32, device=tri_rec.device)
    vary = torch.empty((a, n_vary, tile_h, tile_w), dtype=torch.float32,
                       device=tri_rec.device)
    ev = ((torch.empty_like(winner), torch.empty_like(depth))
          if collect_stats else None)
    out = (depth, winner, vary) + ((ev,) if collect_stats else ())
    if a == 0:
        return out
    n_items = walk_items(a, sorted_tri.shape[0], _build.constant("trt_coarse_range_pairs"))
    scratch = walk_scratch(n_items, a, tile_h, tri_rec.device)
    _build.call("trt_coarse_raster", tri_rec.device,
                tri_rec.data_ptr(), tri_rec.shape[1], sorted_tri.data_ptr(),
                None if tile_ids is None else tile_ids.data_ptr(), start.data_ptr(),
                count.data_ptr(), a, int(origin[0]), int(origin[1]), n_tiles_x, tile_h, tile_w,
                n_vary, init_depth.data_ptr(), depth.data_ptr(), winner.data_ptr(),
                vary.data_ptr() if n_vary else None, ev[0].data_ptr() if ev else None,
                ev[1].data_ptr() if ev else None, n_items, scratch.data_ptr())
    return out


def dense_raster(tri_rec, sorted_tri, start, count, init_tiles, n_tiles_x: int,
                 tile_h: int, tile_w: int, n_vary: int, origin=(0, 0)):
    """Raster EVERY tile of the grid (the launch of ``_pallas_call_jit``):
    ``start``, ``count`` (T,) i32 each tile's CSR segment, ``init_tiles``
    (T, th, tw) f32 each tile's running depth.  Returns (depth, winner,
    vary) for all T tiles; an empty tile gives its init depth, winner -1
    and zero varyings.  CPU tensors take the plain version over tile ids
    0 .. T - 1; CUDA tensors launch the kernel with no tile list."""
    global DENSE_LAUNCHES
    t = count.shape[0]
    check_tensors(tri_rec, n_vary, (
        ("sorted_tri", sorted_tri, torch.int32, (sorted_tri.shape[0],)),
        ("start", start, torch.int32, (t,)),
        ("count", count, torch.int32, (t,)),
        ("init_tiles", init_tiles, torch.float32, (t, tile_h, tile_w))))
    if tri_rec.device.type == "cpu":
        ids = torch.arange(t, dtype=torch.int32)
        return coarse_raster_plain(tri_rec, sorted_tri, ids, start, count, init_tiles,
                                   n_tiles_x, tile_h, tile_w, n_vary, origin)
    out = _launch(tri_rec, sorted_tri, None, start, count, init_tiles, n_tiles_x,
                  tile_h, tile_w, n_vary, origin, False)
    if t:
        DENSE_LAUNCHES += 1
    return out


def rasterize(setup: dict, bins: Bins, init_depth, height: int, width: int,
              vary_corners=None, tile_h: int = TILE_H, tile_w: int = TILE_W,
              origin=(0, 0)):
    """Depth resolve and, with ``vary_corners`` (F, 3, V), the
    perspective-correct varyings of every pixel's winner, over every tile
    of ``bins``' grid (``rasterize_pallas``).  ``init_depth`` (H, W) f32
    is the running depth (the ragged edge is padded with +inf);
    ``origin`` is the global pixel offset of tile 0 (a band of a larger
    frame).  Returns (depth (H, W) f32, winner (H, W) i32, -1 where no
    triangle won, vary (V, H, W) f32 or None), each plane untiled with
    ``untile_one`` and cropped."""
    from tinyrenderder_tpu_torch.ops.raster_sparse import untile_one  # imports this module

    ntx, nty = bins.n_tiles_x, bins.n_tiles_y
    n_vary = 0 if vary_corners is None else vary_corners.shape[-1]
    tri_rec = build_tri_records(setup, vary_corners)
    init = to_tiles(init_depth, nty, ntx, tile_h, tile_w, torch.inf)
    depth, winner, vary = dense_raster(tri_rec, bins.sorted_tri, bins.start[:-1], bins.counts,
                                       init, ntx, tile_h, tile_w, n_vary, origin)

    def plane(x):
        return untile_one(x, ntx, nty, tile_h, tile_w)[:height, :width]

    if n_vary:
        vary = torch.stack([plane(v) for v in vary.transpose(0, 1).contiguous()])
    return plane(depth), plane(winner), vary if n_vary else None


def depth_resolve(setup: dict, bins: Bins, init_depth, height: int, width: int,
                  tile_h: int = TILE_H, tile_w: int = TILE_W, origin=(0, 0)):
    """``rasterize`` without varyings (``depth_resolve_pallas``, phase A
    only) -> (depth (H, W) f32, winner (H, W) i32)."""
    depth, winner, _ = rasterize(setup, bins, init_depth, height, width, None, tile_h,
                                 tile_w, origin)
    return depth, winner


def tile_pixels(tile_ids, n_tiles_x, tile_h, tile_w, origin, dtype):
    """Global integer pixel coords of each tile as exact floats:
    x (C, 1, 1, tw), y (C, 1, th, 1)."""
    dev = tile_ids.device
    gx0 = origin[0] + (tile_ids % n_tiles_x) * tile_w
    gy0 = origin[1] + torch.div(tile_ids, n_tiles_x, rounding_mode="floor") * tile_h
    xi = (gx0[:, None] + torch.arange(tile_w, device=dev)).to(dtype)
    yi = (gy0[:, None] + torch.arange(tile_h, device=dev)).to(dtype)
    return xi[:, None, None, :], yi[:, None, :, None]


def coarse_raster_plain(tri_rec, sorted_tri, tile_ids, start, count,
                        init_depth, n_tiles_x: int, tile_h: int, tile_w: int,
                        n_vary: int, origin=(0, 0), collect_stats: bool = False):
    """Plain PyTorch version, vectorised over tiles and SUB-pair steps
    and chunked over tiles.  Loop 1 is the TPU kernel's form: per step,
    the first-minimum argmin over SUB pairs, then a strict-less merge.
    That picks the earliest pair at the minimum, as the kernel's
    sequential strict-less update does.  The event planes keep the TPU
    form too: pair k of a step is an event iff its z is below the
    exclusive cummin of the step's earlier pairs and the running depth
    (raster_pallas.py:214-236)."""
    dev = tri_rec.device
    a = tile_ids.shape[0]
    f32 = torch.float32
    depth = torch.empty((a, tile_h, tile_w), dtype=f32, device=dev)
    winner = torch.empty((a, tile_h, tile_w), dtype=torch.int32, device=dev)
    vary = torch.empty((a, n_vary, tile_h, tile_w), dtype=f32, device=dev)
    ev = ((torch.zeros_like(winner), torch.full_like(depth, -torch.inf))
          if collect_stats else None)
    out = (depth, winner, vary) + ((ev,) if collect_stats else ())
    if a == 0:
        return out
    n_sorted = sorted_tri.shape[0]
    for c0 in range(0, a, TILE_CHUNK):
        c1 = min(a, c0 + TILE_CHUNK)
        st, cnt = start[c0:c1].long(), count[c0:c1].long()
        x, y = tile_pixels(tile_ids[c0:c1].long(), n_tiles_x, tile_h, tile_w,
                            origin, f32)
        px, py = x + 0.5, y + 0.5
        zbuf = init_depth[c0:c1].clone()
        wbuf = torch.full_like(zbuf, -1, dtype=torch.int32)
        steps = int(cnt.max())
        for s in range(0, steps, SUB):
            j = s + torch.arange(SUB, device=dev)
            live = j[None, :] < cnt[:, None]                          # (C, SUB)
            idx = torch.clamp(st[:, None] + j[None, :], max=max(n_sorted - 1, 0))
            tri = torch.where(live, sorted_tri[idx], 0)               # (C, SUB)
            g = tri_rec[tri.long(), :GEOM][..., None, None]           # (C, SUB, 16, 1, 1)
            b0, b1, b2, _ = semantics.barycentric(
                g[:, :, 0], g[:, :, 1], g[:, :, 2], g[:, :, 3], g[:, :, 4],
                g[:, :, 5], px, py)
            covered = semantics.coverage_mask(b0, b1, b2)
            z = semantics.affine_z(g[:, :, 6], g[:, :, 7], g[:, :, 8], b0, b1, b2)
            covered &= torch.isfinite(z)
            covered &= ((x >= g[:, :, 12]) & (x <= g[:, :, 13])
                        & (y >= g[:, :, 14]) & (y <= g[:, :, 15]))
            covered &= live[..., None, None]
            zc = torch.where(covered, z, torch.inf)
            if collect_stats:
                excl = torch.cat([torch.full_like(zc[:, :1], torch.inf),
                                  torch.cummin(zc, dim=1).values[:, :-1]], dim=1)
                events = zc < torch.minimum(excl, zbuf[:, None])
                ev[0][c0:c1] += events.sum(dim=1, dtype=torch.int32)
                ev[1][c0:c1] = torch.maximum(
                    ev[1][c0:c1], torch.where(events, zc, -torch.inf).amax(dim=1))
            zmin = torch.amin(zc, dim=1)
            best = torch.argmin(zc, dim=1)             # first minimum on ties
            win = torch.gather(tri, 1, best.flatten(1)).view_as(best)
            better = zmin < zbuf
            zbuf = torch.where(better, zmin, zbuf)
            wbuf = torch.where(better, win, wbuf)
        depth[c0:c1] = zbuf
        winner[c0:c1] = wbuf
        if n_vary:
            vary[c0:c1] = interpolate_winners(tri_rec, wbuf, px[:, 0], py[:, 0], n_vary)
    return out


def split_walks(walk, init_depth, steps, range_len: int, collect_stats: bool):
    """The split walk of the CUDA rasters (``csrc/raster_common.cuh``) in
    plain PyTorch, for the tests.  Each output block's walk of ``steps``
    steps is cut into consecutive ranges of ``range_len``; ``walk(r, init,
    stats)`` runs a plain version over range r of every block from
    ``init`` (+inf: the range's own first minimum).  The ranges' (depth,
    winner) are merged in order with strict-less from ``init_depth``, and
    with ``collect_stats`` each range is walked again from its entering
    depth (the exclusive prefix) and its events summed and maxed.  ->
    (depth, winner, (count, max z) or None)."""
    n_ranges = max(1, -(-int(steps.max()) // range_len)) if steps.numel() else 1
    fresh = torch.full_like(init_depth, torch.inf)
    depth = init_depth.clone()
    winner = torch.full_like(depth, -1, dtype=torch.int32)
    entering = []
    for r in range(n_ranges):
        part_d, part_w = walk(r, fresh, False)[:2]
        entering.append(depth)
        better = part_d < depth                       # strict-less: the first range wins a tie
        depth = torch.where(better, part_d, depth)
        winner = torch.where(better, part_w, winner)
    if not collect_stats:
        return depth, winner, None
    count = torch.zeros_like(winner)
    max_z = torch.full_like(depth, -torch.inf)
    for r, enter in enumerate(entering):
        c, z = walk(r, enter, True)[3]
        count += c
        max_z = torch.maximum(max_z, z)
    return depth, winner, (count, max_z)


def coarse_raster_split_plain(tri_rec, sorted_tri, tile_ids, start, count, init_depth,
                              n_tiles_x: int, tile_h: int, tile_w: int, n_vary: int,
                              origin=(0, 0), collect_stats: bool = False,
                              range_len: int = 64):
    """``coarse_raster_plain`` computed as the CUDA kernels split it, for
    the tests: ``coarse_raster_plain`` over each range of ``range_len``
    pairs of every bin, merged by ``split_walks``, then loop 2.  Equal to
    ``coarse_raster_plain`` bitwise."""
    def walk(r, init, stats):
        sub = torch.clamp(count - r * range_len, 0, range_len)
        return coarse_raster_plain(tri_rec, sorted_tri, tile_ids, start + r * range_len, sub,
                                   init, n_tiles_x, tile_h, tile_w, 0, origin, stats)

    depth, winner, ev = split_walks(walk, init_depth, count, range_len, collect_stats)
    x, y = tile_pixels(tile_ids.long(), n_tiles_x, tile_h, tile_w, origin, torch.float32)
    vary = (interpolate_winners(tri_rec, winner, x[:, 0] + 0.5, y[:, 0] + 0.5, n_vary)
            if n_vary else depth.new_empty((depth.shape[0], 0, tile_h, tile_w)))
    return (depth, winner, vary) + ((ev,) if collect_stats else ())


def interpolate_winners(tri_rec, wbuf, px, py, n_vary):
    """Loop 2: each pixel gathers its winner's row and interpolates.
    ``+ 0.0`` turns -0.0 into +0.0 like the TPU kernel's select-by-sum."""
    won = wbuf >= 0
    r = tri_rec[torch.clamp(wbuf, min=0).long()]                      # (C, th, tw, R)
    b0, b1, b2, _ = semantics.barycentric(
        r[..., 0], r[..., 1], r[..., 2], r[..., 3], r[..., 4], r[..., 5], px, py)
    p0, p1, p2 = semantics.perspective_correct_bary(
        b0, b1, b2, r[..., 9], r[..., 10], r[..., 11])
    out = []
    for c in range(n_vary):
        v0, v1, v2 = (r[..., GEOM + 3 * c + k] for k in range(3))
        val = semantics.interp3(v0, v1, v2, p0, p1, p2) + 0.0
        out.append(torch.where(won, val, torch.zeros_like(val)))
    return torch.stack(out, dim=1)
