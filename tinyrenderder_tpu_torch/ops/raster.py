"""Frame buffers, per-pass counters and the scan backend in PyTorch.

Counterpart of ``tinyrenderder_tpu/ops/raster.py`` (the JAX module
imports jax at module level, so the port keeps its own copy): the frame
in image layout (``BACKGROUND``, ``FrameBuffers``, ``new_framebuffers``),
a pass's counters (``pass_stats``, ``PassEvents``) and the scan backend
(``backend="xla"``), which renders a pass in two phases over the whole
frame:

  Phase A (depth resolve, ``depth_resolve_xla``; with the exact z-pass
    events, ``pass_events_xla``): per pixel, the least affine depth of the
    covered triangles, ties to the lowest triangle (= submission) index,
    which is what the reference's serial strict-less z-test keeps
    (our_gl.cpp:165).  The JAX package scans chunks of ``chunk`` triangles
    (a first-occurrence argmin within a chunk, a strict-less merge across
    chunks); ``depth_resolve_xla_plain`` and ``pass_events_xla_plain`` are
    that scan, op for op.  On a CUDA tensor the resolve is the four
    launches of ``csrc/scan_resolve.cu``: the pass's triangles culled once
    per super-block into lists in submission order, then a walk of its
    super-block's list, in that order, per pixel of each block, which
    keeps the same depth, winner and events for any ``chunk`` (the
    arguments are in the kernel's source); ``scan_resolve_split_plain``
    is that decomposition in PyTorch.

  Phase B (``shade_winners``): per pixel, the winner's vertices gathered,
    barycentrics at the pixel centre, perspective-correct weights, the
    varyings interpolated and the fragment shader run once, densely, in
    plain PyTorch on either device (the JAX package computes it outside
    any Pallas kernel too).

All discontinuous decisions go through ``ops.semantics``, so the frame is
the float32 oracle's and the tiled backend's, bitwise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tinyrenderder_tpu_torch import _build, shaders, trace
from tinyrenderder_tpu_torch.ops import semantics
from tinyrenderder_tpu_torch.ops.raster_coarse import GEOM, build_tri_records
from tinyrenderder_tpu_torch.ops.raster_tiled import cdiv, vertex_stage

__all__ = ["BACKGROUND", "FrameBuffers", "PassEvents", "new_framebuffers", "pass_stats",
           "ScanGeometry", "SCAN_GEOMETRY", "kernel_geometry", "depth_resolve_xla",
           "depth_resolve_xla_plain", "pass_events_xla",
           "pass_events_xla_plain", "scan_super_lists_plain", "scan_block_lists_plain",
           "scan_resolve_split_plain", "scan_lists", "shade_winners", "render_pass_xla"]

BACKGROUND = -1  # winner id for empty pixels

#: triangles a warp of the resolve kernel's list launches takes (a unit)
SCAN_UNIT = 32
#: triangles of each block's list that the split plain version's steps take
_SPLIT_STEP = 32

_INT32_MAX = 2**31 - 1
_INT32_MIN = -2**31

# user calls that launch the resolve kernel are counted (``trace.count``,
# the CPU path does not count) as launch.scan_resolve and
# launch.scan_resolve_stats, without and with the z-pass events


class ScanGeometry(NamedTuple):
    """The resolve kernel's walk block and super-block, in pixels
    (``csrc/scan_resolve.cu``'s kBlockW, kBlockH and kSuperPx, a multiple
    of both).  The wrapper asks the library for its own; the plain versions
    take one."""

    block_w: int
    block_h: int
    super_px: int


#: the geometry csrc/scan_resolve.cu is built with
SCAN_GEOMETRY = ScanGeometry(8, 32, 128)


def kernel_geometry() -> ScanGeometry:
    """The loaded kernel library's ``ScanGeometry``."""
    return ScanGeometry(*(_build.constant(f"trt_scan_{k}")
                          for k in ("block_w", "block_h", "super_px")))


class FrameBuffers(NamedTuple):
    """The frame in image layout (the reference's framebuffer and
    zbuffer, our_gl.cpp:12-15)."""

    color: torch.Tensor    # (H, W, 3) uint8
    depth: torch.Tensor    # (H, W) float32, +inf where empty
    winner: torch.Tensor   # (H, W) int32 triangle id of the depth owner


class PassEvents(NamedTuple):
    """One pass's exact counters, on the device (our_gl.cpp:194-200)."""

    setup: dict               # the pass's triangle setup (for pass_stats)
    fragments: torch.Tensor   # 0-d int64: z-pass events, overdraw included
    min_z: torch.Tensor       # 0-d f32: least event z (+inf when none)
    max_z: torch.Tensor       # 0-d f32: largest event z (-inf when none)


def new_framebuffers(width: int, height: int, device) -> FrameBuffers:
    """init_zbuffer semantics on ``device``: colour 0, depth +inf
    (our_gl.cpp:72-74), winner ``BACKGROUND``."""
    return FrameBuffers(
        color=torch.zeros((height, width, 3), dtype=torch.uint8, device=device),
        depth=torch.full((height, width), torch.inf, dtype=torch.float32, device=device),
        winner=torch.full((height, width), BACKGROUND, dtype=torch.int32, device=device))


def pass_stats(setup: dict) -> dict:
    """The reference's per-pass counters from a setup dict
    (our_gl.cpp:18-22): triangle count, valid-triangle count and the
    extremes of the valid triangles' clamped bboxes (the int32 sentinels
    when none is valid).  Reads the host once."""
    valid = setup["valid"]
    bbox = setup["bbox"].to(torch.int64)
    none = torch.tensor([[_INT32_MAX, _INT32_MIN, _INT32_MAX, _INT32_MIN]],
                        dtype=torch.int64, device=bbox.device)
    b = torch.cat([torch.where(valid[:, None], bbox, none), none])
    min_x, max_x, min_y, max_y, n_valid = trace.readback(torch.stack(
        [b[:, 0].amin(), b[:, 1].amax(), b[:, 2].amin(), b[:, 3].amax(), valid.sum()]))
    return dict(min_x=min_x, max_x=max_x, min_y=min_y, max_y=max_y,
                triangles=int(valid.shape[0]), valid_triangles=n_valid)


# ---------------------------------------------------------------------------
# phase A, plain: the JAX package's chunked scan
# ---------------------------------------------------------------------------

def _chunk_windows(setup: dict, chunk: int, height: int, width: int, x0: int, y0: int):
    """(first triangle, end, (row slice, column slice)) of each chunk with a
    valid triangle whose bbox meets the buffer, in order.  The window is
    the union of those bboxes cut to the buffer: every pixel outside it
    fails the chunk's bbox or valid test, so the scan step leaves it as it
    was and has no event there.  Reads the bboxes to the host once."""
    valid = setup["valid"].cpu().numpy()
    bbox = setup["bbox"].cpu().numpy().astype(np.int64)
    f = valid.shape[0]
    n = -(-f // chunk)
    pad = n * chunk - f
    valid = np.pad(valid, (0, pad))
    bbox = np.pad(bbox, ((0, pad), (0, 0)))
    big = np.int64(1) << 40

    def ext(col, fill, op):
        return op(np.where(valid, bbox[:, col], fill).reshape(n, chunk), axis=1)

    lo_x = np.maximum(ext(0, big, np.min) - x0, 0)
    hi_x = np.minimum(ext(1, -big, np.max) - x0, width - 1)
    lo_y = np.maximum(ext(2, big, np.min) - y0, 0)
    hi_y = np.minimum(ext(3, -big, np.max) - y0, height - 1)
    keep = np.flatnonzero((lo_x <= hi_x) & (lo_y <= hi_y))
    return [(int(c) * chunk, min(int(c + 1) * chunk, f),
             (slice(int(lo_y[c]), int(hi_y[c]) + 1), slice(int(lo_x[c]), int(hi_x[c]) + 1)))
            for c in keep]


def _chunk_depths(setup: dict, c0: int, c1: int, win, x0: int, y0: int):
    """The scan step's covered depths of triangles c0 .. c1 - 1 over the
    window (K, h, w): +inf where a triangle does not cover the pixel
    (``depth_resolve_xla``'s step up to its argmin)."""
    dev = setup["screen"].device
    ys, xs = win
    xi = (x0 + torch.arange(xs.start, xs.stop, dtype=torch.int32, device=dev))[None, None, :]
    yi = (y0 + torch.arange(ys.start, ys.stop, dtype=torch.int32, device=dev))[None, :, None]
    return _covered_depths(setup["screen"][c0:c1], setup["ndc_z"][c0:c1],
                           setup["bbox"][c0:c1], setup["valid"][c0:c1], xi, yi)


def _covered_depths(screen, ndc_z, bbox, valid, xi, yi):
    """The covered affine depths of triangles (leading dims T: screen T +
    (3, 2), ndc_z T + (3,), bbox T + (4,) int32, valid T) at the pixels of
    global columns ``xi`` and rows ``yi`` (int32, broadcastable to T + (h,
    w)): +inf where a triangle does not cover the pixel."""
    px = xi.to(torch.float32) + 0.5
    py = yi.to(torch.float32) + 0.5
    screen = screen.to(torch.float32)
    ndc_z = ndc_z.to(torch.float32)

    def per_tri(t):  # T -> T + (1, 1)
        return t[..., None, None]

    b0, b1, b2, _ = semantics.barycentric(
        per_tri(screen[..., 0, 0]), per_tri(screen[..., 0, 1]), per_tri(screen[..., 1, 0]),
        per_tri(screen[..., 1, 1]), per_tri(screen[..., 2, 0]), per_tri(screen[..., 2, 1]),
        px, py)
    covered = semantics.coverage_mask(b0, b1, b2)
    z = semantics.affine_z(per_tri(ndc_z[..., 0]), per_tri(ndc_z[..., 1]),
                           per_tri(ndc_z[..., 2]), b0, b1, b2)
    covered &= torch.isfinite(z)
    # only pixels inside the clamped integer bbox are visited (our_gl.cpp:147-148)
    covered &= ((xi >= per_tri(bbox[..., 0]))
                & (xi <= per_tri(bbox[..., 1]))
                & (yi >= per_tri(bbox[..., 2]))
                & (yi <= per_tri(bbox[..., 3])))
    covered &= per_tri(valid)
    return torch.where(covered, z, torch.inf)


def _merge(zc, c0: int, depth, winner, win) -> None:
    """The chunk's first-occurrence argmin merged into the window of the
    running buffers, in place, on strict less-than: the first drawn wins."""
    best = torch.argmin(zc, dim=0)                       # first min = lowest id
    zmin = torch.gather(zc, 0, best[None])[0]
    zbuf = depth[win]
    better = zmin < zbuf
    depth[win] = torch.where(better, zmin, zbuf)
    winner[win] = torch.where(better, (best + c0).to(torch.int32), winner[win])


def _init_buffers(height: int, width: int, device, init_depth, init_winner):
    depth = (torch.full((height, width), torch.inf, dtype=torch.float32, device=device)
             if init_depth is None else init_depth.to(torch.float32).clone())
    winner = (torch.full((height, width), BACKGROUND, dtype=torch.int32, device=device)
              if init_winner is None else init_winner.clone())
    return depth, winner


def depth_resolve_xla_plain(setup: dict, height: int, width: int, chunk: int = 8,
                            init_depth=None, init_winner=None, x0: int = 0, y0: int = 0):
    """Phase A as the JAX package's scan: chunks of ``chunk`` triangles in
    order, each step evaluated over the window of its bboxes
    (``_chunk_windows``).  ``setup``: ``semantics.triangle_setup_planes``
    of (F, 3, 4) clip.  x0/y0: the global pixel of the buffer's top-left
    corner (a row band of the frame; bboxes stay global).  Returns
    (depth (H, W) f32, winner (H, W) int32) on setup's device."""
    depth, winner = _init_buffers(height, width, setup["screen"].device, init_depth,
                                  init_winner)
    for c0, c1, win in _chunk_windows(setup, chunk, height, width, x0, y0):
        _merge(_chunk_depths(setup, c0, c1, win, x0, y0), c0, depth, winner, win)
    return depth, winner


def pass_events_xla_plain(setup: dict, init_depth, height: int, width: int,
                          chunk: int = 8, x0: int = 0, y0: int = 0):
    """Phase A with the exact per-pass event counters, as the JAX
    package's ``pass_events_xla`` scan: within a chunk, event k fires at a
    pixel iff ``zc[k] < min(running depth, zc[0..k-1])`` (a ``cummin`` and
    its exclusive shift); ``frags`` counts the events (int32; overdraw
    included, our_gl.cpp:194-200), ``max_z`` is their largest z and
    ``min_z`` the least depth over the pixels this pass won.  The winner
    starts at ``BACKGROUND``.  Returns (depth, winner, frags, min_z, max_z),
    the last three 0-d."""
    dev = setup["screen"].device
    depth, winner = _init_buffers(height, width, dev, init_depth, None)
    frags = torch.zeros((), dtype=torch.int32, device=dev)
    max_z = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
    for c0, c1, win in _chunk_windows(setup, chunk, height, width, x0, y0):
        zc = _chunk_depths(setup, c0, c1, win, x0, y0)
        incl = torch.cummin(zc, dim=0).values
        excl = torch.cat([torch.full_like(zc[:1], torch.inf), incl[:-1]])
        thresh = torch.minimum(excl, depth[win][None])
        events = zc < thresh
        frags = frags + events.sum(dtype=torch.int32)
        max_z = torch.maximum(max_z, torch.where(events, zc, -torch.inf).amax())
        _merge(zc, c0, depth, winner, win)
    min_z = torch.where(winner >= 0, depth, torch.inf).amin()
    return depth, winner, frags, min_z, max_z


# ---------------------------------------------------------------------------
# phase A, plain: the resolve kernel's decomposition (super-block and block lists)
# ---------------------------------------------------------------------------

def _block_grid(height: int, width: int, geom: ScanGeometry):
    """(blocks across, down, blocks a super-block across, down,
    super-blocks across, down) of an (H, W) buffer."""
    nbx, nby = cdiv(width, geom.block_w), cdiv(height, geom.block_h)
    sw, sh = geom.super_px // geom.block_w, geom.super_px // geom.block_h
    return nbx, nby, sw, sh, cdiv(nbx, sw), cdiv(nby, sh)


def scan_super_lists_plain(setup: dict, height: int, width: int, x0: int = 0, y0: int = 0,
                           geom: ScanGeometry = SCAN_GEOMETRY):
    """The resolve kernel's super-block lists (its launches 1-3).  The (H,
    W) buffer at global pixel (x0, y0) is cut into blocks of ``geom``'s
    block_w x block_h pixels and those into super-blocks of super_px²
    pixels, row-major.  A super-block's list holds, in submission order,
    each valid triangle whose integer bbox, cut to the buffer, meets it, as
    (triangle, range): the bbox's blocks cut to the super-block, in local
    block indices packed x0 | x1 << 8 | y0 << 16 | y1 << 24.  Returns
    (lengths (S,) int32, lists (S, F, 2) int32, zero past each length)."""
    dev = setup["valid"].device
    f = setup["valid"].shape[0]
    _, _, sw, sh, nsx, nsy = _block_grid(height, width, geom)
    b = setup["bbox"].to(torch.int64)
    lx, hx = b[:, 0].clamp(min=x0), b[:, 1].clamp(max=x0 + width - 1)
    ly, hy = b[:, 2].clamp(min=y0), b[:, 3].clamp(max=y0 + height - 1)
    meets = setup["valid"] & (lx <= hx) & (ly <= hy)
    rng = torch.stack([(lx - x0) // geom.block_w, (hx - x0) // geom.block_w,
                       (ly - y0) // geom.block_h, (hy - y0) // geom.block_h], dim=1)
    lengths = torch.zeros(nsx * nsy, dtype=torch.int32, device=dev)
    lists = torch.zeros((nsx * nsy, f, 2), dtype=torch.int32, device=dev)
    for s in range(nsx * nsy):
        bx, by = s % nsx * sw, s // nsx * sh          # the super-block's first block
        tri = torch.nonzero(meets & (rng[:, 0] < bx + sw) & (rng[:, 1] >= bx)
                            & (rng[:, 2] < by + sh) & (rng[:, 3] >= by)).flatten()
        r = rng[tri]
        box = ((r[:, 0] - bx).clamp(min=0) | (r[:, 1] - bx).clamp(max=sw - 1) << 8
               | (r[:, 2] - by).clamp(min=0) << 16 | (r[:, 3] - by).clamp(max=sh - 1) << 24)
        n = tri.shape[0]
        lists[s, :n, 0] = tri.to(torch.int32)
        lists[s, :n, 1] = box.to(torch.int32)
        lengths[s] = n
    return lengths, lists


def scan_block_lists_plain(lengths, lists, height: int, width: int,
                           geom: ScanGeometry = SCAN_GEOMETRY):
    """Each block's list (the resolve kernel's walk, launch 4): the
    triangles of its super-block's list (``scan_super_lists_plain``) whose
    range holds the block, in list order.  Returns (blocks, K) int64,
    blocks row-major, -1 past each block's list."""
    nbx, nby, sw, sh, nsx, nsy = _block_grid(height, width, geom)
    per_block = [lists.new_empty((0,), dtype=torch.int64)] * (nbx * nby)
    for s in range(nsx * nsy):
        e = lists[s, :int(lengths[s])].to(torch.int64)
        box = e[:, 1]
        lo_x, hi_x = box & 0xFF, (box >> 8) & 0xFF
        lo_y, hi_y = (box >> 16) & 0xFF, (box >> 24) & 0xFF
        bx, by = s % nsx * sw, s // nsx * sh
        for j in range(sw * sh):
            ly, lx = divmod(j, sw)
            if bx + lx < nbx and by + ly < nby:
                holds = (lo_x <= lx) & (hi_x >= lx) & (lo_y <= ly) & (hi_y >= ly)
                per_block[(by + ly) * nbx + bx + lx] = e[holds, 0]
    return torch.nn.utils.rnn.pad_sequence(per_block, batch_first=True, padding_value=-1)


def scan_resolve_split_plain(setup: dict, height: int, width: int, init_depth=None,
                             init_winner=None, x0: int = 0, y0: int = 0,
                             collect_stats: bool = False,
                             geom: ScanGeometry = SCAN_GEOMETRY):
    """Phase A as the resolve kernel decomposes it: the super-block lists,
    the block lists (``scan_block_lists_plain``), then each block walks its
    list in order, _SPLIT_STEP triangles at a time: the scan's step (a
    first-occurrence argmin merged on strict less-than, the events by
    ``pass_events_xla_plain``'s rule) on the block's pixels, so the result
    is the same for any step.  Pixels outside the buffer walk
    nothing.  Returns (depth, winner) or, with ``collect_stats``, (depth,
    winner, event count 0-d int32, largest event z 0-d f32)."""
    dev = setup["screen"].device
    nbx, nby = _block_grid(height, width, geom)[:2]
    blocks = scan_block_lists_plain(*scan_super_lists_plain(setup, height, width, x0, y0, geom),
                                    height, width, geom)
    depth, winner = _init_buffers(height, width, dev, init_depth, init_winner)
    bw, bh, nb = geom.block_w, geom.block_h, nbx * nby

    def to_blocks(plane, fill):   # (H, W) -> (blocks, bh, bw), padded with fill
        padded = torch.full((nby * bh, nbx * bw), fill, dtype=plane.dtype, device=dev)
        padded[:height, :width] = plane
        return padded.reshape(nby, bh, nbx, bw).transpose(1, 2).reshape(nb, bh, bw)

    d_blk, w_blk = to_blocks(depth, torch.inf), to_blocks(winner, BACKGROUND)
    at = torch.arange(nb, dtype=torch.int32, device=dev)
    cols = (at % nbx * bw)[:, None] + torch.arange(bw, dtype=torch.int32, device=dev)
    rows = (at // nbx * bh)[:, None] + torch.arange(bh, dtype=torch.int32, device=dev)
    inside = (cols < width)[:, None, :] & (rows < height)[:, :, None]
    lengths = (blocks >= 0).sum(dim=1)
    frags = torch.zeros((), dtype=torch.int32, device=dev)
    max_z = torch.tensor(-torch.inf, dtype=torch.float32, device=dev)
    for k0 in range(0, blocks.shape[1], _SPLIT_STEP):
        act = torch.nonzero(lengths > k0).flatten()
        ids = blocks[act, k0:k0 + _SPLIT_STEP]            # (a, k), -1 past a list
        tri = ids.clamp(min=0)
        zc = _covered_depths(setup["screen"][tri], setup["ndc_z"][tri], setup["bbox"][tri],
                             setup["valid"][tri] & (ids >= 0),
                             (x0 + cols[act])[:, None, None, :],
                             (y0 + rows[act])[:, None, :, None])
        zc = torch.where(inside[act][:, None], zc, torch.inf)     # (a, k, bh, bw)
        d = d_blk[act]
        if collect_stats:
            incl = torch.cummin(zc, dim=1).values
            excl = torch.cat([torch.full_like(zc[:, :1], torch.inf), incl[:, :-1]], dim=1)
            events = zc < torch.minimum(excl, d[:, None])
            frags = frags + events.sum(dtype=torch.int32)
            max_z = torch.maximum(max_z, torch.where(events, zc, -torch.inf).amax())
        best = torch.argmin(zc, dim=1)                    # first min = earliest in the list
        zmin = torch.gather(zc, 1, best[:, None])[:, 0]
        better = zmin < d
        won = torch.gather(ids, 1, best.flatten(1)).reshape(best.shape).to(torch.int32)
        d_blk[act] = torch.where(better, zmin, d)
        w_blk[act] = torch.where(better, won, w_blk[act])

    def to_plane(blk):
        return blk.reshape(nby, nbx, bh, bw).transpose(1, 2).reshape(nby * bh, nbx * bw)[
            :height, :width].contiguous()

    out = (to_plane(d_blk), to_plane(w_blk))
    return out + ((frags, max_z) if collect_stats else ())


# ---------------------------------------------------------------------------
# phase A: the dispatch (CPU tensors: the plain scan; CUDA tensors: the kernel)
# ---------------------------------------------------------------------------

def _check_plane(name: str, t, dtype, shape, device) -> None:
    if t is None:
        return
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {shape} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(setup: dict, height: int, width: int, init_depth, init_winner, x0: int,
            y0: int, stats: bool, with_lists: bool = False, counter: str | None = None):
    """The four launches of ``csrc/scan_resolve.cu`` on CUDA tensors ->
    (depth, winner[, (event count (1,) int32, largest event z (1,) f32)]
    [, (list lengths (S,), super-block lists (S, F, 2))]).  The workspace
    (the counts and the lists, each sized for every triangle) comes from
    the shapes alone: nothing is read back.  The call is counted as
    ``counter`` unless it is None."""
    dev = setup["screen"].device
    if dev.type != "cuda":
        raise ValueError(f"no scan resolve for device {dev}")
    _check_plane("init_depth", init_depth, torch.float32, (height, width), dev)
    _check_plane("init_winner", init_winner, torch.int32, (height, width), dev)
    rec = build_tri_records(setup)                      # (F, 16): the geometry columns
    valid = setup["valid"].contiguous()
    f = rec.shape[0]
    nsx, nsy = _block_grid(height, width, kernel_geometry())[4:]
    counts = torch.empty((nsx * nsy, cdiv(f, SCAN_UNIT) + 1), dtype=torch.int32, device=dev)
    lists = torch.empty((nsx * nsy, f, 2), dtype=torch.int32, device=dev)
    depth = torch.empty((height, width), dtype=torch.float32, device=dev)
    winner = torch.empty((height, width), dtype=torch.int32, device=dev)
    ev = ((torch.zeros(1, dtype=torch.int32, device=dev),
           torch.full((1,), -torch.inf, dtype=torch.float32, device=dev)) if stats else None)
    if counter is not None:
        trace.count(counter)
    _build.call("trt_scan_resolve", dev, rec.data_ptr(), GEOM, valid.data_ptr(), f, height,
                width, int(x0), int(y0),
                None if init_depth is None else init_depth.data_ptr(),
                None if init_winner is None else init_winner.data_ptr(),
                depth.data_ptr(), winner.data_ptr(), ev[0].data_ptr() if ev else None,
                ev[1].data_ptr() if ev else None, counts.data_ptr(), lists.data_ptr())
    return ((depth, winner) + ((ev,) if stats else ())
            + (((counts[:, -1], lists),) if with_lists else ()))


def scan_lists(setup: dict, height: int, width: int, x0: int = 0, y0: int = 0):
    """The resolve's super-block lists of a non-empty pass -> (lengths (S,)
    int32, lists (S, F, 2) int32, defined up to each length): on CUDA
    tensors the kernel's own (one uncounted resolve), on CPU tensors
    ``scan_super_lists_plain``'s."""
    if setup["screen"].device.type == "cpu":
        return scan_super_lists_plain(setup, height, width, x0, y0)
    return _launch(setup, height, width, None, None, x0, y0, False, with_lists=True)[2]


def depth_resolve_xla(setup: dict, height: int, width: int, chunk: int = 8,
                      init_depth=None, init_winner=None, x0: int = 0, y0: int = 0):
    """Phase A over the (H, W) buffer at global pixel (x0, y0) -> (depth,
    winner).  CPU tensors take the plain scan (``depth_resolve_xla_plain``
    in chunks of ``chunk``); CUDA tensors launch the kernel, whose result
    is the scan's for every ``chunk``."""
    if setup["screen"].device.type == "cpu":
        return depth_resolve_xla_plain(setup, height, width, chunk, init_depth, init_winner,
                                       x0, y0)
    if setup["valid"].shape[0] == 0:
        return _init_buffers(height, width, setup["screen"].device, init_depth, init_winner)
    return _launch(setup, height, width, init_depth, init_winner, x0, y0, False,
                   counter="launch.scan_resolve")


def pass_events_xla(setup: dict, init_depth, height: int, width: int, chunk: int = 8,
                    x0: int = 0, y0: int = 0):
    """Phase A with the exact event counters (``pass_events_xla_plain``'s
    contract) -> (depth, winner, frags int32, min_z, max_z).  CPU tensors
    take the plain scan; CUDA tensors launch the kernel with its event
    sums (the same depth and winner as ``depth_resolve_xla``)."""
    dev = setup["screen"].device
    if dev.type == "cpu":
        return pass_events_xla_plain(setup, init_depth, height, width, chunk, x0, y0)
    if setup["valid"].shape[0] == 0:
        depth, winner = _init_buffers(height, width, dev, init_depth, None)
        return (depth, winner, torch.zeros((), dtype=torch.int32, device=dev),
                torch.tensor(torch.inf, device=dev), torch.tensor(-torch.inf, device=dev))
    depth, winner, (count, max_z) = _launch(setup, height, width, init_depth, None, x0, y0,
                                            True, counter="launch.scan_resolve_stats")
    min_z = torch.where(winner >= 0, depth, torch.inf).amin()
    return depth, winner, count[0], min_z, max_z[0]


# ---------------------------------------------------------------------------
# phase B and the pass
# ---------------------------------------------------------------------------

def shade_winners(fb_color, winner_local, setup: dict, varyings: dict, shader,
                  uniforms: dict, height: int, width: int, x0: int = 0, y0: int = 0):
    """Phase B: the fragment shader once per pixel this pass won.
    ``winner_local``: (H, W) int32, this pass's triangle index per pixel,
    ``BACKGROUND`` where it did not win; ``varyings``: the vertex stage's
    {name: (F, 3, C)}.  Returns the (H, W, 3) uint8 colour: the shaded
    fragment where the pass won, ``fb_color`` elsewhere."""
    f = setup["valid"].shape[0]
    if f == 0:
        return fb_color
    dev = winner_local.device
    mine = winner_local >= 0
    widx = torch.clamp(winner_local, 0, f - 1).long()
    scr = setup["screen"][widx]          # (H, W, 3, 2)
    ws = setup["clip_w"][widx]           # (H, W, 3)
    px = (torch.arange(width, dtype=torch.float32, device=dev) + float(x0))[None, :] + 0.5
    py = (torch.arange(height, dtype=torch.float32, device=dev) + float(y0))[:, None] + 0.5
    px = px.expand(height, width)
    py = py.expand(height, width)
    b0, b1, b2, _ = semantics.barycentric(
        scr[..., 0, 0], scr[..., 0, 1], scr[..., 1, 0], scr[..., 1, 1],
        scr[..., 2, 0], scr[..., 2, 1], px, py)
    pb0, pb1, pb2 = semantics.perspective_correct_bary(
        b0, b1, b2, ws[..., 0], ws[..., 1], ws[..., 2])
    vary_pix = {}
    for name, v in varyings.items():
        vw = v[widx]                     # (H, W, 3, C)
        vary_pix[name] = semantics.interp3(
            vw[..., 0, :], vw[..., 1, :], vw[..., 2, :],
            pb0[..., None], pb1[..., None], pb2[..., None])
    out = shaders.finalize_color(shaders.fragment(shader, uniforms, vary_pix))
    return torch.where(mine[..., None], out, fb_color)


def render_pass_xla(fb: FrameBuffers, attrs: dict, shader, uniforms: dict,
                    winner_offset: int = 0, chunk: int = 8, collect_stats: bool = False):
    """Render one (mesh, shader) pass into ``fb`` through the scan backend.
    ``attrs``: {name: (F, 3, C) f32} and ``uniforms`` as tensors on the
    frame's device.  The pass's resolve is seeded with the frame's depth
    and a fresh winner plane, so a triangle wins a pixel only by beating
    the earlier passes and its own pass's competitors: the serial
    semantics.  A depth-only pass shades nothing.  Returns (new
    FrameBuffers, the pass's setup, ``PassEvents`` with ``collect_stats``
    (one resolve with the event sums) or None)."""
    height, width = fb.color.shape[:2]
    with trace.span("pass.pre"):
        setup, varyings = vertex_stage(attrs, uniforms, shader, width, height)
    events = None
    with trace.span("pass.raster"):
        if collect_stats:
            depth, winner_local, frags, min_z, max_z = pass_events_xla(setup, fb.depth, height,
                                                                       width, chunk)
            events = PassEvents(setup, frags.to(torch.int64), min_z, max_z)
        else:
            depth, winner_local = depth_resolve_xla(setup, height, width, chunk,
                                                    init_depth=fb.depth)
    with trace.span("pass.merge_shade"):
        won = winner_local >= 0
        winner = torch.where(won, winner_local + winner_offset, fb.winner)
        color = (shade_winners(fb.color, winner_local, setup, varyings, shader, uniforms,
                               height, width) if shader.writes_color else fb.color)
    return FrameBuffers(color, depth, winner), setup, events
