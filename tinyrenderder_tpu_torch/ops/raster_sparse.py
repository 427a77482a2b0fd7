"""Active-tile sparse pipeline in PyTorch: the single-pass
direct-to-image route and the multi-pass tiled frame, each pass routed
to the coarse or the strip raster.  Also the untile kernels
(``csrc/untile.cu``: one plane, and the frame's three planes in one
launch), each with a second entry that stores the cropped image
(``untile_image``: compact tiles gathered by id, the colour unpacked to
RGB; ``untile3_image``: the frame's buffers), the hand-written pre-stage
(``csrc/pre.cu``) and merge + shade (``csrc/shade.cu``; its fresh-frame
entry shades the image route's pass), each with its plain PyTorch
version.

Counterpart of the coarse and fine branches of
``tinyrenderder_tpu/ops/raster_sparse.py``:

  * ``render_frame_fused_image`` with ``direct=False``
    (``_pre_sparse_jit`` or ``_pre_fine_jit``, ``_shade_compact_fresh``,
    ``_compact_to_image``, ``_untile_one_jit``, the crop and
    ``_unpack_rgb``: one ``untile_image`` launch here);
  * ``render_frame_fused`` and ``render_pass_tiles`` (``FrameTiles``,
    ``_post_sparse_jit``, ``_reduce_events_jit``, ``tiles_to_buffers``,
    ``_untile_call_jit``).  The JAX package has a fused XLA program and a
    per-pass loop because of XLA's dispatch cost; eager PyTorch has one
    loop with a ``collect_stats`` flag;
  * ``FINE_MODE`` (``decide_mode``), the forced modes of ``_decide_mode``:
    which raster every pass takes.  Both rasters give the same outputs,
    so the merge, the shading and the event reduction are shared.

Each pass reads back its totals once: the coarse route the (tile,
triangle) pair total and the active-tile count, the strip route the
strip pair total, the row total and the active-tile count.  Every
buffer is sized from them, so the TPU path's capacity cache, its
quantized capacities, its won-tile capacity and its overflow re-render
have no counterpart here: nothing can overflow.
"""

from __future__ import annotations

import functools
import struct
import time
import types
from typing import NamedTuple

import numpy as np
import torch

from tinyrenderder_tpu_torch import _build, math3d, shaders, trace
from tinyrenderder_tpu_torch.ops import raster_fine, raster_fine2
from tinyrenderder_tpu_torch.ops.raster import BACKGROUND, FrameBuffers, PassEvents
from tinyrenderder_tpu_torch.ops.raster_coarse import GEOM, build_tri_records, coarse_raster
from tinyrenderder_tpu_torch.ops.raster_tiled import (TILE_H, TILE_W, Band, active_ids,
                                                      band_spans, build_bins, cdiv,
                                                      n_vary_of, shader_varyings,
                                                      tile_pair_counts, vertex_stage)

__all__ = ["pack_rgb", "unpack_rgb", "pick_tile_h", "untile_one",
           "untile_one_plain", "untile3", "untile3_plain", "untile_image",
           "untile_image_plain", "untile3_image", "untile3_image_plain", "FrameTiles",
           "new_frame_tiles", "tiles_to_buffers", "PreSparse", "pre_sparse",
           "pre_sparse_plain", "pre_sparse_kernel", "pre_kind", "viewport_scalars",
           "shade_compact_fresh", "shade_compact_fresh_plain", "shade_compact_fresh_kernel",
           "compact_to_image", "post_sparse", "post_sparse_plain", "post_sparse_kernel",
           "shade_kind",
           "PassEvents", "reduce_events", "FINE_MODE", "decide_mode", "raster_pass",
           "grouped_pass", "walk_passes", "render_frame_fused", "render_frame_fused_image"]

# untile launches are counted by entry point (``trace.count``, the CPU path
# does not count): launch.untile_one and launch.untile_image launch the
# single-plane kernel, launch.untile3 and launch.untile3_image the
# three-plane kernel

#: frames at or above this pixel count use 32-row tiles (the reference's
#: TPU-tuned threshold; the frame does not depend on the tiling)
TILE_H_LARGE_PIXELS = 2_000_000


def pack_rgb(rgb_u8):
    """(..., 3) uint8 -> packed 0x00BBGGRR int32."""
    c = rgb_u8.to(torch.int32)
    return c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16)


def unpack_rgb(packed):
    """packed int32 -> (..., 3) uint8."""
    return torch.stack([packed & 0xFF, (packed >> 8) & 0xFF,
                        (packed >> 16) & 0xFF], dim=-1).to(torch.uint8)


def pick_tile_h(width: int, height: int) -> int:
    return 32 if width * height >= TILE_H_LARGE_PIXELS else TILE_H


# ---------------------------------------------------------------------------
# untile: (T, th, tw) 32-bit tiles -> (nty*th, ntx*tw) row-major image, and
# the same kernels storing a cropped image: (H, W) words or (H, W, 3) RGB
# ---------------------------------------------------------------------------

def untile_one_plain(x, n_tiles_x: int, n_tiles_y: int, tile_h: int, tile_w: int):
    return (x.reshape(n_tiles_y, n_tiles_x, tile_h, tile_w)
             .permute(0, 2, 1, 3)
             .reshape(n_tiles_y * tile_h, n_tiles_x * tile_w))


def _check_tiles(x, shape):
    if tuple(x.shape) != shape:
        raise ValueError(f"tiles must have shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("tiles must be contiguous")


def _check_crop(height: int, width: int, n_tiles_x: int, n_tiles_y: int, tile_h: int,
                tile_w: int):
    if not (0 < height <= n_tiles_y * tile_h and 0 < width <= n_tiles_x * tile_w):
        raise ValueError(f"a {height}x{width} crop does not fit {n_tiles_y}x{n_tiles_x} "
                         f"tiles of {tile_h}x{tile_w}")


def _on_cuda(device, tile_w: int, *xs) -> bool:
    """False for CPU tensors (the plain version); True for CUDA tensors the
    kernel takes; raises otherwise."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no untile for device {device}")
    if tile_w % 4 or any(x.data_ptr() % 16 for x in xs):
        raise ValueError("the CUDA untile moves 16-byte vectors: tile_w must be "
                         "a multiple of 4 and the tiles 16-byte aligned")
    return True


def untile_one(x, n_tiles_x: int, n_tiles_y: int, tile_h: int, tile_w: int):
    """One 32-bit tile plane -> image layout.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check_tiles(x, (n_tiles_x * n_tiles_y, tile_h, tile_w))
    if x.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"untile moves 32-bit words, got {x.dtype}")
    if not _on_cuda(x.device, tile_w, x):
        return untile_one_plain(x, n_tiles_x, n_tiles_y, tile_h, tile_w)
    out = torch.empty((n_tiles_y * tile_h, n_tiles_x * tile_w), dtype=x.dtype,
                      device=x.device)
    trace.count("launch.untile_one")
    _build.call("trt_untile32", x.device,
                x.data_ptr(), out.data_ptr(), n_tiles_x, n_tiles_y, tile_h, tile_w)
    return out


def untile_image_plain(x, ids, n_tiles_x: int, n_tiles_y: int, tile_h: int, tile_w: int,
                       height: int, width: int, fill=0, rgb: bool = False):
    """``compact_to_image`` (or, with ``ids`` None, ``untile_one_plain``),
    cropped, and ``unpack_rgb`` when ``rgb``."""
    if ids is None:
        img = untile_one_plain(x, n_tiles_x, n_tiles_y, tile_h, tile_w)
    else:
        img = compact_to_image(x, ids, n_tiles_x, n_tiles_y, tile_h, tile_w, fill,
                               untile=untile_one_plain)
    img = img[:height, :width]
    return unpack_rgb(img) if rgb else img.contiguous()


def _fill_bits(fill, dtype) -> int:
    """The 32-bit pattern of ``fill`` as a ``dtype`` word, as a signed int."""
    return struct.unpack("<i", struct.pack("<f" if dtype == torch.float32 else "<i",
                                           fill))[0]


def untile_image(x, ids, n_tiles_x: int, n_tiles_y: int, tile_h: int, tile_w: int,
                 height: int, width: int, fill=0, rgb: bool = False):
    """One 32-bit plane straight to a cropped image, in one launch of the
    single-plane kernel: tile ``ids[k]`` is ``x[k]`` (a compact (A, th, tw)
    stack; ``fill`` where a tile is absent), or with ``ids`` None tile t is
    ``x[t]``.  -> (height, width) in ``x``'s dtype, or with ``rgb`` the
    packed 0x00BBGGRR int32 colour as (height, width, 3) uint8.

    The kernel finds a tile's slot by a binary search, so ``ids`` must be
    ascending and unique, as every pre-stage emits them (``active_ids``).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    n = n_tiles_x * n_tiles_y if ids is None else ids.shape[0]
    _check_tiles(x, (n, tile_h, tile_w))
    if x.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"untile moves 32-bit words, got {x.dtype}")
    if rgb and x.dtype != torch.int32:
        raise ValueError(f"rgb unpacks packed int32 colour, got {x.dtype}")
    if ids is not None and (ids.dtype != torch.int32 or ids.dim() != 1
                            or not ids.is_contiguous() or ids.device != x.device):
        raise ValueError("ids must be a contiguous (A,) int32 tensor on the tiles' device")
    _check_crop(height, width, n_tiles_x, n_tiles_y, tile_h, tile_w)
    if not _on_cuda(x.device, tile_w, x):
        return untile_image_plain(x, ids, n_tiles_x, n_tiles_y, tile_h, tile_w, height,
                                  width, fill, rgb)
    out = torch.empty((height, width, 3) if rgb else (height, width),
                      dtype=torch.uint8 if rgb else x.dtype, device=x.device)
    trace.count("launch.untile_image")
    _build.call("trt_untile_image", x.device,
                x.data_ptr(), None if ids is None else ids.data_ptr(), n, out.data_ptr(),
                n_tiles_x, n_tiles_y, tile_h, tile_w, height, width,
                _fill_bits(fill, x.dtype), int(rgb))
    return out


def _check_planes(color, depth, winner, shape):
    for x, dtype in ((color, torch.int32), (depth, torch.float32), (winner, torch.int32)):
        _check_tiles(x, shape)
        if x.dtype != dtype:
            raise ValueError(f"untile3 planes are int32, float32, int32; got {x.dtype}")
        if x.device != color.device:
            raise ValueError("untile3 planes must share a device")


def untile3_plain(color, depth, winner, n_tiles_x: int, n_tiles_y: int,
                  tile_h: int, tile_w: int):
    return tuple(untile_one_plain(x, n_tiles_x, n_tiles_y, tile_h, tile_w).contiguous()
                 for x in (color, depth, winner))


def untile3(color, depth, winner, n_tiles_x: int, n_tiles_y: int, tile_h: int,
            tile_w: int):
    """The frame's packed colour (int32), depth (float32) and winner
    (int32) tile planes -> three image-layout planes, in one launch.
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    its three planes views of one allocation (one allocator call, not
    three: the wrapper's host time is most of its time)."""
    _check_planes(color, depth, winner, (n_tiles_x * n_tiles_y, tile_h, tile_w))
    if not _on_cuda(color.device, tile_w, color, depth, winner):
        return untile3_plain(color, depth, winner, n_tiles_x, n_tiles_y, tile_h, tile_w)
    c, d, w = torch.empty((3, n_tiles_y * tile_h, n_tiles_x * tile_w), dtype=torch.int32,
                          device=color.device).unbind(0)
    outs = (c, d.view(torch.float32), w)
    trace.count("launch.untile3")
    _build.call("trt_untile3", color.device,
                color.data_ptr(), depth.data_ptr(), winner.data_ptr(),
                *(o.data_ptr() for o in outs), n_tiles_x, n_tiles_y, tile_h, tile_w)
    return outs


def untile3_image_plain(color, depth, winner, n_tiles_x: int, n_tiles_y: int,
                        tile_h: int, tile_w: int, height: int, width: int):
    """``untile3_plain``, cropped, the colour through ``unpack_rgb``."""
    c, d, w = untile3_plain(color, depth, winner, n_tiles_x, n_tiles_y, tile_h, tile_w)
    return (unpack_rgb(c[:height, :width]), d[:height, :width].contiguous(),
            w[:height, :width].contiguous())


def untile3_image(color, depth, winner, n_tiles_x: int, n_tiles_y: int, tile_h: int,
                  tile_w: int, height: int, width: int):
    """The frame's three tile planes straight to its buffers, in one launch
    of the three-plane kernel: -> (colour (height, width, 3) uint8 unpacked
    from 0x00BBGGRR, depth (height, width) float32, winner (height, width)
    int32).  CPU tensors take the plain version; CUDA tensors launch the
    kernel, depth and winner views of one allocation."""
    _check_planes(color, depth, winner, (n_tiles_x * n_tiles_y, tile_h, tile_w))
    _check_crop(height, width, n_tiles_x, n_tiles_y, tile_h, tile_w)
    if not _on_cuda(color.device, tile_w, color, depth, winner):
        return untile3_image_plain(color, depth, winner, n_tiles_x, n_tiles_y, tile_h,
                                   tile_w, height, width)
    dev = color.device
    d, w = torch.empty((2, height, width), dtype=torch.int32, device=dev).unbind(0)
    outs = (torch.empty((height, width, 3), dtype=torch.uint8, device=dev),
            d.view(torch.float32), w)
    trace.count("launch.untile3_image")
    _build.call("trt_untile3_image", dev,
                color.data_ptr(), depth.data_ptr(), winner.data_ptr(),
                *(o.data_ptr() for o in outs), n_tiles_x, n_tiles_y, tile_h, tile_w,
                height, width)
    return outs


# ---------------------------------------------------------------------------
# the frame in tiled layout
# ---------------------------------------------------------------------------

class FrameTiles(NamedTuple):
    """Framebuffers resident in tiled layout across every pass of a
    frame: tile t covers pixel rows (t // ntx)*th .. +th and columns
    (t % ntx)*tw .. +tw.  Ragged-edge padding pixels are never covered
    (the bbox test is in global pixel coordinates), so they stay
    background and cropping after the untile is exact.  Colour is packed
    0x00BBGGRR int32, so all three planes are 32-bit (T, th, tw)."""

    color: torch.Tensor    # (T, th, tw) int32, packed 0x00BBGGRR
    depth: torch.Tensor    # (T, th, tw) float32
    winner: torch.Tensor   # (T, th, tw) int32


def new_frame_tiles(width: int, height: int, device, tile_h: int = TILE_H,
                    tile_w: int = TILE_W) -> FrameTiles:
    n = cdiv(width, tile_w) * cdiv(height, tile_h)
    shape = (n, tile_h, tile_w)
    return FrameTiles(
        color=torch.zeros(shape, dtype=torch.int32, device=device),
        depth=torch.full(shape, torch.inf, dtype=torch.float32, device=device),
        winner=torch.full(shape, BACKGROUND, dtype=torch.int32, device=device))


def tiles_to_buffers(ft: FrameTiles, width: int, height: int,
                     tile_h: int = TILE_H, tile_w: int = TILE_W) -> FrameBuffers:
    """Untile the frame's three planes, crop the ragged edge and unpack
    the colour (``untile3_image``: one launch on the card)."""
    return FrameBuffers(*untile3_image(ft.color, ft.depth, ft.winner, cdiv(width, tile_w),
                                       cdiv(height, tile_h), tile_h, tile_w, height, width))


# ---------------------------------------------------------------------------
# pre-stage
# ---------------------------------------------------------------------------

class PreSparse(NamedTuple):
    """Pre-kernel stage outputs.  ``ids`` are the active (non-empty) tile
    ids, ascending; ``start``/``counts`` their CSR segments of
    ``sorted_tri``."""
    tri_rec: torch.Tensor      # (F, 16 + 3V) f32
    sorted_tri: torch.Tensor   # (total,) i32
    ids: torch.Tensor          # (n_active,) i32
    start: torch.Tensor        # (n_active,) i32
    counts: torch.Tensor       # (n_active,) i32
    total: int
    n_active: int
    setup: dict                # the triangle setup (valid, screen, ..., bbox)


def pre_sparse(attrs: dict, uniforms: dict, shader, width: int, height: int,
               tile_h: int = TILE_H, tile_w: int = TILE_W, band: Band | None = None) -> PreSparse:
    """Vertex stage, binning, per-triangle records and active-tile
    compaction (``_pre_sparse_jit``), over every tile or over ``band``'s
    window (band-local tile ids).  Holds the pass's one host readback.

    A pass the hand-written pre-stage takes (``pre_kind``) runs it
    (``csrc/pre.cu``: three launches and the readback of one word);
    every other pass runs ``pre_sparse_plain``.  Both give the same
    outputs bitwise.  Each pass is counted as ``pre.kernel`` or
    ``pre.plain``."""
    kind = pre_kind(attrs, uniforms, shader, band)
    if kind is None:
        trace.count("pre.plain")
        return pre_sparse_plain(attrs, uniforms, shader, width, height, tile_h, tile_w, band)
    trace.count("pre.kernel")
    return pre_sparse_kernel(attrs, uniforms, kind, width, height, tile_h, tile_w)


def pre_sparse_plain(attrs: dict, uniforms: dict, shader, width: int, height: int,
                     tile_h: int = TILE_H, tile_w: int = TILE_W,
                     band: Band | None = None) -> PreSparse:
    """``pre_sparse`` as eager PyTorch ops, on any device, for every
    shader and band."""
    setup, varyings = vertex_stage(attrs, uniforms, shader, width, height,
                                   band.geom if band else None)
    (tx0, ty0, span_x, span_y, spans), (n_tiles_x, n_tiles_y) = band_spans(
        setup, tile_w, tile_h, width, height, band)
    per_tile = tile_pair_counts(tx0, ty0, span_x, span_y, n_tiles_x, n_tiles_y)
    total, n_active = trace.readback(torch.stack([per_tile.sum(), (per_tile > 0).sum()]))
    sorted_tri, start, counts = build_bins(tx0, ty0, span_x, spans, total,
                                           n_tiles_x, n_tiles_y)
    tri_rec = build_tri_records(setup, shader_varyings(varyings, shader))
    ids = active_ids(counts > 0, n_active)
    idl = ids.long()
    return PreSparse(tri_rec, sorted_tri, ids, start[idl], counts[idl],
                     total, n_active, setup)


#: shader class -> the hand-written pre-stage's vertex stage (``csrc/pre.cu``'s
#: Kind): 0 ``_base_vertex``, 1 the same with ``position_model``, 2 clip
#: alone (records without varyings), 3 clip and the varying ``ndc_z``
_PRE_KINDS = {shaders.PhongShader: 0, shaders.EyeShader: 0, shaders.ShadowMappedShader: 1,
              shaders.DepthShader: 2, shaders.GrayDepthShader: 3}
#: each kind's varyings in record order (None: a depth-only pass's records)
_PRE_SPECS = {0: (("uv", 2), ("position_eye", 3), ("normal_eye", 3)),
              1: (("uv", 2), ("position_eye", 3), ("normal_eye", 3), ("position_model", 3)),
              2: None,
              3: (("ndc_z", 1),)}
#: the device type the hand-written pre-stage runs on
_PRE_DEVICE = "cuda"


def pre_kind(attrs: dict, uniforms: dict, shader, band: Band | None = None) -> int | None:
    """The vertex stage the hand-written pre-stage computes for this pass
    (``_PRE_KINDS``), or None where the pass takes ``pre_sparse_plain``:
    its corners are not on the card, its shader is of another class, it
    has a band, or a corner it reads or its modelview or perspective is
    not a float32 tensor.  A pass the kernel takes must be readable by it:
    a shader whose varyings are not its class's, a corner that is not (F,
    3, C), or a matrix that is not (4, 4) on the corners' device raises
    ValueError."""
    kind = _PRE_KINDS.get(type(shader))
    pos = attrs["position"]
    if kind is None or band is not None or pos.device.type != _PRE_DEVICE:
        return None
    corners = {"position": 3} | ({"normal": 3, "uv": 2} if kind <= 1 else {})
    mats = {k: uniforms[k] for k in ("modelview", "perspective")}
    if any(attrs[k].dtype != torch.float32 for k in corners) or any(
            getattr(m, "dtype", None) != torch.float32 for m in mats.values()):
        return None
    spec = tuple(shader.varying_spec.items()) if shader.writes_color else None
    if spec != _PRE_SPECS[kind]:
        raise ValueError(f"pre_sparse: {type(shader).__name__}'s varyings {spec} are not "
                         f"its class's {_PRE_SPECS[kind]}")
    f = pos.shape[0]
    for k, c in corners.items():
        t = attrs[k]
        if t.device != pos.device or tuple(t.shape) != (f, 3, c):
            raise ValueError(f"pre_sparse: {k} is {tuple(t.shape)} on {t.device}, not "
                             f"{(f, 3, c)} on {pos.device}")
    for k, m in mats.items():
        if m.device != pos.device or tuple(m.shape) != (4, 4):
            raise ValueError(f"pre_sparse: {k} is {tuple(m.shape)} on {m.device}, not (4, 4) "
                             f"on {pos.device}")
    return kind


@functools.lru_cache(maxsize=64)
def viewport_scalars(width: int, height: int) -> tuple[float, ...]:
    """Rows 0 and 1 of ``math3d.viewport(0, 0, width, height)`` rounded to
    float32 as ``torch.as_tensor`` rounds them: the hand-written
    pre-stage's viewport, passed as scalars (no upload a pass)."""
    vp = np.asarray(math3d.viewport(0, 0, width, height), dtype=np.float32)
    return tuple(float(v) for v in vp[:2].reshape(-1))


#: the regions of ``pre_sparse_kernel``'s workspace, in the order of
#: ``trt_pre_front``'s arguments, each on a 16-byte boundary
_PRE_REGIONS = ("rec", "valid", "screen", "ndc_z", "clip_w", "bbox", "span", "hist",
                "tile_total", "tile_start", "ids", "cstart", "ccount", "word")


@functools.lru_cache(maxsize=256)
def _pre_layout(f: int, stride: int, n_ranges: int, n_tiles: int):
    """({region: word offset} read-only, total words) of the workspace of a
    pass of ``f`` triangles, ``stride``-float records, ``n_ranges`` ranges
    and ``n_tiles`` tiles."""
    sizes = (f * stride, cdiv(f, 4), 6 * f, 3 * f, 3 * f, 4 * f, 4 * f, n_ranges * n_tiles,
             n_tiles, n_tiles, n_tiles, n_tiles, n_tiles, 4)
    offsets, at = {}, 0
    for name, n in zip(_PRE_REGIONS, sizes):
        offsets[name] = at
        at += cdiv(n, 4) * 4
    return types.MappingProxyType(offsets), at


def _corner_args(t) -> tuple:
    """A corner tensor's pointer and element strides, or a null pointer."""
    return (t.data_ptr(), *t.stride()) if t is not None else (None, 0, 0, 0)


def pre_sparse_kernel(attrs: dict, uniforms: dict, kind: int, width: int, height: int,
                      tile_h: int = TILE_H, tile_w: int = TILE_W) -> PreSparse:
    """``pre_sparse`` of a pass ``pre_kind`` gave ``kind``, on the card:
    the front and offsets launches, the readback of the (pairs, active
    tiles) word, the place launch (none without pairs; a pass of no
    triangles makes no launch and no readback).  Every output is
    a view of one int32 workspace but ``sorted_tri``; ``ids``, ``start``
    and ``counts`` are cut to the active tiles without a launch.  The
    kernels get the regions' addresses; views are made only of what the
    pass returns (the wrapper's host time is most of its time)."""
    pos = attrs["position"]
    dev = pos.device
    f = pos.shape[0]
    n_tiles_x = cdiv(width, tile_w)
    n_tiles = n_tiles_x * cdiv(height, tile_h)
    stride = GEOM + 3 * sum(c for _, c in _PRE_SPECS[kind] or ())
    n_ranges = cdiv(f, _build.constant("trt_pre_range")) if f else 0
    at, words = _pre_layout(f, stride, n_ranges, n_tiles)
    ws = torch.empty(words, dtype=torch.int32, device=dev)
    base = ws.data_ptr()
    ptr = {k: base + 4 * o for k, o in at.items()}
    total = n_active = 0
    if f:
        corners = (pos, attrs["normal"], attrs["uv"]) if kind <= 1 else (pos, None, None)
        mv, persp = uniforms["modelview"].contiguous(), uniforms["perspective"].contiguous()
        trace.count("launch.pre_front")
        trace.count("launch.pre_offsets")
        _build.call("trt_pre_front", dev, kind, f, *(a for t in corners for a in _corner_args(t)),
                    mv.data_ptr(), persp.data_ptr(), *viewport_scalars(width, height), width,
                    height, tile_w, tile_h, ptr["rec"], stride,
                    *(ptr[k] for k in _PRE_REGIONS[1:]))
        total, n_active = trace.readback(ws[at["word"]:at["word"] + 2])
    sorted_tri = torch.empty(total, dtype=torch.int32, device=dev)
    if total:
        trace.count("launch.pre_place")
        _build.call("trt_pre_place", dev, ptr["span"], f, ptr["hist"], ptr["tile_start"],
                    n_tiles, n_tiles_x, sorted_tri.data_ptr())
    wf = ws.view(torch.float32)
    setup = {"valid": ws.view(torch.uint8).as_strided((f,), (1,), 4 * at["valid"]).view(
                 torch.bool),
             "screen": wf.as_strided((f, 3, 2), (6, 2, 1), at["screen"]),
             "ndc_z": wf.as_strided((f, 3), (3, 1), at["ndc_z"]),
             "clip_w": wf.as_strided((f, 3), (3, 1), at["clip_w"]),
             "bbox": ws.as_strided((f, 4), (4, 1), at["bbox"])}
    return PreSparse(wf.as_strided((f, stride), (stride, 1), at["rec"]), sorted_tri,
                     *(ws.as_strided((n_active,), (1,), at[k]) for k in ("ids", "cstart",
                                                                         "ccount")),
                     total, n_active, setup)


# ---------------------------------------------------------------------------
# shading and placement
# ---------------------------------------------------------------------------

def _shade_packed(vary_c, uniforms: dict, shader):
    """Fragment-shade every pixel of the compact tiles -> packed colours
    (A, th, tw) int32."""
    vary = {}
    i = 0
    for name, c in shader.varying_spec.items():
        vary[name] = vary_c[:, i:i + c].movedim(1, -1)
        i += c
    return pack_rgb(shaders.finalize_color(shaders.fragment(shader, uniforms, vary)))


def shade_compact_fresh(winner_c, vary_c, uniforms: dict, shader):
    """Fragment-shade the compact tiles of a single pass on a fresh frame:
    a pixel's winner >= 0 is already the merge outcome.  Returns packed
    colors (A, th, tw) int32, background 0.

    A pass the hand-written shading takes (``shade_kind`` of its winner
    and varyings) runs ``csrc/shade.cu``'s fresh entry
    (``shade_compact_fresh_kernel``: one launch, none without tiles);
    every other pass runs ``shade_compact_fresh_plain``.  Both give the
    same tiles bitwise.  Each call is counted as ``shade.kernel`` or
    ``shade.plain``."""
    kind = shade_kind(uniforms, shader, (winner_c, vary_c))
    if kind is None:
        trace.count("shade.plain")
        return shade_compact_fresh_plain(winner_c, vary_c, uniforms, shader)
    trace.count("shade.kernel")
    return shade_compact_fresh_kernel(winner_c, vary_c, uniforms, shader, kind)


def shade_compact_fresh_plain(winner_c, vary_c, uniforms: dict, shader):
    """``shade_compact_fresh`` as eager PyTorch ops, on any device, for
    every shader: every pixel of the tiles is shaded, and those no
    triangle won are set to 0."""
    out = _shade_packed(vary_c, uniforms, shader)
    return torch.where(winner_c >= 0, out, torch.zeros_like(out))


def post_sparse(ft: FrameTiles, ids, depth_c, winner_c, vary_c, uniforms: dict,
                shader, winner_offset: int) -> None:
    """Merge one pass's compact tiles into the frame, in place: the
    kernel already resolved depth against the running frame, so depth is
    scattered back as is; where the pass won a pixel (winner >= 0) the
    winner becomes ``winner_c + winner_offset`` and the colour its shaded
    fragment, elsewhere both keep the frame's.  A depth-only pass shades
    nothing and keeps the frame's colour.

    A pass the hand-written merge + shade takes (``shade_kind``) runs it
    (``csrc/shade.cu``: one launch, none without active tiles); every
    other pass runs ``post_sparse_plain``.  Both give the same frame
    bitwise.  Each call is counted as ``shade.kernel`` or
    ``shade.plain``."""
    kind = shade_kind(uniforms, shader, (*ft, depth_c, winner_c, vary_c))
    if kind is None:
        trace.count("shade.plain")
        post_sparse_plain(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, winner_offset)
        return
    trace.count("shade.kernel")
    post_sparse_kernel(ft, ids, depth_c, winner_c, vary_c, uniforms, shader, winner_offset,
                       kind)


def post_sparse_plain(ft: FrameTiles, ids, depth_c, winner_c, vary_c, uniforms: dict,
                      shader, winner_offset: int) -> None:
    """``post_sparse`` as eager PyTorch ops, on any device, for every
    shader.  Every active tile is shaded, and the pixels the pass lost
    are thrown away; the TPU's won-tile capacity only chose which tiles
    to shade, never a pixel's value."""
    idl = ids.long()
    won = winner_c >= 0
    ft.depth.index_copy_(0, idl, depth_c)
    ft.winner.index_copy_(0, idl, torch.where(won, winner_c + winner_offset,
                                              ft.winner[idl]))
    if not shader.writes_color:
        return
    out = _shade_packed(vary_c, uniforms, shader)
    ft.color.index_copy_(0, idl, torch.where(won, out, ft.color[idl]))


#: shader class -> the hand-written merge + shade's fragment (``csrc/shade.cu``'s
#: Kind): 0 Phong, 1 Eye, 2 ShadowMappedShader, 3 GrayDepthShader, 4 depth only
_SHADE_KINDS = {shaders.PhongShader: 0, shaders.EyeShader: 1, shaders.ShadowMappedShader: 2,
                shaders.GrayDepthShader: 3, shaders.DepthShader: 4}
#: each kind's varyings in record order (None: a depth-only pass, which shades nothing)
_SHADE_SPECS = {0: _PRE_SPECS[0], 1: _PRE_SPECS[0], 2: _PRE_SPECS[1], 3: _PRE_SPECS[3], 4: None}
#: the uniforms each kind's fragment reads, with their shapes (None: any
#: size above 0): float32, the packed texture uint8
_TEX, _MAP = {"tex_packed": (None, None, 7)}, {"shadow_matrix": (4, 4), "shadow_map": (None, None)}
_LIGHTS = {"key_light_eye": (3,), "fill_light_eye": (3,), "rim_light_eye": (3,)}
_SHADE_UNIFORMS = {0: {"modelview": (4, 4), **_LIGHTS, **_TEX},
                   1: {"key_light_eye": (3,), "rim_light_eye": (3,), **_TEX},
                   2: {"modelview": (4, 4), **_LIGHTS, **_TEX, **_MAP}, 3: {}, 4: {}}
#: the dtypes of the planes ``shade_kind`` takes: the frame's colour, depth and
#: winner, the raster's depth, winner and varyings
_SHADE_PLANES = (torch.int32, torch.float32, torch.int32, torch.float32, torch.int32,
                 torch.float32)
#: the device type the hand-written merge + shade runs on
_SHADE_DEVICE = "cuda"


def shade_kind(uniforms: dict, shader, planes) -> int | None:
    """The fragment the hand-written merge + shade computes for this pass
    (``_SHADE_KINDS``), or None where the pass takes the plain version
    (``post_sparse_plain``, ``shade_compact_fresh_plain``): its planes
    are not on the card, its shader is of another class, a colour kind's
    ``tex_packed`` is None, or a plane or a uniform the fragment reads is
    a tensor of another dtype (float32 planes and uniforms, int32 winners
    and colour, a uint8 texture).  ``planes``: the frame's colour, depth
    and winner tiles and the raster's depth, winner and varyings
    (``post_sparse``), or the raster's winner and varyings alone, on a
    fresh frame (``shade_compact_fresh``).  A pass the kernel takes must
    be readable by it: a shader whose varyings are not its class's,
    planes of other shapes or devices or not contiguous, or a uniform
    that is not a tensor of its shape on the planes' device raises
    ValueError."""
    who = "shade_compact_fresh" if len(planes) == 2 else "post_sparse"
    kind = _SHADE_KINDS.get(type(shader))
    dev = planes[0].device
    if kind is None or dev.type != _SHADE_DEVICE:
        return None
    names = _SHADE_UNIFORMS[kind]
    if "tex_packed" in names and uniforms.get("tex_packed") is None:
        return None
    if any(p.dtype != d for p, d in zip(planes, _SHADE_PLANES[-len(planes):])) or any(
            isinstance(uniforms.get(k), torch.Tensor) and uniforms[k].dtype != (
                torch.uint8 if k == "tex_packed" else torch.float32) for k in names):
        return None
    spec = tuple(shader.varying_spec.items()) if shader.writes_color else None
    if spec != _SHADE_SPECS[kind]:
        raise ValueError(f"{who}: {type(shader).__name__}'s varyings {spec} are not "
                         f"its class's {_SHADE_SPECS[kind]}")
    frame = planes[:-3]            # the frame's tiles: none on a fresh frame
    tile = tuple(planes[0].shape[1:])
    a = planes[-2].shape[0]
    n_vary = sum(c for _, c in spec or ())
    want = [(p, tuple(planes[0].shape)) for p in frame] + [
        (p, (a, *tile)) for p in planes[len(frame):-1]] + [(planes[-1], (a, n_vary, *tile))]
    for p, shape in want:
        if (len(tile) != 2 or p.device != dev or tuple(p.shape) != shape
                or not p.is_contiguous()):
            raise ValueError(f"{who}: a plane is {tuple(p.shape)} on {p.device}, not a "
                             f"contiguous {shape} on {dev}")
    for k, shape in names.items():
        t = uniforms.get(k)
        if not (isinstance(t, torch.Tensor) and t.device == dev and t.dim() == len(shape)
                and all(n > 0 if s is None else n == s for s, n in zip(shape, t.shape))):
            what = (f"{tuple(t.shape)} on {t.device}" if isinstance(t, torch.Tensor)
                    else type(t).__name__)
            raise ValueError(f"{who}: {k} is {what}, not a {shape} tensor on {dev}")
    return kind


def _shade_scalars(shader) -> tuple[float, ...]:
    """``csrc/shade.cu``'s Consts: the shader's constants as Python floats
    (ctypes rounds each to float32, as PyTorch rounds a Python float
    operand), 0.0 where the class has none."""
    g = lambda k: float(getattr(shader, k, 0.0))  # noqa: E731
    s = g("normal_map_strength")
    return (g("AMBIENT"), g("KEY_DIFFUSE_INTENSITY"), g("KEY_SPECULAR_INTENSITY"),
            g("FILL_DIFFUSE_INTENSITY"), g("RIM_DIFFUSE_INTENSITY"), g("SPECULAR_SCALE"),
            1.0 - s, s, g("SHADOW_EPS"), g("SHADOW_AMBIENT_FACTOR"),
            float(shaders.EYE_DIFFUSE_BRIGHTNESS_THRESHOLD),
            float(shaders.EYE_SPECULAR_POWER_THRESHOLD))


def _call_shade(entry: str, dev, head: tuple, uniforms: dict, shader, kind: int) -> None:
    """Call ``csrc/shade.cu``'s ``entry`` with its own arguments ``head``,
    then the uniform block both entries take: the uniforms ``kind``
    reads where ``scene`` put them (contiguous, kept alive over the
    launch; null where the kind reads none), their sizes and the
    shader's constants."""
    u = {k: uniforms[k].contiguous() for k in _SHADE_UNIFORMS[kind]}
    ptr = lambda k: u[k].data_ptr() if k in u else None  # noqa: E731
    tex, smap = u.get("tex_packed"), u.get("shadow_map")
    _build.call(entry, dev, *head,
                *(ptr(k) for k in ("modelview", "key_light_eye", "fill_light_eye",
                                   "rim_light_eye", "tex_packed")),
                *(tex.shape[:2] if tex is not None else (0, 0)),
                ptr("shadow_matrix"), ptr("shadow_map"),
                *(smap.shape if smap is not None else (0, 0)), *_shade_scalars(shader))


def post_sparse_kernel(ft: FrameTiles, ids, depth_c, winner_c, vary_c, uniforms: dict,
                       shader, winner_offset: int, kind: int) -> None:
    """``post_sparse`` of a pass ``shade_kind`` gave ``kind``, on the card:
    one launch of ``merge_shade_kernel`` (none without active tiles), no
    allocation, no readback and no upload: the uniforms are read where
    ``scene`` put them."""
    n_active = ids.shape[0]
    if ids.dtype != torch.int32 or ids.dim() != 1 or not ids.is_contiguous() or (
            ids.device != depth_c.device or n_active != depth_c.shape[0]):
        raise ValueError(f"post_sparse: ids must be a contiguous ({depth_c.shape[0]},) int32 "
                         f"tensor on {depth_c.device}")
    if not -2**31 <= winner_offset < 2**31:
        raise ValueError(f"post_sparse: winner offset {winner_offset} is not an int32")
    if n_active == 0:
        return
    tile_h, tile_w = depth_c.shape[1:]
    trace.count("launch.merge_shade")
    _call_shade("trt_merge_shade", depth_c.device,
                (kind, ids.data_ptr(), n_active, tile_h, tile_w, depth_c.data_ptr(),
                 winner_c.data_ptr(), vary_c.data_ptr() if vary_c.shape[1] else None,
                 vary_c.shape[1], winner_offset, ft.color.data_ptr(), ft.depth.data_ptr(),
                 ft.winner.data_ptr()), uniforms, shader, kind)


def shade_compact_fresh_kernel(winner_c, vary_c, uniforms: dict, shader, kind: int):
    """``shade_compact_fresh`` of a pass ``shade_kind`` gave ``kind``, on
    the card: one launch of ``shade_fresh_kernel`` into
    one new (A, th, tw) int32 tensor (none without tiles), no readback
    and no upload."""
    out = torch.empty(winner_c.shape, dtype=torch.int32, device=winner_c.device)
    n_active, tile_h, tile_w = winner_c.shape
    if n_active:
        trace.count("launch.shade_fresh")
        _call_shade("trt_shade_fresh", winner_c.device,
                    (kind, n_active, tile_h, tile_w, winner_c.data_ptr(), vary_c.data_ptr(),
                     vary_c.shape[1], out.data_ptr()), uniforms, shader, kind)
    return out


def reduce_events(ev, depth_c, winner_c):
    """Per-pass exact counters from the kernel's event planes -> 0-d
    (fragments int64, min_z f32, max_z f32).  Events at a pixel strictly
    decrease, so the least is the pixel's final depth in this pass, and
    min_z is the least depth over the pixels the pass won."""
    count, max_z = ev
    dev = depth_c.device
    if depth_c.numel() == 0:
        return (torch.zeros((), dtype=torch.int64, device=dev),
                torch.tensor(torch.inf, device=dev), torch.tensor(-torch.inf, device=dev))
    min_z = torch.where(winner_c >= 0, depth_c, torch.inf).amin()
    return count.sum(dtype=torch.int64), min_z, max_z.amax()


# ---------------------------------------------------------------------------
# coarse/fine dispatch
# ---------------------------------------------------------------------------

#: which raster every pass takes: "coarse", "fine" (strips per tile) or
#: "fine2" (grouped strips).  On the H100 neither strip route beat the
#: coarse one end to end: the strip kernel is faster on passes with few
#: rows a pair, but its pre-stage costs more than the kernel saves
#: (PERF.md, Findings)
FINE_MODE = "coarse"


def decide_mode() -> str:
    """The raster ``FINE_MODE`` names; any other value raises."""
    if FINE_MODE not in ("coarse", "fine", "fine2"):
        raise ValueError(f"FINE_MODE must be 'coarse', 'fine' or 'fine2', not {FINE_MODE!r}")
    return FINE_MODE


def raster_pass(mode: str, attrs: dict, uniforms: dict, shader, width: int, height: int,
                tile_h: int, tile_w: int, init_depth, collect_stats: bool = False,
                band: Band | None = None):
    """One pass's pre-stage and raster on the coarse or the strip route,
    over every tile or over ``band``'s window (its tiles at their global
    pixels: the band's origin and row stride).  ``init_depth(ids)`` gives
    the running depth of the active tiles.  Returns (ids, setup, (depth,
    winner, vary[, ev])) in the raster contract both routes share."""
    n_tiles_x = band.grid(width, tile_w)[0] if band else cdiv(width, tile_w)
    n_vary = n_vary_of(shader)
    place = ({"origin": band.origin(tile_h, tile_w), "y_stride": band.y_stride(tile_h)}
             if band else {})
    if mode == "fine":
        with trace.span("pass.pre"):
            pre = raster_fine.pre_fine(attrs, uniforms, shader, width, height, tile_h, tile_w,
                                       band)
        with trace.span("pass.raster"):
            out = raster_fine.fine_raster(pre.tri_rec, pre.tri8, pre.ids, pre.row_start,
                                          pre.rows, init_depth(pre.ids), n_tiles_x, tile_h,
                                          tile_w, n_vary, collect_stats=collect_stats,
                                          max_rows=pre.max_rows, **place)
    else:
        with trace.span("pass.pre"):
            pre = pre_sparse(attrs, uniforms, shader, width, height, tile_h, tile_w, band)
        with trace.span("pass.raster"):
            out = coarse_raster(pre.tri_rec, pre.sorted_tri, pre.ids, pre.start, pre.counts,
                                init_depth(pre.ids), n_tiles_x, tile_h, tile_w, n_vary,
                                collect_stats=collect_stats, **place)
    return pre.ids, pre.setup, out


def grouped_pass(attrs: dict, uniforms: dict, shader, width: int, height: int,
                 tile_h: int, depth_tiles=None, collect_stats: bool = False,
                 band: Band | None = None):
    """One pass's pre-stage and raster on the grouped strip route, over
    every tile or over ``band``'s window: -> (the ``raster_fine2.PreFine2``,
    its group-space outputs).  Pass-local, or seeded with the frame's
    ``depth_tiles`` (T, th, 128) when given."""
    with trace.span("pass.pre"):
        pre = raster_fine2.pre_fine2(attrs, uniforms, shader, width, height, tile_h, band=band)
    with trace.span("pass.raster"):
        init = None if depth_tiles is None else raster_fine2.init_strips(depth_tiles, pre)
        out = raster_fine2.fine2_raster(pre.tri_rec, pre.tri8, pre.group_start,
                                        pre.group_rows, pre.x0y0, tile_h, n_vary_of(shader),
                                        init, origin=band.origin(tile_h, TILE_W) if band
                                        else (0, 0), collect_stats=collect_stats)
    return pre, out


def compact_to_image(c_tiles, ids, n_tiles_x: int, n_tiles_y: int, tile_h: int,
                     tile_w: int, fill=0, untile=untile_one):
    """Scatter compact (A, th, tw) 32-bit tiles into the full tile frame
    (``fill`` elsewhere) and untile it to (nty*th, ntx*tw)."""
    tiles = torch.full((n_tiles_x * n_tiles_y, tile_h, tile_w), fill,
                       dtype=c_tiles.dtype, device=c_tiles.device)
    tiles.index_copy_(0, ids.long(), c_tiles)
    return untile(tiles, n_tiles_x, n_tiles_y, tile_h, tile_w)


def render_frame_fused_image(passes, width: int, height: int,
                             tile_h: int = TILE_H, tile_w: int = TILE_W,
                             return_depth: bool = False, band: Band | None = None):
    """Render a single color pass straight to an (H, W, 3) uint8 image on
    the pass's device.  ``passes``: [(attrs, shader, uniforms, exclude)]
    with tensor attrs/uniforms (``convert.pass_to_torch``).  With
    ``return_depth`` also returns the (H, W) f32 depth, +inf where
    empty.

    With ``band`` only the band's tiles are rendered (``_fused_image_body``
    with the band arguments, as a rank of ``parallel/dist.py`` runs it),
    and the image is the band's uncropped rows: (nty_band * th, ntx * tw,
    3), band tile row j at rows j * th .. (j + 1) * th - 1."""
    if len(passes) != 1:
        raise ValueError("render_frame_fused_image takes exactly one pass")
    attrs, shader, uniforms, _exclude = passes[0]
    if not shader.writes_color:
        raise ValueError("render_frame_fused_image needs a color shader")
    if attrs["position"].shape[0] == 0:
        raise ValueError("render_frame_fused_image requires a non-empty pass")
    if band is None:
        n_tiles_x, n_tiles_y = cdiv(width, tile_w), cdiv(height, tile_h)
        crop = (height, width)
    else:
        n_tiles_x, n_tiles_y = band.grid(width, tile_w)
        crop = (n_tiles_y * tile_h, n_tiles_x * tile_w)
    mode = decide_mode()
    if mode == "fine2":
        pre, out = grouped_pass(attrs, uniforms, shader, width, height, tile_h, band=band)
        ids = pre.ids
        with trace.span("pass.merge_shade"):
            c_img, depth_c = raster_fine2.post_fine2_image(
                pre, out, lambda v: _shade_packed(v, uniforms, shader))
    else:
        ids, _, (depth_c, winner_c, vary_c) = raster_pass(
            mode, attrs, uniforms, shader, width, height, tile_h, tile_w,
            lambda ids: torch.full((ids.shape[0], tile_h, tile_w), torch.inf,
                                   dtype=torch.float32, device=ids.device), band=band)
        with trace.span("pass.merge_shade"):
            c_img = shade_compact_fresh(winner_c, vary_c, uniforms, shader)
    with trace.span("frame.untile"):
        image = untile_image(c_img, ids, n_tiles_x, n_tiles_y, tile_h, tile_w, *crop,
                             rgb=True)
        if not return_depth:
            return image
        return image, untile_image(depth_c, ids, n_tiles_x, n_tiles_y, tile_h, tile_w, *crop,
                                   fill=torch.inf)


def walk_passes(frame, passes, render, in_place: bool, seconds: list | None = None,
                names: list | None = None):
    """Walk a frame's ``passes`` ([(attrs, shader, uniforms,
    exclude_from_output_depth)]) in order, as every backend's frame walks
    them: depth is snapshot before the first pass of a run of excluded
    passes and restored before the next pass that is not excluded
    (main.cpp:700,730), the winner ids run on over the passes' faces, and
    a pass with no faces renders nothing.  ``frame`` is a NamedTuple with
    a ``depth`` field (``FrameTiles``, ``raster.FrameBuffers``) on the
    passes' device; ``render(frame, attrs, shader, uniforms,
    winner_offset)`` renders one pass with faces into it and returns the
    frame.  ``in_place``: ``render`` writes the frame's depth in place, so
    the snapshot is a copy.  Returns (frame, output depth): the output
    depth is the snapshot when the frame ends inside an excluded run.

    Each pass runs in a ``pass`` span, its ``names`` entry the argument
    (the pass's index without ``names``).  ``seconds``, if given,
    receives each pass's host seconds, every pass in order (one with no
    faces too): the JAX package's per-pass ``pass_timings``, the host
    time of the pass's span (its launches issued, not their device work:
    nothing synchronizes)."""
    snapshot = None
    in_excluded = False
    winner_offset = 0
    for i, (attrs, shader, uniforms, exclude) in enumerate(passes):
        if exclude:
            if not in_excluded:
                snapshot = frame.depth.clone() if in_place else frame.depth   # main.cpp:700
                in_excluded = True
        elif in_excluded:
            frame = frame._replace(depth=snapshot)                            # main.cpp:730
            in_excluded = False
        t0 = time.perf_counter()
        f = attrs["position"].shape[0]
        with trace.span("pass", names[i] if names else i):
            if f:
                if attrs["position"].device != frame.depth.device:
                    raise ValueError(f"pass inputs are on {attrs['position'].device}, "
                                     f"the frame on {frame.depth.device}")
                frame = render(frame, attrs, shader, uniforms, winner_offset)
        if seconds is not None:
            seconds.append(time.perf_counter() - t0)
        winner_offset += f
    return frame, (snapshot if in_excluded else frame.depth)


def render_frame_fused(passes, width: int, height: int, device,
                       tile_h: int = TILE_H, tile_w: int = TILE_W,
                       collect_stats: bool = False, band: Band | None = None,
                       seconds: list | None = None, names: list | None = None):
    """Render a multi-pass frame in tiled layout on ``device``.

    ``passes``: [(attrs, shader, uniforms, exclude_from_output_depth)]
    with tensor attrs/uniforms on ``device``, walked by ``walk_passes``
    (``seconds`` and ``names`` as it takes them).  Returns (FrameTiles,
    out_depth_tiles, events): the output depth is the snapshot when the
    frame ends inside an excluded run; ``events`` is one ``PassEvents``
    per pass with faces when ``collect_stats``, else None.  Updates the
    frame's tiles in place, so the snapshot is a copy.

    With ``band`` the frame is the band's tiles only (``_fused_frame_body``
    with the band arguments, the body a rank of ``parallel/dist.py`` runs):
    binning is clipped to the band's window, tile ids are band-local and
    the rasters draw each tile at its global pixels; a pass's events are
    the band's, its setup the whole pass's."""
    if band is None:
        ft = new_frame_tiles(width, height, device, tile_h, tile_w)
    else:
        ntx, nty = band.grid(width, tile_w)
        ft = new_frame_tiles(ntx * tile_w, nty * tile_h, device, tile_h, tile_w)
    events = [] if collect_stats else None

    def render(ft, attrs, shader, uniforms, winner_offset):
        """One pass with faces: its raster route, the merge into ``ft`` and,
        with ``collect_stats``, its ``PassEvents`` appended to ``events``."""
        mode = decide_mode()
        if mode == "fine2":
            # pass-local, or seeded with the running depth for exact events
            pre, out = grouped_pass(attrs, uniforms, shader, width, height, tile_h,
                                    ft.depth if collect_stats else None, collect_stats, band)
            setup = pre.setup
            with trace.span("pass.merge_shade"):
                raster_fine2.post_fine2(ft, pre, out, winner_offset,
                                        (lambda v: _shade_packed(v, uniforms, shader))
                                        if shader.writes_color else None)
        else:
            ids, setup, out = raster_pass(mode, attrs, uniforms, shader, width, height,
                                          tile_h, tile_w, lambda ids: ft.depth[ids.long()],
                                          collect_stats, band)
            with trace.span("pass.merge_shade"):
                post_sparse(ft, ids, *out[:3], uniforms, shader, winner_offset)
        if collect_stats:
            with trace.span("pass.stats"):
                events.append(PassEvents(setup, *reduce_events(out[3], out[0], out[1])))
        return ft

    return (*walk_passes(ft, passes, render, True, seconds, names), events)
