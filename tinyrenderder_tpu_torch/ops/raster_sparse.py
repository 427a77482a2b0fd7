"""Single-pass direct-to-image route in PyTorch: pre-stage, coarse
raster over the active tiles, compact shading, placement.  Also the
single-plane untile: the CUDA kernel ``csrc/untile.cu`` and its plain
PyTorch version.

Counterpart of the coarse branch of
``tinyrenderder_tpu/ops/raster_sparse.py::render_frame_fused_image``
with ``direct=False`` (``_pre_sparse_jit``, ``_shade_compact_fresh``,
``_compact_to_image``, ``_untile_one_jit``).

The frame reads back two integers, once: the exact (tile, triangle) pair
total and the active-tile count.  Every buffer is sized from them, so
the TPU path's capacity cache, its quantized capacities and its
overflow re-render have no counterpart here: nothing can overflow.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tinyrenderder_tpu_torch import _build, shaders
from tinyrenderder_tpu_torch.ops.raster_coarse import build_tri_records, coarse_raster
from tinyrenderder_tpu_torch.ops.raster_tiled import (TILE_H, TILE_W, build_bins, cdiv,
                                                      flatten_varyings, tile_pair_counts,
                                                      tile_spans, vertex_stage)

__all__ = ["pack_rgb", "unpack_rgb", "pick_tile_h", "untile_one",
           "untile_one_plain", "PreSparse", "pre_sparse",
           "shade_compact_fresh", "compact_to_image",
           "render_frame_fused_image", "LAUNCHES"]

#: untile kernel launches since the last reset (the CPU path does not count)
LAUNCHES = 0

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
# untile: (T, th, tw) 32-bit tiles -> (nty*th, ntx*tw) row-major image
# ---------------------------------------------------------------------------

def untile_one_plain(x, n_tiles_x: int, n_tiles_y: int, tile_h: int, tile_w: int):
    return (x.reshape(n_tiles_y, n_tiles_x, tile_h, tile_w)
             .permute(0, 2, 1, 3)
             .reshape(n_tiles_y * tile_h, n_tiles_x * tile_w))


def untile_one(x, n_tiles_x: int, n_tiles_y: int, tile_h: int, tile_w: int):
    """One 32-bit tile plane -> image layout.  CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    global LAUNCHES
    shape = (n_tiles_x * n_tiles_y, tile_h, tile_w)
    if tuple(x.shape) != shape:
        raise ValueError(f"tiles must have shape {shape}, got {tuple(x.shape)}")
    if x.dtype not in (torch.int32, torch.float32):
        raise ValueError(f"untile moves 32-bit words, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("tiles must be contiguous")
    if x.device.type == "cpu":
        return untile_one_plain(x, n_tiles_x, n_tiles_y, tile_h, tile_w)
    if x.device.type != "cuda":
        raise ValueError(f"no untile for device {x.device}")
    if tile_w % 4 or x.data_ptr() % 16:
        raise ValueError("the CUDA untile moves 16-byte vectors: tile_w must be "
                         "a multiple of 4 and the tiles 16-byte aligned")
    out = torch.empty((n_tiles_y * tile_h, n_tiles_x * tile_w), dtype=x.dtype,
                      device=x.device)
    lib = _build.library()
    with torch.cuda.device(x.device):
        rc = lib.trt_untile32(x.data_ptr(), out.data_ptr(), n_tiles_x, n_tiles_y,
                              tile_h, tile_w, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "trt_untile32")
    LAUNCHES += 1
    return out


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


def pre_sparse(attrs: dict, uniforms: dict, shader, width: int, height: int,
               tile_h: int = TILE_H, tile_w: int = TILE_W) -> PreSparse:
    """Vertex stage, binning, per-triangle records and active-tile
    compaction.  Holds the frame's one host readback."""
    setup, varyings = vertex_stage(attrs, uniforms, shader, width, height)
    n_tiles_x, n_tiles_y = cdiv(width, tile_w), cdiv(height, tile_h)
    n_tiles = n_tiles_x * n_tiles_y
    tx0, ty0, span_x, span_y, spans = tile_spans(setup, tile_w, tile_h)
    per_tile = tile_pair_counts(tx0, ty0, span_x, span_y, n_tiles_x, n_tiles_y)
    total, n_active = torch.stack([per_tile.sum(), (per_tile > 0).sum()]).tolist()
    sorted_tri, start, counts = build_bins(tx0, ty0, span_x, spans, total,
                                           n_tiles_x, n_tiles_y)

    spec = tuple(shader.varying_spec.items())
    if {name for name, _ in spec} != set(varyings):
        raise ValueError(f"{shader.name}.varying_spec {sorted(dict(spec))} != "
                         f"vertex output {sorted(varyings)}")
    tri_rec = build_tri_records(setup, flatten_varyings(varyings, spec))

    # ids[j] = j-th non-empty tile; empty tiles go to a trash slot
    active = counts > 0
    slot = torch.where(active, torch.cumsum(active, 0) - 1, n_active)
    ids = torch.empty(n_active + 1, dtype=torch.int32, device=counts.device)
    ids.scatter_(0, slot, torch.arange(n_tiles, dtype=torch.int32, device=counts.device))
    ids = ids[:n_active]
    idl = ids.long()
    return PreSparse(tri_rec, sorted_tri, ids, start[idl], counts[idl],
                     total, n_active)


# ---------------------------------------------------------------------------
# shading and placement
# ---------------------------------------------------------------------------

def shade_compact_fresh(winner_c, vary_c, uniforms: dict, shader):
    """Fragment-shade the compact tiles of a single pass on a fresh frame:
    a pixel's winner >= 0 is already the merge outcome.  Returns packed
    colors (A, th, tw) int32, background 0."""
    vary = {}
    i = 0
    for name, c in shader.varying_spec.items():
        vary[name] = vary_c[:, i:i + c].movedim(1, -1)
        i += c
    rgb = shaders.fragment(shader, uniforms, vary)
    out = pack_rgb(shaders.finalize_color(rgb))
    return torch.where(winner_c >= 0, out, torch.zeros_like(out))


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
                             return_depth: bool = False):
    """Render a single color pass straight to an (H, W, 3) uint8 image on
    the pass's device.  ``passes``: [(attrs, shader, uniforms, exclude)]
    with tensor attrs/uniforms (``convert.pass_to_torch``).  With
    ``return_depth`` also returns the (H, W) f32 depth, +inf where
    empty."""
    if len(passes) != 1:
        raise ValueError("render_frame_fused_image takes exactly one pass")
    attrs, shader, uniforms, _exclude = passes[0]
    if not shader.writes_color:
        raise ValueError("render_frame_fused_image needs a color shader")
    if attrs["position"].shape[0] == 0:
        raise ValueError("render_frame_fused_image requires a non-empty pass")
    n_tiles_x, n_tiles_y = cdiv(width, tile_w), cdiv(height, tile_h)
    n_vary = sum(shader.varying_spec.values())

    pre = pre_sparse(attrs, uniforms, shader, width, height, tile_h, tile_w)
    init = torch.full((pre.n_active, tile_h, tile_w), torch.inf,
                      dtype=torch.float32, device=pre.tri_rec.device)
    depth_c, winner_c, vary_c = coarse_raster(
        pre.tri_rec, pre.sorted_tri, pre.ids, pre.start, pre.counts, init,
        n_tiles_x, tile_h, tile_w, n_vary)
    c_img = shade_compact_fresh(winner_c, vary_c, uniforms, shader)
    img = compact_to_image(c_img, pre.ids, n_tiles_x, n_tiles_y, tile_h, tile_w)
    image = unpack_rgb(img[:height, :width])
    if not return_depth:
        return image
    depth = compact_to_image(depth_c, pre.ids, n_tiles_x, n_tiles_y, tile_h,
                             tile_w, fill=torch.inf)
    return image, depth[:height, :width]
