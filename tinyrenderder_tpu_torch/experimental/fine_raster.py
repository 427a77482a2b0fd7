"""The prototype strip raster (depth and winner over 8 x 128 tiles): its
record builder, the CUDA kernel ``csrc/fine_raster.cu`` and its plain
PyTorch version.

Counterpart of ``scripts/experimental_fine_raster.py``
(``build_strip_records``, ``strip_rasterize`` and ``_strip_kernel``), the
groundwork of the production strip raster (``ops/raster_fine.py``).  Its
contract is the prototype's, not the production one's: no bbox clip, no
varyings, and records that carry the geometry itself.

Records (``build_strip_records``, bitwise equal to the script's): the
triangles are binned per strip of 8 x 16 pixels (``raster_tiled.tile_spans``
and ``build_bins`` at strip size, sized from one readback); group g (one
8 x 128 tile, row-major) has ``rows[g]`` = the largest of its 8 strip bins,
and record row r of group g holds, in lanes 16k .. 16k + 9, the r-th
triangle of strip k as ax ay bx by cx cy z0 z1 z2 id (screen xy, NDC z,
the id as f32), zeros elsewhere and id -1 in an empty slot; the rows are
padded to the largest group's count (at least 1).  The script's triple
Python loop (``:147-164``) becomes one scatter on the device.  Its one
readback also gives the row total ``rows.sum()``, which sizes the
kernel's grid and scratch.

Raster contract (``strip_raster``, both versions bitwise, and equal to
``strip_rasterize(interpret=True)``):
  recs        (G, max_rows, 128) f32, rows (G,) i32
  init_tiles  (G, 8, 128) f32 running depth
  -> depth (G, 8, 128) f32, winner (G, 8, 128) i32 (-1 = background).
  A pixel of strip k walks slot k of its group's rows in order:
  ``semantics.barycentric`` at the pixel centre, ``coverage_mask``,
  ``affine_z``, covered &= isfinite(z) and id >= 0, then a strict-less
  depth update whose winner is the id.  No bbox test.
The kernel cuts each group's rows into ranges of ``range_rows()`` and
merges the ranges' first minima in order (``csrc/fine_raster.cu``);
``strip_raster_split_plain`` is that decomposition in plain PyTorch, for
the tests.

``strip_rasterize`` builds the records, tiles the init depth (+inf
padding), rasters, untiles each plane with ``raster_sparse.untile_one``
and crops, as the script does.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tinyrenderder_tpu_torch import _build, convert, math3d, trace
from tinyrenderder_tpu_torch.models import procedural
from tinyrenderder_tpu_torch.ops import semantics
from tinyrenderder_tpu_torch.ops.raster_coarse import split_walks, walk_items, walk_scratch
from tinyrenderder_tpu_torch.ops.raster_tiled import (build_bins, cdiv, tile_pair_counts,
                                                      tile_spans, to_tiles, vertex_stage)

__all__ = ["STRIP_W", "STRIPS", "TILE_H", "TILE_W", "NFIELD",
           "build_strip_records", "range_rows", "strip_raster", "strip_raster_plain",
           "strip_raster_split_plain", "strip_rasterize", "tie_pile", "script_setups",
           "check_against_coarse", "main"]

STRIP_W = 16
STRIPS = 8                      # strips per (8, 128) tile
TILE_H = 8
TILE_W = STRIP_W * STRIPS       # 128
NFIELD = 10                     # ax ay bx by cx cy z0 z1 z2 id

# kernel launches are counted as launch.strip_raster_proto (``trace.count``;
# the CPU path does not count)


def build_strip_records(setup: dict, width: int, height: int):
    """-> (recs (G, max_rows, 128) f32, rows (G,) i32, n_tiles_x,
    n_tiles_y, row_total = rows.sum()) on the setup's device (module
    docstring)."""
    n_tiles_x, n_tiles_y = cdiv(width, TILE_W), cdiv(height, TILE_H)
    n_groups, nsx = n_tiles_x * n_tiles_y, n_tiles_x * STRIPS
    dev = setup["bbox"].device
    tx0, ty0, span_x, span_y, spans = tile_spans(setup, STRIP_W, TILE_H)
    per_strip = tile_pair_counts(tx0, ty0, span_x, span_y, nsx, n_tiles_y)
    rows = per_strip.view(n_groups, STRIPS).amax(dim=1).to(torch.int32)
    total, max_rows, row_total = torch.stack([per_strip.sum(), rows.max(),
                                              rows.sum()]).tolist()
    max_rows = max(max_rows, 1)
    recs = torch.zeros((n_groups, max_rows, STRIPS, STRIP_W), dtype=torch.float32, device=dev)
    recs[..., NFIELD - 1] = -1.0
    if total:
        sorted_tri, start, counts = build_bins(tx0, ty0, span_x, spans, total, nsx,
                                               n_tiles_y)
        strip = torch.repeat_interleave(torch.arange(nsx * n_tiles_y, device=dev), counts,
                                        output_size=total)
        rank = torch.arange(total, device=dev) - start[strip]
        col = strip % nsx
        group = torch.div(strip, nsx, rounding_mode="floor") * n_tiles_x + col // STRIPS
        tri = sorted_tri.long()
        f = setup["screen"].shape[0]
        fields = torch.cat([setup["screen"].reshape(f, 6).to(torch.float32)[tri],
                            setup["ndc_z"].to(torch.float32)[tri],
                            tri.to(torch.float32)[:, None]], dim=1)
        recs[group, rank, col % STRIPS, :NFIELD] = fields
    return recs.view(n_groups, max_rows, TILE_W), rows, n_tiles_x, n_tiles_y, row_total


def _check(recs, rows, init_tiles):
    g = recs.shape[0]
    for name, t, dtype, shape in (("recs", recs, torch.float32, None),
                                  ("rows", rows, torch.int32, (g,)),
                                  ("init_tiles", init_tiles, torch.float32,
                                   (g, TILE_H, TILE_W))):
        if t.dtype != dtype or t.device != recs.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {recs.device}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if recs.dim() != 3 or recs.shape[2] != TILE_W or recs.shape[1] < 1:
        raise ValueError(f"recs must be (G, rows >= 1, {TILE_W}), got {tuple(recs.shape)}")


def range_rows() -> int:
    """Record rows of one work item of the CUDA kernel's split walk."""
    return _build.constant("trt_proto_range_rows")


def strip_raster(recs, rows, init_tiles, n_tiles_x: int, *, row_total: int | None = None):
    """(depth, winner) tiles of the groups (contract in the module
    docstring).  CPU tensors take the plain version; CUDA tensors launch
    the kernel: the walk alone where every group fits one range
    (``recs.shape[1] <= range_rows()``), else the item scan, the split
    walk and the ordered merge, their grid and scratch sized from
    ``row_total``, which must be ``rows.sum()`` (as
    ``build_strip_records`` returns it; read back here when not given)."""
    _check(recs, rows, init_tiles)
    if recs.device.type == "cpu":
        return strip_raster_plain(recs, rows, init_tiles, n_tiles_x)
    if recs.device.type != "cuda":
        raise ValueError(f"no strip raster for device {recs.device}")
    g, max_rows, _ = recs.shape
    depth = torch.empty_like(init_tiles)
    winner = torch.empty(init_tiles.shape, dtype=torch.int32, device=recs.device)
    if g == 0:
        return depth, winner
    n_items, scratch = g, None
    r = range_rows()
    if max_rows > r:
        if row_total is None:
            row_total = int(rows.sum())
        n_items = walk_items(g, row_total, r)
        scratch = walk_scratch(n_items, g, TILE_H, recs.device)
    trace.count("launch.strip_raster_proto")
    _build.call("trt_strip_proto", recs.device,
                recs.data_ptr(), rows.data_ptr(), g, max_rows, init_tiles.data_ptr(),
                depth.data_ptr(), winner.data_ptr(), n_tiles_x, n_items,
                None if scratch is None else scratch.data_ptr())
    return depth, winner


def strip_raster_plain(recs, rows, init_tiles, n_tiles_x: int):
    """Plain PyTorch version: every group at once, one record row a step
    (a group's rows past ``rows[g]`` hold only empty slots)."""
    _check(recs, rows, init_tiles)
    g, max_rows, _ = recs.shape
    dev, f32 = recs.device, torch.float32
    t = torch.arange(g, device=dev)
    gx0 = ((t % n_tiles_x) * TILE_W).to(f32).view(g, 1, 1, 1)
    gy0 = (torch.div(t, n_tiles_x, rounding_mode="floor") * TILE_H).to(f32).view(g, 1, 1, 1)
    # pixels as (G, row, strip, column); lane = 16 * strip + column
    px = (gx0 + torch.arange(TILE_W, device=dev).to(f32).view(1, 1, STRIPS, STRIP_W)) + 0.5
    py = (gy0 + torch.arange(TILE_H, device=dev).to(f32).view(1, TILE_H, 1, 1)) + 0.5
    depth = init_tiles.view(g, TILE_H, STRIPS, STRIP_W).clone()
    winner = torch.full_like(depth, -1, dtype=torch.int32)
    for i in range(max_rows):
        row = recs[:, i].view(g, 1, STRIPS, STRIP_W)
        ax, ay, bx, by, cx, cy, z0, z1, z2, tid = (row[..., k:k + 1] for k in range(NFIELD))
        b0, b1, b2, _ = semantics.barycentric(ax, ay, bx, by, cx, cy, px, py)
        covered = semantics.coverage_mask(b0, b1, b2)
        z = semantics.affine_z(z0, z1, z2, b0, b1, b2)
        covered &= torch.isfinite(z)
        covered &= tid >= 0
        zc = torch.where(covered, z, torch.inf)
        better = zc < depth
        depth = torch.where(better, zc, depth)
        winner = torch.where(better, tid.to(torch.int32), winner)
    return depth.view(g, TILE_H, TILE_W), winner.view(g, TILE_H, TILE_W)


def strip_raster_split_plain(recs, rows, init_tiles, n_tiles_x: int, range_len: int):
    """``strip_raster_plain`` computed as the CUDA kernel splits it, for
    the tests: ``strip_raster_plain`` over each range of ``range_len``
    record rows of every group, the rows past ``rows[g]`` read as empty
    slots (the kernel never reads them), merged by
    ``raster_coarse.split_walks``.  Equal to ``strip_raster_plain``
    bitwise where those rows are empty, as the contract has them."""
    _check(recs, rows, init_tiles)
    g, max_rows, _ = recs.shape

    def walk(r, init, stats):
        part = recs[:, r * range_len:(r + 1) * range_len].clone()
        at = r * range_len + torch.arange(part.shape[1], device=recs.device)
        dead = at[None, :] >= rows[:, None]                             # (G, rows)
        part.view(g, -1, STRIPS, STRIP_W)[..., NFIELD - 1].masked_fill_(dead[..., None], -1.0)
        return strip_raster_plain(part, rows, init, n_tiles_x)

    depth, winner, _ = split_walks(walk, init_tiles, rows.clamp(0, max_rows), range_len,
                                   False)
    return depth, winner


def tie_pile(n_tie: int = 100, device="cpu"):
    """One 8 x 128 group of ties: slot k of rows 0 .. n_tie - 1 holds one
    triangle over the whole tile at one depth under ids 0 .. n_tie - 1
    (slot 3 of row 0 empty: id 1 wins strip 3), then a farther triangle
    over the tile (id n_tie), a row of empty slots, a nearer triangle
    over columns 0 .. ~60 of the top rows (id n_tie + 2) and two padded
    rows.  Its walk must keep the first-drawn triangle of every tie
    across the kernel's range boundaries.  -> (recs, rows, init_tiles,
    n_tiles_x)."""
    n = n_tie + 5
    recs = torch.zeros((1, n, STRIPS, STRIP_W), dtype=torch.float32)
    recs[..., NFIELD - 1] = -1.0

    def put(row, tri, tri_id):
        recs[0, row, :, :NFIELD - 1] = torch.tensor(tri, dtype=torch.float32)
        recs[0, row, :, NFIELD - 1] = tri_id
    big = (-64.0, -64.0, 512.0, -64.0, -64.0, 512.0)
    for r in range(n_tie):
        put(r, big + (0.5, 0.5, 0.5), float(r))
    recs[0, 0, 3, NFIELD - 1] = -1.0
    put(n_tie, big + (0.75, 0.75, 0.75), float(n_tie))
    put(n_tie + 2, (0.0, -1.0, 60.0, -1.0, 0.0, 30.0, 0.25, 0.25, 0.25), float(n_tie + 2))
    rows = torch.tensor([n_tie + 3], dtype=torch.int32)
    init = torch.full((1, TILE_H, TILE_W), torch.inf)
    return (recs.view(1, n, TILE_W).to(device), rows.to(device), init.to(device), 1)


def strip_rasterize(setup: dict, init_depth, width: int, height: int):
    """The script's ``strip_rasterize``: -> (depth (H, W) f32, winner
    (H, W) i32, the records' shape)."""
    from tinyrenderder_tpu_torch.ops.raster_sparse import untile_one  # imports raster_*

    recs, rows, ntx, nty, row_total = build_strip_records(setup, width, height)
    init = to_tiles(init_depth, nty, ntx, TILE_H, TILE_W, torch.inf)
    depth_t, winner_t = strip_raster(recs, rows, init, ntx, row_total=row_total)
    depth = untile_one(depth_t, ntx, nty, TILE_H, TILE_W)[:height, :width]
    winner = untile_one(winner_t, ntx, nty, TILE_H, TILE_W)[:height, :width]
    return depth, winner, tuple(recs.shape)


def script_setups(device, width: int = 128, height: int = 64) -> dict:
    """The script's three passes through the port's vertex stage: the head,
    soup and cube of ``tests/helpers.py::standard_meshes`` under
    ``GouraudShader()`` and its default view (eye (0, 0.5, 3), fov 60,
    aspect 1, near 0.1, far 50).  -> {name: setup}."""
    from tinyrenderder_tpu_torch.shaders import GouraudShader

    head = procedural.bumpy_head(12, 16)
    head.materials = [procedural.default_head_material(32)]
    meshes = {"head": head, "soup": procedural.triangle_soup(40), "cube": procedural.cube()}
    view = math3d.lookat((0, 0.5, 3), (0, 0, 0), (0, 1, 0))
    proj = math3d.perspective(60.0, 1.0, 0.1, 50.0)
    out = {}
    for name, mesh in meshes.items():
        shader = GouraudShader()
        material = mesh.materials[0] if mesh.materials else None
        uniforms = shader.build_uniforms(view @ np.eye(4), proj, material, np.float32)
        attrs, uniforms = convert.pass_to_torch(mesh.face_attributes(np.float32), uniforms,
                                                device)
        out[name] = vertex_stage(attrs, uniforms, shader, width, height)[0]
    return out


def check_against_coarse(setup: dict, width: int, height: int):
    """The script's own check (``:230-248``) on the port: the prototype
    against the production raster over every 8-row tile
    (``raster_coarse.coarse_raster_plain``, which takes any tile height).
    -> (coverage equal, winners equal, max depth ulps, records' shape)."""
    from tinyrenderder_tpu_torch.ops import raster_coarse
    from tinyrenderder_tpu_torch.ops.raster_sparse import untile_one_plain
    from tinyrenderder_tpu_torch.ops.raster_tiled import bin_triangles_csr

    dev = setup["bbox"].device
    init = torch.full((height, width), torch.inf, device=dev)
    bins = bin_triangles_csr(setup, width, height, TILE_W, TILE_H)
    n_t = bins.counts.shape[0]
    d_t, w_t, _ = raster_coarse.coarse_raster_plain(
        raster_coarse.build_tri_records(setup), bins.sorted_tri,
        torch.arange(n_t, dtype=torch.int32, device=dev), bins.start[:-1], bins.counts,
        to_tiles(init, bins.n_tiles_y, bins.n_tiles_x, TILE_H, TILE_W, torch.inf),
        bins.n_tiles_x, TILE_H, TILE_W, 0)
    d_ref, w_ref = (untile_one_plain(x, bins.n_tiles_x, bins.n_tiles_y, TILE_H, TILE_W)
                    [:height, :width].cpu().numpy() for x in (d_t, w_t))
    d_new, w_new, shape = strip_rasterize(setup, init, width, height)
    d_new, w_new = d_new.cpu().numpy(), w_new.cpu().numpy()
    cov_ok = bool((np.isfinite(d_ref) == np.isfinite(d_new)).all())
    win_ok = bool((w_ref == w_new).all())
    both = np.isfinite(d_ref) & np.isfinite(d_new)
    ulps = 0
    if both.any():
        ulps = int(np.abs(d_ref[both].view(np.int32).astype(np.int64)
                          - d_new[both].view(np.int32).astype(np.int64)).max())
    return cov_ok, win_ok, ulps, shape


def main(argv=None) -> int:
    """The script's check on the port: head, soup and cube (Gouraud) at
    128 x 64 against the production raster; coverage equal and depth
    within 4 ulps pass, winners are printed."""
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    w, h = 128, 64
    ok = True
    for name, setup in script_setups(args.device, w, h).items():
        cov_ok, win_ok, ulps, shape = check_against_coarse(setup, w, h)
        print(f"{name}: coverage_ok={cov_ok} winners_ok={win_ok} depth_ulps={ulps} "
              f"recs={shape}")
        ok &= cov_ok and ulps <= 4
    print("PROTOTYPE", "VALIDATED" if ok else "FAILED", "| device:", args.device)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
