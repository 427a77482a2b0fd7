"""raster_roofline_pct: the raster kernels' bound over their device time.

The kernels are those of ``csrc/raster_coarse.cu``, ``raster_fine.cu``,
``raster_fine2.cu``, ``raster_strip.cuh`` and ``raster_common.cuh``
(``KERNELS``), their device time summed over the profiled frames.  The
bound is counted from the scene's inputs by the reference
(``reference.Frame.work``: what the pass has to test, win and write,
whatever bins or tiles implement it), one pass at a time: max(bytes /
PEAK_BYTES_S, operations / PEAK_FLOPS), summed over the passes of the
profiled frames.  Per pass: 25 operations per pixel centre inside a
valid triangle's clipped bbox and 34 + 6V per won pixel (V varying
channels); 64 bytes per valid triangle read, 12V per triangle that wins
a pixel, and the depth and winner planes (4 bytes each a pixel) written
once.  Peaks: one H100 SXM, 3.35 TB/s and 67 TFLOP/s in float32 outside
the tensor cores, at its 700 W limit.
"""

UNIT = "%"
LAYER = "raster kernels (csrc/raster_*.cu)"
MOVES = "frame_p95_ms"

KERNELS = ("item_scan_kernel", "coarse_walk_kernel", "coarse_merge_kernel",
           "coarse_events_kernel", "strip_walk_kernel", "strip_merge_kernel",
           "strip_events_kernel")
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = 67e12
OPS_TEST, OPS_WIN, OPS_WIN_PER_VARYING = 25, 34, 6


def pass_bound_s(work: dict) -> float:
    """The least time one pass's raster could take, in seconds."""
    v = work["varyings"]
    ops = work["tests"] * OPS_TEST + work["won"] * (OPS_WIN + OPS_WIN_PER_VARYING * v)
    n_bytes = work["valid"] * 64 + work["winning_triangles"] * 12 * v + work["pixels"] * 8
    return max(n_bytes / PEAK_BYTES_S, ops / PEAK_FLOPS)


def read(data):
    t = data.window.trace
    if t is None or data.work is None:
        return None
    kernel_s = sum(e - s for name, s, e in t.device if any(k in name for k in KERNELS)) / 1e6
    if kernel_s <= 0:
        return None
    bound = sum(pass_bound_s(p) for frame in data.work for p in frame)
    return 100.0 * bound / kernel_s
