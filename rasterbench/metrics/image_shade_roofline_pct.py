"""image_shade_roofline_pct: the image route's fresh shading bound over
the device time of ``shade_fresh_kernel``.

The kernel is ``csrc/shade.cu``'s fresh-frame entry (``KERNEL``), its
device time summed over the profiled frames.  The bound is counted from
the scene's inputs by the reference (``reference.Frame.work``: the pixels
the pass wins and its V varying channels, whatever tiles implement it),
one pass at a time: max(bytes / PEAK_BYTES_S, operations / PEAK_FLOPS),
summed over the passes of the profiled frames, at
``raster_roofline_pct``'s peaks.  Per won pixel: its V varyings and its
winner read (4V + 4 bytes), its packed colour written (4 bytes), and
the Phong fragment's ``OPS_PHONG`` float operations.  The texture's
texels stay in L2 and are not counted.

``OPS_PHONG`` is counted once from ``shaders.fragment`` of a
``PhongShader`` with a packed texture (``_phong_rgb_base``), one for
each float add, subtract, multiply, divide and square root; negations,
comparisons, clamps, truncations and conversions are not counted, nor
``transform_dir``'s fourth row, which the fragment throws away:

  sample_packed: 2 (the two texel indices) + 9 (the normal map's
  t / 255 * 2 - 1) + 9 (its normalisation: dot 5, root 1, 3 divides) +
  1 (the specular t / 255) = 21;
  _phong_rgb_base: brightness 3, transform_dir 21 (3 rows of 4 products
  and 3 sums), the blend 9, normalized3 of the blend 9 and of the view 9,
  dot(n, key) 5, the key diffuse 1, 2 * dot 1, the reflection 6 and its
  normalisation 9, dot(reflect, view) 5, the key specular 1, fill and
  rim diffuse 6 each, the diffuse sum 2, + ambient 1, the specular term
  2, base * lit + specular 6 = 102.

None where the program launches no such kernel (a program without the
fresh entry) or the reference counted no work.
"""

from rasterbench.metrics import raster_roofline_pct as raster

UNIT = "%"
LAYER = "merge + shade (post_sparse, post_fine2)"
MOVES = "frame_p95_ms"

KERNEL = "shade_fresh_kernel"
OPS_PHONG = 21 + 102


def pass_bound_s(work: dict) -> float:
    """The least time one pass's fresh shading could take, in seconds."""
    won = work["won"]
    n_bytes = won * (4 * work["varyings"] + 4 + 4)
    return max(n_bytes / raster.PEAK_BYTES_S, won * OPS_PHONG / raster.PEAK_FLOPS)


def read(data):
    t = data.window.trace
    if t is None or data.work is None:
        return None
    kernel_s = sum(e - s for name, s, e in t.device if KERNEL in name) / 1e6
    bound = sum(pass_bound_s(p) for frame in data.work for p in frame)
    if kernel_s <= 0 or bound <= 0:
        return None
    return 100.0 * bound / kernel_s
