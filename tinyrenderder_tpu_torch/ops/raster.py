"""Frame buffers and per-pass render counters in PyTorch.

Counterpart of the parts of ``tinyrenderder_tpu/ops/raster.py`` that the
tiled frame uses: ``BACKGROUND``, ``FrameBuffers`` and ``pass_stats``.
The JAX module imports jax at module level, so the port cannot reuse it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["BACKGROUND", "FrameBuffers", "pass_stats"]

BACKGROUND = -1  # winner id for empty pixels

_INT32_MAX = 2**31 - 1
_INT32_MIN = -2**31


class FrameBuffers(NamedTuple):
    """The frame in image layout (the reference's framebuffer and
    zbuffer, our_gl.cpp:12-15)."""

    color: torch.Tensor    # (H, W, 3) uint8
    depth: torch.Tensor    # (H, W) float32, +inf where empty
    winner: torch.Tensor   # (H, W) int32 triangle id of the depth owner


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
    min_x, max_x, min_y, max_y, n_valid = torch.stack(
        [b[:, 0].amin(), b[:, 1].amax(), b[:, 2].amin(), b[:, 3].amax(),
         valid.sum()]).tolist()
    return dict(min_x=min_x, max_x=max_x, min_y=min_y, max_y=max_y,
                triangles=int(valid.shape[0]), valid_triangles=n_valid)
