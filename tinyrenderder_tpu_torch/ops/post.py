"""Post-processing: z-buffer visualization, SSAO, composite.

Counterpart of ``tinyrenderder_tpu/ops/post.py``:

  * save_zbuffer_image (main.cpp:269-314): finite depths normalized to
    [min, max] as 255 * (1 - normalized), infinite depth white;
  * compute_ssao_at (main.cpp:317-362): 8 directions x 8 steps out to
    16 px; a tap occludes when finite and more than 1e-3 nearer than the
    centre; AO = 1 - 0.35 * occluded / total; off-screen taps are
    skipped, infinite taps count but never occlude, infinite centres
    get 1.0;
  * composite (main.cpp:768-786): (colour * AO byte) // 255 per channel.

The PyTorch functions (``zbuffer_to_image`` ... ``postprocess``) run on
the frame's device in the JAX package's op order.  Every tensor stays on
its device: the depth range is kept as 0-d device tensors, so the
normalization divides tensor by tensor (PyTorch's CUDA division by a
host scalar multiplies by the reciprocal, which rounds differently).
The SSAO is plain PyTorch, as it is XLA and not Pallas in the JAX
package.  ``oracle_post`` is the same post in NumPy: the reference for
the oracle's frames.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tinyrenderder_tpu_torch import trace

__all__ = ["zbuffer_to_image", "ssao_map", "ssao_image", "composite", "postprocess",
           "oracle_post", "ssao_offsets", "AO_NUM_DIRECTIONS", "AO_STEPS_PER_DIRECTION",
           "AO_SAMPLE_RADIUS", "AO_OCCLUSION_THRESHOLD", "AO_INTENSITY"]

# SSAO parameters (main.cpp:317-321)
AO_NUM_DIRECTIONS = 8
AO_STEPS_PER_DIRECTION = 8
AO_SAMPLE_RADIUS = 16.0
AO_OCCLUSION_THRESHOLD = 1e-3
AO_INTENSITY = 0.35


def ssao_offsets() -> list[tuple[int, int]]:
    """The 64 integer (dx, dy) taps of compute_ssao_at (main.cpp:332-339),
    with C round-half-away-from-zero; no tap lands on a .5 tie, so
    ``round(px + t) == px + round(t)`` for every pixel."""
    def c_round(v: float) -> int:
        return int(math.floor(v + 0.5)) if v >= 0 else -int(math.floor(-v + 0.5))

    taps = []
    for direction in range(AO_NUM_DIRECTIONS):
        angle = 2.0 * math.pi * direction / AO_NUM_DIRECTIONS
        dx, dy = math.cos(angle), math.sin(angle)
        for step in range(1, AO_STEPS_PER_DIRECTION + 1):
            radius = step / AO_STEPS_PER_DIRECTION * AO_SAMPLE_RADIUS
            taps.append((c_round(dx * radius), c_round(dy * radius)))
    return taps


def zbuffer_to_image(zbuffer):
    """Grayscale (H, W) uint8 view of a depth buffer (main.cpp:269-314):
    255 * (1 - normalized), infinite depth white.  ``zbuffer``'s dtype is
    the working dtype."""
    finite = torch.isfinite(zbuffer)
    any_finite = finite.any()
    big = torch.tensor(1e9, dtype=zbuffer.dtype, device=zbuffer.device)
    zmin = torch.where(finite, zbuffer, big).amin()
    zmax = torch.where(finite, zbuffer, -big).amax()
    zmax = torch.where(zmax - zmin < 1e-7, zmin + 1e-7, zmax)
    denom = zmax - zmin
    denom = torch.where(denom > 0, denom, torch.ones_like(denom))
    normalized = (zbuffer - zmin) / denom
    value = torch.trunc(255.0 * (1.0 - normalized))
    value = torch.where(finite, value, 255.0)
    value = torch.where(any_finite, value, torch.full_like(value, 255.0))
    return torch.clamp(value, 0, 255).to(torch.uint8)


def ssao_map(zbuffer):
    """Ambient-occlusion factor per pixel in [0.65, 1.0] in the working
    dtype (main.cpp:324-362): 64 taps, a sample occludes when finite and
    more than the threshold nearer than the centre; off-screen taps are
    skipped (NaN padding), infinite taps count but never occlude."""
    h, w = zbuffer.shape
    pad = 17  # max |offset| is 16
    zpad = torch.full((h + 2 * pad, w + 2 * pad), torch.nan, dtype=zbuffer.dtype,
                      device=zbuffer.device)
    zpad[pad:pad + h, pad:pad + w] = zbuffer
    occluded = torch.zeros((h, w), dtype=torch.int32, device=zbuffer.device)
    total = torch.zeros_like(occluded)
    threshold_ref = zbuffer - AO_OCCLUSION_THRESHOLD
    for dx, dy in ssao_offsets():
        sample = zpad[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        total += (~torch.isnan(sample)).to(torch.int32)
        occluded += (torch.isfinite(sample) & (sample < threshold_ref)).to(torch.int32)
    ratio = occluded.to(zbuffer.dtype) / torch.clamp(total, min=1).to(zbuffer.dtype)
    ao = 1.0 - ratio * AO_INTENSITY
    ao = torch.where(total == 0, torch.ones_like(ao), ao)
    return torch.where(torch.isfinite(zbuffer), ao, torch.ones_like(ao))


def ssao_image(ao):
    """AO factor -> grayscale uint8 (main.cpp:760-761, truncating cast)."""
    return torch.trunc(255.0 * ao).to(torch.uint8)


def composite(color, ao_u8):
    """final = (color * ao_byte) // 255 per channel in integer math
    (main.cpp:768-786, as the JAX package computes it)."""
    prod = color.to(torch.int32) * ao_u8.to(torch.int32)[..., None]
    return torch.div(prod, 255, rounding_mode="floor").to(torch.uint8)


def postprocess(color_u8, depth):
    """(H, W, 3) uint8 colour and (H, W) f32 depth -> (zbuffer image,
    AO image, final composite), uint8 on the tensors' device."""
    with trace.span("post"):
        zimg = zbuffer_to_image(depth)
        ao_u8 = ssao_image(ssao_map(depth))
        return zimg, ao_u8, composite(color_u8, ao_u8)


# ---------------------------------------------------------------------------
# the same post in NumPy (the reference for the oracle's frames)
# ---------------------------------------------------------------------------

def zbuffer_to_image_np(zbuffer):
    """``zbuffer_to_image`` in NumPy; the working dtype is ``zbuffer``'s."""
    finite = np.isfinite(zbuffer)
    any_finite = np.any(finite)
    big = np.asarray(1e9, dtype=zbuffer.dtype)
    zmin = np.min(np.where(finite, zbuffer, big))
    zmax = np.max(np.where(finite, zbuffer, -big))
    # the degenerate-range guard (main.cpp:294-296); the positive-clamped
    # denominator keeps float32 from 0/0 where zmin + 1e-7 rounds to zmin
    zmax = np.where(zmax - zmin < 1e-7, zmin + 1e-7, zmax)
    denom = zmax - zmin
    denom = np.where(denom > 0, denom, np.ones_like(denom))
    normalized = (zbuffer - zmin) / denom
    value = np.trunc(255.0 * (1.0 - normalized))
    value = np.where(finite, value, 255.0)
    value = np.where(any_finite, value, np.full_like(value, 255.0))
    return np.clip(value, 0, 255).astype(np.uint8)


def ssao_map_np(zbuffer):
    """``ssao_map`` in NumPy."""
    h, w = zbuffer.shape
    dtype = zbuffer.dtype
    pad = 17  # max |offset| is 16
    zpad = np.full((h + 2 * pad, w + 2 * pad), np.asarray(np.nan, dtype=dtype), dtype=dtype)
    zpad[pad:pad + h, pad:pad + w] = zbuffer
    occluded = np.zeros((h, w), dtype=np.int32)
    total = np.zeros((h, w), dtype=np.int32)
    threshold_ref = zbuffer - AO_OCCLUSION_THRESHOLD
    for dx, dy in ssao_offsets():
        sample = zpad[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        total = total + (~np.isnan(sample)).astype(np.int32)
        occluded = occluded + (np.isfinite(sample) & (sample < threshold_ref)).astype(np.int32)
    ratio = occluded.astype(dtype) / np.maximum(total, 1).astype(dtype)
    ao = 1.0 - ratio * AO_INTENSITY
    ao = np.where(total == 0, np.ones_like(ao), ao)
    return np.where(np.isfinite(zbuffer), ao, np.ones_like(ao))


def ssao_image_np(ao):
    return np.trunc(255.0 * ao).astype(np.uint8)


def composite_np(color, ao_u8):
    prod = color.astype(np.int32) * ao_u8.astype(np.int32)[..., None]
    return (prod // 255).astype(np.uint8)


def oracle_post(color_u8, depth):
    """The NumPy post on host arrays ((H, W, 3) uint8, (H, W) depth):
    the bitwise reference for ``postprocess``."""
    zimg = zbuffer_to_image_np(depth)
    ao_u8 = ssao_image_np(ssao_map_np(depth))
    return zimg, ao_u8, composite_np(color_u8, ao_u8)
