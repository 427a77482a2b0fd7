"""Post-processing in PyTorch: z-buffer visualization, SSAO, composite.

Counterpart of ``tinyrenderder_tpu/ops/post.py`` (``zbuffer_to_image``,
``ssao_map``, ``ssao_image``, ``composite``, ``postprocess_device``) in
the same op order; the 64 SSAO taps and the constants are the JAX
module's own (it imports no jax).  Every tensor stays on its device: the
depth range is kept as 0-d device tensors, so the normalization divides
tensor by tensor (PyTorch's CUDA division by a host scalar multiplies by
the reciprocal, which rounds differently).  The SSAO is plain PyTorch
here, as it is XLA and not Pallas in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from tinyrenderder_tpu.ops import post as ref

__all__ = ["zbuffer_to_image", "ssao_map", "ssao_image", "composite", "postprocess",
           "oracle_post"]


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
    threshold_ref = zbuffer - ref.AO_OCCLUSION_THRESHOLD
    for dx, dy in ref.ssao_offsets():
        sample = zpad[pad + dy:pad + dy + h, pad + dx:pad + dx + w]
        total += (~torch.isnan(sample)).to(torch.int32)
        occluded += (torch.isfinite(sample) & (sample < threshold_ref)).to(torch.int32)
    ratio = occluded.to(zbuffer.dtype) / torch.clamp(total, min=1).to(zbuffer.dtype)
    ao = 1.0 - ratio * ref.AO_INTENSITY
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
    zimg = zbuffer_to_image(depth)
    ao_u8 = ssao_image(ssao_map(depth))
    return zimg, ao_u8, composite(color_u8, ao_u8)


def oracle_post(color_u8, depth):
    """The JAX package's NumPy post on host arrays ((H, W, 3) uint8, (H, W)
    f32): the bitwise reference for ``postprocess``."""
    zimg = ref.zbuffer_to_image(depth, np)
    ao_u8 = ref.ssao_image(ref.ssao_map(depth, np), np)
    return zimg, ao_u8, ref.composite(color_u8, ao_u8, np)
