"""The state carried across from the host layer to the device.

``Mesh.face_attributes`` and ``Shader.build_uniforms`` run host-side in
NumPy, in this package as in the JAX package.  Their outputs become
tensors here, bit for bit: float32 stays float32, uint8 textures stay
uint8, ``None`` (a missing texture) stays ``None``.  So one scene's
NumPy inputs, from either package, feed both sides of a comparison.
``device_key`` names a device the same way whatever the caller wrote, for
the caches that keep these tensors (``Mesh.device_face_attributes``,
``scene``'s per-pass and large-uniform caches).
"""

from __future__ import annotations

import numpy as np
import torch


def device_key(device) -> torch.device:
    """``device`` as a ``torch.device`` with its index: ``"cuda"`` is the
    current card (``cuda:0`` on a one-card host), so one mesh rendered on
    the CPU and on the card keeps one cache entry for each.  A CUDA
    device with no card raises; nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: no CUDA device is available "
                           "(pass device='cpu' for the plain versions on the host)")
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


def to_torch(value, device):
    """One attribute or uniform: ndarray -> tensor on ``device``;
    anything else (None, Python scalars) passes through."""
    if isinstance(value, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(value)).to(device)
    return value


def pass_to_torch(attrs: dict, uniforms: dict, device) -> tuple[dict, dict]:
    """(attrs {name: (F, 3, C)}, uniforms) NumPy dicts -> tensor dicts."""
    return ({k: to_torch(v, device) for k, v in attrs.items()},
            {k: to_torch(v, device) for k, v in uniforms.items()})
