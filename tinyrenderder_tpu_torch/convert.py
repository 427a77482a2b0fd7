"""The state carried across from the host layer to the device.

``Mesh.face_attributes`` and ``Shader.build_uniforms`` run host-side in
NumPy, in this package as in the JAX package.  Their outputs become
tensors here, bit for bit: float32 stays float32, uint8 textures stay
uint8, ``None`` (a missing texture) stays ``None``.  So one scene's
NumPy inputs, from either package, feed both sides of a comparison.
"""

from __future__ import annotations

import numpy as np
import torch


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
