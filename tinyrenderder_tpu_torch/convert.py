"""The state carried across from the JAX package's host code.

``Mesh.face_attributes`` and ``Shader.build_uniforms`` run host-side in
NumPy (they import no jax).  Their outputs become tensors here, bit for
bit: float32 stays float32, uint8 textures stay uint8, ``None`` (a
missing texture) stays ``None``.  Both packages then compute from
identical inputs.
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
