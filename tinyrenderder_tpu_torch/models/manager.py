"""Path-keyed model cache (the reference's model_manager.{h,cpp}).

Counterpart of ``tinyrenderder_tpu/models/manager.py``.  The port loads
OBJ files; the JAX package's other formats (PLY, STL, glTF/GLB, COLLADA,
FBX, OFF) raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

import logging
import os
import threading

from tinyrenderder_tpu_torch.models.mesh import Mesh
from tinyrenderder_tpu_torch.models.obj import load_obj

log = logging.getLogger("tinyrenderder_tpu_torch.manager")

__all__ = ["ModelManager", "load_mesh", "UNPORTED_FORMATS"]

#: model formats of the JAX package that the port does not load yet
UNPORTED_FORMATS = (".ply", ".stl", ".gltf", ".glb", ".dae", ".fbx", ".off")


def load_mesh(path: str, load_textures: bool = True) -> Mesh:
    """Load one model file: OBJ (any extension the JAX package does not
    dispatch elsewhere, as there)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in UNPORTED_FORMATS:
        raise NotImplementedError(
            f"{ext} models are not ported yet: ROADMAP.md Queue 1 item 14 "
            "(model loaders); the port loads OBJ")
    return load_obj(path, load_textures=load_textures)


class ModelManager:
    """Loads and caches meshes keyed by canonical path
    (model_manager.cpp:6-36)."""

    _instance: "ModelManager | None" = None
    _instance_lock = threading.Lock()

    def __init__(self):
        self._lock = threading.Lock()
        self._cache: dict[str, Mesh] = {}

    @classmethod
    def instance(cls) -> "ModelManager":
        """Process-wide manager (model_manager.h:11-14)."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def load_model(self, path: str, load_textures: bool = True) -> Mesh | None:
        """Cache hit or load (model_manager.cpp:6-36).  Returns None when
        the file fails to parse, like the reference; an unported format
        raises."""
        key = os.path.realpath(path)
        with self._lock:
            mesh = self._cache.get(key)
            if mesh is not None:
                log.info("Model cache hit: %s", key)
                return mesh
        try:
            mesh = load_mesh(key, load_textures=load_textures)
        except (OSError, ValueError, IndexError) as exc:
            log.error("Failed to load model: %s (%s)", key, exc)
            return None
        with self._lock:
            self._cache[key] = mesh
        log.info("Model loaded and cached: %s", key)
        return mesh
