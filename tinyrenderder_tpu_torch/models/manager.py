"""Path-keyed model cache (the reference's model_manager.{h,cpp}) and the
format-dispatched load.

Counterpart of ``tinyrenderder_tpu/models/manager.py``: ``load_mesh``
picks the loader by extension (PLY, STL, glTF/GLB, COLLADA, FBX, OFF,
anything else OBJ); ``ModelManager`` caches meshes by canonical path,
strongly or (``weak=True``) weakly, with the reference's get, unload and
statistics calls.  ``instance()`` keeps the call-site shape of
``ModelManager::getInstance()``; a caller may construct its own manager.
"""

from __future__ import annotations

import logging
import os
import threading
import weakref

from tinyrenderder_tpu_torch.models.mesh import Mesh
from tinyrenderder_tpu_torch.models.obj import load_obj

log = logging.getLogger("tinyrenderder_tpu_torch.manager")

__all__ = ["ModelManager", "load_mesh"]


def load_mesh(path: str, load_textures: bool = True) -> Mesh:
    """Format-dispatched load (the Assimp-style single entry point the
    reference gets from ReadFile, model.cpp:91-99): .ply -> PLY loader,
    .stl -> STL loader, .gltf/.glb -> glTF loader, .dae -> COLLADA
    loader, .fbx -> FBX loader, .off -> OFF loader, anything else ->
    OBJ."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        from tinyrenderder_tpu_torch.models.ply import load_ply
        return load_ply(path, load_textures=load_textures)
    if ext == ".stl":
        from tinyrenderder_tpu_torch.models.stl import load_stl
        return load_stl(path, load_textures=load_textures)
    if ext in (".gltf", ".glb"):
        from tinyrenderder_tpu_torch.models.gltf import load_gltf
        return load_gltf(path, load_textures=load_textures)
    if ext == ".dae":
        from tinyrenderder_tpu_torch.models.collada import load_collada
        return load_collada(path, load_textures=load_textures)
    if ext == ".fbx":
        from tinyrenderder_tpu_torch.models.fbx import load_fbx
        return load_fbx(path, load_textures=load_textures)
    if ext == ".off":
        from tinyrenderder_tpu_torch.models.off import load_off
        return load_off(path, load_textures=load_textures)
    return load_obj(path, load_textures=load_textures)


class ModelManager:
    """Loads and caches meshes keyed by canonical path
    (model_manager.cpp:6-36)."""

    _instance: "ModelManager | None" = None
    _instance_lock = threading.Lock()

    def __init__(self, weak: bool = False):
        self._lock = threading.Lock()
        self._cache: dict[str, Mesh] | weakref.WeakValueDictionary = (
            weakref.WeakValueDictionary() if weak else {})

    @classmethod
    def instance(cls) -> "ModelManager":
        """Process-wide manager (model_manager.h:11-14)."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @staticmethod
    def _canonical(path: str) -> str:
        return os.path.realpath(path)

    def load_model(self, path: str, load_textures: bool = True) -> Mesh | None:
        """Cache hit or load (model_manager.cpp:6-36).  Returns None on
        failure like the reference (which logs and returns nullptr)."""
        key = self._canonical(path)
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

    def get_model(self, path: str) -> Mesh | None:
        """Alias for load_model (model_manager.cpp:38-40)."""
        return self.load_model(path)

    def unload_model(self, path: str) -> bool:
        """Drop one entry (model_manager.cpp:42-59)."""
        key = self._canonical(path)
        with self._lock:
            if key in self._cache:
                del self._cache[key]
                log.info("Model unloaded from cache: %s", key)
                return True
        return False

    def unload_all(self) -> None:
        """Drop everything (model_manager.cpp:61-72)."""
        with self._lock:
            self._cache.clear()
        log.info("All models unloaded from cache")

    def stats(self) -> dict[str, int]:
        """Counters equivalent to printStats (model_manager.cpp:74-91)."""
        with self._lock:
            items = list(self._cache.items())
        return {os.path.basename(k): m.nfaces for k, m in items}

    def print_stats(self) -> None:
        stats = self.stats()
        log.info("=== Model Manager Statistics ===")
        log.info("Cached models: %d", len(stats))
        for name, nfaces in stats.items():
            log.info("  - %s (faces: %d)", name, nfaces)
