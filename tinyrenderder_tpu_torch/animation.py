"""Orbit-camera animation with frame-level checkpoint/resume, on the port.

Counterpart of ``tinyrenderder_tpu/animation.py``: the eye orbits the
target about +Y (the reference's rotY builder, main.cpp:408-420, applied
to the camera), every frame is written as a TGA file, and a killed job
resumes at the next unwritten frame from ``<outdir>/checkpoint.json``,
written atomically with the JAX module's keys and read by its rule.

Per frame, ``Scene.render(..., collect_stats=False, backend=cfg.backend,
mesh=cfg.mesh)`` renders on ``cfg.device``: the tiled frame, the scan
backend's ("xla"), the NumPy oracle, or one of the sharded backends over
the mesh's ranks.  When the
colour is on a CUDA device it is copied into one of two pinned host
buffers with ``non_blocking=True`` and a CUDA event is recorded; while
the next frame renders, the previous one waits for its event, is encoded
and written (the JAX module's one-frame write pipeline).  Files and
checkpoints land strictly in frame order.

On a sharded backend over a process group (under torchrun) every rank
renders every frame and rank 0 alone reads the checkpoint, encodes and
writes; it broadcasts the start frame, so every rank runs the same orbit
steps.  One process emulating the ranks writes as rank 0 does.

The JAX module's overflow repair has no counterpart: the port sizes
every buffer exactly from one readback per pass, so no frame can
overflow.  The summary keeps ``"overflows_repaired": 0`` so that callers
of either module read the same keys.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from tinyrenderder_tpu_torch import math3d, trace
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.parallel import dist
from tinyrenderder_tpu_torch.scene import Scene
from tinyrenderder_tpu_torch.utils import tga

log = logging.getLogger("tinyrenderder_tpu_torch.animation")

__all__ = ["AnimationConfig", "orbit_eye", "render_animation", "CHECKPOINT_NAME"]

CHECKPOINT_NAME = "checkpoint.json"


@dataclass
class AnimationConfig:
    frames: int = 120
    orbit_degrees: float = 360.0
    #: one of ``scene.BACKENDS`` (as ``Scene.render``)
    backend: str = "tiled"
    #: where the frames render: "cuda" (the kernels) or "cpu" (their plain versions)
    device: str = "cuda"
    #: the ranks of a sharded backend (``parallel.dist.Mesh``); None:
    #: ``dist.make_mesh(device=device)``, the process group's ranks or one
    mesh: object = None
    outdir: str = "frames"
    frame_pattern: str = "frame_%04d.tga"
    frustum_cull: bool = True
    checkpoint: bool = True


def orbit_eye(eye, target, angle_rad: float) -> np.ndarray:
    """Rotate the eye position around the target about +Y."""
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    rel = eye - target
    rot = math3d.rotation_y(angle_rad)
    return target + (rot[:3, :3] @ rel)


def _checkpoint_path(cfg: AnimationConfig) -> str:
    return os.path.join(cfg.outdir, CHECKPOINT_NAME)


def _load_checkpoint(cfg: AnimationConfig) -> int:
    path = _checkpoint_path(cfg)
    if not (cfg.checkpoint and os.path.exists(path)):
        return 0
    try:
        with open(path) as f:
            data = json.load(f)
        if data.get("frames") == cfg.frames and data.get("orbit_degrees") == cfg.orbit_degrees:
            return int(data.get("next_frame", 0))
        log.warning("checkpoint config mismatch — restarting from frame 0")
    except (OSError, ValueError) as e:
        log.warning("unreadable checkpoint (%s) — restarting", e)
    return 0


def _save_checkpoint(cfg: AnimationConfig, next_frame: int) -> None:
    if not cfg.checkpoint:
        return
    # atomic: a kill mid-dump must not truncate the previous checkpoint
    path = _checkpoint_path(cfg)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"next_frame": next_frame, "frames": cfg.frames,
                   "orbit_degrees": cfg.orbit_degrees}, f)
    os.replace(tmp, path)


def render_animation(scene: Scene, cfg: AnimationConfig,
                     stop_after: int | None = None) -> dict:
    """Render the orbit sequence, resuming from the checkpoint if present.

    ``stop_after`` caps the number of frames rendered *this run* (time-
    sliced jobs); the checkpoint lets the next run continue the schedule.
    Returns {frames_rendered, resumed_at, seconds, fps, overflows_repaired},
    the same on every rank.
    """
    backend = tscene._backend(cfg.backend)
    mesh = None
    if backend in tscene.SHARDED_BACKENDS:
        mesh = cfg.mesh if cfg.mesh is not None else dist.make_mesh(device=cfg.device)
    writer = mesh is None or not mesh.rank       # rank 0, or one process
    start_frame = 0
    if writer:
        os.makedirs(cfg.outdir, exist_ok=True)
        start_frame = _load_checkpoint(cfg)
    if mesh is not None:
        start_frame = dist.broadcast_from_rank0(mesh, start_frame)
    if start_frame >= cfg.frames:
        log.info("animation already complete (%d frames)", cfg.frames)
        return {"frames_rendered": 0, "resumed_at": start_frame, "seconds": 0.0, "fps": 0.0}
    if start_frame:
        log.info("resuming at frame %d/%d", start_frame, cfg.frames)

    base_eye = np.array(scene.camera.params.eye, dtype=np.float64)
    base_target = np.array(scene.camera.params.target, dtype=np.float64)
    end_frame = cfg.frames
    if stop_after is not None:
        end_frame = min(end_frame, start_frame + stop_after)
    host_bufs: list = [None, None]       # the two pinned colour buffers, alternating

    t0 = time.perf_counter()
    rendered = 0
    pending = None                       # (frame, host colour, event or None)

    def write(idx: int, color, event) -> None:
        with trace.span("animation.write", idx):
            if event is not None:
                event.synchronize()
            path = os.path.join(cfg.outdir, cfg.frame_pattern % idx)
            rgb = color.numpy() if isinstance(color, torch.Tensor) else color
            tga.TGAImage.from_rgb(rgb).write_tga_file(path)
            _save_checkpoint(cfg, idx + 1)

    try:
        for i in range(start_frame, end_frame):
            event = None
            with trace.frame("animation.frame"):
                angle = math.radians(cfg.orbit_degrees) * i / cfg.frames
                scene.camera.set_eye(orbit_eye(base_eye, base_target, angle))
                color = scene.render(cfg.device, cfg.frustum_cull, collect_stats=False,
                                     backend=backend, mesh=mesh).color
                rendered += 1
                if writer and isinstance(color, torch.Tensor) and color.is_cuda:
                    slot = (i - start_frame) % 2
                    if host_bufs[slot] is None:
                        host_bufs[slot] = torch.empty(color.shape, dtype=color.dtype,
                                                      pin_memory=True)
                    host_bufs[slot].copy_(color, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record()
                    color = host_bufs[slot]
            if not writer:
                continue
            if pending is not None:
                write(*pending)
            pending = (i, color, event)
            if i % 10 == 0:
                log.info("frame %d/%d (%.2f s/frame)", i, cfg.frames,
                         (time.perf_counter() - t0) / max(i - start_frame + 1, 1))
        if pending is not None:
            write(*pending)
    finally:
        # a same-process retry must not orbit around a mid-orbit base eye
        scene.camera.set_eye(base_eye)
    if mesh is not None:
        dist.barrier(mesh)               # rank 0 returns once every rank has rendered
    dt = time.perf_counter() - t0
    return {"frames_rendered": rendered, "resumed_at": start_frame, "seconds": dt,
            "fps": rendered / dt if dt > 0 else 0.0, "overflows_repaired": 0}
