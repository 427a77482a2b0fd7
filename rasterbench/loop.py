"""The frame loop: one general generator for every traffic mix.

A traffic file (``traffic/<name>.json``) names a ``route`` of the
program, its parameters and what a frame delivers; the route is a module
of its own, ``routes/<route>.py`` (``catalog.Benchmark.route``), with

  * ``outputs(plan)``: the images a frame delivers, name -> shape of
    its uint8 array;
  * ``frame(loop, spans)``: render one frame on ``loop.scene`` (the
    camera already set) -> (device images by name, the output depth or
    ``None``, the ``RenderStats`` or ``None``), calling
    ``loop.render_done(spans)`` once the render call has returned and
    wrapping any stage of its own in ``loop.device_span(spans, name)``.

This module delivers each image the route names into pinned host memory.
A frame starts when its camera is set and is delivered when its last
copy has reached the host (a synchronize).  The loop is closed: the
next frame starts after the last is delivered.  The eye orbits, one
view a frame (``scenes.Orbit``).  Set-up renders ``warmup_frames`` views
spread over the revolution, so every size of work the window meets has
been allocated once.

The window runs frames until ``seconds`` have passed since it opened;
every frame started in it counts.  A uniform sample of ``check_frames``
of its frames, drawn from the seed (reservoir sampling, so nothing is
copied twice), is kept for the comparison with the reference: their
host images, their output depth (a device copy) and their
``RenderStats``.

With ``trace``: per-frame spans over the window (``render_s`` on the
host clock around the render call, ended by a synchronize;
``<name>_ms`` from CUDA events around each ``device_span``, such as the
post) and, once the window has closed, ``trace_frames`` more frames of
the same loop under ``torch.profiler`` without the spans
(``trace.profile_frames``).  The profiler is left for
last: frames that follow a trace run slower (about a third slower for
the orbit cell on an H100), so nothing is timed after it.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from rasterbench import scenes


@dataclass
class Sample:
    frame: int
    eye: np.ndarray
    images: dict                     # name -> host uint8 tensor
    depth: torch.Tensor | None = None
    stats: object = None


@dataclass
class Window:
    frames: int = 0
    seconds: float = 0.0             # window length: start to the last delivery
    latencies: list = field(default_factory=list)   # s, every frame
    setup_s: float = 0.0
    samples: list = field(default_factory=list)
    spans: dict = field(default_factory=dict)       # name -> list of floats
    trace: object = None             # trace.Trace, with ``trace``
    memory_peak_bytes: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class FrameLoop:
    """One traffic mix's frame over the program's scene."""

    def __init__(self, plan: scenes.Plan, traffic: dict, route, device):
        self.plan, self.traffic, self.route = plan, traffic, route
        self.device = torch.device(device)
        self.scene = scenes.port_scene(plan)
        self._shapes = dict(route.outputs(plan))
        self.names = list(self._shapes)
        self._pin = self.device.type == "cuda"
        self._t0 = 0.0

    def new_buffers(self) -> dict:
        """One set of host buffers for a frame's delivered images."""
        return {n: torch.empty(self._shapes[n], dtype=torch.uint8, pin_memory=self._pin)
                for n in self.names}

    def render_done(self, spans: dict | None) -> None:
        """The route's render call has returned: with ``spans``, wait for
        the device and record ``render_s`` since the frame's start."""
        if spans is not None:
            _sync(self.device)
            spans["render_s"].append(time.perf_counter() - self._t0)

    @contextlib.contextmanager
    def device_span(self, spans: dict | None, name: str):
        """With ``spans`` on a CUDA device, CUDA events around the block,
        read once the window has closed as ``<name>_ms``."""
        if spans is None or self.device.type != "cuda":
            yield
            return
        ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ev[0].record()
        yield
        ev[1].record()
        spans[f"{name}_events"].append(ev)

    def frame(self, index: int, out: dict, spans: dict | None = None):
        """Render frame ``index`` and deliver it into host buffers ``out``;
        -> (eye, device depth or None, stats or None)."""
        eye = self.plan.orbit.eye_at(index)
        self.scene.camera.set_eye(eye)
        self._t0 = time.perf_counter()
        images, depth, stats = self.route.frame(self, spans)
        for name in self.names:
            out[name].copy_(images[name], non_blocking=True)
        _sync(self.device)
        return eye, depth, stats


def run(plan: scenes.Plan, traffic: dict, route, seconds: float, trace: bool, device,
        process_start: float) -> Window:
    """Set-up, then the window; the sampled frames and, with ``trace``,
    the spans and the profiled frames.  ``route`` is the traffic's route
    module; ``process_start`` is the ``time.perf_counter()`` reading
    taken as the process began."""
    from rasterbench import trace as tracing
    fl = FrameLoop(plan, traffic, route, device)
    dev = fl.device
    views = plan.orbit.views
    k = int(traffic["check_frames"])
    spare = fl.new_buffers()
    fresh = [fl.new_buffers() for _ in range(k)]      # host buffers allocated in set-up
    reservoir: list[Sample] = []
    warm = int(traffic["warmup_frames"])
    for i in range(warm):
        fl.frame(i * views // warm, spare)
    _sync(dev)
    rng = np.random.default_rng(plan.sample_seed)
    win = Window()
    spans = defaultdict(list) if trace else None
    start = time.perf_counter()
    win.setup_s = start - process_start
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 - start >= seconds:
            break
        filling = len(reservoir) < k
        slot = len(reservoir) if filling else int(rng.integers(i + 1))
        target = fresh.pop() if filling else spare
        eye, depth, stats = fl.frame(i, target, spans)
        win.latencies.append(time.perf_counter() - t0)
        if slot < k:
            sample = Sample(i, eye, target, None if depth is None else depth.clone(), stats)
            if filling:
                reservoir.append(sample)
            else:
                spare = reservoir[slot].images
                reservoir[slot] = sample
        i += 1
    _sync(dev)
    win.frames = i
    win.seconds = time.perf_counter() - start
    win.samples = sorted(reservoir, key=lambda s: s.frame)
    if dev.type == "cuda":
        win.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    if trace:
        win.spans = {(n[:-len("_events")] + "_ms" if n.endswith("_events") else n):
                     ([a.elapsed_time(b) for a, b in v] if n.endswith("_events") else v)
                     for n, v in spans.items()}
        win.trace = tracing.profile_frames(fl, i, int(traffic["trace_frames"]), spare)
    return win
