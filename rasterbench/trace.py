"""The device trace of a few frames of the window, as the metrics read it.

``profile_frames`` runs ``frames`` frames of the loop, exactly as the
untraced window runs them, under ``torch.profiler`` (CUDA activity: the
device's kernels, copies and fills, and the host's CUDA runtime calls).
Before each frame it launches one marker kernel (``torch.cuda._sleep``,
named ``spin_kernel``): the stream is in order, so the markers cut the
device timeline into frames.  The card's profiler has been seen to drop
events; a trace in which a frame has no kernel, or fewer than half the
median frame's, or a marker is missing, is taken again on the next
frames, up to ``TRIES`` times.

``Trace`` keeps plain numbers only (names, microseconds), so nothing of
the program outlives the window through it.
"""

from __future__ import annotations

import statistics
import sys
import time
from dataclasses import dataclass, field

import torch

TRIES = 5
MARKER = "spin_kernel"
#: device events that are not kernels
NOT_KERNELS = ("Memcpy", "Memset")


@dataclass
class Trace:
    frames: int                      # frames profiled (those of the kept attempt)
    first: int                       # frame index of the first of them
    window_s: float                  # host seconds, first frame start to last delivery
    device: list = field(default_factory=list)     # (name, start_us, end_us), markers left out
    kernels: list = field(default_factory=list)    # kernels per frame
    runtime: list = field(default_factory=list)    # (name, host us) of CUDA runtime calls
    attempts: int = 1
    consistent: bool = True

    def busy_s(self) -> float:
        """Seconds in which a kernel, copy or fill ran: the union of the
        device intervals."""
        total, end = 0.0, -1.0
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if s > end:
                total += e - s
                end = e
            elif e > end:
                total += e - end
                end = e
        return total / 1e6

    def breakdown(self) -> dict:
        """The device operations that took most time, and the idle gaps
        between device intervals grouped by the operation that ended
        them (the host was preparing it): at most 10 of each, seconds."""
        ops: dict[str, float] = {}
        for name, s, e in self.device:
            ops[short(name)] = ops.get(short(name), 0.0) + (e - s) / 1e6
        gaps: dict[str, float] = {}
        end = None
        for name, s, e in sorted(self.device, key=lambda d: d[1]):
            if end is not None and s > end:
                key = f"before {short(name)}"
                gaps[key] = gaps.get(key, 0.0) + (s - end) / 1e6
            end = e if end is None else max(end, e)
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
        return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def short(name: str) -> str:
    """A kernel's name without its return type, namespaces, template
    arguments and arguments."""
    base = name.replace("(anonymous namespace)::", "").split("(")[0].strip()
    if base.startswith("void "):
        base = base[5:]
    return base.split("<")[0].rsplit("::", 1)[-1][:96] or name[:96]


def _parse(prof, frames: int) -> tuple[list, list, list, bool]:
    from torch.autograd import DeviceType
    events = prof.events()
    dev = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    runtime = [(e.name, e.time_range.elapsed_us()) for e in events
               if e.device_type == DeviceType.CPU and e.name.startswith("cuda")]
    device, counts = [], []
    for e in dev:
        if MARKER in e.name:
            counts.append(0)
            continue
        device.append((e.name, float(e.time_range.start), float(e.time_range.end)))
        if counts and not e.name.startswith(NOT_KERNELS):
            counts[-1] += 1
    med = statistics.median(counts) if counts else 0
    consistent = (len(counts) == frames and med > 0
                  and all(c > 0 and c >= 0.5 * med for c in counts))
    return device, counts, runtime, consistent


def profile_frames(loop, first: int, frames: int, buffers: dict) -> Trace:
    """Frames ``first`` on of ``loop`` (a ``loop.FrameLoop``) under the
    profiler; see the module."""
    import warnings
    from torch.profiler import ProfilerActivity, profile
    warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
    cuda = loop.device.type == "cuda"
    activities = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    trace = None
    for attempt in range(TRIES):
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            for j in range(frames):
                if cuda:
                    torch.cuda._sleep(1)
                loop.frame(first + j, buffers)
            window = time.perf_counter() - t0
        device, counts, runtime, consistent = _parse(prof, frames)
        trace = Trace(frames=frames, first=first, window_s=window, device=device,
                      kernels=counts, runtime=runtime, attempts=attempt + 1,
                      consistent=consistent or not cuda)
        if trace.consistent:
            return trace
        print(f"rasterbench: trace {attempt + 1} of {TRIES} dropped events "
              f"(kernels per frame {counts}); traced again", file=sys.stderr, flush=True)
        first += frames
    return trace
