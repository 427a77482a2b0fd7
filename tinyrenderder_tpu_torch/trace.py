"""Spans and counters of the port's frames: one registry for the package.

**Spans.**  ``span(name, arg=None)`` is a context manager around one
layer of a frame, at the boundary where the layer's work happens:

  ==================  ===================================================  ===============
  span                where                                                parent
  ==================  ===================================================  ===============
  ``frame``           ``scene.render_scene``, ``render_scene_image``,      none
                      ``render_passes``, ``render_passes_xla``,
                      ``shadows.render_with_shadows`` (both passes)
  ``shadow.light``    ``shadows.render_with_shadows``: the light camera,   ``frame``
                      the depth scene, the light pass, its untile
  ``shadow.lit``      ``shadows.render_with_shadows``: ``shadowed_scene``  ``frame``
  ``frame.cull``      ``scene._cull_passes``                               ``frame``
  ``frame.inputs``    ``scene._device_pass_inputs``                        ``frame``
  ``pass``            each pass of ``raster_sparse.walk_passes``: the      ``frame``
                      tiled, scan and geometry frames (its name the arg)
  ``pass.pre``        ``pre_sparse``, ``pre_fine``, ``pre_fine2``, the     ``pass``
                      scan pass's vertex stage
  ``pass.raster``     the hand-written raster or resolve call              ``pass``
  ``pass.merge_shade``  ``post_sparse``, ``post_fine2``,                   ``pass``
                      ``shade_compact_fresh``, the scan pass's shading
  ``pass.stats``      ``raster_sparse.reduce_events``                      ``pass``
  ``frame.untile``    ``tiles_to_buffers``, ``untile_image``               ``frame``
  ``frame.stats``     ``scene._add_events`` (``raster.pass_stats``)        ``frame``
  ``readback``        every blocking read of device values (``readback``)  the reading span
  ``post``            ``ops.post.postprocess``                             none
  ``animation.frame``, ``animation.write``  ``render_animation``           none
  ==================  ===================================================  ===============

On the image route (one pass straight to an image) ``pass.pre``,
``pass.raster`` and ``pass.merge_shade`` lie directly under ``frame``.
In a shadowed frame the light pass's ``frame.cull``, ``frame.inputs``,
``pass`` and ``readback`` spans lie under ``shadow.light``, the lit
pass's under ``frame``.

A span records its name, argument, start and end on
``time.perf_counter_ns()``, its parent (the span open around it) and a
frame id.  ``frame(name)`` opens a new frame id unless a frame is open
already: then it is an ordinary span, or nothing where a span of the
same name is open (``render_passes`` inside ``render_scene``).  Spans
opened outside any frame (the post, the animation's write) take the id
of the frame they follow.  The last ``FRAMES`` frames are kept in
memory (``frames``).  A layer's self time is its duration less its
children's (``self_ns``).

Tracing is on exactly while a ``torch.profiler`` session is active.
Off, ``span`` and ``frame`` return one shared null context after a
single check, and record nothing.  On, each span also enters
``torch.profiler.record_function(name)``, so in any CPU + CUDA trace
(``cli --profile``) the layers lie on the profiler's clock over the
kernels they launched; under a profiler of CUDA activity that range is
most of a span's host cost (14-36 us on the H100's host).  Spans are kept for the calling thread's frames:
the package renders from one thread.

**Counters** (``count``, ``counts``, ``reset_counts``) are always on,
one integer add each: ``launch.<entry point>`` (``LAUNCH_KERNELS``),
``readback``, ``upload`` and ``upload_bytes`` (``convert.to_torch`` onto
a card), ``pre.kernel`` / ``pre.plain`` (each ``raster_sparse.pre_sparse``
pass, by the pre-stage it took), ``shade.kernel`` / ``shade.plain`` (each
``raster_sparse.post_sparse`` and ``shade_compact_fresh`` call, by the
merge + shade it took) and ``cache.<name>.hit`` / ``.miss`` (``cull``, ``pass_inputs``,
``uniforms``; ``shadows.py``'s ``shadow_cam``, ``shadow_merged``,
``shadow_depth``, ``shadow_lit``).  While tracing is on, a count is also added to
its frame's record, and a launch stamps its host time and the span it
was made in: ``attribute`` uses the stamps to put the spans on a device
trace's clock.
"""

from __future__ import annotations

import bisect
import time
from collections import Counter, defaultdict, deque

from torch.autograd import profiler as _profiler

__all__ = ["FRAMES", "LAUNCH_KERNELS", "Span", "FrameRecord", "span", "frame", "readback",
           "count", "counts", "reset_counts", "frames", "clear", "self_ns", "attribute"]

#: frames whose spans are kept, newest last
FRAMES = 64

#: every launch counter (one user call of a kernel entry point) -> a kernel
#: that each such call launches exactly once, the anchor ``attribute``
#: matches its stamps with
LAUNCH_KERNELS = {
    "launch.coarse_raster": "coarse_walk_kernel",
    "launch.coarse_raster_stats": "coarse_walk_kernel",
    "launch.dense_raster": "coarse_walk_kernel",
    "launch.fine_raster": "strip_walk_kernel",
    "launch.fine_raster_stats": "strip_walk_kernel",
    "launch.fine2_raster": "strip_walk_kernel",
    "launch.fine2_raster_stats": "strip_walk_kernel",
    "launch.untile_one": "untile32_kernel",
    "launch.untile_image": "untile32_kernel",
    "launch.untile3": "untile3_kernel",
    "launch.untile3_image": "untile3_kernel",
    "launch.strip_raster_proto": "proto_walk_kernel",
    "launch.rank_pairs": "rank_hist_kernel",
    "launch.inplace_blocks": "inplace_blocks_kernel",
    "launch.scan_resolve": "scan_prefix_kernel",
    "launch.scan_resolve_stats": "scan_prefix_kernel",
    "launch.post": "post_ssao_kernel",
    "launch.pre_front": "pre_front_kernel",
    "launch.pre_offsets": "pre_offsets_kernel",
    "launch.pre_place": "pre_place_kernel",
    "launch.merge_shade": "merge_shade_kernel",
    "launch.shade_fresh": "shade_fresh_kernel",
}

#: device intervals that are copies or fills, not kernels
_NOT_KERNELS = ("Memcpy", "Memset")


class FrameRecord:
    """One frame's spans (in opening order), the counts made while it was
    the current frame and its launch stamps (name, host ns, span)."""

    __slots__ = ("id", "spans", "counts", "stamps")

    def __init__(self, frame_id: int):
        self.id = frame_id
        self.spans: list[Span] = []
        self.counts: Counter = Counter()
        self.stamps: list[tuple] = []


class Span:
    """One recorded span; a context manager while open."""

    __slots__ = ("name", "arg", "start", "end", "parent", "frame", "opens", "_rf")

    def __init__(self, name: str, arg=None, opens: bool = False):
        self.name, self.arg, self.opens = name, arg, opens
        self.start = self.end = 0
        self.parent = None
        self.frame = -1
        self._rf = None

    def __enter__(self):
        label = self.name if self.arg is None else f"{self.name} {self.arg}"
        self._rf = _profiler.record_function(label)
        self._rf.__enter__()
        rec = _new_frame() if self.opens else _current()
        self.parent = _STACK[-1] if _STACK else None
        self.frame = rec.id
        rec.spans.append(self)
        _STACK.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        if _STACK and _STACK[-1] is self:
            _STACK.pop()
        rf, self._rf = self._rf, None
        rf.__exit__(*exc)
        return False

    @property
    def ns(self) -> int:
        return self.end - self.start


class _Null:
    """The context ``span`` returns while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()
_COUNTS: defaultdict = defaultdict(int)
_RING: deque = deque(maxlen=FRAMES)
_STACK: list[Span] = []
_STATE = {"current": None, "next_id": 0}


def _new_frame() -> FrameRecord:
    rec = FrameRecord(_STATE["next_id"])
    _STATE["next_id"] += 1
    _STATE["current"] = rec
    _RING.append(rec)
    return rec


def _current() -> FrameRecord:
    rec = _STATE["current"]
    return _new_frame() if rec is None else rec


def span(name: str, arg=None):
    """A span ``name`` (with ``arg``, such as a pass's name) around the
    block while tracing is on; the shared null context while it is off."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return Span(name, arg)


def frame(name: str = "frame"):
    """A span that opens a new frame id, unless a frame is open: then an
    ordinary span ``name``, or nothing where a span ``name`` is open."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    if any(s.name == name for s in _STACK):
        return _NULL
    return Span(name, opens=not any(s.opens for s in _STACK))


def readback(x) -> list:
    """``x.tolist()``: a blocking read of device values, counted as
    ``readback`` and, while tracing is on, a span of its own."""
    with span("readback"):
        count("readback")
        return x.tolist()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``; while tracing is on, also to the
    current frame's record, and a ``launch.*`` count stamps its host time
    and the open span (call it just before the launch)."""
    _COUNTS[name] += n
    if _profiler._is_profiler_enabled:
        _record_count(name, n)


def _record_count(name: str, n: int) -> None:
    rec = _current()
    rec.counts[name] += n
    if name.startswith("launch."):
        rec.stamps.append((name, time.perf_counter_ns(), _STACK[-1] if _STACK else None))


def counts() -> Counter:
    """A copy of every counter (0 for a name never counted)."""
    return Counter(_COUNTS)


def reset_counts() -> None:
    """Set every counter to 0."""
    _COUNTS.clear()


def frames(n: int | None = None) -> list[FrameRecord]:
    """The last ``n`` frames recorded (every kept one with None), oldest
    first; fewer where fewer were recorded."""
    recs = list(_RING)
    return recs if n is None else recs[max(0, len(recs) - n):]


def clear() -> None:
    """Forget every recorded frame (the counters stay)."""
    _RING.clear()
    _STACK.clear()
    _STATE["current"] = None


def _children(rec: FrameRecord) -> dict:
    kids: dict[int, list[Span]] = {}
    for s in rec.spans:
        if s.parent is not None:
            kids.setdefault(id(s.parent), []).append(s)
    return kids


def self_ns(recs, name: str, include: tuple = ()) -> int | None:
    """The summed self time, ns, of every span ``name`` in frame records
    ``recs``: each span's duration less its children's, children named in
    ``include`` counted in.  None where no such span was recorded."""
    total, seen = 0, False
    for rec in recs:
        kids = _children(rec)
        for s in rec.spans:
            if s.name == name:
                seen = True
                total += s.ns - sum(c.ns for c in kids.get(id(s), ()) if c.name not in include)
    return total if seen else None


class _Timeline:
    """Device intervals on their own clock: the union of busy time, and
    the starts, for queries over host intervals moved by ``offset``."""

    def __init__(self, device):
        items = sorted((float(s), float(e), name) for name, s, e in device)
        self.starts = [s for s, _, _ in items]
        self.names = [n for _, _, n in items]
        merged: list[list[float]] = []
        for s, e, _ in items:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.lo = [m[0] for m in merged]
        self.hi = [m[1] for m in merged]
        self.acc = [0.0]
        for s, e in merged:
            self.acc.append(self.acc[-1] + e - s)

    def _busy_to(self, t: float) -> float:
        i = bisect.bisect_right(self.lo, t)
        if i == 0:
            return 0.0
        return self.acc[i - 1] + min(t, self.hi[i - 1]) - self.lo[i - 1]

    def busy(self, a: float, b: float) -> float:
        return self._busy_to(b) - self._busy_to(a) if b > a else 0.0

    def started(self, a: float, b: float) -> list[str]:
        return self.names[bisect.bisect_left(self.starts, a):bisect.bisect_left(self.starts, b)]


def _offset(device, recs, kernels: dict):
    """(offset, residuals), us: the least (device start - host stamp) over
    the stamped launches, the k-th stamp of an anchor kernel matched with
    its k-th device interval, and each launch's start less its aligned
    stamp.  Kernels whose stamps and intervals differ in number are
    left out; None where none is left."""
    stamps: dict[str, list[float]] = {}
    for rec in recs:
        for name, ns, _ in rec.stamps:
            key = kernels.get(name)
            if key is not None:
                stamps.setdefault(key, []).append(ns / 1e3)
    pairs = []
    for key, hs in stamps.items():
        ds = sorted(float(s) for name, s, _ in device if key in name)
        if len(ds) == len(hs):
            pairs += zip(sorted(hs), ds)
    if not pairs:
        return None
    offset = min(d - h for h, d in pairs)
    return offset, [d - h - offset for h, d in pairs]


def attribute(device, recs, kernels: dict | None = None) -> dict | None:
    """The spans of frame records ``recs`` against device intervals
    ``device`` ((name, start_us, end_us) on any profiler's clock, the
    device work of those frames): the spans are moved onto the device
    clock by the launch stamps (``_offset``), and each span's own time
    (its interval less its children's) gets four numbers, in
    milliseconds: its host self time, the device's idle and busy time
    within it, and the device intervals that start within it (a kernel
    is put where its aligned start falls, an approximation: it ran
    where the device reached it).  The rows of a frame partition its
    top-level spans.  -> {"offset_us", "residual_us" (each matched
    launch's device start less its aligned stamp, >= 0), "spans": [{name,
    arg, frame, parent (its name), self_ms, idle_ms, busy_ms, kernels}]},
    or None where no launch could be matched."""
    found = _offset(device, recs, LAUNCH_KERNELS if kernels is None else kernels)
    if found is None:
        return None
    offset, residuals = found
    line = _Timeline(device)
    rows = []
    for rec in recs:
        kids = _children(rec)
        for s in rec.spans:
            a = s.start / 1e3 + offset
            pieces, at = [], a
            for c in sorted(kids.get(id(s), ()), key=lambda c: c.start):
                c0 = c.start / 1e3 + offset
                if c0 > at:
                    pieces.append((at, c0))
                at = max(at, c.end / 1e3 + offset)
            end = s.end / 1e3 + offset
            if end > at:
                pieces.append((at, end))
            own = sum(b - a_ for a_, b in pieces)
            busy = sum(line.busy(a_, b) for a_, b in pieces)
            rows.append({"name": s.name, "arg": s.arg, "frame": rec.id,
                         "parent": None if s.parent is None else s.parent.name,
                         "self_ms": own / 1e3,
                         "idle_ms": (own - busy) / 1e3, "busy_ms": busy / 1e3,
                         "kernels": [k for a_, b in pieces for k in line.started(a_, b)
                                     if not k.startswith(_NOT_KERNELS)]})
    return {"offset_us": offset, "residual_us": residuals, "spans": rows}
