"""The program's own spans and counters of the profiled frames, as the
per-layer metrics read them.

The program (``tinyrenderder_tpu_torch.trace``) records spans while a
``torch.profiler`` session is active, that is for the frames
``trace.profile_frames`` profiles, and keeps the last few in memory.
The frames of the kept attempt are the last ``Trace.frames`` it
recorded.  A program without that module, or without those frames,
gives nothing to read: ``profiled`` returns None and so does each
reader, without raising.
"""

from __future__ import annotations


def profiled(data):
    """(the program's ``trace`` module, the frame records of the profiled
    frames, oldest first), or None."""
    t = data.window.trace
    if t is None or t.frames <= 0:
        return None
    try:
        from tinyrenderder_tpu_torch import trace
    except ImportError:
        return None
    recs = trace.frames(t.frames)
    if len(recs) < t.frames or not all(r.spans for r in recs):
        return None
    return trace, recs


def self_ms(data, names: tuple, include: tuple = ()) -> float | None:
    """The summed self time of spans ``names`` per profiled frame, ms
    (children named in ``include`` counted in); None without such spans."""
    got = profiled(data)
    if got is None:
        return None
    trace, recs = got
    found = [trace.self_ns(recs, n, include) for n in names]
    if all(v is None for v in found):
        return None
    return sum(v for v in found if v is not None) / len(recs) / 1e6


def per_frame(data, counter: str) -> float | None:
    """Counter ``counter`` over the profiled frames, per frame."""
    got = profiled(data)
    if got is None:
        return None
    _, recs = got
    return sum(r.counts[counter] for r in recs) / len(recs)
