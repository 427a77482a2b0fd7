"""shadow_light_roofline_pct: the light pass's raster bound over the
device time of its raster kernels.

The bound is ``raster_roofline_pct.pass_bound_s`` of the ``light`` work
entry that the configuration's reference module counts for each profiled
frame (valid triangles, pixel centres tested, pixels won, no varyings),
at the same peaks.  The kernels are ``raster_roofline_pct.KERNELS`` that
start inside the program's ``shadow.light`` spans, their descendants
included, on the device trace's clock (the launch stamps' alignment,
``trace.attribute``).  Each span is widened to the end of the first
``readback`` after it (the lit pass's pre-stage): the device runs behind
the host, so a kernel the light pass launched may start after its span
has closed, and that readback waits for it, while the lit pass launches
its raster only after it.  None where the program has no such span."""

from rasterbench import spans
from rasterbench.metrics import raster_roofline_pct as raster

UNIT = "%"
LAYER = "raster kernels (csrc/raster_*.cu), light pass"
MOVES = "frame_p95_ms"


def windows(recs, offset_us: float) -> list:
    """The (start, end) of each ``shadow.light`` span of frame records
    ``recs``, us on the device clock, each ended by the first readback
    after it."""
    out = []
    for rec in recs:
        for s in rec.spans:
            if s.name == "shadow.light":
                after = next((r for r in rec.spans if r.name == "readback" and r.start >= s.end),
                             s)
                out.append((s.start / 1e3 + offset_us, after.end / 1e3 + offset_us))
    return out


def read(data):
    t = data.window.trace
    got = spans.profiled(data)
    if got is None or data.work is None or not t.device:
        return None
    trace, recs = got
    att = trace.attribute(t.device, recs)
    if att is None:
        return None
    light = windows(recs, att["offset_us"])
    kernel_us = sum(e - s for name, s, e in t.device
                    if any(k in name for k in raster.KERNELS)
                    and any(a <= s < b for a, b in light))
    bound = sum(raster.pass_bound_s(p) for frame in data.work for p in frame
                if p["pass"] == "light")
    if kernel_us <= 0 or bound <= 0:
        return None
    return 100.0 * bound / (kernel_us / 1e6)
