"""idle_in_program_ms: device idle time per frame inside the program's
spans (the frame and the post), over the profiled frames: the idle that
the program's own host code causes, as opposed to the caller's.  The
spans are put on the device trace's clock by the program's launch stamps
(``trace.attribute``: the least device start less host stamp over the
launches it can match)."""

from rasterbench import spans

UNIT = "ms"
LAYER = "device (H100)"
MOVES = "frame_p95_ms"


def read(data):
    got = spans.profiled(data)
    if got is None or not data.window.trace.device:
        return None
    trace, recs = got
    att = trace.attribute(data.window.trace.device, recs)
    if att is None:
        return None
    return sum(r["idle_ms"] for r in att["spans"]) / len(recs)
