"""render_ms: host time from the ``Scene.render`` / ``render_image`` call
to its colour being ready (a synchronize after the call), mean per frame
over the traced run's window."""

import statistics

UNIT = "ms"
LAYER = "host layer and frame loop (scene.py)"
MOVES = "frame_p95_ms"


def read(data):
    spans = data.window.spans.get("render_s")
    return statistics.fmean(spans) * 1e3 if spans else None
