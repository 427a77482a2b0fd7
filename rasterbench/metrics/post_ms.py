"""post_ms: device time of ``ops.post.postprocess`` (z-image, 64-tap SSAO,
composite), from CUDA events the harness records around the call, mean
per frame over the traced run's window."""

import statistics

UNIT = "ms"
LAYER = "post (ops/post.py)"
MOVES = "frame_p95_ms"


def read(data):
    spans = data.window.spans.get("post_ms")
    return statistics.fmean(spans) if spans else None
