"""uploads_per_frame: the program's ``upload`` counter (each host array
copied onto the card by ``convert.to_torch``: the uniforms a pass
rebuilds when its ModelView changes) over the profiled frames, per
frame."""

from rasterbench import spans

UNIT = "count"
LAYER = "host layer and frame loop (scene.py)"
MOVES = "frame_p95_ms"


def read(data):
    return spans.per_frame(data, "upload")
