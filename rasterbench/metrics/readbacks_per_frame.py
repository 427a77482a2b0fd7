"""readbacks_per_frame: the program's ``readback`` counter (each
blocking read of device values: a pre-stage's totals, a pass's
``pass_stats`` and event sums) over the profiled frames, per frame."""

from rasterbench import spans

UNIT = "count"
LAYER = "pre-stage (ops/raster_sparse.py)"
MOVES = "frame_p95_ms"


def read(data):
    return spans.per_frame(data, "readback")
