"""stats_host_ms: host time of the exact stats per frame, from the
program's ``pass.stats`` (``reduce_events``) and ``frame.stats``
(``_add_events``, ``raster.pass_stats``) spans over the profiled
frames: their self time with their ``readback`` children counted in."""

from rasterbench import spans

UNIT = "ms"
LAYER = "stats (reduce_events, pass_stats)"
MOVES = "frame_p95_ms"


def read(data):
    return spans.self_ms(data, ("pass.stats", "frame.stats"), include=("readback",))
