"""frame_p95_ms: the 95th percentile, over every frame of the window, of
the time from the frame's start (its camera set) to its delivery."""

import numpy as np

UNIT = "ms"
LAYER = None
MOVES = "frame_p95_ms"


def read(data):
    lat = data.window.latencies
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
