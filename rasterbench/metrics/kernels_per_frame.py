"""kernels_per_frame: the profiler's device kernels (copies and fills
left out) over the profiled frames, per frame."""

UNIT = "kernels/frame"
LAYER = "device (H100)"
MOVES = "frame_p95_ms"


def read(data):
    t = data.window.trace
    if t is None or not t.kernels or not any(t.kernels):
        return None
    return sum(t.kernels) / len(t.kernels)
