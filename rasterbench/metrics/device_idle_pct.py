"""device_idle_pct: the share of the profiled frames' host window in which
no kernel, copy or fill ran on the device."""

UNIT = "%"
LAYER = "device (H100)"
MOVES = "frame_p95_ms"


def read(data):
    t = data.window.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
