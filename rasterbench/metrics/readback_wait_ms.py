"""readback_wait_ms: host time inside blocking CUDA runtime calls, per
frame: every ``cudaMemcpy*`` (a device-to-host copy, such as the
pre-stage's one readback a pass, waits for the device; a pinned
non-blocking copy returns at once) and every ``cuda*Synchronize``, over
the profiled frames."""

UNIT = "ms"
LAYER = "pre-stage (ops/raster_sparse.py)"
MOVES = "frame_p95_ms"


def read(data):
    t = data.window.trace
    if t is None or not t.runtime:
        return None
    us = sum(d for name, d in t.runtime
             if name.startswith("cudaMemcpy") or name.endswith("Synchronize"))
    return us / t.frames / 1e3
