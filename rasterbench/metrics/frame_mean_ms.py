"""frame_mean_ms: the window's length over the frames delivered in it,
read in the traced run.  The mean frame swings with the host's speed
more than a bound allows (PERF.md), so it stands per layer beside
``frame_p95_ms``; its spans add a synchronize a frame in that run."""

UNIT = "ms"
LAYER = "whole frame (routes/, Scene.render to delivery)"
MOVES = "frame_p95_ms"


def read(data):
    w = data.window
    return w.seconds / w.frames * 1e3 if w.frames else None
