"""shadow_light_ms: host time of the shadow map's light pass per frame,
from the program's ``shadow.light`` spans (the light camera, the depth
scene, the depth-only pass and its untile, with their children) over
the profiled frames."""

from rasterbench import spans

UNIT = "ms"
LAYER = "shadow light pass (shadows.py)"
MOVES = "frame_p95_ms"


def read(data):
    got = spans.profiled(data)
    if got is None:
        return None
    _, recs = got
    light = [s.ns for r in recs for s in r.spans if s.name == "shadow.light"]
    return sum(light) / len(recs) / 1e6 if light else None
