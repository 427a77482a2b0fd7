"""shadow_cache_misses_per_frame: the misses of the shadow map's four
caches (``cache.shadow_cam``, ``cache.shadow_merged``,
``cache.shadow_depth``, ``cache.shadow_lit``) over the profiled frames,
per frame.  A light that turns every frame misses the light camera, the
depth scene and the lit scene, 3; the merged mesh hits."""

from rasterbench import spans

UNIT = "count"
LAYER = "shadow light pass (shadows.py)"
MOVES = "frame_p95_ms"
COUNTERS = ("cache.shadow_cam.miss", "cache.shadow_merged.miss", "cache.shadow_depth.miss",
            "cache.shadow_lit.miss")


def read(data):
    got = spans.profiled(data)
    if got is None:
        return None
    _, recs = got
    if not any(s.name == "shadow.light" for r in recs for s in r.spans):
        return None
    return sum(r.counts[c] for r in recs for c in COUNTERS) / len(recs)
