"""merge_shade_host_ms: host self time of the merge and the fragment
shading per frame, from the program's ``pass.merge_shade`` spans
(``post_sparse``, ``post_fine2``, ``shade_compact_fresh``) over the
profiled frames."""

from rasterbench import spans

UNIT = "ms"
LAYER = "merge + shade (post_sparse, post_fine2)"
MOVES = "frame_p95_ms"


def read(data):
    return spans.self_ms(data, ("pass.merge_shade",))
