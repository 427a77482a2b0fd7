"""pre_host_ms: host self time of the pre-stage per frame, from the
program's ``pass.pre`` spans (``pre_sparse``, ``pre_fine``,
``pre_fine2``, ``probe_rows``) over the profiled frames: each span's
duration less its children's, so its ``readback`` waits are left out."""

from rasterbench import spans

UNIT = "ms"
LAYER = "pre-stage (ops/raster_sparse.py)"
MOVES = "frame_p95_ms"


def read(data):
    return spans.self_ms(data, ("pass.pre",))
