"""untile_host_ms: host self time of the untile per frame, from the
program's ``frame.untile`` spans (``tiles_to_buffers``,
``untile_image``) over the profiled frames."""

from rasterbench import spans

UNIT = "ms"
LAYER = "untile (csrc/untile.cu)"
MOVES = "frame_p95_ms"


def read(data):
    return spans.self_ms(data, ("frame.untile",))
