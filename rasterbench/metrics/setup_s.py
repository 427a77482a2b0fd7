"""setup_s: from the process's start to the window's: import, the kernel
library's load (or build), the scene's generation, its upload and the
warm-up frames."""

UNIT = "s"
LAYER = None
MOVES = "setup_s"


def read(data):
    return data.window.setup_s
