#!/usr/bin/env python3
"""Where the prototype strip raster's time goes on one GPU (kernel #7,
``tinyrenderder_tpu_torch/csrc/fine_raster.cu``).

    python3 scripts/torch_proto_probe.py

On the 2048² headline head's 8x128 groups: the rows histogram of the
longest groups, then the CUDA-event median and the profiler's device time
per kernel of the wrapper as ``strip_rasterize`` calls it, of the same
call with every slot emptied (the walk's loop and staging without the
arithmetic) and with every group's rows set to 0 (the dense planes
alone), of the walk alone over every group (one block a group), and of
three clones of the init plane (the copy the dense planes cost).  Last,
the walk kernel's SASS opcode counts from ``cuobjdump`` (divisions show
as MUFU.RCP, FCHK and a CALL to the slow path each).  Each line is one
JSON object with the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def sass_counts(lib: Path, kernel: str, ops=("MUFU.RCP", "FCHK", "CALL", "BSSY")) -> dict:
    """Counts of ``ops`` in the SASS of the functions whose name holds ``kernel``."""
    from tinyrenderder_tpu_torch import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          timeout=300).stdout
    counts, keep = Counter(), False
    for ln in sass.splitlines():
        if "Function :" in ln:
            keep = kernel in ln
        elif keep:
            counts.update(op for op in ops if op in ln)
    return dict(counts)


def main() -> None:
    import torch

    import chip_smoke as cs
    from tinyrenderder_tpu_torch import _build
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.experimental import fine_raster as xfr
    from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_W, to_tiles, vertex_stage

    smi = cs.nvidia_smi()
    dev, w = "cuda", cs.WIDTH
    lib = _build.build()
    _build.library()
    attrs, shader, uniforms, _ = tscene.pass_tensors(tscene.headline_scene(w, w, "phong"),
                                                     dev)[0]
    setup = vertex_stage(attrs, uniforms, shader, w, w)[0]
    recs, rows, ntx, nty, total = xfr.build_strip_records(setup, w, w)
    init = to_tiles(torch.full((w, w), torch.inf, device=dev), nty, ntx, xfr.TILE_H, TILE_W,
                    torch.inf)
    g = recs.shape[0]
    hist = torch.bincount(rows.long()).tolist()
    print(json.dumps({"groups": g, "rows": total, "range_rows": xfr.range_rows(),
                      "groups by rows (> 30)": {r: n for r, n in enumerate(hist) if n and r > 30},
                      "card": smi}), flush=True)
    empty = recs.clone()
    empty.view(g, -1, xfr.STRIPS, xfr.STRIP_W)[..., xfr.NFIELD - 1] = -1.0
    no_rows = torch.zeros_like(rows)

    def walk_alone(r):
        d, wn = torch.empty_like(init), torch.empty_like(init, dtype=torch.int32)
        _build.call("trt_strip_proto", recs.device, r.data_ptr(), rows.data_ptr(), g,
                    r.shape[1], init.data_ptr(), d.data_ptr(), wn.data_ptr(), ntx, g, None)
        return d, wn

    runs = {"split": lambda: xfr.strip_raster(recs, rows, init, ntx, row_total=total),
            "split, every slot empty": lambda: xfr.strip_raster(empty, rows, init, ntx,
                                                                row_total=total),
            "split, no rows (the dense planes)": lambda: xfr.strip_raster(recs, no_rows, init,
                                                                          ntx, row_total=0),
            "the walk alone": lambda: walk_alone(recs),
            "the walk alone, every slot empty": lambda: walk_alone(empty),
            "3 clones of the init plane": lambda: [init.clone() for _ in range(3)]}
    names = ("item_scan", "proto_walk", "proto_merge", "emcpy")
    for name, fn in runs.items():
        print(json.dumps({"run": name, "ms": cs.event_ms(fn),
                          "device_ms": cs.device_ms(fn, names), "card": smi}), flush=True)
    print(json.dumps({"sass proto_walk_kernel": sass_counts(lib, "proto_walk_kernel"),
                      "card": smi}), flush=True)


if __name__ == "__main__":
    main()
