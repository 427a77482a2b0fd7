#!/usr/bin/env python3
"""An excerpt of a CPU + CUDA chrome trace (``cli --profile``'s
``<outdir>/trace/trace.json``): the program's spans of its last frame
(``tinyrenderder_tpu_torch.trace``, ``user_annotation`` events) and, on
the device, the ranges the profiler draws for them over the kernels they
launched (``gpu_user_annotation``), each with its first kernels.

    python3 scripts/trace_excerpt.py TRACE_JSON [--out FILE] [--kernels K]

Prints one JSON object (times in microseconds from the frame's start).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def excerpt(events: list, kernels_per_span: int = 3) -> dict:
    frames = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e.get("name") == "frame"), key=lambda e: e["ts"])
    if not frames:
        return {"frames": 0}
    f = frames[-1]
    t0, t1 = f["ts"], f["ts"] + f["dur"]
    host = [{"name": e["name"], "ts": round(e["ts"] - t0, 1), "dur": round(e["dur"], 1)}
            for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("cat") == "user_annotation" and t0 <= e["ts"] <= t1]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    device = []
    for e in sorted((e for e in events if e.get("cat") == "gpu_user_annotation"),
                    key=lambda e: e["ts"]):
        if e["ts"] < t0:
            continue
        inside = [k for k in kernels if e["ts"] <= k["ts"] <= e["ts"] + e["dur"]]
        device.append({"name": e["name"], "ts": round(e["ts"] - t0, 1),
                       "dur": round(e["dur"], 1), "kernels": len(inside),
                       "first": [k["name"][:80] for k in inside[:kernels_per_span]]})
    return {"frames": len(frames), "frame_us": round(f["dur"], 1), "host": host,
            "device": device}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 scripts/trace_excerpt.py")
    p.add_argument("trace")
    p.add_argument("--out", default=None)
    p.add_argument("--kernels", type=int, default=3)
    args = p.parse_args(argv)
    events = json.loads(Path(args.trace).read_text())["traceEvents"]
    text = json.dumps(excerpt(events, args.kernels), indent=1)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
