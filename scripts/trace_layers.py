#!/usr/bin/env python3
"""The program's layers in a benchmark cell's profiled frames, and what
the program's tracing costs, on one GPU.

    python3 scripts/trace_layers.py --seed N [--workload CELL] [--seconds S]
        [--rounds R] [--out FILE] [--device cpu]

Runs the cell as ``python3 -m rasterbench.run --trace 1`` does (set-up,
the window, then its profiled frames under ``torch.profiler`` with CUDA
activity) and prints, from those frames, one JSON line:

  * ``layers``: for each span name of ``tinyrenderder_tpu_torch.trace``,
    per frame, its host self time, the device's idle and busy time within
    that self time and the kernels that start there
    (``trace.attribute``), with the alignment's offset, its residuals
    (each matched launch's device start less its aligned stamp) and the
    share of the window's device idle time that lies inside the
    program's spans;
  * ``counts``: the program's counters per profiled frame;
  * ``cost``: the same loop's frames under the profiler in ``--rounds``
    pairs of blocks, tracing on and with the trace module patched off (it
    sees no profiler), in turns, each block's median frame; and the host
    time of one span and one count, with tracing off and on (under a
    profiler of CUDA activity), times their number in a frame.

The card's name and power limit are printed beside the numbers.  The
result line is also written to ``--out`` when given.  ``--device cpu``
rehearses the script on the host at the benchmark's test sizes (no
device trace: no ``layers`` alignment).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def layer_table(trace, recs, device, window_s: float, busy_s: float) -> dict:
    """Per span name, per frame: self, idle, busy ms and kernels."""
    att = trace.attribute(device, recs)
    if att is None:
        return {"aligned": False}
    n = len(recs)
    rows: dict[str, dict] = {}
    for r in att["spans"]:
        # a readback is kept apart by the span that reads
        name = f"readback ({r['parent']})" if r["name"] == "readback" else r["name"]
        row = rows.setdefault(name, {"self_ms": 0.0, "idle_ms": 0.0, "busy_ms": 0.0,
                                     "kernels": 0.0})
        row["self_ms"] += r["self_ms"] / n
        row["idle_ms"] += r["idle_ms"] / n
        row["busy_ms"] += r["busy_ms"] / n
        row["kernels"] += len(r["kernels"]) / n
    res = sorted(att["residual_us"])
    idle_in = sum(r["idle_ms"] for r in att["spans"]) / n
    idle_frame = (window_s - busy_s) * 1e3 / n
    return {"aligned": True, "offset_us": att["offset_us"], "launches_matched": len(res),
            "residual_us": {"min": res[0], "median": statistics.median(res), "max": res[-1]},
            "idle_in_program_ms": idle_in, "idle_frame_ms": idle_frame,
            "idle_covered_pct": 100.0 * idle_in / idle_frame if idle_frame > 0 else None,
            "rows": dict(sorted(rows.items(), key=lambda kv: -kv[1]["self_ms"]))}


def frame_counts(recs) -> dict:
    total: dict[str, float] = {}
    for r in recs:
        for k, v in r.counts.items():
            total[k] = total.get(k, 0) + v / len(recs)
    return dict(sorted(total.items()))


def block(fl, first: int, frames: int, buffers) -> list[float]:
    """``frames`` frames of the loop under the profiler (CUDA activity, as
    the benchmark's trace): each frame's host seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = fl.device.type == "cuda"
    times = []
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]):
        for j in range(frames):
            if cuda:
                torch.cuda._sleep(1)
            t0 = time.perf_counter()
            fl.frame(first + j, buffers)
            times.append(time.perf_counter() - t0)
    return times


def cost(trace, fl, first: int, rounds: int, frames: int, recs) -> dict:
    """Tracing on against patched off, in turns; and the off path's host
    time per frame from a count of its calls."""
    buffers = fl.new_buffers()
    real = trace._profiler
    off = SimpleNamespace(_is_profiler_enabled=False)
    means = {"on": [], "off": []}
    for r in range(rounds):
        for mode in (("on", "off") if r % 2 == 0 else ("off", "on")):
            trace._profiler = real if mode == "on" else off
            try:
                t = block(fl, first, frames, buffers)       # the same frames, both modes
            finally:
                trace._profiler = real
            means[mode].append(statistics.median(t) * 1e3)
        first += frames
    diffs = [a - b for a, b in zip(means["on"], means["off"])]
    spans = statistics.fmean(len(r.spans) for r in recs) + 1      # the nested frame() too
    # one call a count, upload_bytes one a upload
    counts = statistics.fmean(sum(v for k, v in r.counts.items() if k != "upload_bytes")
                              + r.counts["upload"] for r in recs)
    out = {"block_median_ms": means, "on_minus_off_ms": diffs,
           "on_minus_off_mean_ms": statistics.fmean(diffs),
           "on_minus_off_median_ms": statistics.median(diffs),
           "spans_per_frame": spans, "counts_per_frame": counts}
    for mode in ("off", "on"):
        span_ns, count_ns = calls_ns(trace, fl.device.type == "cuda", mode == "on")
        out[f"{mode}_span_ns"], out[f"{mode}_count_ns"] = span_ns, count_ns
        out[f"{mode}_ms_per_frame"] = (spans * span_ns + counts * count_ns) / 1e6
    trace.clear()
    return out


def calls_ns(trace, cuda: bool, on: bool, n: int = 20_000) -> tuple[float, float]:
    """Host ns of one empty span and of one launch count, with tracing off
    or under a profiler (CUDA activity, as the benchmark's trace)."""
    import contextlib
    from torch.profiler import ProfilerActivity, profile
    act = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with profile(activities=act) if on else contextlib.nullcontext():
        with trace.frame():
            t0 = time.perf_counter()
            for _ in range(n):
                with trace.span("pass.pre"):
                    pass
            span_ns = (time.perf_counter() - t0) / n * 1e9
            t0 = time.perf_counter()
            for _ in range(n):
                trace.count("launch.cost_probe")
            count_ns = (time.perf_counter() - t0) / n * 1e9
    return span_ns, count_ns


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 scripts/trace_layers.py")
    p.add_argument("--workload", default="reference_main_1200x800.walk")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--rounds", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch
    from rasterbench import catalog, loop, scenes
    from tinyrenderder_tpu_torch import trace
    if args.device == "cuda" and not torch.cuda.is_available():
        print("trace_layers: needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    start = time.perf_counter()
    bench = catalog.Benchmark(ROOT)
    cell = bench.cell(args.workload)
    traffic = bench.traffic(cell["traffic"])
    plan = scenes.make_plan(bench.config(cell["config"]), traffic, args.seed)
    loops = []

    class Kept(loop.FrameLoop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            loops.append(self)

    loop.FrameLoop = Kept
    win = loop.run(plan, traffic, bench.route(traffic["route"]), args.seconds, True,
                   args.device, start)
    t = win.trace
    recs = trace.frames(t.frames)
    out = {"workload": args.workload, "seed": args.seed, "card": card(),
           "frames": win.frames, "frame_mean_ms": win.seconds / win.frames * 1e3,
           "profiled": t.frames, "attempts": t.attempts,
           "device_idle_pct": 100.0 * (1 - t.busy_s() / t.window_s) if t.device else None,
           "layers": layer_table(trace, recs, t.device, t.window_s, t.busy_s()),
           "counts": frame_counts(recs)}
    if args.rounds:
        out["cost"] = cost(trace, loops[0], t.first + t.frames * t.attempts, args.rounds,
                           t.frames, recs)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
