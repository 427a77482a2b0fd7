"""The benchmark of ``tinyrenderder_tpu_torch`` on NVIDIA GPUs.

    python -m rasterbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It builds the cell's scene from the seed
(``scenes``), hands it to the program, renders the cell's traffic for
``--seconds`` (``loop``), compares frames sampled from the window with
the configuration's plain reference (``check``) and prints one JSON
line: with ``--trace 0`` the cell's end-to-end metrics, with ``--trace
1`` its per-layer ones and the device's busy and traced seconds.  Each metric is
read by its own module under ``metrics/``.  It exits non-zero, with no
result line, when the cell's CUDA devices are missing, and when a
module of JAX or of the JAX package is loaded once the window has
closed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


#: ``time.perf_counter()`` at the process's start
PROCESS_START = time.perf_counter() - _process_age()
ROOT = Path(__file__).resolve().parent.parent
#: modules whose top-level name, compared whole, may not be loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "tinyrenderder_tpu")


@dataclass
class RunData:
    """What the metric readers read."""

    window: object                   # loop.Window
    work: list | None = None         # per profiled frame, per pass: the counted raster work


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is in ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _card(device) -> dict:
    import torch
    info = {"platform": "cpu", "kind": "cpu", "power_limit": "none"}
    if torch.device(device).type == "cuda":
        info["platform"] = "gpu"
        info["kind"] = torch.cuda.get_device_name(0)
        try:
            out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True, text=True,
                                 timeout=20)
            info["power_limit"] = out.stdout.strip().splitlines()[0].split(",")[-1].strip()
        except (OSError, subprocess.SubprocessError, IndexError):
            info["power_limit"] = "unknown"
    return info


def _quarters(values: list) -> list:
    n = len(values)
    return [values[i * n // 4:(i + 1) * n // 4] for i in range(4) if (i + 1) * n // 4 > i * n // 4]


def execute(root: Path, workload: str, seed: int, seconds: float, trace: bool,
            device: str) -> int:
    """One run of ``workload`` on ``device``; prints the result line and
    returns the exit code."""
    import torch
    from rasterbench import catalog, check, loop, scenes

    torch.set_num_threads(1)
    bench = catalog.Benchmark(root)
    cell = bench.cell(workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    reference = bench.reference(config.get("reference"))
    plan = scenes.make_plan(config, traffic, seed)
    print(f"rasterbench: {workload} seed {seed}, {plan.faces} faces", file=sys.stderr,
          flush=True)
    win = loop.run(plan, traffic, bench.route(traffic["route"]), seconds, trace, device,
                   PROCESS_START)
    card = _card(device)
    print(f"rasterbench: on {card['kind']} (power limit {card['power_limit']})",
          file=sys.stderr, flush=True)
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    data = RunData(window=win)
    if trace and win.trace is not None:
        ref = reference.Reference(plan, device)
        data.work = [ref.render(plan.orbit.eye_at(win.trace.first + j)).work
                     for j in range(win.trace.frames)]
        del ref
    worst, failed, work = check.compare(reference, plan, traffic["checks"],
                                        [s.eye for s in win.samples],
                                        check.program_frames(win.samples), device)
    limits = traffic["checks"]
    correct = bool(win.samples) and failed == 0
    metrics = {}
    for entry in bench.metrics(cell, per_layer=trace):
        value = bench.reader(entry["name"]).read(data)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": card["platform"], "kind": card["kind"], "count": int(cell["chips"]),
           "memory_peak_bytes": win.memory_peak_bytes, "power_limit": card["power_limit"]}
    result = {"correct": correct, "attempted": win.frames, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s()
        dev["window_s"] = win.trace.window_s
        result["breakdown"] = win.trace.breakdown()
    result["checks"] = {n: {"value": worst[n], "limit": limits[n]} for n in limits}
    bad = forbidden_modules()
    if bad:
        print(f"rasterbench: forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    quarters = [sum(q) / len(q) * 1e3 for q in _quarters(win.latencies)]
    print(f"rasterbench: {win.frames} frames in {win.seconds:.3f} s (mean frame by quarter "
          f"of the window: {', '.join(f'{q:.3f}' for q in quarters)} ms), "
          f"{len(win.samples)} compared with the reference, {failed} failed",
          file=sys.stderr)
    won = {}
    for frame in work:
        for p in frame:
            won.setdefault(p["pass"], []).append(p["won"])
    print("rasterbench: pixels each pass wins in the reference's sampled frames: "
          + "; ".join(f"{name} {w}" for name, w in won.items()), file=sys.stderr)
    for n in limits:
        print(f"check {n} {worst[n]} limit {limits[n]}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m rasterbench.run")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    # one host thread for PyTorch's CPU work, so only the frame loop loads the host
    os.environ["OMP_NUM_THREADS"] = "1"
    # PyTorch's own kernel cache stays inside the checkout, at a fixed path
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(ROOT / "build" / "rasterbench" / "kernels")
    import torch
    from rasterbench import catalog
    chips = int(catalog.Benchmark(ROOT).cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rasterbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    return execute(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), "cuda")


if __name__ == "__main__":
    sys.exit(main())
