"""The readings that set the limits of the comparison (``check``).

    python -m rasterbench.control --workload <cell> --seeds 1,2,3 --seconds 3

For each seed, in one process: a short window of the cell as a run
makes it (``loop.run``), then two readings of every compared number at
the frames sampled from it:

  * ``program``: the program's frames against the float32 reference,
    as a run reads them;
  * ``control``: the reference itself, computed in bfloat16 (the
    precision below the configuration's float32), against the float32
    reference.

The reference is the configuration's (``catalog.Benchmark.reference``).

One JSON line a seed on standard output.  The benchmark's own runs do
not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch


def bfloat16_frames(reference, plan, checks: dict, device):
    """The side under test for ``check.compare`` when ``reference`` (the
    module) in bfloat16 stands in the program's place."""
    from rasterbench import check
    low = reference.Reference(plan, device, dtype=torch.bfloat16)

    def frames(i, eye):
        got = low.render(eye, stats="stats_off" in checks)
        return check.reference_images(reference, got, checks), got.depth, got.stats
    return frames


def readings(root, workload: str, seed: int, seconds: float, device) -> dict:
    from rasterbench import catalog, check, loop, scenes
    bench = catalog.Benchmark(root)
    cell = bench.cell(workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    checks = traffic["checks"]
    reference = bench.reference(config.get("reference"))
    plan = scenes.make_plan(config, traffic, seed)
    win = loop.run(plan, traffic, bench.route(traffic["route"]), seconds, False, device,
                   time.perf_counter())
    gc.collect()
    eyes = [s.eye for s in win.samples]
    program, failed, _ = check.compare(reference, plan, checks, eyes,
                                       check.program_frames(win.samples), device)
    control, _, _ = check.compare(reference, plan, checks, eyes,
                                  bfloat16_frames(reference, plan, checks, device), device)
    return {"workload": workload, "seed": seed, "frames": win.frames,
            "sampled": [s.frame for s in win.samples], "program": program,
            "program_failed": failed, "control": control}


def main(argv=None) -> int:
    from rasterbench.run import ROOT
    parser = argparse.ArgumentParser(prog="python -m rasterbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("rasterbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(ROOT, args.workload, seed, args.seconds, "cuda")), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
