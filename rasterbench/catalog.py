"""Find the benchmark's parts by the names ``BENCHMARK.json`` gives.

``BENCHMARK.json`` at the root of the checkout lists the cells, the
configurations (each with its ``file``) and the metrics.  Each part is a
file of its own, found by its name:

  * a configuration is its ``file`` (``configs/<name>.json``).  The keys
    that ``scenes.make_plan`` reads (size, camera, lights, cull, post,
    passes) build the plan; every other key reaches routes and
    reference modules unchanged as ``plan.options``.  ``"reference":
    "<name>"`` names the configuration's reference module; without it
    the reference is the stock ``reference.py``;
  * a reference ``<name>`` is ``rasterbench/references/<name>.py``, a
    module with ``Reference(plan, device, dtype=torch.float32)``, whose
    ``.render(eye, stats=False)`` returns a ``reference.Frame`` (colour,
    output depth, stats, counted work), and ``post(color, depth)`` ->
    ``{zimg, ao, final}``, as ``reference.py`` has them.  It may import
    ``reference.py``'s frozen formulas, and nothing of the program and
    no JAX.  ``check``, ``control`` and ``run`` take the reference
    only through ``Benchmark.reference``;
  * a traffic mix ``<name>`` is ``rasterbench/traffic/<name>.json``,
    whose ``route`` names its frame loop and delivery point
    ``rasterbench/routes/<route>.py`` (a module with ``outputs(plan)``
    and ``frame(loop, spans)``, see ``loop``);
  * a metric ``<name>`` is ``rasterbench/metrics/<name>.py``, a module
    with ``UNIT``, ``LAYER`` (``None`` for an end-to-end metric),
    ``MOVES`` and ``read(data)``.

So a cell, a configuration with its reference, a traffic mix, a route
or a metric is added by adding files and entries, with no edit to the
harness.  The CPU tests cut a configuration to a tiny size by its own
``"tiny"`` block (``tests/tiny_checkout.py``).
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

PACKAGE = "rasterbench"


class Benchmark:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / PACKAGE / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: dict, per_layer: bool) -> list[dict]:
        """The metric entries a run of ``cell`` reports: the end-to-end
        ones, or with ``per_layer`` the per-layer ones, each where its
        ``workloads`` list (if any) names the cell."""
        group = self.spec["per_layer" if per_layer else "end_to_end"]
        return [m for m in group if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, name: str):
        """The module of metric ``name``."""
        return self._module("metrics", name)

    def route(self, name: str):
        """The module of route ``name``."""
        return self._module("routes", name)

    def reference(self, name: str | None):
        """The reference module ``name``, a configuration's
        ``"reference"``; ``None`` is the stock ``reference``."""
        if name is None:
            from rasterbench import reference
            return reference
        return self._module("references", name)

    def _module(self, kind: str, name: str):
        path = self.root / PACKAGE / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"{PACKAGE}_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
