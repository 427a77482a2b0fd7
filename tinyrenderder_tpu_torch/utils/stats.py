"""Render statistics: the reference's counters.

Counterpart of ``tinyrenderder_tpu/utils/stats.py``.  The reference keeps
global counters updated inside the hot loop (our_gl.cpp:18-22, :90,
:138-141, :194-198) and dumps them at exit (print_render_stats,
our_gl.cpp:204-210); here they are a value object threaded through a
render.  ``fragments_drawn`` counts framebuffer writes including
overdraw.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class RenderStats:
    triangles_rasterized: int = 0
    fragments_drawn: int = 0
    fragments_exact: bool = True      # False when overdraw is not counted
    min_x: int = 2**31 - 1
    min_y: int = 2**31 - 1
    max_x: int = -2**31
    max_y: int = -2**31
    min_z: float = math.inf
    max_z: float = -math.inf
    models_rendered: int = 0
    models_culled: int = 0
    total_triangles: int = 0
    culled_triangles: int = 0
    pass_names: list = field(default_factory=list)

    def merge_bbox(self, min_x: int, min_y: int, max_x: int, max_y: int) -> None:
        self.min_x = min(self.min_x, int(min_x))
        self.min_y = min(self.min_y, int(min_y))
        self.max_x = max(self.max_x, int(max_x))
        self.max_y = max(self.max_y, int(max_y))

    def merge_z(self, zmin: float, zmax: float) -> None:
        self.min_z = min(self.min_z, float(zmin))
        self.max_z = max(self.max_z, float(zmax))

    def describe(self) -> str:
        """print_render_stats format (our_gl.cpp:204-210)."""
        zmin = str(self.min_z) if math.isfinite(self.min_z) else "inf"
        zmax = str(self.max_z) if math.isfinite(self.max_z) else "-inf"
        frag = str(self.fragments_drawn) + ("" if self.fragments_exact else " (winners only)")
        return (f"DEBUG: triangles={self.triangles_rasterized}"
                f" fragments_drawn={frag}"
                f" bbox=[{self.min_x},{self.min_y}] - [{self.max_x},{self.max_y}]"
                f" z-range=[{zmin},{zmax}]")

    def culling_report(self) -> str:
        """main.cpp:794-804."""
        total = self.total_triangles + self.culled_triangles
        lines = [
            "=== Frustum Culling Statistics ===",
            f"  Total models: {self.models_rendered + self.models_culled}",
            f"  Models rendered: {self.models_rendered}",
            f"  Models culled: {self.models_culled}",
            f"  Total triangles: {self.total_triangles}",
            f"  Culled triangles: {self.culled_triangles}",
        ]
        if total > 0:
            lines.append(
                f"  Triangle culling efficiency: {self.culled_triangles * 100.0 / total}%")
        return "\n".join(lines)
