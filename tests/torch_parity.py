"""Shared pieces of the ``test_torch_*.py`` parity tests.

The JAX side of a comparison runs in ONE subprocess per test module:

    python tests/torch_parity.py requests.npz results.npz

XLA:CPU contracts multiply-adds into FMAs under the suite's AVX2 cap
even with ``--xla_allow_excess_precision=false``; under
``--xla_cpu_max_isa=SSE4_2`` (no FMA instructions) it rounds every
product and sum like NumPy and the port.  ``tests/conftest.py`` adds its
AVX2 cap only when no cap is set, so the subprocess sets its own.

Requests and results are flat ``.npz`` files with keys ``case/name``;
``case/op`` names the JAX function to run.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
JAX_XLA_FLAGS = "--xla_cpu_max_isa=SSE4_2 --xla_allow_excess_precision=false"


# ---------------------------------------------------------------------------
# scenes shared by both sides (procedural, deterministic)
# ---------------------------------------------------------------------------

SCENES = {
    # name: (mesh, shader kind, width, height)
    "head_phong": ("head", "phong", 256, 128),
    "sphere_gouraud": ("sphere", "gouraud", 256, 128),
    "head_textured": ("head", "textured", 256, 128),
    "soup_phong_ragged": ("soup", "phong", 160, 42),
}


#: multi-pass frames: name -> (width, height); 160 is a ragged tile width
FRAMES = {
    "cli_default": (160, 96),   # tinyrenderder_tpu.cli's scene, eyes excluded LAST
    "multimesh": (160, 96),     # bench.py's 3-mesh scene, eyes excluded in the MIDDLE
}


def frame_scene(name: str):
    """A fresh ``Scene`` of ``FRAMES`` (host objects only)."""
    w, h = FRAMES[name]
    if name == "cli_default":
        from tinyrenderder_tpu.cli import build_default_scene
        return build_default_scene(width=w, height=h)
    from tinyrenderder_tpu_torch.scene import multimesh_scene
    return multimesh_scene(w, h, head_lat=12, head_lon=16, eye_lat=6, eye_lon=8)


def make_shader(kind: str):
    from tinyrenderder_tpu import math3d
    from tinyrenderder_tpu.shaders import (EyeShader, GouraudShader, PhongShader,
                                           TexturedShader)
    key = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
    fill = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
    rim = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))
    return {"phong": lambda: PhongShader(key, fill, rim, normal_map_strength=0.5),
            "eye": lambda: EyeShader(key, rim),
            "gouraud": lambda: GouraudShader(light_world=key),
            "textured": lambda: TexturedShader(light_world=key)}[kind]()


def scene_pass(name: str):
    """-> (oracle.OraclePass with NumPy float32 attrs/uniforms, w, h)."""
    from helpers import default_view, make_pass, standard_meshes
    mesh, kind, w, h = SCENES[name]
    view, proj = default_view()
    return make_pass(standard_meshes()[mesh], make_shader(kind), view, proj), w, h


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def assert_bits(got, want, what=""):
    """Bitwise equality; float NaNs match any NaN (payloads are not part
    of the contract)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: shape {got.shape} != {want.shape}"
    assert got.dtype == want.dtype, f"{what}: dtype {got.dtype} != {want.dtype}"
    if got.dtype.kind == "f":
        nan = np.isnan(got) & np.isnan(want)
        bits = got.view(f"i{got.itemsize}") == want.view(f"i{want.itemsize}")
        bad = ~(bits | nan)
    else:
        bad = got != want
    if bad.any():
        idx = np.argwhere(bad)[:5]
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.size} elements differ; first at "
            f"{idx.tolist()}: got {got[bad][:5].tolist()} want {want[bad][:5].tolist()}")


def run_jax(requests: dict, tmp_dir) -> dict:
    """requests {case: {"op": str, name: array/int}} -> results {case: {name: array}}."""
    flat = {}
    for case, items in requests.items():
        for k, v in items.items():
            flat[f"{case}/{k}"] = np.asarray(v)
    req = os.path.join(str(tmp_dir), "requests.npz")
    out = os.path.join(str(tmp_dir), "results.npz")
    np.savez(req, **flat)
    env = dict(os.environ, XLA_FLAGS=JAX_XLA_FLAGS, JAX_PLATFORMS="cpu",
               JAX_PLATFORM_NAME="cpu",
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), req, out],
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, f"JAX side failed:\n{proc.stdout}\n{proc.stderr}"
    results: dict = {}
    with np.load(out) as z:
        for key in z.files:
            case, name = key.split("/", 1)
            results.setdefault(case, {})[name] = z[key]
    return results


# ---------------------------------------------------------------------------
# the JAX side (subprocess only)
# ---------------------------------------------------------------------------

def _jax_bins(r):
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops.raster_tiled import _build_bins
    total = int(r["total"])
    sorted_tri, start, counts = _build_bins(
        *(jnp.asarray(r[k]) for k in ("tx0", "ty0", "span_x", "spans")),
        max(total, 1), int(r["ntx"]), int(r["nty"]))
    return {"sorted_tri": np.asarray(sorted_tri)[:total], "start": np.asarray(start),
            "counts": np.asarray(counts)}


def _jax_raster(r):
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_pallas
    setup = {k: jnp.asarray(r[k]) for k in ("valid", "screen", "ndc_z", "clip_w", "bbox")}
    records = raster_pallas.build_pair_records(setup, jnp.asarray(r["sorted_tri"]),
                                               jnp.asarray(r["vary_corners"]))
    depth, winner, vary, ev = raster_pallas._pallas_call_sparse_jit(
        jnp.asarray(r["ids"]), jnp.asarray(r["start"]), jnp.asarray(r["counts"]),
        records, jnp.asarray(r["depth_tiles"]), int(r["ntx"]), int(r["nty"]),
        int(r["th"]), int(r["tw"]), int(r["n_vary"]), True,
        collect_stats=bool(r.get("stats", False)))
    out = {"depth": np.asarray(depth), "winner": np.asarray(winner),
           "vary": np.asarray(vary)}
    if ev is not None:
        out["ev"] = np.asarray(ev)
    return out


def _jax_untile(r):
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_sparse
    out = raster_sparse._untile_one_jit(jnp.asarray(r["x"]), int(r["ntx"]), int(r["nty"]),
                                        int(r["th"]), int(r["tw"]), True)
    return {"out": np.asarray(out)}


def _jax_untile3(r):
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_sparse
    out = raster_sparse._untile_call_jit(
        *(jnp.asarray(r[k]) for k in ("color", "depth", "winner")),
        int(r["ntx"]), int(r["nty"]), int(r["th"]), int(r["tw"]), True)
    return {k: np.asarray(v) for k, v in zip(("color", "depth", "winner"), out)}


def _clear_capacities():
    """Empty the JAX package's capacity caches, as tests/test_image_path.py does."""
    from tinyrenderder_tpu.ops import raster_fine, raster_fine2, raster_sparse
    raster_sparse._SPARSE_CAPACITY.clear()
    raster_sparse._SPARSE_PENDING.clear()
    raster_sparse._W_REFINED.clear()
    raster_fine._FINE_CAPACITY.clear()
    raster_fine._FINE_PENDING.clear()
    raster_fine._W_REFINED.clear()
    raster_fine2._FINE2_CAPACITY.clear()
    raster_fine2._FINE2_PENDING.clear()


class _coarse_tiles_loop:
    """The JAX package's tiled route off the TPU, as tests/test_scene.py
    runs it: ``FINE_MODE = "coarse"``, ``FORCE_TILES_LOOP = True``,
    Pallas in interpret mode; set and restored."""

    def __enter__(self):
        from tinyrenderder_tpu import scene as scene_mod
        from tinyrenderder_tpu.ops import raster_sparse
        self.old = raster_sparse.FINE_MODE, scene_mod.FORCE_TILES_LOOP
        raster_sparse.FINE_MODE, scene_mod.FORCE_TILES_LOOP = "coarse", True
        _clear_capacities()

    def __exit__(self, *exc):
        from tinyrenderder_tpu import scene as scene_mod
        from tinyrenderder_tpu.ops import raster_sparse
        raster_sparse.FINE_MODE, scene_mod.FORCE_TILES_LOOP = self.old
        _clear_capacities()


def _jax_image(r):
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_sparse

    p, w, h = scene_pass(str(r["scene"]))
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    with _coarse_tiles_loop():
        image, overflow = raster_sparse.render_frame_fused_image(
            [(attrs, p.shader, dict(p.uniforms), False)], w, h,
            tile_h=int(r["th"]), strict_capacity=True, interpret=True)
        assert not bool(overflow)
    return {"image": np.asarray(image)}


def stats_vector(st) -> np.ndarray:
    """The RenderStats fields a frame computes, as one float64 vector."""
    return np.array([st.triangles_rasterized, st.fragments_drawn, st.min_x, st.min_y,
                     st.max_x, st.max_y, st.min_z, st.max_z, st.fragments_exact,
                     st.models_rendered, st.models_culled, st.total_triangles,
                     st.culled_triangles], dtype=np.float64)


def _jax_scene(r):
    """``scene.render(backend="tiled")`` with and without stats, and the
    frame's winner plane from ``render_frame_fused`` + ``tiles_to_buffers``."""
    from tinyrenderder_tpu import scene as scene_mod
    from tinyrenderder_tpu.ops import raster_sparse
    from tinyrenderder_tpu.utils.stats import RenderStats

    name = str(r["scene"])
    w, h = FRAMES[name]
    out = {}
    with _coarse_tiles_loop():
        for stats in (True, False):
            res = frame_scene(name).render(backend="tiled", collect_stats=stats)
            for k in ("color", "depth", "full_depth"):
                out[f"{k}_{int(stats)}"] = np.asarray(getattr(res, k))
            out[f"stats_{int(stats)}"] = stats_vector(res.stats)
        sc = frame_scene(name)
        passes = []
        for p in scene_mod._cull_passes(sc, True, RenderStats()):
            attrs, uniforms = scene_mod._pass_inputs(sc, p, np.float32, device=True)
            passes.append((attrs, p.shader, uniforms, p.exclude_from_output_depth))
        ft, _, overflow = raster_sparse.render_frame_fused(
            passes, w, h, tile_h=16, strict_capacity=True, interpret=True)
        assert not bool(overflow)
        out["winner"] = np.asarray(raster_sparse.tiles_to_buffers(ft, w, h, 16).winner)
    return out


def _jax_post(r):
    from tinyrenderder_tpu.ops import post
    zimg, ao, final = post.postprocess_device(r["color"], r["depth"])
    return {"zimg": np.asarray(zimg), "ao": np.asarray(ao), "final": np.asarray(final)}


def _main(req_path, out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    ops = {"bins": _jax_bins, "raster": _jax_raster, "untile": _jax_untile,
           "untile3": _jax_untile3, "image": _jax_image, "scene": _jax_scene,
           "post": _jax_post}
    requests: dict = {}
    with np.load(req_path) as z:
        for key in z.files:
            case, name = key.split("/", 1)
            requests.setdefault(case, {})[name] = z[key]
    flat = {}
    for case, r in requests.items():
        for k, v in ops[str(r["op"])](r).items():
            flat[f"{case}/{k}"] = v
    np.savez(out_path, **flat)


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _main(sys.argv[1], sys.argv[2])
