"""Shared pieces of the ``test_torch_*.py`` parity tests.

The JAX side of a comparison runs in ONE subprocess per test module:

    python tests/torch_parity.py requests.npz results.npz

XLA:CPU contracts multiply-adds into FMAs under the suite's AVX2 cap
even with ``--xla_allow_excess_precision=false``; under
``--xla_cpu_max_isa=SSE4_2`` (no FMA instructions) it rounds every
product and sum like NumPy and the port.  ``tests/conftest.py`` adds its
AVX2 cap only when no cap is set, so the subprocess sets its own.

Threads: the suite runs its files in several worker processes on one
machine, so each test process caps torch at one intra-op thread when it
imports this module, and the JAX subprocess runs XLA:CPU single-threaded;
both keep every comparison bitwise (one thread changes no op order here).

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
JAX_XLA_FLAGS = ("--xla_cpu_max_isa=SSE4_2 --xla_allow_excess_precision=false "
                 "--xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1")

if __name__ != "__main__":      # a test process; the JAX subprocess needs no torch
    import torch
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# scenes shared by both sides (procedural, deterministic)
# ---------------------------------------------------------------------------

SCENES = {
    # name: (mesh, shader kind, width, height)
    "head_phong": ("head", "phong", 256, 128),
    "sphere_gouraud": ("sphere", "gouraud", 256, 128),
    "head_textured": ("head", "textured", 256, 128),
    "soup_phong_ragged": ("soup", "phong", 160, 42),
    "cube_gouraud": ("cube", "gouraud", 160, 42),     # screen-sized triangles
}


#: multi-pass frames: name -> (width, height); 160 is a ragged tile width
FRAMES = {
    "cli_default": (160, 96),   # tinyrenderder_tpu.cli's scene, eyes excluded LAST
    "multimesh": (160, 96),     # bench.py's 3-mesh scene, eyes excluded in the MIDDLE
}

#: the two packages' host modules: "port" (tinyrenderder_tpu_torch) builds
#: the port side of a comparison, "jax" (tinyrenderder_tpu) the JAX side
SIDES = ("port", "jax")


def side_modules(side: str) -> dict:
    """{math3d, camera, procedural, shaders, oracle, scene, cli} of one side."""
    import importlib
    pkg = {"port": "tinyrenderder_tpu_torch", "jax": "tinyrenderder_tpu"}[side]
    return {name: importlib.import_module(f"{pkg}.{path}") for name, path in (
        ("math3d", "math3d"), ("camera", "camera"), ("procedural", "models.procedural"),
        ("shaders", "shaders"), ("oracle", "oracle"), ("scene", "scene"), ("cli", "cli"))}


def multimesh_scene(side: str, w: int, h: int, head_lat=12, head_lon=16, eye_lat=6,
                    eye_lon=8):
    """``tinyrenderder_tpu_torch.scene.multimesh_scene`` (the port side), or
    the same scene built from the JAX package's host objects."""
    m = side_modules(side)
    if side == "port":
        return m["scene"].multimesh_scene(w, h, head_lat, head_lon, eye_lat, eye_lon)
    math3d, procedural, shaders = m["math3d"], m["procedural"], m["shaders"]
    key, fill, rim = (math3d.normalized(math3d.vec3(*v)) for v in
                      ((1.0, 1.4, 1.0), (-0.3, 0.5, 0.2), (-1.0, 0.8, -1.5)))
    cam = m["camera"].Camera()
    cam.set_eye(math3d.vec3(0, 0.6, 3.0))
    cam.set_target(math3d.vec3(0, 0, 0))
    cam.set_fov(60.0)
    cam.set_aspect(w / h)
    cam.set_clipping(0.1, 50.0)
    scene = m["scene"].Scene(camera=cam, width=w, height=h)
    head = procedural.bumpy_head(head_lat, head_lon)
    head.materials = [procedural.default_head_material(256)]
    scene.add(head, math3d.identity4(),
              shaders.PhongShader(key, fill, rim, normal_map_strength=0.5), name="head")
    eyes = procedural.uv_sphere(eye_lat, eye_lon, radius=0.12, name="eyes")
    eyes.positions += np.array([0.35, 0.25, 0.8])
    eyes.finalize()
    eyes.materials = [procedural.default_head_material(64)]
    scene.add(eyes, math3d.identity4(), shaders.EyeShader(key, rim), name="eyes",
              exclude_from_output_depth=True)
    room = procedural.cube(size=12.0, name="room")
    room.faces = room.faces[:, ::-1].copy()
    room.finalize()
    room.materials = [procedural.default_head_material(128)]
    scene.add(room, math3d.identity4(),
              shaders.PhongShader(key, fill, rim, normal_map_strength=0.0), name="room")
    return scene


#: the blocker scene of tests/test_shadows.py: its lights and the light it is lit from
SHADOW_KEY = (0.6, 1.2, 0.8)


def blocker_scene(side: str, w: int = 96, h: int = 72):
    """``tests/test_shadows.py::_blocker_scene`` from one side's host
    objects: a sphere hovering over a ground plane, Phong without normal
    maps, lit from above."""
    m = side_modules(side)
    math3d, procedural, shaders = m["math3d"], m["procedural"], m["shaders"]
    key, fill, rim = (math3d.normalized(math3d.vec3(*v)) for v in
                      (SHADOW_KEY, (-0.3, 0.5, 0.2), (-1.0, 0.8, -1.5)))
    sphere = procedural.uv_sphere(10, 14, radius=0.5)
    sphere.materials = [procedural.default_head_material(16)]
    ground = procedural.plane(6.0, y=-1.0)
    ground.materials = [procedural.default_head_material(16)]
    cam = m["camera"].Camera()
    cam.set_eye(math3d.vec3(0.0, 1.2, 3.2))
    cam.set_target(math3d.vec3(0.0, -0.3, 0.0))
    cam.set_fov(55.0)
    cam.set_aspect(w / h)
    cam.set_clipping(0.1, 50.0)
    scene = m["scene"].Scene(camera=cam, width=w, height=h)
    scene.add(sphere, math3d.translation_matrix(0.0, 0.2, 0.0),
              shaders.PhongShader(key, fill, rim, normal_map_strength=0.0), name="sphere")
    scene.add(ground, math3d.identity4(),
              shaders.PhongShader(key, fill, rim, normal_map_strength=0.0), name="ground")
    return scene


def frame_scene(name: str, side: str = "port"):
    """A fresh ``Scene`` of ``FRAMES`` built from one side's host objects."""
    w, h = FRAMES[name]
    if name == "cli_default":
        return side_modules(side)["cli"].build_default_scene(width=w, height=h)
    return multimesh_scene(side, w, h)


def make_shader(kind: str, side: str = "port"):
    m = side_modules(side)
    math3d, sh = m["math3d"], m["shaders"]
    key = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
    fill = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
    rim = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))
    return {"phong": lambda: sh.PhongShader(key, fill, rim, normal_map_strength=0.5),
            "eye": lambda: sh.EyeShader(key, rim),
            "gouraud": lambda: sh.GouraudShader(light_world=key),
            "textured": lambda: sh.TexturedShader(light_world=key),
            "flat": lambda: sh.FlatShader(light_world=key),
            "depth": lambda: sh.DepthShader(),
            "gray_depth": lambda: sh.GrayDepthShader()}[kind]()


def standard_meshes(side: str = "port") -> dict:
    """``tests/helpers.py::standard_meshes`` from one side's ``procedural``."""
    procedural = side_modules(side)["procedural"]
    head = procedural.bumpy_head(12, 16)
    head.materials = [procedural.default_head_material(32)]
    sphere = procedural.uv_sphere(10, 14)
    sphere.materials = [procedural.default_head_material(16)]
    return {"head": head, "sphere": sphere, "soup": procedural.triangle_soup(40),
            "cube": procedural.cube()}


def make_pass(mesh, shader, view, proj, side: str = "port", dtype=np.float32):
    """One side's ``oracle.OraclePass`` of ``mesh`` (identity model matrix)."""
    material = mesh.materials[0] if mesh.materials else None
    uniforms = shader.build_uniforms(view @ np.eye(4), proj, material, dtype)
    return side_modules(side)["oracle"].OraclePass(
        attrs=mesh.face_attributes(dtype), shader=shader, uniforms=uniforms)


def scene_pass(name: str, side: str = "port"):
    """-> (one side's OraclePass with NumPy float32 attrs/uniforms, w, h)."""
    from helpers import default_view
    mesh, kind, w, h = SCENES[name]
    view, proj = default_view()
    return make_pass(standard_meshes(side)[mesh], make_shader(kind, side), view, proj,
                     side), w, h


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


class _tiles_loop:
    """The JAX package's tiled route off the TPU, as tests/test_scene.py,
    tests/test_fine.py and tests/test_fine2.py run it: ``FINE_MODE``
    forced to ``mode`` ("coarse", "fine" or "fine2"), ``FORCE_TILES_LOOP =
    True``, Pallas in interpret mode; set and restored."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        from tinyrenderder_tpu import scene as scene_mod
        from tinyrenderder_tpu.ops import raster_sparse
        self.old = raster_sparse.FINE_MODE, scene_mod.FORCE_TILES_LOOP
        raster_sparse.FINE_MODE, scene_mod.FORCE_TILES_LOOP = self.mode, True
        _clear_capacities()

    def __exit__(self, *exc):
        from tinyrenderder_tpu import scene as scene_mod
        from tinyrenderder_tpu.ops import raster_sparse
        raster_sparse.FINE_MODE, scene_mod.FORCE_TILES_LOOP = self.old
        _clear_capacities()


def _jax_image(r):
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_sparse

    p, w, h = scene_pass(str(r["scene"]), "jax")
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    with _tiles_loop(str(r.get("mode", "coarse"))):
        image, overflow = raster_sparse.render_frame_fused_image(
            [(attrs, p.shader, dict(p.uniforms), False)], w, h,
            tile_h=int(r["th"]), strict_capacity=True, interpret=True)
        assert not bool(overflow)
    return {"image": np.asarray(image)}


def _jax_pre_fine(r):
    """``raster_fine._pre_fine_jit`` at exact capacities (the port's
    totals): active tiles, their row segments and every slot's triangle
    id, decoded from record column 16 (lane-row 1, lanes 0-7)."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_fine

    p, w, h = scene_pass(str(r["scene"]), "jax")
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    pairs, rows, active = int(r["pairs"]), int(r["rows"]), int(r["active"])
    out = raster_fine._pre_fine_jit(
        attrs, dict(p.uniforms), p.shader, w, h, pairs, rows,
        1 << max(rows - 1, 0).bit_length(), active, int(r["th"]), 128)
    _, rec, ids, kernel_ids, row_start, rows_a, pt, rt, na, _ = out
    res = {"ids": np.asarray(ids)[:active], "row_start": np.asarray(row_start)[:active],
           "rows": np.asarray(rows_a)[:active],
           "slots": np.asarray(rec)[:rows, 1, 0:8].astype(np.int32),
           "totals": np.array([int(pt), int(rt), int(na)])}
    if "n_vary" in r:
        # the strip kernel on this pre-stage, with and without stats
        for stats in (False, True):
            d, wn, v, ev = raster_fine._fine_call_jit(
                kernel_ids, row_start, rows_a, rec, jnp.asarray(r["depth_tiles"]),
                -(-w // 128), -(-h // int(r["th"])), int(r["th"]), 128,
                int(r["n_vary"]), True, collect_stats=stats)
            res.update({f"depth_{int(stats)}": np.asarray(d)[:active],
                        f"winner_{int(stats)}": np.asarray(wn)[:active],
                        f"vary_{int(stats)}": np.asarray(v)[:active]})
            if stats:
                res["ev"] = np.asarray(ev)[:active]
    return res


def _jax_pre_fine2(r):
    """``raster_fine2._pre_fine2_jit`` at exact capacities (the port's
    totals): the groups, their slot origins and strips, the active-tile
    map and every slot's triangle id (record column 16); with ``n_vary``
    also ``_init_strips_jit`` on ``depth_tiles`` and ``_fine2_call_jit``
    on this pre-stage, pass-local with the varyings and init-seeded with
    stats (n_vary 0), as ``render_pass_fine2`` launches them."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_fine2

    p, w, h = scene_pass(str(r["scene"]), "jax")
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    pairs, rows, groups, active = (int(r[k]) for k in ("pairs", "rows", "groups", "active"))
    th = int(r["th"])
    (_, rec, ids, _, src, live, start_g, rows_g, x0y0, sid_of, pt, rt, ng, na,
     _) = raster_fine2._pre_fine2_jit(attrs, dict(p.uniforms), p.shader, w, h, pairs, rows,
                                      1 << max(rows - 1, 0).bit_length(), groups, active,
                                      th, 128)
    res = {"ids": np.asarray(ids), "src": np.asarray(src), "live": np.asarray(live),
           "group_start": np.asarray(start_g), "group_rows": np.asarray(rows_g),
           "x0y0": np.asarray(x0y0), "sid_of": np.asarray(sid_of)[:groups],
           "slots": np.asarray(rec)[:rows, 1, 0:8].astype(np.int32),
           "totals": np.array([int(pt), int(rt), int(ng), int(na)])}
    if "n_vary" in r:
        init = raster_fine2._init_strips_jit(jnp.asarray(r["depth_tiles"]), sid_of, groups,
                                             th)
        d, wn, v, _ = raster_fine2._fine2_call_jit(start_g, rows_g, rec, x0y0, th,
                                                   int(r["n_vary"]), True)
        de, we, _, ev = raster_fine2._fine2_call_jit(start_g, rows_g, rec, x0y0, th, 0, True,
                                                     collect_stats=True, init_g=init)
        res.update(init=np.asarray(init), depth_0=np.asarray(d), winner_0=np.asarray(wn),
                   vary_0=np.asarray(v), depth_1=np.asarray(de), winner_1=np.asarray(we),
                   ev=np.asarray(ev))
    return res


def stats_vector(st) -> np.ndarray:
    """The RenderStats fields a frame computes, as one float64 vector."""
    return np.array([st.triangles_rasterized, st.fragments_drawn, st.min_x, st.min_y,
                     st.max_x, st.max_y, st.min_z, st.max_z, st.fragments_exact,
                     st.models_rendered, st.models_culled, st.total_triangles,
                     st.culled_triangles], dtype=np.float64)


def _jax_scene(r):
    """``scene.render(backend="tiled")`` in ``mode``, with stats and (in
    coarse mode) without, and the frame's winner plane: in coarse mode
    from ``render_frame_fused`` + ``tiles_to_buffers``, in fine mode from
    the tiles of the render with stats itself."""
    from tinyrenderder_tpu import scene as scene_mod
    from tinyrenderder_tpu.ops import raster_sparse
    from tinyrenderder_tpu.utils.stats import RenderStats

    name = str(r["scene"])
    mode = str(r.get("mode", "coarse"))
    w, h = FRAMES[name]
    out = {}
    finish = scene_mod._finish_device_tiles
    tiles = []

    def keep_tiles(scene, ft, *args, **kw):
        tiles.append(ft)
        return finish(scene, ft, *args, **kw)

    with _tiles_loop(mode):
        scene_mod._finish_device_tiles = keep_tiles
        try:
            for stats in (True, False) if mode == "coarse" else (True,):
                res = frame_scene(name, "jax").render(backend="tiled", collect_stats=stats)
                for k in ("color", "depth", "full_depth"):
                    out[f"{k}_{int(stats)}"] = np.asarray(getattr(res, k))
                out[f"stats_{int(stats)}"] = stats_vector(res.stats)
        finally:
            scene_mod._finish_device_tiles = finish
        if mode == "coarse":
            sc = frame_scene(name, "jax")
            passes = []
            for p in scene_mod._cull_passes(sc, True, RenderStats()):
                attrs, uniforms = scene_mod._pass_inputs(sc, p, np.float32, device=True)
                passes.append((attrs, p.shader, uniforms, p.exclude_from_output_depth))
            ft, _, overflow = raster_sparse.render_frame_fused(
                passes, w, h, tile_h=16, strict_capacity=True, interpret=True)
            assert not bool(overflow)
        else:
            ft = tiles[0]
        out["winner"] = np.asarray(raster_sparse.tiles_to_buffers(ft, w, h, 16).winner)
    return out


def _jax_shadows(r):
    """``shadows.render_with_shadows(backend="tiled")`` of the blocker
    scene at (w, h, size), with stats, on the tiled route's loop in
    ``mode``: the map and the frame."""
    from tinyrenderder_tpu import math3d, shadows

    key = math3d.normalized(math3d.vec3(*SHADOW_KEY))
    scene = blocker_scene("jax", int(r["w"]), int(r["h"]))
    with _tiles_loop(str(r["mode"])):
        res, smap = shadows.render_with_shadows(
            scene, key, shadows.ShadowSettings(size=int(r["size"])), backend="tiled",
            collect_stats=True)
    out = {k: np.asarray(getattr(res, k)) for k in ("color", "depth", "full_depth")}
    out.update(map=np.asarray(smap), stats=stats_vector(res.stats))
    return out


def _jax_dense(r):
    """``raster_pallas.rasterize_pallas`` and ``depth_resolve_pallas``
    (``interpret=True``) on the JAX package's own bins of a setup; with
    ``origin``, ``_pallas_call_jit(origin=...)`` on those bins, untiled
    and cropped as ``rasterize_pallas`` does."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_pallas, raster_tiled

    setup = {k: jnp.asarray(r[k]) for k in ("valid", "screen", "ndc_z", "clip_w", "bbox")}
    w, h, th = int(r["w"]), int(r["h"]), int(r["th"])
    init = jnp.asarray(r["init"])
    vary_corners = jnp.asarray(r["vary_corners"])
    bins = raster_tiled.bin_triangles_csr(setup, w, h, 128, th)
    out = {"counts": np.asarray(bins.counts)}
    if "origin" in r:
        ntx, nty, n_vary = bins.n_tiles_x, bins.n_tiles_y, int(vary_corners.shape[-1])
        records = raster_pallas.build_pair_records(setup, bins.sorted_tri, vary_corners)
        init_t = raster_pallas._tiles_jit(init, nty, ntx, th, 128)
        d, wn, v = raster_pallas._pallas_call_jit(
            bins.start[:-1].astype(jnp.int32), bins.counts.astype(jnp.int32), records, init_t,
            ntx, nty, th, 128, n_vary, True, origin=jnp.asarray(r["origin"]))
        out.update(depth=raster_pallas._untile_jit(d, nty, ntx, th, 128, h, w),
                   winner=raster_pallas._untile_winner_jit(wn, nty, ntx, th, 128, h, w),
                   vary=raster_pallas._untile_vary_jit(v, nty, ntx, th, 128, h, w))
    else:
        d, wn, v = raster_pallas.rasterize_pallas(setup, bins, init, h, w, vary_corners, th,
                                                  128, interpret=True)
        d0, w0 = raster_pallas.depth_resolve_pallas(setup, bins, init, h, w, th, 128,
                                                    interpret=True)
        out.update(depth=d, winner=wn, vary=v, depth_only=d0, winner_only=w0)
    return {k: np.asarray(v) for k, v in out.items()}


def _jax_post(r):
    from tinyrenderder_tpu.ops import post
    zimg, ao, final = post.postprocess_device(r["color"], r["depth"])
    return {"zimg": np.asarray(zimg), "ao": np.asarray(ao), "final": np.asarray(final)}


def _main(req_path, out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    ops = {"bins": _jax_bins, "raster": _jax_raster, "untile": _jax_untile,
           "untile3": _jax_untile3, "image": _jax_image, "scene": _jax_scene,
           "post": _jax_post, "pre_fine": _jax_pre_fine, "pre_fine2": _jax_pre_fine2,
           "shadows": _jax_shadows, "dense": _jax_dense}
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
