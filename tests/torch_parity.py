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

import contextlib
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


def culled_scene(side: str):
    """tests/test_parallel.py's scene whose one pass is frustum-culled: the
    head 500 units behind a camera at z = 3, 128x128."""
    m = side_modules(side)
    math3d, procedural, shaders = m["math3d"], m["procedural"], m["shaders"]
    head = procedural.bumpy_head(12, 16)
    head.materials = [procedural.default_head_material(32)]
    cam = m["camera"].Camera()
    cam.set_eye(math3d.vec3(0, 0, 3))
    cam.set_target(math3d.vec3(0, 0, 0))
    cam.set_fov(40.0)
    cam.set_aspect(1.0)
    cam.set_clipping(0.1, 10.0)
    scene = m["scene"].Scene(camera=cam, width=128, height=128)
    scene.add(head, math3d.translation_matrix(0.0, 0.0, 500.0),
              make_shader("phong", side), name="head")
    return scene


def sharded_scene(kind: str, side: str, w: int, h: int):
    """A scene of the sharded backends' tests: "multimesh" (3 passes, the
    eyes excluded in the middle), "eyes_last" (the same passes, the eyes
    last: the frame ends inside the excluded run), "head" (its first pass
    alone: one colour pass), "depth_head" (the head through
    ``DepthShader``, a depth-only pass, then the room) or "culled"
    (``culled_scene``, whose size is its own)."""
    if kind == "culled":
        return culled_scene(side)
    scene = multimesh_scene(side, w, h)
    head, eyes, room = scene.passes
    if kind == "depth_head":
        head.shader = make_shader("depth", side)
    scene.passes = {"multimesh": [head, eyes, room], "eyes_last": [head, room, eyes],
                    "head": [head], "depth_head": [head, room]}[kind]
    return scene


def cut_passes(passes, cut):
    """Each pass tuple's faces cut to the first ``cut[i]`` (all where
    negative): face counts that no rank count divides, or fewer faces
    than ranks."""
    return [({k: v if n < 0 else v[:n] for k, v in attrs.items()}, *rest)
            for (attrs, *rest), n in zip(passes, cut)]


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


def assert_colour(got, want, oracle, what=""):
    """An (..., 3) uint8 port colour against the JAX package's: the port's
    is the float32 NumPy oracle's, bitwise; where the JAX package's leaves
    that oracle (its colour contract allows 1 LSB) the two are within 1
    LSB, and elsewhere bitwise."""
    got, want, oracle = np.asarray(got), np.asarray(want), np.asarray(oracle)
    assert_bits(got, oracle, f"{what} vs the f32 oracle")
    off = (want != oracle).any(-1)
    assert off.sum() <= 4, f"{what}: the JAX colour leaves the oracle at {int(off.sum())} pixels"
    assert_bits(got[~off], want[~off], what)
    assert np.abs(got[off].astype(int) - want[off].astype(int)).max(initial=0) <= 1, what


def launches(*entries: str) -> int:
    """The port's launch counters of kernel entry points ``entries``
    (``launch.<entry>`` in ``trace.counts()``), summed."""
    from tinyrenderder_tpu_torch import trace
    c = trace.counts()
    return sum(c[f"launch.{e}"] for e in entries)


def reset_launches() -> None:
    """Set the port's counters, its launch counters among them, to 0."""
    from tinyrenderder_tpu_torch import trace
    trace.reset_counts()


@contextlib.contextmanager
def fine_mode(mode: str):
    """The port's ``raster_sparse.FINE_MODE`` set to ``mode`` inside the
    block and restored after it."""
    from tinyrenderder_tpu_torch.ops import raster_sparse
    old, raster_sparse.FINE_MODE = raster_sparse.FINE_MODE, mode
    try:
        yield
    finally:
        raster_sparse.FINE_MODE = old


def spawn_ranks(fn, args: tuple, nprocs: int, timeout: float = 180.0) -> None:
    """``torch.multiprocessing.spawn(fn, args, nprocs)`` with a deadline: a
    rank that raises fails the caller, and ranks still running after
    ``timeout`` seconds (a collective that never completes) are killed
    and fail it too."""
    import time
    ctx = torch.multiprocessing.spawn(fn, args=args, nprocs=nprocs, join=False)
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise AssertionError(f"{nprocs} ranks still running after {timeout} s")


def cli_rank(rank, world, port, argv):
    """One torchrun-style rank of ``cli.run(argv)`` (for ``spawn_ranks``):
    the process group from the environment, as torchrun sets it."""
    from tinyrenderder_tpu_torch import cli
    torch.set_num_threads(1)
    os.environ.update(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    assert cli.run(argv) == 0


def run_jax(requests: dict, tmp_dir, devices: int = 1) -> dict:
    """requests {case: {"op": str, name: array/int}} -> results {case: {name: array}}.
    ``devices``: the JAX side's virtual CPU devices (its meshes' size)."""
    flat = {}
    for case, items in requests.items():
        for k, v in items.items():
            flat[f"{case}/{k}"] = np.asarray(v)
    req = os.path.join(str(tmp_dir), "requests.npz")
    out = os.path.join(str(tmp_dir), "results.npz")
    np.savez(req, **flat)
    flags = JAX_XLA_FLAGS
    if devices > 1:         # first: XLA reads no flag after the bare thread count
        flags = f"--xla_force_host_platform_device_count={devices} {flags}"
    env = dict(os.environ, XLA_FLAGS=flags, JAX_PLATFORMS="cpu",
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


def _jax_compact_image(r):
    """``raster_sparse._compact_to_image`` (``direct=False``, interpret mode)
    of compact packed-colour tiles, cropped, and ``_unpack_rgb`` of the crop."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_sparse
    ntx, nty, th, tw, h, w = (int(r[k]) for k in ("ntx", "nty", "th", "tw", "h", "w"))
    img = raster_sparse._compact_to_image(jnp.asarray(r["tiles"]), jnp.asarray(r["ids"]),
                                          ntx * nty, ntx, nty, th, tw, True, False)
    crop = img[:h, :w]
    return {"plane": np.asarray(crop), "rgb": np.asarray(raster_sparse._unpack_rgb(crop))}


def _jax_tiles_to_buffers(r):
    """``raster_sparse._tiles_to_buffers_jit`` (interpret mode): the three
    planes untiled, cropped, the colour unpacked."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_sparse
    ft = raster_sparse.FrameTiles(*(jnp.asarray(r[k]) for k in ("color", "depth", "winner")))
    fb = raster_sparse._tiles_to_buffers_jit(ft, int(r["w"]), int(r["h"]), int(r["th"]),
                                             int(r["tw"]), True)
    return {k: np.asarray(getattr(fb, k)) for k in ("color", "depth", "winner")}


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


def _band_kw(r) -> dict:
    """A request's band window as the pre-stages take it (``ty_lo``,
    ``nty_band``, ``ty_stride``; ``tx_lo``/``ntx_band``; ``ty_rows``), or
    {} for the whole frame."""
    import jax.numpy as jnp
    if "ty_lo" not in r:
        return {}
    kw = {"ty_lo": jnp.int32(int(r["ty_lo"])), "nty_band": int(r["nty_band"]),
          "ty_stride": int(r.get("ty_stride", 1))}
    if "tx_lo" in r:
        kw.update(tx_lo=jnp.int32(int(r["tx_lo"])), ntx_band=int(r["ntx_band"]))
    if "ty_rows" in r:
        kw["ty_rows"] = jnp.int32(int(r["ty_rows"]))
    return kw


def _band_grid(r, w, h, th):
    """(tile columns, tile rows) of a request's band, or of the frame."""
    return (int(r.get("ntx_band", -(-w // 128))), int(r.get("nty_band", -(-h // th))))


def _band_place(r, th) -> dict:
    """The kernel's ``origin`` and ``y_stride`` for a band request: its
    tile 0's global pixel and, for interleaved rows, the pixel rows
    between its tile rows."""
    import jax.numpy as jnp
    if "ty_lo" not in r:
        return {}
    stride = int(r.get("ty_stride", 1))
    return {"origin": jnp.asarray([int(r.get("tx_lo", 0)) * 128, int(r["ty_lo"]) * th],
                                  jnp.int32),
            "y_stride": None if stride == 1 else th * stride}


def _jax_pre_sparse(r):
    """``raster_sparse._pre_sparse_jit`` at exact capacities (the port's
    totals) over the request's band: the active tiles and their CSR
    segments, the totals, the bins' sorted triangles and the window's
    ``raster_tiled._tile_spans``; with ``n_vary`` also
    ``_pallas_call_sparse_jit`` (interpret mode, the band's origin and row
    stride) on it, seeded with ``depth_tiles``, without and with stats."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_pallas, raster_sparse, raster_tiled

    p, w, h = scene_pass(str(r["scene"]), "jax")
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    th, total, active = int(r["th"]), int(r["total"]), int(r["active"])
    kw = _band_kw(r)
    ntx, nty = _band_grid(r, w, h, th)
    setup, records, ids, kernel_ids, sa, ca, tot, na = raster_sparse._pre_sparse_jit(
        attrs, dict(p.uniforms), p.shader, w, h, total, active, th, 128,
        rec_cap=raster_tiled._next_pow2(total), **kw)
    window = {}
    if kw:
        stride = kw["ty_stride"]
        rows = int(r.get("ty_rows", nty))
        window = {"ty_lo": kw["ty_lo"], "ty_stride": stride,
                  "ty_hi": nty - 1 if stride > 1 else kw["ty_lo"] + rows - 1}
        if "tx_lo" in kw:
            window.update(tx_lo=kw["tx_lo"], tx_hi=kw["tx_lo"] + ntx - 1)
    tx0, ty0, span_x, spans, _ = raster_tiled._tile_spans(setup, 128, th, **window)
    sorted_tri, _, _ = raster_tiled._build_bins(tx0, ty0, span_x, spans, max(total, 1),
                                               ntx, nty)
    res = {"ids": np.asarray(ids), "start": np.asarray(sa), "counts": np.asarray(ca),
           "sorted_tri": np.asarray(sorted_tri)[:total],
           "totals": np.array([int(tot), int(na)]), "tx0": np.asarray(tx0),
           "ty0": np.asarray(ty0), "span_x": np.asarray(span_x), "spans": np.asarray(spans)}
    if "n_vary" in r:
        for stats in (False, True):
            d, wn, v, ev = raster_pallas._pallas_call_sparse_jit(
                kernel_ids, sa, ca, records, jnp.asarray(r["depth_tiles"]), ntx, nty, th, 128,
                int(r["n_vary"]), True, collect_stats=stats, **_band_place(r, th))
            res.update({f"depth_{int(stats)}": np.asarray(d),
                        f"winner_{int(stats)}": np.asarray(wn),
                        f"vary_{int(stats)}": np.asarray(v)})
            if stats:
                res["ev"] = np.asarray(ev)
    return res


def _jax_pre_fine(r):
    """``raster_fine._pre_fine_jit`` at exact capacities (the port's
    totals), over the request's band if it names one: active tiles, their
    row segments and every slot's triangle id, decoded from record column
    16 (lane-row 1, lanes 0-7)."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_fine

    p, w, h = scene_pass(str(r["scene"]), "jax")
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    pairs, rows, active = int(r["pairs"]), int(r["rows"]), int(r["active"])
    ntx, nty = _band_grid(r, w, h, int(r["th"]))
    out = raster_fine._pre_fine_jit(
        attrs, dict(p.uniforms), p.shader, w, h, pairs, rows,
        1 << max(rows - 1, 0).bit_length(), active, int(r["th"]), 128, **_band_kw(r))
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
                ntx, nty, int(r["th"]), 128, int(r["n_vary"]), True,
                collect_stats=stats, **_band_place(r, int(r["th"])))
            res.update({f"depth_{int(stats)}": np.asarray(d)[:active],
                        f"winner_{int(stats)}": np.asarray(wn)[:active],
                        f"vary_{int(stats)}": np.asarray(v)[:active]})
            if stats:
                res["ev"] = np.asarray(ev)[:active]
    return res


def _jax_pre_fine2(r):
    """``raster_fine2._pre_fine2_jit`` at exact capacities (the port's
    totals), over the request's band if it names one: the groups, their
    slot origins and strips, the active-tile map and every slot's triangle
    id (record column 16); with ``n_vary`` also ``_init_strips_jit`` on
    ``depth_tiles`` and ``_fine2_call_jit`` on this pre-stage (at the
    band's origin), pass-local with the varyings and init-seeded with
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
                                      th, 128, **_band_kw(r))
    origin = _band_place(r, th).get("origin")
    res = {"ids": np.asarray(ids), "src": np.asarray(src), "live": np.asarray(live),
           "group_start": np.asarray(start_g), "group_rows": np.asarray(rows_g),
           "x0y0": np.asarray(x0y0), "sid_of": np.asarray(sid_of)[:groups],
           "slots": np.asarray(rec)[:rows, 1, 0:8].astype(np.int32),
           "totals": np.array([int(pt), int(rt), int(ng), int(na)])}
    if "n_vary" in r:
        init = raster_fine2._init_strips_jit(jnp.asarray(r["depth_tiles"]), sid_of, groups,
                                             th)
        d, wn, v, _ = raster_fine2._fine2_call_jit(start_g, rows_g, rec, x0y0, th,
                                                   int(r["n_vary"]), True, origin=origin)
        de, we, _, ev = raster_fine2._fine2_call_jit(start_g, rows_g, rec, x0y0, th, 0, True,
                                                     origin=origin, collect_stats=True,
                                                     init_g=init)
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
    """``shadows.render_with_shadows`` of the blocker scene at (w, h,
    size), with stats, on ``backend`` (default "tiled": the tiled route's
    loop) in ``mode``: the map and the frame."""
    from tinyrenderder_tpu import math3d, shadows

    key = math3d.normalized(math3d.vec3(*SHADOW_KEY))
    scene = blocker_scene("jax", int(r["w"]), int(r["h"]))
    with _tiles_loop(str(r["mode"])):
        res, smap = shadows.render_with_shadows(
            scene, key, shadows.ShadowSettings(size=int(r["size"])),
            backend=str(r.get("backend", "tiled")), collect_stats=True)
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


def _jax_passes(scene):
    """The JAX package's pass tuples of a scene, as its sharded route
    builds them."""
    from tinyrenderder_tpu import scene as scene_mod
    from tinyrenderder_tpu.utils.stats import RenderStats
    passes = []
    for p in scene_mod._cull_passes(scene, True, RenderStats()):
        attrs, uniforms = scene_mod._pass_inputs(scene, p, np.float32, device=True)
        passes.append((attrs, p.shader, uniforms, p.exclude_from_output_depth))
    return passes


def _jax_row_costs(r):
    """``dist.measure_tile_row_costs`` of a ``sharded_scene``."""
    from tinyrenderder_tpu.parallel import dist
    w, h = int(r["w"]), int(r["h"])
    passes = _jax_passes(sharded_scene(str(r["scene"]), "jax", w, h))
    return {"costs": dist.measure_tile_row_costs(passes, w, h, int(r["th"]))}


def _clear_sharded():
    from tinyrenderder_tpu.parallel import dist
    for store in (dist._SHARD_FUSED_CAPS, dist._SHARD_FUSED_PENDING,
                  dist._SHARD_FUSED_REFINED, dist._SHARD_FUSED_W_REFINED):
        store.clear()


def _jax_sharded(r):
    """``dist.render_frame_fused_sharded`` (op "sharded_frame") or
    ``render_frame_fused_image_sharded`` (op "sharded_image": the scene's
    first pass) of a ``sharded_scene`` on ``n`` virtual devices (a grid of
    ``n_cols`` columns, or row bands: ``interleave``, ``bands``), in
    ``mode``: the rank-ordered tile planes and the output depth tiles, then
    ``tiles_to_buffers_sharded`` and ``untile_one_sharded``; or the
    image."""
    from tinyrenderder_tpu.parallel import dist
    w, h, n, n_cols = (int(r[k]) for k in ("w", "h", "n", "n_cols"))
    passes = _jax_passes(sharded_scene(str(r["scene"]), "jax", w, h))
    mesh = dist.make_mesh_grid(n // n_cols, n_cols) if n_cols > 1 else dist.make_mesh(n)
    layout = {"interleave": bool(r["interleave"]),
              "bands": tuple(map(tuple, r["bands"].tolist())) if "bands" in r else None}
    with _tiles_loop(str(r["mode"])):
        _clear_sharded()
        if str(r["op"]) == "sharded_image":
            image, _ = dist.render_frame_fused_image_sharded(mesh, passes[:1], w, h,
                                                              **layout)
            return {"image": np.asarray(image)}
        ft, od, _ = dist.render_frame_fused_sharded(mesh, passes, w, h, **layout)
        fb = dist.tiles_to_buffers_sharded(mesh, ft, w, h, **layout)
        out_depth = dist.untile_one_sharded(mesh, od, w, h, **layout)
        _clear_sharded()
    return {"color_t": np.asarray(ft.color), "depth_t": np.asarray(ft.depth),
            "winner_t": np.asarray(ft.winner), "out_depth_t": np.asarray(od),
            "color": np.asarray(fb.color), "depth": np.asarray(fb.depth),
            "winner": np.asarray(fb.winner), "out_depth": np.asarray(out_depth)}


def _jax_sharded_scene(r):
    """``Scene.render(backend)`` with stats and ``Scene.render_image(backend)``
    of a ``sharded_scene`` on every virtual device, as the JAX package
    routes them.  Only the "head" scene is one colour pass; any other's
    image is the frame's colour (``scene.render_scene_image``, which
    renders the frame again), so it is taken from the frame."""
    kind = str(r["scene"])
    scene = sharded_scene(kind, "jax", int(r["w"]), int(r["h"]))
    backend = str(r["backend"])
    _clear_sharded()
    _clear_capacities()        # the triangle-sharded frame's capacities
    res = scene.render(backend=backend)
    out = {k: np.asarray(getattr(res, k)) for k in ("color", "depth", "full_depth")}
    out.update(stats=stats_vector(res.stats),
               image=np.asarray(scene.render_image(backend)) if kind == "head"
               else out["color"])
    _clear_sharded()
    return out


def _jax_geometry(r):
    """``dist.render_frame_geometry_tiles`` of a ``sharded_scene`` (its
    passes cut by ``cut_passes`` where ``cut`` is given) on ``n`` virtual
    devices, then ``tiles_to_buffers`` and the output depth untiled and
    cropped: the tile planes, the buffers and the output depth."""
    from tinyrenderder_tpu.ops import raster_sparse
    from tinyrenderder_tpu.parallel import dist
    w, h, n = int(r["w"]), int(r["h"]), int(r["n"])
    passes = _jax_passes(sharded_scene(str(r["scene"]), "jax", w, h))
    if "cut" in r:
        passes = cut_passes(passes, r["cut"].tolist())
    _clear_capacities()
    ft, od = dist.render_frame_geometry_tiles(dist.make_mesh(n), passes, w, h)
    fb = raster_sparse.tiles_to_buffers(ft, w, h)
    out_depth = raster_sparse._untile_one_jit(od, -(-w // 128), -(-h // 16), 16, 128,
                                              True)[:h, :w]
    _clear_capacities()
    return {"color_t": np.asarray(ft.color), "depth_t": np.asarray(ft.depth),
            "winner_t": np.asarray(ft.winner), "out_depth_t": np.asarray(od),
            "color": np.asarray(fb.color), "depth": np.asarray(fb.depth),
            "winner": np.asarray(fb.winner), "out_depth": np.asarray(out_depth)}


def _jax_animation(r):
    """``animation.render_animation(backend)`` of the 3-mesh scene
    (``multimesh_scene``) at (w, h), ``frames`` frames of a full orbit, on
    every virtual device: the frames as their TGA files decode."""
    import tempfile

    from tinyrenderder_tpu import animation
    from tinyrenderder_tpu.utils import tga
    w, h, n = int(r["w"]), int(r["h"]), int(r["frames"])
    _clear_sharded()
    _clear_capacities()
    with tempfile.TemporaryDirectory() as d:
        animation.render_animation(multimesh_scene("jax", w, h), animation.AnimationConfig(
            frames=n, backend=str(r["backend"]), outdir=d))
        frames = np.stack([tga.read(os.path.join(d, f"frame_{i:04d}.tga")).to_rgb()
                           for i in range(n)])
    _clear_sharded()
    _clear_capacities()
    return {"frames": frames}


def view_pass(eye_z: float, w: int, h: int, side: str):
    """One side's OraclePass of the standard head (normal-mapped Phong)
    seen from (0, 0, ``eye_z``): tests/test_parallel.py's far and near
    views of a moving camera."""
    from helpers import default_view
    view, proj = default_view(eye=(0, 0, eye_z), aspect=w / h)
    return make_pass(standard_meshes(side)["head"], make_shader("phong", side), view, proj,
                     side)


def _jax_view_frame(r):
    """``raster_sparse.render_frame_fused`` (interpret mode, 16-row tiles)
    of ``view_pass`` and ``tiles_to_buffers``: the single-device frame."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster_sparse
    w, h = int(r["w"]), int(r["h"])
    p = view_pass(float(r["eye_z"]), w, h, "jax")
    attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
    _clear_capacities()
    ft, _, overflow = raster_sparse.render_frame_fused(
        [(attrs, p.shader, dict(p.uniforms), False)], w, h, tile_h=16, strict_capacity=True,
        interpret=True)
    assert not bool(overflow)
    fb = raster_sparse.tiles_to_buffers(ft, w, h, 16)
    return {k: np.asarray(getattr(fb, k)) for k in ("color", "depth", "winner")}


def _jax_post(r):
    from tinyrenderder_tpu.ops import post
    zimg, ao, final = post.postprocess_device(r["color"], r["depth"])
    return {"zimg": np.asarray(zimg), "ao": np.asarray(ao), "final": np.asarray(final)}


def _script(name: str):
    """A module of ``scripts/`` loaded from its file (they are not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_strip_proto(r):
    """``scripts/experimental_fine_raster.py``: ``build_strip_records`` and
    ``strip_rasterize(interpret=True)`` on a setup."""
    import jax.numpy as jnp

    mod = _script("experimental_fine_raster")
    setup = {k: jnp.asarray(r[k]) for k in ("valid", "screen", "ndc_z", "clip_w", "bbox")}
    w, h = int(r["w"]), int(r["h"])
    recs, rows, _, _ = mod.build_strip_records(setup, w, h)
    depth, winner, _ = mod.strip_rasterize(setup, jnp.asarray(r["init"]), w, h,
                                           interpret=True)
    return {"recs": recs, "rows": rows, "depth": np.asarray(depth),
            "winner": np.asarray(winner)}


def _jax_rank(r):
    """``scripts/experimental_rank_kernel.py::rank_pairs_kernel(interpret=True)``."""
    import jax.numpy as jnp

    mod = _script("experimental_rank_kernel")
    strips, ranks = mod.rank_pairs_kernel(
        *(jnp.asarray(r[k]) for k in ("tx0", "ty0", "span_x", "spans")), int(r["nsx"]), True)
    return {"strips": np.asarray(strips), "ranks": np.asarray(ranks)}


def _jax_inplace(r):
    """``scripts/probe_inplace_blocks.py``: the probe runs when loaded (it
    has no main guard; interpret mode, as its argv is not "tpu"), then its
    ``run`` on the request's image and ids."""
    import runpy

    import jax.numpy as jnp

    g = runpy.run_path(os.path.join(ROOT, "scripts", "probe_inplace_blocks.py"))
    out = g["run"](jnp.asarray(r["img"]), jnp.asarray(r["ids"]), float(r["add"]),
                   int(r["a_cap"]))
    return {"probe_img": np.asarray(g["img"]), "probe_out": np.asarray(g["out"]),
            "out": np.asarray(out)}


#: the scan backend's chain of passes (tests/test_torch_scan.py): (mesh of
#: ``standard_meshes``, shader kind), each pass seeded with the frame the
#: ones before it left; "depth" is a depth-only pass
SCAN_CHAIN = (("sphere", "gouraud"), ("head", "phong"), ("soup", "depth"), ("soup", "flat"),
              ("cube", "textured"))


def scan_chain(side: str, w: int, h: int) -> list:
    """One side's OraclePasses of ``SCAN_CHAIN`` under ``default_view`` at
    the frame's aspect."""
    from helpers import default_view
    view, proj = default_view(aspect=w / h)
    meshes = standard_meshes(side)
    return [make_pass(meshes[mesh], make_shader(kind, side), view, proj, side)
            for mesh, kind in SCAN_CHAIN]


def _jax_setup(r) -> dict:
    import jax.numpy as jnp
    return {k: jnp.asarray(r[k]) for k in ("valid", "screen", "ndc_z", "clip_w", "bbox")}


def _jax_scan_resolve(r):
    """``raster.depth_resolve_xla`` of a setup at (w, h) in chunks of
    ``chunk``, seeded with ``init`` (and ``init_winner``) and at global
    pixel (x0, y0) where the request has them; on a whole frame also
    ``raster.pass_events_xla`` (seeded with ``init`` alone)."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster
    setup = _jax_setup(r)
    h, w, chunk = int(r["h"]), int(r["w"]), int(r["chunk"])
    init = jnp.asarray(r["init"]) if "init" in r else None
    init_w = jnp.asarray(r["init_winner"]) if "init_winner" in r else None
    x0, y0 = int(r.get("x0", 0)), int(r.get("y0", 0))
    d, wn = raster.depth_resolve_xla(setup, h, w, chunk=chunk, init_depth=init,
                                     init_winner=init_w, x0=x0, y0=y0)
    out = {"depth": np.asarray(d), "winner": np.asarray(wn)}
    if x0 == 0 and y0 == 0:
        init = jnp.full((h, w), jnp.inf, jnp.float32) if init is None else init
        d, wn, frags, mn, mx = raster.pass_events_xla(setup, init, h, w, chunk=chunk)
        out.update(ev_depth=np.asarray(d), ev_winner=np.asarray(wn),
                   ev=np.array([float(frags), float(mn), float(mx)]))
    return out


def _jax_scan_chain(r):
    """``SCAN_CHAIN`` through ``raster.render_pass_xla`` in chunks of
    ``chunk``, winner ids offset by the faces before: the frame after each
    pass."""
    import jax.numpy as jnp

    from tinyrenderder_tpu.ops import raster
    w, h, chunk = int(r["w"]), int(r["h"]), int(r["chunk"])
    fb = raster.new_framebuffers(w, h)
    out, offset = {}, 0
    for i, p in enumerate(scan_chain("jax", w, h)):
        attrs = {k: jnp.asarray(v) for k, v in p.attrs.items()}
        fb, _ = raster.render_pass_xla(fb, attrs, p.shader, p.uniforms, winner_offset=offset,
                                       chunk=chunk)
        offset += attrs["position"].shape[0]
        out.update({f"color_{i}": np.asarray(fb.color), f"depth_{i}": np.asarray(fb.depth),
                    f"winner_{i}": np.asarray(fb.winner)})
    return out


def _jax_scan_scene(r):
    """``Scene.render(backend="xla")`` of a ``FRAMES`` scene with stats,
    ``render_scene_image(backend="xla")``, and the ``pass_timings`` keys
    of the "xla" and "tiled" frames (the tiled route off the TPU), in
    order."""
    from tinyrenderder_tpu import scene as scene_mod
    name = str(r["scene"])
    res = frame_scene(name, "jax").render(backend="xla", collect_stats=True)
    tiled = frame_scene(name, "jax").render(backend="tiled", collect_stats=True)
    out = {k: np.asarray(getattr(res, k)) for k in ("color", "depth", "full_depth")}
    out.update(stats=stats_vector(res.stats), keys=np.array(list(res.pass_timings)),
               tiled_keys=np.array(list(tiled.pass_timings)),
               image=np.asarray(scene_mod.render_scene_image(frame_scene(name, "jax"),
                                                             backend="xla")))
    return out


def _jax_real_asset(r):
    """``scripts/gen_real_asset.py``: the 27,360-face head written to
    ``dir``, and the JAX CLI on it with ``--backend oracle``: its four
    files' bytes."""
    mod = _script("gen_real_asset")
    d, out_dir = str(r["dir"]), os.path.join(str(r["dir"]), "jax_oracle")
    os.makedirs(out_dir)
    mod.render_cli(mod.generate(d), out_dir, backend="oracle")
    return {f: np.frombuffer(open(os.path.join(out_dir, f"{f}.tga"), "rb").read(), np.uint8)
            for f in ("phong", "zbuffer", "ao", "final")}


def _main(req_path, out_path):
    import jax
    jax.config.update("jax_platforms", "cpu")
    ops = {"bins": _jax_bins, "raster": _jax_raster, "untile": _jax_untile,
           "untile3": _jax_untile3, "compact_image": _jax_compact_image,
           "tiles_to_buffers": _jax_tiles_to_buffers, "image": _jax_image, "scene": _jax_scene,
           "post": _jax_post, "pre_fine": _jax_pre_fine, "pre_fine2": _jax_pre_fine2,
           "shadows": _jax_shadows, "dense": _jax_dense, "strip_proto": _jax_strip_proto,
           "rank": _jax_rank, "inplace": _jax_inplace, "pre_sparse": _jax_pre_sparse,
           "row_costs": _jax_row_costs, "sharded_frame": _jax_sharded,
           "sharded_image": _jax_sharded, "sharded_scene": _jax_sharded_scene,
           "geometry_frame": _jax_geometry, "view_frame": _jax_view_frame,
           "animation": _jax_animation, "scan_resolve": _jax_scan_resolve,
           "scan_chain": _jax_scan_chain, "scan_scene": _jax_scan_scene,
           "real_asset": _jax_real_asset}
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
