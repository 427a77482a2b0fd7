"""Scenes and their entry points: the tiled frame and the image route.

Counterpart of ``tinyrenderder_tpu/scene.py``: the scene description
(``ScenePass``, ``Scene`` with its ``render`` and ``render_image``,
``RenderResult``), the per-model frustum cull (main.cpp:623-736) and the
per-pass inputs (``build_uniforms`` and the face attributes, in NumPy),
then ``render_scene`` (the tiled backend's frame loop, and the scan
backend's, "xla": ``ops.raster.render_pass_xla`` a pass) and
``render_scene_image``; ``ops.raster_sparse`` renders.  The backends
"sharded", "sharded-2d" and "sharded-measured" split the frame, and
"sharded-geometry" each pass's faces, over the ranks of a process group
(``parallel.dist``) with the JAX package's routing (``_render_sharded``).
``oracle_render`` is the scene on the NumPy oracle (``_render_oracle``),
the bitwise reference.

A pass's inputs reach the device once and are reused, as the JAX package
keeps them: the face attributes on the mesh
(``Mesh.device_face_attributes``), the finished uniform tensors on the
pass (``_device_pass_inputs``, keyed on the matrices by value and on the
material's textures and the shader's state by reference or value,
``shaders.Shader.uniforms_token``), and the large uniform arrays in a
byte-bounded LRU (``_to_device_cached``).  Every key holds the device.
Nothing downstream writes into a cached tensor or dict.

Every shader class of the JAX package has its device half here; a
shader class the port does not know raises ``NotImplementedError``, and
nothing falls back to another route.  A depth-only pass (the shadow
map's light pass, ``shadows.py``) renders depth and shades nothing.
"""

from __future__ import annotations

import logging
import time
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np
import torch

from tinyrenderder_tpu_torch import convert, math3d, oracle, shaders, trace
from tinyrenderder_tpu_torch.camera import Camera
from tinyrenderder_tpu_torch.math3d import Frustum
from tinyrenderder_tpu_torch.models import procedural
from tinyrenderder_tpu_torch.models.mesh import Mesh
from tinyrenderder_tpu_torch.ops import raster, raster_sparse
from tinyrenderder_tpu_torch.ops.raster_tiled import TILE_H, TILE_W, cdiv
from tinyrenderder_tpu_torch.shaders import (EyeShader, GouraudShader, PhongShader,
                                             Shader, TexturedShader)
from tinyrenderder_tpu_torch.utils.stats import RenderStats

log = logging.getLogger("tinyrenderder_tpu_torch.scene")

__all__ = ["ScenePass", "Scene", "RenderResult", "BACKENDS", "render_scene",
           "render_passes", "render_passes_xla", "render_scene_image", "pass_tensors",
           "clear_caches", "oracle_render", "headline_scene",
           "multimesh_scene", "stress_scene", "mixed_scene"]


@dataclass
class ScenePass:
    """One model submission: mesh + model matrix + shader (a
    main.cpp:647-668 render block)."""

    mesh: Mesh
    model_matrix: np.ndarray
    shader: Shader
    name: str = ""
    material_index: int = 0
    #: rendered into colour, but its depth writes leave the frame's OUTPUT
    #: depth: the reference's eye pass (z-buffer snapshot before, restore
    #: after, main.cpp:700,730), so SSAO sees the depth without the eyes
    exclude_from_output_depth: bool = False


@dataclass
class RenderResult:
    color: object                # (H, W, 3) uint8 RGB
    depth: object                # (H, W) float, the output depth (after restore)
    full_depth: object           # (H, W) float, excluded passes included
    stats: RenderStats
    pass_timings: dict = field(default_factory=dict)


@dataclass
class Scene:
    """A renderable scene description (camera + passes)."""

    camera: Camera
    width: int
    height: int
    passes: list[ScenePass] = field(default_factory=list)

    def add(self, mesh: Mesh, model_matrix, shader: Shader, **kw) -> ScenePass:
        p = ScenePass(mesh=mesh, model_matrix=np.asarray(model_matrix, dtype=np.float64),
                      shader=shader, **kw)
        self.passes.append(p)
        return p

    def world_aabbs(self) -> list:
        return [p.mesh.get_world_aabb(p.model_matrix) for p in self.passes]

    def describe(self) -> str:
        """Scene-analysis text in the spirit of main.cpp:545-579."""
        lines = ["=== Scene Analysis ==="]
        for p in self.passes:
            c = p.mesh.get_center()
            wc = p.mesh.get_world_aabb(p.model_matrix).center()
            lines.append(f"  {p.name or p.mesh.name}: local center "
                         f"({c[0]:.4f}, {c[1]:.4f}, {c[2]:.4f}) world center "
                         f"({wc[0]:.4f}, {wc[1]:.4f}, {wc[2]:.4f}) "
                         f"faces {p.mesh.nfaces}")
        return "\n".join(lines)

    def render(self, device="cuda", frustum_cull: bool = True, collect_stats: bool = True,
               backend: str = "tiled", mesh=None, dtype=np.float32,
               shadows=None) -> RenderResult:
        """The frame: ``render_scene`` on ``device`` (the card unless the
        caller asks for ``"cpu"``) with ``backend`` "tiled", "xla" or one of
        the sharded backends (over ``mesh``, see ``render_scene``), or
        ``oracle_render`` in ``dtype`` with ``backend="oracle"`` (float64
        reproduces the reference's double math).  The device backends
        render in float32 and refuse any other ``dtype``.

        ``shadows``, a pair ``(light_dir, settings)`` (the world direction
        the shadow-casting light comes from, and a
        ``shadows.ShadowSettings`` or None for its defaults), renders the
        two-pass shadow-mapped frame instead: ``shadows.render_with_shadows``
        on the device backends, ``shadows.oracle_render_with_shadows`` on
        the oracle; the lit pass's result is returned."""
        oracle = _backend(backend) == "oracle"
        if not oracle and np.dtype(dtype) != np.float32:
            raise ValueError(f"backend {backend!r} renders in float32, not {np.dtype(dtype)}")
        if shadows is not None:
            from tinyrenderder_tpu_torch import shadows as shadow_mapping
            light_dir, settings = shadows
            if oracle:
                return shadow_mapping.oracle_render_with_shadows(
                    self, light_dir, settings, frustum_cull, dtype)[0]
            return shadow_mapping.render_with_shadows(self, light_dir, settings, device,
                                                      frustum_cull, collect_stats, backend,
                                                      mesh)[0]
        if oracle:
            return oracle_render(self, frustum_cull, dtype)
        return render_scene(self, device, frustum_cull, collect_stats, backend, mesh)

    def render_image(self, device="cuda", frustum_cull: bool = True,
                     backend: str = "tiled", mesh=None):
        """The (H, W, 3) uint8 image: ``render_scene_image`` on ``device``,
        or the oracle's colour with ``backend="oracle"``."""
        if _backend(backend) == "oracle":
            return oracle_render(self, frustum_cull).color
        return render_scene_image(self, device, frustum_cull, backend, mesh)


#: the backends that split the frame (or, "sharded-geometry", each pass's
#: faces) over a process group's ranks
SHARDED_BACKENDS = ("sharded", "sharded-2d", "sharded-measured", "sharded-geometry")


#: every backend the port renders: the tiled frame, the scan ("xla"), the
#: NumPy oracle and the sharded backends
BACKENDS = ("tiled", "xla", "oracle") + SHARDED_BACKENDS


def _backend(backend: str) -> str:
    """``backend`` if the port renders it (``BACKENDS``)."""
    if backend in BACKENDS:
        return backend
    raise ValueError(f"unknown backend: {backend}")


# one-entry frustum cache: a render loop keeps the camera fixed or moves
# it every frame, and either way one entry suffices
_FRUSTUM_CACHE: tuple | None = None


def _frustum_cached(view_proj: np.ndarray) -> Frustum:
    global _FRUSTUM_CACHE
    key = view_proj.tobytes()
    hit = _FRUSTUM_CACHE
    if hit is not None and hit[0] == key:
        return hit[1]
    f = Frustum.from_matrix(view_proj)
    _FRUSTUM_CACHE = (key, f)
    return f


def _cull_passes(scene: Scene, frustum_cull: bool, stats: RenderStats) -> list:
    """Per-model frustum culling (main.cpp:623-736): the visible passes,
    with the model and triangle counts added to ``stats``.  The decision
    is cached on the scene (one entry, as the JAX package keeps it),
    keyed on the view-projection matrix and each pass's identity, mesh,
    face count, local AABB and model matrix."""
    with trace.span("frame.cull"):
        vp = scene.camera.projection_matrix @ scene.camera.view_matrix
        ckey = (vp.tobytes(), frustum_cull,
                tuple((id(p), id(p.mesh), p.mesh.nfaces, id(p.mesh.get_local_aabb()),
                       p.model_matrix.tobytes()) for p in scene.passes))
        hit = scene.__dict__.get("_cull_cache")
        if hit is not None and hit[0] == ckey:
            trace.count("cache.cull.hit")
            visible, culled = hit[1], hit[2]
        else:
            trace.count("cache.cull.miss")
            frustum = _frustum_cached(vp)
            visible, culled = [], []
            for p in scene.passes:
                if frustum_cull and not frustum.intersects(
                        p.mesh.get_world_aabb(p.model_matrix)):
                    culled.append(p)
                    log.info("%s CULLED by frustum", p.name or p.mesh.name)
                    continue
                visible.append(p)
            # visible + culled keep every pass of the key alive: no id recycles
            scene.__dict__["_cull_cache"] = (ckey, visible, culled)
        for p in culled:
            stats.models_culled += 1
            stats.culled_triangles += p.mesh.nfaces
        for p in visible:
            stats.models_rendered += 1
            stats.total_triangles += p.mesh.nfaces
        return list(visible)


def _pass_inputs(scene: Scene, p: ScenePass, dtype) -> tuple[dict, dict]:
    """A pass's face attributes and uniforms as NumPy arrays of ``dtype``
    (ModelView = view @ model, main.cpp:653)."""
    modelview = scene.camera.view_matrix @ p.model_matrix
    material = p.mesh.materials[p.material_index] if p.mesh.materials else None
    uniforms = p.shader.build_uniforms(modelview, scene.camera.projection_matrix,
                                       material, dtype)
    return p.mesh.face_attributes(dtype), uniforms


def _ref_tuples_match(a, b) -> bool:
    """Element-wise ``is`` of two same-length tuples (or two Nones): keys
    by identity that keep what they name alive, so no id is recycled."""
    if a is None or b is None:
        return a is b
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _device_pass_inputs(scene: Scene, p: ScenePass, device):
    """A pass's float32 (face attribute tensors, uniform tensors) on
    ``device``, reused while nothing they are built from changes: a
    one-entry cache on the pass keyed on the ModelView and projection by
    value and the device, the material and its four textures by
    reference, and the shader by identity and ``uniforms_token``.  A miss
    rebuilds the uniforms, sends the arrays the token takes by reference
    through ``_to_device_cached`` and uploads the small ones.  The
    returned dicts are shared across frames: callers never write into
    them."""
    with trace.span("frame.inputs"):
        dtype = np.float32
        dev = convert.device_key(device)
        modelview = scene.camera.view_matrix @ p.model_matrix
        persp = scene.camera.projection_matrix
        material = p.mesh.materials[p.material_index] if p.mesh.materials else None
        token = p.shader.uniforms_token()
        mtok = (None if material is None else
                (material, material.diffuse, material.normal, material.specular,
                 material.emission))
        key = (modelview.tobytes(), persp.tobytes(), dev)
        hit = p.__dict__.get("_device_inputs_cache")
        fresh = (hit is not None and hit[0] == key and _ref_tuples_match(hit[1], mtok)
                 and hit[2] is p.shader and shaders.tokens_match(hit[3], token))
        trace.count("cache.pass_inputs.hit" if fresh else "cache.pass_inputs.miss")
        if not fresh:
            uniforms = p.shader.build_uniforms(modelview, persp, material, dtype)
            uniforms = {k: (_to_device_cached(v, dev) if isinstance(v, np.ndarray)
                            and v.size >= shaders.TOKEN_VALUE_ELEMENTS
                            else convert.to_torch(v, dev)) for k, v in uniforms.items()}
            hit = (key, mtok, p.shader, token, uniforms)
            p.__dict__["_device_inputs_cache"] = hit
        return p.mesh.device_face_attributes(dtype, dev), hit[4]


#: large uniforms (textures, a host shadow map) on a device, keyed on the
#: host array's identity and the device: (array kept alive, tensor), in
#: order of last use
_DEVICE_UNIFORM_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()
#: the cache's bound, in host bytes of the arrays it holds
_DEVICE_UNIFORM_CACHE_BYTES = 256 << 20


def _to_device_cached(v, device):
    """A large uniform's tensor on ``device``, uploaded once: an LRU (a
    hit refreshes recency) bounded by total bytes, so one-shot arrays age
    out instead of evicting the long-lived textures the cache is for.
    Anything but an ndarray of ``shaders.TOKEN_VALUE_ELEMENTS`` or more
    passes through unchanged."""
    if not isinstance(v, np.ndarray) or v.size < shaders.TOKEN_VALUE_ELEMENTS:
        return v
    key = (id(v), convert.device_key(device))
    hit = _DEVICE_UNIFORM_CACHE.get(key)
    if hit is not None and hit[0] is v:
        trace.count("cache.uniforms.hit")
        _DEVICE_UNIFORM_CACHE.move_to_end(key)
        return hit[1]
    trace.count("cache.uniforms.miss")
    hit = (v, convert.to_torch(v, key[1]))     # v kept alive: its id stays valid
    _DEVICE_UNIFORM_CACHE[key] = hit
    total = sum(e[0].nbytes for e in _DEVICE_UNIFORM_CACHE.values())
    while total > _DEVICE_UNIFORM_CACHE_BYTES and len(_DEVICE_UNIFORM_CACHE) > 1:
        _, (old, _) = _DEVICE_UNIFORM_CACHE.popitem(last=False)
        total -= old.nbytes
    return hit[1]


def clear_caches(scene: Scene) -> None:
    """Drop every cache the scene's frames keep: the cull decision, each
    mesh's world AABB and face attribute tensors, each material's packed
    texture, each pass's uniform tensors and the large-uniform LRU.  The
    next frame builds and uploads everything again."""
    scene.__dict__.pop("_cull_cache", None)
    for p in scene.passes:
        p.__dict__.pop("_device_inputs_cache", None)
        p.mesh.invalidate_device_cache()
        p.mesh.__dict__.pop("_world_aabb_cache", None)
        for m in p.mesh.materials:
            m.__dict__.pop("_packed", None)
    _DEVICE_UNIFORM_CACHE.clear()


def _tensors(scene: Scene, p, device):
    if not shaders.supports(p.shader):
        raise NotImplementedError(
            f"{type(p.shader).__name__} has no device half in the port")
    attrs_t, uniforms_t = _device_pass_inputs(scene, p, device)
    return attrs_t, p.shader, uniforms_t, p.exclude_from_output_depth


def pass_tensors(scene: Scene, device, frustum_cull: bool = True) -> list:
    """The scene's visible passes as ``(attrs, shader, uniforms,
    exclude_from_output_depth)`` with tensors on ``device``: the host-side
    cull and the cached device inputs (``_device_pass_inputs``)."""
    visible = _cull_passes(scene, frustum_cull, RenderStats())
    return [_tensors(scene, p, device) for p in visible]


def render_scene(scene: Scene, device, frustum_cull: bool = True,
                 collect_stats: bool = True, backend: str = "tiled",
                 mesh=None) -> RenderResult:
    """Render every pass of ``scene`` on ``device``: into one tiled frame
    (the JAX package's ``render_scene(backend="tiled")``) or, with
    ``backend="xla"``, through the scan backend (``render_pass_xla`` a
    pass, the JAX package's ``render_scene(backend="xla")``), with the
    same pixels and stats.  ``color`` (H, W, 3) uint8, ``depth`` (the
    output depth: the snapshot when the frame ends inside a run of
    excluded passes) and ``full_depth`` are tensors on ``device``.  With
    ``collect_stats`` the ``RenderStats`` are exact (``fragments_exact``):
    each pass reads back its counters once, and ``pass_timings`` holds
    each visible pass's host seconds under its name (``p.name or
    p.mesh.name``), in pass order: the host time of its ``pass`` span
    (``trace``), its launches issued and not waited for, since nothing
    synchronizes.  On a CUDA device every kernel of the route runs on the
    card; on the CPU the kernels' plain versions run.

    The sharded backends split the frame (or each pass's faces) over
    ``mesh``'s ranks (default ``dist.make_mesh(device=device)``: the ranks
    of the initialised process group, each on its own card, or one rank)
    and render on the mesh's device, with the same pixels and stats
    (``_render_sharded``)."""
    with trace.frame():
        if _backend(backend) in SHARDED_BACKENDS:
            return _render_sharded(scene, device, frustum_cull, collect_stats, backend, mesh)
        device = convert.device_key(device)
        stats = RenderStats()
        visible = _cull_passes(scene, frustum_cull, stats)
        passes = [_tensors(scene, p, device) for p in visible]
        names = [p.name or p.mesh.name for p in visible]
        seconds = [] if collect_stats else None
        fb, depth, events = render_passes(passes, scene.width, scene.height, device,
                                          collect_stats, backend, seconds, names)
        timings = {}
        if collect_stats:
            _add_events(stats, events)
            timings = dict(zip(names, seconds, strict=True))
        return RenderResult(color=fb.color, depth=depth, full_depth=fb.depth,
                            stats=stats, pass_timings=timings)


def _add_events(stats: RenderStats, events) -> None:
    """Each pass's counters into ``stats``: the triangle count and bbox of
    its setup, its exact fragment count and z range (one readback a
    pass)."""
    with trace.span("frame.stats"):
        for ev in events:
            agg = raster.pass_stats(ev.setup)
            stats.triangles_rasterized += agg["triangles"]
            if agg["valid_triangles"]:
                stats.merge_bbox(agg["min_x"], agg["min_y"], agg["max_x"], agg["max_y"])
            frags, min_z, max_z = trace.readback(torch.stack(
                [ev.fragments.double(), ev.min_z.double(), ev.max_z.double()]))
            stats.fragments_drawn += int(frags)
            if np.isfinite(min_z):
                stats.merge_z(min_z, max_z)
        stats.fragments_exact = True


#: the sharded backends interleave the row bands (rank b owns tile rows b,
#: b + N, ...), which spreads coverage hot spots over the ranks; False: the
#: contiguous layout (the same pixels)
SHARDED_INTERLEAVE = True


def _sharded_mesh(device, mesh, backend: str, width: int, height: int):
    """The mesh a sharded backend renders over: ``mesh`` (its device must
    be of ``device``'s type) or ``dist.make_mesh(device=device)``, as row
    bands, or for "sharded-2d" as the most-square grid of blocks that
    tiles the frame (``_pick_grid``) when it has more than one column."""
    from tinyrenderder_tpu_torch.parallel import dist
    if mesh is None:
        mesh = dist.make_mesh(device=device)
    elif torch.device(device).type != mesh.device.type:
        raise ValueError(f"the mesh renders on {mesh.device}, not {device}")
    if backend == "sharded-2d":
        grid = _pick_grid(mesh.size, width, height, TILE_H, TILE_W)
        if grid is not None and grid[1] > 1:
            return mesh.as_grid(*grid)
    return mesh.as_rows()


def _pick_grid(n_dev: int, width: int, height: int, th: int, tw: int):
    """Most-square (n_rows, n_cols) factorization of ``n_dev`` whose
    blocks tile-align with the frame, or None."""
    best = None
    for n_cols in range(1, n_dev + 1):
        if n_dev % n_cols:
            continue
        n_rows = n_dev // n_cols
        if height % (n_rows * th) or width % (n_cols * tw):
            continue
        score = abs(n_rows - n_cols)
        if best is None or score < best[0]:
            best = (score, n_rows, n_cols)
    return None if best is None else best[1:]


def _sharded_layout(scene: Scene, passes, mesh, backend: str):
    """(interleave, bands) of a sharded frame, as the JAX package routes
    it: measured bands for "sharded-measured" on more than one rank,
    ``even_unequal_bands`` when the frame's tile rows do not divide over
    the row bands, else interleaved rows (``SHARDED_INTERLEAVE``)."""
    from tinyrenderder_tpu_torch.parallel import dist
    n = mesh.size
    nty = cdiv(scene.height, TILE_H)
    bands = None
    if backend == "sharded-measured" and n > 1:
        bands = _measured_bands_cached(scene, passes, n)
    elif not mesh.two_d and n > 1 and nty % n:
        bands = dist.even_unequal_bands(nty, n)
    return SHARDED_INTERLEAVE and n > 1 and not mesh.two_d and bands is None, bands


def _render_sharded(scene: Scene, device, frustum_cull: bool, collect_stats: bool,
                    backend: str, mesh) -> RenderResult:
    """The frame with its tile rows (or, "sharded-2d", screen blocks) split
    over the mesh's ranks: ``dist.render_frame_fused_sharded``, then each
    band untiled and the frame assembled on every rank.  The same pixels
    and ``RenderStats`` as the tiled backend: each pass's triangle count
    and bbox from its whole setup, its fragments summed over the ranks'
    event planes and its z range their min and max.  A frame that is not
    tile-aligned renders with the tiled route's cdiv tiles, cropped.

    "sharded-geometry" splits each pass's faces over the ranks instead
    (``dist.render_frame_geometry_tiles``) and untiles the replicated
    frame.  A rank's running depth is not the frame's there, so with
    ``collect_stats`` the counters come from a replay of the passes
    through the one-rank stats route on the mesh's device (the JAX
    package's ``_accumulate_exact_events``)."""
    from tinyrenderder_tpu_torch.parallel import dist
    w, h = scene.width, scene.height
    mesh = _sharded_mesh(device, mesh, backend, w, h)
    stats = RenderStats()
    visible = _cull_passes(scene, frustum_cull, stats)
    passes = [_tensors(scene, p, mesh.device) for p in visible]
    t0 = time.perf_counter()
    if not passes:
        fb = raster.new_framebuffers(w, h, mesh.device)
        depth, events = fb.depth, []
    elif backend == "sharded-geometry":
        ft, out_depth_t = dist.render_frame_geometry_tiles(mesh, passes, w, h)
        fb, depth = _buffers(ft, out_depth_t, passes, w, h, TILE_H)
        events = (raster_sparse.render_frame_fused(passes, w, h, mesh.device, TILE_H,
                                                   collect_stats=True)[2]
                  if collect_stats else None)
    else:
        inter, bands = _sharded_layout(scene, passes, mesh, backend)
        ft, out_depth_t, events = dist.render_frame_fused_sharded(
            mesh, passes, w, h, interleave=inter, bands=bands, collect_stats=collect_stats)
        fb = dist.tiles_to_buffers_sharded(mesh, ft, w, h, interleave=inter, bands=bands)
        depth = (dist.untile_one_sharded(mesh, out_depth_t, w, h, interleave=inter,
                                         bands=bands)
                 if visible[-1].exclude_from_output_depth else fb.depth)
    timings = {}
    if collect_stats:
        _add_events(stats, events)
        timings["frame"] = time.perf_counter() - t0
    return RenderResult(color=fb.color, depth=depth, full_depth=fb.depth,
                        stats=stats, pass_timings=timings)


def _measured_bands_cached(scene: Scene, passes, n: int) -> tuple:
    """The measured-load partition of "sharded-measured"
    (``dist.balance_bands`` of the per-tile-row costs), cached on the
    scene, with the JAX package's rule of never blocking a frame on a
    re-measure.  The first frame of a shape (frame size, rank count)
    measures synchronously: bands of another shape would be illegal.
    After that, when a pass's attribute tensor or uniform dict changes
    identity (the per-pass caches rebuild them when anything they hold
    changes: every frame of an orbit), the re-measure is started on the
    device, its (nty,) int32 costs copied into pinned host memory without
    blocking and an event recorded, and the previous bands serve this
    frame.  A pending measurement is adopted at the start of the next
    frame, after its event: a fixed rule, where a poll of the event could
    come back ready on one rank and not on another, and the ranks would
    gather bands of different shapes.  The costs are exact integer counts
    over the replicated passes, so every rank computes the same bands;
    under motion they lag one frame.  Any legal partition gives the same
    pixels."""
    from tinyrenderder_tpu_torch.parallel import dist
    refs = tuple(x for a, _s, u, *_ in passes for x in (a["position"], u))
    shape = (scene.width, scene.height, n)
    cache = scene.__dict__.get("_band_cache")
    if cache is None or cache["shape"] != shape:
        costs = dist.measure_tile_row_costs(passes, scene.width, scene.height)
        cache = {"shape": shape, "refs": refs, "pending": None,
                 "bands": dist.balance_bands(costs, n)}
        scene.__dict__["_band_cache"] = cache
        return cache["bands"]
    if cache["pending"] is not None:
        costs, event = cache["pending"]
        if event is not None:
            event.synchronize()
        cache["bands"] = dist.balance_bands(costs.numpy().astype(np.int64), n)
        cache["pending"] = None
    if not _ref_tuples_match(cache["refs"], refs):
        costs = dist.measure_tile_row_costs_device(passes, scene.width, scene.height)
        event = None
        if costs.is_cuda:
            host = torch.empty(costs.shape, dtype=costs.dtype, pin_memory=True)
            host.copy_(costs, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(costs.device))
            costs = host
        cache["refs"], cache["pending"] = refs, (costs, event)
    return cache["bands"]


def render_passes(passes, width: int, height: int, device,
                  collect_stats: bool = False, backend: str = "tiled",
                  seconds: list | None = None, names: list | None = None):
    """The frame of ``render_scene`` from its pass tensors
    (``pass_tensors``) -> (FrameBuffers in image layout, output depth
    (H, W), per-pass events or None).  "tiled": the frame is tiled with
    ``pick_tile_h`` rows; the output depth of a frame that ends inside
    a run of excluded passes is the snapshot, untiled on its own.
    "xla": the scan backend (``render_passes_xla``).  ``seconds``, if
    given, receives each pass's host seconds and ``names`` name the
    passes' spans (``render_frame_fused``)."""
    if backend == "xla":
        return render_passes_xla(passes, width, height, device, collect_stats, seconds,
                                 names)
    if backend != "tiled":
        raise ValueError(f"render_passes renders 'tiled' or 'xla', not {backend!r}")
    with trace.frame():
        th = raster_sparse.pick_tile_h(width, height)
        ft, out_depth_t, events = raster_sparse.render_frame_fused(
            passes, width, height, device, tile_h=th, collect_stats=collect_stats,
            seconds=seconds, names=names)
        return (*_buffers(ft, out_depth_t, passes, width, height, th), events)


def render_passes_xla(passes, width: int, height: int, device,
                      collect_stats: bool = False, seconds: list | None = None,
                      names: list | None = None):
    """The scan backend's frame (the JAX package's ``_render_device`` with
    ``render_pass_xla``): each pass through ``raster.render_pass_xla`` in
    image layout, its triangle ids offset by the faces before it, the
    depth snapshot before the first pass of a run of excluded passes and
    restored before the next pass that is not excluded (main.cpp:700,730).
    A pass with no faces renders nothing.  With ``collect_stats`` each
    pass's one resolve also sums its z-pass events (``PassEvents``).
    Returns (FrameBuffers, output depth, events or None); ``seconds`` and
    ``names`` as in ``render_passes``."""
    with trace.frame():
        fb = raster.new_framebuffers(width, height, device)
        events = [] if collect_stats else None
        snapshot = None
        in_excluded = False
        winner_offset = 0
        for i, (attrs, shader, uniforms, exclude) in enumerate(passes):
            if exclude:
                if not in_excluded:
                    snapshot = fb.depth             # main.cpp:700 (never written in place)
                    in_excluded = True
            elif in_excluded:
                fb = fb._replace(depth=snapshot)    # main.cpp:730
                in_excluded = False
            t0 = time.perf_counter()
            f = attrs["position"].shape[0]
            with trace.span("pass", names[i] if names else i):
                if f:
                    if attrs["position"].device != fb.depth.device:
                        raise ValueError(f"pass inputs are on {attrs['position'].device}, "
                                         f"the frame on {fb.depth.device}")
                    fb, _, ev = raster.render_pass_xla(fb, attrs, shader, uniforms,
                                                       winner_offset,
                                                       collect_stats=collect_stats)
                    if collect_stats:
                        events.append(ev)
            if seconds is not None:
                seconds.append(time.perf_counter() - t0)
            winner_offset += f
        return fb, (snapshot if in_excluded else fb.depth), events


def _buffers(ft, out_depth_t, passes, width: int, height: int, tile_h: int):
    """A tiled frame -> (FrameBuffers, output depth (H, W)): the output
    depth of a frame that ends inside a run of excluded passes is the
    snapshot, untiled on its own."""
    with trace.span("frame.untile"):
        fb = raster_sparse.tiles_to_buffers(ft, width, height, tile_h=tile_h)
        if not (passes and passes[-1][3]):
            return fb, fb.depth
        return fb, raster_sparse.untile_image(out_depth_t, None, cdiv(width, TILE_W),
                                              cdiv(height, tile_h), tile_h, TILE_W, height,
                                              width)


def render_scene_image(scene: Scene, device, frustum_cull: bool = True,
                       backend: str = "tiled", mesh=None):
    """Render ``scene`` to an (H, W, 3) uint8 image tensor on ``device``.
    A frame of one non-empty colour pass goes straight to the image
    (``render_frame_fused_image``; on the "sharded" backend
    ``dist.render_frame_fused_image_sharded`` when the frame is
    tile-aligned); any other, a depth-only pass included, goes through
    ``render_scene`` and returns its colour, as the JAX package routes it
    (every frame of the "xla" backend too).  On a CUDA device every
    kernel runs on the card; on the CPU the kernels' plain versions run."""
    with trace.frame():
        backend = _backend(backend)
        visible = _cull_passes(scene, frustum_cull, RenderStats())
        single = (len(visible) == 1 and visible[0].mesh.nfaces > 0
                  and visible[0].shader.writes_color
                  and not visible[0].exclude_from_output_depth)
        w, h = scene.width, scene.height
        if single and backend == "tiled":
            device = convert.device_key(device)
            return raster_sparse.render_frame_fused_image(
                [_tensors(scene, visible[0], device)], w, h,
                tile_h=raster_sparse.pick_tile_h(w, h))
        if single and backend == "sharded" and h % TILE_H == 0 and w % TILE_W == 0:
            from tinyrenderder_tpu_torch.parallel import dist
            mesh = _sharded_mesh(device, mesh, backend, w, h)
            passes = [_tensors(scene, visible[0], mesh.device)]
            inter, bands = _sharded_layout(scene, passes, mesh, backend)
            return dist.render_frame_fused_image_sharded(mesh, passes, w, h,
                                                         interleave=inter, bands=bands)
        return render_scene(scene, device, frustum_cull, False, backend, mesh).color


def oracle_render(scene: Scene, frustum_cull: bool = True,
                  dtype=np.float32) -> RenderResult:
    """The scene on the NumPy oracle (the JAX package's
    ``render(backend="oracle")``), with the same snapshot/restore around
    excluded passes: the bitwise reference for ``render_scene`` and
    ``render_scene_image`` at float32.  NumPy arrays, exact stats."""
    stats = RenderStats()
    visible = _cull_passes(scene, frustum_cull, stats)
    frame = oracle.OracleFrame(
        color=np.zeros((scene.height, scene.width, 3), dtype=np.uint8),
        zbuffer=np.full((scene.height, scene.width), np.inf, dtype=dtype), stats=stats)
    snapshot = None
    in_excluded = False
    timings = {}
    for p in visible:
        attrs, uniforms = _pass_inputs(scene, p, dtype)
        if p.exclude_from_output_depth:
            if not in_excluded:
                snapshot = frame.zbuffer.copy()     # main.cpp:700
                in_excluded = True
        elif in_excluded:
            frame.zbuffer = snapshot.copy()         # main.cpp:730
            in_excluded = False
        t0 = time.perf_counter()
        oracle.render_pass(frame, oracle.OraclePass(attrs, p.shader, uniforms),
                           scene.width, scene.height, dtype=dtype)
        timings[p.name or p.mesh.name] = time.perf_counter() - t0
    return RenderResult(color=frame.color,
                        depth=snapshot if in_excluded else frame.zbuffer,
                        full_depth=frame.zbuffer, stats=stats, pass_timings=timings)


def _lights():
    key = math3d.normalized(math3d.vec3(1.0, 1.4, 1.0))
    fill = math3d.normalized(math3d.vec3(-0.3, 0.5, 0.2))
    rim = math3d.normalized(math3d.vec3(-1.0, 0.8, -1.5))
    return key, fill, rim


def _camera(width: int, height: int, eye) -> Camera:
    cam = Camera()
    cam.set_eye(math3d.vec3(*eye))
    cam.set_target(math3d.vec3(0, 0, 0))
    cam.set_fov(60.0)
    cam.set_aspect(width / height)
    cam.set_clipping(0.1, 50.0)
    return cam


def headline_scene(width: int = 2048, height: int = 2048, shader: str = "phong",
                   n_lat: int = 96, n_lon: int = 144) -> Scene:
    """The benchmark headline scene of ``bench.py::bench_single_pass``
    without importing the benchmark: the procedural bumpy head with a
    256² packed material, the bench camera and lights, one pass."""
    key, fill, rim = _lights()
    shader_obj = {
        "phong": lambda: PhongShader(key, fill, rim, normal_map_strength=0.5),
        "gouraud": lambda: GouraudShader(light_world=key),
        "textured": lambda: TexturedShader(light_world=key),
    }[shader]()
    head = procedural.bumpy_head(n_lat, n_lon)
    head.materials = [procedural.default_head_material(256)]
    scene = Scene(camera=_camera(width, height, (0, 0.4, 2.6)), width=width,
                  height=height)
    scene.add(head, math3d.identity4(), shader_obj, name="head")
    return scene


def multimesh_scene(width: int, height: int, head_lat: int = 64, head_lon: int = 96,
                    eye_lat: int = 12, eye_lon: int = 16) -> Scene:
    """The benchmark's 3-mesh scene, ``bench.py::_scene(meshes=3)``,
    without importing the benchmark: the bumpy head (normal-mapped
    Phong), the eyes (EyeShader, excluded from the output depth, the
    middle pass) and an inward-facing room (Phong, no normal map).  The
    mesh resolutions are the bench's by default; tests pass smaller
    ones."""
    key, fill, rim = _lights()
    scene = Scene(camera=_camera(width, height, (0, 0.6, 3.0)), width=width,
                  height=height)
    head = procedural.bumpy_head(head_lat, head_lon)
    head.materials = [procedural.default_head_material(256)]
    scene.add(head, math3d.identity4(),
              PhongShader(key, fill, rim, normal_map_strength=0.5), name="head")
    eyes = procedural.uv_sphere(eye_lat, eye_lon, radius=0.12, name="eyes")
    eyes.positions += np.array([0.35, 0.25, 0.8])
    eyes.finalize()
    eyes.materials = [procedural.default_head_material(64)]
    scene.add(eyes, math3d.identity4(), EyeShader(key, rim), name="eyes",
              exclude_from_output_depth=True)
    room = procedural.cube(size=12.0, name="room")
    room.faces = room.faces[:, ::-1].copy()
    room.finalize()
    room.materials = [procedural.default_head_material(128)]
    scene.add(room, math3d.identity4(),
              PhongShader(key, fill, rim, normal_map_strength=0.0), name="room")
    return scene


def _wall_scene(mesh: Mesh, width: int, height: int) -> Scene:
    """One normal-mapped Phong pass of ``mesh`` (its own 128² material)
    under the camera of ``bench.py::bench_stress`` / ``bench_mixed``."""
    key, fill, rim = _lights()
    scene = Scene(camera=_camera(width, height, (0, 0.3, 6.5)), width=width,
                  height=height)
    scene.add(mesh, math3d.identity4(), PhongShader(key, fill, rim, normal_map_strength=0.5),
              name=mesh.name)
    return scene


def stress_scene(width: int, height: int, grid: int = 3, n_lat: int = 96,
                 n_lon: int = 144) -> Scene:
    """The bench's Sponza-scale stress scene (``bench.py::bench_stress``):
    ``procedural.head_wall(grid)``, 246,240 faces at grid 3.  Tests pass a
    smaller grid and tessellation."""
    return _wall_scene(procedural.head_wall(grid, n_lat, n_lon), width, height)


def mixed_scene(width: int, height: int, grid: int = 3, n_lat: int = 96,
                n_lon: int = 144) -> Scene:
    """The bench's mixed-regime scene (``bench.py::bench_mixed``):
    ``procedural.mixed_interior(grid)``, the head wall and twelve giant
    room triangles in one mesh, 246,252 faces at grid 3."""
    return _wall_scene(procedural.mixed_interior(grid, n_lat, n_lon), width, height)
