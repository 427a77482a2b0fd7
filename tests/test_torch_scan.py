"""The port's scan backend (``backend="xla"``) against the JAX package's.

JAX side in one subprocess for the module (tests/torch_parity.py says
why): ``raster.depth_resolve_xla`` and ``raster.pass_events_xla`` on
setups the port side makes, ``raster.render_pass_xla`` over a chain of
passes (``torch_parity.SCAN_CHAIN``: a pass seeded by the ones before, a
depth-only pass), and ``Scene.render(backend="xla")`` and
``render_scene_image`` of the 3-pass scene with the ``pass_timings`` keys
of its "xla" and "tiled" frames.  The port's other "xla" frames (the
scene whose eyes come last, the shadowed frame, a 3-frame orbit) are
held against its tiled frames and the float32 oracle, which the other
test files hold against the JAX package.

Tolerances: depth, winner and the exact events bitwise; colour under
``torch_parity.assert_colour``'s rule (the port's is the float32 NumPy
oracle's bitwise; it equals the JAX package's except where that leaves
the oracle, by at most 1 LSB); the port's "xla" frame equals its "tiled"
frame bitwise, stats included.  Chunk sizes 1, 8 and 5 (no divisor of
any face count here) give one result on both sides.

The kernel's decomposition, ``raster.scan_resolve_split_plain`` (the
super-block lists, each walk block's list, the walk in list order), is
held bitwise against the JAX package's scan on synthetic passes (a z-tie
pile, triangles over several super-blocks, invalid and off-screen ones, a
band at y0 != 0, a ragged frame, a seeded depth and winner, an empty
pass) at several walk blocks and super-blocks, and a property test holds
each block's list to the pass's triangles filtered by the block's bbox
test, in order.

Tests marked ``cuda`` hold the kernel (``csrc/scan_resolve.cu``) against
the plain scan, the split plain version and its lists, and skip where no
GPU is present."""

import logging
import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from torch_parity import (SHADOW_KEY, assert_bits, assert_colour, blocker_scene,
                          frame_scene, launches, multimesh_scene, run_jax, scan_chain,
                          scene_pass, stats_vector)
from tinyrenderder_tpu_torch import animation, cli, convert, math3d, oracle, shadows
from tinyrenderder_tpu_torch import scene as tscene
from tinyrenderder_tpu_torch.ops import raster, raster_tiled, semantics
from tinyrenderder_tpu_torch.utils import tga

CPU = "cpu"
W, H = 128, 96
CHUNKS = (1, 8, 5)
#: resolve cases: (scene of torch_parity.SCENES, seeded with a running depth,
#: band (y0, rows) or None, faces kept (all where None))
RESOLVE = {"head": ("head_phong", False, None, None),
           "head_seeded": ("head_phong", True, None, None),
           "soup_seeded": ("soup_phong_ragged", True, None, None),
           "head_band": ("head_phong", True, (24, 40), None),
           "empty_seeded": ("head_phong", True, None, 0)}
#: split plain cases: (pass: a synthetic soup of ``_soup`` or "head", width,
#: height, seeded with a running depth and winner, band (y0, rows) or None)
SPLIT = {"tie_pile": ("tie_pile", 256, 256, False, None),
         "spanning": ("spanning", 256, 256, False, None),
         "offscreen": ("offscreen", 256, 192, False, None),
         "band": ("spanning", 256, 256, True, (52, 150)),
         "ragged": ("head", 200, 136, False, None),
         "seeded": ("spanning", 256, 256, True, None),
         "empty": ("empty", 256, 256, True, None)}
#: (walk block width, height, super-block side) in pixels the split plain
#: version is held at: 32x32 blocks, one, four and sixteen a super-block,
#: and the other walk blocks the kernel can be built with
GEOMETRIES = [raster.ScanGeometry(*g) for g in
              ((32, 32, 32), (32, 32, 64), (32, 32, 128), (8, 32, 128), (16, 16, 64))]
ORBIT_W, ORBIT_H, ORBIT_FRAMES = 128, 64, 3
SHADOW_SIZE = 64


def _setup(name: str, faces):
    """The port's triangle setup of a scene pass at (W, H), its faces cut
    to ``faces`` when given (numpy)."""
    p, _, _ = scene_pass(name)
    attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, CPU)
    if faces is not None:
        attrs = {k: v[:faces] for k, v in attrs.items()}
    setup, _ = raster_tiled.vertex_stage(attrs, uniforms, p.shader, W, H)
    return {k: v.numpy() for k, v in setup.items()}


def _init_depth(seed: int = 5) -> np.ndarray:
    """A running depth, half of it finite, in the NDC range."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.2, 1.0, (H, W)).astype(np.float32)
    d[rng.random((H, W)) < 0.5] = np.inf
    return d


def _resolve_request(case: str, chunk: int) -> dict:
    name, seeded, band, faces = RESOLVE[case]
    req = {"op": "scan_resolve", "h": H, "w": W, "chunk": chunk, **_setup(name, faces)}
    if seeded:
        req["init"] = _init_depth()
    if band is not None:
        y0, rows = band
        req.update(h=rows, y0=y0)
        if seeded:
            req["init"] = req["init"][y0:y0 + rows]
    return req


def _soup(kind: str, w: int, h: int, seed: int = 3) -> dict:
    """A synthetic pass's setup at (w, h) as numpy: clip-space triangles
    (w = 1, so clip is NDC) made from ``seed``, set up by the port's
    triangle setup.  "tie_pile": random triangles, then four triangles 25
    times each and a fan of 30 at one depth (exact z ties); "spanning":
    200 small triangles with 12 that cross the frame among them;
    "offscreen": triangles around and past the frame's edges, with some
    behind the eye, beyond the far plane or facing away; "empty": none."""
    rng = np.random.default_rng(seed)

    def tris(n, size, centre=1.1):
        c = rng.uniform(-centre, centre, (n, 1, 2))
        xy = c + rng.uniform(-size, size, (n, 3, 2))
        cross = ((xy[:, 1, 0] - xy[:, 0, 0]) * (xy[:, 2, 1] - xy[:, 0, 1])
                 - (xy[:, 1, 1] - xy[:, 0, 1]) * (xy[:, 2, 0] - xy[:, 0, 0]))
        xy[cross < 0] = xy[cross < 0][:, [0, 2, 1]]          # front-facing
        z = rng.uniform(-0.9, 0.9, (n, 3, 1))
        return np.concatenate([xy, z, np.ones((n, 3, 1))], axis=2)

    if kind == "tie_pile":
        fan = tris(30, 0.4, 0.2)
        fan[..., 2] = 0.25
        clip = np.concatenate([tris(40, 0.2), np.repeat(tris(4, 0.5, 0.3), 25, axis=0), fan])
    elif kind == "spanning":
        clip = np.concatenate([tris(200, 0.08), tris(12, 1.6, 0.3)])
        clip = clip[rng.permutation(len(clip))]
    elif kind == "offscreen":
        clip = tris(160, 0.3, 1.6)
        clip[:10, :, 3] = -1.0                               # behind the eye
        clip[10:20, :, 2] = 1.5                              # beyond the far plane
        clip[20:40] = clip[20:40][:, [0, 2, 1]]              # facing away
    else:
        clip = np.zeros((0, 3, 4))
    vp = torch.as_tensor(math3d.viewport(0, 0, w, h), dtype=torch.float32)
    setup = semantics.triangle_setup_planes(torch.from_numpy(clip.astype(np.float32)), vp, w, h)
    return {k: v.numpy() for k, v in setup.items()}


def _split_request(case: str) -> dict:
    """A ``SPLIT`` case as a JAX request (chunks of 8): the setup, the
    running depth and winner where seeded (a band's rows of them)."""
    kind, w, h, seeded, band = SPLIT[case]
    if kind == "head":
        p, _, _ = scene_pass("head_phong")
        attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, CPU)
        setup = {k: v.numpy() for k, v in
                 raster_tiled.vertex_stage(attrs, uniforms, p.shader, w, h)[0].items()}
    else:
        setup = _soup(kind, w, h)
    req = {"op": "scan_resolve", "h": h, "w": w, "chunk": 8, **setup}
    if seeded:
        rng = np.random.default_rng(11)
        d = rng.uniform(-0.2, 1.0, (h, w)).astype(np.float32)
        d[rng.random((h, w)) < 0.5] = np.inf
        req["init"] = d
        req["init_winner"] = rng.integers(-1, 300, (h, w)).astype(np.int32)
    if band is not None:
        y0, rows = band
        req.update(h=rows, y0=y0)
        for k in ("init", "init_winner"):
            if k in req:
                req[k] = req[k][y0:y0 + rows]
    return req


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    req = {f"resolve_{c}_{k}": _resolve_request(c, k) for c in RESOLVE for k in CHUNKS}
    req.update({f"split_{c}": _split_request(c) for c in SPLIT})
    req["chain"] = {"op": "scan_chain", "w": W, "h": H, "chunk": 8}
    req["scene"] = {"op": "scan_scene", "scene": "multimesh"}
    return run_jax(req, tmp_path_factory.mktemp("jax_scan"))


def _tensors(req: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(req[k]))
            for k in ("valid", "screen", "ndc_z", "clip_w", "bbox")}


# ---------------------------------------------------------------------------
# phase A: the resolve and the exact events
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("case", list(RESOLVE))
def test_resolve_matches_jax(jax_side, case, chunk):
    """``depth_resolve_xla`` (seeded, in a row band at y0) and
    ``pass_events_xla`` (depth, winner, frags, min_z, max_z) bitwise the
    JAX package's, and the same for every chunk size."""
    req = _resolve_request(case, chunk)
    setup = _tensors(req)
    init = torch.from_numpy(req["init"]) if "init" in req else None
    want = jax_side[f"resolve_{case}_{chunk}"]
    depth, winner = raster.depth_resolve_xla(setup, req["h"], W, chunk, init_depth=init,
                                             y0=req.get("y0", 0))
    assert_bits(depth.numpy(), want["depth"], f"{case} depth")
    assert_bits(winner.numpy(), want["winner"], f"{case} winner")
    first = jax_side[f"resolve_{case}_1"]
    assert_bits(want["depth"], first["depth"], f"{case} JAX depth, chunk {chunk} vs 1")
    assert_bits(want["winner"], first["winner"], f"{case} JAX winner, chunk {chunk} vs 1")
    if RESOLVE[case][2] is not None:
        return
    if init is None:
        init = torch.full((H, W), torch.inf)
    d, wn, frags, min_z, max_z = raster.pass_events_xla(setup, init, H, W, chunk)
    assert_bits(d.numpy(), want["ev_depth"], f"{case} events depth")
    assert_bits(wn.numpy(), want["ev_winner"], f"{case} events winner")
    assert frags.dtype == torch.int32
    got = np.array([float(frags), float(min_z), float(max_z)])
    assert_bits(got, want["ev"], f"{case} frags, min_z, max_z")
    assert_bits(want["ev"], first["ev"], f"{case} JAX events, chunk {chunk} vs 1")
    if case != "empty_seeded":
        assert frags > 0 and np.isfinite(got[1:]).all()


def test_resolve_band_is_the_frames_rows(jax_side):
    """A row band at y0, seeded with the frame's rows, resolves the frame's
    rows (the whole frame in the JAX package, sliced)."""
    y0, rows = RESOLVE["head_band"][2]
    whole = jax_side["resolve_head_seeded_8"]
    band = jax_side["resolve_head_band_8"]
    assert_bits(band["depth"], whole["depth"][y0:y0 + rows], "band depth")
    assert_bits(band["winner"], whole["winner"][y0:y0 + rows], "band winner")


def test_resolve_on_a_device_without_a_kernel_raises():
    """Neither a CPU tensor nor a CUDA one: the wrapper refuses it, and
    runs no plain version in its place."""
    setup = _tensors(_resolve_request("head", 8))
    meta = {k: v.to("meta") for k, v in setup.items()}
    with pytest.raises(ValueError, match="no scan resolve"):
        raster.depth_resolve_xla(meta, H, W)
    with pytest.raises(ValueError, match="no scan resolve"):
        raster.pass_events_xla(meta, torch.full((H, W), torch.inf, device="meta"), H, W)


# ---------------------------------------------------------------------------
# the kernel's decomposition: super-block lists, block lists, the walk
# ---------------------------------------------------------------------------

def _split_inputs(req: dict):
    """(setup, running depth or None, running winner or None) tensors."""
    init = torch.from_numpy(req["init"]) if "init" in req else None
    init_w = torch.from_numpy(req["init_winner"]) if "init_winner" in req else None
    return _tensors(req), init, init_w


@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: "{}x{}in{}".format(*g))
@pytest.mark.parametrize("case", list(SPLIT))
def test_split_plain_matches_jax(jax_side, case, geom):
    """``scan_resolve_split_plain`` at each walk block and super-block:
    depth and winner bitwise the JAX package's ``depth_resolve_xla``
    (seeded with a depth and a winner, in a band at y0); with stats the
    event count, max z and the pass's min z bitwise its ``pass_events_xla``
    (a band's, which the JAX function has no y0 for: the port's chunked
    scan's)."""
    req = _split_request(case)
    setup, init, init_w = _split_inputs(req)
    h, w, y0 = req["h"], req["w"], req.get("y0", 0)
    want = jax_side[f"split_{case}"]
    depth, winner = raster.scan_resolve_split_plain(setup, h, w, init, init_w, y0=y0,
                                                    geom=geom)
    assert_bits(depth.numpy(), want["depth"], f"{case} depth")
    assert_bits(winner.numpy(), want["winner"], f"{case} winner")
    seed = init if init is not None else torch.full((h, w), torch.inf)
    d, wn, frags, max_z = raster.scan_resolve_split_plain(setup, h, w, seed, y0=y0,
                                                          collect_stats=True, geom=geom)
    assert frags.dtype == torch.int32
    min_z = torch.where(wn >= 0, d, torch.inf).amin()
    got = np.array([float(frags), float(min_z), float(max_z)])
    if y0 == 0:
        assert_bits(d.numpy(), want["ev_depth"], f"{case} events depth")
        assert_bits(wn.numpy(), want["ev_winner"], f"{case} events winner")
        assert_bits(got, want["ev"], f"{case} frags, min_z, max_z")
    else:
        ev = raster.pass_events_xla_plain(setup, seed, h, w, y0=y0)
        for a, b, what in zip((d, wn), ev[:2], ("depth", "winner")):
            assert_bits(a.numpy(), b.numpy(), f"{case} events {what}")
        assert_bits(got, np.array([float(ev[2]), float(ev[3]), float(ev[4])]),
                    f"{case} frags, min_z, max_z")
    if case != "empty":
        assert frags > 0


@pytest.mark.parametrize("case", ["tie_pile", "spanning", "offscreen"])
def test_soups_hold_what_their_cases_name(case):
    """The synthetic passes hold what the cases are for: the tie pile's
    copies share their depths, the spanning soup has triangles that cross
    super-blocks of 4 blocks, the off-screen soup has invalid triangles and
    bboxes cut at the frame's edges."""
    _, w, h, _, _ = SPLIT[case]
    s = _soup(case, w, h)
    valid, bbox = s["valid"], s["bbox"]
    assert valid.sum() > 20
    if case == "tie_pile":
        assert (s["ndc_z"][40:140:25] == s["ndc_z"][64:140:25]).all()
    elif case == "spanning":
        wide = (bbox[:, 1] // 128 > bbox[:, 0] // 128) & (bbox[:, 3] // 128 > bbox[:, 2] // 128)
        assert (wide & valid).sum() >= 3
    else:
        assert (~valid).sum() >= 40
        edge = (bbox[:, 0] == 0) | (bbox[:, 1] == w - 1) | (bbox[:, 2] == 0) | (bbox[:, 3] == h - 1)
        assert (edge & valid).sum() >= 5


@settings(max_examples=40, deadline=None, derandomize=True, database=None)
@given(data=st.data())
def test_block_lists_are_the_stream_filtered_in_order(data):
    """Each super-block's list holds the valid triangles whose bbox meets
    its rectangle cut to the buffer, and each walk block's list the valid
    triangles that pass the whole-stream walk's bbox test of the block
    (the block's rectangle cut to the buffer), both in submission order,
    for random bboxes, buffers (a band at (x0, y0)) and geometries."""
    f = data.draw(st.integers(0, 60), "faces")
    h, w = data.draw(st.integers(1, 150), "height"), data.draw(st.integers(1, 150), "width")
    x0, y0 = data.draw(st.integers(0, 20), "x0"), data.draw(st.integers(0, 40), "y0")
    geom = raster.ScanGeometry(data.draw(st.sampled_from((8, 16, 32)), "block_w"),
                               data.draw(st.sampled_from((8, 16, 32)), "block_h"),
                               32 * data.draw(st.integers(1, 5), "super-block"))
    rng = np.random.default_rng(data.draw(st.integers(0, 2**32 - 1), "seed"))
    fw, fh = x0 + w + 30, y0 + h + 30            # the frame the bboxes are clamped to
    lo_x, lo_y = rng.integers(0, fw, f), rng.integers(0, fh, f)
    bbox = np.stack([lo_x, np.minimum(lo_x + rng.integers(0, 90, f), fw - 1),
                     lo_y, np.minimum(lo_y + rng.integers(0, 90, f), fh - 1)], 1)
    valid = rng.random(f) < 0.8
    setup = {"valid": torch.from_numpy(valid), "bbox": torch.from_numpy(bbox.astype(np.int32))}
    lengths, lists = raster.scan_super_lists_plain(setup, h, w, x0, y0, geom)
    blocks = raster.scan_block_lists_plain(lengths, lists, h, w, geom)
    bw, bh, p = geom
    nbx, nby = -(-w // bw), -(-h // bh)

    def stream(cx0, cx1, cy0, cy1):    # buffer-local columns and rows, inclusive
        return [i for i in range(f) if valid[i] and bbox[i, 0] <= x0 + cx1
                and bbox[i, 1] >= x0 + cx0 and bbox[i, 2] <= y0 + cy1 and bbox[i, 3] >= y0 + cy0]

    for b in range(nbx * nby):
        by, bx = divmod(b, nbx)
        got = blocks[b][blocks[b] >= 0].tolist() if blocks.shape[1] else []
        assert got == stream(bx * bw, min(bx * bw + bw, w) - 1, by * bh,
                             min(by * bh + bh, h) - 1), f"block {b}"
    nsx = -(-nbx // (p // bw))
    for s, n in enumerate(lengths.tolist()):
        sy, sx = divmod(s, nsx)
        assert lists[s, :n, 0].tolist() == stream(sx * p, min(sx * p + p, w) - 1, sy * p,
                                                  min(sy * p + p, h) - 1), f"super-block {s}"


def test_plain_geometry_is_the_kernels():
    """``SCAN_GEOMETRY``, the plain versions' default, is the geometry
    ``csrc/scan_resolve.cu`` is built with (the wrapper asks the library)."""
    src = (Path(raster.__file__).parent.parent / "csrc" / "scan_resolve.cu").read_text()
    c = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert "kBlockH = kRowStep * kPixY" in src and "kRowStep = kThreads / kBlockW" in src
    assert raster.SCAN_GEOMETRY == (c["kBlockW"], c["kThreads"] // c["kBlockW"] * c["kPixY"],
                                    c["kSuperPx"])


# ---------------------------------------------------------------------------
# a pass: render_pass_xla
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def chain_oracle() -> list:
    """The float32 oracle's frame after each pass of the chain."""
    frame = oracle.OracleFrame(color=np.zeros((H, W, 3), np.uint8),
                               zbuffer=np.full((H, W), np.inf, np.float32))
    out = []
    for p in scan_chain("port", W, H):
        oracle.render_pass(frame, p, W, H, dtype=np.float32)
        out.append((frame.color.copy(), frame.zbuffer.copy()))
    return out


@pytest.mark.parametrize("chunk", CHUNKS)
def test_render_pass_matches_jax(jax_side, chain_oracle, chunk):
    """Each pass of the chain seeded with the frame before it, in chunks
    of ``chunk``: depth and winner bitwise the JAX package's (chunks of
    8), colour under ``assert_colour``; the depth-only pass leaves the
    colour as it was."""
    fb = raster.new_framebuffers(W, H, CPU)
    want = jax_side["chain"]
    offset = 0
    for i, p in enumerate(scan_chain("port", W, H)):
        attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, CPU)
        before = fb.color
        fb, setup, events = raster.render_pass_xla(fb, attrs, p.shader, uniforms, offset,
                                                   chunk)
        assert events is None and setup["valid"].shape[0] == attrs["position"].shape[0]
        offset += attrs["position"].shape[0]
        assert_bits(fb.depth.numpy(), want[f"depth_{i}"], f"pass {i} depth")
        assert_bits(fb.winner.numpy(), want[f"winner_{i}"], f"pass {i} winner")
        assert_bits(fb.depth.numpy(), chain_oracle[i][1], f"pass {i} depth vs the oracle")
        assert_colour(fb.color.numpy(), want[f"color_{i}"], chain_oracle[i][0],
                      f"pass {i} colour")
        if not p.shader.writes_color:
            assert fb.color is before
    assert (fb.winner >= 0).sum() > 0.2 * H * W


def test_render_pass_stats_are_the_oracles(chain_oracle):
    """With ``collect_stats`` the pass's one resolve also returns its exact
    events: the chain's summed fragments and z range are the oracle's, and
    the frame is the one without stats."""
    fb = fb0 = raster.new_framebuffers(W, H, CPU)
    frags, lo, hi = 0, math.inf, -math.inf
    want = oracle.render_passes(scan_chain("port", W, H), W, H, dtype=np.float32)
    for p in scan_chain("port", W, H):
        attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, CPU)
        fb, _, ev = raster.render_pass_xla(fb, attrs, p.shader, uniforms,
                                           collect_stats=True)
        fb0, _, _ = raster.render_pass_xla(fb0, attrs, p.shader, uniforms)
        for a, b in zip(fb, fb0):
            assert torch.equal(a, b)
        frags += int(ev.fragments)
        if math.isfinite(float(ev.min_z)):
            lo, hi = min(lo, float(ev.min_z)), max(hi, float(ev.max_z))
    assert (frags, lo, hi) == (want.stats.fragments_drawn, want.stats.min_z, want.stats.max_z)


# ---------------------------------------------------------------------------
# the frame: Scene.render, render_scene_image, shadows, the orbit
# ---------------------------------------------------------------------------

def _same_frame(got, want, what):
    for k in ("color", "depth", "full_depth"):
        assert_bits(getattr(got, k).numpy(), getattr(want, k).numpy(), f"{what} {k}")
    assert got.stats == want.stats, what


def test_scene_matches_jax(jax_side):
    """``Scene.render(backend="xla")`` of the 3-pass scene (the eyes
    excluded in the middle): bitwise the JAX package's depth planes, its
    colour under ``assert_colour``, equal stats; ``render_image`` the
    JAX package's ``render_scene_image(backend="xla")`` under the same
    rule."""
    got = frame_scene("multimesh").render(CPU, backend="xla")
    want = jax_side["scene"]
    ref = tscene.oracle_render(frame_scene("multimesh"))
    for k in ("depth", "full_depth"):
        assert_bits(getattr(got, k).numpy(), want[k], k)
    assert_colour(got.color.numpy(), want["color"], ref.color, "colour")
    assert_bits(stats_vector(got.stats), want["stats"], "stats")
    image = frame_scene("multimesh").render_image(CPU, backend="xla")
    assert_colour(image.numpy(), want["image"], ref.color, "render_scene_image")


@pytest.mark.parametrize("name", ["multimesh", "cli_default"])
def test_scene_is_the_tiled_frame_and_the_oracles(name):
    """``Scene.render(backend="xla")`` of the 3-pass scenes (the eyes
    excluded in the middle, and last): bitwise the port's tiled frame and
    the float32 oracle, stats equal, with and without stats; the image
    route's colour the same."""
    sc = frame_scene(name)
    got = sc.render(CPU, backend="xla")
    ref = tscene.oracle_render(frame_scene(name))
    for k in ("color", "depth", "full_depth"):
        assert_bits(getattr(got, k).numpy(), getattr(ref, k), f"{name} {k} vs the oracle")
    assert got.stats == ref.stats
    _same_frame(got, sc.render(CPU, backend="tiled"), f"{name} xla vs tiled")
    no_stats = sc.render(CPU, backend="xla", collect_stats=False)
    for k in ("color", "depth", "full_depth"):
        assert torch.equal(getattr(no_stats, k), getattr(got, k))
    image = sc.render_image(CPU, backend="xla")
    assert_bits(image.numpy(), got.color.numpy(), f"{name} render_image")


@pytest.mark.parametrize("backend", ["tiled", "xla"])
def test_pass_timings_are_keyed_by_pass_as_in_jax(jax_side, backend):
    """With stats, ``pass_timings`` holds each visible pass's host seconds
    under its name, in pass order: the JAX package's keys on both of its
    backends; without stats it is empty."""
    sc = multimesh_scene("port", 160, 96)
    res = sc.render(CPU, backend=backend)
    want = jax_side["scene"]
    keys = [str(k) for k in want["keys"]]
    assert keys == [str(k) for k in want["tiled_keys"]] == ["head", "eyes", "room"]
    assert list(res.pass_timings) == keys
    assert all(isinstance(v, float) and v >= 0 for v in res.pass_timings.values())
    assert sc.render(CPU, backend=backend, collect_stats=False).pass_timings == {}


@pytest.mark.parametrize("shadowed", [False, True])
def test_cli_logs_a_line_per_pass(shadowed, tmp_path, caplog):
    """``cli --backend xla`` (with ``--shadows``) writes the tiled CLI's
    files, and on both backends logs one ``pass <name>`` line per pass of
    the default scene, in order, as the JAX CLI does."""
    files = {}
    for backend in ("tiled", "xla"):
        out = tmp_path / backend
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="tinyrenderder_tpu_torch.cli"):
            assert cli.run(["--device", CPU, "--backend", backend, "--width", "96", "--height",
                            "64", "--outdir", str(out)]
                           + (["--shadows", "--shadow-size", "64"] if shadowed else [])) == 0
        lines = [r.getMessage().split()[1] for r in caplog.records
                 if r.name == "tinyrenderder_tpu_torch.cli"
                 and r.getMessage().lstrip().startswith("pass ")]
        assert lines == ["sponza", "head", "eyes"], backend
        files[backend] = {f.name: f.read_bytes() for f in sorted(out.iterdir())}
    assert files["xla"] == files["tiled"] and len(files["xla"]) == 4


def test_shadowed_frame_is_the_tiled_frame_and_the_oracles():
    """``render_with_shadows(backend="xla")``: the map (a depth-only scan
    pass) and the lit frame bitwise the port's tiled shadowed frame and
    the float32 oracle of both passes, stats equal."""
    key = math3d.normalized(math3d.vec3(*SHADOW_KEY))
    settings = shadows.ShadowSettings(size=SHADOW_SIZE)
    res, smap = shadows.render_with_shadows(blocker_scene("port", W, H), key, settings, CPU,
                                            backend="xla")
    tiled, tmap = shadows.render_with_shadows(blocker_scene("port", W, H), key, settings,
                                              CPU)
    ref, ref_map = shadows.oracle_render_with_shadows(blocker_scene("port", W, H), key,
                                                      settings)
    assert_bits(smap.numpy(), tmap.numpy(), "map vs tiled")
    assert_bits(smap.numpy(), ref_map, "map vs the oracle")
    for k in ("color", "depth", "full_depth"):
        assert_bits(getattr(res, k).numpy(), getattr(ref, k), f"{k} vs the oracle")
    assert res.stats == ref.stats
    _same_frame(res, tiled, "shadowed xla vs tiled")
    assert int(torch.isfinite(smap).sum()) > 0


def test_orbit_is_the_tiled_orbit_and_the_oracles(tmp_path):
    """A 3-frame orbit of the 3-mesh scene through
    ``animation.render_animation(backend="xla")``: the tiled orbit's files
    byte for byte, and each frame the f32 oracle's at its eye."""
    files = {}
    for backend in ("xla", "tiled"):
        d = tmp_path / backend
        cfg = animation.AnimationConfig(frames=ORBIT_FRAMES, backend=backend, device=CPU,
                                        outdir=str(d))
        summary = animation.render_animation(multimesh_scene("port", ORBIT_W, ORBIT_H), cfg)
        assert summary["frames_rendered"] == ORBIT_FRAMES
        files[backend] = {f.name: f.read_bytes() for f in sorted(d.iterdir())}
    assert files["xla"] == files["tiled"]
    sc = multimesh_scene("port", ORBIT_W, ORBIT_H)
    eye, target = sc.camera.params.eye.copy(), sc.camera.params.target.copy()
    for i in range(ORBIT_FRAMES):
        sc.camera.set_eye(animation.orbit_eye(eye, target, 2 * math.pi * i / ORBIT_FRAMES))
        frame = tga.read(str(tmp_path / "xla" / f"frame_{i:04d}.tga")).to_rgb()[::-1]
        assert_bits(frame, tscene.oracle_render(sc).color, f"frame {i}")


# ---------------------------------------------------------------------------
# the kernel on the card (skipped without a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RESOLVE))
def test_cuda_resolve_matches_plain(cuda_device, case):
    """One launch each, with and without the event sums: bitwise the plain
    scan's depth, winner and events."""
    req = _resolve_request(case, 8)
    setup = _tensors(req)
    init = torch.from_numpy(req["init"]) if "init" in req else None
    y0 = req.get("y0", 0)
    want = raster.depth_resolve_xla_plain(setup, req["h"], W, 8, init, y0=y0)
    dev = {k: v.to(cuda_device) for k, v in setup.items()}
    init_d = None if init is None else init.to(cuda_device)
    before = launches("scan_resolve"), launches("scan_resolve_stats")
    got = raster.depth_resolve_xla(dev, req["h"], W, init_depth=init_d, y0=y0)
    init_e = init_d if init_d is not None else torch.full((req["h"], W), torch.inf,
                                                          device=cuda_device)
    ev = raster.pass_events_xla(dev, init_e, req["h"], W, y0=y0)
    ev_want = raster.pass_events_xla_plain(setup, init_e.cpu(), req["h"], W, y0=y0)
    torch.cuda.synchronize()
    launched = int(setup["valid"].shape[0] > 0)
    assert (launches("scan_resolve"), launches("scan_resolve_stats")) == (before[0] + launched,
                                                        before[1] + launched)
    for g, w, what in zip((*got, *ev), (*want, *ev_want),
                          ("depth", "winner", "events depth", "events winner", "frags",
                           "min_z", "max_z")):
        assert_bits(g.cpu().numpy(), w.numpy(), f"{case} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SPLIT))
def test_cuda_resolve_matches_the_split_plain_version(cuda_device, case):
    """The kernel, with and without the event sums, bitwise the split
    plain version at the library's geometry (seeded with a depth
    and a winner, in a band at y0), and its super-block lists the plain
    lists up to each length."""
    req = _split_request(case)
    setup, init, init_w = _split_inputs(req)
    h, w, y0 = req["h"], req["w"], req.get("y0", 0)
    geom = raster.kernel_geometry()
    dev = {k: v.to(cuda_device) for k, v in setup.items()}
    on = (lambda t: None if t is None else t.to(cuda_device))  # noqa: E731
    got = raster.depth_resolve_xla(dev, h, w, init_depth=on(init), init_winner=on(init_w),
                                   y0=y0)
    want = raster.scan_resolve_split_plain(setup, h, w, init, init_w, y0=y0, geom=geom)
    seed = init if init is not None else torch.full((h, w), torch.inf)
    ev = raster.pass_events_xla(dev, on(seed), h, w, y0=y0)
    ev_want = raster.scan_resolve_split_plain(setup, h, w, seed, y0=y0, collect_stats=True,
                                              geom=geom)
    for g, wt, what in zip((*got, *ev[:3], ev[4]), (*want, *ev_want),
                           ("depth", "winner", "events depth", "events winner", "frags",
                            "max_z")):
        assert_bits(g.cpu().numpy(), wt.numpy(), f"{case} {what}")
    if setup["valid"].shape[0]:
        lengths, lists = raster.scan_lists(dev, h, w, y0=y0)
        p_len, p_lists = raster.scan_super_lists_plain(setup, h, w, y0=y0, geom=geom)
        assert_bits(lengths.cpu().numpy(), p_len.numpy(), f"{case} list lengths")
        for s_, n in enumerate(p_len.tolist()):
            assert_bits(lists[s_, :n].cpu().numpy(), p_lists[s_, :n].numpy(), f"{case} list {s_}")
