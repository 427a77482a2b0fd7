"""The untile kernels' image stores against the JAX package.

``raster_sparse.untile_image`` (compact tiles gathered by id, cropped, the
colour unpacked) and ``untile3_image`` (the frame's three planes cropped,
the colour unpacked) on the CPU take their plain versions, held here
against the JAX package run as its own tests run it on the CPU (Pallas in
interpret mode, one subprocess for the module, tests/torch_parity.py):
``_compact_to_image(direct=False)`` cropped and through ``_unpack_rgb``,
and ``_tiles_to_buffers_jit``.  The frames are ragged: every tile height
the CUDA kernels compile for (8, 16, 32), widths that are not a multiple
of 16, heights that are not a multiple of the tile, an empty ``ids``.
Tolerance: bitwise.

Tests marked ``cuda`` compare each kernel entry with its plain version at
every instantiated tile height and at the generic kernel's shapes, and
skip where no GPU is present."""

import numpy as np
import pytest
import torch

from torch_parity import assert_bits, launches, reset_launches, run_jax, scene_pass
from tinyrenderder_tpu_torch import convert
from tinyrenderder_tpu_torch.ops import raster_fine, raster_fine2, raster_sparse

#: name -> (tile_h, width, height, share of tiles present); n_tiles_x and
#: n_tiles_y are cdiv(width, 128) and cdiv(height, tile_h)
FRAMES = {
    "th8_300x29": (8, 300, 29, 0.6),
    "th16_250x40": (16, 250, 40, 0.5),
    "th32_200x50": (32, 200, 50, 0.7),
    "th32_1000x70": (32, 1000, 70, 0.4),
    "th16_129x17_empty": (16, 129, 17, 0.0),
    "th16_256x32_full": (16, 256, 32, 1.0),
}
#: the CUDA kernel's shapes beyond FRAMES: (tile_h, tile_w, width, height);
#: tile_h 12 and tile_w 64, 200 take the generic kernel
CUDA_SHAPES = {
    **{name: (th, 128, w, h) for name, (th, w, h, _) in FRAMES.items()},
    "th12_255x30": (12, 128, 255, 30),
    "th16_tw64_190x31": (16, 64, 190, 31),
    "th8_tw200_397x12": (8, 200, 397, 12),
    "th32_2048x64": (32, 128, 2048, 64),
}


def _cdiv(a, b):
    return -(-a // b)


def _frame(th, tw, w, h, frac, seed):
    """Random tile planes of a w x h frame: packed colour over the full
    int32 range (the unpack drops the top byte), depth with inf, -0.0 and
    NaN, winner; and ascending ids of the present tiles."""
    rng = np.random.default_rng(seed)
    ntx, nty = _cdiv(w, tw), _cdiv(h, th)
    shape = (ntx * nty, th, tw)
    color = rng.integers(-2**31, 2**31 - 1, size=shape, dtype=np.int64).astype(np.int32)
    depth = rng.normal(size=shape).astype(np.float32)
    depth[0, 0, :4] = [np.inf, -np.inf, -0.0, np.nan]
    winner = rng.integers(-1, 5000, size=shape, dtype=np.int64).astype(np.int32)
    ids = np.flatnonzero(rng.random(ntx * nty) < frac).astype(np.int32)
    return {"planes": (color, depth, winner), "ids": ids, "ntx": ntx, "nty": nty,
            "th": th, "tw": tw, "w": w, "h": h}


@pytest.fixture(scope="module")
def frames():
    return {name: _frame(th, 128, w, h, frac, seed)
            for seed, (name, (th, w, h, frac)) in enumerate(FRAMES.items())}


@pytest.fixture(scope="module")
def jax_side(frames, tmp_path_factory):
    req = {}
    for name, f in frames.items():
        color, depth, winner = f["planes"]
        dims = {k: f[k] for k in ("ntx", "nty", "th", "tw", "w", "h")}
        req[f"{name}_compact"] = {"op": "compact_image", "tiles": color[f["ids"]],
                                  "ids": f["ids"], **dims}
        req[f"{name}_buffers"] = {"op": "tiles_to_buffers", "color": color, "depth": depth,
                                  "winner": winner, **dims}
    return run_jax(req, tmp_path_factory.mktemp("jax_untile"))


def _dims(f):
    return f["ntx"], f["nty"], f["th"], f["tw"], f["h"], f["w"]


@pytest.mark.parametrize("name", list(FRAMES))
@pytest.mark.parametrize("rgb", [True, False], ids=["rgb", "plane"])
def test_untile_image_matches_compact_to_image(frames, jax_side, name, rgb):
    """#2i's plain version == ``_compact_to_image`` cropped (and unpacked)."""
    f = frames[name]
    tiles = torch.from_numpy(np.ascontiguousarray(f["planes"][0][f["ids"]]))
    got = raster_sparse.untile_image(tiles, torch.from_numpy(f["ids"]), *_dims(f), rgb=rgb)
    assert_bits(got.numpy(), jax_side[f"{name}_compact"]["rgb" if rgb else "plane"], name)


@pytest.mark.parametrize("name", list(FRAMES))
def test_untile3_image_matches_tiles_to_buffers(frames, jax_side, name):
    """#3i's plain version == ``_tiles_to_buffers_jit``."""
    f = frames[name]
    got = raster_sparse.untile3_image(*(torch.from_numpy(x) for x in f["planes"]), *_dims(f))
    want = jax_side[f"{name}_buffers"]
    for k, g in zip(("color", "depth", "winner"), got):
        assert_bits(g.numpy(), want[k], k)


@pytest.mark.parametrize("name", list(FRAMES))
def test_tiles_to_buffers_is_untile3_image(frames, jax_side, name):
    f = frames[name]
    ft = raster_sparse.FrameTiles(*(torch.from_numpy(x) for x in f["planes"]))
    fb = raster_sparse.tiles_to_buffers(ft, f["w"], f["h"], f["th"])
    for k in ("color", "depth", "winner"):
        assert_bits(getattr(fb, k).numpy(), jax_side[f"{name}_buffers"][k], k)


@pytest.mark.parametrize("name", list(FRAMES))
def test_untile_image_depth_fill(frames, name):
    """A float32 plane gathered by id with +inf where a tile is absent,
    against the placement written out in NumPy."""
    f = frames[name]
    depth, ids = f["planes"][1], f["ids"]
    ntx, nty, th, tw, h, w = _dims(f)
    want = np.full((nty * th, ntx * tw), np.inf, np.float32)
    for k, t in enumerate(ids):
        want[(t // ntx) * th:(t // ntx + 1) * th, (t % ntx) * tw:(t % ntx + 1) * tw] = \
            depth[t]
    got = raster_sparse.untile_image(torch.from_numpy(np.ascontiguousarray(depth[ids])),
                                     torch.from_numpy(ids), *_dims(f), fill=torch.inf)
    assert got.is_contiguous()
    assert_bits(got.numpy(), want[:h, :w], name)


@pytest.mark.parametrize("name", list(FRAMES))
def test_untile_image_without_ids_is_the_cropped_untile(frames, name):
    """``ids`` None: every tile in order, the snapshot depth's store."""
    f = frames[name]
    ntx, nty, th, tw, h, w = _dims(f)
    x = torch.from_numpy(f["planes"][1])
    got = raster_sparse.untile_image(x, None, *_dims(f))
    assert_bits(got.numpy(),
                raster_sparse.untile_one_plain(x, ntx, nty, th, tw)[:h, :w].numpy(), name)


def test_unpack_drops_the_top_byte():
    packed = torch.tensor([[0x7F332211, -1, 0x00CCBBAA]], dtype=torch.int32)
    got = raster_sparse.untile_image(packed.reshape(1, 1, 3), None, 1, 1, 1, 3, 1, 3,
                                     rgb=True)
    assert got.tolist() == [[[0x11, 0x22, 0x33], [255, 255, 255], [0xAA, 0xBB, 0xCC]]]


@pytest.mark.parametrize("stage", ["pre_sparse", "pre_fine", "pre_fine2"])
def test_pre_stage_ids_are_ascending(stage):
    """The CUDA ``untile_image`` finds a tile's slot by binary search: every
    pre-stage must emit its active ids ascending and unique."""
    p, w, h = scene_pass("soup_phong_ragged")
    attrs, uniforms = convert.pass_to_torch(p.attrs, p.uniforms, "cpu")
    fn = {"pre_sparse": raster_sparse.pre_sparse, "pre_fine": raster_fine.pre_fine,
          "pre_fine2": raster_fine2.pre_fine2}[stage]
    ids = fn(attrs, uniforms, p.shader, w, h, 16, 128).ids
    assert ids.dtype == torch.int32 and ids.numel() > 1
    assert bool((ids[1:] > ids[:-1]).all())


def test_image_wrappers_validate_inputs():
    tiles = torch.zeros((6, 16, 128), dtype=torch.int32)
    depth = torch.zeros((6, 16, 128))
    ids = torch.arange(6, dtype=torch.int32)
    raster_sparse.untile_image(tiles, ids, 2, 3, 16, 128, 48, 256)
    raster_sparse.untile3_image(tiles, depth, tiles, 2, 3, 16, 128, 33, 129)
    for bad in ((tiles, ids[:5], 48, 256, False), (tiles, ids.long(), 48, 256, False),
                (tiles, ids, 49, 256, False), (tiles, ids, 48, 0, False),
                (depth, ids, 48, 256, True), (tiles.to(torch.int16), ids, 48, 256, False),
                (tiles.transpose(1, 2), ids, 48, 256, False)):
        x, i, h, w, rgb = bad
        with pytest.raises(ValueError):
            raster_sparse.untile_image(x, i, 2, 3, 16, 128, h, w, rgb=rgb)
    for h, w in ((0, 10), (10, 257), (49, 10)):
        with pytest.raises(ValueError):
            raster_sparse.untile3_image(tiles, depth, tiles, 2, 3, 16, 128, h, w)
    with pytest.raises(ValueError):
        raster_sparse.untile3_image(tiles, tiles, tiles, 2, 3, 16, 128, 48, 256)


def test_cpu_image_stores_launch_no_kernel(frames):
    f = frames["th16_250x40"]
    reset_launches()
    entries = ("untile_one", "untile_image", "untile3", "untile3_image")
    before = {e: launches(e) for e in entries}
    planes = [torch.from_numpy(x) for x in f["planes"]]
    raster_sparse.untile_image(planes[0], None, *_dims(f), rgb=True)
    raster_sparse.untile3_image(*planes, *_dims(f))
    assert launches("untile_one", "untile_image") == launches("untile3", "untile3_image") == 0
    assert {e: launches(e) for e in entries} == before


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (skipped without a GPU)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cuda_frame(name):
    th, tw, w, h = CUDA_SHAPES[name]
    return _frame(th, tw, w, h, 0.5, 100 + list(CUDA_SHAPES).index(name))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_SHAPES))
def test_cuda_untile_image_matches_plain(cuda_device, name):
    f = _cuda_frame(name)
    color, depth, _ = (torch.from_numpy(x) for x in f["planes"])
    ids = torch.from_numpy(f["ids"])
    idl = ids.long()
    cases = (("rgb", color[idl].contiguous(), ids, 0, True),
             ("depth", depth[idl].contiguous(), ids, torch.inf, False),
             ("packed", color[idl].contiguous(), ids, 0, False),
             ("every tile", depth, None, 0, False),
             ("every tile rgb", color, None, 0, True))
    for what, x, i, fill, rgb in cases:
        want = raster_sparse.untile_image_plain(x, i, *_dims(f), fill, rgb)
        before = (launches("untile_one", "untile_image"), launches("untile_image"))
        got = raster_sparse.untile_image(x.to(cuda_device),
                                         None if i is None else i.to(cuda_device),
                                         *_dims(f), fill=fill, rgb=rgb)
        torch.cuda.synchronize()
        assert (launches("untile_one", "untile_image"), launches("untile_image")) == \
            (before[0] + 1, before[1] + 1)
        assert_bits(got.cpu().numpy(), want.numpy(), f"{name} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_SHAPES))
def test_cuda_untile3_image_matches_plain(cuda_device, name):
    f = _cuda_frame(name)
    planes = [torch.from_numpy(x) for x in f["planes"]]
    before = (launches("untile3", "untile3_image"), launches("untile3_image"))
    got = raster_sparse.untile3_image(*(x.to(cuda_device) for x in planes), *_dims(f))
    torch.cuda.synchronize()
    assert (launches("untile3", "untile3_image"), launches("untile3_image")) \
        == (before[0] + 1, before[1] + 1)
    for k, g, w in zip(("color", "depth", "winner"), got,
                       raster_sparse.untile3_image_plain(*planes, *_dims(f))):
        assert_bits(g.cpu().numpy(), w.numpy(), f"{name} {k}")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CUDA_SHAPES))
def test_cuda_plain_layout_untiles_match_plain(cuda_device, name):
    """``untile_one`` and ``untile3`` at every instantiated tile height and
    at the generic kernel's shapes."""
    f = _cuda_frame(name)
    planes = [torch.from_numpy(x) for x in f["planes"]]
    n = _dims(f)[:4]
    for x in planes[:2]:
        got = raster_sparse.untile_one(x.to(cuda_device), *n)
        torch.cuda.synchronize()
        assert_bits(got.cpu().numpy(), raster_sparse.untile_one_plain(x, *n).numpy(), name)
    got = raster_sparse.untile3(*(x.to(cuda_device) for x in planes), *n)
    torch.cuda.synchronize()
    for k, g, w in zip(("color", "depth", "winner"), got,
                       raster_sparse.untile3_plain(*planes, *n)):
        assert_bits(g.cpu().numpy(), w.numpy(), f"{name} {k}")
