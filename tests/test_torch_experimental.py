"""The port's experimental kernels (``tinyrenderder_tpu_torch/experimental``)
against the JAX repository's scripts they replace.

JAX side, in one subprocess for the module (tests/torch_parity.py says
why), each script's Pallas kernel in interpret mode:
``scripts/experimental_fine_raster.py`` (``build_strip_records`` and
``strip_rasterize(interpret=True)``), ``scripts/experimental_rank_kernel.py``
(``rank_pairs_kernel(interpret=True)``) and ``scripts/probe_inplace_blocks.py``
(loaded with ``runpy``: it runs its probe when loaded, then its ``run``
on this module's image).  Both sides get the same inputs: the port's
vertex-stage setups of the script's scenes, the script's synthetic
triangles (seed 7), the probe's image.  Tolerance: bitwise everywhere.

Tests marked ``cuda`` compare each CUDA kernel with its plain version and
skip where no GPU is present."""

import numpy as np
import pytest
import torch

from torch_parity import assert_bits, run_jax
from tinyrenderder_tpu_torch.experimental import fine_raster, inplace_blocks, rank_kernel

SETUP_KEYS = ("valid", "screen", "ndc_z", "clip_w", "bbox")
#: prototype strip raster cases: (scene of fine_raster.script_setups, w, h,
#: init seed or None for +inf); the last is ragged on both axes
STRIP = {"head_128x64": ("head", 128, 64, None), "soup_128x64": ("soup", 128, 64, None),
         "cube_128x64": ("cube", 128, 64, None), "head_200x60": ("head", 200, 60, 5)}
#: rank cases: triangles of the script's synthetic set (80 x 50 strips)
RANK = {"f2000": 2000, "f60000": 60000}
NSX = 80
#: block-update case beside the probe's own: ids with repeats, out of order
INPLACE_IDS, INPLACE_ADD = [7, 0, 7, 2, 5, 0], 2.5


def _strip_inputs(scene, w, h, seed):
    setup = fine_raster.script_setups("cpu", w, h)[scene]
    init = np.full((h, w), np.inf, np.float32)
    if seed is not None:
        rng = np.random.default_rng(seed)
        init = rng.uniform(-0.2, 1.0, size=(h, w)).astype(np.float32)
        init[rng.random(init.shape) < 0.5] = np.inf
    return setup, init


@pytest.fixture(scope="module")
def strip_inputs():
    return {name: _strip_inputs(*case) for name, case in STRIP.items()}


@pytest.fixture(scope="module")
def rank_inputs():
    return {name: rank_kernel.synthetic_set(f, nsx=NSX) for name, f in RANK.items()}


def _probe_image():
    h, w = inplace_blocks.H, inplace_blocks.W
    return np.arange(h * w, dtype=np.float32).reshape(h, w) * np.float32(0.001)


@pytest.fixture(scope="module")
def jax_out(strip_inputs, rank_inputs, tmp_path_factory):
    req = {}
    for name, (setup, init) in strip_inputs.items():
        _, w, h, _ = STRIP[name]
        req[name] = {"op": "strip_proto", "w": w, "h": h, "init": init,
                     **{k: setup[k].numpy() for k in SETUP_KEYS}}
    for name, data in rank_inputs.items():
        req[name] = {"op": "rank", "nsx": NSX,
                     **dict(zip(("tx0", "ty0", "span_x", "spans"), data))}
    req["inplace"] = {"op": "inplace", "img": _probe_image(),
                      "ids": np.array(INPLACE_IDS, np.int32), "add": INPLACE_ADD,
                      "a_cap": len(INPLACE_IDS)}
    return run_jax(req, tmp_path_factory.mktemp("jax_experimental"))


# ---------------------------------------------------------------------------
# #7 the prototype strip raster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STRIP))
def test_strip_records_match_script(strip_inputs, jax_out, name):
    _, w, h, _ = STRIP[name]
    recs, rows, ntx, nty = fine_raster.build_strip_records(strip_inputs[name][0], w, h)
    assert (ntx, nty) == (-(-w // 128), -(-h // 8))
    assert_bits(recs.numpy(), jax_out[name]["recs"], "records")
    assert_bits(rows.numpy(), jax_out[name]["rows"], "rows")


@pytest.mark.parametrize("name", list(STRIP))
def test_strip_rasterize_matches_script(strip_inputs, jax_out, name):
    setup, init = strip_inputs[name]
    _, w, h, _ = STRIP[name]
    fine_raster.LAUNCHES = 0
    depth, winner, shape = fine_raster.strip_rasterize(setup, torch.from_numpy(init), w, h)
    assert fine_raster.LAUNCHES == 0                  # the CPU takes the plain version
    assert shape == jax_out[name]["recs"].shape
    assert_bits(depth.numpy(), jax_out[name]["depth"], "depth")
    assert_bits(winner.numpy(), jax_out[name]["winner"], "winner")
    assert (winner >= 0).any()


@pytest.mark.parametrize("scene", ["head", "soup", "cube"])
def test_strip_prototype_passes_the_scripts_check(scene):
    """The script's own check (coverage equal, depth within 4 ulps)
    against the production raster over every 8-row tile."""
    cov_ok, _, ulps, _ = fine_raster.check_against_coarse(
        fine_raster.script_setups("cpu")[scene], 128, 64)
    assert cov_ok and ulps <= 4, (cov_ok, ulps)


def test_strip_raster_refuses_bad_shapes(strip_inputs):
    recs, rows, ntx, nty = fine_raster.build_strip_records(strip_inputs["head_128x64"][0],
                                                           128, 64)
    init = torch.full((rows.shape[0], 8, 128), torch.inf)
    with pytest.raises(ValueError, match="rows"):
        fine_raster.strip_raster(recs, rows.long(), init, ntx)
    with pytest.raises(ValueError, match="init_tiles"):
        fine_raster.strip_raster(recs, rows, init[:, :4].contiguous(), ntx)


# ---------------------------------------------------------------------------
# #8 the pair-rank kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RANK))
def test_rank_pairs_match_script(rank_inputs, jax_out, name):
    data = rank_inputs[name]
    rank_kernel.LAUNCHES = 0
    strips, ranks = rank_kernel.rank_pairs_kernel(*map(torch.from_numpy, data), NSX)
    assert rank_kernel.LAUNCHES == 0
    assert_bits(strips.numpy(), jax_out[name]["strips"], "strips")
    assert_bits(ranks.numpy(), jax_out[name]["ranks"], "ranks")
    s_ref, r_ref = rank_kernel.reference_ranks(*data, NSX, RANK[name])
    live = s_ref >= 0
    assert_bits(strips.numpy().astype(np.int64), s_ref, "strips vs reference_ranks")
    assert_bits(ranks.numpy()[live].astype(np.int64), r_ref[live], "ranks vs reference_ranks")
    assert (~live).any() and not ranks.numpy()[~live].any()     # padded slots: rank 0


@pytest.mark.parametrize("bad,match", [("spans", "slots a triangle"),
                                       ("rows", "counter table"),
                                       ("cols", "counter table")])
def test_rank_pairs_refuse_what_the_tpu_kernel_cannot_count(bad, match):
    tx0, ty0, span_x, spans = (torch.from_numpy(a.copy())
                               for a in rank_kernel.synthetic_set(300, nsx=NSX))
    if bad == "spans":
        span_x[7], spans[7] = 3, 6                   # 6 pairs, 4 slots
    elif bad == "rows":
        ty0[11] = rank_kernel.ROWS_PAD - 1
        spans[11], span_x[11] = 2, 1                 # the second slot's row is 64
    else:
        tx0[13] = rank_kernel.COLS_PAD - 1
        spans[13], span_x[13] = 2, 2                 # the second slot's column is 128
    with pytest.raises(ValueError, match=match):
        rank_kernel.rank_pairs_kernel(tx0, ty0, span_x, spans, NSX)


# ---------------------------------------------------------------------------
# #9 the in-place block probe
# ---------------------------------------------------------------------------

def test_inplace_blocks_match_the_probe(jax_out):
    r = jax_out["inplace"]
    img0 = _probe_image()
    assert_bits(r["probe_img"], img0, "the probe's image")
    inplace_blocks.LAUNCHES = 0
    img = torch.from_numpy(img0.copy())
    out = inplace_blocks.run(img, torch.tensor([1, 3, 3, 6], dtype=torch.int32), 10.0, 4)
    assert out is img and inplace_blocks.LAUNCHES == 0           # in place, plain
    assert_bits(out.numpy(), r["probe_out"], "the probe's own run")
    assert_bits(out.numpy(), inplace_blocks.expected_image(img0, [1, 3, 3, 6], 10.0),
                "expected image")
    blk3 = out.numpy()[16:32, 128:256] - img0[16:32, 128:256]
    assert 12.99 < blk3.min() <= blk3.max() < 13.01                # applied once, not 26
    img = torch.from_numpy(img0.copy())
    inplace_blocks.run(img, torch.tensor(INPLACE_IDS, dtype=torch.int32), INPLACE_ADD,
                       len(INPLACE_IDS))
    assert_bits(img.numpy(), r["out"], "repeated ids")


def test_inplace_blocks_skip_ids_outside_the_image():
    img0 = _probe_image()
    img = torch.from_numpy(img0.copy())
    inplace_blocks.run(img, torch.tensor([-1, 8, 2, 99], dtype=torch.int32), 1.0, 4)
    assert_bits(img.numpy(), inplace_blocks.expected_image(img0, [2], 1.0), "image")
    with pytest.raises(ValueError, match="tile"):
        inplace_blocks.run(img, torch.tensor([0], dtype=torch.int32), 1.0, 1, block=(24, 128))


# ---------------------------------------------------------------------------
# the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STRIP))
def test_cuda_strip_raster_matches_plain(strip_inputs, cuda_device, name):
    setup, init = strip_inputs[name]
    _, w, h, _ = STRIP[name]
    setup = {k: v.to(cuda_device) for k, v in setup.items()}
    recs, rows, ntx, nty = fine_raster.build_strip_records(setup, w, h)
    init_t = fine_raster.to_tiles(torch.from_numpy(init).to(cuda_device), nty, ntx, 8, 128,
                                  torch.inf)
    fine_raster.LAUNCHES = 0
    got = fine_raster.strip_raster(recs, rows, init_t, ntx)
    assert fine_raster.LAUNCHES == 1
    for g, p in zip(got, fine_raster.strip_raster_plain(recs, rows, init_t, ntx)):
        assert_bits(g.cpu().numpy(), p.cpu().numpy(), name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RANK))
def test_cuda_rank_kernel_matches_plain(rank_inputs, cuda_device, name):
    args = [torch.from_numpy(a).to(cuda_device) for a in rank_inputs[name]]
    rank_kernel.LAUNCHES = 0
    got = rank_kernel.rank_pairs_kernel(*args, NSX)
    assert rank_kernel.LAUNCHES == 1
    for g, p in zip(got, rank_kernel.rank_pairs_plain(*args, NSX)):
        assert_bits(g.cpu().numpy(), p.cpu().numpy(), name)


@pytest.mark.cuda
def test_cuda_inplace_blocks_match_plain(cuda_device):
    img0 = torch.from_numpy(_probe_image()).to(cuda_device)
    ids = torch.tensor(INPLACE_IDS + [3, 3, 1], dtype=torch.int32, device=cuda_device)
    inplace_blocks.LAUNCHES = 0
    got = inplace_blocks.run(img0.clone(), ids, INPLACE_ADD, ids.shape[0])
    assert inplace_blocks.LAUNCHES == 1
    want = inplace_blocks.run_plain(img0.clone(), ids, INPLACE_ADD, ids.shape[0])
    assert_bits(got.cpu().numpy(), want.cpu().numpy(), "image")
