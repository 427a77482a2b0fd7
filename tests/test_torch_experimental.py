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
NSX = 80


def _dead_chunks():
    """768 synthetic triangles whose 128 .. 511 have spans 0: three of the
    TPU's 128-triangle chunks, and a whole range of the CUDA kernel's,
    hold no live slot."""
    data = [a.copy() for a in rank_kernel.synthetic_set(768, nsx=NSX)]
    data[3][128:512] = 0
    return tuple(data)


def _four_strips(f: int = 300):
    """``f`` triangles of span_x 2 and spans 4 on one 2 x 2 block of
    strips: every triangle counts in all four, no slot is padded."""
    full = lambda v: np.full(f, v, np.int32)  # noqa: E731
    return full(7), full(3), full(2), full(4)


#: rank cases -> (tx0, ty0, span_x, spans): the script's synthetic set (80 x
#: 50 strips) and the shapes the CUDA kernel's ranges stress: a one-strip
#: pile across three 128-triangle chunks (ranks 0 .. 299), a partial chunk,
#: one triangle, chunks with no live slot, every slot live
RANK = {"f2000": lambda: rank_kernel.synthetic_set(2000, nsx=NSX),
        "f60000": lambda: rank_kernel.synthetic_set(60000, nsx=NSX),
        "pile300": lambda: rank_kernel.pile_set(300),
        "f129": lambda: rank_kernel.synthetic_set(129, nsx=NSX),
        "f1": lambda: rank_kernel.synthetic_set(1, nsx=NSX),
        "dead_chunks": _dead_chunks,
        "four_strips": _four_strips}
#: rank cases for the card only, at the stress scene's 246,240 triangles
RANK_CUDA = {"pile246240": lambda: rank_kernel.pile_set(246240),
             "f246240": lambda: rank_kernel.synthetic_set(246240, nsx=NSX)}
#: block-update cases on the probe's image -> (ids, add, a_cap): repeats out
#: of order, all eight ids in reverse order plus repeats, and an a_cap
#: shorter than the list (the tail is not visited)
INPLACE = {"repeats": ([7, 0, 7, 2, 5, 0], 2.5, 6),
           "reverse": ([7, 6, 5, 4, 3, 2, 1, 0, 0, 4, 7, 1], -1.75, 12),
           "a_cap_short": ([4, 1, 6, 1, 2, 7, 0, 3], 0.625, 4)}


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
    return {name: make() for name, make in RANK.items()}


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
    for name, (ids, add, a_cap) in INPLACE.items():
        req[f"inplace_{name}"] = {"op": "inplace", "img": _probe_image(),
                                  "ids": np.array(ids, np.int32), "add": add, "a_cap": a_cap}
    return run_jax(req, tmp_path_factory.mktemp("jax_experimental"))


# ---------------------------------------------------------------------------
# #7 the prototype strip raster
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(STRIP))
def test_strip_records_match_script(strip_inputs, jax_out, name):
    _, w, h, _ = STRIP[name]
    recs, rows, ntx, nty, row_total = fine_raster.build_strip_records(strip_inputs[name][0],
                                                                      w, h)
    assert (ntx, nty) == (-(-w // 128), -(-h // 8))
    assert row_total == int(rows.sum())
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
    recs, rows, ntx, _, _ = fine_raster.build_strip_records(strip_inputs["head_128x64"][0],
                                                            128, 64)
    init = torch.full((rows.shape[0], 8, 128), torch.inf)
    with pytest.raises(ValueError, match="rows"):
        fine_raster.strip_raster(recs, rows.long(), init, ntx)
    with pytest.raises(ValueError, match="init_tiles"):
        fine_raster.strip_raster(recs, rows, init[:, :4].contiguous(), ntx)


def _strip_case(strip_inputs, name, device="cpu"):
    """(recs, rows, init tiles, n_tiles_x, row total) of STRIP case ``name``."""
    setup, init = strip_inputs[name]
    _, w, h, _ = STRIP[name]
    setup = {k: v.to(device) for k, v in setup.items()}
    recs, rows, ntx, nty, row_total = fine_raster.build_strip_records(setup, w, h)
    init_t = fine_raster.to_tiles(torch.from_numpy(init).to(device), nty, ntx, 8, 128,
                                  torch.inf)
    return recs, rows, init_t, ntx, row_total


def _zero_rows_case(strip_inputs):
    """The ragged head_200x60 with every even group emptied (rows 0, every
    slot empty) -> (recs, rows, init tiles, n_tiles_x, the emptied groups)."""
    recs, rows, init_t, ntx, _ = _strip_case(strip_inputs, "head_200x60")
    zero = torch.arange(rows.shape[0]) % 2 == 0
    assert (rows[zero] > 0).any() and (rows[~zero] > 0).any()
    recs = recs.clone()
    slots = recs.view(rows.shape[0], recs.shape[1], 8, 16)
    slots[zero] = 0.0
    slots[zero, ..., fine_raster.NFIELD - 1] = -1.0
    return recs, torch.where(zero, 0, rows), init_t, ntx, zero


def _past_rows_case(strip_inputs):
    """head_128x64 with each group's rows past ``rows[g]`` filled with a
    live triangle over the whole screen, nearer than anything (id 7777):
    the kernel must never read them.  -> (the dirty records, rows, init
    tiles, n_tiles_x, the clean records)."""
    recs, rows, init_t, ntx, _ = _strip_case(strip_inputs, "head_128x64")
    g, m, _ = recs.shape
    past = torch.arange(m)[None, :] >= rows[:, None]
    assert past.any()
    fill = torch.zeros(8, 16)
    fill[:, :fine_raster.NFIELD] = torch.tensor([-1e4, -1e4, 3e4, -1e4, -1e4, 3e4,
                                                 0.0, 0.0, 0.0, 7777.0])
    dirty = recs.clone()
    dirty.view(g, m, 8, 16)[past] = fill
    return dirty, rows, init_t, ntx, recs


@pytest.mark.parametrize("range_len", [1, 3, 8])
@pytest.mark.parametrize("name", list(STRIP))
def test_strip_split_plain_matches_plain(strip_inputs, name, range_len):
    """The kernel's decomposition (ranges merged in order) == the serial
    walk, bitwise."""
    recs, rows, init_t, ntx, _ = _strip_case(strip_inputs, name)
    want = fine_raster.strip_raster_plain(recs, rows, init_t, ntx)
    got = fine_raster.strip_raster_split_plain(recs, rows, init_t, ntx, range_len)
    for a, b in zip(got, want):
        assert_bits(a.numpy(), b.numpy(), f"{name}, ranges of {range_len}")


def test_strip_tie_pile_keeps_the_first_drawn():
    """100 ties in every strip, cut into ranges of 32: the first drawn
    (id 0; id 1 where slot 3 of row 0 is empty) wins, the farther
    triangle never, the nearer one where it covers, past an empty row."""
    recs, rows, init_t, ntx = fine_raster.tie_pile(100)
    depth, winner = fine_raster.strip_raster_plain(recs, rows, init_t, ntx)
    for a, b in zip(fine_raster.strip_raster_split_plain(recs, rows, init_t, ntx, 32),
                    (depth, winner)):
        assert_bits(a.numpy(), b.numpy(), "tie pile, ranges of 32")
    w = winner[0].view(8, 8, 16)                                  # (row, strip, column)
    nearer = w == 102
    assert nearer.any() and not nearer.all() and not (w == 100).any()
    assert (w[~nearer] == torch.where(torch.arange(8) == 3, 1, 0)[None, :, None]
            .expand_as(w)[~nearer]).all()
    assert (depth[0][winner[0] == 102] < 0.3).all() and (depth[0][winner[0] < 100] > 0.4).all()


@pytest.mark.parametrize("version", ["plain", "wrapper", "split"])
def test_strip_zero_rows_return_init(strip_inputs, version):
    """A group of no row keeps its init depth and winner -1, on the plain
    version, the wrapper's CPU path and the split decomposition; the other
    groups are as before."""
    recs, rows, init_t, ntx, zero = _zero_rows_case(strip_inputs)
    fn = {"plain": fine_raster.strip_raster_plain, "wrapper": fine_raster.strip_raster,
          "split": lambda *a: fine_raster.strip_raster_split_plain(*a, 3)}[version]
    depth, winner = fn(recs, rows, init_t, ntx)
    assert_bits(depth[zero].numpy(), init_t[zero].numpy(), "depth of the empty groups")
    assert (winner[zero] == -1).all()
    assert torch.isfinite(init_t[zero]).any()                    # the seeded init
    want = fine_raster.strip_raster_plain(*_strip_case(strip_inputs, "head_200x60")[:4])
    for a, b in zip((depth, winner), want):
        assert_bits(a[~zero].numpy(), b[~zero].numpy(), "the other groups")


def test_strip_split_plain_never_reads_past_rows(strip_inputs):
    dirty, rows, init_t, ntx, clean = _past_rows_case(strip_inputs)
    want = fine_raster.strip_raster_plain(clean, rows, init_t, ntx)
    assert (fine_raster.strip_raster_plain(dirty, rows, init_t, ntx)[1] == 7777).any()
    for a, b in zip(fine_raster.strip_raster_split_plain(dirty, rows, init_t, ntx, 8), want):
        assert_bits(a.numpy(), b.numpy(), "rows past rows[g]")


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
    _assert_reference_ranks(data, strips, ranks)
    # padded slots exist wherever a triangle spans fewer than 4 strips
    assert (strips.numpy() < 0).any() == bool((data[3] < rank_kernel.S_CAP).any())


def _assert_reference_ranks(data, strips, ranks):
    """strips and ranks (CPU tensors) equal the script's sort-free ground
    truth on live slots, and padded slots have rank 0."""
    s_ref, r_ref = rank_kernel.reference_ranks(*data, NSX, len(data[0]))
    live = s_ref >= 0
    assert_bits(strips.numpy().astype(np.int64), s_ref, "strips vs reference_ranks")
    assert_bits(ranks.numpy()[live].astype(np.int64), r_ref[live], "ranks vs reference_ranks")
    assert not ranks.numpy()[~live].any()                         # padded slots: rank 0


def _bad_rank_input(bad):
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
    return tx0, ty0, span_x, spans


REFUSALS = [("spans", "slots a triangle"), ("rows", "counter table"),
            ("cols", "counter table")]


@pytest.mark.parametrize("bad,match", REFUSALS)
def test_rank_pairs_refuse_what_the_tpu_kernel_cannot_count(bad, match):
    with pytest.raises(ValueError, match=match):
        rank_kernel.rank_pairs_kernel(*_bad_rank_input(bad), NSX)


@pytest.mark.parametrize("n_slots", [1, 4, 516, 1024, 1025, 4 * 60000, 4 * 246240, 1 << 23])
@pytest.mark.parametrize("sm_count", [1, 132])
def test_rank_ranges_cover_the_slots(n_slots, sm_count):
    """The CUDA kernel's ranges: R a multiple of its batch (and so of a
    warp's 32 slots), G * R covers the slots and (G - 1) * R does not, G
    within its caps."""
    g, r = rank_kernel.ranges(n_slots, sm_count)
    assert r % rank_kernel.RANGE_ALIGN == 0 and rank_kernel.RANGE_ALIGN % 32 == 0
    assert g * r >= n_slots > (g - 1) * r
    assert 1 <= g <= min(rank_kernel.RANGES_PER_SM * sm_count, rank_kernel.MAX_RANGES)


# ---------------------------------------------------------------------------
# #9 the in-place block probe
# ---------------------------------------------------------------------------

def test_inplace_blocks_match_the_probe(jax_out):
    r = jax_out["inplace_repeats"]
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


@pytest.mark.parametrize("name", list(INPLACE))
def test_inplace_blocks_match_script_run(jax_out, name):
    ids, add, a_cap = INPLACE[name]
    img0 = _probe_image()
    img = torch.from_numpy(img0.copy())
    inplace_blocks.run(img, torch.tensor(ids, dtype=torch.int32), add, a_cap)
    assert_bits(img.numpy(), jax_out[f"inplace_{name}"]["out"], "the script's run")
    assert_bits(img.numpy(), inplace_blocks.expected_image(img0, ids[:a_cap], add),
                "expected image")


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
    recs, rows, init_t, ntx, row_total = _strip_case(strip_inputs, name, cuda_device)
    fine_raster.LAUNCHES = 0
    got = fine_raster.strip_raster(recs, rows, init_t, ntx, row_total=row_total)
    assert fine_raster.LAUNCHES == 1
    for g, p in zip(got, fine_raster.strip_raster_plain(recs, rows, init_t, ntx)):
        assert_bits(g.cpu().numpy(), p.cpu().numpy(), name)


def _split_case(strip_inputs, case):
    """-> (recs, rows, init tiles, n_tiles_x, the records the plain version
    reads) of a split-walk case on the card."""
    if case.startswith("tie_pile_"):
        recs, rows, init_t, ntx = fine_raster.tie_pile(int(case.split("_")[-1]))
        return recs, rows, init_t, ntx, recs
    if case == "zero_rows":
        recs, rows, init_t, ntx, _ = _zero_rows_case(strip_inputs)
        return recs, rows, init_t, ntx, recs
    return _past_rows_case(strip_inputs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["tie_pile_100", "tie_pile_300", "zero_rows", "past_rows"])
def test_cuda_strip_raster_split_cases(strip_inputs, cuda_device, case):
    """Ties across the ranges (2 and 5 of them), groups of no row, rows
    past rows[g] holding a live triangle: kernel == plain bitwise."""
    recs, rows, init_t, ntx, clean = (t.to(cuda_device) if torch.is_tensor(t) else t
                                      for t in _split_case(strip_inputs, case))
    fine_raster.LAUNCHES = 0
    got = fine_raster.strip_raster(recs, rows, init_t, ntx)     # reads rows.sum() back
    assert fine_raster.LAUNCHES == 1
    for g, p in zip(got, fine_raster.strip_raster_plain(clean, rows, init_t, ntx)):
        assert_bits(g.cpu().numpy(), p.cpu().numpy(), case)


@pytest.mark.cuda
def test_cuda_strip_raster_launches(strip_inputs, cuda_device):
    """The split walk where a group outgrows one range (scan, walk, merge);
    the walk alone where the records fit one (the script's passes)."""
    recs, rows, init_t, ntx = (t.to(cuda_device) if torch.is_tensor(t) else t
                               for t in fine_raster.tie_pile(100))
    assert recs.shape[1] > fine_raster.range_rows()
    names = _device_kernels(lambda: fine_raster.strip_raster(recs, rows, init_t, ntx,
                                                             row_total=103))
    assert len(names) == 3, names
    for phase, name in zip(("item_scan_kernel", "proto_walk_kernel", "proto_merge_kernel"),
                           names):
        assert phase in name, names
    recs, rows, init_t, ntx, total = _strip_case(strip_inputs, "head_128x64", cuda_device)
    assert recs.shape[1] <= fine_raster.range_rows()
    names = _device_kernels(lambda: fine_raster.strip_raster(recs, rows, init_t, ntx,
                                                             row_total=total))
    assert len(names) == 1 and "proto_walk_kernel" in names[0], names


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RANK) + list(RANK_CUDA))
def test_cuda_rank_kernel_matches_plain(cuda_device, name):
    data = {**RANK, **RANK_CUDA}[name]()
    args = [torch.from_numpy(a).to(cuda_device) for a in data]
    rank_kernel.LAUNCHES = 0
    got = rank_kernel.rank_pairs_kernel(*args, NSX)
    assert rank_kernel.LAUNCHES == 1
    for g, p in zip(got, rank_kernel.rank_pairs_plain(*args, NSX)):
        assert_bits(g.cpu().numpy(), p.cpu().numpy(), name)
    _assert_reference_ranks(data, *(g.cpu() for g in got))


@pytest.mark.cuda
@pytest.mark.parametrize("bad,match", REFUSALS)
def test_cuda_rank_kernel_refuses_from_the_device(cuda_device, bad, match):
    """The device's domain word refuses what the CPU check refuses, with
    the same message, after the one launch."""
    args = _bad_rank_input(bad)
    with pytest.raises(ValueError, match=match) as on_cpu:
        rank_kernel.rank_pairs_kernel(*args, NSX)
    rank_kernel.LAUNCHES = 0
    with pytest.raises(ValueError, match=match) as on_card:
        rank_kernel.rank_pairs_kernel(*(a.to(cuda_device) for a in args), NSX)
    assert rank_kernel.LAUNCHES == 1
    assert str(on_card.value) == str(on_cpu.value)


def _device_kernels(fn):
    """Names of the CUDA kernels ``fn`` launches, from torch.profiler; a
    trace that holds no kernel at all is taken again (up to three
    traces: the profiler has been seen to return an empty one)."""
    fn()                                                           # built, warm
    torch.cuda.synchronize()
    for _ in range(3):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and "emcpy" not in e.name]
        if names:
            break
    return names


@pytest.mark.cuda
def test_cuda_rank_kernel_launches_its_three_phases(cuda_device):
    args = [torch.from_numpy(a).to(cuda_device) for a in RANK["f2000"]()]
    names = _device_kernels(lambda: rank_kernel.rank_pairs_kernel(*args, NSX))
    assert len(names) == 3, names
    for phase, name in zip(("rank_hist", "rank_scan", "rank_walk"), names):
        assert phase in name, names


#: block-update cases on the card beside INPLACE: ids outside the image
INPLACE_CUDA = {"outside": ([-1, 8, 2, 99, 2, 5, -7], 1.0, 7)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(INPLACE) + list(INPLACE_CUDA))
@pytest.mark.parametrize("add_tensor", [False, True])
def test_cuda_inplace_blocks_match_plain(cuda_device, name, add_tensor):
    ids, add, a_cap = {**INPLACE, **INPLACE_CUDA}[name]
    img0 = _probe_image()
    img = torch.from_numpy(img0).to(cuda_device)
    ids_t = torch.tensor(ids, dtype=torch.int32, device=cuda_device)
    add_arg = torch.tensor([add], device=cuda_device) if add_tensor else add
    inplace_blocks.LAUNCHES = 0
    got = inplace_blocks.run(img.clone(), ids_t, add_arg, a_cap)
    assert inplace_blocks.LAUNCHES == 1
    want = inplace_blocks.run_plain(img.clone(), ids_t, add_arg, a_cap)
    assert_bits(got.cpu().numpy(), want.cpu().numpy(), "image")
    assert_bits(got.cpu().numpy(), inplace_blocks.expected_image(img0, ids[:a_cap], add),
                "expected image")


@pytest.fixture(scope="module")
def headline_tiles(cuda_device):
    """(active tile ids, tile height) of the headline head at 2048²."""
    from tinyrenderder_tpu_torch import scene as tscene
    from tinyrenderder_tpu_torch.ops import raster_sparse as rs
    sc = tscene.headline_scene(2048, 2048, "phong")
    attrs, shader, uniforms, _ = tscene.pass_tensors(sc, cuda_device)[0]
    th = rs.pick_tile_h(2048, 2048)
    return rs.pre_sparse(attrs, uniforms, shader, 2048, 2048, th, 128).ids, th


@pytest.mark.cuda
def test_cuda_inplace_blocks_headline_tiles_repeated(cuda_device, headline_tiles):
    """Every headline active tile id four times, shuffled: each block
    updated once, every other block bit-unchanged."""
    ids, th = headline_tiles
    perm = torch.from_numpy(np.random.default_rng(4).permutation(4 * ids.shape[0]))
    ids4 = ids.repeat(4)[perm.to(cuda_device)].contiguous()
    rng = np.random.default_rng(9)
    img = torch.from_numpy(rng.standard_normal((2048, 2048)).astype(np.float32)).to(cuda_device)
    inplace_blocks.LAUNCHES = 0
    got = inplace_blocks.run(img.clone(), ids4, 10.0, ids4.shape[0], (th, 128))
    assert inplace_blocks.LAUNCHES == 1
    want = inplace_blocks.run_plain(img.clone(), ids4, 10.0, ids4.shape[0], (th, 128))
    assert_bits(got.cpu().numpy(), want.cpu().numpy(), "image")
    def tiles(x):
        return x.view(2048 // th, th, 16, 128).transpose(1, 2).reshape(-1, th, 128)
    unvisited = torch.ones(tiles(img).shape[0], dtype=torch.bool, device=cuda_device)
    unvisited[ids.long()] = False
    assert torch.equal(tiles(got)[unvisited].view(torch.int32),
                       tiles(img)[unvisited].view(torch.int32))
    assert not torch.equal(tiles(got)[~unvisited], tiles(img)[~unvisited])


@pytest.mark.cuda
def test_cuda_inplace_blocks_run_is_one_launch(cuda_device):
    img = torch.from_numpy(_probe_image()).to(cuda_device)
    ids = torch.tensor(INPLACE["reverse"][0], dtype=torch.int32, device=cuda_device)
    names = _device_kernels(lambda: inplace_blocks.run(img, ids, 2.0, ids.shape[0]))
    assert len(names) == 1 and "inplace_blocks_kernel" in names[0], names
