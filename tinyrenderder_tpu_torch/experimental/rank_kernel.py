"""Strip ids and submission ranks of (triangle, strip slot) pairs: the
CUDA kernel ``csrc/rank_kernel.cu`` and its plain PyTorch version.

Counterpart of ``scripts/experimental_rank_kernel.py``
(``rank_pairs_kernel`` with its slot expansion and ``_rank_kernel``):
per (triangle, slot) pair, the strip id and the pair's stable rank
within its strip, the two numbers an interleaved record layout needs.

Contract (both versions, bitwise equal to ``rank_pairs_kernel(...,
interpret=True)``):
  tx0, ty0, span_x, spans  (F,) i32 per-triangle strip range
                           (``raster_tiled.tile_spans`` at strip size)
  nsx                      strip columns of the grid
  -> strips, ranks (F, 4) i32.  Slot j of triangle i (triangle-major,
     slot-minor = submission order): sx = max(span_x, 1), strip row
     ty0 + j // sx, strip column tx0 + j % sx, live iff j < spans.  A
     live slot gets its strip row * nsx + column and the count of earlier
     live slots in the same strip; a padded slot gets strip -1 and rank 0
     (not -1: the TPU kernel's one-hot is zero there).

Domain.  The TPU kernel counts in a 64 x 128 f32 table with 4 slots per
triangle.  Outside that it is silently wrong: a triangle with more than 4
pairs loses the rest (the script only asserts, ``:185``), and a pair whose
strip row is not in [0, 64) or column not in [0, 128) misses the table's
one-hot and takes rank 0 without counting.  ``rank_pairs_kernel`` refuses
such input with ``ValueError``.  Its f32 counts are exact below 2^24, so
4 F < 2^24 is required too.  On the CPU, ``check_domain`` reduces the
slots before the plain version runs; on CUDA the kernel's first phase
reduces the same five numbers into a domain word, which the wrapper
reads back once, after the launches, and refuses with the same messages.

The CUDA kernel is a parallel stable counting rank (``csrc/rank_kernel.cu``
says how): the slots are cut into ``ranges`` contiguous ranges, each
counted per key, the counts prefix-summed over the ranges, and each range
walked in order from its prefix.
"""

from __future__ import annotations

import argparse
import functools
import sys

import numpy as np
import torch

from tinyrenderder_tpu_torch import _build, trace

__all__ = ["S_CAP", "CHUNK", "ROWS_PAD", "COLS_PAD", "expand_slots",
           "check_domain", "ranges", "launch", "rank_pairs_kernel", "rank_pairs_plain",
           "reference_ranks", "synthetic_set", "pile_set", "main"]

S_CAP = 4          # strip slots per triangle
CHUNK = 128        # triangles per step of the TPU's sequential grid
ROWS_PAD = 64      # counter table rows (strip-grid rows)
COLS_PAD = 128     # counter table columns (strip-grid columns)
#: the CUDA kernel's ranges: at least MIN_RANGE slots each, a multiple of
#: RANGE_ALIGN (its batches of 8 warp steps), at most RANGES_PER_SM a
#: streaming multiprocessor and MAX_RANGES in all; per range
#: WORK_PER_RANGE ints of scratch (8,192 key counts and a domain part),
#: then DOMAIN_WORDS for the domain word
MIN_RANGE, RANGE_ALIGN, RANGES_PER_SM, MAX_RANGES = 1024, 256, 3, 512
WORK_PER_RANGE, DOMAIN_WORDS = ROWS_PAD * COLS_PAD + 8, 8

# kernel launches are counted as launch.rank_pairs (``trace.count``; the CPU
# path does not count)


def expand_slots(tx0, ty0, span_x, spans):
    """The script's slot expansion: (strip row, strip column, live), each
    (F, S_CAP)."""
    j = torch.arange(S_CAP, dtype=torch.int32, device=tx0.device)
    sx = torch.clamp(span_x, min=1)[:, None]
    q = torch.div(j, sx, rounding_mode="floor")
    return ty0[:, None] + q, tx0[:, None] + (j - q * sx), j < spans[:, None]


def _check_args(tx0, ty0, span_x, spans, nsx: int) -> int:
    """Raise ValueError unless the four vectors are (F,) int32 on one
    device, 4 F < 2^24 and nsx > 0; -> F."""
    f = tx0.shape[0]
    for name, t in (("tx0", tx0), ("ty0", ty0), ("span_x", span_x), ("spans", spans)):
        if t.dtype != torch.int32 or tuple(t.shape) != (f,) or t.device != tx0.device:
            raise ValueError(f"{name} must be ({f},) int32 on {tx0.device}")
    if S_CAP * f >= 1 << 24:
        raise ValueError(f"{f} triangles: the TPU kernel's f32 counts are exact only "
                         f"below 2^24 slots")
    if nsx <= 0:
        raise ValueError(f"nsx must be positive, got {nsx}")
    return f


def _refuse_outside(most: int, row_lo: int, row_hi: int, col_lo: int, col_hi: int) -> None:
    """Raise ValueError unless the domain word (the largest spans, the
    least and largest strip row and column, a padded slot counting 0) lies
    in the TPU kernel's domain."""
    if most > S_CAP:
        raise ValueError(f"a triangle spans {most} strips: the TPU kernel has {S_CAP} "
                         f"slots a triangle and drops the rest")
    if row_lo < 0 or row_hi >= ROWS_PAD:
        raise ValueError(f"strip rows {row_lo} .. {row_hi} outside the TPU kernel's "
                         f"{ROWS_PAD}-row counter table")
    if col_lo < 0 or col_hi >= COLS_PAD:
        raise ValueError(f"strip columns {col_lo} .. {col_hi} outside the TPU kernel's "
                         f"{COLS_PAD}-column counter table")


def check_domain(tx0, ty0, span_x, spans, nsx: int) -> None:
    """Raise ValueError unless the four vectors are (F,) int32 on one
    device and every pair lies in the TPU kernel's domain (module
    docstring)."""
    if _check_args(tx0, ty0, span_x, spans, nsx) == 0:
        return
    sy, sc, live = expand_slots(tx0, ty0, span_x, spans)
    zero = torch.zeros_like(sy)
    _refuse_outside(*torch.stack([
        spans.max(), torch.where(live, sy, zero).min(), torch.where(live, sy, zero).max(),
        torch.where(live, sc, zero).min(), torch.where(live, sc, zero).max()]).tolist())


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ranges(n_slots: int, sm_count: int) -> tuple[int, int]:
    """(G, R): the CUDA kernel's G contiguous ranges of R slots, R a
    multiple of RANGE_ALIGN, G * R >= n_slots > (G - 1) * R.  G grows with
    the slots (MIN_RANGE a range) up to RANGES_PER_SM a multiprocessor:
    more ranges shorten each range's serial walk and add 32 KB of counts
    each."""
    g = max(1, min(-(-n_slots // MIN_RANGE), RANGES_PER_SM * sm_count, MAX_RANGES))
    r = -(-n_slots // g)
    r = -(-r // RANGE_ALIGN) * RANGE_ALIGN
    return -(-n_slots // r), r


def launch(tx0, ty0, span_x, spans, nsx: int):
    """The kernel's launches alone on CUDA tensors the caller has checked
    with ``_check_args`` (F > 0): -> (strips, ranks, domain), ``domain``
    the device's five-int domain word, not yet read."""
    f, dev = tx0.shape[0], tx0.device
    g, r = ranges(f * S_CAP, _sm_count(dev))
    strips, ranks = torch.empty((2, f, S_CAP), dtype=torch.int32, device=dev)
    work = torch.empty(g * WORK_PER_RANGE + DOMAIN_WORDS, dtype=torch.int32, device=dev)
    args = [t.contiguous() for t in (tx0, ty0, span_x, spans)]
    trace.count("launch.rank_pairs")
    _build.call("trt_rank_pairs", dev, *(t.data_ptr() for t in args), f, nsx, g, r,
                work.data_ptr(), strips.data_ptr(), ranks.data_ptr())
    return strips, ranks, work[g * WORK_PER_RANGE:g * WORK_PER_RANGE + 5]


def rank_pairs_kernel(tx0, ty0, span_x, spans, nsx: int):
    """(strips, ranks), each (F, S_CAP) int32 (contract in the module
    docstring).  CPU tensors take the plain version; CUDA tensors launch
    the kernel and read its domain word back once."""
    if tx0.device.type == "cpu":
        check_domain(tx0, ty0, span_x, spans, nsx)
        return rank_pairs_plain(tx0, ty0, span_x, spans, nsx)
    f = _check_args(tx0, ty0, span_x, spans, nsx)
    if tx0.device.type != "cuda":
        raise ValueError(f"no rank kernel for device {tx0.device}")
    if f == 0:
        strips = torch.empty((0, S_CAP), dtype=torch.int32, device=tx0.device)
        return strips, torch.empty_like(strips)
    strips, ranks, domain = launch(tx0, ty0, span_x, spans, nsx)
    _refuse_outside(*domain.tolist())
    return strips, ranks


def rank_pairs_plain(tx0, ty0, span_x, spans, nsx: int):
    """Plain PyTorch version: one stable sort of the slots by their
    counter-table key, each slot's rank its position after the first of
    its key."""
    f = tx0.shape[0]
    sy, sc, live = expand_slots(tx0, ty0, span_x, spans)
    strips = torch.where(live, sy * nsx + sc, -1).to(torch.int32)
    key = torch.where(live, sy * COLS_PAD + sc, ROWS_PAD * COLS_PAD).reshape(-1).long()
    sorted_key, order = torch.sort(key, stable=True)
    first = torch.searchsorted(sorted_key, sorted_key)
    ranks = torch.empty_like(order)
    ranks[order] = torch.arange(key.numel(), device=key.device) - first
    ranks = torch.where(live, ranks.view(f, S_CAP), 0).to(torch.int32)
    return strips, ranks


def reference_ranks(tx0, ty0, span_x, spans, nsx: int, f: int):
    """The script's sort-free ground truth in NumPy (``:157-169``): a
    counter per strip, walked in submission order.  Padded slots are -1
    in both outputs; the script compares ranks on live slots only."""
    strips = np.full((f, S_CAP), -1, np.int64)
    ranks = np.full((f, S_CAP), -1, np.int64)
    counters: dict[int, int] = {}
    for i in range(f):
        sx = max(int(span_x[i]), 1)
        for j in range(int(spans[i])):
            s = (int(ty0[i]) + j // sx) * nsx + int(tx0[i]) + j % sx
            strips[i, j] = s
            ranks[i, j] = counters.get(s, 0)
            counters[s] = counters.get(s, 0) + 1
    return strips, ranks


def synthetic_set(f: int = 60000, seed: int = 7, nsx: int = 80, nty: int = 50):
    """The script's clustered synthetic triangles (``:175-185``): strip grid
    nsx x nty, spans 1 .. 4.  -> (tx0, ty0, span_x, spans) int32 NumPy."""
    rng = np.random.default_rng(seed)
    tx0 = (rng.beta(2, 2, f) * (nsx - 4)).astype(np.int32)
    ty0 = (rng.beta(2, 2, f) * (nty - 2)).astype(np.int32)
    span_x = rng.integers(1, 3, f).astype(np.int32)
    span_y = rng.integers(1, 3, f).astype(np.int32)
    return tx0, ty0, span_x, (span_x * span_y).astype(np.int32)


def pile_set(f: int, row: int = 25, col: int = 40):
    """``f`` triangles piled on one strip (row, col), span 1 each: the live
    slots share one key and rank 0 .. f-1.  -> (tx0, ty0, span_x, spans)
    int32 NumPy."""
    full = lambda v: np.full(f, v, np.int32)  # noqa: E731
    return full(col), full(row), full(1), full(1)


def main(argv=None) -> int:
    """The script's check on the port: the 60,000 synthetic triangles
    (seed 7, 80 x 50 strips) against ``reference_ranks``."""
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    nsx, f = 80, 60000
    data = synthetic_set(f, nsx=nsx)
    s_k, r_k = rank_pairs_kernel(*(torch.from_numpy(a).to(args.device) for a in data), nsx)
    s_k, r_k = s_k.cpu().numpy(), r_k.cpu().numpy()
    s_ref, r_ref = reference_ranks(*data, nsx, f)
    ok_s = bool((s_k == s_ref).all())
    ok_r = bool((r_k[s_ref >= 0] == r_ref[s_ref >= 0]).all())
    ok_pad = bool((r_k[s_ref < 0] == 0).all())
    print(f"strips exact: {ok_s}  ranks exact: {ok_r}  padded ranks 0: {ok_pad}  "
          f"({int(data[3].sum())} pairs, device {args.device})")
    ok = ok_s and ok_r and ok_pad
    print("PROTOTYPE", "VALIDATED" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
