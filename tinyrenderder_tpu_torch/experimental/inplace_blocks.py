"""In-place update of a dynamic list of image blocks: the CUDA kernel
``csrc/inplace_blocks.cu`` and its plain PyTorch version.

Counterpart of ``scripts/probe_inplace_blocks.py`` (``run`` and its
``kernel``), the probe of an aliased, dynamic-index block update: a grid
over a compacted list of block ids whose output is the input image, so
that blocks no step visits keep their contents.

Contract (both versions, bitwise):
  img    (H, W) f32, tiled exactly by blocks of ``block`` = (bh, bw)
         pixels, numbered row-major: block t covers rows (t // nbx) * bh
         and columns (t % nbx) * bw, nbx = W // bw
  ids    (n,) i32 block ids, n >= a_cap; the first ``a_cap`` are visited,
         duplicates allowed
  add    a float, or a one-element f32 tensor on img's device
  -> img itself, updated IN PLACE: each visited block becomes
     (x + 1.0 * add) + float(id) in float32, in the script's op order
     (``:36``), computed from the block's content before the call.  A
     duplicate id therefore applies once: the TPU kernel in interpret mode
     gives block 3 of ids [1, 3, 3, 6] +13, not +26.  Every other block
     keeps its bits.  An id outside [0, n_blocks) is skipped (the TPU's
     block index map leaves it undefined).

On CUDA, ``run`` is one launch: each CUDA block looks through the ids
before its own and leaves a repeat to the first occurrence, so no two
CUDA blocks write one image block (``csrc/inplace_blocks.cu``); a Python
``add`` goes by value.  The plain version deduplicates the ids first
(``dedup_ids``, keeping first occurrences), gathers the listed blocks,
computes their new values and scatters them back with ``index_copy_``
over the block axis (the pattern of ``raster_sparse.post_sparse``), the
repeats into a discarded block.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tinyrenderder_tpu_torch import _build

__all__ = ["LAUNCHES", "TH", "TW", "H", "W", "run", "launch", "run_plain", "dedup_ids",
           "expected_image", "main"]

#: the probe's blocks and image: 8 blocks of 16 x 128 in a 64 x 256 image
TH, TW = 16, 128
H, W = 4 * TH, 2 * TW

#: kernel launches since the last reset (the CPU path does not count)
LAUNCHES = 0


def _grid(img, block) -> tuple[int, int, int, int]:
    """(bh, bw, n_blocks_y, n_blocks_x), or ValueError."""
    bh, bw = block
    h, w = img.shape
    if bh <= 0 or bw <= 0 or h % bh or w % bw:
        raise ValueError(f"blocks of {bh}x{bw} do not tile a {h}x{w} image")
    return bh, bw, h // bh, w // bw


def dedup_ids(ids, n_blocks: int):
    """``ids`` with every repeat of an earlier id, and every id outside
    [0, n_blocks), replaced by -1, on the ids' device, without a readback."""
    n = ids.shape[0]
    pos = torch.arange(n, device=ids.device)
    ok = (ids >= 0) & (ids < n_blocks)
    safe = torch.where(ok, ids, 0).long()
    first = torch.full((n_blocks,), n, dtype=torch.long, device=ids.device)
    first.scatter_reduce_(0, safe, torch.where(ok, pos, n), "amin")
    return torch.where(ok & (first[safe] == pos), ids, -1)


def _check(img, ids, a_cap: int):
    if img.dtype != torch.float32 or img.dim() != 2 or not img.is_contiguous():
        raise ValueError(f"img must be a contiguous 2-D float32 tensor, got "
                         f"{img.dtype} {tuple(img.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 1 or ids.device != img.device:
        raise ValueError(f"ids must be 1-D int32 on {img.device}")
    if not 0 < a_cap <= ids.shape[0]:
        raise ValueError(f"a_cap {a_cap} must be in 1 .. {ids.shape[0]}")


def _add_tensor(add, device):
    """``add`` as a (1,) f32 tensor on ``device``; a Python number is
    filled there, with no host-to-device copy."""
    if not isinstance(add, torch.Tensor):
        return torch.full((1,), float(add), dtype=torch.float32, device=device)
    add = add.to(device=device, dtype=torch.float32).reshape(-1)
    if add.numel() != 1:
        raise ValueError("add must be one float")
    return add


def run(img, ids, add, a_cap: int, block=(TH, TW)):
    """Update the first ``a_cap`` listed blocks of ``img`` in place and
    return it (contract in the module docstring).  CPU tensors take the
    plain version; CUDA tensors launch the kernel, once."""
    _check(img, ids, a_cap)
    bh, bw, _, _ = _grid(img, block)
    if img.device.type == "cpu":
        return run_plain(img, ids, add, a_cap, block)
    if img.device.type != "cuda":
        raise ValueError(f"no block update for device {img.device}")
    launch(img, ids, add, a_cap, bh, bw)
    return img


def launch(img, ids, add, a_cap: int, bh: int, bw: int) -> None:
    """The kernel's launch alone on CUDA tensors ``run`` has checked: a
    Python ``add`` by value, a tensor one through its pointer."""
    global LAUNCHES
    add_t = _add_tensor(add, img.device) if isinstance(add, torch.Tensor) else None
    _build.call("trt_inplace_blocks", img.device, img.data_ptr(), ids.data_ptr(), ids.stride(0),
                None if add_t is None else add_t.data_ptr(),
                0.0 if add_t is not None else float(add), a_cap, img.shape[0], img.shape[1],
                bh, bw)
    LAUNCHES += 1


def run_plain(img, ids, add, a_cap: int, block=(TH, TW)):
    """Plain PyTorch version: gather, compute, ``index_copy_`` back."""
    _check(img, ids, a_cap)
    bh, bw, nby, nbx = _grid(img, block)
    n_blocks = nby * nbx
    add = _add_tensor(add, img.device)
    ids = dedup_ids(ids[:a_cap], n_blocks)
    tiles = img.view(nby, bh, nbx, bw).transpose(1, 2).reshape(n_blocks, bh, bw)
    src = tiles[torch.clamp(ids, min=0).long()]
    upd = (src + 1.0 * add) + ids.to(torch.float32)[:, None, None]
    out = torch.cat([tiles, tiles[:1]])           # block n_blocks is discarded
    out.index_copy_(0, torch.where(ids >= 0, ids, n_blocks).long(), upd)
    img.copy_(out[:n_blocks].view(nby, nbx, bh, bw).transpose(1, 2).reshape(img.shape))
    return img


def expected_image(img: np.ndarray, ids, add: float, block=(TH, TW)) -> np.ndarray:
    """The contract in NumPy float32: each distinct valid id's block of a
    copy of ``img`` becomes (x + 1.0 * add) + id, once."""
    bh, bw = block
    nbx = img.shape[1] // bw
    out = img.copy()
    n_blocks = (img.shape[0] // bh) * nbx
    for t in dict.fromkeys(int(i) for i in ids):
        if 0 <= t < n_blocks:
            y, x = (t // nbx) * bh, (t % nbx) * bw
            blk = out[y:y + bh, x:x + bw]
            out[y:y + bh, x:x + bw] = (blk + np.float32(1.0) * np.float32(add)) + np.float32(t)
    return out


def main(argv=None) -> int:
    """The probe on the port: ids [1, 3, 3, 6], add 10 on the probe's
    image, checked bitwise against ``expected_image`` (the script's own
    check compares f32 deltas with exact numbers and fails in f32)."""
    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available")
    img0 = np.arange(H * W, dtype=np.float32).reshape(H, W) * np.float32(0.001)
    ids = [1, 3, 3, 6]
    img = torch.from_numpy(img0.copy()).to(args.device)
    out = run(img, torch.tensor(ids, dtype=torch.int32, device=args.device), 10.0, len(ids))
    got = out.cpu().numpy()
    want = expected_image(img0, ids, 10.0)
    same = np.array_equal(got.view(np.int32), want.view(np.int32))
    nbx = W // TW
    print("per-block delta (min, max); visited blocks 1, 3, 6 gain 10 + id, once:")
    for t in range(8):
        y, x = (t // nbx) * TH, (t % nbx) * TW
        d = got[y:y + TH, x:x + TW] - img0[y:y + TH, x:x + TW]
        unchanged = np.array_equal(got[y:y + TH, x:x + TW].view(np.int32),
                                   img0[y:y + TH, x:x + TW].view(np.int32))
        print(f"  block {t}: ({float(d.min())}, {float(d.max())})"
              + (" bit-unchanged" if unchanged else ""))
    blk3 = got[(3 // nbx) * TH:(3 // nbx + 1) * TH, (3 % nbx) * TW:(3 % nbx + 1) * TW]
    print(f"block 3 (listed twice): first pixel {float(blk3[0, 0])} = "
          f"({float(img0[TH, TW])} + 1.0 * 10.0) + 3.0: each visit computes from the "
          f"block before the call, so the repeat writes the same values (+13, not +26)")
    print("PROBE", "OK" if same else "FAILED", "| device:", args.device)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
