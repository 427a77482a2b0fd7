"""Build the package's CUDA kernels with nvcc and load them with ctypes.

``csrc/*.cu`` expose a plain C interface (no PyTorch headers), so nvcc
builds them in seconds: one nvcc process per source, all started
together, then one link.  The shared library goes to
``build/tinyrenderder_tpu_torch/`` at the repository root, under a name
that hashes the sources and flags: a changed source rebuilds, an
unchanged one loads the existing library.

Flags: ``sm_90a`` code only; ``-fmad=false`` so no multiply-add is
contracted into an FMA (the reference rounds each product and sum
separately); no ``--use_fast_math``, so ``/`` and ``sqrtf`` stay IEEE
round-to-nearest, nvcc's default.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "tinyrenderder_tpu_torch"
SOURCES = ("raster_coarse.cu", "raster_fine.cu", "raster_fine2.cu", "untile.cu",
           "fine_raster.cu", "rank_kernel.cu", "inplace_blocks.cu", "scan_resolve.cu")
HEADERS = ("raster_common.cuh", "raster_strip.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
#: C entry points: name -> argtypes (every function returns cudaError_t)
SIGNATURES = {
    # tri_rec, rec_stride, sorted_tri, tile_ids (or null: every tile),
    # start, count, n_active, origin_x, origin_y, n_tiles_x, tile_h, y_stride,
    # tile_w, n_vary, init_depth, depth, winner, vary, ev_count, ev_maxz,
    # n_items, scratch, stream
    "trt_coarse_raster": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P, _P, _P, _P, _P, _P, _I, _P, _P],
    # tri_rec, rec_stride, tri8, tile_ids, row_start, rows, n_active,
    # origin_x, origin_y, n_tiles_x, tile_h, y_stride, tile_w, n_vary,
    # init_depth, depth, winner, vary, ev_count, ev_maxz, n_items,
    # scratch (or null: one launch), stream
    "trt_fine_raster": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                        _P, _P, _P, _P, _P, _P, _I, _P, _P],
    # tri_rec, rec_stride, tri8, group_start, group_rows, x0y0, n_groups,
    # origin_x, origin_y, tile_h, tile_w, n_vary,
    # init_depth (or null), depth, winner, vary, ev_count, ev_maxz, n_items,
    # scratch, stream
    "trt_fine2_raster": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _P, _P, _P, _P, _P, _P, _I, _P, _P],
    # src, dst, n_tiles_x, n_tiles_y, tile_h, tile_w, stream
    "trt_untile32": [_P, _P, _I, _I, _I, _I, _P],
    # color, depth, winner, color_out, depth_out, winner_out,
    # n_tiles_x, n_tiles_y, tile_h, tile_w, stream
    "trt_untile3": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # src, ids (or null: every tile in order), n_ids, dst, n_tiles_x,
    # n_tiles_y, tile_h, tile_w, height, width, fill bits, rgb, stream
    "trt_untile_image": [_P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # color, depth, winner, rgb_out, depth_out, winner_out, n_tiles_x,
    # n_tiles_y, tile_h, tile_w, height, width, stream
    "trt_untile3_image": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # recs, rows, n_groups, max_rows, init, depth, winner, n_tiles_x,
    # n_items, scratch (or null: the walk alone), stream
    "trt_strip_proto": [_P, _P, _I, _I, _P, _P, _P, _I, _I, _P, _P],
    # tx0, ty0, span_x, spans, n_tri, nsx, n_ranges, range, work, strips,
    # ranks, stream
    "trt_rank_pairs": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # tri_rec, rec_stride, valid, n_tri, height, width, x0, y0, init_depth
    # (or null), init_winner (or null), depth, winner, ev_count (or null),
    # ev_maxz (or null), counts, lists (the super-block lists), stream
    "trt_scan_resolve": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P],
    # img, ids, id_stride, add_ptr (or null), add_val, n_ids, height, width,
    # block_h, block_w, stream
    "trt_inplace_blocks": [_P, _P, _I, _P, _F, _I, _I, _I, _I, _I, _P],
}

#: C functions of no argument that return a kernel's compile-time constant
CONSTANTS = ("trt_coarse_range_pairs", "trt_fine_range_area", "trt_fine2_range_rows",
             "trt_proto_range_rows", "trt_scan_block_w", "trt_scan_block_h",
             "trt_scan_super_px")

_LIB: ctypes.CDLL | None = None
_CONSTANT_VALUES: dict[str, int] = {}
#: seconds this process spent in nvcc (0.0 when the library existed)
BUILD_SECONDS = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built from csrc/ on first use")
    return found


def _library_path(csrc: Path) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return BUILD_DIR / f"libtrt_kernels_{h.hexdigest()[:16]}.so"


def build(csrc: Path = CSRC) -> Path:
    """Compile the kernels of ``csrc`` (the package's sources, or an edited
    copy of them) unless a library of the same sources exists.  nvcc's
    output (ptxas register and shared-memory report) is kept beside the
    library as ``<name>.log``."""
    global BUILD_SECONDS
    lib = _library_path(csrc)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    objs = [tmp.with_name(f"{tmp.name}.{Path(s).stem}.o") for s in SOURCES]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(csrc / s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for s, o in zip(SOURCES, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        if link.returncode != 0:
            failed.append("link")
    BUILD_SECONDS = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("".join(logs))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(logs))
    os.replace(tmp, lib)       # atomic: a concurrent loader never sees half a file
    return lib


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library, its entry points typed."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    for name in CONSTANTS:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.trt_error_string.argtypes = [_I]
    lib.trt_error_string.restype = ctypes.c_char_p
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    if _LIB is None:
        _LIB = load(build())
    return _LIB


def constant(name: str) -> int:
    """The value of ``CONSTANTS`` entry ``name``, from the loaded library
    (asked once a process)."""
    if name not in _CONSTANT_VALUES:
        _CONSTANT_VALUES[name] = getattr(library(), name)()
    return _CONSTANT_VALUES[name]


def call(name: str, device, *args) -> None:
    """Call C entry point ``name`` with ``args`` and the current stream of
    CUDA ``device`` appended, with that device current, and raise on a
    non-zero cudaError_t.  The stream is the raw handle
    (``torch._C._cuda_getCurrentRawStream``), and the device is switched
    only when it is not the current one: ``torch.cuda.current_stream()``
    and ``torch.cuda.device`` each take more host time than the launch."""
    import torch
    fn = getattr(library(), name)
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    check(rc, name)


def check(rc: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        msg = library().trt_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc} ({msg})")
