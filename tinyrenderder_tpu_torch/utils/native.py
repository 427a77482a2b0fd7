"""ctypes bindings to the repository's native C++ host helpers: the TGA RLE
codec (``native/tga_codec.cpp``) and the OBJ tokenizer
(``native/obj_loader.cpp``).

Counterpart of ``tinyrenderder_tpu/utils/native.py``, which loads the
library that ``make -C native`` builds.  The port builds its own at first
use: g++ with ``native/Makefile``'s flags (``-O3 -std=c++17 -fPIC
-shared``) into ``build/tinyrenderder_tpu_torch/``, under a name that
hashes the sources and flags, renamed into place atomically as
``_build.py`` does the CUDA kernels, so that concurrent processes never
load half a file.  Nothing is written into ``native/``.

Where g++ or the sources are missing, or the build fails, ``available()``
is False and the callers (``utils/tga.py``, ``models/obj.py``) take their
pure-Python paths, which give the same bytes and meshes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

__all__ = ["available", "obj_available", "rle_decode", "rle_encode", "parse_obj",
           "BUILD_ERROR"]

ROOT = Path(__file__).resolve().parent.parent.parent
NATIVE = ROOT / "native"
BUILD_DIR = ROOT / "build" / "tinyrenderder_tpu_torch"
SOURCES = ("tga_codec.cpp", "obj_loader.cpp")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib: ctypes.CDLL | None = None
_checked = False
#: why the library is not available (None when it is, or before first use)
BUILD_ERROR: str | None = None


def _library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE / name).read_bytes())
    return BUILD_DIR / f"libtrt_native_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    lib = _library_path()
    if lib.exists():
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise OSError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE / s) for s in SOURCES)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OSError(f"g++ failed:\n{proc.stdout}")
    os.replace(tmp, lib)       # atomic: a concurrent loader never sees half a file
    return lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ll, vp = ctypes.c_longlong, ctypes.c_void_p
    lib.trd_rle_decode.restype = ll
    lib.trd_rle_decode.argtypes = [ctypes.c_char_p, ll, u8p, ll, ctypes.c_int]
    lib.trd_rle_encode.restype = ll
    lib.trd_rle_encode.argtypes = [u8p, ll, ctypes.c_int, u8p, ll]
    lib.trd_obj_parse.restype = vp
    lib.trd_obj_parse.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    for name in ("trd_obj_nverts", "trd_obj_nindices", "trd_obj_nsubmeshes"):
        getattr(lib, name).restype = ll
        getattr(lib, name).argtypes = [vp]
    lib.trd_obj_flags.restype = ctypes.c_int
    lib.trd_obj_flags.argtypes = [vp]
    dp = ctypes.POINTER(ctypes.c_double)
    lib.trd_obj_copy.argtypes = [vp, dp, dp, dp, ctypes.POINTER(ctypes.c_int32),
                                 ctypes.POINTER(ll)]
    lib.trd_obj_names_len.restype = ll
    lib.trd_obj_names_len.argtypes = [vp, ctypes.c_int]
    lib.trd_obj_names.argtypes = [vp, ctypes.c_int, ctypes.c_char_p]
    lib.trd_obj_free.argtypes = [vp]


def _load() -> ctypes.CDLL | None:
    global _lib, _checked, BUILD_ERROR
    if _checked:
        return _lib
    _checked = True
    try:
        lib = ctypes.CDLL(str(_build()))
        _bind(lib)
    except (OSError, AttributeError) as e:
        BUILD_ERROR = str(e)
        return None
    _lib = lib
    return _lib


def available() -> bool:
    """The library is built (now, if it was not) and loaded."""
    return _load() is not None


def obj_available() -> bool:
    """The library is loaded and carries the OBJ tokenizer."""
    lib = _load()
    return lib is not None and hasattr(lib, "trd_obj_parse")


def rle_decode(raw: bytes, w: int, h: int, bpp: int) -> np.ndarray:
    """TGA RLE payload -> flat (h * w, bpp) uint8 (tgaimage.cpp:124-157)."""
    lib = _load()
    out = np.empty((h * w, bpp), dtype=np.uint8)
    n = lib.trd_rle_decode(raw, len(raw), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           h * w, bpp)
    if n != h * w:
        raise ValueError(f"RLE decode produced {n} of {h * w} pixels")
    return out


def rle_encode(flat: np.ndarray, bpp: int) -> bytes:
    """Flat (n, bpp) uint8 -> greedy RLE bytes (tgaimage.cpp:193-242)."""
    lib = _load()
    flat = np.ascontiguousarray(flat, dtype=np.uint8)
    npix = flat.shape[0]
    cap = npix * (bpp + 1) + 64          # every pixel its own raw packet
    out = np.empty(cap, dtype=np.uint8)
    n = lib.trd_rle_encode(flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), npix, bpp,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise ValueError("RLE encode overflow")
    return out[:n].tobytes()


def parse_obj(path: str, default_group: str):
    """An OBJ's geometry through the C++ tokenizer -> (positions (V, 3)
    f64, uvs (V, 2), normals (V, 3), faces (F, 3) i32, submesh table (S, 3)
    [start_index, index_count, material] i64, material names, group
    names, mtllib payloads, any_uv, any_norm), or None when the file does
    not open.  A numeric token that does not parse raises ValueError, as
    the Python path does."""
    lib = _load()
    h = lib.trd_obj_parse(path.encode(), default_group.encode())
    if not h:
        return None
    try:
        nv, ni, ns = lib.trd_obj_nverts(h), lib.trd_obj_nindices(h), lib.trd_obj_nsubmeshes(h)
        flags = lib.trd_obj_flags(h)
        if flags & 4:
            raise ValueError(f"malformed numeric token in OBJ: {path}")
        pos, uv, nrm = (np.empty((nv, c), np.float64) for c in (3, 2, 3))
        faces = np.empty(ni, np.int32)
        sub = np.empty((ns, 3), np.int64)
        dp = ctypes.POINTER(ctypes.c_double)
        lib.trd_obj_copy(h, pos.ctypes.data_as(dp), uv.ctypes.data_as(dp),
                         nrm.ctypes.data_as(dp), faces.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                         sub.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)))

        def names(which: int) -> list[str]:
            n = lib.trd_obj_names_len(h, which)
            if n == 0:
                return []
            buf = ctypes.create_string_buffer(int(n))
            lib.trd_obj_names(h, which, buf)
            return buf.raw[:n].decode(errors="replace").split("\n")

        return (pos, uv, nrm, faces.reshape(-1, 3), sub, names(0), names(1), names(2),
                bool(flags & 1), bool(flags & 2))
    finally:
        lib.trd_obj_free(h)
