"""TGA image codec: read and write Truevision TGA with optional RLE.

Counterpart of ``tinyrenderder_tpu/utils/tga.py`` (the reference's
``tgaimage.{h,cpp}``): the ``TGAImage`` class and image types 2/3
(uncompressed true-colour/grayscale) and 10/11 (RLE), 8/24/32 bpp, both
flip bits of the image descriptor.  Pixels are a (h, w, bpp) uint8 array
in the reference's in-memory order (**B, G, R[, A]**, raw TGA bytes),
row 0 the top row after ``read``'s flips; ``to_rgb`` / ``from_rgb``
convert at the boundary.  Writing defaults to vflip=True, rle=True like
tgaimage.h:75-77, byte-identical to the reference encoder's greedy RLE
(tgaimage.cpp:193-242).  RLE encode and decode go through the C++ codec
of ``native/`` (``utils/native.py``) when it builds; the Python loops
(``_encode_rle_py``, ``_decode_rle_py``) are the plain versions, byte
for byte the same.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from tinyrenderder_tpu_torch.utils import native

__all__ = ["TGAImage", "read", "write", "GRAYSCALE", "RGB", "RGBA"]

GRAYSCALE = 1
RGB = 3
RGBA = 4

_HEADER_FMT = "<BBBHHBHHHHBB"  # tgaimage.h:10-25 (packed, little-endian)
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)


@dataclass
class _Header:
    idlength: int = 0
    colormaptype: int = 0
    datatypecode: int = 2
    colormaporigin: int = 0
    colormaplength: int = 0
    colormapdepth: int = 0
    x_origin: int = 0
    y_origin: int = 0
    width: int = 0
    height: int = 0
    bitsperpixel: int = 24
    imagedescriptor: int = 0

    def pack(self) -> bytes:
        return struct.pack(
            _HEADER_FMT, self.idlength, self.colormaptype, self.datatypecode,
            self.colormaporigin, self.colormaplength, self.colormapdepth,
            self.x_origin, self.y_origin, self.width, self.height,
            self.bitsperpixel, self.imagedescriptor)

    @classmethod
    def unpack(cls, raw: bytes) -> "_Header":
        return cls(*struct.unpack(_HEADER_FMT, raw))


def _decode_rle(raw: bytes, w: int, h: int, bpp: int) -> np.ndarray:
    """RLE decode (tgaimage.cpp:124-157). Returns flat (h*w, bpp) bytes."""
    if native.available():
        return native.rle_decode(raw, w, h, bpp)
    return _decode_rle_py(raw, w, h, bpp)


def _decode_rle_py(raw: bytes, w: int, h: int, bpp: int) -> np.ndarray:
    """``_decode_rle`` in Python."""
    out = np.empty((h * w, bpp), dtype=np.uint8)
    buf = np.frombuffer(raw, dtype=np.uint8)
    pos = 0
    pixel = 0
    total = h * w
    while pixel < total:
        if pos >= buf.size:
            raise ValueError("truncated RLE data in TGA file")
        header = int(buf[pos])
        pos += 1
        if header < 128:                      # raw packet: header+1 literal pixels
            count = header + 1
            if pos + count * bpp > buf.size:
                raise ValueError("truncated RLE packet in TGA file")
            chunk = buf[pos:pos + count * bpp].reshape(count, bpp)
            pos += count * bpp
            out[pixel:pixel + count] = chunk[: total - pixel]
            pixel += count
        else:                                 # run packet: header-127 copies
            count = header - 127
            if pos + bpp > buf.size:
                raise ValueError("truncated RLE run in TGA file")
            value = buf[pos:pos + bpp]
            pos += bpp
            out[pixel:pixel + count] = value
            pixel += count
    return out


def _encode_rle(flat: np.ndarray, bpp: int) -> bytes:
    """Greedy RLE encode, byte-identical to tgaimage.cpp:193-242: at each
    position measure the run of pixels equal to the current one (max
    128); a run of 2 or more becomes an RLE packet, otherwise a raw
    packet extends until the next two pixels are equal (max 128)."""
    if native.available():
        return native.rle_encode(flat, bpp)
    return _encode_rle_py(flat, bpp)


def _encode_rle_py(flat: np.ndarray, bpp: int) -> bytes:
    """``_encode_rle`` in Python."""
    n = flat.shape[0]
    # eq_prev[i] = pixel i equals pixel i-1 (False for i == 0)
    eq_prev = np.zeros(n, dtype=bool)
    if n > 1:
        eq_prev[1:] = np.all(flat[1:] == flat[:-1], axis=1)
    out = bytearray()
    cur = 0
    while cur < n:
        run = 1
        while cur + run < n and run < 128 and eq_prev[cur + run]:
            run += 1
        if run > 1:
            out.append(run - 1 + 128)
            out += flat[cur].tobytes()
            cur += run
        else:
            raw_len = 1
            while cur + raw_len < n and raw_len < 128 and not eq_prev[cur + raw_len]:
                raw_len += 1
            out.append(raw_len - 1)
            out += flat[cur:cur + raw_len].tobytes()
            cur += raw_len
    return bytes(out)


def read(path) -> "TGAImage":
    """Read a TGA file (tgaimage.cpp:76-122), applying the descriptor's
    flips so that row 0 is the top image row.  Raises ValueError on
    malformed input (the reference returns false)."""
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < _HEADER_SIZE:
        raise ValueError(f"can't read TGA header: {path}")
    hdr = _Header.unpack(raw[:_HEADER_SIZE])
    w, h = hdr.width, hdr.height
    bpp = hdr.bitsperpixel >> 3
    if w <= 0 or h <= 0 or bpp not in (1, 3, 4):
        raise ValueError(f"invalid TGA format: {path}")
    body = raw[_HEADER_SIZE + hdr.idlength:]
    if hdr.datatypecode in (2, 3):
        flat = np.frombuffer(body[: h * w * bpp], dtype=np.uint8).reshape(h * w, bpp)
        flat = flat.copy()
    elif hdr.datatypecode in (10, 11):
        flat = _decode_rle(body, w, h, bpp)
    else:
        raise ValueError(f"unknown TGA type {hdr.datatypecode}: {path}")
    data = flat.reshape(h, w, bpp)
    if not (hdr.imagedescriptor & 0x20):  # bottom-left origin file -> flip rows
        data = data[::-1]
    if hdr.imagedescriptor & 0x10:
        data = data[:, ::-1]
    return TGAImage(data=np.ascontiguousarray(data))


def write(img: "TGAImage", path, vflip: bool = True, rle: bool = True) -> None:
    """Write a TGA file (tgaimage.cpp:161-191).  With vflip=True the
    header declares a bottom-left origin and rows are emitted in memory
    order, byte for byte as the reference writes them."""
    h, w, bpp = img.data.shape
    hdr = _Header(
        bitsperpixel=bpp * 8,
        width=w,
        height=h,
        datatypecode=(11 if rle else 3) if bpp == 1 else (10 if rle else 2),
        imagedescriptor=0x00 if vflip else 0x20,
    )
    flat = img.data.reshape(h * w, bpp)
    with open(path, "wb") as f:
        f.write(hdr.pack())
        if rle:
            f.write(_encode_rle(flat, bpp))
        else:
            f.write(flat.tobytes())


class TGAImage:
    """An image over a (h, w, bpp) uint8 BGRA-order array (tgaimage.h:67-104):
    pixel access that tolerates out-of-bounds, flips, nearest-neighbour
    scale, separable Gaussian blur, read and write."""

    def __init__(self, width: int = 0, height: int = 0, bpp: int = RGB,
                 data: np.ndarray | None = None):
        if data is not None:
            self.data = np.asarray(data, dtype=np.uint8)
            if self.data.ndim == 2:
                self.data = self.data[..., None]
        else:
            self.data = np.zeros((height, width, bpp), dtype=np.uint8)

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def bpp(self) -> int:
        return self.data.shape[2]

    # -- pixel access (tgaimage.cpp:24-39) ----------------------------------
    def get(self, x: int, y: int) -> np.ndarray:
        """4 bytes in file order (BGR[A] / gray, zero-filled); zeros out of
        bounds."""
        if x < 0 or y < 0 or x >= self.width or y >= self.height:
            return np.zeros(4, dtype=np.uint8)
        px = self.data[y, x]
        return np.concatenate([px, np.zeros(4 - len(px), dtype=np.uint8)])

    def set(self, x: int, y: int, color) -> None:
        if x < 0 or y < 0 or x >= self.width or y >= self.height:
            return
        self.data[y, x] = np.asarray(color, dtype=np.uint8)[: self.bpp]

    def to_rgb(self) -> np.ndarray:
        """(h, w, c) uint8 with channels reordered to RGB[A] (gray passthrough)."""
        if self.bpp == 1:
            return self.data.copy()
        rgb = self.data[..., [2, 1, 0]]
        if self.bpp == 4:
            return np.concatenate([rgb, self.data[..., 3:4]], axis=-1)
        return np.ascontiguousarray(rgb)

    @classmethod
    def from_rgb(cls, rgb: np.ndarray) -> "TGAImage":
        rgb = np.asarray(rgb, dtype=np.uint8)
        if rgb.ndim == 2 or rgb.shape[-1] == 1:
            return cls(data=rgb.reshape(rgb.shape[0], rgb.shape[1], 1))
        bgr = rgb[..., [2, 1, 0]]
        if rgb.shape[-1] == 4:
            bgr = np.concatenate([bgr, rgb[..., 3:4]], axis=-1)
        return cls(data=np.ascontiguousarray(bgr))

    # -- flips (tgaimage.cpp:43-72) ------------------------------------------
    def flip_horizontally(self) -> None:
        self.data = np.ascontiguousarray(self.data[:, ::-1])

    def flip_vertically(self) -> None:
        self.data = np.ascontiguousarray(self.data[::-1])

    # -- resampling (tgaimage.cpp:246-324) -----------------------------------
    def scale(self, w2: int, h2: int) -> bool:
        """Nearest-neighbour resize: src = dst * old // new."""
        if w2 <= 0 or h2 <= 0 or self.data.size == 0:
            return False
        h, w = self.height, self.width
        xs = (np.arange(w2) * w) // w2
        ys = (np.arange(h2) * h) // h2
        self.data = np.ascontiguousarray(self.data[ys[:, None], xs[None, :]])
        return True

    def gaussian_blur(self, radius: int) -> None:
        """Separable Gaussian blur: a float32 kernel with sigma = radius / 2,
        clamp-to-edge, a truncating cast to uint8 after each pass."""
        if radius <= 0 or self.data.size == 0:
            return
        i = np.arange(-radius, radius + 1, dtype=np.float32)
        sigma = np.float32(radius) / np.float32(2.0)
        kernel = np.exp(-(i * i) / (2 * sigma * sigma)).astype(np.float32)
        kernel /= kernel.sum()

        def one_pass(data: np.ndarray, axis: int) -> np.ndarray:
            # edge-clamped windows over a view, summed (f32, taps last) in
            # row blocks of at most 64 MB of floats
            pad = [(0, 0)] * data.ndim
            pad[axis] = (radius, radius)
            padded = np.pad(data, pad, mode="edge")
            win = np.lib.stride_tricks.sliding_window_view(padded, 2 * radius + 1, axis=axis)
            out = np.empty(data.shape, np.uint8)
            block = max(1, (64 << 20) // max(data[0].size * (2 * radius + 1) * 4, 1))
            for r0 in range(0, data.shape[0], block):
                w = win[r0:r0 + block].astype(np.float32)
                out[r0:r0 + block] = (w * kernel).sum(axis=-1).astype(np.uint8)  # C trunc
            return out

        self.data = one_pass(self.data, axis=1)   # horizontal
        self.data = one_pass(self.data, axis=0)   # vertical

    # -- file I/O ---------------------------------------------------------------
    def read_tga_file(self, path) -> bool:
        try:
            self.data = read(path).data
            return True
        except (OSError, ValueError):
            return False

    def write_tga_file(self, path, vflip: bool = True, rle: bool = True) -> bool:
        try:
            write(self, path, vflip=vflip, rle=rle)
            return True
        except OSError:
            return False
