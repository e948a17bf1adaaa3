"""PNG and BMP to the 32×32 grayscale grid that pHash reads, as PIL gives it.

The port's counterpart of ``image_to_grid`` in ``spacedrive_tpu/ops/phash.py``
(``PIL.Image.open(p).convert("L").resize((32, 32), Image.LANCZOS)``). The
machine with the card has no PIL, and a pHash bit flips when one grid value
moves by one, so this decoder gives PIL's grid bit for bit on what it takes
and raises ``UnsupportedImage`` on everything else:

- PNG, not interlaced, 8-bit gray, RGB, palette, gray + alpha and RGBA, and
  palette or gray at 1, 2 or 4 bits; chunk CRCs are checked, IDAT is
  inflated with ``zlib``, rows are unfiltered (None, Sub, Up, Average,
  Paeth) by ``csrc/imgdec.cpp``;
- BMP, uncompressed, at 24 and 32 bits and 8-bit palette (3 to 256 colours).

JPEG, GIF, TIFF, WebP, HEIF, 16-bit or interlaced PNG, BMP bit fields or RLE
raise. What PIL does, and this module with it:

- to L: RGB, RGBA and BGR(X) pixels go through ``L24``,
  ``(R·19595 + G·38470 + B·7471 + 0x8000) >> 16``, alpha is dropped, a
  palette index through ``L24`` of its entry, 1/2/4-bit gray expands to
  0..255 (×255, ×0x55, ×0x11); transparency (tRNS) never changes L;
- LANCZOS: separable, support 3 scaled by the reduction factor, weights
  normalised in double and rounded to 22-bit fixed point, a horizontal pass
  rounded and clipped to uint8, then the vertical pass; a side already 32
  px long is not resampled. Each pass here is one float64 matrix product of
  integer values: every product is below 2**30 and every sum below 2**53,
  so BLAS carries it exactly in any order.

``png_unfilter_plain`` is the plain version of the native unfilter: the
tests and ``chip_smoke.py`` decode with ``native=False`` to hold one
against the other; nothing on the main path runs it.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import Optional

import numpy as np

GRID_EDGE = 32
PRECISION_BITS = 22  # PIL's Resample.c: 32 - 8 - 2
LANCZOS_SUPPORT = 3.0
# PIL's decompression-bomb error limit (2 × MAX_IMAGE_PIXELS): past it PIL
# refuses the image, and so does this module.
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type → channels, and the bit depths each allows here.
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
PNG_DEPTHS = {0: (1, 2, 4, 8), 2: (8,), 3: (1, 2, 4, 8), 4: (8,), 6: (8,)}
# PIL's unpackers of 1/2/4-bit gray ("1", "L;2", "L;4") scale to 0..255.
GRAY_SCALE = {1: 255, 2: 0x55, 4: 0x11, 8: 1}
BMP_HEADERS = (40, 52, 56, 64, 108, 124)  # BITMAPINFOHEADER .. V5


class UnsupportedImage(ValueError):
    """The bytes are not an image this decoder gives PIL's grid for."""


def image_to_grid(path: str, *, native: bool = True) -> Optional[np.ndarray]:
    """Decode + grayscale + resize to [32, 32] float32; None when the file
    cannot be read or is not a supported PNG or BMP. A fault of the native
    plane (its build or load, or a wrapper's argument check) raises."""
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    try:
        return decode_grid(data, native=native)
    except (UnsupportedImage, zlib.error):
        return None


def decode_grid(data: bytes, *, native: bool = True) -> np.ndarray:
    """Image bytes → [32, 32] float32 grid; raises UnsupportedImage.
    `native` runs the unfilter, L24 and resample of ``csrc/imgdec.cpp``;
    False runs their plain versions here."""
    luma = decode_luma(data, native=native)
    if native:
        from .. import native as plane
        return plane.resample_lanczos(luma, GRID_EDGE).astype(np.float32)
    return resize_lanczos(luma).astype(np.float32)


def decode_luma(data: bytes, *, native: bool = True) -> np.ndarray:
    """Image bytes → [h, w] uint8, PIL's ``convert("L")``."""
    if data[:8] == PNG_SIGNATURE:
        return _png_luma(data, native)
    if data[:2] == b"BM":
        return _bmp_luma(data, native)
    raise UnsupportedImage("not a PNG or BMP")


def _rgb_to_l(pixels: np.ndarray, order, native: bool) -> np.ndarray:
    """[h, w, c] pixels with R, G, B at channel offsets `order` → L."""
    if native:
        from .. import native as plane
        return plane.luma(pixels, order)
    return l24(pixels[..., list(order)])


def l24(rgb: np.ndarray) -> np.ndarray:
    """[..., >= 3] uint8 RGB(…) → [...] uint8 L, PIL's rgb2l."""
    r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def _check_size(w: int, h: int) -> None:
    if w < 1 or h < 1 or w * h > MAX_PIXELS:
        raise UnsupportedImage(f"image size {w}x{h}")


# -- PNG ---------------------------------------------------------------------


def _unknown_critical(ctype: bytes) -> bool:
    return not ctype[0] & 0x20 and ctype not in (b"IHDR", b"PLTE", b"IDAT", b"IEND")


def _png_chunks(data: bytes):
    """(type, payload) of each chunk PIL reads, in its order.

    Up to the first IDAT every chunk is whole and its CRC checked (PIL
    refuses a bad one there). From the first IDAT the CRCs are skipped and
    the walk ends at the first chunk that is not IDAT, or at the end of the
    file: like PIL, a file that ends, or carries junk, after its last IDAT
    is read, and no chunk after the IDAT run changes the image; the inflate
    decides whether the IDAT data was whole. An unknown critical chunk
    there is still refused."""
    pos, in_idat = len(PNG_SIGNATURE), False
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        end = pos + 8 + length
        if in_idat and ctype != b"IDAT":
            if ctype.isalpha() and _unknown_critical(ctype):
                raise UnsupportedImage(f"unknown critical PNG chunk {ctype!r}")
            return
        if ctype == b"IDAT":
            in_idat = True
            yield ctype, data[pos + 8:min(end, len(data))]
        else:
            if end + 4 > len(data):
                raise UnsupportedImage(f"truncated PNG chunk {ctype!r}")
            payload = data[pos + 8:end]
            if zlib.crc32(payload, zlib.crc32(ctype)) != struct.unpack_from(">I", data, end)[0]:
                raise UnsupportedImage(f"bad CRC in PNG chunk {ctype!r}")
            yield ctype, payload
        pos = end + 4
    if not in_idat:
        raise UnsupportedImage("truncated PNG: no IDAT")


def _png_luma(data: bytes, native: bool) -> np.ndarray:
    header, palette, idat = None, None, []
    for ctype, payload in _png_chunks(data):
        if header is None and ctype != b"IHDR":
            raise UnsupportedImage("PNG does not start with IHDR")
        if ctype == b"IHDR":
            if header is not None or len(payload) != 13:
                raise UnsupportedImage("bad IHDR")
            header = struct.unpack(">IIBBBBB", payload)
        elif ctype == b"PLTE":
            if len(payload) % 3 or not 0 < len(payload) <= 768:
                raise UnsupportedImage("bad PLTE")
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype == b"IEND":
            break
        elif _unknown_critical(ctype):
            raise UnsupportedImage(f"unknown critical PNG chunk {ctype!r}")
    w, h, depth, ctype, compression, filtering, interlace = header
    if ctype not in PNG_CHANNELS or depth not in PNG_DEPTHS[ctype]:
        raise UnsupportedImage(f"PNG colour type {ctype} at {depth} bits")
    if compression or filtering or interlace:
        raise UnsupportedImage("interlaced or non-standard PNG")
    _check_size(w, h)
    if ctype == 3 and palette is None:
        raise UnsupportedImage("palette PNG without PLTE")
    channels = PNG_CHANNELS[ctype]
    rowbytes = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    need = h * (rowbytes + 1)
    inflater = zlib.decompressobj()
    raw = inflater.decompress(b"".join(idat), need)
    if len(raw) < need:
        raise UnsupportedImage("truncated PNG image data")
    if native:
        from .. import native as plane
        rows = plane.png_unfilter(raw, h, rowbytes, bpp)
    else:
        rows = png_unfilter_plain(raw, h, rowbytes, bpp)

    if depth < 8:
        per = 8 // depth
        shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint8)
        values = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        rows = values.reshape(h, rowbytes * per)[:, :w]
    if ctype == 0:
        return rows * np.uint8(GRAY_SCALE[depth])
    if ctype == 3:
        if int(rows.max()) >= len(palette):
            raise UnsupportedImage("palette index past PLTE")
        return l24(palette)[rows]
    pixels = rows.reshape(h, w, channels)
    return pixels[..., 0].copy() if ctype == 4 else _rgb_to_l(pixels, (0, 1, 2), native)


def _paeth(a: int, b: int, c: int) -> int:
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def png_unfilter_plain(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Plain version of ``native.png_unfilter``: h filtered rows of
    1 + rowbytes bytes → [h, rowbytes] uint8. Sub and Up are vectorised;
    Average and Paeth carry a per-byte dependency along the row and run
    byte by byte."""
    out = np.zeros((h, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.uint8)
    stride = rowbytes + 1
    for y in range(h):
        kind = raw[y * stride]
        src = np.frombuffer(raw, np.uint8, rowbytes, y * stride + 1)
        if kind == 0:
            cur = src.copy()
        elif kind == 1:
            cur = np.cumsum(src.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = src + prev
        elif kind in (3, 4):
            s, p = src.tolist(), prev.tolist()
            c = [0] * rowbytes
            for i in range(rowbytes):
                a = c[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (a + p[i]) >> 1
                else:
                    pred = _paeth(a, p[i], p[i - bpp] if i >= bpp else 0)
                c[i] = (s[i] + pred) & 0xFF
            cur = np.array(c, np.uint8)
        else:
            raise UnsupportedImage(f"PNG filter type {kind} in row {y}")
        out[y] = cur
        prev = cur
    return out


# -- BMP ---------------------------------------------------------------------


def _bmp_luma(data: bytes, native: bool) -> np.ndarray:
    if len(data) < 18:
        raise UnsupportedImage("truncated BMP header")
    offset, header_size = struct.unpack_from("<II", data, 10)
    if header_size not in BMP_HEADERS or len(data) < 14 + header_size:
        raise UnsupportedImage(f"BMP header of {header_size} bytes")
    w, h_raw, planes, bits, compression = struct.unpack_from("<iIHHI", data, 18)
    colors = struct.unpack_from("<I", data, 46)[0] or (1 << bits)
    top_down = data[25] == 0xFF  # PIL reads a negative height by its top byte
    h = 2**32 - h_raw if top_down else h_raw
    if compression != 0 or planes != 1 or bits not in (8, 24, 32):
        raise UnsupportedImage(
            f"BMP at {bits} bits, compression {compression}, {planes} planes")
    _check_size(w, h)
    if bits == 8:
        if not 3 <= colors <= 256 or 14 + header_size + 4 * colors > len(data):
            raise UnsupportedImage(f"8-bit BMP with {colors} colours")
        if offset == 14 + header_size:
            offset += 4 * colors  # PIL: an offset that skips no palette
    stride = ((w * bits + 31) >> 3) & ~3
    if offset < 14 + header_size or offset + stride * h > len(data):
        raise UnsupportedImage("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if bits == 8:
        table = np.frombuffer(data, np.uint8, 4 * colors, 14 + header_size).reshape(-1, 4)
        idx = rows[:, :w]
        if int(idx.max()) >= colors:
            raise UnsupportedImage("BMP palette index past its table")
        luma = l24(table[:, 2::-1])[idx]
    else:
        pixels = rows[:, :w * (bits // 8)].reshape(h, w, bits // 8)
        luma = _rgb_to_l(pixels, (2, 1, 0), native)
    return luma if top_down else luma[::-1]


# -- LANCZOS resample --------------------------------------------------------


def _lanczos(x: float) -> float:
    def sinc(v: float) -> float:
        if v == 0.0:
            return 1.0
        v = v * math.pi
        return math.sin(v) / v

    if -LANCZOS_SUPPORT <= x < LANCZOS_SUPPORT:
        return sinc(x) * sinc(x / 3)
    return 0.0


@functools.lru_cache(maxsize=1024)
def lanczos_coeffs(in_size: int, out_size: int = GRID_EDGE) -> np.ndarray:
    """[out_size, in_size] float64 of PIL's fixed-point LANCZOS weights
    (Resample.c ``precompute_coeffs`` + ``normalize_coeffs_8bpc``): integer
    values, zero outside each output's taps. Cached, read-only."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ss = 1.0 / filterscale
    out = np.zeros((out_size, in_size), np.float64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        weights = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for wgt in weights:
            total += wgt
        for x, wgt in enumerate(weights):
            if total != 0.0:
                wgt /= total
            fixed = wgt * (1 << PRECISION_BITS)
            out[xx, xmin + x] = int(fixed - 0.5) if wgt < 0 else int(fixed + 0.5)
    out.flags.writeable = False
    return out


def _clip8(acc: np.ndarray) -> np.ndarray:
    """PIL's clip8 of the rounded fixed-point sums."""
    shifted = np.floor((acc + (1 << (PRECISION_BITS - 1))) / (1 << PRECISION_BITS))
    return np.clip(shifted, 0, 255)


def resize_lanczos(luma: np.ndarray, edge: int = GRID_EDGE) -> np.ndarray:
    """[h, w] uint8 → [edge, edge] uint8, PIL's ``resize((edge, edge),
    LANCZOS)`` on an L image: horizontal pass, then vertical."""
    h, w = luma.shape
    out = luma.astype(np.float64)
    if w != edge:
        out = _clip8(out @ lanczos_coeffs(w, edge).T)
    if h != edge:
        out = _clip8(lanczos_coeffs(h, edge) @ out)
    return out.astype(np.uint8)
