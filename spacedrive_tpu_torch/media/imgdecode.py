"""Image files to the 32×32 grayscale grid that pHash reads, as PIL gives it.

The port's counterpart of ``image_to_grid`` in ``spacedrive_tpu/ops/phash.py``
(``PIL.Image.open(p).convert("L").resize((32, 32), Image.LANCZOS)``). The
machine with the card has no PIL, and a pHash bit flips when one grid value
moves by one, so this decoder gives PIL's grid bit for bit on what it takes
and raises ``UnsupportedImage`` on everything else. The format is read
from the bytes' signature, as PIL finds it, never from the file's name:

- PNG, 8-bit gray, RGB, palette, gray + alpha and RGBA, palette or gray at
  1, 2 or 4 bits, and gray, RGB, gray + alpha and RGBA at 16 bits, plain or
  Adam7-interlaced; chunk CRCs are checked, IDAT is inflated with ``zlib``,
  rows are unfiltered (None, Sub, Up, Average, Paeth) by
  ``csrc/imgdec.cpp``, one Adam7 pass at a time;
- BMP, uncompressed, at 24 and 32 bits and 8-bit palette (3 to 256 colours);
- JPEG, baseline, extended and progressive, one, three or four
  components, the last CMYK as PIL reads it (``media/jpeg.py``,
  ``csrc/jpegdec.cpp``);
- GIF, the first frame (``media/gif.py``, its LZW in ``csrc/imgdec.cpp``);
- ICO, the frame PIL takes: a PNG frame as above, or a DIB at 1, 4, 8, 24
  or 32 bits;
- TIFF and DNG's first IFD: none, LZW, Deflate and PackBits, predictor 2,
  strips and tiles, chunky and planar, II and MM, little-endian BigTIFF,
  gray at 1-16 bits, RGB(A) at 8 and 16, palette (``media/tiff.py``, its
  strips and tiles in ``csrc/tiffdec.cpp``);
- WebP: lossless, lossy, with ALPH, an animation's first frame on its
  canvas (``media/webp.py``, ``csrc/webpdec.cpp``).

HEIF/AVIF (PIL here has no HEIF plugin and reads AVIF through libavif; the
port decodes neither HEVC nor AV1), BMP bit fields or RLE, 1/4-bit BMP
files, ≤ 2-colour 8-bit BMP, and what ``media/jpeg.py``, ``media/gif.py``,
``media/tiff.py`` and ``media/webp.py`` list raise.
What PIL does, and this module with it:

- to L: RGB, RGBA and BGR(X) pixels go through ``L24``,
  ``(R·19595 + G·38470 + B·7471 + 0x8000) >> 16``, alpha is dropped, a
  palette index through ``L24`` of its entry, 1/2/4-bit gray expands to
  0..255 (×255, ×0x55, ×0x11), 16-bit gray (``I;16``) clips at 255, 16-bit
  colour keeps each sample's high byte (``RGB;16B``, ``RGBA;16B``,
  ``LA;16B``), CMYK goes through ``cmyk2rgb`` then ``L24``; transparency
  (tRNS, GIF's transparent index) never changes L;
- LANCZOS: separable, support 3 scaled by the reduction factor, weights
  normalised in double and rounded to 22-bit fixed point, a horizontal pass
  rounded and clipped to uint8, then the vertical pass; a side already 32
  px long is not resampled. The plain passes sum each output's taps in
  int64, as Resample.c sums them in int32.

``native=False`` runs the plain versions of the native passes
(``png_unfilter_plain``, ``l24``, ``resize_lanczos``,
``jpeg.decode_plain``, ``gif.lzw_plain``, ``tiff.chunk_plain``,
``webp.lossless_plain``, ``webp.lossy_plain``, ``webp.alpha_plain``): the
tests and ``chip_smoke.py``
decode with it to hold one against the other; nothing on the main path
runs them, and no fault of the native plane falls back to them.
"""

from __future__ import annotations

import functools
import math
import struct
import zlib
from typing import NamedTuple, Optional, Tuple

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
PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (first column, first row, column step, row step).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))
# PIL's unpackers of 1/2/4-bit gray ("1", "L;2", "L;4") scale to 0..255.
GRAY_SCALE = {1: 255, 2: 0x55, 4: 0x11, 8: 1}
BMP_HEADERS = (40, 52, 56, 64, 108, 124)  # BITMAPINFOHEADER .. V5
JPEG_SIGNATURE = b"\xff\xd8\xff"
GIF_SIGNATURES = (b"GIF87a", b"GIF89a")
ICO_SIGNATURE = b"\x00\x00\x01\x00"
# PIL's TIFF prefixes: classic and BigTIFF, and the two "invalid" classic
# headers it still takes.
TIFF_SIGNATURES = (b"II*\x00", b"MM\x00*", b"II\x00*", b"MM*\x00", b"II+\x00", b"MM\x00+")
WEBP_CHUNKS = (b"VP8 ", b"VP8L", b"VP8X")  # the first chunks PIL takes


class UnsupportedImage(ValueError):
    """The bytes are not an image this decoder gives PIL's grid for."""


def image_to_grid(path: str, *, native: bool = True) -> Optional[np.ndarray]:
    """Decode + grayscale + resize to [32, 32] float32; None when the file
    cannot be read or is not an image this module takes. A fault of the
    native plane (its build or load, or a wrapper's argument check)
    raises."""
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
    `native` runs the native decoders and passes of ``csrc/imgdec.cpp`` and
    ``csrc/jpegdec.cpp``; False runs their plain versions."""
    luma = decode_luma(data, native=native)
    if native:
        from .. import native as plane
        return plane.resample_lanczos(luma, GRID_EDGE).astype(np.float32)
    return resize_lanczos(luma).astype(np.float32)


class Decoded(NamedTuple):
    """A decoded image as its decoder holds it: `pixels` in PIL's `mode`
    ("1", "L", "LA", "I;16", "P", "RGB", "RGBA"). "1" and "L" are [h, w]
    uint8 (a "1" pixel is 0 or 255, as PIL stores it), "LA" [h, w, 2],
    "I;16" [h, w] uint16, "P" [h, w] indices into `palette` ([n, 3] RGB);
    "RGB" and "RGBA" [h, w, c] bytes with R, G, B (and A) at the byte
    offsets `order` of a pixel (BMP's BGR, 16-bit samples' high bytes)."""
    pixels: np.ndarray
    mode: str
    palette: Optional[np.ndarray] = None
    order: Tuple[int, ...] = (0, 1, 2, 3)


def decode_luma(data: bytes, *, native: bool = True) -> np.ndarray:
    """Image bytes → [h, w] uint8, PIL's ``convert("L")``. The format is
    the one the bytes' signature names, as PIL finds it; the file's name
    plays no part. A WebP's alpha plane is checked but not built."""
    return to_luma(decode(data, native=native, alpha=False), native)


def decode_image(data: bytes, *, native: bool = True) -> Tuple[np.ndarray, str]:
    """Image bytes → (pixels, mode): PIL's mode of ``Image.open(...)
    .load()`` and its pixels, "RGB" and "RGBA" in that band order, "LA"
    [h, w, 2], "CMYK" [h, w, 4], "I;16" [h, w] uint16, "1" and "L" [h, w];
    a "P" image's
    pixels are its palette's colours [h, w, 3] (the lookup PIL's
    ``convert`` makes; the indices are not kept)."""
    d = decode(data, native=native)
    if d.mode == "P":
        return d.palette[d.pixels], "P"
    if d.mode in ("RGB", "RGBA"):
        n = len(d.mode)
        if d.pixels.shape[-1] == n and tuple(d.order[:n]) == tuple(range(n)):
            return d.pixels, d.mode
        return d.pixels[..., list(d.order[:n])], d.mode
    return d.pixels, d.mode


def decode(data: bytes, *, native: bool = True, alpha: bool = True) -> Decoded:
    """Image bytes → ``Decoded``; raises UnsupportedImage. `alpha` False
    lets a WebP skip its alpha plane (``webp.decode_image``), as the luma
    path drops it; the other formats hold alpha as they decode."""
    if data[:8] == PNG_SIGNATURE:
        return _png_decode(data, native)
    if data[:2] == b"BM":
        return _bmp_decode(data, native)
    if data[:3] == JPEG_SIGNATURE:
        return _jpeg_decode(data, native)
    if data[:6] in GIF_SIGNATURES:
        from . import gif
        return gif.decode(data, native)
    if data[:4] == ICO_SIGNATURE:
        return _ico_decode(data, native)
    if data[:4] in TIFF_SIGNATURES:
        from . import tiff
        return tiff.decode(data, native)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in WEBP_CHUNKS:
        from . import webp
        pixels, mode = webp.decode_image(data, native, alpha)
        return Decoded(pixels, mode)
    if data[4:8] == b"ftyp":
        raise UnsupportedImage("HEIF or AVIF (an ISO BMFF file): the port decodes neither "
                               "HEVC nor AV1")
    raise UnsupportedImage("not a PNG, BMP, JPEG, GIF, ICO, TIFF or WebP")


def to_luma(d: Decoded, native: bool) -> np.ndarray:
    """PIL's ``convert("L")`` of a decoded image: L24 of the colour, alpha
    dropped, I;16 clipped at 255, CMYK through ``cmyk2rgb`` first."""
    if d.mode in ("1", "L"):
        return d.pixels
    if d.mode == "LA":
        return d.pixels[..., 0].copy()
    if d.mode == "I;16":
        return np.minimum(d.pixels, 255).astype(np.uint8)
    if d.mode == "P":
        return l24(d.palette)[d.pixels]
    if d.mode == "CMYK":
        return _rgb_to_l(thumb_rgb(d.pixels, "CMYK", native=native), (0, 1, 2), native)
    return _rgb_to_l(d.pixels, d.order[:3], native)


def _jpeg_decode(data: bytes, native: bool) -> Decoded:
    from . import jpeg
    if native:
        from .. import native as plane
        px = plane.jpeg_decode(data)
    else:
        px = jpeg.decode_plain(data)
    return Decoded(px, "L" if px.ndim == 2 else "RGB" if px.shape[2] == 3 else "CMYK")


def _rgb_to_l(pixels: np.ndarray, order, native: bool) -> np.ndarray:
    """[h, w, c] pixels with R, G, B at channel offsets `order` → L."""
    if pixels.strides[0] < 0:  # bottom-up rows (BMP, ICO): a view
        return _rgb_to_l(pixels[::-1], order, native)[::-1]
    if native:
        from .. import native as plane
        return plane.luma(pixels, tuple(order))
    return l24(pixels[..., list(order)])


def l24(rgb: np.ndarray) -> np.ndarray:
    """[..., >= 3] uint8 RGB(…) → [...] uint8 L, PIL's rgb2l."""
    r, g, b = (rgb[..., k].astype(np.uint32) for k in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def check_size(w: int, h: int) -> None:
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


def _png_decode(data: bytes, native: bool) -> Decoded:
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
    if compression or filtering or interlace > 1:
        raise UnsupportedImage("non-standard PNG")
    check_size(w, h)
    if ctype == 3 and palette is None:
        raise UnsupportedImage("palette PNG without PLTE")
    channels = PNG_CHANNELS[ctype]
    passes = ([(x0, y0, dx, dy, -(-(w - x0) // dx), -(-(h - y0) // dy))
               for x0, y0, dx, dy in ADAM7 if w > x0 and h > y0] if interlace
              else [(0, 0, 1, 1, w, h)])
    sizes = [ph * (1 + (pw * channels * depth + 7) // 8) for *_, pw, ph in passes]
    inflater = zlib.decompressobj()
    raw = inflater.decompress(b"".join(idat), sum(sizes))
    if len(raw) < sum(sizes):
        raise UnsupportedImage("truncated PNG image data")
    # Samples: [h, w] of one channel at up to 8 bits, else [h, w, bytes
    # per pixel].
    shape = (h, w) if channels == 1 and depth <= 8 else (h, w, channels * depth // 8)
    pix = np.zeros(shape, np.uint8) if interlace else None
    offset = 0
    for (x0, y0, dx, dy, pw, ph), size in zip(passes, sizes):
        sub = _png_samples(raw[offset:offset + size], pw, ph, channels, depth, native)
        offset += size
        if not interlace:
            pix = sub
        else:
            pix[y0::dy, x0::dx] = sub
    if ctype == 0:
        if depth == 16:  # I;16B
            return Decoded((pix[..., 0].astype(np.uint16) << 8) | pix[..., 1], "I;16")
        return Decoded(pix * np.uint8(GRAY_SCALE[depth]), "1" if depth == 1 else "L")
    if ctype == 3:
        if int(pix.max()) >= len(palette):
            raise UnsupportedImage("palette index past PLTE")
        return Decoded(pix, "P", palette)
    if ctype == 4:  # LA, or LA;16B unpacked to RGBA: the high bytes
        return Decoded(pix, "LA") if depth == 8 else Decoded(pix, "RGBA", order=(0, 0, 0, 2))
    step = depth // 8  # high bytes of RGB;16B and RGBA;16B
    return Decoded(pix, "RGB" if ctype == 2 else "RGBA", order=(0, step, 2 * step, 3 * step))


def _png_samples(raw: bytes, w: int, h: int, channels: int, depth: int,
                 native: bool) -> np.ndarray:
    """One (sub)image's filtered scanlines → [h, w] uint8 values of one
    channel at up to 8 bits, else [h, w, bytes per pixel] uint8."""
    rowbytes = (w * channels * depth + 7) // 8
    bpp = max(1, channels * depth // 8)
    if native:
        from .. import native as plane
        rows = plane.png_unfilter(raw, h, rowbytes, bpp)
    else:
        rows = png_unfilter_plain(raw, h, rowbytes, bpp)
    if depth < 8:
        per = 8 // depth
        shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint8)
        values = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        return values.reshape(h, rowbytes * per)[:, :w]
    return rows if channels * depth == 8 else rows.reshape(h, w, bpp)


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


def _bmp_decode(data: bytes, native: bool) -> Decoded:
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
    check_size(w, h)
    if bits == 8:
        if not 3 <= colors <= 256 or 14 + header_size + 4 * colors > len(data):
            raise UnsupportedImage(f"8-bit BMP with {colors} colours")
        if offset == 14 + header_size:
            offset += 4 * colors  # PIL: an offset that skips no palette
    stride = ((w * bits + 31) >> 3) & ~3
    if offset < 14 + header_size or offset + stride * h > len(data):
        raise UnsupportedImage("truncated BMP pixel data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bits == 8:
        table = np.frombuffer(data, np.uint8, 4 * colors, 14 + header_size).reshape(-1, 4)
        idx = rows[:, :w]
        if int(idx.max()) >= colors:
            raise UnsupportedImage("BMP palette index past its table")
        return Decoded(idx, "P", np.ascontiguousarray(table[:, 2::-1]))
    return Decoded(rows[:, :w * (bits // 8)].reshape(h, w, bits // 8), "RGB", order=(2, 1, 0))


# -- ICO ---------------------------------------------------------------------


def _ico_decode(data: bytes, native: bool) -> Decoded:
    """The frame PIL's IcoImagePlugin takes: the largest by width × height,
    among those the least colour depth, first in the directory among
    equals; a PNG frame through the PNG path, a DIB frame below."""
    if len(data) < 6:
        raise UnsupportedImage("truncated ICO header")
    count = struct.unpack_from("<H", data, 4)[0]
    if not count or len(data) < 6 + 16 * count:
        raise UnsupportedImage("ICO without a whole directory")
    entries = []
    for i in range(count):
        w, h, nb_color, _, _, bpp, size, offset = struct.unpack_from("<BBBBHHII", data, 6 + 16 * i)
        w, h = w or 256, h or 256
        depth = bpp or (nb_color != 0 and math.ceil(math.log(nb_color, 2))) or 256
        entries.append((w * h, depth, bpp, size, offset))
    entries = sorted(sorted(entries, key=lambda e: e[1]), key=lambda e: e[0], reverse=True)
    _, _, bpp, size, offset = entries[0]
    frame = data[offset:]
    if frame[:8] == PNG_SIGNATURE:
        return _png_decode(frame, native)
    return _ico_dib_decode(data, offset, bpp, size)


def _ico_dib_decode(data: bytes, offset: int, entry_bpp: int, entry_size: int) -> Decoded:
    """A DIB frame (header, palette, XOR bitmap of half the header's height,
    AND mask), as PIL's IcoFile.frame reads it: ``convert("RGBA")`` of the
    DIB, its alpha from the AND mask ("1;I": a set bit is transparent), or
    at 32 bits in the directory from every 4th byte of the pixel data.
    Uncompressed 1, 4, 8, 24 and 32 bits; PIL reads a grey palette as raw L
    or 1 bytes, which is right only at 8 bits and 1 bit, so other such
    palettes are refused."""
    if offset + 40 > len(data):
        raise UnsupportedImage("truncated ICO frame")
    header_size, w, h_raw, planes, bits, compression, _, _, _, colors = struct.unpack_from(
        "<IiIHHIIiiI", data, offset)
    if header_size not in BMP_HEADERS or offset + header_size > len(data):
        raise UnsupportedImage(f"ICO frame DIB header of {header_size} bytes")
    if compression != 0 or bits not in (1, 4, 8, 24, 32) or data[offset + 11] == 0xFF:
        raise UnsupportedImage(f"ICO frame DIB at {bits} bits, compression {compression}")
    check_size(w, h_raw)
    h = h_raw // 2
    check_size(w, h)
    pos = offset + header_size
    if bits <= 8:
        colors = colors or 1 << bits
        if not 0 < colors <= 256 or pos + 4 * colors > len(data):
            raise UnsupportedImage(f"ICO frame DIB with {colors} colours")
        table = np.frombuffer(data, np.uint8, 4 * colors, pos).reshape(-1, 4)[:, 2::-1]
        pos += 4 * colors
        grey = (0, 255) if colors == 2 else range(colors)
        if all((table[i] == v).all() for i, v in enumerate(grey)) and \
                bits != (1 if colors == 2 else 8):
            raise UnsupportedImage(f"ICO frame DIB: grey palette at {bits} bits")
    stride = ((w * bits + 31) >> 3) & ~3
    if pos + stride * h > len(data):
        raise UnsupportedImage("truncated ICO frame pixels")
    if entry_bpp == 32:
        mask_end = pos + w * h * 4  # PIL reads the alpha bytes from here
        mask_bytes = 0
    else:
        mask_bytes = -(-w // 32) * 32 * h // 8
        mask_end = offset + entry_size
        if mask_end - mask_bytes < 0:
            raise UnsupportedImage("ICO frame AND mask before the file")
    if mask_end > len(data):
        raise UnsupportedImage("truncated ICO frame mask")
    rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h, stride)[::-1]
    if entry_bpp == 32:
        alpha = np.frombuffer(data, np.uint8, w * h * 4, pos)[3::4].reshape(h, w)[::-1]
    else:
        mask = np.frombuffer(data, np.uint8, mask_bytes, mask_end - mask_bytes)
        bits_ = np.unpackbits(mask.reshape(h, -1), axis=1)[::-1, :w]
        alpha = np.where(bits_ == 1, 0, 255).astype(np.uint8)
    if bits > 8:  # bottom-up rows of B, G, R (and X)
        colour = rows[:, :w * (bits // 8)].reshape(h, w, bits // 8)[..., 2::-1]
    else:
        per = 8 // bits
        shifts = (8 - bits) - bits * np.arange(per, dtype=np.uint8)
        idx = ((rows[:, :, None] >> shifts) & ((1 << bits) - 1)).reshape(h, -1)[:, :w]
        if int(idx.max()) >= colors:
            raise UnsupportedImage("ICO frame palette index past its table")
        colour = np.ascontiguousarray(table)[idx]
    return Decoded(np.concatenate([colour, alpha[..., None]], axis=-1), "RGBA")


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


def resize_lanczos(luma: np.ndarray, edge: int = GRID_EDGE) -> np.ndarray:
    """[h, w] uint8 → [edge, edge] uint8, PIL's ``resize((edge, edge),
    LANCZOS)`` on an L image."""
    return resize_image(luma, (edge, edge))


# -- thumbnails: RGB at any size ---------------------------------------------

# thumb_rgb's kinds, as csrc/imgdec.cpp's sd_thumb_rgb numbers them.
THUMB_KINDS = {"1": 0, "L": 0, "LA": 0, "I;16": 1, "RGB": 2, "P": 2, "RGBA": 3, "CMYK": 4}


def thumb_rgb(pixels: np.ndarray, mode: str, *, native: bool = True) -> np.ndarray:
    """``decode_image``'s (pixels, mode) → [h, w, 3] uint8, what the JAX
    ``encode_webp`` hands its resize: an RGBA image pasted onto white with
    its alpha as the mask (PIL's Paste.c BLEND,
    ``DIV255(255·(255 − a) + c·a)``), every other mode through PIL's
    ``convert("RGB")`` (gray replicated, LA's alpha dropped, I;16 clipped at
    255, a palette's colours as they are, CMYK by ``cmyk2rgb``)."""
    kind = THUMB_KINDS.get(mode)
    if kind is None:
        raise ValueError(f"thumb_rgb: mode {mode!r}")
    if native:
        from .. import native as plane
        return plane.thumb_rgb(pixels, kind)
    return thumb_rgb_plain(pixels, kind)


def thumb_rgb_plain(pixels: np.ndarray, kind: int) -> np.ndarray:
    """Plain version of ``native.thumb_rgb``."""
    if kind == 0:
        gray = pixels if pixels.ndim == 2 else pixels[..., 0]
        return np.repeat(gray[..., None], 3, axis=-1)
    if kind == 1:
        return np.repeat(np.minimum(pixels, 255).astype(np.uint8)[..., None], 3, axis=-1)
    if kind == 2:
        return np.ascontiguousarray(pixels[..., :3])
    if kind == 4:
        return cmyk_to_rgb(pixels)
    a = pixels[..., 3:4].astype(np.uint32)
    t = 255 * (255 - a) + pixels[..., :3].astype(np.uint32) * a + 128
    return (((t >> 8) + t) >> 8).astype(np.uint8)


def cmyk_to_rgb(pixels: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 CMYK → [..., 3] uint8 RGB, PIL's ``cmyk2rgb``:
    nk = 255 − K, each band CLIP8(nk − DIV255(c · nk))."""
    nk = 255 - pixels[..., 3:4].astype(np.int32)
    t = pixels[..., :3].astype(np.int32) * nk + 128
    return np.maximum(nk - (((t >> 8) + t) >> 8), 0).astype(np.uint8)


@functools.lru_cache(maxsize=64)
def lanczos_taps(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """PIL's fixed-point LANCZOS weights for one side, tap by tap: ([out]
    int64 first input of each output, [out, ksize] int64 weights, zero past
    each output's taps; Resample.c ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``). Cached, read-only: out × ksize values, where
    a dense [out, in] matrix would take out × in at a camera's widths."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = LANCZOS_SUPPORT * filterscale
    ss = 1.0 / filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_lanczos((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        total = 0.0
        for wgt in k:
            total += wgt
        first[xx] = xmin
        for x, wgt in enumerate(k):
            if total != 0.0:
                wgt /= total
            fixed = wgt * (1 << PRECISION_BITS)
            weights[xx, x] = int(fixed - 0.5) if wgt < 0 else int(fixed + 0.5)
    first.flags.writeable = False
    weights.flags.writeable = False
    return first, weights


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8bpc pass of PIL's LANCZOS along `axis` of an int64 image."""
    first, weights = lanczos_taps(img.shape[axis], out_size)
    n = img.shape[axis]
    acc = np.full(img.shape[:axis] + (out_size,) + img.shape[axis + 1:],
                  1 << (PRECISION_BITS - 1), np.int64)
    shape = [1] * img.ndim
    shape[axis] = out_size
    for k in range(weights.shape[1]):
        w = weights[:, k]
        if not w.any():
            continue
        idx = np.minimum(first + k, n - 1)  # a zero weight past the side
        acc += np.take(img, idx, axis=axis) * w.reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255)


def resize_image(pixels: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[h, w] or [h, w, c] uint8 → (width, height) `size`, PIL's
    ``resize(size, LANCZOS)`` on an 8-bit image (c bands resampled alike):
    the horizontal pass, then the vertical; a side that keeps its length is
    not resampled. Plain version of ``native.resample_image``."""
    out_w, out_h = size
    img = pixels.astype(np.int64)
    if img.shape[1] != out_w:
        img = _resample_axis(img, out_w, 1)
    if img.shape[0] != out_h:
        img = _resample_axis(img, out_h, 0)
    return img.astype(np.uint8)
