"""GIF's first frame to L, as PIL opens it (Pillow 12.1.0's GifImagePlugin).

PIL takes a GIF's first frame as mode P (L where neither a local nor the
global palette is given, or where the palette in effect is the identity
ramp), so ``convert("L")`` is L24 of the palette entry of each index, or
the index itself. This module reads the logical screen, skips the
extension blocks before the first image descriptor, takes its local
palette or the global one, LZW-decodes its sub-blocks (``native.gif_lzw``,
or ``lzw_plain`` here), undoes the four-pass interlace, and places the
frame on the screen. Like PIL, the screen grows to hold a frame that
reaches past it, and what the frame leaves uncovered holds the frame's
transparent index (0 where it has none).

Refused (``UnsupportedImage``): no image descriptor, data or sub-blocks
that end before the frame is full, an LZW end code or a code past the
table before it is full, a minimum code size outside 2..8, and an index
(the fill included) past the palette in effect.
"""

from __future__ import annotations

import struct

import numpy as np

from .imgdecode import GIF_SIGNATURES, Decoded, UnsupportedImage, check_size

# (first row, row step) of the four passes of an interlaced frame.
INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


def _sub_blocks(data: bytes, pos: int):
    """(joined payload, position after the terminator) of the sub-blocks at
    `pos`; raises where they run off the end."""
    out = []
    while True:
        if pos >= len(data):
            raise UnsupportedImage("truncated GIF")
        n = data[pos]
        if n == 0:
            return b"".join(out), pos + 1
        if pos + 1 + n > len(data):
            raise UnsupportedImage("truncated GIF")
        out.append(data[pos + 1:pos + 1 + n])
        pos += 1 + n


def _palette(data: bytes, pos: int, flags: int):
    if not flags & 0x80:
        return None, pos
    size = 3 << ((flags & 7) + 1)
    if pos + size > len(data):
        raise UnsupportedImage("truncated GIF palette")
    return np.frombuffer(data, np.uint8, size, pos).reshape(-1, 3), pos + size


def decode(data: bytes, native: bool) -> Decoded:
    """GIF bytes → the first frame on its screen, as PIL loads it: "P"
    (its palette) or, without a palette, "L"; outside the frame the
    transparent index, else 0."""
    if len(data) < 13 or data[:6] not in GIF_SIGNATURES:
        raise UnsupportedImage("not a GIF")
    width, height, flags = struct.unpack_from("<HHB", data, 6)
    palette, pos = _palette(data, 13, flags)
    transparency = None
    while True:
        if pos >= len(data) or data[pos] == 0x3B:
            raise UnsupportedImage("GIF without an image")
        kind = data[pos]
        if kind == 0x21:
            if pos + 2 > len(data):
                raise UnsupportedImage("truncated GIF")
            label = data[pos + 1]
            first, end = _sub_blocks(data, pos + 2)
            if label == 0xF9 and data[pos + 2]:
                if data[pos + 2] < 4:  # PIL reads the flags, delay and index
                    raise UnsupportedImage("short GIF graphic control block")
                transparency = first[3] if first[0] & 1 else None
            pos = end
        elif kind == 0x2C:
            break
        else:
            pos += 1  # PIL reads one byte at a time until it meets '!' or ','
    if pos + 10 > len(data):
        raise UnsupportedImage("truncated GIF image descriptor")
    x0, y0, fw, fh, fflags = struct.unpack_from("<HHHHB", data, pos + 1)
    if not fw or not fh:
        raise UnsupportedImage("empty GIF frame")
    local, pos = _palette(data, pos + 10, fflags)
    if local is not None:
        palette = local
    if pos >= len(data):
        raise UnsupportedImage("truncated GIF")
    min_size = data[pos]
    if not 2 <= min_size <= 8:
        raise UnsupportedImage(f"GIF LZW minimum code size {min_size}")
    lzw, _ = _sub_blocks(data, pos + 1)
    sw, sh = max(width, x0 + fw), max(height, y0 + fh)
    check_size(sw, sh)
    if native:
        from .. import native as plane
        indices = plane.gif_lzw(lzw, min_size, fw * fh)
    else:
        indices = lzw_plain(lzw, min_size, fw * fh)
    frame = indices.reshape(fh, fw)
    if fflags & 0x40:
        rows = np.concatenate([np.arange(start, fh, step) for start, step in INTERLACE])
        frame = frame[np.argsort(rows, kind="stable")]
    canvas = np.full((sh, sw), transparency or 0, np.uint8)
    canvas[y0:y0 + fh, x0:x0 + fw] = frame
    if palette is None:
        return Decoded(canvas, "L")
    if int(canvas.max()) >= len(palette):
        raise UnsupportedImage("GIF index past its palette")
    return Decoded(canvas, "P", palette)


LZW_MESSAGES = {1: "truncated GIF image data", 2: "corrupt GIF image data"}


def lzw_plain(data: bytes, min_size: int, npixels: int) -> np.ndarray:
    """Plain version of ``native.gif_lzw``: the frame's LZW data →
    [npixels] uint8 indices; raises UnsupportedImage as that does."""
    clear, end = 1 << min_size, (1 << min_size) + 1
    buf = data + b"\x00\x00\x00"
    nbits = 8 * len(data)
    table = [bytes([c]) for c in range(clear)] + [b"", b""]
    size, prev = min_size + 1, None
    out, filled, pos = [], 0, 0
    while filled < npixels:
        if pos + size > nbits:
            raise UnsupportedImage(LZW_MESSAGES[1])
        code = (int.from_bytes(buf[pos >> 3:(pos >> 3) + 3], "little") >> (pos & 7)) & (
            (1 << size) - 1)
        pos += size
        if code == clear:
            table = table[:clear + 2]
            size, prev = min_size + 1, None
            continue
        if code == end:
            raise UnsupportedImage(LZW_MESSAGES[1])
        if prev is None:
            if code > clear:
                raise UnsupportedImage(LZW_MESSAGES[2])
            string = table[code]
        elif code < len(table):
            string = table[code]
        elif code == len(table):
            string = prev + prev[:1]
        else:
            raise UnsupportedImage(LZW_MESSAGES[2])
        out.append(string)
        filled += len(string)
        if prev is not None and len(table) < 4096:
            table.append(prev + string[:1])
            if len(table) == 1 << size and size < 12:
                size += 1
        prev = string
    return np.frombuffer(b"".join(out), np.uint8)[:npixels].copy()
