"""TIFF (and DNG's first IFD) to L, as PIL opens it (Pillow 12.1.0's
TiffImagePlugin over libtiff 4.7.1).

PIL reads the first IFD only, so a DNG gives its IFD0 (as a rule a small
RGB preview; the raw data in a ``SubIFDs`` child is never read). It takes
the mode from ``OPEN_INFO`` by (byte order, photometric, sample format,
fill order, bits per sample, extra samples), and reads the pixels along
one of two routes that differ in places, which this module follows:

- ``Compression`` 1: PIL's own raw unpackers, one tile per strip or tile
  read from its offset (``StripByteCounts`` is not read), the
  ``Predictor`` ignored; a planar image unpacks each plane with one
  character of the raw mode, which is right only for 1-bit and 8-bit
  gray, palette, RGB and RGBA (the rest is refused);
- every other compression: libtiff, each strip or whole tile read by its
  byte count and decoded to exactly its size (LZW: MSB-first codes of 9 to
  12 bits with the early change; Deflate (8, 32946) through ``zlib``;
  PackBits), then ``Predictor`` 2 (horizontal differencing of 8 or 16-bit
  samples, LZW and Deflate only: libtiff's PackBits codec has none);
- ``Compression`` 7 (JPEG): libtiff hands libjpeg the ``JPEGTables``
  stream and then each strip or tile's stream, so each is decoded by the
  port's JPEG decoder with the tables prepended, as one stream: gray
  (photometric 1), RGB components as they are (photometric 2: libtiff's
  ``JCS_UNKNOWN``) or YCbCr to RGB (photometric 6, PIL asking libtiff for
  ``JPEGCOLORMODE_RGB``), contiguous samples only, component 0 sampled as
  ``YCbCrSubsampling`` says (1 × 1 but for YCbCr) and the others 1 × 1, a
  stream's size that of its strip or tile (a last strip may be taller),
  as libtiff's ``JPEGPreDecode`` requires.

Then the mode to L: gray at 1, 2, 4 and 8 bits scaled to 0..255 (inverted
where ``Photometric`` is 0), 16-bit gray (``I;16``/``I;16B``) clipped at
255, gray + alpha its gray, RGB(A/X) at 8 or 16 bits through ``L24`` of
each sample's high byte, associated alpha (``RGBa``) un-premultiplied
first (``CLIP8(c·255 / a)``, 0 where a is 0), a palette through ``L24`` of
its ``ColorMap`` entries' high bytes; last, the EXIF orientation
(``Orientation`` 2 to 8) that PIL applies on load.

Refused, with a reason from ``REASONS``: big-endian BigTIFF (PIL reads
its header as classic TIFF), an IFD that is cut or points past the file or
repeats a tag, a tag this module reads that is not an integer PIL reads as
one, modes outside the table (CMYK, YCbCr but JPEG's, LAB, 12 and 32-bit,
float, signed 16-bit, fill order 2), compressions other than 1, 5, 7, 8,
32773 and 32946 (CCITT, old JPEG, LZMA, ...), old-style LZW, a predictor
libtiff refuses (2 below 8 bits, 3, others), planar layouts PIL misreads
or reads through libtiff's RGBA interface, a tile past 256 MiB, strip or
tile data that is short or corrupt, and on libtiff's route what its own
directory reader refuses (core tags of other types or signs, per-sample
tags of other counts, a ColorMap of other than 3 · 2**bits entries below
8 bits, a PlanarConfiguration other than 1 or 2).

The strips and tiles (LZW, PackBits, the predictor, each placed and
cropped) are one call of ``native.tiff_chunks`` (``csrc/tiffdec.cpp``);
``chunks_plain`` and ``chunk_plain`` here are its plain version, with the
same status codes. The IFD walk, Deflate (``zlib``) and the mode to L are
Python and numpy, shared by both.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .imgdecode import GRAY_SCALE, TIFF_SIGNATURES, Decoded, UnsupportedImage, check_size

# Status codes of a strip or tile: must match `enum Status` in
# csrc/tiffdec.cpp. The rest are the parse's own.
OK = 0
SHORT_DATA = 1
CORRUPT_LZW = 2
OLD_LZW = 3
BIG_ENDIAN_BIGTIFF = 4
BAD_IFD = 5
BAD_TAG = 6
MODE = 7
COMPRESSION = 8
PREDICTOR = 9
PLANAR = 10
LAYOUT = 11
PALETTE = 12

REASONS = {
    SHORT_DATA: "truncated or short TIFF strip or tile data",
    CORRUPT_LZW: "corrupt TIFF LZW data",
    OLD_LZW: "old-style TIFF LZW",
    BIG_ENDIAN_BIGTIFF: "big-endian BigTIFF (PIL reads its header as classic TIFF)",
    BAD_IFD: "TIFF IFD cut short or past the file",
    BAD_TAG: "missing or malformed TIFF tag",
    MODE: "TIFF pixel layout outside PIL's table, or CMYK, YCbCr, LAB, 12/32-bit or "
          "float samples",
    COMPRESSION: "TIFF compression other than none, LZW, JPEG, Deflate and PackBits",
    PREDICTOR: "TIFF predictor libtiff refuses",
    PLANAR: "planar TIFF layout PIL misreads or reads through libtiff's RGBA interface, "
            "or a PlanarConfiguration libtiff refuses",
    LAYOUT: "TIFF strips or tiles that do not cover the image, or a tile past 256 MiB",
    PALETTE: "TIFF palette missing or too short",
}

# Compression tag → how this module decodes it.
RAW, LZW, DEFLATE, PACKBITS = 1, 5, 8, 32773
COMPRESSIONS = {1: RAW, 5: LZW, 8: DEFLATE, 32946: DEFLATE, 32773: PACKBITS}

# IFD field type → (struct code, size) of the integer types PIL reads as
# numbers; the rest (bytes, which PIL hands back as a bytes object,
# rationals, floats, undefined) are kept as bytes and never read here.
INT_TYPES = {3: ("H", 2), 4: ("I", 4), 8: ("h", 2), 9: ("i", 4), 13: ("I", 4), 16: ("Q", 8),
             17: ("q", 8), 18: ("Q", 8)}
TYPE_SIZES = {1: 1, 2: 1, 5: 8, 6: 1, 7: 1, 10: 8, 11: 4, 12: 8,
              **{k: v[1] for k, v in INT_TYPES.items()}}

WIDTH, LENGTH, BITS, COMPRESSION_TAG, PHOTOMETRIC, FILL_ORDER = 256, 257, 258, 259, 262, 266
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP, STRIP_COUNTS = 273, 274, 277, 278, 279
PLANAR_TAG, PREDICTOR_TAG, COLORMAP = 284, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_COUNTS = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT = 338, 339
JPEG_TABLES, YCBCR_SUBSAMPLING = 347, 530
MIN_SAMPLE, MAX_SAMPLE, SMIN_SAMPLE, SMAX_SAMPLE = 280, 281, 340, 341
MAX_SAMPLES = 6  # PIL's MAX_SAMPLESPERPIXEL
# The tags libtiff's TIFFReadDirectory fails on when malformed, and the
# field types it reads them from.
LIBTIFF_CORE = (256, 257, 258, 259, 273, 277, 278, 279, 284, 322, 323, 324, 325, 338, 339)
LIBTIFF_INTS = (3, 4, 8, 9, 16, 17)
NUMERIC_TYPES = (1, 3, 4, 5, 6, 8, 9, 10, 11, 12, 16, 17)
MAX_TILE_BYTES = 1 << 28  # a bound on the buffer one tile takes, far past real tiles

# The part of PIL's OPEN_INFO this module reads: (big-endian, photometric,
# sample format, bits per sample, extra samples) → (kind, bits). Kinds:
# "gray" (scaled), "grayi" (inverted), "i16" (clipped), "la", "rgb" (the
# first three samples), "rgba_p" (associated alpha), "pal". Every entry
# holds for both byte orders unless it names one.
def _open_info() -> dict:
    table = {}
    for order in (False, True):
        for bits in (1, 2, 4, 8):
            table[(order, 0, (1,), (bits,), ())] = ("grayi", bits)
            table[(order, 1, (1,), (bits,), ())] = ("gray", bits)
            table[(order, 3, (1,), (bits,), ())] = ("pal", bits)
        table[(order, 1, (2,), (8,), ())] = ("gray", 8)
        table[(order, 1, (1,), (8, 8), (2,))] = ("la", 8)
        table[(order, 3, (1,), (8, 8), (0,))] = ("pal", 8)
        table[(order, 3, (1,), (8, 8), (2,))] = ("pal", 8)
        for extra in ((), (0,), (0, 0), (0, 0, 0), (2,), (2, 0), (2, 0, 0), (999,)):
            table[(order, 2, (1,), (8,) * (3 + len(extra)), extra)] = ("rgb", 8)
        table[(order, 2, (1,), (8,) * 4, ())] = ("rgb", 8)
        for extra in ((1,), (1, 0), (1, 0, 0)):
            table[(order, 2, (1,), (8,) * (3 + len(extra)), extra)] = ("rgba_p", 8)
        for extra in ((), (0,), (2,)):
            table[(order, 2, (1,), (16,) * (3 + len(extra)), extra)] = ("rgb", 16)
        table[(order, 2, (1,), (16,) * 4, ())] = ("rgb", 16)
        table[(order, 2, (1,), (16,) * 4, (1,))] = ("rgba_p", 16)
    table[(False, 0, (1,), (16,), ())] = ("i16", 16)  # I;16, not inverted
    table[(False, 1, (1,), (16,), ())] = ("i16", 16)
    table[(True, 1, (1,), (16,), ())] = ("i16", 16)
    return table


OPEN_INFO = _open_info()
# EXIF orientation → the numpy steps of PIL's exif_transpose.
# Rows and columns only: a pixel's bands stay as they are.
ORIENT = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
          5: lambda a: a.swapaxes(0, 1), 6: lambda a: a.swapaxes(0, 1)[:, ::-1],
          7: lambda a: a.swapaxes(0, 1)[::-1, ::-1], 8: lambda a: a.swapaxes(0, 1)[::-1]}


def _refuse(code: int):
    raise UnsupportedImage(REASONS[code])


def _ifd(data: bytes) -> tuple:
    """(big-endian, {tag: (type, count, raw bytes)}) of the first IFD, as
    PIL's ImageFileDirectory_v2 reads it; refused where PIL would stop
    short or where PIL and libtiff part (a repeated tag). An entry of a
    type PIL skips is kept: a tag this module reads must be an integer."""
    head = data[:4]
    if head not in TIFF_SIGNATURES:
        raise UnsupportedImage("not a TIFF")
    big = head[:2] == b"MM"
    order = ">" if big else "<"
    bigtiff = data[2] == 43  # PIL tests byte 2 only: MM BigTIFF reads as classic
    if head == b"MM\x00+":
        _refuse(BIG_ENDIAN_BIGTIFF)
    if len(data) < (16 if bigtiff else 8):
        _refuse(BAD_IFD)
    pos = struct.unpack_from(order + ("Q" if bigtiff else "I"), data, 8 if bigtiff else 4)[0]
    count_fmt, entry, inline = ("Q", 20, 8) if bigtiff else ("H", 12, 4)
    need = struct.calcsize(count_fmt)
    if pos + need > len(data):
        _refuse(BAD_IFD)
    n = struct.unpack_from(order + count_fmt, data, pos)[0]
    pos += need
    if pos + n * entry + (8 if bigtiff else 4) > len(data):
        _refuse(BAD_IFD)
    tags = {}
    for i in range(n):
        at = pos + i * entry
        tag, kind = struct.unpack_from(order + "HH", data, at)
        count = struct.unpack_from(order + ("Q" if bigtiff else "I"), data, at + 4)[0]
        if tag in tags:  # PIL keeps the last, libtiff the first
            _refuse(BAD_IFD)
        raw = b""
        if kind in TYPE_SIZES:
            size = count * TYPE_SIZES[kind]
            field = data[at + entry - inline:at + entry]
            if size > inline:
                off = struct.unpack(order + ("Q" if bigtiff else "I"), field)[0]
                raw = data[off:off + size]
                if len(raw) != size:
                    _refuse(BAD_IFD)
            else:
                raw = field[:size]
        # Kept with a type PIL skips, or no values: reading it refuses.
        tags[tag] = (kind, count, raw)
    return big, tags


def _ints(big: bool, tags: dict, tag: int, default=None) -> tuple:
    """The integer values of `tag` (`default` where it is absent)."""
    if tag not in tags:
        if default is None:
            _refuse(BAD_TAG)
        return default
    kind, count, raw = tags[tag]
    if kind not in INT_TYPES or not raw:
        _refuse(BAD_TAG)
    fmt = INT_TYPES[kind][0]
    return struct.unpack(("<>"[big]) + fmt * count, raw)


def _one(big: bool, tags: dict, tag: int, default=None) -> int:
    values = _ints(big, tags, tag, None if default is None else (default,))
    if len(values) != 1:
        _refuse(BAD_TAG)
    return values[0]


def decode(data: bytes, native: bool) -> Decoded:
    """TIFF bytes → the first IFD as PIL loads it (``Decoded``), turned by
    its Orientation tag as PIL's TIFF load turns it."""
    big, tags = _ifd(data)
    w, h = _one(big, tags, WIDTH), _one(big, tags, LENGTH)
    compression = _one(big, tags, COMPRESSION_TAG, 1)
    planar = _one(big, tags, PLANAR_TAG, 1)
    photometric = _one(big, tags, PHOTOMETRIC, 0)
    if compression == 6:  # PIL takes old-style JPEG as YCbCr
        _refuse(COMPRESSION)
    if compression == 7:
        return _oriented(big, tags, _jpeg_image(data, big, tags, w, h, photometric,
                                                planar, native))
    fill = _one(big, tags, FILL_ORDER, 1)
    sample_format = _ints(big, tags, SAMPLE_FORMAT, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bits = _ints(big, tags, BITS, (1,))
    extra = _ints(big, tags, EXTRA_SAMPLES, ())
    spp = _one(big, tags, SAMPLES, 1)
    if spp > MAX_SAMPLES:
        _refuse(MODE)
    if spp < len(bits):
        bits = bits[:spp]
    elif spp > len(bits) and len(bits) == 1:
        bits = bits * spp
    if len(bits) != spp or fill != 1:
        _refuse(MODE)
    info = OPEN_INFO.get((big, photometric, tuple(sample_format), tuple(bits), tuple(extra)))
    if info is None:
        _refuse(MODE)
    if compression not in COMPRESSIONS:
        _refuse(COMPRESSION)
    check_size(w, h)
    kind, depth = info
    route = COMPRESSIONS[compression]
    if route != RAW:  # libtiff reads these itself and refuses them malformed
        for tag in LIBTIFF_CORE:
            if tag in tags and (tags[tag][0] not in LIBTIFF_INTS or
                                min(_ints(big, tags, tag)) < 0):
                _refuse(BAD_TAG)
        # per-sample tags: one value, or one for each sample, all equal
        for tag in (BITS, MIN_SAMPLE, MAX_SAMPLE, SAMPLE_FORMAT):
            if tag in tags:
                kind_, count, _ = tags[tag]
                values = _ints(big, tags, tag) if kind_ in LIBTIFF_INTS else ()
                if not values or count != 1 and (count < spp or len(set(values[:spp])) > 1):
                    _refuse(BAD_TAG)
        for tag in (SMIN_SAMPLE, SMAX_SAMPLE):  # one value for each sample
            if tag in tags and (tags[tag][0] not in NUMERIC_TYPES or tags[tag][1] != spp):
                _refuse(BAD_TAG)
        # and, below 8 bits, a palette whose ColorMap has other than
        # 3 · 2**bits entries (PIL takes any; at 8 bits libtiff reads the
        # indices as gray instead, which PIL's palette then maps)
        if photometric == 3 and bits[0] < 8 and (
                COLORMAP not in tags or tags[COLORMAP][1] != 3 << bits[0]):
            _refuse(PALETTE)
    predictor = _one(big, tags, PREDICTOR_TAG, 1) if route in (LZW, DEFLATE) else 1
    if predictor not in (1, 2) or (predictor == 2 and depth not in (8, 16)):
        _refuse(PREDICTOR)
    if planar == 2 and (not _raw_planar_ok(photometric, kind, depth, spp, extra)
                        if route == RAW else spp > 3):
        _refuse(PLANAR)
    if route != RAW and planar not in (1, 2):  # libtiff refuses the directory
        _refuse(PLANAR)
    samples = _samples(data, big, tags, w, h, spp, depth, planar == 2 and spp > 1, route,
                       predictor, native)
    return _oriented(big, tags, _to_image(samples, kind, depth, big, tags, extra))


def _oriented(big: bool, tags: dict, image: Decoded) -> Decoded:
    """The image turned by its Orientation tag, as PIL's TIFF load turns it."""
    kind_, count, raw = tags.get(ORIENTATION, (3, 0, b""))
    orientation = _ints(big, tags, ORIENTATION) if kind_ in INT_TYPES and count == 1 and raw \
        else (1,)
    turn = ORIENT.get(orientation[0])
    if turn is None:
        return image
    return image._replace(pixels=np.ascontiguousarray(turn(image.pixels)))


def _sof_sampling(stream: bytes):
    """[(h, v)] of each component in a JPEG stream's frame header, or None."""
    pos = 2
    while pos + 4 <= len(stream):
        if stream[pos] != 0xFF:
            return None
        marker = stream[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        length = struct.unpack_from(">H", stream, pos + 2)[0]
        if marker in (0xC0, 0xC1, 0xC2):
            n = stream[pos + 9] if pos + 10 <= len(stream) else 0
            body = stream[pos + 10:pos + 10 + 3 * n]
            if len(body) != 3 * n:
                return None
            return [(body[3 * i + 1] >> 4, body[3 * i + 1] & 15) for i in range(n)]
        if marker == 0xDA:
            return None
        pos += 2 + length
    return None


def _jpeg_image(data: bytes, big: bool, tags: dict, w: int, h: int, photometric: int,
                planar: int, native: bool) -> Decoded:
    """Compression 7: every strip or tile through the JPEG decoder, the
    JPEGTables stream prepended, placed and cropped (module docstring)."""
    from . import jpeg

    spp = _one(big, tags, SAMPLES, 1)
    bits = _ints(big, tags, BITS, (8,))
    channels = {1: 1, 2: 3, 6: 3}.get(photometric)
    if channels is None or spp != channels or set(bits) != {8} or \
            EXTRA_SAMPLES in tags or _ints(big, tags, SAMPLE_FORMAT, (1,))[0] != 1 or \
            _one(big, tags, FILL_ORDER, 1) != 1:
        _refuse(MODE)
    if planar != 1 and spp > 1:
        _refuse(PLANAR)
    check_size(w, h)
    sampling = [(1, 1)] * spp
    if photometric == 6:
        sub = _ints(big, tags, YCBCR_SUBSAMPLING, (2, 2))
        if len(sub) != 2:
            _refuse(BAD_TAG)
        sampling = [tuple(sub)] + [(1, 1)] * (spp - 1)
    tables = b""
    if JPEG_TABLES in tags:
        tables = tags[JPEG_TABLES][2]
        if tables[:2] != b"\xff\xd8" or tables[-2:] != b"\xff\xd9":
            _refuse(BAD_TAG)
        tables = tables[:-2]
    tiled = TILE_OFFSETS in tags
    if tiled:
        tw, tl = _one(big, tags, TILE_WIDTH), _one(big, tags, TILE_LENGTH)
        offsets, counts = _ints(big, tags, TILE_OFFSETS), _ints(big, tags, TILE_COUNTS)
    else:
        tw = w
        rps = _one(big, tags, ROWS_PER_STRIP, 2**32 - 1)
        tl = min(rps, h) if rps else 0
        offsets, counts = _ints(big, tags, STRIP_OFFSETS), _ints(big, tags, STRIP_COUNTS)
    if tw < 1 or tl < 1:
        _refuse(LAYOUT)
    across, down = -(-w // tw), -(-h // tl)
    if len(offsets) != across * down or len(counts) != len(offsets):
        _refuse(LAYOUT)
    color = {1: -1, 2: 1, 6: 0}[photometric]
    out = np.zeros((h, w, spp), np.uint8)
    for k, (off, count) in enumerate(zip(offsets, counts)):
        stream = data[off:off + count]
        if len(stream) < count or stream[:2] != b"\xff\xd8":
            _refuse(SHORT_DATA)
        if tables:
            stream = tables + stream[2:]
        if _sof_sampling(stream) != sampling:
            _refuse(LAYOUT)  # libtiff: "Improper JPEG sampling factors"
        y0, x0 = (k // across) * tl, (k % across) * tw
        rows, cols = (tl, tw) if tiled else (min(tl, h - y0), w)
        if native:
            from .. import native as plane
            px = plane.jpeg_decode(stream, color)
        else:
            px = jpeg.decode_plain(stream, color)
        px = px.reshape(px.shape[0], px.shape[1], -1)
        last_strip = not tiled and y0 + rows == h
        if px.shape[1] != cols or px.shape[0] < rows or (px.shape[0] > rows and not last_strip):
            _refuse(LAYOUT)  # libtiff: the strip or tile size must match
        take_r, take_c = min(rows, h - y0), min(cols, w - x0)
        out[y0:y0 + take_r, x0:x0 + take_c] = px[:take_r, :take_c]
    if spp == 1:
        return Decoded(out[..., 0], "L")
    return Decoded(out, "RGB", order=(0, 1, 2, 3))


def _raw_planar_ok(photometric: int, kind: str, depth: int, spp: int, extra: tuple) -> bool:
    """Whether PIL's raw route reads a planar image right: it unpacks plane
    k with character k of the raw mode, which is a whole raw mode only for
    "1", "L", "P", "RGB" and "RGBA"."""
    if kind in ("gray", "pal") and spp == 1:
        return depth == 8 or (depth == 1 and kind == "gray" and photometric == 1)
    return kind == "rgb" and depth == 8 and (
        spp == 3 or (spp == 4 and tuple(extra) in ((), (2,), (999,))))


def _samples(data: bytes, big: bool, tags: dict, w: int, h: int, spp: int, depth: int,
             planar: bool, route: int, predictor: int, native: bool) -> np.ndarray:
    """The image's rows of samples: [h, rowbytes] uint8 of the chunky
    layout (file byte order), planes side by side for a planar one."""
    tiled = TILE_OFFSETS in tags
    if tiled:
        tw, tl = _one(big, tags, TILE_WIDTH), _one(big, tags, TILE_LENGTH)
        offsets = _ints(big, tags, TILE_OFFSETS)
        counts = _ints(big, tags, TILE_COUNTS) if route != RAW else offsets
    else:
        tw = w
        rps = _one(big, tags, ROWS_PER_STRIP, 2**32 - 1)
        tl = min(rps, h) if rps else 0
        offsets = _ints(big, tags, STRIP_OFFSETS)
        counts = _ints(big, tags, STRIP_COUNTS) if route != RAW else offsets
    if tw < 1 or tl < 1 or (tiled and tw * depth % 8):
        _refuse(LAYOUT)
    if min(offsets) < 0 or min(counts) < 0:
        _refuse(BAD_TAG)
    planes = spp if planar else 1
    per_plane = spp // planes
    across, down = -(-w // tw), -(-h // tl)
    if len(offsets) != across * down * planes or len(counts) != len(offsets):
        _refuse(LAYOUT)
    rowbytes = (tw * per_plane * depth + 7) // 8  # one row of a strip or tile
    if tiled and tl * rowbytes > MAX_TILE_BYTES:
        _refuse(LAYOUT)
    if route == DEFLATE:  # libtiff's ZIPDecode of each, for both versions
        parts = []
        for k, (off, count) in enumerate(zip(offsets, counts)):
            src = data[off:off + count]
            if len(src) < count:
                _refuse(SHORT_DATA)
            full = tl if tiled else min(tl, h - (k // across) % down * tl)
            parts.append(_inflate(src, full * rowbytes))
        counts = [len(part) for part in parts]
        offsets = np.cumsum([0] + counts[:-1]).tolist()
        data = b"".join(parts)
    elif route != RAW and any(off + count > len(data) for off, count in zip(offsets, counts)):
        _refuse(SHORT_DATA)
    geometry = (planes, down, across, tw, tl, tiled, w, h, per_plane, depth, predictor, big)
    if native:
        from .. import native as plane
        status, out = plane.tiff_chunks(data, route, offsets, counts, *geometry)
    else:
        status, out = chunks_plain(data, route, offsets, counts, *geometry)
    if status:
        _refuse(status)
    return out


def chunks_plain(data: bytes, route: int, offsets, counts, planes: int, down: int,
                 across: int, tw: int, tl: int, tiled: bool, w: int, h: int, per_plane: int,
                 depth: int, predictor: int, big: bool) -> tuple:
    """Plain version of ``native.tiff_chunks``: every strip or tile (plane
    by plane, row of tiles by row) through ``chunk_plain`` and into place,
    edge tiles cropped → (status of the first that fails, [planes, h,
    image rowbytes] uint8 or None). On PIL's raw route a strip or tile is
    the rows the image holds at its offset (byte counts unread); else
    `counts[k]` bytes (inflated already for Deflate) decoded to the whole
    strip or tile."""
    rowbytes = (tw * per_plane * depth + 7) // 8
    image_rowbytes = (w * per_plane * depth + 7) // 8
    out = np.zeros((planes, h, image_rowbytes), np.uint8)
    k = 0
    for p in range(planes):
        for ty in range(down):
            for tx in range(across):
                y0, x0 = ty * tl, tx * tw
                rows = min(tl, h - y0)
                if route == RAW:
                    src = data[offsets[k]:offsets[k] + rows * rowbytes]
                    if len(src) < rows * rowbytes:
                        return SHORT_DATA, None
                    block = np.frombuffer(src, np.uint8).reshape(rows, rowbytes)
                else:
                    status, block = chunk_plain(data[offsets[k]:offsets[k] + counts[k]], route,
                                                tl if tiled else rows, rowbytes, predictor,
                                                per_plane, depth, big)
                    if status:
                        return status, None
                k += 1
                xb0 = x0 * per_plane * depth // 8
                take = min(rowbytes, image_rowbytes - xb0)
                out[p, y0:y0 + rows, xb0:xb0 + take] = block[:rows, :take]
    return OK, out


def _inflate(src: bytes, size: int) -> bytes:
    """libtiff's ZIPDecode: the first `size` bytes of the zlib stream;
    short or corrupt data before them is refused."""
    try:
        raw = zlib.decompressobj().decompress(src, size)
    except zlib.error:
        _refuse(SHORT_DATA)
    if len(raw) < size:
        _refuse(SHORT_DATA)
    return raw


def _to_image(samples: np.ndarray, kind: str, depth: int, big: bool, tags: dict,
              extra: tuple) -> Decoded:
    """[planes, h, rowbytes] rows → the image in PIL's mode for the kind:
    "L" (gray, scaled or inverted), "I;16", "LA", "P" (PA too: its alpha
    never reaches RGB), "RGBA" (unassociated alpha: PIL's table gives RGBA
    for 4 samples with no extra or a first extra sample of 2 or 999;
    associated alpha unpremultiplied) or "RGB"."""
    planes, h, _ = samples.shape
    w = _one(big, tags, WIDTH)
    if depth < 8:
        per = 8 // depth
        shifts = (8 - depth) - depth * np.arange(per, dtype=np.uint8)
        values = ((samples[0][:, :, None] >> shifts) & ((1 << depth) - 1)).reshape(h, -1)[:, :w]
    elif planes > 1:
        values = np.stack([samples[p].reshape(h, w, -1) for p in range(planes)], axis=2)
        values = values.reshape(h, w, -1)
    else:
        values = samples[0].reshape(h, w, -1)
    if depth == 16:
        wide = values.reshape(h, w, -1, 2)
        hi, lo = (wide[..., 0], wide[..., 1]) if big else (wide[..., 1], wide[..., 0])
    if kind in ("gray", "grayi"):
        gray = values if depth < 8 else values[..., 0]
        luma = gray * np.uint8(GRAY_SCALE[depth])
        return Decoded(255 - luma if kind == "grayi" else luma, "L")
    if kind == "i16":
        return Decoded((hi[..., 0].astype(np.uint16) << 8) | lo[..., 0], "I;16")
    if kind == "la":
        return Decoded(values[..., :2], "LA")
    if kind == "pal":
        index = values if depth < 8 else values[..., 0]
        cmap = np.array(_ints(big, tags, COLORMAP, ()), np.int64)
        if not cmap.size or cmap.size % 3 or int(index.max()) >= cmap.size // 3:
            _refuse(PALETTE)
        table = (cmap.reshape(3, -1).T >> 8).astype(np.uint8)
        return Decoded(index, "P", table)
    if kind == "rgba_p":
        rgb = hi[..., :3] if depth == 16 else values[..., :3]
        alpha = (hi[..., 3] if depth == 16 else values[..., 3]).astype(np.int32)[..., None]
        un = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(alpha, 1), 255)
        colour = np.where(alpha == 0, 0, np.where(alpha == 255, rgb, un)).astype(np.uint8)
        return Decoded(np.concatenate([colour, alpha.astype(np.uint8)], axis=-1), "RGBA")
    mode = "RGBA" if values.shape[-1] >= 4 * (depth // 8) and \
        (not extra or extra[0] in (2, 999)) else "RGB"
    if depth == 8:
        return Decoded(values, mode, order=(0, 1, 2, 3))
    high = 0 if big else 1  # each sample's high byte
    return Decoded(values, mode, order=(high, high + 2, high + 4, high + 6))


def chunk_plain(src: bytes, route: int, rows: int, rowbytes: int, predictor: int,
                spp: int, depth: int, big: bool) -> tuple:
    """One strip or tile's data, the plain version of ``chunk`` in
    ``csrc/tiffdec.cpp`` →
    (status, [rows, rowbytes] uint8 in file byte order): decoded (LZW,
    PackBits; raw and inflated data as they are), then the predictor
    undone; status as ``REASONS``."""
    size = rows * rowbytes
    if route == LZW:
        status, raw = _lzw_plain(src, size)
    elif route == PACKBITS:
        status, raw = _packbits_plain(src, size)
    else:
        status, raw = (OK, src[:size]) if len(src) >= size else (SHORT_DATA, b"")
    if status:
        return status, None
    block = np.frombuffer(raw, np.uint8).reshape(rows, rowbytes).copy()
    if predictor == 2:
        if depth == 8:
            px = block.reshape(rows, -1, spp)
            block = np.cumsum(px, axis=1, dtype=np.uint8).reshape(rows, rowbytes)
        else:
            px = block.view(">u2" if big else "<u2").reshape(rows, -1, spp)
            acc = np.cumsum(px, axis=1, dtype=np.uint16).astype(">u2" if big else "<u2")
            block = acc.view(np.uint8).reshape(rows, rowbytes)
    return OK, block


def _lzw_plain(src: bytes, size: int) -> tuple:
    """libtiff's LZWDecode (new style) of one strip or tile into `size`
    bytes: codes of 9 to 12 bits MSB first, the width growing one code
    early, Clear (256) resetting the table, EOI (257) ending it; decoding
    stops once the output is full."""
    if len(src) >= 2 and src[0] == 0 and src[1] & 1:
        return OLD_LZW, b""
    buf = src + b"\x00\x00\x00"
    nbits_total = 8 * len(src)
    out = bytearray()
    table = [bytes([c]) for c in range(256)] + [b"", b""]
    width, prev, pos, cleared = 9, None, 0, False
    while len(out) < size:
        if pos + width > nbits_total:
            return SHORT_DATA, b""
        code = (int.from_bytes(buf[pos >> 3:(pos >> 3) + 3], "big") >> (
            24 - width - (pos & 7))) & ((1 << width) - 1)
        pos += width
        if code == 256:
            table = table[:258]
            width, prev, cleared = 9, None, True
            continue
        if code == 257:
            return SHORT_DATA, b""
        if not cleared:  # libtiff chains the first entry to no code
            return CORRUPT_LZW, b""
        if prev is None:
            if code > 257:
                return CORRUPT_LZW, b""
            string = table[code]
        elif code < len(table):
            string = table[code]
        elif code == len(table):
            string = prev + prev[:1]
        else:
            return CORRUPT_LZW, b""
        out += string
        if prev is not None:
            if len(table) >= 5119:  # libtiff's CSIZE
                return CORRUPT_LZW, b""
            table.append(prev + string[:1])
            if len(table) >= (1 << width) - 1 and width < 12:
                width += 1
        prev = string
    return OK, bytes(out[:size])


def _packbits_plain(src: bytes, size: int) -> tuple:
    """libtiff's PackBitsDecode into `size` bytes: a run past the output is
    cut (a literal one before its bytes are read), data that ends before
    the output is full is refused."""
    out = bytearray()
    pos, n = 0, len(src)
    while pos < n and len(out) < size:
        c = src[pos]
        pos += 1
        if c == 128:
            continue
        if c > 128:
            if pos >= n:
                break
            out += bytes([src[pos]]) * (257 - c)
            pos += 1
        else:  # a literal run past the output is cut before its data is
            take = min(c + 1, size - len(out))  # needed
            if pos + take > n:
                break
            out += src[pos:pos + take]
            pos += take
    if len(out) < size:
        return SHORT_DATA, b""
    return OK, bytes(out[:size])
