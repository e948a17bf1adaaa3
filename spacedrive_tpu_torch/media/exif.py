"""EXIF media-data extraction: the ``media_data`` rows of image files.

Port of ``spacedrive_tpu/media/exif.py``. The JAX function reads each file
through PIL (``Image.open(path)``, ``im.size``, ``im.getexif()``, the Exif
and GPS sub-IFDs); the machine with the card has no PIL, so this module
reads the same header fields and EXIF bytes itself and builds the same
Python values PIL hands back, so that the row's msgpack blobs are equal
byte for byte. Nothing is decoded but a PNG without an ``eXIf`` chunk
before its image data, which PIL's ``getexif`` loads in full to read the
chunks after it (the port's PNG decoder stands in for PIL's).

Where PIL finds the EXIF block, as Pillow 12.1 does:

- JPEG: the APP1 ``Exif\\0\\0`` segments before the first SOS, joined; the
  size from the last SOF before it. JPEG's open reads the EXIF for its DPI
  and swallows a malformed block, which then reads as empty;
- PNG: ``eXIf`` (the last one), a ``tEXt`` chunk keyed ``exif``, or the
  hex of a text chunk keyed ``Raw profile type exif``; the size from IHDR;
- WebP: the first ``EXIF`` chunk of a VP8X file, once libwebp's demuxer
  accepts the file; the canvas size;
- TIFF and DNG: IFD0 itself, read again from the file; the size from IFD0,
  its sides swapped for orientations 5-8, once PIL's TIFF open would take
  the directory (its compression, pixel layout and data organisation);
- AVIF (an ``av01`` primary item; PIL reads it through libavif): the Exif
  item, its orientation replaced by the one ``irot``/``imir`` give where
  they differ (Pillow's AVIF plugin); the ``ispe`` size;
- HEIF and other ISO BMFF files PIL cannot open: the fallback of the JAX
  function, the largest ``ispe`` and the Exif item (``media/isobmff.py``);
- GIF, BMP and ICO under a media extension: the size, no EXIF.

Then, as PIL's ``ImageFileDirectory_v2``: each IFD entry's value by its
field type (an ASCII value loses one trailing NUL; a rational is an
``IFDRational``, NaN at a zero denominator; a single value unwrapped), a
read past the data ending the directory where it stands, the Exif
(``0x8769``) and GPS (``0x8825``) sub-IFDs from their offsets, and the XMP
``tiff:Orientation`` where IFD0 has none.
"""

from __future__ import annotations

import os
import re
import struct
import zlib
from fractions import Fraction
from typing import Any, Dict, Optional, Tuple

from .. import _msgpack

# Extensions eligible for media-data extraction (the JAX package's set).
MEDIA_DATA_EXTENSIONS = {
    "tiff", "dng", "jpeg", "jpg", "heif", "heifs", "heic", "avif",
    "avcs", "avci", "hif", "png", "webp",
}

_TAG = {
    "DateTimeOriginal": 0x9003,
    "Make": 0x010F,
    "Model": 0x0110,
    "Software": 0x0131,
    "Orientation": 0x0112,
    "FNumber": 0x829D,
    "ExposureTime": 0x829A,
    "ISOSpeedRatings": 0x8827,
    "FocalLength": 0x920A,
    "LensMake": 0xA433,
    "LensModel": 0xA434,
}
EXIF_IFD, GPS_IFD = 0x8769, 0x8825

# TIFF field types PIL reads → the size of one value.
_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
               13: 4, 16: 8}
_FORMATS = {3: "H", 4: "L", 6: "b", 8: "h", 9: "l", 11: "f", 12: "d", 13: "L", 16: "Q"}
# PIL's TiffTags lengths of the IFD0 tags read here (1: one value, 0: any
# number); every other tag, and every tag of the Exif and GPS IFDs, has
# none (one value unwrapped, more kept as a tuple).
_IFD0_LENGTHS = {0x010F: 1, 0x0110: 1, 0x0131: 1, 0x0112: 1, EXIF_IFD: 1, GPS_IFD: 1,
                 256: 1, 257: 1, 259: 1, 262: 1, 266: 1, 277: 1, 284: 1, 322: 1, 323: 1,
                 258: 0, 273: 0, 324: 0, 338: 0, 339: 0, 700: 0}
_TIFF_PREFIXES = (b"MM\x00*", b"II*\x00", b"MM*\x00", b"II\x00*", b"MM\x00+", b"II+\x00")
_XMP_ORIENTATION = r'tiff:Orientation(="|>)([0-9])'


class Rational:
    """PIL's ``IFDRational`` as far as the row reads it: ``float`` as
    ``numbers.Rational`` gives it (numerator / denominator, so a zero
    denominator raises), ``str`` of the value as a float (``nan`` at a zero
    denominator), truth and ``int`` of the value, and no iteration."""

    __slots__ = ("num", "den", "_val")

    def __init__(self, num: int, den: int):
        self.num, self.den = num, den
        self._val = float("nan") if den == 0 else Fraction(num, den)

    def __float__(self) -> float:
        return self.num / self.den

    def __repr__(self) -> str:
        return str(float(self._val))

    def __bool__(self) -> bool:
        return bool(self._val)

    def __int__(self) -> int:
        return int(self._val)


class _Short(Exception):
    """A read past the data: where PIL's IFD load stops (its OSError)."""


def _load_ifd(buf: bytes, off: int, e: str, big: bool) -> Tuple[Dict[int, tuple], Optional[int]]:
    """ImageFileDirectory_v2.load at `off` of `buf`: ({tag: (type, raw
    bytes)}, the next IFD's offset or None where the load stopped first)."""
    tags: Dict[int, tuple] = {}
    pos = off

    def read(n: int) -> bytes:
        nonlocal pos
        chunk = buf[pos:pos + n] if pos < len(buf) else b""
        if len(chunk) != n:
            raise _Short
        pos += n
        return chunk

    try:
        count = struct.unpack(e + ("Q" if big else "H"), read(8 if big else 2))[0]
        for _ in range(count):
            tag, typ, n, data = struct.unpack(e + ("HHQ8s" if big else "HHL4s"),
                                              read(20 if big else 12))
            if typ not in _TYPE_SIZES:
                continue
            size = n * _TYPE_SIZES[typ]
            if size > (8 if big else 4):
                at = struct.unpack(e + ("Q" if big else "L"), data[:8 if big else 4])[0]
                if at >= 1 << 63:
                    raise OverflowError("Python int too large to convert to C ssize_t")
                data = buf[at:at + size]
                if len(data) < size:
                    raise _Short
            else:
                data = data[:size]
            if data:
                tags[tag] = (typ, data)
        return tags, struct.unpack(e + ("Q" if big else "L"), read(8 if big else 4))[0]
    except _Short:
        return tags, None


def _value(typ: int, data: bytes, e: str, length: Optional[int]):
    """A tag's value as ImageFileDirectory_v2 gives it (``tag_v2[tag]``)."""
    if typ == 1:
        return data
    if typ in (2, 7):
        if typ == 2:
            data = data[:-1] if data.endswith(b"\0") else data
            data = data.decode("latin-1")
        return data if length == 1 or length is None else (data,)
    if typ in (5, 10):
        nums = struct.unpack(f"{e}{len(data) // 4}{'L' if typ == 5 else 'l'}", data)
        values = tuple(Rational(a, b) for a, b in zip(nums[::2], nums[1::2]))
    else:
        fmt = _FORMATS[typ]
        values = struct.unpack(f"{e}{len(data) // _TYPE_SIZES[typ]}{fmt}", data)
    if length == 1 or (length is None and len(values) == 1):
        return values[0]
    return values


def _fixup(v):
    """Exif._fixup: a one-value tuple unwrapped."""
    return v[0] if isinstance(v, tuple) and len(v) == 1 else v


class Exif:
    """PIL's ``Image.Exif`` as the row reads it: IFD0's values (``dict``),
    its length and ``get_ifd`` of the Exif and GPS IFDs."""

    def __init__(self, buf: bytes = b"", e: str = "<", big: bool = False,
                 tags: Optional[dict] = None, closed: bool = False):
        self.buf, self.e, self.big, self.closed = buf, e, big, closed
        self.values = {tag: _fixup(_value(typ, data, e, _IFD0_LENGTHS.get(tag)))
                       for tag, (typ, data) in (tags or {}).items()}

    def __len__(self) -> int:
        return len(self.values)

    def get(self, tag: int, default=None):
        return self.values.get(tag, default)

    def get_ifd(self, tag: int) -> dict:
        """Exif.get_ifd of the Exif or GPS IFD: {} where its offset is no
        integer; an offset that cannot be sought raises, as PIL's does, and
        so does every offset of a TIFF's own IFD0 once the file is closed
        (the JAX function asks after its ``with Image.open`` block)."""
        offset = self.values.get(tag)
        if self.closed and offset is not None:
            raise ValueError("I/O operation on closed file")
        if not isinstance(offset, int):
            return {}
        if offset < 0:
            raise ValueError("negative seek value")
        if offset >= 1 << 63:
            raise OverflowError("Python int too large to convert to C ssize_t")
        tags, _ = _load_ifd(self.buf, offset, self.e, self.big)
        return {t: _fixup(_value(typ, data, self.e, None)) for t, (typ, data) in tags.items()}


def load_exif(data: bytes) -> Exif:
    """Exif.load of an EXIF block (leading ``Exif\\0\\0`` stripped); raises
    where PIL's does (a header PIL does not take)."""
    while data and data.startswith(b"Exif\x00\x00"):
        data = data[6:]
    if not data:
        return Exif()
    head = data[:8]
    if head[:4] not in _TIFF_PREFIXES:
        raise SyntaxError(f"not a TIFF file (header {head!r} not valid)")
    e = ">" if head[:2] == b"MM" else "<"
    big = head[2] == 43
    nxt = struct.unpack(e + ("Q" if big else "L"), head[8:] if big else head[4:])[0]
    if nxt >= 1 << 63:
        raise OverflowError("Python int too large to convert to C ssize_t")
    tags, _ = _load_ifd(data, nxt, e, big)
    return Exif(data, e, big, tags)


def _xmp_orientation(exif: Exif, xmp) -> None:
    """getexif's XMP step: IFD0 without an Orientation takes the XMP
    ``tiff:Orientation`` (a str or bytes pattern as PIL picks it)."""
    if xmp is None or _TAG["Orientation"] in exif.values:
        return
    pattern = _XMP_ORIENTATION if isinstance(xmp, str) else _XMP_ORIENTATION.encode()
    match = re.search(pattern, xmp)
    if match:
        exif.values[_TAG["Orientation"]] = int(match[2])


# -- the formats --------------------------------------------------------------


def _jpeg(data: bytes) -> tuple:
    """JpegImageFile._open's marker walk: (size, EXIF block or None, XMP)."""
    handlers = _JPEG_MARKERS
    pos, size, exif, xmp, layers_ok, dpi = 3, None, None, None, False, False
    s = b"\xff"
    while True:
        if not s:
            raise IndexError("index out of range")
        if s[0] == 0xFF:
            if pos >= len(data):
                raise IndexError("index out of range")
            s, pos = s + data[pos:pos + 1], pos + 1
            marker = struct.unpack(">H", s)[0]
        else:
            s, pos = data[pos:pos + 1], pos + 1
            continue
        if marker in handlers:
            kind = handlers[marker]
            if kind is not None:
                if pos + 2 > len(data):
                    raise struct.error("unpack requires a buffer of 2 bytes")
                n = struct.unpack_from(">H", data, pos)[0] - 2
                pos += 2
                body = data[pos:pos + n] if n > 0 else b""
                if n > 0 and len(body) < n:
                    raise OSError("Truncated File Read")
                pos += max(n, 0)
                if kind == "APP":
                    if marker == 0xFFE0 and body.startswith(b"JFIF"):
                        struct.unpack_from(">H", body, 5)  # the version PIL reads
                        dpi |= len(body) >= 12 and body[7] in (1, 2)
                    elif marker == 0xFFE1 and body.startswith(b"Exif\0\0"):
                        exif = body if exif is None else exif + body[6:]
                    elif marker == 0xFFE1 and body.startswith(b"http://ns.adobe.com/xap/1.0/\x00"):
                        xmp = body.split(b"\x00", 1)[1]
                elif kind == "SOF":
                    size = (struct.unpack_from(">H", body, 3)[0],
                            struct.unpack_from(">H", body, 1)[0])
                    if body[0] != 8:
                        raise SyntaxError(f"cannot handle {body[0]}-bit layers")
                    if body[5] not in (1, 3, 4):
                        raise SyntaxError(f"cannot handle {body[5]}-layer images")
                    layers_ok = True
                elif kind == "DQT":
                    rest = body
                    while rest:
                        qt = 1 + (1 if rest[0] // 16 == 0 else 2) * 64
                        if len(rest) < qt:
                            raise SyntaxError("bad quantization table marker")
                        rest = rest[qt:]
            if marker == 0xFFDA:
                break
            s, pos = data[pos:pos + 1], pos + 1
        elif marker in (0, 0xFFFF):
            s = b"\xff"
        elif marker == 0xFF00:
            s, pos = data[pos:pos + 1], pos + 1
        else:
            raise SyntaxError("no marker found")
    if size is None or not layers_ok:
        raise SyntaxError("no SOF before the scan")
    if exif is None or dpi:
        exif_obj = load_exif(exif) if exif is not None else Exif()
    else:
        try:  # _read_dpi_from_exif: getexif at open, its faults swallowed
            exif_obj = load_exif(exif)
        except (struct.error, SyntaxError, TypeError, ValueError):
            return size, Exif()
    _xmp_orientation(exif_obj, xmp)
    return size, exif_obj


# JpegImagePlugin.MARKER: the markers PIL's open knows, by handler (None:
# no segment follows).
_JPEG_MARKERS = {
    **{m: "SOF" for m in (0xFFC0, 0xFFC1, 0xFFC2, 0xFFC3, 0xFFC5, 0xFFC6, 0xFFC7, 0xFFC9,
                          0xFFCA, 0xFFCB, 0xFFCD, 0xFFCE, 0xFFCF, 0xFFDE)},
    **{m: "SKIP" for m in (0xFFC4, 0xFFCC, 0xFFDA, 0xFFDC, 0xFFDD, 0xFFDF, 0xFFFE)},
    **{m: None for m in (0xFFC8, *range(0xFFD0, 0xFFDA), *range(0xFFF0, 0xFFFE))},
    0xFFDB: "DQT",
    **{m: "APP" for m in range(0xFFE0, 0xFFF0)},
}


def _png_text(ctype: bytes, payload: bytes, info: dict) -> None:
    """PngStream's tEXt, zTXt, iTXt and eXIf handlers, into `info`."""
    if ctype == b"eXIf":
        info["exif"] = b"Exif\x00\x00" + payload
        return
    k, sep, v = payload.partition(b"\0")
    if ctype == b"tEXt":
        if k:
            info[k.decode("latin-1")] = v if k == b"exif" else v.decode("latin-1", "replace")
    elif ctype == b"zTXt":
        if v and v[0] != 0:
            raise SyntaxError(f"Unknown compression method {v[0]} in zTXt chunk")
        try:
            v = zlib.decompress(v[1:])
        except zlib.error:
            v = b""
        if k:
            info[k.decode("latin-1")] = v.decode("latin-1", "replace")
    elif ctype == b"iTXt":
        if not sep or len(v) < 2:
            return
        cf, cm, r = v[0], v[1], v[2:]
        parts = r.split(b"\0", 2)
        if len(parts) < 3:
            return
        lang, tk, v = parts
        if cf:
            if cm:
                return
            try:
                v = zlib.decompress(v)
            except zlib.error:
                return
        if k == b"XML:com.adobe.xmp":
            info["xmp"] = v
        try:
            k_str, v_str = k.decode("latin-1"), v.decode("utf-8")
            lang.decode("utf-8"), tk.decode("utf-8")
        except UnicodeError:
            return
        info[k_str] = v_str


def _png(data: bytes) -> tuple:
    from .imgdecode import PNG_SIGNATURE, _png_chunks, decode

    info: dict = {}
    size = None
    idat_at = None
    for ctype, payload in _png_chunks(data):
        if ctype == b"IHDR":
            if len(payload) < 8:
                raise SyntaxError("bad IHDR")
            size = struct.unpack(">II", payload[:8])
        elif ctype == b"IDAT":
            break
        elif ctype in (b"eXIf", b"tEXt", b"zTXt", b"iTXt"):
            _png_text(ctype, payload, info)
    if size is None:
        raise SyntaxError("PNG without IHDR")
    if size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("image size not positive")
    if "exif" not in info:
        # getexif loads the image, then reads the chunks after its data.
        decode(data)
        pos = len(PNG_SIGNATURE)
        seen_idat = False
        while pos + 8 <= len(data):
            length, ctype = struct.unpack_from(">I4s", data, pos)
            if not re.match(rb"\w\w\w\w", ctype):
                break
            if ctype == b"IDAT":
                seen_idat = True
            elif seen_idat:
                if ctype == b"IEND":
                    break
                payload = data[pos + 8:pos + 8 + length]
                if len(payload) < length:
                    raise OSError("Truncated File Read")
                if ctype in (b"eXIf", b"tEXt", b"zTXt", b"iTXt"):
                    try:
                        _png_text(ctype, payload, info)
                    except UnicodeDecodeError:
                        break
            pos += 12 + length
    exif_info = info.get("exif")
    if exif_info is None and "Raw profile type exif" in info:
        exif_info = bytes.fromhex("".join(info["Raw profile type exif"].split("\n")[3:]))
    exif = load_exif(exif_info) if exif_info is not None else Exif()
    xmp = info.get("XML:com.adobe.xmp") or info.get("xmp")
    _xmp_orientation(exif, xmp)
    return size, exif


def _webp(data: bytes) -> tuple:
    from .webp import _Demux

    demux = _Demux(data)
    exif = xmp = None
    if demux.extended:
        buf = demux.buf
        pos = 12 + 8 + ((struct.unpack_from("<I", buf, 16)[0] + 1) & ~1)
        while pos + 8 <= len(buf):
            fourcc = buf[pos:pos + 4]
            n = struct.unpack_from("<I", buf, pos + 4)[0]
            if fourcc == b"EXIF" and exif is None:
                exif = buf[pos + 8:pos + 8 + n]
            elif fourcc == b"XMP " and xmp is None:
                xmp = buf[pos + 8:pos + 8 + n]
            pos += 8 + n + (n & 1)
    obj = load_exif(exif) if exif else Exif()
    _xmp_orientation(obj, xmp or None)
    return demux.canvas, obj


def _tiff_value(tags: dict, e: str, tag: int, default=None):
    if tag not in tags:
        return default
    typ, data = tags[tag]
    return _value(typ, data, e, _IFD0_LENGTHS.get(tag))


# PIL's TIFF OPEN_INFO keys (Pillow 12.1): (photometric, sample format,
# fill order, bits per sample, extra samples), under both byte orders or
# under the one named.
_OPEN_BOTH = (
    (0, (1,), 1, (1,), ()), (0, (1,), 1, (2,), ()), (0, (1,), 1, (4,), ()), (0, (1,), 1, (8,),
    ()), (0, (1,), 2, (1,), ()), (0, (1,), 2, (2,), ()), (0, (1,), 2, (4,), ()), (0, (1,), 2,
    (8,), ()), (0, (3,), 1, (32,), ()), (1, (1,), 1, (1,), ()), (1, (1,), 1, (2,), ()), (1,
    (1,), 1, (4,), ()), (1, (1,), 1, (8,), ()), (1, (1,), 1, (8, 8), (2,)), (1, (1,), 1,
    (16,), ()), (1, (1,), 2, (1,), ()), (1, (1,), 2, (2,), ()), (1, (1,), 2, (4,), ()), (1,
    (1,), 2, (8,), ()), (1, (2,), 1, (8,), ()), (1, (2,), 1, (16,), ()), (1, (2,), 1, (32,),
    ()), (1, (3,), 1, (32,), ()), (2, (1,), 1, (8, 8, 8), ()), (2, (1,), 1, (8, 8, 8, 8), ()),
    (2, (1,), 1, (8, 8, 8, 8), (0,)), (2, (1,), 1, (8, 8, 8, 8), (1,)), (2, (1,), 1, (8, 8, 8,
    8), (2,)), (2, (1,), 1, (8, 8, 8, 8), (999,)), (2, (1,), 1, (8, 8, 8, 8, 8), (0, 0)), (2,
    (1,), 1, (8, 8, 8, 8, 8), (1, 0)), (2, (1,), 1, (8, 8, 8, 8, 8), (2, 0)), (2, (1,), 1, (8,
    8, 8, 8, 8, 8), (0, 0, 0)), (2, (1,), 1, (8, 8, 8, 8, 8, 8), (1, 0, 0)), (2, (1,), 1, (8,
    8, 8, 8, 8, 8), (2, 0, 0)), (2, (1,), 1, (16, 16, 16), ()), (2, (1,), 1, (16, 16, 16, 16),
    ()), (2, (1,), 1, (16, 16, 16, 16), (0,)), (2, (1,), 1, (16, 16, 16, 16), (1,)), (2, (1,),
    1, (16, 16, 16, 16), (2,)), (2, (1,), 2, (8, 8, 8), ()), (3, (1,), 1, (1,), ()), (3, (1,),
    1, (2,), ()), (3, (1,), 1, (4,), ()), (3, (1,), 1, (8,), ()), (3, (1,), 1, (8, 8), (0,)),
    (3, (1,), 1, (8, 8), (2,)), (3, (1,), 2, (1,), ()), (3, (1,), 2, (2,), ()), (3, (1,), 2,
    (4,), ()), (3, (1,), 2, (8,), ()), (5, (1,), 1, (8, 8, 8, 8), ()), (5, (1,), 1, (8, 8, 8,
    8, 8), (0,)), (5, (1,), 1, (8, 8, 8, 8, 8, 8), (0, 0)), (5, (1,), 1, (16, 16, 16, 16),
    ()), (6, (1,), 1, (8,), ()), (6, (1,), 1, (8, 8, 8), ()), (8, (1,), 1, (8, 8, 8), ()),
)
_OPEN_ONE = (
    ((0, (1,), 1, (16,), ()), b'II'), ((1, (1,), 1, (12,), ()), b'II'), ((1, (1,), 1, (32,),
    ()), b'II'), ((1, (1,), 2, (16,), ()), b'II'),
)
_TIFF_OPEN = {(p, *k) for k in _OPEN_BOTH for p in (b"II", b"MM")} | \
    {(p, *k) for k, p in _OPEN_ONE}
_TIFF_COMPRESSIONS = (1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34676, 34677, 34925,
                      50000, 50001)


def _tiff(data: bytes) -> tuple:
    """TiffImageFile._open and _setup on IFD0, then getexif's reload of
    it: (size, Exif); raises where PIL's open does."""
    head = data[:8]
    if head[:4] not in _TIFF_PREFIXES:
        raise SyntaxError("not a TIFF file")
    big = head[2] == 43
    if big:
        head += data[8:16]
    e = ">" if head[:2] == b"MM" else "<"
    first = struct.unpack(e + ("Q" if big else "L"), head[8:] if big else head[4:])[0]
    if not first:
        raise EOFError("no more images in TIFF file")
    if first >= 1 << 63:
        raise ValueError("Unable to seek to frame")
    tags, _ = _load_ifd(data, first, e, big)

    def v(tag, default=None):
        return _tiff_value(tags, e, tag, default)

    if 0xBC01 in tags:
        raise OSError("Windows Media Photo files not yet supported")
    compression = v(259, 1)
    if compression not in _TIFF_COMPRESSIONS:
        raise KeyError(compression)
    photo = 6 if compression == 6 else v(262, 0)
    if 256 not in tags or 257 not in tags:
        raise TypeError("Missing dimensions")
    xsize, ysize = v(256), v(257)
    if not isinstance(xsize, int) or not isinstance(ysize, int):
        raise ValueError("Invalid dimensions")
    size = (ysize, xsize) if v(274) in (5, 6, 7, 8) else (xsize, ysize)
    sample_format = v(339, (1,))
    if len(sample_format) > 1 and max(sample_format) == min(sample_format) == 1:
        sample_format = (1,)
    bps, extra = v(258, (1,)), v(338, ())
    spp = v(277, 3 if compression == 6 and photo in (2, 6) else 1)
    if spp > 6:
        raise SyntaxError("Invalid value for samples per pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise SyntaxError("unknown data organization")
    if (head[:2], photo, sample_format, v(266, 1), bps, extra) not in _TIFF_OPEN:
        raise SyntaxError("unknown pixel mode")
    if compression == 1:  # the raw route reads strips or tiles itself
        if 273 not in tags and 324 not in tags:
            raise SyntaxError("unknown data organization")
        if 273 not in tags and not (isinstance(v(322), int) and isinstance(v(323), int)):
            raise ValueError("Invalid tile dimensions")
    if size[0] <= 0 or size[1] <= 0:
        raise SyntaxError("image size not positive")
    exif = Exif(data, e, big, tags, closed=True)
    xmp = v(700)
    _xmp_orientation(exif, xmp[0] if isinstance(xmp, tuple) and len(xmp) == 1 else xmp)
    return size, exif


# libavif's avifImageIrotImirToExifOrientation: irot's angle (0-3,
# anticlockwise) and imir's axis (0, 1, or none) → an EXIF orientation.
_AVIF_ORIENT = {(0, None): 1, (0, 0): 4, (0, 1): 2, (1, None): 8, (1, 0): 5, (1, 1): 7,
                (2, None): 3, (2, 0): 2, (2, 1): 4, (3, None): 6, (3, 0): 7, (3, 1): 5}
_AVIF_BRANDS = (b"avif", b"avis", b"mif1", b"msf1")


def _avif(data: bytes) -> tuple:
    """An AVIF PIL reads through libavif: an av01 primary item. (size, the
    Exif item's EXIF with the irot/imir orientation where it differs)."""
    from .isobmff import find_box, heif_dimensions, heif_exif, iter_boxes, parse_heif

    if data[4:8] != b"ftyp" or data[8:12] not in _AVIF_BRANDS:
        raise SyntaxError("not an AVIF file")
    meta = parse_heif(data)
    primary = meta.items.get(meta.primary)
    dims = heif_dimensions(data)
    if primary is None or primary.item_type != b"av01" or dims is None:
        raise SyntaxError("no AV1 primary item")
    angle, axis = 0, None
    span = find_box(data, [b"meta", b"iprp", b"ipco"])
    for typ, ps, pe in iter_boxes(data, span[0], span[1]):
        if typ == b"irot" and pe > ps:
            angle = data[ps] & 3
        elif typ == b"imir" and pe > ps:
            axis = data[ps] & 1
    orientation = _AVIF_ORIENT[(angle, axis)]
    tiff = heif_exif(data, meta)
    exif = load_exif(tiff) if tiff else Exif()
    if (orientation != 1 or tiff) and orientation != exif.get(_TAG["Orientation"], 1):
        exif.values[_TAG["Orientation"]] = orientation
    if dims[0] <= 0 or dims[1] <= 0:
        raise SyntaxError("image size not positive")
    return dims, exif


def _open(data: bytes) -> tuple:
    """``Image.open`` → (size, ``getexif()``) by the bytes' signature."""
    from .imgdecode import (GIF_SIGNATURES, ICO_SIGNATURE, JPEG_SIGNATURE, MAX_PIXELS,
                            PNG_SIGNATURE, decode)

    if data[:8] == PNG_SIGNATURE:
        size, exif = _png(data)
    elif data[:3] == JPEG_SIGNATURE:
        size, exif = _jpeg(data)
    elif data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        size, exif = _webp(data)
    elif data[:4] in _TIFF_PREFIXES:
        size, exif = _tiff(data)
    elif data[4:8] == b"ftyp":
        size, exif = _avif(data)
    elif data[:2] == b"BM" or data[:6] in GIF_SIGNATURES or data[:4] == ICO_SIGNATURE:
        pixels = decode(data).pixels
        size, exif = (pixels.shape[1], pixels.shape[0]), Exif()
    else:
        raise SyntaxError("cannot identify image file")
    if size[0] * size[1] > MAX_PIXELS:  # Image.open's decompression-bomb error
        raise ValueError(f"image size {size} past {MAX_PIXELS} pixels")
    return size, exif


def _ratio(v) -> Optional[float]:
    try:
        return float(v)
    except (TypeError, ValueError, ZeroDivisionError):
        return None


def _gps_to_degrees(values, ref: str) -> Optional[float]:
    try:
        d, m, s = (float(x) for x in values)
        deg = d + m / 60 + s / 3600
        return -deg if ref in ("S", "W") else deg
    except Exception:
        return None


def _heif_exif_fallback(path: str):
    """(width, height, Exif) for HEIF containers PIL cannot open: the EXIF
    item and ``ispe`` size, readable without an HEVC decoder."""
    from .images import HEIF_EXTENSIONS, MAXIMUM_FILE_SIZE
    from .isobmff import heif_dimensions, heif_exif

    ext = path.rsplit(".", 1)[-1].lower()
    if ext not in HEIF_EXTENSIONS:
        return None
    try:
        if os.path.getsize(path) > MAXIMUM_FILE_SIZE:
            return None
        with open(path, "rb") as f:
            data = f.read()
        dims = heif_dimensions(data) or (0, 0)
        tiff = heif_exif(data)
        exif = load_exif(b"Exif\x00\x00" + tiff) if tiff is not None else Exif()
        return dims[0], dims[1], exif
    except Exception:
        return None


def extract_media_data(path: str) -> Optional[Dict[str, Any]]:
    """Returns a media_data row dict (without object_id), or None when the
    file has no readable EXIF."""
    try:
        with open(path, "rb") as f:
            data = f.read()
        (width, height), exif = _open(data)
    except Exception:
        heif = _heif_exif_fallback(path)
        if heif is None:
            return None
        width, height, exif = heif

    row: Dict[str, Any] = {
        "resolution": _msgpack.packb({"width": width, "height": height}),
    }
    if not exif:
        return row

    ifd = {}
    try:
        ifd = dict(exif.get_ifd(EXIF_IFD))
    except Exception:
        pass
    merged = {**exif.values, **ifd}

    date = merged.get(_TAG["DateTimeOriginal"])
    if date:
        row["media_date"] = _msgpack.packb(str(date))
    camera = {
        k: str(merged[t]) for k, t in (
            ("make", _TAG["Make"]), ("model", _TAG["Model"]),
            ("software", _TAG["Software"]),
            ("lens_make", _TAG["LensMake"]),
            ("lens_model", _TAG["LensModel"]),
        ) if merged.get(t)
    }
    for k, t in (("f_number", _TAG["FNumber"]),
                 ("exposure_time", _TAG["ExposureTime"]),
                 ("focal_length", _TAG["FocalLength"])):
        v = _ratio(merged.get(t))
        if v is not None:
            camera[k] = v
    iso = merged.get(_TAG["ISOSpeedRatings"])
    if iso is not None:
        try:
            camera["iso"] = int(iso if not isinstance(iso, tuple) else iso[0])
        except (TypeError, ValueError):
            pass
    orient = merged.get(_TAG["Orientation"])
    if orient is not None:
        try:
            camera["orientation"] = int(orient)
        except (TypeError, ValueError):
            pass
    if camera:
        row["camera_data"] = _msgpack.packb(camera)

    try:
        gps = exif.get_ifd(GPS_IFD)
        if gps:
            lat = _gps_to_degrees(gps.get(2), str(gps.get(1, "N")))
            lon = _gps_to_degrees(gps.get(4), str(gps.get(3, "E")))
            if lat is not None and lon is not None:
                from .pluscodes import encode as encode_pluscode

                row["media_location"] = _msgpack.packb({
                    "latitude": lat, "longitude": lon,
                    "pluscode": encode_pluscode(lat, lon),
                })
    except Exception:
        pass
    return row
