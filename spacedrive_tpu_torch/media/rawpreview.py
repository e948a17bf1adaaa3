"""RAW camera file previews — decoder-free, via the TIFF structure.

Port of ``spacedrive_tpu/media/rawpreview.py``, a copy. TIFF-based RAW
formats (DNG, CR2, NEF, ARW, PEF, ORF) don't need a RAW demosaicer for
thumbnails: every one of them embeds at least one JPEG preview — IFD0/IFD1 thumbnails
(JPEGInterchangeFormat), SubIFD previews (NEF/DNG), or CR2's IFD0
full-size JPEG strip. This module walks the TIFF IFD tree (both
endians, SubIFDs included), collects every plausible JPEG blob, and
returns the largest one that actually parses as a JPEG.

Pure structure walking — bounded reads, no pixel decoding."""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

RAW_TIFF_EXTENSIONS = {"dng", "cr2", "nef", "arw", "pef", "orf"}

_MAX_IFDS = 32          # cycle/fuzz guard
_MAX_PREVIEW = 64 << 20  # a preview larger than this is not a preview

# TIFF tags
_STRIP_OFFSETS = 0x0111
_STRIP_BYTE_COUNTS = 0x0117
_COMPRESSION = 0x0103
_JPEG_IF = 0x0201        # JPEGInterchangeFormat (offset)
_JPEG_IF_LEN = 0x0202    # JPEGInterchangeFormatLength
_SUB_IFDS = 0x014A


def _u(fmt: str, data: bytes, off: int) -> int:
    return struct.unpack_from(fmt, data, off)[0]


def _read_ifd(data: bytes, off: int, e: str) -> Tuple[dict, int]:
    """One IFD → ({tag: (type, count, value_or_offset_raw)}, next_off)."""
    if off + 2 > len(data):
        return {}, 0
    n = _u(e + "H", data, off)
    entries = {}
    p = off + 2
    for _ in range(n):
        if p + 12 > len(data):
            break
        tag = _u(e + "H", data, p)
        typ = _u(e + "H", data, p + 2)
        count = _u(e + "I", data, p + 4)
        entries[tag] = (typ, count, p + 8)
        p += 12
    nxt = _u(e + "I", data, p) if p + 4 <= len(data) else 0
    return entries, nxt


def _value(data: bytes, e: str, entry, index: int = 0) -> Optional[int]:
    """Integer value of a SHORT/LONG entry (inline or offset array)."""
    typ, count, vpos = entry
    size = {3: 2, 4: 4}.get(typ)
    if size is None or index >= count:
        return None
    fmt = e + ("H" if typ == 3 else "I")
    if count * size <= 4:
        return _u(fmt, data, vpos + index * size)
    arr_off = _u(e + "I", data, vpos)
    p = arr_off + index * size
    if p + size > len(data):
        return None
    return _u(fmt, data, p)


def _is_jpeg(blob: bytes) -> bool:
    return len(blob) > 4 and blob[:2] == b"\xff\xd8"


def extract_preview(path: str) -> Optional[bytes]:
    """Largest embedded JPEG preview of a TIFF-structured RAW file, or
    None when the file isn't TIFF-shaped / carries no parseable JPEG."""
    size = os.path.getsize(path)
    if size < 16 or size > (2 << 30):
        return None
    with open(path, "rb") as f:
        # Bounded: the IFD structures live at the head of every format
        # this module accepts; preview BLOBS may sit anywhere and are
        # seek+read individually below, never the whole file.
        data = f.read(min(size, 16 << 20))
    if data[:2] == b"II":
        e = "<"
    elif data[:2] == b"MM":
        e = ">"
    else:
        return None
    magic = _u(e + "H", data, 2)
    # 42 = TIFF/DNG/NEF/ARW/PEF; 0x4F52/0x5352 = ORF ("RO"/"RS")
    if magic not in (42, 0x4F52, 0x5352):
        return None
    first_ifd = _u(e + "I", data, 4)

    candidates: List[Tuple[int, int]] = []  # (offset, length)
    seen = set()
    queue = [first_ifd]
    hops = 0
    while queue and hops < _MAX_IFDS:
        off = queue.pop(0)
        if not off or off in seen or off + 2 > len(data):
            continue
        seen.add(off)
        hops += 1
        entries, nxt = _read_ifd(data, off, e)
        if nxt:
            queue.append(nxt)
        if _SUB_IFDS in entries:
            typ, count, _v = entries[_SUB_IFDS]
            for i in range(min(count, 8)):
                sub = _value(data, e, entries[_SUB_IFDS], i)
                if sub:
                    queue.append(sub)
        # IFD0/IFD1-style thumbnail pair
        if _JPEG_IF in entries and _JPEG_IF_LEN in entries:
            o = _value(data, e, entries[_JPEG_IF])
            ln = _value(data, e, entries[_JPEG_IF_LEN])
            if o and ln:
                candidates.append((o, ln))
        # strip-based previews (CR2 IFD0 carries a full-size JPEG this
        # way, compression 6 = old-style JPEG)
        comp = (_value(data, e, entries[_COMPRESSION])
                if _COMPRESSION in entries else None)
        if comp in (6, 7) and _STRIP_OFFSETS in entries \
                and _STRIP_BYTE_COUNTS in entries:
            o = _value(data, e, entries[_STRIP_OFFSETS])
            ln = _value(data, e, entries[_STRIP_BYTE_COUNTS])
            if o and ln:
                candidates.append((o, ln))

    best: Optional[bytes] = None
    fh = None
    try:
        for o, ln in candidates:
            if ln <= 0 or ln > _MAX_PREVIEW or o + ln > size:
                continue
            if o + ln <= len(data):
                blob = data[o:o + ln]
            else:  # preview beyond the structure window: targeted read
                if fh is None:
                    fh = open(path, "rb")
                fh.seek(o)
                blob = fh.read(ln)
            if _is_jpeg(blob) and (best is None or len(blob) > len(best)):
                best = blob
    finally:
        if fh is not None:
            fh.close()
    return best
