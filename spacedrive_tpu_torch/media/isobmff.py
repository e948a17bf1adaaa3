"""ISO-BMFF (HEIF/HEIC/AVIF) box parser: embedded JPEG + EXIF extraction.

Port of ``spacedrive_tpu/media/isobmff.py``, a copy. The port decodes
neither HEVC nor AV1, but HEIF containers carry extractable payloads that
cover the thumbnail/metadata use cases without decoding the image at all:

- items whose coding is already JPEG (`infe` item_type "jpeg", or
  "mime" with an image/jpeg content type) — extract the bytes, decode
  with the generic raster path;
- the EXIF metadata item ("Exif"), whose TIFF IFD1 conventionally
  embeds a ready-made JPEG thumbnail (JPEGInterchangeFormat tags).

Box-structure references (publicly documented): ISO/IEC 14496-12
(box/fullbox framing, `meta`/`iloc`/`iinf`/`iref`/`pitm`) and ISO/IEC
23008-12 (HEIF item types). Only the subset needed for extraction is
implemented; everything else is skipped structurally.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

# Boxes whose payload is a sequence of child boxes.
_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf",
               b"iprp", b"ipco"}


class BoxError(ValueError):
    pass


def iter_boxes(data: bytes, start: int = 0,
               end: Optional[int] = None) -> Iterator[Tuple[bytes, int, int]]:
    """Yield (type, payload_start, payload_end) for each box in a span."""
    pos = start
    end = len(data) if end is None else end
    while pos + 8 <= end:
        size, typ = struct.unpack_from(">I4s", data, pos)
        header = 8
        if size == 1:
            if pos + 16 > end:
                raise BoxError("truncated largesize box")
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            header = 16
        elif size == 0:
            size = end - pos  # box extends to end of file
        if size < header or pos + size > end:
            raise BoxError(f"bad box size {size} at {pos}")
        yield typ, pos + header, pos + size
        pos += size


def find_box(data: bytes, path: List[bytes], start: int = 0,
             end: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """Payload span of the first box matching a type path (e.g.
    [b"meta", b"iinf"]); `meta` is a FullBox (4-byte version/flags)."""
    span = (start, len(data) if end is None else end)
    for depth, want in enumerate(path):
        found = None
        for typ, ps, pe in iter_boxes(data, span[0], span[1]):
            if typ == want:
                if typ in (b"meta",):  # FullBox: skip version/flags
                    ps += 4
                found = (ps, pe)
                break
        if found is None:
            return None
        span = found
    return span


@dataclass
class HeifItem:
    item_id: int
    item_type: bytes
    content_type: str = ""
    extents: List[Tuple[int, int]] = field(default_factory=list)  # (off, len)
    construction_method: int = 0
    base_offset: int = 0


@dataclass
class HeifMeta:
    primary: Optional[int] = None
    items: Dict[int, HeifItem] = field(default_factory=dict)
    # references: (ref_type, from_item) -> [to_items]
    refs: Dict[Tuple[bytes, int], List[int]] = field(default_factory=dict)
    idat: bytes = b""


def _parse_iinf(data: bytes, ps: int, pe: int, meta: HeifMeta) -> None:
    version = data[ps]
    count_size = 2 if version == 0 else 4
    pos = ps + 4
    pos += count_size  # entry_count
    for typ, ips, ipe in iter_boxes(data, pos, pe):
        if typ != b"infe":
            continue
        v = data[ips]
        p = ips + 4
        if v >= 2:
            if v == 2:
                item_id = struct.unpack_from(">H", data, p)[0]
                p += 2
            else:
                item_id = struct.unpack_from(">I", data, p)[0]
                p += 4
            p += 2  # protection index
            item_type = data[p:p + 4]
            p += 4
            item = meta.items.setdefault(item_id, HeifItem(item_id, b""))
            item.item_type = item_type
            if item_type == b"mime":
                # null-terminated item_name, then content_type
                name_end = data.index(b"\x00", p, ipe)
                ct_end = data.index(b"\x00", name_end + 1, ipe)
                item.content_type = data[name_end + 1:ct_end].decode(
                    "ascii", "replace")


def _parse_iloc(data: bytes, ps: int, pe: int, meta: HeifMeta) -> None:
    version = data[ps]
    p = ps + 4
    sizes = struct.unpack_from(">H", data, p)[0]
    p += 2
    offset_size = (sizes >> 12) & 0xF
    length_size = (sizes >> 8) & 0xF
    base_offset_size = (sizes >> 4) & 0xF
    index_size = sizes & 0xF if version in (1, 2) else 0
    if version < 2:
        item_count = struct.unpack_from(">H", data, p)[0]
        p += 2
    else:
        item_count = struct.unpack_from(">I", data, p)[0]
        p += 4

    def read_int(pos: int, size: int) -> Tuple[int, int]:
        if size == 0:
            return 0, pos
        raw = data[pos:pos + size]
        return int.from_bytes(raw, "big"), pos + size

    for _ in range(item_count):
        if version < 2:
            item_id = struct.unpack_from(">H", data, p)[0]
            p += 2
        else:
            item_id = struct.unpack_from(">I", data, p)[0]
            p += 4
        cm = 0
        if version in (1, 2):
            cm = struct.unpack_from(">H", data, p)[0] & 0xF
            p += 2
        p += 2  # data_reference_index
        base, p = read_int(p, base_offset_size)
        extent_count = struct.unpack_from(">H", data, p)[0]
        p += 2
        item = meta.items.setdefault(item_id, HeifItem(item_id, b""))
        item.construction_method = cm
        item.base_offset = base
        for _ in range(extent_count):
            _, p = read_int(p, index_size)
            off, p = read_int(p, offset_size)
            length, p = read_int(p, length_size)
            item.extents.append((off, length))


def _parse_iref(data: bytes, ps: int, pe: int, meta: HeifMeta) -> None:
    version = data[ps]
    id_fmt = ">H" if version == 0 else ">I"
    id_sz = 2 if version == 0 else 4
    for typ, rps, rpe in iter_boxes(data, ps + 4, pe):
        p = rps
        from_id = struct.unpack_from(id_fmt, data, p)[0]
        p += id_sz
        count = struct.unpack_from(">H", data, p)[0]
        p += 2
        to_ids = []
        for _ in range(count):
            to_ids.append(struct.unpack_from(id_fmt, data, p)[0])
            p += id_sz
        meta.refs[(typ, from_id)] = to_ids


def parse_heif(data: bytes) -> HeifMeta:
    meta_span = find_box(data, [b"meta"])
    if meta_span is None:
        raise BoxError("no meta box (not a HEIF container)")
    meta = HeifMeta()
    for typ, ps, pe in iter_boxes(data, meta_span[0], meta_span[1]):
        if typ == b"pitm":
            v = data[ps]
            meta.primary = (struct.unpack_from(">H", data, ps + 4)[0]
                            if v == 0 else
                            struct.unpack_from(">I", data, ps + 4)[0])
        elif typ == b"iinf":
            _parse_iinf(data, ps, pe, meta)
        elif typ == b"iloc":
            _parse_iloc(data, ps, pe, meta)
        elif typ == b"iref":
            _parse_iref(data, ps, pe, meta)
        elif typ == b"idat":
            meta.idat = data[ps:pe]
    return meta


def item_bytes(data: bytes, meta: HeifMeta, item: HeifItem) -> bytes:
    """Concatenate an item's extents (construction 0 = file offsets,
    1 = offsets into the meta idat box)."""
    src = meta.idat if item.construction_method == 1 else data
    out = bytearray()
    for off, length in item.extents:
        s = item.base_offset + off
        if length == 0:
            length = len(src) - s
        if s + length > len(src):
            raise BoxError(f"item {item.item_id} extent out of range")
        out += src[s:s + length]
    return bytes(out)


def heif_dimensions(data: bytes) -> Optional[Tuple[int, int]]:
    """Largest declared image size (`ispe` property in meta/iprp/ipco) —
    readable without any decode."""
    span = find_box(data, [b"meta", b"iprp", b"ipco"])
    if span is None:
        return None
    best = None
    for typ, ps, pe in iter_boxes(data, span[0], span[1]):
        if typ == b"ispe" and pe - ps >= 12:
            w, h = struct.unpack_from(">II", data, ps + 4)
            if best is None or w * h > best[0] * best[1]:
                best = (w, h)
    return best


# -- extraction helpers ----------------------------------------------------


def heif_exif(data: bytes, meta: Optional[HeifMeta] = None) -> Optional[bytes]:
    """The EXIF payload (TIFF stream) of a HEIF file, or None."""
    meta = meta or parse_heif(data)
    for item in meta.items.values():
        if item.item_type == b"Exif" and item.extents:
            raw = item_bytes(data, meta, item)
            if len(raw) < 8:
                return None
            # ExifDataBlock: u32 offset to the TIFF header within payload
            off = struct.unpack_from(">I", raw, 0)[0] + 4
            if raw[4:10] == b"Exif\x00\x00":
                off = 10
            if off > len(raw) - 8:
                return None
            return raw[off:]
    return None


def _tiff_thumbnail(tiff: bytes) -> Optional[bytes]:
    """JPEG thumbnail from TIFF IFD1 (JPEGInterchangeFormat/Length) —
    the classic EXIF-embedded thumbnail every camera writes."""
    if len(tiff) < 8:
        return None
    if tiff[:2] == b"II":
        u16, u32 = "<H", "<I"
    elif tiff[:2] == b"MM":
        u16, u32 = ">H", ">I"
    else:
        return None

    def read_ifd(off: int) -> Tuple[Dict[int, Tuple[int, int, int]], int]:
        """{tag: (type, count, value_or_offset)}, next_ifd_offset."""
        out: Dict[int, Tuple[int, int, int]] = {}
        if off + 2 > len(tiff):
            return out, 0
        n = struct.unpack_from(u16, tiff, off)[0]
        p = off + 2
        for _ in range(n):
            if p + 12 > len(tiff):
                return out, 0
            tag = struct.unpack_from(u16, tiff, p)[0]
            ftype = struct.unpack_from(u16, tiff, p + 2)[0]
            count = struct.unpack_from(u32, tiff, p + 4)[0]
            value = struct.unpack_from(u32, tiff, p + 8)[0]
            out[tag] = (ftype, count, value)
            p += 12
        nxt = (struct.unpack_from(u32, tiff, p)[0]
               if p + 4 <= len(tiff) else 0)
        return out, nxt

    ifd0_off = struct.unpack_from(u32, tiff, 4)[0]
    _, ifd1_off = read_ifd(ifd0_off)
    if not ifd1_off:
        return None
    ifd1, _ = read_ifd(ifd1_off)
    if 0x0201 not in ifd1 or 0x0202 not in ifd1:
        return None
    start = ifd1[0x0201][2]
    length = ifd1[0x0202][2]
    if start + length > len(tiff):
        return None
    jpeg = tiff[start:start + length]
    return jpeg if jpeg[:2] == b"\xff\xd8" else None


def heif_embedded_jpeg(data: bytes) -> Optional[bytes]:
    """Best extractable JPEG from a HEIF container, decoder-free.

    Preference order: a JPEG-coded thumbnail item referencing the
    primary (`thmb` iref), any JPEG-coded item, then the EXIF IFD1
    thumbnail. Returns raw JPEG bytes or None.
    """
    meta = parse_heif(data)

    def is_jpeg(it: HeifItem) -> bool:
        return (it.item_type == b"jpeg"
                or (it.item_type == b"mime"
                    and it.content_type.lower() == "image/jpeg"))

    jpeg_items = [it for it in meta.items.values()
                  if is_jpeg(it) and it.extents]
    # thumbnails first (smallest payload that still previews correctly)
    thumbs = [it for it in jpeg_items
              if meta.primary in meta.refs.get((b"thmb", it.item_id), [])]
    for it in thumbs + jpeg_items:
        raw = item_bytes(data, meta, it)
        if raw[:2] == b"\xff\xd8":
            return raw
    exif = heif_exif(data, meta)
    if exif is not None:
        return _tiff_thumbnail(exif)
    return None
