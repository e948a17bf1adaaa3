"""MP4/MOV/M4A stream metadata from the container, no demuxer needed.

Port of ``spacedrive_tpu/media/mp4meta.py``, a copy. The `moov` box tree
is read directly (ISO/IEC 14496-12, the same box framing media/isobmff.py
parses for HEIF): movie duration from `mvhd`, per-track
dimensions/rotation from `tkhd`, codec fourcc + sample-entry details from
`stsd`, audio rate/channels from the AudioSampleEntry, fps estimated from
`stts`/`mdhd`; and the iTunes `covr` cover image.

Only box headers are walked at file level (a video file is GBs but its
`moov` is typically well under 10 MB), so probing is O(moov), not
O(file). The common camera/phone brands — isom/mp42/qt/3gp — all use
this layout.
"""

from __future__ import annotations

import math
import os
import struct
from typing import Dict, Optional

from .isobmff import iter_boxes

_MOOV_CAP = 64 << 20  # a moov larger than this is not metadata


def _file_top_boxes(f, end: int):
    """Yield (type, payload_off, payload_end) of top-level boxes by
    seeking over payloads — never reads media data."""
    pos = 0
    while pos + 8 <= end:
        f.seek(pos)
        head = f.read(16)
        if len(head) < 8:
            return
        size, typ = struct.unpack_from(">I4s", head, 0)
        hdr = 8
        if size == 1:
            if len(head) < 16:
                return
            size = struct.unpack_from(">Q", head, 8)[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        if size < hdr or pos + size > end:
            return
        yield typ, pos + hdr, pos + size
        pos += size


def _rotation_from_matrix(m: bytes) -> Optional[int]:
    """Track display rotation (degrees CW) from the 3x3 16.16/2.30
    fixed-point matrix — how phones record portrait video."""
    a, b, _u, c, d = struct.unpack_from(">5i", m, 0)[:5]
    a /= 65536.0; b /= 65536.0; c /= 65536.0; d /= 65536.0
    deg = round(math.degrees(math.atan2(b, a))) % 360
    return deg if deg in (0, 90, 180, 270) else None


def parse_mp4(path: str) -> Optional[Dict]:
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        end = f.tell()
        f.seek(0)
        head = f.read(12)
        if len(head) < 12 or head[4:8] != b"ftyp":
            return None
        brand = head[8:12].decode("ascii", "replace")
        moov = None
        for typ, ps, pe in _file_top_boxes(f, end):
            if typ == b"moov":
                if pe - ps > _MOOV_CAP:
                    return None
                f.seek(ps)
                moov = f.read(pe - ps)
                break
        if moov is None:
            return None

    out: Dict = {"format_name": "mov" if brand.startswith("qt")
                 else "mp4", "brand": brand.strip()}

    def full(ps: int):
        version = moov[ps]
        return version, ps + 4

    for typ, ps, pe in iter_boxes(moov):
        if typ == b"mvhd":
            v, p = full(ps)
            if v == 1:
                p += 16
                timescale = struct.unpack_from(">I", moov, p)[0]
                duration = struct.unpack_from(">Q", moov, p + 4)[0]
            else:
                p += 8
                timescale = struct.unpack_from(">I", moov, p)[0]
                duration = struct.unpack_from(">I", moov, p + 4)[0]
            if timescale:
                out["duration_seconds"] = round(duration / timescale, 3)
        elif typ == b"trak":
            _parse_trak(moov, ps, pe, out)
    # format_name + brand alone mean nothing parsed — treat as unreadable
    return out if len(out) > 2 else None


def _parse_trak(moov: bytes, ps: int, pe: int, out: Dict) -> None:
    handler = None
    tkhd_dims = None
    rotation = None
    mdhd_ts = sample_count = None
    mdhd_dur = None
    stsd_entry = None

    def walk(ps, pe, depth=0):
        nonlocal handler, tkhd_dims, rotation, mdhd_ts, mdhd_dur
        nonlocal sample_count, stsd_entry
        for typ, bs, be in iter_boxes(moov, ps, pe):
            if typ == b"tkhd":
                v = moov[bs]
                p = bs + 4 + (32 if v == 1 else 20)
                p += 8 + 2 + 2 + 2 + 2   # reserved, layer, group, vol, rsvd
                mat = moov[p:p + 36]
                if len(mat) == 36:
                    rotation = _rotation_from_matrix(mat)
                p += 36
                if be - p >= 8:
                    w, h = struct.unpack_from(">II", moov, p)
                    tkhd_dims = (w >> 16, h >> 16)
            elif typ == b"hdlr":
                handler = moov[bs + 8:bs + 12]
            elif typ == b"mdhd":
                v = moov[bs]
                p = bs + 4 + (16 if v == 1 else 8)
                mdhd_ts = struct.unpack_from(">I", moov, p)[0]
                mdhd_dur = (struct.unpack_from(">Q", moov, p + 4)[0]
                            if v == 1 else
                            struct.unpack_from(">I", moov, p + 4)[0])
            elif typ == b"stsd":
                n = struct.unpack_from(">I", moov, bs + 4)[0]
                if n >= 1:
                    esz, fourcc = struct.unpack_from(">I4s", moov, bs + 8)
                    stsd_entry = (fourcc, bs + 8, min(bs + 8 + esz, be))
            elif typ == b"stts":
                n = struct.unpack_from(">I", moov, bs + 4)[0]
                # clamp to what the box actually holds (corrupt counts
                # must not read sibling bytes) and to a sane VFR bound;
                # a clamped count would yield a WRONG fps, so omit it
                capped = min(n, (be - bs - 8) // 8, 65536)
                if capped == n:
                    total = 0
                    for k in range(capped):
                        cnt = struct.unpack_from(
                            ">I", moov, bs + 8 + 8 * k)[0]
                        total += cnt
                    sample_count = total
            elif typ in (b"mdia", b"minf", b"stbl"):
                walk(bs, be, depth + 1)

    walk(ps, pe)
    if stsd_entry is None:
        return
    fourcc, es, ee = stsd_entry
    codec = fourcc.decode("ascii", "replace").strip()
    if handler == b"vide":
        if "video_codec" in out:
            return  # first video track wins (matches the ffprobe branch)
        out["video_codec"] = codec
        # VisualSampleEntry: 8 hdr + 6 reserved + 2 dref + 16 predefined
        p = es + 8 + 6 + 2 + 16
        if ee - p >= 4:
            w, h = struct.unpack_from(">HH", moov, p)
            if w and h:
                out["width"], out["height"] = w, h
        if tkhd_dims and not out.get("width"):
            out["width"], out["height"] = tkhd_dims
        if rotation:
            out["rotation"] = rotation
        if mdhd_ts and mdhd_dur and sample_count:
            secs = mdhd_dur / mdhd_ts
            if secs > 0:
                out["fps"] = round(sample_count / secs, 3)
    elif handler == b"soun":
        if "audio_codec" in out:
            return
        out["audio_codec"] = codec
        # AudioSampleEntry: 8 hdr + 6 reserved + 2 dref + 8 version/rsvd,
        # then channelcount(2) samplesize(2) predefined(2) reserved(2)
        # samplerate(16.16)
        p = es + 8 + 6 + 2 + 8
        if ee - p >= 12:
            channels, _bits = struct.unpack_from(">HH", moov, p)
            rate = struct.unpack_from(">I", moov, p + 8)[0] >> 16
            if channels:
                out["channels"] = channels
            if rate:
                out["sample_rate"] = rate


def mp4_cover_art(path: str) -> Optional[bytes]:
    """Embedded cover image (iTunes-style `covr` in moov/udta/meta/ilst)
    — JPEG/PNG bytes, or None. Lets MP4/M4V/MOV files carry a real
    thumbnail with no video decoder (movies/TV rips and anything tagged
    by iTunes/ffmpeg `-disposition:v attached_pic` muxing carry one)."""
    with open(path, "rb") as f:
        f.seek(0, os.SEEK_END)
        end = f.tell()
        f.seek(0)
        if f.read(12)[4:8] != b"ftyp":
            return None
        moov = None
        for typ, ps, pe in _file_top_boxes(f, end):
            if typ == b"moov":
                if pe - ps > _MOOV_CAP:
                    return None
                f.seek(ps)
                moov = f.read(pe - ps)
                break
    if moov is None:
        return None
    span = (0, len(moov))
    for name in (b"udta", b"meta", b"ilst", b"covr", b"data"):
        found = None
        for typ, ps, pe in iter_boxes(moov, span[0], span[1]):
            if typ == name:
                if name == b"meta":
                    ps += 4  # FullBox version/flags
                found = (ps, pe)
                break
        if found is None:
            return None
        span = found
    # data box: u32 type (13=jpeg, 14=png), u32 locale, then payload
    ps, pe = span
    if pe - ps < 8:
        return None
    payload = moov[ps + 8:pe]
    if payload[:2] == b"\xff\xd8" or payload[:8] == b"\x89PNG\r\n\x1a\n":
        return payload
    return None
