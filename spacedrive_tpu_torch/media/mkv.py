"""Matroska/WebM stream metadata: a minimal EBML walker.

Port of ``spacedrive_tpu/media/mkv.py``, a copy. MKV keeps its metadata
in plain EBML elements near the head of the file, so a tiny varint walker
recovers duration, codecs, dimensions and audio params without any
demuxer, and the first image attachment (cover art). Element IDs from the
public Matroska spec (Segment → Info{TimestampScale, Duration}, Tracks →
TrackEntry {TrackType, CodecID, Video{PixelWidth, PixelHeight}, Audio
{SamplingFrequency, Channels}}).

Only the first `_SCAN_CAP` bytes are examined: Info/Tracks precede the
clusters in every muxer that exists (streamed files use unknown-size
Segments, handled below).
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple

_SCAN_CAP = 16 << 20

_EBML = 0x1A45DFA3
_SEGMENT = 0x18538067
_INFO = 0x1549A966
_TS_SCALE = 0x2AD7B1
_DURATION = 0x4489
_TRACKS = 0x1654AE6B
_TRACK_ENTRY = 0xAE
_TRACK_TYPE = 0x83
_CODEC_ID = 0x86
_VIDEO = 0xE0
_PIXEL_W = 0xB0
_PIXEL_H = 0xBA
_AUDIO = 0xE1
_SAMPLING = 0xB5
_CHANNELS = 0x9F
_DOCTYPE = 0x4282


def _read_vint(data: bytes, pos: int,
               keep_marker: bool) -> Optional[Tuple[int, int, int]]:
    """(value, next_pos, vint_length). EBML ids keep the length marker
    bit; sizes strip it. Returns None at end of data."""
    if pos >= len(data):
        return None
    first = data[pos]
    if first == 0:
        return None
    length = 8 - first.bit_length() + 1
    if pos + length > len(data):
        return None
    val = first if keep_marker else first & (0xFF >> length)
    for k in range(1, length):
        val = (val << 8) | data[pos + k]
    return val, pos + length, length


def _walk(data: bytes, pos: int, end: int):
    """Yield (element_id, payload_start, payload_end)."""
    while pos < end:
        r = _read_vint(data, pos, keep_marker=True)
        if r is None:
            return
        eid, pos, _ = r
        r = _read_vint(data, pos, keep_marker=False)
        if r is None:
            return
        size, pos, slen = r
        # Unknown size = ALL data bits set FOR THIS VINT LENGTH (a
        # legit size of 127 in a non-minimal 2-byte vint is not it).
        if size == (1 << (7 * slen)) - 1:
            # unknown-size master element (streamed Segment): its
            # children run to the end of the scanned span
            yield eid, pos, end
            return
        pe = min(pos + size, end)
        yield eid, pos, pe
        pos += size


def _uint(data: bytes, ps: int, pe: int) -> int:
    v = 0
    for b in data[ps:pe]:
        v = (v << 8) | b
    return v


def _float(data: bytes, ps: int, pe: int) -> Optional[float]:
    n = pe - ps
    if n == 4:
        return struct.unpack(">f", data[ps:pe])[0]
    if n == 8:
        return struct.unpack(">d", data[ps:pe])[0]
    return None


def _scan(path: str):
    """Progressive read: Info/Tracks live in the head of every real
    muxer's output, so start at 256 KB and grow only while the tracks
    haven't been seen (a library sweep must not read 16 MB per file)."""
    size = 256 << 10
    with open(path, "rb") as f:
        while True:
            f.seek(0)
            data = f.read(size)
            if (b"\x16\x54\xae\x6b" in data  # Tracks id present
                    or len(data) < size or size >= _SCAN_CAP):
                return data
            size *= 4


def parse_mkv(path: str) -> Optional[Dict]:
    data = _scan(path)
    if len(data) < 8:
        return None
    out: Dict = {}
    segments = []
    for eid, ps, pe in _walk(data, 0, len(data)):
        if eid == _EBML:
            for cid, cs, ce in _walk(data, ps, pe):
                if cid == _DOCTYPE:
                    out["format_name"] = data[cs:ce].decode(
                        "ascii", "replace").strip("\x00")
        elif eid == _SEGMENT:
            segments.append((ps, pe))
    if "format_name" not in out:
        return None
    ts_scale = 1_000_000  # ns per timestamp tick (spec default)
    duration_ticks: Optional[float] = None
    for ps, pe in segments:
        for eid, bs, be in _walk(data, ps, pe):
            if eid == _INFO:
                for cid, cs, ce in _walk(data, bs, be):
                    if cid == _TS_SCALE:
                        ts_scale = _uint(data, cs, ce) or ts_scale
                    elif cid == _DURATION:
                        duration_ticks = _float(data, cs, ce)
            elif eid == _TRACKS:
                for cid, cs, ce in _walk(data, bs, be):
                    if cid != _TRACK_ENTRY:
                        continue
                    ttype, codec = None, None
                    video, audio = None, None
                    for tid, ts, te in _walk(data, cs, ce):
                        if tid == _TRACK_TYPE:
                            ttype = _uint(data, ts, te)
                        elif tid == _CODEC_ID:
                            codec = data[ts:te].decode("ascii", "replace")
                        elif tid == _VIDEO:
                            video = (ts, te)
                        elif tid == _AUDIO:
                            audio = (ts, te)
                    # first track of each type wins, matching mp4meta
                    # and the ffprobe branch
                    if ttype == 1 and video and "video_codec" not in out:
                        if codec:
                            out["video_codec"] = codec
                        for vid, vs, ve in _walk(data, *video):
                            if vid == _PIXEL_W:
                                out["width"] = _uint(data, vs, ve)
                            elif vid == _PIXEL_H:
                                out["height"] = _uint(data, vs, ve)
                    elif ttype == 2 and audio and "audio_codec" not in out:
                        if codec:
                            out["audio_codec"] = codec
                        for aid, as_, ae in _walk(data, *audio):
                            if aid == _SAMPLING:
                                r = _float(data, as_, ae)
                                if r:
                                    out["sample_rate"] = int(r)
                            elif aid == _CHANNELS:
                                out["channels"] = _uint(data, as_, ae)
    if duration_ticks is not None:
        out["duration_seconds"] = round(
            duration_ticks * ts_scale / 1e9, 3)
    return out if len(out) > 1 else None


_ATTACHMENTS = 0x1941A469
_ATTACHED_FILE = 0x61A7
_FILE_NAME = 0x466E
_FILE_MIME = 0x4660
_FILE_DATA = 0x465C


def mkv_attachment_image(path: str) -> Optional[bytes]:
    """First image attachment (cover.jpg convention) from a Matroska
    file — movie rips routinely attach cover art; no video decode
    needed. Returns JPEG/PNG bytes or None."""
    data = _scan(path)
    if len(data) < 8:
        return None
    # attachments usually precede clusters; extend the scan if the
    # Attachments id is beyond the tracks-bounded head read
    if _ATTACHMENTS.to_bytes(4, "big") not in data:
        with open(path, "rb") as f:
            data = f.read(_SCAN_CAP)
        if _ATTACHMENTS.to_bytes(4, "big") not in data:
            return None
    for eid, ps, pe in _walk(data, 0, len(data)):
        if eid != 0x18538067:  # Segment
            continue
        for sid, bs, be in _walk(data, ps, pe):
            if sid != _ATTACHMENTS:
                continue
            for aid, as_, ae in _walk(data, bs, be):
                if aid != _ATTACHED_FILE:
                    continue
                mime, blob = "", None
                for fid, fs, fe in _walk(data, as_, ae):
                    if fid == _FILE_MIME:
                        mime = data[fs:fe].decode("ascii", "replace")
                    elif fid == _FILE_DATA:
                        blob = data[fs:fe]
                if blob and (mime.startswith("image/")
                             or blob[:2] == b"\xff\xd8"
                             or blob[:8] == b"\x89PNG\r\n\x1a\n"):
                    return blob
    return None
