"""Self-hosted audio/video stream metadata parsers.

Port of ``spacedrive_tpu/media/audio.py``, a copy. Container headers are
parsed directly, no codec library needed, for the formats whose metadata
lives in plain sight —

- WAV   (RIFF fmt/data chunks: codec tag, channels, rate, duration)
- FLAC  (STREAMINFO block: rate, channels, bits, total samples)
- MP3   (first MPEG frame header; ID3v2 skipped; CBR duration estimate,
         Xing/Info frame count used when present)
- OGG   (Vorbis identification header + terminal page granule)
- Opus  (OpusHead in an Ogg stream, 48 kHz granule clock)
- AVI   (avih main header: dimensions, fps, frame count → duration;
         the same RIFF walker that powers MJPEG thumbnails)
- MP4/MOV/M4A/3GP (media/mp4meta.py: moov walk — duration, codec
         fourccs, dimensions, rotation, fps, audio rate/channels)
- MKV/WebM (media/mkv.py: EBML walk — the same fields)

Each parser returns a plain dict of present fields; `parse_stream_info`
dispatches by extension with a magic-byte check. Callers merge this into
`StreamMetadata` (media/avmetadata.py), which prefers ffprobe when an
ffmpeg install is available.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Optional

AUDIO_EXTENSIONS = {"wav", "flac", "mp3", "ogg", "opus", "m4a", "aac",
                    "wma", "aiff"}

# Layer III bitrate tables (kbps) by bitrate index; MPEG2 and MPEG2.5
# share one table, distinct from MPEG1's.
_MP3_BITRATES_V1 = {
    1: 32, 2: 40, 3: 48, 4: 56, 5: 64, 6: 80, 7: 96, 8: 112,
    9: 128, 10: 160, 11: 192, 12: 224, 13: 256, 14: 320,
}
_MP3_BITRATES_V2 = {
    1: 8, 2: 16, 3: 24, 4: 32, 5: 40, 6: 48, 7: 56, 8: 64,
    9: 80, 10: 96, 11: 112, 12: 128, 13: 144, 14: 160,
}
# Sample rates by version bits (3=MPEG1, 2=MPEG2, 0=MPEG2.5; 1 reserved).
_MP3_RATES = {
    3: {0: 44100, 1: 48000, 2: 32000},
    2: {0: 22050, 1: 24000, 2: 16000},
    0: {0: 11025, 1: 12000, 2: 8000},
}


def parse_wav(path: str) -> Optional[Dict]:
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            return None
        out: Dict = {"format_name": "wav"}
        byte_rate = data_size = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cc, size = hdr[:4], struct.unpack("<I", hdr[4:8])[0]
            if cc == b"fmt " and size >= 16:
                fmt = f.read(size + (size & 1))
                tag, ch, rate, brate, _align, bits = struct.unpack(
                    "<HHIIHH", fmt[:16])
                out["audio_codec"] = {1: "pcm_s16le", 3: "pcm_float",
                                      6: "pcm_alaw", 7: "pcm_mulaw",
                                      85: "mp3"}.get(tag, f"wav_0x{tag:x}")
                out["channels"] = ch
                out["sample_rate"] = rate
                out["bitrate"] = brate * 8
                byte_rate = brate
            elif cc == b"data":
                data_size = size
                f.seek(size + (size & 1), os.SEEK_CUR)
            else:
                f.seek(size + (size & 1), os.SEEK_CUR)
        if byte_rate and data_size:
            out["duration_seconds"] = round(data_size / byte_rate, 3)
        return out if "sample_rate" in out else None


def parse_flac(path: str) -> Optional[Dict]:
    with open(path, "rb") as f:
        if f.read(4) != b"fLaC":
            return None
        while True:
            hdr = f.read(4)
            if len(hdr) < 4:
                return None
            last = bool(hdr[0] & 0x80)
            btype = hdr[0] & 0x7F
            size = int.from_bytes(hdr[1:4], "big")
            if btype != 0:  # only STREAMINFO is read; skip PICTURE etc.
                f.seek(size, os.SEEK_CUR)
                if last:
                    return None
                continue
            block = f.read(size)
            if btype == 0 and size >= 34:  # STREAMINFO
                bits = int.from_bytes(block[10:18], "big")
                rate = (bits >> 44) & 0xFFFFF
                channels = ((bits >> 41) & 0x7) + 1
                depth = ((bits >> 36) & 0x1F) + 1
                total = bits & ((1 << 36) - 1)
                out = {"format_name": "flac", "audio_codec": "flac",
                       "sample_rate": rate, "channels": channels,
                       "bits_per_sample": depth}
                if rate and total:
                    out["duration_seconds"] = round(total / rate, 3)
                return out
            if last:
                return None


def parse_mp3(path: str) -> Optional[Dict]:
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        data = f.read(256 * 1024)
        start = 0
        if data[:3] == b"ID3" and len(data) > 10:
            syn = data[6:10]
            start = 10 + ((syn[0] & 0x7F) << 21 | (syn[1] & 0x7F) << 14
                          | (syn[2] & 0x7F) << 7 | (syn[3] & 0x7F))
            if start >= len(data):
                # Oversized ID3 tag (cover art): window past it.
                f.seek(start)
                data = f.read(256 * 1024)
                base, start = start, 0
            else:
                base = 0
        else:
            base = 0
    pos = start
    while pos + 4 <= len(data):
        b = data[pos:pos + 4]
        if b[0] == 0xFF and (b[1] & 0xE0) == 0xE0:
            version = (b[1] >> 3) & 0x3   # 3=MPEG1 2=MPEG2 0=MPEG2.5
            layer = (b[1] >> 1) & 0x3     # 1=III
            br_idx = (b[2] >> 4) & 0xF
            sr_idx = (b[2] >> 2) & 0x3
            bitrates = (_MP3_BITRATES_V1 if version == 3
                        else _MP3_BITRATES_V2)
            if (layer == 1 and version != 1 and br_idx in bitrates
                    and sr_idx < 3):
                rate = _MP3_RATES[version][sr_idx]
                kbps = bitrates[br_idx]
                out = {"format_name": "mp3", "audio_codec": "mp3",
                       "sample_rate": rate,
                       "channels": 1 if ((b[3] >> 6) & 0x3) == 3 else 2,
                       "bitrate": kbps * 1000}
                # Xing/Info header carries the true frame count (VBR).
                spf = 1152 if version == 3 else 576
                window = data[pos:pos + 200]
                for tag in (b"Xing", b"Info"):
                    at = window.find(tag)
                    if at >= 0 and len(window) >= at + 12:
                        flags = struct.unpack(
                            ">I", window[at + 4:at + 8])[0]
                        if flags & 1:
                            frames = struct.unpack(
                                ">I", window[at + 8:at + 12])[0]
                            out["duration_seconds"] = round(
                                frames * spf / rate, 3)
                            return out
                out["duration_seconds"] = round(
                    (size - base - pos) * 8 / (kbps * 1000),
                    3)  # CBR estimate
                return out
        pos += 1
    return None


def _last_ogg_granule(data: bytes) -> Optional[int]:
    """Granule of the last structurally-plausible page: 'OggS' capture
    + version 0 + sane header-type bits + granule ≥ 0 (a -1 granule or
    a chance 'OggS' inside packet data is skipped)."""
    at = len(data)
    while True:
        at = data.rfind(b"OggS", 0, at)
        if at < 0:
            return None
        if (len(data) >= at + 27 and data[at + 4] == 0
                and data[at + 5] <= 0x07):
            granule = struct.unpack("<q", data[at + 6:at + 14])[0]
            if granule >= 0:
                return granule
        if at == 0:
            return None


def parse_ogg(path: str) -> Optional[Dict]:
    with open(path, "rb") as f:
        head = f.read(4096)
        if head[:4] != b"OggS":
            return None
        f.seek(max(0, os.path.getsize(path) - 65536))
        tail = f.read()
    granule = _last_ogg_granule(tail)
    at = head.find(b"\x01vorbis")
    if at >= 0 and len(head) >= at + 16:
        channels = head[at + 11]
        rate = struct.unpack("<I", head[at + 12:at + 16])[0]
        out = {"format_name": "ogg", "audio_codec": "vorbis",
               "channels": channels, "sample_rate": rate}
        if granule and rate:
            out["duration_seconds"] = round(granule / rate, 3)
        return out
    at = head.find(b"OpusHead")
    if at >= 0 and len(head) >= at + 10:
        channels = head[at + 9]
        out = {"format_name": "ogg", "audio_codec": "opus",
               "channels": channels, "sample_rate": 48000}
        if granule:
            out["duration_seconds"] = round(granule / 48000, 3)
        return out
    return None


def parse_avi(path: str) -> Optional[Dict]:
    """AVI main header → video dimensions/fps/duration; codec fourcc
    from the first stream header."""
    from .mjpeg import _walk_chunks

    out: Dict = {"format_name": "avi"}
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"AVI ":
            return None
        f.seek(0, os.SEEK_END)
        end = f.tell()
        for cc, p, size in list(_walk_chunks(f, 12, end)):
            if cc != b"LIST":
                continue
            f.seek(p)
            if f.read(4) != b"hdrl":
                continue
            for c2, p2, s2 in list(_walk_chunks(f, p + 4, p + size)):
                if c2 == b"avih" and s2 >= 40:
                    f.seek(p2)
                    v = struct.unpack("<10I", f.read(40))
                    us_per_frame, _, _, _, frames = v[:5]
                    out["width"], out["height"] = v[8], v[9]
                    if us_per_frame:
                        out["fps"] = round(1e6 / us_per_frame, 3)
                        out["duration_seconds"] = round(
                            frames * us_per_frame / 1e6, 3)
                elif c2 == b"LIST":
                    f.seek(p2)
                    if f.read(4) == b"strl":
                        for c3, p3, s3 in list(_walk_chunks(
                                f, p2 + 4, p2 + s2)):
                            if c3 == b"strh" and s3 >= 8:
                                f.seek(p3)
                                kind = f.read(4)
                                codec = f.read(4)
                                if kind == b"vids":
                                    out["video_codec"] = codec.decode(
                                        "ascii", "replace").strip()
                            break
    return out if len(out) > 1 else None


def _parse_mp4(path: str) -> Optional[Dict]:
    from .mp4meta import parse_mp4

    return parse_mp4(path)


def _parse_mkv(path: str) -> Optional[Dict]:
    from .mkv import parse_mkv

    return parse_mkv(path)


_PARSERS = {
    "wav": parse_wav, "wave": parse_wav,
    "flac": parse_flac,
    "mp3": parse_mp3,
    "ogg": parse_ogg, "oga": parse_ogg, "opus": parse_ogg,
    "avi": parse_avi,
    # ISO-BMFF family (media/mp4meta.py) + Matroska (media/mkv.py):
    # the formats that actually hold most of the world's video.
    "mp4": _parse_mp4, "m4v": _parse_mp4, "mov": _parse_mp4,
    "m4a": _parse_mp4, "3gp": _parse_mp4,
    "mkv": _parse_mkv, "webm": _parse_mkv,
}


def parse_stream_info(path: str) -> Optional[Dict]:
    """Self-hosted container probe by extension — WAV/FLAC/MP3/OGG/
    Opus/AVI here, MP4/MOV/M4A/3GP via media/mp4meta.py, MKV/WebM via
    media/mkv.py; None when the container is unreadable."""
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    parser = _PARSERS.get(ext)
    if parser is None:
        return None
    try:
        return parser(path)
    except (OSError, struct.error, ValueError, IndexError):
        # IndexError: corrupt containers with truncated boxes/elements
        return None
