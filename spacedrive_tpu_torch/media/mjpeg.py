"""Minimal MJPEG-AVI container support, pure Python.

Port of ``spacedrive_tpu/media/mjpeg.py``. Motion-JPEG needs no codec —
every frame is a complete JPEG — so parsing the RIFF/AVI container is
enough to hand the port's JPEG decoder a frame: MJPEG `.avi` is the
self-hosted video format, the thumbnailer runs for it with the
seek-10% frame semantics, and everything else goes on down the chain of
media/video.py.

The writer emits a minimal-but-valid AVI (hdrl with avih + one video
strl, movi with 00dc chunks, idx1 index) so tests and corpus generators
can synthesize real files. It takes JPEG bytes; the JAX writer's branch
that encodes images needs a JPEG encoder the port does not have.
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional, Tuple

JPEG_SOI = b"\xff\xd8"


def _walk_chunks(f, start: int, end: int):
    """Yield (fourcc, payload_start, payload_size) reading only the
    8-byte headers — payloads are seeked over, never loaded, so a
    multi-GB camera AVI indexes in O(frame count) memory."""
    pos = start
    while pos + 8 <= end:
        f.seek(pos)
        header = f.read(8)
        if len(header) < 8:
            return
        fourcc = header[:4]
        (size,) = struct.unpack("<I", header[4:8])
        yield fourcc, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def index_frames(path: str) -> List[Tuple[int, int]]:
    """(offset, size) of every video frame chunk in stream order.

    Walks RIFF → LIST 'movi' → '..dc'/'..db' chunk headers.
    """
    frames: List[Tuple[int, int]] = []
    with open(path, "rb") as f:
        head = f.read(12)
        if len(head) < 12 or head[0:4] != b"RIFF" or head[8:12] != b"AVI ":
            raise ValueError(f"{path}: not a RIFF/AVI file")
        f.seek(0, os.SEEK_END)
        file_end = f.tell()
        for fourcc, p, size in list(_walk_chunks(f, 12, file_end)):
            if fourcc != b"LIST":
                continue
            f.seek(p)
            if f.read(4) != b"movi":
                continue
            for cc, fp, fsize in _walk_chunks(f, p + 4,
                                              min(p + size, file_end)):
                if cc[2:4] in (b"dc", b"db") and fsize > 0:
                    frames.append((fp, fsize))
    return frames


def frame_at_fraction(path: str, fraction: float = 0.10
                      ) -> Optional[bytes]:
    """The JPEG bytes of the frame nearest `fraction` through the stream
    (thumbnailer.rs seeks 10%), or None when the file holds no JPEG
    frames (non-MJPEG AVIs)."""
    frames = index_frames(path)
    if not frames:
        return None
    off, size = frames[min(int(len(frames) * fraction),
                           len(frames) - 1)]
    with open(path, "rb") as f:
        f.seek(off)
        payload = f.read(size)
    return payload if payload.startswith(JPEG_SOI) else None


def write_mjpeg_avi(path: str, frames: List[bytes], fps: int = 10) -> str:
    """Write JPEG frames (bytes) as an MJPEG AVI; the frame size is the
    first frame's."""
    from .imgdecode import decode_image

    jpegs = list(frames)
    if not jpegs:
        raise ValueError("no frames")
    height, width = decode_image(jpegs[0])[0].shape[:2]

    def chunk(fourcc: bytes, payload: bytes) -> bytes:
        pad = b"\x00" if len(payload) & 1 else b""
        return fourcc + struct.pack("<I", len(payload)) + payload + pad

    def lst(four: bytes, payload: bytes) -> bytes:
        return chunk(b"LIST", four + payload)

    us_per_frame = 1_000_000 // fps
    max_bytes = max(len(j) for j in jpegs)
    avih = struct.pack(
        "<14I", us_per_frame, max_bytes * fps, 0, 0x10,  # HASINDEX
        len(jpegs), 0, 1, max_bytes, width, height, 0, 0, 0, 0)
    # AVISTREAMHEADER: flags, prio/lang, initialFrames, scale, rate,
    # start, length, bufSize, quality, sampleSize, then rcFrame (56 B).
    strh = (b"vids" + b"MJPG" + struct.pack(
        "<IHHIIIIIIII", 0, 0, 0, 0, 1, fps, 0, len(jpegs),
        max_bytes, 0xFFFFFFFF, 0) + struct.pack("<4H", 0, 0,
                                                width, height))
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24,
                       b"MJPG", width * height * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_body = b"movi"
    index_entries = []
    for j in jpegs:
        # idx1 ckOffset: the chunk header's offset from the 'movi' fourcc
        index_entries.append((len(movi_body), len(j)))
        movi_body += chunk(b"00dc", j)
    movi = chunk(b"LIST", movi_body)
    idx1 = b"".join(
        b"00dc" + struct.pack("<III", 0x10, off, size)
        for off, size in index_entries)
    body = b"AVI " + hdrl + movi + chunk(b"idx1", idx1)
    # Synthesized sample media for tests/benches at a caller-chosen
    # path — corpus content, not durable node state.
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(body)) + body)
    return os.path.abspath(path)
