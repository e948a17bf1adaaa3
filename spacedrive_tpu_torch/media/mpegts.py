"""MPEG-TS demux for video thumbnails — feeds the H.264 decoder.

Port of ``spacedrive_tpu/media/mpegts.py``, a copy. Camcorders and
broadcast rips ship H.264 in MPEG transport streams (.ts/.mts/.m2ts); the
container is walked directly: 188-byte packets (192 with the BDAV/M2TS
4-byte timestamp prefix), PAT → PMT → the AVC elementary stream
(stream_type 0x1B), PES payloads re-assembled into Annex-B and handed to
media/h264.py. Seek-to-fraction = start scanning packets at that byte
offset (TS is designed for mid-stream joins: SPS/PPS repeat before every
IDR) and decode the first complete IDR picture found.

Structure-only parsing, bounded reads (SCAN_CAP per attempt).
"""

from __future__ import annotations

import os
import struct
from typing import List, Optional

TS_PACKET = 188
SCAN_CAP = 48 << 20       # max bytes examined per scan attempt
_H264_STREAM_TYPE = 0x1B


def _packet_size(head: bytes) -> Optional[int]:
    """188 (plain) or 192 (M2TS: 4-byte TP_extra before sync)."""
    if len(head) < 384:
        return None
    if head[0] == 0x47 and head[TS_PACKET] == 0x47:
        return TS_PACKET
    if len(head) >= 2 * 192 and head[4] == 0x47 and head[196] == 0x47:
        return 192
    return None


def _iter_packets(data: bytes, psize: int, start: int = 0):
    """Yield (pid, payload_unit_start, payload_bytes)."""
    skew = psize - TS_PACKET  # 4 for m2ts
    pos = start
    n = len(data)
    while pos + psize <= n:
        p = pos + skew
        if data[p] != 0x47:  # resync
            pos += 1
            continue
        b1, b2, b3 = data[p + 1], data[p + 2], data[p + 3]
        pid = ((b1 & 0x1F) << 8) | b2
        pusi = bool(b1 & 0x40)
        afc = (b3 >> 4) & 3
        off = p + 4
        if afc in (2, 3):  # adaptation field
            af_len = data[off]
            off += 1 + af_len
        if afc in (1, 3) and off < p + TS_PACKET + 0:
            yield pid, pusi, data[off:p + 4 + TS_PACKET - 4]
        pos += psize


def _parse_psi(payload: bytes) -> Optional[bytes]:
    """Pointer-field-skipped PSI section body, or None."""
    if not payload:
        return None
    ptr = payload[0]
    body = payload[1 + ptr:]
    return body if len(body) > 8 else None


def _find_h264_pid(data: bytes, psize: int) -> Optional[int]:
    """PAT (PID 0) → first program's PMT → first 0x1B stream PID."""
    pmt_pids: List[int] = []
    for pid, pusi, payload in _iter_packets(data, psize):
        if pid == 0 and pusi:
            body = _parse_psi(payload)
            if body is None or body[0] != 0x00:  # PAT table_id
                continue
            sec_len = ((body[1] & 0x0F) << 8) | body[2]
            p = 8
            end = min(3 + sec_len - 4, len(body))
            while p + 4 <= end:
                prog = (body[p] << 8) | body[p + 1]
                entry_pid = ((body[p + 2] & 0x1F) << 8) | body[p + 3]
                if prog != 0:
                    pmt_pids.append(entry_pid)
                p += 4
            break
    for pid, pusi, payload in _iter_packets(data, psize):
        if pid in pmt_pids and pusi:
            body = _parse_psi(payload)
            if body is None or body[0] != 0x02 or len(body) < 12:
                continue
            sec_len = ((body[1] & 0x0F) << 8) | body[2]
            pinfo_len = ((body[10] & 0x0F) << 8) | body[11]
            p = 12 + pinfo_len
            end = min(3 + sec_len - 4, len(body))
            while p + 5 <= end:
                stype = body[p]
                spid = ((body[p + 1] & 0x1F) << 8) | body[p + 2]
                es_len = ((body[p + 3] & 0x0F) << 8) | body[p + 4]
                if stype == _H264_STREAM_TYPE:
                    return spid
                p += 5 + es_len
            break
    return None


def _strip_pes_header(payload: bytes) -> Optional[bytes]:
    if len(payload) < 9 or payload[:3] != b"\x00\x00\x01":
        return None
    hdr_len = payload[8]
    return payload[9 + hdr_len:]


def extract_annexb(path: str, fraction: float = 0.10
                   ) -> Optional[bytes]:
    """Annex-B byte stream around `fraction` of the file: the video
    PID's PES payloads from the first unit-start after the seek point,
    capped at SCAN_CAP. Returns None for non-TS / non-H.264 files."""
    size = os.path.getsize(path)
    if size < 2 * TS_PACKET:
        return None
    with open(path, "rb") as f:
        head = f.read(512)
        psize = _packet_size(head)
        if psize is None:
            return None
        # PAT/PMT from the head of the file
        f.seek(0)
        lead = f.read(min(size, 4 << 20))
        try:
            vpid = _find_h264_pid(lead, psize)
        except (IndexError, struct.error):
            return None  # 0x47-looking garbage; honor the None contract
        if vpid is None:
            return None
        start = int(size * fraction)
        start -= start % psize
        f.seek(start)
        data = f.read(min(size - start, SCAN_CAP))
    out: List[bytes] = []
    started = False
    units_started = 0
    for pid, pusi, payload in _iter_packets(data, psize):
        if pid != vpid:
            continue
        if pusi:
            units_started += 1
            # collect a handful of access units: SPS/PPS repeat ahead
            # of the IDR, and a couple of extra units guarantee the
            # IDR's slices are complete before we stop
            if units_started > 12 and started:
                break
            body = _strip_pes_header(payload)
            if body is None:
                continue
            started = True
            out.append(body)
        elif started:
            out.append(payload)
    return b"".join(out) if out else None


def keyframe_from_ts(path: str, fraction: float = 0.10):
    """Decode the IDR picture nearest `fraction` → (Y, Cb, Cr) or None.

    Retries from the file head when the mid-stream window lacked an
    IDR (short clips)."""
    from . import h264 as D

    for frac in (fraction, 0.0):
        stream = extract_annexb(path, frac)
        if stream is None:
            continue
        try:
            return D.decode_annexb_iframe(stream)
        except D.H264Error:
            continue
    return None
