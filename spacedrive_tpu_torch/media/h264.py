"""Self-hosted H.264 baseline I-frame decoder (CAVLC, 4:2:0).

Port of ``spacedrive_tpu/media/h264.py``, a copy: numpy on the host, as
in the JAX package. A video thumbnail needs one frame; the dominant
real-world codec gets a from-spec decoder for exactly the slice of the
standard a thumbnail needs:

- baseline profile I/IDR pictures: I_4x4, I_16x16 and I_PCM macroblocks
  with all intra prediction modes (ITU-T H.264 §8.3),
- CAVLC entropy decoding (§9.2) with the full coeff_token /
  total_zeros / run_before tables,
- dequantisation + the 4x4 integer inverse transform, the 4x4 luma-DC
  Hadamard and the 2x2 chroma-DC transform (§8.5),
- multi-slice pictures (first_mb_in_slice resumes the raster walk).

Out of scope, by design: P/B slices, CABAC, high-profile 8x8 transforms,
MBAFF/fields, and the in-loop deblocking filter (§8.7) — skipping
deblock changes pixels slightly vs a full decoder but is visually
irrelevant at thumbnail scale; the fixtures are encoded with deblocking
disabled, where decode is bit-exact.

Decoding is deterministic: tests/test_torch_video.py holds the planes to
the committed fixtures' ground truth (tests/fixtures/h264/*.truth.npz)
and to the JAX decoder.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional, Tuple

import numpy as np


class H264Error(ValueError):
    pass


class Unsupported(H264Error):
    """Stream uses features outside the baseline-I subset (CABAC,
    P-slices, 4:2:2...). Callers fall back to cover art."""


# ---------------------------------------------------------------------------
# bit reading
# ---------------------------------------------------------------------------

def unescape(nal: bytes) -> bytes:
    """NAL → RBSP: strip emulation_prevention_three_bytes (§7.4.1)."""
    if b"\x00\x00\x03" not in nal:
        return nal
    out = bytearray()
    i, n = 0, len(nal)
    while i < n:
        if i + 2 < n and nal[i] == 0 and nal[i + 1] == 0 and nal[i + 2] == 3:
            out += b"\x00\x00"
            i += 3
        else:
            out.append(nal[i])
            i += 1
    return bytes(out)


class BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position
        self.n = len(data) * 8

    def u(self, bits: int) -> int:
        p, v = self.pos, 0
        if p + bits > self.n:
            raise H264Error("bitstream overrun")
        d = self.data
        for _ in range(bits):
            v = (v << 1) | ((d[p >> 3] >> (7 - (p & 7))) & 1)
            p += 1
        self.pos = p
        return v

    def flag(self) -> int:
        p = self.pos
        if p >= self.n:
            raise H264Error("bitstream overrun")
        self.pos = p + 1
        return (self.data[p >> 3] >> (7 - (p & 7))) & 1

    def ue(self) -> int:
        zeros = 0
        while not self.flag():
            zeros += 1
            if zeros > 32:
                raise H264Error("bad exp-golomb")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) >> 1 if k & 1 else -(k >> 1)

    def byte_align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def more_rbsp_data(self) -> bool:
        """§7.2: data remains iff bits exist past the rbsp_stop_bit."""
        if self.pos >= self.n:
            return False
        # find last set bit in stream (the stop bit)
        last = self.n - 1
        d = self.data
        while last >= 0 and not (d[last >> 3] >> (7 - (last & 7))) & 1:
            last -= 1
        return self.pos < last


def split_annexb(stream: bytes) -> List[bytes]:
    """Split an Annex-B byte stream into NAL units (no start codes)."""
    nals, i, n = [], 0, len(stream)
    starts = []
    while i + 3 <= n:
        if stream[i] == 0 and stream[i + 1] == 0:
            if stream[i + 2] == 1:
                starts.append((i, i + 3))
                i += 3
                continue
            if i + 4 <= n and stream[i + 2] == 0 and stream[i + 3] == 1:
                starts.append((i, i + 4))
                i += 4
                continue
        i += 1
    for k, (s, body) in enumerate(starts):
        end = starts[k + 1][0] if k + 1 < len(starts) else n
        if body < end:
            nals.append(stream[body:end])
    return nals


# ---------------------------------------------------------------------------
# parameter sets (§7.3.2)
# ---------------------------------------------------------------------------

def parse_sps(rbsp: bytes) -> Dict:
    r = BitReader(rbsp)
    sps: Dict = {}
    sps["profile_idc"] = r.u(8)
    r.u(8)  # constraint flags + reserved
    sps["level_idc"] = r.u(8)
    sps["id"] = r.ue()
    if sps["profile_idc"] in (100, 110, 122, 244, 44, 83, 86, 118, 128):
        chroma = r.ue()
        sps["chroma_format_idc"] = chroma
        if chroma == 3:
            r.flag()
        r.ue()  # bit_depth_luma_minus8
        r.ue()  # bit_depth_chroma_minus8
        r.flag()  # qpprime_y_zero_transform_bypass
        if r.flag():  # seq_scaling_matrix_present
            raise Unsupported("scaling matrices")
        if chroma != 1:
            raise Unsupported(f"chroma_format_idc {chroma}")
    else:
        sps["chroma_format_idc"] = 1
    sps["log2_max_frame_num"] = r.ue() + 4
    poc = r.ue()
    sps["pic_order_cnt_type"] = poc
    if poc == 0:
        sps["log2_max_poc_lsb"] = r.ue() + 4
    elif poc == 1:
        r.flag()
        r.se()
        r.se()
        for _ in range(r.ue()):
            r.se()
    sps["max_num_ref_frames"] = r.ue()
    r.flag()  # gaps_in_frame_num_value_allowed
    sps["pic_width_in_mbs"] = r.ue() + 1
    sps["pic_height_in_map_units"] = r.ue() + 1
    sps["frame_mbs_only"] = r.flag()
    if not sps["frame_mbs_only"]:
        raise Unsupported("interlaced (fields/MBAFF)")
    r.flag()  # direct_8x8_inference
    sps["crop"] = (0, 0, 0, 0)
    if r.flag():  # frame_cropping
        sps["crop"] = (r.ue(), r.ue(), r.ue(), r.ue())  # l, r, t, b
    return sps


def parse_pps(rbsp: bytes) -> Dict:
    r = BitReader(rbsp)
    pps: Dict = {}
    pps["id"] = r.ue()
    pps["sps_id"] = r.ue()
    if r.flag():  # entropy_coding_mode
        raise Unsupported("CABAC")
    pps["bottom_field_pic_order"] = r.flag()
    if r.ue() != 0:  # num_slice_groups_minus1
        raise Unsupported("slice groups (FMO)")
    pps["num_ref_idx_l0"] = r.ue() + 1
    pps["num_ref_idx_l1"] = r.ue() + 1
    r.flag()  # weighted_pred
    r.u(2)  # weighted_bipred_idc
    pps["pic_init_qp"] = r.se() + 26
    r.se()  # pic_init_qs
    pps["chroma_qp_index_offset"] = r.se()
    pps["deblocking_filter_control_present"] = r.flag()
    pps["constrained_intra_pred"] = r.flag()
    pps["redundant_pic_cnt_present"] = r.flag()
    return pps


# ---------------------------------------------------------------------------
# CAVLC tables (§9.2). Each VLC is {bitstring: value}; bitstrings are
# matched incrementally, MSB first.
# ---------------------------------------------------------------------------

def _vlc(entries) -> Dict[str, Tuple[int, int]]:
    return {code: val for code, val in entries}


# coeff_token → (TotalCoeff, TrailingOnes), Table 9-5, by nC class.
_COEFF_TOKEN_0 = _vlc([  # 0 <= nC < 2
    ("1", (0, 0)),
    ("000101", (1, 0)), ("01", (1, 1)),
    ("00000111", (2, 0)), ("000100", (2, 1)), ("001", (2, 2)),
    ("000000111", (3, 0)), ("00000110", (3, 1)), ("0000101", (3, 2)),
    ("00011", (3, 3)),
    ("0000000111", (4, 0)), ("000000110", (4, 1)), ("00000101", (4, 2)),
    ("000011", (4, 3)),
    ("00000000111", (5, 0)), ("0000000110", (5, 1)), ("000000101", (5, 2)),
    ("0000100", (5, 3)),
    ("0000000001111", (6, 0)), ("00000000110", (6, 1)),
    ("0000000101", (6, 2)), ("00000100", (6, 3)),
    ("0000000001011", (7, 0)), ("0000000001110", (7, 1)),
    ("00000000101", (7, 2)), ("000000100", (7, 3)),
    ("0000000001000", (8, 0)), ("0000000001010", (8, 1)),
    ("0000000001101", (8, 2)), ("0000000100", (8, 3)),
    ("00000000001111", (9, 0)), ("00000000001110", (9, 1)),
    ("0000000001001", (9, 2)), ("00000000100", (9, 3)),
    ("00000000001011", (10, 0)), ("00000000001010", (10, 1)),
    ("00000000001101", (10, 2)), ("0000000001100", (10, 3)),
    ("000000000001111", (11, 0)), ("000000000001110", (11, 1)),
    ("00000000001001", (11, 2)), ("00000000001100", (11, 3)),
    ("000000000001011", (12, 0)), ("000000000001010", (12, 1)),
    ("000000000001101", (12, 2)), ("00000000001000", (12, 3)),
    ("0000000000001111", (13, 0)), ("000000000000001", (13, 1)),
    ("000000000001001", (13, 2)), ("000000000001100", (13, 3)),
    ("0000000000001011", (14, 0)), ("0000000000001110", (14, 1)),
    ("0000000000001101", (14, 2)), ("000000000001000", (14, 3)),
    ("0000000000000111", (15, 0)), ("0000000000001010", (15, 1)),
    ("0000000000001001", (15, 2)), ("0000000000001100", (15, 3)),
    ("0000000000000100", (16, 0)), ("0000000000000110", (16, 1)),
    ("0000000000000101", (16, 2)), ("0000000000001000", (16, 3)),
])

_COEFF_TOKEN_2 = _vlc([  # 2 <= nC < 4
    ("11", (0, 0)),
    ("001011", (1, 0)), ("10", (1, 1)),
    ("000111", (2, 0)), ("00111", (2, 1)), ("011", (2, 2)),
    ("0000111", (3, 0)), ("001010", (3, 1)), ("001001", (3, 2)),
    ("0101", (3, 3)),
    ("00000111", (4, 0)), ("000110", (4, 1)), ("000101", (4, 2)),
    ("0100", (4, 3)),
    ("00000100", (5, 0)), ("0000110", (5, 1)), ("0000101", (5, 2)),
    ("00110", (5, 3)),
    ("000000111", (6, 0)), ("00000110", (6, 1)), ("00000101", (6, 2)),
    ("001000", (6, 3)),
    ("00000001111", (7, 0)), ("000000110", (7, 1)), ("000000101", (7, 2)),
    ("000100", (7, 3)),
    ("00000001011", (8, 0)), ("00000001110", (8, 1)),
    ("00000001101", (8, 2)), ("0000100", (8, 3)),
    ("000000001111", (9, 0)), ("00000001010", (9, 1)),
    ("00000001001", (9, 2)), ("000000100", (9, 3)),
    ("000000001011", (10, 0)), ("000000001110", (10, 1)),
    ("000000001101", (10, 2)), ("00000001100", (10, 3)),
    ("000000001000", (11, 0)), ("000000001010", (11, 1)),
    ("000000001001", (11, 2)), ("00000001000", (11, 3)),
    ("0000000001111", (12, 0)), ("0000000001110", (12, 1)),
    ("0000000001101", (12, 2)), ("000000001100", (12, 3)),
    ("0000000001011", (13, 0)), ("0000000001010", (13, 1)),
    ("0000000001001", (13, 2)), ("0000000001100", (13, 3)),
    ("0000000000111", (14, 0)), ("00000000001011", (14, 1)),
    ("0000000000110", (14, 2)), ("0000000001000", (14, 3)),
    ("00000000001001", (15, 0)), ("00000000001000", (15, 1)),
    ("00000000001010", (15, 2)), ("0000000000001", (15, 3)),
    ("00000000000111", (16, 0)), ("00000000000110", (16, 1)),
    ("00000000000101", (16, 2)), ("00000000000100", (16, 3)),
])

_COEFF_TOKEN_4 = _vlc([  # 4 <= nC < 8
    ("1111", (0, 0)),
    ("001111", (1, 0)), ("1110", (1, 1)),
    ("001011", (2, 0)), ("01111", (2, 1)), ("1101", (2, 2)),
    ("001000", (3, 0)), ("01100", (3, 1)), ("01110", (3, 2)),
    ("1100", (3, 3)),
    ("0001111", (4, 0)), ("01010", (4, 1)), ("01011", (4, 2)),
    ("1011", (4, 3)),
    ("0001011", (5, 0)), ("01000", (5, 1)), ("01001", (5, 2)),
    ("1010", (5, 3)),
    ("0001001", (6, 0)), ("001110", (6, 1)), ("001101", (6, 2)),
    ("1001", (6, 3)),
    ("0001000", (7, 0)), ("001010", (7, 1)), ("001001", (7, 2)),
    ("1000", (7, 3)),
    ("00001111", (8, 0)), ("0001110", (8, 1)), ("0001101", (8, 2)),
    ("01101", (8, 3)),
    ("00001011", (9, 0)), ("00001110", (9, 1)), ("0001010", (9, 2)),
    ("001100", (9, 3)),
    ("000001111", (10, 0)), ("00001010", (10, 1)), ("00001101", (10, 2)),
    ("0001100", (10, 3)),
    ("000001011", (11, 0)), ("000001110", (11, 1)), ("00001001", (11, 2)),
    ("00001100", (11, 3)),
    ("000001000", (12, 0)), ("000001010", (12, 1)), ("000001101", (12, 2)),
    ("00001000", (12, 3)),
    ("0000001101", (13, 0)), ("000000111", (13, 1)), ("000001001", (13, 2)),
    ("000001100", (13, 3)),
    ("0000001001", (14, 0)), ("0000001100", (14, 1)), ("0000001011", (14, 2)),
    ("0000001010", (14, 3)),
    ("0000000101", (15, 0)), ("0000001000", (15, 1)), ("0000000111", (15, 2)),
    ("0000000110", (15, 3)),
    ("0000000001", (16, 0)), ("0000000100", (16, 1)), ("0000000011", (16, 2)),
    ("0000000010", (16, 3)),
])

_COEFF_TOKEN_CHROMA_DC = _vlc([  # nC == -1 (4:2:0 chroma DC)
    ("01", (0, 0)),
    ("000111", (1, 0)), ("1", (1, 1)),
    ("000100", (2, 0)), ("000110", (2, 1)), ("001", (2, 2)),
    ("000011", (3, 0)), ("0000011", (3, 1)), ("0000010", (3, 2)),
    ("000101", (3, 3)),
    ("000010", (4, 0)), ("00000011", (4, 1)), ("00000010", (4, 2)),
    ("0000000", (4, 3)),
])

# total_zeros, Table 9-7/9-8 (4x4 blocks), indexed by TotalCoeff 1..15.
_TOTAL_ZEROS_4x4 = {
    1: _vlc([("1", 0), ("011", 1), ("010", 2), ("0011", 3), ("0010", 4),
             ("00011", 5), ("00010", 6), ("000011", 7), ("000010", 8),
             ("0000011", 9), ("0000010", 10), ("00000011", 11),
             ("00000010", 12), ("000000011", 13), ("000000010", 14),
             ("000000001", 15)]),
    2: _vlc([("111", 0), ("110", 1), ("101", 2), ("100", 3), ("011", 4),
             ("0101", 5), ("0100", 6), ("0011", 7), ("0010", 8),
             ("00011", 9), ("00010", 10), ("000011", 11), ("000010", 12),
             ("000001", 13), ("000000", 14)]),
    3: _vlc([("0101", 0), ("111", 1), ("110", 2), ("101", 3), ("0100", 4),
             ("0011", 5), ("100", 6), ("011", 7), ("0010", 8),
             ("00011", 9), ("00010", 10), ("000001", 11), ("00001", 12),
             ("000000", 13)]),
    4: _vlc([("00011", 0), ("111", 1), ("0101", 2), ("0100", 3),
             ("110", 4), ("101", 5), ("100", 6), ("0011", 7), ("011", 8),
             ("0010", 9), ("00010", 10), ("00001", 11), ("00000", 12)]),
    5: _vlc([("0101", 0), ("0100", 1), ("0011", 2), ("111", 3),
             ("110", 4), ("101", 5), ("100", 6), ("011", 7), ("0010", 8),
             ("00001", 9), ("0001", 10), ("00000", 11)]),
    6: _vlc([("000001", 0), ("00001", 1), ("111", 2), ("110", 3),
             ("101", 4), ("100", 5), ("011", 6), ("010", 7), ("0001", 8),
             ("001", 9), ("000000", 10)]),
    7: _vlc([("000001", 0), ("00001", 1), ("101", 2), ("100", 3),
             ("011", 4), ("11", 5), ("010", 6), ("0001", 7), ("001", 8),
             ("000000", 9)]),
    8: _vlc([("000001", 0), ("0001", 1), ("00001", 2), ("011", 3),
             ("11", 4), ("10", 5), ("010", 6), ("001", 7), ("000000", 8)]),
    9: _vlc([("000001", 0), ("000000", 1), ("0001", 2), ("11", 3),
             ("10", 4), ("001", 5), ("01", 6), ("00001", 7)]),
    10: _vlc([("00001", 0), ("00000", 1), ("001", 2), ("11", 3),
              ("10", 4), ("01", 5), ("0001", 6)]),
    11: _vlc([("0000", 0), ("0001", 1), ("001", 2), ("010", 3), ("1", 4),
              ("011", 5)]),
    12: _vlc([("0000", 0), ("0001", 1), ("01", 2), ("1", 3), ("001", 4)]),
    13: _vlc([("000", 0), ("001", 1), ("1", 2), ("01", 3)]),
    14: _vlc([("00", 0), ("01", 1), ("1", 2)]),
    15: _vlc([("0", 0), ("1", 1)]),
}

# total_zeros for chroma DC (4:2:0), Table 9-9(a), TotalCoeff 1..3.
_TOTAL_ZEROS_CHROMA_DC = {
    1: _vlc([("1", 0), ("01", 1), ("001", 2), ("000", 3)]),
    2: _vlc([("1", 0), ("01", 1), ("00", 2)]),
    3: _vlc([("1", 0), ("0", 1)]),
}

# run_before, Table 9-10, indexed by min(zerosLeft, 7).
_RUN_BEFORE = {
    1: _vlc([("1", 0), ("0", 1)]),
    2: _vlc([("1", 0), ("01", 1), ("00", 2)]),
    3: _vlc([("11", 0), ("10", 1), ("01", 2), ("00", 3)]),
    4: _vlc([("11", 0), ("10", 1), ("01", 2), ("001", 3), ("000", 4)]),
    5: _vlc([("11", 0), ("10", 1), ("011", 2), ("010", 3), ("001", 4),
             ("000", 5)]),
    6: _vlc([("11", 0), ("000", 1), ("001", 2), ("011", 3), ("010", 4),
             ("101", 5), ("100", 6)]),
    7: _vlc([("111", 0), ("110", 1), ("101", 2), ("100", 3), ("011", 4),
             ("010", 5), ("001", 6), ("0001", 7), ("00001", 8),
             ("000001", 9), ("0000001", 10), ("00000001", 11),
             ("000000001", 12), ("0000000001", 13), ("00000000001", 14)]),
}


def _read_vlc(r: BitReader, table: Dict[str, object], what: str):
    code = ""
    for _ in range(20):
        code += "1" if r.flag() else "0"
        if code in table:
            return table[code]
    raise H264Error(f"bad {what} VLC: {code}")


# zig-zag scan for 4x4 blocks (Table 8-13), position → (row, col)
_ZIGZAG = [(0, 0), (0, 1), (1, 0), (2, 0), (1, 1), (0, 2), (0, 3), (1, 2),
           (2, 1), (3, 0), (3, 1), (2, 2), (1, 3), (2, 3), (3, 2), (3, 3)]

# dequant scale V (Table: normAdjust4x4 per qp%6 at the 3 position classes)
_DEQUANT_V = [
    (10, 16, 13), (11, 18, 14), (13, 20, 16),
    (14, 23, 18), (16, 25, 20), (18, 29, 23),
]
# position class per (row, col): 0 for (even,even), 1 for (odd,odd), 2 mixed
_POS_CLASS = [[(0 if (i % 2 == 0 and j % 2 == 0) else
               1 if (i % 2 == 1 and j % 2 == 1) else 2)
               for j in range(4)] for i in range(4)]

_CHROMA_QP_MAP = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                  17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 29, 30,
                  31, 32, 32, 33, 34, 34, 35, 35, 36, 36, 37, 37, 37, 38, 38,
                  38, 39, 39, 39, 39]

# coded_block_pattern mapping for Intra_4x4 (Table 9-4, codeNum → cbp)
_CBP_INTRA = [47, 31, 15, 0, 23, 27, 29, 30, 7, 11, 13, 14, 39, 43, 45, 46,
              16, 3, 5, 10, 12, 19, 21, 26, 28, 35, 37, 42, 44, 1, 2, 4, 8,
              17, 18, 20, 24, 6, 9, 22, 25, 32, 33, 34, 36, 40, 38, 41]


def residual_block_cavlc(r: BitReader, nC: int, max_coeffs: int
                         ) -> Tuple[List[int], int]:
    """§9.2: one CAVLC residual block → (coefficient levels in scan
    order, TotalCoeff)."""
    if nC == -1:
        table = _COEFF_TOKEN_CHROMA_DC
    elif nC < 2:
        table = _COEFF_TOKEN_0
    elif nC < 4:
        table = _COEFF_TOKEN_2
    elif nC < 8:
        table = _COEFF_TOKEN_4
    else:
        # nC >= 8: 6-bit FLC; 000011 means (0,0)
        v = r.u(6)
        total_coeff, trailing_ones = (0, 0) if v == 3 else \
            ((v >> 2) + 1, v & 3)
        return _cavlc_levels(r, total_coeff, trailing_ones, nC, max_coeffs)
    total_coeff, trailing_ones = _read_vlc(r, table, "coeff_token")
    return _cavlc_levels(r, total_coeff, trailing_ones, nC, max_coeffs)


def _cavlc_levels(r: BitReader, total_coeff: int, trailing_ones: int,
                  nC: int, max_coeffs: int) -> Tuple[List[int], int]:
    if total_coeff == 0:
        return [0] * max_coeffs, 0
    levels: List[int] = []
    for i in range(trailing_ones):
        levels.append(-1 if r.flag() else 1)
    suffix_len = 1 if (total_coeff > 10 and trailing_ones < 3) else 0
    for i in range(trailing_ones, total_coeff):
        # level_prefix: count of zeros before the 1
        prefix = 0
        while not r.flag():
            prefix += 1
            if prefix > 47:
                raise H264Error("bad level_prefix")
        if prefix == 14 and suffix_len == 0:
            suffix_size = 4
        elif prefix >= 15:
            suffix_size = prefix - 3
        else:
            suffix_size = suffix_len
        # levelCode per §9.2.2.1
        level_code = min(15, prefix) << suffix_len
        if prefix >= 15 and suffix_len == 0:
            level_code += 15
        if prefix >= 16:
            level_code += (1 << (prefix - 3)) - 4096
        if suffix_size:
            level_code += r.u(suffix_size)
        if i == trailing_ones and trailing_ones < 3:
            level_code += 2
        level = (level_code + 2) >> 1 if level_code % 2 == 0 else \
            -((level_code + 1) >> 1)
        levels.append(level)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1
    # total_zeros
    if total_coeff < max_coeffs:
        if nC == -1:
            tz_table = _TOTAL_ZEROS_CHROMA_DC[total_coeff]
        else:
            tz_table = _TOTAL_ZEROS_4x4[total_coeff]
        total_zeros = _read_vlc(r, tz_table, "total_zeros")
    else:
        total_zeros = 0
    # runs
    runs = []
    zeros_left = total_zeros
    for i in range(total_coeff - 1):
        if zeros_left > 0:
            run = _read_vlc(r, _RUN_BEFORE[min(zeros_left, 7)], "run_before")
        else:
            run = 0
        runs.append(run)
        zeros_left -= run
    runs.append(zeros_left)
    # place into scan order (levels are highest-freq first)
    out = [0] * max_coeffs
    pos = -1
    for i in range(total_coeff - 1, -1, -1):
        pos += runs[i] + 1
        if pos >= max_coeffs:
            raise H264Error("coefficient run overflow")
        out[pos] = levels[i]
    return out, total_coeff


# ---------------------------------------------------------------------------
# transforms (§8.5)
# ---------------------------------------------------------------------------

def idct4x4_add(pred: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    res = _idct_core(coeffs)
    return np.clip(pred.astype(np.int64) + ((res + 32) >> 6), 0, 255)


def _idct_core(c: np.ndarray) -> np.ndarray:
    """§8.5.12.2 order: each row horizontally, then each column."""
    d = c.astype(np.int64)
    e = np.empty((4, 4), np.int64)
    e[:, 0] = d[:, 0] + d[:, 2]
    e[:, 1] = d[:, 0] - d[:, 2]
    e[:, 2] = (d[:, 1] >> 1) - d[:, 3]
    e[:, 3] = d[:, 1] + (d[:, 3] >> 1)
    f = np.empty((4, 4), np.int64)
    f[:, 0] = e[:, 0] + e[:, 3]
    f[:, 1] = e[:, 1] + e[:, 2]
    f[:, 2] = e[:, 1] - e[:, 2]
    f[:, 3] = e[:, 0] - e[:, 3]
    g = np.empty((4, 4), np.int64)
    g[0, :] = f[0, :] + f[2, :]
    g[1, :] = f[0, :] - f[2, :]
    g[2, :] = (f[1, :] >> 1) - f[3, :]
    g[3, :] = f[1, :] + (f[3, :] >> 1)
    h = np.empty((4, 4), np.int64)
    h[0, :] = g[0, :] + g[3, :]
    h[1, :] = g[1, :] + g[2, :]
    h[2, :] = g[1, :] - g[2, :]
    h[3, :] = g[0, :] - g[3, :]
    return h


def dequant4x4(coeffs: List[int], qp: int, skip_dc: bool = False
               ) -> np.ndarray:
    """Scale AC (and optionally DC) levels per §8.5.12.1."""
    out = np.zeros((4, 4), np.int64)
    v = _DEQUANT_V[qp % 6]
    shift = qp // 6
    for idx, (i, j) in enumerate(_ZIGZAG):
        if skip_dc and idx == 0:
            continue
        lvl = coeffs[idx]
        if lvl:
            out[i, j] = (lvl * v[_POS_CLASS[i][j]]) << shift
    return out


def luma_dc_dequant(dc: np.ndarray, qp: int) -> np.ndarray:
    """4x4 luma DC: inverse Hadamard then scale (§8.5.10). LevelScale
    here is weightScale(16, flat default) × normAdjust."""
    h = np.array([[1, 1, 1, 1], [1, 1, -1, -1],
                  [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)
    f = h @ dc.astype(np.int64) @ h
    ls = _DEQUANT_V[qp % 6][0] * 16
    if qp >= 36:
        return (f * ls) << (qp // 6 - 6)
    return (f * ls + (1 << (5 - qp // 6))) >> (6 - qp // 6)


def chroma_dc_dequant(dc: np.ndarray, qp: int) -> np.ndarray:
    """2x2 chroma DC transform + scale (§8.5.11), LevelScale = 16 ×
    normAdjust as above."""
    f = np.array([[dc[0, 0] + dc[0, 1] + dc[1, 0] + dc[1, 1],
                   dc[0, 0] - dc[0, 1] + dc[1, 0] - dc[1, 1]],
                  [dc[0, 0] + dc[0, 1] - dc[1, 0] - dc[1, 1],
                   dc[0, 0] - dc[0, 1] - dc[1, 0] + dc[1, 1]]], np.int64)
    ls = _DEQUANT_V[qp % 6][0] * 16
    return ((f * ls) << (qp // 6)) >> 5


# ---------------------------------------------------------------------------
# intra prediction (§8.3)
# ---------------------------------------------------------------------------

def _pred4x4(mode: int, top: Optional[np.ndarray], left: Optional[np.ndarray],
             topleft: Optional[int], topright: Optional[np.ndarray]
             ) -> np.ndarray:
    """9 intra 4x4 modes. top/topright are length-4 arrays (int64),
    left length-4, topleft scalar; None = unavailable."""
    p = np.empty((4, 4), np.int64)
    if mode == 0:  # vertical
        if top is None:
            raise H264Error("pred4x4 V without top")
        p[:] = top
        return p
    if mode == 1:  # horizontal
        if left is None:
            raise H264Error("pred4x4 H without left")
        p[:] = left[:, None]
        return p
    if mode == 2:  # DC
        if top is not None and left is not None:
            dc = (int(top.sum() + left.sum()) + 4) >> 3
        elif top is not None:
            dc = (int(top.sum()) + 2) >> 2
        elif left is not None:
            dc = (int(left.sum()) + 2) >> 2
        else:
            dc = 128
        p[:] = dc
        return p
    # diagonal modes need the 8-sample top row (top + topright)
    if mode in (3, 7):
        if top is None:
            raise H264Error("pred4x4 diag without top")
        if topright is None:
            tr = np.full(4, top[3], np.int64)
        else:
            tr = topright
        t = np.concatenate([top, tr])
    if mode == 3:  # diagonal down-left
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    p[y, x] = (t[x + y] + 2 * t[x + y + 1]
                               + t[x + y + 2] + 2) >> 2
        return p
    if mode == 7:  # vertical-left
        for y in range(4):
            for x in range(4):
                i = x + (y >> 1)
                if y % 2 == 0:
                    p[y, x] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    p[y, x] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return p
    if mode == 8:  # horizontal-up: left samples only
        if left is None:
            raise H264Error("pred4x4 HU without left")
        la = left
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z < 5:
                    i = y + (x >> 1)
                    if z % 2 == 0:
                        p[y, x] = (la[i] + la[i + 1] + 1) >> 1
                    else:
                        p[y, x] = (la[i] + 2 * la[i + 1] + la[i + 2] + 2) >> 2
                elif z == 5:
                    p[y, x] = (la[2] + 3 * la[3] + 2) >> 2
                else:
                    p[y, x] = la[3]
        return p
    # remaining modes (4, 5, 6) need top+left+topleft
    if top is None or left is None or topleft is None:
        raise H264Error("pred4x4 mode needs full neighborhood")
    tl = int(topleft)
    if mode == 4:  # diagonal down-right
        # ref[] = the 9 border samples left-bottom → topleft → top-right
        # (ref[0]=left[3] .. ref[3]=left[0], ref[4]=topleft, ref[5..8]=top)
        ref = np.empty(9, np.int64)
        ref[0:4] = left[::-1]      # ref[0]=left[3] ... ref[3]=left[0]
        ref[4] = tl
        ref[5:9] = top
        for y in range(4):
            for x in range(4):
                k = 4 + x - y
                p[y, x] = (ref[k - 1] + 2 * ref[k] + ref[k + 1] + 2) >> 2
        return p
    if mode == 5:  # vertical-right
        ref = np.empty(9, np.int64)
        ref[0:4] = left[::-1]
        ref[4] = tl
        ref[5:9] = top
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                k = 4 + x - (y >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (ref[k] + ref[k + 1] + 1) >> 1
                elif z >= 0:
                    p[y, x] = (ref[k - 1] + 2 * ref[k] + ref[k + 1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (ref[3] + 2 * ref[4] + ref[5] + 2) >> 2
                else:  # z <= -2: down the left column (x=0, y=2..3)
                    p[y, x] = (left[y - 1] + 2 * left[y - 2] +
                               (left[y - 3] if y >= 3 else tl) + 2) >> 2
        return p
    if mode == 6:  # horizontal-down
        ref = np.empty(9, np.int64)
        ref[0:4] = left[::-1]
        ref[4] = tl
        ref[5:9] = top
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                k = 4 - y + (x >> 1)
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (ref[k] + ref[k - 1] + 1) >> 1
                elif z >= 0:
                    p[y, x] = (ref[k + 1] + 2 * ref[k] + ref[k - 1] + 2) >> 2
                elif z == -1:
                    p[y, x] = (ref[3] + 2 * ref[4] + ref[5] + 2) >> 2
                else:  # z <= -2: along the top row (y=0, x=2..3)
                    p[y, x] = (top[x - 1] + 2 * top[x - 2] +
                               (top[x - 3] if x >= 3 else tl) + 2) >> 2
        return p
    raise H264Error(f"intra4x4 mode {mode}")


def _pred16x16(mode: int, top: Optional[np.ndarray],
               left: Optional[np.ndarray], topleft: Optional[int]
               ) -> np.ndarray:
    p = np.empty((16, 16), np.int64)
    if mode == 0:  # vertical
        if top is None:
            raise H264Error("pred16 V without top")
        p[:] = top
    elif mode == 1:  # horizontal
        if left is None:
            raise H264Error("pred16 H without left")
        p[:] = left[:, None]
    elif mode == 2:  # DC
        if top is not None and left is not None:
            dc = (int(top.sum() + left.sum()) + 16) >> 5
        elif top is not None:
            dc = (int(top.sum()) + 8) >> 4
        elif left is not None:
            dc = (int(left.sum()) + 8) >> 4
        else:
            dc = 128
        p[:] = dc
    elif mode == 3:  # plane
        if top is None or left is None or topleft is None:
            raise H264Error("pred16 plane needs full neighborhood")
        tl = int(topleft)
        h = sum((x + 1) * (int(top[8 + x]) -
                           (int(top[6 - x]) if 6 - x >= 0 else tl))
                for x in range(8))
        v = sum((y + 1) * (int(left[8 + y]) -
                           (int(left[6 - y]) if 6 - y >= 0 else tl))
                for y in range(8))
        b = (5 * h + 32) >> 6
        c = (5 * v + 32) >> 6
        a = 16 * (int(left[15]) + int(top[15]))
        for y in range(16):
            for x in range(16):
                p[y, x] = np.clip((a + b * (x - 7) + c * (y - 7) + 16) >> 5,
                                  0, 255)
    else:
        raise H264Error(f"intra16x16 mode {mode}")
    return p


def _pred_chroma(mode: int, top: Optional[np.ndarray],
                 left: Optional[np.ndarray], topleft: Optional[int]
                 ) -> np.ndarray:
    p = np.empty((8, 8), np.int64)
    if mode == 0:  # DC, per 4x4 quadrant (§8.3.4.1)
        for qy in (0, 4):
            for qx in (0, 4):
                t = top[qx:qx + 4] if top is not None else None
                l = left[qy:qy + 4] if left is not None else None
                # corner quadrants prefer the adjacent edge
                if qx == 0 and qy == 0 or qx == 4 and qy == 4:
                    if t is not None and l is not None:
                        dc = (int(t.sum() + l.sum()) + 4) >> 3
                    elif t is not None:
                        dc = (int(t.sum()) + 2) >> 2
                    elif l is not None:
                        dc = (int(l.sum()) + 2) >> 2
                    else:
                        dc = 128
                elif qx == 4 and qy == 0:
                    if t is not None:
                        dc = (int(t.sum()) + 2) >> 2
                    elif l is not None:
                        dc = (int(l.sum()) + 2) >> 2
                    else:
                        dc = 128
                else:  # qx == 0, qy == 4
                    if l is not None:
                        dc = (int(l.sum()) + 2) >> 2
                    elif t is not None:
                        dc = (int(t.sum()) + 2) >> 2
                    else:
                        dc = 128
                p[qy:qy + 4, qx:qx + 4] = dc
    elif mode == 1:  # horizontal
        if left is None:
            raise H264Error("chroma H without left")
        p[:] = left[:, None]
    elif mode == 2:  # vertical
        if top is None:
            raise H264Error("chroma V without top")
        p[:] = top
    elif mode == 3:  # plane
        if top is None or left is None or topleft is None:
            raise H264Error("chroma plane needs full neighborhood")
        tl = int(topleft)
        h = sum((x + 1) * (int(top[4 + x]) -
                           (int(top[2 - x]) if 2 - x >= 0 else tl))
                for x in range(4))
        v = sum((y + 1) * (int(left[4 + y]) -
                           (int(left[2 - y]) if 2 - y >= 0 else tl))
                for y in range(4))
        b = (17 * h + 16) >> 5
        c = (17 * v + 16) >> 5
        a = 16 * (int(left[7]) + int(top[7]))
        for y in range(8):
            for x in range(8):
                p[y, x] = np.clip((a + b * (x - 3) + c * (y - 3) + 16) >> 5,
                                  0, 255)
    else:
        raise H264Error(f"chroma mode {mode}")
    return p


# I_16x16 mb_type decomposition (Table 7-11): mb_type 1..24
def _i16_info(mb_type: int) -> Tuple[int, int, int]:
    """→ (pred_mode, cbp_chroma, cbp_luma) for I_16x16 mb_type."""
    m = mb_type - 1
    pred = m % 4
    m //= 4
    cbp_chroma = m % 3
    cbp_luma = 15 if m >= 3 else 0
    return pred, cbp_chroma, cbp_luma


# raster order of the 16 4x4 luma blocks within an MB (§6.4.3 inverse
# 4x4 scan: the standard "zig" ordering of blocks)
_BLK4_ORDER = [(0, 0), (0, 1), (1, 0), (1, 1), (0, 2), (0, 3), (1, 2), (1, 3),
               (2, 0), (2, 1), (3, 0), (3, 1), (2, 2), (2, 3), (3, 2), (3, 3)]


class _Frame:
    """Decode state: planes plus per-4x4-block CAVLC nC bookkeeping."""

    def __init__(self, w_mbs: int, h_mbs: int):
        self.w_mbs, self.h_mbs = w_mbs, h_mbs
        self.Y = np.zeros((h_mbs * 16, w_mbs * 16), np.int64)
        self.Cb = np.zeros((h_mbs * 8, w_mbs * 8), np.int64)
        self.Cr = np.zeros((h_mbs * 8, w_mbs * 8), np.int64)
        # total_coeff per 4x4 block, -1 = not yet decoded
        self.nzY = np.full((h_mbs * 4, w_mbs * 4), -1, np.int16)
        self.nzCb = np.full((h_mbs * 2, w_mbs * 2), -1, np.int16)
        self.nzCr = np.full((h_mbs * 2, w_mbs * 2), -1, np.int16)
        # intra4x4 pred mode per 4x4 block (-1 = unavailable/not intra4x4)
        self.i4mode = np.full((h_mbs * 4, w_mbs * 4), -1, np.int16)
        self.decoded = np.zeros((h_mbs, w_mbs), bool)
        # slice index per MB: neighbors in a DIFFERENT slice are
        # unavailable for intra prediction and CAVLC nC (§6.4.8)
        self.slice_id = np.full((h_mbs, w_mbs), -1, np.int32)

    def same_slice(self, mby: int, mbx: int, sid: int) -> bool:
        return (0 <= mby < self.h_mbs and 0 <= mbx < self.w_mbs
                and self.slice_id[mby, mbx] == sid)


def _nC(nz: np.ndarray, by: int, bx: int, frame: _Frame, sid: int,
        mb_shift: int) -> int:
    """CAVLC nC from left (A) and top (B) block totals (§9.2.1);
    neighbors outside the current slice are unavailable. `mb_shift`
    maps block coords to MB coords (2 for luma 4x4s, 1 for chroma)."""
    nA = nB = None
    if bx > 0 and nz[by, bx - 1] >= 0 and \
            frame.same_slice(by >> mb_shift, (bx - 1) >> mb_shift, sid):
        nA = int(nz[by, bx - 1])
    if by > 0 and nz[by - 1, bx] >= 0 and \
            frame.same_slice((by - 1) >> mb_shift, bx >> mb_shift, sid):
        nB = int(nz[by - 1, bx])
    if nA is not None and nB is not None:
        return (nA + nB + 1) >> 1
    if nA is not None:
        return nA
    if nB is not None:
        return nB
    return 0


def decode_picture(sps: Dict, pps: Dict, slices: List[bytes]
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode one I/IDR picture from its slice NALs → (Y, Cb, Cr)
    uint8 planes, cropped per SPS."""
    w_mbs = sps["pic_width_in_mbs"]
    h_mbs = sps["pic_height_in_map_units"]
    frame = _Frame(w_mbs, h_mbs)
    for sid, nal in enumerate(slices):
        _decode_slice(sps, pps, unescape(nal[1:]), nal[0] & 0x1F, frame, sid)
    if not frame.decoded.all():
        raise H264Error("picture incomplete: missing macroblocks")
    Y = frame.Y.astype(np.uint8)
    Cb = frame.Cb.astype(np.uint8)
    Cr = frame.Cr.astype(np.uint8)
    cl, cr, ct, cb = sps["crop"]
    H, W = Y.shape
    Y = Y[2 * ct:H - 2 * cb or None, 2 * cl:W - 2 * cr or None]
    Cb = Cb[ct:(H // 2) - cb or None, cl:(W // 2) - cr or None]
    Cr = Cr[ct:(H // 2) - cb or None, cl:(W // 2) - cr or None]
    return Y, Cb, Cr


def _decode_slice(sps: Dict, pps: Dict, rbsp: bytes, nal_type: int,
                  frame: _Frame, sid: int = 0) -> None:
    r = BitReader(rbsp)
    first_mb = r.ue()
    slice_type = r.ue()
    if slice_type % 5 != 2:  # 2/7 = I
        raise Unsupported(f"slice_type {slice_type} (only I)")
    r.ue()  # pps id (single-PPS streams assumed; caller matched them)
    r.u(sps["log2_max_frame_num"])  # frame_num
    if nal_type == 5:
        r.ue()  # idr_pic_id
    if sps["pic_order_cnt_type"] == 0:
        r.u(sps["log2_max_poc_lsb"])
        if pps["bottom_field_pic_order"]:
            r.se()
    elif sps["pic_order_cnt_type"] == 1:
        raise Unsupported("poc type 1 slice fields")
    if pps["redundant_pic_cnt_present"]:
        r.ue()
    if nal_type == 5:
        r.flag()  # no_output_of_prior_pics
        r.flag()  # long_term_reference
    # I slice: no ref lists, no pred weights
    qp = pps["pic_init_qp"] + r.se()
    disable_deblock = 0
    if pps["deblocking_filter_control_present"]:
        disable_deblock = r.ue()
        if disable_deblock != 1:
            r.se()
            r.se()
    # macroblock_layer loop
    addr = first_mb
    total = frame.w_mbs * frame.h_mbs
    while True:
        if addr >= total:
            raise H264Error("mb address past picture end")
        qp = _decode_mb(r, sps, pps, frame, addr, qp, sid)
        addr += 1
        if not r.more_rbsp_data():
            break


def _decode_mb(r: BitReader, sps: Dict, pps: Dict, frame: _Frame,
               addr: int, qp: int, sid: int) -> int:
    mby, mbx = divmod(addr, frame.w_mbs)
    y0, x0 = mby * 16, mbx * 16
    cy0, cx0 = mby * 8, mbx * 8
    mb_type = r.ue()
    if mb_type > 25:
        raise H264Error(f"mb_type {mb_type} in I slice")

    up = frame.same_slice(mby - 1, mbx, sid)
    left_av = frame.same_slice(mby, mbx - 1, sid)
    upleft = frame.same_slice(mby - 1, mbx - 1, sid)
    upright = frame.same_slice(mby - 1, mbx + 1, sid)
    frame.slice_id[mby, mbx] = sid

    if mb_type == 25:  # I_PCM
        r.byte_align()
        for i in range(16):
            for j in range(16):
                frame.Y[y0 + i, x0 + j] = r.u(8)
        for plane in (frame.Cb, frame.Cr):
            for i in range(8):
                for j in range(8):
                    plane[cy0 + i, cx0 + j] = r.u(8)
        frame.nzY[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 16
        frame.nzCb[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 16
        frame.nzCr[mby * 2:mby * 2 + 2, mbx * 2:mbx * 2 + 2] = 16
        frame.i4mode[mby * 4:mby * 4 + 4, mbx * 4:mbx * 4 + 4] = 2  # DC
        frame.decoded[mby, mbx] = True
        return qp

    if mb_type == 0:  # I_4x4 (I_NxN)
        modes = _read_i4_modes(r, frame, mby, mbx, sid)
        chroma_mode = r.ue()
        cbp_code = r.ue()
        if cbp_code >= len(_CBP_INTRA):
            raise H264Error("bad coded_block_pattern")
        cbp = _CBP_INTRA[cbp_code]
        cbp_luma, cbp_chroma = cbp & 15, cbp >> 4
        if cbp_luma or cbp_chroma:
            qp = (qp + r.se() + 52) % 52
        _decode_i4x4_luma(r, frame, mby, mbx, modes, cbp_luma, qp,
                          up, left_av, upleft, upright, sid)
    else:  # I_16x16
        pred_mode, cbp_chroma, cbp_luma = _i16_info(mb_type)
        modes = None
        chroma_mode = r.ue()
        qp = (qp + r.se() + 52) % 52
        _decode_i16x16_luma(r, frame, mby, mbx, pred_mode, cbp_luma, qp,
                            up, left_av, upleft, sid)

    if chroma_mode > 3:
        raise H264Error("bad intra_chroma_pred_mode")
    _decode_chroma(r, pps, frame, mby, mbx, chroma_mode, cbp_chroma, qp,
                   up, left_av, upleft, sid)
    frame.decoded[mby, mbx] = True
    return qp


def _read_i4_modes(r: BitReader, frame: _Frame, mby: int, mbx: int,
                   sid: int) -> List[int]:
    """prev_intra4x4_pred_mode_flag / rem for the 16 blocks (§8.3.1.1),
    in coded block order, returning modes indexed by raster 4x4 pos."""
    modes = [-1] * 16
    b4y0, b4x0 = mby * 4, mbx * 4
    for k in range(16):
        br, bc = _BLK4_ORDER[k]
        gy, gx = b4y0 + br, b4x0 + bc
        # predicted mode = min(left, top) where available, else 2 (DC);
        # neighbors in another slice are unavailable (§8.3.1.1)
        lm = frame.i4mode[gy, gx - 1] if gx > 0 and \
            frame.same_slice(gy >> 2, (gx - 1) >> 2, sid) else -1
        tm = frame.i4mode[gy - 1, gx] if gy > 0 and \
            frame.same_slice((gy - 1) >> 2, gx >> 2, sid) else -1
        pred = 2 if lm < 0 or tm < 0 else min(int(lm), int(tm))
        if r.flag():
            mode = pred
        else:
            rem = r.u(3)
            mode = rem if rem < pred else rem + 1
        modes[br * 4 + bc] = mode
        frame.i4mode[gy, gx] = mode
    return modes


def _luma_neighbors(frame: _Frame, y: int, x: int, up: bool, left: bool,
                    upleft: bool, upright_limit: int):
    """Neighbor samples for a 4x4 at plane coords (y, x); availability
    is sample-precise: inside the MB everything above/left is decoded."""
    Y = frame.Y
    H, W = Y.shape
    top = Y[y - 1, x:x + 4].copy() if y > 0 and up else None
    lf = Y[y:y + 4, x - 1].copy() if x > 0 and left else None
    tl = int(Y[y - 1, x - 1]) if (y > 0 and x > 0 and upleft) else None
    tr = None
    if y > 0 and x + 8 <= upright_limit:
        tr = Y[y - 1, x + 4:x + 8].copy()
    return top, lf, tl, tr


def _decode_i4x4_luma(r: BitReader, frame: _Frame, mby: int, mbx: int,
                      modes: List[int], cbp_luma: int, qp: int,
                      up: bool, left_av: bool, upleft: bool, upright: bool,
                      sid: int = 0) -> None:
    y0, x0 = mby * 16, mbx * 16
    nz = frame.nzY
    for k in range(16):
        br, bc = _BLK4_ORDER[k]
        by, bx = y0 + br * 4, x0 + bc * 4
        gby, gbx = mby * 4 + br, mbx * 4 + bc
        # sample availability for this 4x4
        t_ok = (br > 0) or up
        l_ok = (bc > 0) or left_av
        tl_ok = (br > 0 and bc > 0) or (br > 0 and left_av) or \
            (bc > 0 and up) or upleft
        # top-right availability: within the MB rows, blocks on the top
        # row can see the above MB / above-right MB; interior blocks see
        # decoded-block coverage only when the block above-right in the
        # coded order is already reconstructed.
        tr_ok = False
        if br == 0:
            tr_ok = upright if bc == 3 else up
        elif bc == 3:
            tr_ok = False
        else:
            # above-right 4x4 inside this MB must already be decoded:
            # true iff its coded index precedes k
            nb = _BLK4_ORDER.index((br - 1, bc + 1))
            tr_ok = nb < k
        top, lf, tl, tr = _sample_neigh(frame.Y, by, bx, t_ok, l_ok,
                                        tl_ok, tr_ok)
        mode = modes[br * 4 + bc]
        pred = _pred4x4(mode, top, lf, tl, tr)
        blk8 = (br // 2) * 2 + (bc // 2)
        if cbp_luma & (1 << blk8):
            nc = _nC(nz, gby, gbx, frame, sid, 2)
            coeffs, tc = residual_block_cavlc(r, nc, 16)
            nz[gby, gbx] = tc
            d = dequant4x4(coeffs, qp)
            frame.Y[by:by + 4, bx:bx + 4] = idct4x4_add(pred, d)
        else:
            nz[gby, gbx] = 0
            frame.Y[by:by + 4, bx:bx + 4] = np.clip(pred, 0, 255)


def _sample_neigh(plane: np.ndarray, y: int, x: int, t_ok: bool, l_ok: bool,
                  tl_ok: bool, tr_ok: bool):
    top = plane[y - 1, x:x + 4].copy() if t_ok and y > 0 else None
    lf = plane[y:y + 4, x - 1].copy() if l_ok and x > 0 else None
    tl = int(plane[y - 1, x - 1]) if tl_ok and y > 0 and x > 0 else None
    tr = None
    if tr_ok and y > 0 and x + 8 <= plane.shape[1]:
        tr = plane[y - 1, x + 4:x + 8].copy()
    elif tr_ok and y > 0:
        tr = None  # off right edge: substitution handled in _pred4x4
    return top, lf, tl, tr


def _decode_i16x16_luma(r: BitReader, frame: _Frame, mby: int, mbx: int,
                        pred_mode: int, cbp_luma: int, qp: int,
                        up: bool, left_av: bool, upleft: bool,
                        sid: int = 0) -> None:
    y0, x0 = mby * 16, mbx * 16
    Y = frame.Y
    top = Y[y0 - 1, x0:x0 + 16].copy() if up else None
    lf = Y[y0:y0 + 16, x0 - 1].copy() if left_av else None
    tl = int(Y[y0 - 1, x0 - 1]) if upleft else None
    pred = _pred16x16(pred_mode, top, lf, tl)
    nz = frame.nzY
    # luma DC block: nC from neighboring 4x4 block 0's totals
    nc = _nC(nz, mby * 4, mbx * 4, frame, sid, 2)
    dc_coeffs, _dc_tc = residual_block_cavlc(r, nc, 16)
    dc = np.zeros((4, 4), np.int64)
    for idx, (i, j) in enumerate(_ZIGZAG):
        dc[i, j] = dc_coeffs[idx]
    dc = luma_dc_dequant(dc, qp)
    for k in range(16):
        br, bc = _BLK4_ORDER[k]
        by, bx = y0 + br * 4, x0 + bc * 4
        gby, gbx = mby * 4 + br, mbx * 4 + bc
        if cbp_luma:
            nc = _nC(nz, gby, gbx, frame, sid, 2)
            coeffs, tc = residual_block_cavlc(r, nc, 15)
            nz[gby, gbx] = tc
            d = dequant4x4([0] + coeffs, qp, skip_dc=False)
            # AC levels occupy scan positions 1..15
            d2 = np.zeros((4, 4), np.int64)
            v = _DEQUANT_V[qp % 6]
            for idx in range(1, 16):
                lvl = coeffs[idx - 1]
                if lvl:
                    i, j = _ZIGZAG[idx]
                    d2[i, j] = (lvl * v[_POS_CLASS[i][j]]) << (qp // 6)
            d = d2
        else:
            nz[gby, gbx] = 0
            d = np.zeros((4, 4), np.int64)
        d[0, 0] = dc[br, bc]
        frame.Y[by:by + 4, bx:bx + 4] = idct4x4_add(
            pred[br * 4:br * 4 + 4, bc * 4:bc * 4 + 4], d)


def _decode_chroma(r: BitReader, pps: Dict, frame: _Frame, mby: int,
                   mbx: int, chroma_mode: int, cbp_chroma: int, qp: int,
                   up: bool, left_av: bool, upleft: bool,
                   sid: int = 0) -> None:
    qpc_i = int(np.clip(qp + pps["chroma_qp_index_offset"], 0, 51))
    qpc = _CHROMA_QP_MAP[qpc_i]
    cy0, cx0 = mby * 8, mbx * 8
    for plane, nz in ((frame.Cb, frame.nzCb), (frame.Cr, frame.nzCr)):
        top = plane[cy0 - 1, cx0:cx0 + 8].copy() if up else None
        lf = plane[cy0:cy0 + 8, cx0 - 1].copy() if left_av else None
        tl = int(plane[cy0 - 1, cx0 - 1]) if upleft else None
        pred = _pred_chroma(chroma_mode, top, lf, tl)
        plane[cy0:cy0 + 8, cx0:cx0 + 8] = np.clip(pred, 0, 255)
    # residuals: DC blocks for both planes, then AC
    dcs = []
    for plane_i in range(2):
        if cbp_chroma:
            coeffs, _tc = residual_block_cavlc(r, -1, 4)
            dc = np.array([[coeffs[0], coeffs[1]],
                           [coeffs[2], coeffs[3]]], np.int64)
            dcs.append(chroma_dc_dequant(dc, qpc))
        else:
            dcs.append(np.zeros((2, 2), np.int64))
    for plane_i, (plane, nz) in enumerate(
            ((frame.Cb, frame.nzCb), (frame.Cr, frame.nzCr))):
        for br in range(2):
            for bc in range(2):
                by, bx = cy0 + br * 4, cx0 + bc * 4
                gby, gbx = mby * 2 + br, mbx * 2 + bc
                pred = plane[by:by + 4, bx:bx + 4].copy()
                if cbp_chroma == 2:
                    nc = _nC(nz, gby, gbx, frame, sid, 1)
                    coeffs, tc = residual_block_cavlc(r, nc, 15)
                    nz[gby, gbx] = tc
                    d = np.zeros((4, 4), np.int64)
                    v = _DEQUANT_V[qpc % 6]
                    for idx in range(1, 16):
                        lvl = coeffs[idx - 1]
                        if lvl:
                            i, j = _ZIGZAG[idx]
                            d[i, j] = (lvl * v[_POS_CLASS[i][j]]) << (qpc // 6)
                else:
                    nz[gby, gbx] = 0
                    d = np.zeros((4, 4), np.int64)
                d[0, 0] = dcs[plane_i][br, bc]
                plane[by:by + 4, bx:bx + 4] = idct4x4_add(pred, d)


# ---------------------------------------------------------------------------
# top-level entry points
# ---------------------------------------------------------------------------

def iter_pictures(stream: bytes):
    """Yield (sps, pps, slice_nals) per coded picture of an Annex-B
    stream. Pictures are cut at slices whose first_mb_in_slice restarts
    at 0 (types 1 AND 5 — non-IDR I slices exist in open-GOP streams),
    so multi-access-unit windows (TS captures) never mix pictures."""
    sps = pps = None
    slices: List[bytes] = []
    for nal in split_annexb(stream):
        if not nal:
            continue
        t = nal[0] & 0x1F
        if t == 7:
            if sps is None:
                sps = parse_sps(unescape(nal[1:]))
        elif t == 8:
            if pps is None:
                pps = parse_pps(unescape(nal[1:]))
        elif t in (1, 5):
            if sps is None or pps is None:
                continue  # mid-stream window before parameter sets
            first_mb = BitReader(unescape(nal[1:5])).ue()
            if first_mb == 0 and slices:
                yield sps, pps, slices
                slices = []
            slices.append(nal)
    if slices:
        yield sps, pps, slices


def decode_annexb_iframe(stream: bytes
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode the first decodable I/IDR picture of an Annex-B stream →
    (Y, Cb, Cr). Later pictures are tried (bounded) when the first is
    a P/B slice the intra decoder rejects."""
    err: Optional[H264Error] = None
    for k, (sps, pps, slices) in enumerate(iter_pictures(stream)):
        if sps is None or pps is None:
            raise H264Error("slice before parameter sets")
        try:
            return decode_picture(sps, pps, slices)
        except Unsupported as e:
            err = e  # e.g. a P picture; try the next one
            if k >= 8:
                break
    raise err or H264Error("no decodable I/IDR picture")


def keyframe_from_mp4(path: str, fraction: float = 0.10
                      ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]]:
    """Decode the sync sample nearest `fraction` into an H.264 MP4 →
    (Y, Cb, Cr), or None when the file isn't H.264-in-MP4 / uses
    features outside the baseline-I subset.

    The thumbnailer's contract (seek 10%, decode one frame) realized
    against the container's own sample tables: stsd→avcC for SPS/PPS,
    stss for sync samples, stts for times, stsz/stsc/stco for bytes —
    no demuxer library, O(moov) + one sample read.
    """
    import os as _os

    from .mp4meta import _file_top_boxes
    from .isobmff import iter_boxes

    try:
        with open(path, "rb") as f:
            f.seek(0, _os.SEEK_END)
            end = f.tell()
            f.seek(0)
            if f.read(12)[4:8] != b"ftyp":
                return None
            moov = None
            for typ, ps, pe in _file_top_boxes(f, end):
                if typ == b"moov":
                    if pe - ps > (64 << 20):
                        return None
                    f.seek(ps)
                    moov = f.read(pe - ps)
                    break
            if moov is None:
                return None
            tables = _h264_track_tables(moov)
            if tables is None:
                return None
            sample_i = _pick_sync_sample(tables, fraction)
            if sample_i is None:
                return None
            off, size = _sample_location(tables, sample_i)
            f.seek(off)
            sample = f.read(size)
            if len(sample) != size:
                return None
        nal_len = tables["nal_length_size"]
        slices = []
        pos = 0
        while pos + nal_len <= len(sample):
            ln = int.from_bytes(sample[pos:pos + nal_len], "big")
            pos += nal_len
            nal = sample[pos:pos + ln]
            pos += ln
            if nal and (nal[0] & 0x1F) in (1, 5):
                slices.append(nal)
        if not slices:
            return None
        return decode_picture(tables["sps"], tables["pps"], slices)
    except Unsupported:
        return None
    except (H264Error, struct.error, ValueError, OSError):
        return None


def _h264_track_tables(moov: bytes) -> Optional[Dict]:
    """Sample tables of the first avc1 video track."""
    from .isobmff import iter_boxes

    for typ, ps, pe in iter_boxes(moov):
        if typ != b"trak":
            continue
        out: Dict = {}

        def walk(bs, be):
            for t, s, e in iter_boxes(moov, bs, be):
                if t == b"hdlr":
                    out["handler"] = moov[s + 8:s + 12]
                elif t == b"stsd":
                    n = struct.unpack_from(">I", moov, s + 4)[0]
                    if n >= 1:
                        esz, fourcc = struct.unpack_from(">I4s", moov, s + 8)
                        out["fourcc"] = fourcc
                        out["entry"] = (s + 8, min(s + 8 + esz, e))
                elif t in (b"stts", b"stss", b"stsz", b"stsc", b"stco",
                           b"co64"):
                    out[t.decode()] = (s, e)
                elif t in (b"mdia", b"minf", b"stbl"):
                    walk(s, e)

        walk(ps, pe)
        if out.get("handler") != b"vide" or out.get("fourcc") not in (
                b"avc1", b"avc3"):
            continue
        # avcC inside the VisualSampleEntry (8 + 70 fixed bytes in)
        es, ee = out["entry"]
        avcc = None
        p = es + 8 + 78
        while p + 8 <= ee:
            bsz, btyp = struct.unpack_from(">I4s", moov, p)
            if bsz < 8 or p + bsz > ee:
                break
            if btyp == b"avcC":
                avcc = moov[p + 8:p + bsz]
                break
            p += bsz
        if avcc is None or len(avcc) < 7:
            continue
        nal_len = (avcc[4] & 3) + 1
        n_sps = avcc[5] & 0x1F
        q = 6
        sps = pps = None
        for _ in range(n_sps):
            ln = struct.unpack_from(">H", avcc, q)[0]
            q += 2
            if sps is None:
                sps = parse_sps(unescape(avcc[q + 1:q + ln]))
            q += ln
        n_pps = avcc[q]
        q += 1
        for _ in range(n_pps):
            ln = struct.unpack_from(">H", avcc, q)[0]
            q += 2
            if pps is None:
                pps = parse_pps(unescape(avcc[q + 1:q + ln]))
            q += ln
        if sps is None or pps is None:
            continue
        out["sps"], out["pps"] = sps, pps
        out["nal_length_size"] = nal_len
        out["moov"] = moov
        return out
    return None


def _table_entries(moov: bytes, span, fmt: str, count_off: int = 4):
    s, e = span
    n = struct.unpack_from(">I", moov, s + count_off)[0]
    sz = struct.calcsize(fmt)
    n = min(n, (e - s - count_off - 4) // sz + 1)  # clamp to box bytes
    return n, s + count_off + 4 - 4  # caller offsets per-format


def _pick_sync_sample(t: Dict, fraction: float) -> Optional[int]:
    """1-based sample number of the sync sample nearest `fraction` of
    the track duration (at-or-before; first sync after as fallback)."""
    moov = t["moov"]
    if "stts" not in t or "stsz" not in t:
        return None
    # total samples + the sample index at the target time
    s, e = t["stts"]
    n = struct.unpack_from(">I", moov, s + 4)[0]
    total_samples = 0
    total_time = 0
    runs = []
    p = s + 8
    for _ in range(n):
        if p + 8 > e:
            return None
        cnt, delta = struct.unpack_from(">II", moov, p)
        runs.append((cnt, delta))
        total_samples += cnt
        total_time += cnt * delta
        p += 8
    if total_samples == 0:
        return None
    target_t = total_time * fraction
    acc_t, acc_s = 0, 0
    target_sample = total_samples
    for cnt, delta in runs:
        if delta and acc_t + cnt * delta >= target_t:
            target_sample = acc_s + int((target_t - acc_t) / max(delta, 1)) + 1
            break
        acc_t += cnt * delta
        acc_s += cnt
    target_sample = max(1, min(total_samples, target_sample))
    if "stss" not in t:
        return target_sample  # every sample is sync
    s, e = t["stss"]
    n = struct.unpack_from(">I", moov, s + 4)[0]
    best_before = None
    first_after = None
    p = s + 8
    for _ in range(n):
        if p + 4 > e:
            break
        sync = struct.unpack_from(">I", moov, p)[0]
        if sync <= target_sample:
            best_before = sync
        elif first_after is None:
            first_after = sync
        p += 4
    return best_before or first_after


def _sample_location(t: Dict, sample_i: int) -> Tuple[int, int]:
    """Byte (offset, size) of 1-based sample_i via stsz + stsc + stco."""
    moov = t["moov"]
    # sizes
    s, e = t["stsz"]
    uniform, count = struct.unpack_from(">II", moov, s + 4)

    def size_of(k: int) -> int:  # 1-based
        if uniform:
            return uniform
        return struct.unpack_from(">I", moov, s + 12 + 4 * (k - 1))[0]

    # chunk mapping
    s2, e2 = t["stsc"]
    n2 = struct.unpack_from(">I", moov, s2 + 4)[0]
    entries = []
    p = s2 + 8
    for _ in range(n2):
        first_chunk, per_chunk, _desc = struct.unpack_from(">III", moov, p)
        entries.append((first_chunk, per_chunk))
        p += 12
    # chunk offsets
    if "stco" in t:
        s3, e3 = t["stco"]
        n3 = struct.unpack_from(">I", moov, s3 + 4)[0]

        def chunk_off(c: int) -> int:  # 1-based
            return struct.unpack_from(">I", moov, s3 + 8 + 4 * (c - 1))[0]
    else:
        s3, e3 = t["co64"]
        n3 = struct.unpack_from(">I", moov, s3 + 4)[0]

        def chunk_off(c: int) -> int:
            return struct.unpack_from(">Q", moov, s3 + 8 + 8 * (c - 1))[0]

    # walk chunks to find the one holding sample_i
    remaining = sample_i - 1
    chunk = 1
    for idx, (first_chunk, per_chunk) in enumerate(entries):
        last_chunk = (entries[idx + 1][0] - 1) if idx + 1 < len(entries) \
            else n3
        span_chunks = last_chunk - first_chunk + 1
        span_samples = span_chunks * per_chunk
        if remaining < span_samples:
            chunk = first_chunk + remaining // per_chunk
            index_in_chunk = remaining % per_chunk
            first_sample_of_chunk = sample_i - index_in_chunk
            off = chunk_off(chunk)
            for k in range(first_sample_of_chunk, sample_i):
                off += size_of(k)
            return off, size_of(sample_i)
        remaining -= span_samples
    raise H264Error("sample not covered by stsc")


def yuv420_to_rgb(Y: np.ndarray, Cb: np.ndarray, Cr: np.ndarray
                  ) -> np.ndarray:
    """BT.601 full-swing-ish conversion good enough for thumbnails."""
    H, W = Y.shape
    cb = np.repeat(np.repeat(Cb, 2, 0), 2, 1)[:H, :W].astype(np.float64) - 128
    cr = np.repeat(np.repeat(Cr, 2, 0), 2, 1)[:H, :W].astype(np.float64) - 128
    y = (Y.astype(np.float64) - 16) * (255.0 / 219.0)
    r = y + 1.596 * cr
    g = y - 0.392 * cb - 0.813 * cr
    b = y + 2.017 * cb
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
