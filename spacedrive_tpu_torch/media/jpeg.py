"""JPEG to the pixels libjpeg-turbo gives PIL: the plain (numpy) version.

PIL opens a JPEG through libjpeg-turbo with its defaults (``JDCT_ISLOW``,
fancy upsampling, block smoothing) and asks for L from one component, RGB
from three, CMYK from four; ``convert("L")`` of the RGB is then L24. The machine with the
card has no PIL and no libjpeg, so the port decodes JPEG itself, integer
arithmetic only, to libjpeg-turbo 3.1.3's samples exactly:

- the marker walk (SOI, APPn, COM, DQT, DHT, SOF0/1/2, SOS, DRI, RSTn,
  EOI), junk bytes before a marker skipped as libjpeg skips them;
- Huffman decoding of sequential scans (interleaved or not) and of
  progressive ones (spectral selection, successive approximation: DC
  first and refine, AC first and refine with EOB runs), restart intervals
  resetting the DC predictors and the EOB run, into whole-image
  coefficient buffers;
- ``jpeg_idct_islow`` (``jidctint.c``: CONST_BITS 13, PASS1_BITS 2,
  DESCALE rounding), its outputs clamped to 0..255. libjpeg-turbo's C
  code masks an out-of-range output through ``range_limit`` (RANGE_MASK
  1023) where its SIMD IDCT, which PIL's x86-64 builds run, saturates;
  Pillow 12.1.0 here clamps (a DC-only block at 600 gives 255, not 0), so
  this decoder clamps too. The SIMD IDCT holds dequantised values, the
  pass-1 workspace and pairwise sums of them in 16-bit lanes, so a block
  with such a value past +-16383 is refused;
- fancy (triangle) upsampling (``jdsample.c``: h2v1, h2v2 with context
  rows, h1v2; edge columns and rows replicated) where a component is half
  as wide or tall, plain replication where its ``downsampled_width`` is at
  most 2 or its factors are other integers;
- YCbCr to RGB through ``jdcolor.c``'s fixed-point tables, clamped; no
  conversion where the image is RGB (Adobe APP14 transform 0, or component
  IDs 'R', 'G', 'B' without JFIF or Adobe markers);
- four components: CMYK as they are (no Adobe marker, or transform 0) or
  YCCK to CMYK (any other Adobe transform: ``ycck_cmyk_convert``, 255 minus
  the YCbCr-to-RGB of the first three, K as it is), then every sample
  inverted, as PIL reads a CMYK JPEG (raw mode ``CMYK;I``, Adobe's
  polarity). ``imgdecode.thumb_rgb`` turns that into RGB by PIL's
  ``cmyk2rgb``.

What it cannot give exactly it refuses with a reason (``REASONS``): two
or more than four components, arithmetic coding, lossless and hierarchical frames, 12-bit
samples, DNL, a file without EOI (PIL: "image file is truncated"), a scan
whose entropy data is short or corrupt (libjpeg would warn and fill),
a progressive image whose first ten coefficients are incomplete (libjpeg
would smooth its blocks), a bogus progression, and a block past the IDCT's
16-bit range.

The Huffman decoding loops in Python over symbols; the IDCT, upsampling
and colour stages are vectorised over blocks and rows. ``csrc/jpegdec.cpp``
is the native version, one ctypes call with the same status codes; the
tests and ``chip_smoke.py`` hold the two against each other, and nothing
on the main path runs this one.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .imgdecode import MAX_PIXELS, UnsupportedImage

# Status codes: must match `enum Status` in csrc/jpegdec.cpp.
OK = 0
NOT_JPEG = 1
NO_EOI = 2
BAD_MARKER = 3
ARITHMETIC = 4
LOSSLESS = 5
HIERARCHICAL = 6
PRECISION = 7
COMPONENTS = 8
DNL = 9
BAD_TABLE = 10
BAD_FRAME = 11
BAD_SCAN = 12
SAMPLING = 13
CORRUPT_DATA = 14
PROGRESSION = 15
INCOMPLETE = 16
EXTREME_BLOCK = 17
SIZE = 18

REASONS = {
    NOT_JPEG: "not a JPEG",
    NO_EOI: "truncated JPEG: no EOI",
    BAD_MARKER: "unknown or misplaced JPEG marker",
    ARITHMETIC: "arithmetic-coded JPEG",
    LOSSLESS: "lossless JPEG",
    HIERARCHICAL: "hierarchical JPEG",
    PRECISION: "JPEG samples are not 8-bit",
    COMPONENTS: "JPEG with other than 1, 3 or 4 components",
    DNL: "JPEG with a DNL marker",
    BAD_TABLE: "bad or missing JPEG table",
    BAD_FRAME: "bad JPEG frame header",
    BAD_SCAN: "bad JPEG scan header",
    SAMPLING: "unsupported JPEG sampling factors",
    CORRUPT_DATA: "truncated or corrupt JPEG scan data",
    PROGRESSION: "bogus JPEG progression",
    INCOMPLETE: "incomplete progressive JPEG (libjpeg would smooth its blocks)",
    EXTREME_BLOCK: "JPEG block past the IDCT's 16-bit range",
    SIZE: "JPEG image size",
}


class _Refused(Exception):
    def __init__(self, code: int):
        super().__init__(code)
        self.code = code


def _zigzag() -> np.ndarray:
    """NATURAL[k]: the row-major index of the k-th coefficient in zigzag
    order (libjpeg's jpeg_natural_order)."""
    order = []
    for s in range(15):
        cells = [(r, s - r) for r in range(max(0, s - 7), min(s, 7) + 1)]
        order += cells if s % 2 else cells[::-1]
    return np.array([r * 8 + c for r, c in order], np.int64)


NATURAL = _zigzag()
MAX_DIMENSION = 65500  # libjpeg's JPEG_MAX_DIMENSION
# Coefficients whose incompleteness makes libjpeg-turbo smooth a
# progressive image (jdcoefct.c SAVED_COEFS): the first ten in zigzag order.
SMOOTHED_COEFS = 10

# -- jidctint.c ---------------------------------------------------------------

CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100 = 2446, 3196, 4433
FIX_0_765366865, FIX_0_899976223, FIX_1_175875602 = 6270, 7373, 9633
FIX_1_501321110, FIX_1_847759065, FIX_1_961570560 = 12299, 15137, 16069
FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16819, 20995, 25172
# The SIMD IDCT's 16-bit lanes hold a dequantised or workspace value and the
# sum of two of them: within +-IDCT_INPUT_MAX it computes what the C code
# does, then saturates its outputs.
IDCT_INPUT_MAX = 16383


def _idct_1d(c):
    """One islow butterfly over the 8 inputs `c` (int64 arrays, natural
    order along the pass); returns the 8 undescaled outputs."""
    z1 = (c[2] + c[6]) * FIX_0_541196100
    tmp2 = z1 - c[6] * FIX_1_847759065
    tmp3 = z1 + c[2] * FIX_0_765366865
    tmp0 = (c[0] + c[4]) << CONST_BITS
    tmp1 = (c[0] - c[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0 = t0 * FIX_0_298631336
    t1 = t1 * FIX_2_053119869
    t2 = t2 * FIX_3_072711026
    t3 = t3 * FIX_1_501321110
    z1 = z1 * -FIX_0_899976223
    z2 = z2 * -FIX_2_562915447
    z3 = z3 * -FIX_1_961570560 + z5
    z4 = z4 * -FIX_0_390180644 + z5
    t0 += z1 + z3
    t1 += z2 + z4
    t2 += z2 + z3
    t3 += z1 + z4
    return (tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
            tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)


def _descale(x, n: int):
    return (x + (1 << (n - 1))) >> n


def idct_islow(coefs: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """[N, 64] int32 coefficients in zigzag order and their [64] zigzag
    quantisation table → [N, 8, 8] uint8 samples, ``jpeg_idct_islow`` and
    the SIMD path's saturation. Raises _Refused(EXTREME_BLOCK) where a
    pass input leaves the SIMD path's 16-bit range."""
    n = coefs.shape[0]
    deq = np.zeros((n, 64), np.int64)
    deq[:, NATURAL] = coefs.astype(np.int64) * quant.astype(np.int64)
    if deq.size and np.abs(deq).max() > IDCT_INPUT_MAX:
        raise _Refused(EXTREME_BLOCK)
    x = deq.reshape(n, 8, 8)
    # Pass 1: columns (inputs along axis 1), into an int workspace.
    ws = np.stack([_descale(o, CONST_BITS - PASS1_BITS)
                   for o in _idct_1d([x[:, k, :] for k in range(8)])], axis=1)
    if ws.size and np.abs(ws).max() > IDCT_INPUT_MAX:
        raise _Refused(EXTREME_BLOCK)
    # Pass 2: rows (inputs along axis 2).
    out = np.stack([_descale(o, CONST_BITS + PASS1_BITS + 3)
                    for o in _idct_1d([ws[:, :, k] for k in range(8)])], axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


# -- jdsample.c -----------------------------------------------------------------


def _prev(a: np.ndarray, axis: int) -> np.ndarray:
    """`a` shifted by one along `axis`, its first slice replicated."""
    idx = np.maximum(np.arange(a.shape[axis]) - 1, 0)
    return np.take(a, idx, axis=axis)


def _next(a: np.ndarray, axis: int) -> np.ndarray:
    idx = np.minimum(np.arange(a.shape[axis]) + 1, a.shape[axis] - 1)
    return np.take(a, idx, axis=axis)


def _interleave(even: np.ndarray, odd: np.ndarray, axis: int) -> np.ndarray:
    out = np.stack([even, odd], axis=axis + 1)
    shape = list(even.shape)
    shape[axis] *= 2
    return out.reshape(shape)


def upsample(plane: np.ndarray, h_expand: int, v_expand: int, fancy: bool) -> np.ndarray:
    """A component's [dh, dw] samples → [dh·v, dw·h] uint8 as libjpeg's
    upsampler for these factors (`fancy` false where jinit_upsampler takes
    plain replication: a downsampled width of at most 2)."""
    p = plane.astype(np.int32)
    if (h_expand, v_expand) == (1, 1):
        return plane
    if fancy and (h_expand, v_expand) == (2, 1):
        t = 3 * p
        out = _interleave((t + _prev(p, 1) + 1) >> 2, (t + _next(p, 1) + 2) >> 2, 1)
    elif (h_expand, v_expand) == (1, 2):
        t = 3 * p
        out = _interleave((t + _prev(p, 0) + 1) >> 2, (t + _next(p, 0) + 2) >> 2, 0)
    elif fancy and (h_expand, v_expand) == (2, 2):
        t = 3 * p
        cols = _interleave(t + _prev(p, 0), t + _next(p, 0), 0)
        t = 3 * cols
        out = _interleave((t + _prev(cols, 1) + 8) >> 4, (t + _next(cols, 1) + 7) >> 4, 1)
    else:
        out = np.repeat(np.repeat(p, v_expand, axis=0), h_expand, axis=1)
    return out.astype(np.uint8)


# -- jdcolor.c ----------------------------------------------------------------


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    fix = lambda v: int(v * (1 << 16) + 0.5)  # noqa: E731
    half = 1 << 15
    cr_r = (fix(1.40200) * x + half) >> 16
    cb_b = (fix(1.77200) * x + half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + half
    return cr_r, cb_b, cr_g, cb_g


CR_R, CB_B, CR_G, CB_G = _ycc_tables()


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """[h, w] uint8 planes → [h, w, 3] uint8, ``ycc_rgb_convert``."""
    y = y.astype(np.int64)
    r = y + CR_R[cr]
    g = y + ((CB_G[cb] + CR_G[cr]) >> 16)
    b = y + CB_B[cb]
    return np.clip(np.stack([r, g, b], axis=2), 0, 255).astype(np.uint8)


# -- markers and tables -------------------------------------------------------


class _Component:
    __slots__ = ("cid", "h", "v", "tq", "qt", "bw", "bh", "bw_pad", "bh_pad", "dw", "dh",
                 "offset", "scans", "coef_bits")


class _Frame:
    def __init__(self, marker: int, payload: bytes):
        if len(payload) < 6:
            raise _Refused(BAD_FRAME)
        precision, self.height, self.width, n = struct.unpack_from(">BHHB", payload)
        if precision != 8:
            raise _Refused(PRECISION)
        if self.height == 0:
            raise _Refused(DNL)
        if n not in (1, 3, 4):
            raise _Refused(COMPONENTS)
        if self.width == 0 or max(self.width, self.height) > MAX_DIMENSION or \
                len(payload) != 6 + 3 * n:
            raise _Refused(BAD_FRAME)
        self.progressive = marker == 0xC2
        self.comps: List[_Component] = []
        for i in range(n):
            cid, hv, tq = payload[6 + 3 * i:9 + 3 * i]
            c = _Component()
            c.cid, c.h, c.v, c.tq = cid, hv >> 4, hv & 15, tq
            if not (1 <= c.h <= 4 and 1 <= c.v <= 4) or tq > 3:
                raise _Refused(BAD_FRAME)
            self.comps.append(c)
        self.hmax = max(c.h for c in self.comps)
        self.vmax = max(c.v for c in self.comps)
        self.mcux = -(-self.width // (8 * self.hmax))
        self.mcuy = -(-self.height // (8 * self.vmax))
        total = 0
        for c in self.comps:
            if self.hmax % c.h or self.vmax % c.v:
                raise _Refused(SAMPLING)
            c.dw = -(-self.width * c.h // self.hmax)
            c.dh = -(-self.height * c.v // self.vmax)
            c.bw, c.bh = -(-c.dw // 8), -(-c.dh // 8)
            c.bw_pad, c.bh_pad = self.mcux * c.h, self.mcuy * c.v
            c.offset = total
            total += c.bw_pad * c.bh_pad
            c.qt = None
            c.scans = 0
            c.coef_bits = [-1] * 64
        if n > 1 and sum(c.h * c.v for c in self.comps) > 10:
            raise _Refused(SAMPLING)  # libjpeg's D_MAX_BLOCKS_IN_MCU
        self.blocks = total


def _huffman_lut(bits: bytes, values: bytes) -> List[int]:
    """65536-entry decode table: the 16 bits at the read position →
    (code length << 8) | symbol, 0 for no code. jdhuff.c's checks."""
    lut = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            if code >= 1 << length:
                raise _Refused(BAD_TABLE)
            span = 1 << (16 - length)
            lut[code * span:(code + 1) * span] = (length << 8) | values[k]
            code += 1
            k += 1
        if code >= 1 << length:
            raise _Refused(BAD_TABLE)
        code <<= 1
    return lut.tolist()


def _read_dht(payload: bytes, tables: dict) -> None:
    pos = 0
    while pos < len(payload):
        if pos + 17 > len(payload):
            raise _Refused(BAD_TABLE)
        tc_th = payload[pos]
        bits = payload[pos + 1:pos + 17]
        count = sum(bits)
        values = payload[pos + 17:pos + 17 + count]
        if tc_th & 0xEC or count > 256 or len(values) != count:
            raise _Refused(BAD_TABLE)
        if not tc_th >> 4 and max(values, default=0) > 15:
            raise _Refused(BAD_TABLE)
        tables[tc_th >> 4, tc_th & 3] = _huffman_lut(bits, values)
        pos += 17 + count


def _read_dqt(payload: bytes, quant: dict) -> None:
    pos = 0
    while pos < len(payload):
        pq_tq = payload[pos]
        if pq_tq >> 4 > 1 or pq_tq & 15 > 3:
            raise _Refused(BAD_TABLE)
        size = 64 * (1 + (pq_tq >> 4))
        if pos + 1 + size > len(payload):
            raise _Refused(BAD_TABLE)
        dtype = ">u2" if pq_tq >> 4 else np.uint8
        quant[pq_tq & 15] = np.frombuffer(payload, dtype, 64, pos + 1).astype(np.int64)
        pos += 1 + size


def _next_marker(data: bytes, pos: int) -> Tuple[int, int]:
    """libjpeg's next_marker: skip non-FF bytes, fill FFs and FF 00 pairs;
    returns (marker byte, position after it)."""
    n = len(data)
    while True:
        while pos < n and data[pos] != 0xFF:
            pos += 1
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise _Refused(NO_EOI)
        if data[pos] != 0:
            return data[pos], pos + 1
        pos += 1


def _segment(data: bytes, pos: int) -> Tuple[bytes, int]:
    if pos + 2 > len(data):
        raise _Refused(NO_EOI)
    length = struct.unpack_from(">H", data, pos)[0]
    if length < 2:
        raise _Refused(BAD_MARKER)
    if pos + length > len(data):
        raise _Refused(NO_EOI)
    return data[pos + 2:pos + length], pos + length


def _entropy_segment(data: bytes, pos: int) -> Tuple[bytes, int, int]:
    """Entropy-coded bytes from `pos` to the next marker, unstuffed (FF 00
    and FF FF .. 00 are one FF byte); returns (bytes, marker, position
    after the marker)."""
    out = []
    n = len(data)
    while True:
        ff = data.find(b"\xff", pos)
        if ff < 0:
            raise _Refused(NO_EOI)
        out.append(data[pos:ff])
        q = ff
        while q < n and data[q] == 0xFF:
            q += 1
        if q >= n:
            raise _Refused(NO_EOI)
        if data[q] == 0:
            out.append(b"\xff")
            pos = q + 1
            continue
        return b"".join(out), data[q], q + 1


class _Bits:
    """MSB-first reader over one unstuffed entropy segment."""

    __slots__ = ("buf", "nbits", "pos")

    def __init__(self, seg: bytes):
        self.buf = seg + b"\x00" * 4
        self.nbits = 8 * len(seg)
        self.pos = 0


def _short(v: int) -> int:
    """`v` stored in a JCOEF (int16), as C truncates it."""
    return (v + 0x8000) % 0x10000 - 0x8000


def _extend(r: int, s: int) -> int:
    return r - (1 << s) + 1 if r < 1 << (s - 1) else r


# -- scans ----------------------------------------------------------------------


def _scan_blocks(frame: _Frame, comps: List[_Component]) -> np.ndarray:
    """[n_mcu, blocks per MCU] flat block indices in the scan's order."""
    if len(comps) == 1:
        c = comps[0]
        by, bx = np.meshgrid(np.arange(c.bh), np.arange(c.bw), indexing="ij")
        return (c.offset + by * c.bw_pad + bx).reshape(-1, 1)
    cols = []
    my, mx = np.meshgrid(np.arange(frame.mcuy), np.arange(frame.mcux), indexing="ij")
    my, mx = my.reshape(-1), mx.reshape(-1)
    for c in comps:
        for v in range(c.v):
            for h in range(c.h):
                cols.append(c.offset + (my * c.v + v) * c.bw_pad + mx * c.h + h)
    return np.stack(cols, axis=1)


def _decode_scan(data: bytes, pos: int, frame: _Frame, comps, spec, tables,
                 restart: int, coef: np.ndarray) -> Tuple[int, int]:
    """Decode one scan's entropy data from `pos` into `coef` ([blocks, 64]
    int32, zigzag); returns (marker after the scan, position after it)."""
    ss, se, ah, al = spec
    mcus = _scan_blocks(frame, [frame.comps[ci] for ci, _, _ in comps])
    block_comp = []
    for k, (ci, _, _) in enumerate(comps):
        c = frame.comps[ci]
        block_comp += [k] * (1 if len(comps) == 1 else c.h * c.v)
    dc_luts = [tables.get((0, td)) for _, td, _ in comps]
    ac_luts = [tables.get((1, ta)) for _, _, ta in comps]
    need_dc = not frame.progressive or (ss == 0 and ah == 0)
    need_ac = not frame.progressive or ss > 0
    if need_dc and any(t is None for t in dc_luts) or need_ac and any(
            t is None for t in ac_luts):
        raise _Refused(BAD_TABLE)
    if not frame.progressive:
        kind = _seq_mcu
    elif ss == 0:
        kind = _dc_first if ah == 0 else _dc_refine
    else:
        kind = _ac_first if ah == 0 else _ac_refine
    n_mcu = mcus.shape[0]
    per = restart if restart else n_mcu
    mcu_list = mcus.tolist()
    rst = 0
    for start in range(0, n_mcu, per):
        seg, marker, pos = _entropy_segment(data, pos)
        bits = _Bits(seg)
        state = [[0] * len(comps), 0]  # DC predictors, EOB run
        try:
            for m in range(start, min(start + per, n_mcu)):
                kind(bits, mcu_list[m], block_comp, dc_luts, ac_luts, state, coef, ss, se, al)
        except IndexError:  # read far past the segment's end
            raise _Refused(CORRUPT_DATA) from None
        if bits.pos > bits.nbits:
            raise _Refused(CORRUPT_DATA)
        if start + per < n_mcu:
            if marker != 0xD0 + rst:
                raise _Refused(CORRUPT_DATA)
            rst = (rst + 1) & 7
    return marker, pos


def _huff(bits: _Bits, lut) -> int:
    p = bits.pos
    b = bits.buf
    word = (b[p >> 3] << 16 | b[(p >> 3) + 1] << 8 | b[(p >> 3) + 2]) >> (8 - (p & 7)) & 0xFFFF
    e = lut[word]
    if not e:
        raise _Refused(CORRUPT_DATA)
    bits.pos = p + (e >> 8)
    return e & 0xFF


def _get(bits: _Bits, s: int) -> int:
    p = bits.pos
    b = bits.buf
    word = (b[p >> 3] << 24 | b[(p >> 3) + 1] << 16 | b[(p >> 3) + 2] << 8
            | b[(p >> 3) + 3]) >> (32 - (p & 7) - s) & ((1 << s) - 1)
    bits.pos = p + s
    return word


def _seq_mcu(bits, blocks, block_comp, dc_luts, ac_luts, state, coef, ss, se, al):
    last = state[0]
    for blk, k in zip(blocks, block_comp):
        s = _huff(bits, dc_luts[k])
        diff = _extend(_get(bits, s), s) if s else 0
        last[k] = dc = (last[k] + diff + 0x80000000) % (1 << 32) - 0x80000000
        row = coef[blk]
        row[0] = _short(dc)
        lut = ac_luts[k]
        i = 1
        while i < 64:
            rs = _huff(bits, lut)
            r, s = rs >> 4, rs & 15
            if s:
                i += r
                if i > 63:
                    raise _Refused(CORRUPT_DATA)
                row[i] = _extend(_get(bits, s), s)
            elif r == 15:
                i += 15
            else:
                break
            i += 1


def _dc_first(bits, blocks, block_comp, dc_luts, ac_luts, state, coef, ss, se, al):
    last = state[0]
    for blk, k in zip(blocks, block_comp):
        s = _huff(bits, dc_luts[k])
        diff = _extend(_get(bits, s), s) if s else 0
        last[k] = dc = (last[k] + diff + 0x80000000) % (1 << 32) - 0x80000000
        coef[blk, 0] = _short(dc << al)


def _dc_refine(bits, blocks, block_comp, dc_luts, ac_luts, state, coef, ss, se, al):
    for blk in blocks:
        if _get(bits, 1):
            coef[blk, 0] |= 1 << al


def _eob_run(bits: _Bits, r: int) -> int:
    run = 1 << r
    if r:
        run += _get(bits, r)
    return run


def _ac_first(bits, blocks, block_comp, dc_luts, ac_luts, state, coef, ss, se, al):
    blk = blocks[0]
    if state[1] > 0:
        state[1] -= 1
        return
    lut = ac_luts[0]
    row = coef[blk]
    k = ss
    while k <= se:
        rs = _huff(bits, lut)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > se:
                raise _Refused(CORRUPT_DATA)
            row[k] = _short(_extend(_get(bits, s), s) << al)
        elif r == 15:
            k += 15
        else:
            state[1] = _eob_run(bits, r) - 1
            break
        k += 1


def _ac_refine(bits, blocks, block_comp, dc_luts, ac_luts, state, coef, ss, se, al):
    blk = blocks[0]
    p1, m1 = 1 << al, -1 << al
    lut = ac_luts[0]
    row = coef[blk].tolist()
    k = ss
    if state[1] == 0:
        while k <= se:
            rs = _huff(bits, lut)
            r, s = rs >> 4, rs & 15
            if s:
                if s != 1:
                    raise _Refused(CORRUPT_DATA)
                s = p1 if _get(bits, 1) else m1
            elif r != 15:
                state[1] = _eob_run(bits, r)
                break
            while k <= se:
                c = row[k]
                if c:
                    if _get(bits, 1) and not c & p1:
                        row[k] = _short(c + p1 if c >= 0 else c + m1)
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
            if s:
                if k > se:
                    raise _Refused(CORRUPT_DATA)
                row[k] = s
            k += 1
    if state[1] > 0:
        while k <= se:
            c = row[k]
            if c and _get(bits, 1) and not c & p1:
                row[k] = _short(c + p1 if c >= 0 else c + m1)
            k += 1
        state[1] -= 1
    coef[blk] = row


def _check_progression(frame: _Frame, comps, spec) -> None:
    ss, se, ah, al = spec
    if ss == 0:
        bad = se != 0
    else:
        bad = ss > se or se > 63 or len(comps) != 1
    if (ah and al != ah - 1) or al > 13 or bad:
        raise _Refused(PROGRESSION)
    for ci, _, _ in comps:
        bits = frame.comps[ci].coef_bits
        if ss and bits[0] < 0:
            raise _Refused(PROGRESSION)
        for k in range(ss, se + 1):
            if ah != max(bits[k], 0) or (ah == 0 and bits[k] >= 0):
                raise _Refused(PROGRESSION)
            bits[k] = al


def _read_sos(payload: bytes, frame: _Frame):
    if not payload:
        raise _Refused(BAD_SCAN)
    n = payload[0]
    if not 1 <= n <= 4 or len(payload) != 4 + 2 * n:
        raise _Refused(BAD_SCAN)
    comps, seen = [], set()
    for i in range(n):
        cid, t = payload[1 + 2 * i:3 + 2 * i]
        match = [k for k, c in enumerate(frame.comps) if c.cid == cid and k not in seen]
        if not match or (t >> 4) > 3 or (t & 15) > 3:
            raise _Refused(BAD_SCAN)
        seen.add(match[0])
        comps.append((match[0], t >> 4, t & 15))
    if sorted(ci for ci, _, _ in comps) != [ci for ci, _, _ in comps]:
        raise _Refused(BAD_SCAN)
    ss, se, a = payload[1 + 2 * n:4 + 2 * n]
    if n > 1 and sum(frame.comps[ci].h * frame.comps[ci].v for ci, _, _ in comps) > 10:
        raise _Refused(SAMPLING)
    return comps, (ss, se, a >> 4, a & 15)


REFUSED_MARKERS = {0xC3: LOSSLESS, 0xC9: ARITHMETIC, 0xCA: ARITHMETIC, 0xCB: LOSSLESS,
                0xCC: ARITHMETIC, 0xC5: HIERARCHICAL, 0xC6: HIERARCHICAL,
                0xC7: HIERARCHICAL, 0xCD: HIERARCHICAL, 0xCE: HIERARCHICAL,
                0xCF: HIERARCHICAL, 0xDC: DNL}


def _walk(data: bytes):
    """The marker walk, decoding each scan as it comes; returns (frame,
    [blocks, 64] coefficients, whether the components need no colour
    transform: three that are RGB, four that are CMYK, not YCCK)."""
    if data[:3] != b"\xff\xd8\xff":
        raise _Refused(NOT_JPEG)
    pos = 2
    frame: Optional[_Frame] = None
    tables, quant = {}, {}
    restart = 0
    jfif = adobe = False
    transform = None
    coef = None
    marker, pos = _next_marker(data, pos)
    sequential_done = False
    while True:
        if marker == 0xD9:
            break
        if marker in REFUSED_MARKERS:
            raise _Refused(REFUSED_MARKERS[marker])
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            marker, pos = _next_marker(data, pos)
            continue
        if marker in (0xC0, 0xC1, 0xC2, 0xC4, 0xDA, 0xDB, 0xDD, 0xFE) or 0xE0 <= marker <= 0xEF:
            payload, pos = _segment(data, pos)
        else:
            raise _Refused(BAD_MARKER)
        if marker in (0xC0, 0xC1, 0xC2):
            if frame is not None:
                raise _Refused(BAD_MARKER)
            frame = _Frame(marker, payload)
            if frame.width * frame.height > MAX_PIXELS:
                raise _Refused(SIZE)
            coef = np.zeros((frame.blocks, 64), np.int32)
        elif marker == 0xC4:
            _read_dht(payload, tables)
        elif marker == 0xDB:
            _read_dqt(payload, quant)
        elif marker == 0xDD:
            if len(payload) != 2:
                raise _Refused(BAD_MARKER)
            restart = struct.unpack(">H", payload)[0]
        elif marker == 0xE0:
            jfif = jfif or (len(payload) >= 14 and payload[:5] == b"JFIF\x00")
        elif marker == 0xEE:
            if len(payload) >= 12 and payload[:5] == b"Adobe":
                adobe, transform = True, payload[11]
        elif marker == 0xDA:
            if frame is None or sequential_done:
                raise _Refused(BAD_MARKER)
            comps, spec = _read_sos(payload, frame)
            if frame.progressive:
                _check_progression(frame, comps, spec)
            else:
                if spec != (0, 63, 0, 0):
                    raise _Refused(BAD_SCAN)
                if any(frame.comps[ci].scans for ci, _, _ in comps):
                    raise _Refused(BAD_SCAN)
                sequential_done = all(c.scans == 0 for c in frame.comps) and \
                    len(comps) == len(frame.comps)
            for ci, _, _ in comps:
                c = frame.comps[ci]
                if c.qt is None:
                    if c.tq not in quant:
                        raise _Refused(BAD_TABLE)
                    c.qt = quant[c.tq].copy()
                c.scans += 1
            marker, pos = _decode_scan(data, pos, frame, comps, spec, tables, restart, coef)
            continue
        marker, pos = _next_marker(data, pos)
    if frame is None or not any(c.scans for c in frame.comps):
        raise _Refused(BAD_MARKER)
    if frame.progressive:
        if any(b != 0 for c in frame.comps for b in c.coef_bits[:SMOOTHED_COEFS]):
            raise _Refused(INCOMPLETE)
    rgb = False
    if len(frame.comps) == 3:
        if jfif:
            rgb = False
        elif adobe:
            rgb = transform == 0
        else:
            rgb = [c.cid for c in frame.comps] == [82, 71, 66]
    elif len(frame.comps) == 4:
        rgb = not adobe or transform == 0  # else YCCK (jdapimin.c)
    return frame, coef, rgb


def decode_plain(data: bytes, color: int = -1) -> np.ndarray:
    """JPEG bytes → [h, w] uint8 L (one component), [h, w, 3] uint8 RGB or
    [h, w, 4] uint8 CMYK as PIL reads it, libjpeg-turbo's samples; raises
    UnsupportedImage with the reason. `color` -1 lets the markers pick the
    colour transform, 0 forces the YCbCr (YCCK) conversion, 1 none."""
    try:
        return _decode(data, color)
    except _Refused as e:
        raise UnsupportedImage(REASONS[e.code]) from None


def _decode(data: bytes, color: int = -1) -> np.ndarray:
    frame, coef, rgb = _walk(data)
    if color >= 0:
        rgb = color == 1
    planes = []
    for c in frame.comps:
        blocks = coef[c.offset:c.offset + c.bw_pad * c.bh_pad]
        qt = c.qt if c.qt is not None else np.zeros(64, np.int64)
        px = idct_islow(blocks, qt).reshape(c.bh_pad, c.bw_pad, 8, 8)
        plane = px.transpose(0, 2, 1, 3).reshape(c.bh_pad * 8, c.bw_pad * 8)[:c.dh, :c.dw]
        up = upsample(plane, frame.hmax // c.h, frame.vmax // c.v, c.dw > 2)
        planes.append(up[:frame.height, :frame.width])
    if len(planes) == 1:
        return np.ascontiguousarray(planes[0])
    if len(planes) == 4:
        # libjpeg's CMYK (YCCK: 255 - RGB, K as is), then PIL's inversion
        if rgb:
            return 255 - np.stack(planes, axis=2)
        return np.concatenate([ycc_to_rgb(*planes[:3]), 255 - planes[3][..., None]], axis=2)
    if rgb:
        return np.stack(planes, axis=2)
    return ycc_to_rgb(*planes)
