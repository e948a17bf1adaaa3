"""A lossy WebP encoder for thumbnails: one VP8 key frame of an RGB image.

The JAX package's ``encode_webp`` saves through PIL, that is libwebp at
quality 30. The machine with the card has no PIL, so the port writes its
own key frame in a ``RIFF``/``WEBP``/``VP8 `` file, which any WebP decoder
reads. Its bytes are not libwebp's (that would mean porting libwebp's
rate-distortion search); its quantiser and loop filter are libwebp's for
quality 30 with one segment:

- the quantiser index from ``VP8SetSegmentParams``' mapping
  (``QualityToCompression``: 52 at quality 30), and its chroma DC delta
  (-4 · sns_strength / 100 with the default strength of 50: -2);
- the normal loop filter at the level ``SetupFilterStrength`` gives the
  default filter strength of 60 at that quantiser, sharpness 0.

``csrc/webpenc.cpp`` holds the encoder and says what it does; ``encode_plain``
here is its plain version, step for step and integer for integer (the
macroblocks by wavefronts of x + y, whose predictions read only earlier
wavefronts), so the two give the same bytes. The tests and ``chip_smoke.py``
hold one against the other; nothing on the main path runs the plain
version.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from . import webp as W
from . import webp_tables as T

QUALITY = 30          # thumbnail/mod.rs, the JAX TARGET_QUALITY
SNS_STRENGTH = 50     # libwebp's default
FILTER_STRENGTH = 60  # libwebp's default
MAX_SIDE = 16383      # VP8's 14-bit sides

ZIGZAG = np.array(W.ZIGZAG)
BANDS = W.BANDS
FREQ_SHARPENING = np.array([0, 30, 60, 90, 30, 60, 90, 90, 60, 90, 90, 90, 90, 90, 90, 90])
BIAS = ((96, 110), (96, 108), (110, 115))  # y1, y2, uv: (dc, ac) in 1/256
QFIX = 17
MAX_LEVEL = 2047
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# A bit's cost at probability p/256 of a zero, in 1/256 bits.
COST = tuple(int(round(-math.log2(max(p, 1) / 256) * 256)) for p in range(256))


def quantizer() -> int:
    """libwebp's quantiser index for QUALITY with one segment
    (QualityToCompression; the segment's alpha 0)."""
    c = QUALITY / 100
    linear = c * 2 / 3 if c < 0.75 else 2 * c - 1
    return min(max(int(127 * (1 - linear ** (1 / 3))), 0), 127)


def uv_dc_delta() -> int:
    return min(max(-4 * SNS_STRENGTH // 100, -15), 15)


def filter_level(q: int) -> int:
    """SetupFilterStrength at the default strength, sharpness 0, one
    segment of beta 0: kLevelsFromDelta[0] is the identity below 64."""
    qstep = T.AC_TABLE[q] >> 2
    f = min(qstep, 63) * (5 * FILTER_STRENGTH) // 256
    return 0 if f < 2 else min(f, 63)


def params() -> tuple:
    q = quantizer()
    return q, uv_dc_delta(), filter_level(q)


def riff(frame: bytes) -> bytes:
    chunk = b"VP8 " + struct.pack("<I", len(frame)) + frame + b"\x00" * (len(frame) & 1)
    return b"RIFF" + struct.pack("<I", 4 + len(chunk)) + b"WEBP" + chunk


def encode(rgb: np.ndarray, *, native: bool = True) -> bytes:
    """[h, w, 3] uint8 RGB → a lossy WebP file's bytes at QUALITY."""
    from .imgdecode import UnsupportedImage

    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3 or not 1 <= min(rgb.shape[:2]):
        raise ValueError(f"webp encode: {rgb.shape}")
    if max(rgb.shape[:2]) > MAX_SIDE:  # libwebp refuses these too
        raise UnsupportedImage(f"WebP side past {MAX_SIDE}: {rgb.shape[:2]}")
    if native:
        from .. import native as plane
        frame = plane.webp_encode(rgb, *params())
    else:
        frame = encode_plain(rgb, *params())
    return riff(frame)


# -- the plain version -------------------------------------------------------


def _matrix(dc: int, ac: int, kind: int) -> dict:
    q = np.array([dc] + [ac] * 15, np.int64)
    iq = (1 << QFIX) // q
    bias = np.array([BIAS[kind][0]] + [BIAS[kind][1]] * 15, np.int64) << (QFIX - 8)
    return {"q": q, "iq": iq, "bias": bias, "zthresh": ((1 << QFIX) - 1 - bias) // iq,
            "sharpen": (FREQ_SHARPENING * q) >> 11 if kind == 0 else np.zeros(16, np.int64)}


def _wrap16(v: np.ndarray) -> np.ndarray:
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _quantize(coef: np.ndarray, m: dict, first: int) -> tuple:
    """[..., 16] raster coefficients → ([..., 16] zigzag levels, [..., 16]
    dequantised raster coefficients)."""
    zz = coef[..., ZIGZAG]
    sign = zz < 0
    c = np.abs(zz) + m["sharpen"][ZIGZAG]
    level = np.minimum((c * m["iq"][ZIGZAG] + m["bias"][ZIGZAG]) >> QFIX, MAX_LEVEL)
    level = np.where(c > m["zthresh"][ZIGZAG], level, 0)
    level[..., :first] = 0
    level = np.where(sign, -level, level)
    deq = np.zeros_like(coef)
    deq[..., ZIGZAG] = _wrap16(level * m["q"][ZIGZAG])
    return level, deq


def _ftransform(d: np.ndarray) -> np.ndarray:
    """libwebp's FTransform of [..., 4, 4] differences → [..., 16]."""
    d0, d1, d2, d3 = (d[..., k] for k in range(4))  # [..., row]
    a0, a1, a2, a3 = d0 + d3, d1 + d2, d1 - d2, d0 - d3
    t = np.stack([(a0 + a1) * 8, (a2 * 2217 + a3 * 5352 + 1812) >> 9, (a0 - a1) * 8,
                  (a3 * 2217 - a2 * 5352 + 937) >> 9], axis=-1)  # [..., row, k]
    a0, a1 = t[..., 0, :] + t[..., 3, :], t[..., 1, :] + t[..., 2, :]
    a2, a3 = t[..., 1, :] - t[..., 2, :], t[..., 0, :] - t[..., 3, :]
    out = np.stack([(a0 + a1 + 7) >> 4, ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0),
                    (a0 - a1 + 7) >> 4, (a3 * 2217 - a2 * 5352 + 51000) >> 16], axis=-2)
    return out.reshape(out.shape[:-2] + (16,))


def _fwht(dc: np.ndarray) -> np.ndarray:
    """FTransformWHT of [..., 16] block DCs (raster) → [..., 16]."""
    d = dc.reshape(dc.shape[:-1] + (4, 4))  # [..., row i, k]
    a0, a1 = d[..., 0] + d[..., 2], d[..., 1] + d[..., 3]
    a2, a3 = d[..., 1] - d[..., 3], d[..., 0] - d[..., 2]
    t = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], axis=-1)  # [..., i, k]
    a0, a1 = t[..., 0, :] + t[..., 2, :], t[..., 1, :] + t[..., 3, :]
    a2, a3 = t[..., 1, :] - t[..., 3, :], t[..., 0, :] - t[..., 2, :]
    out = np.stack([(a0 + a1) >> 1, (a3 + a2) >> 1, (a3 - a2) >> 1, (a0 - a1) >> 1], axis=-2)
    return out.reshape(out.shape[:-2] + (16,))


def _blocks(mb: np.ndarray, per_row: int) -> np.ndarray:
    """[m, 4·per_row, 4·per_row] → [m, per_row², 4, 4] (raster blocks)."""
    m = mb.shape[0]
    return mb.reshape(m, per_row, 4, per_row, 4).transpose(0, 1, 3, 2, 4).reshape(
        m, per_row * per_row, 4, 4)


def _gather(plane: np.ndarray, my: np.ndarray, mx: np.ndarray, size: int) -> np.ndarray:
    k = np.arange(size)
    return plane[(my * size)[:, None, None] + k[None, :, None],
                 (mx * size)[:, None, None] + k[None, None, :]]


def _yuv(rgb: np.ndarray, mb_h: int, mb_w: int) -> tuple:
    h, w, _ = rgb.shape
    pad = np.pad(rgb.astype(np.int64), ((0, 16 * mb_h - h), (0, 16 * mb_w - w), (0, 0)),
                 mode="edge")
    r, g, b = pad[..., 0], pad[..., 1], pad[..., 2]
    y = (16839 * r + 33059 * g + 6420 * b + (16 << 16) + (1 << 15)) >> 16

    def sum4(p):
        return p.reshape(8 * mb_h, 2, 8 * mb_w, 2).sum(axis=(1, 3))

    r4, g4, b4 = sum4(r), sum4(g), sum4(b)
    u = (-9719 * r4 - 19081 * g4 + 28800 * b4 + (1 << 17) + (128 << 18)) >> 18
    v = (28800 * r4 - 24116 * g4 - 4684 * b4 + (1 << 17) + (128 << 18)) >> 18
    return y, np.clip(u, 0, 255), np.clip(v, 0, 255)


def _reconstruct(rgb: np.ndarray, q: int, uv_dc: int) -> dict:
    """Modes and zigzag levels of every macroblock, by wavefronts."""
    h, w, _ = rgb.shape
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    Y, U, V = _yuv(rgb, mb_h, mb_w)
    RY, RU, RV = np.zeros_like(Y), np.zeros_like(U), np.zeros_like(V)
    dc, ac = T.DC_TABLE, T.AC_TABLE
    m_y1 = _matrix(dc[q], ac[q], 0)
    m_y2 = _matrix(dc[q] * 2, max(8, (ac[q] * 101581) >> 16), 1)
    m_uv = _matrix(dc[min(max(q + uv_dc, 0), 117)], ac[q], 2)
    out = {"ymode": np.zeros((mb_h, mb_w), np.int64), "uvmode": np.zeros((mb_h, mb_w), np.int64),
           "y2": np.zeros((mb_h, mb_w, 16), np.int64),
           "y": np.zeros((mb_h, mb_w, 16, 16), np.int64),
           "uv": np.zeros((mb_h, mb_w, 8, 16), np.int64)}
    ys = np.arange(mb_h)
    for t in range(mb_w + mb_h - 1):
        xs = t - ys
        keep = (xs >= 0) & (xs < mb_w)
        my, mx = ys[keep], xs[keep]
        m = len(my)
        src = _gather(Y, my, mx, 16)
        preds = W.predict_all(*W.neighbours(RY, my, mx, 16), my, mx, 16)
        pick = ((src[None] - preds) ** 2).sum(axis=(2, 3)).argmin(axis=0)
        pred = preds[pick, np.arange(m)]
        coef = _ftransform(_blocks(src, 4) - _blocks(pred, 4))  # [m, 16, 16]
        y2, y2deq = _quantize(_fwht(coef[..., 0]), m_y2, 0)
        dcs = W.wht_batch(y2deq)
        lv, deq = _quantize(coef, m_y1, 1)
        deq[..., 0] = dcs
        res = W._idct(deq.reshape(-1, 16)).reshape(m, 16, 4, 4)
        W.put_blocks(RY, my, mx, np.clip(pred + W.blocks_to_plane(res, 4), 0, 255))
        out["ymode"][my, mx], out["y2"][my, mx], out["y"][my, mx] = pick, y2, lv
        src_u, src_v = _gather(U, my, mx, 8), _gather(V, my, mx, 8)
        pu = W.predict_all(*W.neighbours(RU, my, mx, 8), my, mx, 8)
        pv = W.predict_all(*W.neighbours(RV, my, mx, 8), my, mx, 8)
        err = ((src_u[None] - pu) ** 2).sum(axis=(2, 3)) + ((src_v[None] - pv) ** 2).sum(
            axis=(2, 3))
        pick = err.argmin(axis=0)
        out["uvmode"][my, mx] = pick
        for plane, s, preds_c, at in ((RU, src_u, pu, 0), (RV, src_v, pv, 4)):
            pred = preds_c[pick, np.arange(m)]
            lv, deq = _quantize(_ftransform(_blocks(s, 2) - _blocks(pred, 2)), m_uv, 0)
            res = W._idct(deq.reshape(-1, 16)).reshape(m, 4, 4, 4)
            W.put_blocks(plane, my, mx, np.clip(pred + W.blocks_to_plane(res, 2), 0, 255))
            out["uv"][my, mx, at:at + 4] = lv
    return out


def _slot(kind: int, n: int, ctx: int) -> int:
    return ((kind * 8 + BANDS[n]) * 3 + ctx) * 11


def _block_tokens(tokens: list, kind: int, ctx: int, zz: list, first: int) -> int:
    """One block's tokens as (slot, fixed probability, bit); returns the
    decoder's nz (a non-zero level from `first` on)."""
    put = tokens.append
    n = first
    p = _slot(kind, n, ctx)
    nonzero = [k for k in range(first, 16) if zz[k]]
    if not nonzero:
        put((p, 0, 0))
        return 0
    last = nonzero[-1]
    while n < 16:
        if n > last:
            put((p, 0, 0))
            return 1
        put((p, 0, 1))
        while zz[n] == 0:
            put((p + 1, 0, 0))
            n += 1
            p = _slot(kind, n, 0)
        put((p + 1, 0, 1))
        v = abs(zz[n])
        if v == 1:
            put((p + 2, 0, 0))
            p = _slot(kind, n + 1, 1)
        else:
            put((p + 2, 0, 1))
            if v <= 4:
                put((p + 3, 0, 0))
                if v == 2:
                    put((p + 4, 0, 0))
                else:
                    put((p + 4, 0, 1))
                    put((p + 5, 0, v - 3))
            elif v <= 10:
                put((p + 3, 0, 1))
                put((p + 6, 0, 0))
                if v <= 6:
                    put((p + 7, 0, 0))
                    put((-1, 159, v - 5))
                else:
                    put((p + 7, 0, 1))
                    put((-1, 165, (v - 7) >> 1))
                    put((-1, 145, (v - 7) & 1))
            else:
                put((p + 3, 0, 1))
                put((p + 6, 0, 1))
                cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
                put((p + 8, 0, cat >> 1))
                put((p + 9 + (cat >> 1), 0, cat & 1))
                extra = v - (3 + (8 << cat))
                probs = CAT_PROBS[cat]
                for k, prob in enumerate(probs):
                    put((-1, prob, (extra >> (len(probs) - 1 - k)) & 1))
            p = _slot(kind, n + 1, 2)
        put((-1, 128, int(zz[n] < 0)))
        n += 1
    return 1


def _mb_tokens(tokens: list, y2: list, y: list, uv: list, top: list, left: list) -> None:
    nz = _block_tokens(tokens, 1, top[1] + left[1], y2, 0)
    top[1] = left[1] = nz
    tnz, lnz = top[0] & 0x0F, left[0] & 0x0F
    for yy in range(4):
        lb = lnz & 1
        for xx in range(4):
            lb = _block_tokens(tokens, 0, lb + (tnz & 1), y[4 * yy + xx], 1)
            tnz = (tnz >> 1) | (lb << 7)
        tnz >>= 4
        lnz = (lnz >> 1) | (lb << 7)
    out_t, out_l = tnz, lnz >> 4
    for ch in (0, 2):
        tnz = (top[0] >> (4 + ch)) & 0xFF
        lnz = (left[0] >> (4 + ch)) & 0xFF
        for yy in range(2):
            lb = lnz & 1
            for xx in range(2):
                lb = _block_tokens(tokens, 2, lb + (tnz & 1), uv[2 * ch + 2 * yy + xx], 0)
                tnz = (tnz >> 1) | (lb << 3)
            tnz >>= 2
            lnz = (lnz >> 1) | (lb << 5)
        out_t |= (tnz << 4) << ch
        out_l |= (lnz & 0xF0) << ch
    top[0] = out_t & 0xFF
    left[0] = out_l & 0xFF


class BoolWriter:
    """The VP8 boolean encoder (RFC 6386 section 7.3); csrc/webpenc.cpp's
    ``BoolWriter`` bit for bit."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.count = 255, 0, 24

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.count -= 1
            if not self.count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.count = 8

    def _carry(self) -> None:
        i = len(self.out)
        while i > 0 and self.out[i - 1] == 255:
            i -= 1
            self.out[i] = 0
        if i > 0:
            self.out[i - 1] += 1

    def bits(self, value: int, n: int) -> None:
        for k in range(n - 1, -1, -1):
            self.put((value >> k) & 1, 0x80)

    def finish(self) -> bytes:
        c, v = self.count, self.bottom
        if c < 32 and v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _bit_cost(bit: int, prob: int) -> int:
    return COST[255 - prob] if bit else COST[prob]


def encode_plain(rgb: np.ndarray, q: int, uv_dc: int, level: int) -> bytes:
    """Plain version of ``native.webp_encode``: [h, w, 3] uint8 RGB → the
    VP8 key frame's bytes."""
    h, w, _ = rgb.shape
    mb_w, mb_h = (w + 15) >> 4, (h + 15) >> 4
    mbs = _reconstruct(rgb, q, uv_dc)
    y2_all, y_all, uv_all = mbs["y2"].tolist(), mbs["y"].tolist(), mbs["uv"].tolist()
    skip = ~((mbs["y2"] != 0).any(axis=-1) | (mbs["y"] != 0).any(axis=(-1, -2))
             | (mbs["uv"] != 0).any(axis=(-1, -2)))
    n_skip, total = int(skip.sum()), mb_w * mb_h
    skip_proba = (total - n_skip) * 255 // total
    use_skip = n_skip > 0 and skip_proba < 250
    skip_p = max(skip_proba, 1)
    tokens: list = []
    top_nz = [[0, 0] for _ in range(mb_w)]
    for my in range(mb_h):
        left = [0, 0]
        for mx in range(mb_w):
            top = top_nz[mx]
            if use_skip and skip[my, mx]:
                top[0] = left[0] = top[1] = left[1] = 0
            else:
                _mb_tokens(tokens, y2_all[my][mx], y_all[my][mx], uv_all[my][mx], top, left)
    ones, totals = np.zeros(1056, np.int64), np.zeros(1056, np.int64)
    arr = np.array([(s, b) for s, _, b in tokens if s >= 0], np.int64).reshape(-1, 2)
    np.add.at(ones, arr[:, 0], arr[:, 1])
    np.add.at(totals, arr[:, 0], 1)
    probs = list(T.COEFFS_PROBA0)
    updated = [False] * 1056
    for i in np.flatnonzero(totals).tolist():
        nb, tot = int(ones[i]), int(totals[i])
        new_p = max(255 - nb * 255 // tot if nb else 255, 1)
        old_p, up = T.COEFFS_PROBA0[i], T.COEFFS_UPDATE_PROBA[i]
        old_cost = nb * _bit_cost(1, old_p) + (tot - nb) * _bit_cost(0, old_p) + _bit_cost(0, up)
        new_cost = (nb * _bit_cost(1, new_p) + (tot - nb) * _bit_cost(0, new_p)
                    + _bit_cost(1, up) + 8 * 256)
        if old_cost > new_cost:
            probs[i], updated[i] = new_p, True
    hdr = BoolWriter()
    for bit in (0, 0, 0, 0):  # colour space, clamping, no segmentation, normal filter
        hdr.put(bit, 0x80)
    hdr.bits(level, 6)
    hdr.bits(0, 3)  # sharpness
    hdr.put(0, 0x80)  # no loop filter deltas
    hdr.bits(0, 2)  # one token partition
    hdr.bits(q, 7)
    for d in (0, 0, 0, uv_dc, 0):
        hdr.put(int(d != 0), 0x80)
        if d:
            hdr.bits(abs(d), 4)
            hdr.put(int(d < 0), 0x80)
    hdr.put(0, 0x80)  # refresh entropy probabilities
    for i in range(1056):
        hdr.put(int(updated[i]), T.COEFFS_UPDATE_PROBA[i])
        if updated[i]:
            hdr.bits(probs[i], 8)
    hdr.put(int(use_skip), 0x80)
    if use_skip:
        hdr.bits(skip_p, 8)
    ymode, uvmode = mbs["ymode"].tolist(), mbs["uvmode"].tolist()
    for my in range(mb_h):
        for mx in range(mb_w):
            if use_skip:
                hdr.put(int(skip[my, mx]), skip_p)
            hdr.put(1, 145)  # 16x16 luma
            m = ymode[my][mx]  # 0 DC, 1 TM, 2 V, 3 H
            if m in (1, 3):
                hdr.put(1, 156)
                hdr.put(int(m == 1), 128)
            else:
                hdr.put(0, 156)
                hdr.put(int(m == 2), 163)
            uv = uvmode[my][mx]
            hdr.put(int(uv != 0), 142)
            if uv:
                hdr.put(int(uv != 2), 114)
                if uv != 2:
                    hdr.put(int(uv != 3), 183)
    first = hdr.finish()
    part = BoolWriter()
    for slot, fixed, bit in tokens:
        part.put(bit, probs[slot] if slot >= 0 else fixed)
    tag = (len(first) << 5) | (1 << 4)
    return (struct.pack("<I", tag)[:3] + b"\x9d\x01\x2a" + struct.pack("<HH", w, h) + first
            + part.finish())
