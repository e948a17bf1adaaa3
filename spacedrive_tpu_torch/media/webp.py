"""WebP to L, as PIL opens it (Pillow 12.1.0 over libwebp 1.6.0).

PIL opens every WebP, still or animated, through libwebp's
``WebPAnimDecoder`` in ``MODE_RGBA`` (not premultiplied) and takes frame
0: the canvas zero-filled (transparent black), the frame decoded into it
at its offset. ``convert("L")`` is then ``L24`` of the canvas' RGB; alpha
never changes L, but a frame whose alpha fails to decode fails the whole
image. This module gives that L plane, bit for bit:

- the container, as ``WebPDemux`` validates it (``_demux``): the RIFF
  size (a file shorter than it is refused; bytes past it are ignored),
  every chunk size, ``VP8X`` (flags, canvas), ``ALPH`` before its image,
  ``ANIM``/``ANMF`` (frame offsets and bounds), ICCP/EXIF/XMP skipped;
- VP8L (lossless, ``_Lossless``): the transforms (predictor, all 14
  modes; cross-colour; subtract-green; colour indexing with pixel
  bundling), the Huffman groups (simple and normal codes, the code-length
  code, the meta Huffman image), LZ77 backward references with the
  120-entry distance map, the colour cache; a stream that reads past its
  end is refused as libwebp refuses it;
- VP8 key frames (lossy, ``_Lossy``, RFC 6386): the boolean decoder, the
  frame header, 1 to 8 token partitions, the coefficient probabilities,
  the intra modes, dequantisation, the inverse WHT and DCT (libwebp's C
  arithmetic, coefficients held in 16 bits), reconstruction with the
  127/129 edges, the simple and normal loop filters; then libwebp's fancy
  upsampling of the 4:2:0 chroma and its fixed-point YUV to RGB, no
  dithering;
- ``ALPH`` (raw, or a headerless VP8L stream, any of the four filters),
  validated as libwebp validates it; the alpha values do not reach L, and
  ``decode_image`` unfilters them where PIL's mode is RGBA.

Refused with a reason from ``REASONS``: what libwebp refuses, and nothing
else. ``native.webp_lossless``, ``native.webp_alpha`` and
``native.webp_lossy`` (``csrc/webpdec.cpp``) are the native versions of
the three bitstream decoders here, with the same status codes; the
container walk and the canvas are shared.
"""

from __future__ import annotations

import struct

import numpy as np

from . import webp_tables as T
from .imgdecode import UnsupportedImage, check_size

# Status codes: must match `enum Status` in csrc/webpdec.cpp.
OK = 0
TRUNCATED = 1
BAD_CONTAINER = 2
BAD_FRAME = 3
LOSSLESS_HEADER = 4
LOSSLESS_TRANSFORM = 5
LOSSLESS_CODE = 6
LOSSLESS_DATA = 7
LOSSLESS_END = 8
LOSSY_HEADER = 9
LOSSY_PARTITIONS = 10
LOSSY_END = 11
ALPHA_HEADER = 12

REASONS = {
    TRUNCATED: "truncated WebP: the file is shorter than its RIFF size",
    BAD_CONTAINER: "bad WebP container (RIFF, chunk sizes, VP8X or chunk order)",
    BAD_FRAME: "bad WebP frame (header, size or bounds on the canvas)",
    LOSSLESS_HEADER: "bad VP8L header",
    LOSSLESS_TRANSFORM: "bad VP8L transform",
    LOSSLESS_CODE: "bad VP8L Huffman code",
    LOSSLESS_DATA: "bad VP8L backward reference",
    LOSSLESS_END: "VP8L data ends before the image",
    LOSSY_HEADER: "bad VP8 frame header",
    LOSSY_PARTITIONS: "bad VP8 partition sizes",
    LOSSY_END: "VP8 data ends before the frame",
    ALPHA_HEADER: "bad WebP ALPH chunk",
}

MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
MAX_IMAGE_AREA = 1 << 32
ANIMATION, ALPHA_FLAG, ALL_VALID_FLAGS = 0x02, 0x10, 0x3E


def _refuse(code: int):
    raise UnsupportedImage(REASONS[code])


def _le24(b: bytes, at: int) -> int:
    return b[at] | b[at + 1] << 8 | b[at + 2] << 16


# -- container ---------------------------------------------------------------


class _Frame:
    """One frame as WebPDemux stores it: chunk offsets and sizes (header
    and padded payload) of its ALPH and image chunks."""

    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.alpha = None       # (offset, size)
        self.image = None       # (offset, size, lossless)
        self.has_alpha = False
        self.number = 0
        self.complete = False


def _features(chunk: bytes, size: int):
    """WebPGetFeatures of an image chunk (header + padded payload):
    (width, height, has alpha, lossless), or None where it fails."""
    payload = chunk[8:]
    if chunk[:4] == b"VP8L":
        if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
            return None
        bits = int.from_bytes(payload[1:5], "little")
        return (bits & 0x3FFF) + 1, (bits >> 14 & 0x3FFF) + 1, bool(bits >> 28 & 1), True
    if len(payload) < 10 or payload[3:6] != b"\x9d\x01\x2a":
        return None
    bits = payload[0] | payload[1] << 8 | payload[2] << 16
    w = (payload[6] | payload[7] << 8) & 0x3FFF
    h = (payload[8] | payload[9] << 8) & 0x3FFF
    if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or (bits >> 5) >= size \
            or not w or not h:
        return None
    return w, h, False, False


class _Demux:
    """libwebp's WebPDemux (not partial) over the whole file; `frames`
    as it stores them, or a refusal."""

    def __init__(self, data: bytes):
        if len(data) < 20:
            _refuse(TRUNCATED)
        riff_size = struct.unpack_from("<I", data, 4)[0]
        if riff_size < 8 or riff_size > MAX_CHUNK_PAYLOAD:
            _refuse(BAD_CONTAINER)
        self.end = riff_size + 8
        if len(data) < self.end:
            _refuse(TRUNCATED)
        self.buf = data[:self.end]
        self.flags = 0
        self.extended = False
        self.canvas = (0, 0)
        self.frames = []
        pos = 12
        if self.buf[pos:pos + 4] == b"VP8X":
            self._vp8x(pos)
        else:
            self._single(pos)
        self._validate()

    def _remaining(self, pos: int) -> int:
        return self.end - pos

    def _chunk(self, pos: int):
        """(fourcc, size, padded size) of the chunk at `pos`, refused where
        its size cannot fit in the RIFF."""
        if self._remaining(pos) < 8:
            _refuse(BAD_CONTAINER)
        fourcc = self.buf[pos:pos + 4]
        size = struct.unpack_from("<I", self.buf, pos + 4)[0]
        if size > MAX_CHUNK_PAYLOAD:
            _refuse(BAD_CONTAINER)
        padded = size + (size & 1)
        if padded > self._remaining(pos + 8):
            _refuse(BAD_CONTAINER)
        return fourcc, size, padded

    def _store_frame(self, pos: int, number: int, min_size: int, frame: _Frame) -> int:
        """StoreFrame: the ALPH and image chunks from `pos`; returns the
        position after them."""
        if self._remaining(pos) < 8 or self._remaining(pos) < min_size:
            _refuse(BAD_CONTAINER)
        alpha_chunks = image_chunks = 0
        while True:
            fourcc, size, padded = self._chunk(pos)
            if fourcc == b"ALPH":
                if alpha_chunks:
                    return pos
                alpha_chunks = 1
                frame.alpha = (pos, 8 + padded)
                frame.has_alpha = True
                frame.number = number
            elif fourcc in (b"VP8L", b"VP8 "):
                if fourcc == b"VP8L" and alpha_chunks:
                    _refuse(BAD_CONTAINER)  # VP8L carries its own alpha
                if image_chunks:
                    return pos
                feats = _features(self.buf[pos:pos + 8 + padded], size)
                if feats is None:
                    _refuse(BAD_FRAME)
                image_chunks = 1
                frame.image = (pos, 8 + padded, feats[3])
                frame.width, frame.height = feats[0], feats[1]
                frame.has_alpha |= feats[2]
                frame.number = number
                frame.complete = True
            else:
                return pos
            pos += 8 + padded
            if pos == self.end:
                return pos
            if self._remaining(pos) < 8:
                _refuse(BAD_CONTAINER)

    def _add(self, frame: _Frame) -> None:
        if self.frames and not self.frames[-1].complete:
            _refuse(BAD_CONTAINER)
        self.frames.append(frame)

    def _single(self, pos: int) -> int:
        """ParseSingleImage."""
        if self.frames or self._remaining(pos) < 8:
            _refuse(BAD_CONTAINER)
        frame = _Frame()
        pos = self._store_frame(pos, 1, 0, frame)
        if not self.flags & ALPHA_FLAG and frame.alpha is not None:
            frame.alpha, frame.has_alpha = None, False
        if not self.extended and frame.width > 0 and frame.height > 0:
            self.canvas = (frame.width, frame.height)
            self.flags |= ALPHA_FLAG if frame.has_alpha else 0
        self._add(frame)
        return pos

    def _vp8x(self, pos: int) -> None:
        """ParseVP8X and ParseVP8XChunks."""
        self.extended = True
        size = struct.unpack_from("<I", self.buf, pos + 4)[0]
        if size > MAX_CHUNK_PAYLOAD or size < 10:
            _refuse(BAD_CONTAINER)
        size += size & 1
        pos += 8
        if size > self._remaining(pos):
            _refuse(BAD_CONTAINER)
        self.flags = self.buf[pos]
        self.canvas = (1 + _le24(self.buf, pos + 4), 1 + _le24(self.buf, pos + 7))
        if self.canvas[0] * self.canvas[1] >= MAX_IMAGE_AREA:
            _refuse(BAD_CONTAINER)
        pos += size
        if self._remaining(pos) < 8:
            _refuse(BAD_CONTAINER)
        animated = bool(self.flags & ANIMATION)
        anim_chunks = 0
        while True:
            fourcc, size, padded = self._chunk(pos)
            if fourcc == b"VP8X":
                _refuse(BAD_CONTAINER)
            elif fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animated:
                    _refuse(BAD_CONTAINER)
                pos = self._single(pos)
            elif fourcc == b"ANIM":
                if padded < 6:
                    _refuse(BAD_CONTAINER)
                anim_chunks = 1  # its background colour and loop count change no pixel
                pos += 8 + padded
            elif fourcc == b"ANMF":
                if not anim_chunks:
                    _refuse(BAD_CONTAINER)
                pos = self._anmf(pos + 8, padded, animated)
            else:
                pos += 8 + padded
            if pos == self.end:
                return
            if self._remaining(pos) < 8:
                _refuse(BAD_CONTAINER)

    def _anmf(self, pos: int, chunk_size: int, animated: bool) -> int:
        """ParseAnimationFrame; `pos` is the ANMF payload."""
        if 16 > self._remaining(pos) or chunk_size < 16:
            _refuse(BAD_CONTAINER)
        frame = _Frame()
        frame.x = 2 * _le24(self.buf, pos)
        frame.y = 2 * _le24(self.buf, pos + 3)
        frame.width = 1 + _le24(self.buf, pos + 6)
        frame.height = 1 + _le24(self.buf, pos + 9)
        if frame.width * frame.height >= MAX_IMAGE_AREA:
            _refuse(BAD_CONTAINER)
        pos += 16
        start = pos
        pos = self._store_frame(pos, len(self.frames) + 1, chunk_size - 16, frame)
        if pos - start > chunk_size - 16:
            _refuse(BAD_CONTAINER)
        if animated and frame.number > 0:
            self._add(frame)
        return pos

    def _validate(self) -> None:
        """IsValidSimpleFormat / IsValidExtendedFormat."""
        w, h = self.canvas
        if w <= 0 or h <= 0 or not self.frames:
            _refuse(BAD_CONTAINER)
        if not self.extended:
            if self.frames[0].width <= 0 or self.frames[0].height <= 0:
                _refuse(BAD_FRAME)
            return
        if self.flags & ~ALL_VALID_FLAGS & 0xFF:
            _refuse(BAD_CONTAINER)
        animated = bool(self.flags & ANIMATION)
        for f in self.frames:
            if not animated and f.number > 1:
                _refuse(BAD_CONTAINER)
            if not f.complete:
                _refuse(BAD_CONTAINER)
            if f.alpha is not None and f.alpha[0] > f.image[0]:
                _refuse(BAD_CONTAINER)
            if f.width <= 0 or f.height <= 0:
                _refuse(BAD_FRAME)
            if not animated and (f.x or f.y or f.width != w or f.height != h):
                _refuse(BAD_FRAME)
            if animated and (f.x + f.width > w or f.y + f.height > h):
                _refuse(BAD_FRAME)

    def first_frame(self):
        """(frame, image payload from its start to the fragment's end,
        ALPH payload or None) of frame 1, as GetFramePayload cuts it."""
        f = self.frames[0]
        img_off, img_size, _ = f.image
        payload = self.buf[img_off + 8:img_off + img_size]
        alpha = None
        if f.alpha is not None:
            a_off = f.alpha[0]
            a_len = struct.unpack_from("<I", self.buf, a_off + 4)[0]
            alpha = self.buf[a_off + 8:a_off + 8 + a_len]
        return f, payload, alpha


def decode_image(data: bytes, native: bool, alpha: bool = True) -> tuple:
    """WebP bytes → (pixels, mode) as PIL's ``Image.open(...).load()``
    gives frame 0 on its canvas: "RGBA" ([h, w, 4]) where the container
    says the image has alpha (the canvas outside the frame transparent
    black), else "RGB" ([h, w, 3], the canvas black). `alpha` False skips
    the alpha plane (the luma path reads R, G and B only)."""
    demux = _Demux(data)
    cw, ch = demux.canvas
    check_size(cw, ch)
    frame, payload, alph = demux.first_frame()
    lossless = frame.image[2]
    bands = 4 if alpha and demux.flags & ALPHA_FLAG else 3
    plane = None
    if native:
        from .. import native as plane_lib
        if lossless:
            status, px = plane_lib.webp_lossless(payload, frame.width, frame.height, bands)
        else:
            status = OK
            if alph is not None and bands == 4:
                status, plane = plane_lib.webp_alpha(alph, frame.width, frame.height, plane=True)
            elif alph is not None:
                status = plane_lib.webp_alpha(alph, frame.width, frame.height)
            if not status:
                status, px = plane_lib.webp_lossy(payload, frame.width, frame.height)
    else:
        if lossless:
            status, px = lossless_plain(payload, frame.width, frame.height, bands)
        else:
            status = OK
            if alph is not None:
                status, plane = alpha_plane_plain(alph, frame.width, frame.height,
                                                  plane=bands == 4)
            if not status:
                status, px = lossy_plain(payload, frame.width, frame.height)
    if status:
        _refuse(status)
    if bands == 4 and not lossless:
        a = plane if plane is not None else np.full(px.shape[:2], 255, np.uint8)
        px = np.concatenate([px, a[..., None]], axis=-1)
    mode = "RGBA" if bands == 4 else "RGB"
    if (frame.x, frame.y, frame.width, frame.height) == (0, 0, cw, ch):
        return px, mode
    canvas = np.zeros((ch, cw, bands), np.uint8)
    canvas[frame.y:frame.y + frame.height, frame.x:frame.x + frame.width] = px
    return canvas, mode


# -- VP8L --------------------------------------------------------------------

NUM_LITERAL_CODES, NUM_LENGTH_CODES, NUM_DISTANCE_CODES = 256, 24, 40
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
HASH_MUL = 0x1E35A7BD


class _Refused(Exception):
    def __init__(self, code: int):
        super().__init__(code)
        self.code = code


class _LBits:
    """VP8L's bit reader: least significant bit first. Past the data it
    reads zeros; `eos` is libwebp's end-of-stream test, which allows the
    64-bit window to run dry before it trips."""

    def __init__(self, data: bytes):
        self.data = bytes(data) + b"\x00" * 16
        self.limit = 8 * max(len(data), 8)
        self.pos = 0

    def read(self, n: int) -> int:
        p = self.pos
        self.pos = p + n
        if n == 0:
            return 0
        return (int.from_bytes(self.data[p >> 3:(p >> 3) + 4], "little") >> (p & 7)) & ((1 << n) - 1)

    def eos(self) -> bool:
        return self.pos > self.limit


ROOT_BITS = 8  # a code's first-level table; longer codes go on to a second


def _huffman(lengths: list):
    """libwebp's BuildHuffmanTable over code lengths: None where it fails
    (no symbol, an over-subscribed or incomplete code), else (root bits,
    table). The table, indexed by the next root bits read least
    significant first, holds (symbol, length), or for codes past ROOT_BITS
    (None, second table, its bits) indexed by the bits after those. One
    symbol alone is a code of length 0 (root bits 0)."""
    used = [(n, s) for s, n in enumerate(lengths) if n]
    if not used:
        return None
    if len(used) == 1:
        return 0, [(used[0][1], 0)]
    used.sort()
    if sum(1 << (15 - n) for n, _ in used) != 1 << 15:
        return None
    root_bits = min(used[-1][0], ROOT_BITS)
    table = [None] * (1 << root_bits)
    longer = {}  # root index → [(the code's bits after the root, length, symbol)]
    code, prev_len = 0, used[0][0]
    for n, s in used:
        code <<= n - prev_len
        prev_len = n
        rev = int(f"{code:0{n}b}"[::-1], 2)
        code += 1
        if n <= root_bits:
            for k in range(1 << (root_bits - n)):
                table[rev | (k << n)] = (s, n)
        else:
            longer.setdefault(rev & ((1 << root_bits) - 1), []).append((rev >> root_bits, n, s))
    for index, entries in longer.items():
        bits = max(n for _, n, _ in entries) - root_bits
        second = [None] * (1 << bits)
        for rest, n, s in entries:
            for k in range(1 << (bits - (n - root_bits))):
                second[rest | (k << (n - root_bits))] = (s, n)
        table[index] = (None, second, bits)
    return root_bits, table


def _read_symbol(br: _LBits, code) -> int:
    root_bits, table = code
    p = br.pos
    bits = int.from_bytes(br.data[p >> 3:(p >> 3) + 3], "little") >> (p & 7)
    entry = table[bits & ((1 << root_bits) - 1)]
    if entry[0] is None:
        entry = entry[1][(bits >> root_bits) & ((1 << entry[2]) - 1)]
    br.pos = p + entry[1]
    return entry[0]


def _read_code(br: _LBits, alphabet: int):
    """ReadHuffmanCode: a simple or a normal code over `alphabet` symbols."""
    lengths = [0] * max(alphabet, 256)
    if br.read(1):
        num = br.read(1) + 1
        first = br.read(8 if br.read(1) else 1)
        lengths[first] = 1
        if num == 2:
            lengths[br.read(8)] = 1
    else:
        num_codes = br.read(4) + 4
        cl_lengths = [0] * 19
        for i in range(num_codes):
            cl_lengths[CODE_LENGTH_ORDER[i]] = br.read(3)
        cl_code = _huffman(cl_lengths)
        if cl_code is None:
            raise _Refused(LOSSLESS_CODE)
        if br.read(1):
            max_symbol = 2 + br.read(2 + 2 * br.read(3))
            if max_symbol > alphabet:
                raise _Refused(LOSSLESS_CODE)
        else:
            max_symbol = alphabet
        symbol, prev = 0, 8
        while symbol < alphabet:
            if max_symbol == 0:
                break
            max_symbol -= 1
            c = _read_symbol(br, cl_code)
            if c < 16:
                lengths[symbol] = c
                symbol += 1
                if c:
                    prev = c
            else:
                extra, offset = ((2, 3), (3, 3), (7, 11))[c - 16]
                repeat = br.read(extra) + offset
                if symbol + repeat > alphabet:
                    raise _Refused(LOSSLESS_CODE)
                value = prev if c == 16 else 0
                lengths[symbol:symbol + repeat] = [value] * repeat
                symbol += repeat
    if br.eos():
        raise _Refused(LOSSLESS_END)
    code = _huffman(lengths[:alphabet])
    if code is None:
        raise _Refused(LOSSLESS_CODE)
    return code


def _subsample(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


class _Lossless:
    """libwebp's VP8L decoder over one bit reader (the main image's or an
    alpha stream's)."""

    def __init__(self, br: _LBits, alpha: bool = False):
        self.br = br
        self.alpha = alpha

    def image_stream(self, xsize: int, ysize: int, level0: bool):
        """DecodeImageStream: (transforms, [ysize', xsize'] uint32 ARGB)
        with the level-0 transforms read first."""
        br = self.br
        transforms, seen = [], set()
        width = xsize
        if level0:
            while br.read(1):
                kind = br.read(2)
                if kind in seen:
                    raise _Refused(LOSSLESS_TRANSFORM)
                seen.add(kind)
                if kind in (0, 1):  # predictor, cross-colour
                    bits = br.read(3) + 2
                    sub = self.image_stream(_subsample(width, bits), _subsample(ysize, bits),
                                            False)[1]
                    transforms.append((kind, width, bits, sub))
                elif kind == 3:  # colour indexing
                    num = br.read(8) + 1
                    bits = 0 if num > 16 else 1 if num > 4 else 2 if num > 2 else 3
                    pal = self.image_stream(num, 1, False)[1].reshape(-1)
                    transforms.append((kind, width, bits, _expand_palette(pal, bits)))
                    width = _subsample(width, bits)
                else:  # subtract green
                    transforms.append((kind, width, 0, None))
        cache_bits = 0
        if br.read(1):
            cache_bits = br.read(4)
            if not 1 <= cache_bits <= 11:
                raise _Refused(LOSSLESS_HEADER)
        groups, group_bits, group_map = self._codes(width, ysize, cache_bits, level0)
        # libwebp decodes an alpha plane with only a colour-indexing
        # transform, no colour cache and one-symbol red, blue and alpha
        # codes on its 8-bit path, which lets the last symbol read past
        # the end of the stream.
        eight_bit = (level0 and self.alpha and len(transforms) == 1 and transforms[0][0] == 3
                     and not cache_bits and all(g[k][0] == 0 for g in groups for k in (1, 2, 3)))
        data = self._pixels(width, ysize, groups, group_bits, group_map, cache_bits, eight_bit)
        return transforms, data

    def _codes(self, xsize: int, ysize: int, cache_bits: int, allow_meta: bool):
        """ReadHuffmanCodes: (groups of 5 codes, meta bits, [h, w] group
        index image or None)."""
        br = self.br
        num_groups, group_bits, group_map = 1, 0, None
        if allow_meta and br.read(1):
            group_bits = br.read(3) + 2
            sub = self.image_stream(_subsample(xsize, group_bits), _subsample(ysize, group_bits),
                                    False)[1]
            group_map = (sub >> 8) & 0xFFFF
            num_groups = int(group_map.max()) + 1
        if br.eos():
            raise _Refused(LOSSLESS_END)
        alphabets = (NUM_LITERAL_CODES + NUM_LENGTH_CODES + ((1 << cache_bits) if cache_bits else 0),
                     256, 256, 256, NUM_DISTANCE_CODES)
        groups = [[_read_code(br, a) for a in alphabets] for _ in range(num_groups)]
        return groups, group_bits, group_map

    def _pixels(self, width: int, height: int, groups, group_bits: int, group_map,
                cache_bits: int, eight_bit: bool = False) -> np.ndarray:
        """DecodeImageData (DecodeAlphaData where `eight_bit`): the
        entropy-coded pixels, [height, width] uint32."""
        br = self.br
        total = width * height
        out = [0] * total
        cache = [0] * (1 << cache_bits) if cache_bits else None
        shift = 32 - cache_bits
        cached = 0  # pixels inserted into the cache so far
        literal_limit = NUM_LITERAL_CODES + NUM_LENGTH_CODES
        mask = (1 << group_bits) - 1 if group_bits else -1
        gw = _subsample(width, group_bits) if group_bits else 1
        flat_map = group_map.reshape(-1).tolist() if group_map is not None else None
        pos = 0
        group = groups[0]
        while pos < total:
            if br.pos > br.limit:
                raise _Refused(LOSSLESS_END)
            y, x = divmod(pos, width)
            if eight_bit:
                group = groups[flat_map[(y >> group_bits) * gw + (x >> group_bits)]] \
                    if flat_map is not None else group
                code = _read_symbol(br, group[0])
                if code < NUM_LITERAL_CODES:
                    out[pos] = code << 8
                    pos += 1
                    continue
            if flat_map is not None:
                group = groups[flat_map[(y >> group_bits) * gw + (x >> group_bits)]]
            code = _read_symbol(br, group[0])
            if code < NUM_LITERAL_CODES:
                red = _read_symbol(br, group[1])
                blue = _read_symbol(br, group[2])
                alpha = _read_symbol(br, group[3])
                out[pos] = (alpha << 24) | (red << 16) | (code << 8) | blue
                pos += 1
            elif code < literal_limit:
                length = _prefix_value(br, code - NUM_LITERAL_CODES)
                dist_code = _prefix_value(br, _read_symbol(br, group[4]))
                dist = _plane_distance(width, dist_code)
                if br.pos > br.limit and not eight_bit:
                    raise _Refused(LOSSLESS_END)
                if pos < dist or total - pos < length:
                    raise _Refused(LOSSLESS_DATA)
                for k in range(length):
                    out[pos + k] = out[pos + k - dist]
                pos += length
            else:
                if cache is None:
                    raise _Refused(LOSSLESS_DATA)
                while cached < pos:
                    v = out[cached]
                    cache[((v * HASH_MUL) & 0xFFFFFFFF) >> shift] = v
                    cached += 1
                out[pos] = cache[code - literal_limit]
                pos += 1
        if br.eos() and not eight_bit:
            raise _Refused(LOSSLESS_END)
        return np.array(out, np.uint32).reshape(height, width)


def _prefix_value(br: _LBits, symbol: int) -> int:
    """GetCopyDistance / GetCopyLength."""
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    return ((2 + (symbol & 1)) << extra) + br.read(extra) + 1


def _plane_distance(width: int, code: int) -> int:
    if code > 120:
        return code - 120
    d = T.CODE_TO_PLANE[code - 1]
    dist = (d >> 4) * width + 8 - (d & 0xF)
    return dist if dist >= 1 else 1


def _expand_palette(pal: np.ndarray, bits: int) -> np.ndarray:
    """ExpandColorMap: the colour-indexing palette, delta-coded, then
    transparent black up to 2**(8 >> bits) entries."""
    size = 1 << (8 >> bits)
    raw = pal.astype(np.uint32).view(np.uint8).reshape(-1, 4)
    acc = np.cumsum(raw, axis=0, dtype=np.uint8)
    out = np.zeros((size, 4), np.uint8)
    out[:len(acc)] = acc[:size]
    return out.view(np.uint32).reshape(-1)


def _add(a: int, b: int) -> int:
    return (((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00) | \
        (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF)


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _channels(v: int):
    return v >> 24, (v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF


def _half(v: int) -> int:
    """C's v / 2: rounded toward zero."""
    return v // 2 if v >= 0 else -(-v // 2)


def _clip255(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _predict(mode: int, left: int, top: int, top_right: int, top_left: int) -> int:
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return top_right
    if mode == 4:
        return top_left
    if mode == 5:
        return _avg2(_avg2(left, top_right), top)
    if mode == 6:
        return _avg2(left, top_left)
    if mode == 7:
        return _avg2(left, top)
    if mode == 8:
        return _avg2(top_left, top)
    if mode == 9:
        return _avg2(top, top_right)
    if mode == 10:
        return _avg2(_avg2(left, top_left), _avg2(top, top_right))
    if mode == 11:  # Select(T, L, TL)
        t, l, tl = _channels(top), _channels(left), _channels(top_left)
        s = sum(abs(l[k] - tl[k]) - abs(t[k] - tl[k]) for k in range(4))
        return top if s <= 0 else left
    if mode == 12:
        l, t, tl = _channels(left), _channels(top), _channels(top_left)
        a, r, g, b = (_clip255(l[k] + t[k] - tl[k]) for k in range(4))
        return a << 24 | r << 16 | g << 8 | b
    if mode == 13:
        avg, tl = _channels(_avg2(left, top)), _channels(top_left)
        a, r, g, b = (_clip255(avg[k] + _half(avg[k] - tl[k])) for k in range(4))
        return a << 24 | r << 16 | g << 8 | b
    return 0xFF000000  # 0, and the padding modes 14 and 15


def _inverse_predictor(data: np.ndarray, bits: int, sub: np.ndarray) -> np.ndarray:
    h, w = data.shape
    res = data.reshape(-1).tolist()
    out = [0] * (h * w)
    modes = ((sub >> 8) & 0xF).tolist()
    for y in range(h):
        row = y * w
        for x in range(w):
            i = row + x
            if y == 0:
                pred = 0xFF000000 if x == 0 else out[i - 1]
            elif x == 0:
                pred = out[i - w]
            else:
                pred = _predict(modes[y >> bits][x >> bits], out[i - 1], out[i - w],
                                out[i - w + 1], out[i - w - 1])
            out[i] = _add(res[i], pred)
    return np.array(out, np.uint32).reshape(h, w)


def _signed8(v: np.ndarray) -> np.ndarray:
    return v.astype(np.uint8).astype(np.int8).astype(np.int32)


def _inverse_cross_colour(data: np.ndarray, bits: int, sub: np.ndarray) -> np.ndarray:
    h, w = data.shape
    m = sub[np.arange(h)[:, None] >> bits, np.arange(w)[None, :] >> bits]
    g2r, g2b, r2b = _signed8(m & 0xFF), _signed8((m >> 8) & 0xFF), _signed8((m >> 16) & 0xFF)
    green = _signed8((data >> 8) & 0xFF)
    red = ((data >> 16) & 0xFF).astype(np.int32)
    blue = (data & 0xFF).astype(np.int32)
    red = (red + ((g2r * green) >> 5)) & 0xFF
    blue = (blue + ((g2b * green) >> 5) + ((r2b * _signed8(red)) >> 5)) & 0xFF
    return (data & np.uint32(0xFF00FF00)) | (red.astype(np.uint32) << 16) | blue.astype(np.uint32)


def _inverse_transforms(transforms: list, data: np.ndarray) -> np.ndarray:
    for kind, width, bits, extra in reversed(transforms):
        if kind == 0:
            data = _inverse_predictor(data, bits, extra)
        elif kind == 1:
            data = _inverse_cross_colour(data, bits, extra)
        elif kind == 2:
            g = (data >> 8) & 0xFF
            red = (((data >> 16) & 0xFF) + g) & 0xFF
            blue = ((data & 0xFF) + g) & 0xFF
            data = (data & np.uint32(0xFF00FF00)) | (red << 16) | blue
        else:
            if bits:
                per = 1 << bits
                x = np.arange(width)
                packed = (data[:, x >> bits] >> 8) & 0xFF
                index = (packed >> ((x & (per - 1)) * (8 >> bits)).astype(np.uint32)) & (
                    (1 << (8 >> bits)) - 1)
            else:
                index = (data >> 8) & 0xFF
            data = extra[index]
    return data


def lossless_plain(payload: bytes, width: int, height: int, bands: int = 3) -> tuple:
    """Plain version of ``native.webp_lossless``: a VP8L chunk's payload
    (to the fragment's end) → (status, [h, w, bands] uint8 RGB(A) or
    None)."""
    br = _LBits(payload)
    try:
        if br.read(8) != 0x2F:
            raise _Refused(LOSSLESS_HEADER)
        w, h = br.read(14) + 1, br.read(14) + 1
        br.read(1)
        if br.read(3) or (w, h) != (width, height):
            raise _Refused(LOSSLESS_HEADER)
        transforms, data = _Lossless(br).image_stream(w, h, True)
    except _Refused as r:
        return r.code, None
    argb = _inverse_transforms(transforms, data)
    shifts = (16, 8, 0, 24)[:bands]
    rgb = np.stack([(argb >> s) & 0xFF for s in shifts], axis=-1)
    return OK, rgb.astype(np.uint8)


def alpha_plain(alpha: bytes, width: int, height: int) -> int:
    """Plain version of ``native.webp_alpha`` without the plane: an ALPH
    payload checked as libwebp's ALPHInit and alpha decode check it;
    returns a status."""
    return alpha_plane_plain(alpha, width, height, plane=False)[0]


def alpha_plane_plain(alpha: bytes, width: int, height: int, plane: bool = True) -> tuple:
    """Plain version of ``native.webp_alpha``: (status, the [h, w] uint8
    alpha plane with its rows unfiltered as libwebp's alpha decoder does,
    or None)."""
    if len(alpha) <= 1:
        return ALPHA_HEADER, None
    method, filt = alpha[0] & 3, (alpha[0] >> 2) & 3
    pre, rsrv = (alpha[0] >> 4) & 3, alpha[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        return ALPHA_HEADER, None
    if method == 0:
        if len(alpha) - 1 < width * height:
            return ALPHA_HEADER, None
        if not plane:
            return OK, None
        raw = np.frombuffer(alpha, np.uint8, width * height, 1).reshape(height, width)
    else:
        try:
            transforms, data = _Lossless(_LBits(alpha[1:]), alpha=True).image_stream(
                width, height, True)
        except _Refused as r:
            return r.code, None
        if not plane:
            return OK, None
        raw = ((_inverse_transforms(transforms, data) >> 8) & 0xFF).astype(np.uint8)
    return OK, _unfilter_alpha(raw, filt)


def _unfilter_alpha(raw: np.ndarray, filt: int) -> np.ndarray:
    """libwebp's HorizontalUnfilter (1), VerticalUnfilter (2) and
    GradientUnfilter (3) row by row; the first row of each is horizontal
    from 0."""
    h, w = raw.shape
    out = np.empty_like(raw)
    if filt == 0:
        return raw.copy()
    for y in range(h):
        src = raw[y]
        if y == 0 or filt == 1:
            start = np.uint8(out[y - 1, 0]) if y and filt == 1 else np.uint8(0)
            row = np.cumsum(np.concatenate([[start], src]).astype(np.uint64))[1:]
            out[y] = (row & 0xFF).astype(np.uint8)
        elif filt == 2:
            out[y] = out[y - 1] + src
        else:
            prev = out[y - 1].tolist()
            s = src.tolist()
            row = [0] * w
            left, top_left = prev[0], prev[0]
            for i in range(w):
                top = prev[i]
                g = left + top - top_left
                left = (s[i] + (g if 0 <= g <= 255 else 0 if g < 0 else 255)) & 0xFF
                top_left = top
                row[i] = left
            out[y] = row
    return out


# -- VP8 ---------------------------------------------------------------------

ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's intra modes: the 4x4 ones, and the 16x16 and chroma ones
# under the same numbers.
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
DC_PRED, TM_PRED, V_PRED, H_PRED = B_DC, B_TM, B_VE, B_HE
# The 4x4 mode tree (kYModesIntra4): leaves are -mode.
YMODES_INTRA4 = (-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7, -B_VL,
                 8, -B_HD, -B_HU)
# Shifts that bring a range of 1..127 back to 128..255.
NORM = [0] + [7 - r.bit_length() + 1 for r in range(1, 256)]


class _Bool:
    """The VP8 boolean decoder (RFC 6386 section 7). Past its data it
    reads zeros and sets `eof` as libwebp's reader does: on any read made
    once the bits shifted out pass 8·(size − 1), and at once for an empty
    partition."""

    def __init__(self, data: bytes):
        self.data = bytes(data) + b"\x00\x00"
        self.value = self.data[0] << 8 | self.data[1]
        self.pos = 2
        self.range = 255
        self.count = 0
        self.shifts = 0
        self.limit = 8 * len(data) - 8
        self.eof = len(data) == 0

    def bit(self, prob: int) -> int:
        if self.shifts > self.limit:
            self.eof = True
        split = 1 + (((self.range - 1) * prob) >> 8)
        big = split << 8
        if self.value >= big:
            rng = self.range - split
            self.value -= big
            bit = 1
        else:
            rng = split
            bit = 0
        if rng < 128:
            s = NORM[rng]
            rng <<= s
            self.value <<= s
            self.shifts += s
            count = self.count + s
            if count >= 8:
                count -= 8
                p = self.pos
                self.value |= (self.data[p] if p < len(self.data) else 0) << count
                self.pos = p + 1
            self.count = count
        self.range = rng
        return bit

    def value_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = v << 1 | self.bit(0x80)
        return v

    def signed_bits(self, n: int) -> int:
        v = self.value_bits(n)
        return -v if self.bit(0x80) else v


def _large_value(br: _Bool, p) -> int:
    """GetLargeValue: a token past ONE."""
    if not br.bit(p[3]):
        if not br.bit(p[4]):
            return 2
        return 3 + br.bit(p[5])
    if not br.bit(p[6]):
        if not br.bit(p[7]):
            return 5 + br.bit(159)
        v = 7 + 2 * br.bit(165)
        return v + br.bit(145)
    bit1 = br.bit(p[8])
    bit0 = br.bit(p[9 + bit1])
    cat = 2 * bit1 + bit0
    v = 0
    for prob in CAT_PROBS[cat]:
        v += v + br.bit(prob)
    return v + 3 + (8 << cat)


def _coeffs(br: _Bool, prob, ctx: int, dq, n: int, out: list, base: int) -> int:
    """GetCoeffs: one block's tokens from coefficient `n`, dequantised
    into out[base:base + 16] (raster order, 16-bit); returns the index
    past the last one read."""
    p = prob[n][ctx]
    while n < 16:
        if not br.bit(p[0]):
            return n
        while not br.bit(p[1]):
            n += 1
            if n == 16:
                return 16
            p = prob[n][0]
        nxt = prob[n + 1]
        if not br.bit(p[2]):
            v = 1
            p = nxt[1]
        else:
            v = _large_value(br, p)
            p = nxt[2]
        if br.bit(0x80):
            v = -v
        out[base + ZIGZAG[n]] = _wrap(v * dq[n > 0])
        n += 1
    return 16


def _mul1(a):
    return ((a * 20091) >> 16) + a


def _mul2(a):
    return (a * 35468) >> 16


def _idct(coeffs: np.ndarray) -> np.ndarray:
    """libwebp's TransformOne over [n, 16] coefficients: [n, 4, 4] int64
    residuals (the values added to the prediction before clipping). The
    first pass runs down the columns, the second along the rows."""
    c = coeffs.astype(np.int64).reshape(-1, 4, 4)
    a = c[:, 0] + c[:, 2]
    b = c[:, 0] - c[:, 2]
    cc = _mul2(c[:, 1]) - _mul1(c[:, 3])
    d = _mul1(c[:, 1]) + _mul2(c[:, 3])
    t = np.stack([a + d, b + cc, b - cc, a - d], axis=1)  # [n, row, column]
    dc = t[..., 0] + 4
    a = dc + t[..., 2]
    b = dc - t[..., 2]
    cc = _mul2(t[..., 1]) - _mul1(t[..., 3])
    d = _mul1(t[..., 1]) + _mul2(t[..., 3])
    return np.stack([(a + d) >> 3, (b + cc) >> 3, (b - cc) >> 3, (a - d) >> 3], axis=-1)


def _wrap(v):
    """A value held in a signed 16-bit lane."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _idct_sse2(coeffs: np.ndarray) -> np.ndarray:
    """libwebp's Transform_SSE2 over [n, 16] coefficients: TransformOne in
    16-bit lanes that wrap, the multiplies as ``_mm_mulhi_epi16`` by 20091
    and by 35468 - 65536 plus the value itself; [n, 4, 4] residuals, each
    then added to the prediction in 16 bits before saturating."""
    w = _wrap
    c = coeffs.astype(np.int64).reshape(-1, 4, 4)

    def butterfly(x0, x1, x2, x3):
        a, b = w(x0 + x2), w(x0 - x2)
        cc = w(w(x1 - x3) + w(((x1 * -30068) >> 16) - ((x3 * 20091) >> 16)))
        d = w(w(x1 + x3) + w(((x1 * 20091) >> 16) + ((x3 * -30068) >> 16)))
        return w(a + d), w(b + cc), w(b - cc), w(a - d)

    t = np.stack(butterfly(c[:, 0], c[:, 1], c[:, 2], c[:, 3]), axis=1)  # [n, row, column]
    out = butterfly(w(t[..., 0] + 4), t[..., 1], t[..., 2], t[..., 3])
    return np.stack([v >> 3 for v in out], axis=-1)


def _wht(dc: list) -> list:
    """TransformWHT: the 16 DC values of a 16x16 macroblock's Y blocks."""
    tmp = [0] * 16
    for i in range(4):
        a0, a1 = dc[i] + dc[12 + i], dc[4 + i] + dc[8 + i]
        a2, a3 = dc[4 + i] - dc[8 + i], dc[i] - dc[12 + i]
        tmp[i], tmp[8 + i], tmp[4 + i], tmp[12 + i] = a0 + a1, a0 - a1, a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        d = tmp[4 * i] + 3
        a0, a1 = d + tmp[3 + 4 * i], tmp[1 + 4 * i] + tmp[2 + 4 * i]
        a2, a3 = tmp[1 + 4 * i] - tmp[2 + 4 * i], d - tmp[3 + 4 * i]
        out[4 * i:4 * i + 4] = [_wrap((a0 + a1) >> 3), _wrap((a3 + a2) >> 3),
                                _wrap((a0 - a1) >> 3), _wrap((a3 - a2) >> 3)]
    return out


def _clip(v: int) -> int:
    return 0 if v < 0 else 255 if v > 255 else v


def _avg3(a: int, b: int, c: int) -> int:
    return (a + 2 * b + c + 2) >> 2


def _predict4(mode: int, top: list, left: list, tl: int) -> list:
    """One 4x4 block's prediction (libwebp's VP8PredLuma4): `top` the 8
    pixels above (4 above-right last), `left` the 4 to the left, `tl` the
    corner; 16 values, rows first."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if mode == B_DC:
        return [(sum(top[:4]) + sum(left) + 4) >> 3] * 16
    if mode == B_TM:
        return [_clip(top[x] + left[y] - X) for y in range(4) for x in range(4)]
    if mode == B_VE:
        return [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)] * 4
    if mode == B_HE:
        rows = (_avg3(X, I, J), _avg3(I, J, K), _avg3(J, K, L), _avg3(K, L, L))
        return [v for v in rows for _ in range(4)]
    out = [0] * 16

    def put(x, y, v):
        out[y * 4 + x] = v

    if mode == B_RD:
        for (x, y), v in (((0, 3), _avg3(J, K, L)), ((1, 3), _avg3(I, J, K)),
                          ((0, 2), _avg3(I, J, K)), ((2, 3), _avg3(X, I, J)),
                          ((1, 2), _avg3(X, I, J)), ((0, 1), _avg3(X, I, J))):
            put(x, y, v)
        for x, y in ((3, 3), (2, 2), (1, 1), (0, 0)):
            put(x, y, _avg3(A, X, I))
        for x, y in ((3, 2), (2, 1), (1, 0)):
            put(x, y, _avg3(B, A, X))
        put(3, 1, _avg3(C, B, A))
        put(2, 0, _avg3(C, B, A))
        put(3, 0, _avg3(D, C, B))
    elif mode == B_LD:
        vals = (_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E), _avg3(D, E, F),
                _avg3(E, F, G), _avg3(F, G, H), _avg3(G, H, H))
        for y in range(4):
            for x in range(4):
                put(x, y, vals[x + y])
    elif mode == B_VR:
        put(0, 0, (X + A + 1) >> 1)
        put(1, 2, (X + A + 1) >> 1)
        put(1, 0, (A + B + 1) >> 1)
        put(2, 2, (A + B + 1) >> 1)
        put(2, 0, (B + C + 1) >> 1)
        put(3, 2, (B + C + 1) >> 1)
        put(3, 0, (C + D + 1) >> 1)
        put(0, 3, _avg3(K, J, I))
        put(0, 2, _avg3(J, I, X))
        put(0, 1, _avg3(I, X, A))
        put(1, 3, _avg3(I, X, A))
        put(1, 1, _avg3(X, A, B))
        put(2, 3, _avg3(X, A, B))
        put(2, 1, _avg3(A, B, C))
        put(3, 3, _avg3(A, B, C))
        put(3, 1, _avg3(B, C, D))
    elif mode == B_VL:
        put(0, 0, (A + B + 1) >> 1)
        put(1, 0, (B + C + 1) >> 1)
        put(0, 2, (B + C + 1) >> 1)
        put(2, 0, (C + D + 1) >> 1)
        put(1, 2, (C + D + 1) >> 1)
        put(3, 0, (D + E + 1) >> 1)
        put(2, 2, (D + E + 1) >> 1)
        put(0, 1, _avg3(A, B, C))
        put(1, 1, _avg3(B, C, D))
        put(0, 3, _avg3(B, C, D))
        put(2, 1, _avg3(C, D, E))
        put(1, 3, _avg3(C, D, E))
        put(3, 1, _avg3(D, E, F))
        put(2, 3, _avg3(D, E, F))
        put(3, 2, _avg3(E, F, G))
        put(3, 3, _avg3(F, G, H))
    elif mode == B_HU:
        put(0, 0, (I + J + 1) >> 1)
        put(2, 0, (J + K + 1) >> 1)
        put(0, 1, (J + K + 1) >> 1)
        put(2, 1, (K + L + 1) >> 1)
        put(0, 2, (K + L + 1) >> 1)
        put(1, 0, _avg3(I, J, K))
        put(3, 0, _avg3(J, K, L))
        put(1, 1, _avg3(J, K, L))
        put(3, 1, _avg3(K, L, L))
        put(1, 2, _avg3(K, L, L))
        for x, y in ((3, 2), (2, 2), (0, 3), (1, 3), (2, 3), (3, 3)):
            put(x, y, L)
    else:  # B_HD
        put(0, 0, (I + X + 1) >> 1)
        put(2, 1, (I + X + 1) >> 1)
        put(0, 1, (J + I + 1) >> 1)
        put(2, 2, (J + I + 1) >> 1)
        put(0, 2, (K + J + 1) >> 1)
        put(2, 3, (K + J + 1) >> 1)
        put(0, 3, (L + K + 1) >> 1)
        put(3, 0, _avg3(A, B, C))
        put(2, 0, _avg3(X, A, B))
        put(1, 0, _avg3(I, X, A))
        put(3, 1, _avg3(I, X, A))
        put(1, 1, _avg3(J, I, X))
        put(3, 2, _avg3(J, I, X))
        put(1, 2, _avg3(K, J, I))
        put(3, 3, _avg3(K, J, I))
        put(1, 3, _avg3(L, K, J))
    return out


def _diagonals(mb_w: int, mb_h: int):
    """The macroblocks by wavefront: (mb_y, mb_x) arrays of those with the
    same x + 2y, in order. Intra prediction of (x, y) reads (x - 1, y),
    (x, y - 1), (x - 1, y - 1) and (x + 1, y - 1) only, all on earlier
    wavefronts, so each wavefront is reconstructed at once."""
    ys = np.arange(mb_h)
    for t in range(mb_w + 2 * (mb_h - 1)):
        xs = t - 2 * ys
        keep = (xs >= 0) & (xs < mb_w)
        yield ys[keep], xs[keep]


def neighbours(plane: np.ndarray, my: np.ndarray, mx: np.ndarray, size: int):
    """The unfiltered samples around each macroblock: (top [m, size],
    left [m, size], top-left [m]), 127 above the first row, 129 left of
    the first column, the corner 127 on the first row and 129 down the
    first column."""
    k = np.arange(size)
    y0, x0 = my * size, mx * size
    top = np.where((my > 0)[:, None], plane[np.maximum(y0 - 1, 0)[:, None], x0[:, None] + k],
                   127).astype(np.int64)
    left = np.where((mx > 0)[:, None], plane[y0[:, None] + k, np.maximum(x0 - 1, 0)[:, None]],
                    129).astype(np.int64)
    corner = plane[np.maximum(y0 - 1, 0), np.maximum(x0 - 1, 0)].astype(np.int64)
    tl = np.where(my == 0, 127, np.where(mx == 0, 129, corner))
    return top, left, tl


def predict_all(top: np.ndarray, left: np.ndarray, tl: np.ndarray, my: np.ndarray,
                mx: np.ndarray, size: int) -> np.ndarray:
    """The four 16x16 luma or 8x8 chroma predictions of m macroblocks (DC
    with libwebp's edge variants, TM, V, H, by mode number): [4, m, size,
    size]."""
    shift = 4 if size == 16 else 3
    st, sl = top.sum(axis=1), left.sum(axis=1)
    has_top, has_left = my > 0, mx > 0
    dc = np.where(has_top & has_left, (st + sl + size) >> (shift + 1),
                  np.where(has_left, (sl + (size >> 1)) >> shift,
                           np.where(has_top, (st + (size >> 1)) >> shift, 0x80)))
    shape = (len(my), size, size)
    return np.stack([np.broadcast_to(dc[:, None, None], shape),
                     np.clip(top[:, None, :] + left[:, :, None] - tl[:, None, None], 0, 255),
                     np.broadcast_to(top[:, None, :], shape),
                     np.broadcast_to(left[:, :, None], shape)])


def predict_batch(modes: np.ndarray, top: np.ndarray, left: np.ndarray, tl: np.ndarray,
                  my: np.ndarray, mx: np.ndarray, size: int) -> np.ndarray:
    """Each macroblock's prediction by its own mode: [m, size, size]."""
    return predict_all(top, left, tl, my, mx, size)[np.asarray(modes), np.arange(len(my))]


def blocks_to_plane(res: np.ndarray, per_row: int) -> np.ndarray:
    """[m, per_row², 4, 4] blocks (raster order) → [m, 4·per_row, 4·per_row]."""
    m = res.shape[0]
    return res.reshape(m, per_row, per_row, 4, 4).transpose(0, 1, 3, 2, 4).reshape(
        m, 4 * per_row, 4 * per_row)


def put_blocks(plane: np.ndarray, my: np.ndarray, mx: np.ndarray, values: np.ndarray) -> None:
    size = values.shape[1]
    k = np.arange(size)
    plane[(my * size)[:, None, None] + k[None, :, None],
          (mx * size)[:, None, None] + k[None, None, :]] = values


def wht_batch(dc: np.ndarray) -> np.ndarray:
    """TransformWHT over [m, 16] Y2 coefficients (raster): [m, 16] DC
    values of the 16 Y blocks, held in 16 bits."""
    d = dc.astype(np.int64).reshape(-1, 4, 4)
    a0, a1 = d[:, 0] + d[:, 3], d[:, 1] + d[:, 2]
    a2, a3 = d[:, 1] - d[:, 2], d[:, 0] - d[:, 3]
    t = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=1)  # [m, k, column]
    dc0 = t[..., 0] + 3
    a0, a1 = dc0 + t[..., 3], t[..., 1] + t[..., 2]
    a2, a3 = t[..., 1] - t[..., 2], dc0 - t[..., 3]
    out = np.stack([(a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3, (a3 - a2) >> 3], axis=-1)
    return ((out.reshape(-1, 16) + 0x8000) & 0xFFFF) - 0x8000


def i4_reconstruct(plane: np.ndarray, mb_x: int, mb_y: int, mb_w: int, top: list, left: list,
                   tl: int, block):
    """One B_PRED macroblock: libwebp's work area (rows -1..15, columns
    -1..19, the above-right pixels repeated over rows 3, 7 and 11), each
    4x4 block predicted in turn; `block(n, pred)` gives block n's 16
    reconstructed values from its prediction. Writes the macroblock."""
    y0, x0 = 16 * mb_y, 16 * mb_x
    if mb_y == 0:
        top_right = [127] * 4
    elif mb_x == mb_w - 1:
        top_right = [top[15]] * 4
    else:
        top_right = plane[y0 - 1, x0 + 16:x0 + 20].tolist()
    buf = [[0] * 21 for _ in range(17)]
    buf[0] = [tl] + list(top) + top_right
    for r in range(16):
        buf[r + 1][0] = left[r]
    for r in (3, 7, 11):
        buf[r + 1][17:21] = top_right
    for n in range(16):
        bx, by = 4 * (n & 3), 4 * (n >> 2)
        above = buf[by][bx + 1:bx + 9]
        left4 = [buf[by + 1 + k][bx] for k in range(4)]
        values = block(n, above, left4, buf[by][bx])
        for k in range(4):
            buf[by + 1 + k][bx + 1:bx + 5] = values[4 * k:4 * k + 4]
    plane[y0:y0 + 16, x0:x0 + 16] = np.array([row[1:17] for row in buf[1:]], np.uint8)


class _Lossy:
    """libwebp's VP8 decoder of one key frame: parse, reconstruct, loop
    filter, then fancy upsampling and YUV to RGB."""

    def __init__(self, payload: bytes, width: int, height: int):
        self.buf = payload
        self.width, self.height = width, height

    def decode(self) -> np.ndarray:
        buf = self.buf
        if len(buf) < 10:
            raise _Refused(LOSSY_HEADER)
        bits = buf[0] | buf[1] << 8 | buf[2] << 16
        part_len = bits >> 5
        if bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or buf[3:6] != b"\x9d\x01\x2a":
            raise _Refused(LOSSY_HEADER)
        w = (buf[6] | buf[7] << 8) & 0x3FFF
        h = (buf[8] | buf[9] << 8) & 0x3FFF
        if (w, h) != (self.width, self.height):
            raise _Refused(LOSSY_HEADER)
        if part_len > len(buf) - 10:
            raise _Refused(LOSSY_HEADER)
        br = _Bool(buf[10:10 + part_len])
        br.bit(0x80)  # colour space
        br.bit(0x80)  # clamping type
        self._segment_header(br)
        self._filter_header(br)
        self._partitions(br, buf[10 + part_len:])
        self._quant(br)
        br.bit(0x80)  # refresh entropy probabilities: ignored
        self._proba(br)
        self.mb_w, self.mb_h = (w + 15) >> 4, (h + 15) >> 4
        self._frame(br)
        self._loop_filter()
        return self._rgb()

    def _segment_header(self, br: _Bool) -> None:
        self.use_segment = br.bit(0x80)
        self.update_map = 0
        self.absolute_delta = 1
        self.seg_quant = [0] * 4
        self.seg_filter = [0] * 4
        self.seg_probs = [255] * 3
        if self.use_segment:
            self.update_map = br.bit(0x80)
            if br.bit(0x80):
                self.absolute_delta = br.bit(0x80)
                self.seg_quant = [br.signed_bits(7) if br.bit(0x80) else 0 for _ in range(4)]
                self.seg_filter = [br.signed_bits(6) if br.bit(0x80) else 0 for _ in range(4)]
            if self.update_map:
                self.seg_probs = [br.value_bits(8) if br.bit(0x80) else 255 for _ in range(3)]
        if br.eof:
            raise _Refused(LOSSY_HEADER)

    def _filter_header(self, br: _Bool) -> None:
        self.simple = br.bit(0x80)
        self.level = br.value_bits(6)
        self.sharpness = br.value_bits(3)
        self.use_lf_delta = br.bit(0x80)
        self.ref_lf_delta = [0] * 4
        self.mode_lf_delta = [0] * 4
        if self.use_lf_delta and br.bit(0x80):
            for i in range(4):
                if br.bit(0x80):
                    self.ref_lf_delta[i] = br.signed_bits(6)
            for i in range(4):
                if br.bit(0x80):
                    self.mode_lf_delta[i] = br.signed_bits(6)
        self.filter_type = 0 if self.level == 0 else 1 if self.simple else 2
        if br.eof:
            raise _Refused(LOSSY_HEADER)

    def _partitions(self, br: _Bool, rest: bytes) -> None:
        num = 1 << br.value_bits(2)
        last = num - 1
        size = len(rest)
        if size < 3 * last:
            raise _Refused(LOSSY_PARTITIONS)
        start, left = 3 * last, size - 3 * last
        parts = []
        for p in range(last):
            psize = rest[3 * p] | rest[3 * p + 1] << 8 | rest[3 * p + 2] << 16
            psize = min(psize, left)
            parts.append(_Bool(rest[start:start + psize]))
            start += psize
            left -= psize
        parts.append(_Bool(rest[start:start + left]))
        if start >= size:
            raise _Refused(LOSSY_PARTITIONS)
        self.parts = parts

    def _quant(self, br: _Bool) -> None:
        base = br.value_bits(7)
        deltas = [br.signed_bits(4) if br.bit(0x80) else 0 for _ in range(5)]
        y1_dc, y2_dc, y2_ac, uv_dc, uv_ac = deltas

        def clip(v, m):
            return 0 if v < 0 else m if v > m else v

        self.dqm = []
        for s in range(4):
            if self.use_segment:
                q = self.seg_quant[s] + (0 if self.absolute_delta else base)
            elif s > 0:
                self.dqm.append(self.dqm[0])
                continue
            else:
                q = base
            y2_ac_q = max(8, (T.AC_TABLE[clip(q + y2_ac, 127)] * 101581) >> 16)
            self.dqm.append({
                "y1": (T.DC_TABLE[clip(q + y1_dc, 127)], T.AC_TABLE[clip(q, 127)]),
                "y2": (T.DC_TABLE[clip(q + y2_dc, 127)] * 2, y2_ac_q),
                "uv": (T.DC_TABLE[clip(q + uv_dc, 117)], T.AC_TABLE[clip(q + uv_ac, 127)]),
            })

    def _proba(self, br: _Bool) -> None:
        flat = [br.value_bits(8) if br.bit(T.COEFFS_UPDATE_PROBA[i]) else T.COEFFS_PROBA0[i]
                for i in range(4 * 8 * 3 * 11)]
        bands = [[[flat[((t * 8 + b) * 3 + c) * 11:((t * 8 + b) * 3 + c) * 11 + 11]
                   for c in range(3)] for b in range(8)] for t in range(4)]
        self.bands = [[bands[t][BANDS[n]] for n in range(17)] for t in range(4)]
        self.use_skip = br.bit(0x80)
        self.skip_p = br.value_bits(8) if self.use_skip else 0

    def _intra_row(self, br: _Bool, top: list, mbs: list) -> None:
        """ParseIntraMode for each macroblock of a row."""
        left = [B_DC] * 4
        for mb_x in range(self.mb_w):
            mb = {}
            if self.update_map:
                mb["segment"] = (2 + br.bit(self.seg_probs[2])) if br.bit(self.seg_probs[0]) \
                    else br.bit(self.seg_probs[1])
            else:
                mb["segment"] = 0
            mb["skip"] = br.bit(self.skip_p) if self.use_skip else 0
            t = top[4 * mb_x:4 * mb_x + 4]
            mb["i4x4"] = not br.bit(145)
            if not mb["i4x4"]:
                if br.bit(156):
                    ymode = TM_PRED if br.bit(128) else H_PRED
                else:
                    ymode = V_PRED if br.bit(163) else DC_PRED
                mb["modes"] = [ymode]
                t[:] = [ymode] * 4
                left[:] = [ymode] * 4
            else:
                modes = []
                for y in range(4):
                    ymode = left[y]
                    for x in range(4):
                        prob = T.BMODES_PROBA[(t[x] * 10 + ymode) * 9:(t[x] * 10 + ymode) * 9 + 9]
                        i = YMODES_INTRA4[br.bit(prob[0])]
                        while i > 0:
                            i = YMODES_INTRA4[2 * i + br.bit(prob[i])]
                        ymode = -i
                        t[x] = ymode
                    modes += t
                    left[y] = ymode
                mb["modes"] = modes
            top[4 * mb_x:4 * mb_x + 4] = t
            if not br.bit(142):
                mb["uv"] = DC_PRED
            elif not br.bit(114):
                mb["uv"] = V_PRED
            else:
                mb["uv"] = TM_PRED if br.bit(183) else H_PRED
            mbs.append(mb)

    def _residuals(self, br: _Bool, mb: dict, top: list, left: list):
        """ParseResiduals: ([24 * 16] coefficients, [24] transform codes
        (NzCodeBits: 3 full, 2 three coefficients, 1 DC only, 0 none));
        `top` and `left` are [nz, nz_dc] context pairs, updated."""
        q = self.dqm[mb["segment"]]
        coeffs = [0] * 384
        codes = [0] * 24
        if not mb["i4x4"]:
            dc = [0] * 16
            nz = _coeffs(br, self.bands[1], top[1] + left[1], q["y2"], 0, dc, 0)
            top[1] = left[1] = int(nz > 0)
            values = _wht(dc) if nz > 1 else [(dc[0] + 3) >> 3] * 16
            for i in range(16):
                coeffs[16 * i] = values[i]
            first, ac = 1, self.bands[0]
        else:
            first, ac = 0, self.bands[3]
        tnz, lnz = top[0] & 0x0F, left[0] & 0x0F
        for y in range(4):
            l = lnz & 1
            for x in range(4):
                base = 16 * (4 * y + x)
                nz = _coeffs(br, ac, l + (tnz & 1), q["y1"], first, coeffs, base)
                l = int(nz > first)
                tnz = (tnz >> 1) | (l << 7)
                codes[4 * y + x] = 3 if nz > 3 else 2 if nz > 1 else int(coeffs[base] != 0)
            tnz >>= 4
            lnz = (lnz >> 1) | (l << 7)
        out_t, out_l = tnz, lnz >> 4
        for ch in (0, 2):
            tnz = (top[0] >> (4 + ch)) & 0xFF
            lnz = (left[0] >> (4 + ch)) & 0xFF
            for y in range(2):
                l = lnz & 1
                for x in range(2):
                    base = 16 * (16 + 2 * ch + 2 * y + x)
                    nz = _coeffs(br, self.bands[2], l + (tnz & 1), q["uv"], 0, coeffs, base)
                    l = int(nz > 0)
                    tnz = (tnz >> 1) | (l << 3)
                    codes[16 + 2 * ch + 2 * y + x] = \
                        3 if nz > 3 else 2 if nz > 1 else int(coeffs[base] != 0)
                tnz >>= 2
                lnz = (lnz >> 1) | (l << 5)
            out_t |= (tnz << 4) << ch
            out_l |= (lnz & 0xF0) << ch
        top[0] = out_t & 0xFF
        left[0] = out_l & 0xFF
        return coeffs, codes

    def _frame(self, br0: _Bool) -> None:
        mb_w, mb_h = self.mb_w, self.mb_h
        self.finfo = []
        self._strengths()
        intra_top = [B_DC] * (4 * mb_w)
        nz_top = [[0, 0] for _ in range(mb_w)]
        coeffs = np.zeros((mb_h, mb_w, 384), np.int64)
        codes = np.zeros((mb_h, mb_w, 24), np.int64)
        self.mbs = []
        for mb_y in range(mb_h):
            mbs = []
            self._intra_row(br0, intra_top, mbs)
            if br0.eof:
                raise _Refused(LOSSY_END)
            tokens = self.parts[mb_y & (len(self.parts) - 1)]
            nz_left = [0, 0]
            for mb_x, mb in enumerate(mbs):
                if not mb["skip"]:
                    values, block_codes = self._residuals(tokens, mb, nz_top[mb_x], nz_left)
                    coeffs[mb_y, mb_x] = values
                    codes[mb_y, mb_x] = block_codes
                    skip = not any(block_codes)
                else:
                    nz_top[mb_x][0] = nz_left[0] = 0
                    if not mb["i4x4"]:
                        nz_top[mb_x][1] = nz_left[1] = 0
                    skip = True
                if tokens.eof:
                    raise _Refused(LOSSY_END)
                if self.filter_type:
                    limit, ilevel, inner, hev = self.fstrengths[mb["segment"]][int(mb["i4x4"])]
                    self.finfo.append((limit, ilevel, int(inner or not skip), hev))
            self.mbs.append(mbs)
        self._reconstruct(coeffs, codes)

    def _strengths(self) -> None:
        """PrecomputeFilterStrengths: (limit, interior limit, inner edges,
        hev threshold) by segment and by 4x4 mode."""
        self.fstrengths = []
        for s in range(4):
            if self.use_segment:
                base = self.seg_filter[s] + (0 if self.absolute_delta else self.level)
            else:
                base = self.level
            row = []
            for i4x4 in (0, 1):
                level = base
                if self.use_lf_delta:
                    level += self.ref_lf_delta[0]
                    if i4x4:
                        level += self.mode_lf_delta[0]
                level = 0 if level < 0 else 63 if level > 63 else level
                if level > 0:
                    ilevel = level
                    if self.sharpness > 0:
                        ilevel >>= 2 if self.sharpness > 4 else 1
                        ilevel = min(ilevel, 9 - self.sharpness)
                    ilevel = max(ilevel, 1)
                    row.append((2 * level + ilevel, ilevel, bool(i4x4),
                                2 if level >= 40 else 1 if level >= 15 else 0))
                else:
                    row.append((0, 0, bool(i4x4), 0))
            self.fstrengths.append(row)

    def _reconstruct(self, coeffs: np.ndarray, codes: np.ndarray) -> None:
        """ReconstructRow over the frame, a wavefront at a time: the
        prediction from the unfiltered frame plus the residuals. libwebp's
        x86-64 build runs a block with more than three coefficients (and a
        chroma plane with any such block) through its SSE2 transform, in
        16-bit lanes that wrap; the others through its C transforms. Every
        block's both forms are computed at once and each block takes its
        own (they differ only on extreme coefficients)."""
        mb_w, mb_h = self.mb_w, self.mb_h
        self.Y = np.zeros((16 * mb_h, 16 * mb_w), np.uint8)
        self.U = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
        self.V = np.zeros((8 * mb_h, 8 * mb_w), np.uint8)
        flat = coeffs.reshape(-1, 16)
        res = _idct(flat).reshape(mb_h, mb_w, 24, 4, 4)
        wide = _idct_sse2(flat).reshape(mb_h, mb_w, 24, 4, 4)
        sse2 = codes == 3
        for first in (16, 20):
            sse2[..., first:first + 4] = (codes[..., first:first + 4] >= 2).any(-1, keepdims=True)
        i4 = np.array([[mb["i4x4"] for mb in row] for row in self.mbs], bool)
        ymode = np.array([[mb["modes"][0] for mb in row] for row in self.mbs], np.int64)
        uvmode = np.array([[mb["uv"] for mb in row] for row in self.mbs], np.int64)

        def add(pred, my, mx, blocks, per_row):
            s = np.broadcast_to(sse2[my, mx, blocks][..., None, None],
                                (len(my), per_row * per_row, 4, 4))
            r = blocks_to_plane(res[my, mx, blocks], per_row)
            w = blocks_to_plane(wide[my, mx, blocks], per_row)
            return np.where(blocks_to_plane(s, per_row), np.clip(_wrap(pred + w), 0, 255),
                            np.clip(pred + r, 0, 255))

        for my, mx in _diagonals(mb_w, mb_h):
            sel = ~i4[my, mx]
            if sel.any():
                sy, sx = my[sel], mx[sel]
                top, left, tl = neighbours(self.Y, sy, sx, 16)
                pred = predict_batch(ymode[sy, sx], top, left, tl, sy, sx, 16)
                put_blocks(self.Y, sy, sx, add(pred, sy, sx, slice(0, 16), 4))
            for y, x in zip(my[~sel].tolist(), mx[~sel].tolist()):
                top, left, tl = neighbours(self.Y, np.array([y]), np.array([x]), 16)
                modes = self.mbs[y][x]["modes"]
                r = res[y, x, :16].reshape(16, 16).tolist()
                w = wide[y, x, :16].reshape(16, 16).tolist()
                full = sse2[y, x, :16].tolist()

                def block(n, above, left4, corner, modes=modes, r=r, w=w, full=full):
                    pred = _predict4(modes[n], above, left4, corner)
                    if full[n]:
                        return [_clip(_wrap(pred[k] + w[n][k])) for k in range(16)]
                    return [_clip(pred[k] + r[n][k]) for k in range(16)]

                i4_reconstruct(self.Y, x, y, mb_w, top[0].tolist(), left[0].tolist(),
                               int(tl[0]), block)
            for plane, first in ((self.U, 16), (self.V, 20)):
                top, left, tl = neighbours(plane, my, mx, 8)
                pred = predict_batch(uvmode[my, mx], top, left, tl, my, mx, 8)
                put_blocks(plane, my, mx, add(pred, my, mx, slice(first, first + 4), 2))

    def _loop_filter(self) -> None:
        """DoFilter over every macroblock in raster order. A macroblock's
        filters touch only itself, the 4 columns left of it and the 4 rows
        above it, so macroblock (x, y) waits only for (x - 1, y) and
        (x + 1, y - 1): those with the same x + 2y are filtered together,
        edge by edge in libwebp's order (left, inner vertical, top, inner
        horizontal), luma and both chroma planes in one pass an edge."""
        if not self.filter_type:
            return
        simple = self.filter_type == 1
        Y = self.Y.astype(np.int64)
        UV = np.concatenate([self.U, self.V], axis=1).astype(np.int64)  # V right of U
        info = np.array(self.finfo, np.int64).reshape(self.mb_h, self.mb_w, 4)
        # (across columns, luma edge, chroma edge or None): None at 8 and 12
        steps = [(True, 0, 0), (True, 4, 4), (True, 8, None), (True, 12, None),
                 (False, 0, 0), (False, 4, 4), (False, 8, None), (False, 12, None)]
        for my, mx in _diagonals(self.mb_w, self.mb_h):
            keep = info[my, mx, 0] > 0
            my, mx = my[keep], mx[keep]
            if not len(my):
                continue
            limit, ilevel, inner, hev = (info[my, mx, k] for k in range(4))
            for across, at, chroma_at in steps:
                sel = (mx > 0 if across else my > 0) if at == 0 else inner.astype(bool)
                if not sel.any():
                    continue
                thresh = limit + 4 if at == 0 else limit
                parts = [(Y, _edge_lines(my[sel] * 16, mx[sel] * 16, 16, at, across), 16)]
                if chroma_at is not None and not simple:
                    cy = np.concatenate([my[sel], my[sel]]) * 8
                    cx = np.concatenate([mx[sel], mx[sel] + self.mb_w]) * 8
                    parts.append((UV, _edge_lines(cy, cx, 8, chroma_at, across), 8))
                segs = [plane[idx] for plane, idx, _ in parts]
                per = [np.repeat(v[sel], 16) for v in (thresh, ilevel, hev)]
                if len(parts) > 1:
                    per = [np.concatenate([p, np.tile(np.repeat(v[sel], 8), 2)])
                           for p, v in zip(per, (thresh, ilevel, hev))]
                seg = np.concatenate(segs)
                if simple:
                    _simple(seg, per[0])
                else:
                    _complex(seg, *per, at == 0)
                start = 0
                for (plane, idx, _), part in zip(parts, segs):
                    plane[idx] = seg[start:start + len(part)]
                    start += len(part)
        self.Y = Y.astype(np.uint8)
        cw = self.U.shape[1]
        self.U, self.V = UV[:, :cw].astype(np.uint8), UV[:, cw:].astype(np.uint8)

    def _rgb(self) -> np.ndarray:
        """EmitFancyRGB: the chroma upsampled by libwebp's 9-3-3-1 filter
        (edges replicated), then VP8YuvToRgb."""
        w, h = self.width, self.height
        y = self.Y[:h, :w].astype(np.int64)
        uw, uh = (w + 1) >> 1, (h + 1) >> 1
        u = _upsample(self.U[:uh, :uw].astype(np.int64), h, w)
        v = _upsample(self.V[:uh, :uw].astype(np.int64), h, w)
        yy = (y * 19077) >> 8
        r = _clip8(yy + ((v * 26149) >> 8) - 14234)
        g = _clip8(yy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708)
        b = _clip8(yy + ((u * 33050) >> 8) - 17685)
        return np.stack([r, g, b], axis=-1).astype(np.uint8)


def _clip8(v: np.ndarray) -> np.ndarray:
    """VP8Clip8: 14-bit fixed point to 0..255."""
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def _near_far(n: int, m: int):
    """For output samples 0..n-1 of a 2x upsampled plane of m samples: the
    nearer and the farther source sample (libwebp's fancy upsampler, edges
    replicated)."""
    i = np.arange(n)
    near = np.where(i & 1, (i - 1) >> 1, i >> 1)
    far = np.where(i & 1, (i + 1) >> 1, (i >> 1) - 1)
    return np.clip(near, 0, m - 1), np.clip(far, 0, m - 1)


def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """(9·nn + 3·nf + 3·fn + ff + 8) >> 4 over near and far rows and
    columns."""
    rn, rf = _near_far(h, c.shape[0])
    cn, cf = _near_far(w, c.shape[1])
    nn = c[rn][:, cn]
    nf = c[rn][:, cf]
    fn = c[rf][:, cn]
    ff = c[rf][:, cf]
    return (9 * nn + 3 * nf + 3 * fn + ff + 8) >> 4


def _edge_lines(y0: np.ndarray, x0: np.ndarray, size: int, at: int, across_columns: bool):
    """Index arrays [lines, 8] of the taps p3..q3 across one edge of each
    macroblock (top-left corners y0, x0): the edge `at` pixels in, across
    columns (a vertical edge) or rows, `size` lines each."""
    lines = np.arange(size)
    taps = np.arange(-4, 4)
    if across_columns:
        rows = np.repeat((y0[:, None] + lines).reshape(-1, 1), 8, axis=1)
        cols = np.repeat(x0 + at, size)[:, None] + taps
    else:
        rows = np.repeat(y0 + at, size)[:, None] + taps
        cols = np.repeat((x0[:, None] + lines).reshape(-1, 1), 8, axis=1)
    return rows, cols


def _simple(seg: np.ndarray, thresh) -> None:
    """The simple filter across one edge: `seg` [lines, 8] (p3..p0 |
    q0..q3), changed in place (p0 and q0 only)."""
    p1, p0, q0, q1 = (seg[:, k].copy() for k in range(2, 6))
    mask = 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    a1 = np.clip((a + 4) >> 3, -16, 15)
    a2 = np.clip((a + 3) >> 3, -16, 15)
    seg[:, 3] = np.where(mask, np.clip(p0 + a2, 0, 255), p0)
    seg[:, 4] = np.where(mask, np.clip(q0 - a1, 0, 255), q0)


def _complex(seg: np.ndarray, thresh, ithresh, hev_thresh, edge: bool) -> None:
    """The normal filter across one edge: `seg` [lines, 8] (p3..p0 |
    q0..q3), changed in place; 6 taps on a macroblock edge, 4 on an inner
    one, 2 where the edge variance is high."""
    p3, p2, p1, p0, q0, q1, q2, q3 = (seg[:, k].copy() for k in range(8))
    mask = (4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= 2 * thresh + 1) & \
        (np.abs(p3 - p2) <= ithresh) & (np.abs(p2 - p1) <= ithresh) & \
        (np.abs(p1 - p0) <= ithresh) & (np.abs(q3 - q2) <= ithresh) & \
        (np.abs(q2 - q1) <= ithresh) & (np.abs(q1 - q0) <= ithresh)
    hev = (np.abs(p1 - p0) > hev_thresh) | (np.abs(q1 - q0) > hev_thresh)
    # DoFilter2 where the variance is high
    a = 3 * (q0 - p0) + np.clip(p1 - q1, -128, 127)
    f2_a1 = np.clip((a + 4) >> 3, -16, 15)
    f2_a2 = np.clip((a + 3) >> 3, -16, 15)
    m2 = mask & hev
    new_p0 = np.where(m2, np.clip(p0 + f2_a2, 0, 255), p0)
    new_q0 = np.where(m2, np.clip(q0 - f2_a1, 0, 255), q0)
    new_p1, new_q1, new_p2, new_q2 = p1, q1, p2, q2
    mo = mask & ~hev
    if edge:  # DoFilter6
        w = np.clip(3 * (q0 - p0) + np.clip(p1 - q1, -128, 127), -128, 127)
        a1 = (27 * w + 63) >> 7
        a2 = (18 * w + 63) >> 7
        a3 = (9 * w + 63) >> 7
        new_p2 = np.where(mo, np.clip(p2 + a3, 0, 255), p2)
        new_p1 = np.where(mo, np.clip(p1 + a2, 0, 255), p1)
        new_p0 = np.where(mo, np.clip(p0 + a1, 0, 255), new_p0)
        new_q0 = np.where(mo, np.clip(q0 - a1, 0, 255), new_q0)
        new_q1 = np.where(mo, np.clip(q1 - a2, 0, 255), q1)
        new_q2 = np.where(mo, np.clip(q2 - a3, 0, 255), q2)
    else:  # DoFilter4
        a = 3 * (q0 - p0)
        a1 = np.clip((a + 4) >> 3, -16, 15)
        a2 = np.clip((a + 3) >> 3, -16, 15)
        a3 = (a1 + 1) >> 1
        new_p1 = np.where(mo, np.clip(p1 + a3, 0, 255), p1)
        new_p0 = np.where(mo, np.clip(p0 + a2, 0, 255), new_p0)
        new_q0 = np.where(mo, np.clip(q0 - a1, 0, 255), new_q0)
        new_q1 = np.where(mo, np.clip(q1 - a3, 0, 255), q1)
    seg[:, 1] = new_p2
    seg[:, 2] = new_p1
    seg[:, 3] = new_p0
    seg[:, 4] = new_q0
    seg[:, 5] = new_q1
    seg[:, 6] = new_q2


def lossy_plain(payload: bytes, width: int, height: int) -> tuple:
    """Plain version of ``native.webp_lossy``: a VP8 chunk's payload (to
    the fragment's end) → (status, [h, w, 3] uint8 RGB or None)."""
    try:
        return OK, _Lossy(payload, width, height).decode()
    except _Refused as r:
        return r.code, None
