"""The port's image decoder against PIL, bit for bit.

``spacedrive_tpu_torch/media/imgdecode.py`` must give the 32×32 grid of
``PIL.Image.open(p).convert("L").resize((32, 32), Image.LANCZOS)`` (the JAX
package's ``image_to_grid``) on every PNG, BMP, GIF and ICO it takes (JPEG,
TIFF and WebP have ``tests/test_torch_jpeg.py``, ``test_torch_tiff.py`` and
``test_torch_webp.py``), through its native C++ passes and through their
plain versions, and raise on everything else (``UNSUPPORTED``: AVIF, and a
sample of each format's refusals). Images of
1–80 px a side come from hypothesis through the test-side writers in
``chip_smoke.py`` (every PNG colour type and depth, 16-bit included,
Adam7 or not, the row filter forced per row), and from PIL's own encoders;
larger PIL-saved images cover the downscales the near-dup corpus has.
Tests may import PIL; port files may not.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import chip_smoke
from spacedrive_tpu_torch import native
from spacedrive_tpu_torch.media import imgdecode
from spacedrive_tpu_torch.media.imgdecode import UnsupportedImage

PNG_FORMS = [(c, d) for c, depths in imgdecode.PNG_DEPTHS.items() for d in depths]


def pil_grid(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("L").resize((32, 32), Image.LANCZOS), np.float32)


def assert_pils(data: bytes) -> None:
    want = pil_grid(data)
    for native_passes in (True, False):
        got = imgdecode.decode_grid(data, native=native_passes)
        assert got.dtype == np.float32 and got.shape == (32, 32)
        assert np.array_equal(got, want), f"native={native_passes}"


@st.composite
def png_images(draw):
    ctype, depth = draw(st.sampled_from(PNG_FORMS))
    w, h = draw(st.integers(1, 80)), draw(st.integers(1, 80))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    channels = chip_smoke.PNG_CHANNELS[ctype]
    palette = trns = None
    if ctype == 3:
        n_colors = draw(st.integers(1, 1 << depth if depth < 8 else 256))
        palette = rng.integers(0, 256, (n_colors, 3))
        values = rng.integers(0, n_colors, (h, w))
        if draw(st.booleans()):
            trns = rng.integers(0, 256, n_colors).astype(np.uint8).tobytes()
    else:
        values = rng.integers(0, 1 << depth, (h, w * channels))
        if draw(st.booleans()) and ctype in (0, 2):
            trns = struct.pack(">" + "H" * channels, *rng.integers(0, 1 << depth, channels))
    if depth < 8:
        rows = chip_smoke.pack_bits(values, depth)
    else:
        rows = chip_smoke.png16_rows(values) if depth == 16 else values.astype(np.uint8)
    filters = np.array(draw(st.lists(st.integers(0, 4), min_size=h, max_size=h)))
    return chip_smoke.png_bytes(rows, w, ctype, depth, filters, palette=palette, trns=trns,
                                level=draw(st.integers(0, 9)),
                                interlace=int(draw(st.booleans())))


@settings(max_examples=40, deadline=None)
@given(png_images())
def test_png_grids_are_pils(data):
    assert_pils(data)


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 80), st.integers(1, 80), st.sampled_from([8, 24, 32]),
       st.booleans(), st.integers(0, 2**32 - 1))
def test_bmp_grids_are_pils(w, h, bits, top_down, seed):
    rng = np.random.default_rng(seed)
    if bits == 8:
        colors = int(rng.integers(3, 257))
        data = chip_smoke.bmp_bytes(rng.integers(0, colors, (h, w)),
                                    palette=rng.integers(0, 256, (colors, 3)),
                                    top_down=top_down)
    else:
        alpha = rng.integers(0, 256, (h, w)) if bits == 32 else None
        data = chip_smoke.bmp_bytes(rng.integers(0, 256, (h, w, 3)), alpha=alpha,
                                    top_down=top_down)
    assert_pils(data)


@pytest.mark.parametrize("fmt,mode", [(f, m) for f in ("PNG", "BMP")
                                      for m in ("L", "RGB", "RGBA", "P", "LA", "1")
                                      if (f, m) not in (("BMP", "LA"), ("BMP", "1"))])
@pytest.mark.parametrize("w,h", [(400, 300), (97, 33), (32, 301), (5, 3)])
def test_pil_saved_images_are_pils(fmt, mode, w, h):
    rng = np.random.default_rng(w * h)
    base = Image.fromarray(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), "RGBA")
    im = base.convert("RGB").quantize(77) if mode == "P" else base.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt)
    assert_pils(buf.getvalue())


@pytest.mark.parametrize("ctype,depth", PNG_FORMS)
@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("w,h", [(1, 1), (3, 2), (9, 7), (37, 41)])
def test_adam7_and_16bit_pngs_are_pils(ctype, depth, interlace, w, h):
    """Every colour type and depth, Adam7 or not, at sizes whose passes are
    empty, partial and whole; 16-bit gray with values past 255 (PIL's
    I;16 clips)."""
    rng = np.random.default_rng(ctype * 100 + depth + interlace * 7 + w)
    channels = chip_smoke.PNG_CHANNELS[ctype]
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (1 << min(depth, 7), 3))
        values = rng.integers(0, len(palette), (h, w))
    else:
        values = rng.integers(0, 1 << depth, (h, w * channels))
        if (ctype, depth) == (0, 16):
            values = np.where(rng.random((h, w)) < 0.5, rng.integers(0, 300, (h, w)), values)
    if depth < 8:
        rows = chip_smoke.pack_bits(values, depth)
    else:
        rows = chip_smoke.png16_rows(values) if depth == 16 else values.astype(np.uint8)
    assert_pils(chip_smoke.png_bytes(rows, w, ctype, depth, rng.integers(0, 5, h),
                                     palette=palette, interlace=interlace))


@pytest.mark.parametrize("case", ["global", "local", "interlaced", "local_interlaced",
                                  "screen_past_frame", "transparent_fill",
                                  "frame_past_screen", "identity_palette", "two_colours"])
@pytest.mark.parametrize("w,h", [(1, 1), (13, 9), (70, 45)])
def test_gif_grids_are_pils(case, w, h):
    """The first frame of GIFs from the harness writer: a global or local
    palette, interlaced rows, a frame smaller than the screen (the rest
    index 0, or the transparent index), a frame past the screen (the
    screen grows), the identity palette (PIL opens that as L)."""
    rng = np.random.default_rng(w * h)
    k = 2 if case == "two_colours" else 200
    palette = np.repeat(np.arange(256)[:, None], 3, 1) if case == "identity_palette" else \
        rng.integers(0, 256, (k, 3))
    indices = rng.integers(0, len(palette), (h, w))
    kw = {"global": {}, "local": {"local": True}, "interlaced": {"interlace": True},
          "local_interlaced": {"local": True, "interlace": True},
          "screen_past_frame": {"screen": (w + 6, h + 2), "offset": (3, 1)},
          "transparent_fill": {"screen": (w + 4, h + 5), "offset": (0, 5),
                               "transparency": 7},
          "frame_past_screen": {"screen": (max(1, w // 2), max(1, h // 2)), "offset": (2, 3)},
          "identity_palette": {}, "two_colours": {}}[case]
    assert_pils(chip_smoke.gif_bytes(indices, palette, **kw))


@pytest.mark.parametrize("frames", ["png", "dib32", "dib24", "dib8", "dib4", "dib1",
                                    "dib1_black_white", "png_and_dib", "same_size_depths"])
@pytest.mark.parametrize("size", [16, 37, 64])
def test_ico_grids_are_pils(frames, size):
    """ICOs of PNG and DIB frames: PIL takes the largest frame, among equal
    sizes the least bit count, and reads a DIB through its AND mask."""
    rng = np.random.default_rng(size)
    px = rng.integers(0, 256, (size, size, 3))

    def dib(bits, palette=None):
        if bits > 8:
            return chip_smoke.dib_bytes(px, bits, alpha=rng.integers(0, 256, (size, size)),
                                        mask=rng.integers(0, 2, (size, size)))
        palette = rng.integers(0, 256, (1 << bits, 3)) if palette is None else palette
        return chip_smoke.dib_bytes(rng.integers(0, len(palette), (size, size)), bits,
                                    palette=palette, mask=rng.integers(0, 2, (size, size)))

    png = chip_smoke.png_bytes(px.reshape(size, -1).astype(np.uint8), size, 2, 8,
                               np.zeros(size, np.int64))
    small = chip_smoke.dib_bytes(px[:8, :8], 24)
    big = {"png": [(png, 32)], "dib32": [(dib(32), 32)], "dib24": [(dib(24), 24)],
           "dib8": [(dib(8), 8)], "dib4": [(dib(4), 4)], "dib1": [(dib(1), 1)],
           "dib1_black_white": [(dib(1, [[0, 0, 0], [255, 255, 255]]), 1)],
           "png_and_dib": [(dib(24), 24), (png, 32)],
           "same_size_depths": [(dib(32), 32), (dib(8), 8), (dib(24), 24)]}[frames]
    assert_pils(chip_smoke.ico_bytes([(small, 8, 8, 24)] +
                                     [(data, size, size, bits) for data, bits in big]))


@pytest.mark.parametrize("fmt,mode,kw", [
    ("PNG", "I;16", {}), ("GIF", "P", {}), ("GIF", "L", {}), ("GIF", "RGB", {}),
    ("GIF", "P", {"interlace": False}), ("ICO", "RGBA", {}),
    ("ICO", "RGBA", {"bitmap_format": "bmp"}), ("ICO", "RGB", {"bitmap_format": "bmp"})])
@pytest.mark.parametrize("w,h", [(97, 33), (40, 40), (5, 3)])
def test_pil_saved_16bit_gif_and_ico_are_pils(fmt, mode, kw, w, h):
    rng = np.random.default_rng(w * h + len(kw))
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 600, (h, w)).astype(np.uint16))
    else:
        base = Image.fromarray(rng.integers(0, 256, (h, w, 4), dtype=np.uint8), "RGBA")
        im = base.convert("RGB").quantize(77) if mode == "P" else base.convert(mode)
    if fmt == "ICO":
        kw = dict(kw, sizes=[(16, 16), (w, h)])
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    assert_pils(buf.getvalue())


def _pil_bytes(mode: str, fmt: str, **kw) -> bytes:
    buf = io.BytesIO()
    Image.new(mode, (20, 10), 128).save(buf, fmt, **kw)
    return buf.getvalue()


def _png_with(ctype=2, depth=8, interlace=0, extra=b"", crc_flip=False, cut=None):
    rows = np.full((4, 6 * chip_smoke.PNG_CHANNELS[ctype] * depth // 8), 7, np.uint8)
    palette = np.zeros((2, 3)) if ctype == 3 else None
    data = chip_smoke.png_bytes(rows, 6, ctype, depth, np.zeros(4, np.int64),
                                palette=palette, interlace=interlace)
    if extra:
        data = data[:-12] + extra + data[-12:]
    if crc_flip:
        data = data[:29] + bytes([data[29] ^ 1]) + data[30:]
    return data[:cut] if cut else data


def _flip_crc(chunk: bytes) -> bytes:
    return chunk[:-1] + bytes([chunk[-1] ^ 1])


def _png_walk(case: str) -> bytes:
    """A 40×30 RGB PNG whose chunks after the header are laid out as `case`
    names: PIL reads past CRCs from the first IDAT on and stops at the
    first chunk after the IDAT run or at the end of the file."""
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, (30, 120)).astype(np.uint8)
    z = zlib.compress(chip_smoke.png_filter(rows, 3, np.zeros(30, np.int64)))
    head = chip_smoke.PNG_SIGNATURE + chip_smoke.png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", 40, 30, 8, 2, 0, 0, 0))
    idat = chip_smoke.png_chunk(b"IDAT", z)
    halves = [chip_smoke.png_chunk(b"IDAT", z[:len(z) // 2]),
              chip_smoke.png_chunk(b"IDAT", z[len(z) // 2:])]
    text = chip_smoke.png_chunk(b"tEXt", b"k\x00v")
    plte = chip_smoke.png_chunk(b"PLTE", bytes(range(12)))
    iend = chip_smoke.png_chunk(b"IEND", b"")
    return head + {
        "idat_bad_crc": _flip_crc(idat) + iend,
        "second_idat_bad_crc": halves[0] + _flip_crc(halves[1]) + iend,
        "text_after_idat_bad_crc": idat + _flip_crc(text) + iend,
        "no_iend": idat,
        "iend_bad_crc": idat + _flip_crc(iend),
        "junk_after_idat": idat + b"\x00\x01",
        "plte_after_idat": idat + plte + iend,
        "text_before_idat_bad_crc": _flip_crc(text) + idat + iend,
        "idat_cut_midway": halves[0] + iend,
    }[case]


@pytest.mark.parametrize("case", ["idat_bad_crc", "second_idat_bad_crc",
                                  "text_after_idat_bad_crc", "no_iend", "iend_bad_crc",
                                  "junk_after_idat", "plte_after_idat"])
def test_png_chunk_walk_reads_what_pil_reads(case):
    assert_pils(_png_walk(case))


@pytest.mark.parametrize("case", ["text_before_idat_bad_crc", "idat_cut_midway"])
def test_png_chunk_walk_refuses_what_pil_refuses(case):
    """PIL refuses these (a bad CRC before IDAT, IDAT data cut midway); the
    port's refusals are in UNSUPPORTED."""
    with pytest.raises((OSError, SyntaxError)):
        pil_grid(_png_walk(case))


def _pil_tiff_compressed(mode: str, compression: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(_scene()).convert(mode).save(buf, "TIFF", compression=compression)
    return buf.getvalue()


def _jpeg(**kw) -> bytes:
    rng = np.random.default_rng(7)
    return chip_smoke.jpeg_bytes(rng.integers(0, 256, (20, 28, 3), dtype=np.uint8), **kw)


def _sof(data: bytes, marker: bytes = None, precision: int = None) -> bytes:
    """`data` with its frame header's marker or sample precision replaced."""
    at = data.index(b"\xff\xc0") if b"\xff\xc0" in data else data.index(b"\xff\xc2")
    if marker is not None:
        data = data[:at] + marker + data[at + 2:]
    if precision is not None:
        data = data[:at + 4] + bytes([precision]) + data[at + 5:]
    return data


def _dht_counts(data: bytes, counts: bytes) -> bytes:
    """`data` with its first Huffman table's code counts by length replaced
    (the same total: more codes of a length than it holds)."""
    at = data.index(b"\xff\xc4") + 5
    return data[:at] + counts + data[at + 16:]


def _drop_last_scan(data: bytes) -> bytes:
    """A progressive file without its last scan (the DC refinement)."""
    return data[:data.rindex(b"\xff\xda")] + b"\xff\xd9"


def _extreme_block() -> bytes:
    """A DC coefficient whose dequantised value (2047 x 9) passes the SIMD
    IDCT's 16-bit range."""
    block = np.zeros((1, 1, 64), np.int64)
    block[0, 0, 0] = 2047
    return chip_smoke.jpeg_from_coefficients([block], 8, 8, [(1, 1)], [np.full(64, 9)])


def _gif(**kw) -> bytes:
    rng = np.random.default_rng(8)
    return chip_smoke.gif_bytes(rng.integers(0, 4, (9, 11)), rng.integers(0, 256, (4, 3)), **kw)


def _scene(h: int = 20, w: int = 28) -> np.ndarray:
    return np.clip(chip_smoke.image_scene(np.random.default_rng(4), h, w), 0, 255).astype(
        np.uint8)


def _tiff(**kw) -> bytes:
    return chip_smoke.tiff_bytes(chip_smoke.tiff_image(_scene(), 2, 8, **kw))


def _webp_lossy(**kw) -> bytes:
    return chip_smoke.webp_lossy_bytes(_scene(), np.random.default_rng(4), **kw)


UNSUPPORTED = {
    "avif": lambda: _pil_bytes("RGB", "AVIF"),
    "tiff_truncated": lambda: _tiff(compression=5)[:-30],
    "tiff_big_endian_bigtiff": lambda: chip_smoke.tiff_bytes(
        chip_smoke.tiff_image(_scene(), 2, 8), order=">", bigtiff=True),
    "tiff_cmyk": lambda: _pil_bytes("CMYK", "TIFF"),
    "tiff_ccitt_group4": lambda: _pil_tiff_compressed("1", "group4"),
    "tiff_floating_point_predictor": lambda: _tiff(compression=8, predictor=3),
    "tiff_lzw_code_past_table": lambda: chip_smoke.tiff_bytes((chip_smoke.tiff_image(
        np.zeros((4, 4), np.int64), 1, 8, compression=5)[0], [chip_smoke._pack_msb(
            np.array([256, 1, 300, 257]), np.array([9, 9, 9, 9]))])),
    "webp_truncated": lambda: _webp_lossy()[:-10],
    "webp_vp8_cut": lambda: chip_smoke.webp_vp8_cut(np.random.default_rng(1), _scene(40, 60)),
    "webp_vp8l_version_bits": lambda: (lambda d: d[:24] + bytes([d[24] | 0x20]) + d[25:])(
        chip_smoke.webp_lossless_bytes(_scene())),
    "webp_alph_reserved_bits": lambda: (lambda d: d[:38] + b"\xc0" + d[39:])(
        _webp_lossy(alpha=np.zeros((20, 28), np.int64))),
    "tiff_old_style_lzw": lambda: chip_smoke.tiff_bytes((chip_smoke.tiff_image(
        np.zeros((4, 4), np.int64), 1, 8, compression=5)[0], [b"\x00\x01" + bytes(10)])),
    "tiff_without_a_width": lambda: chip_smoke.tiff_bytes((
        {k: v for k, v in chip_smoke.tiff_image(_scene(), 2, 8)[0].items() if k != 256},
        chip_smoke.tiff_image(_scene(), 2, 8)[1])),
    "tiff_planar_16_bit_uncompressed": lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        np.full((6, 6, 3), 1000), 2, 16, planar=2)),
    "tiff_palette_without_colormap": lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        np.zeros((4, 4), np.int64), 3, 8)),
    "tiff_tile_past_256_mib": lambda: chip_smoke.tiff_bytes((chip_smoke.tiff_image(
        np.zeros((4, 4, 3), np.int64), 2, 8, tile=(16, 16), tags={
            322: (4, [1 << 16]), 323: (4, [1 << 16])})[0], [bytes(768)])),
    "tiff_lzw_strip_short": lambda: chip_smoke.tiff_bytes((chip_smoke.tiff_image(
        np.zeros((4, 4), np.int64), 1, 8, compression=5)[0], [chip_smoke._pack_msb(
            np.array([256, 1, 2, 257]), np.array([9, 9, 9, 9]))])),
    "webp_riff_size_below_eight": lambda: (lambda d: d[:4] + b"\x04\x00\x00\x00" + d[8:])(
        _webp_lossy()),
    "webp_vp8_partitions_past_data": lambda: chip_smoke.riff_webp(chip_smoke.riff_chunk(
        b"VP8 ", (lambda f: f[:10 + ((f[0] | f[1] << 8 | f[2] << 16) >> 5)])(
            chip_smoke.vp8_frame(_scene(), np.random.default_rng(2))))),
    "webp_vp8l_stream_cut": lambda: chip_smoke.riff_webp(chip_smoke.riff_chunk(
        b"VP8L", chip_smoke.webp_lossless_stream(chip_smoke.rgb_to_argb(_scene()))[:40])),
    "webp_frame_past_its_canvas": lambda: chip_smoke.webp_animation_bytes(
        [(chip_smoke.riff_chunk(b"VP8 ", chip_smoke.vp8_frame(_scene(), np.random.default_rng(
            0))), 4, 0, 28, 20)], (28, 20)),
    "jpeg_no_eoi": lambda: _jpeg()[:-2],
    "jpeg_truncated_scan": lambda: _jpeg()[:-60],
    "jpeg_scan_cut_before_eoi": lambda: _jpeg()[:-60] + b"\xff\xd9",
    "jpeg_arithmetic": lambda: _sof(_jpeg(), marker=b"\xff\xc9"),
    "jpeg_lossless": lambda: _sof(_jpeg(), marker=b"\xff\xc3"),
    "jpeg_12bit": lambda: _sof(_jpeg(), precision=12),
    "jpeg_two_components": lambda: chip_smoke.jpeg_from_coefficients(
        [np.zeros((2, 2, 64), np.int64)] * 2, 16, 16, [(1, 1)] * 2, [np.ones(64)] * 2),
    "jpeg_incomplete_progressive": lambda: _drop_last_scan(_jpeg(progressive=True)),
    "jpeg_block_past_16_bits": _extreme_block,
    "jpeg_oversubscribed_huffman_table": lambda: _dht_counts(
        _jpeg(), bytes([3, 0, 4, 1, 1, 1, 1, 1] + [0] * 8)),
    "gif_truncated": lambda: _gif()[:-12],
    "gif_index_past_palette": lambda: chip_smoke.gif_bytes(np.full((3, 3), 5), np.zeros((4, 3))),
    "gif_no_image": lambda: _gif()[:13 + 12] + b"\x3b",
    "ico_grey_4bit_palette": lambda: chip_smoke.ico_bytes([(chip_smoke.dib_bytes(
        np.zeros((8, 8), np.int64), 4, palette=np.repeat(np.arange(16)[:, None], 3, 1)),
        8, 8, 4)]),
    "ico_truncated": lambda: chip_smoke.ico_bytes([(chip_smoke.dib_bytes(
        np.zeros((8, 8, 3), np.int64), 24), 8, 8, 24)])[:-40],
    "png_truncated": lambda: _png_with(cut=50),
    "png_bad_crc": lambda: _png_with(crc_flip=True),
    "png_bad_crc_text_before_idat": lambda: _png_walk("text_before_idat_bad_crc"),
    "png_idat_cut_midway": lambda: _png_walk("idat_cut_midway"),
    "png_unknown_critical_chunk": lambda: _png_with(extra=chip_smoke.png_chunk(b"ZZZZ", b"x")),
    "png_palette_index_past_plte": lambda: _png_with(3, 8),
    "png_bad_filter_type": lambda: chip_smoke.PNG_SIGNATURE + chip_smoke.png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", 2, 1, 8, 0, 0, 0, 0)) + chip_smoke.png_chunk(
        b"IDAT", zlib.compress(b"\x05ab")) + chip_smoke.png_chunk(b"IEND", b""),
    "bmp_1bit": lambda: _pil_bytes("1", "BMP"),
    "bmp_rle8": lambda: (lambda d: d[:30] + struct.pack("<I", 1) + d[34:])(
        _pil_bytes("P", "BMP")),
    "bmp_two_colours": lambda: chip_smoke.bmp_bytes(np.zeros((3, 3)),
                                                    palette=[[0, 0, 0], [255, 255, 255]]),
    "bmp_truncated": lambda: _pil_bytes("RGB", "BMP")[:-7],
    "random_bytes": lambda: np.random.default_rng(1).integers(0, 256, 500,
                                                              dtype=np.uint8).tobytes(),
    "empty": lambda: b"",
}


@pytest.mark.parametrize("kind", sorted(UNSUPPORTED))
def test_each_unsupported_input_raises(kind, tmp_path):
    data = UNSUPPORTED[kind]()
    for native_passes in (True, False):
        with pytest.raises(UnsupportedImage):
            imgdecode.decode_grid(data, native=native_passes)
    path = tmp_path / "img"
    path.write_bytes(data)
    assert imgdecode.image_to_grid(str(path)) is None


def test_image_to_grid_reads_a_file_and_none_for_a_missing_one(tmp_path):
    data = _pil_bytes("RGB", "PNG")
    (tmp_path / "a.png").write_bytes(data)
    assert np.array_equal(imgdecode.image_to_grid(str(tmp_path / "a.png")), pil_grid(data))
    assert imgdecode.image_to_grid(str(tmp_path / "missing.png")) is None


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
def test_native_unfilter_matches_plain(bpp):
    rng = np.random.default_rng(bpp)
    h, rowbytes = 23, bpp * 17
    rows = np.zeros((h, rowbytes + 1), np.uint8)
    rows[:, 0] = np.arange(h) % 5
    rows[:, 1:] = rng.integers(0, 256, (h, rowbytes))
    raw = rows.tobytes()
    assert np.array_equal(native.png_unfilter(raw, h, rowbytes, bpp),
                          imgdecode.png_unfilter_plain(raw, h, rowbytes, bpp))


def test_native_luma_and_resample_match_plain_on_strided_pixels():
    rng = np.random.default_rng(2)
    px = rng.integers(0, 256, (61, 45, 4), dtype=np.uint8)
    for order in ((0, 1, 2), (2, 1, 0)):
        assert np.array_equal(native.luma(px, order), imgdecode.l24(px[..., list(order)]))
    flipped = px[::-1]
    with pytest.raises(ValueError):
        native.luma(flipped, (0, 1, 2))
    luma = imgdecode.l24(px)
    for edge in (32, 8, 100):
        assert np.array_equal(native.resample_lanczos(luma, edge),
                              imgdecode.resize_lanczos(luma, edge))
