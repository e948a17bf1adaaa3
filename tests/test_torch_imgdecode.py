"""The port's image decoder against PIL, bit for bit.

``spacedrive_tpu_torch/media/imgdecode.py`` must give the 32×32 grid of
``PIL.Image.open(p).convert("L").resize((32, 32), Image.LANCZOS)`` (the JAX
package's ``image_to_grid``) on every PNG and BMP it takes, through its
native C++ passes and through their plain versions, and raise on everything
else. Images of 1–80 px a side come from hypothesis through the test-side
writer in ``chip_smoke.py`` (every colour type and depth, the row filter
forced per row), and from PIL's own encoders; larger PIL-saved images
cover the downscales the near-dup corpus has. Tests may import PIL; port
files may not.
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
    rows = chip_smoke.pack_bits(values, depth) if depth < 8 else values.astype(np.uint8)
    filters = np.array(draw(st.lists(st.integers(0, 4), min_size=h, max_size=h)))
    return chip_smoke.png_bytes(rows, w, ctype, depth, filters, palette=palette, trns=trns,
                                level=draw(st.integers(0, 9)))


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


UNSUPPORTED = {
    "jpeg": lambda: _pil_bytes("RGB", "JPEG"),
    "gif": lambda: _pil_bytes("P", "GIF"),
    "tiff": lambda: _pil_bytes("RGB", "TIFF"),
    "webp": lambda: _pil_bytes("RGB", "WEBP"),
    "png_16bit": lambda: _pil_bytes("I;16", "PNG"),
    "png_16bit_rgb": lambda: _png_with(2, 16),
    "png_interlaced": lambda: _png_with(interlace=1),
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
