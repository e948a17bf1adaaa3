"""The port's TIFF decoder against PIL (libtiff), bit for bit.

``spacedrive_tpu_torch/media/tiff.py`` with its native strip and tile
decoder (``csrc/tiffdec.cpp``) and the plain version (``chunk_plain``) must
give the L plane of ``PIL.Image.open(p).convert("L")``, and so the JAX
package's ``image_to_grid`` grid, on every TIFF it takes, or refuse it with
the same reason from both versions. Inputs: PIL-saved files of every
compression PIL writes without fault here (none, LZW, Deflate, Adobe
Deflate, PackBits) at modes 1, L, P, RGB, RGBA, LA, I;16 and I;16B (PIL
writes little-endian TIFF only), and the harness writer's files (``chip_smoke.
tiff_image`` / ``tiff_bytes``: II and MM, strips and tiles, chunky and
planar, predictor 2, gray at 1, 2, 4, 8 and 16 bits, white-is-zero, RGB at
8 and 16 bits with and without extra samples, palette at 4 and 8 bits,
BigTIFF, every EXIF orientation, the DNG shape). Tolerance 0 throughout.
"""

import io

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from spacedrive_tpu.ops import phash as jax_phash
from spacedrive_tpu_torch import native
from spacedrive_tpu_torch.media import imgdecode, tiff
from spacedrive_tpu_torch.media.imgdecode import UnsupportedImage


def _scene(seed: int, h: int, w: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.clip(chip_smoke.image_scene(rng, h, w), 0, 255).astype(np.uint8)


def assert_decodes_as_pil(data: bytes, tmp_path) -> None:
    """Native and plain L planes equal PIL's; both grids equal the JAX
    package's image_to_grid on the same file."""
    with Image.open(io.BytesIO(data)) as im:
        want = np.asarray(im.convert("L"))
    for native_passes in (True, False):
        got = imgdecode.decode_luma(data, native=native_passes)
        assert got.shape == want.shape and np.array_equal(got, want), f"native={native_passes}"
    path = tmp_path / "img.tif"
    path.write_bytes(data)
    grid = jax_phash.image_to_grid(str(path))
    assert grid is not None
    for native_passes in (True, False):
        got = imgdecode.image_to_grid(str(path), native=native_passes)
        assert got.dtype == np.float32 and np.array_equal(got, grid), f"native={native_passes}"


def _split_jpeg(jpg: bytes) -> tuple:
    """A JPEG → (its tables-only stream, the stream without its tables and
    APP0): the JPEGTables tag and one strip or tile, as libtiff writes them."""
    pos, tables, rest = 2, b"\xff\xd8", b"\xff\xd8"
    while True:
        marker, length = jpg[pos + 1], int.from_bytes(jpg[pos + 2:pos + 4], "big")
        seg = jpg[pos:pos + 2 + length]
        if marker == 0xDA:
            return tables + b"\xff\xd9", rest + jpg[pos:]
        if marker in (0xDB, 0xC4):
            tables += seg
        elif marker != 0xE0:
            rest += seg
        pos += 2 + length


def _jpeg_tiff(px: np.ndarray, rps: int = None, tile=None, sampling=(2, 2), quality=80,
               progressive=False, photometric=6, tag_sampling=None, short=False,
               orientation=None) -> bytes:
    """A JPEG-compressed TIFF (compression 7) of [h, w, 3] pixels from the
    harness's JPEG writer: YCbCr at `sampling` (photometric 6) or RGB
    components (2), strips of `rps` rows or `tile` (w, h) tiles, edges
    replicated, one JPEGTables stream. `short` writes each strip's stream
    at half its rows."""
    h, w, _ = px.shape
    boxes = ([(y, 0, min(rps, h - y), w) for y in range(0, h, rps)] if tile is None else
             [(y, x, tile[1], tile[0]) for y in range(0, h, tile[1])
              for x in range(0, w, tile[0])])
    chunks, tables = [], None
    for y, x, bh, bw in boxes:
        part = px[y:y + bh, x:x + bw]
        block = np.pad(part, ((0, bh - part.shape[0]), (0, bw - part.shape[1]), (0, 0)),
                       mode="edge")
        if short:
            block = block[:max(1, bh // 2)]
        jpg = chip_smoke.jpeg_bytes(block, quality=quality,
                                    sampling=sampling if photometric != 2 else (1, 1),
                                    progressive=progressive, adobe_rgb=photometric == 2)
        t, r = _split_jpeg(jpg)
        assert tables in (None, t)
        tables = t
        chunks.append(r)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [8, 8, 8]), 259: (3, [7]),
               262: (3, [photometric]), 277: (3, [3]), 284: (3, [1]),
               347: (7, list(tables))}
    if photometric == 6:
        entries[530] = (3, list(tag_sampling or sampling))
    if tile is None:
        entries[278] = (4, [rps])
    else:
        entries[322], entries[323] = (3, [tile[0]]), (3, [tile[1]])
    if orientation is not None:
        entries[274] = (3, [orientation])
    entries["tiled"] = tile is not None
    return chip_smoke.tiff_bytes((entries, chunks))


def _pil_tiff(mode: str, compression: str, h: int = 23, w: int = 37) -> bytes:
    px = _scene(h * w, h, w)
    if mode in ("I;16", "I;16B"):
        values = px[..., 0].astype(np.uint16) * 3  # past 255 in places: I;16 clips
        im = Image.fromarray(values).convert(mode) if mode == "I;16B" else Image.fromarray(values)
    else:
        im = Image.fromarray(px).convert(mode)
    buf = io.BytesIO()
    im.save(buf, "TIFF", compression=compression)
    return buf.getvalue()


PIL_COMPRESSIONS = ["raw", "tiff_lzw", "tiff_deflate", "tiff_adobe_deflate", "packbits"]


@pytest.mark.parametrize("compression", PIL_COMPRESSIONS)
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA", "LA", "I;16", "I;16B"])
def test_pil_saved_tiffs(mode, compression, tmp_path):
    assert_decodes_as_pil(_pil_tiff(mode, compression), tmp_path)


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (64, 80), (131, 9)])
@pytest.mark.parametrize("compression", ["tiff_lzw", "raw"])
def test_pil_saved_tiffs_at_odd_sizes(h, w, compression, tmp_path):
    assert_decodes_as_pil(_pil_tiff("RGB", compression, h, w), tmp_path)


# (photometric, bits, channels, extra samples) of the harness's layouts.
LAYOUTS = {
    "gray1": (1, 1, 1, ()), "white_is_zero1": (0, 1, 1, ()), "gray2": (1, 2, 1, ()),
    "gray4": (1, 4, 1, ()), "white_is_zero4": (0, 4, 1, ()), "gray8": (1, 8, 1, ()),
    "white_is_zero8": (0, 8, 1, ()), "gray16": (1, 16, 1, ()), "rgb8": (2, 8, 3, ()),
    "rgb16": (2, 16, 3, ()), "rgbx8": (2, 8, 4, (0,)), "rgba8": (2, 8, 4, (2,)),
    "rgba_associated8": (2, 8, 4, (1,)), "rgba16": (2, 16, 4, (2,)),
    "rgba_associated16": (2, 16, 4, (1,)), "pal4": (3, 4, 1, ()), "pal8": (3, 8, 1, ()),
    "gray_alpha8": (1, 8, 2, (2,)),
}


def _layout_samples(name: str, h: int, w: int, seed: int):
    photometric, bits, c, extra = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    top = (1 << bits) if bits < 16 else 700  # 16-bit gray passes 255: I;16 clips
    samples = rng.integers(0, top if c == 1 else 1 << bits, (h, w, c))
    if extra == (1,):  # associated alpha: colour at most alpha
        samples[..., :3] = np.minimum(samples[..., :3], samples[..., 3:])
    cmap = rng.integers(0, 1 << 16, (1 << bits, 3)) if photometric == 3 else None
    return samples, photometric, bits, extra, cmap


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("compression", [1, 5, 8, 32946, 32773])
@pytest.mark.parametrize("order", ["<", ">"])
def test_harness_layouts_in_strips(name, compression, order, tmp_path):
    samples, photometric, bits, extra, cmap = _layout_samples(name, 19, 27, compression)
    data = chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        samples, photometric, bits, order=order, compression=compression, rows_per_strip=5,
        extra=extra, colormap=cmap), order=order)
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("name", ["gray8", "gray16", "rgb8", "rgb16", "rgba8", "pal8"])
@pytest.mark.parametrize("compression", [5, 8])
@pytest.mark.parametrize("order", ["<", ">"])
def test_predictor_2(name, compression, order, tmp_path):
    samples, photometric, bits, extra, cmap = _layout_samples(name, 21, 30, 7)
    for planar in (1, 2):
        if planar == 2 and len(extra):
            continue
        data = chip_smoke.tiff_bytes(chip_smoke.tiff_image(
            samples, photometric, bits, order=order, compression=compression, predictor=2,
            planar=planar, rows_per_strip=4, extra=extra, colormap=cmap), order=order)
        assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("compression", [1, 32773])
def test_a_predictor_outside_lzw_and_deflate_is_ignored(compression, tmp_path):
    """PIL's raw unpackers and libtiff's PackBits codec have no predictor:
    the differences are the samples."""
    samples, photometric, bits, extra, cmap = _layout_samples("rgb8", 12, 17, 3)
    data = chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        samples, photometric, bits, compression=compression, predictor=2))
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("name", ["gray1", "gray4", "gray8", "gray16", "rgb8", "rgb16",
                                  "rgba8", "pal4", "pal8"])
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("tile", [(16, 16), (32, 16), (16, 48)])
def test_tiles_cropped_at_the_edges(name, compression, tile, tmp_path):
    samples, photometric, bits, extra, cmap = _layout_samples(name, 37, 41, 11)
    data = chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        samples, photometric, bits, compression=compression, tile=tile, extra=extra,
        colormap=cmap), order=">")
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("name", ["gray8", "rgb8", "rgb16", "pal8", "rgba8"])
@pytest.mark.parametrize("compression", [1, 5, 8, 32773])
@pytest.mark.parametrize("tile", [None, (16, 16)])
def test_planar_layouts(name, compression, tile, tmp_path):
    samples, photometric, bits, extra, cmap = _layout_samples(name, 22, 35, 13)
    data = chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        samples, photometric, bits, compression=compression, planar=2, tile=tile,
        rows_per_strip=6, extra=extra, colormap=cmap))
    if compression != 1 and len(extra) or compression == 1 and bits == 16:
        assert_refused(data, tiff.REASONS[tiff.PLANAR])
    else:
        assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation_is_applied(orientation, tmp_path):
    px = _scene(orientation, 13, 22)
    data = chip_smoke.tiff_bytes(chip_smoke.tiff_image(px, 2, 8, compression=5,
                                                       orientation=orientation))
    assert_decodes_as_pil(data, tmp_path)


def test_an_unknown_planar_configuration_reads_chunky_uncompressed(tmp_path):
    """PIL's raw route takes any value but 2 as chunky (libtiff refuses it,
    see REFUSED)."""
    data = chip_smoke.tiff_bytes(chip_smoke.tiff_image(_scene(6, 7, 9), 2, 8,
                                                       tags={284: (3, [17])}))
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("compression", [1, 5])
def test_little_endian_bigtiff(compression, tmp_path):
    px = _scene(5, 19, 23)
    data = chip_smoke.tiff_bytes(chip_smoke.tiff_image(px, 2, 8, compression=compression,
                                                       rows_per_strip=7), bigtiff=True)
    assert data[:4] == b"II+\x00"
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("order", ["<", ">"])
@pytest.mark.parametrize("compression", [1, 5])
def test_dng_shape_reads_its_preview(order, compression, tmp_path):
    """IFD0 is the 8-bit RGB preview PIL takes; the 16-bit CFA raw image in
    its SubIFDs child is never read."""
    preview = _scene(9, 24, 32)
    raw = np.random.default_rng(9).integers(0, 1 << 16, (48, 64))
    data = chip_smoke.dng_bytes(preview, raw, order, compression)
    assert_decodes_as_pil(data, tmp_path)
    with Image.open(io.BytesIO(data)) as im:
        assert im.size == (32, 24)


@pytest.mark.parametrize("kind", ["tiff_lzw", "tiff_deflate", "tiff_packbits", "tiff_raw",
                                  "dng"])
@pytest.mark.parametrize("seed", range(4))
def test_corpus_kinds(kind, seed, tmp_path):
    """chip_smoke's corpus writer: what the near-dup location on the card
    holds."""
    rng = np.random.default_rng(seed)
    px = _scene(seed, 30 + seed, 41)
    data, ext = chip_smoke.encode_image(rng, px, kind)
    assert ext == ("dng" if kind == "dng" else "tif")
    assert_decodes_as_pil(data, tmp_path)


def assert_refused(data: bytes, reason: str = None) -> str:
    """Both versions raise UnsupportedImage with one reason; returns it."""
    reasons = []
    for native_passes in (True, False):
        with pytest.raises(UnsupportedImage) as info:
            imgdecode.decode_grid(data, native=native_passes)
        reasons.append(str(info.value))
    assert reasons[0] == reasons[1]
    if reason is not None:
        assert reasons[0] == reason
    return reasons[0]


def _pil_fails(data: bytes) -> bool:
    try:
        with Image.open(io.BytesIO(data)) as im:
            im.convert("L")
    except Exception:
        return True
    return False


def _lzw_strip_file(payload: bytes) -> bytes:
    """A 4 x 4 gray LZW TIFF whose one strip is `payload`."""
    entries, _ = chip_smoke.tiff_image(np.zeros((4, 4), np.int64), 1, 8, compression=5)
    return chip_smoke.tiff_bytes((entries, [payload]))


def _strip_after_ifd(cut: int) -> bytes:
    """An uncompressed RGB TIFF laid out IFD first, its one strip last and
    `cut` bytes short: PIL's raw reader runs off the end of the file."""
    entries, chunks = chip_smoke.tiff_image(_scene(2, 10, 10), 2, 8)
    entries = {k: v for k, v in entries.items() if k != "tiled"}
    entries[279] = (4, [len(chunks[0])])
    entries[273] = (4, [0])
    size = len(chip_smoke._tiff_ifd(entries, 8, "<", False))
    entries[273] = (4, [8 + size])
    return b"II*\x00" + (8).to_bytes(4, "little") + chip_smoke._tiff_ifd(
        entries, 8, "<", False) + chunks[0][:-cut]


def _codes(codes, widths) -> bytes:
    return chip_smoke._pack_msb(np.array(codes), np.array(widths))


REFUSED = {
    # (data, reason, whether PIL refuses it too)
    "ifd_cut": (lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        _scene(1, 20, 20), 2, 8, compression=5))[:-30], tiff.BAD_IFD, True),
    "raw_strip_cut": (lambda: _strip_after_ifd(9), tiff.SHORT_DATA, True),
    "lzw_strip_short": (lambda: _lzw_strip_file(_codes([256, 1, 2, 257], [9, 9, 9, 9])),
                        tiff.SHORT_DATA, True),
    "lzw_code_past_table": (lambda: _lzw_strip_file(_codes([256, 1, 300, 257], [9] * 4)),
                            tiff.CORRUPT_LZW, True),
    "lzw_no_clear_first": (lambda: _lzw_strip_file(_codes([1] * 16 + [257], [9] * 17)),
                           tiff.CORRUPT_LZW, True),
    "deflate_strip_short": (lambda: (lambda e, c: chip_smoke.tiff_bytes((e, [c[0][:-6]])))(
        *chip_smoke.tiff_image(np.random.default_rng(3).integers(0, 256, (12, 12)), 1, 8,
                               compression=8)), tiff.SHORT_DATA, True),
    "predictor_2_at_4_bits": (lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        np.zeros((4, 4), np.int64), 1, 4, compression=5, predictor=2)), tiff.PREDICTOR, True),
    "floating_point_predictor": (lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        _scene(4, 6, 6), 2, 8, compression=8, predictor=3)), tiff.PREDICTOR, True),
    "big_endian_bigtiff": (lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        _scene(5, 6, 6), 2, 8), order=">", bigtiff=True), tiff.BIG_ENDIAN_BIGTIFF, True),
    "white_is_zero_16_big_endian": (lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        np.zeros((4, 4), np.int64), 0, 16, order=">"), order=">"), tiff.MODE, True),
    "palette_without_colormap": (lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        np.zeros((4, 4), np.int64), 3, 8)), tiff.PALETTE, True),
    "planar_associated_alpha_lzw": (lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        np.full((6, 6, 4), 100), 2, 8, compression=5, planar=2, extra=(1,))), tiff.PLANAR,
        False),
    "planar_16_bit_raw": (lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        np.full((6, 6, 3), 1000), 2, 16, planar=2)), tiff.PLANAR, False),
    "planar_configuration_17_lzw": (lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        _scene(6, 6, 6), 2, 8, compression=5, tags={284: (3, [17])})), tiff.PLANAR, True),
    "tile_past_256_mib": (lambda: chip_smoke.tiff_bytes((chip_smoke.tiff_image(
        np.zeros((4, 4, 3), np.int64), 2, 8, tile=(16, 16), tags={
            322: (4, [1 << 16]), 323: (4, [1 << 16])})[0], [b"\x00" * 768])), tiff.LAYOUT,
        True),
    "cmyk": (lambda: _pil_tiff("CMYK", "tiff_lzw"), tiff.MODE, False),
    "ycbcr_deflate": (lambda: _pil_tiff("YCbCr", "tiff_deflate"), tiff.MODE, False),
    "old_style_jpeg": (lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        _scene(6, 6, 6), 2, 8, tags={259: (3, [6])})), tiff.COMPRESSION, True),
    "jpeg_cmyk_photometric": (lambda: _jpeg_tiff(_scene(7, 16, 16), rps=16, photometric=5),
                              tiff.MODE, True),
    "jpeg_sampling_not_the_tag": (lambda: _jpeg_tiff(_scene(8, 16, 16), rps=16,
                                                     sampling=(2, 1), tag_sampling=(2, 2)),
                                  tiff.LAYOUT, True),
    "jpeg_strip_shorter_than_its_rows": (lambda: _jpeg_tiff(_scene(9, 32, 16), rps=16,
                                                            short=True), tiff.LAYOUT, False),
    "ccitt_group3": (lambda: _pil_tiff("1", "group3"), tiff.COMPRESSION, False),
    "ccitt_group4": (lambda: _pil_tiff("1", "group4"), tiff.COMPRESSION, False),
    "float32": (lambda: _pil_tiff("F", "raw"), tiff.MODE, False),
    "int32": (lambda: _pil_tiff("I", "tiff_lzw"), tiff.MODE, False),
}


@pytest.mark.parametrize("mode", ["RGB", "L"])
@pytest.mark.parametrize("quality", [30, 95])
@pytest.mark.parametrize("h,w", [(23, 37), (1, 9), (64, 64), (17, 130)])
def test_pil_jpeg_compressed_tiffs(mode, quality, h, w, tmp_path):
    """PIL's own compression="jpeg" TIFFs (photometric 2 or 1, JPEGTables)."""
    buf = io.BytesIO()
    Image.fromarray(_scene(h + w, h, w)).convert(mode).save(buf, "TIFF", compression="jpeg",
                                                            quality=quality)
    assert_decodes_as_pil(buf.getvalue(), tmp_path)
    for native_passes in (True, False):
        with Image.open(io.BytesIO(buf.getvalue())) as im:
            want = np.asarray(im)
        assert np.array_equal(tiff.decode(buf.getvalue(), native_passes).pixels, want)


JPEG_TIFFS = {
    "ycbcr_420_strips": dict(rps=16),
    "ycbcr_420_one_strip": dict(rps=45),
    "ycbcr_420_tiles": dict(tile=(32, 32)),
    "ycbcr_422_strips": dict(rps=16, sampling=(2, 1)),
    "ycbcr_444_strips": dict(rps=8, sampling=(1, 1)),
    "ycbcr_progressive": dict(rps=8, progressive=True),
    "ycbcr_tiles_progressive_444": dict(tile=(16, 48), sampling=(1, 1), progressive=True),
    "rgb_components_strips": dict(rps=16, photometric=2),
    "rgb_components_tiles": dict(tile=(32, 16), photometric=2),
    "ycbcr_oriented": dict(rps=16, orientation=6),
}


@pytest.mark.parametrize("case", sorted(JPEG_TIFFS))
def test_harness_jpeg_compressed_tiffs(case, tmp_path):
    """YCbCr (libtiff's JPEGCOLORMODE_RGB, as PIL asks), RGB components,
    strips and tiles, every chroma sampling, progressive streams."""
    data = _jpeg_tiff(_scene(45, 45, 70), **JPEG_TIFFS[case])
    assert_decodes_as_pil(data, tmp_path)
    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB")
        from PIL import ImageOps
        want = np.asarray(ImageOps.exif_transpose(im) if "oriented" in case else im)
    for native_passes in (True, False):
        d = tiff.decode(data, native_passes)
        assert d.mode == "RGB" and np.array_equal(d.pixels, want)


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_share_one_reason(case):
    make, code, pil_refuses = REFUSED[case]
    data = make()
    assert_refused(data, tiff.REASONS[code])
    assert _pil_fails(data) == pil_refuses


@pytest.mark.parametrize("route", [tiff.LZW, tiff.PACKBITS, tiff.RAW])
@pytest.mark.parametrize("seed", range(6))
def test_native_chunk_decoder_matches_plain_on_any_bytes(route, seed):
    """Random data, valid or not, as a one-strip image: the same status and
    the same bytes."""
    rng = np.random.default_rng(seed)
    if seed % 2:
        raw = rng.integers(0, 256 >> (seed % 5), 300, dtype=np.uint8).tobytes()
        src = chip_smoke.tiff_lzw(raw) if route == tiff.LZW else \
            chip_smoke.packbits(raw) if route == tiff.PACKBITS else raw
        src = src[:int(rng.integers(len(src) // 2, len(src) + 1))]
    else:
        src = rng.integers(0, 256, int(rng.integers(0, 400)), dtype=np.uint8).tobytes()
        if route == tiff.LZW:
            src = b"\x80" + src
    # (h, w, samples a pixel, depth, predictor, big-endian)
    for h, w, spp, depth, predictor, big in ((10, 10, 3, 8, 1, False), (10, 10, 3, 8, 2, False),
                                             (5, 10, 3, 16, 2, True), (5, 30, 1, 16, 2, False)):
        geometry = (1, 1, 1, w, h, False, w, h, spp, depth, predictor, big)
        got = native.tiff_chunks(src, route, [0], [len(src)], *geometry)
        want = tiff.chunks_plain(src, route, [0], [len(src)], *geometry)
        assert got[0] == want[0]
        if got[0] == tiff.OK:
            assert np.array_equal(got[1], want[1])


def test_harness_writers_round_trip():
    """tiff_lzw and packbits invert as libtiff decodes them (through the
    plain chunk decoder, held to PIL above), and the writer's files look
    like their pixels."""
    rng = np.random.default_rng(0)
    for data in (b"a", rng.integers(0, 4, 20000, dtype=np.uint8).tobytes(),
                 rng.integers(0, 256, 9000, dtype=np.uint8).tobytes(), bytes(range(256)) * 40):
        for route, packed in ((tiff.LZW, chip_smoke.tiff_lzw(data)),
                              (tiff.PACKBITS, chip_smoke.packbits(data))):
            status, out = tiff.chunk_plain(packed, route, 1, len(data), 1, 1, 8, False)
            assert status == tiff.OK and out.tobytes() == data
    px = _scene(1, 30, 40)
    for kind in ("tiff_lzw", "tiff_deflate", "dng"):
        luma = imgdecode.decode_luma(chip_smoke.encode_image(rng, px, kind)[0])
        assert np.abs(luma.astype(int) - imgdecode.l24(px)).max() == 0


@pytest.mark.parametrize("source", ["lzw_strips", "packbits_big_endian", "raw_tiles"])
@pytest.mark.parametrize("seed", range(3))
def test_mutated_files_decode_only_as_pil_does(source, seed):
    """Byte changes and cuts anywhere past the header: both versions give
    one outcome, and where it is an L plane PIL reads the file to the same
    plane (the port may refuse what PIL reads, never the other way)."""
    rng = np.random.default_rng(seed)
    px = _scene(seed, 23, 31)
    data = {"lzw_strips": lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
        px, 2, 8, compression=5, predictor=2, rows_per_strip=7)),
        "packbits_big_endian": lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
            px, 2, 8, compression=32773, rows_per_strip=7), order=">"),
        "raw_tiles": lambda: chip_smoke.tiff_bytes(chip_smoke.tiff_image(
            px, 2, 8, tile=(16, 16)))}[source]()
    for _ in range(25):
        m = bytearray(data)
        if rng.random() < 0.3:
            m = m[:int(rng.integers(8, len(m)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                m[int(rng.integers(8, len(m)))] = int(rng.integers(0, 256))
        m = bytes(m)
        outcomes = []
        for native_passes in (True, False):
            try:
                outcomes.append(imgdecode.decode_luma(m, native=native_passes))
            except UnsupportedImage as e:
                outcomes.append(str(e))
        if isinstance(outcomes[0], str):
            assert outcomes[0] == outcomes[1]
            continue
        assert np.array_equal(outcomes[0], outcomes[1])
        with Image.open(io.BytesIO(m)) as im:
            assert np.array_equal(np.asarray(im.convert("L")), outcomes[0])
