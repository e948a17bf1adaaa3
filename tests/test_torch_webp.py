"""The port's WebP decoder against PIL (libwebp's WebPAnimDecoder), bit for bit.

``spacedrive_tpu_torch/media/webp.py`` (plain) and ``csrc/webpdec.cpp``
(native) must give the L plane of ``PIL.Image.open(p).convert("L")`` — frame
0 on its canvas — and so the JAX package's ``image_to_grid`` grid, on every
WebP they take, or refuse it with the same reason from both versions, where
PIL fails too. Inputs: PIL-saved files (lossless at methods 0, 4 and 6;
lossy at quality 10, 75 and 100 and methods 0, 4 and 6; RGBA with its alpha
as lossy + ALPH or lossless; two-frame animations; sizes down to 1 x 1) and
the harness writers' files (``chip_smoke.webp_lossless_bytes``: subtract
green, predictor, colour cache, backward references, colour indexing with
pixel bundling; ``webp_lossy_bytes``: 16x16 and B_PRED modes, 1-8
partitions, segments, both loop filters at several levels, ALPH raw or
lossless under each filter; ``webp_animation_bytes``: a first frame smaller
than its canvas). Tolerance 0 throughout; the alpha plane PIL reads is held
to the writer's too.
"""

import io

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from spacedrive_tpu.ops import phash as jax_phash
from spacedrive_tpu_torch import native
from spacedrive_tpu_torch.media import imgdecode, webp
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
    path = tmp_path / "img.webp"
    path.write_bytes(data)
    grid = jax_phash.image_to_grid(str(path))
    assert grid is not None
    for native_passes in (True, False):
        got = imgdecode.image_to_grid(str(path), native=native_passes)
        assert got.dtype == np.float32 and np.array_equal(got, grid), f"native={native_passes}"


def _pil_webp(px: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px, mode).save(buf, "WEBP", **kw)
    return buf.getvalue()


SIZES = [(1, 1), (2, 3), (7, 5), (17, 33), (40, 57)]


@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("h,w", SIZES)
def test_pil_lossless(method, h, w, tmp_path):
    data = _pil_webp(_scene(h * w + method, h, w), lossless=True, method=method)
    assert data[12:16] == b"VP8L"
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("quality", [10, 75, 100])
@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("h,w", SIZES)
def test_pil_lossy(quality, method, h, w, tmp_path):
    data = _pil_webp(_scene(h + w + quality, h, w), quality=quality, method=method)
    assert data[12:16] == b"VP8 "
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("quality", [10, 90])
def test_pil_lossy_noise(quality, tmp_path):
    """Every token of the coefficient tree, escape categories included."""
    px = np.random.default_rng(quality).integers(0, 256, (53, 71, 3), dtype=np.uint8)
    assert_decodes_as_pil(_pil_webp(px, quality=quality), tmp_path)


@pytest.mark.parametrize("kw", [dict(quality=80), dict(quality=80, alpha_quality=50),
                                dict(quality=50, method=6, alpha_quality=0),
                                dict(lossless=True), dict(lossless=True, exact=True)],
                         ids=["lossy", "alpha_q50", "alpha_q0_m6", "lossless", "exact"])
@pytest.mark.parametrize("h,w", [(1, 1), (23, 37), (64, 64)])
def test_pil_rgba(kw, h, w, tmp_path):
    rng = np.random.default_rng(h * w)
    rgba = np.dstack([_scene(h, h, w), rng.integers(0, 256, (h, w), dtype=np.uint8)])
    data = _pil_webp(rgba, "RGBA", **kw)
    assert data[12:16] in ((b"VP8L",) if kw.get("lossless") else (b"VP8X", b"VP8 "))
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("kw", [dict(lossless=True), dict(quality=70)], ids=["lossless", "lossy"])
def test_pil_two_frame_animation(kw, tmp_path):
    frames = [Image.fromarray(_scene(k, 40, 50)) for k in range(2)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=100, **kw)
    data = buf.getvalue()
    assert b"ANMF" in data
    assert_decodes_as_pil(data, tmp_path)


LOSSLESS_VARIANTS = {
    "plain": dict(),
    "predictor": dict(predictor_bits=2),
    "predictor_subtract_green_cache": dict(predictor_bits=3, subtract_green=True, cache_bits=4),
    "big_cache": dict(cache_bits=10),
    "no_backrefs": dict(backrefs=False, predictor_bits=5),
}


@pytest.mark.parametrize("variant", sorted(LOSSLESS_VARIANTS))
@pytest.mark.parametrize("h,w", [(1, 1), (9, 13), (40, 57)])
def test_harness_lossless(variant, h, w, tmp_path):
    data = chip_smoke.webp_lossless_bytes(_scene(h * 7 + w, h, w), **LOSSLESS_VARIANTS[variant])
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("colours", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("h,w", [(1, 1), (9, 13), (40, 57)])
def test_harness_colour_indexed(colours, h, w, tmp_path):
    """Colour indexing at every bundling: 8, 4, 2 and 1 pixels a byte."""
    rng = np.random.default_rng(colours * h)
    palette = rng.integers(0, 256, (colours, 3), dtype=np.uint8)
    px = palette[rng.integers(0, colours, (h, w))]
    data = chip_smoke.webp_lossless_bytes(px, palette=True, cache_bits=3 if colours > 2 else 0)
    assert_decodes_as_pil(data, tmp_path)


LOSSY_VARIANTS = {
    "default": dict(quality=80),
    "segments_simple_filter": dict(quality=30, partitions=2, segments=True, filter_kind="simple",
                                   level=30, sharpness=3),
    "b_pred_8_partitions": dict(quality=95, partitions=8, b_pred_share=1.0, level=63,
                                sharpness=7),
    "16x16_only_no_filter_no_skip": dict(quality=60, partitions=4, b_pred_share=0.0,
                                         skip_proba=False, level=0),
    "coarse_segments_normal_filter": dict(quality=5, segments=True, level=45, b_pred_share=0.5),
    "probability_updates": dict(quality=70, prob_updates=200, sharpness=5, level=12),
}


@pytest.mark.parametrize("variant", sorted(LOSSY_VARIANTS))
@pytest.mark.parametrize("h,w", [(1, 1), (9, 13), (40, 57), (70, 33)])
def test_harness_lossy(variant, h, w, tmp_path):
    data = chip_smoke.webp_lossy_bytes(_scene(h + w, h, w), np.random.default_rng(h * w),
                                       **LOSSY_VARIANTS[variant])
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("method", [0, 1])
@pytest.mark.parametrize("filt", [0, 1, 2, 3])
@pytest.mark.parametrize("h,w", [(1, 1), (23, 31)])
def test_harness_alpha(method, filt, h, w, tmp_path):
    rng = np.random.default_rng(method * 4 + filt)
    alpha = rng.integers(0, 256, (h, w))
    data = chip_smoke.webp_lossy_bytes(_scene(filt, h, w), rng, alpha=alpha, alpha_method=method,
                                       alpha_filter=filt)
    assert_decodes_as_pil(data, tmp_path)
    with Image.open(io.BytesIO(data)) as im:
        assert np.array_equal(np.asarray(im)[..., 3], alpha)


@pytest.mark.parametrize("first", ["lossless", "lossy"])
@pytest.mark.parametrize("offset", [(0, 0), (2, 4), (6, 2)])
def test_harness_animation_first_frame_smaller_than_its_canvas(first, offset, tmp_path):
    """Frame 0 at its offset, the rest of the canvas transparent black (L
    0); the second frame, the whole canvas, is not read."""
    rng = np.random.default_rng(offset[0])
    canvas = _scene(3, 30, 40)
    y0, x0 = offset
    part = canvas[y0:y0 + 17, x0:x0 + 23]
    chunk = chip_smoke.riff_chunk(b"VP8L", chip_smoke.webp_lossless_stream(
        chip_smoke.rgb_to_argb(part), predictor_bits=2)) if first == "lossless" else \
        chip_smoke.riff_chunk(b"VP8 ", chip_smoke.vp8_frame(part, rng))
    second = chip_smoke.riff_chunk(b"VP8 ", chip_smoke.vp8_frame(canvas, rng))
    data = chip_smoke.webp_animation_bytes([(chunk, x0, y0, 23, 17), (second, 0, 0, 40, 30)],
                                           (40, 30))
    assert_decodes_as_pil(data, tmp_path)
    luma = imgdecode.decode_luma(data)
    assert luma[:y0].max(initial=0) == 0 and luma[y0 + 17:].max(initial=0) == 0


@pytest.mark.parametrize("kind", ["webp_lossless", "webp_palette", "webp_lossy",
                                  "webp_extended"])
@pytest.mark.parametrize("seed", range(4))
def test_corpus_kinds(kind, seed, tmp_path):
    """chip_smoke's corpus writer: what the near-dup location on the card
    holds (the extended kind alternates ALPH and animation)."""
    rng = np.random.default_rng(seed)
    data, ext = chip_smoke.encode_image(rng, _scene(seed, 30 + 3 * seed, 41), kind)
    assert ext == "webp"
    assert_decodes_as_pil(data, tmp_path)


def test_lossy_writer_is_faithful():
    """The VP8 writer's file looks like its picture (a writer bug would
    still decode alike on both sides)."""
    px = _scene(1, 48, 64)
    luma = imgdecode.decode_luma(chip_smoke.webp_lossy_bytes(px, np.random.default_rng(1),
                                                             quality=90))
    assert np.abs(luma.astype(int) - imgdecode.l24(px)).mean() < 3


def assert_refused(data: bytes, code) -> None:
    """Both versions raise UnsupportedImage with one reason (REASONS[code]
    where `code` is given), and PIL fails on the file too."""
    reasons = []
    for native_passes in (True, False):
        with pytest.raises(UnsupportedImage) as info:
            imgdecode.decode_grid(data, native=native_passes)
        reasons.append(str(info.value))
    assert reasons[0] == reasons[1]
    if code is not None:
        assert reasons[0] == webp.REASONS[code]
    with pytest.raises(Exception):
        with Image.open(io.BytesIO(data)) as im:
            im.convert("L")


def _lossy(seed: int = 0, **kw) -> bytes:
    return chip_smoke.webp_lossy_bytes(_scene(seed, 24, 32), np.random.default_rng(seed), **kw)


def _lossless(**kw) -> bytes:
    return chip_smoke.webp_lossless_bytes(_scene(2, 24, 32), **kw)


def _set(data: bytes, at: int, value: bytes) -> bytes:
    return data[:at] + value + data[at + len(value):]


def _vp8_frame(seed: int = 0) -> bytes:
    return chip_smoke.vp8_frame(_scene(seed, 24, 32), np.random.default_rng(seed))


def _code_without_a_symbol() -> bytes:
    """A 1 x 1 VP8L image whose distance code is a simple code of symbol
    255, past the 40-symbol alphabet: a code with no symbol."""
    bw = chip_smoke._LosslessBits()
    for value, width in ((0x2F, 8), (0, 14), (0, 14), (0, 1), (0, 3), (0, 1), (0, 1), (0, 1)):
        bw.put(value, width)
    for _ in range(4):  # green, red, blue, alpha: symbol 0 alone
        for value, width in ((1, 1), (0, 1), (0, 1), (0, 1)):
            bw.put(value, width)
    for value, width in ((1, 1), (0, 1), (1, 1), (255, 8)):
        bw.put(value, width)
    return chip_smoke.riff_webp(chip_smoke.riff_chunk(b"VP8L", bw.tobytes() + b"\x00" * 8))


def _lossless_header_then(*fields) -> bytes:
    """A 1 x 1 VP8L file: the header, then `fields` (value, width) and zeros."""
    bw = chip_smoke._LosslessBits()
    for value, width in ((0x2F, 8), (0, 14), (0, 14), (0, 1), (0, 3)) + fields:
        bw.put(value, width)
    return chip_smoke.riff_webp(chip_smoke.riff_chunk(b"VP8L", bw.tobytes() + b"\x00" * 8))


def _vp8_first_partition_past_data() -> bytes:
    """A key frame whose first partition claims more bytes than follow its
    header (but fewer than the chunk, which WebPGetFeatures checks)."""
    frame = bytearray(_vp8_frame(6))
    claim = len(frame) - 9
    tag = (frame[0] | frame[1] << 8 | frame[2] << 16) & 0x1F | claim << 5
    frame[0:3] = tag.to_bytes(3, "little")
    return chip_smoke.riff_webp(chip_smoke.riff_chunk(b"VP8 ", bytes(frame)))


REFUSED = {
    "truncated_file": (lambda: _lossy()[:-10], webp.TRUNCATED),
    "riff_size_below_eight": (lambda: _set(_lossy(), 4, b"\x04\x00\x00\x00"),
                              webp.BAD_CONTAINER),
    "chunk_size_past_riff": (lambda: _set(_lossy(), 16, b"\xff\xff\x00\x00"),
                             webp.BAD_CONTAINER),
    "vp8_data_cut": (lambda: chip_smoke.webp_vp8_cut(np.random.default_rng(3),
                                                     _scene(3, 40, 60)), webp.LOSSY_END),
    "vp8_not_a_key_frame": (lambda: _set(_lossy(), 20, bytes([_lossy()[20] | 1])),
                            webp.BAD_FRAME),
    "vp8_bad_start_code": (lambda: _set(_lossy(), 23, b"\x00"), webp.BAD_FRAME),
    "vp8_partition_count_past_data": (
        lambda: chip_smoke.riff_webp(chip_smoke.riff_chunk(b"VP8 ", (lambda f: f[:10 + (
            (f[0] | f[1] << 8 | f[2] << 16) >> 5)])(_vp8_frame(4)))), webp.LOSSY_PARTITIONS),
    "vp8l_version_bits": (lambda: _set(_lossless(), 24, bytes([_lossless()[24] | 0x20])),
                          webp.BAD_FRAME),
    # a cut stream fails where its zeros first break it: the reason varies
    "vp8l_stream_cut": (lambda: chip_smoke.riff_webp(chip_smoke.riff_chunk(
        b"VP8L", chip_smoke.webp_lossless_stream(chip_smoke.rgb_to_argb(_scene(5, 24, 32)))[
            :40])), None),
    "vp8l_code_without_a_symbol": (_code_without_a_symbol, webp.LOSSLESS_CODE),
    "vp8l_one_transform_twice": (lambda: _lossless_header_then((1, 1), (2, 2), (1, 1), (2, 2)),
                                 webp.LOSSLESS_TRANSFORM),
    "vp8l_colour_cache_of_12_bits": (lambda: _lossless_header_then((0, 1), (1, 1), (12, 4)),
                                     webp.LOSSLESS_HEADER),
    "vp8_first_partition_past_data": (_vp8_first_partition_past_data, webp.LOSSY_HEADER),
    "alph_reserved_bits": (lambda: _set(_lossy(alpha=np.zeros((24, 32), np.int64)), 38,
                                        b"\xc0"), webp.ALPHA_HEADER),
    "alph_raw_too_short": (lambda: chip_smoke.riff_webp(
        chip_smoke.vp8x_chunk(32, 24, alpha=True) + chip_smoke.riff_chunk(b"ALPH", b"\x00" * 9)
        + chip_smoke.riff_chunk(b"VP8 ", _vp8_frame())), webp.ALPHA_HEADER),
    "alph_lossless_cut": (lambda: chip_smoke.riff_webp(
        chip_smoke.vp8x_chunk(32, 24, alpha=True) + chip_smoke.riff_chunk(
            b"ALPH", b"\x01" + chip_smoke.webp_lossless_stream(
                np.random.default_rng(0).integers(0, 256, (24, 32)).astype(np.uint32) << 8,
                header=False)[:30]) + chip_smoke.riff_chunk(b"VP8 ", _vp8_frame())), None),
    "vp8x_canvas_not_the_frame": (lambda: chip_smoke.riff_webp(
        chip_smoke.vp8x_chunk(33, 24) + chip_smoke.riff_chunk(b"VP8 ", _vp8_frame())),
        webp.BAD_FRAME),
    "vp8x_reserved_flag": (lambda: _set(chip_smoke.riff_webp(
        chip_smoke.vp8x_chunk(32, 24) + chip_smoke.riff_chunk(b"VP8 ", _vp8_frame())), 20,
        b"\x01"), webp.BAD_CONTAINER),
    "vp8x_without_an_image": (lambda: chip_smoke.riff_webp(chip_smoke.vp8x_chunk(32, 24)),
                              webp.BAD_CONTAINER),
    "frame_past_the_canvas": (lambda: chip_smoke.webp_animation_bytes(
        [(chip_smoke.riff_chunk(b"VP8 ", _vp8_frame()), 4, 0, 32, 24)], (32, 24)),
        webp.BAD_FRAME),
    "anmf_before_anim": (lambda: chip_smoke.riff_webp(
        chip_smoke.vp8x_chunk(32, 24, animation=True) + chip_smoke.riff_chunk(
            b"ANMF", bytes(15) + b"\x00" + chip_smoke.riff_chunk(b"VP8 ", _vp8_frame()))),
        webp.BAD_CONTAINER),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refusals_share_one_reason_where_pil_fails(case):
    make, code = REFUSED[case]
    assert_refused(make(), code)


def test_avif_is_refused_with_its_reason():
    buf = io.BytesIO()
    Image.fromarray(_scene(1, 8, 8)).save(buf, "AVIF")
    for native_passes in (True, False):
        with pytest.raises(UnsupportedImage, match="AVIF"):
            imgdecode.decode_grid(buf.getvalue(), native=native_passes)


@pytest.mark.parametrize("source", ["pil_lossless", "pil_lossy", "harness_alpha"])
@pytest.mark.parametrize("seed", range(3))
def test_mutated_files_agree_with_pil(source, seed):
    """Byte changes and cuts anywhere past the RIFF header: the port decodes
    exactly what PIL decodes, to the same L plane, and refuses the rest,
    both versions alike."""
    rng = np.random.default_rng(seed)
    px = _scene(seed, 29, 37)
    data = {"pil_lossless": lambda: _pil_webp(px, lossless=True),
            "pil_lossy": lambda: _pil_webp(px, quality=60),
            "harness_alpha": lambda: chip_smoke.webp_lossy_bytes(
                px, rng, alpha=rng.integers(0, 256, (29, 37)), alpha_filter=3)}[source]()
    for _ in range(25):
        m = bytearray(data)
        if rng.random() < 0.3:
            m = m[:int(rng.integers(12, len(m)))]
        else:
            for _ in range(int(rng.integers(1, 4))):
                m[int(rng.integers(12, len(m)))] = int(rng.integers(0, 256))
        m = bytes(m)
        try:
            with Image.open(io.BytesIO(m)) as im:
                want = np.asarray(im.convert("L"))
        except Exception:
            want = None
        outcomes = []
        for native_passes in (True, False):
            try:
                outcomes.append(imgdecode.decode_luma(m, native=native_passes))
            except UnsupportedImage as e:
                outcomes.append(str(e))
        if want is None:
            assert isinstance(outcomes[0], str) and outcomes[0] == outcomes[1]
        else:
            for got in outcomes:
                assert not isinstance(got, str) and np.array_equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_native_bitstream_decoders_match_plain_on_any_bytes(seed):
    """Random payloads behind a valid header: the same status and pixels."""
    rng = np.random.default_rng(seed)
    noise = rng.integers(0, 256, 300, dtype=np.uint8).tobytes()
    lossless = bytes([0x2F]) + (15 | 11 << 14).to_bytes(4, "little") + noise
    frame = bytearray(_vp8_frame(seed))
    frame[12:] = noise[:len(frame) - 12]
    for fn, plain, payload in ((native.webp_lossless, webp.lossless_plain, lossless),
                               (native.webp_lossy, webp.lossy_plain, bytes(frame))):
        w, h = (16, 12) if fn is native.webp_lossless else (32, 24)
        got, want = fn(payload, w, h), plain(payload, w, h)
        assert got[0] == want[0]
        if got[0] == webp.OK:
            assert np.array_equal(got[1], want[1])
    alpha = b"\x01" + noise
    assert native.webp_alpha(alpha, 10, 10) == webp.alpha_plain(alpha, 10, 10)
