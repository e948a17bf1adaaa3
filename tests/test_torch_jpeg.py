"""The port's JPEG decoder against PIL (libjpeg-turbo), bit for bit.

``spacedrive_tpu_torch/media/jpeg.py`` (plain) and ``csrc/jpegdec.cpp``
(native) must give the samples PIL's libjpeg-turbo gives, and so the JAX
package's ``image_to_grid`` grid, on every JPEG they take: baseline and
progressive (PIL's progression uses successive approximation, AC
refinement included), 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1, gray, restart
intervals, Adobe RGB, CMYK and YCCK (four components, as PIL reads them:
Adobe-inverted), odd sizes and chroma one or two samples wide, junk
before EOI. Inputs are PIL-written JPEGs of seeded numpy pixels, and the
harness writer's files (``chip_smoke.jpeg_bytes``: what the near-dup
corpus on the card holds), which PIL must read to the same grid.
Tolerance 0 throughout. Refusals are in ``tests/test_torch_imgdecode.py``.
"""

import io

import numpy as np
import pytest
from PIL import Image

import chip_smoke
from spacedrive_tpu.ops import phash as jax_phash
from spacedrive_tpu_torch import native
from spacedrive_tpu_torch.media import imgdecode, jpeg


def _pixels(seed: int, h: int, w: int, smooth: bool) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if smooth:
        return np.clip(chip_smoke.image_scene(rng, h, w), 0, 255).astype(np.uint8)
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _pil_jpeg(px: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def assert_decodes_as_pil(data: bytes, tmp_path) -> None:
    """Native and plain samples equal PIL's; both grids equal the JAX
    package's image_to_grid on the same file."""
    with Image.open(io.BytesIO(data)) as im:
        samples = np.asarray(im)
    assert np.array_equal(native.jpeg_decode(data), samples)
    assert np.array_equal(jpeg.decode_plain(data), samples)
    path = tmp_path / "img.jpg"
    path.write_bytes(data)
    want = jax_phash.image_to_grid(str(path))
    assert want is not None
    for native_passes in (True, False):
        got = imgdecode.image_to_grid(str(path), native=native_passes)
        assert got.dtype == np.float32 and np.array_equal(got, want), f"native={native_passes}"


SIZES = [(37, 53), (1, 1), (2, 2), (17, 2), (1, 30), (16, 16), (64, 96), (100, 129)]


@pytest.mark.parametrize("subsampling", [0, 1, 2, "gray"])
@pytest.mark.parametrize("quality", [10, 75, 100])
@pytest.mark.parametrize("h,w", SIZES)
def test_pil_baseline_jpegs(subsampling, quality, h, w, tmp_path):
    px = _pixels(h * w + quality, h, w, smooth=quality != 100)
    if subsampling == "gray":
        data = _pil_jpeg(px, "L", quality=quality)
    else:
        data = _pil_jpeg(px, quality=quality, subsampling=subsampling)
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("subsampling", [0, 1, 2, "gray"])
@pytest.mark.parametrize("quality", [10, 75, 100])
@pytest.mark.parametrize("h,w", [(37, 53), (2, 2), (17, 2), (64, 96)])
def test_pil_progressive_jpegs(subsampling, quality, h, w, tmp_path):
    px = _pixels(h + w + quality, h, w, smooth=quality == 75)
    if subsampling == "gray":
        data = _pil_jpeg(px, "L", quality=quality, progressive=True)
    else:
        data = _pil_jpeg(px, quality=quality, progressive=True, subsampling=subsampling)
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("kw", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 3},
                                {"restart_marker_rows": 1},
                                {"restart_marker_blocks": 2, "progressive": True},
                                {"optimize": True}])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_pil_restart_intervals_and_optimised_tables(kw, subsampling, tmp_path):
    px = _pixels(len(kw) + subsampling, 45, 70, smooth=True)
    data = _pil_jpeg(px, quality=80, subsampling=subsampling, **kw)
    if "restart_marker_blocks" in kw or "restart_marker_rows" in kw:
        assert b"\xff\xdd" in data and b"\xff\xd0" in data
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("sampling", [(1, 1), (2, 1), (2, 2), (1, 2), (4, 1), "gray",
                                      "adobe_rgb"])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("restart", [0, 1, 5])
@pytest.mark.parametrize("h,w", [(23, 41), (2, 9), (9, 2)])
def test_harness_writer_jpegs(sampling, progressive, restart, h, w, tmp_path):
    """chip_smoke.jpeg_bytes: every chroma sampling the corpus uses and
    4:4:0 and 4:1:1 (replication at four to one), gray, Adobe RGB
    (APP14 transform 0: no colour conversion), DC successive approximation
    and spectral selection, restart intervals; PIL reads each to the grid
    the port reads."""
    px = _pixels(h * 31 + w + restart, h, w, smooth=True)
    if sampling == "gray":
        data = chip_smoke.jpeg_bytes(px[..., 1], 85, progressive=progressive, restart=restart)
    elif sampling == "adobe_rgb":
        data = chip_smoke.jpeg_bytes(px, 85, progressive=progressive, restart=restart,
                                     adobe_rgb=True)
    else:
        data = chip_smoke.jpeg_bytes(px, 85, sampling, progressive=progressive, restart=restart)
    assert_decodes_as_pil(data, tmp_path)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("h,w", [(37, 53), (2, 2), (17, 2), (64, 96)])
def test_pil_cmyk_jpegs(subsampling, progressive, h, w, tmp_path):
    """PIL's CMYK JPEGs (Adobe APP14, transform 0): PIL reads them as
    ``CMYK;I``, every sample inverted, and so do the port's decoders; the
    grid goes through ``cmyk2rgb``."""
    px = np.concatenate([_pixels(h + w, h, w, smooth=True),
                         _pixels(h * w, h, w, smooth=False)[..., :1]], axis=2)
    data = _pil_jpeg(px, "CMYK", quality=80, subsampling=subsampling, progressive=progressive)
    assert_decodes_as_pil(data, tmp_path)


def _ycck_jpeg(seed: int, h: int, w: int, sampling, progressive: bool, restart: int) -> bytes:
    """Four components of random quantised coefficients under an Adobe
    APP14 with transform 2 (YCCK), from the harness writer."""
    rng = np.random.default_rng(seed)
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    blocks = []
    for sh, sv in sampling:
        b = rng.integers(-12, 13, (mcuy * sv, mcux * sh, 64))
        b[..., 0] = rng.integers(-40, 41, b.shape[:2])
        b[..., 16:] = 0
        blocks.append(b)
    data = chip_smoke.jpeg_from_coefficients(blocks, w, h, list(sampling),
                                             [np.full(64, 3)] * 4, progressive=progressive,
                                             restart=restart, ids=[1, 2, 3, 4])
    at = data.index(b"\xff\xe0")
    app0 = int.from_bytes(data[at + 2:at + 4], "big")
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x02"
    return data[:at] + adobe + data[at + 2 + app0:]


@pytest.mark.parametrize("sampling", [((1, 1),) * 4, ((2, 2), (1, 1), (1, 1), (2, 2)),
                                      ((2, 1), (1, 1), (1, 1), (2, 1))],
                         ids=["444", "420", "422"])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("h,w", [(24, 40), (9, 2), (33, 17)])
def test_ycck_jpegs(sampling, progressive, h, w, tmp_path):
    """YCCK (Adobe transform 2): libjpeg turns it into CMYK (255 minus the
    YCbCr-to-RGB of the first three, K as it is), PIL inverts that."""
    data = _ycck_jpeg(h * w, h, w, sampling, progressive, restart=2 if progressive else 0)
    assert_decodes_as_pil(data, tmp_path)


def test_harness_writer_is_faithful():
    """The harness writer's files look like their pixels (a writer bug would
    still decode alike on both sides)."""
    px = _pixels(3, 61, 75, smooth=True)
    for kw in ({"sampling": (1, 1)}, {"adobe_rgb": True}, {"progressive": True}):
        with Image.open(io.BytesIO(chip_smoke.jpeg_bytes(px, 95, **kw))) as im:
            err = np.abs(np.asarray(im).astype(int) - px).mean()
        assert err < 6, (kw, err)


def test_junk_before_markers_and_eoi(tmp_path):
    """libjpeg skips bytes that are not a marker (with a warning); so do
    the port's decoders."""
    data = _pil_jpeg(_pixels(1, 30, 40, smooth=True), quality=70)
    junk = data[:-2] + b"\x00\x13\x37junk" + b"\xff\xd9"
    assert_decodes_as_pil(junk, tmp_path)
    at = data.index(b"\xff\xdb")
    assert_decodes_as_pil(data[:at] + b"\x01\x02" + data[at:], tmp_path)


def _idct_unclamped(block: np.ndarray, q: int) -> tuple:
    """(max |pass-1 workspace|, pass-2 outputs before the range limit) of
    one zigzag block at a flat quantiser."""
    deq = np.zeros(64, np.int64)
    deq[jpeg.NATURAL] = block * q
    x = deq.reshape(1, 8, 8)
    ws = np.stack([jpeg._descale(o, 11) for o in jpeg._idct_1d(
        [x[:, k, :] for k in range(8)])], axis=1)
    out = np.stack([jpeg._descale(o, 18) for o in jpeg._idct_1d(
        [ws[:, :, k] for k in range(8)])], axis=2)
    return int(np.abs(ws).max()), out


def test_extreme_blocks_saturate_as_pil_does(tmp_path):
    """IDCT outputs past 0..255 clamp, as libjpeg-turbo's SIMD IDCT in PIL
    does, where its C code's range_limit would mask (an output in
    [512, 895] would come out 0, one in [-640, -513] 255): random blocks
    scaled until the pass-1 workspace nears the 16-bit limit."""
    rng = np.random.default_rng(4)
    masked_differs = 0
    for _ in range(30):
        block = np.zeros(64, np.int64)
        at = rng.choice(64, int(rng.integers(1, 64)), replace=False)
        block[at] = rng.integers(-1023, 1024, len(at))
        block = np.round(block * 14000 / _idct_unclamped(block, 1)[0]).astype(np.int64)
        q = -(-int(np.abs(block).max()) // 1023)  # keep within Annex K's categories
        block //= q
        peak, out = _idct_unclamped(block, q)
        assert peak <= jpeg.IDCT_INPUT_MAX
        masked_differs += int(((out >= 512) | (out <= -513)).any())
        data = chip_smoke.jpeg_from_coefficients([block.reshape(1, 1, 64)], 8, 8, [(1, 1)],
                                                 [np.full(64, q)])
        assert_decodes_as_pil(data, tmp_path)
    assert masked_differs > 10


def test_format_is_read_from_the_bytes(tmp_path):
    """A .png holding JPEG bytes decodes as JPEG, and a .jpg holding PNG
    bytes as PNG, in both packages."""
    px = _pixels(5, 20, 30, smooth=True)
    for name, data in (("a.png", _pil_jpeg(px)),
                       ("b.jpg", chip_smoke.png_bytes(px.reshape(20, -1), 30, 2, 8,
                                                      np.zeros(20, np.int64)))):
        (tmp_path / name).write_bytes(data)
        want = jax_phash.image_to_grid(str(tmp_path / name))
        assert np.array_equal(imgdecode.image_to_grid(str(tmp_path / name)), want)


def test_refusals_carry_the_same_reason_in_both_versions():
    data = chip_smoke.jpeg_bytes(_pixels(2, 20, 20, smooth=True))
    cases = {data[:-2]: jpeg.NO_EOI,
             data.replace(b"\xff\xc0", b"\xff\xc9", 1): jpeg.ARITHMETIC,
             data.replace(b"\xff\xc0", b"\xff\xc3", 1): jpeg.LOSSLESS,
             data[:-40] + b"\xff\xd9": jpeg.CORRUPT_DATA}
    for bad, code in cases.items():
        reasons = []
        for decode in (native.jpeg_decode, jpeg.decode_plain):
            with pytest.raises(imgdecode.UnsupportedImage) as err:
                decode(bad)
            reasons.append(str(err.value))
        assert reasons == [jpeg.REASONS[code]] * 2
