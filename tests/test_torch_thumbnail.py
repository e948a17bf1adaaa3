"""The port's thumbnail passes against the JAX package's ``encode_webp``.

For every decoded mode (RGB, RGBA, L, LA, P with and without tRNS, 1, I;16,
16-bit colour, an ICO's RGBA, WebP with alpha, GIF) and the sizes 1 × 4000,
4000 × 1, 7 × 5 (no upscale) and 2000 × 1500: the grid the port hands its
encoder equals the image PIL's ``save`` receives inside the JAX
``encode_webp`` (captured by wrapping ``PIL.Image.Image.save`` here), the
native passes equal their plain versions, the encoder's native bytes equal
its plain bytes, PIL reads the port's WebP and its pixels equal the port
decoder's. The encoder is held against libwebp's own quality-30 encode of
the same grids: PSNR at least libwebp's less 2 dB (or 40 dB), and the mean
size at most twice libwebp's.

Run with ``-s`` to print the quality table PERF.md records.
"""

from __future__ import annotations

import io
import os

import numpy as np
import pytest
from PIL import Image

from spacedrive_tpu.media import thumbnail as jax_thumb
from spacedrive_tpu_torch import native
from spacedrive_tpu_torch.media import imgdecode, images, thumbnail, webpenc


def _scene(h, w, c, seed=0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 100 * np.sin(x / 9.0 + y / 23.0), 128 + 90 * np.cos(y / 13.0 + x / 31.0),
                     (x * 3 + y * 2) % 256, np.clip((x * 255) // max(w - 1, 1), 0, 255)], -1)
    return (base[..., :c] + rng.normal(0, 5, (h, w, c))).clip(0, 255).astype(np.uint8)


def _png16(values: np.ndarray, mode: str) -> bytes:
    """A 16-bit PNG PIL itself does not write: RGB, RGBA or LA at 16 bits."""
    import struct
    import zlib
    h, w, c = values.shape
    ctype = {3: 2, 4: 6, 2: 4}[c]
    rows = b"".join(b"\x00" + values[y].astype(">u2").tobytes() for y in range(h))

    def chunk(kind, payload):
        return struct.pack(">I", len(payload)) + kind + payload + struct.pack(
            ">I", zlib.crc32(kind + payload))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _save(arr, mode, fmt, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, fmt, **kw)
    return buf.getvalue()


def _cases():
    s3, s4 = _scene(37, 53, 3, 1), _scene(37, 53, 4, 2)
    p = Image.fromarray(s3).convert("P", palette=Image.ADAPTIVE, colors=12)
    trns = io.BytesIO()
    p.save(trns, "PNG", transparency=3)
    plain_p = io.BytesIO()
    p.save(plain_p, "PNG")
    return {
        "rgb_png": lambda: _save(s3, "RGB", "PNG"),
        "rgba_png": lambda: _save(s4, "RGBA", "PNG"),
        "l_png": lambda: _save(s3[..., 0], "L", "PNG"),
        "la_png": lambda: _save(s4[..., :2], "LA", "PNG"),
        "p_png": lambda: plain_p.getvalue(),
        "p_trns_png": lambda: trns.getvalue(),
        "1_png": lambda: _save(s3[..., 0] > 128, "1", "PNG"),
        "i16_png": lambda: _save(s3[..., 0].astype(np.uint16) * 3, "I;16", "PNG"),
        "rgb16_png": lambda: _png16(s3.astype(np.uint16) * 257 + 7, "RGB"),
        "rgba16_png": lambda: _png16(s4.astype(np.uint16) * 257, "RGBA"),
        "la16_png": lambda: _png16(s4[..., :2].astype(np.uint16) * 257, "LA"),
        "rgba_ico": lambda: _save(s4[:32, :32], "RGBA", "ICO", sizes=[(32, 32)]),
        "rgba_webp": lambda: _save(s4, "RGBA", "WEBP", quality=60),
        "gif": lambda: _save(s3, "RGB", "GIF"),
        "rgba_tiff": lambda: _save(s4, "RGBA", "TIFF"),
        "jpeg": lambda: _save(s3, "RGB", "JPEG"),
        # CMYK (Adobe-inverted) and a JPEG-compressed TIFF: refused until
        # the decoder took four components and TIFF's compression 7
        "cmyk_jpeg": lambda: _save(np.concatenate([s3, s3[..., :1]], -1), "CMYK", "JPEG"),
        "cmyk_progressive_jpeg": lambda: _save(s4, "CMYK", "JPEG", progressive=True,
                                               subsampling=2),
        "jpeg_tiff": lambda: _save(s3, "RGB", "TIFF", compression="jpeg"),
        "1x4000": lambda: _save(_scene(4000, 1, 3, 3), "RGB", "PNG"),
        "4000x1": lambda: _save(_scene(1, 4000, 3, 4), "RGB", "PNG"),
        "7x5": lambda: _save(_scene(5, 7, 3, 5), "RGB", "PNG"),
        "2000x1500": lambda: _save(_scene(1500, 2000, 3, 6), "RGB", "JPEG", quality=90),
    }


CASES = _cases()
EXT = {"png": "png", "ico": "ico", "webp": "webp", "gif": "gif", "tiff": "tiff", "jpeg": "jpg"}


def _ext(name: str) -> str:
    for k, v in EXT.items():
        if name.endswith(k):
            return v
    return "png" if name != "2000x1500" else "jpg"


def _jax_grid(path: str, out: str, monkeypatch) -> np.ndarray:
    """The image PIL's save receives inside the JAX encode_webp."""
    seen = []
    real = Image.Image.save

    def spy(self, fp, format=None, **kw):
        if format == "WEBP":
            seen.append(np.asarray(self.convert("RGB")).copy())
        return real(self, fp, format, **kw)

    monkeypatch.setattr(Image.Image, "save", spy)
    assert jax_thumb.generate_thumbnail(path, os.path.dirname(out), "ab" * 8)
    monkeypatch.setattr(Image.Image, "save", real)
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_the_grid_and_the_file_match(tmp_path, case, monkeypatch):
    path = str(tmp_path / f"in.{_ext(case)}")
    with open(path, "wb") as f:
        f.write(CASES[case]())
    want = _jax_grid(path, str(tmp_path / "jax" / "x"), monkeypatch)
    pixels, mode = images.format_image(path)
    plain_px, plain_mode = images.format_image(path, native=False)
    assert mode == plain_mode and np.array_equal(pixels, plain_px)
    grid = thumbnail.thumbnail_rgb(pixels, mode)
    assert np.array_equal(grid, want)
    assert np.array_equal(thumbnail.thumbnail_rgb(pixels, mode, native=False), want)
    data = webpenc.encode(grid)
    assert data == webpenc.encode(grid, native=False)
    with Image.open(io.BytesIO(data)) as im:
        assert im.format == "WEBP" and im.size == (want.shape[1], want.shape[0])
        assert np.array_equal(np.asarray(im.convert("RGB")), imgdecode.decode_image(data)[0])
    # The port's own path writes the same file at the JAX path's size.
    out = thumbnail.generate_thumbnail(path, str(tmp_path / "port"), "ab" * 8)
    with open(out, "rb") as f:
        assert f.read() == data


def test_native_passes_equal_plain_on_odd_shapes():
    rng = np.random.default_rng(7)
    for (h, w, c), size in (((3, 2000, 3), (400, 1)), ((999, 2, 1), (1, 31)),
                            ((64, 48, 3), (48, 64)), ((17, 17, 3), (16, 17))):
        px = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        if c == 1:
            px = px[..., 0]
        assert np.array_equal(native.resample_image(px, size), imgdecode.resize_image(px, size))
        want = np.asarray(Image.fromarray(px).resize(size, Image.LANCZOS))
        assert np.array_equal(imgdecode.resize_image(px, size), want)
    for mode, shape, dtype in (("L", (5, 9), np.uint8), ("LA", (5, 9, 2), np.uint8),
                               ("I;16", (5, 9), np.uint16), ("RGB", (5, 9, 3), np.uint8),
                               ("RGBA", (5, 9, 4), np.uint8), ("CMYK", (5, 9, 4), np.uint8)):
        px = rng.integers(0, 1000 if dtype == np.uint16 else 256, shape).astype(dtype)
        assert np.array_equal(imgdecode.thumb_rgb(px, mode),
                              imgdecode.thumb_rgb(px, mode, native=False))


# The floor chip_smoke.py's phase 12 holds each thumbnail to (MEDIA_PSNR_FLOOR).
PSNR_FLOOR = 20.0


def _psnr(a, b) -> float:
    mse = float(((a.astype(np.float64) - b) ** 2).mean())
    return 99.0 if mse == 0 else 10 * np.log10(255 ** 2 / mse)


def test_encoder_quality_against_libwebp():
    rows = []
    for seed, (h, w) in enumerate(((443, 591), (512, 512), (300, 800), (64, 64), (33, 47))):
        grid = _scene(h, w, 3, 10 + seed)
        if seed % 2:  # a flatter picture, and one with sharp edges
            grid = (grid // 32) * 32
        ours = webpenc.encode(grid)
        buf = io.BytesIO()
        Image.fromarray(grid).save(buf, "WEBP", quality=30)
        theirs = buf.getvalue()
        decoded = [np.asarray(Image.open(io.BytesIO(d)).convert("RGB")) for d in (ours, theirs)]
        p_ours, p_theirs = _psnr(decoded[0], grid), _psnr(decoded[1], grid)
        rows.append((h, w, p_ours, p_theirs, len(ours), len(theirs)))
        assert p_ours >= p_theirs - 2.0 or p_ours >= 40.0, rows[-1]
        assert p_ours >= PSNR_FLOOR and ours != theirs  # libwebp's bytes: not the aim
    mean_ratio = np.mean([r[4] for r in rows]) / np.mean([r[5] for r in rows])
    print("\nencoder vs libwebp q30: h w psnr_port psnr_libwebp bytes_port bytes_libwebp")
    for r in rows:
        print("  %d %d %.3f %.3f %d %d" % r)
    print(f"  mean size ratio {mean_ratio:.4f}")
    assert mean_ratio <= 2.0

