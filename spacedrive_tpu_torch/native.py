"""ctypes bindings to the port's native host code: the staging plane
(csrc/sdio_stage.cpp) and the image decoders (csrc/imgdec.cpp: the PNG
unfilter, L24, LANCZOS and the GIF LZW; csrc/jpegdec.cpp: JPEG).

Port of the staging half of ``spacedrive_tpu/native/__init__.py``: batched
file reads into dense rows by a pool of C++ threads over pread/mmap, with
the interpreter lock released for the whole call. ``ops/_build.py`` builds
the library with ``g++`` at first use; if it cannot, the call raises. There
is no ``available()`` gate: no caller is rerouted to another plane.

Every entry point takes ``n_threads``, the C plane's worker threads for
this call (callers that stage several batches at once split the host's
cores between them).
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import numpy as np

from .ops import _build, cas

# Status codes: must match `enum Status` in csrc/sdio_stage.cpp.
OK = 0
ERR_OPEN = -1
ERR_SHORT_READ = -2
ERR_GREW = -3
ERR_EMPTY = -4
ERR_IO = -5

STATUS_MESSAGES = {
    ERR_OPEN: "cannot open file",
    ERR_SHORT_READ: "short read",
    ERR_GREW: "file grew past its declared size class",
    ERR_EMPTY: "empty file",
    ERR_IO: "I/O error",
}

# The constants baked into csrc/sdio_stage.cpp.
LARGE_PAYLOAD = cas.LARGE_PAYLOAD_SIZE  # 57344
SMALL_CAP = cas.MINIMUM_FILE_SIZE  # 102400


def _lib() -> ctypes.CDLL:
    return _build.library("sdio_stage")


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _paths_array(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def _threads(n_threads: int) -> int:
    if int(n_threads) < 1:
        raise ValueError(f"n_threads must be >= 1, got {n_threads}")
    return int(n_threads)


def stage_large(paths: Sequence[str], sizes: np.ndarray, *,
                n_threads: int) -> Tuple[np.ndarray, np.ndarray]:
    """Sampled reads → ([n, 57344] uint8 payloads, [n] int32 status)."""
    lib = _lib()
    n = len(paths)
    sizes = np.ascontiguousarray(sizes, dtype=np.uint64)
    if sizes.shape != (n,):
        raise ValueError(f"sizes must be [{n}], got {sizes.shape}")
    out = np.zeros((n, LARGE_PAYLOAD), dtype=np.uint8)
    status = np.zeros(n, dtype=np.int32)
    if n:
        lib.sd_stage_large(n, _paths_array(paths), _ptr(sizes, ctypes.c_uint64),
                           _ptr(out, ctypes.c_uint8), _ptr(status, ctypes.c_int32),
                           _threads(n_threads))
    return out, status


def stage_small(paths: Sequence[str], cap: int = SMALL_CAP, *,
                n_threads: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Whole-file reads → ([n, cap+1] payloads, [n] lens, [n] status).

    The extra column lets the C plane detect files that grew past the size
    class (ERR_GREW); callers slice [:, :cap].
    """
    lib = _lib()
    n = len(paths)
    out = np.zeros((n, cap + 1), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    status = np.zeros(n, dtype=np.int32)
    if n:
        lib.sd_stage_small(n, _paths_array(paths), cap, _ptr(out, ctypes.c_uint8),
                           _ptr(lens, ctypes.c_int32), _ptr(status, ctypes.c_int32),
                           _threads(n_threads))
    return out, lens, status


def stage_batch(paths: Sequence[str], sizes: np.ndarray, out: np.ndarray,
                payload_cap: int, *, n_threads: int) -> Tuple[np.ndarray, np.ndarray]:
    """Packed staging into a caller-owned [>= n, stride] uint8 page: row i
    becomes le64(size) ‖ payload ‖ zeros, ``build_cas_messages``' layout.

    `out` must be C-contiguous with a stride that is a multiple of 1024 and
    holds 8 + payload_cap + 1 bytes (the last for the grew-detection byte
    of small rows). Returns ([n] int32 message lengths, the kernel's
    `lengths` operand, and [n] int32 status); non-OK rows are scrubbed to
    their 8-byte prefix.
    """
    lib = _lib()
    n = len(paths)
    if out.ndim != 2 or out.dtype != np.uint8 or out.shape[0] < n or \
            not out.flags.c_contiguous:
        # A mis-shaped page would let the C writer scribble past it.
        raise ValueError(
            f"stage_batch: out must be C-contiguous uint8 [>= {n}, stride], "
            f"got {out.dtype} {out.shape}")
    stride = int(out.shape[1])
    if stride < 8 + int(payload_cap) + 1 or stride % 1024:
        raise ValueError(
            f"stage_batch: stride {stride} cannot hold the {payload_cap}-byte "
            "payload class (+ prefix and grew byte) on the chunk grid")
    sizes = np.ascontiguousarray(sizes, dtype=np.uint64)
    if sizes.shape != (n,):
        raise ValueError(f"sizes must be [{n}], got {sizes.shape}")
    msg_lens = np.zeros(n, dtype=np.int32)
    status = np.zeros(n, dtype=np.int32)
    if n:
        lib.sd_stage_batch(n, _paths_array(paths), _ptr(sizes, ctypes.c_uint64),
                           _ptr(out, ctypes.c_uint8), stride, payload_cap,
                           _ptr(msg_lens, ctypes.c_int32),
                           _ptr(status, ctypes.c_int32), _threads(n_threads))
    return msg_lens, status


def png_unfilter(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """h filtered PNG rows of 1 + rowbytes bytes (inflated IDAT) →
    [h, rowbytes] uint8; UnsupportedImage on a filter type past 4. The
    plain version is ``media.imgdecode.png_unfilter_plain``."""
    from .media.imgdecode import UnsupportedImage

    src = np.frombuffer(raw, np.uint8)
    if h < 0 or rowbytes < 1 or bpp < 1 or src.size < h * (rowbytes + 1):
        raise ValueError(f"png_unfilter: {src.size} bytes cannot hold {h} rows "
                         f"of 1 + {rowbytes}")
    out = np.empty((h, rowbytes), np.uint8)
    bad = _build.library("imgdec").sd_png_unfilter(
        _ptr(src, ctypes.c_uint8), h, rowbytes, bpp, _ptr(out, ctypes.c_uint8))
    if bad:
        raise UnsupportedImage(f"PNG filter type {raw[(bad - 1) * (rowbytes + 1)]} "
                         f"in row {bad - 1}")
    return out


def luma(pixels: np.ndarray, order: Tuple[int, int, int]) -> np.ndarray:
    """[h, w, c] uint8 pixels (any strides of whole bytes, c >= 3) → [h, w]
    uint8 L by PIL's L24, reading R, G and B at channel offsets `order`.
    The plain version is ``media.imgdecode.l24``."""
    h, w, c = pixels.shape
    row_stride, pixel_stride, unit = pixels.strides
    if unit != 1 or c < 3 or min(order) < 0 or max(order) >= c or row_stride < 0:
        raise ValueError(f"luma: pixels {pixels.shape} {pixels.strides}, order {order}")
    out = np.empty((h, w), np.uint8)
    if h and w:
        first = ctypes.cast(pixels.ctypes.data, ctypes.POINTER(ctypes.c_uint8))
        _build.library("imgdec").sd_luma(first, h, w, row_stride, pixel_stride, *order,
                                         _ptr(out, ctypes.c_uint8))
    return out


def resample_lanczos(l8: np.ndarray, edge: int) -> np.ndarray:
    """[h, w] uint8 → [edge, edge] uint8, PIL's LANCZOS ``resize``. The
    plain version is ``media.imgdecode.resize_lanczos``."""
    l8 = np.ascontiguousarray(l8, dtype=np.uint8)
    h, w = l8.shape
    if h < 1 or w < 1 or edge < 1:
        raise ValueError(f"resample_lanczos: {l8.shape} to {edge}")
    out = np.empty((edge, edge), np.uint8)
    _build.library("imgdec").sd_resample_lanczos(
        _ptr(l8, ctypes.c_uint8), h, w, edge, _ptr(out, ctypes.c_uint8))
    return out


def resample_image(pixels: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[h, w] or [h, w, c] uint8 → PIL's ``resize(size, LANCZOS)`` at
    `size` = (width, height), c bands alike. The plain version is
    ``media.imgdecode.resize_image``."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w = pixels.shape[:2]
    c = pixels.shape[2] if pixels.ndim == 3 else 1
    out_w, out_h = (int(v) for v in size)
    if min(h, w, c, out_w, out_h) < 1 or pixels.ndim not in (2, 3):
        raise ValueError(f"resample_image: {pixels.shape} to {size}")
    out = np.empty((out_h, out_w) + pixels.shape[2:], np.uint8)
    _build.library("imgdec").sd_resample_lanczos_image(
        _ptr(pixels, ctypes.c_uint8), h, w, c, out_h, out_w, _ptr(out, ctypes.c_uint8))
    return out


def resample_rgba(rgba: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """[h, w, 4] RGBA uint8 → PIL's ``resize(size, LANCZOS)`` of an RGBA
    image at `size` = (width, height): premultiplied, resampled, back. The
    plain version is ``media.draw.resize_rgba(..., native=False)``."""
    rgba = np.ascontiguousarray(rgba, dtype=np.uint8)
    h, w = rgba.shape[:2]
    out_w, out_h = (int(v) for v in size)
    if rgba.ndim != 3 or rgba.shape[2] != 4 or min(h, w, out_w, out_h) < 1:
        raise ValueError(f"resample_rgba: {rgba.shape} to {size}")
    out = np.empty((out_h, out_w, 4), np.uint8)
    _build.library("imgdec").sd_resample_lanczos_rgba(
        _ptr(rgba, ctypes.c_uint8), h, w, out_h, out_w, _ptr(out, ctypes.c_uint8))
    return out


def thumb_rgb(pixels: np.ndarray, kind: int) -> np.ndarray:
    """[h, w] or [h, w, c] pixels → [h, w, 3] uint8 RGB by ``sd_thumb_rgb``'s
    `kind` (``media.imgdecode.THUMB_KINDS``). The plain version is
    ``media.imgdecode.thumb_rgb_plain``."""
    dtype = np.dtype("<u2") if kind == 1 else np.uint8
    pixels = np.ascontiguousarray(pixels, dtype=dtype)
    h, w = pixels.shape[:2]
    c = pixels.shape[2] if pixels.ndim == 3 else 1
    need = {0: 1, 1: 1, 2: 3, 3: 4, 4: 4}.get(kind)
    if need is None or c < need or pixels.ndim not in (2, 3):
        raise ValueError(f"thumb_rgb: {pixels.shape} {pixels.dtype}, kind {kind}")
    out = np.empty((h, w, 3), np.uint8)
    src = pixels.view(np.uint8)
    _build.library("imgdec").sd_thumb_rgb(
        _ptr(src, ctypes.c_uint8), h * w, c * pixels.itemsize, kind, _ptr(out, ctypes.c_uint8))
    return out


def webp_encode(rgb: np.ndarray, q: int, uv_dc: int, level: int) -> bytes:
    """[h, w, 3] uint8 RGB → a VP8 key frame's bytes (the payload of a
    "VP8 " chunk) at quantiser `q`, chroma DC delta `uv_dc` and loop filter
    `level`, in one call of csrc/webpenc.cpp. The plain version is
    ``media.webpenc.encode_plain``."""
    from .media import webp_tables as T
    from .media.webpenc import COST

    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w = rgb.shape[:2]
    if rgb.ndim != 3 or rgb.shape[2] != 3 or min(h, w) < 1 or max(h, w) > 16383 or \
            not 0 <= q <= 127:
        raise ValueError(f"webp_encode: {rgb.shape}, q {q}")
    tables = [np.asarray(t, np.int64) for t in
              (T.DC_TABLE, T.AC_TABLE, T.COEFFS_PROBA0, T.COEFFS_UPDATE_PROBA, COST)]
    cap = (1 << 16) + 4 * h * w
    while True:
        out = np.empty(cap, np.uint8)
        n = _build.library("webpenc").sd_webp_encode(
            _ptr(rgb, ctypes.c_uint8), h, w, q, uv_dc, level,
            *(_ptr(t, ctypes.c_int64) for t in tables), _ptr(out, ctypes.c_uint8), cap)
        if n >= 0:
            return out[:n].tobytes()
        cap *= 4


def gif_lzw(data: bytes, min_size: int, npixels: int) -> np.ndarray:
    """A GIF frame's LZW data (its sub-blocks joined) → [npixels] uint8
    palette indices; UnsupportedImage where the data or an end code comes
    before the frame is full, or a code lies past the table. The plain
    version is ``media.gif.lzw_plain``."""
    from .media.gif import LZW_MESSAGES
    from .media.imgdecode import UnsupportedImage

    if not 2 <= min_size <= 8 or npixels < 0:
        raise ValueError(f"gif_lzw: minimum code size {min_size}, {npixels} pixels")
    src = np.frombuffer(data, np.uint8)
    out = np.empty(npixels, np.uint8)
    status = _build.library("imgdec").sd_gif_lzw(
        _ptr(src, ctypes.c_uint8), src.size, min_size, _ptr(out, ctypes.c_uint8), npixels)
    if status:
        raise UnsupportedImage(LZW_MESSAGES[status])
    return out


def jpeg_decode(data: bytes, color: int = -1) -> np.ndarray:
    """JPEG bytes → [h, w] uint8 L (one component), [h, w, 3] uint8 RGB or
    [h, w, 4] uint8 CMYK as PIL reads it (Adobe-inverted), libjpeg-turbo's
    samples, in one call of csrc/jpegdec.cpp; `color` -1 lets the markers
    pick the colour transform, 0 forces YCbCr (YCCK) conversion, 1 none;
    UnsupportedImage with ``media.jpeg.REASONS``' reason where it refuses.
    The plain version is ``media.jpeg.decode_plain``."""
    from .media.imgdecode import MAX_PIXELS, UnsupportedImage
    from .media.jpeg import REASONS

    lib = _build.library("jpegdec")
    src = np.frombuffer(data, np.uint8)
    dims = np.zeros(3, np.int64)
    status = lib.sd_jpeg_header(_ptr(src, ctypes.c_uint8), src.size, MAX_PIXELS,
                                _ptr(dims, ctypes.c_int64))
    if status:
        raise UnsupportedImage(REASONS[status])
    w, h, c = (int(v) for v in dims)
    out = np.empty((h, w, c), np.uint8)
    status = lib.sd_jpeg_decode(_ptr(src, ctypes.c_uint8), src.size, MAX_PIXELS, color,
                                _ptr(out, ctypes.c_uint8))
    if status:
        raise UnsupportedImage(REASONS[status])
    return out[..., 0] if c == 1 else out


def tiff_chunks(data: bytes, route: int, offsets, counts, planes: int, down: int,
                across: int, tw: int, tl: int, tiled: bool, w: int, h: int, per_plane: int,
                depth: int, predictor: int, big: bool) -> tuple:
    """Every strip or tile of a TIFF image decoded and placed in one call of
    csrc/tiffdec.cpp → (status, [planes, h, image rowbytes] uint8 or None),
    status as ``media.tiff.REASONS``. The plain version is
    ``media.tiff.chunks_plain``."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    if offsets.shape != (planes * down * across,) or counts.shape != offsets.shape or \
            min(tw, tl, w, h, per_plane) < 1 or depth not in (1, 2, 4, 8, 16):
        raise ValueError(f"tiff_chunks: {offsets.shape} chunks for {planes} x {down} x "
                         f"{across}, {tw} x {tl} of {w} x {h}, {per_plane} x {depth} bits")
    src = np.frombuffer(data, np.uint8)
    out = np.zeros((planes, h, (w * per_plane * depth + 7) // 8), np.uint8)
    status = _build.library("tiffdec").sd_tiff_chunks(
        _ptr(src, ctypes.c_uint8), src.size, route, _ptr(offsets, ctypes.c_int64),
        _ptr(counts, ctypes.c_int64), planes, down, across, tw, tl, int(tiled), w, h,
        per_plane, depth, predictor, int(big), _ptr(out, ctypes.c_uint8))
    return int(status), (out if status == 0 else None)


def _webp_bands(fn: str, payload: bytes, width: int, height: int, *extra) -> tuple:
    if width < 1 or height < 1:
        raise ValueError(f"{fn}: frame {width}x{height}")
    bands = extra[0] if extra else 3
    src = np.frombuffer(payload, np.uint8)
    out = np.empty((height, width, bands), np.uint8)
    status = getattr(_build.library("webpdec"), fn)(
        _ptr(src, ctypes.c_uint8), src.size, width, height, *extra, _ptr(out, ctypes.c_uint8))
    return int(status), (out if status == 0 else None)


def webp_lossless(payload: bytes, width: int, height: int, bands: int = 3) -> tuple:
    """A VP8L chunk's payload (to the end of the frame's bytes) of a
    width x height frame → (status, [h, w, bands] uint8 RGB, or RGBA with
    bands 4, or None), in one call of csrc/webpdec.cpp; status as
    ``media.webp.REASONS``. The plain version is
    ``media.webp.lossless_plain``."""
    if bands not in (3, 4):
        raise ValueError(f"webp_lossless: {bands} bands")
    return _webp_bands("sd_webp_lossless_bands", payload, width, height, bands)


def webp_lossy(payload: bytes, width: int, height: int) -> tuple:
    """A VP8 key frame's payload → (status, [h, w, 3] uint8 RGB or None),
    libwebp's reconstruction, loop filter, fancy upsampling and YUV to
    RGB. The plain version is ``media.webp.lossy_plain``."""
    return _webp_bands("sd_webp_lossy", payload, width, height)


def webp_alpha(payload: bytes, width: int, height: int, plane: bool = False):
    """An ALPH chunk's payload of a width x height frame → the status
    libwebp's alpha decoder ends with (0 where it decodes); with `plane`,
    (status, the [h, w] uint8 alpha plane or None). The plain versions are
    ``media.webp.alpha_plain`` and ``alpha_plane_plain``."""
    if width < 1 or height < 1:
        raise ValueError(f"webp_alpha: frame {width}x{height}")
    src = np.frombuffer(payload, np.uint8)
    lib = _build.library("webpdec")
    if not plane:
        return int(lib.sd_webp_alpha(_ptr(src, ctypes.c_uint8), src.size, width, height))
    out = np.empty((height, width), np.uint8)
    status = int(lib.sd_webp_alpha_plane(_ptr(src, ctypes.c_uint8), src.size, width, height,
                                         _ptr(out, ctypes.c_uint8)))
    return status, (out if status == 0 else None)
