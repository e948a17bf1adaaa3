"""Thumbnail generation: WebP thumbnails in a 256-way sharded cache.

Port of ``spacedrive_tpu/media/thumbnail.py``. Thumbnails live at
``<data_dir>/thumbnails/<cas_id[0:2]>/<cas_id>.webp``, scaled so
width × height ≈ TARGET_PX = 262 144 px² (never up), lossy WebP at quality
30, the layout and ``version.txt`` the JAX package writes, so each package
reads the other's cache. Where the JAX function runs PIL, the port runs its
own passes on the host: the decoders (``media/imgdecode.py``), ``thumb_rgb``
(RGBA onto white, else PIL's ``convert("RGB")``), PIL's LANCZOS at the
thumbnail's size (``native.resample_image``) and its own VP8 encoder
(``media/webpenc.py``). The grid handed to the encoder equals the one PIL's
``save`` receives in the JAX ``encode_webp``; the WebP bytes are the port's.
"""

from __future__ import annotations

import gzip
import math
import os
import zlib
from typing import Optional, Tuple

import numpy as np

from .. import persist
from . import imgdecode, webpenc

TARGET_PX = 262144.0    # thumbnail/mod.rs:113
TARGET_QUALITY = webpenc.QUALITY
WEBP_EXTENSION = "webp"
VERSION_FILE = "version.txt"
THUMBNAIL_CACHE_VERSION = 1

# The JAX package's static set: its PIL raster set, SVG, MJPEG .avi, and
# HEIF/PDF through their embedded payloads.
THUMBNAILABLE_EXTENSIONS = {
    "jpg", "jpeg", "png", "gif", "bmp", "tiff", "webp", "ico", "apng",
    "svg", "svgz", "avi",
    "heic", "heif", "heifs", "heics", "avif", "avci", "avcs", "pdf",
}


def thumbnailable_extensions() -> set:
    """The JAX package's set in this runtime: the static set, the cover-art
    containers, TIFF-structured RAW and H.264 transport streams always,
    every video container when ffmpeg or OpenCV is present."""
    from .rawpreview import RAW_TIFF_EXTENSIONS
    from .video import (_COVER_EXTENSIONS, _H264_TS_EXTENSIONS, VIDEO_EXTENSIONS, available,
                        cv2_available)

    exts = (set(THUMBNAILABLE_EXTENSIONS) | _COVER_EXTENSIONS | RAW_TIFF_EXTENSIONS
            | _H264_TS_EXTENSIONS)
    if available() or cv2_available():
        exts |= VIDEO_EXTENSIONS
    return exts


def shard_hex(cas_id: str) -> str:
    """Two-char shard dir (shard.rs:4)."""
    return cas_id[:2]


def thumbnail_path(data_dir: str, cas_id: str) -> str:
    return os.path.join(data_dir, "thumbnails", shard_hex(cas_id), f"{cas_id}.{WEBP_EXTENSION}")


def ensure_thumbnail_dir(data_dir: str) -> str:
    root = os.path.join(data_dir, "thumbnails")
    os.makedirs(root, exist_ok=True)
    version_file = os.path.join(root, VERSION_FILE)
    if not os.path.exists(version_file):
        persist.atomic_write("media.thumbs_version", version_file, str(THUMBNAIL_CACHE_VERSION))
    return root


def scale_dimensions(w: float, h: float, target_px: float = TARGET_PX) -> Tuple[int, int]:
    """Scale preserving aspect ratio to ~target_px total pixels, never up
    (thumbnail/mod.rs:142; Python's round)."""
    ratio = math.sqrt(target_px / (w * h)) if w * h > 0 else 1.0
    ratio = min(ratio, 1.0)
    return max(1, round(w * ratio)), max(1, round(h * ratio))


def thumbnail_rgb(pixels: np.ndarray, mode: str, *, native: bool = True,
                  target_px: float = TARGET_PX) -> np.ndarray:
    """A decoded image → the [h', w', 3] RGB grid the encoder takes: thumb_rgb,
    then LANCZOS to ``scale_dimensions``' size."""
    rgb = imgdecode.thumb_rgb(pixels, mode, native=native)
    h, w = rgb.shape[:2]
    size = scale_dimensions(w, h, target_px)
    if size == (w, h):
        return rgb
    if native:
        from .. import native as plane
        return plane.resample_image(rgb, size)
    return imgdecode.resize_image(rgb, size)


def encode_webp(pixels: np.ndarray, mode: str, out_path: str, *, native: bool = True,
                target_px: float = TARGET_PX) -> str:
    """RGB(A)-composite → scale → atomic WebP write (the shared tail of
    every thumbnail path)."""
    rgb = thumbnail_rgb(pixels, mode, native=native, target_px=target_px)
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    data = webpenc.encode(rgb, native=native)
    persist.atomic_write("media.thumbnail", out_path, data)
    return out_path


def generate_thumbnail(input_path: str, data_dir: str, cas_id: str, *,
                       native: bool = True) -> Optional[str]:
    """Decode → scale → WebP → sharded cache. Returns the output path, or
    None where the format is not thumbnailed here or the decoder refuses
    the file. Skips work if the thumbnail already exists. A fault of the
    native plane (its build or load) raises."""
    out = thumbnail_path(data_dir, cas_id)
    if os.path.exists(out):
        return out
    ext = os.path.splitext(input_path)[1].lstrip(".").lower()
    from .video import VIDEO_EXTENSIONS, generate_video_thumbnail

    if ext in VIDEO_EXTENSIONS:
        # generate_video_thumbnail picks ffmpeg / OpenCV / the self-hosted
        # decoders / cover art / None itself.
        return generate_video_thumbnail(input_path, out, native=native)
    from .images import ImageHandlerError, format_image
    from .rawpreview import RAW_TIFF_EXTENSIONS, extract_preview

    try:
        if ext in RAW_TIFF_EXTENSIONS:
            blob = extract_preview(input_path)
            if blob is None:
                return None
            pixels, mode = imgdecode.decode_image(blob, native=native)
        else:
            pixels, mode = format_image(input_path, native=native)
        return encode_webp(pixels, mode, out, native=native)
    except (ValueError, SyntaxError, EOFError, gzip.BadGzipFile, zlib.error, ImageHandlerError,
            FileNotFoundError, IsADirectoryError, PermissionError):
        # A file the decoders refuse, an SVG that does not parse (ValueError
        # covers imgdecode.UnsupportedImage, SyntaxError the XML parser's).
        return None


def remove_thumbnails_by_cas_ids(data_dir: str, cas_ids) -> int:
    """Thumbnailer::remove_cas_ids (actor API)."""
    n = 0
    for cas_id in cas_ids:
        p = thumbnail_path(data_dir, cas_id)
        if os.path.exists(p):
            os.remove(p)
            n += 1
    return n
