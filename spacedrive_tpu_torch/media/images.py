"""Image decode dispatch for thumbnails (the sd-images crate surface).

Port of ``format_image`` in ``spacedrive_tpu/media/images.py``: route by
extension behind the 192 MiB size guard, raising ``UnsupportedFormat``
with the reason where no handler applies. The JAX package decodes through
PIL; the port decodes with its own decoders (``media/imgdecode.py``) and
returns ``imgdecode.decode_image``'s (pixels, mode):

- the generic raster set through the port's decoders (the format read from
  the bytes' signature, as PIL reads it);
- HEIF and AVIF through the container's embedded JPEG (a JPEG-coded item,
  else the EXIF IFD1 thumbnail; ``media/isobmff.py``), as the JAX package
  does where no HEIF plugin is installed (neither this port's hosts nor
  the JAX package's have one);
- SVG and PDF are the second media slice's and raise ``UnsupportedFormat``.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

MIB = 1_048_576
MAXIMUM_FILE_SIZE = 192 * MIB     # consts.rs:9

GENERIC_EXTENSIONS = {
    "apng", "bmp", "dib", "ff", "gif", "ico", "jpg", "jpeg", "png",
    "pnm", "qoi", "tga", "icb", "vda", "vst", "tiff", "tif", "webp",
}
SVG_EXTENSIONS = {"svg", "svgz"}
PDF_EXTENSIONS = {"pdf"}
HEIF_EXTENSIONS = {"heif", "heifs", "heic", "heics", "avif", "avci",
                   "avcs"}


class ImageHandlerError(Exception):
    pass


class UnsupportedFormat(ImageHandlerError):
    pass


def _check_size(path: str) -> None:
    if os.path.getsize(path) > MAXIMUM_FILE_SIZE:
        raise ImageHandlerError(
            f"{path}: exceeds maximum image size (192 MiB)")


def format_image(path: str, *, native: bool = True) -> Tuple[np.ndarray, str]:
    """Decode any supported image to (pixels, mode) (handler.rs:18);
    ``imgdecode.UnsupportedImage`` where the port's decoder refuses it."""
    from .imgdecode import decode_image

    _check_size(path)
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    if ext in GENERIC_EXTENSIONS:
        with open(path, "rb") as f:
            return decode_image(f.read(), native=native)
    if ext in HEIF_EXTENSIONS:
        from .isobmff import BoxError, heif_embedded_jpeg

        with open(path, "rb") as f:
            data = f.read()
        try:
            jpeg = heif_embedded_jpeg(data)
        except BoxError as e:
            raise UnsupportedFormat(f"{ext}: {e}") from e
        if jpeg is None:
            raise UnsupportedFormat(
                f"{ext}: no embedded JPEG item or EXIF thumbnail "
                "(full HEVC decode unavailable in this runtime)")
        return decode_image(jpeg, native=native)
    if ext in SVG_EXTENSIONS or ext in PDF_EXTENSIONS:
        raise UnsupportedFormat(f"{ext}: not ported yet (media slice 2)")
    raise UnsupportedFormat(f"unsupported image extension: {ext!r}")
