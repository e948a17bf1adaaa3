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
- SVG through the port's rasterizer (``media/svg.py``), RGBA at
  ``SVG_TARGET_PX``, the JAX ``render_svg``'s pixels;
- PDF through pypdfium2 where it imports (neither this port's hosts nor
  the JAX package's have it), else the page's largest image stream
  (``media/pdf.py``: DCTDecode through the port's JPEG decoder,
  FlateDecode as RGB or L).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

MIB = 1_048_576
MAXIMUM_FILE_SIZE = 192 * MIB     # consts.rs:9
SVG_TARGET_PX = 262_144.0         # consts.rs:31
PDF_RENDER_WIDTH = 992            # consts.rs:37

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


def _pdf_available() -> bool:
    try:
        import pypdfium2  # noqa: F401

        return True
    except ImportError:
        return False


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
    if ext in SVG_EXTENSIONS:
        from .svg import render_svg

        return render_svg(path, target_px=SVG_TARGET_PX, native=native), "RGBA"
    if ext in PDF_EXTENSIONS:
        if _pdf_available():
            import pypdfium2

            pdf = pypdfium2.PdfDocument(path)
            page = pdf[0]
            scale = PDF_RENDER_WIDTH / page.get_size()[0]
            bitmap = page.render(scale=scale, rev_byteorder=True)
            return bitmap.to_numpy(), bitmap.mode
        from .pdf import PdfImageError, pdf_first_image

        try:
            return pdf_first_image(path, native=native)
        except PdfImageError as e:
            raise UnsupportedFormat(str(e)) from e
    raise UnsupportedFormat(f"unsupported image extension: {ext!r}")
