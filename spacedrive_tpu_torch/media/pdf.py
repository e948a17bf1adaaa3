"""PDF first-page image extraction without a PDF renderer.

Port of ``spacedrive_tpu/media/pdf.py``. Most PDF pages that *contain* an
image carry it as an image XObject whose stream is directly recoverable:

- /Filter /DCTDecode  → the stream IS a JPEG, decoded by the port's own
  decoder (media/imgdecode.py); one it refuses moves on to the next
  candidate, as the JAX function does with whatever PIL raises;
- /Filter /FlateDecode → zlib-compressed raw samples, reconstructable
  from /Width /Height /ColorSpace /BitsPerComponent (+ optional PNG
  predictors from /DecodeParms), as RGB or L.

Scope: unencrypted PDFs with image XObjects in plain object streams
(not /ObjStm-packed); the first (largest) image in document order
stands in for "first page". Outside that envelope the caller gets
UnsupportedFormat and degrades per-file like every other handler.
"""

from __future__ import annotations

import re
import zlib
from typing import List, Tuple

import numpy as np

_OBJ_RE = re.compile(
    rb"(\d+)\s+(\d+)\s+obj(.*?)(?:endobj|\Z)", re.DOTALL)
_STREAM_RE = re.compile(rb"stream\r?\n(.*?)(?:\r?\n)?endstream", re.DOTALL)
_INT_RE = {
    "Width": re.compile(rb"/Width\s+(\d+)"),
    "Height": re.compile(rb"/Height\s+(\d+)"),
    "BitsPerComponent": re.compile(rb"/BitsPerComponent\s+(\d+)"),
    "Predictor": re.compile(rb"/Predictor\s+(\d+)"),
    "Colors": re.compile(rb"/Colors\s+(\d+)"),
    "Columns": re.compile(rb"/Columns\s+(\d+)"),
}


class PdfImageError(ValueError):
    pass


def _int(dict_src: bytes, key: str, default: int = 0) -> int:
    m = _INT_RE[key].search(dict_src)
    return int(m.group(1)) if m else default


def _png_unpredict(raw: bytes, columns: int, colors: int) -> bytes:
    """Reverse PNG row filters (predictor 10-15): each row is one filter
    byte + columns*colors bytes."""
    stride = columns * colors
    out = bytearray()
    prev = bytes(stride)
    pos = 0
    while pos + 1 + stride <= len(raw) + stride:  # allow short last row
        ft = raw[pos]
        row = bytearray(raw[pos + 1:pos + 1 + stride])
        pos += 1 + stride
        if ft == 1:    # Sub
            for i in range(colors, len(row)):
                row[i] = (row[i] + row[i - colors]) & 0xFF
        elif ft == 2:  # Up
            for i in range(len(row)):
                row[i] = (row[i] + prev[i]) & 0xFF
        elif ft == 3:  # Average
            for i in range(len(row)):
                left = row[i - colors] if i >= colors else 0
                row[i] = (row[i] + ((left + prev[i]) >> 1)) & 0xFF
        elif ft == 4:  # Paeth
            for i in range(len(row)):
                a = row[i - colors] if i >= colors else 0
                b = prev[i]
                c = prev[i - colors] if i >= colors else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (
                    b if pb <= pc else c)
                row[i] = (row[i] + pred) & 0xFF
        elif ft != 0:
            raise PdfImageError(f"unknown PNG filter {ft}")
        out += row
        prev = bytes(row)
        if pos >= len(raw):
            break
    return bytes(out)


def _candidates(data: bytes) -> List[Tuple[int, bytes, bytes]]:
    """(pixel_area, dict_src, stream_bytes) for every image XObject."""
    out = []
    for m in _OBJ_RE.finditer(data):
        body = m.group(3)
        if b"/Subtype" not in body or b"/Image" not in body:
            continue
        sm = _STREAM_RE.search(body)
        if not sm:
            continue
        dict_src = body[:sm.start()]
        w, h = _int(dict_src, "Width"), _int(dict_src, "Height")
        if w <= 0 or h <= 0:
            continue
        out.append((w * h, dict_src, sm.group(1)))
    out.sort(key=lambda t: -t[0])
    return out


def pdf_first_image(path: str, *, native: bool = True) -> Tuple[np.ndarray, str]:
    """Decode the largest image XObject in the PDF to (pixels, mode), as
    ``imgdecode.decode_image`` gives them."""
    from .imgdecode import decode_image

    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"%PDF"):
        raise PdfImageError(f"{path}: not a PDF")
    errors = []
    for _area, dict_src, stream in _candidates(data):
        try:
            if b"/DCTDecode" in dict_src:
                return decode_image(stream, native=native)
            if b"/FlateDecode" in dict_src:
                raw = zlib.decompress(stream)
                w = _int(dict_src, "Width")
                h = _int(dict_src, "Height")
                bpc = _int(dict_src, "BitsPerComponent", 8)
                if bpc != 8:
                    raise PdfImageError(f"unsupported {bpc}-bit samples")
                if b"/DeviceRGB" in dict_src:
                    mode, colors = "RGB", 3
                elif b"/DeviceGray" in dict_src:
                    mode, colors = "L", 1
                else:
                    raise PdfImageError("unsupported color space")
                pred = _int(dict_src, "Predictor", 1)
                if pred >= 10:
                    raw = _png_unpredict(
                        raw, _int(dict_src, "Columns", w),
                        _int(dict_src, "Colors", colors))
                elif pred != 1:
                    raise PdfImageError(f"unsupported predictor {pred}")
                need = w * h * colors
                if len(raw) < need:
                    raise PdfImageError("short image stream")
                px = np.frombuffer(raw[:need], np.uint8)
                return px.reshape((h, w, colors) if colors > 1 else (h, w)), mode
            raise PdfImageError("no supported filter")
        except (ValueError, zlib.error) as e:  # try the next candidate
            errors.append(str(e))
    raise PdfImageError(
        f"{path}: no extractable image stream"
        + (f" ({'; '.join(errors[:3])})" if errors else ""))
