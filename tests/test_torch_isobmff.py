"""``media/isobmff.py`` against the JAX package's: the same parse, sizes,
EXIF and embedded JPEG of ISO BMFF files (a JPEG-coded item beside an Exif
item, the IFD1 thumbnail route, PIL-written AVIF) and the same refusals of
cut and garbled boxes."""

from __future__ import annotations

import io

import numpy as np
import pytest
from PIL import Image

from spacedrive_tpu.media import isobmff as jax_box
from spacedrive_tpu_torch.media import isobmff as port_box
from tests.test_torch_exif import _exif, _save, heif_bytes


def _outcome(mod, data):
    out = {}
    for name in ("heif_dimensions", "heif_exif", "heif_embedded_jpeg"):
        try:
            out[name] = getattr(mod, name)(data)
        except Exception as e:  # noqa: BLE001 (the refusal is the outcome)
            out[name] = (type(e).__name__, str(e))
    try:
        meta = mod.parse_heif(data)
        out["meta"] = (meta.primary, sorted((i, it.item_type, it.content_type, it.extents,
                                              it.construction_method, it.base_offset)
                                             for i, it in meta.items.items()),
                       sorted(meta.refs.items()), meta.idat)
    except Exception as e:  # noqa: BLE001
        out["meta"] = (type(e).__name__, str(e))
    return out


def _thumb_exif() -> bytes:
    """An EXIF TIFF whose IFD1 carries a JPEG thumbnail."""
    im = Image.fromarray(np.full((16, 16, 3), 90, np.uint8))
    buf = io.BytesIO()
    im.save(buf, "JPEG")
    jpeg = buf.getvalue()
    import struct
    ifd0 = struct.pack("<H", 0) + struct.pack("<I", 14)
    ifd1 = struct.pack("<H", 2) + struct.pack("<HHII", 0x0201, 4, 1, 44) + \
        struct.pack("<HHII", 0x0202, 4, 1, len(jpeg)) + struct.pack("<I", 0)
    return b"II*\x00" + struct.pack("<I", 8) + ifd0 + ifd1 + jpeg


CASES = {
    "jpeg_item": lambda: heif_bytes(_save("JPEG"), _exif().tobytes()[6:], 640, 480),
    "ifd1_thumbnail": lambda: heif_bytes(b"\x00" * 10, _thumb_exif(), 320, 240, b"mif1"),
    "avif": lambda: _save("AVIF", _exif()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_outputs_equal(case):
    data = CASES[case]()
    out = _outcome(port_box, data)
    assert out == _outcome(jax_box, data)
    assert out["heif_dimensions"] is not None


@pytest.mark.parametrize("seed", range(10))
def test_cut_and_garbled_boxes_equal(seed):
    rng = np.random.default_rng(seed)
    data = bytearray(CASES[sorted(CASES)[seed % 3]]())
    if seed < 5:
        data = data[:int(rng.integers(4, len(data)))]
    else:
        for at in rng.integers(0, min(len(data), 300), 4).tolist():
            data[at] = int(rng.integers(0, 256))
    assert _outcome(port_box, bytes(data)) == _outcome(jax_box, bytes(data))
