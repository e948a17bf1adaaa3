"""``media/exif.py`` against the JAX package's ``extract_media_data``.

The JAX function reads through PIL; the port reads the same header fields
and EXIF bytes itself. Each case writes a file with PIL here and holds the
two rows equal byte for byte (both None, or the same msgpack blobs):
JPEG, PNG ``eXIf``, WebP ``EXIF``, TIFF, DNG, AVIF with and without the
orientation ``irot``/``imir`` carry, HEIF boxes around an Exif item; GPS in
all four quadrants, zero denominators, ISO as a tuple, no EXIF at all; and
seeded mutations of each EXIF block.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image, TiffImagePlugin

from spacedrive_tpu.media import exif as jax_exif
from spacedrive_tpu_torch import _msgpack
from spacedrive_tpu_torch.media import exif as port_exif

R = TiffImagePlugin.IFDRational


def _exif(lat="N", lon="E", fnum=(28, 10), iso=200, orient=6, exposure=(1, 250),
          focal=(50, 1), date="2024:05:06 07:08:09") -> Image.Exif:
    ex = Image.Exif()
    ex[0x010F], ex[0x0110], ex[0x0131] = "Canon", "EOS R5", "fw 1.0"
    if orient is not None:
        ex[0x0112] = orient
    sub = ex.get_ifd(0x8769)
    sub[0x9003] = date
    sub[0x829D], sub[0x829A], sub[0x920A] = R(*fnum), R(*exposure), R(*focal)
    sub[0x8827] = iso
    sub[0xA433], sub[0xA434] = "Canon", "RF 24-70mm"
    gps = ex.get_ifd(0x8825)
    gps[1], gps[2] = lat, (R(37, 1), R(46, 1), R(3015, 100))
    gps[3], gps[4] = lon, (R(122, 1), R(25, 1), R(1, 3))
    return ex


def _scene(h=40, w=56):
    y, x = np.mgrid[0:h, 0:w]
    return np.stack([x * 4 % 256, y * 6 % 256, (x + y) * 3 % 256], -1).astype(np.uint8)


def _save(fmt, exif=None, **kw) -> bytes:
    buf = io.BytesIO()
    if exif is not None:
        kw["exif"] = exif.tobytes() if isinstance(exif, Image.Exif) else exif
    Image.fromarray(_scene()).save(buf, fmt, **kw)
    return buf.getvalue()


def _rows_equal(tmp_path, name: str, data: bytes):
    path = tmp_path / name
    path.write_bytes(data)
    want = jax_exif.extract_media_data(str(path))
    got = port_exif.extract_media_data(str(path))
    assert got == want, name
    return got


FORMATS = {"jpg": "JPEG", "png": "PNG", "webp": "WEBP", "tiff": "TIFF", "avif": "AVIF"}


@pytest.mark.parametrize("ext", sorted(FORMATS))
@pytest.mark.parametrize("case", ["full", "ne", "sw", "se", "nw", "zero_denominators",
                                  "iso_tuple", "no_orientation", "no_exif"])
def test_rows_equal_the_jax_functions(tmp_path, ext, case):
    kw = {"ne": dict(lat="N", lon="E"), "sw": dict(lat="S", lon="W"),
          "se": dict(lat="S", lon="E"), "nw": dict(lat="N", lon="W"),
          "zero_denominators": dict(fnum=(28, 0), exposure=(0, 0), focal=(5, 0)),
          "no_orientation": dict(orient=None)}.get(case, {})
    exif = None if case == "no_exif" else _exif(**kw)
    if case == "iso_tuple":
        exif.get_ifd(0x8769)[0x8827] = (100, 200)
    if ext == "webp":
        extra = {"lossless": True}
    else:
        extra = {}
    row = _rows_equal(tmp_path, f"{case}.{ext}", _save(FORMATS[ext], exif, **extra))
    assert row is not None and "resolution" in row
    if case == "no_exif":
        assert set(row) == {"resolution"}


@pytest.mark.parametrize("orientation", range(1, 9))
def test_avif_orientation_rides_irot_and_imir(tmp_path, orientation):
    exif = _exif(orient=orientation)
    row = _rows_equal(tmp_path, f"o{orientation}.avif", _save("AVIF", exif))
    # PIL moves the orientation into irot/imir and back; 1 is no transform.
    assert _msgpack.unpackb(row["camera_data"]).get("orientation", 1) == orientation


def _dng(preview: bytes, order: str = "<") -> bytes:
    """A DNG-shaped TIFF: IFD0 an 8-bit RGB thumbnail strip with Make and
    Model, a SubIFD holding a JPEG preview."""
    e = order
    w, h = 8, 6
    pixels = bytes(range(w * h * 3))
    entries = []

    def entry(tag, typ, count, value: bytes):
        entries.append((tag, typ, count, value))

    head = (b"II*\x00" if e == "<" else b"MM\x00*") + struct.pack(e + "I", 8)
    make, model = b"Nikon\x00", b"Z 9\x00"
    n_entries = 12
    ifd_size = 2 + 12 * n_entries + 4
    data_at = 8 + ifd_size
    blobs = b""

    def place(b: bytes) -> int:
        nonlocal blobs
        at = data_at + len(blobs)
        blobs += b + b"\x00" * (len(b) & 1)
        return at

    bps_at = place(struct.pack(e + "3H", 8, 8, 8))
    make_at, model_at = place(make), place(model)
    strip_at = place(pixels)
    sub_at = data_at + len(blobs)
    sub_ifd_size = 2 + 12 * 3 + 4
    jpeg_at = sub_at + sub_ifd_size
    sub = struct.pack(e + "H", 3)
    sub += struct.pack(e + "HHII", 0x00FE, 4, 1, 0)
    sub += struct.pack(e + "HHII", 0x0201, 4, 1, jpeg_at)
    sub += struct.pack(e + "HHII", 0x0202, 4, 1, len(preview)) + struct.pack(e + "I", 0)
    short = lambda v: struct.pack(e + "HH", v, 0)  # noqa: E731
    long_ = lambda v: struct.pack(e + "I", v)  # noqa: E731
    entry(0x00FE, 4, 1, long_(1))
    entry(0x0100, 3, 1, short(w))
    entry(0x0101, 3, 1, short(h))
    entry(0x0102, 3, 3, long_(bps_at))
    entry(0x0103, 3, 1, short(1))
    entry(0x0106, 3, 1, short(2))
    entry(0x010F, 2, len(make), long_(make_at))
    entry(0x0110, 2, len(model), long_(model_at))
    entry(0x0111, 4, 1, long_(strip_at))
    entry(0x0115, 3, 1, short(3))
    entry(0x0117, 4, 1, long_(len(pixels)))
    entry(0x014A, 4, 1, long_(sub_at))
    ifd = struct.pack(e + "H", n_entries) + b"".join(
        struct.pack(e + "HHI", t, ty, c) + v for t, ty, c, v in sorted(entries)) + \
        struct.pack(e + "I", 0)
    return head + ifd + blobs + sub + preview


@pytest.mark.parametrize("order", ["<", ">"])
def test_dng_rows_equal(tmp_path, order):
    row = _rows_equal(tmp_path, "raw.dng", _dng(_save("JPEG"), order))
    assert _msgpack.unpackb(row["camera_data"])["make"] == "Nikon"


def _box(kind: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def heif_bytes(jpeg: bytes, exif_tiff: bytes, width: int, height: int,
               brand: bytes = b"heic") -> bytes:
    """An ISO BMFF file around a JPEG-coded primary item and an Exif item
    (the layout ``tests/test_heif_pdf.py`` builds)."""
    ftyp = _box(b"ftyp", brand + b"\x00\x00\x00\x00" + b"mif1" + brand)
    pitm = _box(b"pitm", b"\x00\x00\x00\x00" + struct.pack(">H", 1))
    infe1 = _box(b"infe", b"\x02\x00\x00\x00" + struct.pack(">HH", 1, 0) + b"jpeg" + b"\x00")
    infe2 = _box(b"infe", b"\x02\x00\x00\x00" + struct.pack(">HH", 2, 0) + b"Exif" + b"\x00")
    iinf = _box(b"iinf", b"\x00\x00\x00\x00" + struct.pack(">H", 2) + infe1 + infe2)
    ispe = _box(b"ispe", b"\x00\x00\x00\x00" + struct.pack(">II", width, height))
    iprp = _box(b"iprp", _box(b"ipco", ispe))
    exif_item = struct.pack(">I", 0) + exif_tiff

    def build(off1: int, off2: int) -> bytes:
        iloc = _box(b"iloc", b"\x00\x00\x00\x00" + struct.pack(">BBH", 0x44, 0x00, 2)
                    + struct.pack(">HHHII", 1, 0, 1, off1, len(jpeg))
                    + struct.pack(">HHHII", 2, 0, 1, off2, len(exif_item)))
        meta = _box(b"meta", b"\x00\x00\x00\x00" + _box(b"hdlr", b"\x00" * 4 + b"\x00" * 4
                                                          + b"pict" + b"\x00" * 13)
                    + pitm + iinf + iloc + iprp)
        return ftyp + meta

    head = build(0, 0)
    mdat_at = len(head) + 8
    head = build(mdat_at, mdat_at + len(jpeg))
    return head + _box(b"mdat", jpeg + exif_item)


@pytest.mark.parametrize("ext,brand", [("heic", b"heic"), ("heif", b"mif1"), ("avif", b"avif")])
def test_heif_boxes_rows_equal(tmp_path, ext, brand):
    tiff = _exif().tobytes()[6:]
    row = _rows_equal(tmp_path, f"x.{ext}", heif_bytes(_save("JPEG"), tiff, 4032, 3024, brand))
    assert _msgpack.unpackb(row["resolution"]) == {"width": 4032, "height": 3024}


def _mutations(data: bytes, lo: int, hi: int, seed: int, n: int):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        out = bytearray(data)
        for at in rng.integers(lo, hi, int(rng.integers(1, 4))).tolist():
            out[at] = int(rng.integers(0, 256))
        yield bytes(out)


def _png_with_chunk(data: bytes, kind: bytes, payload: bytes) -> bytes:
    """`data` (a PNG) with a chunk of `kind` before its first IDAT, CRC
    fixed."""
    at = data.index(b"IDAT") - 4
    chunk = struct.pack(">I", len(payload)) + kind + payload + struct.pack(
        ">I", zlib.crc32(kind + payload))
    return data[:at] + chunk + data[at:]


@pytest.mark.parametrize("ext", ["jpg", "png", "webp", "tiff"])
@pytest.mark.parametrize("seed", range(6))
def test_mutated_exif_blocks_give_the_same_row(tmp_path, ext, seed):
    block = _exif().tobytes()
    if ext == "png":
        base = _save("PNG")
        files = [_png_with_chunk(base, b"eXIf", m[6:])
                 for m in _mutations(block, 6, len(block), seed, 8)]
    else:
        base = _save(FORMATS[ext], _exif(), **({"lossless": True} if ext == "webp" else {}))
        start = base.index(block[6:22]) if ext != "tiff" else 8
        span = len(block) - 6 if ext != "tiff" else len(base) - 8 - 56 * 40 * 3
        files = list(_mutations(base, start, start + max(span, 16), seed, 8))
    for k, data in enumerate(files):
        _rows_equal(tmp_path, f"m{seed}_{k}.{ext}", data)


@pytest.mark.parametrize("case", ["raw_profile", "text_exif", "xmp_orientation", "jfif_dpi",
                                  "truncated_png", "bad_header"])
def test_other_places_pil_reads(tmp_path, case):
    block = _exif(orient=None).tobytes()
    if case == "raw_profile":
        hexed = block.hex()
        text = f"\nexif\n{len(block)}\n" + "\n".join(hexed[i:i + 72]
                                                   for i in range(0, len(hexed), 72))
        data = _png_with_chunk(_save("PNG"), b"tEXt", b"Raw profile type exif\x00" +
                               text.encode("latin-1"))
    elif case == "text_exif":
        data = _png_with_chunk(_save("PNG"), b"tEXt", b"exif\x00" + block)
    elif case == "xmp_orientation":
        data = _save("JPEG", block, xmp=b'<x:xmpmeta><rdf:Description tiff:Orientation="8"/>'
                                        b'</x:xmpmeta>')
    elif case == "jfif_dpi":
        data = _save("JPEG", b"Exif\x00\x00XX*\x00junk", dpi=(300, 300))
    elif case == "truncated_png":
        data = _save("PNG")[:-30]
    else:
        data = _save("JPEG", b"Exif\x00\x00XX*\x00junk")
    ext = "jpg" if case in ("xmp_orientation", "jfif_dpi", "bad_header") else "png"
    _rows_equal(tmp_path, f"{case}.{ext}", data)
