"""The port's SVG rasterizer and PDF image streams against the JAX package's.

SVG: the supersampled canvas the JAX ``render_svg`` draws with PIL
(captured where it calls ``Image.resize``) and the resized RGBA must equal
the port's ``svg.rasterize`` / ``svg.render_svg`` bit for bit, native and
plain: on the JAX tests' SVGs, on strokes of width 1, 3, 5 and 9 pixels
and wider (PIL's joints and gap lines), rotated and skewed shapes, arcs
and Béziers, opacity, every colour syntax, and on seeded random documents.
The drawing primitives are held to PIL one by one on random input
(``media/draw.py``), and what they do not match yet is pinned with its
size. PDF: the image XObject each package recovers (DCT, Flate with and
without a PNG predictor, gray, none), and the thumbnail grids of both.
"""

from __future__ import annotations

import gzip
import io
import os
import re
import zlib

import numpy as np
import pytest
from PIL import Image, ImageColor, ImageDraw

from spacedrive_tpu.media import images as jax_images
from spacedrive_tpu.media import pdf as jax_pdf
from spacedrive_tpu.media import svg as jax_svg
from spacedrive_tpu.media import thumbnail as jax_thumb
from spacedrive_tpu_torch.media import draw, images, pdf, svg, thumbnail, webpenc

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
with open(os.path.join(os.path.dirname(__file__), "test_svg.py")) as _f:
    JAX_TEST_SVG = re.search(r'SVG = """(.*?)"""', _f.read(), re.S).group(1)

DOCS = {
    "jax_test.svg": JAX_TEST_SVG,
    "arc.svg": ('<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 40 40">'
                '<path d="M20 10 A 10 10 0 1 1 19.9 10 Z" fill="lime"/></svg>'),
    "strokes.svg": """<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 100 100">
  <polyline points="5,5 40,12 20,30 60,25" fill="none" stroke="black" stroke-width="0.049"/>
  <polyline points="5,35 40,42 20,60 60,55 70,20" fill="none" stroke="#c03" stroke-width="0.146"/>
  <polyline points="5,65 40,72 20,90 60,85 90,60" fill="none" stroke="navy" stroke-width="0.244"/>
  <polyline points="65,5 95,15 70,40 95,45" fill="none" stroke="green" stroke-width="0.44"/>
  <path d="M 10 50 L 30 45 L 50 70 L 80 66 Z" fill="none" stroke="purple" stroke-width="1.7"/>
  <line x1="70" y1="70" x2="95" y2="98" stroke="orange" stroke-width="3"/>
  <polygon points="60,80 75,75 90,95 65,97" fill="rgb(10, 200, 30)" stroke="blue"
    stroke-width="2.3"/>
</svg>""",
    "shapes.svg": """<svg xmlns="http://www.w3.org/2000/svg" width="240" height="160">
  <rect x="10" y="10" width="100" height="60" fill="hsl(200, 60%, 40%)"
    transform="rotate(17 60 40)"/>
  <g transform="translate(150,80) scale(1.3,0.8) rotate(-30)">
    <ellipse cx="0" cy="0" rx="40" ry="20" fill="#ffa" stroke="#333" stroke-width="2"/>
    <circle cx="20" cy="-10" r="12" fill="rgb(50%, 10%, 90%)" opacity="0.6"/>
  </g>
  <g transform="matrix(0.9,0.2,-0.3,1.1,20,90) skewX(12)">
    <rect width="60" height="40" fill="teal" fill-opacity="0.5" stroke="crimson"
      stroke-opacity="0.7" stroke-width="4"/>
  </g>
  <rect x="180" y="10" width="50" height="30"
    style="fill: hsv(30, 80%, 90%); stroke: DarkSlateGray; stroke-width: 1.5"/>
</svg>""",
    "curves.svg": """<svg xmlns="http://www.w3.org/2000/svg" viewBox="-10 -10 120 80">
  <defs><linearGradient id="g1"><stop offset="0" stop-color="gold"/>
  <stop offset="1" stop-color="red"/></linearGradient>
  <radialGradient id="g2"><stop offset="0" style="stop-color: #0a8"/></radialGradient></defs>
  <path d="M0 0 C 20 -10, 40 30, 60 10 S 90 -5, 100 20" fill="none" stroke="url(#g1)"
    stroke-width="2.5"/>
  <path d="m5 40 q 15 -20 30 0 t 30 0 t 30 0" fill="none" stroke="currentColor"
    stroke-width="1.2"/>
  <path d="M20 60 A 15 10 30 1 1 50 55 a 8 8 0 0 0 -10 -5 z" fill="url(#g2)" stroke="maroon"
    stroke-width="0.8"/>
  <path d="M70 45 h 20 v 15 h -20 Z M 75 50 h 10 v 5 h -10 z" fill="#8a2be2aa"/>
  <path d="M 60 20 l 10 10 l 10 -10 70 50" fill="#abcd" stroke="#f0f" stroke-width="0.5"/>
  <circle cx="95" cy="5" r="6" fill="notacolor" stroke="black"/>
  <rect x="0" y="50" width="10" height="10" fill="url(#missing)" stroke="rgba(1,2,3,4)"/>
</svg>""",
    "wide.svg": """<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 300 200">
  <path d="M 20 180 L 60 20 L 100 180 L 140 20 L 180 180" fill="none" stroke="#123456"
    stroke-width="9" stroke-opacity="0.9"/>
  <path d="M 200 30 Q 280 60 260 120 T 220 190" fill="none" stroke="tomato" stroke-width="5"/>
  <polyline points="190,20 295,25 200,60 290,80" stroke="black" stroke-width="0.3" fill="none"/>
</svg>""",
    "sized.svg": ('<?xml version="1.0"?>\n<!DOCTYPE svg PUBLIC "-//W3C//DTD SVG 1.1//EN" '
                  '"http://www.w3.org/Graphics/SVG/1.1/DTD/svg11.dtd">\n'
                  '<svg xmlns="http://www.w3.org/2000/svg" width="30px" height="400px">'
                  '<rect width="30" height="400" fill="Gray" stroke="grey" stroke-width="7"/>'
                  '<switch><a><circle cx="15" cy="200" r="10" fill="white"/></a></switch>'
                  '<text x="1" y="1">skipped</text></svg>'),
    "defaults.svg": ('<svg xmlns="http://www.w3.org/2000/svg">'
                     '<circle cx="150" cy="75" r="60"/><line x1="0" y1="0" x2="300" y2="150" '
                     'stroke="red"/></svg>'),
}


def _random_svg(seed: int) -> str:
    """A document of random shapes, paths, strokes, transforms, colours."""
    rng = np.random.default_rng(seed)
    colours = ["red", "SteelBlue", "#0f0", "#12ab9c", "rgb(200,20,120)", "rgb(10%,80%,30%)",
               "hsl(120,40%,60%)", "hsv(250,70%,80%)", "#ffcc0080", "none", "currentColor"]
    w, h = int(rng.integers(40, 200)), int(rng.integers(40, 200))
    out = [f'<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 {w} {h}">']

    def n(lo, hi):
        return f"{rng.uniform(lo, hi):.2f}"

    def paint():
        s = f'fill="{rng.choice(colours)}"'
        if rng.random() < 0.7:
            s += f' stroke="{rng.choice(colours)}" stroke-width="{n(0.02, 4)}"'
        if rng.random() < 0.3:
            s += f' opacity="{n(0.2, 1)}" fill-opacity="{n(0.3, 1)}"'
        return s

    for _ in range(int(rng.integers(4, 10))):
        kind = rng.integers(0, 6)
        tf = (f' transform="rotate({n(-90, 90)} {n(0, w)} {n(0, h)}) skewY({n(-20, 20)})"'
              if rng.random() < 0.4 else "")
        if kind == 0:
            out.append(f'<rect x="{n(0, w)}" y="{n(0, h)}" width="{n(1, w / 2)}" '
                       f'height="{n(1, h / 2)}" {paint()}{tf}/>')
        elif kind == 1:
            out.append(f'<circle cx="{n(0, w)}" cy="{n(0, h)}" r="{n(1, w / 3)}" {paint()}{tf}/>')
        elif kind == 2:
            out.append(f'<ellipse cx="{n(0, w)}" cy="{n(0, h)}" rx="{n(1, w / 3)}" '
                       f'ry="{n(1, h / 3)}" {paint()}{tf}/>')
        elif kind == 3:
            pts = " ".join(f"{n(0, w)},{n(0, h)}" for _ in range(int(rng.integers(2, 7))))
            tag = "polygon" if rng.random() < 0.5 else "polyline"
            out.append(f'<{tag} points="{pts}" {paint()}{tf}/>')
        else:
            d = [f"M {n(0, w)} {n(0, h)}"]
            for _ in range(int(rng.integers(2, 7))):
                c = rng.choice(list("LlHhVvCcSsQqTtAa"))
                k = {"L": 2, "H": 1, "V": 1, "C": 6, "S": 4, "Q": 4, "T": 2}.get(c.upper())
                if c.upper() == "A":
                    d.append(f"{c} {n(2, w / 2)} {n(2, h / 2)} {n(0, 90)} "
                             f"{rng.integers(0, 2)} {rng.integers(0, 2)} {n(0, w)} {n(0, h)}")
                else:
                    d.append(c + " " + " ".join(n(-w / 3, w) for _ in range(k)))
            if rng.random() < 0.5:
                d.append("Z")
            out.append(f'<g transform="translate({n(-5, 5)},{n(-5, 5)})"><path d="{" ".join(d)}" '
                       f'{paint()}{tf}/></g>')
    out.append("</svg>")
    return "\n".join(out)


def _jax_render(path: str):
    """The JAX render_svg's canvas (before its resize) and its result."""
    got = {}
    real = Image.Image.resize

    def spy(self, size, *a, **kw):
        if "canvas" not in got:  # the RGBA canvas; then PIL's own RGBa call
            got["canvas"], got["size"] = np.asarray(self).copy(), size
        return real(self, size, *a, **kw)

    Image.Image.resize = spy
    try:
        out = np.asarray(jax_svg.render_svg(path))
    finally:
        Image.Image.resize = real
    return got["canvas"], got["size"], out


def _write(tmp_path, name: str, text: str) -> str:
    path = str(tmp_path / name)
    if name.endswith(".svgz"):
        open(path, "wb").write(gzip.compress(text.encode()))
    else:
        open(path, "w").write(text)
    return path


def _held(path: str, plain: bool = False) -> np.ndarray:
    canvas, size, want = _jax_render(path)
    got_canvas, got_size = svg.rasterize(path)
    assert got_size == size
    assert got_canvas.shape == canvas.shape
    bad = np.argwhere((got_canvas != canvas).any(-1))
    assert len(bad) == 0, f"{len(bad)} canvas pixels differ, the first at {bad[:3].tolist()}"
    got = svg.render_svg(path)
    assert np.array_equal(got, want)
    if plain:  # the numpy resize of a 2048 x 2048 canvas takes seconds
        assert np.array_equal(svg.render_svg(path, native=False), want)
    return got


@pytest.mark.parametrize("name", sorted(DOCS) + ["shapes.svgz"])
def test_the_canvas_and_the_resize_equal_the_jax_render(tmp_path, name):
    text = DOCS[name.replace(".svgz", ".svg")]
    _held(_write(tmp_path, name, text), plain=name in ("jax_test.svg", "sized.svg"))


@pytest.mark.parametrize("seed", range(8))
def test_random_documents_render_alike(tmp_path, seed):
    _held(_write(tmp_path, f"r{seed}.svg", _random_svg(seed)))


@pytest.mark.parametrize("name,text", [
    ("entity.svg", '<!DOCTYPE svg [<!ENTITY a "x">]><svg xmlns="http://www.w3.org/2000/svg"/>'),
    ("subset.svg", '<!DOCTYPE svg [ ]><svg xmlns="http://www.w3.org/2000/svg"/>'),
    ("open.svg", '<!DOCTYPE svg <svg xmlns="http://www.w3.org/2000/svg"/>'),
    ("notsvg.svg", '<html xmlns="http://www.w3.org/1999/xhtml"/>'),
    ("empty.svg", '<svg xmlns="http://www.w3.org/2000/svg" viewBox="0 0 0 10"/>'),
    ("broken.svg", "<svg"),
])
def test_refusals_raise_what_the_jax_function_raises(tmp_path, name, text):
    path = _write(tmp_path, name, text)
    with pytest.raises(Exception) as want:
        jax_svg.render_svg(path)
    with pytest.raises(type(want.value)) as got:
        svg.render_svg(path)
    assert str(got.value) == str(want.value)
    # The thumbnail path degrades to no thumbnail in both.
    assert thumbnail.generate_thumbnail(path, str(tmp_path / "p"), "ab" * 8) is None
    assert jax_thumb.generate_thumbnail(path, str(tmp_path / "j"), "ab" * 8) is None


def _jax_grid(path: str, out_dir: str, monkeypatch):
    seen = []
    real = Image.Image.save

    def spy(self, fp, format=None, **kw):
        if format == "WEBP":
            seen.append(np.asarray(self.convert("RGB")).copy())
        return real(self, fp, format, **kw)

    monkeypatch.setattr(Image.Image, "save", spy)
    try:
        assert jax_thumb.generate_thumbnail(path, out_dir, "cd" * 8)
    finally:
        monkeypatch.setattr(Image.Image, "save", real)
    return seen[0]


def _port_grid(path: str, out_dir: str, monkeypatch):
    seen = []
    real = webpenc.encode

    def spy(rgb, **kw):
        seen.append(rgb.copy())
        return real(rgb, **kw)

    monkeypatch.setattr(webpenc, "encode", spy)
    try:
        assert thumbnail.generate_thumbnail(path, out_dir, "cd" * 8)
    finally:
        monkeypatch.setattr(webpenc, "encode", real)
    return seen[0]


@pytest.mark.parametrize("name", ["jax_test.svg", "shapes.svgz", "wide.svg", "sized.svg",
                                  "dct.pdf", "flate.pdf"])
def test_the_thumbnail_grid_equals_the_jax_grid(tmp_path, name, monkeypatch):
    if name.endswith(".pdf"):
        path = os.path.join(FIX, name)
    else:
        path = _write(tmp_path, name, DOCS[name.replace(".svgz", ".svg")])
    want = _jax_grid(path, str(tmp_path / "jax"), monkeypatch)
    got = _port_grid(path, str(tmp_path / "port"), monkeypatch)
    assert got.shape == want.shape and np.array_equal(got, want)


# -- PDF -----------------------------------------------------------------------


def _pdf(*objects: bytes) -> bytes:
    body = b"%PDF-1.4\n"
    for k, obj in enumerate(objects, 1):
        body += b"%d 0 obj\n" % k + obj + b"\nendobj\n"
    return body + b"trailer\n<< /Root 1 0 R >>\n%%EOF\n"


def _image(w, h, space: bytes, data: bytes, filt: bytes, parms: bytes = b"") -> bytes:
    return (b"<< /Type /XObject /Subtype /Image /Width %d /Height %d /ColorSpace %s "
            b"/BitsPerComponent 8 /Filter %s %s/Length %d >>\nstream\n" % (
                w, h, space, filt, parms, len(data)) + data + b"\nendstream")


def _png_rows(px: np.ndarray, filters) -> bytes:
    """PNG-predicted rows (filter byte + row), the encoder's side."""
    h, w = px.shape[:2]
    c = 1 if px.ndim == 2 else px.shape[2]
    rows = px.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        row = rows[y]
        left = np.concatenate([np.zeros(c, np.int64), row[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if f == 0:
            enc = row
        elif f == 1:
            enc = row - left
        elif f == 2:
            enc = row - prev
        elif f == 3:
            enc = row - (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - upleft)
            enc = row - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out += bytes([f]) + bytes((enc & 0xFF).astype(np.uint8))
        prev = row
    return bytes(out)


def _scene(h, w, c, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([(x * 7) % 256, (y * 5) % 256, (x * y) % 256], -1)[..., :c]
    out = (base + rng.integers(0, 30, base.shape)).clip(0, 255).astype(np.uint8)
    return out[..., 0] if c == 1 else out


def _jpeg(px, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px).save(buf, "JPEG", **kw)
    return buf.getvalue()


PDFS = {
    "flate_rgb.pdf": lambda: _pdf(_image(33, 21, b"/DeviceRGB", zlib.compress(
        _scene(21, 33, 3, 1).tobytes()), b"/FlateDecode")),
    "flate_gray_predicted.pdf": lambda: _pdf(_image(40, 17, b"/DeviceGray", zlib.compress(
        _png_rows(_scene(17, 40, 1, 2), [0, 1, 2, 3, 4])), b"/FlateDecode",
        b"/DecodeParms << /Predictor 15 /Colors 1 /Columns 40 >> ")),
    "flate_rgb_predicted.pdf": lambda: _pdf(_image(25, 30, b"/DeviceRGB", zlib.compress(
        _png_rows(_scene(30, 25, 3, 3), [4, 3, 2, 1, 0])), b"/FlateDecode",
        b"/DecodeParms << /Predictor 12 /Colors 3 /Columns 25 >> ")),
    "dct_largest.pdf": lambda: _pdf(
        _image(10, 10, b"/DeviceRGB", zlib.compress(bytes(300)), b"/FlateDecode"),
        _image(64, 40, b"/DeviceRGB", _jpeg(_scene(40, 64, 3, 4), quality=90), b"/DCTDecode")),
    "dct_gray.pdf": lambda: _pdf(_image(48, 32, b"/DeviceGray", _jpeg(_scene(32, 48, 1, 5)),
                                        b"/DCTDecode")),
    "bad_then_good.pdf": lambda: _pdf(
        _image(90, 90, b"/DeviceCMYK", zlib.compress(bytes(90 * 90 * 4)), b"/FlateDecode"),
        _image(80, 80, b"/DeviceRGB", zlib.compress(bytes(50)), b"/FlateDecode"),
        _image(70, 70, b"/DeviceRGB", b"garbage", b"/FlateDecode"),
        _image(60, 60, b"/DeviceRGB", zlib.compress(bytes(60 * 60 * 3)), b"/LZWDecode"),
        _image(20, 30, b"/DeviceRGB", zlib.compress(_scene(30, 20, 3, 6).tobytes()),
               b"/FlateDecode")),
    "none.pdf": lambda: _pdf(b"<< /Type /Catalog >>"),
    "not_a.pdf": lambda: b"%PS-Adobe\n",
}


@pytest.mark.parametrize("name", sorted(PDFS) + ["dct.pdf", "flate.pdf"])
def test_pdf_images_equal_the_jax_images(tmp_path, name):
    if name in PDFS:
        path = str(tmp_path / name)
        open(path, "wb").write(PDFS[name]())
    else:
        path = os.path.join(FIX, name)
    try:
        im = jax_pdf.pdf_first_image(path)
    except jax_pdf.PdfImageError as e:
        with pytest.raises(pdf.PdfImageError) as got:
            pdf.pdf_first_image(path)
        assert str(got.value) == str(e)
        with pytest.raises(images.UnsupportedFormat):
            images.format_image(path)
        return
    want = np.asarray(im)
    for native in (True, False):
        px, mode = pdf.pdf_first_image(path, native=native)
        assert mode == im.mode and np.array_equal(px, want)
    px, mode = images.format_image(path)
    assert mode == im.mode and np.array_equal(px, want)


def test_a_jpeg_the_port_refuses_moves_on_to_the_next_image(tmp_path):
    """A JPEG whose frame header claims arithmetic coding, which the
    port's decoder refuses (a decode gap; PIL decodes the Huffman data as
    noise): where PIL returns it, the port takes the next candidate, as
    the JAX function does with whatever PIL raises."""
    jpg = _jpeg(_scene(50, 50, 3, 8))
    at = jpg.index(b"\xff\xc0")
    arithmetic = jpg[:at] + b"\xff\xc9" + jpg[at + 2:]
    rgb = _scene(12, 16, 3, 7)
    path = str(tmp_path / "arith.pdf")
    open(path, "wb").write(_pdf(
        _image(50, 50, b"/DeviceRGB", arithmetic, b"/DCTDecode"),
        _image(16, 12, b"/DeviceRGB", zlib.compress(rgb.tobytes()), b"/FlateDecode")))
    assert jax_pdf.pdf_first_image(path).size == (50, 50)
    px, mode = pdf.pdf_first_image(path)
    assert mode == "RGB" and np.array_equal(px, rgb)


@pytest.mark.parametrize("progressive", [False, True])
def test_a_cmyk_dct_image_decodes_as_pil_reads_it(tmp_path, progressive):
    """A /DCTDecode image in CMYK: PIL reads it Adobe-inverted (``CMYK;I``),
    and so does the port's decoder."""
    cmyk = io.BytesIO()
    Image.fromarray(np.concatenate([_scene(40, 50, 3, 9), _scene(40, 50, 1, 10)[..., None]], -1),
                    "CMYK").save(cmyk, "JPEG", progressive=progressive)
    path = str(tmp_path / "cmyk.pdf")
    open(path, "wb").write(_pdf(_image(50, 40, b"/DeviceCMYK", cmyk.getvalue(),
                                       b"/DCTDecode")))
    im = jax_pdf.pdf_first_image(path)
    assert im.mode == "CMYK"
    for native in (True, False):
        px, mode = pdf.pdf_first_image(path, native=native)
        assert mode == "CMYK" and np.array_equal(px, np.asarray(im))


def test_png_unpredict_equals_the_jax_function():
    rng = np.random.default_rng(3)
    for colors, columns in ((1, 7), (3, 5), (4, 9)):
        raw = bytes(rng.integers(0, 256, (columns * colors + 1) * 6 - 3, dtype=np.uint8))
        raw = bytes([b % 5 if k % (columns * colors + 1) == 0 else b for k, b in enumerate(raw)])
        assert pdf._png_unpredict(raw, columns, colors) == jax_pdf._png_unpredict(
            raw, columns, colors)
    with pytest.raises(pdf.PdfImageError):
        pdf._png_unpredict(b"\x07" + bytes(3), 3, 1)


def test_pdf_and_svg_route_through_format_image(tmp_path):
    assert jax_images.SVG_TARGET_PX == images.SVG_TARGET_PX
    path = _write(tmp_path, "a.svg", JAX_TEST_SVG)
    px, mode = images.format_image(path)
    assert mode == "RGBA" and np.array_equal(px, np.asarray(jax_images.format_image(path)))


# -- the drawing primitives, one by one ----------------------------------------


def _pil(size, fn):
    im = Image.new("RGBA", size, (0, 0, 0, 0))
    fn(ImageDraw.Draw(im, "RGBA"))
    return np.asarray(im)


@pytest.mark.parametrize("seed", range(3))
def test_polygons_equal_pil(seed):
    rng = np.random.default_rng(100 + seed)
    ink = (200, 30, 40, 255)
    for t in range(150):
        n = int(rng.integers(3, 9))
        if t % 3 == 0:
            pts = [tuple(map(float, rng.integers(-5, 65, 2))) for _ in range(n)]
        else:
            pts = [(float(rng.uniform(-5, 65)), float(rng.uniform(-5, 55))) for _ in range(n)]
        canvas = np.zeros((50, 60, 4), np.uint8)
        draw.polygon(canvas, pts, np.array(ink, np.uint8))
        assert np.array_equal(canvas, _pil((60, 50), lambda d: d.polygon(pts, fill=ink))), pts


@pytest.mark.parametrize("width", [1, 2, 3, 5, 6, 9, 12, 20])
def test_jointed_lines_equal_pil(width):
    rng = np.random.default_rng(width)
    ink = (1, 2, 3, 255)
    for _ in range(60):
        pts = [(float(rng.uniform(-5, 65)), float(rng.uniform(-5, 55)))
               for _ in range(int(rng.integers(2, 6)))]
        canvas = np.zeros((50, 60, 4), np.uint8)
        draw.line(canvas, pts, np.array(ink, np.uint8), width=width, joint="curve")
        want = _pil((60, 50), lambda d: d.line(pts, fill=ink, width=width, joint="curve"))
        assert np.array_equal(canvas, want), pts


def test_ellipses_and_square_pies_equal_pil():
    rng = np.random.default_rng(11)
    ink = (9, 8, 7, 255)
    for _ in range(200):
        x0, y0, r = rng.uniform(-3, 40), rng.uniform(-3, 30), rng.uniform(0, 25)
        box = [(x0, y0), (x0 + r, y0 + r)]
        canvas = np.zeros((50, 60, 4), np.uint8)
        draw.pieslice(canvas, box, 0, 360, np.array(ink, np.uint8))
        assert np.array_equal(canvas, _pil((60, 50), lambda d: d.ellipse(box, fill=ink)))


def test_colours_and_the_rgba_resize_equal_pil():
    for c in ("red", "Gray", "DarkOliveGreen", "#abc", "#abcd", "#a1b2c3", "#a1b2c3d4",
              "rgb(1,2,3)", "rgb(10%, 20%,30%)", "hsl(120, 50%, 25%)", "hsv(300,20%,90%)",
              "hsb(3.5,2.5%,90%)", "rgba(1,2,3,4)"):
        assert draw.getrgb(c) == ImageColor.getrgb(c)
    for bad in ("nope", "#12", "rgb(1,2)", "x" * 101):
        with pytest.raises(ValueError):
            ImageColor.getrgb(bad)
        with pytest.raises(ValueError):
            draw.getrgb(bad)
    rng = np.random.default_rng(0)
    for (h, w), size in (((64, 80), (20, 16)), ((50, 40), (50, 13)), ((30, 30), (30, 30)),
                         ((37, 90), (91, 5))):
        px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        px[..., 3] = np.where(rng.random((h, w)) < 0.3, 0, px[..., 3])
        want = np.asarray(Image.fromarray(px, "RGBA").resize(size, Image.LANCZOS))
        assert np.array_equal(draw.resize_rgba(px, size), want)
        assert np.array_equal(draw.resize_rgba(px, size, native=False), want)


# Two cases the primitives once missed, now equal to PIL. Neither is reached
# by an SVG path, whose pie slices are the joints' square boxes under their
# own line and whose random documents above match.
GAPS = {
    # A polygon that passes through one vertex twice, so that four edges
    # meet on one row at one crossing: PIL joins a corner only with an
    # earlier edge.
    "polygon": (lambda d, ink: d.polygon([(45.0, 12.0), (59.0, 13.0), (45.0, 12.0), (9.0, 31.0)],
                                         fill=ink),
                lambda c, ink: draw.polygon(c, [(45.0, 12.0), (59.0, 13.0), (45.0, 12.0),
                                                (9.0, 31.0)], ink)),
    # A pie slice of a flat 24 x 4 box under 90 degrees: PIL's third
    # half-plane cuts into the slice.
    "pieslice": (lambda d, ink: d.pieslice([(13.95, 39.66), (37.04, 43.46)], 71.968, 156.972,
                                           fill=ink),
                 lambda c, ink: draw.pieslice(c, [(13.95, 39.66), (37.04, 43.46)], 71.968,
                                              156.972, ink)),
}


def _polygon_pair(pts, ink=(200, 30, 40, 255)):
    want = _pil((60, 50), lambda d: d.polygon(pts, fill=ink))
    canvas = np.zeros((50, 60, 4), np.uint8)
    draw.polygon(canvas, pts, np.array(ink, np.uint8))
    return canvas, want


def test_polygon_joins_a_corner_from_a_later_edge_as_pil_does():
    """Corners the port once joined wrongly: this self-intersecting
    polygon's at (57, 24) and a triangle's at its bottom vertex (56, 42).
    PIL joins a corner only with an earlier edge of the table."""
    for pts in ([(57.0, 24.0), (32.0, 28.0), (4.0, 47.0), (10.0, 55.0), (49.0, 22.0),
                 (49.0, 53.0), (2.0, 51.0)], [(56.0, 42.0), (14.0, 32.0), (15.0, 23.0)],
                [(17.0, 34.0), (35.0, 46.0), (11.0, 30.0)]):
        canvas, want = _polygon_pair(pts)
        assert np.array_equal(canvas, want), pts


@pytest.mark.parametrize("seed", range(4))
def test_polygon_equals_pil_on_random_self_intersecting_polygons(seed):
    """300 random polygons of 3 to 24 vertices (most of them
    self-intersecting), integer and fractional, some off the canvas, a
    third of them through one vertex more than once: equal to PIL pixel for
    pixel."""
    rng = np.random.default_rng(seed)
    for n in range(300):
        k = int(rng.integers(3, 25))
        pts = [(float(rng.integers(-5, 66)) + (0.5 if seed % 2 else 0.0),
                float(rng.integers(-5, 56))) for _ in range(k)]
        if n % 3 == 2:
            for _ in range(int(rng.integers(1, 4))):
                pts.insert(int(rng.integers(0, len(pts))), pts[int(rng.integers(0, len(pts)))])
        canvas, want = _polygon_pair(pts)
        assert np.array_equal(canvas, want), pts


@pytest.mark.parametrize("seed", range(4))
def test_pieslice_equals_pil_on_random_boxes_and_angles(seed):
    """250 random pie slices: flat, thin, degenerate and square boxes,
    fractional corners, some off the canvas, angles of either sign and any
    span: equal to PIL pixel for pixel."""
    rng = np.random.default_rng(seed)
    ink = (200, 30, 40, 255)
    for _ in range(250):
        x0, y0 = rng.uniform(-3, 50), rng.uniform(-3, 45)
        w, h = [(rng.uniform(0, 30), rng.uniform(0, 5)), (rng.uniform(0, 5), rng.uniform(0, 30)),
                (rng.uniform(0, 30), rng.uniform(0, 30))][int(rng.integers(3))]
        start = float(rng.uniform(-400, 400))
        end = start + float(rng.uniform(-30, 400)) if rng.random() < 0.9 \
            else float(rng.uniform(-400, 400))
        box = [(x0, y0), (x0 + w, y0 + h)]
        canvas = np.zeros((50, 60, 4), np.uint8)
        draw.pieslice(canvas, box, start, end, np.array(ink, np.uint8))
        want = _pil((60, 50), lambda d: d.pieslice(box, start, end, fill=ink))
        assert np.array_equal(canvas, want), (box, start, end)


@pytest.mark.parametrize("name", sorted(GAPS))
def test_the_known_gaps_of_the_primitives(name):
    pil_fn, port_fn = GAPS[name]
    ink = (200, 30, 40, 255)
    want = _pil((60, 50), lambda d: pil_fn(d, ink))
    canvas = np.zeros((50, 60, 4), np.uint8)
    port_fn(canvas, np.array(ink, np.uint8))
    assert np.array_equal(canvas, want)
