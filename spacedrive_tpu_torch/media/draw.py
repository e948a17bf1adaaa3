"""The raster primitives of PIL's ImageDraw that the SVG rasterizer uses,
on an RGBA numpy canvas, pixel for pixel.

The JAX package's ``media/svg.py`` draws with PIL: ``ImageColor.getrgb``,
``ImageDraw.Draw(img, "RGBA")`` on an RGBA image (the ink overwrites, it
does not blend) with ``polygon(xy, fill=...)`` and ``line(xy, fill=...,
width=w, joint="curve")``, and ``Image.resize(..., LANCZOS)`` of the RGBA
canvas. The machine with the card has no PIL, so the port draws itself:

- ``getrgb``: PIL's colour syntax (CSS names, hex, ``rgb()``, ``hsl()``,
  ``hsv()``), a copy of ImageColor's table and rules;
- ``polygon``: vertices rounded half away from zero, edges scanned row by
  row in float32 (Draw.c ``polygon_generic``, its horizontal edges, its
  doubled intersection at an edge's end row and its corner fix);
- ``line``: 1-pixel segments by Bresenham (``line32``, the last point
  drawn once), wider ones as a four-vertex polygon each
  (``ImagingDrawWideLine``), and for ``joint="curve"`` past width 4 a
  pie slice at each joint (the quarter-ellipse walk, its clip tree of two
  half-planes) and past width 8 the width-3 lines that cover the gaps;
- ``resize_rgba``: PIL resizes RGBA premultiplied — ``RGBa``
  (``MULDIV255``), LANCZOS on four bands, then back to ``RGBA`` — natively
  in ``csrc/imgdec.cpp`` (``native.resample_rgba``), plainly here.

Where PIL's C source was not at hand its rules were read off PIL itself,
input by input (tests/test_torch_svg_pdf.py holds each primitive to PIL on
random input). Two are known to miss on inputs the SVG path does not draw:
a self-intersecting polygon whose corner PIL fixes from a later edge
(about 1 in 1 400 random polygons, one pixel), and a pie slice of a
flat, non-square box (a few side pixels); the joints' slices are
near-square and lie under their own line.
"""

from __future__ import annotations

import math
import re
from colorsys import hls_to_rgb, hsv_to_rgb
from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

F32 = np.float32

# ImageColor.colormap: the CSS3 colour names.
COLORMAP = {
    "aliceblue": "#f0f8ff", "antiquewhite": "#faebd7", "aqua": "#00ffff", "aquamarine": "#7fffd4",
    "azure": "#f0ffff", "beige": "#f5f5dc", "bisque": "#ffe4c4", "black": "#000000",
    "blanchedalmond": "#ffebcd", "blue": "#0000ff", "blueviolet": "#8a2be2", "brown": "#a52a2a",
    "burlywood": "#deb887", "cadetblue": "#5f9ea0", "chartreuse": "#7fff00",
    "chocolate": "#d2691e", "coral": "#ff7f50", "cornflowerblue": "#6495ed",
    "cornsilk": "#fff8dc", "crimson": "#dc143c", "cyan": "#00ffff", "darkblue": "#00008b",
    "darkcyan": "#008b8b", "darkgoldenrod": "#b8860b", "darkgray": "#a9a9a9",
    "darkgrey": "#a9a9a9", "darkgreen": "#006400", "darkkhaki": "#bdb76b",
    "darkmagenta": "#8b008b", "darkolivegreen": "#556b2f", "darkorange": "#ff8c00",
    "darkorchid": "#9932cc", "darkred": "#8b0000", "darksalmon": "#e9967a",
    "darkseagreen": "#8fbc8f", "darkslateblue": "#483d8b", "darkslategray": "#2f4f4f",
    "darkslategrey": "#2f4f4f", "darkturquoise": "#00ced1", "darkviolet": "#9400d3",
    "deeppink": "#ff1493", "deepskyblue": "#00bfff", "dimgray": "#696969", "dimgrey": "#696969",
    "dodgerblue": "#1e90ff", "firebrick": "#b22222", "floralwhite": "#fffaf0",
    "forestgreen": "#228b22", "fuchsia": "#ff00ff", "gainsboro": "#dcdcdc",
    "ghostwhite": "#f8f8ff", "gold": "#ffd700", "goldenrod": "#daa520", "gray": "#808080",
    "grey": "#808080", "green": "#008000", "greenyellow": "#adff2f", "honeydew": "#f0fff0",
    "hotpink": "#ff69b4", "indianred": "#cd5c5c", "indigo": "#4b0082", "ivory": "#fffff0",
    "khaki": "#f0e68c", "lavender": "#e6e6fa", "lavenderblush": "#fff0f5", "lawngreen": "#7cfc00",
    "lemonchiffon": "#fffacd", "lightblue": "#add8e6", "lightcoral": "#f08080",
    "lightcyan": "#e0ffff", "lightgoldenrodyellow": "#fafad2", "lightgreen": "#90ee90",
    "lightgray": "#d3d3d3", "lightgrey": "#d3d3d3", "lightpink": "#ffb6c1",
    "lightsalmon": "#ffa07a", "lightseagreen": "#20b2aa", "lightskyblue": "#87cefa",
    "lightslategray": "#778899", "lightslategrey": "#778899", "lightsteelblue": "#b0c4de",
    "lightyellow": "#ffffe0", "lime": "#00ff00", "limegreen": "#32cd32", "linen": "#faf0e6",
    "magenta": "#ff00ff", "maroon": "#800000", "mediumaquamarine": "#66cdaa",
    "mediumblue": "#0000cd", "mediumorchid": "#ba55d3", "mediumpurple": "#9370db",
    "mediumseagreen": "#3cb371", "mediumslateblue": "#7b68ee", "mediumspringgreen": "#00fa9a",
    "mediumturquoise": "#48d1cc", "mediumvioletred": "#c71585", "midnightblue": "#191970",
    "mintcream": "#f5fffa", "mistyrose": "#ffe4e1", "moccasin": "#ffe4b5",
    "navajowhite": "#ffdead", "navy": "#000080", "oldlace": "#fdf5e6", "olive": "#808000",
    "olivedrab": "#6b8e23", "orange": "#ffa500", "orangered": "#ff4500", "orchid": "#da70d6",
    "palegoldenrod": "#eee8aa", "palegreen": "#98fb98", "paleturquoise": "#afeeee",
    "palevioletred": "#db7093", "papayawhip": "#ffefd5", "peachpuff": "#ffdab9",
    "peru": "#cd853f", "pink": "#ffc0cb", "plum": "#dda0dd", "powderblue": "#b0e0e6",
    "purple": "#800080", "rebeccapurple": "#663399", "red": "#ff0000", "rosybrown": "#bc8f8f",
    "royalblue": "#4169e1", "saddlebrown": "#8b4513", "salmon": "#fa8072",
    "sandybrown": "#f4a460", "seagreen": "#2e8b57", "seashell": "#fff5ee", "sienna": "#a0522d",
    "silver": "#c0c0c0", "skyblue": "#87ceeb", "slateblue": "#6a5acd", "slategray": "#708090",
    "slategrey": "#708090", "snow": "#fffafa", "springgreen": "#00ff7f", "steelblue": "#4682b4",
    "tan": "#d2b48c", "teal": "#008080", "thistle": "#d8bfd8", "tomato": "#ff6347",
    "turquoise": "#40e0d0", "violet": "#ee82ee", "wheat": "#f5deb3", "white": "#ffffff",
    "whitesmoke": "#f5f5f5", "yellow": "#ffff00", "yellowgreen": "#9acd32",
}


@lru_cache(maxsize=128)
def getrgb(color: str) -> tuple:
    """PIL's ``ImageColor.getrgb``: a colour string → (r, g, b) or (r, g, b,
    a); ValueError where PIL raises one."""
    if len(color) > 100:
        raise ValueError("color specifier is too long")
    color = color.lower()
    named = COLORMAP.get(color)
    if named:
        return getrgb(named)
    if re.match("#[a-f0-9]{3}$", color):
        return int(color[1] * 2, 16), int(color[2] * 2, 16), int(color[3] * 2, 16)
    if re.match("#[a-f0-9]{4}$", color):
        return tuple(int(color[k] * 2, 16) for k in range(1, 5))
    if re.match("#[a-f0-9]{6}$", color):
        return int(color[1:3], 16), int(color[3:5], 16), int(color[5:7], 16)
    if re.match("#[a-f0-9]{8}$", color):
        return tuple(int(color[k:k + 2], 16) for k in range(1, 9, 2))
    m = re.match(r"rgb\(\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\)$", color)
    if m:
        return int(m.group(1)), int(m.group(2)), int(m.group(3))
    m = re.match(r"rgb\(\s*(\d+)%\s*,\s*(\d+)%\s*,\s*(\d+)%\s*\)$", color)
    if m:
        return tuple(int((int(m.group(k)) * 255) / 100.0 + 0.5) for k in (1, 2, 3))
    m = re.match(r"hsl\(\s*(\d+\.?\d*)\s*,\s*(\d+\.?\d*)%\s*,\s*(\d+\.?\d*)%\s*\)$", color)
    if m:
        rgb = hls_to_rgb(float(m.group(1)) / 360.0, float(m.group(3)) / 100.0,
                         float(m.group(2)) / 100.0)
        return tuple(int(v * 255 + 0.5) for v in rgb)
    m = re.match(r"hs[bv]\(\s*(\d+\.?\d*)\s*,\s*(\d+\.?\d*)%\s*,\s*(\d+\.?\d*)%\s*\)$",
                 color)
    if m:
        rgb = hsv_to_rgb(float(m.group(1)) / 360.0, float(m.group(2)) / 100.0,
                         float(m.group(3)) / 100.0)
        return tuple(int(v * 255 + 0.5) for v in rgb)
    m = re.match(r"rgba\(\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\)$", color)
    if m:
        return tuple(int(m.group(k)) for k in (1, 2, 3, 4))
    raise ValueError(f"unknown color specifier: {color!r}")


# -- Draw.c, on an [h, w, 4] uint8 canvas with a 4-byte ink -------------------


def _round_up_f(f: np.float32) -> int:
    """Draw.c ROUND_UP of a float: floor(f + 0.5F) in float arithmetic."""
    if f >= 0:
        return int(math.floor(F32(f) + F32(0.5)))
    return -int(math.floor(abs(float(f)) + 0.5))


def _round_down_f(f: np.float32) -> int:
    """Draw.c ROUND_DOWN of a float: ceil(f - 0.5F)."""
    if f >= 0:
        return int(math.ceil(F32(f) - F32(0.5)))
    return -int(math.ceil(abs(float(f)) - 0.5))


def _round_up_d(f: float) -> int:
    """ROUND_UP of a double."""
    return int(math.floor(f + 0.5)) if f >= 0 else -int(math.floor(abs(f) + 0.5))


def _round_down_d(f: float) -> int:
    """ROUND_DOWN of a double."""
    return int(math.ceil(f - 0.5)) if f >= 0 else -int(math.ceil(abs(f) - 0.5))


def _roundf(f: np.float32) -> np.float32:
    """C roundf: half away from zero."""
    return F32(math.floor(abs(float(f)) + 0.5) * (1 if f >= 0 else -1)) \
        if abs(float(f)) < 2 ** 23 else f


def hline(canvas: np.ndarray, x0: int, y: int, x1: int, ink) -> None:
    """hline32: pixels x0..x1 of row y, clipped to the canvas."""
    h, w = canvas.shape[:2]
    if 0 <= y < h:
        if x0 < 0:
            x0 = 0
        elif x0 >= w:
            return
        if x1 < 0:
            return
        if x1 >= w:
            x1 = w - 1
        if x0 <= x1:
            canvas[y, x0:x1 + 1] = ink


def point(canvas: np.ndarray, x: int, y: int, ink) -> None:
    h, w = canvas.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        canvas[y, x] = ink


class _Edge:
    __slots__ = ("x0", "y0", "xmin", "ymin", "xmax", "ymax", "dx")

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        """add_edge."""
        self.xmin, self.xmax = (x0, x1) if x0 <= x1 else (x1, x0)
        self.ymin, self.ymax = (y0, y1) if y0 <= y1 else (y1, y0)
        self.dx = F32(0.0) if y0 == y1 else F32(F32(x1 - x0) / F32(y1 - y0))
        self.x0, self.y0 = x0, y0

    def at(self, y: int) -> np.float32:
        return F32(F32(y - self.y0) * self.dx) + F32(self.x0)


def _fill_edges(canvas: np.ndarray, edges: List[_Edge], ink) -> None:
    """polygon_generic (no alpha, no even-odd): each row's crossings of the
    edges, sorted, filled pair by pair from ROUND_UP to ROUND_DOWN."""
    height = canvas.shape[0]
    ymin, ymax = height - 1, 0
    table = []
    for e in edges:
        ymin = min(ymin, e.ymin)
        ymax = max(ymax, e.ymax)
        if e.ymin == e.ymax:
            hline(canvas, e.xmin, e.ymin, e.xmax, ink)
            continue
        table.append(e)
    ymin = max(ymin, 0)
    ymax = min(ymax, height)
    for y in range(ymin, ymax + 1):
        xx = []
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            x = cur.at(y)
            xx.append(x)
            if y == cur.ymax and y < ymax:
                # Needed to draw consistent polygons
                xx.append(x)
            elif cur.dx != 0 and y in (cur.ymin, cur.ymax):
                _corner(table, i, y, xx)
        xx.sort()
        for i in range(1, len(xx), 2):
            hline(canvas, _round_up_f(xx[i - 1]), y, _round_down_f(xx[i]), ink)


def _corner(table, i: int, y: int, xx: list) -> None:
    """Connect discontiguous corners: edge i starts on this row (or ends on
    the last one). The first earlier edge that starts or ends on this row
    too and crosses it at the same rounded x makes a corner with it, if it
    goes on to the next row (the previous row where edge i ends). Then the
    crossing moves next to where the two edges cross that row, if it lies
    more than a pixel past both."""
    cur = table[i]
    offset = -1 if y == cur.ymax else 1
    x = xx[-1]
    for other in table[:i]:
        if (y != other.ymin and y != other.ymax) or other.dx == 0:
            continue
        if _roundf(x) != _roundf(other.at(y)):
            continue
        if not other.ymin <= y + offset <= other.ymax:
            continue
        a, b = cur.at(y + offset), other.at(y + offset)
        if x > a + 1 and x > b + 1:
            xx[-1] = _roundf(max(a, b)) + 1
        elif x < a - 1 and x < b - 1:
            xx[-1] = _roundf(min(a, b)) - 1
        return


def polygon(canvas: np.ndarray, xy: Sequence[Tuple[float, float]], ink) -> None:
    """``ImageDraw.polygon(xy, fill=ink)``: vertices truncated to ints, the
    closing edge added where the ring is open, a run of horizontal edges in
    one direction merged (ImagingDrawPolygon)."""
    pts = [(int(x), int(y)) for x, y in xy]
    edges: List[_Edge] = []
    n = len(pts)
    for i in range(n - 1):
        (x0, y0), (x1, y1) = pts[i], pts[i + 1]
        if y0 == y1 and i != 0 and y0 == pts[i - 1][1]:
            last = edges[-1]
            if x1 > x0 > pts[i - 1][0]:
                last.xmax = x1
                continue
            if x1 < x0 < pts[i - 1][0]:
                last.xmin = x1
                continue
        edges.append(_Edge(x0, y0, x1, y1))
    if pts[-1] != pts[0]:
        edges.append(_Edge(*pts[-1], *pts[0]))
    _fill_edges(canvas, edges, ink)


def line1(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int, ink) -> None:
    """line32: Bresenham from (x0, y0) up to, not including, (x1, y1)."""
    dx, xs = (x1 - x0, 1) if x1 >= x0 else (x0 - x1, -1)
    dy, ys = (y1 - y0, 1) if y1 >= y0 else (y0 - y1, -1)
    if dx == 0:
        for _ in range(dy):
            point(canvas, x0, y0, ink)
            y0 += ys
    elif dy == 0:
        for _ in range(dx):
            point(canvas, x0, y0, ink)
            x0 += xs
    elif dx > dy:
        n, dy2, dx2 = dx, dy + dy, dx + dx
        e = dy2 - dx
        for _ in range(n):
            point(canvas, x0, y0, ink)
            if e >= 0:
                y0 += ys
                e -= dx2
            e += dy2
            x0 += xs
    else:
        n, dx2, dy2 = dy, dx + dx, dy + dy
        e = dx2 - dy
        for _ in range(n):
            point(canvas, x0, y0, ink)
            if e >= 0:
                x0 += xs
                e -= dy2
            e += dx2
            y0 += ys


def wide_line(canvas: np.ndarray, x0: int, y0: int, x1: int, y1: int, ink, width: int) -> None:
    """ImagingDrawWideLine: the segment as a four-vertex polygon, offset by
    ROUND_UP and ROUND_DOWN of (width - 1) / 2 along its normal."""
    dx, dy = x1 - x0, y1 - y0
    if dx == 0 and dy == 0:
        point(canvas, x0, y0, ink)
        return
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    ratio_max = _round_up_d(small) / big
    ratio_min = _round_down_d(small) / big
    dxmin, dxmax = _round_down_d(ratio_min * dy), _round_down_d(ratio_max * dy)
    dymin, dymax = _round_down_d(ratio_min * dx), _round_down_d(ratio_max * dx)
    v = [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax),
         (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)]
    _fill_edges(canvas, [_Edge(*v[k], *v[(k + 1) % 4]) for k in range(4)], ink)


def _draw_lines(canvas: np.ndarray, pts, ink, width: int) -> None:
    """draw_lines: coordinates truncated to ints; 1-pixel segments and the
    last point, or wide segments."""
    ipts = [(int(x), int(y)) for x, y in pts]
    if width <= 1:
        for (x0, y0), (x1, y1) in zip(ipts, ipts[1:]):
            line1(canvas, x0, y0, x1, y1, ink)
        if len(ipts) > 1:
            point(canvas, *ipts[-1], ink)
    else:
        for (x0, y0), (x1, y1) in zip(ipts, ipts[1:]):
            wide_line(canvas, x0, y0, x1, y1, ink, width)


def line(canvas: np.ndarray, xy: Sequence[Tuple[float, float]], ink, width: int = 0,
         joint: str = None) -> None:
    """``ImageDraw.line(xy, fill=ink, width=width, joint=joint)``."""
    pts = [(x, y) for x, y in xy]
    _draw_lines(canvas, pts, ink, width)
    if joint != "curve" or width <= 4:
        return
    for i in range(1, len(pts) - 1):
        pt = pts[i]
        angles = [math.degrees(math.atan2(end[0] - start[0], start[1] - end[1])) % 360
                  for start, end in ((pts[i - 1], pt), (pt, pts[i + 1]))]
        if angles[0] == angles[1]:
            continue  # a straight line: no joint

        def coord_at_angle(coord, angle):
            x, y = coord
            angle -= 90
            distance = width / 2 - 1
            return tuple(p + (math.floor(p_d) if p_d > 0 else math.ceil(p_d))
                         for p, p_d in ((x, distance * math.cos(math.radians(angle))),
                                        (y, distance * math.sin(math.radians(angle)))))

        flipped = ((angles[1] > angles[0] and angles[1] - 180 > angles[0])
                   or (angles[1] < angles[0] and angles[1] + 180 > angles[0]))
        coords = [(pt[0] - width / 2 + 1, pt[1] - width / 2 + 1),
                  (pt[0] + width / 2 - 1, pt[1] + width / 2 - 1)]
        if flipped:
            start, end = angles[1] + 90, angles[0] + 90
        else:
            start, end = angles[0] - 90, angles[1] - 90
        pieslice(canvas, coords, start - 90, end - 90, ink)
        if width > 8:
            # Cover potential gaps between the line and the joint
            sign = 1 if flipped else -1
            gap = [coord_at_angle(pt, angles[0] + sign * 90), pt,
                   coord_at_angle(pt, angles[1] + sign * 90)]
            line(canvas, gap, ink, width=3)


# -- the Pillow 8+ ellipse: quarter walks, spans, a clip tree ----------------


class _Quarter:
    """quarter_state: one quarter of an ellipse in doubled coordinates
    (centre 0, 0; a pixel two units), walked from (a, b % 2) to (a % 2, b)."""

    def __init__(self, a: int, b: int):
        self.finished = a < 0 or b < 0
        if not self.finished:
            self.cx, self.cy, self.ex, self.ey = a, b % 2, a % 2, b
            self.a2, self.b2 = a * a, b * b
            self.a2b2 = self.a2 * self.b2

    def _delta(self, x: int, y: int) -> int:
        return abs(self.a2 * y * y + self.b2 * x * x - self.a2b2)

    def next(self):
        if self.finished:
            return None
        out = (self.cx, self.cy)
        if self.cx == self.ex and self.cy == self.ey:
            self.finished = True
        else:
            nx, ny = self.cx, self.cy + 2
            nd = self._delta(nx, ny)
            if nx > 1:
                d = self._delta(self.cx - 2, self.cy + 2)
                if nd > d:
                    nx, ny, nd = self.cx - 2, self.cy + 2, d
                d = self._delta(self.cx - 2, self.cy)
                if nd > d:
                    nx, ny = self.cx - 2, self.cy
            self.cx, self.cy = nx, ny
        return out


def _ellipse_spans(a: int, b: int, w: int):
    """ellipse_init + ellipse_next: the (x0, y, x1) spans, in doubled
    coordinates, of the ring between the outer quarter and the inner one
    2(w - 1) in (the whole ellipse where w covers it)."""
    leftmost = a % 2
    outer = _Quarter(a, b)
    first = outer.next()
    if w < 1 or first is None:
        return
    pr, py = first
    inner = _Quarter(a - 2 * (w - 1), b - 2 * (w - 1))
    pl = leftmost
    finished = False
    while not finished:
        y, l, r = py, pl, pr
        while True:
            nxt = outer.next()
            if nxt is None or nxt[1] > y:
                break
        if nxt is None:
            finished = True
        else:
            pr, py = nxt
        while True:
            nxt = inner.next()
            if nxt is None or nxt[1] > y:
                break
            l = nxt[0]
        pl = leftmost if nxt is None else nxt[0]
        buf = []
        if (l > 0 or l < r) and y > 0:
            buf.append((2 if l == 0 else l, y, r))
        if y > 0:
            buf.append((-r, y, -l))
        if l > 0 or l < r:
            buf.append((2 if l == 0 else l, -y, r))
        buf.append((-r, -y, -l))
        yield from reversed(buf)


def _clip(node, x0: int, y: int, x1: int) -> list:
    """clip_tree_do_clip: the ordered [(x, +1 | -1)] ends of the parts of
    the span (x0, y, x1) the tree keeps."""
    if node is None:
        return [(x0, 1), (x1, -1)]
    if node[0] == "clip":
        _, A, B, C = node
        eps = 1e-9
        if abs(A) < eps:
            if B * y + C < -eps:
                x0, x1 = 1, 0
        else:
            ix = -(B * y + C) / A
            if A * x0 + B * y + C < eps:
                x0 = _lround(max(x0, ix))
            if A * x1 + B * y + C < eps:
                x1 = _lround(min(x1, ix))
        return [(x0, 1), (x1, -1)] if x0 <= x1 else []
    kind, left, right = node
    l1, l2 = _clip(left, x0, y, x1), _clip(right, x0, y, x1)
    out = []
    k1 = k2 = 0
    i1 = i2 = 0
    while i1 < len(l1) or i2 < len(l2):
        if i2 == len(l2) or (i1 < len(l1) and (l1[i1][0] < l2[i2][0] or (
                l1[i1][0] == l2[i2][0] and l1[i1][1] > l2[i2][1]))):
            t = l1[i1]
            k1 += t[1]
            i1 += 1
        else:
            t = l2[i2]
            k2 += t[1]
            i2 += 1
        tail = out[-1] if out else None
        if kind == "or":
            keep = ((t[1] == 1 and (tail is None or tail[1] == -1))
                    or (t[1] == -1 and k1 == 0 and k2 == 0))
        else:
            keep = ((t[1] == 1 and (tail is None or tail[1] == -1) and k1 > 0 and k2 > 0)
                    or (t[1] == -1 and tail is not None and tail[1] == 1
                        and (k1 == 0 or k2 == 0)))
        if keep:
            out.append(t)
    return out


def _lround(v: float) -> int:
    return int(math.floor(abs(v) + 0.5)) * (1 if v >= 0 else -1)


def _normalize_angles(al: np.float32, ar: np.float32):
    """normalize_angles, in float: 0 <= al < 360, al <= ar <= al + 360."""
    if ar - al >= 360:
        return F32(0), F32(360)
    al = F32(math.fmod(360 - math.fmod(-float(al), 360) if al < 0 else float(al), 360))
    d = (360 - math.fmod(float(al) - float(ar), 360) if ar < al
         else math.fmod(float(ar) - float(al), 360))
    return al, F32(al + F32(d))


def pieslice(canvas: np.ndarray, xy, start: float, end: float, ink) -> None:
    """``ImageDraw.pieslice(xy, start, end, fill=ink)``: the box truncated
    to ints, the angles as C floats, the filled ellipse's spans clipped by
    the two sides' half-planes (pie_init: their intersection under 180°,
    else their union; under 90° also the half-plane facing the sum of the
    sides' two points on the ellipse)."""
    (fx0, fy0), (fx1, fy1) = xy
    if fx1 < fx0 or fy1 < fy0:
        raise ValueError("x1 must be greater than or equal to x0")
    x0, y0, x1, y1 = int(fx0), int(fy0), int(fx1), int(fy1)
    al, ar = _normalize_angles(F32(start), F32(end))
    a, b = x1 - x0, y1 - y0
    if a < 0 or b < 0:
        return
    if al + 360 == ar:
        spans = ((s, None) for s in _ellipse_spans(a, b, a + b))
        tree = None
    elif al == ar:
        return
    else:
        rad = lambda v: float(v) * math.pi / 180.0
        xl, yl = a * math.cos(rad(al)), b * math.sin(rad(al))
        xr, yr = a * math.cos(rad(ar)), b * math.sin(rad(ar))
        tree = ("and" if ar - al < 180 else "or", ("clip", -yl, xl, 0.0), ("clip", yr, -xr, 0.0))
        if ar - al < 90:
            # and the half-plane on the side of the sum of the two points
            tree = ("and", tree, ("clip", (xl + xr) * 0.5, (yl + yr) * 0.5, 0.0))
        spans = ((s, tree) for s in _ellipse_spans(a, b, a + b))
    for (sx0, sy, sx1), node in spans:
        ends = _clip(node, sx0, sy, sx1) if node is not None else [(sx0, 1), (sx1, -1)]
        for k in range(0, len(ends) - 1, 2):
            hline(canvas, x0 + (ends[k][0] + a) // 2, y0 + (sy + b) // 2,
                  x0 + (ends[k + 1][0] + a) // 2, ink)


# -- Image.resize(size, LANCZOS) of an RGBA image -----------------------------


def premultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's RGBA → RGBa (Convert.c rgbA2rgba): each colour MULDIV255 by
    alpha."""
    a = rgba[..., 3:4].astype(np.uint32)
    t = rgba[..., :3].astype(np.uint32) * a + 128
    out = rgba.copy()
    out[..., :3] = ((t >> 8) + t) >> 8
    return out


def unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """PIL's RGBa → RGBA (Convert.c rgba2rgbA): 255·c / alpha, truncated and
    clipped, where alpha is neither 0 nor 255."""
    a = rgba[..., 3:4].astype(np.int64)
    c = rgba[..., :3].astype(np.int64)
    scaled = np.minimum((255 * c) // np.maximum(a, 1), 255)
    out = rgba.copy()
    out[..., :3] = np.where((a == 0) | (a == 255), c, scaled)
    return out


def resize_rgba(rgba: np.ndarray, size: Tuple[int, int], *, native: bool = True) -> np.ndarray:
    """``Image.resize(size, LANCZOS)`` of an [h, w, 4] RGBA image: to RGBa,
    LANCZOS on the four bands, back to RGBA. `native` runs it in one call
    of ``csrc/imgdec.cpp``."""
    if native:
        from .. import native as plane
        return plane.resample_rgba(rgba, size)
    from .imgdecode import resize_image

    out = rgba if size == rgba.shape[1::-1] else resize_image(premultiply(rgba), size)
    return out if out is rgba else unpremultiply(out)
