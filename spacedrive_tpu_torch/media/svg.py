"""Pure-Python SVG rasterizer — the sd-images SVG handler, self-hosted.

Port of ``spacedrive_tpu/media/svg.py``: the same parser, styles,
transforms and path flattening, drawn on an RGBA numpy canvas by the
port's copy of the PIL primitives the JAX function calls
(``media/draw.py``), so the canvas and the resized RGBA equal the JAX
``render_svg``'s. The subset:

- structure: <svg> width/height/viewBox, nested <g>, <defs> ignored,
  `svgz` (gzip) streams;
- shapes: rect, circle, ellipse, line, polyline, polygon, path with
  M/m L/l H/h V/v C/c S/s Q/q T/t A/a Z/z (curves and arcs flattened to
  polylines);
- paint: fill/stroke presentation attributes + inline `style=`, any CSS
  colour PIL's ImageColor parses (named/hex/rgb()/hsl()/hsv()),
  fill-opacity/stroke-opacity/opacity, stroke-width, `none`;
  url(#gradient) references degrade to the gradient's first stop color;
- transforms: translate/scale/rotate/matrix/skewX/skewY, composed down the
  tree and applied to flattened geometry.

Rendering is 4× supersampled then LANCZOS-downsampled (premultiplied, as
PIL resizes RGBA). Out of scope (rendered as their fallback or skipped):
text, filters, masks, clip paths, real gradients, CSS stylesheets.
"""

from __future__ import annotations

import gzip
import math
import re
import xml.etree.ElementTree as ET
from typing import List, Optional, Tuple

import numpy as np

from . import draw

SS = 4  # supersampling factor
# Decompressed .svgz ceiling — same budget as images.MAXIMUM_FILE_SIZE.
_MAX_DECOMPRESSED = 192 * (1 << 20)

_FLOAT = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"
_NUM_RE = re.compile(_FLOAT)
_PATH_RE = re.compile(rf"([MmLlHhVvCcSsQqTtAaZz])|({_FLOAT})")


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _floats(s: str) -> List[float]:
    return [float(m) for m in _NUM_RE.findall(s or "")]


def _parse_length(s, default: float = 0.0) -> float:
    if s is None:
        return default
    m = _NUM_RE.search(str(s))
    return float(m.group(0)) if m else default


Matrix = Tuple[float, float, float, float, float, float]  # a b c d e f
_IDENTITY: Matrix = (1, 0, 0, 1, 0, 0)


def _mat_mul(m1: Matrix, m2: Matrix) -> Matrix:
    a1, b1, c1, d1, e1, f1 = m1
    a2, b2, c2, d2, e2, f2 = m2
    return (a1 * a2 + c1 * b2, b1 * a2 + d1 * b2,
            a1 * c2 + c1 * d2, b1 * c2 + d1 * d2,
            a1 * e2 + c1 * f2 + e1, b1 * e2 + d1 * f2 + f1)


def _mat_apply(m: Matrix, x: float, y: float) -> Tuple[float, float]:
    a, b, c, d, e, f = m
    return a * x + c * y + e, b * x + d * y + f


def _parse_transform(s: str) -> Matrix:
    m = _IDENTITY
    for name, args in re.findall(r"(\w+)\s*\(([^)]*)\)", s or ""):
        v = _floats(args)
        if name == "translate":
            t = (1, 0, 0, 1, v[0], v[1] if len(v) > 1 else 0)
        elif name == "scale":
            t = (v[0], 0, 0, v[1] if len(v) > 1 else v[0], 0, 0)
        elif name == "rotate":
            th = math.radians(v[0])
            cos, sin = math.cos(th), math.sin(th)
            t = (cos, sin, -sin, cos, 0, 0)
            if len(v) == 3:
                cx, cy = v[1], v[2]
                t = _mat_mul(_mat_mul((1, 0, 0, 1, cx, cy), t),
                             (1, 0, 0, 1, -cx, -cy))
        elif name == "matrix" and len(v) == 6:
            t = tuple(v)  # type: ignore[assignment]
        elif name == "skewX":
            t = (1, 0, math.tan(math.radians(v[0])), 1, 0, 0)
        elif name == "skewY":
            t = (1, math.tan(math.radians(v[0])), 0, 1, 0, 0)
        else:
            continue
        m = _mat_mul(m, t)
    return m


class _Style:
    __slots__ = ("fill", "stroke", "stroke_width", "opacity",
                 "fill_opacity", "stroke_opacity")

    def __init__(self):
        self.fill: Optional[str] = "black"   # SVG initial value
        self.stroke: Optional[str] = None
        self.stroke_width = 1.0
        self.opacity = 1.0
        self.fill_opacity = 1.0
        self.stroke_opacity = 1.0

    def child(self, el, gradients) -> "_Style":
        s = _Style()
        s.fill, s.stroke = self.fill, self.stroke
        s.stroke_width = self.stroke_width
        s.opacity, s.fill_opacity = self.opacity, self.fill_opacity
        s.stroke_opacity = self.stroke_opacity
        props = dict(el.attrib)
        for decl in (el.get("style") or "").split(";"):
            if ":" in decl:
                k, v = decl.split(":", 1)
                props[k.strip()] = v.strip()
        if "fill" in props:
            s.fill = _resolve_paint(props["fill"], gradients)
        if "stroke" in props:
            s.stroke = _resolve_paint(props["stroke"], gradients)
        if "stroke-width" in props:
            s.stroke_width = _parse_length(props["stroke-width"], 1.0)
        if "opacity" in props:
            s.opacity *= _parse_length(props["opacity"], 1.0)
        if "fill-opacity" in props:
            s.fill_opacity = _parse_length(props["fill-opacity"], 1.0)
        if "stroke-opacity" in props:
            s.stroke_opacity = _parse_length(props["stroke-opacity"], 1.0)
        return s


def _resolve_paint(value: str, gradients) -> Optional[str]:
    value = (value or "").strip()
    if value in ("none", ""):
        return None
    m = re.match(r"url\(#([^)]+)\)", value)
    if m:
        # Gradients degrade to their first stop color.
        return gradients.get(m.group(1), "gray")
    if value == "currentColor":
        return "black"
    return value


def _color(value: Optional[str], opacity: float):
    if value is None or opacity <= 0:
        return None
    try:
        rgb = draw.getrgb(value)
    except ValueError:
        return None
    a = int(round(255 * max(0.0, min(1.0, opacity))))
    return (rgb[0], rgb[1], rgb[2],
            a if len(rgb) < 4 else int(rgb[3] * opacity))


def _flatten_cubic(p0, p1, p2, p3, steps: int = 16):
    pts = []
    for k in range(1, steps + 1):
        t = k / steps
        u = 1 - t
        x = (u**3 * p0[0] + 3 * u * u * t * p1[0]
             + 3 * u * t * t * p2[0] + t**3 * p3[0])
        y = (u**3 * p0[1] + 3 * u * u * t * p1[1]
             + 3 * u * t * t * p2[1] + t**3 * p3[1])
        pts.append((x, y))
    return pts


def _flatten_quad(p0, p1, p2, steps: int = 12):
    pts = []
    for k in range(1, steps + 1):
        t = k / steps
        u = 1 - t
        x = u * u * p0[0] + 2 * u * t * p1[0] + t * t * p2[0]
        y = u * u * p0[1] + 2 * u * t * p1[1] + t * t * p2[1]
        pts.append((x, y))
    return pts


def _flatten_arc(p0, rx, ry, rot, large, sweep, p1, steps: int = 24):
    """Endpoint-parameterized elliptical arc → polyline (F.6.5)."""
    if rx == 0 or ry == 0 or p0 == p1:
        return [p1]
    rx, ry = abs(rx), abs(ry)
    phi = math.radians(rot)
    cp, sp = math.cos(phi), math.sin(phi)
    dx, dy = (p0[0] - p1[0]) / 2, (p0[1] - p1[1]) / 2
    x1 = cp * dx + sp * dy
    y1 = -sp * dx + cp * dy
    lam = (x1 / rx) ** 2 + (y1 / ry) ** 2
    if lam > 1:
        s = math.sqrt(lam)
        rx, ry = rx * s, ry * s
    num = rx**2 * ry**2 - rx**2 * y1**2 - ry**2 * x1**2
    den = rx**2 * y1**2 + ry**2 * x1**2
    co = math.sqrt(max(0.0, num / den)) if den else 0.0
    if large == sweep:
        co = -co
    cxp = co * rx * y1 / ry
    cyp = -co * ry * x1 / rx
    cx = cp * cxp - sp * cyp + (p0[0] + p1[0]) / 2
    cy = sp * cxp + cp * cyp + (p0[1] + p1[1]) / 2

    def angle(ux, uy, vx, vy):
        dot = ux * vx + uy * vy
        ln = math.hypot(ux, uy) * math.hypot(vx, vy)
        a = math.acos(max(-1, min(1, dot / ln))) if ln else 0.0
        return -a if ux * vy - uy * vx < 0 else a

    th1 = angle(1, 0, (x1 - cxp) / rx, (y1 - cyp) / ry)
    dth = angle((x1 - cxp) / rx, (y1 - cyp) / ry,
                (-x1 - cxp) / rx, (-y1 - cyp) / ry)
    if not sweep and dth > 0:
        dth -= 2 * math.pi
    elif sweep and dth < 0:
        dth += 2 * math.pi
    pts = []
    for k in range(1, steps + 1):
        th = th1 + dth * k / steps
        x = cx + rx * math.cos(th) * cp - ry * math.sin(th) * sp
        y = cy + rx * math.cos(th) * sp + ry * math.sin(th) * cp
        pts.append((x, y))
    return pts


def _parse_path(d: str) -> List[List[Tuple[float, float]]]:
    """Path data → list of subpath polylines (closed subpaths repeat
    their first point at the end)."""
    tokens = [(m.group(1), m.group(2)) for m in _PATH_RE.finditer(d or "")]
    i = 0
    nums: List[float] = []
    subpaths: List[List[Tuple[float, float]]] = []
    cur: List[Tuple[float, float]] = []
    pos = (0.0, 0.0)
    start = (0.0, 0.0)
    last_ctrl: Optional[Tuple[float, float]] = None
    last_cmd = ""

    def flush():
        nonlocal cur
        if len(cur) > 1:
            subpaths.append(cur)
        cur = []

    def take(n) -> List[float]:
        nonlocal i
        out = []
        while len(out) < n and i < len(tokens) and tokens[i][1] is not None:
            out.append(float(tokens[i][1]))
            i += 1
        return out if len(out) == n else []

    while i < len(tokens):
        cmd_tok, num_tok = tokens[i]
        if cmd_tok:
            cmd = cmd_tok
            i += 1
        elif last_cmd:
            # Implicit command repetition; M/m repeats as L/l.
            cmd = {"M": "L", "m": "l"}.get(last_cmd, last_cmd)
        else:
            i += 1
            continue
        rel = cmd.islower()
        C = cmd.upper()
        if C == "Z":
            if cur:
                cur.append(start)
            flush()
            pos = start
            last_cmd, last_ctrl = cmd, None
            continue
        if C == "M":
            v = take(2)
            if not v:
                break
            flush()
            pos = (pos[0] + v[0], pos[1] + v[1]) if rel else (v[0], v[1])
            start = pos
            cur = [pos]
            last_ctrl = None
        elif C == "L":
            v = take(2)
            if not v:
                break
            pos = (pos[0] + v[0], pos[1] + v[1]) if rel else (v[0], v[1])
            cur.append(pos)
            last_ctrl = None
        elif C == "H":
            v = take(1)
            if not v:
                break
            pos = (pos[0] + v[0] if rel else v[0], pos[1])
            cur.append(pos)
            last_ctrl = None
        elif C == "V":
            v = take(1)
            if not v:
                break
            pos = (pos[0], pos[1] + v[0] if rel else v[0])
            cur.append(pos)
            last_ctrl = None
        elif C in ("C", "S"):
            n = 6 if C == "C" else 4
            v = take(n)
            if not v:
                break
            if rel:
                v = [v[k] + pos[k % 2] for k in range(n)]
            if C == "C":
                c1, c2, end = (v[0], v[1]), (v[2], v[3]), (v[4], v[5])
            else:
                c1 = ((2 * pos[0] - last_ctrl[0], 2 * pos[1] - last_ctrl[1])
                      if last_cmd.upper() in ("C", "S") and last_ctrl
                      else pos)
                c2, end = (v[0], v[1]), (v[2], v[3])
            cur.extend(_flatten_cubic(pos, c1, c2, end))
            last_ctrl = c2
            pos = end
        elif C in ("Q", "T"):
            n = 4 if C == "Q" else 2
            v = take(n)
            if not v:
                break
            if rel:
                v = [v[k] + pos[k % 2] for k in range(n)]
            if C == "Q":
                c1, end = (v[0], v[1]), (v[2], v[3])
            else:
                c1 = ((2 * pos[0] - last_ctrl[0], 2 * pos[1] - last_ctrl[1])
                      if last_cmd.upper() in ("Q", "T") and last_ctrl
                      else pos)
                end = (v[0], v[1])
            cur.extend(_flatten_quad(pos, c1, end))
            last_ctrl = c1
            pos = end
        elif C == "A":
            v = take(7)
            if not v:
                break
            end = ((pos[0] + v[5], pos[1] + v[6]) if rel
                   else (v[5], v[6]))
            cur.extend(_flatten_arc(pos, v[0], v[1], v[2],
                                    bool(v[3]), bool(v[4]), end))
            pos = end
            last_ctrl = None
        last_cmd = cmd
    flush()
    return subpaths


def _collect_gradients(root) -> dict:
    """gradient id → first stop color (the degrade-to-solid fallback)."""
    out = {}
    for el in root.iter():
        if _strip_ns(el.tag) in ("linearGradient", "radialGradient"):
            gid = el.get("id")
            for stop in el:
                if _strip_ns(stop.tag) == "stop":
                    color = stop.get("stop-color")
                    if not color:
                        m = re.search(r"stop-color\s*:\s*([^;]+)",
                                      stop.get("style") or "")
                        color = m.group(1).strip() if m else None
                    if gid and color:
                        out[gid] = color
                    break
    return out


def _ellipse_points(cx, cy, rx, ry, steps: int = 48):
    return [(cx + rx * math.cos(2 * math.pi * k / steps),
             cy + ry * math.sin(2 * math.pi * k / steps))
            for k in range(steps)]


def render_svg(path: str, target_px: float = 262_144.0, *, native: bool = True) -> np.ndarray:
    """Rasterize an SVG file to an [h, w, 4] RGBA image of ~target_px area
    (svg.rs renders to the same target pixel budget, consts.rs:31): the
    supersampled canvas, resized as PIL resizes RGBA."""
    canvas, size = rasterize(path, target_px)
    return draw.resize_rgba(canvas, size, native=native)


def rasterize(path: str, target_px: float = 262_144.0) -> Tuple[np.ndarray, Tuple[int, int]]:
    """The SS× supersampled RGBA canvas [h·SS, w·SS, 4] and the (w, h) it
    resizes to: what the JAX ``render_svg`` draws before its resize."""
    with open(path, "rb") as f:
        head = f.read(2)
        f.seek(0)
        if head == b"\x1f\x8b":
            # Chunked decompress with a hard output ceiling: a tiny
            # crafted .svgz must not expand past the same 192 MiB budget
            # that bounds on-disk inputs (images._check_size only guards
            # the compressed size).
            chunks, total = [], 0
            with gzip.open(f) as gz:
                while True:
                    chunk = gz.read(1 << 20)
                    if not chunk:
                        break
                    total += len(chunk)
                    if total > _MAX_DECOMPRESSED:
                        raise ValueError(
                            f"{path}: decompressed SVG exceeds "
                            f"{_MAX_DECOMPRESSED >> 20} MiB")
                    chunks.append(chunk)
            data = b"".join(chunks)
        else:
            data = f.read()
    # Reject entity declarations before parsing: xml.etree expands
    # internal entities, so a billion-laughs/quadratic-blowup document
    # reached by the automatic thumbnail job could exhaust node memory.
    # A bare external DOCTYPE (the legacy W3C header every old
    # Illustrator/Inkscape file carries) is harmless — expat never
    # fetches external DTDs — so only an internal subset (the "[...]"
    # block that could hold ENTITY declarations) is refused.
    if b"<!ENTITY" in data:
        raise ValueError(f"{path}: SVG with entity declarations "
                         "is not supported")
    doc = data.find(b"<!DOCTYPE")
    if doc != -1:
        gt = data.find(b">", doc)
        if gt == -1 or b"[" in data[doc:gt]:
            raise ValueError(f"{path}: SVG DOCTYPE with internal "
                             "subset is not supported")
    root = ET.fromstring(data)
    if _strip_ns(root.tag) != "svg":
        raise ValueError(f"{path}: not an SVG document")

    vb = _floats(root.get("viewBox") or "")
    if len(vb) == 4:
        min_x, min_y, vw, vh = vb
    else:
        min_x = min_y = 0.0
        vw = _parse_length(root.get("width"), 0) or 300.0
        vh = _parse_length(root.get("height"), 0) or 150.0
    if vw <= 0 or vh <= 0:
        raise ValueError(f"{path}: empty SVG viewport")

    scale = math.sqrt(target_px / (vw * vh))
    out_w = max(1, int(round(vw * scale)))
    out_h = max(1, int(round(vh * scale)))
    s = scale * SS
    # viewport transform: user coords → supersampled pixel coords
    view = (s, 0, 0, s, -min_x * s, -min_y * s)

    img = np.zeros((out_h * SS, out_w * SS, 4), np.uint8)
    gradients = _collect_gradients(root)

    def emit(points, style: _Style, ctm: Matrix, closed: bool):
        pts = [_mat_apply(ctm, x, y) for x, y in points]
        if len(pts) < 2:
            return
        fill = _color(style.fill, style.fill_opacity * style.opacity) \
            if closed else None
        stroke = _color(style.stroke,
                        style.stroke_opacity * style.opacity)
        # stroke width scales with the CTM's mean scale factor
        a, b, c, d, _, _ = ctm
        sw = style.stroke_width * math.sqrt(abs(a * d - b * c) or 1.0)
        if fill and len(pts) >= 3:
            draw.polygon(img, pts, np.array(fill, np.uint8))
        if stroke:
            draw.line(img, pts + ([pts[0]] if closed else []),
                      np.array(stroke, np.uint8), width=max(1, int(round(sw))),
                      joint="curve")

    def walk(el, style: _Style, ctm: Matrix):
        tag = _strip_ns(el.tag)
        if tag in ("defs", "symbol", "clipPath", "mask", "marker",
                   "linearGradient", "radialGradient", "style", "metadata",
                   "title", "desc"):
            return
        st = style.child(el, gradients)
        m = ctm
        if el.get("transform"):
            m = _mat_mul(ctm, _parse_transform(el.get("transform")))
        if tag in ("svg", "g", "a", "switch"):
            for ch in el:
                walk(ch, st, m)
            return
        if tag == "rect":
            x = _parse_length(el.get("x"))
            y = _parse_length(el.get("y"))
            w = _parse_length(el.get("width"))
            h = _parse_length(el.get("height"))
            if w > 0 and h > 0:
                emit([(x, y), (x + w, y), (x + w, y + h), (x, y + h)],
                     st, m, closed=True)
        elif tag == "circle":
            r = _parse_length(el.get("r"))
            if r > 0:
                emit(_ellipse_points(_parse_length(el.get("cx")),
                                     _parse_length(el.get("cy")), r, r),
                     st, m, closed=True)
        elif tag == "ellipse":
            rx = _parse_length(el.get("rx"))
            ry = _parse_length(el.get("ry"))
            if rx > 0 and ry > 0:
                emit(_ellipse_points(_parse_length(el.get("cx")),
                                     _parse_length(el.get("cy")), rx, ry),
                     st, m, closed=True)
        elif tag == "line":
            p = [(_parse_length(el.get("x1")), _parse_length(el.get("y1"))),
                 (_parse_length(el.get("x2")), _parse_length(el.get("y2")))]
            st2 = st
            emit(p, st2, m, closed=False)
        elif tag in ("polyline", "polygon"):
            v = _floats(el.get("points") or "")
            pts = list(zip(v[0::2], v[1::2]))
            if pts:
                emit(pts, st, m, closed=(tag == "polygon"))
        elif tag == "path":
            for sub in _parse_path(el.get("d") or ""):
                closed = len(sub) > 2 and sub[0] == sub[-1]
                emit(sub, st, m, closed=closed or st.fill is not None)

    walk(root, _Style(), view)
    return img, (out_w, out_h)
