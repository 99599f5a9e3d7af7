"""Drawing primitives on numpy images, with the pixels of Pillow's
``ImageDraw`` (libImaging/Draw.c) where the JAX package's ``vis`` draws with
it, and a bitmap font of the port's own for text.

Every function draws into a (H, W, 3) uint8 array in place. ``blend`` is
Pillow's "RGBA on RGB" mode (``ImageDraw.Draw(img, "RGBA")``): the ink's
alpha a mixes it in as (in (255 - a) + ink a) / 255, rounded as Draw.c's
``DIV255``, and a filled polygon then keeps its spans apart so no pixel is
blended twice. Without ``blend`` the ink's colour is written as it is.

What Draw.c does, written out:

* a coordinate is truncated to an integer (``(int)`` of the float) before
  anything is drawn;
* a one-pixel line is Bresenham's from the first end up to, not including,
  the last (a polyline then sets its last point);
* a wide line is the quadrilateral around the segment, its half-widths
  rounded up and down (``ImagingDrawWideLine``), filled as a polygon;
* a polygon is filled by a scan line over its edges, intersections in f32,
  each span from the rounded-up left to the rounded-down right crossing
  (``polygon_generic``);
* a rectangle's outline is ``width`` nested one-pixel frames, its fill one
  span a row.

Text is drawn with ``FONT``, 5 x 8 glyphs on a 6-pixel advance, solid in the
ink's colour: Pillow's default font is not carried.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

Ink = Sequence[int]  # (r, g, b) or (r, g, b, alpha)


def _rgb_alpha(ink: Ink):
    return np.asarray(ink[:3], np.int32), (int(ink[3]) if len(ink) > 3 else 255)


def _put(img: np.ndarray, ys, xs, ink: Ink, blend: bool) -> None:
    """Set (or blend in) the pixels at (ys, xs) that lie inside ``img``;
    no pixel may repeat within one call."""
    ys, xs = np.asarray(ys, np.int64), np.asarray(xs, np.int64)
    keep = (ys >= 0) & (ys < img.shape[0]) & (xs >= 0) & (xs < img.shape[1])
    ys, xs = ys[keep], xs[keep]
    rgb, alpha = _rgb_alpha(ink)
    if not blend or alpha == 255:
        img[ys, xs] = rgb
        return
    v = img[ys, xs].astype(np.int32) * (255 - alpha) + rgb * alpha + 128
    img[ys, xs] = ((v >> 8) + v) >> 8


def hline(img: np.ndarray, x0: int, y: int, x1: int, ink: Ink, blend: bool = False) -> None:
    """Pixels x0..x1 (inclusive, either order) of row y, clipped to the image."""
    if not 0 <= y < img.shape[0]:
        return
    x0, x1 = min(x0, x1), max(x0, x1)
    x0, x1 = max(x0, 0), min(x1, img.shape[1] - 1)
    if x0 <= x1:
        xs = np.arange(x0, x1 + 1)
        _put(img, np.full_like(xs, y), xs, ink, blend)


def bresenham(x0, y0, x1, y1, shape=None):
    """The pixels (xs, ys) Draw.c's ``line`` sets from (x0, y0) towards
    (x1, y1), the last end excluded: max(|dx|, |dy|) of them, or, given the
    image's ``shape``, those whose major coordinate lies inside it. The ends
    may be arrays of equal length (many segments at once) or integers."""
    x0, y0, x1, y1 = (np.atleast_1d(np.asarray(v, np.int64)) for v in (x0, y0, x1, y1))
    dx, dy = np.abs(x1 - x0), np.abs(y1 - y0)
    sx, sy = np.where(x1 >= x0, 1, -1), np.where(y1 >= y0, 1, -1)
    flat = dx >= dy  # x is the major axis
    n, d_major, d_minor = np.maximum(dx, dy), np.where(flat, dx, dy), np.where(flat, dy, dx)
    start, step = np.where(flat, x0, y0), np.where(flat, sx, sy)
    lo, hi = np.zeros_like(n), n - 1
    if shape is not None:  # the steps whose major coordinate is inside the image
        size = np.where(flat, shape[1], shape[0])
        lo = np.maximum(np.where(step > 0, -start, start - size + 1), 0)
        hi = np.minimum(np.where(step > 0, size - 1 - start, start), hi)
    count = np.maximum(hi - lo + 1, 0)
    seg = np.repeat(np.arange(len(n)), count)
    i = lo[seg] + np.arange(count.sum()) - np.repeat(np.cumsum(count) - count, count)
    # the minor axis steps where the error term turns non-negative
    minor = np.where(d_minor[seg] > 0, (2 * d_minor[seg] * i + d_major[seg]) // np.maximum(2 * d_major[seg], 1), 0)
    major = start[seg] + step[seg] * i
    xs = np.where(flat[seg], major, x0[seg] + sx[seg] * minor)
    ys = np.where(flat[seg], y0[seg] + sy[seg] * minor, major)
    return xs, ys


def line1(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, ink: Ink, blend: bool = False) -> None:
    xs, ys = bresenham(x0, y0, x1, y1, img.shape)
    _put(img, ys, xs, ink, blend)


def _round_up(f: float) -> int:
    return int(math.floor(f + 0.5)) if f >= 0.0 else -int(math.floor(abs(f) + 0.5))


def _round_down(f: float) -> int:
    return int(math.ceil(f - 0.5)) if f >= 0.0 else -int(math.ceil(abs(f) - 0.5))


class _Edge:
    __slots__ = ("x0", "y0", "xmin", "xmax", "ymin", "ymax", "dx", "row0", "xs")

    def __init__(self, x0: int, y0: int, x1: int, y1: int):
        self.xmin, self.xmax = min(x0, x1), max(x0, x1)
        self.ymin, self.ymax = min(y0, y1), max(y0, y1)
        self.dx = np.float32(0.0) if y0 == y1 else np.float32(x1 - x0) / np.float32(y1 - y0)
        self.x0, self.y0 = x0, y0
        self.row0, self.xs = 0, np.zeros(0, np.float32)

    def tabulate(self, lo: int, hi: int) -> None:
        """``at`` of rows lo..hi computed at once (the same f32 operations)."""
        self.row0 = lo
        self.xs = (np.arange(lo, hi + 1) - self.y0).astype(np.float32) * self.dx + np.float32(self.x0)

    def at(self, y: int) -> np.float32:
        """The edge's x on row y, in f32 as Draw.c computes it."""
        if 0 <= y - self.row0 < len(self.xs):
            return self.xs[y - self.row0]
        return np.float32(y - self.y0) * self.dx + np.float32(self.x0)


def _span_ends(f: np.float32):
    """Draw.c's ROUND_UP and ROUND_DOWN of an f32 crossing (the half added in f32)."""
    h = np.float32(0.5)
    up = int(math.floor(f + h)) if f >= 0 else -int(math.floor(abs(f) + h))
    down = int(math.ceil(f - h)) if f >= 0 else -int(math.ceil(abs(f) - h))
    return up, down


def _connect_corner(table, i: int, y: int, ymax: int, xx: list, slot: dict) -> None:
    """At a vertex on row y where edge i meets an earlier edge leaving (or
    arriving) on the same side, stretch the vertex's span towards the next
    (on the last row, the previous) row's span so the two rows touch: the
    crossing of the other edge on row y is moved to one pixel past the
    adjacent row's crossings, where that lies beyond the vertex."""
    cur = table[i]
    for k in range(i):
        other = table[k]
        if (cur.dx > 0 and other.dx <= 0) or (cur.dx < 0 and other.dx >= 0):
            continue
        if not (cur.ymin == y == other.ymin or cur.ymax == y == other.ymax):
            continue
        if np.round(xx[-1]) != np.round(other.at(y)):
            continue
        v = xx[-1]
        off = -1 if y == ymax else 1
        a, b = cur.at(y + off), other.at(y + off)
        if y == cur.ymax:
            val = min(v, max(a, b) + 1) if cur.dx > 0 else max(v, min(a, b) - 1)
        else:
            val = max(v, min(a, b) - 1) if cur.dx > 0 else min(v, max(a, b) + 1)
        if k in slot:
            xx[slot[k]] = np.float32(val)
        return


class _Spans:
    """Row spans of one fill, set (or blended) together at the end: a fill
    covers a pixel once, so the order of its spans does not matter."""

    def __init__(self, img: np.ndarray):
        self.img, self.spans = img, []

    def __call__(self, x0: int, y: int, x1: int) -> None:
        """``hline``'s span, clipped to the image."""
        if 0 <= y < self.img.shape[0]:
            x0, x1 = max(min(x0, x1), 0), min(max(x0, x1), self.img.shape[1] - 1)
            if x0 <= x1:
                self.spans.append((y, x0, x1))

    def flush(self, ink: Ink, blend: bool) -> None:
        if not self.spans:
            return
        y, x0, x1 = (np.asarray(v, np.int64) for v in zip(*self.spans))
        n = x1 - x0 + 1
        xs = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n) + np.repeat(x0, n)
        _put(self.img, np.repeat(y, n), xs, ink, blend)


def _fill_edges(img: np.ndarray, edges: Sequence[_Edge], ink: Ink, blend: bool) -> None:
    """Draw.c's ``polygon_generic`` over ``edges``; with ``blend`` its
    alpha form, which keeps the spans of a row from overlapping."""
    n = len(edges)
    if n == 0:
        return
    spans = _Spans(img)
    ymin, ymax = img.shape[0] - 1, 0
    table = []
    for e in edges:
        ymin, ymax = min(ymin, e.ymin), max(ymax, e.ymax)
        if e.ymin == e.ymax:
            if not blend:
                spans(e.xmin, e.ymin, e.xmax)
            continue
        table.append(e)
    ymin, ymax = max(ymin, 0), min(ymax, img.shape[0])
    for e in table:
        e.tabulate(ymin - 1, ymax + 1)

    def flat_lines(y: int, x_pos: int) -> int:
        for e in edges:
            if e.ymin == y and e.ymin == e.ymax:
                xmin = e.xmin
                if x_pos != -1 and x_pos < xmin:
                    continue
                xmax = e.xmax
                if x_pos > xmin:
                    xmin = x_pos
                    if xmax < xmin:
                        continue
                spans(xmin, e.ymin, xmax)
                x_pos = xmax + 1
        return x_pos

    for y in range(ymin, ymax + 1):
        xx, slot = [], {}
        for i, cur in enumerate(table):
            if not cur.ymin <= y <= cur.ymax:
                continue
            slot[i] = len(xx)
            xx.append(cur.at(y))
            if y == cur.ymax and y < ymax:
                xx.append(xx[-1])  # an edge ending on this row counts twice
            elif cur.dx != 0 and np.round(xx[-1]) == xx[-1]:
                _connect_corner(table, i, y, ymax, xx, slot)
        xx.sort()
        if blend:
            x_pos = -1 if not xx else 0
            for i in range(1, len(xx), 2):
                x_end = _span_ends(xx[i])[1]
                if x_end < x_pos:
                    continue
                x_pos = flat_lines(y, x_pos)
                if x_end < x_pos:
                    continue
                x_start = _span_ends(xx[i - 1])[0]
                if x_pos > x_start:
                    x_start = x_pos
                    if x_end < x_start:
                        continue
                spans(x_start, y, x_end)
                x_pos = x_end + 1
            flat_lines(y, x_pos)
        else:
            for i in range(1, len(xx), 2):
                spans(_span_ends(xx[i - 1])[0], y, _span_ends(xx[i])[1])
    spans.flush(ink, blend)


def wide_line(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, ink: Ink, width: int,
              blend: bool = False) -> None:
    """Draw.c's ``ImagingDrawWideLine``: the segment's quadrilateral, filled."""
    dx, dy = x1 - x0, y1 - y0
    if dx == 0 and dy == 0:
        _put(img, [y0], [x0], ink, blend)
        return
    big = math.hypot(dx, dy)
    small = (width - 1) / 2.0
    ratio_max, ratio_min = _round_up(small) / big, _round_down(small) / big
    dxmin, dxmax = _round_down(ratio_min * dy), _round_down(ratio_max * dy)
    dymin, dymax = _round_down(ratio_min * dx), _round_down(ratio_max * dx)
    v = [(x0 - dxmin, y0 + dymax), (x1 - dxmin, y1 + dymax), (x1 + dxmax, y1 - dymin), (x0 + dxmax, y0 - dymin)]
    _fill_edges(img, [_Edge(*v[i], *v[(i + 1) % 4]) for i in range(4)], ink, blend)


def _ints(xy) -> list:
    """Points as C's ``(int)`` of each float coordinate (towards zero)."""
    return [(int(p[0]), int(p[1])) for p in xy]


def lines(img: np.ndarray, xy, ink: Ink, width: int = 0, blend: bool = False) -> None:
    """``ImageDraw.line(xy, fill=ink, width=width)``: a polyline."""
    pts = _ints(xy)
    for (x0, y0), (x1, y1) in zip(pts[:-1], pts[1:]):
        if width <= 1:
            line1(img, x0, y0, x1, y1, ink, blend)
        else:
            wide_line(img, x0, y0, x1, y1, ink, width, blend)
    if width <= 1 and len(pts) > 1:
        _put(img, [pts[-1][1]], [pts[-1][0]], ink, blend)


def segments(img: np.ndarray, starts, ends, ink: Ink, width: int = 0) -> None:
    """Each segment starts[k] -> ends[k] as its own ``lines`` call, without
    blending (so their order does not matter); one-pixel segments are
    rasterized together."""
    starts, ends = np.trunc(np.asarray(starts, np.float64)), np.trunc(np.asarray(ends, np.float64))
    if width > 1:
        for p, q in zip(starts, ends):
            lines(img, [p, q], ink, width)
        return
    x1, y1 = ends[:, 0].astype(np.int64), ends[:, 1].astype(np.int64)
    xs, ys = bresenham(starts[:, 0], starts[:, 1], x1, y1, img.shape)
    _put(img, np.concatenate([ys, y1]), np.concatenate([xs, x1]), ink, False)


def rectangle(img: np.ndarray, xy, fill: Optional[Ink] = None, outline: Optional[Ink] = None,
              width: int = 1, blend: bool = False) -> None:
    """``ImageDraw.rectangle([x0, y0, x1, y1], fill, outline, width)``."""
    x0, y0, x1, y1 = (int(v) for v in np.asarray(xy, np.float64).reshape(-1))
    if x1 < x0 or y1 < y0:
        raise ValueError(f"rectangle {list(xy)}: x1 must be >= x0 and y1 >= y0")
    if fill is not None:
        for y in range(max(y0, 0), min(y1, img.shape[0]) + 1):
            hline(img, x0, y, x1, fill, blend)
    if outline is not None and width != 0 and (fill is None or tuple(outline) != tuple(fill)):
        for i in range(max(width, 1)):
            hline(img, x0, y0 + i, x1, outline, blend)
            hline(img, x0, y1 - i, x1, outline, blend)
            line1(img, x1 - i, y0 + width, x1 - i, y1 - width + 1, outline, blend)
            line1(img, x0 + i, y0 + width, x0 + i, y1 - width + 1, outline, blend)


def polygon(img: np.ndarray, xy, fill: Optional[Ink] = None, outline: Optional[Ink] = None,
            blend: bool = False) -> None:
    """``ImageDraw.polygon(xy, fill, outline)`` (outline one pixel wide)."""
    pts = _ints(xy)
    if fill is not None:
        edges = []
        for i in range(len(pts) - 1):
            (x0, y0), (x1, y1) = pts[i], pts[i + 1]
            if y0 == y1 and i != 0 and y0 == pts[i - 1][1]:  # a horizontal edge after another
                if x1 > x0 > pts[i - 1][0]:
                    edges[-1].xmax = x1
                    continue
                if x1 < x0 < pts[i - 1][0]:
                    edges[-1].xmin = x1
                    continue
            edges.append(_Edge(x0, y0, x1, y1))
        if pts[-1] != pts[0]:
            edges.append(_Edge(*pts[-1], *pts[0]))
        _fill_edges(img, edges, fill, blend)
    if outline is not None and (fill is None or tuple(outline) != tuple(fill)):
        for i in range(len(pts)):
            line1(img, *pts[i], *pts[(i + 1) % len(pts)], outline, blend)


# 5 x 8 glyphs of printable ASCII, one byte a column, bit 0 the top row
FONT_FIRST = 0x20
FONT = bytes.fromhex(
    "0000000000" "00005f0000" "0007000700" "147f147f14" "242a7f2a12" "2313086462" "3649562050" "0008070300"
    "001c224100" "0041221c00" "2a1c7f1c2a" "08083e0808" "0080703000" "0808080808" "0000606000" "2010080402"
    "3e5149453e" "00427f4000" "7249494946" "2141494d33" "1814127f10" "2745454539" "3c4a494931" "4121110907"
    "3649494936" "464949291e" "0000140000" "0040340000" "0008142241" "1414141414" "0041221408" "0201590906"
    "3e415d594e" "7c1211127c" "7f49494936" "3e41414122" "7f4141413e" "7f49494941" "7f09090901" "3e41415173"
    "7f0808087f" "00417f4100" "2040413f01" "7f08142241" "7f40404040" "7f021c027f" "7f0408107f" "3e4141413e"
    "7f09090906" "3e4151215e" "7f09192946" "2649494932" "03017f0103" "3f4040403f" "1f2040201f" "3f4038403f"
    "6314081463" "0304780403" "6159494d43" "007f414141" "0204081020" "004141417f" "0402010204" "4040404040"
    "0003070800" "2054547840" "7f28444438" "3844444428" "384444287f" "3854545418" "00087e0902" "18a4a49c78"
    "7f08040478" "00447d4000" "2040403d00" "7f10284400" "00417f4000" "7c0478047c" "7c08040478" "3844444438"
    "fc18242418" "18242418fc" "7c08040408" "4854545424" "04043f4424" "3c4040207c" "1c2040201c" "3c4030403c"
    "4428102844" "4c9090907c" "4464544c44" "0008364100" "0000770000" "0041360800" "0201020402"
)
GLYPH_W, GLYPH_H, ADVANCE = 5, 8, 6


def glyph_mask(text: str) -> np.ndarray:
    """(8, 6 len(text)) bool bitmap of ``text`` in ``FONT`` (a character
    outside printable ASCII is drawn as '?')."""
    out = np.zeros((GLYPH_H, ADVANCE * len(text)), bool)
    for k, ch in enumerate(text):
        code = ord(ch) if FONT_FIRST <= ord(ch) < FONT_FIRST + len(FONT) // GLYPH_W else ord("?")
        cols = FONT[(code - FONT_FIRST) * GLYPH_W:(code - FONT_FIRST + 1) * GLYPH_W]
        for c, bits in enumerate(cols):
            out[:, ADVANCE * k + c] = [(bits >> r) & 1 for r in range(GLYPH_H)]
    return out


def text(img: np.ndarray, xy, s: str, ink: Ink, blend: bool = False) -> None:
    """``s`` with its top-left corner at (int x, int y), clipped to the image."""
    m = glyph_mask(s)
    ys, xs = np.nonzero(m)
    _put(img, ys + int(xy[1]), xs + int(xy[0]), ink, blend)
