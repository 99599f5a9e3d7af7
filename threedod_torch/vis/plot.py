"""A small plotter on numpy images, for the port's figures: the JAX tools
draw theirs with matplotlib, which the card's machine does not have.

``Plot`` collects bars (vertical or horizontal), histograms, scatter points,
lines, vertical segments and a heatmap in data coordinates, then ``render``
draws them into a white (H, W, 3) uint8 image with ``vis/draw.py``'s
primitives and its 5 x 8 font: a framed panel, five ticks an axis (powers of
ten on a log axis), the title above, the x label below, the y label in the top-left
corner, category names under (or beside) their bars, one
character a row. ``save`` writes it with ``vis/png.write_png``. The figures
are not matplotlib's pixels; the numbers they show are the JAX tools'
(their tools write those numbers beside each figure).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np

from . import draw
from .png import write_png

BLUE = (52, 138, 189)  # the JAX tools' "#348ABD"
ORANGE = (255, 165, 0)
RED = (255, 0, 0)
GRAY = (128, 128, 128)
BLACK = (0, 0, 0)
CHAR_W, CHAR_H = draw.ADVANCE, draw.GLYPH_H + 1
MAX_LABEL = 14  # characters of a category name that are drawn


def _dash(p: np.ndarray, q: np.ndarray, period: float = 8.0):
    """The drawn halves of a dashed segment p -> q."""
    n = max(1, int(np.hypot(*(q - p)) // period))
    ts = np.linspace(0.0, 1.0, 2 * n + 1)
    return [(p + (q - p) * a, p + (q - p) * b) for a, b in zip(ts[0::2], ts[1::2])]


class Plot:
    def __init__(self, width: int = 640, height: int = 400, title: str = "", xlabel: str = "", ylabel: str = "",
                 xlog: bool = False, ylog: bool = False):
        self.width, self.height = width, height
        self.title, self.xlabel, self.ylabel = title, xlabel, ylabel
        self.xlog, self.ylog = xlog, ylog
        self.items: List[tuple] = []
        self.xcats: Optional[List[str]] = None
        self.ycats: Optional[List[str]] = None

    # -- what is drawn -------------------------------------------------------
    def bar(self, labels: Sequence[str], values, color=BLUE) -> None:
        self.xcats = [str(s) for s in labels]
        self.items.append(("bar", np.arange(len(self.xcats), dtype=np.float64), np.asarray(values, np.float64), color))

    def categories(self, labels: Sequence[str]) -> None:
        """Name the x positions 0, 1, ... without drawing bars."""
        self.xcats = [str(s) for s in labels]
        self.items.append(("categories", np.arange(len(self.xcats), dtype=np.float64)))

    def barh(self, labels: Sequence[str], values, color=BLUE) -> None:
        self.ycats = [str(s) for s in labels]
        self.items.append(("barh", np.arange(len(self.ycats), dtype=np.float64), np.asarray(values, np.float64),
                           color))

    def hist(self, values, bins: int = 20, density: bool = False, color=BLUE):
        """numpy's histogram of ``values``, drawn; returns (heights, edges)."""
        counts, edges = np.histogram(np.asarray(values, np.float64), bins=bins)
        heights = counts / (counts.sum() * np.diff(edges)) if density else counts.astype(np.float64)
        self.items.append(("hist", edges, heights, color))
        return heights, edges

    def scatter(self, xs, ys, sizes=None, color=BLUE, labels: Optional[Sequence[str]] = None) -> None:
        xs, ys = np.asarray(xs, np.float64), np.asarray(ys, np.float64)
        sizes = np.full(len(xs), 16.0) if sizes is None else np.broadcast_to(np.asarray(sizes, np.float64), xs.shape)
        self.items.append(("scatter", xs, ys, color, sizes, list(labels) if labels is not None else None))

    def line(self, xs, ys, color=RED, dashed: bool = False) -> None:
        self.items.append(("line", np.asarray(xs, np.float64), np.asarray(ys, np.float64), color, dashed))

    def vlines(self, xs, lo, hi, color=GRAY, dashed: bool = False) -> None:
        xs = np.atleast_1d(np.asarray(xs, np.float64))
        self.items.append(("vlines", xs, np.broadcast_to(np.asarray(lo, np.float64), xs.shape),
                           np.broadcast_to(np.asarray(hi, np.float64), xs.shape), color, dashed))

    def heatmap(self, grid) -> None:
        """A (h, w) grid in [0, 1] as gray levels, 0 white and 1 black, row 0
        at the top."""
        self.items.append(("heatmap", np.clip(np.asarray(grid, np.float64), 0.0, 1.0)))

    # -- drawing -------------------------------------------------------------
    def _tx(self, v, log: bool):
        v = np.asarray(v, np.float64)
        if not log:
            return v
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(v > 0, np.log10(np.where(v > 0, v, 1.0)), np.nan)

    def _extent(self):
        xs, ys, pad = [], [], False
        for it in self.items:
            kind = it[0]
            if kind == "categories":
                xs += [-0.5, len(it[1]) - 0.5]
            elif kind == "bar":
                xs += [-0.5, len(it[1]) - 0.5]
                ys += [0.0, *it[2]]
            elif kind == "barh":
                ys += [-0.5, len(it[1]) - 0.5]
                xs += [0.0, *it[2]]
            elif kind == "hist":
                xs += [it[1][0], it[1][-1]]
                ys += [0.0, *it[2]]
            elif kind == "heatmap":
                xs += [0.0, it[1].shape[1]]
                ys += [0.0, it[1].shape[0]]
            elif kind == "vlines":
                xs += list(it[1])
                ys += [*it[2], *it[3]]
                pad = True
            else:
                xs += list(it[1])
                ys += list(it[2])
                pad = True
        out = []
        for vals, log in ((xs, self.xlog), (ys, self.ylog)):
            v = self._tx(vals, log)
            v = v[np.isfinite(v)]
            lo, hi = (float(v.min()), float(v.max())) if v.size else (0.0, 1.0)
            if hi <= lo:
                lo, hi = lo - 0.5, hi + 0.5
            if pad:
                lo, hi = lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo)
            out.append((lo, hi))
        return out

    @staticmethod
    def _ticks(lo: float, hi: float, log: bool):
        if log:
            ks = range(math.ceil(lo), math.floor(hi) + 1)
            return [(float(k), f"1e{k}") for k in ks] or [(lo, f"{10 ** lo:.3g}"), (hi, f"{10 ** hi:.3g}")]
        return [(float(v), f"{v:.3g}") for v in np.linspace(lo, hi, 5)]

    def render(self) -> np.ndarray:
        img = np.full((self.height, self.width, 3), 255, np.uint8)
        ycat_w = CHAR_W * min(MAX_LABEL, max(map(len, self.ycats))) + 6 if self.ycats else 0
        xcat_h = CHAR_H * min(MAX_LABEL, max(map(len, self.xcats))) + 4 if self.xcats else 0
        left, right, top, bottom = 8 + max(ycat_w, CHAR_W * 8), 12, 16 + CHAR_H, 24 + xcat_h
        pw, ph = self.width - left - right, self.height - top - bottom
        if pw < 16 or ph < 16:
            raise ValueError(f"a {self.width}x{self.height} figure leaves no room for its panel")
        (x0, x1), (y0, y1) = self._extent()

        def px(x):
            return left + (self._tx(x, self.xlog) - x0) / (x1 - x0) * (pw - 1)

        def py(y):
            return top + ph - 1 - (self._tx(y, self.ylog) - y0) / (y1 - y0) * (ph - 1)

        def clip_x(v):
            return float(np.clip(v, left, left + pw - 1))

        def clip_y(v):
            return float(np.clip(v, top, top + ph - 1))

        for it in self.items:
            kind = it[0]
            if kind == "heatmap":
                g = it[1]
                rows = np.clip(((np.arange(ph) + 0.5) / ph * g.shape[0]).astype(int), 0, g.shape[0] - 1)
                cols = np.clip(((np.arange(pw) + 0.5) / pw * g.shape[1]).astype(int), 0, g.shape[1] - 1)
                img[top:top + ph, left:left + pw] = np.round(255.0 * (1.0 - g[rows][:, cols]))[..., None]
            elif kind in ("bar", "hist"):
                if kind == "bar":
                    x_lo, x_hi = it[1] - 0.4, it[1] + 0.4
                else:
                    x_lo, x_hi = it[1][:-1], it[1][1:]
                base = py(0.0) if not self.ylog else top + ph - 1
                for a, b, v in zip(px(x_lo), px(x_hi), py(it[2])):
                    if np.isfinite(v):
                        ya, yb = sorted((clip_y(v), clip_y(base)))
                        draw.rectangle(img, [a, ya, max(a, b - (kind == "hist")), yb], fill=it[3])
            elif kind == "barh":
                base = px(0.0) if not self.xlog else left
                for y, v in zip(it[1], px(it[2])):
                    if np.isfinite(v):
                        xa, xb = sorted((clip_x(v), clip_x(base)))
                        draw.rectangle(img, [xa, py(y + 0.4), xb, py(y - 0.4)], fill=it[3])
            elif kind == "scatter":
                for x, y, s, k in zip(px(it[1]), py(it[2]), it[4], range(len(it[1]))):
                    if np.isfinite(x) and np.isfinite(y):
                        r = max(1, int(round(math.sqrt(s) / 2)))
                        draw.rectangle(img, [clip_x(x - r), clip_y(y - r), clip_x(x + r), clip_y(y + r)], fill=it[3])
                        if it[5] is not None:
                            draw.text(img, (x + r + 2, y - CHAR_H // 2), str(it[5][k])[:MAX_LABEL], it[3])
            elif kind in ("line", "vlines"):
                if kind == "line":
                    pts = np.stack([px(it[1]), py(it[2])], -1)
                    segs = list(zip(pts[:-1], pts[1:]))
                    color, dashed = it[3], it[4]
                else:
                    segs = [(np.array([x, a]), np.array([x, b])) for x, a, b in zip(px(it[1]), py(it[2]), py(it[3]))]
                    color, dashed = it[4], it[5]
                for p, q in segs:
                    if np.isfinite(p).all() and np.isfinite(q).all():
                        p = np.array([clip_x(p[0]), clip_y(p[1])])
                        q = np.array([clip_x(q[0]), clip_y(q[1])])
                        for a, b in (_dash(p, q) if dashed else [(p, q)]):
                            draw.lines(img, [a, b], color)
        draw.rectangle(img, [left - 1, top - 1, left + pw, top + ph], outline=BLACK)
        if self.xcats is None:
            for v, s in self._ticks(x0, x1, self.xlog):
                x = int(left + (v - x0) / (x1 - x0) * (pw - 1))
                draw.lines(img, [(x, top + ph), (x, top + ph + 3)], BLACK)
                draw.text(img, (x - CHAR_W * len(s) // 2, top + ph + 5), s, BLACK)
        else:
            for i, name in enumerate(self.xcats):
                x = int(px(float(i))) - CHAR_W // 2
                for k, ch in enumerate(name[:MAX_LABEL]):
                    draw.text(img, (x, top + ph + 4 + CHAR_H * k), ch, BLACK)
        if self.ycats is None:
            for v, s in self._ticks(y0, y1, self.ylog):
                y = int(top + ph - 1 - (v - y0) / (y1 - y0) * (ph - 1))
                draw.lines(img, [(left - 4, y), (left - 1, y)], BLACK)
                draw.text(img, (max(0, left - 6 - CHAR_W * len(s)), y - CHAR_H // 2), s, BLACK)
        else:
            for i, name in enumerate(self.ycats):
                s = name[:MAX_LABEL]
                draw.text(img, (left - 4 - CHAR_W * len(s), int(py(float(i))) - CHAR_H // 2), s, BLACK)
        draw.text(img, ((self.width - CHAR_W * len(self.title)) // 2, 4), self.title, BLACK)
        draw.text(img, ((self.width - CHAR_W * len(self.xlabel)) // 2, self.height - CHAR_H - 2), self.xlabel, BLACK)
        draw.text(img, (4, 4), self.ylabel, BLACK)
        return img

    def save(self, path: str) -> np.ndarray:
        img = self.render()
        write_png(path, img)
        return img


def row(images: Sequence[np.ndarray]) -> np.ndarray:
    """Panels of one height side by side."""
    return np.concatenate(list(images), axis=1)
