"""The arithmetic of kernels K1 and K2's window design, emulated in torch on
the CPU (``csrc/roi_align_common.cuh``, ``roi_align_fwd.cu``,
``roi_align_bwd.cu``; the kernels themselves run only on a card).

Per ROI the kernels build, on its level, the samples of each axis (two taps
and their weights, nothing outside the [-1, dim] band), the window (the cells
the taps span), and for every window row and column the summed weights of
each bin's taps on it and the mask of those bins. In the forward each bin
reads every cell of the rows and columns its taps touch once, with weight row
weight x column weight; the backward sums the cotangent along the columns,
then the rows, into one value per touched cell. A ROI whose taps span more
than ``WINDOW_Y`` cells goes tap by tap. The emulation below follows those steps and is held against the plain
versions ``roi_align_levels`` and ``roi_align_backward`` at 1e-6 of the
largest entry in f32 (only the summation order differs), on boxes at the map
borders and in the [-1, dim] band, degenerate boxes, boxes that take the level
bump, and ROIs wider than the window. A ``hypothesis`` property pins the
window bound itself. No JAX here: the plain versions' parity with the JAX
package is in ``test_torch_roi_align{,_bwd}.py``.
"""
from __future__ import annotations

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import _torch_port  # noqa: F401  (one torch thread per worker)

from threedod_torch.ops.roi_align import STRIDES, WINDOW_Y, assign_levels, roi_align_backward, roi_align_levels

NAMES = ["p2", "p3", "p4", "p5", "p6"]
S, R = 7, 2


def _f32(v):
    return torch.tensor(v, dtype=torch.float32)


def axis_samples(lo, hi, scale, limit):
    """``axis_sample`` of roi_align_common.cuh for the S * R samples of one
    axis: (valid, t0, t1, w0, w1), each (S * R,)."""
    a = _f32(lo) * scale - 0.5
    b = _f32(hi) * scale - 0.5
    bin_ = (b - a).clamp(min=1e-6) / _f32(S)
    coord = a + (torch.arange(S * R, dtype=torch.float32) + 0.5) / _f32(R) * bin_
    valid = (coord >= -1.0) & (coord <= float(limit))
    cc = coord.clamp(0.0, limit - 1.0)
    f0 = torch.floor(cc)
    t0 = f0.long()
    frac = cc - f0
    return valid, t0, (t0 + 1).clamp(max=limit - 1), 1.0 - frac, frac


def axis_window(samples):
    """``build_window`` for one axis: (origin, extent, weights (WINDOW_Y, S),
    masks (WINDOW_Y,) of bins); the tables are None when the taps span more
    than WINDOW_Y cells. A bin's touched cells, the kernels' per-bin lists,
    are the cells whose mask has its bit."""
    valid, t0, t1, w0, w1 = samples
    if not valid.any():
        return 0, 0, torch.zeros(WINDOW_Y, S), [0] * WINDOW_Y
    lo, hi = int(t0[valid].min()), int(t1[valid].max())
    extent = hi - lo + 1
    if extent > WINDOW_Y:
        return lo, extent, None, None
    wt = torch.zeros(WINDOW_Y, S)
    mask = [0] * WINDOW_Y
    for k in range(S * R):  # sample order: the sums come out as the kernels form them
        if not valid[k]:
            continue
        p = k // R
        for tap, w in ((t0[k], w0[k]), (t1[k], w1[k])):
            wt[tap - lo, p] += w
            mask[tap - lo] |= 1 << p
    return lo, extent, wt, mask


def _roi_windows(box, fmap_shape, scale):
    h, w = fmap_shape
    ys, xs = axis_samples(box[1], box[3], scale, h), axis_samples(box[0], box[2], scale, w)
    return ys, xs, axis_window(ys), axis_window(xs)


def _bins_of(mask):
    return [p for p in range(S) if mask >> p & 1]


def window_forward(levels, boxes, level):
    """K1 as the kernel computes it: (B, N, S, S, C) f32. Bin (py, px) reads
    each cell of its touched rows by its touched columns once, rows outer,
    with weight (row weight x column weight)."""
    b, n = boxes.shape[:2]
    c = levels[0].shape[-1]
    out = torch.zeros(b, n, S, S, c)
    for i in range(b):
        for j in range(n):
            li = int(level[i, j])
            fmap = levels[li][i].float()
            ys, xs, (y0, ny, wy, my), (x0, nx, wx, mx) = _roi_windows(
                boxes[i, j].tolist(), fmap.shape[:2], 1.0 / STRIDES[NAMES[li]])
            if wy is None or wx is None:  # per-tap path
                out[i, j] = _per_tap_forward(fmap, ys, xs)
                continue
            for py in range(S):  # one warp a bin: its touched rows by its touched columns
                for px in range(S):
                    for r in (r for r in range(ny) if my[r] >> py & 1):
                        for x in (x for x in range(nx) if mx[x] >> px & 1):
                            out[i, j, py, px] += (wy[r, py] * wx[x, px]) * fmap[y0 + r, x0 + x]
            out[i, j] *= 1.0 / (R * R)
    return out


def _per_tap_forward(fmap, ys, xs):
    (vy, y0, y1, wy0, wy1), (vx, x0, x1, wx0, wx1) = ys, xs
    out = torch.zeros(S, S, fmap.shape[-1])
    for iy in range(S * R):
        for ix in range(S * R):
            if vy[iy] and vx[ix]:
                out[iy // R, ix // R] += (wy0[iy] * (wx0[ix] * fmap[y0[iy], x0[ix]] + wx1[ix] * fmap[y0[iy], x1[ix]])
                                          + wy1[iy] * (wx0[ix] * fmap[y1[iy], x0[ix]] + wx1[ix] * fmap[y1[iy], x1[ix]]))
    return out / (R * R)


def window_backward(grad, boxes, level, shapes):
    """K2 as the kernel computes it: one (B, H_l, W_l, C) f32 plane a level."""
    b, n = boxes.shape[:2]
    c = grad.shape[-1]
    planes = [torch.zeros(b, h, w, c) for h, w in shapes]
    for i in range(b):
        for j in range(n):
            li = int(level[i, j])
            plane = planes[li][i]
            g = grad[i, j].float()
            ys, xs, (y0, ny, wy, my), (x0, nx, wx, mx) = _roi_windows(
                boxes[i, j].tolist(), shapes[li], 1.0 / STRIDES[NAMES[li]])
            if wy is None or wx is None:  # per-tap path
                _per_tap_backward(plane, g, ys, xs)
                continue
            for x in range(nx):
                if not mx[x]:
                    continue
                a = torch.zeros(S, c)  # columns first
                for px in _bins_of(mx[x]):
                    a += (wx[x, px] * (1.0 / (R * R))) * g[:, px]
                for r in range(ny):  # then rows: one addition per touched cell
                    if my[r]:
                        plane[y0 + r, x0 + x] += sum(wy[r, p] * a[p] for p in _bins_of(my[r]))
    return planes


def _per_tap_backward(plane, g, ys, xs):
    (vy, y0, y1, wy0, wy1), (vx, x0, x1, wx0, wx1) = ys, xs
    g = g * (1.0 / (R * R))
    for iy in range(S * R):
        for ix in range(S * R):
            if vy[iy] and vx[ix]:
                gv = g[iy // R, ix // R]
                for yi, xi, w in ((y0[iy], x0[ix], wy0[iy] * wx0[ix]), (y0[iy], x1[ix], wy0[iy] * wx1[ix]),
                                  (y1[iy], x0[ix], wy1[iy] * wx0[ix]), (y1[iy], x1[ix], wy1[iy] * wx1[ix])):
                    plane[yi, xi] += w * gv


def _feats(c, b, h, w, seed=0):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(b, -(-h // s), -(-w // s), c).astype(np.float32))
            for s in (4, 8, 16, 32, 64)]


def _boxes(h, w, n=12, seed=1):
    rng = np.random.RandomState(seed)
    x1, y1 = rng.uniform(-10, w, (2, n)), rng.uniform(-10, h, (2, n))
    bw = np.exp(rng.uniform(np.log(2), np.log(300), (2, n)))
    bh = np.exp(rng.uniform(np.log(2), np.log(200), (2, n)))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    boxes[:, :10] = [
        [0, 0, 8, 8],  # top-left corner
        [w - 8, h - 8, w, h],  # bottom-right corner
        [w - 1.5, h - 1.2, w + 0.5, h + 0.3],  # samples in the [-1, dim] band
        [-7, -5, 3, 2],  # partly outside the band
        [30, 40, 30, 40],  # degenerate: a point
        [50, 20, 50.0001, 90],  # degenerate: a vertical line
        [2, 30, w - 2, 46],  # elongated: bumped from p2
        [40, 1, 52, h - 1],  # tall and thin: bumped
        [-300, -250, w + 300, h + 250],  # the coarsest levels
        [4, 6, w - 4, h - 7],  # most of the image
    ]
    return torch.from_numpy(boxes.astype(np.float32))


def _close(got, ref, tol=1e-6):
    return float((got - ref).abs().max()) <= tol * max(float(ref.abs().max()), 1.0)


def _case(h, w, boxes, c=8):
    levels = _feats(c, 2, h, w)
    level = assign_levels(boxes.reshape(-1, 4), NAMES).reshape(boxes.shape[:2])
    return levels, level


def test_window_forward_matches_plain():
    h, w = 128, 168
    boxes = _boxes(h, w)
    levels, level = _case(h, w, boxes)
    ref = roi_align_levels(levels, boxes, level, [1.0 / STRIDES[nm] for nm in NAMES], S, R)
    assert _close(window_forward(levels, boxes, level), ref)


def test_window_backward_matches_plain():
    h, w = 128, 168
    boxes = _boxes(h, w)
    levels, level = _case(h, w, boxes)
    shapes = [tuple(lv.shape[1:3]) for lv in levels]
    grad = torch.from_numpy(np.random.RandomState(2).randn(2, boxes.shape[1], S, S, 8).astype(np.float32))
    ref = roi_align_backward(grad, boxes, level, shapes, [1.0 / STRIDES[nm] for nm in NAMES], R, torch.float32)
    got = window_backward(grad, boxes, level, shapes)
    for g, r in zip(got, ref):
        assert _close(g, r)
    assert float(ref[0].abs().max()) > 0.5


def test_the_cases_are_exercised():
    """The boxes reach several levels, take the bump, sample in the band and
    outside it, and every window fits."""
    h, w = 128, 168
    boxes = _boxes(h, w)
    _, level = _case(h, w, boxes)
    flat, lvl = boxes.reshape(-1, 4), level.reshape(-1)
    area = ((flat[:, 2] - flat[:, 0]) * (flat[:, 3] - flat[:, 1])).clamp(min=1e-6)
    canonical = torch.floor(4 + torch.log2(area.sqrt() / 224 + 1e-8)).clamp(2, 6).long() - 2
    assert (lvl > canonical).sum() >= 4 and len(set(lvl.tolist())) >= 3
    outside = 0
    for box, li in zip(flat.tolist(), lvl.tolist()):
        shape = (-(-h // STRIDES[NAMES[li]]), -(-w // STRIDES[NAMES[li]]))
        ys, xs, wy, wx = _roi_windows(box, shape, 1.0 / STRIDES[NAMES[li]])
        assert wy[2] is not None and wx[2] is not None
        outside += int((~ys[0]).sum() + (~xs[0]).sum())
    assert outside > 0


@settings(max_examples=150, deadline=None)
@given(
    h=st.integers(32, 1344), w=st.integers(32, 1344),
    box=st.tuples(*[st.floats(-0.5, 1.5, allow_nan=False)] * 4),
    scale=st.floats(0.0, 1.0),
)
def test_taps_fit_the_window(h, w, box, scale):
    """On canvases up to 1344 px every ROI's taps on its assigned level span
    at most WINDOW_Y cells on each axis, whatever its size, aspect or
    position (boxes may leave the image): the level bump bounds the longest
    side to 30 cells, and at the top level the map itself is at most 21."""
    x1, y1 = box[0] * w, box[1] * h
    x2 = x1 + abs(box[2]) * w * scale + abs(box[2] - box[0]) * 64
    y2 = y1 + abs(box[3]) * h * scale + abs(box[3] - box[1]) * 64
    b = _f32([[x1, y1, x2, y2]])
    li = int(assign_levels(b, NAMES)[0])
    stride = STRIDES[NAMES[li]]
    for lo, hi, dim in ((y1, y2, h), (x1, x2, w)):
        _, extent, *_ = axis_window(axis_samples(lo, hi, 1.0 / stride, -(-dim // stride)))
        assert extent <= WINDOW_Y


def test_wide_rois_take_the_per_tap_path():
    """On a 128 x 2112 canvas, p6 is 33 cells wide: a ROI across it is clamped
    at the top level and its taps span 33 cells, more than the window. The
    per-tap path pools and scatters it as the plain versions do."""
    h, w = 128, 2112
    boxes = _boxes(h, w, n=10)
    boxes[:, :2] = _f32([[[0, 0, 2112, 128], [20, 5, 2090, 120]], [[3, 40, 2110, 90], [0, 0, 2112, 128]]])
    levels, level = _case(h, w, boxes)
    assert (level[:, :2] == 4).all()
    spans = [axis_window(axis_samples(bx[0], bx[2], 1 / 64, 33))[1] for bx in boxes[:, :2].reshape(-1, 4).tolist()]
    assert min(spans) > WINDOW_Y
    scales = [1.0 / STRIDES[nm] for nm in NAMES]
    ref = roi_align_levels(levels, boxes, level, scales, S, R)
    assert _close(window_forward(levels, boxes, level), ref)
    shapes = [tuple(lv.shape[1:3]) for lv in levels]
    grad = torch.from_numpy(np.random.RandomState(3).randn(2, 10, S, S, 8).astype(np.float32))
    for g, r in zip(window_backward(grad, boxes, level, shapes),
                    roi_align_backward(grad, boxes, level, shapes, scales, R, torch.float32)):
        assert _close(g, r)
