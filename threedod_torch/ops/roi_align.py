"""Multilevel ROIAlignV2 forward and backward, plain PyTorch (counterpart of
``threedod/ops/roi_align.py::multilevel_roi_align_windowed`` at
``window=WINDOW_Y``, the function the JAX package pools with on the CPU and
that its Pallas kernels ``roi_align_pallas.py::_kernel`` and ``_bwd_kernel``
compute on a TPU).

These are the plain versions of kernels K1 (``csrc/roi_align_fwd.cu``) and K2
(``csrc/roi_align_bwd.cu``): the CPU path, and what ``chip_smoke.py`` holds
the kernels against on the card. Taps are read and written by direct
indexing; the TPU window, stacked plane and selector matmuls are layout and
are not ported.

Per ROI:
  * level: detectron2's ``floor(4 + log2(sqrt(area)/224 + 1e-8))`` clipped
    to the pyramid, then raised until the ROI's longest side fits the TPU
    kernel's 30-cell tap budget (``WINDOW_Y - 2``), so every path pools the
    same level;
  * aligned coordinates ``box * (1/stride) - 0.5``, box size floored at
    1e-6, ``r`` samples per bin edge at ``(k + 0.5) / r`` of the bin;
  * the ROIAlignV2 border rule: a sample is zero outside [-1, dim]; inside
    that band it clamps into [0, dim-1];
  * the r x r bilinear samples of each bin are averaged.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

STRIDES = {"p2": 4, "p3": 8, "p4": 16, "p5": 32, "p6": 64}
# rows of the TPU kernel's ROI window (roi_align_pallas.py WINDOW_Y); its
# 30-cell tap budget decides the level bump that every path applies
WINDOW_Y = 32


def assign_levels(boxes: torch.Tensor, names: List[str], window: int = WINDOW_Y) -> torch.Tensor:
    """(M, 4) boxes -> (M,) int64 index into ``names`` (sorted 'p2'..'p6')."""
    lmin, lmax = int(names[0][1:]), int(names[-1][1:])
    area = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])).clamp(min=1e-6)
    lvl = torch.floor(4 + torch.log2(torch.sqrt(area) / 224.0 + 1e-8))
    assign = lvl.clamp(lmin, lmax).long() - lmin
    ext = torch.maximum(boxes[:, 2] - boxes[:, 0], boxes[:, 3] - boxes[:, 1])
    ext_cells = ext / float(STRIDES[names[0]])
    need = torch.ceil(torch.log2((ext_cells / (window - 2)).clamp(min=1e-6)))
    return torch.maximum(assign, need.clamp(0, lmax - lmin).long())


def _axis(coords: torch.Tensor, limit: int):
    """Sample coords -> (band mask, tap0, tap1, frac); tap1 clamps into the
    map (its weight is 0 whenever the clamp bites)."""
    band = (coords >= -1.0) & (coords <= float(limit))
    cc = coords.clamp(0.0, limit - 1.0)
    f0 = torch.floor(cc)
    i0 = f0.long()
    return band, i0, (i0 + 1).clamp(max=limit - 1), cc - f0


def _grid(s: int, r: int, device):
    """(s_t, sample offsets (s*r,)): bin edge count as a tensor, and the
    sample positions in bins, (k + 0.5) / r.

    Divisors are held in tensors: PyTorch's CUDA division by a Python scalar
    multiplies by its reciprocal, which rounds the sample coordinates
    differently from a true division (the CPU's, the kernels', XLA's)."""
    s_t, r_t = (torch.tensor(float(v), device=device) for v in (s, r))
    return s_t, (torch.arange(s * r, device=device, dtype=torch.float32) + 0.5) / r_t


def _level_taps(boxes: torch.Tensor, scale: float, h: int, w: int, s_t, grid):
    """Sample geometry of ROIs (m, 4) on one level: per axis the band mask,
    both taps and the fraction towards the second, each (m, s*r)."""
    bx = boxes * scale - 0.5
    x1, y1 = bx[:, 0], bx[:, 1]
    bw = (bx[:, 2] - x1).clamp(min=1e-6)
    bh = (bx[:, 3] - y1).clamp(min=1e-6)
    sx = x1[:, None] + grid[None, :] * (bw / s_t)[:, None]
    sy = y1[:, None] + grid[None, :] * (bh / s_t)[:, None]
    return _axis(sy, h), _axis(sx, w)


def roi_align_levels(
    levels: List[torch.Tensor],
    boxes: torch.Tensor,
    level: torch.Tensor,
    scales: List[float],
    output_size: int,
    sampling_ratio: int,
) -> torch.Tensor:
    """levels: per pyramid level (B, H_l, W_l, C); boxes (B, N, 4) f32;
    level (B, N) index into ``levels``. Returns (B, N, S, S, C) in the
    features' dtype, computed in f32."""
    b, n = boxes.shape[:2]
    c = levels[0].shape[-1]
    s, r = output_size, sampling_ratio
    flat_boxes = boxes.reshape(-1, 4).float()
    flat_level = level.reshape(-1)
    img = torch.arange(b, device=boxes.device).repeat_interleave(n)
    s_t, grid = _grid(s, r, boxes.device)
    out = torch.zeros((b * n, s, s, c), dtype=torch.float32, device=boxes.device)
    for li, fmap in enumerate(levels):
        sel = (flat_level == li).nonzero(as_tuple=True)[0]
        if sel.numel() == 0:
            continue
        h, w = fmap.shape[1], fmap.shape[2]
        (band_y, y0, y1i, fy), (band_x, x0, x1i, fx) = _level_taps(flat_boxes[sel], scales[li], h, w, s_t, grid)
        bi = img[sel][:, None, None]
        dy = fy[:, :, None, None]
        dx = fx[:, None, :, None]

        def tap(yi, xi):
            return fmap[bi, yi[:, :, None], xi[:, None, :]].float()  # (m, sr, sr, C)

        val = tap(y0, x0) * (1 - dy) * (1 - dx)
        val += tap(y0, x1i) * (1 - dy) * dx
        val += tap(y1i, x0) * dy * (1 - dx)
        val += tap(y1i, x1i) * dy * dx
        val *= (band_y[:, :, None] & band_x[:, None, :])[..., None]
        out[sel] = val.reshape(-1, s, r, s, r, c).mean(dim=(2, 4))
    return out.to(levels[0].dtype).reshape(b, n, s, s, c)


def roi_align_backward(
    grad: torch.Tensor,
    boxes: torch.Tensor,
    level: torch.Tensor,
    shapes: List[Tuple[int, int]],
    scales: List[float],
    sampling_ratio: int,
    dtype: torch.dtype,
) -> List[torch.Tensor]:
    """Gradient of ``roi_align_levels`` with respect to its levels.

    grad (B, N, S, S, C), the cotangent of the pooled block; boxes (B, N, 4);
    level (B, N); ``shapes`` the (H_l, W_l) of each level. Returns one
    (B, H_l, W_l, C) tensor per level in ``dtype``, accumulated in f32: each
    bin's cotangent, divided by its r*r samples, goes back to the four taps
    of every sample with the forward's weights, border rule and level. A
    level no ROI pooled from comes back as zeros. Boxes get no gradient."""
    b, n, s, _, c = grad.shape
    r = sampling_ratio
    flat_boxes = boxes.reshape(-1, 4).float()
    flat_level = level.reshape(-1)
    flat_grad = grad.reshape(b * n, s, s, c).float()
    img = torch.arange(b, device=boxes.device).repeat_interleave(n)
    s_t, grid = _grid(s, r, boxes.device)
    out = []
    for li, (h, w) in enumerate(shapes):
        acc = torch.zeros((b * h * w, c), dtype=torch.float32, device=boxes.device)
        sel = (flat_level == li).nonzero(as_tuple=True)[0]
        if sel.numel():
            (band_y, y0, y1i, fy), (band_x, x0, x1i, fx) = _level_taps(flat_boxes[sel], scales[li], h, w, s_t, grid)
            # every sample of a bin receives the bin's cotangent / (r*r)
            g = flat_grad[sel] / float(r * r)
            g = g.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)  # (m, sr, sr, C)
            g = g * (band_y[:, :, None] & band_x[:, None, :])[..., None]
            base = img[sel][:, None, None] * (h * w)
            dy = fy[:, :, None, None]
            dx = fx[:, None, :, None]
            for yi, xi, wgt in (
                (y0, x0, (1 - dy) * (1 - dx)), (y0, x1i, (1 - dy) * dx),
                (y1i, x0, dy * (1 - dx)), (y1i, x1i, dy * dx),
            ):
                cell = base + yi[:, :, None] * w + xi[:, None, :]  # (m, sr, sr)
                acc.index_add_(0, cell.reshape(-1), (g * wgt).reshape(-1, c))
        out.append(acc.to(dtype).reshape(b, h, w, c))
    return out


def multilevel_roi_align(
    features: Dict[str, torch.Tensor],
    boxes: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """features {'p2'..'p6'}: (B, C, H_l, W_l); boxes (B, N, 4) in image
    coordinates -> (B, N, S, S, C) in the features' dtype."""
    names = sorted(features)
    level = assign_levels(boxes.reshape(-1, 4).float(), names).reshape(boxes.shape[:2])
    return roi_align_levels(
        [features[nm].permute(0, 2, 3, 1) for nm in names],
        boxes, level, [1.0 / STRIDES[nm] for nm in names],
        output_size, sampling_ratio,
    )
