"""Proposal/anchor <-> ground-truth matching and IoU-weighted subsampling
(counterpart of ``threedod/ops/matcher.py``).

detectron2's Matcher with ``allow_low_quality_matches`` as the RPN configures
it, and IoU-weighted sampling without replacement by the Gumbel top-k trick.
Functions take one image: candidates (R, 4) against padded ground truth
(M, 4).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..geometry.boxes2d import box_area, pairwise_intersection, pairwise_iou
from .order_stats import top_take_mask


class MatchResult(NamedTuple):
    matched_idxs: torch.Tensor  # (R,) best gt index per candidate
    matched_labels: torch.Tensor  # (R,) -1 ignore / 0 bg / 1 fg
    matched_ious: torch.Tensor  # (R,) IoU with the matched gt
    forced: torch.Tensor  # (R,) candidate is some gt's argmax anchor (allow_low_quality)


def match_candidates(
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    candidates: torch.Tensor,
    bg_thresh: float,
    fg_thresh: float,
    allow_low_quality: bool = False,
    iou: Optional[torch.Tensor] = None,
) -> MatchResult:
    """Labels: iou < bg_thresh -> 0; bg_thresh <= iou < fg_thresh -> -1;
    iou >= fg_thresh -> 1. With ``allow_low_quality`` each valid gt's best
    candidates are forced foreground. A precomputed (M, R) IoU matrix may be
    passed in."""
    if iou is None:
        iou = pairwise_iou(gt_boxes, candidates)
    iou = torch.where(gt_valid[:, None], iou, torch.full_like(iou, -1.0))
    matched_ious, matched_idxs = iou.max(dim=0)  # first maximum, as argmax

    labels = torch.where(matched_ious >= fg_thresh, 1, torch.where(matched_ious < bg_thresh, 0, -1))
    forced = torch.zeros(candidates.shape[0], dtype=torch.bool, device=candidates.device)
    if allow_low_quality:
        best_per_gt = iou.amax(dim=1, keepdim=True)
        forced = ((iou >= best_per_gt) & gt_valid[:, None] & (best_per_gt > 0)).any(0)
        labels = torch.where(forced, 1, labels)

    any_gt = gt_valid.any()  # no gt at all -> everything is background
    labels = torch.where(any_gt, labels, torch.zeros_like(labels))
    matched_ious = torch.where(any_gt, matched_ious.clamp(min=0.0), torch.zeros_like(matched_ious))
    return MatchResult(matched_idxs, labels, matched_ious, forced)


def match_and_ignore(
    gt_boxes: torch.Tensor,
    gt_valid: torch.Tensor,
    gt_is_ignore: torch.Tensor,
    candidates: torch.Tensor,
    bg_thresh: float,
    fg_thresh: float,
    ignore_thresh: float,
    allow_low_quality: bool = False,
) -> Tuple[MatchResult, torch.Tensor]:
    """Matcher and ignore-region test over one (M, R) intersection matrix.

    Returns (MatchResult, in_ignore (R,) bool). Callers apply the ignore
    mask after subsampling: ``labels = where(in_ignore & (labels == 0), -1,
    labels)``."""
    inter = pairwise_intersection(gt_boxes, candidates)
    a_cand = box_area(candidates)[None, :]
    union = box_area(gt_boxes)[:, None] + a_cand - inter
    zero = torch.zeros_like(inter)
    iou = torch.where(union > 0, inter / union.clamp(min=1e-12), zero)
    m = match_candidates(gt_boxes, gt_valid, candidates, bg_thresh, fg_thresh,
                         allow_low_quality=allow_low_quality, iou=iou)
    ioa = torch.where(a_cand > 0, inter / a_cand.clamp(min=1e-12), zero)
    ioa = torch.where(gt_is_ignore[:, None], ioa, zero)
    in_ignore = gt_is_ignore.any() & (ioa.amax(dim=0) >= ignore_thresh)
    return m, in_ignore


def gumbel_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel draws, made on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    tiny = torch.finfo(torch.float32).tiny
    return (-torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2.0 ** -24)))).to(device)


def subsample_fg_bg(
    noise: Union[torch.Generator, Tuple[torch.Tensor, torch.Tensor]],
    labels: torch.Tensor,
    matched_ious: torch.Tensor,
    num_samples: int,
    positive_fraction: float,
    eps: float = 1e-4,
):
    """IoU-weighted fg/bg subsampling with a static output size.

    ``noise`` is a ``torch.Generator``, or the two (R,) Gumbel noise vectors
    (foreground, background) themselves. Returns (indices (num_samples,),
    is_fg, valid). Foreground and background are each drawn without
    replacement with probability proportional to matched_iou + eps; selected
    foreground always fills the leading slots, in descending key order, and
    the unfilled tail keeps index order (a stable sort)."""
    r = labels.shape[0]
    if isinstance(noise, torch.Generator):
        g_fg = gumbel_noise(noise, (r,), labels.device)
        g_bg = gumbel_noise(noise, (r,), labels.device)
    else:
        g_fg, g_bg = noise
    k_fg_max = int(num_samples * positive_fraction)
    is_fg = labels == 1
    is_bg = labels == 0
    logw = torch.log(matched_ious + eps)
    neg_inf = torch.full_like(logw, float("-inf"))

    fg_val = logw + g_fg
    fg_key = torch.where(is_fg, fg_val, neg_inf)
    fg_take = is_fg.sum().clamp(max=k_fg_max)
    if k_fg_max > 0:
        fg_selected = top_take_mask(fg_val[None], is_fg[None], fg_take[None])[0]
    else:
        fg_selected = torch.zeros_like(is_fg)

    bg_val = logw + g_bg
    bg_key = torch.where(is_bg, bg_val, neg_inf)
    bg_take = torch.minimum(is_bg.sum(), num_samples - fg_take)
    bg_selected = top_take_mask(bg_val[None], is_bg[None], bg_take[None])[0]

    # priority: foreground first (by key), then background (by key)
    prio = torch.where(fg_selected, 1e9 + fg_key, torch.where(bg_selected, bg_key, neg_inf))
    vals, idx = torch.sort(prio, descending=True, stable=True)
    vals, idx = vals[:num_samples], idx[:num_samples]
    valid = torch.isfinite(vals)
    return idx, fg_selected[idx] & valid, valid
