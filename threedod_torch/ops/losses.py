"""Loss primitives with masks (counterpart of ``threedod/ops/losses.py``):
padding slots contribute zero. The dice loss has no caller in either
package and is not ported.

Under a process group a masked mean is this rank's share of the global
batch's: its rows' sum over the count of masked entries summed over the
ranks (``parallel.dist.all_sum``), so the shares of the ranks add up to the
mean over the global batch."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..parallel import dist


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy over masked entries (with a mask, this
    rank's share of the global batch's mean). labels int (N,),
    logits (N, C); labels are clipped into range (masked rows may hold any)."""
    labels_safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1, labels_safe[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / dist.all_sum(mask.sum()).clamp(min=1.0)


def binary_cross_entropy_with_logits(logits, targets, weight=None, reduction: str = "none"):
    loss = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if weight is not None:
        loss = loss * weight
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    return loss


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0, reduction: str = "none"):
    """torchvision's ``sigmoid_focal_loss``: the binary cross-entropy of
    ``logits`` against ``targets``, scaled by (1 - p_t) ** gamma and, for
    ``alpha`` >= 0, by alpha_t."""
    p = torch.sigmoid(logits)
    ce = binary_cross_entropy_with_logits(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    if reduction == "sum":
        return loss.sum()
    if reduction == "mean":
        return loss.mean()
    return loss


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 0.0) -> torch.Tensor:
    diff = (pred - target).abs()
    if beta <= 0:
        return diff
    return torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)


def safely_reduce_losses(loss: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean over finite (and masked) entries (the global batch's, as this
    rank's share); 0 if there is none."""
    finite = torch.isfinite(loss)
    if mask is not None:
        finite = finite & mask
    w = finite.to(loss.dtype)
    safe = torch.where(finite, loss, torch.zeros_like(loss))
    return (safe * w).sum() / dist.all_sum(w.sum()).clamp(min=1.0)
