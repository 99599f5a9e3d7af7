"""Loss primitives with masks (counterpart of ``threedod/ops/losses.py``):
padding slots contribute zero. The focal and dice losses of the weak method
are not ported yet."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy over masked entries. labels int (N,),
    logits (N, C); labels are clipped into range (masked rows may hold any)."""
    labels_safe = labels.long().clamp(0, logits.shape[-1] - 1)
    nll = -torch.gather(F.log_softmax(logits, dim=-1), -1, labels_safe[..., None])[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.to(nll.dtype)
    return (nll * mask).sum() / mask.sum().clamp(min=1.0)


def binary_cross_entropy_with_logits(logits, targets, weight=None, reduction: str = "none"):
    loss = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if weight is not None:
        loss = loss * weight
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
    """Mean over finite (and masked) entries; 0 if there is none."""
    finite = torch.isfinite(loss)
    if mask is not None:
        finite = finite & mask
    w = finite.to(loss.dtype)
    safe = torch.where(finite, loss, torch.zeros_like(loss))
    return (safe * w).sum() / w.sum().clamp(min=1.0)
