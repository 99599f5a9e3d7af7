"""Metric-depth fine-tuning of Depth-Anything-V2: loss, metrics, optimizer and
trainer (counterpart of ``threedod/train/depth.py``).

* SiLog loss over the valid-depth mask, with the JAX package's guards: depths
  clamped at 1e-6 before the log, the variance term floored at 1e-12;
* AdamW with two parameter groups: the encoder (``pretrained.*``) at the base
  LR, everything else (the DPT head) at 10x; weight decay 0.01 on every
  parameter, betas (0.9, 0.999), eps 1e-8;
* polynomial decay ``lr = base * (1 - it / total) ** 0.9``, set before step
  ``it`` from the count of updates already made (optax's schedule count:
  the first update runs at the base LR);
* a whole-batch random horizontal flip with p = 0.5, drawn from an explicit
  ``torch.Generator``;
* masked per-image metrics (d1, d2, d3, abs_rel, sq_rel, rmse, rmse_log,
  log10, silog), images with fewer than ``MIN_VALID_PIXELS`` valid pixels
  skipped, the prediction resized with ``align_corners=True`` when its size
  is not the target's;
* one overwritten ``latest.pt`` an epoch holding the model, the optimizer,
  the step, the epoch and ``previous_best``.

The JAX package's jitted steps are forms for its compiler and are not
ported; its device mesh is (``parallel.dist``): under a process group each
rank takes its rows of every global batch, SiLog's two moments and its count
are summed over the ranks before the square root, every rank backpropagates
the (replicated) loss over the world size, the gradients are summed over
the ranks, and the metrics' sums and counts are summed over the ranks. The
whole-batch flip is one draw of a generator every rank seeds alike. On the
card the ViT's attention at 2048 tokens and more is kernel K9 forward and
backward (``ops/attention.py``).
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np
import torch

from ..models.depth.dpt import resize_align_corners
from ..parallel import dist
from .checkpoint import CheckpointManager

logger = logging.getLogger(__name__)

MIN_VALID_PIXELS = 10  # images with fewer valid pixels are left out of the metrics
HEAD_LR_SCALE = 10.0


# ---------------------------------------------------------------------------
# loss and metrics (masked, static shape)
# ---------------------------------------------------------------------------

def _masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    """Over ``dim``, or with no ``dim`` over the whole (global) batch."""
    if dim is None:
        return dist.all_sum(torch.where(mask, x, 0.0).sum()) / dist.all_sum(mask.sum()).clamp(min=1)
    return torch.where(mask, x, 0.0).sum(dim) / mask.sum(dim).clamp(min=1)


def silog_loss(pred: torch.Tensor, target: torch.Tensor, valid_mask: torch.Tensor,
               lambd: float = 0.5) -> torch.Tensor:
    """sqrt(mean(d^2) - lambd * mean(d)^2) over the valid pixels of the whole
    (global) batch, d = log(target) - log(pred); invalid pixels flow through
    masked."""
    mask = valid_mask.bool()
    d = torch.log(target.clamp(min=1e-6)) - torch.log(pred.clamp(min=1e-6))
    m2 = _masked_mean(d * d, mask)
    m1 = _masked_mean(d, mask)
    return torch.sqrt((m2 - lambd * m1 * m1).clamp(min=1e-12))


def eval_depth(pred: torch.Tensor, target: torch.Tensor, valid_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Masked depth metrics of each image: (..., H, W) -> {name: (...)}."""
    mask = valid_mask.bool()
    p = pred.clamp(min=1e-6)
    t = target.clamp(min=1e-6)
    thresh = torch.maximum(t / p, p / t)
    diff = p - t
    diff_log = torch.log(p) - torch.log(t)

    def m(x):
        return _masked_mean(x, mask, dim=(-2, -1))

    silog_m2, silog_m1 = m(diff_log ** 2), m(diff_log)
    return {
        "d1": m((thresh < 1.25).float()),
        "d2": m((thresh < 1.25 ** 2).float()),
        "d3": m((thresh < 1.25 ** 3).float()),
        "abs_rel": m(diff.abs() / t),
        "sq_rel": m(diff ** 2 / t),
        "rmse": torch.sqrt(m(diff ** 2)),
        "rmse_log": torch.sqrt(m(diff_log ** 2)),
        "log10": m((torch.log10(p) - torch.log10(t)).abs()),
        "silog": torch.sqrt((silog_m2 - 0.5 * silog_m1 ** 2).clamp(min=1e-12)),
    }


# ---------------------------------------------------------------------------
# optimizer: two groups (encoder x1, head x10) and poly decay
# ---------------------------------------------------------------------------

def poly_schedule(base_lr: float, total_iters: int, power: float = 0.9):
    """lr(count) = base * (1 - count / total) ** power, count clipped to [0, total]."""

    def schedule(count: int) -> float:
        return host_poly_lr(base_lr, total_iters, count, power)

    return schedule


def host_poly_lr(base_lr: float, total_iters: int, iteration: int, power: float = 0.9) -> float:
    frac = min(max(iteration / max(total_iters, 1), 0.0), 1.0)
    return float(base_lr * (1.0 - frac) ** power)


def build_depth_optimizer(model: torch.nn.Module, base_lr: float, weight_decay: float = 0.01) -> torch.optim.AdamW:
    """AdamW over two groups: parameters under ``pretrained.`` at ``base_lr``,
    the others at 10x. Each group keeps its ``base_lr`` for the schedule."""
    enc, head = [], []
    for name, p in model.named_parameters():
        (enc if name.startswith("pretrained.") else head).append(p)
    groups = [dict(params=enc, lr=base_lr, base_lr=base_lr),
              dict(params=head, lr=base_lr * HEAD_LR_SCALE, base_lr=base_lr * HEAD_LR_SCALE)]
    return torch.optim.AdamW([g for g in groups if g["params"]], betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def set_poly_lr(optimizer: torch.optim.Optimizer, total_iters: int, count: int) -> None:
    """Each group's LR for the update after ``count`` updates."""
    for group in optimizer.param_groups:
        group["lr"] = host_poly_lr(group["base_lr"], total_iters, count)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _tensor(x, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device=device, dtype=dtype)


class DepthTrainer:
    """Fine-tunes a ``DepthAnythingV2`` on (image (B, H, W, 3) normalised,
    depth (B, H, W), valid_mask (B, H, W)) batches, as numpy arrays or
    tensors. ``device`` defaults to the first CUDA device; pass
    ``torch.device("cpu")`` to run on the CPU."""

    def __init__(self, model: torch.nn.Module, device: Optional[torch.device] = None, base_lr: float = 5e-6,
                 total_iters: int = 1000, min_depth: float = 0.001, max_depth: float = 20.0):
        self.device = torch.device("cuda", 0) if device is None else torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("the depth trainer runs on a CUDA device; none is available (pass device='cpu')")
        self.model = model.to(self.device).train()
        self.base_lr = base_lr
        self.total_iters = total_iters
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.optimizer = build_depth_optimizer(self.model, base_lr)
        # every parameter holds a gradient, zero where the loss does not reach
        # it, so that weight decay acts on it as optax's AdamW does
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                p.grad = torch.zeros_like(p)
        self.step = 0  # updates made: the schedule's count
        self.last_loss: Optional[torch.Tensor] = None

    def _batch(self, image, depth, valid_mask):
        """This rank's rows of a global batch, on the device."""
        return (_tensor(dist.local_rows(image), self.device, torch.float32),
                _tensor(dist.local_rows(depth), self.device, torch.float32),
                _tensor(dist.local_rows(valid_mask), self.device, torch.bool))

    def _mask(self, depth: torch.Tensor, valid_mask: torch.Tensor) -> torch.Tensor:
        return valid_mask & (depth >= self.min_depth) & (depth <= self.max_depth)

    def train_step(self, image, depth, valid_mask, flip: bool) -> torch.Tensor:
        """One update on a batch, flipped along its width when ``flip``;
        returns the loss (a 0-d tensor on the device, not read back)."""
        image, depth, valid_mask = self._batch(image, depth, valid_mask)
        if flip:
            image, depth, valid_mask = image.flip(2), depth.flip(2), valid_mask.flip(2)
        mask = self._mask(depth, valid_mask)
        set_poly_lr(self.optimizer, self.total_iters, self.step)
        self.optimizer.zero_grad(set_to_none=False)
        pred = self.model(image.permute(0, 3, 1, 2))
        loss = silog_loss(pred, depth, mask)
        # every rank holds the global loss: the ranks' gradients, summed, are its own
        (loss / dist.world_size() if dist.active() else loss).backward()
        dist.allreduce_grads([p.grad for g in self.optimizer.param_groups for p in g["params"]])
        self.optimizer.step()
        self.step += 1
        self.last_loss = loss.detach()
        return self.last_loss

    @torch.no_grad()
    def eval_step(self, image, depth, valid_mask):
        """({metric: sum over this rank's kept images}, their number), on
        the device."""
        image, depth, valid_mask = self._batch(image, depth, valid_mask)
        pred = self.model(image.permute(0, 3, 1, 2))
        if pred.shape != depth.shape:
            pred = resize_align_corners(pred[:, None], depth.shape[1], depth.shape[2])[:, 0]
        mask = self._mask(depth, valid_mask)
        per_image = eval_depth(pred, depth, mask)
        keep = (mask.sum((1, 2)) >= MIN_VALID_PIXELS).float()
        return {k: (v * keep).sum() for k, v in per_image.items()}, keep.sum()

    def evaluate(self, val_loader) -> Dict[str, float]:
        totals: Dict[str, torch.Tensor] = {}
        nsamples = torch.zeros((), device=self.device)
        for sample in val_loader:
            sums, n = self.eval_step(sample["image"], sample["depth"], sample["valid_mask"])
            for k, v in sums.items():
                totals[k] = totals.get(k, 0.0) + v
            nsamples = nsamples + n
        if totals and dist.active():  # the ranks' sums and counts, summed
            keys = sorted(totals)
            summed = dist.all_sum(torch.stack([totals[k] for k in keys] + [nsamples])).tolist()
            totals, nsamples = dict(zip(keys, summed[:-1])), summed[-1]
        denom = max(float(nsamples), 1.0)
        return {k: float(v) / denom for k, v in totals.items()}

    def fit(self, train_loader, epochs: int, val_loader=None, save_path: Optional[str] = None, seed: int = 0,
            log_every: int = 100) -> Dict[str, float]:
        """The epoch loop: a flip drawn for every batch, a log line every
        ``log_every`` steps, evaluation and ``latest.pt`` after each epoch.
        Returns the best metrics seen (``previous_best``)."""
        ckpt = CheckpointManager(save_path, period=10 ** 9, max_iter=10 ** 9) if save_path is not None else None
        previous_best = ({k: 0.0 for k in ("d1", "d2", "d3")}
                         | {k: 100.0 for k in ("abs_rel", "sq_rel", "rmse", "rmse_log", "log10", "silog")})
        gen = torch.Generator().manual_seed(seed)
        for epoch in range(epochs):
            for sample in train_loader:
                it = self.step
                flip = bool(torch.rand((), generator=gen) < 0.5)
                loss = self.train_step(sample["image"], sample["depth"], sample["valid_mask"], flip)
                if it % log_every == 0:
                    logger.info("Epoch %d iter %d LR %.7f loss %.3f", epoch, it,
                                host_poly_lr(self.base_lr, self.total_iters, it), float(loss))
            if val_loader is not None:
                results = self.evaluate(val_loader)
                logger.info("eval @ epoch %d: %s", epoch, {k: round(v, 3) for k, v in results.items()})
                for k, v in results.items():
                    previous_best[k] = max(previous_best[k], v) if k in ("d1", "d2", "d3") else min(previous_best[k], v)
            if ckpt is not None:
                ckpt.save("latest", {"model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
                                     "step": self.step, "epoch": epoch, "previous_best": dict(previous_best)})
        return previous_best
