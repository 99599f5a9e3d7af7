"""Shared conv/norm building blocks (counterpart of
``threedod/models/backbones/layers.py``), NCHW tensors.

Parameters stay f32. At inference a ConvBN folds the BatchNorm into the
convolution in f32 (kernel scaled by gamma/sigma, shift turned into a conv
bias) and only then casts weight and bias to the compute dtype, as the JAX
package's eval branch does, so the block is one convolution with a bias.

In training the convolution runs in the compute dtype with the raw kernel;
the batch mean and mean of squares are taken in f32 over (N, H, W), so the
variance is the biased one; the normalisation is applied in the compute
dtype with the folded per-channel scale and shift. This is not
``torch.nn.BatchNorm2d``, which normalises in f32 and feeds its running
variance the unbiased estimate.

DenseNet's norms stand alone, before their convolution (``batch_norm``): they
normalise in f32 whatever the input's dtype, and their running statistics
move with momentum 0.99, so the momentum is a field of the holder.

Under a process group the batch statistics are the global batch's: each
rank's per-channel means of x and x^2 are averaged over the ranks, which
hold as many elements each (``parallel.dist.batch_moments``), so every rank
folds the same statistics into its running ones.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...parallel import dist


def conv_layer(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1) -> nn.Conv2d:
    """A bias-free convolution padded to keep the size at stride 1 (the conv
    of a ConvBN; its norm is a ``BatchNorm2d`` beside it)."""
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, groups=groups, bias=False)


class BatchNorm2d(nn.Module):
    """BatchNorm state under detectron2's names: trainable ``weight`` and
    ``bias``, buffers ``running_mean`` and ``running_var``. It only holds
    them: ``conv_bn`` applies the normalisation. A training forward leaves
    its batch statistics in ``batch_stats`` and does not touch the running
    ones; ``update_running_stats`` folds them in once the step is accepted:
    ``running = momentum * running + (1 - momentum) * batch``."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.batch_stats = None  # (mean, biased var) of the last training forward


def fold_convbn(conv: nn.Conv2d, bn: BatchNorm2d):
    """(w, b) in f32 with conv(x, w) + b == bn(conv(x)) on the running statistics."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    w = conv.weight.float() * s[:, None, None, None]
    b = bn.bias.float() - bn.running_mean.float() * s
    return w, b


def conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn: BatchNorm2d, relu: bool = True) -> torch.Tensor:
    """ConvBN [+ ReLU] at the dtype of ``x``. Eval (``bn.training`` false):
    fold in f32, then cast. Training: batch statistics, as the module
    docstring says."""
    kw = dict(stride=conv.stride, padding=conv.padding, dilation=conv.dilation, groups=conv.groups)
    if not bn.training:
        w, b = fold_convbn(conv, bn)
        y = F.conv2d(x, w.to(x.dtype), b.to(x.dtype), **kw)
    else:
        y = F.conv2d(x, conv.weight.to(x.dtype), None, **kw)
        m, sq = dist.batch_moments(y.float(), (0, 2, 3))
        v = sq - m.square()
        bn.batch_stats = (m.detach(), v.detach())
        a = bn.weight * torch.rsqrt(v + bn.eps)
        y = y * a.to(x.dtype)[None, :, None, None] + (bn.bias - m * a).to(x.dtype)[None, :, None, None]
    return F.relu(y) if relu else y


def batch_norm(x: torch.Tensor, bn: BatchNorm2d, relu: bool = True) -> torch.Tensor:
    """A BatchNorm on its own [+ ReLU], in f32 whatever the dtype of ``x``;
    returns f32 (the caller casts after the relu). Training: batch mean and
    biased variance (mean of squares less the squared mean) over (N, H, W)."""
    xf = x.float()
    if not bn.training:
        m, v = bn.running_mean, bn.running_var
    else:
        m, sq = dist.batch_moments(xf, (0, 2, 3))
        v = sq - m.square()
        bn.batch_stats = (m.detach(), v.detach())
    a = bn.weight * torch.rsqrt(v + bn.eps)
    y = (xf - m[None, :, None, None]) * a[None, :, None, None] + bn.bias[None, :, None, None]
    return F.relu(y) if relu else y


def max_pool(x: torch.Tensor, window: int, stride: int, padding: int = 0) -> torch.Tensor:
    """Max pooling padded with -inf; window 1 is the plain subsample."""
    if window == 1:
        return x[:, :, ::stride, ::stride]
    return F.max_pool2d(x, window, stride, padding)


@torch.no_grad()
def update_running_stats(model: nn.Module, discard: bool = False) -> None:
    """Fold every BatchNorm's last batch statistics into its running ones
    (each with its own momentum, biased variance), in place; with ``discard``
    only drop them (a skipped step, frozen statistics)."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d) and m.batch_stats is not None]
    if not discard:
        for momentum in {m.momentum for m in bns}:
            group = [m for m in bns if m.momentum == momentum]
            for which, name in ((0, "running_mean"), (1, "running_var")):
                running = [getattr(m, name) for m in group]
                torch._foreach_mul_(running, momentum)
                torch._foreach_add_(running, [m.batch_stats[which] for m in group], alpha=1.0 - momentum)
    for m in bns:
        m.batch_stats = None


def conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    """A biased conv at the dtype of ``x`` (f32 parameters cast down)."""
    return F.conv2d(
        x, layer.weight.to(x.dtype), layer.bias.to(x.dtype),
        stride=layer.stride, padding=layer.padding,
    )
