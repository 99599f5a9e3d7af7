"""ResNet trunks 18/34/50/101 (counterpart of
``threedod/models/backbones/resnet.py``).

torchvision's topology re-exposed as a 5-level extractor {p2: s4, p3: s8,
p4: s16, p5: s32, p6: s64}, with p6 the stride-2 subsample of p5. Module
names are torchvision's (``conv1``, ``bn1``, ``layer{s}.{i}.conv{k}``,
``bn{k}``, ``downsample.{0,1}``), so a trunk's ``state_dict()`` reads like a
torchvision checkpoint without the classifier. The JAX package's
space-to-depth stem is a TPU layout of the same arithmetic and is not ported.

In eval, with ``ops.fused_conv`` switched on, a ``ResBasicBlock`` runs as one
kernel: a stride-1 block without downsample as K4 (``fused_basic_block``),
a stride-2 block with its 1x1 stride-2 downsample on even input dims as K6
(``fused_block_down`` with the subsampled, projected residual). On the card
a K4 block folds and packs its weights once and keeps them
(``ResBasicBlock.fused_weights``) until a conv or BatchNorm tensor changes
(``load_state_dict``, an in-place update), moves or changes dtype; training
and the CPU never touch that cache.
``ResBottleneck`` has no fused form.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from ...ops import fused_conv
from .layers import BatchNorm2d, conv_bn, conv_layer as _conv, fold_convbn, max_pool


def _downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    return nn.Sequential(_conv(cin, cout, 1, stride), BatchNorm2d(cout))


class ResBasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.stride = stride
        self.conv1 = _conv(cin, features, 3, stride)
        self.bn1 = BatchNorm2d(features)
        self.conv2 = _conv(features, features, 3)
        self.bn2 = BatchNorm2d(features)
        self.downsample = _downsample(cin, features, stride) if downsample else None
        self._fused_cache = None  # (key, fused_conv.PackedBasicBlock): K4's weights, on the card only

    def _fused_key(self, dtype: torch.dtype, device: torch.device) -> tuple:
        tensors = (self.conv1.weight, self.conv2.weight, *(t for bn in (self.bn1, self.bn2) for t in (
            bn.weight, bn.bias, bn.running_mean, bn.running_var)))
        return (dtype, device, *((t.data_ptr(), t._version) for t in tensors))

    def fused_weights(self, dtype: torch.dtype, device: torch.device) -> fused_conv.PackedBasicBlock:
        """Both ConvBN pairs folded in f32 and packed for K4 at ``dtype``,
        from the cache while no conv or BatchNorm tensor has changed."""
        key = self._fused_key(dtype, device)
        if self._fused_cache is None or self._fused_cache[0] != key:
            with torch.no_grad():
                folded = (*fold_convbn(self.conv1, self.bn1), *fold_convbn(self.conv2, self.bn2))
                packed = fused_conv.pack_basic_block(*(t.to(device) for t in folded), dtype)
            self._fused_cache = (key, packed)
        return self._fused_cache[1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training and fused_conv.fused_conv_available():
            if self.stride == 1 and self.downsample is None and x.shape[1] == self.conv1.out_channels:
                if x.device.type == "cuda":
                    fused_conv._refuse_grad(x, *self.parameters())
                    return fused_conv.fused_basic_block_packed(x, self.fused_weights(x.dtype, x.device))
                return fused_conv.fused_basic_block(
                    x, *fold_convbn(self.conv1, self.bn1), *fold_convbn(self.conv2, self.bn2))
            folded = (*fold_convbn(self.conv1, self.bn1), *fold_convbn(self.conv2, self.bn2))
            if self.stride == 2 and self.downsample is not None and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
                # the 1x1 stride-2 downsample is x[::2, ::2] through a 1x1 product
                return fused_conv.fused_block_down(x, *folded, *fold_convbn(*self.downsample), pool_residual=False)
        identity = x
        out = conv_bn(x, self.conv1, self.bn1, relu=True)
        out = conv_bn(out, self.conv2, self.bn2, relu=False)
        if self.downsample is not None:
            identity = conv_bn(x, self.downsample[0], self.downsample[1], relu=False)
        return torch.relu(out + identity)


class ResBottleneck(nn.Module):
    """``features`` is the output width (planes * 4); the stride sits on the
    3x3 convolution."""

    def __init__(self, cin: int, features: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        planes = features // 4
        self.conv1 = _conv(cin, planes, 1)
        self.bn1 = BatchNorm2d(planes)
        self.conv2 = _conv(planes, planes, 3, stride)
        self.bn2 = BatchNorm2d(planes)
        self.conv3 = _conv(planes, features, 1)
        self.bn3 = BatchNorm2d(features)
        self.downsample = _downsample(cin, features, stride) if downsample else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = conv_bn(x, self.conv1, self.bn1, relu=True)
        out = conv_bn(out, self.conv2, self.bn2, relu=True)
        out = conv_bn(out, self.conv3, self.bn3, relu=False)
        if self.downsample is not None:
            identity = conv_bn(x, self.downsample[0], self.downsample[1], relu=False)
        return torch.relu(out + identity)


class ResNet(nn.Module):
    """torchvision-topology trunk; ``forward`` returns the {'p2' .. 'p6'}
    feature dict."""

    def __init__(self, block_counts: Tuple[int, int, int, int], bottleneck: bool = False):
        super().__init__()
        width = 4 if bottleneck else 1
        block = ResBottleneck if bottleneck else ResBasicBlock
        self.conv1 = _conv(3, 64, 7, 2)
        self.bn1 = BatchNorm2d(64)
        cin = 64
        self.out_channels = {}
        for stage, n_blocks in enumerate(block_counts):
            f = 64 * 2 ** stage * width
            blocks = []
            for i in range(n_blocks):
                s = 2 if (i == 0 and stage > 0) else 1
                down = i == 0 and (s != 1 or (stage == 0 and bottleneck))
                blocks.append(block(cin, f, s, down))
                cin = f
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
            self.out_channels[f"p{stage + 2}"] = f
        self.out_channels["p6"] = cin

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = conv_bn(x, self.conv1, self.bn1, relu=True)
        x = max_pool(x, 3, 2, padding=1)
        outs = {}
        for stage in range(4):
            x = getattr(self, f"layer{stage + 1}")(x)
            outs[f"p{stage + 2}"] = x
        outs["p6"] = max_pool(x, 1, 2)
        return outs


_RESNET_SPECS = {
    "resnet18": dict(block_counts=(2, 2, 2, 2), bottleneck=False),
    "resnet34": dict(block_counts=(3, 4, 6, 3), bottleneck=False),
    "resnet50": dict(block_counts=(3, 4, 6, 3), bottleneck=True),
    "resnet101": dict(block_counts=(3, 4, 23, 3), bottleneck=True),
}


def build_resnet(name: str) -> ResNet:
    if name not in _RESNET_SPECS:
        raise ValueError(f"unknown ResNet '{name}' (one of {sorted(_RESNET_SPECS)})")
    return ResNet(**_RESNET_SPECS[name])
