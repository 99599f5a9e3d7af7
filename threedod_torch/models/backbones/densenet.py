"""DenseNet-121/169 trunk (counterpart of
``threedod/models/backbones/densenet.py``).

torchvision's ``densenet121().features`` re-exposed as a 5-level extractor:
p2 to p4 are the dense blocks' outputs before each transition's downsampling,
p5 is the last block through ``norm5`` (no relu), p6 its stride-2 subsample.
Module names are torchvision's (``features.conv0``, ``features.norm0``,
``features.denseblock{b}.denselayer{l}.{norm1,conv1,norm2,conv2}``,
``features.transition{t}.{norm,conv}``, ``features.norm5``).

Every norm but the stem's stands alone before its convolution: it runs in
f32 with momentum 0.99 (``layers.batch_norm``), and its result is cast to the
compute dtype after the relu.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, batch_norm, conv_bn, conv_layer as _conv, max_pool

NORM_MOMENTUM = 0.99  # of the stand-alone norms; the stem's ConvBN keeps 0.9


def _plain_conv(x: torch.Tensor, layer: nn.Conv2d) -> torch.Tensor:
    return F.conv2d(x, layer.weight.to(x.dtype), None, padding=layer.padding)


class DenseLayer(nn.Module):
    def __init__(self, cin: int, growth: int = 32, bn_size: int = 4):
        super().__init__()
        self.norm1 = BatchNorm2d(cin, momentum=NORM_MOMENTUM)
        self.conv1 = _conv(cin, bn_size * growth, 1)
        self.norm2 = BatchNorm2d(bn_size * growth, momentum=NORM_MOMENTUM)
        self.conv2 = _conv(bn_size * growth, growth, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _plain_conv(batch_norm(x, self.norm1).to(x.dtype), self.conv1)
        out = _plain_conv(batch_norm(out, self.norm2).to(x.dtype), self.conv2)
        return torch.cat([x, out], dim=1)


class Transition(nn.Module):
    """1x1 conv halving the channels, then a 2x2 average pool."""

    def __init__(self, cin: int):
        super().__init__()
        self.norm = BatchNorm2d(cin, momentum=NORM_MOMENTUM)
        self.conv = _conv(cin, cin // 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.avg_pool2d(_plain_conv(batch_norm(x, self.norm).to(x.dtype), self.conv), 2, 2)


class DenseNet(nn.Module):
    """``forward`` returns the {'p2' .. 'p6'} feature dict."""

    def __init__(self, block_counts: Tuple[int, ...] = (6, 12, 24, 16), growth: int = 32, init_features: int = 64):
        super().__init__()
        f = nn.ModuleDict()
        f["conv0"] = _conv(3, init_features, 7, 2)
        f["norm0"] = BatchNorm2d(init_features)
        features = init_features
        self.out_channels = {}
        for bi, n_layers in enumerate(block_counts):
            f[f"denseblock{bi + 1}"] = nn.ModuleDict(
                {f"denselayer{li + 1}": DenseLayer(features + li * growth, growth) for li in range(n_layers)})
            features += n_layers * growth
            self.out_channels[f"p{bi + 2}"] = features
            if bi != len(block_counts) - 1:
                f[f"transition{bi + 1}"] = Transition(features)
                features //= 2
        f["norm5"] = BatchNorm2d(features, momentum=NORM_MOMENTUM)
        self.out_channels["p6"] = features
        self.features = f
        self.num_blocks = len(block_counts)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        f = self.features
        x = conv_bn(x, f["conv0"], f["norm0"], relu=True)
        x = max_pool(x, 3, 2, padding=1)
        outs = {}
        for bi in range(self.num_blocks):
            for layer in f[f"denseblock{bi + 1}"].values():
                x = layer(x)
            outs[f"p{bi + 2}"] = x
            if bi != self.num_blocks - 1:
                x = f[f"transition{bi + 1}"](x)
        outs["p5"] = batch_norm(x, f["norm5"], relu=False).to(x.dtype)
        outs["p6"] = max_pool(outs["p5"], 1, 2)
        return outs


_DENSENET_SPECS = {"densenet121": (6, 12, 24, 16), "densenet169": (6, 12, 32, 32)}


def build_densenet(name: str = "densenet121") -> DenseNet:
    if name not in _DENSENET_SPECS:
        raise ValueError(f"unknown DenseNet '{name}' (one of {sorted(_DENSENET_SPECS)})")
    return DenseNet(block_counts=_DENSENET_SPECS[name])
