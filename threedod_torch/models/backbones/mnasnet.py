"""MNASNet-1.0 trunk (counterpart of
``threedod/models/backbones/mnasnet.py``).

torchvision's ``mnasnet1_0().layers`` tapped at strides 4/8/16/32 as p2..p5,
p6 the stride-2 subsample of p5. Module names are torchvision's: the stem is
``layers.{0,1}``, ``layers.{3,4}``, ``layers.{6,7}`` (conv, norm; the odd
slots between are its relus), stage ``s`` is ``layers.{8 + s}``, and a block's
expand / depthwise / project convolutions are its ``layers.{0,1}``,
``layers.{3,4}``, ``layers.{6,7}``. The final 1280-channel convolution of the
classifier is not part of the extractor.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .layers import BatchNorm2d, conv_bn, conv_layer as _conv, max_pool

# (features, blocks, stride, expansion, kernel)
STAGES = [(24, 3, 2, 3, 3), (40, 3, 2, 3, 5), (80, 3, 2, 6, 5), (96, 2, 1, 6, 3), (192, 4, 2, 6, 5), (320, 1, 1, 6, 3)]
TAPS = {0: "p2", 1: "p3", 3: "p4", 5: "p5"}  # the level after these stages


def _three(cin: int, mid: int, cout: int, k: int, stride: int, first_k: int = 1, first_stride: int = 1) -> nn.Sequential:
    """conv, norm, relu, depthwise conv, norm, relu, 1x1 conv, norm."""
    return nn.Sequential(
        _conv(cin, mid, first_k, first_stride), BatchNorm2d(mid), nn.ReLU(),
        _conv(mid, mid, k, stride, groups=mid), BatchNorm2d(mid), nn.ReLU(),
        _conv(mid, cout, 1), BatchNorm2d(cout),
    )


def _run_three(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    x = conv_bn(x, seq[0], seq[1], relu=True)
    x = conv_bn(x, seq[3], seq[4], relu=True)
    return conv_bn(x, seq[6], seq[7], relu=False)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, features: int, stride: int, expansion: int, kernel: int = 3):
        super().__init__()
        self.residual = stride == 1 and cin == features
        self.layers = _three(cin, cin * expansion, features, kernel, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _run_three(self.layers, x)
        return out + x if self.residual else out


class MNASNet(nn.Module):
    """Stem and 6 inverted-residual stages; ``forward`` returns the
    {'p2' .. 'p6'} feature dict."""

    def __init__(self):
        super().__init__()
        layers = list(_three(3, 32, 16, 3, 1, first_k=3, first_stride=2))
        cin = 16
        self.out_channels = {}
        for si, (f, n, s, e, k) in enumerate(STAGES):
            layers.append(nn.Sequential(*[InvertedResidual(cin if bi == 0 else f, f, s if bi == 0 else 1, e, k)
                                          for bi in range(n)]))
            cin = f
            if si in TAPS:
                self.out_channels[TAPS[si]] = f
        self.out_channels["p6"] = cin
        self.layers = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = _run_three(self.layers, x)
        outs = {}
        for si in range(len(STAGES)):
            x = self.layers[8 + si](x)
            if si in TAPS:
                outs[TAPS[si]] = x
        outs["p6"] = max_pool(outs["p5"], 1, 2)
        return outs


def build_mnasnet(name: str = "mnasnet") -> MNASNet:
    return MNASNet()
