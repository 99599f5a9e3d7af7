"""ShuffleNet-V2 x1.0 trunk (counterpart of
``threedod/models/backbones/shufflenet.py``).

torchvision's ``shufflenet_v2_x1_0`` stages as p2..p5 (p2 is the stem after
its max-pool, 24 channels), p6 the stride-2 subsample of p5. Module names are
torchvision's: ``conv1.{0,1}``, ``stage{2,3,4}.{b}.branch1.{0,1,2,3}`` (the
stride-2 units only: depthwise conv, norm, 1x1 conv, norm) and
``branch2.{0,1,3,4,5,6}`` (1x1, norm, depthwise, norm, 1x1, norm; the slots
between are relus). torchvision's ``conv5`` is not in the forward and the
trunk has no such parameters.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn

from .layers import BatchNorm2d, conv_bn, conv_layer as _conv, max_pool

STAGE_CHANNELS = (116, 232, 464)
STAGE_REPEATS = (4, 8, 4)


def channel_shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Interleave the channel groups. Done on the (B, H, W, C) view, so the
    result is channels-last in memory whatever the concat before it made:
    the levels go to kernels that read (B, H, W, C) storage."""
    b, c, h, w = x.shape
    y = x.permute(0, 2, 3, 1).reshape(b, h, w, groups, c // groups).transpose(3, 4)
    return y.reshape(b, h, w, c).permute(0, 3, 1, 2)


class ShuffleUnit(nn.Module):
    """``features`` is the unit's whole output width. Stride 1: the first
    half of the channels passes through, the second goes through branch2.
    Stride 2: both branches see the whole input."""

    def __init__(self, cin: int, features: int, stride: int):
        super().__init__()
        half = features // 2
        self.stride = stride
        if stride == 1:
            self.branch1 = nn.Sequential()
            b2_in = cin // 2
        else:
            self.branch1 = nn.Sequential(
                _conv(cin, cin, 3, stride, groups=cin), BatchNorm2d(cin),
                _conv(cin, half, 1), BatchNorm2d(half), nn.ReLU(),
            )
            b2_in = cin
        self.branch2 = nn.Sequential(
            _conv(b2_in, half, 1), BatchNorm2d(half), nn.ReLU(),
            _conv(half, half, 3, stride, groups=half), BatchNorm2d(half),
            _conv(half, half, 1), BatchNorm2d(half), nn.ReLU(),
        )

    def _branch2(self, x: torch.Tensor) -> torch.Tensor:
        b = self.branch2
        x = conv_bn(x, b[0], b[1], relu=True)
        x = conv_bn(x, b[3], b[4], relu=False)
        return conv_bn(x, b[5], b[6], relu=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self._branch2(x2)], dim=1)
        else:
            b = self.branch1
            left = conv_bn(conv_bn(x, b[0], b[1], relu=False), b[2], b[3], relu=True)
            out = torch.cat([left, self._branch2(x)], dim=1)
        return channel_shuffle(out)


class ShuffleNetV2(nn.Module):
    """``forward`` returns the {'p2' .. 'p6'} feature dict."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Sequential(_conv(3, 24, 3, 2), BatchNorm2d(24), nn.ReLU())
        cin = 24
        self.out_channels = {"p2": 24}
        for si, (c, n) in enumerate(zip(STAGE_CHANNELS, STAGE_REPEATS)):
            setattr(self, f"stage{si + 2}", nn.Sequential(
                *[ShuffleUnit(cin if bi == 0 else c, c, 2 if bi == 0 else 1) for bi in range(n)]))
            cin = c
            self.out_channels[f"p{si + 3}"] = c
        self.out_channels["p6"] = cin

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = conv_bn(x, self.conv1[0], self.conv1[1], relu=True)
        x = max_pool(x, 3, 2, padding=1)
        outs = {"p2": x}
        for si in range(len(STAGE_CHANNELS)):
            x = getattr(self, f"stage{si + 2}")(x)
            outs[f"p{si + 3}"] = x
        outs["p6"] = max_pool(x, 1, 2)
        return outs


def build_shufflenet(name: str = "shufflenet") -> ShuffleNetV2:
    return ShuffleNetV2()
