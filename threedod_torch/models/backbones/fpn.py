"""Feature Pyramid Network over a trunk's five levels (counterpart of
``threedod/models/backbones/fpn.py``).

detectron2 FPN as the reference configures it: a lateral 1x1 and an output
3x3 conv per level p2..p6, nearest top-down upsampling and sum fusion, p6 fed
from the trunk (no extra top block). Names follow d2: ``bottom_up``,
``fpn_lateral{2..6}``, ``fpn_output{2..6}``.

In eval, with ``ops.fused_conv`` switched on, a level with a top-down input,
even dims and a lateral input of a multiple of 16 channels runs as kernel K8
(lateral, 2x repeat, sum and output conv in one): there the exact 2x repeat
is the nearest upsampling, and 16 channels are one k-step of the tensor
cores. Every other level keeps the stock path (MNASNet's 24 and 40 channels,
ShuffleNet's 24, 116 and 232). On the card a fused level packs its weights
once and keeps them (``BackboneWithFPN.fused_level_weights``) until a conv
tensor changes, moves or changes dtype; training and the CPU never touch
that cache.

``build_backbone`` picks the trunk by the name's family: dla, resnet,
densenet, mnasnet, shufflenet.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import fused_conv
from .densenet import build_densenet
from .dla import build_dla
from .layers import conv
from .mnasnet import build_mnasnet
from .resnet import build_resnet
from .shufflenet import build_shufflenet

_TRUNKS = (("dla", build_dla), ("resnet", build_resnet), ("densenet", build_densenet),
             ("mnasnet", build_mnasnet), ("shufflenet", build_shufflenet))


class BackboneWithFPN(nn.Module):
    def __init__(self, bottom_up: nn.Module, out_channels: int = 256):
        super().__init__()
        self.bottom_up = bottom_up
        self.names = sorted(bottom_up.out_channels)  # ['p2', ..., 'p6']
        for n in self.names:
            lvl = n[1:]
            cin = bottom_up.out_channels[n]
            self.add_module(f"fpn_lateral{lvl}", nn.Conv2d(cin, out_channels, 1))
            self.add_module(f"fpn_output{lvl}", nn.Conv2d(out_channels, out_channels, 3, padding=1))
        self._fused_cache = {}  # level -> (key, fused_conv.PackedFPNLevel): K8's weights, on the card only

    def fused_level_weights(self, lvl: str, dtype: torch.dtype, device: torch.device) -> fused_conv.PackedFPNLevel:
        """Level ``lvl``'s lateral and output convs packed for K8 at
        ``dtype``, from the cache while none of their tensors has changed."""
        lateral, output = getattr(self, f"fpn_lateral{lvl}"), getattr(self, f"fpn_output{lvl}")
        tensors = (lateral.weight, lateral.bias, output.weight, output.bias)
        key = (dtype, device, *((t.data_ptr(), t._version) for t in tensors))
        cached = self._fused_cache.get(lvl)
        if cached is None or cached[0] != key:
            with torch.no_grad():
                cached = (key, fused_conv.pack_fpn_level(*(t.to(device) for t in tensors), dtype))
            self._fused_cache[lvl] = cached
        return cached[1]

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, 3, H, W) at the compute dtype -> {'p2'..'p6'} (B, C, H_l, W_l)."""
        feats = self.bottom_up(x)
        outs = {}
        prev = None
        fuse = not self.training and fused_conv.fused_conv_available()
        for n in reversed(self.names):
            lvl = n[1:]
            f, lateral, output = feats[n], getattr(self, f"fpn_lateral{lvl}"), getattr(self, f"fpn_output{lvl}")
            h, w = f.shape[-2:]
            if (fuse and prev is not None and h % 2 == 0 and w % 2 == 0 and prev.shape[-2:] == (h // 2, w // 2)
                    and f.shape[1] % 16 == 0):
                emit = n != self.names[0]  # nobody reads the finest level's carry
                if f.device.type == "cuda":
                    fused_conv._refuse_grad(f, prev, lateral.weight, output.weight)
                    res = fused_conv.fused_fpn_level_packed(
                        f, prev, self.fused_level_weights(lvl, f.dtype, f.device), emit_cur=emit)
                else:
                    res = fused_conv.fused_fpn_level(
                        f, prev, lateral.weight, lateral.bias, output.weight, output.bias, emit_cur=emit)
                outs[n], prev = res if emit else (res, None)
                continue
            cur = conv(f, lateral)
            if prev is not None:
                # jax.image.resize(method="nearest") picks source index
                # floor((i + 0.5) * in / out): torch's "nearest-exact", not
                # "nearest" (they differ on the non-integer p6 -> p5 step)
                cur = cur + F.interpolate(prev, size=cur.shape[-2:], mode="nearest-exact")
            prev = cur
            outs[n] = conv(cur, output)
        return dict(sorted(outs.items()))


def build_backbone(name: str, fpn_out_channels: int = 256) -> BackboneWithFPN:
    """The named trunk under an FPN over its lateral widths."""
    for prefix, build in _TRUNKS:
        if name.startswith(prefix):
            return BackboneWithFPN(build(name), fpn_out_channels)
    raise ValueError(f"unknown backbone '{name}'")
