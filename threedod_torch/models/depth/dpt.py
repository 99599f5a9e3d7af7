"""DPT decoder and the Depth-Anything-V2 metric-depth model (counterpart of
``threedod/models/depth/dpt.py``).

Per-level 1x1 projections and resize layers, scratch 3x3 convolutions, four
feature-fusion blocks (residual conv units, bilinear upsampling with
``align_corners=True`` to the next level's size), a sigmoid scaled by
``max_depth``. Tensors are (B, C, H, W); parameter names are the DA-V2
checkpoint's (``pretrained.*``, ``depth_head.projects.{i}``,
``depth_head.resize_layers.{0,1,3}``, ``depth_head.scratch.layer{n}_rn``,
``depth_head.scratch.refinenet{n}.{resConfUnit1,resConfUnit2,out_conv}``,
``depth_head.scratch.output_conv1``, ``output_conv2.{0,2}``). ``refinenet4``
has no ``resConfUnit1``: it gets no residual input.

Parameters stay f32; a convolution casts its input and weights to the compute
dtype. A resize returns f32 (its f32 weights promote a bf16 map, as in the
JAX model) and the next convolution casts down again; the last 1x1
convolution and the sigmoid run in f32.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dinov2 import INTERMEDIATE_LAYER_IDX, build_dinov2

DEPTH_MODEL_CONFIGS = {
    "vits": {"features": 64, "out_channels": (48, 96, 192, 384)},
    "vitb": {"features": 128, "out_channels": (96, 192, 384, 768)},
    "vitl": {"features": 256, "out_channels": (256, 512, 1024, 1024)},
}


def resize_align_corners(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize of (B, C, H, W) with ``align_corners=True`` semantics,
    written out: f32 source coordinates from ``linspace``, floor, and the four
    weighted corners. Returns x itself when the size does not change."""
    _, _, h, w = x.shape
    if h == out_h and w == out_w:
        return x
    ys = torch.linspace(0.0, h - 1.0, out_h, device=x.device, dtype=torch.float32)
    xs = torch.linspace(0.0, w - 1.0, out_w, device=x.device, dtype=torch.float32)
    y0, x0 = torch.floor(ys).long(), torch.floor(xs).long()
    y1, x1 = (y0 + 1).clamp(0, h - 1), (x0 + 1).clamp(0, w - 1)
    dy = (ys - y0)[None, None, :, None]
    dx = (xs - x0)[None, None, None, :]
    top, bottom = x[:, :, y0], x[:, :, y1]
    return (top[:, :, :, x0] * (1 - dy) * (1 - dx) + top[:, :, :, x1] * (1 - dy) * dx
            + bottom[:, :, :, x0] * dy * (1 - dx) + bottom[:, :, :, x1] * dy * dx)


def _conv(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.conv2d(x.to(dtype), layer.weight.to(dtype), bias, stride=layer.stride, padding=layer.padding)


def _conv_transpose(x: torch.Tensor, layer: nn.ConvTranspose2d, dtype: torch.dtype) -> torch.Tensor:
    return F.conv_transpose2d(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype), stride=layer.stride)


class ResidualConvUnit(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = _conv(F.relu(x), self.conv1, self.dtype)
        return _conv(F.relu(out), self.conv2, self.dtype) + x


class FeatureFusionBlock(nn.Module):
    def __init__(self, features: int, dtype: torch.dtype, with_residual: bool = True):
        super().__init__()
        self.dtype = dtype
        if with_residual:
            self.resConfUnit1 = ResidualConvUnit(features, dtype)
        self.resConfUnit2 = ResidualConvUnit(features, dtype)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x: torch.Tensor, res: Optional[torch.Tensor] = None,
                size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        if res is not None:
            x = x + self.resConfUnit1(res)
        x = self.resConfUnit2(x)
        if size is None:
            size = (x.shape[2] * 2, x.shape[3] * 2)
        return _conv(resize_align_corners(x, *size), self.out_conv, self.dtype)


class _Scratch(nn.Module):
    def __init__(self, features: int, out_channels: Sequence[int], dtype: torch.dtype):
        super().__init__()
        for i, c in enumerate(out_channels):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(c, features, 3, padding=1, bias=False))
        for i in range(1, 5):
            setattr(self, f"refinenet{i}", FeatureFusionBlock(features, dtype, with_residual=i != 4))
        self.output_conv1 = nn.Conv2d(features, features // 2, 3, padding=1)
        self.output_conv2 = nn.Sequential(
            nn.Conv2d(features // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1))


class DPTHead(nn.Module):
    def __init__(self, in_channels: int, features: int, out_channels: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        oc = out_channels
        self.dtype = dtype
        self.projects = nn.ModuleList([nn.Conv2d(in_channels, c, 1) for c in oc])
        self.resize_layers = nn.ModuleList([
            nn.ConvTranspose2d(oc[0], oc[0], 4, stride=4),
            nn.ConvTranspose2d(oc[1], oc[1], 2, stride=2),
            nn.Identity(),
            nn.Conv2d(oc[3], oc[3], 3, stride=2, padding=1),
        ])
        self.scratch = _Scratch(features, oc, dtype)

    def forward(self, tokens: List[torch.Tensor], patch_h: int, patch_w: int) -> torch.Tensor:
        """tokens: 4 x patch tokens (B, N, D) -> depth in (0, 1), (B, 14 h, 14 w), f32."""
        d, sc = self.dtype, self.scratch
        rn = []
        for i, t in enumerate(tokens):
            b, _, dim = t.shape
            # (B, h, w, D) seen as (B, D, h, w): channels-last storage, no copy
            x = _conv(t.reshape(b, patch_h, patch_w, dim).permute(0, 3, 1, 2), self.projects[i], d)
            if i < 2:
                x = _conv_transpose(x, self.resize_layers[i], d)
            elif i == 3:
                x = _conv(x, self.resize_layers[3], d)
            rn.append(_conv(x, getattr(sc, f"layer{i + 1}_rn"), d))
        path = sc.refinenet4(rn[3], size=rn[2].shape[2:])
        path = sc.refinenet3(path, rn[2], size=rn[1].shape[2:])
        path = sc.refinenet2(path, rn[1], size=rn[0].shape[2:])
        path = sc.refinenet1(path, rn[0])
        out = _conv(path, sc.output_conv1, d)
        out = resize_align_corners(out, patch_h * 14, patch_w * 14)
        out = F.relu(_conv(out, sc.output_conv2[0], d))
        out = _conv(out, sc.output_conv2[2], torch.float32)
        return torch.sigmoid(out)[:, 0]


class DepthAnythingV2(nn.Module):
    """Metric-depth DA-V2: the DPT head's sigmoid times ``max_depth``."""

    def __init__(self, encoder: str = "vits", max_depth: float = 20.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if encoder not in DEPTH_MODEL_CONFIGS:
            raise ValueError(f"unknown encoder '{encoder}' (one of {sorted(DEPTH_MODEL_CONFIGS)})")
        cfg = DEPTH_MODEL_CONFIGS[encoder]
        self.encoder = encoder
        self.max_depth = max_depth
        self.pretrained = build_dinov2(encoder, dtype=dtype)
        self.depth_head = DPTHead(self.pretrained.embed_dim, cfg["features"], cfg["out_channels"], dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, 3, H, W), RGB normalised with the ImageNet mean and std, H and
        W multiples of 14 -> metric depth (B, H, W), f32."""
        feats, hp, wp = self.pretrained.get_intermediate_layers(x, INTERMEDIATE_LAYER_IDX[self.encoder])
        return self.depth_head([f[0] for f in feats], hp, wp) * self.max_depth


@torch.no_grad()
def init_weights(model: DepthAnythingV2, generator: torch.Generator) -> None:
    """Seeded initialisation with the JAX package's initialisers: lecun-normal
    projections and convolutions with zero biases, normal(0.02) position
    embedding, zero cls token, LayerNorm and LayerScale at identity. Draws are
    made on the CPU, so a seed gives the same weights on every device."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.weight[0].numel() if not isinstance(m, nn.ConvTranspose2d) else m.weight[:, 0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) / fan_in ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    vit = model.pretrained
    vit.pos_embed.copy_(torch.randn(vit.pos_embed.shape, generator=generator) * 0.02)
    vit.cls_token.zero_()
    for blk in vit.blocks:
        blk.ls1.gamma.fill_(1.0)
        blk.ls2.gamma.fill_(1.0)


def build_depth_model(encoder: str = "vitl", max_depth: float = 20.0, dtype: torch.dtype = torch.bfloat16,
                      seed: int = 0) -> DepthAnythingV2:
    """The seeded model in eval mode."""
    model = DepthAnythingV2(encoder, max_depth, dtype)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()
