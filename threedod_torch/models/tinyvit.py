"""TinyViT-5M, the image encoder of MobileSAM and Light HQ-SAM (counterpart
of ``threedod/models/tinyvit.py``).

Dims 64/128/160/320, depths 2/2/6/2, heads 2/4/5/10, windows 7/7/14/7: a
stride-4 patch embedding of two 3x3 convolutions, two MBConv blocks, then
windowed attention stages with LeViT's learned bias a (|dy|, |dx|) offset,
each block's attention followed by a 3x3 depthwise convolution and an MLP;
patch merging between stages, the last one of stride 1 (MobileSAM's), so a
1024 px input ends on a 64x64 grid; the SAM neck to 256 channels. Images
and maps are (B, H, W, C).

Module names are MobileSAM's (``patch_embed.seq.{0,2}``,
``layers.{i}.blocks.{j}.{conv1,conv2,conv3}``, ``layers.{i}.downsample``,
``layers.{i}.blocks.{j}.attn.{norm,qkv,proj,attention_biases}``,
``local_conv``, ``mlp.{norm,fc1,fc2}``, ``neck.{0,1,2,3}``), so the JAX
package's ``convert_tinyvit`` reads a port ``state_dict()``. A
``Conv2d_BN`` pair (``c`` and ``bn``) is folded as that converter folds it,
with BatchNorm's epsilon 1e-5, and the folded kernel and bias run in the
compute ``dtype``, as the JAX module's biased convolution does. The norms
compute in f32 with flax's epsilon 1e-6 and return ``dtype``.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def bias_idxs(ws: int) -> np.ndarray:
    """LeViT's attention-bias index table: idxs[i, j] = the id of the offset
    (|dy|, |dx|) between window positions i and j, numbered as met."""
    points = list(itertools.product(range(ws), range(ws)))
    offsets: dict = {}
    idxs = []
    for p1 in points:
        for p2 in points:
            off = (abs(p1[0] - p2[0]), abs(p1[1] - p2[1]))
            if off not in offsets:
                offsets[off] = len(offsets)
            idxs.append(offsets[off])
    return np.asarray(idxs, np.int64).reshape(len(points), len(points))


class _BatchNorm(nn.Module):
    """An inference BatchNorm's four tensors under BatchNorm2d's names."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    @torch.no_grad()
    def reset(self) -> None:
        self.weight.fill_(1.0)
        self.bias.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)


class Conv2dBN(nn.Module):
    """Conv2d_BN: a bias-free convolution ``c`` and its BatchNorm ``bn``,
    applied folded into one biased convolution."""

    EPS = 1e-5

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1, groups: int = 1):
        super().__init__()
        self.c = nn.Conv2d(cin, cout, kernel, stride, kernel // 2, groups=groups, bias=False)
        self.bn = _BatchNorm(cout)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        scale = self.bn.weight / torch.sqrt(self.bn.running_var + self.EPS)
        weight = self.c.weight * scale[:, None, None, None]
        bias = self.bn.bias - self.bn.running_mean * scale
        y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), weight.to(dtype), bias.to(dtype), self.c.stride,
                     self.c.padding, groups=self.c.groups)
        return y.permute(0, 2, 3, 1)


def _norm(x: torch.Tensor, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps).to(dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.seq = nn.Sequential(Conv2dBN(3, dim // 2, 3, 2), nn.GELU(), Conv2dBN(dim // 2, dim, 3, 2))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.seq[2](F.gelu(self.seq[0](x, dtype)), dtype)


class MBConv(nn.Module):
    """1x1 expand, 3x3 depthwise, 1x1 project, GELU between, residual, GELU."""

    def __init__(self, dim: int, expand: float = 4.0):
        super().__init__()
        hidden = int(dim * expand)
        self.conv1 = Conv2dBN(dim, hidden, 1)
        self.conv2 = Conv2dBN(hidden, hidden, 3, groups=hidden)
        self.conv3 = Conv2dBN(hidden, dim, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = F.gelu(self.conv1(x, dtype))
        h = self.conv3(F.gelu(self.conv2(h, dtype)), dtype)
        return F.gelu(x + h)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, out_dim: int, stride: int = 2):
        super().__init__()
        self.conv1 = Conv2dBN(dim, out_dim, 1)
        self.conv2 = Conv2dBN(out_dim, out_dim, 3, stride=stride, groups=out_dim)
        self.conv3 = Conv2dBN(out_dim, out_dim, 1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = F.gelu(self.conv2(F.gelu(self.conv1(x, dtype)), dtype))
        return self.conv3(h, dtype)


class WindowAttention(nn.Module):
    """LayerNorm inside, qkv, the learned offset bias added to the logits,
    softmax in f32."""

    def __init__(self, dim: int, heads: int, ws: int):
        super().__init__()
        self.heads = heads
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        idxs = bias_idxs(ws)
        self.attention_biases = nn.Parameter(torch.zeros(heads, int(idxs.max()) + 1))
        self.register_buffer("attention_bias_idxs", torch.from_numpy(idxs), persistent=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:  # (B*, N, C)
        b, n, c = x.shape
        key_dim = c // self.heads
        qkv = _linear(_norm(x, self.norm, dtype), self.qkv, dtype).reshape(b, n, self.heads, 3 * key_dim)
        q, k, v = (t.transpose(1, 2) for t in qkv.split(key_dim, dim=-1))
        attn = (q @ k.transpose(-1, -2)) * key_dim ** -0.5
        attn = attn + self.attention_biases[:, self.attention_bias_idxs][None].to(attn.dtype)
        attn = torch.softmax(attn.float(), dim=-1).to(dtype)
        return _linear((attn @ v).transpose(1, 2).reshape(b, n, c), self.proj, dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class TinyViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, ws: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.ws = ws
        self.attn = WindowAttention(dim, heads, ws)
        self.local_conv = Conv2dBN(dim, dim, 3, groups=dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:  # (B, H, W, C)
        b, hh, ww, c = x.shape
        ws = self.ws
        if hh == ws and ww == ws:
            a = self.attn(x.reshape(b, hh * ww, c), dtype).reshape(b, hh, ww, c)
        else:
            pad_b, pad_r = (ws - hh % ws) % ws, (ws - ww % ws) % ws
            xp = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
            ph, pw = hh + pad_b, ww + pad_r
            nh, nw = ph // ws, pw // ws
            wnd = xp.reshape(b, nh, ws, nw, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b * nh * nw, ws * ws, c)
            a = self.attn(wnd, dtype)
            a = a.reshape(b, nh, nw, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, c)[:, :hh, :ww]
        x = self.local_conv(x + a, dtype)
        h = _linear(_norm(x, self.mlp.norm, dtype), self.mlp.fc1, dtype)
        return x + _linear(F.gelu(h), self.mlp.fc2, dtype)


class ConvLayer(nn.Module):
    """Stage 0: MBConv blocks, then the merge to the next width."""

    def __init__(self, dim: int, out_dim: int, depth: int):
        super().__init__()
        self.blocks = nn.ModuleList(MBConv(dim) for _ in range(depth))
        self.downsample = PatchMerging(dim, out_dim, 2)


class BasicLayer(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, ws: int, mlp_ratio: float, out_dim: int = 0,
                 stride: int = 2):
        super().__init__()
        self.blocks = nn.ModuleList(TinyViTBlock(dim, heads, ws, mlp_ratio) for _ in range(depth))
        self.downsample = PatchMerging(dim, out_dim, stride) if out_dim else None


class LayerNorm2dCF(nn.Module):
    """Channels-last LayerNorm (the SAM neck's), in f32, epsilon 1e-6,
    returned in the input's type."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return ((x - mean) / torch.sqrt(var + 1e-6) * self.weight + self.bias).to(dt)


class TinyViT(nn.Module):
    """(B, S, S, 3) -> (B, S/16, S/16, 256); with ``return_interm`` also the
    stage-2 feature (B, S/16, S/16, 160), the HQ decoder's early feature."""

    def __init__(self, img_size: int = 1024, embed_dims: Sequence[int] = (64, 128, 160, 320),
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (2, 4, 5, 10),
                 window_sizes: Sequence[int] = (7, 7, 14, 7), mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.dtype = img_size, dtype
        d = embed_dims
        self.patch_embed = PatchEmbed(d[0])
        self.layers = nn.ModuleList([ConvLayer(d[0], d[1], depths[0])])
        for i in (1, 2, 3):
            # MobileSAM: the merge to the last width keeps stride 1
            self.layers.append(BasicLayer(d[i], depths[i], num_heads[i], window_sizes[i], mlp_ratio,
                                          out_dim=d[i + 1] if i < 3 else 0, stride=2 if i < 2 else 1))
        self.neck = nn.Sequential(nn.Conv2d(d[3], 256, 1, bias=False), LayerNorm2dCF(256),
                                  nn.Conv2d(256, 256, 3, padding=1, bias=False), LayerNorm2dCF(256))

    def forward(self, x: torch.Tensor, return_interm: bool = False):
        dt = self.dtype
        x = self.patch_embed(x, dt)
        stage0 = self.layers[0]
        for blk in stage0.blocks:
            x = blk(x, dt)
        x = stage0.downsample(x, dt)
        interm = None
        for i in (1, 2, 3):
            layer = self.layers[i]
            for blk in layer.blocks:
                x = blk(x, dt)
            if i == 2:
                interm = x
            if layer.downsample is not None:
                x = layer.downsample(x, dt)
        for k in (0, 2):
            conv = self.neck[k]
            x = F.conv2d(x.to(dt).permute(0, 3, 1, 2), conv.weight.to(dt), None, 1, conv.padding).permute(0, 2, 3, 1)
            x = self.neck[k + 1](x)
        return (x, interm) if return_interm else x
