"""Swin-T image backbone of GroundingDINO (counterpart of
``threedod/models/gdino/swin.py``).

Patch 4 (flax "SAME" padding), embed 96, depths (2, 2, 6, 2), heads (3, 6,
12, 24), window 7; returns the stage 1 to 3 taps {p3, p4, p5} as (B, H, W, C)
maps in the compute dtype, each through its f32 out-norm. Names are the
official checkpoint's under ``backbone.0``: ``patch_embed.{proj,norm}``,
``layers.{s}.blocks.{b}.{norm1, attn.{qkv, proj,
relative_position_bias_table}, norm2, mlp.{fc1, fc2}}``,
``layers.{s}.downsample.{norm, reduction}`` and ``norm{1,2,3}``.

A block pads its (H, W) grid on the right and bottom to a multiple of the
window, shifts by half a window (odd blocks, only where both padded sides
exceed the window) with the -100 mask between the three regions of each axis,
and shifts back. Tokens are (B, H * W, C) between blocks.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import container, layer_norm, linear


def _rel_pos_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2 ws - 1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (ws - 1)
    return rel[0] * (2 * ws - 1) + rel[1]


@functools.lru_cache(maxsize=None)
def _shift_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) f32: -100 between tokens of different regions, else 0.
    Regions of an axis of n: [0, n - ws), [n - ws, n - shift), [n - shift, n)."""
    def regions(n):
        i = np.arange(n)
        return (i >= n - ws).astype(np.int32) + (i >= n - shift).astype(np.int32)

    img = regions(hp)[:, None] * 3 + regions(wp)[None, :]
    wm = img.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    return np.where(wm[:, :, None] != wm[:, None, :], -100.0, 0.0).astype(np.float32)


def _same_pad(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class WindowAttention(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.register_buffer("relative_position_index", torch.from_numpy(_rel_pos_index(window)).long(),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        # x (nW * B, N, C); mask (nW, N, N) or None
        b, n, c = x.shape
        h = self.heads
        qkv = linear(x, self.qkv, self.dtype).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # (B, h, N, hd)
        attn = (q * (c // h) ** -0.5) @ k.transpose(-2, -1)
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(n, n, h).permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b // nw, nw, h, n, n) + mask[None, :, None].to(attn.dtype)).reshape(b, h, n, n)
        attn = torch.softmax(attn, dim=-1)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return linear(out, self.proj, self.dtype)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, heads: int, window: int = 7, shift: int = 0, mlp_ratio: float = 4.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window, self.shift, self.dtype = window, shift, dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = WindowAttention(dim, heads, window, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = container(fc1=nn.Linear(dim, int(dim * mlp_ratio)), fc2=nn.Linear(int(dim * mlp_ratio), dim))

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        H, W = hw
        b, _, c = x.shape
        ws = self.window
        shortcut = x
        x = layer_norm(x, self.norm1).to(self.dtype).reshape(b, H, W, c)
        pad_b, pad_r = (ws - H % ws) % ws, (ws - W % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = H + pad_b, W + pad_r
        shift = self.shift if min(hp, wp) > ws else 0
        mask = None
        if shift:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = torch.from_numpy(_shift_mask(hp, wp, ws, shift)).to(x.device)
        xw = x.reshape(b, hp // ws, ws, wp // ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)
        xw = self.attn(xw, mask)
        x = xw.reshape(b, hp // ws, wp // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)
        if shift:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = shortcut + x[:, :H, :W].reshape(b, H * W, c)
        y = linear(layer_norm(x, self.norm2).to(self.dtype), self.mlp.fc1, self.dtype)
        return x + linear(F.gelu(y), self.mlp.fc2, self.dtype)


class PatchMerging(nn.Module):
    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(4 * dim, eps=1e-6)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]):
        H, W = hw
        b, _, c = x.shape
        x = F.pad(x.reshape(b, H, W, c), (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        hh, wh = (H + 1) // 2, (W + 1) // 2
        x = layer_norm(x.reshape(b, hh * wh, 4 * c), self.norm).to(self.dtype)
        return linear(x, self.reduction, self.dtype), (hh, wh)


class SwinT(nn.Module):
    def __init__(self, embed_dim: int = 96, depths=(2, 2, 6, 2), heads=(3, 6, 12, 24), window: int = 7,
                 out_indices=(1, 2, 3), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dim, self.out_indices, self.dtype = embed_dim, tuple(out_indices), dtype
        self.patch_embed = container(proj=nn.Conv2d(3, embed_dim, 4, stride=4), norm=nn.LayerNorm(embed_dim, eps=1e-6))
        self.layers = nn.ModuleList()
        dim = embed_dim
        for si, depth in enumerate(depths):
            blocks = nn.ModuleList(
                SwinBlock(dim, heads[si], window, shift=0 if bi % 2 == 0 else window // 2, dtype=dtype)
                for bi in range(depth))
            last = si == len(depths) - 1
            self.layers.append(container(blocks=blocks, downsample=None if last else PatchMerging(dim, dtype)))
            if si in self.out_indices:
                self.add_module(f"norm{si}", nn.LayerNorm(dim, eps=1e-6))
            dim *= 2

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (B, H, W, 3) -> {f"p{s + 2}": (B, H_s, W_s, C_s)} for s in out_indices."""
        b, h0, w0, _ = x.shape
        proj = self.patch_embed.proj
        (pt, pb), (pl, pr) = _same_pad(h0, 4, 4), _same_pad(w0, 4, 4)
        x = F.pad(x.permute(0, 3, 1, 2).to(self.dtype), (pl, pr, pt, pb))
        x = F.conv2d(x, proj.weight.to(self.dtype), proj.bias.to(self.dtype), stride=4)
        H, W = x.shape[2], x.shape[3]
        x = layer_norm(x.permute(0, 2, 3, 1).reshape(b, H * W, self.embed_dim), self.patch_embed.norm).to(self.dtype)
        outs, dim = {}, self.embed_dim
        for si, layer in enumerate(self.layers):
            for blk in layer.blocks:
                x = blk(x, (H, W))
            if si in self.out_indices:
                outs[f"p{si + 2}"] = layer_norm(x, getattr(self, f"norm{si}")).reshape(b, H, W, dim).to(self.dtype)
            if layer.downsample is not None:
                x, (H, W) = layer.downsample(x, (H, W))
                dim *= 2
        return outs
