"""DINOv2 vision transformer, vits / vitb / vitl (counterpart of
``threedod/models/depth/dinov2.py``).

Patch 14, native image 518 (a 37x37 grid), LayerScale starting at 1, plain MLP
with the exact gelu, LayerNorm eps 1e-6, no register tokens.
``get_intermediate_layers`` returns final-normed (patch tokens, cls token)
pairs for the DPT head. Images come in as (B, 3, H, W). Parameter names are
the Depth-Anything-V2 checkpoint's (``cls_token``, ``pos_embed``,
``patch_embed.proj``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,ls1.gamma,norm2,
mlp.fc1,mlp.fc2,ls2.gamma}``, ``norm``).

Parameters stay f32 and ``dtype`` is the compute dtype of the projections.
The residual stream is not in it: the LayerNorms compute and return f32, each
projection casts its input down, and a branch times its f32 LayerScale is f32
again, so from the first block on the stream is f32 (as type promotion makes
it in the JAX model).

Attention goes through ``ops.attention.multi_head_attention``: kernel K9 on
the card from 2048 tokens on (a 518x924 frame has 37 x 66 + 1 = 2443).
"""
from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.attention import multi_head_attention


def _cubic_kernel(t: torch.Tensor, a: float = -0.75) -> torch.Tensor:
    """The bicubic convolution kernel with a = -0.75."""
    at = t.abs()
    near = (a + 2) * at ** 3 - (a + 3) * at ** 2 + 1
    far = a * at ** 3 - 5 * a * at ** 2 + 8 * a * at - 4 * a
    return torch.where(at <= 1.0, near, torch.where(at < 2.0, far, torch.zeros_like(at)))


def bicubic_resize(x: torch.Tensor, out_h: int, out_w: int, scale_y: float, scale_x: float) -> torch.Tensor:
    """``F.interpolate(mode="bicubic", align_corners=False, scale_factor=...)``
    of the original model written out, so that the CPU, the card and the JAX
    package compute the same sums: source coordinate (i + 0.5) / scale - 0.5,
    four taps with a = -0.75, indices clamped to the border. x (B, H, W, C)."""
    _, h, w, _ = x.shape
    taps = torch.arange(-1, 3, device=x.device)

    def axis_weights(out_n: int, in_n: int, scale: float):
        pos = (torch.arange(out_n, device=x.device, dtype=torch.float32) + 0.5) / scale - 0.5
        base = torch.floor(pos)
        wgt = _cubic_kernel((pos - base)[:, None] - taps[None, :].float())
        idx = (base.long()[:, None] + taps[None, :]).clamp(0, in_n - 1)
        return idx, wgt.to(x.dtype)

    yi, yw = axis_weights(out_h, h, scale_y)
    xi, xw = axis_weights(out_w, w, scale_x)
    rows = torch.einsum("bofwc,of->bowc", x[:, yi], yw)
    return torch.einsum("bowfc,wf->bowc", rows[:, :, xi], xw)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        qkv = _linear(x, self.qkv, self.dtype).view(b, n, 3, self.num_heads, c // self.num_heads)
        # three strided views of one projection, (B, N, H, D) each
        out = multi_head_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        return _linear(out.reshape(b, n, c), self.proj, self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _linear(F.gelu(_linear(x, self.fc1, self.dtype)), self.fc2, self.dtype)


class LayerScale(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads, dtype)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1.gamma * self.attn(_layer_norm(x, self.norm1))
        return x + self.ls2.gamma * self.mlp(_layer_norm(x, self.norm2))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch_size: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)


class DinoVisionTransformer(nn.Module):
    def __init__(self, embed_dim: int = 384, depth: int = 12, num_heads: int = 6, patch_size: int = 14,
                 img_size: int = 518, interpolate_offset: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        grid = img_size // patch_size
        self.embed_dim = embed_dim
        self.num_patches = grid * grid
        self.interpolate_offset = interpolate_offset
        self.dtype = dtype
        self.patch_embed = PatchEmbed(embed_dim, patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, self.num_patches + 1, embed_dim))
        self.blocks = nn.ModuleList([Block(embed_dim, num_heads, dtype=dtype) for _ in range(depth)])
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def _interp_pos(self, h_patches: int, w_patches: int) -> torch.Tensor:
        """The position embedding on an (h, w) patch grid: untouched on the
        square native grid, else bicubic with the original's 0.1 offset in
        the scale factor."""
        n = self.num_patches
        if h_patches * w_patches == n and h_patches == w_patches:
            return self.pos_embed
        g = int(math.sqrt(n))
        pe = self.pos_embed[:, 1:].reshape(1, g, g, self.embed_dim)
        sy = (h_patches + self.interpolate_offset) / g
        sx = (w_patches + self.interpolate_offset) / g
        pe = bicubic_resize(pe, h_patches, w_patches, sy, sx)
        return torch.cat([self.pos_embed[:, :1], pe.reshape(1, -1, self.embed_dim)], dim=1)

    def prepare_tokens(self, x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
        """x (B, 3, H, W) -> tokens (B, 1 + hp * wp, D) at the compute dtype, hp, wp."""
        proj = self.patch_embed.proj
        t = F.conv2d(x.to(self.dtype), proj.weight.to(self.dtype), proj.bias.to(self.dtype), stride=proj.stride)
        b, _, hp, wp = t.shape
        t = t.flatten(2).transpose(1, 2)
        cls = self.cls_token.expand(b, 1, self.embed_dim).to(t.dtype)
        t = torch.cat([cls, t], dim=1)
        return t + self._interp_pos(hp, wp).to(t.dtype), hp, wp

    def get_intermediate_layers(self, x: torch.Tensor, layer_ids: Sequence[int]):
        """-> [(patch tokens (B, N, D), cls (B, D)), ...] final-normed in f32, hp, wp."""
        t, hp, wp = self.prepare_tokens(x)
        want = set(layer_ids)
        outs = {}
        for i, blk in enumerate(self.blocks):
            t = blk(t)
            if i in want:
                outs[i] = t
        result: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for i in layer_ids:
            normed = _layer_norm(outs[i], self.norm)
            result.append((normed[:, 1:], normed[:, 0]))
        return result, hp, wp

    def forward(self, x: torch.Tensor, layer_ids: Sequence[int] = (2, 5, 8, 11)):
        return self.get_intermediate_layers(x, layer_ids)


VIT_SPECS = {
    "vits": dict(embed_dim=384, depth=12, num_heads=6),
    "vitb": dict(embed_dim=768, depth=12, num_heads=12),
    "vitl": dict(embed_dim=1024, depth=24, num_heads=16),
}

INTERMEDIATE_LAYER_IDX = {
    "vits": (2, 5, 8, 11),
    "vitb": (2, 5, 8, 11),
    "vitl": (4, 11, 17, 23),
}


def build_dinov2(name: str, dtype: torch.dtype = torch.float32) -> DinoVisionTransformer:
    if name not in VIT_SPECS:
        raise ValueError(f"unknown encoder '{name}' (one of {sorted(VIT_SPECS)})")
    return DinoVisionTransformer(**VIT_SPECS[name], dtype=dtype)
