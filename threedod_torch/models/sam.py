"""Segment-Anything and SAM-HQ, box-prompted (counterpart of
``threedod/models/sam.py``).

The image encoder (a windowed ViT with decomposed relative positions and the
SAM neck; ViT-B by default: 1024 px, dim 768, depth 12, 12 heads, global
attention in blocks 2, 5, 8 and 11, window 14; or the TinyViT-5M of
``models/tinyvit.py`` with ``encoder_type="vit_tiny"``), the prompt encoder
(random Fourier features of the box corners) and the two-way mask decoder,
with SAM-HQ's HQ token and global-local fusion when ``hq``. Module names are
the official SAM / SAM-HQ checkpoints' (``image_encoder.blocks.N.attn.qkv``,
``prompt_encoder.pe_layer.positional_encoding_gaussian_matrix``,
``mask_decoder.transformer.layers.N.cross_attn_token_to_image.q_proj``,
``mask_decoder.hf_token``, ...), so the JAX package's ``convert_sam`` reads
a port ``state_dict()`` as it reads a checkpoint.

Layouts and types follow the JAX modules: images and maps are (B, H, W, C);
parameters are f32 and ``dtype`` is the encoder's compute type. A projection
casts its input and weights to it; the block norms compute in f32 (epsilon
1e-6), so after the f32 position embedding the encoder's stream is f32;
``LayerNorm2d`` computes in its input's type and its f32 scale promotes the
result to f32, so the image embedding is f32 and the prompt encoder and the
mask decoder run in f32 whatever ``dtype`` is. The relative-position biases
are added in the attention's type, their sum first: ``attn + (rel_h +
rel_w)``. Attention is plain matrix products: the JAX package has no Pallas
kernel for SAM.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.resize import resize_cubic, resize_linear

SAM_MEAN = (123.675, 116.28, 103.53)
SAM_STD = (58.395, 57.12, 57.375)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _conv_nhwc(x: torch.Tensor, layer: nn.Conv2d, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    y = F.conv2d(x.to(dtype).permute(0, 3, 1, 2), layer.weight.to(dtype), bias, layer.stride, layer.padding,
                 layer.dilation, layer.groups)
    return y.permute(0, 2, 3, 1)


def _conv_transpose_nhwc(x: torch.Tensor, layer: nn.ConvTranspose2d) -> torch.Tensor:
    y = F.conv_transpose2d(x.float().permute(0, 3, 1, 2), layer.weight, layer.bias, layer.stride)
    return y.permute(0, 2, 3, 1)


def _norm32(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """A flax ``LayerNorm`` computing in f32 (epsilon 1e-6), f32 out."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


class LayerNorm2d(nn.Module):
    """Channels-last LayerNorm over the feature axis, computed in the input's
    type with epsilon 1e-6; the f32 scale and shift promote the result."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-6) * self.weight + self.bias


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------

def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """(q_size, k_size, C) relative-position embeddings, the table resized
    ("linear", antialiased) first when its length is not 2 max(q, k) - 1."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = resize_linear(rel_pos, (max_rel_dist, rel_pos.shape[1]))
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.to(torch.int32).long()]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor, rel_pos_h: torch.Tensor, rel_pos_w: torch.Tensor,
                           q_hw: Tuple[int, int], k_hw: Tuple[int, int]) -> torch.Tensor:
    """attn (B, qh qw, kh kw) + the decomposed bias from the unscaled q
    (B, qh qw, C): the two (B, qh, qw, kh) and (B, qh, qw, kw) terms are made
    in f32, cast to attn's type, summed there, then added."""
    qh, qw = q_hw
    kh, kw = k_hw
    rh, rw = get_rel_pos(qh, kh, rel_pos_h), get_rel_pos(qw, kw, rel_pos_w)
    b, _, dim = q.shape
    r_q = q.reshape(b, qh, qw, dim).float()
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh.float()).to(attn.dtype)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw.float()).to(attn.dtype)
    bias = rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :]
    return (attn.view(b, qh, qw, kh, kw) + bias).view(b, qh * qw, kh * kw)


class SamAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int], dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        head = dim // num_heads
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, head))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, head))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C)."""
        b, h, w, c = x.shape
        nh, head = self.num_heads, c // self.num_heads
        qkv = _linear(x.reshape(b, h * w, c), self.qkv, self.dtype)
        qkv = qkv.reshape(b, h * w, 3, nh, head).permute(2, 0, 3, 1, 4).reshape(3, b * nh, h * w, head)
        q, k, v = qkv[0], qkv[1], qkv[2]
        attn = (q * head ** -0.5) @ k.transpose(-1, -2)
        attn = add_decomposed_rel_pos(attn, q, self.rel_pos_h, self.rel_pos_w, (h, w), (h, w))
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = (attn @ v).reshape(b, nh, h, w, head).permute(0, 2, 3, 1, 4).reshape(b, h, w, c)
        return _linear(out, self.proj, self.dtype)


def window_partition(x: torch.Tensor, window: int):
    """(B, H, W, C) -> (B nH nW, window, window, C) windows of the map padded
    with zeros at the bottom and right, and the padded (Hp, Wp)."""
    b, h, w, c = x.shape
    ph, pw = (window - h % window) % window, (window - w % window) % window
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c), (hp, wp)


def window_unpartition(win: torch.Tensor, window: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp * wp // window // window)
    x = win.reshape(b, hp // window, wp // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)[:, :h, :w]


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)


class SamBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window: int, global_attn: bool, input_size: Tuple[int, int],
                 dtype: torch.dtype):
        super().__init__()
        self.window = 0 if global_attn else window
        self.dtype = dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SamAttention(dim, num_heads, input_size if global_attn else (window, window), dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, dim * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _norm32(x, self.norm1)
        if self.window:
            win, pad_hw = window_partition(h, self.window)
            h = window_unpartition(self.attn(win), self.window, pad_hw, (x.shape[1], x.shape[2]))
        else:
            h = self.attn(h)
        x = x + h
        h = _linear(_norm32(x, self.norm2), self.mlp.lin1, self.dtype)
        return x + _linear(F.gelu(h), self.mlp.lin2, self.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, patch)


class ImageEncoderViT(nn.Module):
    def __init__(self, img_size: int = 1024, patch_size: int = 16, dim: int = 768, depth: int = 12,
                 num_heads: int = 12, out_chans: int = 256, global_attn_indexes: Sequence[int] = (2, 5, 8, 11),
                 window: int = 14, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.global_attn_indexes = tuple(global_attn_indexes)
        grid = img_size // patch_size
        self.patch_embed = PatchEmbed(dim, patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.blocks = nn.ModuleList(
            SamBlock(dim, num_heads, window, i in self.global_attn_indexes, (grid, grid), dtype) for i in range(depth))
        self.neck = nn.Sequential(nn.Conv2d(dim, out_chans, 1, bias=False), LayerNorm2d(out_chans),
                                  nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False), LayerNorm2d(out_chans))

    def forward(self, x: torch.Tensor, return_interm: bool = False):
        """x (B, H, W, 3) normalised pixels -> (B, H/16, W/16, 256) f32, and
        with ``return_interm`` the first global block's output (SAM-HQ's early
        ViT feature, (B, H/16, W/16, dim) f32)."""
        x = _conv_nhwc(x, self.patch_embed.proj, self.dtype)
        pos = self.pos_embed
        if x.shape[1:3] != pos.shape[1:3]:
            pos = resize_cubic(pos, (1, x.shape[1], x.shape[2], pos.shape[3]))
        x = x + pos
        interm = None
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if interm is None and i in self.global_attn_indexes:
                interm = x
        x = self.neck[1](_conv_nhwc(x, self.neck[0], self.dtype))
        x = self.neck[3](_conv_nhwc(x, self.neck[2], self.dtype))
        return (x, interm) if return_interm else x


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

class PositionEmbeddingRandom(nn.Module):
    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.zeros(2, num_pos_feats))

    def forward(self, coords01: torch.Tensor) -> torch.Tensor:
        """coords in [0, 1]^2 -> Fourier features (..., 2 num_pos_feats)."""
        coords = (2.0 * coords01 - 1.0) @ self.positional_encoding_gaussian_matrix
        coords = 2 * math.pi * coords
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256, image_embedding_size: Tuple[int, int] = (64, 64),
                 input_image_size: Tuple[int, int] = (1024, 1024)):
        super().__init__()
        self.image_embedding_size = image_embedding_size
        self.input_image_size = input_image_size
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        # 0: negative point, 1: positive point, 2 and 3: a box's two corners
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def dense_pe(self) -> torch.Tensor:
        """(h, w, C) positional encoding of the embedding grid's centres."""
        h, w = self.image_embedding_size
        dev = self.no_mask_embed.weight.device
        ys = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5) / h
        xs = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5) / w
        grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)], dim=-1)
        return self.pe_layer(grid)

    def encode_boxes(self, boxes: torch.Tensor) -> torch.Tensor:
        """boxes (N, 4) XYXY in model-input pixels -> sparse embeddings (N, 2, C)."""
        coords = boxes.float().reshape(-1, 2, 2) + 0.5
        size = torch.tensor([self.input_image_size[1], self.input_image_size[0]], dtype=torch.float32,
                            device=coords.device)
        pe = self.pe_layer(coords / size)
        corners = torch.stack([self.point_embeddings[2].weight[0], self.point_embeddings[3].weight[0]])
        return pe + corners


# ---------------------------------------------------------------------------
# mask decoder (two-way transformer)
# ---------------------------------------------------------------------------

class TwoWayAttention(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8, downsample_rate: int = 1):
        super().__init__()
        inner = embed_dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(embed_dim, inner)
        self.k_proj = nn.Linear(embed_dim, inner)
        self.v_proj = nn.Linear(embed_dim, inner)
        self.out_proj = nn.Linear(inner, embed_dim)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        inner = self.q_proj.out_features
        head = inner // self.num_heads

        def split(x):
            b, n, _ = x.shape
            return x.reshape(b, n, self.num_heads, head).transpose(1, 2)

        a = split(self.q_proj(q)) @ split(self.k_proj(k)).transpose(-1, -2) / math.sqrt(head)
        out = torch.softmax(a, dim=-1) @ split(self.v_proj(v))
        return self.out_proj(out.transpose(1, 2).reshape(q.shape[0], q.shape[1], inner))


class TwoWayAttentionBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.self_attn = TwoWayAttention(embed_dim, num_heads)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.cross_attn_token_to_image = TwoWayAttention(embed_dim, num_heads, 2)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.mlp = MLPBlock(embed_dim, mlp_dim)
        self.norm3 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.norm4 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.cross_attn_image_to_token = TwoWayAttention(embed_dim, num_heads, 2)

    def forward(self, queries, keys, tokens, pos, skip_first_layer_pe: bool):
        if skip_first_layer_pe:  # the first layer's self-attention replaces the queries
            queries = self.self_attn(queries, queries, queries)
        else:
            qp = queries + tokens
            queries = queries + self.self_attn(qp, qp, queries)
        queries = self.norm1(queries)
        qp, kp = queries + tokens, keys + pos
        queries = self.norm2(queries + self.cross_attn_token_to_image(qp, kp, keys))
        queries = self.norm3(queries + self.mlp.lin2(torch.relu(self.mlp.lin1(queries))))
        qp = queries + tokens
        keys = self.norm4(keys + self.cross_attn_image_to_token(kp, qp, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, embed_dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048, depth: int = 2):
        super().__init__()
        self.layers = nn.ModuleList(TwoWayAttentionBlock(embed_dim, num_heads, mlp_dim) for _ in range(depth))
        self.final_attn_token_to_image = TwoWayAttention(embed_dim, num_heads, 2)
        self.norm_final_attn = nn.LayerNorm(embed_dim, eps=1e-6)


class MLP(nn.Module):
    """``layers.{k}`` linears with relu between them."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


def _stack(first: nn.Module, norm: LayerNorm2d, last: nn.Module) -> nn.Sequential:
    """Sequential(first, LayerNorm2d, GELU, last): the official indices 0, 1, 3."""
    return nn.Sequential(first, norm, nn.GELU(), last)


def _apply_stack(x: torch.Tensor, seq: nn.Sequential) -> torch.Tensor:
    conv = _conv_transpose_nhwc if isinstance(seq[0], nn.ConvTranspose2d) else \
        (lambda t, layer: _conv_nhwc(t, layer, torch.float32))
    return conv(F.gelu(seq[1](conv(x.float(), seq[0]))), seq[3])


class MaskDecoder(nn.Module):
    """SAM's two-way-transformer mask decoder; with ``hq`` SAM-HQ's
    MaskDecoderHQ: the HQ token and its MLP, and the fused plane
    (``embedding_encoder`` on the neck output plus ``compress_vit_feat`` on
    the early ViT feature, read only by the HQ mask through
    ``embedding_maskfeature``). The IoU head predicts 4 scores in both."""

    def __init__(self, embed_dim: int = 256, num_heads: int = 8, mlp_dim: int = 2048, num_multimask: int = 3,
                 hq: bool = False, vit_dim: int = 768):
        super().__init__()
        self.embed_dim, self.num_multimask, self.hq = embed_dim, num_multimask, hq
        n_masks = num_multimask + 1
        self.transformer = TwoWayTransformer(embed_dim, num_heads, mlp_dim)
        self.iou_token = nn.Embedding(1, embed_dim)
        self.mask_tokens = nn.Embedding(n_masks, embed_dim)
        self.output_upscaling = nn.Sequential(
            nn.ConvTranspose2d(embed_dim, embed_dim // 4, 2, 2), LayerNorm2d(embed_dim // 4), nn.GELU(),
            nn.ConvTranspose2d(embed_dim // 4, embed_dim // 8, 2, 2), nn.GELU())
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP((embed_dim, embed_dim, embed_dim, embed_dim // 8)) for _ in range(n_masks))
        self.iou_prediction_head = MLP((embed_dim, embed_dim, embed_dim, n_masks))
        if hq:
            ed = embed_dim
            self.hf_token = nn.Embedding(1, ed)
            self.hf_mlp = MLP((ed, ed, ed, ed // 8))
            self.compress_vit_feat = _stack(nn.ConvTranspose2d(vit_dim, ed, 2, 2), LayerNorm2d(ed),
                                            nn.ConvTranspose2d(ed, ed // 8, 2, 2))
            self.embedding_encoder = _stack(nn.ConvTranspose2d(ed, ed // 4, 2, 2), LayerNorm2d(ed // 4),
                                            nn.ConvTranspose2d(ed // 4, ed // 8, 2, 2))
            self.embedding_maskfeature = _stack(nn.Conv2d(ed // 8, ed // 4, 3, 1, 1), LayerNorm2d(ed // 4),
                                                nn.Conv2d(ed // 4, ed // 8, 3, 1, 1))

    def hq_features(self, image_embed: torch.Tensor, vit_feat: torch.Tensor) -> torch.Tensor:
        """The fused plane (1, 4h, 4w, C/8) from the raw embedding and the
        early ViT feature."""
        return _apply_stack(image_embed, self.embedding_encoder) + _apply_stack(vit_feat, self.compress_vit_feat)

    def forward(self, image_embed: torch.Tensor, image_pe: torch.Tensor, sparse: torch.Tensor,
                hq_feat: Optional[torch.Tensor] = None):
        """image_embed (N, h, w, C), image_pe (h, w, C), sparse (N, P, C);
        returns mask logits (N, n_tokens, 4h, 4w) and IoU scores (N, 4)."""
        n, h, w, c = image_embed.shape
        toks = [self.iou_token.weight.expand(n, 1, c), self.mask_tokens.weight.expand(n, -1, c)]
        if self.hq:
            toks.append(self.hf_token.weight.expand(n, 1, c))
        tokens = torch.cat(toks + [sparse.float()], dim=1)
        keys = image_embed.float().reshape(n, h * w, c)
        pos = image_pe.float().reshape(1, h * w, c).expand(n, -1, -1)
        queries = tokens
        tf = self.transformer
        for i, layer in enumerate(tf.layers):
            queries, keys = layer(queries, keys, tokens, pos, skip_first_layer_pe=i == 0)
        qp, kp = queries + tokens, keys + pos
        queries = tf.norm_final_attn(queries + tf.final_attn_token_to_image(qp, kp, keys))

        n_tok = self.num_multimask + 1 + int(self.hq)
        iou_out, mask_toks = queries[:, 0], queries[:, 1:1 + n_tok]
        up_layers = self.output_upscaling
        up = _conv_transpose_nhwc(keys.reshape(n, h, w, c), up_layers[0])
        up = F.gelu(up_layers[1](up))
        up = F.gelu(_conv_transpose_nhwc(up, up_layers[3]))  # (N, 4h, 4w, C/8)
        hyper = torch.stack([mlp(mask_toks[:, i]) for i, mlp in enumerate(self.output_hypernetworks_mlps)], 1)
        masks = torch.einsum("nmc,nhwc->nmhw", hyper, up)
        if self.hq:
            up_hq = _apply_stack(up, self.embedding_maskfeature) + hq_feat
            hq_hyper = self.hf_mlp(mask_toks[:, n_tok - 1])
            masks = torch.cat([masks, torch.einsum("nc,nhwc->nhw", hq_hyper, up_hq)[:, None]], dim=1)
        return masks, self.iou_prediction_head(iou_out)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

class Sam(nn.Module):
    """Image encoder, prompt encoder and mask decoder (ViT-B by default).

    ``hq`` builds SAM-HQ: ``decode_boxes`` returns the SAM mask plus the HQ
    correction (``hq_token_only=False``, the reference's default) or the HQ
    mask alone. ``encoder_type`` is "vit" or "vit_tiny" (TinyViT-5M, whose
    stage-2 feature of 160 channels is the HQ decoder's early feature)."""

    def __init__(self, encoder_dim: int = 768, encoder_depth: int = 12, encoder_heads: int = 12,
                 global_attn_indexes: Sequence[int] = (2, 5, 8, 11), img_size: int = 1024, hq: bool = False,
                 encoder_type: str = "vit", dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size, self.hq, self.dtype = img_size, hq, dtype
        if encoder_type == "vit_tiny":
            from .tinyvit import TinyViT

            self.image_encoder = TinyViT(img_size=img_size, dtype=dtype)
            vit_dim = 160
        elif encoder_type == "vit":
            self.image_encoder = ImageEncoderViT(img_size=img_size, dim=encoder_dim, depth=encoder_depth,
                                                 num_heads=encoder_heads, global_attn_indexes=global_attn_indexes,
                                                 dtype=dtype)
            vit_dim = encoder_dim
        else:
            raise ValueError(f"unknown encoder_type '{encoder_type}' (vit or vit_tiny)")
        grid = img_size // 16
        self.prompt_encoder = PromptEncoder(image_embedding_size=(grid, grid), input_image_size=(img_size, img_size))
        self.mask_decoder = MaskDecoder(hq=hq, vit_dim=vit_dim)

    def encode_image(self, x: torch.Tensor):
        """(1, S, S, 3) normalised image -> the (1, h, w, 256) embedding; with
        ``hq`` the pair (embedding, early ViT feature)."""
        return self.image_encoder(x, return_interm=True) if self.hq else self.image_encoder(x)

    def decode_boxes(self, image_embed, boxes: torch.Tensor, multimask_output: bool = False,
                     hq_token_only: bool = False) -> torch.Tensor:
        """``encode_image``'s output and boxes (N, 4) XYXY in model-input
        pixels -> mask logits (N, 4h, 4w), f32. Each box's tokens attend only
        within their own row, so N boxes in one call give the logits of N
        calls of one box."""
        vit_feat = None
        if self.hq:
            image_embed, vit_feat = image_embed
        pe = self.prompt_encoder
        sparse = pe.encode_boxes(boxes)
        n = boxes.shape[0]
        img = (image_embed + pe.no_mask_embed.weight[0]).expand(n, -1, -1, -1)
        hq_feat = self.mask_decoder.hq_features(image_embed, vit_feat) if self.hq else None
        masks, iou_pred = self.mask_decoder(img, pe.dense_pe(), sparse, hq_feat)
        if multimask_output:
            best = torch.argmax(iou_pred[:, 1:], dim=1) + 1
            sam_mask = masks[torch.arange(n, device=masks.device), best]
        else:
            sam_mask = masks[:, 0]
        if not self.hq:
            return sam_mask
        return masks[:, -1] if hq_token_only else sam_mask + masks[:, -1]

    def forward(self, x: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        return self.decode_boxes(self.encode_image(x), boxes)


def preprocess_sam_image(img_rgb: torch.Tensor, img_size: int = 1024):
    """(H, W, 3) RGB in 0..255 -> ((1, S, S, 3) resized ("linear") so the
    longer side is S, normalised and zero-padded at the bottom and right,
    the scale used)."""
    h, w = img_rgb.shape[:2]
    scale = img_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    x = resize_linear(img_rgb.float(), (nh, nw, 3))
    mean = torch.tensor(SAM_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(SAM_STD, dtype=torch.float32, device=x.device)
    out = torch.zeros((img_size, img_size, 3), dtype=torch.float32, device=x.device)
    out[:nh, :nw] = (x - mean) / std
    return out[None], scale


def masks_from_logits(logits: torch.Tensor, img_size: int, scale: float, height: int, width: int) -> torch.Tensor:
    """(N, S/4, S/4) logits -> (N, height, width) uint8 masks as the asset
    tools make them: "linear" resize to S x S, crop to the resized image,
    "linear" resize (antialiased) to the image, > 0."""
    up = resize_linear(logits.float(), (logits.shape[0], img_size, img_size))
    nh, nw = int(round(height * scale)), int(round(width * scale))
    return (resize_linear(up[:, :nh, :nw], (logits.shape[0], height, width)) > 0).to(torch.uint8)


@torch.no_grad()
def init_weights(model: Sam, generator: torch.Generator) -> None:
    """Seeded initialisation after the JAX package's initialisers:
    lecun-normal projections and convolutions with zero biases, norms at
    identity, normal(1) prompt embeddings, tokens and Fourier matrix, zero
    position embedding and relative positions. Draws are made on the CPU, so a
    seed gives the same weights on every device."""
    from .tinyvit import Conv2dBN

    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            w = m.weight
            fan_in = w[0].numel() if not isinstance(m, nn.ConvTranspose2d) else w[:, 0].numel()
            w.copy_(torch.randn(w.shape, generator=generator) / fan_in ** 0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, LayerNorm2d)):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, Conv2dBN):
            m.bn.reset()
    model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.copy_(
        torch.randn(model.prompt_encoder.pe_layer.positional_encoding_gaussian_matrix.shape, generator=generator))
    for name, p in model.named_parameters():
        if name.endswith(("pos_embed", "rel_pos_h", "rel_pos_w", "attention_biases")):
            p.zero_()


def build_sam(hq: bool = True, img_size: int = 1024, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
              **kwargs) -> Sam:
    """The seeded model in eval mode (full ViT-B unless ``kwargs`` say
    otherwise)."""
    model = Sam(img_size=img_size, hq=hq, dtype=dtype, **kwargs)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.eval()


# official-checkpoint tensors of paths the box prompts never take (the mask prompt)
UNUSED_CHECKPOINT_PREFIXES = ("prompt_encoder.mask_downscaling.",)


def vit_config(sd) -> dict:
    """The ViT encoder's width, depth, heads and global blocks, read from a
    state dict's shapes: a block whose relative-position table is not the
    14-window's (27 rows) attends globally."""
    enc = "image_encoder.blocks."
    depth = 1 + max(int(k[len(enc):].split(".")[0]) for k in sd if k.startswith(enc))
    dim = sd["image_encoder.patch_embed.proj.weight"].shape[0]
    head_dim = sd[f"{enc}0.attn.rel_pos_h"].shape[1]
    return dict(encoder_dim=dim, encoder_depth=depth, encoder_heads=dim // head_dim,
                global_attn_indexes=tuple(i for i in range(depth) if sd[f"{enc}{i}.attn.rel_pos_h"].shape[0] != 27))


def load_sam(checkpoint: str, img_size: int, device: torch.device, dtype: torch.dtype = torch.bfloat16) -> Sam:
    """The asset tools' SAM on ``device``: a SAM or SAM-HQ checkpoint's state
    dict (official names; HQ when it holds ``mask_decoder.hf_token.weight``;
    the ViT's size from its shapes, ``vit_config``), loaded strictly after the
    mask prompt's tensors are dropped; without a checkpoint, plain ViT-B SAM
    with seeded weights (the JAX tools' ``model.init`` stand-in)."""
    if not checkpoint:
        return build_sam(hq=False, img_size=img_size, dtype=dtype).to(device)
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    sd = {k: v for k, v in sd.items() if not k.startswith(UNUSED_CHECKPOINT_PREFIXES)}
    model = Sam(img_size=img_size, hq="mask_decoder.hf_token.weight" in sd, dtype=dtype, **vit_config(sd))
    model.load_state_dict(sd, strict=True)
    return model.eval().to(device)


@torch.no_grad()
def masks_for_boxes(model: Sam, image: torch.Tensor, boxes, img_size: int) -> torch.Tensor:
    """(H, W, 3) uint8 RGB and N boxes [x1, y1, x2, y2] in image pixels ->
    (N, H, W) uint8 masks, as the asset tools make them: the image encoded
    once, all boxes decoded in one ``decode_boxes`` call (each box's tokens
    attend only within their row, so this is the tools' one call a box), the
    logits resized back to the image and thresholded at 0."""
    h, w = image.shape[:2]
    x, scale = preprocess_sam_image(image, img_size)
    boxes_in = torch.tensor([[c * scale for c in box] for box in boxes], dtype=torch.float32, device=image.device)
    logits = model.decode_boxes(model.encode_image(x), boxes_in)
    return masks_from_logits(logits, img_size, scale, h, w)
