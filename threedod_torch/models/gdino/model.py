"""GroundingDINO, the text-prompted open-vocabulary detector of the asset
pipeline (counterpart of ``threedod/models/gdino/model.py``).

  Swin-T (p3, p4, p5) + 1x1 projections with GroupNorm + an extra stride-2
    level -> four levels, S tokens of 256
  BERT-base over the prompt's token ids -> 768 -> 256 (``feat_map``)
  feature enhancer, 6 layers: image <-> text fusion (``BiAttentionBlock``),
    text self-attention and FFN, deformable image self-attention and FFN
  language-guided query selection: the top 900 tokens by their largest
    text-token logit
  cross-modality decoder, 6 layers: query self-attention, text
    cross-attention, deformable image cross-attention (kernel K3 on the card),
    FFN; iterative box refinement
  contrastive logits against the text tokens.

Parameter names are the official checkpoint's (``backbone.0``, ``bert``,
``feat_map``, ``input_proj.{i}.{0,1}``, ``transformer.*``,
``bbox_embed.{i}.layers.{k}``); ``utils/convert_weights.py::
gdino_from_jax_variables`` makes a state dict from the JAX package's params.
Images come in as (B, H, W, 3), normalised, as in the JAX package. The
forward returns (logits (B, Q, Lt), boxes (B, Q, 4) cxcywh in [0, 1], the
stage outputs the JAX model sows: vis_in, txt_in, vis_enc, txt_enc, and the
selected token indices, top_idx).

Types follow the JAX model: parameters f32, projections in the compute
dtype, norms in f32 cast back, and where an f32 parameter scales a branch
(the fusion's gammas) the stream is f32 until the next norm. The constants of
an image size (sine embeddings of the grid, reference points) are computed
once on the CPU in f32 and kept on the device, so the card and the CPU start
from the same values and a forward does not rebuild them.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .bert import BertEncoder, attention_mask
from .deformable import MSDeformAttn
from .layers import MLP, container, ffn, layer_norm, linear
from .swin import SwinT


def _interleaved_sincos(pos: torch.Tensor, num: int, temperature: float) -> torch.Tensor:
    """The DETR interleave: out[2k] = sin(p / t_k), out[2k + 1] = cos(p / t_k),
    t_k = T^(2k / num). The periods are computed in float64 and rounded to
    f32 before the division, as JAX does with a float64 numpy array."""
    i = np.arange(num)
    t = torch.from_numpy((temperature ** (2 * (i // 2) / num)).astype(np.float32)).to(pos.device)
    p = pos[..., None] / t
    emb = torch.stack([torch.sin(p[..., 0::2]), torch.cos(p[..., 1::2])], dim=-1)
    return emb.reshape(pos.shape + (num,))


def sine_pos_embed_2d(h: int, w: int, dim: int = 256, temperature: float = 20.0) -> torch.Tensor:
    """(H * W, dim) f32 on the CPU: 1-based coordinates over the extent
    (y / f32(h + eps) * f32(2 pi)), interleaved sin/cos, (y-block, x-block)."""
    eps, scale = 1e-6, torch.tensor(2 * math.pi, dtype=torch.float32)
    yy, xx = torch.meshgrid(torch.arange(1, h + 1, dtype=torch.float32),
                            torch.arange(1, w + 1, dtype=torch.float32), indexing="ij")
    ys = yy / torch.tensor(h + eps, dtype=torch.float32) * scale
    xs = xx / torch.tensor(w + eps, dtype=torch.float32) * scale
    num = dim // 2
    emb = torch.cat([_interleaved_sincos(ys, num, temperature), _interleaved_sincos(xs, num, temperature)], dim=-1)
    return emb.reshape(h * w, dim)


def sine_pos_embed_boxes(boxes: torch.Tensor, dim: int = 256, temperature: float = 10000.0) -> torch.Tensor:
    """(..., 4) cxcywh -> (..., 2 * dim), concatenated in the official order
    (cy, cx, w, h)."""
    scale, num = 2 * math.pi, dim // 2
    cx, cy, w, h = (_interleaved_sincos(boxes[..., i] * scale, num, temperature) for i in range(4))
    return torch.cat([cy, cx, w, h], dim=-1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def reference_points(shapes: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """(S, 2) f32 on the CPU: each token's normalised centre (x, y)."""
    refs = []
    for h, w in shapes:
        ys = (torch.arange(h, dtype=torch.float32) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32) + 0.5) / w
        yy, xx = torch.meshgrid(ys, xs, indexing="ij")
        refs.append(torch.stack([xx, yy], dim=-1).reshape(-1, 2))
    return torch.cat(refs, dim=0)


@functools.lru_cache(maxsize=16)
def _grid_constants(shapes: Tuple[Tuple[int, int], ...], dim: int, device: torch.device):
    """The constants of one image size, built once on the CPU in f32 and kept
    on ``device``: every token's sine embedding (S, dim), level (S,), centre
    (S, 2) and proposal size wh = 0.05 * 2^level (S, 2). Built outside
    inference mode, so a later forward with autograd on may use them."""
    with torch.inference_mode(False), torch.no_grad():
        pos = torch.cat([sine_pos_embed_2d(h, w, dim) for h, w in shapes], dim=0)
        level = torch.cat([torch.full((h * w,), i, dtype=torch.long) for i, (h, w) in enumerate(shapes)])
        wh = torch.cat([torch.full((h * w, 2), 0.05 * 2.0 ** i) for i, (h, w) in enumerate(shapes)])
        return tuple(t.to(device) for t in (pos, level, reference_points(shapes), wh))


class MHA(nn.Module):
    """Multi-head attention with separate q, k, v inputs; the official
    checkpoint packs the three input projections (``in_proj_weight``,
    ``in_proj_bias``) beside ``out_proj``."""

    def __init__(self, dim: int, heads: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, q, k, v, mask=None):
        b, lq, d = q.shape
        h, dt = self.heads, self.dtype
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)

        def proj(x, i):
            t = F.linear(x.to(dt), w[i * d:(i + 1) * d], bias[i * d:(i + 1) * d])
            return t.reshape(b, -1, h, d // h).transpose(1, 2)

        attn = (proj(q, 0) @ proj(k, 1).transpose(-2, -1)) * (d // h) ** -0.5
        if mask is not None:
            attn = attn.masked_fill(~attention_mask(mask), -1e9)
        out = (torch.softmax(attn, dim=-1) @ proj(v, 2)).transpose(1, 2).reshape(b, lq, d)
        return linear(out, self.out_proj, dt)


class BiAttentionBlock(nn.Module):
    """GLIP-style image <-> text fusion with layer scale. The logits' maximum
    over both axes is subtracted; only the image-to-text softmax is masked;
    the text-to-image softmax runs over the image axis; the residuals land on
    the normalised features, scaled by the f32 gammas."""

    def __init__(self, dim: int = 256, embed: int = 1024, heads: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed, self.heads, self.dtype = embed, heads, dtype
        self.layer_norm_v = nn.LayerNorm(dim, eps=1e-6)
        self.layer_norm_l = nn.LayerNorm(dim, eps=1e-6)
        self.attn = container(v_proj=nn.Linear(dim, embed), l_proj=nn.Linear(dim, embed),
                              values_v_proj=nn.Linear(dim, embed), values_l_proj=nn.Linear(dim, embed),
                              out_v_proj=nn.Linear(embed, dim), out_l_proj=nn.Linear(embed, dim))
        self.gamma_v = nn.Parameter(torch.full((dim,), 1e-4))
        self.gamma_l = nn.Parameter(torch.full((dim,), 1e-4))

    def forward(self, vis, txt, txt_mask):
        dt, a = self.dtype, self.attn
        v = layer_norm(vis, self.layer_norm_v).to(dt)
        t = layer_norm(txt, self.layer_norm_l).to(dt)
        b, lv, _ = v.shape
        h, hd = self.heads, self.embed // self.heads

        def split(x):
            return x.reshape(b, -1, h, hd).transpose(1, 2)

        attn = split(linear(v, a.v_proj, dt)) @ split(linear(t, a.l_proj, dt)).transpose(-2, -1) * hd ** -0.5
        attn = attn - attn.amax(dim=(-1, -2), keepdim=True)
        a_v2t = torch.softmax(attn.masked_fill(~txt_mask[:, None, None, :], -1e9), dim=-1)
        a_t2v = torch.softmax(attn, dim=-2)
        dv = (a_v2t @ split(linear(t, a.values_l_proj, dt))).transpose(1, 2).reshape(b, lv, self.embed)
        dt_ = (a_t2v.transpose(-2, -1) @ split(linear(v, a.values_v_proj, dt))).transpose(1, 2)
        dt_ = dt_.reshape(b, -1, self.embed)
        dv = linear(dv, a.out_v_proj, dt)
        dt_ = linear(dt_, a.out_l_proj, dt)
        return v + self.gamma_v * dv, t + self.gamma_l * dt_


class TextEnhancerLayer(nn.Module):
    """Text self-attention (queries and keys carry the text position
    embedding) and FFN of one enhancer layer."""

    def __init__(self, dim: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MHA(dim, 4, dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.linear1 = nn.Linear(dim, 1024)
        self.linear2 = nn.Linear(1024, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, txt, txt_pos, mask):
        tq = txt if txt_pos is None else txt + txt_pos
        t = self.self_attn(tq, tq, txt, mask)
        txt = layer_norm(txt + t, self.norm1).to(self.dtype)
        return ffn(txt, self.linear1, self.linear2, self.norm2, self.dtype)


class DeformableEncoderLayer(nn.Module):
    """Deformable image self-attention (K3) and FFN of one enhancer layer."""

    def __init__(self, dim: int = 256, levels: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MSDeformAttn(dim, 8, levels, 4, dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.linear1 = nn.Linear(dim, 2048)
        self.linear2 = nn.Linear(2048, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, vis, vis_pos, ref_points, shapes):
        d = self.self_attn(vis + vis_pos, ref_points, vis, shapes)
        vis = layer_norm(vis + d, self.norm1).to(self.dtype)
        return ffn(vis, self.linear1, self.linear2, self.norm2, self.dtype)


class Encoder(nn.Module):
    """The feature enhancer; its three lists are the official checkpoint's."""

    def __init__(self, layers: int = 6, dim: int = 256, levels: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(DeformableEncoderLayer(dim, levels, dtype) for _ in range(layers))
        self.text_layers = nn.ModuleList(TextEnhancerLayer(dim, dtype) for _ in range(layers))
        self.fusion_layers = nn.ModuleList(BiAttentionBlock(dim, dtype=dtype) for _ in range(layers))

    def enhancer_layer(self, i: int, vis, txt, txt_mask, vis_pos, ref_points, shapes, txt_pos=None,
                       txt_self_mask=None):
        """Layer i, the JAX package's ``EnhancerLayer``: fusion, then the text
        branch (masked by the per-phrase mask where given), then the image
        branch."""
        vis, txt = self.fusion_layers[i](vis, txt, txt_mask)
        txt = self.text_layers[i](txt, txt_pos, txt_self_mask if txt_self_mask is not None else txt_mask)
        return self.layers[i](vis, vis_pos, ref_points, shapes), txt


class DecoderLayer(nn.Module):
    """Query self-attention, text cross-attention, deformable image
    cross-attention (K3, box references) and FFN. The official norms by role:
    ``norm2`` after the self-attention, ``norm1`` after the image
    cross-attention, ``norm3`` after the FFN."""

    def __init__(self, dim: int = 256, levels: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MHA(dim, 8, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.ca_text = MHA(dim, 8, dtype)
        self.catext_norm = nn.LayerNorm(dim, eps=1e-6)
        self.cross_attn = MSDeformAttn(dim, 8, levels, 4, dtype)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.linear1 = nn.Linear(dim, 2048)
        self.linear2 = nn.Linear(2048, dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, q, qpos, txt, txt_mask, vis, ref_boxes, shapes):
        dt = self.dtype
        s = self.self_attn(q + qpos, q + qpos, q)
        q = layer_norm(q + s, self.norm2).to(dt)
        t = self.ca_text(q + qpos, txt, txt, txt_mask)
        q = layer_norm(q + t, self.catext_norm).to(dt)
        refs = ref_boxes[:, :, None].expand(ref_boxes.shape[0], ref_boxes.shape[1], len(shapes), 4)
        d = self.cross_attn(q + qpos, refs, vis, shapes)
        q = layer_norm(q + d, self.norm1).to(dt)
        return ffn(q, self.linear1, self.linear2, self.norm3, dt)


class GroundingDINO(nn.Module):
    def __init__(self, num_queries: int = 900, dim: int = 256, enc_layers: int = 6, dec_layers: int = 6,
                 levels: int = 4, swin_depths: Tuple[int, ...] = (2, 2, 6, 2), bert_layers: int = 12,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_queries, self.dim, self.levels, self.dtype = num_queries, dim, levels, dtype
        self.backbone = nn.ModuleList([SwinT(depths=swin_depths, dtype=dtype)])
        self.bert = BertEncoder(layers=bert_layers, dtype=dtype)
        self.feat_map = nn.Linear(768, dim)
        widths = (192, 384, 768)  # Swin-T's p3, p4, p5
        self.input_proj = nn.ModuleList(
            [nn.Sequential(nn.Conv2d(c, dim, 1), nn.GroupNorm(32, dim, eps=1e-6)) for c in widths]
            + [nn.Sequential(nn.Conv2d(widths[-1], dim, 3, stride=2, padding=1), nn.GroupNorm(32, dim, eps=1e-6))])
        self.transformer = container(
            level_embed=nn.Parameter(torch.zeros(levels, dim)),
            encoder=Encoder(enc_layers, dim, levels, dtype),
            enc_output=nn.Linear(dim, dim), enc_output_norm=nn.LayerNorm(dim, eps=1e-6),
            enc_out_bbox_embed=MLP((dim, dim, dim, 4), dtype),
            tgt_embed=nn.Embedding(num_queries, dim),
            decoder=container(layers=nn.ModuleList(DecoderLayer(dim, levels, dtype) for _ in range(dec_layers)),
                              ref_point_head=MLP((2 * dim, dim, dim), dtype),
                              norm=nn.LayerNorm(dim, eps=1e-6)))
        self.bbox_embed = nn.ModuleList(MLP((dim, dim, dim, 4), dtype) for _ in range(dec_layers))

    def _levels(self, feats: Dict[str, torch.Tensor]):
        """Projected and normalised levels, flattened (B, H_l * W_l, dim) in
        (H, W) order, and their shapes."""
        dt, srcs, shapes = self.dtype, [], []
        for i, x in enumerate((feats["p3"], feats["p4"], feats["p5"], feats["p5"])):
            conv, gn = self.input_proj[i]
            s = F.conv2d(x.permute(0, 3, 1, 2).to(dt), conv.weight.to(dt), conv.bias.to(dt),
                         stride=conv.stride, padding=conv.padding)
            s = F.group_norm(s.float(), gn.num_groups, gn.weight, gn.bias, gn.eps).to(dt)
            shapes.append((s.shape[2], s.shape[3]))
            srcs.append(s.flatten(2).transpose(1, 2))
        return srcs, shapes

    def forward(self, image, token_ids, token_mask, text_self_mask=None, position_ids=None):
        """image (B, H, W, 3) normalised; token_ids, token_mask (B, Lt);
        text_self_mask (B, Lt, Lt) and position_ids (B, Lt) from
        ``generate_text_masks``, or the padding mask and arange."""
        dt, dev, tr = self.dtype, image.device, self.transformer
        b, lt = token_ids.shape
        feats = self.backbone[0](image)
        txt = self.bert(token_ids, text_self_mask if text_self_mask is not None else token_mask,
                        position_ids=position_ids)
        txt = linear(txt, self.feat_map, dt)
        pos_ids = position_ids if position_ids is not None else torch.arange(lt, device=dev).expand(b, lt)
        txt_pos = _interleaved_sincos(pos_ids.float() * 2 * math.pi, self.dim, 10000.0).to(dt)

        srcs, shapes = self._levels(feats)
        vis = torch.cat(srcs, dim=1)
        inter = {"vis_in": vis, "txt_in": txt}
        grid_pos, level, ref_2d, wh = _grid_constants(tuple(shapes), self.dim, dev)
        pos = (grid_pos + tr.level_embed[level])[None].to(dt)
        s = ref_2d.shape[0]
        ref_pts = ref_2d[None, :, None, :].expand(b, s, self.levels, 2)

        for i in range(len(tr.encoder.layers)):
            vis, txt = tr.encoder.enhancer_layer(i, vis, txt, token_mask, pos, ref_pts, shapes,
                                                 txt_pos=txt_pos, txt_self_mask=text_self_mask)
        inter.update(vis_enc=vis, txt_enc=txt)

        # language-guided query selection: ties go to the lower index, as in
        # jax.lax.top_k (torch.topk promises no order on the card)
        mem = layer_norm(linear(vis, tr.enc_output, dt), tr.enc_output_norm).to(dt)
        logits_all = (mem @ txt.transpose(1, 2)).masked_fill(~token_mask[:, None, :], -1e9)
        k = min(self.num_queries, s)
        top_idx = torch.sort(logits_all.amax(dim=-1), dim=1, descending=True, stable=True).indices[:, :k]
        inter["top_idx"] = top_idx

        # proposals: each token's centre with wh = 0.05 * 2^level
        base = torch.cat([ref_2d, wh], dim=-1)[None].expand(b, s, 4)
        enc_boxes = torch.sigmoid(tr.enc_out_bbox_embed(mem) + inverse_sigmoid(base))
        ref_boxes = torch.gather(enc_boxes, 1, top_idx[..., None].expand(b, k, 4))
        q = tr.tgt_embed.weight[:k][None].expand(b, k, self.dim).to(dt)

        for layer, box_mlp in zip(tr.decoder.layers, self.bbox_embed):
            qpos = tr.decoder.ref_point_head(sine_pos_embed_boxes(ref_boxes, self.dim))
            q = layer(q, qpos, txt, token_mask, vis, ref_boxes, shapes)
            ref_boxes = torch.sigmoid(box_mlp(q) + inverse_sigmoid(ref_boxes))

        q = layer_norm(q, tr.decoder.norm).to(dt)
        logits = (q @ txt.transpose(1, 2)).masked_fill(~token_mask[:, None, :], float("-inf"))
        return logits, ref_boxes, inter


def best_box_for_prompt(logits: torch.Tensor, boxes: torch.Tensor, image_hw: torch.Tensor):
    """The asset pipeline's contract: the single best box for the prompt, in
    pixel xyxy, and its score (sigmoid of the best token logit)."""
    score = torch.sigmoid(logits.amax(dim=-1))  # (B, Q)
    idx = score.argmax(dim=1)
    rows = torch.arange(boxes.shape[0], device=boxes.device)
    best = boxes[rows, idx]
    h, w = image_hw[:, 0].to(best.dtype), image_hw[:, 1].to(best.dtype)
    cx, cy, bw, bh = best[:, 0] * w, best[:, 1] * h, best[:, 2] * w, best[:, 3] * h
    xyxy = torch.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
    return xyxy, score[rows, idx]


SPECIAL_TOKEN_IDS = (101, 102, 1012, 1029)  # [CLS], [SEP], '.', '?'


def generate_text_masks(token_ids: np.ndarray, special_ids=SPECIAL_TOKEN_IDS):
    """The official per-phrase text masks on the host: special tokens split
    the prompt into phrases; each phrase (with its closing special token)
    attends within itself, [CLS] and the last token only to themselves, and
    positions restart at 0 in each phrase.

    token_ids (B, L) int -> (self_mask (B, L, L) bool, position_ids (B, L) int64)
    """
    token_ids = np.asarray(token_ids)
    b, l = token_ids.shape
    special = np.isin(token_ids, np.asarray(special_ids))
    mask = np.tile(np.eye(l, dtype=bool)[None], (b, 1, 1))
    pos = np.zeros((b, l), np.int64)
    for r in range(b):
        prev = 0
        for c in np.nonzero(special[r])[0]:
            if c == 0 or c == l - 1:
                mask[r, c, c] = True
                pos[r, c] = 0
            else:
                mask[r, prev + 1:c + 1, prev + 1:c + 1] = True
                pos[r, prev + 1:c + 1] = np.arange(0, c - prev)
            prev = c
    return mask, pos


def build_groundingdino(dtype: torch.dtype = torch.float32, seed: int = 0, **config) -> GroundingDINO:
    """A GroundingDINO with seeded weights: lecun-normal kernels (packed
    attention projections included), biases of std 0.02, norm scales in 0.8
    to 1.2, fusion gammas in 0.5 to 1 (where the official init's 1e-4 would
    leave the fusion silent), the Swin bias tables of std 0.02, and
    embeddings, level embeddings and query embeddings of std 1. At these
    scales the deformable offsets move samples a pixel or two, so the
    samples land inside the maps, across their borders and outside."""
    model = GroundingDINO(dtype=dtype, **config)
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, std):
        return torch.randn(shape, generator=gen) * std

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "relative_position_bias_table":
                p.copy_(normal(p.shape, 0.02))
            elif leaf.startswith("gamma_"):
                p.copy_(0.5 + 0.5 * torch.rand(p.shape, generator=gen))
            elif p.dim() == 1 and leaf == "weight":  # LayerNorm and GroupNorm scales
                p.copy_(0.8 + 0.4 * torch.rand(p.shape, generator=gen))
            elif p.dim() == 1:  # biases
                p.copy_(normal(p.shape, 0.02))
            elif leaf == "level_embed" or "embeddings." in name or "tgt_embed" in name:
                p.copy_(normal(p.shape, 1.0))
            else:  # kernels: fan-in is every dimension but the first
                p.copy_(normal(p.shape, 1.0 / math.sqrt(p[0].numel())))
    return model
