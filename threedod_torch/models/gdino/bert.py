"""BERT-base text encoder of GroundingDINO (counterpart of
``threedod/models/gdino/bert.py``): token ids in, hidden states out, no
tokenizer. Names are the official checkpoint's under ``bert``:
``embeddings.{word_embeddings, position_embeddings, token_type_embeddings,
LayerNorm}`` and ``encoder.layer.{i}.{attention.self.{query, key, value},
attention.output.{dense, LayerNorm}, intermediate.dense, output.{dense,
LayerNorm}}``. Norms use epsilon 1e-12 and compute in f32; gelu is the exact
one.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import container, layer_norm, linear


def attention_mask(mask: torch.Tensor) -> torch.Tensor:
    """(B, L) padding mask or (B, L, L) pairwise mask -> broadcastable over
    (B, heads, Lq, Lk)."""
    return mask[:, None, :, :] if mask.dim() == 3 else mask[:, None, None, :]


class BertLayer(nn.Module):
    def __init__(self, dim: int = 768, heads: int = 12, ffn: int = 3072, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.heads, self.dtype = heads, dtype
        self.attention = container(
            self=container(query=nn.Linear(dim, dim), key=nn.Linear(dim, dim), value=nn.Linear(dim, dim)),
            output=container(dense=nn.Linear(dim, dim), LayerNorm=nn.LayerNorm(dim, eps=1e-12)))
        self.intermediate = container(dense=nn.Linear(dim, ffn))
        self.output = container(dense=nn.Linear(ffn, dim), LayerNorm=nn.LayerNorm(dim, eps=1e-12))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        b, l, d = x.shape
        h, dt = self.heads, self.dtype
        att = self.attention.self

        def split(t):
            return t.reshape(b, l, h, d // h).transpose(1, 2)

        q, k, v = (split(linear(x, m, dt)) for m in (att.query, att.key, att.value))
        attn = (q @ k.transpose(-2, -1)) * (d // h) ** -0.5
        attn = torch.softmax(attn.masked_fill(~attention_mask(mask), -1e9), dim=-1)
        out = linear((attn @ v).transpose(1, 2).reshape(b, l, d), self.attention.output.dense, dt)
        x = layer_norm(x + out, self.attention.output.LayerNorm).to(dt)
        y = linear(F.gelu(linear(x, self.intermediate.dense, dt)), self.output.dense, dt)
        return layer_norm(x + y, self.output.LayerNorm).to(dt)


class BertEncoder(nn.Module):
    def __init__(self, vocab_size: int = 30522, dim: int = 768, layers: int = 12, heads: int = 12,
                 max_len: int = 512, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embeddings = container(
            word_embeddings=nn.Embedding(vocab_size, dim), position_embeddings=nn.Embedding(max_len, dim),
            token_type_embeddings=nn.Embedding(2, dim), LayerNorm=nn.LayerNorm(dim, eps=1e-12))
        self.encoder = container(layer=nn.ModuleList(BertLayer(dim, heads, 4 * dim, dtype) for _ in range(layers)))

    def forward(self, token_ids: torch.Tensor, mask: torch.Tensor, token_type_ids: torch.Tensor | None = None,
                position_ids: torch.Tensor | None = None) -> torch.Tensor:
        """token_ids (B, L); mask (B, L) padding or (B, L, L) pairwise -> (B, L, dim)."""
        b, l = token_ids.shape
        emb, dt = self.embeddings, self.dtype
        if position_ids is None:
            position_ids = torch.arange(l, device=token_ids.device).expand(b, l)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(token_ids)
        # rows gathered, then cast: the same values as a gather from a cast table
        x = (F.embedding(token_ids, emb.word_embeddings.weight).to(dt)
             + F.embedding(position_ids, emb.position_embeddings.weight).to(dt)
             + F.embedding(token_type_ids, emb.token_type_embeddings.weight).to(dt))
        x = layer_norm(x, emb.LayerNorm).to(dt)
        for layer in self.encoder.layer:
            x = layer(x, mask)
        return x
