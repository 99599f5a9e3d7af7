"""Helpers shared by the GroundingDINO modules.

Parameters stay f32 and a module's ``dtype`` is its compute dtype, as in the
flax modules: a projection casts its input, weight and bias to it; a
LayerNorm or GroupNorm computes in f32 with the JAX package's epsilon (1e-6,
BERT's 1e-12) and returns f32, which the caller casts back.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F


def container(**children: nn.Module) -> nn.Module:
    """A module that only holds ``children`` under their names (the official
    checkpoint's nesting, e.g. ``attention.self.query``)."""
    m = nn.Module()
    for name, child in children.items():
        setattr(m, name, child)
    return m


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


def ffn(x: torch.Tensor, fc1: nn.Linear, fc2: nn.Linear, norm: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """The JAX package's ``FFN``: norm(x + fc2(relu(fc1(x)))), cast to dtype."""
    y = linear(torch.relu(linear(x, fc1, dtype)), fc2, dtype)
    return layer_norm(x + y, norm).to(dtype)


class MLP(nn.Module):
    """``layers.{k}`` linears with relu between them (the official MLP)."""

    def __init__(self, dims, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = linear(x, layer, self.dtype)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x
