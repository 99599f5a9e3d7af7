"""DLA34 trunk (counterpart of ``threedod/models/backbones/dla.py``).

A 7x7 stem, two plain conv levels, then hierarchical ``Tree``/``Root``
aggregation; outputs {p2: s4, p3: s8, p4: s16, p5: s32, p6: s64}, with p6 the
stride-2 subsample of p5. Module names follow the reference torch DLA
(``base_layer.0``, ``level1.3``, ``level3.tree1.tree2.conv1``,
``level3.tree2.root.bn`` ...), which are the names a Cube R-CNN checkpoint
carries under ``backbone.bottom_up``. The JAX package's space-to-depth stem
is a TPU layout rewrite of this same arithmetic and is not ported.

In eval, with ``ops.fused_conv`` switched on, a ``Tree(levels == 1)`` runs
its stride-2 head block (with the pooled, projected residual) as kernel K6
and its tail (``tree2``, or ``tree1`` and ``tree2`` of a stride-1 tree
without projection, plus the root) as kernel K5, from the same parameters.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import fused_conv
from .layers import BatchNorm2d, conv_bn, fold_convbn


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=(k - 1) // 2, bias=False)


def _conv_bn_relu(cin: int, cout: int, k: int, stride: int = 1) -> List[nn.Module]:
    return [_conv(cin, cout, k, stride), BatchNorm2d(cout), nn.ReLU()]


def _run_seq(seq: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
    """A (conv, bn, relu)* Sequential as ConvBN-ReLU steps."""
    for i in range(0, len(seq), 3):
        x = conv_bn(x, seq[i], seq[i + 1], relu=True)
    return x


class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, cout, 3, stride)
        self.bn1 = BatchNorm2d(cout)
        self.conv2 = _conv(cout, cout, 3)
        self.bn2 = BatchNorm2d(cout)

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if residual is None:
            residual = x
        out = conv_bn(x, self.conv1, self.bn1, relu=True)
        out = conv_bn(out, self.conv2, self.bn2, relu=False)
        return torch.relu(out + residual)

    def folded(self):
        """(w1, b1, w2, b2) with the BatchNorms folded in, f32."""
        return (*fold_convbn(self.conv1, self.bn1), *fold_convbn(self.conv2, self.bn2))


class Root(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.conv = _conv(cin, cout, 1)
        self.bn = BatchNorm2d(cout)

    def forward(self, children: List[torch.Tensor]) -> torch.Tensor:
        return torch.relu(conv_bn(torch.cat(children, dim=1), self.conv, self.bn, relu=False))


class Tree(nn.Module):
    """DLA aggregation tree. ``project`` exists whenever cin != cout, also at
    an outer (levels > 1) node, where its output is not used (the nested
    trees project for themselves). There it runs in training only, without a
    graph, because the reference and the JAX package feed its BatchNorm's
    running statistics from it."""

    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1,
                 level_root: bool = False, root_dim: int = 0):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        self.levels = levels
        self.level_root = level_root
        self.stride = stride
        if levels == 1:
            self.tree1 = BasicBlock(cin, cout, stride)
            self.tree2 = BasicBlock(cout, cout, 1)
            self.root = Root(root_dim, cout)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride, root_dim=0)
            self.tree2 = Tree(levels - 1, cout, cout, 1, root_dim=root_dim + cout)
        self.project = None
        if cin != cout:
            self.project = nn.Sequential(_conv(cin, cout, 1), BatchNorm2d(cout))

    def forward(self, x: torch.Tensor, children: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            if not self.training and fused_conv.fused_conv_available():
                return self._forward_fused(x, bottom, children)
            x1 = self.tree1(x, self._residual(bottom))
            x2 = self.tree2(x1)
            return self.root([x2, x1] + children)
        if self.project is not None and self.training:
            with torch.no_grad():
                conv_bn(bottom, self.project[0], self.project[1], relu=False)
        x1 = self.tree1(x)
        children.append(x1)
        return self.tree2(x1, children=children)

    def _residual(self, bottom: torch.Tensor) -> torch.Tensor:
        if self.project is None:
            return bottom
        return conv_bn(bottom, self.project[0], self.project[1], relu=False)

    def _forward_fused(self, x: torch.Tensor, bottom: torch.Tensor, children: List[torch.Tensor]) -> torch.Tensor:
        """The eval fast paths of a ``levels == 1`` tree. K6 takes a stride-2
        head on even input dims; K5 takes the tail where every child has the
        output's size: ``tree2`` and the root after a stride-2 head, both
        blocks and the root in a stride-1 tree without projection (with a
        projection ``tree1``'s residual is proj(x), which the two-block tail
        does not compute, so that tree stays on the stock path)."""
        oh, ow = x.shape[2] // self.stride, x.shape[3] // self.stride
        tail = all(ch.shape[2] == oh and ch.shape[3] == ow for ch in children)
        head = self.stride == 2 and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0
        wr, br = fold_convbn(self.root.conv, self.root.bn)
        if tail and self.stride == 1 and self.project is None:
            # tree1's residual is x itself, and the last child (appended by
            # the outer tree) is x: the kernel reads it once
            incl = bool(children) and children[-1] is x
            return fused_conv.fused_tree_tail(
                x, children[:-1] if incl else children, self.tree1.folded(), self.tree2.folded(), wr, br,
                two_blocks=True, include_input_child=incl)
        if head:
            proj = (None, None) if self.project is None else fold_convbn(self.project[0], self.project[1])
            x1 = fused_conv.fused_block_down(x, *self.tree1.folded(), *proj, pool_residual=True)
        else:
            x1 = self.tree1(x, self._residual(bottom))
        if tail and self.stride > 1:
            return fused_conv.fused_tree_tail(x1, children, None, self.tree2.folded(), wr, br)
        x2 = self.tree2(x1)
        return self.root([x2, x1] + children)


_DLA_SPECS = {
    "dla34": dict(levels=(1, 1, 1, 2, 2, 1), channels=(16, 32, 64, 128, 256, 512)),
}


class DLA(nn.Module):
    """DLA trunk; ``forward`` returns the {'p2' .. 'p6'} feature dict."""

    def __init__(self, levels: Tuple[int, ...], channels: Tuple[int, ...]):
        super().__init__()
        ch = channels
        self.base_layer = nn.Sequential(*_conv_bn_relu(3, ch[0], 7))
        self.level0 = nn.Sequential(
            *[m for _ in range(levels[0]) for m in _conv_bn_relu(ch[0], ch[0], 3)]
        )
        self.level1 = nn.Sequential(
            *[m for i in range(levels[1])
              for m in _conv_bn_relu(ch[0] if i == 0 else ch[1], ch[1], 3, 2 if i == 0 else 1)]
        )
        self.level2 = Tree(levels[2], ch[1], ch[2], 2, level_root=False)
        self.level3 = Tree(levels[3], ch[2], ch[3], 2, level_root=True)
        self.level4 = Tree(levels[4], ch[3], ch[4], 2, level_root=True)
        self.level5 = Tree(levels[5], ch[4], ch[5], 2, level_root=True)
        self.out_channels = {f"p{i}": ch[min(i, 5)] for i in range(2, 7)}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = _run_seq(self.base_layer, x)
        x = _run_seq(self.level0, x)
        x = _run_seq(self.level1, x)
        outs = {}
        for name, level in (("p2", self.level2), ("p3", self.level3),
                            ("p4", self.level4), ("p5", self.level5)):
            x = level(x)
            outs[name] = x
        outs["p6"] = F.max_pool2d(x, 1, 2)
        return outs


def build_dla(name: str) -> DLA:
    if name not in _DLA_SPECS:
        raise NotImplementedError(f"backbone '{name}' is not ported yet (dla34 only)")
    return DLA(**_DLA_SPECS[name])
