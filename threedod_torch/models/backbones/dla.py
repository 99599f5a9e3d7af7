"""DLA trunks, dla34 to dla169 (counterpart of
``threedod/models/backbones/dla.py``).

A 7x7 stem, two plain conv levels, then hierarchical ``Tree``/``Root``
aggregation; outputs {p2: s4, p3: s8, p4: s16, p5: s32, p6: s64}, with p6 the
stride-2 subsample of p5. The trees are built of ``BasicBlock`` (dla34),
``Bottleneck`` (1x1, 3x3 with the stride, 1x1; expansion 2) or
``BottleneckX`` (the 3x3 grouped in 32); dla102, dla102x and dla169 add the
first child to every root (``residual_root``). Module names follow the
reference torch DLA (``base_layer.0``, ``level1.3``,
``level3.tree1.tree2.conv1``, ``level3.tree2.root.bn`` ...), which are the
names a Cube R-CNN checkpoint carries under ``backbone.bottom_up``. The JAX
package's space-to-depth stem and ``_FastLevel2`` are TPU layout rewrites of
this same arithmetic and are not ported.

In eval, with ``ops.fused_conv`` switched on, a ``Tree(levels == 1)`` of
``BasicBlock``s runs its stride-2 head block (with the pooled, projected
residual) as kernel K6 and its tail (``tree2``, or ``tree1`` and ``tree2`` of
a stride-1 tree without projection, plus the root) as kernel K5, from the
same parameters; trees of the bottleneck blocks run stock, as in JAX, and
so would a BasicBlock tree with a residual root (no published trunk has one).
On the card the tail folds and packs its weights once and keeps them
(``Tree.fused_tail_weights``) until a conv or BatchNorm tensor changes
(``load_state_dict``, an in-place update), moves or changes dtype; training
and the CPU never touch that cache.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Type

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops import fused_conv
from .layers import BatchNorm2d, conv_bn, conv_layer as _conv, fold_convbn


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


class Bottleneck(nn.Module):
    """1x1 down to ``bottle(cout)`` channels, 3x3 with the stride in
    ``groups`` groups, 1x1 up to ``cout``."""

    groups = 1

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        bottle = self.bottle(cout)
        self.conv1 = _conv(cin, bottle, 1)
        self.bn1 = BatchNorm2d(bottle)
        self.conv2 = _conv(bottle, bottle, 3, stride, groups=self.groups)
        self.bn2 = BatchNorm2d(bottle)
        self.conv3 = _conv(bottle, cout, 1)
        self.bn3 = BatchNorm2d(cout)

    @staticmethod
    def bottle(cout: int) -> int:
        return cout // 2  # expansion 2

    def forward(self, x: torch.Tensor, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        if residual is None:
            residual = x
        out = conv_bn(x, self.conv1, self.bn1, relu=True)
        out = conv_bn(out, self.conv2, self.bn2, relu=True)
        out = conv_bn(out, self.conv3, self.bn3, relu=False)
        return torch.relu(out + residual)


class BottleneckX(Bottleneck):
    """The bottleneck with its 3x3 in 32 groups (the cardinality) over
    ``cout * 32 // 32`` channels."""

    groups = 32

    @staticmethod
    def bottle(cout: int) -> int:
        return cout * BottleneckX.groups // 32


class Root(nn.Module):
    def __init__(self, cin: int, cout: int, residual: bool = False):
        super().__init__()
        self.conv = _conv(cin, cout, 1)
        self.bn = BatchNorm2d(cout)
        self.residual = residual

    def forward(self, children: List[torch.Tensor]) -> torch.Tensor:
        x = conv_bn(torch.cat(children, dim=1), self.conv, self.bn, relu=False)
        if self.residual:
            x = x + children[0]
        return torch.relu(x)


class Tree(nn.Module):
    """DLA aggregation tree. ``project`` exists whenever cin != cout, also at
    an outer (levels > 1) node, where its output is not used (the nested
    trees project for themselves). There it runs in training only, without a
    graph, because the reference and the JAX package feed its BatchNorm's
    running statistics from it."""

    def __init__(self, levels: int, cin: int, cout: int, stride: int = 1, level_root: bool = False,
                 root_dim: int = 0, block: Type[nn.Module] = BasicBlock, root_residual: bool = False):
        super().__init__()
        if root_dim == 0:
            root_dim = 2 * cout
        if level_root:
            root_dim += cin
        self.levels = levels
        self.level_root = level_root
        self.stride = stride
        self.block = block
        self.root_residual = root_residual
        if levels == 1:
            self.tree1 = block(cin, cout, stride)
            self.tree2 = block(cout, cout, 1)
            self.root = Root(root_dim, cout, root_residual)
        else:
            self.tree1 = Tree(levels - 1, cin, cout, stride, root_dim=0, block=block, root_residual=root_residual)
            self.tree2 = Tree(levels - 1, cout, cout, 1, root_dim=root_dim + cout, block=block,
                              root_residual=root_residual)
        self.project = None
        if cin != cout:
            self.project = nn.Sequential(_conv(cin, cout, 1), BatchNorm2d(cout))
        self._fused_cache = None  # (key, fused_conv.PackedTreeTail): K5's weights, on the card only
        self._fused_head_cache = None  # (key, fused_conv.PackedBlockDown): K6's weights, on the card only

    def forward(self, x: torch.Tensor, children: Optional[List[torch.Tensor]] = None) -> torch.Tensor:
        children = [] if children is None else list(children)
        bottom = F.max_pool2d(x, self.stride) if self.stride > 1 else x
        if self.level_root:
            children.append(bottom)
        if self.levels == 1:
            if (not self.training and self.block is BasicBlock and not self.root_residual
                    and fused_conv.fused_conv_available()):  # dla34's trees (no published trunk has both)
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

    def fused_tail_weights(self, dtype: torch.dtype, device: torch.device, children: Tuple[int, ...],
                           two_blocks: bool, include_input_child: bool) -> fused_conv.PackedTreeTail:
        """The tail's ConvBN pairs folded in f32 and packed for K5 at
        ``dtype`` (``children``: the root's children's channel counts), from
        the cache while no conv or BatchNorm tensor has changed."""
        blocks = (self.tree1, self.tree2) if two_blocks else (self.tree2,)
        pairs = [p for blk in blocks for p in ((blk.conv1, blk.bn1), (blk.conv2, blk.bn2))]
        tensors = [t for conv, bn in pairs + [(self.root.conv, self.root.bn)]
                   for t in (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)]
        key = (dtype, device, tuple(children), two_blocks, include_input_child,
               *((t.data_ptr(), t._version) for t in tensors))
        if self._fused_cache is None or self._fused_cache[0] != key:
            with torch.no_grad():
                on = lambda ts: tuple(t.to(device) for t in ts)  # noqa: E731
                packed = fused_conv.pack_tree_tail(
                    on(self.tree1.folded()) if two_blocks else None, on(self.tree2.folded()),
                    *on(fold_convbn(self.root.conv, self.root.bn)), dtype, children=children,
                    two_blocks=two_blocks, include_input_child=include_input_child)
            self._fused_cache = (key, packed)
        return self._fused_cache[1]

    def fused_head_weights(self, dtype: torch.dtype, device: torch.device) -> fused_conv.PackedBlockDown:
        """The stride-2 head (``tree1`` and the projection) folded in f32 and
        packed for K6 at ``dtype``, from the cache while no conv or BatchNorm
        tensor has changed."""
        pairs = [(self.tree1.conv1, self.tree1.bn1), (self.tree1.conv2, self.tree1.bn2)]
        if self.project is not None:
            pairs.append((self.project[0], self.project[1]))
        tensors = [t for conv, bn in pairs for t in (conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var)]
        key = (dtype, device, *((t.data_ptr(), t._version) for t in tensors))
        if self._fused_head_cache is None or self._fused_head_cache[0] != key:
            with torch.no_grad():
                proj = (None, None) if self.project is None else fold_convbn(self.project[0], self.project[1])
                packed = fused_conv.pack_block_down(*(None if t is None else t.to(device)
                                                      for t in (*self.tree1.folded(), *proj)), dtype)
            self._fused_head_cache = (key, packed)
        return self._fused_head_cache[1]

    def _fused_tail(self, x: torch.Tensor, children: List[torch.Tensor], two_blocks: bool,
                    include_input_child: bool) -> torch.Tensor:
        """K5 over x and the children: from the cached packed weights on the
        card, packed at this call on the CPU."""
        if x.device.type == "cuda":
            fused_conv._refuse_grad(x, *self.parameters())
            packed = self.fused_tail_weights(x.dtype, x.device, tuple(ch.shape[1] for ch in children), two_blocks,
                                             include_input_child)
            return fused_conv.fused_tree_tail_packed(x, children, packed)
        wr, br = fold_convbn(self.root.conv, self.root.bn)
        return fused_conv.fused_tree_tail(
            x, children, self.tree1.folded() if two_blocks else None, self.tree2.folded(), wr, br,
            two_blocks=two_blocks, include_input_child=include_input_child)

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
        if tail and self.stride == 1 and self.project is None:
            # tree1's residual is x itself, and the last child (appended by
            # the outer tree) is x: the kernel reads it once
            incl = bool(children) and children[-1] is x
            return self._fused_tail(x, children[:-1] if incl else children, True, incl)
        if head and x.device.type == "cuda":
            fused_conv._refuse_grad(x, *self.parameters())
            x1 = fused_conv.fused_block_down_packed(x, self.fused_head_weights(x.dtype, x.device), pool_residual=True)
        elif head:
            proj = (None, None) if self.project is None else fold_convbn(self.project[0], self.project[1])
            x1 = fused_conv.fused_block_down(x, *self.tree1.folded(), *proj, pool_residual=True)
        else:
            x1 = self.tree1(x, self._residual(bottom))
        if tail and self.stride > 1:
            return self._fused_tail(x1, children, False, False)
        x2 = self.tree2(x1)
        return self.root([x2, x1] + children)


# the published widths (reference dla.py:336-474, the JAX table)
_DLA_SPECS = {
    "dla34": dict(levels=(1, 1, 1, 2, 2, 1), channels=(16, 32, 64, 128, 256, 512), block=BasicBlock),
    "dla46_c": dict(levels=(1, 1, 1, 2, 2, 1), channels=(16, 32, 64, 64, 128, 256), block=Bottleneck),
    "dla46x_c": dict(levels=(1, 1, 1, 2, 2, 1), channels=(16, 32, 64, 64, 128, 256), block=BottleneckX),
    "dla60x_c": dict(levels=(1, 1, 1, 2, 3, 1), channels=(16, 32, 64, 64, 128, 256), block=BottleneckX),
    "dla60": dict(levels=(1, 1, 1, 2, 3, 1), channels=(16, 32, 128, 256, 512, 1024), block=Bottleneck),
    "dla60x": dict(levels=(1, 1, 1, 2, 3, 1), channels=(16, 32, 128, 256, 512, 1024), block=BottleneckX),
    "dla102": dict(levels=(1, 1, 1, 3, 4, 1), channels=(16, 32, 128, 256, 512, 1024), block=Bottleneck,
                   residual_root=True),
    "dla102x": dict(levels=(1, 1, 1, 3, 4, 1), channels=(16, 32, 128, 256, 512, 1024), block=BottleneckX,
                    residual_root=True),
    "dla169": dict(levels=(1, 1, 2, 3, 5, 1), channels=(16, 32, 128, 256, 512, 1024), block=Bottleneck,
                   residual_root=True),
}


class DLA(nn.Module):
    """DLA trunk; ``forward`` returns the {'p2' .. 'p6'} feature dict."""

    def __init__(self, levels: Tuple[int, ...], channels: Tuple[int, ...], block: Type[nn.Module] = BasicBlock,
                 residual_root: bool = False):
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
        for i in range(2, 6):
            self.add_module(f"level{i}", Tree(levels[i], ch[i - 1], ch[i], 2, level_root=i > 2, block=block,
                                              root_residual=residual_root))
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
        raise ValueError(f"unknown DLA '{name}' (one of {', '.join(_DLA_SPECS)})")
    return DLA(**_DLA_SPECS[name])
