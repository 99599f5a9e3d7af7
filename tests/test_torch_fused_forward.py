"""The port's fused serving forward (``ops.fused_conv`` switched on) through
its modules, f32 on the CPU, where the four functions run their plain
versions.

* DLA34, FPN and ``RPNHead`` with the switch on vs the same module with it
  off, and vs the JAX module running its Pallas kernels in interpret mode
  (``threedod.ops.fused_conv.FORCE_INTERPRET``, set by a fixture), from one
  set of seeded weights: atol 2e-4 (f32 sums in another order through some
  thirty convolutions; features are of order 1 to 10).
* Which call sites engage, counted without a forward at full size: the
  modules run on ``meta`` tensors with the four functions replaced by
  recorders. 128x96 and 512x672 inputs: K6 4 times, K5 6 times (two of them
  two-block tails with one child and the input as last child), K8 3 times
  (the finest without ``emit_cur``), K7 5 times.
* A stride-1 ``Tree`` with a projection takes no fused tail (its ``tree1``
  residual is proj(x), which the two-block tail does not compute).
* In training mode the switch changes nothing.
* The whole ``RCNN3D`` forward on the tiny configuration, fused vs stock:
  boxes and scores to 1e-3, corners to 5e-3.
* K5's, K6's, K7's and K8's packed weights as the modules keep them
  (``Tree.fused_tail_weights``, ``Tree.fused_head_weights``,
  ``RPNHead.fused_weights``, ``BackboneWithFPN.fused_level_weights``): the
  folded, packed weights, kept until a conv or BatchNorm tensor changes (a
  second call packs nothing, a changed tensor repacks); the CPU and training
  forwards leave every cache empty.

On a CUDA card only (marked ``gpu``): the DLA34-FPN backbone fused vs stock
in f32, which fills the trees' and the FPN's caches and reuses them on the
next forward.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch
import torch.nn as nn

import _torch_port as tp

import jax
import jax.numpy as jnp

from threedod.ops import fused_conv as jfc
from threedod_torch.models.backbones.dla import Tree
from threedod_torch.models.backbones.fpn import BackboneWithFPN, build_backbone
from threedod_torch.models.backbones.layers import fold_convbn
from threedod_torch.models.rpn import RPNHead
from threedod_torch.ops import fused_conv as pfc

ATOL = 2e-4
FUSED = ("fused_block_down", "fused_tree_tail", "fused_fpn_level", "fused_conv_relu_head")


@pytest.fixture
def force_interpret():
    jfc.FORCE_INTERPRET = True
    try:
        yield
    finally:
        jfc.FORCE_INTERPRET = False


@pytest.fixture(scope="module")
def models():
    """JAX variables (numpy) and the port model loaded from them."""
    jcfg, pcfg = tp.configs()
    _, variables = tp.jax_model(jcfg, predictor_scale=50.0)
    return jcfg, pcfg, variables, tp.port_model(pcfg, variables)


@pytest.fixture(scope="module")
def trunk_input():
    return np.random.RandomState(2).randn(1, 128, 96, 3).astype(np.float32)


@pytest.fixture(scope="module")
def stock_feats(models, trunk_input):
    """The port's stock DLA34 levels at 128x96, NCHW torch."""
    port = models[3]
    with torch.no_grad():
        return port.backbone.bottom_up(torch.from_numpy(trunk_input).permute(0, 3, 1, 2))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _close(got, ref, what):
    np.testing.assert_allclose(got, ref, atol=ATOL, err_msg=what)


class _Given(nn.Module):
    """Stands in for the trunk: hands the FPN the levels it is given."""

    def __init__(self, out_channels):
        super().__init__()
        self.out_channels = out_channels

    def forward(self, feats):
        return feats


def _fpn_alone(port_backbone):
    fpn = BackboneWithFPN(_Given(port_backbone.bottom_up.out_channels)).eval()
    fpn.load_state_dict({k: v for k, v in port_backbone.state_dict().items() if k.startswith("fpn_")}, strict=True)
    return fpn


def test_dla34_fused_matches_stock_and_jax(models, trunk_input, stock_feats, force_interpret):
    from threedod.models.backbones.dla import build_dla

    _, _, variables, port = models
    with torch.no_grad(), pfc.fused_forward():
        got = port.backbone.bottom_up(torch.from_numpy(trunk_input).permute(0, 3, 1, 2))
    assert sorted(got) == ["p2", "p3", "p4", "p5", "p6"]
    for lvl in got:
        _close(got[lvl].numpy(), stock_feats[lvl].numpy(), f"fused vs stock {lvl}")
    trunk = build_dla("dla34", dtype=jnp.float32)
    tvars = {"params": variables["params"]["backbone"]["trunk"],
             "batch_stats": variables["batch_stats"]["backbone"]["trunk"]}
    assert jfc.fused_conv_available() and jfc.kernel_interpret()
    ref = jax.jit(lambda v, x: trunk.apply(v, x, train=False))(tvars, trunk_input)
    for lvl in got:
        _close(_nhwc(got[lvl]), np.asarray(ref[lvl]), f"fused vs JAX fused {lvl}")


def test_fpn_fused_matches_stock_and_jax(models, stock_feats, force_interpret):
    from threedod.models.backbones.fpn import FPN

    _, _, variables, port = models
    fpn = _fpn_alone(port.backbone)
    with torch.no_grad():
        stock = fpn(stock_feats)
        with pfc.fused_forward():
            got = fpn(stock_feats)
    for lvl in got:
        _close(got[lvl].numpy(), stock[lvl].numpy(), f"fused vs stock {lvl}")
    jfeats = {k: jnp.asarray(_nhwc(v)) for k, v in stock_feats.items()}
    fpn_j = FPN(256, dtype=jnp.float32)
    ref = jax.jit(lambda p, f: fpn_j.apply({"params": p}, f, train=False))(variables["params"]["backbone"]["fpn"], jfeats)
    for lvl in got:
        _close(_nhwc(got[lvl]), np.asarray(ref[lvl]), f"fused vs JAX fused {lvl}")


def test_rpn_head_fused_matches_stock_and_jax(models, force_interpret):
    from threedod.models.rpn import RPNHead

    _, _, variables, port = models
    head = port.proposal_generator.rpn_head
    rng = np.random.RandomState(6)
    feats = {"p2": (rng.randn(1, 32, 24, 256) * 0.5).astype(np.float32),
             "p3": (rng.randn(1, 16, 12, 256) * 0.5).astype(np.float32),
             "p6": (rng.randn(1, 2, 3, 256) * 0.5).astype(np.float32)}
    tfeats = {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}
    with torch.no_grad():
        stock_l, stock_r = head(tfeats)
        with pfc.fused_forward():
            got_l, got_r = head(tfeats)
    rpn_j = RPNHead(num_anchors=head.num_anchors, dtype=jnp.float32)
    ref_l, ref_r = jax.jit(lambda p, f: rpn_j.apply({"params": p}, f, train=False))(
        variables["params"]["rpn_head"], feats)
    for k, f in feats.items():
        n = f.shape[1] * f.shape[2] * head.num_anchors
        assert got_l[k].shape == (1, n) and got_r[k].shape == (1, n, 4)
        _close(got_l[k].numpy(), stock_l[k].numpy(), f"logits fused vs stock {k}")
        _close(got_r[k].numpy(), stock_r[k].numpy(), f"deltas fused vs stock {k}")
        _close(got_l[k].numpy(), np.asarray(ref_l[k]), f"logits fused vs JAX fused {k}")
        _close(got_r[k].numpy(), np.asarray(ref_r[k]), f"deltas fused vs JAX fused {k}")


# ---------------- which call sites engage ----------------------------------


@pytest.fixture
def recorder(monkeypatch):
    """Replace the four functions by recorders that return ``meta`` tensors of
    the right shapes; yields the list of (name, x shape, details)."""
    calls = []

    def tree_tail(x, children, bb_a, bb_b, wr, br, *, two_blocks=False, include_input_child=False,
                  root_residual=False):
        assert (bb_a is not None) == two_blocks
        ctot = 2 * x.shape[1] + sum(c.shape[1] for c in children) + (x.shape[1] if include_input_child else 0)
        assert wr.shape[1] == ctot
        calls.append(("fused_tree_tail", tuple(x.shape),
                      dict(two_blocks=two_blocks, children=[c.shape[1] for c in children],
                           include_input_child=include_input_child, root_residual=root_residual)))
        return x.new_empty((x.shape[0], wr.shape[0], *x.shape[2:]))

    def block_down(x, w1, b1, w2, b2, wproj=None, bproj=None, *, pool_residual=True):
        calls.append(("fused_block_down", tuple(x.shape), dict(proj=wproj is not None, pool_residual=pool_residual)))
        return x.new_empty((x.shape[0], w1.shape[0], x.shape[2] // 2, x.shape[3] // 2))

    def fpn_level(f, prev, wlat, blat, wout, bout, *, emit_cur=True):
        calls.append(("fused_fpn_level", tuple(f.shape), dict(emit_cur=emit_cur, prev=tuple(prev.shape))))
        out = f.new_empty((f.shape[0], wout.shape[0], *f.shape[2:]))
        return (out, out.clone()) if emit_cur else out

    def conv_relu_head(x, wc, bc, wh, bh):
        calls.append(("fused_conv_relu_head", tuple(x.shape), dict(n_out=wh.shape[0])))
        return x.new_empty((x.shape[0], wh.shape[0], *x.shape[2:]))

    for name, fn in zip(FUSED, (block_down, tree_tail, fpn_level, conv_relu_head)):
        monkeypatch.setattr(pfc, name, fn)
    return calls


@pytest.mark.parametrize("h,w", [(128, 96), (512, 672)])
def test_launch_site_census(models, recorder, h, w):
    port = copy.deepcopy(models[3]).to("meta")
    x = torch.empty((8, 3, h, w), device="meta")
    with torch.no_grad(), pfc.fused_forward():
        feats = port.backbone(x)
        port.proposal_generator.rpn_head(feats)
    by = {name: [c for c in recorder if c[0] == name] for name in FUSED}
    assert {k: len(v) for k, v in by.items()} == {
        "fused_block_down": 4, "fused_tree_tail": 6, "fused_fpn_level": 3, "fused_conv_relu_head": 5}
    s = lambda d: (h // d, w // d)  # noqa: E731
    # K6: level2, level3.tree1, level4.tree1, level5, all pooled and projected
    assert [c[1] for c in by["fused_block_down"]] == [(8, 32, *s(2)), (8, 64, *s(4)), (8, 128, *s(8)), (8, 256, *s(16))]
    assert all(c[2] == dict(proj=True, pool_residual=True) for c in by["fused_block_down"])
    # K5: each head's tail, and the two-block tails of level3.tree2 and level4.tree2
    one = dict(two_blocks=False, children=[], include_input_child=False, root_residual=False)
    assert [(c[1], c[2]) for c in by["fused_tree_tail"]] == [
        ((8, 64, *s(4)), one),
        ((8, 128, *s(8)), one),
        ((8, 128, *s(8)), dict(one, two_blocks=True, children=[64], include_input_child=True)),
        ((8, 256, *s(16)), one),
        ((8, 256, *s(16)), dict(one, two_blocks=True, children=[128], include_input_child=True)),
        ((8, 512, *s(32)), dict(one, children=[256])),
    ]
    # K8: p4, p3 hand their carry down, p2 does not; p5 (odd width) and p6 (no carry) stay stock
    assert [(c[1], c[2]["emit_cur"]) for c in by["fused_fpn_level"]] == [
        ((8, 256, *s(16)), True), ((8, 128, *s(8)), True), ((8, 64, *s(4)), False)]
    # K7: every level, 3 anchors x (1 + 4) outputs
    assert [c[1][2:] for c in by["fused_conv_relu_head"]] == [s(4), s(8), s(16), s(32), (-(-h // 64), -(-w // 64))]
    assert all(c[2] == dict(n_out=15) for c in by["fused_conv_relu_head"])


def test_switch_off_or_training_engages_nothing(models, recorder):
    port = copy.deepcopy(models[3]).to("meta")
    x = torch.empty((2, 3, 64, 96), device="meta")
    with torch.no_grad():
        port.proposal_generator.rpn_head(port.backbone(x))  # switch off
        port.train()
        with pfc.fused_forward():
            port.proposal_generator.rpn_head(port.backbone(x))  # eval only
    assert recorder == []


def _seeded_tree(cin, cout, stride, level_root=False, root_dim=0):
    tree = Tree(1, cin, cout, stride, level_root=level_root, root_dim=root_dim).eval()
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for p in tree.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.1 if p.dim() == 4 else 0.3) + (p.dim() == 1))
        for name, buf in tree.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) + (0.5 if name.endswith("var") else -0.5))
    return tree


def test_tree_stride1_with_projection_takes_no_fused_tail(monkeypatch):
    """cin != cout at stride 1: ``tree1``'s residual is proj(x), so the tree
    stays on the stock path; without the projection the same tree takes the
    two-block tail."""
    x = torch.from_numpy(np.random.RandomState(7).randn(1, 8, 16, 16).astype(np.float32))
    calls = []
    real = pfc.fused_tree_tail
    monkeypatch.setattr(pfc, "fused_tree_tail", lambda *a, **k: calls.append(k) or real(*a, **k))
    for cin, want in ((8, []), (16, [dict(two_blocks=True, include_input_child=False)])):
        tree = _seeded_tree(cin, 16, 1)
        assert (tree.project is not None) == (cin != 16)
        xin = x if cin == 8 else torch.cat([x, -x], dim=1)
        calls.clear()
        with torch.no_grad():
            ref = tree(xin)
            with pfc.fused_forward():
                got = tree(xin)
        assert calls == want
        _close(got.numpy(), ref.numpy(), f"cin={cin}")


@pytest.mark.parametrize("level_root", [False, True])
def test_tree_stride2_fused_matches_stock(level_root):
    """A stride-2 tree (K6 head, one-block K5 tail), without and with the
    pooled input as the root's child (``level_root``)."""
    tree = _seeded_tree(8, 16, 2, level_root)
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 8, 16, 24).astype(np.float32))
    with torch.no_grad():
        ref = tree(x)
        with pfc.fused_forward():
            got = tree(x)
    _close(got.numpy(), ref.numpy(), f"level_root={level_root}")


def test_rcnn3d_fused_matches_stock(models):
    """The whole forward on the tiny configuration: same detections."""
    _, _, _, port = models
    batch = tp.torch_batch(*tp.inputs())
    with torch.inference_mode():
        ref = port(batch)
        with pfc.fused_forward():
            got = port(batch)
    assert ref.valid.any() and torch.equal(got.valid, ref.valid)
    assert torch.equal(got.classes, ref.classes)
    np.testing.assert_allclose(got.boxes.numpy(), ref.boxes.numpy(), atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy(), ref.scores.numpy(), atol=1e-3)
    np.testing.assert_allclose(got.corners3d.numpy(), ref.corners3d.numpy(), atol=5e-3)


# ---------------- K5's and K8's packed weights, kept by the modules ------------


def test_tree_keeps_its_packed_tail_until_a_tensor_changes():
    cpu, bf16 = torch.device("cpu"), torch.bfloat16
    tree = _seeded_tree(16, 16, 1, root_dim=80)  # stride 1, no projection: the two-block tail; x2, x1, a child of 32, x
    first = tree.fused_tail_weights(bf16, cpu, (32,), True, True)
    assert tree.fused_tail_weights(bf16, cpu, (32,), True, True) is first  # cached
    assert first.sources == (16, 16, 32, 16) and first.block_a is not None
    wr, _ = fold_convbn(tree.root.conv, tree.root.bn)
    assert torch.equal(pfc.unpack_conv1x1(first.wr, 16, first.sources), wr.to(bf16))
    assert torch.equal(pfc.unpack_conv3x3(first.block_a.w1, 16, 16), fold_convbn(tree.tree1.conv1, tree.tree1.bn1)[0].to(bf16))
    with torch.no_grad():
        tree.root.bn.running_var.mul_(4.0)  # an in-place BN statistic update
    second = tree.fused_tail_weights(bf16, cpu, (32,), True, True)
    assert second is not first and not torch.equal(second.wr, first.wr)
    assert torch.equal(second.block_b.w2, first.block_b.w2)
    with torch.no_grad():
        tree.tree1.conv2.weight.add_(0.5)
    third = tree.fused_tail_weights(bf16, cpu, (32,), True, True)
    assert third is not second and not torch.equal(third.block_a.w2, second.block_a.w2)
    tree.load_state_dict(_seeded_tree(16, 16, 1, root_dim=80).state_dict())  # the same values, new tensors
    fourth = tree.fused_tail_weights(bf16, cpu, (32,), True, True)
    assert fourth is not third and torch.equal(fourth.wr, first.wr)
    assert tree.fused_tail_weights(bf16, cpu, (16, 32), True, False).sources == (16, 16, 16, 32)  # another structure
    one = _seeded_tree(8, 16, 2).fused_tail_weights(torch.float32, cpu, (), False, False)  # a head's tail, f32
    assert one.block_a is None and one.wr.shape == (1, 1, 32, 16) and one.wr.dtype == torch.float32


def test_fpn_keeps_its_packed_levels_until_a_tensor_changes():
    cpu, bf16 = torch.device("cpu"), torch.bfloat16
    fpn = BackboneWithFPN(_Given({"p2": 64, "p3": 128, "p4": 256, "p5": 512, "p6": 512})).eval()
    first = {lvl: fpn.fused_level_weights(lvl, bf16, cpu) for lvl in ("2", "3", "4")}
    assert all(fpn.fused_level_weights(lvl, bf16, cpu) is first[lvl] for lvl in first)
    assert torch.equal(pfc.unpack_conv1x1(first["3"].wlat, 256, [128]), fpn.fpn_lateral3.weight.to(bf16))
    assert torch.equal(pfc.unpack_conv3x3(first["3"].wout, 256, 256), fpn.fpn_output3.weight.to(bf16))
    with torch.no_grad():
        fpn.fpn_output3.bias.add_(1.0)
    again = {lvl: fpn.fused_level_weights(lvl, bf16, cpu) for lvl in first}
    assert again["3"] is not first["3"] and torch.equal(again["3"].bout, fpn.fpn_output3.bias)
    assert again["2"] is first["2"] and again["4"] is first["4"]
    f32 = fpn.fused_level_weights("3", torch.float32, cpu)  # another dtype: the CUDA cores' layout
    assert f32.wlat.shape == (1, 1, 128, 256) and fpn.fused_level_weights("3", bf16, cpu) is not again["3"]


def test_cpu_and_training_forwards_leave_the_tree_and_fpn_caches_empty(models):
    port = copy.deepcopy(models[3].backbone)
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 3, 64, 96).astype(np.float32))
    with torch.no_grad(), pfc.fused_forward():
        port(x)
        port.train()
        port(x)
    trees = [m for m in port.modules() if isinstance(m, Tree) and m.levels == 1]
    assert len(trees) == 6 and all(t._fused_cache is None for t in trees)
    assert port._fused_cache == {}


# ---------------- K6's and K7's packed weights, kept by the modules ------------


def _count_packs(monkeypatch, name):
    """Count the calls of ``fused_conv.<name>`` (each one packs)."""
    calls = []
    real = getattr(pfc, name)
    monkeypatch.setattr(pfc, name, lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def test_tree_keeps_its_packed_head_until_a_tensor_changes(monkeypatch):
    cpu, bf16 = torch.device("cpu"), torch.bfloat16
    packs = _count_packs(monkeypatch, "pack_block_down")
    tree = _seeded_tree(32, 64, 2)  # DLA34's level2: stride 2, projected
    first = tree.fused_head_weights(bf16, cpu)
    assert tree.fused_head_weights(bf16, cpu) is first and len(packs) == 1  # cached: a second forward packs nothing
    assert (first.cin, first.c) == (32, 64)
    w1, _, w2, _ = tree.tree1.folded()
    wp, bp = fold_convbn(tree.project[0], tree.project[1])
    assert torch.equal(pfc.unpack_conv3x3(first.w1, 64, 32), w1.to(bf16))
    assert torch.equal(pfc.unpack_conv3x3(first.w2, 64, 64), w2.to(bf16))
    assert torch.equal(pfc.unpack_conv1x1(first.wp, 64, [32]), wp.to(bf16)) and torch.equal(first.bp, bp)
    with torch.no_grad():
        tree.project[1].running_var.mul_(4.0)  # an in-place BN statistic update of the projection
    second = tree.fused_head_weights(bf16, cpu)
    assert second is not first and len(packs) == 2 and not torch.equal(second.wp, first.wp)
    assert torch.equal(second.w1, first.w1)
    with torch.no_grad():
        tree.tree1.conv1.weight.add_(0.5)
    third = tree.fused_head_weights(bf16, cpu)
    assert third is not second and not torch.equal(third.w1, second.w1)
    tree.load_state_dict(_seeded_tree(32, 64, 2).state_dict())  # the same values, new tensors
    fourth = tree.fused_head_weights(bf16, cpu)
    assert fourth is not third and torch.equal(fourth.w1, first.w1) and len(packs) == 4
    f32 = tree.fused_head_weights(torch.float32, cpu)  # another dtype: the CUDA cores' layout
    assert f32.w1.shape == (3, 3, 32, 64) and f32.wp.shape == (1, 1, 32, 64)
    assert _seeded_tree(16, 16, 2).fused_head_weights(bf16, cpu).wp is None  # no projection: the pooled x itself


def test_rpn_head_keeps_its_packed_weights_until_a_tensor_changes(monkeypatch):
    cpu, bf16 = torch.device("cpu"), torch.bfloat16
    packs = _count_packs(monkeypatch, "pack_conv_relu_head")
    head = RPNHead(32, 3).eval()
    first = head.fused_weights(bf16, cpu)
    assert head.fused_weights(bf16, cpu) is first and len(packs) == 1
    c, a = head.conv.in_channels, head.num_anchors
    wh = torch.cat([head.objectness_logits.weight, head.anchor_deltas.weight])
    assert (first.c, first.cm, first.nout) == (c, c, 5 * a)
    assert torch.equal(pfc.unpack_conv1x1(first.wh, 5 * a, [c]), wh.to(bf16))  # objectness channels first
    assert torch.equal(pfc.unpack_conv3x3(first.wc, c, c), head.conv.weight.to(bf16))
    with torch.no_grad():
        head.anchor_deltas.bias.add_(1.0)
    second = head.fused_weights(bf16, cpu)
    assert second is not first and len(packs) == 2 and torch.equal(second.bh[a:5 * a], head.anchor_deltas.bias)
    assert torch.equal(second.wc, first.wc)
    f32 = head.fused_weights(torch.float32, cpu)
    assert f32.wh.shape == (1, 1, c, 16) and len(packs) == 3


def test_cpu_and_training_forwards_leave_the_head_caches_empty(models):
    port = copy.deepcopy(models[3])
    x = torch.from_numpy(np.random.RandomState(4).randn(1, 3, 64, 96).astype(np.float32))
    with torch.no_grad(), pfc.fused_forward():
        port.proposal_generator.rpn_head(port.backbone(x))
        port.train()
        port.proposal_generator.rpn_head(port.backbone(x))
    heads = [m for m in port.modules() if isinstance(m, Tree) and m.levels == 1 and m.stride == 2]
    assert len(heads) == 4 and all(t._fused_head_cache is None for t in heads)
    assert port.proposal_generator.rpn_head._fused_cache is None


@pytest.mark.gpu
def test_dla34_fpn_fused_vs_stock_on_card_and_caches():
    if not torch.cuda.is_available():
        pytest.skip("the fused conv kernels need a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    backbone = build_backbone("dla34").eval()
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # seeded on the CPU: lecun-normal convs, BatchNorm off the identity
        for p in backbone.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5 if p.dim() == 4
                    else 1.0 + 0.1 * torch.randn(p.shape, generator=gen))
        for name, buf in backbone.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) * 0.4 + (0.8 if name.endswith("var") else -0.2))
    backbone = backbone.to("cuda")
    x = torch.randn((2, 3, 128, 192), generator=gen).to("cuda").contiguous(memory_format=torch.channels_last)
    pfc.reset_launches()
    with torch.no_grad():
        stock = backbone(x)
        with pfc.fused_forward():
            got = backbone(x)
            kept = ({id(t): t._fused_cache[1] for t in backbone.modules() if isinstance(t, Tree) and t._fused_cache},
                    {k: v[1] for k, v in backbone._fused_cache.items()})
            heads = {id(t): t._fused_head_cache[1] for t in backbone.modules()
                     if isinstance(t, Tree) and t._fused_head_cache}
            again = backbone(x)
    torch.cuda.synchronize()
    # at 128x192 p5 (4x6) has even dims too: four fused FPN levels a forward
    assert pfc.LAUNCHES["tree_tail"] == 12 and pfc.LAUNCHES["fpn_level"] == 8 and pfc.LAUNCHES["block_down"] == 8
    assert len(kept[0]) == 6 and sorted(kept[1]) == ["2", "3", "4", "5"] and len(heads) == 4
    assert all(t._fused_cache[1] is kept[0][id(t)] for t in backbone.modules() if isinstance(t, Tree) and t._fused_cache)
    assert all(t._fused_head_cache[1] is heads[id(t)] for t in backbone.modules()
               if isinstance(t, Tree) and t._fused_head_cache)
    assert all(backbone._fused_cache[k][1] is v for k, v in kept[1].items())
    for lvl in stock:
        assert torch.equal(got[lvl], again[lvl])
        err = (got[lvl] - stock[lvl]).abs().max().item() / stock[lvl].abs().max().item()
        assert err <= 1e-4, (lvl, err)
