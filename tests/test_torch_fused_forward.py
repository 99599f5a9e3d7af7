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
from threedod_torch.models.backbones.fpn import BackboneWithFPN
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


def _seeded_tree(cin, cout, stride, level_root=False):
    tree = Tree(1, cin, cout, stride, level_root=level_root).eval()
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
