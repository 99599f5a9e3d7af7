"""Kernel K4 (``fused_basic_block``) and the fused eval paths of the port's
ResNet trunks, f32 on the CPU, where the fused functions run their plain
versions.

* ``fused_basic_block`` vs the JAX package's ``basic_block_reference`` and its
  Pallas kernel in interpret mode, at two shapes: atol 1e-4 (sums of a few
  hundred f32 terms in another order).
* ResNet34 with the switch on vs the same trunk with it off, and vs the JAX
  trunk running its Pallas kernels in interpret mode
  (``threedod.ops.fused_conv.FORCE_INTERPRET``), from one set of seeded
  weights at 128x96: atol 2e-4 (34 convolutions, features of order 1 to 10).
* Which call sites engage, counted on ``meta`` tensors with the five functions
  replaced by recorders. ResNet34 at 512x672: K4 13 times (3 at C = 64, 3 at
  128, 5 at 256, 2 at 512), K6 3 times with the subsampled residual through
  the folded downsample, K8 3 times, K7 5 times. A stride-2 block on odd
  input dims, a ``ResBottleneck`` and training mode take no fused path.
* The K8 rule on lateral widths: a level whose trunk input is not a multiple
  of 16 channels keeps the stock path. ShuffleNet (24, 116, 232, 464) fuses
  nothing at 512x672 (p5 has an odd width) and p5 alone at 512x640; MNASNet
  (24, 40, 96, 320) fuses p4 alone at 512x672.

On a CUDA card only (marked ``gpu``): K4 vs its plain version at small shapes
with ragged tiles, f32 to 1e-4 and bf16 to 2^-6 of the largest entry, and the
ResNet34 trunk fused vs stock in f32.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp

from threedod.ops import fused_conv as jfc
from threedod_torch.models.backbones.fpn import build_backbone
from threedod_torch.ops import fused_conv as pfc

FUSED = ("fused_basic_block", "fused_block_down", "fused_tree_tail", "fused_fpn_level", "fused_conv_relu_head")


@pytest.fixture
def force_interpret():
    jfc.FORCE_INTERPRET = True
    try:
        yield
    finally:
        jfc.FORCE_INTERPRET = False


@pytest.fixture(scope="module")
def resnet34():
    """(JAX variables of an RCNN3D on resnet34, numpy; the port model loaded from them)."""
    jcfg, pcfg = tp.configs(**{"model.backbone": "resnet34"})
    variables = tp.seeded_variables(jcfg, seed=1)
    return variables, tp.port_model(pcfg, variables)


def _block_case(b, h, w, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h, w, c) * 0.5).astype(np.float32)
    w1, w2 = ((rng.randn(3, 3, c, c) * 0.05).astype(np.float32) for _ in range(2))
    b1, b2 = ((rng.randn(c) * 0.1).astype(np.float32) for _ in range(2))
    return x, w1, b1, w2, b2


def _torch_args(x, w1, b1, w2, b2):
    """NHWC / HWIO numpy -> the port's NCHW activation and (O, I, kh, kw) weights."""
    conv = lambda a: torch.from_numpy(a).permute(3, 2, 0, 1).contiguous()  # noqa: E731
    return (torch.from_numpy(x).permute(0, 3, 1, 2), conv(w1), torch.from_numpy(b1), conv(w2), torch.from_numpy(b2))


@pytest.mark.parametrize("b,h,w,c,ht", [(2, 16, 12, 8, 8), (1, 32, 10, 16, 16)])
def test_basic_block_matches_jax(b, h, w, c, ht):
    case = _block_case(b, h, w, c, seed=h)
    jargs = tuple(jnp.asarray(a) for a in case)
    ref = np.asarray(jfc.basic_block_reference(*jargs))
    pallas = np.asarray(jfc.fused_basic_block(*jargs, interpret=True, ht=ht))
    got = pfc.fused_basic_block(*_torch_args(*case))
    assert got.shape == (b, c, h, w)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), pallas, atol=1e-4)


def test_basic_block_on_the_cpu_is_the_plain_version_and_counts_no_launch():
    args = _torch_args(*_block_case(1, 8, 8, 8, seed=0))
    before = dict(pfc.LAUNCHES)
    np.testing.assert_array_equal(pfc.fused_basic_block(*args).numpy(), pfc.basic_block_reference(*args).numpy())
    assert pfc.LAUNCHES == before and "basic_block" in before
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        pfc.fused_basic_block(*(torch.empty(a.shape, device="meta") for a in args))


def test_resnet34_fused_matches_stock_and_jax(resnet34, force_interpret):
    from threedod.models.backbones.resnet import build_resnet

    variables, port = resnet34
    x = np.random.RandomState(3).randn(1, 128, 96, 3).astype(np.float32)
    trunk = port.backbone.bottom_up
    with torch.no_grad():
        stock = trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
        with pfc.fused_forward():
            got = trunk(torch.from_numpy(x).permute(0, 3, 1, 2))
    tvars = {"params": variables["params"]["backbone"]["trunk"],
             "batch_stats": variables["batch_stats"]["backbone"]["trunk"]}
    assert jfc.fused_conv_available() and jfc.kernel_interpret()
    jtrunk = build_resnet("resnet34", dtype=jnp.float32)
    ref = jax.jit(lambda v, a: jtrunk.apply(v, a, train=False))(tvars, x)
    assert sorted(got) == ["p2", "p3", "p4", "p5", "p6"]
    for lvl in got:
        np.testing.assert_allclose(got[lvl].numpy(), stock[lvl].numpy(), atol=2e-4, err_msg=f"fused vs stock {lvl}")
        np.testing.assert_allclose(got[lvl].permute(0, 2, 3, 1).numpy(), np.asarray(ref[lvl]), atol=2e-4,
                                   err_msg=f"fused vs JAX fused {lvl}")


# ---------------- which call sites engage ----------------------------------


@pytest.fixture
def recorder(monkeypatch):
    """Replace the five functions by recorders that return ``meta`` tensors of
    the right shapes; yields the list of (name, x shape, details)."""
    calls = []

    def basic_block(x, w1, b1, w2, b2):
        assert tuple(w1.shape) == tuple(w2.shape) == (x.shape[1], x.shape[1], 3, 3)
        calls.append(("fused_basic_block", tuple(x.shape), {}))
        return x.new_empty(x.shape)

    def block_down(x, w1, b1, w2, b2, wproj=None, bproj=None, *, pool_residual=True):
        assert wproj is None or tuple(wproj.shape) == (w1.shape[0], x.shape[1], 1, 1)
        calls.append(("fused_block_down", tuple(x.shape), dict(proj=wproj is not None, pool_residual=pool_residual)))
        return x.new_empty((x.shape[0], w1.shape[0], x.shape[2] // 2, x.shape[3] // 2))

    def tree_tail(x, *args, **kw):
        raise AssertionError("a ResNet has no tree tail")

    def fpn_level(f, prev, wlat, blat, wout, bout, *, emit_cur=True):
        calls.append(("fused_fpn_level", tuple(f.shape), dict(emit_cur=emit_cur)))
        out = f.new_empty((f.shape[0], wout.shape[0], *f.shape[2:]))
        return (out, out.clone()) if emit_cur else out

    def conv_relu_head(x, wc, bc, wh, bh):
        calls.append(("fused_conv_relu_head", tuple(x.shape), dict(n_out=wh.shape[0])))
        return x.new_empty((x.shape[0], wh.shape[0], *x.shape[2:]))

    for name, fn in zip(FUSED, (basic_block, block_down, tree_tail, fpn_level, conv_relu_head)):
        monkeypatch.setattr(pfc, name, fn)
    return calls


def _by_name(calls):
    return {name: [c for c in calls if c[0] == name] for name in FUSED}


def test_launch_site_census_resnet34(resnet34, recorder):
    port = copy.deepcopy(resnet34[1]).to("meta")
    h, w = 512, 672
    x = torch.empty((8, 3, h, w), device="meta")
    with torch.no_grad(), pfc.fused_forward():
        feats = port.backbone(x)
        port.proposal_generator.rpn_head(feats)
    by = _by_name(recorder)
    assert {k: len(v) for k, v in by.items()} == {
        "fused_basic_block": 13, "fused_block_down": 3, "fused_tree_tail": 0, "fused_fpn_level": 3,
        "fused_conv_relu_head": 5}
    s = lambda d: (h // d, w // d)  # noqa: E731
    # K4: every stride-1 block, layer by layer (the first block of layers 2 to 4 is K6's)
    assert [c[1] for c in by["fused_basic_block"]] == (
        [(8, 64, *s(4))] * 3 + [(8, 128, *s(8))] * 3 + [(8, 256, *s(16))] * 5 + [(8, 512, *s(32))] * 2)
    # K6: layer2.0, layer3.0, layer4.0, the 1x1 stride-2 downsample as the projection of x[::2, ::2]
    assert [c[1] for c in by["fused_block_down"]] == [(8, 64, *s(4)), (8, 128, *s(8)), (8, 256, *s(16))]
    assert all(c[2] == dict(proj=True, pool_residual=False) for c in by["fused_block_down"])
    # K8: p4, p3 hand their carry down, p2 does not; p5 (odd width) and p6 (no carry) stay stock
    assert [(c[1], c[2]["emit_cur"]) for c in by["fused_fpn_level"]] == [
        ((8, 256, *s(16)), True), ((8, 128, *s(8)), True), ((8, 64, *s(4)), False)]
    assert [c[1][2:] for c in by["fused_conv_relu_head"]] == [s(4), s(8), s(16), s(32), (8, 11)]


def test_odd_dims_training_and_the_switch_engage_nothing_more(resnet34, recorder):
    port = copy.deepcopy(resnet34[1]).to("meta")
    trunk = port.backbone.bottom_up
    with torch.no_grad():
        # 40x56 -> layer1 10x14 -> layer2.0 fuses (even) -> 5x7 -> layer3.0, layer4.0 stay stock (odd)
        with pfc.fused_forward():
            trunk(torch.empty((1, 3, 40, 56), device="meta"))
        by = _by_name(recorder)
        assert [c[1] for c in by["fused_block_down"]] == [(1, 64, 10, 14)]
        assert len(by["fused_basic_block"]) == 13
        recorder.clear()
        trunk(torch.empty((1, 3, 64, 96), device="meta"))  # switch off
        port.train()
        with pfc.fused_forward():
            port.backbone(torch.empty((2, 3, 64, 96), device="meta"))  # eval only
    assert recorder == []


def test_bottleneck_has_no_fused_path(recorder):
    trunk = build_backbone("resnet50").eval().to("meta").bottom_up
    with torch.no_grad(), pfc.fused_forward():
        out = trunk(torch.empty((1, 3, 64, 96), device="meta"))
    assert recorder == [] and out["p5"].shape == (1, 2048, 2, 3)


@pytest.mark.parametrize("name,hw,fused_levels", [
    ("shufflenet", (512, 672), []),
    ("shufflenet", (512, 640), [(464, 16, 20)]),
    ("mnasnet", (512, 672), [(96, 32, 42)]),
    ("densenet121", (512, 672), [(1024, 32, 42), (512, 64, 84), (256, 128, 168)]),
])
def test_fpn_levels_off_the_kernels_width_stay_stock(recorder, name, hw, fused_levels):
    """K8 takes lateral inputs in multiples of 16 channels; the wrapper would
    raise on another width, so the module must not send it one."""
    bb = build_backbone(name).eval().to("meta")
    with torch.no_grad(), pfc.fused_forward():
        out = bb(torch.empty((2, 3, *hw), device="meta"))
    assert sorted(out) == ["p2", "p3", "p4", "p5", "p6"]
    assert [c[1][1:] for c in recorder if c[0] == "fused_fpn_level"] == fused_levels
    assert all(c[0] == "fused_fpn_level" for c in recorder)


def test_fpn_stock_levels_between_fused_ones_match():
    """MNASNet at 64x96: p4 (96 channels, 4x6) is the one fused level; the
    levels around it keep the stock path and the whole pyramid still agrees
    with the switch off (atol 1e-4)."""
    bb = build_backbone("mnasnet").eval()
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in bb.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (0.1 if p.dim() == 4 else 0.2) + (p.dim() == 1))
        x = torch.randn((1, 3, 64, 96), generator=gen)
        stock = bb(x)
        with pfc.fused_forward():
            got = bb(x)
    for lvl in stock:
        np.testing.assert_allclose(got[lvl].numpy(), stock[lvl].numpy(), atol=1e-4, err_msg=lvl)


# ---------------- on the card ----------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("b,h,w,c", [(2, 16, 12, 32), (1, 17, 13, 16), (2, 21, 19, 64), (1, 5, 7, 128)])
def test_basic_block_kernel_on_card(b, h, w, c, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("the fused conv kernels need a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    x, w1, b1, w2, b2 = _torch_args(*_block_case(b, h, w, c, seed=c))
    args = (x.to(dev, dtype).contiguous(memory_format=torch.channels_last), w1.to(dev), b1.to(dev), w2.to(dev), b2.to(dev))
    before = pfc.LAUNCHES["basic_block"]
    out = pfc.fused_basic_block(*args)
    torch.cuda.synchronize()
    assert pfc.LAUNCHES["basic_block"] == before + 1
    ref = pfc.basic_block_reference(*args)
    assert out.shape == ref.shape and out.dtype == dtype
    scale = ref.float().abs().amax().clamp(min=1.0)
    assert ((out.float() - ref.float()).abs().amax() / scale).item() <= tol


@pytest.mark.gpu
def test_resnet34_trunk_fused_vs_stock_on_card():
    if not torch.cuda.is_available():
        pytest.skip("the fused conv kernels need a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    trunk = build_backbone("resnet34").eval().bottom_up
    gen = torch.Generator().manual_seed(5)
    with torch.no_grad():  # seeded on the CPU: lecun-normal convs, BatchNorm off the identity
        for p in trunk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) / p[0].numel() ** 0.5 if p.dim() == 4
                    else 1.0 + 0.1 * torch.randn(p.shape, generator=gen))
        for name, buf in trunk.named_buffers():
            buf.copy_(torch.rand(buf.shape, generator=gen) * 0.4 + (0.8 if name.endswith("var") else -0.2))
    trunk = trunk.to("cuda")
    x = torch.randn((2, 3, 128, 96), generator=gen).to("cuda").contiguous(memory_format=torch.channels_last)
    pfc.reset_launches()
    with torch.no_grad():
        stock = trunk(x)
        with pfc.fused_forward():
            got = trunk(x)
    torch.cuda.synchronize()
    assert pfc.LAUNCHES["basic_block"] == 13 and pfc.LAUNCHES["block_down"] == 3
    for lvl in stock:
        err = (got[lvl] - stock[lvl]).abs().max().item() / stock[lvl].abs().max().item()
        assert err <= 1e-4, (lvl, err)
