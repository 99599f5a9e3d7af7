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

* K4's packed weights (``pack_conv3x3``, the ``wgmma`` B layout): each
  element where the 128-byte swizzle puts it, unpacking gives
  ``fold_convbn``'s weights exactly, and ``ResBasicBlock`` keeps them until a
  conv or BatchNorm tensor changes; the CPU and training forwards leave the
  cache empty.
* The bf16 kernel's indexing (``csrc/conv_wgmma.cuh``) emulated in float64:
  slabs copied as its tensor copies land (zeros outside the map, NaN in rows
  no copy writes), A rows read through its per-lane tap mask, B through the
  swizzle, tiles and slices as its grid walks them, against ``F.conv2d``:
  exact to 1e-9.
* ``basic_block_tile`` fills the card at ResNet34's four K4 shapes.

On a CUDA card only (marked ``gpu``): K4 vs its plain version at small shapes
with ragged tiles and at every channel count of ResNet34, f32 to 1e-4 and bf16
to 2^-6 of the largest entry, two bf16 runs bit-equal, and the ResNet34 trunk
fused vs stock in f32.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_port as tp

import jax
import jax.numpy as jnp

from threedod.ops import fused_conv as jfc
from threedod_torch.models.backbones.fpn import build_backbone
from threedod_torch.models.backbones.layers import fold_convbn
from threedod_torch.models.backbones.resnet import ResBasicBlock
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


# ---------------- K4's packed weights and the bf16 kernel's indexing ----------


def _seeded_block(c, seed=0):
    blk = ResBasicBlock(c, c).eval()
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in [*blk.named_parameters(), *blk.named_buffers()]:
            t.copy_(torch.randn(t.shape, generator=gen) * 0.2 + (1.0 if name.endswith(("var", "bn1.weight")) else 0.0))
            if name.endswith("var"):
                t.abs_()
    return blk


@pytest.mark.parametrize("c", [16, 80])
def test_packed_weights_are_the_folded_ones_in_the_swizzle(c):
    blk = _seeded_block(c)
    packed = blk.fused_weights(torch.bfloat16, torch.device("cpu"))
    assert packed.dtype == torch.bfloat16 and packed.c == c
    nk, coutp = -(-c // 64), -(-c // 128) * 128
    for conv, bn, w, b in ((blk.conv1, blk.bn1, packed.w1, packed.b1), (blk.conv2, blk.bn2, packed.w2, packed.b2)):
        wf, bf = fold_convbn(conv, bn)
        assert w.shape == (nk, 9, coutp, 64) and w.dtype == torch.bfloat16
        assert torch.equal(pfc.unpack_conv3x3(w, c, c), wf.to(torch.bfloat16))
        assert torch.equal(b, bf) and b.dtype == torch.float32
        # element (n, k) of tap (dy, dx): chunk k // 64, 16-byte piece (k % 64 // 8) ^ (n % 8) of row n
        for n, k, dy, dx in ((0, 0, 0, 0), (9, 13, 1, 2), (c - 1, c - 1, 2, 1), (5, c - 3, 2, 2)):
            col = 8 * ((k % 64 // 8) ^ (n % 8)) + k % 8
            assert w[k // 64, 3 * dy + dx, n, col] == wf[n, k, dy, dx].to(torch.bfloat16)
        # zeros past cout and past cin
        assert not w[:, :, c:].any() and not pfc.unpack_conv3x3(w, c, nk * 64)[:, c:].any()


def test_block_keeps_its_packed_weights_until_a_tensor_changes():
    blk = _seeded_block(32, seed=1)
    cpu = torch.device("cpu")
    first = blk.fused_weights(torch.bfloat16, cpu)
    assert blk.fused_weights(torch.bfloat16, cpu) is first  # cached
    with torch.no_grad():
        blk.bn1.running_var.mul_(4.0)  # an in-place BN statistic update
    second = blk.fused_weights(torch.bfloat16, cpu)
    assert second is not first and not torch.equal(second.w1, first.w1) and torch.equal(second.w2, first.w2)
    assert torch.equal(pfc.unpack_conv3x3(second.w1, 32, 32), fold_convbn(blk.conv1, blk.bn1)[0].to(torch.bfloat16))
    blk.load_state_dict(_seeded_block(32, seed=2).state_dict())
    third = blk.fused_weights(torch.bfloat16, cpu)
    assert not torch.equal(third.w2, second.w2)
    f32 = blk.fused_weights(torch.float32, cpu)  # another dtype: the CUDA cores' (3, 3, cin, cout) f32
    assert f32.w1.shape == (3, 3, 32, 32) and f32.w1.dtype == torch.float32


def test_cpu_and_training_forwards_leave_the_cache_empty():
    blk = _seeded_block(16)
    x = torch.randn(1, 16, 5, 6)
    with torch.no_grad(), pfc.fused_forward():
        got = blk(x)
        blk.train()
        blk(x)
    assert blk._fused_cache is None
    blk.eval()
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), blk(x).numpy(), atol=1e-5)


def _emulate_conv(x, packed, bias, resid, b, h, w, c, bn, mt):
    """What ``conv3x3_wgmma<bn, mt>`` computes, step by step in float64: x
    and resid (P, C), packed from ``pack_conv3x3``; -> (P, C) before
    rounding."""
    P, nk, coutp, bm = b * h * w, packed.shape[0], packed.shape[2], 64 * mt
    S, nr, rows, box = pfc.k4_slab(w, bm)
    na = 2 if nk > 1 else 1
    xpad = torch.zeros(P, nk * 64, dtype=torch.float64)  # the tensor map's view: zeros past C
    xpad[:, :c] = x
    out = torch.zeros(P, c, dtype=torch.float64)
    col = 8 * (torch.arange(64) // 8)[None, :] ^ 8 * (torch.arange(bn) % 8)[:, None]
    col = col + torch.arange(64)[None, :] % 8  # stored column of logical (n, k) in a swizzled tile
    for tile in range(math.ceil(P / bm)):
        p0 = tile * bm
        q = p0 + torch.arange(bm)
        rem = q % (h * w)
        y, xx = rem // w, rem % w
        mask = torch.zeros(bm, 9, dtype=torch.bool)
        for t in range(9):
            yy, xs = y + t // 3 - 1, xx + t % 3 - 1
            mask[:, t] = (q < P) & (yy >= 0) & (yy < h) & (xs >= 0) & (xs < w)
        for n0 in range(0, math.ceil(c / bn) * bn, bn):
            slabs = [torch.full((rows, 64), float("nan"), dtype=torch.float64) for _ in range(na)]  # never written
            acc = torch.zeros(bm, bn, dtype=torch.float64)
            for kc in range(nk):
                slab = slabs[kc % na]
                for r in range(nr):  # one tensor copy a band: box rows from s0, zeros outside [0, P)
                    s0 = p0 + (-w if nr == 1 else (r - 1) * w) - 1
                    src = torch.arange(s0, s0 + box)
                    inside = (src >= 0) & (src < P)
                    slab[r * S * (nr == 3) + torch.arange(box)] = torch.where(
                        inside[:, None], xpad[src.clamp(0, P - 1), 64 * kc: 64 * kc + 64], torch.zeros(()))
                for t in range(9):
                    idx = torch.arange(bm) + t % 3 + (t // 3) * S
                    a = torch.where(mask[:, t, None], slab[idx.clamp(max=rows - 1)], torch.zeros(()))
                    tile_b = packed[kc, t, n0: n0 + bn].double()
                    acc += a @ torch.gather(tile_b, 1, col).T
            keep = q < P
            for j in range(bn):
                if n0 + j < c:
                    v = acc[:, j] + bias[n0 + j]
                    if resid is not None:
                        v = v + resid[q.clamp(max=P - 1), n0 + j]
                    out[q[keep], n0 + j] = torch.relu(v[keep])
    return out


@pytest.mark.parametrize("b,h,w,c,bn,mt", [(2, 5, 7, 80, 64, 1), (2, 5, 7, 80, 128, 2), (1, 3, 70, 16, 64, 1),
                                           (1, 1, 9, 64, 64, 2), (3, 4, 4, 128, 128, 1), (1, 2, 140, 32, 64, 2),
                                           (1, 3, 100, 16, 128, 2)])
def test_wgmma_conv_indexing_emulated(b, h, w, c, bn, mt):
    """Ragged last tiles, a short k-chunk and a padded slice (C = 80), bands
    (W = 70 > 66 at 64 rows, W = 140 > 130 at 128, and W = 100 whose run
    would pass a copy's 256 rows), one row (H = 1), tiles that span images
    (4x4 maps)."""
    gen = torch.Generator().manual_seed(c + w)
    rnd = lambda *s, k=1.0: (k * torch.randn(*s, generator=gen)).to(torch.bfloat16).double()  # noqa: E731
    x, wt, bias, resid = rnd(b, h, w, c), rnd(c, c, 3, 3, k=0.1), rnd(c), rnd(b, h, w, c)
    packed = pfc.pack_conv3x3(wt)
    flat = lambda t: t.reshape(b * h * w, c)  # noqa: E731
    ref = F.conv2d(x.permute(0, 3, 1, 2), wt, bias, padding=1).permute(0, 2, 3, 1)
    got = _emulate_conv(flat(x), packed, bias, None, b, h, w, c, bn, mt)
    torch.testing.assert_close(got, flat(torch.relu(ref)), atol=1e-9, rtol=0)
    got = _emulate_conv(flat(x), packed, bias, flat(resid), b, h, w, c, bn, mt)
    torch.testing.assert_close(got, flat(torch.relu(ref + resid)), atol=1e-9, rtol=0)


def test_basic_block_tile_fills_the_card():
    for c, h, w, _ in [(64, 128, 168, 3), (128, 64, 84, 3), (256, 32, 42, 5), (512, 16, 21, 2)]:
        bn, mt = pfc.basic_block_tile(8, h, w, c)
        assert bn in (64, 128) and mt in (1, 2)
        assert math.ceil(8 * h * w / (64 * mt)) * math.ceil(c / bn) >= pfc.SMS, (c, bn, mt)
        assert pfc._k4_smem(bn, mt, c, w) <= 232448
    assert pfc.basic_block_tile(1, 5, 7, 16) in ((64, 1), (64, 2))


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
@pytest.mark.parametrize("b,h,w,c", [(2, 16, 12, 32), (1, 17, 13, 16), (2, 21, 19, 64), (1, 5, 7, 128),
                                     (2, 7, 9, 64), (1, 16, 21, 128), (2, 16, 21, 256), (1, 7, 9, 512),
                                     (3, 1, 37, 256), (1, 1, 70, 64), (2, 9, 70, 128), (8, 16, 21, 512)])
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
@pytest.mark.parametrize("b,h,w,c", [(2, 16, 21, 256), (1, 9, 70, 64)])
def test_basic_block_kernel_is_deterministic_on_card(b, h, w, c):
    """No atomics: two bf16 runs on the same input are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("the fused conv kernels need a CUDA card")
    dev = torch.device("cuda")
    x, w1, b1, w2, b2 = _torch_args(*_block_case(b, h, w, c, seed=c))
    packed = pfc.pack_basic_block(w1.to(dev), b1.to(dev), w2.to(dev), b2.to(dev), torch.bfloat16)
    xd = x.to(dev, torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        first = pfc.fused_basic_block_packed(xd, packed)
        second = pfc.fused_basic_block_packed(xd, packed)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


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
