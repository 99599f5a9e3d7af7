"""The port's four fused-forward functions (``threedod_torch/ops/fused_conv.py``,
kernels K5 to K8) vs ``threedod/ops/fused_conv.py``, f32 on the CPU.

The same numpy-seeded inputs go through three things: the JAX package's XLA
reference, its Pallas kernel in interpret mode, and the port's plain version
(which is what the port's wrapper runs for a CPU tensor). The port takes NCHW
tensors and ``nn.Conv2d``-layout weights, the JAX package NHWC and HWIO; the
tests transpose. All three agree to atol 1e-4 (sums of a few hundred f32
terms in another order). Shapes and variants are those of
``tests/test_fused_conv.py``.

K5's to K8's bf16 forms on ``csrc/conv_wgmma.cuh``, on the CPU:
``pack_tree_tail``, ``pack_fpn_level``, ``pack_block_down`` and
``pack_conv_relu_head`` give back the folded weights exactly (the root's
rows in concat order: x2, x1, the children, x; K7's predictors padded to 16),
and the weights unpacked from the last two through the plain versions give
the public calls; float64 emulations of ``conv1x1_wgmma``'s indexing (the
sources' chunks, tensor copies with zeros past P and past a source's
channels, the swizzled weight tiles, slices, the ragged last tile, the carry
read at (y / 2, x / 2)) and of ``conv3x3s2_wgmma``'s (the four parity
planes' tensor copies, tap offsets and masks, the zero rows at -1 and the
image above's last row masked, Cin = 32, an odd Wo, the pooled and
subsampled residual's source) equal the plain computation to 1e-9;
``conv1x1_tile`` and ``block_down_tile`` pick blocks that fit at 132 SMs and
at another count, ``block_down_tile`` the fastest at 132.

On a CUDA card only (marked ``gpu``): each kernel vs its plain version at
small shapes with channel counts the kernels take (multiples of 16), over the
variants the serving path does not reach (root residual, no projection,
subsampled residual, ragged tiles), f32 to 1e-4 and bf16 to 2^-6 of the
largest entry; K5's and K8's packed calls at both 1x1 block shapes and with
seven root sources; K6's at every stride-2 block shape with Cin = 32 and
128 and Wo = 21, K7's at the 8x11 level with every 3x3 and 1x1 block shape. The kernels have no backward and refuse a gradient on the
card; that check runs before anything card-specific, so it is tested here.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import _torch_port  # noqa: F401  (one torch thread per test worker)

import jax.numpy as jnp

from threedod.ops import fused_conv as jfc
from threedod_torch.ops import fused_conv as pfc

ATOL = 1e-4


def _t(a):
    """NHWC numpy activation -> NCHW torch tensor."""
    return torch.from_numpy(a).permute(0, 3, 1, 2)


def _w(a):
    """HWIO (or (I, O)) numpy kernel -> (O, I, kh, kw) torch weight."""
    if a.ndim == 2:
        a = a[None, None]
    return torch.from_numpy(a).permute(3, 2, 0, 1).contiguous()


def _back(t):
    return t.permute(0, 2, 3, 1).numpy()


def _rand_bb(rng, cin, cout):
    return (
        (rng.randn(3, 3, cin, cout) * 0.05).astype(np.float32), (rng.randn(cout) * 0.1).astype(np.float32),
        (rng.randn(3, 3, cout, cout) * 0.05).astype(np.float32), (rng.randn(cout) * 0.1).astype(np.float32),
    )


def _bb_torch(bb):
    w1, b1, w2, b2 = bb
    return _w(w1), torch.from_numpy(b1), _w(w2), torch.from_numpy(b2)


def _j(*arrays):
    return tuple(None if a is None else jnp.asarray(a) for a in arrays)


def _tree_tail_case(two_blocks, n_children, incl, c=8, child_c=4, b=2, h=16, w=12, seed=1):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h, w, c) * 0.5).astype(np.float32)
    children = [(rng.randn(b, h, w, child_c) * 0.5).astype(np.float32) for _ in range(n_children)]
    bb_a = _rand_bb(rng, c, c) if two_blocks else None
    bb_b = _rand_bb(rng, c, c)
    ctot = 2 * c + child_c * n_children + (c if incl else 0)
    wr = (rng.randn(ctot, c) * 0.05).astype(np.float32)
    br = (rng.randn(c) * 0.1).astype(np.float32)
    return x, children, bb_a, bb_b, wr, br


@pytest.mark.parametrize(
    "two_blocks,n_children,incl,rres",
    [(False, 0, False, False), (False, 1, False, False), (True, 1, True, False), (True, 0, False, True)],
)
def test_tree_tail_matches_jax(two_blocks, n_children, incl, rres):
    x, children, bb_a, bb_b, wr, br = _tree_tail_case(two_blocks, n_children, incl)
    kw = dict(two_blocks=two_blocks, include_input_child=incl, root_residual=rres)
    jargs = (jnp.asarray(x), _j(*children), None if bb_a is None else _j(*bb_a), _j(*bb_b), *_j(wr, br))
    ref = np.asarray(jfc.tree_tail_reference(*jargs, **kw))
    pallas = np.asarray(jfc.fused_tree_tail(*jargs, interpret=True, ht=8, **kw))
    got = pfc.fused_tree_tail(
        _t(x), [_t(c) for c in children], None if bb_a is None else _bb_torch(bb_a), _bb_torch(bb_b),
        _w(wr), torch.from_numpy(br), **kw)
    assert got.shape == (x.shape[0], wr.shape[1], x.shape[1], x.shape[2])
    np.testing.assert_allclose(_back(got), ref, atol=ATOL)
    np.testing.assert_allclose(_back(got), pallas, atol=ATOL)


def _block_down_case(b, h2, w2, cin, cout, proj, seed=4):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h2, w2, cin) * 0.5).astype(np.float32)
    w1, b1, w2_, b2 = _rand_bb(rng, cin, cout)
    wp = (rng.randn(1, 1, cin, cout) * 0.05).astype(np.float32) if proj else None
    bp = (rng.randn(cout) * 0.1).astype(np.float32) if proj else None
    return x, w1, b1, w2_, b2, wp, bp


@pytest.mark.parametrize(
    "b,h2,w2,cin,cout,proj,pool",
    [
        (1, 16, 24, 8, 16, True, True),
        (2, 32, 22, 8, 16, True, True),  # odd W_out
        (1, 16, 24, 16, 16, False, True),
        (1, 16, 24, 8, 16, True, False),  # the ResNet downsample's subsampled residual
    ],
)
def test_block_down_matches_jax(b, h2, w2, cin, cout, proj, pool):
    x, w1, b1, w2_, b2, wp, bp = _block_down_case(b, h2, w2, cin, cout, proj)
    jargs = _j(x, w1, b1, w2_, b2, wp, bp)
    ref = np.asarray(jfc.block_down_reference(*jargs, pool_residual=pool))
    pallas = np.asarray(jfc.fused_block_down(*jargs, pool_residual=pool, interpret=True, ht=8))
    got = pfc.fused_block_down(
        _t(x), _w(w1), torch.from_numpy(b1), _w(w2_), torch.from_numpy(b2),
        None if wp is None else _w(wp), None if bp is None else torch.from_numpy(bp), pool_residual=pool)
    assert got.shape == (b, cout, h2 // 2, w2 // 2)
    np.testing.assert_allclose(_back(got), ref, atol=ATOL)
    np.testing.assert_allclose(_back(got), pallas, atol=ATOL)


def _fpn_case(b=2, h=16, w=12, cl=8, c=16, seed=8):
    rng = np.random.RandomState(seed)
    f = (rng.randn(b, h, w, cl) * 0.5).astype(np.float32)
    prev = (rng.randn(b, h // 2, w // 2, c) * 0.5).astype(np.float32)
    wl = (rng.randn(1, 1, cl, c) * 0.1).astype(np.float32)
    bl = (rng.randn(c) * 0.1).astype(np.float32)
    wo = (rng.randn(3, 3, c, c) * 0.05).astype(np.float32)
    bo = (rng.randn(c) * 0.1).astype(np.float32)
    return f, prev, wl, bl, wo, bo


@pytest.mark.parametrize("emit_cur", [True, False])
def test_fpn_level_matches_jax(emit_cur):
    f, prev, wl, bl, wo, bo = _fpn_case()
    jargs = _j(f, prev, wl, bl, wo, bo)
    ref_out, ref_cur = (np.asarray(a) for a in jfc.fpn_level_reference(*jargs))
    pallas = jfc.fused_fpn_level(*jargs, emit_cur=emit_cur, interpret=True, ht=8)
    got = pfc.fused_fpn_level(_t(f), _t(prev), _w(wl), torch.from_numpy(bl), _w(wo), torch.from_numpy(bo),
                              emit_cur=emit_cur)
    if emit_cur:
        assert isinstance(got, tuple) and len(got) == 2
        np.testing.assert_allclose(_back(got[1]), ref_cur, atol=ATOL)
        np.testing.assert_allclose(_back(got[1]), np.asarray(pallas[1]), atol=ATOL)
        got, pallas = got[0], pallas[0]
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(_back(got), ref_out, atol=ATOL)
    np.testing.assert_allclose(_back(got), np.asarray(pallas), atol=ATOL)


def _head_case(b=2, h=16, w=11, c=32, n_out=15, seed=5):
    rng = np.random.RandomState(seed)
    x = (rng.randn(b, h, w, c) * 0.5).astype(np.float32)
    wc = (rng.randn(3, 3, c, c) * 0.05).astype(np.float32)
    bc = (rng.randn(c) * 0.1).astype(np.float32)
    wh = (rng.randn(c, n_out) * 0.05).astype(np.float32)
    bh = (rng.randn(n_out) * 0.1).astype(np.float32)
    return x, wc, bc, wh, bh


def test_conv_relu_head_matches_jax():
    x, wc, bc, wh, bh = _head_case()
    jargs = _j(x, wc, bc, wh, bh)
    ref = np.asarray(jfc.conv_relu_head_reference(*jargs))
    pallas = np.asarray(jfc.fused_conv_relu_head(*jargs, interpret=True, ht=8))
    got = pfc.fused_conv_relu_head(_t(x), _w(wc), torch.from_numpy(bc), _w(wh), torch.from_numpy(bh))
    assert got.shape == (2, 15, 16, 11)
    np.testing.assert_allclose(_back(got), ref, atol=ATOL)
    np.testing.assert_allclose(_back(got), pallas, atol=ATOL)


def test_basic_block_reference_matches_jax():
    rng = np.random.RandomState(0)
    x = (rng.randn(1, 8, 12, 8) * 0.5).astype(np.float32)
    bb = _rand_bb(rng, 8, 8)
    ref = np.asarray(jfc.basic_block_reference(*_j(x, *bb)))
    np.testing.assert_allclose(_back(pfc.basic_block_reference(_t(x), *_bb_torch(bb))), ref, atol=ATOL)


def test_switch_is_off_by_default_and_restored():
    assert pfc.ENABLED is False and not pfc.fused_conv_available()
    with pfc.fused_forward():
        assert pfc.fused_conv_available()
        with pfc.fused_forward(False):
            assert not pfc.fused_conv_available()
        assert pfc.fused_conv_available()
    assert not pfc.fused_conv_available()
    with pytest.raises(RuntimeError):
        with pfc.fused_forward():
            raise RuntimeError("inside")
    assert not pfc.fused_conv_available()


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    from threedod_torch.ops import _build

    x, wc, bc, wh, bh = _head_case()
    before, built = dict(pfc.LAUNCHES), _build.load.cache_info().currsize
    args = (_t(x), _w(wc), torch.from_numpy(bc), _w(wh), torch.from_numpy(bh))
    got = pfc.fused_conv_relu_head(*args)
    np.testing.assert_array_equal(got.numpy(), pfc.conv_relu_head_reference(*args).numpy())
    assert pfc.LAUNCHES == before and set(before) == {"basic_block", "tree_tail", "block_down", "conv_relu_head", "fpn_level"}
    assert _build.load.cache_info().currsize == built  # nothing was built
    pfc.LAUNCHES["fpn_level"] += 3
    pfc.reset_launches()
    assert set(pfc.LAUNCHES.values()) == {0}
    pfc.LAUNCHES.update(before)


@pytest.mark.parametrize("which", ["tree_tail", "block_down", "fpn_level", "conv_relu_head"])
def test_wrappers_refuse_other_devices(which):
    """No silent fallback: a tensor that is neither on the CPU nor on CUDA raises."""
    m = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    bb = (m(8, 8, 3, 3), m(8), m(8, 8, 3, 3), m(8))
    calls = {
        "tree_tail": lambda: pfc.fused_tree_tail(m(1, 8, 4, 4), [], None, bb, m(8, 16, 1, 1), m(8)),
        "block_down": lambda: pfc.fused_block_down(m(1, 8, 4, 4), *bb),
        "fpn_level": lambda: pfc.fused_fpn_level(
            m(1, 8, 4, 4), m(1, 8, 2, 2), m(8, 8, 1, 1), m(8), m(8, 8, 3, 3), m(8)),
        "conv_relu_head": lambda: pfc.fused_conv_relu_head(m(1, 8, 4, 4), m(8, 8, 3, 3), m(8), m(15, 8, 1, 1), m(15)),
    }
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        calls[which]()


def test_odd_dims_are_refused():
    bb = (torch.zeros(8, 8, 3, 3), torch.zeros(8), torch.zeros(8, 8, 3, 3), torch.zeros(8))
    with pytest.raises(ValueError, match="even input dims"):
        pfc.fused_block_down(torch.zeros(1, 8, 5, 4), *bb)
    with pytest.raises(ValueError, match="even dims and a half-size carry"):
        pfc.fused_fpn_level(torch.zeros(1, 8, 4, 6), torch.zeros(1, 8, 2, 2), torch.zeros(8, 8, 1, 1),
                            torch.zeros(8), torch.zeros(8, 8, 3, 3), torch.zeros(8))


@pytest.mark.parametrize("which", ["basic_block", "tree_tail", "block_down", "conv_relu_head", "fpn_level"])
def test_kernels_refuse_a_gradient(which, monkeypatch):
    """The kernels have no backward: the card branch raises when grad mode is
    on and an input requires a gradient (reached here by taking the card
    branch for CPU tensors); the plain version on the CPU stays
    differentiable."""
    x, b = torch.zeros(1, 16, 4, 4), torch.zeros(16)
    w = torch.zeros(16, 16, 3, 3, requires_grad=True)
    w1 = torch.zeros(16, 16, 1, 1)
    calls = {
        "basic_block": lambda: pfc.fused_basic_block(x, w, b, w, b),
        "tree_tail": lambda: pfc.fused_tree_tail(x, [], None, (w, b, w, b), torch.zeros(16, 32, 1, 1), b),
        "block_down": lambda: pfc.fused_block_down(x, w, b, w, b),
        "conv_relu_head": lambda: pfc.fused_conv_relu_head(x, w, b, w1, b),
        "fpn_level": lambda: pfc.fused_fpn_level(x, torch.zeros(1, 16, 2, 2), w1, b, w, b, emit_cur=False),
    }
    assert calls[which]().grad_fn is not None  # the plain version
    monkeypatch.setattr(pfc, "_on_card", lambda *t: True)
    with pytest.raises(RuntimeError, match="no backward"):
        calls[which]()


# ---------------- K5's and K8's packed weights and the 1x1's indexing --------

H100_SMS = 132  # the streaming multiprocessors of an H100 SXM, which the wrappers read from the card


def _bf16_exact(*shape, seed, k=1.0):
    """float64 values a bf16 holds exactly."""
    gen = torch.Generator().manual_seed(seed)
    return (k * torch.randn(*shape, generator=gen)).to(torch.bfloat16).double()


@pytest.mark.parametrize("two_blocks,children,incl", [(False, (), False), (True, (64,), True), (False, (16, 48), False),
                                                      (True, (16, 48, 16, 32), True)])
def test_pack_tree_tail_gives_back_the_folded_weights(two_blocks, children, incl):
    c, cout = 80, 80
    sources = (c, c, *children) + ((c,) if incl else ())
    bb = [tuple(_bf16_exact(*s, seed=i * 4 + j, k=0.1).float() for j, s in enumerate(((c, c, 3, 3), (c,), (c, c, 3, 3), (c,))))
          for i in range(2)]
    wr, br = _bf16_exact(cout, sum(sources), 1, 1, seed=9).float(), torch.randn(cout)
    packed = pfc.pack_tree_tail(bb[0] if two_blocks else None, bb[1], wr, br, torch.bfloat16, children=children,
                                two_blocks=two_blocks, include_input_child=incl)
    assert packed.sources == sources and packed.c == c and packed.cout == cout
    assert (packed.block_a is not None) == two_blocks and packed.include_input_child == incl
    for blk, w in ((packed.block_a, bb[0]), (packed.block_b, bb[1])):
        if blk is not None:
            assert torch.equal(pfc.unpack_conv3x3(blk.w1, c, c), w[0].to(torch.bfloat16))
            assert torch.equal(pfc.unpack_conv3x3(blk.w2, c, c), w[2].to(torch.bfloat16))
    chunks = [math.ceil(k / 64) for k in sources]
    assert packed.wr.shape == (sum(chunks), 128, 64) and packed.wr.dtype == torch.bfloat16
    assert torch.equal(pfc.unpack_conv1x1(packed.wr, cout, sources), wr.to(torch.bfloat16))
    assert torch.equal(packed.br, br) and packed.br.data_ptr() != br.data_ptr()  # fresh, aligned storage
    # the root's row of source s, channel k: chunk sum(chunks[:s]) + k // 64, 16-byte piece (k % 64 // 8) ^ (n % 8)
    starts = np.cumsum([0, *sources])
    for src, k, n in ((0, 0, 0), (1, 79, 3), (len(sources) - 1, sources[-1] - 1, cout - 1), (2, 5, 17)):
        if src >= len(sources):
            continue
        chunk = sum(chunks[:src]) + k // 64
        col = 8 * ((k % 64 // 8) ^ (n % 8)) + k % 8
        assert packed.wr[chunk, n, col] == wr[n, starts[src] + k, 0, 0].to(torch.bfloat16)
    # a source's last chunk is zero past its channels, and every row past cout is zero
    padded = pfc.unpack_conv1x1(packed.wr, 128, [64 * n for n in chunks])[:, :, 0, 0]
    pstarts = np.cumsum([0, *[64 * n for n in chunks]])
    for src, k in enumerate(sources):
        assert not padded[:, pstarts[src] + k: pstarts[src + 1]].any()
    assert not packed.wr[:, cout:].any()
    f32 = pfc.pack_tree_tail(bb[0] if two_blocks else None, bb[1], wr, br, torch.float32, children=children,
                             two_blocks=two_blocks, include_input_child=incl)
    assert f32.wr.shape == (1, 1, sum(sources), cout) and torch.equal(f32.wr[0, 0], wr[:, :, 0, 0].T)
    with pytest.raises(ValueError, match="wr must be"):
        pfc.pack_tree_tail(None, bb[1], wr[:, 1:], br, torch.bfloat16, children=children, include_input_child=incl)


def test_pack_fpn_level_gives_back_the_folded_weights():
    cl, c = 48, 256
    wl, wo = _bf16_exact(c, cl, 1, 1, seed=1).float(), _bf16_exact(c, c, 3, 3, seed=2, k=0.1).float()
    bl, bo = torch.randn(c), torch.randn(c)
    packed = pfc.pack_fpn_level(wl, bl, wo, bo, torch.bfloat16)
    assert (packed.cl, packed.c) == (cl, c) and packed.wlat.shape == (1, 256, 64) and packed.wout.shape == (4, 9, 256, 64)
    assert torch.equal(pfc.unpack_conv1x1(packed.wlat, c, [cl]), wl.to(torch.bfloat16))
    assert not packed.wlat.reshape(256, 8, 8)[torch.arange(256)[:, None], torch.arange(6, 8)[None, :] ^
                                              (torch.arange(256) % 8)[:, None]].any()  # channels 48 to 63
    assert torch.equal(pfc.unpack_conv3x3(packed.wout, c, c), wo.to(torch.bfloat16))
    assert torch.equal(packed.blat, bl) and torch.equal(packed.bout, bo)
    f32 = pfc.pack_fpn_level(wl, bl, wo, bo, torch.float32)
    assert f32.wlat.shape == (1, 1, cl, c) and f32.wout.shape == (3, 3, c, c)


def _emulate_conv1x1(sources, packed, bias, resid, carry, b, h, w, cout, mt, relu):
    """What ``conv1x1_wgmma<mt, relu>`` computes, step by step in float64:
    ``sources`` (P, C_s) each, ``packed`` from ``pack_conv1x1``, ``resid``
    (P, cout) or None, ``carry`` the flat (B, H/2, W/2, cout) storage or
    None; -> (P, cout), NaN where no thread stores."""
    P, bm, bn, coutp = b * h * w, 64 * mt, pfc.K1X1_SLICE, packed.shape[1]
    steps = [(s, kc) for s, x in enumerate(sources) for kc in range(math.ceil(x.shape[1] / 64))]
    assert len(steps) == packed.shape[0] and math.ceil(cout / bn) * bn <= coutp
    col = 8 * (torch.arange(64) // 8)[None, :] ^ 8 * (torch.arange(bn) % 8)[:, None]
    col = col + torch.arange(64)[None, :] % 8  # stored column of logical (n, k) in a swizzled tile
    out = torch.full((P, cout), float("nan"), dtype=torch.float64)
    for tile in range(math.ceil(P / bm)):
        q = tile * bm + torch.arange(bm)
        for n0 in range(0, math.ceil(cout / bn) * bn, bn):
            acc = torch.zeros(bm, bn, dtype=torch.float64)
            for i, (s, kc) in enumerate(steps):
                x = sources[s]  # the tensor copy: 64 channels x bm rows at (64 kc, p0), zeros past P and C_s
                k = 64 * kc + torch.arange(64)
                inside = (q < P)[:, None] & (k < x.shape[1])[None, :]
                a = torch.where(inside, x[q.clamp(max=P - 1)][:, k.clamp(max=x.shape[1] - 1)], torch.zeros(()))
                acc += a @ torch.gather(packed[i, n0: n0 + bn].double(), 1, col).T
            n = n0 + torch.arange(bn)
            keep_q, keep_n = q < P, n < cout
            v = acc[keep_q][:, keep_n] + bias[n[keep_n]]
            qq, nn = q[keep_q][:, None], n[keep_n][None, :]
            if resid is not None:
                v = v + resid.reshape(-1)[qq * cout + nn]
            if carry is not None:  # the epilogue's index: b = q / (H W), then y, x, and (y / 2, x / 2)
                bi, rem = qq // (h * w), qq % (h * w)
                y, xx = rem // w, rem % w
                v = v + carry[((bi * (h // 2) + y // 2) * (w // 2) + xx // 2) * cout + nn]
            out[q[keep_q][:, None], nn] = torch.relu(v) if relu else v
    return out


@pytest.mark.parametrize("b,h,w,channels,cout,mt,mode", [
    (1, 5, 7, [80, 80, 16, 48, 80], 80, 2, "resid"),       # ragged chunks and tile, a slice past cout
    (2, 6, 7, [16] * 7, 16, 1, "relu"),                   # seven sources, two tiles, the last ragged
    (2, 6, 10, [48], 256, 1, "carry"),                    # K8's lateral: a half-empty chunk, the carry
    (3, 4, 4, [64], 128, 2, "carry"),                     # tiles that span images
    (1, 2, 142, [128, 128, 64, 128], 128, 2, "relu"),     # K5's two-block root sources
])
def test_conv1x1_indexing_emulated(b, h, w, channels, cout, mt, mode):
    srcs = [_bf16_exact(b, h, w, c, seed=10 + i) for i, c in enumerate(channels)]
    wt, bias = _bf16_exact(cout, sum(channels), 1, 1, seed=3, k=0.1), _bf16_exact(cout, seed=4)
    resid = _bf16_exact(b, h, w, cout, seed=5) if mode == "resid" else None
    carry = _bf16_exact(b, h // 2, w // 2, cout, seed=6) if mode == "carry" else None
    packed = pfc.pack_conv1x1(wt, channels)
    flat = lambda t: t.reshape(b * h * w, -1)  # noqa: E731
    got = _emulate_conv1x1([flat(x) for x in srcs], packed, bias, None if resid is None else flat(resid),
                           None if carry is None else carry.reshape(-1), b, h, w, cout, mt, mode != "carry")
    ref = F.conv2d(torch.cat(srcs, dim=3).permute(0, 3, 1, 2), wt, bias).permute(0, 2, 3, 1)
    if resid is not None:
        ref = ref + resid
    if carry is not None:
        ref = ref + carry.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    else:
        ref = torch.relu(ref)
    torch.testing.assert_close(got, flat(ref), atol=1e-9, rtol=0)


# K5's and K8's 1x1 launches in the bs8 512x672 DLA34 forward: (h, w, sources, cout)
DLA34_1X1 = [(128, 168, (64, 64), 64), (64, 84, (128, 128), 128), (64, 84, (128, 128, 64, 128), 128),
             (32, 42, (256, 256), 256), (32, 42, (256, 256, 128, 256), 256), (16, 21, (512, 512, 256), 512),
             (32, 42, (256,), 256), (64, 84, (128,), 256), (128, 168, (64,), 256)]


# the warpgroups a block picked at 132 SMs, in DLA34_1X1's order
PICKS_AT_132 = [1, 2, 2, 2, 2, 1, 2, 1, 1]


def test_conv1x1_tile_at_132():
    assert [pfc.conv1x1_tile(8, h, w, src, cout, sms=H100_SMS) for h, w, src, cout in DLA34_1X1] == PICKS_AT_132


@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_conv1x1_tile_fits_and_stays_inside_the_packed_rows(sms):
    for h, w, sources, cout in DLA34_1X1:
        mt = pfc.conv1x1_tile(8, h, w, sources, cout, sms=sms)
        assert mt in pfc.K1X1_WARPGROUPS
        bn = pfc.K1X1_SLICE
        assert math.ceil(cout / bn) * bn <= math.ceil(cout / 128) * 128  # the slices read packed rows only
        nk = sum(math.ceil(c / 64) for c in sources)
        assert pfc._k1x1_smem(mt, nk) <= 232448
    assert pfc.conv1x1_tile(1, 3, 5, (16,), 16, sms=sms) in (1, 2)
    with pytest.raises(TypeError):
        pfc.conv1x1_tile(8, 32, 42, (256,), 256)  # the count has no default


# ---------------- K6's and K7's packed weights and the stride-2 indexing ------


def _emulate_conv3x3s2(x, packed, bias, b, ho, wo, cin, c, bn, mt):
    """What ``conv3x3s2_wgmma<bn, mt>`` computes, step by step in float64: x
    (B, 2 ho, 2 wo, cin), ``packed`` from ``pack_conv3x3`` of a (c, cin, 3, 3)
    kernel; -> (t (B ho wo, c) after bias and relu, before rounding, and the
    residual's source as the first slice's blocks write it, max-pooled and
    subsampled, (B ho wo, cin) each), NaN where no thread stores."""
    R, th, tw, bm = b * ho, 8 * mt, pfc.S2_TW, 64 * mt
    nk, coutp = packed.shape[0], packed.shape[2]
    rows = -(-(th + 1) * (tw + 1) // 8) * 8  # a plane's stage: whole 1024-byte units, so the swizzle's row is q % 8
    assert rows * 128 % 1024 == 0 and math.ceil(c / bn) * bn <= coutp
    # the 5-D tensor map's view (R, 2, wo, 2, cin) as the four parity planes, zeros past cin
    planes = torch.zeros(2, 2, R, wo, nk * 64, dtype=torch.float64)
    planes[..., :cin] = x.reshape(R, 2, wo, 2, cin).permute(1, 3, 0, 2, 4)
    col = 8 * (torch.arange(64) // 8)[None, :] ^ 8 * (torch.arange(bn) % 8)[:, None]
    col = col + torch.arange(64)[None, :] % 8  # stored column of logical (n, k) in a swizzled tile
    out = torch.full((R * wo, c), float("nan"), dtype=torch.float64)
    pooled = {mode: torch.full((R * wo, cin), float("nan"), dtype=torch.float64) for mode in (1, 0)}
    i = torch.arange(bm)
    ry, rx = i // tw, i % tw
    base = (ry + 1) * (tw + 1) + rx + 1  # box row of the lane's own position
    for r0 in range(0, R, th):
        for xo0 in range(0, wo, tw):
            r, xo = r0 + ry, xo0 + rx
            valid = (r < R) & (xo < wo)
            q_out = (r * wo + xo)[valid]
            mask = torch.stack([valid & ((t // 3 != 0) | (r % ho > 0)) & ((t % 3 != 0) | (xo > 0)) for t in range(9)], 1)
            rr, cc = r0 - 1 + torch.arange(th + 1), xo0 - 1 + torch.arange(tw + 1)
            inside = ((rr >= 0) & (rr < R))[:, None, None] & ((cc >= 0) & (cc < wo))[None, :, None]
            for n0 in range(0, math.ceil(c / bn) * bn, bn):
                acc = torch.zeros(bm, bn, dtype=torch.float64)
                for kc in range(nk):
                    box = torch.full((4, rows, 64), float("nan"), dtype=torch.float64)  # rows no copy writes: NaN
                    for s in range(4):  # plane (s // 2, s % 2), one tensor copy from (r0 - 1, xo0 - 1)
                        v = planes[s // 2, s % 2][rr.clamp(0, R - 1)][:, cc.clamp(0, wo - 1), 64 * kc: 64 * kc + 64]
                        box[s, : (th + 1) * (tw + 1)] = torch.where(inside, v, torch.zeros(())).reshape(-1, 64)
                    if n0 == 0:
                        k = 64 * kc + torch.arange(64)
                        keep = k < cin
                        pooled[0][q_out[:, None], k[keep][None, :]] = box[0, base][valid][:, keep]
                        pooled[1][q_out[:, None], k[keep][None, :]] = box[:, base].amax(0)[valid][:, keep]
                    for t in range(9):
                        dy, dx = t // 3, t % 3
                        q = base - int(dy == 0) * (tw + 1) - int(dx == 0)
                        a = torch.where(mask[:, t, None], box[int(dy != 1) * 2 + int(dx != 1), q], torch.zeros(()))
                        acc += a @ torch.gather(packed[kc, t, n0: n0 + bn].double(), 1, col).T
                n = n0 + torch.arange(bn)
                keep_n = n < c
                out[q_out[:, None], n[keep_n][None, :]] = torch.relu(acc[valid][:, keep_n] + bias[n[keep_n]])
    return out, pooled[1], pooled[0]


@pytest.mark.parametrize("b,ho,wo,cin,c,bn,mt", [
    (2, 3, 5, 32, 64, 64, 1),     # DLA34's first head: half a k-chunk; odd Wo; a tile over both images
    (1, 9, 21, 64, 128, 128, 2),  # Wo = 21 (two column tiles, the last ragged); rows past B Ho
    (2, 5, 11, 128, 256, 64, 2),  # two k-chunks, four slices; the second image's row -1 masked mid-tile
    (1, 3, 9, 256, 512, 128, 1),  # four k-chunks, four slices of 128
])
def test_conv3x3s2_indexing_emulated(b, ho, wo, cin, c, bn, mt):
    """The stride-2 3x3 at DLA34's and ResNet34's channel counts (Cin, C)."""
    gen = torch.Generator().manual_seed(cin + wo)
    rnd = lambda *s, k=1.0: (k * torch.randn(*s, generator=gen)).to(torch.bfloat16).double()  # noqa: E731
    x, wt, bias = rnd(b, 2 * ho, 2 * wo, cin), rnd(c, cin, 3, 3, k=0.1), rnd(c)
    t, pooled, sub = _emulate_conv3x3s2(x, pfc.pack_conv3x3(wt), bias, b, ho, wo, cin, c, bn, mt)
    xc = x.permute(0, 3, 1, 2)
    flat = lambda y: y.permute(0, 2, 3, 1).reshape(b * ho * wo, -1)  # noqa: E731
    torch.testing.assert_close(t, flat(torch.relu(F.conv2d(xc, wt, bias, stride=2, padding=1))), atol=1e-9, rtol=0)
    torch.testing.assert_close(pooled, flat(F.max_pool2d(xc, 2)), atol=0, rtol=0)
    torch.testing.assert_close(sub, flat(xc[:, :, ::2, ::2]), atol=0, rtol=0)


# K6's launches: DLA34's four (pooled) and ResNet34's three (subsampled) at bs8 512x672, (ho, wo, cin, c)
K6_LAUNCHES = [(128, 168, 32, 64), (64, 84, 64, 128), (32, 42, 128, 256), (16, 21, 256, 512),
               (64, 84, 64, 128), (32, 42, 128, 256), (16, 21, 256, 512)]


# the stride-2 block shapes picked at 132 SMs, in K6_LAUNCHES's order: the
# fastest of the four at each launch (chip_smoke.py phase_k6_k7(shapes=True))
K6_PICKS_AT_132 = [(64, 1), (128, 1), (128, 2), (128, 2), (128, 1), (128, 2), (128, 2)]


def test_block_down_tile_at_132():
    assert [pfc.block_down_tile(8, *launch, sms=H100_SMS) for launch in K6_LAUNCHES] == K6_PICKS_AT_132


@pytest.mark.parametrize("sms", [H100_SMS, 114])
def test_block_down_tile_fits(sms):
    for ho, wo, cin, c in K6_LAUNCHES:
        bn, mt = pfc.block_down_tile(8, ho, wo, cin, c, sms=sms)
        assert (bn, mt) in pfc.K6_SHAPES and pfc._k6_smem(bn, mt, cin) <= 232448
    assert pfc.block_down_tile(1, 1, 1, 16, 16, sms=sms) in pfc.K6_SHAPES
    with pytest.raises(TypeError):
        pfc.block_down_tile(8, 16, 21, 256, 512)  # the count has no default


@pytest.mark.parametrize("cin,c,proj", [(32, 64, True), (128, 256, True), (80, 80, False)])
def test_pack_block_down_gives_back_the_folded_weights(cin, c, proj):
    w1, w2 = _bf16_exact(c, cin, 3, 3, seed=1, k=0.1).float(), _bf16_exact(c, c, 3, 3, seed=2, k=0.1).float()
    wp = _bf16_exact(c, cin, 1, 1, seed=3).float() if proj else None
    b1, b2, bp = torch.randn(c), torch.randn(c), torch.randn(c) if proj else None
    packed = pfc.pack_block_down(w1, b1, w2, b2, wp, bp, torch.bfloat16)
    assert (packed.cin, packed.c) == (cin, c) and packed.w1.shape == (math.ceil(cin / 64), 9, math.ceil(c / 128) * 128, 64)
    assert torch.equal(pfc.unpack_conv3x3(packed.w1, c, cin), w1.to(torch.bfloat16))
    assert torch.equal(pfc.unpack_conv3x3(packed.w2, c, c), w2.to(torch.bfloat16))
    assert not pfc.unpack_conv3x3(packed.w1, c, math.ceil(cin / 64) * 64)[:, cin:].any()  # zeros past cin
    assert torch.equal(packed.b1, b1) and packed.b1.data_ptr() != b1.data_ptr()  # fresh, aligned storage
    if proj:
        assert torch.equal(pfc.unpack_conv1x1(packed.wp, c, [cin]), wp.to(torch.bfloat16)) and torch.equal(packed.bp, bp)
    else:
        assert packed.wp is None and packed.bp is None
    f32 = pfc.pack_block_down(w1, b1, w2, b2, wp, bp, torch.float32)
    assert f32.w1.shape == (3, 3, cin, c) and torch.equal(f32.w1, w1.permute(2, 3, 1, 0))
    assert not proj or torch.equal(f32.wp[0, 0], wp[:, :, 0, 0].T)
    with pytest.raises(ValueError, match="keep its channel count"):
        pfc.pack_block_down(w1, b1, w2, b2, None, None, torch.bfloat16) if cin != c else pfc.pack_block_down(
            w1[:, :16], b1, w2, b2, None, None, torch.bfloat16)


def test_pack_conv_relu_head_gives_back_the_weights():
    c, nout = 256, 15
    wc, wh = _bf16_exact(c, c, 3, 3, seed=4, k=0.1).float(), _bf16_exact(nout, c, 1, 1, seed=5).float()
    bc, bh = torch.randn(c), torch.randn(nout)
    packed = pfc.pack_conv_relu_head(wc, bc, wh, bh, torch.bfloat16)
    assert (packed.c, packed.cm, packed.nout) == (c, c, nout) and packed.wh.shape == (4, 128, 64)
    assert torch.equal(pfc.unpack_conv3x3(packed.wc, c, c), wc.to(torch.bfloat16))
    assert torch.equal(pfc.unpack_conv1x1(packed.wh, nout, [c]), wh.to(torch.bfloat16))
    assert not packed.wh[:, nout:].any()  # the 64-channel slice reads zeros past the 15 predictors
    assert packed.bh.shape == (16,) and torch.equal(packed.bh[:nout], bh) and packed.bh[nout] == 0  # 16-byte loads
    f32 = pfc.pack_conv_relu_head(wc, bc, wh, bh, torch.float32)
    assert f32.wc.shape == (3, 3, c, c) and f32.wh.shape == (1, 1, c, 16) and f32.bh.shape == (16,)
    assert torch.equal(f32.wh[0, 0, :, :nout], wh[:, :, 0, 0].T) and not f32.wh[..., nout:].any()
    with pytest.raises(ValueError, match="keep the channel count"):
        pfc.pack_conv_relu_head(wc[:, :128], bc, wh, bh, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_packed_weights_give_the_public_calls(dtype):
    """What the packed calls compute on the card, from what they are given:
    the weights unpacked from ``pack_block_down`` and ``pack_conv_relu_head``
    through the plain versions equal the public calls on the CPU."""
    x, w1, b1, w2_, b2, wp, bp = _block_down_case(2, 8, 10, 32, 64, True)
    args = [_t(x), *(a.to(dtype) for a in (_w(w1), torch.from_numpy(b1), _w(w2_), torch.from_numpy(b2), _w(wp),
                                            torch.from_numpy(bp)))]
    args[0] = args[0].to(dtype)
    pk = pfc.pack_block_down(*args[1:], dtype)
    if dtype == torch.bfloat16:
        unpacked = (pfc.unpack_conv3x3(pk.w1, 64, 32), pk.b1, pfc.unpack_conv3x3(pk.w2, 64, 64), pk.b2,
                    pfc.unpack_conv1x1(pk.wp, 64, [32]), pk.bp)
    else:
        unpacked = (pk.w1.permute(3, 2, 0, 1), pk.b1, pk.w2.permute(3, 2, 0, 1), pk.b2, pk.wp.permute(3, 2, 0, 1), pk.bp)
    for pool in (True, False):
        assert torch.equal(pfc.block_down_reference(args[0], *unpacked, pool_residual=pool),
                           pfc.fused_block_down(*args, pool_residual=pool))
    x, wc, bc, wh, bh = _head_case()
    hargs = [_t(x).to(dtype), _w(wc).to(dtype), torch.from_numpy(bc), _w(wh).to(dtype), torch.from_numpy(bh)]
    pk = pfc.pack_conv_relu_head(*hargs[1:], dtype)
    if dtype == torch.bfloat16:
        unpacked = (pfc.unpack_conv3x3(pk.wc, 32, 32), pk.bc, pfc.unpack_conv1x1(pk.wh, 15, [32]), pk.bh[:15])
    else:
        unpacked = (pk.wc.permute(3, 2, 0, 1), pk.bc, pk.wh.permute(3, 2, 0, 1)[:15], pk.bh[:15])
    assert torch.equal(pfc.conv_relu_head_reference(hargs[0], *unpacked), pfc.fused_conv_relu_head(*hargs))


# ---------------- on the card ----------------------------------------------

_DTYPES = [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)]


def _on_card(fused, plain, args, kw, dtype, tol, key):
    """Run a wrapper and its plain version on CUDA copies of ``args``."""
    if not torch.cuda.is_available():
        pytest.skip("the fused conv kernels need a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def move(a):
        if isinstance(a, torch.Tensor):
            # activations and conv weights (4-D) at the storage dtype, biases f32
            return a.to(dev, dtype).contiguous(memory_format=torch.channels_last) if a.dim() == 4 else a.to(dev)
        if isinstance(a, (list, tuple)):
            return type(a)(move(v) for v in a)
        return a

    args = move(args)
    before = pfc.LAUNCHES[key]
    out = fused(*args, **kw)
    torch.cuda.synchronize()
    assert pfc.LAUNCHES[key] == before + 1
    ref = plain(*args, **kw)
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    for o, r in zip(outs, refs):
        assert o.shape == r.shape and o.dtype == dtype
        scale = r.float().abs().amax().clamp(min=1.0)
        assert ((o.float() - r.float()).abs().amax() / scale).item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _DTYPES)
@pytest.mark.parametrize(
    "two_blocks,n_children,incl,rres,h,w",
    [(False, 0, False, False, 16, 12), (False, 1, False, True, 17, 13), (True, 1, True, False, 16, 12),
     (True, 2, False, True, 19, 21)],
)
def test_tree_tail_kernel_on_card(two_blocks, n_children, incl, rres, h, w, dtype, tol):
    x, children, bb_a, bb_b, wr, br = _tree_tail_case(two_blocks, n_children, incl, c=32, child_c=16, h=h, w=w)
    args = (_t(x), [_t(c) for c in children], None if bb_a is None else _bb_torch(bb_a), _bb_torch(bb_b),
            _w(wr), torch.from_numpy(br))
    kw = dict(two_blocks=two_blocks, include_input_child=incl, root_residual=rres)
    _on_card(pfc.fused_tree_tail, pfc.tree_tail_reference, args, kw, dtype, tol, "tree_tail")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _DTYPES)
@pytest.mark.parametrize(
    "h2,w2,cin,cout,proj,pool",
    [(16, 24, 16, 32, True, True), (34, 22, 16, 32, True, True), (16, 24, 16, 16, False, True),
     (18, 26, 16, 48, True, False), (18, 26, 32, 32, False, False)],
)
def test_block_down_kernel_on_card(h2, w2, cin, cout, proj, pool, dtype, tol):
    x, w1, b1, w2_, b2, wp, bp = _block_down_case(2, h2, w2, cin, cout, proj)
    args = (_t(x), _w(w1), torch.from_numpy(b1), _w(w2_), torch.from_numpy(b2),
            None if wp is None else _w(wp), None if bp is None else torch.from_numpy(bp))
    _on_card(pfc.fused_block_down, pfc.block_down_reference, args, dict(pool_residual=pool), dtype, tol, "block_down")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _DTYPES)
@pytest.mark.parametrize("emit_cur,h,w", [(True, 16, 12), (False, 16, 12), (True, 18, 34)])
def test_fpn_level_kernel_on_card(emit_cur, h, w, dtype, tol):
    f, prev, wl, bl, wo, bo = _fpn_case(h=h, w=w, cl=16, c=32)
    args = (_t(f), _t(prev), _w(wl), torch.from_numpy(bl), _w(wo), torch.from_numpy(bo))

    def plain(*a, emit_cur):
        out, cur = pfc.fpn_level_reference(*a)
        return (out, cur) if emit_cur else out

    _on_card(pfc.fused_fpn_level, plain, args, dict(emit_cur=emit_cur), dtype, tol, "fpn_level")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _DTYPES)
@pytest.mark.parametrize("h,w", [(16, 11), (5, 19)])
def test_conv_relu_head_kernel_on_card(h, w, dtype, tol):
    x, wc, bc, wh, bh = _head_case(h=h, w=w)
    args = (_t(x), _w(wc), torch.from_numpy(bc), _w(wh), torch.from_numpy(bh))
    _on_card(pfc.fused_conv_relu_head, pfc.conv_relu_head_reference, args, {}, dtype, tol, "conv_relu_head")


def _packed_tail_case(c, children, incl, two_blocks, b=2, h=5, w=7):
    x, kids, bb_a, bb_b, wr, br = _tree_tail_case(two_blocks, len(children), incl, c=c, b=b, h=h, w=w)
    rng = np.random.RandomState(3)
    kids = [(rng.randn(b, h, w, k) * 0.5).astype(np.float32) for k in children]
    wr = (rng.randn(2 * c + sum(children) + (c if incl else 0), c) * 0.05).astype(np.float32)
    return (_t(x), [_t(k) for k in kids], None if bb_a is None else _bb_torch(bb_a), _bb_torch(bb_b), _w(wr),
            torch.from_numpy(br))


def _card(args, dtype):
    dev = torch.device("cuda")
    if isinstance(args, torch.Tensor):
        return args.to(dev, dtype).contiguous(memory_format=torch.channels_last) if args.dim() == 4 else args.to(dev)
    return None if args is None else type(args)(_card(a, dtype) for a in args)


def _close_on_card(got, ref, tol):
    for o, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        assert o.shape == r.shape and o.dtype == r.dtype
        scale = r.float().abs().amax().clamp(min=1.0)
        assert ((o.float() - r.float()).abs().amax() / scale).item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("tile1", [1, 2])
def test_tree_tail_packed_every_1x1_block_shape_on_card(tile1):
    """C = 256, two blocks, a child and x, 70 positions (a ragged tile)."""
    if not torch.cuda.is_available():
        pytest.skip("the fused conv kernels need a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    x, kids, bb_a, bb_b, wr, br = _card(_packed_tail_case(256, (128,), True, True), torch.bfloat16)
    packed = pfc.pack_tree_tail(bb_a, bb_b, wr, br, torch.bfloat16, children=[128], two_blocks=True,
                                include_input_child=True)
    kw = dict(two_blocks=True, include_input_child=True)
    for rres in (False, True):
        with torch.no_grad():
            got = pfc.fused_tree_tail_packed(x, kids, packed, root_residual=rres,
                                             tiles=(pfc.basic_block_tile(2, 5, 7, 256, sms=H100_SMS), tile1))
            torch.cuda.synchronize()
            ref = pfc.tree_tail_reference(x, kids, bb_a, bb_b, wr, br, root_residual=rres, **kw)
        _close_on_card(got, ref, 2.0 ** -6)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", _DTYPES)
def test_tree_tail_packed_seven_sources_on_card(dtype, tol):
    """C = 80 (a ragged k-chunk in every convolution), four children of 16 and 48 channels and x: seven root sources."""
    if not torch.cuda.is_available():
        pytest.skip("the fused conv kernels need a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    x, kids, bb_a, bb_b, wr, br = _card(_packed_tail_case(80, (16, 48, 16, 48), True, True, h=9, w=11), dtype)
    packed = pfc.pack_tree_tail(bb_a, bb_b, wr, br, dtype, children=[16, 48, 16, 48], two_blocks=True,
                                include_input_child=True)
    before = pfc.LAUNCHES["tree_tail"]
    with torch.no_grad():
        got = pfc.fused_tree_tail_packed(x, kids, packed)
        torch.cuda.synchronize()
        ref = pfc.tree_tail_reference(x, kids, bb_a, bb_b, wr, br, two_blocks=True, include_input_child=True)
    assert pfc.LAUNCHES["tree_tail"] == before + 1
    _close_on_card(got, ref, tol)


@pytest.mark.gpu
@pytest.mark.parametrize("tile1", [1, 2])
def test_fpn_level_packed_every_1x1_block_shape_on_card(tile1):
    """Cl = 48 (a half-empty k-chunk), C = 256, a 6x10 map (ragged tiles), cur emitted and not."""
    if not torch.cuda.is_available():
        pytest.skip("the fused conv kernels need a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    f, prev, wl, bl, wo, bo = _fpn_case(h=6, w=10, cl=48, c=256)
    f, prev, wl, bl, wo, bo = _card((_t(f), _t(prev), _w(wl), torch.from_numpy(bl), _w(wo), torch.from_numpy(bo)),
                                    torch.bfloat16)
    packed = pfc.pack_fpn_level(wl, bl, wo, bo, torch.bfloat16)
    for emit in (True, False):
        with torch.no_grad():
            got = pfc.fused_fpn_level_packed(f, prev, packed, emit_cur=emit,
                                             tiles=(tile1, pfc.basic_block_tile(2, 6, 10, 256, sms=H100_SMS)))
            torch.cuda.synchronize()
            ref = pfc.fpn_level_reference(f, prev, wl, bl, wo, bo)
        _close_on_card(got, ref if emit else ref[0], 2.0 ** -6)


@pytest.mark.gpu
@pytest.mark.parametrize("tile1", pfc.K6_SHAPES)
@pytest.mark.parametrize("cin,cout,h2,w2", [(32, 64, 18, 42), (128, 256, 10, 42)])
def test_block_down_packed_every_block_shape_on_card(tile1, cin, cout, h2, w2):
    """The stride-2 3x3 at each of its block shapes: Cin = 32 (half a k-chunk)
    and 128 (two chunks, two plane stages), Wo = 21 (a ragged column tile), Ho
    = 9 and 5 over two images (tiles that span them, and the row above an
    image's first row masked); pooled and subsampled residuals, both 1x1
    block shapes."""
    if not torch.cuda.is_available():
        pytest.skip("the fused conv kernels need a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    case = _block_down_case(2, h2, w2, cin, cout, True)
    x, w1, b1, w2_, b2, wp, bp = _card((_t(case[0]), _w(case[1]), torch.from_numpy(case[2]), _w(case[3]),
                                        torch.from_numpy(case[4]), _w(case[5]), torch.from_numpy(case[6])),
                                       torch.bfloat16)
    packed = pfc.pack_block_down(w1, b1, w2_, b2, wp, bp, torch.bfloat16)
    for pool, tilep in ((True, 1), (False, 2)):
        tiles = (tile1, tilep, pfc.basic_block_tile(2, h2 // 2, w2 // 2, cout, sms=H100_SMS))
        with torch.no_grad():
            got = pfc.fused_block_down_packed(x, packed, pool_residual=pool, tiles=tiles)
            torch.cuda.synchronize()
            ref = pfc.block_down_reference(x, w1, b1, w2_, b2, wp, bp, pool_residual=pool)
        _close_on_card(got, ref, 2.0 ** -6)


@pytest.mark.gpu
@pytest.mark.parametrize("tile1", [1, 2])
def test_conv_relu_head_packed_every_1x1_block_shape_on_card(tile1):
    """C = 256 at the p6 level's 8x11 with 15 predictors (a ragged row of the
    1x1's outputs), both 1x1 block shapes and the 3x3's every shape."""
    if not torch.cuda.is_available():
        pytest.skip("the fused conv kernels need a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    x, wc, bc, wh, bh = _head_case(h=8, w=11, c=256)
    x, wc, bc, wh, bh = _card((_t(x), _w(wc), torch.from_numpy(bc), _w(wh), torch.from_numpy(bh)), torch.bfloat16)
    packed = pfc.pack_conv_relu_head(wc, bc, wh, bh, torch.bfloat16)
    for tile3 in pfc.K4_SHAPES:
        with torch.no_grad():
            got = pfc.fused_conv_relu_head_packed(x, packed, tiles=(tile3, tile1))
            torch.cuda.synchronize()
            ref = pfc.conv_relu_head_reference(x, wc, bc, wh, bh)
        assert got.is_contiguous(memory_format=torch.channels_last)
        _close_on_card(got, ref, 2.0 ** -6)
