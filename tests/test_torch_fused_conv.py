"""The port's four fused-forward functions (``threedod_torch/ops/fused_conv.py``,
kernels K5 to K8) vs ``threedod/ops/fused_conv.py``, f32 on the CPU.

The same numpy-seeded inputs go through three things: the JAX package's XLA
reference, its Pallas kernel in interpret mode, and the port's plain version
(which is what the port's wrapper runs for a CPU tensor). The port takes NCHW
tensors and ``nn.Conv2d``-layout weights, the JAX package NHWC and HWIO; the
tests transpose. All three agree to atol 1e-4 (sums of a few hundred f32
terms in another order). Shapes and variants are those of
``tests/test_fused_conv.py``.

On a CUDA card only (marked ``gpu``): each kernel vs its plain version at
small shapes with channel counts the kernels take (multiples of 16), over the
variants the serving path does not reach (root residual, no projection,
subsampled residual, ragged tiles), f32 to 1e-4 and bf16 to 2^-6 of the
largest entry.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

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
