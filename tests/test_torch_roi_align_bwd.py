"""The port's multilevel ROIAlign backward (plain version and kernel K2) vs
autograd and vs JAX.

The plain backward ``roi_align_backward`` is written out step by step (taps,
weights, ``index_add_``). It is held against
* autograd through the plain forward, f32, to 1e-6 of the largest entry (the
  same products, summed in another order);
* ``jax.grad`` of ``multilevel_roi_align_windowed(window=WINDOW_Y)``, the
  function the JAX package pools with on the CPU, to 1e-5 (separable matmuls
  there, direct taps here);
* the Pallas TPU backward kernel itself, run through the Pallas interpreter
  as tests/test_ops.py runs it, at C=128, to 1e-5;
and, on a CUDA card only (marked ``gpu``), kernel K2 against the plain
backward: f32 to 1e-5 of the largest entry (f32 atomics add in an order that
changes from run to run), bf16 to one rounding of the bf16 result, on the
cases of ``_torch_port.roi_card_case``; a channel count K2 refuses raises.

ROIs overlap heavily (several copies of one box), sit on a level boundary
(area 112^2, where the assignment steps from p2 to p3), leave the image, and
leave p5 and p6 untouched: their gradients must come back as exact zeros.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port  # one torch thread per worker; the card cases

import jax
import jax.numpy as jnp

from threedod.ops.roi_align import multilevel_roi_align_windowed
from threedod.ops.roi_align_pallas import WINDOW_Y

from threedod_torch.ops import roi_align_cuda
from threedod_torch.ops.roi_align import STRIDES, assign_levels, multilevel_roi_align, roi_align_backward

NAMES = ["p2", "p3", "p4", "p5", "p6"]


def _feats(c, b=2, h=128, w=168, seed=0):
    rng = np.random.RandomState(seed)
    return {nm: rng.randn(b, -(-h // s), -(-w // s), c).astype(np.float32)
            for nm, s in zip(NAMES, (4, 8, 16, 32, 64))}


def _boxes(b=2, n=24, h=128, w=168, seed=1):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-10, w - 20, (b, n))
    y1 = rng.uniform(-10, h - 20, (b, n))
    bw = np.exp(rng.uniform(np.log(4), np.log(200), (b, n)))
    bh = np.exp(rng.uniform(np.log(4), np.log(150), (b, n)))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    boxes[:, :9] = [
        [20, 20, 60, 52], [20, 20, 60, 52], [21, 19, 61, 53], [20, 20, 60, 52],  # overlapping copies
        [10, 10, 121.9, 121.9],  # just under the p2/p3 boundary (sqrt(area) = 111.9)
        [10, 10, 122.1, 122.1],  # just over it
        [-6, -4, 30, 24],  # leaves the image
        [w - 9, h - 7, w + 3, h + 2],  # samples in the [-1, dim] band
        [-100, -80, 230, 220],  # larger than the image: p4
    ]
    return boxes.astype(np.float32)


def _cot(boxes, c, seed=2):
    return np.random.RandomState(seed).randn(*boxes.shape[:2], 7, 7, c).astype(np.float32)


def _plain_backward(feats, boxes, cot):
    tboxes = torch.from_numpy(boxes)
    level = assign_levels(tboxes.reshape(-1, 4), NAMES).reshape(boxes.shape[:2])
    shapes = [feats[nm].shape[1:3] for nm in NAMES]
    out = roi_align_backward(torch.from_numpy(cot), tboxes, level, shapes,
                             [1.0 / STRIDES[nm] for nm in NAMES], 2, torch.float32)
    return {nm: g.numpy() for nm, g in zip(NAMES, out)}, level


def _close(got, ref, tol):
    scale = max(np.abs(ref).max(), 1.0)
    return np.abs(got - ref).max() / scale <= tol


def test_levels_cover_the_cases():
    _, level = _plain_backward(_feats(8), _boxes(), _cot(_boxes(), 8))
    assert level[0, 4] == 0 and level[0, 5] == 1  # the boundary pair splits p2 / p3
    assert set(level.flatten().tolist()) == {0, 1, 2}  # p5 and p6 untouched


def test_plain_backward_matches_autograd():
    feats, boxes = _feats(16), _boxes()
    cot = _cot(boxes, 16)
    tfeats = {k: torch.from_numpy(v).permute(0, 3, 1, 2).requires_grad_() for k, v in feats.items()}
    # the plain forward alone, outside the autograd.Function, so that autograd differentiates it
    (multilevel_roi_align(tfeats, torch.from_numpy(boxes)) * torch.from_numpy(cot)).sum().backward()
    got, _ = _plain_backward(feats, boxes, cot)
    for nm in NAMES:
        ref = tfeats[nm].grad
        ref = np.zeros_like(got[nm]) if ref is None else ref.permute(0, 2, 3, 1).numpy()
        assert _close(got[nm], ref, 1e-6), nm
    assert not got["p5"].any() and not got["p6"].any()
    assert np.abs(got["p2"]).max() > 1.0


def test_wrapper_backward_is_the_plain_backward_on_cpu():
    """On CPU tensors the autograd.Function of the ROI heads' pooler runs the
    plain backward and launches nothing."""
    feats, boxes = _feats(8), _boxes()
    cot = _cot(boxes, 8)
    tfeats = {k: torch.from_numpy(v).permute(0, 3, 1, 2).requires_grad_() for k, v in feats.items()}
    before = roi_align_cuda.BACKWARD_LAUNCHES
    out = roi_align_cuda.multilevel_roi_align(tfeats, torch.from_numpy(boxes))
    # a non-contiguous cotangent, as the heads' slice of the pooled block gives
    wide = torch.from_numpy(np.concatenate([cot, cot], axis=-1))[..., ::2]
    assert not wide.is_contiguous()
    out.backward(wide)
    assert roi_align_cuda.BACKWARD_LAUNCHES == before
    want, _ = _plain_backward(feats, boxes, wide.contiguous().numpy())
    for nm in NAMES:
        np.testing.assert_array_equal(tfeats[nm].grad.permute(0, 2, 3, 1).numpy(), want[nm])


@pytest.mark.parametrize("c", [8, 32])
def test_plain_backward_matches_jax_grad(c):
    feats, boxes = _feats(c), _boxes()
    cot = _cot(boxes, c)

    def pooled_sum(f):
        return sum(
            jnp.sum(multilevel_roi_align_windowed(
                {k: v[i] for k, v in f.items()}, jnp.asarray(boxes[i]),
                output_size=7, sampling_ratio=2, window=WINDOW_Y) * cot[i])
            for i in range(boxes.shape[0]))

    ref = jax.jit(jax.grad(pooled_sum))({k: jnp.asarray(v) for k, v in feats.items()})
    got, _ = _plain_backward(feats, boxes, cot)
    for nm in NAMES:
        assert _close(got[nm], np.asarray(ref[nm]), 1e-5), nm


@pytest.fixture
def interp(monkeypatch):
    from threedod.ops import roi_align_pallas as rap

    monkeypatch.setattr(rap, "FORCE_INTERPRET", True)
    return rap


def test_plain_backward_matches_pallas_kernel_interpret(interp):
    feats = _feats(128, b=2, h=64, w=80, seed=3)
    boxes = _boxes(b=2, n=10, h=64, w=80, seed=4)
    cot = _cot(boxes, 128)
    ref = jax.jit(jax.grad(
        lambda f: jnp.sum(interp.multilevel_roi_align_tpu(f, jnp.asarray(boxes)) * cot)
    ))({k: jnp.asarray(v) for k, v in feats.items()})
    got, _ = _plain_backward(feats, boxes, cot)
    for nm in NAMES:
        assert _close(got[nm], np.asarray(ref[nm]), 1e-5), nm


@pytest.mark.gpu
@pytest.mark.parametrize("case", [*_torch_port.ROI_CARD_CASES, "refused_channels"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)])
def test_kernel_matches_plain_backward_on_card(dtype, tol, case):
    """K2 vs the plain backward on the card, through the autograd Function;
    ROIs wider than the window are scattered by the kernel's per-tap path. A
    channel count the kernels refuse raises."""
    if not torch.cuda.is_available():
        pytest.skip("the ROIAlign backward kernel needs a CUDA card")
    dev = torch.device("cuda")
    if case == "refused_channels":
        boxes = torch.zeros((1, 2, 4), device=dev)
        level = torch.zeros((1, 2), dtype=torch.int32, device=dev)
        with pytest.raises(ValueError, match="multiple of 4"):
            roi_align_cuda.roi_align_backward_cuda(torch.zeros((1, 2, 7, 7, 6), device=dev), boxes, level,
                                                   ["p2"], [(8, 8)], 2, dtype)
        return
    feats, boxes = _torch_port.roi_card_case(case)
    cot = _cot(boxes, feats["p2"].shape[-1])
    tfeats = {
        k: torch.from_numpy(v).permute(0, 3, 1, 2).to(dev, dtype)
        .contiguous(memory_format=torch.channels_last).requires_grad_()
        for k, v in feats.items()
    }
    before = roi_align_cuda.BACKWARD_LAUNCHES
    out = roi_align_cuda.multilevel_roi_align(tfeats, torch.from_numpy(boxes).to(dev))
    out.backward(torch.from_numpy(cot).to(dev, dtype))
    torch.cuda.synchronize()
    assert roi_align_cuda.BACKWARD_LAUNCHES == before + 1
    cot_seen = torch.from_numpy(cot).to(dtype).float().numpy()  # the cotangent as the kernel read it
    want, _ = _plain_backward(feats, boxes, cot_seen)
    for nm in NAMES:
        got = tfeats[nm].grad.permute(0, 2, 3, 1).float().cpu().numpy()
        assert got.dtype == np.float32 and tfeats[nm].grad.dtype == dtype
        assert _close(got, want[nm], tol), nm
