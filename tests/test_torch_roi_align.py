"""The port's multilevel ROIAlign (plain version and kernel K1) vs JAX.

* plain vs ``multilevel_roi_align_windowed(window=WINDOW_Y)``, the function
  the JAX package pools with on the CPU, over a batch in f32, to 1e-5 (the
  same taps and weights; only the summation order differs: direct taps here,
  separable matmuls there);
* plain vs the Pallas TPU kernel itself, run through the Pallas interpreter
  as tests/test_ops.py runs it, at C=128, to 1e-5;
* on a CUDA card only (marked ``gpu``): K1 vs the plain version, f32 to
  1e-5 and bf16 to one bf16 rounding of the output, on the cases of
  ``_torch_port.roi_card_case`` (ROIs wider than the window among them); a
  channel count K1 refuses raises; K1's own level assignment equals
  ``assign_levels`` on the card, on boxes placed on level boundaries.

Boxes cover both TPU window classes (<= 14 cells and larger), the image
edges, the [-1, dim] border band, boxes leaving the image, and elongated
ROIs that take the level bump.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port  # one torch thread per worker; the card cases

import jax

from threedod.ops.roi_align import multilevel_roi_align_windowed
from threedod.ops.roi_align_pallas import WINDOW_Y

from threedod_torch.ops import roi_align_cuda
from threedod_torch.ops.roi_align import WINDOW_Y as PORT_WINDOW_Y
from threedod_torch.ops.roi_align import assign_levels, multilevel_roi_align

NAMES = ["p2", "p3", "p4", "p5", "p6"]


def _feats(c, b=2, h=128, w=168, seed=0):
    rng = np.random.RandomState(seed)
    return {nm: rng.randn(b, -(-h // s), -(-w // s), c).astype(np.float32)
            for nm, s in zip(NAMES, (4, 8, 16, 32, 64))}


def _boxes(b=2, n=40, h=128, w=168, seed=1):
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-20, w, (b, n))
    y1 = rng.uniform(-20, h, (b, n))
    bw = np.exp(rng.uniform(np.log(2), np.log(400), (b, n)))
    bh = np.exp(rng.uniform(np.log(2), np.log(300), (b, n)))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    boxes[:, :7] = [
        [0, 0, 8, 8],  # top-left corner, small window class
        [w - 8, h - 8, w, h],  # bottom-right corner
        [-3, -2, w + 4, h + 3],  # leaves the image on every side
        [2, 30, w - 2, 46],  # elongated: extent > 30 cells at p2, bumped
        [40, 1, 52, h - 1],  # tall and thin, bumped
        [w - 1.5, h - 1.2, w + 0.5, h + 0.3],  # samples in the [-1, dim] band
        [-300, -250, w + 300, h + 250],  # coarsest levels
    ]
    return boxes.astype(np.float32)


def _port(feats_np, boxes_np):
    feats = {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats_np.items()}
    return multilevel_roi_align(feats, torch.from_numpy(boxes_np)).numpy()


def test_window_matches_jax():
    assert PORT_WINDOW_Y == WINDOW_Y


def test_level_bump_is_exercised():
    boxes = torch.from_numpy(_boxes().reshape(-1, 4))
    lvl = assign_levels(boxes, NAMES)
    area = ((boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])).clamp(min=1e-6)
    canonical = torch.floor(4 + torch.log2(area.sqrt() / 224 + 1e-8)).clamp(2, 6).long() - 2
    assert (lvl > canonical).sum() >= 2
    assert len(set(lvl.tolist())) >= 3


@pytest.mark.parametrize("c", [8, 32])
def test_plain_matches_windowed(c):
    feats, boxes = _feats(c), _boxes()
    pool = jax.jit(lambda f, b: multilevel_roi_align_windowed(f, b, output_size=7, sampling_ratio=2, window=WINDOW_Y))
    ref = np.stack([np.asarray(pool({k: v[i] for k, v in feats.items()}, boxes[i])) for i in range(boxes.shape[0])])
    out = _port(feats, boxes)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


@pytest.fixture
def interp(monkeypatch):
    from threedod.ops import roi_align_pallas as rap

    monkeypatch.setattr(rap, "FORCE_INTERPRET", True)
    return rap


def test_plain_matches_pallas_kernel_interpret(interp):
    feats = _feats(128, b=2, h=64, w=80, seed=3)
    boxes = _boxes(b=2, n=12, h=64, w=80, seed=4)
    ref = np.asarray(jax.jit(interp.multilevel_roi_align_tpu)(feats, boxes))
    np.testing.assert_allclose(_port(feats, boxes), ref, rtol=0, atol=1e-5)


def test_cpu_wrapper_takes_plain_version():
    feats, boxes = _feats(8), _boxes()
    tfeats = {k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()}
    before = roi_align_cuda.LAUNCHES
    out = roi_align_cuda.multilevel_roi_align(tfeats, torch.from_numpy(boxes))
    assert roi_align_cuda.LAUNCHES == before
    np.testing.assert_array_equal(out.numpy(), _port(feats, boxes))


def test_wrapper_refuses_other_devices():
    """No silent fallback: tensors neither all on the CPU nor all on CUDA raise."""
    feats = {nm: torch.empty((1, 8, 4, 4), device="meta") for nm in NAMES}
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        roi_align_cuda.multilevel_roi_align(feats, torch.zeros((1, 2, 4)))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [*_torch_port.ROI_CARD_CASES, "refused_channels"])
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2 ** -7)])
def test_kernel_matches_plain_on_card(dtype, atol, case):
    """K1 vs the plain version on the card; ROIs wider than the window are
    pooled by the kernel's per-tap path. A channel count that is not a
    whole number of 16-byte vectors raises."""
    if not torch.cuda.is_available():
        pytest.skip("the ROIAlign kernel needs a CUDA card")
    dev = torch.device("cuda")
    if case == "refused_channels":
        c = 12 if dtype == torch.bfloat16 else 6
        feats = {nm: torch.zeros((1, c, 8, 8), device=dev, dtype=dtype).contiguous(memory_format=torch.channels_last)
                 for nm in NAMES}
        with pytest.raises(ValueError, match="multiple of"):
            roi_align_cuda.multilevel_roi_align(feats, torch.zeros((1, 2, 4), device=dev))
        return
    feats, boxes = _torch_port.roi_card_case(case)
    tfeats = {
        k: torch.from_numpy(v).permute(0, 3, 1, 2).to(dev, dtype).contiguous(memory_format=torch.channels_last)
        for k, v in feats.items()
    }
    tboxes = torch.from_numpy(boxes).to(dev)
    before = roi_align_cuda.LAUNCHES
    out = roi_align_cuda.multilevel_roi_align(tfeats, tboxes)
    torch.cuda.synchronize()
    assert roi_align_cuda.LAUNCHES == before + 1
    ref = multilevel_roi_align(tfeats, tboxes)
    scale = ref.float().abs().amax().clamp(min=1.0)
    assert ((out.float() - ref.float()).abs().amax() / scale).item() <= atol


@pytest.mark.gpu
def test_kernel_levels_match_assign_levels_on_card():
    """K1 assigns the levels itself; they must equal ``assign_levels`` run
    on the card, bit for bit, also for boxes placed on the boundaries of the
    canonical rule (sqrt(area) = 112 * 2^k) and of the bump (longest side 120
    * 2^k px), one f32 step to either side, and a fine sweep of sizes."""
    if not torch.cuda.is_available():
        pytest.skip("the ROIAlign kernel needs a CUDA card")
    dev = torch.device("cuda")
    sides = []
    for edge in [112.0 * 2 ** k for k in range(5)] + [120.0 * 2 ** k for k in range(6)]:
        e = np.float32(edge)
        sides += [np.nextafter(e, np.float32(0)), e, np.nextafter(e, np.float32(1e9))]
    sides = np.array(sides + list(np.linspace(1, 2400, 4000)), dtype=np.float32)
    rng = np.random.RandomState(5)
    x0 = rng.uniform(-50, 500, sides.size).astype(np.float32)
    y0 = rng.uniform(-50, 500, sides.size).astype(np.float32)
    aspect = np.where(np.arange(sides.size) % 3 == 0, 1.0, rng.uniform(0.1, 1.0, sides.size)).astype(np.float32)
    boxes = np.stack([x0, y0, x0 + sides, y0 + sides * aspect], -1)[None]
    tboxes = torch.from_numpy(boxes).to(dev).contiguous()
    names = NAMES
    levels = [torch.zeros((1, -(-700 // s), -(-700 // s), 8), device=dev) for s in (4, 8, 16, 32, 64)]
    _, level = roi_align_cuda.roi_align_cuda(names, levels, tboxes)
    want = assign_levels(tboxes.reshape(-1, 4), names).reshape(1, -1)
    assert level.dtype == torch.int32
    assert torch.equal(level.long().cpu(), want.cpu())
    assert len(set(want.flatten().tolist())) == 5
