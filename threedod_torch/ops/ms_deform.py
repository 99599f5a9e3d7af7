"""Multi-scale deformable sampling of GroundingDINO's MSDeformAttn, with
kernel K3 (counterpart of ``threedod/models/gdino/deformable.py``'s
``ms_deform_sample``).

``ms_deform_sample(value, spatial_shapes, locations, weights)`` takes
  value      (B, S, H, D): the L level maps flattened and concatenated, S the
             sum of H_l * W_l, in the compute dtype (float32 or bfloat16);
  locations  (B, Lq, H, L, P, 2) float32, (x, y) normalised to [0, 1];
  weights    (B, Lq, H, L, P) in value's dtype, softmaxed over L * P;
and returns (B, Lq, H, D) in value's dtype: for every (image, query, head),
the sum over levels and points of the weight times a bilinear sample of the
level's map at pixel (x * W_l - 0.5, y * H_l - 0.5) (pixel centres on
half-integers, as with ``align_corners=False``), taps outside the map reading
zero. Sums are kept in float32 and cast to value's dtype once, as the Pallas
kernel does.

A CUDA tensor goes to the hand-written kernel ``csrc/ms_deform_sample.cu``
(K3), built at first use and launched on the current stream; one launch covers
all levels. A build or launch failure raises. A CPU tensor goes to
``ms_deform_sample_reference``, the plain version the tests and the card-side
comparison use. Every launch adds one to ``LAUNCHES``. Forward only: the
kernel raises when grad mode is on and an input requires a gradient, rather
than return a result that autograd cannot see through (the plain version on
the CPU stays differentiable).
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import _build

LAUNCHES = 0  # K3
MAX_LEVELS = 8  # the kernel's level table; GroundingDINO has 4
_DTYPES = (torch.float32, torch.bfloat16)


def _level_starts(spatial_shapes: Sequence[Tuple[int, int]]):
    starts, s = [], 0
    for hl, wl in spatial_shapes:
        starts.append(s)
        s += hl * wl
    return starts, s


def ms_deform_sample_reference(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                               locations: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The four-tap gather of the JAX package's ``ms_deform_sample_gather``
    written out, in float32 throughout, with one cast to value's dtype at the
    end. The corner indices are clamped to [-2, W_l + 1] x [-2, H_l + 1] as
    floats before they become integers, so a location far off the map reads
    zeros like any other outside tap."""
    b, _, h, d = value.shape
    lq, p = locations.shape[1], locations.shape[4]
    starts, _ = _level_starts(spatial_shapes)
    out = torch.zeros((b, lq, h, d), dtype=torch.float32, device=value.device)
    for lvl, ((hl, wl), start) in enumerate(zip(spatial_shapes, starts)):
        vv = value[:, start:start + hl * wl].float().permute(0, 2, 1, 3)  # (B, H, S_l, D)
        loc = locations[:, :, :, lvl].float()                              # (B, Lq, H, P, 2)
        w = weights[:, :, :, lvl].float()                                  # (B, Lq, H, P)
        x = loc[..., 0] * wl - 0.5
        y = loc[..., 1] * hl - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        fx, fy = x - x0, y - y0
        x0 = x0.clamp(-2.0, wl + 1.0)
        y0 = y0.clamp(-2.0, hl + 1.0)
        acc = torch.zeros((b, lq, h, p, d), dtype=torch.float32, device=value.device)
        for dy, dx, tap_w in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                              (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < wl) & (yi >= 0) & (yi < hl)
            idx = yi.clamp(0, hl - 1).long() * wl + xi.clamp(0, wl - 1).long()  # (B, Lq, H, P)
            flat = idx.permute(0, 2, 1, 3).reshape(b, h, lq * p, 1).expand(b, h, lq * p, d)
            g = torch.gather(vv, 2, flat).reshape(b, h, lq, p, d).permute(0, 2, 1, 3, 4)
            acc = acc + g * (tap_w * ok)[..., None]
        out = out + (acc * w[..., None]).sum(3)
    return out.to(value.dtype)


def _check(value, spatial_shapes, locations, weights) -> None:
    if value.dim() != 4 or locations.dim() != 6 or weights.dim() != 5:
        raise ValueError(f"expected value (B, S, H, D), locations (B, Lq, H, L, P, 2), weights (B, Lq, H, L, P); "
                         f"got {tuple(value.shape)}, {tuple(locations.shape)}, {tuple(weights.shape)}")
    b, s, h, _ = value.shape
    lq, n_lvl, p = locations.shape[1], locations.shape[3], locations.shape[4]
    if (tuple(locations.shape) != (b, lq, h, n_lvl, p, 2)
            or tuple(weights.shape) != (b, lq, h, n_lvl, p)):
        raise ValueError(f"locations {tuple(locations.shape)} and weights {tuple(weights.shape)} do not match "
                         f"value {tuple(value.shape)}")
    if len(spatial_shapes) != n_lvl or _level_starts(spatial_shapes)[1] != s:
        raise ValueError(f"spatial shapes {list(spatial_shapes)} do not cover the {s} value rows in {n_lvl} levels")
    if value.dtype not in _DTYPES:
        raise TypeError(f"value must be float32 or bfloat16, got {value.dtype}")
    if weights.dtype != value.dtype:
        raise TypeError(f"weights must have value's dtype {value.dtype}, got {weights.dtype}")
    if locations.dtype != torch.float32:
        raise TypeError(f"locations must be float32, got {locations.dtype}")
    if len({t.device for t in (value, locations, weights)}) != 1:
        raise ValueError("value, locations and weights must be on one device")


def ms_deform_sample_cuda(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                          locations: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Kernel K3: the same function as ``ms_deform_sample_reference`` in one
    launch over all levels. Contiguous CUDA tensors, D a multiple of 4."""
    global LAUNCHES
    _check(value, spatial_shapes, locations, weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (value, locations, weights)):
        raise RuntimeError("the deformable-sampling kernel has no backward (the JAX package differentiates through "
                           "none of its backends): call it under torch.no_grad() or torch.inference_mode()")
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_sample_cuda takes CUDA tensors, got {value.device}")
    b, s, h, d = value.shape
    lq, n_lvl, p = locations.shape[1], locations.shape[3], locations.shape[4]
    if d % 4:
        raise ValueError(f"the deformable-sampling kernel takes a head width that is a multiple of 4, got {d}")
    if n_lvl > MAX_LEVELS:
        raise ValueError(f"the deformable-sampling kernel takes at most {MAX_LEVELS} levels, got {n_lvl}")
    for t, what in ((value, "value"), (locations, "locations"), (weights, "weights")):
        if not t.is_contiguous():
            raise ValueError(f"{what} must be contiguous")
    if value.data_ptr() % (4 * value.element_size()) or locations.data_ptr() % 8:
        raise ValueError("value must start on a 4-element boundary and locations on an 8-byte one")
    out = torch.empty((b, lq, h, d), dtype=value.dtype, device=value.device)
    if out.numel() == 0:
        return out
    starts, _ = _level_starts(spatial_shapes)
    hw = (ctypes.c_int * (3 * MAX_LEVELS))()
    for i, ((hl, wl), st) in enumerate(zip(spatial_shapes, starts)):
        hw[3 * i], hw[3 * i + 1], hw[3 * i + 2] = hl, wl, st
    argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib = _build.library("ms_deform_sample", "threedod_ms_deform_sample", argtypes)
    err = lib.threedod_ms_deform_sample(value.data_ptr(), locations.data_ptr(), weights.data_ptr(), out.data_ptr(), hw,
                                        b, s, h, d, lq, n_lvl, p, *_build.launch_args(value))
    _build.check_launch(lib, "ms_deform_sample", err)
    LAUNCHES += 1
    return out


def ms_deform_sample(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                     locations: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(B, Lq, H, D) in value's dtype: K3 on a CUDA tensor, the plain version
    on a CPU tensor; any other device raises."""
    _check(value, spatial_shapes, locations, weights)
    if value.device.type == "cpu":
        return ms_deform_sample_reference(value, spatial_shapes, locations, weights)
    if value.device.type != "cuda":
        raise ValueError(f"ms_deform_sample runs on CUDA or CPU tensors, got {value.device}")
    return ms_deform_sample_cuda(value, spatial_shapes, locations, weights)
