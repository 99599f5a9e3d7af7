"""Wrappers of kernels K1 and K2, the multilevel ROIAlignV2 forward and
backward (``csrc/roi_align_fwd.cu``, ``csrc/roi_align_bwd.cu``; they replace
``threedod/ops/roi_align_pallas.py::_kernel`` and ``::_bwd_kernel``).

``multilevel_roi_align`` is what the ROI heads call. It is one
``torch.autograd.Function``: tensors on the CPU go to the plain versions
(``ops/roi_align.py``) in both directions; tensors on a CUDA device always go
to the kernels, which are built at first use and launched on the current
stream. On the card K1 also assigns the levels (``assign_levels``'
arithmetic as PyTorch runs it there) and hands them to K2. A build or launch
failure raises. Every K1 launch adds one to ``LAUNCHES``, every K2 launch one
to ``BACKWARD_LAUNCHES``. The gradient goes to the feature levels only;
boxes get none.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List

import torch

from . import _build
from .roi_align import STRIDES, assign_levels, roi_align_backward, roi_align_levels

LAUNCHES = 0  # K1
BACKWARD_LAUNCHES = 0  # K2
MAX_LEVELS = 5
MAX_BINS, MAX_SAMPLES = 8, 64  # bins a side, samples a side (S * R) the kernels take
_VEC = {torch.float32: 4, torch.bfloat16: 8}  # values per 16-byte load of K1


class _Levels(ctypes.Structure):
    _fields_ = [
        ("ptr", ctypes.c_void_p * MAX_LEVELS),
        ("h", ctypes.c_int * MAX_LEVELS),
        ("w", ctypes.c_int * MAX_LEVELS),
        ("scale", ctypes.c_float * MAX_LEVELS),
    ]


_INT, _PTR = ctypes.c_int, ctypes.c_void_p


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    return _build.library("roi_align_fwd", "threedod_roi_align_fwd",
                          [_Levels, _PTR, _PTR, _PTR, *[_INT] * 9, _PTR])


@functools.lru_cache(maxsize=None)
def _backward_library() -> ctypes.CDLL:
    return _build.library("roi_align_bwd", "threedod_roi_align_bwd",
                          [_Levels, _PTR, _PTR, _PTR, *[_INT] * 6, _PTR])


class _ROIAlign(torch.autograd.Function):
    """(boxes, output_size, sampling_ratio, names, *levels (B, H_l, W_l, C))
    -> (B, N, S, S, C). Saves the boxes and the level assignment, so the
    backward scatters on the level the forward read."""

    @staticmethod
    def forward(ctx, boxes, output_size, sampling_ratio, names, *levels):
        if boxes.is_cuda:
            out, level = roi_align_cuda(list(names), list(levels), boxes, output_size, sampling_ratio)
        else:
            level = assign_levels(boxes.reshape(-1, 4).float(), list(names)).reshape(boxes.shape[:2])
            scales = [1.0 / STRIDES[nm] for nm in names]
            out = roi_align_levels(list(levels), boxes, level, scales, output_size, sampling_ratio)
        ctx.save_for_backward(boxes, level)
        ctx.names, ctx.sampling_ratio = names, sampling_ratio
        ctx.shapes = [(lv.shape[1], lv.shape[2]) for lv in levels]
        ctx.dtype = levels[0].dtype
        return out

    @staticmethod
    def backward(ctx, grad):
        boxes, level = ctx.saved_tensors
        if grad.is_cuda:
            grads = roi_align_backward_cuda(
                grad, boxes, level, list(ctx.names), ctx.shapes, ctx.sampling_ratio, ctx.dtype)
        else:
            scales = [1.0 / STRIDES[nm] for nm in ctx.names]
            grads = roi_align_backward(grad, boxes, level, ctx.shapes, scales, ctx.sampling_ratio, ctx.dtype)
        return (None, None, None, None, *grads)


def multilevel_roi_align(
    features: Dict[str, torch.Tensor],
    boxes: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
) -> torch.Tensor:
    """features {'p2'..'p6'}: (B, C, H_l, W_l); boxes (B, N, 4) f32 in image
    coordinates -> (B, N, S, S, C) in the features' dtype."""
    devices = {t.device.type for t in features.values()} | {boxes.device.type}
    if devices not in ({"cpu"}, {"cuda"}):
        raise ValueError(f"ROIAlign inputs must all be on the CPU or all on CUDA, got {devices}")
    names = sorted(features)
    if not 1 <= len(names) <= MAX_LEVELS or any(nm not in STRIDES for nm in names):
        raise ValueError(f"levels must be a subset of {sorted(STRIDES)}, got {names}")
    levels = [features[nm].permute(0, 2, 3, 1) for nm in names]
    return _ROIAlign.apply(boxes, output_size, sampling_ratio, tuple(names), *levels)


def _level_spec(names: List[str], levels: List[torch.Tensor]) -> _Levels:
    spec = _Levels()
    for i, (nm, lv) in enumerate(zip(names, levels)):
        spec.ptr[i] = lv.data_ptr()
        spec.h[i] = lv.shape[1]
        spec.w[i] = lv.shape[2]
        spec.scale[i] = 1.0 / STRIDES[nm]
    return spec


def _check_grid(output_size: int, sampling_ratio: int) -> None:
    if not (1 <= output_size <= MAX_BINS and sampling_ratio >= 1 and output_size * sampling_ratio <= MAX_SAMPLES):
        raise ValueError(f"the ROIAlign kernels take output_size <= {MAX_BINS} and output_size * sampling_ratio "
                         f"<= {MAX_SAMPLES}, got {output_size} and {sampling_ratio}")


def roi_align_cuda(
    names: List[str],
    levels: List[torch.Tensor],
    boxes: torch.Tensor,
    output_size: int = 7,
    sampling_ratio: int = 2,
):
    """Launch K1. ``names`` are consecutive pyramid levels, sorted;
    ``levels`` their (B, H_l, W_l, C) views of channels-last maps, each
    contiguous. Returns the pooled block (B, N, S, S, C) and each ROI's index
    into ``levels`` (B, N) int32, as ``assign_levels`` computes it."""
    global LAUNCHES
    dtype, device = levels[0].dtype, boxes.device
    b, _, _, c = levels[0].shape
    if dtype not in _VEC:
        raise TypeError(f"ROIAlign kernel takes float32 or bfloat16 features, got {dtype}")
    if c % _VEC[dtype]:
        raise ValueError(f"channel count {c} must be a multiple of {_VEC[dtype]} for {dtype} (16-byte loads)")
    _check_grid(output_size, sampling_ratio)
    for nm, lv in zip(names, levels):
        if lv.dtype != dtype or lv.device != device or lv.shape[0] != b or lv.shape[3] != c:
            raise ValueError(f"level {nm}: {tuple(lv.shape)} {lv.dtype} {lv.device} does not match")
        if not lv.is_contiguous():
            raise ValueError(f"level {nm} must be channels-last (torch.channels_last) in memory")
        if lv.data_ptr() % 16:
            raise ValueError(f"level {nm} must start on a 16-byte boundary for vector loads")
    _check_boxes(boxes, b)

    n = boxes.shape[1]
    s, r = output_size, sampling_ratio
    out = torch.empty((b, n, s, s, c), dtype=dtype, device=device)
    level = torch.empty((b, n), dtype=torch.int32, device=device)
    lib = _library()
    _build.check_launch(lib, "ROIAlign", lib.threedod_roi_align_fwd(
        _level_spec(names, levels), boxes.data_ptr(), level.data_ptr(), out.data_ptr(),
        b * n, n, c, s, r, int(names[0][1:]), int(names[-1][1:]), *_build.launch_args(out)))
    LAUNCHES += 1
    return out, level


def _check_boxes(boxes: torch.Tensor, b: int) -> None:
    if boxes.dtype != torch.float32 or boxes.dim() != 3 or boxes.shape[0] != b or boxes.shape[2] != 4:
        raise ValueError(f"boxes must be float32 (B={b}, N, 4), got {tuple(boxes.shape)} {boxes.dtype}")
    if not boxes.is_contiguous():
        raise ValueError("boxes must be contiguous")


def roi_align_backward_cuda(
    grad: torch.Tensor,
    boxes: torch.Tensor,
    level: torch.Tensor,
    names: List[str],
    shapes,
    sampling_ratio: int,
    dtype: torch.dtype,
) -> List[torch.Tensor]:
    """Launch K2. grad (B, N, S, S, C), made f32 and contiguous here; boxes
    (B, N, 4) f32; level (B, N) int32. Returns one (B, H_l, W_l, C) gradient
    per level in ``dtype``: views of one buffer that is zeroed on the current
    stream before the launch, accumulated into in f32 and cast once."""
    global BACKWARD_LAUNCHES
    b, n, s, _, c = grad.shape
    device = grad.device
    if dtype not in _VEC:
        raise TypeError(f"ROIAlign backward kernel returns float32 or bfloat16 gradients, got {dtype}")
    if c % 4:
        raise ValueError(f"channel count {c} must be a multiple of 4 (float4 atomics)")
    _check_grid(s, sampling_ratio)
    _check_boxes(boxes, b)
    if level.dtype != torch.int32 or not level.is_contiguous() or level.numel() != b * n:
        raise ValueError("level must be contiguous int32 (B, N)")
    # the heads flatten the pooled block and the cube branch slices it, so
    # the summed cotangent may arrive in any layout
    grad = grad.float().contiguous()
    if grad.data_ptr() % 16:
        raise ValueError("the cotangent must start on a 16-byte boundary for vector loads")

    sizes = [b * h * w * c for h, w in shapes]
    acc = torch.zeros(sum(sizes), dtype=torch.float32, device=device)  # zeroed on the current stream
    planes = [p.view(b, h, w, c) for p, (h, w) in zip(acc.split(sizes), shapes)]
    lib = _backward_library()
    _build.check_launch(lib, "ROIAlign backward", lib.threedod_roi_align_bwd(
        _level_spec(names, planes), grad.data_ptr(), boxes.data_ptr(), level.data_ptr(),
        b * n, n, c, s, sampling_ratio, device.index or 0, torch.cuda.current_stream(device).cuda_stream))
    BACKWARD_LAUNCHES += 1
    if dtype == torch.float32:
        return planes
    out = acc.to(dtype)
    return [p.view(b, h, w, c) for p, (h, w) in zip(out.split(sizes), shapes)]
