"""Pillow's uint8 bilinear and bicubic resizes and its nearest-neighbour
resize of single-band images, bit for bit, in torch index and integer
arithmetic.

The JAX mapper resizes with ``Image.fromarray(rgb).resize((nw, nh),
Image.BILINEAR)``. This is Pillow's ``ImagingResample`` (libImaging/Resample.c)
written out, so the CPU and the card give Pillow's bits:

* per output pixel, the filter's taps around its centre ``(i + 0.5) *
  scale``, the support widened by the scale when shrinking (the triangle of
  support 1; for ``resize_bicubic``, which ``vis`` uses as ``Image.resize``'s
  default, Keys' cubic with a = -0.5 and support 2);
* the weights in float64, divided by their sum (summed tap by tap), then
  fixed point with ``PRECISION_BITS`` = 22 fraction bits, rounded half away
  from zero;
* the horizontal pass, then the vertical pass, each an integer sum started at
  half a unit, shifted down by 22 bits and clipped to 0..255.

A pass whose size does not change is skipped, as Pillow skips it. The taps
(index and fixed weight) are computed once per (input, output) size on the
host and kept on the device; a pass is a gather and a sum.

The weak path's depth and ground maps and object masks are resized with
``Image.fromarray(m).resize((nw, nh), Image.NEAREST)`` (modes ``F`` and
``L``). That is Pillow's ``ImagingScaleAffine``: output pixel k reads source
pixel int(x_k), where x_0 = a / 2 and x_{k+1} = x_k + a, a = in / out, summed
in float64 one step at a time; a position outside the source gives 0.
``resize_nearest`` gathers those indices.
"""
from __future__ import annotations

import functools
import itertools
import math
from typing import Tuple

import numpy as np
import torch

PRECISION_BITS = 22


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` (a = -0.5) of |x|."""
    a = -0.5
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


# name -> (support, filter of |x|)
_FILTERS = {"bilinear": (1.0, lambda x: np.where(x < 1.0, 1.0 - x, 0.0)), "bicubic": (2.0, _bicubic)}


@functools.lru_cache(maxsize=None)
def _taps_host(in_size: int, out_size: int, filt: str = "bilinear") -> Tuple[np.ndarray, np.ndarray]:
    """(out_size, ksize) input indices (clamped in range) and int32 fixed-point
    weights (0 beyond each pixel's taps): Pillow's ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` for the filter ``filt``."""
    base, kernel = _FILTERS[filt]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = base * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)[None, :]
    live = x < xmax[:, None]
    arg = np.abs((x + xmin[:, None] - center[:, None] + 0.5) * ss)
    k = np.where(live, kernel(arg), 0.0)
    ww = k[:, 0].copy()
    for j in range(1, ksize):  # tap by tap, as the C loop sums
        ww = ww + k[:, j]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    one = float(1 << PRECISION_BITS)
    fixed = np.where(k < 0, np.trunc(-0.5 + k * one), np.trunc(0.5 + k * one)).astype(np.int32)
    index = np.minimum(x + xmin[:, None], in_size - 1)
    return index, np.where(live, fixed, 0).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _taps(in_size: int, out_size: int, device: torch.device, filt: str) -> Tuple[torch.Tensor, torch.Tensor]:
    index, weight = _taps_host(in_size, out_size, filt)
    return torch.from_numpy(index).to(device), torch.from_numpy(weight).to(device)


def _pass(image: torch.Tensor, out_size: int, dim: int, filt: str) -> torch.Tensor:
    """One pass along ``dim`` (0 rows, 1 columns) of a uint8 (H, W, C) image."""
    index, weight = _taps(image.shape[dim], out_size, image.device, filt)
    taps = image.index_select(dim, index.reshape(-1)).to(torch.int32)
    if dim == 0:
        taps = taps.reshape(out_size, -1, *image.shape[1:])  # (out, ksize, W, C)
        acc = (taps * weight[:, :, None, None]).sum(1, dtype=torch.int64)
    else:
        taps = taps.reshape(image.shape[0], out_size, -1, image.shape[2])  # (H, out, ksize, C)
        acc = (taps * weight[None, :, :, None]).sum(2, dtype=torch.int64)
    acc = (acc + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS
    return acc.clamp_(0, 255).to(torch.uint8)


def resize_bilinear(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """uint8 (H, W, C) -> uint8 (height, width, C), Pillow's ``BILINEAR``
    resize of the same image, on the image's device."""
    return _resize(image, height, width, "bilinear")


def resize_bicubic(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """uint8 (H, W, C) -> uint8 (height, width, C), Pillow's ``BICUBIC``
    resize (``Image.resize``'s default) of the same image, on its device."""
    return _resize(image, height, width, "bicubic")


def _resize(image: torch.Tensor, height: int, width: int, filt: str) -> torch.Tensor:
    if image.dtype != torch.uint8 or image.dim() != 3:
        raise ValueError(f"a {filt} resize takes a uint8 (H, W, C) image, not {image.dtype} {tuple(image.shape)}")
    out = image
    if width != image.shape[1]:
        out = _pass(out, width, 1, filt)
    if height != image.shape[0]:
        out = _pass(out, height, 0, filt)
    return out.contiguous()


@functools.lru_cache(maxsize=None)
def _nearest_host(in_size: int, out_size: int) -> np.ndarray:
    """(out_size,) source indices of Pillow's nearest resize, -1 where the
    position falls outside the source."""
    a = float(in_size) / out_size
    pos = np.cumsum(np.concatenate([[a * 0.5], np.full(out_size - 1, a)]))  # left to right, as the C loop adds
    idx = np.where(pos < 0.0, -1, np.floor(np.maximum(pos, 0.0))).astype(np.int64)
    return np.where(idx < in_size, idx, -1)


@functools.lru_cache(maxsize=64)
def _nearest(in_size: int, out_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_nearest_host(in_size, out_size)).to(device)


def resize_nearest(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(H, W) of any dtype -> (height, width): Pillow's ``NEAREST`` resize of
    the same single-band image, on the image's device."""
    if image.dim() != 2:
        raise ValueError(f"resize_nearest takes an (H, W) image, not {tuple(image.shape)}")
    if (height, width) == tuple(image.shape):
        return image.clone()
    rows = _nearest(image.shape[0], height, image.device)
    cols = _nearest(image.shape[1], width, image.device)
    out = image[rows.clamp(min=0)[:, None], cols.clamp(min=0)[None, :]]
    inside = (rows >= 0)[:, None] & (cols >= 0)[None, :]
    return torch.where(inside, out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# jax.image.resize, "linear" and "cubic", written out
# ---------------------------------------------------------------------------
#
# ``jax.image.resize(x, shape, method)`` (jax/_src/image/scale.py) is a
# product of x with one weight matrix a dimension whose size changes, the
# others skipped. For an input size m and an output size n, scale = n / m:
# the output pixel j samples the input at s_j = (j + 0.5) / scale - 0.5 (f32),
# the kernel is evaluated at |s_j - i| / max(1 / scale, 1) (with jax's default
# ``antialias=True`` the kernel widens by 1 / scale when it shrinks; it is the
# plain kernel when it grows), each column is divided by its sum (0 where the
# sum is below 1000 f32 epsilons), and a column whose s_j lies outside
# [-0.5, m - 0.5] is 0. The weights are made in f32 and cast to x's dtype.
# The dimensions are contracted in the order jax's einsum picks (opt_einsum's
# cheapest path: the least sum of the products' sizes, the first such order
# on a tie); a bf16 x is multiplied with f32 sums and rounded to bf16 after
# each dimension (XLA's bf16 dot_general), which gives jax's bits.


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic with a = -0.5, in jax's operation order."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(out), out)


_JAX_KERNELS = {"linear": _triangle, "cubic": _keys_cubic}


@functools.lru_cache(maxsize=None)
def _jax_weights_host(in_size: int, out_size: int, method: str) -> torch.Tensor:
    """(in_size, out_size) f32 weights of ``compute_weight_mat``."""
    f32 = torch.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = torch.tensor(max(inv_scale, 1.0), dtype=f32)
    sample = (torch.arange(out_size, dtype=f32) + 0.5) * torch.tensor(inv_scale, dtype=f32) - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=f32)[:, None]).abs() / kernel_scale
    w = _JAX_KERNELS[method](x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


@functools.lru_cache(maxsize=64)
def _jax_weights(in_size: int, out_size: int, method: str, device: torch.device, dtype: torch.dtype):
    return _jax_weights_host(in_size, out_size, method).to(device=device, dtype=dtype)


def _contraction_order(in_shape, out_shape):
    """The dimensions that change size, in the order jax's einsum contracts
    them: the permutation whose products' sizes sum least, the first of
    equals."""
    dims = [d for d in range(len(in_shape)) if in_shape[d] != out_shape[d]]
    best, best_cost = (), None
    for order in itertools.permutations(dims):
        size, cost = list(in_shape), 0
        for d in order:
            cost += math.prod(size) * out_shape[d]
            size[d] = out_shape[d]
        if best_cost is None or cost < best_cost:
            best, best_cost = order, cost
    return best


def _jax_resize(x: torch.Tensor, shape, method: str) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    if len(shape) != x.dim():
        raise ValueError(f"shape {shape} must have one size a dimension of x {tuple(x.shape)}")
    if not x.is_floating_point():
        x = x.float()
    dtype = x.dtype
    for d in _contraction_order(tuple(x.shape), shape):
        w = _jax_weights(x.shape[d], shape[d], method, x.device, dtype).float()
        x = torch.matmul(x.movedim(d, -1).float(), w).movedim(-1, d).to(dtype)
    return x.contiguous()


def resize_linear(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, "linear")`` (antialiased when shrinking)."""
    return _jax_resize(x, shape, "linear")


def resize_cubic(x: torch.Tensor, shape) -> torch.Tensor:
    """``jax.image.resize(x, shape, "cubic")`` (also "bicubic"; Keys, a = -0.5)."""
    return _jax_resize(x, shape, "cubic")
