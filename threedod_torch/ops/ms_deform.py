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
all levels, in the variant ``sample_plan`` picks from the shape alone (staged
coarse levels in shared memory at the encoder's shape, levels split over lane
groups at the decoder's, a generic kernel for other L and P). A build or
launch failure raises. A CPU tensor goes to
``ms_deform_sample_reference``, the plain version the tests and the card-side
comparison use. Every launch adds one to ``LAUNCHES``. Forward only: the
kernel raises when grad mode is on and an input requires a gradient, rather
than return a result that autograd cannot see through (the plain version on
the CPU stays differentiable).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from . import _build
from ._build import card_sms

LAUNCHES = 0  # K3
MAX_LEVELS = 8  # the generic kernel's level table; GroundingDINO has 4
FAST_LEVELS = FAST_POINTS = 4  # GroundingDINO's (L, P): the specialised kernels
LANES_AN_SM = 1024  # below this many lanes an SM the levels are split over lane groups
STAGE_BYTES = 131072  # the staged levels' budget: half the SM's 256 KB of L1 and shared memory
STAGE_GAIN = 4  # a staged level is gathered at least this many times its size by its block
# vectors a lane loads a tap, by kind: the counts csrc/ms_deform_sample.cu is
# instantiated for (it refuses any other)
VECTORS_A_LANE = {"generic": 1, "staged": 1, "split": 2}
_DTYPES = (torch.float32, torch.bfloat16)
_VARIANTS = {"generic": 0, "split": 1, "staged": 2}


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


class SamplePlan(NamedTuple):
    """How K3 serves one call: ``kind`` "staged", "split" or "generic" (see
    ``sample_plan``), the bytes a lane loads at once (``vec_bytes``), the
    lanes serving one (image, query, head), or one level of it when split
    (``lanes``), the vectors a lane loads a tap (``vectors``), the coarsest
    levels held in shared memory (``staged``) and their bytes
    (``smem_bytes``), and the blocks an (image, head) takes (``per_pair``)."""
    kind: str
    vec_bytes: int
    lanes: int
    vectors: int
    staged: int = 0
    smem_bytes: int = 0
    per_pair: int = 1


def sample_plan(spatial_shapes: Sequence[Tuple[int, int]], lq: int, h: int, d: int, dtype: torch.dtype, *,
                sms: int, b: int = 1, points: int = 4, value_align: int = 16,
                vectors_align: int = 16) -> SamplePlan:
    """K3's variant for a shape, a pure function of it, of the card's
    streaming multiprocessors (``sms``) and of the pointers' alignment, in
    bytes (``value_align`` that of value, ``vectors_align`` the smaller of the
    locations' and the weights').

    * The vector: 16 bytes where a head's run of D channels and value's start
      allow it, else 8 (bf16 with D * 2 not a multiple of 16); each lane loads
      ``VECTORS_A_LANE`` vectors a tap, and the lanes of a (query, head) are
      as many as cover D, rounded up to a power of two, at most 32 (a lane
      loops over the rest).
    * (L, P) other than (4, 4), or locations or weights that are not 16-byte
      aligned: "generic".
    * Too few (query, head) pairs to give the card ``sms * LANES_AN_SM``
      lanes (the decoder's 900 queries) while four levels' lane groups fit a
      warp: "split", one level a lane group.
    * Otherwise "staged": ``sms // (b * h)`` blocks an (image, head), each
      holding the coarsest levels in shared memory, as many as fit in
      ``STAGE_BYTES`` and are each gathered at least ``STAGE_GAIN`` times
      their size by one block (a level too large, or too few queries a
      block, is gathered from memory). The budget is half the SM's L1 and
      shared memory: at GroundingDINO's encoder shape staging levels 2 and 3
      beat staging 1 to 3 and staging nothing in bf16 on an H100 (``PERF.md``
      §6), the L1 left over catching the model's neighbouring taps on levels
      0 and 1."""
    itemsize = torch.finfo(dtype).bits // 8
    n_lvl = len(spatial_shapes)
    vec_bytes = 16 if (d * itemsize) % 16 == 0 and value_align % 16 == 0 else 8
    nvec = d * itemsize // vec_bytes

    def lanes_for(kind):
        return min(32, 1 << (-(-nvec // VECTORS_A_LANE[kind]) - 1).bit_length())

    if (n_lvl, points) != (FAST_LEVELS, FAST_POINTS) or vectors_align % 16:
        return SamplePlan("generic", vec_bytes, lanes_for("generic"), VECTORS_A_LANE["generic"])
    lanes = lanes_for("split")
    if b * lq * h * lanes < sms * LANES_AN_SM and lanes * FAST_LEVELS <= 32:
        return SamplePlan("split", vec_bytes, lanes, VECTORS_A_LANE["split"])
    lanes = lanes_for("staged")
    per_pair = max(1, sms // (b * h))
    gathered = -(-lq // per_pair) * points * 4 * d * itemsize  # one level's tap bytes a block
    staged = smem = 0
    for hl, wl in reversed(spatial_shapes):
        size = hl * wl * d * itemsize
        if smem + size > STAGE_BYTES or size * STAGE_GAIN > gathered:
            break
        staged, smem = staged + 1, smem + size
    return SamplePlan("staged", vec_bytes, lanes, VECTORS_A_LANE["staged"], staged, smem, per_pair)


_cached_plan = functools.lru_cache(maxsize=256)(sample_plan)  # the wrapper's, keyed on hashable arguments


@functools.lru_cache(maxsize=None)
def _level_table(spatial_shapes: Tuple[Tuple[int, int], ...]):
    starts, _ = _level_starts(spatial_shapes)
    hw = (ctypes.c_int * (3 * MAX_LEVELS))()
    for i, ((hl, wl), st) in enumerate(zip(spatial_shapes, starts)):
        hw[3 * i], hw[3 * i + 1], hw[3 * i + 2] = hl, wl, st
    return hw


@functools.lru_cache(maxsize=None)
def _kernel():
    """The library and its entry point, declared once."""
    argtypes = [ctypes.c_void_p] * 4 + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    lib = _build.library("ms_deform_sample", "threedod_ms_deform_sample", argtypes)
    return lib, lib.threedod_ms_deform_sample


@functools.lru_cache(maxsize=None)
def _align(ptr: int) -> int:
    """The pointer's alignment in bytes, up to the 16 the plan asks about."""
    return min(16, ptr & -ptr) if ptr else 16


def ms_deform_sample_cuda(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                          locations: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Kernel K3: the same function as ``ms_deform_sample_reference`` in one
    launch over all levels, in the variant ``sample_plan`` picks for the
    shape. Contiguous CUDA tensors, D a multiple of 4."""
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
    shapes = tuple((int(hl), int(wl)) for hl, wl in spatial_shapes)
    plan = _cached_plan(shapes, lq, h, d, value.dtype, sms=card_sms(value.device), b=b, points=p,
                        value_align=_align(value.data_ptr()),
                        vectors_align=min(_align(locations.data_ptr()), _align(weights.data_ptr())))
    lib, fn = _kernel()
    err = fn(value.data_ptr(), locations.data_ptr(), weights.data_ptr(), out.data_ptr(), _level_table(shapes),
             b, s, h, d, lq, n_lvl, p, _VARIANTS[plan.kind], plan.vec_bytes, plan.vectors, plan.lanes.bit_length() - 1,
             n_lvl - plan.staged, plan.per_pair, *_build.launch_args(value))
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
