"""Cube proposal samplers (counterpart of ``threedod/proposals/proposals.py``,
after ProposalNetwork/proposals/proposals.py).

Seven samplers, from ``random`` (everything uniform) to ``propose`` (the
method): centres from a grid across the 2D box unprojected through the depth
map and refined by the fitted linear coefficients, dimensions from the
category's prior truncated to [0.05, mean + 2 std], rotations swept about the
ground normal. Every sampler works on (B, N) reference boxes at once and
returns (B, N, P, 15) cubes: images, instances, proposals.

Randomness comes in as standard variates, one tensor per name of
``sampler_draws``: U[0, 1) uniforms, N(0, 1) normals, the U[0, 1) behind
each truncated normal (transformed here as ``jax.random.truncated_normal``
transforms it), N(0, 1) matrices for random rotations, and integers.
``draw_standard`` draws them from a ``torch.Generator`` on its device; the
tests hand in the variates the JAX key tree draws.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..geometry.rotations import matrix_to_euler, orthobasis_from_normal
from ..structures.cubes import Cubes

MIN_PROP_S = 0.05  # least edge length in metres
RATIOS = (0.33, 0.66, 1.0, 1.33, 1.67, 2.0, 3.0)  # the aspect sampler's h / w and l / w
YAW_BINS = 36  # ``propose``'s rotations about the ground normal, over [0, pi]

_DIMS_UNIFORM = (("w", "uniform"), ("h", "uniform"), ("l", "uniform"))
_DIMS_PRIOR = (("w", "truncated"), ("h", "truncated"), ("l", "truncated"))
_CENTER = (("x", "normal"), ("y", "normal"), ("z", "normal"))
_ROTATION = (("R", "rotation"),)

# each sampler's variates, in the order the JAX sampler splits its key
SAMPLER_DRAWS = {
    "random": (("x", "uniform"), ("y", "uniform"), ("z", "uniform")) + _DIMS_UNIFORM + _ROTATION,
    "xy": (("z", "uniform"),) + _DIMS_UNIFORM + _ROTATION,
    "z": _DIMS_UNIFORM + _ROTATION,
    "dim": _DIMS_UNIFORM + _CENTER + _ROTATION,
    "aspect": (("w", "uniform"), ("r1", "ratio"), ("r2", "ratio")) + _CENTER + _ROTATION,
    "rotation": _DIMS_PRIOR + _CENTER + _ROTATION,
    "propose": _DIMS_PRIOR + _CENTER + _ROTATION,
}


def sampler_draws(name: str, with_normal: bool = False) -> Tuple[Tuple[str, str], ...]:
    """(variate name, kind) pairs sampler ``name`` reads; ``propose`` with a
    ground normal reads a yaw bin a proposal instead of a random rotation."""
    spec = SAMPLER_DRAWS[name]
    if name == "propose" and with_normal:
        spec = spec[:-1] + (("yaw", "yaw"),)
    return spec


def draw_standard(name: str, b: int, n: int, p: int, generator: torch.Generator,
                  with_normal: bool = False) -> Dict[str, torch.Tensor]:
    """The variates of sampler ``name`` for (b, n) instances and p proposals,
    drawn from ``generator`` on its device."""
    dev = generator.device
    out = {}
    for key, kind in sampler_draws(name, with_normal):
        if kind in ("uniform", "truncated"):
            out[key] = torch.rand((b, n, p), generator=generator, device=dev)
        elif kind == "normal":
            out[key] = torch.randn((b, n, p), generator=generator, device=dev)
        elif kind == "rotation":
            out[key] = torch.randn((b, n, p, 3, 3), generator=generator, device=dev)
        elif kind == "ratio":
            out[key] = torch.randint(0, len(RATIOS), (b, n), generator=generator, device=dev)
        else:  # yaw
            out[key] = torch.randint(0, YAW_BINS, (b, n, p), generator=generator, device=dev)
    return out


def _f32(x: float) -> float:
    """x rounded to the nearest f32 (the value a JAX f32 constant holds)."""
    return torch.tensor(x, dtype=torch.float32).item()


def linspace(start, stop, num: int, device=None, endpoint: bool = True) -> torch.Tensor:
    """``jnp.linspace`` along a new last axis as XLA computes it: start (1 -
    i c) + i (stop c) with c = 1 / div in f32, the stop itself last. ``start``
    and ``stop`` are floats or f32 tensors of one shape; a float is filled in
    on the device (a copy from the host would wait for the card)."""
    div = num - 1 if endpoint else num
    like = start if torch.is_tensor(start) else stop
    dev = like.device if torch.is_tensor(like) else device

    def on_device(v):
        return v if torch.is_tensor(v) else torch.full((), v, dtype=torch.float32, device=dev)

    c = _f32(1.0 / div)
    i = torch.arange(div, dtype=torch.float32, device=dev)
    stop_t = on_device(stop)[..., None]
    out = i * (stop_t * c)
    if not (isinstance(start, float) and start == 0.0):
        out = on_device(start)[..., None] * (1.0 - i * c) + out
    if endpoint:
        out = torch.cat([out, stop_t.expand(*out.shape[:-1], 1)], dim=-1)
    return out


def rescale_interval(x, lo: float, hi: float):
    return (lo - hi) * x + hi


def truncated_normal(u: torch.Tensor, lower: torch.Tensor, upper: torch.Tensor) -> torch.Tensor:
    """A standard normal truncated to (lower, upper) from a U[0, 1) variate,
    as ``jax.random.truncated_normal`` draws it: u mapped into [erf(lower /
    sqrt 2), erf(upper / sqrt 2)), sqrt 2 erfinv of that, clipped to the open
    interval."""
    sqrt2 = math.sqrt(2.0)
    a = torch.erf(lower / sqrt2)
    b = torch.erf(upper / sqrt2)
    v = torch.maximum(a, u * (b - a) + a)
    out = sqrt2 * torch.erfinv(v)
    inf = torch.full_like(lower, math.inf)
    return torch.minimum(torch.maximum(out, torch.nextafter(lower, inf)), torch.nextafter(upper, -inf))


def sample_normal_in_range(variate: torch.Tensor, mean, std, lo=None, hi=None) -> torch.Tensor:
    """mean + std x (a normal variate, or a truncated one from its uniform when
    ``lo`` or ``hi`` is given): the exact form of the reference's rejection
    loop. mean, std (, hi) (...,) broadcast over the variate's last axis."""
    std = torch.clamp(std, min=1e-6)[..., None]
    mean = mean[..., None]
    if lo is None and hi is None:
        return mean + std * variate
    a = (lo - mean) / std if lo is not None else torch.full_like(mean, -math.inf)
    b = (hi[..., None] - mean) / std if hi is not None else torch.full_like(mean, math.inf)
    b = torch.maximum(b, a + 1e-4)  # an inverted or empty interval
    return mean + std * truncated_normal(variate, a.expand_as(variate), b.expand_as(variate))


def randn_orthobasis(z: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) normal variates -> orthonormal bases (rows r0, r1, z2)."""
    def unit(v):
        return v / torch.clamp(torch.sqrt((v * v).sum(-1, keepdim=True)), min=1e-8)

    z = unit(z)
    r0 = unit(torch.linalg.cross(z[..., 1, :], z[..., 2, :], dim=-1))
    r1 = unit(torch.linalg.cross(z[..., 2, :], r0, dim=-1))
    return torch.stack([r0, r1, z[..., 2, :]], dim=-2)


def _median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over the last axis: the mean of the two middle values
    of an even count, NaN where the row holds one."""
    n = x.shape[-1]
    s = torch.sort(x, dim=-1).values
    med = (s[..., (n - 1) // 2] + s[..., n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(-1), torch.full_like(med, math.nan), med)


def _std(x: torch.Tensor) -> torch.Tensor:
    """``jnp.std`` over the last axis (ddof 0)."""
    c = x - x.mean(-1, keepdim=True)
    return torch.sqrt((c * c).sum(-1) / x.shape[-1])


def nanquantile(x: torch.Tensor, qs) -> torch.Tensor:
    """``jnp.nanquantile(x, qs)`` (linear) over the last axis -> (..., len(qs)):
    NaN where a row has no number."""
    s = torch.sort(x, dim=-1).values  # NaN last
    counts = (~torch.isnan(x)).sum(-1).float()
    out = []
    for q in qs:
        pos = _f32(q) * (counts - 1.0)
        low, high = torch.floor(pos), torch.ceil(pos)
        hw = pos - low
        lw = 1.0 - hw
        low = torch.maximum(torch.minimum(low, counts - 1.0), torch.zeros_like(low)).long()
        high = torch.maximum(torch.minimum(high, counts - 1.0), torch.zeros_like(high)).long()
        out.append(torch.gather(s, -1, low[..., None])[..., 0] * lw + torch.gather(s, -1, high[..., None])[..., 0] * hw)
    return torch.stack(out, dim=-1)


def _gather_image(maps: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """maps (B, H, W) at integer pixels yi, xi (B, ...) -> (B, ...)."""
    b, _, w = maps.shape
    flat = (yi * w + xi).reshape(b, -1)
    return torch.gather(maps.reshape(b, -1), 1, flat).reshape(yi.shape)


def _depth_grid_centers(boxes, depth, K, p):
    """The grid of p points along the diagonal of each box shrunk by a quarter
    on every side, unprojected through the depth map by angles (reference
    :352-375). -> (x, y, z_tmp) each (B, N, p)."""
    h, w = depth.shape[-2:]
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    x_lo, x_hi = boxes[..., 0] + bw / 4, boxes[..., 2] - bw / 4
    y_lo, y_hi = boxes[..., 1] + bh / 4, boxes[..., 3] - bh / 4
    t = linspace(0.0, 1.0, p, device=boxes.device)
    xg = x_lo[..., None] + t * (x_hi - x_lo)[..., None]
    yg = y_lo[..., None] + t * (y_hi - y_lo)[..., None]
    xi = torch.round(xg).long().clamp(0, w - 1)
    yi = torch.round(yg).long().clamp(0, h - 1)
    d = _gather_image(depth, yi, xi)

    Kb = K[:, None, None]
    opp_x = xg - Kb[..., 0, 2]
    opp_y = yg - Kb[..., 1, 2]
    adj = Kb[..., 0, 0]
    angle_x = torch.atan2(opp_x, adj)
    dx_cam = torch.sqrt(opp_x * opp_x + adj * adj)
    angle_d = torch.atan2(opp_y, dx_cam)
    y = d * torch.sin(angle_d)
    dx = torch.sqrt(torch.clamp(d * d - y * y, min=0.0))
    x = dx * torch.sin(angle_x)
    z_tmp = torch.sqrt(torch.clamp(dx * dx - x * x, min=0.0))
    return x, y, z_tmp


def _refined_center(draws, x, y, z_tmp, l):
    """Centres drawn about the fitted linear refinement of the grid's medians
    (x: 1.15 x, y: 1.1 y, z: 0.85 z + 0.35), spread by its deviations."""
    x_new = sample_normal_in_range(draws["x"], 1.15 * _median(x) + 0.0, _std(x) * 1.2)
    y_new = sample_normal_in_range(draws["y"], 1.1 * _median(y) + 0.0, _std(y) * 0.8)
    z_shift = z_tmp + l / 2
    z_new = sample_normal_in_range(draws["z"], 0.85 * _median(z_shift) + 0.35, _std(z_shift) * 1.2)
    return x_new, y_new, z_new


def _prior_dims(draws, prior_mean, prior_std):
    """(w, h, l) from the category's prior, truncated (reference :377-383)."""
    m, s = prior_mean.unbind(-1), prior_std.unbind(-1)
    w = sample_normal_in_range(draws["w"], m[0], s[0], MIN_PROP_S, m[0] + 2 * s[0])
    h = sample_normal_in_range(draws["h"], m[1], s[1] * 1.1, MIN_PROP_S, m[1] + 2.2 * s[1])
    l = sample_normal_in_range(draws["l"], m[2], s[2], MIN_PROP_S, m[2] + 2 * s[2])
    return w, h, l


def _uniform_dims(draws):
    return tuple(rescale_interval(draws[k], MIN_PROP_S, 2) for k in ("w", "h", "l"))


def _pixel_to_norm(v, dim: int, norm: float):
    return (v - 0.5 * dim) * (norm / dim)


def _xy_patch(boxes, im_shape, p):
    """x and y spread evenly across the shrunk box in normalised image units."""
    bw = boxes[..., 2] - boxes[..., 0]
    bh = boxes[..., 3] - boxes[..., 1]
    x_lo = _pixel_to_norm(boxes[..., 0] + bw / 4, im_shape[0], 3.0)
    x_hi = _pixel_to_norm(boxes[..., 2] - bw / 4, im_shape[0], 3.0)
    y_lo = _pixel_to_norm(boxes[..., 1] + bh / 4, im_shape[1], 2.0)
    y_hi = _pixel_to_norm(boxes[..., 3] - bh / 4, im_shape[1], 2.0)
    t = linspace(0.0, 1.0, p, device=boxes.device)
    return x_lo[..., None] + t * (x_hi - x_lo)[..., None], y_lo[..., None] + t * (y_hi - y_lo)[..., None]


def _propose_random(d, boxes, depth, pm, ps, im_shape, K, p, normal):
    x = d["x"] * 4 - 2
    y = d["y"] * 2 - 1
    z = d["z"] * 4 + 1
    return (x, y, z, *_uniform_dims(d), randn_orthobasis(d["R"]))


def _propose_xy_patch(d, boxes, depth, pm, ps, im_shape, K, p, normal):
    x, y = _xy_patch(boxes, im_shape, p)
    z = d["z"] * 4 + 1
    return (x, y, z, *_uniform_dims(d), randn_orthobasis(d["R"]))


def _propose_z(d, boxes, depth, pm, ps, im_shape, K, p, normal):
    x, y = _xy_patch(boxes, im_shape, p)
    h_im, w_im = depth.shape[-2:]
    yy = torch.arange(h_im, device=depth.device)[:, None]
    xx = torch.arange(w_im, device=depth.device)[None, :]
    bx = boxes[..., None, None, :]
    in_box = (yy >= bx[..., 1]) & (yy < bx[..., 3]) & (xx >= bx[..., 0]) & (xx < bx[..., 2])  # (B, N, H, W)
    vals = torch.where(in_box, depth[:, None], torch.full_like(depth[:, None], math.nan))
    q = nanquantile(vals.flatten(-2), (0.1, 0.9))
    z = linspace(q[..., 0].contiguous(), q[..., 1].contiguous(), p)
    return (x, y, z, *_uniform_dims(d), randn_orthobasis(d["R"]))


def _propose_random_dim(d, boxes, depth, pm, ps, im_shape, K, p, normal):
    xg, yg, z_tmp = _depth_grid_centers(boxes, depth, K, p)
    w, h, l = _uniform_dims(d)
    x, y, z = _refined_center(d, xg, yg, z_tmp, l)
    return x, y, z, w, h, l, randn_orthobasis(d["R"])


def _propose_aspect_ratio(d, boxes, depth, pm, ps, im_shape, K, p, normal):
    xg, yg, z_tmp = _depth_grid_centers(boxes, depth, K, p)
    w = rescale_interval(d["w"], MIN_PROP_S, 2)
    ratios = _ratios(w.device)
    h = w * ratios[d["r1"]][..., None]
    l = w * ratios[d["r2"]][..., None]
    x, y, z = _refined_center(d, xg, yg, z_tmp, l)
    return x, y, z, w, h, l, randn_orthobasis(d["R"])


def _ratios(device) -> torch.Tensor:
    """``RATIOS`` as f32 on ``device``, filled there: a copy from the host
    would wait for the card."""
    out = torch.zeros(len(RATIOS), dtype=torch.float32, device=device)
    for i, r in enumerate(RATIOS):
        out[i] = r
    return out


def _propose_random_rotation(d, boxes, depth, pm, ps, im_shape, K, p, normal):
    xg, yg, z_tmp = _depth_grid_centers(boxes, depth, K, p)
    w, h, l = _prior_dims(d, pm, ps)
    x, y, z = _refined_center(d, xg, yg, z_tmp, l)
    return x, y, z, w, h, l, randn_orthobasis(d["R"])


def _propose(d, boxes, depth, pm, ps, im_shape, K, p, normal):
    """The method (reference :338-424)."""
    xg, yg, z_tmp = _depth_grid_centers(boxes, depth, K, p)
    w, h, l = _prior_dims(d, pm, ps)
    x, y, z = _refined_center(d, xg, yg, z_tmp, l)
    if normal is None:
        R = randn_orthobasis(d["R"])
    else:
        bases = orthobasis_from_normal(normal, linspace(0.0, math.pi, YAW_BINS, device=normal.device))  # (B, 36, 3, 3)
        b = bases.shape[0]
        R = torch.gather(bases.reshape(b, 1, YAW_BINS, 9).expand(b, d["yaw"].shape[1], YAW_BINS, 9), 2,
                         d["yaw"][..., None].expand(*d["yaw"].shape, 9)).reshape(*d["yaw"].shape, 3, 3)
    return x, y, z, w, h, l, R


PROPOSAL_FUNCS = {
    "random": _propose_random,
    "xy": _propose_xy_patch,
    "z": _propose_z,
    "dim": _propose_random_dim,
    "aspect": _propose_aspect_ratio,
    "rotation": _propose_random_rotation,
    "propose": _propose,
}


def propose_batch(draws: Dict[str, torch.Tensor], name: str, reference_boxes: torch.Tensor, depth: torch.Tensor,
                  prior_means: torch.Tensor, prior_stds: torch.Tensor, im_shape, K: torch.Tensor,
                  number_of_proposals: int = 1000, ground_normal: Optional[torch.Tensor] = None) -> Cubes:
    """(B, N, P) cubes from sampler ``name``: reference boxes (B, N, 4) XYXY
    at network resolution, depth maps (B, H, W), prior means and deviations
    (B, N, 3), im_shape (w, h), intrinsics at network resolution (B, 3, 3),
    ground normals (B, 3) or None, and the sampler's ``draws``."""
    x, y, z, w, h, l, R = PROPOSAL_FUNCS[name](draws, reference_boxes, depth, prior_means, prior_stds, im_shape,
                                               K, number_of_proposals, ground_normal)
    return Cubes(torch.cat([torch.stack([x, y, z, w, h, l], dim=-1), R.flatten(-2)], dim=-1))


def gt_in_norm_range(rng, gt):
    return (gt - rng[0]) / (rng[1] - rng[0]).abs()


def statistics(gt_cubes: torch.Tensor, cubes: Cubes) -> torch.Tensor:
    """Where each ground truth (..., 15) falls inside its proposals' (..., P,
    15) ranges (reference :427-445): (..., 9), the six parameters' positions
    between the proposals' least and greatest values, and the Euler angles
    over (pi, pi / 2, pi)."""
    t = cubes.tensor[..., :6]
    lo, hi = t.amin(-2), t.amax(-2)
    stats6 = (gt_cubes[..., :6] - lo) / (hi - lo + 1e-9).abs()
    angles = matrix_to_euler(gt_cubes[..., 6:].reshape(*gt_cubes.shape[:-1], 3, 3))
    return torch.cat([stats6, torch.stack([angles[..., 0] / math.pi, angles[..., 1] / (math.pi / 2),
                                           angles[..., 2] / math.pi], dim=-1)], dim=-1)
