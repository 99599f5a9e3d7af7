"""BoxNet's propose-and-score path, the port vs the JAX package, f32 on the CPU.

The JAX samplers draw from a key tree; the port takes the same standard
variates as tensors. ``_replay`` draws them from the JAX key tree as the JAX
code splits it (per image: ground plane, proposals, random score; the
proposals' key over instances, then each sampler's own splits), so both
packages see the same numbers. Scene: two 64x96 images of a floor 1.2 m
below the camera and a unit cube 3 m away, three reference boxes each, 64
proposals a box. Tolerances:

* the seven samplers (``propose_batch``): 2e-5 relative and 2e-5 absolute.
  The port's erf, erfinv, atan2 and sums differ from XLA's in the last bits,
  and the truncated normals and the medians pass that on;
* every score against its JAX function on the same cubes: 1e-5 relative;
  the minimum-area rectangle's corners to 1e-4 pixels, the hull's order, the
  row intervals and the pixel counts exactly;
* ``propose_and_score``: every score to 1e-4 relative and 1e-4 absolute
  (the seg_mod score, intersection^5, to 1e-4 relative), the ground normal
  to 1e-6, IoU3D to 1e-4 absolute, and ``best_cubes`` equal to 1e-4 where
  the two largest combined scores of a box differ by more than 1e-4 of the
  largest;
* ``BoxNet`` in GT mode against ``threedod.models.boxnet.BoxNet``: the same;
* ``mabo_statistics`` and the 26 combinations: equal (the same numpy).
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import _torch_port as tp  # noqa: F401  (one torch thread)

import jax
import jax.numpy as jnp

H, W, N, P = 64, 96, 3, 64
SAMPLERS = ("random", "xy", "z", "dim", "aspect", "rotation", "propose")
SCORE_RTOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


# ---- the scene and the replayed draws ---------------------------------------------


def _scene(b=2):
    """Depth and ground maps (B, H, W), intrinsics (B, 3, 3), reference boxes
    (B, N, 4), prior means and deviations (B, N, 3), ground-truth cubes (B,
    N, 15): a floor at y = 1.2 and a unit cube at (0, 0.7, 3), the first box
    tight on the cube, the others shifted and on the floor."""
    rng = np.random.RandomState(3)
    depth, ground, K, boxes, gts = [], [], [], [], []
    for i in range(b):
        f, cx, cy = 70.0 + 8 * i, 48.0 - 2 * i, 32.0 + i
        vv = np.arange(H, dtype=np.float32)[:, None] + 0.5
        floor = np.where(vv > cy, f * 1.2 / np.maximum(vv - cy, 1e-6), 30.0).astype(np.float32)
        d = np.broadcast_to(floor, (H, W)).copy()
        x1, x2 = int(cx + f * -0.5 / 3), int(cx + f * 0.5 / 3)
        y1, y2 = int(cy + f * 0.2 / 3), int(cy + f * 1.2 / 3)
        d[y1:y2, x1:x2] = 3.0
        g = np.broadcast_to(vv > cy, (H, W)).astype(np.float32).copy()
        g[y1:y2, x1:x2] = 0.0
        d += rng.uniform(-0.01, 0.01, d.shape).astype(np.float32)
        bx = np.array([[x1, y1, x2, y2], [x1 + 9.5, y1 - 3, x2 + 14, y2 + 2.5], [5.0, 40.0, 30.5, 60.0]], np.float32)
        cube = np.concatenate([[0.0, 0.7, 3.0, 1.0, 1.0, 1.0], np.eye(3).ravel()])
        gt = np.stack([cube, cube + np.r_[0.4, 0, 0.3, 0.2, 0, 0, np.zeros(9)], cube + np.r_[-1.5, 0.5, 1, 0, 0, 0,
                                                                                            np.zeros(9)]])
        depth.append(d)
        ground.append(g)
        K.append(np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32))
        boxes.append(bx)
        gts.append(gt.astype(np.float32))
    pm = np.tile(np.array([[1.0, 1.0, 1.0], [0.6, 0.9, 0.6], [1.0, 0.7, 1.5]], np.float32), (b, 1, 1))
    ps = np.tile(np.array([[0.25, 0.25, 0.25], [0.2, 0.2, 0.2], [0.3, 0.2, 0.4]], np.float32), (b, 1, 1))
    return (np.stack(depth), np.stack(ground), np.stack(K), np.stack(boxes), pm, ps, np.stack(gts))


def _sampler_keys(name, k, with_normal):
    """{variate: (key, kind)} of one instance's sampler, split as the JAX
    sampler splits ``k``."""
    from threedod_torch.proposals.proposals import sampler_draws

    spec = sampler_draws(name, with_normal)
    n_split = {"random": 7, "xy": 5, "z": 4, "dim": 5, "aspect": 5, "rotation": 3, "propose": 4}[name]
    ks = jax.random.split(k, n_split)
    out, i = {}, 0
    for var, kind in spec:
        if kind == "truncated" or (kind == "normal" and var in "xyz"):
            group = ("w", "h", "l") if kind == "truncated" else ("x", "y", "z")
            sub = jax.random.split(ks[i], 3)
            out[var] = (sub[group.index(var)], kind)
            if var == group[-1]:
                i += 1
        elif var == "yaw":
            out[var] = (ks[3], kind)
        else:
            out[var] = (ks[i], kind)
            i += 1
    return out


def _replay_sampler(key, name, n, p, with_normal):
    """The sampler's variates (numpy, (n, ...)) the JAX ``propose_batch``
    draws from ``key``."""
    out = {}
    for k in jax.random.split(key, n):
        for var, (kk, kind) in _sampler_keys(name, k, with_normal).items():
            if kind in ("uniform", "truncated"):
                v = jax.random.uniform(kk, (p,))
            elif kind == "normal":
                v = jax.random.normal(kk, (p,))
            elif kind == "rotation":
                v = jax.random.normal(kk, (p, 3, 3))
            elif kind == "ratio":
                v = jax.random.randint(kk, (), 0, 7)
            else:
                v = jax.random.randint(kk, (p,), 0, 36)
            out.setdefault(var, []).append(np.asarray(v))
    return {var: np.stack(v) for var, v in out.items()}


def _replay_boxer(key, name, n, p, n_points, with_normal):
    """``boxer.BoxerDraws`` of one image from the JAX key ``propose_and_score`` splits."""
    k_plane, k_prop, k_rand = jax.random.split(key, 3)
    return (np.asarray(jax.random.randint(k_plane, (1000, 3), 0, n_points)),
            _replay_sampler(k_prop, name, n, p, with_normal), np.asarray(jax.random.uniform(k_rand, (n, p))))


def _stack_draws(per_image):
    from threedod_torch.models.boxer import BoxerDraws

    ransac, props, rand = zip(*per_image)
    return BoxerDraws(_t(np.stack(ransac)), {k: _t(np.stack([d[k] for d in props])) for k in props[0]},
                      _t(np.stack(rand)))


@pytest.fixture(scope="module")
def scene():
    return _scene()


# ---- geometry ---------------------------------------------------------------------




def test_rotations_hull_and_cubes():
    from threedod.geometry.hull import convex_hull_order as jhull
    from threedod.geometry.rotations import matrix_to_euler as jeuler, orthobasis_from_normal as jbasis
    from threedod.structures.cubes import Cubes as JCubes

    from threedod_torch.geometry.hull import convex_hull_order
    from threedod_torch.geometry.rotations import matrix_to_euler, orthobasis_from_normal
    from threedod_torch.structures.cubes import Cubes

    rng = np.random.RandomState(0)
    normals = rng.randn(4, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals[3] = [0.0, 0.6, 0.8]  # n.x = 0: the other perpendicular
    yaw = np.linspace(0, np.pi, 36).astype(np.float32)
    t = rng.randn(5, 7, 15).astype(np.float32)
    t[..., 3:6] = np.abs(t[..., 3:6]) + 0.1
    t[..., 2] += 6.0
    t[..., 6:] = np.asarray(jax.vmap(jax.vmap(lambda n: jbasis(n, jnp.zeros(1))[0]))(
        t[..., 6:9] / np.linalg.norm(t[..., 6:9], axis=-1, keepdims=True))).reshape(5, 7, 9)
    K = np.array([[80.0, 0, 48], [0, 80, 32], [0, 0, 1]], np.float32)
    pts = rng.uniform(0, 50, (40, 8, 2)).astype(np.float32)
    pts[0, 4:] = pts[0, :4]  # repeated points

    def jax_side(normals, t, pts):
        c = JCubes(t)
        return (jax.vmap(lambda n: jbasis(n, jnp.asarray(yaw)))(normals), jeuler(c.rotations),
                c.get_all_corners(), c.get_bube_corners(jnp.asarray(K), clamp=(W, H)), c.to_boxes2d(jnp.asarray(K)),
                c.get_volumes(), jax.vmap(jhull)(pts))

    ref = jax.jit(jax_side)(normals, t, pts)
    c = Cubes(_t(t))
    got = (orthobasis_from_normal(_t(normals), _t(yaw)), matrix_to_euler(c.rotations), c.get_all_corners(),
           c.get_bube_corners(_t(K), clamp=(W, H)), c.to_boxes2d(_t(K)), c.get_volumes(), convex_hull_order(_t(pts)))
    for name, g, r in zip(("basis", "euler", "corners", "bube", "boxes2d", "volumes"), got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got[-1].numpy(), ref[-1], err_msg="hull")
    assert (c.get_bube_corners(_t(K), clamp=(W, H))[..., 0] >= -47).all()
    both = Cubes.cat([c, Cubes.from_parts(c.centers, c.dimensions, c.rotations)], dim=0)
    assert torch.equal(both.tensor[5:], c.tensor)


# ---- the samplers --------------------------------------------------------------------


def test_samplers_match_propose_batch(scene):
    """Each of the seven samplers against the JAX ``propose_batch`` at N 3,
    P 64 on 64x96 maps, from the variates its key tree draws; ``propose``
    with and without a ground normal."""
    from threedod.proposals.proposals import propose_batch as jprop

    from threedod_torch.proposals.proposals import propose_batch

    depth, _, K, boxes, pm, ps, _ = scene
    normal = np.array([0.05, 0.99, -0.1], np.float32) / np.linalg.norm([0.05, 0.99, -0.1])
    keys = jax.random.split(jax.random.PRNGKey(11), 2)
    cases = [(s, False) for s in SAMPLERS] + [("propose", True)]

    def jax_side(depth, K, boxes, pm, ps, normal):
        out = []
        for name, with_normal in cases:
            one = lambda k, d, Ki, b, m, s: jprop(k, name, b, d, m, s, (W, H), Ki, P,  # noqa: E731
                                                  ground_normal=normal if with_normal else None).tensor
            out.append(jax.vmap(one)(keys, depth, K, boxes, pm, ps))
        return out

    refs = jax.jit(jax_side)(depth, K, boxes, pm, ps, normal)
    for (name, with_normal), ref in zip(cases, refs):
        draws = [_replay_sampler(k, name, N, P, with_normal) for k in keys]
        draws = {k: _t(np.stack([d[k] for d in draws])) for k in draws[0]}
        got = propose_batch(draws, name, _t(boxes), _t(depth), _t(pm), _t(ps), (W, H), _t(K), P,
                            ground_normal=_t(np.stack([normal] * 2)) if with_normal else None).tensor
        assert got.shape == (2, N, P, 15)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5,
                                   err_msg=f"{name} with_normal={with_normal}")
        if name in ("rotation", "propose"):
            dims = got[..., 3:6]
            w_hi = _t(pm)[..., None, 0] + 2 * _t(ps)[..., None, 0]
            assert (dims >= 0.05).all() and (dims[..., 0] <= w_hi + 1e-5).all()


def test_sampler_helpers():
    """The truncated normal, median, deviation, quantiles and linspace
    against ``jax.random.truncated_normal``, ``jnp.median`` (an even count),
    ``jnp.std``, ``jnp.nanquantile`` (a row without numbers gives NaN) and
    ``jnp.linspace``; ``statistics`` and ``gt_in_norm_range``."""
    from threedod.proposals.proposals import gt_in_norm_range as jnorm, statistics as jstats
    from threedod.structures.cubes import Cubes as JCubes

    from threedod_torch.proposals import proposals as pp
    from threedod_torch.structures.cubes import Cubes

    rng = np.random.RandomState(5)
    # the last interval is so far out that f32's erf is -1 at both ends:
    # there both land on a bound, and may pick different ones
    lo = np.array([-2.0, 0.5, -0.3, -3.0, -6.0], np.float32)
    hi = np.array([1.0, 3.0, -0.2, -2.5, -5.9], np.float32)
    x = rng.randn(4, 64).astype(np.float32)
    vals = rng.uniform(1, 5, (3, 50)).astype(np.float32)
    vals[1, 10:] = np.nan
    vals[2] = np.nan
    t = rng.randn(3, 64, 15).astype(np.float32)
    gt = rng.randn(3, 15).astype(np.float32)
    key = jax.random.PRNGKey(2)

    def jax_side(x, vals, t, gt, lo, hi, q0, q1):
        trunc = jnp.stack([jax.random.truncated_normal(key, lo[i], hi[i], (64,)) for i in range(5)])
        return (trunc, jax.random.uniform(key, (64,)), jnp.median(x, axis=-1), jnp.std(x, axis=-1),
                jnp.nanquantile(vals, jnp.asarray([0.1, 0.9]), axis=-1).T,
                jnp.linspace(q0, q1, 64), jnp.linspace(0.0, 1.0, 64), jnp.linspace(0.0, jnp.pi, 36),
                jnp.linspace(0.0, jnp.pi / 2, 90, endpoint=False),
                jstats(JCubes(gt[:, None]), JCubes(t)), jnorm((lo[:4], hi[:4]), gt[:, :4]))

    q0, q1 = np.float32(2.3456), np.float32(5.71234)
    (trunc, u, med, std, quant, ls, unit, yaw, rect, stats, norm) = jax.jit(jax_side)(x, vals, t, gt, lo, hi, q0, q1)
    got_trunc = pp.truncated_normal(_t(np.asarray(u))[None].expand(5, 64), _t(lo)[:, None].expand(5, 64),
                                    _t(hi)[:, None].expand(5, 64))
    np.testing.assert_allclose(got_trunc[:4].numpy(), trunc[:4], rtol=1e-5, atol=2e-6)
    assert (got_trunc > _t(lo)[:, None]).all() and (got_trunc < _t(hi)[:, None]).all()
    assert (trunc > lo[:, None]).all() and (trunc < hi[:, None]).all()
    np.testing.assert_array_equal(pp._median(_t(x)).numpy(), med)
    np.testing.assert_allclose(pp._std(_t(x)).numpy(), std, rtol=1e-6)
    got_q = pp.nanquantile(_t(vals), (0.1, 0.9)).numpy()
    np.testing.assert_allclose(got_q, quant, rtol=1e-6)  # XLA fuses the interpolation's sum into a multiply-add
    assert np.isnan(got_q[2]).all()
    np.testing.assert_allclose(pp.linspace(_t(q0), _t(q1), 64).numpy(), ls, rtol=0, atol=5e-7)
    for got, ref in ((pp.linspace(0.0, 1.0, 64), unit), (pp.linspace(0.0, math.pi, 36), yaw),
                     (pp.linspace(0.0, math.pi / 2, 90, endpoint=False), rect)):
        np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(pp.statistics(_t(gt), Cubes(_t(t))).numpy(), stats, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pp.gt_in_norm_range((_t(lo[:4]), _t(hi[:4])), _t(gt[:, :4])).numpy(), norm, rtol=1e-6)
    # the grid's pixel lookup rounds half to even, as jnp.round does
    halves = np.array([-1.5, -0.5, 0.5, 1.5, 2.5, 3.5], np.float32)
    np.testing.assert_array_equal(torch.round(_t(halves)).numpy(), np.asarray(jnp.round(halves)))


# ---- the scores ----------------------------------------------------------------------


def _score_inputs(scene):
    """Cubes (2, N, P, 15) of the JAX ``propose`` sampler, their clamped
    projected corners, and masks: the filled boxes, and for the second image's
    last box a tilted ellipse (a rectangle at an angle)."""
    from threedod.models.boxer import box_fill_masks as jfill
    from threedod.proposals.proposals import propose_batch as jprop

    depth, _, K, boxes, pm, ps, _ = scene
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    cubes = np.asarray(jax.jit(jax.vmap(lambda k, d, Ki, b, m, s: jprop(k, "propose", b, d, m, s, (W, H), Ki, P)
                                        .tensor))(keys, depth, K, boxes, pm, ps))
    masks = np.array(jax.jit(jax.vmap(lambda b: jfill(b, H, W)))(boxes))
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    u, v = (xx - 50) * np.cos(0.5) + (yy - 30) * np.sin(0.5), -(xx - 50) * np.sin(0.5) + (yy - 30) * np.cos(0.5)
    masks[1, 2] = ((u / 20) ** 2 + (v / 8) ** 2 <= 1).astype(np.float32)
    return cubes, masks


def test_scores_match(scene):
    """Every score function against its JAX counterpart on the same cubes."""
    from threedod.scoring import scorefunction as js
    from threedod.structures.cubes import Cubes as JCubes

    from threedod_torch.models.boxer import ground_plane_from_depth
    from threedod_torch.scoring import scorefunction as ts
    from threedod_torch.structures.cubes import Cubes, corners_to_boxes

    depth, ground, K, boxes, pm, ps, _ = scene
    cubes, masks = _score_inputs(scene)
    idx = np.stack([np.asarray(jax.random.randint(k, (1000, 3), 0, 12 * 19))
                    for k in jax.random.split(jax.random.PRNGKey(9), 2)])
    _, points, pc_valid = ground_plane_from_depth(_t(idx), _t(depth), _t(K), _t(ground))
    c = Cubes(_t(cubes))
    bube = c.get_bube_corners(_t(K)[:, None, None], clamp=(W, H))
    prop = corners_to_boxes(bube)

    def jax_side(cubes, masks, points, pc_valid, bube, prop, boxes, pm, ps):
        one = lambda m, bb, b, pb, mu, sd: dict(  # noqa: E731
            iou=js.score_iou(b, pb), rect=js.min_area_rect(m), corner=js.score_corners(m, bb),
            seg=js.score_segmentation(m, bb), mod=js.score_mod_segmentation(m, bb),
            pair=js.score_segmentation_pair(m, bb), ratios=js.score_ratios(b, pb),
            rows=jax.vmap(lambda q: js.hull_row_intervals(q / 4, H // 4))(bb))
        out = jax.vmap(jax.vmap(one))(masks, bube, boxes, prop, pm, ps)
        out["dims"] = jax.vmap(jax.vmap(js.score_dimensions))(pm, ps, cubes[..., 3:6], boxes, prop)
        out["pc"] = jax.vmap(lambda p, c, v: js.score_point_cloud(p, JCubes(c), v))(points, cubes, pc_valid)
        out["combined"] = js.combined_score(out["iou"], out["dims"], out["corner"])
        return out

    ref = jax.jit(jax_side)(cubes, masks, points.numpy(), pc_valid.numpy(), bube.numpy(), prop.numpy(), boxes, pm, ps)
    m, b = _t(masks), _t(boxes)
    got = dict(iou=ts.score_iou(b, prop), rect=ts.min_area_rect(m), corner=ts.score_corners(m, bube),
               seg=ts.score_segmentation(m, bube), mod=ts.score_mod_segmentation(m, bube),
               pair=ts.score_segmentation_pair(m, bube), ratios=ts.score_ratios(b, prop),
               rows=ts.hull_row_intervals(bube / 4, H // 4),
               dims=ts.score_dimensions(_t(pm), _t(ps), c.dimensions, b, prop),
               pc=ts.score_point_cloud(points, c, pc_valid))
    got["combined"] = ts.combined_score(got["iou"], got["dims"], got["corner"])
    for name in got:
        g, r = got[name], ref[name]
        if isinstance(g, tuple):
            for gi, ri in zip(g, r):
                np.testing.assert_allclose(gi.numpy(), np.asarray(ri), rtol=1e-5, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4 if name == "rect" else 1e-6,
                                       err_msg=name)
    assert float(got["pc"].max()) > 0 and float(got["seg"].max()) > 0.3
    # the tilted ellipse's rectangle is tilted
    rect = got["rect"][1, 2].numpy()
    assert abs(rect[0, 1] - rect[1, 1]) > 1.0


# ---- propose_and_score and BoxNet ----------------------------------------------------------


def _check_output(got, ref, what):
    """A port BoxerOutput against the JAX one (numpy leaves, stacked over images)."""
    for name, r in ref.scores.items():
        g = got.scores[name].numpy()
        np.testing.assert_allclose(g, r, rtol=SCORE_RTOL, atol=0 if name == "seg_mod" else 1e-4,
                                   err_msg=f"{what}: {name}")
    np.testing.assert_allclose(got.normal.numpy(), ref.normal, rtol=0, atol=1e-6, err_msg=f"{what}: normal")
    if ref.iou3d is not None:
        np.testing.assert_allclose(got.iou3d.numpy(), ref.iou3d, rtol=0, atol=1e-4, err_msg=f"{what}: iou3d")
    top2 = np.sort(ref.scores["combined"], axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > SCORE_RTOL * np.abs(top2[..., 1])
    assert clear.mean() > 0.5, f"{what}: too few boxes with a clear best proposal"
    np.testing.assert_allclose(got.best_cubes.numpy()[clear], ref.best_cubes[clear], rtol=1e-4, atol=1e-4,
                               err_msg=f"{what}: best_cubes")
    np.testing.assert_allclose(got.best_scores.numpy(), ref.best_scores, rtol=SCORE_RTOL, atol=1e-6)


@pytest.mark.parametrize("name", ["propose", "z"])
def test_propose_and_score_matches(scene, name):
    """``propose_and_score`` on both images at once against the JAX function
    image by image, from the variates of the JAX key."""
    from threedod.models.boxer import box_fill_masks as jfill, propose_and_score as jpas
    from threedod.structures.cubes import Cubes as JCubes

    from threedod_torch.models.boxer import box_fill_masks, propose_and_score

    depth, ground, K, boxes, pm, ps, gts = scene
    keys = jax.random.split(jax.random.PRNGKey(21), 2)
    hw = np.array([[H, W], [H, W - 8]], np.int32)

    def jax_side(keys, boxes, pm, ps, depth, ground, K, gts, hw):
        def one(k, b, m, s, d, g, Ki, gt, v):
            out = jpas(k, name, b, jfill(b, H, W), m, s, d, Ki, (W, H), P, ground_map=g, gt_cubes=JCubes(gt[:, None]),
                       valid_hw=v)
            return out._replace(cubes=out.cubes.tensor)
        return jax.vmap(one)(keys, boxes, pm, ps, depth, ground, K, gts, hw)

    ref = jax.tree_util.tree_map(np.asarray, jax.jit(jax_side)(keys, boxes, pm, ps, depth, ground, K, gts, hw))
    draws = _stack_draws([_replay_boxer(k, name, N, P, 12 * 19, name == "propose") for k in keys])
    got = propose_and_score(draws, name, _t(boxes), box_fill_masks(_t(boxes), H, W), _t(pm), _t(ps), _t(depth),
                            _t(K), (W, H), P, ground_maps=_t(ground), gt_cubes=_t(gts), valid_hw=_t(hw))
    np.testing.assert_allclose(got.cubes.tensor.numpy(), ref.cubes, rtol=2e-5, atol=2e-5)
    _check_output(got, ref, name)
    assert ref.iou3d[:, 0].max() > 0.25  # the sampler lands near the cube


def test_boxnet_gt_mode_matches(scene):
    """``BoxNet`` in GT mode against ``threedod.models.boxnet.BoxNet`` on a
    batch of the scene (the ground-truth slots: three boxes and a padding
    slot, one box an ignore region), with the variates of the JAX key."""
    _gt_mode_case(scene)


def test_boxnet_gt_mode_with_masks(scene):
    """The same with instance masks given (uint8, as the loader ships them):
    the ellipse inside each box, so the segmentation scores differ from the
    filled boxes'."""
    boxes = scene[3]
    ys, xs = np.arange(H)[:, None] + 0.5, np.arange(W)[None, :] + 0.5
    masks = np.zeros((2, 4, H, W), np.uint8)
    for i in range(2):
        for j in range(N):
            x1, y1, x2, y2 = boxes[i, j]
            masks[i, j] = ((xs - (x1 + x2) / 2) / ((x2 - x1) / 2)) ** 2 + ((ys - (y1 + y2) / 2) / (
                (y2 - y1) / 2)) ** 2 <= 1
    fills = _gt_mode_case(scene, masks)
    assert fills < 0.9  # the segmentation scores are not the filled boxes'


def _gt_mode_case(scene, masks=None):
    """Both BoxNets on the scene's batch; returns the share of the kept
    slots' seg scores that equal those of the filled boxes."""
    from threedod.config import Config as JaxConfig
    from threedod.data.batch import Batch as JBatch, GroundTruth as JGT
    from threedod.models import build_model as jbuild

    from threedod_torch.config import Config
    from threedod_torch.data.batch import Batch, GroundTruth
    from threedod_torch.models.meta_arch import build_model

    depth, ground, K, boxes, pm, ps, gts = scene
    m = 4
    b2 = np.zeros((2, m, 4), np.float32)
    b2[:, :N] = boxes
    classes = np.array([[1, 3, -1, -1], [0, 2, 4, -1]], np.int32)
    valid = np.array([[1, 1, 1, 0], [1, 1, 1, 0]], bool)
    b3 = np.zeros((2, m, 9), np.float32)
    b3[:, :N, 6:9] = gts[..., :3]
    b3[:, :N, 3:6] = gts[..., 3:6]
    poses = np.tile(np.eye(3, dtype=np.float32), (2, m, 1, 1))
    poses[:, :N] = gts[..., 6:].reshape(2, N, 3, 3)
    ratio = np.array([1.5, 2.0], np.float32)
    Korig = K.copy()
    Korig[:, :2] *= ratio[:, None, None]
    hw = np.array([[H, W], [H - 4, W]], np.int32)
    img = np.zeros((2, H, W, 3), np.uint8)
    priors = {"priors_dims_per_cat": np.stack([np.stack([pm[0, i % N], ps[0, i % N]]) for i in range(5)])}

    jcfg, pcfg = JaxConfig(), Config()
    for cfg in (jcfg, pcfg):
        cfg.model.meta_architecture = "BoxNet"
        cfg.model.roi_heads.num_classes = 5
        cfg.model.roi_cube_head.number_of_proposals = P
        cfg.model.dtype = "float32"
        cfg.shapes.canvas_height, cfg.shapes.canvas_width, cfg.shapes.max_gt = H, W, m
    jmodel = jbuild(jcfg, priors={k: jnp.asarray(v) for k, v in priors.items()})
    key = jax.random.PRNGKey(8)
    jbatch = JBatch(image=jnp.asarray(img), image_hw=jnp.asarray(hw), K=jnp.asarray(Korig),
                    im_scale_ratio=jnp.asarray(ratio), image_id=jnp.arange(2, dtype=jnp.int32),
                    gt=JGT(*(jnp.asarray(a) for a in (b2, classes, b3, poses, valid))),
                    depth_map=jnp.asarray(depth, jnp.float16), ground_map=jnp.asarray(ground, jnp.uint8))

    def jax_side(batch):
        out, bx, cls, v = jmodel.apply({}, batch, proposal_function="propose", key=key,
                                       masks=None if masks is None else jnp.asarray(masks))
        det = jmodel.apply({}, out, bx, cls, v, batch.im_scale_ratio, method=lambda mm, *a: mm.to_detections(*a))
        return out._replace(cubes=out.cubes.tensor), bx, cls, v, det

    ref, rbx, rcls, rv, rdet = jax.tree_util.tree_map(np.asarray, jax.jit(jax_side)(jbatch))
    # the padding slot's combined scores are all 0: both take the first proposal
    assert (ref.scores["combined"][:, 3] == 0).all()
    np.testing.assert_array_equal(ref.best_cubes[:, 3], ref.cubes[:, 3, 0])
    model = build_model(pcfg, priors=priors)
    batch = Batch(image=_t(img), image_hw=_t(hw), K=_t(Korig), im_scale_ratio=_t(ratio),
                  image_id=torch.arange(2, dtype=torch.int32),
                  gt=GroundTruth(*(_t(a) for a in (b2, classes, b3, poses, valid))),
                  depth_map=_t(depth).half(), ground_map=_t(ground).to(torch.uint8))
    n_points = (H // 5) * (W // 5)
    draws = _stack_draws([_replay_boxer(k, "propose", m, P, n_points, True) for k in jax.random.split(key, 2)])
    pmasks = None if masks is None else _t(masks)
    with torch.no_grad():
        got, bx, cls, v = model(batch, "propose", masks=pmasks, draws=draws)
        fills, _, _, _ = model(batch, "propose", draws=draws)
    assert torch.equal(got.best_cubes[:, 3], got.cubes.tensor[:, 3, 0])
    np.testing.assert_array_equal(v.numpy(), rv)
    np.testing.assert_array_equal(cls.numpy(), rcls)
    assert v.sum() == 5
    keep = rv  # the padding and ignore slots' scores are not compared
    ref = ref._replace(scores={k: s[keep] for k, s in ref.scores.items()}, iou3d=ref.iou3d[keep],
                       best_cubes=ref.best_cubes[keep], best_scores=ref.best_scores[keep])
    got = got._replace(scores={k: s[_t(keep)] for k, s in got.scores.items()}, iou3d=got.iou3d[_t(keep)],
                       best_cubes=got.best_cubes[_t(keep)], best_scores=got.best_scores[_t(keep)])
    _check_output(got, ref, "BoxNet GT")
    det = model.to_detections(*model(batch, "propose", masks=pmasks, draws=draws), batch.im_scale_ratio)
    for name in ("boxes", "scores", "classes", "valid", "center_2d"):
        np.testing.assert_allclose(getattr(det, name).numpy(), getattr(rdet, name), rtol=SCORE_RTOL, atol=1e-5,
                                   err_msg=name)
    assert det.corners3d.shape == (2, m, 8, 3)
    return (fills.scores["seg"][_t(keep)] == got.scores["seg"]).float().mean().item()


# ---- MABO ----------------------------------------------------------------------------------


def test_mabo_statistics_match():
    """``mabo_statistics``, ``accumulate_scores`` and the 26 combinations
    against the JAX package's on one score dict."""
    from threedod.models import boxer as jb

    from threedod_torch.models import boxer as tb

    rng = np.random.RandomState(0)
    scores = {n: rng.rand(5, 40) for n in tb.SCORE_NAMES}
    iou3d = rng.rand(5, 40)
    valid = np.array([True, False, True, True, False])
    assert tb.SCORE_NAMES == jb.SCORE_NAMES and tb.COMBINATION_DEFS == jb.COMBINATION_DEFS
    assert len(tb.COMBINATION_DEFS) == 26
    curves, combos = tb.mabo_statistics(scores, iou3d, valid)
    rcurves, rcombos = jb.mabo_statistics(scores, iou3d, valid)
    assert set(curves) == set(rcurves) and combos.shape == (3, 26)
    for k in curves:
        np.testing.assert_array_equal(curves[k], rcurves[k])
    np.testing.assert_array_equal(combos, rcombos)
    np.testing.assert_array_equal(tb.accumulate_scores(scores["seg"][0], iou3d[0]),
                                  jb.accumulate_scores(scores["seg"][0], iou3d[0]))
    empty_curves, empty = tb.mabo_statistics(scores, iou3d, np.zeros(5, bool))
    assert empty.shape == (0, 26) and empty_curves["IoU2D"].shape == (0, 40)
