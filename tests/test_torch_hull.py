"""The soft polygon fill, the convex-hull mask and the focal loss of the weak
``segmentation`` loss: the port vs the JAX package, f32 on the CPU.

The same numpy polygons and points (seeded) go through each JAX function,
under one ``jax.jit`` each, and through its counterpart in
``threedod_torch``:

* ``fill_polygon_soft`` forward to 1e-6 absolute and its vertex gradient
  (the port's autograd Function against the JAX ``custom_vjp``) to 1e-5 of
  the largest entry, on float polygons, on polygons with integer-lattice
  vertices (where s lands exactly on the clip's bounds 0 and 1, and the
  gradient there is 0.5, not ``torch.clamp``'s 1) and on polygons with
  repeated vertices (degenerate edges, one polygon a single point);
* the backward keeps the (N, P, 2) polygons and nothing larger;
* ``convex_hull_mask`` on the projected corners of cubes, forward and the
  gradient to the corners, at the same tolerances;
* ``sigmoid_focal_loss`` to 1e-6 with every reduction, and its gradient to
  the targets (the hull fill, in the loss) to 1e-5 of the largest entry.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp  # noqa: F401  (one torch thread)

import jax

H, W = 20, 28


def _t(a):
    return torch.from_numpy(np.array(a))


def _polygons(kind: str, n: int = 24, seed: int = 0) -> np.ndarray:
    """(n, 8, 2) counter-clockwise convex polygons (x, y)."""
    from threedod_torch.geometry.hull import convex_hull_order

    rng = np.random.RandomState(seed)
    centre = rng.uniform([2, 2], [W - 2, H - 2], (n, 1, 2))
    if kind == "lattice":  # integer vertices: s is an integer at every pixel
        pts = np.round(centre + rng.uniform(-9, 9, (n, 8, 2)))
    else:
        pts = centre + rng.uniform(-9, 9, (n, 8, 2))
    poly = convex_hull_order(_t(pts.astype(np.float32))).numpy()
    if kind == "degenerate":  # repeated vertices; the last polygon one point
        poly[:, 3] = poly[:, 2]
        poly[:, 6] = poly[:, 5]
        poly[-1] = poly[-1, :1]
    return poly


def _jax_fill_and_grad(poly, g):
    from threedod.geometry.hull import fill_polygon_soft

    fill = jax.vmap(lambda p: fill_polygon_soft(p, H, W))
    out, vjp = jax.vjp(fill, poly)
    return out, vjp(g)[0]


@pytest.mark.parametrize("kind", ["float", "lattice", "degenerate"])
def test_fill_polygon_soft(kind):
    from threedod_torch.geometry.hull import fill_polygon_soft

    poly = _polygons(kind, seed={"float": 0, "lattice": 1, "degenerate": 2}[kind])
    g = np.random.RandomState(3).randn(len(poly), H, W).astype(np.float32)
    ref, ref_grad = jax.device_get(jax.jit(_jax_fill_and_grad)(poly, g))
    p = _t(poly).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        out = fill_polygon_soft(p, H, W)
    assert saved == [tuple(poly.shape)]  # the polygons alone, nothing (P, H, W)-sized
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-6)
    assert 0 < ref.mean() < 1 and (ref == 1).any() and (ref == 0).any()
    tp.close(p.grad.numpy(), ref_grad, tol=1e-5)
    if kind == "lattice":
        # the polygons' edges pass through pixel centres: s is exactly 0 or 1
        # there, where only the clip's 0.5 gives JAX's gradient
        ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
        v1, v2 = poly, np.roll(poly, -1, axis=1)
        e = v2 - v1
        s = (e[..., 0, None, None] * (ys - v1[..., 1, None, None])
             - e[..., 1, None, None] * (xs - v1[..., 0, None, None]))
        assert (s == 0).sum() > 100 and (s == 1).sum() > 100
    if kind == "degenerate":
        np.testing.assert_array_equal(out.detach().numpy()[-1], 1.0)
        np.testing.assert_array_equal(p.grad.numpy()[-1], 0.0)


def test_fill_polygon_soft_leading_dims():
    from threedod_torch.geometry.hull import fill_polygon_soft

    poly = _t(_polygons("float", n=6))
    flat = fill_polygon_soft(poly, H, W)
    assert torch.equal(fill_polygon_soft(poly.reshape(2, 3, 8, 2), H, W), flat.reshape(2, 3, H, W))


def test_convex_hull_mask_on_projected_cubes():
    from threedod.geometry.cuboids import cuboid_verts as jverts, project_points as jproject
    from threedod.geometry.hull import convex_hull_mask as jmask

    from threedod_torch.geometry.cuboids import cuboid_verts, project_points
    from threedod_torch.geometry.hull import convex_hull_mask

    rng = np.random.RandomState(4)
    n, hm, wm = 32, 24, 32
    K = np.tile(np.array([[60.0, 0, 64], [0, 60.0, 48], [0, 0, 1]], np.float32), (n, 1, 1))
    z = rng.uniform(2, 6, n)
    centre = np.stack([rng.uniform(-1.5, 1.5, n) * z / 3, rng.uniform(-1, 1, n) * z / 3, z], -1)
    box = np.concatenate([centre, rng.uniform(0.4, 2.0, (n, 3))], -1).astype(np.float32)
    q = rng.randn(n, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, zq = q.T
    R = np.stack([np.stack([1 - 2 * (y * y + zq * zq), 2 * (x * y - zq * w), 2 * (x * zq + y * w)], -1),
                  np.stack([2 * (x * y + zq * w), 1 - 2 * (x * x + zq * zq), 2 * (y * zq - x * w)], -1),
                  np.stack([2 * (x * zq - y * w), 2 * (y * zq + x * w), 1 - 2 * (x * x + y * y)], -1)], -2)
    R = R.astype(np.float32)
    g = rng.randn(n, hm, wm).astype(np.float32)

    def jax_side(box, R, K, g):
        pts = jproject(K, jverts(box, R))[..., :2] / 4.0  # the mask grid of a 96x128 canvas
        out, vjp = jax.vjp(jax.vmap(lambda p: jmask(p, hm, wm)), pts)
        return pts, out, vjp(g)[0]

    pts, ref, ref_grad = jax.device_get(jax.jit(jax_side)(box, R, K, g))
    got_pts = project_points(_t(K), cuboid_verts(_t(box), _t(R)))[..., :2] / 4.0
    np.testing.assert_allclose(got_pts.numpy(), pts, rtol=1e-6, atol=1e-5)
    p = _t(pts).requires_grad_(True)
    out = convex_hull_mask(p, hm, wm)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0, atol=1e-6)
    assert (ref.reshape(n, -1).max(1) > 0.5).sum() > n // 2  # most hulls cover pixels
    tp.close(p.grad.numpy(), ref_grad, tol=1e-5)


@pytest.mark.parametrize("reduction,alpha", [("none", 0.25), ("sum", 0.25), ("mean", 0.25), ("none", -1.0)])
def test_sigmoid_focal_loss(reduction, alpha):
    from threedod.ops.losses import sigmoid_focal_loss as jfocal

    from threedod_torch.ops.losses import sigmoid_focal_loss

    rng = np.random.RandomState(5)
    logits = (rng.randn(6, 16, 20) * 3).astype(np.float32)
    logits[0] = rng.rand(16, 20) > 0.5  # a 0/1 mask as the logits, as the weak loss passes it
    targets = np.clip(rng.uniform(-0.3, 1.3, (6, 16, 20)), 0, 1).astype(np.float32)  # exact 0 and 1 too
    g = np.asarray(rng.randn(*(() if reduction != "none" else logits.shape)), np.float32)

    def jax_side(x, t, g):
        out, vjp = jax.vjp(lambda tt: jfocal(x, tt, alpha=alpha, reduction=reduction), t)
        return out, vjp(g)[0]

    ref, ref_grad = jax.device_get(jax.jit(jax_side)(logits, targets, g))
    t = _t(targets).requires_grad_(True)
    out = sigmoid_focal_loss(_t(logits), t, alpha=alpha, reduction=reduction)
    out.backward(_t(g))
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-6, atol=1e-6)
    tp.close(t.grad.numpy(), ref_grad, tol=1e-5)
