"""Weak Cube R-CNN's modules, the port vs the JAX package, f32 on the CPU.

The same numpy inputs (seeded) go through each JAX function, under one
``jax.jit`` each, and through its counterpart in ``threedod_torch``:

* ``project_cube_boxes``, ``giou_loss`` and ``pose_alignment_loss``: 1e-6
  relative (sums of a few products in another order);
* ``normal_to_rotation`` and ``disambiguate_ground_normal``: 1e-6 absolute on
  unit vectors;
* the z search's 50 steps bit-equal to ``jnp.linspace``, and
  ``z_search_loss`` to 1e-6: the loss is half of |z - z_best|, so a
  different best step would move it by 0.05;
* ``masked_quantile_batch`` and the two window gathers: bit-equal (they
  select values; the JAX radix bisection and one-hot products, the port's
  sort and gathers);
* the RANSAC fit with the hypothesis indices ``jax.random.randint`` drew, on
  the fixture's depth and ground maps at Base_Synth's 384x512 canvas: the
  plane to 1e-6 and the ground normal to 1e-6;
* ``ROIHeads3DScore.weak_cube_losses`` on one set of cube outputs with the
  fixture's maps, box-filled masks and the hypotheses the JAX key draws:
  every loss and metric of the 7-loss menu and of the other three losses
  (``pose_ground2``, ``z_pseudo_gt_center``, and ``depth`` without masks) to
  1e-5 relative; the 8-loss menu (the 7 and ``segmentation``) with ellipse
  masks inside the boxes, as SAM's would be, not the filled boxes.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp  # noqa: F401  (one torch thread)

import jax
import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL = 1e-6
CANVAS = (384, 512)  # Base_Synth's, where the weak path's maps are fitted
MENU = ("dims", "pose_alignment", "pose_ground", "iou", "z", "z_pseudo_gt_patch", "depth")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _rotations(rng, shape):
    q = rng.randn(*shape, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2).astype(np.float32)


def _cubes(n, seed=0, w=512, h=384):
    """(centers, dims, poses, Ks, 2D boxes) of n cubes in front of a 500 px
    camera, a few of them beyond the clamp bounds."""
    rng = np.random.RandomState(seed)
    z = rng.uniform(1.5, 8.0, n)
    uv = np.stack([rng.uniform(-0.2 * w, 1.2 * w, n), rng.uniform(-0.2 * h, 1.2 * h, n)], -1)
    K = np.array([[500.0, 0, w / 2], [0, 500.0, h / 2], [0, 0, 1]])
    centers = np.stack([(uv[:, 0] - K[0, 2]) * z / 500.0, (uv[:, 1] - K[1, 2]) * z / 500.0, z], -1)
    centers[:3, 2] = [0.2, 0.4, 0.3]  # near the camera: corners spill past the clamps
    dims = rng.uniform(0.3, 1.6, (n, 3))
    wh = rng.uniform(10, 160, (n, 2))
    boxes = np.concatenate([uv - wh / 2, uv + wh / 2], -1)
    Ks = np.tile(K, (n, 1, 1))
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f32(centers), f32(dims), _rotations(rng, (n,)), f32(Ks), f32(boxes)


# ---- geometry ---------------------------------------------------------------------


def test_project_cube_boxes():
    from threedod.models.weak_heads import project_cube_boxes as jfn

    from threedod_torch.models.weak_heads import project_cube_boxes

    c, d, p, K, _ = _cubes(64)
    ref = np.asarray(jax.jit(jfn, static_argnums=(4, 5))(c, d, p, K, 512, 384))
    got = project_cube_boxes(_t(c), _t(d), _t(p), _t(K), 512, 384).numpy()
    assert (ref[:, 0] == -255).any() and (ref[:, 2] == 1023).any()  # both clamps reached
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-4)


def test_cached_tables_serve_training_after_inference():
    """The tables cached a device are made outside inference mode: a
    training step after an evaluation that made them can still back-propagate
    through them."""
    from threedod_torch.geometry import cuboids
    from threedod_torch.models import weak_heads

    cuboids._signs.cache_clear()
    weak_heads._on_device.cache_clear()
    c, d, p, K, boxes = _cubes(8, seed=9)
    with torch.inference_mode():
        weak_heads.z_search_loss(_t(boxes), _t(c), _t(d), _t(p), _t(c[:, 2]), _t(K), 512, 384)
    z = _t(c[:, 2]).clone().requires_grad_(True)
    centers = torch.cat([_t(c[:, :2]), z[:, None]], 1)
    loss = weak_heads.project_cube_boxes(centers, _t(d), _t(p), _t(K), 512, 384).sum()
    loss = loss + weak_heads.z_search_loss(_t(boxes), centers, _t(d), _t(p), z, _t(K), 512, 384).sum()
    loss.backward()
    assert torch.isfinite(z.grad).all() and z.grad.abs().sum() > 0


def test_giou_and_matched_iou():
    from threedod.geometry.boxes2d import giou_loss as jgiou, matched_pairwise_iou as jiou

    from threedod_torch.geometry.boxes2d import giou_loss, matched_pairwise_iou

    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 100, (2, 200, 2))
    wh = rng.uniform(0, 60, (2, 200, 2))
    a, b = (np.concatenate([xy[i], xy[i] + wh[i]], -1).astype(np.float32) for i in range(2))
    b[:5] = a[:5]  # identical
    b[5:10] = a[5:10] + 500  # disjoint
    b[10:12, 2:] = b[10:12, :2]  # empty
    ref_g, ref_i = jax.jit(lambda x, y: (jgiou(x, y), jiou(x, y)))(a, b)
    np.testing.assert_allclose(giou_loss(_t(a), _t(b)).numpy(), ref_g, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(matched_pairwise_iou(_t(a), _t(b)).numpy(), ref_i, rtol=RTOL, atol=1e-7)


def test_pose_alignment_loss():
    from threedod.models.weak_heads import pose_alignment_loss as jfn

    from threedod_torch.models.weak_heads import pose_alignment_loss

    rng = np.random.RandomState(2)
    poses = _rotations(rng, (3, 8))
    fg = rng.rand(3, 8) > 0.4
    fg[2] = [True] + [False] * 7  # one image without a pair
    ref, has = jax.jit(jfn)(poses, fg)
    got, got_has = pose_alignment_loss(_t(poses), _t(fg))
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
    assert bool(got_has) == bool(has)
    none, none_has = pose_alignment_loss(_t(poses), torch.zeros(3, 8, dtype=torch.bool))
    assert none.item() == 0.0 and not bool(none_has)


def test_normal_to_rotation_and_disambiguation():
    from threedod.models.boxer import disambiguate_ground_normal as jdis
    from threedod.models.weak_heads import normal_to_rotation as jrot

    from threedod_torch.models.boxer import disambiguate_ground_normal
    from threedod_torch.models.weak_heads import normal_to_rotation

    rng = np.random.RandomState(3)
    n = rng.randn(64, 3)
    n[:6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, 0, -1], [0.9, 0.01, 0.02], [0.1, -0.2, 0.95]]
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    ref_r, ref_d = jax.jit(lambda v: (jrot(v), jax.vmap(jdis)(v)))(n)
    np.testing.assert_allclose(normal_to_rotation(_t(n)).numpy(), ref_r, rtol=0, atol=1e-6)
    np.testing.assert_allclose(disambiguate_ground_normal(_t(n)).numpy(), ref_d, rtol=0, atol=1e-6)


def test_z_steps_equal_linspace():
    from threedod_torch.models.weak_heads import z_steps

    np.testing.assert_array_equal(z_steps(), np.asarray(jnp.linspace(0.0, 4.9, 50)))
    np.testing.assert_array_equal(z_steps(), np.asarray(jax.jit(lambda: jnp.linspace(0.0, (50 - 1) / 10.0, 50))()))


def test_z_search_loss():
    from threedod.models.weak_heads import z_search_loss as jfn

    from threedod_torch.models.weak_heads import z_search_loss

    c, d, p, K, boxes = _cubes(96, seed=4)
    ref = np.asarray(jax.jit(jfn, static_argnums=(6, 7))(boxes, c, d, p, c[:, 2], K, 512, 384))
    got = z_search_loss(_t(boxes), _t(c), _t(d), _t(p), _t(c[:, 2]), _t(K), 512, 384).numpy()
    assert (ref == 2.5).any() and (ref < 2.5).sum() > 40  # rows outside and inside the search window
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-6)


# ---- quantiles and windows ------------------------------------------------------------


def test_masked_quantile_batch_bit_equal():
    from threedod.models.weak_heads import masked_quantile as jq1, masked_quantile_batch as jq

    from threedod_torch.models.weak_heads import masked_quantile, masked_quantile_batch

    rng = np.random.RandomState(5)
    v = rng.uniform(0.5, 8.0, (40, 1024)).astype(np.float32)
    v[:, ::7] = np.round(v[:, ::7])  # ties
    v[3] = -v[3]
    mask = rng.rand(40, 1024) < rng.uniform(0, 1, (40, 1))
    mask[0], mask[1], mask[2] = False, True, False
    mask[2, 17] = True
    ref = jax.jit(lambda a, m: (jq(a, m, 0.5), jq(a, m, 0.9, 0.1), jq1(a[4], m[4], 0.3)))(v, mask)
    np.testing.assert_array_equal(masked_quantile_batch(_t(v), _t(mask), 0.5).numpy(), ref[0])
    for got, want in zip(masked_quantile_batch(_t(v), _t(mask), 0.9, 0.1), ref[1]):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(masked_quantile(_t(v[4]), _t(mask[4]), 0.3).numpy(), ref[2])


def test_box_windows_bit_equal():
    from threedod.models.weak_heads import _box_window_batch as jwin, _box_window_batch_masks as jmwin

    from threedod_torch.models.weak_heads import _box_window_batch, _box_window_batch_masks

    rng = np.random.RandomState(6)
    b, f, h, w = 2, 12, 192, 256
    imgs = rng.uniform(0.5, 9.0, (b, h, w)).astype(np.float32)
    masks = (rng.rand(b, 4, 96, 128) > 0.5).astype(np.uint8)
    xy = rng.uniform(-40, 260, (b * f, 2))
    wh = rng.uniform(0.3, 150, (b * f, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    img_idx = np.repeat(np.arange(b), f)
    gt_idx = rng.randint(0, 4, b * f)
    ref = jax.jit(lambda i, ii, m, g, bx: (jwin(i, ii, bx), jmwin(m, ii, g, bx / 2.0)))(
        imgs, img_idx, masks, gt_idx, boxes)
    win, valid = _box_window_batch(_t(imgs), _t(img_idx), _t(boxes))
    mwin, mvalid = _box_window_batch_masks(_t(masks), _t(img_idx), _t(gt_idx), _t(boxes) / 2.0)
    np.testing.assert_array_equal(win.numpy(), ref[0][0])
    np.testing.assert_array_equal(valid.numpy(), ref[0][1])
    assert mwin.dtype == torch.uint8
    np.testing.assert_array_equal(mwin.numpy(), ref[1][0])
    np.testing.assert_array_equal(mvalid.numpy(), ref[1][1])
    assert not ref[0][1].all() and ref[0][1].any()


# ---- the ground plane on the fixture's maps ----------------------------------------------


def _fixture_maps(ids, scale_to=CANVAS):
    """Depth and ground maps of fixture images resized (Pillow's nearest, as
    the mapper does) to 384x512, and their K at that resolution."""
    from threedod_torch.data.resize import resize_nearest

    with open(ROOT / "datasets" / "Omni3D" / "synth_train.json") as fh:
        Ks = {im["id"]: np.asarray(im["K"], np.float32) for im in json.load(fh)["images"]}
    depth, ground, K = [], [], []
    for i in ids:
        with np.load(ROOT / "datasets" / "depth_maps" / f"{i}.npz") as z:
            depth.append(resize_nearest(_t(z["depth"].astype(np.float32)), *scale_to).numpy())
        with np.load(ROOT / "datasets" / "ground_maps" / f"{i}.npz") as z:
            ground.append(resize_nearest(_t(z["mask"].astype(np.float32)), *scale_to).numpy())
        k = Ks[i] * (scale_to[0] / 480.0)
        k[2, 2] = 1.0
        K.append(k)
    return np.stack(depth), np.stack(ground), np.stack(K).astype(np.float32)


def _hypotheses(key, b, n_points=76 * 102):
    """The (B, 1000, 3) indices JAX's per-image RANSAC draws from ``key``."""
    keys = jax.random.split(key, b)
    return np.stack([np.asarray(jax.random.randint(k, (1000, 3), 0, n_points)) for k in keys])


@pytest.fixture(scope="module")
def maps():
    return _fixture_maps([3, 17])


def test_ground_plane_on_fixture_maps(maps):
    from threedod.geometry.plane import fit_plane_ransac as jfit
    from threedod.models.boxer import ground_plane_from_depth as jplane

    from threedod_torch.geometry.plane import fit_plane_ransac, point_cloud_from_depth
    from threedod_torch.models.boxer import ground_plane_from_depth

    depth, ground, K = maps
    hw = np.array([[384, 512], [352, 469]], np.int32)
    key = jax.random.PRNGKey(4)
    keys = jax.random.split(key, 2)
    idx = _hypotheses(key, 2)

    def jax_side(d, g, k, v):
        normals = jax.vmap(lambda ki, di, gi, Ki, vi: jplane(ki, di, Ki, gi, valid_hw=vi)[0])(keys, d, g, k, v)
        pts = jax.vmap(lambda di, Ki: jplane(keys[0], di, Ki)[1])(d, k)
        eqs = jax.vmap(lambda ki, p: jfit(p, ki)[0])(keys, pts)
        return normals, pts, eqs

    ref_n, ref_pts, ref_eq = jax.jit(jax_side)(depth, ground, K, hw)
    normal, points, no_ground = ground_plane_from_depth(_t(idx), _t(depth), _t(K), _t(ground), valid_hw=_t(hw))
    np.testing.assert_allclose(points.numpy(), ref_pts, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(normal.numpy(), ref_n, rtol=0, atol=1e-6)
    assert points.shape == (2, 7752, 3) and no_ground.any() and (~no_ground).any()
    eq, frac = fit_plane_ransac(_t(ref_pts), _t(idx))
    np.testing.assert_allclose(eq.numpy(), ref_eq, rtol=0, atol=1e-6)
    assert ((frac > 0) & (frac <= 1)).all()
    # the point cloud alone
    np.testing.assert_allclose(point_cloud_from_depth(_t(depth), _t(K)).numpy(), ref_pts, rtol=1e-6, atol=1e-6)
    # a generator draws its own hypotheses; the fit still finds the floor
    drawn, _, _ = ground_plane_from_depth(torch.Generator().manual_seed(0), _t(depth), _t(K), _t(ground),
                                          valid_hw=_t(hw))
    assert (torch.nn.functional.cosine_similarity(drawn, normal, dim=-1) > 0.99).all()


# ---- the weak losses on one set of cube outputs ----------------------------------------------


def _loss_case(maps, b=2, f=16, seed=7, ellipses=False):
    """Cube outputs and the sampled prefix for B x F rows (numpy), on the
    fixture's maps; the masks fill the boxes, or with ``ellipses`` the
    ellipse inscribed in each box."""
    depth, ground, K = maps
    h, w = CANVAS
    rng = np.random.RandomState(seed)
    n = b * f
    xy = np.stack([rng.uniform(20, w - 80, (b, f)), rng.uniform(20, h - 80, (b, f))], -1)
    wh = rng.uniform(20, 120, (b, f, 2))
    gt_boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    centre = (gt_boxes[..., :2] + gt_boxes[..., 2:]) / 2 + rng.uniform(-8, 8, (b, f, 2))
    Ks_per = np.repeat(K, f, axis=0)
    prior_mean = rng.uniform(0.5, 1.5, (n, 3))
    out = dict(
        xy=centre.reshape(n, 2), z=rng.uniform(1.5, 6.0, n), dims=prior_mean * rng.uniform(0.3, 2.5, (n, 3)),
        pose=_rotations(rng, (n,)), uncert=rng.normal(0, 0.5, n), Ks_per=Ks_per, prior_dims_mean=prior_mean,
        prior_dims_std=rng.uniform(0.05, 0.4, (n, 3)),
    )
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    fg = rng.rand(b, f) > 0.3
    fg[1, -3:] = False
    sampled = dict(
        boxes=gt_boxes + rng.uniform(-4, 4, (b, f, 4)).astype(np.float32), classes=rng.randint(0, 10, (b, f)),
        fg=fg, valid=np.ones((b, f), bool), matched_gt_boxes=gt_boxes,
        gt_boxes3d=np.concatenate([centre, rng.uniform(1, 6, (b, f, 1)), rng.uniform(0.3, 1.5, (b, f, 3)),
                                   rng.randn(b, f, 3)], -1).astype(np.float32),
        gt_poses=_rotations(rng, (b, f)), gt_index=np.tile(np.arange(f) % 5, (b, 1)),
    )
    # box-filled masks on the quarter grid, as the mapper fills them without stored masks
    masks = np.zeros((b, 5, h // 4, w // 4), np.uint8)
    ys, xs = np.arange(h // 4)[:, None], np.arange(w // 4)[None, :]
    for i in range(b):
        for j in range(5):
            x1, y1, x2, y2 = gt_boxes[i, j] / 4.0
            if ellipses:
                cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
                masks[i, j] = ((xs + 0.5 - cx) / rx) ** 2 + ((ys + 0.5 - cy) / ry) ** 2 <= 1.0
            else:
                masks[i, j] = (ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)
    hw = np.array([[384, 512], [352, 469]], np.int32)
    return out, sampled, masks, hw


MENUS = {
    "menu7": MENU,
    "menu8": MENU + ("segmentation",),
    "others": ("pose_ground2", "z_pseudo_gt_center", "depth"),
}


@pytest.mark.parametrize("menu", sorted(MENUS))
def test_weak_cube_losses(maps, menu):
    """Every loss and metric of ``weak_cube_losses``; the 7-loss menu with
    box-filled masks and ground maps, the 8-loss menu with ellipse masks and
    ground maps, the other losses without either."""
    from threedod.config import Config as JaxConfig
    from threedod.models.roi_heads3d import SampledROIs as JaxSampled
    from threedod.models.weak_heads import ROIHeads3DScore as JaxHeads

    from threedod_torch.config import Config
    from threedod_torch.models.roi_heads3d import SampledROIs
    from threedod_torch.models.weak_heads import ROIHeads3DScore

    depth, ground, K = maps
    over = {"model.roi_heads.num_classes": 10, "model.roi_cube_head.loss_w_pose": 7.0,
            "model.roi_cube_head.loss_w_dims": 20.0, "model.dtype": "float32"}
    jcfg, pcfg = tp._apply(JaxConfig(), over), tp._apply(Config(), over)
    jcfg.loss_functions = pcfg.loss_functions = MENUS[menu]
    with_maps = menu != "others"
    out, sampled, masks, hw = _loss_case(maps, ellipses=menu == "menu8")
    key = jax.random.PRNGKey(11)
    gmaps = ground if with_maps else None
    gmasks = masks if with_maps else None

    def jax_side(o, s, m, d, g, k, v):
        heads = JaxHeads(cfg=jcfg)
        return heads.init_with_output(jax.random.PRNGKey(0), o, JaxSampled(**s), m, d, g, k, v, key,
                                      method=JaxHeads.weak_cube_losses)[0]

    jl, jm = jax.jit(jax_side)(out, sampled, gmasks, depth, gmaps, K, hw)
    heads = ROIHeads3DScore(pcfg, 16)
    tl, tm = heads.weak_cube_losses(
        {k: _t(v) for k, v in out.items()}, SampledROIs(**{k: _t(v) for k, v in sampled.items()}),
        None if gmasks is None else _t(gmasks), _t(depth), None if gmaps is None else _t(gmaps), _t(K), _t(hw),
        _t(_hypotheses(key, 2)))
    assert set(tl) == set(jl) and set(tm) == set(jm)
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-5, atol=1e-7, err_msg=k)
        assert float(jl[k]) != 0.0 or k == "Cube/loss_pseudo_gt_z", k
    for k in jm:
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    if with_maps:
        assert {"Cube/loss_iou", "Cube/loss_pose", "Cube/loss_normal_vec", "Cube/loss_z", "Cube/loss_pseudo_gt_z",
                "Cube/loss_dims_w", "Cube/loss_dims_h", "Cube/loss_dims_l", "Cube/loss_depth",
                "Cube/uncert"} | ({"Cube/loss_seg"} if menu == "menu8" else set()) == set(tl)


def test_menu_checks():
    """Every loss of the menu is accepted, ``segmentation`` included; an
    unknown one raises."""
    from threedod_torch.config import Config
    from threedod_torch.models.weak_heads import ROIHeads3DScore

    cfg = Config()
    cfg.model.roi_cube_head.fc_dim = cfg.model.roi_box_head.fc_dim = 8
    cfg.loss_functions = ROIHeads3DScore.VALID_LOSSES
    ROIHeads3DScore(cfg, 16)
    cfg.loss_functions = ("iou", "no_such_loss")
    with pytest.raises(ValueError, match="no_such_loss"):
        ROIHeads3DScore(cfg, 16)
