"""Per-category priors of the 3D dimensions and depths, and the depth bins
of clustered heads (the port's copy of ``threedod/data/priors.py``, after
cubercnn/util/math_util.py:288-525). float64 numpy on the host, once before
training.
"""
from __future__ import annotations

import numpy as np

from .omni3d import _select_bbox2d


def compute_virtual_scale_from_focal_spaces(f, H, f0, H0):
    """Scaling factor of depth from real (f0, H0) to virtual (f, H) space."""
    return (H0 * f) / (f0 * H)


def approx_eval_resolution(h, w, scale_min=0, scale_max=1e10):
    """Resolution an (h, w) image runs through the model at (math_util.py:288)."""
    orig_h = h
    sf = scale_min / min(h, w)
    h *= sf
    w *= sf
    sf = min(scale_max / max(h, w), 1.0)
    h *= sf
    w *= sf
    return h, w, h / orig_h


def compute_priors(cfg, datasets, category_names, max_cluster_rounds=1000, min_points_for_std=5, n_bins=None):
    """Compute priors dict from an Omni3D dataset object.

    Returns the same structure as the reference: priors_dims_per_cat (C,2,3),
    priors_z3d_per_cat (C,2), priors_y3d_per_cat (C,2), priors_bins, and
    global priors_z3d / priors_y3d.
    """
    virtual_depth = cfg.model.roi_cube_head.virtual_depth
    virtual_focal = cfg.model.roi_cube_head.virtual_focal
    test_scale_min = cfg.input.min_size_test
    test_scale_max = cfg.input.max_size_test
    if n_bins is None:
        n_bins = cfg.model.roi_cube_head.cluster_bins

    fs = {
        "modal_2D_boxes": cfg.datasets.modal_2d_boxes,
        "trunc_2D_boxes": cfg.datasets.trunc_2d_boxes,
    }

    names, whs, xyz, dims, scales = [], [], [], [], []
    for ann in datasets.loadAnns(datasets.getAnnIds()):
        category_name = ann["category_name"].lower()
        if ann.get("ignore", False) or category_name not in category_names:
            continue
        img = datasets.imgs[ann["image_id"]]
        fy = img["K"][1][1]
        im_h, im_w = img["height"], img["width"]
        bbox2D = _select_bbox2d(ann, fs)
        if bbox2D is None:
            continue
        _, _, sf = approx_eval_resolution(im_h, im_w, test_scale_min, test_scale_max)
        w, h = bbox2D[2] * sf, bbox2D[3] * sf
        x3d, y3d, z3d = ann["center_cam"]
        if virtual_depth:
            test_h = im_h * sf
            v2r = compute_virtual_scale_from_focal_spaces(fy, im_h, virtual_focal, test_h)
            z3d = z3d / v2r
        names.append(category_name)
        whs.append((w, h))
        xyz.append((x3d, y3d, z3d))
        dims.append(tuple(ann["dimensions"]))
        scales.append(np.sqrt(w**2 + h**2))

    names = np.asarray(names)
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    dims = np.asarray(dims, np.float64).reshape(-1, 3)
    scales = np.asarray(scales, np.float64)

    def _ms(x):
        if len(x) == 0:
            return [0.0, 0.0]
        return [float(np.mean(x)), float(np.std(x, ddof=1)) if len(x) > 1 else 0.0]

    priors_z3d = _ms(xyz[:, 2]) if len(xyz) else [50.0, 50.0]
    priors_y3d = _ms(xyz[:, 1]) if len(xyz) else [1.0, 10.0]

    priors_bins = []
    priors_dims_per_cat = []
    priors_z3d_per_cat = []
    priors_y3d_per_cat = []

    for cat in category_names:
        sel = names == cat
        n = int(sel.sum())
        if n > 0:
            d = dims[sel]
            priors_dims_per_cat.append(
                [
                    [float(d[:, 0].mean()), float(d[:, 1].mean()), float(d[:, 2].mean())],
                    [
                        float(d[:, 0].std(ddof=1)) if n > 1 else 1.0,
                        float(d[:, 1].std(ddof=1)) if n > 1 else 1.0,
                        float(d[:, 2].std(ddof=1)) if n > 1 else 1.0,
                    ],
                ]
            )
            priors_z3d_per_cat.append(_ms(xyz[sel, 2]))
            priors_y3d_per_cat.append(_ms(xyz[sel, 1]))
        else:
            priors_dims_per_cat.append([[1.0, 1.0, 1.0], [1.0, 1.0, 1.0]])
            priors_z3d_per_cat.append([50.0, 50.0])
            priors_y3d_per_cat.append([1.0, 10.0])

        if n_bins > 1:
            cat_scales = scales[sel]
            cat_z = xyz[sel, 2]
            if n < min_points_for_std:
                max_scale, min_scale = 512.0, 32.0
                base = (max_scale / min_scale) ** (1 / (n_bins - 1))
                cluster_scales = [min_scale * base**i for i in range(n_bins)]
                bin_priors_z = [[b, 15.0] for b in np.arange(100, 1, -(100 - 1) / n_bins)][:n_bins]
                priors_bins.append((cat, cluster_scales, bin_priors_z))
            else:
                max_scale, min_scale = cat_scales.max(), max(cat_scales.min(), 1e-3)
                base = (max_scale / min_scale) ** (1 / (n_bins - 1))
                cluster_scales = np.array([min_scale * base**i for i in range(n_bins)])
                best_score = -np.inf
                assignments = None
                for _ in range(max_cluster_rounds):
                    quality = -np.abs(cluster_scales[None, :] - cat_scales[:, None])
                    a = quality.argmax(1)
                    score = quality.max(1).mean()
                    if np.round(score, 5) > best_score:
                        best_score = score
                        assignments = a
                        for b in range(n_bins):
                            in_c = assignments == b
                            if in_c.sum() < min_points_for_std:
                                top = np.argsort(-quality[:, b])[:min_points_for_std]
                                in_c = np.zeros_like(in_c)
                                in_c[top] = True
                            cluster_scales[b] = cat_scales[in_c].mean()
                    else:
                        break
                bin_priors_z = []
                quality = -np.abs(cluster_scales[None, :] - cat_scales[:, None])
                for b in range(n_bins):
                    in_c = assignments == b
                    if in_c.sum() < min_points_for_std:
                        top = np.argsort(-quality[:, b])[:min_points_for_std]
                        in_c = np.zeros_like(in_c)
                        in_c[top] = True
                    zb = cat_z[in_c]
                    bin_priors_z.append(_ms(zb))
                priors_bins.append((cat, cluster_scales.tolist(), bin_priors_z))

    return {
        "priors_dims_per_cat": priors_dims_per_cat,
        "priors_z3d_per_cat": priors_z3d_per_cat,
        "priors_y3d_per_cat": priors_y3d_per_cat,
        "priors_bins": priors_bins,
        "priors_y3d": priors_y3d,
        "priors_z3d": priors_z3d,
    }
