"""Detection drawings: rendered front and novel scene views, BEV,
wireframes, and evaluation-time dumps (counterpart of
``threedod/vis/vis.py``, after cubercnn/vis/vis.py).

Images are (H, W, 3) uint8 numpy arrays, drawn in place by ``vis/draw.py``
with Pillow's pixels, so the port's drawings are the JAX package's except for
the glyphs of text (the port's own 5 x 8 font; the blended strip behind them
is Pillow's). The meshes are rasterized on the host in float64
(``vis/render.py``). ``visualize_from_instances`` writes its dumps as PNG
(``vis/png.py``) where the JAX package writes JPEG through Pillow, and reads
images with ``data/image_io.imread_rgb`` on the device it is given (the card
decodes JPEG and PNG files).
"""
from __future__ import annotations

import os
import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.image_io import imread_rgb
from ..data.resize import resize_bicubic
from ..geometry.cuboids import cuboid_verts
from . import draw
from .png import write_png
from .render import render_cuboids

# the cuboid's 12 edges and 6 outward-wound quad faces over its 8 corners
# (the JAX package's EDGES and QUAD_FACES)
EDGES = ((0, 1), (1, 2), (2, 3), (3, 0), (4, 5), (5, 6), (6, 7), (7, 4), (0, 4), (1, 5), (2, 6), (3, 7))
QUAD_FACES = ((0, 3, 2, 1), (4, 5, 6, 7), (1, 2, 6, 5), (0, 4, 7, 3), (2, 3, 7, 6), (0, 1, 5, 4))
GROUND = (225, 225, 225)  # the novel view's background


def get_color(index: int):
    """A stable colour for ``index`` (util.py:269-300 contract)."""
    rng = np.random.RandomState(index * 9781 + 3)
    c = rng.randint(60, 255, 3)
    return tuple(int(x) for x in c)


def _project(K: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = pts @ K.T
    return p[:, :2] / np.maximum(p[:, 2:3], 1e-6)


def euler2mat(euler):
    """XYZ-intrinsic Euler angles to a rotation, R = Rz Ry Rx, computed in f32
    as the JAX package does (its default novel view, vis.py:236), then f64."""
    x, y, z = (np.float32(v) for v in np.asarray(euler, np.float64))
    cx, sx, cy, sy, cz, sz = np.cos(x), np.sin(x), np.cos(y), np.sin(y), np.cos(z), np.sin(z)
    return np.array([
        [cz * cy, cz * sy * sx - sz * cx, cz * sy * cx + sz * sx],
        [sz * cy, sz * sy * sx + cz * cx, sz * sy * cx - cz * sx],
        [-sy, cy * sx, cy * cx],
    ], np.float32).astype(np.float64)


def draw_text(img: np.ndarray, text: str, pos, color=(0, 255, 255)) -> np.ndarray:
    """Text on a blended strip (vis.py:664-693)."""
    x = min(max(float(pos[0]), 0.0), img.shape[1] - 1)
    y = min(max(float(pos[1]), 0.0), img.shape[0] - 1)
    tw = max(7 * len(str(text)), 10)
    fg = (0, 0, 0) if (sum(color[:3]) / 3 > 127.5) else (255, 255, 255)
    draw.rectangle(img, [x, y - 11, x + tw, y + 1], fill=tuple(color[:3]) + (170,), blend=True)
    draw.text(img, (x + 2, y - 10), str(text), fg, blend=True)
    return img


def draw_boxes_2d(img: np.ndarray, boxes, labels=None, scores=None, color=(0, 255, 80)) -> np.ndarray:
    for i, b in enumerate(np.asarray(boxes)):
        draw.rectangle(img, [b[0], b[1], b[2], b[3]], outline=color, width=2)
        txt = []
        if labels is not None:
            txt.append(str(labels[i]))
        if scores is not None:
            txt.append(f"{scores[i]:.2f}")
        if txt:
            draw.text(img, (b[0] + 2, b[1] + 2), " ".join(txt), color)
    return img


def draw_3d_box_from_verts(img: np.ndarray, K: np.ndarray, verts3d: np.ndarray, color=(255, 120, 40),
                           width: int = 2, zplane: float = 0.05) -> np.ndarray:
    """Wireframe edges, each clipped to the plane z = ``zplane`` where one end
    lies behind it (vis.py:577-633)."""
    verts3d = np.asarray(verts3d, np.float64)
    K = np.asarray(K, np.float64)
    eps = 1e-4

    def proj(v):
        z = max(v[2], eps)
        return (K[0, 0] * v[0] / z + K[0, 2], K[1, 1] * v[1] / z + K[1, 2])

    for a, b in EDGES:
        v0, v1 = verts3d[a].copy(), verts3d[b].copy()
        z0, z1 = v0[2], v1[2]
        if z0 < zplane and z1 < zplane:
            continue
        s = (zplane - z0) / max(z1 - z0, eps) if z1 != z0 else 0.0
        new_v = v0 + s * (v1 - v0)
        if z0 < zplane <= z1:
            v0 = new_v
        elif z1 < zplane <= z0:
            v1 = new_v
        draw.lines(img, [proj(v0), proj(v1)], tuple(color[:3]) + (255,), width, blend=True)
    return img


def draw_box_3d(img: np.ndarray, corners3d: np.ndarray, K: np.ndarray, color=(255, 120, 40), width: int = 2,
                fill_faces: bool = False) -> np.ndarray:
    """Wireframe (optionally face-filled) projected cuboid."""
    corners3d = np.asarray(corners3d)
    if np.all(corners3d[:, 2] <= 0.05):
        return img
    if fill_faces and np.all(corners3d[:, 2] > 0.05):
        uv = _project(np.asarray(K), corners3d)
        order = np.argsort([-corners3d[list(QUAD_FACES[f])].mean(0)[2] for f in range(6)])
        for f in order:
            draw.polygon(img, [tuple(uv[i]) for i in QUAD_FACES[f]], fill=tuple(color[:3]) + (40,), blend=True)
    draw_3d_box_from_verts(img, np.asarray(K), corners3d, color=color, width=width)
    return img


def draw_bev(corners3d_list: Sequence[np.ndarray], colors=None, size: int = 400, max_range: float = 12.0):
    """Bird's-eye-view canvas (vis.py:26 contract): X right, Z up."""
    img = np.full((size, size, 3), 245, np.uint8)
    scale = size / (2 * max_range)

    def to_px(x, z):
        return (size / 2 + x * scale, size - z * scale)

    draw.lines(img, [to_px(0, 0), to_px(-2, 3)], (150, 150, 150))
    draw.lines(img, [to_px(0, 0), to_px(2, 3)], (150, 150, 150))
    for i, corners in enumerate(corners3d_list):
        color = colors[i] if colors else get_color(i)
        footprint = np.asarray(corners)[[0, 1, 5, 4], :][:, [0, 2]]  # x, z of one face loop
        draw.polygon(img, [to_px(x, z) for x, z in footprint], outline=color)
    return img


def _auto_zoom(verts_rot: np.ndarray, center_z: float, K_novel: np.ndarray, scale: int):
    """The reference's zoom-out search (vis.py:348-377): start far out and
    pull in by 5% steps until any vertex leaves the margins or comes too
    close; keep the last fully-visible zoom."""
    margin = 0.01
    zoom = 100.0
    zoom_in = zoom
    for _ in range(10000):
        zoom_in = zoom_in * 0.95
        z = verts_rot[:, 2] + center_z * zoom_in
        if (z < 0.25).any():
            break
        u = K_novel[0, 0] * verts_rot[:, 0] / z + K_novel[0, 2]
        v = K_novel[1, 1] * verts_rot[:, 1] / z + K_novel[1, 2]
        if (u < scale * margin).any() or (v < scale * margin).any():
            break
        if (u > scale * (1 - margin)).any() or (v > scale * (1 - margin)).any():
            break
        zoom = zoom_in
    return zoom


def _ground_grid_canvas(all_verts: np.ndarray, center: np.ndarray, view_R: np.ndarray, K_novel: np.ndarray,
                        scale: int, z_shift: float, ground_bounds=None):
    """Novel-view background: a 1 m ground grid at the scene's max-Y plane,
    bounds estimated by the reference's two-pass projection (vis.py:393-497).
    Returns the canvas, or None for a scene that gives no grid."""
    if ground_bounds is None:
        min_x3d, _, min_z3d = all_verts.min(0)
        max_x3d, max_y3d, max_z3d = all_verts.max(0)
        # pass 1: absurdly wide bounds, then trim to what lands near the canvas
        x3d_start = np.round(min_x3d - (max_x3d - min_x3d) * 50)
        x3d_end = np.round(max_x3d + (max_x3d - min_x3d) * 50)
        z3d_start = np.round(min_z3d - (max_z3d - min_z3d) * 50)
        z3d_end = np.round(max_z3d + (max_z3d - min_z3d) * 50)
        gx = np.arange(x3d_start, x3d_end)
        gz = np.arange(z3d_start, z3d_end)
        if len(gx) == 0 or len(gz) == 0:
            return None
        xs, zs = np.meshgrid(gx, gz)
        pts = np.stack([xs, np.full_like(xs, max_y3d), zs], -1).reshape(-1, 3)
        cam = (view_R @ (pts - center).T).T
        cam[:, 2] = np.maximum(cam[:, 2] + z_shift, 0.25)
        uv = np.stack([K_novel[0, 0] * cam[:, 0] / cam[:, 2] + K_novel[0, 2],
                       K_novel[1, 1] * cam[:, 1] / cam[:, 2] + K_novel[1, 2]], -1)
        near = cam[:, 2] > 0
        maskx = (uv[:, 0] >= -50) & (uv[:, 0] < scale + 50) & near
        maskz = (uv[:, 1] >= -50) & (uv[:, 1] < scale + 50) & near
        if not maskx.any() or not maskz.any():
            return None
        x3d_start = np.round(cam[maskx, 0].min() - 10)
        x3d_end = np.round(cam[maskx, 0].max() + 10)
        z3d_start = np.round(pts[maskz, 2].min() - 10)
        z3d_end = np.round(pts[maskz, 2].max() + 10)
    else:
        max_y3d, x3d_start, x3d_end, z3d_start, z3d_end = ground_bounds

    gx = np.arange(x3d_start, x3d_end)
    gz = np.arange(z3d_start, z3d_end)
    if len(gx) < 2 or len(gz) < 2:
        return None
    xs, zs = np.meshgrid(gx, gz)
    ground_y = float(all_verts[:, 1].max()) if ground_bounds is None else max_y3d
    pts = np.stack([xs, np.full_like(xs, ground_y), zs], -1)
    shape = pts.shape
    cam = (view_R @ (pts.reshape(-1, 3) - center).T).T
    cam[:, 2] = np.maximum(cam[:, 2] + z_shift, 0.25)
    uv = np.stack([K_novel[0, 0] * cam[:, 0] / cam[:, 2] + K_novel[0, 2],
                   K_novel[1, 1] * cam[:, 1] / cam[:, 2] + K_novel[1, 2], cam[:, 2]], -1).reshape(shape)

    canvas = np.full((scale, scale, 3), GROUND, np.uint8)
    lw = max(1, int(np.round(3 * scale / 1250)))
    valid = uv[:, :, 2] > 0
    # the segments from each node (r - 1, c - 1) to (r - 1, c) and to (r, c - 1),
    # for r, c >= 1 (their order does not matter: the lines are not blended)
    p, right, down = uv[:-1, :-1, :2], uv[:-1, 1:, :2], uv[1:, :-1, :2]
    to_right = valid[:-1, :-1] & valid[:-1, 1:]
    to_down = valid[:-1, :-1] & valid[1:, :-1]
    draw.segments(canvas, np.concatenate([p[to_right], p[to_down]]),
                  np.concatenate([right[to_right], down[to_down]]), (175, 175, 175), lw)
    return canvas


def render_scene_views(image: np.ndarray, K: np.ndarray, corners3d: np.ndarray, text=None, colors=None,
                       mode: str = "front_and_novel", R: Optional[np.ndarray] = None, T: Optional[np.ndarray] = None,
                       scale: Optional[int] = None, zoom_factor: float = 1.0, blend_weight: float = 0.80,
                       blend_weight_overlay: float = 1.0, ground_bounds=None, zplane: float = 0.05):
    """The reference's ``draw_scene_view`` (vis.py:210-546) on (N, 8, 3)
    corner sets. Returns uint8 images: the front view for 'front' and
    '2D_only', the novel view for 'novel', (front, novel) for
    'front_and_novel'."""
    image = np.asarray(image, np.uint8)
    K = np.asarray(K, np.float64)
    corners3d = np.asarray(corners3d, np.float64)
    h, w = image.shape[:2]
    n = len(corners3d)
    if scale is None:
        scale = h
    if colors is None:
        colors = [get_color(i) for i in range(n)]
    colors01 = np.asarray([[c / 255.0 for c in col[:3]] for col in colors]) if n else np.zeros((0, 3))
    if R is None:
        R = euler2mat([np.pi / 3, 0, 0])
    lw = max(2, int(np.round(3 * h / 1250)))

    # painter order: reverse mean-Y (vis.py:247, 292), highest boxes last
    order = list(reversed(np.argsort(corners3d[:, :, 1].mean(1)))) if n else []

    if mode == "2D_only":
        img = image.copy()
        for i in order:
            uv = _project(K, corners3d[i])
            x1, y1 = uv[:, 0].min(), uv[:, 1].min()
            x2, y2 = uv[:, 0].max(), uv[:, 1].max()
            draw.rectangle(img, [x1, y1, x2, y2], outline=tuple(colors[i][:3]), width=lw)
            if text is not None:
                draw_text(img, text[i], (x1, y1), color=colors[i])
        return img

    front = None
    if mode in ("front", "front_and_novel"):
        front_np = image.astype(np.float64).copy()
        if blend_weight > 0 and n:
            rgb, sil, _ = render_cuboids(corners3d, colors01, K, w, h, znear=zplane)
            front_np[sil] = rgb[sil] * 255.0 * blend_weight + front_np[sil] * (1 - blend_weight)
        img = front_np.astype(np.uint8)
        for i in order:
            draw_3d_box_from_verts(img, K, corners3d[i], color=colors[i], width=lw, zplane=zplane)
            if text is not None:
                uv = _project(K, corners3d[i])
                draw_text(img, text[i], (uv[:, 0].min(), uv[:, 1].min()), color=colors[i])
        front = img.astype(np.float64)
        if 0.0 < blend_weight_overlay < 1.0:
            front = front * blend_weight_overlay + image.astype(np.float64) * (1 - blend_weight_overlay)
        front = front.astype(np.uint8)
        if mode == "front":
            return front

    if mode in ("novel", "front_and_novel"):
        if n == 0:
            novel = np.full((scale, scale, 3), GROUND, np.uint8)
            return (front, novel) if mode == "front_and_novel" else novel
        all_verts = corners3d.reshape(-1, 3)
        if T is None:
            center = (all_verts.min(0) + all_verts.max(0)) / 2.0
        else:
            center = np.asarray(T, np.float64).reshape(3)
        verts_rot = (R @ (all_verts - center).T).T

        K_novel = K.copy()
        K_novel[0, 2] *= scale / w
        K_novel[1, 2] *= scale / h

        if T is None:
            zoom_factor = _auto_zoom(verts_rot, center[2], K_novel, scale)
            zoom_out_bias = center[2]
        else:
            zoom_out_bias = 1.0
        z_shift = zoom_out_bias * zoom_factor
        verts_novel = verts_rot.copy()
        verts_novel[:, 2] += z_shift
        corners_novel = verts_novel.reshape(n, 8, 3)

        rgb, sil, _ = render_cuboids(corners_novel, colors01, K_novel, scale, scale, znear=zplane)
        canvas = _ground_grid_canvas(all_verts, center, R, K_novel, scale, z_shift, ground_bounds)
        if canvas is None:
            canvas = np.full((scale, scale, 3), GROUND, np.uint8)
        novel_np = canvas.astype(np.float64)
        novel_np[sil] = rgb[sil] * 255.0
        img = novel_np.astype(np.uint8)
        lwn = max(2, int(np.round(3 * scale / 1250)))
        for i in order:
            draw_3d_box_from_verts(img, K_novel, corners_novel[i], color=colors[i], width=lwn, zplane=zplane)
            if text is not None:
                uv = _project(K_novel, corners_novel[i])
                draw_text(img, text[i], (uv[:, 0].min(), uv[:, 1].min()), color=colors[i])
        return (front, img) if mode == "front_and_novel" else img

    raise ValueError(f"unknown mode {mode}")


def side_by_side(panels: Sequence[np.ndarray]) -> np.ndarray:
    """Panels joined left to right, each resized (Pillow's bicubic) to the
    first one's height where it differs."""
    h = panels[0].shape[0]
    out = [panels[0]]
    for p in panels[1:]:
        if p.shape[0] != h:
            p = resize_bicubic(torch.from_numpy(np.ascontiguousarray(p)), h, max(1, int(p.shape[1] * h / p.shape[0])))
            p = p.numpy()
        out.append(p)
    return np.concatenate(out, axis=1)


def draw_scene_view(image: np.ndarray, K: np.ndarray, corners3d: np.ndarray, labels=None, scores=None, colors=None,
                    novel_view: bool = True, **kwargs) -> np.ndarray:
    """The rendered front view, and beside it the novel view, as one image
    (the reference's panel contract; ``demo`` writes the panels apart too)."""
    corners3d = np.asarray(corners3d, np.float64)
    n = len(corners3d)
    text = None
    if labels is not None:
        text = [str(labels[i]) + (f" {scores[i]:.2f}" if scores is not None else "") for i in range(n)]

    def _color_idx(i):
        if labels is None:
            return i
        try:
            return int(labels[i])
        except (TypeError, ValueError):
            # stable across processes (hash() is salted per process)
            return zlib.crc32(str(labels[i]).encode()) % 10000

    if colors is None:
        colors = [get_color(_color_idx(i)) for i in range(n)]
    if not novel_view:
        return render_scene_views(image, K, corners3d, text=text, colors=colors, mode="front", **kwargs)
    front, novel = render_scene_views(image, K, corners3d, text=text, colors=colors, mode="front_and_novel",
                                      **kwargs)
    return side_by_side([front, novel])


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Plain pairwise IoU of xyxy boxes (util.iou contract, vis.py:142)."""
    ix1 = np.maximum(a[:, None, 0], b[None, :, 0])
    iy1 = np.maximum(a[:, None, 1], b[None, :, 1])
    ix2 = np.minimum(a[:, None, 2], b[None, :, 2])
    iy2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def so3_relative_angle(R1: np.ndarray, R2: np.ndarray) -> float:
    """Geodesic angle between two rotations, cos clamped to [-1, 1]
    (pytorch3d so3_relative_angle with cos_bound, vis.py:169)."""
    cos = (np.trace(R1 @ R2.T) - 1.0) / 2.0
    return float(np.arccos(np.clip(cos, -1.0, 1.0)))


def visualize_from_instances(detections, dataset_dicts, dataset_name: str, min_size_test: int, output_folder: str,
                             category_names_official, iteration="", visualize_every: int = 50,
                             score_thres: Optional[float] = None, device="cpu") -> str:
    """Evaluation-time dumps and error statistics (vis.py:76-198).

    ``detections``: per-image dicts with 'image_id', 'K', 'width', 'height'
    and 'instances' (each: category_id, score, bbox xywh, center_2D,
    center_cam, dimensions, pose), as ``evaluation.inference.
    group_predictions_by_image`` groups them; ``dataset_dicts``: the matching
    records with 'annotations' and 'file_name'. Every ``visualize_every``-th
    image is drawn into ``output_folder``/vis/<index>.png, its file decoded on
    ``device``. Returns the reference's one-line error log."""
    vis_folder = os.path.join(output_folder, "vis")
    os.makedirs(vis_folder, exist_ok=True)

    xy_errors, z_errors = [], []
    w3d_errors, h3d_errors, l3d_errors, dim_errors, ry_errors = [], [], [], [], []
    n_cats = len(category_names_official)
    thres = np.sqrt(1.0 / max(n_cats, 1)) if score_thres is None else score_thres

    for imind, im_obj in enumerate(detections):
        write_sample = (imind % visualize_every) == 0
        annos = dataset_dicts[imind].get("annotations", [])
        if len(annos) == 0:
            continue
        gt_boxes_2d = np.array([a["bbox"] for a in annos], np.float64)
        gt_boxes_2d[:, 2] += gt_boxes_2d[:, 0]
        gt_boxes_2d[:, 3] += gt_boxes_2d[:, 1]
        gt_cats = np.array([a["category_id"] for a in annos])

        K = np.array(im_obj["K"], np.float64)
        K_inv = np.linalg.inv(K)
        img = None
        if write_sample:
            fn = dataset_dicts[imind].get("file_name")
            if fn and os.path.exists(fn):
                img = imread_rgb(fn, device).cpu().numpy()
            else:
                img = np.full((int(im_obj.get("height", 480)), int(im_obj.get("width", 640)), 3), 40, np.uint8)

        for inst in im_obj.get("instances", []):
            cat_id = inst["category_id"]
            score = inst["score"]
            x1, y1, bw, bh = inst["bbox"]
            w3d, h3d, l3d = inst["dimensions"]
            cen_2d = np.array(list(inst["center_2D"]) + [1.0])
            z3d = inst["center_cam"][2]
            ry3d = np.array(inst["pose"], np.float64)

            valid_gt = np.flatnonzero(cat_id == gt_cats)
            valid_match = False
            if len(valid_gt) > 0:
                q = _iou_xyxy(np.array([[x1, y1, x1 + bw, y1 + bh]]), gt_boxes_2d[valid_gt])
                nearest = int(q.argmax(axis=1)[0])
                valid_match = float(q.max(axis=1)[0]) >= 0.5
            if valid_match:
                g = annos[valid_gt[nearest]]
                gt_x3d, gt_y3d, gt_z3d = g["center_cam"]
                gt_w3d, gt_h3d, gt_l3d = g["dimensions"]
                gt_cen = K @ np.array([gt_x3d, gt_y3d, gt_z3d])
                gt_cen = gt_cen / gt_cen[2]
                xy_errors.append(float(np.linalg.norm(cen_2d[:2] - gt_cen[:2])))
                z_errors.append(abs(z3d - gt_z3d))
                w3d_errors.append(abs(w3d - gt_w3d))
                h3d_errors.append(abs(h3d - gt_h3d))
                l3d_errors.append(abs(l3d - gt_l3d))
                dim_errors.append(float(np.sqrt((w3d - gt_w3d) ** 2 + (h3d - gt_h3d) ** 2 + (l3d - gt_l3d) ** 2)))
                ry_errors.append(so3_relative_angle(ry3d, np.array(g["pose"], np.float64)))

            if write_sample and img is not None and score > thres:
                x3d, y3d, z3d_u = K_inv @ (z3d * cen_2d)
                corners = cuboid_verts(torch.tensor([[x3d, y3d, z3d_u, w3d, h3d, l3d]], dtype=torch.float32),
                                       torch.tensor(ry3d[None], dtype=torch.float32))[0].numpy()
                color = get_color(int(cat_id))
                draw_box_3d(img, corners, K, color=color, width=max(2, int(np.round(3 * img.shape[0] / 500))))
                cat = category_names_official[cat_id] if cat_id < len(category_names_official) else str(cat_id)
                draw_text(img, f"{cat}, z={z3d:.1f}, s={score:.2f}", (x1, y1), color=color)

        if write_sample and img is not None:
            write_png(os.path.join(vis_folder, f"{imind:06d}.png"), img)

    if len(ry_errors) == 0:
        ry_errors = [1000, 1000]
    return "{}iter={}, xy({:.2f}), z({:.2f}), whl({:.2f}, {:.2f}, {:.2f}), ry({:.2f})\n".format(
        dataset_name,
        iteration,
        np.mean(xy_errors) if xy_errors else float("nan"),
        np.mean(z_errors) if z_errors else float("nan"),
        np.mean(w3d_errors) if w3d_errors else float("nan"),
        np.mean(h3d_errors) if h3d_errors else float("nan"),
        np.mean(l3d_errors) if l3d_errors else float("nan"),
        np.mean(ry_errors),
    )
