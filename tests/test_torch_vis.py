"""The port's drawings (``threedod_torch/vis``) vs the JAX package's
``threedod/vis`` and Pillow, on the CPU. No test here needs the card.

* ``render_cuboids`` (the float64 host rasterizer) is bit-equal, boxes
  crossing the near plane included.
* The drawing primitives (``vis/draw.py``) against Pillow's ``ImageDraw``:
  one-pixel and wide lines, rectangle outlines and fills, with and without
  blending, equal pixel for pixel; filled polygons (convex, concave, with
  flat edges, blended or not) within the drawing tolerance below, taken over
  the 400 together (Pillow's corner rules are matched from its output: 5 of
  4000 random polygons differed by one pixel when the rules were fitted).
* The scene views (front, novel, 2D only), the bird's-eye view, the
  face-filled box, the 2D boxes, the three-panel ``draw_scene_view`` and the
  evaluation dumps of ``visualize_from_instances`` against the JAX
  functions on the same inputs. Text glyphs are the port's own font, so both
  sides draw them as nothing here (Pillow's ``ImageDraw.text`` and the port's
  ``draw.text`` replaced by no-ops); the blended strip behind the text is
  compared like everything else. Drawing tolerance: of the pixels either side
  changed, at most 1 % may differ, each within one pixel of a pixel both
  sides changed (the comparisons with the JAX package were pixel-equal
  when written).
* ``visualize_from_instances``'s log line is equal as text; the ``logperf``
  tables are equal; the PNG writer's files read back by Pillow (in the test
  only) and by ``read_png`` as the array drawn; Pillow's bicubic resize
  (``side_by_side``) is bit-equal.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image, ImageDraw

import jax  # noqa: F401  (the JAX package below runs on the CPU platform conftest sets)

import threedod.vis.vis as jvis
from threedod.vis import logperf as jlogperf
from threedod.vis.render import render_cuboids as jax_render
from threedod_torch.vis import draw as pdraw
from threedod_torch.vis import logperf as plogperf
from threedod_torch.vis import png as ppng
from threedod_torch.vis import vis as pvis
from threedod_torch.vis.render import render_cuboids as port_render

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGNS = np.array([[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]])


def cuboids(n: int, seed: int, near: bool = False) -> np.ndarray:
    """(n, 8, 3) corners of yawed boxes in front of the camera (with
    ``near``, the first one straddles the near plane)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        c = rng.uniform([-3, -1, 4], [3, 1.5, 14])
        if near and i == 0:
            c[2] = 0.6
        d = rng.uniform(0.5, 3.0, 3)
        t = rng.uniform(-3, 3)
        R = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]])
        out.append((SIGNS * d[[2, 1, 0]] / 2) @ R.T + c)
    return np.array(out)


def drawing_difference(port: np.ndarray, ref: np.ndarray, base: np.ndarray):
    """(pixels that differ, pixels either side changed from ``base``),
    asserting that each differing pixel lies within one pixel of a pixel
    both sides changed."""
    assert port.shape == ref.shape and port.dtype == ref.dtype == np.uint8
    base = np.broadcast_to(base, ref.shape)
    differ = (port != ref).any(-1)
    both = (port != base).any(-1) & (ref != base).any(-1)
    changed = ((port != base).any(-1) | (ref != base).any(-1)).sum()
    near = np.zeros_like(both)
    p = np.pad(both, 1)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            near |= p[dy:dy + both.shape[0], dx:dx + both.shape[1]]
    assert not (differ & ~near).any(), np.argwhere(differ & ~near)[:5]
    return int(differ.sum()), int(changed)


def assert_drawings_close(port: np.ndarray, ref: np.ndarray, base: np.ndarray) -> None:
    """The drawing tolerance: of the pixels either side changed from
    ``base``, at most 1 % differ, each within one pixel of a pixel both
    changed."""
    differ, changed = drawing_difference(port, ref, base)
    assert differ <= 0.01 * max(changed, 1), (differ, changed)


@pytest.fixture
def no_glyphs(monkeypatch):
    """Both sides draw text as nothing: the glyphs are not the same font."""
    monkeypatch.setattr(ImageDraw.ImageDraw, "text", lambda self, *a, **k: None)
    monkeypatch.setattr(pdraw, "text", lambda *a, **k: None)


# ---- the rasterizer and the primitives ------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_render_cuboids_bit_equal(seed):
    corners = cuboids(1 + seed, seed, near=seed % 2 == 1)
    colors = np.random.RandomState(seed).uniform(0, 1, (len(corners), 3))
    K = np.array([[110.0, 0, 80], [0, 105.0, 60], [0, 0, 1]])
    for got, want in zip(port_render(corners, colors, K, 160, 120), jax_render(corners, colors, K, 160, 120)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(port_render(corners[:0], colors[:0], K, 16, 12), jax_render(corners[:0], colors[:0], K, 16, 12)):
        np.testing.assert_array_equal(got, want)


def _pillow(shape, fn, blend):
    im = Image.fromarray(np.full(shape, 100, np.uint8))
    fn(ImageDraw.Draw(im, "RGBA" if blend else None))
    return np.asarray(im)


@pytest.mark.parametrize("blend", [False, True], ids=["opaque", "blend"])
def test_lines_and_rectangles_equal_pillow(blend):
    rng = np.random.RandomState(int(blend))
    shape = (60, 80, 3)
    for case in range(300):
        p = rng.uniform(-30, 110, (2, 2))
        ink = (200, 30, 60, int(rng.choice([40, 170, 255])) if blend else 255)
        fill = ink if blend else ink[:3]
        mine = np.full(shape, 100, np.uint8)
        if case % 3 < 2:
            width = int(rng.choice([0, 1, 2, 3, 5]))
            want = _pillow(shape, lambda d: d.line([tuple(p[0]), tuple(p[1])], fill=fill, width=width), blend)
            pdraw.lines(mine, p, ink, width, blend)
        else:
            box = [p[0, 0], p[0, 1], p[0, 0] + abs(p[1, 0]) / 2, p[0, 1] + abs(p[1, 1]) / 2]
            kw = dict(fill=fill) if case % 2 else dict(outline=fill, width=int(rng.choice([1, 2, 3])))
            want = _pillow(shape, lambda d: d.rectangle(box, **kw), blend)
            pdraw.rectangle(mine, box, blend=blend, **kw)
        np.testing.assert_array_equal(mine, want, err_msg=f"case {case}")


def test_polygons_close_to_pillow():
    """The drawing tolerance over the 400 polygons together (one pixel of a
    12-pixel sliver is more than 1 % of it)."""
    shape = (70, 90, 3)
    differ = changed = 0
    for seed in range(400):
        rng = np.random.RandomState(seed)
        pts = rng.uniform(-20, 110, (int(rng.choice([3, 4, 5, 6])), 2))
        if seed % 4 == 1:
            pts = np.round(pts)  # flat edges
        blend = bool(seed % 2)
        ink = (200, 30, 60, int(rng.choice([40, 170, 255])) if blend else 255)
        fill = ink if blend else ink[:3]
        want = _pillow(shape, lambda d: d.polygon([tuple(q) for q in pts], fill=fill, outline=None), blend)
        mine = np.full(shape, 100, np.uint8)
        pdraw.polygon(mine, pts, fill=fill, blend=blend)
        d, c = drawing_difference(mine, want, np.full(shape, 100, np.uint8))
        differ, changed = differ + d, changed + c
        want = _pillow(shape, lambda d: d.polygon([tuple(q) for q in pts], outline=ink[:3]), False)
        mine = np.full(shape, 100, np.uint8)
        pdraw.polygon(mine, pts, outline=ink[:3])
        np.testing.assert_array_equal(mine, want, err_msg=f"outline {seed}")
    assert differ <= 0.01 * changed, (differ, changed)


def test_glyphs_stay_inside_their_strip():
    img = np.zeros((40, 120, 3), np.uint8)
    pvis.draw_text(img, "chair, z=3.1, s=0.92", (10, 20), color=(20, 200, 90))
    drawn = (img != 0).any(-1)
    ys, xs = np.nonzero(drawn)
    assert ys.min() >= 20 - 11 and ys.max() <= 20 + 1 and xs.min() >= 10 and xs.max() <= 10 + 7 * 20
    glyph = (img == 255).all(-1)  # white glyphs on the dark-blended strip
    assert glyph.sum() > 40


# ---- the JAX package's drawings -------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_scene_views_match_jax(seed, no_glyphs):
    h, w = 120, 160
    img = np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)
    K = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1]])
    corners = cuboids(1 + seed, seed, near=seed == 2)
    text = [f"{i} 0.{5 + i}" for i in range(len(corners))]
    kw = dict(text=text, blend_weight=0.5, blend_weight_overlay=0.85)
    (f1, n1), (f2, n2) = jvis.render_scene_views(img, K, corners, **kw), pvis.render_scene_views(img, K, corners, **kw)
    assert_drawings_close(f2, f1, img)
    assert_drawings_close(n2, n1, np.array([225, 225, 225], np.uint8))
    two = jvis.render_scene_views(img, K, corners, text=text, mode="2D_only")
    assert_drawings_close(pvis.render_scene_views(img, K, corners, text=text, mode="2D_only"), two, img)
    novel = jvis.render_scene_views(img, K, corners, mode="novel", scale=96)
    assert_drawings_close(pvis.render_scene_views(img, K, corners, mode="novel", scale=96), novel,
                          np.array([225, 225, 225], np.uint8))
    panel = np.asarray(jvis.draw_scene_view(img, K, corners, labels=[3] * len(corners), scores=[0.5] * len(corners)))
    got = pvis.draw_scene_view(img, K, corners, labels=[3] * len(corners), scores=[0.5] * len(corners))
    assert_drawings_close(got, panel, np.concatenate([img, np.full((h, h, 3), 225, np.uint8)], 1))
    bev = np.asarray(jvis.draw_bev(list(corners), size=h))
    assert_drawings_close(pvis.draw_bev(list(corners), size=h), bev, np.array([245, 245, 245], np.uint8))


def test_filled_boxes_and_2d_boxes_match_jax(no_glyphs):
    h, w = 120, 160
    img = np.random.RandomState(7).randint(0, 256, (h, w, 3)).astype(np.uint8)
    K = np.array([[150.0, 0, w / 2], [0, 150.0, h / 2], [0, 0, 1]])
    ref, mine = Image.fromarray(img.copy()), img.copy()
    for i, c in enumerate(cuboids(3, 7)):
        jvis.draw_box_3d(ref, c, K, color=pvis.get_color(i), width=2, fill_faces=True)
        pvis.draw_box_3d(mine, c, K, color=pvis.get_color(i), width=2, fill_faces=True)
    assert_drawings_close(mine, np.asarray(ref), img)
    boxes = np.array([[10.3, 12.7, 60.2, 70.9], [-5.0, 40.0, 150.0, 130.0]])
    ref = np.asarray(jvis.draw_boxes_2d(Image.fromarray(img.copy()), boxes, labels=["a", "b"], scores=[0.3, 0.9]))
    assert_drawings_close(pvis.draw_boxes_2d(img.copy(), boxes, labels=["a", "b"], scores=[0.3, 0.9]), ref, img)


def _records_and_detections():
    """Three fixture images' records (contiguous ids) and detections made
    from their ground truth, shifted so the errors are not zero."""
    with open(os.path.join(ROOT, "datasets", "Omni3D", "synth_test.json")) as f:
        data = json.load(f)
    records, dets = [], []
    rng = np.random.RandomState(3)
    for im in data["images"][:3]:
        annos = [dict(a, category_id=a["category_id"] - 1) for a in data["annotations"] if a["image_id"] == im["id"]]
        records.append({"file_name": os.path.join(ROOT, "datasets", im["file_path"]), "image_id": im["id"],
                        "K": im["K"], "width": im["width"], "height": im["height"], "annotations": annos})
        K = np.array(im["K"])
        inst = []
        for a in annos:
            cen = np.array(a["center_cam"]) + rng.normal(0, 0.1, 3)
            uv = K @ cen
            inst.append({"category_id": a["category_id"], "score": float(rng.uniform(0.3, 1.0)),
                         "bbox": list(np.array(a["bbox"]) + rng.normal(0, 2, 4)), "center_2D": list(uv[:2] / uv[2]),
                         "center_cam": list(cen), "dimensions": list(np.array(a["dimensions"]) * 1.1),
                         "pose": a["pose"]})
        dets.append({"image_id": im["id"], "K": im["K"], "width": im["width"], "height": im["height"],
                     "instances": inst})
    return records, dets


def test_visualize_from_instances_matches_jax(tmp_path, no_glyphs, monkeypatch):
    records, dets = _records_and_detections()
    cats = ["chair", "table", "sofa", "bed", "lamp", "shelf", "desk", "cabinet", "tv", "plant"]
    saved = {}
    monkeypatch.setattr(Image.Image, "save", lambda self, path, *a, **k: saved.setdefault(
        os.path.basename(path), np.asarray(self.convert("RGB"))))
    want = jvis.visualize_from_instances(dets, records, "synth_test", 512, str(tmp_path / "jax"), cats, 7,
                                         visualize_every=1, score_thres=0.2)
    got = pvis.visualize_from_instances(dets, records, "synth_test", 512, str(tmp_path / "port"), cats, 7,
                                        visualize_every=1, score_thres=0.2)
    assert got == want
    assert "xy(" in got and "ry(1000.00)" not in got
    for i, rec in enumerate(records):
        drawn = ppng.read_png(str(tmp_path / "port" / "vis" / f"{i:06d}.png"))
        base = np.asarray(Image.open(rec["file_name"]).convert("RGB"))
        assert (drawn != base).any()
        assert_drawings_close(drawn, saved[f"{i:06d}.jpg"], base)


def test_logperf_tables_equal(capsys):
    per_cat = {"chair": 12.3456, "table": 0.5, "sofa": 99.0}
    results = {"synth_test": {"AP2D": 10.0, "AP3D": 5.25, "AP3D@15": 7.0, "AP3D@25": 6.0, "AP3D@50": 1.0,
                              "AP3D_near": 3.0, "AP3D_med": 2.0, "AP3D_far": 1.5},
               "other": {"AP2D": 1.0}, "skipped": 3}
    assert plogperf.print_ap_category_table(per_cat) == jlogperf.print_ap_category_table(per_cat)
    assert plogperf.print_ap_analysis_table(results) == jlogperf.print_ap_analysis_table(results)
    assert plogperf.print_omni_summary(results) == jlogperf.print_omni_summary(results)
    out = capsys.readouterr().out
    assert out.count("3D AP analysis") == 2


def test_png_round_trip(tmp_path):
    img = np.random.RandomState(0).randint(0, 256, (37, 53, 3)).astype(np.uint8)
    path = str(tmp_path / "x.png")
    ppng.write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == "RGB" and im.size == (53, 37)
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(ppng.read_png(path), img)
    Image.fromarray(img).save(str(tmp_path / "pillow.png"))  # Pillow filters its rows, and read_png undoes them
    np.testing.assert_array_equal(ppng.read_png(str(tmp_path / "pillow.png")), img)
    Image.fromarray((img[..., 0].astype(np.uint16) * 257)).save(str(tmp_path / "16bit.png"))
    with Image.open(str(tmp_path / "16bit.png")) as im:  # 16-bit gray: Pillow's I;16, clamped at 255
        np.testing.assert_array_equal(ppng.read_png(str(tmp_path / "16bit.png")), np.asarray(im.convert("RGB")))
    (tmp_path / "cut.png").write_bytes((tmp_path / "16bit.png").read_bytes()[:40])
    with pytest.raises(ValueError, match="cut.png: "):
        ppng.read_png(str(tmp_path / "cut.png"))
    with pytest.raises(ValueError):
        ppng.write_png(path, img[..., :2])


def test_side_by_side_resizes_like_pillow():
    a = np.random.RandomState(1).randint(0, 256, (40, 30, 3)).astype(np.uint8)
    b = np.random.RandomState(2).randint(0, 256, (64, 64, 3)).astype(np.uint8)
    want = np.asarray(Image.fromarray(b).resize((40, 40)))
    got = pvis.side_by_side([a, b])
    np.testing.assert_array_equal(got[:, :30], a)
    np.testing.assert_array_equal(got[:, 30:], want)
    rng = np.random.RandomState(3)
    for h, w, nh, nw in ((50, 70, 31, 90), (20, 33, 60, 61), (480, 640, 240, 320)):
        x = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        from threedod_torch.data.resize import resize_bicubic

        np.testing.assert_array_equal(resize_bicubic(torch.from_numpy(x), nh, nw).numpy(),
                                      np.asarray(Image.fromarray(x).resize((nw, nh), Image.BICUBIC)))
