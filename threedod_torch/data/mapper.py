"""Per-sample transform: decode, resize, flip with the pose mirrored, pad onto
the canvas (counterpart of ``threedod/data/mapper.py``, after
cubercnn/data/dataset_mapper.py).

``DatasetMapper3D(cfg, is_train, rng, device)`` draws, from one
``np.random.RandomState`` and in the JAX mapper's order, the train scale
(``_scale_for``) and then the flip. The image is decoded and resized on
``device`` (``image_io.imread_rgb``, ``resize.resize_bilinear``: Pillow's
bits) and the resized image is cached there, keyed by (path, size), within a
byte budget (oldest out first): a fixture-sized dataset is decoded once. The
canvas is uint8 (canvas_h, canvas_w, 3) on ``device``; the ground truth is
numpy: 2D boxes XYXY at network resolution (mirrored by a flip), 3D rows
[u, v, z, w, h, l, x, y, z] and poses mirrored as ``_M1 @ R @ _M2``.

With ``load_maps`` (weak Cube R-CNN, BoxNet) the sample also holds the
record's depth and ground maps (``.npz`` files read with numpy, keys
``depth`` and ``mask``), resized nearest as Pillow does
(``resize.resize_nearest``), flipped with the image and padded onto the
canvas as float32 on ``device`` (zeros where the record has no file); the
resized maps are cached like the images. A training sample also holds
``gt_masks``, numpy float32 (annotations, canvas_h / 4, canvas_w / 4): the
stored instance mask of each annotation (``object_masks_path``, keys
``masks`` and ``ann_ids``) resized nearest and flipped, else the
annotation's 2D box filled on that quarter-resolution grid.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .image_io import image_hw, imread_rgb
from .resize import resize_bilinear, resize_nearest

_M1 = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
_M2 = np.array([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
CACHE_BYTES = 512_000_000  # resized images and maps kept on the device


class DatasetMapper3D:
    """Record dict -> fixed-shape sample dict."""

    def __init__(self, cfg, is_train: bool = True, load_maps: bool = False,
                 rng: Optional[np.random.RandomState] = None, device="cpu"):
        self.is_train = is_train
        self.load_maps = load_maps
        self.canvas_h = cfg.shapes.canvas_height
        self.canvas_w = cfg.shapes.canvas_width
        self.min_sizes_train = cfg.input.min_size_train
        self.min_size_test = cfg.input.min_size_test
        self.max_size = cfg.input.max_size_train if is_train else cfg.input.max_size_test
        self.random_flip = cfg.input.random_flip and is_train
        self.format = cfg.input.format
        self.rng = rng or np.random.RandomState(cfg.seed)
        self.device = torch.device(device)
        self._cache: Dict[tuple, torch.Tensor] = {}
        self._cache_bytes = 0
        # decoded (h, w) per path: the record's height and width are checked
        # against the pixels on the first decode
        self._true_dims: Dict[str, Tuple[int, int]] = {}

    def _decode(self, path: str, size_key: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        key = (path, size_key)
        rgb = self._cache.get(key)
        if rgb is not None:
            return rgb
        rgb = imread_rgb(path, self.device)
        self._true_dims[path] = tuple(rgb.shape[:2])
        if size_key is not None:
            rgb = resize_bilinear(rgb, size_key[1], size_key[0])
        return self._remember(key, rgb)

    def _remember(self, key, value: torch.Tensor) -> torch.Tensor:
        self._cache[key] = value
        self._cache_bytes += value.numel() * value.element_size()
        while self._cache_bytes > CACHE_BYTES:
            old = self._cache.pop(next(iter(self._cache)))
            self._cache_bytes -= old.numel() * old.element_size()
        return value

    def _scale_for(self, h: int, w: int) -> float:
        if self.is_train:
            min_size = int(self.rng.choice(self.min_sizes_train))
        else:
            min_size = self.min_size_test
        scale = min_size / min(h, w)
        scale = min(scale, self.max_size / max(h, w))
        # the resized image must fit the canvas
        return min(scale, self.canvas_h / h, self.canvas_w / w)

    def __call__(self, record: dict) -> dict:
        h0, w0 = record.get("height"), record.get("width")
        if h0 is None or w0 is None:
            rgb = self._decode(record["file_name"])
            h0, w0 = rgb.shape[:2]
            scale = self._scale_for(h0, w0)
            nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
            image = resize_bilinear(rgb, nh, nw)
        else:
            scale = self._scale_for(h0, w0)
            nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
            image = self._decode(record["file_name"], size_key=(nw, nh))
            true_hw = self._true_dims.get(record["file_name"])
            if true_hw is not None and tuple(true_hw) != (h0, w0):
                # stale record metadata: sizes from the decoded pixels
                h0, w0 = true_hw
                scale = self._scale_for(h0, w0)
                nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
                image = self._decode(record["file_name"], size_key=(nw, nh))
        if self.format == "BGR":
            image = image.flip(2)

        do_flip = self.random_flip and self.rng.rand() < 0.5
        if do_flip:
            image = image.flip(1)

        # uint8 on the wire; the model normalises on the device
        canvas = torch.zeros((self.canvas_h, self.canvas_w, 3), dtype=torch.uint8, device=self.device)
        canvas[:nh, :nw] = image

        sample = {
            "image": canvas,
            "image_hw": np.array([nh, nw], np.int32),
            "K": np.asarray(record["K"], np.float32),
            "im_scale_ratio": h0 / nh,  # original height / network height
            "image_id": record.get("image_id", -1),
            "height": h0,
            "width": w0,
            "dataset_id": record.get("dataset_id", 0),
        }
        if self.load_maps:
            sample["depth_map"] = self._load_map(record.get("depth_image_path"), "depth", nh, nw, do_flip)
            sample["ground_map"] = self._load_map(record.get("ground_image_path"), "mask", nh, nw, do_flip)

        annos = record.get("annotations")
        if annos is not None:
            K = np.asarray(record["K"], np.float64)
            boxes, classes, boxes3d, poses = [], [], [], []
            for anno in annos:
                x, y, bw, bh = anno["bbox"]  # XYWH
                box = np.array([x, y, x + bw, y + bh], np.float64) * scale
                if do_flip:
                    box = np.array([nw - box[2], box[1], nw - box[0], box[3]])

                cam = np.asarray(anno["center_cam"], np.float64)
                if cam[2] != 0:
                    uvz = K @ cam
                    u, v = uvz[0] / uvz[2], uvz[1] / uvz[2]
                else:
                    u = v = 0.0
                u, v = u * scale, v * scale
                if do_flip:
                    u = nw - u

                pose = np.asarray(anno["pose"], np.float32)
                if do_flip:
                    pose = _M1 @ pose @ _M2

                boxes.append(box.astype(np.float32))
                classes.append(int(anno["category_id"]))
                boxes3d.append(np.concatenate([[u, v, cam[2]], np.asarray(anno["dimensions"]), cam]).astype(np.float32))
                poses.append(pose)

            sample["gt_boxes2d"] = np.asarray(boxes, np.float32).reshape(-1, 4)
            sample["gt_classes"] = np.asarray(classes, np.int32)
            sample["gt_boxes3d"] = np.asarray(boxes3d, np.float32).reshape(-1, 9)
            sample["gt_poses"] = np.asarray(poses, np.float32).reshape(-1, 3, 3)
            if self.load_maps and self.is_train:  # the weak losses' masks; BoxNet fills its boxes
                sample["gt_masks"] = self._load_object_masks(record, annos, sample["gt_boxes2d"], nh, nw, do_flip)
        return sample

    def skip(self, record: dict) -> None:
        """Draw what mapping ``record`` draws, and map nothing: a rank that
        maps only its rows of a global batch keeps the stream of one process
        (``TrainLoader``). A record whose height and width disagree with its
        pixels draws a second scale, as ``__call__`` does; the pixels' size
        comes from the image's header where the record was never decoded."""
        if self.is_train:
            h0, w0 = record.get("height"), record.get("width")
            stale = False
            if h0 is not None and w0 is not None:
                path = record["file_name"]
                if path not in self._true_dims:
                    self._true_dims[path] = tuple(image_hw(path))
                stale = self._true_dims[path] != (h0, w0)
            for _ in range(1 + stale):
                self.rng.choice(self.min_sizes_train)
        if self.random_flip:
            self.rng.rand()

    def _load_map(self, path, key: str, nh: int, nw: int, do_flip: bool) -> torch.Tensor:
        canvas = torch.zeros((self.canvas_h, self.canvas_w), dtype=torch.float32, device=self.device)
        if path is None or not os.path.exists(path):
            return canvas
        m = self._cache.get((path, key, nh, nw))
        if m is None:
            with np.load(path) as z:
                arr = torch.from_numpy(np.asarray(z[key], np.float32)).to(self.device)
            m = self._remember((path, key, nh, nw), resize_nearest(arr, nh, nw))
        canvas[:nh, :nw] = m.flip(1) if do_flip else m
        return canvas

    def _load_object_masks(self, record, annos, boxes2d, nh: int, nw: int, do_flip: bool) -> np.ndarray:
        """(annotations, canvas_h // 4, canvas_w // 4) float32 instance masks."""
        hm, wm = self.canvas_h // 4, self.canvas_w // 4
        out = np.zeros((len(annos), hm, wm), np.float32)
        stored = {}
        path = record.get("object_masks_path")
        if path is not None and os.path.exists(path):
            with np.load(path) as z:
                stored = {int(a): m for a, m in zip(z["ann_ids"], z["masks"])}
        rh, rw = max(round(nh / 4), 1), max(round(nw / 4), 1)
        for i, anno in enumerate(annos):
            m = stored.get(int(anno.get("ann_id", -1)))
            if m is not None:
                mi = resize_nearest(torch.from_numpy(m.astype(np.uint8)), rh, rw).numpy()
                out[i, :rh, :rw] = mi[:, ::-1] if do_flip else mi
            else:  # the 2D box, network resolution -> the mask grid
                x1, y1, x2, y2 = boxes2d[i] / 4.0
                ys, xs = np.arange(hm)[:, None], np.arange(wm)[None, :]
                out[i] = ((ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)).astype(np.float32)
        return out
