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

The weak path's depth and ground maps and object masks (``load_maps``) are
not ported yet.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .image_io import imread_rgb
from .resize import resize_bilinear

_M1 = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
_M2 = np.array([[-1.0, 0.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
CACHE_BYTES = 512_000_000  # resized images kept on the device


class DatasetMapper3D:
    """Record dict -> fixed-shape sample dict."""

    def __init__(self, cfg, is_train: bool = True, load_maps: bool = False,
                 rng: Optional[np.random.RandomState] = None, device="cpu"):
        if load_maps:
            raise NotImplementedError("depth and ground maps and object masks (the weak path) are not ported yet")
        self.is_train = is_train
        self.canvas_h = cfg.shapes.canvas_height
        self.canvas_w = cfg.shapes.canvas_width
        self.min_sizes_train = cfg.input.min_size_train
        self.min_size_test = cfg.input.min_size_test
        self.max_size = cfg.input.max_size_train if is_train else cfg.input.max_size_test
        self.random_flip = cfg.input.random_flip and is_train
        self.format = cfg.input.format
        self.rng = rng or np.random.RandomState(cfg.seed)
        self.device = torch.device(device)
        self._cache: Dict[Tuple[str, Tuple[int, int]], torch.Tensor] = {}
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
        self._cache[key] = rgb
        self._cache_bytes += rgb.numel()
        while self._cache_bytes > CACHE_BYTES:
            self._cache_bytes -= self._cache.pop(next(iter(self._cache))).numel()
        return rgb

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
        return sample
