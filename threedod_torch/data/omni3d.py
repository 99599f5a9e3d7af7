"""Omni3D JSON datasets on the host, in numpy (the port's copy of
``threedod/data/omni3d.py``, after cubercnn/data/datasets.py: ``is_ignore``
:83-123, the multi-json ``Omni3D`` merge :141-301, ``load_omni3d_json``
:339-480).

The Omni3D schema is parsed directly; ``Omni3D`` carries the few COCO
calls that the priors need (getAnnIds, loadAnns, imgs).
"""
from __future__ import annotations

import json
import logging
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)


def xyxy_to_xywh(b):
    return [b[0], b[1], b[2] - b[0], b[3] - b[1]]


def get_filter_settings_from_cfg(cfg=None) -> dict:
    """Filter settings dict (parity: datasets.py:53-80)."""
    if cfg is None:
        return {
            "category_names": [],
            "ignore_names": [],
            "truncation_thres": 0.99,
            "visibility_thres": 0.01,
            "min_height_thres": 0.00,
            "max_height_thres": 1.50,
            "modal_2D_boxes": False,
            "trunc_2D_boxes": False,
            "max_depth": 1e8,
        }
    d = cfg.datasets
    return {
        "category_names": list(d.category_names),
        "ignore_names": list(d.ignore_names),
        "truncation_thres": d.truncation_thres,
        "visibility_thres": d.visibility_thres,
        "min_height_thres": d.min_height_thres,
        "max_height_thres": d.max_height_thres,
        "modal_2D_boxes": d.modal_2d_boxes,
        "trunc_2D_boxes": d.trunc_2d_boxes,
        "max_depth": d.max_depth,
    }


def _select_bbox2d(anno: dict, filter_settings: dict):
    """2D box preference: tight (modal) -> trunc -> proj. XYWH or None."""
    if (
        filter_settings.get("modal_2D_boxes", False)
        and "bbox2D_tight" in anno
        and anno["bbox2D_tight"][0] != -1
    ):
        return xyxy_to_xywh(anno["bbox2D_tight"])
    if (
        filter_settings.get("trunc_2D_boxes", False)
        and "bbox2D_trunc" in anno
        and not np.all([v == -1 for v in anno["bbox2D_trunc"]])
    ):
        return xyxy_to_xywh(anno["bbox2D_trunc"])
    if "bbox2D_proj" in anno and anno["bbox2D_proj"][0] != -1:
        return xyxy_to_xywh(anno["bbox2D_proj"])
    return None


def is_ignore(anno: dict, filter_settings: dict, image_height: float) -> bool:
    """Annotation ignore rules (parity: datasets.py:83-123)."""
    ignore = bool(anno.get("behind_camera", False))
    ignore |= not bool(anno.get("valid3D", True))
    if ignore:
        return True

    dims = anno["dimensions"]
    ignore |= dims[0] <= 0.01 or dims[1] <= 0.01 or dims[2] <= 0.01
    ignore |= anno["center_cam"][2] > filter_settings["max_depth"]
    ignore |= anno.get("lidar_pts", 1) == 0
    ignore |= anno.get("segmentation_pts", 1) == 0
    ignore |= anno.get("depth_error", 0.0) > 0.5

    bbox2D = _select_bbox2d(anno, filter_settings)
    if bbox2D is None:
        bbox2D = anno.get("bbox", [0, 0, 0, 0])

    ignore |= bbox2D[3] <= filter_settings["min_height_thres"] * image_height
    ignore |= bbox2D[3] >= filter_settings["max_height_thres"] * image_height

    trunc = anno.get("truncation", -1)
    vis = anno.get("visibility", -1)
    ignore |= trunc >= 0 and trunc >= filter_settings["truncation_thres"]
    ignore |= vis >= 0 and vis <= filter_settings["visibility_thres"]

    if "ignore_names" in filter_settings:
        ignore |= anno["category_name"] in filter_settings["ignore_names"]

    return bool(ignore)


class Omni3D:
    """Multi-json Omni3D merge + filtering (parity: datasets.py Omni3D).

    Provides the subset of the pycocotools COCO API used downstream:
    getAnnIds / loadAnns / imgs / cats / dataset.
    """

    def __init__(self, annotation_files, filter_settings: Optional[dict] = None):
        if isinstance(annotation_files, str):
            annotation_files = [annotation_files]

        self.dataset: dict = {}
        cats_ids_master: list = []
        cats_master: list = []

        for annotation_file in annotation_files:
            logger.info("loading %s annotations into memory...", annotation_file)
            with open(annotation_file) as f:
                data = json.load(f)
            if isinstance(data.get("info"), list):
                data["info"] = data["info"][0]
            data.setdefault("info", {})
            data["info"]["known_category_ids"] = [c["id"] for c in data["categories"]]

            if not self.dataset:
                self.dataset = data
            else:
                if isinstance(self.dataset["info"], dict):
                    self.dataset["info"] = [self.dataset["info"]]
                self.dataset["info"] += [data["info"]]
                self.dataset["annotations"] += data["annotations"]
                self.dataset["images"] += data["images"]

            for cat in data["categories"]:
                if cat["id"] not in cats_ids_master:
                    cats_ids_master.append(cat["id"])
                    cats_master.append(cat)

        order = np.argsort(cats_ids_master)

        if filter_settings is None:
            self.dataset["categories"] = [cats_master[i] for i in order]
        else:
            trainable = set(filter_settings["ignore_names"]) | set(
                filter_settings["category_names"]
            )
            if len(filter_settings["category_names"]) > 0:
                self.dataset["categories"] = [
                    cats_master[i]
                    for i in order
                    if cats_master[i]["name"] in filter_settings["category_names"]
                ]
            else:
                self.dataset["categories"] = [cats_master[i] for i in order]
                filter_settings["category_names"] = [
                    c["name"] for c in self.dataset["categories"]
                ]
                trainable |= set(filter_settings["category_names"])

            im_height = {im["id"]: im["height"] for im in self.dataset["images"]}
            valid_anns = []
            for anno in self.dataset["annotations"]:
                ignore = is_ignore(anno, filter_settings, im_height[anno["image_id"]])

                bbox2D = _select_bbox2d(
                    anno, {**filter_settings, "modal_2D_boxes": False}
                )
                if bbox2D is None:
                    if "bbox2D_tight" in anno and anno["bbox2D_tight"][0] != -1:
                        bbox2D = xyxy_to_xywh(anno["bbox2D_tight"])
                    else:
                        continue

                anno["area"] = bbox2D[2] * bbox2D[3]
                anno["iscrowd"] = False
                anno["ignore"] = ignore
                anno["ignore2D"] = ignore
                anno["ignore3D"] = ignore
                if (
                    filter_settings["modal_2D_boxes"]
                    and anno.get("bbox2D_tight", [-1])[0] != -1
                ):
                    anno["bbox"] = xyxy_to_xywh(anno["bbox2D_tight"])
                else:
                    anno["bbox"] = bbox2D
                anno["bbox3D"] = anno.get("bbox3D_cam")
                anno["depth"] = anno["center_cam"][2]

                if anno["category_name"] in trainable and not ignore:
                    valid_anns.append(anno)
            self.dataset["annotations"] = valid_anns

        self._create_index()

    def _create_index(self):
        self.anns = {a["id"]: a for a in self.dataset["annotations"]}
        self.imgs = {im["id"]: im for im in self.dataset["images"]}
        self.cats = {c["id"]: c for c in self.dataset["categories"]}
        self.imgToAnns = defaultdict(list)
        for a in self.dataset["annotations"]:
            self.imgToAnns[a["image_id"]].append(a)

    # --- minimal COCO API ---------------------------------------------------
    def getAnnIds(self):
        return list(self.anns.keys())

    def loadAnns(self, ids):
        return [self.anns[i] for i in ids]


# ---- the dataset registry (for detectron2's DatasetCatalog and MetadataCatalog)

@dataclass
class DatasetMetadata:
    name: str
    json_file: str = ""
    thing_classes: List[str] = field(default_factory=list)
    thing_dataset_id_to_contiguous_id: Dict[int, int] = field(default_factory=dict)


class _Catalog:
    def __init__(self):
        self._loaders: Dict[str, callable] = {}
        self._meta: Dict[str, DatasetMetadata] = {}

    def register(self, name, loader):
        self._loaders[name] = loader

    def get(self, name):
        return self._loaders[name]()

    def metadata(self, name) -> DatasetMetadata:
        if name not in self._meta:
            self._meta[name] = DatasetMetadata(name=name)
        return self._meta[name]

    def clear(self):
        self._loaders.clear()
        self._meta.clear()


CATALOG = _Catalog()


def register_and_store_model_metadata(datasets: Omni3D, output_dir: str, filter_settings: dict):
    """Fix the model's category list + contiguous id map (datasets.py:303-336)."""
    os.makedirs(output_dir, exist_ok=True)
    output_file = os.path.join(output_dir, "category_meta.json")

    if os.path.exists(output_file):
        with open(output_file) as f:
            metadata = json.load(f)
        thing_classes = metadata["thing_classes"]
        id_map = {int(k): v for k, v in metadata["thing_dataset_id_to_contiguous_id"].items()}
    else:
        thing_classes = list(filter_settings["category_names"])
        name_to_id = {c["name"]: c["id"] for c in datasets.dataset["categories"]}
        cat_ids = [name_to_id[c] for c in thing_classes]
        ordering = np.argsort(cat_ids)
        cat_ids = [cat_ids[i] for i in ordering]
        thing_classes = [thing_classes[i] for i in ordering]
        id_map = {int(cid): i for i, cid in enumerate(cat_ids)}
        with open(output_file, "w") as f:
            json.dump(
                {
                    "thing_classes": thing_classes,
                    "thing_dataset_id_to_contiguous_id": id_map,
                },
                f,
            )

    meta = CATALOG.metadata("omni3d_model")
    meta.thing_classes = thing_classes
    meta.thing_dataset_id_to_contiguous_id = id_map
    return meta


def load_omni3d_json(json_file, image_root, dataset_name, filter_settings, filter_empty=True):
    """Per-image record dicts (parity: datasets.py:339-480)."""
    with open(json_file) as f:
        data = json.load(f)

    meta_model = CATALOG.metadata("omni3d_model")
    id_map = meta_model.thing_dataset_id_to_contiguous_id

    meta = CATALOG.metadata(dataset_name)
    names = set(filter_settings["category_names"])
    cats = sorted(
        [c for c in data["categories"] if not names or c["name"] in names],
        key=lambda c: c["id"],
    )
    meta.thing_classes = [c["name"] for c in cats]
    meta.thing_dataset_id_to_contiguous_id = id_map
    meta.json_file = json_file

    img_anns = defaultdict(list)
    for a in data["annotations"]:
        img_anns[a["image_id"]].append(a)

    # optional precomputed asset maps (depth / ground), same layout as the
    # reference: datasets/{depth,ground}_maps/{image_id}.npz
    def _asset_ids(sub):
        d = os.path.join(image_root, sub)
        if not os.path.isdir(d):
            return set()
        out = set()
        for f_ in os.listdir(d):
            try:
                out.add(int(f_.split(".")[0]))
            except ValueError:
                pass
        return out

    depth_idx = _asset_ids("depth_maps")
    objmask_idx = _asset_ids("object_masks")
    ground_idx = _asset_ids("ground_maps")

    ann_keys = [
        "bbox", "bbox3D_cam", "bbox2D_proj", "bbox2D_trunc", "bbox2D_tight",
        "center_cam", "dimensions", "pose", "R_cam", "category_id",
    ]

    dataset_dicts = []
    invalid = 0
    for img in sorted(data["images"], key=lambda im: im["id"]):
        record = {
            "file_name": os.path.join(image_root, img["file_path"]),
            "dataset_id": img.get("dataset_id", 0),
            "height": img["height"],
            "width": img["width"],
            "K": img["K"],
            "image_id": img["id"],
        }
        if "p2" in img:
            record["p2"] = img["p2"]
        if img["id"] in depth_idx:
            record["depth_image_path"] = os.path.join(image_root, "depth_maps", f"{img['id']}.npz")
        if img["id"] in ground_idx:
            record["ground_image_path"] = os.path.join(image_root, "ground_maps", f"{img['id']}.npz")
        if img["id"] in objmask_idx:
            # per-annotation instance masks, precomputed (the weak path's)
            record["object_masks_path"] = os.path.join(image_root, "object_masks", f"{img['id']}.npz")

        objs = []
        has_valid = False
        for anno in img_anns[img["id"]]:
            obj = {k: anno[k] for k in ann_keys if k in anno}
            if anno["category_id"] not in id_map and anno["category_name"] not in filter_settings["ignore_names"]:
                continue
            ignore = is_ignore(anno, filter_settings, img["height"])
            obj["iscrowd"] = False
            obj["ignore"] = ignore
            obj["ann_id"] = anno.get("id", -1)

            bbox2D = _select_bbox2d(anno, filter_settings)
            if bbox2D is None:
                continue
            obj["bbox"] = bbox2D  # XYWH
            obj["pose"] = anno["R_cam"]
            obj["category_id"] = -1 if ignore else id_map[anno["category_id"]]
            objs.append(obj)
            has_valid |= not ignore

        if has_valid or not filter_empty:
            record["annotations"] = objs
            dataset_dicts.append(record)
        else:
            invalid += 1

    logger.info(
        "Loaded %d images (%d filtered) from %s", len(dataset_dicts), invalid, json_file
    )
    return dataset_dicts
