"""Data loaders: repeat-factor sampling of training images, and the test
loader (counterpart of ``threedod/data/build.py``, after
cubercnn/data/build.py).

``TrainLoader`` is one thread: per batch it draws the images' indices from
the repeat-factor probabilities, then maps each image in turn, which draws
its scale and its flip, all from one ``np.random.RandomState(seed)``; so a
seed fixes the whole stream. (The JAX loader maps in a pool of threads that
share the generator, so its order of draws is not fixed.) The mapper's cache
keeps the resized images on the device, so after the first epoch a batch
costs a flip, a canvas copy and a stack there.
"""
from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np

from .batch import Batch, collate
from .mapper import DatasetMapper3D
from .omni3d import CATALOG

REPEAT_THRESH = 0.1  # cubercnn's DATASETS.REPEAT_THRESHOLD


def repeat_factors_from_category_frequency(dataset_dicts: List[dict], repeat_thresh: float) -> np.ndarray:
    """Per-image repeat factor r(I) = max over the categories c in I of
    max(1, sqrt(t / f(c))), f(c) the share of images holding c."""
    category_freq: dict = {}
    for d in dataset_dicts:
        for anno in d["annotations"]:
            if anno["category_id"] >= 0:
                category_freq[anno["category_id"]] = category_freq.get(anno["category_id"], 0) + 1
    num_images = max(len(dataset_dicts), 1)
    for k in category_freq:
        category_freq[k] /= num_images

    rep = np.ones(len(dataset_dicts))
    for i, d in enumerate(dataset_dicts):
        cats = {a["category_id"] for a in d["annotations"] if a["category_id"] >= 0}
        if cats:
            rep[i] = max(max(1.0, math.sqrt(repeat_thresh / category_freq[c])) for c in cats)
    return rep


class TrainLoader:
    """Endless loader of padded Batches of ``cfg.solver.ims_per_batch`` images
    on ``device``; ``load_maps`` adds the depth and ground maps and the
    instance masks (weak Cube R-CNN)."""

    def __init__(self, dataset_dicts: List[dict], cfg, seed: int = 0, device="cpu", load_maps: bool = False):
        assert len(dataset_dicts) > 0, "empty dataset"
        self.dicts = dataset_dicts
        self.batch_size = cfg.solver.ims_per_batch
        self.max_gt = cfg.shapes.max_gt
        self.rng = np.random.RandomState(seed)
        self.mapper = DatasetMapper3D(cfg, is_train=True, load_maps=load_maps, rng=self.rng, device=device)
        weights = repeat_factors_from_category_frequency(dataset_dicts, REPEAT_THRESH)
        self.probs = weights / weights.sum()

    def next_batch(self) -> Batch:
        idx = self.rng.choice(len(self.dicts), size=self.batch_size, p=self.probs)
        return collate([self.mapper(self.dicts[i]) for i in idx], self.max_gt)

    def __iter__(self) -> Iterator[Batch]:
        while True:
            yield self.next_batch()


class TestLoader:
    """The records in order, in batches of ``cfg.test.batch_size``; the last
    batch is padded by repeating its last record. Yields (batch, number of
    real images). A record's annotations, where it has them, give the
    batch's ground truth at the test scale, unflipped. ``load_maps`` adds
    each image's depth and ground maps (zeros where the record has none), as
    the training loader does: the propose-and-score tool reads them
    (``eval_boxes.py``). It builds no instance masks: BoxNet scores against
    its filled 2D boxes."""

    __test__ = False  # not a pytest class

    def __init__(self, dataset_dicts: List[dict], cfg, device="cpu", load_maps: bool = False):
        self.dicts = dataset_dicts
        self.batch_size = cfg.test.batch_size
        self.max_gt = cfg.shapes.max_gt
        self.mapper = DatasetMapper3D(cfg, is_train=False, load_maps=load_maps, device=device)

    def __len__(self):
        return math.ceil(len(self.dicts) / self.batch_size)

    def __iter__(self):
        for start in range(0, len(self.dicts), self.batch_size):
            chunk = self.dicts[start:start + self.batch_size]
            n_real = len(chunk)
            chunk = chunk + [chunk[-1]] * (self.batch_size - n_real)
            yield collate([self.mapper(d) for d in chunk], self.max_gt), n_real


def get_dataset_dicts(names) -> List[dict]:
    """The registered datasets' records, concatenated."""
    out = []
    for name in names:
        out.extend(CATALOG.get(name))
    return out
