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

Under a process group (``parallel.dist``) both loaders give this rank its
part. ``TrainLoader`` draws the global batch as one process would and maps
this rank's rows only; the other rows' draws are still made, in order
(``DatasetMapper3D.skip``), so each rank's rows are those of the one-process
batch. ``TestLoader`` gives each rank a contiguous run of whole batches, so
every batch is the one-process loader's and the ranks' predictions,
gathered in rank order, are in the dataset's order.
"""
from __future__ import annotations

import math
from typing import Iterator, List

import numpy as np

from ..parallel import dist
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
    on ``device`` (this rank's rows of them under a process group);
    ``load_maps`` adds the depth and ground maps and the instance masks (weak
    Cube R-CNN)."""

    def __init__(self, dataset_dicts: List[dict], cfg, seed: int = 0, device="cpu", load_maps: bool = False):
        assert len(dataset_dicts) > 0, "empty dataset"
        self.dicts = dataset_dicts
        self.batch_size = cfg.solver.ims_per_batch  # the global batch
        dist.check_divides(self.batch_size)
        n = self.batch_size // dist.world_size()
        self.rows = range(dist.rank() * n, (dist.rank() + 1) * n)  # this rank's
        self.max_gt = cfg.shapes.max_gt
        self.rng = np.random.RandomState(seed)
        self.mapper = DatasetMapper3D(cfg, is_train=True, load_maps=load_maps, rng=self.rng, device=device)
        weights = repeat_factors_from_category_frequency(dataset_dicts, REPEAT_THRESH)
        self.probs = weights / weights.sum()

    def next_batch(self) -> Batch:
        idx = self.rng.choice(len(self.dicts), size=self.batch_size, p=self.probs)
        samples = []
        for row, i in enumerate(idx):
            if row in self.rows:
                samples.append(self.mapper(self.dicts[i]))
            else:
                self.mapper.skip(self.dicts[i])
        return collate(samples, self.max_gt)

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
    its filled 2D boxes. Under a process group it gives this rank's
    contiguous run of the batches (rank r of W: batches r * n // W to
    (r + 1) * n // W - 1 of the n)."""

    __test__ = False  # not a pytest class

    def __init__(self, dataset_dicts: List[dict], cfg, device="cpu", load_maps: bool = False):
        self.dicts = dataset_dicts
        self.batch_size = cfg.test.batch_size
        self.max_gt = cfg.shapes.max_gt
        self.mapper = DatasetMapper3D(cfg, is_train=False, load_maps=load_maps, device=device)
        n, w, r = math.ceil(len(self.dicts) / self.batch_size), dist.world_size(), dist.rank()
        self.batches = range(r * n // w, (r + 1) * n // w)

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for k in self.batches:
            start = k * self.batch_size
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
