"""Category sets of the Omni3D splits (the port's copy of
``threedod/data/builtin.py``, itself after cubercnn/data/builtin.py:3-46):
dataset facts, reproduced verbatim."""
from __future__ import annotations

_OMNI3D = {
    'chair', 'table', 'cabinet', 'car', 'lamp', 'books', 'sofa', 'pedestrian',
    'picture', 'window', 'pillow', 'truck', 'door', 'blinds', 'sink', 'shelves',
    'television', 'shoes', 'cup', 'bottle', 'bookcase', 'laptop', 'desk',
    'cereal box', 'floor mat', 'traffic cone', 'mirror', 'barrier', 'counter',
    'camera', 'bicycle', 'toilet', 'bus', 'bed', 'refrigerator', 'trailer',
    'box', 'oven', 'clothes', 'van', 'towel', 'motorcycle', 'night stand',
    'stove', 'machine', 'stationery', 'bathtub', 'cyclist', 'curtain', 'bin',
}
_OMNI3D_IN = {
    'stationery', 'sink', 'table', 'floor mat', 'bottle', 'bookcase', 'bin',
    'blinds', 'pillow', 'bicycle', 'refrigerator', 'night stand', 'chair',
    'sofa', 'books', 'oven', 'towel', 'cabinet', 'window', 'curtain', 'bathtub',
    'laptop', 'desk', 'television', 'clothes', 'stove', 'cup', 'shelves', 'box',
    'shoes', 'mirror', 'door', 'picture', 'lamp', 'machine', 'counter', 'bed',
    'toilet',
}
_OMNI3D_OUT = {
    'cyclist', 'pedestrian', 'trailer', 'bus', 'motorcycle', 'car', 'barrier',
    'truck', 'van', 'traffic cone', 'bicycle',
}
_SUNRGBD = {
    'bicycle', 'books', 'bottle', 'chair', 'cup', 'laptop', 'shoes', 'towel',
    'blinds', 'window', 'lamp', 'shelves', 'mirror', 'sink', 'cabinet',
    'bathtub', 'door', 'toilet', 'desk', 'box', 'bookcase', 'picture', 'table',
    'counter', 'bed', 'night stand', 'pillow', 'sofa', 'television',
    'floor mat', 'curtain', 'clothes', 'stationery', 'refrigerator', 'bin',
    'stove', 'oven', 'machine',
}
_HYPERSIM = {
    'books', 'chair', 'towel', 'blinds', 'window', 'lamp', 'shelves', 'mirror',
    'sink', 'cabinet', 'bathtub', 'door', 'toilet', 'desk', 'box', 'bookcase',
    'picture', 'table', 'counter', 'bed', 'night stand', 'pillow', 'sofa',
    'television', 'floor mat', 'curtain', 'clothes', 'stationery',
    'refrigerator',
}
_ARKIT = {
    'table', 'bed', 'sofa', 'television', 'refrigerator', 'chair', 'oven',
    'machine', 'stove', 'shelves', 'sink', 'cabinet', 'bathtub', 'toilet',
}
_OBJECTRON = {
    'bicycle', 'books', 'bottle', 'camera', 'cereal box', 'chair', 'cup',
    'laptop', 'shoes',
}
# the synthetic fixture dataset's categories (``threedod/data/synth.py``)
SYNTH_CATEGORIES = ["chair", "table", "sofa", "bed", "cabinet", "television", "lamp", "desk", "pillow", "bookcase"]
_KITTI = {'pedestrian', 'car', 'cyclist', 'van', 'truck'}
_NUSCENES = {
    'pedestrian', 'car', 'truck', 'traffic cone', 'barrier', 'motorcycle',
    'bicycle', 'bus', 'trailer',
}


def get_omni3d_categories(dataset: str = "omni3d") -> set:
    """Category set for a named dataset/split."""
    if dataset == "omni3d":
        assert len(_OMNI3D) == 50
        return set(_OMNI3D)
    if dataset == "omni3d_in":
        assert len(_OMNI3D_IN) == 38
        return set(_OMNI3D_IN)
    if dataset == "omni3d_out":
        assert len(_OMNI3D_OUT) == 11
        return set(_OMNI3D_OUT)
    base = dataset.split("_")[0]
    if base == "SUNRGBD":
        return set(_SUNRGBD)
    if base == "Hypersim":
        if dataset == "Hypersim_test":
            return set(_HYPERSIM) - {"toilet"}
        return set(_HYPERSIM)
    if base == "ARKitScenes":
        return set(_ARKIT)
    if base == "Objectron":
        return set(_OBJECTRON)
    if base == "KITTI":
        return set(_KITTI)
    if base == "nuScenes":
        return set(_NUSCENES)
    if base in ("synth", "Synth"):
        return set(SYNTH_CATEGORIES)
    raise ValueError(f"{dataset} dataset is not registered.")
