"""Model weights from a detectron2-layout state dict: a Cube R-CNN zoo
checkpoint, a port checkpoint or a port ``state_dict()``, and ImageNet trunk
weights (counterpart of ``threedod/utils/model_zoo.py`` over
``convert_weights.py::load_torch_checkpoint``, ``convert_cubercnn_rcnn3d``
and the trunk converters).

The port's modules carry detectron2's names, so a zoo dict loads as it is
once ``state_dict`` has
  1. unwrapped ``{"model": ...}`` (a detectron2 checkpoint, or a port
     training checkpoint);
  2. dropped every ``num_batches_tracked`` (BatchNorm's counter; the port's
     BatchNorm keeps none);
and ``load_model_weights``
  3. keeps the model's own ``roi_heads.priors_*`` where the dict has none;
  4. loads the rest strictly: any other missing or extra key raises.

The trunks carry the names of their ImageNet checkpoints (the reference
DLA's, torchvision's ResNet, DenseNet, MNASNet and ShuffleNet), so
``load_trunk_weights`` copies a checkpoint's entries under the trunk
(``backbone.bottom_up``): every trunk entry must be there with its shape,
and the classifier and other entries the trunk lacks are not read.

``cubercnn://`` paths resolve under ``$THREEDOD_ZOO_DIR`` (default
``datasets/zoo``); nothing is fetched, and a file that is not there raises
with the address to fetch it from elsewhere.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Union

import torch
import torch.nn as nn

PRIORS = ("roi_heads.priors_dims_per_cat", "roi_heads.priors_z_scales", "roi_heads.priors_z_stats")
BN_STATS = ("running_mean", "running_var")
PREFIX = "cubercnn://"
BASE_URL = "https://dl.fbaipublicfiles.com/cubercnn"


def zoo_dir() -> str:
    return os.environ.get("THREEDOD_ZOO_DIR", os.path.join("datasets", "zoo"))


def resolve(path: str) -> str:
    """``cubercnn://name`` -> the cached file under ``zoo_dir()`` (raises if
    absent); any other path as it is."""
    if not path.startswith(PREFIX):
        return path
    rel = path[len(PREFIX):]
    local = os.path.join(zoo_dir(), rel)
    if not os.path.exists(local):
        raise FileNotFoundError(
            f"zoo checkpoint '{rel}' not cached at {local}. This environment has no network egress; "
            f"download {BASE_URL}/{rel} elsewhere and place it there.")
    return local


def imagenet_trunk_path(backbone_name: str) -> Optional[str]:
    """The cached ImageNet checkpoint of a trunk,
    ``zoo_dir()``/imagenet/<backbone>.pth; None if absent."""
    p = os.path.join(zoo_dir(), "imagenet", f"{backbone_name}.pth")
    return p if os.path.exists(p) else None


def load_trunk_weights(path: str, backbone_name: str, model: nn.Module) -> nn.Module:
    """Copy an ImageNet trunk checkpoint (the reference DLA's or
    torchvision's layout, ``path`` resolved as ``resolve`` does) into
    ``model.backbone.bottom_up``; returns the model. A trunk entry the file
    lacks, or has at another shape, raises."""
    sd = state_dict(resolve(path))
    trunk = model.backbone.bottom_up
    own = trunk.state_dict()
    missing = sorted(k for k in own if k not in sd)
    if missing:
        raise KeyError(f"{path} lacks {len(missing)} entries of the {backbone_name} trunk, first {missing[:3]}")
    for k, v in own.items():
        if tuple(sd[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: {tuple(sd[k].shape)} in {path}, {tuple(v.shape)} in the {backbone_name} trunk")
    trunk.load_state_dict({k: sd[k] for k in own}, strict=True)
    return model


def state_dict(path_or_dict: Union[str, dict]) -> Dict[str, torch.Tensor]:
    """The weights of a file saved with ``torch.save`` (or of a dict already
    loaded), unwrapped and without ``num_batches_tracked``, on the CPU."""
    sd = path_or_dict
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k: torch.as_tensor(v) for k, v in sd.items() if not k.endswith("num_batches_tracked")}


def num_classes(sd: Dict[str, torch.Tensor]) -> int:
    """Foreground classes of a state dict (its class scores have one more, the background)."""
    return sd["roi_heads.box_predictor.cls_score.weight"].shape[0] - 1


def load_model_weights(path_or_dict: Union[str, dict], model: nn.Module) -> nn.Module:
    """Load ``path_or_dict`` (a ``cubercnn://`` path resolved) into
    ``model`` (steps 1 to 4 above); returns the model."""
    sd = state_dict(resolve(path_or_dict) if isinstance(path_or_dict, str) else path_or_dict)
    own = model.state_dict()
    for key in PRIORS:
        if key not in sd and key in own:
            sd[key] = own[key]
    model.load_state_dict(sd, strict=True)
    return model
