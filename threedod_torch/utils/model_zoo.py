"""Model weights from a detectron2-layout state dict: a Cube R-CNN zoo
checkpoint, a port checkpoint or a port ``state_dict()`` (counterpart of
``threedod/utils/model_zoo.py::load_model_weights`` over
``convert_weights.py::load_torch_checkpoint`` and ``convert_cubercnn_rcnn3d``).

The port's modules carry detectron2's names, so a zoo dict loads as it is
once ``state_dict`` has
  1. unwrapped ``{"model": ...}`` (a detectron2 checkpoint, or a port
     training checkpoint);
  2. dropped every ``num_batches_tracked`` (BatchNorm's counter; the port's
     BatchNorm keeps none);
and ``load_model_weights``
  3. keeps the model's own ``roi_heads.priors_*`` where the dict has none;
  4. loads the rest strictly: any other missing or extra key raises.
"""
from __future__ import annotations

from typing import Dict, Union

import torch
import torch.nn as nn

PRIORS = ("roi_heads.priors_dims_per_cat", "roi_heads.priors_z_scales", "roi_heads.priors_z_stats")


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
    """Load ``path_or_dict`` into ``model`` (steps 1 to 4 above); returns the model."""
    sd = state_dict(path_or_dict)
    own = model.state_dict()
    for key in PRIORS:
        if key not in sd and key in own:
            sd[key] = own[key]
    model.load_state_dict(sd, strict=True)
    return model
