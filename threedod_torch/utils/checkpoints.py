"""Foundation-model weights from an official checkpoint file: the port's
counterpart of ``threedod/utils/convert_weights.py``'s
``load_torch_checkpoint`` with ``convert_depth_anything_v2`` and
``convert_groundingdino``.

``read_state_dict`` does what ``load_torch_checkpoint`` does: ``torch.load``
with ``weights_only=True``, then ``{"model": ...}`` unwrapped and a leading
``module.`` (a DataParallel save) stripped from every key.

``load_official`` loads such a dict into a port model. The port's modules
carry the official checkpoint's names, and a port model's ``state_dict()``
holds exactly the tensors the JAX converter reads for that model
(``tests/test_torch_official_checkpoints.py`` records the converters' reads
and pins the two sets equal). So every entry of the model's state dict must
be in the file with its shape, or the load raises; the file's other entries,
which the converter does not read either, are skipped and counted. Those are,
in an official Depth-Anything-V2 file, ``pretrained.mask_token`` and the
unused ``resConfUnit1`` of ``refinenet4``; in an official GroundingDINO file,
Swin's ``relative_position_index`` buffers, the decoder's
``transformer.decoder.bbox_embed.*`` copies of ``bbox_embed.*``, and BERT's
``position_ids`` and pooler. A port ``state_dict()`` saved with
``torch.save`` loads the same way, with nothing skipped.
"""
from __future__ import annotations

from typing import Dict, Union

import torch
from torch import nn

StateDict = Dict[str, torch.Tensor]


def read_state_dict(path_or_dict: Union[str, dict]) -> StateDict:
    """The tensors of a checkpoint file (or of a dict already loaded) on the
    CPU, ``{"model": ...}`` unwrapped and ``module.`` stripped."""
    sd = path_or_dict
    if isinstance(sd, str):
        sd = torch.load(sd, map_location="cpu", weights_only=True)
    if isinstance(sd.get("model"), dict):
        sd = sd["model"]
    return {k.removeprefix("module."): torch.as_tensor(v) for k, v in sd.items()}


def select(sd: StateDict, wanted: StateDict, what: str, kind: str = "model tensors") -> StateDict:
    """The entries of ``sd`` named in ``wanted``, each checked against
    ``wanted``'s shape; a missing entry raises ``KeyError``, a shape
    ``ValueError``, both naming ``what`` (the file)."""
    missing = sorted(k for k in wanted if k not in sd)
    if missing:
        raise KeyError(f"{what} lacks {len(missing)} of the {len(wanted)} {kind}, first {missing[:3]}")
    for k, dst in wanted.items():
        if tuple(sd[k].shape) != tuple(dst.shape):
            raise ValueError(f"{what}: {k} is {tuple(sd[k].shape)} in the file, {tuple(dst.shape)} in the model")
    return {k: sd[k] for k in wanted}


def load_official(model: nn.Module, path_or_dict: Union[str, dict], what: str = "the checkpoint") -> int:
    """Load an official (or port) checkpoint into ``model`` as set out
    above; returns how many of the file's entries were skipped. Errors name
    the file where a path is given, else ``what``."""
    sd = read_state_dict(path_or_dict)
    what = path_or_dict if isinstance(path_or_dict, str) else what
    model.load_state_dict(select(sd, model.state_dict(), what), strict=True)
    return len(sd) - len(model.state_dict())

