"""JAX variables -> port state dict (the inverse of the JAX package's
``threedod/utils/convert_weights.py::convert_cubercnn_rcnn3d``).

The port's names are detectron2's ``GeneralizedRCNN`` names, the ones a
Cube R-CNN checkpoint carries, so the JAX converter reads a port
``state_dict()`` as it reads a zoo checkpoint. Layouts:
  Dense  kernel (in, out)        -> Linear weight (out, in)
  Conv   kernel (kh, kw, I, O)   -> Conv2d weight (O, I, kh, kw)
  first fc over pooled ROIs: (S, S, C)-ordered rows -> d2's (C, S, S) columns
  ConvBN conv/kernel, bn/{scale, bias}, batch_stats bn/{mean, var}
         -> <conv>.weight, <bn>.{weight, bias, running_mean, running_var}
Every leaf of the JAX variables is consumed; a leftover raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path


def _dla_names(path: Tuple[str, ...]) -> Tuple[str, str]:
    """JAX DLA ConvBN path -> (torch conv prefix, torch bn prefix)."""
    head, last = path[0], path[-1]
    if head == "base_layer":
        return "base_layer.0", "base_layer.1"
    if head.startswith(("level0_", "level1_")):
        lvl, i = head.split("_")
        return f"{lvl}.{3 * int(i)}", f"{lvl}.{3 * int(i) + 1}"
    base = ".".join(path[:-1])
    if last == "project":
        return f"{base}.project.0", f"{base}.project.1"
    if last == "conv" and len(path) >= 2 and path[-2] == "root":
        return f"{base}.conv", f"{base}.bn"
    if last.startswith("conv"):
        return f"{base}.{last}", f"{base}.bn{last[4:]}"
    raise KeyError(f"unrecognised DLA ConvBN path {path}")


def from_jax_variables(variables: Dict, cfg) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of JAX ``RCNN3D`` (numpy leaves) -> the
    port's state dict. It only permutes and transposes leaves, so any tree
    of the parameters' shape goes through it: ``{"params": grads}`` (without
    ``batch_stats``) gives the gradients under the port's parameter names."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    res = cfg.model.roi_box_head.pooler_resolution
    cfp = cfg.model.fpn_out_channels
    used = set()
    sd: Dict[str, np.ndarray] = {}

    def take(kind, *path):
        used.add((kind,) + path)
        node = params if kind == "params" else stats
        for p in path:
            node = node[p]
        return np.asarray(node)

    def conv(prefix, *path, bias=True):
        sd[f"{prefix}.weight"] = take("params", *path, "kernel").transpose(3, 2, 0, 1)
        if bias:
            sd[f"{prefix}.bias"] = take("params", *path, "bias")

    def linear(prefix, *path):
        sd[f"{prefix}.weight"] = take("params", *path, "kernel").T
        sd[f"{prefix}.bias"] = take("params", *path, "bias")

    def linear_chw(prefix, *path):
        k = take("params", *path, "kernel")  # (S*S*C, out), rows in (S, S, C) order
        sd[f"{prefix}.weight"] = k.reshape(res, res, cfp, -1).transpose(3, 2, 0, 1).reshape(k.shape[1], -1)
        sd[f"{prefix}.bias"] = take("params", *path, "bias")

    # --- trunk: every ConvBN subtree of the DLA ------------------------------
    def walk(tree, path):
        if set(tree) <= {"conv", "bn"} and "kernel" in tree.get("conv", {}):
            cname, bname = _dla_names(path)
            full = ("backbone", "trunk") + path
            conv(f"backbone.bottom_up.{cname}", *full, "conv", bias=False)
            pre = f"backbone.bottom_up.{bname}"
            sd[f"{pre}.weight"] = take("params", *full, "bn", "scale")
            sd[f"{pre}.bias"] = take("params", *full, "bn", "bias")
            if stats:
                sd[f"{pre}.running_mean"] = take("batch_stats", *full, "bn", "mean")
                sd[f"{pre}.running_var"] = take("batch_stats", *full, "bn", "var")
            return
        for k, v in tree.items():
            walk(v, path + (k,))

    walk(params["backbone"]["trunk"], ())

    for name in params["backbone"]["fpn"]:
        kind, lvl = name.split("_p")  # lateral_p2 -> ("lateral", "2")
        conv(f"backbone.fpn_{kind}{lvl}", "backbone", "fpn", name)
    for name in ("conv", "objectness_logits", "anchor_deltas"):
        conv(f"proposal_generator.rpn_head.{name}", "rpn_head", name)

    rh = params["roi_heads"]
    for name in rh["box_head"]:
        fn = linear_chw if name == "fc1" else linear
        fn(f"roi_heads.box_head.{name}", "roi_heads", "box_head", name)
    for name in ("cls_score", "bbox_pred"):
        linear(f"roi_heads.box_predictor.{name}", "roi_heads", "box_predictor", name)
    for name in rh.get("cube_head", {}):
        if name.startswith("bbox_3D"):
            linear(f"roi_heads.cube_head.{name}", "roi_heads", "cube_head", name)
            continue
        branch, fc = name.rsplit("_", 1)  # shared_fc1 -> (shared, fc1)
        if branch != "shared":
            raise NotImplementedError(f"cube head fc stack '{branch}' is not ported yet (shared only)")
        fn = linear_chw if fc == "fc1" else linear
        fn(f"roi_heads.cube_head.feature_generator.{fc}", "roi_heads", "cube_head", name)
    for prior in ("priors_dims_per_cat", "priors_z_scales", "priors_z_stats"):
        if prior in rh:
            sd[f"roi_heads.{prior}"] = take("params", "roi_heads", prior)

    leftover = [("params",) + p for p in _leaves(params)] + [("batch_stats",) + p for p in _leaves(stats)]
    leftover = [p for p in leftover if p not in used]
    if leftover:
        raise KeyError(f"JAX leaves with no port counterpart: {leftover[:8]}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}
