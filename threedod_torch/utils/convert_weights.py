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
The trunk's names are the reference DLA's, or torchvision's for the ResNet,
DenseNet, MNASNet and ShuffleNet families. ``depth_from_jax_variables`` and
``gdino_from_jax_variables`` do the same for Depth-Anything-V2 and
GroundingDINO under their checkpoints' names, ``sam_from_jax_variables`` for
SAM, SAM-HQ and TinyViT.
Every leaf of the JAX variables is consumed; a leftover raises.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# the JAX cube head's fc stacks -> the reference CubeHead's (``models/heads.py``)
CUBE_FC_STACKS = {"shared": "feature_generator", "xy": "feature_generator_XY", "dims": "feature_generator_dims",
                  "pose": "feature_generator_pose", "z": "feature_generator_Z", "conf": "feature_generator_conf"}


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


def _resnet_names(path):
    """``stem`` -> conv1 / bn1; ``layer{s}_{i}/conv{k}`` -> layer{s}.{i}.conv{k}
    / bn{k}; ``.../downsample`` -> layer{s}.{i}.downsample.{0,1}."""
    if path == ("stem",):
        return "conv1", "bn1"
    block = path[0].replace("_", ".")
    if path[1] == "downsample":
        return f"{block}.downsample.0", f"{block}.downsample.1"
    return f"{block}.{path[1]}", f"{block}.bn{path[1][4:]}"


def _densenet_names(path):
    """``stem`` -> features.conv0 / norm0; ``block{b}_layer{l}/{leaf}`` ->
    features.denseblock{b}.denselayer{l}.{leaf}; ``trans{n}_{norm,conv}`` ->
    features.transition{n}.{norm,conv}; ``norm5``. A lone norm or conv has
    one name; it is returned first."""
    if path == ("stem",):
        return "features.conv0", "features.norm0"
    head = path[0]
    if head.startswith("block"):
        b, l = head[len("block"):].split("_layer")
        return (f"features.denseblock{b}.denselayer{l}.{path[1]}",)
    if head.startswith("trans"):
        n, leaf = head[len("trans"):].split("_")
        return (f"features.transition{n}.{leaf}",)
    if head == "norm5":
        return ("features.norm5",)
    raise KeyError(f"unrecognised DenseNet path {path}")


def _mnasnet_names(path):
    """``stem{i}`` -> layers.{3i} / {3i + 1}; ``stage{s}_{b}/{expand,
    depthwise,project}`` -> layers.{8 + s}.{b}.layers.{0,3,6} / {1,4,7}."""
    head = path[0]
    if head.startswith("stem"):
        i = 3 * int(head[4:])
        return f"layers.{i}", f"layers.{i + 1}"
    s, b = head[len("stage"):].split("_")
    i = {"expand": 0, "depthwise": 3, "project": 6}[path[1]]
    base = f"layers.{8 + int(s)}.{b}.layers"
    return f"{base}.{i}", f"{base}.{i + 1}"


def _shufflenet_names(path):
    """``stem`` -> conv1.{0,1}; ``stage{s}_{b}/{b1_dw,b1_conv}`` ->
    stage{s}.{b}.branch1.{0,2} / {1,3}; ``{b2_conv1,b2_dw,b2_conv2}`` ->
    branch2.{0,3,5} / {1,4,6}."""
    if path == ("stem",):
        return "conv1.0", "conv1.1"
    branch, i = {"b1_dw": ("branch1", 0), "b1_conv": ("branch1", 2), "b2_conv1": ("branch2", 0),
                 "b2_dw": ("branch2", 3), "b2_conv2": ("branch2", 5)}[path[1]]
    base = f"{path[0].replace('_', '.')}.{branch}"
    return f"{base}.{i}", f"{base}.{i + 1}"


def _trunk_names(backbone: str):
    """The trunk family's map from a JAX subtree's path to the port's names."""
    for prefix, fn in (("dla", _dla_names), ("resnet", _resnet_names), ("densenet", _densenet_names),
                       ("mnasnet", _mnasnet_names), ("shufflenet", _shufflenet_names)):
        if backbone.startswith(prefix):
            return fn
    raise ValueError(f"unknown backbone '{backbone}'")


def from_jax_variables(variables: Dict, cfg) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of JAX ``RCNN3D`` (numpy leaves) -> the
    port's state dict. It only permutes and transposes leaves, so any tree
    of the parameters' shape goes through it: ``{"params": grads}`` (without
    ``batch_stats``) gives the gradients under the port's parameter names.
    A part the tree lacks is skipped: ``{"params": {"roi_heads": ...}}``
    gives the ROI heads' entries alone."""
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

    def linear_chw(prefix, *path, res=res):
        k = take("params", *path, "kernel")  # (S*S*C, out), rows in (S, S, C) order
        sd[f"{prefix}.weight"] = k.reshape(res, res, cfp, -1).transpose(3, 2, 0, 1).reshape(k.shape[1], -1)
        sd[f"{prefix}.bias"] = take("params", *path, "bias")

    # --- trunk: every ConvBN subtree, lone BatchNorm and lone conv ------------
    names = _trunk_names(cfg.model.backbone)
    top = "backbone.bottom_up."

    def norm(prefix, full):
        sd[f"{prefix}.weight"] = take("params", *full, "scale")
        sd[f"{prefix}.bias"] = take("params", *full, "bias")
        if stats:
            sd[f"{prefix}.running_mean"] = take("batch_stats", *full, "mean")
            sd[f"{prefix}.running_var"] = take("batch_stats", *full, "var")

    def walk(tree, path):
        if not isinstance(tree, dict):
            return  # a leaf no rule took: reported with the leftovers below
        full = ("backbone", "trunk") + path
        if set(tree) == {"conv", "bn"} and "kernel" in tree["conv"]:
            cname, bname = names(path)
            conv(top + cname, *full, "conv", bias=False)
            norm(top + bname, full + ("bn",))
        elif set(tree) == {"scale", "bias"}:  # DenseNet's stand-alone norms
            norm(top + names(path)[0], full)
        elif set(tree) == {"kernel"}:  # and the convolutions that follow them
            conv(top + names(path)[0], *full, bias=False)
        else:
            for k, v in tree.items():
                walk(v, path + (k,))

    if "backbone" in params:
        walk(params["backbone"]["trunk"], ())
        for name in params["backbone"]["fpn"]:
            kind, lvl = name.split("_p")  # lateral_p2 -> ("lateral", "2")
            conv(f"backbone.fpn_{kind}{lvl}", "backbone", "fpn", name)
    if "rpn_head" in params:
        for name in ("conv", "objectness_logits", "anchor_deltas"):
            conv(f"proposal_generator.rpn_head.{name}", "rpn_head", name)

    rh = params["roi_heads"]
    for name in rh.get("box_head", {}):
        fn = linear_chw if name == "fc1" else linear
        fn(f"roi_heads.box_head.{name}", "roi_heads", "box_head", name)
    for name in rh.get("box_predictor", {}):
        linear(f"roi_heads.box_predictor.{name}", "roi_heads", "box_predictor", name)
    cube_res = cfg.model.roi_cube_head.pooler_resolution
    for name in rh.get("cube_head", {}):
        if name.startswith("bbox_3D"):
            linear(f"roi_heads.cube_head.{name}", "roi_heads", "cube_head", name)
            continue
        branch, fc = name.rsplit("_", 1)  # shared_fc1 -> (shared, fc1), xy_fc2 -> (xy, fc2)
        prefix = f"roi_heads.cube_head.{CUBE_FC_STACKS[branch]}.{fc}"
        if fc == "fc1":
            linear_chw(prefix, "roi_heads", "cube_head", name, res=cube_res)
        else:
            linear(prefix, "roi_heads", "cube_head", name)
    for prior in ("priors_dims_per_cat", "priors_z_scales", "priors_z_stats"):
        if prior in rh:
            sd[f"roi_heads.{prior}"] = take("params", "roi_heads", prior)

    leftover = [("params",) + p for p in _leaves(params)] + [("batch_stats",) + p for p in _leaves(stats)]
    leftover = [p for p in leftover if p not in used]
    if leftover:
        raise KeyError(f"JAX leaves with no port counterpart: {leftover[:8]}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def depth_from_jax_variables(params: Dict) -> Dict[str, torch.Tensor]:
    """flax params of the JAX ``DepthAnythingV2`` (numpy leaves) -> the port's
    state dict under the Depth-Anything-V2 checkpoint's names: the inverse of
    the JAX package's ``convert_depth_anything_v2``, leaf for leaf. Both conv
    kernels (kh, kw, I, O) and transposed-conv kernels (kh, kw, O, I) become
    (dim 3, dim 2, kh, kw). Every leaf is consumed; a leftover raises."""
    used = set()
    sd: Dict[str, np.ndarray] = {}

    def take(*path):
        used.add(path)
        node = params
        for p in path:
            node = node[p]
        return np.asarray(node)

    def has(*path):
        node = params
        for p in path:
            if p not in node:
                return False
            node = node[p]
        return True

    def linear(prefix, *path):
        sd[f"{prefix}.weight"] = take(*path, "kernel").T
        sd[f"{prefix}.bias"] = take(*path, "bias")

    def conv(prefix, *path):
        sd[f"{prefix}.weight"] = take(*path, "kernel").transpose(3, 2, 0, 1)
        if has(*path, "bias"):
            sd[f"{prefix}.bias"] = take(*path, "bias")

    def norm(prefix, *path):
        sd[f"{prefix}.weight"] = take(*path, "scale")
        sd[f"{prefix}.bias"] = take(*path, "bias")

    vit = params["pretrained"]
    sd["pretrained.cls_token"] = take("pretrained", "cls_token")
    sd["pretrained.pos_embed"] = take("pretrained", "pos_embed")
    conv("pretrained.patch_embed.proj", "pretrained", "patch_embed")
    norm("pretrained.norm", "pretrained", "norm")
    for name in vit:
        if not name.startswith("block"):
            continue
        b, at = f"pretrained.blocks.{name[len('block'):]}", ("pretrained", name)
        norm(f"{b}.norm1", *at, "norm1")
        norm(f"{b}.norm2", *at, "norm2")
        linear(f"{b}.attn.qkv", *at, "attn", "qkv")
        linear(f"{b}.attn.proj", *at, "attn", "proj")
        linear(f"{b}.mlp.fc1", *at, "mlp", "fc1")
        linear(f"{b}.mlp.fc2", *at, "mlp", "fc2")
        sd[f"{b}.ls1.gamma"] = take(*at, "ls1_gamma")
        sd[f"{b}.ls2.gamma"] = take(*at, "ls2_gamma")

    for name, tree in params["depth_head"].items():
        at = ("depth_head", name)
        if name.startswith("project"):
            conv(f"depth_head.projects.{name[len('project'):]}", *at)
        elif name.startswith("resize"):
            conv(f"depth_head.resize_layers.{name[len('resize'):]}", *at)
        elif name.startswith("refinenet"):
            for unit in tree:
                if unit == "out_conv":
                    conv(f"depth_head.scratch.{name}.out_conv", *at, unit)
                else:
                    for c in tree[unit]:
                        conv(f"depth_head.scratch.{name}.{unit}.{c}", *at, unit, c)
        elif name.startswith("output_conv2_"):
            conv(f"depth_head.scratch.output_conv2.{name[len('output_conv2_'):]}", *at)
        else:  # layer{n}_rn, output_conv1
            conv(f"depth_head.scratch.{name}", *at)

    leftover = [p for p in _leaves(params) if p not in used]
    if leftover:
        raise KeyError(f"JAX leaves with no port counterpart: {leftover[:8]}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def gdino_from_jax_variables(params: Dict) -> Dict[str, torch.Tensor]:
    """flax params of the JAX ``GroundingDINO`` (numpy leaves) -> the port's
    state dict under the official checkpoint's names: the inverse of the JAX
    package's ``convert_groundingdino``, leaf for leaf. The text and decoder
    attentions' q, k, v Dense layers become one packed ``in_proj_weight`` /
    ``in_proj_bias``; the decoder's flax ``norm1`` (after the self-attention)
    is the official ``norm2`` and flax ``norm2`` the official ``norm1``. Every
    leaf is consumed; a leftover raises."""
    used = set()
    sd: Dict[str, np.ndarray] = {}

    def take(*path):
        used.add(path)
        node = params
        for p in path:
            node = node[p]
        return np.asarray(node)

    def linear(prefix, *path):
        sd[f"{prefix}.weight"] = take(*path, "kernel").T
        if "bias" in _node(params, path):
            sd[f"{prefix}.bias"] = take(*path, "bias")

    def conv(prefix, *path):
        sd[f"{prefix}.weight"] = take(*path, "kernel").transpose(3, 2, 0, 1)
        sd[f"{prefix}.bias"] = take(*path, "bias")

    def norm(prefix, *path):
        sd[f"{prefix}.weight"] = take(*path, "scale")
        sd[f"{prefix}.bias"] = take(*path, "bias")

    def packed(prefix, *path):
        parts = ("q", "k", "v")
        sd[f"{prefix}.in_proj_weight"] = np.concatenate([take(*path, p, "kernel").T for p in parts])
        sd[f"{prefix}.in_proj_bias"] = np.concatenate([take(*path, p, "bias") for p in parts])
        linear(f"{prefix}.out_proj", *path, "out")

    def box_mlp(prefix, *path):
        for k, fc in enumerate(("fc1", "fc2", "fc3")):
            linear(f"{prefix}.layers.{k}", *path, fc)

    def deform(prefix, *path):
        for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
            linear(f"{prefix}.{name}", *path, name)

    # Swin-T
    bb, t = params["backbone"], "backbone.0"
    conv(f"{t}.patch_embed.proj", "backbone", "patch_embed")
    norm(f"{t}.patch_embed.norm", "backbone", "patch_norm")
    for name in bb:
        at = ("backbone", name)
        if name.startswith("stage"):
            s, blk = name[len("stage"):].split("_block")
            p = f"{t}.layers.{s}.blocks.{blk}"
            norm(f"{p}.norm1", *at, "norm1")
            norm(f"{p}.norm2", *at, "norm2")
            linear(f"{p}.attn.qkv", *at, "attn", "qkv")
            linear(f"{p}.attn.proj", *at, "attn", "proj")
            sd[f"{p}.attn.relative_position_bias_table"] = take(*at, "attn", "relative_position_bias_table")
            linear(f"{p}.mlp.fc1", *at, "mlp_fc1")
            linear(f"{p}.mlp.fc2", *at, "mlp_fc2")
        elif name.startswith("downsample"):
            p = f"{t}.layers.{name[len('downsample'):]}.downsample"
            norm(f"{p}.norm", *at, "norm")
            linear(f"{p}.reduction", *at, "reduction")
        elif name.startswith("out_norm"):
            norm(f"{t}.norm{name[len('out_norm'):]}", *at)

    # BERT
    for name in ("word_embeddings", "position_embeddings", "token_type_embeddings"):
        sd[f"bert.embeddings.{name}.weight"] = take("bert", name, "embedding")
    norm("bert.embeddings.LayerNorm", "bert", "embeddings_norm")
    for name in params["bert"]:
        if not name.startswith("layer"):
            continue
        p, at = f"bert.encoder.layer.{name[len('layer'):]}", ("bert", name)
        for flax_name, official in (("q", "attention.self.query"), ("k", "attention.self.key"),
                                    ("v", "attention.self.value"), ("attn_out", "attention.output.dense"),
                                    ("ffn_in", "intermediate.dense"), ("ffn_out", "output.dense")):
            linear(f"{p}.{official}", *at, flax_name)
        norm(f"{p}.attention.output.LayerNorm", *at, "attn_norm")
        norm(f"{p}.output.LayerNorm", *at, "ffn_norm")
    linear("feat_map", "feat_map")

    for i in range(4):
        conv(f"input_proj.{i}.0", f"input_proj{i}")
        norm(f"input_proj.{i}.1", f"input_gn{i}")
    sd["transformer.level_embed"] = take("level_embed")

    enc, dec = "transformer.encoder", "transformer.decoder"
    for name in params:
        if name.startswith("enc") and name[3:].isdigit():
            i = name[3:]
            fu, te, de = f"{enc}.fusion_layers.{i}", f"{enc}.text_layers.{i}", f"{enc}.layers.{i}"
            norm(f"{fu}.layer_norm_v", name, "fusion", "layer_norm_v")
            norm(f"{fu}.layer_norm_l", name, "fusion", "layer_norm_l")
            for proj in ("v_proj", "l_proj", "values_v_proj", "values_l_proj", "out_v_proj", "out_l_proj"):
                linear(f"{fu}.attn.{proj}", name, "fusion", proj)
            sd[f"{fu}.gamma_v"] = take(name, "fusion", "gamma_v")
            sd[f"{fu}.gamma_l"] = take(name, "fusion", "gamma_l")
            packed(f"{te}.self_attn", name, "text_attn")
            norm(f"{te}.norm1", name, "text_norm")
            linear(f"{te}.linear1", name, "text_ffn", "fc1")
            linear(f"{te}.linear2", name, "text_ffn", "fc2")
            norm(f"{te}.norm2", name, "text_ffn", "norm")
            deform(f"{de}.self_attn", name, "deform")
            norm(f"{de}.norm1", name, "vis_norm")
            linear(f"{de}.linear1", name, "vis_ffn", "fc1")
            linear(f"{de}.linear2", name, "vis_ffn", "fc2")
            norm(f"{de}.norm2", name, "vis_ffn", "norm")
        elif name.startswith("dec") and name[3:].isdigit():
            p = f"{dec}.layers.{name[3:]}"
            packed(f"{p}.self_attn", name, "self_attn")
            norm(f"{p}.norm2", name, "norm1")
            packed(f"{p}.ca_text", name, "ca_text")
            norm(f"{p}.catext_norm", name, "catext_norm")
            deform(f"{p}.cross_attn", name, "cross_attn")
            norm(f"{p}.norm1", name, "norm2")
            linear(f"{p}.linear1", name, "ffn", "fc1")
            linear(f"{p}.linear2", name, "ffn", "fc2")
            norm(f"{p}.norm3", name, "ffn", "norm")
        elif name.startswith("bbox_embed"):
            box_mlp(f"bbox_embed.{name[len('bbox_embed'):]}", name)

    linear("transformer.enc_output", "enc_output")
    norm("transformer.enc_output_norm", "enc_output_norm")
    box_mlp("transformer.enc_out_bbox_embed", "enc_bbox")
    sd["transformer.tgt_embed.weight"] = take("tgt_embed")
    linear(f"{dec}.ref_point_head.layers.0", "ref_point_head_fc1")
    linear(f"{dec}.ref_point_head.layers.1", "ref_point_head_fc2")
    norm(f"{dec}.norm", "decoder_norm")

    leftover = [p for p in _leaves(params) if p not in used]
    if leftover:
        raise KeyError(f"JAX leaves with no port counterpart: {leftover[:8]}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def _node(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def sam_from_jax_variables(params: Dict, hq: bool, encoder_type: str = "vit") -> Dict[str, torch.Tensor]:
    """flax params of the JAX ``Sam`` (numpy leaves) -> the port's state dict
    under the official SAM / SAM-HQ checkpoint's names: the inverse of the JAX
    package's ``convert_sam`` (``encoder_type`` "vit") or, for the image
    encoder of ``encoder_type`` "vit_tiny", of ``convert_tinyvit``. A folded
    TinyViT convolution becomes ``c.weight`` and a BatchNorm whose scale is 1
    (weight sqrt(1 + 1e-5), running variance 1, mean 0, bias the folded
    bias), so ``convert_tinyvit`` folds it back to the same kernel and bias.
    ``hq`` says whether the decoder has SAM-HQ's leaves. Every leaf is
    consumed; a leftover raises."""
    used = set()
    sd: Dict[str, np.ndarray] = {}

    def take(*path):
        used.add(path)
        return np.asarray(_node(params, path))

    def linear(prefix, *path):
        sd[f"{prefix}.weight"] = take(*path, "kernel").T
        sd[f"{prefix}.bias"] = take(*path, "bias")

    def conv(prefix, *path):  # Conv (kh, kw, I, O) and ConvTranspose (kh, kw, O, I) alike
        sd[f"{prefix}.weight"] = take(*path, "kernel").transpose(3, 2, 0, 1)
        if "bias" in _node(params, path):
            sd[f"{prefix}.bias"] = take(*path, "bias")

    def norm(prefix, *path, names=("scale", "bias")):
        sd[f"{prefix}.weight"] = take(*path, names[0])
        sd[f"{prefix}.bias"] = take(*path, names[1])

    def conv_bn(prefix, *path):
        conv(f"{prefix}.c", *path, "conv")
        bias = sd.pop(f"{prefix}.c.bias")
        sd[f"{prefix}.bn.weight"] = np.sqrt(np.ones_like(bias) + np.float32(1e-5))
        sd[f"{prefix}.bn.bias"] = bias
        sd[f"{prefix}.bn.running_mean"] = np.zeros_like(bias)
        sd[f"{prefix}.bn.running_var"] = np.ones_like(bias)

    enc, e = params["image_encoder"], "image_encoder"
    if encoder_type == "vit":
        conv(f"{e}.patch_embed.proj", e, "patch_embed")
        sd[f"{e}.pos_embed"] = take(e, "pos_embed")
        conv(f"{e}.neck.0", e, "neck0")
        norm(f"{e}.neck.1", e, "neck1", names=("weight", "bias"))
        conv(f"{e}.neck.2", e, "neck2")
        norm(f"{e}.neck.3", e, "neck3", names=("weight", "bias"))
        for name in enc:
            if not name.startswith("block"):
                continue
            b, at = f"{e}.blocks.{name[len('block'):]}", (e, name)
            norm(f"{b}.norm1", *at, "norm1")
            norm(f"{b}.norm2", *at, "norm2")
            linear(f"{b}.attn.qkv", *at, "attn", "qkv")
            linear(f"{b}.attn.proj", *at, "attn", "proj")
            sd[f"{b}.attn.rel_pos_h"] = take(*at, "attn", "rel_pos_h")
            sd[f"{b}.attn.rel_pos_w"] = take(*at, "attn", "rel_pos_w")
            linear(f"{b}.mlp.lin1", *at, "mlp_lin1")
            linear(f"{b}.mlp.lin2", *at, "mlp_lin2")
    elif encoder_type == "vit_tiny":
        conv_bn(f"{e}.patch_embed.seq.0", e, "patch_conv1")
        conv_bn(f"{e}.patch_embed.seq.2", e, "patch_conv2")
        conv(f"{e}.neck.0", e, "neck_conv1")
        norm(f"{e}.neck.1", e, "neck_ln1", names=("weight", "bias"))
        conv(f"{e}.neck.2", e, "neck_conv2")
        norm(f"{e}.neck.3", e, "neck_ln2", names=("weight", "bias"))
        for name in enc:
            at = (e, name)
            if name.startswith("merge"):
                for c in ("conv1", "conv2", "conv3"):
                    conv_bn(f"{e}.layers.{name[len('merge'):]}.downsample.{c}", *at, c)
            elif name.startswith("layer0_block"):
                for c in ("conv1", "conv2", "conv3"):
                    conv_bn(f"{e}.layers.0.blocks.{name[len('layer0_block'):]}.{c}", *at, c)
            elif name.startswith("layer"):
                i, j = name[len("layer"):].split("_block")
                b = f"{e}.layers.{i}.blocks.{j}"
                norm(f"{b}.attn.norm", *at, "attn", "norm")
                linear(f"{b}.attn.qkv", *at, "attn", "qkv")
                linear(f"{b}.attn.proj", *at, "attn", "proj")
                sd[f"{b}.attn.attention_biases"] = take(*at, "attn", "attention_biases")
                conv_bn(f"{b}.local_conv", *at, "local_conv")
                norm(f"{b}.mlp.norm", *at, "mlp_norm")
                linear(f"{b}.mlp.fc1", *at, "mlp_fc1")
                linear(f"{b}.mlp.fc2", *at, "mlp_fc2")
    else:
        raise ValueError(f"unknown encoder_type '{encoder_type}' (vit or vit_tiny)")

    p = "prompt_encoder"
    sd[f"{p}.pe_layer.positional_encoding_gaussian_matrix"] = take(p, "pe_gaussian")
    points = take(p, "point_embeddings")
    for i in range(points.shape[0]):
        sd[f"{p}.point_embeddings.{i}.weight"] = points[i:i + 1]
    sd[f"{p}.not_a_point_embed.weight"] = take(p, "not_a_point_embed")
    sd[f"{p}.no_mask_embed.weight"] = take(p, "no_mask_embed")

    d, m = params["mask_decoder"], "mask_decoder"

    def two_way(prefix, name):
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{prefix}.{proj}", m, name, proj)

    sd[f"{m}.iou_token.weight"] = take(m, "iou_token")
    sd[f"{m}.mask_tokens.weight"] = take(m, "mask_tokens")
    t = f"{m}.transformer"
    two_way(f"{t}.final_attn_token_to_image", "final_attn")
    norm(f"{t}.norm_final_attn", m, "norm_final")
    conv(f"{m}.output_upscaling.0", m, "upscale_conv1")
    norm(f"{m}.output_upscaling.1", m, "upscale_norm", names=("weight", "bias"))
    conv(f"{m}.output_upscaling.3", m, "upscale_conv2")
    for i in range(2):
        layer = f"{t}.layers.{i}"
        two_way(f"{layer}.self_attn", f"l{i}_self_attn")
        two_way(f"{layer}.cross_attn_token_to_image", f"l{i}_cross_t2i")
        two_way(f"{layer}.cross_attn_image_to_token", f"l{i}_cross_i2t")
        for k in range(1, 5):
            norm(f"{layer}.norm{k}", m, f"l{i}_norm{k}")
        linear(f"{layer}.mlp.lin1", m, f"l{i}_mlp1")
        linear(f"{layer}.mlp.lin2", m, f"l{i}_mlp2")
    for name in d:
        if name.startswith("hyper"):
            i, k = name[len("hyper"):].split("_")
            linear(f"{m}.output_hypernetworks_mlps.{i}.layers.{k}", m, name)
        elif name.startswith("iou_mlp_"):
            linear(f"{m}.iou_prediction_head.layers.{name[len('iou_mlp_'):]}", m, name)
    if hq:
        sd[f"{m}.hf_token.weight"] = take(m, "hf_token")
        for i in range(3):
            linear(f"{m}.hf_mlp.layers.{i}", m, f"hf_mlp_{i}")
        for official, flax_name in (("compress_vit_feat", "compress_vit"), ("embedding_encoder", "encoder"),
                                    ("embedding_maskfeature", "mask")):
            conv(f"{m}.{official}.0", m, f"{flax_name}_conv1")
            norm(f"{m}.{official}.1", m, f"{flax_name}_norm", names=("weight", "bias"))
            conv(f"{m}.{official}.3", m, f"{flax_name}_conv2")

    leftover = [p for p in _leaves(params) if p not in used]
    if leftover:
        raise KeyError(f"JAX leaves with no port counterpart: {leftover[:8]}")
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}
