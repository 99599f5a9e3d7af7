"""Port hygiene: what threedod_torch may import, its config defaults, and the
exact weight round trip through the JAX package's zoo converter.

* No module of ``threedod_torch/`` nor ``chip_smoke.py`` imports jax, flax or
  threedod (an AST walk, so a lazy import inside a function counts too).
* Every field of the port's config has the default of ``threedod.config.Config``.
* JAX variables (numpy-made in the JAX model's shape) ->
  ``from_jax_variables`` -> port (strict load) -> ``state_dict()`` ->
  ``convert_cubercnn_rcnn3d`` gives back the JAX variables bit for bit. This pins the detectron2 names and layouts, so a
  Cube R-CNN zoo checkpoint will load into the port as it is.
* A tree of the parameters' shape alone (a gradient tree) goes through the
  same bridge and comes out under exactly the port's parameter names, and the
  training fields of the config (solver, samplers, loss weights) are among
  those pinned.
* Importing the port builds no kernel, and its entry points refuse to run
  without a CUDA card.
* Every CUDA source includes only the CUDA toolkit's own headers and the
  port's: no cuBLAS, cuDNN, CUTLASS or PyTorch header, so every product a
  kernel computes is computed in its own body.
* No module of the port names PyTorch's fused attention, ``grid_sample`` or
  ``torch.compile``: on the card the attention of 2048 tokens and more is
  kernel K9 and GroundingDINO's deformable sampling is kernel K3, and nothing
  else (``chip_smoke.py`` alone times the library calls beside them).
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import pathlib

import numpy as np
import pytest

import _torch_port as tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "threedod_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "threedod")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _fields(cfg, prefix=""):
    for f in dataclasses.fields(cfg):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            yield from _fields(val, f"{prefix}{f.name}.")
        else:
            yield f"{prefix}{f.name}", val


def test_config_defaults_match_jax():
    from threedod.config import Config as JaxConfig

    from threedod_torch.config import Config

    jcfg = JaxConfig()
    fields = dict(_fields(Config()))
    assert len(fields) >= 84
    for path in ("solver.base_lr", "solver.clip_gradients", "model.rpn.batch_size_per_image",
                 "model.rpn.pre_nms_topk_train", "model.roi_heads.positive_fraction",
                 "model.roi_box_head.smooth_l1_beta", "model.roi_cube_head.loss_w_joint",
                 "model.roi_cube_head.chamfer_pose", "model.stabilize", "model.freeze_bn", "model.use_bn",
                 "shapes.max_gt", "shapes.roi_batch", "max_training_attempts", "output_dir"):
        assert path in fields, path
    assert "solver.steps_per_dispatch" not in fields  # a dispatch workaround of the JAX package
    for path, val in fields.items():
        ref = jcfg
        for p in path.split("."):
            ref = getattr(ref, p)
        assert val == ref, f"{path}: port {val!r} vs JAX {ref!r}"


@pytest.fixture(scope="module")
def bridged():
    """(numpy variables in the JAX RCNN3D's shape, the port config, the port
    model loaded from them)."""
    jcfg, pcfg = tp.configs()
    variables = tp.seeded_variables(jcfg)
    return variables, pcfg, tp.port_model(pcfg, variables)


def test_weight_round_trip_is_exact(bridged):
    import jax

    from threedod.utils.convert_weights import convert_cubercnn_rcnn3d

    variables, _, port = bridged
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_cubercnn_rcnn3d(sd, variables)
    flat_a = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        other = np.asarray(flat_b[path])
        assert other.dtype == leaf.dtype and other.shape == leaf.shape, path
        np.testing.assert_array_equal(other, leaf, err_msg=jax.tree_util.keystr(path))


def test_gradient_tree_goes_through_the_bridge(bridged):
    """``from_jax_variables`` on {"params": tree} alone: every parameter of
    the port, and nothing else, with the parameter's shape."""
    from threedod_torch.utils.convert_weights import from_jax_variables

    variables, pcfg, port = bridged
    tree = from_jax_variables({"params": variables["params"]}, pcfg)
    params = dict(port.named_parameters())
    assert set(tree) == set(params)
    for name, leaf in tree.items():
        assert leaf.shape == params[name].shape, name
        np.testing.assert_array_equal(leaf.numpy(), params[name].detach().numpy(), err_msg=name)
    # BatchNorm weight and bias train; the running statistics are buffers
    assert "backbone.bottom_up.base_layer.1.weight" in params
    assert "backbone.bottom_up.base_layer.1.running_var" in dict(port.named_buffers())


def test_import_builds_no_kernel():
    from threedod_torch.ops import _build

    for mod in ("threedod_torch.infer", "threedod_torch.train", "threedod_torch.train.trainer",
                "threedod_torch.ops.roi_align_cuda", "threedod_torch.ops.fused_conv",
                "threedod_torch.models.meta_arch", "threedod_torch.models.backbones.fpn",
                "threedod_torch.ops.attention", "threedod_torch.models.depth.dpt", "threedod_torch.depth_infer",
                "threedod_torch.ops.ms_deform", "threedod_torch.models.gdino.model", "threedod_torch.gdino_infer",
                "threedod_torch.train.depth", "threedod_torch.train_depth"):
        importlib.import_module(mod)
    assert _build.load.cache_info().currsize == 0


CUDA_SOURCES = sorted((ROOT / "threedod_torch" / "ops" / "csrc").glob("*.cu*"))
ALLOWED_INCLUDES = {"cuda.h", "cuda_bf16.h", "cuda_runtime.h", "stdint.h", "math.h", "fused_conv_common.cuh", "conv_wgmma.cuh",
                    "flash_attention_common.cuh", "roi_align_common.cuh"}


@pytest.mark.parametrize("path", CUDA_SOURCES, ids=lambda p: p.name)
def test_cuda_sources_include_no_library(path):
    includes = {line.split()[1].strip('<>"') for line in path.read_text().splitlines()
                if line.startswith("#include")}
    assert includes and includes <= ALLOWED_INCLUDES, includes - ALLOWED_INCLUDES


def test_every_kernel_has_a_source():
    names = {p.name for p in CUDA_SOURCES}
    assert names == {"roi_align_common.cuh", "roi_align_fwd.cu", "roi_align_bwd.cu", "fused_conv_common.cuh", "fused_tree_tail.cu",
                     "fused_block_down.cu", "fused_conv_relu_head.cu", "fused_fpn_level.cu",
                     "fused_basic_block.cu", "conv_wgmma.cuh", "flash_attention_common.cuh", "flash_attention_fwd.cu",
                     "flash_attention_bwd.cu", "ms_deform_sample.cu"}


@pytest.mark.parametrize("path", PORT_FILES[:-1], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_attention_or_compile(path):
    text = path.read_text()
    for name in ("scaled_dot_product_attention", "torch.compile", "MultiheadAttention", "grid_sample"):
        assert name not in text, f"{path.relative_to(ROOT)} names {name}"


def test_depth_infer_refuses_without_cuda():
    from threedod_torch import depth_infer

    with pytest.raises(RuntimeError, match="CUDA"):
        depth_infer.main(["--device", "cpu", "--encoder", "vits"])


def test_train_depth_refuses_without_cuda(tmp_path):
    from threedod_torch import train_depth

    with pytest.raises(RuntimeError, match="CUDA"):
        train_depth.main(["--device", "cpu", "--synthetic", "--encoder", "vits", "--save-path", str(tmp_path)])
    assert not any(tmp_path.iterdir())  # refused before anything was written


def test_gdino_infer_refuses_without_cuda():
    from threedod_torch import gdino_infer

    with pytest.raises(RuntimeError, match="CUDA"):
        gdino_infer.main(["--device", "cpu"])


def test_infer_refuses_without_cuda():
    from threedod_torch import infer

    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--device", "cpu"])
