"""Port hygiene: what threedod_torch may import, its config defaults, and the
exact weight round trip through the JAX package's zoo converter.

* No module of ``threedod_torch/`` nor ``chip_smoke.py`` imports jax, flax or
  threedod (an AST walk, so a lazy import inside a function counts too), and
  none imports Pillow or PyYAML at its top level: the card's data path needs
  neither.
* Every field of the port's config has the default of ``threedod.config.Config``,
  the two configs have the same fields, and every ``configs/*.yaml`` loads
  in both packages to the same values. A ``model.weights_pretrain`` that
  names no file is refused by ``train_net`` and ``eval_boxes`` before
  anything is written, while ``vis_period`` (its drawings ported) is read and
  set up, the two shipped configs that set it included; ``log`` without
  wandb installed logs to the JSON file alone.
* With Pillow and matplotlib unimportable, as the card's machine may have
  them, the modules of the card's paths import and ``image_hw`` reads a JPEG's
  size.
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
* Every CUDA source includes only the CUDA toolkit's own headers (nvJPEG's
  among them, for the decode gate's per-plane comparison) and the port's: no
  cuBLAS, cuDNN, CUTLASS or PyTorch header and no libjpeg, so every product a
  kernel computes, and every JPEG the card decodes, is computed in the
  repository's own code.
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
import re

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_pillow_or_yaml_at_module_level(path):
    top = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            top += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            top.append(node.module)
    bad = [m for m in top if m.split(".")[0] in ("PIL", "yaml")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad} at its top level"


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
    assert "solver.steps_per_dispatch" in fields  # read and ignored: one step at a time computes the same
    for path in ("input.min_size_train", "input.format", "datasets.root", "datasets.trunc_2d_boxes",
                 "test.eval_period", "model.weights"):
        assert path in fields, path
    for path, val in fields.items():
        ref = jcfg
        for p in path.split("."):
            ref = getattr(ref, p)
        assert val == ref, f"{path}: port {val!r} vs JAX {ref!r}"


def test_config_fields_equal_jax():
    from threedod.config import Config as JaxConfig

    from threedod_torch.config import Config

    assert set(dict(_fields(Config()))) == set(dict(_fields(JaxConfig())))


CONFIG_FILES = sorted((ROOT / "configs").glob("*.yaml"))


@pytest.mark.parametrize("path", CONFIG_FILES, ids=lambda p: p.name)
def test_config_file_loads_as_jax(path):
    from threedod.config import load_config as jax_load

    from threedod_torch.config_yaml import load_config

    got, want = dict(_fields(load_config(str(path)))), dict(_fields(jax_load(str(path))))
    assert got == want


@pytest.mark.parametrize("opts", [["vis_period", "20"], ["model.weights_pretrain", "pretrain.pth"]],
                         ids=["vis_period", "weights_pretrain"])
@pytest.mark.parametrize("tool", ["train_net", "eval_boxes"])
def test_unported_fields_are_refused(tool, opts, tmp_path):
    """A config whose ``model.weights_pretrain`` names a file that is not
    there is refused before anything is written. ``vis_period``'s drawings
    are ported now, so it is not refused: the tool's ``setup`` reads it and
    goes on to fix the categories in ``output_dir``."""
    module = importlib.import_module(f"threedod_torch.{tool}")
    config = ROOT / "configs" / ("Base_Synth.yaml" if tool == "train_net" else "BoxNet_Synth.yaml")
    if opts[0] == "vis_period":
        cfg, meta, _ = module.setup(str(config), ["output_dir", str(tmp_path / "out"), *opts])
        assert cfg.vis_period == 20 and meta.thing_classes
        assert (tmp_path / "out" / "category_meta.json").exists()
        return
    args = module.parser().parse_args(["--config-file", str(config), "output_dir", str(tmp_path / "out"), *opts])
    with pytest.raises(FileNotFoundError, match=opts[0]):
        module.run(args, torch.device("cpu"))
    assert not (tmp_path / "out").exists()


@pytest.mark.parametrize("name", ["Base_Omni3D_og.yaml", "Base_Omni3D_prof.yaml"])
def test_vis_period_configs_get_past_setup_refusals(name, tmp_path):
    """The shipped configs that set ``vis_period`` are not refused: ``setup``
    gets as far as reading their Omni3D datasets, which this checkout lacks."""
    from threedod_torch.config_yaml import load_config
    from threedod_torch.train_net import setup

    assert load_config(str(ROOT / "configs" / name)).vis_period > 0
    with pytest.raises(FileNotFoundError, match="Omni3D"):
        setup(str(ROOT / "configs" / name), ["output_dir", str(tmp_path / "out"), "datasets.root", str(tmp_path)])


CARD_PATH_MODULES = ("threedod_torch.data.image_io", "threedod_torch.data.mapper", "threedod_torch.vis",
                     "threedod_torch.vis.vis", "threedod_torch.vis.draw", "threedod_torch.vis.render",
                     "threedod_torch.vis.png", "threedod_torch.vis.logperf", "threedod_torch.demo",
                     "threedod_torch.kitti_demo", "threedod_torch.train_net", "threedod_torch.eval_boxes")


def test_card_paths_import_without_pillow_or_matplotlib():
    """In a fresh interpreter where ``PIL`` and ``matplotlib`` cannot be
    imported, every module of the card's data and drawing paths imports, and
    ``image_hw`` reads a fixture JPEG's size from its header."""
    import subprocess
    import sys

    jpeg = next((ROOT / "datasets" / "synth").rglob("*.jpg"))
    code = ("import sys; sys.modules['PIL'] = None; sys.modules['matplotlib'] = None\n"
            "import importlib\n"
            f"for m in {CARD_PATH_MODULES!r}: importlib.import_module(m)\n"
            "from threedod_torch.data.image_io import image_hw\n"
            f"print(image_hw({str(jpeg)!r}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split()[-2:] == ["(480,", "640)"]


def test_log_without_wandb(tmp_path, monkeypatch, caplog):
    import sys

    from threedod_torch.train.events import EventStorage

    monkeypatch.setitem(sys.modules, "wandb", None)  # as on a machine without it
    storage = EventStorage(str(tmp_path), window=1, use_wandb=True)
    assert "wandb requested but unavailable" in caplog.text
    storage.put_scalars(total_loss=1.5)
    storage.flush()
    storage.close()
    assert (tmp_path / "metrics.json").read_text().strip() == '{"iteration": 0, "total_loss": 1.5}'


def test_boxnet_config_defaults_match_jax():
    """The propose-and-score tool's fields are among those pinned."""
    from threedod.config import Config as JaxConfig

    from threedod_torch.config import Config

    fields = dict(_fields(Config()))
    for path in ("plot.eval", "plot.mode2d", "plot.scoring_func", "plot.proposal_func", "plot.number_of_proposals",
                 "plot.output_dir", "train.pseudo_gt", "model.roi_cube_head.number_of_proposals"):
        ref = JaxConfig()
        for p in path.split("."):
            ref = getattr(ref, p)
        assert fields[path] == ref, path


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
                "threedod_torch.train.depth", "threedod_torch.train_depth", "threedod_torch.train_net",
                "threedod_torch.data.image_io", "threedod_torch.data.build", "threedod_torch.evaluation.inference",
                "threedod_torch.geometry.iou3d", "threedod_torch.utils.model_zoo", "threedod_torch.ops.jpeg",
                "threedod_torch.models.sam", "threedod_torch.models.tinyvit", "threedod_torch.generate_object_masks",
                "threedod_torch.generate_ground_segmentations", "threedod_torch.generate_depth_maps",
                "threedod_torch.generate_normal_vectors", "threedod_torch.filter_ground", "threedod_torch.vis",
                "threedod_torch.demo", "threedod_torch.kitti_demo", "threedod_torch.kitti_split",
                "threedod_torch.kitti_pred_overwrite_z", "threedod_torch.data.kitti"):
        importlib.import_module(mod)
    assert _build.load.cache_info().currsize == 0


CUDA_SOURCES = sorted((ROOT / "threedod_torch" / "ops" / "csrc").glob("*.cu*"))
ALLOWED_INCLUDES = {"cuda.h", "cuda_bf16.h", "cuda_runtime.h", "stdint.h", "math.h", "fused_conv_common.cuh",
                    "conv_wgmma.cuh", "flash_attention_common.cuh", "roi_align_common.cuh", "jpeg_entropy.cuh"}


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
                     "flash_attention_bwd.cu", "ms_deform_sample.cu", "jpeg_decode.cu",
                     "jpeg_entropy.cuh", "png_decode.cu"}


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


def test_train_net_refuses_without_cuda(tmp_path):
    from threedod_torch import train_net

    with pytest.raises(RuntimeError, match="CUDA"):
        train_net.main(["--config-file", str(ROOT / "configs" / "Base_Synth.yaml"), "--device", "cpu",
                        "output_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()  # refused before anything was written


def test_eval_boxes_refuses_without_cuda(tmp_path):
    from threedod_torch import eval_boxes

    with pytest.raises(RuntimeError, match="CUDA"):
        eval_boxes.main(["--config-file", str(ROOT / "configs" / "BoxNet_Synth.yaml"), "--device", "cpu",
                         "output_dir", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()


def test_nvjpeg_links_the_toolkit_library():
    """No source links a library, nvJPEG included: every source is built
    with ``NVCC_FLAGS``, which name no library, and none calls nvJPEG (the
    card decodes JPEGs with its own kernels, ``jpeg_decode``)."""
    from threedod_torch.ops import _build

    assert not any(f.startswith(("-l", "-L")) or f == "-Xlinker" for f in _build.NVCC_FLAGS), _build.NVCC_FLAGS
    for path in CUDA_SOURCES:
        assert not re.search(r"\bnvjpeg[A-Z]\w*\s*\(", path.read_text()), path.name


@pytest.mark.parametrize("tool", ["demo", "kitti_demo"])
def test_drawing_tools_refuse_without_cuda(tool, tmp_path):
    module = importlib.import_module(f"threedod_torch.{tool}")
    extra = ["--input-folder", str(ROOT / "datasets")] if tool == "demo" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main(["--config-file", str(ROOT / "configs" / "Base_Synth.yaml"), "--device", "cpu",
                     "--output-dir", str(tmp_path / "out"), *extra])
    assert not (tmp_path / "out").exists()


def test_infer_refuses_without_cuda():
    from threedod_torch import infer

    with pytest.raises(RuntimeError, match="CUDA"):
        infer.main(["--device", "cpu"])
