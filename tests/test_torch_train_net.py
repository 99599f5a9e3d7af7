"""The port's slice from data to evaluation (``threedod_torch.train_net``) vs
the JAX package, on the CPU, on Base_Synth cut to a 96x128 canvas
(``min_size_*`` 96), batch 2, f32, 4 test images (the first 4 of
``synth_test``, in a datasets root made here that links the fixture's images):

* the first training step: the port's ``setup`` and ``TrainLoader`` make the
  batch, the weights are the JAX model's (numpy-made, its priors from the JAX
  ``compute_priors``) through ``from_jax_variables``; every loss of the port's
  ``Trainer.train_step`` equals the JAX ``Trainer``'s step on the same batch
  within ``test_torch_train_step.py``'s 2e-3. As there, the samplers are
  saturated (the RPN on p4 to p6, all 192 anchors kept, no proposal NMS, all
  208 ROIs sampled), so the chosen sets do not depend on the noise. The two
  train-mode trunks differ by up to 1e-3 of the features' scale (XLA's CPU
  reductions sum in another order; see ``test_torch_train_step.py``), and so
  do the RPN's deltas and the proposals decoded from them. The ROI head's
  box-regression targets weigh the proposals' centres by 10 (its
  ``Box2BoxTransform`` weights are (10, 10, 5, 5)), so ``loss_box_reg``, an L1
  of those targets, is held to 10 x 1e-3 relative (``BOX_REG_RTOL``; it
  differs by 5.5e-3 here); every other loss to the 2e-3 of
  ``test_torch_train_step.py``;
* ``do_test`` writes ``results.json``, whose AP2D and AP3D equal the JAX
  ``Omni3DEvaluationHelper``'s on the port's own predictions;
* ``run`` trains, checkpoints at iteration 1 and evaluates; ``--resume``
  continues from that checkpoint at iteration 1 to 2; and ``--eval-only``
  evaluates it, on Base_Synth and on weak Cube R-CNN's Omni_combined_Synth
  (``main``'s refusal of the CPU is held in ``test_torch_port_hygiene.py``);
* the 2D-only ablation (``loss_w_3d`` 0) trains a step and evaluates.
"""
from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 2e-3
BOX_REG_RTOL = 10 * 1e-3  # the trunks' 1e-3, through the box targets' weight 10 (see the docstring)
SMALL = [
    "model.dtype", "float32", "shapes.canvas_height", "96", "shapes.canvas_width", "128",
    "input.min_size_train", "[96]", "input.min_size_test", "96", "solver.ims_per_batch", "2",
    "solver.max_iter", "2", "solver.checkpoint_period", "1", "datasets.test", "[synth_test4]",
]
SATURATE = [
    "model.rpn.in_features", "[p4, p5, p6]", "model.rpn.nms_thresh", "1.0", "model.rpn.pre_nms_topk_train", "192",
    "model.rpn.post_nms_topk_train", "192", "model.rpn.pre_nms_topk_test", "192", "model.rpn.post_nms_topk_test", "192",
    "model.rpn.batch_size_per_image", "192", "shapes.roi_batch", "208",
    "model.roi_heads.positive_fraction", "1.0",
]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A datasets root: the training JSON, a 4-image test JSON, the images and
    the depth and ground maps linked."""
    out = tmp_path_factory.mktemp("datasets")
    (out / "Omni3D").mkdir()
    src = ROOT / "datasets" / "Omni3D"
    (out / "Omni3D" / "synth_train.json").write_text((src / "synth_train.json").read_text())
    test = json.loads((src / "synth_test.json").read_text())
    keep = {im["id"] for im in test["images"][:4]}
    test["images"] = test["images"][:4]
    test["annotations"] = [a for a in test["annotations"] if a["image_id"] in keep]
    (out / "Omni3D" / "synth_test4.json").write_text(json.dumps(test))
    for name in ("synth", "depth_maps", "ground_maps"):
        os.symlink(ROOT / "datasets" / name, out / name)
    return out


def _opts(root, out, extra=()):
    return SMALL + ["datasets.root", str(root), "output_dir", str(out)] + list(extra)


@pytest.fixture(scope="module")
def first_step(root, tmp_path_factory):
    import optax
    from threedod.config import load_config as jax_load
    from threedod.data import Omni3D as JaxOmni3D, compute_priors as jax_priors
    from threedod.data import get_filter_settings_from_cfg as jax_fs
    from threedod.data.batch import GroundTruth as JaxGT
    from threedod.models import build_model as jax_build
    from threedod.train.trainer import Trainer as JaxTrainer, TrainState, init_stab

    from threedod_torch import train_net
    from threedod_torch.data.build import TrainLoader, get_dataset_dicts
    from threedod_torch.train.trainer import Trainer

    out = tmp_path_factory.mktemp("step")
    cfg, meta, priors = train_net.setup(str(ROOT / "configs" / "Base_Synth.yaml"), _opts(root, out, SATURATE))
    batch = TrainLoader(get_dataset_dicts(cfg.datasets.train), cfg, seed=cfg.seed).next_batch()

    jcfg = jax_load(str(ROOT / "configs" / "Base_Synth.yaml"), _opts(root, out, SATURATE))
    jcfg.model.roi_heads.num_classes = len(meta.thing_classes)
    fs = jax_fs(jcfg)
    jds = JaxOmni3D([os.path.join(str(root), "Omni3D", "synth_train.json")], filter_settings=fs)
    jpri = jax_priors(jcfg, jds, meta.thing_classes)
    variables = tp.init_like_variables(jcfg)
    variables["params"]["roi_heads"]["priors_dims_per_cat"] = np.asarray(jpri["priors_dims_per_cat"], np.float32)[None]

    # the supervised loader fills neither the weak path's maps nor its masks
    np_batch = {k: v.numpy() for k, v in batch._asdict().items() if k != "gt" and v is not None}
    jb = tp.jax_batch(np_batch["image"], np_batch["image_hw"], np_batch["K"], np_batch["im_scale_ratio"]).replace(
        gt=JaxGT(**{k: jnp.asarray(v.numpy()) for k, v in batch.gt._asdict().items() if v is not None}))
    jmodel = jax_build(jcfg, priors=jpri)
    jtrainer = JaxTrainer(jcfg, jmodel)
    optimizer = jtrainer.ensure_optimizer(variables["params"])
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=optimizer.init(variables["params"]), step=jnp.zeros((), jnp.int32), stab=init_stab())
    _, jout = jax.device_get(jax.jit(jtrainer._step_body())(state, jb, jax.random.PRNGKey(jcfg.seed)))
    del optax

    trainer = Trainer(cfg, tp.port_model(cfg, variables), torch.device("cpu"))
    pout = trainer.train_step(batch, torch.Generator().manual_seed(0))
    return dict(cfg=cfg, meta=meta, batch=batch, jlosses=jout.losses, pout=pout, variables=variables,
                jdiv=bool(jout.diverging), priors=priors, jpriors=jpri)


def test_first_batch_is_mapped_from_the_fixture(first_step):
    batch = first_step["batch"]
    assert batch.image.dtype == torch.uint8 and tuple(batch.image.shape) == (2, 96, 128, 3)
    assert batch.image_hw.tolist() == [[96, 128], [96, 128]] and batch.gt.valid.sum() > 2
    assert np.allclose(batch.im_scale_ratio.numpy(), 5.0)


def test_first_step_losses_equal_jax(first_step):
    jl, pout = first_step["jlosses"], first_step["pout"]
    assert set(pout.losses) == set(jl) and len(jl) == 10
    for k, ref in jl.items():
        rtol = BOX_REG_RTOL if k == "BoxHead/loss_box_reg" else LOSS_RTOL
        np.testing.assert_allclose(pout.losses[k], float(ref), rtol=rtol, atol=1e-6, err_msg=k)
    assert not pout.diverging and not first_step["jdiv"]
    np.testing.assert_allclose(np.asarray(first_step["priors"]["priors_dims_per_cat"]),
                               np.asarray(first_step["jpriors"]["priors_dims_per_cat"]), rtol=1e-12)


def test_do_test_results_equal_jax_helper(first_step, root):
    from threedod.evaluation import Omni3DEvaluationHelper as JaxHelper, gts_from_records as jax_gts

    from threedod_torch import train_net
    from threedod_torch.data.build import TestLoader, get_dataset_dicts
    from threedod_torch.evaluation.inference import inference_on_dataset
    from threedod_torch.infer import predict

    cfg, meta = first_step["cfg"], first_step["meta"]
    model = tp.port_model(cfg, first_step["variables"])
    results = train_net.do_test(cfg, model, meta, torch.device("cpu"))
    written = json.loads((pathlib.Path(cfg.output_dir) / "results.json").read_text())
    assert written["synth_test4"]["AP2D"] == pytest.approx(results["synth_test4"]["AP2D"], abs=1e-12)

    records = get_dataset_dicts(["synth_test4"])
    assert len(records) == 4
    id_map_inv = {v: k for k, v in meta.thing_dataset_id_to_contiguous_id.items()}
    preds, _ = inference_on_dataset(lambda b: predict(model, b), TestLoader(records, cfg), id_map_inv)
    assert len(preds) > 0
    helper = JaxHelper(["synth_test4"], meta.thing_classes, meta.thing_dataset_id_to_contiguous_id)
    ref = helper.evaluate("synth_test4", jax_gts(records, id_map_inv), preds)
    for key in ("AP2D", "AP3D", "AP3D@15", "AP3D@25", "AP3D@50"):
        assert written["synth_test4"][key] == pytest.approx(ref[key], abs=1e-4), key


def test_train_checkpoint_resume_and_eval_only(root, tmp_path):
    _train_resume_eval_only(str(ROOT / "configs" / "Base_Synth.yaml"), root, tmp_path)


def test_weak_train_checkpoint_resume_and_eval_only(root, tmp_path):
    """The same on weak Cube R-CNN: the loader reads the depth and ground maps,
    and the resumed run's RANSAC draws come from the restored generator."""
    resumed = _train_resume_eval_only(str(ROOT / "configs" / "Omni_combined_Synth.yaml"), root, tmp_path)
    metrics = [json.loads(line) for line in (tmp_path / "metrics.json").read_text().splitlines()]
    assert {"Cube/loss_normal_vec", "Cube/loss_depth", "Cube/loss_pseudo_gt_z"} <= set(metrics[-1])
    assert resumed["nonfinite_losses"] == 0


def test_2d_only_trains_and_evaluates(root, tmp_path):
    """The 2D-only ablation (``configs/Base_Omni3D_2D_only.yaml``'s
    ``loss_w_3d`` 0) on Base_Synth: a model without cube parameters trains a
    step of box and RPN losses and evaluates to a finite AP2D."""
    from threedod_torch import train_net

    out = train_net.run(train_net.parser().parse_args(
        ["--config-file", str(ROOT / "configs" / "Base_Synth.yaml")]
        + _opts(root, tmp_path, ["solver.max_iter", "1", "model.roi_cube_head.loss_w_3d", "0.0"])), torch.device("cpu"))
    assert out["steps"] == 1 and out["skipped"] == 0 and out["nonfinite_losses"] == 0
    assert np.isfinite(out["results"]["synth_test4"]["AP2D"])
    metrics = [json.loads(line) for line in (tmp_path / "metrics.json").read_text().splitlines()]
    assert not any(k.startswith("Cube/") for k in metrics[-1]) and "BoxHead/loss_cls" in metrics[-1]
    state = torch.load(tmp_path / "model_final.pt", weights_only=True)
    assert not any("cube_head" in k or "priors" in k for k in state["model"])


def _train_resume_eval_only(cfg_file, root, tmp_path):
    from threedod_torch import train_net
    from threedod_torch.train.checkpoint import CheckpointManager

    ap = train_net.parser()
    first = train_net.run(ap.parse_args(["--config-file", cfg_file] + _opts(root, tmp_path, ["solver.max_iter", "1"])),
                          torch.device("cpu"))
    assert first["iterations"] == 1 and first["steps"] == 1 and first["skipped"] == 0
    assert first["nonfinite_losses"] == 0 and np.isfinite(first["loss_first_mean"])
    assert np.isfinite(first["results"]["synth_test4"]["AP2D"])
    state = CheckpointManager(str(tmp_path), 1, 1).resume_or_load(resume=True)
    assert state["iteration"] == 1 and (tmp_path / "model_final.pt").exists()

    resumed = train_net.run(ap.parse_args(["--config-file", cfg_file, "--resume"] + _opts(root, tmp_path)),
                            torch.device("cpu"))
    assert resumed["first_iteration"] == 1 and resumed["iterations"] == 2 and resumed["steps"] == 1
    assert resumed["attempts"] == 1 and resumed["skipped"] == 0
    after = CheckpointManager(str(tmp_path), 1, 2).resume_or_load(resume=True)
    assert after["iteration"] == 2 and after["count"] == 2

    only = train_net.run(ap.parse_args(["--config-file", cfg_file, "--eval-only"] + _opts(root, tmp_path)),
                         torch.device("cpu"))
    for key in ("AP2D", "AP3D", "AP3D@15", "percat2D", "percat3D"):  # the final checkpoint, evaluated again
        assert only["results"]["synth_test4"][key] == resumed["results"]["synth_test4"][key], key
    metrics = [json.loads(line) for line in (tmp_path / "metrics.json").read_text().splitlines()]
    assert {"total_loss", "time", "data_time", "lr"} <= set(metrics[-1])
    return resumed
