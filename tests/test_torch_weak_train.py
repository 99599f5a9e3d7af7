"""Weak Cube R-CNN's training slice vs the JAX package, f32 on the CPU.

One seeded JAX ``RCNN3DCombined`` (the parameters of ``RCNN3D``) goes through
the weight bridge into the port's. One numpy batch with ground truth, box
masks, depth maps and ground maps flows through both:

* the training forward against ``apply(train=True)``: every loss of the
  7-loss menu (``configs/Omni_combined_Synth.yaml``'s) and every metric, key
  by key;
* the gradient of the summed losses against the JAX step's own
  ``jax.value_and_grad``, leaf by leaf;
* one ``Trainer.train_step`` against the JAX ``Trainer._step_body``: the
  updated parameters and the stabiliser's rolling mean.

The JAX side is one ``jax.jit`` of the trainer's step body, whose optimizer
is chained behind a pass-through stage that keeps the gradients, as in
``test_torch_train_step.py``. That file's route two and tolerances hold here
for the same reasons: the configuration saturates both subsamplers and
switches the proposal NMS off (``_torch_port.TRAIN_OVERRIDES``), so the
sampled sets do not depend on the noise; losses are held to 2e-3 relative,
gradients by cosine.

The weak losses add three discrete choices. The RANSAC fit: each image's
depth is fronto-parallel at a value exact in float16 (2.5 and 4.0 m), so
every hypothesis that is not degenerate gives the normal (0, 0, +-1), the
floor normal (0, 1, 0) after the wall fix-up, whatever indices either side
draws (the JAX side draws from its key, the port from its generator). The
median and the quantiles of the depth windows: a constant depth gives the
same value at every index. The z search's best step: the projected boxes
differ by the trunks' 1e-3, which could pick the neighbouring step where two
steps tie within it; on this batch no step flips (the loss is held to 2e-3
like the others), and ``test_torch_weak.py`` holds the search on identical
inputs. Image 1 has a ground map with no ground pixel, so its pose-ground
loss takes the 0.1 weight.

Also here: inference of the port's ``RCNN3DCombined`` equals ``RCNN3D``'s on
the same weights, and a ``RCNN3D`` state dict loads into it through
``utils/model_zoo.load_model_weights``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp
import optax

LOSS_RTOL = 2e-3
LEAF_COS, LEAF_L2, ALL_COS = 0.9, 0.5, 0.99
# the trunk is ResNet18: the weak losses do not depend on it, and its JAX
# step compiles in half the time of DLA34's (whose step is held in
# test_torch_train_step.py)
WEAK = {"model.meta_architecture": "RCNN3DCombined", "model.backbone": "resnet18",
        "model.roi_cube_head.loss_w_pose": 7.0, "model.roi_cube_head.loss_w_dims": 20.0}
MENU_KEYS = {"Cube/loss_iou", "Cube/loss_pose", "Cube/loss_normal_vec", "Cube/loss_z", "Cube/loss_pseudo_gt_z",
             "Cube/loss_dims_w", "Cube/loss_dims_h", "Cube/loss_dims_l", "Cube/loss_depth", "Cube/uncert"}


def _maps(gt, h, w):
    """Fronto-parallel depth (f16-exact), ground maps (image 1: none on the
    ground) and the ground truth's boxes filled on the quarter grid."""
    depth = np.stack([np.full((h, w), 2.5), np.full((h, w), 4.0)]).astype(np.float16)
    ground = np.zeros((2, h, w), np.uint8)
    ground[0, h // 2:] = 1
    hm, wm = h // 4, w // 4
    ys, xs = np.arange(hm)[:, None], np.arange(wm)[None, :]
    masks = np.zeros(gt["boxes2d"].shape[:2] + (hm, wm), np.uint8)
    for i in range(masks.shape[0]):
        for j in range(masks.shape[1]):
            if gt["valid"][i, j]:
                x1, y1, x2, y2 = gt["boxes2d"][i, j] / 4.0
                masks[i, j] = (ys >= y1) & (ys < y2) & (xs >= x1) & (xs < x2)
    return depth, ground, masks


@pytest.fixture(scope="module")
def run():
    from threedod.data.batch import normalize_image as jax_normalize
    from threedod.train.trainer import Trainer as JaxTrainer, TrainState, init_stab

    from threedod_torch.train.trainer import Trainer
    from threedod_torch.utils.convert_weights import from_jax_variables

    jcfg, pcfg = tp.configs(**tp.TRAIN_OVERRIDES, **WEAK)
    img, image_hw, K, ratio = tp.inputs()
    gt = tp.ground_truth()
    depth, ground, masks = _maps(gt, *img.shape[1:3])
    img = np.array(jax_normalize(jnp.asarray(img), jcfg.model, jnp.asarray(image_hw)), np.float32)
    jb = tp.jax_train_batch(img, image_hw, K, ratio, gt)
    jb = jb.replace(gt=jb.gt.replace(masks=jnp.asarray(masks)), depth_map=jnp.asarray(depth),
                    ground_map=jnp.asarray(ground))
    tb = tp.torch_train_batch(img, image_hw, K, ratio, gt)
    tb = tb._replace(gt=tb.gt._replace(masks=torch.from_numpy(masks)), depth_map=torch.from_numpy(depth),
                     ground_map=torch.from_numpy(ground))
    jmodel, variables = tp.jax_model(jcfg)
    assert type(jmodel).__name__ == "RCNN3DCombined"

    # ---- JAX: the trainer's own step, compiled once, keeping its gradients --
    jtrainer = JaxTrainer(jcfg, jmodel)
    real = jtrainer.ensure_optimizer(variables["params"])
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params), lambda updates, state, params=None: (updates, updates))
    jtrainer.optimizer = optimizer = optax.chain(keep, real)
    state = TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=optimizer.init(variables["params"]), step=jnp.zeros((), jnp.int32), stab=init_stab())
    jstate, out = jax.device_get(jax.jit(jtrainer._step_body())(state, jb, jax.random.PRNGKey(jcfg.seed)))

    # ---- port ---------------------------------------------------------------
    pmodel = tp.port_model(pcfg, variables).train()
    assert type(pmodel).__name__ == "RCNN3DCombined"
    losses, metrics = pmodel(tb, torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    pgrads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
              for k, p in pmodel.named_parameters()}
    trainer = Trainer(pcfg, tp.port_model(pcfg, variables), torch.device("cpu"))
    before = {k: v.detach().numpy().copy() for k, v in trainer.model.state_dict().items()}
    step = trainer.train_step(tb, torch.Generator().manual_seed(0))
    after = {k: v.detach().numpy().copy() for k, v in trainer.model.state_dict().items()}

    as_np = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)  # noqa: E731
    return dict(
        pcfg=pcfg, jlosses=out.losses, jmetrics=out.metrics, jdiv=bool(out.diverging),
        losses={k: v.item() for k, v in losses.items()}, metrics={k: float(v) for k, v in metrics.items()},
        jgrads=from_jax_variables({"params": as_np(jstate.opt_state[0])}, pcfg), pgrads=pgrads,
        jafter=from_jax_variables({"params": as_np(jstate.params)}, pcfg), jstab=float(jstate.stab),
        before=before, after=after, step=step, variables=variables,
    )


def test_loss_keys(run):
    assert set(run["losses"]) == set(run["jlosses"]) == MENU_KEYS | {
        "BoxHead/loss_cls", "BoxHead/loss_box_reg", "rpn/cls", "rpn/loc"}
    assert set(run["metrics"]) == set(run["jmetrics"])
    assert {"Cube/2D IoU", "Cube/total_3D_loss", "roi/num_fg"} <= set(run["metrics"])


def test_losses(run):
    for k, ref in run["jlosses"].items():
        assert np.isfinite(ref), k
        np.testing.assert_allclose(run["losses"][k], ref, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    # the depth windows of a fronto-parallel map have no range: the depth loss
    # is the cubes' own extent, and the pseudo depth is the map's
    assert run["losses"]["Cube/loss_depth"] > 0 and run["losses"]["Cube/loss_normal_vec"] > 0


def test_metrics(run):
    for k, ref in run["jmetrics"].items():
        np.testing.assert_allclose(run["metrics"][k], ref, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    assert run["metrics"]["roi/num_fg"] > 0


def test_gradients_leaf_by_leaf(run):
    jg, pg = run["jgrads"], run["pgrads"]
    assert set(jg) == set(pg)
    dot = nj = npp = 0.0
    nonzero = 0
    for name, ref in jg.items():
        ref = ref.numpy().astype(np.float64).ravel()
        got = pg[name].astype(np.float64).ravel()
        if np.abs(ref).max() == 0:  # priors, unused outer projections
            assert np.abs(got).max() == 0, name
            continue
        nonzero += 1
        cos = ref @ got / (np.linalg.norm(ref) * np.linalg.norm(got))
        dist = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert cos >= LEAF_COS and dist <= LEAF_L2, (name, cos, dist)
        dot, nj, npp = dot + ref @ got, nj + ref @ ref, npp + got @ got
    assert nonzero >= 100  # ResNet18-FPN and the heads: 106 leaves the losses reach
    assert dot / np.sqrt(nj * npp) >= ALL_COS


def test_train_step_matches(run):
    """Both steps take an SGD step from zero momentum on their own gradient
    (held tightly) and end within the gradients' tolerance of each other."""
    assert not run["jdiv"] and not run["step"].diverging
    cfg = run["pcfg"]
    lr = cfg.solver.base_lr * cfg.solver.warmup_factor  # warm-up at count 0
    for name, ref in run["jafter"].items():
        old = run["before"][name]
        norm = old.ndim == 1 and (".bn" in name or name.rsplit(".", 2)[-2].isdigit())
        wd = 0.0 if norm or "priors" in name else cfg.solver.weight_decay
        for new, grad in ((ref.numpy(), run["jgrads"][name].numpy()), (run["after"][name], run["pgrads"][name])):
            want = -lr * (grad + wd * old)
            atol = 1e-3 * np.abs(want).max() + 2e-7 * np.abs(old).max() + 1e-12
            np.testing.assert_allclose(new - old, want, rtol=0, atol=atol, err_msg=name)
    np.testing.assert_allclose(run["step"].rolling, run["jstab"], rtol=LOSS_RTOL)
    assert set(run["step"].losses) == set(run["jlosses"])


def test_inference_equals_rcnn3d(run):
    """Eval-mode RCNN3DCombined is RCNN3D: the same detections, bit for bit,
    from the same weights; an RCNN3D state dict loads through the zoo loader."""
    import dataclasses

    from threedod_torch.infer import predict
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils.model_zoo import load_model_weights

    weak_cfg = run["pcfg"]
    sup_cfg = dataclasses.replace(weak_cfg, model=dataclasses.replace(weak_cfg.model, meta_architecture="RCNN3D"))
    sup = tp.port_model(sup_cfg, run["variables"])
    weak = load_model_weights({"model": sup.state_dict()}, build_model(weak_cfg, seed=3))
    assert type(weak).__name__ == "RCNN3DCombined"
    batch = tp.torch_batch(*tp.inputs(seed=9))
    a, b = predict(sup.eval(), batch), predict(weak.eval(), batch)
    assert a.valid.any()
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name
