"""Weak Cube R-CNN's training step over 2 processes vs one process at the
global batch, and vs the JAX package, f32 on the CPU.

``test_torch_weak_train.py``'s ResNet18 ``RCNN3DCombined`` with its 7-loss
menu, saturated samplers and fronto-parallel depth maps (every RANSAC
hypothesis that is not degenerate gives the same floor normal, whatever the
draw), on a global batch of 4 images: ``test_torch_ddp_train.py``'s images
and ground truth, each half with ``test_torch_weak_train._maps``'s depth,
ground maps and box masks (images 1 and 3 have no ground pixel). One spawn
of 2 gloo ranks takes the step with 2 images each; the same function takes
it in this process on all 4; one ``jax.jit`` of the JAX step takes it at 4.
The RANSAC fit draws its hypotheses for the global batch and each rank keeps
its rows (``geometry/plane.py``); the pose-alignment loss averages over the
global batch's images that have a pair of cubes.

2 ranks vs one process, with the BatchNorms on their running statistics
("frozen"): losses and metrics to 1e-5 relative, the updated parameters to
1e-6 of each tensor's largest entry, the gradients to 1e-5 of it; on the
global batch's statistics ("train"): losses and metrics to 1e-4 relative,
the running statistics to 1e-5 of each tensor's largest entry and the
gradients and updates by cosine (0.99 a leaf, 0.9999 over all), for the
reasons ``test_torch_ddp_train.py`` gives. Against the JAX step, the 2-rank
"train" step at ``test_torch_weak_train.py``'s tolerances: losses and
metrics 2e-3 relative, gradients by cosine 0.9 and relative L2 distance 0.5
a leaf and cosine 0.99 over all.
"""
from __future__ import annotations

import numpy as np
import pytest

import _torch_ddp as td
import _torch_port as tp
from test_torch_ddp_train import (FROZEN_GRAD_TOL, FROZEN_LOSS_RTOL, FROZEN_PARAM_TOL, TRAIN_ALL_COS,
                                  TRAIN_LEAF_COS, TRAIN_LOSS_RTOL, TRAIN_STATS_TOL, _cosines, _rel, global_batch)
from test_torch_weak_train import WEAK, _maps

import jax
import jax.numpy as jnp
import optax

LOSS_RTOL = 2e-3
LEAF_COS, LEAF_L2, ALL_COS = 0.9, 0.5, 0.99


@pytest.fixture(scope="module")
def run():
    from threedod.data.batch import normalize_image as jax_normalize
    from threedod.train.trainer import Trainer as JaxTrainer, TrainState, init_stab

    from threedod_torch.utils.convert_weights import from_jax_variables

    jcfg, pcfg = tp.configs(**{**tp.TRAIN_OVERRIDES, **WEAK, "solver.ims_per_batch": 4})
    img, hw, K, ratio, gt = global_batch()
    halves = [_maps({k: v[i:i + 2] for k, v in gt.items()}, *img.shape[1:3]) for i in (0, 2)]
    depth, ground, masks = (np.concatenate(parts) for parts in zip(*halves))
    img = np.array(jax_normalize(jnp.asarray(img), jcfg.model, jnp.asarray(hw)), np.float32)
    jb = tp.jax_train_batch(img, hw, K, ratio, gt)
    jb = jb.replace(gt=jb.gt.replace(masks=jnp.asarray(masks)), depth_map=jnp.asarray(depth),
                    ground_map=jnp.asarray(ground))
    tb = tp.torch_train_batch(img, hw, K, ratio, gt)
    import torch

    tb = tb._replace(gt=tb.gt._replace(masks=torch.from_numpy(masks)), depth_map=torch.from_numpy(depth),
                     ground_map=torch.from_numpy(ground))
    jmodel, variables = tp.jax_model(jcfg)

    jtrainer = JaxTrainer(jcfg, jmodel)
    real = jtrainer.ensure_optimizer(variables["params"])
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params), lambda updates, state, params=None: (updates, updates))
    jtrainer.optimizer = optimizer = optax.chain(keep, real)
    state = TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=optimizer.init(variables["params"]), step=jnp.zeros((), jnp.int32), stab=init_stab())
    jstate, jout = jax.device_get(jax.jit(jtrainer._step_body())(state, jb, jax.random.PRNGKey(jcfg.seed)))

    job = dict(cfg=pcfg, state=from_jax_variables(variables, pcfg), modes=("frozen", "train"), batch=tb)
    one = td.detector_step(job)
    ranks = td.on_ranks("detector_step", job)
    as_np = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)  # noqa: E731
    jax_ref = dict(
        losses=jout.losses, metrics=jout.metrics, diverging=bool(jout.diverging), stab=float(jstate.stab),
        grads={k: v.numpy() for k, v in from_jax_variables({"params": as_np(jstate.opt_state[0])}, pcfg).items()})
    return dict(one=one, ranks=ranks, jax=jax_ref, before={k: v.numpy() for k, v in job["state"].items()},
                params={k for k in job["state"] if not k.endswith(("running_mean", "running_var"))})


def test_ranks_end_alike(run):
    a, b = run["ranks"]
    for mode in ("frozen", "train"):
        assert a[mode]["losses"] == b[mode]["losses"]
        for part in ("grads", "after"):
            for k, v in a[mode][part].items():
                np.testing.assert_array_equal(v, b[mode][part][k], err_msg=f"{mode} {part} {k}")


def test_frozen_statistics_step_matches_one_process(run):
    got, want = run["ranks"][0]["frozen"], run["one"]["frozen"]
    assert {"Cube/loss_pose", "Cube/loss_normal_vec", "Cube/loss_depth"} <= set(got["losses"])
    _rel(got["losses"], want["losses"], FROZEN_LOSS_RTOL, "loss")
    _rel(got["metrics"], want["metrics"], FROZEN_LOSS_RTOL, "metric")
    td.close_to_largest(got["grads"], want["grads"], FROZEN_GRAD_TOL, "gradient")
    td.close_to_largest(got["after"], want["after"], FROZEN_PARAM_TOL, "after")


def test_train_step_matches_one_process(run):
    got, want = run["ranks"][0]["train"], run["one"]["train"]
    assert not got["diverging"] and not want["diverging"]
    _rel(got["losses"], want["losses"], TRAIN_LOSS_RTOL, "loss")
    _rel(got["metrics"], want["metrics"], TRAIN_LOSS_RTOL, "metric")
    stats = {k: v for k, v in want["after"].items() if k not in run["params"]}
    td.close_to_largest({k: got["after"][k] for k in stats}, stats, TRAIN_STATS_TOL, "running statistic")
    _cosines(got["grads"], want["grads"], TRAIN_LEAF_COS, TRAIN_ALL_COS)
    updates = [{k: r["after"][k] - run["before"][k] for k in run["params"]} for r in (got, want)]
    _cosines(*updates, TRAIN_LEAF_COS, TRAIN_ALL_COS)


def test_train_step_matches_jax(run):
    got, ref = run["ranks"][0]["train"], run["jax"]
    assert not ref["diverging"]
    _rel(got["losses"], ref["losses"], LOSS_RTOL, "loss")
    _rel(got["metrics"], ref["metrics"], LOSS_RTOL, "metric")
    _cosines(got["grads"], ref["grads"], LEAF_COS, ALL_COS, LEAF_L2)
    np.testing.assert_allclose(got["rolling"], ref["stab"], rtol=LOSS_RTOL)
