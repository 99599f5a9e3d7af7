"""The port's training loop on the CPU at a tiny size (the port alone: the
JAX loop's asynchronous dispatch has no counterpart to compare step by step):
``fit`` with the recent/final checkpoint policy and the scalar log, resuming
from a checkpoint, the schedule count that a skipped step does not advance,
frozen BatchNorm statistics, and the retry loop giving up.
"""
from __future__ import annotations

import json
import math

import numpy as np
import pytest
import torch

import _torch_port as tp

from threedod_torch.data.batch import synthetic_train_batch
from threedod_torch.train import build_trainer, train_with_retries
from threedod_torch.train.checkpoint import CheckpointManager
from threedod_torch.train.solver import build_optimizer, host_lr, param_groups

SMALL = {
    "model.rpn.pre_nms_topk_train": 100, "model.rpn.post_nms_topk_train": 40,
    "model.rpn.batch_size_per_image": 32, "shapes.roi_batch": 16, "shapes.max_gt": 8,
    "solver.max_iter": 4, "solver.checkpoint_period": 2, "solver.warmup_iters": 2,
}


def _cfg(tmp_path, **extra):
    _, cfg = tp.configs(**{**SMALL, **extra})
    cfg.output_dir = str(tmp_path)
    return cfg


def _loader(cfg, bad_from=None):
    step = 0
    while True:
        batch = synthetic_train_batch(cfg, 2, seed=step)
        if bad_from is not None and step >= bad_from:
            batch = batch._replace(image=batch.image * float("nan"))
        step += 1
        yield batch


def test_fit_checkpoints_and_resume(tmp_path):
    cfg = _cfg(tmp_path)
    trainer = build_trainer(cfg, torch.device("cpu"), seed=0)
    assert trainer.fit(_loader(cfg)) is True
    assert trainer.count == 4 and trainer.iteration == 4
    assert (tmp_path / "model_recent.pt").exists() and (tmp_path / "model_final.pt").exists()
    records = [json.loads(line) for line in (tmp_path / "metrics.json").read_text().splitlines()]
    assert records[-1]["iteration"] == 3 and math.isfinite(records[-1]["total_loss"])
    assert {"lr", "rpn/cls", "Cube/loss_joint", "roi/num_fg"} <= set(records[-1])

    state = CheckpointManager(cfg.output_dir, 2, 4).resume_or_load(resume=True)
    resumed = build_trainer(cfg, torch.device("cpu"), seed=1)  # other weights, then the checkpoint's
    resumed.load_state_dict(state)
    assert resumed.count == 4 and resumed.iteration == 4 and resumed.stab == trainer.stab
    for (k, a), b in zip(trainer.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    buf = next(iter(resumed.optimizer.state.values()))["momentum_buffer"]
    assert torch.isfinite(buf).all() and buf.abs().sum() > 0
    assert CheckpointManager(cfg.output_dir, 2, 4).resume_or_load(resume=False) is None


def test_skipped_step_advances_nothing(tmp_path):
    cfg = _cfg(tmp_path)
    trainer = build_trainer(cfg, torch.device("cpu"), seed=0)
    good, bad = next(_loader(cfg)), next(_loader(cfg, bad_from=0))
    trainer.train_step(good)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    stab = trainer.stab
    out = trainer.train_step(bad)
    assert out.diverging and trainer.count == 1 and trainer.iteration == 2 and trainer.stab == stab
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, before[k]), k
    trainer.train_step(good)  # the next update runs at the schedule's second value
    assert trainer.count == 2
    assert trainer.optimizer.param_groups[0]["lr"] == host_lr(cfg.solver, 1)


def test_freeze_bn_keeps_running_statistics(tmp_path):
    cfg = _cfg(tmp_path, **{"model.freeze_bn": True})
    trainer = build_trainer(cfg, torch.device("cpu"), seed=0)
    before = {k: v.clone() for k, v in trainer.model.named_buffers()}
    weight = trainer.model.backbone.bottom_up.base_layer[1].weight.detach().clone()
    assert not trainer.train_step(next(_loader(cfg))).diverging
    for k, v in trainer.model.named_buffers():
        assert torch.equal(v, before[k]), k
    assert not torch.equal(trainer.model.backbone.bottom_up.base_layer[1].weight, weight)  # BN still trains


def test_retries_give_up(tmp_path):
    cfg = _cfg(tmp_path, **{"solver.max_iter": 6, "max_training_attempts": 2})
    built = []

    def build_fn(resume):
        built.append(resume)
        return build_trainer(cfg, torch.device("cpu"), seed=0), 0

    with pytest.raises(RuntimeError, match="after 2 attempts"):
        train_with_retries(cfg, build_fn, lambda: _loader(cfg, bad_from=0))
    assert built == [False, True]
    assert not (tmp_path / "model_recent.pt").exists()  # nothing is saved while diverging


@pytest.mark.parametrize("opt_type", ["sgd", "adam", "adam+amsgrad", "adamw", "adamw+amsgrad"])
def test_optimizer_groups(opt_type):
    _, cfg = tp.configs(**{"solver.type": opt_type})
    from threedod_torch.models.meta_arch import build_model

    model = build_model(cfg, seed=0)
    decay, plain = param_groups(model, cfg.solver.weight_decay)
    names = {id(p): n for n, p in model.named_parameters()}
    plain_names = {names[id(p)] for p in plain["params"]}
    assert plain["weight_decay"] == 0.0 and decay["weight_decay"] == cfg.solver.weight_decay
    assert {"roi_heads.priors_dims_per_cat", "roi_heads.priors_z_scales", "roi_heads.priors_z_stats",
            "backbone.bottom_up.base_layer.1.weight", "backbone.bottom_up.level5.root.bn.bias"} <= plain_names
    assert "backbone.bottom_up.base_layer.0.weight" not in plain_names
    assert len(decay["params"]) + len(plain["params"]) == len(names)
    opt = build_optimizer(cfg, model)
    assert type(opt).__name__.lower() == opt_type.split("+")[0]
    if opt_type != "sgd":
        assert opt.defaults["eps"] == 1e-2 and opt.defaults["amsgrad"] == opt_type.endswith("amsgrad")
    assert np.isclose(opt.param_groups[0]["lr"], host_lr(cfg.solver, 0))
