"""Optimizer and learning-rate schedule (counterpart of
``threedod/train/solver.py``).

``torch.optim`` SGD, Adam and AdamW (each optionally ``+amsgrad``, in
torch's own semantics) over two parameter groups: the decayed one, and one
without weight decay for the ``priors*`` parameters and every BatchNorm
weight and bias. Every Adam variant runs with eps = 1e-2. The warm-up
multi-step schedule is a function of the number of applied updates; the
trainer writes it into the groups before each update.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn

from ..models.backbones.layers import BatchNorm2d

ADAM_EPS = 1e-2


def host_lr(solver_cfg, iteration: int) -> float:
    """detectron2's WarmupMultiStepLR: linear warm-up, then step decays."""
    if solver_cfg.warmup_iters <= 0:
        warm = 1.0
    else:
        warm = min(max(iteration / solver_cfg.warmup_iters, 0.0), 1.0)
    factor = solver_cfg.warmup_factor * (1 - warm) + warm
    milestones = sum(1 for s in solver_cfg.steps if iteration >= s)
    return float(solver_cfg.base_lr * factor * (solver_cfg.gamma ** milestones))


def param_groups(model: nn.Module, weight_decay: float) -> List[dict]:
    """[decayed, not decayed]: priors and norm-layer parameters train decay-free."""
    norm_params = {id(p) for m in model.modules() if isinstance(m, BatchNorm2d) for p in m.parameters(recurse=False)}
    decay, no_decay = [], []
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        plain = "priors" in name or id(p) in norm_params
        (no_decay if plain else decay).append(p)
    return [{"params": decay, "weight_decay": weight_decay}, {"params": no_decay, "weight_decay": 0.0}]


def build_optimizer(cfg, model: nn.Module) -> torch.optim.Optimizer:
    s = cfg.solver
    groups = param_groups(model, s.weight_decay)
    lr = host_lr(s, 0)
    opt_type = s.type.lower()
    amsgrad = opt_type.endswith("+amsgrad")
    if opt_type == "sgd":
        return torch.optim.SGD(groups, lr=lr, momentum=s.momentum, nesterov=s.nesterov)
    if opt_type in ("adam", "adam+amsgrad"):
        return torch.optim.Adam(groups, lr=lr, eps=ADAM_EPS, amsgrad=amsgrad)
    if opt_type in ("adamw", "adamw+amsgrad"):
        return torch.optim.AdamW(groups, lr=lr, eps=ADAM_EPS, amsgrad=amsgrad)
    raise ValueError(f"unknown solver type '{s.type}'")


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


@torch.no_grad()
def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> None:
    """Scale the gradients in place by max_norm / max(norm, max_norm), norm
    being their joint 2-norm (no epsilon, unlike ``clip_grad_norm_``)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    torch._foreach_mul_(grads, max_norm / norm.clamp(min=max_norm))
