"""Training loop with the divergence guard (counterpart of
``threedod/train/trainer.py``).

One ``train_step`` is: training forward, sum of the losses, backward, the
guard, and the optimizer update. The guard skips the whole update when the
loss or any gradient is not finite, or the loss exceeds ``TOLERANCE`` times
a rolling mean of recent losses; a skipped step leaves parameters, optimizer
state, running BatchNorm statistics and the schedule count as they were.
``fit`` is one training attempt, with evaluation every
``cfg.test.eval_period`` iterations and at the end; it gives up when the
share of skipped iterations reaches ``cfg.model.stabilize``, and
``train_with_retries`` restarts it from the last checkpoint.

A step reads the device once: the loss, the gradients' finiteness and every
logged scalar come back in one small tensor. The JAX package's chained
K-step dispatch, packed state and flat optimizer are forms for its compiler
and are not ported.

Its device mesh is: under a process group (``parallel.dist``) each rank
holds its rows of the global batch, its losses are its shares of the global
batch's, the gradients are summed over the ranks in flat buckets after the
backward, and the small tensor is summed over the ranks in one collective
before its read. So every rank sees the global step's loss and gradients and
takes the same guard decision, clip and update, as one process at the
global batch would. Rank 0 alone writes checkpoints and the log.
"""
from __future__ import annotations

import logging
import math
import time
from collections import deque
from typing import Callable, Dict, NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..data.batch import Batch
from ..models.backbones.layers import update_running_stats
from ..parallel import dist
from .checkpoint import CheckpointManager
from .events import EventStorage
from .solver import build_optimizer, clip_by_global_norm, host_lr, set_lr

logger = logging.getLogger(__name__)

TOLERANCE = 4.0
GAMMA = 0.02
WARMUP_STEPS = 10  # steps of an attempt left out of its time sums (kernel builds, cuDNN's first choices)
LOSS_KEEP = 10  # total losses kept of an attempt's first and of its last steps


class StepOut(NamedTuple):
    total: float
    losses: Dict[str, float]
    metrics: Dict[str, float]
    diverging: bool  # the update was skipped
    rolling: float  # the rolling loss mean after this step


class StepTally:
    """What ``fit`` keeps of its steps: counts, the host-clock sums of
    ``time`` and ``data_time`` over the steps after the first
    ``WARMUP_STEPS``, and the total losses of the first and the last
    ``LOSS_KEEP`` steps."""

    def __init__(self):
        self.first_iteration: Optional[int] = None
        self.steps = self.skipped = self.nonfinite = self.timed = 0
        self.time = self.data_time = 0.0
        self.first_losses, self.last_losses = [], deque(maxlen=LOSS_KEEP)

    def add(self, iteration: int, total_loss: float, skipped: bool, t_step: float, t_data: float) -> None:
        if self.first_iteration is None:
            self.first_iteration = iteration
        self.steps += 1
        self.skipped += skipped
        self.nonfinite += not math.isfinite(total_loss)
        if self.steps > WARMUP_STEPS:
            self.timed += 1
            self.time += t_step
            self.data_time += t_data
        if len(self.first_losses) < LOSS_KEEP:
            self.first_losses.append(total_loss)
        self.last_losses.append(total_loss)


class Trainer:
    def __init__(self, cfg, model, device: Optional[torch.device] = None):
        """``model`` must already be on ``device`` (default: the first CUDA
        device; pass ``torch.device("cpu")`` to run on the CPU)."""
        self.cfg = cfg
        self.device = torch.device("cuda", 0) if device is None else torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "the trainer runs on a CUDA device; none is available (pass device='cpu' to use the CPU)")
        self.model = model.train()
        self.optimizer = build_optimizer(cfg, model)
        self.params = [p for g in self.optimizer.param_groups for p in g["params"]]
        # every parameter holds a gradient, zero where the loss does not reach
        # it (the priors, a projection whose output is unused), so that weight
        # decay acts on it as it does in the JAX package
        for p in self.params:
            p.grad = torch.zeros_like(p)
        self.freeze_bn = cfg.model.freeze_bn or not cfg.model.use_bn
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.iteration = 0  # steps taken, skipped ones included
        self.count = 0  # updates applied: the schedule's clock
        self.stab = math.nan  # rolling loss mean; NaN = not yet initialised
        self.tally = StepTally()  # of the steps ``fit`` took

    # ------------------------------------------------------------------
    def train_step(self, batch: Batch, noise=None) -> StepOut:
        """One step on ``batch`` (already on the device). ``noise`` replaces
        the trainer's generator as the subsamplers' source (see
        ``RCNN3D.forward``)."""
        self.optimizer.zero_grad(set_to_none=False)
        with record_function("forward"):
            losses, metrics = self.model(batch, self.generator if noise is None else noise)
            total = sum(losses.values())
        with record_function("backward"):
            total.backward()
            grads = [p.grad for p in self.params]
            dist.allreduce_grads(grads)

        with record_function("guard"):
            grads_finite = torch.isfinite(torch.stack(torch._foreach_norm(grads, float("inf")))).all()
            lkeys, mkeys = sorted(losses), sorted(metrics)
            packed = dist.all_sum(torch.stack(
                [total.detach().float(), grads_finite.float()]
                + [losses[k].detach().float() for k in lkeys]
                + [metrics[k].detach().float() for k in mkeys]
            )).tolist()  # the step's one read of the device; the ranks' shares summed
        # the summed gradients are the same on every rank, so is their finiteness
        total_f, finite = packed[0], packed[1] > dist.world_size() - 0.5

        uninit = math.isnan(self.stab)
        loss_ok = math.isfinite(total_f) and total_f <= (math.inf if uninit else self.stab) * TOLERANCE
        diverging = not (finite and loss_ok)
        # rolling mean: initialised to twice the first loss, then an EMA over
        # the accepted steps
        base = (total_f * 2.0 if math.isfinite(total_f) else 1e6) if uninit else self.stab
        if diverging and self.cfg.model.stabilize > 0:
            self.stab = base
        else:
            self.stab = base * (1 - GAMMA) + total_f * GAMMA

        with record_function("update"):
            if not diverging:
                set_lr(self.optimizer, host_lr(self.cfg.solver, self.count))
                if self.cfg.solver.clip_gradients > 0:
                    clip_by_global_norm(grads, self.cfg.solver.clip_gradients)
                self.optimizer.step()
                self.count += 1
            # running statistics follow only an accepted step, and never when frozen
            update_running_stats(self.model, discard=diverging or self.freeze_bn)
        self.iteration += 1
        n = 2 + len(lkeys)
        return StepOut(
            total=total_f, losses=dict(zip(lkeys, packed[2:n])), metrics=dict(zip(mkeys, packed[n:])),
            diverging=diverging, rolling=self.stab,
        )

    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        return {
            "model": self.model.state_dict(), "optimizer": self.optimizer.state_dict(),
            "iteration": self.iteration, "count": self.count, "stab": self.stab,
            "generator": self.generator.get_state(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.iteration, self.count, self.stab = state["iteration"], state["count"], state["stab"]
        self.generator.set_state(state["generator"].cpu())

    # ------------------------------------------------------------------
    def fit(self, train_loader, start_iter: int = 0, storage: Optional[EventStorage] = None,
            eval_fn: Optional[Callable] = None) -> bool:
        """One training attempt over ``train_loader`` (an iterable of
        batches) up to ``cfg.solver.max_iter``. Returns True on success, or
        False when the guard demands a restart: the share of skipped
        iterations reached ``cfg.model.stabilize`` past half a checkpoint
        period. Checkpoints are withheld while the run may be diverging.
        ``eval_fn(trainer, iteration, storage)`` runs with the model in eval
        mode every ``cfg.test.eval_period`` iterations (when above 0) and
        after the last one, never right after a skipped step. Each step logs
        ``time`` (seconds, host clock; the step ends with its read of the
        device) and ``data_time`` (of it, waiting for the loader)."""
        cfg = self.cfg
        max_iter = cfg.solver.max_iter
        storage = storage or EventStorage(cfg.output_dir)
        ckpt = CheckpointManager(cfg.output_dir, cfg.solver.checkpoint_period, max_iter)
        self.stab = math.nan  # a fresh attempt restarts the rolling mean
        success = explode = 0
        data_iter = iter(train_loader)
        for iteration in range(start_iter, max_iter):
            self.iteration = iteration
            lr = host_lr(cfg.solver, self.count)
            t0 = time.perf_counter()
            batch = next(data_iter).to(self.device)
            t_data = time.perf_counter() - t0
            out = self.train_step(batch)
            skipped = out.diverging and cfg.model.stabilize > 0
            if skipped:
                explode += 1
                logger.warning("Skipping gradient update: loss %.2f vs rolling mean %.2f", out.total, out.rolling)
            else:
                success += 1
            storage.iter = iteration
            t_step = time.perf_counter() - t0
            self.tally.add(iteration, out.total, skipped, t_step, t_data)
            storage.put_scalars(total_loss=out.total, lr=lr, time=t_step, data_time=t_data,
                                **out.losses, **out.metrics)
            if (iteration + 1) % storage.window == 0 or iteration == max_iter - 1:
                storage.flush(max_iter)

            share = explode / (success + explode)
            past_half = success + explode > cfg.solver.checkpoint_period * 0.5
            if cfg.model.stabilize > 0 and share >= cfg.model.stabilize and past_half:
                logger.warning("!! Restarting training at %d iters. Exploding loss %d%% of iters !!",
                               iteration, int(100 * share))
                return False
            if skipped:
                continue
            last = iteration == max_iter - 1
            period = cfg.test.eval_period
            if eval_fn is not None and (last or (period > 0 and (iteration + 1) % period == 0)):
                self.model.eval()
                eval_fn(self, iteration + 1, storage)
                self.model.train()
            if cfg.model.stabilize <= 0 or share < 0.5 * cfg.model.stabilize:
                if (iteration + 1) % ckpt.period == 0 or last:
                    ckpt.step(iteration, self.state_dict())
        return True


def train_with_retries(cfg, build_fn: Callable, train_loader_fn: Callable, eval_fn: Optional[Callable] = None,
                       storage: Optional[EventStorage] = None):
    """The retry loop: ``build_fn(resume)`` -> (trainer, start_iter), resumed
    from the last checkpoint on every attempt after the first; up to
    ``cfg.max_training_attempts`` attempts. ``eval_fn`` goes to ``fit``."""
    storage = storage or EventStorage(cfg.output_dir)
    for attempt in range(cfg.max_training_attempts):
        trainer, start_iter = build_fn(resume=attempt > 0)
        if trainer.fit(train_loader_fn(), start_iter=start_iter, storage=storage, eval_fn=eval_fn):
            return trainer
        logger.warning("training attempt %d failed; retrying from checkpoint", attempt + 1)
    raise RuntimeError(f"training failed after {cfg.max_training_attempts} attempts")
