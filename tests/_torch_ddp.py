"""Shared set-up of the port's data-parallel tests (tests/test_torch_ddp_*.py,
tests/test_torch_dist.py).

A step runs the same function in one process at the global batch and in each
of 2 gloo ranks on the CPU at half of it. The ranks are spawned with
``threedod_torch.parallel.dist.spawn`` (fresh interpreters that meet through
a file in a temporary folder), each with one torch thread and a time limit,
so that a hung rank fails its test instead of holding the suite. This module
imports neither JAX nor the JAX package: the ranks import it.
"""
from __future__ import annotations

import os
import pickle
import tempfile

import numpy as np
import torch

RANKS = 2
RANK_TIMEOUT_S = 150.0


def detector_step(job: dict) -> dict:
    """One ``Trainer.train_step`` of the port's model built from
    ``job["cfg"]`` and ``job["state"]`` on this rank's rows of
    ``job["batch"]``, the noise from the trainer's generator, for each of
    ``job["modes"]``: "train" (every BatchNorm on its batch statistics) or
    "frozen" (the BatchNorms on their running statistics, as in eval).
    -> {mode: the step's losses, metrics and rolling mean, the summed
    gradients and the state after it, as numpy}."""
    from threedod_torch.models.backbones.layers import BatchNorm2d
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.parallel.dist import local_rows
    from threedod_torch.train.trainer import Trainer

    cfg = job["cfg"]
    out = {}
    for mode in job["modes"]:
        model = build_model(cfg)
        model.load_state_dict(job["state"], strict=True)
        trainer = Trainer(cfg, model, torch.device("cpu"))
        if mode == "frozen":
            for m in trainer.model.modules():
                if isinstance(m, BatchNorm2d):
                    m.eval()
        step = trainer.train_step(local_rows(job["batch"]))
        out[mode] = dict(
            total=step.total, losses=step.losses, metrics=step.metrics, rolling=step.rolling,
            diverging=step.diverging, grads={k: p.grad.numpy().copy() for k, p in trainer.model.named_parameters()},
            after={k: v.numpy().copy() for k, v in trainer.model.state_dict().items()},
        )
    return out


class TinyDepth(torch.nn.Module):
    """The port of ``test_depth_train._TinyDepthNet``: a 3x3 conv named
    ``pretrained`` and a 1x1 ``depth_head``, softplus + 0.05."""

    def __init__(self):
        super().__init__()
        self.pretrained = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.depth_head = torch.nn.Conv2d(8, 1, 1)

    def forward(self, x):
        h = torch.nn.functional.relu(self.pretrained(x))
        return torch.nn.functional.softplus(self.depth_head(h))[:, 0] + 0.05


def seeded_vits():
    """Depth-Anything-V2 ``vits`` (f32) with the port's seeded initialisation."""
    from threedod_torch.models.depth.dpt import DepthAnythingV2, init_weights

    model = DepthAnythingV2("vits", dtype=torch.float32)
    init_weights(model, torch.Generator().manual_seed(0))
    return model


def depth_step(job: dict) -> dict:
    """``DepthTrainer.train_step`` on ``job["steps"]`` global batches (each
    (image, depth, valid_mask, flip)) of the model ``job["make"]()``, loaded
    with ``job["state"]`` where given. -> the losses, the last step's summed
    gradients and the parameters after the steps."""
    from threedod_torch.train.depth import DepthTrainer

    model = job["make"]()
    if job.get("state") is not None:
        model.load_state_dict(job["state"], strict=True)
    trainer = DepthTrainer(model, torch.device("cpu"), **job["trainer"])
    losses = [trainer.train_step(*step).item() for step in job["steps"]]
    return dict(losses=losses, grads={k: p.grad.numpy().copy() for k, p in trainer.model.named_parameters()},
                after={k: v.numpy().copy() for k, v in trainer.model.state_dict().items()})


def primitives(job: dict) -> dict:
    """The reductions of ``parallel/dist.py`` and their users on this rank's
    rows of ``job``'s global arrays: for each of ``all_sum`` (under a group
    only), the masked
    cross-entropy, ``safely_reduce_losses``, ``conv_bn`` and ``batch_norm``,
    the value (a loss share, or this rank's rows of the output) and the
    gradient of sum(output * weights) with respect to the input rows (and,
    summed over the ranks, to the conv and norm parameters); the BatchNorms'
    batch statistics; and the collectives launched."""
    from threedod_torch.models.backbones.layers import BatchNorm2d, conv_bn, batch_norm, conv_layer
    from threedod_torch.ops.losses import cross_entropy, safely_reduce_losses
    from threedod_torch.parallel import dist

    def leaf(name):
        return torch.from_numpy(dist.local_rows(job[name])).clone().requires_grad_(True)

    start = dist.COLLECTIVES
    out = {}
    if dist.active():  # every rank backpropagates the replicated sum over the world size
        x = leaf("x")
        y = dist.all_sum(x)
        ((y * torch.from_numpy(job["x_weights"])).sum() / dist.world_size()).backward()
        out["all_sum"] = (y.detach().numpy(), x.grad.numpy())

    logits = leaf("logits")
    loss = cross_entropy(logits, torch.from_numpy(dist.local_rows(job["labels"])),
                         torch.from_numpy(dist.local_rows(job["mask"])))
    loss.backward()
    out["cross_entropy"] = (loss.detach().numpy(), logits.grad.numpy())

    values = leaf("values")
    loss = safely_reduce_losses(values * 1.0, torch.from_numpy(dist.local_rows(job["mask"])))
    loss.backward()
    out["safely_reduce_losses"] = (loss.detach().numpy(), values.grad.numpy())

    torch.manual_seed(0)
    conv, bn = conv_layer(4, 6, 3), BatchNorm2d(6)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.uniform_(-0.5, 0.5)
    for name, fn, inp in (("conv_bn", lambda t: conv_bn(t, conv, bn), "image"),
                          ("batch_norm", lambda t: batch_norm(t, bn), "features")):
        t = leaf(inp)
        for p in (conv.weight, bn.weight, bn.bias):
            p.grad = None
        y = fn(t)
        (y * torch.from_numpy(dist.local_rows(job[f"{inp}_weights"]))).sum().backward()
        params = [p.grad if p.grad is not None else torch.zeros_like(p) for p in (conv.weight, bn.weight, bn.bias)]
        dist.allreduce_grads(params)
        out[name] = (y.detach().numpy(), t.grad.numpy(), [p.numpy() for p in params],
                     [s.numpy() for s in bn.batch_stats])
    out["collectives"] = dist.COLLECTIVES - start
    return out


def sampling(job: dict) -> dict:
    """This rank's rows of two draws with a batch axis made from a generator
    seeded alike on every rank: ``ROIHeads3D.label_and_sample``'s (its
    sampled slots) and the weak heads' RANSAC hypotheses (the planes
    ``fit_plane_ransac`` fits with them)."""
    from threedod_torch.geometry.plane import fit_plane_ransac
    from threedod_torch.models.roi_heads3d import ROIHeads3D
    from threedod_torch.models.rpn import Proposals
    from threedod_torch.models.weak_heads import ransac_hypotheses
    from threedod_torch.parallel.dist import local_rows

    heads = ROIHeads3D(job["cfg"], 8)
    sampled = heads.label_and_sample(local_rows(Proposals(*job["proposals"])), local_rows(job["gt"]),
                                     torch.Generator().manual_seed(5))
    points = local_rows(job["points"])
    eq, _ = fit_plane_ransac(points, ransac_hypotheses(torch.Generator().manual_seed(6), *points.shape[:2]))
    return dict(sampled={k: v.numpy() for k, v in sampled._asdict().items()}, planes=eq.numpy())


def loader_batches(job: dict) -> list:
    """This rank's first batches of a ``TrainLoader`` over ``job["records"]``."""
    from threedod_torch.data.build import TrainLoader

    loader = TrainLoader(job["records"], job["cfg"], seed=job["seed"], load_maps=job["load_maps"])
    return [loader.next_batch() for _ in range(job["batches"])]


def depth_steps(jobs: dict) -> dict:
    """``depth_step`` of each job: {name: result}."""
    return {name: depth_step(job) for name, job in jobs.items()}


def ends(seconds: float = 0.0, fail_rank: int = -1) -> None:
    """A rank that sleeps ``seconds`` and ends, or raises on ``fail_rank``."""
    import time

    from threedod_torch.parallel import dist

    if dist.rank() == fail_rank:
        raise ValueError("this rank fails")
    time.sleep(seconds)


def rank_main(fn_name: str, job_path: str, out_prefix: str) -> None:
    """One rank: ``fn_name``'s function of this module on the pickled job;
    its result is pickled to ``out_prefix``.<rank>."""
    from threedod_torch.parallel import dist

    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    out = globals()[fn_name](job)
    with open(f"{out_prefix}.{dist.rank()}", "wb") as f:
        pickle.dump(out, f)


def on_ranks(fn_name: str, job: dict, ranks: int = RANKS) -> list:
    """``fn_name``'s function on ``job`` in ``ranks`` spawned gloo ranks on
    the CPU; -> each rank's result, in rank order."""
    from threedod_torch.parallel import dist

    with tempfile.TemporaryDirectory(prefix="torch_ddp_") as folder:
        job_path, prefix = os.path.join(folder, "job.pkl"), os.path.join(folder, "out")
        with open(job_path, "wb") as f:
            pickle.dump(job, f)
        dist.spawn(rank_main, ["cpu"] * ranks, (fn_name, job_path, prefix), timeout_s=RANK_TIMEOUT_S)
        results = []
        for r in range(ranks):
            with open(f"{prefix}.{r}", "rb") as f:
                results.append(pickle.load(f))
    return results


def close_to_largest(got, want, tol, what=""):
    """Each array of ``got`` within ``tol`` x the largest |entry| of its
    counterpart in ``want`` (dicts of arrays with the same keys)."""
    assert set(got) == set(want), what
    for k, ref in want.items():
        ref = np.asarray(ref, np.float64)
        err = np.abs(np.asarray(got[k], np.float64) - ref).max() if ref.size else 0.0
        assert err <= tol * np.abs(ref).max() + 1e-30, f"{what} {k}: {err:.3e} > {tol} x {np.abs(ref).max():.3e}"
