"""The port's data parallelism over processes (``threedod_torch/parallel/
dist.py``) at the level of its reductions, draws and loader, on the CPU: 2
gloo ranks, each holding half of a global batch, against one process at the
whole batch (one spawn of 2 ranks per fixture, ``_torch_ddp.on_ranks``).

* ``all_sum``: the sum over ranks, whose backward sums the upstream
  gradients over ranks;
* the masked cross-entropy and ``safely_reduce_losses`` (this rank's share:
  its rows' sum over the global count; the shares add up to one process's
  mean), ``conv_bn`` and ``batch_norm`` in training mode (the global batch's
  statistics): values, the gradients of the inputs and, summed over ranks,
  of the parameters, and the batch statistics, f32, within 1e-6 of each
  array's largest entry;
* the ROI sampler's and the RANSAC fit's draws from a generator seeded alike
  on every rank: each rank's rows of the result are one process's rows,
  exactly (the draw is the global batch's, sliced);
* ``TrainLoader`` on Base_Synth's fixture: each rank maps its rows of the
  global batch, and the other rows' draws of scale and flip are still made,
  so the ranks' batches are one process's rows, bit for bit;
* a group of one rank launches the collectives and computes the
  one-process training step bit for bit;
* ``spawn`` returns when every rank has ended (all at once included), raises
  when one fails, and kills the ranks that outlive its time limit;
* without a process group every helper is the identity (the very object, or
  the expressions the one-process step had) and launches no collective:
  ``torch.distributed``'s collectives are replaced by functions that raise
  while a training step of the small model runs, and the step equals the
  plain step written out here (forward, the sum of the losses, backward,
  the SGD update, the running statistics), bit for bit.
"""
from __future__ import annotations

import pathlib

import numpy as np
import pytest
import torch

import _torch_ddp as td
import _torch_port as tp

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-6


def _prim_job():
    rng = np.random.RandomState(0)
    n, c = 12, 7
    return dict(
        x=rng.randn(4, 5).astype(np.float32), x_weights=rng.randn(2, 5).astype(np.float32),
        logits=rng.randn(n, c).astype(np.float32), labels=rng.randint(0, c, n).astype(np.int64),
        mask=rng.rand(n) > 0.3, values=rng.randn(n).astype(np.float32),
        image=rng.randn(4, 4, 6, 8).astype(np.float32), image_weights=rng.randn(4, 6, 6, 8).astype(np.float32),
        features=(rng.randn(4, 6, 5, 7) * 2 + 1).astype(np.float32),
        features_weights=rng.randn(4, 6, 5, 7).astype(np.float32),
    )


@pytest.fixture(scope="module")
def prims():
    job = _prim_job()
    return job, td.primitives(job), td.on_ranks("primitives", job)


def test_all_sum_and_its_backward(prims):
    job, _, ranks = prims
    for out in ranks:
        y, grad = out["all_sum"]
        np.testing.assert_allclose(y, job["x"][:2] + job["x"][2:], rtol=TOL)
        np.testing.assert_allclose(grad, job["x_weights"], rtol=TOL)


@pytest.mark.parametrize("name", ["cross_entropy", "safely_reduce_losses"])
def test_masked_means_are_shares_of_the_global_mean(prims, name):
    _, one, ranks = prims
    value, grad = one[name]
    tp.close(sum(r[name][0] for r in ranks), value, TOL)
    tp.close(np.concatenate([r[name][1] for r in ranks]), grad, TOL)


@pytest.mark.parametrize("name", ["conv_bn", "batch_norm"])
def test_batchnorm_uses_the_global_batch(prims, name):
    _, one, ranks = prims
    y, grad, params, stats = one[name]
    tp.close(np.concatenate([r[name][0] for r in ranks]), y, TOL)
    tp.close(np.concatenate([r[name][1] for r in ranks]), grad, TOL)
    for r in ranks:
        for got, want in zip(r[name][2] + r[name][3], params + stats):
            if np.abs(want).max() > 0:
                tp.close(got, want, TOL)
            else:  # batch_norm reaches no conv weight
                assert np.abs(got).max() == 0


def test_collectives_counted(prims):
    _, one, ranks = prims
    assert one["collectives"] == 0
    # all_sum: 1 forward + 1 backward; each mean: its count; each norm: 1 forward, 1 backward, 1 gradient bucket
    assert [r["collectives"] for r in ranks] == [10, 10]


@pytest.fixture(scope="module")
def draws():
    _, pcfg = tp.configs(**{"shapes.roi_batch": 16, "shapes.max_gt": 4})
    rng = np.random.RandomState(1)
    xy = rng.uniform(0, 60, (4, 40, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 30, (4, 40, 2))], -1).astype(np.float32)
    g1, g2 = tp.ground_truth(11), tp.ground_truth(12)
    gt = tp.torch_train_batch(*tp.inputs(), {k: np.concatenate([g1[k], g2[k]]) for k in g1}).gt
    from threedod_torch.models.rpn import Proposals

    job = dict(cfg=pcfg, gt=gt,
               proposals=tuple(Proposals(torch.from_numpy(boxes), torch.from_numpy(rng.randn(4, 40).astype(np.float32)),
                                         torch.ones(4, 40, dtype=torch.bool))),
               points=torch.from_numpy(np.concatenate(
                   [rng.uniform(-2, 2, (4, 300, 2)), rng.uniform(0, 0.3, (4, 300, 1))], -1).astype(np.float32)))
    return td.sampling(job), td.on_ranks("sampling", job)


def test_draws_with_a_batch_axis_are_the_global_draws_rows(draws):
    one, ranks = draws
    for k, v in one["sampled"].items():
        np.testing.assert_array_equal(np.concatenate([r["sampled"][k] for r in ranks]), v, err_msg=k)
    assert one["sampled"]["fg"].sum() > 0 and (~one["sampled"]["valid"]).sum() < one["sampled"]["valid"].size
    np.testing.assert_array_equal(np.concatenate([r["planes"] for r in ranks]), one["planes"])


@pytest.fixture(scope="module")
def loader(tmp_path_factory):
    from threedod_torch import train_net
    from threedod_torch.data.build import get_dataset_dicts

    out = tmp_path_factory.mktemp("loader")
    cfg, _, _ = train_net.setup(str(ROOT / "configs" / "Base_Synth.yaml"), [
        "shapes.canvas_height", "96", "shapes.canvas_width", "128", "input.min_size_train", "[64, 80, 96]",
        "solver.ims_per_batch", "4", "output_dir", str(out)])
    records = get_dataset_dicts(cfg.datasets.train)
    # a record whose size disagrees with its pixels draws a second scale: every other one here
    records = [dict(r, height=r["height"] + 1) if i % 2 else r for i, r in enumerate(records)]
    job = dict(records=records, cfg=cfg, seed=3, load_maps=False, batches=3)
    return td.loader_batches(job), td.on_ranks("loader_batches", job)


def test_train_loader_ranks_map_the_one_process_rows(loader):
    one, ranks = loader
    flat = lambda b: [t for t in (*b[:-3], *b.gt) if t is not None]  # noqa: E731
    for i, want in enumerate(one):
        got = [flat(r[i]) for r in ranks]
        for j, w in enumerate(flat(want)):
            torch.testing.assert_close(torch.cat([g[j] for g in got]), w, rtol=0, atol=0)
    assert len({tuple(b.image_hw[:, 0].tolist()) for b in one}) > 1  # the scales vary


def _small_step_job():
    from threedod_torch.utils.convert_weights import from_jax_variables

    jcfg, pcfg = tp.configs(**tp.TRAIN_OVERRIDES)
    return dict(cfg=pcfg, state=from_jax_variables(tp.init_like_variables(jcfg), pcfg), modes=("train",),
                batch=tp.torch_train_batch(*tp.inputs(), tp.ground_truth()))


def test_a_group_of_one_computes_the_one_process_step():
    """A world of one runs every collective and changes no bit of the step."""
    job = _small_step_job()
    one = td.detector_step(job)["train"]
    (grouped,) = td.on_ranks("detector_step", job, ranks=1)
    grouped = grouped["train"]
    assert grouped["losses"] == one["losses"] and grouped["metrics"] == one["metrics"]
    assert grouped["total"] == one["total"] and grouped["rolling"] == one["rolling"]
    for part in ("grads", "after"):
        for k, v in one[part].items():
            np.testing.assert_array_equal(grouped[part][k], v, err_msg=f"{part} {k}")


def test_without_a_group_nothing_is_launched_and_the_step_is_the_plain_one(monkeypatch):
    import torch.distributed as tdist

    from threedod_torch.models.backbones.layers import update_running_stats
    from threedod_torch.parallel import dist
    from threedod_torch.train.solver import build_optimizer, host_lr, set_lr
    from threedod_torch.train.trainer import Trainer

    def refuse(*args, **kwargs):
        raise AssertionError("a collective was launched without a process group")

    for name in ("all_reduce", "all_gather_object", "broadcast_object_list", "barrier", "all_gather"):
        monkeypatch.setattr(tdist, name, refuse)
    assert not dist.active() and dist.world_size() == 1 and dist.rank() == 0 and dist.is_primary()
    x = torch.randn(3, 4, 5, 6)
    assert dist.all_sum(x) is x and dist.local_rows(x) is x and dist.global_batch(3) == 3
    m, sq = dist.batch_moments(x, (0, 2, 3))
    assert torch.equal(m, x.mean(dim=(0, 2, 3))) and torch.equal(sq, x.square().mean(dim=(0, 2, 3)))

    jcfg, pcfg = tp.configs(**tp.TRAIN_OVERRIDES)
    variables = tp.init_like_variables(jcfg)
    batch = tp.torch_train_batch(*tp.inputs(), tp.ground_truth())
    start = dist.COLLECTIVES
    trainer = Trainer(pcfg, tp.port_model(pcfg, variables), torch.device("cpu"))
    out = trainer.train_step(batch, torch.Generator().manual_seed(0))

    model = tp.port_model(pcfg, variables).train()
    optimizer = build_optimizer(pcfg, model)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    losses, _ = model(batch, torch.Generator().manual_seed(0))
    total = sum(losses.values())
    total.backward()
    set_lr(optimizer, host_lr(pcfg.solver, 0))
    optimizer.step()
    update_running_stats(model)
    assert dist.COLLECTIVES == start
    assert out.total == total.item() and out.losses == {k: v.item() for k, v in losses.items()}
    for k, v in model.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k



def test_spawn_ends_fails_and_times_out():
    import time

    from threedod_torch.parallel import dist

    dist.spawn(td.ends, ["cpu"] * 3, timeout_s=td.RANK_TIMEOUT_S)  # ranks that end together, as they start
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited"):
        dist.spawn(td.ends, ["cpu"] * 2, (0.0, 1), timeout_s=td.RANK_TIMEOUT_S)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        dist.spawn(td.ends, ["cpu"] * 2, (600.0,), timeout_s=5.0)
    assert time.monotonic() - t0 < 60.0  # the sleeping ranks were killed, not waited for
