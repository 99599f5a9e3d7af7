"""The port's whole training slice vs the JAX package, f32 on the CPU.

One seeded JAX model; its variables go through the weight bridge into the
port. One numpy batch with ground truth flows through both:

* the training forward against ``RCNN3D.apply(train=True)``: every loss and
  every metric, key by key;
* the gradient of the summed losses against the JAX step's own
  ``jax.value_and_grad``, leaf by leaf (the JAX gradient tree goes through
  the same bridge as the weights);
* one ``Trainer.train_step`` against the JAX ``Trainer._step_body``: updated
  parameters, running BatchNorm statistics and the stabiliser's rolling mean;
  and a step with a non-finite loss, which both skip.

Sampling noise (route two): the configuration saturates both subsamplers
and switches the proposal NMS off (``_torch_port.TRAIN_OVERRIDES``), so the
selected anchors and ROIs are the same sets whatever the noise, and the
losses, masked sums and means, do not depend on their order. The JAX side
draws from its flax ``sampling`` key, the port from a ``torch.Generator``.
The samplers themselves are held against JAX with shared noise in
``test_torch_matcher.py``.

The JAX side pools with ``multilevel_roi_align_windowed(window=WINDOW_Y)``
and its autodiff; the port with its plain ROIAlign forward and backward.
Inputs keep clear of the clamp bounds (deltas far below SCALE_CLAMP, dims
logits far below 5, uncertainty above 0.01), where ``jnp.clip`` and
``torch.clamp`` define different gradients.

Tolerances. In training mode every ConvBN normalises with the statistics of
a 2-image batch on a 64x96 canvas (12 values a channel at the coarsest
level), and XLA's CPU reductions and its space-to-depth stem sum in another
order than PyTorch's, so the two f32 trunks differ by up to 1e-3 of the
features' scale (the port agrees with its own f64 run to 3e-5). Losses are
held to 2e-3 relative. The gradient of a randomly initialised 34-layer
BatchNorm network magnifies such differences about a thousandfold on its way
back (a 1e-6 relative change of the port's own input moves its gradient
leaves by 0.5% in the median), and an L1 loss flips the sign of a residual
that is nearly zero, so leaf by leaf the two gradients are held to a cosine
of 0.9 and a relative L2 distance of 0.5, and all leaves together to a cosine
of 0.99: enough to catch a missing detach, a wrong normaliser or a
misplaced leaf, not rounding. What the step then does with a gradient is held
tightly on each side against the update rule written out in the test, and the
heads' gradients are held tightly on identical features in
``test_torch_train_heads.py``.
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


def _port_state(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def run():
    from threedod.data.batch import normalize_image as jax_normalize
    from threedod.train.trainer import Trainer as JaxTrainer, TrainState, init_stab

    from threedod_torch.train.trainer import Trainer
    from threedod_torch.utils.convert_weights import from_jax_variables

    jcfg, pcfg = tp.configs(**tp.TRAIN_OVERRIDES)
    img, image_hw, K, ratio = tp.inputs()
    gt = tp.ground_truth()
    # images go in normalised, as f32, so that the step with a NaN pixel
    # below reuses the compiled JAX step
    img = np.array(jax_normalize(jnp.asarray(img), jcfg.model, jnp.asarray(image_hw)), np.float32)
    jb = tp.jax_train_batch(img, image_hw, K, ratio, gt)
    tb = tp.torch_train_batch(img, image_hw, K, ratio, gt)
    jmodel, variables = tp.jax_model(jcfg)
    base_key = jax.random.PRNGKey(jcfg.seed)

    # ---- JAX: the trainer's own step, compiled once ------------------------
    # Its optimizer is wrapped by a pass-through stage whose state keeps the
    # gradients it was handed, so the step's own jax.value_and_grad result
    # comes out with the new state and the backward is traced once.
    jtrainer = JaxTrainer(jcfg, jmodel)
    real = jtrainer.ensure_optimizer(variables["params"])
    keep = optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params), lambda updates, state, params=None: (updates, updates))
    jtrainer.optimizer = optimizer = optax.chain(keep, real)
    jax_step = jax.jit(jtrainer._step_body())

    state = TrainState(
        params=variables["params"], batch_stats=variables["batch_stats"],
        opt_state=optimizer.init(variables["params"]), step=jnp.zeros((), jnp.int32), stab=init_stab())
    jstate, out = jax.device_get(jax_step(state, jb, base_key))
    jgrads, jlosses, jmetrics, jdiv = jstate.opt_state[0], out.losses, out.metrics, out.diverging
    # a non-finite loss: the same step on an image with a NaN pixel
    bad_img = img.copy()
    bad_img[0, 3, 3, 0] = np.nan
    jstate_bad, out_b = jax.device_get(jax_step(state, jb.replace(image=jnp.asarray(bad_img)), base_key))
    jdiv_bad = out_b.diverging

    # ---- port -------------------------------------------------------------
    noise = torch.Generator().manual_seed(0)
    pmodel = tp.port_model(pcfg, variables).train()
    losses, metrics = pmodel(tb, noise)
    sum(losses.values()).backward()
    pgrads = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy().copy()
              for k, p in pmodel.named_parameters()}

    trainer = Trainer(pcfg, tp.port_model(pcfg, variables), torch.device("cpu"))
    before = _port_state(trainer.model)
    out = trainer.train_step(tb, noise)
    after = _port_state(trainer.model)

    bad = Trainer(pcfg, tp.port_model(pcfg, variables), torch.device("cpu"))
    out_bad = bad.train_step(tb._replace(image=torch.from_numpy(bad_img)), noise)

    as_np = lambda t: jax.tree_util.tree_map(lambda a: np.array(a, np.float32), t)  # noqa: E731
    return dict(
        pcfg=pcfg, jlosses=jlosses, jmetrics=jmetrics, jdiv=bool(jdiv),
        losses={k: v.item() for k, v in losses.items()}, metrics={k: float(v) for k, v in metrics.items()},
        jgrads=from_jax_variables({"params": as_np(jgrads)}, pcfg), pgrads=pgrads,
        jafter=from_jax_variables({"params": as_np(jstate.params), "batch_stats": as_np(jstate.batch_stats)}, pcfg),
        jstab=float(jstate.stab), before=before, after=after, out=out, trainer=trainer,
        jbad=from_jax_variables(
            {"params": as_np(jstate_bad.params), "batch_stats": as_np(jstate_bad.batch_stats)}, pcfg),
        jdiv_bad=bool(jdiv_bad), jstab_bad=float(jstate_bad.stab), out_bad=out_bad, bad=bad,
    )


def test_loss_keys(run):
    assert set(run["losses"]) == set(run["jlosses"]) == {
        "BoxHead/loss_cls", "BoxHead/loss_box_reg", "Cube/uncert", "Cube/loss_dims", "Cube/loss_xy",
        "Cube/loss_z", "Cube/loss_pose", "Cube/loss_joint", "rpn/cls", "rpn/loc"}
    assert set(run["metrics"]) == set(run["jmetrics"])


def test_losses(run):
    for k, ref in run["jlosses"].items():
        assert np.isfinite(ref) and ref > 0, k
        np.testing.assert_allclose(run["losses"][k], ref, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


def test_metrics(run):
    for k, ref in run["jmetrics"].items():
        np.testing.assert_allclose(run["metrics"][k], ref, rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    assert run["metrics"]["roi/num_fg"] > 0 and run["metrics"]["roi/num_bg"] > 0
    assert run["metrics"]["rpn/num_pos_anchors"] > 0


def test_gradients_leaf_by_leaf(run):
    jg, pg = run["jgrads"], run["pgrads"]
    assert set(jg) == set(pg)
    dot = nj = npp = 0.0
    nonzero = 0
    for name, ref in jg.items():
        ref = ref.numpy().astype(np.float64).ravel()
        got = pg[name].astype(np.float64).ravel()
        assert got.shape == ref.shape, name
        if np.abs(ref).max() == 0:  # priors, unused outer projections
            assert np.abs(got).max() == 0, name
            continue
        nonzero += 1
        cos = ref @ got / (np.linalg.norm(ref) * np.linalg.norm(got))
        dist = np.linalg.norm(got - ref) / np.linalg.norm(ref)
        assert cos >= LEAF_COS and dist <= LEAF_L2, (name, cos, dist)
        dot, nj, npp = dot + ref @ got, nj + ref @ ref, npp + got @ got
    assert nonzero >= 150
    assert dot / np.sqrt(nj * npp) >= ALL_COS


def _expected_update(cfg, name, old, grad):
    """One SGD step from zero momentum: -lr * (grad + decay * old), no decay
    on BatchNorm weight and bias and on the priors."""
    lr = cfg.solver.base_lr * cfg.solver.warmup_factor  # warm-up at count 0
    norm = old.ndim == 1 and (".bn" in name or name.rsplit(".", 2)[-2].isdigit())
    wd = 0.0 if norm or "priors" in name else cfg.solver.weight_decay
    return -lr * (grad + wd * old)


def test_train_step_matches(run):
    """Both steps apply the same rule to their own gradient (tight), and end
    within the gradients' tolerance of each other; running statistics and the
    rolling loss mean agree as the losses do."""
    assert not run["jdiv"] and not run["out"].diverging
    cfg = run["pcfg"]
    params = set(run["pgrads"])
    for name, ref in run["jafter"].items():
        ref = ref.numpy()
        got, old = run["after"][name], run["before"][name]
        if name in params:
            for new, grad in ((ref, run["jgrads"][name].numpy()), (got, run["pgrads"][name])):
                want = _expected_update(cfg, name, old, grad)
                # 1e-3 of the update, plus the f32 rounding of old + update
                atol = 1e-3 * np.abs(want).max() + 2e-7 * np.abs(old).max() + 1e-12
                np.testing.assert_allclose(new - old, want, rtol=0, atol=atol, err_msg=name)
        else:  # running_mean, running_var: 0.9 * old + 0.1 * batch
            assert np.abs(ref - old).max() > 0, name
            np.testing.assert_allclose(got, ref, rtol=0, atol=LOSS_RTOL * np.abs(ref).max(), err_msg=name)
    np.testing.assert_allclose(run["out"].rolling, run["jstab"], rtol=LOSS_RTOL)
    assert run["trainer"].count == 1 and run["trainer"].iteration == 1


def test_nonfinite_loss_skips_update(run):
    assert run["jdiv_bad"] and run["out_bad"].diverging
    state = _port_state(run["bad"].model)
    for name, ref in run["jbad"].items():  # JAX left everything as it was; so did the port
        np.testing.assert_array_equal(ref.numpy(), run["before"][name], err_msg=name)
        np.testing.assert_array_equal(state[name], run["before"][name], err_msg=name)
    assert run["bad"].count == 0 and run["bad"].iteration == 1
    assert not run["bad"].optimizer.state  # no momentum was written
    np.testing.assert_allclose(run["out_bad"].rolling, run["jstab_bad"], rtol=1e-6)


def test_trainer_with_generator_unsaturated():
    """The port alone, with its own generator and samplers that must choose
    (32 of ~1500 anchors, 32 of 64 ROIs): finite losses, a step taken, and
    the second step drawing other noise than the first."""
    from threedod_torch.data.batch import synthetic_train_batch
    from threedod_torch.train import build_trainer

    _, pcfg = tp.configs(**{
        "model.rpn.pre_nms_topk_train": 200, "model.rpn.post_nms_topk_train": 60,
        "model.rpn.batch_size_per_image": 32, "shapes.roi_batch": 32, "shapes.max_gt": 8})
    trainer = build_trainer(pcfg, torch.device("cpu"), seed=0)
    batch = synthetic_train_batch(pcfg, 2, seed=3)
    assert batch.gt.valid.sum(1).tolist() == [6, 6] and batch.gt.boxes2d.shape == (2, 8, 4)
    state = trainer.generator.get_state()
    outs = [trainer.train_step(batch) for _ in range(2)]
    assert not torch.equal(trainer.generator.get_state(), state)
    for out in outs:
        assert not out.diverging and np.isfinite(out.total) and len(out.losses) == 10
        assert all(np.isfinite(v) for v in out.losses.values())
    assert trainer.count == 2
    assert outs[0].metrics["roi/num_fg"] + outs[0].metrics["roi/num_bg"] == 32


def test_train_entry_refuses_without_cuda():
    from threedod_torch import train

    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--device", "cpu", "--steps", "1"])
