"""The port's depth fine-tuning (``threedod_torch/train/depth.py``,
``threedod_torch/train_depth.py``) vs the JAX package's
(``threedod/train/depth.py``, ``tools/train_depth.py``), on the CPU. Inputs
and weights are made with numpy from a seed and handed to both.

* ``silog_loss``, ``eval_depth`` and the poly LR against the JAX functions:
  the loss to 1e-6 relative (f32 means of 1024 pixels; measured 1.0e-7), the
  LR to 1e-6 of the base (the JAX schedule runs in f32, the port's in f64;
  measured 8.5e-8), the metrics to atol 1e-5 (means of up to 576 ratios of
  order 1 to 10; measured 1.9e-6);
* the two-group AdamW against ``build_depth_optimizer`` (optax) over 3 steps
  of fixed gradients at LR 1e-2 (head 1e-1), with a parameter whose gradient
  is zero (weight decay still acts on it): atol 3e-6 on parameters of order
  1. optax forms the bias correction 1 - 0.999^t in f32, where 0.999 rounds
  to 0.99900001 (1.3e-5 off in 1 - b2, 6.4e-6 in the step), torch in f64:
  three head steps of 0.1 part by up to 1.9e-6 (measured 1.7e-6; at the
  tool's LR of 5e-6 this is 1e-10);
* Depth-Anything-V2 ``vits`` at 28x42 (a 2x3 patch grid, so the position
  embedding goes through the bicubic resize): the loss and the gradient of
  every parameter against ``jax.value_and_grad`` in one ``jax.jit``; the
  loss to 1e-6 relative (measured 7.1e-8) and each gradient to 1e-4 of its
  largest entry (f32 sums in other orders through 12 blocks, the head and
  back; measured 2.9e-6), and every parameter gets a gradient, non-zero
  where the JAX one is;
* three ``train_step``s against the JAX ``DepthTrainer.make_train_step`` on
  the JAX test's two-part net (``tests/test_depth_train.py``), each JAX key's
  flip handed to the port, depths outside the range and a random mask: the
  losses to 1e-6 relative (measured 2.7e-7) and the parameters to atol 1e-6
  (measured 5.4e-7, the bias correction above at LR 3e-2);
* ``evaluate`` with depth maps of another size than the prediction (the
  align-corners resize) and an image under ``MIN_VALID_PIXELS``: atol 1e-5
  (measured 2.7e-7);
* ``fit`` writes one ``latest.pt`` that loads strictly;
* the port's datasets give the tool's batches exactly;
* ``--pretrained-from`` reads the encoder only, needs all of it, and takes
  an official checkpoint's extra ``mask_token``;
* the entry and the trainer refuse to run without a CUDA card.
"""
from __future__ import annotations

import importlib.util
import pathlib

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

import _torch_port  # noqa: F401  (one torch thread per test worker)

import jax
import jax.numpy as jnp

from test_depth_train import _TinyDepthNet
from threedod.models.depth import dpt as jdpt
from threedod.train import depth as jdepth
from threedod_torch import train_depth
from threedod_torch.models.depth import dpt as pdpt
from threedod_torch.train import depth as pdepth
from threedod_torch.utils.convert_weights import depth_from_jax_variables

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


def _depth_batch(seed, b, s, w=None, lo=0.5, hi=25.0):
    """Normalised-looking images (B, s, w, 3), depths in [lo, hi] (some past
    the 20 m range), a random valid mask."""
    rng = np.random.RandomState(seed)
    w = s if w is None else w
    img = rng.randn(b, s, w, 3).astype(np.float32)
    depth = rng.uniform(lo, hi, (b, s, w)).astype(np.float32)
    mask = rng.rand(b, s, w) > 0.2
    return img, depth, mask


# ---------------- loss, metrics, schedule ------------------------------------


def test_silog_matches_jax():
    rng = np.random.RandomState(0)
    pred = rng.uniform(0.0, 10, (4, 16, 16)).astype(np.float32)
    target = rng.uniform(-1.0, 10, (4, 16, 16)).astype(np.float32)  # non-positive pixels hit the clamp
    mask = rng.rand(4, 16, 16) > 0.3
    ref = float(jdepth.silog_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(mask)))
    got = pdepth.silog_loss(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(got.item() - ref) <= 1e-6 * ref
    # an empty mask lands on the floor, as in JAX
    empty = np.zeros_like(mask)
    ref = float(jdepth.silog_loss(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(empty)))
    got = pdepth.silog_loss(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(empty)).item()
    assert got == ref == pytest.approx(1e-6, rel=1e-6)


def test_eval_depth_matches_jax_per_image():
    rng = np.random.RandomState(1)
    pred = rng.uniform(0.5, 10, (3, 24, 24)).astype(np.float32)
    target = rng.uniform(0.5, 10, (3, 24, 24)).astype(np.float32)
    mask = rng.rand(3, 24, 24) > 0.4
    got = pdepth.eval_depth(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(mask))
    assert set(got) == {"d1", "d2", "d3", "abs_rel", "sq_rel", "rmse", "rmse_log", "log10", "silog"}
    for i in range(3):
        ref = jdepth.eval_depth(jnp.asarray(pred[i]), jnp.asarray(target[i]), jnp.asarray(mask[i]))
        for k, v in ref.items():
            assert got[k].shape == (3,)
            assert abs(got[k][i].item() - float(v)) <= 1e-5, k


def test_poly_lr_matches_jax():
    for base, total in ((5e-6, 160), (5e-5, 7), (1e-3, 1)):
        sched_j, sched_p = jdepth.poly_schedule(base, total), pdepth.poly_schedule(base, total)
        for it in (0, 1, total // 2, total - 1, total, total + 3):
            assert abs(sched_p(it) - float(sched_j(jnp.asarray(it)))) <= 1e-6 * base
            assert pdepth.host_poly_lr(base, total, it) == jdepth.host_poly_lr(base, total, it)


# ---------------- optimizer ---------------------------------------------------


class _TwoGroups(nn.Module):
    def __init__(self, params):
        super().__init__()
        for group in ("pretrained", "depth_head"):
            setattr(self, group, nn.ParameterDict({k: nn.Parameter(torch.from_numpy(v.copy()))
                                                   for k, v in params[group].items()}))


def test_optimizer_matches_optax():
    rng = np.random.RandomState(2)
    params = {"pretrained": {"w": rng.randn(4, 5).astype(np.float32)},
              "depth_head": {"w": rng.randn(3).astype(np.float32), "b": rng.randn(2).astype(np.float32)}}
    grads = [{"pretrained": {"w": rng.randn(4, 5).astype(np.float32)},
              "depth_head": {"w": rng.randn(3).astype(np.float32), "b": np.zeros(2, np.float32)}} for _ in range(3)]
    base, total = 1e-2, 5
    tx = jdepth.build_depth_optimizer(params, base, total)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)

    model = _TwoGroups(params)
    opt = pdepth.build_depth_optimizer(model, base)
    assert [g["lr"] for g in opt.param_groups] == [base, 10 * base]
    assert [len(g["params"]) for g in opt.param_groups] == [1, 2]
    for it, g in enumerate(grads):
        pdepth.set_poly_lr(opt, total, it)
        for name, p in model.named_parameters():
            group, leaf = name.split(".")
            p.grad = torch.from_numpy(g[group][leaf])
        opt.step()
    for name, p in model.named_parameters():
        group, leaf = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[group][leaf]), atol=3e-6, err_msg=name)
    assert not np.allclose(model.depth_head["b"].detach().numpy(), params["depth_head"]["b"])  # decayed


# ---------------- the model's loss and gradients -----------------------------


def _vits_params(shape_tree, seed=0):
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if hasattr(val, "items"):
                out[key] = fill(val)
            elif key == "kernel":
                out[key] = (rng.randn(*val.shape) / np.sqrt(np.prod(val.shape[:-1]))).astype(np.float32)
            elif key in ("scale", "ls1_gamma", "ls2_gamma"):
                out[key] = rng.uniform(0.7, 1.3, val.shape).astype(np.float32)
            elif key == "bias":
                out[key] = rng.normal(0, 0.05, val.shape).astype(np.float32)
            else:  # cls_token, pos_embed
                out[key] = rng.normal(0, 0.2, val.shape).astype(np.float32)
        return out

    return fill(shape_tree)


def test_vits_loss_and_gradients_match_jax():
    h, w = 28, 42  # a 2x3 patch grid: the bicubic position path
    jmodel = jdpt.DepthAnythingV2(encoder="vits", dtype=jnp.float32)
    shapes = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x), jnp.zeros((1, h, w, 3)))["params"]
    params = _vits_params(shapes)
    img, depth, mask = _depth_batch(3, 2, h, w, lo=0.5, hi=12.0)

    def loss_fn(p, x, d, m):
        return jdepth.silog_loss(jmodel.apply({"params": p}, x), d, m)

    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(params, img, depth, mask)
    ref = {k: v.numpy() for k, v in depth_from_jax_variables(jax.tree.map(np.asarray, ref_grads)).items()}

    model = pdpt.DepthAnythingV2("vits", dtype=torch.float32)
    model.load_state_dict(depth_from_jax_variables(params), strict=True)
    x = torch.from_numpy(img).permute(0, 3, 1, 2)
    loss = pdepth.silog_loss(model(x), torch.from_numpy(depth), torch.from_numpy(mask))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= 1e-6 * float(ref_loss)
    grads = {name: p.grad for name, p in model.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        assert g is not None, name
        r = ref[name]
        scale = np.abs(r).max()
        assert np.abs(g.numpy() - r).max() <= 1e-4 * scale, name
        assert (scale == 0) == (not g.any()), name
    for name in ("pretrained.pos_embed", "pretrained.cls_token", "pretrained.blocks.0.ls1.gamma",
                 "pretrained.blocks.11.ls2.gamma", "depth_head.resize_layers.0.weight",
                 "depth_head.resize_layers.1.weight", "depth_head.scratch.output_conv2.2.weight"):
        assert grads[name].abs().max() > 0, name


# ---------------- the trainer against the JAX trainer ------------------------


class _TinyPort(nn.Module):
    """The port of ``_TinyDepthNet``: a 3x3 conv named ``pretrained`` and a
    1x1 ``depth_head``, softplus + 0.05."""

    def __init__(self, jparams=None):
        super().__init__()
        self.pretrained = nn.Conv2d(3, 8, 3, padding=1)
        self.depth_head = nn.Conv2d(8, 1, 1)
        if jparams is not None:
            with torch.no_grad():
                for name in ("pretrained", "depth_head"):
                    conv = getattr(self, name)
                    conv.weight.copy_(torch.from_numpy(np.array(jparams[name]["kernel"]).transpose(3, 2, 0, 1)))
                    conv.bias.copy_(torch.from_numpy(np.array(jparams[name]["bias"])))

    def forward(self, x):
        return F.softplus(self.depth_head(F.relu(self.pretrained(x))))[:, 0] + 0.05


@pytest.fixture(scope="module")
def tiny():
    """(JAX trainer, its initial state, the port's net with those weights)."""
    img, _, _ = _depth_batch(4, 8, 16)
    trainer = jdepth.DepthTrainer(_TinyDepthNet(), base_lr=3e-3, total_iters=5, max_depth=20.0)
    state = trainer.init_state(jax.random.PRNGKey(0), jnp.asarray(img))
    return trainer, jax.device_get(state), jax.device_get(state.params)


def _assert_same_params(port, jparams, atol):
    for name in ("pretrained", "depth_head"):
        conv = getattr(port, name)
        np.testing.assert_allclose(conv.weight.detach().numpy(),
                                   np.asarray(jparams[name]["kernel"]).transpose(3, 2, 0, 1), atol=atol)
        np.testing.assert_allclose(conv.bias.detach().numpy(), np.asarray(jparams[name]["bias"]), atol=atol)


def test_three_train_steps_match_jax(tiny):
    trainer, state, params0 = tiny
    img, depth, mask = _depth_batch(5, 8, 16)
    step = trainer.make_train_step()
    port = pdepth.DepthTrainer(_TinyPort(params0), CPU, base_lr=3e-3, total_iters=5, max_depth=20.0)
    key = jax.random.PRNGKey(1)
    flips = []
    jstate = jax.tree.map(jnp.asarray, state)
    for _ in range(3):
        key, k = jax.random.split(key)
        flips.append(bool(jax.random.bernoulli(k)))
        jstate, jloss = step(jstate, jnp.asarray(img), jnp.asarray(depth), jnp.asarray(mask), k)
        loss = port.train_step(img, depth, mask, flips[-1])
        assert abs(loss.item() - float(jloss)) <= 1e-6 * float(jloss)
    assert len(set(flips)) == 2  # both branches ran
    assert port.step == 3 and int(jstate.step) == 3
    _assert_same_params(port.model, jax.device_get(jstate.params), atol=1e-6)


def test_evaluate_with_a_size_mismatch_matches_jax(tiny):
    trainer, _, params0 = tiny
    img, _, _ = _depth_batch(6, 8, 16)
    _, depth, mask = _depth_batch(7, 8, 24, 20, lo=0.5, hi=6.0)
    mask[3] = False
    mask[3, :3, :3] = True  # 9 valid pixels: left out
    batch = {"image": img, "depth": depth, "valid_mask": mask}
    ref = trainer.evaluate(jax.tree.map(jnp.asarray, params0), [batch])
    port = pdepth.DepthTrainer(_TinyPort(params0), CPU)
    got = port.evaluate([batch])
    assert set(got) == set(ref)
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-5, k
    _, n = port.eval_step(img, depth, mask)
    assert n.item() == 7


def test_fit_writes_latest(tmp_path):
    img, depth, mask = _depth_batch(8, 2, 16, lo=1.0, hi=5.0)
    loader = [{"image": img, "depth": depth, "valid_mask": mask}] * 2
    port = pdepth.DepthTrainer(_TinyPort(), CPU, base_lr=1e-3, total_iters=4)
    best = port.fit(loader, epochs=2, val_loader=loader, save_path=str(tmp_path / "ckpt"), seed=3, log_every=1)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["latest.pt"]
    ck = torch.load(tmp_path / "ckpt" / "latest.pt", weights_only=True)
    assert (ck["step"], ck["epoch"], ck["previous_best"]) == (4, 1, best)
    _TinyPort().load_state_dict(ck["model"], strict=True)
    pdepth.build_depth_optimizer(_TinyPort(), 1e-3).load_state_dict(ck["optimizer"])
    assert 0.0 <= best["d1"] <= 1.0 and best["rmse"] < 100.0


# ---------------- the entry ----------------------------------------------------


@pytest.fixture(scope="module")
def tool():
    spec = importlib.util.spec_from_file_location("tool_train_depth", ROOT / "tools" / "train_depth.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert set(x) == set(y) == {"image", "depth", "valid_mask"}
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


def test_datasets_equal_the_tools(tool, tmp_path):
    _same_batches(train_depth.SyntheticDepthDataset(28, 2, n_batches=2, seed=3),
                  tool.SyntheticDepthDataset(28, 2, n_batches=2, seed=3))
    rng = np.random.RandomState(9)
    for i in range(5):
        sample = {"image": rng.randint(0, 256, (30, 40, 3)).astype(np.uint8),
                  "depth": rng.uniform(0, 9, (30, 40)).astype(np.float32)}
        if i % 2:
            sample["valid_mask"] = rng.rand(30, 40) > 0.5
        np.savez(tmp_path / f"s{i}.npz", **sample)
    for train in (True, False):
        port = train_depth.NpzFolderDataset(str(tmp_path), 28, 2, seed=1, train=train)
        ref = tool.NpzFolderDataset(str(tmp_path), 28, 2, seed=1, train=train)
        assert len(port) == len(ref) == 2
        for _ in range(2):  # the order moves on from epoch to epoch
            _same_batches(port, ref)
    assert train_depth.IMAGENET_MEAN == jdpt.IMAGENET_MEAN and train_depth.IMAGENET_STD == jdpt.IMAGENET_STD


def test_pretrained_from_reads_the_encoder_only(tmp_path):
    src = pdpt.build_depth_model("vits", dtype=torch.float32, seed=1)
    sd = dict(src.state_dict())
    sd["pretrained.mask_token"] = torch.zeros(1, 384)  # an official checkpoint's, unused
    torch.save(sd, tmp_path / "official.pth")
    dst = pdpt.build_depth_model("vits", dtype=torch.float32, seed=2)
    head = {k: v.clone() for k, v in dst.state_dict().items() if k.startswith("depth_head.")}
    n = train_depth.load_pretrained(dst, str(tmp_path / "official.pth"))
    assert n == len(src.pretrained.state_dict())
    for k, v in dst.state_dict().items():
        want = sd[k] if k.startswith("pretrained.") else head[k]
        assert torch.equal(v, want), k
    del sd["pretrained.blocks.3.norm1.weight"]
    torch.save(sd, tmp_path / "short.pth")
    with pytest.raises(KeyError, match="encoder weights"):
        train_depth.load_pretrained(dst, str(tmp_path / "short.pth"))


def test_entry_and_trainer_refuse_the_cpu(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA"):
        train_depth.main(["--device", "cpu", "--synthetic", "--save-path", str(tmp_path)])
    with pytest.raises(SystemExit):
        train_depth.main(["--synthetic", "--img-size", "520", "--save-path", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pdepth.DepthTrainer(_TinyPort())
