"""The port's loss primitives, new geometry functions, schedule and
train-mode ConvBN vs the JAX package: same numpy inputs, f32, values to 1e-6
and gradients to 1e-5 (single elementwise formulas; only rounding differs).
Inputs keep clear of clamp bounds and of |x| kinks.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per worker)

import jax
import jax.numpy as jnp

from threedod.geometry import boxes2d as jbox, misc as jmisc, rotations as jrot
from threedod.ops import losses as jl

from threedod_torch.geometry import boxes2d as pbox, misc as pmisc, rotations as prot
from threedod_torch.ops import losses as pl

RNG = np.random.RandomState(0)


def _both(jfn, pfn, *arrays, argnum=0, atol=1e-6, gtol=1e-5):
    """Value and gradient (of the sum, w.r.t. arrays[argnum]) on both sides."""
    ref = np.asarray(jax.jit(jfn)(*arrays))
    ts = [torch.from_numpy(a) for a in arrays]
    ts[argnum].requires_grad_()
    out = pfn(*ts)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=1e-5, atol=atol)
    out.sum().backward()
    gref = np.asarray(jax.jit(jax.grad(lambda *a: jnp.sum(jfn(*a)), argnums=argnum))(*arrays))
    np.testing.assert_allclose(ts[argnum].grad.numpy(), gref, rtol=1e-4, atol=gtol)


def _rot(n, seed):
    q = np.random.RandomState(seed).randn(n, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2).astype(np.float32)


def test_cross_entropy_masked():
    logits = RNG.randn(40, 6).astype(np.float32)
    labels = RNG.randint(0, 6, 40).astype(np.int32)
    labels[:3] = [7, -1, 6]  # out of range where masked
    mask = RNG.rand(40) > 0.3
    mask[:3] = False
    _both(lambda lg: jl.cross_entropy(lg, jnp.asarray(labels), jnp.asarray(mask)),
          lambda lg: pl.cross_entropy(lg, torch.from_numpy(labels), torch.from_numpy(mask)), logits)
    _both(lambda lg: jl.cross_entropy(lg, jnp.asarray(labels % 6)),
          lambda lg: pl.cross_entropy(lg, torch.from_numpy(labels % 6)), logits)


@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_bce_with_logits(reduction):
    logits = (RNG.randn(50) * 4).astype(np.float32)
    targets = RNG.rand(50).astype(np.float32)
    weight = RNG.rand(50).astype(np.float32)
    _both(lambda lg, t, w: jl.binary_cross_entropy_with_logits(lg, t, w, reduction),
          lambda lg, t, w: pl.binary_cross_entropy_with_logits(lg, t, w, reduction), logits, targets, weight)


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_smooth_l1(beta):
    a, b = RNG.randn(30, 4).astype(np.float32), RNG.randn(30, 4).astype(np.float32)
    _both(lambda x, y: jl.smooth_l1_loss(x, y, beta), lambda x, y: pl.smooth_l1_loss(x, y, beta), a, b)
    _both(lambda x, y: jmisc.smooth_l1(x, y, beta), lambda x, y: pmisc.smooth_l1(x, y, beta), a, b)


def test_safely_reduce_losses():
    loss = RNG.rand(20).astype(np.float32)
    loss[[2, 5]] = [np.inf, np.nan]
    mask = RNG.rand(20) > 0.4
    mask[[2, 5]] = True
    for m in (mask, None, np.zeros(20, bool)):
        ref = jl.safely_reduce_losses(jnp.asarray(loss), None if m is None else jnp.asarray(m))
        got = pl.safely_reduce_losses(torch.from_numpy(loss), None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(got.item(), float(ref), rtol=1e-6)
    x = torch.from_numpy(loss).requires_grad_()
    pl.safely_reduce_losses(x, torch.from_numpy(mask)).backward()
    assert torch.isfinite(x.grad).all() and x.grad[2] == 0 and x.grad[5] == 0


def test_chamfer_scaled_sigmoid():
    a, b = RNG.randn(12, 8, 3).astype(np.float32), RNG.randn(12, 8, 3).astype(np.float32)
    _both(jmisc.chamfer_corner_loss, pmisc.chamfer_corner_loss, a, b)
    v = RNG.randn(12).astype(np.float32)
    _both(lambda x: jmisc.scaled_sigmoid(x, 0.5, 3.0), lambda x: pmisc.scaled_sigmoid(x, 0.5, 3.0), v)


def test_box_functions():
    xy1, xy2 = RNG.uniform(0, 50, (9, 2)), RNG.uniform(0, 50, (14, 2))
    b1 = np.concatenate([xy1, xy1 + RNG.uniform(5, 40, (9, 2))], -1).astype(np.float32)
    b2 = np.concatenate([xy2, xy2 + RNG.uniform(5, 40, (14, 2))], -1).astype(np.float32)
    b2[0] = 0.0
    for name in ("pairwise_intersection", "pairwise_ioa", "pairwise_iou"):
        ref = np.asarray(getattr(jbox, name)(jnp.asarray(b1), jnp.asarray(b2)))
        got = getattr(pbox, name)(torch.from_numpy(b1), torch.from_numpy(b2)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(pbox.box_area(torch.from_numpy(b2)).numpy(), np.asarray(jbox.box_area(jnp.asarray(b2))))
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        _both(jbox.Box2BoxTransform(w).get_deltas, pbox.Box2BoxTransform(w).get_deltas, b1, b2[1:10], argnum=1)
        d = np.asarray(jbox.Box2BoxTransform(w).get_deltas(jnp.asarray(b1), jnp.asarray(b2[1:10])))
        back = pbox.Box2BoxTransform(w).apply_deltas(torch.from_numpy(d), torch.from_numpy(b1)).numpy()
        np.testing.assert_allclose(back, b2[1:10], rtol=1e-4, atol=1e-3)


def test_rotation_functions():
    n = 10
    R1, R2 = _rot(n, 1), _rot(n, 2)
    K = np.tile(np.array([[70.0, 0, 48], [0, 75.0, 32], [0, 0, 1]], np.float32), (n, 1, 1))
    u, v = RNG.uniform(0, 96, n).astype(np.float32), RNG.uniform(0, 64, n).astype(np.float32)
    _both(lambda r: jrot.R_to_allocentric(jnp.asarray(K), r, jnp.asarray(u), jnp.asarray(v)),
          lambda r: prot.R_to_allocentric(torch.from_numpy(K), r, torch.from_numpy(u), torch.from_numpy(v)), R1)
    # to and from allocentric are inverses
    allo = prot.R_to_allocentric(torch.from_numpy(K), torch.from_numpy(R1), torch.from_numpy(u), torch.from_numpy(v))
    ego = prot.R_from_allocentric(torch.from_numpy(K), allo, torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(ego.numpy(), R1, atol=1e-5)
    for cos in (True, False):
        _both(lambda a, b: jrot.so3_relative_angle(a, b, cos_angle=cos),
              lambda a, b: prot.so3_relative_angle(a, b, cos_angle=cos), R1, R2, atol=1e-5, gtol=1e-4)
    x = np.array([-1.2, -0.99995, -0.5, 0.0, 0.7, 0.99995, 1.3], np.float32)  # both sides of the bounds
    _both(jrot.acos_linear_extrapolation, prot.acos_linear_extrapolation, x, atol=1e-5, gtol=1e-2)
    _both(lambda r: jrot.so3_rotation_angle(r), lambda r: prot.so3_rotation_angle(r), R1, atol=1e-5, gtol=1e-4)


@pytest.mark.parametrize("iteration", [0, 1, 500, 999, 1000, 19199, 19200, 25600, 31999])
def test_schedule(iteration):
    from threedod.config import Config as JaxConfig
    from threedod.train.solver import host_lr as jax_host_lr, warmup_multistep_schedule

    from threedod_torch.config import Config
    from threedod_torch.train.solver import host_lr

    js, ps = JaxConfig().solver, Config().solver
    assert host_lr(ps, iteration) == jax_host_lr(js, iteration)
    sched = warmup_multistep_schedule(js.base_lr, js.steps, js.gamma, js.warmup_iters, js.warmup_factor)
    np.testing.assert_allclose(host_lr(ps, iteration), float(sched(jnp.asarray(iteration))), rtol=1e-6)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_is_optax(max_norm):
    """optax scales by max_norm / max(norm, max_norm), with no epsilon
    (``torch.nn.utils.clip_grad_norm_`` divides by norm + 1e-6): the port
    writes optax's rule out. Above and below the bound, to 1e-6 relative."""
    import optax

    from threedod_torch.train.solver import clip_by_global_norm

    grads = [RNG.randn(*shape).astype(np.float32) for shape in ((3, 4), (7,), (2, 2, 2))]
    ref, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    clip_by_global_norm(got, max_norm)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=0)
    norm = np.sqrt(sum((g ** 2).sum() for g in grads))
    assert (norm > max_norm) == (not np.array_equal(got[0].numpy(), grads[0]))


@pytest.mark.parametrize("stride,relu,kernel", [(1, True, 3), (2, False, 3), (1, False, 1)])
def test_convbn_train_mode(stride, relu, kernel):
    """Outputs, batch statistics (biased variance), running statistics after
    the update, and gradients w.r.t. input, kernel, scale and bias."""
    import torch.nn as nn

    from threedod.models.backbones.layers import ConvBN

    from threedod_torch.models.backbones.layers import BatchNorm2d, conv_bn, update_running_stats

    rng = np.random.RandomState(stride + kernel)
    x = rng.randn(2, 12, 16, 8).astype(np.float32)
    cot = rng.randn(2, 12 // stride, 16 // stride, 10).astype(np.float32)
    mod = ConvBN(10, kernel, stride, relu=relu, dtype=jnp.float32)
    v = jax.tree_util.tree_map(np.asarray, jax.jit(mod.init)(jax.random.PRNGKey(0), x))
    params = {"conv": {"kernel": v["params"]["conv"]["kernel"]},
              "bn": {"scale": rng.uniform(0.8, 1.2, 10).astype(np.float32),
                     "bias": rng.normal(0, 0.1, 10).astype(np.float32)}}
    stats = {"bn": {"mean": rng.normal(0, 0.1, 10).astype(np.float32),
                    "var": rng.uniform(0.8, 1.2, 10).astype(np.float32)}}

    def loss(params, x):
        y, mut = mod.apply({"params": params, "batch_stats": stats}, x, train=True, mutable=["batch_stats"])
        return jnp.sum(y * cot), (y, mut["batch_stats"])

    (_, (y_ref, new_stats)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, x)

    conv = nn.Conv2d(8, 10, kernel, stride=stride, padding=(kernel - 1) // 2, bias=False)
    bn = BatchNorm2d(10).train()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(params["conv"]["kernel"].transpose(3, 2, 0, 1).copy()))
        bn.weight.copy_(torch.from_numpy(params["bn"]["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bn"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["bn"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["bn"]["var"]))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    y = conv_bn(xt, conv, bn, relu=relu)
    (y * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    # the running statistics stay put until the step is accepted
    np.testing.assert_array_equal(bn.running_var.numpy(), stats["bn"]["var"])
    update_running_stats(bn)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new_stats["bn"]["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new_stats["bn"]["var"]), rtol=1e-5, atol=1e-6)
    assert bn.batch_stats is None

    def close(got, ref):
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * np.abs(ref).max())

    close(xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(gx))
    close(conv.weight.grad.numpy(), np.asarray(gp["conv"]["kernel"]).transpose(3, 2, 0, 1))
    close(bn.weight.grad.numpy(), np.asarray(gp["bn"]["scale"]))
    close(bn.bias.grad.numpy(), np.asarray(gp["bn"]["bias"]))


def test_convbn_differs_from_torch_batchnorm():
    """The trap this module avoids: ``torch.nn.BatchNorm2d`` feeds its running
    variance the unbiased estimate."""
    from threedod_torch.models.backbones.layers import BatchNorm2d, conv_bn, update_running_stats

    import torch.nn as nn

    x = torch.from_numpy(RNG.randn(2, 4, 3, 3).astype(np.float32))
    conv = nn.Conv2d(4, 4, 1, bias=False)
    bn = BatchNorm2d(4).train()
    conv_bn(x, conv, bn, relu=False)
    update_running_stats(bn)
    ref = nn.BatchNorm2d(4).train()
    ref(conv(x))
    n = 2 * 3 * 3
    np.testing.assert_allclose(bn.running_mean.numpy(), ref.running_mean.numpy(), atol=1e-6)
    np.testing.assert_allclose((bn.running_var - 0.9).numpy() * n / (n - 1), (ref.running_var - 0.9).detach().numpy(),
                               rtol=1e-4, atol=1e-7)
