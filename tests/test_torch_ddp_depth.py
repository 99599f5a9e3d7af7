"""The depth fine-tuning step over 2 processes vs one process at the global
batch, and vs the JAX package, f32 on the CPU.

SiLog is sqrt(M2 - 0.5 M1^2) over the global batch's valid pixels: under a
process group the moments' sums and the pixel count are summed over the
ranks before the square root, every rank backpropagates the (replicated)
loss over the world size, and the gradients are summed over the ranks
(``threedod_torch/train/depth.py``). One spawn of 2 gloo ranks takes, each
on its 2 rows of a global batch of 4:

* three ``DepthTrainer.train_step``s of ``test_torch_depth_train.py``'s
  two-part net (16x16 images, depths outside the range, a random mask); the
  flips are the JAX keys' draws, as there, and both occur;
* one step of Depth-Anything-V2 ``vits`` at 28x42 (a 2x3 patch grid), seeded.

Against one process at the global batch: the losses to 1e-5 relative, the
parameters after the steps to 1e-6 of each tensor's largest entry and the
last step's gradients to 1e-5 of it (the ranks sum 2 + 2 images' products
where one process sums 4). The ViT's parameters after its one step are held
to that plus twice the LR: the first AdamW update, from zero moments, is
-lr g / (|g| + eps), so the rounding of a gradient entry near zero can move
it by up to the LR (measured 3.3e-5 at an LR of 1e-4). The two-part net's steps against the JAX
``DepthTrainer.make_train_step`` at the global batch at
``test_torch_depth_train.py``'s tolerances: losses 1e-6 relative,
parameters atol 1e-6. Both ranks hold the same loss and parameters.
"""
from __future__ import annotations

import numpy as np
import pytest

import _torch_ddp as td

import jax
import jax.numpy as jnp

from test_depth_train import _TinyDepthNet
from test_torch_depth_train import _depth_batch, _TinyPort
from threedod.train import depth as jdepth

LOSS_RTOL, PARAM_TOL, GRAD_TOL = 1e-5, 1e-6, 1e-5
JAX_LOSS_RTOL, JAX_PARAM_ATOL = 1e-6, 1e-6
TINY = dict(base_lr=3e-3, total_iters=5, max_depth=20.0)
VITS_LR = 1e-4


@pytest.fixture(scope="module")
def run():
    img, depth, mask = _depth_batch(5, 4, 16)
    jtrainer = jdepth.DepthTrainer(_TinyDepthNet(), **TINY)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), jnp.asarray(img))
    params0 = jax.device_get(jstate.params)
    step = jtrainer.make_train_step()
    key, flips, jlosses = jax.random.PRNGKey(1), [], []
    for _ in range(3):
        key, k = jax.random.split(key)
        flips.append(bool(jax.random.bernoulli(k)))
        jstate, loss = step(jstate, jnp.asarray(img), jnp.asarray(depth), jnp.asarray(mask), k)
        jlosses.append(float(loss))
    state = {k: v.detach().clone() for k, v in _TinyPort(params0).state_dict().items()}
    vimg, vdepth, vmask = _depth_batch(3, 4, 28, 42, lo=0.5, hi=12.0)
    jobs = {
        "tiny": dict(make=td.TinyDepth, state=state, trainer=TINY,
                     steps=[(img, depth, mask, flip) for flip in flips]),
        "vits": dict(make=td.seeded_vits, trainer=dict(base_lr=VITS_LR, total_iters=10),
                     steps=[(vimg, vdepth, vmask, False)]),
    }
    return dict(one=td.depth_steps(jobs), ranks=td.on_ranks("depth_steps", jobs), flips=flips, lr=VITS_LR,
                jlosses=jlosses, jparams=jax.device_get(jstate.params))


@pytest.mark.parametrize("model", ["tiny", "vits"])
def test_two_ranks_match_one_process(run, model):
    got, want = run["ranks"][0][model], run["one"][model]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    td.close_to_largest(got["grads"], want["grads"], GRAD_TOL, "gradient")
    if model == "tiny":
        td.close_to_largest(got["after"], want["after"], PARAM_TOL, "after")
    else:  # one AdamW step from zero moments: each update is -lr g / (|g| + eps)
        lr = run["lr"]
        for k, ref in want["after"].items():
            np.testing.assert_allclose(got["after"][k], ref, rtol=0, atol=PARAM_TOL * np.abs(ref).max() + 2 * lr,
                                       err_msg=k)
    other = run["ranks"][1][model]
    assert other["losses"] == got["losses"]
    for k, v in got["after"].items():
        np.testing.assert_array_equal(v, other["after"][k], err_msg=k)


def test_two_ranks_match_jax(run):
    got = run["ranks"][0]["tiny"]
    assert len(set(run["flips"])) == 2  # both branches ran
    np.testing.assert_allclose(got["losses"], run["jlosses"], rtol=JAX_LOSS_RTOL)
    for name in ("pretrained", "depth_head"):
        np.testing.assert_allclose(got["after"][f"{name}.weight"],
                                   np.asarray(run["jparams"][name]["kernel"]).transpose(3, 2, 0, 1),
                                   atol=JAX_PARAM_ATOL)
        np.testing.assert_allclose(got["after"][f"{name}.bias"], np.asarray(run["jparams"][name]["bias"]),
                                   atol=JAX_PARAM_ATOL)
