"""The backward of the port's flash route (``threedod_torch/ops/attention.py``,
kernel K9's dK/dV and dQ), f32 on the CPU.

On the CPU ``flash_attention`` is an autograd Function whose forward and
backward are the plain versions, ``attention_forward_reference`` (output and
row log-sum-exp) and ``attention_backward_reference`` (the five formulas in
f32); on the card the same Function launches the kernels. Inputs are made
with numpy from a seed, as strided views of one (B, S, 3, H, D) qkv tensor,
the way the ViT hands them over, and the gradient is read where it lands, in
that tensor.

* the plain backward against autograd of ``attention_reference`` and against
  ``jax.vjp`` of ``jax.nn.dot_product_attention`` (the JAX package's route off
  the TPU, ``threedod/ops/attention.py:58-59``) at B = 2, S = 37 (not a
  multiple of the kernels' 64-token tiles) and 130, H = 2: atol 1e-5 (f32
  sums of up to 130 terms in other orders; gradients of order 1; measured at
  most 6.0e-7 against autograd and 5.4e-7 against JAX, outputs 8.9e-7);
* lse against a float64 log-sum-exp of the same logits: atol 1e-5 (f32
  logits and sums; values near log S; measured 5.1e-7);
* the Function's CPU wiring at S = 2048, the dispatch threshold: a
  ``grad_fn`` on the output, gradients equal to autograd's of the plain
  version within 1e-5 (measured 1.3e-7), nothing saved and no grad_fn under
  ``no_grad``, no launch counted and no kernel built;
* bf16 inputs get bf16 gradients within 2^-6 of each tensor's largest entry
  of the f32 ones (one rounding of the f32 sums, and the bf16 inputs and
  output entering every product; measured 8.1e-3 of the largest entry);
* on a CUDA card only (marked ``gpu``): the forward's lse and the backward
  kernels against the plain versions at ragged and full-width shapes, f32 to
  1e-4 and bf16 to 2^-6 of each tensor's largest entry, two runs bit-equal,
  and a vits-width attention's gradient through autograd card against CPU.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)

import jax
import jax.numpy as jnp

from threedod_torch.ops import attention as pattn


def _qkv(b, s, h, seed, d=64):
    """A (B, S, 3, H, D) leaf that requires grad, its three strided views and
    a seeded cotangent (B, S, H, D), from numpy."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy(rng.randn(b, s, 3, h, d).astype(np.float32)).requires_grad_(True)
    dout = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
    return qkv, (qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]), dout


def _grad_of(fn, qkv, views, dout):
    qkv.grad = None
    out = fn(*views)
    out.backward(dout)
    return out.detach(), qkv.grad.clone()


@pytest.mark.parametrize("s", [37, 130])
def test_plain_backward_matches_autograd_and_jax(s):
    qkv, views, dout = _qkv(2, s, 2, seed=s)
    assert not views[0].is_contiguous()
    out, got = _grad_of(pattn.flash_attention, qkv, views, dout)
    ref_out, ref = _grad_of(pattn.attention_reference, qkv, views, dout)
    np.testing.assert_array_equal(out.numpy(), ref_out.numpy())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)

    def jax_attention(a):
        return jax.nn.dot_product_attention(a[:, :, 0], a[:, :, 1], a[:, :, 2])

    jout, vjp = jax.vjp(jax_attention, jnp.asarray(qkv.detach().numpy()))
    (jgrad,) = vjp(jnp.asarray(dout.numpy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgrad), atol=1e-5)
    assert np.abs(got.numpy()).max() > 0.1  # not a vanishing gradient


def test_lse_is_the_row_logsumexp():
    _, (q, k, v), _ = _qkv(2, 70, 3, seed=3)
    out, lse = pattn.attention_forward_reference(q.detach(), k.detach(), v.detach())
    assert lse.shape == (2, 3, 70) and lse.dtype == torch.float32
    logits = np.einsum("bqhd,bkhd->bhqk", q.detach().numpy().astype(np.float64),
                       k.detach().numpy().astype(np.float64)) / 8.0
    mx = logits.max(-1, keepdims=True)
    ref = (mx + np.log(np.exp(logits - mx).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), ref, atol=1e-5)
    np.testing.assert_array_equal(out.numpy(), pattn.attention_reference(q, k, v).detach().numpy())


def test_function_wiring_at_the_threshold():
    from threedod_torch.ops import _build

    before = (pattn.LAUNCHES, pattn.LAUNCHES_BWD, _build.load.cache_info().currsize)
    qkv, views, dout = _qkv(1, 2048, 1, seed=4)
    out = pattn.multi_head_attention(*views)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    out.backward(dout)
    got = qkv.grad.clone()
    _, ref = _grad_of(pattn.attention_reference, qkv, views, dout)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)
    with torch.no_grad():
        assert pattn.multi_head_attention(*views).grad_fn is None
    assert (pattn.LAUNCHES, pattn.LAUNCHES_BWD, _build.load.cache_info().currsize) == before


def test_bf16_gradients_round_once():
    qkv, views, dout = _qkv(1, 37, 2, seed=5)
    _, ref = _grad_of(pattn.flash_attention, qkv, views, dout)
    qkv16 = qkv.detach().bfloat16().requires_grad_(True)
    out16 = pattn.flash_attention(qkv16[:, :, 0], qkv16[:, :, 1], qkv16[:, :, 2])
    assert out16.dtype == torch.bfloat16
    out16.backward(dout.bfloat16())
    assert qkv16.grad.dtype == torch.bfloat16
    for i in range(3):
        r, g = ref[:, :, i], qkv16.grad[:, :, i].float()
        assert (g - r).abs().max().item() <= 2.0 ** -6 * r.abs().max().item()


# ---------------- on the card ----------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("b,s,h", [(1, 70, 2), (2, 129, 3), (2, 2117, 16), (1, 2443, 16), (1, 2049, 16), (1, 2175, 16)])
def test_backward_kernels_on_card(b, s, h, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("the flash-attention kernels need a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.RandomState(s)
    qkv = torch.from_numpy(rng.randn(b, s, 3, h, 64).astype(np.float32)).to(dev, dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    dout = torch.from_numpy(rng.randn(b, s, h, 64).astype(np.float32)).to(dev, dtype)
    before = pattn.LAUNCHES_BWD
    out, lse = pattn.flash_forward_cuda(q, k, v, want_lse=True)
    got = pattn.flash_backward_cuda(q, k, v, out, lse, dout)
    again = pattn.flash_backward_cuda(q, k, v, out, lse, dout)
    ref_out, ref_lse = pattn.attention_forward_reference(q, k, v)
    ref = pattn.attention_backward_reference(q, k, v, ref_out, ref_lse, dout)
    torch.cuda.synchronize()
    assert pattn.LAUNCHES_BWD == before + 2
    assert (lse - ref_lse).abs().max().item() <= 1e-5 * ref_lse.abs().max().item()
    for g, a, r in zip(got, again, ref):
        assert g.shape == r.shape and g.dtype == dtype and g.is_contiguous()
        assert torch.equal(g, a)
        assert (g.float() - r.float()).abs().max().item() <= tol * r.float().abs().max().item()


@pytest.mark.gpu
def test_autograd_through_the_kernels_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("the flash-attention kernels need a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    qkv, views, dout = _qkv(1, 2117, 6, seed=7)
    _, ref = _grad_of(pattn.multi_head_attention, qkv, views, dout)
    dev_qkv = qkv.detach().cuda().requires_grad_(True)
    fwd, bwd = pattn.LAUNCHES, pattn.LAUNCHES_BWD
    out = pattn.multi_head_attention(dev_qkv[:, :, 0], dev_qkv[:, :, 1], dev_qkv[:, :, 2])
    out.backward(dout.cuda())
    torch.cuda.synchronize()
    assert (pattn.LAUNCHES - fwd, pattn.LAUNCHES_BWD - bwd) == (1, 1)
    assert (dev_qkv.grad.cpu() - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
