"""The port's attention dispatch (``threedod_torch/ops/attention.py``, kernel
K9) vs ``threedod.ops.attention.multi_head_attention``, f32 on the CPU.

On the CPU the JAX function takes ``jax.nn.dot_product_attention`` at every
length (its Pallas flash kernel is TPU only) and the port takes its plain
version, below the threshold of 2048 tokens directly and above it through
``flash_attention``, whose CPU branch is the same plain version. Inputs are
made with numpy from a seed; the two agree to atol 1e-5 (f32 sums of up to
2100 terms in another order, outputs of order 1).

On a CUDA card only (marked ``gpu``): kernel K9 vs the plain version, f32 to
1e-5 and bf16 to 2^-7 of the largest entry, on contiguous tensors and on the
strided slices of one qkv projection, with ragged tails.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)

import jax.numpy as jnp

from threedod.ops import attention as jattn
from threedod_torch.ops import attention as pattn


def _qkv(b, s, h, d, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("s", [130, 2100])
def test_attention_matches_jax(s):
    q, k, v = _qkv(1, s, 2, 64, seed=s)
    ref = np.asarray(jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = pattn.multi_head_attention(*(torch.from_numpy(a) for a in (q, k, v)))
    assert got.shape == (1, s, 2, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_threshold_is_the_jax_packages():
    assert pattn._FLASH_MIN_SEQ == jattn._FLASH_MIN_SEQ == 2048


def test_slices_of_one_projection_are_read_as_views():
    """q, k, v as the ViT hands them over: strided views of (B, N, 3, H, D)."""
    rng = np.random.RandomState(1)
    qkv = torch.from_numpy(rng.randn(2, 50, 3, 2, 64).astype(np.float32))
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    got = pattn.multi_head_attention(q, k, v)
    ref = pattn.attention_reference(q.contiguous(), k.contiguous(), v.contiguous())
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    # the kernel's view of them: same storage, no copy; an odd layout is copied once
    assert pattn._strided(k, "k").data_ptr() == k.data_ptr()
    odd = torch.zeros(1, 4, 2, 128)[..., ::2]
    assert pattn._strided(odd, "odd").is_contiguous()


def test_reference_output_dtype_follows_q():
    q, k, v = (torch.from_numpy(a).bfloat16() for a in _qkv(1, 40, 2, 64))
    out = pattn.multi_head_attention(q, k, v)
    assert out.dtype == torch.bfloat16
    ref = pattn.attention_reference(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() <= 2.0 ** -7 * ref.abs().max().item()


def test_other_head_width_raises_on_the_kernel_route_only():
    short = tuple(torch.from_numpy(a) for a in _qkv(1, 16, 2, 32))
    assert pattn.multi_head_attention(*short).shape == (1, 16, 2, 32)  # plain route: any width
    long = tuple(torch.zeros(1, 2048, 1, 32) for _ in range(3))
    with pytest.raises(ValueError, match="head width 64"):
        pattn.multi_head_attention(*long)
    with pytest.raises(ValueError, match="head width 64"):
        pattn.flash_attention(*short)


def test_bad_inputs_raise():
    q, k, v = (torch.zeros(1, 8, 2, 64) for _ in range(3))
    with pytest.raises(ValueError, match="share one"):
        pattn.multi_head_attention(q, k[:, :4], v)
    with pytest.raises(TypeError, match="share one dtype"):
        pattn.multi_head_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pattn.flash_attention(q.half(), k.half(), v.half())
    m = lambda: torch.empty(1, 2048, 2, 64, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA or CPU"):  # no silent fallback on another device
        pattn.multi_head_attention(m(), m(), m())


def test_cpu_tensors_count_no_launch_and_build_nothing():
    from threedod_torch.ops import _build

    before, built = pattn.LAUNCHES, _build.load.cache_info().currsize
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2048, 1, 64))
    out = pattn.multi_head_attention(q, k, v)
    np.testing.assert_array_equal(out.numpy(), pattn.attention_reference(q, k, v).numpy())
    assert pattn.LAUNCHES == before and _build.load.cache_info().currsize == built


# ---------------- on the card ----------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("b,s,h,strided", [(1, 2443, 16, True), (2, 2048, 6, False), (1, 70, 2, True), (3, 129, 1, False)])
def test_flash_attention_kernel_on_card(b, s, h, strided, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("the flash-attention kernel needs a CUDA card")
    rng = np.random.RandomState(s)
    dev = torch.device("cuda")
    if strided:
        qkv = torch.from_numpy(rng.randn(b, s, 3, h, 64).astype(np.float32)).to(dev, dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    else:
        q, k, v = (torch.from_numpy(a).to(dev, dtype) for a in _qkv(b, s, h, 64, seed=s))
    before = pattn.LAUNCHES
    out = pattn.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert pattn.LAUNCHES == before + 1
    ref = pattn.attention_reference(q, k, v)
    assert out.shape == ref.shape and out.dtype == dtype and out.is_contiguous()
    assert bool(torch.isfinite(out.float()).all())
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()
