"""Bias-free multi-head attention of the ViT encoders, with kernel K9
(counterpart of ``threedod/ops/attention.py``).

``multi_head_attention(q, k, v)`` takes (B, S, H, D) tensors, the layout of
``jax.nn.dot_product_attention``, and returns (B, S, H, D) in q's dtype. The
dispatch rule is the JAX package's: sequences of ``_FLASH_MIN_SEQ`` (2048)
tokens and more go to the flash-attention route, shorter ones to the plain
version, which materialises the (B, H, S, S) logits. The threshold is that
package's rule, kept so that both take the same route on the same input; it is
not a measurement of this card.

The flash route (``flash_attention``) is an autograd Function over two
hand-written CUDA sources, both on the tensor cores. Its forward,
``csrc/flash_attention_fwd.cu`` (bf16 on ``wgmma``, f32 on ``mma.sync`` in
three TF32 passes that keep f32 accuracy), reads q, k and v in place through
their strides (they are slices of one qkv projection), keeps a running
softmax over tiles of keys and never writes the logits; when a gradient is
wanted it also writes the (B, H, S) f32 row log-sum-exp. Its backward,
``csrc/flash_attention_bwd.cu`` (the JAX library's dK/dV and dQ kernels, on
``mma.sync`` in bf16 or in three TF32 passes), rebuilds the probabilities
from that log-sum-exp and forms dq, dk and dv without atomics, the same bits
from run to run. A CUDA tensor always goes to the kernels,
built at first use and launched on the current stream; a build or launch
failure raises. A CPU tensor goes to the plain versions,
``attention_forward_reference`` and ``attention_backward_reference``, which
the tests and the card-side comparison use. Every forward launch adds one to
``LAUNCHES``, every backward call one to ``LAUNCHES_BWD``. Below the threshold
the plain ``attention_reference`` runs on both devices and autograd
differentiates it, as XLA does for the JAX package.
"""
from __future__ import annotations

import ctypes
import math

import torch
from torch.autograd.function import once_differentiable

from . import _build

_FLASH_MIN_SEQ = 2048
HEAD_DIM = 64  # the one head width of the three DINOv2 encoders, and the kernel's
LAUNCHES = 0  # K9's forward
LAUNCHES_BWD = 0  # K9's backward, one for each backward call (three kernels)
_DTYPES = (torch.float32, torch.bfloat16)


def _logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """(B, H, S, S) f32 logits q k^T / sqrt(D)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (1.0 / math.sqrt(q.shape[-1]))


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v with logits, softmax and the second product
    in f32, cast to q's dtype at the end."""
    probs = torch.softmax(_logits(q, k), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


def attention_forward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The plain forward of the flash route: (``attention_reference``'s
    output, the (B, H, S) f32 row log-sum-exp of the logits in natural-log
    units), the two things K9's forward writes when a gradient is wanted."""
    logits = _logits(q, k)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)
    return out, torch.logsumexp(logits, dim=-1)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, dout: torch.Tensor):
    """The plain backward of the flash route, the five formulas in f32, each
    gradient cast to its input's dtype once: P = exp(s q k^T - lse), delta =
    rowsum(dout * out), dV = P^T dout, dS = P * (dout v^T - delta), dQ = s dS k,
    dK = s dS^T q, with s = 1 / sqrt(D). (B, S, H, D) tensors, lse (B, H, S)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, dof = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(_logits(q, k) - lse[..., None])
    delta = (dof * out.float()).sum(-1).permute(0, 2, 1)  # (B, H, S)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", dof, vf) - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share one (B, S, H, D) shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if len({t.device for t in (q, k, v)}) != 1:
        raise ValueError("q, k, v must be on one device")


def _strided(t: torch.Tensor, what: str) -> torch.Tensor:
    """``t`` as the kernel reads it: last stride 1, every other stride and the
    start on a 16-byte boundary. A view that is not gets one contiguous copy."""
    per16 = 16 // t.element_size()
    if t.stride(3) != 1 or any(s % per16 for s in t.stride()[:3]):
        t = t.contiguous()
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary for vector loads")
    return t


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, want_lse: bool):
    """K9's forward on CUDA tensors already laid out for it (``_strided``):
    (out (B, S, H, D) contiguous, lse (B, H, S) f32 or None). The kernel
    writes lse only when ``want_lse``."""
    global LAUNCHES
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if want_lse else None
    lib = _build.library("flash_attention_fwd", "threedod_flash_attention_fwd",
                         [_P] * 5 + [_I] * 4 + [_L] * 9 + [_I] * 2 + [_P])
    err = lib.threedod_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(), b, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *_build.launch_args(q))
    _build.check_launch(lib, "flash_attention", err)
    LAUNCHES += 1
    return out, lse


def flash_backward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor):
    """K9's backward on CUDA tensors: (dq, dk, dv), (B, S, H, D) contiguous
    in q's dtype. q, k, v and out as the forward left them, lse (B, H, S) f32
    contiguous; dout is laid out here. Three launches (delta, dK/dV, dQ),
    counted as one backward."""
    global LAUNCHES_BWD
    dout = _strided(dout.to(q.dtype), "dout")
    b, s, h, d = q.shape
    if lse.dtype != torch.float32 or not lse.is_contiguous() or tuple(lse.shape) != (b, h, s):
        raise ValueError(f"lse must be a contiguous (B, H, S) float32 tensor, got {tuple(lse.shape)} {lse.dtype}")
    dq, dk, dv = (torch.empty((b, s, h, d), dtype=q.dtype, device=q.device) for _ in range(3))
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _build.library("flash_attention_bwd", "threedod_flash_attention_bwd",
                         [_P] * 10 + [_I] * 4 + [_L] * 15 + [_I] * 2 + [_P])
    err = lib.threedod_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3], *dout.stride()[:3],
        *_build.launch_args(q))
    _build.check_launch(lib, "flash_attention backward", err)
    LAUNCHES_BWD += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """(q, k, v, want) -> out: K9's forward and backward on CUDA tensors, the
    plain versions on CPU tensors. The row log-sum-exp is written and q, k, v,
    out and it are saved only when ``want`` (a gradient is wanted: grad mode
    is on and an input requires one; ``ctx.needs_input_grad`` does not say
    so under ``no_grad``)."""

    @staticmethod
    def forward(ctx, q, k, v, want):
        if q.device.type == "cpu":
            out, lse = attention_forward_reference(q, k, v)
        else:
            q, k, v = _strided(q, "q"), _strided(k, "k"), _strided(v, "v")
            out, lse = flash_forward_cuda(q, k, v, want)
        if want:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if dout.device.type == "cpu":
            return (*attention_backward_reference(q, k, v, out, lse, dout), None)
        return (*flash_backward_cuda(q, k, v, out, lse, dout), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel K9: the same function as ``attention_reference`` without the
    logits in memory, differentiable through K9's backward. D must be 64;
    float32 or bfloat16."""
    _check(q, k, v)
    if q.shape[3] != HEAD_DIM:
        raise ValueError(f"the flash-attention kernel takes head width {HEAD_DIM}, got {q.shape[3]}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash-attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    want = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _FlashAttention.apply(q, k, v, want)


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bias-free scaled dot-product attention, (B, S, H, D) -> (B, S, H, D) in
    q's dtype."""
    _check(q, k, v)
    if q.shape[1] >= _FLASH_MIN_SEQ:
        return flash_attention(q, k, v)
    return attention_reference(q, k, v)
