"""Bias-free multi-head attention of the ViT encoders, with kernel K9
(counterpart of ``threedod/ops/attention.py``).

``multi_head_attention(q, k, v)`` takes (B, S, H, D) tensors, the layout of
``jax.nn.dot_product_attention``, and returns (B, S, H, D) in q's dtype. The
dispatch rule is the JAX package's: sequences of ``_FLASH_MIN_SEQ`` (2048)
tokens and more go to the flash-attention route, shorter ones to the plain
version, which materialises the (B, H, S, S) logits. The threshold is that
package's rule, kept so that both take the same route on the same input; it is
not a measurement of this card.

The flash route (``flash_attention``) is the hand-written CUDA kernel
``csrc/flash_attention_fwd.cu``: it reads q, k and v in place through their
strides (they are slices of one qkv projection), keeps a running softmax over
tiles of 64 keys and never writes the logits. A CUDA tensor always goes to the
kernel, built at first use and launched on the current stream; a build or
launch failure raises. A CPU tensor goes to ``attention_reference``, the plain
version the tests and the card-side comparison use. Every launch adds one to
``LAUNCHES``. Forward only.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_FLASH_MIN_SEQ = 2048
HEAD_DIM = 64  # the one head width of the three DINOv2 encoders, and the kernel's
LAUNCHES = 0  # K9
_DTYPES = (torch.float32, torch.bfloat16)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v with logits, softmax and the second product
    in f32, cast to q's dtype at the end."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v.float()).to(q.dtype)


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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Kernel K9: the same function as ``attention_reference`` without the
    logits in memory. D must be 64; float32 or bfloat16."""
    global LAUNCHES
    _check(q, k, v)
    if q.shape[3] != HEAD_DIM:
        raise ValueError(f"the flash-attention kernel takes head width {HEAD_DIM}, got {q.shape[3]}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash-attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got {q.device}")
    q, k, v = _strided(q, "q"), _strided(k, "k"), _strided(v, "v")
    b, s, h, d = q.shape
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = _build.load("flash_attention_fwd")
    fn = lib.threedod_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.threedod_cuda_error_string.argtypes = [ctypes.c_int]
    lib.threedod_cuda_error_string.restype = ctypes.c_char_p
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(q.dtype == torch.bfloat16), q.device.index or 0, torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: {lib.threedod_cuda_error_string(err).decode()}")
    LAUNCHES += 1
    return out


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bias-free scaled dot-product attention, (B, S, H, D) -> (B, S, H, D) in
    q's dtype."""
    _check(q, k, v)
    if q.shape[1] >= _FLASH_MIN_SEQ:
        return flash_attention(q, k, v)
    return attention_reference(q, k, v)
