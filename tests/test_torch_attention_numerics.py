"""The numerical design of kernel K9 (``threedod_torch/ops/csrc/
flash_attention_{fwd,bwd}.cu``), emulated on the CPU at the training shape's
2117 tokens on two heads, against the plain versions in
``threedod_torch/ops/attention.py``.

The kernels themselves run only on a card (``tests/test_torch_attention*.py``,
marked ``gpu``); these tests pin what they compute in the working types:

* bf16: P (and in the backward dS) are rounded once to bf16 where they become
  the A operand of the next product, every product sums in f32. The forward
  stays within 2^-7 and each gradient within 2^-6 of its largest entry of the
  plain versions (the card-side tolerances, ``chip_smoke.TOL_ATTN`` and
  ``TOL_ATTN_BWD``; measured 4.9e-3, and 7.1e-3, 4.9e-3, 3.5e-3 for dq, dk,
  dv).
* f32, 3xTF32: x = hi + lo with hi = rna_tf32(x), lo = rna_tf32(x - hi)
  reconstructs x to 2^-21 relative (2^-22 in theory: each rounding keeps
  half an ulp of 10 fraction bits), and the three-pass products (lo hi + hi lo
  + hi hi) keep the forward within 1e-5 and the gradients within 1e-4 of their
  largest entries of the f32 plain versions (measured 1.2e-6, and 1.2e-6,
  1.1e-6, 1.1e-6); one pass would not (8.1e-4 in the forward). The
  emulation sums in f32 with rounding; the tensor cores truncate, which the
  kernels meet with their choice of accumulators (on the card: 6e-7 of the
  largest entry in the forward).
* the fragment layouts of ``mma.sync`` (one lane's registers): the tf32
  accumulator is read as the next product's A in the order {c0, c2, c1, c3}
  with B's rows permuted the same way, and two bf16 accumulator blocks packed
  side by side are one m16n8k16 A fragment; both give the product exactly.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)

from threedod_torch.ops import attention as pattn

S, H = 2117, 2  # the vitl fine-tuning step's tokens (46 * 46 + 1), two of its 16 heads


def _inputs(seed, dtype):
    rng = np.random.RandomState(seed)
    q, k, v, dout = (torch.from_numpy(rng.randn(1, S, H, 64).astype(np.float32)).to(dtype) for _ in range(4))
    return q, k, v, dout


def _rel_err(got, ref):
    return (got.float() - ref.float()).abs().max().item() / ref.float().abs().max().item()


# ---------------- bf16: P and dS rounded once ------------------------------


def _bf16(x):
    return x.to(torch.bfloat16).float()


def test_bf16_forward_rounding_of_p_holds_its_tolerance():
    """The forward kernel: unnormalised probabilities exp(s - m) rounded to
    bf16 before P V, f32 sums, one division and one rounding of the output."""
    q, k, v, _ = _inputs(1, torch.bfloat16)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / 8.0
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    num = torch.einsum("bhqk,bkhd->bqhd", _bf16(p), v.float())
    got = (num / p.sum(-1).permute(0, 2, 1)[..., None]).to(torch.bfloat16)
    err = _rel_err(got, pattn.attention_reference(q, k, v))
    assert 0 < err <= 2.0 ** -7, err


def test_bf16_backward_rounding_of_p_and_ds_holds_its_tolerance():
    """The backward kernels: P rebuilt in f32 from lse, rounded to bf16 for
    dV = P^T dout; dS = P (dP - delta) in f32, rounded to bf16 for dQ = dS K
    and dK = dS^T Q; each gradient rounded once to bf16."""
    q, k, v, dout = _inputs(2, torch.bfloat16)
    out, lse = pattn.attention_forward_reference(q, k, v)
    scale = 1.0 / math.sqrt(64)
    qf, kf, vf, of = q.float(), k.float(), v.float(), dout.float()
    p = torch.exp(torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale - lse[..., None])
    delta = (of * out.float()).sum(-1).permute(0, 2, 1)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", of, vf) - delta[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", _bf16(p), of)
    dq = torch.einsum("bhqk,bkhd->bqhd", _bf16(ds), kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), qf) * scale
    ref = pattn.attention_backward_reference(q, k, v, out, lse, dout)
    for got, r in zip((dq, dk, dv), ref):
        err = _rel_err(got.to(torch.bfloat16), r)
        assert 0 < err <= 2.0 ** -6, err


# ---------------- f32: three TF32 passes -----------------------------------


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: round an f32 tensor to 10 fraction bits, to nearest,
    ties away from zero (the 13 low bits cleared after adding half of them to
    the magnitude)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & -0x80000000
    mag = ((bits & 0x7FFFFFFF) + 0x1000) & ~0x1FFF
    return (sign | mag).view(torch.float32)


def split_tf32(x):
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm3(a, b, eq):
    """einsum ``eq`` of f32 a and b as three TF32 passes, each summed in f32:
    lo_a hi_b + hi_a lo_b + hi_a hi_b."""
    ah, al = split_tf32(a)
    bh, bl = split_tf32(b)
    return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_tf32_split_reconstructs_f32(scale):
    x = torch.from_numpy(np.random.RandomState(3).randn(1 << 16).astype(np.float32) * scale)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()  # 10 fraction bits left
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert ((x - (hi + lo)).abs() <= x.abs() * 2.0 ** -21).all()
    assert ((x - hi).abs() > 0).any()  # hi alone is not x


def test_rna_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # of a tf32 value in [1, 2)
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2.0 ** -23, -(one + ulp / 2), one + 0.75 * ulp],
                     dtype=torch.float32)
    got = rna_tf32(x).tolist()
    assert got == [one + ulp, one, -(one + ulp), one + ulp]


def test_three_pass_forward_holds_the_f32_tolerance():
    q, k, v, _ = _inputs(4, torch.float32)
    logits = mm3(q, k, "bqhd,bkhd->bhqk") / 8.0
    p = torch.softmax(logits, dim=-1)
    got = mm3(p, v, "bhqk,bkhd->bqhd")
    err = _rel_err(got, pattn.attention_reference(q, k, v))
    assert err <= 1e-5, err


def test_three_pass_backward_holds_the_f32_tolerance():
    q, k, v, dout = _inputs(5, torch.float32)
    out, lse = pattn.attention_forward_reference(q, k, v)
    scale = 1.0 / math.sqrt(64)
    p = torch.exp(mm3(q, k, "bqhd,bkhd->bhqk") * scale - lse[..., None])
    delta = (dout * out).sum(-1).permute(0, 2, 1)
    ds = p * (mm3(dout, v, "bqhd,bkhd->bhqk") - delta[..., None])
    got = (mm3(ds, k, "bhqk,bkhd->bqhd") * scale, mm3(ds, q, "bhqk,bqhd->bkhd") * scale,
           mm3(p, dout, "bhqk,bqhd->bkhd"))
    ref = pattn.attention_backward_reference(q, k, v, out, lse, dout)
    for g, r in zip(got, ref):
        err = _rel_err(g, r)
        assert err <= 1e-4, err


def test_one_tf32_pass_would_not():
    """The reason for three passes: one TF32 pass of the forward misses the
    f32 tolerance by far."""
    q, k, v, _ = _inputs(4, torch.float32)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", rna_tf32(q), rna_tf32(k)) / 8.0, dim=-1)
    got = torch.einsum("bhqk,bkhd->bqhd", rna_tf32(p), rna_tf32(v))
    assert _rel_err(got, pattn.attention_reference(q, k, v)) > 1e-4


# ---------------- fragment layouts -----------------------------------------

LANES = [(lane >> 2, lane & 3) for lane in range(32)]  # (g, t)


def _c_frag(c):
    """A 16 x 8 accumulator as each lane holds it: c0, c1 = (g, 2t), (g, 2t + 1),
    c2, c3 = (g + 8, 2t), (g + 8, 2t + 1)."""
    return [[c[g, 2 * t], c[g, 2 * t + 1], c[g + 8, 2 * t], c[g + 8, 2 * t + 1]] for g, t in LANES]


def _mma_tf32(a_regs, b_regs):
    """m16n8k8 from lanes' registers: A (g, t), (g + 8, t), (g, t + 4), (g + 8,
    t + 4); B (k t, n g), (k t + 4, n g)."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for (g, t), ar, br in zip(LANES, a_regs, b_regs):
        a[g, t], a[g + 8, t], a[g, t + 4], a[g + 8, t + 4] = ar
        b[t, g], b[t + 4, g] = br
    return a @ b


def _mma_bf16(a_regs, b_regs):
    """m16n8k16 from lanes' registers: A (g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
    (g + 8, 2t + 8..), two values a register; B (k 2t.., n g), (k 2t + 8.., n g)."""
    a, b = np.zeros((16, 16)), np.zeros((16, 8))
    for (g, t), ar, br in zip(LANES, a_regs, b_regs):
        for i, (r, c) in enumerate(((g, 2 * t), (g + 8, 2 * t), (g, 2 * t + 8), (g + 8, 2 * t + 8))):
            a[r, c:c + 2] = ar[i]
        b[2 * t:2 * t + 2, g], b[2 * t + 8:2 * t + 10, g] = br
    return a @ b


def test_tf32_accumulator_read_as_a_with_permuted_b_rows():
    """tf32_pb: the lane's accumulator {c0, c1, c2, c3} of P (16 x 8) as the A
    fragment {c0, c2, c1, c3}, B's rows 2t and 2t + 1 of column g: P B exactly."""
    rng = np.random.RandomState(6)
    p, b = rng.randn(16, 8), rng.randn(8, 8)
    cf = _c_frag(p)
    a_regs = [(c0, c2, c1, c3) for c0, c1, c2, c3 in cf]
    b_regs = [(b[2 * t, g], b[2 * t + 1, g]) for g, t in LANES]
    np.testing.assert_allclose(_mma_tf32(a_regs, b_regs), p @ b, rtol=1e-12)
    # read as it lies, the accumulator is not the A fragment
    plain = [(b[t, g], b[t + 4, g]) for g, t in LANES]
    assert not np.allclose(_mma_tf32([tuple(c) for c in cf], plain), p @ b)


def test_bf16_accumulators_packed_are_an_a_fragment():
    """bf16_pb and the forward's P V: the accumulators of key blocks 2kk and
    2kk + 1 (16 x 16) packed in pairs are the m16n8k16 A fragment of P."""
    rng = np.random.RandomState(7)
    p, b = rng.randn(16, 16), rng.randn(16, 8)
    lo, hi = _c_frag(p[:, :8]), _c_frag(p[:, 8:])
    a_regs = [((x[0], x[1]), (x[2], x[3]), (y[0], y[1]), (y[2], y[3])) for x, y in zip(lo, hi)]
    b_regs = [((b[2 * t, g], b[2 * t + 1, g]), (b[2 * t + 8, g], b[2 * t + 9, g])) for g, t in LANES]
    np.testing.assert_allclose(_mma_bf16(a_regs, b_regs), p @ b, rtol=1e-12)
