"""The port's deformable sampling (``threedod_torch/ops/ms_deform.py``, kernel
K3) and ``MSDeformAttn`` vs the JAX package's, f32 on the CPU.

* The plain version of K3 against the three JAX backends,
  ``ms_deform_sample_gather``, ``ms_deform_sample_matmul`` and
  ``ms_deform_sample_pallas(interpret=True, chunk=3)`` (the Pallas kernel in
  interpret mode, as tests/test_gdino.py runs it), on three levels (one not
  square), an odd Lq and locations in [-0.2, 1.2], and on one level with one
  point a head: atol 1e-5 (f32 sums of 12 samples of 4 taps in other orders,
  outputs of order 1); the plain version takes any head width;
* locations far off the map (+-1e4) read zeros, where the JAX backends agree:
  this pins the clamp of the corner before its conversion to an integer;
* ``MSDeformAttn`` with 2-d (point) and 4-d (box) references, with and
  without a value mask, against the JAX module on the same numpy-made
  weights: atol 1e-5; the samples land inside the maps, across their borders
  and outside;
* the wrapper checks shapes, dtypes and devices, counts no launch and builds
  nothing for CPU tensors;
* on a CUDA card only (marked ``gpu``): K3 against its plain version in f32
  (1e-5 of the largest entry) and bf16 (2^-7 of the largest entry), with
  locations far off the map among them, and the wrapper raising on a head
  width that is not a multiple of 4.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (one torch thread per test worker)

import jax
import jax.numpy as jnp

from threedod_torch.models.gdino.deformable import MSDeformAttn
from threedod_torch.ops import ms_deform

SHAPES = [(6, 8), (3, 5), (2, 2)]
S = sum(h * w for h, w in SHAPES)
ONE_LEVEL = [(5, 7)]  # one level, one point a head, a head width of 4


def _inputs(seed, b=2, lq=7, h=2, d=8, p=3, lo=-0.2, hi=1.2, shapes=SHAPES):
    rng = np.random.RandomState(seed)
    value = rng.randn(b, sum(hl * wl for hl, wl in shapes), h, d).astype(np.float32)
    locs = rng.uniform(lo, hi, (b, lq, h, len(shapes), p, 2)).astype(np.float32)
    w = rng.rand(b, lq, h, len(shapes), p).astype(np.float32)
    return value, locs, w


def _port(value, locs, w, shapes=SHAPES):
    return ms_deform.ms_deform_sample(torch.from_numpy(value), shapes, torch.from_numpy(locs),
                                      torch.from_numpy(w)).numpy()


def _jdfm():
    """The JAX module, imported where a test needs it: it imports flax, which
    the card's machine lacks, and the ``gpu`` tests of this file run there."""
    from threedod.models.gdino import deformable

    return deformable


def _jax(backend, value, locs, w, shapes=SHAPES):
    jdfm = _jdfm()
    fn = {"gather": jdfm.ms_deform_sample_gather, "matmul": jdfm.ms_deform_sample_matmul,
          "pallas_interpret": lambda *a: jdfm.ms_deform_sample_pallas(*a, chunk=3, interpret=True)}[backend]
    return np.asarray(jax.jit(lambda v, l, a: fn(v, shapes, l, a))(value, locs, w))


CASES = {"three_levels": dict(), "one_level": dict(b=1, lq=3, h=3, d=4, p=1, shapes=ONE_LEVEL)}


@pytest.mark.parametrize("backend", ["gather", "matmul", "pallas_interpret"])
@pytest.mark.parametrize("far", [False, True], ids=["in_range", "far_off_the_map"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_k3_matches_jax(backend, far, case):
    kw = CASES[case]
    shapes = kw.get("shapes", SHAPES)
    value, locs, w = _inputs(seed=3, **kw)
    if far:  # whole queries and single samples thrown far off, both ways
        locs[0, 1] = 1e4
        locs[-1, 2] = -1e4
        locs[0, 0, -1, -1, 0] = (-1e4, 0.5)
    ref = _jax(backend, value, locs, w, shapes)
    got = _port(value, locs, w, shapes)
    assert got.shape == locs.shape[:3] + value.shape[3:] and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-5)
    if far:
        assert not got[0, 1].any() and not got[-1, 2].any()


def test_plain_k3_takes_any_head_width():
    """The plain version has no vector width: a head of 6 channels (which the
    kernel refuses) matches the JAX gather."""
    value, locs, w = _inputs(seed=8, d=6)
    np.testing.assert_allclose(_port(value, locs, w), _jax("gather", value, locs, w), atol=1e-5)


def test_bf16_sums_in_f32_and_rounds_once():
    value, locs, w = _inputs(seed=4)
    v16, w16 = torch.from_numpy(value).bfloat16(), torch.from_numpy(w).bfloat16()
    got = ms_deform.ms_deform_sample(v16, SHAPES, torch.from_numpy(locs), w16)
    want = ms_deform.ms_deform_sample_reference(v16.float(), SHAPES, torch.from_numpy(locs), w16.float())
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.bfloat16())


# ---------------- MSDeformAttn against the JAX module ----------------------

DIM, HEADS, POINTS = 32, 4, 2


@pytest.fixture(scope="module")
def attn_params():
    """Numpy weights in the shape of the JAX module's (lecun-normal kernels,
    biases of std 0.05), and the port module loaded from them."""
    module = _jdfm().MSDeformAttn(DIM, HEADS, len(SHAPES), POINTS)
    shapes = jax.eval_shape(lambda q, r, v: module.init(jax.random.PRNGKey(0), q, r, v, SHAPES), jnp.zeros((1, 5, DIM)),
                            jnp.zeros((1, 5, len(SHAPES), 2)), jnp.zeros((1, S, DIM)))["params"]
    rng = np.random.RandomState(0)
    params = {name: {"kernel": (rng.randn(*leaf["kernel"].shape) / np.sqrt(DIM)).astype(np.float32),
                     "bias": rng.normal(0, 0.05, leaf["bias"].shape).astype(np.float32)}
              for name, leaf in shapes.items()}
    port = MSDeformAttn(DIM, HEADS, len(SHAPES), POINTS)
    port.load_state_dict({f"{n}.{k}": torch.from_numpy(np.ascontiguousarray(v))
                          for n, leaf in params.items()
                          for k, v in (("weight", leaf["kernel"].T), ("bias", leaf["bias"]))}, strict=True)
    return module, params, port


@pytest.mark.parametrize("masked", [False, True], ids=["no_value_mask", "value_mask"])
@pytest.mark.parametrize("ref_dim", [2, 4], ids=["point_refs", "box_refs"])
def test_msdeformattn_matches_jax(attn_params, ref_dim, masked):
    module, params, port = attn_params
    rng = np.random.RandomState(ref_dim)
    query = rng.randn(2, 9, DIM).astype(np.float32)
    value = rng.randn(2, S, DIM).astype(np.float32)
    if ref_dim == 2:
        refs = rng.uniform(0, 1, (2, 9, len(SHAPES), 2)).astype(np.float32)
    else:
        refs = np.concatenate([rng.uniform(0.2, 0.8, (2, 9, 1, 2)), rng.uniform(0.05, 0.6, (2, 9, 1, 2))], -1)
        refs = np.broadcast_to(refs, (2, 9, len(SHAPES), 4)).astype(np.float32)
    mask = rng.rand(2, S) > 0.1 if masked else None
    ref = jax.jit(lambda p, q, r, v, m: module.apply({"params": p}, q, r, v, SHAPES, value_mask=m))(
        params, query, refs, value, mask)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in (query, refs, value)), SHAPES,
                   value_mask=None if mask is None else torch.from_numpy(mask))
    assert got.shape == (2, 9, DIM) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_msdeformattn_samples_land_inside_across_and_outside(attn_params):
    """The seeded weights spread the samples: some fall inside a map, some
    straddle its border, some lie outside it, so every branch of the sampler
    is exercised by the module tests."""
    _, _, port = attn_params
    rng = np.random.RandomState(2)
    query = torch.from_numpy(rng.randn(2, 9, DIM).astype(np.float32))
    refs = torch.from_numpy(rng.uniform(0, 1, (2, 9, len(SHAPES), 2)).astype(np.float32))
    with torch.no_grad():
        off = port.sampling_offsets(query).reshape(2, 9, HEADS, len(SHAPES), POINTS, 2)
    inside = across = outside = 0
    for lvl, (hl, wl) in enumerate(SHAPES):
        loc = refs[:, :, None, lvl, None, :] + off[:, :, :, lvl] / torch.tensor([wl, hl])
        x, y = loc[..., 0] * wl - 0.5, loc[..., 1] * hl - 0.5
        full = (x >= 0) & (x <= wl - 1) & (y >= 0) & (y <= hl - 1)
        none = (x <= -1) | (x >= wl) | (y <= -1) | (y >= hl)
        inside, outside = inside + int(full.sum()), outside + int(none.sum())
        across += int((~full & ~none).sum())
    assert min(inside, across, outside) > 0, (inside, across, outside)


# ---------------- the wrapper ----------------------------------------------


def test_bad_inputs_raise():
    value, locs, w = (torch.from_numpy(a) for a in _inputs(seed=5))
    with pytest.raises(ValueError, match="do not cover"):
        ms_deform.ms_deform_sample(value, SHAPES[:2] + [(3, 3)], locs, w)
    with pytest.raises(ValueError, match="do not match"):
        ms_deform.ms_deform_sample(value, SHAPES, locs[:, :3], w)
    with pytest.raises(TypeError, match="value's dtype"):
        ms_deform.ms_deform_sample(value, SHAPES, locs, w.double())
    with pytest.raises(TypeError, match="locations must be float32"):
        ms_deform.ms_deform_sample(value.bfloat16(), SHAPES, locs.bfloat16(), w.bfloat16())
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ms_deform.ms_deform_sample(value.half(), SHAPES, locs, w.half())
    m = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA or CPU"):  # no silent fallback on another device
        ms_deform.ms_deform_sample(m(value), SHAPES, m(locs), m(w))
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        ms_deform.ms_deform_sample_cuda(value, SHAPES, locs, w)


def test_cpu_tensors_count_no_launch_and_build_nothing():
    from threedod_torch.ops import _build

    before, built = ms_deform.LAUNCHES, _build.load.cache_info().currsize
    value, locs, w = _inputs(seed=6)
    _port(value, locs, w)
    assert ms_deform.LAUNCHES == before and _build.load.cache_info().currsize == built


# ---------------- on the card ----------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("b,lq,h,d,p", [(2, 7, 2, 8, 3), (1, 300, 8, 32, 4), (3, 33, 3, 12, 5), (1, 50, 2, 64, 2)])
def test_k3_on_card(b, lq, h, d, p, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("the deformable-sampling kernel needs a CUDA card")
    value, locs, w = _inputs(seed=lq, b=b, lq=lq, h=h, d=d, p=p)
    locs[0, 0] = 1e9  # far off the map: an unclamped conversion to int overflows
    locs[-1, -1, 0, 0, 0] = (-1e9, 0.5)
    dev = torch.device("cuda")
    value_t, w_t = (torch.from_numpy(a).to(dev, dtype) for a in (value, w))
    locs_t = torch.from_numpy(locs).to(dev)
    before = ms_deform.LAUNCHES
    out = ms_deform.ms_deform_sample(value_t, SHAPES, locs_t, w_t)
    torch.cuda.synchronize()
    assert ms_deform.LAUNCHES == before + 1
    ref = ms_deform.ms_deform_sample_reference(value_t, SHAPES, locs_t, w_t)
    assert out.shape == ref.shape == (b, lq, h, d) and out.dtype == dtype
    assert bool(torch.isfinite(out.float()).all()) and not out[0, 0].any()
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.gpu
def test_k3_refuses_a_head_width_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("the deformable-sampling kernel needs a CUDA card")
    value, locs, w = (torch.from_numpy(a).cuda() for a in _inputs(seed=7, d=6))
    with pytest.raises(ValueError, match="multiple of 4"):
        ms_deform.ms_deform_sample(value, SHAPES, locs, w)
