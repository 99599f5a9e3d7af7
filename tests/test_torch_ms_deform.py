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
* ``sample_plan``, the kernel's choice by shape: the staged levels fit a
  block's shared memory in each dtype, GroundingDINO's decoder shape gets the
  split, the vector width follows D, the dtype and the alignment, other L
  and P (or unaligned vectors) take the generic kernel; every design of the
  kernel's trial (``threedod_torch/tools/k3_designs.py``) still applies to
  its source;
* the wrapper checks shapes, dtypes and devices, counts no launch and builds
  nothing for CPU tensors, and the kernel refuses a gradient (it has no
  backward) before it checks the device, while the plain version on the CPU
  stays differentiable;
* on a CUDA card only (marked ``gpu``): K3 against its plain version in f32
  (1e-5 of the largest entry) and bf16 (2^-7 of the largest entry) in every
  variant the plan can choose, with locations far off the map among them,
  the wrapper raising on a head width that is not a multiple of 4, and the
  kernel refusing a gradient.
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
from threedod_torch.tools import k3_designs

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


# ---------------- the kernel's plan ----------------------------------------


GDINO_LEVELS = [(100, 100), (50, 50), (25, 25), (13, 13)]  # GroundingDINO's levels at 800x800
H100_SMS = 132  # the streaming multiprocessors of an H100 SXM, which the wrapper reads from the card


def _level_bytes(shapes, d, itemsize):
    return [hl * wl * d * itemsize for hl, wl in shapes]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shapes,lq,h,d,b", [
    (GDINO_LEVELS, 13294, 8, 32, 1), (GDINO_LEVELS, 13294, 8, 64, 1), (GDINO_LEVELS, 30000, 4, 128, 1),
    ([(64, 64), (32, 32), (16, 16), (8, 8)], 5461, 8, 32, 2), ([(20, 20), (10, 10), (5, 5), (3, 3)], 9001, 8, 32, 1),
])
def test_plan_stages_what_fits_a_block(shapes, lq, h, d, b, dtype):
    """The staged levels are the coarsest ones, their bytes are the plan's
    shared memory, and that fits the 227 KB a block can have."""
    plan = ms_deform.sample_plan(shapes, lq, h, d, dtype, sms=H100_SMS, b=b)
    assert plan.kind == "staged" and plan.per_pair == max(1, H100_SMS // (b * h))
    sizes = _level_bytes(shapes, d, torch.empty((), dtype=dtype).element_size())
    assert plan.smem_bytes == sum(sizes[len(shapes) - plan.staged:]) <= ms_deform.STAGE_BYTES <= 232448
    if plan.staged < len(shapes):  # the next level would not fit
        assert plan.smem_bytes + sizes[len(shapes) - plan.staged - 1] > ms_deform.STAGE_BYTES or \
            sizes[len(shapes) - plan.staged - 1] * ms_deform.STAGE_GAIN > -(-lq // plan.per_pair) * 4 * 4 * d * \
            torch.empty((), dtype=dtype).element_size()


def test_plan_at_groundingdino_shapes():
    """The encoder's launch stages levels 2 and 3 (50.8 KB in bf16, 101.6 KB
    in f32: level 1 would pass the 128 KB budget in both) with one 16-byte
    vector a lane; the decoder's 900 queries split the levels over lane
    groups of two 16-byte vectors a lane."""
    enc16 = ms_deform.sample_plan(GDINO_LEVELS, 13294, 8, 32, torch.bfloat16, sms=H100_SMS)
    enc32 = ms_deform.sample_plan(GDINO_LEVELS, 13294, 8, 32, torch.float32, sms=H100_SMS)
    assert enc16 == ms_deform.SamplePlan("staged", 16, 4, 1, 2, 50816, 16)
    assert enc32 == ms_deform.SamplePlan("staged", 16, 8, 1, 2, 101632, 16)
    for dtype, lanes in ((torch.bfloat16, 2), (torch.float32, 4)):
        plan = ms_deform.sample_plan(GDINO_LEVELS, 900, 8, 32, dtype, sms=H100_SMS)
        assert plan == ms_deform.SamplePlan("split", 16, lanes, 2)


@pytest.mark.parametrize("sms,lq,want", [(H100_SMS, 900, "split"), (H100_SMS, 8447, "split"),
                                         (H100_SMS, 8448, "staged"), (66, 4223, "split"), (66, 4224, "staged")])
def test_plan_splits_while_the_pairs_cannot_fill_the_card(sms, lq, want):
    """bf16 at D = 32 splits while B * Lq * H pairs of two lanes stay under
    1024 lanes an SM of the card, and a card with fewer SMs moves the
    threshold and the blocks a staged (image, head) takes with them."""
    plan = ms_deform.sample_plan(GDINO_LEVELS, lq, 8, 32, torch.bfloat16, sms=sms)
    assert plan.kind == want
    if want == "staged":
        assert plan.per_pair == sms // 8


def test_plan_does_not_split_past_a_warp():
    """f32 at D = 128 takes 16 lanes a (query, head) with two vectors a lane:
    four levels' lane groups would not fit one warp, so even a small call is
    staged (32 lanes of one vector)."""
    plan = ms_deform.sample_plan(GDINO_LEVELS, 900, 8, 128, torch.float32, sms=H100_SMS)
    assert plan.kind == "staged" and plan.lanes == 32


@pytest.mark.parametrize("d,h,dtype,value_align,vec_bytes,vectors", [
    (32, 8, torch.bfloat16, 16, 16, 4), (32, 8, torch.float32, 16, 16, 8),
    (12, 3, torch.bfloat16, 16, 8, 3),  # 24-byte runs in 72-byte rows: no 16-byte lane
    (12, 3, torch.float32, 16, 16, 3), (8, 2, torch.bfloat16, 16, 16, 1), (64, 8, torch.bfloat16, 16, 16, 8),
    (32, 8, torch.bfloat16, 8, 8, 8),  # value starts on an 8-byte boundary only
    (256, 1, torch.float32, 16, 16, 64),
])
@pytest.mark.parametrize("lq,points", [(900, 4), (13294, 4), (900, 2)], ids=["split", "staged", "generic"])
def test_plan_vector_follows_head_width_and_alignment(d, h, dtype, value_align, vec_bytes, vectors, lq, points):
    """The vector width follows D, the dtype and value's alignment; the lanes
    of a (query, head), each loading the kind's vectors a lane, cover its D
    channels: a power of two, at most 32 (a lane loops over the rest)."""
    plan = ms_deform.sample_plan(GDINO_LEVELS, lq, h, d, dtype, sms=H100_SMS, points=points,
                                 value_align=value_align)
    per_lane = plan.vectors
    assert per_lane == ms_deform.VECTORS_A_LANE[plan.kind] == (2 if plan.kind == "split" else 1)
    want = min(32, 1 << (-(-vectors // per_lane) - 1).bit_length())
    assert (plan.vec_bytes, plan.lanes) == (vec_bytes, want)
    assert plan.lanes * per_lane >= vectors or plan.lanes == 32


@pytest.mark.parametrize("shapes,points,vectors_align", [
    (SHAPES, 4, 16), (GDINO_LEVELS, 2, 16), (GDINO_LEVELS + [(7, 7)], 4, 16), (GDINO_LEVELS, 4, 8)])
def test_plan_takes_the_generic_kernel_off_groundingdinos_shape(shapes, points, vectors_align):
    """(L, P) other than (4, 4), or locations or weights not 16-byte aligned."""
    plan = ms_deform.sample_plan(shapes, 13294, 8, 32, torch.bfloat16, sms=H100_SMS, points=points,
                                 vectors_align=vectors_align)
    assert plan.kind == "generic" and plan.staged == 0


def test_plan_gathers_a_level_too_large_to_stage():
    """A coarsest-placed level larger than a block's shared memory stops the
    staging: the staged kernel gathers every level from memory."""
    plan = ms_deform.sample_plan([(100, 100), (50, 50), (25, 25), (120, 120)], 9001, 8, 32, torch.bfloat16,
                                 sms=H100_SMS)
    assert plan.kind == "staged" and plan.staged == 0 and plan.smem_bytes == 0


def test_plan_stages_nothing_for_too_few_queries_a_block():
    """Staging pays only where a block gathers each staged level several times
    over: B * H = 1696 pairs leave one block a pair and 40 queries each."""
    plan = ms_deform.sample_plan(GDINO_LEVELS, 40, 8, 32, torch.bfloat16, sms=H100_SMS, b=212)
    assert plan.kind == "staged" and plan.per_pair == 1 and plan.staged == 0



@pytest.mark.parametrize("name", sorted(k3_designs.DESIGNS))
def test_design_trial_variants_apply_to_the_kernel_source(name):
    """Each design of the trial (``threedod_torch/tools/k3_designs.py``,
    which times the kernel's alternatives for ``PERF.md``) still applies to
    the committed source: every replaced text is found as often as the
    design says, and a design changes the source or a plan constant that
    ``ms_deform`` has."""
    replacements, consts = k3_designs.DESIGNS[name]
    src = k3_designs.design_source(replacements)
    assert (src != k3_designs.SOURCE.read_text()) == bool(replacements)
    assert all(hasattr(ms_deform, k) for k in consts)
    assert replacements or consts or name == "committed"


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


def test_k3_refuses_a_gradient_before_the_device_check():
    """K3 has no backward: asked for a gradient it raises, before it looks at
    the device, so this check runs here; without grad mode or without an input
    that requires one, the device check comes next. The plain version stays
    differentiable."""
    value, locs, w = (torch.from_numpy(a) for a in _inputs(seed=8))
    for wants in (value, locs, w):
        args = [t.clone().requires_grad_(t is wants) for t in (value, locs, w)]
        with pytest.raises(RuntimeError, match="no backward"):
            ms_deform.ms_deform_sample_cuda(args[0], SHAPES, args[1], args[2])
        with torch.no_grad(), pytest.raises(ValueError, match="takes CUDA tensors"):
            ms_deform.ms_deform_sample_cuda(args[0], SHAPES, args[1], args[2])
    v = value.clone().requires_grad_(True)
    out = ms_deform.ms_deform_sample(v, SHAPES, locs, w)  # a CPU tensor: the plain version
    out.sum().backward()
    assert out.grad_fn is not None and v.grad.abs().max() > 0


# ---------------- on the card ----------------------------------------------


SMALL4 = [(20, 20), (10, 10), (5, 5), (3, 3)]
TOO_LARGE = [(100, 100), (50, 50), (25, 25), (120, 120)]  # the coarsest-placed level is too large to stage
# name -> (b, lq, h, d, p, levels, the variant sample_plan picks in both dtypes)
CARD_CASES = {
    "three_levels_p3": (2, 7, 2, 8, 3, SHAPES, "generic"),
    "three_levels_h8": (1, 300, 8, 32, 4, SHAPES, "generic"),
    "three_levels_d12_p5": (3, 33, 3, 12, 5, SHAPES, "generic"),
    "three_levels_d64_p2": (1, 50, 2, 64, 2, SHAPES, "generic"),
    "gdino_p2": (1, 100, 8, 32, 2, GDINO_LEVELS, "generic"),
    "gdino_decoder": (1, 900, 8, 32, 4, GDINO_LEVELS, "split"),
    "gdino_encoder": (1, 13294, 8, 32, 4, GDINO_LEVELS, "staged"),  # Lq not a multiple of the query tile
    "staged_all_levels_ragged": (1, 9001, 8, 32, 4, SMALL4, "staged"),
    "level_too_large_to_stage": (1, 9001, 8, 32, 4, TOO_LARGE, "staged"),
    "d12_split": (1, 300, 3, 12, 4, SMALL4, "split"),
    "d12_staged": (1, 23000, 3, 12, 4, SMALL4, "staged"),
    "b2_split": (2, 100, 8, 32, 4, GDINO_LEVELS, "split"),
    "b2_staged": (2, 4500, 8, 32, 4, SMALL4, "staged"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -7)])
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_k3_on_card(case, dtype, tol):
    """Every variant sample_plan can choose, against the plain version: f32 to
    1e-5 of the largest entry (sums in another order), bf16 to 2^-7 (one
    rounding); whole queries and single samples at +-1e9 read zeros."""
    if not torch.cuda.is_available():
        pytest.skip("the deformable-sampling kernel needs a CUDA card")
    b, lq, h, d, p, shapes, kind = CARD_CASES[case]
    sms = ms_deform.card_sms(torch.device("cuda", 0))
    assert ms_deform.sample_plan(shapes, lq, h, d, dtype, sms=sms, b=b, points=p).kind == kind
    value, locs, w = _inputs(seed=lq, b=b, lq=lq, h=h, d=d, p=p, shapes=shapes)
    locs[0, 0] = 1e9  # far off the map: an unclamped conversion to int overflows
    locs[-1, -1, 0, 0, 0] = (-1e9, 0.5)
    dev = torch.device("cuda")
    value_t, w_t = (torch.from_numpy(a).to(dev, dtype) for a in (value, w))
    locs_t = torch.from_numpy(locs).to(dev)
    before = ms_deform.LAUNCHES
    out = ms_deform.ms_deform_sample(value_t, shapes, locs_t, w_t)
    torch.cuda.synchronize()
    assert ms_deform.LAUNCHES == before + 1
    ref = ms_deform.ms_deform_sample_reference(value_t, shapes, locs_t, w_t)
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


@pytest.mark.gpu
def test_k3_refuses_a_gradient_on_card():
    if not torch.cuda.is_available():
        pytest.skip("the deformable-sampling kernel needs a CUDA card")
    value, locs, w = (torch.from_numpy(a).cuda() for a in _inputs(seed=9))
    before = ms_deform.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        ms_deform.ms_deform_sample(value.requires_grad_(True), SHAPES, locs, w)
    with torch.no_grad():
        assert ms_deform.ms_deform_sample(value, SHAPES, locs, w).shape == (2, 7, 2, 8)
    assert ms_deform.LAUNCHES == before + 1
