"""The port's matcher, rank selection and subsamplers vs the JAX package.

Same numpy inputs on both sides. The subsamplers get the same Gumbel noise:
it is drawn with JAX from the key the JAX function is called with
(``split`` then ``gumbel``, as ``subsample_fg_bg`` does) and handed to the
port. Index outputs must be identical, order included; IoUs agree to 1e-6
(one division).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import _torch_port as tp

import jax
import jax.numpy as jnp

from threedod.ops import matcher as jm
from threedod.ops.order_stats import top_take_mask as jax_top_take_mask

from threedod_torch.ops import matcher as pm
from threedod_torch.ops.order_stats import top_take_mask


def _case(seed, r=300, m=6):
    rng = np.random.RandomState(seed)
    gxy = rng.uniform(0, 60, (m, 2))
    gt = np.concatenate([gxy, gxy + rng.uniform(8, 40, (m, 2))], -1).astype(np.float32)
    cxy = rng.uniform(-5, 80, (r, 2))
    cand = np.concatenate([cxy, cxy + rng.uniform(2, 50, (r, 2))], -1).astype(np.float32)
    cand[:m] = gt  # exact copies: IoU 1, and ties for the best candidate
    cand[m] = gt[0]
    cand[m + 1] = 0.0  # an empty box
    gt_valid = np.array([True] * (m - 2) + [False, True])
    gt_ignore = np.array([False] * (m - 1) + [True])
    return gt, gt_valid & ~gt_ignore, gt_ignore, cand


@pytest.mark.parametrize("seed,low_quality,thresholds", [
    (0, True, (0.05, 0.05)), (1, False, (0.5, 0.5)), (2, True, (0.3, 0.7)), (3, False, (0.3, 0.7))])
def test_match_and_ignore(seed, low_quality, thresholds):
    gt, valid, ignore, cand = _case(seed)
    ref, ref_ign = jax.jit(lambda *a: jm.match_and_ignore(
        *a, thresholds[0], thresholds[1], 0.5, allow_low_quality=low_quality))(gt, valid, ignore, cand)
    got, got_ign = pm.match_and_ignore(
        torch.from_numpy(gt), torch.from_numpy(valid), torch.from_numpy(ignore), torch.from_numpy(cand),
        thresholds[0], thresholds[1], 0.5, allow_low_quality=low_quality)
    np.testing.assert_array_equal(got.matched_idxs.numpy(), np.asarray(ref.matched_idxs))
    np.testing.assert_array_equal(got.matched_labels.numpy(), np.asarray(ref.matched_labels))
    np.testing.assert_allclose(got.matched_ious.numpy(), np.asarray(ref.matched_ious), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.forced.numpy(), np.asarray(ref.forced))
    np.testing.assert_array_equal(got_ign.numpy(), np.asarray(ref_ign))
    assert set(got.matched_labels.tolist()) >= {0, 1} and got_ign.any()


def test_match_without_ground_truth():
    gt, _, _, cand = _case(4)
    none = np.zeros(len(gt), bool)
    ref, ref_ign = jax.jit(lambda *a: jm.match_and_ignore(*a, 0.3, 0.7, 0.5, allow_low_quality=True))(
        gt, none, none, cand)
    got, got_ign = pm.match_and_ignore(torch.from_numpy(gt), torch.from_numpy(none), torch.from_numpy(none),
                                       torch.from_numpy(cand), 0.3, 0.7, 0.5, allow_low_quality=True)
    assert not got.matched_labels.any() and not got_ign.any() and not got.matched_ious.any()
    np.testing.assert_array_equal(got.matched_labels.numpy(), np.asarray(ref.matched_labels))
    np.testing.assert_array_equal(got_ign.numpy(), np.asarray(ref_ign))


@pytest.mark.parametrize("take", [0, 1, 5, 40, 1000])
def test_top_take_mask_same_set_with_ties(take):
    rng = np.random.RandomState(take)
    values = rng.randn(3, 200).astype(np.float32)
    values[:, 50:60] = values[:, 49:50]  # ten values tied with another
    values[1, :] = np.round(values[1, :], 1)  # many ties, some at the threshold
    mask = rng.rand(3, 200) > 0.3
    mask[2] = False  # nothing to take from
    takes = np.array([take, take, take], np.int32)
    ref = np.asarray(jax.jit(jax_top_take_mask)(values, mask, takes))
    got = top_take_mask(torch.from_numpy(values), torch.from_numpy(mask), torch.from_numpy(takes).long())
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.sum() >= min(take, mask[0].sum())


@pytest.mark.parametrize("seed,num_samples,fraction", [
    (0, 32, 0.25), (1, 32, 1.0), (2, 256, 0.25), (3, 300, 0.5), (4, 16, 0.0)])
def test_subsample_fg_bg_shared_noise(seed, num_samples, fraction):
    rng = np.random.RandomState(seed)
    r = 300
    labels = rng.choice([-1, 0, 1], r, p=[0.2, 0.6, 0.2]).astype(np.int32)
    ious = np.where(labels == 1, rng.uniform(0.5, 1, r), rng.uniform(0, 0.5, r)).astype(np.float32)
    ious[labels == 0][:20] = 0.0
    key = jax.random.PRNGKey(seed)
    ref_idx, ref_fg, ref_valid = jax.jit(lambda k, l, i: jm.subsample_fg_bg(k, l, i, num_samples, fraction))(
        key, labels, ious)
    kf, kb = jax.random.split(key)
    noise = tuple(torch.from_numpy(np.asarray(jax.random.gumbel(k, (r,)))) for k in (kf, kb))
    idx, fg, valid = pm.subsample_fg_bg(noise, torch.from_numpy(labels), torch.from_numpy(ious), num_samples, fraction)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(ref_valid))
    np.testing.assert_array_equal(fg.numpy(), np.asarray(ref_fg))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))  # the unfilled tail too: index order
    n_fg = int(fg.sum())
    assert fg[:n_fg].all() and n_fg == min(int(num_samples * fraction), int((labels == 1).sum()))


def test_sampler_noise_helper_matches_vmapped_keys():
    """``_torch_port.sampler_noise`` rebuilds what the models' per-image vmap draws."""
    key = jax.random.PRNGKey(9)
    labels = jnp.asarray(np.random.RandomState(0).choice([0, 1], (2, 50)).astype(np.int32))
    ious = jnp.full((2, 50), 0.5)
    ref = jax.jit(jax.vmap(lambda k, l, i: jm.subsample_fg_bg(k, l, i, 8, 0.5)))(jax.random.split(key, 2), labels, ious)
    fg, bg = tp.sampler_noise(key, 2, 50)
    for i in range(2):
        idx, _, _ = pm.subsample_fg_bg((fg[i], bg[i]), torch.from_numpy(np.asarray(labels[i])),
                                       torch.from_numpy(np.asarray(ious[i])), 8, 0.5)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0][i]))


def test_subsample_with_generator_fills_foreground_prefix():
    g = torch.Generator().manual_seed(0)
    labels = torch.tensor([1] * 10 + [0] * 100 + [-1] * 10)
    ious = torch.cat([torch.full((10,), 0.8), torch.rand(110, generator=g) * 0.4])
    idx, fg, valid = pm.subsample_fg_bg(g, labels, ious, 32, 0.25)
    assert valid.all() and fg[:8].all() and not fg[8:].any()
    assert len(set(idx.tolist())) == 32 and (labels[idx[8:]] == 0).all()
    idx2, _, _ = pm.subsample_fg_bg(g, labels, ious, 32, 0.25)
    assert idx.tolist() != idx2.tolist()  # the generator moved on
