"""The port's whole inference slice on a torchvision trunk (ResNet18 under
the FPN) vs JAX ``RCNN3D.apply(train=False)``, stage by stage: FPN features,
RPN proposals, 2D detections, 3D cubes.

The stages, the matching of sets and every tolerance are those of
``tests/test_torch_rcnn3d.py`` (features to 1e-4 of the largest entry, boxes
to 1e-4 relative / 1e-3 px, 3D fields to 2e-4 relative): its test functions
run here against this file's ``slice_run``, which builds both models on
``resnet18``. One whole JAX model is compiled, once. The class-score kernel
is scaled by 3, not 50: this trunk's seeded features are larger, and at 50
every ROI saturates into background and nothing is left to compare.
"""
from __future__ import annotations

import pytest

import _torch_port  # noqa: F401  (one torch thread per test worker)
from test_torch_rcnn3d import run_slice, test_cubes, test_detections, test_features, test_proposals  # noqa: F401


@pytest.fixture(scope="module")
def slice_run():
    return run_slice("resnet18", predictor_scale=3.0)


def test_the_port_model_is_built_on_resnet18(slice_run):
    assert sorted(slice_run["pfeats"]) == ["p2", "p3", "p4", "p5", "p6"]
    assert all(v.shape[1] == 256 for v in slice_run["pfeats"].values())
    assert slice_run["pdet"].valid.sum() >= 20
