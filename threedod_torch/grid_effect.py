"""The IoU3D a yaw grid's discretisation costs: the port's counterpart of
``tools/grid_effect.py`` (ProposalNetwork/proposals/grid_effect.py of the
reference).

    python -m threedod_torch.grid_effect [--device cuda]

The ``propose`` sampler sets yaw on a 36-step grid (10 degrees,
proposals.py:400-407). A unit cube turned about y by 1.25, 2.5 and 5 degrees
is held against the unturned one with ``geometry/iou3d.box3d_overlap`` on
``--device``, and 1 - IoU is printed for each, in the JAX tool's words.
``run(device)`` returns the three losses.
"""
from __future__ import annotations

import argparse
import math

import torch

from .geometry.cuboids import cuboid_verts
from .geometry.iou3d import box3d_overlap
from .geometry.rotations import euler_to_matrix

DEGREES = (1.25, 2.5, 5.0)


def run(device) -> dict:
    device = torch.device(device)
    center_dims = torch.tensor([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0]], device=device)
    unit = cuboid_verts(center_dims, euler_to_matrix(torch.zeros(3, device=device))[None])
    losses = {}
    for deg in DEGREES:
        euler = torch.tensor([0.0, math.radians(deg), 0.0], device=device)
        _, iou = box3d_overlap(unit, cuboid_verts(center_dims, euler_to_matrix(euler)[None]))
        losses[deg] = 1.0 - float(iou[0, 0])
        print(f"Difference in IoU due to rotation grid ({deg:5.2f} deg): {losses[deg]:.4f}", flush=True)
    return losses


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.grid_effect runs on a CUDA device; '{args.device}' is not available")
    return run(device)


if __name__ == "__main__":
    main()
