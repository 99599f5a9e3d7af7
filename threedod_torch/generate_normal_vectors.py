"""Per-image ground normals from the depth and ground maps, on a CUDA device
(counterpart of ``tools/generate_normal_vectors.py``).

    python -m threedod_torch.generate_normal_vectors --dataset-json J
        [--depth-dir datasets/depth_maps] [--ground-dir datasets/ground_maps]
        [--out datasets/normal_vectors.json] [--seed 0] [--device cuda]

For every image with a depth map: the point cloud of every fifth pixel, a
RANSAC plane over its points on the ground (all its points where the image
has no ground mask), the normal turned to the floor's side
(``models/boxer.ground_plane_from_depth``). The 1000 three-point hypotheses of
each image are drawn from one generator on the device seeded with
``--seed``. Writes ``{image_id: [nx, ny, nz]}`` rounded to 6 places. Prints
one JSON line: the card, the normals written, the seconds of the pass.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .geometry.plane import RANSAC_HYPOTHESES
from .models.boxer import ground_plane_from_depth
from .train_net import card_name_and_power_limit


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset-json", required=True)
    ap.add_argument("--depth-dir", default="datasets/depth_maps")
    ap.add_argument("--ground-dir", default="datasets/ground_maps")
    ap.add_argument("--out", default="datasets/normal_vectors.json")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    return ap


def normals(data: dict, depth_dir: str, ground_dir: str, device: torch.device,
            hypotheses: Callable[[int, int], torch.Tensor]) -> Dict[str, list]:
    """{image_id: normal} of every image with a depth map; ``hypotheses(i,
    n_points)`` gives the (RANSAC_HYPOTHESES, 3) point indices of the i-th
    such image."""
    out, i = {}, 0
    for im in data["images"]:
        dpath = os.path.join(depth_dir, f"{im['id']}.npz")
        if not os.path.exists(dpath):
            continue
        with np.load(dpath) as z:
            depth = torch.from_numpy(np.asarray(z["depth"], np.float32)).to(device)
        gpath = os.path.join(ground_dir, f"{im['id']}.npz")
        ground = None
        if os.path.exists(gpath):
            with np.load(gpath) as z:
                ground = torch.from_numpy(np.asarray(z["mask"])).to(device)[None]
        K = torch.tensor(im["K"], dtype=torch.float32, device=device)[None]
        h, w = depth.shape
        n_points = (h // 5) * (w // 5)
        normal, _, _ = ground_plane_from_depth(hypotheses(i, n_points)[None], depth[None], K, ground)
        out[str(im["id"])] = np.asarray(normal[0].cpu(), np.float64).round(6).tolist()
        i += 1
    return out


def run(args, device: torch.device, hypotheses: Optional[Callable[[int, int], torch.Tensor]] = None) -> dict:
    """The pass over the dataset. The hypotheses come from a generator on
    ``device`` seeded with ``--seed``, unless ``hypotheses`` gives them (the
    tests replay the JAX tool's key tree)."""
    with open(args.dataset_json) as f:
        data = json.load(f)
    if hypotheses is None:
        gen = torch.Generator(device=device).manual_seed(args.seed)

        def hypotheses(_, n_points):
            return torch.randint(0, n_points, (RANSAC_HYPOTHESES, 3), generator=gen, device=device)

    t0 = time.perf_counter()
    out = normals(data, args.depth_dir, args.ground_dir, device, hypotheses)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f)
    return {"normals": len(out), "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.generate_normal_vectors runs on a CUDA device; '{args.device}' is not "
                           f"available")
    out = run(args, device)
    print(json.dumps({"device": card_name_and_power_limit(device), **out}), flush=True)


if __name__ == "__main__":
    main()
