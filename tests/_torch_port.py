"""Shared set-up of the PyTorch-port parity tests (tests/test_torch_*.py).

One small configuration for both packages (64x96 canvas, batch 2, 5 classes,
few proposals): at that size p5 is 2x3 and p6 is 1x2, so the FPN's
non-integer nearest step is exercised. Inputs are made with numpy from a
seed and handed to JAX and to the port. Torch runs on one thread per test
worker.
"""
from __future__ import annotations

import numpy as np
import torch

torch.set_num_threads(1)

OVERRIDES = {
    "model.dtype": "float32",
    "model.roi_heads.num_classes": 5,
    "model.rpn.post_nms_topk_test": 64,
    "shapes.canvas_height": 64,
    "shapes.canvas_width": 96,
    "shapes.nms_candidates": 128,
    "shapes.max_detections": 16,
}


def _apply(cfg, overrides):
    for path, value in overrides.items():
        *parents, leaf = path.split(".")
        node = cfg
        for p in parents:
            node = getattr(node, p)
        setattr(node, leaf, value)
    return cfg


def configs(**extra):
    """(JAX Config, port Config) with the same small overrides."""
    from threedod.config import Config as JaxConfig

    from threedod_torch.config import Config

    over = {**OVERRIDES, **extra}
    return _apply(JaxConfig(), over), _apply(Config(), over)


def inputs(seed: int = 7):
    """uint8 images zeroed beyond each image's extent, image_hw, K, ratio."""
    h, w = OVERRIDES["shapes.canvas_height"], OVERRIDES["shapes.canvas_width"]
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (2, h, w, 3)).astype(np.uint8)
    image_hw = np.array([[h, w], [56, 80]], np.int32)
    for i, (hh, ww) in enumerate(image_hw):
        img[i, hh:] = 0
        img[i, :, ww:] = 0
    K = np.array(
        [[[70.0, 0, 48], [0, 75.0, 32], [0, 0, 1]],
         [[115.0, 0, 42], [0, 120.0, 28], [0, 0, 1]]], np.float32)
    ratio = np.array([2.0, 1.5], np.float32)
    return img, image_hw, K, ratio


def jax_batch(img, image_hw, K, ratio):
    import jax.numpy as jnp

    from threedod.data.batch import Batch

    return Batch(
        image=jnp.asarray(img), image_hw=jnp.asarray(image_hw), K=jnp.asarray(K),
        im_scale_ratio=jnp.asarray(ratio), image_id=jnp.arange(len(img), dtype=jnp.int32),
    )


def torch_batch(img, image_hw, K, ratio):
    from threedod_torch.data.batch import Batch

    return Batch(
        image=torch.from_numpy(img), image_hw=torch.from_numpy(image_hw),
        K=torch.from_numpy(K), im_scale_ratio=torch.from_numpy(ratio),
        image_id=torch.arange(len(img), dtype=torch.int32),
    )


def jax_model(jcfg, predictor_scale: float = 1.0):
    """JAX RCNN3D and variables for it as numpy trees, made without compiling
    anything (``init_like_variables``). The
    class-score kernel is scaled by ``predictor_scale`` so random-init class
    scores are not near-tied (both packages get the scaled weights)."""
    from threedod.models import build_model

    return build_model(jcfg), init_like_variables(jcfg, predictor_scale)


def seeded_variables(jcfg, seed: int = 0):
    """Numpy variables in the shape of the JAX RCNN3D's: lecun-normal
    kernels, BatchNorm scales in 0.8..1.2, small biases and running means,
    running variances in 0.8..1.25, priors of 1."""
    import jax

    from threedod.models import build_model

    model = build_model(jcfg)
    shapes = jax.eval_shape(lambda b: model.init(jax.random.PRNGKey(0), b), jax_batch(*inputs()))
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict) or hasattr(val, "items"):
                out[key] = fill(val)
            elif key == "kernel":
                out[key] = (rng.randn(*val.shape) / np.sqrt(np.prod(val.shape[:-1]))).astype(np.float32)
            elif key == "scale":
                out[key] = rng.uniform(0.8, 1.2, val.shape).astype(np.float32)
            elif key == "bias":
                out[key] = rng.normal(0, 0.05, val.shape).astype(np.float32)
            elif key == "mean":
                out[key] = rng.normal(0, 0.1, val.shape).astype(np.float32)
            elif key == "var":
                out[key] = rng.uniform(0.8, 1.25, val.shape).astype(np.float32)
            else:
                out[key] = np.ones(val.shape, np.float32)
        return out

    return fill(shapes)


def init_like_variables(jcfg, predictor_scale: float = 1.0, seed: int = 0):
    """``seeded_variables`` with the ROI heads drawn as the JAX init draws
    them: xavier-uniform fc layers with zero biases, class scores of std 0.01
    (times ``predictor_scale``), box deltas and every 3D output of std 0.001
    with the init's biases (1 for the depth, 5 for the uncertainty, 0
    elsewhere). Trunk, FPN and RPN head keep the seeded BatchNorm and biases
    off the identity. Nothing is compiled (``jax.eval_shape`` only)."""
    variables = seeded_variables(jcfg, seed)
    rng = np.random.RandomState(seed + 1)
    bias_init = {"bbox_3D_center_depth": 1.0, "bbox_3D_uncertainty": 5.0}

    def dense(layer, std=None, bias=0.0):
        fan_in, fan_out = layer["kernel"].shape[0], layer["kernel"].shape[-1]
        if std is None:  # xavier uniform
            lim = np.sqrt(6.0 / (fan_in + fan_out))
            layer["kernel"] = rng.uniform(-lim, lim, layer["kernel"].shape).astype(np.float32)
        else:
            layer["kernel"] = (rng.randn(*layer["kernel"].shape) * std).astype(np.float32)
        layer["bias"] = np.full(layer["bias"].shape, bias, np.float32)

    heads = variables["params"]["roi_heads"]
    for name, layer in heads.get("box_head", {}).items():
        dense(layer)
    dense(heads["box_predictor"]["cls_score"], 0.01 * predictor_scale)
    dense(heads["box_predictor"]["bbox_pred"], 0.001)
    for name, layer in heads.get("cube_head", {}).items():
        if name.startswith("bbox_3D"):
            dense(layer, 0.001, bias_init.get(name, 0.0))
        else:
            dense(layer)
    return variables


def port_model(pcfg, variables):
    """Port RCNN3D loaded (strictly) from the JAX variables."""
    from threedod_torch.models.meta_arch import build_model
    from threedod_torch.utils.convert_weights import from_jax_variables

    model = build_model(pcfg)
    model.load_state_dict(from_jax_variables(variables, pcfg), strict=True)
    return model


# ---- training: ground truth and the samplers' noise -----------------------

# The whole-step tests saturate every discrete choice, so that the ~1e-3
# differences between the two trunks in training mode (see
# test_torch_train_step.py) cannot flip one: the RPN sees the three coarsest
# levels only (96 anchors an image), all of them enter and survive the NMS
# (threshold 1), both samplers have room for every candidate, so the selected
# sets do not depend on the sampling noise, and every loss, a masked sum or
# mean, does not depend on the order.
TRAIN_OVERRIDES = {
    "model.rpn.in_features": ("p4", "p5", "p6"),
    "model.rpn.nms_thresh": 1.0,
    "model.rpn.pre_nms_topk_train": 96,
    "model.rpn.post_nms_topk_train": 96,
    "model.rpn.batch_size_per_image": 96,
    "shapes.roi_batch": 100,
    "shapes.max_gt": 4,
    "solver.ims_per_batch": 2,
    "solver.warmup_iters": 10,
    "solver.warmup_factor": 0.5,
}


def ground_truth(seed: int = 11):
    """Numpy ground truth for the two images of ``inputs()``: 4 slots, the
    last one padding, slot 1 of image 0 an ignore region (class -1); poses
    are random rotations."""
    rng = np.random.RandomState(seed)
    boxes2d = np.array(
        [[[8, 6, 40, 38], [50, 10, 90, 60], [30, 30, 62, 58], [0, 0, 0, 0]],
         [[4, 20, 36, 50], [40, 4, 76, 30], [20, 8, 52, 44], [0, 0, 0, 0]]], np.float32)
    classes = np.array([[2, -1, 0, 0], [4, 1, 3, 0]], np.int32)
    valid = np.array([[True, True, True, False]] * 2)
    centre = (boxes2d[..., :2] + boxes2d[..., 2:]) / 2 + rng.uniform(-2, 2, (2, 4, 2))
    boxes3d = np.concatenate(
        [centre, rng.uniform(2, 6, (2, 4, 1)), rng.uniform(0.3, 1.3, (2, 4, 3)), rng.randn(2, 4, 3)], -1
    ).astype(np.float32)
    q = rng.randn(2, 4, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = np.moveaxis(q, -1, 0)
    poses = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], -2).astype(np.float32)
    return dict(boxes2d=boxes2d, classes=classes, boxes3d=boxes3d, poses=poses, valid=valid)


def jax_train_batch(img, image_hw, K, ratio, gt):
    import jax.numpy as jnp

    from threedod.data.batch import GroundTruth

    return jax_batch(img, image_hw, K, ratio).replace(
        gt=GroundTruth(**{k: jnp.asarray(v) for k, v in gt.items()}))


def torch_train_batch(img, image_hw, K, ratio, gt):
    from threedod_torch.data.batch import GroundTruth

    return torch_batch(img, image_hw, K, ratio)._replace(
        gt=GroundTruth(**{k: torch.from_numpy(v) for k, v in gt.items()}))


def sampler_noise(key, batch_size: int, num_candidates: int):
    """The Gumbel noise ``subsample_fg_bg`` draws under a per-image vmap
    whose keys are ``jax.random.split(key, batch_size)``: (fg, bg) torch
    tensors, each (B, R)."""
    import jax

    fg, bg = [], []
    for key_i in jax.random.split(key, batch_size):
        kf, kb = jax.random.split(key_i)
        fg.append(np.asarray(jax.random.gumbel(kf, (num_candidates,))))
        bg.append(np.asarray(jax.random.gumbel(kb, (num_candidates,))))
    return torch.from_numpy(np.stack(fg)), torch.from_numpy(np.stack(bg))


# ---- the suite's clock --------------------------------------------------------


ROI_CARD_CASES = ("mixed", "border_band", "bumped", "wider_than_window")


def roi_card_case(case: str, seed: int = 0):
    """Inputs of the ROIAlign kernels' ``gpu`` tests: (channels-last level
    maps {name: (B, H_l, W_l, C)} f32, boxes (B, N, 4) f32), from numpy.

    mixed: 2 x 300 detection-like ROIs at 512x672, C = 256; border_band: ROIs
    at the corners and edges of a 128x168 canvas, with samples in and beyond
    the [-1, dim] band, C = 32; bumped: elongated ROIs that the level bump
    raises, 512x672, C = 32; wider_than_window: a 128x2112 canvas (p6 is 33
    cells wide) with ROIs across it, clamped at p6, whose taps span more than
    the 32-cell window, C = 8."""
    rng = np.random.RandomState(seed)
    h, w, c = {"mixed": (512, 672, 256), "border_band": (128, 168, 32), "bumped": (512, 672, 32),
               "wider_than_window": (128, 2112, 8)}[case]
    n = 300 if case == "mixed" else 32
    x1, y1 = rng.uniform(-20, w, (2, n)), rng.uniform(-20, h, (2, n))
    bw = np.exp(rng.uniform(np.log(2), np.log(400), (2, n)))
    bh = np.exp(rng.uniform(np.log(2), np.log(300), (2, n)))
    if case == "bumped":  # aspect 4 to 40
        bh = bw / np.exp(rng.uniform(np.log(4), np.log(40), (2, n)))
    boxes = np.stack([x1, y1, x1 + bw, y1 + bh], -1)
    special = {
        "mixed": [[0, 0, 8, 8], [w - 8, h - 8, w, h], [-3, -2, w + 4, h + 3], [2, 30, w - 2, 46],
                  [40, 1, 52, h - 1], [w - 1.5, h - 1.2, w + 0.5, h + 0.3], [-300, -250, w + 300, h + 250]],
        "border_band": [[0, 0, 8, 8], [w - 8, h - 8, w, h], [w - 1.5, h - 1.2, w + 0.5, h + 0.3],
                        [-1.4, -1.1, 2, 2.5], [w - 0.2, 0, w + 1, 9], [-7, -5, 3, 2], [0, h - 0.5, 10, h + 0.7],
                        [-3, -2, w + 4, h + 3], [-20, 3, 4, 9], [w - 3, -9, w + 20, 2], [30, 40, 30, 40]],
        "bumped": [[2, 30, w - 2, 46], [40, 1, 52, h - 1], [0, 200, w, 230], [300, 0, 330, h]],
        "wider_than_window": [[0, 0, 2112, 128], [20, 5, 2090, 120], [3, 40, 2110, 90], [-10, -10, 2122, 138]],
    }[case]
    boxes[:, :len(special)] = special
    feats = {nm: rng.randn(2, -(-h // s), -(-w // s), c).astype(np.float32)
             for nm, s in (("p2", 4), ("p3", 8), ("p4", 16), ("p5", 32), ("p6", 64))}
    return feats, boxes.astype(np.float32)


def junit_seconds_by_file(path: str):
    """{test file: summed seconds}, {test file: test count} of a pytest
    ``--junitxml`` report (set-up, call and tear-down of each test), and the
    report's own wall time."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    suite = root if root.tag == "testsuite" else root.find("testsuite")
    seconds, counts = {}, {}
    for case in suite.iter("testcase"):
        name = case.get("classname", "").split(".")
        stem = next((n for n in name if n.startswith("test_")), name[0])
        key = f"tests/{stem}.py"
        seconds[key] = seconds.get(key, 0.0) + float(case.get("time", 0.0))
        counts[key] = counts.get(key, 0) + 1
    return seconds, counts, float(suite.get("time", 0.0))


def replay_loadfile(seconds, counts, workers: int = 6) -> float:
    """Wall time of pytest-xdist's ``--dist loadfile`` schedule for files of
    the given durations: files queue by test count, most first (ties in path
    order); each worker is handed one file, then a second, and takes the next
    in the queue whenever one ends."""
    import heapq

    queue = sorted(sorted(seconds), key=lambda f: -counts[f])
    pending = [[] for _ in range(workers)]
    for _ in range(2):  # one file to each worker, then a second to each
        for p in pending:
            if queue:
                p.append(queue.pop(0))
    events = [(seconds[p[0]], w) for w, p in enumerate(pending) if p]
    heapq.heapify(events)
    wall = 0.0
    while events:
        t, w = heapq.heappop(events)
        wall = t
        pending[w].pop(0)
        if queue:
            pending[w].append(queue.pop(0))
        if pending[w]:
            heapq.heappush(events, (t + seconds[pending[w][0]], w))
    return wall


if __name__ == "__main__":
    # python tests/_torch_port.py report.xml [glob]: summed seconds by file;
    # with --replay: the loadfile schedule's wall time, and its median, 10th
    # and 90th percentiles over 400 draws of every file's time times
    # U(0.85, 1.15), as reported and with the files of [glob] at zero time
    import fnmatch
    import random
    import sys

    args = [a for a in sys.argv[1:] if a != "--replay"]
    files, tests, wall = junit_seconds_by_file(args[0])
    pattern = args[1] if len(args) > 1 else "*"
    picked = {k: v for k, v in files.items() if fnmatch.fnmatch(k, pattern)}
    for name, sec in sorted(picked.items(), key=lambda kv: -kv[1]):
        print(f"{sec:9.1f}  {name}")
    print(f"{sum(picked.values()):9.1f}  summed over {len(picked)} files; the report's wall time {wall:.1f} s")
    if "--replay" in sys.argv:
        for label, scale in (("as reported", 1.0), (f"{pattern} at zero", 0.0)):
            base = {k: v * (scale if k in picked else 1.0) for k, v in files.items()}
            draws = sorted(replay_loadfile({k: v * rng.uniform(0.85, 1.15) for k, v in base.items()}, tests)
                           for rng in (random.Random(i) for i in range(400)))
            print(f"replayed loadfile wall, {label}: {replay_loadfile(base, tests):.1f} s; jittered median "
                  f"{draws[200]:.1f}, p10 {draws[40]:.1f}, p90 {draws[360]:.1f}")
