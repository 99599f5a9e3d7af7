"""``python -m threedod_torch.train_net --num-gpus 2`` on the CPU: the tool
spawns 2 gloo ranks (``train_net.launch``), each training on its rows of
the global batch and evaluating its share of the test set, against the same
run in one process, on ``test_torch_train_net.py``'s cut Base_Synth (96x128
canvas, a global batch of 2, 4 test images):

* the 2-rank run trains 2 iterations, checkpoints and evaluates; its
  ``results.json`` equals the one-process run's, key by key, and so do the
  summary's counts; rank 0 alone wrote ``metrics.json`` (as many lines as
  one process writes) and the checkpoints;
* ``--resume`` under 2 ranks continues from that checkpoint at iteration 2
  to 3;
* ``--num-gpus`` follows the mesh's rule: the world is the largest count up
  to the number asked for that divides ``solver.ims_per_batch``.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

import _torch_ddp as td
from test_torch_train_net import _opts, root  # noqa: F401  (the datasets root fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "Base_Synth.yaml")


def _launch(root, out, extra=(), flags=()):  # noqa: F811
    from threedod_torch import train_net

    return train_net.launch(train_net.parser().parse_args(
        ["--config-file", CONFIG, "--device", "cpu", *flags] + _opts(root, out, list(extra))), td.RANK_TIMEOUT_S)


def test_two_ranks_train_evaluate_and_resume_as_one_process(root, tmp_path):  # noqa: F811
    one = _launch(root, tmp_path / "one")
    two = _launch(root, tmp_path / "two", flags=["--num-gpus", "2"])
    assert one["world_size"] == 1 and two["world_size"] == 2
    for key in ("iterations", "steps", "skipped", "nonfinite_losses", "attempts"):
        assert two[key] == one[key], key
    np.testing.assert_allclose(two["loss_first_mean"], one["loss_first_mean"], rtol=1e-4)
    written = [json.loads((tmp_path / d / "results.json").read_text()) for d in ("one", "two")]
    assert written[1] == written[0] == json.loads(json.dumps(two["results"]))
    lines = [(tmp_path / d / "metrics.json").read_text().splitlines() for d in ("one", "two")]
    assert len(lines[1]) == len(lines[0]) > 0
    state = torch.load(tmp_path / "two" / "model_final.pt", weights_only=True)
    assert state["iteration"] == 2 and state["count"] == 2

    resumed = _launch(root, tmp_path / "two", ["solver.max_iter", "3"], flags=["--num-gpus", "2", "--resume"])
    assert resumed["world_size"] == 2 and resumed["first_iteration"] == 2 and resumed["iterations"] == 3
    assert resumed["steps"] == 1 and resumed["skipped"] == 0
    assert torch.load(tmp_path / "two" / "model_final.pt", weights_only=True)["count"] == 3
    for path in tmp_path.glob("*/*.pt"):  # 0.4 GB a checkpoint: not kept with the test's folder
        path.unlink()


def test_world_follows_the_batch(caplog):
    from threedod_torch.parallel import dist

    world = lambda n, b: dist.world_for_batch(b, torch.device("cpu"), n)  # noqa: E731
    assert world(2, 4) == 2 and world(4, 4) == 4 and world(1, 4) == 1 and world(None, 4) == 1
    assert world(3, 4) == 2 and "data parallelism uses 2" in caplog.text
    assert world(4, 6) == 3
