"""Train and evaluate Cube R-CNN, supervised (``RCNN3D``) or weak
(``RCNN3DCombined``), from a config file on a CUDA device: the port's
counterpart of ``tools/train_net.py``.

    python -m threedod_torch.train_net --config-file configs/Base_Synth.yaml
        [--eval-only] [--resume] [--device cuda] [--num-gpus N] [KEY VALUE ...]
    python -m threedod_torch.train_net --config-file configs/Omni_combined_Synth.yaml
    python -m torch.distributed.run --nproc-per-node N -m threedod_torch.train_net --config-file ...

The steps are those of ``tools/train_net.py``. ``setup`` reads the config
(``config_yaml.py``; ``KEY VALUE`` pairs such as ``solver.max_iter 60``
override it), merges the training datasets' JSON files
(``cfg.datasets.root``/Omni3D/<name>.json), fixes the model's categories in
``output_dir``/category_meta.json, registers the train and test datasets
and computes the priors. The model is built with them, from ``cfg.seed``.
Training runs the retry loop (``train.trainer.train_with_retries``) over the
repeat-factor loader (which, for ``RCNN3DCombined``, also loads each image's
depth and ground maps and instance masks), resuming each failed attempt from the last checkpoint
or, when there is none, from a fresh initialisation with the seed folded
with the attempt. ``do_test`` then evaluates every test dataset (AP2D, AP3D,
AP3D@15/25/50, near/medium/far) and writes ``output_dir``/results.json.

A fresh initialisation is ``tools/train_net.py``'s ``fresh_state``
(``fresh_model``): the seeded weights, then, where neither ``model.weights``
nor ``model.weights_pretrain`` is set, the trunk's ImageNet checkpoint
where one is cached (``utils/model_zoo.imagenet_trunk_path``), then
``model.weights_pretrain``, model only, on every fresh attempt.
``--resume`` continues from ``output_dir``'s checkpoint; ``--eval-only``
evaluates it. Either, without a checkpoint, starts from ``model.weights``
(``utils/model_zoo.py``: a zoo or port state dict). With ``vis_period``
set, each evaluation also draws every ``vis_period``-th test image's
detections into ``output_dir``/<dataset>/vis/<index>.png and logs the error
line of ``vis.visualize_from_instances`` (``eval_boxes`` does the same on its
AP path). ``log`` mirrors the scalar log to wandb where it is installed.

Data parallelism (``parallel/dist.py``): ``--num-gpus N`` runs N ranks, one
card each (NCCL), or N ranks on the CPU (gloo) with ``--device cpu``; by
default every visible card. As ``make_mesh_for_batch`` does, the world is the
largest count up to N that divides ``solver.ims_per_batch``. The tool spawns
the ranks itself, or joins the group of a ``torch.distributed.run`` launch,
whose world must divide the batch. A step over N ranks is the one-process
step at the global batch; each rank evaluates its share of the test set and
rank 0 evaluates the gathered predictions and writes the checkpoints,
``metrics.json`` and ``results.json``.

Rank 0 prints one JSON line per logged window of iterations (the medians of
``metrics.json``) and a last line with the results and the run's summary:
the card, iterations, skipped steps, the mean total loss of the attempt's
first and of its last 10 steps (``metrics.json`` holds the window medians),
ms per iteration after 10 warm-up steps and the loader's share, peak memory,
the seconds evaluation took and the launches of the ROIAlign kernels K1 and
K2.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import time
from typing import Optional

import numpy as np
import torch

from .config_yaml import load_config
from .data.build import TestLoader, TrainLoader, get_dataset_dicts
from .data.omni3d import (CATALOG, Omni3D, get_filter_settings_from_cfg, load_omni3d_json,
                          register_and_store_model_metadata)
from .data.priors import compute_priors
from .evaluation.inference import (Omni3DEvaluationHelper, group_predictions_by_image, gts_from_records,
                                   inference_on_dataset)
from .infer import predict
from .models.meta_arch import build_model
from .ops import roi_align_cuda
from .parallel import dist
from .train.checkpoint import CheckpointManager
from .train.events import EventStorage
from .train.trainer import Trainer, train_with_retries
from .utils.model_zoo import BN_STATS, imagenet_trunk_path, load_model_weights, load_trunk_weights, resolve, state_dict
from .vis import visualize_from_instances

logger = logging.getLogger("threedod_torch")


def _json_path(cfg, name: str) -> str:
    return os.path.join(cfg.datasets.root, "Omni3D", f"{name}.json")


def register_datasets(cfg, names) -> None:
    fs = get_filter_settings_from_cfg(cfg)
    for name in names:
        records = load_omni3d_json(_json_path(cfg, name), cfg.datasets.root, name, fs)
        CATALOG.register(name, lambda r=records: r)


def setup(config_file: str, opts=()):
    """(cfg, model metadata, priors): the config with the categories of the
    training datasets, the datasets registered, the priors computed. Before
    anything is written it refuses a ``model.weights_pretrain`` that names no
    file. Under a process group rank 0 fixes the categories first."""
    cfg = load_config(config_file, list(opts))
    if cfg.model.weights_pretrain and not os.path.exists(resolve(cfg.model.weights_pretrain)):
        raise FileNotFoundError(f"model.weights_pretrain {cfg.model.weights_pretrain!r}: no such file")
    os.makedirs(cfg.output_dir, exist_ok=True)
    fs = get_filter_settings_from_cfg(cfg)
    datasets = Omni3D([_json_path(cfg, n) for n in cfg.datasets.train], filter_settings=fs)
    if not dist.is_primary():  # rank 0 writes category_meta.json, the others read it
        dist.barrier()
    meta = register_and_store_model_metadata(datasets, cfg.output_dir, fs)
    if dist.is_primary():
        dist.barrier()
    if not cfg.datasets.category_names:
        cfg.datasets.category_names = tuple(meta.thing_classes)
    cfg.model.roi_heads.num_classes = len(meta.thing_classes)
    register_datasets(cfg, list(cfg.datasets.train) + list(cfg.datasets.test))
    priors = compute_priors(cfg, datasets, meta.thing_classes)
    return cfg, meta, priors


def draw_evaluation(cfg, meta, name: str, records, predictions, device, iteration="") -> str:
    """``vis_period``'s work for one test dataset (tools/train_net.py:98-116):
    every ``vis_period``-th image's predictions drawn into
    ``output_dir``/<name>/vis, and the logged error line, which is returned."""
    id_map = meta.thing_dataset_id_to_contiguous_id
    contiguous = [{**p, "category_id": id_map.get(p["category_id"], p["category_id"])} for p in predictions]
    line = visualize_from_instances(group_predictions_by_image(contiguous, records), records, name,
                                    cfg.input.min_size_test, os.path.join(cfg.output_dir, name),
                                    list(meta.thing_classes), iteration, visualize_every=cfg.vis_period,
                                    device=device)
    logger.info(line.rstrip())
    return line


def do_test(cfg, model, meta, device, storage=None, iteration="") -> dict:
    """Evaluate ``model`` on every test dataset; writes and returns the
    results, and with ``vis_period`` draws (``draw_evaluation``). Under a
    process group each rank infers its share, rank 0 evaluates the gathered
    predictions, draws and writes the file, and every rank returns rank 0's
    results."""
    id_map_inv = {v: k for k, v in meta.thing_dataset_id_to_contiguous_id.items()}
    helper = Omni3DEvaluationHelper(list(cfg.datasets.test), meta.thing_classes,
                                    meta.thing_dataset_id_to_contiguous_id, device=device)
    was_training = model.training
    model.eval()
    for name in cfg.datasets.test:
        records = get_dataset_dicts([name])
        loader = TestLoader(records, cfg, device=device)
        preds, timing = inference_on_dataset(lambda b: predict(model, b), loader, id_map_inv)
        logger.info("%s: %d predictions over %d images (%.3f images/s, %.4f s a batch computing)",
                    name, len(preds), timing["images"], timing["images_per_s"], timing["s_per_iter_compute"])
        if not dist.is_primary():
            continue
        res = helper.evaluate(name, gts_from_records(records, id_map_inv), preds)
        logger.info("%s: AP2D %.2f AP3D %.2f (@15 %.2f @25 %.2f @50 %.2f)",
                    name, res["AP2D"], res["AP3D"], res["AP3D@15"], res["AP3D@25"], res["AP3D@50"])
        if cfg.vis_period:
            draw_evaluation(cfg, meta, name, records, preds, device, iteration)
        if storage is not None:
            storage.put_scalars(**{f"{name}/AP2D": res["AP2D"], f"{name}/AP3D": res["AP3D"]})
    model.train(was_training)
    results = None
    if dist.is_primary():
        results = helper.summarize_all()
        with open(os.path.join(cfg.output_dir, "results.json"), "w") as f:
            json.dump(results, f, indent=1, default=float)
    return dist.broadcast_object(results)


def fresh_model(cfg, priors, seed: int):
    """A fresh initialisation (``tools/train_net.py::fresh_state``): the
    model from ``seed``, then the trunk's cached ImageNet checkpoint where
    neither ``model.weights`` nor ``model.weights_pretrain`` is set, then
    ``model.weights_pretrain`` (model only; the fresh BatchNorm statistics
    stay where the file has none)."""
    model = build_model(cfg, seed=seed, priors=priors)
    if not cfg.model.weights_pretrain and not cfg.model.weights:
        path = imagenet_trunk_path(cfg.model.backbone)
        if path:
            load_trunk_weights(path, cfg.model.backbone, model)
            logger.info("initialised %s trunk from %s", cfg.model.backbone, path)
    if cfg.model.weights_pretrain:
        sd = state_dict(resolve(cfg.model.weights_pretrain))
        if not any(k.endswith(BN_STATS) for k in sd):  # a file saved without them
            sd.update({k: v for k, v in model.state_dict().items() if k.endswith(BN_STATS)})
        load_model_weights(sd, model)
        logger.info("loaded pretrain weights from %s", cfg.model.weights_pretrain)
    return model


def fold_seed(seed: int, attempt: int) -> int:
    """The initialisation seed of a retry that has no checkpoint to resume."""
    return int(np.random.SeedSequence([seed, attempt]).generate_state(1)[0])


def card_name_and_power_limit(device: torch.device) -> str:
    """``nvidia-smi``'s name and power limit of the card, else torch's name."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True, timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except OSError:
        pass
    return torch.cuda.get_device_name(device) + ", power limit not read"


def run(args, device: torch.device) -> dict:
    """The tool's work on ``device`` (``main`` refuses all but a CUDA card;
    tests call this on the CPU). Returns the last line's object."""
    cfg, meta, priors = setup(args.config_file, args.opts)
    ckpt = CheckpointManager(cfg.output_dir, cfg.solver.checkpoint_period, cfg.solver.max_iter)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    launches = {"k1_eval": 0, "eval_seconds": 0.0, "results": None}

    def test(model, storage=None, iteration=""):
        k1, t0 = roi_align_cuda.LAUNCHES, time.perf_counter()
        launches["results"] = do_test(cfg, model, meta, device, storage, iteration)
        launches["eval_seconds"] += time.perf_counter() - t0
        launches["k1_eval"] += roi_align_cuda.LAUNCHES - k1
        return launches["results"]

    def loaded(state, seed: int):
        """A fresh model from ``seed`` (``fresh_model``) on ``device``, then
        ``state`` (a checkpoint or ``model.weights``) if given."""
        model = fresh_model(cfg, priors, seed)
        if state:
            load_model_weights(state, model)
        return model.to(device)

    restored = ckpt.resume_or_load(resume=args.resume or args.eval_only)
    if args.eval_only:
        model = loaded(restored or cfg.model.weights, cfg.seed)
        return {"results": test(model), "eval_seconds": launches["eval_seconds"]}

    attempts = []

    def build_fn(resume: bool):
        attempts.append(resume)
        state = ckpt.resume_or_load(resume=True) if resume else restored
        if state is not None:
            trainer = Trainer(cfg, loaded(None, cfg.seed), device)
            trainer.load_state_dict(state)
            logger.info("resumed from iteration %d", trainer.iteration)
            return trainer, trainer.iteration
        seed = cfg.seed if len(attempts) == 1 else fold_seed(cfg.seed, len(attempts) - 1)
        first = len(attempts) == 1 and args.resume
        return Trainer(cfg, loaded(cfg.model.weights if first else None, seed), device), 0

    storage = EventStorage(cfg.output_dir, stdout=True, use_wandb=cfg.log)
    k1, k2 = roi_align_cuda.LAUNCHES, roi_align_cuda.BACKWARD_LAUNCHES
    # weak Cube R-CNN learns from the depth and ground maps and the instance masks
    load_maps = cfg.model.meta_architecture == "RCNN3DCombined"
    trainer = train_with_retries(
        cfg, build_fn, lambda: TrainLoader(get_dataset_dicts(cfg.datasets.train), cfg, seed=cfg.seed, device=device,
                                           load_maps=load_maps),
        eval_fn=lambda tr, it, st: test(tr.model, st, it), storage=storage)
    if launches["results"] is None:  # resumed at the end: no step ran, so no evaluation either
        test(trainer.model)
    tally = trainer.tally
    return {
        "results": launches["results"], "world_size": dist.world_size(),
        "iterations": trainer.iteration, "attempts": len(attempts),
        "first_iteration": trainer.iteration if tally.first_iteration is None else tally.first_iteration,
        "steps": tally.steps, "skipped": tally.skipped, "nonfinite_losses": tally.nonfinite,
        "loss_first_mean": float(np.mean(tally.first_losses)) if tally.steps else None,
        "loss_last_mean": float(np.mean(tally.last_losses)) if tally.steps else None,
        "ms_per_iteration": 1000.0 * tally.time / tally.timed if tally.timed else None,
        "loader_share": tally.data_time / tally.time if tally.timed else None,
        "steps_timed": tally.timed,
        "eval_seconds": launches["eval_seconds"],
        "k1_launches_training": roi_align_cuda.LAUNCHES - k1 - launches["k1_eval"],
        "k2_launches_training": roi_align_cuda.BACKWARD_LAUNCHES - k2,
        "k1_launches_eval": launches["k1_eval"],
        "peak_memory_bytes": torch.cuda.max_memory_allocated(device) if cuda else None,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train and evaluate Cube R-CNN (supervised or weak) from a config file")
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-gpus", type=int, default=None,
                    help="ranks to run, one card each (every visible card by default; 1 on the CPU)")
    ap.add_argument("opts", nargs=argparse.REMAINDER, default=[], help="KEY VALUE pairs overriding the config")
    return ap


def launch(args, timeout_s: Optional[float] = None) -> Optional[dict]:
    """The tool over its ranks (``parallel.dist.run_ranks``): a launcher's
    group, else ``--num-gpus`` spawned ranks cut to the batch
    (``parallel.dist.world_for_batch``; they must end within ``timeout_s``
    where given), else this process. Returns rank 0's result (None on the
    other ranks of a launch)."""
    device = torch.device(args.device)
    batch = load_config(args.config_file, list(args.opts)).solver.ims_per_batch
    return dist.run_ranks(run, args, device, dist.world_for_batch(batch, device, args.num_gpus), timeout_s)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"threedod_torch.train_net runs on a CUDA device; '{args.device}' is not available")
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s", force=True)
    t0 = time.perf_counter()
    out = launch(args)
    if out is not None:
        print(json.dumps({"device": card_name_and_power_limit(device), "seconds": time.perf_counter() - t0, **out},
                         default=float), flush=True)


if __name__ == "__main__":
    main()
