"""Supervised Cube R-CNN training on a CUDA device: the port's training
entry point (counterpart of ``tools/train_net.py`` on seeded synthetic
batches) and its parts.

    python -m threedod_torch.train [--steps 10] [--batch-size 8]
        [--weights model.pt] [--dtype bfloat16] [--device cuda]

The functions of the entry point live in ``entry.py``; ``solver.py``,
``trainer.py``, ``checkpoint.py`` and ``events.py`` are the counterparts of
the JAX package's ``threedod/train/`` modules.
"""
from .entry import build_trainer, main, train_config
from .trainer import StepOut, Trainer, train_with_retries

__all__ = ["StepOut", "Trainer", "build_trainer", "main", "train_config", "train_with_retries"]
