"""Scalar log (counterpart of ``threedod/train/events.py``): scalars
accumulate each iteration; every ``window`` iterations their medians go to
the log and to ``metrics.json`` (one JSON object per line), and with
``stdout`` also to standard output as the same JSON line. With
``use_wandb`` (the config's ``log``) the records are mirrored to wandb where
it is installed; where it is not, the storage says so once and logs to the
JSON file alone, as the JAX package's does. Under a process group only rank
0 writes: the other ranks' storages keep their scalars and write nothing."""
from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque

from ..parallel import dist

logger = logging.getLogger(__name__)


class EventStorage:
    def __init__(self, output_dir: str, window: int = 20, stdout: bool = False, use_wandb: bool = False):
        self.output_dir = output_dir
        self.stdout = stdout
        self.window = window
        self.iter = 0
        self._history = defaultdict(lambda: deque(maxlen=window))
        self.writes = dist.is_primary()
        self._jsonl = None
        if self.writes:
            os.makedirs(output_dir, exist_ok=True)
            self._jsonl = open(os.path.join(output_dir, "metrics.json"), "a")
        self._t_last_flush = time.time()
        self._wandb = None
        if use_wandb and self.writes:
            try:
                import wandb

                wandb.init(project="threedod", dir=output_dir)
                self._wandb = wandb
            except Exception:
                logger.warning("wandb requested but unavailable; logging to JSONL only")

    def put_scalars(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self._history[k].append(float(v))

    def median(self, key: str) -> float:
        vals = sorted(self._history[key])
        return vals[len(vals) // 2] if vals else 0.0

    def flush(self, max_iter: int | None = None) -> None:
        if not self.writes:
            return
        record = {"iteration": self.iter}
        record.update({k: self.median(k) for k in sorted(self._history)})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self.stdout:
            print(json.dumps(record), flush=True)
        if self._wandb is not None:
            self._wandb.log(record, step=self.iter)
        now = time.time()
        it_s = self.window / max(now - self._t_last_flush, 1e-6)
        self._t_last_flush = now
        eta = ""
        if max_iter:
            secs = (max_iter - self.iter) / it_s
            eta = f" eta: {int(secs // 3600)}h{int(secs % 3600 // 60):02d}m"
        main = {
            k: v for k, v in record.items()
            if k in ("total_loss", "lr") or k.endswith("loss_cls") or k.startswith("Cube/loss")
        }
        parts = " ".join(f"{k}: {v:.4g}" for k, v in main.items())
        logger.info("iter %d%s %s (%.2f it/s)", self.iter, eta, parts, it_s)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
