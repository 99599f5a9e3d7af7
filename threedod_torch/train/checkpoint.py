"""Checkpoints with the recent/final policy (counterpart of
``threedod/train/checkpoint.py``): one overwritten ``model_recent.pt`` every
``period`` iterations and a ``model_final.pt`` at the end, written with
``torch.save`` by rank 0 under a process group; resuming takes the final one
if it exists, else the recent, on every rank."""
from __future__ import annotations

import os
from typing import Any, Optional

import torch

from ..parallel import dist


class CheckpointManager:
    def __init__(self, output_dir: str, period: int, max_iter: int):
        self.output_dir = os.path.abspath(output_dir)
        self.period = period
        self.max_iter = max_iter
        os.makedirs(self.output_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.output_dir, f"{name}.pt")

    def save(self, name: str, state: Any) -> None:
        """Rank 0 writes (every process without a group); every rank then
        waits for the file, which any of them may read next."""
        if dist.is_primary():
            tmp = self._path(name) + ".tmp"
            torch.save(state, tmp)
            os.replace(tmp, self._path(name))
        dist.barrier()

    def step(self, iteration: int, state: Any) -> None:
        """Periodic save: overwrite model_recent; model_final at the end."""
        if (iteration + 1) % self.period == 0:
            self.save("model_recent", state)
        if iteration >= self.max_iter - 1:
            self.save("model_final", state)

    def restore(self, name: str, map_location="cpu") -> Optional[Any]:
        path = self._path(name)
        if not os.path.exists(path):
            return None
        return torch.load(path, map_location=map_location, weights_only=True)

    def resume_or_load(self, resume: bool = True, map_location="cpu") -> Optional[Any]:
        """The final checkpoint, else the recent one, if resuming; else None."""
        if not resume:
            return None
        for name in ("model_final", "model_recent"):
            out = self.restore(name, map_location)
            if out is not None:
                return out
        return None
