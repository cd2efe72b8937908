"""Checkpoint and resume with ``torch.save`` (the port of
``tpugnn/train/checkpoint.py``, which uses orbax).

A checkpoint holds the parameters, the optimizer state, the sampling
generator's state, the step and, where there is one, the EMA of the
parameters, so a resumed run draws the batches the first run would have
drawn.  Files are ``ckpt_<step>.pt`` in the directory; the newest
``max_to_keep`` are kept.  Orbax checkpoints of the JAX package are not read.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, *, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        self._keep = max_to_keep
        os.makedirs(self._dir, exist_ok=True)

    def _steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self._dir)
                      if (m := _NAME.match(f)))

    def _path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt_{step:09d}.pt")

    def save(self, step: int, payload: dict) -> None:
        """Write ``payload`` (tensors and plain values) as step ``step``,
        atomically, then drop all but the newest ``max_to_keep``."""
        path = self._path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save({"step": int(step), **payload}, tmp)
        os.replace(tmp, path)
        for old in self._steps()[:-self._keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, step: int) -> dict:
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def restore_latest(self) -> Optional[dict]:
        """The newest checkpoint's payload with its ``step``, or None."""
        step = self.latest_step()
        return None if step is None else self.restore(step)
