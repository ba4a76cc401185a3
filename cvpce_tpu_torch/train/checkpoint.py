"""Checkpoint save/restore with rotation and best-model retention;
counterpart of cvpce_tpu/train/checkpoint.py.

The reference's scheme (cvpce/proposals_training.py:103-139):
`checkpoint` rotated to `previous_checkpoint`, `epoch_<e>` saved when the
metric improves and on the final epoch, each beside a `<name>.meta.json`
sidecar of scalars. A checkpoint is one file written by torch.save:
the state's `state_dict()` (for GLN training the model's state_dict,
the SGD momentum buffers and the step count), read back with
`torch.load(weights_only=True)` onto the state's own tensors.

Under data parallelism one rank writes (`writer=True` on rank 0 only):
the state is replicated, so one copy is the whole of it, and no two
ranks write the same file.
"""
from __future__ import annotations

import json
import os
from os import path
from typing import Any, Dict, Optional

import torch


class CheckpointManager:
    def __init__(self, output_dir: str, name: str = "checkpoint",
                 writer: bool = True):
        """`writer=False`: the saves write nothing (a data-parallel rank
        other than 0)."""
        self.output_dir = path.abspath(output_dir)
        self.name = name
        self.writer = writer
        os.makedirs(self.output_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return path.join(self.output_dir, name)

    def _write(self, state: Any, target: str, meta: Dict) -> None:
        if not self.writer:
            return
        tmp = target + ".tmp"
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, target)
        with open(target + ".meta.json", "w") as f:
            json.dump(meta, f)

    def save_rotating(self, state: Any, meta: Dict) -> None:
        """Save `state` as <name>, the existing one becoming
        previous_<name> (proposals_training.py:130-136)."""
        current = self._path(self.name)
        if self.writer and path.exists(current):
            os.replace(current, self._path(f"previous_{self.name}"))
        self._write(state, current, meta)

    def save_named(self, state: Any, name: str, meta: Dict) -> None:
        self._write(state, self._path(name), meta)

    def restore(self, state: Any, name: Optional[str] = None) -> Any:
        """Load the checkpoint into `state` (in place: each tensor is
        copied onto the device of the one it replaces) and return it."""
        state.load_state_dict(self.read(name))
        return state

    def read(self, name: Optional[str] = None) -> Dict:
        """The saved state_dict, on the CPU."""
        return torch.load(self._path(name or self.name), map_location="cpu",
                          weights_only=True)

    def load_meta(self, name: Optional[str] = None) -> Dict:
        target = self._path(name or self.name) + ".meta.json"
        if not path.exists(target):
            return {}
        with open(target, "r") as f:
            return json.load(f)


class BestKeeper:
    """Best-metric epoch retention (proposals_training.py:156-172): save
    epoch_<e> only when the metric improves; always on the final
    epoch."""

    def __init__(self, manager: CheckpointManager, metric_name: str):
        self.manager = manager
        self.metric_name = metric_name
        self.best = {"epoch": -1, metric_name: 0.0}

    def update(self, state: Any, epoch: int, value: float,
               final: bool = False) -> bool:
        improved = value > self.best[self.metric_name]
        if improved:
            self.best = {"epoch": epoch, self.metric_name: float(value)}
        if improved or final:
            self.manager.save_named(state, f"epoch_{epoch}",
                                    {"epoch": epoch,
                                     self.metric_name: float(value),
                                     "best": self.best})
        return improved
