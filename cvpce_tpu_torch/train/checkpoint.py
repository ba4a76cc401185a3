"""Checkpoint save/restore with rotation and best-model retention;
counterpart of cvpce_tpu/train/checkpoint.py.

The reference's scheme (cvpce/proposals_training.py:103-139):
`checkpoint` rotated to `previous_checkpoint`, `epoch_<e>` saved when the
metric improves and on the final epoch, each beside a `<name>.meta.json`
sidecar of scalars.

A checkpoint is what the JAX package writes: an orbax directory of the
whole train state (utils/orbax_write.py), in the layout of its
GLNTrainState, DIHETrainState or GAN pretraining dict, optimizer state
included. Each train state converts itself (`to_tree` / `load_tree` in
train/gln.py and train/dihe.py), so either package resumes a run that
the other wrote, and the `.meta.json` sidecar is the JAX package's. The
JAX tree has no place for torch's BatchNorm update counters
(`num_batches_tracked`, which no computation reads, the momentum being
fixed): the node's directory keeps them in a file of its own,
`num_batches_tracked.json`, which orbax does not read, so that they
move and go with the node; a node without it (one the JAX package
wrote) resumes with the counters the state has.

A node may also be one `torch.save` file of the state's `state_dict()`,
as the port wrote before: `read` and `restore` take it
(`torch.load(weights_only=True)`), and the next save replaces it.

Under data parallelism one rank writes (`writer=True` on rank 0 only):
the state is replicated, so one copy is the whole of it, and no two
ranks write the same directory.
"""
from __future__ import annotations

import json
import os
import shutil
from os import path
from typing import Any, Dict, NamedTuple, Optional

import torch

from ..utils import orbax_read, orbax_write

COUNTERS = "num_batches_tracked"
COUNTERS_FILE = COUNTERS + ".json"


class Node(NamedTuple):
    """A checkpoint as read: `layout` "orbax" with the JAX train-state
    tree and the BatchNorm counters it keeps (None without them),
    or "torch" with a `torch.save` state_dict."""
    layout: str
    value: Dict
    counters: Optional[Dict[str, int]] = None


def _counters(state) -> Dict[str, int]:
    """The BatchNorm update counters of the state's modules, by
    `<module>.<state_dict key>`."""
    return {f"{m}.{k}": int(v) for m in state.MODULES
            for k, v in getattr(state, m).state_dict().items()
            if k.endswith(COUNTERS)}


def _set_counters(state, counters: Optional[Dict[str, int]]) -> None:
    if not counters:
        return
    for m in state.MODULES:
        for k, v in getattr(state, m).state_dict(keep_vars=True).items():
            if k.endswith(COUNTERS) and f"{m}.{k}" in counters:
                v.fill_(counters[f"{m}.{k}"])


def load_node(state: Any, node: Node) -> Any:
    """Load a node `CheckpointManager.read` returned into `state`, in
    place (each tensor onto the device of the one it replaces); returns
    `state`."""
    if node.layout == "orbax":
        state.load_tree(node.value)
        _set_counters(state, node.counters)
    else:
        state.load_state_dict(node.value)
    return state


def _remove(target: str) -> None:
    if path.isdir(target) and not path.islink(target):
        shutil.rmtree(target)
    else:
        os.remove(target)


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
        orbax_write.save(target, state.to_tree())
        counters = _counters(state)
        if counters:
            with open(path.join(target, COUNTERS_FILE), "w") as f:
                json.dump(counters, f)
        with open(target + ".meta.json", "w") as f:
            json.dump(meta, f)

    def save_rotating(self, state: Any, meta: Dict) -> None:
        """Save `state` as <name>, the existing one becoming
        previous_<name> (proposals_training.py:130-136): an existing
        previous_<name> is removed, then <name> renamed onto it."""
        current = self._path(self.name)
        previous = self._path(f"previous_{self.name}")
        if self.writer and path.lexists(current):
            if path.lexists(previous):
                _remove(previous)
            os.replace(current, previous)
        self._write(state, current, meta)

    def save_named(self, state: Any, name: str, meta: Dict) -> None:
        self._write(state, self._path(name), meta)

    def restore(self, state: Any, name: Optional[str] = None) -> Any:
        """Load the checkpoint into `state` (in place: each tensor is
        copied onto the device of the one it replaces) and return it."""
        return load_node(state, self.read(name))

    def read(self, name: Optional[str] = None) -> Node:
        """The checkpoint, on the CPU: an orbax directory's tree
        (utils/orbax_read.py), or the state_dict of a `torch.save`
        file."""
        target = self._path(name or self.name)
        if orbax_read.is_checkpoint(target):
            counters = None
            if path.exists(path.join(target, COUNTERS_FILE)):
                with open(path.join(target, COUNTERS_FILE)) as f:
                    counters = json.load(f)
            return Node("orbax", orbax_read.restore(target), counters)
        if path.isdir(target):
            raise ValueError(f"{target} holds no orbax checkpoint")
        return Node("torch", torch.load(target, map_location="cpu",
                                        weights_only=True))

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
