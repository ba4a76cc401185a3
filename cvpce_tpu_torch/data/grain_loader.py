"""Deterministic, resumable input pipeline; the port's counterpart of
cvpce_tpu/data/grain_loader.py, without grain (the card's machine has
none).

`GrainLoader` keeps the JAX class's surface: PrefetchLoader's
constructor (with the same `shard_index` / `num_shards` sharding),
`set_epoch`, `__len__`, `__iter__`, `iter_from(skip_batches)` for the
train loops' exact mid-epoch resume (train/loops.py:_resume_position),
and `iterator(num_epochs)`, a stream across epochs whose `get_state()`
/ `set_state()` resume it on the batch it would have produced.

The order is a numpy permutation that is a pure function of (seed,
epoch), sliced `[shard_index::num_shards]` after shuffling, as
data/loader.py:PrefetchLoader computes it: shards partition every epoch
and every resumed process sees the same batches. It is not grain's
order: grain's shuffle cannot be reproduced without grain, so the same
seed gives the two packages different batches (ROADMAP.md, "By
design"). `iterator` also keeps batches inside epochs (drop_last per
epoch), where grain's stream lets them straddle epoch boundaries.
"""
from __future__ import annotations

from typing import Dict, Iterator, Optional

from .loader import PrefetchLoader


class GrainLoader(PrefetchLoader):
    def iter_from(self, skip_batches: int) -> Iterator:
        """The current epoch's batches minus its first `skip_batches`;
        no skipped item is loaded."""
        return self._batches(self.epoch, skip_batches)

    def iterator(self, num_epochs: Optional[int] = None) -> "LoaderIterator":
        """Resumable batch stream over `num_epochs` epochs (None: no
        end) from epoch 0, reshuffled per epoch."""
        return LoaderIterator(self, num_epochs)


class LoaderIterator:
    """Batches of epochs 0, 1, ... of a GrainLoader; `get_state()` is the
    position of the next batch, `set_state()` moves there."""

    def __init__(self, loader: GrainLoader, num_epochs: Optional[int]):
        self.loader = loader
        self.num_epochs = num_epochs
        self._epoch = 0
        self._batch = 0
        self._it = None

    def __iter__(self) -> "LoaderIterator":
        return self

    def __next__(self):
        while self.num_epochs is None or self._epoch < self.num_epochs:
            if self._it is None:
                self._it = self.loader._batches(self._epoch, self._batch)
            try:
                batch = next(self._it)
            except StopIteration:
                self._it = None
                self._epoch += 1
                self._batch = 0
                continue
            self._batch += 1
            return batch
        raise StopIteration

    def get_state(self) -> Dict[str, int]:
        return {"epoch": self._epoch, "batch": self._batch}

    def set_state(self, state: Dict[str, int]) -> None:
        if self._it is not None:
            self._it.close()
            self._it = None
        self._epoch = int(state["epoch"])
        self._batch = int(state["batch"])
