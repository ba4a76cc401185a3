"""Gallery-sharded kNN over the ranks of a data-parallel mesh;
counterpart of cvpce_tpu/ops/knn_sharded.py.

The gallery is padded to a multiple of the rank count and each rank
holds one row block on its device. A search takes every rank's k
nearest rows of its own block (global indices), gathers the (n, Q, k)
candidates and merges them by (distance, index), which reproduces the
single-process search, ties to the lowest index included: splitting
the gallery's rows does not touch the D-long reduction of any distance.
Communication is O(n·Q·k), independent of the gallery's size.

The local search is the fused kNN kernel (K2, ops/knn.py) on the card
for a block of at least `FUSED_MIN_ROWS` valid rows and k <= 8, run on
the block's valid prefix (pad rows sit only at the end of the last
block, and the kernel masks the rows past the prefix's end itself);
otherwise the masked plain search, pad rows at +inf distance.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..parallel.mesh import DataParallelMesh, all_gather
from .knn import (FUSED_MIN_ROWS, MAX_K, inverse_norms, knn_masked,
                  nearest_neighbors_fused)


def pad_gallery(anchors: np.ndarray, n_shards: int,
                valid: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad the gallery's rows to a multiple of the shard count.

    Returns (anchors_padded, valid_padded); pad rows are zero vectors
    with valid=False, which the sharded search ranks at +inf distance."""
    a = np.asarray(anchors)
    n = a.shape[0]
    if valid is None:
        valid = np.ones((n,), bool)
    pad = (-n) % n_shards
    if pad:
        a = np.concatenate([a, np.zeros((pad, a.shape[1]), a.dtype)])
        valid = np.concatenate([valid, np.zeros((pad,), bool)])
    return a, valid


def gallery_sharding(mesh: DataParallelMesh) -> Callable:
    """The placement of the padded gallery (and of its mask): this
    rank's row block, a tensor on the mesh's device."""
    def place(x) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        rows = t.shape[0] // mesh.size
        if rows * mesh.size != t.shape[0]:
            raise ValueError(f"{t.shape[0]} rows do not divide over "
                             f"{mesh.size} ranks: pad_gallery first")
        return t[mesh.rank * rows:(mesh.rank + 1) * rows].contiguous().to(
            mesh.device)
    return place


class _ShardedSearch:
    """(block, block_valid, queries) -> (distances (Q, k) f32, global
    indices (Q, k) int64), the same on every rank. What the local search
    needs of a block (its valid count, whether the valid rows are a
    prefix, K2's inverse norms) is taken once and kept while the same
    block tensors, unchanged, come back."""

    def __init__(self, mesh: DataParallelMesh, k: int):
        self.mesh = mesh
        self.k = k
        self._key = None
        self._prep = None

    def _prepare(self, block: torch.Tensor, valid: torch.Tensor):
        try:
            key = (block.data_ptr(), block._version, tuple(block.shape),
                   valid.data_ptr(), valid._version)
        except RuntimeError:  # an inference tensor keeps no version
            key = None
        if key is None or key != self._key:
            n_valid = int(valid.sum())
            prefix = bool(valid[:n_valid].all())
            fused = (prefix and n_valid >= FUSED_MIN_ROWS
                     and self.k <= MAX_K)
            inv = inverse_norms(block[:n_valid]) if fused else None
            self._key, self._prep = key, (n_valid, fused, inv)
        return self._prep

    def __call__(self, block: torch.Tensor, valid: torch.Tensor,
                 queries: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        mesh = self.mesh
        n_valid, fused, inv = self._prepare(block, valid)
        q = queries.to(block.device, torch.float32)
        if fused:
            dists, idx = nearest_neighbors_fused(block[:n_valid], q,
                                                 self.k, inv)
        else:
            dists, idx = knn_masked(block, valid, q,
                                    min(self.k, block.shape[0]))
        idx = idx.long() + mesh.rank * block.shape[0]
        dists = torch.cat(all_gather(dists.contiguous(), mesh), dim=1)
        idx = torch.cat(all_gather(idx.contiguous(), mesh), dim=1)
        # lexicographic (distance, index): by index, then stably by
        # distance
        order = torch.argsort(idx, dim=1, stable=True)
        dists, idx = dists.gather(1, order), idx.gather(1, order)
        order = torch.argsort(dists, dim=1, stable=True)
        dists, idx = dists.gather(1, order), idx.gather(1, order)
        return dists[:, :self.k], idx[:, :self.k]


def make_sharded_nn(mesh: DataParallelMesh, k: int) -> Callable:
    """A (anchors, anchor_valid, queries) -> (distances, indices)
    sharded search. `anchors` (A/n, D) and `anchor_valid` (A/n,) are this
    rank's blocks of the padded gallery (`pad_gallery`, then
    `gallery_sharding` once when the index loads); the queries are the
    same on every rank. Returns ascending (Q, k) f32 distances and int64
    global indices, every rank the same, equal to the single-process
    search on the unpadded gallery (ties to the lowest index)."""
    return _ShardedSearch(mesh, k)


def sharded_nearest_neighbors(anchors, queries, k: int,
                              mesh: DataParallelMesh) -> torch.Tensor:
    """One-shot `nearest_neighbors(anchors, queries, k)` over the mesh:
    pads and places the gallery, returns (Q, k) global indices. For
    repeated searches keep the placed blocks and a `make_sharded_nn`
    search."""
    a, valid = pad_gallery(np.asarray(anchors, np.float32), mesh.size)
    place = gallery_sharding(mesh)
    q = queries if torch.is_tensor(queries) else torch.from_numpy(
        np.asarray(queries, np.float32))
    return make_sharded_nn(mesh, k)(place(a), place(valid), q)[1]
