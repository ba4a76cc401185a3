"""Weight bridge: the JAX package's variable trees -> the port's
state_dicts.

Input trees are nested dicts of numpy arrays, as the JAX serving
loaders return them (`{params, frozen, batch_stats}` for GLN;
`(params, batch_stats)` for MACVGG). This module reads no checkpoint
itself. Layout changes: conv kernels HWIO -> OIHW; FrozenBN
`scale/bias/mean/var` -> `weight/bias/running_mean/running_var`; flax
BatchNorm likewise plus a `num_batches_tracked` counter. Module paths
keep the JAX names (`body.layer2_0.conv1`), and the detector head needs
no reordering: the port flattens its NCHW outputs in the same
(y, x, anchor) order the JAX head uses.

The int8 path's `act_scales` collection is not part of a state_dict: the
port keeps each scale in its Int8Conv's buffer, and `load_act_scales`
copies a JAX tree of them there (same module paths for GLN, `f{idx}` ->
`features.{idx}` for MACVGG). Int8Conv keeps nn.Conv's parameter names,
so int8 models take the same state_dicts.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from ..models import quant

_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _leaves(tree, trail=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _leaves(v, trail + (str(k),))
    else:
        yield trail, np.asarray(tree)


def _convert(trees, rename_module=lambda path: path
             ) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    for coll, tree in trees:
        for path, arr in _leaves(tree):
            *mods, leaf = path
            mods = [m for m in mods if m != "fbn"]
            if leaf not in _LEAF:
                raise KeyError(f"unexpected leaf {'/'.join(path)}")
            if leaf == "kernel" and arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            name = ".".join(rename_module(mods))
            out[f"{name}.{_LEAF[leaf]}"] = torch.from_numpy(
                np.array(arr, np.float32))
            if coll == "batch_stats":
                bn_modules.add(name)
    for name in bn_modules:
        out[f"{name}.num_batches_tracked"] = torch.tensor(0)
    return out


def gln_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """GLN variables {params, frozen, batch_stats} -> models.gln.GLN
    state_dict."""
    return _convert([(c, variables[c])
                     for c in ("params", "frozen", "batch_stats")
                     if c in variables])


def macvgg_state_dict(params: Mapping, batch_stats: Mapping
                      ) -> Dict[str, torch.Tensor]:
    """MACVGG (params, batch_stats) with flax names f{idx} ->
    models.embedders.MACVGG state_dict (features.{idx}.*)."""
    def rename(mods):
        if len(mods) != 1 or not mods[0].startswith("f"):
            raise KeyError(f"not a MACVGG layer: {'/'.join(mods)}")
        return ["features", mods[0][1:]]

    return _convert([("params", params), ("batch_stats", batch_stats)],
                    rename)


# a JAX `act_scales` tree (numpy or float leaves) -> the Int8Conv buffers
# of a port GLN or MACVGG; a layer without a scale in the tree raises
load_act_scales = quant.load_act_scales
