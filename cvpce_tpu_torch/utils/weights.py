"""Weight bridge: the JAX package's variable trees -> the port's
state_dicts.

Input trees are nested dicts of numpy arrays, as the JAX serving
loaders return them (`{params, frozen, batch_stats}` for GLN;
`(params, batch_stats)` for MACVGG, MACResNet and the GAN players).
This module reads no checkpoint itself. Layout changes: conv kernels
HWIO -> OIHW (ConvTranspose kernels -> (in, out, kh, kw), flipped);
FrozenBN `scale/bias/mean/var` -> `weight/bias/running_mean/running_var`;
flax BatchNorm likewise plus a `num_batches_tracked` counter. Module paths
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

import re
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


def _convert(trees, rename_module=lambda path: path,
             transposed=lambda mods: False) -> Dict[str, torch.Tensor]:
    out: Dict[str, torch.Tensor] = {}
    bn_modules = set()
    for coll, tree in trees:
        for path, arr in _leaves(tree):
            *mods, leaf = path
            mods = [m for m in mods if m != "fbn"]
            if leaf not in _LEAF:
                raise KeyError(f"unexpected leaf {'/'.join(path)}")
            if leaf == "kernel" and arr.ndim == 4 and transposed(mods):
                # flax applies a ConvTranspose kernel unflipped, torch's
                # ConvTranspose2d flipped
                arr = arr.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            elif leaf == "kernel" and arr.ndim == 4:
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


def macresnet_state_dict(params: Mapping, batch_stats: Mapping
                         ) -> Dict[str, torch.Tensor]:
    """MACResNet (params, batch_stats) -> models.embedders.MACResNet
    state_dict: `trunk/.../bnZ/bn/{scale,bias}` -> `trunk....bnZ.weight /
    .bias`, `batch_stats/.../{mean,var}` -> `running_mean / running_var`,
    conv kernels HWIO -> OIHW."""
    return _convert([("params", params), ("batch_stats", batch_stats)],
                    lambda mods: [m for m in mods if m != "bn"])


_GAN_MODULE = re.compile(r"(down|down_bn|up|up_bn|conv|bn)_\d+")


def gan_state_dict(params: Mapping, batch_stats: Mapping
                   ) -> Dict[str, torch.Tensor]:
    """UNetGenerator or AveragingPatchGAN (params, batch_stats) ->
    models.gan state_dict, module names kept (`down_bn_1`,
    `d.conv_3`). Conv kernels HWIO -> OIHW; the generator's
    ConvTranspose kernels (`up_{i}`) HWIO -> (in, out, kh, kw), flipped
    in both spatial axes."""
    def rename(mods):
        if not mods or not _GAN_MODULE.fullmatch(mods[-1]) or any(
                m != "d" for m in mods[:-1]):
            raise KeyError(f"not a GAN layer: {'/'.join(mods)}")
        return mods

    return _convert([("params", params), ("batch_stats", batch_stats)],
                    rename, lambda mods: re.fullmatch(r"up_\d+", mods[-1])
                    is not None)


def dihe_state_dict(state) -> Dict[str, Dict[str, torch.Tensor]]:
    """The three players of a JAX `DIHETrainState` (anything with its
    `emb_params`, `emb_stats`, `gen_params`, ... attributes, as numpy
    trees) -> {"embedder", "generator", "discriminator"} state_dicts of
    MACVGG, UNetGenerator and AveragingPatchGAN."""
    return {"embedder": macvgg_state_dict(state.emb_params, state.emb_stats),
            "generator": gan_state_dict(state.gen_params, state.gen_stats),
            "discriminator": gan_state_dict(state.disc_params,
                                            state.disc_stats)}


# a JAX `act_scales` tree (numpy or float leaves) -> the Int8Conv buffers
# of a port GLN or MACVGG; a layer without a scale in the tree raises
load_act_scales = quant.load_act_scales
