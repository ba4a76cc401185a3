"""Weight bridge: the JAX package's variable trees <-> the port's
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

`gln_variables`, `macvgg_variables` and `gan_variables` go the other
way, for the port's orbax exports (pipeline/serving.py) and training
checkpoints (train/checkpoint.py): each undoes a step of `_convert`
(OIHW -> HWIO, the `fbn` level put back, flax's leaf names, the counter
dropped) and sorts the state_dict into flax's collections by the port's
module types, read off the state_dict: a module with running statistics
and a `num_batches_tracked` counter is a BatchNorm (its affine to
`params`, its statistics to `batch_stats`), one without the counter a
FrozenBatchNorm (all four to `frozen`), anything else a conv (`params`).
Every leaf comes back as f32 numpy, as the JAX package stores it. The
`*_parameter_tree` functions lay a per-parameter tensor (an optimizer's
momentum or Adam moment, by parameter name) out as the model's flax
`params` tree, each in its parameter's layout: optax keeps its states
in that tree.

The int8 path's `act_scales` collection is not part of a state_dict: the
port keeps each scale in its Int8Conv's buffer, and `load_act_scales`
copies a JAX tree of them there (same module paths for GLN, `f{idx}` ->
`features.{idx}` for MACVGG). Int8Conv keeps nn.Conv's parameter names,
so int8 models take the same state_dicts.
"""
from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Optional, Tuple

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


_FROZEN = {"weight": "scale", "bias": "bias", "running_mean": "mean",
           "running_var": "var"}
_BN = {"weight": ("params", "scale"), "bias": ("params", "bias"),
       "running_mean": ("batch_stats", "mean"),
       "running_var": ("batch_stats", "var")}
_CONV = {"weight": "kernel", "bias": "bias"}


def _placement(state_dict: Mapping[str, torch.Tensor], rename_module,
               transposed) -> Dict[str, Tuple[str, Tuple[str, ...], str]]:
    """state_dict key -> (flax collection, path in it, layout): `conv`
    for an OIHW kernel (to HWIO), `transposed` for a ConvTranspose
    kernel ((in, out, kh, kw) flipped, to HWIO), else `same`. The
    BatchNorm counters have no place and are left out."""
    modules: Dict[str, list] = {}
    for key in state_dict:
        name, _, leaf = key.rpartition(".")
        modules.setdefault(name, []).append(leaf)
    out = {}
    for name, leaves in modules.items():
        mods = rename_module(name.split("."))
        norm = "running_mean" in leaves
        bn = norm and "num_batches_tracked" in leaves
        table = _BN if bn else _FROZEN if norm else _CONV
        for leaf in leaves:
            if bn and leaf == "num_batches_tracked":
                continue
            if leaf not in table:
                raise KeyError(f"unexpected state_dict entry {name}.{leaf}")
            layout = "same"
            if table is _BN:
                coll, flax_leaf = _BN[leaf]
                where = (coll, tuple(mods) + (flax_leaf,))
            elif table is _FROZEN:
                where = ("frozen", tuple(mods) + ("fbn", _FROZEN[leaf]))
            else:
                where = ("params", tuple(mods) + (_CONV[leaf],))
                if leaf == "weight" and state_dict[f"{name}.{leaf}"].dim() == 4:
                    layout = "transposed" if transposed(mods) else "conv"
            out[f"{name}.{leaf}"] = where + (layout,)
    return out


def _to_flax(value: torch.Tensor, layout: str) -> np.ndarray:
    arr = value.detach().cpu().float().numpy()
    if layout == "conv":
        arr = arr.transpose(2, 3, 1, 0)
    elif layout == "transposed":  # `_convert`'s flip undone
        arr = arr[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
    return np.array(arr, np.float32, order="C")


def _put(tree: Dict, path: Tuple[str, ...], value) -> None:
    for m in path[:-1]:
        tree = tree.setdefault(m, {})
    tree[path[-1]] = value


def _variables(state_dict: Mapping[str, torch.Tensor],
               collections: Tuple[str, ...],
               rename_module=lambda mods: mods,
               transposed=lambda mods: False) -> Dict[str, Dict]:
    """`_convert`'s inverse: flax collections of numpy f32 trees."""
    out: Dict[str, Dict] = {c: {} for c in collections}
    for key, (coll, path, layout) in _placement(
            state_dict, rename_module, transposed).items():
        if coll not in out:
            raise KeyError(f"{key}: a {coll} leaf, which this model's "
                           "variables do not hold")
        _put(out[coll], path, _to_flax(state_dict[key], layout))
    return out


def _parameter_tree(module: torch.nn.Module,
                    values: Mapping[str, Optional[torch.Tensor]],
                    rename_module=lambda mods: mods,
                    transposed=lambda mods: False) -> Dict:
    """A per-parameter tensor of `module` (an optimizer's momentum or
    moment, named by its parameter) as a tree of its `params`
    collection, each in its parameter's layout; None where the value is
    None (a parameter optax masks out). Every parameter needs a value."""
    placement = _placement(module.state_dict(), rename_module, transposed)
    tree: Dict = {}
    for name, _ in module.named_parameters():
        if name not in values:
            raise KeyError(f"no value for parameter {name}")
        _, path, layout = placement[name]
        v = values[name]
        _put(tree, path, None if v is None else _to_flax(v, layout))
    return tree


def gln_variables(state_dict: Mapping[str, torch.Tensor]
                  ) -> Dict[str, Dict]:
    """models.gln.GLN state_dict -> GLN variables {params, frozen,
    batch_stats} with flax's names (`gln_state_dict`'s inverse)."""
    return _variables(state_dict, ("params", "frozen", "batch_stats"))


def _macvgg_rename(mods):
    if len(mods) != 2 or mods[0] != "features":
        raise KeyError(f"not a MACVGG layer: {'.'.join(mods)}")
    return [f"f{mods[1]}"]


def macvgg_variables(state_dict: Mapping[str, torch.Tensor]
                     ) -> Tuple[Dict, Dict]:
    """models.embedders.MACVGG state_dict (features.{idx}.*) ->
    (params, batch_stats) with flax's names f{idx}
    (`macvgg_state_dict`'s inverse)."""
    v = _variables(state_dict, ("params", "batch_stats"), _macvgg_rename)
    return v["params"], v["batch_stats"]


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


def _gan_rename(mods):
    if not mods or not _GAN_MODULE.fullmatch(mods[-1]) or any(
            m != "d" for m in mods[:-1]):
        raise KeyError(f"not a GAN layer: {'/'.join(mods)}")
    return mods


def _gan_transposed(mods) -> bool:
    return re.fullmatch(r"up_\d+", mods[-1]) is not None


def gan_state_dict(params: Mapping, batch_stats: Mapping
                   ) -> Dict[str, torch.Tensor]:
    """UNetGenerator or AveragingPatchGAN (params, batch_stats) ->
    models.gan state_dict, module names kept (`down_bn_1`,
    `d.conv_3`). Conv kernels HWIO -> OIHW; the generator's
    ConvTranspose kernels (`up_{i}`) HWIO -> (in, out, kh, kw), flipped
    in both spatial axes."""
    return _convert([("params", params), ("batch_stats", batch_stats)],
                    _gan_rename, _gan_transposed)


def gan_variables(state_dict: Mapping[str, torch.Tensor]
                  ) -> Tuple[Dict, Dict]:
    """models.gan UNetGenerator or AveragingPatchGAN state_dict ->
    (params, batch_stats) with flax's names (`gan_state_dict`'s
    inverse: the ConvTranspose kernels unflipped back to HWIO)."""
    v = _variables(state_dict, ("params", "batch_stats"), _gan_rename,
                   _gan_transposed)
    return v["params"], v["batch_stats"]


def gln_parameter_tree(model: torch.nn.Module,
                       values: Mapping[str, Optional[torch.Tensor]]) -> Dict:
    """Per-parameter tensors of a models.gln.GLN (by parameter name) as
    a tree of its flax `params`, None where a value is None."""
    return _parameter_tree(model, values)


def macvgg_parameter_tree(model: torch.nn.Module,
                          values: Mapping[str, torch.Tensor]) -> Dict:
    """Per-parameter tensors of a MACVGG as a tree of its flax params."""
    return _parameter_tree(model, values, _macvgg_rename)


def gan_parameter_tree(model: torch.nn.Module,
                       values: Mapping[str, torch.Tensor]) -> Dict:
    """Per-parameter tensors of a UNetGenerator or AveragingPatchGAN as
    a tree of its flax params."""
    return _parameter_tree(model, values, _gan_rename, _gan_transposed)


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
