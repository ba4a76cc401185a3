"""Weight loading for the detector and the embedder from reference torch
checkpoints; counterpart of cvpce_tpu/cli/common.py (its loaders; the
commands come later).

A checkpoint overlays a model built from its config (`_merge`): a key
the model lacks raises KeyError and a shape mismatch ValueError, both
naming the key, so a checkpoint of another architecture fails at load
time. A directory is an orbax export of the JAX package, which the port
cannot read (ROADMAP.md, Queue 1 item 7), and raises.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..models.embedders import EmbedFn, MACResNet, MACVGG, fold_bn_variables
from ..models.gln import GLN, GLNConfig
from ..utils.torch_import import (import_gln, import_resnet50,
                                  import_vgg16_features, load_state_dict)

# reference MACVGG checkpoints hold `block1` = vgg.features[:cut] and
# `block2` = vgg.features[cut:...], each renumbered from 0: the cut is at
# the pool after block 4 (classification.py:36-37)
MACVGG_BLOCK2_OFFSET = {True: 33, False: 23}


def default_gln_config(fast: bool = False) -> GLNConfig:
    """Inference config: f32 by default; `fast` runs the conv stacks in
    bf16. The JAX package's `fast` also takes an approximate per-level
    top-k, which the port leaves out by design (exact top-k only)."""
    return GLNConfig(compute_dtype="bfloat16") if fast else GLNConfig()


def _refuse_directory(weights: str) -> None:
    if os.path.isdir(weights):
        raise ValueError(
            f"{weights} is a directory: orbax exports of the JAX package "
            "cannot be read by the port (ROADMAP.md, Queue 1 item 7)")


def load_gln_state_dict(weights: Optional[str], config: GLNConfig,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
    """GLN state_dict for `config`: a seeded random init from `generator`
    (seed 0 when none is given) when `weights` is None, else a reference
    GaussianLayerNetwork checkpoint file mapped by `import_gln` onto that
    init and loaded strictly."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = GLN(config, generator=generator)
    if weights is None:
        return model.state_dict()
    _refuse_directory(weights)
    imported = import_gln(load_state_dict(weights))
    model.load_state_dict(_merge(model.state_dict(), imported), strict=True)
    return model.state_dict()


def load_embedder(weights: Optional[str], batch_norm: bool = True,
                  encoder: str = "vgg16", int8: bool = False,
                  resnet_layers: Sequence[int] = (2, 3),
                  device="cuda") -> Tuple[EmbedFn, int]:
    """(EmbedFn on `device`, embedding size).

    `encoder='vgg16'`: MACVGG from torchvision vgg16(_bn) `features.*`
    or a reference MACVGG checkpoint (`block1.` / `block2.` slices). Its
    BatchNorms are folded into the convs for serving. `int8` serves the
    folded model in bf16 with every conv but conv1_1 in static int8.
    `encoder='resnet50'`: MACResNet from torchvision resnet50 names, with
    descriptor stages c(l + 1) for l in `resnet_layers` (reference
    layers [2, 3] -> c3 + c4, 1536-d); `int8` serves it in bf16 with
    quant='static'. Static int8 scales are calibrated by the Classifier
    on its gallery, or by the EmbedFn on its first batch. `weights=None`
    gives a seeded random init (seed 0)."""
    generator = torch.Generator().manual_seed(0)
    dtype = torch.bfloat16 if int8 else torch.float32
    if encoder == "resnet50":
        model = MACResNet(
            descriptor_stages=tuple(f"c{layer + 1}" for layer in resnet_layers),
            dtype=dtype, quant="static" if int8 else None,
            generator=generator)
        if weights is not None:
            _refuse_directory(weights)
            imported = import_resnet50(load_state_dict(weights), "batch",
                                       prefix="trunk.")
            model.load_state_dict(_merge(model.state_dict(), imported))
        return EmbedFn(model, device=device), model.embedding_size
    if encoder != "vgg16":
        raise ValueError(f"unknown encoder {encoder!r}")

    served = dict(int8_all=int8, int8_static=int8, dtype=dtype)
    # a BN checkpoint loads into the f32 BN model, whose BatchNorms then
    # fold into the serving model; a BN-free one loads into it directly
    model = MACVGG(batch_norm=batch_norm, generator=generator,
                   **({} if batch_norm else served))
    if weights is not None:
        _refuse_directory(weights)
        sd = load_state_dict(weights)
        if any(k.startswith("features.") for k in sd):
            imported = import_vgg16_features(sd, batch_norm)
        elif any(k.startswith("block1.") for k in sd):
            offset = MACVGG_BLOCK2_OFFSET[batch_norm]
            remapped = {}
            for k, v in sd.items():
                if k.startswith("block1."):
                    remapped["features." + k[len("block1."):]] = v
                elif k.startswith("block2."):
                    idx, tail = k[len("block2."):].split(".", 1)
                    remapped[f"features.{int(idx) + offset}.{tail}"] = v
            imported = import_vgg16_features(remapped, batch_norm)
        else:
            raise ValueError("unrecognized embedder checkpoint layout")
        model.load_state_dict(_merge(model.state_dict(), imported))
    if batch_norm:
        model = fold_bn_variables(model, **served)
    return EmbedFn(model, device=device), model.embedding_size


def _merge(base: Dict[str, torch.Tensor], update: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    """`update` overlaid on `base` (a model's state_dict): every key of
    `update` must be in `base` (KeyError) with the same shape
    (ValueError)."""
    out = dict(base)
    for k, v in update.items():
        if k not in out:
            raise KeyError(
                f"checkpoint key {k!r} is not in the model's state_dict "
                f"({len(out)} keys): wrong checkpoint for this "
                "architecture or config?")
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(
                f"shape mismatch for {k}: model {tuple(out[k].shape)} vs "
                f"checkpoint {tuple(v.shape)}")
        out[k] = v
    return out
