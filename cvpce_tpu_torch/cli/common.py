"""Weight loading for the detector and the embedder, shared by the
commands; counterpart of cvpce_tpu/cli/common.py.

Weights are a file or a directory. A file is a reference torch
checkpoint or a training checkpoint the port wrote before its nodes
became orbax directories (`torch.save` of a train state's
`state_dict()`, e.g. `<run>/checkpoint` or `<run>/epoch_3`). A directory
is a training run, one of its checkpoint nodes (`<run>/epoch_3`) or a
serving export (pipeline/serving.py), of the port or of the JAX package
(orbax directories, read by utils/orbax_read.py), taken as the JAX
package takes its orbax directories (`_load_gln_orbax`): what a run
saved, a command loads. A reference checkpoint overlays a model built
from its config (`_merge`): a key the model lacks raises KeyError and a
shape mismatch ValueError, both naming the key, so a checkpoint of
another architecture fails at load time. The port's own checkpoints and
exports load strictly. A file of no known layout raises ValueError
naming the keys it holds.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import torch

from ..models.embedders import EmbedFn, MACResNet, MACVGG, fold_bn_variables
from ..models.gln import GLN, GLNConfig
from ..pipeline.serving import (DIHE_PART, GLN_PART, SERVING_NAME,
                                load_dihe_encoder, load_gln_variables)
from ..utils.torch_import import (flat_state_dict, import_gln,
                                  import_resnet50, import_vgg16_features)

# reference MACVGG checkpoints hold `block1` = vgg.features[:cut] and
# `block2` = vgg.features[cut:...], each renumbered from 0: the cut is at
# the pool after block 4 (classification.py:36-37)
MACVGG_BLOCK2_OFFSET = {True: 33, False: 23}


def default_gln_config(fast: bool = False) -> GLNConfig:
    """Inference config: f32 by default; `fast` runs the conv stacks in
    bf16. The JAX package's `fast` also takes an approximate per-level
    top-k, which the port leaves out by design (exact top-k only)."""
    return GLNConfig(compute_dtype="bfloat16") if fast else GLNConfig()


def _read(weights: str):
    if os.path.isdir(weights):
        raise ValueError(
            f"{weights} is a directory: this loader reads checkpoint "
            "files only")
    return torch.load(weights, map_location="cpu", weights_only=True)


def _directory(ckpt_dir: str, node: str, load):
    """`load(run, name)` of a directory: a training run or a serving
    export (`load(dir)`); else the directory is taken as a checkpoint
    node inside a run (an orbax node such as `<run>/epoch_3`)."""
    d = os.path.normpath(ckpt_dir)
    if (os.path.exists(os.path.join(d, SERVING_NAME))
            or os.path.exists(os.path.join(d, node))):
        return load(d)
    return load(os.path.dirname(d), name=os.path.basename(d))


def _gln_directory(ckpt_dir: str) -> Dict[str, torch.Tensor]:
    """The GLN state_dict of a directory (JAX's `_load_gln_orbax`)."""
    return _directory(ckpt_dir, "checkpoint", load_gln_variables)


def _train_state_part(obj, part: str) -> Optional[Dict[str, torch.Tensor]]:
    """`obj[part]` where `obj` is a `torch.save` training checkpoint of
    the port's earlier runs holding `part`, else None."""
    if isinstance(obj, dict) and "step" in obj \
            and isinstance(obj.get(part), dict):
        return obj[part]
    return None


def _unknown_layout(weights: str, obj, wanted: str) -> ValueError:
    keys = (sorted(map(str, obj))[:12] if isinstance(obj, dict)
            else type(obj).__name__)
    return ValueError(f"{weights}: unrecognized checkpoint layout, not "
                      f"{wanted}; its top-level keys are {keys}")


def load_gln_state_dict(weights: Optional[str], config: GLNConfig,
                        generator: Optional[torch.Generator] = None,
                        param_dtype: Optional[torch.dtype] = None
                        ) -> Dict[str, torch.Tensor]:
    """GLN state_dict for `config`: a seeded random init from `generator`
    (seed 0 when none is given) when `weights` is None; else a reference
    GaussianLayerNetwork checkpoint file mapped by `import_gln` onto that
    init, the port's GLN training checkpoint (`checkpoint`, `epoch_<e>`:
    its `model`), or a directory (a run or a serving export), each
    loaded strictly.

    The conv tensors come in `param_dtype` (GLN's), by default
    `config`'s compute dtype, as a serving GLN stores them. Training
    asks for f32 whatever the compute dtype: a bf16 run keeps f32
    master weights, and starts from the file's f32 values, as the JAX
    package loads f32 parameters under any compute dtype."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = GLN(config, generator=generator, param_dtype=param_dtype)
    if weights is None:
        return model.state_dict()
    if os.path.isdir(weights):
        model.load_state_dict(_gln_directory(weights), strict=True)
        return model.state_dict()
    obj = _read(weights)
    own = _train_state_part(obj, GLN_PART)
    if own is not None:
        model.load_state_dict(own, strict=True)
        return model.state_dict()
    sd = flat_state_dict(obj) if isinstance(obj, dict) else {}
    if not any(k.startswith(("backbone.", "head.")) for k in sd):
        raise _unknown_layout(
            weights, obj, "a reference GaussianLayerNetwork checkpoint "
            "(backbone.*, head.*) nor the port's GLN training checkpoint "
            "(model, optimizer, step)")
    model.load_state_dict(_merge(model.state_dict(), import_gln(sd)),
                          strict=True)
    return model.state_dict()


def load_embedder(weights: Optional[str], batch_norm: bool = True,
                  encoder: str = "vgg16", int8: bool = False,
                  resnet_layers: Sequence[int] = (2, 3),
                  device="cuda") -> Tuple[EmbedFn, int]:
    """(EmbedFn on `device`, embedding size).

    `encoder='vgg16'`: MACVGG from torchvision vgg16(_bn) `features.*`,
    a reference MACVGG checkpoint (`block1.` / `block2.` slices), a
    `torch.save` DIHE training checkpoint of the port's earlier runs
    (`embedder_checkpoint`, `epoch_<e>`: its `embedder`, loaded
    strictly) or a directory: a DIHE run, one of its checkpoint nodes
    or a serving export, of the port or of the JAX package
    (pipeline/serving.py:load_dihe_encoder, loaded strictly; a GLN's
    raises). Its BatchNorms are
    folded into the convs for serving. `int8` serves the
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
            imported = import_resnet50(flat_state_dict(_read(weights)),
                                       "batch", prefix="trunk.")
            model.load_state_dict(_merge(model.state_dict(), imported))
        return EmbedFn(model, device=device), model.embedding_size
    if encoder != "vgg16":
        raise ValueError(f"unknown encoder {encoder!r}")

    served = dict(int8_all=int8, int8_static=int8, dtype=dtype)
    # a BN checkpoint loads into the f32 BN model, whose BatchNorms then
    # fold into the serving model; a BN-free one loads into it directly
    model = MACVGG(batch_norm=batch_norm, generator=generator,
                   **({} if batch_norm else served))
    if weights is not None and os.path.isdir(weights):
        model.load_state_dict(
            _directory(weights, "embedder_checkpoint", load_dihe_encoder),
            strict=True)
    elif weights is not None:
        obj = _read(weights)
        own = _train_state_part(obj, DIHE_PART)
        if own is not None:
            model.load_state_dict(own, strict=True)
        else:
            model.load_state_dict(_merge(model.state_dict(),
                                         _import_macvgg(weights, obj,
                                                        batch_norm)))
    if batch_norm:
        model = fold_bn_variables(model, **served)
    return EmbedFn(model, device=device), model.embedding_size


def _import_macvgg(weights: str, obj, batch_norm: bool
                   ) -> Dict[str, torch.Tensor]:
    sd = flat_state_dict(obj) if isinstance(obj, dict) else {}
    if any(k.startswith("features.") for k in sd):
        return import_vgg16_features(sd, batch_norm)
    if any(k.startswith("block1.") for k in sd):
        offset = MACVGG_BLOCK2_OFFSET[batch_norm]
        remapped = {}
        for k, v in sd.items():
            if k.startswith("block1."):
                remapped["features." + k[len("block1."):]] = v
            elif k.startswith("block2."):
                idx, tail = k[len("block2."):].split(".", 1)
                remapped[f"features.{int(idx) + offset}.{tail}"] = v
        return import_vgg16_features(remapped, batch_norm)
    raise _unknown_layout(
        weights, obj, "a torchvision vgg16 (features.*) or reference "
        "MACVGG (block1.*, block2.*) checkpoint nor the port's DIHE "
        "training checkpoint (embedder, ..., step)")


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
