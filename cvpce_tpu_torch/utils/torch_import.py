"""Reference torch checkpoints -> the port's state_dicts; counterpart of
cvpce_tpu/utils/torch_import.py.

The reference ships torch checkpoints (GaussianLayerNetwork, MACVGG as
two Sequential slices of vgg16(_bn) `features`) and starts from
torchvision's resnet50 and vgg16(_bn). Both sides are torch, so this
module only maps names: torchvision's `layer1.0.downsample.0` is the
port's `layer1_0.downsample_conv`, and so on; weights keep their OIHW
layout. Every tensor comes out f32 on the CPU, and each nn.BatchNorm2d
of the port (`norm='batch'`, the Gaussian branch, MACVGG's) gets a
`num_batches_tracked` of 0, as the flax bridge (utils/weights.py) gives
it. FrozenBatchNorm keeps `weight / bias / running_mean / running_var`.
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..models.embedders import _vgg_plan

RESNET50_STAGES = (3, 4, 6, 3)


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", torch.float32).clone()


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint file -> a flat state_dict (`flat_state_dict`).
    Only tensors and plain containers are unpickled."""
    return flat_state_dict(
        torch.load(path, map_location="cpu", weights_only=True))


def flat_state_dict(obj) -> Dict[str, torch.Tensor]:
    """A loaded checkpoint -> a flat state_dict: unwrapped from
    `state_dict` or `model_state_dict` (the reference nests there) and
    from `model`, with a leading `module.` (DataParallel) stripped from
    each key."""
    for key in ("state_dict", "model_state_dict"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    if isinstance(obj, dict) and "model" in obj and hasattr(
            next(iter(obj["model"].values()), None), "shape"):
        obj = obj["model"]
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in obj.items()}


def _norm(sd: Mapping, src: str, out: Dict, dst: str, kind: str) -> None:
    for leaf in ("weight", "bias", "running_mean", "running_var"):
        out[f"{dst}.{leaf}"] = _f32(sd[f"{src}.{leaf}"])
    if kind == "batch":
        out[f"{dst}.num_batches_tracked"] = torch.tensor(0)


def import_resnet50(sd: Mapping, norm: str = "frozen",
                    torch_prefix: str = "", prefix: str = "",
                    out: Dict | None = None) -> Dict[str, torch.Tensor]:
    """torchvision resnet50 names (under `torch_prefix`, e.g.
    'backbone.body.' in a GLN checkpoint) -> models.resnet.ResNet50 names
    under `prefix` ('body.' in GLN, 'trunk.' in MACResNet). `norm`:
    'frozen' or 'batch'. The fc head, if present, is not read."""
    if norm not in ("frozen", "batch"):
        raise ValueError(f"unknown norm {norm!r}")
    out = out if out is not None else {}
    tp, p = torch_prefix, prefix
    out[f"{p}conv1.weight"] = _f32(sd[f"{tp}conv1.weight"])
    _norm(sd, f"{tp}bn1", out, f"{p}bn1", norm)
    for si, blocks in enumerate(RESNET50_STAGES):
        for bi in range(blocks):
            t = f"{tp}layer{si + 1}.{bi}"
            f = f"{p}layer{si + 1}_{bi}"
            for ci in (1, 2, 3):
                out[f"{f}.conv{ci}.weight"] = _f32(sd[f"{t}.conv{ci}.weight"])
                _norm(sd, f"{t}.bn{ci}", out, f"{f}.bn{ci}", norm)
            if f"{t}.downsample.0.weight" in sd:
                out[f"{f}.downsample_conv.weight"] = _f32(
                    sd[f"{t}.downsample.0.weight"])
                _norm(sd, f"{t}.downsample.1", out, f"{f}.downsample_bn",
                      norm)
    return out


def import_vgg16_features(sd: Mapping, batch_norm: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """torchvision vgg16(_bn) `features.*` -> models.embedders.MACVGG
    (`features.{idx}`, the same torchvision indices): every conv's weight
    and bias and, with `batch_norm`, every BatchNorm's."""
    out: Dict[str, torch.Tensor] = {}
    for kind, idx, _ in _vgg_plan(batch_norm):
        if kind == "conv":
            for leaf in ("weight", "bias"):
                key = f"features.{idx}.{leaf}"
                out[key] = _f32(sd[key])
        elif kind == "bn":
            _norm(sd, f"features.{idx}", out, f"features.{idx}", "batch")
    return out


def _conv(sd: Mapping, src: str, out: Dict, dst: str) -> None:
    out[f"{dst}.weight"] = _f32(sd[f"{src}.weight"])
    if f"{src}.bias" in sd:
        out[f"{dst}.bias"] = _f32(sd[f"{src}.bias"])


def import_gln(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A reference GLN checkpoint (GaussianLayerNetwork: torchvision's
    RetinaNet layout plus `backbone.gaussian_layer` and
    `backbone.gaussian_subnet`) -> models.gln.GLN state_dict: body, FPN,
    the Gaussian layer and subnet, and both heads."""
    out: Dict[str, torch.Tensor] = {}
    import_resnet50(sd, "frozen", "backbone.body.", "body.", out)
    for i in range(3):
        _conv(sd, f"backbone.fpn.inner_blocks.{i}", out, f"fpn.inner_{i}")
        _conv(sd, f"backbone.fpn.layer_blocks.{i}", out, f"fpn.layer_{i}")
    _conv(sd, "backbone.fpn.extra_blocks.p6", out, "fpn.p6")
    _conv(sd, "backbone.fpn.extra_blocks.p7", out, "fpn.p7")

    g = "backbone.gaussian_layer"
    _conv(sd, f"{g}.lateral", out, "gaussian.lateral")
    for bi in (1, 2):
        _conv(sd, f"{g}.block{bi}.conv", out, f"gaussian.block{bi}_conv")
        _norm(sd, f"{g}.block{bi}.norm", out, f"gaussian.block{bi}_bn",
              "batch")
    for i in range(5):
        _conv(sd, f"backbone.gaussian_subnet.blocks.{i}.conv", out,
              f"gaussian.subnet_{i}")

    for head, tower, final in (("classification_head", "cls_tower",
                                "cls_logits"),
                               ("regression_head", "reg_tower", "bbox_reg")):
        for i in range(4):
            _conv(sd, f"head.{head}.conv.{2 * i}", out,
                  f"head.{tower}.conv_{i}")
        _conv(sd, f"head.{head}.{final}", out, f"head.{final}")
    return out
