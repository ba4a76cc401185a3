"""MACVGG embedder (torch); counterpart of cvpce_tpu/models/embedders.py.

VGG16(+BN) `features` in torchvision's layer numbering, cut after the
last ReLU of block 5. The descriptor is the concat of the spatial max
(MAC) after the last ReLU of block 4 and of block 5 -> 1024-d,
L2-normalized with an eps-clamped norm. Input: NHWC images in tanh scale
([-1, 1]); ImageNet normalization (rescaled to that range) happens in
the forward, as in the JAX module. f32 only.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.image import normalize_tanh_imagenet
from ..utils import resolve_device

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


def _vgg_plan(batch_norm: bool):
    """(kind, torchvision index, channels) per VGG16 features entry."""
    plan = []
    idx = 0
    for entry in VGG16_CFG:
        if entry == "M":
            plan.append(("pool", idx, 0))
            idx += 1
        else:
            plan.append(("conv", idx, entry))
            idx += 1
            if batch_norm:
                plan.append(("bn", idx, entry))
                idx += 1
            plan.append(("relu", idx, entry))
            idx += 1
    return plan


class MACVGG(nn.Module):
    embedding_size = 1024
    EPS = 1e-8  # descriptor norm clamp

    def __init__(self, batch_norm: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.batch_norm = batch_norm
        layers = []
        cin = 3
        for kind, _, ch in _vgg_plan(batch_norm):
            if kind == "conv":
                layers.append(nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch
            elif kind == "bn":
                layers.append(nn.BatchNorm2d(ch, eps=1e-5))
            elif kind == "relu":
                layers.append(nn.ReLU())
            else:
                layers.append(nn.MaxPool2d(2, 2))
        self.features = nn.Sequential(*layers)
        with torch.no_grad():
            for m in self.features:
                if isinstance(m, nn.Conv2d):
                    fan_in = m.weight[0].numel()
                    nn.init.normal_(m.weight, 0.0, fan_in ** -0.5,
                                    generator=generator)
                    nn.init.zeros_(m.bias)
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = normalize_tanh_imagenet(x).permute(0, 3, 1, 2)
        pools = 0
        descs = []
        for layer in self.features:
            if isinstance(layer, nn.MaxPool2d):
                pools += 1
                if pools >= 4:
                    descs.append(torch.amax(x, dim=(2, 3)))
                if pools == 5:
                    break
            x = layer(x)
        desc = torch.cat(descs, 1).float()
        norm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
        return desc / norm.clamp(min=self.EPS)


def fold_bn_state_dict(state: Dict[str, torch.Tensor]
                       ) -> Dict[str, torch.Tensor]:
    """MACVGG(batch_norm=True) state_dict -> MACVGG(batch_norm=False)
    state_dict with each eval-mode BatchNorm folded into its conv:
    w' = w * s, b' = (b - mean) * s + beta, s = gamma / sqrt(var + 1e-5)
    (cvpce_tpu/models/embedders.py:fold_bn_variables)."""
    plan_bn = _vgg_plan(True)
    convs_bn = [i for kind, i, _ in plan_bn if kind == "conv"]
    bns = [i for kind, i, _ in plan_bn if kind == "bn"]
    convs_plain = [i for kind, i, _ in _vgg_plan(False) if kind == "conv"]
    out = {}
    for c_bn, b_bn, c_pl in zip(convs_bn, bns, convs_plain):
        w = state[f"features.{c_bn}.weight"]
        bias = state[f"features.{c_bn}.bias"]
        s = state[f"features.{b_bn}.weight"] / torch.sqrt(
            state[f"features.{b_bn}.running_var"] + 1e-5)
        out[f"features.{c_pl}.weight"] = w * s[:, None, None, None]
        out[f"features.{c_pl}.bias"] = (
            (bias - state[f"features.{b_bn}.running_mean"]) * s
            + state[f"features.{b_bn}.bias"])
    return out


def fold_bn_variables(model: MACVGG) -> MACVGG:
    """A BN-free MACVGG computing what `model` (batch_norm=True, eval)
    computes, on the same device."""
    folded = MACVGG(batch_norm=False)
    folded.load_state_dict(fold_bn_state_dict(model.state_dict()))
    return folded.to(next(model.parameters()).device)


class EmbedFn:
    """Serving wrapper: `(B, 256, 256, 3)` tanh-scale images (numpy or
    tensor) -> `(B, D)` f32 embeddings on the model's device."""

    def __init__(self, model: nn.Module, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @property
    def embedding_size(self) -> int:
        return self.model.embedding_size

    def __call__(self, imgs) -> torch.Tensor:
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        x = imgs.to(self.device, torch.float32)
        with torch.inference_mode():
            return self.model(x)
