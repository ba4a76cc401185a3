"""MAC embedders (torch): MACVGG and MACResNet; counterpart of
cvpce_tpu/models/embedders.py.

VGG16(+BN) `features` in torchvision's layer numbering, cut after the
last ReLU of block 5. The descriptor is the concat of the spatial max
(MAC) after the last ReLU of block 4 and of block 5 -> 1024-d,
L2-normalized with an eps-clamped norm. Input: NHWC images in tanh scale
([-1, 1]); ImageNet normalization (rescaled to that range) happens in
the forward, as in the JAX module.

`dtype` is the conv stack's compute dtype (f32 or bf16). The int8
serving path (models/quant.py) runs the INT8_FAVORED_CONVS (`int8`) or
INT8_ALL_CONVS (`int8_all`) as int8 convs: dynamic scales by default,
calibrated static scales with `int8_static`, recording them with
`int8_calibrate`. Their act scales are keyed by the JAX module names
`f{idx}` (`MACVGG.scale_key`), so one scale tree serves both packages.

MACResNet is the same MAC idea over the stage outputs of a ResNet-50
trunk with eval-mode BatchNorm (default c3 + c4 = 1536-d). Its input is
the raw tanh-scale image, with no ImageNet normalisation, as in the JAX
module. `quant` runs the trunk's 52 stage convs as int8 convs (the 7x7
stem stays in `dtype`), keyed in the act-scale tree by module path
(`trunk/layer1_0/conv1`), as JAX keys them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.image import normalize_tanh_imagenet
from ..utils import resolve_device
from .layers import cast_float_convs_, conv
from .quant import (Int8Conv, act_scale_tree, calibrate_act_scales,
                    int8_convs, load_act_scales)
from .resnet import ResNet50

VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")

# conv ordinals (1-based through VGG16's 13 convs) run as int8 convs by
# `int8` and by `int8_all` (cvpce_tpu/models/embedders.py:57-66); conv1_1,
# with its 3 input channels, always stays in the compute dtype
INT8_FAVORED_CONVS = frozenset({2, 4, 5, 6, 7, 9, 10, 11, 12, 13})
INT8_ALL_CONVS = frozenset(range(2, 14))


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
                 generator: Optional[torch.Generator] = None,
                 int8: bool = False, int8_all: bool = False,
                 int8_static: bool = False, int8_calibrate: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.batch_norm = batch_norm
        self.int8_static = int8_static
        self.dtype = dtype
        int8_set = (INT8_ALL_CONVS if int8_all else INT8_FAVORED_CONVS
                    if int8 else frozenset())
        mode = ("calibrate" if int8_calibrate else
                "static" if int8_static else "dynamic")
        layers = []
        cin = 3
        ordinal = 0
        for kind, _, ch in _vgg_plan(batch_norm):
            if kind == "conv":
                ordinal += 1
                layers.append(
                    Int8Conv(cin, ch, 3, dtype=dtype, mode=mode)
                    if ordinal in int8_set else conv(cin, ch, 3, bias=True))
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
                if isinstance(m, (nn.Conv2d, Int8Conv)):
                    fan_in = m.weight[0].numel()
                    nn.init.normal_(m.weight, 0.0, fan_in ** -0.5,
                                    generator=generator)
                    nn.init.zeros_(m.bias)
        cast_float_convs_(self, dtype)
        self.eval()

    @staticmethod
    def scale_key(path: str) -> Tuple[str, ...]:
        """Module path 'features.{idx}' -> the JAX layer name ('f{idx}',)."""
        return ("f" + path.split(".")[1],)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = normalize_tanh_imagenet(x).to(self.dtype).permute(0, 3, 1, 2)
        pools = 0
        descs = []
        for layer in self.features:
            if isinstance(layer, nn.MaxPool2d):
                pools += 1
                if pools >= 4:
                    descs.append(torch.amax(x, dim=(2, 3)))
                if pools == 5:
                    break
            if isinstance(layer, nn.BatchNorm2d):
                # in f32, cast back to the compute dtype (as flax's)
                x = layer(x.float()).to(self.dtype)
            else:
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


def fold_bn_variables(model: MACVGG, **kwargs) -> MACVGG:
    """A BN-free MACVGG computing what `model` (batch_norm=True, eval)
    computes, on the same device; `kwargs` choose its serving options
    (`int8_all`, `int8_static`, `dtype`, ...)."""
    folded = MACVGG(batch_norm=False, **kwargs)
    folded.load_state_dict(fold_bn_state_dict(model.state_dict()))
    return folded.to(next(model.parameters()).device)


# the JAX package's name for the shared calibration helper
calibrate_int8_scales = calibrate_act_scales


class MACResNet(nn.Module):
    """ResNet-50 MAC embedder over stage outputs; counterpart of
    cvpce_tpu/models/embedders.py:MACResNet. `descriptor_stages` are the
    reference's descriptor layers + 1 (layers [2, 3] -> c3, c4). The
    trunk computes every stage, as the JAX one does; the MAC of each
    chosen stage is taken in f32, the stages are concatenated and the
    result is L2-normalised with the `eps` clamp. `quant` in (None,
    'static', 'calibrate', 'dynamic') runs the stage convs as int8
    convs. The convs get a seeded lecun-normal init from `generator`;
    the BatchNorms start as the identity (scale 1, bias 0, mean 0,
    var 1), as flax initialises them."""

    STAGE_SIZES = {"c1": 64, "c2": 256, "c3": 512, "c4": 1024, "c5": 2048}

    def __init__(self, descriptor_stages=("c3", "c4"), eps: float = 1e-8,
                 dtype: torch.dtype = torch.float32,
                 quant: Optional[str] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        unknown = set(descriptor_stages) - set(self.STAGE_SIZES)
        if unknown:
            raise ValueError(f"unknown descriptor stages {sorted(unknown)}")
        self.descriptor_stages = tuple(descriptor_stages)
        self.eps = eps
        self.dtype = dtype
        self.quant = quant
        self.trunk = ResNet50(norm="batch", quant=quant, dtype=dtype)
        with torch.no_grad():
            for m in self.trunk.modules():
                if isinstance(m, (nn.Conv2d, Int8Conv)):
                    # drawn in f32, then stored in the conv's dtype
                    w = torch.empty(m.weight.shape)
                    nn.init.normal_(w, 0.0, m.weight[0].numel() ** -0.5,
                                    generator=generator)
                    m.weight.copy_(w)
        self.eval()

    @property
    def embedding_size(self) -> int:
        return sum(self.STAGE_SIZES[s] for s in self.descriptor_stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) tanh-scale images -> (B, embedding_size) f32."""
        feats = self.trunk(x.permute(0, 3, 1, 2))
        desc = torch.cat([torch.amax(feats[s], dim=(2, 3)).float()
                          for s in self.descriptor_stages], 1)
        norm = torch.linalg.vector_norm(desc, dim=1, keepdim=True)
        return desc / norm.clamp(min=self.eps)


class EmbedFn:
    """Serving wrapper: `(B, 256, 256, 3)` tanh-scale images (numpy or
    tensor) -> `(B, D)` f32 embeddings on the model's device.

    It carries the int8 static-scale lifecycle of
    cvpce_tpu/models/embedders.py:EmbedFn: an `int8_static` model needs
    calibrated activation scales. The Classifier calibrates them on the
    gallery when it builds the index and saves them with it; an encoder
    that starts serving uncalibrated calibrates on its first batch, and
    its scales then stay fixed. MACVGG marks static int8 with
    `int8_static`; MACResNet (as the detectors) with `quant='static'`."""

    def __init__(self, model: nn.Module, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.needs_calibration = bool(
            getattr(model, "int8_static", False)
            or getattr(model, "quant", None) == "static")
        self._calibrated = not self.needs_calibration

    @property
    def embedding_size(self) -> int:
        return self.model.embedding_size

    def _input(self, imgs) -> torch.Tensor:
        if isinstance(imgs, np.ndarray):
            imgs = torch.from_numpy(imgs)
        return imgs.to(self.device, torch.float32)

    def __call__(self, imgs) -> torch.Tensor:
        x = self._input(imgs)
        if not self._calibrated:
            self.calibrate([x])
        with torch.inference_mode():
            return self.model(x)

    def calibrate(self, batches) -> None:
        """Record the int8 activation scales: the running max over
        `batches`, on top of the scales the model holds already."""
        calibrate_act_scales(self.model, (self._input(b) for b in batches))
        self._calibrated = True

    def get_scales(self) -> Optional[Dict]:
        """Per-layer act scales as a plain float tree keyed like the JAX
        `act_scales` collection ({'f2': {'scale': s}, ...}); None while
        the model has no calibrated static int8 convs."""
        if not (self.needs_calibration and self._calibrated
                and int8_convs(self.model)):
            return None
        return act_scale_tree(self.model)

    def set_scales(self, scales) -> None:
        load_act_scales(self.model, scales)
        self._calibrated = True
