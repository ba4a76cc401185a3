"""ResNet-50 trunk with FrozenBatchNorm (the GLN body); counterpart of
cvpce_tpu/models/resnet.py:ResNet50 with norm='frozen'. Module names
follow the JAX parameter tree (`layer2_0.downsample_conv`, ...)."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FrozenBatchNorm, conv, max_pool

RESNET50_STAGES = (3, 4, 6, 3)
STAGE_FEATURES = (64, 128, 256, 512)


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = features * 4
        self.conv1 = conv(cin, features, 1)
        self.bn1 = FrozenBatchNorm(features)
        self.conv2 = conv(features, features, 3, stride)
        self.bn2 = FrozenBatchNorm(features)
        self.conv3 = conv(features, out, 1)
        self.bn3 = FrozenBatchNorm(out)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = conv(cin, out, 1, stride)
            self.downsample_bn = FrozenBatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = (self.downsample_bn(self.downsample_conv(x))
               if self.downsample else x)
        return F.relu(y + res)


class ResNet50(nn.Module):
    """NCHW in, {'c1'..'c5'} NCHW feature maps out."""

    def __init__(self):
        super().__init__()
        self.conv1 = conv(3, 64, 7, 2)
        self.bn1 = FrozenBatchNorm(64)
        self.stages = []  # block names per stage
        cin = 64
        for si, (blocks, width) in enumerate(
                zip(RESNET50_STAGES, STAGE_FEATURES)):
            stride = 1 if si == 0 else 2
            names = []
            for bi in range(blocks):
                name = f"layer{si + 1}_{bi}"
                setattr(self, name, Bottleneck(
                    cin, width, stride if bi == 0 else 1, bi == 0))
                names.append(name)
                cin = width * 4
            self.stages.append(names)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        y = F.relu(self.bn1(self.conv1(x)))
        feats = {"c1": y}
        y = max_pool(y, 3, 2, padding=1)
        for si, names in enumerate(self.stages):
            for name in names:
                y = getattr(self, name)(y)
            feats[f"c{si + 2}"] = y
        return feats
