"""DIHE's GAN domain adapter: the U-Net generator and the averaging
PatchGAN; counterpart of cvpce_tpu/models/gan.py.

pix2pix topology, as the JAX package re-authored it: a `num_downs`-level
U-Net of (4, 4) stride-2 convolutions (LeakyReLU(0.2) going down, ReLU
going up, no norm on the outermost and the innermost down layer, tanh
at the output) and a 3-layer 70x70 PatchGAN whose sigmoid is averaged to
one probability an image. Images are NHWC at the boundary, as elsewhere
in the port. The BatchNorms are flax's (models/resnet.py:BatchNorm).

The up convolutions are `ConvTranspose2d(k=4, s=2, p=1)`. flax's
`ConvTranspose(padding="SAME")` gives the same shapes but applies its
kernel unflipped, so a flax kernel reaches them flipped in both spatial
axes (utils/weights.py:gan_state_dict). Module names follow the flax
parameter tree (`down_1`, `down_bn_1`, `up_7`, `d.conv_3`, ...).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BatchNorm


def _down_conv(cin: int, cout: int, bias: bool = True) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 4, stride=2, padding=1, bias=bias)


def _up_conv(cin: int, cout: int, bias: bool = True) -> nn.ConvTranspose2d:
    return nn.ConvTranspose2d(cin, cout, 4, stride=2, padding=1, bias=bias)


def _init_(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Seeded lecun-normal kernels (fan-in = in x kh x kw, as flax counts
    it for both kinds of convolution), zero biases; the BatchNorms keep
    their identity init."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                w = m.weight
                fan_in = (w[0] if isinstance(m, nn.Conv2d)
                          else w[:, 0]).numel()
                nn.init.normal_(w, 0.0, fan_in ** -0.5, generator=generator)
                if m.bias is not None:
                    nn.init.zeros_(m.bias)


class UNetGenerator(nn.Module):
    """(B, H, W, in_channels) -> (B, H, W, out_channels) in [-1, 1];
    H and W multiples of 2 ** num_downs (256 for num_downs = 8)."""

    def __init__(self, out_channels: int = 3, ngf: int = 64,
                 num_downs: int = 8, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.widths = [ngf, ngf * 2, ngf * 4] + [ngf * 8] * (num_downs - 3)
        n = len(self.widths)
        cin = in_channels
        for i, w in enumerate(self.widths):
            setattr(self, f"down_{i}", _down_conv(cin, w, bias=i == 0))
            if 0 < i < n - 1:
                setattr(self, f"down_bn_{i}", BatchNorm(w))
            cin = w
        for i in reversed(range(n)):
            if i == 0:
                setattr(self, "up_0", _up_conv(2 * self.widths[0],
                                               out_channels))
                continue
            cin = self.widths[i] * (1 if i == n - 1 else 2)
            setattr(self, f"up_{i}", _up_conv(cin, self.widths[i - 1],
                                              bias=False))
            setattr(self, f"up_bn_{i}", BatchNorm(self.widths[i - 1]))
        _init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.widths)
        skips = []
        y = x.permute(0, 3, 1, 2)
        for i in range(n):
            if i == 0:
                y = self.down_0(y)
            else:
                y = getattr(self, f"down_{i}")(F.leaky_relu(y, 0.2))
                if i < n - 1:
                    y = getattr(self, f"down_bn_{i}")(y)
            skips.append(y)
        for i in reversed(range(n)):
            if i < n - 1:
                y = torch.cat([skips[i], y], dim=1)
            else:
                y = skips[i]
            y = getattr(self, f"up_{i}")(F.relu(y))
            if i > 0:
                y = getattr(self, f"up_bn_{i}")(y)
        return torch.tanh(y).permute(0, 2, 3, 1)


class PatchGAN(nn.Module):
    """70x70 PatchGAN ('basic', n_layers=3): (B, H, W, 3) -> raw patch
    logits (B, h, w, 1)."""

    def __init__(self, ndf: int = 64, in_channels: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv_0 = _down_conv(in_channels, ndf)
        self.conv_1 = _down_conv(ndf, ndf * 2, bias=False)
        self.bn_1 = BatchNorm(ndf * 2)
        self.conv_2 = _down_conv(ndf * 2, ndf * 4, bias=False)
        self.bn_2 = BatchNorm(ndf * 4)
        self.conv_3 = nn.Conv2d(ndf * 4, ndf * 8, 4, stride=1, padding=1,
                                bias=False)
        self.bn_3 = BatchNorm(ndf * 8)
        self.conv_4 = nn.Conv2d(ndf * 8, 1, 4, stride=1, padding=1)
        _init_(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.leaky_relu(self.conv_0(x.permute(0, 3, 1, 2)), 0.2)
        y = F.leaky_relu(self.bn_1(self.conv_1(y)), 0.2)
        y = F.leaky_relu(self.bn_2(self.conv_2(y)), 0.2)
        y = F.leaky_relu(self.bn_3(self.conv_3(y)), 0.2)
        return self.conv_4(y).permute(0, 2, 3, 1)


class AveragingPatchGAN(nn.Module):
    """sigmoid(patch logits) averaged to one probability an image, (B,)
    (cvpce/models/classification.py:10-18)."""

    def __init__(self, ndf: int = 64,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.d = PatchGAN(ndf, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.d(x)).mean(dim=(1, 2, 3))
