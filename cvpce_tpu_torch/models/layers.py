"""Shared building blocks (torch, NCHW inside modules); counterpart of
cvpce_tpu/models/layers.py."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.spatial import pad_strip


class FrozenBatchNorm(nn.Module):
    """BatchNorm with frozen statistics and affine (torchvision's
    FrozenBatchNorm2d). Buffers only; the statistics fold in f32 the way
    cvpce_tpu/models/layers.py:FrozenBatchNorm folds them."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # fold in f32, apply in the activation's dtype
        inv = self.weight / torch.sqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return (x * inv.to(x.dtype)[None, :, None, None]
                + shift.to(x.dtype)[None, :, None, None])


class Conv2d(nn.Conv2d):
    """nn.Conv2d that, stored in a reduced dtype (bf16), rounds the
    convolution to that dtype before it adds the bias, as a flax nn.Conv
    with that compute dtype does; in f32 it is nn.Conv2d. Under
    parallel/spatial.py:width_sharded its width padding is the
    neighbouring strips' columns."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad_w = pad_strip(x, self.kernel_size[1], self.stride[1],
                             self.padding[1])
        padding = (self.padding[0], pad_w)
        if self.bias is None or self.weight.dtype == torch.float32:
            return F.conv2d(x, self.weight, self.bias, self.stride, padding,
                            self.dilation, self.groups)
        return (F.conv2d(x, self.weight, None, self.stride, padding,
                         self.dilation, self.groups)
                + self.bias[None, :, None, None])


def conv(cin: int, cout: int, kernel: int, stride: int = 1,
         bias: bool = False) -> nn.Conv2d:
    """Conv with torch-style symmetric padding kernel // 2."""
    return Conv2d(cin, cout, kernel, stride=stride, padding=kernel // 2,
                  bias=bias)


def max_pool(x: torch.Tensor, window: int, stride: int,
             padding: int = 0) -> torch.Tensor:
    """Max pool with symmetric -inf padding; under width_sharded its
    width padding is the neighbouring strips' columns."""
    x, pad_w = pad_strip(x, window, stride, padding, float("-inf"))
    return F.max_pool2d(x, window, stride, (padding, pad_w))


def upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample of an NCHW tensor. Local under
    width_sharded: a level's strip r upsamples to strip r of the level
    above, since every level's width splits evenly."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def cast_float_convs_(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Run every nn.Conv2d of `module` in `dtype` (its weight and bias
    are stored in it, as a JAX conv casts its f32 parameters at apply
    time). Int8 convs, norms and their statistics stay f32."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            m.to(dtype)
    return module
