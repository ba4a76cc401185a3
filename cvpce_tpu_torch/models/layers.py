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
    """nn.Conv2d that, in a reduced dtype (bf16), rounds the convolution
    to that dtype before it adds the bias, as a flax nn.Conv with that
    compute dtype does; in f32 it is nn.Conv2d. Under
    parallel/spatial.py:width_sharded its width padding is the
    neighbouring strips' columns.

    Parameters stored in f32 under a bf16 input are master weights
    (training, models/gln.py's `param_dtype`): they are cast to bf16 at
    each call, as flax casts its f32 parameters to its compute dtype, and
    their gradient comes back through the cast. Parameters stored in the
    compute dtype serve. On either path `f32_out` marks a conv whose
    output the JAX module widens to f32 at once (into a BatchNorm's f32
    statistics, or an f32 head output): XLA then adds the bf16 bias to
    the bf16 convolution in f32 without rounding the sum, and so does
    this, returning f32.

    On the CPU a bf16 conv runs as the f32 convolution of the bf16
    operands, rounded to bf16: the product XLA's CPU computes. oneDNN's
    own bf16 convolution sums in an order that depends on the shape (a
    width-sharded strip and the whole canvas round a few outputs one
    step apart), and its weight gradient reads uninitialised memory at
    taps that see padding alone (a 1x1 map under a strided 3x3, FPN's P7
    on a small canvas). The card runs cuDNN's bf16 convolution."""

    f32_out = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad_w = pad_strip(x, self.kernel_size[1], self.stride[1],
                             self.padding[1])
        padding = (self.padding[0], pad_w)
        if x.dtype not in (torch.bfloat16, torch.float16):
            return F.conv2d(x, self.weight, self.bias, self.stride, padding,
                            self.dilation, self.groups)
        return self._reduced(x, padding)

    def _reduced(self, x: torch.Tensor, padding) -> torch.Tensor:
        weight = self.weight.to(x.dtype)
        if x.device.type == "cpu":
            y = F.conv2d(x.float(), weight.float(), None, self.stride,
                         padding, self.dilation, self.groups).to(x.dtype)
        else:
            y = F.conv2d(x, weight, None, self.stride, padding,
                         self.dilation, self.groups)
        if self.bias is None:
            return y
        bias = self.bias.to(x.dtype)
        if self.f32_out:
            return y.float() + bias.float()[None, :, None, None]
        return y + bias[None, :, None, None]


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
