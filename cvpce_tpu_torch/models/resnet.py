"""ResNet-50 trunk; counterpart of cvpce_tpu/models/resnet.py:ResNet50.
`norm='frozen'` is the GLN body (FrozenBatchNorm), `norm='batch'` the
MACResNet trunk (`BatchNorm`: flax's, in eval and train mode),
`norm='none'` the folded serving twin. Module names follow the JAX
parameter tree (`layer2_0.downsample_conv`, `layer2_0.bn1`, ...).

`quant` runs every stage conv as an int8 conv (models/quant.py modes
'static' / 'calibrate' / 'dynamic'); the 7x7 stem stays in `dtype`.
`norm='none', conv_bias=True` is the serving twin of a FrozenBN trunk
whose affines `fold_frozen_bn` has folded into the conv weights and
biases."""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import active_mesh, all_reduce_sum
from .layers import FrozenBatchNorm, cast_float_convs_, conv, max_pool
from .quant import qconv

RESNET50_STAGES = (3, 4, 6, 3)
STAGE_FEATURES = (64, 128, 256, 512)


class BatchNorm(nn.BatchNorm2d):
    """flax's BatchNorm (momentum 0.9, eps 1e-5) on nn.BatchNorm2d's
    parameters and buffers, normalising in f32 (f64 for f64 inputs) in
    flax's order, (x - mean) * (rsqrt(var + eps) * scale) + bias, and
    returning its input's dtype. Eval mode uses the running statistics.
    Train mode uses the batch's, in that precision: mean(x) and the biased
    mean(x^2) - mean(x)^2 (clipped at 0), and moves the running ones by
    0.9 * running + 0.1 * batch, the biased variance included (torch's
    own update takes the unbiased one).

    `update_stats = False` keeps the train mode's batch statistics but
    leaves the running ones untouched: flax's train-mode apply whose
    mutated `batch_stats` the caller throws away (`frozen_statistics`).

    Inside a data-parallel step over several ranks
    (parallel/mesh.py:active_mesh) the batch is the global one, as under
    the JAX package's sharded batch: `batch_moments` takes the count,
    sum and sum of squares over every rank."""

    def __init__(self, features: int):
        super().__init__(features, eps=1e-5, momentum=0.1)
        self.update_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = (None, slice(None), None, None)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.training:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = batch_moments(xf, active_mesh())
            if self.update_stats:
                with torch.no_grad():
                    keep = 1.0 - self.momentum
                    self.running_mean.copy_(keep * self.running_mean
                                            + self.momentum * mean)
                    self.running_var.copy_(keep * self.running_var
                                           + self.momentum * var)
                    self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[c]) * mul[c] + self.bias[c]
        return y.to(x.dtype)


def batch_moments(x: torch.Tensor, mesh=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel mean and biased variance, mean(x^2) - mean(x)^2
    clipped at 0, of an NCHW batch. With a `mesh`, over the batch of
    every rank: the count, sum and sum of squares are all-reduced in
    x's dtype, and in backward the gradients of the sums, so the input
    gradient is the global batch's."""
    dims = (0, 2, 3)
    if mesh is None:
        mean = x.mean(dim=dims)
        return mean, torch.clamp((x * x).mean(dim=dims) - mean * mean,
                                 min=0.0)
    c = x.shape[1]
    sums = all_reduce_sum(torch.cat([
        x.sum(dim=dims), (x * x).sum(dim=dims),
        x.new_full((1,), x.numel() // c)]), mesh)
    count = sums[2 * c]
    mean = sums[:c] / count
    return mean, torch.clamp(sums[c:2 * c] / count - mean * mean, min=0.0)


@contextlib.contextmanager
def frozen_statistics(*modules: nn.Module):
    """Within the block, every `BatchNorm` of `modules` normalises by
    its batch's statistics in train mode without moving its running
    ones."""
    norms = [m for module in modules for m in module.modules()
             if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def _norm(kind: str, features: int) -> nn.Module:
    if kind == "frozen":
        return FrozenBatchNorm(features)
    if kind == "batch":
        return BatchNorm(features)
    if kind == "none":
        return nn.Identity()
    raise ValueError(f"unknown norm {kind!r}")


class Bottleneck(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1,
                 downsample: bool = False, norm: str = "frozen",
                 quant: Optional[str] = None, conv_bias: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()

        def _c(ci, co, kernel, s=1):
            if quant:
                return qconv(ci, co, kernel, s, bias=conv_bias, dtype=dtype,
                             quant=quant)
            return conv(ci, co, kernel, s, bias=conv_bias)

        out = features * 4
        self.conv1 = _c(cin, features, 1)
        self.bn1 = _norm(norm, features)
        self.conv2 = _c(features, features, 3, stride)
        self.bn2 = _norm(norm, features)
        self.conv3 = _c(features, out, 1)
        self.bn3 = _norm(norm, out)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = _c(cin, out, 1, stride)
            self.downsample_bn = _norm(norm, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        res = (self.downsample_bn(self.downsample_conv(x))
               if self.downsample else x)
        return F.relu(y + res)


class ResNet50(nn.Module):
    """NCHW in, {'c1'..'c5'} NCHW feature maps out, in `dtype`. The
    float convs store their parameters in `param_dtype` (default
    `dtype`); f32 under a bf16 `dtype` keeps master weights for
    training (layers.py:Conv2d casts them at each call)."""

    def __init__(self, norm: str = "frozen", quant: Optional[str] = None,
                 conv_bias: bool = False,
                 dtype: torch.dtype = torch.float32,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = conv(3, 64, 7, 2, bias=conv_bias)
        self.bn1 = _norm(norm, 64)
        self.stages = []  # block names per stage
        cin = 64
        for si, (blocks, width) in enumerate(
                zip(RESNET50_STAGES, STAGE_FEATURES)):
            stride = 1 if si == 0 else 2
            names = []
            for bi in range(blocks):
                name = f"layer{si + 1}_{bi}"
                setattr(self, name, Bottleneck(
                    cin, width, stride if bi == 0 else 1, bi == 0, norm,
                    quant, conv_bias, dtype))
                names.append(name)
                cin = width * 4
            self.stages.append(names)
        cast_float_convs_(self, param_dtype or dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.dtype)
        y = F.relu(self.bn1(self.conv1(x)))
        feats = {"c1": y}
        y = max_pool(y, 3, 2, padding=1)
        for si, names in enumerate(self.stages):
            for name in names:
                y = getattr(self, name)(y)
            feats[f"c{si + 2}"] = y
        return feats


# FrozenBN -> the conv it follows, inside a Bottleneck and at the stem
_FOLD_PAIRS = {"bn1": "conv1", "bn2": "conv2", "bn3": "conv3",
               "downsample_bn": "downsample_conv"}


def fold_frozen_bn(state: Dict[str, torch.Tensor], eps: float = 1e-5
                   ) -> Dict[str, torch.Tensor]:
    """ResNet50(norm='frozen') state_dict -> the state_dict of its
    `norm='none', conv_bias=True` twin: each FrozenBN affine
    y = x * inv + shift (inv = weight / sqrt(var + eps),
    shift = bias - mean * inv) folds into the bias-free conv before it,
    weight[o] *= inv[o], bias[o] = shift[o]
    (cvpce_tpu/models/resnet.py:fold_frozen_bn). Exact for the int8 path
    too: its per-output-channel weight scales absorb `inv`."""
    out = dict(state)
    for key in state:
        if not key.endswith(".running_var"):
            continue
        bn = key[:-len("running_var")]  # 'layer1_0.bn2.', stem 'bn1.'
        parent, _, leaf = bn.rstrip(".").rpartition(".")
        conv_name = (parent + "." if parent else "") + _FOLD_PAIRS[leaf]
        # a correctly rounded f32 sqrt (torch's CPU kernel may be 1 ulp
        # off), so the fold equals the JAX package's bit for bit
        var = state[bn + "running_var"] + eps
        inv = state[bn + "weight"] / torch.sqrt(var.double()).to(var.dtype)
        shift = state[bn + "bias"] - state[bn + "running_mean"] * inv
        out[conv_name + ".weight"] = (state[conv_name + ".weight"]
                                      * inv[:, None, None, None])
        out[conv_name + ".bias"] = shift
        for leaf_name in ("weight", "bias", "running_mean", "running_var"):
            del out[bn + leaf_name]
    return out
