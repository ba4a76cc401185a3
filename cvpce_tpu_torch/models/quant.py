"""Int8 conv path shared by the embedder and the detector (torch);
counterpart of cvpce_tpu/models/quant.py.

Per-output-channel weight quantization, per-tensor activation
quantization, int32 accumulation, f32 dequant epilogue. `Int8Conv` keeps
nn.Conv2d's parameter names and shapes (`weight` OIHW, `bias`), so f32
state_dicts load unchanged; the activation scale lives in a buffer
`act_scale` that is not part of the state_dict. Scales travel as a plain
tree of floats keyed like the JAX `act_scales` collection
(`{"body": {"layer1_0": {"conv1": {"scale": s}}}}`): `act_scale_tree`
reads it, `load_act_scales` writes it, `calibrate_act_scales` records it.
A model whose module paths differ from the JAX names maps them with a
`scale_key(path) -> tuple of tree keys` method (MACVGG: 'features.2' ->
('f2',)).

Modes, as the JAX module's: 'dynamic' takes the batch abs-max every
call; 'static' reads the calibrated scale; 'calibrate' behaves as
dynamic and keeps the running max of the scale.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from ..ops.conv_fused import int8_conv_nhwc, quantize
from ..parallel.spatial import pad_strip, strip_max

MODES = ("dynamic", "static", "calibrate")


class Int8Conv(nn.Module):
    """Quantized drop-in for nn.Conv2d (NCHW in and out, `padding` zero
    pixels on each side). Returns `dtype`."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None, bias: bool = True,
                 dtype: torch.dtype = torch.float32, mode: str = "dynamic"):
        super().__init__()
        if mode not in MODES:
            raise ValueError(f"unknown int8 mode {mode!r}")
        self.kernel = kernel
        self.stride = stride
        self.padding = kernel // 2 if padding is None else padding
        self.dtype = dtype
        self.mode = mode
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.register_buffer("act_scale", torch.zeros(()), persistent=False)
        self._wq = None  # (key, kq HWIO int8, w_scale) of the weight

    def quantized_weight(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(kq (kh, kw, Cin, Cout) int8, w_scale (Cout,) f32), computed
        once per weight version: w_scale = max(max|k|, 1e-8) / 127 per
        output channel, kq = clip(round(k / w_scale), +-127)."""
        w = self.weight
        key = (w.data_ptr(), w._version, w.device)
        if self._wq is None or self._wq[0] != key:
            with torch.no_grad():
                k = w.detach().float().permute(2, 3, 1, 0)  # HWIO
                w_scale = k.abs().amax(dim=(0, 1, 2)).clamp(min=1e-8) \
                    / torch.tensor(127.0, device=k.device)
                kq = torch.clamp(torch.round(k / w_scale), -127,
                                 127).to(torch.int8).contiguous()
            self._wq = (key, kq, w_scale)
        return self._wq[1], self._wq[2]

    def _activation_scale(self, xf: torch.Tensor) -> torch.Tensor:
        if self.mode == "static":
            return self.act_scale.clamp(min=1e-8)
        a_scale = strip_max(xf.abs().amax()).clamp(min=1e-8) \
            / torch.tensor(127.0, device=xf.device)
        if self.mode == "calibrate":
            with torch.no_grad():
                self.act_scale.copy_(torch.maximum(self.act_scale, a_scale))
        return a_scale

    def accumulate(self, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(int32 accumulators (B, Cout, Ho, Wo), activation scale).
        Under parallel/spatial.py:width_sharded the halo columns join in
        float before the elementwise quantize, and a dynamic scale is
        the whole canvas's."""
        xf = x.float()
        a_scale = self._activation_scale(xf)
        kq, _ = self.quantized_weight()
        xf, pad_w = pad_strip(xf, self.kernel, self.stride, self.padding)
        xq = quantize(xf.permute(0, 2, 3, 1), a_scale)
        acc = int8_conv_nhwc(xq, kq, self.stride, (self.padding, pad_w))
        return acc.permute(0, 3, 1, 2), a_scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        acc, a_scale = self.accumulate(x)
        _, w_scale = self.quantized_weight()
        y = acc.float() * (a_scale * w_scale)[None, :, None, None]
        if self.bias is not None:
            y = y + self.bias[None, :, None, None]
        return y.to(self.dtype)


def qconv(cin: int, cout: int, kernel: int, stride: int = 1,
          bias: bool = False, padding: Optional[int] = None,
          dtype: torch.dtype = torch.bfloat16,
          quant: str = "static") -> Int8Conv:
    """Int8 twin of layers.conv (symmetric padding kernel // 2). quant:
    'static', 'calibrate' or 'dynamic'."""
    return Int8Conv(cin, cout, kernel, stride, padding, bias, dtype, quant)


def int8_convs(model: nn.Module) -> Dict[str, Int8Conv]:
    return {name: m for name, m in model.named_modules()
            if isinstance(m, Int8Conv)}


def _scale_key(model: nn.Module, path: str) -> Tuple[str, ...]:
    key = getattr(model, "scale_key", None)
    return key(path) if key else tuple(path.split("."))


def act_scale_tree(model: nn.Module) -> Dict:
    """The Int8Convs' activation scales as a nested dict of floats keyed
    like the JAX `act_scales` collection."""
    tree: Dict = {}
    for name, m in int8_convs(model).items():
        node = tree
        for part in _scale_key(model, name):
            node = node.setdefault(part, {})
        node["scale"] = float(m.act_scale)
    return tree


def load_act_scales(model: nn.Module, tree) -> None:
    """Set every Int8Conv's activation scale from `tree`, a JAX-keyed
    act-scale tree (nested mappings with float or 0-d array leaves). A
    missing scale raises."""
    for name, m in int8_convs(model).items():
        node = tree
        key = _scale_key(model, name)
        for part in key + ("scale",):
            if part not in node:
                raise KeyError(f"no act scale for {name} ({'/'.join(key)})")
            node = node[part]
        with torch.no_grad():
            m.act_scale.fill_(float(node))


def calibrate_act_scales(model: nn.Module, batches: Iterable) -> Dict:
    """Record per-layer int8 activation scales for static serving: runs
    `model` on each batch with every Int8Conv in 'calibrate' mode,
    keeping the running max of each layer's scale from the scales it
    holds already (zeros on a fresh model), then puts the modes back.
    Returns `act_scale_tree(model)`."""
    convs = int8_convs(model)
    modes = {name: m.mode for name, m in convs.items()}
    for m in convs.values():
        m.mode = "calibrate"
    try:
        with torch.no_grad():
            for batch in batches:
                model(batch)
    finally:
        for name, m in convs.items():
            m.mode = modes[name]
    return act_scale_tree(model)
