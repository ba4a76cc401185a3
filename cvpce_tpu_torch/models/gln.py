"""GLN — Gaussian Layer Network detector (torch); counterpart of
cvpce_tpu/models/gln.py.

RetinaNet (ResNet-50 FrozenBN body, FPN P3-P7, shared conv towers) plus
the Gaussian heatmap branch fed from C2 + P3. `GLN.forward` takes and
returns NHWC tensors like the JAX module; inside it runs NCHW. The
Gaussian branch is the plain upsample -> conv form; the JAX package's
`_FoldedUpConv` is a TPU lane-packing rewrite with the same parameters.

`compute_dtype` ('float32' or 'bfloat16') is the conv stacks' dtype.
A serving GLN stores its float convs' parameters in it; a training GLN
(`param_dtype=torch.float32`, train/gln.py) keeps them f32 and casts
them to bf16 at each conv, as flax's f32 parameters under a bf16
`dtype`, so the optimizer updates f32 master weights.

Serving options, as the JAX config's: `int8` ('off', 'calibrate', 'static')
runs the trunk stages, FPN and head towers as int8 convs
(models/quant.py) while the stem, the cls_logits/bbox_reg predictors and
the Gaussian branch stay in the compute dtype; `fold_backbone_fbn` serves
the backbone with its FrozenBN folded into the convs (state_dict from
`fold_gln_backbone`). Head outputs are f32 whatever the compute dtype.

`postprocess_detections` is the fixed-shape torchvision-style decode in
f32: per-level exact top-k (stable sort, ties to the lowest index, as
`jax.lax.top_k`), box decode and clip, the best `max_nms_candidates`
across levels, then hard NMS (ops/nms.py:nms_mask_fused) or, with
`nms_mode='soft'`, Soft-NMS re-scoring (ops/nms.py:soft_nms_scores_fused)
-- each a CUDA kernel on the card -- optional score-weighted box merging
of the survivors (`merge_boxes`), and `detections_per_img`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import anchors as anchor_ops
from ..ops.boxes import decode_boxes
from ..ops.nms import merge_boxes as merge_boxes_op
from ..ops.nms import nms_mask_fused, soft_nms_scores_fused
from .fpn import FPN
from .layers import cast_float_convs_, conv, upsample_nearest_2x
from .quant import Int8Conv
from .resnet import BatchNorm, ResNet50, fold_frozen_bn


@dataclasses.dataclass(frozen=True)
class GLNConfig:
    canvas_h: int = 832
    canvas_w: int = 1344
    num_classes: int = 1
    tanh: bool = False
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    topk_candidates: int = 1000
    detections_per_img: int = 1000
    max_nms_candidates: int = 5120
    box_weights: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    # conv stacks in 'float32' or 'bfloat16'; params and postprocess f32
    compute_dtype: str = "float32"
    # 'hard' (torchvision parity) or 'soft' (Soft-NMS re-scoring)
    nms_mode: str = "hard"
    soft_nms_sigma: float = 0.5
    # score-weighted box merging of the NMS survivors
    merge_boxes: bool = False
    # 'off', 'calibrate' (record act scales) or 'static' (serve with them)
    int8: str = "off"
    # backbone FrozenBN folded into its convs (fold_gln_backbone weights)
    fold_backbone_fbn: bool = False
    with_gaussians: bool = True

    def anchors(self) -> Tuple[np.ndarray, List[int]]:
        return anchor_ops.grid_anchors(self.canvas_h, self.canvas_w)

    @property
    def dtype(self) -> torch.dtype:
        return {"float32": torch.float32,
                "bfloat16": torch.bfloat16}[self.compute_dtype]

    @property
    def quant(self) -> Optional[str]:
        if self.int8 not in ("off", "calibrate", "static"):
            raise ValueError(f"unknown int8 mode {self.int8!r}")
        return None if self.int8 == "off" else self.int8


class _ConvTower(nn.Module):
    """4x (3x3 conv 256 + ReLU), shared across pyramid levels; int8
    convs when `quant` is set."""

    def __init__(self, quant: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i in range(4):
            setattr(self, f"conv_{i}",
                    Int8Conv(256, 256, 3, dtype=dtype, mode=quant) if quant
                    else conv(256, 256, 3, bias=True))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = F.relu(getattr(self, f"conv_{i}")(x))
        return x


class RetinaNetHead(nn.Module):
    NUM_ANCHORS = 9

    def __init__(self, num_classes: int = 1, quant: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.cls_tower = _ConvTower(quant, dtype)
        self.reg_tower = _ConvTower(quant, dtype)
        self.cls_logits = conv(256, self.NUM_ANCHORS * num_classes, 3,
                               bias=True)
        self.bbox_reg = conv(256, self.NUM_ANCHORS * 4, 3, bias=True)
        # widened to f32 at once (layers.Conv2d)
        self.cls_logits.f32_out = self.bbox_reg.f32_out = True

    def forward(self, features: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        logits_all, regs_all = [], []
        for f in features:
            b = f.shape[0]
            logits = self.cls_logits(self.cls_tower(f)).float()
            regs = self.bbox_reg(self.reg_tower(f)).float()
            # (B, A*K, H, W) -> (B, H*W*A, K): the (y, x, anchor) order
            # of the anchor grid
            logits_all.append(
                logits.permute(0, 2, 3, 1).reshape(b, -1, self.num_classes))
            regs_all.append(regs.permute(0, 2, 3, 1).reshape(b, -1, 4))
        return torch.cat(logits_all, 1), torch.cat(regs_all, 1)


class GaussianBranch(nn.Module):
    """C2 lateral + 2x-upsampled P3 -> conv-BN-ReLU x2 -> upsample ->
    subnet 64->32->32->16->16->1 -> half-resolution heatmap."""

    SUBNET = ((64, 32, 3), (32, 32, 3), (32, 16, 3), (16, 16, 1))

    def __init__(self, tanh: bool = False):
        super().__init__()
        self.tanh = tanh
        self.lateral = conv(256, 256, 1, bias=True)
        self.block1_conv = conv(256, 128, 3, bias=True)
        self.block1_bn = BatchNorm(128)
        self.block2_conv = conv(128, 64, 3, bias=True)
        self.block2_bn = BatchNorm(64)
        for i, (cin, cout, k) in enumerate(self.SUBNET):
            setattr(self, f"subnet_{i}", conv(cin, cout, k, bias=True))
        self.subnet_4 = conv(16, 1, 1, bias=True)
        # widened to f32 at once, by the BatchNorms and the heatmap
        # (layers.Conv2d)
        for c in (self.block1_conv, self.block2_conv, self.subnet_4):
            c.f32_out = True

    def forward(self, c2: torch.Tensor, p3: torch.Tensor) -> torch.Tensor:
        dt = c2.dtype
        x = self.lateral(c2) + upsample_nearest_2x(p3)
        # flax's BatchNorm: f32 inside, the compute dtype out
        x = F.relu(self.block1_bn(self.block1_conv(x)).to(dt))
        x = F.relu(self.block2_bn(self.block2_conv(x)).to(dt))
        x = upsample_nearest_2x(x)
        for i in range(len(self.SUBNET)):
            x = F.relu(getattr(self, f"subnet_{i}")(x))
        x = self.subnet_4(x).float()
        return torch.tanh(x) if self.tanh else F.relu(x)


class GLN(nn.Module):
    """Full detector: NHWC images in; cls_logits (B, A, K),
    bbox_regression (B, A, 4) and, with `with_gaussians`, the heatmap
    (B, H/2, W/2, 1) out, in train mode as in eval mode (JAX's
    GLN(train=True) returns the same dict). `train()` switches only the
    Gaussian branch's two BatchNorms to batch statistics, as
    GLN(train=True) does; the body's FrozenBN stays frozen.

    `param_dtype`, flax's: the dtype the float convs store their
    parameters in, the compute dtype when None (serving). f32 under a
    bf16 config gives the f32 GLN's initial parameters from the same
    generator, bit for bit, computing in bf16."""

    def __init__(self, config: GLNConfig = GLNConfig(),
                 generator: Optional[torch.Generator] = None,
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.config = config
        dt, quant = config.dtype, config.quant
        pdt = param_dtype or dt
        self.body = ResNet50(
            norm="none" if config.fold_backbone_fbn else "frozen",
            quant=quant, conv_bias=config.fold_backbone_fbn, dtype=dt,
            param_dtype=pdt)
        self.fpn = FPN(quant=quant, dtype=dt, param_dtype=pdt)
        self.gaussian = GaussianBranch(tanh=config.tanh)
        self.head = RetinaNetHead(config.num_classes, quant, dt)
        init_gln_(self, generator)
        cast_float_convs_(self, pdt)
        self.eval()

    def train(self, mode: bool = True) -> "GLN":
        super().train(False)
        self.training = mode
        self.gaussian.block1_bn.train(mode)
        self.gaussian.block2_bn.train(mode)
        return self

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = images.permute(0, 3, 1, 2).to(self.config.dtype)
        feats = self.body(x)
        pyramid = self.fpn(feats["c3"], feats["c4"], feats["c5"])
        out = {}
        if self.config.with_gaussians:
            out["gaussians"] = self.gaussian(
                feats["c2"], pyramid[0]).permute(0, 2, 3, 1)
        out["cls_logits"], out["bbox_regression"] = self.head(pyramid)
        return out


def init_gln_(model: GLN, generator: Optional[torch.Generator] = None,
              prior_probability: float = 0.01) -> None:
    """Seeded random init in the JAX module's scheme: lecun-normal trunk
    and FPN convs, N(0, 0.01) head convs with the focal-loss prior bias,
    He-normal Gaussian branch."""
    def lecun(m: nn.Module, gain: float = 1.0):
        fan_in = m.weight[0].numel()
        nn.init.normal_(m.weight, 0.0, math.sqrt(gain / fan_in),
                        generator=generator)
        if m.bias is not None:
            nn.init.zeros_(m.bias)

    convs = (nn.Conv2d, Int8Conv)
    with torch.no_grad():
        for mod in list(model.body.modules()) + list(model.fpn.modules()):
            if isinstance(mod, convs):
                lecun(mod)
        for mod in model.gaussian.modules():
            if isinstance(mod, convs):
                lecun(mod, 2.0)
        for mod in model.head.modules():
            if isinstance(mod, convs):
                nn.init.normal_(mod.weight, 0.0, 0.01, generator=generator)
                nn.init.zeros_(mod.bias)
        model.head.cls_logits.bias.fill_(
            -math.log((1 - prior_probability) / prior_probability))


def fold_gln_backbone(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """GLN state_dict -> the state_dict of its `fold_backbone_fbn=True`
    twin: the body's FrozenBN affines fold into its convs
    (resnet.fold_frozen_bn); every other entry passes through. Int8 act
    scales are not in the state_dict and need no change: the per-channel
    weight scales absorb the fold exactly
    (cvpce_tpu/models/gln.py:fold_gln_backbone)."""
    body = {k[len("body."):]: v for k, v in state.items()
            if k.startswith("body.")}
    out = {k: v for k, v in state.items() if not k.startswith("body.")}
    out.update({f"body.{k}": v for k, v in fold_frozen_bn(body).items()})
    return out


def _topk_desc(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k along the last axis, ties to the lowest index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def postprocess_detections(outputs: Dict[str, torch.Tensor],
                           anchors: torch.Tensor,
                           level_counts: Sequence[int],
                           image_sizes: torch.Tensor, config: GLNConfig,
                           return_candidates: bool = False
                           ) -> Dict[str, torch.Tensor]:
    """Batched fixed-shape decode. image_sizes (B, 2) content (h, w).
    Returns 'boxes' (B, D, 4), 'scores' (B, D), 'valid' (B, D),
    'num_candidates' (B,) (valid boxes entering NMS) and the 'gaussians'
    passthrough when present; D = detections_per_img. With
    `return_candidates`, also the NMS inputs 'cand_boxes', 'cand_scores',
    'cand_valid', its output 'keep' and, with `nms_mode='soft'`, the
    re-scored 'soft_scores'."""
    cfg = config
    nc = cfg.num_classes
    logits = outputs["cls_logits"]
    regs = outputs["bbox_regression"]
    b = logits.shape[0]
    h = image_sizes[:, 0:1].to(logits.dtype)
    w = image_sizes[:, 1:2].to(logits.dtype)
    zero = torch.zeros((), dtype=logits.dtype, device=logits.device)
    level_boxes, level_scores = [], []
    start = 0
    for count in level_counts:
        scores = torch.sigmoid(logits[:, start:start + count]).reshape(b, -1)
        k = min(cfg.topk_candidates, count * nc)
        top_scores, top_idx = _topk_desc(scores, k)
        anchor_idx = top_idx // nc + start
        l_regs = torch.gather(regs, 1, anchor_idx[..., None].expand(-1, -1, 4))
        boxes = decode_boxes(l_regs, anchors[anchor_idx], cfg.box_weights)
        x1 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
        y1 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
        x2 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
        y2 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
        level_boxes.append(torch.stack([x1, y1, x2, y2], -1))
        level_scores.append(top_scores)
        start += count
    boxes = torch.cat(level_boxes, 1)
    scores = torch.cat(level_scores, 1)
    valid = scores > cfg.score_thresh

    c = min(cfg.max_nms_candidates, boxes.shape[1])
    cand_scores, cand_idx = _topk_desc(
        torch.where(valid, scores, torch.full_like(scores, float("-inf"))), c)
    cand_boxes = torch.gather(boxes, 1, cand_idx[..., None].expand(-1, -1, 4))
    cand_valid = torch.isfinite(cand_scores)
    cand_scores = torch.where(cand_valid, cand_scores, zero)

    nms_boxes, nms_scores = cand_boxes, cand_scores
    if cfg.nms_mode == "soft":
        # survivors are the candidates whose decayed score clears
        # score_thresh; the decayed scores rank them
        soft_scores = soft_nms_scores_fused(cand_boxes, cand_scores,
                                            cand_valid, cfg.soft_nms_sigma,
                                            cfg.nms_thresh)
        keep = cand_valid & (soft_scores > cfg.score_thresh)
        nms_scores = soft_scores
    elif cfg.nms_mode == "hard":
        keep = nms_mask_fused(cand_boxes, cand_scores, cand_valid,
                              cfg.nms_thresh)
    else:
        raise ValueError(f"unknown nms_mode {cfg.nms_mode!r}")
    if cfg.merge_boxes:
        nms_boxes = merge_boxes_op(cand_boxes, nms_scores, cand_valid, keep,
                                   cfg.nms_thresh)
    kept = torch.where(keep, nms_scores,
                       torch.full_like(nms_scores, float("-inf")))
    d = min(cfg.detections_per_img, c)
    out_scores, out_idx = _topk_desc(kept, d)
    out_valid = torch.isfinite(out_scores)
    res = {
        "boxes": torch.gather(nms_boxes, 1,
                              out_idx[..., None].expand(-1, -1, 4)),
        "scores": torch.where(out_valid, out_scores, zero),
        "valid": out_valid,
        "num_candidates": cand_valid.sum(1),
    }
    if return_candidates:
        res.update(cand_boxes=cand_boxes, cand_scores=cand_scores,
                   cand_valid=cand_valid, keep=keep)
        if cfg.nms_mode == "soft":
            res["soft_scores"] = soft_scores
    if "gaussians" in outputs:
        res["gaussians"] = outputs["gaussians"]
    return res
