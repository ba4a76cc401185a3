"""Vectorized box operations (torch); counterpart of cvpce_tpu/ops/boxes.py.

Boxes are (..., 4) tensors in (x1, y1, x2, y2) corner format.
"""
from __future__ import annotations

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between (..., N, 4) and (..., M, 4) xyxy boxes ->
    (..., N, M); zero where the union is not positive."""
    area_a = box_area(boxes_a)
    area_b = box_area(boxes_b)
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    pos = union > 0
    safe = torch.where(pos, union, torch.ones_like(union))
    return torch.where(pos, inter / safe, torch.zeros_like(inter))


def xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([cx, cy, w, h], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 clip_value: float = 4.135166556742356) -> torch.Tensor:
    """Decode (dx, dy, dw, dh) regression deltas against anchors -> xyxy.
    `clip_value` = log(1000/16), torchvision's bbox_xform_clip."""
    wx, wy, ww, wh = weights
    anc = xyxy_to_cxcywh(anchors)
    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=clip_value)
    dh = torch.clamp(deltas[..., 3] / wh, max=clip_value)
    cx = dx * anc[..., 2] + anc[..., 0]
    cy = dy * anc[..., 3] + anc[..., 1]
    w = torch.exp(dw) * anc[..., 2]
    h = torch.exp(dh) * anc[..., 3]
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)
