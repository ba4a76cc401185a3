"""Anchor <-> ground-truth matching (torchvision Matcher semantics);
counterpart of cvpce_tpu/ops/matching.py.

For each anchor the best-IoU gt wins if IoU >= 0.5 (foreground), IoU <
0.4 is background, in between is ignored; every valid gt's best
anchor(s) are also foreground ("low-quality matches", the anchors whose
IoU equals the gt's maximum exactly and is above 0). Padded gts score
-1. The A x T IoU matrix is computed in anchor chunks, twice: once for
the per-anchor best and the per-gt maximum, once for the exact ties
with that maximum. Both passes run the same `_chunk_ious`, so the
equality holds bit for bit. No anchor padding is needed: the JAX
package's far-away pad anchors never change a result.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .boxes import pairwise_iou


def _chunk_ious(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                gt_valid: torch.Tensor) -> torch.Tensor:
    """(B, C, T) IoUs of a (C, 4) anchor chunk with (B, T, 4) gts, -1 at
    padded gts."""
    ious = pairwise_iou(anchors.expand(gt_boxes.shape[0], -1, -1), gt_boxes)
    return torch.where(gt_valid[:, None, :], ious,
                       torch.full_like(ious, -1.0))


def match_anchors(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_valid: torch.Tensor, high_threshold: float = 0.5,
                  low_threshold: float = 0.4,
                  allow_low_quality: bool = True, chunk: int = 8192
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Match (A, 4) xyxy anchors to padded gts, (T, 4) with (T,) valid,
    or batched, (B, T, 4) with (B, T).

    Returns matched_idx (A,) int64 (argmax IoU, the first gt on ties;
    meaningful where fg), fg (A,) bool and valid (A,) bool (the anchor
    is not ignored), each with the leading B when the gts have one."""
    single = gt_boxes.dim() == 2
    if single:
        gt_boxes, gt_valid = gt_boxes[None], gt_valid[None]
    gt_valid = gt_valid.bool()
    best_gt, best_iou = [], []
    per_gt_max = None
    for start in range(0, anchors.shape[0], chunk):
        ious = _chunk_ious(anchors[start:start + chunk], gt_boxes, gt_valid)
        # argmax takes the first index on ties, as jnp.argmax does
        best_gt.append(ious.argmax(dim=2))
        best_iou.append(ious.amax(dim=2))
        chunk_max = ious.amax(dim=1)
        per_gt_max = (chunk_max if per_gt_max is None
                      else torch.maximum(per_gt_max, chunk_max))
    best_gt = torch.cat(best_gt, 1)
    best_iou = torch.cat(best_iou, 1)

    if allow_low_quality:
        low_quality = []
        for start in range(0, anchors.shape[0], chunk):
            ious = _chunk_ious(anchors[start:start + chunk], gt_boxes,
                               gt_valid)
            is_best = ((ious == per_gt_max[:, None, :])
                       & gt_valid[:, None, :] & (ious > 0))
            low_quality.append(is_best.any(dim=2))
        low_quality = torch.cat(low_quality, 1)
    else:
        low_quality = torch.zeros_like(best_iou, dtype=torch.bool)

    fg = (best_iou >= high_threshold) | low_quality
    between = ((best_iou >= low_threshold) & (best_iou < high_threshold)
               & ~low_quality)
    out = (best_gt, fg, ~between)
    return tuple(t[0] for t in out) if single else out
