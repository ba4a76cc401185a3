"""Independent COCO-protocol detection evaluation (COCOeval semantics);
a numpy copy of cvpce_tpu/eval/coco_protocol.py.

The reference validates its base detector against pycocotools
(cvpce/cli/misc.py:54-101) — an external referee implementing a DIFFERENT
AP protocol than the in-house metric stack (cvpce/metrics.py: 11-point
VOC interpolation, greedy first-fit matching). This module provides that
referee without pycocotools: the COCO bbox protocol re-implemented from
its published definition —

- per-image/category greedy matching in detection-score order, each
  detection taking the highest-IoU unmatched GT with IoU >= threshold;
- GT "ignore" flags by area range (all / small <32^2 / medium / large
  >96^2); detections matched to ignored GTs are ignored, unmatched
  detections with out-of-range area are ignored;
- maxDets truncation (COCO summary uses 1/10/100);
- 101-point interpolated AP over the monotone precision envelope, sampled
  at recall 0.00:0.01:1.00; AR = mean max recall;
- averages over IoU 0.50:0.05:0.95 and over categories.

It deliberately shares NO code with ops/metrics.py, so the two stacks
cross-check each other.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

AREA_RANGES = {
    "all": (0.0, float("inf")),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, float("inf")),
}
IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 1.0, 0.05), 2))
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


@dataclasses.dataclass
class ImageDetections:
    """One image's predictions + ground truth for a single category."""
    det_boxes: np.ndarray      # (D, 4) xyxy
    det_scores: np.ndarray     # (D,)
    gt_boxes: np.ndarray       # (G, 4) xyxy


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0.0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def _box_area(boxes: np.ndarray) -> np.ndarray:
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


@dataclasses.dataclass
class _PreparedImage:
    """Per-image state shared across all (iou_threshold x area) cells:
    the score sort / maxDets truncation, box areas, and the IoU matrix
    (dets sorted by score x gts in original order) are threshold- and
    area-independent, so computing them once per image avoids the 40x
    redundant work pycocotools also hoists."""
    det_scores: np.ndarray
    det_area: np.ndarray
    gt_area: np.ndarray
    iou: np.ndarray  # (D, G)


def _prepare_image(img: ImageDetections, max_dets: int) -> _PreparedImage:
    order = np.argsort(-img.det_scores, kind="stable")[:max_dets]
    det_boxes = img.det_boxes[order]
    gt_area = _box_area(img.gt_boxes) if len(img.gt_boxes) else np.zeros(0)
    return _PreparedImage(img.det_scores[order], _box_area(det_boxes),
                          gt_area, _iou_matrix(det_boxes, img.gt_boxes))


def _match_image(prep: _PreparedImage, iou_thresh: float,
                 area_range: Tuple[float, float]):
    """COCOeval evaluateImg: returns (scores, matched, ignored) for the
    prepared detections and the number of non-ignored GTs."""
    lo, hi = area_range
    gt_ignore = (prep.gt_area < lo) | (prep.gt_area > hi)
    # COCOeval sorts GT so non-ignored come first; matching prefers them
    gt_order = np.argsort(gt_ignore, kind="stable")
    gt_ignore = gt_ignore[gt_order]
    iou = prep.iou[:, gt_order]

    n_det, n_gt_total = iou.shape
    g_matched = np.full(n_gt_total, -1)
    d_matched = np.zeros(n_det, bool)
    d_ignore = np.zeros(n_det, bool)
    for di in range(n_det):
        best_iou = iou_thresh - 1e-10
        best_gi = -1
        for gi in range(n_gt_total):
            if g_matched[gi] >= 0:  # no crowd GTs -> never rematch
                continue
            # once matched to a real GT, never downgrade to an ignored one
            if best_gi >= 0 and not gt_ignore[best_gi] and gt_ignore[gi]:
                break
            if iou[di, gi] >= best_iou:
                best_iou = iou[di, gi]
                best_gi = gi
        if best_gi >= 0 and g_matched[best_gi] < 0:
            g_matched[best_gi] = di
            d_matched[di] = True
            d_ignore[di] = gt_ignore[best_gi]
    out_of_range = (prep.det_area < lo) | (prep.det_area > hi)
    d_ignore |= (~d_matched) & out_of_range
    n_gt = int((~gt_ignore).sum())
    return prep.det_scores, d_matched & ~d_ignore, d_ignore, n_gt


def _accumulate(per_image) -> Tuple[float, float]:
    """COCOeval accumulate for one (iou, area, maxdet) cell ->
    (AP_101pt, AR_maxrecall)."""
    scores = np.concatenate([s for s, _, _, _ in per_image]) \
        if per_image else np.zeros(0)
    tps = np.concatenate([t for _, t, _, _ in per_image]) \
        if per_image else np.zeros(0, bool)
    ign = np.concatenate([g for _, _, g, _ in per_image]) \
        if per_image else np.zeros(0, bool)
    npig = sum(n for _, _, _, n in per_image)
    if npig == 0:
        return float("nan"), float("nan")
    keep = ~ign
    scores, tps = scores[keep], tps[keep]
    order = np.argsort(-scores, kind="mergesort")
    tps = tps[order]
    tp_cum = np.cumsum(tps)
    fp_cum = np.cumsum(~tps)
    recall = tp_cum / npig
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    # monotone-decreasing precision envelope
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    # sample at the 101 recall points (first recall index >= point)
    if len(precision) == 0:
        prec_at = np.zeros_like(RECALL_POINTS)
    else:
        idx = np.searchsorted(recall, RECALL_POINTS, side="left")
        prec_at = np.where(idx < len(precision),
                           precision[np.minimum(idx, len(precision) - 1)],
                           0.0)
    ap = float(prec_at.mean())
    ar = float(recall[-1]) if len(recall) else 0.0
    return ap, ar


def evaluate_coco_protocol(
    images: Dict[Optional[str], List[ImageDetections]],
    iou_thresholds: Sequence[float] = IOU_THRESHOLDS,
    area_ranges: Sequence[str] = ("all", "small", "medium", "large"),
    max_dets: int = 100,
) -> Dict:
    """Full COCO-protocol evaluation.

    Args:
      images: {category: [ImageDetections per image]}. Use a single key
        (e.g. None) for class-agnostic evaluation.

    Returns {'ap': mAP@[.5:.95] (area=all), 'ap50', 'ap75',
             'ar': AR@maxDets, 'per_area': {...}, 'per_threshold': {...}}.
    """
    cats = list(images.keys())
    prepared = {cat: [_prepare_image(img, max_dets) for img in imgs]
                for cat, imgs in images.items()}
    ap_cell = {}
    ar_cell = {}
    for area in area_ranges:
        rng_ = AREA_RANGES[area]
        for t in iou_thresholds:
            aps, ars = [], []
            for cat in cats:
                per_image = [_match_image(prep, t, rng_)
                             for prep in prepared[cat]]
                ap, ar = _accumulate(per_image)
                if not np.isnan(ap):
                    aps.append(ap)
                    ars.append(ar)
            ap_cell[(t, area)] = float(np.mean(aps)) if aps else float("nan")
            ar_cell[(t, area)] = float(np.mean(ars)) if ars else float("nan")

    def mean_over_t(cells, area):
        vals = [cells[(t, area)] for t in iou_thresholds
                if not np.isnan(cells[(t, area)])]
        return float(np.mean(vals)) if vals else float("nan")

    has_all = "all" in area_ranges
    nan = float("nan")
    result = {
        "ap": mean_over_t(ap_cell, "all") if has_all else nan,
        "ap50": ap_cell.get((0.5, "all"), nan),
        "ap75": ap_cell.get((0.75, "all"), nan),
        "ar": mean_over_t(ar_cell, "all") if has_all else nan,
        "per_area": {a: mean_over_t(ap_cell, a) for a in area_ranges},
        "per_threshold": {float(t): ap_cell[(t, "all")]
                          for t in iou_thresholds} if has_all else {},
    }
    return result
