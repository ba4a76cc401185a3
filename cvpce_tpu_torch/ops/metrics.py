"""Detection metrics: greedy matching, P/R, F1, 11-point VOC AP, AR@300
(torch + numpy); counterpart of cvpce_tpu/ops/metrics.py.

The per-image matcher is the closed form of the reference's greedy
confidence-ordered loop: predictions are visited in descending
confidence, each marks *every* not-yet-used target with IoU >= the
threshold, and is a true positive iff it marked one. The targets marked
by prediction i are {j : iou[i, j] >= t} whatever the visit order, so
"used before prediction i" is the exclusive cumulative OR of the
threshold mask over predictions 0..i-1, and
    tp[i] = any_j(mask[i, j] & ~used_before[i, j]).
It runs on the given device, all thresholds at once; aggregation
(merge, sort, AP) is host numpy.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..utils import resolve_device
from .boxes import pairwise_iou


def match_detections(target_boxes: np.ndarray, pred_boxes: np.ndarray,
                     confidences: np.ndarray,
                     iou_thresholds: Sequence[float], device="cuda"
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-image matching: returns (tp[num_thr, P], sorted_conf[P]).

    Predictions are sorted by descending confidence (stable, so earlier
    predictions win ties)."""
    dev = resolve_device(device)
    order = np.argsort(-np.asarray(confidences), kind="stable")
    pred_sorted = np.asarray(pred_boxes, np.float32).reshape(-1, 4)[order]
    conf_sorted = np.asarray(confidences, np.float32)[order]
    tgt = np.asarray(target_boxes, np.float32).reshape(-1, 4)
    ious = pairwise_iou(torch.from_numpy(pred_sorted).to(dev),
                        torch.from_numpy(tgt).to(dev))
    thr = torch.tensor(list(iou_thresholds), dtype=torch.float32,
                       device=dev)
    mask = ious[None] >= thr[:, None, None]  # (num_thr, P, T)
    m = mask.to(torch.int32)
    used_before = (m.cumsum(1) - m) > 0  # exclusive cumulative OR
    tp = (mask & ~used_before).any(2)
    return tp.to(torch.float32).cpu().numpy(), conf_sorted


def precision_and_recall(tp: np.ndarray, fp: np.ndarray,
                         total_targets: int) -> Tuple[np.ndarray, np.ndarray]:
    """Cumulative precision/recall curves."""
    ctp = np.cumsum(tp)
    cfp = np.cumsum(fp)
    denom = ctp + cfp
    precision = np.where(denom > 0, ctp / np.where(denom > 0, denom, 1), 0.0)
    if total_targets > 0:
        recall = ctp / total_targets
    else:
        recall = np.zeros_like(ctp)
    return precision, recall


def f_score(precision: np.ndarray, recall: np.ndarray) -> np.ndarray:
    """F1 curve with NaN->0."""
    denom = precision + recall
    return np.where(denom > 0,
                    2 * precision * recall / np.where(denom > 0, denom, 1),
                    0.0)


def average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """11-point interpolated VOC AP."""
    values = np.zeros(11, dtype=np.float64)
    for i, r in enumerate(np.linspace(0, 1, 11)):
        above = precision[recall >= r]
        if len(above) > 0:
            values[i] = above.max()
        else:
            break  # recall is non-decreasing: later levels are empty too
    return float(values.mean())


class StreamingMetrics:
    """Incremental metric accumulation: add() each image's results as
    they come off the device, result() at the end."""

    def __init__(self, iou_thresholds: Sequence[float] = (0.5,),
                 device="cuda"):
        self.thresholds = list(iou_thresholds)
        self.device = resolve_device(device)
        self._tp: List[np.ndarray] = []
        self._conf: List[np.ndarray] = []
        self._recall_300 = {t: [] for t in self.thresholds}
        self._total_targets = 0

    def add(self, target_boxes, pred_boxes, confidences) -> None:
        tgt = np.asarray(target_boxes, np.float32).reshape(-1, 4)
        pred = np.asarray(pred_boxes, np.float32).reshape(-1, 4)
        conf = np.asarray(confidences, np.float32).reshape(-1)
        tp, conf_sorted = match_detections(tgt, pred, conf, self.thresholds,
                                           self.device)
        self._tp.append(tp)
        self._conf.append(conf_sorted)
        self._total_targets += len(tgt)
        for ti, t in enumerate(self.thresholds):
            if len(conf_sorted) > 0 and len(tgt) > 0:
                r300 = np.cumsum(tp[ti][:300])[-1] / len(tgt)
            else:
                r300 = 0.0
            self._recall_300[t].append(float(r300))

    def result(self) -> Dict:
        merged_conf = (np.concatenate(self._conf)
                       if self._conf else np.zeros(0, np.float32))
        sort_idx = np.argsort(-merged_conf, kind="stable")
        merged_conf = merged_conf[sort_idx]
        res = {}
        for ti, t in enumerate(self.thresholds):
            tp = (np.concatenate([m[ti] for m in self._tp])
                  if self._tp else np.zeros(0, np.float32))[sort_idx]
            fp = 1.0 - tp
            p, r = precision_and_recall(tp, fp, self._total_targets)
            f = f_score(p, r)
            if len(f) > 0:
                mi = int(np.argmax(f))
                best = (float(f[mi]), float(p[mi]), float(r[mi]),
                        float(merged_conf[mi]))
            else:
                best = (0.0, 0.0, 0.0, 0.0)
            rc = self._recall_300[t]
            res[t] = {
                "raw": {"p": p, "r": r, "f": f, "c": merged_conf},
                "f": best[0], "p": best[1], "r": best[2], "c": best[3],
                "ap": average_precision(p, r),
                "ar_300": sum(rc) / len(rc) if rc else 0.0,
            }
        return res


def calculate_metrics(targets: Sequence, predictions: Sequence,
                      confidences: Sequence,
                      iou_thresholds: Sequence[float] = (0.5,),
                      device="cuda") -> Dict:
    """Corpus-level detection metrics: per IoU threshold a dict with
    max-F1 `f`, precision/recall at max F1 `p`/`r`, confidence at max F1
    `c`, 11-point `ap`, `ar_300`, and the `raw` P/R/F1/conf curves.
    Inputs are per-image sequences of (T_i, 4) target boxes, (P_i, 4)
    predicted boxes and (P_i,) confidences."""
    acc = StreamingMetrics(iou_thresholds, device)
    for tgt, pred, conf in zip(targets, predictions, confidences):
        acc.add(tgt, pred, conf)
    return acc.result()
