"""Product-detection evaluation: GLN proposals -> crops -> gallery kNN ->
per-class AP; counterpart of cvpce_tpu/eval/detection.py. Detection runs
K1, the gallery search K2 for galleries of >= 4096 entries, and the
matcher of ops/metrics.py on the proposal generator's device."""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from ..ops import metrics as M


def evaluate_detections(proposal_generator, classifier, testset,
                        thresholds: Sequence[float] = (0.5,),
                        verbose: bool = True):
    """testset: items (img, anns, boxes) plus `ann_to_int`/`int_to_ann`
    lookups.

    Returns (per_class_metrics, overall_metrics), raw curves dropped."""
    device = proposal_generator.device
    n_classes = len(testset.int_to_ann)
    predictions = {c: [] for c in range(n_classes)}
    targets = {c: [] for c in range(n_classes)}
    confidences = {c: [] for c in range(n_classes)}
    all_predictions, all_targets, all_confidences = [], [], []

    for i in range(len(testset)):
        if verbose and i % 10 == 0:
            print(f"{i}...")
        img, anns, gt_boxes = testset[i]
        gt_labels = np.asarray([testset.ann_to_int[a] for a in anns])
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)

        res = proposal_generator.detect_with_crops(img)
        boxes, scores = res["boxes"], res["scores"]
        if len(boxes):
            classes = classifier.classify(res["crops"])
            class_ids = np.asarray([
                testset.ann_to_int.get(ann[0], -1) for ann in classes
            ])
        else:
            class_ids = np.zeros(0, np.int64)

        class_set = set(class_ids.tolist()) | set(gt_labels.tolist())
        for c in class_set:
            p = boxes[class_ids == c] if len(boxes) else \
                np.zeros((0, 4), np.float32)
            s = scores[class_ids == c] if len(boxes) else \
                np.zeros(0, np.float32)
            t = gt_boxes[gt_labels == c]
            all_predictions.append(p)
            all_confidences.append(s)
            all_targets.append(t)
            if c != -1:
                predictions[c].append(p)
                confidences[c].append(s)
                targets[c].append(t)

    per_class = {
        c: M.calculate_metrics(targets[c], predictions[c], confidences[c],
                               thresholds, device)
        for c in range(n_classes)
    }
    overall = M.calculate_metrics(all_targets, all_predictions,
                                  all_confidences, thresholds, device)

    def strip(r):
        return {t: {k: v for k, v in d.items() if k != "raw"}
                for t, d in r.items()}

    return ({c: strip(r) for c, r in per_class.items()}, strip(overall))


def mean_average_metrics(per_class: Dict, thresholds: Sequence[float]):
    """mAP / mAR@300 over classes."""
    return {t: {
        "map": sum(d[t]["ap"] for d in per_class.values()) / len(per_class),
        "mar300": sum(d[t]["ar_300"] for d in per_class.values())
                  / len(per_class),
    } for t in thresholds}
