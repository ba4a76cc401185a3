"""Compliance comparison and the end-to-end planogram evaluator (torch);
counterpart of cvpce_tpu/pipeline/evaluator.py with the same fallbacks:
no detections -> 0 (or 1 for an empty planogram); no graph matching ->
0; no homography -> |matching| / |expected|; optional second-chance
reclassification of projected missing-product regions.

The comparator builds graphs and matches them with the native engine
(pipeline/native.py) by default, as in the JAX package; where it does
not build, the comparator raises, and `use_native=False` is the explicit
pure-Python route (pipeline/planograms.py).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..data import transforms as T
from ..utils import resolve_device
from . import planograms as pg


class PlanogramComparator:
    def __init__(self, graph_threshold: float = 0.5,
                 use_native: bool = True, device="cuda"):
        self.graph_threshold = graph_threshold
        self.device = resolve_device(device)
        self._native = None
        if use_native:
            from . import native

            native.load()
            self._native = native

    def _build_graph(self, boxes, labels):
        if self._native is not None:
            return self._native.build_graph(boxes, labels,
                                            self.graph_threshold)
        return pg.build_graph(boxes, labels, self.graph_threshold)

    def _match(self, ge, ga):
        if self._native is not None:
            return self._native.large_common_subgraph(ge, ga)
        return pg.large_common_subgraph(ge, ga)

    def compare(self, expected: Dict, actual: Dict,
                image: Optional[np.ndarray] = None,
                classifier=None) -> float:
        return self.compare_detailed(expected, actual, image,
                                     classifier)[0]

    def compare_detailed(self, expected: Dict, actual: Dict,
                         image: Optional[np.ndarray] = None,
                         classifier=None):
        """(compliance, per-expected-slot found mask or None, path)."""
        if image is None:
            reproj_threshold = 10.0
        else:
            h, w = image.shape[:2]
            reproj_threshold = min(h, w) * 0.01

        if not len(actual["boxes"]):
            return ((0.0 if len(expected["boxes"]) else 1.0),
                    None, "no_detections")

        ge = expected.get("graph")
        if ge is None:
            ge = self._build_graph(expected["boxes"], expected["labels"])
        ga = self._build_graph(actual["boxes"], actual["labels"])
        matching = self._match(ge, ga)
        if not len(matching):
            return 0.0, None, "no_matching"

        found, missing_indices, missing_positions, missing_labels = \
            pg.finalize_via_ransac(
                matching, expected["boxes"], actual["boxes"],
                expected["labels"], actual["labels"],
                reproj_threshold=reproj_threshold, device=self.device)
        if found is None:
            return (len(matching) / len(expected["boxes"]),
                    None, "no_homography")

        if classifier is not None and image is not None \
                and len(missing_positions):
            h, w = image.shape[:2]
            mp = missing_positions.copy()
            mp[:, [0, 2]] = mp[:, [0, 2]].clip(0, w)
            mp[:, [1, 3]] = mp[:, [1, 3]].clip(0, h)
            valid = (mp[:, 2] - mp[:, 0] > 1) & (mp[:, 3] - mp[:, 1] > 1)
            if not valid.any():
                return float(found.sum() / len(found)), found, "ransac"
            missing_indices = missing_indices[valid]
            mp = mp[valid]
            missing_labels = [lbl for lbl, v in zip(missing_labels, valid)
                              if v]
            img = T.as_tensor(image, self.device)
            crops = torch.stack([
                T.scale_to_tanh(T.resize_for_classification(
                    img[int(y1):int(y2), int(x1):int(x2)]))
                for x1, y1, x2, y2 in mp.astype(int)])
            reclass = classifier.classify(crops)
            for idx, exp_label, act_labels in zip(missing_indices,
                                                  missing_labels, reclass):
                if exp_label == act_labels[0]:
                    found[idx] = True
        return float(found.sum() / len(found)), found, "ransac"


class PlanogramEvaluator:
    """generator -> classifier -> comparator.

    color_correct=True removes the scene-level photometric state
    (pipeline/colorcorrect.py) from the classify leg only: detection
    runs on the raw image, while the classification crops, the
    comparator's second-chance ones included, come from the corrected
    scene."""

    def __init__(self, proposal_generator, classifier, comparator,
                 color_correct: bool = False):
        self.proposal_generator = proposal_generator
        self.classifier = classifier
        self.comparator = comparator
        self.color_correct = color_correct

    def evaluate(self, image: np.ndarray, planogram: Dict) -> float:
        return self.evaluate_detailed(image, planogram)[0]

    def evaluate_detailed(self, image: np.ndarray, planogram: Dict):
        """(compliance, per-expected-slot found mask or None, path)."""
        if self.color_correct:
            from .colorcorrect import scene_color_correct

            cls_image = scene_color_correct(image)
            boxes = self.proposal_generator.generate_proposals(image)
            crops = self.proposal_generator.crop_boxes(cls_image, boxes)
        else:
            boxes, crops = \
                self.proposal_generator.generate_proposals_and_images(image)
            cls_image = image
        classes = ([ann[0] for ann in self.classifier.classify(crops)]
                   if len(crops) else [])
        return self.comparator.compare_detailed(
            planogram, {"boxes": boxes, "labels": classes}, cls_image,
            self.classifier)
