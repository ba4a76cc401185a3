"""Planogram compliance evaluation over a planogram test set (mean
detected accuracy + MSE against the ground-truth accuracy); counterpart
of cvpce_tpu/eval/compliance.py."""
from __future__ import annotations

from typing import Dict

import numpy as np


def evaluate_planograms(evaluator, planoset, verbose: bool = True
                        ) -> Dict[str, float]:
    """evaluator: pipeline.evaluator.PlanogramEvaluator; planoset items
    are either (img, anns, boxes, plano) [GP-180] or (img, {labels,
    boxes, actual_accuracy}) [internal]."""
    accuracies = []
    expected = []
    for i in range(len(planoset)):
        item = planoset[i]
        if len(item) == 4:
            img, _, _, plano = item
            planogram = {"boxes": plano["boxes"], "labels": plano["labels"],
                         "graph": plano.get("graph")}
        else:
            img, plano = item
            planogram = {"boxes": plano["boxes"], "labels": plano["labels"]}
        actual = plano.get("actual_accuracy", 1.0)
        score = evaluator.evaluate(img, planogram)
        accuracies.append(float(score))
        expected.append(float(actual))
        if verbose:
            print(f"[{i + 1}/{len(planoset)}] compliance={score:.3f} "
                  f"(ground truth {actual:.3f})")

    accuracies = np.asarray(accuracies)
    expected = np.asarray(expected)
    result = {
        "mean_accuracy": float(accuracies.mean()) if len(accuracies) else 0.0,
        "mse": float(((accuracies - expected) ** 2).mean())
               if len(accuracies) else 0.0,
        "per_image": accuracies.tolist(),
    }
    if verbose:
        print(f"Mean detected accuracy: {result['mean_accuracy']:.4f}, "
              f"MSE vs ground truth: {result['mse']:.4f}")
    return result
