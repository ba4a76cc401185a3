"""Serving-threshold calibration for the production detector; counterpart
of cvpce_tpu/pipeline/calibrate.py.

`calibrate_confidence` picks the max-F1 confidence threshold on a
held-out split (the metric stack's `c` at max F1) and records the
preprocessing the checkpoint expects. The result is the same json file,
`serving_calibration.json`, next to the checkpoint, so either package
reads the other's file.
"""
from __future__ import annotations

import json
from os import path
from typing import Dict, Optional

CALIBRATION_FILE = "serving_calibration.json"


def calibrate_confidence(state_dict, model_cfg, dataset,
                         iou_threshold: float = 0.5,
                         batch_size: int = 4,
                         infer_fn=None,
                         input_norm: str = "imagenet",
                         device="cuda") -> Dict:
    """Sweep the detection-confidence operating point on `dataset`
    (held-out scenes) through eval/proposals.py:evaluate_gln and return
    the max-F1 point: {"threshold", "f1", "precision", "recall", "ap",
    "ar_300", "iou_threshold", "n_images", "input_norm"}.

    `input_norm` records the preprocessing the checkpoint expects
    ("imagenet", or "raw01" for the synthetic sets that feed [0, 1]
    images); resolve_input_norm reads it back at serving."""
    from ..eval.proposals import evaluate_gln

    res = evaluate_gln(state_dict, dataset, model_cfg,
                       thresholds=(iou_threshold,),
                       batch_size=batch_size, infer_fn=infer_fn,
                       device=device)
    stats = res[iou_threshold]
    return {
        "threshold": float(stats["c"]),
        "f1": float(stats["f"]),
        "precision": float(stats["p"]),
        "recall": float(stats["r"]),
        "ap": float(stats["ap"]),
        "ar_300": float(stats["ar_300"]),
        "iou_threshold": float(iou_threshold),
        "n_images": len(dataset),
        "input_norm": input_norm,
    }


def save_calibration(checkpoint_dir: str, calibration: Dict) -> str:
    out = path.join(checkpoint_dir, CALIBRATION_FILE)
    with open(out, "w") as f:
        json.dump(calibration, f, indent=1)
    return out


def load_calibration(checkpoint_dir: str) -> Optional[Dict]:
    p = path.join(checkpoint_dir, CALIBRATION_FILE)
    if not path.exists(p):
        return None
    with open(p) as f:
        return json.load(f)


def resolve_threshold(confidence, checkpoint_dir: Optional[str],
                      default: float = 0.5) -> float:
    """An explicit number wins; 'auto' (or None) reads the checkpoint's
    calibration file and falls back to the reference's 0.5 without
    one."""
    if confidence is not None and confidence != "auto":
        return float(confidence)
    if checkpoint_dir:
        cal = load_calibration(checkpoint_dir)
        if cal:
            return float(cal["threshold"])
    return default


def resolve_input_norm(checkpoint_dir: Optional[str],
                       default: str = "imagenet") -> str:
    """The checkpoint's preprocessing from its calibration file's
    `input_norm`; `default` when there is no file or no field."""
    if checkpoint_dir:
        cal = load_calibration(checkpoint_dir)
        if cal and "input_norm" in cal:
            return str(cal["input_norm"])
    return default


def calibration_dir_for_weights(weights: Optional[str]) -> Optional[str]:
    """The directory whose calibration file governs `weights` (a run
    dir, its `checkpoint` subdir or a file in it): the path itself,
    then its parent, the first with a calibration file, else the
    innermost candidate."""
    if weights is None:
        return None
    weights = path.abspath(weights)
    first = weights if path.isdir(weights) else path.dirname(weights)
    for d in (first, path.dirname(first)):
        if load_calibration(d):
            return d
    return first
