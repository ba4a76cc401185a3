"""GLN proposal evaluation: AP/AR over a detection dataset; counterpart
of cvpce_tpu/eval/proposals.py.

The detector is the port's GLN + postprocess_detections, so every batch
runs the hard-NMS kernel (K1) on the card; the matcher of ops/metrics.py
runs on the same device. Batch-sharded evaluation (`mesh=`) waits for
the parallel queue, and the P/R/F1 plots for utils/viz.py.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..data import transforms as T
from ..models.gln import GLN, GLNConfig, postprocess_detections
from ..ops import metrics as M
from ..utils import resolve_device


def make_variables_inference_fn(config: GLNConfig, device="cuda"
                                ) -> Callable:
    """(state_dict, images (B, H, W, 3), image_sizes (B, 2)) ->
    detections, with the weights as an argument: one GLN module serves
    every checkpoint, and a state_dict loads into it when another one
    (a different object) is passed."""
    dev = resolve_device(device)
    model = GLN(config).to(dev)
    anchors, counts = config.anchors()
    anchors_t = torch.from_numpy(anchors).to(dev)
    loaded = None

    @torch.inference_mode()
    def infer(state_dict: Dict, images, image_sizes) -> Dict:
        nonlocal loaded
        if loaded is not state_dict:
            model.load_state_dict(state_dict)
            loaded = state_dict
        outputs = model(torch.as_tensor(images).to(dev, torch.float32))
        sizes = torch.as_tensor(image_sizes).to(dev, torch.float32)
        return postprocess_detections(outputs, anchors_t, counts, sizes,
                                      config)

    return infer


def make_inference_fn(state_dict: Dict, config: GLNConfig, device="cuda"
                      ) -> Callable:
    """(images, image_sizes) -> detections with `state_dict` loaded."""
    infer = make_variables_inference_fn(config, device)
    return lambda images, image_sizes: infer(state_dict, images,
                                             image_sizes)


class DetectionEvalAdapter:
    """Wrap any (image, boxes) dataset into canvas-transformed eval
    items (imagenet-normalised, as in the JAX package) for
    evaluate_gln."""

    def __init__(self, base, extract, canvas_h: int, canvas_w: int,
                 device="cuda"):
        """extract: item -> (image HWC [0,1], boxes (T, 4))."""
        self.base = base
        self.extract = extract
        self.canvas_h = canvas_h
        self.canvas_w = canvas_w
        self.device = resolve_device(device)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i: int) -> Dict:
        img, boxes = self.extract(self.base[i])
        canvas, sboxes, (ch, cw), scale = T.detection_canvas(
            img, boxes, self.canvas_h, self.canvas_w, device=self.device)
        return {
            "image": canvas,
            "boxes": sboxes,
            "image_size": np.array([ch, cw], np.int32),
            "scale": np.float32(scale),
            "orig_boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
        }


def _numpy(x) -> np.ndarray:
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def evaluate_gln(state_dict: Dict, dataset, config: GLNConfig,
                 thresholds: Sequence[float] = (0.5,),
                 batch_size: int = 4, score_min: float = 0.0,
                 verbose: bool = False,
                 plot_out: str | None = None,
                 return_detections: bool = False,
                 infer_fn: Callable | None = None,
                 device="cuda") -> Dict:
    """Run detection over `dataset` (items with image/image_size/scale/
    orig_boxes fields) and compute the metric suite (AP, AR@300, max-F1
    P/R/C) per IoU threshold, with detections mapped back to original
    image coordinates. `infer_fn(state_dict, images, sizes)` replaces
    the port's GLN (make_variables_inference_fn, shared across
    calls)."""
    if plot_out:
        raise NotImplementedError(
            "plot_out needs utils/viz.py (matplotlib), which is not "
            "ported yet (ROADMAP.md Queue 1)")
    dev = resolve_device(device)
    if infer_fn is not None:
        def infer(images, sizes):
            return infer_fn(state_dict, images, sizes)
    else:
        infer = make_inference_fn(state_dict, config, dev)
    targets: List[np.ndarray] = []
    predictions: List[np.ndarray] = []
    confidences: List[np.ndarray] = []

    n = len(dataset)
    for start in range(0, n, batch_size):
        items = [dataset[i] for i in range(start, min(start + batch_size, n))]
        images = torch.stack([T.as_tensor(it["image"], dev) for it in items])
        sizes = torch.from_numpy(np.stack(
            [it["image_size"] for it in items]).astype(np.float32)).to(dev)
        res = infer(images, sizes)
        boxes = _numpy(res["boxes"])
        scores = _numpy(res["scores"])
        valid = _numpy(res["valid"])
        for i, item in enumerate(items):
            keep = valid[i] & (scores[i] > score_min)
            targets.append(item["orig_boxes"])
            predictions.append(boxes[i][keep] / item["scale"])
            confidences.append(scores[i][keep])
        if verbose and (start // batch_size) % 20 == 0:
            print(f"eval {start}/{n}")

    res = M.calculate_metrics(targets, predictions, confidences,
                              iou_thresholds=thresholds, device=dev)
    if return_detections:
        return res, (targets, predictions, confidences)
    return res
