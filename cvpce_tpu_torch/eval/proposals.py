"""GLN proposal evaluation: AP/AR over a detection dataset; counterpart
of cvpce_tpu/eval/proposals.py.

The detector is the port's GLN + postprocess_detections, so every batch
runs the hard-NMS kernel (K1) on the card; the matcher of ops/metrics.py
runs on the same device. With `mesh=` (parallel/mesh.py) every rank is
given the same batch, runs the forward and the postprocess on its own
slice of it and gathers the others' (`shard_inference`), so every rank
returns the whole batch's detections and the same metrics. `plot_out`
draws the P/R/F1 curves with utils/viz.py (matplotlib, which the card's
machine lacks).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..data import transforms as T
from ..models.gln import GLN, GLNConfig, postprocess_detections
from ..ops import metrics as M
from ..parallel.mesh import all_gather
from ..utils import resolve_device


def shard_inference(infer: Callable, mesh) -> Callable:
    """(images (B, ...), image_sizes (B, 2)) -> detections over a mesh:
    the batch, padded to a multiple of the rank count (zero images of
    content size 1 x 1, as the JAX package pads), is split into
    contiguous slices; each rank runs `infer` on its own and gathers
    every output, and the pad rows are dropped. Every rank must call it
    with the same batch."""
    def sharded(images, image_sizes) -> Dict:
        n = len(images)
        local = -(-n // mesh.size)
        pad = local * mesh.size - n
        if pad:
            images = torch.cat([images, images.new_zeros(
                (pad, *images.shape[1:]))])
            image_sizes = torch.cat([image_sizes, image_sizes.new_ones(
                (pad, 2))])
        rows = slice(mesh.rank * local, (mesh.rank + 1) * local)
        res = infer(images[rows], image_sizes[rows])
        return {k: torch.cat(all_gather(v, mesh))[:n]
                for k, v in res.items()}
    return sharded


def make_variables_inference_fn(config: GLNConfig, mesh=None,
                                device="cuda") -> Callable:
    """(state_dict, images (B, H, W, 3), image_sizes (B, 2)) ->
    detections, with the weights as an argument: one GLN module serves
    every checkpoint, and each call runs the weights it is given, as the
    JAX function applies its variables on every call. The state_dict is
    loaded again unless every tensor in it is the one loaded last and
    unchanged since (same storage, same `_version`), so an in-place
    update, as an optimizer step makes, reaches the next call. A bf16
    config's GLN stores its convs in bf16, so the f32 weights of a bf16
    training run serve rounded to bf16, as JAX's eval casts its f32
    parameters at each conv.

    `mesh`: the batch is shared out over the ranks (`shard_inference`);
    every rank passes the same weights and batch and gets every image's
    detections."""
    dev = resolve_device(device)
    model = GLN(config).to(dev)
    anchors, counts = config.anchors()
    anchors_t = torch.from_numpy(anchors).to(dev)
    loaded = None  # (the tensors loaded last, their versions)

    def detect(images, sizes) -> Dict:
        return postprocess_detections(model(images), anchors_t, counts,
                                      sizes, config)

    run = detect if mesh is None else shard_inference(detect, mesh)

    @torch.inference_mode()
    def infer(state_dict: Dict, images, image_sizes) -> Dict:
        nonlocal loaded
        key = _weights_key(state_dict)
        if key is None or loaded is None or loaded[1] != key:
            model.load_state_dict(state_dict)
            # holding the tensors keeps their storage from being reused
            loaded = (list(state_dict.values()), key)
        return run(torch.as_tensor(images).to(dev, torch.float32),
                   torch.as_tensor(image_sizes).to(dev, torch.float32))

    return infer


def _weights_key(state_dict: Dict):
    """(name, storage pointer, version) of each tensor, or None where a
    tensor keeps no version (one made under inference mode): such a
    state_dict is loaded on every call."""
    try:
        return [(name, t.data_ptr(), t._version)
                for name, t in state_dict.items()]
    except RuntimeError:
        return None


def make_inference_fn(state_dict: Dict, config: GLNConfig, device="cuda"
                      ) -> Callable:
    """(images, image_sizes) -> detections with `state_dict` loaded."""
    infer = make_variables_inference_fn(config, device=device)
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
                 mesh=None, device="cuda") -> Dict:
    """Run detection over `dataset` (items with image/image_size/scale/
    orig_boxes fields) and compute the metric suite (AP, AR@300, max-F1
    P/R/C) per IoU threshold, with detections mapped back to original
    image coordinates. `infer_fn(state_dict, images, sizes)` replaces
    the port's GLN (make_variables_inference_fn, shared across
    calls). `mesh` (without an infer_fn): every batch is shared out over
    the ranks, `batch_size` a multiple of their count; every rank
    returns the same metrics. `plot_out` ("x.png"): the P/R/F1 curves
    of each IoU threshold t into "x_iou{t}.png" (rank 0 alone under a
    mesh; matplotlib needed)."""
    dev = resolve_device(device)
    if infer_fn is None and mesh is not None:
        assert batch_size % mesh.size == 0, (
            f"batch_size {batch_size} not divisible over {mesh.size} "
            "ranks")
        infer_fn = make_variables_inference_fn(config, mesh, device=dev)
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
    if plot_out and (mesh is None or mesh.rank == 0):
        # P/R/F1-vs-recall curves per threshold (the reference's `plots`
        # flag, cvpce/proposals_eval.py + metrics.plot_prfc)
        from ..utils.viz import plot_prfc

        for t, d in res.items():
            raw = d["raw"]
            plot_prfc(raw["p"], raw["r"], raw["f"], raw["c"],
                      plot_out.replace(".png", f"_iou{t}.png"),
                      title=f"IoU {t}")
    if return_detections:
        return res, (targets, predictions, confidences)
    return res
