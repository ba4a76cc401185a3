"""GLN training: losses, heatmap targets and the SGD step; counterpart of
cvpce_tpu/train/gln.py.

- SGD (momentum 0.9, weight decay 1e-4, dampening 0) over the trainable
  parameters only, the LR `lr * lr_multiplier ** (step // steps_per_epoch)`
  set before every step. torch's order (decay added to the gradient, the
  momentum trace, then the LR) is optax's masked
  add_decayed_weights -> sgd; the frozen stem gets no gradient at all
  (`requires_grad=False`), where optax zeroes its update.
- losses: per image, the focal loss over non-ignored anchors and the L1
  loss on encoded deltas over foreground anchors, each divided by
  max(#fg, 1), averaged over the batch; the Gaussian heatmap loss over
  the batch against targets rendered at half resolution on the device;
  total = scale_class * cls + reg + scale_gaussian * gauss.
- compute dtype: `compute_dtype='bfloat16'` runs the convolutions in
  bf16 on f32 parameters, flax's mixed precision (models/gln.py): each
  conv casts its f32 weight and bias to bf16, the FrozenBNs fold in f32
  and apply in bf16, the Gaussian BatchNorms take f32 statistics and
  return bf16, and the head outputs and heatmap reach the losses in f32.
  The gradients, the momentum, the update and every checkpoint are f32.
  int8 configs are serving paths and are refused.
- the train step works in place: the model's parameters, its Gaussian
  BatchNorm statistics and the optimizer's momentum buffers are updated
  where they are, and the step returns the state it was given.
- data parallelism wraps the step in parallel/mesh.py:make_dp_train_step:
  the Gaussian branch's BatchNorms and the hard-negative mining then see
  the global batch, the per-image losses average over equal local
  batches, and `apply_gradients` averages the gradients over the ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..models.gln import GLN, GLNConfig
from ..ops.boxes import encode_boxes
from ..ops.gaussians import render_gaussians_batch
from ..ops.losses import gaussian_heatmap_loss, sigmoid_focal_loss
from ..ops.matching import match_anchors
from ..parallel.mesh import average_gradients
from ..utils import resolve_device


@dataclasses.dataclass(frozen=True)
class GLNTrainConfig:
    # cvpce/proposals_training.py:33-39 defaults
    lr: float = 0.0025
    momentum: float = 0.9
    weight_decay: float = 1e-4
    lr_multiplier: float = 0.99
    scale_class: float = 1.0
    scale_gaussian: float = 1.0
    # gaussian loss params (cvpce/models/proposals.py:141)
    negative_threshold: float = 0.0
    positive_threshold: float = 0.1
    min_negatives: int = 1000
    negatives_per_positive: int = 3
    # anchors per chunk of the matcher's IoU matrix
    match_chunk: int = 8192
    # backbone freezing: trainable_layers=4 freezes the conv1/bn1 stem
    # and trains layer1..4
    trainable_layers: int = 4
    steps_per_epoch: int = 1000
    gauss_method: str = "simple"
    gauss_join: str = "max"


@dataclasses.dataclass
class GLNTrainState:
    """The model (updated in place), its optimizer (the momentum
    buffers) and the number of steps taken."""
    model: GLN
    optimizer: torch.optim.SGD
    step: int = 0

    def state_dict(self) -> Dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "step": self.step}

    def load_state_dict(self, sd: Dict) -> None:
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])


def _freeze_mask(model: torch.nn.Module,
                 trainable_layers: int) -> Dict[str, bool]:
    """Parameter name -> trainable, gln_backbone's layers_to_train
    slicing on the JAX parameter paths the port keeps
    (`body.layer1_0.conv1.weight`)."""
    train_prefixes = ["layer4", "layer3", "layer2", "layer1", "conv1"]
    trainable = set(train_prefixes[:trainable_layers])

    def is_trainable(name: str) -> bool:
        keys = name.split(".")
        if keys[0] != "body":
            return True
        stem = keys[1].split("_")[0]
        if stem in ("conv1", "bn1"):
            return "conv1" in trainable
        return any(stem.startswith(t) for t in trainable if t != "conv1")

    return {name: is_trainable(name) for name, _ in model.named_parameters()}


def make_optimizer(cfg: GLNTrainConfig,
                   model: torch.nn.Module) -> torch.optim.SGD:
    """SGD over the trainable parameters; the frozen ones stop
    requiring gradients."""
    mask = _freeze_mask(model, cfg.trainable_layers)
    params = []
    for name, p in model.named_parameters():
        p.requires_grad_(mask[name])
        if mask[name]:
            params.append(p)
    return torch.optim.SGD(params, lr=cfg.lr, momentum=cfg.momentum,
                           dampening=0.0, weight_decay=cfg.weight_decay)


def learning_rate(cfg: GLNTrainConfig, step: int) -> float:
    """The LR of optimizer step `step` (0-based): a multiplicative decay
    once an epoch."""
    return cfg.lr * cfg.lr_multiplier ** (step // cfg.steps_per_epoch)


def apply_gradients(optimizer: torch.optim.SGD, cfg: GLNTrainConfig,
                    step: int) -> None:
    """One SGD update at step `step`'s LR from the gradients in `.grad`,
    which it then clears. Inside a data-parallel step the gradients are
    first averaged over the ranks."""
    lr = learning_rate(cfg, step)
    for group in optimizer.param_groups:
        group["lr"] = lr
    average_gradients(p for group in optimizer.param_groups
                      for p in group["params"])
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def compute_losses(outputs: Dict[str, torch.Tensor], anchors: torch.Tensor,
                   gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   heatmap_targets: torch.Tensor, model_cfg: GLNConfig,
                   cfg: GLNTrainConfig) -> Dict[str, torch.Tensor]:
    """Batch GLN losses. gt boxes in canvas coordinates, padded
    (B, T, 4) with (B, T) valid; anchors (A, 4) unpadded."""
    matched_idx, fg, not_ignored = match_anchors(
        anchors, gt_boxes, gt_valid, chunk=cfg.match_chunk)
    num_fg = fg.sum(1).clamp(min=1)

    # classification: focal over non-ignored anchors, single class
    logits = outputs["cls_logits"]
    focal = sigmoid_focal_loss(logits, fg.to(logits.dtype)[..., None])
    cls = torch.where(not_ignored[..., None], focal,
                      torch.zeros_like(focal)).sum((1, 2)) / num_fg

    # regression: L1 on encoded deltas over foreground anchors
    matched = torch.gather(gt_boxes, 1,
                           matched_idx[..., None].expand(-1, -1, 4))
    target = encode_boxes(matched, anchors[None])
    l1 = (outputs["bbox_regression"] - target).abs().sum(-1)
    reg = torch.where(fg, l1, torch.zeros_like(l1)).sum(1) / num_fg

    gauss = gaussian_heatmap_loss(
        outputs["gaussians"], heatmap_targets, tanh=model_cfg.tanh,
        negative_threshold=cfg.negative_threshold,
        positive_threshold=cfg.positive_threshold,
        min_negatives=cfg.min_negatives,
        negatives_per_positive=cfg.negatives_per_positive)
    return {"classification": cls.mean(), "bbox_regression": reg.mean(),
            "gaussian": gauss}


def render_heatmap_targets(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                           image_sizes: torch.Tensor, model_cfg: GLNConfig,
                           cfg: GLNTrainConfig) -> torch.Tensor:
    """(B, H/2, W/2) heatmap targets from canvas-space boxes; pixels past
    an image's content keep the fill value (-1 tanh, else 0), which the
    loss counts as negatives."""
    hm = render_gaussians_batch(
        gt_boxes, gt_valid, height=model_cfg.canvas_h,
        width=model_cfg.canvas_w, method=cfg.gauss_method,
        join=cfg.gauss_join, tanh=model_cfg.tanh, size_reduction=2)
    dev = hm.device
    half = torch.div(image_sizes.long(), 2, rounding_mode="floor")
    yy = torch.arange(hm.shape[1], device=dev)[None, :, None]
    xx = torch.arange(hm.shape[2], device=dev)[None, None, :]
    inside = (yy < half[:, 0, None, None]) & (xx < half[:, 1, None, None])
    fill = -1.0 if model_cfg.tanh else 0.0
    return torch.where(inside, hm, torch.full_like(hm, fill))


def _to(x, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
    return t.to(device=device, dtype=dtype)


def make_train_step(model_cfg: GLNConfig, cfg: GLNTrainConfig,
                    anchors: np.ndarray) -> Callable:
    """(state, images (B, H, W, 3), gt_boxes (B, T, 4), gt_valid (B, T),
    image_sizes (B, 2)) -> (state, metrics): one SGD step on the
    state's device, in place. Inputs may be numpy arrays or tensors.
    `anchors` is the table of GLNConfig.anchors(). The metrics
    (classification, bbox_regression, gaussian, total) are 0-d tensors
    on the device."""
    anchors_np = np.asarray(anchors, np.float32)
    on_device = {}

    def train_step(state: GLNTrainState, images, gt_boxes, gt_valid,
                   image_sizes):
        model = state.model
        dev = next(model.parameters()).device
        if dev not in on_device:
            on_device[dev] = torch.from_numpy(anchors_np).to(dev)
        anchors_t = on_device[dev]
        images = _to(images, dev, torch.float32)
        gt_boxes = _to(gt_boxes, dev, torch.float32)
        gt_valid = _to(gt_valid, dev, torch.bool)
        image_sizes = _to(image_sizes, dev)
        heatmaps = render_heatmap_targets(
            gt_boxes, gt_valid, image_sizes, model_cfg, cfg)[..., None]

        model.train()
        outputs = model(images)
        losses = compute_losses(outputs, anchors_t, gt_boxes, gt_valid,
                                heatmaps, model_cfg, cfg)
        total = (cfg.scale_class * losses["classification"]
                 + losses["bbox_regression"]
                 + cfg.scale_gaussian * losses["gaussian"])
        total.backward()
        apply_gradients(state.optimizer, cfg, state.step)
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total"] = total.detach()
        return state, metrics

    return train_step


def make_multi_step(step_fn: Callable) -> Callable:
    """k steps of `step_fn` over a leading steps axis of stacked batches;
    the metrics come back stacked, shape (k,). Step for step what k
    calls of `step_fn` do."""

    def multi_step(state, images, gt_boxes, gt_valid, image_sizes):
        per_step = []
        for batch in zip(images, gt_boxes, gt_valid, image_sizes):
            state, metrics = step_fn(state, *batch)
            per_step.append(metrics)
        return state, {k: torch.stack([m[k] for m in per_step])
                       for k in per_step[0]}

    return multi_step


def init_train_state(model_cfg: GLNConfig, cfg: GLNTrainConfig,
                     seed: int = 0, state_dict: Optional[Dict] = None,
                     device="cuda") -> GLNTrainState:
    """A GLN on `device` with seeded random weights (init_gln_ drawing
    from a torch.Generator seeded with `seed`) or `state_dict`, and its
    optimizer. The parameters are f32 whatever `compute_dtype`: a
    bf16 config computes in bf16 on f32 master weights (GLN's
    `param_dtype`), with the f32 config's initial parameters, and a
    bf16 `state_dict` is widened to f32. int8 configs are refused: the
    JAX package's train step cannot apply them either (it has no
    'act_scales' collection)."""
    if model_cfg.int8 != "off":
        raise ValueError("GLN training takes int8='off' (int8 is a "
                         f"serving path); got int8={model_cfg.int8!r}")
    model = GLN(model_cfg, generator=torch.Generator().manual_seed(seed),
                param_dtype=torch.float32)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    model.to(resolve_device(device))
    return GLNTrainState(model, make_optimizer(cfg, model))
