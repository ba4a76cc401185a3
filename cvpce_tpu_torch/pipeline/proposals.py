"""Proposal generation: GLN inference + batched on-device crops (torch);
counterpart of cvpce_tpu/pipeline/proposals.py.

`input_norm` is the preprocessing the checkpoint was trained with:
"imagenet" or "raw01". The heatmap is returned only when the config
computes it (`with_gaussians`).

The config's serving options reach the model as they are: the int8
preset is `GLNConfig(compute_dtype='bfloat16', int8='static',
fold_backbone_fbn=True)` with a `fold_gln_backbone` state_dict and act
scales recorded on the photos to serve (`calibrate`), as bench.py
calibrates on its batch of 8.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..data import transforms as T
from ..models.gln import GLN, GLNConfig, postprocess_detections
from ..models.quant import calibrate_act_scales
from ..ops.image import crop_resize_square, scale_to_tanh
from ..utils import resolve_device

CROP_SIZE = 256


class ProposalGenerator:
    def __init__(self, state_dict: Dict[str, torch.Tensor],
                 config: GLNConfig, confidence_threshold: float = 0.5,
                 max_proposals: int = 256, input_norm: str = "imagenet",
                 device="cuda"):
        if input_norm not in ("imagenet", "raw01"):
            raise ValueError(f"unknown input_norm: {input_norm!r}")
        self.device = resolve_device(device)
        self.config = config
        self.confidence_threshold = confidence_threshold
        self.max_proposals = max_proposals
        self.input_norm = input_norm
        self.model = GLN(config)
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()
        anchors, self.level_counts = config.anchors()
        self.anchors = torch.from_numpy(anchors).to(self.device)

    def _canvas(self, image: np.ndarray):
        return T.detection_canvas(
            image, None, self.config.canvas_h, self.config.canvas_w,
            normalize=self.input_norm == "imagenet", device=self.device)

    def _canvases(self, images: List[np.ndarray]):
        canvases, sizes, scales = [], [], []
        for image in images:
            canvas, _, (ch, cw), scale = self._canvas(image)
            canvases.append(canvas)
            sizes.append([ch, cw])
            scales.append(scale)
        return (torch.stack(canvases),
                torch.tensor(sizes, dtype=torch.float32, device=self.device),
                scales)

    def calibrate(self, images: List[np.ndarray]) -> Dict:
        """Record the int8 act scales on `images` (HWC [0, 1]) in one
        batch; returns the scale tree."""
        return calibrate_act_scales(self.model, [self._canvases(images)[0]])

    @torch.inference_mode()
    def infer(self, canvases: torch.Tensor, sizes: torch.Tensor,
              return_candidates: bool = False) -> Dict[str, torch.Tensor]:
        """GLN forward + postprocess on (B, H, W, 3) canvases with
        content sizes (B, 2)."""
        outputs = self.model(canvases)
        return postprocess_detections(
            outputs, self.anchors, self.level_counts, sizes, self.config,
            return_candidates=return_candidates)

    def detect_batch(self, images: List[np.ndarray]) -> List[Dict]:
        """Detections per image (HWC [0, 1]) in image coordinates, the
        images forward in one batch."""
        canvases, sizes, scales = self._canvases(images)
        res = self.infer(canvases, sizes)
        out = []
        for i, scale in enumerate(scales):
            item = {"boxes": (res["boxes"][i] / scale).cpu().numpy(),
                    "scores": res["scores"][i].cpu().numpy(),
                    "valid": res["valid"][i].cpu().numpy()}
            if "gaussians" in res:
                item["gaussians"] = res["gaussians"][i].cpu().numpy()
            out.append(item)
        return out

    def detect(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        return self.detect_batch([image])[0]

    def generate_proposals(self, image: np.ndarray) -> np.ndarray:
        res = self.detect(image)
        keep = res["valid"] & (res["scores"] > self.confidence_threshold)
        return res["boxes"][keep]

    @torch.inference_mode()
    def crop_boxes(self, image, boxes: np.ndarray) -> torch.Tensor:
        """(N, 256, 256, 3) tanh-scale crops on the device, made in
        chunks of max_proposals boxes to bound memory."""
        img = T.as_tensor(image, self.device)
        b = torch.from_numpy(np.asarray(boxes, np.float32)).to(self.device)
        step = self.max_proposals
        chunks = [scale_to_tanh(crop_resize_square(img, b[s:s + step],
                                                   CROP_SIZE))
                  for s in range(0, len(b), step)]
        if not chunks:
            return torch.zeros((0, CROP_SIZE, CROP_SIZE, 3),
                               device=self.device)
        return torch.cat(chunks)

    def detect_with_crops(self, image: np.ndarray) -> Dict:
        """Detections above the confidence threshold: `boxes` (N, 4) and
        `scores` (N,) numpy, and their classification-ready `crops`
        (N, 256, 256, 3) tanh tensor on the device."""
        res = self.detect(image)
        keep = res["valid"] & (res["scores"] > self.confidence_threshold)
        boxes = res["boxes"][keep]
        return {"boxes": boxes, "scores": res["scores"][keep],
                "crops": self.crop_boxes(image, boxes)}

    def generate_proposals_and_images(self, image: np.ndarray
                                      ) -> Tuple[np.ndarray, torch.Tensor]:
        """(boxes (N, 4) numpy, crops (N, 256, 256, 3) tanh tensor)."""
        res = self.detect_with_crops(image)
        return res["boxes"], res["crops"]
