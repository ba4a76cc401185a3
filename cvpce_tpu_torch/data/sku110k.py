"""SKU-110K dataset, its target-domain crops and padded batches;
counterpart of cvpce_tpu/data/sku110k.py.

The same index (malformed rows and skip-listed names left out), the same
50% horizontal flip drawn from `self.rng` (so both packages draw the
same numbers from the same seed), the same corrupt-image fallback to
item 0 on an OSError (a truncated or corrupt file). Images are decoded
by the port's PNG and JPEG decoders (transforms.decode_image); a JPEG
feature they refuse (progressive, CMYK, ...) raises
NotImplementedError, which is not an OSError and so is never replaced
by item 0. `pad_boxes` buckets box
counts and `collate_detection` stacks items into one fixed-shape batch,
so the train step sees static shapes. Gaussian heatmap targets are
rendered by the train step (train/gln.py:render_heatmap_targets).
"""
from __future__ import annotations

import csv
from os import path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import transforms as T


class SKU110KDataset:
    def __init__(self, img_dir: str, annotation_file: str,
                 skip: Sequence[str] = (), flip_chance: float = 0.5,
                 canvas_h: int = 832, canvas_w: int = 1344,
                 seed: int = 0, device="cpu"):
        """`device`: where `__getitem__` builds the canvas. The CPU by
        default, as a loader thread wants it (the train step and
        evaluate_gln move each batch to the card); give "cuda" to
        resize on the card."""
        self.img_dir = img_dir
        self.index = self._build_index(annotation_file, set(skip))
        self.flip_chance = flip_chance
        self.canvas_h = canvas_h
        self.canvas_w = canvas_w
        self.rng = np.random.default_rng(seed)
        self.device = device

    @staticmethod
    def _build_index(annotation_file: str, skip) -> List[Dict]:
        index: Dict[str, Dict] = {}
        with open(annotation_file, "r") as f:
            for row in csv.reader(f):
                if len(row) != 8:
                    print(f"Malformed annotation row: {row}, skipping")
                    continue
                name, x1, y1, x2, y2, _, img_w, img_h = row
                if name in skip:
                    continue
                entry = index.setdefault(name, {
                    "image_name": name,
                    "image_width": int(img_w),
                    "image_height": int(img_h),
                    "boxes": [],
                })
                entry["boxes"].append([int(c) for c in (x1, y1, x2, y2)])
        out = []
        for entry in index.values():
            entry["boxes"] = np.asarray(entry["boxes"], np.float32)
            out.append(entry)
        return out

    def index_for_name(self, name: str) -> Optional[int]:
        for i, entry in enumerate(self.index):
            if entry["image_name"] == name:
                return i
        return None

    def __len__(self) -> int:
        return len(self.index)

    def load_raw(self, i: int):
        entry = self.index[i]
        img = T.load_image(path.join(self.img_dir, entry["image_name"]))
        return img, entry["boxes"].copy()

    def __getitem__(self, i: int) -> Dict:
        """The item dict of the JAX package; "image" is the canvas
        (canvas_h, canvas_w, 3) f32 tensor on `self.device`, ImageNet-
        normalised, the rest numpy."""
        entry = self.index[i]
        try:
            img, boxes = self.load_raw(i)
        except OSError:
            print(f"WARNING: Malformed image: {entry['image_name']} - "
                  f"returning image 0 instead")
            return self[0]
        if self.flip_chance > 0 and self.rng.random() < self.flip_chance:
            img, boxes = T.hflip_with_boxes(img, boxes)
        canvas, sboxes, (ch, cw), scale = T.detection_canvas(
            img, boxes, self.canvas_h, self.canvas_w, device=self.device)
        return {
            "image": canvas,
            "boxes": sboxes,
            "image_size": np.array([ch, cw], np.int32),
            "scale": np.float32(scale),
            "name": entry["image_name"],
            "orig_boxes": boxes,
            "orig_size": np.array(img.shape[:2], np.int32),
        }


class TargetDomainDataset:
    """SKU-110K boxes flattened into square 256x256 product crops, the
    'real' samples of the GAN discriminator. Items are (256, 256, 3)
    f32 CPU tensors in [0, 1]."""

    def __init__(self, img_dir: str, annotation_file: str,
                 skip: Sequence[str] = ()):
        self.base = SKU110KDataset(img_dir, annotation_file, skip,
                                   flip_chance=0.0)
        counts = np.array([len(e["boxes"]) for e in self.base.index])
        self.cum = np.cumsum(counts)

    def __len__(self) -> int:
        return int(self.cum[-1]) if len(self.cum) else 0

    def __getitem__(self, i: int) -> torch.Tensor:
        img_idx = int(np.searchsorted(self.cum, i, side="right"))
        box_idx = i - (self.cum[img_idx - 1] if img_idx > 0 else 0)
        img, boxes = self.base.load_raw(img_idx)
        h, w = img.shape[:2]
        x1, y1, x2, y2 = boxes[int(box_idx)].astype(int)
        crop = img[max(0, y1):min(h, y2), max(0, x1):min(w, x2)]
        if crop.size == 0:
            crop = np.full((4, 4, 3), 0.5, np.float32)
        return T.resize_for_classification(crop)


def pad_boxes(boxes: np.ndarray, bucket: int):
    """Pad (T, 4) boxes to the next multiple of `bucket`; returns
    (padded (Tb, 4), valid (Tb,))."""
    t = len(boxes)
    tb = max(bucket, ((t + bucket - 1) // bucket) * bucket)
    out = np.zeros((tb, 4), np.float32)
    if t:
        out[:t] = boxes
    valid = np.arange(tb) < t
    return out, valid


def collate_detection(items: Sequence[Dict], box_bucket: int = 768) -> Dict:
    """Stack items into one fixed-shape batch dict. Images that are
    tensors stack into a tensor on their device, numpy ones into numpy."""
    max_t = max((len(it["boxes"]) for it in items), default=1)
    bucket = max(box_bucket, ((max_t + 63) // 64) * 64)
    boxes, valids = zip(*(pad_boxes(it["boxes"], bucket) for it in items))
    images = [it["image"] for it in items]
    return {
        "images": (torch.stack(images) if torch.is_tensor(images[0])
                   else np.stack(images)),
        "boxes": np.stack(boxes),
        "box_valid": np.stack(valids),
        "image_sizes": np.stack([it["image_size"] for it in items]),
    }
