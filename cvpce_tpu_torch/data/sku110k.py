"""SKU-110K batch padding; counterpart of the padding half of
cvpce_tpu/data/sku110k.py. `pad_boxes` buckets box counts and
`collate_detection` stacks items (image, boxes in canvas coordinates,
image_size) into one fixed-shape batch, so the train step sees static
shapes. The dataset class itself decodes images with cv2/PIL and waits
for the data item of ROADMAP.md Queue 1.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


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
    """Stack items into one fixed-shape batch dict."""
    max_t = max((len(it["boxes"]) for it in items), default=1)
    bucket = max(box_bucket, ((max_t + 63) // 64) * 64)
    boxes, valids = zip(*(pad_boxes(it["boxes"], bucket) for it in items))
    return {
        "images": np.stack([it["image"] for it in items]),
        "boxes": np.stack(boxes),
        "box_valid": np.stack(valids),
        "image_sizes": np.stack([it["image_size"] for it in items]),
    }
