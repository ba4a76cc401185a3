"""RetinaNet anchor generation (numpy, once per canvas); counterpart of
cvpce_tpu/ops/anchors.py with the same flattening order: per level,
row-major over (y, x) grid cells with the 9 cell anchors contiguous."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

LEVELS = (3, 4, 5, 6, 7)
ASPECT_RATIOS = (0.5, 1.0, 2.0)
SCALE_OCTAVES = (0.0, 1.0 / 3.0, 2.0 / 3.0)


def level_sizes(level: int) -> Tuple[float, ...]:
    base = 2.0 ** (level + 2)
    return tuple(base * 2.0**o for o in SCALE_OCTAVES)


def cell_anchors(level: int) -> np.ndarray:
    """(9, 4) zero-centred anchors: aspect ratios outer, scales inner,
    rounded (torchvision AnchorGenerator)."""
    scales = np.asarray(level_sizes(level), np.float64)
    ratios = np.asarray(ASPECT_RATIOS, np.float64)
    h_ratios = np.sqrt(ratios)
    w_ratios = 1.0 / h_ratios
    ws = (w_ratios[:, None] * scales[None, :]).reshape(-1)
    hs = (h_ratios[:, None] * scales[None, :]).reshape(-1)
    base = np.stack([-ws, -hs, ws, hs], axis=1) / 2.0
    return np.round(base).astype(np.float32)


def grid_anchors(canvas_h: int, canvas_w: int,
                 levels: Sequence[int] = LEVELS
                 ) -> Tuple[np.ndarray, List[int]]:
    """(anchors (A_total, 4) float32 xyxy, per-level counts)."""
    all_anchors = []
    counts = []
    for level in levels:
        stride = 2**level
        gh = int(np.ceil(canvas_h / stride))
        gw = int(np.ceil(canvas_w / stride))
        base = cell_anchors(level)
        shift_x = np.arange(gw, dtype=np.float32) * stride
        shift_y = np.arange(gh, dtype=np.float32) * stride
        sx, sy = np.meshgrid(shift_x, shift_y)
        shifts = np.stack([sx, sy, sx, sy], axis=-1).reshape(-1, 1, 4)
        anchors = (shifts + base[None]).reshape(-1, 4)
        all_anchors.append(anchors)
        counts.append(len(anchors))
    return np.concatenate(all_anchors, axis=0), counts
