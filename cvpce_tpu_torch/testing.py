"""Adversarial inputs for the port's kernels: the one source of the edge
cases that `tests/test_torch_cuda.py` (under pytest) and `chip_smoke.py`
(in the smoke run on the card) both hold K1 and K2 to their plain
versions on. Numpy only; the callers move the arrays to the card."""
from __future__ import annotations

import numpy as np

# K1, called through nms_keep_sorted on score-sorted boxes
NMS_EDGE_CASES = ("identical", "walk_lt_n", "n4693", "ragged_walks",
                  "iou_at_thresh")
# K2: every query count the wrapper's tiling treats apart (1, a ragged
# tile, one full tile, more than two tiles), galleries whole and ragged
# in the scan's 32-row tiles, and k at each end and between
KNN_QUERIES = (1, 17, 32, 67)
KNN_GALLERIES = (4096, 4097, 8192)
KNN_KS = (1, 5, 8)
# a gallery of KNN_DUP_COPIES copies of KNN_DUP_ROWS rows: every
# distance ties that many ways, and the lowest copy must win
KNN_DUP_ROWS, KNN_DUP_COPIES = 2048, 4


def random_boxes(rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    """(B, N, 4) f32 detection-like boxes, centres in 1300 x 800."""
    cx, cy = rng.uniform(0, 1300, (b, n)), rng.uniform(0, 800, (b, n))
    w, h = rng.uniform(4, 120, (b, n)), rng.uniform(4, 160, (b, n))
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    -1).astype(np.float32)


def nms_sorted_case(case: str, rng: np.random.Generator):
    """(boxes_sorted (B, N, 4) f32, n_walk (B,) int32) for one of
    NMS_EDGE_CASES."""
    if case == "identical":  # exactly one keep
        return (np.tile(np.float32([10, 20, 60, 90]), (1, 700, 1)),
                np.array([700], np.int32))
    if case == "walk_lt_n":
        # invalid boxes (past n_walk) on top of valid ones: they can be
        # suppressed but never suppress
        valid = random_boxes(rng, 1, 1500)
        invalid = valid[:, :900] + rng.uniform(-2, 2, (1, 900, 4))
        return (np.concatenate([valid, invalid], 1).astype(np.float32),
                np.array([1500], np.int32))
    if case == "n4693":  # the serve scene's N, no multiple of 64
        return random_boxes(rng, 1, 4693), np.array([4693], np.int32)
    if case == "ragged_walks":
        return (random_boxes(rng, 8, 5120),
                np.array([5120, 3001, 64, 0, 1, 4999, 2048, 65], np.int32))
    if case == "iou_at_thresh":
        # integer boxes on a small grid: many pairs at IoU exactly 0.5 in
        # f32 (e.g. [0, 0, 3, 1] and [1, 0, 4, 1]: 2 / 4), others just
        # either side
        xy = rng.integers(0, 24, (2, 3000, 2))
        wh = rng.integers(1, 7, (2, 3000, 2))
        grid = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        grid[0, :600] = np.float32([[k % 40, 0, k % 40 + 3, 1]
                                    for k in range(600)])
        return grid, np.array([3000, 2500], np.int32)
    raise ValueError(f"unknown NMS edge case {case!r}")
