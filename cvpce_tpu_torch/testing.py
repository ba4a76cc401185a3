"""Adversarial inputs for the port's kernels: the one source of the edge
cases that `tests/test_torch_cuda.py` (under pytest) and `chip_smoke.py`
(in the smoke run on the card) both hold K1, K2, K3 and K4 to their
plain versions on. Numpy only; the callers move the arrays to the card."""
from __future__ import annotations

import numpy as np

# K1, called through nms_keep_sorted on score-sorted boxes
NMS_EDGE_CASES = ("identical", "walk_lt_n", "n4693", "ragged_walks",
                  "iou_at_thresh")
# K3, called through soft_nms_scores_fused with both methods. N = 1, 31,
# 33, 1000 and 4693 (the serve scene's) are no multiple of the 64-box
# mask words nor all of the 32-entry argmax groups
SOFT_EDGE_CASES = ("identical", "disjoint", "ties", "n1", "n31", "n33",
                   "n1000", "n4693", "empty_image", "ragged_valid",
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
# K4, called through fused_pool_int8_conv, (B, H, W, Cin, Cout) of each:
# pooled values exactly halfway between two int8 steps (round half to
# even), values beyond +-127.5 steps (saturation), all-negative inputs,
# B = 1, pooled sizes that fill no 128-pixel tile (9 x 11, 17 x 19), and
# Cin 64, 128 and 256, the last with a Cout that ends inside a 128-channel
# tile. "ties", "saturate" and "negative" keep 9 * Cin * 127^2 below 2^24,
# so f32 holds their accumulators exactly.
POOL_CASE_SHAPES = {"ties": (2, 16, 20, 64, 64),
                    "saturate": (2, 16, 20, 64, 64),
                    "negative": (2, 16, 20, 64, 32),
                    "b1": (1, 32, 32, 128, 128),
                    "ragged_18x22": (2, 18, 22, 64, 128),
                    "ragged_34x38": (2, 34, 38, 128, 256),
                    "cin256": (2, 24, 28, 256, 136)}
POOL_EDGE_CASES = tuple(POOL_CASE_SHAPES)


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


def _soft_scores(rng: np.random.Generator, b: int, n: int) -> np.ndarray:
    return rng.uniform(0.05, 1.0, (b, n)).astype(np.float32)


def _tie_triples() -> tuple:
    """Six boxes away from the others, for the linear rule: twice a
    winner W (score 1); a box A at IoU 0.6 with W whose score W's decay
    brings to exactly B's; a box B at IoU 1/3 with W (not decayed) and
    0.6 with A. So A and B tie after W's round, and the lower index of
    the two must win and decay the other; once with A first, once with
    B first."""
    w = np.float32([[0, 0, 4, 4], [0, 1, 4, 5], [0, 2, 4, 6]])
    iou = np.float32(12) / np.float32(20)  # (16 + 16) - 12 in both pairs
    tie = np.float32(0.8) * (np.float32(1) - iou)
    boxes = np.concatenate([w + np.float32([1000, 0, 1000, 0]),
                            (w + np.float32([1100, 0, 1100, 0]))[[0, 2, 1]]])
    scores = np.float32([1.0, 0.8, tie, 1.0, tie, 0.8])
    return boxes, scores


def soft_nms_case(case: str, rng: np.random.Generator, n: int = None):
    """(boxes (B, N, 4) f32, scores (B, N) f32, valid (B, N) bool) for one
    of SOFT_EDGE_CASES. `n` shrinks the cases whose size is not their
    point (identical, disjoint, ties, empty_image) for the CPU tests."""
    if case == "identical":
        # every round decays every other box: the gaussian scores fall
        # through the subnormals to 0, the linear ones to 0 at once, and
        # the later rounds pick among equal zeros
        n = n or 700
        return (np.tile(np.float32([10, 20, 60, 90]), (1, n, 1)),
                _soft_scores(rng, 1, n), np.ones((1, n), bool))
    if case == "disjoint":  # nothing decays: the output is the input
        n = n or 2000
        k = np.arange(n)
        x = (k % 50) * 10 + rng.uniform(0, 1, n)
        y = (k // 50) * 10 + rng.uniform(0, 1, n)
        boxes = np.stack([x, y, x + 8, y + 8], -1).astype(np.float32)
        return (boxes[None], _soft_scores(rng, 1, n),
                rng.uniform(0, 1, (1, n)) < 0.9)
    if case == "ties":
        # integer boxes on a small grid, scores in eighths: many exact
        # ties among the initial scores and among decayed ones
        n = n or 1500
        xy = rng.integers(0, 30, (n - 6, 2))
        wh = rng.integers(1, 7, (n - 6, 2))
        grid = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        tri_boxes, tri_scores = _tie_triples()
        scores = (rng.integers(1, 9, n - 6) / 8).astype(np.float32)
        return (np.concatenate([tri_boxes, grid])[None],
                np.concatenate([tri_scores, scores])[None],
                np.ones((1, n), bool))
    if case in ("n1", "n31", "n33", "n1000", "n4693"):
        n = int(case[1:])
        return (random_boxes(rng, 1, n), _soft_scores(rng, 1, n),
                rng.uniform(0, 1, (1, n)) < 0.95)
    if case == "empty_image":  # the middle image has no valid entry
        n = n or 500
        valid = np.ones((3, n), bool)
        valid[1] = False
        return random_boxes(rng, 3, n), _soft_scores(rng, 3, n), valid
    if case == "ragged_valid":
        counts = (5120, 3001, 64, 0, 1, 4999, 2048, 65)
        valid = np.zeros((len(counts), 5120), bool)
        for i, c in enumerate(counts):
            valid[i, rng.permutation(5120)[:c]] = True
        return (random_boxes(rng, len(counts), 5120),
                _soft_scores(rng, len(counts), 5120), valid)
    if case == "iou_at_thresh":
        # nms_sorted_case's grid: many pairs at IoU exactly 0.5, which
        # the linear rule (iou > 0.5) must not decay
        boxes, walk = nms_sorted_case("iou_at_thresh", rng)
        valid = np.arange(boxes.shape[1])[None, :] < walk[:, None]
        return boxes, _soft_scores(rng, *valid.shape), valid
    raise ValueError(f"unknown Soft-NMS edge case {case!r}")


def bf16_round(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def pool_case(case: str, rng: np.random.Generator):
    """(x (B, H, W, Cin) f32 of bf16 values, kq (3, 3, Cin, Cout) int8,
    a_scale, scale (Cout,) f32, bias (Cout,) f32) for one of
    POOL_EDGE_CASES."""
    if case not in POOL_CASE_SHAPES:
        raise ValueError(f"unknown pool edge case {case!r}")
    b, h, w, cin, cout = POOL_CASE_SHAPES[case]
    a_scale = 3.0 / 127.0
    if case == "ties":
        # every input, so every pooled value, is (k + 1/2) a_scale with a
        # power-of-two a_scale: x / a_scale is exactly k + 1/2, and
        # |k + 1/2| <= 127.5 has 8 significant bits, exact in bf16
        a_scale = 1.0 / 16.0
        x = (rng.integers(-128, 128, (b, h, w, cin)) + 0.5) * a_scale
    elif case == "saturate":
        x = rng.uniform(-400, 400, (b, h, w, cin)) * a_scale
    elif case == "negative":
        x = -rng.uniform(1e-3, 3, (b, h, w, cin))
    else:
        x = rng.uniform(-3, 3, (b, h, w, cin))
    kq = rng.integers(-127, 128, (3, 3, cin, cout)).astype(np.int8)
    scale = rng.uniform(1e-5, 1e-4, cout).astype(np.float32)
    bias = rng.normal(0, 0.1, cout).astype(np.float32)
    return bf16_round(x.astype(np.float32)), kq, a_scale, scale, bias
