"""Adversarial inputs for the port's kernels: the one source of the edge
cases that `tests/test_torch_cuda.py` (under pytest) and `chip_smoke.py`
(in the smoke run on the card) both hold K1, K2, K3 and K4 to their
plain versions on. Numpy only; the callers move the arrays to the card.
Likewise the card-against-CPU checks of one GLN train step
(`train_step_on_devices`, `train_step_differences`, `TRAIN_STEP_TOL`;
in bf16 compute `train_step_bf16_check`, `TRAIN_STEP_TOL_BF16`,
`master_weights_kept`)
and of one DIHE or GAN pretraining step (`dihe_step_on_devices`,
`gan_step_on_devices`, `dihe_step_differences`, `DIHE_STEP_TOL`).

Also seeded state_dicts in the reference checkpoints' layouts
(torchvision resnet50 and vgg16(_bn) `features`, the reference MACVGG's
block slices, the reference GaussianLayerNetwork), for the checkpoint
loaders: numpy draws in torch tensors, with the key sets, shapes and
draw order of the JAX package's tests' builders
(tests/test_model_parity.py, tests/test_checkpoint_import.py).
"""
from __future__ import annotations

import functools
import struct
from typing import Dict

import numpy as np
import torch

from .cli.common import MACVGG_BLOCK2_OFFSET

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


# ------------------------------------------- reference-layout checkpoints

RESNET50_STAGES = (3, 4, 6, 3)
RESNET50_WIDTHS = (64, 128, 256, 512)
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


def _rand_conv(rng: np.random.Generator, cout: int, cin: int,
               k: int) -> torch.Tensor:
    w = rng.normal(size=(cout, cin, k, k)) * (2.0 / np.sqrt(cin * k * k)) \
        * 0.5
    return torch.tensor(w.astype(np.float32))


def _rand_bn(rng: np.random.Generator, sd: Dict, prefix: str,
             c: int) -> None:
    """Non-trivial BatchNorm statistics: scale and var in [0.5, 1.5]."""
    sd[f"{prefix}.weight"] = torch.tensor(
        rng.uniform(0.5, 1.5, c).astype(np.float32))
    sd[f"{prefix}.bias"] = torch.tensor(
        rng.normal(0, 0.1, c).astype(np.float32))
    sd[f"{prefix}.running_mean"] = torch.tensor(
        rng.normal(0, 0.1, c).astype(np.float32))
    sd[f"{prefix}.running_var"] = torch.tensor(
        rng.uniform(0.5, 1.5, c).astype(np.float32))


def resnet50_state_dict(rng: np.random.Generator) -> Dict[str, torch.Tensor]:
    """torchvision resnet50 trunk names (`layer1.0.downsample.0.weight`,
    ...), no fc head."""
    sd = {"conv1.weight": _rand_conv(rng, 64, 3, 7)}
    _rand_bn(rng, sd, "bn1", 64)
    cin = 64
    for si, blocks in enumerate(RESNET50_STAGES):
        width = RESNET50_WIDTHS[si]
        for bi in range(blocks):
            p = f"layer{si + 1}.{bi}"
            sd[f"{p}.conv1.weight"] = _rand_conv(rng, width, cin, 1)
            _rand_bn(rng, sd, f"{p}.bn1", width)
            sd[f"{p}.conv2.weight"] = _rand_conv(rng, width, width, 3)
            _rand_bn(rng, sd, f"{p}.bn2", width)
            sd[f"{p}.conv3.weight"] = _rand_conv(rng, width * 4, width, 1)
            _rand_bn(rng, sd, f"{p}.bn3", width * 4)
            if bi == 0:
                sd[f"{p}.downsample.0.weight"] = _rand_conv(
                    rng, width * 4, cin, 1)
                _rand_bn(rng, sd, f"{p}.downsample.1", width * 4)
            cin = width * 4
    return sd


def vgg16_features_state_dict(rng: np.random.Generator,
                              batch_norm: bool = True
                              ) -> Dict[str, torch.Tensor]:
    """torchvision vgg16_bn (or, without `batch_norm`, vgg16) `features.*`
    convs and BatchNorms."""
    sd = {}
    idx = 0
    cin = 3
    for entry in VGG16_CFG:
        if entry == "M":
            idx += 1
            continue
        sd[f"features.{idx}.weight"] = _rand_conv(rng, entry, cin, 3)
        sd[f"features.{idx}.bias"] = torch.tensor(
            rng.normal(0, 0.05, entry).astype(np.float32))
        idx += 1
        if batch_norm:
            _rand_bn(rng, sd, f"features.{idx}", entry)
            idx += 1
        idx += 1  # relu
        cin = entry
    return sd


# the reference MACVGG cuts vgg.features after block 4's last ReLU and
# after block 5's: block1 = features[:cut], block2 = features[cut:end],
# each renumbered from 0
MACVGG_SLICES = {bn: (MACVGG_BLOCK2_OFFSET[bn], end)
                 for bn, end in ((True, 43), (False, 30))}


def macvgg_reference_state_dict(rng: np.random.Generator,
                                batch_norm: bool = True
                                ) -> Dict[str, torch.Tensor]:
    """A reference MACVGG checkpoint: `block1.{i}` / `block2.{i}` slices
    of seeded vgg16(_bn) features."""
    return macvgg_slices(vgg16_features_state_dict(rng, batch_norm),
                         batch_norm)


def macvgg_slices(features: Dict[str, torch.Tensor],
                  batch_norm: bool = True) -> Dict[str, torch.Tensor]:
    """vgg16(_bn) `features.*` -> the reference MACVGG's `block1.{i}` /
    `block2.{i}` slices of them."""
    cut, end = MACVGG_SLICES[batch_norm]
    sliced = {}
    for k, v in features.items():
        idx = int(k.split(".")[1])
        tail = k.split(".", 2)[2]
        if idx < cut:
            sliced[f"block1.{idx}.{tail}"] = v
        elif idx < end:
            sliced[f"block2.{idx - cut}.{tail}"] = v
    return sliced


def gln_reference_state_dict(rng: np.random.Generator
                             ) -> Dict[str, torch.Tensor]:
    """A reference GaussianLayerNetwork checkpoint: torchvision's RetinaNet
    layout (resnet50 body, FPN with P6/P7, classification and regression
    heads) plus `backbone.gaussian_layer` and `backbone.gaussian_subnet`."""
    sd = {f"backbone.body.{k}": v
          for k, v in resnet50_state_dict(rng).items()}

    def conv_wb(prefix, cout, cin, k):
        sd[f"{prefix}.weight"] = _rand_conv(rng, cout, cin, k)
        sd[f"{prefix}.bias"] = torch.tensor(
            rng.normal(0, 0.02, cout).astype(np.float32))

    for i, cin in enumerate((512, 1024, 2048)):
        conv_wb(f"backbone.fpn.inner_blocks.{i}", 256, cin, 1)
        conv_wb(f"backbone.fpn.layer_blocks.{i}", 256, 256, 3)
    conv_wb("backbone.fpn.extra_blocks.p6", 256, 256, 3)
    conv_wb("backbone.fpn.extra_blocks.p7", 256, 256, 3)
    conv_wb("backbone.gaussian_layer.lateral", 256, 256, 1)
    conv_wb("backbone.gaussian_layer.block1.conv", 128, 256, 3)
    _rand_bn(rng, sd, "backbone.gaussian_layer.block1.norm", 128)
    conv_wb("backbone.gaussian_layer.block2.conv", 64, 128, 3)
    _rand_bn(rng, sd, "backbone.gaussian_layer.block2.norm", 64)
    for i, (cin, cout, k) in enumerate(
            [(64, 32, 3), (32, 32, 3), (32, 16, 3), (16, 16, 1), (16, 1, 1)]):
        conv_wb(f"backbone.gaussian_subnet.blocks.{i}.conv", cout, cin, k)
    for head, final in (("classification_head", "cls_logits"),
                        ("regression_head", "bbox_reg")):
        for i in range(4):
            conv_wb(f"head.{head}.conv.{2 * i}", 256, 256, 3)
        conv_wb(f"head.{head}.{final}", 9 if final == "cls_logits" else 36,
                256, 3)
    return sd


# ------------------------------------------------------------ training

# one GLN train step on the card against the CPU, from the same weights
# and batch (train_step_differences' keys): the losses, each trained
# tensor (over its largest update), the Gaussian branch's running
# statistics, all relative
TRAIN_STEP_TOL = {"loss_rel": 1e-4, "param_rel_to_update": 5e-2,
                  "stat_rel": 1e-4}

def train_step_on_devices(model_cfg, train_cfg, state_dict: Dict, batch,
                          devices=("cpu", "cuda")) -> Dict:
    """One GLN train step from `state_dict` on each device, on the same
    collated batch (images, boxes, box_valid, image_sizes): {device:
    (metrics as floats, the state_dict after it, on the CPU)}. For the
    card-against-CPU checks of chip_smoke.py and tests/test_torch_cuda.py."""
    from .train import gln as gln_train

    step = gln_train.make_train_step(model_cfg, train_cfg,
                                     model_cfg.anchors()[0])
    out = {}
    for dev in devices:
        state = gln_train.init_train_state(model_cfg, train_cfg,
                                           state_dict=state_dict, device=dev)
        state, metrics = step(state, *batch)
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    {k: v.cpu() for k, v in state.model.state_dict().items()})
    return out


def train_step_differences(before: Dict, a, b,
                           trainable_layers: int = 4) -> Dict:
    """How far apart two devices' steps from the same `before` state_dict
    came out (`a`, `b` as train_step_on_devices gives them): the largest
    relative loss difference; over the trained tensors, the largest
    |a - b| over the larger of the tensor's largest |update| and 1e-6 x
    max(1, its largest magnitude) (the convolution biases in front of a
    BatchNorm have a zero gradient and move by rounding noise only); the
    largest |a - b| of the Gaussian branch's running statistics over
    max(1, their magnitude); and whether every frozen tensor (the stem
    and every FrozenBN buffer) kept its value on both devices. Also the
    name of the tensor furthest apart (`param_worst`)."""
    from .models.gln import GLN, GLNConfig
    from .train.gln import _freeze_mask

    (ma, sa), (mb, sb) = a, b
    mask = _freeze_mask(GLN(GLNConfig(canvas_h=64, canvas_w=64)),
                        trainable_layers)
    loss_rel, param_rel, stat_rel, frozen_kept = 0.0, 0.0, 0.0, True
    param_worst = None
    for key in ma:
        loss_rel = max(loss_rel, abs(ma[key] - mb[key])
                       / max(abs(mb[key]), 1e-30))
    for key, old in before.items():
        old = old.cpu()
        if key.endswith("num_batches_tracked"):
            continue
        err = (sa[key] - sb[key]).abs().max().item()
        if key.startswith("body.") and not mask.get(key, False):
            frozen_kept &= torch.equal(sa[key], old) and torch.equal(
                sb[key], old)
        elif key.endswith(("running_mean", "running_var")):
            stat_rel = max(stat_rel, err / max(1.0, sb[key].abs().max()
                                               .item()))
        else:
            floor = 1e-6 * max(1.0, old.abs().max().item())
            update = (sb[key] - old).abs().max().item()
            if err / max(update, floor) > param_rel:
                param_rel, param_worst = err / max(update, floor), key
    return {"loss_rel": loss_rel, "param_rel_to_update": param_rel,
            "param_worst": param_worst, "stat_rel": stat_rel,
            "frozen_kept": frozen_kept}


# one GLN train step in bf16 compute (f32 master weights) against a
# bf16 reference step from the same weights and batch (the JAX
# package's in the tests, the CPU's on the card), held by distances
# (train_step_bf16_check). Two correct bf16 steps are about as far
# apart as bf16 is from f32: a 1-ulp difference in one bf16 convolution
# compounds over the 50-odd layers, so at 64x64 the port's updates lie a
# median relative L2 of 0.16-0.17 from JAX's bf16 ones, and JAX's 0.19-
# 0.20 from its f32 ones (scripts/torch_bf16_parity.py), and single
# elements are no yardstick. So each
# distance is held to `factor` times the reference's own bf16-against-
# f32 distance on the same inputs, the repo's convention of twice a
# measured spread: the losses as the largest relative difference over
# the loss terms, each trained tensor's and each Gaussian running
# statistic's update as the L2 norm of its difference. Three floors are
# added to a tensor's bound. `floor_l2`: tensors whose exact update is
# below it (FPN's P6/P7 biases at 64x64, 1e-13) move by rounding alone.
# `pre_bn_floor_l2`, in place of it on the conv biases in front of the
# Gaussian BatchNorms: their exact gradient is 0, which the BatchNorm
# after them subtracts out, and in bf16 both packages move them by
# rounding noise of about 1e-5 in L2; the floor is ten times that.
# `update_rel` x the L2 norm of the reference's update, the f32 card-
# against-CPU tolerance (TRAIN_STEP_TOL's 5e-2): one bf16 spread is a
# poor yardstick for a tensor of a few dozen elements (a Gaussian subnet
# bias): over chip_smoke.py's train.parity inputs at 24 seeds, two CPU
# bf16 convolutions (oneDNN's and the f32 one of the rounded operands)
# put a tensor past twice the spread at 2 seeds without it, and none past
# 0.44 of its bound with it (scripts/torch_bf16_parity.py --seeds 24).
TRAIN_STEP_TOL_BF16 = {"factor": 2.0, "floor_l2": 1e-9,
                       "pre_bn_floor_l2": 1e-4, "update_rel": 5e-2}
# the biases of the convolutions in front of a BatchNorm
PRE_BN_BIASES = ("gaussian.block1_conv.bias", "gaussian.block2_conv.bias")


def _loss_distance(a: Dict, b: Dict) -> float:
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b)


@functools.lru_cache(maxsize=None)
def _gln_freeze_mask(trainable_layers: int) -> Dict[str, bool]:
    from .models.gln import GLN, GLNConfig
    from .train.gln import _freeze_mask

    return _freeze_mask(GLN(GLNConfig(canvas_h=64, canvas_w=64)),
                        trainable_layers)


def master_weights_kept(before: Dict, after: Dict,
                        trainable_layers: int = 4) -> Dict:
    """Of a bf16-compute train step from the `before` state_dict to
    `after`: 'frozen_kept', whether the stem and every FrozenBN buffer
    kept their values; 'master_f32', whether every float tensor of
    `after` is f32 and no trained one lies on the bf16 grid (as weights
    stored in bf16 would)."""
    mask = _gln_freeze_mask(trainable_layers)
    frozen_kept, master_f32 = True, True
    for key, old in before.items():
        g = after[key]
        if not g.is_floating_point():
            continue
        master_f32 &= g.dtype == torch.float32
        if key.startswith("body.") and not mask.get(key, False):
            frozen_kept &= torch.equal(g, old.cpu())
        elif mask.get(key, False) and bool((g != 0).any()):
            master_f32 &= bool((g != g.to(torch.bfloat16).float()).any())
    return {"frozen_kept": frozen_kept, "master_f32": master_f32}


def train_step_bf16_check(before: Dict, got, want, ref,
                          trainable_layers: int = 4,
                          tol: Dict = TRAIN_STEP_TOL_BF16) -> Dict:
    """Hold a bf16 step `got` to the bf16 step `want` beside `ref`, an
    f32 step of the same implementation as `want`, each (metrics as
    floats, state_dict after the step) from the `before` state_dict
    (train_step_on_devices' values): every distance of `got` from
    `want` within tol["factor"] x that of `want` from `ref`, plus the
    floors (TRAIN_STEP_TOL_BF16 says why). Returns 'loss_rel' and its
    'loss_bound'; 'worst' (tensor, distance / bound) over the held
    tensors (the trained ones and the Gaussian running statistics);
    'failures', a list of (name, distance, bound) beyond their bounds;
    'n_held', the number of tensors held; and `got`'s
    master_weights_kept."""
    (mg, sg), (mw, sw), (mr, sr) = got, want, ref
    kept = master_weights_kept(before, sg, trainable_layers)
    loss_rel = _loss_distance(mg, mw)
    loss_bound = tol["factor"] * _loss_distance(mw, mr)
    failures = [("losses", loss_rel, loss_bound)] \
        if loss_rel > loss_bound else []
    mask = _gln_freeze_mask(trainable_layers)
    worst, n_held = (None, 0.0), 0
    for key, old in before.items():
        if not old.is_floating_point() or (key.startswith("body.")
                                           and not mask.get(key, False)):
            continue
        dg, dw, dr = ((x[key].double() - old.cpu().double())
                      for x in (sg, sw, sr))
        dist = (dg - dw).norm().item()
        floor = tol["pre_bn_floor_l2"] if key in PRE_BN_BIASES \
            else tol["floor_l2"]
        bound = (tol["factor"] * (dw - dr).norm().item() + floor
                 + tol["update_rel"] * dw.norm().item())
        n_held += 1
        if dist / bound > worst[1]:
            worst = (key, dist / bound)
        if dist > bound:
            failures.append((key, dist, bound))
    return {"loss_rel": loss_rel, "loss_bound": loss_bound,
            "worst": worst, "failures": failures, "n_held": n_held, **kept}


# one DIHE three-player step, or one GAN pretraining step, on the card
# against the CPU (dihe_step_differences' keys): the losses and the
# running statistics, relative; each player's gradient (Adam's first
# moment) as L2 over the player relative to the CPU's; the parameter
# updates where the two gradients resolve Adam's step, relative to the
# tensor's largest update. Adam's first step moves each element by about
# lr x sign(grad), and MACVGG's max pools and MAC maxima route their
# gradient to one of several near-equal positions, so f32 rounding alone
# flips single elements (tests/test_torch_train_dihe.py)
DIHE_STEP_TOL = {"loss_rel": 1e-3, "stat_rel": 1e-3, "moment_l2": 5e-2,
                 "update_rel_resolved": 1e-2}
# BatchNorm updates a step keeps (the JAX step's): the rest leave the
# running statistics alone
DIHE_STAT_UPDATES = {"embedder": 3, "generator": 3, "discriminator": 2}
GAN_STAT_UPDATES = {"generator": 2, "discriminator": 2}


def _player_record(state, players) -> Dict:
    """{player: (state_dict, first moments by parameter name)} on the
    CPU."""
    opts = {"embedder": "emb_opt", "generator": "gen_opt",
            "discriminator": "disc_opt"}
    out = {}
    for name in players:
        module = getattr(state, name)
        opt = getattr(state, opts[name])
        out[name] = ({k: v.detach().cpu() for k, v in
                      module.state_dict().items()},
                     {n: opt.state[p]["exp_avg"].cpu()
                      for n, p in module.named_parameters()})
    return out


def dihe_step_on_devices(cfg, state_dicts: Dict, batch,
                         devices=("cpu", "cuda")) -> Dict:
    """One DIHE train step from `state_dicts` ({"embedder", "generator",
    "discriminator"}) on each device, on the same batch (positives,
    negatives, gen_batch, disc_batch, similarity): {device: (metrics as
    floats, {player: (state_dict, first moments)} on the CPU)}."""
    from .train import dihe

    step = dihe.make_dihe_train_step(cfg)
    out = {}
    for dev in devices:
        state = dihe.init_dihe_state(
            cfg, state_dicts=state_dicts,
            gen_channels=state_dicts["generator"]["down_0.weight"].shape[1],
            device=dev)
        state, metrics = step(state, *batch)
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    _player_record(state, DIHE_STAT_UPDATES))
    return out


def gan_step_on_devices(cfg, state_dicts: Dict, batch,
                        devices=("cpu", "cuda")) -> Dict:
    """One GAN pretraining step from `state_dicts` ({"generator",
    "discriminator"}) on each device, on the same (gen_batch,
    disc_batch), as dihe_step_on_devices returns it."""
    from .train import dihe

    init, step = dihe.make_gan_pretrain_step(cfg)
    out = {}
    for dev in devices:
        state = init(gen_channels=state_dicts["generator"][
            "down_0.weight"].shape[1], device=dev)
        state.generator.load_state_dict(state_dicts["generator"])
        state.discriminator.load_state_dict(state_dicts["discriminator"])
        state, metrics = step(state, *batch)
        out[dev] = ({k: float(v) for k, v in metrics.items()},
                    _player_record(state, GAN_STAT_UPDATES))
    return out


def _l2(a: Dict, b: Dict, keys) -> float:
    num = sum(float((a[k] - b[k]).double().pow(2).sum()) for k in keys)
    den = sum(float(b[k].double().pow(2).sum()) for k in keys)
    return (num / max(den, 1e-300)) ** 0.5


def dihe_step_differences(before: Dict, a, b, updates: Dict) -> Dict:
    """How far apart two devices' steps from the same `before` state_dicts
    came out (`a`, `b` as dihe_step_on_devices gives them; `b` the
    reference): the largest relative loss difference; the largest |a -
    b| of a running statistic over max(1, its magnitude); per player the
    L2 distance of the first moments relative to `b`'s (the worst player
    named); over the elements whose gradient the two resolve (|b's first
    moment| above twice the tensor's largest first-moment difference and
    above 100 x Adam's eps x 0.1), the largest |update a - update b|
    beyond one f32 ulp of the parameter, over the tensor's largest
    update; the share of elements not resolved, and the L2 distance of
    all updates (both reported only); and whether every BatchNorm
    counted `updates[player]` statistics updates on both."""
    (ma, pa), (mb, pb) = a, b
    out = {"loss_rel": max(abs(ma[k] - mb[k]) / max(abs(mb[k]), 1e-30)
                           for k in mb),
           "stat_rel": 0.0, "moment_l2": 0.0, "update_rel_resolved": 0.0,
           "update_l2": 0.0, "stat_updates_kept": True}
    unresolved = total = 0
    for name, (sd_b, mu_b) in pb.items():
        sd_a, mu_a = pa[name]
        old = {k: v.cpu() for k, v in before[name].items()}
        for key, v in sd_b.items():
            if key.endswith("num_batches_tracked"):
                out["stat_updates_kept"] &= (
                    int(sd_a[key]) == int(v) == updates[name])
            elif key.endswith(("running_mean", "running_var")):
                out["stat_rel"] = max(out["stat_rel"], (sd_a[key] - v).abs()
                                      .max().item() / max(
                                          1.0, v.abs().max().item()))
        moment = _l2(mu_a, mu_b, mu_b)
        if moment >= out["moment_l2"]:
            out["moment_l2"], out["moment_worst"] = moment, name
        upd_a = {k: sd_a[k] - old[k] for k in mu_b}
        upd_b = {k: sd_b[k] - old[k] for k in mu_b}
        out["update_l2"] = max(out["update_l2"], _l2(upd_a, upd_b, mu_b))
        for key, m in mu_b.items():
            err = (mu_a[key] - m).abs().max().item()
            resolved = m.abs() > max(2 * err, 1e-7)
            excess = ((upd_a[key] - upd_b[key]).abs()
                      - 1.2e-7 * old[key].abs() - 1e-8).clamp(min=0)
            scale = max(upd_b[key].abs().max().item(), 1e-30)
            worst = (excess[resolved].max().item() / scale
                     if resolved.any() else 0.0)
            if worst >= out["update_rel_resolved"]:
                out["update_rel_resolved"] = worst
                out["update_worst"] = f"{name}.{key}"
            unresolved += int((~resolved).sum())
            total += m.numel()
    out["unresolved_share"] = unresolved / max(total, 1)
    return out


# ------------------------------------------------------------ PNG files

# a row's filter type by default: row r takes r % 5, so every unfilter
# path of data/png.py runs on any image of 5 rows or more
PNG_FILTERS = ("none", "sub", "up", "average", "paeth")


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    import struct
    import zlib

    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def write_png(path, array: np.ndarray, filters=None, palette=None,
              trns: bytes = None, bit_depth: int = 8,
              compress_level: int = 6) -> None:
    """Write `array` as a non-interlaced PNG (a helper of the tests and
    the smoke run, not part of the data API). uint8 (H, W) or (H, W, C):
    C = 1 grey, 2 grey + alpha, 3 RGB, 4 RGBA; with `palette` ((N, 3)
    uint8) `array` holds palette indices (colour type 3). `bit_depth`
    below 8 packs grey or palette samples. `filters`: None (row r takes
    filter r % 5), one filter for every row, or one per row, each a
    number 0-4 or a name of PNG_FILTERS. `trns` is the tRNS chunk's
    body, as given; `compress_level` zlib's level."""
    import struct
    import zlib

    a = np.asarray(array, np.uint8)
    if a.ndim == 2:
        a = a[..., None]
    h, w, c = a.shape
    color_type = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[c]
    if bit_depth < 8:
        per = 8 // bit_depth
        pad = (-w) % per
        vals = np.pad(a[..., 0], ((0, 0), (0, pad))).reshape(h, -1, per)
        shifts = np.arange(8 - bit_depth, -1, -bit_depth)
        rows = (vals.astype(np.int64) << shifts).sum(-1).astype(np.uint8)
    else:
        rows = a.reshape(h, w * c)
    bpp = max(c * bit_depth // 8, 1)
    if filters is None:
        filters = [r % 5 for r in range(h)]
    elif isinstance(filters, (int, str)):
        filters = [filters] * h
    kinds = np.array([PNG_FILTERS.index(f) if isinstance(f, str) else int(f)
                      for f in filters])[:, None]
    # every row is filtered against the unfiltered row above it
    x = rows.astype(np.int16)
    up = np.concatenate([np.zeros_like(x[:1]), x[:-1]])
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    pred = np.select([kinds == 1, kinds == 2, kinds == 3, kinds == 4],
                     [left, up, (left + up) >> 1,
                      _paeth(left, up, upleft)], 0)
    out = np.concatenate([kinds.astype(np.uint8),
                          ((x - pred) & 0xFF).astype(np.uint8)], axis=1)
    chunks = [_png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth,
                                              color_type, 0, 0, 0))]
    if palette is not None:
        chunks.append(_png_chunk(b"PLTE", np.asarray(palette, np.uint8)
                                 .tobytes()))
    if trns is not None:
        chunks.append(_png_chunk(b"tRNS", trns))
    chunks += [_png_chunk(b"IDAT", zlib.compress(out.tobytes(),
                                                 compress_level)),
               _png_chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"".join(chunks))


# ----------------------------------------------------------- JPEG files

# (h, v) of the luma component a sampling name gives; chroma is 1 x 1
JPEG_SAMPLINGS = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
                  "4:4:0": (1, 2), "4:1:1": (4, 1)}
# JPEG Annex K.1's quantisation tables (natural order)
JPEG_LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
JPEG_CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
# JPEG Annex K.3's Huffman tables: (16 code counts, symbols), DC and AC
# of luma, then of chroma
_STD_AC_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_STD_AC_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
JPEG_HUFFMAN = (
    (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]), bytes(range(12))),
    (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d]), _STD_AC_LUMA),
    (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]), bytes(range(12))),
    (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]), _STD_AC_CHROMA))


def jpeg_quant_tables(quality: int, baseline: bool = True):
    """IJG's jpeg_set_quality scaling of the Annex K tables: (luma,
    chroma), each (8, 8); entries capped at 255 when `baseline`."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    out = []
    for base in (JPEG_LUMA_QUANT, JPEG_CHROMA_QUANT):
        t = np.clip((base * scale + 50) // 100, 1, 255 if baseline else 32767)
        out.append(t.reshape(8, 8).astype(np.int64))
    return out


def _huffman_lookup(counts: bytes, symbols: bytes):
    """(code, length) of each symbol 0-255 under a canonical table."""
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], len_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


def _dct_matrix() -> np.ndarray:
    x = np.arange(8)
    c = np.cos((2 * x[None, :] + 1) * x[:, None] * np.pi / 16) / 2
    c[0] /= np.sqrt(2)
    return c


def _magnitude(v: np.ndarray):
    """JPEG's size category of each value and its extra bits."""
    size = np.searchsorted(1 << np.arange(16), np.abs(v), side="right")
    extra = np.where(v < 0, v + (1 << size) - 1, v)
    return size.astype(np.int64), extra.astype(np.int64)


def _segment(marker: int, body: bytes) -> bytes:
    import struct

    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _optimal_huffman(freq: np.ndarray):
    """(16 code counts, symbols) of a Huffman table for the symbol
    counts `freq` (256), as libjpeg's jpeg_gen_optimal_table builds one:
    a reserved symbol of count 1 takes the all-ones code (which no table
    may use), lengths are cut to 16 bits by its adjust_bits, and the
    symbols are listed by their code length."""
    import heapq

    syms = [int(s) for s in np.nonzero(freq)[0]] + [256]
    size = dict.fromkeys(syms, 0)
    heap = [(int(freq[s]) if s < 256 else 1, s, [s]) for s in syms]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, t1, l1 = heapq.heappop(heap)
        f2, t2, l2 = heapq.heappop(heap)
        for s in l1 + l2:
            size[s] += 1
        heapq.heappush(heap, (f1 + f2, min(t1, t2), l1 + l2))
    bits = [0] * (max(max(size.values()), 16) + 1)
    for s in syms:
        bits[size[s]] += 1
    for i in range(len(bits) - 1, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1  # the reserved symbol's code
    order = sorted(syms[:-1], key=lambda s: (size[s], s))
    return bytes(bits[1:17]), bytes(order)


# jcparam.c's jpeg_simple_progression: (components, Ss, Se, Ah, Al) of
# each scan; the YCbCr script, and the one for every other colour space
_YCC_PROGRESSION = (
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
    ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
    ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
    ((0,), 1, 63, 1, 0))


def _progression(ncomp: int, colour: str):
    if colour == "ycbcr":
        return _YCC_PROGRESSION
    every = tuple(range(ncomp))
    lone = [(c,) for c in every]
    return ((every, 0, 0, 0, 1), *[(c, 1, 5, 0, 2) for c in lone],
            *[(c, 6, 63, 0, 2) for c in lone],
            *[(c, 1, 63, 2, 1) for c in lone], (every, 0, 0, 1, 0),
            *[(c, 1, 63, 1, 0) for c in lone])


def _scan_blocks(comps, factors, grids, reals):
    """(component, flat block index in its stored grid, MCU) of each
    block of a scan in stream order: a lone component's own blocks in
    raster order, else MCU by MCU with each component's h x v blocks."""
    if len(comps) == 1:
        c = comps[0]
        rbh, rbw = reals[c]
        r, q = np.divmod(np.arange(rbh * rbw), rbw)
        return (np.full(rbh * rbw, c), r * grids[c][1] + q,
                np.arange(rbh * rbw))
    h0, v0 = factors[comps[0]]
    my, mx = grids[comps[0]][0] // v0, grids[comps[0]][1] // h0
    per_mcu = sum(factors[c][0] * factors[c][1] for c in comps)
    order_c, order_b, pos, offset = [], [], [], 0
    for c in comps:
        h, v = factors[c]
        mi, by, mj, bx = np.meshgrid(np.arange(my), np.arange(v),
                                     np.arange(mx), np.arange(h),
                                     indexing="ij")
        order_c.append(np.full(mi.size, c))
        order_b.append(((mi * v + by) * (mx * h) + mj * h + bx).ravel())
        pos.append(((mi * mx + mj) * per_mcu + offset + by * h + bx).ravel())
        offset += h * v
    seq = np.argsort(np.concatenate(pos), kind="stable")
    return (np.concatenate(order_c)[seq], np.concatenate(order_b)[seq],
            np.arange(len(seq)) // per_mcu)


# event keys: block (in scan order) * _SLOTS + slot; slot 0 is the EOB
# run flushed before a block's first code and 1 its correction bits, a
# coefficient at zigzag k codes at 2 + 4k ... 2 + 4k + 3, and the run
# flushed at a block's end takes _END and _END + 1
_SLOTS, _END = 1024, 1000


def _events(key, sym, xval, xlen, tbl, key2=None):
    n = len(key)
    return dict(key=np.asarray(key, np.int64),
                key2=np.zeros(n, np.int64) if key2 is None
                else np.asarray(key2, np.int64),
                tbl=np.broadcast_to(np.asarray(tbl, np.int64), (n,)),
                sym=np.broadcast_to(np.asarray(sym, np.int64), (n,)),
                xval=np.asarray(xval, np.int64),
                xlen=np.broadcast_to(np.asarray(xlen, np.int64), (n,)))


def _dc_events(dc, comp, seg, table):
    """The DC differences of each component, predictors reset at each
    restart; `dc` after the point transform."""
    diff = np.empty(len(dc), np.int64)
    for c in np.unique(comp):
        sel = np.nonzero(comp == c)[0]
        prev = np.concatenate([[0], dc[sel][:-1]])
        s = seg[sel]
        prev[np.concatenate([[True], s[1:] != s[:-1]])] = 0
        diff[sel] = dc[sel] - prev
    size, extra = _magnitude(diff)
    return _events(np.arange(len(dc)) * _SLOTS + 2, size, extra, size,
                   table)


def _eob_runs(contrib, has_codes, seg, maxrun, table):
    """jcphuff.c's EOB runs: each block whose band ends in zeros (or
    in correction bits alone) adds one to the run, which is flushed
    before the next block that codes a coefficient, at a restart or the
    scan's end, and when it reaches `maxrun` (1 in a sequential scan:
    an EOB a block). Returns the run events and, for each block, the
    key of the run that holds it (-1 when none)."""
    n = len(contrib)
    seg_end = np.concatenate([seg[1:] != seg[:-1], [True]])
    # the flush points before block i's first code and after its end,
    # in time 2i and 2i + 1; a block's count joins the next flush
    group = (np.cumsum(has_codes)
             + np.concatenate([[0], np.cumsum(seg_end)[:-1]]))
    times = np.sort(np.concatenate([2 * np.nonzero(has_codes)[0],
                                    2 * np.nonzero(seg_end)[0] + 1]))
    blocks = np.nonzero(contrib)[0]
    run_key = np.full(n, -1, np.int64)
    if not len(blocks):
        return _events([], 0, [], 0, []), run_key
    g = group[blocks]
    idx = np.arange(len(blocks))
    first = np.concatenate([[True], g[1:] != g[:-1]])
    m = idx - np.maximum.accumulate(np.where(first, idx, 0))
    sub = m // maxrun
    t = times[g]
    flush_key = np.where(t % 2, (t // 2) * _SLOTS + _END, (t // 2) * _SLOTS)
    # a run that reaches maxrun goes at the end of its last block
    ends_full = np.zeros(len(blocks), bool)
    last_of = np.concatenate([(g[1:] != g[:-1]) | (sub[1:] != sub[:-1]),
                              [True]])
    ends_full[last_of] = (m[last_of] + 1) % maxrun == 0
    run_id = np.cumsum(np.concatenate([[True], (g[1:] != g[:-1])
                                       | (sub[1:] != sub[:-1])])) - 1
    at_full = np.zeros(run_id[-1] + 1, bool)
    at_full[run_id[last_of]] = ends_full[last_of]
    last_block = np.zeros(run_id[-1] + 1, np.int64)
    last_block[run_id[last_of]] = blocks[last_of]
    key = np.where(at_full, last_block * _SLOTS + _END,
                   np.zeros_like(last_block))
    key[~at_full] = flush_key[last_of][~at_full]
    run_key[blocks] = key[run_id]
    length = np.bincount(run_id)
    nbits = np.floor(np.log2(length)).astype(np.int64)
    return (_events(key, nbits << 4, length - (1 << nbits), nbits,
                    table[last_block]), run_key)


def _ac_first_events(band, ss, seg, maxrun, table):
    """An AC scan's first pass over band ss.. (values after the point
    transform): runs of zeros, ZRL for each 16, EOB runs."""
    n, length = band.shape
    nb, nk = np.nonzero(band)
    first = np.concatenate([[True], nb[1:] != nb[:-1]])
    prev_k = np.where(first, -1, np.concatenate([[0], nk[:-1]]))
    run = nk - prev_k - 1
    size, extra = _magnitude(band[nb, nk])
    base = nb * _SLOTS + 2 + 4 * (ss + nk)
    out = [_events(base + 3, ((run % 16) << 4) | size, extra, size,
                   table[nb])]
    for j in range(3):  # at most 3 runs of 16 zeros before a value
        w = np.nonzero(run // 16 > j)[0]
        out.append(_events(base[w] + j, 0xF0, np.zeros(len(w)), 0,
                           table[nb[w]]))
    has_codes = np.zeros(n, bool)
    has_codes[nb] = True
    last = np.full(n, -1)
    last[nb] = nk  # np.nonzero is row-major: the last write is the last k
    runs, _ = _eob_runs(last < length - 1, has_codes, seg, maxrun, table)
    return out + [runs]


def _ac_refine_events(band, ss, al, seg, table):
    """jcphuff.c's encode_mcu_AC_refine over band ss.. of the original
    coefficients: a newly nonzero coefficient (magnitude 1 after the
    point transform) codes its zero run and its sign; one already nonzero
    sends its next bit, buffered until the next code of its block
    (a ZRL, emitted only where a newly nonzero one follows, or a new
    coefficient) or, after the last new one, until its EOB run is
    flushed."""
    a = np.abs(band) >> al
    n, length = a.shape
    new = a == 1
    eob = np.where(new.any(1), length - 1 - np.argmax(new[:, ::-1], 1), -1)
    eb, ek = np.nonzero(a)
    big = len(eb)
    idx = np.arange(big)
    is_new = a[eb, ek] == 1
    coded = ek <= eob[eb]
    first = np.concatenate([[True], eb[1:] != eb[:-1]])
    start = np.maximum.accumulate(np.where(first, idx, 0))
    zeros_before = ek - (idx - start)
    last_new = np.maximum.accumulate(np.where(is_new, idx, -1))
    prev_new = np.concatenate([[-1], last_new[:-1]])
    since = prev_new >= start
    z = zeros_before - np.where(
        since, np.concatenate([[0], zeros_before])[prev_new + 1], 0)
    zrl_total = z // 16
    same = ~first & ~np.concatenate([[False], is_new[:-1]])
    zrl = np.where(coded, zrl_total - np.where(
        same, np.concatenate([[0], zrl_total[:-1]]), 0), 0)
    has_ev = coded & ((zrl > 0) | is_new)
    nxt = np.minimum.accumulate(np.where(has_ev, idx, big)[::-1])[::-1]
    nxt = np.concatenate([nxt[1:], [big]])
    base = eb * _SLOTS + 2 + 4 * (ss + ek)
    out = []
    w = np.nonzero(has_ev & (zrl > 0))[0]
    out.append(_events(base[w], 0xF0, np.zeros(len(w)), 0, table[eb[w]]))
    for j in range(1, 4):
        w = np.nonzero(has_ev & (zrl > j))[0]
        out.append(_events(base[w] + 2, 0xF0, np.zeros(len(w)), 0,
                           table[eb[w]], key2=np.full(len(w), j)))
    w = np.nonzero(is_new & coded)[0]
    sign = (band[eb[w], ek[w]] >= 0).astype(np.int64)
    out.append(_events(base[w] + np.where(zrl[w] > 0, 3, 0),
                       ((z[w] % 16) << 4) | 1, sign, 1, table[eb[w]]))
    corr = (a[eb, ek] & 1).astype(np.int64)
    w = np.nonzero(~is_new & coded)[0]
    out.append(_events(base[nxt[w]] + 1, -1, corr[w], 1, -1, key2=ek[w]))
    has_codes = eob >= 0
    runs, run_key = _eob_runs(eob < length - 1, has_codes, seg, 0x7FFF,
                              table)
    out.append(runs)
    w = np.nonzero(~is_new & ~coded)[0]
    out.append(_events(run_key[eb[w]] + 1, -1, corr[w], 1, -1,
                       key2=eb[w] * 64 + ek[w]))
    return out


def _pack_scan(events, seg, nseg, tables) -> bytes:
    """The scan's entropy-coded bytes: the events in key order, each
    code from `tables` ({slot: (code of each symbol, its length)}) and
    its extra bits; each restart segment padded with 1 bits to a byte,
    0xFF stuffed with 0x00, RSTn between segments."""
    ev = {k: np.concatenate([e[k] for e in events]) for k in events[0]}
    order = np.lexsort((ev["key2"], ev["key"]))
    ev = {k: v[order] for k, v in ev.items()}
    code = np.zeros(len(order), np.int64)
    clen = np.zeros(len(order), np.int64)
    for slot, (codes, lengths) in tables.items():
        w = ev["tbl"] == slot
        code[w], clen[w] = codes[ev["sym"][w]], lengths[ev["sym"][w]]
    vals = (code << ev["xlen"]) | ev["xval"]
    lens = clen + ev["xlen"]
    ev_seg = seg[ev["key"] // _SLOTS]
    seg_bits = np.bincount(ev_seg, weights=lens, minlength=nseg).astype(
        np.int64)
    pad = (-seg_bits) % 8
    at = np.searchsorted(ev_seg, np.arange(nseg), side="right")
    vals = np.insert(vals, at, (1 << pad) - 1)
    lens = np.insert(lens, at, pad)
    bit_ev = np.repeat(np.arange(len(vals)), lens)
    start = np.cumsum(lens) - lens
    shift = lens[bit_ev] - 1 - (np.arange(len(bit_ev)) - start[bit_ev])
    scan = np.packbits(((vals[bit_ev] >> shift) & 1).astype(np.uint8))
    bounds = np.cumsum((seg_bits + pad) // 8)[:-1]
    ff = np.nonzero(scan == 0xFF)[0] + 1
    rst = 0xD0 + np.arange(len(bounds)) % 8
    scan = np.insert(scan, np.concatenate([ff, bounds, bounds]),
                     np.concatenate([np.zeros(len(ff), np.int64),
                                     np.full(len(bounds), 0xFF),
                                     rst]).astype(np.uint8))
    return scan.tobytes()


# component ids, and whether an Adobe marker (with its transform) or a
# JFIF one is written, by colour space
_JPEG_IDS = {"grey": b"\x01", "ycbcr": b"\x01\x02\x03", "rgb": b"RGB",
             "cmyk": b"CMYK", "ycck": b"\x01\x02\x03\x04"}
_ADOBE_TRANSFORM = {"rgb": 0, "cmyk": 0, "ycck": 2}


def _ycc(rgb: np.ndarray):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
           0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    return [np.clip(np.round(p), 0, 255) for p in ycc]


def write_jpeg(path, array: np.ndarray, quality: int = 90,
               sampling: str = "4:2:0", restart_interval: int = 0,
               sof: int = 0xC0, colour: str = None,
               progressive: bool = False, scans=None):
    """Write `array` as a Huffman-coded JPEG (a helper of the tests and
    the smoke run, not part of the data API) and return the quantised
    coefficients it wrote: one (blocks down, blocks across, 8, 8) int16
    array a component, natural order, zero where no scan codes them.

    uint8 (H, W) or (H, W, 1) is grey, (H, W, 3) RGB, (H, W, 4) CMYK as
    libjpeg takes and gives it (Adobe's inverted form). `colour` is the
    file's colour space: for three channels "ycbcr" (the default, JFIF's
    equations, a JFIF marker) or "rgb" (no transform, an Adobe marker
    with transform 0); for four "cmyk" (the default, Adobe transform 0)
    or "ycck" (C, M, Y inverted to R, G, B and taken to YCbCr as
    jccolor.c's cmyk_ycck_convert does, K kept; Adobe transform 2).
    `sampling` is a name of JPEG_SAMPLINGS: the factors of the first
    component (and of K); the others are 1 x 1, grey ignores it. The
    tables are those of Annex K at IJG's `quality` scaling,
    `restart_interval` the MCUs between RST markers (0: none). `sof`
    0xC1 writes an extended sequential frame with 16-bit quantisation
    tables. `scans` splits the components of a sequential file over
    scans: None one interleaved scan, "components" one scan each, or a
    tuple of tuples of component indices; a scan of one component codes
    its own blocks only, not the MCU padding. `progressive` writes SOF2
    with jcparam.c's jpeg_simple_progression script (DC first at Al 1,
    AC bands at Al 2 and 1, refinement down to bit 0; 10 scans for
    YCbCr, 2 + 4 x components for the others), each scan with Huffman
    tables built from its own symbol counts (DHT before each scan; the
    Annex K tables lack the EOB-run symbols). Vectorised numpy with no
    Python loop over symbols or blocks."""
    import struct

    from .data.jpeg import CHANNELS, ZIGZAG

    a = np.asarray(array, np.uint8)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    height, width = a.shape[:2]
    ncomp = 1 if a.ndim == 2 else a.shape[2]
    colour = colour or {1: "grey", 3: "ycbcr", 4: "cmyk"}[ncomp]
    if CHANNELS[colour] != ncomp:
        raise ValueError(f"{colour} from {ncomp} channels")
    if progressive and (sof != 0xC0 or scans is not None):
        raise ValueError("a progressive file has its own scans and SOF2")
    hmax, vmax = (1, 1) if ncomp == 1 else JPEG_SAMPLINGS[sampling]
    factors = [(hmax, vmax) if c in (0, 3) else (1, 1)
               for c in range(ncomp)]
    tq = [0 if c in (0, 3) else 1 for c in range(ncomp)]
    luma_q, chroma_q = jpeg_quant_tables(quality, baseline=sof == 0xC0)
    mh, mw = 8 * vmax, 8 * hmax
    ph, pw = -(-height // mh) * mh, -(-width // mw) * mw
    pad = ((0, ph - height), (0, pw - width)) + ((0, 0),) * (a.ndim - 2)
    px = np.pad(a, pad, mode="edge").astype(np.float64)
    if colour == "grey":
        planes = [px]
    elif colour == "ycbcr":
        planes = _ycc(px)
    elif colour == "ycck":
        planes = _ycc(255 - px[..., :3]) + [px[..., 3]]
    else:
        planes = [px[..., c] for c in range(ncomp)]
    dct = _dct_matrix()
    coefs, grids, reals = [], [], []
    for c, (p, (h, v)) in enumerate(zip(planes, factors)):
        p = p.reshape(ph * v // vmax, vmax // v, pw * h // hmax,
                      hmax // h).mean((1, 3))
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        blocks = (p - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        f = dct @ blocks @ dct.T
        q = luma_q if tq[c] == 0 else chroma_q
        coefs.append(np.round(f / q).astype(np.int16))
        grids.append((bh, bw))
        dh, dw = -(-height * v // vmax), -(-width * h // hmax)
        reals.append((-(-dh // 8), -(-dw // 8)))

    if progressive:
        script = _progression(ncomp, colour)
    elif scans is None:
        script = ((tuple(range(ncomp)), 0, 63, 0, 0),)
    else:
        split = ([(c,) for c in range(ncomp)] if scans == "components"
                 else [tuple(s) for s in scans])
        if sorted(sum(split, ())) != list(range(ncomp)):
            raise ValueError(f"scans {scans!r} do not split the components")
        script = tuple((s, 0, 63, 0, 0) for s in split)
    flat = [c.reshape(-1, 64)[:, ZIGZAG].astype(np.int64) for c in coefs]
    dc_done = [np.zeros(len(f), bool) for f in flat]
    ac_done = [np.zeros(len(f), bool) for f in flat]
    tbl_of = np.array([min(c, 1) for c in range(ncomp)])
    std = {slot: _huffman_lookup(*JPEG_HUFFMAN[slot]) for slot in range(4)}

    out_scans = []
    for comps, ss, se, ah, al in script:
        comp, blk, mcu = _scan_blocks(comps, factors, grids, reals)
        zz = np.empty((len(blk), 64), np.int64)
        for c in comps:
            w = comp == c
            zz[w] = flat[c][blk[w]]
            (dc_done if ss == 0 else ac_done)[c][blk[w]] = True
            if not progressive:
                ac_done[c][blk[w]] = True
        seg = mcu // restart_interval if restart_interval else \
            np.zeros_like(mcu)
        nseg = int(seg[-1]) + 1
        # Huffman slots: 2t the DC table t, 2t + 1 the AC table t
        dc_tbl, ac_tbl = 2 * tbl_of[comp], 2 * tbl_of[comp] + 1
        if not progressive:
            events = [_dc_events(zz[:, 0], comp, seg, dc_tbl)]
            events += _ac_first_events(zz[:, 1:], 1, seg, 1, ac_tbl)
            out_scans.append((comps, ss, se, ah, al, b"",
                              _pack_scan(events, seg, nseg, std)))
            continue
        if ss == 0 and ah == 0:
            events = [_dc_events(zz[:, 0] >> al, comp, seg, dc_tbl)]
        elif ss == 0:
            events = [_events(np.arange(len(zz)) * _SLOTS + 2, -1,
                              (zz[:, 0] >> al) & 1, 1, -1)]
        elif ah == 0:
            band = zz[:, ss:se + 1]
            band = np.sign(band) * (np.abs(band) >> al)
            events = _ac_first_events(band, ss, seg, 0x7FFF, ac_tbl)
        else:
            events = _ac_refine_events(zz[:, ss:se + 1], ss, al, seg,
                                       ac_tbl)
        ev_tbl = np.concatenate([e["tbl"] for e in events])
        ev_sym = np.concatenate([e["sym"] for e in events])
        tables, dht = {}, b""
        for slot in np.unique(ev_tbl[ev_tbl >= 0]):
            counts, symbols = _optimal_huffman(np.bincount(
                ev_sym[ev_tbl == slot], minlength=256))
            tables[int(slot)] = _huffman_lookup(counts, symbols)
            dht += bytes([((slot % 2) << 4) | (slot // 2)]) + counts \
                + symbols
        out_scans.append((comps, ss, se, ah, al, dht,
                          _pack_scan(events, seg, nseg, tables)))

    for c in range(ncomp):
        coefs[c].reshape(-1, 64)[~dc_done[c], 0] = 0
        coefs[c].reshape(-1, 64)[~ac_done[c], 1:] = 0

    out = [b"\xff\xd8"]
    if colour in _ADOBE_TRANSFORM:
        out.append(_segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                            + bytes([_ADOBE_TRANSFORM[colour]])))
    else:
        out.append(_segment(
            0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"))
    sixteen = sof == 0xC1
    for i, q in enumerate([luma_q] if ncomp == 1 else [luma_q, chroma_q]):
        zq = q.reshape(64)[ZIGZAG]
        body = (bytes([0x10 | i]) + zq.astype(">u2").tobytes() if sixteen
                else bytes([i]) + zq.astype(np.uint8).tobytes())
        out.append(_segment(0xDB, body))
    frame = struct.pack(">BHHB", 8, height, width, ncomp)
    ids = _JPEG_IDS[colour]
    for c, (h, v) in enumerate(factors):
        frame += bytes([ids[c], (h << 4) | v, tq[c]])
    out.append(_segment(0xC2 if progressive else sof, frame))
    if not progressive:
        for i, (counts, symbols) in enumerate(
                JPEG_HUFFMAN[:2 if ncomp == 1 else 4]):
            index = ((i % 2) << 4) | (i // 2)
            out.append(_segment(0xC4, bytes([index]) + counts + symbols))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    for comps, ss, se, ah, al, dht, data in out_scans:
        if dht:
            out.append(_segment(0xC4, dht))
        head = bytes([len(comps)])
        for c in comps:
            t = int(tbl_of[c])
            head += bytes([ids[c], (t << 4) | t])
        out += [_segment(0xDA, head + bytes([ss, se, (ah << 4) | al])), data]
    out.append(b"\xff\xd9")
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return coefs


# tests/torch_fixtures/jpeg_features/ holds JPEG files that PIL and cv2
# wrote (progressive, CMYK, Adobe RGB; scripts/write_jpeg_fixtures.py)
# and tests/torch_fixtures/jpeg_digests.json the digests of the JAX
# package's two reads of each, so that the card's run, which has neither
# library, holds the port's readers to them.
JPEG_FIXTURE_DIR = "tests/torch_fixtures/jpeg_features"
JPEG_DIGESTS = "tests/torch_fixtures/jpeg_digests.json"


def pixel_digest(pixels: np.ndarray) -> str:
    """sha256 of an image read as the loaders give it (float in [0, 1],
    turned back into its uint8 samples) or of uint8 samples: the shape,
    then the bytes."""
    import hashlib

    a = np.asarray(pixels)
    if a.dtype != np.uint8:
        a = np.rint(a.astype(np.float64) * 255).astype(np.uint8)
    return hashlib.sha256(str(a.shape).encode()
                          + np.ascontiguousarray(a).tobytes()).hexdigest()


# ------------------------------------------------- Motion-JPEG AVI

def mjpeg_frame(jpeg_bytes: bytes, polarity: int = 0) -> bytes:
    """A baseline JPEG as a Motion-JPEG AVI stores a frame: its JFIF
    APP0 replaced by an AVI1 APP0 of field polarity `polarity` (0: one
    progressive frame, 1 or 2: interlaced fields) and its DHT segments
    dropped, so that the frame relies on the standard Huffman tables."""
    out, pos = [jpeg_bytes[:2]], 2
    while True:
        marker = jpeg_bytes[pos + 1]
        if marker == 0xDA:
            out.append(jpeg_bytes[pos:])
            return b"".join(out)
        (length,) = struct.unpack(">H", jpeg_bytes[pos + 2:pos + 4])
        segment = jpeg_bytes[pos:pos + 2 + length]
        if marker == 0xE0:
            segment = _segment(0xE0, b"AVI1" + bytes([polarity]) + bytes(9))
        if marker != 0xC4:
            out.append(segment)
        pos += 2 + length


def _riff(cid: bytes, body: bytes) -> bytes:
    return cid + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def write_avi(path, frames, width: int, height: int,
              fourcc: bytes = b"MJPG", avix_from: int = None,
              index: bool = True) -> None:
    """A RIFF AVI of one video stream whose `00dc` chunks hold `frames`
    (JPEG bytes, one a frame; b"" writes an empty chunk) at 25 frames a
    second, its strh handler and strf biCompression `fourcc`.
    `index` adds an idx1 of the first RIFF's chunks (offsets from the
    movi fourcc); `avix_from` puts the frames from that one on into an
    OpenDML `RIFF AVIX` extension of their own movi list."""
    frames = list(frames)
    first = frames if avix_from is None else frames[:avix_from]
    rest = [] if avix_from is None else frames[avix_from:]
    rate = 25
    avih = struct.pack("<10I4I", 1000000 // rate, 0, 0, 0x10 if index else 0,
                       len(frames), 0, 1, 0, width, height, 0, 0, 0, 0)
    strh = struct.pack("<4s4sIHHIIIIIIIIhhhh", b"vids", fourcc, 0, 0, 0, 0,
                       1, rate, 0, len(frames), 0, 0xFFFFFFFF, 0, 0, 0,
                       width, height)
    strf = struct.pack("<IiiHH4sIiiII", 40, width, height, 1, 24, fourcc,
                       width * height * 3, 0, 0, 0, 0)
    hdrl = _riff(b"LIST", b"hdrl" + _riff(b"avih", avih) + _riff(
        b"LIST", b"strl" + _riff(b"strh", strh) + _riff(b"strf", strf)))
    movi, entries = [b"movi"], []
    for data in first:
        entries.append(struct.pack("<4sIII", b"00dc", 0x10,
                                   sum(map(len, movi)), len(data)))
        movi.append(_riff(b"00dc", data))
    body = b"AVI " + hdrl + _riff(b"LIST", b"".join(movi))
    if index:
        body += _riff(b"idx1", b"".join(entries))
    out = _riff(b"RIFF", body)
    if rest:
        out += _riff(b"RIFF", b"AVIX" + _riff(b"LIST", b"movi" + b"".join(
            _riff(b"00dc", data) for data in rest)))
    with open(path, "wb") as f:
        f.write(out)


def smooth_frames(rng: np.random.Generator, n: int, height: int,
                  width: int) -> list:
    """n seeded (H, W, 3) uint8 RGB frames of slowly moving waves of 60
    to 160 pixel periods: smooth enough that two Motion-JPEG decoders
    with different IDCTs and chroma filters agree within some levels."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    k = 2 * np.pi / rng.uniform(60.0, 160.0, (3, 2))  # periods in pixels
    phase = rng.uniform(0, 2 * np.pi, (3,))
    out = []
    for f in range(n):
        chans = [120 + 90 * np.sin(k[c, 0] * yy + k[c, 1] * xx + phase[c]
                                   + 0.1 * f) for c in range(3)]
        out.append(np.clip(np.rint(np.stack(chans, -1)), 0, 255)
                   .astype(np.uint8))
    return out


def write_grozi_videos(root, videos: Dict[int, list],
                       interest: Dict[int, list],
                       rng: np.random.Generator) -> Dict[int, list]:
    """A GroZi-120 test layout under `root`: `video/Shelf_{v}.avi` for
    each v of `videos` (RGB frames, written as Motion-JPEG by the port's
    encoder, DHT dropped), and `inSitu/{p}/coordinates.txt` for every
    product p (tab-separated video, frame, x, y, w, h), one to three
    boxes of random products on each frame of `interest[v]`, frames past
    a video's end included; all 120 products, as GroZiTestSet reads
    them. Returns {v: frames encoded as JPEG}."""
    import os

    from .data.jpeg import encode_jpeg

    os.makedirs(os.path.join(root, "video"), exist_ok=True)
    encoded = {}
    for v, frames in videos.items():
        encoded[v] = [encode_jpeg(f) for f in frames]
        height, width = frames[0].shape[:2]
        write_avi(os.path.join(root, "video", f"Shelf_{v}.avi"),
                  [mjpeg_frame(e) for e in encoded[v]], width, height)
    products = 120
    rows: Dict[int, list] = {p: [] for p in range(1, products + 1)}
    for v, frames in interest.items():
        height, width = videos[v][0].shape[:2]
        for f in frames:
            for p in rng.choice(products, int(rng.integers(1, 4)),
                                replace=False) + 1:
                w = int(rng.integers(4, max(5, min(32, width // 2))))
                h = int(rng.integers(4, max(5, min(32, height // 2))))
                x = int(rng.integers(0, width - w))
                y = int(rng.integers(0, height - h))
                rows[int(p)].append(f"{v}\t{f}\t{x}\t{y}\t{w}\t{h}\n")
    for p, lines in rows.items():
        os.makedirs(os.path.join(root, "inSitu", str(p)), exist_ok=True)
        with open(os.path.join(root, "inSitu", str(p), "coordinates.txt"),
                  "w") as f:
            f.writelines(lines)
    return encoded


# ------------------------------------------------- orbax checkpoints

# tests/torch_fixtures/orbax_seeded/ is an orbax checkpoint of
# `orbax_fixture_tree()`, written by scripts/write_orbax_fixture.py with
# the JAX package's serving `_save`; tests/torch_fixtures/zstd_frames.bin
# holds zstd frames of `zstd_fixture_data` (index in zstd_frames.json).
# The tests and chip_smoke.py regenerate both from the seed and hold the
# port's reader to them bit for bit.
ORBAX_FIXTURE_SEED = 2020
ORBAX_FIXTURE_DIR = "tests/torch_fixtures/orbax_seeded"
ORBAX_DIGESTS = "tests/torch_fixtures/orbax_digests.json"
ZSTD_FRAMES = "tests/torch_fixtures/zstd_frames"


def orbax_fixture_tree(seed: int = ORBAX_FIXTURE_SEED) -> Dict:
    """A nested dict and list of numpy leaves: f32 (random, constant, and
    one of 160 KB quantised to sixteenths, so that its zstd frame has
    several blocks with matches), int32, a 0-d int32, bool and uint8
    noise (stored in raw blocks)."""
    rng = np.random.default_rng(seed)
    return {
        "params": {
            "conv": {"kernel": rng.standard_normal(
                         (3, 3, 16, 32)).astype(np.float32),
                     "bias": np.zeros(32, np.float32)},
            "dense": {"kernel": (np.round(rng.standard_normal(
                (320, 128)) * 16) / 16).astype(np.float32)},
        },
        "batch_stats": {"bn": {
            "mean": rng.standard_normal(32).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, 32).astype(np.float32)}},
        "counts": rng.integers(-1000, 1000, 4096).astype(np.int32),
        "step": np.array(1234, np.int32),
        "mask": rng.random(100) < 0.5,
        "noise": rng.integers(0, 256, 65536).astype(np.uint8),
        "layers": [rng.standard_normal((64, 64)).astype(np.float32),
                   {"table": np.repeat(np.arange(8, dtype=np.int32),
                                       512).reshape(64, 64)}],
    }


def zstd_fixture_data(kind: str, seed: int = ORBAX_FIXTURE_SEED) -> bytes:
    """Seeded inputs of the committed zstd frames: `text` (words, for
    Huffman literals and matches), `noise` (raw blocks), `run` (RLE
    blocks) and `f32q` (quantised floats over several blocks)."""
    rng = np.random.default_rng((seed, sum(kind.encode())))
    if kind == "text":
        words = np.array([b"shelf ", b"product ", b"facing ", b"gap ",
                          b"price ", b"label ", b"row "], object)
        return b"".join(words[rng.integers(0, len(words), 3000)])[:20000]
    if kind == "noise":
        return rng.integers(0, 256, 5000).astype(np.uint8).tobytes()
    if kind == "run":
        return bytes([0x5A]) * 100000
    if kind == "f32q":
        return (np.round(rng.standard_normal(65536) * 4) / 4).astype(
            np.float32).tobytes()
    raise ValueError(f"unknown zstd fixture {kind!r}")


def tree_leaves(tree, trail=()):
    """('/'-joined path, leaf) of every leaf of a nested dict / list /
    tuple tree."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, trail + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, trail + (str(i),))
    else:
        yield "/".join(trail), tree


def tree_digests(tree) -> Dict[str, Dict]:
    """{path: {sha256, shape, dtype}} of every array leaf of a nested
    tree (bfloat16 tensors by their raw bits)."""
    import hashlib

    out = {}
    for path, leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            dtype = str(leaf.dtype).replace("torch.", "")
            shape = list(leaf.shape)
            raw = leaf.contiguous().view(torch.int16).numpy().tobytes()
        else:
            arr = np.ascontiguousarray(np.asarray(leaf))
            dtype, shape, raw = str(arr.dtype), list(arr.shape), \
                arr.tobytes()
        out[path] = {"sha256": hashlib.sha256(raw).hexdigest(),
                     "shape": shape, "dtype": dtype}
    return out
