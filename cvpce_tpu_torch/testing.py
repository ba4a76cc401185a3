"""Adversarial inputs for the port's kernels: the one source of the edge
cases that `tests/test_torch_cuda.py` (under pytest) and `chip_smoke.py`
(in the smoke run on the card) both hold K1, K2, K3 and K4 to their
plain versions on. Numpy only; the callers move the arrays to the card.
Likewise the card-against-CPU checks of one GLN train step
(`train_step_on_devices`, `train_step_differences`, `TRAIN_STEP_TOL`)
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


def write_jpeg(path, array: np.ndarray, quality: int = 90,
               sampling: str = "4:2:0", restart_interval: int = 0,
               sof: int = 0xC0):
    """Write `array` as a Huffman-coded sequential JPEG (a helper of the
    tests and the smoke run, not part of the data API) and return the
    quantised coefficients it wrote: one (blocks down, blocks across, 8,
    8) int16 array a component, natural order.

    uint8 (H, W) or (H, W, 1) is grey, (H, W, 3) RGB, converted to YCbCr
    with JFIF's equations. `sampling` is a name of JPEG_SAMPLINGS (the
    luma factors; chroma is 1 x 1; grey ignores it), the tables those of
    Annex K at IJG's `quality` scaling, `restart_interval` the MCUs
    between RST markers (0: none). `sof` 0xC1 writes an extended
    sequential frame with 16-bit quantisation tables. Vectorised numpy
    with no Python loop over symbols or blocks: a 2448 x 3264 photo
    takes seconds."""
    import struct

    from .data.jpeg import ZIGZAG

    a = np.asarray(array, np.uint8)
    if a.ndim == 3 and a.shape[2] == 1:
        a = a[..., 0]
    height, width = a.shape[:2]
    grey = a.ndim == 2
    hmax, vmax = (1, 1) if grey else JPEG_SAMPLINGS[sampling]
    luma_q, chroma_q = jpeg_quant_tables(quality, baseline=sof == 0xC0)
    if grey:
        ph, pw = -(-height // 8) * 8, -(-width // 8) * 8
        planes = [np.pad(a, ((0, ph - height), (0, pw - width)),
                         mode="edge").astype(np.float64)]
        factors = [(1, 1)]
    else:
        mh, mw = 8 * vmax, 8 * hmax
        ph, pw = -(-height // mh) * mh, -(-width // mw) * mw
        rgb = np.pad(a, ((0, ph - height), (0, pw - width), (0, 0)),
                     mode="edge").astype(np.float64)
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        ycc = [0.299 * r + 0.587 * g + 0.114 * b,
               -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
               0.5 * r - 0.418688 * g - 0.081312 * b + 128]
        ycc = [np.clip(np.round(p), 0, 255) for p in ycc]
        planes = [ycc[0]] + [p.reshape(ph // vmax, vmax, pw // hmax,
                                       hmax).mean((1, 3)) for p in ycc[1:]]
        factors = [(hmax, vmax), (1, 1), (1, 1)]
    dct = _dct_matrix()
    coefs = []
    for i, p in enumerate(planes):
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        blocks = (p - 128).reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        f = dct @ blocks @ dct.T
        q = luma_q if i == 0 else chroma_q
        coefs.append(np.round(f / q).astype(np.int16))

    # blocks in the scan's order: MCU by MCU, each component's h x v
    # blocks in raster order (grey: one block an MCU)
    order_c, order_b, mcu_of = [], [], []
    if grey:
        n = coefs[0].shape[0] * coefs[0].shape[1]
        per_mcu, mcus = 1, n
        order_c.append(np.zeros(n, np.int64))
        order_b.append(np.arange(n))
        pos = [np.arange(n)]
    else:
        my, mx = ph // (8 * vmax), pw // (8 * hmax)
        mcus = my * mx
        per_mcu = sum(h * v for h, v in factors)
        pos, offset = [], 0
        for i, (h, v) in enumerate(factors):
            mi, by, mj, bx = np.meshgrid(np.arange(my), np.arange(v),
                                         np.arange(mx), np.arange(h),
                                         indexing="ij")
            rows, cols = mi * v + by, mj * h + bx
            order_c.append(np.full(rows.size, i))
            order_b.append((rows * (mx * h) + cols).ravel())
            pos.append(((mi * mx + mj) * per_mcu + offset + by * h
                        + bx).ravel())
            offset += h * v
    seq = np.argsort(np.concatenate(pos), kind="stable")
    comp = np.concatenate(order_c)[seq]
    flat = [c.reshape(-1, 64)[:, ZIGZAG].astype(np.int64) for c in coefs]
    zz = np.empty((len(seq), 64), np.int64)
    blk = np.concatenate(order_b)[seq]
    for i in range(len(flat)):
        zz[comp == i] = flat[i][blk[comp == i]]
    mcu = np.arange(len(seq)) // per_mcu
    seg = mcu // restart_interval if restart_interval else np.zeros_like(mcu)

    # DC differences, the predictors reset at each restart
    diff = np.empty(len(seq), np.int64)
    for i in range(len(flat)):
        sel = np.nonzero(comp == i)[0]
        dc, s = zz[sel, 0], seg[sel]
        prev = np.concatenate([[0], dc[:-1]])
        prev[np.concatenate([[True], s[1:] != s[:-1]])] = 0
        diff[sel] = dc - prev
    table = np.where(comp == 0, 0, 1)
    lookups = [_huffman_lookup(*t) for t in JPEG_HUFFMAN]
    dc_code = np.stack([lookups[0][0], lookups[2][0]])
    dc_len = np.stack([lookups[0][1], lookups[2][1]])
    ac_code = np.stack([lookups[1][0], lookups[3][0]])
    ac_len = np.stack([lookups[1][1], lookups[3][1]])

    # events: (block, slot) keys, a code + extra bits each
    keys, vals, lens = [], [], []
    size, extra = _magnitude(diff)
    keys.append(np.arange(len(seq)) * 256)
    vals.append((dc_code[table, size] << size) | extra)
    lens.append(dc_len[table, size] + size)
    nb, nk = np.nonzero(zz[:, 1:])
    nk = nk + 1
    first = np.concatenate([[True], nb[1:] != nb[:-1]])
    prev_k = np.where(first, 0, np.concatenate([[0], nk[:-1]]))
    run = nk - prev_k - 1
    zrl = run // 16
    size, extra = _magnitude(zz[nb, nk])
    sym = ((run % 16) << 4) | size
    t = table[nb]
    keys.append(nb * 256 + 3 * nk + 3)
    vals.append((ac_code[t, sym] << size) | extra)
    lens.append(ac_len[t, sym] + size)
    for j in range(3):  # at most 3 runs of 16 zeros before a value
        w = np.nonzero(zrl > j)[0]
        keys.append(nb[w] * 256 + 3 * nk[w] + j)
        vals.append(ac_code[t[w], 0xF0])
        lens.append(ac_len[t[w], 0xF0])
    last = np.zeros(len(seq), np.int64)
    last[nb] = nk  # np.nonzero is row-major: the last write is the last k
    eob = np.nonzero(last < 63)[0]
    keys.append(eob * 256 + 200)
    vals.append(ac_code[table[eob], 0])
    lens.append(ac_len[table[eob], 0])
    keys, vals, lens = (np.concatenate(x) for x in (keys, vals, lens))
    # each restart segment ends on a byte boundary, padded with 1 bits
    ev_seg = seg[keys // 256]
    nseg = int(seg[-1]) + 1
    seg_bits = np.bincount(ev_seg, weights=lens, minlength=nseg).astype(
        np.int64)
    pad = (-seg_bits) % 8
    ends = np.searchsorted(seg, np.arange(nseg), side="right") - 1
    keys = np.concatenate([keys, ends * 256 + 255])
    vals = np.concatenate([vals, (1 << pad) - 1])
    lens = np.concatenate([lens, pad])
    order = np.argsort(keys, kind="stable")
    vals, lens = vals[order], lens[order]
    ev = np.repeat(np.arange(len(vals)), lens)
    start = np.cumsum(lens) - lens
    shift = lens[ev] - 1 - (np.arange(len(ev)) - start[ev])
    scan = np.packbits(((vals[ev] >> shift) & 1).astype(np.uint8))
    # stuff a 0x00 after each 0xFF, then RSTn between the segments
    bounds = np.cumsum((seg_bits + pad) // 8)[:-1]
    ff = np.nonzero(scan == 0xFF)[0] + 1
    rst = 0xD0 + np.arange(len(bounds)) % 8
    scan = np.insert(scan, np.concatenate([ff, bounds, bounds]),
                     np.concatenate([np.zeros(len(ff), np.int64),
                                     np.full(len(bounds), 0xFF),
                                     rst]).astype(np.uint8))

    sixteen = sof != 0xC0
    out = [b"\xff\xd8",
           _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for i, q in enumerate([luma_q] if grey else [luma_q, chroma_q]):
        zq = q.reshape(64)[ZIGZAG]
        body = (bytes([0x10 | i]) + zq.astype(">u2").tobytes() if sixteen
                else bytes([i]) + zq.astype(np.uint8).tobytes())
        out.append(_segment(0xDB, body))
    frame = struct.pack(">BHHB", 8, height, width, len(planes))
    for i, (h, v) in enumerate(factors):
        frame += bytes([i + 1, (h << 4) | v, min(i, 1)])
    out.append(_segment(sof, frame))
    for i, (counts, symbols) in enumerate(JPEG_HUFFMAN[:2 if grey else 4]):
        index = ((i % 2) << 4) | (i // 2)
        out.append(_segment(0xC4, bytes([index]) + counts + symbols))
    if restart_interval:
        out.append(_segment(0xDD, struct.pack(">H", restart_interval)))
    scan_head = bytes([len(planes)])
    for i in range(len(planes)):
        scan_head += bytes([i + 1, 0x11 * min(i, 1)])
    out += [_segment(0xDA, scan_head + b"\x00\x3f\x00"), scan.tobytes(),
            b"\xff\xd9"]
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return coefs
