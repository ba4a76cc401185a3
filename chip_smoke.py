#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (cvpce_tpu_torch) on one GPU.

Builds the four CUDA kernels with nvcc and holds each against its plain
PyTorch version on the card: hard NMS (K1) and Soft-NMS (K3) on 8 x 5120
seeded boxes, K1 also on adversarial boxes (all identical, invalid boxes
past n_walk, N = 4693, ragged walks, IoUs exactly at the threshold), K3
bit for bit on its own (identical, disjoint, exact score ties, N in {1,
31, 33, 1000, 4693}, an image with no valid entry, ragged valid counts,
IoUs exactly at the threshold) with at most 2 kernels a call;
fused kNN (K2) at the serving shape and over Q in {1, 17, 32, 67}, A in
{4096, 4097, 8192}, k in {1, 5, 8}, on a gallery of exact ties, and a
misaligned query tensor it must refuse; and fused maxpool -> int8 conv
(K4) at the three VGG block-boundary sites of
scripts/profile_fused_pool.py (B=128), which is also the path K4
serves, with 1 kernel a call, beside torch._int_mm on the same im2col
product, and bit for bit on its own (pooled values at exact rounding
ties, saturation, all-negative inputs, B = 1, ragged pooled sizes, Cin
64 / 128 / 256; int32, f32 and bf16 out, with and without ReLU). Then
it serves at full width, on 4 synthetic planogram scenes of 832x1344:

- serve (f32): GLN (seeded random weights, head calibrated to the
  scenes' product density) -> hard-NMS kernel -> crops -> MACVGG ->
  fused-kNN kernel against an 8192-entry gallery -> compliance; then the
  same scenes with the plain kNN, whose compliance must match;
- serve.soft: the same detector and gallery with GLNConfig(nms_mode=
  'soft'), through the Soft-NMS kernel;
- serve.int8: the int8-static preset -- bf16 GLN with int8='static'
  (scales calibrated on the scenes) and its backbone folded, an int8_all
  static bf16 MACVGG on folded BN calibrated on a 4096-entry gallery,
  the index saved with its scales and loaded back -- then the same
  scenes, and the detector alone on a batch of 8 photos;
- eval, on the serve phase's f32 detector and 8192-entry gallery:
  eval.calibrate (calibrate_confidence on 8 PlanogramSceneDetectionSet
  scenes, saved and read back through the resolvers), eval.proposals
  (evaluate_gln at IoU 0.5:0.95, its metrics held against the matcher on
  the CPU), eval.detection (evaluate_detections on 4 PlanogramQuerySet
  scenes, held against the plain kNN), eval.dihe (eval_dihe, k = 1 and
  5, through the saved index) and eval.planograms (evaluate_planograms
  on the serve scenes under a 0.5 domain shift, with and without colour
  correction, the native graph matcher held against the Python one);
- kernels.knn_fused.wide: K2 past its resident query tile, at D in
  {1280, 1284, 1536, 2048, 3072, 3904} x Q in {1, 32, 67} x A in {4096,
  8192} x k in {1, 5, 8}, timed at Q = 32, D = 1536, k = 1, and refusing
  one D past knn_fused_max_dim();
- serve.macresnet: the serve phase's f32 detector with an f32 MACResNet
  (c3 + c4, 1536-d; seeded weights and BatchNorm statistics) indexing a
  4096-entry gallery, K2 at D = 1536; then the same scenes with the
  plain kNN, whose compliance must match;
- serve.macresnet.int8: the same MACResNet in bf16 with quant='static',
  calibrated on the gallery, the index saved with its 52 scales and
  loaded back;
- load.reference: seeded checkpoints in the reference's layouts (GLN,
  torchvision resnet50 and vgg16_bn, a reference MACVGG in block
  slices; nested, with `module.` prefixes) saved with torch.save and
  loaded through cli/common.py onto the card, every parameter and
  output held bit for bit against the same dict loaded directly;
- load.orbax: the port's reader of the JAX package's orbax checkpoints
  (utils/zstd.py, utils/ocdbt.py, utils/orbax_read.py): the committed
  fixture tests/torch_fixtures/orbax_seeded/ bit for bit against the
  seeded tree it was written from, and the committed zstd frames; the
  trained exports artifacts/gln_r5 and artifacts/dihe_r4, every leaf
  against tests/torch_fixtures/orbax_digests.json (orbax's restore),
  with the read seconds and the decode's MB/s; then the 4 serve scenes
  served by gln_r5 + dihe_r4 (the threshold from its
  serving_calibration.json) against an 8192-entry gallery embedded by
  dihe_r4, K1 and K2 launched and equal to their plain versions, scene
  0's detections within stated bounds of the port's CPU forward, the
  detection counts and compliance printed (synthetic scenes: no quality
  number); then (d) the port writes both exports again, as it read
  them, in the JAX package's orbax layout through export_gln_serving and
  export_dihe_serving (utils/orbax_write.py, the bridges' inverse),
  reads them back equal to the digests, and serves
  scene 0 from them with K1 and K2 launched, its detections and kNN
  labels bit for bit (c)'s, printing the write seconds and MB/s. Where
  the copy to the card lacks the exports, (b) to (d) print that they
  are absent;
- data.perspective: eval_dihe through the MACResNet index on
  perspective-warped query scenes (the warp is the port's numpy one);
- data.files: seeded sets written as PNG files (testing.write_png, row
  r with filter r % 5) in the datasets' own layouts under
  build/chip_smoke/data/, every file decoded back equal as uint8 by the
  port's decoder: 8 shelf photos of 2448x3264 and their SKU-110K CSV
  (a malformed row, a skip-listed name) through SKU110KDataset
  (canvases of 832x1344 made on the card) into evaluate_gln with the
  serve detector (K1), one train_proposal_generator epoch of 4 steps at
  batch 2 with GrainLoader and its eval (K1), the same epoch cut at its
  third batch and resumed through GrainLoader.iter_from with the
  uninterrupted run's losses (cuDNN deterministic) from an orbax
  train-state node equal to the state saved, and a
  CachedDetectionDataset whose batches equal the dataset's; a Grocery
  Products catalogue of 4096 products (the walk, and TrainingFiles.txt
  the same) through GroceryProductsDataset into a MACVGG Classifier
  (K2), and the 4 serve scenes with their CSV annotations and Tonioni
  planograms through PlanogramTestSet into evaluate_planograms (K1,
  K2), whose
  compliance and kept detections equal an in-memory pass over the same
  uint8 images and planograms; decode seconds per megapixel, read,
  evaluate and train seconds, launches and the card's name and power
  limit;
- data.jpeg: the 8 shelf photos again as JPEG files written by
  testing.write_jpeg (4:2:0 at quality 90: baseline, progressive,
  progressive with a restart interval of 4 MCUs, one scan a component,
  baseline with the restart interval; 4:2:2, 4:4:4, grey) in SKU-110K's
  layout, and the 4 scenes at 4:2:0 in GP-180's layout, under
  build/chip_smoke/data/jpeg/: each file's coefficients as the port's
  decoder reads them equal to those written, its pixels equal to
  data/jpeg.py:reconstruct_reference's, and 30 small edge files (1x1 to
  61x97 and 33x200, every sampling, restart intervals, SOF1) equal to
  decode_reference's; the committed PIL and cv2 files of
  tests/torch_fixtures/jpeg_features (progressive, CMYK, Adobe RGB, and
  five progressive files cut short, which libjpeg decodes with block
  smoothing) read equal to the digests of the JAX package's reads; a
  64-product
  Grocery Products catalogue of progressive, CMYK, YCCK, RGB and
  one-scan-a-component files read through GroceryProductsDataset and
  InternalTrainSet equal to reconstruct_reference through to_rgb and
  to_rgba; then SKU110KDataset(device="cuda") over the photos into
  evaluate_gln (K1) and PlanogramTestSet with data.files' catalogue into
  evaluate_planograms (K1, K2), each equal to the same pass over the
  decoded pixels in memory; decode seconds per megapixel of each kind
  and by feature (baseline, progressive, one scan a component), the
  encoder's seconds, launches;
- data.video: GroZi-120's test layout, two Motion-JPEG AVIs of 90
  frames at 640x480 written by the port's JPEG encoder and
  testing.write_avi, 19 annotated frames and one past a video's end:
  the first video demuxed and decoded by data/avi.py equal to the
  frames written, `datasets grozi extract-test-images` run in this
  process (its missing-frame line, index.txt in the JAX package's
  order, each file byte for byte the port's encode of its frame's
  decode), GroZiTestSet over the frames and each frame through the
  serve detector's ProposalGenerator.detect (K1 once a frame); demux +
  decode and encode seconds a frame, launches;
- cli: the command line (`cvpce_tpu_torch.cli.main(argv)` in this
  process) on data.files' photos, catalogue and scenes, each command's
  output and K1 / K2 launches held to the library calls with the same
  arguments; `gln train`'s run directory and its serving export
  (export_gln_serving) through `gln eval --weights <dir>`;
- cli.dihe: the `dihe` commands over the 4096-product catalogue
  (prebuild-index, --int8, eval from the folders, --index, --int8
  --index), pretrain-gan -> train --gan and hyperopt on a 32-product
  slice at batch 4, the train run's serving export (export_dihe_serving)
  through `dihe eval --weights <dir>`, and the host-only `datasets`
  commands, each held to the library; every drawing command fails on
  the missing matplotlib within a second, with no launch;
- train.parity: one GLN train step on the card and one on the CPU at
  256x384, batch 2 (tanh, simple Gaussians), from the same seeded
  reference-layout checkpoint loaded through cli/common.py and the same
  collated SyntheticShelfDataset batch: losses, updated parameters and
  the Gaussian branch's running statistics held within stated
  tolerances, the frozen stem and every FrozenBN buffer unchanged;
- train.gln: train_proposal_generator at 832x1344 (the best model's
  recipe), batch 2, 8 scenes, 2 epochs, rotating checkpoints every 2
  steps, an eval on 4 held-out scenes after each epoch with K1 launched
  in each; its files, finite losses, and epoch 1's scores differing from
  epoch 0's; seconds per step, per eval and the peak memory; its sample
  pictures skipped (the card's machine has no matplotlib), as
  train.gan's;
- train.parity.bf16: train.parity in bf16 compute on f32 master weights
  (`GLNConfig(compute_dtype='bfloat16')`), beside an f32 step on the
  CPU: every distance of the card's step from the CPU's within twice
  the CPU's own bf16-against-f32 distance
  (testing.TRAIN_STEP_TOL_BF16), every trained tensor f32;
- train.gln.bf16: train.gln in bf16 compute, K1 launched in each epoch
  eval, f32 tensors in `checkpoint` and `epoch_0`, epoch 1's scores
  differing from epoch 0's; its median step, step breakdown and peak
  memory printed beside train.gln's, with the card's name and power
  limit;
- train.resume: at 256x384, 2 epochs in one go against 1 epoch and a
  resume=True epoch: the node resumed from is an orbax directory in the
  JAX package's GLNTrainState layout whose leaves equal the saved state
  bit for bit (train/checkpoint.py; its write, read and load seconds
  and MB/s on a line of their own, `train.resume.node`), the iteration
  counter continues, the momentum comes back as saved, the resumed
  epoch's losses agree;
- train.dihe.parity: one DIHE three-player step and one GAN pretraining
  step on the card and on the CPU at 128x128 (gen_downs 7), batch 2,
  from the same seeded weights: losses, first moments, updates and
  running statistics within testing.DIHE_STEP_TOL, every BatchNorm's
  update count the JAX step's, and the generator sub-step on the card
  leaving the embedder's and discriminator's statistics bit for bit;
- train.gan: pretrain_gan at 256x256 (gen_downs 8, ngf = ndf = 64,
  batch 4), ArchetypeGallerySet / SceneCropSet items, 2 epochs of 4
  steps, a rotating checkpoint every 2 steps; seconds per step, peak
  memory;
- train.dihe: train_dihe at 256x256 (MACVGG with BatchNorm, gen_downs 8,
  batch 4) from train.gan's players, 2 epochs of 4 steps, an eval_dihe
  after each against a 4096-entry gallery with K2 launched in each;
  seconds per step and per sub-step (CUDA events), per eval, peak
  memory, the embedder's movement, BestKeeper's epoch files;
- train.dihe.resume: at 64x64, both loops for 2 epochs against 1 epoch
  and a resume=True epoch, cuDNN deterministic: the `gan_checkpoint`
  and `embedder_checkpoint` nodes are orbax directories in the JAX
  package's layouts whose leaves equal the saved state (their seconds
  and MB/s on `train.dihe.resume.node` lines), the iteration counter
  continues, the Adam moments come back bit for bit, the resumed losses
  agree.

Prints one JSON line per phase with its elapsed seconds, then the
`{"kernels": [...]}` line, the card's name and power limit as nvidia-smi
prints them, and last `{"ok": true, "device": {...}}`. Any failed check
raises, so the script exits non-zero without that last line. Needs one
CUDA card; fails without one.

    python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import datetime
import functools
import gc
import hashlib
import io
import itertools
import json
import math
import shutil
import socket
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from cvpce_tpu_torch import _build, testing
from cvpce_tpu_torch.cli import main as cli_main
from cvpce_tpu_torch.cli.common import load_embedder, load_gln_state_dict
from cvpce_tpu_torch.cli.dihe import load_gan_state
from cvpce_tpu_torch.data import avi, defaults, grozi, jpeg, png, synthetic
from cvpce_tpu_torch.data import transforms as T
from cvpce_tpu_torch.data.cache import CachedDetectionDataset
from cvpce_tpu_torch.data.grain_loader import GrainLoader
from cvpce_tpu_torch.data.loader import PrefetchLoader
from cvpce_tpu_torch.data.coco import CocoDetectionDataset
from cvpce_tpu_torch.data.grocery import (GroceryProductsDataset,
                                          GroceryProductsTestSet,
                                          InternalTrainSet, SimpleFolderSet)
from cvpce_tpu_torch.data.planograms import (PlanogramTestSet,
                                             read_tonioni_planogram)
from cvpce_tpu_torch.data.sku110k import (SKU110KDataset, TargetDomainDataset,
                                          collate_detection)
from cvpce_tpu_torch.eval import (eval_dihe, evaluate_detections,
                                  evaluate_gln, evaluate_planograms,
                                  mean_average_metrics)
from cvpce_tpu_torch.eval.coco_protocol import (ImageDetections,
                                                evaluate_coco_protocol)
from cvpce_tpu_torch.eval.proposals import (DetectionEvalAdapter,
                                            make_variables_inference_fn)
from cvpce_tpu_torch.models.embedders import (EmbedFn, MACResNet, MACVGG,
                                              fold_bn_state_dict,
                                              fold_bn_variables)
from cvpce_tpu_torch.models.gln import (GLN, GLNConfig, fold_gln_backbone,
                                        postprocess_detections)
from cvpce_tpu_torch.ops import conv_fused
from cvpce_tpu_torch.ops import knn as knn_ops
from cvpce_tpu_torch.ops import nms as nms_ops
from cvpce_tpu_torch.ops.knn_sharded import (gallery_sharding,
                                              make_sharded_nn, pad_gallery)
from cvpce_tpu_torch.ops.matching import match_anchors
from cvpce_tpu_torch.parallel import (data_parallel_mesh, make_dp_train_step,
                                      make_spatial_forward,
                                      make_spatial_infer, put_replicated,
                                      put_sharded, spatial_mesh)
from cvpce_tpu_torch.parallel.multihost import initialize_multihost
from cvpce_tpu_torch.parallel.spatial import strip_width
from cvpce_tpu_torch.ops.metrics import calculate_metrics
from cvpce_tpu_torch.pipeline import native
from cvpce_tpu_torch.pipeline.calibrate import (calibrate_confidence,
                                                calibration_dir_for_weights,
                                                load_calibration,
                                                resolve_input_norm,
                                                resolve_threshold,
                                                save_calibration)
from cvpce_tpu_torch.pipeline.classifier import Classifier
from cvpce_tpu_torch.pipeline.evaluator import (PlanogramComparator,
                                                PlanogramEvaluator)
from cvpce_tpu_torch.pipeline.planograms import Graph
from cvpce_tpu_torch.pipeline.proposals import ProposalGenerator
from cvpce_tpu_torch.pipeline.serving import (export_dihe_serving,
                                              export_gln_serving,
                                              load_gln_variables,
                                              load_serving_meta)
from cvpce_tpu_torch.train import dihe as dihe_train
from cvpce_tpu_torch.train import gln as gln_train
from cvpce_tpu_torch.train.checkpoint import CheckpointManager, load_node
from cvpce_tpu_torch.train import loops as train_loops
from cvpce_tpu_torch.train.loops import train_proposal_generator
from cvpce_tpu_torch.utils import (ocdbt, orbax_read, orbax_write,
                                   profiling, viz, zstd)
from cvpce_tpu_torch.utils.torch_import import (import_gln, import_resnet50,
                                                import_vgg16_features)
from cvpce_tpu_torch.utils.weights import macvgg_state_dict

# H100 SXM peaks from NVIDIA's data sheet: HBM bytes/s, f32 FLOP/s
# outside the tensor cores and dense int8 tensor-core OP/s, at the full
# 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_INT8_OPS = 1979e12
NMS_FLOPS_PER_IOU = 12  # 4 min/max, 4 sub, 2 clamp, mul, add-sub, div
# a Soft-NMS pair: the IoU, 4 for the decay (square, negate, divide,
# exp), the multiply, and the next round's argmax compare
SOFT_FLOPS_PER_PAIR = NMS_FLOPS_PER_IOU + 6
KNN_TOL = 1e-5
SOFT_TOL = 1e-6
GALLERY_SIZE = 8192
INT8_GALLERY_SIZE = 4096  # still >= 4096, so K2 serves it
MACRESNET_GALLERY_SIZE = 4096
MACRESNET_INT8_SCALES = 52  # 16 bottlenecks x 3 convs + 4 downsamples
# K2 past its resident query tile: the last resident D and the first
# streamed one, MACResNet's c3 + c4 (1536) and c1..c5 (3904), between
WIDE_DIMS = (1280, 1284, 1536, 2048, 3072, 3904)
WIDE_QUERIES = (1, 32, 67)
WIDE_GALLERIES = (4096, 8192)
N_STYLES = 16
N_SCENES = 4
DETECT_BATCH = 8  # bench.py's detector batch
EVAL_IMAGES = 8  # PlanogramSceneDetectionSet scenes calibrated and scored
EVAL_BATCH = 4
COCO_THRESHOLDS = tuple(float(t) for t in
                        np.round(np.arange(0.5, 1.0, 0.05), 2))
METRIC_KEYS = ("ap", "ar_300", "f", "p", "r", "c")
# scripts/profile_fused_pool.py: (site, H = W, Cin, Cout), B = 128
POOL_SITES = (("pool1_conv2_1", 256, 64, 128),
              ("pool2_conv3_1", 128, 128, 256),
              ("pool3_conv4_1", 64, 256, 512))
POOL_BATCH = 128
BUILD = Path(__file__).resolve().parent / "build" / "chip_smoke"
# training: the parity and resume phases' canvas, the full-width
# trainer's scenes (batch 2: 4 steps an epoch) and held-out scenes
TRAIN_SMALL_HW = (256, 384)
TRAIN_BATCH = 2
TRAIN_SCENES = 8
TRAIN_EVAL_SCENES = 4
# a resumed epoch's losses against the uninterrupted run's (relative,
# cuDNN deterministic): within this, or 4x a rerun's distance where the
# card's own spread is wider (atomics outside cuDNN)
RESUME_LOSS_TOL = 1e-5
# DIHE and GAN training: the card-against-CPU step's canvas (gen_downs 7),
# the CLI's batch, and the epoch evals' gallery (>= 4096, so K2 serves it)
DIHE_PARITY_HW = 128
DIHE_BATCH = 4
DIHE_GALLERY_SIZE = 4096


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bound_ms(nbytes: float, flops: float, peak_ops: float = PEAK_F32_FLOPS):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


class Timer:
    """Median device time of a callable, by CUDA events around each
    call. The 64 MB buffer is rewritten before every call so the 50 MB
    L2 cache starts cold, as it does for the serving path. A spin of
    SPIN_CYCLES (about 0.5 ms) on the card precedes the start event, so
    the host has queued the call's launches before the card reaches
    them: the time is the card's, not the host's launch overhead."""

    SPIN_CYCLES = 1_000_000

    def __init__(self):
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, iters: int = 20, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- kernels

def random_boxes(rng, batch: int, n: int):
    """Detection-like candidates on an 832x1344 canvas."""
    cx = rng.uniform(0, 1344, (batch, n))
    cy = rng.uniform(0, 832, (batch, n))
    w = rng.uniform(8, 120, (batch, n))
    h = rng.uniform(8, 160, (batch, n))
    boxes = np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    scores = rng.uniform(0.05, 1.0, (batch, n))
    valid = rng.uniform(0, 1, (batch, n)) < 0.95
    cuda = lambda a, t: torch.from_numpy(a.astype(t)).cuda()  # noqa: E731
    return (cuda(boxes, np.float32), cuda(scores, np.float32),
            torch.from_numpy(valid).cuda())


def nms_cost(keep_sorted, n_walk):
    """(bytes, flops) the sorted walk needs on these inputs: every live
    candidate i tests the n - 1 - i boxes after it."""
    b, n = keep_sorted.shape
    idx = torch.arange(n, device=keep_sorted.device)
    live = keep_sorted & (idx[None, :] < n_walk[:, None])
    tests = ((n - 1 - idx)[None, :] * live).sum().item()
    return b * n * (16 + 1) + b * 4, tests * NMS_FLOPS_PER_IOU


def check_nms(timer, boxes, scores, valid, label):
    t0 = time.perf_counter()
    keep_k = nms_ops.nms_mask_fused(boxes, scores, valid, 0.5)
    keep_p = nms_ops.nms_mask(boxes, scores, valid, 0.5)
    torch.cuda.synchronize()
    mismatches = int((keep_k != keep_p).sum())
    max_abs_err = float((keep_k.int() - keep_p.int()).abs().max())
    require(mismatches == 0, f"NMS kernel keep mask differs from plain "
                             f"({label}: {mismatches} entries)")
    boxes_s, _, n_walk, _ = nms_ops.sort_candidates(boxes, scores, valid)
    ks = nms_ops.nms_keep_sorted(boxes_s, n_walk, 0.5)
    ms = timer.ms(lambda: nms_ops.nms_keep_sorted(boxes_s, n_walk, 0.5))
    plain_ms = timer.ms(
        lambda: nms_ops.nms_keep_sorted_plain(boxes_s, n_walk, 0.5),
        iters=3, warmup=1)
    nbytes, flops = nms_cost(ks, n_walk)
    bms, by = bound_ms(nbytes, flops)
    row = {"name": "nms_hard", "shape": list(boxes.shape),
           "valid": int(valid.sum()), "kept": int(keep_k.sum()),
           "mismatches": mismatches, "max_abs_err": max_abs_err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": None, "seconds": time.perf_counter() - t0}
    emit({"phase": f"kernels.nms_hard.{label}", **row})
    return row


def knn_check(timer, gallery, inv_g, queries, k, label):
    """K2 as the Classifier calls it: the resident gallery with its
    inverse norms taken once (`inv_g`)."""
    t0 = time.perf_counter()
    d_k, i_k = knn_ops.nearest_neighbors_fused(gallery, queries, k, inv_g)
    d_p, i_p = knn_ops.knn_plain(gallery, queries, k)
    err, n_diff, tie_gap = knn_index_check(
        d_k, i_k, d_p, i_p, knn_ops.distance_matrix(queries, gallery), label)
    ms = timer.ms(lambda: knn_ops.nearest_neighbors_fused(
        gallery, queries, k, inv_g))
    # the same kernel with the gallery's norms taken anew in the call
    ms_norms_per_call = timer.ms(
        lambda: knn_ops.nearest_neighbors_fused(gallery, queries, k))
    plain_ms = timer.ms(lambda: knn_ops.knn_plain(gallery, queries, k))

    def library():
        qn = knn_ops.l2_normalize(queries)
        d = 1.0 - (qn @ gallery.T) * inv_g
        return torch.topk(d, k, dim=1, largest=False)

    library_ms = timer.ms(library)
    # reading the gallery once, by one torch reduction, under this timer
    read_ms = timer.ms(lambda: gallery.sum())
    (q, dim), a = queries.shape, gallery.shape[0]
    nbytes = (q + a) * dim * 4 + a * 4 + q * k * 12
    flops = 2 * q * a * dim + 3 * q * dim + 2 * q * a
    bms, by = bound_ms(nbytes, flops)
    row = {"name": "knn_fused", "shape": [q, a, dim], "k": k,
           "index_mismatches": n_diff, "tie_gap": tie_gap,
           "max_abs_err": err, "ms": ms,
           "ms_norms_per_call": ms_norms_per_call, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
           "gallery_read_ms": read_ms, "seconds": time.perf_counter() - t0}
    emit({"phase": f"kernels.knn_fused.{label}", **row})
    return row


def phase_nms_edges(rng):
    """K1 bit-equal to its plain version on the adversarial inputs of
    cvpce_tpu_torch.testing (which tests/test_torch_cuda.py holds it to
    as well), called through nms_keep_sorted directly."""
    t0 = time.perf_counter()
    rows = {}
    for label in testing.NMS_EDGE_CASES:
        boxes, walk = (torch.from_numpy(a).cuda()
                       for a in testing.nms_sorted_case(label, rng))
        got = nms_ops.nms_keep_sorted(boxes, walk, 0.5)
        want = nms_ops.nms_keep_sorted_plain(boxes, walk.long(), 0.5)
        torch.cuda.synchronize()
        mismatches = int((got != want).sum())
        require(mismatches == 0, f"NMS kernel differs from plain on "
                                 f"{label} ({mismatches} entries)")
        rows[label] = {"shape": list(boxes.shape), "kept": got.sum(1).tolist(),
                       "mismatches": mismatches}
        if label == "identical":
            require(got.sum().item() == 1 and bool(got[0, 0]),
                    "identical boxes: exactly the first one kept")
    emit({"phase": "kernels.nms_hard.edges", "cases": rows,
          "seconds": time.perf_counter() - t0})


def knn_index_check(d_k, i_k, d_p, i_p, dists, label):
    """(largest distance error, index mismatches, largest distance gap
    at a mismatch) of K2 against knn_plain; where indices differ, the two
    neighbours must tie within KNN_TOL."""
    err = float((d_k - d_p).abs().max())
    require(err <= KNN_TOL, f"kNN {label}: distance error {err} > {KNN_TOL}")
    diff = i_k != i_p
    tie_gap = float((dists.gather(1, i_k) - dists.gather(1, i_p))
                    .abs()[diff].max()) if diff.any() else 0.0
    require(tie_gap <= KNN_TOL, f"kNN {label}: index differs off a tie "
                                f"(distance gap {tie_gap})")
    return err, int(diff.sum()), tie_gap


def phase_knn_edges(gen):
    """K2 against knn_plain over the query counts, ragged galleries and
    k of cvpce_tpu_torch.testing (which tests/test_torch_cuda.py holds it
    to as well); exact ties on a duplicated gallery; a misaligned query
    slice refused, an aligned one served."""
    t0 = time.perf_counter()
    worst, mismatched, shapes = 0.0, 0, 0
    base = torch.randn((max(testing.KNN_GALLERIES), 1024), device="cuda",
                       generator=gen)
    for a in testing.KNN_GALLERIES:
        g = base[:a]
        inv_g = knn_ops.inverse_norms(g)
        for nq in testing.KNN_QUERIES:
            q = torch.randn((nq, 1024), device="cuda", generator=gen)
            dists = knn_ops.distance_matrix(q, g)
            for k in testing.KNN_KS:
                shapes += 1
                d_k, i_k = knn_ops.nearest_neighbors_fused(g, q, k, inv_g)
                d_p, i_p = knn_ops.knn_plain(g, q, k)
                err, n_diff, _ = knn_index_check(d_k, i_k, d_p, i_p, dists,
                                                 f"Q={nq} A={a} k={k}")
                worst, mismatched = max(worst, err), mismatched + n_diff
    rows = testing.KNN_DUP_ROWS
    dup = base[:rows].repeat(testing.KNN_DUP_COPIES, 1)
    q = torch.randn((32, 1024), device="cuda", generator=gen)
    dup_rows = {}
    for k in testing.KNN_KS:
        d_k, i_k = knn_ops.nearest_neighbors_fused(dup, q, k)
        d_p, i_p = knn_ops.knn_plain(dup, q, k)
        torch.cuda.synchronize()
        require(torch.equal(i_k, i_p), f"duplicated gallery, k={k}: "
                                       f"indices differ from plain")
        require(bool((i_k[:, 0] < rows).all()), "a tie went to a higher "
                                                "index")
        dup_rows[k] = float((d_k - d_p).abs().max())
    # rows of a (33, 1024) tensor from the second on start 4096 bytes in;
    # a flat slice one float in is misaligned and must be refused
    q33 = torch.randn((33, 1024), device="cuda", generator=gen)
    d_k, i_k = knn_ops.nearest_neighbors_fused(base, q33[1:], 1)
    d_p, i_p = knn_ops.knn_plain(base, q33[1:], 1)
    knn_index_check(d_k, i_k, d_p, i_p,
                    knn_ops.distance_matrix(q33[1:], base), "row slice")
    flat = q33.flatten()[1:1 + 32 * 1024].view(32, 1024)
    try:
        knn_ops.nearest_neighbors_fused(base, flat, 1)
        refused = False
    except ValueError:
        refused = True
    require(refused, "a query tensor 4 bytes off 16-byte alignment was "
                     "not refused")
    emit({"phase": "kernels.knn_fused.edges", "shapes": shapes,
          "max_abs_err": worst, "index_mismatches": mismatched,
          "duplicated_max_abs_err": dup_rows, "misaligned_refused": refused,
          "seconds": time.perf_counter() - t0})


def profile_kernels(fns):
    """[(name, device ms)] of the CUDA kernels the callables launch, from
    one torch.profiler session around a call of each (after a call of
    each outside it); None when the profiler sees no device activity.
    One session for all: in one process only the first sessions return
    device events."""
    from torch.profiler import ProfilerActivity, profile

    for fn in fns:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in fns:
            fn()
        torch.cuda.synchronize()
    kernels = [(e.name, e.time_range.elapsed_us() / 1e3)
               for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return kernels or None


def phase_kernel_launches(gallery, queries, inv_g, boxes, scores, valid):
    """Kernels per call of K2 (k = 1 and k up to 8: its two template
    widths) and K3, counted where the .cu files launch them, at most 2
    each; and the kernels the profiler sees in one call of each, with
    their device times (K3's two phases apart)."""
    knn = {k: (lambda k=k: knn_ops.nearest_neighbors_fused(
        gallery, queries, k, inv_g)) for k in (1, 5)}

    def soft():
        return nms_ops.soft_nms_scores_fused(boxes, scores, valid, 0.5, 0.5,
                                             "gaussian")

    counted = {}
    for k, fn in knn.items():
        before = knn_ops.kernels_launched()
        fn()
        counted[k] = knn_ops.kernels_launched() - before
        require(counted[k] <= 2, f"K2 launched {counted[k]} kernels in one "
                                 f"call")
    before = nms_ops.soft_nms_kernels_launched()
    soft()
    soft_counted = nms_ops.soft_nms_kernels_launched() - before
    require(soft_counted <= 2, f"K3 launched {soft_counted} kernels in one "
                               f"call")
    seen = profile_kernels([*knn.values(), soft])

    def picked(*parts):
        if seen is None:
            return None
        return [(name, ms) for name, ms in seen
                if all(p in name for p in parts)]

    row = {}
    for k in knn:
        ks = picked("knn_", "<1>" if k == 1 else "<8>")
        require(ks is None or len(ks) <= 2, f"the profiler saw {len(ks or [])} "
                                            f"kernels in one K2 call: {ks}")
        row[f"knn_fused.k{k}"] = {
            "kernels": counted[k], "profiler_kernels":
                None if ks is None else len(ks),
            "names": sorted({n for n, _ in ks or []})}
    ks = picked("soft_")
    require(ks is None or len(ks) <= 2, f"the profiler saw {len(ks or [])} "
                                        f"kernels in one K3 call: {ks}")
    row["soft_nms.8x5120.gaussian"] = {
        "kernels": soft_counted,
        "profiler_kernels": None if ks is None else len(ks),
        "device_ms": {n: ms for n, ms in ks or []}}
    emit({"phase": "kernels.launches_per_call", **row})


def soft_cost(valid):
    """(bytes, flops) Soft-NMS needs on these inputs: an image with v
    valid candidates runs v rounds, round r decaying the v - 1 - r
    unprocessed ones."""
    b, n = valid.shape
    v = valid.sum(1).double()
    pairs = float((v * (v - 1) / 2).sum())
    return b * n * (16 + 4 + 1 + 4), pairs * SOFT_FLOPS_PER_PAIR


def soft_against_plain(boxes, scores, valid, method, label):
    """K3 and its plain version on the same inputs, required bit-equal
    (same rounds, same IoU and decay expressions, no FMA contraction),
    with at most 2 kernels in the call by csrc/soft_nms.cu's own count.
    Returns (kernel scores, plain scores, kernels in the call)."""
    before = nms_ops.soft_nms_kernels_launched()
    got = nms_ops.soft_nms_scores_fused(boxes, scores, valid, 0.5, 0.5,
                                        method)
    kernels = nms_ops.soft_nms_kernels_launched() - before
    want = nms_ops.soft_nms_scores(boxes, scores, valid, 0.5, 0.5, method)
    torch.cuda.synchronize()
    require(kernels <= 2, f"K3 launched {kernels} kernels in one call "
                          f"({label}, {method})")
    err = float((got - want).abs().max()) if got.numel() else 0.0
    require(torch.equal(got, want), f"Soft-NMS kernel not bit-equal to "
                                    f"plain ({label}, {method}: max "
                                    f"difference {err})")
    return got, want, kernels


def check_soft(timer, boxes, scores, valid, method, label, time_it=True):
    """K3 against its plain version: bit-equal, the keep-set
    (> score_thresh) mismatches, the rounds of the fullest image; timed
    when `time_it`."""
    t0 = time.perf_counter()
    thresh = GLNConfig.score_thresh
    got, want, kernels = soft_against_plain(boxes, scores, valid, method,
                                            label)
    err = float((got - want).abs().max())
    keep_mismatches = int(((got > thresh) != (want > thresh)).sum())
    require(err <= SOFT_TOL, f"Soft-NMS kernel differs from plain by {err} "
                             f"({label}, {method})")
    require(keep_mismatches == 0, f"Soft-NMS keep sets differ ({label}, "
                                  f"{method}: {keep_mismatches})")
    rounds = int(valid.sum(1).max())
    row = {"name": "soft_nms", "method": method, "shape": list(boxes.shape),
           "valid": int(valid.sum()), "rounds": rounds,
           "kept": int((got > thresh).sum()), "bit_equal": True,
           "max_abs_err": err, "keep_mismatches": keep_mismatches,
           "kernels_per_call": kernels}
    if time_it:
        row["ms"] = timer.ms(lambda: nms_ops.soft_nms_scores_fused(
            boxes, scores, valid, 0.5, 0.5, method))
        row["us_per_round"] = row["ms"] * 1000 / rounds
        row["plain_ms"] = timer.ms(lambda: nms_ops.soft_nms_scores(
            boxes, scores, valid, 0.5, 0.5, method), iters=3, warmup=1)
        nbytes, flops = soft_cost(valid)
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, flops)
        row["library_ms"] = None  # no torch op computes Soft-NMS
    row["seconds"] = time.perf_counter() - t0
    emit({"phase": f"kernels.soft_nms.{label}.{method}", **row})
    return row


def phase_soft_edges(rng):
    """K3 bit-equal to its plain version, both methods, on the
    adversarial inputs of cvpce_tpu_torch.testing (which
    tests/test_torch_cuda.py holds it to as well)."""
    t0 = time.perf_counter()
    rows = {}
    for label in testing.SOFT_EDGE_CASES:
        boxes, scores, valid = (torch.from_numpy(a).cuda() for a in
                                testing.soft_nms_case(label, rng))
        for method in ("gaussian", "linear"):
            got, _, kernels = soft_against_plain(boxes, scores, valid,
                                                 method, label)
            rows[f"{label}.{method}"] = {
                "shape": list(boxes.shape), "valid": valid.sum(1).tolist(),
                "kept": (got > GLNConfig.score_thresh).sum(1).tolist(),
                "kernels_per_call": kernels}
    emit({"phase": "kernels.soft_nms.edges", "bit_equal": True,
          "cases": rows, "seconds": time.perf_counter() - t0})


def pool_site_inputs(rng, hw, cin, cout):
    """scripts/profile_fused_pool.py's inputs for one site: bf16
    activations in [0, 3), a random int8 kernel, per-channel dequant
    scales and biases, made on the card from a seeded generator."""
    gen = torch.Generator(device="cuda").manual_seed(
        int(rng.integers(1 << 31)))
    x = (torch.rand((POOL_BATCH, hw, hw, cin), device="cuda", generator=gen)
         * 3.0).to(torch.bfloat16)
    kq = torch.randint(-127, 128, (3, 3, cin, cout), device="cuda",
                       generator=gen, dtype=torch.int8)
    scale = 1e-4 + 9e-4 * torch.rand(cout, device="cuda", generator=gen)
    bias = torch.randn(cout, device="cuda", generator=gen)
    return x, kq, 3.0 / 127.0, scale, bias


def fused_pool_path(sites):
    """The port's twin of scripts/profile_fused_pool.py's fused run: each
    block-boundary site once through fused_pool_int8_conv, bf16 out with
    the ReLU fused."""
    return [conv_fused.fused_pool_int8_conv(*args, fuse_relu=True)
            for args in sites]


def pool_cost(x, cout):
    b, h, w, cin = x.shape
    p, q = h // 2, w // 2
    nbytes = (x.numel() * x.element_size() + 9 * cin * cout + 8 * cout
              + b * p * q * cout * 2)
    return nbytes, 2.0 * 9 * cin * cout * b * p * q


def pool_against_plain(args, out_dtype, fuse_relu, label):
    """K4 and its plain version on the same inputs, required equal (int32
    accumulators bit for bit; the f32 and bf16 epilogues round as the
    plain version does), with 1 kernel a call by csrc/pool_int8_conv.cu's
    own count. Returns the kernel's output."""
    before = conv_fused.kernels_launched()
    got = conv_fused.fused_pool_int8_conv(*args, fuse_relu, out_dtype)
    kernels = conv_fused.kernels_launched() - before
    want = conv_fused.pool_int8_conv_plain(*args, fuse_relu, out_dtype)
    torch.cuda.synchronize()
    require(kernels == 1, f"K4 launched {kernels} kernels in one call "
                          f"({label})")
    mismatches = int((got != want).sum())
    require(mismatches == 0, f"K4 differs from plain in {mismatches} "
                             f"outputs ({label}, {out_dtype}, relu "
                             f"{fuse_relu})")
    return got


def int_mm_ms(timer, args):
    """torch._int_mm alone on the site's im2col product (M = B * P * Q
    patch rows, K = 9 Cin, N = Cout): the library's int8 tensor-core time
    for the same multiply-accumulate."""
    x, kq, a_scale, _, _ = args
    a = conv_fused._scale_tensor(a_scale, x.device)
    pooled = torch.nn.functional.max_pool2d(
        x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
    rows = conv_fused.im2col_nhwc(conv_fused.quantize(pooled, a), 3, 3, 1,
                                  1).contiguous()
    del pooled
    cin, cout = kq.shape[2], kq.shape[3]
    mat = kq.reshape(9 * cin, cout).t().contiguous().t()
    ms = timer.ms(lambda: torch._int_mm(rows, mat), iters=10)
    del rows
    torch.cuda.empty_cache()
    return ms


def check_pool(timer, name, args, out):
    """K4 against its plain version at one site: int32 accumulators bit
    for bit and the bf16 output equal, 1 kernel a call; times the kernel,
    the plain version (= the library composition) and torch._int_mm on
    the same product, and the kernel's int8 operations a second."""
    t0 = time.perf_counter()
    x, kq, a_scale, scale, bias = args
    pool_against_plain(args, torch.int32, False, name)
    want = conv_fused.pool_int8_conv_plain(*args, fuse_relu=True).float()
    got = out.float()
    torch.cuda.synchronize()
    err = (got - want).abs()
    mismatches = int((got != want).sum())
    require(mismatches == 0, f"{name}: {mismatches} bf16 outputs differ "
                             f"from plain")
    row = {"name": "pool_int8_conv", "site": name, "shape": list(x.shape),
           "cout": kq.shape[3], "acc_mismatches": 0,
           "bf16_mismatches": mismatches, "kernels_per_call": 1,
           "max_abs_err": float(err.max())}
    del got, want, err
    row["ms"] = timer.ms(lambda: conv_fused.fused_pool_int8_conv(
        *args, fuse_relu=True), iters=10)
    row["plain_ms"] = timer.ms(lambda: conv_fused.pool_int8_conv_plain(
        *args, fuse_relu=True), iters=5, warmup=1)
    # no single torch call pools and convolves in int8: the yardstick is
    # the library composition max_pool2d + quantize + im2col +
    # torch._int_mm + dequant, which is the plain version itself, so its
    # one timing stands for both; int_mm_ms is its product alone
    row["library_ms"] = row["plain_ms"]
    row["library"] = "composition (= plain version)"
    row["int_mm_ms"] = int_mm_ms(timer, args)
    nbytes, ops = pool_cost(x, kq.shape[3])
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, ops, PEAK_INT8_OPS)
    row["tops"] = ops / (row["ms"] * 1e-3) / 1e12
    row["bound_fraction"] = row["bound_ms"] / row["ms"]
    row["seconds"] = time.perf_counter() - t0
    emit({"phase": f"kernels.pool_int8_conv.{name}", **row})
    return row


def phase_pool_edges(rng):
    """K4 equal to its plain version on the adversarial inputs of
    cvpce_tpu_torch.testing (which tests/test_torch_cuda.py holds it to as
    well): every output type, with and without the ReLU."""
    t0 = time.perf_counter()
    rows = {}
    for label in testing.POOL_EDGE_CASES:
        x, kq, a_scale, scale, bias = testing.pool_case(label, rng)
        args = (torch.from_numpy(x).cuda().to(torch.bfloat16),
                torch.from_numpy(kq).cuda(), a_scale,
                torch.from_numpy(scale).cuda(), torch.from_numpy(bias).cuda())
        for out_dtype, relu in ((torch.int32, False), (torch.float32, False),
                                (torch.float32, True),
                                (torch.bfloat16, False),
                                (torch.bfloat16, True)):
            pool_against_plain(args, out_dtype, relu, label)
        rows[label] = {"shape": list(x.shape), "cout": kq.shape[3],
                       "kernels_per_call": 1}
    emit({"phase": "kernels.pool_int8_conv.edges", "equal": True,
          "cases": rows, "seconds": time.perf_counter() - t0})


def phase_kernels(timer, rng):
    t0 = time.perf_counter()
    boxes, scores, valid = random_boxes(rng, 8, 5120)
    check_nms(timer, boxes, scores, valid, "8x5120")
    for method in ("gaussian", "linear"):
        check_soft(timer, boxes, scores, valid, method, "8x5120")
    gen = torch.Generator(device="cuda").manual_seed(
        int(rng.integers(1 << 31)))
    gallery = torch.randn((GALLERY_SIZE, 1024), device="cuda", generator=gen)
    queries = torch.randn((32, 1024), device="cuda", generator=gen)
    inv_g = knn_ops.inverse_norms(gallery)
    for k in (1, 5):
        knn_check(timer, gallery, inv_g, queries, k, f"k{k}")
    phase_kernel_launches(gallery, queries, inv_g, boxes, scores, valid)
    del gallery, queries, inv_g
    # the edge cases draw from their own seeds, so the later phases' inputs
    # stay those of earlier runs
    phase_nms_edges(np.random.default_rng(41))
    phase_soft_edges(np.random.default_rng(47))
    phase_knn_edges(torch.Generator(device="cuda").manual_seed(43))
    phase_pool_edges(np.random.default_rng(53))
    emit({"phase": "kernels", "seconds": time.perf_counter() - t0})


def phase_fused_pool(timer, rng):
    """K4 on its path: the three block-boundary sites at B = 128 driven
    once, with the launch count at 0 before and read after; then each
    site held against its plain version and timed."""
    t0 = time.perf_counter()
    sites = [pool_site_inputs(rng, hw, cin, cout)
             for _, hw, cin, cout in POOL_SITES]
    conv_fused.fused_pool_int8_conv.launches = 0
    kernels = conv_fused.kernels_launched()
    outs = fused_pool_path(sites)
    torch.cuda.synchronize()
    launches = conv_fused.fused_pool_int8_conv.launches
    kernels = conv_fused.kernels_launched() - kernels
    require(launches == len(POOL_SITES),
            f"K4 launched {launches} times on its path")
    require(kernels == len(POOL_SITES),
            f"K4's .so launched {kernels} kernels for {launches} calls")
    path_s = time.perf_counter() - t0
    rows = [check_pool(timer, name, args, out)
            for (name, *_), args, out in zip(POOL_SITES, sites, outs)]
    del sites, outs
    torch.cuda.empty_cache()
    emit({"phase": "fused_pool", "sites": len(rows), "launches": launches,
          "kernels": kernels, "path_seconds": path_s,
          "seconds": time.perf_counter() - t0})
    return rows, launches


# ------------------------------------------------------------------ serve

class GallerySet:
    """GALLERY_SIZE tanh-scale 256x256 views of the product archetypes,
    made on the card: view 0 of a style is its canonical render, the
    others carry a seeded gain and pixel noise."""

    def __init__(self, styles, size: int, seed: int):
        self.styles = styles
        self.size = size
        self.canon = [T.resize_for_classification(
            synthetic.product_gallery_image(s), device="cuda")
            for s in styles]
        self.gen = torch.Generator(device="cuda").manual_seed(seed)

    def __len__(self):
        return self.size

    def __getitem__(self, i):
        sid, view = i % len(self.styles), i // len(self.styles)
        img = self.canon[sid]
        if view:
            gain = 0.9 + 0.2 * torch.rand((), device="cuda",
                                          generator=self.gen)
            noise = 0.02 * torch.randn(img.shape, device="cuda",
                                       generator=self.gen)
            img = (img * gain + noise).clamp(0.0, 1.0)
        label = self.styles[sid]["label"]
        return T.scale_to_tanh(img), None, label, label


def calibrate_head(pg, images, target):
    """bench.py's calibration of a random head, on the port: widen the
    logit spread by scaling the cls_logits kernel, then bisect a shift
    of its bias until the detections per image above the serving
    confidence threshold match the scenes' product count. As with a
    trained detector (artifacts/gln_r5 serves at 0.48), most anchors
    then clear the 0.05 postprocess floor, so thousands of candidates
    enter NMS."""
    head = pg.model.head.cls_logits
    canvases, sizes = [], []
    for img in images:
        canvas, _, (ch, cw), _ = pg._canvas(img)
        canvases.append(canvas)
        sizes.append([ch, cw])
    canvases = torch.stack(canvases)
    sizes = torch.tensor(sizes, dtype=torch.float32, device="cuda")
    thresh = pg.confidence_threshold
    with torch.inference_mode():
        sigma = float(pg.model(canvases[:1])["cls_logits"].std())
        factor = float(np.clip(0.5 / max(sigma, 1e-6), 1.0, 1000.0))
        head.weight.mul_(factor)
        raw = pg.model(canvases[:1])["cls_logits"].flatten()
    base = head.bias.detach().clone()

    def count(shift):
        with torch.no_grad():
            head.bias.copy_(base + shift)
        res = pg.infer(canvases, sizes)
        return (res["valid"] & (res["scores"] > thresh)).sum(1).cpu().numpy()

    hi = float(np.log(thresh / (1 - thresh))
               - torch.quantile(raw, 0.999))
    n_hi = count(hi)
    tries = 0
    while n_hi.mean() < target and tries < 6:
        hi += 2.0
        n_hi = count(hi)
        tries += 1
    best = (abs(n_hi.mean() - target), hi, n_hi)
    lo = hi - 6.0
    n_lo = count(lo)
    tries = 0
    while n_lo.mean() > target and tries < 6:
        hi, lo = lo, lo - 4.0
        n_lo = count(lo)
        tries += 1
    if abs(n_lo.mean() - target) < best[0]:
        best = (abs(n_lo.mean() - target), lo, n_lo)
    for _ in range(12):
        mid = (lo + hi) / 2
        n_mid = count(mid)
        if abs(n_mid.mean() - target) < best[0]:
            best = (abs(n_mid.mean() - target), mid, n_mid)
        if n_mid.mean() > target:
            hi = mid
        else:
            lo = mid
        if best[0] < 0.15 * target:
            break
    _, shift, counts = best
    with torch.no_grad():
        head.bias.copy_(base + shift)
    return {"kernel_scale": factor, "bias_shift": shift,
            "dets_per_image": counts.tolist()}


def phase_serve(timer, seed):
    t0 = time.perf_counter()
    config = GLNConfig()
    gen = torch.Generator().manual_seed(seed)
    state = GLN(config, generator=gen).state_dict()
    pg = ProposalGenerator(state, config, confidence_threshold=0.5,
                           input_norm="raw01", device="cuda")
    styles = synthetic.product_styles(N_STYLES, seed=seed)
    scenes = []
    for i in range(N_SCENES):
        rng = np.random.default_rng((seed, 31, i))
        scenes.append(synthetic.planogram_scene(
            config.canvas_h, config.canvas_w, styles, rng,
            violation_rate=0.0 if i % 2 == 0 else 0.3))
    gt_mean = float(np.mean([len(s[2]["boxes"]) for s in scenes]))
    cal = calibrate_head(pg, [s[0] for s in scenes], gt_mean)
    emit({"phase": "serve.calibrate", "gt_per_image": gt_mean, **cal,
          "seconds": time.perf_counter() - t0})

    t1 = time.perf_counter()
    vgg = MACVGG(batch_norm=True, generator=gen).cuda()
    encoder = EmbedFn(fold_bn_variables(vgg), device="cuda")
    clf = Classifier(encoder, encoder.embedding_size,
                     sample_set=GallerySet(styles, GALLERY_SIZE, seed),
                     k=1, device="cuda")
    torch.cuda.synchronize()
    require(clf._use_fused, "gallery too small for the fused kNN path")
    require(np.isfinite(clf.embedding).all(), "non-finite gallery")
    emit({"phase": "serve.gallery", "entries": len(clf.embedding),
          "seconds": time.perf_counter() - t1})

    evaluator = PlanogramEvaluator(pg, clf, PlanogramComparator(device="cuda"))
    nms_ops.nms_keep_sorted.launches = 0
    knn_ops.nearest_neighbors_fused.launches = 0
    per_scene = serve_scenes(evaluator, scenes)
    launches = {"nms_hard": nms_ops.nms_keep_sorted.launches,
                "knn_fused": knn_ops.nearest_neighbors_fused.launches}
    serve_s = sum(r["seconds"] for r in per_scene)

    # what the serve path produced, scene by scene, held against plain
    nms_rows = []
    for i, (img, *_rest) in enumerate(scenes):
        res, n_det, crops, keep_mismatches, knn_mismatches = \
            scene_kernel_checks(pg, clf, img, f"scene {i}")
        per_scene[i].update(candidates=int(res["num_candidates"][0]),
                            detections=n_det, crops=int(crops.shape[0]),
                            keep_mismatches=keep_mismatches,
                            knn_index_mismatches=knn_mismatches)
        if i == 0:
            nms_rows.append(res)
            require(n_det > 0, "no detections to embed")
            emb = encoder(crops[:32])
            knn_serve = knn_check(timer, clf._anchors_dev,
                                  clf._anchor_inv_norms, emb, 1, "serve")
    # the same scenes with the plain kNN in place of K2: the compliance
    # must not move
    clf._use_fused = False
    plain_rows = serve_scenes(evaluator, scenes)
    clf._use_fused = True
    for r, p in zip(per_scene, plain_rows):
        r["plain_knn_compliance"] = p["compliance"]
        require(r["compliance"] == p["compliance"],
                f"scene {r['scene']}: compliance {r['compliance']} with K2, "
                f"{p['compliance']} with the plain kNN")
    for r in per_scene:
        emit({"phase": "serve.scene", **r})
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the serve path")
    res0 = nms_rows[0]
    nms_serve = check_nms(timer, res0["cand_boxes"], res0["cand_scores"],
                          res0["cand_valid"], "serve")
    emit({"phase": "serve", "scenes": N_SCENES, "launches": launches,
          "serve_seconds": serve_s, "seconds": time.perf_counter() - t0})
    ctx = {"pg": pg, "clf": clf, "vgg": vgg, "styles": styles,
           "scenes": scenes, "compliance": [r["compliance"]
                                            for r in per_scene]}
    return launches, nms_serve, knn_serve, ctx


def scene_kernel_checks(pg, clf, img, label):
    """K1 and K2 against their plain versions on one scene as the serve
    path runs it: the kernel's NMS keep mask against nms_mask, and K2 on
    the crops of every detection above the threshold, 32 at a time as
    the Classifier searches, against knn_plain. Returns (the forward's
    result with its candidates, the detections, their crops, keep-mask
    mismatches, kNN index mismatches)."""
    canvas, _, (ch, cw), _ = pg._canvas(img)
    sizes = torch.tensor([[ch, cw]], dtype=torch.float32, device="cuda")
    res = pg.infer(canvas[None], sizes, return_candidates=True)
    keep_p = nms_ops.nms_mask(res["cand_boxes"], res["cand_scores"],
                              res["cand_valid"], pg.config.nms_thresh)
    keep_mismatches = int((keep_p != res["keep"]).sum())
    require(keep_mismatches == 0,
            f"{label}: NMS kernel keep mask differs from plain "
            f"({keep_mismatches} entries)")
    boxes = res["boxes"][res["valid"]]
    require(torch.isfinite(boxes).all(), "non-finite detections")
    n_det = int((res["valid"] & (res["scores"] > pg.confidence_threshold))
                .sum())
    crops = pg.crop_boxes(img, res["boxes"][0][:n_det].cpu().numpy())
    require(tuple(crops.shape[1:]) == (256, 256, 3), "crop shape")
    knn_mismatches = 0
    for s0 in range(0, n_det, clf.batch_size):
        emb = clf._embed(crops[s0:s0 + clf.batch_size])
        d_k, i_k = knn_ops.nearest_neighbors_fused(
            clf._anchors_dev, emb, 1, clf._anchor_inv_norms)
        d_p, i_p = knn_ops.knn_plain(clf._anchors_dev, emb, 1)
        knn_mismatches += knn_index_check(
            d_k, i_k, d_p, i_p,
            knn_ops.distance_matrix(emb, clf._anchors_dev),
            f"{label} crops")[1]
    return res, n_det, crops, keep_mismatches, knn_mismatches


def serve_scenes(evaluator, scenes):
    """Compliance and host seconds (ending in a synchronise) per scene."""
    rows = []
    for i, (img, plano, _actual, expected) in enumerate(scenes):
        ts = time.perf_counter()
        score, _, path = evaluator.evaluate_detailed(img, plano)
        torch.cuda.synchronize()
        require(0.0 <= score <= 1.0, f"compliance {score} outside [0, 1]")
        rows.append({"scene": i, "compliance": score, "path": path,
                     "expected": expected,
                     "seconds": time.perf_counter() - ts})
    return rows


def phase_serve_soft(timer, ctx):
    """The f32 detector and gallery of the serve phase with Soft-NMS in
    place of hard NMS; K3 held against its plain version on each scene's
    real candidates, for both methods."""
    t0 = time.perf_counter()
    pg0, clf = ctx["pg"], ctx["clf"]
    config = dataclasses.replace(pg0.config, nms_mode="soft")
    pg = ProposalGenerator(pg0.model.state_dict(), config,
                           confidence_threshold=pg0.confidence_threshold,
                           input_norm="raw01", device="cuda")
    evaluator = PlanogramEvaluator(pg, clf, PlanogramComparator(device="cuda"))
    nms_ops.nms_keep_sorted.launches = 0
    nms_ops.soft_nms_scores_fused.launches = 0
    knn_ops.nearest_neighbors_fused.launches = 0
    per_scene = serve_scenes(evaluator, ctx["scenes"])
    launches = {"soft_nms": nms_ops.soft_nms_scores_fused.launches,
                "knn_fused": knn_ops.nearest_neighbors_fused.launches,
                "nms_hard": nms_ops.nms_keep_sorted.launches}
    require(launches["soft_nms"] > 0, "soft_nms was not launched")
    require(launches["knn_fused"] > 0, "knn_fused was not launched")
    require(launches["nms_hard"] == 0, "hard NMS ran on the soft path")
    serve_s = sum(r["seconds"] for r in per_scene)
    rows = []
    for i, (img, *_rest) in enumerate(ctx["scenes"]):
        canvas, _, (ch, cw), _ = pg._canvas(img)
        sizes = torch.tensor([[ch, cw]], dtype=torch.float32, device="cuda")
        res = pg.infer(canvas[None], sizes, return_candidates=True)
        cand = (res["cand_boxes"], res["cand_scores"], res["cand_valid"])
        for method in ("gaussian", "linear"):
            rows.append(check_soft(timer, *cand, method, f"scene{i}",
                                   time_it=i == 0 and method == "gaussian"))
        n_det = int((res["valid"] & (res["scores"]
                                     > pg.confidence_threshold)).sum())
        per_scene[i].update(candidates=int(res["num_candidates"][0]),
                            survivors=int(res["keep"].sum()),
                            detections=n_det,
                            f32_hard_compliance=ctx["compliance"][i])
    for r in per_scene:
        emit({"phase": "serve.soft.scene", **r})
    serve_row = dict(rows[0])
    serve_row["max_abs_err"] = max(r["max_abs_err"] for r in rows)
    serve_row["keep_mismatches"] = sum(r["keep_mismatches"] for r in rows)
    emit({"phase": "serve.soft", "scenes": N_SCENES, "launches": launches,
          "serve_seconds": serve_s, "seconds": time.perf_counter() - t0})
    return launches, serve_row


def phase_serve_int8(ctx, seed):
    """The int8-static preset at 832x1344 and full width: bf16 GLN with
    int8='static' and its backbone folded, calibrated on the scenes; an
    int8_all static bf16 MACVGG on folded BN calibrated on the gallery;
    the index saved with its scales and loaded back; the 4 scenes."""
    t0 = time.perf_counter()
    scenes, pg0 = ctx["scenes"], ctx["pg"]
    config = dataclasses.replace(pg0.config, compute_dtype="bfloat16",
                                 int8="static", fold_backbone_fbn=True)
    pg = ProposalGenerator(fold_gln_backbone(pg0.model.state_dict()), config,
                           confidence_threshold=pg0.confidence_threshold,
                           input_norm="raw01", device="cuda")
    gln_scales = pg.calibrate([s[0] for s in scenes])
    n_scales = sum(1 for _ in _leaves(gln_scales))
    require(n_scales == 68, f"{n_scales} GLN act scales, expected 68")
    emit({"phase": "serve.int8.calibrate", "gln_scales": n_scales,
          "seconds": time.perf_counter() - t0})

    # the detector alone on a batch of 8 photos, as bench.py serves it
    photos = [s[0] for s in scenes]
    for i in range(DETECT_BATCH - len(photos)):
        rng = np.random.default_rng((seed, 37, i))
        photos.append(synthetic.planogram_scene(
            config.canvas_h, config.canvas_w, ctx["styles"], rng)[0])
    pg.detect_batch(photos)  # warm-up
    torch.cuda.synchronize()
    td = time.perf_counter()
    dets = pg.detect_batch(photos)
    torch.cuda.synchronize()
    detect_s = time.perf_counter() - td
    for d in dets:
        require(np.isfinite(d["boxes"][d["valid"]]).all(),
                "non-finite int8 detections")
    n_dets = [int((d["valid"] & (d["scores"] > pg.confidence_threshold))
                  .sum()) for d in dets]
    emit({"phase": "serve.int8.detect_batch", "batch": len(photos),
          "detections": n_dets, "seconds": detect_s})

    t1 = time.perf_counter()
    encoder = EmbedFn(fold_bn_variables(
        ctx["vgg"], int8_all=True, int8_static=True, dtype=torch.bfloat16),
        device="cuda")
    require(encoder.needs_calibration, "int8 encoder needs no calibration")
    clf = Classifier(encoder, encoder.embedding_size,
                     sample_set=GallerySet(ctx["styles"], INT8_GALLERY_SIZE,
                                           seed), k=1, device="cuda")
    torch.cuda.synchronize()
    scales = encoder.get_scales()
    require(scales is not None and len(scales) == 12,
            "int8 MACVGG not calibrated on the gallery")
    BUILD.mkdir(parents=True, exist_ok=True)
    index = str(BUILD / "int8_index.npz")
    clf.save_index(index)
    encoder2 = EmbedFn(fold_bn_variables(
        ctx["vgg"], int8_all=True, int8_static=True, dtype=torch.bfloat16),
        device="cuda")
    clf2 = Classifier(encoder2, encoder2.embedding_size, load=index, k=1,
                      device="cuda")
    require(encoder2.get_scales() == scales, "saved scales not restored")
    require(clf2._use_fused, "int8 gallery too small for the fused kNN")
    require(np.isfinite(clf2.embedding).all(), "non-finite int8 gallery")
    emit({"phase": "serve.int8.gallery", "entries": len(clf2.embedding),
          "mac_scales": len(scales), "seconds": time.perf_counter() - t1})

    evaluator = PlanogramEvaluator(pg, clf2, PlanogramComparator(device="cuda"))
    nms_ops.nms_keep_sorted.launches = 0
    knn_ops.nearest_neighbors_fused.launches = 0
    per_scene = serve_scenes(evaluator, scenes)
    launches = {"nms_hard": nms_ops.nms_keep_sorted.launches,
                "knn_fused": knn_ops.nearest_neighbors_fused.launches}
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the int8 path")
    for r in per_scene:
        r["f32_compliance"] = ctx["compliance"][r["scene"]]
        emit({"phase": "serve.int8.scene", **r})
    emit({"phase": "serve.int8", "scenes": N_SCENES, "launches": launches,
          "serve_seconds": sum(r["seconds"] for r in per_scene),
          "seconds": time.perf_counter() - t0})


# ------------------------------------------------------------------- eval

class QueryTestSet:
    """PlanogramQuerySet scenes, rendered once, with the ann_to_int /
    int_to_ann lookups of evaluate_detections over the styles."""

    def __init__(self, styles, n: int, seed: int, config):
        base = synthetic.PlanogramQuerySet(styles, n=n,
                                           canvas_h=config.canvas_h,
                                           canvas_w=config.canvas_w,
                                           seed=10_000 + seed)
        self.items = [base[i] for i in range(n)]
        self.int_to_ann = [s["label"] for s in styles]
        self.ann_to_int = {a: i for i, a in enumerate(self.int_to_ann)}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


def _reset_launches():
    nms_ops.nms_keep_sorted.launches = 0
    knn_ops.nearest_neighbors_fused.launches = 0


def _launches():
    return {"nms_hard": nms_ops.nms_keep_sorted.launches,
            "knn_fused": knn_ops.nearest_neighbors_fused.launches}


def phase_eval(ctx, seed):
    """The evaluation and calibration path on the serve phase's f32
    detector (calibrated head) and 8192-entry gallery, at 832x1344."""
    pg, clf = ctx["pg"], ctx["clf"]
    config, state = pg.config, pg.model.state_dict()
    infer = make_variables_inference_fn(config, device="cuda")

    t0 = time.perf_counter()
    calset = synthetic.PlanogramSceneDetectionSet(
        EVAL_IMAGES, config.canvas_h, config.canvas_w, seed=seed)
    _reset_launches()
    cal = calibrate_confidence(state, config, calset, batch_size=EVAL_BATCH,
                               infer_fn=infer, input_norm="raw01",
                               device="cuda")
    launches = _launches()
    BUILD.mkdir(parents=True, exist_ok=True)
    save_calibration(str(BUILD), cal)
    cal_dir = calibration_dir_for_weights(str(BUILD))
    back = {"threshold": resolve_threshold("auto", cal_dir),
            "input_norm": resolve_input_norm(cal_dir)}
    require(load_calibration(cal_dir) == cal
            and back == {k: cal[k] for k in back},
            f"calibration read back as {back}, written {cal}")
    require(launches["nms_hard"] > 0, "nms_hard not launched calibrating")
    emit({"phase": "eval.calibrate", **cal, "read_back": back,
          "launches": launches, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    _reset_launches()
    res, (targets, preds, confs) = evaluate_gln(
        state, calset, config, thresholds=COCO_THRESHOLDS,
        batch_size=EVAL_BATCH, return_detections=True, infer_fn=infer,
        device="cuda")
    launches = _launches()
    require(launches["nms_hard"] > 0, "nms_hard not launched in evaluate_gln")
    cpu = calculate_metrics(targets, preds, confs, COCO_THRESHOLDS,
                            device="cpu")
    for t in COCO_THRESHOLDS:
        for key in METRIC_KEYS:
            require(res[t][key] == cpu[t][key],
                    f"evaluate_gln {key}@{t}: {res[t][key]} on the card, "
                    f"{cpu[t][key]} with the matcher on the CPU")
    emit({"phase": "eval.proposals", "images": len(calset),
          "detections": int(sum(len(c) for c in confs)),
          "targets": int(sum(len(t) for t in targets)),
          **{f"{key}@{t}": res[t][key] for t in (0.5, 0.75)
             for key in ("ap", "ar_300", "f")},
          "launches": launches, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    testset = QueryTestSet(ctx["styles"], N_SCENES, seed, config)
    _reset_launches()
    per_class, overall = evaluate_detections(pg, clf, testset, (0.5,),
                                             verbose=False)
    launches = _launches()
    mean = mean_average_metrics(per_class, (0.5,))
    clf._use_fused = False
    per_class_p, overall_p = evaluate_detections(pg, clf, testset, (0.5,),
                                                 verbose=False)
    clf._use_fused = True
    mean_p = mean_average_metrics(per_class_p, (0.5,))
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched in evaluate_detections")
    require(overall == overall_p and mean == mean_p,
            f"evaluate_detections with K2 {overall} {mean}, with the plain "
            f"kNN {overall_p} {mean_p}")
    emit({"phase": "eval.detection", "scenes": len(testset),
          "overall": overall[0.5], "mean": mean[0.5],
          "launches": launches, "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    index = str(BUILD / "f32_index.npz")
    clf.save_index(index)
    _reset_launches()
    acc = eval_dihe(clf.encoder_fn, clf.embedding_size, None, testset,
                    k=(1, 5), load_index=index, verbose=False, device="cuda")
    launches = _launches()
    require(launches["knn_fused"] > 0, "knn_fused not launched in eval_dihe")
    require(sorted(acc) == [1, 5] and 0.0 <= acc[1] <= acc[5] <= 1.0,
            f"eval_dihe accuracy {acc}")
    emit({"phase": "eval.dihe", "scenes": len(testset),
          "crops": int(sum(len(it[1]) for it in testset.items)),
          "accuracy": acc, "launches": launches,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    planoset = []
    for i, (img, plano, _actual, expected) in enumerate(ctx["scenes"]):
        shifted = synthetic.apply_domain_shift(
            img, np.random.default_rng((seed, 41, i)), 0.5)
        planoset.append((shifted, {"boxes": plano["boxes"],
                                   "labels": plano["labels"],
                                   "actual_accuracy": expected}))
    rows = {}
    for color_correct in (False, True):
        native.CALLS.update(build_graph=0, large_common_subgraph=0)
        _reset_launches()
        got = evaluate_planograms(PlanogramEvaluator(
            pg, clf, PlanogramComparator(device="cuda"),
            color_correct=color_correct), planoset, verbose=False)
        launches = _launches()
        calls = dict(native.CALLS)
        require(calls["large_common_subgraph"] > 0,
                "the native graph matcher was not used")
        plain = evaluate_planograms(PlanogramEvaluator(
            pg, clf, PlanogramComparator(use_native=False, device="cuda"),
            color_correct=color_correct), planoset, verbose=False)
        require(got["per_image"] == plain["per_image"],
                f"compliance {got['per_image']} with the native matcher, "
                f"{plain['per_image']} with the Python one")
        require(all(0.0 <= v <= 1.0 for v in got["per_image"]),
                f"compliance outside [0, 1]: {got['per_image']}")
        rows["color_correct" if color_correct else "raw"] = dict(
            got, native_calls=calls, launches=launches)
    emit({"phase": "eval.planograms", "scenes": len(planoset),
          "domain_shift": 0.5, **rows,
          "seconds": time.perf_counter() - t0})


# ------------------------------------------------- MACResNet, loaders, data

def phase_knn_wide(timer):
    """K2 on D past its resident query tile, held against knn_plain on
    every shape of the grid, timed at Q = 32, D = 1536, k = 1; one D
    past knn_fused_max_dim() must be refused."""
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(59)
    shapes = mismatches = 0
    worst = 0.0
    rows = []
    for dim in WIDE_DIMS:
        queries = torch.randn((max(WIDE_QUERIES), dim), device="cuda",
                              generator=gen)
        for na in WIDE_GALLERIES:
            gallery = torch.randn((na, dim), device="cuda", generator=gen)
            inv_g = knn_ops.inverse_norms(gallery)
            for nq in WIDE_QUERIES:
                q = queries[:nq]
                dists = knn_ops.distance_matrix(q, gallery)
                for k in testing.KNN_KS:
                    d_k, i_k = knn_ops.nearest_neighbors_fused(gallery, q, k,
                                                               inv_g)
                    d_p, i_p = knn_ops.knn_plain(gallery, q, k)
                    err, n_diff, _ = knn_index_check(
                        d_k, i_k, d_p, i_p, dists,
                        f"wide D={dim} Q={nq} A={na} k={k}")
                    shapes += 1
                    mismatches += n_diff
                    worst = max(worst, err)
            if dim == 1536:
                rows.append(knn_check(timer, gallery, inv_g,
                                      queries[:32], 1, f"d1536_a{na}"))
            del gallery, inv_g
    max_dim = knn_ops.knn_fused_max_dim()
    wide = max_dim + 4
    try:
        knn_ops.nearest_neighbors_fused(
            torch.zeros((4096, wide), device="cuda"),
            torch.zeros((2, wide), device="cuda"), 1)
        refused = False
    except ValueError:
        refused = True
    require(refused, f"K2 took D={wide}, past knn_fused_max_dim()")
    require(max_dim >= max(WIDE_DIMS), f"knn_fused_max_dim() {max_dim}")
    emit({"phase": "kernels.knn_fused.wide", "shapes": shapes,
          "index_mismatches": mismatches, "max_abs_err": worst,
          "max_dim": max_dim,
          "resident_max_dim": knn_ops.knn_fused_resident_max_dim(),
          "refused_dim": wide, "seconds": time.perf_counter() - t0})
    return rows


def seeded_macresnet(seed: int) -> MACResNet:
    """An f32 MACResNet (c3 + c4) with seeded conv weights and seeded
    BatchNorm affines and running statistics (means N(0, 0.1), variances
    in [0.5, 2]), on the CPU."""
    model = MACResNet(generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng((seed, 61))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                for t, v in ((m.weight, rng.uniform(0.5, 1.5, c)),
                             (m.bias, rng.normal(0, 0.1, c)),
                             (m.running_mean, rng.normal(0, 0.1, c)),
                             (m.running_var, rng.uniform(0.5, 2.0, c))):
                    t.copy_(torch.from_numpy(v.astype(np.float32)))
    return model


def phase_serve_macresnet(timer, ctx, seed):
    """The serve phase's f32 detector with an f32 MACResNet and a
    4096-entry gallery (K2 at D = 1536) on the 4 scenes, then again
    with the plain kNN; then the same MACResNet in bf16 + int8 static."""
    t0 = time.perf_counter()
    pg, scenes = ctx["pg"], ctx["scenes"]
    model = seeded_macresnet(seed)
    encoder = EmbedFn(model, device="cuda")
    gallery = GallerySet(ctx["styles"], MACRESNET_GALLERY_SIZE, seed)
    clf = Classifier(encoder, encoder.embedding_size, sample_set=gallery,
                     k=1, device="cuda")
    torch.cuda.synchronize()
    gallery_s = time.perf_counter() - t0
    require(encoder.embedding_size == 1536, "MACResNet is not 1536-d")
    require(clf._use_fused, "gallery too small for the fused kNN path")
    require(np.isfinite(clf.embedding).all(), "non-finite gallery")
    emit({"phase": "serve.macresnet.gallery", "entries": len(clf.embedding),
          "dim": encoder.embedding_size, "seconds": gallery_s})

    evaluator = PlanogramEvaluator(pg, clf, PlanogramComparator(device="cuda"))
    _reset_launches()
    per_scene = serve_scenes(evaluator, scenes)
    launches = _launches()
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched on the MACResNet path")
    clf._use_fused = False
    plain_rows = serve_scenes(evaluator, scenes)
    clf._use_fused = True
    for r, p in zip(per_scene, plain_rows):
        r["plain_knn_compliance"] = p["compliance"]
        r["macvgg_compliance"] = ctx["compliance"][r["scene"]]
        require(r["compliance"] == p["compliance"],
                f"MACResNet scene {r['scene']}: compliance "
                f"{r['compliance']} with K2, {p['compliance']} plain")
        emit({"phase": "serve.macresnet.scene", **r})
    # K2's row of the kernels line: the first scene's first 32 crops
    img = scenes[0][0]
    canvas, _, (ch, cw), _ = pg._canvas(img)
    res = pg.infer(canvas[None], torch.tensor([[ch, cw]], dtype=torch.float32,
                                              device="cuda"))
    n_det = int((res["valid"] & (res["scores"] > pg.confidence_threshold))
                .sum())
    crops = pg.crop_boxes(img, res["boxes"][0][:n_det].cpu().numpy())
    emb = encoder(crops[:32])
    knn_row = knn_check(timer, clf._anchors_dev, clf._anchor_inv_norms, emb,
                        1, "macresnet")
    emit({"phase": "serve.macresnet", "scenes": N_SCENES,
          "launches": launches,
          "serve_seconds": sum(r["seconds"] for r in per_scene),
          "seconds_per_scene": [r["seconds"] for r in per_scene],
          "gallery_seconds": gallery_s,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    state = model.state_dict()

    def int8_encoder():
        m = MACResNet(dtype=torch.bfloat16, quant="static")
        m.load_state_dict(state)
        return EmbedFn(m, device="cuda")

    encoder8 = int8_encoder()
    require(encoder8.needs_calibration, "quant='static' needs calibration")
    clf8 = Classifier(encoder8, encoder8.embedding_size, sample_set=gallery,
                      k=1, device="cuda")
    scales = encoder8.get_scales()
    n_scales = sum(1 for _ in _leaves(scales)) if scales else 0
    require(n_scales == MACRESNET_INT8_SCALES,
            f"{n_scales} MACResNet act scales after indexing")
    BUILD.mkdir(parents=True, exist_ok=True)
    index = str(BUILD / "macresnet_int8_index.npz")
    clf8.save_index(index)
    encoder8b = int8_encoder()
    clf8b = Classifier(encoder8b, encoder8b.embedding_size, load=index, k=1,
                       device="cuda")
    require(encoder8b.get_scales() == scales, "saved scales not restored")
    before, after = encoder8(crops), encoder8b(crops)
    require(torch.equal(before, after),
            "int8 MACResNet embeddings changed across the index reload")
    gallery_s = time.perf_counter() - t0
    evaluator = PlanogramEvaluator(pg, clf8b,
                                   PlanogramComparator(device="cuda"))
    _reset_launches()
    per_scene8 = serve_scenes(evaluator, scenes)
    launches8 = _launches()
    require(launches8["knn_fused"] > 0,
            "knn_fused was not launched on the int8 MACResNet path")
    for r in per_scene8:
        r["f32_compliance"] = per_scene[r["scene"]]["compliance"]
        emit({"phase": "serve.macresnet.int8.scene", **r})
    emit({"phase": "serve.macresnet.int8", "scenes": N_SCENES,
          "act_scales": n_scales, "launches": launches8,
          "gallery_seconds": gallery_s,
          "serve_seconds": sum(r["seconds"] for r in per_scene8),
          "seconds": time.perf_counter() - t0})
    ctx.update(macresnet=encoder, macresnet_clf=clf)
    return launches, knn_row


def phase_load_reference(seed):
    """Seeded checkpoints in the reference's layouts, saved with
    torch.save and loaded through cli/common.py onto the card: every
    parameter equals the tensor the name mapping picks, and 8 crops and
    one canvas give the outputs of the same dict loaded directly."""
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng((seed, 67))
    gln_sd = testing.gln_reference_state_dict(rng)
    resnet_sd = testing.resnet50_state_dict(rng)
    vgg_sd = testing.vgg16_features_state_dict(rng, batch_norm=True)
    # the reference MACVGG in block slices of the same vgg16_bn weights
    slices_sd = testing.macvgg_slices(vgg_sd, batch_norm=True)
    files = {"gln": {"model_state_dict": gln_sd},
             "resnet50": {"model_state_dict": {f"module.{k}": v
                                               for k, v in resnet_sd.items()}},
             "vgg16_bn": vgg_sd,
             "macvgg": {"model_state_dict": slices_sd}}
    paths = {}
    for name, obj in files.items():
        paths[name] = str(BUILD / f"reference_{name}.pth")
        torch.save(obj, paths[name])
    crops = torch.from_numpy(rng.uniform(-1, 1, (8, 256, 256, 3))
                             .astype(np.float32)).cuda()
    rows = {}

    def same_params(got, want, label):
        require(set(got) == set(want), f"{label}: key sets differ")
        for key, t in want.items():
            require(torch.equal(got[key].cpu(), t.to(got[key].dtype)),
                    f"{label}: {key} differs from the mapped tensor")
        return len(want)

    # the detector, on one seeded canvas
    config = GLNConfig()
    state = load_gln_state_dict(paths["gln"], config)
    n_gln = same_params(state, import_gln(gln_sd), "gln")
    direct = GLN(config)
    direct.load_state_dict(import_gln(gln_sd))
    loaded = GLN(config)
    loaded.load_state_dict(state)
    canvas = torch.from_numpy(rng.uniform(
        0, 1, (1, config.canvas_h, config.canvas_w, 3)).astype(
            np.float32)).cuda()
    with torch.inference_mode():
        out_l = loaded.cuda()(canvas)
        out_d = direct.cuda()(canvas)
    for key in out_d:
        require(torch.equal(out_l[key], out_d[key]),
                f"gln {key} differs from the directly loaded model")
    rows["gln"] = {"params": n_gln, "outputs": sorted(out_d)}
    del loaded, direct, out_l, out_d

    # the embedders, on 8 seeded crops
    enc, size = load_embedder(paths["resnet50"], encoder="resnet50",
                              device="cuda")
    mapped = import_resnet50(resnet_sd, "batch", prefix="trunk.")
    n_res = same_params(enc.model.state_dict(), mapped, "resnet50")
    direct = MACResNet()
    direct.load_state_dict(mapped)
    require(torch.equal(enc(crops), EmbedFn(direct, device="cuda")(crops)),
            "resnet50 embeddings differ from the directly loaded model")
    rows["resnet50"] = {"params": n_res, "dim": size}
    mapped = fold_bn_state_dict(import_vgg16_features(vgg_sd, True))
    direct = MACVGG(batch_norm=False)
    direct.load_state_dict(mapped)
    want = EmbedFn(direct, device="cuda")(crops)
    for name in ("vgg16_bn", "macvgg"):
        enc, size = load_embedder(paths[name], batch_norm=True,
                                  device="cuda")
        n_vgg = same_params(enc.model.state_dict(), mapped, name)
        require(torch.equal(enc(crops), want),
                f"{name} embeddings differ from the directly loaded model")
        rows[name] = {"params": n_vgg, "dim": size}

    bad = dict(resnet_sd)
    bad["layer1.0.conv1.weight"] = bad["layer1.0.conv1.weight"][:, :32]
    bad_path = str(BUILD / "reference_resnet50_bad.pth")
    torch.save(bad, bad_path)
    try:
        load_embedder(bad_path, encoder="resnet50", device="cuda")
        raised = None
    except ValueError as err:
        raised = str(err)
    require(raised is not None and "layer1_0.conv1.weight" in raised,
            f"a wrongly shaped checkpoint loaded ({raised})")
    emit({"phase": "load.reference", **rows, "wrong_shape": raised,
          "seconds": time.perf_counter() - t0})


ORBAX_EXPORTS = ("gln_r5", "dihe_r4")
# the trained detector on the card against the port's CPU forward of the
# same weights on one serve scene: cuDNN's f32 convolutions sum in another
# order than the CPU's, which moves scores and boxes; the bounds are the
# ones JAX's own test holds a forward in another order to
# (tests/test_parallel_e2e.py), as parallel.spatial does
ORBAX_SCORE_TOL = 1e-4
ORBAX_BOX_TOL = 1e-2  # px


def _matched(a, b):
    """For each detection of `a` ({boxes, scores}), the largest box
    coordinate and score differences to its nearest box in `b`."""
    if len(a["boxes"]) == 0:
        return 0.0, 0.0
    if len(b["boxes"]) == 0:
        return float("inf"), float("inf")
    d = np.abs(a["boxes"][:, None, :] - b["boxes"][None, :, :]).max(-1)
    j = d.argmin(1)
    return (float(d[np.arange(len(j)), j].max()),
            float(np.abs(a["scores"] - b["scores"][j]).max()))


def phase_load_orbax(ctx, seed):
    """The port's reader of the JAX package's orbax checkpoints
    (utils/zstd.py, utils/ocdbt.py, utils/orbax_read.py) on the card's
    machine, which has no zstd, tensorstore or orbax:

    (a) the committed fixture tests/torch_fixtures/orbax_seeded/, every
        leaf bit for bit the seeded tree it was written from, and the
        committed zstd frames equal to their seeded data;
    (b) the trained exports artifacts/gln_r5 and artifacts/dihe_r4, every
        leaf's sha256, shape and dtype equal to
        tests/torch_fixtures/orbax_digests.json (orbax's restore); the
        read seconds and the decode's MB/s;
    (c) the 4 serve scenes at 832x1344 served by gln_r5 + dihe_r4 (the
        threshold and preprocessing from the export's
        serving_calibration.json, no head calibration) against an
        8192-entry gallery embedded by dihe_r4: K1 and K2 launched and
        equal to their plain versions, one scene's detections held to
        the port's CPU forward of the same weights. The scenes are
        synthetic: their detection counts and compliance are no quality
        number;
    (d) both exports written again by the port, as it read them, in the
        JAX package's orbax layout into a directory under BUILD: each
        export linked as the checkpoint node of a run with its sidecars,
        and that run exported by `export_gln_serving` /
        `export_dihe_serving` (the bridge's inverse, utils/orbax_write.py,
        the sidecars copied byte for byte), read back
        by the port's reader with every leaf equal to the digests, and
        scene 0 served from them, launch counts set to 0 just before:
        K1 and K2 launched, the detections bit for bit (c)'s on the
        original exports and the kNN labels of their crops (c)'s. Write
        seconds of `orbax_write.save` and of the whole export, and the
        write's MB/s of the arrays' bytes, with the card's name and power
        limit.
    Only the exports may be missing (the copy to the card may drop
    them): (b) to (d) then print that they are absent."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent
    # (a)
    t = time.perf_counter()
    got = dict(testing.tree_leaves(orbax_read.restore(
        str(root / testing.ORBAX_FIXTURE_DIR))))
    want = dict(testing.tree_leaves(testing.orbax_fixture_tree(
        testing.ORBAX_FIXTURE_SEED)))
    require(set(got) == set(want), "load.orbax: the fixture's leaves "
            f"{sorted(set(got) ^ set(want))} differ")
    for key, w in want.items():
        g = got[key]
        require(isinstance(g, np.ndarray) and g.dtype == w.dtype
                and g.shape == w.shape and g.tobytes() == w.tobytes(),
                f"load.orbax: fixture leaf {key} differs from the seed")
    fixture_s = time.perf_counter() - t
    blob = (root / (testing.ZSTD_FRAMES + ".bin")).read_bytes()
    index = json.loads((root / (testing.ZSTD_FRAMES + ".json")).read_text())
    for entry in index:
        frame = blob[entry["offset"]:entry["offset"] + entry["length"]]
        expected = b"".join(testing.zstd_fixture_data(k)
                            for k in entry["parts"])
        require(zstd.decompress(frame) == expected,
                f"load.orbax: zstd frame {entry['name']} decodes wrong")
    row = {"fixture": {"leaves": len(want),
                       "bytes": int(sum(w.nbytes for w in want.values())),
                       "seconds": fixture_s},
           "zstd_frames": len(index)}
    dirs = {n: root / "artifacts" / n for n in ORBAX_EXPORTS}
    if not all((d / "serving_checkpoint").is_dir() for d in dirs.values()):
        print("load.orbax: the trained exports artifacts/gln_r5 and "
              "artifacts/dihe_r4 are absent from this copy: (b) and (c) "
              "not run", flush=True)
        emit({"phase": "load.orbax", **row, "exports": "absent",
              "seconds": time.perf_counter() - t0})
        return {"nms_hard": 0, "knn_fused": 0}

    # (b)
    digests = json.loads((root / testing.ORBAX_DIGESTS).read_text())
    exports = {}
    for name, d in dirs.items():
        ckpt = d / "serving_checkpoint"
        stored = sum(f.stat().st_size for f in ckpt.rglob("*")
                     if f.is_file())
        t = time.perf_counter()
        tree = orbax_read.restore(str(ckpt))
        read_s = time.perf_counter() - t
        leaves = dict(testing.tree_leaves(tree))
        decoded = int(sum(v.nbytes for v in leaves.values()))
        bad = [k for k, v in testing.tree_digests(tree).items()
               if digests[name].get(k) != v]
        require(not bad and len(leaves) == len(digests[name]),
                f"load.orbax: {name}: {len(bad)} leaves differ from "
                f"orbax_digests.json (first {bad[:3]}), {len(leaves)} "
                f"leaves for {len(digests[name])}")
        # the decode alone: every stored value through the zstd decoder
        # on one thread
        store = ocdbt.OcdbtStore(str(ckpt))
        values = [store.read(k) for k in store.keys()
                  if not k.endswith(b".zarray")]
        t = time.perf_counter()
        out = sum(len(zstd.decompress(v)) for v in values)
        decode_s = time.perf_counter() - t
        require(out == decoded, f"load.orbax: {name}: {out} bytes decoded "
                f"from the chunks, {decoded} in the arrays")
        exports[name] = {"leaves": len(leaves), "stored_bytes": stored,
                         "decoded_bytes": decoded, "read_seconds": read_s,
                         "read_mb_per_s": decoded / 1e6 / read_s,
                         "decode_seconds_one_thread": decode_s,
                         "decode_mb_per_s_one_thread":
                             decoded / 1e6 / decode_s}
        del tree, leaves, values

    # (c)
    t = time.perf_counter()
    gln_dir, dihe_dir = str(dirs["gln_r5"]), str(dirs["dihe_r4"])
    threshold = resolve_threshold("auto", gln_dir)
    input_norm = resolve_input_norm(gln_dir)
    config = GLNConfig()
    state = load_gln_variables(gln_dir)
    pg = ProposalGenerator(state, config, confidence_threshold=threshold,
                           input_norm=input_norm, device="cuda")
    encoder, dim = load_embedder(dihe_dir, device="cuda")
    clf = Classifier(encoder, dim, sample_set=GallerySet(
        ctx["styles"], GALLERY_SIZE, seed), k=1, device="cuda")
    torch.cuda.synchronize()
    require(clf._use_fused, "load.orbax: gallery too small for K2")
    load_s = time.perf_counter() - t
    evaluator = PlanogramEvaluator(pg, clf, PlanogramComparator(device="cuda"))
    _reset_launches()
    per_scene = serve_scenes(evaluator, ctx["scenes"])
    launches = _launches()
    for kernel, n in launches.items():
        require(n > 0, f"load.orbax: {kernel} was not launched serving "
                "the trained exports")
    for i, (img, *_rest) in enumerate(ctx["scenes"]):
        res, n_det, crops, keep_mm, knn_mm = scene_kernel_checks(
            pg, clf, img, f"load.orbax scene {i}")
        per_scene[i].update(candidates=int(res["num_candidates"][0]),
                            detections=n_det, keep_mismatches=keep_mm,
                            knn_index_mismatches=knn_mm)
    require(per_scene[0]["detections"] > 0,
            "load.orbax: gln_r5 finds nothing on scene 0")
    # scene 0 on the card against the port's CPU forward
    img = ctx["scenes"][0][0]
    pg_cpu = ProposalGenerator(state, config, confidence_threshold=threshold,
                               input_norm=input_norm, device="cpu")
    card, cpu = pg.detect(img), pg_cpu.detect(img)

    def served(r, lo=threshold):
        keep = r["valid"] & (r["scores"] > lo)
        return {"boxes": r["boxes"][keep], "scores": r["scores"][keep]}

    box_a, score_a = _matched(served(card), served(cpu, -1.0))
    box_b, score_b = _matched(served(cpu), served(card, -1.0))
    n_card, n_cpu = len(served(card)["scores"]), len(served(cpu)["scores"])
    borderline = int((np.abs(cpu["scores"][cpu["valid"]] - threshold)
                      <= ORBAX_SCORE_TOL).sum())
    box_err, score_err = max(box_a, box_b), max(score_a, score_b)
    require(box_err <= ORBAX_BOX_TOL and score_err <= ORBAX_SCORE_TOL
            and abs(n_card - n_cpu) <= borderline,
            f"load.orbax: scene 0 on the card against the CPU: boxes "
            f"{box_err} px, scores {score_err}, {n_card} against {n_cpu} "
            f"detections ({borderline} within the score bound of the "
            "threshold)")
    for r in per_scene:
        emit({"phase": "load.orbax.scene", "synthetic_scene": True, **r})
    rewrite = orbax_rewrite(dirs, digests, pg, clf, card, ctx["scenes"][:1],
                            config, threshold, input_norm)
    emit({"phase": "load.orbax", **row, "exports": exports,
          "serve": {"threshold": threshold, "input_norm": input_norm,
                    "gallery": len(clf.embedding), "embedding_size": dim,
                    "load_and_gallery_seconds": load_s,
                    "serve_seconds": sum(r["seconds"] for r in per_scene),
                    "detections": [r["detections"] for r in per_scene],
                    "compliance": [r["compliance"] for r in per_scene],
                    "note": "synthetic scenes: no quality number",
                    "launches": launches,
                    "cpu_parity": {"detections_card": n_card,
                                   "detections_cpu": n_cpu,
                                   "borderline": borderline,
                                   "max_box_err_px": box_err,
                                   "max_score_err": score_err,
                                   "tolerances": {
                                       "score": ORBAX_SCORE_TOL,
                                       "box_px": ORBAX_BOX_TOL}}},
          "rewrite": rewrite, "nvidia_smi": nvidia_smi(),
          "seconds": time.perf_counter() - t0})
    return launches


def orbax_rewrite(dirs, digests, pg, clf, card, scenes, config, threshold,
                  input_norm):
    """load.orbax (d): gln_r5 and dihe_r4 written again by the port in
    the JAX package's orbax layout, read back against the digests, and
    scene 0 served from them against (c)'s detector `pg`, classifier
    `clf` and scene-0 detections `card`."""
    t0 = time.perf_counter()
    out = BUILD / "orbax_rewrite"
    shutil.rmtree(out, ignore_errors=True)
    # each export as the checkpoint node of a training run, its sidecars
    # beside it, as the serving export finds them
    exports = {"gln_r5": (export_gln_serving, "checkpoint"),
               "dihe_r4": (export_dihe_serving, "embedder_checkpoint")}
    saved = []
    save = orbax_write.save

    def timed_save(directory, tree):
        t = time.perf_counter()
        stats = save(directory, tree)
        saved.append((time.perf_counter() - t, stats))
        return stats

    written = {}
    for name, d in dirs.items():
        export, node = exports[name]
        run = out / "runs" / name
        run.mkdir(parents=True)
        (run / node).symlink_to(d / "serving_checkpoint")
        if (d / "serving_calibration.json").exists():
            shutil.copyfile(d / "serving_calibration.json",
                            run / "serving_calibration.json")
        shutil.copyfile(d / "serving_checkpoint.meta.json",
                        run / f"{node}.meta.json")
        with mock.patch.object(orbax_write, "save", timed_save):
            t = time.perf_counter()
            target = Path(export(str(run), str(out / name)))
            export_s = time.perf_counter() - t
        write_s, stats = saved.pop()
        for sidecar in ("serving_calibration.json",
                        "serving_checkpoint.meta.json"):
            require((target / sidecar).exists() == (d / sidecar).exists()
                    and (not (d / sidecar).exists() or (
                        (target / sidecar).read_bytes()
                        == (d / sidecar).read_bytes())),
                    f"load.orbax (d): {name}'s {sidecar} was not copied "
                    "byte for byte")
        stored = sum(f.stat().st_size for f in
                     (target / "serving_checkpoint").rglob("*")
                     if f.is_file())
        t = time.perf_counter()
        back = orbax_read.restore(str(target / "serving_checkpoint"))
        read_s = time.perf_counter() - t
        got = testing.tree_digests(back)
        bad = [k for k, v in digests[name].items() if got.get(k) != v]
        require(not bad and len(got) == len(digests[name]),
                f"load.orbax (d): the port's rewrite of {name}: {len(bad)} "
                f"leaves differ from orbax_digests.json (first {bad[:3]}), "
                f"{len(got)} leaves for {len(digests[name])}")
        written[name] = {"leaves": len(got),
                         "array_bytes": stats["array_bytes"],
                         "stored_bytes": stored,
                         "ocdbt": {k: stats[k] for k in ("keys", "nodes")},
                         "export_seconds": export_s,
                         "write_seconds": write_s,
                         "write_mb_per_s": stats["array_bytes"] / 1e6
                         / write_s,
                         "read_back_seconds": read_s}
        del back
    gln_dir, dihe_dir = str(out / "gln_r5"), str(out / "dihe_r4")
    require(resolve_threshold("auto", gln_dir) == threshold
            and resolve_input_norm(gln_dir) == input_norm,
            "load.orbax (d): the rewrite's calibration sidecar differs")
    pg2 = ProposalGenerator(load_gln_variables(gln_dir), config,
                            confidence_threshold=threshold,
                            input_norm=input_norm, device="cuda")
    encoder, dim = load_embedder(dihe_dir, device="cuda")
    index = BUILD / "orbax_rewrite" / "gallery_index.npz"
    clf.save_index(str(index))
    clf2 = Classifier(encoder, dim, k=1, load=str(index), device="cuda")
    require(clf2._use_fused, "load.orbax (d): gallery too small for K2")
    evaluator = PlanogramEvaluator(pg2, clf2,
                                   PlanogramComparator(device="cuda"))
    _reset_launches()
    served = serve_scenes(evaluator, scenes)
    launches = _launches()
    for kernel, n in launches.items():
        require(n > 0, f"load.orbax (d): {kernel} was not launched serving "
                "the rewritten exports")
    img = scenes[0][0]
    again = pg2.detect(img)
    for key in ("boxes", "scores", "valid"):
        require(np.array_equal(again[key], card[key]),
                f"load.orbax (d): scene 0's {key} from the rewritten gln_r5 "
                "differ from (c)'s")
    kept = card["valid"] & (card["scores"] > threshold)
    n_det = int(kept.sum())
    crops = pg.crop_boxes(img, card["boxes"][kept])
    require(n_det > 0 and clf2.classify(crops) == clf.classify(crops),
            "load.orbax (d): the rewritten dihe_r4 classifies scene 0's "
            "crops otherwise than (c)")
    shutil.rmtree(out, ignore_errors=True)
    return {"exports": written, "scene0": {
        "detections": n_det, "launches": launches,
        "compliance": served[0]["compliance"],
        "serve_seconds": served[0]["seconds"]},
        "seconds": time.perf_counter() - t0}


def phase_data_perspective(ctx, seed):
    """eval_dihe through the MACResNet index on perspective-warped query
    scenes at 832x1344: the warp is transforms.warp_perspective, host
    numpy, so no cv2 is needed."""
    t0 = time.perf_counter()
    config = ctx["pg"].config
    base = synthetic.PlanogramQuerySet(
        ctx["styles"], n=N_SCENES, canvas_h=config.canvas_h,
        canvas_w=config.canvas_w, seed=10_000 + seed, perspective=0.5)
    items, render_s = [], []
    for i in range(len(base)):
        ts = time.perf_counter()
        items.append(base[i])
        render_s.append(time.perf_counter() - ts)
    for img, labels, boxes in items:
        require(img.shape == (config.canvas_h, config.canvas_w, 3)
                and np.isfinite(img).all() and len(labels) == len(boxes),
                "perspective scene")
    index = str(BUILD / "macresnet_index.npz")
    clf = ctx["macresnet_clf"]
    clf.save_index(index)
    _reset_launches()
    acc = eval_dihe(ctx["macresnet"], clf.embedding_size, None, items,
                    k=(1, 5), load_index=index, verbose=False, device="cuda")
    launches = _launches()
    require(launches["knn_fused"] > 0, "knn_fused not launched in eval_dihe")
    require(sorted(acc) == [1, 5] and 0.0 <= acc[1] <= acc[5] <= 1.0,
            f"eval_dihe accuracy {acc}")
    emit({"phase": "data.perspective", "scenes": len(items),
          "perspective": 0.5,
          "crops": int(sum(len(it[1]) for it in items)),
          "render_seconds_per_scene": render_s, "accuracy": acc,
          "launches": launches, "seconds": time.perf_counter() - t0})


# ------------------------------------------------------- data from files

DATA_PHOTO_HW = (2448, 3264)  # a phone photo, h x w
DATA_PHOTOS = 8
DATA_GALLERY = 4096  # ops/knn.py:FUSED_MIN_ROWS: the Classifier takes K2
DATA_VIEW_HEIGHT = 48  # px, the gallery's product images
DATA_RESUME_EVAL = 2  # scenes in the resume runs' epoch eval
DATA_STORES = (("1", "1"), ("1", "2"), ("2", "1"), ("2", "2"))


def _quantise(img) -> np.ndarray:
    return np.clip(np.rint(np.asarray(img) * 255.0), 0, 255).astype(np.uint8)


class _TimedReads:
    """The first `n` items of a dataset; the seconds spent in its
    __getitem__ add up in `seconds` (over every loader thread), and the
    last item read at each index stays in `items`."""

    def __init__(self, base, n=None):
        self.base = base
        self.n = len(base) if n is None else n
        self.seconds = 0.0
        self.items = {}
        self._lock = threading.Lock()

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if not 0 <= i < self.n:
            raise IndexError(i)
        t0 = time.perf_counter()
        item = self.base[i]
        with self._lock:
            self.seconds += time.perf_counter() - t0
            self.items[i] = item
        return item


class _Interrupt(Exception):
    pass


class _InterruptedGrainLoader(GrainLoader):
    """Stops a run as it asks for its epoch's third batch."""

    def __iter__(self):
        for i, batch in enumerate(super().__iter__()):
            if i == 2:
                raise _Interrupt
            yield batch


class _RecordingComparator(PlanogramComparator):
    """Keeps the detections (boxes, classes) each comparison is given."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.seen = []

    def compare_detailed(self, expected, actual, image=None,
                         classifier=None):
        score, found, path = super().compare_detailed(expected, actual,
                                                      image, classifier)
        self.seen.append((np.asarray(actual["boxes"]).copy(),
                          list(actual["labels"]),
                          None if found is None else np.asarray(found),
                          path))
        return score, found, path


def _write_png(i, path, u8):
    testing.write_png(path, u8, compress_level=1)


def write_sku110k_files(root: Path, seed, write=_write_png) -> Dict:
    """DATA_PHOTOS shelf scenes at the phone photo's size under
    SKU-110K's `.jpg` names, written by `write(i, path, uint8 image)`
    (PNG bytes by default), and the 8-column annotation CSV with one
    malformed row and one name of the skip list. Returns {path: the
    uint8 image written}, the boxes by name and {path: what `write`
    returned}."""
    img_dir = root / "SKU110K_fixed" / "images"
    ann = root / "SKU110K_fixed" / "annotations" / "annotations_train.csv"
    img_dir.mkdir(parents=True)
    ann.parent.mkdir(parents=True)
    h, w = DATA_PHOTO_HW

    def photo(i):
        img, boxes = synthetic.shelf_scene(
            h, w, np.random.default_rng((seed, 83, i)))
        u8 = _quantise(img)
        out = write(i, img_dir / f"train_{i}.jpg", u8)
        return u8, np.rint(boxes).astype(int), out

    # numpy and zlib let the threads overlap
    with ThreadPoolExecutor(DATA_PHOTOS) as pool:
        photos = list(pool.map(photo, range(DATA_PHOTOS)))
    rows, written, boxes_of, outs = [], {}, {}, {}
    for i, (u8, boxes, out) in enumerate(photos):
        name = f"train_{i}.jpg"
        written[img_dir / name] = u8
        outs[img_dir / name] = out
        boxes_of[name] = boxes
        rows += [f"{name},{x1},{y1},{x2},{y2},object,{w},{h}"
                 for x1, y1, x2, y2 in boxes]
    rows.insert(1, "train_0.jpg,1,2,3")
    rows.append(f"{defaults.SKU110K_SKIP[0]},10,10,50,50,object,{w},{h}")
    ann.write_text("\n".join(rows) + "\n")
    return {"img_dir": str(img_dir), "ann": str(ann), "written": written,
            "boxes": boxes_of, "outs": outs}


def _product_path(p: int) -> str:
    """Product p's place below Training/, and its annotation without
    the extension: family/line/p, as GP's category/sub/number."""
    return f"Family{p // 1024}/Line{(p // 64) % 16}/{p}"


def tonioni_planogram(plano, styles):
    """A serve scene's planogram as a GP-180 (Tonioni) grid JSON, with
    the boxes, labels and Graph that it stands for.

    Each shelf is a row chain (e/w) of its products from left to right,
    the shelves' first products one column (JSON n = the shelf below in
    the photo), one object per product with its box's size, named after
    the product's gallery image. Nodes run from the lowest
    shelf up, so the reader anchors that shelf: each row starts at
    x = 0 and packs its products; row r's bottom edge is the summed
    heights of the first products of the rows below (y up)."""
    boxes = np.asarray(plano["boxes"])
    by_label = {s["label"]: i for i, s in enumerate(styles)}
    shelves = []
    for y2 in sorted(set(boxes[:, 3].tolist()), reverse=True):
        idx = np.nonzero(boxes[:, 3] == y2)[0]
        shelves.append(sorted(idx.tolist(), key=lambda k: boxes[k, 0]))
    first = np.cumsum([0] + [len(r) for r in shelves])
    graph, objects, labels, want = [], [], [], []
    y2 = 0.0
    for r, row in enumerate(shelves):
        x1 = 0.0
        for c, k in enumerate(row):
            i = int(first[r] + c)
            graph.append({
                "ogg": i,
                "n": int(first[r - 1]) if c == 0 and r else -1,
                "s": int(first[r + 1]) if c == 0 and r + 1 < len(shelves)
                else -1,
                "e": i + 1 if c + 1 < len(row) else -1,
                "w": i - 1 if c else -1})
            bw = float(boxes[k, 2] - boxes[k, 0])
            bh = float(boxes[k, 3] - boxes[k, 1])
            label = _product_path(by_label[plano["labels"][k]])
            objects.append({"width": bw, "height": bh,
                            "img_path": f"{label}.jpg"})
            labels.append(label)
            want.append([x1, y2 - bh, x1 + bw, y2])
            x1 += bw
        y2 += float(boxes[row[0], 3] - boxes[row[0], 1])
    g = Graph()
    dirs = {"n": "S", "s": "N", "e": "E", "w": "W"}
    for i, entry in enumerate(graph):
        g.add_node(i)
        for key, d in dirs.items():
            if entry[key] >= 0:
                g.add_edge(i, entry[key], dir=d)
    for i, label in enumerate(labels):
        g.nodes[i]["label"] = label
    return ({"graph": graph, "objects": objects},
            {"boxes": np.asarray(want, np.float32), "labels": labels,
             "graph": g, "actual_accuracy": 1.0})


def _same_graph(a: Graph, b: Graph) -> bool:
    return (list(a.nodes.items()) == list(b.nodes.items())
            and [(u, list(a[u].items())) for u in a]
            == [(u, list(b[u].items())) for u in b])


def write_gp_files(root: Path, styles, scenes, seed) -> Dict:
    """The Grocery Products layout: a catalogue of DATA_GALLERY products,
    one image each as PNG bytes under Training/<family>/<line>/<p>.jpg
    (the serve scenes' styles are products 0-15, seeded grey styles the
    rest) and the TrainingFiles.txt index; then the scenes
    (`write_gp_scenes`, PNG bytes). Returns the paths, {path: uint8
    image} and the in-memory planograms."""
    gp = root / "Grocery_products"
    others = synthetic.product_styles(DATA_GALLERY - len(styles),
                                      seed=seed + 97)
    for st in others:  # grey: the scenes' products stay nearest their own
        st["color"] = np.full(3, st["color"].mean(), np.float32)
        st["band_color"] = np.full(3, st["band_color"].mean(), np.float32)
    catalogue = list(styles) + others
    files, written = [], {}
    for p, style in enumerate(catalogue):
        path = gp / "Training" / f"{_product_path(p)}.jpg"
        path.parent.mkdir(parents=True, exist_ok=True)
        written[path] = _quantise(synthetic.product_gallery_image(
            style, height=DATA_VIEW_HEIGHT))
        testing.write_png(path, written[path])
        files.append(f"Training/{_product_path(p)}.jpg")
    (gp / "TrainingFiles.txt").write_text("\n".join(files) + "\n")
    out = write_gp_scenes(root, styles, scenes)
    out["written"].update(written)
    return {"gp": str(gp), **out}


def write_gp_scenes(root: Path, styles, scenes, write=_write_png) -> Dict:
    """The GP-180 scenes of the Grocery Products layout under
    Testing/store{s}/images/store{s}_{i}.jpg, written by `write(i, path,
    uint8 image)`, with their s{s}_{i}.csv annotations (the rendered
    products, named as the catalogue's) and Tonioni s{s}_{i}.json
    planograms. Returns the directories, {path: uint8 image}, {path:
    what `write` returned} and the in-memory planograms."""
    gp = root / "Grocery_products"
    ann_dir = root / "Planogram_Dataset" / "annotations"
    plano_dir = root / "Planogram_Dataset" / "planograms"
    ann_dir.mkdir(parents=True)
    plano_dir.mkdir(parents=True)
    by_label = {s["label"]: i for i, s in enumerate(styles)}
    planos, anns, written, outs = [], [], {}, {}
    for k, ((s, i), (img, plano, actual, _expected)) in enumerate(
            zip(DATA_STORES, scenes)):
        path = gp / "Testing" / f"store{s}" / "images" / f"store{s}_{i}.jpg"
        path.parent.mkdir(parents=True, exist_ok=True)
        written[path] = _quantise(img)
        outs[path] = write(k, path, written[path])
        labels = [_product_path(by_label[a]) for a in actual["labels"]]
        ab = np.rint(actual["boxes"]).astype(int)
        (ann_dir / f"s{s}_{i}.csv").write_text("".join(
            f"{a}.jpg, {x1}, {y1}, {x2}, {y2}\n"
            for a, (x1, y1, x2, y2) in zip(labels, ab)))
        anns.append((labels, ab.astype(np.float32)))
        spec, want = tonioni_planogram(plano, styles)
        (plano_dir / f"s{s}_{i}.json").write_text(json.dumps(spec))
        planos.append(want)
    return {"test_dir": str(gp / "Testing"), "ann_dir": str(ann_dir),
            "plano_dir": str(plano_dir), "written": written, "outs": outs,
            "planograms": planos, "anns": anns}


def decode_check(written: Dict) -> Dict:
    """Decodes every file written and holds it to the uint8 image
    written: (seconds, megapixels, files)."""
    seconds, pixels = 0.0, 0
    for path, u8 in written.items():
        t0 = time.perf_counter()
        got = png.to_rgb(png.read_png(path))
        seconds += time.perf_counter() - t0
        require(np.array_equal(got, u8),
                f"{path} decodes to other pixels than were written")
        pixels += u8.shape[0] * u8.shape[1]
    return {"files": len(written), "megapixels": pixels / 1e6,
            "seconds": seconds,
            "seconds_per_megapixel": seconds / (pixels / 1e6)}


def phase_data_files(ctx, seed, ref, smi):
    """The dataset readers on files in the datasets' own layouts, under
    build/chip_smoke/data/: SKU-110K photos through SKU110KDataset
    (canvases made on the card) into evaluate_gln with the serve
    detector, one train_proposal_generator epoch (GrainLoader) with
    its eval, a resume inside that epoch and the record cache; the
    Grocery Products gallery through GroceryProductsDataset into a
    MACVGG Classifier (K2) and the GP-180 scenes through
    PlanogramTestSet into evaluate_planograms, held to an in-memory
    pass over the same uint8 images and planograms."""
    t_phase = time.perf_counter()
    root = BUILD / "data"
    shutil.rmtree(root, ignore_errors=True)
    pg, config = ctx["pg"], ctx["pg"].config
    state = pg.model.state_dict()

    t0 = time.perf_counter()
    sku = write_sku110k_files(root, seed)
    gp = write_gp_files(root, ctx["styles"], ctx["scenes"], seed)
    write_s = time.perf_counter() - t0
    photos = decode_check(sku["written"])
    gallery = {p: u for p, u in gp["written"].items()
               if "Training" in p.parts}
    views = decode_check(gallery)
    scenes = decode_check({p: u for p, u in gp["written"].items()
                           if p not in gallery})
    emit({"phase": "data.files.write", "root": str(root),
          "photos": photos, "gallery": views, "scenes": scenes,
          "bytes": sum(p.stat().st_size for p in root.rglob("*")
                       if p.is_file()),
          "write_seconds": write_s})

    # SKU-110K: the index, evaluate_gln on the serve detector
    t0 = time.perf_counter()
    kw = dict(skip=defaults.SKU110K_SKIP, canvas_h=config.canvas_h,
              canvas_w=config.canvas_w, device="cuda")
    evalset = SKU110KDataset(sku["img_dir"], sku["ann"], flip_chance=0.0,
                             **kw)
    require([e["image_name"] for e in evalset.index]
            == list(sku["boxes"]), "SKU-110K index names")
    for e in evalset.index:
        require(np.array_equal(e["boxes"], sku["boxes"][e["image_name"]])
                and e["image_height"] == DATA_PHOTO_HW[0]
                and e["image_width"] == DATA_PHOTO_HW[1],
                f"SKU-110K index entry {e['image_name']}")
    timed = _TimedReads(evalset)
    _reset_launches()
    res, (targets, _, confs) = evaluate_gln(
        state, timed, config, thresholds=(0.5,), batch_size=EVAL_BATCH,
        return_detections=True,
        infer_fn=make_variables_inference_fn(config, device="cuda"),
        device="cuda")
    torch.cuda.synchronize()
    eval_launches = _launches()
    require(eval_launches["nms_hard"] > 0,
            "nms_hard not launched in evaluate_gln on the files")
    require(all(np.isfinite(c).all() for c in confs), "non-finite scores")
    sku_eval = {"seconds": time.perf_counter() - t0,
                "read_seconds": timed.seconds,
                "images": len(evalset),
                "targets": int(sum(len(t) for t in targets)),
                "detections": int(sum(len(c) for c in confs)),
                **{k: res[0.5][k] for k in ("ap", "ar_300", "f")},
                "launches": eval_launches}
    emit({"phase": "data.files.sku110k", **sku_eval})

    # one GLN epoch on the files, a resume inside it, the record cache
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        train = _data_files_train(seed, ref, sku, kw, evalset)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit({"phase": "data.files.train", **train})

    t0 = time.perf_counter()
    timed = _TimedReads(evalset)
    cached = CachedDetectionDataset(timed, str(root / "sku110k.cache"),
                                    rebuild=True, verbose=False)
    require(len(cached) == len(evalset), "cache length")
    for i in range(0, len(evalset), 2):
        got = cached.read_batch([i, i + 1])
        # the items the cache was built from
        want = collate_detection([timed.items[i], timed.items[i + 1]])
        want["images"] = want["images"].cpu().numpy()
        for key, v in want.items():
            require(np.array_equal(got[key], v),
                    f"cached batch {i}: {key} differs from the dataset's")
    cache_row = {"seconds": time.perf_counter() - t0,
                 "read_seconds": timed.seconds,
                 "bytes": (root / "sku110k.cache").stat().st_size}
    cached.cache.close()
    emit({"phase": "data.files.cache", **cache_row})

    planos, file_clf, gallery_items = _data_files_planograms(ctx, gp)
    emit({"phase": "data.files.planograms", **planos})

    launches = {
        "nms_hard": (eval_launches["nms_hard"] + train["launches"]["nms_hard"]
                     + train["resume_launches"]["nms_hard"]
                     + planos["launches"]["nms_hard"]),
        "knn_fused": planos["launches"]["knn_fused"]}
    emit({"phase": "data.files",
          "decode_seconds_per_megapixel": photos["seconds_per_megapixel"],
          "read_seconds": {"evaluate_gln": sku_eval["read_seconds"],
                           "train": train["read_seconds"],
                           "cache": cache_row["read_seconds"],
                           "gallery": planos["gallery_read_seconds"],
                           "planograms": planos["read_seconds"]},
          "evaluate_seconds": {"evaluate_gln": sku_eval["seconds"],
                               "planograms": planos["seconds"]},
          "train_seconds": train["train_seconds"],
          "launches": launches, "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase})
    # data.jpeg reads its scenes against this catalogue; cli reads the
    # files again, and holds its commands to library calls on the items
    # GroceryProductsDataset gave here
    ctx["data_files"] = {"clf": file_clf, "canvas_kw": kw, "sku": sku,
                         "gp": gp, "gallery_items": gallery_items}
    return launches


def _data_files_train(seed, ref, sku, kw, evalset):
    """One epoch of 4 steps at batch 2 (train_proposal_generator with
    GrainLoader, an eval on the 8 photos), then the same epoch cut at
    its third batch and resumed through GrainLoader.iter_from: the
    resumed steps' losses are the uninterrupted run's. The flips are
    off: the JAX package draws them from one rng that the loader's
    threads share, in the order the threads reach it."""
    config, train_cfg = train_configs()
    out = BUILD / "data" / "train"
    trainset = _TimedReads(SKU110KDataset(sku["img_dir"], sku["ann"],
                                          flip_chance=0.0, seed=seed, **kw))
    common = dict(model_cfg=config, train_cfg=train_cfg,
                  batch_size=TRAIN_BATCH, epochs=1, checkpoint_interval=2,
                  eval_interval=1, eval_threshold=0.5, load_torch=ref,
                  seed=seed, device="cuda")
    t0 = time.perf_counter()
    _reset_launches()
    whole = train_proposal_generator(trainset, evalset, str(out / "whole"),
                                     loader_cls=GrainLoader, **common)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = _launches()
    with open(out / "whole" / "stats_0.json") as f:
        stats = json.load(f)
    steps = DATA_PHOTOS // TRAIN_BATCH
    losses = [stats[k] for k in ("class_loss", "reg_loss", "gauss_loss")]
    require(whole["state"].step == steps
            and all(len(v) == steps for v in losses),
            f"{whole['state'].step} steps on the files")
    require(np.isfinite(losses).all(), f"non-finite losses {losses}")
    require(launches["nms_hard"] >= 1, "K1 not launched in the epoch eval")

    split = out / "split"
    small = _TimedReads(evalset, DATA_RESUME_EVAL)
    saved = {}
    save_rotating = CheckpointManager.save_rotating

    def recorded(manager, state, meta):
        save_rotating(manager, state, meta)
        saved["tree"] = state.to_tree()

    try:
        with mock.patch.object(CheckpointManager, "save_rotating",
                               recorded):
            train_proposal_generator(trainset, small, str(split),
                                     loader_cls=_InterruptedGrainLoader,
                                     **common)
        require(False, "the interrupted run was not interrupted")
    except _Interrupt:
        pass
    node = check_node("data.files", split, "checkpoint", saved["tree"],
                      gln_train.init_train_state(config, train_cfg,
                                                 device="cuda"))
    meta = CheckpointManager(str(split)).load_meta()
    require((meta["epoch"], meta["iteration"], meta["epoch_step"])
            == (0, 0, 0), f"interval checkpoint at {meta}")
    _reset_launches()
    resumed = train_proposal_generator(trainset, small, str(split),
                                       resume=True, loader_cls=GrainLoader,
                                       **common)
    resume_launches = _launches()
    require(resumed["state"].step == steps,
            f"the resumed run ended at step {resumed['state'].step}")
    with open(split / "stats_0.json") as f:
        got = json.load(f)
    rel = _loss_rel(got, stats, 1)
    require(rel <= RESUME_LOSS_TOL, f"the resumed steps' losses {rel} "
            f"apart from the uninterrupted run's (> {RESUME_LOSS_TOL})")
    return {"canvas": [config.canvas_h, config.canvas_w],
            "batch": TRAIN_BATCH, "steps": steps, "losses": losses,
            "step_seconds": stats["batch_times"], "train_seconds": train_s,
            "read_seconds": trainset.seconds, "launches": launches,
            "best": whole["best"], "resumed_steps": len(got["class_loss"]),
            "resume_loss_rel": rel, "resume_launches": resume_launches,
            "resume_node": node}


def _data_files_planograms(ctx, gp):
    """The gallery read by GroceryProductsDataset, walking Training/ as
    the JAX package's eval CLI does (annotations without the extension,
    the planograms' labels), into a MACVGG Classifier with the serve
    phase's encoder; then `planogram_pass` over the scenes. Returns the
    row, the Classifier and the gallery's items by index."""
    t0 = time.perf_counter()
    gallery = GroceryProductsDataset([str(Path(gp["gp"]) / "Training")],
                                     random_crop=False,
                                     include_annotations=True)
    indexed = GroceryProductsDataset([gp["gp"]], random_crop=False,
                                     index_from_file=True)
    require(len(gallery) == DATA_GALLERY
            and sorted(gallery.paths) == sorted(indexed.paths),
            f"{len(gallery)} gallery entries; the walk and "
            "TrainingFiles.txt differ")
    timed = _TimedReads(gallery)
    serve_clf = ctx["clf"]
    clf = Classifier(serve_clf.encoder_fn, serve_clf.embedding_size,
                     sample_set=timed, k=1, device="cuda")
    torch.cuda.synchronize()
    require(clf._use_fused, "the file gallery is too small for K2")
    require(clf.annotations == gallery.annotations, "gallery annotations")
    gallery_s = time.perf_counter() - t0
    row = planogram_pass(ctx, clf, gp, gp["written"])
    # the items as a Classifier reads them (no generator image)
    items = {i: (emb, None, hierarchy, annotation)
             for i, (emb, _, hierarchy, annotation) in timed.items.items()}
    return {"gallery_entries": len(clf.embedding),
            "gallery_seconds": gallery_s,
            "gallery_read_seconds": timed.seconds, **row}, clf, items


def planogram_pass(ctx, clf, gp, pixels):
    """evaluate_planograms on PlanogramTestSet over the scene files of
    `gp` (write_gp_scenes), and the same evaluator on `pixels` ({path:
    uint8 image}) and the planograms held in memory: the compliance and
    the kept detections must be equal."""
    planoset = PlanogramTestSet(gp["test_dir"], gp["ann_dir"],
                                gp["plano_dir"])
    require(len(planoset) == len(DATA_STORES), "planogram test set size")
    memory = []
    for i, (want, (labels, boxes)) in enumerate(zip(gp["planograms"],
                                                    gp["anns"])):
        e = planoset.index[i]
        require(e["anns"] == labels and np.array_equal(e["boxes"], boxes),
                f"scene {i}: annotations read back differ")
        got = e["plano"]
        require(np.array_equal(got["boxes"], want["boxes"])
                and got["labels"] == want["labels"]
                and _same_graph(got["graph"], want["graph"]),
                f"scene {i}: the Tonioni planogram read back differs")
        path = Path(e["path"])
        memory.append((pixels[path].astype(np.float32) / 255.0,
                       labels, boxes, want))

    t0 = time.perf_counter()
    timed_scenes = _TimedReads(planoset)
    rows = {}
    for name, data in (("files", timed_scenes), ("memory", memory)):
        comparator = _RecordingComparator(device="cuda")
        _reset_launches()
        rows[name] = evaluate_planograms(
            PlanogramEvaluator(ctx["pg"], clf, comparator), data,
            verbose=False)
        torch.cuda.synchronize()
        rows[name]["launches"] = _launches()
        rows[name]["detections"] = comparator.seen
        if name == "files":
            eval_s = time.perf_counter() - t0
    files, mem = rows["files"], rows["memory"]
    for name, n in files["launches"].items():
        require(n > 0, f"{name} not launched in evaluate_planograms")
    require(files["per_image"] == mem["per_image"],
            f"compliance {files['per_image']} from the files, "
            f"{mem['per_image']} in memory")
    for i, (f, m) in enumerate(zip(files["detections"],
                                   mem["detections"])):
        require(np.array_equal(f[0], m[0]) and f[1] == m[1],
                f"scene {i}: the kept detections differ from memory's")
        require(f[3] == m[3] and (f[2] is None) == (m[2] is None)
                and (f[2] is None or np.array_equal(f[2], m[2])),
                f"scene {i}: the planogram slots found differ from "
                "memory's")
    return {"seconds": eval_s, "read_seconds": timed_scenes.seconds,
            "compliance_files": files["per_image"],
            "compliance_memory": mem["per_image"],
            "kept_detections": [len(d[0]) for d in files["detections"]],
            "paths": [d[3] for d in files["detections"]],
            "launches": files["launches"]}


# (sampling, restart interval, scans) of each SKU-110K photo of
# data.jpeg: scans "" is one interleaved scan, "progressive" SOF2 with
# libjpeg's simple progression, "components" one scan a component
DATA_JPEG_PHOTOS = (("4:2:0", 0, ""), ("4:2:0", 0, "progressive"),
                    ("4:2:0", 4, "progressive"), ("4:2:0", 0, "components"),
                    ("4:2:0", 4, ""), ("4:2:2", 0, ""), ("4:4:4", 0, ""),
                    ("grey", 0, ""))
DATA_JPEG_QUALITY = 90
# the Grocery Products catalogue of data.jpeg, one file a product in
# turn of these kinds: (label, channels, write_jpeg keyword arguments)
JPEG_CATALOGUE = 64
JPEG_CATALOGUE_KINDS = (
    ("progressive", 3, dict(progressive=True)),
    ("cmyk", 4, dict(sampling="4:4:4")),
    ("ycck", 4, dict(colour="ycck")),
    ("rgb", 3, dict(colour="rgb", sampling="4:4:4")),
    ("progressive cmyk", 4, dict(progressive=True, sampling="4:4:4")),
    ("progressive ycck", 4, dict(progressive=True, colour="ycck")),
    ("progressive rgb", 3, dict(progressive=True, colour="rgb",
                                restart_interval=2)),
    ("scan a component", 3, dict(scans="components", sampling="4:2:2")))
JPEG_EDGE_SIZES = ((1, 1), (2, 3), (17, 9), (61, 97), (33, 200))
JPEG_EDGE_SAMPLINGS = ("4:4:4", "4:2:2", "4:2:0", "4:4:0", "4:1:1", "grey")


class _JPEGWriter:
    """write(i, path, uint8 image) for the dataset writers: the i-th
    file as JPEG (testing.write_jpeg) at `samplings[i]` (sampling,
    restart interval, scans); returns (label, the coefficients written).
    `seconds` adds up the encoder's time over the writing threads."""

    def __init__(self, samplings):
        self.samplings = samplings
        self.seconds = 0.0
        self._lock = threading.Lock()

    def __call__(self, i, path, u8):
        sampling, restart, scans = self.samplings[i]
        grey = sampling == "grey"
        t0 = time.perf_counter()
        coefs = testing.write_jpeg(
            path, _grey(u8) if grey else u8, quality=DATA_JPEG_QUALITY,
            sampling="4:2:0" if grey else sampling,
            restart_interval=restart, progressive=scans == "progressive",
            scans="components" if scans == "components" else None)
        with self._lock:
            self.seconds += time.perf_counter() - t0
        return " ".join(filter(None, (sampling, scans, f"rst{restart}"
                                      if restart else ""))), coefs


def _grey(u8) -> np.ndarray:
    return np.rint(u8.astype(np.float64) @ [0.299, 0.587, 0.114]).astype(
        np.uint8)


def jpeg_exact(files: Dict) -> Dict:
    """Each file of {path: (label, coefficients written)}: the C++
    decoder's coefficients equal the encoder's, and its pixels equal
    jpeg.reconstruct_reference of them. Returns the decoded pixels (RGB,
    grey replicated) by path and the decode seconds per megapixel by
    label (one file at a time, on one thread), the decoder's g++ build
    kept out of them."""
    t0 = time.perf_counter()
    _build.load("jpeg_decode")
    build_s = time.perf_counter() - t0
    pixels, coefs, per_label = {}, {}, {}
    for path, (label, wrote) in files.items():
        data = path.read_bytes()
        t0 = time.perf_counter()
        img = jpeg.decode_jpeg(data, str(path))
        seconds = time.perf_counter() - t0
        got = jpeg.decode_coefficients(data, str(path))
        require(len(got.coefficients) == len(wrote) and all(
            np.array_equal(a, b) for a, b in zip(got.coefficients, wrote)),
            f"{path}: the coefficients decoded differ from those written")
        pixels[path], coefs[path] = img.samples, got
        acc = per_label.setdefault(label, [0.0, 0.0])
        acc[0] += seconds
        acc[1] += img.samples.shape[0] * img.samples.shape[1] / 1e6

    def plain(path):
        c = coefs[path]
        return jpeg.reconstruct_reference(c.coefficients, c.tables,
                                          c.sampling, c.size, c.colour)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        refs = dict(zip(files, pool.map(plain, files)))
    plain_s = time.perf_counter() - t0
    for path in files:
        require(np.array_equal(refs[path], pixels[path]),
                f"{path}: the C++ decode differs from reconstruct_reference")
        pixels[path] = jpeg.to_rgb(jpeg.JPEGImage(pixels[path]))
    by_feature = {}
    for label, (sec, mp) in per_label.items():
        feature = ("progressive" if "progressive" in label else
                   "scan a component" if "components" in label
                   else "baseline")
        acc = by_feature.setdefault(feature, [0.0, 0.0])
        acc[0] += sec
        acc[1] += mp
    return pixels, {
        "seconds_per_megapixel": {k: v[0] / v[1]
                                  for k, v in per_label.items()},
        "seconds_per_megapixel_by_feature": {
            k: v[0] / v[1] for k, v in by_feature.items()},
        "megapixels": {k: v[1] for k, v in per_label.items()},
        "build_seconds": build_s, "reconstruct_reference_seconds": plain_s}


def jpeg_edge_files(root: Path, seed) -> Dict:
    """Small seeded files at every edge size and sampling, restart
    intervals 0, 1 and 2 in turn and a few SOF1 frames: the C++ decode
    equals jpeg.decode_reference (the pure-Python decoder) on each, and
    its coefficients the encoder's."""
    rng = np.random.default_rng((seed, 89))
    t0 = time.perf_counter()
    cases = list(itertools.product(JPEG_EDGE_SAMPLINGS, JPEG_EDGE_SIZES))
    sof1 = 0
    for k, (sampling, (h, w)) in enumerate(cases):
        a = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        sof = 0xC1 if k % 7 == 3 else 0xC0
        sof1 += sof == 0xC1
        path = root / f"edge_{k}.jpg"
        grey = sampling == "grey"
        wrote = testing.write_jpeg(
            path, a[..., 0] if grey else a, quality=75,
            sampling="4:2:0" if grey else sampling,
            restart_interval=k % 3, sof=sof)
        data = path.read_bytes()
        got = jpeg.decode_jpeg(data, str(path)).samples
        require(np.array_equal(jpeg.decode_reference(data), got),
                f"{path} ({sampling}, {h}x{w}): the C++ decode differs "
                "from decode_reference")
        require(all(np.array_equal(x, y) for x, y in zip(
            jpeg.decode_coefficients(data).coefficients, wrote)),
            f"{path}: the coefficients decoded differ from those written")
    return {"files": len(cases), "sof1_files": sof1,
            "samplings": list(JPEG_EDGE_SAMPLINGS),
            "sizes": [list(hw) for hw in JPEG_EDGE_SIZES],
            "seconds": time.perf_counter() - t0}


def jpeg_fixtures() -> Dict:
    """The committed files of testing.JPEG_FIXTURE_DIR, which PIL and
    cv2 wrote (progressive at each sampling and with `optimize`, cv2's
    with restarts, grey progressive, CMYK, Adobe RGB, and five
    progressive files cut short, which libjpeg decodes with block
    smoothing): the port's load_image and load_image_rgba of each equal
    the digests of the JAX package's reads (PIL's convert("RGB"), cv2's
    IMREAD_UNCHANGED as RGBA) in testing.JPEG_DIGESTS."""
    root = Path(__file__).resolve().parent
    digests = json.loads((root / testing.JPEG_DIGESTS).read_text())
    t0 = time.perf_counter()
    for name, want in digests.items():
        path = root / testing.JPEG_FIXTURE_DIR / name
        for load, key, lib in ((T.load_image, "rgb", "PIL"),
                               (T.load_image_rgba, "rgba", "cv2")):
            require(testing.pixel_digest(load(path)) == want[key],
                    f"{path}: {load.__name__} differs from {lib}'s read")
    smoothed = sorted(n for n in digests if n.startswith("pil_smooth_"))
    require(len(smoothed) == 5, f"block-smoothing fixtures: {smoothed}")
    return {"files": len(digests), "names": sorted(digests),
            "block_smoothing": smoothed,
            "seconds": time.perf_counter() - t0}


def jpeg_catalogue(root: Path, seed) -> Dict:
    """JPEG_CATALOGUE products in Grocery Products' layout
    (Training/<family>/<line>/<p>.jpg, gallery images of seeded
    product styles), written in turn as each of JPEG_CATALOGUE_KINDS
    (progressive, CMYK, YCCK, RGB, one scan a component; four channels
    as (R, G, B, 255 - a darkening)); read through GroceryProductsDataset
    (load_image) and InternalTrainSet (load_image_rgba), each image
    equal to jpeg.reconstruct_reference of the coefficients written
    through to_rgb or to_rgba, and one item of each dataset taken."""
    train = root / "Grocery_products" / "Training"
    styles = synthetic.product_styles(JPEG_CATALOGUE, seed=seed + 131)
    wrote, kinds = {}, {}
    t0 = time.perf_counter()
    for p, style in enumerate(styles):
        label, channels, kw = JPEG_CATALOGUE_KINDS[
            p % len(JPEG_CATALOGUE_KINDS)]
        u8 = _quantise(synthetic.product_gallery_image(
            style, height=DATA_VIEW_HEIGHT))
        if channels == 4:
            dark = np.full(u8.shape[:2] + (1,), 255 - 17 * (p % 5),
                           np.uint8)
            u8 = np.concatenate([u8, dark], -1)
        path = train / f"{_product_path(p)}.jpg"
        path.parent.mkdir(parents=True, exist_ok=True)
        wrote[str(path)] = testing.write_jpeg(path, u8, quality=85, **kw)
        kinds[str(path)] = label
    write_s = time.perf_counter() - t0

    def plain(path):
        c = jpeg.decode_coefficients(Path(path).read_bytes(), path)
        require(all(np.array_equal(a, b) for a, b in zip(
            c.coefficients, wrote[path])),
            f"{path}: the coefficients decoded differ from those written")
        return jpeg.JPEGImage(jpeg.reconstruct_reference(
            c.coefficients, c.tables, c.sampling, c.size, c.colour))

    refs = {path: plain(path) for path in wrote}
    rows = {}
    for name, ds, to in (
            ("GroceryProductsDataset", GroceryProductsDataset(
                [str(train)], random_crop=False), jpeg.to_rgb),
            ("InternalTrainSet", InternalTrainSet(
                str(train), random_crop=False), jpeg.to_rgba)):
        require(sorted(ds.paths) == sorted(wrote),
                f"{name} indexes other files than were written")
        t0 = time.perf_counter()
        for i, path in enumerate(ds.paths):
            want = np.asarray(to(refs[path])[..., :3], np.float32) / 255.0
            require(np.array_equal(ds._load(i), want),
                    f"{path} ({kinds[path]}): {name} reads other pixels "
                    "than reconstruct_reference's")
        emb, _, _ = ds[0]
        require(tuple(emb.shape) == (256, 256, 3)
                and bool(torch.isfinite(emb).all()),
                f"{name}[0]: {tuple(emb.shape)}")
        rows[name] = {"seconds": time.perf_counter() - t0}
    return {"products": len(wrote),
            "kinds": collections.Counter(kinds.values()),
            "write_seconds": write_s, **rows}


class _MemorySKU(SKU110KDataset):
    """SKU110KDataset whose images are `pixels` ({name: uint8 RGB}),
    not the files."""

    def __init__(self, pixels, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pixels = pixels

    def load_raw(self, i):
        entry = self.index[i]
        return (self.pixels[entry["image_name"]].astype(np.float32) / 255.0,
                entry["boxes"].copy())


def phase_data_jpeg(ctx, seed, smi):
    """The readers on JPEG files, under build/chip_smoke/data/jpeg/:
    DATA_PHOTOS shelf photos of 2448x3264 in SKU-110K's layout
    (DATA_JPEG_PHOTOS: 4:2:0 at quality 90 baseline, progressive,
    progressive with a restart interval of 4 MCUs and one scan a
    component, the restart interval alone, 4:2:2, 4:4:4 and grey) and
    the 4 serve scenes as GP-180 files (4:2:0), written by
    testing.write_jpeg; every file's coefficients decoded equal to those
    written and its pixels to reconstruct_reference's; 30 small edge
    files equal to decode_reference; the committed PIL / cv2 fixtures
    against their digests (`jpeg_fixtures`); the JPEG_CATALOGUE products
    through both Grocery Products readers (`jpeg_catalogue`); then
    SKU110KDataset(device="cuda") into evaluate_gln with the serve
    detector (K1) and PlanogramTestSet with data.files' catalogue into
    evaluate_planograms (K1, K2), each held to the same pass over the
    decoded pixels in memory."""
    t_phase = time.perf_counter()
    root = BUILD / "data" / "jpeg"
    shutil.rmtree(root, ignore_errors=True)
    pg, config = ctx["pg"], ctx["pg"].config
    files_ctx = ctx["data_files"]

    t0 = time.perf_counter()
    photos_w = _JPEGWriter(DATA_JPEG_PHOTOS)
    sku = write_sku110k_files(root, seed, photos_w)
    scenes_w = _JPEGWriter((("4:2:0", 0, ""),) * len(DATA_STORES))
    gp = write_gp_scenes(root, ctx["styles"], ctx["scenes"], scenes_w)
    write_s = time.perf_counter() - t0
    files = {**sku["outs"], **{p: ("scene " + lbl, c)
                               for p, (lbl, c) in gp["outs"].items()}}
    emit({"phase": "data.jpeg.write", "root": str(root),
          "files": len(files), "quality": DATA_JPEG_QUALITY,
          "bytes": sum(p.stat().st_size for p in files),
          "encoder_seconds": photos_w.seconds + scenes_w.seconds,
          "write_seconds": write_s})

    pixels, decode = jpeg_exact(files)
    edges = jpeg_edge_files(root, seed)
    emit({"phase": "data.jpeg.exact", **decode, "edges": edges})
    fixtures = jpeg_fixtures()
    emit({"phase": "data.jpeg.fixtures", **fixtures})
    catalogue = jpeg_catalogue(root, seed)
    emit({"phase": "data.jpeg.catalogue", **catalogue})

    # SKU-110K: evaluate_gln on the files and on the pixels in memory
    kw = files_ctx["canvas_kw"]
    evalset = SKU110KDataset(sku["img_dir"], sku["ann"], flip_chance=0.0,
                             **kw)
    require([e["image_name"] for e in evalset.index]
            == list(sku["boxes"]), "SKU-110K index names")
    memset = _MemorySKU({Path(p).name: u for p, u in pixels.items()},
                        sku["img_dir"], sku["ann"], flip_chance=0.0, **kw)
    infer = make_variables_inference_fn(config, device="cuda")
    state = pg.model.state_dict()
    rows = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for name, data in (("files", _TimedReads(evalset)),
                           ("memory", memset)):
            t0 = time.perf_counter()
            _reset_launches()
            res, (targets, _, confs) = evaluate_gln(
                state, data, config, thresholds=(0.5,),
                batch_size=EVAL_BATCH, return_detections=True,
                infer_fn=infer, device="cuda")
            torch.cuda.synchronize()
            rows[name] = {
                "seconds": time.perf_counter() - t0,
                "detections": int(sum(len(c) for c in confs)),
                **{k: res[0.5][k] for k in ("ap", "ar_300", "f")},
                "launches": _launches()}
            if name == "files":
                rows[name]["read_seconds"] = data.seconds
                require(all(np.isfinite(c).all() for c in confs),
                        "non-finite scores")
        require(rows["files"]["launches"]["nms_hard"] > 0,
                "nms_hard not launched in evaluate_gln on the JPEG files")
        for key in ("ap", "ar_300", "f", "detections"):
            require(rows["files"][key] == rows["memory"][key],
                    f"evaluate_gln {key}: {rows['files'][key]} from the "
                    f"JPEG files, {rows['memory'][key]} in memory")
        emit({"phase": "data.jpeg.sku110k", **rows})
        planos = planogram_pass(ctx, files_ctx["clf"], gp, pixels)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit({"phase": "data.jpeg.planograms", **planos})

    ctx["data_jpeg"] = {"sku": {"img_dir": sku["img_dir"],
                                "ann": sku["ann"]}}
    sku_launches = rows["files"]["launches"]
    launches = {
        "nms_hard": (sku_launches["nms_hard"]
                     + planos["launches"]["nms_hard"]),
        "knn_fused": planos["launches"]["knn_fused"]}
    emit({"phase": "data.jpeg",
          "decode_seconds_per_megapixel": decode["seconds_per_megapixel"],
          "decode_seconds_per_megapixel_by_feature":
              decode["seconds_per_megapixel_by_feature"],
          "fixtures": fixtures["files"],
          "catalogue": catalogue["products"],
          "encoder_seconds": photos_w.seconds + scenes_w.seconds,
          "launches": launches, "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase})
    return launches


# ------------------------------------------------------------- data.video

# GroZi-120's test layout: two Motion-JPEG videos of VIDEO_FRAMES frames
# at VIDEO_HW, written by the port's encoder (no DHT, as MJPEG frames
# store them), and VIDEO_INTEREST annotated frames in each, the second
# video's last one past its end
VIDEO_FRAMES = 90
VIDEO_HW = (480, 640)
VIDEO_INTEREST = 10


def phase_data_video(ctx, seed, smi):
    """GroZi-120's test frames out of its videos, under
    build/chip_smoke/data/grozi/: the layout written by
    testing.write_grozi_videos; the first video demuxed and decoded by
    data/avi.py, every frame equal to the port's decode of the JPEG
    written; `cvpce-torch datasets grozi extract-test-images` in this
    process, its missing-frame line and index.txt the frames of interest
    in the JAX package's order, each extracted file the port's encode of
    the port's decode of its AVI frame, byte for byte, and so decoding to
    the same pixels; GroZiTestSet over the frames, each served through
    the serve detector's ProposalGenerator.detect (K1 once a frame,
    finite results). Returns the launches."""
    t_phase = time.perf_counter()
    root = BUILD / "data" / "grozi"
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(seed + 211)
    videos = {v: testing.smooth_frames(rng, VIDEO_FRAMES, *VIDEO_HW)
              for v in (1, 2)}
    interest = {v: sorted(int(f) for f in rng.choice(
        VIDEO_FRAMES, VIDEO_INTEREST, replace=False)) for v in (1, 2)}
    interest[2][-1] = VIDEO_FRAMES + 5
    t0 = time.perf_counter()
    encoded = testing.write_grozi_videos(str(root), videos, interest, rng)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for frame in videos[1]:
        jpeg.encode_jpeg(frame)
    encode_s = (time.perf_counter() - t0) / VIDEO_FRAMES

    t0 = time.perf_counter()
    decoded = list(avi.open_avi(root / "video" / "Shelf_1.avi").frames())
    demux_s = (time.perf_counter() - t0) / max(len(decoded), 1)
    require(len(decoded) == VIDEO_FRAMES,
            f"Shelf_1.avi: {len(decoded)} frames, not {VIDEO_FRAMES}")
    for f, (got, data) in enumerate(zip(decoded, encoded[1])):
        require(np.array_equal(got, jpeg.decode_jpeg(data).samples),
                f"Shelf_1.avi frame {f} differs from its JPEG's decode")

    text, extract_s, launches = _cli(["datasets", "grozi",
                                      "extract-test-images", "--root", root])
    require(not any(launches.values()), "extraction launched a kernel")
    order: Dict[int, set] = {}
    for _, v, f, *_ in grozi.iter_grozi_annotations(str(root)):
        order.setdefault(v, set()).add(f)
    want_index = [grozi.extracted_img_name(v, f) for v, frames in
                  order.items() for f in sorted(frames) if f < VIDEO_FRAMES]
    want_text = "".join(
        f"Not all frames extracted from video {v}: missing "
        f"{sorted(f for f in frames if f >= VIDEO_FRAMES)[:10]}...\n"
        for v, frames in order.items() if max(frames) >= VIDEO_FRAMES)
    require(text == want_text, f"extract-test-images printed {text!r}")
    index = (root / "extracted" / "index.txt").read_text().split()
    require(index == want_index, f"index.txt {index} != {want_index}")
    require(len(index) == 2 * VIDEO_INTEREST - 1, "frames extracted")
    for name in index:
        v, f = (int(s) for s in name[:-4].split("_"))
        frame = jpeg.decode_jpeg(encoded[v][f]).samples
        data = (root / "extracted" / name).read_bytes()
        require(data == jpeg.encode_jpeg(frame),
                f"{name}: not the port's encode of its AVI frame")
        require(np.array_equal(jpeg.decode_jpeg(data).samples,
                               jpeg.decode_jpeg(jpeg.encode_jpeg(
                                   frame)).samples), f"{name}: pixels")

    testset = grozi.GroZiTestSet(str(root))
    require([Path(e["path"]).name for e in testset.index] == index,
            "GroZiTestSet's frames")
    boxes = sum(len(e["boxes"]) for e in testset.index)
    pg = ctx["pg"]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _reset_launches()
        t0 = time.perf_counter()
        dets = [pg.detect(testset[i][0]) for i in range(len(testset))]
        torch.cuda.synchronize()
        detect_s = time.perf_counter() - t0
        launches = _launches()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    require(launches["nms_hard"] == len(testset),
            f"nms_hard launched {launches['nms_hard']} times on "
            f"{len(testset)} frames")
    require(launches["knn_fused"] == 0, "knn_fused launched in detect")
    for d in dets:
        require(np.isfinite(d["scores"]).all()
                and np.isfinite(d["boxes"]).all()
                and d["boxes"].shape[1:] == (4,), "non-finite detections")
    emit({"phase": "data.video", "root": str(root), "videos": len(videos),
          "frames_per_video": VIDEO_FRAMES, "frame_hw": list(VIDEO_HW),
          "frames": len(index), "annotated_boxes": boxes,
          "missing": text.strip(),
          "write_seconds": write_s,
          "demux_decode_seconds_per_frame": demux_s,
          "encode_seconds_per_frame": encode_s,
          "extract_seconds": extract_s, "detect_seconds": detect_s,
          "valid_detections": int(sum(int(d["valid"].sum()) for d in dets)),
          "launches": launches, "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase})
    shutil.rmtree(root, ignore_errors=True)
    return launches


# --------------------------------------------------------------------- cli

def _cli(argv):
    """`cvpce-torch argv` in this process, so that the kernels' launch
    counters see it: (stdout, host seconds ending in a synchronise,
    launches)."""
    out = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main([str(a) for a in argv])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(rc == 0, f"cvpce-torch {' '.join(map(str, argv[:2]))}: rc {rc}")
    return out.getvalue(), seconds, _launches()


def _library(fn):
    """fn() with its progress lines swallowed: (result, launches)."""
    _reset_launches()
    with contextlib.redirect_stdout(io.StringIO()):
        res = fn()
    torch.cuda.synchronize()
    return res, _launches()


def _library_text(fn):
    """fn()'s printed text and launches, its result dropped."""
    _reset_launches()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    torch.cuda.synchronize()
    return out.getvalue(), _launches()


def _printed_json(stdout: str) -> str:
    """The JSON object a command printed last, after its progress
    lines."""
    lines = stdout.rstrip("\n").splitlines()
    start = max(i for i, ln in enumerate(lines) if ln.startswith("{"))
    return "\n".join(lines[start:])


def _metrics_json(res) -> dict:
    return {str(t): {k: float(v) for k, v in d.items() if k != "raw"}
            for t, d in res.items()}


def _nan_to_none(obj):
    if isinstance(obj, dict):
        return {k: _nan_to_none(v) for k, v in obj.items()}
    return None if isinstance(obj, float) and obj != obj else obj


class _TanhFolder:
    """SimpleFolderSet items in the classifier's tanh scale."""

    def __init__(self, base):
        self.base = base

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        img, gen, c1, c2 = self.base[i]
        return T.scale_to_tanh(img), T.scale_to_tanh(gen), c1, c2


def _cli_files(root: Path, ctx, seed):
    """The serve detector as the port's GLN checkpoint with its serving
    calibration beside it (threshold and input norm, read by
    --confidence auto), the serve embedder in train_dihe's checkpoint
    layout, a pipeline-demo folder gallery and planogram for the first
    scene, and a COCO `instances` JSON for the SKU-110K photos. The
    embedder is a `torch.save` file, the layout of the port's runs
    before their nodes became orbax directories, which the loaders
    still read."""
    pg, sku = ctx["pg"], ctx["data_files"]["sku"]
    gp = ctx["data_files"]["gp"]
    weights_dir = root / "serve_gln"
    state = gln_train.init_train_state(
        pg.config, gln_train.GLNTrainConfig(), seed,
        state_dict={k: v.detach().cpu()
                    for k, v in pg.model.state_dict().items()},
        device="cuda")
    CheckpointManager(str(weights_dir)).save_named(state, "checkpoint",
                                                   {"epoch": 0})
    del state
    save_calibration(str(weights_dir), {
        "threshold": pg.confidence_threshold, "input_norm": pg.input_norm})
    embedder = root / "embedder_checkpoint"
    torch.save({"embedder": {k: v.detach().cpu() for k, v in
                             ctx["vgg"].state_dict().items()}, "step": 0},
               embedder)

    # pipeline-demo: scene 0, one gallery image per product named by its
    # label, and the scene's planogram in its own coordinates
    folder = root / "demo_gallery"
    folder.mkdir()
    plano = ctx["scenes"][0][1]
    by_label = {s["label"]: i for i, s in enumerate(ctx["styles"])}
    for label in sorted(set(plano["labels"])):
        product = _product_path(by_label[label])
        shutil.copyfile(Path(gp["gp"]) / "Training" / f"{product}.jpg",
                        folder / f"{label}.png")
    demo_plano = root / "demo_planogram.json"
    demo_plano.write_text(json.dumps(
        [{"label": lb, "box": [float(c) for c in b]}
         for lb, b in zip(plano["labels"], plano["boxes"])]))

    h, w = DATA_PHOTO_HW
    images, anns = [], []
    for k, (name, boxes) in enumerate(sorted(sku["boxes"].items())):
        images.append({"id": k + 1, "file_name": name, "width": w,
                       "height": h})
        anns += [{"image_id": k + 1, "category_id": 1,
                  "bbox": [int(x1), int(y1), int(x2 - x1), int(y2 - y1)]}
                 for x1, y1, x2, y2 in boxes]
    instances = root / "instances_sku110k.json"
    instances.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "object"}]}))
    scene = Path(gp["test_dir"]) / "store1" / "images" / "store1_1.jpg"
    return {"weights": str(weights_dir / "checkpoint"),
            "calibration_dir": str(weights_dir), "embedder": str(embedder),
            "folder": str(folder), "demo_plano": str(demo_plano),
            "instances": str(instances), "scene": str(scene),
            "photo": str(sorted(sku["written"])[0])}


def phase_cli(ctx, seed, ref, smi):
    """The command line (cvpce_tpu_torch/cli) at full width, called in
    this process through `main(argv)`, on data.files' photos, catalogue
    and scenes: each command's output held against the port's library
    calls with the same arguments on the card (JSON text bit for bit;
    K1 and K2 launches equal), then `gln detect` once more through
    `python3 -m cvpce_tpu_torch.cli` in a fresh process."""
    t_phase = time.perf_counter()
    root = BUILD / "cli"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    sku, gp = ctx["data_files"]["sku"], ctx["data_files"]["gp"]
    f = _cli_files(root, ctx, seed)
    W, E = f["weights"], f["embedder"]
    threshold = resolve_threshold("auto", f["calibration_dir"])
    norm = resolve_input_norm(f["calibration_dir"])
    require(calibration_dir_for_weights(W) == f["calibration_dir"]
            and threshold == ctx["pg"].confidence_threshold
            and norm == ctx["pg"].input_norm,
            "--confidence auto does not read the serve calibration")
    config = GLNConfig()
    # misc's commands cut the candidates and detections to the canvas's
    # stride-8 cells; at 832x1344 that is GLNConfig()'s 5120 and 1000
    cells = (config.canvas_h // 8) * (config.canvas_w // 8)
    misc_config = dataclasses.replace(
        config, max_nms_candidates=min(5120, cells),
        detections_per_img=min(1000, cells))
    rows = {}

    def held(name, seconds, launches, text, want, lib_launches):
        require(text == want, f"{name}: the command printed\n{text[:2000]}"
                f"\nthe library gives\n{want[:2000]}")
        require(launches == lib_launches,
                f"{name}: launches {launches}, the library's "
                f"{lib_launches}")
        rows[name] = {"seconds": seconds, "launches": launches}

    # gln detect, before cuDNN is made deterministic: its output is held
    # again against a fresh process's, which runs cuDNN's defaults
    detect_argv = ["gln", "detect", f["photo"], "--weights", W]
    out, s, ln = _cli(detect_argv)

    def detect():
        gen = ProposalGenerator(load_gln_state_dict(W, config), config,
                                confidence_threshold=0.5,
                                input_norm=norm, device="cuda")
        res = gen.detect(T.load_image(f["photo"]))
        keep = res["valid"] & (res["scores"] > 0.5)
        lines = [f"{int(keep.sum())} detections over 0.5"]
        lines += [f"  {sc:.3f} {np.round(b, 1).tolist()}" for b, sc in
                  zip(res["boxes"][keep][:20], res["scores"][keep][:20])]
        return "\n".join(lines) + "\n"
    want, lib = _library(detect)
    held("gln detect", s, ln, out, want, lib)
    require(int(out.split()[0]) > 0, "gln detect found nothing")
    detect_out = out

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # gln eval on the SKU-110K photos and the GP-180 scenes
        sku_args = ["--imgs", sku["img_dir"], "--annotations", sku["ann"]]

        def sku_set():
            return SKU110KDataset(sku["img_dir"], sku["ann"],
                                  skip=defaults.SKU110K_SKIP,
                                  flip_chance=0.0, canvas_h=config.canvas_h,
                                  canvas_w=config.canvas_w, device="cuda")

        def gln_eval(state_dict, dataset):
            return json.dumps(_metrics_json(evaluate_gln(
                state_dict, dataset, config, thresholds=(0.5,),
                batch_size=EVAL_BATCH, device="cuda")), indent=2)

        out, s, ln = _cli(["gln", "eval", *sku_args, "--weights", W])
        want, lib = _library(lambda: gln_eval(
            load_gln_state_dict(W, config), sku_set()))
        held("gln eval sku110k", s, ln, _printed_json(out), want, lib)
        out, s, ln = _cli(["gln", "eval", "--dataset-type", "gp180",
                           "--imgs", gp["test_dir"], "--annotations",
                           gp["ann_dir"], "--weights", W])
        want, lib = _library(lambda: gln_eval(
            load_gln_state_dict(W, config), DetectionEvalAdapter(
                GroceryProductsTestSet(gp["test_dir"], gp["ann_dir"]),
                lambda it: (it[0], it[2]), config.canvas_h,
                config.canvas_w, device="cuda")))
        held("gln eval gp180", s, ln, _printed_json(out), want, lib)

        # gln train, then gln eval on the epoch checkpoint it wrote
        run = root / "train"
        returned = {}
        train = train_loops.train_proposal_generator

        def keep_state(*args, **kwargs):
            returned.update(train(*args, **kwargs))
            return returned
        with mock.patch.object(train_loops, "train_proposal_generator",
                               keep_state):
            _, s, ln = _cli(["gln", "train", *sku_args, "--out", run,
                             "--epochs", 1, "--batch-size", TRAIN_BATCH,
                             "--load", ref, "--tanh", "--method", "simple",
                             "--hyperopt-params"])
        rows["gln train"] = {"seconds": s, "launches": ln}
        with open(run / "stats_0.json") as fh:
            step_s = json.load(fh)["batch_times"]
        steps = DATA_PHOTOS // TRAIN_BATCH
        require(returned["state"].step == steps and len(step_s) == steps,
                f"gln train took {returned['state'].step} steps")
        require(ln["nms_hard"] >= 1, "K1 not launched in gln train's eval")
        out, s, ln = _cli(["gln", "eval", *sku_args, "--weights",
                           run / "epoch_0"])
        want, lib = _library(lambda: gln_eval(
            returned["state"].model.state_dict(), sku_set()))
        held("gln eval epoch_0", s, ln, _printed_json(out), want, lib)
        # the run directory and its serving export load as its state
        export = root / "gln_export"
        export_gln_serving(str(run), str(export))
        require(load_serving_meta(str(export))
                == CheckpointManager(str(run)).load_meta(),
                "the export's meta is not the run's")
        for name, weights in (("gln eval <run dir>", run),
                              ("gln eval <serving export>", export)):
            out, s, ln = _cli(["gln", "eval", *sku_args, "--weights",
                               weights])
            held(name, s, ln, _printed_json(out), want, lib)
        del returned["state"]
        shutil.rmtree(run, ignore_errors=True)

        # the pipeline commands against one library pipeline
        t0 = time.perf_counter()
        training = str(Path(gp["gp"]) / "Training")
        # the catalogue's items as data.files read them through
        # GroceryProductsDataset([training], random_crop=False,
        # include_annotations=True), each once
        kept = ctx["data_files"].pop("gallery_items")
        items = [kept[i] for i in range(len(kept))]
        del kept
        require(len(items) == DATA_GALLERY, "gallery items kept")
        encoder, size = load_embedder(E, device="cuda")
        # verbose, as `dihe prebuild-index` builds: cli.dihe holds the
        # command's lines and index files to these
        built = io.StringIO()
        with contextlib.redirect_stdout(built):
            lib_clf = Classifier(encoder, size, items, verbose=True,
                                 device="cuda")
        lib_pg = ProposalGenerator(load_gln_state_dict(W, config), config,
                                   confidence_threshold=threshold,
                                   input_norm=norm, device="cuda")
        index = root / "index_f32.npz"
        lib_clf.save_index(str(index))
        fast_config = GLNConfig(compute_dtype="bfloat16")
        encoder8, _ = load_embedder(E, int8=True, device="cuda")
        index8 = root / "index_int8.npz"
        built8 = io.StringIO()
        with contextlib.redirect_stdout(built8):
            Classifier(encoder8, size, items, verbose=True,
                       device="cuda").save_index(str(index8))
        library_s = time.perf_counter() - t0
        pipe = ["--gln-weights", W, "--encoder-weights", E, "--source",
                training, "--test-imgs", gp["test_dir"],
                "--test-annotations", gp["ann_dir"]]
        planos = ["eval-planograms", *pipe, "--planograms", gp["plano_dir"],
                  "--verbose"]

        def planograms(gen, clf):
            return json.dumps(evaluate_planograms(
                PlanogramEvaluator(gen, clf,
                                   PlanogramComparator(device="cuda")),
                PlanogramTestSet(gp["test_dir"], gp["ann_dir"],
                                 gp["plano_dir"])), indent=2)

        want_planos, lib = _library(lambda: planograms(lib_pg, lib_clf))
        for name, extra in (("eval-planograms", []),
                            ("eval-planograms --index", ["--index",
                                                         index])):
            out, s, ln = _cli(planos + extra)
            held(name, s, ln, _printed_json(out), want_planos, lib)
            require(ln["knn_fused"] > 0, f"{name}: K2 not launched")

        out, s, ln = _cli(planos + ["--fast", "--index", index8])

        def fast():
            enc, _ = load_embedder(E, int8=True, device="cuda")
            gen = ProposalGenerator(load_gln_state_dict(W, fast_config),
                                    fast_config,
                                    confidence_threshold=threshold,
                                    input_norm=norm, device="cuda")
            return planograms(gen, Classifier(enc, size, load=str(index8),
                                              device="cuda"))
        want, lib = _library(fast)
        held("eval-planograms --fast", s, ln, _printed_json(out), want,
             lib)

        out, s, ln = _cli(["eval-product-detection", *pipe, "--index",
                           index])

        def product_detection():
            per_class, overall = evaluate_detections(
                lib_pg, lib_clf,
                GroceryProductsTestSet(gp["test_dir"], gp["ann_dir"]),
                thresholds=(0.5,))
            mam = mean_average_metrics(per_class, (0.5,))
            return json.dumps({
                "overall": {str(t): {k: float(v) for k, v in d.items()}
                            for t, d in overall.items()},
                "mean": {str(t): d for t, d in mam.items()}}, indent=2)
        want, lib = _library(product_detection)
        held("eval-product-detection", s, ln, _printed_json(out), want,
             lib)
        require(ln["knn_fused"] > 0, "eval-product-detection: K2 not "
                "launched")

        # misc
        out, s, ln = _cli(["misc", "pipeline-demo", f["scene"], "--gallery",
                           f["folder"], "--planogram", f["demo_plano"],
                           "--gln-weights", W, "--encoder-weights", E])

        def demo():
            clf = Classifier(encoder, size, _TanhFolder(
                SimpleFolderSet(f["folder"])), device="cuda")
            with open(f["demo_plano"]) as fh:
                spec = json.load(fh)
            plano = {"boxes": np.asarray([e["box"] for e in spec],
                                         np.float32),
                     "labels": [e["label"] for e in spec]}
            gen = ProposalGenerator(load_gln_state_dict(W, misc_config),
                                    misc_config,
                                    confidence_threshold=threshold,
                                    input_norm=norm, device="cuda")
            score = PlanogramEvaluator(
                gen, clf, PlanogramComparator(device="cuda")).evaluate(
                    T.load_image(f["scene"]), plano)
            return json.dumps({"compliance": float(score)})
        want, lib = _library(demo)
        held("misc pipeline-demo", s, ln, _printed_json(out), want, lib)

        out, s, ln = _cli(["misc", "retinanet-coco-test", "--imgs",
                           sku["img_dir"], "--annotations", f["instances"],
                           "--weights", W])

        def coco():
            base = CocoDetectionDataset(sku["img_dir"], f["instances"])
            adapter = DetectionEvalAdapter(
                base, lambda it: (it[0], it[1]["boxes"]), config.canvas_h,
                config.canvas_w, device="cuda")
            res, (tgts, preds, confs) = evaluate_gln(
                load_gln_state_dict(W, misc_config), adapter, misc_config,
                thresholds=(0.5,), return_detections=True, device="cuda")
            referee = evaluate_coco_protocol({None: [
                ImageDetections(p, c, t)
                for t, p, c in zip(tgts, preds, confs)]})
            return json.dumps(_nan_to_none({
                "reference_protocol": _metrics_json(res),
                "coco_protocol": {k: v for k, v in referee.items()
                                  if k != "per_threshold"}}), indent=2)
        want, lib = _library(coco)
        held("misc retinanet-coco-test", s, ln, _printed_json(out), want,
             lib)

        # a drawing command: matplotlib first, before any model
        _reset_launches()
        t0 = time.perf_counter()
        try:
            cli_main(["rebuild-scene", *pipe, f["scene"], "--out",
                      str(root / "rebuilt.png")])
            drew = True
        except ModuleNotFoundError as e:
            require("matplotlib" in str(e), f"rebuild-scene raised {e!r}")
            drew = False
        require(drew == viz.available(),
                "rebuild-scene drew without matplotlib, or failed with it")
        rows["rebuild-scene"] = {"seconds": time.perf_counter() - t0,
                                 "launches": _launches(), "drew": drew}
        require(drew or _launches()["nms_hard"] == 0,
                "rebuild-scene ran the detector before failing")

        # the module entry point in a fresh process
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cvpce_tpu_torch.cli", *detect_argv],
            cwd=Path(__file__).resolve().parent, capture_output=True,
            text=True, timeout=600)
        require(proc.returncode == 0 and proc.stdout == detect_out,
                f"python3 -m cvpce_tpu_torch.cli gln detect: rc "
                f"{proc.returncode}\n{proc.stdout[:1500]}\nin this process"
                f"\n{detect_out[:1500]}\n{proc.stderr[-3000:]}")
        rows["python3 -m cvpce_tpu_torch.cli gln detect"] = {
            "seconds": time.perf_counter() - t0}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    for name in ("gln detect", "gln eval sku110k", "gln eval gp180",
                 "gln eval epoch_0", "gln eval <run dir>",
                 "gln eval <serving export>", "eval-planograms",
                 "eval-product-detection", "misc pipeline-demo",
                 "misc retinanet-coco-test"):
        require(rows[name]["launches"]["nms_hard"] > 0,
                f"{name}: K1 not launched")
    launches = {k: {name: r["launches"][k] for name, r in rows.items()
                    if "launches" in r}
                for k in ("nms_hard", "knn_fused")}
    emit({"phase": "cli", "commands": rows,
          "train_step_median_seconds": statistics.median(step_s[1:]),
          "train_step_seconds": step_s,
          "library_gallery_seconds": library_s, "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase})
    ctx["cli"] = {"root": root, "gln": W, "embedder": E, "items": items,
                  "index": (index, built.getvalue()),
                  "index_int8": (index8, built8.getvalue())}
    return launches


# ---------------------------------------------------------------- cli.dihe

DIHE_CLI_ITEMS = 32  # the catalogue's products that the training commands see
DIHE_CLI_STEP = DATA_GALLERY // DIHE_CLI_ITEMS


def _same_checkpoint(run_a: Path, run_b: Path, name: str) -> None:
    """Two runs' orbax train-state nodes `name` with the same leaves,
    bit for bit (the command's and the library's training runs: the
    same seeds, cuDNN deterministic, the loader on one thread)."""
    _same_tree_bits(orbax_read.restore(str(run_a / name)),
                    orbax_read.restore(str(run_b / name)), name)


def _dihe_cli_files(root: Path, gp, seed) -> Dict:
    """A DIHE_CLI_ITEMS-product slice of the catalogue (every
    DIHE_CLI_STEP-th product, its hierarchy kept) for the training
    commands, a Grocery Products download renamed to food_<n>.jpg for
    `gp fix`, and an internal trainset of RGBA products for `internal
    iter-train`."""
    small = root / "dihe_gallery" / "Training"
    for p in range(0, DATA_GALLERY, DIHE_CLI_STEP):
        product = f"{_product_path(p)}.jpg"
        (small / product).parent.mkdir(parents=True, exist_ok=True)
        shutil.copyfile(Path(gp["gp"]) / "Training" / product,
                        small / product)
    renamed = root / "renamed"
    for d, n in (("Food/Bakery", 5), ("Food/Dairy", 3), ("Drinks", 2)):
        (renamed / d).mkdir(parents=True)
        for i in range(n):
            (renamed / d / f"food_{i + 1}.jpg").write_bytes(b"%d" % i)
    internal = root / "internal"
    rng = np.random.default_rng(seed + 61)
    for code in range(8):
        face = internal / "Shelf" / str(code % 2) / ("front", "back")[
            code % 2 == 0 and code > 3]
        face.mkdir(parents=True, exist_ok=True)
        rgba = np.zeros((60, 44, 4), np.uint8)
        rgba[2:-2, 3:-3, :3] = rng.integers(0, 255, (56, 38, 3))
        rgba[2:-2, 3:-3, 3] = 255
        testing.write_png(face / f"{1000 + code}.png", rgba)
    return {"small": str(small), "renamed": str(renamed),
            "internal": str(internal)}


def _iter_lines(n, failures) -> str:
    """What the `iter` commands print over n items, `failures` the
    (index, line) of those that failed."""
    failed = dict(failures)
    lines = []
    for i in range(n):
        if i in failed:
            lines.append(failed[i])
        if i % 100 == 0:
            lines.append(f"{i}/{n}")
    return "".join(line + "\n" for line in lines)


def _fix_dry_run_lines(source: str, out: str) -> str:
    """`gp fix --dry-run`'s lines, walked independently: each directory's
    food_<n>.jpg files by n, the first dropped, the rest renamed 1.jpg
    on; directories in the command's stack order."""
    import os
    import re

    lines, stack = [], [(source, [])]
    while stack:
        cur, hier = stack.pop()
        entries = list(os.scandir(cur))
        stack += [(e.path, hier + [e.name]) for e in entries if e.is_dir()]
        numbered = sorted((int(m.group(1)), e.path) for e in entries
                          if (m := re.match(r"food_(\d+).jpg", e.name)))
        # the reference's names: 1.jpg.. sorted as strings
        names = sorted(f"{i}.jpg" for i in range(1, len(numbered)))
        for (_, src), name in zip(numbered[1:], names):
            lines.append(f"{src} -> {os.path.join(out, *hier, name)}")
    return "".join(line + "\n" for line in lines) + "(dry run) done, 0 files\n"


def phase_cli_dihe(ctx, seed, smi):
    """The `dihe` and `datasets` command groups and the serving exports
    (cvpce_tpu_torch/cli/{dihe,datasets}.py, pipeline/serving.py) in this
    process on data.files' catalogue (4096 products, DIHE at 256x256),
    scenes and photos, each held to the port's library calls with the
    same arguments on the card (printed text and index files bit for
    bit, K2 launches equal): prebuild-index (f32, --int8) against the
    cli phase's library indexes; eval from the folders, --index and
    --int8 --index; pretrain-gan and train --gan on a 32-product slice
    at batch 4 (checkpoints equal to the library's); the
    train run's serving export; hyperopt (2 trials); the host-only
    datasets commands against the readers; and the drawing commands,
    which must fail on the missing matplotlib within a second."""
    t_phase = time.perf_counter()
    keep = ctx.pop("cli")
    root, E = keep["root"], keep["embedder"]
    sku, gp = ctx["data_files"]["sku"], ctx["data_files"]["gp"]
    training = str(Path(gp["gp"]) / "Training")
    f = _dihe_cli_files(root, gp, seed)
    rows = {}

    def held(name, seconds, launches, text, want, lib_launches):
        require(text == want, f"{name}: the command printed\n{text[:2000]}"
                f"\nthe library gives\n{want[:2000]}")
        require(launches == lib_launches,
                f"{name}: launches {launches}, the library's "
                f"{lib_launches}")
        rows[name] = {"seconds": seconds, "launches": launches}

    test = ["--test-imgs", gp["test_dir"], "--test-annotations",
            gp["ann_dir"]]
    # the discriminator's crops come from data.jpeg's photos, which
    # decode in about half the PNGs' time (each crop decodes its photo)
    jpeg_sku = ctx["data_jpeg"]["sku"]
    targets = ["--imgs", jpeg_sku["img_dir"], "--annotations",
               jpeg_sku["ann"]]
    testset = GroceryProductsTestSet(gp["test_dir"], gp["ann_dir"])
    encoder, size = load_embedder(E, device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # prebuild-index against the cli phase's library indexes, built
        # from the same catalogue items with the same batch size
        for name, extra, (lib_index, lib_text) in (
                ("dihe prebuild-index", [], keep["index"]),
                ("dihe prebuild-index --int8", ["--int8"],
                 keep["index_int8"])):
            out_path = root / f"cli_{lib_index.name}"
            out, s, ln = _cli(["dihe", "prebuild-index", "--source",
                               training, "--weights", E, "--out", out_path,
                               *extra])
            held(name, s, ln, out, lib_text + f"index with {DATA_GALLERY} "
                 f"entries -> {out_path}\n", {k: 0 for k in ln})
            got, want = (np.load(p, allow_pickle=True)
                         for p in (out_path, lib_index))
            require(sorted(got.files) == sorted(want.files), name)
            for key in want.files:
                require(np.array_equal(got[key], want[key]),
                        f"{name}: {key} differs from the library's")

        # eval from the folders, --index and --int8 --index
        def lib_eval(enc, items=None, index=None):
            return json.dumps({str(k): v for k, v in eval_dihe(
                enc, size, items, testset, batch_size=32, k=(1, 5),
                load_index=index, device="cuda").items()})

        items = keep.pop("items")
        base = ["dihe", "eval", "--source", training, *test, "--weights", E]
        out, s, ln = _cli(base)
        want, lib = _library(lambda: lib_eval(encoder, items=items))
        held("dihe eval", s, ln, _printed_json(out), want, lib)
        del items
        index, index8 = keep["index"][0], keep["index_int8"][0]
        out, s, ln = _cli(base + ["--index", index])
        want, lib = _library(lambda: lib_eval(encoder, index=str(index)))
        held("dihe eval --index", s, ln, _printed_json(out), want, lib)
        out, s, ln = _cli(base + ["--int8", "--index", index8])
        want, lib = _library(lambda: lib_eval(
            load_embedder(E, int8=True, device="cuda")[0],
            index=str(index8)))
        held("dihe eval --int8 --index", s, ln, _printed_json(out), want,
             lib)
        for name in ("dihe eval", "dihe eval --index",
                     "dihe eval --int8 --index"):
            require(rows[name]["launches"]["knn_fused"] > 0,
                    f"{name}: K2 not launched")

        # pretrain-gan, then train --gan, on the catalogue slice, the
        # loader on one thread: the gallery's random crops draw from one
        # rng in the order the pool's threads fetch the items
        one_thread = mock.patch.object(
            PrefetchLoader, "__init__", functools.partialmethod(
                PrefetchLoader.__init__, num_threads=1))
        one_thread.start()
        small = f["small"]
        gan_cli, gan_lib = root / "gan_cli", root / "gan_lib"
        out, s, ln = _cli(["dihe", "pretrain-gan", "--source", small,
                           *targets, "--out", gan_cli, "--epochs", 1,
                           "--batch-size", DIHE_BATCH])

        def discset():
            return TargetDomainDataset(jpeg_sku["img_dir"], jpeg_sku["ann"],
                                       skip=defaults.SKU110K_SKIP)

        def gallery(**kw):
            return GroceryProductsDataset([small], **kw)
        want, lib = _library_text(lambda: train_loops.pretrain_gan(
            gallery(), discset(), str(gan_lib), epochs=1,
            batch_size=DIHE_BATCH, device="cuda"))
        held("dihe pretrain-gan", s, ln, out, want, lib)
        _same_checkpoint(gan_cli, gan_lib, "gan_checkpoint")

        run_cli, run_lib = root / "dihe_cli", root / "dihe_lib"
        out, s, ln = _cli(["dihe", "train", "--source", small, *targets,
                           *test, "--out", run_cli, "--gan", gan_cli,
                           "--epochs", 1, "--batch-size", DIHE_BATCH])

        def train():
            data = gallery(include_annotations=True)
            return train_loops.train_dihe(
                data, discset(), data, GroceryProductsTestSet(
                    gp["test_dir"], gp["ann_dir"],
                    only=defaults.GP_TEST_VALIDATION_SET_SIZE),
                str(run_lib), gan_state=load_gan_state(str(gan_cli)),
                epochs=1, batch_size=DIHE_BATCH,
                train_cfg=dihe_train.DIHETrainConfig(), device="cuda")
        want, lib = _library_text(train)
        held("dihe train --gan", s, ln, out, want, lib)
        require("epoch 0: top-1 accuracy" in out, "dihe train: no eval")
        for name in ("embedder_checkpoint", "epoch_0"):
            _same_checkpoint(run_cli, run_lib, name)
        one_thread.stop()

        # the run directory and its serving export serve the same encoder
        export = root / "dihe_export"
        export_dihe_serving(str(run_cli), str(export))
        small_eval = ["dihe", "eval", "--source", small, *test]
        enc_run, _ = load_embedder(str(run_cli / "embedder_checkpoint"),
                                   device="cuda")
        want, lib = _library(lambda: json.dumps({
            str(k): v for k, v in eval_dihe(
                enc_run, size, gallery(random_crop=False,
                                       include_annotations=True),
                testset, batch_size=32, k=(1, 5),
                device="cuda").items()}))
        for name, weights in (("dihe eval --weights <run dir>", run_cli),
                              ("dihe eval --weights <serving export>",
                               export)):
            out, s, ln = _cli(small_eval + ["--weights", weights])
            held(name, s, ln, _printed_json(out), want, lib)

        # hyperopt: 2 one-epoch trials, each trial's metric its epoch_0
        # embedder's top-1 accuracy (the loop's epoch eval)
        search = root / "hyperopt"
        out, s, ln = _cli(["dihe", "hyperopt", "--source", small, *targets,
                           *test, "--out", search, "--trials", 2,
                           "--max-epochs", 1, "--batch-size", DIHE_BATCH])
        rows["dihe hyperopt"] = {"seconds": s, "launches": ln}
        result = json.loads((search / "hyperopt_result.json").read_text())
        require(json.loads(_printed_json(out)) == result,
                "dihe hyperopt: printed JSON is not the result file")
        trials = json.loads((search / "search_state.json").read_text())[
            "trials"]
        require(len(trials) == 2, f"{len(trials)} trials")
        data = gallery(include_annotations=True)
        valset = GroceryProductsTestSet(
            gp["test_dir"], gp["ann_dir"],
            only=defaults.GP_TEST_VALIDATION_SET_SIZE)
        for t in trials:
            require(not t["failed"] and len(t["results"]) == 1,
                    f"trial {t['trial_id']}: {t}")
            model = MACVGG(batch_norm=t["config"]["batchnorm"])
            node = orbax_read.restore(str(
                search / f"trial_{t['trial_id'] + 1:03d}" / "epoch_0"))
            model.load_state_dict(macvgg_state_dict(node["emb_params"],
                                                    node["emb_stats"]))
            acc = eval_dihe(EmbedFn(model, device="cuda"), size, data,
                            valset, batch_size=DIHE_BATCH, k=(1,),
                            verbose=False, device="cuda")
            require(t["results"][0] == acc[1],
                    f"trial {t['trial_id']}: {t['results'][0]} vs {acc[1]}")
        best = max(trials, key=lambda t: t["results"][0])
        require(result == {"best_config": best["config"],
                           "best_metric": best["results"][0]},
                "dihe hyperopt: not the best trial")
    finally:
        torch.backends.cudnn.deterministic = deterministic

    # datasets: the host-only commands against the readers
    for name, photos in (("datasets sku110k iter (PNG)", sku),
                         ("datasets sku110k iter (JPEG)", jpeg_sku)):
        out, s, ln = _cli(["datasets", "sku110k", "iter", "--imgs",
                           photos["img_dir"], "--annotations",
                           photos["ann"]])
        read = io.StringIO()  # the reader's own lines (malformed rows)
        with contextlib.redirect_stdout(read):
            ds = SKU110KDataset(photos["img_dir"], photos["ann"],
                                flip_chance=0.0)
        failures = []
        for i in range(len(ds)):
            try:
                ds.load_raw(i)
            except Exception as e:  # noqa: BLE001 - what the command prints
                failures.append((i, f"FAIL {ds.index[i]['image_name']}: "
                                    f"{e}"))
        held(name, s, ln, out,
             read.getvalue() + _iter_lines(len(ds), failures),
             {k: 0 for k in ln})

    gp_test = ["--imgs", gp["test_dir"], "--annotations", gp["ann_dir"]]
    def counted(make, key):
        """The reader's own lines, then each top-level count."""
        read = io.StringIO()
        with contextlib.redirect_stdout(read):
            counts = collections.Counter(key(make()))
        return read.getvalue() + "".join(
            f"{n:6d}  {c}\n" for c, n in counts.most_common())

    out, s, ln = _cli(["datasets", "gp", "test-distribution", *gp_test])
    held("datasets gp test-distribution", s, ln, out, counted(
        lambda: GroceryProductsTestSet(gp["test_dir"], gp["ann_dir"]),
        lambda ds: (a.split("/")[0] if "/" in a else a
                    for e in ds.index for a in e["anns"])),
        {k: 0 for k in ln})
    out, s, ln = _cli(["datasets", "gp", "train-distribution", "--source",
                       training])
    held("datasets gp train-distribution", s, ln, out, counted(
        lambda: GroceryProductsDataset([training], random_crop=False),
        lambda ds: (c[0] if c else "(root)" for c in ds.categories)),
        {k: 0 for k in ln})
    fixed = root / "fixed"
    out, s, ln = _cli(["datasets", "gp", "fix", "--source", f["renamed"],
                       "--out", fixed, "--dry-run"])
    held("datasets gp fix --dry-run", s, ln, out,
         _fix_dry_run_lines(f["renamed"], str(fixed)), {k: 0 for k in ln})
    require(not fixed.exists(), "gp fix --dry-run wrote files")
    out, s, ln = _cli(["datasets", "gp", "planogram-test", "--planograms",
                       gp["plano_dir"]])
    lines = []
    for p in sorted(Path(gp["plano_dir"]).glob("*.json")):
        boxes, _, g = read_tonioni_planogram(str(p))
        lines.append(f"{p.name}: {len(boxes)} boxes, "
                     f"{sum(len(v) for v in g.adj.values())} edges")
    lines.append(f"{len(lines)} parsed, 0 failed")
    held("datasets gp planogram-test", s, ln, out,
         "".join(ln_ + "\n" for ln_ in lines), {k: 0 for k in ln})
    out, s, ln = _cli(["datasets", "internal", "iter-train", "--root",
                       f["internal"]])
    internal = InternalTrainSet(f["internal"])
    for i in range(len(internal)):
        internal[i]
    held("datasets internal iter-train", s, ln, out,
         _iter_lines(len(internal), []), {k: 0 for k in ln})

    # the drawing commands fail first on the missing matplotlib
    scene = str(Path(gp["test_dir"]) / "store1" / "images" / "store1_1.jpg")
    drawing = [
        ["dihe", "visualize-performance", "--index", index, "--weights", E,
         scene],
        ["datasets", "sku110k", "visualize", *targets, "--model",
         keep["gln"]],
        ["datasets", "sku110k", "visualize-discriminator-target", *targets],
        ["datasets", "gp", "visualize-test", *gp_test],
        ["datasets", "gp", "visualize-planoset", *gp_test, "--planograms",
         gp["plano_dir"]],
        ["datasets", "gp", "mask-test", scene],
        ["datasets", "gp", "visualize-train", "--source", training],
        ["datasets", "gp", "train-distribution", "--source", training],
        ["datasets", "gp", "visualize", "--source", training,
         "--test-imgs", gp["test_dir"], "--annotations", gp["ann_dir"]],
        ["datasets", "gp", "visualize-baseline", "--imgs", gp["test_dir"]],
        ["datasets", "grozi", "visualize-test"],
        ["datasets", "grozi", "visualize"],
        ["datasets", "grozi", "visualize-train"],
        ["datasets", "internal", "visualize-train", "--root",
         f["internal"]],
        ["datasets", "internal", "visualize", "--root", f["internal"]],
        ["datasets", "internal", "visualize-planoset", "--root",
         f["internal"]],
        ["datasets", "visualize-coco", "--imgs", sku["img_dir"]],
    ]
    fails = {}
    if viz.available():
        fails["skipped"] = "matplotlib is installed"
    else:
        for argv in drawing:
            name = " ".join(a for a in argv[:3] if not a.startswith("-"))
            _reset_launches()
            t0 = time.perf_counter()
            try:
                cli_main([str(a) for a in argv
                          + ["--out", str(root / "drawn.png")]])
                raise AssertionError(f"{name} drew without matplotlib")
            except ModuleNotFoundError as e:
                require("matplotlib" in str(e), f"{name} raised {e!r}")
            seconds = time.perf_counter() - t0
            require(seconds < 1.0, f"{name} took {seconds:.2f} s to fail")
            require(not any(_launches().values()),
                    f"{name} launched a kernel before failing")
            fails[name] = seconds

    launches = {k: {name: r["launches"][k] for name, r in rows.items()}
                for k in ("nms_hard", "knn_fused")}
    emit({"phase": "cli.dihe", "commands": rows, "fail_fast": fails,
          "hyperopt": result, "nvidia_smi": smi,
          "seconds": time.perf_counter() - t_phase})
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------- training

def reference_gln_checkpoint(seed) -> str:
    """A seeded reference-layout GLN checkpoint file (the reference's
    GaussianLayerNetwork names), the training phases' starting point,
    with torchvision RetinaNet's focal prior (0.01) on the
    classification bias. With the seeded bias, N(0, 0.02), every anchor
    scores about 0.5, and SGD at the recipe's LR diverged at 832x1344
    within 6 steps (PERF.md section 6)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    path = BUILD / "train_reference_gln.pth"
    sd = testing.gln_reference_state_dict(np.random.default_rng((seed, 71)))
    sd["head.classification_head.cls_logits.bias"].fill_(
        -math.log((1 - 0.01) / 0.01))
    torch.save({"model_state_dict": sd}, path)
    return str(path)


def train_configs(h=None, w=None, **train_kw):
    """The best model's recipe (cvpce_tpu/cli/gln.py:84-124 with --tanh
    --method simple --hyperopt-params) at a canvas of h x w."""
    canvas = {} if h is None else {"canvas_h": h, "canvas_w": w}
    return (GLNConfig(tanh=True, **canvas),
            gln_train.GLNTrainConfig(
                gauss_method="simple", lr_multiplier=0.995,
                negative_threshold=-1.0, positive_threshold=0.3,
                **train_kw))


def phase_train_parity(seed, ref):
    """One train step on the card and one on the CPU, from the same
    reference-layout checkpoint (through cli/common.py) and the same
    collated batch of 2 SyntheticShelfDataset scenes at 256x384."""
    t0 = time.perf_counter()
    h, w = TRAIN_SMALL_HW
    config, train_cfg = train_configs(h, w, steps_per_epoch=1)
    state = load_gln_state_dict(ref, config)
    scenes = synthetic.SyntheticShelfDataset(TRAIN_BATCH, h, w,
                                             seed=seed + 500)
    b = collate_detection([scenes[i] for i in range(TRAIN_BATCH)])
    batch = (b["images"], b["boxes"], b["box_valid"], b["image_sizes"])
    steps = testing.train_step_on_devices(config, train_cfg, state, batch)
    diff = testing.train_step_differences(state, steps["cuda"],
                                          steps["cpu"])
    for name, (metrics, _) in steps.items():
        require(all(np.isfinite(v) for v in metrics.values()),
                f"non-finite losses on {name}: {metrics}")
    require(diff["frozen_kept"], "the frozen stem or a FrozenBN buffer "
            "moved in a train step")
    for key, tol in testing.TRAIN_STEP_TOL.items():
        require(diff[key] <= tol, f"train step on the card and the CPU: "
                f"{key} {diff[key]} > {tol}")
    emit({"phase": "train.parity", "canvas": [h, w], "batch": TRAIN_BATCH,
          "gt_boxes": int(b["box_valid"].sum()),
          "losses": {k: v[0] for k, v in steps.items()}, **diff,
          "tolerances": testing.TRAIN_STEP_TOL,
          "seconds": time.perf_counter() - t0})


def phase_train_parity_bf16(seed, ref):
    """One bf16-compute train step (f32 master weights) on the card and
    one on the CPU, as train.parity, beside an f32 step on the CPU: the
    card's step within testing.TRAIN_STEP_TOL_BF16 of the CPU's, twice
    the CPU's own bf16-against-f32 distance; every trained tensor f32
    after it, and the frozen stem unmoved."""
    t0 = time.perf_counter()
    h, w = TRAIN_SMALL_HW
    config, train_cfg = train_configs(h, w, steps_per_epoch=1)
    bf16 = dataclasses.replace(config, compute_dtype="bfloat16")
    state = load_gln_state_dict(ref, config)
    scenes = synthetic.SyntheticShelfDataset(TRAIN_BATCH, h, w,
                                             seed=seed + 500)
    b = collate_detection([scenes[i] for i in range(TRAIN_BATCH)])
    batch = (b["images"], b["boxes"], b["box_valid"], b["image_sizes"])
    steps = testing.train_step_on_devices(bf16, train_cfg, state, batch)
    f32 = testing.train_step_on_devices(config, train_cfg, state, batch,
                                        devices=("cpu",))["cpu"]
    res = testing.train_step_bf16_check(state, steps["cuda"], steps["cpu"],
                                        f32)
    for name, (metrics, _) in steps.items():
        require(all(np.isfinite(v) for v in metrics.values()),
                f"non-finite bf16 losses on {name}: {metrics}")
    require(res["frozen_kept"], "the frozen stem or a FrozenBN buffer "
            "moved in a bf16 train step")
    require(res["master_f32"], "a tensor is not f32, or a trained one "
            "lies on the bf16 grid, after a bf16 train step on the card")
    require(not res["failures"], f"bf16 train step on the card and the "
            f"CPU: beyond twice the CPU's bf16-against-f32 distance: "
            f"{res['failures']}")
    emit({"phase": "train.parity.bf16", "canvas": [h, w],
          "batch": TRAIN_BATCH, "gt_boxes": int(b["box_valid"].sum()),
          "losses": {**{k: v[0] for k, v in steps.items()},
                     "cpu_f32": f32[0]},
          "loss_rel": res["loss_rel"], "loss_bound": res["loss_bound"],
          "worst": res["worst"], "tensors_held": res["n_held"],
          "tolerances": testing.TRAIN_STEP_TOL_BF16,
          "seconds": time.perf_counter() - t0})


def phase_train_gln(seed, ref, compute_dtype="float32", f32_run=None,
                    smi=None):
    """train_proposal_generator at 832x1344, batch 2, 8 scenes (4 steps
    an epoch), 2 epochs, rotating checkpoints every 2 steps and an eval
    on 4 held-out scenes after each epoch. evaluate_gln is wrapped to
    time each eval, count its K1 launches and keep its scores.

    `compute_dtype='bfloat16'` (train.gln.bf16) trains in bf16 on f32
    master weights, requires f32 tensors in `checkpoint` and `epoch_0`,
    and prints `f32_run`, train.gln's step times, breakdown and peak
    memory, beside its own. Returns (the evals' K1 launches, the run's
    step times, breakdown and peak memory)."""
    t0 = time.perf_counter()
    config, train_cfg = train_configs()
    config = dataclasses.replace(config, compute_dtype=compute_dtype)
    bf16 = compute_dtype == "bfloat16"
    out = BUILD / ("train_bf16" if bf16 else "train")
    shutil.rmtree(out, ignore_errors=True)
    trainset = synthetic.SyntheticShelfDataset(TRAIN_SCENES, seed=seed + 600)
    evalset = synthetic.SyntheticShelfDataset(TRAIN_EVAL_SCENES,
                                              seed=seed + 700)
    evals = []
    real_eval = train_loops.evaluate_gln

    def timed_eval(*args, **kwargs):
        _reset_launches()
        te = time.perf_counter()
        res, (_, _, confs) = real_eval(*args, return_detections=True,
                                       **kwargs)
        torch.cuda.synchronize()
        evals.append({"seconds": time.perf_counter() - te,
                      "launches": _launches(),
                      "scores": np.concatenate(confs)})
        return res

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_loops, "evaluate_gln", timed_eval):
        result = train_proposal_generator(
            trainset, evalset, str(out), model_cfg=config,
            train_cfg=train_cfg, batch_size=TRAIN_BATCH, epochs=2,
            checkpoint_interval=2, eval_interval=1, eval_threshold=0.5,
            load_torch=ref, seed=seed, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    with open(out / "stats_1.json") as f:
        stats = json.load(f)
    steps = TRAIN_SCENES // TRAIN_BATCH * 2
    losses = [stats[k] for k in ("class_loss", "reg_loss", "gauss_loss")]
    require(result["state"].step == steps and all(
        len(v) == steps for v in losses), f"{result['state'].step} steps")
    require(np.isfinite(losses).all(), f"non-finite losses {losses}")
    require(len(evals) == 2, f"{len(evals)} epoch evals")
    for i, e in enumerate(evals):
        require(e["launches"]["nms_hard"] >= 1,
                f"K1 not launched in epoch {i}'s eval")
    files = sorted(p.name for p in out.iterdir())
    for name in ("checkpoint", "previous_checkpoint", "stats_0.json",
                 "stats_1.json", "epoch_0"):
        require(name in files, f"{name} not written ({files})")
    s0, s1 = evals[0]["scores"], evals[1]["scores"]
    require(s0.shape != s1.shape or not np.array_equal(s0, s1),
            "the epoch-1 eval scored as epoch 0's: the updated weights "
            "did not reach the inference function")
    if bf16:
        for name in ("checkpoint", "epoch_0"):
            saved = orbax_read.restore(str(out / name))
            kinds = {str(a.dtype) for c in ("params", "frozen",
                                            "batch_stats")
                     for _, a in _tree_arrays(saved[c])}
            require(kinds == {"float32"},
                    f"{name} of the bf16 run holds {sorted(kinds)}")
    times = stats["batch_times"]
    breakdown = train_step_breakdown(result["state"], config, train_cfg,
                                     trainset)
    run = {"median_step_seconds": statistics.median(times[1:]),
           "step_ms_by_stage": breakdown, "max_memory_allocated": peak}
    emit({"phase": "train.gln.bf16" if bf16 else "train.gln",
          "canvas": [config.canvas_h, config.canvas_w],
          "compute_dtype": compute_dtype,
          "batch": TRAIN_BATCH, "steps": steps,
          "first_step_seconds": times[0], **run,
          "step_seconds": times,
          "eval_seconds": [e["seconds"] for e in evals],
          "eval_launches": [e["launches"] for e in evals],
          "eval_detections": [int(e["scores"].size) for e in evals],
          "best": result["best"], "losses": losses, "files": files,
          "sample_pictures": sample_pictures(out),
          "allocated_before": resident,
          **({"float32": f32_run, "nvidia_smi": smi} if bf16 else {}),
          "seconds": time.perf_counter() - t0})
    return sum(e["launches"]["nms_hard"] for e in evals), run


def sample_pictures(out: Path):
    """The sample pictures a training loop drew in `out`; without
    matplotlib (the card's machine) the loop skips them, and none may
    be there."""
    pngs = sorted(p.name for p in out.iterdir() if p.suffix == ".png")
    if viz.available():
        return pngs
    require(not pngs, f"sample pictures drawn without matplotlib: {pngs}")
    return "skipped (no matplotlib)"


def train_step_breakdown(state, config, train_cfg, trainset, reps=3):
    """Device milliseconds of each stage of train/gln.py's step on one
    batch (median of `reps`, CUDA events, the stages in the step's
    order): the heatmap targets, the forward, the matcher alone, the
    losses (the matcher again, focal, L1, heatmap), the backward and the
    SGD update."""
    model = state.model
    b = collate_detection([trainset[i] for i in range(TRAIN_BATCH)])
    images = torch.from_numpy(b["images"]).cuda()
    boxes = torch.from_numpy(b["boxes"]).cuda()
    valid = torch.from_numpy(b["box_valid"]).cuda()
    sizes = torch.from_numpy(b["image_sizes"]).cuda()
    anchors = torch.from_numpy(config.anchors()[0]).cuda()
    stages = ("targets", "forward", "match", "losses", "backward", "sgd")
    ms = {k: [] for k in stages}
    for _ in range(reps):
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(len(stages) + 1)]
        torch.cuda.synchronize()
        events[0].record()
        heat = gln_train.render_heatmap_targets(boxes, valid, sizes, config,
                                                train_cfg)[..., None]
        events[1].record()
        model.train()
        out = model(images)
        events[2].record()
        match_anchors(anchors, boxes, valid, chunk=train_cfg.match_chunk)
        events[3].record()
        losses = gln_train.compute_losses(out, anchors, boxes, valid, heat,
                                          config, train_cfg)
        total = (train_cfg.scale_class * losses["classification"]
                 + losses["bbox_regression"]
                 + train_cfg.scale_gaussian * losses["gaussian"])
        events[4].record()
        total.backward()
        events[5].record()
        gln_train.apply_gradients(state.optimizer, train_cfg, state.step)
        events[6].record()
        torch.cuda.synchronize()
        for i, k in enumerate(stages):
            ms[k].append(events[i].elapsed_time(events[i + 1]))
    return {k: statistics.median(v) for k, v in ms.items()}


def phase_train_resume(seed, ref):
    """At 256x384: 2 epochs in one go, twice, against 1 epoch and then
    resume=True for 1 more, with cuDNN's deterministic algorithms. The
    rerun measures the card's run-to-run spread; a resume that lost its
    momentum or its place in the LR schedule would be orders of
    magnitude further off."""
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _train_resume(seed, ref, t0)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _loss_rel(got: Dict, want: Dict, skip: int) -> float:
    """Largest relative difference of two stats files' loss series, the
    second's first `skip` steps left out."""
    worst = 0.0
    for key in ("class_loss", "reg_loss", "gauss_loss"):
        a, b = np.asarray(got[key]), np.asarray(want[key][skip:])
        require(a.shape == b.shape, f"{key}: {len(a)} steps, {len(b)}")
        worst = max(worst, float((np.abs(a - b) / np.abs(b)).max()))
    return worst


def _tree_arrays(tree, trail=()):
    """((dotted path, array), ...) of a train-state tree; None leaves
    (optax's empty nodes) hold none."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_arrays(v, trail + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _tree_arrays(v, trail + (str(i),))
    elif tree is not None:
        yield ".".join(trail), np.asarray(tree)


def _same_tree_bits(got, want, label) -> int:
    """Two train-state trees leaf for leaf, dtype, shape and bytes;
    returns the number of arrays."""
    a, b = dict(_tree_arrays(got)), dict(_tree_arrays(want))
    require(sorted(a) == sorted(b), f"{label}: the leaves differ "
            f"{sorted(set(a) ^ set(b))[:4]}")
    for k, w in b.items():
        require(a[k].dtype == w.dtype and a[k].shape == w.shape
                and a[k].tobytes() == w.tobytes(),
                f"{label}: leaf {k} differs from the saved state")
    return len(b)


def check_node(phase: str, run: Path, name: str, saved, fresh) -> Dict:
    """The node a run resumes from (train/checkpoint.py): `run / name`
    is an orbax directory, not a torch.save file, whose tree equals
    `saved` (the state's `to_tree()` when it was written) bit for bit,
    and restored into `fresh` (a new train state on the card) gives that
    tree back. Its write (to_tree and orbax_write.save into a scratch
    node, as the loops write one), read (orbax_read.restore) and load
    (onto the card) seconds, host time, and MB/s over the arrays' bytes
    print on a line of their own."""
    node = run / name
    require(orbax_read.is_checkpoint(str(node)),
            f"{phase}: {node} is not an orbax train-state node")
    manager = CheckpointManager(str(run), name=name)
    t = time.perf_counter()
    read = manager.read()
    read_s = time.perf_counter() - t
    require(read.layout == "orbax", f"{phase}: {name} read as {read.layout}")
    n = _same_tree_bits(read.value, saved, f"{phase}: {name}")
    t = time.perf_counter()
    load_node(fresh, read)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    _same_tree_bits(fresh.to_tree(), saved, f"{phase}: {name} restored")
    scratch = BUILD / "node_timing"
    shutil.rmtree(scratch, ignore_errors=True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    CheckpointManager(str(scratch)).save_named(fresh, name, {})
    write_s = time.perf_counter() - t
    shutil.rmtree(scratch, ignore_errors=True)
    mb = sum(a.nbytes for _, a in _tree_arrays(saved)) / 1e6
    line = {"phase": f"{phase}.node", "node": name, "arrays": n, "mb": mb,
            "write_seconds": write_s, "write_mb_per_s": mb / write_s,
            "read_seconds": read_s, "read_mb_per_s": mb / read_s,
            "load_seconds": load_s, "clock": "host"}
    emit(line)
    return line


def _train_resume(seed, ref, t0):
    h, w = TRAIN_SMALL_HW
    config, train_cfg = train_configs(h, w)
    out = BUILD / "train_resume"
    shutil.rmtree(out, ignore_errors=True)
    trainset = synthetic.SyntheticShelfDataset(4, h, w, seed=seed + 800)
    evalset = synthetic.SyntheticShelfDataset(2, h, w, seed=seed + 900)
    common = dict(model_cfg=config, train_cfg=train_cfg,
                  batch_size=TRAIN_BATCH, checkpoint_interval=100,
                  eval_interval=10, eval_threshold=0.5, load_torch=ref,
                  seed=seed, device="cuda")
    whole = train_proposal_generator(trainset, evalset, str(out / "whole"),
                                     epochs=2, **common)
    train_proposal_generator(trainset, evalset, str(out / "rerun"),
                             epochs=2, **common)
    split = out / "split"
    first = train_proposal_generator(trainset, evalset, str(split),
                                     epochs=1, **common)
    manager = CheckpointManager(str(split))
    meta_first = manager.load_meta()
    saved = first["state"].to_tree()
    node = check_node("train.resume", split, "checkpoint", saved,
                      gln_train.init_train_state(config, train_cfg,
                                                 device="cuda"))
    momentum = dict(_tree_arrays(saved["opt_state"]))
    require(len(momentum) > 100, "momentum missing from the checkpoint")
    resumed = train_proposal_generator(trainset, evalset, str(split),
                                       epochs=1, resume=True, **common)
    meta = manager.load_meta()
    steps = whole["state"].step
    require(meta_first["iteration"] == steps // 2 - 1
            and meta["iteration"] == steps - 1
            and resumed["state"].step == steps,
            f"iterations {meta_first['iteration']} -> {meta['iteration']}, "
            f"{resumed['state'].step} steps")
    stats = {}
    for name, path in (("whole", out / "whole"), ("rerun", out / "rerun"),
                       ("resumed", split)):
        with open(path / "stats_1.json") as f:
            stats[name] = json.load(f)
    rerun = _loss_rel(stats["rerun"], stats["whole"], 0)
    worst = _loss_rel(stats["resumed"], stats["whole"], steps // 2)
    bound = max(RESUME_LOSS_TOL, 4 * rerun)
    require(worst <= bound, f"the resumed epoch's losses {worst} apart from "
            f"the uninterrupted run's (a rerun {rerun}, bound {bound})")
    emit({"phase": "train.resume", "canvas": [h, w], "steps": steps,
          "iterations": [meta_first["iteration"], meta["iteration"]],
          "momentum_arrays": len(momentum), "node": node, "loss_rel": worst,
          "rerun_loss_rel": rerun, "bound": bound,
          "seconds": time.perf_counter() - t0})


# ------------------------------------------------------- DIHE training

class _Recorder:
    """Wraps train/loops.py's step factory: every step's metrics (as
    floats, which waits for the card) and its host seconds."""

    def __init__(self, factory, gan: bool):
        self.factory, self.gan = factory, gan
        self.metrics, self.seconds = [], []

    def __call__(self, cfg):
        made = self.factory(cfg)
        init, step = made if self.gan else (None, made)

        def timed(*args):
            t = time.perf_counter()
            state, metrics = step(*args)
            self.metrics.append({k: float(v) for k, v in metrics.items()})
            self.seconds.append(time.perf_counter() - t)
            return state, metrics

        return (init, timed) if self.gan else timed


def _finite_losses(recorder, steps, label):
    require(len(recorder.metrics) == steps,
            f"{label}: {len(recorder.metrics)} steps, not {steps}")
    require(all(np.isfinite(v) for m in recorder.metrics
                for v in m.values()), f"{label}: non-finite losses")


def phase_train_dihe_parity(seed):
    """One DIHE three-player step and one GAN pretraining step on the
    card and on the CPU at 128x128 (gen_downs 7), batch 2, from the same
    seeded weights and batch, within testing.DIHE_STEP_TOL; every
    BatchNorm counted the statistics updates the JAX step keeps, and the
    generator sub-step on the card leaves the embedder's and the
    discriminator's running statistics bit for bit where they were."""
    t0 = time.perf_counter()
    hw = DIHE_PARITY_HW
    cfg = dihe_train.DIHETrainConfig(gen_downs=7, steps_per_epoch=10)
    state = dihe_train.init_dihe_state(cfg, seed=seed + 31, device="cpu")
    before = {k: getattr(state, k).state_dict()
              for k in testing.DIHE_STAT_UPDATES}
    rng = np.random.default_rng(seed + 32)
    pos, neg, gen, disc = (rng.uniform(-1, 1, (2, hw, hw, 3)).astype(
        np.float32) for _ in range(4))
    sim = np.float32([0.5, 1.0])
    out = {}
    for loop, updates in (("dihe", testing.DIHE_STAT_UPDATES),
                          ("gan", testing.GAN_STAT_UPDATES)):
        start = {k: before[k] for k in updates}
        if loop == "dihe":
            steps = testing.dihe_step_on_devices(cfg, start,
                                                 (pos, neg, gen, disc, sim))
        else:
            steps = testing.gan_step_on_devices(
                dihe_train.GANPretrainConfig(gen_downs=7), start,
                (gen, disc))
        diff = testing.dihe_step_differences(start, steps["cuda"],
                                             steps["cpu"], updates)
        for name, (metrics, _) in steps.items():
            require(all(np.isfinite(v) for v in metrics.values()),
                    f"{loop}: non-finite losses on {name}: {metrics}")
        require(diff["stat_updates_kept"], f"{loop}: a BatchNorm moved its "
                "statistics in a forward whose statistics JAX discards")
        for key, tol in testing.DIHE_STEP_TOL.items():
            require(diff[key] <= tol, f"{loop} step on the card and the "
                    f"CPU: {key} {diff[key]} > {tol}")
        out[loop] = dict(diff, losses={k: v[0] for k, v in steps.items()})
    # the generator sub-step alone on the card: its embedder and
    # discriminator forwards run with batch statistics and keep none
    state = dihe_train.init_dihe_state(cfg, state_dicts=before,
                                       device="cuda")
    kept = {k: v.clone() for name in ("embedder", "discriminator")
            for k, v in getattr(state, name).state_dict().items()
            if "running" in k or "num_batches" in k}
    batch = [torch.from_numpy(a).cuda() for a in (pos, gen)]
    dihe_train.generator_substep(state, cfg, *batch)
    after = {k: v for name in ("embedder", "discriminator")
             for k, v in getattr(state, name).state_dict().items()
             if k in kept}
    require(all(torch.equal(after[k], v) for k, v in kept.items()),
            "the generator sub-step moved a running statistic of the "
            "embedder or the discriminator")
    emit({"phase": "train.dihe.parity", "canvas": [hw, hw], "batch": 2,
          "gen_downs": 7, **out, "discarded_forwards_kept": len(kept),
          "tolerances": testing.DIHE_STEP_TOL,
          "seconds": time.perf_counter() - t0})


def phase_train_gan(seed):
    """pretrain_gan at full width (256x256, gen_downs 8, ngf = ndf = 64,
    batch 4, the CLI's default): ArchetypeGallerySet items as the
    generator's input, SceneCropSet crops as the discriminator's real
    ones, 2 epochs of 4 steps, a rotating checkpoint every 2 steps."""
    t0 = time.perf_counter()
    styles = synthetic.product_styles(N_STYLES, seed=seed)
    data = synthetic.ArchetypeGallerySet(styles[:4], views=4,
                                         seed=seed + 40)
    crops = synthetic.SceneCropSet(styles, n=32, seed=seed + 41)
    out = BUILD / "train_gan"
    shutil.rmtree(out, ignore_errors=True)
    rec = _Recorder(train_loops.make_gan_pretrain_step, gan=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_loops, "make_gan_pretrain_step", rec):
        result = train_loops.pretrain_gan(
            data, crops, str(out), epochs=2, batch_size=DIHE_BATCH,
            checkpoint_interval=2, seed=seed, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    steps = 2 * len(data) // DIHE_BATCH
    _finite_losses(rec, steps, "train.gan")
    files = sorted(p.name for p in out.iterdir())
    for name in ("gan_checkpoint", "previous_gan_checkpoint",
                 "gan_checkpoint.meta.json"):
        require(name in files, f"{name} not written ({files})")
    meta = CheckpointManager(str(out), name="gan_checkpoint").load_meta()
    require(meta == {"epoch": 1, "iteration": steps - 1,
                     "epoch_step": steps // 2 - 1}, f"gan meta {meta}")
    emit({"phase": "train.gan", "canvas": [256, 256], "gen_downs": 8,
          "batch": DIHE_BATCH, "steps": steps,
          "first_step_seconds": rec.seconds[0],
          "median_step_seconds": statistics.median(rec.seconds[1:]),
          "step_seconds": rec.seconds, "losses": rec.metrics,
          "files": files, "sample_pictures": sample_pictures(out),
          "max_memory_allocated": peak,
          "seconds": time.perf_counter() - t0})
    return result["state"]


def phase_train_dihe(seed, gan_state):
    """train_dihe at full width (256x256, MACVGG with BatchNorm,
    gen_downs 8, batch 4 = 8 items a loader batch, f32 with TF32 off)
    from train.gan's generator and discriminator: 32 ArchetypeGallerySet
    items, 2 epochs of 4 steps, an eval_dihe after each epoch against a
    DIHE_GALLERY_SIZE-entry gallery on 2 planogram query scenes, K2
    launched and counted in each. eval_dihe is wrapped to time each eval
    and count its launches; then each sub-step's device time."""
    t0 = time.perf_counter()
    styles = synthetic.product_styles(N_STYLES, seed=seed)
    data = synthetic.ArchetypeGallerySet(styles[:8], views=4,
                                         seed=seed + 50)
    crops = synthetic.SceneCropSet(styles, n=32, seed=seed + 41)
    gallery = GallerySet(styles, DIHE_GALLERY_SIZE, seed + 51)
    queries = synthetic.PlanogramQuerySet(styles, n=2, seed=seed + 52)
    queries = [queries[i] for i in range(len(queries))]
    out = BUILD / "train_dihe"
    shutil.rmtree(out, ignore_errors=True)
    rec = _Recorder(train_loops.make_dihe_train_step, gan=False)
    evals = []
    real_eval = train_loops.eval_dihe

    def timed_eval(*args, **kwargs):
        _reset_launches()
        te = time.perf_counter()
        acc = real_eval(*args, **kwargs)
        torch.cuda.synchronize()
        evals.append({"seconds": time.perf_counter() - te,
                      "knn_fused": knn_ops.nearest_neighbors_fused.launches,
                      "accuracy": acc.get(1, 0.0)})
        return acc

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(train_loops, "make_dihe_train_step", rec), \
            mock.patch.object(train_loops, "eval_dihe", timed_eval):
        result = train_loops.train_dihe(
            data, crops, gallery, queries, str(out), gan_state=gan_state,
            epochs=2, batch_size=DIHE_BATCH, checkpoint_interval=2,
            seed=seed, device="cuda")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    state = result["state"]
    steps = 2 * len(data) // (2 * DIHE_BATCH)
    _finite_losses(rec, steps, "train.dihe")
    require(state.step == steps and steps >= 8, f"{state.step} steps")
    require(len(evals) == 2, f"{len(evals)} epoch evals")
    for i, e in enumerate(evals):
        require(e["knn_fused"] >= 1, f"K2 not launched in epoch {i}'s eval")
    files = sorted(p.name for p in out.iterdir())
    for name in ("embedder_checkpoint", "previous_embedder_checkpoint",
                 "epoch_1"):
        require(name in files, f"{name} not written ({files})")
    seeded = dict(dihe_train.init_dihe_state(
        dihe_train.DIHETrainConfig(), seed=seed,
        device="cpu").embedder.named_parameters())
    moved = max((p.detach().cpu() - seeded[k]).abs().max().item()
                for k, p in state.embedder.named_parameters())
    require(moved > 0, "the embedder's parameters did not move")
    pretrained = dict(gan_state.generator.named_parameters())
    gen_moved = max((p - pretrained[k]).abs().max().item()
                    for k, p in state.generator.named_parameters())
    breakdown = dihe_substep_breakdown(state, data)
    emit({"phase": "train.dihe", "canvas": [256, 256], "gen_downs": 8,
          "batch": DIHE_BATCH, "steps": steps,
          "first_step_seconds": rec.seconds[0],
          "median_step_seconds": statistics.median(rec.seconds[1:]),
          "step_seconds": rec.seconds, "losses": rec.metrics,
          "substep_ms": breakdown,
          "eval_seconds": [e["seconds"] for e in evals],
          "eval_knn_fused_launches": [e["knn_fused"] for e in evals],
          "eval_accuracy": [e["accuracy"] for e in evals],
          "gallery": len(gallery), "best": result["best"],
          "embedder_moved": moved, "generator_moved": gen_moved,
          "files": files, "max_memory_allocated": peak,
          "allocated_before": resident,
          "seconds": time.perf_counter() - t0})
    return sum(e["knn_fused"] for e in evals)


def dihe_substep_breakdown(state, data, reps=3):
    """Device milliseconds of the three sub-steps of one DIHE step on a
    loader batch of `data` (median of `reps`, CUDA events): encoder,
    discriminator, generator. They update the state, as a step does."""
    cfg = dihe_train.DIHETrainConfig(steps_per_epoch=4)
    items = [data[i] for i in range(2 * DIHE_BATCH)]
    emb = torch.from_numpy(np.stack([it[0] for it in items])).cuda()
    gen = torch.from_numpy(np.stack([it[1] for it in items[:DIHE_BATCH]]))
    gen = gen.cuda()
    sim = torch.from_numpy(dihe_train.hierarchy_similarity(
        [it[2] for it in items[:DIHE_BATCH]],
        [it[2] for it in items[DIHE_BATCH:]])).cuda()
    pos, neg = emb[:DIHE_BATCH], emb[DIHE_BATCH:]
    stages = ("encoder", "discriminator", "generator")
    ms = {k: [] for k in stages}
    for _ in range(reps):
        events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        events[0].record()
        dihe_train.encoder_substep(state, cfg, pos, neg, gen, sim)
        events[1].record()
        dihe_train.discriminator_substep(state, gen, pos)
        events[2].record()
        dihe_train.generator_substep(state, cfg, pos, gen)
        events[3].record()
        torch.cuda.synchronize()
        for i, k in enumerate(stages):
            ms[k].append(events[i].elapsed_time(events[i + 1]))
    return {k: statistics.median(v) for k, v in ms.items()}


def phase_train_dihe_resume(seed):
    """At 64x64 (gen_downs 4, batch 2, 8 items): both loops for 2
    epochs in one go, twice, against 1 epoch and then resume=True for 1
    more, with cuDNN's deterministic algorithms. The rerun measures the
    card's run-to-run spread. Checks: the iteration counter continues,
    the Adam moments come back from the checkpoint bit for bit, the
    resumed epoch's losses agree with the uninterrupted run's."""
    t0 = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = {loop: _dihe_resume(seed, loop) for loop in ("gan", "dihe")}
    finally:
        torch.backends.cudnn.deterministic = deterministic
    emit({"phase": "train.dihe.resume", "canvas": [64, 64], "batch": 2,
          **out, "seconds": time.perf_counter() - t0})


def _dihe_resume(seed, loop):
    rng = np.random.default_rng(seed + 60)
    data = [(rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32),
             rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32),
             ["Food", f"Cat{i % 2}", f"Sub{i % 4}"], f"p{i}")
            for i in range(8)]
    crops = rng.uniform(0, 1, (8, 64, 64, 3)).astype(np.float32)
    root = BUILD / f"train_{loop}_resume"
    shutil.rmtree(root, ignore_errors=True)
    if loop == "gan":
        factory, name = "make_gan_pretrain_step", "gan_checkpoint"
        opt = "gen_opt"
        gan_cfg = dihe_train.GANPretrainConfig(gen_downs=4)

        def fresh():
            return dihe_train.make_gan_pretrain_step(gan_cfg)[0](
                device="cuda")

        def run(path, **kw):
            return train_loops.pretrain_gan(
                data, crops, str(path), batch_size=2, seed=seed,
                checkpoint_interval=100, device="cuda",
                train_cfg=gan_cfg, **kw)
    else:
        factory, name = "make_dihe_train_step", "embedder_checkpoint"
        opt = "emb_opt"

        def fresh():
            return dihe_train.init_dihe_state(
                dihe_train.DIHETrainConfig(gen_downs=4), device="cuda")

        def run(path, **kw):
            return train_loops.train_dihe(
                data, crops, data, [], str(path), batch_size=2,
                seed=seed, checkpoint_interval=100, eval_interval=10,
                device="cuda",
                train_cfg=dihe_train.DIHETrainConfig(gen_downs=4), **kw)

    losses = {}
    for key, path, kw in (("whole", root / "whole", {"epochs": 2}),
                          ("rerun", root / "rerun", {"epochs": 2}),
                          ("first", root / "split", {"epochs": 1}),
                          ("resumed", root / "split",
                           {"epochs": 1, "resume": True})):
        rec = _Recorder(getattr(train_loops, factory), gan=loop == "gan")
        with mock.patch.object(train_loops, factory, rec):
            result = run(path, **kw)
        losses[key] = rec.metrics
        if key == "first":
            manager = CheckpointManager(str(path), name=name)
            meta_first = manager.load_meta()
            saved = result["state"].to_tree()
            node = check_node("train.dihe.resume", path, name, saved,
                              fresh())
            adam = dict(_tree_arrays(saved[opt][0]))
            require(len(adam) > 20 and int(saved[opt][0]["count"])
                    == len(losses["first"]),
                    f"{loop}: Adam state missing from the checkpoint")
    meta = manager.load_meta()
    steps = len(losses["whole"])
    require(meta_first["iteration"] == steps // 2 - 1
            and meta["iteration"] == steps - 1
            and len(losses["resumed"]) == steps // 2,
            f"{loop}: iterations {meta_first['iteration']} -> "
            f"{meta['iteration']}, {len(losses['resumed'])} resumed steps")

    def rel(got, want):
        return max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30)
                   for g, w in zip(got, want) for k in w)

    rerun = rel(losses["rerun"], losses["whole"])
    worst = rel(losses["resumed"], losses["whole"][steps // 2:])
    bound = max(RESUME_LOSS_TOL, 4 * rerun)
    require(worst <= bound, f"{loop}: the resumed epoch's losses {worst} "
            f"apart from the uninterrupted run's (a rerun {rerun}, bound "
            f"{bound})")
    return {"steps": steps, "iterations": [meta_first["iteration"],
                                           meta["iteration"]],
            "adam_arrays": len(adam), "node": node, "loss_rel": worst,
            "rerun_loss_rel": rerun, "bound": bound}


# --------------------------------------------------------------- parallel

PARALLEL_TIMEOUT = 600  # seconds, the two ranks of parallel.ranks2
PARALLEL_GALLERY = 8192  # 4096 rows a rank: K2 on each
PARALLEL_QUERIES = 67
PARALLEL_EVAL_SCENES = 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _digest(sd: Dict) -> str:
    h = hashlib.sha256()
    for key in sorted(sd):
        h.update(key.encode())
        h.update(sd[key].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _same_metrics(a: Dict, b: Dict) -> bool:
    """Equal evaluate_gln results, their raw curves included."""
    if a.keys() != b.keys():
        return False
    for t in a:
        for key, v in a[t].items():
            if key == "raw":
                if not all(np.array_equal(v[k], b[t][key][k]) for k in v):
                    return False
            elif v != b[t][key]:
                return False
    return True


def phase_parallel_init():
    """initialize_multihost at world size 1 over NCCL on a free port:
    the rendezvous and the warm-up all-reduce of ones."""
    t0 = time.perf_counter()
    initialize_multihost(f"tcp://127.0.0.1:{_free_port()}", 1, 0,
                         local_rank=0,
                         timeout=datetime.timedelta(seconds=120))
    require(dist.is_initialized() and dist.get_world_size() == 1,
            "the process group did not come up")
    emit({"phase": "parallel.init", "backend": dist.get_backend(),
          "world_size": dist.get_world_size(),
          "seconds": time.perf_counter() - t0})


def phase_parallel_serve(par, seed):
    """The mesh paths at world size 1 over NCCL: ProposalGenerator(mesh=)
    on the serve phase's 4 scenes against the non-mesh detect_batch, bit
    for bit, with K1 in the mesh path; Classifier(mesh=) over a
    4096-entry 1024-d MACVGG gallery (the non-mesh index saved and
    loaded into it) against the non-mesh search, with K2 in the mesh
    path."""
    t0 = time.perf_counter()
    mesh = data_parallel_mesh()
    images = par["scenes"]
    torch.cuda.reset_peak_memory_stats()
    pg, pg_mesh = (ProposalGenerator(par["gln_state"], par["config"],
                                     confidence_threshold=0.5,
                                     input_norm="raw01", mesh=m,
                                     device="cuda")
                   for m in (None, mesh))
    _reset_launches()
    ts = time.perf_counter()
    got = pg_mesh.detect_batch(images)
    torch.cuda.synchronize()
    detect_s = time.perf_counter() - ts
    k1 = _launches()["nms_hard"]
    ts = time.perf_counter()
    want = pg.detect_batch(images)
    torch.cuda.synchronize()
    plain_detect_s = time.perf_counter() - ts
    for i, (g, w) in enumerate(zip(got, want)):
        for key in ("valid", "boxes", "scores"):
            require(np.array_equal(g[key], w[key]),
                    f"scene {i}: detect_batch(mesh) {key} differs from "
                    "the non-mesh path")
    require(k1 > 0, "K1 was not launched in the mesh detect_batch")

    vgg = MACVGG(batch_norm=True)
    vgg.load_state_dict(par["vgg_state"])
    encoder = EmbedFn(fold_bn_variables(vgg.cuda()), device="cuda")
    clf = Classifier(encoder, encoder.embedding_size,
                     sample_set=GallerySet(par["styles"], DIHE_GALLERY_SIZE,
                                           seed), k=1, device="cuda")
    index = BUILD / "parallel_index.npz"
    clf.save_index(str(index))
    clf_mesh = Classifier(encoder, encoder.embedding_size, load=str(index),
                          k=1, mesh=mesh, device="cuda")
    crops = torch.cat([pg.crop_boxes(img, r["boxes"][
        r["valid"] & (r["scores"] > pg.confidence_threshold)])
        for img, r in zip(images, want)])
    require(len(crops) > 0, "no detections to classify")
    _reset_launches()
    ts = time.perf_counter()
    labels_mesh = clf_mesh.classify(crops)
    torch.cuda.synchronize()
    classify_s = time.perf_counter() - ts
    k2 = _launches()["knn_fused"]
    labels = clf.classify(crops)
    mismatches = 0
    with torch.inference_mode():
        for s0 in range(0, len(crops), clf.batch_size):
            emb = clf._embed(crops[s0:s0 + clf.batch_size])
            mismatches += int((clf_mesh.search(emb) != clf.search(emb))
                              .sum())
    require(mismatches == 0 and labels_mesh == labels,
            f"Classifier(mesh) indices differ from the non-mesh search "
            f"({mismatches})")
    require(k2 > 0, "K2 was not launched in the mesh classify")
    emit({"phase": "parallel.serve", "world_size": mesh.size,
          "scenes": len(images),
          "detections": int(sum(
              (r["valid"] & (r["scores"] > pg.confidence_threshold)).sum()
              for r in want)),
          "crops": int(len(crops)), "gallery": len(clf.embedding),
          "launches": {"nms_hard": k1, "knn_fused": k2},
          "detect_seconds": detect_s, "plain_detect_seconds": plain_detect_s,
          "classify_seconds": classify_s,
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t0})
    return {"nms_hard": k1, "knn_fused": k2}


def parallel_inputs(par, seed, ref) -> Dict:
    """What both ranks of parallel.ranks2 take: the GLN step's checkpoint
    and global batch (256x384, 2 scenes), the DIHE step's seed and global
    batch (128x128, 2 samples), a gallery of PARALLEL_GALLERY rows whose
    row 4101 (rank 1's) repeats row 5 (rank 0's) and its queries, and
    the serve phase's detector with PARALLEL_EVAL_SCENES eval scenes at
    832x1344."""
    h, w = TRAIN_SMALL_HW
    scenes = synthetic.SyntheticShelfDataset(TRAIN_BATCH, h, w,
                                             seed=seed + 500)
    b = collate_detection([scenes[i] for i in range(TRAIN_BATCH)])
    rng = np.random.default_rng(seed + 32)
    hw = DIHE_PARITY_HW
    pos, neg, gen, disc = (rng.uniform(-1, 1, (2, hw, hw, 3)).astype(
        np.float32) for _ in range(4))
    grng = np.random.default_rng(seed + 61)
    gallery = grng.standard_normal((PARALLEL_GALLERY, 1024)).astype(
        np.float32)
    gallery[4101] = gallery[5]
    queries = np.concatenate([gallery[[5, 4101, 8191]], grng.standard_normal(
        (PARALLEL_QUERIES - 3, 1024))]).astype(np.float32)
    config = par["config"]
    evalset = synthetic.PlanogramSceneDetectionSet(
        PARALLEL_EVAL_SCENES, config.canvas_h, config.canvas_w, seed=seed)
    items = [{k: v.cpu().numpy() if torch.is_tensor(v) else v
              for k, v in evalset[i].items()}
             for i in range(PARALLEL_EVAL_SCENES)]
    return {"ref": ref,
            "gln_batch": (b["images"], b["boxes"], b["box_valid"],
                          b["image_sizes"]),
            "dihe_seed": seed + 31,
            "dihe_batch": (pos, neg, gen, disc, np.float32([0.5, 1.0])),
            "gallery": gallery, "queries": queries,
            "eval_state": par["gln_state"], "eval_config": config,
            "eval_items": items}


def parallel_worker(rank: int, port: int, work: Path) -> int:
    """One of parallel.ranks2's two ranks, both on cuda:0 over gloo (NCCL
    refuses two ranks on one device): the DP GLN step, the DP DIHE step,
    the sharded search and evaluate_gln(mesh=) on the inputs in `work`;
    the results go to work/rank<r>.pt."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(f"tcp://127.0.0.1:{port}", 2, rank, local_rank=0,
                         backend="gloo",
                         timeout=datetime.timedelta(seconds=300))
    mesh = data_parallel_mesh()
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    out = {}

    t0 = time.perf_counter()
    h, w = TRAIN_SMALL_HW
    config, train_cfg = train_configs(h, w, steps_per_epoch=1)
    state = gln_train.init_train_state(
        config, train_cfg, state_dict=load_gln_state_dict(inputs["ref"],
                                                          config),
        device="cuda")
    put_replicated(state, mesh)
    step = make_dp_train_step(gln_train.make_train_step(
        config, train_cfg, config.anchors()[0]), mesh)
    batch = put_sharded(inputs["gln_batch"], mesh)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ts = time.perf_counter()
    state, metrics = step(state, *batch)
    torch.cuda.synchronize()
    sd = {k: v.cpu() for k, v in state.model.state_dict().items()}
    out["gln"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                  "state": sd if rank == 0 else None, "digest": _digest(sd),
                  "step_seconds": time.perf_counter() - ts,
                  "max_memory_allocated": torch.cuda.max_memory_allocated(),
                  "seconds": time.perf_counter() - t0}
    del state, step, batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = dihe_train.DIHETrainConfig(gen_downs=7, steps_per_epoch=10)
    state = dihe_train.init_dihe_state(cfg, seed=inputs["dihe_seed"],
                                       device="cuda")
    put_replicated(state, mesh)
    step = make_dp_train_step(dihe_train.make_dihe_train_step(cfg), mesh)
    batch = put_sharded(inputs["dihe_batch"], mesh)
    torch.cuda.synchronize()
    ts = time.perf_counter()
    state, metrics = step(state, *batch)
    torch.cuda.synchronize()
    record = testing._player_record(state, testing.DIHE_STAT_UPDATES)
    out["dihe"] = {"metrics": {k: float(v) for k, v in metrics.items()},
                   "players": record if rank == 0 else None,
                   "digest": _digest({f"{p}.{k}": v for p, (sd, _) in
                                      record.items() for k, v in sd.items()}),
                   "step_seconds": time.perf_counter() - ts,
                   "seconds": time.perf_counter() - t0}
    del state, step, batch
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    padded, valid = pad_gallery(inputs["gallery"], mesh.size)
    place = gallery_sharding(mesh)
    block, block_valid = place(padded), place(valid)
    queries = torch.from_numpy(inputs["queries"]).cuda()
    out["knn"] = {}
    for k in (1, 8):
        search = make_sharded_nn(mesh, k)
        _reset_launches()
        kernels = knn_ops.kernels_launched()
        d, i = search(block, block_valid, queries)
        torch.cuda.synchronize()
        out["knn"][k] = {"dists": d.cpu(), "idx": i.cpu(),
                         "launches": _launches()["knn_fused"],
                         "kernels": knn_ops.kernels_launched() - kernels}
    out["knn_seconds"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    _reset_launches()
    out["eval"] = evaluate_gln(inputs["eval_state"], inputs["eval_items"],
                               inputs["eval_config"], thresholds=(0.5,),
                               batch_size=PARALLEL_EVAL_SCENES, mesh=mesh,
                               device="cuda")
    torch.cuda.synchronize()
    out["eval_launches"] = _launches()["nms_hard"]
    out["eval_seconds"] = time.perf_counter() - t0
    torch.save(out, work / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def _run_ranks(work: Path, job: str = "ranks2", n: int = 2) -> list:
    """Start the n ranks of parallel.<job> (this script again, with the
    hidden rank arguments), wait up to PARALLEL_TIMEOUT, end them all
    whatever happens; every rank's results."""
    port = _free_port()
    procs, logs = [], []
    for rank in range(n):
        log = open(work / f"rank{rank}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--parallel-rank", str(rank), "--parallel-port", str(port),
             "--parallel-dir", str(work), "--parallel-job", job],
            stdout=log, stderr=subprocess.STDOUT))
    end = time.monotonic() + PARALLEL_TIMEOUT
    try:
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            require(not failed and time.monotonic() < end,
                    f"parallel.{job}: rank {failed[:1]} failed or ran past "
                    f"{PARALLEL_TIMEOUT} s:\n"
                    + (work / f"rank{(failed or [0])[0]}.log").read_text()[
                        -3000:])
            time.sleep(0.2)
        for r, p in enumerate(procs):
            require(p.returncode == 0, f"parallel.{job}: rank {r} exited "
                    f"{p.returncode}:\n"
                    + (work / f"rank{r}.log").read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    return [torch.load(work / f"rank{r}.pt", weights_only=False)
            for r in range(n)]


def phase_parallel_ranks2(par, seed, ref):
    """Two ranks on the one card over gloo, each with half of every
    global batch: the DP GLN step at 256x384 and the DP DIHE step at
    128x128 against the one-process step on the same global batch on the
    card (testing.TRAIN_STEP_TOL, testing.DIHE_STEP_TOL), the ranks bit
    for bit alike; the gallery-sharded search over PARALLEL_GALLERY rows
    (K2 on each rank's 4096) against the one search over all of them;
    evaluate_gln(mesh=) on PARALLEL_EVAL_SCENES scenes (one a rank, K1 on
    each) against the non-mesh evaluate_gln at batch 1, equal."""
    t0 = time.perf_counter()
    work = BUILD / "parallel"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    inputs = parallel_inputs(par, seed, ref)
    torch.save(inputs, work / "inputs.pt")
    ts = time.perf_counter()
    ranks = _run_ranks(work)
    ranks_s = time.perf_counter() - ts

    h, w = TRAIN_SMALL_HW
    config, train_cfg = train_configs(h, w, steps_per_epoch=1)
    state = load_gln_state_dict(ref, config)
    one = testing.train_step_on_devices(config, train_cfg, state,
                                        inputs["gln_batch"],
                                        devices=("cuda",))["cuda"]
    dp = (ranks[0]["gln"]["metrics"], ranks[0]["gln"]["state"])
    gln_diff = testing.train_step_differences(state, dp, one)
    require(ranks[0]["gln"]["digest"] == ranks[1]["gln"]["digest"],
            "the ranks' GLN states differ after the DP step")
    require(gln_diff["frozen_kept"], "a frozen tensor moved in the DP step")
    for key, tol in testing.TRAIN_STEP_TOL.items():
        require(gln_diff[key] <= tol, f"DP GLN step against one process: "
                f"{key} {gln_diff[key]} > {tol}")

    cfg = dihe_train.DIHETrainConfig(gen_downs=7, steps_per_epoch=10)
    init = dihe_train.init_dihe_state(cfg, seed=inputs["dihe_seed"],
                                      device="cpu")
    before = {k: getattr(init, k).state_dict()
              for k in testing.DIHE_STAT_UPDATES}
    one = testing.dihe_step_on_devices(cfg, before, inputs["dihe_batch"],
                                       devices=("cuda",))["cuda"]
    dp = (ranks[0]["dihe"]["metrics"], ranks[0]["dihe"]["players"])
    dihe_diff = testing.dihe_step_differences(before, dp, one,
                                              testing.DIHE_STAT_UPDATES)
    require(ranks[0]["dihe"]["digest"] == ranks[1]["dihe"]["digest"],
            "the ranks' DIHE players differ after the DP step")
    require(dihe_diff["stat_updates_kept"], "DP DIHE step: a BatchNorm's "
            "update count differs from the JAX step's")
    for key, tol in testing.DIHE_STEP_TOL.items():
        require(dihe_diff[key] <= tol, f"DP DIHE step against one process: "
                f"{key} {dihe_diff[key]} > {tol}")

    gallery = torch.from_numpy(inputs["gallery"]).cuda()
    queries = torch.from_numpy(inputs["queries"]).cuda()
    knn_rows = {}
    for k in (1, 8):
        d1, i1 = knn_ops.nearest_neighbors_fused(gallery, queries, k)
        for r, out in enumerate(ranks):
            got = out["knn"][k]
            require(torch.equal(got["idx"], i1.cpu()),
                    f"sharded search (k={k}) on rank {r} differs from the "
                    "single search")
            require(float((got["dists"] - d1.cpu()).abs().max()) <= KNN_TOL,
                    f"sharded search (k={k}) distances on rank {r}")
            require(got["launches"] == 1 and got["kernels"] == 3,
                    f"rank {r}: K2 launches {got['launches']}, kernels "
                    f"{got['kernels']} (norms, scan, merge)")
        require(bool((i1[:2, 0] == 5).all()), "the tie across the ranks "
                "did not go to the lowest index")
        knn_rows[k] = [out["knn"][k]["launches"] for out in ranks]

    want = evaluate_gln(inputs["eval_state"], inputs["eval_items"],
                        inputs["eval_config"], thresholds=(0.5,),
                        batch_size=1, device="cuda")
    for r, out in enumerate(ranks):
        require(_same_metrics(out["eval"], want),
                f"evaluate_gln(mesh) on rank {r} differs from the non-mesh "
                "metrics")
        require(out["eval_launches"] > 0, f"rank {r}: K1 not launched in "
                "evaluate_gln(mesh)")
    launches = {"nms_hard": [out["eval_launches"] for out in ranks],
                "knn_fused": knn_rows[1]}
    emit({"phase": "parallel.ranks2", "backend": "gloo", "world_size": 2,
          "device": "cuda:0 (both ranks)",
          "gln": {"canvas": [h, w], "global_batch": TRAIN_BATCH, **gln_diff,
                  "losses": ranks[0]["gln"]["metrics"],
                  "step_seconds": [o["gln"]["step_seconds"] for o in ranks],
                  "max_memory_allocated": [o["gln"]["max_memory_allocated"]
                                           for o in ranks]},
          "dihe": {"canvas": [DIHE_PARITY_HW] * 2, "global_batch": 2,
                   **dihe_diff,
                   "step_seconds": [o["dihe"]["step_seconds"]
                                    for o in ranks]},
          "knn": {"gallery": PARALLEL_GALLERY,
                  "queries": PARALLEL_QUERIES, "launches": knn_rows,
                  "seconds": [o["knn_seconds"] for o in ranks]},
          "eval": {"scenes": PARALLEL_EVAL_SCENES,
                   "ap": float(want[0.5]["ap"]),
                   "seconds": [o["eval_seconds"] for o in ranks]},
          "launches": launches, "ranks_seconds": ranks_s,
          "tolerances": {"train": testing.TRAIN_STEP_TOL,
                         "dihe": testing.DIHE_STEP_TOL, "knn": KNN_TOL},
          "seconds": time.perf_counter() - t0})
    return launches


SPATIAL_RANKS = 4
SPATIAL_STRIP = 1024  # columns a rank: 4 serve scenes side by side
SPATIAL_ONE_RANK_WIDTH = 1408  # 11 x 128
SPATIAL_REPS = 3
# a canvas width that is no multiple of 128 x SPATIAL_RANKS: strips of
# 1024 columns, the last 448 of the padded canvas pad (parallel/spatial.py)
SPATIAL_PADDED_WIDTH = 3648
SPATIAL_HALOS = 78  # exchanges a GLN forward (parallel/spatial.py)
SPATIAL_SCORE_TOL = 1e-4  # JAX's own test's bounds (tests/test_parallel_e2e.py)
SPATIAL_BOX_TOL = 1e-2  # px


def spatial_canvases(scenes, h: int, w: int):
    """The scenes each on an (h, w) canvas as ProposalGenerator(
    input_norm='raw01') puts them, on the host: (B, h, w, 3), content
    sizes (B, 2)."""
    canvases, sizes = [], []
    for img in scenes:
        canvas, _, content, _ = T.detection_canvas(img, None, h, w,
                                                   normalize=False)
        canvases.append(canvas.cpu())
        sizes.append(content)
    return torch.stack(canvases), torch.tensor(sizes, dtype=torch.float32)


def spatial_regions(prof) -> Dict:
    """{name: count, host ms, kernel ms, device span ms} of the traced
    `spatial.*` regions: the host ranges (their count, wall time, and
    the device time of the kernels their ops launched) and, on the
    card, the profiler's device-side copies of each range (the span
    from its first to its last device activity)."""
    regions = {}
    for e in prof.events():
        if not e.name.startswith("spatial."):
            continue
        r = regions.setdefault(e.name, {"count": 0, "host_ms": 0.0,
                                        "kernel_ms": 0.0,
                                        "device_span_ms": 0.0})
        if e.device_type == torch.autograd.DeviceType.CPU:
            r["count"] += 1
            r["host_ms"] += e.cpu_time_total / 1e3
            r["kernel_ms"] += e.device_time_total / 1e3
        else:
            r["device_span_ms"] += e.time_range.elapsed_us() / 1e3
    return regions


def spatial_worker(rank: int, port: int, work: Path) -> int:
    """One of parallel.spatial's SPATIAL_RANKS ranks, all on cuda:0 over
    gloo: make_spatial_infer on the wide photo in `work`, a warm-up,
    SPATIAL_REPS timed runs with K1 counted, make_spatial_forward's
    gathered outputs, and on rank 0 one run under utils.profiling.trace
    (`reps` and `trace` in the inputs change the last two); the results
    go to work/rank<r>.pt."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    initialize_multihost(f"tcp://127.0.0.1:{port}", SPATIAL_RANKS, rank,
                         local_rank=0, backend="gloo",
                         timeout=datetime.timedelta(seconds=300))
    mesh = spatial_mesh()
    inputs = torch.load(work / "inputs.pt", weights_only=False)
    config = inputs["config"]
    model = GLN(config)
    model.load_state_dict(inputs["state"])
    run = make_spatial_infer(model, config, mesh)
    image, sizes = inputs["image"], inputs["sizes"]
    run(image, sizes)
    torch.cuda.synchronize()
    seconds, launches = [], []
    for _ in range(inputs.get("reps", SPATIAL_REPS)):
        dist.barrier()
        _reset_launches()
        ts = time.perf_counter()
        dets = run(image, sizes)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - ts)
        launches.append(_launches()["nms_hard"])
    outputs = make_spatial_forward(model, config, mesh)(image)
    dist.barrier()
    regions = None
    if rank == 0 and inputs.get("trace", True):
        with profiling.trace(str(work / "trace")) as prof:
            ts = time.perf_counter()
            run(image, sizes)
            torch.cuda.synchronize()
            traced_s = time.perf_counter() - ts
        regions = spatial_regions(prof)
        regions["run"] = {"host_ms": traced_s * 1e3}
    else:
        run(image, sizes)
        torch.cuda.synchronize()
    torch.save({"detections": {k: v.cpu() for k, v in dets.items()},
                "outputs": ({k: v.cpu() for k, v in outputs.items()}
                            if rank == 0 else None),
                "seconds": seconds, "launches": launches,
                "regions": regions,
                "max_memory_allocated": torch.cuda.max_memory_allocated()},
               work / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def _spatial_padded(par, base, image, work: Path) -> Dict:
    """The SPATIAL_RANKS gloo ranks again at 832 x SPATIAL_PADDED_WIDTH
    (the wide photo's first columns), a width that is no multiple of 128
    x ranks: rank 0's detections held to the one-process forward at that
    width as the 832x4096 run's are, every rank's equal, K1 once a rank
    a run."""
    config = dataclasses.replace(base, canvas_w=SPATIAL_PADDED_WIDTH)
    require(config.canvas_w % (128 * SPATIAL_RANKS),
            "SPATIAL_PADDED_WIDTH splits evenly")
    image = image[:, :, :config.canvas_w].contiguous()
    sizes = torch.tensor([[config.canvas_h, config.canvas_w]],
                         dtype=torch.float32)
    work = work / "padded"
    work.mkdir()
    torch.save({"state": par["gln_state"], "config": config, "image": image,
                "sizes": sizes, "reps": 1, "trace": False},
               work / "inputs.pt")
    ts = time.perf_counter()
    ranks = _run_ranks(work, "spatial", SPATIAL_RANKS)
    ranks_s = time.perf_counter() - ts
    model = GLN(config)
    model.load_state_dict(par["gln_state"])
    model.cuda()
    anchors, counts = config.anchors()
    with torch.inference_mode():
        outputs = model(image.cuda())
        want = postprocess_detections(outputs, torch.from_numpy(
            anchors).cuda(), counts, sizes.cuda(), config)
    want = {k: v.cpu() for k, v in want.items()}
    got = ranks[0]["detections"]
    for r, out in enumerate(ranks):
        for key, v in out["detections"].items():
            require(torch.equal(v, got[key]), f"parallel.spatial padded: "
                    f"rank {r}'s {key} differs from rank 0's")
        require(out["launches"] == [1], f"parallel.spatial padded: rank "
                f"{r}: K1 launches {out['launches']}")
    keep = want["valid"]
    keep_diff = int((got["valid"] != keep).sum())
    score_err = float((got["scores"][keep] - want["scores"][keep]).abs().max())
    box_err = float((got["boxes"][keep] - want["boxes"][keep]).abs().max())
    require(keep_diff == 0 and bool(keep.any()),
            f"parallel.spatial padded: {keep_diff} keep-set differences "
            f"from the one-process forward ({int(keep.sum())} kept)")
    require(score_err <= SPATIAL_SCORE_TOL and box_err <= SPATIAL_BOX_TOL,
            f"parallel.spatial padded against one process: scores "
            f"{score_err}, boxes {box_err} px")
    gathered = ranks[0]["outputs"]
    for key, v in outputs.items():
        require(tuple(gathered[key].shape) == tuple(v.shape),
                f"parallel.spatial padded: gathered {key} "
                f"{tuple(gathered[key].shape)}, not {tuple(v.shape)}")
    strip = strip_width(config.canvas_w, SPATIAL_RANKS)
    return {"canvas": [config.canvas_h, config.canvas_w],
            "strip": [config.canvas_h, strip],
            "pad_columns": strip * SPATIAL_RANKS - config.canvas_w,
            "detections": int(keep.sum()), "keep_set_differences": keep_diff,
            "max_score_err": score_err, "max_box_err_px": box_err,
            "max_gaussians_err": float((gathered["gaussians"]
                                        - outputs["gaussians"].cpu())
                                       .abs().max()),
            "run_seconds": ranks[0]["seconds"],
            "launches": [out["launches"][-1] for out in ranks],
            "ranks_seconds": ranks_s}


def phase_parallel_spatial(par, seed):
    """Width-sharded GLN inference (parallel/spatial.py) on the serve
    detector. World size 1 over parallel.init's NCCL group at
    832x1408: make_spatial_infer on the 4 serve scenes bit for bit the
    one-process forward and postprocess, K1 once a call. Then
    SPATIAL_RANKS gloo ranks on the one card at 832x4096 (the 4 scenes
    side by side, a strip of 1024 columns a rank): rank 0's detections
    within JAX's test bounds of the one-process forward at 832x4096 on
    the card with no keep-set difference, every rank's equal, K1 once a
    rank a run, 78 halo exchanges a forward; seconds beside the one
    process's and the halo / gather / postprocess split. Last the same
    ranks at a width that is no multiple of 128 x ranks
    (`_spatial_padded`)."""
    t0 = time.perf_counter()
    base = par["config"]
    mesh = spatial_mesh()
    config = dataclasses.replace(base, canvas_w=SPATIAL_ONE_RANK_WIDTH)
    canvases, sizes = spatial_canvases(par["scenes"], base.canvas_h,
                                       config.canvas_w)
    model = GLN(config)
    model.load_state_dict(par["gln_state"])
    run = make_spatial_infer(model, config, mesh)
    _reset_launches()
    ts = time.perf_counter()
    got = run(canvases, sizes)
    torch.cuda.synchronize()
    one_rank_s = time.perf_counter() - ts
    one_rank_k1 = _launches()["nms_hard"]
    anchors, counts = config.anchors()
    with torch.inference_mode():
        want = postprocess_detections(
            model(canvases.cuda()), torch.from_numpy(anchors).cuda(),
            counts, sizes.cuda(), config)
    for key in want:
        require(torch.equal(got[key], want[key]),
                f"make_spatial_infer at world size 1: {key} differs from "
                "the one-process forward")
    require(one_rank_k1 == 1, f"K1 launched {one_rank_k1} times in a world "
                              "size 1 spatial run")
    one_rank = {"canvas": [config.canvas_h, config.canvas_w],
                "images": len(canvases), "backend": dist.get_backend(),
                "detections": int(want["valid"].sum()),
                "seconds": one_rank_s, "launches": one_rank_k1}
    dist.destroy_process_group()
    del model, run, got, want
    torch.cuda.empty_cache()

    work = BUILD / "spatial"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    config = dataclasses.replace(base, canvas_w=SPATIAL_RANKS
                                 * SPATIAL_STRIP)
    strips, _ = spatial_canvases(par["scenes"], base.canvas_h,
                                 SPATIAL_STRIP)
    image = torch.cat(list(strips), dim=1)[None]
    sizes = torch.tensor([[config.canvas_h, config.canvas_w]],
                         dtype=torch.float32)
    torch.save({"state": par["gln_state"], "config": config, "image": image,
                "sizes": sizes}, work / "inputs.pt")
    ts = time.perf_counter()
    ranks = _run_ranks(work, "spatial", SPATIAL_RANKS)
    ranks_s = time.perf_counter() - ts

    model = GLN(config)
    model.load_state_dict(par["gln_state"])
    model.cuda()
    anchors, counts = config.anchors()
    anchors = torch.from_numpy(anchors).cuda()

    def one_process():
        with torch.inference_mode():
            outputs = model(image.cuda())
            return outputs, postprocess_detections(
                outputs, anchors, counts, sizes.cuda(), config)

    one_process()
    torch.cuda.synchronize()
    one_s = []
    for _ in range(SPATIAL_REPS):
        ts = time.perf_counter()
        outputs, want = one_process()
        torch.cuda.synchronize()
        one_s.append(time.perf_counter() - ts)
    want = {k: v.cpu() for k, v in want.items()}
    got = ranks[0]["detections"]
    for r, out in enumerate(ranks):
        for key, v in out["detections"].items():
            require(torch.equal(v, got[key]), f"parallel.spatial: rank {r}'s "
                    f"{key} differs from rank 0's")
        require(out["launches"] == [1] * SPATIAL_REPS, f"rank {r}: K1 "
                f"launches {out['launches']} in {SPATIAL_REPS} runs")
    keep_diff = int((got["valid"] != want["valid"]).sum())
    keep = want["valid"]
    score_err = float((got["scores"][keep] - want["scores"][keep]).abs().max())
    box_err = float((got["boxes"][keep] - want["boxes"][keep]).abs().max())
    require(keep_diff == 0 and bool(keep.any()),
            f"parallel.spatial: {keep_diff} keep-set differences from the "
            f"one-process forward ({int(keep.sum())} kept)")
    require(score_err <= SPATIAL_SCORE_TOL and box_err <= SPATIAL_BOX_TOL,
            f"parallel.spatial against one process: scores {score_err}, "
            f"boxes {box_err} px")
    gathered = ranks[0]["outputs"]
    levels, start = [], 0
    for count in counts:
        levels.append({key: float((gathered[key][:, start:start + count]
                                   - outputs[key][:, start:start + count]
                                   .cpu()).abs().max())
                       for key in ("cls_logits", "bbox_regression")})
        start += count
    regions = ranks[0]["regions"]
    halos = regions.get("spatial.halo", {}).get("count", 0)
    require(halos == SPATIAL_HALOS, f"parallel.spatial: {halos} halo "
            f"exchanges in a traced forward, not {SPATIAL_HALOS}")
    launches = {"one_rank": one_rank_k1,
                "ranks4": [out["launches"][-1] for out in ranks]}
    gaussians_err = float((gathered["gaussians"]
                           - outputs["gaussians"].cpu()).abs().max())
    del model, outputs
    torch.cuda.empty_cache()
    padded = _spatial_padded(par, base, image, work)
    launches["padded"] = padded["launches"]
    emit({"phase": "parallel.spatial", "one_rank": one_rank,
          "padded": padded,
          "ranks": {"world_size": SPATIAL_RANKS, "backend": "gloo",
                    "device": "cuda:0 (every rank)",
                    "canvas": [config.canvas_h, config.canvas_w],
                    "strip": [config.canvas_h, SPATIAL_STRIP],
                    "detections": int(keep.sum()),
                    "keep_set_differences": keep_diff,
                    "max_score_err": score_err, "max_box_err_px": box_err,
                    "max_gaussians_err": gaussians_err,
                    "levels": levels,
                    "run_seconds": [out["seconds"] for out in ranks],
                    "run_median_s": statistics.median(ranks[0]["seconds"]),
                    "one_process_s": one_s,
                    "one_process_median_s": statistics.median(one_s),
                    "launches_per_run": [out["launches"] for out in ranks],
                    "halo_exchanges": halos, "regions": regions,
                    "max_memory_allocated": [out["max_memory_allocated"]
                                             for out in ranks],
                    "ranks_seconds": ranks_s},
          "tolerances": {"score": SPATIAL_SCORE_TOL,
                         "box_px": SPATIAL_BOX_TOL},
          "seconds": time.perf_counter() - t0})
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    # parallel.ranks2 and parallel.spatial start this script again as each
    # of their ranks
    ap.add_argument("--parallel-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-port", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-dir", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--parallel-job", choices=("ranks2", "spatial"),
                    default="ranks2", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if args.parallel_rank is not None:
        worker = {"ranks2": parallel_worker,
                  "spatial": spatial_worker}[args.parallel_job]
        return worker(args.parallel_rank, args.parallel_port,
                      args.parallel_dir)
    t0 = time.perf_counter()
    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "allow_tf32": False, "seed": args.seed,
          "seconds": time.perf_counter() - t0})

    t0 = time.perf_counter()
    info = _build.build_all()
    emit({"phase": "build", "kernels": {
        name: {"seconds": v["seconds"],
               "ptxas": [ln.strip() for ln in v["log"].splitlines()
                         if "registers" in ln or "spill" in ln]}
        for name, v in info.items()}, "seconds": time.perf_counter() - t0})

    timer = Timer()
    rng = np.random.default_rng(args.seed)
    phase_kernels(timer, rng)
    pool_rows, pool_launches = phase_fused_pool(timer, rng)
    launches, nms_serve, knn_serve, ctx = phase_serve(timer, args.seed)
    soft_launches, soft_serve = phase_serve_soft(timer, ctx)
    phase_serve_int8(ctx, args.seed)
    phase_eval(ctx, args.seed)
    phase_knn_wide(timer)
    mac_launches, knn_mac = phase_serve_macresnet(timer, ctx, args.seed)
    phase_load_reference(args.seed)
    orbax_launches = phase_load_orbax(ctx, args.seed)
    phase_data_perspective(ctx, args.seed)
    ref = reference_gln_checkpoint(args.seed)
    data_launches = phase_data_files(ctx, args.seed, ref, smi)
    jpeg_launches = phase_data_jpeg(ctx, args.seed, smi)
    video_launches = phase_data_video(ctx, args.seed, smi)
    cli_launches = phase_cli(ctx, args.seed, ref, smi)
    dihe_cli_launches = phase_cli_dihe(ctx, args.seed, smi)
    # the parallel phases' detector (its head calibrated), embedder and
    # scenes, on the host: the phases between keep the card as they had it
    par = {"gln_state": {k: v.cpu() for k, v in
                         ctx["pg"].model.state_dict().items()},
           "config": ctx["pg"].config,
           "vgg_state": {k: v.cpu() for k, v in
                         ctx["vgg"].state_dict().items()},
           "styles": ctx["styles"], "scenes": [s[0] for s in ctx["scenes"]]}
    del ctx
    gc.collect()
    phase_train_parity(args.seed, ref)
    train_launches, f32_run = phase_train_gln(args.seed, ref)
    phase_train_parity_bf16(args.seed, ref)
    train_bf16_launches, _ = phase_train_gln(
        args.seed, ref, "bfloat16", f32_run, smi)
    phase_train_resume(args.seed, ref)
    phase_train_dihe_parity(args.seed)
    gan_state = phase_train_gan(args.seed)
    dihe_launches = phase_train_dihe(args.seed, gan_state)
    del gan_state
    phase_train_dihe_resume(args.seed)
    phase_parallel_init()
    serve_par = phase_parallel_serve(par, args.seed)
    ranks_par = phase_parallel_ranks2(par, args.seed, ref)
    spatial_par = phase_parallel_spatial(par, args.seed)
    del par
    pool_row = dict(pool_rows[0])
    pool_row["max_abs_err"] = max(r["max_abs_err"] for r in pool_rows)
    # K2's row times serve.macresnet's 1536-d search; the MACVGG serve
    # path's (D = 1024) rides along, and the DIHE epoch evals' launches
    d1024 = {k: knn_serve[k] for k in ("shape", "ms", "plain_ms",
                                        "bound_ms", "library_ms")}
    parallel = {name: {"serve": serve_par[name], "ranks2": ranks_par[name]}
                for name in ("nms_hard", "knn_fused")}
    parallel["nms_hard"]["spatial"] = spatial_par
    rows = {"nms_hard": dict(nms_serve, launches=launches["nms_hard"],
                             orbax_launches=orbax_launches["nms_hard"],
                             train_launches=train_launches,
                             train_bf16_launches=train_bf16_launches,
                             parallel_launches=parallel["nms_hard"],
                             data_files_launches=data_launches["nms_hard"],
                             data_jpeg_launches=jpeg_launches["nms_hard"],
                             data_video_launches=video_launches["nms_hard"],
                             cli_launches=cli_launches["nms_hard"]),
            "knn_fused": dict(knn_mac, launches=mac_launches["knn_fused"],
                              d1024=dict(d1024,
                                         launches=launches["knn_fused"]),
                              orbax_launches=orbax_launches["knn_fused"],
                              dihe_train_launches=dihe_launches,
                              parallel_launches=parallel["knn_fused"],
                              data_files_launches=data_launches[
                                  "knn_fused"],
                              data_jpeg_launches=jpeg_launches[
                                  "knn_fused"],
                              cli_launches=cli_launches["knn_fused"],
                              cli_dihe_launches=dihe_cli_launches[
                                  "knn_fused"]),
            "soft_nms": dict(soft_serve,
                             launches=soft_launches["soft_nms"]),
            "pool_int8_conv": dict(pool_row, launches=pool_launches)}
    replaces = {
        "nms_hard": ("cvpce_tpu_torch/csrc/nms_hard.cu",
                     "cvpce_tpu/ops/nms_pallas.py:31"),
        "knn_fused": ("cvpce_tpu_torch/csrc/knn_fused.cu",
                      "cvpce_tpu/ops/knn_pallas.py:29"),
        "soft_nms": ("cvpce_tpu_torch/csrc/soft_nms.cu",
                     "cvpce_tpu/ops/nms_pallas.py:99"),
        "pool_int8_conv": ("cvpce_tpu_torch/csrc/pool_int8_conv.cu",
                           "cvpce_tpu/ops/conv_pallas.py:73"),
    }
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    extra = {"nms_hard": ("orbax_launches", "train_launches",
                          "train_bf16_launches",
                          "parallel_launches", "data_files_launches",
                          "data_jpeg_launches", "data_video_launches",
                          "cli_launches"),
             "knn_fused": ("d1024", "orbax_launches", "dihe_train_launches",
                           "parallel_launches", "data_files_launches",
                           "data_jpeg_launches", "cli_launches",
                           "cli_dihe_launches")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": replaces[name][0],
         "replaces": replaces[name][1],
         **{k: row[k] for k in keys + extra.get(name, ())}}
        for name, row in rows.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
