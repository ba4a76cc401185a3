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
  correction, the native graph matcher held against the Python one).

Prints one JSON line per phase with its elapsed seconds, then the
`{"kernels": [...]}` line, the card's name and power limit as nvidia-smi
prints them, and last `{"ok": true, "device": {...}}`. Any failed check
raises, so the script exits non-zero without that last line. Needs one
CUDA card; fails without one.

    python3 chip_smoke.py [--seed 0]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from cvpce_tpu_torch import _build, testing
from cvpce_tpu_torch.data import synthetic
from cvpce_tpu_torch.data import transforms as T
from cvpce_tpu_torch.eval import (eval_dihe, evaluate_detections,
                                  evaluate_gln, evaluate_planograms,
                                  mean_average_metrics)
from cvpce_tpu_torch.eval.proposals import make_variables_inference_fn
from cvpce_tpu_torch.models.embedders import EmbedFn, MACVGG, fold_bn_variables
from cvpce_tpu_torch.models.gln import GLN, GLNConfig, fold_gln_backbone
from cvpce_tpu_torch.ops import conv_fused
from cvpce_tpu_torch.ops import knn as knn_ops
from cvpce_tpu_torch.ops import nms as nms_ops
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
from cvpce_tpu_torch.pipeline.proposals import ProposalGenerator

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
        canvas, _, (ch, cw), _ = pg._canvas(img)
        sizes = torch.tensor([[ch, cw]], dtype=torch.float32, device="cuda")
        res = pg.infer(canvas[None], sizes, return_candidates=True)
        keep_p = nms_ops.nms_mask(res["cand_boxes"], res["cand_scores"],
                                  res["cand_valid"], config.nms_thresh)
        keep_mismatches = int((keep_p != res["keep"]).sum())
        require(keep_mismatches == 0,
                f"scene {i}: NMS kernel keep mask differs from plain "
                f"({keep_mismatches} entries)")
        boxes = res["boxes"][res["valid"]]
        require(torch.isfinite(boxes).all(), "non-finite detections")
        n_det = int((res["valid"] & (res["scores"] > pg.confidence_threshold))
                    .sum())
        crops = pg.crop_boxes(img, res["boxes"][0][:n_det].cpu().numpy())
        require(tuple(crops.shape[1:]) == (256, 256, 3), "crop shape")
        # K2 against knn_plain on every scene's crops, 32 at a time as
        # the Classifier searches
        knn_mismatches = 0
        for s0 in range(0, n_det, clf.batch_size):
            emb = clf._embed(crops[s0:s0 + clf.batch_size])
            d_k, i_k = knn_ops.nearest_neighbors_fused(
                clf._anchors_dev, emb, 1, clf._anchor_inv_norms)
            d_p, i_p = knn_ops.knn_plain(clf._anchors_dev, emb, 1)
            knn_mismatches += knn_index_check(
                d_k, i_k, d_p, i_p,
                knn_ops.distance_matrix(emb, clf._anchors_dev),
                f"scene {i} crops")[1]
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
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
    pool_row = dict(pool_rows[0])
    pool_row["max_abs_err"] = max(r["max_abs_err"] for r in pool_rows)
    rows = {"nms_hard": dict(nms_serve, launches=launches["nms_hard"]),
            "knn_fused": dict(knn_serve, launches=launches["knn_fused"]),
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
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": replaces[name][0],
         "replaces": replaces[name][1],
         **{k: row[k] for k in keys}} for name, row in rows.items()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
