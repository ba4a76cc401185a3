"""The port's detection metric stack (ops/metrics.py) and COCO referee
(eval/coco_protocol.py) against the JAX package's, on the golden corpus
of tests/test_metrics_golden.py, on 20 seeded corpora with empty
images, confidence ties and IoUs exactly at a threshold, and on the
pycocotools fixture corpus. The matcher runs on the CPU here; on the
card chip_smoke.py holds it to the CPU result."""
import json
import os
import sys

import numpy as np
import pytest

from cvpce_tpu.eval import coco_protocol as j_coco
from cvpce_tpu.ops import metrics as j_metrics
from cvpce_tpu_torch.eval import coco_protocol as coco
from cvpce_tpu_torch.ops import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("ap", "ar_300", "f", "p", "r", "c")
COCO_THRESHOLDS = tuple(float(t) for t in
                        np.round(np.arange(0.5, 1.0, 0.05), 2))

# the golden corpus of tests/test_metrics_golden.py
TARGETS = [
    np.array([[0, 0, 1, 1], [1, 0, 2, 1], [1, 1, 2, 2]], np.float32),
    np.array([[1, 1, 2, 2], [3, 1, 4, 2], [5, 1, 6, 2], [7, 1, 8, 2]],
             np.float32),
    np.array([[0, 0, 5, 5], [5, 5, 10, 10]], np.float32),
]
PREDICTIONS = [
    np.array([[0, 0, 0.9, 0.9], [1.1, 0.1, 1.9, 0.9], [0, 0, 1, 1],
              [0.9, 0.9, 2.1, 2.1], [3, 3, 4, 4]], np.float32),
    np.array([[1, 0, 2, 1], [1, 1, 2, 2], [5, 1, 6, 2],
              [7, 1.1, 8, 1.9], [9, 9, 10, 10]], np.float32),
    np.array([[0, 0, 1, 1], [1, 1, 3, 3], [0.5, 0.5, 4.5, 4.5],
              [0, 0, 6, 6], [6, 6, 9, 9]], np.float32),
]
CONFIDENCES = [
    np.array([1, 0.8, 0.6, 0.4, 0.2], np.float32),
    np.array([0.9, 0.8, 0.7, 0.65, 0.5], np.float32),
    np.array([0.85, 0.6, 0.4, 0.2, 0.1], np.float32),
]


def calc(targets, preds, confs, thresholds=(0.5,)):
    return metrics.calculate_metrics(targets, preds, confs, thresholds,
                                     device="cpu")


def assert_same_results(got, want):
    assert list(got) == list(want)
    for t in want:
        for key in KEYS:
            assert got[t][key] == want[t][key], (t, key)
        for key in ("p", "r", "f", "c"):
            np.testing.assert_array_equal(got[t]["raw"][key],
                                          want[t]["raw"][key])


def assert_same_matches(targets, preds, confs, thresholds):
    for tgt, pred, conf in zip(targets, preds, confs):
        tp, c = metrics.match_detections(tgt, pred, conf, thresholds,
                                         device="cpu")
        j_tp, j_c = j_metrics.match_detections(tgt, pred, conf, thresholds)
        np.testing.assert_array_equal(tp, j_tp)
        np.testing.assert_array_equal(c, j_c)


# ------------------------------------------------------ golden corpus

def test_golden_greedy_match_threshold_065():
    tp, conf = metrics.match_detections(TARGETS[0], PREDICTIONS[0],
                                        CONFIDENCES[0], [0.65],
                                        device="cpu")
    np.testing.assert_array_equal(tp[0], [1, 0, 0, 1, 0])
    np.testing.assert_allclose(conf, [1, 0.8, 0.6, 0.4, 0.2])


def test_golden_calculate_metrics_values():
    res = calc(TARGETS, PREDICTIONS, CONFIDENCES)[0.5]
    p, r = 7 / 12, 7 / 9
    assert res["ap"] == pytest.approx(
        (1 + 1 + 5 / 7 + 5 / 7 + 5 / 7 + 5 / 7 + 7 / 12 + 7 / 12) / 11,
        rel=1e-6)
    assert res["ar_300"] == pytest.approx((1 + 3 / 4 + 1 / 2) / 3, rel=1e-6)
    assert res["p"] == pytest.approx(p, rel=1e-6)
    assert res["r"] == pytest.approx(r, rel=1e-6)
    assert res["f"] == pytest.approx(2 * p * r / (p + r), rel=1e-6)


@pytest.mark.parametrize("thresholds", [(0.5,), (0.5, 0.75),
                                        COCO_THRESHOLDS])
def test_golden_corpus_matches_jax(thresholds):
    assert_same_matches(TARGETS, PREDICTIONS, CONFIDENCES, thresholds)
    assert_same_results(
        calc(TARGETS, PREDICTIONS, CONFIDENCES, thresholds),
        j_metrics.calculate_metrics(TARGETS, PREDICTIONS, CONFIDENCES,
                                    thresholds))


def test_one_prediction_consumes_all_overlapping_targets():
    targets = np.array([[0, 0, 10, 10], [8, 0, 18, 10]], np.float32)
    preds = np.array([[0, 0, 17, 10], [0, 0, 10, 10]], np.float32)
    conf = np.array([0.9, 0.8], np.float32)
    tp, _ = metrics.match_detections(targets, preds, conf, [0.5],
                                     device="cpu")
    np.testing.assert_array_equal(tp[0], [1, 0])


def test_empty_predictions_and_streaming():
    res = calc([TARGETS[0]], [np.zeros((0, 4), np.float32)],
               [np.zeros(0, np.float32)])
    assert res[0.5]["ap"] == 0.0 and res[0.5]["f"] == 0.0
    streaming = metrics.StreamingMetrics((0.5,), device="cpu")
    for t, p, c in zip(TARGETS, PREDICTIONS, CONFIDENCES):
        streaming.add(t, p, c)
    assert_same_results(streaming.result(),
                        calc(TARGETS, PREDICTIONS, CONFIDENCES))


# ---------------------------------------------------- seeded corpora

def seeded_corpus(seed):
    """Integer-grid boxes (so IoUs such as 1/2 and 3/4 are exact in any
    order of operations), jittered and exact copies of targets,
    duplicates, false positives, confidences drawn from a few levels
    (ties), images without targets or without predictions."""
    rng = np.random.default_rng(seed)
    targets, preds, confs = [], [], []
    for _ in range(int(rng.integers(3, 8))):
        n_t = int(rng.choice([0, 1, 3, 6, 10]))
        xy = rng.integers(0, 60, (n_t, 2))
        wh = rng.integers(2, 12, (n_t, 2))
        tgt = np.concatenate([xy, xy + wh], 1).astype(np.float32)
        rows = []
        for box in tgt:
            kind = rng.integers(0, 5)
            if kind == 0:
                rows.append(box)  # exact
            elif kind == 1:  # IoU exactly 1/2: width doubled
                rows.append(box + [0, 0, box[2] - box[0], 0])
            elif kind == 2:  # IoU 3/4 or 2/3 or other: shifted by one
                rows.append(box + [1, 0, 1, 0])
            elif kind == 3:
                rows += [box, box + rng.normal(0, 1.0, 4)]  # duplicate
        n_fp = int(rng.integers(0, 4))
        fxy = rng.integers(0, 70, (n_fp, 2))
        fwh = rng.integers(2, 12, (n_fp, 2))
        rows += list(np.concatenate([fxy, fxy + fwh], 1))
        if rng.random() < 0.15:
            rows = []
        pred = np.asarray(rows, np.float32).reshape(-1, 4)
        conf = rng.choice([0.3, 0.5, 0.5, 0.7, 0.9, 1.0],
                          len(pred)).astype(np.float32)
        targets.append(tgt)
        preds.append(pred)
        confs.append(conf)
    return targets, preds, confs


@pytest.mark.parametrize("seed", range(20))
def test_seeded_corpus_matches_jax(seed):
    targets, preds, confs = seeded_corpus(seed)
    thresholds = (0.5, 2 / 3, 0.75) + COCO_THRESHOLDS[5:]
    assert_same_matches(targets, preds, confs, thresholds)
    assert_same_results(
        calc(targets, preds, confs, thresholds),
        j_metrics.calculate_metrics(targets, preds, confs, thresholds))


def test_seeded_corpora_hit_exact_thresholds_and_ties():
    """The corpora above do reach the cases they are meant for."""
    at_half = ties = empty_t = empty_p = 0
    for seed in range(20):
        targets, preds, confs = seeded_corpus(seed)
        for tgt, pred, conf in zip(targets, preds, confs):
            empty_t += not len(tgt)
            empty_p += not len(pred)
            ties += len(conf) - len(np.unique(conf))
            if len(tgt) and len(pred):
                ious = np.asarray(j_metrics.pairwise_iou(pred, tgt))
                at_half += int((ious == 0.5).sum())
    assert min(at_half, ties, empty_t, empty_p) > 0


# ---------------------------------------------------------- COCO referee

def coco_images(module, corpus, n_cats):
    images = {}
    for c in range(n_cats):
        per_image = []
        for im in corpus:
            gt = np.asarray([g["box"] for g in im["gts"] if g["cat"] == c],
                            np.float64).reshape(-1, 4)
            dt = [d for d in im["dets"] if d["cat"] == c]
            db = np.asarray([d["box"] for d in dt], np.float64).reshape(-1, 4)
            ds = np.asarray([d["score"] for d in dt], np.float64)
            gt = np.concatenate([gt[:, :2], gt[:, :2] + gt[:, 2:]], 1)
            db = np.concatenate([db[:, :2], db[:, :2] + db[:, 2:]], 1)
            per_image.append(module.ImageDetections(db, ds, gt))
        images[f"cat{c}"] = per_image
    return images


def assert_same_coco(got, want):
    for key in ("ap", "ap50", "ap75", "ar"):
        assert got[key] == want[key] or (np.isnan(got[key])
                                         and np.isnan(want[key])), key
    for group in ("per_area", "per_threshold"):
        assert list(got[group]) == list(want[group])
        np.testing.assert_array_equal(list(got[group].values()),
                                      list(want[group].values()))


def test_coco_protocol_on_pycoco_fixture():
    with open(os.path.join(REPO, "tests", "fixtures",
                           "pycoco_golden.json")) as f:
        fixture = json.load(f)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        from make_pycoco_fixture import make_corpus
    finally:
        sys.path.pop(0)
    corpus = make_corpus(fixture["seed"])
    n = fixture["n_cats"]
    got = coco.evaluate_coco_protocol(coco_images(coco, corpus, n))
    want = j_coco.evaluate_coco_protocol(coco_images(j_coco, corpus, n))
    assert_same_coco(got, want)
    for key in ("ap", "ap50", "ap75", "ar"):
        assert got[key] == fixture["ours"][key], key


@pytest.mark.parametrize("max_dets", [1, 10, 100])
def test_coco_protocol_on_seeded_corpus(max_dets):
    targets, preds, confs = seeded_corpus(7)
    images = {None: [coco.ImageDetections(p.astype(np.float64),
                                          c.astype(np.float64),
                                          t.astype(np.float64))
                     for t, p, c in zip(targets, preds, confs)]}
    j_images = {None: [j_coco.ImageDetections(d.det_boxes, d.det_scores,
                                              d.gt_boxes)
                       for d in images[None]]}
    assert_same_coco(
        coco.evaluate_coco_protocol(images, max_dets=max_dets),
        j_coco.evaluate_coco_protocol(j_images, max_dets=max_dets))
