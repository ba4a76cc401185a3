"""The port's evaluation and calibration path against the JAX package's:
calibration resolvers and files, serving metadata, Classifier
index_average, detect_with_crops, and on the trained artifacts/gln_r5 +
artifacts/dihe_r4 weights at 256x384 windows of synthetic planogram
scenes: evaluate_gln (directly and through DetectionEvalAdapter),
calibrate_confidence and evaluate_detections. evaluate_planograms and
eval_dihe are in tests/test_torch_eval_compliance.py, so the two halves
can run on two workers."""
import os

import numpy as np
import pytest
import torch

from cvpce_tpu.data import synthetic as j_syn
from cvpce_tpu.eval import detection as j_detection
from cvpce_tpu.eval import proposals as j_proposals
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.pipeline import calibrate as j_cal
from cvpce_tpu.pipeline import serving as j_serving
from cvpce_tpu.pipeline.classifier import Classifier as JClassifier
from cvpce_tpu_torch.eval import detection, proposals
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.pipeline import calibrate as cal
from cvpce_tpu_torch.pipeline import serving
from cvpce_tpu_torch.pipeline.classifier import Classifier
from torch_eval_common import (DIHE_DIR, GLN_DIR, H, J_BATCH, N_STYLES,
                               SCORE_TOL, THRESHOLD, W, WindowDetSet,
                               WindowTestSet, assert_metrics)
from torch_eval_common import stack  # noqa: F401 (module-scoped fixture)


# ------------------------------------------------- calibration resolvers

def test_resolve_explicit_number_wins(tmp_path):
    cal.save_calibration(str(tmp_path), {"threshold": 0.8})
    assert cal.resolve_threshold(0.3, str(tmp_path)) == pytest.approx(0.3)
    assert cal.resolve_threshold("0.25", str(tmp_path)) == \
        pytest.approx(0.25)


def test_resolve_auto_reads_calibration_or_falls_back(tmp_path):
    assert cal.resolve_threshold("auto", str(tmp_path)) == 0.5
    assert cal.resolve_threshold("auto", None) == 0.5
    cal.save_calibration(str(tmp_path), {"threshold": 0.62, "f1": 0.9})
    assert cal.resolve_threshold("auto", str(tmp_path)) == 0.62
    assert cal.resolve_threshold(None, str(tmp_path)) == 0.62


def test_calibration_dir_for_weights(tmp_path):
    run = tmp_path / "run"
    ckpt = run / "checkpoint"
    ckpt.mkdir(parents=True)
    (ckpt / "blob").write_text("x")
    cal.save_calibration(str(run), {"threshold": 0.44})
    for weights in (run, ckpt, ckpt / "blob"):
        d = cal.calibration_dir_for_weights(str(weights))
        assert d == j_cal.calibration_dir_for_weights(str(weights))
        assert cal.resolve_threshold("auto", d) == pytest.approx(0.44)
    assert cal.calibration_dir_for_weights(None) is None
    bare = tmp_path / "bare"
    bare.mkdir()
    d = cal.calibration_dir_for_weights(str(bare))
    assert d == str(bare) and cal.resolve_threshold("auto", d) == 0.5


def test_resolve_input_norm(tmp_path):
    assert cal.resolve_input_norm(None) == "imagenet"
    assert cal.resolve_input_norm(str(tmp_path)) == "imagenet"
    assert cal.resolve_input_norm(str(tmp_path), default="raw01") == "raw01"
    cal.save_calibration(str(tmp_path), {"threshold": 0.5,
                                         "input_norm": "raw01"})
    assert cal.resolve_input_norm(str(tmp_path)) == "raw01"
    cal.save_calibration(str(tmp_path), {"threshold": 0.5})
    assert cal.resolve_input_norm(str(tmp_path)) == "imagenet"


def test_committed_calibration_resolves_as_in_jax():
    d = cal.calibration_dir_for_weights(
        os.path.join(GLN_DIR, "serving_checkpoint"))
    assert d == GLN_DIR
    assert cal.resolve_threshold("auto", d) == THRESHOLD
    assert cal.resolve_input_norm(d) == "raw01"
    assert cal.load_calibration(d) == j_cal.load_calibration(d)


def test_calibration_files_cross_packages(tmp_path):
    record = {"threshold": 0.71, "f1": 0.88, "precision": 0.9,
              "recall": 0.86, "iou_threshold": 0.5, "n_images": 16,
              "input_norm": "raw01"}
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    cal.save_calibration(str(tmp_path / "t"), record)
    j_cal.save_calibration(str(tmp_path / "j"), record)
    assert j_cal.load_calibration(str(tmp_path / "t")) == record
    assert cal.load_calibration(str(tmp_path / "j")) == record
    assert cal.load_calibration(str(tmp_path / "missing")) is None
    assert (tmp_path / "t" / "serving_calibration.json").read_bytes() == \
        (tmp_path / "j" / "serving_calibration.json").read_bytes()


class TinyDetSet:
    """Four 8x8 images, two gt boxes each (tests/test_calibrate.py)."""

    boxes = np.asarray([[0, 0, 4, 4], [4, 4, 8, 8]], np.float32)

    def __len__(self):
        return 4

    def __getitem__(self, i):
        return {"image": np.zeros((8, 8, 3), np.float32),
                "boxes": self.boxes,
                "image_size": np.array([8, 8], np.int32),
                "scale": np.float32(1.0),
                "orig_boxes": self.boxes.copy()}


def fake_max_f1(variables, images, sizes):
    b = images.shape[0]
    boxes = np.asarray([[0, 0, 4, 4], [4, 4, 8, 8], [0, 4, 4, 8]],
                       np.float32)
    return {"boxes": np.tile(boxes[None], (b, 1, 1)),
            "scores": np.tile(np.asarray([0.9, 0.9, 0.2], np.float32)[None],
                              (b, 1)),
            "valid": np.ones((b, 3), bool)}


def fake_noise(variables, images, sizes):
    b = images.shape[0]
    junk = np.stack([np.asarray([0, 0, 2, 2], np.float32) + i
                     for i in range(4)])
    boxes = np.concatenate(
        [np.asarray([[0, 0, 4, 4], [4, 4, 8, 8]], np.float32), junk])
    scores = np.asarray([0.6, 0.6, 0.55, 0.55, 0.55, 0.55], np.float32)
    return {"boxes": np.tile(boxes[None], (b, 1, 1)),
            "scores": np.tile(scores[None], (b, 1)),
            "valid": np.ones((b, 6), bool)}


@pytest.mark.parametrize("infer_fn,batch,norm", [(fake_max_f1, 2, "raw01"),
                                                 (fake_noise, 4,
                                                  "imagenet")])
def test_calibrate_confidence_on_fake_detectors(infer_fn, batch, norm):
    got = cal.calibrate_confidence({}, GLNConfig(canvas_h=8, canvas_w=8),
                                   TinyDetSet(), batch_size=batch,
                                   infer_fn=infer_fn, input_norm=norm,
                                   device="cpu")
    want = j_cal.calibrate_confidence({}, JGLNConfig(canvas_h=8, canvas_w=8),
                                      TinyDetSet(), batch_size=batch,
                                      infer_fn=infer_fn, input_norm=norm)
    assert got == want
    assert got["f1"] == pytest.approx(1.0) and got["input_norm"] == norm


def test_serving_meta_matches_jax(tmp_path):
    for d in (GLN_DIR, DIHE_DIR, str(tmp_path)):
        assert serving.load_serving_meta(d) == j_serving.load_serving_meta(d)
    assert serving.load_serving_meta(GLN_DIR)
    assert serving.load_serving_meta(str(tmp_path)) == {}


def test_index_average_matches_jax(stack, tmp_path):
    """2 styles x 4 variants collapse to 2 mean embeddings."""
    styles = j_syn.product_styles(2)
    items = [j_syn.ArchetypeGallerySet(styles, views=4, seed=3)[i]
             for i in range(8)]
    got = Classifier(stack["t_enc"], 1024, sample_set=items,
                     index_average=4, device="cpu")
    want = JClassifier(stack["j_enc"], 1024, sample_set=items,
                       batch_size=J_BATCH, index_average=4)
    assert got.annotations == want.annotations == ["prod_00", "prod_01"]
    np.testing.assert_allclose(got.embedding, want.embedding, atol=1e-5)
    with pytest.raises(AssertionError, match="divide"):
        Classifier(stack["t_enc"], 1024, sample_set=items[:6],
                   index_average=4, device="cpu")
    with pytest.raises(AssertionError, match="share one annotation"):
        Classifier(stack["t_enc"], 1024, sample_set=items[2:],
                   index_average=3, device="cpu")
    path = str(tmp_path / "index.npz")
    got.save_index(path)
    with pytest.warns(UserWarning, match="index_average"):
        loaded = Classifier(stack["t_enc"], 1024, load=path,
                            index_average=4, device="cpu")
    assert loaded.annotations == got.annotations


@pytest.mark.parametrize("seed", [0, 1])
def test_detect_with_crops_matches_jax(stack, seed):
    img = stack["windows"][seed]["image"]
    got = stack["t_pg"].detect_with_crops(img)
    want = stack["j_pg"].detect_with_crops(img)
    assert len(got["boxes"]) == len(want["boxes"]) > 0
    # f32 convolutions in another order move boxes by a few 1e-3 px
    # (tests/test_torch_pipeline.py)
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-2)
    np.testing.assert_allclose(got["scores"], want["scores"],
                               atol=SCORE_TOL, rtol=0)
    assert tuple(got["crops"].shape) == (len(got["boxes"]), 256, 256, 3)
    torch.testing.assert_close(
        got["crops"], stack["t_pg"].crop_boxes(img, got["boxes"]))
    boxes, crops = stack["t_pg"].generate_proposals_and_images(img)
    np.testing.assert_array_equal(boxes, got["boxes"])


def test_evaluate_gln_and_calibration_match_jax(stack):
    ds = WindowDetSet(stack["windows"])
    thresholds = (0.5, 0.75)
    got, (tg, pr, cf) = proposals.evaluate_gln(
        stack["state"], ds, GLNConfig(canvas_h=H, canvas_w=W),
        thresholds=thresholds, batch_size=2, return_detections=True,
        device="cpu")
    want, (j_tg, j_pr, j_cf) = j_proposals.evaluate_gln(
        stack["gln"], ds, JGLNConfig(canvas_h=H, canvas_w=W),
        thresholds=thresholds, batch_size=1, return_detections=True,
        infer_fn=stack["j_infer"])
    assert_metrics(got, want)
    assert got[0.5]["ap"] > 0.5  # trained weights find the products
    for a, b in zip(cf, j_cf):
        np.testing.assert_allclose(a, b, atol=SCORE_TOL, rtol=0)

    got_cal = cal.calibrate_confidence(
        stack["state"], GLNConfig(canvas_h=H, canvas_w=W), ds,
        batch_size=3, input_norm="raw01", device="cpu")
    want_cal = j_cal.calibrate_confidence(
        stack["gln"], JGLNConfig(canvas_h=H, canvas_w=W), ds, batch_size=1,
        infer_fn=stack["j_infer"], input_norm="raw01")
    assert got_cal.keys() == want_cal.keys()
    for key, value in want_cal.items():
        if key == "threshold":
            assert got_cal[key] == pytest.approx(value, abs=SCORE_TOL)
        else:
            assert got_cal[key] == value, key


def test_evaluate_gln_through_adapter_matches_jax(stack, tmp_path):
    def extract(w):
        return w["image"], w["boxes"]

    got = proposals.evaluate_gln(
        stack["state"], proposals.DetectionEvalAdapter(
            stack["windows"], extract, H, W, device="cpu"),
        GLNConfig(canvas_h=H, canvas_w=W), batch_size=3,
        plot_out=str(tmp_path / "prfc.png"), device="cpu")
    want = j_proposals.evaluate_gln(
        stack["gln"], j_proposals.DetectionEvalAdapter(
            stack["windows"], extract, H, W),
        JGLNConfig(canvas_h=H, canvas_w=W), batch_size=1,
        infer_fn=stack["j_infer"])
    assert_metrics(got, want)
    # plot_out draws each threshold's P/R/F1 curves (utils/viz.py)
    assert sorted(os.listdir(tmp_path)) == ["prfc_iou0.5.png"]


def test_evaluate_detections_matches_jax(stack):
    ts = WindowTestSet(stack["windows"])
    thresholds = (0.5,)
    got_pc, got_all = detection.evaluate_detections(
        stack["t_pg"], stack["t_clf"], ts, thresholds, verbose=False)
    want_pc, want_all = j_detection.evaluate_detections(
        stack["j_pg"], stack["j_clf"], ts, thresholds, verbose=False)
    assert list(got_pc) == list(want_pc) == list(range(N_STYLES))
    for c in want_pc:
        assert_metrics(got_pc[c], want_pc[c])
    assert_metrics(got_all, want_all)
    assert got_all[0.5]["ap"] > 0.5
    assert detection.mean_average_metrics(got_pc, thresholds) == \
        j_detection.mean_average_metrics(want_pc, thresholds)
