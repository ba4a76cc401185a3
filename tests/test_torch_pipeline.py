"""The port's serving pipeline against the JAX package's: planogram
graphs and matching, RANSAC finalization, the Classifier's index file,
and the slice end to end — detect (GLN, artifacts/gln_r5) -> crops ->
embed (MACVGG, artifacts/dihe_r4) -> kNN -> compliance — on small
windows of synthetic planogram scenes, through both PlanogramEvaluators
on the CPU."""
import jax
import numpy as np
import pytest
import torch

from cvpce_tpu.data import synthetic as j_syn
from cvpce_tpu.data import transforms as j_T
from cvpce_tpu.models.embedders import MACVGG as JMACVGG
from cvpce_tpu.models.embedders import EmbedFn as JEmbedFn
from cvpce_tpu.models.embedders import fold_bn_variables as j_fold_bn
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.ops.knn import nearest_neighbors as j_nn
from cvpce_tpu.pipeline import Classifier as JClassifier
from cvpce_tpu.pipeline import PlanogramComparator as JComparator
from cvpce_tpu.pipeline import ProposalGenerator as JProposalGenerator
from cvpce_tpu.pipeline import planograms as j_pg
from cvpce_tpu.pipeline.evaluator import PlanogramEvaluator as JEvaluator
from cvpce_tpu.pipeline.serving import load_dihe_encoder, load_gln_variables
from cvpce_tpu_torch.models.embedders import MACVGG, EmbedFn, fold_bn_variables
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.pipeline import planograms as pg
from cvpce_tpu_torch.pipeline.classifier import Classifier
from cvpce_tpu_torch.pipeline.evaluator import (PlanogramComparator,
                                                PlanogramEvaluator)
from cvpce_tpu_torch.pipeline.proposals import ProposalGenerator
from cvpce_tpu_torch.utils.weights import gln_state_dict, macvgg_state_dict

H, W = 256, 384          # scene window: products keep their trained scale
THRESHOLD = 0.4837080240249634  # artifacts/gln_r5 serving_calibration.json
N_STYLES = 8


def scene_window(seed, violation_rate):
    """A 256x384 window of a full-size planogram scene (bottom shelf),
    with the planogram slots that lie inside it."""
    styles = j_syn.product_styles(N_STYLES)
    img, plano, _, _ = j_syn.planogram_scene(
        832, 1344, styles, np.random.default_rng((seed, 9)),
        violation_rate=violation_rate, min_shelves=4, max_shelves=4)
    y0, x0 = 832 - H - 8, 200
    b = plano["boxes"]
    inside = ((b[:, 0] >= x0) & (b[:, 2] <= x0 + W)
              & (b[:, 1] >= y0) & (b[:, 3] <= y0 + H))
    planogram = {
        "boxes": b[inside] - np.array([x0, y0, x0, y0], np.float32),
        "labels": [lbl for lbl, k in zip(plano["labels"], inside) if k]}
    intact = [v for v, k in zip(plano["violations"], inside) if k]
    return (np.ascontiguousarray(img[y0:y0 + H, x0:x0 + W]), planogram,
            intact.count("intact") / len(intact))


def gallery():
    items = []
    for s in j_syn.product_styles(N_STYLES):
        img = j_T.scale_to_tanh(j_T.resize_for_classification(
            j_syn.product_gallery_image(s)))
        items.append((img, img, s["label"], s["label"]))
    return items


@pytest.fixture(scope="module")
def evaluators():
    gln = jax.device_get(load_gln_variables("artifacts/gln_r5"))
    params, stats = jax.device_get(load_dihe_encoder("artifacts/dihe_r4"))
    items = gallery()
    j_fn = JEmbedFn(JMACVGG(batch_norm=False),
                    j_fold_bn({"params": params, "batch_stats": stats}))
    j_eval = JEvaluator(
        JProposalGenerator(gln, JGLNConfig(canvas_h=H, canvas_w=W),
                           confidence_threshold=THRESHOLD,
                           input_norm="raw01"),
        JClassifier(j_fn, 1024, sample_set=items),
        JComparator(use_native=False))
    vgg = MACVGG(batch_norm=True)
    vgg.load_state_dict(macvgg_state_dict(params, stats))
    fn = EmbedFn(fold_bn_variables(vgg), device="cpu")
    t_eval = PlanogramEvaluator(
        ProposalGenerator(gln_state_dict(gln),
                          GLNConfig(canvas_h=H, canvas_w=W),
                          confidence_threshold=THRESHOLD,
                          input_norm="raw01", device="cpu"),
        Classifier(fn, 1024, sample_set=items, device="cpu"),
        PlanogramComparator(device="cpu"))
    return j_eval, t_eval


@pytest.mark.parametrize("seed,violation_rate", [(0, 0.0), (1, 0.4),
                                                 (2, 0.4)])
def test_end_to_end_compliance_matches_jax(evaluators, seed,
                                           violation_rate):
    """Equal compliance and fallback path per scene. The JAX generator
    crops with its bf16 einsum resampler, the port with the f32 gather;
    on these scenes both classify every crop alike."""
    j_eval, t_eval = evaluators
    img, planogram, expected = scene_window(seed, violation_rate)
    want = j_eval.evaluate_detailed(img, planogram)
    got = t_eval.evaluate_detailed(img, planogram)
    assert got[2] == want[2] == "ransac"
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    # trained weights on in-domain scenes: the slot count is recovered
    assert got[0] == pytest.approx(expected)


def test_detections_match_jax(evaluators):
    j_eval, t_eval = evaluators
    img, _, _ = scene_window(3, 0.2)
    want = j_eval.proposal_generator.detect(img)
    got = t_eval.proposal_generator.detect(img)
    keep_j = want["valid"] & (want["scores"] > THRESHOLD)
    keep_t = got["valid"] & (got["scores"] > THRESHOLD)
    np.testing.assert_array_equal(keep_t, keep_j)
    # f32 convolutions in another order move boxes by a few 1e-3 px
    np.testing.assert_allclose(got["boxes"][keep_t], want["boxes"][keep_j],
                               atol=1e-2)
    assert got["gaussians"].shape == want["gaussians"].shape


def test_empty_detections_give_empty_crops(evaluators):
    _, t_eval = evaluators
    crops = t_eval.proposal_generator.crop_boxes(
        np.zeros((64, 64, 3), np.float32), np.zeros((0, 4), np.float32))
    assert tuple(crops.shape) == (0, 256, 256, 3)
    score, found, path = t_eval.comparator.compare_detailed(
        {"boxes": np.ones((3, 4), np.float32), "labels": ["a"] * 3},
        {"boxes": np.zeros((0, 4), np.float32), "labels": []})
    assert (score, found, path) == (0.0, None, "no_detections")


def test_classifier_index_loads_across_packages(evaluators, tmp_path):
    j_eval, t_eval = evaluators
    j_path, t_path = tmp_path / "jax.npz", tmp_path / "torch.npz"
    j_eval.classifier.save_index(str(j_path))
    t_eval.classifier.save_index(str(t_path))
    emb_j, ann_j = JClassifier.load_index(str(t_path))
    emb_t, ann_t = Classifier.load_index(str(j_path))
    assert ann_j == ann_t == [f"prod_{i:02d}" for i in range(N_STYLES)]
    np.testing.assert_allclose(emb_j, emb_t, atol=1e-5)  # unit vectors
    loaded = Classifier(t_eval.classifier.encoder_fn, 1024,
                        load=str(j_path), device="cpu")
    crops = np.stack([it[0] for it in gallery()])
    assert [r[0] for r in loaded.classify(crops)] == ann_t


def test_classifier_large_gallery_takes_fused_path(tmp_path):
    rng = np.random.default_rng(0)
    emb = rng.normal(size=(4096, 64)).astype(np.float32)
    anns = [f"item{i}" for i in range(4096)]
    np.savez(tmp_path / "big.npz", embedding=emb,
             annotations=np.array(anns, dtype=object))
    clf = Classifier(lambda x: torch.as_tensor(x), 64,
                     load=str(tmp_path / "big.npz"), k=3, device="cpu")
    assert clf._use_fused
    queries = rng.normal(size=(40, 64)).astype(np.float32)
    want = np.asarray(j_nn(emb, queries, 3))
    assert clf.classify(queries) == [[anns[j] for j in row] for row in want]


@pytest.mark.parametrize("seed", [0, 1])
def test_graph_and_matching_match_networkx(seed):
    img, planogram, _ = scene_window(seed, 0.3)
    styles = j_syn.product_styles(N_STYLES)
    _, _, actual, _ = j_syn.planogram_scene(
        832, 1344, styles, np.random.default_rng((seed, 9)),
        violation_rate=0.3, min_shelves=4, max_shelves=4)
    boxes, labels = actual["boxes"], actual["labels"]
    jg, tg = j_pg.build_graph(boxes, labels), pg.build_graph(boxes, labels)
    assert list(tg) == list(jg.nodes)
    for n in jg.nodes:
        assert tg.nodes[n] == jg.nodes[n]
        assert list(tg[n].items()) == list(jg[n].items())
    pb, pl = planogram["boxes"], planogram["labels"]
    jp, tp = j_pg.build_graph(pb, pl), pg.build_graph(pb, pl)
    assert pg.large_common_subgraph(tp, tg) == \
        j_pg.large_common_subgraph(jp, jg)
    assert pg.build_hypotheses(tp, tg) == j_pg.build_hypotheses(jp, jg)


def test_finalize_via_ransac_matches_jax():
    styles = j_syn.product_styles(N_STYLES)
    _, plano, actual, _ = j_syn.planogram_scene(
        832, 1344, styles, np.random.default_rng(4), violation_rate=0.3)
    shift = np.array([13.0, -7.0, 13.0, -7.0], np.float32)
    b1, l1 = plano["boxes"], plano["labels"]
    b2, l2 = actual["boxes"] + shift, actual["labels"]
    g1, g2 = pg.build_graph(b1, l1), pg.build_graph(b2, l2)
    sol = pg.large_common_subgraph(g1, g2)
    got = pg.finalize_via_ransac(sol, b1, b2, l1, l2, device="cpu")
    want = j_pg.finalize_via_ransac(sol, b1, b2, l1, l2)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], atol=1e-2)  # px
    assert got[3] == want[3]
