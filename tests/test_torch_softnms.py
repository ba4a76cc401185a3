"""The port's Soft-NMS, box merging and soft/merge postprocess against
the JAX package on the same seeded inputs: ops/nms.py:soft_nms_scores
(both methods) against the JAX plain version and the Pallas kernel in
interpret mode (on seeded boxes and on the edge cases of
cvpce_tpu_torch.testing that pin what the CUDA kernel's chain must keep),
merge_boxes, and postprocess_detections with
nms_mode='soft' and merge_boxes on and off fed the same head outputs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.models.gln import postprocess_detections as j_post
from cvpce_tpu.ops.nms import merge_boxes as j_merge
from cvpce_tpu.ops.nms import nms_mask as j_nms
from cvpce_tpu.ops.nms import soft_nms_scores as j_soft
from cvpce_tpu.ops.nms_pallas import soft_nms_scores_pallas as j_soft_pallas
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.models.gln import GLNConfig, postprocess_detections
from cvpce_tpu_torch.ops import nms

H, W = 128, 192


def random_boxes(rng, n, extent=150.0):
    xy = rng.uniform(0, extent, (n, 2)).astype(np.float32)
    wh = rng.uniform(5, 60, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


def case(n, seed):
    rng = np.random.default_rng(seed)
    return (random_boxes(rng, n), rng.uniform(size=n).astype(np.float32),
            rng.uniform(size=n) > 0.1)


# n = 120 and 200 are no multiple of the TPU kernel's 256 alignment
@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("n,seed", [(120, 7), (200, 8), (256, 9)])
def test_soft_nms_matches_jax(method, n, seed):
    boxes, scores, valid = case(n, seed)
    want = np.asarray(j_soft(boxes, scores, valid, 0.5, 0.5, method))
    want_k = np.asarray(j_soft_pallas(boxes, scores, valid, 0.5, 0.5,
                                      method, interpret=True))
    got = nms.soft_nms_scores(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(valid), 0.5, 0.5, method)
    # tolerance of tests/test_nms_pallas.py: exp / IoU rounding in
    # another library, over up to n sequential decays
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), want_k, rtol=1e-4, atol=1e-6)
    assert (got.numpy()[~valid] == 0).all()


# identical boxes (every round decays all the others, the linear rule to
# exactly 0, so later rounds pick among equal zeros); exact score ties,
# initial and after decays that meet, where the lowest index must win; a
# batch whose middle image has no valid entry; N = 33, one past a
# 32-entry group. JAX runs one image at a time.
@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("case,n", [("identical", 40), ("ties", 150),
                                    ("empty_image", 60), ("n33", None)])
def test_soft_nms_edge_cases_match_jax(method, case, n):
    boxes, scores, valid = testing.soft_nms_case(
        case, np.random.default_rng(17), n)
    got = nms.soft_nms_scores(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(valid), 0.5, 0.5,
                              method).numpy()
    for b in range(boxes.shape[0]):
        args = (boxes[b], scores[b], valid[b], 0.5, 0.5, method)
        want = np.asarray(j_soft(*args))
        want_k = np.asarray(j_soft_pallas(*args, interpret=True))
        np.testing.assert_allclose(got[b], want, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got[b], want_k, rtol=1e-4, atol=1e-6)
    assert (got[~valid] == 0).all()
    if case == "empty_image":
        assert not valid[1].any() and (got[1] == 0).all()
    if case == "identical" and method == "linear":
        # the first winner keeps its score, every other one falls to 0
        first = int(np.argmax(scores[0]))
        assert got[0, first] == scores[0, first]
        assert np.count_nonzero(got[0]) == 1
    if case == "ties" and method == "linear":
        # _tie_triples: A decays to exactly B's score, the lower index of
        # the two wins and decays the other by 1 - 0.6
        tie = scores[0, 2]
        lose = tie * (np.float32(1) - np.float32(12) / np.float32(20))
        np.testing.assert_array_equal(
            got[0, :6], np.float32([1.0, tie, lose, 1.0, tie, lose]))


def test_soft_nms_batch_and_fused_wrapper_on_cpu():
    """A batch answers as its images one by one; on CPU tensors the
    fused wrapper is the plain version and launches nothing."""
    cases = [case(150, s) for s in (1, 2)]
    boxes, scores, valid = (torch.from_numpy(np.stack(a))
                            for a in zip(*cases))
    batch = nms.soft_nms_scores(boxes, scores, valid)
    for i in range(2):
        torch.testing.assert_close(
            batch[i], nms.soft_nms_scores(boxes[i], scores[i], valid[i]),
            rtol=0, atol=0)
    before = nms.soft_nms_scores_fused.launches
    fused = nms.soft_nms_scores_fused(boxes, scores, valid, 0.5, 0.5,
                                      "linear")
    assert nms.soft_nms_scores_fused.launches == before
    torch.testing.assert_close(
        fused, nms.soft_nms_scores(boxes, scores, valid, 0.5, 0.5, "linear"),
        rtol=0, atol=0)
    with pytest.raises(ValueError):
        nms.soft_nms_scores(boxes, scores, valid, method="box")


def test_merge_boxes_matches_jax():
    boxes, scores, valid = case(180, 4)
    keep = np.asarray(j_nms(boxes, scores, valid, 0.5))
    want = np.asarray(j_merge(boxes, scores, valid, keep, 0.5))
    got = nms.merge_boxes(*(torch.from_numpy(a)
                            for a in (boxes, scores, valid, keep)), 0.5)
    # score-weighted means summed in another order (f32 matmul)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got.numpy()[~keep], boxes[~keep])
    batched = nms.merge_boxes(*(torch.from_numpy(np.stack([a, a]))
                                for a in (boxes, scores, valid, keep)))
    torch.testing.assert_close(batched[1], got, rtol=0, atol=0)


def head_outputs(seed, anchors_total, b=2):
    rng = np.random.default_rng(seed)
    logits = rng.normal(-2.0, 2.0, (b, anchors_total, 1)).astype(np.float32)
    regs = rng.normal(0.0, 0.3, (b, anchors_total, 4)).astype(np.float32)
    return {"cls_logits": logits, "bbox_regression": regs}


@pytest.mark.parametrize("mode,merge", [("soft", False), ("soft", True),
                                        ("hard", True)])
def test_postprocess_soft_and_merge_match_jax(mode, merge):
    opts = dict(canvas_h=H, canvas_w=W, detections_per_img=300,
                max_nms_candidates=1024, nms_mode=mode, merge_boxes=merge)
    jcfg = JGLNConfig(**opts)
    cfg = GLNConfig(**opts)
    anchors, counts = cfg.anchors()
    outs = head_outputs(3, len(anchors))
    sizes = np.array([[H, W], [100, 150]], np.float32)
    want = jax.device_get(j_post(outs, jnp.asarray(anchors), counts,
                                 jnp.asarray(sizes), jcfg))
    got = postprocess_detections(
        {k: torch.from_numpy(v) for k, v in outs.items()},
        torch.from_numpy(anchors), counts, torch.from_numpy(sizes), cfg,
        return_candidates=True)
    assert int(got["num_candidates"].min()) == 1024
    if mode == "soft":
        assert "soft_scores" in got
        assert int(got["keep"].sum()) > int(got["valid"].sum()) // 2
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    # the sigmoids differ by up to one f32 ulp (ROADMAP Queue 3), and
    # Soft-NMS carries that through its sequential decays
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"],
                               rtol=1e-5, atol=1e-3)


def test_postprocess_soft_differs_from_hard():
    """Soft-NMS re-scores instead of dropping: another survivor set,
    every score decayed or kept, the best candidate untouched."""
    cfg = GLNConfig(canvas_h=H, canvas_w=W, detections_per_img=300,
                    max_nms_candidates=1024)
    anchors, counts = cfg.anchors()
    outs = {k: torch.from_numpy(v)
            for k, v in head_outputs(5, len(anchors), b=1).items()}
    args = (torch.from_numpy(anchors), counts, torch.tensor([[H, W]]))
    hard = postprocess_detections(outs, *args, cfg, return_candidates=True)
    soft = postprocess_detections(
        outs, *args, dataclasses.replace(cfg, nms_mode="soft"),
        return_candidates=True)
    assert not torch.equal(soft["keep"], hard["keep"])
    assert (soft["soft_scores"] <= soft["cand_scores"]).all()
    assert float(soft["scores"][0, 0]) == float(hard["scores"][0, 0])
