"""The public functions of the JAX package's ops that nothing on a main
path calls, against the port's counterparts on the same numpy inputs:
`ops/nms.py:nms_topk` (hard NMS + static top-k; boxes, scores and the
valid mask equal), `ops/image.py:resize_bilinear` and
`pad_to_square_resize` (within 2e-6: f32 bilinear sums in XLA's and
torch's order) and `ops/losses.py:hierarchy_similarity_matrix`
(equal)."""
import numpy as np
import pytest
import torch

from cvpce_tpu.ops import image as j_image
from cvpce_tpu.ops import losses as j_losses
from cvpce_tpu.ops import nms as j_nms
from cvpce_tpu_torch.ops import image, losses, nms

RESIZE_TOL = 2e-6


def _boxes(rng, n, extent=120.0):
    cx, cy = rng.uniform(0, extent, n), rng.uniform(0, extent, n)
    w, h = rng.uniform(4, 50, n), rng.uniform(4, 50, n)
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    1).astype(np.float32)


@pytest.mark.parametrize("n, k, valid_share, ties", [
    (40, 10, 1.0, False), (40, 40, 0.7, False), (64, 64, 0.5, True),
    (1, 1, 1.0, False), (25, 5, 0.0, False), (9, 12, 1.0, False)])
def test_nms_topk_matches_jax(n, k, valid_share, ties):
    """Kept boxes by score; past them (k above the kept count) the
    suppressed boxes JAX's top_k picks, lowest index first; k above the
    box count raises in both."""
    rng = np.random.default_rng(n * 100 + k)
    boxes = _boxes(rng, n)
    scores = rng.random(n).astype(np.float32)
    if ties:
        scores = np.round(scores * 4) / 4
    valid = rng.random(n) < valid_share
    if k > n:
        with pytest.raises(ValueError):
            j_nms.nms_topk(boxes, scores, valid, k)
        with pytest.raises(ValueError):
            nms.nms_topk(torch.from_numpy(boxes), torch.from_numpy(scores),
                         torch.from_numpy(valid), k)
        return
    jb, js, jv = (np.asarray(x) for x in j_nms.nms_topk(
        boxes, scores, valid, k, iou_threshold=0.4))
    pb, ps, pv = nms.nms_topk(torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(valid), k,
                              iou_threshold=0.4)
    np.testing.assert_array_equal(pv.numpy(), jv)
    np.testing.assert_array_equal(ps.numpy(), js)
    np.testing.assert_array_equal(pb.numpy(), jb)
    # a batch of one is the same
    bb, bs, bv = nms.nms_topk(torch.from_numpy(boxes)[None],
                              torch.from_numpy(scores)[None],
                              torch.from_numpy(valid)[None], k,
                              iou_threshold=0.4)
    np.testing.assert_array_equal(bb[0].numpy(), jb)
    np.testing.assert_array_equal(bv[0].numpy(), jv)


@pytest.mark.parametrize("hw, out", [
    ((37, 53, 3), (64, 64)), ((64, 48, 3), (17, 90)), ((5, 9, 4), (5, 9)),
    ((1, 1, 3), (3, 2)), ((120, 80, 1), (256, 256))])
def test_resize_bilinear_matches_jax(hw, out):
    rng = np.random.default_rng(sum(hw) + sum(out))
    img = rng.random(hw).astype(np.float32)
    want = np.asarray(j_image.resize_bilinear(img, *out))
    got = image.resize_bilinear(torch.from_numpy(img), *out).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("hw, out", [
    ((37, 53, 3), 64), ((64, 48, 3), 256), ((30, 30, 4), 16),
    ((1, 7, 3), 8)])
def test_pad_to_square_resize_matches_jax(hw, out):
    rng = np.random.default_rng(sum(hw) * 7 + out)
    img = rng.random(hw).astype(np.float32)
    want = np.asarray(j_image.pad_to_square_resize(img, out))
    got = image.pad_to_square_resize(torch.from_numpy(img), out).numpy()
    assert got.shape == want.shape == (out, out, hw[2])
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL)


@pytest.mark.parametrize("b", (1, 7, 64))
def test_hierarchy_similarity_matrix_matches_jax(b):
    rng = np.random.default_rng(b)
    depth = rng.integers(0, 5, b).astype(np.int32)
    shared = np.minimum(rng.integers(0, 5, b), depth).astype(np.int32)
    prefix = rng.random(b) < 0.3
    want = np.asarray(j_losses.hierarchy_similarity_matrix(depth, shared,
                                                          prefix))
    got = losses.hierarchy_similarity_matrix(
        torch.from_numpy(depth), torch.from_numpy(shared),
        torch.from_numpy(prefix)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
