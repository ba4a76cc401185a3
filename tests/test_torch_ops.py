"""The port's tensor ops against the JAX package on the same numpy
inputs: boxes, anchors, hard NMS (plain and kernel wrapper), kNN (plain
and kernel wrapper), crops and RANSAC. On the CPU the kernel wrappers
run their plain versions; tests/test_torch_cuda.py holds the kernels
themselves on a card."""
import jax
import numpy as np
import pytest
import torch

from cvpce_tpu.ops import anchors as j_anchors
from cvpce_tpu.ops import boxes as j_boxes
from cvpce_tpu.ops import image as j_image
from cvpce_tpu.ops.knn import l2_normalize as j_l2_normalize
from cvpce_tpu.ops.knn import nearest_neighbors as j_nn
from cvpce_tpu.ops.knn_pallas import nearest_neighbors_fused as j_nn_fused
from cvpce_tpu.ops.nms import nms_mask as j_nms
from cvpce_tpu.ops.nms_pallas import nms_mask_pallas
from cvpce_tpu.ops.ransac import find_homography_ransac as j_ransac
from cvpce_tpu_torch.ops import anchors, boxes, image, knn, nms, ransac


def random_boxes(rng, n, extent=200.0):
    cx, cy = rng.uniform(0, extent, n), rng.uniform(0, extent, n)
    w, h = rng.uniform(4, 60, n), rng.uniform(4, 60, n)
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                    1).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a))


def test_pairwise_iou_matches_jax():
    rng = np.random.default_rng(0)
    a, b = random_boxes(rng, 40), random_boxes(rng, 30)
    a[0] = [5, 5, 5, 9]  # degenerate: zero area
    want = np.asarray(j_boxes.pairwise_iou(a, b))
    got = boxes.pairwise_iou(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)  # f32 rounding


def test_decode_boxes_matches_jax():
    rng = np.random.default_rng(1)
    anc = random_boxes(rng, 50)
    deltas = rng.normal(0, 1.5, (50, 4)).astype(np.float32)
    deltas[0, 2] = 9.0  # beyond the log(1000/16) clip
    want = np.asarray(j_boxes.decode_boxes(deltas, anc))
    got = boxes.decode_boxes(t(deltas), t(anc)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("hw", [(128, 192), (832, 1344)])
def test_grid_anchors_match_jax(hw):
    want, want_counts = j_anchors.grid_anchors(*hw)
    got, counts = anchors.grid_anchors(*hw)
    assert counts == want_counts
    np.testing.assert_array_equal(got, want)


def nms_inputs(seed, n):
    rng = np.random.default_rng(seed)
    b = random_boxes(rng, n)
    s = rng.uniform(0, 1, n).astype(np.float32)
    s[: n // 10] = s[n // 10: 2 * (n // 10)]  # exact score ties
    v = rng.uniform(0, 1, n) < 0.9
    return b, s, v


@pytest.mark.parametrize("seed,n", [(0, 37), (1, 256), (2, 700)])
def test_nms_mask_matches_jax_and_pallas(seed, n):
    """Keep masks equal to ops/nms.py:nms_mask and to the Pallas kernel
    in interpret mode, for the plain version and the kernel wrapper."""
    b, s, v = nms_inputs(seed, n)
    want = np.asarray(j_nms(b, s, v, 0.5))
    pallas = np.asarray(nms_mask_pallas(b, s, v, 0.5, interpret=True))
    plain = nms.nms_mask(t(b), t(s), t(v), 0.5).numpy()
    fused = nms.nms_mask_fused(t(b), t(s), t(v), 0.5).numpy()
    np.testing.assert_array_equal(plain, want)
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(fused, plain)


def test_nms_batched_equals_per_image():
    ins = [nms_inputs(seed, 300) for seed in range(3)]
    bb, ss, vv = (torch.stack([t(x[i]) for x in ins]) for i in range(3))
    batched = nms.nms_mask_fused(bb, ss, vv, 0.5)
    for i, (b, s, v) in enumerate(ins):
        np.testing.assert_array_equal(batched[i].numpy(),
                                      np.asarray(j_nms(b, s, v, 0.5)))


def test_nms_keep_sorted_walks_only_valid_prefix():
    b, s, v = nms_inputs(3, 256)
    bs, vs, n_walk, _ = nms.sort_candidates(t(b)[None], t(s)[None],
                                            t(v)[None])
    assert int(n_walk[0]) == int(v.sum())
    full = nms.nms_keep_sorted_plain(bs, torch.tensor([256]), 0.5)
    part = nms.nms_keep_sorted_plain(bs, n_walk, 0.5)
    np.testing.assert_array_equal((full & vs).numpy(), (part & vs).numpy())


def test_nms_cpu_wrapper_does_not_launch():
    before = nms.nms_keep_sorted.launches
    b, s, v = nms_inputs(4, 64)
    nms.nms_mask_fused(t(b), t(s), t(v), 0.5)
    assert nms.nms_keep_sorted.launches == before


@pytest.mark.parametrize("k", [1, 5])
def test_nearest_neighbors_match_jax_and_pallas(k):
    rng = np.random.default_rng(5)
    g = rng.normal(size=(600, 64)).astype(np.float32)
    q = rng.normal(size=(9, 64)).astype(np.float32)
    q[0] = g[17] * 3.0  # exact match up to scale: distance ~0
    want = np.asarray(j_nn(g, q, k))
    pd, pi = j_nn_fused(g, q, k, interpret=True)
    got = knn.nearest_neighbors(t(g), t(q), k).numpy()
    fd, fi = knn.nearest_neighbors_fused(t(g), t(q), k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(fi.numpy(), np.asarray(pi))
    assert got[0, 0] == 17
    # distances: f32 dot products summed in another order
    np.testing.assert_allclose(fd.numpy(), np.asarray(pd), atol=1e-5)


def test_inverse_norms_match_jax_l2_normalize():
    rng = np.random.default_rng(8)
    x = rng.normal(size=(50, 64)).astype(np.float32)
    x[3] = 0.0  # clamped at eps, as in the JAX package
    got = x * knn.inverse_norms(t(x)).numpy()[:, None]
    want = np.asarray(j_l2_normalize(x))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)  # f32 ulps


def test_knn_ties_go_to_lowest_index():
    g = np.zeros((10, 8), np.float32)
    g[:, 0] = 1.0  # ten identical gallery rows
    q = np.ones((2, 8), np.float32)
    d, i = knn.nearest_neighbors_fused(t(g), t(q), 3)
    np.testing.assert_array_equal(i.numpy(), [[0, 1, 2], [0, 1, 2]])
    np.testing.assert_array_equal(np.asarray(j_nn(g, q, 3)), i.numpy())


def test_crop_resize_square_matches_jax():
    rng = np.random.default_rng(6)
    img = rng.uniform(0, 1, (90, 120, 3)).astype(np.float32)
    bx = np.array([[10.7, 5.2, 60.9, 30.1], [0, 0, 120, 90],
                   [100, 70, 119, 89], [30, 10, 34, 80]], np.float32)
    want = np.asarray(j_image.crop_resize_square(img, bx, out_size=64))
    got = image.crop_resize_square(t(img), t(bx), 64).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)  # f32 blend order


def test_tanh_normalization_matches_jax():
    x = np.random.default_rng(7).uniform(-1, 1, (2, 5, 5, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        image.normalize_tanh_imagenet(t(x)).numpy(),
        np.asarray(j_image.normalize_tanh_imagenet(x)), atol=1e-6)
    np.testing.assert_allclose(image.scale_to_tanh(t(x)).numpy(),
                               np.asarray(j_image.scale_to_tanh(x)))


def test_ransac_recovers_homography_despite_outliers():
    """Exact correspondences plus far outliers: any draw that finds the
    inliers refits the same homography, so both packages agree with
    the truth whatever their random streams."""
    rng = np.random.default_rng(8)
    h_true = np.array([[1.05, 0.02, 12.0], [-0.01, 0.97, -7.0],
                       [1e-5, 2e-5, 1.0]], np.float64)
    src = rng.uniform(0, 500, (60, 2))
    hom = np.concatenate([src, np.ones((60, 1))], 1) @ h_true.T
    dst = hom[:, :2] / hom[:, 2:]
    dst[:12] += rng.uniform(200, 400, (12, 2))  # far outliers
    src, dst = src.astype(np.float32), dst.astype(np.float32)
    valid = np.ones(60, bool)
    gen = torch.Generator().manual_seed(0)
    h, inl, ok = ransac.find_homography_ransac(t(src), t(dst), t(valid),
                                               gen)
    jh, jinl, jok = j_ransac(src, dst, valid, jax.random.PRNGKey(0))
    assert bool(ok) and bool(jok)
    want_inl = np.arange(60) >= 12
    np.testing.assert_array_equal(inl.numpy(), want_inl)
    np.testing.assert_array_equal(np.asarray(jinl), want_inl)
    proj = ransac.project_points(h, t(src)).numpy()
    np.testing.assert_allclose(proj[12:], dst[12:], atol=0.05)  # px
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-3,
                               atol=1e-4)
