"""The port's cv2-free perspective warp against cv2 (the tests may import
it; the port may not), and the data sets that use it against the JAX
package's at a small canvas: `perspective_scene`,
`SyntheticShelfDataset(perspective=)`, `PlanogramSceneDetectionSet(
perspective=)`, `PlanogramQuerySet(perspective=)`, `SceneCropSet`,
`AugmentedGallerySet` and `InterleavedDataset`."""
import cv2
import numpy as np
import pytest

from cvpce_tpu.data import synthetic as j_syn
from cvpce_tpu_torch.data import synthetic as syn
from cvpce_tpu_torch.data import transforms as T

H, W = 128, 192
# [0, 1] images. The warp follows cv2's f32 arithmetic step by step and
# was measured equal to it, bit for bit, at both sizes and every strength
# here; the bound leaves room for a cv2 built for another SIMD width
WARP_TOL = 1e-6
# the sets' images: the defocus blur of apply_domain_shift (f32 sums in
# another order, PR 10) and the port's bilinear crop resize, both within
# 1e-4 of cv2 (ROADMAP Queue 3); measured at most 6.0e-7 here
IMAGE_TOL = 1e-4


def corners(h, w, rng, strength):
    d = 0.04 * strength
    src = np.asarray([[0, 0], [w, 0], [w, h], [0, h]], np.float32)
    dst = np.ascontiguousarray(src + rng.uniform(-d, d, (4, 2)) * [w, h],
                               np.float32)
    return src, dst


@pytest.mark.parametrize("h,w", [(64, 96), (832, 1344)])
@pytest.mark.parametrize("strength", [0.5, 3.0])
def test_warp_perspective_matches_cv2(h, w, strength):
    rng = np.random.default_rng(h + int(10 * strength))
    src, dst = corners(h, w, rng, strength)
    m = T.get_perspective_transform(src, dst)
    np.testing.assert_array_equal(m, cv2.getPerspectiveTransform(src, dst))
    img = rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
    want = cv2.warpPerspective(img, m, (w, h), flags=cv2.INTER_LINEAR,
                               borderMode=cv2.BORDER_REPLICATE)
    got = T.warp_perspective(img, m, w, h)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got - want).max() <= WARP_TOL
    # one channel, and a rendered scene with sharp product edges
    gray = T.warp_perspective(img[..., 1], m, w, h)
    assert np.abs(gray - want[..., 1]).max() <= WARP_TOL


def test_get_perspective_transform_matches_cv2_bit_for_bit():
    """cv2's 8x8 elimination in f64 (f32 products of the corners), over
    200 seeded corner sets of perspective_scene's kind."""
    for seed in range(200):
        rng = np.random.default_rng(seed)
        h, w = [(64, 96), (832, 1344), (128, 192), (37, 53)][seed % 4]
        src, dst = corners(h, w, rng, 1.0)
        np.testing.assert_array_equal(T.get_perspective_transform(src, dst),
                                      cv2.getPerspectiveTransform(src, dst))


@pytest.mark.parametrize("strength", [0.5, 1.0])
def test_perspective_scene_matches_jax(strength):
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    boxes = np.array([[10, 10, 50, 60], [0, 0, 20, 20],
                      [150, 100, 191, 127]], np.float32)
    got = syn.perspective_scene(img, boxes, np.random.default_rng(3),
                                strength)
    want = j_syn.perspective_scene(img, boxes, np.random.default_rng(3),
                                   strength)
    for g, w_ in zip(got, want):
        assert g.dtype == w_.dtype == np.float32
    assert np.abs(got[0] - want[0]).max() <= WARP_TOL
    np.testing.assert_array_equal(got[1], want[1])  # boxes
    np.testing.assert_array_equal(got[2], want[2])  # H


def test_detection_sets_with_perspective_match_jax():
    for cls, args in (("SyntheticShelfDataset",
                       dict(n=2, perspective=0.6, domain_shift=0.3)),
                      ("PlanogramSceneDetectionSet",
                       dict(n=2, perspective=0.5))):
        got = getattr(syn, cls)(canvas_h=H, canvas_w=W, **args)
        want = getattr(j_syn, cls)(canvas_h=H, canvas_w=W, **args)
        for i in range(2):
            g, w_ = got[i], want[i]
            assert g["name"] == w_["name"]
            np.testing.assert_array_equal(g["boxes"], w_["boxes"])
            assert np.abs(g["image"] - w_["image"]).max() <= IMAGE_TOL


def test_query_and_crop_sets_with_perspective_match_jax():
    styles, j_styles = syn.product_styles(6), j_syn.product_styles(6)
    got = syn.PlanogramQuerySet(styles, n=2, canvas_h=H, canvas_w=W,
                                perspective=0.5, domain_shift=0.4)
    want = j_syn.PlanogramQuerySet(j_styles, n=2, canvas_h=H, canvas_w=W,
                                   perspective=0.5, domain_shift=0.4)
    for i in range(2):
        (gi, gl, gb), (wi, wl, wb) = got[i], want[i]
        assert gl == wl
        np.testing.assert_array_equal(gb, wb)
        assert np.abs(gi - wi).max() <= IMAGE_TOL
    got = syn.SceneCropSet(styles, n=12, canvas_h=H, canvas_w=W,
                           perspective=0.5)
    want = j_syn.SceneCropSet(j_styles, n=12, canvas_h=H, canvas_w=W,
                              perspective=0.5)
    assert len(got) == len(want) == 12
    for i in range(12):
        assert got[i].shape == want[i].shape == (256, 256, 3)
        assert np.abs(got[i] - want[i]).max() <= IMAGE_TOL


def test_augmented_gallery_and_interleaved_sets_match_jax():
    styles, j_styles = syn.product_styles(4), j_syn.product_styles(4)
    got = syn.AugmentedGallerySet(
        syn.ArchetypeGallerySet(styles, views=2, size=64), factor=3)
    want = j_syn.AugmentedGallerySet(
        j_syn.ArchetypeGallerySet(j_styles, views=2, size=64), factor=3)
    assert len(got) == len(want) == 24
    for i in range(len(want)):
        assert got[i][2:] == want[i][2:]
        assert np.abs(got[i][0] - want[i][0]).max() <= 2 * IMAGE_TOL
    mixed = syn.InterleavedDataset(syn.SyntheticShelfDataset(2, H, W),
                                   syn.PlanogramSceneDetectionSet(3, H, W))
    j_mixed = j_syn.InterleavedDataset(
        j_syn.SyntheticShelfDataset(2, H, W),
        j_syn.PlanogramSceneDetectionSet(3, H, W))
    assert len(mixed) == len(j_mixed) == 4
    for i in range(4):
        assert mixed[i]["name"] == j_mixed[i]["name"]
        np.testing.assert_array_equal(mixed[i]["image"], j_mixed[i]["image"])
    with pytest.raises(IndexError):
        mixed[4]
