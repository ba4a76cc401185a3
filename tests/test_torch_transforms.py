"""The port's image transforms against the JAX package's OpenCV-based
host transforms, and its synthetic scene copies against the originals,
on the same seeded numpy inputs."""
import numpy as np
import pytest
import torch

from cvpce_tpu.data import synthetic as j_syn
from cvpce_tpu.data import transforms as j_T
from cvpce_tpu_torch.data import synthetic
from cvpce_tpu_torch.data import transforms as T

# cv2 computes its f32 interpolation weights with its own rounding of
# the source coordinates; on [0, 1] data the two agree to 5e-5, an
# eightieth of an 8-bit level
ATOL = 5e-5


def image(seed, h, w):
    return np.random.default_rng(seed).uniform(0, 1, (h, w, 3)).astype(
        np.float32)


@pytest.mark.parametrize("src,dst", [((60, 80), (120, 160)),
                                     ((60, 80), (30, 40)),
                                     ((97, 61), (256, 256)),
                                     ((256, 384), (85, 133)),
                                     ((50, 70), (50, 70))])
def test_resize_bilinear_matches_cv2(src, dst):
    img = image(0, *src)
    want = j_T.resize_bilinear_np(img, *dst)
    got = T.resize_bilinear(img, *dst).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("hw", [(300, 500), (832, 1344), (100, 90)])
def test_detection_canvas_matches_jax(hw, normalize):
    img = image(1, *hw)
    bx = np.array([[10, 20, 50, 80], [0, 0, 30, 30]], np.float32)
    want, wboxes, wsize, wscale = j_T.detection_canvas(
        img, bx, 256, 384, normalize=normalize)
    got, gboxes, gsize, gscale = T.detection_canvas(
        img, bx, 256, 384, normalize=normalize)
    assert gsize == wsize and gscale == wscale
    np.testing.assert_array_equal(gboxes, wboxes)
    # normalization divides by std >= 0.224, scaling the resize error
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL / 0.224)


@pytest.mark.parametrize("hw", [(40, 25), (25, 40), (300, 120)])
def test_resize_for_classification_matches_jax(hw):
    img = image(2, *hw)
    want = j_T.resize_for_classification(img)
    got = T.resize_for_classification(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_normalize_imagenet_matches_jax():
    img = image(3, 8, 8)
    np.testing.assert_allclose(
        T.normalize_imagenet(torch.from_numpy(img)).numpy(),
        j_T.normalize_imagenet(img), atol=1e-6)


@pytest.mark.parametrize("texture", [False, True])
def test_product_styles_and_gallery_match_jax(texture):
    want = j_syn.product_styles(7, seed=3, texture=texture)
    got = synthetic.product_styles(7, seed=3, texture=texture)
    for w, g in zip(want, got):
        assert w.keys() == g.keys()
        assert w["label"] == g["label"]
        np.testing.assert_array_equal(g["color"], w["color"])
        np.testing.assert_array_equal(
            synthetic.product_gallery_image(g),
            j_syn.product_gallery_image(w))


@pytest.mark.parametrize("violation_rate", [0.0, 0.4])
def test_planogram_scene_matches_jax(violation_rate):
    styles = j_syn.product_styles(6)
    want = j_syn.planogram_scene(192, 320, styles,
                                 np.random.default_rng((5, 1)),
                                 violation_rate=violation_rate)
    got = synthetic.planogram_scene(192, 320, styles,
                                    np.random.default_rng((5, 1)),
                                    violation_rate=violation_rate)
    np.testing.assert_array_equal(got[0], want[0])
    for key in ("boxes", "labels", "violations"):
        np.testing.assert_array_equal(got[1][key], want[1][key])
    np.testing.assert_array_equal(got[2]["boxes"], want[2]["boxes"])
    assert got[2]["labels"] == want[2]["labels"] and got[3] == want[3]
