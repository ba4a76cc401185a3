"""The port's colour correction (pipeline/colorcorrect.py), its cv2-free
Gaussian blur (data/transforms.py:gaussian_blur) and the new synthetic
sets and domain shift (data/synthetic.py) against the JAX package's
numpy/cv2 originals, on the same seeded inputs."""
import cv2
import numpy as np
import pytest

from cvpce_tpu.data import synthetic as j_syn
from cvpce_tpu.pipeline import colorcorrect as j_cc
from cvpce_tpu_torch.data import synthetic as syn
from cvpce_tpu_torch.data import transforms as T
from cvpce_tpu_torch.pipeline import colorcorrect as cc

# cv2 sums the blur's f32 products in another order
BLUR_TOL = 1e-4
# the gallery renders go through the port's bilinear resize, 5e-5 from
# cv2.INTER_LINEAR (tests/test_torch_transforms.py)
RESIZE_TOL = 5e-5


def image(seed, h, w, c=3):
    shape = (h, w, c) if c else (h, w)
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def shifted_scene(seed, strength=0.7):
    img = image(seed, 96, 128)
    return j_syn.apply_domain_shift(img, np.random.default_rng(seed),
                                    strength)


@pytest.mark.parametrize("shape,sigma", [((256, 384), 30.72),
                                         ((32, 400), 3.84),
                                         ((20, 30, 3), 3.2),
                                         ((5, 7, 3), 1.1),
                                         ((1, 9), 2.0),
                                         ((64, 64, 3), 0.25),
                                         ((40, 60), 0.1875)])
def test_gaussian_blur_matches_cv2(shape, sigma):
    """Kernel size, coefficients and BORDER_REFLECT_101, including
    kernels wider than the image (33 taps over 32 rows, 17 over 5) and
    a size exactly between two odd integers (sigma 0.1875)."""
    img = np.random.default_rng(len(shape)).uniform(0, 1, shape).astype(
        np.float32)
    want = cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)
    got = T.gaussian_blur(img, sigma)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=BLUR_TOL)


@pytest.mark.parametrize("seed", range(4))
def test_gray_world_and_correction_match_jax(seed):
    img = shifted_scene(seed) if seed % 2 else image(seed, 64, 96)
    np.testing.assert_allclose(cc.estimate_gray_world_gains(img),
                               j_cc.estimate_gray_world_gains(img),
                               atol=1e-6)
    np.testing.assert_allclose(cc.scene_color_correct(img),
                               j_cc.scene_color_correct(img), atol=1e-6)
    np.testing.assert_array_equal(cc.center_mean_rgb(img),
                                  j_cc.center_mean_rgb(img))


@pytest.mark.parametrize("hw", [(256, 384), (16, 300)])
def test_illumination_field_matches_cv2(hw):
    """256x384: sigma 30.72, 247 taps; 16x300: sigma 2, 17 taps down a
    16-row image."""
    img = shifted_scene(5)
    img = cv2.resize(img, (hw[1], hw[0]))
    np.testing.assert_allclose(cc.estimate_illumination_field(img),
                               j_cc.estimate_illumination_field(img),
                               atol=BLUR_TOL)
    np.testing.assert_allclose(
        cc.scene_color_correct(img, flatten_illumination=True),
        j_cc.scene_color_correct(img, flatten_illumination=True),
        atol=BLUR_TOL)


def test_gallery_feedback_gains_match_jax():
    rng = np.random.default_rng(4)
    gal = rng.uniform(0.2, 0.9, (64, 3)).astype(np.float32)
    crops = np.clip(gal * [0.8, 1.05, 1.4], 0, 1).astype(np.float32)
    crops[:20] = rng.uniform(0.2, 0.9, (20, 3))
    np.testing.assert_array_equal(cc.gallery_feedback_gains(crops, gal),
                                  j_cc.gallery_feedback_gains(crops, gal))


@pytest.mark.parametrize("seed,strength", [(0, 0.05), (1, 0.06),
                                           (2, 0.5), (3, 0.7), (4, 1.0)])
def test_apply_domain_shift_matches_jax(seed, strength):
    """Bit-equal where no blur is drawn (sigma <= 0.2 at strength <=
    1/16), within the blur's tolerance where one is."""
    img = image(seed, 72, 100)
    got = syn.apply_domain_shift(img, np.random.default_rng(seed), strength)
    want = j_syn.apply_domain_shift(img, np.random.default_rng(seed),
                                    strength)
    if strength <= 1 / 16:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=BLUR_TOL)
    assert syn.apply_domain_shift(img, None, 0.0) is img


def assert_items_equal(got, want, atol):
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key == "image" and atol:
            np.testing.assert_allclose(got[key], value, atol=atol)
        elif isinstance(value, np.ndarray):
            np.testing.assert_array_equal(got[key], value)
        else:
            assert got[key] == value, key


@pytest.mark.parametrize("shift", [0.0, 0.6])
def test_detection_sets_match_jax(shift):
    for i in range(3):
        assert_items_equal(
            syn.SyntheticShelfDataset(3, 128, 192, seed=1,
                                      domain_shift=shift)[i],
            j_syn.SyntheticShelfDataset(3, 128, 192, seed=1,
                                        domain_shift=shift)[i],
            BLUR_TOL if shift else 0)
        assert_items_equal(
            syn.PlanogramSceneDetectionSet(3, 160, 224, seed=2,
                                           domain_shift=shift)[i],
            j_syn.PlanogramSceneDetectionSet(3, 160, 224, seed=2,
                                             domain_shift=shift)[i],
            BLUR_TOL if shift else 0)
    img, boxes = syn.shelf_scene(96, 144, np.random.default_rng(3))
    j_img, j_boxes = j_syn.shelf_scene(96, 144, np.random.default_rng(3))
    np.testing.assert_array_equal(img, j_img)
    np.testing.assert_array_equal(boxes, j_boxes)


@pytest.mark.parametrize("shift", [0.0, 0.5])
def test_query_set_and_shifted_scene_match_jax(shift):
    styles, j_styles = syn.product_styles(8), j_syn.product_styles(8)
    for i in range(2):
        got = syn.PlanogramQuerySet(styles, 2, 160, 256,
                                    domain_shift=shift)[i]
        want = j_syn.PlanogramQuerySet(j_styles, 2, 160, 256,
                                       domain_shift=shift)[i]
        assert got[1] == want[1]
        np.testing.assert_array_equal(got[2], want[2])
        if shift:
            np.testing.assert_allclose(got[0], want[0], atol=BLUR_TOL)
        else:
            np.testing.assert_array_equal(got[0], want[0])


def test_archetype_gallery_set_matches_jax():
    styles, j_styles = syn.product_styles(6), j_syn.product_styles(6)
    got = syn.ArchetypeGallerySet(styles, views=3, seed=9)
    want = j_syn.ArchetypeGallerySet(j_styles, views=3, seed=9)
    assert len(got) == len(want) == 18
    assert got.hierarchies == want.hierarchies
    for i in range(len(want)):
        g, w = got[i], want[i]
        for a, b in zip(g[:2], w[:2]):
            np.testing.assert_allclose(a, b, atol=2 * RESIZE_TOL)
        assert g[2:] == w[2:]


def test_perspective_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        syn.PlanogramSceneDetectionSet(2, 64, 96, perspective=0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        syn.PlanogramQuerySet(syn.product_styles(4), perspective=0.5)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        syn.SyntheticShelfDataset(2, 64, 96, perspective=0.1)
