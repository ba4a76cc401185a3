"""The port's image transforms against the JAX package's OpenCV-based
host transforms, and its synthetic scene copies against the originals,
on the same seeded numpy inputs; the Sobel gradient and the flood fill
of the white-background mask against cv2's, bit for bit."""
import cv2
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


# ---- the transforms of the dataset readers: resize-pad, flip, mask

@pytest.mark.parametrize("tanh", [True, False])
@pytest.mark.parametrize("hw", [(97, 61), (61, 97), (80, 80), (512, 384)])
def test_aspect_resize_pad_matches_jax(hw, tanh):
    """(512, 384) -> (256, 192) is an exact 2x downscale, which cv2
    takes by INTER_AREA: the same 2x2 means up to f32 rounding."""
    img = image(4, *hw)
    mask = np.random.default_rng(5).uniform(0, 1, hw) < 0.3
    want, wmask = j_T.aspect_resize_pad(img, tanh=tanh, mask=mask)
    got, gmask = T.aspect_resize_pad(img, tanh=tanh, mask=mask)
    scale = 2.0 if tanh else 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=scale * ATOL)
    np.testing.assert_allclose(gmask.numpy(), wmask, atol=ATOL)
    np.testing.assert_allclose(
        T.aspect_resize_pad(torch.from_numpy(img), size=64, tanh=tanh)
        .numpy(), j_T.aspect_resize_pad(img, size=64, tanh=tanh),
        atol=scale * ATOL)


def test_hflip_with_boxes_matches_jax():
    img = image(6, 20, 31)
    boxes = np.array([[1, 2, 10, 12], [20, 0, 31, 20]], np.float32)
    for b in (boxes, np.zeros((0, 4), np.float32)):
        got = T.hflip_with_boxes(img, b)
        want = j_T.hflip_with_boxes(img, b)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_sobel3_is_cv2_sobel():
    """Bit for bit (measured bound 0) at every width 1-41: cv2 sums the
    SIMD body and the scalar tail of a row in two orders."""
    rng = np.random.default_rng(7)
    for w in range(1, 42):
        for h in (1, 2, 5, 30):
            g = rng.uniform(0, 1, (h, w)).astype(np.float32)
            for dx in (1, 0):
                np.testing.assert_array_equal(
                    T.sobel3(g, dx),
                    cv2.Sobel(g, cv2.CV_32F, dx, 1 - dx, ksize=3))


def _flood_cases():
    rng = np.random.default_rng(8)
    t = np.float32(1e-2)
    for h, w in [(9, 13), (20, 31)]:
        yield np.cumsum(np.full((h, w), t, np.float32), axis=1)
        yield np.cumsum(np.full((h, w), t, np.float32), axis=0) + 0.3
        ramp = (np.arange(w) * 0.01).astype(np.float32)[None].repeat(h, 0)
        yield ramp + np.float32(0.5)
        yield np.nextafter(ramp, np.float32(1))
        yield (rng.integers(0, 4, (h, w)) * 0.005).astype(np.float32)
        yield rng.uniform(0, 0.03, (h, w)).astype(np.float32)
        walls = np.zeros((h, w), np.float32)
        walls[:, w // 2] = 0.5
        walls[h // 2] = 0.02
        yield walls
        snake = np.ones((h, w), np.float32)  # a zig-zag corridor of 0
        snake[::2] = 0
        snake[1::4, -1] = 0
        snake[3::4, 0] = 0
        yield snake


def test_flood_fill_matches_cv2():
    """Plateaus, walls, a one-pixel corridor and ramps whose steps lie
    at the tolerance and one ulp past it, from the corners and the
    centre: the filled masks are equal."""
    for img in _flood_cases():
        h, w = img.shape
        for x, y in ((0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1),
                     (w // 2, h // 2)):
            ff = np.zeros((h + 2, w + 2), np.uint8)
            cv2.floodFill(img.copy(), ff, (x, y), 0, loDiff=1e-2,
                          upDiff=1e-2,
                          flags=4 | cv2.FLOODFILL_MASK_ONLY | (1 << 8))
            np.testing.assert_array_equal(
                T.flood_fill_mask(img, x, y, 1e-2),
                ff[1:-1, 1:-1].astype(bool))


def _product_photos():
    """Seeded product renders on a white ground with faint noise, and
    the cases the corner rule decides: a dark corner, all white, no
    white corner, a grey ramp of tolerance-sized steps."""
    rng = np.random.default_rng(9)
    for s in j_syn.product_styles(6, seed=2):
        for hw in [(40, 30), (97, 61)]:
            prod = j_T.resize_bilinear_np(j_syn.product_gallery_image(s),
                                          *hw)
            img = np.ones((hw[0] + 20, hw[1] + 16, 3), np.float32)
            img[10:10 + hw[0], 8:8 + hw[1]] = prod
            yield np.clip(img + rng.normal(0, 2e-3, img.shape), 0, 1
                          ).astype(np.float32)
    img = np.ones((30, 40, 3), np.float32)
    img[10:20, 10:30] = 0.3
    dark = img.copy()
    dark[:5, :5] = 0.5
    yield dark
    yield np.ones((12, 9, 3), np.float32)
    yield np.full((12, 9, 3), 0.5, np.float32)
    ramp = np.ones((16, 60, 3), np.float32)
    ramp[:, 20:] -= (np.arange(40, dtype=np.float32) * 0.08)[None, :, None]
    yield ramp


def test_white_background_mask_matches_jax():
    for img in _product_photos():
        np.testing.assert_array_equal(T.build_white_background_mask(img),
                                      j_T.build_white_background_mask(img))
