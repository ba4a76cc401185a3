"""Scene-statistics photometric correction for the serving classify leg
(host numpy); counterpart of cvpce_tpu/pipeline/colorcorrect.py.

A shelf photo's white-balance cast and lighting are scene-level: every
crop shares them and the whole scene carries enough statistics to
estimate them. Gray-world gains (per-channel g_c = mean(luma) /
mean(c)) undo the cast; the optional illumination field (luma over its
heavily blurred copy, single-scale Retinex) flattens smooth lighting
gradients, and is off by default because products imprint themselves
on it. Only the classification crops see the corrected scene; the
detector's input stays raw.
"""
from __future__ import annotations

import numpy as np

from ..data.transforms import gaussian_blur

_LUMA = np.asarray([0.299, 0.587, 0.114], np.float32)


def estimate_gray_world_gains(img: np.ndarray) -> np.ndarray:
    """(3,) f32 gains that equalise the channel means of an HWC [0, 1]
    image to its luma mean, clipped to [0.5, 2.0]."""
    means = img.reshape(-1, 3).mean(axis=0)
    target = float(means @ _LUMA / _LUMA.sum())
    gains = target / np.clip(means, 1e-4, None)
    return np.clip(gains, 0.5, 2.0).astype(np.float32)


def estimate_illumination_field(img: np.ndarray,
                                sigma_frac: float = 0.12) -> np.ndarray:
    """Smooth multiplicative lighting field, unit mean, (H, W, 1): luma
    blurred with sigma = sigma_frac * min(H, W) (at least 2), clipped to
    [0.5, 2.0]."""
    luma = img.astype(np.float32) @ _LUMA
    sigma = max(2.0, sigma_frac * min(img.shape[:2]))
    field = gaussian_blur(luma, sigma)
    field = field / max(float(field.mean()), 1e-4)
    return np.clip(field, 0.5, 2.0)[..., None].astype(np.float32)


def gallery_feedback_gains(crop_means: np.ndarray,
                           matched_gallery_means: np.ndarray) -> np.ndarray:
    """Scene cast as the median per-channel ratio between each crop's
    mean colour and its matched gallery entry's, (N, 3) each; robust to
    misclassified crops while most match. (3,) gains in [0.5, 2.0]."""
    ratios = matched_gallery_means / np.clip(crop_means, 1e-3, None)
    gains = np.median(ratios, axis=0)
    return np.clip(gains, 0.5, 2.0).astype(np.float32)


def center_mean_rgb(img01: np.ndarray) -> np.ndarray:
    """Mean RGB of the central half-crop (border/neighbor-free)."""
    h, w = img01.shape[:2]
    return img01[h // 4: 3 * h // 4, w // 4: 3 * w // 4].reshape(
        -1, 3).mean(axis=0)


def scene_color_correct(img: np.ndarray,
                        flatten_illumination: bool = False) -> np.ndarray:
    """A corrected copy (HWC f32 [0, 1]) of a shelf photo; near-neutral,
    evenly lit scenes pass almost unchanged."""
    out = img.astype(np.float32)
    if flatten_illumination:
        out = out / estimate_illumination_field(out)
    out = out * estimate_gray_world_gains(out)
    return np.clip(out, 0.0, 1.0)
