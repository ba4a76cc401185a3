"""Image transforms (torch); counterpart of cvpce_tpu/data/transforms.py.

Bilinear resizing follows OpenCV's INTER_LINEAR (half-pixel centres,
edge clamping, no antialiasing), which `F.interpolate(mode="bilinear",
align_corners=False)` computes. Images are HWC float32 in [0, 1], numpy
arrays or tensors; results are tensors on `device` (the input's device
by default). `gaussian_blur` is host numpy, like the cv2 calls it
replaces.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

CLASSIFICATION_IMAGE_SIZE = 256
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def as_tensor(img, device=None) -> torch.Tensor:
    """HWC image (numpy or tensor) -> f32 tensor on `device` (default:
    where it already is)."""
    if isinstance(img, np.ndarray):
        img = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    return img.to(device if device is not None else img.device,
                  torch.float32)


def resize_bilinear(img, out_h: int, out_w: int, device=None
                    ) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C), cv2.INTER_LINEAR semantics."""
    x = as_tensor(img, device).permute(2, 0, 1)[None]
    y = F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                      align_corners=False, antialias=False)
    return y[0].permute(1, 2, 0).contiguous()


def scale_to_tanh(img):
    return img * 2.0 - 1.0


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


def detection_canvas(img, boxes: Optional[np.ndarray], canvas_h: int,
                     canvas_w: int, min_size: int = 800,
                     max_size: int = 1333, normalize: bool = True,
                     device=None
                     ) -> Tuple[torch.Tensor, np.ndarray, Tuple[int, int],
                                float]:
    """Aspect-preserving resize into a fixed canvas (shorter side ->
    min_size, longer capped at max_size and by the canvas).

    Returns (canvas (canvas_h, canvas_w, C) tensor, scaled boxes (numpy),
    content (h, w), scale)."""
    h, w = img.shape[:2]
    scale = min(min_size / min(h, w), max_size / max(h, w))
    scale = min(scale, canvas_h / h, canvas_w / w)
    new_h = min(int(round(h * scale)), canvas_h)
    new_w = min(int(round(w * scale)), canvas_w)
    resized = resize_bilinear(img, new_h, new_w, device)
    if normalize:
        resized = normalize_imagenet(resized)
    canvas = torch.zeros((canvas_h, canvas_w, resized.shape[2]),
                         dtype=torch.float32, device=resized.device)
    canvas[:new_h, :new_w] = resized
    if boxes is not None and len(boxes):
        sboxes = np.asarray(boxes, np.float32).copy()
        sboxes[:, [0, 2]] *= new_w / w
        sboxes[:, [1, 3]] *= new_h / h
    else:
        sboxes = np.zeros((0, 4), np.float32)
    return canvas, sboxes, (new_h, new_w), scale


def resize_for_classification(img, size: int = CLASSIFICATION_IMAGE_SIZE,
                              pad_value: float = 0.5, device=None
                              ) -> torch.Tensor:
    """Square-pad (bottom/right) with gray, then resize to `size`."""
    x = as_tensor(img, device)
    h, w = x.shape[:2]
    side = max(h, w)
    canvas = torch.full((side, side, x.shape[2]), pad_value,
                        dtype=torch.float32, device=x.device)
    canvas[:h, :w] = x
    return resize_bilinear(canvas, size, size)


def _reflect101(idx: np.ndarray, n: int) -> np.ndarray:
    """cv2.BORDER_REFLECT_101 source index of each (possibly far
    out-of-range) position along an axis of length n: reflection about
    the edge pixels, repeated for borders wider than the axis."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def gaussian_kernel(sigma: float) -> np.ndarray:
    """cv2's automatic Gaussian kernel for f32 images: size
    cvRound(sigma * 8 + 1) | 1 (round half to even), coefficients
    exp(-x^2 / (2 sigma^2)) taken in f64, normalised to sum 1, then
    rounded to f32."""
    n = int(np.rint(sigma * 8 + 1)) | 1
    x = np.arange(n, dtype=np.float64) - (n - 1) * 0.5
    k = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (k * (1.0 / k.sum())).astype(np.float32)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """`cv2.GaussianBlur(img, (0, 0), sigmaX=sigma, sigmaY=sigma)` for an
    f32 (H, W) or (H, W, C) array: the separable kernel of
    `gaussian_kernel`, rows first, then columns, BORDER_REFLECT_101 at
    the edges (also where the kernel is wider than the image). f32
    sums in another order than cv2's, so results agree to f32
    rounding."""
    img = np.asarray(img, np.float32)
    k = gaussian_kernel(sigma)
    r = len(k) // 2
    out = img
    for axis in (1, 0):
        n = out.shape[axis]
        src = np.take(out, _reflect101(np.arange(-r, n + r), n), axis=axis)
        acc = np.zeros_like(out)
        for j, w in enumerate(k):
            acc += w * np.take(src, np.arange(j, j + n), axis=axis)
        out = acc
    return out
