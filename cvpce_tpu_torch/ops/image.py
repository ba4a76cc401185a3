"""Crop + square-pad + resize and normalization (torch); counterpart of
cvpce_tpu/ops/image.py in its f32 gather form (`crop_resize_square`).

Images are HWC float32 in [0, 1] unless noted.
"""
from __future__ import annotations

import torch

CLASSIFICATION_IMAGE_SIZE = 256
PAD_VALUE = 0.5

TANH_IMAGENET_MEAN = (0.485 * 2 - 1, 0.456 * 2 - 1, 0.406 * 2 - 1)
TANH_IMAGENET_STD = (0.229 * 2, 0.224 * 2, 0.225 * 2)


def scale_to_tanh(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1]."""
    return x * 2.0 - 1.0


def normalize_tanh_imagenet(x: torch.Tensor) -> torch.Tensor:
    """Normalize a [-1, 1]-scaled channels-last image with ImageNet
    statistics rescaled to that range."""
    mean = torch.tensor(TANH_IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(TANH_IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _bilinear_gather(image: torch.Tensor, sx: torch.Tensor,
                     sy: torch.Tensor) -> torch.Tensor:
    """Sample HWC `image` at (B, S) column coords sx and (B, S) row
    coords sy -> (B, S, S, C), clamped to the image (edge padding)."""
    h, w, c = image.shape
    sx = sx.clamp(0.0, w - 1.0)
    sy = sy.clamp(0.0, h - 1.0)
    x0 = torch.floor(sx).long()
    y0 = torch.floor(sy).long()
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    lx = (sx - x0)[:, None, :, None]
    ly = (sy - y0)[:, :, None, None]
    flat = image.reshape(h * w, c)

    def at(yi, xi):
        idx = (yi[:, :, None] * w + xi[:, None, :]).reshape(-1)
        return flat[idx].reshape(yi.shape[0], yi.shape[1], xi.shape[1], c)

    return ((1 - ly) * (1 - lx) * at(y0, x0) + (1 - ly) * lx * at(y0, x1)
            + ly * (1 - lx) * at(y1, x0) + ly * lx * at(y1, x1))


def crop_resize_square(image: torch.Tensor, boxes: torch.Tensor,
                       out_size: int = CLASSIFICATION_IMAGE_SIZE
                       ) -> torch.Tensor:
    """Crop -> pad to square (right/bottom, PAD_VALUE gray) -> bilinear
    resize (align_corners=False) for many boxes at once.

    image (H, W, C); boxes (B, 4) xyxy, truncated to integers first.
    Returns (B, out_size, out_size, C) on the image's device.
    """
    b = boxes.to(torch.int32).to(torch.float32)
    x1, y1 = b[:, 0], b[:, 1]
    cw = b[:, 2] - x1
    ch = b[:, 3] - y1
    side = torch.maximum(cw, ch)
    p = torch.arange(out_size, dtype=torch.float32, device=image.device)
    scale = side / out_size
    src = (p[None, :] + 0.5) * scale[:, None] - 0.5  # (B, S)
    vals = _bilinear_gather(image, x1[:, None] + src, y1[:, None] + src)
    inside_x = (src < cw[:, None]) & (src >= -0.5)
    inside_y = (src < ch[:, None]) & (src >= -0.5)
    inside = inside_y[:, :, None] & inside_x[:, None, :]
    return torch.where(inside[..., None], vals,
                       torch.full_like(vals, PAD_VALUE))
