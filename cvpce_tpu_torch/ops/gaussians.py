"""Gaussian heatmap target rendering on the device; counterpart of
cvpce_tpu/ops/gaussians.py.

Every box is evaluated against the whole output grid under its window
mask [max(x1, 0), min(x2, W)) x [max(y1, 0), min(y2, H)), box
coordinates floor-divided by `size_reduction`; the background is -1
for tanh targets, 0 otherwise. Three generators (`mvn`, the fixed-kernel
`kant`, `simple`) and three joins (`max`, `add`, `replace`).

Boxes are folded in `_BOX_CHUNK` at a time, with the batch of images as
one more axis. `max` is exact in any order. `add` follows the JAX
package's order: one box at a time below 2 * `_BOX_CHUNK` boxes, else a
sum within each 32-box chunk added to the canvas chunk by chunk.
`replace` keeps, at each pixel, the last valid box that covers it, which
is what the JAX package's box-by-box scan leaves there.
"""
from __future__ import annotations

import math

import torch

KANT_SIZE = 120
KANT_SIGMA = 40.0
_BOX_CHUNK = 32


def _kant_kernel(device, size: int = KANT_SIZE,
                 sigma: float = KANT_SIGMA) -> torch.Tensor:
    """The fixed 120 x 120 kernel of the Kant method:
    exp(-4 ln 2 * ((x - c)^2 + (y - c)^2) / sigma^2)."""
    c = size // 2
    xx = (torch.arange(size, dtype=torch.float32, device=device) - c) ** 2
    grid = xx[:, None] + xx[None, :]
    return torch.exp(-4.0 * math.log(2.0) * grid / sigma ** 2)


def _bilinear_resize_sample(kernel: torch.Tensor, u: torch.Tensor,
                            v: torch.Tensor, out_w: torch.Tensor,
                            out_h: torch.Tensor) -> torch.Tensor:
    """`kernel` (K, K) as if bilinearly resized (align_corners=False) to
    (out_w, out_h), sampled at integer output coords (u, v); indexed
    kernel[u, v] as the JAX function indexes it."""
    k = kernel.shape[0]
    su = torch.clamp((u + 0.5) * (k / torch.clamp(out_w, min=1.0)) - 0.5,
                     min=0.0)
    sv = torch.clamp((v + 0.5) * (k / torch.clamp(out_h, min=1.0)) - 0.5,
                     min=0.0)
    u0 = torch.floor(su).long().clamp(0, k - 1)
    v0 = torch.floor(sv).long().clamp(0, k - 1)
    u1 = (u0 + 1).clamp(max=k - 1)
    v1 = (v0 + 1).clamp(max=k - 1)
    lu = su - u0
    lv = sv - v0
    k00 = kernel[u0, v0]
    k01 = kernel[u0, v1]
    k10 = kernel[u1, v0]
    k11 = kernel[u1, v1]
    return ((1 - lu) * (1 - lv) * k00 + (1 - lu) * lv * k01
            + lu * (1 - lv) * k10 + lu * lv * k11)


def _render(boxes: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
            h: int, w: int, method: str, tanh: bool, peak: float,
            kernel) -> tuple:
    """(probs, mask), each (..., h, w), of boxes (..., 4)."""
    def col(i):
        return boxes[..., i][..., None, None]

    x1, y1, x2, y2 = col(0), col(1), col(2), col(3)
    cx = (x1 + x2) * 0.5
    cy = (y1 + y2) * 0.5
    bw = (x2 - x1).abs()
    bh = (y2 - y1).abs()
    x_lo = torch.clamp(x1, min=0.0)
    x_hi = torch.clamp(x2, max=float(w))
    y_lo = torch.clamp(y1, min=0.0)
    y_hi = torch.clamp(y2, max=float(h))
    mask = (xs >= x_lo) & (xs < x_hi) & (ys >= y_lo) & (ys < y_hi)

    if method == "mvn":
        var_w = torch.clamp((bw / 2.0) ** 2, min=1e-12)
        var_h = torch.clamp((bh / 2.0) ** 2, min=1e-12)
        logp = -0.5 * ((ys - cy) ** 2 / var_h + (xs - cx) ** 2 / var_w)
        # normalised by the window's max, taken on logp for stability
        max_logp = torch.where(mask, logp, torch.full_like(logp, -math.inf)
                               ).amax(dim=(-2, -1), keepdim=True)
        max_logp = torch.where(torch.isfinite(max_logp), max_logp,
                               torch.zeros_like(max_logp))
        probs = torch.exp(logp - max_logp) * peak
    elif method == "kant":
        probs = _bilinear_resize_sample(kernel, xs - x_lo, ys - y_lo,
                                        x_hi - x_lo, y_hi - y_lo)
    elif method == "simple":
        lo, hi = (-1.0, 1.0) if tanh else (0.0, 1.0)
        sig_w = torch.clamp(bw / 6.0, min=1e-12)
        sig_h = torch.clamp(bh / 6.0, min=1e-12)
        e = ((xs - cx) ** 2 / (2 * sig_w ** 2)
             + (ys - cy) ** 2 / (2 * sig_h ** 2))
        probs = (hi - lo) * torch.exp(-e) + lo
    else:
        raise ValueError(f"unknown method {method!r}")
    return probs, mask


def render_gaussians_batch(boxes: torch.Tensor, valid: torch.Tensor, *,
                           height: int, width: int, method: str = "mvn",
                           join: str = "max", tanh: bool = False,
                           size_reduction: int = 1,
                           peak: float = 1.0) -> torch.Tensor:
    """Boxes (N, B, 4) xyxy at the original resolution, valid (N, B) ->
    (N, height // r, width // r) heatmaps, r = `size_reduction`."""
    if join not in ("max", "add", "replace"):
        raise ValueError(f"unknown join {join!r}")
    dev = boxes.device
    h, w = height // size_reduction, width // size_reduction
    n, nb = valid.shape
    canvas = torch.full((n, h, w), -1.0 if tanh else 0.0,
                        dtype=torch.float32, device=dev)
    b = torch.floor(torch.div(boxes.float(), float(size_reduction),
                              rounding_mode="floor"))
    valid = valid.bool()
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    kernel = _kant_kernel(dev) if method == "kant" else None
    # one box at a time where the JAX package scans box by box: the add
    # join's order; max and replace come out the same either way
    step = _BOX_CHUNK if nb >= 2 * _BOX_CHUNK or join != "add" else 1
    for start in range(0, nb, step):
        probs, masks = _render(b[:, start:start + step], ys, xs, h, w,
                               method, tanh, peak, kernel)
        masks = masks & valid[:, start:start + step, None, None]
        if join == "max":
            contrib = torch.where(masks, probs,
                                  torch.full_like(probs, -math.inf)
                                  ).amax(dim=1)
            canvas = torch.where(torch.isfinite(contrib),
                                 torch.maximum(canvas, contrib), canvas)
        elif join == "add":
            canvas = canvas + torch.where(masks, probs,
                                          torch.zeros_like(probs)).sum(1)
        else:
            # the last covering box of the chunk, then over earlier ones
            cover = masks.any(dim=1)
            order = torch.arange(1, masks.shape[1] + 1, device=dev)
            last = (masks * order[None, :, None, None]).argmax(dim=1)
            picked = torch.gather(probs, 1, last[:, None]).squeeze(1)
            canvas = torch.where(cover, picked, canvas)
    return canvas


def render_gaussians(boxes: torch.Tensor, valid: torch.Tensor,
                     **kwargs) -> torch.Tensor:
    """Boxes (B, 4), valid (B,) -> one (height // r, width // r)
    heatmap; keywords as render_gaussians_batch."""
    return render_gaussians_batch(boxes[None], valid[None], **kwargs)[0]
