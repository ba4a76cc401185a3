"""Batched RANSAC homography (torch); counterpart of
cvpce_tpu/ops/ransac.py.

All S four-point hypotheses are solved at once (batched 8x9 DLT through
`torch.linalg.svd` on Hartley-normalized points), scored together, and
the winner is refit by weighted least squares on its inliers. Samples
are drawn from an explicit `torch.Generator`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def _hartley_normalize(pts: torch.Tensor, valid: torch.Tensor):
    w = valid.to(pts.dtype)
    n = w.sum().clamp(min=1.0)
    mean = (pts * w[:, None]).sum(0) / n
    centered = pts - mean
    dist = torch.sqrt((centered ** 2).sum(-1) + 1e-12)
    mean_dist = (dist * w).sum() / n
    scale = math.sqrt(2.0) / mean_dist.clamp(min=1e-8)
    t = torch.zeros((3, 3), dtype=pts.dtype, device=pts.device)
    t[0, 0] = scale
    t[1, 1] = scale
    t[0, 2] = -scale * mean[0]
    t[1, 2] = -scale * mean[1]
    t[2, 2] = 1.0
    return centered * scale, t


def _dlt_rows(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """(..., K, 2) x2 -> (..., 2K, 9) DLT constraint rows."""
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], -1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1)
    return torch.cat([r1, r2], -2)


def _solve_dlt(src, dst, weights: Optional[torch.Tensor] = None):
    a = _dlt_rows(src, dst)
    if weights is not None:
        a = a * torch.cat([weights, weights], -1)[..., None]
    _, _, vh = torch.linalg.svd(a, full_matrices=True)
    return vh[..., -1, :].reshape(*a.shape[:-2], 3, 3)


def project_points(h: torch.Tensor, pts: torch.Tensor,
                   eps: float = 1e-12) -> torch.Tensor:
    """Apply homographies h (..., 3, 3) to points (..., N, 2)."""
    ones = torch.ones(pts.shape[:-1] + (1,), dtype=pts.dtype,
                      device=pts.device)
    q = torch.cat([pts, ones], -1) @ h.transpose(-1, -2)
    z = q[..., 2:3]
    small = z.abs() < eps
    z = torch.where(small, torch.where(z < 0, -eps, eps).to(z.dtype), z)
    return q[..., :2] / z


def project_boxes(h: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Project xyxy boxes corner-wise through h."""
    return torch.cat([project_points(h, boxes[..., 0:2]),
                      project_points(h, boxes[..., 2:4])], -1)


def find_homography_ransac(src: torch.Tensor, dst: torch.Tensor,
                           valid: torch.Tensor, generator: torch.Generator,
                           reproj_threshold: float = 10.0,
                           num_samples: int = 512):
    """RANSAC homography src -> dst over (N, 2) points, valid (N,) bool.

    Returns (h (3, 3), inliers (N,) bool, ok bool tensor): ok means a fit
    with >= 4 inliers exists."""
    n = src.shape[0]
    nvalid = valid.sum()
    src_n, t_src = _hartley_normalize(src, valid)
    dst_n, t_dst = _hartley_normalize(dst, valid)

    scores = torch.rand((num_samples, n), generator=generator,
                        device=generator.device).to(src.device)
    scores = torch.where(valid[None, :], scores,
                         torch.full_like(scores, float("-inf")))
    idx = torch.sort(scores, dim=1, descending=True,
                     stable=True).indices[:, :4]
    hs = _solve_dlt(src_n[idx], dst_n[idx])                  # (S, 3, 3)
    t_dst_inv = torch.linalg.inv(t_dst)
    hs_full = t_dst_inv @ hs @ t_src

    proj = project_points(hs_full, src[None].expand(num_samples, -1, -1))
    err2 = ((proj - dst[None]) ** 2).sum(-1)
    inlier = (err2 < reproj_threshold ** 2) & valid[None, :]
    counts = inlier.sum(-1)
    best = int(torch.argmax(counts))
    best_inliers = inlier[best]

    w = best_inliers.to(src.dtype)
    h_refit = t_dst_inv @ _solve_dlt(src_n, dst_n, w) @ t_src
    err2_r = ((project_points(h_refit, src) - dst) ** 2).sum(-1)
    inlier_r = (err2_r < reproj_threshold ** 2) & valid
    use_refit = bool(inlier_r.sum() >= counts[best])
    h_best = h_refit if use_refit else hs_full[best]
    inliers = inlier_r if use_refit else best_inliers
    h22 = h_best[2, 2]
    h_best = h_best / torch.where(h22.abs() > 1e-12, h22,
                                  torch.ones_like(h22))
    ok = (inliers.sum() >= 4) & (nvalid >= 4)
    return h_best, inliers, ok
