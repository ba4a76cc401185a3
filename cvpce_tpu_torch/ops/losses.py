"""Loss functions for GLN and DIHE training; counterpart of
cvpce_tpu/ops/losses.py.

- sigmoid focal loss (torchvision RetinaNet's) with a stable BCE;
- the Gaussian heatmap loss with hard-negative mining: the top
  k = max(min_negatives, 3 * #pos) negatives are a descending sort and a
  prefix sum read at k, a tensor index, so no host sync; inside a
  data-parallel step over several ranks the mining runs over the global
  batch (`_mined_over_ranks`);
- the hierarchical triplet loss and ZNCC of the DIHE trainer.

Every function is plain torch and differentiable, with jnp's gradients
at the kinks: max(x, 0) is a relu (0 at x = 0, where torch.maximum would
split it), |x| has 0 at 0.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.mesh import active_mesh, all_gather
from .knn import cosine_distance


def optax_sigmoid_ce(logits: torch.Tensor,
                     labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable binary CE with logits."""
    return (torch.relu(logits) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Elementwise sigmoid focal loss (Lin et al. 2017), torchvision's
    formulation."""
    p = torch.sigmoid(logits)
    ce = optax_sigmoid_ce(logits, targets)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    return loss


def gaussian_heatmap_loss(predictions: torch.Tensor, targets: torch.Tensor,
                          tanh: bool = False,
                          negative_threshold: float = 0.0,
                          positive_threshold: float = 0.1,
                          min_negatives: int = 1000,
                          negatives_per_positive: int = 3) -> torch.Tensor:
    """MSE with hard-negative mining over the whole batch: every positive
    pixel (target >= positive_threshold) counts, the largest
    max(min_negatives, 3 * #pos) errors among the negative pixels
    (target <= negative_threshold) count, normalised by their number.
    `tanh` is accepted for the JAX signature; the thresholds carry it.
    Inside a data-parallel step the batch is the global one
    (`_mined_over_ranks`)."""
    pred = predictions.reshape(-1)
    tgt = targets.reshape(-1)
    se = (pred - tgt) ** 2

    pos_mask = tgt >= positive_threshold
    neg_mask = tgt <= negative_threshold
    mesh = active_mesh()
    if mesh is not None:
        return _mined_over_ranks(se, pos_mask, neg_mask, mesh,
                                 min_negatives, negatives_per_positive)
    n_pos = pos_mask.sum()
    pos_sum = torch.where(pos_mask, se, torch.zeros_like(se)).sum()

    # SE >= 0, so -1 sorts last
    neg_se = torch.where(neg_mask, se, torch.full_like(se, -1.0))
    neg_sorted = torch.sort(neg_se, descending=True).values
    neg_cumsum = torch.cumsum(
        torch.where(neg_sorted >= 0, neg_sorted,
                    torch.zeros_like(neg_sorted)), 0)

    n_top = torch.clamp(negatives_per_positive * n_pos, min=min_negatives)
    n_top = torch.minimum(n_top, neg_mask.sum())
    picked = neg_cumsum[(n_top - 1).clamp(min=0)]
    neg_sum = torch.where(n_top > 0, picked, torch.zeros_like(picked))
    denom = (n_pos + n_top).clamp(min=1)
    return (pos_sum + neg_sum) / denom


def _mined_over_ranks(se: torch.Tensor, pos_mask: torch.Tensor,
                      neg_mask: torch.Tensor, mesh, min_negatives: int,
                      negatives_per_positive: int) -> torch.Tensor:
    """The heatmap loss over the global batch, of which this rank holds
    the slice `se` (rank-major, as the global batch is laid out).

    #pos and the positives' sum are all-reduced; every rank's negative
    errors (detached) are gathered and sorted once, descending and
    stable, so the kept negatives are the first n_top of that order and
    ties at the cut go to the lowest global index, as JAX's one stable
    sort of the whole batch breaks them. The value is the global loss on
    every rank. Its gradient reaches this rank's kept pixels scaled by the
    rank count, so the gradients averaged over the ranks are the global
    loss's."""
    zero = torch.zeros_like(se)
    pos_sum = torch.where(pos_mask, se, zero).sum()
    totals = torch.stack([pos_mask.sum().double(), pos_sum.detach().double()])
    dist.all_reduce(totals, group=mesh.group)
    n_pos = totals[0].long()

    neg_se = torch.where(neg_mask, se, torch.full_like(se, -1.0)).detach()
    every = torch.cat(all_gather(neg_se, mesh))
    ranked, order = torch.sort(every, descending=True, stable=True)
    n_top = torch.clamp(negatives_per_positive * n_pos, min=min_negatives)
    n_top = torch.minimum(n_top, (every >= 0).sum())
    neg_cumsum = torch.cumsum(torch.where(ranked >= 0, ranked,
                                          torch.zeros_like(ranked)), 0)
    picked = neg_cumsum[(n_top - 1).clamp(min=0)]
    neg_sum = torch.where(n_top > 0, picked, torch.zeros_like(picked))
    denom = (n_pos + n_top).clamp(min=1)
    value = ((totals[1] + neg_sum) / denom).to(se.dtype)

    position = torch.empty_like(order)
    position[order] = torch.arange(len(order), device=order.device)
    n = se.numel()
    kept = position[mesh.rank * n:(mesh.rank + 1) * n] < n_top
    local = (pos_sum + torch.where(kept, se, zero).sum()) * (
        mesh.size / denom.to(se.dtype))
    return value + (local - local.detach())


def hierarchical_triplet_loss(anchor_emb: torch.Tensor,
                              pos_emb: torch.Tensor, neg_emb: torch.Tensor,
                              similarity: torch.Tensor,
                              min_margin: float = 0.05,
                              max_margin: float = 0.5) -> torch.Tensor:
    """Adaptive-margin triplet hinge on cosine distances; `similarity`
    (B,) in [0, 1] between the positive's and the negative's category
    paths sets the margin."""
    margin = min_margin + (1.0 - similarity) * (max_margin - min_margin)
    d_pos = cosine_distance(anchor_emb, pos_emb, axis=1)
    d_neg = cosine_distance(anchor_emb, neg_emb, axis=1)
    return torch.relu(d_pos - d_neg + margin).mean()


def zncc(a: torch.Tensor, b: torch.Tensor,
         eps: float = 1e-8) -> torch.Tensor:
    """Zero-normalised cross-correlation of (B, H, W, C) images in the
    reference's scale: per (image, channel) sum((a - mean_a)(b - mean_b))
    / (std_a * std_b) with unbiased stds, summed and divided by
    B * C * H * W."""
    bsz, ch = a.shape[0], a.shape[-1]
    af = a.reshape(bsz, -1, ch)
    bf = b.reshape(bsz, -1, ch)
    n = af.shape[1]
    ac = af - af.mean(dim=1, keepdim=True)
    bc = bf - bf.mean(dim=1, keepdim=True)
    num = (ac * bc).sum(dim=1)
    denom = torch.sqrt(((ac ** 2).sum(dim=1) / (n - 1))
                       * ((bc ** 2).sum(dim=1) / (n - 1)))
    terms = num / denom.clamp(min=eps)
    return terms.sum() / (bsz * ch * n)


def masked_zncc(a: torch.Tensor, b: torch.Tensor, mask: torch.Tensor,
                eps: float = 1e-8) -> torch.Tensor:
    """ZNCC over the pixels where `mask` ((B, H, W) or (B, H, W, 1)) is
    1, with unbiased masked stds; the total is divided by the unmasked
    element count B * C * H * W, as the reference divides."""
    if mask.dim() == 3:
        mask = mask[..., None]
    bsz, ch = a.shape[0], a.shape[-1]
    m = mask.reshape(bsz, -1, 1).to(a.dtype)
    af = a.reshape(bsz, -1, ch)
    bf = b.reshape(bsz, -1, ch)
    n_total = af.shape[1]
    nm = m.sum(dim=1).clamp(min=2.0)  # (B, 1)
    am = (af * m).sum(dim=1, keepdim=True) / nm[:, None]
    bm = (bf * m).sum(dim=1, keepdim=True) / nm[:, None]
    ac = (af - am) * m
    bc = (bf - bm) * m
    num = (ac * bc).sum(dim=1)
    denom = torch.sqrt(((ac ** 2).sum(dim=1) / (nm - 1))
                       * ((bc ** 2).sum(dim=1) / (nm - 1)))
    terms = num / denom.clamp(min=eps)
    return terms.sum() / (bsz * ch * n_total)
