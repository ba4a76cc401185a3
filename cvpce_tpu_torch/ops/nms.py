"""Greedy hard NMS, Soft-NMS and box merging: the plain torch versions
and the CUDA kernels' wrappers.

Counterpart of cvpce_tpu/ops/nms.py (`nms_mask`, `soft_nms_scores`,
`merge_boxes`) and cvpce_tpu/ops/nms_pallas.py (`nms_mask_pallas`,
`soft_nms_scores_pallas`). Every function takes (N, 4) boxes or a batch
(B, N, 4) and answers in input order.

Hard NMS: `nms_mask` and `nms_mask_fused` share the pad / mask /
stable-sort / scatter steps; they differ only in the serial walk over
the sorted candidates:

- `nms_keep_sorted_plain`: torch ops on any device;
- `nms_keep_sorted`: on a CUDA tensor, the kernels in csrc/nms_hard.cu
  (an IoU bitmask on all SMs, then a one-warp walk per image); on a CPU
  tensor, the plain walk. It counts its calls of the kernels in
  `nms_keep_sorted.launches`.

Soft-NMS: `soft_nms_scores` is the plain version; `soft_nms_scores_fused`
launches csrc/soft_nms.cu for a CUDA tensor (an overlap bitmask on all
SMs, then one chain of rounds per image; its calls counted in
`soft_nms_scores_fused.launches`, the kernels in
`soft_nms_kernels_launched()`) and runs the plain version for a CPU
tensor.

IoU in both NMS walks is `inter / max(union, 1e-12)` with the kernels'
expression order, so the kernels' results are bit-equal to the plain
versions'. `merge_boxes` is plain torch (an IoU matrix and one matmul),
as in the JAX package.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from .boxes import pairwise_iou

ALIGN = 256  # pad N like nms_mask_pallas does


def _iou_rows(boxes: torch.Tensor) -> torch.Tensor:
    """(B, N, 4) -> (B, N, N) IoU of row i against every box, computed
    exactly as csrc/nms_hard.cu does it."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    ix1 = torch.maximum(x1[:, :, None], x1[:, None, :])
    iy1 = torch.maximum(y1[:, :, None], y1[:, None, :])
    ix2 = torch.minimum(x2[:, :, None], x2[:, None, :])
    iy2 = torch.minimum(y2[:, :, None], y2[:, None, :])
    inter = (ix2 - ix1).clamp(min=0.0) * (iy2 - iy1).clamp(min=0.0)
    union = (area[:, :, None] + area[:, None, :]) - inter
    return inter / union.clamp(min=1e-12)


def nms_keep_sorted_plain(boxes_sorted: torch.Tensor, n_walk: torch.Tensor,
                          iou_threshold: float) -> torch.Tensor:
    """Keep flags (B, N) for score-sorted (B, N, 4) boxes: the plain
    version of the kernel. Walks the first n_walk[b] candidates."""
    b, n, _ = boxes_sorted.shape
    iou = _iou_rows(boxes_sorted)
    col = torch.arange(n, device=boxes_sorted.device)
    supp = torch.zeros((b, n), dtype=torch.bool, device=boxes_sorted.device)
    walk = int(n_walk.max()) if b else 0
    for i in range(min(walk, n)):
        alive = ~supp[:, i] & (i < n_walk)
        row = (iou[:, i, :] > iou_threshold) & (col > i)
        supp |= row & alive[:, None]
    return ~supp


def nms_keep_sorted(boxes_sorted: torch.Tensor, n_walk: torch.Tensor,
                    iou_threshold: float) -> torch.Tensor:
    """Keep flags (B, N) for score-sorted (B, N, 4) f32 boxes. A CUDA
    tensor goes to the kernel; a CPU tensor to the plain version."""
    if boxes_sorted.device.type == "cpu":
        return nms_keep_sorted_plain(boxes_sorted, n_walk, iou_threshold)
    if boxes_sorted.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes_sorted.device}")
    if boxes_sorted.dtype != torch.float32 or boxes_sorted.dim() != 3 \
            or boxes_sorted.shape[-1] != 4:
        raise ValueError("boxes_sorted must be (B, N, 4) float32")
    if n_walk.shape != boxes_sorted.shape[:1]:
        raise ValueError("n_walk must be (B,)")
    lib = _lib()
    b, n, _ = boxes_sorted.shape
    if n > lib.nms_hard_max_n():
        raise ValueError(f"N={n} exceeds the walk's removed-bit registers "
                         f"and staged mask rows ({lib.nms_hard_max_n()} "
                         f"boxes)")
    boxes_c = boxes_sorted.contiguous()
    walk = n_walk.to(device=boxes_c.device, dtype=torch.int32).contiguous()
    keep = torch.empty((b, n), dtype=torch.uint8, device=boxes_c.device)
    # the IoU bitmask: bit t of word w in row i says that box i suppresses
    # box 64w + t
    mask = torch.empty((b, n, lib.nms_hard_mask_words(n)), dtype=torch.int64,
                       device=boxes_c.device)
    # the kernels run after this returns; temporaries freed here stay
    # safe because the caching allocator reuses memory in stream order
    if b and n:
        code = lib.nms_hard_launch(
            *(ctypes.c_void_p(t.data_ptr())
              for t in (boxes_c, walk, mask, keep)), b, n,
            ctypes.c_float(iou_threshold), _build.stream_ptr(boxes_c))
        if code:
            raise RuntimeError("nms_hard launch failed: "
                               + lib.nms_hard_error_string(code).decode())
        nms_keep_sorted.launches += 1
    return keep.bool()


nms_keep_sorted.launches = 0


def _lib():
    lib = _build.load("nms_hard")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.nms_hard_launch.argtypes = [vp, vp, vp, vp, ci, ci,
                                        ctypes.c_float, vp]
        lib.nms_hard_launch.restype = ci
        lib.nms_hard_max_n.restype = ci
        lib.nms_hard_mask_words.argtypes = [ci]
        lib.nms_hard_mask_words.restype = ci
        lib.nms_hard_error_string.argtypes = [ctypes.c_int]
        lib.nms_hard_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def sort_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor):
    """(B, N, ...) -> the sorted walk's inputs: boxes padded to an ALIGN
    multiple with far-away invalid dummies and sorted stably by
    descending masked score (B, Np, 4); the sorted valid flags (B, Np);
    how many candidates to walk per image (B,), since those after the
    last valid one cannot affect a valid one; and the sort order."""
    b, n, _ = boxes.shape
    pad = (-n) % ALIGN
    if pad:
        far = torch.full((b, pad, 4), -1e6, dtype=boxes.dtype,
                         device=boxes.device)
        far[..., 2:] += 1.0
        boxes = torch.cat([boxes, far], 1)
        scores = torch.cat([scores, torch.full(
            (b, pad), float("-inf"), dtype=scores.dtype,
            device=scores.device)], 1)
        valid = torch.cat([valid, torch.zeros(
            (b, pad), dtype=torch.bool, device=valid.device)], 1)
    masked = torch.where(valid, scores,
                         torch.full_like(scores, float("-inf")))
    order = torch.sort(masked, dim=1, descending=True, stable=True).indices
    boxes_s = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    valid_s = torch.gather(valid, 1, order)
    pos = torch.arange(1, boxes.shape[1] + 1, device=boxes.device)
    n_walk = torch.where(valid_s, pos, torch.zeros_like(pos)).amax(1)
    return boxes_s.contiguous(), valid_s, n_walk, order


def _nms(boxes, scores, valid, iou_threshold, walk_fn):
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    n = boxes.shape[1]
    boxes_s, valid_s, n_walk, order = sort_candidates(boxes, scores, valid)
    keep_s = walk_fn(boxes_s, n_walk, iou_threshold) & valid_s
    keep = torch.zeros_like(keep_s).scatter_(1, order, keep_s)[:, :n]
    return keep[0] if single else keep


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float = 0.5) -> torch.Tensor:
    """Greedy hard-NMS keep mask, plain torch on any device. boxes
    (N, 4) or (B, N, 4) xyxy; scores and valid (N,) or (B, N)."""
    return _nms(boxes, scores, valid, iou_threshold, nms_keep_sorted_plain)


def nms_mask_fused(boxes: torch.Tensor, scores: torch.Tensor,
                   valid: torch.Tensor,
                   iou_threshold: float = 0.5) -> torch.Tensor:
    """`nms_mask` with the walk in the CUDA kernel for CUDA tensors."""
    return _nms(boxes, scores, valid, iou_threshold, nms_keep_sorted)


def soft_nms_scores(boxes: torch.Tensor, scores: torch.Tensor,
                    valid: torch.Tensor, sigma: float = 0.5,
                    iou_threshold: float = 0.5,
                    method: str = "gaussian") -> torch.Tensor:
    """Soft-NMS re-scoring, plain torch on any device: each round picks
    the unprocessed maximum (lowest index on ties) and decays the other
    unprocessed scores by exp(-iou^2 / sigma) (gaussian) or, above
    `iou_threshold`, by 1 - iou (linear). Returns the re-scored (N,) or
    (B, N) scores, 0 at invalid entries. Runs one round per valid
    candidate of the fullest image."""
    if method not in ("gaussian", "linear"):
        raise ValueError(f"unknown Soft-NMS method {method!r}")
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    b, n, _ = boxes.shape
    iou = _iou_rows(boxes)
    col = torch.arange(n, device=boxes.device)
    # a 0-dim device tensor, so torch divides as the kernel does (a
    # Python scalar divisor becomes a reciprocal multiply on CUDA)
    sig = torch.tensor(sigma, dtype=scores.dtype, device=scores.device)
    neg = torch.full_like(scores, float("-inf"))
    cur = scores.clone()
    proc = ~valid
    rounds = int(valid.sum(1).max()) if b else 0
    for _ in range(rounds):
        cand = torch.where(proc, neg, cur)
        m = cand.amax(1, keepdim=True)
        live = m > float("-inf")
        i = torch.where(cand == m, col, n).amin(1)
        row = torch.gather(iou, 1, i[:, None, None].expand(-1, 1, n))[:, 0]
        if method == "gaussian":
            decay = torch.exp(-(row * row) / sig)
        else:
            decay = torch.where(row > iou_threshold, 1.0 - row,
                                torch.ones_like(row))
        sel = (col == i[:, None]) & live
        decay = torch.where(proc | sel, torch.ones_like(decay), decay)
        cur = cur * decay
        proc = proc | sel
    out = torch.where(valid, cur, torch.zeros_like(cur))
    return out[0] if single else out


def soft_nms_scores_fused(boxes: torch.Tensor, scores: torch.Tensor,
                          valid: torch.Tensor, sigma: float = 0.5,
                          iou_threshold: float = 0.5,
                          method: str = "gaussian") -> torch.Tensor:
    """`soft_nms_scores` in the CUDA kernels for CUDA tensors (no sort;
    two launches: the overlap bitmask, then one chain block per image); a
    CPU tensor takes the plain version."""
    if boxes.device.type == "cpu":
        return soft_nms_scores(boxes, scores, valid, sigma, iou_threshold,
                               method)
    if boxes.device.type != "cuda":
        raise ValueError(f"unsupported device {boxes.device}")
    if method not in ("gaussian", "linear"):
        raise ValueError(f"unknown Soft-NMS method {method!r}")
    single = boxes.dim() == 2
    if single:
        boxes, scores, valid = boxes[None], scores[None], valid[None]
    if boxes.dtype != torch.float32 or boxes.dim() != 3 \
            or boxes.shape[-1] != 4:
        raise ValueError("boxes must be (B, N, 4) float32")
    b, n, _ = boxes.shape
    lib = _soft_lib()
    if n > lib.soft_nms_max_n():
        raise ValueError(f"N={n} exceeds one block's shared memory "
                         f"({lib.soft_nms_max_n()} boxes)")
    boxes_c = boxes.contiguous()
    scores_c = scores.to(boxes_c.device, torch.float32).contiguous()
    valid_c = valid.to(boxes_c.device, torch.uint8).contiguous()
    out = torch.empty((b, n), dtype=torch.float32, device=boxes_c.device)
    # the overlap bitmask: bit t of word w in row i says that the decay
    # between boxes i and 64w + t may differ from exactly 1
    mask = torch.empty((b, n, lib.soft_nms_mask_words(n)), dtype=torch.int64,
                       device=boxes_c.device)
    if b and n:
        code = lib.soft_nms_launch(
            *(ctypes.c_void_p(t.data_ptr())
              for t in (boxes_c, scores_c, valid_c, mask, out)), b, n,
            ctypes.c_float(sigma), ctypes.c_float(iou_threshold),
            int(method == "linear"), _build.stream_ptr(boxes_c))
        if code:
            raise RuntimeError("soft_nms launch failed: "
                               + lib.soft_nms_error_string(code).decode())
        soft_nms_scores_fused.launches += 1
    return out[0] if single else out


soft_nms_scores_fused.launches = 0


def soft_nms_kernels_launched() -> int:
    """Kernels csrc/soft_nms.cu has launched in this process, counted
    where it launches them (two a call). Builds the library on first
    use."""
    return _soft_lib().soft_nms_kernels_launched()


def _soft_lib():
    lib = _build.load("soft_nms")
    if not getattr(lib, "_typed", False):
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.soft_nms_launch.argtypes = [vp, vp, vp, vp, vp, ci, ci, cf, cf,
                                        ci, vp]
        lib.soft_nms_launch.restype = ci
        lib.soft_nms_max_n.restype = ci
        lib.soft_nms_mask_words.argtypes = [ci]
        lib.soft_nms_mask_words.restype = ci
        lib.soft_nms_kernels_launched.restype = ctypes.c_ulonglong
        lib.soft_nms_error_string.argtypes = [ci]
        lib.soft_nms_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def merge_boxes(boxes: torch.Tensor, scores: torch.Tensor,
                valid: torch.Tensor, keep: torch.Tensor,
                iou_threshold: float = 0.5) -> torch.Tensor:
    """Score-weighted box merging of NMS survivors: each kept box becomes
    the score-weighted mean of the valid boxes overlapping it above
    `iou_threshold` (itself included, IoU 1); the others are returned
    unchanged. (N, 4) or (B, N, 4)."""
    iou = pairwise_iou(boxes, boxes)
    w = torch.where(keep[..., :, None] & valid[..., None, :]
                    & (iou > iou_threshold),
                    iou * scores[..., None, :], torch.zeros_like(iou))
    total = w.sum(-1, keepdim=True).clamp(min=1e-12)
    merged = (w @ boxes) / total
    return torch.where(keep[..., None], merged, boxes)
