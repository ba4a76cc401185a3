"""Cosine-distance kNN: the plain torch version and the fused CUDA
kernel's wrapper.

Counterpart of cvpce_tpu/ops/knn.py (plain: distance matrix + top-k) and
cvpce_tpu/ops/knn_pallas.py:nearest_neighbors_fused (kernel). Ties go to
the lowest gallery index in both: the plain version takes a stable sort,
never `torch.topk`, whose tie order is unspecified.

`nearest_neighbors_fused` launches csrc/knn_fused.cu for CUDA tensors
(a one-pass gallery scan and a merge of its partial top-k lists) and
counts those calls in `nearest_neighbors_fused.launches`; for CPU
tensors it returns the plain version's result. Rows past the gallery's
end are masked in the kernel, never ranked. A gallery that stays
resident takes its inverse norms once, from `inverse_norms` (the same
.cu file's first pass), and hands them to every search. The kernel
keeps a 32-query tile resident up to `knn_fused_resident_max_dim()`
(1280 on an H100) and streams the queries beside the gallery above it,
up to `knn_fused_max_dim()` (4096): MACResNet's 1536-d and 3904-d
embeddings take the streamed scan.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import _build

MAX_K = 8
# the smallest gallery the callers search with the fused kernel; smaller
# ones take the plain distance matrix, as in the JAX package
FUSED_MIN_ROWS = 4096
# the largest (Q, rows, D) product `distance_matrix` holds at once
_PRODUCT_ELEMS = 1 << 24


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / norm.clamp(min=eps)


def cosine_distance(a: torch.Tensor, b: torch.Tensor, axis: int = -1,
                    eps: float = 1e-8) -> torch.Tensor:
    """1 - cosine similarity along `axis`, each vector's norm clamped to
    at least `eps` (F.cosine_similarity's semantics)."""
    an = torch.linalg.vector_norm(a, dim=axis, keepdim=True)
    bn = torch.linalg.vector_norm(b, dim=axis, keepdim=True)
    sim = ((a / an.clamp(min=eps)) * (b / bn.clamp(min=eps))).sum(axis)
    return 1.0 - sim


def distance_matrix(queries: torch.Tensor, anchors: torch.Tensor,
                    eps: float = 1e-8) -> torch.Tensor:
    """(Q, D) x (A, D) -> (Q, A) cosine distances, f32. Each similarity
    is the sum over D of its own row product, whatever the row's place
    in the gallery: a BLAS GEMM sums the columns at the edge of its
    tiles in another order, and then two equal gallery rows got two
    distances and lost the lowest-row tie rule."""
    q = l2_normalize(queries.float(), eps)
    a = l2_normalize(anchors.float(), eps)
    step = max(1, _PRODUCT_ELEMS // max(1, q.shape[0] * q.shape[1]))
    sim = [(q[:, None, :] * a[None, s:s + step]).sum(-1)
           for s in range(0, a.shape[0], step)]
    return 1.0 - (torch.cat(sim, 1) if sim else q.new_zeros(len(q), 0))


def knn_plain(anchors: torch.Tensor, queries: torch.Tensor,
              k: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """(distances (Q, k), indices (Q, k)) ascending; ties to the lowest
    index."""
    dists = distance_matrix(queries, anchors)
    sd, si = torch.sort(dists, dim=1, stable=True)
    return sd[:, :k], si[:, :k]


def nearest_neighbors(anchors: torch.Tensor, queries: torch.Tensor,
                      k: int = 1) -> torch.Tensor:
    """Indices (Q, k) of the k nearest anchors per query."""
    return knn_plain(anchors, queries, k)[1]


def knn_masked(anchors: torch.Tensor, anchor_valid: torch.Tensor,
               queries: torch.Tensor, k: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`knn_plain` over a padded gallery: rows where `anchor_valid` is
    False get +inf distance (and rank after every valid row)."""
    dists = distance_matrix(queries, anchors)
    dists = torch.where(anchor_valid[None, :], dists,
                        torch.full_like(dists, float("inf")))
    sd, si = torch.sort(dists, dim=1, stable=True)
    return sd[:, :k], si[:, :k]


def nearest_neighbors_masked(anchors: torch.Tensor,
                             anchor_valid: torch.Tensor,
                             queries: torch.Tensor,
                             k: int = 1) -> torch.Tensor:
    """Indices (Q, k) of the k nearest valid anchors per query."""
    return knn_masked(anchors, anchor_valid, queries, k)[1]


def inverse_norms(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """(N, D) -> (N,) f32 `1 / max(||row||, eps)`: the fused kernel's
    normalization pass, launched from csrc/knn_fused.cu for a CUDA
    tensor, computed plainly for a CPU tensor."""
    if x.device.type == "cpu":
        return 1.0 / torch.linalg.vector_norm(x.float(), dim=-1).clamp(
            min=eps)
    if x.device.type != "cuda" or x.dim() != 2:
        raise ValueError("a 2-D CPU or CUDA tensor is required")
    lib = _lib()
    xc = x.float().contiguous()
    inv = torch.empty(xc.shape[0], dtype=torch.float32, device=xc.device)
    _check(lib, lib.knn_inv_norm_launch(
        ctypes.c_void_p(xc.data_ptr()), xc.shape[0], xc.shape[1],
        ctypes.c_void_p(inv.data_ptr()), _build.stream_ptr(xc)))
    return inv


def nearest_neighbors_fused(anchors: torch.Tensor, queries: torch.Tensor,
                            k: int = 1,
                            anchor_inv_norms: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused kNN: (distances (Q, k) f32, indices (Q, k) int64). A CUDA
    tensor goes to the kernel; a CPU tensor to `knn_plain`.
    `anchor_inv_norms` is `inverse_norms(anchors)`, kept by a caller that
    searches one gallery many times (two launches a search); without it
    the gallery's norms are taken anew in this call (one launch more).
    The kernel loads rows 16 bytes at a time: it refuses D % 4 != 0 and
    rows that do not start 16-byte aligned, and does not copy them."""
    if anchors.device.type == "cpu" and queries.device.type == "cpu":
        return knn_plain(anchors, queries, k)
    if anchors.device.type != "cuda" or queries.device != anchors.device:
        raise ValueError("anchors and queries must share one CUDA device")
    if anchors.dim() != 2 or queries.dim() != 2 \
            or anchors.shape[1] != queries.shape[1]:
        raise ValueError("anchors (A, D) and queries (Q, D) required")
    na, dim = anchors.shape
    nq = queries.shape[0]
    if not 1 <= k <= MAX_K or k > na:
        raise ValueError(f"k={k} must be in [1, {MAX_K}] and <= A={na}")
    lib = _lib()
    if dim % 4 or dim > knn_fused_max_dim():
        raise ValueError(f"D={dim} must be a multiple of 4 and at most "
                         f"{knn_fused_max_dim()}")
    a = anchors.float().contiguous()
    q = queries.float().contiguous()
    for name, t in (("anchors", a), ("queries", q)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start 16-byte aligned")
    if anchor_inv_norms is None:
        anchor_inv_norms = inverse_norms(a)
    inv_g = anchor_inv_norms.float().contiguous()
    if inv_g.shape != (na,) or inv_g.device != a.device:
        raise ValueError("anchor_inv_norms must be (A,) on the anchors' "
                         "device")
    dev = a.device
    nparts = lib.knn_fused_parts(na, dim, k)
    if nparts <= 0:
        _check(lib, -nparts)
    slots = 1 if k == 1 else MAX_K
    part_d = torch.empty(nq * nparts * slots, dtype=torch.float32,
                         device=dev)
    part_i = torch.empty(nq * nparts * slots, dtype=torch.int32, device=dev)
    out_d = torch.empty((nq, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nq, k), dtype=torch.int64, device=dev)
    # the scratch tensors die here while the kernels may still run: the
    # caching allocator hands their memory out again in stream order only
    if nq:
        _check(lib, lib.knn_fused_launch(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, a, inv_g)),
            nq, na, dim, k,
            *(ctypes.c_void_p(t.data_ptr())
              for t in (part_d, part_i, out_d, out_i)),
            _build.stream_ptr(a)))
        nearest_neighbors_fused.launches += 1
    return out_d, out_i


nearest_neighbors_fused.launches = 0


def knn_fused_max_dim() -> int:
    """The widest D `nearest_neighbors_fused` takes on this card."""
    return _lib().knn_fused_max_dim()


def knn_fused_resident_max_dim() -> int:
    """The widest D whose query tile stays resident in the scan; wider
    queries stream through its ring."""
    return _lib().knn_fused_resident_max_dim()


def kernels_launched() -> int:
    """Kernels csrc/knn_fused.cu has launched in this process (its norm
    pass, scan and merge each count one): the difference across a call
    is that call's launches."""
    return _lib().knn_fused_kernels_launched()


def _check(lib, code: int) -> None:
    if code:
        raise RuntimeError("knn_fused launch failed: "
                           + lib.knn_fused_error_string(code).decode())


def _lib():
    lib = _build.load("knn_fused")
    if not getattr(lib, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.knn_inv_norm_launch.argtypes = [vp, ci, ci, vp, vp]
        lib.knn_inv_norm_launch.restype = ci
        lib.knn_fused_launch.argtypes = [
            vp, vp, vp, ci, ci, ci, ci, vp, vp, vp, vp, vp]
        lib.knn_fused_launch.restype = ci
        lib.knn_fused_parts.argtypes = [ci, ci, ci]
        lib.knn_fused_parts.restype = ci
        lib.knn_fused_max_dim.restype = ci
        lib.knn_fused_resident_max_dim.restype = ci
        lib.knn_fused_kernels_launched.restype = ctypes.c_ulonglong
        lib.knn_fused_error_string.argtypes = [ctypes.c_int]
        lib.knn_fused_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib
