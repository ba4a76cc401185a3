"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Marked `cuda`; they skip without one. This file imports no JAX,
so it runs on the GPU machine:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from cvpce_tpu_torch.ops import knn, nms

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_nms_kernel_bit_equal_to_plain(cuda):
    rng = np.random.default_rng(9)
    n = 5120
    cx, cy = rng.uniform(0, 1300, (2, n)), rng.uniform(0, 800, (2, n))
    w, h = rng.uniform(4, 120, (2, n)), rng.uniform(4, 160, (2, n))
    boxes = torch.from_numpy(np.stack(
        [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
        .astype(np.float32)).to(cuda)
    scores = torch.from_numpy(rng.uniform(0, 1, (2, n)).astype(
        np.float32)).to(cuda)
    valid = torch.from_numpy(rng.uniform(0, 1, (2, n)) < 0.95).to(cuda)
    before = nms.nms_keep_sorted.launches
    fused = nms.nms_mask_fused(boxes, scores, valid, 0.5)
    assert nms.nms_keep_sorted.launches == before + 1
    assert torch.equal(fused, nms.nms_mask(boxes, scores, valid, 0.5))


@pytest.mark.parametrize("cached_norms", [False, True])
@pytest.mark.parametrize("k", [1, 8])
def test_knn_kernel_matches_plain(cuda, k, cached_norms):
    gen = torch.Generator(device=cuda).manual_seed(k)
    g = torch.randn((5000, 1024), device=cuda, generator=gen)
    q = torch.randn((40, 1024), device=cuda, generator=gen)
    inv = knn.inverse_norms(g) if cached_norms else None
    before = knn.nearest_neighbors_fused.launches
    d, i = knn.nearest_neighbors_fused(g, q, k, inv)
    assert knn.nearest_neighbors_fused.launches == before + 1
    pd, pi = knn.knn_plain(g, q, k)
    assert (d - pd).abs().max() <= 1e-5  # f32 dots summed in another order
    assert torch.equal(i, pi)
