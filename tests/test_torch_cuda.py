"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Marked `cuda`; they skip without one. This file imports no JAX,
so it runs on the GPU machine:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from cvpce_tpu_torch.ops import conv_fused, knn, nms

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


def soft_case(cuda, b, n, seed):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 300, (b, n, 2))
    wh = rng.uniform(5, 60, (b, n, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + wh], -1)
                             .astype(np.float32)).to(cuda)
    scores = torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(
        np.float32)).to(cuda)
    valid = torch.from_numpy(rng.uniform(0, 1, (b, n)) < 0.9).to(cuda)
    return boxes, scores, valid


# n = 1000 is no multiple of any tile; 5120 fills the block's shared memory
@pytest.mark.parametrize("n", [1000, 5120])
@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_kernel_matches_plain(cuda, method, n):
    boxes, scores, valid = soft_case(cuda, 2, n, n)
    before = nms.soft_nms_scores_fused.launches
    got = nms.soft_nms_scores_fused(boxes, scores, valid, 0.5, 0.5, method)
    assert nms.soft_nms_scores_fused.launches == before + 1
    want = nms.soft_nms_scores(boxes, scores, valid, 0.5, 0.5, method)
    torch.cuda.synchronize()
    # same IoU expression and expf, no FMA contraction: equal up to the
    # exp of the CUDA math library against torch's
    assert (got - want).abs().max() <= 1e-6
    assert torch.equal(got > 0.05, want > 0.05)
    assert (got[~valid] == 0).all()


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("fuse_relu", [False, True])
@pytest.mark.parametrize("cin,cout,hw", [(64, 128, 36), (128, 256, 20),
                                         (256, 512, 16)])
def test_pool_int8_conv_kernel_matches_plain(cuda, cin, cout, hw, fuse_relu,
                                             out_dtype, x_dtype):
    rng = np.random.default_rng(cin)
    x = torch.from_numpy(rng.uniform(-3, 3, (2, hw, hw + 4, cin)).astype(
        np.float32)).to(cuda, x_dtype)
    kq = torch.from_numpy(rng.integers(-127, 128, (3, 3, cin, cout))
                          .astype(np.int8)).to(cuda)
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-4, cout).astype(
        np.float32)).to(cuda)
    bias = torch.from_numpy(rng.normal(0, 0.1, cout).astype(
        np.float32)).to(cuda)
    a_scale = 3.0 / 127.0
    before = conv_fused.fused_pool_int8_conv.launches
    acc = conv_fused.fused_pool_int8_conv(x, kq, a_scale, scale, bias,
                                          out_dtype=torch.int32)
    got = conv_fused.fused_pool_int8_conv(x, kq, a_scale, scale, bias,
                                          fuse_relu, out_dtype)
    assert conv_fused.fused_pool_int8_conv.launches == before + 2
    acc_p = conv_fused.pool_int8_conv_plain(x, kq, a_scale, scale, bias,
                                            out_dtype=torch.int32)
    want = conv_fused.pool_int8_conv_plain(x, kq, a_scale, scale, bias,
                                           fuse_relu, out_dtype)
    torch.cuda.synchronize()
    assert torch.equal(acc, acc_p)  # int32 accumulators, bit for bit
    assert got.dtype == out_dtype and got.shape == want.shape
    # same epilogue rounding (multiply, then add, then the cast)
    assert torch.equal(got, want)
