"""The port's CUDA kernels against their plain PyTorch versions, and one
GLN train step against the same step on the CPU, on a card. Marked
`cuda`; they skip without one. This file imports no JAX,
so it runs on the GPU machine:

    python3 -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from cvpce_tpu_torch import testing
from cvpce_tpu_torch.ops import conv_fused, knn, nms

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("case", ("random",) + testing.NMS_EDGE_CASES)
def test_nms_kernel_bit_equal_to_plain(cuda, case):
    rng = np.random.default_rng(9)
    if case == "random":
        n = 5120
        boxes = torch.from_numpy(testing.random_boxes(rng, 2, n)).to(cuda)
        scores = torch.from_numpy(rng.uniform(0, 1, (2, n)).astype(
            np.float32)).to(cuda)
        valid = torch.from_numpy(rng.uniform(0, 1, (2, n)) < 0.95).to(cuda)
        before = nms.nms_keep_sorted.launches
        fused = nms.nms_mask_fused(boxes, scores, valid, 0.5)
        assert nms.nms_keep_sorted.launches == before + 1
        assert torch.equal(fused, nms.nms_mask(boxes, scores, valid, 0.5))
        return
    boxes, walk = testing.nms_sorted_case(case, rng)
    boxes = torch.from_numpy(boxes).to(cuda)
    walk = torch.from_numpy(walk).to(cuda)
    got = nms.nms_keep_sorted(boxes, walk, 0.5)
    want = nms.nms_keep_sorted_plain(boxes, walk, 0.5)
    assert torch.equal(got, want)
    if case == "identical":
        assert got.sum() == 1 and got[0, 0]


def test_kernel_wrappers_refuse_what_kernels_cannot_take(cuda):
    g = torch.randn((4096, 1024), device=cuda)
    q = torch.randn((33, 1024), device=cuda)
    misaligned = q.flatten()[1:1 + 32 * 1024].view(32, 1024)
    with pytest.raises(ValueError, match="aligned"):
        knn.nearest_neighbors_fused(g, misaligned, 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        knn.nearest_neighbors_fused(g[:, :1022], q[:, :1022], 1)
    # the streamed-query scan takes MACResNet's widest descriptor (c1..c5)
    assert knn.knn_fused_resident_max_dim() < 1536
    assert knn.knn_fused_max_dim() >= 3904
    wide = knn.knn_fused_max_dim() + 4
    with pytest.raises(ValueError, match="at most"):
        knn.nearest_neighbors_fused(torch.zeros((4096, wide), device=cuda),
                                    torch.zeros((2, wide), device=cuda), 1)
    for k in (0, 9):
        with pytest.raises(ValueError, match="k="):
            knn.nearest_neighbors_fused(g, q, k)
    with pytest.raises(ValueError, match="k="):
        knn.nearest_neighbors_fused(g[:4], q, 5)
    boxes = torch.zeros((1, 64, 4), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        nms.nms_keep_sorted(boxes.double(), torch.ones(1, device=cuda), 0.5)
    with pytest.raises(ValueError, match="float32"):
        nms.nms_keep_sorted(boxes[0], torch.ones(1, device=cuda), 0.5)
    big = torch.zeros((1, nms._lib().nms_hard_max_n() + 64, 4), device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        nms.nms_keep_sorted(big, torch.ones(1, device=cuda), 0.5)


# D = 1000 ends in a partial depth stage; D = 256 is a single one; Q = 200
# runs 7 query tiles through one block's ring at the serving gallery.
# D = 1284 and up stream the queries through the ring: 1284 is the first
# such D and ends in a 4-deep chunk, 1536 is MACResNet's c3 + c4, 3904
# its c1..c5
@pytest.mark.parametrize("nq,na,k,cached_norms,dim", [
    (40, 5000, 1, False, 1024), (40, 5000, 1, True, 1024),
    (200, 8192, 8, True, 1024),
    (40, 5000, 8, False, 1024), (40, 5000, 8, True, 1024),
    (67, 4097, 5, True, 1000), (5, 20000, 8, True, 256),
    (32, 8192, 1, True, 1536), (67, 4097, 5, False, 1536),
    (1, 4096, 1, True, 1284), (33, 4097, 8, True, 3904),
    (200, 4096, 8, False, 3904)] + [
    (nq, na, k, True, 1024) for nq in testing.KNN_QUERIES
    for na in testing.KNN_GALLERIES for k in testing.KNN_KS])
def test_knn_kernel_matches_plain(cuda, nq, na, k, cached_norms, dim):
    gen = torch.Generator(device=cuda).manual_seed(k)
    g = torch.randn((na, dim), device=cuda, generator=gen)
    q = torch.randn((nq, dim), device=cuda, generator=gen)
    inv = knn.inverse_norms(g) if cached_norms else None
    before = knn.nearest_neighbors_fused.launches
    kernels = knn.kernels_launched()
    d, i = knn.nearest_neighbors_fused(g, q, k, inv)
    assert knn.nearest_neighbors_fused.launches == before + 1
    # the scan and the merge, and the gallery's norms when not cached
    assert knn.kernels_launched() - kernels == (2 if cached_norms else 3)
    pd, pi = knn.knn_plain(g, q, k)
    assert (d - pd).abs().max() <= 1e-5  # f32 dots summed in another order
    assert torch.equal(i, pi)
    # the sums run in a fixed order: a second search is bit-equal
    d2, i2 = knn.nearest_neighbors_fused(g, q, k, inv)
    assert torch.equal(d2, d) and torch.equal(i2, i)


@pytest.mark.parametrize("k", testing.KNN_KS)
def test_knn_kernel_ties_to_lowest_index(cuda, k):
    gen = torch.Generator(device=cuda).manual_seed(5)
    rows = testing.KNN_DUP_ROWS
    g = torch.randn((rows, 1024), device=cuda, generator=gen).repeat(
        testing.KNN_DUP_COPIES, 1)
    q = torch.randn((32, 1024), device=cuda, generator=gen)
    d, i = knn.nearest_neighbors_fused(g, q, k)
    pd, pi = knn.knn_plain(g, q, k)
    assert torch.equal(i, pi)
    assert (i[:, 0] < rows).all()
    assert (d - pd).abs().max() <= 1e-5


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


# n = 1000 is no multiple of any tile; 5120 is the serve path's most;
# then the adversarial cases of cvpce_tpu_torch.testing
@pytest.mark.parametrize("case", ("random1000", "random5120")
                         + testing.SOFT_EDGE_CASES)
@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_kernel_matches_plain(cuda, method, case):
    if case.startswith("random"):
        n = int(case[len("random"):])
        boxes, scores, valid = soft_case(cuda, 2, n, n)
    else:
        boxes, scores, valid = (torch.from_numpy(a).to(cuda) for a in
                                testing.soft_nms_case(
                                    case, np.random.default_rng(13)))
    before = nms.soft_nms_scores_fused.launches
    kernels = nms.soft_nms_kernels_launched()
    got = nms.soft_nms_scores_fused(boxes, scores, valid, 0.5, 0.5, method)
    assert nms.soft_nms_scores_fused.launches == before + 1
    # the overlap bitmask, then the chain
    assert nms.soft_nms_kernels_launched() - kernels == 2
    want = nms.soft_nms_scores(boxes, scores, valid, 0.5, 0.5, method)
    torch.cuda.synchronize()
    # same rounds, IoU and decay expressions, expf, no FMA contraction
    assert torch.equal(got, want)
    assert (got[~valid] == 0).all()


# a power-of-two sigma divides by multiplying with its exact reciprocal,
# any other by the division itself: both must round as torch does
@pytest.mark.parametrize("sigma", [0.5, 2.0, 0.3, 0.7])
def test_soft_nms_kernel_bit_equal_for_any_sigma(cuda, sigma):
    boxes, scores, valid = soft_case(cuda, 2, 3000, 4)
    got = nms.soft_nms_scores_fused(boxes, scores, valid, sigma)
    want = nms.soft_nms_scores(boxes, scores, valid, sigma)
    assert torch.equal(got, want)


def test_soft_nms_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    boxes = torch.zeros((1, 64, 4), device=cuda)
    scores = torch.zeros((1, 64), device=cuda)
    valid = torch.ones((1, 64), dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        nms.soft_nms_scores_fused(boxes.double(), scores, valid)
    with pytest.raises(ValueError, match="float32"):
        nms.soft_nms_scores_fused(boxes[..., :3], scores, valid)
    with pytest.raises(ValueError, match="method"):
        nms.soft_nms_scores_fused(boxes, scores, valid, method="box")
    n = nms._soft_lib().soft_nms_max_n() + 1
    with pytest.raises(ValueError, match="exceeds"):
        nms.soft_nms_scores_fused(torch.zeros((1, n, 4), device=cuda),
                                  torch.zeros((1, n), device=cuda),
                                  torch.ones((1, n), dtype=torch.bool,
                                             device=cuda))


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


# every K4 edge case of cvpce_tpu_torch.testing, each output type, bit for
# bit: the accumulators are exact int32 sums, and the epilogue rounds as
# the plain version does
@pytest.mark.parametrize("case", testing.POOL_EDGE_CASES)
def test_pool_int8_conv_kernel_bit_equal_on_edge_cases(cuda, case):
    x, kq, a_scale, scale, bias = testing.pool_case(
        case, np.random.default_rng(17))
    x = torch.from_numpy(x).to(cuda, torch.bfloat16)
    kq, scale, bias = (torch.from_numpy(a).to(cuda) for a in (kq, scale,
                                                             bias))
    for out_dtype, relu in ((torch.int32, False), (torch.float32, False),
                            (torch.float32, True), (torch.bfloat16, False),
                            (torch.bfloat16, True)):
        kernels = conv_fused.kernels_launched()
        got = conv_fused.fused_pool_int8_conv(x, kq, a_scale, scale, bias,
                                              relu, out_dtype)
        assert conv_fused.kernels_launched() - kernels == 1
        want = conv_fused.pool_int8_conv_plain(x, kq, a_scale, scale, bias,
                                               relu, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == want.shape
        assert torch.equal(got, want), (out_dtype, relu)


def test_pool_int8_conv_wrapper_refuses_what_the_tiles_cannot_take(cuda):
    def call(b=1, h=8, w=8, cin=64, cout=64, x=None):
        if x is None:
            x = torch.zeros((b, h, w, cin), dtype=torch.bfloat16,
                            device=cuda)
        kq = torch.zeros((3, 3, cin, cout), dtype=torch.int8, device=cuda)
        return conv_fused.fused_pool_int8_conv(
            x, kq, 0.1, torch.ones(cout, device=cuda),
            torch.zeros(cout, device=cuda))

    with pytest.raises(ValueError, match="multiple of 32"):
        call(cin=48)
    with pytest.raises(ValueError, match="multiple of 32"):
        call(cout=12)
    with pytest.raises(ValueError, match="even"):
        call(h=7)
    wide = 2 * (conv_fused._lib().pool_int8_conv_max_q(256) + 1)
    with pytest.raises(ValueError, match="exceeds"):
        call(h=2, w=wide, cin=256)
    flat = torch.zeros(8 * 8 * 64 + 4, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        call(x=flat[4:].view(1, 8, 8, 64))
    assert call().shape == (1, 4, 4, 64)


def _train_step_inputs(tmp_path):
    """A 64x64 GLN config (tanh), its train config, a seeded
    reference-layout checkpoint loaded through cli/common.py (focal prior
    on the classification bias, as chip_smoke.py trains from) and a
    batch of 2 (an image without a valid gt)."""
    import math

    from cvpce_tpu_torch.cli.common import load_gln_state_dict
    from cvpce_tpu_torch.models.gln import GLNConfig
    from cvpce_tpu_torch.train.gln import GLNTrainConfig

    config = GLNConfig(canvas_h=64, canvas_w=64, tanh=True)
    train_cfg = GLNTrainConfig(match_chunk=256, min_negatives=64,
                               steps_per_epoch=4)
    sd = testing.gln_reference_state_dict(np.random.default_rng(3))
    sd["head.classification_head.cls_logits.bias"].fill_(-math.log(99.0))
    torch.save(sd, tmp_path / "gln.pth")
    state = load_gln_state_dict(str(tmp_path / "gln.pth"), config)
    rng = np.random.default_rng(0)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[..., :2] = rng.uniform(0, 40, (2, 8, 2))
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(8, 24, (2, 8, 2))
    valid = np.zeros((2, 8), bool)
    valid[0, :6] = True
    batch = (rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32), boxes,
             valid, np.array([[64, 64], [48, 56]], np.int32))
    return config, train_cfg, state, batch


def test_train_step_on_card_matches_cpu(cuda, tmp_path):
    """One GLN train step at 64x64, batch 2 (an image without a valid
    gt), on the card and on the CPU from the same seeded reference-layout
    checkpoint (focal prior on the classification bias, as chip_smoke.py
    trains from), within testing.TRAIN_STEP_TOL; the frozen stem and
    FrozenBN stay put."""
    config, train_cfg, state, batch = _train_step_inputs(tmp_path)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # f32 convolutions, as served
    try:
        steps = testing.train_step_on_devices(config, train_cfg, state,
                                              batch)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    diff = testing.train_step_differences(state, steps["cuda"],
                                          steps["cpu"])
    assert diff["frozen_kept"]
    for key, tol in testing.TRAIN_STEP_TOL.items():
        assert diff[key] <= tol, (key, diff)


def test_bf16_train_step_on_card_keeps_f32_master_weights(cuda, tmp_path):
    """The same step in bf16 compute on the card: finite losses, every
    tensor of the state f32 afterwards and every trained one moved off
    the bf16 grid, the frozen stem and FrozenBN put, and the train state
    computing in bf16 (a bf16 heatmap before its f32 cast)."""
    import dataclasses

    from cvpce_tpu_torch.train import gln as gln_train

    config, train_cfg, state, batch = _train_step_inputs(tmp_path)
    config = dataclasses.replace(config, compute_dtype="bfloat16")
    metrics, after = testing.train_step_on_devices(
        config, train_cfg, state, batch, devices=("cuda",))["cuda"]
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    kept = testing.master_weights_kept(state, after)
    assert kept["frozen_kept"] and kept["master_f32"]
    moved = [k for k, v in after.items() if v.is_floating_point()
             and not torch.equal(v, state[k].cpu())]
    assert len(moved) > 100
    seen = []
    model = gln_train.init_train_state(config, train_cfg, state_dict=state,
                                       device="cuda").model
    model.gaussian.subnet_3.register_forward_hook(
        lambda m, i, o: seen.append(o.dtype))
    with torch.no_grad():
        model(torch.from_numpy(batch[0]).cuda())
    assert seen == [torch.bfloat16]


@pytest.mark.parametrize("loop", ["dihe", "gan"])
def test_dihe_and_gan_steps_on_card_match_cpu(cuda, loop):
    """One DIHE three-player step and one GAN pretraining step at 64 px,
    gen_downs 4, batch 2, on the card and on the CPU from the same seeded
    weights, within testing.DIHE_STEP_TOL; each BatchNorm counted the
    statistics updates the JAX step keeps."""
    from cvpce_tpu_torch.train import dihe

    rng = np.random.default_rng(0)
    pos, neg, gen, disc = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32) for _ in range(4))
    cfg = dihe.DIHETrainConfig(gen_downs=4, steps_per_epoch=10)
    state = dihe.init_dihe_state(cfg, seed=3, device="cpu")
    before = {k: getattr(state, k).state_dict()
              for k in testing.DIHE_STAT_UPDATES}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        if loop == "dihe":
            steps = testing.dihe_step_on_devices(
                cfg, before, (pos, neg, gen, disc,
                              np.float32([0.5, 1.0])))
            updates = testing.DIHE_STAT_UPDATES
        else:
            before = {k: before[k] for k in testing.GAN_STAT_UPDATES}
            steps = testing.gan_step_on_devices(
                dihe.GANPretrainConfig(gen_downs=4), before, (gen, disc))
            updates = testing.GAN_STAT_UPDATES
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    diff = testing.dihe_step_differences(before, steps["cuda"],
                                         steps["cpu"], updates)
    assert diff["stat_updates_kept"]
    for key, tol in testing.DIHE_STEP_TOL.items():
        assert diff[key] <= tol, (key, diff)


@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank NCCL process group on a free port, on the card, and its
    mesh; destroyed at the end of the module."""
    import datetime
    import socket

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from cvpce_tpu_torch.parallel import data_parallel_mesh
    from cvpce_tpu_torch.parallel.multihost import initialize_multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    initialize_multihost(f"tcp://127.0.0.1:{port}", 1, 0, local_rank=0,
                         timeout=datetime.timedelta(seconds=120))
    yield data_parallel_mesh()
    torch.distributed.destroy_process_group()


@pytest.mark.parametrize("k", [1, 8])
def test_sharded_search_takes_k2_on_a_shorter_valid_prefix(nccl_mesh, k):
    """A block of 5000 rows whose last 500 are invalid: the search runs
    K2 on the 4500-row prefix (kernel tail masking inside its last
    tile), equal to the masked plain search over the whole block; the
    block's norms are taken once for two searches."""
    from cvpce_tpu_torch.ops import knn_sharded

    cuda = nccl_mesh.device
    gen = torch.Generator(device=cuda).manual_seed(k)
    block = torch.randn((5000, 1024), device=cuda, generator=gen)
    valid = torch.arange(5000, device=cuda) < 4500
    block[4500:] = block[:500]  # invalid copies of valid rows never win
    search = knn_sharded.make_sharded_nn(nccl_mesh, k)
    for seed in (0, 1):
        q = torch.randn((67, 1024), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(
                            seed))
        before = knn.nearest_neighbors_fused.launches
        kernels = knn.kernels_launched()
        d, i = search(block, valid, q)
        assert knn.nearest_neighbors_fused.launches == before + 1
        # scan and merge, plus the norm pass on the first search only
        assert knn.kernels_launched() - kernels == (3 if seed == 0 else 2)
        pd, pi = knn.knn_masked(block, valid, q, k)
        assert torch.equal(i, pi)
        assert (d - pd).abs().max() <= 1e-5
        assert (i < 4500).all()


def test_global_batchnorm_at_world_size_one_matches_plain(nccl_mesh):
    """batch_moments through the NCCL all-reduce (forward and backward) at
    world size 1 against the local moments; and a BatchNorm inside
    batch_sharded(mesh) of one rank is plain train mode, bit for bit."""
    from cvpce_tpu_torch.models.resnet import BatchNorm, batch_moments
    from cvpce_tpu_torch.parallel.mesh import batch_sharded

    cuda = nccl_mesh.device
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 64, 17, 23), device=cuda, generator=gen) * 3 + 1
    g_mean, g_var = (torch.randn(64, device=cuda, generator=gen)
                     for _ in range(2))
    grads = []
    for mesh in (None, nccl_mesh):
        xi = x.clone().requires_grad_(True)
        mean, var = batch_moments(xi, mesh)
        ((mean * g_mean).sum() + (var * g_var).sum()).backward()
        grads.append((mean.detach(), var.detach(), xi.grad))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)

    outs = []
    for sharded in (False, True):
        bn = BatchNorm(64).to(cuda).train()
        xi = x.clone().requires_grad_(True)
        if sharded:
            with batch_sharded(nccl_mesh):
                y = bn(xi)
        else:
            y = bn(xi)
        y.square().sum().backward()
        outs.append((y.detach(), xi.grad, bn.running_mean, bn.running_var))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_spatial_infer_at_world_size_one_is_the_one_process_forward(
        nccl_mesh):
    """make_spatial_infer over the one-rank NCCL group (no halo, one
    gather of the whole width) on a seeded GLN whose classification
    prior is lifted to 0.5, so detections survive: detections, heatmap
    and make_spatial_forward's outputs bit for bit the one-process
    forward and postprocess; K1 launched once a call."""
    from cvpce_tpu_torch.models.gln import (GLN, GLNConfig,
                                            postprocess_detections)
    from cvpce_tpu_torch.parallel import (make_spatial_forward,
                                          make_spatial_infer)

    cuda = nccl_mesh.device
    cfg = GLNConfig(canvas_h=256, canvas_w=384, max_nms_candidates=1024,
                    detections_per_img=300)
    model = GLN(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.cls_logits.bias.zero_()
    model.to(cuda)
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, 256, 384, 3)).astype(np.float32)
    sizes = np.array([[256, 384], [200, 300]], np.float32)
    run = make_spatial_infer(model, cfg, nccl_mesh)
    before = nms.nms_keep_sorted.launches
    got = run(images, sizes)
    assert nms.nms_keep_sorted.launches == before + 1
    outputs = make_spatial_forward(model, cfg, nccl_mesh)(images)
    anchors, counts = cfg.anchors()
    with torch.inference_mode():
        whole = model(torch.from_numpy(images).to(cuda))
        want = postprocess_detections(
            whole, torch.from_numpy(anchors).to(cuda), counts,
            torch.from_numpy(sizes).to(cuda), cfg)
    assert got["valid"].any()
    for have, ref in ((got, want), (outputs, whole)):
        assert have.keys() == ref.keys()
        for key in ref:
            assert torch.equal(have[key], ref[key]), key


def _flood_reference(grad, seed, tol):
    """A breadth-first flood over 4-neighbours whose f32 difference lies
    within tol (the rule cv2's scan-line fill follows), in plain Python."""
    h, w = grad.shape
    t = np.float32(tol)
    mask = np.zeros((h, w), bool)
    mask[seed] = True
    todo = [seed]
    while todo:
        y, x = todo.pop()
        for v, u in ((y - 1, x), (y + 1, x), (y, x - 1), (y, x + 1)):
            if 0 <= v < h and 0 <= u < w and not mask[v, u] and \
                    abs(grad[v, u] - grad[y, x]) <= t:
                mask[v, u] = True
                todo.append((v, u))
    return mask


def test_png_decoder_and_mask_on_the_card_machine(cuda, tmp_path):
    """The decoder (csrc/png_unfilter.cpp built here) gives back what
    write_png wrote, for every filter, colour type and palette depth;
    the white-background mask's flood fill is the breadth-first one."""
    from cvpce_tpu_torch.data import png
    from cvpce_tpu_torch.data import transforms as T

    rng = np.random.default_rng(11)
    for c in (1, 2, 3, 4):
        for filt in testing.PNG_FILTERS:
            arr = rng.integers(0, 256, (9, 17, c), dtype=np.uint8)
            path = tmp_path / f"{c}_{filt}.png"
            testing.write_png(path, arr, filters=filt)
            np.testing.assert_array_equal(png.read_png(path).samples, arr)
    for depth in (1, 2, 4, 8):
        pal = rng.integers(0, 256, (1 << depth, 3), dtype=np.uint8)
        idx = rng.integers(0, 1 << depth, (7, 13)).astype(np.uint8)
        testing.write_png(tmp_path / "p.png", idx, palette=pal,
                          bit_depth=depth)
        np.testing.assert_array_equal(
            T.load_image(tmp_path / "p.png"),
            pal[idx].astype(np.float32) / 255.0)
    img = np.ones((40, 50, 3), np.float32)
    img[8:30, 10:40] = rng.uniform(0, 0.8, (22, 30, 3))
    mask = T.build_white_background_mask(img)
    gray = img[..., 0] * 0.2989 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    grad = np.sqrt((T.sobel3(gray, 1) / 8.0) ** 2
                   + (T.sobel3(gray, 0) / 8.0) ** 2)
    np.testing.assert_array_equal(mask, _flood_reference(grad, (0, 0), 1e-2))
    assert mask[0, 0] and not mask[20, 25]


def test_sku110k_canvas_on_the_card_matches_cpu(cuda, tmp_path):
    """SKU110KDataset(device="cuda") resizes on the card: the canvas is
    the CPU's within the resize bound (5e-5, / 0.224 normalised)."""
    from cvpce_tpu_torch.data.sku110k import SKU110KDataset

    rng = np.random.default_rng(12)
    rows = []
    for k, (h, w) in enumerate([(300, 400), (410, 230)]):
        testing.write_png(tmp_path / f"s{k}.jpg",
                          rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        rows.append(f"s{k}.jpg,5,6,{w - 9},{h - 7},object,{w},{h}")
    (tmp_path / "ann.csv").write_text("\n".join(rows) + "\n")
    kw = dict(flip_chance=0.5, canvas_h=256, canvas_w=384, seed=1)
    on_card = SKU110KDataset(str(tmp_path), str(tmp_path / "ann.csv"),
                             device=cuda, **kw)
    on_cpu = SKU110KDataset(str(tmp_path), str(tmp_path / "ann.csv"), **kw)
    for i in (0, 1, 1, 0):
        got, want = on_card[i], on_cpu[i]
        assert got["image"].device.type == "cuda"
        torch.testing.assert_close(got["image"].cpu(), want["image"],
                                   atol=5e-5 / 0.224, rtol=0)
        np.testing.assert_array_equal(got["boxes"], want["boxes"])


def test_sku110k_jpeg_canvas_on_the_card_matches_cpu(cuda, tmp_path):
    """JPEG photos (csrc/jpeg_decode.cpp built here; 4:2:0 with a restart
    interval, 4:2:2, grey) through SKU110KDataset(device="cuda"): the
    canvas is the CPU's within the resize bound (5e-5, / 0.224
    normalised), and the decode equals reconstruct_reference."""
    from cvpce_tpu_torch.data import jpeg
    from cvpce_tpu_torch.data.sku110k import SKU110KDataset

    rng = np.random.default_rng(13)
    rows = []
    for k, (h, w, sampling, restart) in enumerate(
            [(300, 400, "4:2:0", 3), (410, 230, "4:2:2", 0),
             (97, 61, "grey", 0)]):
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        path = tmp_path / f"s{k}.jpg"
        wrote = testing.write_jpeg(
            path, arr[..., 0] if sampling == "grey" else arr,
            sampling="4:2:0" if sampling == "grey" else sampling,
            restart_interval=restart)
        coefs = jpeg.decode_coefficients(path.read_bytes())
        for a, b in zip(wrote, coefs.coefficients):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            jpeg.read_jpeg(path).samples, jpeg.reconstruct_reference(
                coefs.coefficients, coefs.tables, coefs.sampling,
                coefs.size))
        rows.append(f"s{k}.jpg,5,6,{w - 9},{h - 7},object,{w},{h}")
    (tmp_path / "ann.csv").write_text("\n".join(rows) + "\n")
    kw = dict(flip_chance=0.5, canvas_h=256, canvas_w=384, seed=2)
    on_card = SKU110KDataset(str(tmp_path), str(tmp_path / "ann.csv"),
                             device=cuda, **kw)
    on_cpu = SKU110KDataset(str(tmp_path), str(tmp_path / "ann.csv"), **kw)
    for i in (0, 1, 2, 1, 0):
        got, want = on_card[i], on_cpu[i]
        assert got["image"].device.type == "cuda"
        torch.testing.assert_close(got["image"].cpu(), want["image"],
                                   atol=5e-5 / 0.224, rtol=0)
        np.testing.assert_array_equal(got["boxes"], want["boxes"])
