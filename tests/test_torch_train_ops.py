"""The training slice's ops against the JAX package on the same seeded
numpy inputs: the box helpers, the anchor matcher (exact low-quality
ties, padded gts, an image with no valid gt), the focal and Gaussian
heatmap losses with their gradients, the DIHE losses, every Gaussian
renderer x join, and the BatchNorm train mode (GLN's Gaussian branch and
MACResNet's ResNet50(norm='batch')) against flax's mutated batch_stats.

Tolerances: the matcher's indices, fg and valid are equal; the box
helpers and renderers within 1e-6 of the value range (XLA's exp and log
against torch's, one or two f32 ulps); the losses within 1e-5 relative
(f32 sums in another order); BatchNorm statistics within 1e-5 of the
variance (the old torch update is 2e-4 off at n = 512), 1e-6 of the
mean."""
import jax
import numpy as np
import pytest
import torch

from cvpce_tpu.models.gln import GLN as JGLN
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.models.resnet import ResNet50 as JResNet50
from cvpce_tpu.ops import boxes as jboxes
from cvpce_tpu.ops import gaussians as jgauss
from cvpce_tpu.ops import losses as jlosses
from cvpce_tpu.ops.knn import cosine_distance as j_cosine
from cvpce_tpu.ops.matching import match_anchors as j_match
from cvpce_tpu.train.gln import pad_anchors
from cvpce_tpu_torch.models.gln import GLN, GLNConfig
from cvpce_tpu_torch.models.resnet import ResNet50
from cvpce_tpu_torch.ops import boxes as pboxes
from cvpce_tpu_torch.ops import gaussians as pgauss
from cvpce_tpu_torch.ops import losses as plosses
from cvpce_tpu_torch.ops.knn import cosine_distance as p_cosine
from cvpce_tpu_torch.ops.matching import match_anchors as p_match
from cvpce_tpu_torch.utils.weights import gln_state_dict


def t(x):
    return torch.from_numpy(np.array(x))


def assert_close(got, want, rel=1e-6):
    """|got - want| <= rel * max(1, max|want|) elementwise."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, np.abs(want).max()))


def seeded_boxes(rng, n, lo=0.0, hi=100.0, wmin=2.0, wmax=40.0):
    xy = rng.uniform(lo, hi, (n, 2))
    wh = rng.uniform(wmin, wmax, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ------------------------------------------------------------ box helpers

def test_box_helpers_match_jax():
    rng = np.random.default_rng(0)
    ref = seeded_boxes(rng, 64)
    anchors = seeded_boxes(rng, 64)
    assert_close(pboxes.encode_boxes(t(ref), t(anchors)),
                 jboxes.encode_boxes(ref, anchors))
    assert_close(pboxes.encode_boxes(t(ref), t(anchors), (10., 10., 5., 5.)),
                 jboxes.encode_boxes(ref, anchors, (10., 10., 5., 5.)))
    wide = seeded_boxes(rng, 64, lo=-30.0, hi=120.0)
    assert_close(pboxes.clip_boxes(t(wide), 80, 100),
                 jboxes.clip_boxes(wide, 80, 100))
    assert_close(pboxes.box_centers(t(wide)), jboxes.box_centers(wide))
    cxcywh = jboxes.xyxy_to_cxcywh(wide)
    assert_close(pboxes.cxcywh_to_xyxy(t(cxcywh)),
                 jboxes.cxcywh_to_xyxy(cxcywh))
    # encode -> decode round trip
    deltas = pboxes.encode_boxes(t(ref), t(anchors))
    assert_close(pboxes.decode_boxes(deltas, t(anchors)), ref, rel=1e-5)


# ------------------------------------------------------------ matcher

def _match_case():
    """Level-3-5 anchors of a 128x192 canvas, and 3 images of 12 padded
    gts: image 0 has large boxes (IoU >= 0.5 matches), a 10x10 box that
    several same-shape anchors contain (an exact low-quality tie at IoU
    100/1024) and a box centred between two anchors (tied IoU); image 1
    random boxes with padding rows that hold real coordinates; image 2
    no valid gt."""
    anchors, _ = JGLNConfig(canvas_h=128, canvas_w=192).anchors()
    rng = np.random.default_rng(7)
    gts = np.zeros((3, 12, 4), np.float32)
    valid = np.zeros((3, 12), bool)
    gts[0, :5] = [[100, 60, 110, 70], [36, 20, 68, 52], [2, 2, 60, 40],
                  [120, 80, 180, 126], [44, 40, 76, 72]]
    valid[0, :5] = True
    gts[1] = seeded_boxes(rng, 12, hi=150.0, wmin=6.0, wmax=60.0)
    valid[1, :7] = True
    gts[2] = seeded_boxes(rng, 12, hi=150.0)
    return anchors.astype(np.float32), gts, valid


@pytest.mark.parametrize("chunk", [1000, 4096])
def test_match_anchors_matches_jax(chunk):
    anchors, gts, valid = _match_case()
    got = p_match(t(anchors), t(gts), t(valid), chunk=chunk)
    padded, a = pad_anchors(anchors, 512)
    for i in range(len(gts)):
        want = [np.asarray(x)[:a] for x in
                j_match(padded, gts[i], valid[i], chunk=512)]
        single = p_match(t(anchors), t(gts[i]), t(valid[i]), chunk=chunk)
        for g, s, w in zip(got, single, want):
            np.testing.assert_array_equal(g[i].numpy(), w)
            np.testing.assert_array_equal(s.numpy(), w)
    _, fg, ok = (x.numpy() for x in got)
    # the 10x10 box: every anchor at its best IoU is foreground
    ious = pboxes.pairwise_iou(t(anchors), t(gts[0, :1]))[:, 0].numpy()
    ties = ious == ious.max()
    assert ties.sum() > 1 and ious.max() < 0.4
    assert fg[0][ties].all()
    assert not fg[2].any() and ok[2].all()
    assert fg[0].sum() > 5 and (~ok[0]).any()


def test_match_anchors_without_low_quality():
    anchors, gts, valid = _match_case()
    padded, a = pad_anchors(anchors, 512)
    got = p_match(t(anchors), t(gts[0]), t(valid[0]), chunk=1000,
                  allow_low_quality=False)
    want = j_match(padded, gts[0], valid[0], chunk=512,
                   allow_low_quality=False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w)[:a])


# ------------------------------------------------------------ losses

def test_focal_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(4, 300, 1)) * 4).astype(np.float32)
    logits[0, :3, 0] = [0.0, 40.0, -40.0]
    targets = (rng.uniform(size=(4, 300, 1)) > 0.8).astype(np.float32)
    want = jlosses.sigmoid_focal_loss(logits, targets)
    want_g = jax.grad(lambda x: jlosses.sigmoid_focal_loss(
        x, targets).sum())(logits)
    x = t(logits).requires_grad_()
    got = plosses.sigmoid_focal_loss(x, t(targets))
    got.sum().backward()
    assert_close(got, want, rel=1e-6)
    assert_close(x.grad, want_g, rel=1e-6)


def _heatmap_case(case):
    """(pred, target, kwargs): 'mined' positives and more negatives than
    the top-k; 'n_top_gt_neg' min_negatives past the negatives there
    are; 'no_pos' no positive pixel; 'tanh' tanh-range targets."""
    rng = np.random.default_rng(3)
    shape = (2, 16, 24, 1)
    tgt = rng.uniform(0, 1, shape).astype(np.float32)
    tgt[tgt < 0.7] = 0.0
    pred = rng.uniform(0, 1, shape).astype(np.float32)
    kw = dict(min_negatives=50, negatives_per_positive=3)
    if case == "n_top_gt_neg":
        kw["min_negatives"] = 100_000
    elif case == "no_pos":
        tgt = np.zeros(shape, np.float32)
    elif case == "tanh":
        tgt = tgt * 2 - 1
        pred = np.tanh(rng.normal(size=shape)).astype(np.float32)
        kw.update(tanh=True, negative_threshold=-1.0, positive_threshold=0.3)
    return pred, tgt, kw


@pytest.mark.parametrize("case", ["mined", "n_top_gt_neg", "no_pos", "tanh"])
def test_gaussian_heatmap_loss_matches_jax(case):
    pred, tgt, kw = _heatmap_case(case)
    want, want_g = jax.value_and_grad(
        lambda p: jlosses.gaussian_heatmap_loss(p, tgt, **kw))(pred)
    x = t(pred).requires_grad_()
    got = plosses.gaussian_heatmap_loss(x, t(tgt), **kw)
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=1e-5)
    assert_close(x.grad, want_g, rel=1e-5)


def test_dihe_losses_match_jax():
    rng = np.random.default_rng(4)
    a, p, n = (rng.normal(size=(6, 32)).astype(np.float32)
               for _ in range(3))
    sim = rng.uniform(0, 1, 6).astype(np.float32)
    assert_close(p_cosine(t(a), t(p), axis=1), j_cosine(a, p, axis=1))
    got = plosses.hierarchical_triplet_loss(t(a), t(p), t(n), t(sim))
    assert got.item() == pytest.approx(
        float(jlosses.hierarchical_triplet_loss(a, p, n, sim)), rel=1e-5)
    x = rng.uniform(size=(3, 8, 10, 3)).astype(np.float32)
    y = (x + 0.3 * rng.uniform(size=x.shape)).astype(np.float32)
    mask = (rng.uniform(size=(3, 8, 10)) > 0.4).astype(np.float32)
    assert plosses.zncc(t(x), t(y)).item() == pytest.approx(
        float(jlosses.zncc(x, y)), rel=1e-5)
    for m in (mask, mask[..., None]):
        assert plosses.masked_zncc(t(x), t(y), t(m)).item() == \
            pytest.approx(float(jlosses.masked_zncc(x, y, m)), rel=1e-5)


# ------------------------------------------------------------ renderers

def _render_boxes(n):
    """n boxes in a 48x64 frame (some past its edges, one degenerate),
    a tenth of them invalid."""
    rng = np.random.default_rng(n)
    boxes = seeded_boxes(rng, n, lo=-8.0, hi=56.0, wmin=1.0, wmax=24.0)
    boxes[0] = [10, 10, 10, 22]  # zero width
    valid = rng.uniform(size=n) > 0.1
    return boxes, valid


@pytest.mark.parametrize("method", ["mvn", "kant", "simple"])
@pytest.mark.parametrize("join", ["max", "add", "replace"])
@pytest.mark.parametrize("n", [9, 70])
def test_render_gaussians_matches_jax(method, join, n):
    boxes, valid = _render_boxes(n)
    for kw in (dict(tanh=False, size_reduction=1),
               dict(tanh=True, size_reduction=2)):
        want = jgauss.render_gaussians(boxes, valid, height=48, width=64,
                                       method=method, join=join, **kw)
        got = pgauss.render_gaussians(t(boxes), t(valid), height=48,
                                      width=64, method=method, join=join,
                                      **kw)
        # add sums up to a few dozen boxes a pixel
        assert_close(got, want, rel=1e-6 if join != "add" else 4e-6)


def test_render_gaussians_batch_matches_jax():
    boxes = np.stack([_render_boxes(70)[0], _render_boxes(70)[0][::-1]])
    valid = np.stack([_render_boxes(70)[1], np.zeros(70, bool)])
    kw = dict(height=48, width=64, method="simple", join="max", tanh=True,
              size_reduction=2)
    want = jgauss.render_gaussians_batch(boxes, valid, **kw)
    got = pgauss.render_gaussians_batch(t(boxes), t(valid), **kw)
    assert_close(got, want)
    assert (got[1] == -1.0).all()


# ------------------------------------------------------------ BatchNorm

BN_H = BN_W = 64


@pytest.fixture(scope="module")
def gln_train_forward():
    """JAX GLN(train=True) at 64x64, one forward at batch 2 with its
    mutated batch_stats, and the variables it started from."""
    model = JGLN(config=JGLNConfig(canvas_h=BN_H, canvas_w=BN_W), train=True)
    x = np.random.default_rng(3).uniform(0, 1, (2, BN_H, BN_W, 3)).astype(
        np.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(1), x[:1]))
    out, mut = jax.jit(lambda v, x: model.apply(
        v, x, mutable=["batch_stats"]))(variables, x)
    return variables, x, jax.device_get(out), jax.device_get(
        mut["batch_stats"])


def test_gln_train_mode_batchnorm_matches_flax(gln_train_forward):
    """The Gaussian branch's running statistics move as flax's do: the
    biased batch variance at momentum 0.9. torch's own BatchNorm2d
    update (unbiased variance) is 2.2e-4 off here, n = 2 * 16 * 16."""
    variables, x, out, stats = gln_train_forward
    model = GLN(GLNConfig(canvas_h=BN_H, canvas_w=BN_W))
    model.load_state_dict(gln_state_dict(variables))
    model.train()
    assert model.gaussian.block1_bn.training
    assert not model.body.training and not model.head.training
    with torch.no_grad():
        got = model(t(x))
    for name in ("block1_bn", "block2_bn"):
        bn = getattr(model.gaussian, name)
        want = stats["gaussian"][name]
        np.testing.assert_allclose(bn.running_var.numpy(), want["var"],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"],
                                   rtol=0, atol=1e-6)
        assert int(bn.num_batches_tracked) == 1
    # the forward normalises with the batch statistics, as flax's
    for key in ("gaussians", "cls_logits", "bbox_regression"):
        assert_close(got[key], out[key], rel=1e-4)
    # eval mode is back to the running statistics, and leaves them
    before = model.gaussian.block1_bn.running_var.clone()
    model.eval()
    with torch.no_grad():
        model(t(x))
    assert torch.equal(model.gaussian.block1_bn.running_var, before)


def test_resnet_batchnorm_train_mode_matches_flax():
    """ResNet50(norm='batch'), MACResNet's trunk, in train mode: the
    c5 features and every mutated statistic against flax's."""
    from cvpce_tpu_torch.utils.weights import macresnet_state_dict

    jm = JResNet50(norm="batch", train=True)
    x = np.random.default_rng(5).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    v = jax.device_get(jm.init(jax.random.PRNGKey(2), x[:1]))
    feats, mut = jax.jit(lambda v, x: jm.apply(
        v, x, mutable=["batch_stats"]))(v, x)
    model = ResNet50(norm="batch")
    sd = {k[len("trunk."):]: w for k, w in macresnet_state_dict(
        {"trunk": v["params"]}, {"trunk": v["batch_stats"]}).items()}
    model.load_state_dict(sd)
    model.train()
    with torch.no_grad():
        got = model(t(x).permute(0, 3, 1, 2))
    # batch statistics over n = 2 * 2 * 2 values a channel at c5 amplify
    # the convolutions' f32 order about 5x a stage: 6e-7 at c1, 2e-5 at
    # c3, 7e-4 at c5
    for key, rel in (("c1", 1e-5), ("c3", 1e-4), ("c5", 2e-3)):
        assert_close(got[key].permute(0, 2, 3, 1), feats[key], rel=rel)
    want = {k[len("trunk."):]: w for k, w in macresnet_state_dict(
        {"trunk": v["params"]},
        {"trunk": jax.device_get(mut["batch_stats"])}).items()}
    state = model.state_dict()
    # the same amplification: up to 9e-5 at c5's norms (torch's own
    # unbiased update would be 8/7 off on the batch term there)
    n = 0
    for key, w in want.items():
        if key.endswith(("running_mean", "running_var")):
            assert_close(state[key], w.numpy(), rel=3e-4)
            n += 1
    assert n == 2 * 53  # 52 bottleneck and downsample norms, the stem's
