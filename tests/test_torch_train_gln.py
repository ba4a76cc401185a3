"""GLN training in the port against the JAX package: one SGD step of a
64x64 GLN from the same variables (losses, every updated parameter, the
Gaussian branch's batch statistics), the freeze mask, the LR schedule
across epoch boundaries with momentum and weight decay, make_multi_step,
and the whole loop (train_proposal_generator, 3 steps and an epoch eval
from the same reference-layout checkpoint); then the port's resume, bit
for bit, from an epoch boundary and from an interval checkpoint.

Tolerances: losses within 1e-5 relative; each updated parameter within
1e-2 of its update's largest magnitude plus 1e-8 (torch's and XLA's f32
convolution gradients in another order; the largest seen is 0.2% on the
head towers, and the convolution biases in front of a BatchNorm, whose
true gradient is 0, move by 1e-9 noise in both); statistics within 1e-5;
the loops' loss series within 1e-5 relative and the keeper's AP equal."""
import itertools
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.train import gln as jtrain
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.data.loader import PrefetchLoader
from cvpce_tpu_torch.data.sku110k import collate_detection
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.train import gln as ptrain
from cvpce_tpu_torch.train import loops
from cvpce_tpu_torch.utils.weights import gln_state_dict

H = W = 64
TRAIN_KW = dict(match_chunk=256, min_negatives=64, steps_per_epoch=4)
# the loops' small detector (the JAX package's loop tests use it)
LOOP_CFG = dict(canvas_h=H, canvas_w=W, max_nms_candidates=128,
                detections_per_img=64)
LOOP_TRAIN = dict(match_chunk=1024, min_negatives=64)


def step_batch():
    """Batch 2: image 0 with 6 valid boxes of 8 (one larger than the
    canvas' half), image 1 with none and a smaller content size."""
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[..., :2] = rng.uniform(0, 40, (2, 8, 2))
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(8, 24, (2, 8, 2))
    boxes[0, 0] = [2, 3, 61, 60]
    valid = np.zeros((2, 8), bool)
    valid[0, :6] = True
    sizes = np.array([[64, 64], [48, 56]], np.int32)
    return images, boxes, valid, sizes


@pytest.fixture(scope="module")
def jax_step():
    """JAX's jitted make_train_step, one step from a PRNGKey(0) init."""
    cfg = JGLNConfig(canvas_h=H, canvas_w=W, tanh=True)
    tcfg = jtrain.GLNTrainConfig(**TRAIN_KW)
    state, opt = jtrain.init_train_state(cfg, tcfg, jax.random.PRNGKey(0))
    step = jax.jit(jtrain.make_train_step(cfg, tcfg, cfg.anchors()[0], opt))
    new, metrics = step(state, *step_batch())

    def variables(s):
        return jax.device_get({"params": s.params, "frozen": s.frozen,
                               "batch_stats": s.batch_stats})
    return (variables(state), variables(new),
            {k: float(v) for k, v in metrics.items()}, state.params)


def port_state(sd, **kw):
    cfg = GLNConfig(canvas_h=H, canvas_w=W, tanh=True)
    tcfg = ptrain.GLNTrainConfig(**{**TRAIN_KW, **kw})
    state = ptrain.init_train_state(cfg, tcfg, state_dict=sd, device="cpu")
    step = ptrain.make_train_step(cfg, tcfg, cfg.anchors()[0])
    return state, step


def test_train_step_matches_jax(jax_step):
    before, after, want_metrics, _ = jax_step
    sd = gln_state_dict(before)
    state, step = port_state(sd)
    state, metrics = step(state, *step_batch())
    assert state.step == 1
    for key, want in want_metrics.items():
        assert metrics[key].item() == pytest.approx(want, rel=1e-5), key

    want = gln_state_dict(after)
    got = state.model.state_dict()
    assert set(got) == set(want)
    n_moved = 0
    for key, w in want.items():
        g, old = got[key], sd[key]
        if key.endswith("num_batches_tracked"):
            continue
        trained_conv = ".conv" in key or "downsample_conv" in key
        if key.startswith("body.conv1.") or (key.startswith("body.")
                                             and not trained_conv):
            # the frozen stem and every FrozenBN buffer: unchanged
            assert torch.equal(g, old), key
            assert torch.equal(w, old), key
            continue
        update = (w - old).abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= 1e-2 * update + 1e-8, (key, err, update)
        n_moved += update > 0
    assert n_moved > 100
    for name in ("block1_bn", "block2_bn"):
        for leaf in ("running_mean", "running_var"):
            key = f"gaussian.{name}.{leaf}"
            np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                       rtol=0, atol=1e-5)
            assert not torch.equal(got[key], sd[key])


def test_gradients_finite_on_image_without_gt(jax_step):
    state, _ = port_state(gln_state_dict(jax_step[0]))
    cfg, tcfg = GLNConfig(canvas_h=H, canvas_w=W, tanh=True), \
        ptrain.GLNTrainConfig(**TRAIN_KW)
    images, boxes, valid, sizes = (torch.from_numpy(a[1:])
                                   for a in step_batch())
    heat = ptrain.render_heatmap_targets(boxes, valid, sizes, cfg, tcfg)
    assert (heat == -1.0).all()
    state.model.train()
    out = state.model(images)
    losses = ptrain.compute_losses(
        out, torch.from_numpy(cfg.anchors()[0]), boxes, valid,
        heat[..., None], cfg, tcfg)
    assert losses["bbox_regression"].item() == 0.0
    assert losses["classification"].item() > 0.0
    sum(losses.values()).backward()
    grads = [p.grad for p in state.model.parameters() if p.requires_grad]
    assert len(grads) > 100
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("trainable_layers", [0, 3, 4, 5])
def test_freeze_mask_matches_jax(jax_step, trainable_layers):
    params = jax_step[3]
    mask = jtrain._freeze_mask(params, trainable_layers)
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias"}
    want = {".".join([getattr(k, "key") for k in path[:-1]]
                     + [leaf[path[-1].key]]): bool(m)
            for path, m in jax.tree_util.tree_leaves_with_path(mask)}
    state, _ = port_state(gln_state_dict(jax_step[0]),
                          trainable_layers=trainable_layers)
    assert ptrain._freeze_mask(state.model, trainable_layers) == want
    trained = {id(p) for g in state.optimizer.param_groups
               for p in g["params"]}
    for name, p in state.model.named_parameters():
        assert (id(p) in trained) == want[name] == p.requires_grad, name


class _Leaf(torch.nn.Module):
    def __init__(self, value):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.from_numpy(value.copy()))


def test_sgd_schedule_matches_optax_across_epochs():
    """Momentum, weight decay, the frozen stem and the per-epoch LR decay
    over 7 steps of 3 an epoch, against the optax chain on the same
    gradients."""
    rng = np.random.default_rng(1)
    shapes = {"body/conv1": (3, 2), "body/layer1_0": (4,), "head": (5, 2)}
    values = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    cfg = dict(lr=0.1, lr_multiplier=0.5, steps_per_epoch=3)
    jparams = {"body": {"conv1": {"kernel": values["body/conv1"]},
                        "layer1_0": {"kernel": values["body/layer1_0"]}},
               "head": {"kernel": values["head"]}}
    jcfg = jtrain.GLNTrainConfig(**cfg)
    opt = jtrain.make_optimizer(jcfg, jparams)
    jstate = opt.init(jparams)

    module = torch.nn.Module()
    module.body = torch.nn.Module()
    module.body.conv1 = _Leaf(values["body/conv1"])
    module.body.layer1_0 = _Leaf(values["body/layer1_0"])
    module.head = _Leaf(values["head"])
    pcfg = ptrain.GLNTrainConfig(**cfg)
    popt = ptrain.make_optimizer(pcfg, module)
    assert not module.body.conv1.weight.requires_grad

    import optax
    for step in range(7):
        grads = {k: rng.normal(size=s).astype(np.float32)
                 for k, s in shapes.items()}
        jgrads = {"body": {"conv1": {"kernel": grads["body/conv1"]},
                           "layer1_0": {"kernel": grads["body/layer1_0"]}},
                  "head": {"kernel": grads["head"]}}
        updates, jstate = opt.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        module.body.layer1_0.weight.grad = torch.from_numpy(
            grads["body/layer1_0"])
        module.head.weight.grad = torch.from_numpy(grads["head"])
        assert ptrain.learning_rate(pcfg, step) == pytest.approx(
            0.1 * 0.5 ** (step // 3), rel=1e-12)
        ptrain.apply_gradients(popt, pcfg, step)
        for name, leaf in (("layer1_0", module.body.layer1_0),
                           ("conv1", module.body.conv1)):
            np.testing.assert_allclose(
                leaf.weight.detach().numpy(),
                np.asarray(jparams["body"][name]["kernel"]),
                rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(module.head.weight.detach().numpy(),
                                   np.asarray(jparams["head"]["kernel"]),
                                   rtol=1e-6, atol=1e-7)
    assert torch.equal(module.body.conv1.weight,
                       torch.from_numpy(values["body/conv1"]))


@pytest.fixture(scope="module")
def one_thread():
    """Bit-for-bit comparisons between runs take one CPU thread: with
    several, the reductions' partial sums can split differently from one
    run to the next on a loaded machine (seen as 1e-13 differences in
    parameters whose gradient is noise)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_multi_step_equals_single_steps(jax_step, one_thread):
    sd = gln_state_dict(jax_step[0])
    images, boxes, valid, sizes = step_batch()
    k = 3
    stacked = [np.stack([a[::-1] if s % 2 else a for s in range(k)])
               for a in (images, boxes, valid, sizes)]
    single, step = port_state(sd)
    seq = []
    for s in range(k):
        single, m = step(single, *(a[s] for a in stacked))
        seq.append(m)
    multi, _ = port_state(sd)
    multi, metrics = ptrain.make_multi_step(step)(multi, *stacked)
    assert multi.step == single.step == k
    for key in seq[0]:
        assert metrics[key].shape == (k,)
        assert torch.equal(metrics[key], torch.stack([m[key] for m in seq]))
    for key, v in single.model.state_dict().items():
        assert torch.equal(multi.model.state_dict()[key], v), key


# ------------------------------------------------------------ the loop

class DetectionSet:
    """3 items shaped like SKU110KDataset's, 2-4 small boxes and one
    large one each, so a random detector's epoch eval finds some."""

    def __init__(self, n=3, canvas=H):
        rng = np.random.default_rng(0)
        self.items = []
        for _ in range(n):
            img = rng.uniform(0, 1, (canvas, canvas, 3)).astype(np.float32)
            nb = int(rng.integers(2, 5))
            xy = rng.uniform(0, canvas - 20, (nb, 2)).astype(np.float32)
            wh = rng.uniform(8, 18, (nb, 2)).astype(np.float32)
            boxes = np.concatenate([np.concatenate([xy, xy + wh], -1),
                                    np.float32([[2, 3, 61, 60]])])
            self.items.append({
                "image": img, "boxes": boxes,
                "image_size": np.array([canvas, canvas], np.int32),
                "scale": np.float32(1.0), "orig_boxes": boxes})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture
def run_dir(tmp_path):
    """A directory for a run's checkpoints (a 64x64 GLN's are still
    ResNet-50 sized, 0.3 GB each with the momentum), removed after the
    test."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def reference_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "gln_reference.pth")
    torch.save({"model_state_dict": testing.gln_reference_state_dict(
        np.random.default_rng(5))}, path)
    return path


def test_training_loop_matches_jax(run_dir, reference_checkpoint):
    """train_proposal_generator in both packages: 1 epoch of 3 steps at
    batch 1, an epoch eval at IoU 0.5, from the same checkpoint."""
    from cvpce_tpu.train.loops import train_proposal_generator as jloop

    data = DetectionSet()
    common = dict(batch_size=1, epochs=1, checkpoint_interval=2,
                  eval_interval=1, eval_threshold=0.5, use_mesh=False,
                  load_torch=reference_checkpoint)
    jout, pout = str(run_dir / "jax"), str(run_dir / "port")
    want = jloop(data, data, jout, model_cfg=JGLNConfig(**LOOP_CFG),
                 train_cfg=jtrain.GLNTrainConfig(**LOOP_TRAIN), **common)
    got = loops.train_proposal_generator(
        data, data, pout, model_cfg=GLNConfig(**LOOP_CFG),
        train_cfg=ptrain.GLNTrainConfig(**LOOP_TRAIN), device="cpu",
        **common)
    assert got["state"].step == int(want["state"].step) == 3
    assert got["best"] == want["best"] and got["best"]["ap"] > 0
    with open(os.path.join(jout, "stats_0.json")) as f:
        jstats = json.load(f)
    with open(os.path.join(pout, "stats_0.json")) as f:
        pstats = json.load(f)
    for key in ("class_loss", "reg_loss", "gauss_loss"):
        np.testing.assert_allclose(pstats[key], jstats[key], rtol=1e-5)
    for name in ("checkpoint", "epoch_0"):
        with open(os.path.join(jout, name + ".meta.json")) as f:
            jmeta = json.load(f)
        with open(os.path.join(pout, name + ".meta.json")) as f:
            assert json.load(f) == jmeta
    # both loops draw the same sample pictures (utils/viz.py)
    assert set(os.listdir(pout)) == set(os.listdir(jout))
    assert {f for f in os.listdir(pout) if f.endswith(".png")} == {
        "00000_gt_05.png", "00000_gaussians.png", "00002_gt_05.png",
        "00002_gaussians.png"}


class ResumableLoader(PrefetchLoader):
    """PrefetchLoader with `iter_from`: a resumed run continues inside
    the epoch (the batch order is a function of (seed, epoch))."""

    def iter_from(self, skip):
        return itertools.islice(iter(self), skip, None)


class Interrupt(Exception):
    pass


class InterruptedLoader(ResumableLoader):
    """Stops the run as it asks for epoch 1's third batch."""

    def __iter__(self):
        for i, batch in enumerate(super().__iter__()):
            if self.epoch == 1 and i == 2:
                raise Interrupt
            yield batch


def _run(out, loader_cls=PrefetchLoader, **kw):
    args = dict(batch_size=1, epochs=2, checkpoint_interval=100,
                eval_interval=5, eval_threshold=0.5, use_mesh=False,
                seed=3, device="cpu", loader_cls=loader_cls)
    args.update(kw)
    return loops.train_proposal_generator(
        DetectionSet(), DetectionSet(n=2), str(out),
        model_cfg=GLNConfig(**LOOP_CFG),
        train_cfg=ptrain.GLNTrainConfig(**LOOP_TRAIN), **args)


def _assert_same_state(a, b):
    assert a.step == b.step
    for key, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[key], v), key
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert len(sa["state"]) == len(sb["state"]) > 100
    for i, s in sa["state"].items():
        assert torch.equal(sb["state"][i]["momentum_buffer"],
                           s["momentum_buffer"]), i


def _losses(out, epoch):
    with open(os.path.join(out, f"stats_{epoch}.json")) as f:
        stats = json.load(f)
    return [stats[k] for k in ("class_loss", "reg_loss", "gauss_loss")]


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory, one_thread):
    """2 epochs of 3 steps in one go, checkpoints every 2 steps: the
    final state and epoch 1's losses."""
    out = tmp_path_factory.mktemp("uninterrupted")
    state = _run(out, checkpoint_interval=2)["state"]
    losses = _losses(out, 1)
    shutil.rmtree(out, ignore_errors=True)
    return state, losses


def test_resume_from_epoch_boundary_bit_identical(run_dir, uninterrupted):
    want, losses = uninterrupted
    first = _run(run_dir, epochs=1)
    assert first["state"].step == 3
    resumed = _run(run_dir, epochs=1, resume=True)
    _assert_same_state(want, resumed["state"])
    assert [s[3:] for s in losses] == _losses(run_dir, 1)
    # the momentum buffers came back from the checkpoint, not fresh: an
    # orbax node in the JAX package's GLNTrainState layout
    from cvpce_tpu_torch.utils import orbax_read
    tree = orbax_read.restore(os.path.join(run_dir, "checkpoint"))
    trace = tree["opt_state"][0]["inner_state"][1][0]["trace"]

    def arrays(t):
        return (sum(arrays(v) for v in t.values()) if isinstance(t, dict)
                else int(t is not None))
    assert int(tree["step"]) == 6 and arrays(trace) > 100


def test_resume_from_interval_checkpoint_bit_identical(run_dir,
                                                       uninterrupted):
    """Interrupted after the interval save at iteration 4 (epoch 1,
    batch 1); a loader with iter_from resumes on epoch 1's batch 2."""
    want, losses = uninterrupted
    with pytest.raises(Interrupt):
        _run(run_dir, InterruptedLoader, checkpoint_interval=2)
    with open(os.path.join(run_dir, "checkpoint.meta.json")) as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["iteration"], meta["epoch_step"]) == (1, 4, 1)
    resumed = _run(run_dir, ResumableLoader, epochs=1, resume=True,
                   checkpoint_interval=2)
    _assert_same_state(want, resumed["state"])
    assert [s[5:] for s in losses] == _losses(run_dir, 1)


def test_loop_steps_per_call_and_reports(run_dir, uninterrupted):
    """steps_per_call=2 (chunks of 2 and 1 in 3-step epochs) trains as
    single steps do, and hyperopt_report gets every epoch eval."""
    want, losses = uninterrupted
    reports = []
    got = _run(run_dir, checkpoint_interval=2, steps_per_call=2,
               eval_interval=1, hyperopt_report=lambda **kw: reports.append(
                   kw))
    _assert_same_state(want, got["state"])
    assert _losses(run_dir, 1) == losses
    assert len(reports) == 2
    assert {"average_precision", "ap", "ar_300", "f"} <= set(reports[0])


def test_loop_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="orbax"):
        _run(tmp_path, load_orbax=str(tmp_path))
    assert not os.listdir(tmp_path)
    # without a process group one process loads everything, however
    # many cards it sees; in one of 2 ranks, half of an even global batch
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert loops._host_sharding(True, 2) == (0, 1, 2)
    monkeypatch.setattr(loops, "host_shard_info", lambda: (1, 2))
    assert loops._host_sharding(True, 4) == (1, 2, 2)
    assert loops._host_sharding(False, 2) == (0, 1, 2)
    with pytest.raises(AssertionError, match="divide over 2 ranks"):
        loops._host_sharding(True, 3)
    # bf16 compute trains (tests/test_torch_train_gln_bf16.py); int8 is
    # a serving path, which JAX's train step cannot apply either
    for int8 in ("static", "calibrate"):
        with pytest.raises(ValueError, match="int8"):
            ptrain.init_train_state(
                GLNConfig(canvas_h=H, canvas_w=W, compute_dtype="bfloat16",
                          int8=int8), ptrain.GLNTrainConfig(), device="cpu")


def test_collate_pads_to_the_box_bucket():
    items = DetectionSet().items
    batch = collate_detection(items)
    assert batch["boxes"].shape == (3, 768, 4)
    assert batch["box_valid"].sum(1).tolist() == [len(i["boxes"])
                                                  for i in items]
    big = dict(items[0], boxes=np.zeros((800, 4), np.float32))
    assert collate_detection([big])["boxes"].shape == (1, 832, 4)
