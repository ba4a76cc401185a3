"""The port's `pretrain_gan` and `train_dihe` against the JAX package's
loops on 8 gallery items at 64 px (`gen_downs=4`, batch 2), from the
same weights; their resume, bit for bit; the refusals and overlays.

The loops are compared on what the orchestration decides: the batches
and discriminator draws (a function of the seed, epoch and step in both),
the iteration counters and checkpoint metas, the file sets (the GAN
loops' sample pictures included), the final running statistics (within 1e-3
of max(1, |value|)), the final parameters and Adam moments (per player,
L2 relative to the reference's update and first moment, within 1e-1),
and the epoch eval: both packages' `eval_dihe` on the same gallery and
query scenes, top-1 within one of the 8 queries of each other (JAX crops
with its bf16 einsum resampler, the port with the f32 gather; measured:
equal, 0.125). Over several steps the f32 gradients' argmax jumps
(tests/test_torch_train_dihe.py) flip Adam's update at some elements and
the weights drift apart by rounding-level amounts that the next forwards
carry on, so the loops are held in L2; the step tests hold a single step
elementwise."""
import itertools
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from cvpce_tpu.train import dihe as jdihe
from cvpce_tpu.train import loops as jloops
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.data.loader import PrefetchLoader
from cvpce_tpu_torch.train import dihe as pdihe
from cvpce_tpu_torch.train import loops
from cvpce_tpu_torch.utils.torch_import import import_vgg16_features
from cvpce_tpu_torch.utils.weights import gan_state_dict, macvgg_state_dict

S = 64
GEN_DOWNS = 4
N_ITEMS = 8
# measured (largest over the players of both loops): statistics 2.0e-4,
# parameters 3.9e-2, first moments 4.1e-2; the bounds are 5x, 2.5x, 2.5x
STAT_TOL = 1e-3
# L2 of (port - JAX) over the JAX update / first moment, per player
PARAM_L2 = 1e-1
MOMENT_L2 = 1e-1


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs several workers on the CPU's
    cores, where these models' many small parallel regions slowed ten
    times with a thread per core each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


class GallerySet:
    """(emb image, gen image, hierarchy, annotation) in tanh scale."""

    def __init__(self, n=N_ITEMS):
        rng = np.random.default_rng(1)
        self.items = []
        for i in range(n):
            img = rng.uniform(-1, 1, (S, S, 3)).astype(np.float32)
            crop = rng.uniform(-1, 1, (S, S, 3)).astype(np.float32)
            self.items.append((img, crop, ["Food", f"Cat{i % 2}",
                                           f"Sub{i % 4}"], f"p{i}"))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class CropSet:
    """[0, 1] target-domain crops."""

    def __init__(self, n=N_ITEMS):
        self.crops = np.random.default_rng(2).uniform(
            0, 1, (n, S, S, 3)).astype(np.float32)

    def __len__(self):
        return len(self.crops)

    def __getitem__(self, i):
        return self.crops[i]


class QuerySet:
    """Scenes of gallery products side by side, [0, 1], with their
    annotations and boxes: eval_dihe's test set."""

    def __init__(self, gallery, n=2):
        rng = np.random.default_rng(3)
        self.items = []
        for _ in range(n):
            picks = rng.permutation(len(gallery))[:4]
            img = np.concatenate([(gallery[int(j)][0] + 1) / 2
                                  for j in picks], axis=1)
            img = np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1)
            boxes = np.array([[k * S, 0, (k + 1) * S, S]
                              for k in range(4)], np.float32)
            self.items.append((img.astype(np.float32),
                               [gallery[int(j)][3] for j in picks], boxes))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture
def run_dir(tmp_path):
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def one_thread():
    """Bit-for-bit comparisons between runs take one CPU thread
    (tests/test_torch_train_gln.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_init_weights():
    """JAX's PRNGKey(0) DIHE variables at 64 px, gen_downs 4."""
    state, _ = jdihe.init_dihe_state(
        jdihe.DIHETrainConfig(gen_downs=GEN_DOWNS), jax.random.PRNGKey(0),
        image_size=S)
    return jax.device_get(state)


def l2(got, want):
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    num = sum(float((got[k].float() - want[k]).pow(2).sum()) for k in keys)
    return (num / sum(float(want[k].pow(2).sum()) for k in keys)) ** 0.5


def hold_player(before, got_sd, want_sd, got_mu=None, want_mu=None):
    update = {k: want_sd[k] - before[k] for k in want_sd
              if not k.endswith(("num_batches_tracked", "running_mean",
                                 "running_var"))}
    moved = {k: got_sd[k] - before[k] for k in update}
    assert l2(moved, update) <= PARAM_L2
    if want_mu is not None:
        assert l2(got_mu, want_mu) <= MOMENT_L2
    for key, want in want_sd.items():
        if key.endswith(("running_mean", "running_var")):
            err = (got_sd[key] - want).abs().max().item()
            assert err <= STAT_TOL * max(1.0, want.abs().max().item()), key


def adam_mu(opt_state, bridge):
    adam = next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: hasattr(x, "mu")) if hasattr(s, "mu"))
    return bridge(adam.mu)


def port_mu(module, opt):
    return {n: opt.state[p]["exp_avg"] for n, p in module.named_parameters()}


def same_files(jout, pout):
    """The same files (the GAN loops' sample pictures among them) and
    the same checkpoint metas."""
    assert set(os.listdir(pout)) == set(os.listdir(jout))
    for name in os.listdir(pout):
        if name.endswith(".meta.json"):
            with open(os.path.join(jout, name)) as a, \
                    open(os.path.join(pout, name)) as b:
                assert a.read() == b.read(), name


def test_pretrain_gan_matches_jax(run_dir, monkeypatch):
    """2 epochs of 4 steps, rotating checkpoints every 3 steps, from JAX's
    PRNGKey(0) GAN weights (the port's init is handed them)."""
    data, crops = GallerySet(), CropSet()
    cfg = dict(gen_downs=GEN_DOWNS)
    jout, pout = str(run_dir / "jax"), str(run_dir / "port")
    want = jloops.pretrain_gan(data, crops, jout, epochs=2, batch_size=2,
                               checkpoint_interval=3,
                               train_cfg=jdihe.GANPretrainConfig(**cfg))
    want = jax.device_get(want["state"])
    init_w = jax.device_get(jdihe.make_gan_pretrain_step(
        jdihe.GANPretrainConfig(**cfg))[0](jax.random.PRNGKey(0),
                                           image_size=S))
    before = {p: gan_state_dict(init_w[f"{p}_params"], init_w[f"{p}_stats"])
              for p in ("gen", "disc")}
    real = loops.make_gan_pretrain_step

    def from_jax_weights(c):
        init, step = real(c)

        def init_bridged(*args, **kwargs):
            state = init(*args, **kwargs)
            state.generator.load_state_dict(before["gen"])
            state.discriminator.load_state_dict(before["disc"])
            return state
        return init_bridged, step

    monkeypatch.setattr(loops, "make_gan_pretrain_step", from_jax_weights)
    got = loops.pretrain_gan(data, crops, pout, epochs=2, batch_size=2,
                             checkpoint_interval=3, device="cpu",
                             train_cfg=pdihe.GANPretrainConfig(**cfg))["state"]
    same_files(jout, pout)
    for p, module, opt in (("gen", got.generator, got.gen_opt),
                           ("disc", got.discriminator, got.disc_opt)):
        hold_player(before[p], module.state_dict(),
                    gan_state_dict(want[f"{p}_params"], want[f"{p}_stats"]),
                    port_mu(module, opt),
                    adam_mu(want[f"{p}_opt"], lambda t: gan_state_dict(t, {})))
        assert int(module.state_dict()[
            "d.bn_1.num_batches_tracked" if p == "disc"
            else "down_bn_1.num_batches_tracked"]) == 16


def test_train_dihe_matches_jax(run_dir):
    """1 epoch of 2 steps and its eval, from the same weights (JAX's
    PRNGKey(0) variables handed to both loops through `gan_state` and
    `init_embedder`)."""
    data, crops = GallerySet(), CropSet()
    queries = QuerySet(data)
    init_w = jax_init_weights()
    common = dict(epochs=1, batch_size=2, checkpoint_interval=1,
                  use_mesh=False)
    jreports, preports = [], []
    jout, pout = str(run_dir / "jax"), str(run_dir / "port")
    want = jloops.train_dihe(
        data, crops, data, queries, jout,
        train_cfg=jdihe.DIHETrainConfig(gen_downs=GEN_DOWNS),
        gan_state={k: getattr(init_w, k) for k in (
            "gen_params", "gen_stats", "disc_params", "disc_stats")},
        init_embedder={"params": init_w.emb_params,
                       "batch_stats": init_w.emb_stats},
        hyperopt_report=lambda **kw: jreports.append(kw), **common)
    before = {"embedder": macvgg_state_dict(init_w.emb_params,
                                            init_w.emb_stats),
              "generator": gan_state_dict(init_w.gen_params,
                                          init_w.gen_stats),
              "discriminator": gan_state_dict(init_w.disc_params,
                                              init_w.disc_stats)}
    got = loops.train_dihe(
        data, crops, data, queries, pout,
        train_cfg=pdihe.DIHETrainConfig(gen_downs=GEN_DOWNS),
        gan_state={k: before[k] for k in ("generator", "discriminator")},
        init_embedder=before["embedder"], device="cpu",
        hyperopt_report=lambda **kw: preports.append(kw), **common)
    jstate = jax.device_get(want["state"])
    state = got["state"]
    assert state.step == int(jstate.step) == N_ITEMS // 4
    same_files(jout, pout)
    bridges = {"embedder": (lambda t: macvgg_state_dict(t, {}), "emb"),
               "generator": (lambda t: gan_state_dict(t, {}), "gen"),
               "discriminator": (lambda t: gan_state_dict(t, {}), "disc")}
    for name, (bridge, short) in bridges.items():
        module = getattr(state, name)
        want_sd = (macvgg_state_dict if name == "embedder"
                   else gan_state_dict)(getattr(jstate, f"{short}_params"),
                                        getattr(jstate, f"{short}_stats"))
        hold_player(before[name], module.state_dict(), want_sd,
                    port_mu(module, getattr(state, f"{short}_opt")),
                    adam_mu(getattr(jstate, f"{short}_opt"), bridge))
    # the epoch eval: 8 queries, JAX's bf16 einsum crops against the
    # port's f32 gather
    assert len(jreports) == len(preports) == 1
    assert abs(jreports[0]["accuracy"] - preports[0]["accuracy"]) <= 1 / 8
    assert got["best"]["epoch"] == want["best"]["epoch"] == 0


# ------------------------------------------------------------- resume

class ResumableLoader(PrefetchLoader):
    """PrefetchLoader with `iter_from`: a resumed run continues inside
    the epoch."""

    def iter_from(self, skip):
        return itertools.islice(iter(self), skip, None)


class Interrupt(Exception):
    pass


class InterruptedLoader(ResumableLoader):
    """Stops the run as it asks for epoch 1's second batch."""

    def __iter__(self):
        for i, batch in enumerate(super().__iter__()):
            if self.epoch == 1 and i == 1:
                raise Interrupt
            yield batch


def _same_state(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for part in sa:
        if part == "step":
            assert sa[part] == sb[part]
        elif part.endswith("_opt"):
            assert len(sa[part]["state"]) == len(sb[part]["state"]) > 10
            for i, s in sa[part]["state"].items():
                for k in ("exp_avg", "exp_avg_sq", "step"):
                    assert torch.equal(sb[part]["state"][i][k], s[k]), \
                        (part, i, k)
        else:
            for k, v in sa[part].items():
                assert torch.equal(sb[part][k], v), (part, k)


def _gan(out, **kw):
    args = dict(epochs=2, batch_size=2, checkpoint_interval=100, seed=4,
                device="cpu",
                train_cfg=pdihe.GANPretrainConfig(gen_downs=GEN_DOWNS))
    args.update(kw)
    return loops.pretrain_gan(GallerySet(), CropSet(), str(out), **args)


def _dihe(out, **kw):
    """train_dihe whose final-epoch eval has no query scene (the gallery
    is still embedded), to keep the resume runs short."""
    args = dict(epochs=2, batch_size=2, checkpoint_interval=100, seed=4,
                device="cpu", use_mesh=False, eval_interval=5,
                train_cfg=pdihe.DIHETrainConfig(gen_downs=GEN_DOWNS))
    args.update(kw)
    data = GallerySet()
    return loops.train_dihe(data, CropSet(), data, QuerySet(data, n=0),
                            str(out), **args)


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory, one_thread):
    """Each loop's state after 2 epochs in one go, interval saves every
    step (they do not change the training)."""
    out = {}
    for loop, run in (("gan", _gan), ("dihe", _dihe)):
        path = tmp_path_factory.mktemp(loop)
        out[loop] = run(path, checkpoint_interval=1)["state"]
        shutil.rmtree(path, ignore_errors=True)
    return out


@pytest.mark.parametrize("loop", ["gan", "dihe"])
def test_resume_from_epoch_boundary_bit_identical(run_dir, uninterrupted,
                                                  loop):
    run = _gan if loop == "gan" else _dihe
    whole = uninterrupted[loop]
    run(run_dir / "split", epochs=1)
    name = "gan_checkpoint" if loop == "gan" else "embedder_checkpoint"
    saved = torch.load(run_dir / "split" / name, weights_only=True)
    resumed = run(run_dir / "split", epochs=1, resume=True)["state"]
    _same_state(whole, resumed)
    opt = "gen_opt" if loop == "gan" else "emb_opt"
    assert len(saved[opt]["state"]) > 10
    assert all(int(s["step"]) == 4 // (1 if loop == "gan" else 2)
               for s in saved[opt]["state"].values())


@pytest.mark.parametrize("loop", ["gan", "dihe"])
def test_resume_inside_an_epoch_bit_identical(run_dir, uninterrupted,
                                              loop):
    """Interrupted in epoch 1 after an interval save; a loader with
    iter_from resumes on the next batch."""
    run = _gan if loop == "gan" else _dihe
    whole = uninterrupted[loop]
    with pytest.raises(Interrupt):
        run(run_dir / "split", loader_cls=InterruptedLoader,
            checkpoint_interval=1)
    resumed = run(run_dir / "split", loader_cls=ResumableLoader, epochs=1,
                  resume=True, checkpoint_interval=1)["state"]
    _same_state(whole, resumed)


def test_overlays_and_refusals(run_dir, monkeypatch):
    """`init_embedder` takes utils/torch_import.py's vgg16_bn import and
    refuses a shape it does not hold; `gan_state` takes a GAN state;
    use_mesh in a process group of 2 ranks refuses an odd global
    batch."""
    vgg = import_vgg16_features(testing.vgg16_features_state_dict(
        np.random.default_rng(8), batch_norm=True))
    gan_init, _ = pdihe.make_gan_pretrain_step(
        pdihe.GANPretrainConfig(gen_downs=GEN_DOWNS))
    gan = gan_init(seed=9, device="cpu")
    got = _dihe(run_dir / "a", epochs=1, init_embedder=vgg, gan_state=gan,
                checkpoint_interval=100)["state"]
    sd = torch.load(run_dir / "a" / "embedder_checkpoint",
                    weights_only=True)
    assert sd["step"] == got.step == 2
    first = vgg["features.0.weight"]
    assert (got.embedder.features[0].weight - first).abs().max() <= 2.1e-6
    assert not torch.equal(got.embedder.features[0].weight, first)
    bad = dict(vgg, **{"features.0.weight": torch.zeros(64, 3, 5, 5)})
    with pytest.raises(ValueError, match="features.0.weight"):
        _dihe(run_dir / "b", epochs=1, init_embedder=bad)
    with pytest.raises(ValueError, match="no such entry"):
        _dihe(run_dir / "b", epochs=1, init_embedder={"fc.weight":
                                                      torch.zeros(1)})
    monkeypatch.setattr(loops, "host_shard_info", lambda: (0, 2))
    with pytest.raises(AssertionError, match="divide over 2 ranks"):
        _dihe(run_dir / "c", batch_size=3, use_mesh=True)
