"""DIHE and GAN training steps in the port against the JAX package: one
`make_dihe_train_step` step (masks off and on) and one
`make_gan_pretrain_step` step (masks off and on) at 64 px,
`gen_downs=4`, batch 2, from JAX's `PRNGKey(0)` variables; MACVGG's
train-mode BatchNorm; `hierarchy_similarity`'s golden cases; `_bce`; the
encoder's LR schedule against optax across an epoch boundary.

The reference is JAX's own step function evaluated in float64 (x64 on,
float64 inputs, MACVGG's compute dtype float64; parameters, optimizer
state and updates stay f32). The port's step runs twice: in f32, as the
trainer runs it, and in float64 (the same code on `.double()` models).

Why float64: MACVGG's max pools and MAC maxima send their gradient to
one position among near-ties, and the generator's gradient passes
through them, so in f32 a rounding-level change of the input moves
single gradient elements by several % of their tensor's largest (the
port's embedder weight gradient moves by 7.9% of its largest under a
1e-6 relative input change). Two f32 implementations therefore
disagree elementwise, and JAX's f32 step is no closer to the float64 one than the port's by any
margin that holds across inputs; `test_float32_gradients_against_float64`
prints both distances (`pytest -s`).

How a step is held, player by player:
- the six (four) losses: within 1e-5 relative in f32; 1e-4 in float64
  (both packages cast MACVGG's descriptor to f32, and the embedder's
  updated weights differ at the elements named below);
- every running statistic within 1e-5 of the reference's (over max(1,
  |value|)), and each BatchNorm's update counter at the number of
  forwards whose statistics JAX keeps (generator 3, embedder 3,
  discriminator 2 in a DIHE step; 2 and 2 in pretraining), so the
  forwards JAX discards moved nothing;
- the gradient, as Adam's first moment (0.1 x the gradient after one
  step): in float64 within 1e-3 of each tensor's largest magnitude (the
  semantics check); in f32, L2 over the player within 5e-2 of the
  reference's norm;
- every parameter within 1e-2 of its tensor's largest update plus 1e-8
  (plus one f32 ulp of the parameter: the reference's update is known
  only as an f32 parameter) where Adam's first step resolves it: its
  reference gradient larger than twice the tensor's largest gradient
  difference and than 100 x Adam's eps. Adam's first step moves each
  element by lr x g / (|g| + eps), about lr x sign(g), so an element
  whose gradient is below the two gradients' difference may move by
  +-lr in either; every element is held to that bound, and in float64
  at most 1% of them are unresolved. The conv biases in front of a
  train-mode BatchNorm have a zero gradient: the reference's is held to
  1e-6 of its layer's weight gradient, the port's update to Adam's
  bound."""
import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from cvpce_tpu.models.embedders import MACVGG as JMACVGG
from cvpce_tpu.train import dihe as jdihe
from cvpce_tpu_torch.models.embedders import MACVGG, _vgg_plan
from cvpce_tpu_torch.train import dihe as pdihe
from cvpce_tpu_torch.utils.weights import (dihe_state_dict, gan_state_dict,
                                           macvgg_state_dict)

S, B = 64, 2
GEN_DOWNS = 4
LOSS_REL = 1e-5
STAT_TOL = 1e-5
# the port's float64 gradients (Adam's first moment) against the
# reference's, over each tensor's largest magnitude
GRAD_TOL_F64 = 1e-3
# the port's f32 gradients against the reference's: L2 over a player's
# tensors, relative (module docstring)
GRAD_L2_F32 = 5e-2
ADAM_EPS = 1e-8
BRIDGE = {"embedder": lambda t: macvgg_state_dict(t, {}),
          "generator": lambda t: gan_state_dict(t, {}),
          "discriminator": lambda t: gan_state_dict(t, {})}
OPTS = {"embedder": "emb_opt", "generator": "gen_opt",
        "discriminator": "disc_opt"}
# conv biases that feed a train-mode BatchNorm: zero true gradient
PRE_BN_BIASES = {f"features.{i}.bias"
                 for kind, i, _ in _vgg_plan(True) if kind == "conv"}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs several workers on the CPU's
    cores, where these models' many small parallel regions slowed ten
    times with a thread per core each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def step_batch(masks: bool):
    rng = np.random.default_rng(0)
    pos, neg = (rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
                for _ in range(2))
    gen = rng.uniform(-1, 1, (B, S, S, 4 if masks else 3)).astype(np.float32)
    if masks:
        gen[..., 3] = (rng.uniform(size=(B, S, S)) < 0.3).astype(np.float32)
    disc = rng.uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    sim = np.array([0.5, 1.0], np.float32)
    return pos, neg, gen, disc, sim


@contextlib.contextmanager
def jax_float64():
    """JAX's step functions computed in float64: x64 on and MACVGG built
    with a float64 compute dtype (the GAN players take their inputs'
    dtype); parameters stay f32."""
    with jax.enable_x64(True), mock.patch.object(
            jdihe, "MACVGG", functools.partial(JMACVGG,
                                               dtype=jnp.float64)):
        yield


def f64(arrays):
    return [np.asarray(a, np.float64) for a in arrays]


def adam_moments(opt_state, bridge):
    """(mu, nu) of the optax adam state inside `opt_state`, bridged to
    the port's parameter names."""
    adam = next(s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    return bridge(adam.mu), bridge(adam.nu)


def port_moments(module, opt):
    mu, nu = {}, {}
    for name, p in module.named_parameters():
        mu[name] = opt.state[p]["exp_avg"]
        nu[name] = opt.state[p]["exp_avg_sq"]
    return mu, nu


def adam_bound(lr, param):
    """The most one Adam step moves each element: lr, plus the f32
    rounding of the parameter it lands on."""
    return lr * (1 + 1e-5) + 1.2e-7 * param.abs()


def hold_adam_step(before, got_sd, got_mu, want_sd, want_mu, lr, grad_tol,
                   skip=()):
    """The per-tensor checks of one Adam step (module docstring); returns
    the counts of unresolved and of all elements."""
    unresolved = total = 0
    for key, mu_w in want_mu.items():
        if key in skip:
            continue
        mu_g = got_mu[key].detach().float()
        scale = mu_w.abs().max().item()
        err = (mu_g - mu_w).abs().max().item()
        assert grad_tol is None or err <= grad_tol * scale, (key, err, scale)
        upd_g = (got_sd[key] - before[key]).float()
        upd_w = want_sd[key] - before[key]
        resolved = mu_w.abs() > max(2 * err, 0.1 * 100 * ADAM_EPS)
        # JAX's update is known only as an f32 parameter: one ulp of it
        off = (upd_g - upd_w).abs() > (1e-2 * upd_w.abs().max() + 1e-8
                                       + 1.2e-7 * before[key].abs())
        assert not (off & resolved).any(), (key, int((off & resolved).sum()))
        assert (upd_g.abs() <= adam_bound(lr, before[key])).all(), key
        unresolved += int((~resolved).sum())
        total += resolved.numel()
    return unresolved, total


def gradient_l2(got_mu, want_mu, skip=()):
    """|got - want| / |want| over all of a player's tensors."""
    keys = [k for k in want_mu if k not in skip]
    num = sum(float((got_mu[k].detach().float() - want_mu[k]).pow(2).sum())
              for k in keys)
    den = sum(float(want_mu[k].pow(2).sum()) for k in keys)
    return (num / den) ** 0.5


def hold_statistics(got_sd, want_sd, count):
    for key, want in want_sd.items():
        if key.endswith(("running_mean", "running_var")):
            err = (got_sd[key].float() - want).abs().max().item()
            assert err <= STAT_TOL * max(1.0, want.abs().max().item()), key
        elif key.endswith("num_batches_tracked"):
            assert int(got_sd[key]) == count, key


# ------------------------------------------------------------ DIHE step

def jax_dihe_step(masks: bool, float64: bool):
    """JAX's jitted DIHE step from a PRNGKey(0) init: (bridged state
    before and after, metrics, Adam moments per player)."""
    cfg = jdihe.DIHETrainConfig(gen_downs=GEN_DOWNS, steps_per_epoch=10,
                                masks=masks)
    state, opts = jdihe.init_dihe_state(cfg, jax.random.PRNGKey(0),
                                        image_size=S,
                                        gen_channels=4 if masks else 3)
    batch = step_batch(masks)
    with jax_float64() if float64 else contextlib.nullcontext():
        step = jax.jit(jdihe.make_dihe_train_step(cfg, opts))
        new, metrics = step(state, *(f64(batch) if float64 else batch))
        new = jax.device_get(new)
    moments = {name: adam_moments(getattr(new, OPTS[name]), BRIDGE[name])
               for name in OPTS}
    return (dihe_state_dict(jax.device_get(state)), dihe_state_dict(new),
            {k: float(v) for k, v in metrics.items()}, moments)


@pytest.fixture(scope="module", params=[False, True], ids=["rgb", "masks"])
def jax_dihe(request):
    return request.param, jax_dihe_step(request.param, float64=True)


def to_float64(*models):
    for m in models:
        m.double()
        if isinstance(m, MACVGG):
            m.dtype = torch.float64


def port_dihe_step(before, masks, float64=False):
    cfg = pdihe.DIHETrainConfig(gen_downs=GEN_DOWNS, steps_per_epoch=10,
                                masks=masks)
    state = pdihe.init_dihe_state(cfg, state_dicts=before,
                                  gen_channels=4 if masks else 3,
                                  device="cpu")
    if float64:
        to_float64(state.embedder, state.generator, state.discriminator)
    return pdihe.make_dihe_train_step(cfg)(state, *step_batch(masks))


@pytest.mark.parametrize("float64", [False, True], ids=["f32", "f64"])
def test_dihe_step_matches_jax(jax_dihe, float64):
    """The port's step in f32 (the trainer's) and in float64 (the same
    code on `.double()` models) against the reference."""
    masks, (before, after, want_metrics, moments) = jax_dihe
    state, metrics = port_dihe_step(before, masks, float64)
    assert state.step == 1
    assert set(metrics) == set(want_metrics)
    for key, want in want_metrics.items():
        assert metrics[key].item() == pytest.approx(
            want, rel=1e-4 if float64 else LOSS_REL), key
    counts = {"embedder": 3, "generator": 3, "discriminator": 2}
    lrs = {"embedder": pdihe.DIHETrainConfig().enc_lr,
           "generator": pdihe.DIHETrainConfig().gan_lr,
           "discriminator": pdihe.DIHETrainConfig().gan_lr}
    unresolved = total = 0
    for name in OPTS:
        module = getattr(state, name)
        got = module.state_dict()
        hold_statistics(got, after[name], counts[name])
        mu, _ = port_moments(module, getattr(state, OPTS[name]))
        u, t = hold_adam_step(
            before[name], got, mu, after[name], moments[name][0], lrs[name],
            GRAD_TOL_F64 if float64 else None, skip=PRE_BN_BIASES)
        assert gradient_l2(mu, moments[name][0], PRE_BN_BIASES) <= (
            GRAD_L2_F32), name
        unresolved += u
        total += t
    if float64:
        assert unresolved <= 1e-2 * total
    grad = moments["embedder"][0]
    got = state.embedder.state_dict()
    for key in PRE_BN_BIASES:
        weight = grad[key.replace(".bias", ".weight")].abs().max()
        assert grad[key].abs().max() <= 1e-6 * weight, key
        assert ((got[key] - before["embedder"][key]).abs()
                <= adam_bound(lrs["embedder"],
                              before["embedder"][key])).all(), key


def test_float32_gradients_against_float64(jax_dihe):
    """Each player's f32 gradient (Adam's first moment) of the port and
    of JAX against the float64 reference, as L2 distances relative to
    its norm, of the player's worst tensor (pre-BatchNorm biases aside):
    the port's within GRAD_L2_F32; both printed."""
    masks, (before, _, _, moments) = jax_dihe
    _, _, _, moments32 = jax_dihe_step(masks, float64=False)
    state, _ = port_dihe_step(before, masks)
    for name in OPTS:
        mu, _ = port_moments(getattr(state, name), getattr(state, OPTS[name]))
        port_worst = jax_worst = 0.0
        for key, ref in moments[name][0].items():
            if key in PRE_BN_BIASES:
                continue
            norm = ref.norm().item()
            port = (mu[key] - ref).norm().item() / norm
            jax32 = (moments32[name][0][key] - ref).norm().item() / norm
            assert port <= GRAD_L2_F32, (name, key, port)
            port_worst, jax_worst = max(port_worst, port), max(jax_worst,
                                                               jax32)
        print(f"{'masks' if masks else 'rgb'} {name}: f32 gradient vs the "
              f"float64 reference, L2 relative, worst tensor: port "
              f"{port_worst:.3e}, JAX f32 {jax_worst:.3e}")
    # the embedder's f32 gradient under a 1e-6 relative input change
    pos, neg, _, _, sim = step_batch(masks)
    jitter = np.random.default_rng(9).standard_normal(pos.shape)
    grads = []
    for scale in (0.0, 1e-6):
        emb = pdihe.init_dihe_state(
            pdihe.DIHETrainConfig(gen_downs=GEN_DOWNS), state_dicts=before,
            gen_channels=4 if masks else 3, device="cpu").embedder
        x = [torch.from_numpy((a * (1 + scale * jitter)).astype(np.float32))
             for a in (pos, neg, neg[::-1].copy())]
        loss = pdihe.hierarchical_triplet_loss(
            *(emb(a) for a in x), torch.from_numpy(sim))
        grads.append(torch.autograd.grad(loss, list(emb.parameters())))
    moved = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(*grads) if a.dim() == 4)
    print(f"{'masks' if masks else 'rgb'} embedder: its f32 weight gradient "
          f"under a 1e-6 relative input change moves by {moved:.3e} of "
          f"the tensor's largest")


# --------------------------------------------------------- GAN pretrain

@pytest.fixture(scope="module", params=[False, True], ids=["rgb", "masks"])
def jax_pretrain(request):
    masks = request.param
    cfg = jdihe.GANPretrainConfig(gen_downs=GEN_DOWNS, masks=masks)
    init, step = jdihe.make_gan_pretrain_step(cfg)
    state = jax.device_get(init(jax.random.PRNGKey(0), image_size=S,
                                gen_channels=4 if masks else 3))
    _, _, gen, disc, _ = step_batch(masks)
    with jax_float64():
        new, metrics = jax.jit(step)(state, *f64((gen, disc)))
        new = jax.device_get(new)

    def bridged(s, player):
        return gan_state_dict(s[f"{player}_params"], s[f"{player}_stats"])

    return (masks, {p: bridged(state, p) for p in ("gen", "disc")},
            {p: bridged(new, p) for p in ("gen", "disc")},
            {k: float(v) for k, v in metrics.items()},
            {p: adam_moments(new[f"{p}_opt"], BRIDGE["generator"])
             for p in ("gen", "disc")})


@pytest.mark.parametrize("float64", [False, True], ids=["f32", "f64"])
def test_gan_pretrain_step_matches_jax(jax_pretrain, float64):
    masks, before, after, want_metrics, moments = jax_pretrain
    cfg = pdihe.GANPretrainConfig(gen_downs=GEN_DOWNS, masks=masks)
    init, step = pdihe.make_gan_pretrain_step(cfg)
    state = init(gen_channels=4 if masks else 3, device="cpu")
    state.generator.load_state_dict(before["gen"])
    state.discriminator.load_state_dict(before["disc"])
    if float64:
        to_float64(state.generator, state.discriminator)
    _, _, gen, disc, _ = step_batch(masks)
    state, metrics = step(state, gen, disc)
    assert set(metrics) == set(want_metrics)
    for key, want in want_metrics.items():
        assert metrics[key].item() == pytest.approx(
            want, rel=1e-4 if float64 else LOSS_REL), key

    unresolved = total = 0
    for p, module, opt in (("gen", state.generator, state.gen_opt),
                           ("disc", state.discriminator, state.disc_opt)):
        got = module.state_dict()
        hold_statistics(got, after[p], 2)
        mu, _ = port_moments(module, opt)
        u, t = hold_adam_step(before[p], got, mu, after[p], moments[p][0],
                              cfg.lr, GRAD_TOL_F64 if float64 else None)
        assert gradient_l2(mu, moments[p][0]) <= GRAD_L2_F32, p
        unresolved += u
        total += t
    if float64:
        assert unresolved <= 1e-2 * total


# ------------------------------------------------------------- pieces

def test_macvgg_train_mode_batchnorm_matches_flax():
    """MACVGG(train=True): embeddings and the running statistics of one
    forward against flax's; the same weights in torch's own
    nn.BatchNorm2d (unbiased variance, momentum 0.1) miss the
    statistics."""
    x = np.random.default_rng(6).uniform(-1, 1, (2, S, S, 3)).astype(
        np.float32)
    jm = JMACVGG(batch_norm=True, train=True)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(6), x))
    want, mut = jm.apply(variables, x, mutable=["batch_stats"])
    want_sd = macvgg_state_dict(variables["params"],
                                jax.device_get(mut["batch_stats"]))
    sd = macvgg_state_dict(variables["params"], variables["batch_stats"])

    def run(model):
        model.load_state_dict(sd)
        out = model.train()(torch.from_numpy(x)).detach().numpy()
        worst = max((model.state_dict()[k] - w).abs().max().item()
                    / max(1.0, w.abs().max().item())
                    for k, w in want_sd.items()
                    if k.endswith(("running_mean", "running_var")))
        return out, worst

    out, worst = run(MACVGG(batch_norm=True))
    np.testing.assert_allclose(out, np.asarray(want), rtol=0, atol=1e-5)
    assert worst <= STAT_TOL
    torch_bn = MACVGG(batch_norm=True)
    for i, m in enumerate(torch_bn.features):
        if isinstance(m, torch.nn.BatchNorm2d):
            torch_bn.features[i] = torch.nn.BatchNorm2d(m.num_features)
    _, torch_worst = run(torch_bn)
    assert torch_worst > 100 * STAT_TOL


def test_hierarchy_similarity_golden_cases():
    """The reference's golden fixture (tests/test_dihe_gan.py)."""
    pos = [["Quick", "Brown", "Fox", "Lazy", "Dog"],
           ["Quick", "Brown", "Fox", "Lazy", "Dog"],
           ["Quick", "Brown", "Fox"],
           ["Pot", "Kettle", "Black"],
           ["Pot", "Kettle", "Black"],
           ["Pot", "Kettle", "Black"]]
    neg = [["Quick", "Brown", "Fox", "Lazy", "Dog"],
           ["Quick", "Brown", "Cat", "Lazy", "Dog"],
           ["Quick", "Brown", "Fox", "Snoozy", "Hyena"],
           ["Quick", "Brown", "Fox", "Lazy", "Dog"],
           ["Pot"],
           ["Hello", "Darkness", "My", "Old", "Friend"]]
    got = pdihe.hierarchy_similarity(pos, neg)
    np.testing.assert_allclose(got, [1, 2 / 5, 1, 0, 1 / 3, 0])
    np.testing.assert_array_equal(got, jdihe.hierarchy_similarity(pos, neg))


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_clips_like_jax(target):
    """Inside the clip the port's BCE is JAX's; at a saturated
    probability both clip it to eps or 1 - eps (as f32), where torch's
    own BCE clamps the log at -100. (XLA may fold JAX's 1 - clip(p) into
    clip(1 - p), which rounds 1 - (1 - eps) differently.)"""
    inside = np.array([1e-6, 0.3, 0.5, 0.97, 1 - 1e-6], np.float32)
    got = pdihe._bce(torch.from_numpy(inside), target).item()
    assert got == pytest.approx(
        float(jdihe._bce(jnp.asarray(inside), target)), rel=1e-6)
    for v in inside:
        assert pdihe._bce(torch.tensor([v]), target).item() == pytest.approx(
            float(jdihe._bce(jnp.asarray([v]), target)), rel=1e-6)
    wrong = torch.tensor([1.0 - target])
    clipped = np.float32(1e-7) if target == 1.0 else (
        np.float32(1) - np.float32(1 - 1e-7))
    assert pdihe._bce(wrong, target).item() == pytest.approx(
        -np.log(clipped), rel=1e-6)
    right = torch.tensor([target])
    assert pdihe._bce(right, target).item() == pytest.approx(1e-7, rel=0.2)
    assert F.binary_cross_entropy(wrong, torch.tensor([target])).item() \
        == 100.0


def test_encoder_schedule_matches_optax_across_epochs():
    """Adam with the encoder's schedule (enc_multiplier 0.5, 3 steps an
    epoch) over 7 steps, against optax.adam(schedule) on the same
    gradients; the generator's and discriminator's optimizers at gan_lr."""
    cfg = dict(enc_lr=1e-3, enc_multiplier=0.5, steps_per_epoch=3)
    jcfg = jdihe.DIHETrainConfig(**cfg)
    pcfg = pdihe.DIHETrainConfig(**cfg)
    jtx = jdihe.build_optimizers(jcfg)[0]
    rng = np.random.default_rng(2)
    value = rng.normal(size=(4, 3)).astype(np.float32)
    jparams = {"w": jnp.asarray(value)}
    jstate = jtx.init(jparams)
    models = [torch.nn.Linear(3, 4, bias=False) for _ in range(3)]
    with torch.no_grad():
        models[0].weight.copy_(torch.from_numpy(value))
    opts = pdihe.build_optimizers(pcfg, models)
    assert [o.param_groups[0]["lr"] for o in opts[1:]] == [pcfg.gan_lr] * 2
    for step in range(7):
        grad = rng.normal(size=(4, 3)).astype(np.float32)
        updates, jstate = jtx.update({"w": jnp.asarray(grad)}, jstate,
                                     jparams)
        jparams = optax.apply_updates(jparams, updates)
        lr = pdihe.encoder_learning_rate(pcfg, step)
        assert lr == pytest.approx(1e-3 * 0.5 ** (step // 3), rel=1e-12)
        loss = (models[0].weight * torch.from_numpy(grad)).sum()
        pdihe._update(opts[0], loss, lr)
        np.testing.assert_allclose(models[0].weight.detach().numpy(),
                                   np.asarray(jparams["w"]), rtol=1e-6,
                                   atol=1e-9)


@pytest.mark.parametrize("loop", ["dihe", "gan"])
def test_step_on_devices_helpers(loop):
    """testing.py's card-against-CPU helpers (chip_smoke.py's
    train.dihe.parity, tests/test_torch_cuda.py), run on the CPU twice:
    nothing apart, every statistics counter where the JAX step leaves
    it."""
    from cvpce_tpu_torch import testing

    cfg = pdihe.DIHETrainConfig(gen_downs=GEN_DOWNS, steps_per_epoch=10)
    state = pdihe.init_dihe_state(cfg, seed=3, device="cpu")
    before = {k: getattr(state, k).state_dict()
              for k in testing.DIHE_STAT_UPDATES}
    pos, neg, gen, disc, sim = step_batch(False)
    if loop == "dihe":
        steps = testing.dihe_step_on_devices(
            cfg, before, (pos, neg, gen, disc, sim), devices=("cpu",))
        updates = testing.DIHE_STAT_UPDATES
    else:
        before = {k: before[k] for k in testing.GAN_STAT_UPDATES}
        steps = testing.gan_step_on_devices(
            pdihe.GANPretrainConfig(gen_downs=GEN_DOWNS), before,
            (gen, disc), devices=("cpu",))
        updates = testing.GAN_STAT_UPDATES
    diff = testing.dihe_step_differences(before, steps["cpu"], steps["cpu"],
                                         updates)
    assert diff["stat_updates_kept"]
    assert diff["loss_rel"] == diff["stat_rel"] == 0.0
    assert diff["moment_l2"] == diff["update_rel_resolved"] == 0.0
    assert diff["update_l2"] == 0.0
    assert set(steps["cpu"][0]) == ({"dihe", "disc_fake", "disc_real",
                                     "gen_adv", "gen_reg", "gen_emb"}
                                    if loop == "dihe" else
                                    {"disc_fake", "disc_real", "gen_adv",
                                     "gen_reg"})


def test_step_tolerances_cover_the_cpus_own_sensitivity():
    """testing.DIHE_STEP_TOL (the card against the CPU) on two CPU steps
    whose inputs differ by 1e-6 relative: the gate passes, though the
    updates' L2 distance is several % (`pytest -s` prints both)."""
    from cvpce_tpu_torch import testing

    cfg = pdihe.DIHETrainConfig(gen_downs=GEN_DOWNS, steps_per_epoch=10)
    state = pdihe.init_dihe_state(cfg, seed=3, device="cpu")
    before = {k: getattr(state, k).state_dict()
              for k in testing.DIHE_STAT_UPDATES}
    batch = step_batch(False)
    jitter = np.random.default_rng(9)
    moved = [(a * (1 + 1e-6 * jitter.standard_normal(a.shape))).astype(
        np.float32) for a in batch[:4]] + [batch[4]]
    a = testing.dihe_step_on_devices(cfg, before, moved, devices=("cpu",))
    b = testing.dihe_step_on_devices(cfg, before, batch, devices=("cpu",))
    diff = testing.dihe_step_differences(before, a["cpu"], b["cpu"],
                                         testing.DIHE_STAT_UPDATES)
    print(f"1e-6 input change: first moments {diff['moment_l2']:.3e} "
          f"(L2), updates {diff['update_l2']:.3e} (L2), resolved updates "
          f"{diff['update_rel_resolved']:.3e}, unresolved share "
          f"{diff['unresolved_share']:.3f}")
    assert diff["stat_updates_kept"]
    for key, tol in testing.DIHE_STEP_TOL.items():
        assert diff[key] <= tol, (key, diff)
