"""DIHE and GAN pretraining checkpoints shared by the two packages: the
port's `embedder_checkpoint` and `gan_checkpoint` nodes are orbax
directories in the JAX package's DIHETrainState and GAN pretraining
layouts (cvpce_tpu_torch/train/dihe.py: `to_tree` / `load_tree`), Adam
states included.

- JAX -> port and port -> JAX, as tests/test_torch_train_state_orbax.py
  does for GLN: 2 steps of one package from the port's seeded players
  (64 px, `gen_downs` 4, batch 2), its node written by its own
  CheckpointManager and read by the other's (JAX's
  `restore(abstract_state)`), every leaf bit for bit, then the third
  step of each from that state held together;
- the port's DIHE node of JAX's state has JAX's `_METADATA`; empty
  nodes (None, an empty dict) and the int32 step are written as orbax
  writes them;
- a torch Adam whose parameters' steps differ cannot be written.

`steps_per_epoch` 2 and `enc_multiplier` 0.5: the third step's encoder
LR is the second epoch's, which the restored count sets. The third
steps are held with the f32 bounds of tests/test_torch_train_dihe.py
(testing.dihe_step_differences): losses within 1e-5 relative, running
statistics within 1e-5, each player's gradient (the step's increment
of Adam's first moment, 0.1 x the gradient, as the one-step tests read
it) within 5e-2 L2 of the reference's, and its parameter updates within
5e-2 L2 of the reference's (measured: losses 9e-7 and 2e-6, statistics
2e-6, gradients 1e-3 and 8e-3, updates 2e-3 and 6e-3, the worst player
the embedder). The one-step tests' elementwise check of the updates
where the gradients resolve rests on Adam's first step moving each
element by about lr x sign(g); a third step's update also depends on the
two earlier moments, and where MACVGG's max-pool and MAC near-ties move
a gradient element, the update moves by up to 0.19 of the tensor's
largest (embedder features.27), so it is reported by
testing.dihe_step_differences and not held."""
import collections

import jax
import numpy as np
import optax
import pytest
import torch

from cvpce_tpu.train import dihe as jdihe
from cvpce_tpu.train.checkpoint import CheckpointManager as JCheckpoints
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.train import dihe as pdihe
from cvpce_tpu_torch.train.checkpoint import CheckpointManager
from cvpce_tpu_torch.utils import orbax_read, orbax_write
from cvpce_tpu_torch.utils.weights import (dihe_state_dict, gan_state_dict,
                                           gan_variables, macvgg_variables)
from test_torch_train_dihe import BRIDGE, OPTS, adam_moments, port_moments
from torch_train_state_common import (assert_bit_equal, flat_jax,
                                      flat_tree, node_signature)

S, B = 64, 2
DIHE = dict(gen_downs=4, steps_per_epoch=2, enc_multiplier=0.5)
GAN = dict(gen_downs=4)
META = {"epoch": 0, "iteration": 1, "epoch_step": 1}
B1 = 0.9  # Adam's first-moment decay
# the f32 bounds of tests/test_torch_train_dihe.py (module docstring)
BOUNDS = {"loss_rel": 1e-5, "stat_rel": 1e-5, "moment_l2": 5e-2,
          "update_l2": 5e-2}
PLAYERS = ("embedder", "generator", "discriminator")
GAN_PLAYERS = {"generator": "gen", "discriminator": "disc"}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def batch(i: int):
    """(positives, negatives, gen_batch, disc_batch, similarity) of step
    i, in tanh scale."""
    rng = np.random.default_rng(30 + i)
    pos, neg, gen, disc = (rng.uniform(-1, 1, (B, S, S, 3)).astype(
        np.float32) for _ in range(4))
    return pos, neg, gen, disc, np.array([0.5, 1.0], np.float32)


def hold(before, got, want):
    """testing.dihe_step_differences of two third steps within BOUNDS."""
    # the BatchNorm counters are no part of the JAX tree: not held here
    res = testing.dihe_step_differences(before, got, want,
                                        collections.defaultdict(int))
    for key, bound in BOUNDS.items():
        assert res[key] <= bound, (key, res[key], bound, res)


# ------------------------------------------------------------------ DIHE

def port_dihe(seed=0, sds=None):
    return pdihe.init_dihe_state(pdihe.DIHETrainConfig(**DIHE), seed=seed,
                                 state_dicts=sds, device="cpu")


def port_record(state, metrics, mu2, players=PLAYERS):
    """(metrics, {player: (state_dict, first-moment increment)})."""
    opts = dict(OPTS)
    out = {}
    for name in players:
        module = getattr(state, name)
        mu, _ = port_moments(module, getattr(state, opts[name]))
        out[name] = ({k: v.detach().clone()
                      for k, v in module.state_dict().items()},
                     {k: v - B1 * mu2[name][k] for k, v in mu.items()})
    return {k: float(v) for k, v in metrics.items()}, out


def jax_dihe_record(new, metrics, mu2):
    sds = dihe_state_dict(new)
    out = {}
    for name in PLAYERS:
        mu, _ = adam_moments(getattr(new, OPTS[name]), BRIDGE[name])
        out[name] = (sds[name], {k: v - B1 * mu2[name][k]
                                 for k, v in mu.items()})
    return {k: float(v) for k, v in metrics.items()}, out


def jax_dihe_moments(state):
    return {name: adam_moments(getattr(state, OPTS[name]), BRIDGE[name])[0]
            for name in PLAYERS}


@pytest.fixture(scope="module")
def jax_dihe():
    """JAX's initial DIHETrainState on the port's seeded players, and
    its jitted step."""
    sds = {k: getattr(port_dihe(), k).state_dict() for k in PLAYERS}
    emb = macvgg_variables(sds["embedder"])
    variables = {"embedder": dict(zip(("params", "batch_stats"), emb))}
    for k in ("generator", "discriminator"):
        variables[k] = dict(zip(("params", "batch_stats"),
                                gan_variables(sds[k])))
    cfg = jdihe.DIHETrainConfig(**DIHE)
    state, opts = jdihe.init_dihe_state(cfg, jax.random.PRNGKey(0),
                                        image_size=S, variables=variables)
    return sds, state, jax.jit(jdihe.make_dihe_train_step(cfg, opts))


@pytest.fixture(scope="module")
def jax_dihe_written(jax_dihe, tmp_path_factory):
    """JAX's 2 steps, its `embedder_checkpoint` node and third step."""
    _, state, step = jax_dihe
    for i in range(2):
        state, _ = step(state, *batch(i))
    state = jax.device_get(state)
    run = str(tmp_path_factory.mktemp("jax_dihe"))
    JCheckpoints(run, name="embedder_checkpoint").save_rotating(state, META)
    new, metrics = step(state, *batch(2))
    return run, state, jax_dihe_record(jax.device_get(new), metrics,
                                       jax_dihe_moments(state))


def test_jax_dihe_checkpoint_resumes_in_the_port(jax_dihe_written):
    run, state2, want = jax_dihe_written
    state = port_dihe(seed=1)
    CheckpointManager(run, name="embedder_checkpoint").restore(state)
    assert state.step == 2
    assert_bit_equal(flat_tree(state.to_tree()), flat_jax(state2))
    before = {k: dihe_state_dict(state2)[k] for k in PLAYERS}
    mu2 = jax_dihe_moments(state2)
    state, metrics = pdihe.make_dihe_train_step(
        pdihe.DIHETrainConfig(**DIHE))(state, *batch(2))
    hold(before, port_record(state, metrics, mu2), want)


def test_port_dihe_checkpoint_resumes_in_jax(jax_dihe, tmp_path):
    sds, abstract, jstep = jax_dihe
    state = port_dihe(sds=sds)
    step = pdihe.make_dihe_train_step(pdihe.DIHETrainConfig(**DIHE))
    for i in range(2):
        state, _ = step(state, *batch(i))
    CheckpointManager(str(tmp_path), name="embedder_checkpoint"
                      ).save_rotating(state, META)
    restored = JCheckpoints(str(tmp_path), name="embedder_checkpoint"
                            ).restore(abstract)
    assert int(restored.step) == 2
    assert_bit_equal(flat_jax(restored), flat_tree(state.to_tree()))
    mu2 = jax_dihe_moments(restored)
    before = {k: dihe_state_dict(restored)[k] for k in PLAYERS}
    new, metrics = jstep(restored, *batch(2))
    want = jax_dihe_record(jax.device_get(new), metrics, mu2)
    state, metrics = step(state, *batch(2))
    hold(before, port_record(state, metrics, mu2), want)


def test_port_dihe_node_metadata_is_jax(jax_dihe_written, tmp_path):
    """The port's node of JAX's DIHE state beside JAX's: the same
    `_METADATA` entries (gen_opt's and disc_opt's EmptyState as None)
    and array shapes and dtypes."""
    run, _, _ = jax_dihe_written
    state = port_dihe(seed=1)
    CheckpointManager(run, name="embedder_checkpoint").restore(state)
    CheckpointManager(str(tmp_path), name="embedder_checkpoint"
                      ).save_rotating(state, META)
    want = node_signature(f"{run}/embedder_checkpoint")
    assert node_signature(f"{tmp_path}/embedder_checkpoint") == want
    assert want["('gen_opt', '1')"] == ((2, 1), "None", True, None, None)
    assert want["('emb_opt', '1', 'count')"][3:] == ((), "<i4")


def test_adam_steps_that_differ_are_refused():
    """optax keeps one count an optimizer: a torch Adam whose
    parameters' steps differ has no such count."""
    state = port_dihe()
    state, _ = pdihe.make_dihe_train_step(pdihe.DIHETrainConfig(**DIHE))(
        state, *batch(0))
    p = next(state.generator.parameters())
    state.gen_opt.state[p]["step"] += 1
    with pytest.raises(ValueError, match="steps of UNetGenerator"):
        state.to_tree()


def test_empty_nodes_and_the_step_are_written_as_orbax_writes_them(
        tmp_path):
    """None (optax's EmptyState and MaskedNode), an empty dict and a 0-d
    int32 step: the port's `_METADATA` and arrays are orbax's own save
    of the same tree, and each package reads the other's."""
    tree = {"step": np.asarray(7, np.int32), "batch_stats": {},
            "opt": [None, {"count": np.asarray(7, np.int32),
                           "trace": {"a": None, "b": np.ones(3, np.float32)}}]}
    orbax_write.save(str(tmp_path / "port"), tree)
    JCheckpoints(str(tmp_path), name="jax").save_rotating(
        {"step": tree["step"], "batch_stats": {},
         "opt": (optax.EmptyState(),
                 {"count": tree["opt"][1]["count"],
                  "trace": {"a": optax.MaskedNode(),
                            "b": tree["opt"][1]["trace"]["b"]}})}, {})
    assert node_signature(str(tmp_path / "port")) == node_signature(
        str(tmp_path / "jax"))
    assert_bit_equal(flat_tree(orbax_read.restore(str(tmp_path / "port"))),
                     flat_tree(tree))
    assert orbax_read.restore(str(tmp_path / "port"))["batch_stats"] == {}


# ------------------------------------------------------------------- GAN

def jax_gan_state(sds):
    """The JAX pretraining dict make_gan_pretrain_step's init builds, on
    the port's players."""
    tx = optax.adam(jdihe.GANPretrainConfig(**GAN).lr)
    out = {}
    for name, short in GAN_PLAYERS.items():
        params, stats = gan_variables(sds[name])
        out.update({f"{short}_params": params, f"{short}_stats": stats,
                    f"{short}_opt": tx.init(params)})
    return out


def gan_moments(state):
    return {name: adam_moments(state[f"{short}_opt"], BRIDGE[name])[0]
            for name, short in GAN_PLAYERS.items()}


def gan_before(state):
    return {name: gan_state_dict(state[f"{s}_params"], state[f"{s}_stats"])
            for name, s in GAN_PLAYERS.items()}


def jax_gan_record(new, metrics, mu2):
    sds = gan_before(new)
    mu = gan_moments(new)
    return ({k: float(v) for k, v in metrics.items()},
            {name: (sds[name], {k: v - B1 * mu2[name][k]
                                for k, v in mu[name].items()})
             for name in GAN_PLAYERS})


@pytest.fixture(scope="module")
def gan():
    """The port's init and step, the port's seeded players and JAX's
    initial dict on them, and JAX's jitted step."""
    init, step = pdihe.make_gan_pretrain_step(pdihe.GANPretrainConfig(**GAN))
    first = init(device="cpu")
    sds = {k: getattr(first, k).state_dict() for k in GAN_PLAYERS}
    _, jstep = jdihe.make_gan_pretrain_step(jdihe.GANPretrainConfig(**GAN))
    return init, step, sds, jax_gan_state(sds), jax.jit(jstep)


def test_jax_gan_checkpoint_resumes_in_the_port(gan, tmp_path):
    init, step, _, state, jstep = gan
    for i in range(2):
        state, _ = jstep(state, *batch(i)[2:4])
    state = jax.device_get(state)
    JCheckpoints(str(tmp_path), name="gan_checkpoint").save_rotating(
        state, META)
    new, metrics = jstep(state, *batch(2)[2:4])
    mu2 = gan_moments(state)
    want = jax_gan_record(jax.device_get(new), metrics, mu2)
    port = init(seed=1, device="cpu")
    CheckpointManager(str(tmp_path), name="gan_checkpoint").restore(port)
    assert_bit_equal(flat_tree(port.to_tree()), flat_jax(state))
    port, metrics = step(port, *batch(2)[2:4])
    hold(gan_before(state), port_record(port, metrics, mu2, GAN_PLAYERS),
         want)


def test_port_gan_checkpoint_resumes_in_jax(gan, tmp_path):
    init, step, sds, abstract, jstep = gan
    port = init(device="cpu")
    for name in GAN_PLAYERS:
        getattr(port, name).load_state_dict(sds[name])
    for i in range(2):
        port, _ = step(port, *batch(i)[2:4])
    CheckpointManager(str(tmp_path), name="gan_checkpoint").save_rotating(
        port, META)
    restored = JCheckpoints(str(tmp_path), name="gan_checkpoint"
                            ).restore(abstract)
    assert_bit_equal(flat_jax(restored), flat_tree(port.to_tree()))
    assert int(restored["gen_opt"][0].count) == 2
    mu2 = gan_moments(restored)
    new, metrics = jstep(restored, *batch(2)[2:4])
    want = jax_gan_record(jax.device_get(new), metrics, mu2)
    port, metrics = step(port, *batch(2)[2:4])
    hold(gan_before(restored), port_record(port, metrics, mu2, GAN_PLAYERS),
         want)
