"""GLN training checkpoints shared by the two packages: the port's
`checkpoint` node is an orbax directory in the JAX package's
GLNTrainState layout (cvpce_tpu_torch/train/checkpoint.py,
train/gln.py:GLNTrainState.to_tree / load_tree), in f32 and in bf16
compute on f32 master weights.

- JAX -> port: JAX's jitted step takes 2 steps from the port's seeded
  initial variables and its CheckpointManager writes the node; the
  port restores it, every leaf bit for bit JAX's state (momentum,
  schedule count and step included), and its third step is held to
  JAX's third step;
- port -> JAX: the port takes the 2 steps and writes the node; JAX's
  `CheckpointManager.restore(abstract_state)` reads it, every leaf bit
  for bit the port's, and JAX's third step is held to the port's;
- the port's node of JAX's state has JAX's `_METADATA`: the same keys,
  key types, value types, `skip_deserialize`, shapes and dtypes, on the
  full-width ResNet-50 + FPN tree (a 64x64 canvas changes no parameter).

`steps_per_epoch` is 2, so the third step runs at the second epoch's LR,
which the restored count sets. The third steps are held as
tests/test_torch_train_gln.py:test_train_step_matches_jax holds one
step (f32: losses within 1e-5 relative, each updated tensor within
1e-2 of its update's largest magnitude plus 1e-8, the Gaussian
statistics within 1e-5, the frozen stem unchanged) and as
tests/test_torch_train_gln_bf16.py holds a bf16 step
(testing.train_step_bf16_check beside JAX's f32 step from the same
state, JAX's bf16 step unfolded as the port computes it: `jax_steps`)."""
import jax
import numpy as np
import pytest
import torch

from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.train import gln as jtrain
from cvpce_tpu.train.checkpoint import CheckpointManager as JCheckpoints
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.models.gln import GLNConfig
from cvpce_tpu_torch.train import gln as ptrain
from cvpce_tpu_torch.train.checkpoint import CheckpointManager
from cvpce_tpu_torch.utils.weights import gln_state_dict, gln_variables
from test_torch_train_gln import TRAIN_KW, H, W
from torch_train_state_common import (assert_bit_equal, flat_jax,
                                      flat_tree, node_signature)

TRAIN = dict(TRAIN_KW, steps_per_epoch=2)
META = {"epoch": 0, "iteration": 1, "epoch_step": 1}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads, as in the other training test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def batch(i: int):
    """Batch 2 of step i: image 0 with 6 valid boxes of 8, image 1 with
    none and a smaller content size (test_torch_train_gln.step_batch's
    shapes, another seed a step)."""
    rng = np.random.default_rng(20 + i)
    images = rng.uniform(0, 1, (2, H, W, 3)).astype(np.float32)
    boxes = np.zeros((2, 8, 4), np.float32)
    boxes[..., :2] = rng.uniform(0, 40, (2, 8, 2))
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(8, 24, (2, 8, 2))
    valid = np.zeros((2, 8), bool)
    valid[0, :6] = True
    sizes = np.array([[64, 64], [48, 56]], np.int32)
    return images, boxes, valid, sizes


def port_cfg(dtype: str) -> GLNConfig:
    return GLNConfig(canvas_h=H, canvas_w=W, tanh=True, compute_dtype=dtype)


def port_state(dtype: str, sd=None, seed: int = 0):
    cfg, tcfg = port_cfg(dtype), ptrain.GLNTrainConfig(**TRAIN)
    state = ptrain.init_train_state(cfg, tcfg, seed=seed, state_dict=sd,
                                    device="cpu")
    return state, ptrain.make_train_step(cfg, tcfg, cfg.anchors()[0])


def snapshot(state) -> dict:
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


def jax_outcome(step, state, i):
    """(metrics, port state_dict after) of JAX's step on batch i."""
    new, metrics = step(state, *batch(i))
    new = jax.device_get(new)
    return ({k: float(v) for k, v in metrics.items()},
            gln_state_dict({"params": new.params, "frozen": new.frozen,
                            "batch_stats": new.batch_stats}))


@pytest.fixture(scope="module")
def init_sd():
    """The port's seeded (seed 0) f32 initial GLN state_dict."""
    return port_state("float32")[0].model.state_dict()


@pytest.fixture(scope="module")
def jax_steps(init_sd):
    """{dtype: (JAX's initial GLNTrainState, its jitted step)} from the
    port's initial variables (a bf16 config keeps f32 parameters). The
    bf16 step is JAX's in the port's form, the Gaussian up-convolution
    unfolded: folded (JAX's default), JAX sums its taps in bf16, which
    alone puts the third step's losses 4.6e-4 from the port's against a
    bound of 4.1e-4 (unfolded 2.9e-4 against 2.4e-3);
    tests/test_torch_train_gln_bf16.py holds a first step to both
    forms."""
    tcfg = jtrain.GLNTrainConfig(**TRAIN)
    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = JGLNConfig(canvas_h=H, canvas_w=W, tanh=True,
                         compute_dtype=dtype,
                         fold_gaussian_upsample=dtype == "float32")
        state, opt = jtrain.init_train_state(
            cfg, tcfg, jax.random.PRNGKey(0),
            variables=gln_variables(init_sd))
        out[dtype] = (state, jax.jit(jtrain.make_train_step(
            cfg, tcfg, cfg.anchors()[0], opt)))
    return out


def third_steps(jax_steps, dtype, state2):
    """JAX's third step from `state2` in `dtype`, and beside a bf16 one
    JAX's f32 step from the same state (the bf16 check's yardstick)."""
    want = jax_outcome(jax_steps[dtype][1], state2, 2)
    ref = (jax_outcome(jax_steps["float32"][1], state2, 2)
           if dtype == "bfloat16" else None)
    return want, ref


def port_outcome(dtype, run, i):
    """(metrics, state_dict after) of the port's step on batch i from
    the node in `run`, in `dtype`."""
    state, step = port_state(dtype, seed=1)
    CheckpointManager(run).restore(state)
    state, metrics = step(state, *batch(i))
    return {k: v.item() for k, v in metrics.items()}, snapshot(state)


def hold_step(dtype, before, got, want, ref, run=None):
    """The port's step `got` against JAX's `want`, each (metrics,
    state_dict after) from `before`: the one-step tests' bounds (module
    docstring). In bf16 the losses are held to twice the larger of the
    two packages' own bf16-against-f32 distances from that state (the
    port's f32 step from the node in `run`): the Gaussian loss's
    hard-negative selection moves each package's bf16 loss by up to
    1.6e-3 of its f32 value in either direction (measured over batches
    2-5), so one package's distance alone is no yardstick for the
    other's."""
    if dtype == "bfloat16":
        res = testing.train_step_bf16_check(before, got, want, ref)
        tensors = [f for f in res["failures"] if f[0] != "losses"]
        assert not tensors, tensors
        own = testing._loss_distance(got[0], port_outcome("float32", run,
                                                          2)[0])
        bound = max(res["loss_bound"], testing.TRAIN_STEP_TOL_BF16[
            "factor"] * own)
        assert res["loss_rel"] <= bound, (res["loss_rel"], bound)
        assert res["frozen_kept"] and res["master_f32"]
        assert res["n_held"] > 100
        return
    (got_m, got_sd), (want_m, want_sd) = got, want
    for key, w in want_m.items():
        assert got_m[key] == pytest.approx(w, rel=1e-5), key
    n_moved = 0
    for key, w in want_sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        g, old = got_sd[key], before[key]
        trained_conv = ".conv" in key or "downsample_conv" in key
        if key.startswith("body.conv1.") or (key.startswith("body.")
                                             and not trained_conv):
            assert torch.equal(g, old) and torch.equal(w, old), key
            continue
        update = (w - old).abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= 1e-2 * update + 1e-8, (key, err, update)
        n_moved += update > 0
    assert n_moved > 100
    for name in ("block1_bn", "block2_bn"):
        for leaf in ("running_mean", "running_var"):
            key = f"gaussian.{name}.{leaf}"
            np.testing.assert_allclose(got_sd[key].numpy(),
                                       want_sd[key].numpy(), rtol=0,
                                       atol=1e-5)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def jax_written(request, jax_steps, tmp_path_factory):
    """JAX's run of 2 steps in a compute dtype, its rotating checkpoint
    written by JAX's CheckpointManager: (dtype, run directory, the state
    after 2 steps, JAX's third step and its f32 yardstick)."""
    dtype = request.param
    state, step = jax_steps[dtype]
    for i in range(2):
        state, _ = step(state, *batch(i))
    state = jax.device_get(state)
    run = tmp_path_factory.mktemp(f"jax_gln_{dtype}")
    JCheckpoints(str(run)).save_rotating(state, META)
    return (dtype, str(run), state) + third_steps(jax_steps, dtype, state)


def test_jax_checkpoint_resumes_in_the_port(jax_written):
    dtype, run, state2, want, ref = jax_written
    # other weights than the node's, which the restore replaces
    state, step = port_state(dtype, seed=1)
    CheckpointManager(run).restore(state)
    assert state.step == 2
    tree = state.to_tree()
    assert_bit_equal(flat_tree(tree), flat_jax(state2))
    # the frozen stem's momentum is optax's MaskedNode
    trace = tree["opt_state"][0]["inner_state"][1][0]["trace"]
    assert trace["body"]["conv1"]["kernel"] is None
    before = snapshot(state)
    state, metrics = step(state, *batch(2))
    hold_step(dtype, before, ({k: v.item() for k, v in metrics.items()},
                              snapshot(state)), want, ref, run)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_checkpoint_resumes_in_jax(jax_steps, init_sd, tmp_path,
                                        dtype):
    state, step = port_state(dtype, sd=init_sd)
    for i in range(2):
        state, _ = step(state, *batch(i))
    CheckpointManager(str(tmp_path)).save_rotating(state, META)
    restored = JCheckpoints(str(tmp_path)).restore(jax_steps[dtype][0])
    assert int(restored.step) == 2
    assert_bit_equal(flat_jax(restored), flat_tree(state.to_tree()))
    want, ref = third_steps(jax_steps, dtype, restored)
    before = snapshot(state)
    state, metrics = step(state, *batch(2))
    hold_step(dtype, before, ({k: v.item() for k, v in metrics.items()},
                              snapshot(state)), want, ref, str(tmp_path))


def test_port_node_metadata_is_jax(jax_written, tmp_path):
    """The port's node of JAX's state beside JAX's own node: the same
    `_METADATA` entries (438 of them: params, frozen, batch_stats, the
    momentum trace with None at the frozen stem, the EmptyStates, count
    and step) and the same array shapes and dtypes."""
    dtype, run, _, _, _ = jax_written
    state, _ = port_state(dtype, seed=1)
    CheckpointManager(run).restore(state)
    CheckpointManager(str(tmp_path)).save_rotating(state, META)
    want = node_signature(f"{run}/checkpoint")
    got = node_signature(f"{tmp_path}/checkpoint")
    assert got == want
    assert len(want) == 438
    kinds = {v[1] for v in want.values()}
    assert kinds == {"np.ndarray", "None"}
    assert want["('step',)"][3:] == ((), "<i4")
    n_params = sum(1 for _ in state.model.parameters())
    assert sum(1 for k in want if "'trace'" in k) == n_params
