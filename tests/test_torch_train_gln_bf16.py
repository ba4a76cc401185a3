"""GLN training in bf16 compute with f32 master weights
(`GLNConfig(compute_dtype="bfloat16")`, flax's mixed precision) in the
port against the JAX package: the initial parameters, one SGD step of a
64x64 GLN from the same variables against JAX's jitted bf16 step with
the Gaussian up-convolution folded (JAX's default) and unfolded, the
master weights, the loop (train_proposal_generator, 3 steps and an
epoch eval from the same reference-layout checkpoint) and the port's
bit-for-bit resume.

Tolerances (cvpce_tpu_torch/testing.py:TRAIN_STEP_TOL_BF16, where the
reasons are set out): bf16 rounding compounds over the network, so two
correct bf16 steps are about as far apart as bf16 is from f32, and no
element is held alone. Each distance of the port's bf16 step from
JAX's bf16 step is held to twice JAX's own bf16-against-f32 distance on
the same inputs: the losses as the largest relative difference over the
loss terms, each trained tensor's update and each Gaussian running
statistic's update as the L2 norm of its difference, plus 1e-9 (tensors
that move by 1e-13 of rounding alone), or 1e-4 on the two conv biases
in front of a BatchNorm, whose exact gradient is 0 and which both
packages move by rounding noise of about 1e-5, plus 5e-2 of JAX's bf16
update (the f32 steps' own tolerance; one spread is a poor yardstick
for a tensor of a few dozen elements). The loops' loss series
are held the same way against JAX's bf16 loop beside the f32 loop, and
the epoch eval's AP to within twice its own spread plus 0.05. int8 is
refused, as JAX's train step cannot run it. `-s` prints each distance
beside its bound."""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.train import gln as jtrain
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.cli.common import load_gln_state_dict
from cvpce_tpu_torch.data.loader import PrefetchLoader
from cvpce_tpu_torch.models.gln import GLN, GLNConfig
from cvpce_tpu_torch.pipeline.serving import (export_gln_serving,
                                              load_gln_variables)
from cvpce_tpu_torch.train import gln as ptrain
from cvpce_tpu_torch.train import loops
from cvpce_tpu_torch.utils.weights import gln_state_dict
from test_torch_train_gln import (LOOP_CFG, LOOP_TRAIN, TRAIN_KW,
                                  DetectionSet, H, W, _assert_same_state,
                                  _losses, one_thread,  # noqa: F401
                                  reference_checkpoint, run_dir,
                                  step_batch)

BF16 = dict(compute_dtype="bfloat16")


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads, as in the other training test files."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _variables(s):
    return jax.device_get({"params": s.params, "frozen": s.frozen,
                           "batch_stats": s.batch_stats})


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's jitted make_train_step from a PRNGKey(0) init, in f32 and
    in bf16 with the Gaussian up-convolution folded and unfolded: the
    variables before (a port state_dict) and {(dtype, fold): (metrics,
    state_dict after)}. The bf16 init is the f32 init, bit for bit."""
    tcfg = jtrain.GLNTrainConfig(**TRAIN_KW)
    out, before = {}, None
    for dtype, fold in (("float32", True), ("bfloat16", True),
                        ("bfloat16", False)):
        cfg = JGLNConfig(canvas_h=H, canvas_w=W, tanh=True,
                         compute_dtype=dtype, fold_gaussian_upsample=fold)
        state, opt = jtrain.init_train_state(cfg, tcfg,
                                             jax.random.PRNGKey(0))
        init = gln_state_dict(_variables(state))
        if before is None:
            before = init
        assert init.keys() == before.keys()
        for key, v in init.items():
            assert v.dtype == before[key].dtype and torch.equal(
                v, before[key]), key
        step = jax.jit(jtrain.make_train_step(cfg, tcfg, cfg.anchors()[0],
                                              opt))
        new, metrics = step(state, *step_batch())
        out[dtype, fold] = ({k: float(v) for k, v in metrics.items()},
                            gln_state_dict(_variables(new)))
    return before, out


@pytest.fixture(scope="module")
def port_step(jax_steps):
    """The port's bf16 step from JAX's initial variables: (its train
    state, (metrics, state_dict after))."""
    before, _ = jax_steps
    cfg = GLNConfig(canvas_h=H, canvas_w=W, tanh=True, **BF16)
    tcfg = ptrain.GLNTrainConfig(**TRAIN_KW)
    state = ptrain.init_train_state(cfg, tcfg, state_dict=before,
                                    device="cpu")
    step = ptrain.make_train_step(cfg, tcfg, cfg.anchors()[0])
    state, metrics = step(state, *step_batch())
    return state, ({k: float(v) for k, v in metrics.items()},
                   {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()})


def test_initial_parameters_equal_float32():
    tcfg = ptrain.GLNTrainConfig(**TRAIN_KW)
    f32 = ptrain.init_train_state(GLNConfig(canvas_h=H, canvas_w=W), tcfg,
                                  seed=3, device="cpu")
    bf16 = ptrain.init_train_state(GLNConfig(canvas_h=H, canvas_w=W, **BF16),
                                   tcfg, seed=3, device="cpu")
    want = f32.model.state_dict()
    got = bf16.model.state_dict()
    assert got.keys() == want.keys()
    for key, v in got.items():
        assert v.dtype == want[key].dtype and torch.equal(v, want[key]), key
    params = list(bf16.model.named_parameters())
    assert len(params) > 100
    assert all(p.dtype == torch.float32 for _, p in params)
    # a serving GLN of the same config still stores its convs in bf16
    serving = GLN(GLNConfig(canvas_h=H, canvas_w=W, **BF16)).state_dict()
    assert serving["body.layer1_0.conv1.weight"].dtype == torch.bfloat16
    assert serving["gaussian.block1_bn.weight"].dtype == torch.float32


@pytest.mark.parametrize("fold", [True, False],
                         ids=["folded_upconv", "plain_upconv"])
def test_train_step_matches_jax(jax_steps, port_step, fold):
    """The port runs the Gaussian branch's upsample -> conv; JAX's
    default folds it into one conv whose taps it sums in bf16."""
    before, jax_out = jax_steps
    _, got = port_step
    res = testing.train_step_bf16_check(before, got,
                                        jax_out["bfloat16", fold],
                                        jax_out["float32", True])
    print(f"\nfold={fold}: losses {res['loss_rel']:.3e} (bound "
          f"{res['loss_bound']:.3e}); worst tensor {res['worst'][0]} at "
          f"{res['worst'][1]:.3f} of its bound, over {res['n_held']}")
    assert not res["failures"], res["failures"]
    assert res["frozen_kept"] and res["master_f32"]
    assert res["n_held"] > 100


def test_master_weights_stay_float32(port_step, jax_steps,
                                     reference_checkpoint, tmp_path):
    """After the step every trainable parameter and its momentum is f32
    and off the bf16 grid, and so is the update wherever f32 can carry
    more of it than bf16 (an update at least 2^-8 of the value it moves,
    so that the f32 sum keeps 15 of its bits); the loop starts from the
    file's f32 values on the load_torch and load_orbax routes (epochs=0
    returns the state it started from), a bf16 state_dict widened."""
    state, _ = port_step
    before, _ = jax_steps
    trained = [p for g in state.optimizer.param_groups for p in g["params"]]
    assert len(trained) > 100
    names = {id(p): n for n, p in state.model.named_parameters()}
    resolved = off_grid = 0
    for p in trained:
        name = names[id(p)]
        assert p.dtype == torch.float32 and p.requires_grad, name
        buf = state.optimizer.state[p]["momentum_buffer"]
        assert buf.dtype == torch.float32, name
        value = p.detach()
        assert (value != value.to(torch.bfloat16).float()).any(), name
        step = value - before[name]
        big = (step != 0) & (step.abs() >= before[name].abs() / 256)
        resolved += int(big.sum())
        off_grid += int((step != step.to(torch.bfloat16).float())[big].sum())
    print(f"\n{off_grid} of {resolved} resolved updates off the bf16 grid")
    assert resolved > 1000 and off_grid > 0.9 * resolved

    cfg = GLNConfig(**LOOP_CFG, **BF16)
    want = load_gln_state_dict(reference_checkpoint, GLNConfig(**LOOP_CFG))
    loaded = load_gln_state_dict(reference_checkpoint, cfg,
                                 param_dtype=torch.float32)
    serving = load_gln_state_dict(reference_checkpoint, cfg)
    assert serving["fpn.p6.weight"].dtype == torch.bfloat16
    half = {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
            for k, v in want.items()}
    orbax_dir = tmp_path / "run"
    orbax_dir.mkdir()
    torch.save({"model": half, "optimizer": {}, "step": 0},
               str(orbax_dir / "checkpoint"))
    for route, expect in (({"load_torch": reference_checkpoint}, want),
                          ({"load_orbax": str(orbax_dir)}, {
                              k: v.float() if v.is_floating_point() else v
                              for k, v in half.items()})):
        start = loops.train_proposal_generator(
            DetectionSet(), DetectionSet(), str(tmp_path / "out"),
            model_cfg=cfg, train_cfg=ptrain.GLNTrainConfig(**LOOP_TRAIN),
            epochs=0, use_mesh=False, device="cpu", **route)["state"]
        got = start.model.state_dict()
        for key, v in expect.items():
            assert got[key].dtype == v.dtype and torch.equal(got[key], v), (
                route, key)
    for key, v in want.items():
        assert loaded[key].dtype == v.dtype and torch.equal(loaded[key], v)


@pytest.mark.parametrize("int8", ["static", "calibrate"])
def test_int8_training_refused_as_jax_cannot_run_it(int8):
    """int8 is a serving path: the port refuses it, naming int8, and
    JAX's train step cannot apply it (it applies `params`, `frozen` and
    `batch_stats`, not the int8 convs' `act_scales`)."""
    from flax.errors import ScopeCollectionNotFound

    cfg = JGLNConfig(canvas_h=H, canvas_w=W, tanh=True, int8=int8, **BF16)
    tcfg = jtrain.GLNTrainConfig(**TRAIN_KW)

    def init_and_step():  # traced only
        state, opt = jtrain.init_train_state(cfg, tcfg,
                                             jax.random.PRNGKey(0))
        return jtrain.make_train_step(cfg, tcfg, cfg.anchors()[0], opt)(
            state, *step_batch())

    with pytest.raises(ScopeCollectionNotFound, match="act_scales"):
        jax.eval_shape(init_and_step)
    with pytest.raises(ValueError, match="int8"):
        ptrain.init_train_state(
            GLNConfig(canvas_h=H, canvas_w=W, int8=int8, **BF16),
            ptrain.GLNTrainConfig(**TRAIN_KW), device="cpu")


def _loss_series(out):
    return np.array(_losses(out, 0), np.float64)


def _series_distance(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_training_loop_matches_jax(run_dir, reference_checkpoint):
    """train_proposal_generator in bf16 against JAX's in bf16, beside
    the f32 loop: 1 epoch of 3 steps at batch 1, an epoch eval at IoU
    0.5, from the same checkpoint. The f32 loop is the port's, which
    tests/test_torch_train_gln.py holds to JAX's within 1e-5 relative (a
    thousandth of the bf16 spread here), so that JAX's f32 loop need not
    compile again. The loss series within twice JAX's own bf16-against-
    f32 distance (the largest relative difference over the series), the
    AP within twice its spread plus 0.05; the checkpoints hold f32
    tensors that an f32 and a bf16 serving GLN load."""
    from cvpce_tpu.train.loops import train_proposal_generator as jloop

    data = DetectionSet()
    common = dict(batch_size=1, epochs=1, checkpoint_interval=100,
                  eval_interval=1, eval_threshold=0.5, use_mesh=False,
                  load_torch=reference_checkpoint)
    jout = str(run_dir / "jax")
    want_best = jloop(data, data, jout,
                      model_cfg=JGLNConfig(**LOOP_CFG, **BF16),
                      train_cfg=jtrain.GLNTrainConfig(**LOOP_TRAIN),
                      **common)["best"]
    outs = {d: str(run_dir / f"port_{d}") for d in ("bfloat16", "float32")}
    runs = {d: loops.train_proposal_generator(
        data, data, out, model_cfg=GLNConfig(**LOOP_CFG, compute_dtype=d),
        train_cfg=ptrain.GLNTrainConfig(**LOOP_TRAIN), device="cpu",
        **common) for d, out in outs.items()}
    got, pout = runs["bfloat16"], outs["bfloat16"]
    f32_ap = runs["float32"]["best"]["ap"]
    want, ref = _loss_series(jout), _loss_series(outs["float32"])
    dist, bound = (_series_distance(_loss_series(pout), want),
                   2 * _series_distance(want, ref))
    ap, ap_bound = (abs(got["best"]["ap"] - want_best["ap"]),
                    2 * abs(want_best["ap"] - f32_ap) + 0.05)
    print(f"\nloop losses {dist:.3e} (bound {bound:.3e}); AP "
          f"{got['best']['ap']:.4f} against {want_best['ap']:.4f} "
          f"(f32 {f32_ap:.4f})")
    assert dist <= bound
    assert got["best"]["ap"] > 0 and ap <= ap_bound
    assert got["best"]["epoch"] == want_best["epoch"]
    assert got["state"].step == 3

    for name in ("checkpoint", "epoch_0"):
        sd = torch.load(os.path.join(pout, name), weights_only=True)
        floats = [v for v in sd["model"].values() if v.is_floating_point()]
        assert floats and all(v.dtype == torch.float32 for v in floats)
        moments = [s["momentum_buffer"]
                   for s in sd["optimizer"]["state"].values()]
        assert moments and all(m.dtype == torch.float32 for m in moments)
    export = export_gln_serving(pout, str(run_dir / "export"))
    floats = [v for v in load_gln_variables(export).values()
              if v.is_floating_point()]
    assert floats and all(v.dtype == torch.float32 for v in floats)
    for cfg in (GLNConfig(**LOOP_CFG), GLNConfig(**LOOP_CFG, **BF16)):
        for weights in (os.path.join(pout, "epoch_0"), export):
            served = load_gln_state_dict(weights, cfg)
            assert served["head.cls_logits.weight"].dtype == cfg.dtype


def _run(out, **kw):
    args = dict(batch_size=1, epochs=2, checkpoint_interval=100,
                eval_interval=5, eval_threshold=0.5, use_mesh=False,
                seed=3, device="cpu", loader_cls=PrefetchLoader)
    args.update(kw)
    return loops.train_proposal_generator(
        DetectionSet(), DetectionSet(n=2), str(out),
        model_cfg=GLNConfig(**LOOP_CFG, **BF16),
        train_cfg=ptrain.GLNTrainConfig(**LOOP_TRAIN), **args)


def test_resume_bit_identical(run_dir, one_thread):  # noqa: F811
    """2 bf16 epochs of 3 steps in one go against 1 epoch, then 1
    resumed from its checkpoint: the same weights, momentum and epoch-1
    losses, bit for bit."""
    once = run_dir / "once"
    want = _run(once)["state"]
    losses = _losses(once, 1)
    shutil.rmtree(once, ignore_errors=True)
    twice = run_dir / "twice"
    assert _run(twice, epochs=1)["state"].step == 3
    resumed = _run(twice, epochs=1, resume=True)["state"]
    _assert_same_state(want, resumed)
    assert [s[3:] for s in losses] == _losses(twice, 1)
    assert all(p.dtype == torch.float32
               for p in resumed.model.parameters())
