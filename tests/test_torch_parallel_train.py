"""The port's data-parallel train steps on 2 gloo ranks on the CPU against
the JAX package's step on the whole global batch (what JAX computes
under its mesh, tests/test_parallel_e2e.py:21):

- one GLN step at 64x64, the Gaussian branch on (tanh), one image a
  rank: image 0 with 6 boxes, image 1 with none
  (tests/test_torch_train_gln.py's batch), against JAX's jitted step on
  both, held as that file holds a one-process step: losses within 1e-5
  relative, each updated parameter within 1e-2 of its largest update plus
  1e-8, the Gaussian branch's running statistics within 1e-5; then
  make_multi_step under make_dp_train_step(batch_axis=1) against two DP
  single steps, bit for bit; the same in bf16 compute against JAX's bf16
  step, held as tests/test_torch_train_gln_bf16.py holds a one-process
  bf16 step (testing.train_step_bf16_check: twice JAX's own
  bf16-against-f32 distance);
- one DIHE three-player step and one GAN pretraining step at 64 px,
  gen_downs 4, one sample a rank, in float64 against JAX's step in
  float64 (tests/test_torch_train_dihe.py says why f32 gradients cannot
  be held elementwise), held as that file holds the port's float64 step:
  losses within 1e-4 relative, running statistics within 1e-5 and each
  BatchNorm's update count JAX's, first moments within 1e-3 of each
  tensor's largest, resolved updates within 1e-2 of the largest update.

Both ranks end bit for bit alike in every case (a sha256 of their
state)."""
import jax
import numpy as np
import pytest
import torch

from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.train import dihe as jdihe
from cvpce_tpu.train import gln as jtrain
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.utils.weights import (dihe_state_dict, gan_state_dict,
                                           gln_state_dict)
from test_torch_train_dihe import (BRIDGE, GEN_DOWNS, GRAD_TOL_F64, OPTS,
                                   PRE_BN_BIASES, S, adam_bound,
                                   adam_moments, f64, hold_adam_step,
                                   hold_statistics, jax_float64)
from test_torch_train_dihe import step_batch as dihe_batch
from test_torch_train_gln import TRAIN_KW, H, W
from test_torch_train_gln import step_batch as gln_batch
from torch_parallel_common import start_ranks


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads in this process, as in the other training test
    files; each rank runs on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gln_dp_step_matches_jax_on_the_global_batch(compute_dtype):
    tcfg = jtrain.GLNTrainConfig(**TRAIN_KW)

    def init(dtype):
        cfg = JGLNConfig(canvas_h=H, canvas_w=W, tanh=True,
                         compute_dtype=dtype)
        return (cfg,) + jtrain.init_train_state(cfg, tcfg,
                                                jax.random.PRNGKey(0))

    def variables(s):
        return jax.device_get({"params": s.params, "frozen": s.frozen,
                               "batch_stats": s.batch_stats})

    def jax_step(cfg, state, opt):
        step = jax.jit(jtrain.make_train_step(cfg, tcfg, cfg.anchors()[0],
                                              opt))
        new, metrics = step(state, *batch)
        return ({k: float(v) for k, v in metrics.items()},
                gln_state_dict(variables(new)))

    cfg, state, opt = init(compute_dtype)
    before = gln_state_dict(variables(state))
    batch = gln_batch()
    ranks = start_ranks("gln_step", state_dict=before, batch=batch,
                        config_kw=dict(canvas_h=H, canvas_w=W, tanh=True,
                                       compute_dtype=compute_dtype),
                        train_kw=TRAIN_KW)
    want_metrics, want = jax_step(cfg, state, opt)
    got = ranks.results()

    assert got[0]["digest"] == got[1]["digest"]
    for out in got:
        assert out["step"] == 1
        assert out["metrics"] == got[0]["metrics"]
        # make_multi_step under batch_axis=1 is two DP steps, bit for bit
        assert out["multi"] == out["singles"]
    sd = got[0]["state"]
    if compute_dtype == "bfloat16":
        # JAX's own bf16-against-f32 distance sets the bounds
        # (tests/test_torch_train_gln_bf16.py)
        res = testing.train_step_bf16_check(
            before, (got[0]["metrics"], sd), (want_metrics, want),
            jax_step(*init("float32")))
        assert not res["failures"], res["failures"]
        assert res["frozen_kept"] and res["master_f32"]
        assert res["n_held"] > 100
        return
    for key, value in want_metrics.items():
        assert got[0]["metrics"][key] == pytest.approx(value, rel=1e-5), key
    n_moved = 0
    for key, w in want.items():
        g, old = sd[key], before[key]
        if key.endswith("num_batches_tracked"):
            continue
        trained_conv = ".conv" in key or "downsample_conv" in key
        if key.startswith("body.conv1.") or (key.startswith("body.")
                                             and not trained_conv):
            assert torch.equal(g, old), key  # frozen
            continue
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-5, err_msg=key)
            assert not torch.equal(g, old), key
            continue
        update = (w - old).abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= 1e-2 * update + 1e-8, (key, err, update)
        n_moved += update > 0
    assert n_moved > 100


def _hold_players(before, after, moments, players, counts, lrs):
    unresolved = total = 0
    for name in counts:
        sd, mu = players[name]
        hold_statistics(sd, after[name], counts[name])
        u, t = hold_adam_step(before[name], sd, mu, after[name],
                              moments[name][0], lrs[name], GRAD_TOL_F64,
                              skip=PRE_BN_BIASES if name == "embedder"
                              else ())
        unresolved += u
        total += t
    assert unresolved <= 1e-2 * total


def test_dihe_dp_step_matches_jax_float64():
    cfg = jdihe.DIHETrainConfig(gen_downs=GEN_DOWNS, steps_per_epoch=10)
    state, opts = jdihe.init_dihe_state(cfg, jax.random.PRNGKey(0),
                                        image_size=S)
    before = dihe_state_dict(jax.device_get(state))
    batch = dihe_batch(False)
    ranks = start_ranks("dihe_step", before=before, batch=batch,
                        cfg_kw=dict(gen_downs=GEN_DOWNS, steps_per_epoch=10))
    with jax_float64():
        new, metrics = jax.jit(jdihe.make_dihe_train_step(cfg, opts))(
            state, *f64(batch))
        new = jax.device_get(new)
    after = dihe_state_dict(new)
    moments = {name: adam_moments(getattr(new, OPTS[name]), BRIDGE[name])
               for name in OPTS}
    got = ranks.results()

    assert got[0]["digest"] == got[1]["digest"]
    for out in got:
        assert out["step"] == 1
        assert out["metrics"] == got[0]["metrics"]
        for key, value in metrics.items():
            assert out["metrics"][key] == pytest.approx(float(value),
                                                        rel=1e-4), key
    lr = {"embedder": cfg.enc_lr, "generator": cfg.gan_lr,
          "discriminator": cfg.gan_lr}
    _hold_players(before, after, moments, got[0]["players"],
                  {"embedder": 3, "generator": 3, "discriminator": 2}, lr)
    # the pre-BatchNorm biases: zero gradient, Adam's bound
    sd = got[0]["players"]["embedder"][0]
    for key in PRE_BN_BIASES:
        assert ((sd[key] - before["embedder"][key]).abs()
                <= adam_bound(cfg.enc_lr, before["embedder"][key])).all()


def test_gan_dp_step_matches_jax_float64():
    cfg = jdihe.GANPretrainConfig(gen_downs=GEN_DOWNS)
    init, step = jdihe.make_gan_pretrain_step(cfg)
    state = jax.device_get(init(jax.random.PRNGKey(0), image_size=S))

    def bridged(s, player):
        return gan_state_dict(s[f"{player}_params"], s[f"{player}_stats"])

    before = {"generator": bridged(state, "gen"),
              "discriminator": bridged(state, "disc")}
    _, _, gen, disc, _ = dihe_batch(False)
    ranks = start_ranks("gan_step", before=before, batch=(gen, disc),
                        cfg_kw=dict(gen_downs=GEN_DOWNS))
    with jax_float64():
        new, metrics = jax.jit(step)(state, *f64((gen, disc)))
        new = jax.device_get(new)
    after = {"generator": bridged(new, "gen"),
             "discriminator": bridged(new, "disc")}
    moments = {name: adam_moments(new[f"{p}_opt"], BRIDGE["generator"])
               for name, p in (("generator", "gen"),
                               ("discriminator", "disc"))}
    got = ranks.results()

    assert got[0]["digest"] == got[1]["digest"]
    for out in got:
        for key, value in metrics.items():
            assert out["metrics"][key] == pytest.approx(float(value),
                                                        rel=1e-4), key
    _hold_players(before, after, moments, got[0]["players"],
                  {"generator": 2, "discriminator": 2},
                  {"generator": cfg.lr, "discriminator": cfg.lr})
