"""The port's DIHE GAN players (models/gan.py) against the JAX package's
flax modules on bridged weights (utils/weights.py:gan_state_dict):
UNetGenerator with 3- and 4-channel input (num_downs 4 at 64 px) and
AveragingPatchGAN, in eval and in train mode, and the running statistics
one train-mode forward leaves; the ConvTranspose bridge's spatial flip;
`frozen_statistics`.

Tolerances: outputs within OUT_TOL = 1e-4 (measured 1.9e-6 in train
mode and 2.7e-7 in eval mode, identical across 16 concurrent runs; in 2
of some 20 runs under concurrent load, 1% of the masked generator's
outputs came out up to 3.9e-5 off, which no later run reproduced);
running statistics within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpce_tpu.models import gan as jgan
from cvpce_tpu_torch.models import gan as pgan
from cvpce_tpu_torch.models.resnet import BatchNorm, frozen_statistics
from cvpce_tpu_torch.utils import weights

S = 64
OUT_TOL = 1e-4
CASES = {"unet_rgb": (3, 2), "unet_masked": (4, 2), "patchgan": (3, 3)}


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads: the suite runs several workers on the CPU's
    cores, where these models' many small parallel regions slowed ten
    times with a thread per core each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _flax(name):
    return (jgan.AveragingPatchGAN if name == "patchgan"
            else lambda train: jgan.UNetGenerator(num_downs=4, train=train))


def _port(name):
    if name == "patchgan":
        return pgan.AveragingPatchGAN()
    return pgan.UNetGenerator(num_downs=4, in_channels=CASES[name][0])


@pytest.fixture(scope="module")
def flax_runs():
    """name -> (input, variables, train-mode output and statistics,
    eval-mode output on those statistics)."""
    runs = {}
    for name, (cin, b) in CASES.items():
        x = np.random.default_rng(len(name)).uniform(
            -1, 1, (b, S, S, cin)).astype(np.float32)
        make = _flax(name)
        variables = make(train=True).init(jax.random.PRNGKey(3),
                                          jnp.asarray(x))
        out, mut = make(train=True).apply(variables, x,
                                          mutable=["batch_stats"])
        evaluated = make(train=False).apply(
            {"params": variables["params"],
             "batch_stats": mut["batch_stats"]}, x)
        runs[name] = (x, jax.device_get(variables), np.asarray(out),
                      jax.device_get(mut["batch_stats"]),
                      np.asarray(evaluated))
    return runs


def _bridged(name, variables):
    model = _port(name)
    model.load_state_dict(weights.gan_state_dict(variables["params"],
                                                 variables["batch_stats"]))
    return model


@pytest.mark.parametrize("name", sorted(CASES))
def test_train_and_eval_forward_match_flax(flax_runs, name):
    x, variables, want_train, stats, want_eval = flax_runs[name]
    model = _bridged(name, variables).train()
    got = model(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want_train.shape
    np.testing.assert_allclose(got, want_train, rtol=0, atol=OUT_TOL)
    want_sd = weights.gan_state_dict(variables["params"], stats)
    moved = 0
    for key, want in want_sd.items():
        if key.endswith(("running_mean", "running_var")):
            got_stat = model.state_dict()[key]
            np.testing.assert_allclose(got_stat.numpy(), want.numpy(),
                                       rtol=0, atol=1e-6)
            moved += not torch.equal(got_stat, _port(name).state_dict()[key])
    assert moved == 2 * (3 if name == "patchgan" else 5)
    model.eval()
    np.testing.assert_allclose(model(torch.from_numpy(x)).detach().numpy(),
                               want_eval, rtol=0, atol=OUT_TOL)


@pytest.mark.parametrize("name", ["unet_masked", "unet_rgb"])
def test_unflipped_conv_transpose_bridge_fails(flax_runs, name):
    """The generator's up convolutions need flax's kernels flipped in
    both spatial axes: laid in unflipped, the output is far off."""
    x, variables, want, _, _ = flax_runs[name]
    sd = weights.gan_state_dict(variables["params"],
                                variables["batch_stats"])
    for key in sd:
        if key.startswith("up_") and key.endswith(".weight") \
                and sd[key].dim() == 4:
            sd[key] = sd[key].flip(2, 3)
    model = _port(name)
    model.load_state_dict(sd)
    got = model.train()(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - want).max() > 1e-2


def test_generator_layout_and_seeded_init():
    gen = pgan.UNetGenerator(num_downs=8, in_channels=4,
                             generator=torch.Generator().manual_seed(1))
    names = {n for n, _ in gen.named_children()}
    assert {f"down_{i}" for i in range(8)} <= names
    assert {f"down_bn_{i}" for i in range(1, 7)} <= names
    assert "down_bn_0" not in names and "down_bn_7" not in names
    assert {f"up_bn_{i}" for i in range(1, 8)} <= names
    assert gen.down_0.bias is not None and gen.up_0.bias is not None
    assert gen.down_7.bias is None and gen.up_7.bias is None
    assert gen.down_0.weight.shape == (64, 4, 4, 4)
    assert gen.up_7.weight.shape == (512, 512, 4, 4)
    assert gen.up_0.weight.shape == (128, 3, 4, 4)
    again = pgan.UNetGenerator(num_downs=8, in_channels=4,
                               generator=torch.Generator().manual_seed(1))
    for key, v in gen.state_dict().items():
        assert torch.equal(again.state_dict()[key], v), key
    x = torch.zeros(1, 256, 256, 4)
    assert gen.eval()(x).shape == (1, 256, 256, 3)


def test_gan_state_dict_refuses_other_trees():
    with pytest.raises(KeyError, match="not a GAN layer"):
        weights.gan_state_dict({"f0": {"kernel": np.zeros((4, 4, 3, 8))}},
                               {})
    with pytest.raises(KeyError, match="unexpected leaf"):
        weights.gan_state_dict({"down_0": {"weights": np.zeros(3)}}, {})


def test_frozen_statistics_keeps_running_statistics():
    """Inside `frozen_statistics` a train-mode BatchNorm normalises by
    its batch, as it does outside, and leaves its running statistics and
    counter alone; nested modules are reached and the flag comes back."""
    x = torch.from_numpy(np.random.default_rng(4).normal(
        2.0, 3.0, (2, 5, 6, 7)).astype(np.float32))
    outer = torch.nn.Sequential(torch.nn.Identity(), BatchNorm(5)).train()
    bn = outer[1]
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    with frozen_statistics(outer):
        frozen = bn(x)
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert bn.update_stats
    updated = bn(x)
    assert torch.equal(frozen, updated)
    assert int(bn.num_batches_tracked) == 1
    assert not torch.equal(bn.running_mean, before["running_mean"])
