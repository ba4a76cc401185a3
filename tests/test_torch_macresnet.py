"""The port's MACResNet against the JAX package's on the same weights
(flax tree -> utils/weights.py:macresnet_state_dict, BatchNorm statistics
away from the identity): f32 at c3 + c4 and at c1..c5, and the int8
static path (bf16 convs, 52 int8 stage convs) on JAX-calibrated scales,
plus the port's own calibration and EmbedFn's lifecycle for
quant='static'. 64x64 crops, numpy-seeded. Tolerances are stated per
test with what was measured."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpce_tpu.models.embedders import MACResNet as JMACResNet
from cvpce_tpu.models.quant import calibrate_act_scales as j_cal
from cvpce_tpu_torch.models.embedders import EmbedFn, MACResNet
from cvpce_tpu_torch.utils.weights import macresnet_state_dict

ALL_STAGES = ("c1", "c2", "c3", "c4", "c5")


def leaves(tree, trail=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from leaves(v, trail + (k,))
    else:
        yield trail, float(tree)


def _stats(tree, rng):
    """Seeded running statistics for every BatchNorm of a batch_stats
    tree: means N(0, 0.1), variances in [0.5, 2]."""
    if "mean" in tree:
        return {"mean": rng.normal(0, 0.1, np.shape(tree["mean"]))
                .astype(np.float32),
                "var": rng.uniform(0.5, 2.0, np.shape(tree["var"]))
                .astype(np.float32)}
    return {k: _stats(v, rng) for k, v in tree.items()}


def _affine(tree, rng):
    """Seeded BatchNorm scales in [0.5, 1.5] and biases N(0, 0.1)."""
    out = {}
    for k, v in tree.items():
        if k == "bn":
            out[k] = {"scale": rng.uniform(0.5, 1.5, np.shape(v["scale"]))
                      .astype(np.float32),
                      "bias": rng.normal(0, 0.1, np.shape(v["bias"]))
                      .astype(np.float32)}
        elif hasattr(v, "items"):
            out[k] = _affine(v, rng)
        else:
            out[k] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def setup():
    """Crops, flax (params, batch_stats) and act scales that the JAX
    package calibrated on two batches of the crops."""
    rng = np.random.default_rng(21)
    x = rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32)
    v = jax.device_get(JMACResNet().init(jax.random.PRNGKey(3), x[:1]))
    params = _affine(v["params"], rng)
    stats = _stats(v["batch_stats"], rng)
    variables = {"params": params, "batch_stats": stats}
    scales = jax.device_get(j_cal(JMACResNet(quant="calibrate"), variables,
                                  [x[:2], x[2:]]))["act_scales"]
    return x, params, stats, scales


def port_model(params, stats, **kwargs):
    model = MACResNet(**kwargs)
    model.load_state_dict(macresnet_state_dict(params, stats))
    return model


@pytest.mark.parametrize("stages", [("c3", "c4"), ALL_STAGES])
def test_macresnet_f32_matches_jax(setup, stages):
    """Unit-norm embeddings, bound 1e-5: the same f32 convolutions summed
    in another order. Measured 9.3e-8 at c1..c5."""
    x, params, stats, _ = setup
    want = np.asarray(JMACResNet(descriptor_stages=stages).apply(
        {"params": params, "batch_stats": stats}, x))
    model = port_model(params, stats, descriptor_stages=stages)
    assert model.embedding_size == want.shape[1] \
        == (1536 if stages == ("c3", "c4") else 3904)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_macresnet_int8_static_matches_jax(setup):
    """bf16 + quant='static' on JAX-calibrated scales. Bound: twice JAX's
    own bf16-to-f32 distance (the same int8 model in f32), as the bf16
    GLN and MACVGG are bounded; int8 rounding flips at .5 ties, moved by
    sums in another order, could cascade through 52 layers. Measured
    7.5e-9 against JAX's own 3.1e-3."""
    x, params, stats, scales = setup
    full = {"params": params, "batch_stats": stats, "act_scales": scales}
    want = np.asarray(JMACResNet(quant="static", dtype=jnp.bfloat16)
                      .apply(full, x))
    own = np.abs(want - np.asarray(JMACResNet(quant="static")
                                   .apply(full, x))).max()
    enc = EmbedFn(port_model(params, stats, quant="static",
                             dtype=torch.bfloat16), device="cpu")
    assert enc.needs_calibration
    enc.set_scales(scales)
    assert dict(leaves(enc.get_scales())) == dict(leaves(scales))
    got = enc(x).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 1536)
    assert np.abs(got - want).max() <= 2 * own
    assert ((got * want).sum(1) > 0.99).all()


def test_macresnet_calibration_matches_jax(setup):
    """EmbedFn(MACResNet(quant='static')) calibrates the 52 stage convs
    (not the stem), keyed as the JAX act_scales tree, to JAX's scales:
    layer1 (c2) within f32 rounding (rtol 1e-6, measured 2.4e-7). Deeper,
    calibration's per-batch dynamic scales let int8 rounding flips,
    seeded by f32 sums in another order, cascade through the layers; a
    flip at a layer's largest input moves its scale by one int8 step,
    1/127 of it. Bound: two steps, 2/127 = 1.6e-2 (measured up to
    1.4e-2, at layer4_1.conv3, with the conftest's JAX platform)."""
    x, params, stats, want = setup
    enc = EmbedFn(port_model(params, stats, quant="static"), device="cpu")
    assert enc.needs_calibration and enc.get_scales() is None
    enc.calibrate([x[:2], x[2:]])
    got, want = dict(leaves(enc.get_scales())), dict(leaves(want))
    assert set(got) == set(want) and len(got) == 52
    assert all(k[0] == "trunk" for k in got)
    assert ("trunk", "conv1", "scale") not in got  # the stem stays bf16
    for k in want:
        deep = not k[1].startswith("layer1")
        np.testing.assert_allclose(got[k], want[k],
                                   rtol=2 / 127 if deep else 1e-6,
                                   err_msg=k)


def test_embedfn_calibrates_quant_static_on_first_batch():
    """A MACResNet(quant='static') that starts serving uncalibrated
    calibrates on its first batch (as the JAX EmbedFn does for
    quant == 'static'), then keeps its scales: a second batch does not
    move them."""
    rng = np.random.default_rng(23)
    x = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    model = MACResNet(quant="static", dtype=torch.bfloat16,
                      generator=torch.Generator().manual_seed(1))
    enc = EmbedFn(model, device="cpu")
    assert enc.needs_calibration and enc.get_scales() is None
    first = enc(x)
    scales = enc.get_scales()
    assert len(list(leaves(scales))) == 52
    assert all(s > 0 for _, s in leaves(scales))
    assert torch.isfinite(first).all()
    enc(3.0 * x)
    assert enc.get_scales() == scales
    assert torch.equal(enc(x), first)
