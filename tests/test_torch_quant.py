"""The port's int8 conv path against the JAX package: Int8Conv in its
three modes (models/quant.py), calibrate_act_scales, the plain fused
pool -> int8 conv (ops/conv_fused.py) against the Pallas kernel in
interpret mode, and the FrozenBN folds. Inputs are seeded numpy arrays
handed to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn

from cvpce_tpu.models import quant as jq
from cvpce_tpu.models.gln import GLN as JGLN
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.models.gln import fold_gln_backbone as j_fold_gln
from cvpce_tpu.models.resnet import ResNet50 as JResNet50
from cvpce_tpu.models.resnet import fold_frozen_bn as j_fold_fbn
from cvpce_tpu.ops.conv_pallas import fused_pool_int8_conv as j_fused
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.models.gln import GLN, GLNConfig, fold_gln_backbone
from cvpce_tpu_torch.models.quant import (Int8Conv, act_scale_tree,
                                          calibrate_act_scales)
from cvpce_tpu_torch.models.resnet import ResNet50, fold_frozen_bn
from cvpce_tpu_torch.ops.conv_fused import (fused_pool_int8_conv,
                                            pool_int8_conv_plain)
from cvpce_tpu_torch.utils.weights import gln_state_dict

# (kernel, stride, cin, cout): the GLN's 3x3 / 1x1 sites, strided too
CONV_SITES = [(3, 1, 16, 24), (1, 1, 32, 16), (1, 2, 16, 32),
              (3, 2, 24, 16)]


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def pair(kernel, stride, cin, cout, mode, w, b):
    """The JAX Int8Conv and the port's on the same HWIO kernel w and
    bias b."""
    jmod = jq.Int8Conv(cout, (kernel, kernel), (stride, stride),
                       ((kernel // 2,) * 2,) * 2, dtype=jnp.float32,
                       static_scale=mode == "static",
                       calibrate=mode == "calibrate")
    tmod = Int8Conv(cin, cout, kernel, stride, mode=mode)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        tmod.bias.copy_(torch.from_numpy(b))
    return jmod, tmod


@pytest.mark.parametrize("kernel,stride,cin,cout", CONV_SITES)
def test_int8conv_accumulators_bit_equal(kernel, stride, cin, cout):
    """Integer kernels whose per-channel max is 127 quantize to
    themselves (w_scale 1) and a static act scale of 1 makes the
    output the int32 accumulator itself (exact in f32 below 2^24), so
    the JAX module's output is its accumulator: equal bit for bit."""
    rng = np.random.default_rng(kernel * 10 + stride)
    w = rng.integers(-127, 128, (kernel, kernel, cin, cout)).astype(
        np.float32)
    w[0, 0, 0, :] = 127.0
    b = np.zeros(cout, np.float32)
    x = rng.uniform(-150, 150, (2, 12, 10, cin)).astype(np.float32)
    jmod, tmod = pair(kernel, stride, cin, cout, "static", w, b)
    want = np.asarray(jmod.apply(
        {"params": {"kernel": w, "bias": b},
         "act_scales": {"scale": np.float32(1.0)}}, x))
    tmod.act_scale.fill_(1.0)
    with torch.no_grad():
        acc, a_scale = tmod.accumulate(
            torch.from_numpy(x).permute(0, 3, 1, 2))
    assert float(a_scale) == 1.0 and acc.dtype == torch.int32
    np.testing.assert_array_equal(nhwc(acc), want.astype(np.int64))


@pytest.mark.parametrize("mode", ["dynamic", "static", "calibrate"])
@pytest.mark.parametrize("kernel,stride,cin,cout", CONV_SITES[:2])
def test_int8conv_modes_match_jax(kernel, stride, cin, cout, mode):
    """Random f32 kernel, bias and input: the output at dtype f32 is
    within 1 f32 ulp of the JAX module's (the two take the same int32
    accumulators through the same f32 epilogue), and calibrate records
    the same scale."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((kernel, kernel, cin, cout)) * 0.1).astype(
        np.float32)
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 9, 11, cin)).astype(np.float32)
    jmod, tmod = pair(kernel, stride, cin, cout, mode, w, b)
    variables = {"params": {"kernel": w, "bias": b}}
    if mode == "static":
        variables["act_scales"] = {"scale": np.float32(0.021)}
        tmod.act_scale.fill_(0.021)
    if mode == "calibrate":
        variables["act_scales"] = {"scale": np.float32(0.0)}
        want, mut = jmod.apply(variables, x, mutable=["act_scales"])
    else:
        want = jmod.apply(variables, x)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.dtype == torch.float32
    np.testing.assert_array_max_ulp(nhwc(got), np.asarray(want), maxulp=1)
    if mode == "calibrate":
        assert float(tmod.act_scale) == float(mut["act_scales"]["scale"])


class _JTwo(jnn.Module):
    @jnn.compact
    def __call__(self, x):
        x = jnn.relu(jq.Int8Conv(16, dtype=jnp.float32, calibrate=True,
                                 name="a")(x))
        return jq.Int8Conv(8, dtype=jnp.float32, calibrate=True,
                           name="b")(x)


class _TTwo(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = Int8Conv(4, 16, 3, mode="static")
        self.b = Int8Conv(16, 8, 3, mode="static")

    def forward(self, x):
        return self.b(torch.relu(self.a(x)))


def test_calibrate_act_scales_matches_jax():
    """Running max over two batches, layer by layer, keyed like the JAX
    collection; the modes come back as they were."""
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal((2, 10, 10, 4)).astype(np.float32) * s
          for s in (1.0, 3.0)]
    jm = _JTwo()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), xs[0]))
    want = jq.calibrate_act_scales(jm, {"params": variables["params"]},
                                   [jnp.asarray(x) for x in xs])
    tm = _TTwo()
    with torch.no_grad():
        for name in ("a", "b"):
            p = variables["params"][name]
            getattr(tm, name).weight.copy_(torch.from_numpy(
                np.array(p["kernel"]).transpose(3, 2, 0, 1)))
            getattr(tm, name).bias.copy_(torch.from_numpy(
                np.array(p["bias"])))
    got = calibrate_act_scales(
        tm, [torch.from_numpy(x).permute(0, 3, 1, 2) for x in xs])
    assert tm.a.mode == tm.b.mode == "static"
    assert got == act_scale_tree(tm)
    assert set(got) == set(want["act_scales"]) == {"a", "b"}
    for name in ("a", "b"):
        # layer a sees the same input (exact); b the outputs of a, equal
        # to within 1 ulp (test above), so at most 1 ulp apart
        np.testing.assert_allclose(
            got[name]["scale"], float(want["act_scales"][name]["scale"]),
            rtol=2.4e-7, atol=0)


def bf16_ulp(v):
    """The spacing of bf16 numbers at |v|: 2**(floor(log2|v|) - 7), and
    the subnormal step 2**-133 at 0 and below the normal range."""
    _, exp = np.frexp(v)  # v = m * 2**exp with 0.5 <= |m| < 1
    ulp = np.maximum(np.ldexp(1.0, exp - 8), 2.0 ** -133)
    return np.where(v == 0, 2.0 ** -133, ulp)


def _make_site(cin, cout, hw, seed=0):
    """tests/test_conv_pallas.py:_make: bf16 activations in [0, 3],
    per-channel quantized kernel, dequant scale a_scale * w_scale."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 3, (2, hw, hw, cin)).astype(np.float32)
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    k = (rng.standard_normal((3, 3, cin, cout)) * 0.05).astype(np.float32)
    w_scale = np.maximum(np.abs(k).max((0, 1, 2)), 1e-8) / np.float32(127)
    kq = np.clip(np.round(k / w_scale), -127, 127).astype(np.int8)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    a_scale = np.float32(3.0 / 127.0)
    return x, kq, a_scale, (a_scale * w_scale).astype(np.float32), bias


# the shapes of tests/test_conv_pallas.py: multi-strip, single-strip and
# the Cin = 64 tap-pair packing of the TPU kernel
@pytest.mark.parametrize("cin,cout,hw", [(64, 128, 64), (128, 256, 32),
                                         (256, 512, 64)])
def test_pool_int8_conv_plain_matches_pallas(cin, cout, hw):
    x, kq, a_scale, scale, bias = _make_site(cin, cout, hw)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    tkq = torch.from_numpy(kq)
    # accumulators: the Pallas kernel's through an identity dequant
    # (exact in f32 below 2^24), the port's as int32 -- equal bit for bit
    want_acc = np.asarray(j_fused(
        jx, jnp.asarray(kq), a_scale, jnp.ones(cout), jnp.zeros(cout),
        fuse_relu=False, out_dtype=jnp.float32, interpret=True))
    got_acc = fused_pool_int8_conv(tx, tkq, float(a_scale),
                                   torch.ones(cout), torch.zeros(cout),
                                   out_dtype=torch.int32)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy().astype(np.int64),
                                  want_acc.astype(np.int64))
    # bf16 output with ReLU: within 1 bf16 ulp (fma association in the
    # TPU kernel's epilogue), as tests/test_conv_pallas.py holds it
    want = np.asarray(j_fused(jx, jnp.asarray(kq), a_scale,
                              jnp.asarray(scale), jnp.asarray(bias),
                              fuse_relu=True, interpret=True),
                      np.float32)
    got = pool_int8_conv_plain(tx, tkq, float(a_scale),
                               torch.from_numpy(scale),
                               torch.from_numpy(bias), fuse_relu=True)
    assert got.dtype == torch.bfloat16 and (got >= 0).all()
    got = got.float().numpy()
    assert np.all(np.abs(got - want) <= bf16_ulp(want))
    assert (got == want).mean() > 0.999


# the K4 edge cases of cvpce_tpu_torch/testing.py where rounding could
# differ: pooled values exactly halfway between two int8 steps, values
# that saturate at +-127, all-negative inputs (Cin = 64: the accumulators
# stay below 2^24, so the Pallas kernel's f32 output holds them exactly)
@pytest.mark.parametrize("case", ["ties", "saturate", "negative"])
def test_pool_int8_conv_plain_matches_pallas_on_edge_cases(case):
    x, kq, a_scale, _, _ = testing.pool_case(case, np.random.default_rng(5))
    b, h, w, cin = x.shape
    cout = kq.shape[3]
    pooled = x.reshape(b, h // 2, 2, w // 2, 2, cin).max((2, 4)) \
        / np.float32(a_scale)
    if case == "ties":
        assert np.all(pooled % 1 == 0.5)
    elif case == "saturate":
        assert (np.abs(pooled) > 127.5).mean() > 0.5
    else:
        assert (pooled < 0).all()
    want_acc = np.asarray(j_fused(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(kq),
        np.float32(a_scale), jnp.ones(cout), jnp.zeros(cout),
        fuse_relu=False, out_dtype=jnp.float32, interpret=True))
    got_acc = pool_int8_conv_plain(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(kq),
        a_scale, torch.ones(cout), torch.zeros(cout), out_dtype=torch.int32)
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy().astype(np.int64),
                                  want_acc.astype(np.int64))


def test_pool_int8_conv_flags():
    x, kq, a_scale, scale, bias = _make_site(64, 128, 32, seed=1)
    args = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(kq),
            float(a_scale), torch.from_numpy(scale), torch.from_numpy(bias))
    y = pool_int8_conv_plain(*args, fuse_relu=False, out_dtype=torch.float32)
    assert y.dtype == torch.float32 and (y < 0).any()
    assert y.shape == (2, 16, 16, 128)
    before = fused_pool_int8_conv.launches
    torch.testing.assert_close(fused_pool_int8_conv(*args),
                               pool_int8_conv_plain(*args), rtol=0, atol=0)
    assert fused_pool_int8_conv.launches == before  # CPU: plain, no launch


def _randomize_fbn(tree, rng):
    if hasattr(tree, "items"):
        if "fbn" in tree:
            n = np.asarray(tree["fbn"]["scale"]).shape[0]
            return {"fbn": {
                "scale": rng.uniform(0.5, 2.0, n).astype(np.float32),
                "bias": rng.normal(0, 0.5, n).astype(np.float32),
                "mean": rng.normal(0, 0.5, n).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, n).astype(np.float32)}}
        return {k: _randomize_fbn(v, rng) for k, v in tree.items()}
    return tree


def test_fold_frozen_bn_matches_jax_fold():
    """The port's fold of a FrozenBN trunk equals the JAX fold bit for
    bit, and the folded twin computes what the FrozenBN trunk does."""
    jm = JResNet50(norm="frozen")
    variables = jax.device_get(jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = {"params": variables["params"],
                 "frozen": _randomize_fbn(variables["frozen"],
                                          np.random.default_rng(1))}
    want = gln_state_dict(j_fold_fbn(variables))
    got = fold_frozen_bn(gln_state_dict(variables))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    model = ResNet50()
    model.load_state_dict(gln_state_dict(variables))
    folded = ResNet50(norm="none", conv_bias=True)
    folded.load_state_dict(got)
    x = torch.from_numpy(np.random.default_rng(2).random(
        (2, 3, 64, 96)).astype(np.float32))
    with torch.no_grad():
        ref, out = model(x), folded(x)
    for tap in ("c1", "c2", "c3", "c4", "c5"):
        # f32 rounding of the fold, as tests/test_resnet_fold.py bounds it
        torch.testing.assert_close(out[tap], ref[tap], rtol=2e-4, atol=2e-4)


def test_fold_gln_backbone_matches_jax():
    cfg = JGLNConfig(canvas_h=64, canvas_w=64)
    variables = jax.device_get(JGLN(config=cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3), jnp.float32)))
    variables = dict(variables)
    variables["frozen"] = _randomize_fbn(variables["frozen"],
                                         np.random.default_rng(3))
    want = gln_state_dict(j_fold_gln(variables))
    got = fold_gln_backbone(gln_state_dict(variables))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    GLN(GLNConfig(canvas_h=64, canvas_w=64, fold_backbone_fbn=True)) \
        .load_state_dict(got)
