"""The port's int8-static serving models against the JAX package's on
the same weights and on JAX-calibrated act scales carried through the
weight bridge: MACVGG(int8_all, int8_static) on folded BN at 64x64
crops, and the GLN with int8='static' at a 128x192 canvas, in f32 and in
bf16 (the bf16 GLN also with its backbone folded, as the int8 serving
preset runs). Tolerances are stated per test with their reason."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpce_tpu.models.embedders import MACVGG as JMACVGG
from cvpce_tpu.models.embedders import calibrate_int8_scales as j_cal_vgg
from cvpce_tpu.models.embedders import fold_bn_variables as j_fold_bn
from cvpce_tpu.models.gln import GLN as JGLN
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.models.gln import fold_gln_backbone as j_fold_gln
from cvpce_tpu.models.quant import calibrate_act_scales as j_cal
from cvpce_tpu_torch.models.embedders import MACVGG, EmbedFn
from cvpce_tpu_torch.models.gln import GLN, GLNConfig
from cvpce_tpu_torch.models.quant import act_scale_tree
from cvpce_tpu_torch.utils.weights import (gln_state_dict, load_act_scales,
                                           macvgg_state_dict)

H, W = 128, 192


def leaves(tree, trail=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from leaves(v, trail + (k,))
    else:
        yield trail, float(tree)


@pytest.fixture(scope="module")
def vgg_setup():
    """Folded-BN MACVGG weights (JAX init with random BN statistics) and
    act scales calibrated by the JAX package on two batches."""
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (6, 64, 64, 3)).astype(np.float32)
    bn = JMACVGG(batch_norm=True)
    v = jax.device_get(bn.init(jax.random.PRNGKey(2), x[:1]))
    stats = {k: {"mean": rng.normal(0, 0.1, np.shape(s["mean"]))
                 .astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, np.shape(s["var"]))
                 .astype(np.float32)}
             for k, s in v["batch_stats"].items()}
    folded = jax.device_get(j_fold_bn({"params": v["params"],
                                       "batch_stats": stats}))
    cal = JMACVGG(batch_norm=False, int8_all=True, int8_calibrate=True)
    scales = jax.device_get(j_cal_vgg(cal, folded, [x[:3], x[3:]]))
    return x, folded["params"], scales["act_scales"]


def port_vgg(params, dtype):
    model = MACVGG(batch_norm=False, int8_all=True, int8_static=True,
                   dtype=dtype)
    model.load_state_dict(macvgg_state_dict(params, {}))
    return model


def test_macvgg_calibration_matches_jax(vgg_setup):
    """The port calibrates the same 12 layers to the same scales. f32:
    the first int8 layer's input comes from an f32 conv summed in
    another order, so through conv4_1 (f17) the scales agree to f32
    rounding; deeper, calibration's per-batch dynamic scales let the
    rounding flips cascade (measured up to 0.7% apart at f28)."""
    x, params, want = vgg_setup
    enc = EmbedFn(port_vgg(params, torch.float32), device="cpu")
    assert enc.needs_calibration and enc.get_scales() is None
    enc.calibrate([x[:3], x[3:]])
    got = dict(leaves(enc.get_scales()))
    want = dict(leaves(want))
    assert set(got) == set(want) and len(got) == 12
    assert ("f0", "scale") not in got  # conv1_1 stays in compute dtype
    for k in want:
        deep = int(k[0][1:]) > 17
        np.testing.assert_allclose(got[k], want[k],
                                   rtol=1e-2 if deep else 1e-6, err_msg=k)


@pytest.mark.parametrize("dtype,atol", [
    # on unit-norm embeddings. f32: the same int8 numerics in the same
    # order of rounding; measured 4.5e-8 apart
    ("float32", 1e-4),
    # bf16: measured 1.5e-8 apart; the bound leaves room for one int8
    # rounding moved across a .5 tie by conv1_1's bf16 sums in another
    # order, a flip that cascades through the 12 int8 layers
    ("bfloat16", 1e-2),
])
def test_macvgg_int8_static_matches_jax(vgg_setup, dtype, atol):
    x, params, scales = vgg_setup
    jdt = jnp.dtype(dtype)
    want = np.asarray(JMACVGG(batch_norm=False, int8_all=True,
                              int8_static=True, dtype=jdt).apply(
        {"params": params, "act_scales": scales}, x))
    model = port_vgg(params, getattr(torch, dtype))
    load_act_scales(model, scales)
    assert act_scale_tree(model) == {
        k: {"scale": float(v["scale"])} for k, v in scales.items()}
    enc = EmbedFn(model, device="cpu")
    enc.set_scales(scales)
    got = enc(x).numpy()
    assert got.dtype == np.float32 and got.shape == (6, 1024)
    np.testing.assert_allclose(got, want, atol=atol)
    assert ((got * want).sum(1) > 0.9999).all()
    # each port embedding finds its own JAX twin as top-1 in the gallery
    # of the JAX embeddings, as the JAX embedding does
    np.testing.assert_array_equal(np.argmax(got @ want.T, 1),
                                  np.argmax(want @ want.T, 1))


@pytest.fixture(scope="module")
def gln_setup():
    """GLN variables (JAX init, random FrozenBN statistics), the seeded
    input, and the JAX-calibrated act scales of the int8 GLN."""
    cfg = JGLNConfig(canvas_h=H, canvas_w=W, fold_gaussian_upsample=False)
    x = np.random.default_rng(12).uniform(0, 1, (2, H, W, 3)).astype(
        np.float32)
    variables = jax.device_get(JGLN(config=cfg).init(
        jax.random.PRNGKey(3), x[:1]))
    rng = np.random.default_rng(13)

    def perturb(t, name=""):
        if hasattr(t, "items"):
            return {k: perturb(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a

    variables = {"params": variables["params"],
                 "frozen": perturb(variables["frozen"]),
                 "batch_stats": perturb(variables["batch_stats"])}
    cal = JGLN(config=dataclasses.replace(cfg, int8="calibrate"))
    scales = jax.device_get(j_cal(cal, variables, [x]))["act_scales"]
    return cfg, variables, scales, x


@pytest.mark.parametrize("dtype,fold,rel", [
    # relative to each output's largest magnitude. f32: the same int8
    # numerics; f32 convs summed in another order (measured <= 4e-6)
    ("float32", False, 1e-4),
    # the serving preset: bf16 rounds where XLA's does, but the Gaussian
    # branch's BatchNorm computes in another order (measured 1.0e-2 on
    # gaussians, 7.5e-5 on bbox_regression, 0 on cls_logits)
    ("bfloat16", True, 2e-2),
])
def test_gln_int8_static_matches_jax(gln_setup, dtype, fold, rel):
    cfg, variables, scales, x = gln_setup
    jcfg = dataclasses.replace(cfg, int8="static", compute_dtype=dtype,
                               fold_backbone_fbn=fold)
    jvars = j_fold_gln(variables) if fold else variables
    want = jax.device_get(JGLN(config=jcfg).apply(
        {**jvars, "act_scales": scales}, x))
    model = GLN(GLNConfig(canvas_h=H, canvas_w=W, int8="static",
                          compute_dtype=dtype, fold_backbone_fbn=fold))
    model.load_state_dict(gln_state_dict(jvars))
    load_act_scales(model, scales)
    assert len(list(leaves(act_scale_tree(model)))) == 68
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("cls_logits", "bbox_regression", "gaussians"):
        w = np.asarray(want[key], np.float32)
        g = got[key].numpy()
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=rel * np.abs(w).max(),
                                   err_msg=key)
