"""The port's models against the JAX modules on the same weights (JAX
random init handed over through the weight bridge) and the same seeded
numpy inputs: ResNet-50, FPN, the GLN detector at a 128x192 canvas,
detection postprocess fed the same head outputs, and MACVGG at 64x64
crops. f32 throughout; tolerances are f32 summation-order noise scaled
to each output's magnitude."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpce_tpu.models.embedders import MACVGG as JMACVGG
from cvpce_tpu.models.embedders import fold_bn_variables as j_fold_bn
from cvpce_tpu.models.fpn import FPN as JFPN
from cvpce_tpu.models.gln import GLN as JGLN
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.models.gln import postprocess_detections as j_post
from cvpce_tpu.models.resnet import ResNet50 as JResNet50
from cvpce_tpu_torch.models.embedders import (MACVGG, EmbedFn,
                                              fold_bn_state_dict,
                                              fold_bn_variables)
from cvpce_tpu_torch.models.gln import GLN, GLNConfig, postprocess_detections
from cvpce_tpu_torch.utils.weights import gln_state_dict, macvgg_state_dict

H, W = 128, 192


def nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def assert_close(got, want, rel=1e-4):
    """|got - want| <= rel * max|want| elementwise (f32 sums of
    hundreds of terms in another order)."""
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else got
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max())


def perturb(tree, seed):
    """Random (not identity) FrozenBN/BN statistics so the bridge's
    mapping of every leaf is exercised."""
    rng = np.random.default_rng(seed)

    def walk(t, name=""):
        if hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return a
    return walk(tree)


@pytest.fixture(scope="module")
def jax_gln():
    cfg = JGLNConfig(canvas_h=H, canvas_w=W)
    model = JGLN(config=cfg, train=False)
    x = np.random.default_rng(0).uniform(0, 1, (2, H, W, 3)).astype(
        np.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(0), x[:1]))
    variables = {"params": variables["params"],
                 "frozen": perturb(variables["frozen"], 1),
                 "batch_stats": perturb(variables["batch_stats"], 2)}
    out = jax.device_get(jax.jit(model.apply)(variables, x))
    return cfg, variables, x, out


@pytest.fixture(scope="module")
def torch_gln(jax_gln):
    _, variables, x, _ = jax_gln
    model = GLN(GLNConfig(canvas_h=H, canvas_w=W))
    model.load_state_dict(gln_state_dict(variables))
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    return model, out


def test_resnet50_stages_match_jax(jax_gln, torch_gln):
    _, variables, x, _ = jax_gln
    model, _ = torch_gln
    want = JResNet50(norm="frozen").apply(
        {"params": variables["params"]["body"],
         "frozen": variables["frozen"]["body"]}, x[:1])
    with torch.no_grad():
        got = model.body(nchw(x[:1]))
    for name in ("c1", "c2", "c3", "c4", "c5"):
        assert_close(got[name].permute(0, 2, 3, 1), want[name])


def test_fpn_matches_jax(jax_gln, torch_gln):
    _, variables, _, _ = jax_gln
    model, _ = torch_gln
    rng = np.random.default_rng(3)
    cs = [rng.normal(size=(1, H // s, W // s, c)).astype(np.float32)
          for s, c in ((8, 512), (16, 1024), (32, 2048))]
    want = JFPN().apply({"params": variables["params"]["fpn"]}, *cs)
    with torch.no_grad():
        got = model.fpn(*(nchw(c) for c in cs))
    for g, w in zip(got, want):
        assert_close(g.permute(0, 2, 3, 1), w)


@pytest.mark.parametrize("key", ["cls_logits", "bbox_regression",
                                 "gaussians"])
def test_gln_head_outputs_match_jax(jax_gln, torch_gln, key):
    """Full detector forward, including the Gaussian branch in its plain
    upsample->conv form against the JAX folded form."""
    _, _, _, want = jax_gln
    _, got = torch_gln
    assert_close(got[key], want[key])


def synthetic_head_outputs(seed, anchors_total, b=2):
    """Head outputs with a spread of scores: thousands of candidates
    above the 0.05 threshold, clustered boxes for NMS to resolve."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(-2.0, 2.0, (b, anchors_total, 1)).astype(np.float32)
    regs = rng.normal(0.0, 0.3, (b, anchors_total, 4)).astype(np.float32)
    return {"cls_logits": logits, "bbox_regression": regs}


@pytest.mark.parametrize("seed", [0, 1])
def test_postprocess_matches_jax_on_same_head_outputs(seed):
    jcfg = JGLNConfig(canvas_h=H, canvas_w=W, detections_per_img=300)
    cfg = GLNConfig(canvas_h=H, canvas_w=W, detections_per_img=300)
    anchors, counts = cfg.anchors()
    outs = synthetic_head_outputs(seed, len(anchors))
    sizes = np.array([[H, W], [100, 150]], np.float32)
    want = jax.device_get(j_post(outs, jnp.asarray(anchors), counts,
                                 jnp.asarray(sizes), jcfg))
    got = postprocess_detections(
        {k: torch.from_numpy(v) for k, v in outs.items()},
        torch.from_numpy(anchors), counts, torch.from_numpy(sizes), cfg)
    assert int(got["num_candidates"].min()) > 1000
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    # same kept boxes in the same order; the two sigmoids differ by up
    # to one f32 ulp
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=0, atol=1.2e-7)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"],
                               atol=1e-4)


def test_postprocess_candidates_report_nms_io():
    cfg = GLNConfig(canvas_h=H, canvas_w=W, detections_per_img=300)
    anchors, counts = cfg.anchors()
    outs = synthetic_head_outputs(2, len(anchors), b=1)
    res = postprocess_detections(
        {k: torch.from_numpy(v) for k, v in outs.items()},
        torch.from_numpy(anchors), counts, torch.tensor([[H, W]]), cfg,
        return_candidates=True)
    assert int(res["cand_valid"].sum()) == int(res["num_candidates"][0])
    assert int(res["keep"].sum()) >= int(res["valid"].sum())


@pytest.fixture(scope="module")
def macvgg_pair():
    x = np.random.default_rng(4).uniform(-1, 1, (3, 64, 64, 3)).astype(
        np.float32)
    jm = JMACVGG(batch_norm=True)
    v = jax.device_get(jm.init(jax.random.PRNGKey(1), x[:1]))
    stats = perturb(v["batch_stats"], 5)
    params = {k: (perturb(p, 6) if "scale" in p else p)
              for k, p in v["params"].items()}
    want = jax.device_get(jm.apply(
        {"params": params, "batch_stats": stats}, x))
    model = MACVGG(batch_norm=True)
    model.load_state_dict(macvgg_state_dict(params, stats))
    return x, params, stats, want, model


def test_macvgg_matches_jax(macvgg_pair):
    x, _, _, want, model = macvgg_pair
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (3, 1024)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)  # unit norm


def test_fold_bn_matches_jax_fold(macvgg_pair):
    x, params, stats, want, model = macvgg_pair
    folded_j = j_fold_bn({"params": params, "batch_stats": stats})
    folded_t = fold_bn_state_dict(model.state_dict())
    for name, leaf in folded_j["params"].items():
        idx = name[1:]
        np.testing.assert_allclose(
            folded_t[f"features.{idx}.weight"].permute(2, 3, 1, 0).numpy(),
            np.asarray(leaf["kernel"]), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(folded_t[f"features.{idx}.bias"].numpy(),
                                   np.asarray(leaf["bias"]), rtol=1e-5,
                                   atol=1e-6)
    fn = EmbedFn(fold_bn_variables(model), device="cpu")
    np.testing.assert_allclose(fn(x).numpy(), want, atol=1e-5)
    assert fn.embedding_size == 1024


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmbedFn(MACVGG(batch_norm=False))
