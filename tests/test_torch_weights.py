"""The weight bridge on the trained exports in artifacts/: gln_r5 (GLN
detector) and dihe_r4 (MACVGG encoder), loaded through the JAX package's
serving loaders and handed to the port as numpy trees. The port's
forward on the bridged weights is held against the JAX forward on the
same weights and inputs."""
import jax
import numpy as np
import pytest
import torch

from cvpce_tpu.models.embedders import MACVGG as JMACVGG
from cvpce_tpu.models.gln import GLN as JGLN
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.pipeline.serving import load_dihe_encoder, load_gln_variables
from cvpce_tpu_torch.models.embedders import MACVGG
from cvpce_tpu_torch.models.gln import GLN, GLNConfig
from cvpce_tpu_torch.utils.weights import gln_state_dict, macvgg_state_dict

H, W = 128, 192


def flat(tree, trail=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from flat(v, trail + (k,))
    else:
        yield trail, np.asarray(tree)


@pytest.fixture(scope="module")
def gln_r5():
    return jax.device_get(load_gln_variables("artifacts/gln_r5"))


@pytest.fixture(scope="module")
def dihe_r4():
    return jax.device_get(load_dihe_encoder("artifacts/dihe_r4"))


def test_gln_bridge_covers_every_leaf(gln_r5):
    sd = gln_state_dict(gln_r5)
    model = GLN(GLNConfig(canvas_h=H, canvas_w=W))
    model.load_state_dict(sd, strict=True)
    n_leaves = sum(1 for c in gln_r5.values() for _ in flat(c))
    n_bn = sum(1 for k in sd if k.endswith("num_batches_tracked"))
    assert len(sd) == n_leaves + n_bn
    kernel = gln_r5["params"]["head"]["cls_logits"]["kernel"]
    np.testing.assert_array_equal(sd["head.cls_logits.weight"].numpy(),
                                  np.asarray(kernel).transpose(3, 2, 0, 1))
    fbn = gln_r5["frozen"]["body"]["layer3_2"]["bn2"]["fbn"]
    np.testing.assert_array_equal(
        sd["body.layer3_2.bn2.running_var"].numpy(), fbn["var"])


def test_gln_r5_forward_matches_jax(gln_r5):
    x = np.random.default_rng(0).uniform(0, 1, (1, H, W, 3)).astype(
        np.float32)
    want = jax.device_get(jax.jit(
        JGLN(config=JGLNConfig(canvas_h=H, canvas_w=W)).apply)(gln_r5, x))
    model = GLN(GLNConfig(canvas_h=H, canvas_w=W))
    model.load_state_dict(gln_state_dict(gln_r5))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    for key in ("cls_logits", "bbox_regression", "gaussians"):
        w = np.asarray(want[key])
        # f32 convolutions summed in another order, 60+ layers deep
        np.testing.assert_allclose(got[key].numpy(), w,
                                   atol=1e-4 * np.abs(w).max())


def test_dihe_r4_bridge_and_forward_match_jax(dihe_r4):
    params, stats = dihe_r4
    sd = macvgg_state_dict(params, stats)
    model = MACVGG(batch_norm=True)
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(sd["features.1.running_mean"].numpy(),
                                  stats["f1"]["mean"])
    x = np.random.default_rng(1).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    want = JMACVGG(batch_norm=True).apply(
        {"params": params, "batch_stats": stats}, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-5)  # unit-norm descriptors
