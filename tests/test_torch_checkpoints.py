"""The port's reference-checkpoint bridge against the JAX package's:
`utils/torch_import.py` against `weights.*_state_dict(ti.import_*(sd))`
(the JAX importers, then the flax->torch bridge), bit for bit; the
seeded builders of `cvpce_tpu_torch.testing` against the JAX tests'
builders; and `cli/common.py`'s loaders against JAX's `load_embedder`
and `load_gln_variables` on torch.save'd files, nested under
`model_state_dict` and with `module.` prefixes."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpce_tpu.cli import common as j_common
from cvpce_tpu.models.gln import GLNConfig as JGLNConfig
from cvpce_tpu.utils import torch_import as ti
from cvpce_tpu_torch import testing
from cvpce_tpu_torch.cli import common
from cvpce_tpu_torch.models.embedders import MACResNet, MACVGG
from cvpce_tpu_torch.models.gln import GLN, GLNConfig
from cvpce_tpu_torch.utils import torch_import as pti
from cvpce_tpu_torch.utils import weights
from tests.test_checkpoint_import import make_gln_state_dict
from tests.test_model_parity import (make_resnet50_state_dict,
                                     make_vgg16bn_state_dict)

CANVAS = dict(canvas_h=64, canvas_w=64)


def assert_same(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("name,port,jax_builder", [
    ("resnet50", testing.resnet50_state_dict, make_resnet50_state_dict),
    ("vgg16_bn", testing.vgg16_features_state_dict, make_vgg16bn_state_dict),
    ("gln", testing.gln_reference_state_dict, make_gln_state_dict)])
def test_builders_match_jax_tests_builders(name, port, jax_builder):
    """Same keys, shapes and (same draw order) values."""
    assert_same(port(np.random.default_rng(4)),
                jax_builder(np.random.default_rng(4)))


def test_macvgg_slices_match_the_jax_test_layout():
    """tests/test_checkpoint_import.py slices vgg16_bn features at 33 and
    43 into block1 / block2, renumbered from 0; without BN the cut is at
    23 and block 5 ends at 30."""
    full = make_vgg16bn_state_dict(np.random.default_rng(5))
    want = {}
    for k, v in full.items():
        idx, tail = int(k.split(".")[1]), k.split(".", 2)[2]
        if idx < 33:
            want[f"block1.{idx}.{tail}"] = v
        elif idx < 43:
            want[f"block2.{idx - 33}.{tail}"] = v
    assert_same(testing.macvgg_reference_state_dict(
        np.random.default_rng(5)), want)
    plain = testing.macvgg_reference_state_dict(np.random.default_rng(5),
                                                batch_norm=False)
    assert max(int(k.split(".")[1]) for k in plain
               if k.startswith("block1.")) == 21
    assert {k for k in plain if k.startswith("block2.")} == {
        f"block2.{i}.{leaf}" for i in (1, 3, 5) for leaf in ("weight",
                                                             "bias")}


def test_import_gln_matches_jax_bridge():
    sd = testing.gln_reference_state_dict(np.random.default_rng(6))
    got = pti.import_gln(sd)
    assert_same(got, weights.gln_state_dict(ti.import_gln(sd)))
    assert set(got) == set(GLN(GLNConfig(**CANVAS)).state_dict())


@pytest.mark.parametrize("norm", ["frozen", "batch"])
def test_import_resnet50_matches_jax_bridge(norm):
    sd = testing.resnet50_state_dict(np.random.default_rng(7))
    got = pti.import_resnet50(sd, norm, prefix="trunk.")
    imported = ti.import_resnet50(sd, norm=norm, flax_prefix=["trunk"])
    if norm == "batch":
        want = weights.macresnet_state_dict(imported["params"],
                                            imported["batch_stats"])
        assert set(got) == set(MACResNet().state_dict())
    else:
        want = weights.gln_state_dict(imported)
    assert_same(got, want)


@pytest.mark.parametrize("batch_norm", [True, False])
def test_import_vgg16_features_matches_jax_bridge(batch_norm):
    sd = testing.vgg16_features_state_dict(np.random.default_rng(8),
                                           batch_norm)
    got = pti.import_vgg16_features(sd, batch_norm)
    imported = ti.import_vgg16_features(sd, batch_norm=batch_norm)
    assert_same(got, weights.macvgg_state_dict(
        imported["params"], imported.get("batch_stats", {})))
    assert set(got) == set(MACVGG(batch_norm=batch_norm).state_dict())


def test_load_state_dict_unwraps_as_jax_does(tmp_path):
    """`state_dict` / `model_state_dict` nesting, `model` nesting and a
    leading `module.` are undone, as by the JAX package's reader."""
    sd = {"a.weight": torch.ones(2), "b.bias": torch.zeros(3)}
    cases = {"flat": sd,
             "nested": {"model_state_dict": sd, "epoch": 3},
             "state": {"state_dict": {f"module.{k}": v
                                      for k, v in sd.items()}},
             "model": {"model": sd, "optimizer": {}}}
    for name, obj in cases.items():
        path = str(tmp_path / f"{name}.pth")
        torch.save(obj, path)
        got = pti.load_state_dict(path)
        assert_same(got, ti.load_state_dict(path))
        assert_same(got, sd)


def _save_nested(path, sd, prefix):
    torch.save({"model_state_dict": {prefix + k: v for k, v in sd.items()},
                "epoch": 1}, str(path))


def test_load_gln_state_dict_matches_jax(tmp_path):
    """The port's GLN state_dict from a reference checkpoint equals the
    JAX loader's variables through the bridge, bit for bit."""
    sd = testing.gln_reference_state_dict(np.random.default_rng(9))
    _save_nested(tmp_path / "gln.pth", sd, "module.")
    path = str(tmp_path / "gln.pth")
    got = common.load_gln_state_dict(path, GLNConfig(**CANVAS))
    want = weights.gln_state_dict(jax.device_get(
        j_common.load_gln_variables(path, JGLNConfig(**CANVAS))))
    assert_same(got, want)
    # no file: a seeded init, the same for the same generator seed
    a = common.load_gln_state_dict(None, GLNConfig(**CANVAS),
                                   torch.Generator().manual_seed(3))
    b = common.load_gln_state_dict(None, GLNConfig(**CANVAS),
                                   torch.Generator().manual_seed(3))
    assert_same(a, b)
    with pytest.raises(ValueError, match="directory"):
        common.load_gln_state_dict(str(tmp_path), GLNConfig(**CANVAS))


@pytest.mark.parametrize("layout", ["features", "slices"])
def test_load_embedder_vgg16_matches_jax(tmp_path, layout):
    """MACVGG from torchvision vgg16_bn features or reference block
    slices, BN folded: unit-norm embeddings within 1e-5 of JAX's
    (measured 2.5e-7: the same f32 convs summed in another order)."""
    rng = np.random.default_rng(10)
    sd = (testing.vgg16_features_state_dict(rng) if layout == "features"
          else testing.macvgg_reference_state_dict(rng))
    _save_nested(tmp_path / "vgg.pth", sd, "")
    path = str(tmp_path / "vgg.pth")
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    enc, size = common.load_embedder(path, device="cpu")
    j_enc, j_size = j_common.load_embedder(path)
    assert size == j_size == 1024
    np.testing.assert_allclose(enc(x).numpy(), np.asarray(j_enc(x)),
                               atol=1e-5)


def test_load_embedder_resnet50_matches_jax(tmp_path):
    """MACResNet (c3 + c4) from torchvision resnet50 names under
    `module.`: unit-norm embeddings within 1e-5 of JAX's (measured
    8.2e-8)."""
    rng = np.random.default_rng(11)
    _save_nested(tmp_path / "r50.pth", testing.resnet50_state_dict(rng),
                 "module.")
    path = str(tmp_path / "r50.pth")
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    enc, size = common.load_embedder(path, encoder="resnet50",
                                     device="cpu")
    j_enc, j_size = j_common.load_embedder(path, encoder="resnet50")
    assert size == j_size == 1536
    np.testing.assert_allclose(enc(x).numpy(),
                               np.asarray(j_enc(jnp.asarray(x))), atol=1e-5)


def test_default_gln_config():
    """f32 by default; `fast` runs the conv stacks in bf16 (the JAX
    package's approximate top-k is left out by design)."""
    assert common.default_gln_config() == GLNConfig()
    assert common.default_gln_config(fast=True) == GLNConfig(
        compute_dtype="bfloat16")


def test_loaders_refuse_wrong_checkpoints(tmp_path):
    """A key the checkpoint lacks or the model lacks raises KeyError, a
    shape mismatch ValueError; each message names the key."""
    sd = testing.resnet50_state_dict(np.random.default_rng(12))
    missing = dict(sd)
    del missing["layer3.2.conv2.weight"]
    torch.save(missing, str(tmp_path / "missing.pth"))
    with pytest.raises(KeyError, match="layer3.2.conv2.weight"):
        common.load_embedder(str(tmp_path / "missing.pth"),
                             encoder="resnet50", device="cpu")
    bad = dict(sd)
    bad["layer1.0.conv1.weight"] = bad["layer1.0.conv1.weight"][:, :32]
    torch.save(bad, str(tmp_path / "bad.pth"))
    with pytest.raises(ValueError, match="trunk.layer1_0.conv1.weight"):
        common.load_embedder(str(tmp_path / "bad.pth"), encoder="resnet50",
                             device="cpu")
    state = MACResNet().state_dict()
    with pytest.raises(KeyError, match="trunk.fc.weight"):
        common._merge(state, {"trunk.fc.weight": torch.zeros(2)})
    torch.save({"classifier.0.weight": torch.zeros(2)},
               str(tmp_path / "other.pth"))
    with pytest.raises(ValueError, match="layout"):
        common.load_embedder(str(tmp_path / "other.pth"), device="cpu")
