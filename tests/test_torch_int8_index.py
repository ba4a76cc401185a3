"""The int8 static-scale lifecycle across the two packages: the port's
Classifier calibrates an int8_static MACVGG on the gallery when it
builds the index, saves the scales with it in the JAX package's
`np.savez` format, and an index saved by either package loads in the
other with equal scales restored into its encoder."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cvpce_tpu.models.embedders import MACVGG as JMACVGG
from cvpce_tpu.models.embedders import EmbedFn as JEmbedFn
from cvpce_tpu.models.embedders import fold_bn_variables as j_fold_bn
from cvpce_tpu.pipeline.classifier import Classifier as JClassifier
from cvpce_tpu_torch.models.embedders import MACVGG, EmbedFn
from cvpce_tpu_torch.pipeline.classifier import Classifier
from cvpce_tpu_torch.utils.weights import macvgg_state_dict


class Gallery:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        r = np.random.default_rng(i)
        img = r.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
        return img, img, ["c"], f"prod{i}"


def leaves(tree, trail=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from leaves(v, trail + (k,))
    else:
        yield trail, float(tree)


@pytest.fixture(scope="module")
def folded():
    v = JMACVGG(batch_norm=True).init(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 64, 64, 3)))
    return jax.device_get(j_fold_bn(v))


def port_encoder(folded):
    model = MACVGG(batch_norm=False, int8_all=True, int8_static=True)
    model.load_state_dict(macvgg_state_dict(folded["params"], {}))
    return EmbedFn(model, device="cpu")


def jax_encoder(folded):
    return JEmbedFn(JMACVGG(batch_norm=False, int8_all=True,
                            int8_static=True), folded)


def test_port_index_calibrates_and_loads_in_jax(folded, tmp_path):
    enc = port_encoder(folded)
    assert enc.needs_calibration and enc.get_scales() is None
    clf = Classifier(enc, enc.embedding_size, sample_set=Gallery(),
                     batch_size=2, k=1, device="cpu")
    scales = enc.get_scales()
    assert len(list(leaves(scales))) == 12
    assert all(s > 0 for _, s in leaves(scales))
    path = str(tmp_path / "port_index.npz")
    clf.save_index(path)
    data = np.load(path, allow_pickle=True)
    assert set(data.files) == {"embedding", "annotations", "act_scales"}
    # calibration saw the first 4 batches (8 of 10 images) only
    enc_first4 = port_encoder(folded)
    enc_first4.calibrate([np.stack([Gallery()[i][0] for i in (j, j + 1)])
                          for j in range(0, 8, 2)])
    assert enc_first4.get_scales() == scales

    jenc = jax_encoder(folded)
    jclf = JClassifier(jenc, 1024, load=path, batch_size=2, k=1)
    assert dict(leaves(jenc.get_scales())) == dict(leaves(scales))
    assert list(jclf.annotations) == [f"prod{i}" for i in range(10)]
    q = np.stack([Gallery()[3][0]])
    assert clf.classify(q)[0][0] == "prod3"
    assert jclf.classify(q)[0][0] == "prod3"


def test_jax_index_loads_in_port(folded, tmp_path):
    jenc = jax_encoder(folded)
    jclf = JClassifier(jenc, 1024, sample_set=Gallery(), batch_size=2, k=1)
    path = str(tmp_path / "jax_index.npz")
    jclf.save_index(path)
    enc = port_encoder(folded)
    clf = Classifier(enc, enc.embedding_size, load=path, batch_size=2, k=1,
                     device="cpu")
    assert dict(leaves(enc.get_scales())) == dict(leaves(jenc.get_scales()))
    np.testing.assert_array_equal(clf.embedding, jclf.embedding)
    # queries embed with the restored scales: the JAX gallery's nearest
    # entry for each gallery image is the image itself
    imgs = np.stack([Gallery()[i][0] for i in range(10)])
    assert [r[0] for r in clf.classify(imgs)] == [f"prod{i}"
                                                   for i in range(10)]


def test_uncalibrated_encoder_self_calibrates_once(folded):
    """An int8_static encoder serving uncalibrated calibrates on its
    first batch; its scales then stay fixed (embedders.py:227-230)."""
    enc = port_encoder(folded)
    x = np.stack([Gallery()[i][0] for i in range(3)])
    e1 = enc(x)
    scales = enc.get_scales()
    assert scales is not None
    enc(np.stack([Gallery()[i][0] * 3 for i in range(3)]))
    assert enc.get_scales() == scales
    torch.testing.assert_close(enc(x), e1, rtol=0, atol=0)
    plain = EmbedFn(MACVGG(batch_norm=False), device="cpu")
    assert not plain.needs_calibration and plain.get_scales() is None
